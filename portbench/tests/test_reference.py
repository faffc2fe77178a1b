"""The plain references against the port on the CPU: the forwards at
64x64, the peaks and the people of the decode."""

from __future__ import annotations


import numpy as np
import pytest
import torch

from portbench import catalog
from portbench.check import people_of, unpack_peaks, unpack_table
from portbench.params import Params, frame_pool, shape_head
from portbench.reference import decode, family
from portbench.reference.common import preprocess


def _estimator(name, state_dict):
    from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator

    return PoseEstimator(name, state_dict=state_dict, device="cpu",
                         compute_dtype=torch.float32, precision="highest",
                         decode_backend="device")


@pytest.mark.parametrize("name", ["vgg2016", "mobilenet_thin"])
def test_forward_matches_the_port(name):
    cfg = catalog.load_config(name)
    fam = family(cfg["reference"])
    params = Params(fam.param_specs(cfg), 11, "cpu", torch.float32)
    frames = frame_pool({"batch": 2, "height": 64, "width": 64,
                         "pool_batches": 1}, 11, "cpu")
    est = _estimator(name, params.state_dict())
    with torch.no_grad():
        paf, heat = est._forward(frames)
        out = fam.forward(params.float32(), preprocess(torch.from_numpy(frames)),
                          cfg)
    scale = max(float(out["heat"].abs().max()), float(out["paf"].abs().max()))
    assert torch.allclose(paf, out["paf"], atol=1e-5 * scale, rtol=0)
    assert torch.allclose(heat, out["heat"], atol=1e-5 * scale, rtol=0)


def test_decode_matches_the_port():
    """On shaped maps with people: the same peaks (coordinates exact,
    scores to float32 rounding), from the port's peaks and PAF maps the
    same people, bit for bit, and from its person table the same again."""
    cfg = catalog.load_config("mobilenet_thin")
    fam = family(cfg["reference"])
    traffic = catalog.load_traffic("crowd-b8")
    params = Params(fam.param_specs(cfg), 5, "cpu", torch.float32)
    frames = frame_pool({"batch": 2, "height": 128, "width": 128,
                         "pool_batches": 1}, 5, "cpu")
    shape_head(fam, cfg, params, frames, traffic["head"], "cpu")
    est = _estimator("mobilenet_thin", params.state_dict())
    handle = est.estimate_batch_async(frames)
    humans = est.collect_batch(handle)
    xy, score, valid = unpack_peaks(handle[0].numpy())
    subset, person_valid = unpack_table(handle[0].numpy())
    with torch.no_grad():
        out = fam.forward(params.float32(), preprocess(torch.from_numpy(frames)),
                          cfg)
        port_paf, _ = est._forward(frames)
    rxy, rscore, rvalid = decode.find_peaks(out["heat"])
    assert valid.sum() > 100 and np.array_equal(valid, rvalid)
    assert np.array_equal(xy[valid], rxy[rvalid])
    assert np.allclose(score[valid], rscore[rvalid], rtol=1e-5, atol=0)
    paf = port_paf.numpy()
    for i in range(2):
        people = decode.assemble(xy[i], score[i], valid[i], paf[i], 128, 128)
        assert len(people) > 3
        assert people_of(humans[i]) == people
        assert decode.people_from_table(subset[i], person_valid[i], xy[i],
                                        score[i], 128, 128) == people
