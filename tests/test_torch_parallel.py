"""The port's batch-sharded inference and mesh helpers on the CPU.

``ShardedPoseEstimator`` over ``[cpu] * 4`` (one process, a device named
four times, as the JAX tests' virtual CPU devices) against the port's
``PoseEstimator`` image by image, and against the JAX package's
``ShardedPoseEstimator`` on its 8-virtual-device mesh on the same weights.
Random weights find no people, so the stage-6 projections' BN is set by
``torch_port_inputs.peaky_head_`` first and every parity test asserts
people. The sharded eval loop replays the eval scenes' maps
(``replay_forward`` on each replica) and gives the JAX package's
device-decode rows, its remainder bucket included.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_jax_models as tjm  # noqa: E402
import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu.decode.synthetic import canonical_humans  # noqa: E402
from torch_ekpose_tpu_torch.evaluate import run_eval  # noqa: E402
from torch_ekpose_tpu_torch.parallel import (  # noqa: E402
    ShardedPoseEstimator, infer_compute_dtype, make_mesh, shard_batch)
from torch_ekpose_tpu_torch.runtime.checkpoint import (  # noqa: E402
    state_dict_from_jax)
from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

NAME = "mobilenet_thin"
FRAMES = np.random.default_rng(0).integers(0, 256, (8, 64, 72, 3),
                                           dtype=np.uint8)
EVAL_GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                           "torch_eval_golden.npz")


def _cpu_mesh(n: int):
    return make_mesh(devices=["cpu"] * n)


@pytest.fixture(scope="module")
def port():
    """The port's float32 ``PoseEstimator`` with a peaky head."""
    est = PoseEstimator(NAME, state_dict_from_jax(tjm.jax_variables(NAME),
                                                  NAME),
                        device="cpu", compute_dtype=torch.float32)
    inputs.peaky_head_(est, FRAMES)
    return est


@pytest.fixture(scope="module")
def sharded(port):
    return ShardedPoseEstimator(NAME, port.model.state_dict(),
                                mesh=_cpu_mesh(4),
                                compute_dtype=torch.float32)


def _people(humans) -> list:
    return [canonical_humans(h) for h in humans]


@pytest.fixture(scope="module")
def sharded_people(sharded):
    """``sharded.estimate_batch(FRAMES)``, run once for both parities."""
    return sharded.estimate_batch(FRAMES)


def test_sharded_matches_the_one_device_estimator(port, sharded,
                                                  sharded_people):
    want = port.estimate_batch(FRAMES)
    got = sharded_people
    assert sharded.num_devices == 4 and len(got) == 8
    assert _people(got) == _people(want)
    assert min(len(h) for h in got) >= 1


def test_sharded_matches_the_jax_sharded_estimator(port, sharded_people):
    """The JAX ``ShardedPoseEstimator`` on the 8-virtual-device mesh, on
    the port's weights (``convert_torch_checkpoint``), finds the same
    people frame by frame."""
    from torch_ekpose_tpu.models import get_model
    from torch_ekpose_tpu.parallel import make_mesh as jax_mesh
    from torch_ekpose_tpu.parallel.inference import (
        ShardedPoseEstimator as JaxSharded)
    from torch_ekpose_tpu.runtime.checkpoint import convert_torch_checkpoint

    variables = convert_torch_checkpoint(
        {k: v.numpy() for k, v in port.model.state_dict().items()}, NAME)
    ref = JaxSharded(get_model(NAME, dtype=jnp.float32), variables,
                     mesh=jax_mesh(8))
    got = sharded_people
    assert _people(got) == _people(ref.estimate_batch(FRAMES))
    assert min(len(h) for h in got) >= 1


def test_sharded_refuses_an_indivisible_batch(sharded):
    with pytest.raises(ValueError, match="not divisible by mesh size 4"):
        sharded.estimate_batch(FRAMES[:3])


def test_sharded_eval_loop_gives_the_jax_device_rows(tmp_path):
    """``run_eval`` on a 4-device ``ShardedPoseEstimator`` whose replicas
    replay the eval scenes' maps: the JAX package's device-decode rows
    (batch 8: three buckets, the remainder padded by repeating a
    frame)."""
    golden = dict(np.load(EVAL_GOLDEN))
    maps = {i: (golden[f"heatmaps_{i}"], golden[f"pafs_{i}"])
            for i in inputs.EVAL_IDS}
    est = ShardedPoseEstimator("vgg2016", mesh=_cpu_mesh(4),
                               compute_dtype=torch.float32)
    for replica in est._replicas.values():
        inputs.replay_forward(replica, maps)
    paths = str(tmp_path / "images"), str(tmp_path / "annotations.json")
    inputs.write_eval_images(*paths, json.loads(str(golden["annotations"])))
    out = str(tmp_path / "rows.json")
    ap = run_eval(*paths, est, progress=False, batch_size=8,
                  results_json=out)
    rows = inputs.eval_rows(out)
    np.testing.assert_array_equal(rows, golden["rows_device"])
    assert ap == golden["ap_device"] > 0.75
    assert sorted(set(rows[:, 0].astype(int))) == list(inputs.EVAL_IDS)


def test_sharded_int8_static_calibrates_once_for_every_replica():
    """``int8_static`` without calibrated scales: the first batch
    calibrates one replica on the WHOLE batch (as one ``PoseEstimator``
    would) and every replica serves those scales."""
    frames = FRAMES[:4, :, :64]
    one = PoseEstimator("vgg2016", device="cpu", compute_dtype="int8_static")
    one.estimate_batch(frames)
    est = ShardedPoseEstimator("vgg2016", mesh=make_mesh(
        devices=["cpu", torch.device("cpu", 0)]), compute_dtype="int8_static")
    est.estimate_batch(frames)
    want = {k: v for k, v in one.model.state_dict().items()
            if k.endswith("act_scale")}
    assert len(est._replicas) == 2 and want
    for replica in est._replicas.values():
        got = replica.model.state_dict()
        for key, value in want.items():
            assert torch.equal(got[key], value), key


@pytest.mark.parametrize("kwargs,error,needle", [
    (dict(num_devices=5, devices=["cpu"] * 4), ValueError,
     "5 devices asked for, but only 4"),
    (dict(devices=["cpu"] * 4, spatial=3), ValueError, "spatial=3"),
    (dict(num_devices=2), RuntimeError, "no CUDA device"),
], ids=["too_many", "spatial", "no_card"])
def test_make_mesh_refuses(kwargs, error, needle):
    if "devices" not in kwargs and torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(error, match=needle):
        make_mesh(**kwargs)


def test_make_mesh_shapes_and_shard_batch():
    mesh = make_mesh(devices=["cpu"] * 4, spatial=2)
    assert mesh.shape == (2, 2) and mesh.axis_names == ("data", "spatial")
    assert mesh.size == 4 and len(mesh.flat) == 4
    flat = make_mesh(3, devices=["cpu"] * 4)
    assert flat.shape == (3,) and flat.axis_names == ("data",)
    x = np.arange(12).reshape(6, 2)
    (part,) = shard_batch((x,), 1, 3)
    np.testing.assert_array_equal(part, x[2:4])
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch((x,), 0, 4)


def test_infer_compute_dtype():
    f32 = {"w": torch.zeros(1), "n": torch.zeros((), dtype=torch.int64)}
    assert infer_compute_dtype(f32) == torch.float32
    assert infer_compute_dtype({"w": torch.zeros(1, dtype=torch.bfloat16)}) \
        == torch.bfloat16
    assert infer_compute_dtype({"b": torch.zeros(1), "q": torch.zeros(
        1, dtype=torch.int8)}) == torch.bfloat16
