"""Write the JAX package's decodes that the PyTorch port is held against
on a machine that has no JAX (``chip_smoke.py``, the GPU tests):

- ``tests/data/torch_decode_golden.npz``: the device decode of four
  synthetic multi-person scenes, ``decode/synthetic.py::synth_scene``
  draws from seed 7 (the ones ``bench.py`` certifies its decode on), as
  packed buffers of ``decode_jax_batched(use_pallas_loops=False)`` with
  the default config (K = 32 peaks per part, 96 person rows);
- ``tests/data/torch_host_decode_golden.npz``: the host decode
  (``decode/api.py::paf_to_pose``, ``"native"`` and ``"numpy"``) of those
  four scenes and of a crowded frame (``crowded_maps`` of
  ``tests/torch_port_inputs.py``: 3 people over clutter, over 32 peaks in
  a part), whose maps it stores; each person as rows ``[scene, person,
  part, x, y, part score, person score]``;
- ``tests/data/torch_eval_golden.npz``: the JAX package's ``run_eval``
  on the eval scenes of ``tests/torch_port_inputs.py`` (12 solid-fill
  frames, landscape and portrait, 1-2 people each; the COCO annotations
  as a JSON string), whose forward replays each frame's ground-truth maps
  at its padded shape (``data/targets.py::gen_targets_np``, stored): the
  result rows and AP with the ``"numpy"`` decode at batch 1, and with the
  device decode at batch 8 (``decode_jax_batched(use_pallas_loops=
  False)``).

    JAX_PLATFORMS=cpu python scripts/make_torch_golden.py

``tests/test_torch_decode.py``, ``tests/test_torch_decode_host.py`` and
``tests/test_torch_eval.py`` regenerate the arrays in memory and check
the committed files are current.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

DATA = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, "tests", "data")
GOLDEN = os.path.join(DATA, "torch_decode_golden.npz")
HOST_GOLDEN = os.path.join(DATA, "torch_host_decode_golden.npz")
EVAL_GOLDEN = os.path.join(DATA, "torch_eval_golden.npz")


def make_golden() -> dict:
    import jax
    import jax.numpy as jnp

    from torch_ekpose_tpu.config import Config
    from torch_ekpose_tpu.decode import device as decode_device
    from torch_ekpose_tpu.decode.synthetic import synth_scene

    cfg = Config()
    prng = np.random.default_rng(7)
    scenes = [synth_scene(prng, int(prng.integers(1, 5))) for _ in range(4)]
    heatmaps = np.stack([s[0] for s in scenes])
    pafs = np.stack([s[1] for s in scenes])
    decoder = decode_device.build_packed_decoder(cfg, batched=True,
                                                 pallas=False)
    packed = np.asarray(jax.device_get(
        decoder(jnp.asarray(heatmaps), jnp.asarray(pafs))
    ))
    up_h, up_w = (d * cfg.MODEL.DOWNSAMPLE for d in heatmaps.shape[1:3])
    n_humans = np.array([
        len(decode_device.packed_to_humans(row, up_h, up_w, cfg))
        for row in packed
    ], np.int32)
    return {
        "heatmaps": heatmaps, "pafs": pafs, "packed": packed,
        "n_humans": n_humans,
        "max_peaks": np.int32(cfg.DECODE.max_peaks_per_part),
        "subset_cap": np.int32(cfg.DECODE.max_people * 3),
    }


def people_rows(scene: int, humans) -> np.ndarray:
    """[N, 7] float64 rows ``[scene, person, part, x, y, part score,
    person score]`` of ``humans``, in their order, parts ascending."""
    return np.array([
        [scene, i, part, bp.x, bp.y, bp.score, h.score]
        for i, h in enumerate(humans)
        for part, bp in sorted(h.body_parts.items())
    ], np.float64).reshape(-1, 7)


def make_host_golden(golden: dict) -> dict:
    """The JAX package's host decodes of ``golden``'s four scenes and of a
    crowded frame (its maps are stored)."""
    from torch_ekpose_tpu.decode import api

    sys.path.insert(0, os.path.dirname(DATA))
    import torch_port_inputs as inputs

    heat, pafs = inputs.crowded_maps(np.random.default_rng(1), 1, 3,
                                     clutter=0.152)
    scenes = list(zip(golden["heatmaps"], golden["pafs"])) + [
        (heat[0], pafs[0])]
    out = {"crowded_heatmaps": heat, "crowded_pafs": pafs}
    for backend in ("native", "numpy"):
        out[f"people_{backend}"] = np.concatenate([
            people_rows(i, api.paf_to_pose(h, p, backend=backend))
            for i, (h, p) in enumerate(scenes)])
    return out


def eval_maps(people: dict, annotations: dict) -> dict:
    """{image id: (heatmaps, pafs)}: each eval frame's ground-truth maps
    at its padded shape, as ``tests/test_eval_pipeline.py``'s fake
    estimator makes them."""
    from torch_ekpose_tpu.data import gen_targets_np
    from torch_ekpose_tpu.runtime.estimator import padding

    maps = {}
    for info in annotations["images"]:
        im_pad, scale, _ = padding(
            np.zeros((info["height"], info["width"], 3), np.uint8), 368, 8)
        kpts = np.stack(people[info["id"]]).copy()
        kpts[:, :, :2] *= scale
        maps[info["id"]] = gen_targets_np(
            kpts, im_pad.shape[0] // 8, im_pad.shape[1] // 8, 8, 7.0)
    return maps


def make_eval_golden() -> dict:
    """The JAX package's ``run_eval`` on the eval scenes, host decode at
    batch 1 and device decode at batch 8."""
    import tempfile

    import jax.numpy as jnp

    from torch_ekpose_tpu.config import Config
    from torch_ekpose_tpu.decode import device as decode_device
    from torch_ekpose_tpu.evaluate import run_eval

    sys.path.insert(0, os.path.dirname(DATA))
    import torch_port_inputs as inputs

    cfg = Config()
    decoder = decode_device.build_packed_decoder(cfg, batched=True,
                                                 pallas=False)

    class Replay(inputs.ReplayMaps):
        def estimate_batch_async(self, images):
            pafs, heat = self.lookup(images)
            b, h, w = images.shape[:3]
            return np.asarray(decoder(jnp.asarray(heat),
                                      jnp.asarray(pafs))), b, h, w

        def collect_batch(self, handle):
            packed, b, h, w = handle
            return [decode_device.packed_to_humans(packed[i], h, w, cfg)
                    for i in range(b)]

    annotations, people = inputs.eval_dataset(np.random.default_rng(0))
    maps = eval_maps(people, annotations)
    out = {"annotations": np.array(json.dumps(annotations))}
    for img_id, (heat, pafs) in maps.items():
        out[f"heatmaps_{img_id}"], out[f"pafs_{img_id}"] = heat, pafs
    with tempfile.TemporaryDirectory() as tmp:
        image_dir = os.path.join(tmp, "images")
        anno = os.path.join(tmp, "annotations.json")
        inputs.write_eval_images(image_dir, anno, annotations)
        for name, backend, batch in (("numpy", "numpy", 1),
                                     ("device", "jax", 8)):
            results = os.path.join(tmp, f"{name}.json")
            ap = run_eval(image_dir, anno, Replay(maps, cfg, backend),
                          progress=False, batch_size=batch,
                          results_json=results)
            out[f"rows_{name}"] = inputs.eval_rows(results)
            out[f"ap_{name}"] = np.float64(ap)
    return out


def main() -> int:
    golden = make_golden()
    host = make_host_golden(golden)
    evals = make_eval_golden()
    os.makedirs(DATA, exist_ok=True)
    for path, arrays in ((GOLDEN, golden), (HOST_GOLDEN, host),
                         (EVAL_GOLDEN, evals)):
        np.savez_compressed(path, **arrays)
        print(f"wrote {os.path.normpath(path)} ({os.path.getsize(path)} "
              "bytes)")
    print(f"people per scene (device decode): {golden['n_humans'].tolist()}")
    print(f"eval AP: numpy {evals['ap_numpy']:.4f}, device "
          f"{evals['ap_device']:.4f}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(DATA, os.pardir, os.pardir))
    sys.exit(main())
