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
  part, x, y, part score, person score]``.

    JAX_PLATFORMS=cpu python scripts/make_torch_golden.py

``tests/test_torch_decode.py`` and ``tests/test_torch_decode_host.py``
regenerate the arrays in memory and check the committed files are
current.
"""

from __future__ import annotations

import os
import sys

import numpy as np

DATA = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, "tests", "data")
GOLDEN = os.path.join(DATA, "torch_decode_golden.npz")
HOST_GOLDEN = os.path.join(DATA, "torch_host_decode_golden.npz")


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


def main() -> int:
    golden = make_golden()
    host = make_host_golden(golden)
    os.makedirs(DATA, exist_ok=True)
    for path, arrays in ((GOLDEN, golden), (HOST_GOLDEN, host)):
        np.savez_compressed(path, **arrays)
        print(f"wrote {os.path.normpath(path)} ({os.path.getsize(path)} "
              "bytes)")
    print(f"people per scene (device decode): {golden['n_humans'].tolist()}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(DATA, os.pardir, os.pardir))
    sys.exit(main())
