"""Write ``tests/data/torch_decode_golden.npz``: the JAX package's decode
of four synthetic multi-person scenes, the reference for the PyTorch
port's decode on a machine that has no JAX (``chip_smoke.py``, the GPU
tests).

    JAX_PLATFORMS=cpu python scripts/make_torch_golden.py

The scenes are ``decode/synthetic.py::synth_scene`` draws from seed 7
(the ones ``bench.py`` certifies its decode on); the packed buffers come
from ``decode_jax_batched(use_pallas_loops=False)`` with the default
config (K = 32 peaks per part, 96 person rows). ``tests/test_torch_decode.py``
regenerates the arrays in memory and checks the committed file is current.
"""

from __future__ import annotations

import os
import sys

import numpy as np

GOLDEN = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, "tests", "data",
    "torch_decode_golden.npz",
)


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


def main() -> int:
    golden = make_golden()
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **golden)
    print(f"wrote {os.path.normpath(GOLDEN)} "
          f"({os.path.getsize(GOLDEN)} bytes), humans per scene: "
          f"{golden['n_humans'].tolist()}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(GOLDEN), os.pardir,
                                    os.pardir))
    sys.exit(main())
