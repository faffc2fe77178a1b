"""Write the JAX package's stage-6 maps that ``tests/test_torch_bf16_drift.py``
holds the port's bf16 drift against: ``tests/data/torch_bf16_drift_golden.npz``.

For each of the seven ds models, on ``tests/torch_jax_models.py::
jax_variables`` weights and one seeded frame batch (:func:`frames`,
2x64x72, N(0, 1)): the float32 forward under ``jit`` and the bf16
forward (the JAX package's ``cast_params`` and ``get_model(dtype=
bfloat16)``) op by op, not under ``jit``, so that each op rounds its
output to bf16 as the port's eager ops do (under ``jit`` XLA fuses
elementwise chains and keeps float32 between them). Keys
``{name}/{float32|bfloat16}/{paf|heat}``, NHWC; the bf16 maps are
stored as their bits (uint16), exactly.

    JAX_PLATFORMS=cpu python scripts/make_torch_drift_golden.py

The test regenerates one model's float32 maps in memory and checks that
the committed file holds them.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_bf16_drift_golden.npz")
DS_NAMES = ("mobilenet", "mobilenet_thin", "mobilenetV2", "mobilenetV2_large",
            "mobilenetV2_small", "shufflenetV2_1.0x", "shufflenetV2_0.5x")


def frames() -> np.ndarray:
    """The 2x64x72 NHWC float32 frames every model runs on."""
    return np.random.default_rng(1).normal(0.0, 1.0, (2, 64, 72, 3)).astype(
        np.float32)


def stage6(name: str, variables: dict, x: np.ndarray, dtype) -> tuple:
    """(paf, heat) of the JAX package's stage 6 in ``dtype``, numpy."""
    import jax
    import jax.numpy as jnp

    from torch_ekpose_tpu.models import get_model
    from torch_ekpose_tpu.models.factory import cast_params

    model = get_model(name, dtype=dtype)
    if dtype != jnp.float32:
        variables = cast_params(variables, dtype)
    apply = model.apply if dtype == jnp.bfloat16 else jax.jit(
        model.apply, static_argnames="train")
    (paf, heat), _ = apply(variables, jnp.asarray(x, dtype), train=False)
    return np.asarray(paf), np.asarray(heat)


def drift_maps(name: str) -> dict:
    """``name``'s float32 and bf16 (as uint16 bits) stage-6 maps."""
    import jax.numpy as jnp

    import torch_jax_models as tjm

    variables = tjm.jax_variables(name)
    out = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        key = jnp.dtype(dtype).name
        for part, arr in zip(("paf", "heat"),
                             stage6(name, variables, frames(), dtype)):
            out[f"{name}/{key}/{part}"] = (
                arr.view(np.uint16) if dtype == jnp.bfloat16 else arr)
    return out


def load(golden, name: str, dtype: str) -> tuple:
    """(paf, heat) float32 of ``name`` in ``dtype`` from the golden file."""
    maps = []
    for part in ("paf", "heat"):
        arr = golden[f"{name}/{dtype}/{part}"]
        if arr.dtype == np.uint16:             # bf16 bits -> float32, exact
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        maps.append(arr)
    return tuple(maps)


def main() -> int:
    arrays = {}
    for name in DS_NAMES:
        arrays.update(drift_maps(name))
        print(f"{name}: done", flush=True)
    np.savez_compressed(GOLDEN, **arrays)
    print(f"wrote {os.path.normpath(GOLDEN)} ({os.path.getsize(GOLDEN)} "
          "bytes)")
    return 0


if __name__ == "__main__":
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    sys.exit(main())
