"""Write the JAX package's int8 serving maps that ``tests/test_torch_quant.py``
holds the port's int8 modes against: ``tests/data/torch_int8_golden.npz``.

vgg2016 on ``tests/torch_jax_models.py::jax_variables`` weights, one
seeded batch of model input (:func:`model_input`: two 64x64 frames,
preprocessed as the serving path does, NHWC float32):

- ``float32/{paf,heat}``: the float32 forward (``jit``);
- ``int8/{paf,heat}``: ``get_model(dtype=bfloat16, quantize=True)`` on
  ``quantize_variables``' tree;
- ``act_scale/<path>``: the static scales ``calibrate_act_scales``'s math
  measures on that batch;
- ``int8_static/{paf,heat}``: ``quantize="static"`` on those scales;
- ``layer/{input,output}``: backbone ``conv_2`` alone (dynamic scales) on
  a seeded bf16 input, as the cheap currency check's reference.

Every forward runs under ``jit``, as the JAX package serves, with XLA's
``--xla_allow_excess_precision=false``, so each bf16 op rounds its output
to bf16 as the port's eager ops do (by default XLA may keep float32
between fused ops). Keys hold NHWC float32 maps; bf16 values are exact
in float32. About 45 s of CPU.

    JAX_PLATFORMS=cpu python scripts/make_torch_int8_golden.py
"""

from __future__ import annotations

import functools
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_int8_golden.npz")
NAME = "vgg2016"


def model_input() -> np.ndarray:
    """Two seeded 64x64 BGR frames, preprocessed as the serving path does
    (/255, BGR->RGB, ImageNet mean/std): NHWC float32."""
    from torch_ekpose_tpu import constants

    frames = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3))
    x = frames[..., ::-1].astype(np.float32) / np.float32(255.0)
    mean = np.asarray(constants.IMAGENET_MEAN, np.float32)
    std = np.asarray(constants.IMAGENET_STD, np.float32)
    return ((x - mean) / std).astype(np.float32)


def layer_input() -> np.ndarray:
    """A seeded bf16-valued input of backbone ``conv_2`` (64 channels,
    ReLU'd), NHWC float32."""
    import jax.numpy as jnp

    x = np.random.default_rng(4).gamma(1.0, 1.0, (2, 12, 14, 64))
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def layer_output(variables: dict, x: np.ndarray) -> np.ndarray:
    """Backbone ``conv_2`` alone: the JAX package's dynamic ``QuantConv``
    on ``quantize_variables``' int8 weight, bf16 out, as float32."""
    import jax.numpy as jnp

    from torch_ekpose_tpu.models.quant import QuantConv, quantize_kernel

    conv = variables["params"]["model0"]["conv_2"]["conv"]
    q, scale = quantize_kernel(np.asarray(conv["kernel"]))
    params = {"kernel_q": q, "scale": scale, "bias": np.asarray(conv["bias"])}
    out = QuantConv(64, kernel=3, dtype=jnp.bfloat16).apply(
        {"params": params}, jnp.asarray(x, jnp.bfloat16))
    return np.asarray(out.astype(jnp.float32))


def _maps(apply, variables, x) -> tuple:
    import jax.numpy as jnp

    (paf, heat), _ = apply(variables, x, train=False)
    return (np.asarray(paf.astype(jnp.float32)),
            np.asarray(heat.astype(jnp.float32)))


def _scales(tree, prefix="") -> dict:
    """{"a/b/c": value} of every ``act_scale`` leaf."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_scales(value, path))
        elif key == "act_scale":
            out[path] = np.float32(value)
    return out


def golden() -> dict:
    import jax
    import jax.numpy as jnp

    import torch_jax_models as tjm
    from torch_ekpose_tpu.models import get_model, quantize_variables
    from torch_ekpose_tpu.models import quant

    variables = tjm.jax_variables(NAME)
    x = model_input()
    out = {}
    f32 = get_model(NAME)
    out["float32/paf"], out["float32/heat"] = _maps(
        jax.jit(f32.apply, static_argnames="train"), variables, x)
    dyn = get_model(NAME, dtype=jnp.bfloat16, quantize=True)
    qvars = quantize_variables(variables, dyn)
    out["int8/paf"], out["int8/heat"] = _maps(
        jax.jit(dyn.apply, static_argnames="train"), qvars, x)
    # calibrate_act_scales' math
    _, inter = jax.jit(functools.partial(
        dyn.apply, train=False, mutable=["intermediates"]))(qvars, x)
    absmax = jax.tree.map(lambda t: t[0], inter["intermediates"],
                          is_leaf=lambda t: isinstance(t, tuple))
    params = quant._plain_dict(qvars["params"])
    svars = dict(qvars)
    svars["params"] = quant._insert_act_scales(
        params, jax.device_get(quant._plain_dict(absmax)))
    static = get_model(NAME, dtype=jnp.bfloat16, quantize="static")
    out["int8_static/paf"], out["int8_static/heat"] = _maps(
        jax.jit(static.apply, static_argnames="train"), svars, x)
    for path, value in _scales(svars["params"]).items():
        out[f"act_scale/{path}"] = value
    out["layer/input"] = layer_input()
    out["layer/output"] = layer_output(variables, out["layer/input"])
    return out


def main() -> None:
    # XLA may otherwise keep float32 between fused bf16 ops
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_allow_excess_precision=false")
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    out = golden()
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {os.path.relpath(GOLDEN, ROOT)}: {len(out)} arrays, "
          f"{os.path.getsize(GOLDEN)} bytes")


if __name__ == "__main__":
    main()
