"""JAX-side weights and forwards that the port's model tests hold the
port against (not a test file; imported by ``tests/test_torch_*.py``).

:func:`jax_variables` builds a JAX model's variable tree from
``jax.eval_shape`` of its ``init`` (no XLA compile) and fills every leaf
from a seeded numpy generator by ``torch_port_inputs.draw_weight``, so BN
and every conv do real work. :func:`jax_maps` runs one jitted
float32 ``apply`` and returns the backbone output and the 12 stage
outputs, NHWC. :func:`jax_draws` replays the JAX package's per-image
augmentation draws.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

import torch_port_inputs as inputs
from torch_ekpose_tpu.models import get_model

__all__ = ["jax_draws", "jax_maps", "jax_model", "jax_variables", "nchw",
           "variables_shape"]


@functools.lru_cache(maxsize=None)
def jax_model(name: str):
    """The JAX package's float32 network for ``name``."""
    return get_model(name, dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def variables_shape(name: str):
    """``jax.eval_shape`` of ``init``: the variable tree's shapes (the
    parameters do not depend on the frame size)."""
    return jax.eval_shape(
        functools.partial(jax_model(name).init, train=False),
        jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 64, 64, 3),
                                                    jnp.float32))


def _fill(rng: np.random.Generator, path, leaf) -> np.ndarray:
    keys = [getattr(k, "key", str(k)) for k in path]
    shape, kind = leaf.shape, keys[-1]
    fan = 1
    if kind == "kernel":                        # HWIO; [k, k, 1, C] depthwise
        fan = int(np.prod(shape[:-2])) * (1 if shape[-2] == 1 else shape[-1])
    return inputs.draw_weight(rng, kind, shape, fan)


def jax_variables(name: str, seed: int = 0) -> dict:
    """{"params": ..., ["batch_stats": ...]} of numpy float32 arrays."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        functools.partial(_fill, rng), dict(variables_shape(name)))


def jax_maps(name: str, variables: dict, x: np.ndarray):
    """(backbone output, [paf_1, ht_1, ..., paf_6, ht_6]) of the JAX
    float32 forward of NHWC ``x``, as numpy."""
    model = jax_model(name)
    (_, saved), inter = jax.jit(functools.partial(
        model.apply, train=False, mutable=["intermediates"],
        capture_intermediates=lambda mdl, method: mdl.name == "model0",
    ))(variables, jnp.asarray(x))
    features = inter["intermediates"]["model0"]["__call__"][0]
    return np.asarray(features), [np.asarray(s) for s in saved]


def jax_draws(key, batch: int, scale_range=(0.5, 1.0), flip_prob=0.5,
              strength=0.1) -> dict:
    """The JAX package's per-image draws of ``augment_batch(..., key)``:
    its key splits (``_augment_one``, ``_color_jitter_device``), replayed
    under ``jit`` and ``vmap`` as there."""
    lo, hi = scale_range

    def one(k):
        k_flip, k_scale, k_cx, k_cy, k_jit = jax.random.split(k, 5)
        k_perm, k_b, k_c, k_s, k_h = jax.random.split(k_jit, 5)
        factors = jnp.stack([
            jax.random.uniform(k_b, (), minval=1 - strength,
                               maxval=1 + strength),
            jax.random.uniform(k_c, (), minval=1 - strength,
                               maxval=1 + strength),
            jax.random.uniform(k_s, (), minval=1 - strength,
                               maxval=1 + strength),
            jax.random.uniform(k_h, (), minval=-strength, maxval=strength),
        ])
        return {"order": jax.random.permutation(k_perm, 4),
                "factors": factors,
                "s": jax.random.uniform(k_scale, (), minval=lo, maxval=hi),
                "flip": jax.random.bernoulli(k_flip, flip_prob),
                "crop_x": jax.random.uniform(k_cx, ()),
                "crop_y": jax.random.uniform(k_cy, ())}

    draws = jax.jit(jax.vmap(one))(jax.random.split(key, batch))
    import torch

    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def nchw(x: np.ndarray):
    """NHWC numpy -> NCHW torch (a view)."""
    import torch

    return torch.from_numpy(x).permute(0, 3, 1, 2)


def port_model(name: str, variables: dict):
    """The port's float32 CPU network for ``name`` on ``variables``
    (through ``state_dict_from_jax``, strictly)."""
    from torch_ekpose_tpu_torch.models.factory import get_model as port_get
    from torch_ekpose_tpu_torch.runtime.checkpoint import state_dict_from_jax

    model = port_get(name, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, name), strict=True)
    return model.eval()


def assert_maps_close(got, want, what: str) -> None:
    """Port NCHW torch vs JAX NHWC numpy, within rtol 1e-4 and atol
    1e-4 * max|JAX| (the convs sum in another order)."""
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max(), err_msg=what)


def check_forward(name: str, height: int, width: int, seed: int = 0) -> None:
    """The port's float32 backbone output (``model0``) and 12 stage
    outputs equal the JAX package's ``apply(train=False)`` on the same
    weights and frames."""
    import torch

    variables = jax_variables(name, seed)
    model = port_model(name, variables)
    x = np.random.default_rng(seed + 1).normal(
        0.0, 1.0, (2, height, width, 3)).astype(np.float32)
    features, saved = jax_maps(name, variables, x)
    h8, w8 = -(-height // 8), -(-width // 8)
    assert features.shape == (2, h8, w8, model.model0.out_channels)
    with torch.inference_mode():
        got_features = model.model0(nchw(x))
        (paf, heat), got = model(nchw(x))
    assert len(got) == 12 and got[-2] is paf and got[-1] is heat
    assert_maps_close(got_features, features, f"{name} model0")
    for i, (g, r) in enumerate(zip(got, saved)):
        assert r.shape == (2, h8, w8, 38 if i % 2 == 0 else 19)
        assert_maps_close(g, r, f"{name} stage output {i}")


def check_estimator(name: str) -> None:
    """``PoseEstimator(name, device="cpu")`` in float32 against the JAX
    estimator on the same weights and frames: ``get_outputs_batch``
    within the forward's tolerance, and ``estimate_batch``'s people and
    the packed decode buffers equal. Random weights make no people, so
    the stage-6 projections' BN (shared weights; the forward is the
    model's) is set by ``torch_port_inputs.peaky_head_`` to heatmaps of
    noise and a constant PAF field first; the buffers must then hold
    peaks, and people in every frame."""
    import torch

    from torch_ekpose_tpu.decode import device as D
    from torch_ekpose_tpu.decode.synthetic import canonical_humans
    from torch_ekpose_tpu.runtime import PoseEstimator as JaxEstimator
    from torch_ekpose_tpu.runtime.checkpoint import convert_torch_checkpoint
    from torch_ekpose_tpu_torch.decode import device as PD
    from torch_ekpose_tpu_torch.runtime.checkpoint import state_dict_from_jax
    from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator

    frames = np.random.default_rng(0).integers(0, 256, (2, 64, 72, 3),
                                               dtype=np.uint8)
    port = PoseEstimator(name, state_dict_from_jax(jax_variables(name), name),
                         device="cpu", compute_dtype=torch.float32)
    inputs.peaky_head_(port, frames)
    shared = convert_torch_checkpoint(
        {k: v.numpy() for k, v in port.model.state_dict().items()}, name)
    ref = JaxEstimator(name, shared, compute_dtype=jnp.float32,
                       decode_backend="jax")

    humans = port.estimate_batch(frames)
    assert [canonical_humans(h) for h in humans] == [
        canonical_humans(h) for h in ref.estimate_batch(frames)]
    assert min(len(h) for h in humans) >= 1

    paf, heat = port.get_outputs_batch(frames)
    paf_ref, heat_ref = ref.get_outputs_batch(frames)
    assert paf.shape == (2, 8, 9, 38) and heat.shape == (2, 8, 9, 19)
    for got, want in ((paf, paf_ref), (heat, heat_ref)):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())

    cfg = port.config
    k, cap = cfg.DECODE.max_peaks_per_part, cfg.DECODE.max_people * 3
    packed = PD.build_packed_decoder(cfg)(
        torch.from_numpy(heat), torch.from_numpy(paf)).numpy()
    packed_ref = np.asarray(D.build_packed_decoder(
        cfg, batched=True, pallas=False)(jnp.asarray(heat), jnp.asarray(paf)))
    assert inputs.packed_mismatches(packed, packed_ref, k, cap,
                                    rtol=1e-6) == []
    peak_valid = packed[:, 18 * k * 3:18 * k * 4]
    assert peak_valid.sum(1).min() > 18


def check_reference_pth(name: str, unused: dict, tmp_path,
                        extra: str = "") -> None:
    """A reference-style ``.pth`` (``module.``-prefixed, holding the
    ``unused`` parameters the reference builds but never runs) loads
    through ``cli/common.py::load_variables`` into ``PoseEstimator``
    strictly, with the JAX package's weights. ``extra``: one more key,
    which the strict load must refuse (``"-"`` + a key: one key less)."""
    import torch

    from torch_ekpose_tpu.runtime.checkpoint import export_torch_checkpoint
    from torch_ekpose_tpu_torch.cli.common import load_variables
    from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator

    variables = jax_variables(name)
    want = export_torch_checkpoint(variables, name, prefix="")
    template = {k: np.ones(shape, np.float32) for k, shape in unused.items()}
    state = export_torch_checkpoint(variables, name, template=template)
    assert set(template) < {k[len("module."):] for k in state}
    if extra.startswith("-"):
        del state["module." + extra[1:]]
    elif extra:
        state["module." + extra] = np.zeros(3, np.float32)
    path = str(tmp_path / f"{name}.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in state.items()}, path)
    loaded = load_variables(name, path)
    if extra:
        import pytest

        with pytest.raises(RuntimeError, match="key"):
            PoseEstimator(name, loaded, device="cpu",
                          compute_dtype=torch.float32)
        return
    est = PoseEstimator(name, loaded, device="cpu",
                        compute_dtype=torch.float32)
    got = est.model.state_dict()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)

