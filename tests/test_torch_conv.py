"""The port's VGG-prefix conv functions on the CPU (the kernels' plain
twins) against the JAX package's TPU kernels run in interpret mode.

Tolerances:
- float32 ``conv_chain``: atol 2e-5, as ``tests/test_pallas_conv.py``
  holds the Pallas kernel to XLA (the sums run in another order); the
  bias-50 border case keeps that file's atol 1e-4 / rtol 1e-5 (values
  near 50).
- bf16 against bf16: max error within 0.02 of max|reference|. Both sides
  sum in float32, but in another order, before each bf16 rounding, so a
  value can round the other way and the next layer carries it on.
- ``conv1_fused`` / ``block1_fused`` in float32: atol 2e-5, as above
  (atol 1e-4 / rtol 1e-5 in the bias-50 border case, as above); in bf16
  within 0.02 of max|reference|, as above.
- blocks 1-3 against ``backbone[:19]``: rtol 1e-4, atol 1e-4 *
  max|reference| (``tests/test_torch_models.py``'s forward tolerance).
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from torch_ekpose_tpu.ops.pallas_conv import conv_chain as jax_conv_chain  # noqa: E402
from torch_ekpose_tpu_torch.models.vgg import (  # noqa: E402
    BLOCK1_ROUTES, PREFIX_END, VGG19Backbone, chain_params, prefix_forward)
from torch_ekpose_tpu_torch.ops import block1  # noqa: E402
from torch_ekpose_tpu_torch.ops.conv_chain import conv_chain  # noqa: E402
from torch_ekpose_tpu_torch.runtime.checkpoint import state_dict_from_jax  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core


def _profile_block1():
    """``scripts/profile_block1.py``, imported by path (it imports
    ``profile_mfu`` beside it). Importing it sets JAX's persistent
    compilation cache; the settings are put back right after."""
    scripts = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           os.pardir, "scripts")
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    sys.path.insert(0, scripts)
    try:
        import profile_block1
    finally:
        sys.path.remove(scripts)
        for k, v in saved.items():
            jax.config.update(k, v)
    return profile_block1


def _params(rng, chain, bias=None):
    return [(rng.standard_normal((3, 3, ci, co)).astype(np.float32) * 0.2,
             rng.standard_normal(co).astype(np.float32) * 0.1
             if bias is None else np.full(co, bias, np.float32))
            for ci, co in chain]


def _both(x, params, pool, dtype):
    """(port, JAX Pallas kernel in interpret mode) on the same inputs."""
    got = conv_chain(torch.from_numpy(x).to(dtype),
                     [(torch.from_numpy(w), torch.from_numpy(b))
                      for w, b in params], pool=pool)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_conv_chain(jnp.asarray(x, jdtype),
                          [(jnp.asarray(w), jnp.asarray(b)) for w, b in params],
                          pool=pool, row_tile=8, interpret=True)
    assert got.dtype == dtype and got.shape == want.shape
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize(
    "h,w,chain,pool,bias,atol,rtol",
    [
        (36, 24, [(3, 16), (16, 16)], True, None, 2e-5, 0),
        (20, 16, [(8, 8)], False, None, 2e-5, 0),
        (34, 20, [(4, 8), (8, 8)], False, None, 2e-5, 0),
        (32, 24, [(16, 24), (24, 32)], True, None, 2e-5, 0),
        (16, 16, [(8, 8), (8, 8), (8, 8)], False, None, 2e-5, 0),
        (16, 16, [(4, 8), (8, 8)], False, 50.0, 1e-4, 1e-5),  # border
    ],
    ids=["block1_like", "single", "ragged", "widening", "three_deep",
         "bias50_border"],
)
def test_conv_chain_matches_jax_kernel(h, w, chain, pool, bias, atol, rtol):
    rng = np.random.default_rng(h * 100 + w)
    x = rng.standard_normal((2, h, w, chain[0][0])).astype(np.float32)
    got, want = _both(x, _params(rng, chain, bias), pool, torch.float32)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    if bias is not None:       # relu(50) leaking past the border would show
        assert np.abs(want).max() > 50


def test_conv_chain_bf16_matches_jax_kernel():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 24, 16, 3)).astype(np.float32)
    got, want = _both(x, _params(rng, [(3, 16), (16, 16)]), True,
                      torch.bfloat16)
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


def test_pooled_conv_chain_refuses_odd_sides():
    params = [(torch.zeros(3, 3, 3, 8), torch.zeros(8))]
    for shape in ((1, 15, 16, 3), (1, 16, 15, 3)):
        with pytest.raises(ValueError, match="even H and W"):
            conv_chain(torch.zeros(shape), params, pool=True)
        with pytest.raises(ValueError, match="even H and W"):
            jax_conv_chain(jnp.zeros(shape), [(jnp.zeros((3, 3, 3, 8)),
                                               jnp.zeros(8))], pool=True)
    with pytest.raises(ValueError, match="even H and W"):
        block1.block1_fused(torch.zeros(1, 15, 16, 3), *params[0],
                            torch.zeros(3, 3, 8, 8), torch.zeros(8))
    assert conv_chain(torch.zeros(1, 15, 16, 3), params).shape == (
        1, 15, 16, 8)


@pytest.mark.parametrize("variant", ["A", "B"])
def test_block1_kernels_match_profile_block1(variant):
    prof = _profile_block1()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 16, 24, 3)).astype(np.float32)
    (w1, b1), (w2, b2) = _params(rng, [(3, 64), (64, 64)])
    tx, tw1, tb1, tw2, tb2 = map(torch.from_numpy, (x, w1, b1, w2, b2))
    jx, jw1, jb1, jw2, jb2 = map(jnp.asarray, (x, w1, b1, w2, b2))

    got = block1.block1_fused(tx, tw1, tb1, tw2, tb2)
    want = prof.block1_fused(jx, jw1, jb1, jw2, jb2, variant=variant,
                             interpret=True)
    assert got.shape == want.shape == (1, 8, 12, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)

    got1 = block1.conv1_fused(tx, tw1, tb1)
    want1 = prof.conv1_fused(jx, jw1, jb1, interpret=True)
    assert got1.shape == want1.shape == (1, 16, 24, 64)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape,bias,rt", [((1, 38, 70), None, 2), ((2, 16, 24), 50.0, 8)],
    ids=["ragged_38x70", "bias50_border"])
def test_block1_kernels_match_profile_block1_cases(shape, bias, rt, dtype):
    """The port's ``conv1_fused`` / ``block1_fused`` (the twins on the CPU)
    against ``scripts/profile_block1.py``'s kernels in interpret mode, at
    a side that is no multiple of the card kernel's tiles and with a
    bias-50 border: float32 within atol 2e-5 (the border case, whose
    values reach the hundreds, within ``test_conv_chain_matches_jax_kernel``'s
    atol 1e-4 / rtol 1e-5), bf16 within 0.02 of max|reference|."""
    prof = _profile_block1()
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape + (3,)).astype(np.float32)
    (w1, b1), (w2, b2) = _params(rng, [(3, 64), (64, 64)], bias)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt)
    tw1, tb1, tw2, tb2 = map(torch.from_numpy, (w1, b1, w2, b2))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jw1, jb1, jw2, jb2 = map(jnp.asarray, (w1, b1, w2, b2))
    pairs = [
        (block1.conv1_fused(tx, tw1, tb1),
         prof.conv1_fused(jx, jw1, jb1, rt=rt, interpret=True)),
        (block1.block1_fused(tx, tw1, tb1, tw2, tb2),
         prof.block1_fused(jx, jw1, jb1, jw2, jb2, rt=rt, variant="A",
                           interpret=True)),
    ]
    for got, want in pairs:
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        assert got.shape == want.shape
        if dtype == "float32":
            np.testing.assert_allclose(
                got, want, atol=2e-5 if bias is None else 1e-4,
                rtol=0 if bias is None else 1e-5)
        else:
            assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()
    if bias is not None:       # relu(50) leaking past the border would show
        assert want[:, 0, 0].max() < want[:, 4, 4].max()


def test_prefix_matches_backbone_on_jax_weights(vgg_model_and_vars):
    """``chain_params`` + ``conv_chain`` over blocks 1-3 (and the other two
    block-1 routes) == ``backbone[:19]`` on the JAX package's weights."""
    params = jax.device_get(vgg_model_and_vars[1])["params"]
    state = {k[len("model0."):]: v
             for k, v in state_dict_from_jax(params).items()
             if k.startswith("model0.")}
    model = VGG19Backbone()
    model.load_state_dict(state, strict=True)
    x = torch.from_numpy(np.random.default_rng(5).random(
        (2, 32, 32, 3), dtype=np.float32))
    with torch.no_grad():
        want = model.backbone[:PREFIX_END](x.permute(0, 3, 1, 2))
        want = want.permute(0, 2, 3, 1).numpy()
        y = x
        for blk in (1, 2, 3):
            y = conv_chain(y, chain_params(model, blk), pool=True)
        routes = [prefix_forward(model, x, r) for r in BLOCK1_ROUTES]
    for got in [y] + routes:
        assert got.shape == (2, 4, 4, 256)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    assert np.abs(want).max() > 0
