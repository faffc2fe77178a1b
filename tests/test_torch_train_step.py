"""The port's train step against the JAX package's, vgg2016 on the CPU.

Same weights (``tests/torch_jax_models.py::jax_variables``), same
rendered batches (``torch_port_inputs.train_batch``, 64x64, batch 2),
Adam at lr 1e-4 with weight decay 5e-4, 2 steps. At step 1 Adam's update
is ~lr * sign(g), so a gradient that crosses zero between the two
stacks' roundings moves its element by up to 2 lr a step: the parameters
(compared through the JAX package's ``export_torch_checkpoint``) are held
to >= 99.9% within 1e-5, mean |diff| < 2e-6 and max <= 2 x steps x lr +
1e-6, the envelope of ``tests/test_reference_train_math.py``, with a
median update > 1e-5 so the check is not vacuous; every logged series
within rtol 5e-4. The JAX step is compiled once (host targets; the
device-target case rasterizes with ``gen_targets_jax`` first, which is
what its device step does, and the raw case augments with its
``augment_batch`` before that, which is what its raw step does): every
rate goes in as a strong float32, so the state the step returns has the
signature it was given and a second step does not compile again.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_jax_models as tjm  # noqa: E402
import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu.data.device_aug import (  # noqa: E402
    augment_batch as jax_augment)
from torch_ekpose_tpu.data.targets import (  # noqa: E402
    make_batched_target_fn as jax_target_fn)
from torch_ekpose_tpu.models import get_model as jax_get_model  # noqa: E402
from torch_ekpose_tpu.runtime.checkpoint import (  # noqa: E402
    export_torch_checkpoint)
from torch_ekpose_tpu.training import (  # noqa: E402
    ReduceLROnPlateau as JaxPlateau)
from torch_ekpose_tpu.training import cpm_loss as jax_cpm_loss  # noqa: E402
from torch_ekpose_tpu.training import create_train_state  # noqa: E402
from torch_ekpose_tpu.training import make_optimizer as jax_optimizer  # noqa: E402
from torch_ekpose_tpu.training import make_train_step as jax_train_step  # noqa: E402
from torch_ekpose_tpu.training import (  # noqa: E402
    set_learning_rate as jax_set_lr)
from torch_ekpose_tpu_torch.data.targets import gen_targets_np  # noqa: E402
from torch_ekpose_tpu_torch.models.factory import get_model  # noqa: E402
from torch_ekpose_tpu_torch.runtime.checkpoint import (  # noqa: E402
    state_dict_from_jax)
from torch_ekpose_tpu_torch.training import (  # noqa: E402
    ReduceLROnPlateau, cpm_loss, loss_series_names, make_eval_step,
    make_optimizer, make_train_step, set_learning_rate)

torch.set_num_threads(2)  # xdist already runs one process per core

LR, WD = 1e-4, 5e-4
S, B, GRID = 64, 2, (8, 8)


@pytest.fixture(scope="module")
def variables():
    return tjm.jax_variables("vgg2016")


#: one optimizer for every JAX run: the train state carries it as a
#: static field, so a new one would recompile the step
JAX_TX = jax_optimizer(LR, WD)


@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's float32 vgg2016 step, host targets."""
    model = jax_get_model("vgg2016")
    return model, jax_train_step(model, targets="host")


def _batches(seed: int, n: int = 2, size: int = S):
    rng = np.random.default_rng(seed)
    return [inputs.train_batch(rng, B, size) for _ in range(n)]


def _grid(batches):
    return (batches[0][0].shape[1] // 8,) * 2


def _host_targets(kpts, grid=GRID):
    maps = [gen_targets_np(k, *grid) for k in kpts]
    return (np.stack([m[0] for m in maps]), np.stack([m[1] for m in maps]))


def _jax_run(jax_step, variables, batches, targets, lr_after=None):
    model, step = jax_step
    # the rate as a strong float32 (a Python float would be weakly typed,
    # and the state the step returns, strong, would compile it again)
    state = jax_set_lr(create_train_state(model, variables, JAX_TX),
                       np.float32(LR))
    grid, logs = _grid(batches), []
    for i, (images, kpts) in enumerate(batches):
        if targets == "device":
            heat, paf = jax_target_fn(*grid)(kpts)
        else:
            heat, paf = _host_targets(kpts, grid)
        state, out = step(state, images, heat, paf)
        logs.append({k: float(v) for k, v in out.items()})
        if lr_after is not None and i == 0:
            state = jax_set_lr(state, np.float32(lr_after))
    return logs, export_torch_checkpoint({"params": state.params},
                                         "vgg2016", prefix="")


def _port(variables, grid=GRID, **options):
    model = get_model("vgg2016", device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, "vgg2016"))
    optimizer = make_optimizer(model, LR, WD)
    return model, optimizer, make_train_step(model, optimizer, grid=grid,
                                             **options)


def _port_run(variables, batches, targets, lr_after=None, **options):
    grid = _grid(batches)
    model, optimizer, step = _port(variables, grid, targets=targets,
                                   **options)
    logs = []
    for i, (images, kpts) in enumerate(batches):
        rest = ((kpts,) if targets == "device"
                else _host_targets(kpts, grid))
        out = step(*(torch.from_numpy(a) for a in (images,) + rest))
        logs.append({k: float(v) for k, v in out.items()})
        if lr_after is not None and i == 0:
            set_learning_rate(optimizer, lr_after)
    return logs, {k: v.numpy() for k, v in model.state_dict().items()}


def _check(got, want, start, lr=LR):
    got_logs, got_state = got
    want_logs, want_state = want
    assert set(got_logs[0]) == set(want_logs[0]) == set(
        loss_series_names()) | {"max_ht", "min_ht", "max_paf", "min_paf",
                                "Loss"}
    for step, (g, w) in enumerate(zip(got_logs, want_logs)):
        for name in w:
            np.testing.assert_allclose(g[name], w[name], rtol=5e-4,
                                       err_msg=f"step {step} {name}")
    env = inputs.update_envelope(got_state, want_state, start, lr,
                                 len(got_logs))
    assert env["ok"], env
    return env


def test_loss_matches_jax():
    """``cpm_loss`` on NCHW maps == the JAX package's on their NHWC
    transposes: the 12 stage sums, the extrema (background excluded from
    ``max_ht``/``min_ht``) and the total."""
    rng = np.random.default_rng(0)
    saved = [rng.normal(0, 1, (2, 38 if i % 2 == 0 else 19, 6, 7))
             .astype(np.float32) for i in range(12)]
    heat = rng.normal(0, 1, (2, 19, 6, 7)).astype(np.float32)
    paf = rng.normal(0, 1, (2, 38, 6, 7)).astype(np.float32)
    saved[-1][:, -1] = 9.0                     # a background that would win
    total, logs = cpm_loss([torch.from_numpy(s) for s in saved],
                           torch.from_numpy(heat), torch.from_numpy(paf))
    nhwc = [jnp.asarray(s.transpose(0, 2, 3, 1)) for s in saved]
    want_total, want = jax_cpm_loss(nhwc, jnp.asarray(heat.transpose(
        0, 2, 3, 1)), jnp.asarray(paf.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-6)
    assert set(logs) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(float(logs[name]), float(value),
                                   rtol=1e-6, err_msg=name)
    assert float(logs["max_ht"]) < 9.0


@pytest.mark.parametrize("targets", ["device", "host"])
def test_float32_lockstep_matches_jax(jax_step, variables, targets):
    """Device targets at lr 1e-4 for both steps; host targets with the
    rate set to 3e-4 after step 1 on both stacks (``set_learning_rate``
    against the JAX package's)."""
    batches = _batches(1)
    start = {k: v.numpy() for k, v in state_dict_from_jax(
        variables, "vgg2016").items()}
    lr_after = 3e-4 if targets == "host" else None
    env = _check(
        _port_run(variables, batches, targets, lr_after=lr_after),
        _jax_run(jax_step, variables, batches, targets, lr_after=lr_after),
        start, lr=lr_after or LR)
    if lr_after:
        assert env["median_update"] > 2 * LR   # step 2 took the new rate


def test_set_learning_rate_writes_every_group():
    model = get_model("mobilenet_thin", device="cpu")
    optimizer = make_optimizer(model, LR, WD, freeze_backbone=True)
    set_learning_rate(optimizer, 3e-4)
    assert [g["lr"] for g in optimizer.param_groups] == [3e-4]


def test_grad_accum_matches_jax(variables):
    """``grad_accum=2``: two micro-batches of 1, gradients averaged, one
    Adam step, against the JAX package's ``lax.scan`` accumulation (at
    32x32: its scan runs a 64x64 step 3-4x slower on the CPU than the
    plain step)."""
    model = jax_get_model("vgg2016")
    jax_accum = (model, jax_train_step(model, targets="host", grad_accum=2))
    batches = _batches(3, size=32)
    start = {k: v.numpy() for k, v in state_dict_from_jax(
        variables, "vgg2016").items()}
    _check(_port_run(variables, batches, "host", grad_accum=2),
           _jax_run(jax_accum, variables, batches, "host"), start)


def test_grad_accum_needs_equal_micro_batches(variables):
    _, _, step = _port(variables, targets="device", grad_accum=3)
    images, kpts = _batches(4, 1)[0]
    with pytest.raises(ValueError, match="micro-batches"):
        step(torch.from_numpy(images), torch.from_numpy(kpts))


def test_plateau_schedule_matches_jax():
    metrics = [10.0, 9.0, 9.0, 9.5, 9.2, 9.1, 9.05, 9.0, 8.99995, 9.3, 9.4,
               9.4, 9.4, 9.4, 9.4, 9.4, 7.0]
    port, ref = ReduceLROnPlateau(1e-3), JaxPlateau(1e-3)
    got = [port.step(m) for m in metrics]
    assert got == [ref.step(m) for m in metrics]
    assert got[-1] < got[0]
    assert port.state_dict() == ref.state_dict()


def test_eval_step_matches_jax(variables):
    """``make_eval_step`` (no backward, eval mode) == the JAX package's
    eval step on the same weights and batch."""
    from torch_ekpose_tpu.training import make_eval_step as jax_eval_step

    model = jax_get_model("vgg2016")
    state = create_train_state(model, variables, JAX_TX)
    images, kpts = _batches(5, 1)[0]
    want = jax_eval_step(model, targets="device", grid=GRID)(
        state, images, kpts)
    port = get_model("vgg2016", device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, "vgg2016"))
    got = make_eval_step(port, targets="device", grid=GRID)(
        torch.from_numpy(images), torch.from_numpy(kpts))
    assert not port.training
    for name, value in want.items():
        np.testing.assert_allclose(float(got[name]), float(value),
                                   rtol=5e-5, err_msg=name)


def test_bf16_step_tracks_jax_and_float32(jax_step, variables):
    """``compute_dtype=torch.bfloat16`` is the JAX package's mixed
    precision: the first-step loss within 1% of the JAX bf16 step's and
    within 5% of float32 (the JAX package's own bound,
    ``tests/test_training.py``); the loss falls over 2 steps on one
    batch; parameters and Adam moments stay float32."""
    images, kpts = _batches(6, 1)[0]
    batches = [(images, kpts)] * 2
    model = jax_get_model("vgg2016", dtype=jnp.bfloat16)
    jax_bf16, _ = _jax_run((model, jax_train_step(model, targets="host")),
                           variables, batches[:1], "device")
    port_f32, _ = _port_run(variables, batches[:1], "device")
    port, optimizer, step = _port(variables, targets="device",
                                  compute_dtype=torch.bfloat16)
    losses = [float(step(torch.from_numpy(images),
                         torch.from_numpy(kpts))["Loss"]) for _ in range(2)]
    assert abs(losses[0] - jax_bf16[0]["Loss"]) < 0.01 * jax_bf16[0]["Loss"]
    assert abs(losses[0] - port_f32[0]["Loss"]) < 0.05 * port_f32[0]["Loss"]
    assert losses[1] < losses[0]
    assert all(p.dtype == torch.float32 for p in port.parameters())
    moments = [t for s in optimizer.state.values() for k, t in s.items()
               if k in ("exp_avg", "exp_avg_sq")]
    assert len(moments) == 2 * len(list(port.parameters()))
    assert all(t.dtype == torch.float32 for t in moments)


def test_unported_target_mode_is_refused():
    """An unknown mode, and ``raw`` where it has no meaning (validation
    never augments), are refused; ``device`` and ``raw`` need the grid."""
    model = get_model("vgg2016", device="meta")
    optimizer = torch.optim.Adam([torch.zeros(1, requires_grad=True)])
    for targets in ("device", "raw"):
        with pytest.raises(ValueError, match="grid"):
            make_train_step(model, optimizer, targets=targets)
    with pytest.raises(ValueError, match="targets"):
        make_eval_step(model, targets="raw", grid=GRID)
    with pytest.raises(ValueError, match="targets"):
        make_eval_step(model, targets="pixels", grid=GRID)


def test_raw_step_matches_jax(jax_step, variables, monkeypatch):
    """``targets="raw"``: ``step(canvases_u8, valid_hw, keypoints,
    generator)`` augments on the device, rasterizes and steps. Against
    the JAX package's raw step (``augment_batch`` on a key, then its
    device targets and its step) on the same weights and canvases, the
    port's draws replaced by the JAX package's (the key's splits,
    replayed): the first step's 17 series within rtol 5e-4 (the first
    loss) and the parameters after it in the envelope (Adam's first step
    is ~lr * sign(g): the gradients' signs)."""
    import torch_ekpose_tpu_torch.data.device_aug as device_aug

    rng = np.random.default_rng(9)
    c = 96
    canvases = rng.integers(0, 256, (B, c, c, 3), dtype=np.uint8)
    valid = np.asarray([[c, c], [80, 90]], np.int32)
    canvases[1, 80:] = 0
    canvases[1, :, 90:] = 0
    kpts = inputs.train_batch(rng, B, c)[1]
    key = jax.random.PRNGKey(5)
    images, kp = jax_augment(canvases, valid, kpts, key, out_size=S)
    heat, paf = jax_target_fn(*GRID)(kp)
    model, step = jax_step
    state = jax_set_lr(create_train_state(model, variables, JAX_TX),
                       np.float32(LR))
    state, out = step(state, images, heat, paf)
    want = ([{k: float(v) for k, v in out.items()}],
            export_torch_checkpoint({"params": state.params}, "vgg2016",
                                    prefix=""))

    draws = tjm.jax_draws(key, B)
    monkeypatch.setattr(device_aug, "sample_params",
                        lambda batch, generator, *a, **kw: draws)
    port, _, port_step = _port(variables, targets="raw")
    logs = port_step(torch.from_numpy(canvases), torch.from_numpy(valid),
                     torch.from_numpy(kpts), torch.Generator())
    got = ([{k: float(v) for k, v in logs.items()}],
           {k: v.numpy() for k, v in port.state_dict().items()})
    start = {k: v.numpy() for k, v in state_dict_from_jax(
        variables, "vgg2016").items()}
    env = _check(got, want, start)
    assert env["median_update"] > 1e-5
