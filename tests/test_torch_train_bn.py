"""The port's train step on a BatchNorm model (mobilenetV2_small) against
the JAX package's, and the frozen-backbone warmup, on the CPU.

BN in train mode normalizes with the batch statistics and updates the
running ones with torch's unbiased variance, which the JAX package's
``TorchBatchNorm`` copies. Its float32 gradients are ill-conditioned on
both stacks: a channel's gradient is a difference of nearly equal sums,
so step 1's Adam (~lr * sign(g)) moves some elements the other way on
each side, and the second forward reads other weights (measured: 61-65%
of the parameters within 1e-5 after 2 float32 steps; 99.8% after one).
So the 2-step lockstep holds the envelope of
``tests/test_torch_train_step.py`` with both stacks in float64 (the
predictions still rounded to float32 by each ``cpm_loss``): every series
within rtol 5e-4, the parameters >= 99.9% within 1e-5 (mean < 2e-6, max
<= 4 lr + 1e-6, median update > 1e-5) and the running statistics within
rtol 1e-4 (atol 1e-6: channels whose mean is zero by construction hold
float noise). Float32 is held on the first train-mode forward: its 17
series and the running statistics it leaves. Weights: the reference's
init (``init_model``), through ``export``/``convert``. The JAX float64
step is compiled once for both cases (~40 s of CPU a compile): the
frozen backbone's reference is that step with ``model0``'s parameters
put back after each step, which is what the JAX package's
``make_optimizer(freeze_backbone=True)`` computes (``set_to_zero`` on
``model0``; the weight decay and Adam act element by element, so
``model0``'s own moments move nothing else). The same step carries the
restore lockstep: a JAX trainer ``.ckpt`` written after step 1 and
restored by each package's ``Trainer`` takes step 2 alike.
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu.config import (  # noqa: E402
    get_default_config as jax_config)
from torch_ekpose_tpu.data.targets import (  # noqa: E402
    make_batched_target_fn as jax_target_fn)
from torch_ekpose_tpu.models import get_model as jax_get_model  # noqa: E402
from torch_ekpose_tpu.runtime.checkpoint import (  # noqa: E402
    convert_torch_checkpoint, export_torch_checkpoint)
from torch_ekpose_tpu.training import cpm_loss as jax_cpm_loss  # noqa: E402
from torch_ekpose_tpu.training import create_train_state  # noqa: E402
from torch_ekpose_tpu.training import make_optimizer as jax_optimizer  # noqa: E402
from torch_ekpose_tpu.training import make_train_step as jax_train_step  # noqa: E402
from torch_ekpose_tpu.training import (  # noqa: E402
    set_learning_rate as jax_set_lr)
from torch_ekpose_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from torch_ekpose_tpu_torch.config import get_default_config  # noqa: E402
from torch_ekpose_tpu_torch.models.factory import (  # noqa: E402
    get_model, init_model)
from torch_ekpose_tpu_torch.training import (  # noqa: E402
    Trainer, cpm_loss, make_optimizer, make_train_step)

torch.set_num_threads(2)  # xdist already runs one process per core

NAME, LR, WD = "mobilenetV2_small", 1e-4, 5e-4
S, B, GRID = 64, 2, (8, 8)


@pytest.fixture(scope="module")
def start():
    """The reference's seeded init: (port state_dict, JAX variables)."""
    state = init_model(NAME, generator=torch.Generator().manual_seed(0),
                       device="cpu").state_dict()
    return state, convert_torch_checkpoint(
        {k: v.numpy() for k, v in state.items()}, NAME)


def _batches(seed: int, n: int = 2):
    rng = np.random.default_rng(seed)
    return [inputs.train_batch(rng, B, S) for _ in range(n)]


@pytest.fixture(scope="module")
def jax64():
    """The JAX package's float64 model, optimizer and step: one optimizer
    object, which the train state carries as a static field, so both
    cases share one compile."""
    with jax.enable_x64(True):
        model = jax_get_model(NAME, dtype=jnp.float64)
        return model, jax_optimizer(LR, WD), jax_train_step(model,
                                                             targets="host")


def _jax64_state(jax64, variables):
    """The float64 train state, its rate a strong float64 (the state the
    step returns has one, so every step runs one compile); call under
    ``jax.enable_x64``."""
    model, tx, _ = jax64
    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    return jax_set_lr(create_train_state(model, v64, tx), np.float64(LR))


def _jax64_run(jax64, variables, batches, freeze_backbone=False):
    model, tx, step = jax64
    with jax.enable_x64(True):
        state = _jax64_state(jax64, variables)
        backbone = state.params["model0"]
        logs = []
        for images, kpts in batches:
            heat, paf = jax_target_fn(*GRID)(kpts)
            state, out = step(state, images.astype(np.float64), heat, paf)
            if freeze_backbone:
                state = state.replace(params=type(state.params)(
                    {**state.params, "model0": backbone}))
            logs.append({k: float(v) for k, v in out.items()})
        return logs, export_torch_checkpoint(
            {"params": state.params, "batch_stats": state.batch_stats},
            NAME, prefix="")


def _port_run(state, batches, dtype, freeze_backbone=False):
    model = get_model(NAME, device="cpu")
    model.load_state_dict(state)
    model.to(dtype)
    optimizer = make_optimizer(model, LR, WD, freeze_backbone)
    step = make_train_step(model, optimizer, targets="device", grid=GRID)
    logs = [{k: float(v) for k, v in step(
        torch.from_numpy(images).to(dtype), torch.from_numpy(kpts)).items()}
        for images, kpts in batches]
    return logs, {k: v.numpy() for k, v in model.state_dict().items()}


def _check_series(got, want, rtol=5e-4):
    for step, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for name in w:
            np.testing.assert_allclose(g[name], w[name], rtol=rtol,
                                       err_msg=f"step {step} {name}")


@pytest.mark.parametrize("freeze_backbone", [False, True],
                         ids=["lockstep", "frozen_backbone"])
def test_float64_lockstep_matches_jax(start, jax64, freeze_backbone):
    """Two steps in float64 on both stacks. ``frozen_backbone`` is the
    reference's warmup: the port's ``model0`` parameters stay as they
    were, bitwise, while its BN running statistics move as the JAX
    package's do."""
    state, variables = start
    batches = _batches(1)
    got_logs, got = _port_run(state, batches, torch.float64,
                              freeze_backbone)
    want_logs, want = _jax64_run(jax64, variables, batches,
                                 freeze_backbone)
    _check_series(got_logs, want_logs)
    begin = {k: v.numpy() for k, v in state.items()}
    env = inputs.update_envelope(got, want, begin, LR)
    assert env["ok"], env
    assert inputs.stats_mismatches(got, want) == []
    if freeze_backbone:
        for key, value in begin.items():
            if key.startswith("model0.") and "running_" not in key \
                    and not key.endswith("num_batches_tracked"):
                np.testing.assert_array_equal(got[key], value, err_msg=key)
        moved = [k for k in begin if k.startswith("model0.")
                 and k.endswith("running_var")
                 and not np.array_equal(got[k], begin[k])]
        assert len(moved) > 20
        assert not np.array_equal(got["model1_1.0.pointwise.weight"],
                                  begin["model1_1.0.pointwise.weight"])


def test_float32_train_forward_matches_jax(start):
    """The first float32 step's forward: the 17 series and the running
    statistics BN leaves (rtol 1e-4, atol 1e-6) equal the JAX package's
    ``apply(train=True, mutable=["batch_stats"])``."""
    state, variables = start
    images, kpts = _batches(2, 1)[0]
    model = jax_get_model(NAME)
    (_, saved), updated = jax.jit(lambda v, x: model.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, images)
    heat, paf = jax_target_fn(*GRID)(kpts)
    want_total, want = jax_cpm_loss(saved, heat, paf)
    want = {k: float(v) for k, v in want.items()}
    want["Loss"] = float(want_total)
    want_stats = export_torch_checkpoint(
        {"params": variables["params"],
         "batch_stats": updated["batch_stats"]}, NAME, prefix="")
    got_logs, got = _port_run(state, [(images, kpts)], torch.float32)
    _check_series(got_logs, [want])
    assert inputs.stats_mismatches(got, want_stats) == []


def test_train_mode_bn_uses_the_unbiased_variance(start):
    """After one train forward, ``running_var`` = 0.9 * 1 + 0.1 *
    unbiased batch variance (torch's rule, which the JAX package's
    ``TorchBatchNorm`` copies), not the biased one."""
    state, _ = start
    model = get_model(NAME, device="cpu").double()
    model.load_state_dict(state)
    seen = []
    bn = model.model0.features[1]
    bn.register_forward_hook(lambda m, i, o: seen.append(i[0].clone()))
    images, _ = _batches(3, 1)[0]
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(images).double().permute(0, 3, 1, 2))
    (x,) = seen
    delta = (bn.running_var - 0.9) / 0.1
    unbiased = x.var(dim=(0, 2, 3), unbiased=True)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(delta, unbiased, rtol=1e-9, atol=0)
    assert bool(((delta - biased).abs() > 1e-6).all())


def test_restored_trainer_steps_as_jax(start, jax64, tmp_path, monkeypatch):
    """A JAX trainer ``.ckpt`` (``Trainer.save`` after one float64 step)
    restored by the port's ``Trainer`` (float64 model; the flax reader and
    the optax -> Adam mapping) takes step 2 as the JAX ``Trainer`` restored
    from the same file does: the 17 series within rtol 5e-4, the
    parameters in the 2-step envelope, the running statistics within rtol
    1e-4."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    model, tx, step = jax64
    state, variables = start
    (b1, k1), (b2, k2) = _batches(4)
    heat1, paf1 = jax_target_fn(*GRID)(k1)
    heat2, paf2 = jax_target_fn(*GRID)(k2)
    path = str(tmp_path / "epoch_0.ckpt")
    cfg = jax_config()
    cfg.TRAIN.square_size = S
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        state1, _ = step(_jax64_state(jax64, variables),
                         b1.astype(np.float64), heat1, paf1)
        writer = JaxTrainer(NAME, config=cfg, variables=v64,
                            out_dir=str(tmp_path / "w"),
                            log_dir=str(tmp_path / "wl"))
        writer.state = state1
        writer.save(path)
        reader = JaxTrainer(NAME, config=cfg, variables=v64,
                            out_dir=str(tmp_path / "r"),
                            log_dir=str(tmp_path / "rl"))
        reader.restore(path)
        # the JAX trainer's own tx is another static object and its mesh
        # another placement: keep the compiled step's, with the restored
        # values on the host and the counter weakly typed as it was
        restored = state1.replace(
            params=jax.device_get(reader.state.params),
            batch_stats=jax.device_get(reader.state.batch_stats),
            opt_state=jax.device_get(reader.state.opt_state),
            step=jnp.asarray(int(reader.state.step)))
        state2, out = step(restored, b2.astype(np.float64), heat2, paf2)
        want_logs = [{k: float(v) for k, v in out.items()}]
        want = export_torch_checkpoint(
            {"params": state2.params, "batch_stats": state2.batch_stats},
            NAME, prefix="")

    pcfg = get_default_config()
    pcfg.TRAIN.square_size = S
    port = Trainer(NAME, config=pcfg, out_dir=str(tmp_path / "p"),
                   log_dir=str(tmp_path / "pl"), device="cpu")
    port.model.double()
    port.restore(path)
    assert (port.step, port.epoch) == (1, 1)
    got_logs = [{k: float(v) for k, v in port.train_step(
        torch.from_numpy(b2).double(), torch.from_numpy(k2)).items()}]
    got = {k: v.numpy() for k, v in port.model.state_dict().items()}
    _check_series(got_logs, want_logs)
    begin = {k: v.numpy() for k, v in state.items()}
    env = inputs.update_envelope(got, want, begin, LR)
    assert env["ok"], env
    assert inputs.stats_mismatches(got, want) == []
