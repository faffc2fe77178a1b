"""The port's data-parallel training on the CPU: two gloo ranks against
one process on the global batch (``--spatial`` training:
``tests/test_torch_spatial.py``).

The two ranks run once for every data-parallel case
(``tests/torch_parallel_workers.py::dp_worker``); the one-process
references run here through the same ``step_model``, while the ranks
run. SGD steps are held
within rtol 1e-5 and atol 1e-7 (the JAX package's
``tests/test_training.py`` data-parallel tolerance): vgg2016 in float32
on the JAX test's problem at 32x32,
a BN model (mobilenetV2_small) in float64 with its running statistics,
because a BN model's float32 gradients are ill-conditioned on both
stacks (``tests/test_torch_train_bn.py``). The two-rank loss is also held
to the JAX package's 2-device mesh step on the same weights, through
``tests/data/torch_parallel_golden.npz``
(``scripts/make_torch_parallel_golden.py``).
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parallel_workers as workers  # noqa: E402
import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu_torch.cli import train as cli_train  # noqa: E402
from torch_ekpose_tpu_torch.data.device_aug import augment_batch  # noqa: E402
from torch_ekpose_tpu_torch.models.factory import (  # noqa: E402
    get_model, init_model)
from torch_ekpose_tpu_torch.models.layers import BatchNorm2d  # noqa: E402
from torch_ekpose_tpu_torch.training.trainer import aug_generator  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_parallel_golden.npz")
BN_NAME = "mobilenetV2_small"
RTOL, ATOL = 1e-5, 1e-7


@pytest.fixture(scope="module")
def case():
    return {
        "vgg": init_model("vgg2016", generator=torch.Generator().manual_seed(
            0), device="cpu").state_dict(),
        "bn_name": BN_NAME,
        "bn": inputs.working_state_dict(get_model(BN_NAME, device="cpu"), 0),
        "batch": inputs.sparse_batch(4, 32),
        "dense": inputs.train_batch(np.random.default_rng(3), 4, 32),
    }


def _series(log_dir: str) -> dict:
    """The train series of one epoch's ``metrics.jsonl``."""
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["name"]: r["value"] for r in rows
            if r["name"].endswith("/train")
            and not r["name"].startswith(("BatchTime", "DataTime"))}


def _references(case, work: str) -> dict:
    """One process on the global batch, for each case the ranks run."""
    dense = case["dense"]
    out = {
        "sgd": workers.step_model("vgg2016", case["vgg"], *case["batch"]),
        "bn": workers.step_model(BN_NAME, case["bn"], *dense,
                                 dtype=torch.float64, lr=1e-3),
        # micro-step j of the ranks holds global rows j and 2 + j
        "accum": workers.step_model(
            BN_NAME, case["bn"], *(a[[0, 2, 1, 3]] for a in dense),
            dtype=torch.float64, lr=1e-3, grad_accum=2),
    }
    with pytest.MonkeyPatch.context() as patch:
        patch.setitem(sys.modules, "torch.utils.tensorboard", None)
        one = workers._trainer(BN_NAME, os.path.join(work, "one"))
        one.fit([dense], None, epochs=1, verbose=False)
        one.metrics.close()
    out["logs"] = _series(os.path.join(work, "one_logs"))
    return out


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    """What the two ranks wrote (one start for every case), and under
    ``"one"`` the one-process references, computed while they run."""
    work = str(tmp_path_factory.mktemp("ranks"))
    torch.save(case, os.path.join(work, "case.pt"))
    running = workers.start_ranks(workers.dp_worker, 2, work)
    try:
        one = _references(case, work)
    except BaseException:
        for process in running.processes:
            process.terminate()
        raise
    while not running.join():
        pass
    out = torch.load(os.path.join(work, "results.pt"), weights_only=False)
    out.update(work=work, one=one)
    return out


def _assert_states(got: dict, want: dict) -> None:
    inputs.assert_states_close(got, want, rtol=RTOL, atol=ATOL)


def _moved(after: dict, before: dict) -> float:
    return max(float((after[k].double() - before[k].double()).abs().max())
               for k in before if before[k].is_floating_point())


def test_dp_sgd_step_matches_one_process(case, ranks):
    loss, state = ranks["sgd"]
    want_loss, model, _ = ranks["one"]["sgd"]
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL)
    _assert_states(state, model.state_dict())
    assert _moved(state, case["vgg"]) > 1e-6


def test_dp_grad_accum_matches_one_process(case, ranks):
    """``--grad-accum 2`` on the BN model: each rank's micro-steps but the
    last skip the all-reduce (``no_sync``), and each micro-step's BN
    statistics span both ranks: micro-step ``j`` holds global rows ``j``
    and ``2 + j``, which one process takes in that order."""
    loss, state = ranks["accum"]
    want_loss, model, _ = ranks["one"]["accum"]
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL)
    _assert_states(state, model.state_dict())


def test_dp_logs_are_the_global_batchs(ranks):
    """Rank 0 logs, once an epoch, the series of the GLOBAL batch: the
    stage sums added over the ranks, ``Loss`` their mean, the extrema
    the max / min, as one process logs them on the whole batch. Within
    rtol 1e-4: the ranks' BN normalizes by the global E[x^2] - mean^2,
    one process's by torch's own variance, and through the BN model's
    ~100 BN layers the float32 maps part by ~1e-5 (float64 BN parity:
    ``test_dp_bn_step_matches_one_process``)."""
    got = _series(os.path.join(ranks["work"], "logs_logs"))
    want = ranks["one"]["logs"]
    assert got.keys() == want.keys() and len(want) == 17
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=1e-4, err_msg=name)


def test_dp_loss_matches_the_jax_mesh_step(case, ranks):
    """The two ranks' global loss and parameter change equal the JAX
    package's step on its 2-device mesh, on the same weights and batch:
    the change of every parameter at its golden sample of elements, and
    its largest |change|, within 2% of that largest change (plus 1e-7,
    float32's rounding of parameters near 1). Measured: 1.6e-2 at worst
    (a bias whose change is 3e-6), 1.7e-7 at the median; one rank's
    half-batch gradient without the all-reduce misses by 1.7 at worst
    and 0.23 at the median; a summed instead of averaged gradient
    would miss by the change itself."""
    golden = np.load(GOLDEN)
    np.testing.assert_allclose(ranks["sgd"][0], float(golden["Loss"]),
                               rtol=RTOL)
    after, before = ranks["sgd"][1], case["vgg"]
    ends = np.cumsum(golden["delta_count"])
    assert len(golden["delta_keys"]) == sum(
        v.is_floating_point() for v in before.values())
    for key, end, count, largest in zip(
            golden["delta_keys"], ends, golden["delta_count"],
            golden["delta_max"]):
        delta = (after[key].double() - before[key].double()).numpy().ravel()
        limit = 0.02 * largest + 1e-7
        index = golden["delta_index"][end - count:end]
        np.testing.assert_allclose(delta[index],
                                   golden["delta_value"][end - count:end],
                                   rtol=0, atol=limit, err_msg=key)
        assert abs(np.abs(delta).max() - largest) <= limit, key


def test_dp_bn_step_matches_one_process(case, ranks):
    """BN's statistics span both ranks' batches: the step and the running
    mean and variance (Bessel over the global count) equal one process's
    on the global batch."""
    loss, state = ranks["bn"]
    want_loss, model, _ = ranks["one"]["bn"]
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL)
    _assert_states(state, model.state_dict())
    stats = [k for k in state if k.endswith("running_var")]
    assert stats and _moved({k: state[k] for k in stats},
                            {k: case["bn"][k] for k in stats}) > 1e-3


def test_zero1_matches_dp_after_three_adam_steps(ranks):
    """ZeRO-1 takes the same three Adam steps as plain data parallelism,
    and each rank holds about half of the moments."""
    dp_loss, dp_state, _ = ranks["adam"]
    z_loss, z_state, shares = ranks["zero1"]
    np.testing.assert_allclose(z_loss, dp_loss, rtol=RTOL)
    _assert_states(z_state, dp_state)
    total = shares[0][1]
    assert sum(held for held, _ in shares) == total
    assert all(0.3 < held / total < 0.7 for held, _ in shares), shares
    assert ranks["adam"][2][0][0] == total        # plain Adam: every rank all


def test_zero1_checkpoint_restores_into_dp_and_back(ranks):
    """A ``--zero1`` trainer's checkpoint holds the whole Adam state,
    which a plain data-parallel trainer restores, and the plain trainer's
    checkpoint restores into a ZeRO-1 trainer unchanged."""
    work = ranks["work"]

    def load(name):
        return torch.load(os.path.join(work, name), weights_only=False)

    zero, plain, again = (load(n) for n in (
        "zero1.ckpt", "plain.ckpt", "zero1_again.ckpt"))
    n_params = len(zero["model"]) - sum(
        k.endswith(("running_mean", "running_var", "num_batches_tracked"))
        for k in zero["model"])
    for ckpt, steps in ((zero, 1), (plain, 2), (again, 2)):
        state = ckpt["optimizer"]["state"]
        assert len(state) == n_params
        assert {float(s["step"]) for s in state.values()} == {steps}
    assert again["optimizer"]["param_groups"] == \
        plain["optimizer"]["param_groups"]
    assert again["optimizer"]["state"].keys() == \
        plain["optimizer"]["state"].keys()
    for i, s in plain["optimizer"]["state"].items():
        assert float(s["step"]) == float(again["optimizer"]["state"][i][
            "step"])
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(s[name], again["optimizer"]["state"][i][name])
            assert not torch.equal(s[name], zero["optimizer"]["state"][i][
                name])


def test_preemption_on_one_rank_stops_both_at_the_same_batch(ranks):
    """Rank 1 alone is flagged at batch 1; the ranks agree on it at the
    next sync point (batch 2), both having taken 2 steps, and rank 0
    writes ``preempt.ckpt``."""
    assert ranks["preempt"] == [(2, True), (2, True)]
    path = os.path.join(ranks["work"], "preempt", "preempt.ckpt")
    saved = torch.load(path, weights_only=False)
    assert (saved["epoch"], saved["step"]) == (0, 2)


def test_raw_draws_of_two_ranks_equal_one_process():
    """Each rank draws the global batch's augmentation and keeps its
    slice: two ranks augment exactly as one process on the global batch."""
    rng = np.random.default_rng(5)
    canvases = torch.from_numpy(rng.integers(0, 256, (4, 96, 96, 3),
                                             dtype=np.uint8))
    valid = torch.tensor([[96, 96], [80, 96], [96, 64], [72, 72]],
                         dtype=torch.int32)
    kpts = torch.from_numpy(inputs.train_batch(rng, 4, 96, people=2)[1])
    whole = augment_batch(canvases, valid, kpts, aug_generator(0, 1, 2), 64)
    halves = [augment_batch(*(a[r * 2:(r + 1) * 2] for a in (
        canvases, valid, kpts)), aug_generator(0, 1, 2), 64, shard=(r, 2))
        for r in range(2)]
    for i, want in enumerate(whole):
        assert torch.equal(torch.cat([h[i] for h in halves]), want)


def test_bn_without_ranks_or_stripes_is_torchs():
    """With no process group and no stripes the port's BN computes what
    ``nn.BatchNorm2d`` does, bit for bit, in training and eval mode."""
    torch.manual_seed(0)
    ours, ref = BatchNorm2d(5), torch.nn.BatchNorm2d(5)
    x = torch.randn(3, 5, 6, 7)
    for train in (True, False):
        ours.train(train), ref.train(train)
        assert torch.equal(ours(x), ref(x))
    assert torch.equal(ours.running_var, ref.running_var)


def test_raw_cache_wait_ends_on_failure_stall_or_the_cache(tmp_path,
                                                           monkeypatch):
    """A rank waiting for rank 0's raw cache exits when rank 0 writes a
    failure, exits when the decoded count stops moving for
    ``RAW_CACHE_STALL_S``, and returns once the cache is complete however
    long a moving build takes (no fixed wall clock)."""
    prefix = str(tmp_path / "c")
    progress = f"{prefix}_progress.json"

    def write(done, failed=None):
        with open(progress, "w") as f:
            json.dump({"done": done, "n": 9, "failed": failed}, f)

    write(3, failed="OSError: disk full")
    with pytest.raises(SystemExit, match="disk full"):
        cli_train.wait_for_cache(prefix, poll=0.01)
    monkeypatch.setattr(cli_train, "RAW_CACHE_STALL_S", 0.2)
    write(3)
    with pytest.raises(SystemExit, match="no progress"):
        cli_train.wait_for_cache(prefix, poll=0.01)

    def build():
        for done in range(4, 10):      # 0.6 s of steady progress
            time.sleep(0.1)
            write(done)
        for name in ("images", "valid", "kpts"):
            np.save(f"{prefix}_{name}.npy", np.zeros(1))
        with open(f"{prefix}_meta.json", "w") as f:
            json.dump({"n": 9, "canvas": 8, "max_people": 1}, f)

    builder = threading.Thread(target=build)
    builder.start()
    cli_train.wait_for_cache(prefix, poll=0.01)
    builder.join()
