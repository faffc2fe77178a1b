"""The port's flax msgpack reader (``runtime/flax_msgpack.py``) and what
rides on it, against ``flax.serialization`` on the CPU.

- Files the JAX package writes read bit-equal, leaf for leaf, to
  ``flax.serialization.msgpack_restore`` of the same bytes: its native
  checkpoints (``runtime/checkpoint.py::save_checkpoint``) in float32,
  bfloat16 (a ``torch.bfloat16`` tensor of the same bits), int8 and
  calibrated int8, and its trainer's ``.ckpt`` (``Trainer.save``), with and
  without the frozen-backbone optimizer; flax's chunked arrays; every
  msgpack type the format can hold.
- The port's ``Trainer.restore`` maps a JAX trainer ``.ckpt``: parameters
  and BN statistics as the weight bridge maps them, Adam's ``mu``/``nu``
  to ``exp_avg``/``exp_avg_sq`` (OIHW), ``count`` to ``step``, the rate to
  the groups' ``lr``, and ``step``, ``epoch``, ``best_val``, the scheduler
  and the curves. (The restored step against the JAX package's restored
  step is ``tests/test_torch_train_bn.py``'s lockstep.)
- The port imports neither flax nor msgpack for any of it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
serialization = pytest.importorskip("flax.serialization")
msgpack = pytest.importorskip("msgpack")

import jax.numpy as jnp  # noqa: E402

import torch_jax_models as tjm  # noqa: E402
from torch_ekpose_tpu.config import get_default_config  # noqa: E402
from torch_ekpose_tpu.models import cast_params as jax_cast  # noqa: E402
from torch_ekpose_tpu.models import get_model as jax_get_model  # noqa: E402
from torch_ekpose_tpu.models import quantize_variables as jax_quantize  # noqa: E402
from torch_ekpose_tpu.runtime.checkpoint import save_checkpoint  # noqa: E402
from torch_ekpose_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from torch_ekpose_tpu_torch.cli.common import load_variables  # noqa: E402
from torch_ekpose_tpu_torch.config import (  # noqa: E402
    get_default_config as port_config)
from torch_ekpose_tpu_torch.runtime.checkpoint import (  # noqa: E402
    params_from_jax, state_dict_from_jax)
from torch_ekpose_tpu_torch.runtime.flax_msgpack import (  # noqa: E402
    read_flax_msgpack, unpack)
from torch_ekpose_tpu_torch.training import Trainer  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

NAME = "mobilenetV2_small"


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """Both trainers' metrics writers fall back to their JSONL files:
    importing TensorBoard (TensorFlow) would cost ~18 s a process."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def assert_same_tree(got, want, path="") -> int:
    """``got`` (the port's reader) == ``want`` (flax's), bit for bit and
    type for type; returns the number of array leaves."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        return sum(assert_same_tree(got[k], want[k], f"{path}/{k}")
                   for k in want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        return sum(assert_same_tree(g, w, path) for g, w in zip(got, want))
    if isinstance(want, (np.ndarray, np.generic)) and \
            want.dtype == jnp.bfloat16:
        assert torch.is_tensor(got) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(np.uint16),
            np.asarray(want).view(np.uint16), err_msg=path)
        return 1
    if isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), (path, type(got), type(want))
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
        return 1
    assert type(got) is type(want) and got == want, (path, got, want)
    return 0


def _read_both(path):
    with open(path, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    return read_flax_msgpack(path), want


@pytest.fixture(scope="module")
def vgg_variables():
    return tjm.jax_variables("vgg2016")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8",
                                   "int8_static"])
def test_native_checkpoints_read_bit_equal(tmp_path, vgg_variables, dtype):
    """The JAX package's ``save_checkpoint`` of a variable tree in each of
    its ``cli.export`` dtypes (mobilenetV2_small's tree, with BN, for the
    float ones; vgg2016's for int8), read by the port as flax reads it;
    the weight bridge then maps it (int8: ``weight_q`` OIHW, ``scale``,
    ``bias``[, ``act_scale``])."""
    if dtype.startswith("int8"):
        name = "vgg2016"
        quantize = "static" if dtype == "int8_static" else True
        variables = jax_quantize(vgg_variables, jax_get_model(
            name, dtype=jnp.bfloat16, quantize=quantize))
    else:
        name = NAME
        variables = tjm.jax_variables(name)
        if dtype == "bfloat16":
            variables = jax_cast(variables, jnp.bfloat16)
    path = str(tmp_path / f"{dtype}.msgpack")
    save_checkpoint(path, variables)
    got, want = _read_both(path)
    assert assert_same_tree(got, want) > 50
    state = load_variables(name, path)
    bridge = state_dict_from_jax(want, name)
    assert sorted(state) == sorted(bridge)
    if dtype.startswith("int8"):
        q = state["model0.backbone.2.weight_q"]
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(
            q.permute(2, 3, 1, 0).numpy(),
            want["params"]["model0"]["conv_2"]["conv"]["kernel_q"])
        assert ("model0.backbone.2.act_scale" in state) == (
            dtype == "int8_static")
    if dtype == "bfloat16":
        assert state["model1_1.0.pointwise.weight"].dtype == torch.bfloat16


def _jax_trainer(tmp_path, freeze_backbone: bool):
    cfg = get_default_config()
    cfg.TRAIN.square_size = 32
    return JaxTrainer(NAME, config=cfg, variables=tjm.jax_variables(NAME),
                      out_dir=str(tmp_path / "jax_out"),
                      log_dir=str(tmp_path / "jax_logs"),
                      freeze_backbone=freeze_backbone)


def _fill_moments(trainer, seed: int):
    """Random Adam moments, count and rate in the JAX trainer's state, so
    the mapping is not checked on zeros."""
    rng = np.random.default_rng(seed)

    def fill(leaf):
        leaf = np.asarray(leaf)
        if leaf.dtype == np.float32 and leaf.ndim:
            return rng.normal(0, 1, leaf.shape).astype(np.float32)
        return leaf

    opt = jax.tree.map(fill, trainer.state.opt_state)
    count = np.asarray(7, np.int32)

    def set_count(state):
        adam = state.inner_state[1][0]._replace(count=count)
        return state._replace(
            count=count,
            hyperparams={"learning_rate": np.asarray(3e-4, np.float32)},
            inner_state=(state.inner_state[0],
                         (adam,) + tuple(state.inner_state[1][1:])))

    if hasattr(opt, "inner_states"):
        inner = dict(opt.inner_states)
        inner["train"] = inner["train"]._replace(
            inner_state=set_count(inner["train"].inner_state))
        opt = opt._replace(inner_states=inner)
    else:
        opt = set_count(opt)
    trainer.state = trainer.state.replace(opt_state=opt, step=count)
    trainer.epoch, trainer.best_val = 4, 123.5
    trainer.train_curve = {"train": [3.0, 2.5], "val": [4.0, 3.25]}
    trainer.scheduler.step(9.0)


@pytest.mark.parametrize("freeze_backbone", [False, True],
                         ids=["adam", "frozen_backbone"])
def test_trainer_ckpt_reads_and_restores(tmp_path, freeze_backbone):
    """A JAX trainer ``.ckpt`` (``Trainer.save``; under the frozen
    backbone, ``multi_transform`` with no moments for ``model0``) reads
    bit-equal, and the port's ``Trainer.restore`` maps every piece."""
    jt = _jax_trainer(tmp_path, freeze_backbone)
    _fill_moments(jt, 1 + freeze_backbone)
    path = str(tmp_path / "epoch_4.ckpt")
    jt.save(path)
    got, want = _read_both(path)
    assert assert_same_tree(got, want) > 100

    cfg = port_config()
    cfg.TRAIN.square_size = 32
    port = Trainer(NAME, config=cfg, out_dir=str(tmp_path / "out"),
                   log_dir=str(tmp_path / "logs"), device="cpu",
                   freeze_backbone=freeze_backbone)
    port.restore(path)
    state = port.model.state_dict()
    for key, value in state_dict_from_jax(want, NAME).items():
        torch.testing.assert_close(state[key], value, rtol=0, atol=0,
                                   msg=key)
    opt = want["opt_state"]
    if freeze_backbone:
        assert opt["inner_states"]["frozen"] == {"inner_state": {}}
        opt = opt["inner_states"]["train"]["inner_state"]
    adam = opt["inner_state"]["1"]["0"]
    mu = params_from_jax(adam["mu"], NAME, partial=True)
    nu = params_from_jax(adam["nu"], NAME, partial=True)
    params = dict(port.model.named_parameters())
    assert any(k.startswith("model0.") for k in mu) != freeze_backbone
    assert len(port.optimizer.state) == len(mu) > 50
    for name, value in mu.items():
        entry = port.optimizer.state[params[name]]
        torch.testing.assert_close(entry["exp_avg"], value, rtol=0, atol=0)
        torch.testing.assert_close(entry["exp_avg_sq"], nu[name], rtol=0,
                                   atol=0)
        assert float(entry["step"]) == 7.0
    assert [g["lr"] for g in port.optimizer.param_groups] == [
        float(np.float32(3e-4))]
    # the JAX trainer saves the epoch to resume at, one past its own
    assert (port.step, port.epoch, port.best_val) == (7, 5, 123.5)
    assert port.train_curve == {"train": [3.0, 2.5], "val": [4.0, 3.25]}
    assert port.scheduler.state_dict() == {
        k: (v.item() if hasattr(v, "item") else v)
        for k, v in jt.scheduler.state_dict().items()}


def test_trainer_refuses_moments_of_another_optimizer(tmp_path):
    """A frozen-backbone state cannot seed an optimizer that trains the
    backbone too."""
    jt = _jax_trainer(tmp_path, True)
    path = str(tmp_path / "frozen.ckpt")
    jt.save(path)
    port = Trainer(NAME, out_dir=str(tmp_path / "out"),
                   log_dir=str(tmp_path / "logs"), device="cpu")
    with pytest.raises(ValueError, match="freeze_backbone"):
        port.restore(path)


def test_chunked_arrays_read_bit_equal(tmp_path, monkeypatch):
    """flax splits a leaf over ``MAX_CHUNK_SIZE`` bytes into flat chunks
    (2**30 in use; set small here): float32, bfloat16 and int8 leaves come
    back whole, at their shapes, as flax's reader gives them."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(7, 111)).astype(np.float32),
            "b": {"c": np.asarray(jnp.asarray(rng.normal(size=(3, 500)),
                                              jnp.bfloat16)),
                  "d": rng.integers(-128, 128, (50, 41), dtype=np.int8)},
            "small": np.arange(5, dtype=np.int64)}
    path = str(tmp_path / "chunked.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize(tree))
    got, want = _read_both(path)
    assert assert_same_tree(got, want) == 4
    assert got["a"].shape == (7, 111) and got["b"]["c"].shape == (3, 500)


def test_every_msgpack_type_decodes():
    """Integers of every width and sign, floats of both widths, str and
    bin of every length class, arrays and maps of every size class, nil,
    booleans, and flax's complex and numpy-scalar extensions."""
    value = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
                 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                 -2**31, -2**31 - 1, -2**63],
        "floats": [0.5, -1e300, float("inf")],
        "strs": ["", "x" * 31, "y" * 32, "z" * 255, "w" * 256,
                 "v" * 65536, "ünï"],
        "bins": [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536],
        "arrays": [list(range(15)), list(range(16)),
                   list(range(65536))],
        "maps": [{str(i): i for i in range(15)},
                 {str(i): i for i in range(16)},
                 {str(i): i for i in range(65536)}],
        "misc": [None, True, False],
    }
    packed = msgpack.packb(value, use_bin_type=True)
    got = unpack(packed)
    assert {k: v for k, v in got.items() if k != "bins"} == {
        k: v for k, v in value.items() if k != "bins"}
    assert [bytes(b) for b in got["bins"]] == value["bins"]
    assert unpack(msgpack.packb(1.5, use_single_float=True)) == 1.5
    ext = {"c": complex(2.0, -3.5), "s": np.float32(2.5),
           "i": np.int64(-4), "h": np.asarray(jnp.bfloat16(1.5))[()]}
    tree = serialization.msgpack_restore(serialization.msgpack_serialize(ext))
    port = unpack(serialization.msgpack_serialize(ext))
    assert port["c"] == tree["c"] == complex(2.0, -3.5)
    assert type(port["s"]) is np.float32 and port["s"] == 2.5
    assert type(port["i"]) is np.int64 and port["i"] == -4
    assert port["h"].dtype == torch.bfloat16 and float(port["h"]) == 1.5
    with pytest.raises(ValueError, match="after the msgpack document"):
        unpack(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        unpack(msgpack.packb("abcdef")[:-1])


def test_reader_needs_neither_flax_nor_msgpack(tmp_path):
    """In a process where flax, msgpack and jax cannot be imported, the
    port reads a flax file (``tests/test_torch_slice.py`` imports every
    module of the port without them)."""
    path = str(tmp_path / "tree.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize(
            {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}))
    code = (
        "import sys\n"
        "for name in ('flax', 'msgpack', 'jax'):\n"
        "    sys.modules[name] = None\n"
        "from torch_ekpose_tpu_torch.runtime.flax_msgpack import "
        "read_flax_msgpack\n"
        f"tree = read_flax_msgpack({path!r})\n"
        "assert tree['w'].tolist() == [[0, 1, 2], [3, 4, 5]], tree\n"
        "import torch_ekpose_tpu_torch.runtime.checkpoint\n"
        "print('ok')\n"
    )
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
