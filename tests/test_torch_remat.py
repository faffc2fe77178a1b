"""``--remat`` and the bf16 cast at use, on the port alone (CPU).

``get_model(..., remat=True)`` runs the backbone and each CPM branch
under ``torch.utils.checkpoint`` (non-reentrant): the loss and every
gradient must be bitwise the port's own without remat, with in-place
ReLUs in the recomputed units, and BN's running statistics must update
once per forward (the recomputation's second update is undone). The
bf16 train step casts each conv's weight and bias at use through
``torch.func.functional_call``: its gradients must be bitwise those of a
copy of the model whose convs hold the bf16 weights (BN float32), cast
back to float32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu_torch.models.factory import (  # noqa: E402
    get_model, init_model)
from torch_ekpose_tpu_torch.training import (  # noqa: E402
    cpm_loss, make_optimizer, make_train_step)
from torch_ekpose_tpu_torch.data.targets import gen_targets_torch  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

S, B, GRID = 64, 2, (8, 8)


def _state(name):
    return init_model(name, generator=torch.Generator().manual_seed(1),
                      device="cpu").state_dict()


def _step(name, state, remat, dtype=torch.float32):
    """(logs, {param: grad}, state_dict) after one train step."""
    model = get_model(name, device="cpu", remat=remat)
    model.load_state_dict(state)
    optimizer = make_optimizer(model, 1e-4, 5e-4)
    step = make_train_step(model, optimizer, targets="device", grid=GRID,
                           compute_dtype=dtype)
    images, kpts = inputs.train_batch(np.random.default_rng(0), B, S)
    logs = step(torch.from_numpy(images), torch.from_numpy(kpts))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return logs, grads, model.state_dict()


@pytest.mark.parametrize("name,dtype", [
    ("vgg2016", torch.float32), ("mobilenetV2_small", torch.float32),
    ("mobilenetV2_small", torch.bfloat16), ("shufflenetV2_0.5x",
                                            torch.float32)],
    ids=["vgg2016", "mobilenetV2_small", "mobilenetV2_small_bf16",
         "shufflenetV2_0.5x"])
def test_remat_gradients_are_bitwise_the_same(name, dtype):
    state = _state(name)
    logs, grads, after = _step(name, state, remat=False, dtype=dtype)
    logs_r, grads_r, after_r = _step(name, state, remat=True, dtype=dtype)
    for key, value in logs.items():
        assert torch.equal(logs_r[key], value), key
    assert grads_r.keys() == grads.keys()
    for key, grad in grads.items():
        assert grad.dtype == torch.float32
        assert torch.equal(grads_r[key], grad), key
    # parameters, running statistics and num_batches_tracked: one update
    for key, value in after.items():
        assert torch.equal(after_r[key], value), key
    if name != "vgg2016":
        nbt = [v for k, v in after_r.items()
               if k.endswith("num_batches_tracked")]
        assert nbt and all(int(v) == 1 for v in nbt)


def test_bf16_cast_at_use_gradients():
    """The functional cast's gradients == a bf16-conv copy's, cast up;
    in-place ReLUs and BN included (mobilenet_thin)."""
    name = "mobilenet_thin"
    state = _state(name)
    _, grads, _ = _step(name, state, remat=False, dtype=torch.bfloat16)

    model = get_model(name, device="cpu")
    model.load_state_dict(state)
    for module in model.modules():
        if isinstance(module, torch.nn.Conv2d):
            module.to(torch.bfloat16)
    model.train()
    images, kpts = inputs.train_batch(np.random.default_rng(0), B, S)
    x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
    _, saved = model(x.to(torch.bfloat16))
    heat, paf = gen_targets_torch(torch.from_numpy(kpts), *GRID)
    cpm_loss(saved, heat, paf)[0].backward()
    for key, param in model.named_parameters():
        want = param.grad.float()
        assert torch.equal(grads[key], want), key
        assert (param.dtype == torch.bfloat16) == (".bn." not in key)


def test_remat_is_refused_with_int8():
    with pytest.raises(ValueError, match="int8"):
        get_model("vgg2016", device="meta", quantize=True, remat=True)
    assert get_model("vgg2016", device="meta", remat=True).remat
    assert not get_model("vgg2016", device="meta").remat
