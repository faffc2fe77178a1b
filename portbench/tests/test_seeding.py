"""Frames and weights come from the seed alone."""

from __future__ import annotations

import numpy as np
import torch

from portbench import catalog
from portbench.params import Params, frame_pool
from portbench.reference import family

TRAFFIC = {"batch": 2, "height": 16, "width": 24, "pool_batches": 3}
BIG = 2 ** 31 + 12345


def test_pool_is_the_same_for_the_same_seed():
    a = frame_pool(TRAFFIC, BIG, "cpu")
    b = frame_pool(TRAFFIC, BIG, "cpu")
    assert a.shape == (6, 16, 24, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b)
    assert not np.array_equal(a, frame_pool(TRAFFIC, BIG + 1, "cpu"))


def test_weights_are_the_same_for_the_same_seed():
    cfg = catalog.load_config("mobilenet_thin")
    specs = family(cfg["reference"]).param_specs(cfg)
    a = Params(specs, BIG, "cpu", torch.bfloat16).state_dict()
    b = Params(specs, BIG, "cpu", torch.bfloat16).state_dict()
    c = Params(specs, BIG + 1, "cpu", torch.bfloat16).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["model0.model0.0.conv.weight"],
                           c["model0.model0.0.conv.weight"])


def test_weights_are_served_dtype_and_scaled():
    cfg = catalog.load_config("vgg2016")
    specs = family(cfg["reference"]).param_specs(cfg)
    p = Params(specs, 3, "cpu", torch.bfloat16)
    sd, f32 = p.state_dict(), p.float32()
    w = sd["model0.backbone.21.weight"]
    assert w.dtype == torch.bfloat16
    assert abs(w.float().std().item() - (2 / (512 * 9)) ** 0.5) < 1e-3
    assert sd["model6_2.12.weight"].float().std().item() < 0.011
    bias = sd["model0.backbone.0.bias"].float()
    assert abs(bias.std().item() - 0.05) < 0.02 and bias.all()
    assert torch.equal(f32["model0.backbone.21.weight"], w.float())


def test_bn_leaves_are_drawn():
    """Every BN's scale, shift and running statistics come from the seed,
    around the identity, with positive variances."""
    cfg = catalog.load_config("mobilenet_thin")
    specs = family(cfg["reference"]).param_specs(cfg)
    sd = Params(specs, BIG, "cpu", torch.bfloat16).state_dict()
    bn = "model0.model0.11.bn"
    weight, var = sd[bn + ".weight"].float(), sd[bn + ".running_var"]
    assert var.dtype == torch.float32 and (var > 0).all()
    assert abs(weight.mean().item() - 1) < 0.05 and weight.std().item() > 0.05
    assert abs(var.mean().item() - 1) < 0.1 and var.std().item() > 0.1
    for leaf in ("bias", "running_mean"):
        assert sd[f"{bn}.{leaf}"].float().std().item() > 0.03
    assert sd[bn + ".num_batches_tracked"].item() == 0
