"""VGG19-based flagship backbone ("vgg2016").

Counterpart of the JAX package's ``models/vgg.py`` (reference
lib/network/vgg2016.py:6-24): torchvision VGG19 ``features[:23]``
(conv1_1 .. conv4_2 + ReLU, three 2x2 max pools -> stride 8) followed by
two extra 3x3 convs 512 -> 256 -> 128 with ReLU. One ``nn.Sequential``
named ``backbone``, so the convs sit at the reference's indices
``0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25``.

:func:`prefix_forward` runs blocks 1-3 (``backbone[:19]``) through the
conv kernels of ``ops/conv_chain.py`` and ``ops/block1.py``, the
counterpart of the JAX package's ``scripts/profile_fused_conv.py`` and
``scripts/profile_block1.py``. The serving forward stays on cuDNN, as the
JAX backbone never calls those kernels.

``VGG19Backbone(s2d_blocks=N)`` runs the first N (0-3) pooled blocks
through the weight-exact space-to-depth decomposition
(``ops/s2d_conv.py``, cuDNN convs), reading the same modules' weights,
so the ``state_dict`` is the same either way; the folded int8 model
(``models/quant.py``) realizes its deferred record at the backbone's end.
"""

from __future__ import annotations

from torch import nn

from torch_ekpose_tpu_torch.models.layers import conv_relu, max_pool
from torch_ekpose_tpu_torch.models.quant import realize
from torch_ekpose_tpu_torch.ops.block1 import block1_fused, conv1_fused
from torch_ekpose_tpu_torch.ops.conv_chain import conv_chain
from torch_ekpose_tpu_torch.ops.s2d_conv import s2d_conv_chain

__all__ = ["BLOCK1_ROUTES", "BLOCK_ENDS", "PREFIX_BLOCKS", "PREFIX_END",
           "VGG19Backbone", "VGG19_PLAN", "chain_params", "prefix_forward"]

#: (convs_per_block, out_channels); a 2x2/2 max pool follows each of the
#: first three blocks. This is exactly torchvision vgg19 features[:23].
VGG19_PLAN = ((2, 64), (2, 128), (4, 256), (2, 512))


class VGG19Backbone(nn.Module):
    """VGG19 features[:23] + 3x3(512->256) + 3x3(256->128), stride 8 out.
    NCHW in, ``[B, 128, H/8, W/8]`` out.

    ``s2d_blocks`` (0-3): the first that many pooled blocks run through
    ``s2d_conv_chain(pool=True)`` on their convs' own weights, and their
    ReLU and pool modules are skipped; H and W must then be even down to
    the last such block (the serving frames' multiples of 8 are)."""

    out_channels = 128

    def __init__(self, device=None, s2d_blocks: int = 0):
        super().__init__()
        self.s2d_blocks = min(s2d_blocks, 3)
        layers = []
        in_ch = 3
        for block_i, (n_convs, feats) in enumerate(VGG19_PLAN):
            for _ in range(n_convs):
                layers += conv_relu(in_ch, feats, 3, device)
                in_ch = feats
            if block_i < 3:
                layers.append(max_pool())
        # the two convs appended after features[:23]
        # (reference vgg2016.py:16-19): indices 23 and 25
        layers += conv_relu(512, 256, 3, device)
        layers += conv_relu(256, 128, 3, device)
        self.backbone = nn.Sequential(*layers)

    def forward(self, x):
        layers = self.backbone
        if self.s2d_blocks:
            for block in PREFIX_BLOCKS[:self.s2d_blocks]:
                convs = [layers[i] for i in block]
                x = s2d_conv_chain(x, [(c.weight, c.bias) for c in convs],
                                   pool=True)
            layers = layers[BLOCK_ENDS[self.s2d_blocks - 1]:]
        # the folded int8 model's deferred record feeds every stage
        return realize(layers(x))


#: ``backbone`` indices of the convs of blocks 1, 2 and 3; a 2x2/2 pool
#: ends each, and ``backbone[:PREFIX_END]`` is conv1_1 .. pool3
PREFIX_BLOCKS = ((0, 2), (5, 7), (10, 12, 14, 16))
#: the ``backbone`` index after each of those blocks' pool
BLOCK_ENDS = (5, 10, 19)
PREFIX_END = BLOCK_ENDS[-1]
#: how :func:`prefix_forward` runs block 1
BLOCK1_ROUTES = ("conv_chain", "block1_fused", "conv1_fused")


def chain_params(model: VGG19Backbone, block: int):
    """Block ``block`` (1-3) of ``model`` as ``conv_chain`` params:
    ``[(weight [3, 3, ci, co] HWIO, bias [co]), ...]``, views of the
    module's OIHW weights (JAX weights reach them unchanged through
    ``runtime/checkpoint.py::state_dict_from_jax``)."""
    convs = [model.backbone[i] for i in PREFIX_BLOCKS[block - 1]]
    return [(c.weight.detach().permute(2, 3, 1, 0), c.bias.detach())
            for c in convs]


def prefix_forward(model: VGG19Backbone, x, block1: str = "conv_chain"):
    """VGG19 blocks 1-3 (``backbone[:19]``) through the conv kernels:
    NHWC ``[B, H, W, 3]`` -> ``[B, H/8, W/8, 256]`` in ``x.dtype``.

    ``block1`` picks block 1's entry point: ``conv_chain`` (both convs
    and the pool; in bf16 it routes them to ``block1_fused``'s kernel),
    ``block1_fused`` (the same in one 27-deep-patch kernel), or
    ``conv1_fused`` (conv1_1 alone, then ``conv_chain`` for conv1_2 and
    the pool: one ``conv3x3_sm90`` launch in bf16). Blocks 2 and 3 always
    go through ``conv_chain``.
    """
    first = chain_params(model, 1)
    if block1 == "conv_chain":
        y = conv_chain(x, first, pool=True)
    elif block1 == "block1_fused":
        y = block1_fused(x, *first[0], *first[1])
    elif block1 == "conv1_fused":
        y = conv_chain(conv1_fused(x, *first[0]), first[1:], pool=True)
    else:
        raise ValueError(f"block1 must be one of {BLOCK1_ROUTES}, "
                         f"got {block1!r}")
    for block in (2, 3):
        y = conv_chain(y, chain_params(model, block), pool=True)
    return y
