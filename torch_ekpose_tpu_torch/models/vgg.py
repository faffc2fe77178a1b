"""VGG19-based flagship backbone ("vgg2016").

Counterpart of the JAX package's ``models/vgg.py`` (reference
lib/network/vgg2016.py:6-24): torchvision VGG19 ``features[:23]``
(conv1_1 .. conv4_2 + ReLU, three 2x2 max pools -> stride 8) followed by
two extra 3x3 convs 512 -> 256 -> 128 with ReLU. One ``nn.Sequential``
named ``backbone``, so the convs sit at the reference's indices
``0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25``.
"""

from __future__ import annotations

from torch import nn

from torch_ekpose_tpu_torch.models.layers import conv_relu, max_pool

__all__ = ["VGG19Backbone", "VGG19_PLAN"]

#: (convs_per_block, out_channels); a 2x2/2 max pool follows each of the
#: first three blocks. This is exactly torchvision vgg19 features[:23].
VGG19_PLAN = ((2, 64), (2, 128), (4, 256), (2, 512))


class VGG19Backbone(nn.Module):
    """VGG19 features[:23] + 3x3(512->256) + 3x3(256->128), stride 8 out.
    NCHW in, ``[B, 128, H/8, W/8]`` out."""

    out_channels = 128

    def __init__(self, device=None):
        super().__init__()
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
        return self.backbone(x)
