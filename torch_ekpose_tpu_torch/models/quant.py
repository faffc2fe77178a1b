"""Int8 serving: per-channel int8 weights, int8 activations, int32 sums.

Counterpart of the JAX package's ``models/quant.py`` (post-training
quantization of the dense-conv vgg family). Each quantized conv
(:class:`QuantConv`) keeps ``weight_q`` (int8, OIHW), ``scale`` (float32
per output channel), ``bias`` (float32) and, in the static mode,
``act_scale`` (a float32 scalar) as buffers. Its input is quantized to
int8, the product of two int8 operands accumulates in int32, and the
accumulator is rescaled to the input's dtype (bf16 in the int8 model):

- weights: ``scale = max|k| * _INV127`` per output channel (a multiply,
  as the JAX package's host and device paths both compute it);
- activations, dynamic mode (``quantize=True``): ``sx = max|x| / 127``
  per example, which XLA compiles as ``max|x| * f32(1/127)`` (measured on
  the CPU: the JAX program's ``sx`` equals that product bit for bit, and
  the true quotient differs from it in some layers), so the port
  multiplies too; static mode (``quantize="static"``): the calibrated
  ``act_scale`` (:func:`calibrate_act_scales`); then
  ``xq = clip(round(x / sx), -127, 127)`` (a divide);
- the rescale: ``acc * (sx * scale) + bias``, which XLA fuses into one
  fma (one rounding), as ``torch.addcmul`` computes it.

In that order of operations the int8 activations and the int32
accumulator are bit-equal to the JAX package's. The conv is ``im2col``
(a strided view of the padded int8 NHWC input, copied once into
``[B*H*W, k*k*C]`` in 8-byte words) followed by ``torch._int_mm`` (int8
x int8 -> int32) against the weight matrix ``wmat`` [O, k*k*C], which
:class:`QuantConv` packs from ``weight_q`` once, when its state is
loaded (:meth:`QuantConv.pack`), where the JAX package calls XLA's
``conv_general_dilated`` with ``preferred_element_type=int32``: on the
card ``_int_mm`` wants more than 16 rows and K and N multiples of 8, so
the channels are padded with zeros to a multiple of 8 (the head's 7x7
convs over 185 channels run at K = 49 x 192) and a short M with zero
rows.

The network's input conv and each branch's final 1x1 projection stay
bf16 (:class:`FloatConv`, ``models/factory.py``); the depthwise-separable
family is refused.

The folded pipeline (``quantize="folded"``, the JAX package's
``QuantConv(static_act=True, fold=True)``): a folded conv returns its
int32 accumulator as a :class:`QuantAcc` record with the affine that
maps it to real activations, and defers the ReLU and max pools that
follow it (``models/layers.py::FoldReLU``, ``FoldMaxPool2d``). The next
folded conv requantizes the record in ONE int32 -> int8 pass in its own
static scale, ``clip(round(acc * (mult / sx) + bias / sx), 0 if relu
else -127, 127)`` (the affine as one fma, ``torch.addcmul``, as the JAX
CPU program fuses it), then runs the deferred pools on int8 data (the
requantize is monotone per channel, so max commutes with it);
:func:`realize` materializes a record in the activations' dtype at the
backbone's end and before each branch's final projection.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["FloatConv", "QuantAcc", "QuantConv", "calibrate_act_scales",
           "has_act_scales", "int8_conv2d", "is_quantized", "pack_weight",
           "quant_convs", "quantize_kernel", "quantize_variables",
           "realize"]

#: the JAX package's float32 reciprocal of 127 (a multiply, not a divide,
#: so its numpy and device conversions agree bit for bit)
_INV127 = np.float32(1.0 / 127.0)
#: the smallest scale, so an all-zero channel or input divides safely
_TINY = 1e-12
#: ``torch._int_mm`` on the card: rows > 16, K and N multiples of 8
_MIN_ROWS, _ALIGN = 17, 8


@dataclasses.dataclass(frozen=True)
class QuantAcc:
    """The deferred output of a folded static-scale :class:`QuantConv`
    (the JAX package's ``QuantAcc``): the int32 accumulator ``acc``
    (NCHW, a ``channels_last`` view of ``_int_mm``'s [B*H*W, C]),
    ``mult = act_scale * scale`` and ``bias`` (float32 [C]) mapping it to
    real activations, the activations' ``dtype``, and the ReLU and max
    pools (``(window, stride, padding)`` in order) deferred to its
    consumer: another folded conv (:meth:`requantize`) or
    :func:`realize`."""

    acc: torch.Tensor
    mult: torch.Tensor
    bias: torch.Tensor
    dtype: torch.dtype
    relu: bool = False
    pools: tuple = ()

    def replace(self, **changes) -> "QuantAcc":
        return dataclasses.replace(self, **changes)

    @property
    def shape(self):
        n, c, h, w = self.acc.shape
        for window, stride, padding in self.pools:
            h = (h + 2 * padding - window) // stride + 1
            w = (w + 2 * padding - window) // stride + 1
        return (n, c, h, w)

    def requantize(self, sx: torch.Tensor) -> torch.Tensor:
        """The consumer's int8 input in its scale ``sx``: the producer's
        dequantize, bias and ReLU and this requantize in one pass, then
        the deferred pools on the int8 data."""
        y = torch.addcmul((self.bias / sx)[:, None, None], self.acc.float(),
                          (self.mult / sx)[:, None, None])
        xq = torch.round(y).clamp(0 if self.relu else -127, 127)
        return _apply_pools(xq.to(torch.int8), self.pools, -128)


def _apply_pools(y: torch.Tensor, pools, pad_value) -> torch.Tensor:
    """The deferred max pools; ``pad_value`` is the domain's minimum
    (-128 for int8, -inf for floats). A max over ``unfold`` windows:
    ``max_pool2d`` checks an int8 input's size against int8's range."""
    for window, stride, padding in pools:
        if padding:
            y = F.pad(y, (padding,) * 4, value=pad_value)
        y = y.unfold(2, window, stride).unfold(3, window, stride).amax(
            dim=(4, 5))
    return y


def realize(x, dtype: Optional[torch.dtype] = None):
    """A :class:`QuantAcc` as real activations in ``dtype`` (default its
    own): dequantize + bias (one fma), ReLU, the deferred pools. Anything
    else passes through."""
    if not isinstance(x, QuantAcc):
        return x
    y = torch.addcmul(x.bias[:, None, None], x.acc.float(),
                      x.mult[:, None, None])
    if x.relu:
        y = torch.relu(y)
    return _apply_pools(y, x.pools, -math.inf).to(dtype or x.dtype)


def quantize_kernel(weight: torch.Tensor):
    """Per-output-channel symmetric int8 quantization of an OIHW conv
    weight -> (int8 OIHW weight, float32 [O] scale)."""
    k = weight.float()
    scale = (k.abs().amax(dim=(1, 2, 3)) * _INV127).clamp_min(_TINY)
    q = torch.round(k / scale[:, None, None, None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def pack_weight(weight_q: torch.Tensor) -> torch.Tensor:
    """int8 OIHW ``weight_q`` -> the contiguous int8 matrix [O, k*k*cp]
    that :func:`int8_conv2d` multiplies by, columns (dy, dx, c) with the
    channels padded with zeros to ``cp``, a multiple of 8."""
    o, c, k, _ = weight_q.shape
    return F.pad(weight_q.permute(0, 2, 3, 1),
                 (0, _ceil(c, _ALIGN) - c)).reshape(o, -1).contiguous()


def int8_conv2d(xq: torch.Tensor, wmat: torch.Tensor, kernel: int,
                pad_h: Optional[int] = None) -> torch.Tensor:
    """Stride-1 SAME ``kernel`` x ``kernel`` conv of int8 NCHW ``xq`` with
    the packed weight ``wmat`` (:func:`pack_weight`) -> the int32
    accumulator, NCHW (a ``channels_last`` view): ``im2col`` then
    ``torch._int_mm``. ``pad_h`` (default ``kernel // 2``) is the zero
    rows added above and below: 0 for a stripe of a height-split image
    that carries its halo rows (``parallel/spatial.py``).

    The columns are gathered channels last, (dy, dx, c): the input is
    padded NHWC (the activations between int8 convs are ``channels_last``
    already, so the NHWC view is free) with its channels padded with
    zeros to a multiple of 8, so that each pixel's channels move as 8-byte
    words and K = k * k * C is a multiple of 8, as in ``wmat``."""
    n, c, h, w = xq.shape
    o, k = wmat.shape[0], kernel
    pad, cp = k // 2, _ceil(c, _ALIGN)
    pad_h = pad if pad_h is None else pad_h
    h += 2 * pad_h - 2 * pad
    padded = F.pad(xq.permute(0, 2, 3, 1),
                   (0, cp - c, pad, pad, pad_h, pad_h)).contiguous()
    words = padded.view(torch.int64)            # [N, H', W', cp / 8]
    if k > 1:
        # [N, H, W, cp / 8, k, k] view -> rows (n, y, x), columns (dy, dx)
        words = words.unfold(1, k, 1).unfold(2, k, 1).permute(
            0, 1, 2, 4, 5, 3)
    rows = n * h * w
    cols = words.reshape(rows, k * k * cp // _ALIGN).view(torch.int8)
    if rows < _MIN_ROWS:
        cols = F.pad(cols, (0, 0, 0, _MIN_ROWS - rows))
    acc = torch._int_mm(cols, wmat.t())
    return acc[:rows].view(n, h, w, o).permute(0, 3, 1, 2)


class FloatConv(nn.Conv2d):
    """A float conv of the int8 network (the input conv, each branch's
    final projection) in flax's order of operations: the conv in the
    input's dtype, rounded, then the bias added in that dtype. cuDNN's
    fused bias rounds once; flax rounds twice, and one bf16 ulp on the
    input conv moves a per-example ``max|x|`` downstream, so the int8
    layers would see other scales than the JAX package's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = realize(x)          # a branch's last record (folded model)
        y = F.conv2d(x, self.weight, None, self.stride, self.padding)
        return y + self.bias[:, None, None]


class QuantConv(nn.Module):
    """A conv (SAME padding, stride 1, bias) whose weight is int8; see
    the module docstring for its numerics. ``static`` selects the
    calibrated ``act_scale`` over the per-example dynamic scale. The
    output has the input's dtype; with ``fold`` (static only) it is a
    :class:`QuantAcc` record, and the input may be one."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 static: bool = False, device=None, fold: bool = False):
        super().__init__()
        if fold and not static:
            raise ValueError("fold=True requires static=True")
        self.static = static
        self.fold = fold
        self.register_buffer("weight_q", torch.zeros(
            out_ch, in_ch, kernel, kernel, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(out_ch, device=device))
        self.register_buffer("bias", torch.zeros(out_ch, device=device))
        if static:
            self.register_buffer("act_scale", torch.ones((), device=device))
        # derived from weight_q, so left out of the state_dict
        self.register_buffer("wmat", pack_weight(self.weight_q),
                             persistent=False)
        self.register_load_state_dict_post_hook(
            lambda module, _keys: module.pack())
        #: set by :func:`calibrate_act_scales`: run on the dynamic scales
        #: and keep the largest ``max|x|`` seen
        self.observed = None

    @torch.no_grad()
    def pack(self) -> None:
        """Rebuild ``wmat`` from ``weight_q``: runs after every
        ``load_state_dict``; call it after writing ``weight_q`` in place."""
        self.wmat = pack_weight(self.weight_q)

    def extra_repr(self) -> str:
        o, c, k, _ = self.weight_q.shape
        return (f"{c}, {o}, kernel_size={k}, static={self.static}, "
                f"fold={self.fold}")

    def forward(self, x):
        """A height-split ``x`` (``parallel/spatial.py``) takes its
        dynamic scale over every stripe and its halo rows from the stripes
        next to each. A folded conv under :func:`calibrate_act_scales`
        runs unfolded."""
        fold = self.fold and self.observed is None
        if isinstance(x, QuantAcc):
            if not fold:
                raise TypeError("QuantAcc records only flow between "
                                "folded QuantConvs")
            sx = self.act_scale.clamp_min(_TINY)
            xq = x.requantize(sx)
            return self._conv(xq, sx, x.dtype, fold)
        xf = x.float()
        if self.static and self.observed is None:
            sx = self.act_scale.clamp_min(_TINY)
        else:
            # per EXAMPLE (over C, H, W): a frame gives the same values at
            # any batch size
            # a float32 scalar: no host-to-device copy a call
            sx = (xf.abs().amax(dim=(1, 2, 3), keepdim=True) * _INV127
                  ).clamp_min(_TINY)
            if self.observed is not None:
                seen = sx.max() * 127.0
                self.observed = torch.maximum(self.observed, seen)
        xq = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
        return self._conv(xq, sx, x.dtype, fold)

    def _conv(self, xq, sx: torch.Tensor, dtype: torch.dtype, fold: bool):
        k = self.weight_q.shape[-1]
        if hasattr(xq, "conv_rows"):      # height-split (parallel/spatial.py)
            if fold:
                raise NotImplementedError(
                    "the folded int8 pipeline runs on one device")
            acc = xq.conv_rows(k, 1, k // 2, 0, lambda rows, move: int8_conv2d(
                rows, move(self.wmat), k, pad_h=0))
        else:
            acc = int8_conv2d(xq, self.wmat, k)
        if fold:
            return QuantAcc(acc, sx * self.scale, self.bias, dtype)
        y = torch.addcmul(self.bias[:, None, None], acc.float(),
                          sx * self.scale[:, None, None])
        return y.to(dtype)


def quant_convs(model: nn.Module) -> Iterator[tuple]:
    """(name, module) of every :class:`QuantConv` in ``model``."""
    return ((name, m) for name, m in model.named_modules()
            if isinstance(m, QuantConv))


def quantize_variables(
    state_dict: Dict[str, torch.Tensor], quant_model: nn.Module
) -> Dict[str, torch.Tensor]:
    """A float ``state_dict`` in the layout of ``quant_model`` (the
    JAX package's ``quantize_variables``): each conv that the quantized
    model runs in int8 gets ``weight_q``/``scale`` from its float
    ``weight`` (and keeps its ``bias``); a conv already quantized passes
    through; a static model gains a placeholder ``act_scale`` of 1 until
    :func:`calibrate_act_scales` measures it, and a dynamic model drops
    a calibrated one. Everything else passes through."""
    out = dict(state_dict)
    for name, conv in quant_convs(quant_model):
        if f"{name}.weight" in out:
            q, scale = quantize_kernel(out.pop(f"{name}.weight"))
            out[f"{name}.weight_q"], out[f"{name}.scale"] = q, scale
        key = f"{name}.act_scale"
        if conv.static and key not in out:
            out[key] = torch.ones(())
        elif not conv.static:
            out.pop(key, None)
    return out


def is_quantized(state_dict: Dict[str, torch.Tensor]) -> bool:
    """True when ``state_dict`` holds int8 convs (``weight_q`` entries)."""
    return any(k.endswith(".weight_q") for k in state_dict)


def has_act_scales(state_dict: Dict[str, torch.Tensor]) -> bool:
    """True when some quantized conv carries a calibrated ``act_scale``
    (the tree of a static model, e.g. ``cli.export --dtype int8_static``)."""
    return any(k.endswith(".act_scale") for k in state_dict)


@contextlib.contextmanager
def _observing(model: nn.Module):
    convs = [m for _, m in quant_convs(model)]
    for conv in convs:
        conv.observed = torch.zeros((), device=conv.scale.device)
    try:
        yield convs
    finally:
        for conv in convs:
            conv.observed = None


@torch.no_grad()
def calibrate_act_scales(model: nn.Module,
                         inputs: Iterable[torch.Tensor]) -> None:
    """Post-training calibration of a static int8 model, in place: run
    ``model`` on the dynamic scales over ``inputs`` (batches of model
    input, NCHW) and set each quantized conv's ``act_scale`` to
    ``max(max|x| / 127, 1e-12)`` over everything it saw (the JAX package's
    ``calibrate_act_scales``: its ``max(sx) * 127`` per batch, reduced by
    max, divided in double precision, stored as float32)."""
    if not all(conv.static for _, conv in quant_convs(model)):
        raise ValueError("calibrate_act_scales needs a static model "
                         "(quantize='static')")
    with _observing(model) as convs:
        n = 0
        for x in inputs:
            model(x)
            n += 1
        if not n:
            raise ValueError("calibration needs at least one input batch")
        for conv in convs:
            absmax = float(conv.observed)
            conv.act_scale.fill_(max(absmax / 127.0, _TINY))
