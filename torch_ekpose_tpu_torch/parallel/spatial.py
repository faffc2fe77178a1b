"""Height-split (spatial) inference and training over several devices.

Counterpart of the JAX package's ``parallel/spatial.py``. Data
parallelism cannot cut the latency of ONE frame, so the padded image's
height is split into stripes, one per device, and every layer runs on
each stripe on its own device. The JAX package lets GSPMD partition each
conv and insert the halo exchanges; here the split is explicit:

- :class:`Stripes` holds an NCHW activation as ``parts``, consecutive row
  ranges of the image, ``parts[i]`` on its own device. It answers
  ``__torch_function__``, so the models' own forwards run on it
  unchanged: an op that is local in the height (ReLU, add, a channel
  ``cat`` or shuffle, BN in eval mode, the casts) runs on each stripe;
  ``Conv2d`` (3x3, 7x7, 1x1, the stride-2 and depthwise convs, with the
  port's symmetric ``k // 2`` padding), max pools (the 2x2/2 pools and
  ShuffleNetV2's 3x3/2 with padding 1), ``QuantConv``
  (:meth:`Stripes.conv_rows`) and the space-to-depth blocks of
  ``--s2d-blocks`` (:meth:`Stripes.s2d_rows`) first gather the halo rows
  they read from the stripes next to them (``.to(device)`` and
  ``torch.cat``, which
  autograd carries back), with zero rows (-inf for a pool) only beyond
  the image's own edges; the bilinear resizes of MobileNetV2 and
  ShuffleNetV2 read their two source rows wherever they lie; a reduction
  over the height (``amax``, the dynamic int8 scale) spans every stripe;
  and BN in training mode sums its statistics over every stripe
  (``models/layers.py::BatchNorm2d``).
- A stripe owns the output rows whose first strided input row it holds,
  so stripes may be uneven, or empty, deep in a network.
- :class:`SpatialPoseEstimator` pads a frame to multiples of ``8 * N``,
  runs the forward on N stripes, gathers the stage-6 maps on the first
  device and decodes them there with the hand kernels.
- :class:`SpatialForward` is the training forward (``cli.train
  --spatial K``): the 12 stage outputs come back whole on the first
  device, where the loss runs.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch_ekpose_tpu_torch.config import Config
from torch_ekpose_tpu_torch.decode import device as decode_device
from torch_ekpose_tpu_torch.parallel.mesh import make_mesh
from torch_ekpose_tpu_torch.utils.human import Human

__all__ = ["Replicas", "SpatialForward", "SpatialPoseEstimator", "Stripes",
           "split_height"]


class Replicas:
    """Where a stripe's layer finds a weight that lives on another device.

    With no replicas (training) :meth:`move` copies the tensor with
    ``.to(device)``, which autograd carries back to the master weight.
    :meth:`add` registers a model's copy on another device (inference),
    so its weights are copied once, not at every forward."""

    def __init__(self):
        self._copies = {}

    def add(self, master: nn.Module, replica: nn.Module) -> None:
        device = next(iter([*replica.parameters(),
                            *replica.buffers()])).device
        pairs = list(zip(master.parameters(), replica.parameters())) + list(
            zip(master.buffers(), replica.buffers()))
        for m, r in pairs:
            self._copies[(id(m), device)] = (m, r)

    def move(self, tensor: torch.Tensor, device: torch.device):
        if not isinstance(tensor, torch.Tensor) or tensor.device == device:
            return tensor
        hit = self._copies.get((id(tensor), device))
        if hit is not None and hit[0] is tensor:
            return hit[1]
        return tensor.to(device)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _touches_height(dim, ndim: int = 4) -> bool:
    dims = dim if isinstance(dim, (tuple, list)) else (dim,)
    return any(d % ndim == 2 for d in dims if isinstance(d, int))


class _Shape(tuple):
    """A height-split activation's shape: a tuple whose slices keep the
    stripes' row ``offsets``."""

    def __new__(cls, dims, offsets):
        shape = super().__new__(cls, dims)
        shape.offsets = offsets
        return shape

    def __getitem__(self, index):
        out = super().__getitem__(index)
        return _Shape(out, self.offsets) if isinstance(index, slice) else out


class Stripes:
    """An NCHW activation split along its height: ``parts[i]`` holds rows
    ``offsets[i]:offsets[i + 1]`` of the image, on its own device. A
    per-example value that is the same for every stripe (a reduction over
    the height) is ``replicated``: each part holds the whole value."""

    def __init__(self, parts: Sequence[torch.Tensor],
                 replicas: Optional[Replicas] = None,
                 replicated: bool = False):
        self.parts = list(parts)
        self.replicas = replicas or Replicas()
        self.replicated = replicated

    # -- the tensor surface the models read -------------------------------

    @property
    def shape(self):
        """The whole image's shape (heights summed), carrying the stripes'
        row ``offsets``, so a resize ``to size=x.shape[-2:]`` splits its
        output as ``x`` is split."""
        first = self.parts[0].shape
        if self.replicated or len(first) != 4:
            return first
        return _Shape((first[0], first[1], self.height, first[3]),
                      self.offsets)

    @property
    def height(self) -> int:
        return sum(p.shape[2] for p in self.parts)

    @property
    def offsets(self) -> List[int]:
        out = [0]
        for p in self.parts:
            out.append(out[-1] + p.shape[2])
        return out

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def __repr__(self) -> str:
        return (f"Stripes({tuple(self.shape)}, rows {self.offsets}, "
                f"{[str(p.device) for p in self.parts]})")

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        method = getattr(torch.Tensor, name)
        return lambda *args, **kwargs: Stripes.__torch_function__(
            method, (), (self,) + args, kwargs)

    def _binary(name):
        method = getattr(torch.Tensor, name)
        return lambda self, other: _map(method, (self, other), {})

    # the operators the models apply to an activation (a tensor on the
    # left dispatches through __torch_function__)
    __add__ = _binary("__add__")
    __mul__ = _binary("__mul__")
    __truediv__ = _binary("__truediv__")
    del _binary

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        handler = _HANDLERS.get(func)
        if handler is not None:
            return handler(*args, **kwargs)
        if func in _HEIGHT_GUARDED:
            at, default = _HEIGHT_GUARDED[func]
            dim = kwargs.get("dim", args[at] if len(args) > at else default)
            if dim is None or _touches_height(dim):
                raise NotImplementedError(
                    f"{getattr(func, '__name__', func)} along the height of "
                    "height-split stripes")
        return _map(func, args, kwargs)

    # -- halos -------------------------------------------------------------

    def rows(self, lo: int, hi: int, device: torch.device,
             fill: float = 0.0) -> torch.Tensor:
        """Rows ``lo:hi`` of the whole image on ``device``: slices of the
        stripes that hold them, and ``fill`` rows beyond the image's
        edges."""
        first = self.parts[0]
        n, c, _, w = first.shape
        pieces = []

        def filler(count):
            return torch.full((n, c, count, w), fill, dtype=first.dtype,
                              device=device)

        if lo < 0:
            pieces.append(filler(min(hi, 0) - lo))
        offsets = self.offsets
        for part, a, b in zip(self.parts, offsets[:-1], offsets[1:]):
            s, e = max(lo, a), min(hi, b)
            if s < e:
                pieces.append(part[:, :, s - a:e - a].to(device))
        if hi > offsets[-1]:
            pieces.append(filler(hi - max(lo, offsets[-1])))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=2)

    def conv_rows(self, kernel: int, stride: int, pad: int, fill: float,
                  fn: Callable, out_rows: Optional[int] = None) -> "Stripes":
        """A windowed layer (``kernel`` rows, ``stride``, ``pad`` rows of
        ``fill`` at the top) on every stripe: ``fn(rows, move)`` gets the
        rows that the stripe's outputs read, halo included, and must
        apply the layer with no padding in the height (``move(t)`` puts a
        weight on the rows' device). Stripe ``i`` owns the output rows
        ``r`` with ``r * stride`` in its input rows; ``out_rows`` is the
        whole output's height (default: the height's ceiling over the
        stride, what symmetric ``k // 2`` padding gives)."""
        offsets, height = self.offsets, self.height
        total = out_rows if out_rows is not None else -(-height // stride)
        out = []
        for part, a, b in zip(self.parts, offsets[:-1], offsets[1:]):
            r0 = min(-(-a // stride), total)
            r1 = min(-(-b // stride), total)
            want = r1 - r0
            rows = self.rows(r0 * stride - pad,
                             (max(want, 1) - 1 + r0) * stride - pad + kernel,
                             part.device, fill)
            y = fn(rows, lambda t, d=part.device: self.replicas.move(t, d))
            out.append(y[:, :, :want])
        return Stripes(out, self.replicas)

    def s2d_rows(self, layers: int, pool: bool, fn: Callable) -> "Stripes":
        """A space-to-depth chain of ``layers`` SAME 3x3 convs [+ a 2x2/2
        pool] (``ops/s2d_conv.py``) on every stripe: ``fn(rows, move)``
        runs it, with the chain's own padding, on the stripe's rows and up
        to ``2 * layers`` rows each side, cut at the image's edges, so
        the rows it keeps never read a cut window's edge. Every stripe
        boundary must be even (the frame's ``8 * N`` padding makes those
        of VGG blocks 1-3 so)."""
        offsets, height = self.offsets, self.height
        if any(o % 2 for o in offsets):
            raise ValueError(f"space-to-depth stripes need even row "
                             f"boundaries, got {offsets}")
        halo, scale = 2 * layers, 2 if pool else 1
        out = []
        for part, a, b in zip(self.parts, offsets[:-1], offsets[1:]):
            lo, hi = max(a - halo, 0), min(b + halo, height)
            y = fn(self.rows(lo, hi, part.device),
                   lambda t, d=part.device: self.replicas.move(t, d))
            out.append(y[:, :, (a - lo) // scale:(b - lo) // scale])
        return Stripes(out, self.replicas)

    def gather(self, device=None, dtype=None) -> torch.Tensor:
        """The whole activation on ``device`` (default: the first
        stripe's), in ``dtype`` if given."""
        device = self.device if device is None else torch.device(device)
        parts = [p.to(device) for p in self.parts]
        if dtype is not None:
            parts = [p.to(dtype) for p in parts]
        return torch.cat(parts, dim=2)


def _unwrap(value, i: int, device: torch.device, replicas: Replicas):
    if isinstance(value, Stripes):
        return value.parts[i]
    if isinstance(value, torch.Tensor):
        return replicas.move(value, device)
    if isinstance(value, (list, tuple)):
        return type(value)(_unwrap(v, i, device, replicas) for v in value)
    return value


def _map(func, args, kwargs):
    """``func`` on each stripe: every :class:`Stripes` argument becomes
    its ``i``-th part and every other tensor moves to that part's
    device."""
    stripes = list(_all_stripes((args, kwargs)))
    lead = stripes[0]
    replicated = all(s.replicated for s in stripes)
    results = []
    for i, part in enumerate(lead.parts):
        a = _unwrap(args, i, part.device, lead.replicas)
        k = {key: _unwrap(v, i, part.device, lead.replicas)
             for key, v in kwargs.items()}
        results.append(func(*a, **k))
    first = results[0]
    if isinstance(first, torch.Tensor):
        return Stripes(results, lead.replicas, replicated)
    if isinstance(first, (tuple, list)) and first and all(
            isinstance(r, torch.Tensor) for r in first):
        return type(first)(Stripes(list(r), lead.replicas, replicated)
                           for r in zip(*results))
    return first


def _all_stripes(value):
    if isinstance(value, Stripes):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _all_stripes(v)
    elif isinstance(value, dict):
        yield from _all_stripes(list(value.values()))


def _conv2d(input, weight, bias=None, stride=1, padding=0, dilation=1,
            groups=1):
    if isinstance(padding, str) or _pair(dilation) != (1, 1):
        raise NotImplementedError("height-split convs take integer "
                                  "padding and no dilation")
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    kh = weight.shape[2]
    out_rows = (input.height + 2 * ph - kh) // sh + 1

    def conv(rows, move):
        return F.conv2d(rows, move(weight), move(bias), (sh, sw), (0, pw),
                        1, groups)
    return input.conv_rows(kh, sh, ph, 0.0, conv, out_rows)


def _max_pool2d(input, kernel_size, stride=None, padding=0, dilation=1,
                ceil_mode=False, return_indices=False):
    (kh, kw) = _pair(kernel_size)
    (sh, sw) = _pair(stride if stride not in (None, []) else kernel_size)
    (ph, pw) = _pair(padding)
    if ceil_mode or return_indices or _pair(dilation) != (1, 1):
        raise NotImplementedError("height-split max pools take no "
                                  "ceil_mode, indices or dilation")
    out_rows = (input.height + 2 * ph - kh) // sh + 1

    def pool(rows, move):
        return F.max_pool2d(rows, (kh, kw), (sh, sw), (0, pw))
    return input.conv_rows(kh, sh, ph, -math.inf, pool, out_rows)


def _interpolate(input, size=None, scale_factor=None, mode="nearest",
                 align_corners=None, recompute_scale_factor=None,
                 antialias=False):
    """Bilinear (``align_corners=False``) resize to ``size``: in the
    height, each output row is a weighted pair of source rows, found by
    torch's source index (``max(scale * (o + 0.5) - 0.5, 0)``) wherever
    they lie; the width then resizes on each stripe's rows. A ``size``
    read off a height-split activation's shape splits the output as that
    activation is split."""
    if mode != "bilinear" or align_corners or size is None or antialias:
        raise NotImplementedError("height-split resizes are bilinear to a "
                                  "size, align_corners=False")
    h_out, w_out = _pair(size) if isinstance(size, int) else tuple(size)
    h_in = input.height
    acc = torch.promote_types(input.dtype, torch.float32)
    scale = torch.tensor(h_in, dtype=acc) / h_out      # in torch's opmath
    # the output rows of each stripe: those of the activation whose size
    # this is, else in proportion
    ends = getattr(size, "offsets", None) or [
        min(math.ceil(a * h_out / h_in), h_out) for a in input.offsets]
    out = []
    for part, o0, o1 in zip(input.parts, ends[:-1], ends[1:]):
        dst = torch.arange(o0, o1, dtype=acc)
        src = torch.clamp(scale * (dst + 0.5) - 0.5, min=0.0)
        i0 = src.floor().long()
        i1 = torch.clamp(i0 + 1, max=h_in - 1)
        l1 = (src - i0.to(acc)).to(part.device)[None, None, :, None]
        if o1 > o0:
            lo, hi = int(i0.min()), int(i1.max()) + 1
            rows = input.rows(lo, hi, part.device).to(acc)
            top = rows.index_select(2, (i0 - lo).to(part.device))
            bottom = rows.index_select(2, (i1 - lo).to(part.device))
            mixed = (1.0 - l1) * top + l1 * bottom
        else:
            n, c, _, w = part.shape
            mixed = part.new_zeros((n, c, 0, w), dtype=acc)
        y = F.interpolate(mixed, size=(o1 - o0, w_out), mode="bilinear",
                          align_corners=False) if o1 > o0 else \
            mixed.new_zeros(mixed.shape[:2] + (0, w_out))
        out.append(y.to(part.dtype))
    return Stripes(out, input.replicas)


def _amax(input, dim=(), keepdim=False):
    """``amax`` over dims that include the height: the max over every
    stripe, the same value on each stripe's device."""
    if not _touches_height(dim):
        return _map(torch.Tensor.amax, (input, dim, keepdim), {})
    local = [p.amax(dim=dim, keepdim=keepdim)
             for p in input.parts if p.shape[2]]
    dev = input.device
    total = torch.stack([v.to(dev) for v in local]).amax(dim=0)
    return Stripes([total.to(p.device) for p in input.parts],
                   input.replicas, replicated=True)


_HANDLERS = {
    F.conv2d: _conv2d,
    F.max_pool2d: _max_pool2d,
    F.interpolate: _interpolate,
    torch.Tensor.amax: _amax,
    torch.amax: _amax,
}
#: ops that would cut across the stripes along the height: func ->
#: (position of its ``dim`` argument, its default; None reduces all)
_HEIGHT_GUARDED = {
    torch.cat: (1, 0), torch.Tensor.chunk: (2, 0), torch.chunk: (2, 0),
    torch.Tensor.split: (2, 0), torch.split: (2, 0),
    torch.Tensor.sum: (1, None), torch.sum: (1, None),
    torch.Tensor.mean: (1, None), torch.mean: (1, None),
    torch.Tensor.max: (1, None), torch.Tensor.min: (1, None),
}


def split_height(x: torch.Tensor, devices: Sequence,
                 replicas: Optional[Replicas] = None) -> Stripes:
    """``x`` (NCHW) as ``len(devices)`` stripes of its height, stripe
    ``i`` on ``devices[i]`` (``torch.tensor_split``'s row counts)."""
    parts = [p.to(torch.device(d)) for p, d in
             zip(torch.tensor_split(x, len(devices), dim=2), devices)]
    return Stripes(parts, replicas)


class SpatialForward(nn.Module):
    """``model``'s forward with the input's height split over
    ``devices``; the 12 stage outputs come back whole on the input's
    device, so the loss, the targets and the optimizer run there as on
    one device. Gradients reach ``model``'s parameters through the halo
    and weight copies. Its call signature is ``model``'s (``x``,
    ``compute_dtype``)."""

    def __init__(self, model: nn.Module, devices: Sequence):
        super().__init__()
        self.model = model
        self.devices = [torch.device(d) for d in devices]

    def forward(self, x: torch.Tensor, compute_dtype=None):
        _, saved = self.model(split_height(x, self.devices),
                              compute_dtype=compute_dtype)
        saved = [s.gather(x.device) for s in saved]
        return (saved[-2], saved[-1]), saved


class SpatialPoseEstimator:
    """Batch-1 pose inference with the frame's height split over a mesh.

    ``estimate(image)`` mirrors ``PoseEstimator.estimate`` (one BGR image
    -> (List[Human], im_scale)) with the forward split into
    ``mesh.size`` stripes. The padded H and W are rounded up to
    multiples of ``8 * mesh.size``. The stage-6 maps are gathered on the
    mesh's first device and decoded there by the hand kernels (the
    device decode of ``PoseEstimator.estimate_batch``). The model, its
    dtypes (int8 included) and its arguments are ``PoseEstimator``'s; a
    copy of the weights sits on each other device of the mesh.
    """

    decode_backend = "device"

    def __init__(self, model_name: str = "vgg2016",
                 state_dict: Optional[dict] = None,
                 config: Optional[Config] = None, *, mesh=None,
                 compute_dtype=torch.bfloat16, precision: str = "fast",
                 preprocess: str = "vgg", dest_size: int = 368,
                 s2d_blocks: int = 0, seed: int = 0):
        from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator

        self.mesh = mesh if mesh is not None else make_mesh()
        self.devices = self.mesh.flat
        self._single = PoseEstimator(
            model_name, state_dict, config, device=self.devices[0],
            compute_dtype=compute_dtype, precision=precision,
            preprocess=preprocess, dest_size=dest_size,
            decode_backend="device", s2d_blocks=s2d_blocks, seed=seed)
        self.config = self._single.config
        self.dest_size = dest_size
        self.model = self._single.model
        self._replicas = None

    @property
    def num_devices(self) -> int:
        return self.mesh.size

    def _copies(self) -> Replicas:
        """The model's copy on each other device, made once (after a
        static int8 model's calibration)."""
        if self._replicas is None:
            self._replicas = Replicas()
            for device in dict.fromkeys(self.devices[1:]):
                if device != self.devices[0]:
                    self._replicas.add(self.model, copy.deepcopy(
                        self.model).to(device))
        return self._replicas

    def pad(self, image: np.ndarray) -> Tuple[np.ndarray, float]:
        """Resize the long side to ``dest_size`` and zero-pad H and W up
        to multiples of ``8 * mesh.size``."""
        from torch_ekpose_tpu_torch.runtime.estimator import padding

        im_pad, im_scale, _ = padding(image, self.dest_size,
                                      8 * self.mesh.size)
        return im_pad, im_scale

    @torch.inference_mode()
    def _forward(self, images: np.ndarray):
        """Padded frames [B, H, W, 3] -> stage-6 (paf, heatmap), float32
        NCHW on the first device, the forward split over the mesh."""
        from torch_ekpose_tpu_torch.runtime.estimator import precision_mode

        single = self._single
        if single._needs_calib:
            single.calibrate([images])
        x = split_height(single._model_input(images), self.devices,
                         self._copies())
        with precision_mode(single.precision):
            (paf, heatmap), _ = self.model(x)
        return paf.gather(dtype=torch.float32), heatmap.gather(
            dtype=torch.float32)

    def estimate(self, image: np.ndarray) -> Tuple[List[Human], float]:
        im_pad, im_scale = self.pad(image)
        h, w = im_pad.shape[:2]
        paf, heatmap = self._forward(im_pad[None])
        with torch.inference_mode():
            packed = self._single._decode(heatmap.permute(0, 2, 3, 1),
                                          paf.permute(0, 2, 3, 1))
        packed = packed.cpu().numpy()
        return decode_device.packed_to_humans(packed[0], h, w,
                                              self.config), im_scale
