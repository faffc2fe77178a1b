"""Inference runtime: padding, preprocessing and the batched estimator.

Counterpart of the JAX package's ``runtime/estimator.py`` (reference
lib/evaluate/estimator.py). A batch of uint8 BGR frames goes to the
device, is preprocessed there, runs the model's forward (any of the eight
names of ``models/factory.py``) in the compute dtype (cuDNN convs, NCHW)
and the batched decode
(``decode/device.py``); only the packed ``[B, L]`` result comes back, as
one device->host copy per batch. On a card each batch shape's forward
and decode are captured once in one CUDA graph and replayed
(:class:`PoseEstimator`). One image of any size goes through
``estimate``, which routes as the JAX package's does: the maps come back
to the host (``get_outputs``) and ``decode/api.py`` decodes them there
(``decode_backend="auto"``: native, else numpy), or, with ``"device"``,
the batched device decode runs on the image alone.

Public layouts are the JAX package's: frames ``[B, H, W, 3]`` uint8,
maps ``[B, h, w, C]``. :func:`nhwc_to_nchw` / :func:`nchw_to_nhwc` are the
one place the layouts change.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torch_ekpose_tpu_torch import constants
from torch_ekpose_tpu_torch.config import Config, cfg as default_cfg
from torch_ekpose_tpu_torch.decode import api as decode_api
from torch_ekpose_tpu_torch.decode import device as decode_device
from torch_ekpose_tpu_torch.models.factory import (
    cast_params, get_model, init_model)
from torch_ekpose_tpu_torch.models.quant import (
    calibrate_act_scales, has_act_scales, quantize_variables)
from torch_ekpose_tpu_torch.ops import block1, conv_chain, match, merge, nms
from torch_ekpose_tpu_torch.ops.resize import resize_image_np
from torch_ekpose_tpu_torch.utils import profiling
from torch_ekpose_tpu_torch.utils.human import Human

__all__ = [
    "MAX_GRAPHS", "PoseEstimator", "ServingForward", "imagenet_stats",
    "nchw_to_nhwc", "nhwc_to_nchw", "padding", "precision_mode",
    "preprocess",
]


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, C, H, W] (a view)."""
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H, W, C] (a view)."""
    return x.permute(0, 2, 3, 1)


#: the serving precision knob: "highest" turns TF32 off for the forward's
#: cuDNN convs and matmuls, "fast" allows it (float32 compute only; the
#: decode never uses TF32)
PRECISIONS = ("fast", "highest")


def precision_mode(precision: str):
    """Context manager setting the TF32 flags for ``precision``."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {precision!r}"
        )
    return decode_device.tf32(precision == "fast")


def _factor_closest(num: float, factor: int, is_ceil: bool = True) -> int:
    fn = np.ceil if is_ceil else np.floor
    return int(fn(float(num) / factor)) * factor


def padding(
    im: np.ndarray, dest_size: int = 368, factor: int = 8,
    is_ceil: bool = True,
) -> Tuple[np.ndarray, float, Tuple[int, int, int]]:
    """Resize the long side to ``dest_size`` and zero-pad H/W up to
    multiples of ``factor`` (reference estimator.py:52-68). cv2 when
    present (bit-parity with the reference), else the numpy bilinear."""
    im_scale = float(dest_size) / np.max(im.shape[0:2])
    new_w = int(np.rint(im.shape[1] * im_scale))
    new_h = int(np.rint(im.shape[0] * im_scale))
    try:
        import cv2

        # fx/fy form, as the reference calls it (estimator.py:60)
        im = cv2.resize(im, None, fx=im_scale, fy=im_scale)
    except ImportError:
        resized = resize_image_np(im.astype(np.float32), new_h, new_w, "linear")
        im = (
            np.clip(np.rint(resized), 0, 255).astype(im.dtype)
            if np.issubdtype(im.dtype, np.integer) else resized
        )

    h, w, c = im.shape
    im_pad = np.zeros(
        [_factor_closest(h, factor, is_ceil),
         _factor_closest(w, factor, is_ceil), c],
        dtype=im.dtype,
    )
    im_pad[0:h, 0:w, :] = im
    return im_pad, im_scale, im.shape


def imagenet_stats(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """ImageNet (mean, std) as fresh float32 tensors on ``device`` (a
    host->device copy on a card, which waits for the queued work:
    :class:`ServingForward` makes them once, as buffers)."""
    return tuple(
        torch.tensor(v, dtype=torch.float32, device=device)
        for v in (constants.IMAGENET_MEAN, constants.IMAGENET_STD)
    )


def preprocess(images: torch.Tensor, mode: str = "vgg",
               stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               ) -> torch.Tensor:
    """[..., H, W, 3] BGR frames (any dtype) -> float32, same layout.

    - ``"vgg"``: /255, BGR->RGB, imagenet mean/std (``stats``, made here
      when not given; reference preprocessing.py:32-43);
    - ``"rtpose"``: /256 - 0.5 (reference preprocessing.py:16-21).
    """
    x = images.float()
    if mode == "vgg":
        mean, std = stats if stats is not None else imagenet_stats(x.device)
        return (x.flip(-1) / 255.0 - mean) / std
    if mode == "rtpose":
        return x / 256.0 - 0.5
    raise ValueError(f"unknown preprocess mode {mode!r}")


class ServingForward(torch.nn.Module):
    """Frames [B, H, W, 3] (uint8 BGR, on the model's device) -> stage-6
    (paf, heatmap) as float32 NCHW: :func:`preprocess`, then ``model`` in
    ``act_dtype``. The ImageNet statistics are buffers made once on
    ``device``, outside any trace, so serving copies nothing to the card a
    call and an exported forward (``runtime/aot.py``) carries them as
    constants. The TF32 flags are the caller's (:func:`precision_mode`)."""

    def __init__(self, model: torch.nn.Module, mode: str, act_dtype,
                 device):
        super().__init__()
        self.model = model
        self.mode = mode
        self.act_dtype = act_dtype
        mean, std = imagenet_stats(device)
        self.register_buffer("mean", mean, persistent=False)
        self.register_buffer("std", std, persistent=False)

    def model_input(self, images: torch.Tensor) -> torch.Tensor:
        """Frames -> the model's NCHW input in ``act_dtype``."""
        x = nhwc_to_nchw(preprocess(images, self.mode, (self.mean, self.std)))
        return x.to(self.act_dtype, memory_format=torch.contiguous_format)

    def forward(self, images: torch.Tensor):
        (paf, heatmap), _ = self.model(self.model_input(images))
        return paf.float(), heatmap.float()


#: the kernel wrappers that count their launches in ``.launches``
_COUNTED = (nms.masked_peak_scores, match.greedy_match, merge.merge_people,
            conv_chain.conv_chain, conv_chain.conv3x3_sm90,
            conv_chain.conv3x3_f32, block1.conv1_fused, block1.block1_fused)

#: the most batch shapes one estimator captures; a repeated shape past
#: them stays eager. Callers bound their shapes (a batch size and a frame
#: size, or ``PoseServer``'s ``max_batch`` sizes a frame size), but
#: ``estimate`` and ``PoseServer`` pad frames of any size, and each graph
#: keeps its static frames, its output and its host-side graph.
MAX_GRAPHS = 64


class _Graph(NamedTuple):
    """One batch shape's forward and decode captured in one CUDA graph
    over its static uint8 frames ``images`` into its static ``packed``.
    ``calls``: each of ``_COUNTED``'s calls during the capture, which
    launched nothing; :meth:`replay` launches them and counts them."""
    graph: "torch.cuda.CUDAGraph"
    images: torch.Tensor
    packed: torch.Tensor
    calls: Tuple[int, ...]

    def replay(self) -> None:
        self.graph.replay()
        for wrapper, n in zip(_COUNTED, self.calls):
            wrapper.launches += n


class PoseEstimator:
    """Owns a model + weights on one device and serves pose inference.

    ``state_dict=None`` initializes random weights from ``seed``.
    Parameters are cast to ``compute_dtype`` once, as the JAX package's
    ``cast_params`` does (BN running statistics stay float32). ``device`` is the card
    unless the caller asks for another.

    ``compute_dtype="int8"`` or ``"int8_static"`` serves vgg2016's int8
    variant (``models/quant.py``; bf16 between the int8 convs): a float
    ``state_dict`` is quantized once, an int8 one (``cli.export``'s, the
    port's or the JAX package's) is taken as it is. ``"int8_static"``
    calibrates its activation scales with :meth:`calibrate`, or on the
    first frames it serves, unless the ``state_dict`` carries calibrated
    ``act_scale`` entries. ``decode_backend`` is one of
    ``decode/api.py``'s backends and decides how :meth:`estimate` decodes;
    the batched calls always decode on the device. ``s2d_blocks`` runs
    vgg2016's first N VGG blocks through the space-to-depth decomposition
    (``ops/s2d_conv.py``; the same ``state_dict``; not with int8, as in
    the JAX package).

    **CUDA graphs.** On a card, :meth:`estimate_batch_async` (and so
    :meth:`estimate_batch` and ``estimate`` with the ``"device"`` decode)
    runs a batch shape ``(B, H, W)``'s first batch eagerly, as always.
    Its second batch runs the forward and the decode once on a side
    stream, which serves it and warms the workspaces, and captures them
    in one CUDA graph (span ``estimator.capture``); every later batch of
    the shape copies its frames into the graph's static input and
    replays it (span ``dispatch.replay``). Nothing is captured on the
    CPU, while ``int8_static`` still has to calibrate, for frames other
    than uint8, or past :data:`MAX_GRAPHS` shapes. ``graphs`` maps each
    captured shape to its graph; ``graph_replays`` counts the batches a
    replay served. Each kernel wrapper's ``.launches`` still counts one
    launch a batch: a replay adds what its capture's calls took back.
    All the estimator's graphs share one memory pool: every replay is
    followed, on the same stream and under one lock, by the copy of its
    output to the batch's own pinned buffer before any other replay is
    enqueued, and no graph reads another's memory. :meth:`get_outputs`,
    ``estimate`` with a host decode and :meth:`calibrate` stay eager.
    The graphs hold the weights' memory: change weights in place only.
    """

    def __init__(
        self,
        model_name: str = "vgg2016",
        state_dict: Optional[dict] = None,
        config: Optional[Config] = None,
        *,
        device="cuda",
        compute_dtype=torch.bfloat16,
        precision: str = "fast",
        preprocess: str = "vgg",
        dest_size: int = 368,
        decode_backend: str = "auto",
        s2d_blocks: int = 0,
        seed: int = 0,
    ):
        with profiling.span("estimator.init"):
            quantize = False
            if isinstance(compute_dtype, str):
                quantize = {"int8": True, "int8_static": "static"}.get(
                    compute_dtype, False)
            if not quantize and compute_dtype not in (torch.float32,
                                                      torch.bfloat16):
                raise ValueError(
                    f"compute_dtype must be torch.float32, torch.bfloat16, "
                    f"'int8' or 'int8_static', got {compute_dtype!r}"
                )
            if decode_backend not in decode_api.BACKENDS:
                raise ValueError(
                    f"unknown decode_backend {decode_backend!r}; expected "
                    f"one of {decode_api.BACKENDS}"
                )
            precision_mode(precision)  # validates the name
            self.config = config or default_cfg
            self.model_name = model_name
            self.device = torch.device(device)
            self.compute_dtype = compute_dtype
            #: the activations' dtype: bf16 between an int8 model's convs
            self.act_dtype = torch.bfloat16 if quantize else compute_dtype
            self.precision = precision
            self.preprocess = preprocess
            self.dest_size = dest_size
            #: "jax" is the JAX package's name for the device decode
            self.decode_backend = ("device" if decode_backend == "jax"
                                   else decode_backend)
            #: the (B, H, W) batch shapes served so far; its size is how
            #: often the forward planned a shape anew
            self.shapes_seen = set()
            self._batch_ids = itertools.count()
            #: (B, H, W) -> its captured forward and decode
            self.graphs: Dict[Tuple[int, int, int], _Graph] = {}
            #: batches served by a graph's replay
            self.graph_replays = 0
            self._graph_lock = threading.Lock()
            self._graph_pool = None
            self._capture_stream = None
            with profiling.span("estimator.model"):
                if state_dict is None:
                    model = init_model(
                        model_name,
                        generator=torch.Generator().manual_seed(seed),
                        device=self.device, s2d_blocks=s2d_blocks,
                        quantize=quantize,
                    )
                    calibrated = False
                else:
                    model = get_model(
                        model_name, device=self.device,
                        s2d_blocks=s2d_blocks, quantize=quantize,
                    )
                    # a state_dict with act_scale entries is a calibrated
                    # static checkpoint: do not calibrate again on
                    # arbitrary first frames
                    calibrated = has_act_scales(state_dict)
                    if quantize:
                        state_dict = quantize_variables(state_dict, model)
                    model.load_state_dict(state_dict, strict=True)
                # cast once: halves weight traffic and drops per-call casts
                self.model = cast_params(model, self.act_dtype).eval()
            #: static int8 scales still to measure (on the first frames
            #: served)
            self._needs_calib = quantize == "static" and not calibrated
            #: preprocess + forward, the program ``runtime/aot.py`` exports
            self.serving_forward = ServingForward(
                self.model, preprocess, self.act_dtype, self.device)
            with profiling.span("estimator.decoder"):
                self._decode = decode_device.build_packed_decoder(
                    self.config, self.device)

    # -- static int8 calibration ------------------------------------------

    def _model_input(self, images) -> torch.Tensor:
        """[B, H, W, 3] frames (numpy or tensor) -> the model's NCHW input
        in the activation dtype, on the device."""
        return self.serving_forward.model_input(self._upload(images))

    def _upload(self, images) -> torch.Tensor:
        """[B, H, W, 3] frames (numpy or tensor) on the device."""
        return torch.as_tensor(np.ascontiguousarray(images)).to(
            self.device, non_blocking=True)

    @torch.inference_mode()
    def calibrate(self, image_batches) -> None:
        """Measure the static int8 activation scales (``int8_static``) on
        representative PADDED frames: an iterable of [H, W, 3] or
        [B, H, W, 3] arrays. Each quantized conv's scale becomes the
        largest ``|input|`` seen over all batches / 127 (the JAX package's
        ``PoseEstimator.calibrate``). Called with the first frames served
        if never called."""
        if self.compute_dtype != "int8_static":
            raise RuntimeError(
                "calibrate() applies to compute_dtype='int8_static' only")

        def inputs():
            for images in image_batches:
                images = np.asarray(images)
                yield self._model_input(
                    images[None] if images.ndim == 3 else images)

        with precision_mode(self.precision):
            calibrate_act_scales(self.model, inputs())
        self._needs_calib = False

    # -- device program ----------------------------------------------------

    @torch.inference_mode()
    def _forward(self, images: np.ndarray):
        """Frames -> stage-6 (paf, heatmap) as float32 NCHW on the device."""
        if self._needs_calib:
            self.calibrate([images])
        with profiling.span("dispatch.upload"):
            x = self._upload(images)
        with profiling.span("dispatch.forward"), \
                precision_mode(self.precision):
            return self.serving_forward(x)

    @torch.inference_mode()
    def _packed(self, images: np.ndarray) -> torch.Tensor:
        paf, heatmap = self._forward(images)
        with profiling.span("dispatch.decode"):
            return self._decode(nchw_to_nhwc(heatmap), nchw_to_nhwc(paf))

    def _program(self, x: torch.Tensor) -> torch.Tensor:
        """Device frames -> packed ``[B, L]``: what a graph captures."""
        with precision_mode(self.precision):
            paf, heatmap = self.serving_forward(x)
        return self._decode(nchw_to_nhwc(heatmap), nchw_to_nhwc(paf))

    def _graphed(self, images: np.ndarray) -> bool:
        """Whether a batch of a shape served before goes through the
        shape's graph."""
        return (self.device.type == "cuda" and images.dtype == np.uint8
                and not self._needs_calib
                and (images.shape[:3] in self.graphs
                     or len(self.graphs) < MAX_GRAPHS))

    def _capture(self, images: torch.Tensor):
        """Run the program once on the capture stream over the static
        ``images`` (its output serves the batch; the run sets up cuBLAS's
        and cuDNN's workspaces), then capture it in one graph of the
        shared pool; returns (the graph, that output). ``thread_local``:
        a thread waiting on a batch's event meanwhile does not break the
        capture."""
        with torch.cuda.device(self.device):
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
                self._capture_stream = torch.cuda.Stream(self.device)
            main = torch.cuda.current_stream(self.device)
            side = self._capture_stream
            side.wait_stream(main)
            with torch.cuda.stream(side):
                packed = self._program(images)
            main.wait_stream(side)
            packed.record_stream(main)
            before = [k.launches for k in _COUNTED]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._graph_pool, stream=side,
                                  capture_error_mode="thread_local"):
                static = self._program(images)
            calls = tuple(k.launches - n for k, n in zip(_COUNTED, before))
            for wrapper, n in zip(_COUNTED, calls):
                wrapper.launches -= n
        return _Graph(graph, images, static, calls), packed

    @torch.inference_mode()
    def _replay(self, images: np.ndarray, batch: int) -> torch.Tensor:
        """Upload ``images`` into their shape's static input and replay
        the shape's graph, or capture it if it has none; returns the
        packed output (the caller holds the lock)."""
        shape = images.shape[:3]
        graph = self.graphs.get(shape)
        static = (graph.images if graph is not None else torch.empty(
            images.shape, dtype=torch.uint8, device=self.device))
        with profiling.span("dispatch.upload"):
            static.copy_(torch.as_tensor(np.ascontiguousarray(images)),
                         non_blocking=True)
        if graph is None:
            with profiling.span("estimator.capture", batch):
                self.graphs[shape], packed = self._capture(static)
            return packed
        with profiling.span("dispatch.replay"):
            graph.replay()
        self.graph_replays += 1
        return graph.packed

    # -- public API ----------------------------------------------------------

    def get_outputs_batch(self, images: np.ndarray):
        """Batched forward over same-shape padded images [B, H, W, 3] ->
        (pafs [B, h, w, 38], heatmaps [B, h, w, 19]) float32 numpy."""
        paf, heatmap = self._forward(images)
        return (nchw_to_nhwc(paf).cpu().numpy(),
                nchw_to_nhwc(heatmap).cpu().numpy())

    def estimate_batch(self, images: np.ndarray) -> List[List[Human]]:
        """Assembled people for a batch of same-shape padded images
        [B, H, W, 3]."""
        return self.collect_batch(self.estimate_batch_async(images))

    def estimate_batch_async(self, images: np.ndarray):
        """Enqueue a batch and its device->host copy without waiting;
        returns a handle for :meth:`collect_batch`: (packed buffer, its
        event or None on the CPU, B, H, W, the batch's id). The handle
        stays valid after later batches."""
        shape = images.shape[:3]
        batch = next(self._batch_ids)
        if shape in self.shapes_seen:
            return self._dispatch(images, batch, self._graphed(images))
        # the first batch of a shape: cuDNN's plans, lazy module loads,
        # the kernel library's first load
        with profiling.span("estimator.first_shape", batch):
            handle = self._dispatch(images, batch, False)
        self.shapes_seen.add(shape)
        return handle

    def _dispatch(self, images: np.ndarray, batch: int, graphed: bool):
        with profiling.span("dispatch", batch):
            if not graphed:
                return self._copy_out(self._packed(images), images, batch)
            with self._graph_lock:
                packed = self._replay(images, batch)
                return self._copy_out(packed, images, batch)

    def _copy_out(self, packed: torch.Tensor, images: np.ndarray,
                  batch: int):
        """The handle of a batch whose packed result is ``packed``: on a
        card, its copy into a pinned buffer of its own, enqueued, and the
        event that marks it done."""
        b, h, w = images.shape[:3]
        with profiling.span("dispatch.copy"):
            if self.device.type != "cuda":
                return packed, None, b, h, w, batch
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            return host, done, b, h, w, batch

    def collect_batch(self, handle) -> List[List[Human]]:
        """Wait for a handle from :meth:`estimate_batch_async` and convert
        its packed buffer to Humans."""
        packed, done, b, h, w, batch = handle
        with profiling.span("collect", batch):
            with profiling.span("collect.wait"):
                if done is not None:
                    done.synchronize()
            with profiling.span("collect.humans"):
                packed = packed.numpy()
                return [
                    decode_device.packed_to_humans(packed[i], h, w,
                                                   self.config)
                    for i in range(b)
                ]

    def get_outputs(
        self, image: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, float]:
        """(pafs [h, w, 38], heatmaps [h, w, 19], im_scale) as float32
        numpy for one BGR image of any size (reference
        estimator.py:71-88), with one device->host copy."""
        im_pad, im_scale, _ = padding(
            image, self.dest_size, self.config.MODEL.DOWNSAMPLE
        )
        paf, heatmap = self._forward(im_pad[None])
        maps = nchw_to_nhwc(torch.cat((paf, heatmap), dim=1))[0].cpu().numpy()
        n_paf = paf.shape[1]
        return (np.ascontiguousarray(maps[..., :n_paf]),
                np.ascontiguousarray(maps[..., n_paf:]), im_scale)

    def estimate(self, image: np.ndarray) -> Tuple[List[Human], float]:
        """Assembled people + im_scale for one BGR image of any size:
        ``get_outputs`` and the host decode of ``decode_backend``, or with
        ``"device"`` the batched device decode of the image alone."""
        if self.decode_backend == "device":
            im_pad, im_scale, _ = padding(
                image, self.dest_size, self.config.MODEL.DOWNSAMPLE
            )
            return self.estimate_batch(im_pad[None])[0], im_scale
        pafs, heatmaps, im_scale = self.get_outputs(image)
        humans = decode_api.paf_to_pose(
            heatmaps, pafs, self.config, backend=self.decode_backend
        )
        return humans, im_scale
