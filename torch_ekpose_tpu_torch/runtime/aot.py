"""AOT deployment artifacts: the serving pipeline as two exported programs.

Counterpart of the JAX package's ``runtime/aot.py``. ``export_pipeline``
bundles everything a serving process needs into ONE file: the batched
preprocess + forward program and the batched packed-decode program, both
traced by ``torch.export`` for one fixed input shape, the parameters
inside the first, and the decode metadata. ``load_pipeline`` restores it
and serves without the model-building code (``models/``) or a
checkpoint: the artifact is the deployable unit, pinned to the graph that
was validated at export time.

The decode program holds the three decode kernels as the custom ops
``ekpose::masked_peak_scores``, ``ekpose::greedy_match`` and
``ekpose::merge_people`` (``ops/``), which dispatch by device to the CUDA
kernel or to the plain twin; loading imports those registrations and
nothing else of the package's model code. On a card, the loaded pair is
captured once in one CUDA graph (static input and output buffers), the
counterpart of XLA compiling the StableHLO at load: a call copies the
frames in and replays the graph, with no host launch per op. A capture
that fails raises; nothing falls back to eager launches on the card.

Artifacts are platform-specific (the traced programs hold their device's
constants and kernels); the platform is recorded and checked at load.
The TF32 flags are global state that an exported graph does not record:
:class:`AotPipeline` sets them from ``meta`` around every call and around
the capture (the forward's from ``precision``, the decode's off).

Container format (zip, stored):
    meta.json     format and torch versions, model, dtype, precision,
                  preprocess mode, platform, shapes, decode caps
    forward.pt2   ``torch.export.save`` of (images [B,H,W,3] uint8) ->
                  (paf [B,h,w,38], heatmap [B,h,w,19]) float32, the
                  parameters included
    decode.pt2    ``torch.export.save`` of (heatmap, paf) -> packed
                  [B, L] float32

Forward and decode stay two programs, as in the JAX package and as the
live estimator runs them.
"""

from __future__ import annotations

import io
import json
import threading
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from torch_ekpose_tpu_torch.config import Config
from torch_ekpose_tpu_torch.decode import device as decode_device
# the custom ops the decode program calls
from torch_ekpose_tpu_torch.ops import match, merge, nms  # noqa: F401

FORMAT_VERSION = 1
PLATFORMS = ("cuda", "cpu")

__all__ = [
    "FORMAT_VERSION",
    "export_pipeline",
    "load_pipeline",
    "AotPipeline",
    "AotServingAdapter",
]


class _NhwcForward(torch.nn.Module):
    """An estimator's ``ServingForward`` with the maps in the public NHWC
    layout (views of its NCHW outputs)."""

    def __init__(self, serving_forward: torch.nn.Module):
        super().__init__()
        self.serving = serving_forward

    def forward(self, images: torch.Tensor):
        paf, heatmap = self.serving(images)
        return paf.permute(0, 2, 3, 1), heatmap.permute(0, 2, 3, 1)


def _dtype_name(compute_dtype) -> str:
    if isinstance(compute_dtype, str):
        return compute_dtype
    return str(compute_dtype).replace("torch.", "")


def _save(program) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_pipeline(
    estimator,
    path: str,
    batch: int,
    height: int,
    width: int,
    platform: Optional[str] = None,
) -> Dict[str, Any]:
    """Export a :class:`~torch_ekpose_tpu_torch.runtime.estimator.PoseEstimator`'s
    batched serving pipeline (preprocess + forward, packed decode) for
    fixed ``[batch, height, width, 3]`` uint8 input. Returns the metadata
    dict that was written.

    ``height``/``width`` must be multiples of the model stride (the
    caller pads frames as online serving does:
    ``runtime.estimator.padding``). ``platform`` defaults to the
    estimator's device type; the programs are traced on that device, so
    exporting for another platform is refused rather than miscompiled.
    """
    stride = estimator.config.MODEL.DOWNSAMPLE
    if height % stride or width % stride:
        raise ValueError(
            f"height/width must be multiples of the model stride "
            f"{stride}, got {height}x{width}"
        )
    device = estimator.device
    platform = platform or device.type
    if platform not in PLATFORMS or platform != device.type:
        raise ValueError(
            f"cannot export for platform {platform!r} from an estimator on "
            f"{device.type!r}: the programs are traced on the estimator's "
            f"device — build the estimator on the target platform "
            f"({' or '.join(PLATFORMS)})"
        )
    if estimator._needs_calib:
        raise ValueError(
            "int8_static estimator has no calibrated activation scales "
            "yet — calibrate() first (or export from a checkpoint "
            "written by cli.export --dtype int8_static)"
        )

    forward = _NhwcForward(estimator.serving_forward).eval()
    decoder = estimator._decode
    images = torch.zeros((batch, height, width, 3), dtype=torch.uint8,
                         device=device)
    with torch.no_grad():
        with decode_device.tf32(estimator.precision == "fast"):
            paf, heatmap = forward(images)
        exp_fwd = torch.export.export(forward, (images,), strict=False)
        exp_dec = torch.export.export(decoder, (heatmap, paf), strict=False)

    cfg = estimator.config
    meta = {
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "model": estimator.model_name,
        "dtype": _dtype_name(estimator.compute_dtype),
        "precision": estimator.precision,
        "preprocess": estimator.preprocess,
        "platform": platform,
        "batch": batch,
        "height": height,
        "width": width,
        "stride": stride,
        "max_peaks": cfg.DECODE.max_peaks_per_part,
        "subset_cap": cfg.DECODE.max_people * 3,
        "heatmap_shape": list(heatmap.shape),
        "paf_shape": list(paf.shape),
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("meta.json", json.dumps(meta, indent=1))
        zf.writestr("forward.pt2", _save(exp_fwd))
        zf.writestr("decode.pt2", _save(exp_dec))
    return meta


class AotPipeline:
    """A loaded deployment artifact: fixed-shape batched pose inference.

    ``estimate_batch(images)`` takes uint8 ``[B, H, W, 3]`` frames padded
    to the artifact's shape (pad smaller frames with
    :func:`runtime.estimator.padding`) and returns assembled
    :class:`~torch_ekpose_tpu_torch.utils.human.Human` lists, as
    ``PoseEstimator.estimate_batch`` does. ``packed(images)`` returns the
    packed decode buffer on the device for custom post-processing.

    It is built from the two loaded programs (callables). On ``cuda``
    the pair is warmed on a side stream and captured in one CUDA graph at
    construction; on the CPU each call runs them eagerly (so do
    :meth:`forward`, :meth:`decode` and :meth:`run_eager` on any device).
    Calls are serialized by a lock: the graph's buffers are shared.
    """

    def __init__(self, meta: Dict[str, Any], forward, decode):
        self.meta = meta
        self.device = torch.device(meta["platform"])
        self._fwd = forward
        self._dec = decode
        self.config = Config()
        self.config.DECODE.max_peaks_per_part = meta["max_peaks"]
        self.config.DECODE.max_people = meta["subset_cap"] // 3
        self._lock = threading.Lock()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        if self.device.type == "cuda":
            self._capture()

    @property
    def batch(self) -> int:
        return self.meta["batch"]

    @property
    def input_shape(self):
        m = self.meta
        return (m["batch"], m["height"], m["width"], 3)

    def _check(self, images) -> None:
        want = self.input_shape
        if tuple(images.shape) != want or images.dtype != np.uint8:
            raise ValueError(
                f"artifact expects input {want} uint8, got "
                f"{tuple(images.shape)} {images.dtype} — pad frames with "
                f"runtime.estimator.padding and batch to size "
                f"{want[0]}"
            )

    def forward(self, images: torch.Tensor):
        """The forward program, op by op: device frames -> (paf, heatmap)
        NHWC float32, under the artifact's TF32 flags."""
        with torch.no_grad(), decode_device.tf32(
                self.meta["precision"] == "fast"):
            return self._fwd(images)

    def decode(self, heatmap: torch.Tensor, paf: torch.Tensor):
        """The decode program, op by op (TF32 off): NHWC maps -> packed
        [B, L]."""
        with torch.no_grad(), decode_device.tf32(False):
            return self._dec(heatmap, paf)

    def run_eager(self, images: torch.Tensor) -> torch.Tensor:
        """Both programs on device frames, op by op: what the CUDA graph
        captures and replays."""
        paf, heatmap = self.forward(images)
        return self.decode(heatmap, paf)

    def _capture(self) -> None:
        """Warm both programs on a side stream (the kernels' build,
        cuDNN's and cuBLAS's handles and workspaces), then capture the
        pair in one CUDA graph over static buffers."""
        self._static_in = torch.zeros(self.input_shape, dtype=torch.uint8,
                                      device=self.device)
        self._host_in = torch.empty(self.input_shape, dtype=torch.uint8,
                                    pin_memory=True)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(2):
                self.run_eager(self._static_in)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._static_out = self.run_eager(self._static_in)
        self._host_out = torch.empty(self._static_out.shape,
                                     dtype=self._static_out.dtype,
                                     pin_memory=True)
        self._copied = torch.cuda.Event()
        self.graph = graph

    def _launch(self, images: np.ndarray) -> torch.Tensor:
        """Enqueue the pipeline on ``images``. On a card: the frames go
        through pinned memory into the static input and the graph
        replays; the result is the graph's static output, valid until the
        next call (hold the lock)."""
        self._check(images)
        if self.graph is None:
            return self.run_eager(torch.as_tensor(np.ascontiguousarray(images)))
        # the previous call's upload has left the pinned buffer
        self._copied.synchronize()
        self._host_in.numpy()[...] = images
        self._static_in.copy_(self._host_in, non_blocking=True)
        self._copied.record()
        self.graph.replay()
        return self._static_out

    def packed(self, images: np.ndarray) -> torch.Tensor:
        """The packed ``[B, L]`` decode buffer on the device (a copy of
        the graph's output on a card)."""
        with self._lock:
            out = self._launch(images)
            return out.clone() if self.graph is not None else out

    def estimate_batch(self, images: np.ndarray) -> List[List]:
        """Assembled people for each of the padded frames."""
        with self._lock:
            out = self._launch(images)
            if self.graph is not None:
                # one device->host copy, finished before the next replay
                # may overwrite the static output
                self._host_out.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
                out = self._host_out
            packed = out.numpy()
            m = self.meta
            return [
                decode_device.packed_to_humans(
                    packed[i], m["height"], m["width"], self.config)
                for i in range(m["batch"])
            ]


class AotServingAdapter:
    """Adapts an :class:`AotPipeline` to the live-estimator serving
    surface (``runtime.server.PoseServer``): arbitrary BGR frames are
    letterboxed into the artifact's fixed ``[H, W]`` frame, and partial
    batches are zero-padded up to the artifact batch (the padded rows'
    results are dropped).

    ``scale`` keeps the reference's coordinate contract
    (``x_px = x_norm * W_pad / scale``, reference eval.py:110-111): it is
    the resize factor applied to the original frame, with the letterbox
    zero region part of the padded frame exactly like
    ``runtime.estimator.padding``'s to-multiple-of-8 margin.
    """

    def __init__(self, pipeline: AotPipeline):
        self.pipeline = pipeline
        self.config = pipeline.config
        self.device = pipeline.device
        m = pipeline.meta
        self.model_name = f"{m['model']} (AOT {m['platform']})"
        self.dest_size = max(m["height"], m["width"])

    def pad_image(self, image: np.ndarray):
        """Letterbox one BGR frame into the artifact frame.

        Returns (im_pad [H, W, 3] uint8, scale) with
        scale = min(H/h0, W/w0) — both dims always fit, unlike the
        long-side rule, because the artifact shape is fixed.
        """
        import cv2

        h, w = self.pipeline.meta["height"], self.pipeline.meta["width"]
        h0, w0 = image.shape[:2]
        scale = min(h / h0, w / w0)
        resized = cv2.resize(
            image, (0, 0), fx=scale, fy=scale,
            interpolation=cv2.INTER_CUBIC,
        )
        canvas = np.zeros((h, w, 3), dtype=np.uint8)
        canvas[: resized.shape[0], : resized.shape[1]] = resized
        return canvas, scale

    def estimate_batch(self, images: np.ndarray) -> List[List]:
        b = self.pipeline.batch
        n = images.shape[0]
        if n > b:
            raise ValueError(
                f"batch {n} exceeds the artifact batch {b}"
            )
        if n < b:
            pad = np.zeros((b - n, *images.shape[1:]), images.dtype)
            images = np.concatenate([images, pad])
        return self.pipeline.estimate_batch(images)[:n]

    def estimate(self, image: np.ndarray):
        """(humans, scale) for one arbitrary BGR frame."""
        im_pad, scale = self.pad_image(image)
        return self.estimate_batch(im_pad[None])[0], scale


def load_pipeline(path: str) -> AotPipeline:
    """Load an artifact written by :func:`export_pipeline`; on ``cuda``
    the pair is captured in one CUDA graph (a failed capture raises)."""
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"unsupported artifact format "
                f"{meta.get('format_version')!r} (this build reads "
                f"{FORMAT_VERSION})"
            )
        here = "cuda" if torch.cuda.is_available() else "cpu"
        if meta["platform"] != here:
            raise ValueError(
                f"artifact was exported for {meta['platform']!r} but this "
                f"host runs on {here!r} — export per platform"
            )
        exp_fwd = torch.export.load(io.BytesIO(zf.read("forward.pt2")))
        exp_dec = torch.export.load(io.BytesIO(zf.read("decode.pt2")))
    return AotPipeline(meta, exp_fwd.module(), exp_dec.module())
