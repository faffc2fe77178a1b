"""HTTP pose-estimation server with device micro-batching.

Counterpart of the JAX package's ``runtime/server.py``, with the same
worker and endpoints. Stdlib-only: ``ThreadingHTTPServer`` accepts
concurrent requests, a single device worker drains a queue and batches up
to ``max_batch`` same-shape frames per ``estimate_batch`` call (requests
arriving within ``max_wait_ms`` of each other share a batch), so
throughput under load approaches the batched device rate while a lone
request pays only its own latency.

Endpoints:

- ``POST /pose``  — raw JPEG/PNG body (or base64 JSON {"image": ...});
  responds {"humans": [{"score", "parts": {id: {x, y, score,
  part_name}}}], "latency_ms"} with x/y normalized to the padded frame
  (the reference's BodyPart convention, reference common.py:277-298).
  The body is decoded by cv2, else Pillow; without either library every
  post answers 400 with a message that says so.
- ``GET /healthz`` — {"status": "ok", "model": ..., "device": ...}, the
  device being the estimator's torch device.
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from torch_ekpose_tpu_torch import constants
from torch_ekpose_tpu_torch.runtime.estimator import padding
from torch_ekpose_tpu_torch.utils.human import Human

__all__ = ["PoseServer", "humans_to_json"]


def humans_to_json(
    humans: List[Human],
    scale: Optional[float] = None,
    padded_shape=None,
) -> List[dict]:
    """x/y are normalized to the padded frame (the reference's BodyPart
    convention). When ``scale``/``padded_shape`` are given, each part also
    carries x_px/y_px — pixel coordinates in the CLIENT's original image
    (x_norm * padded_W / scale, the append_result mapping,
    reference eval.py:110-111)."""
    out = []
    for h in humans:
        parts = {}
        for idx, bp in h.body_parts.items():
            entry = {
                "x": round(float(bp.x), 6),
                "y": round(float(bp.y), 6),
                "score": round(float(bp.score), 5),
                "part_name": constants.KEYPOINTS[idx]
                if idx < len(constants.KEYPOINTS) else str(idx),
            }
            if scale is not None and padded_shape is not None:
                entry["x_px"] = round(
                    float(bp.x) * padded_shape[1] / scale, 2
                )
                entry["y_px"] = round(
                    float(bp.y) * padded_shape[0] / scale, 2
                )
            parts[str(idx)] = entry
        out.append({"score": round(float(h.score), 5), "parts": parts})
    return out


def _decode_image(body: bytes, content_type: str) -> np.ndarray:
    if content_type.startswith("application/json"):
        payload = json.loads(body)
        body = base64.b64decode(payload["image"])
    try:
        import cv2

        img = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError("undecodable image")
        return img
    except ImportError:
        pass
    try:
        from PIL import Image
    except ImportError:
        raise ValueError("undecodable image: decoding needs cv2 or Pillow, "
                         "and neither is installed") from None
    import io

    rgb = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
    return rgb[:, :, ::-1].copy()


class _Request:
    __slots__ = ("im_pad", "event", "humans", "error")

    def __init__(self, im_pad):
        self.im_pad = im_pad
        self.event = threading.Event()
        self.humans: Optional[List[Human]] = None
        self.error: Optional[Exception] = None


class PoseServer:
    """Owns an estimator + a micro-batching device worker."""

    def __init__(
        self,
        estimator,
        host: str = "127.0.0.1",
        port: int = 8000,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
    ):
        self.estimator = estimator
        self.host = host
        self.port = port
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._threads: List[threading.Thread] = []

    # -- device worker ----------------------------------------------------

    def _worker(self):
        carry: Optional[_Request] = None
        while not self._stop.is_set():
            if carry is not None:
                first, carry = carry, None
            else:
                try:
                    first = self._queue.get(timeout=0.1)
                except queue.Empty:
                    continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait_ms / 1e3
            while len(batch) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                # only same-shape frames can share a batch; a mismatched
                # request seeds the NEXT batch
                if nxt.im_pad.shape == first.im_pad.shape:
                    batch.append(nxt)
                else:
                    carry = nxt
                    break
            self._run_batch(batch)
        # fail fast anything still pending at shutdown
        leftovers = [carry] if carry is not None else []
        while True:
            try:
                leftovers.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for req in leftovers:
            req.error = RuntimeError("server shutting down")
            req.event.set()

    def _run_batch(self, batch: List[_Request]):
        try:
            stack = np.stack([r.im_pad for r in batch])
            humans_b = self.estimator.estimate_batch(stack)
            for req, humans in zip(batch, humans_b):
                req.humans = humans
        except Exception as e:  # surface device errors to the client
            for req in batch:
                req.error = e
        finally:
            for req in batch:
                req.event.set()

    # -- request handling --------------------------------------------------

    def submit(self, image: np.ndarray, timeout: float = 300.0):
        """Pad + enqueue one BGR image; blocks until its batch returns.
        Returns (humans, scale, padded_shape). The first request at a new
        shape pays cuDNN's algorithm search and, in a fresh checkout, the
        kernels' build, so the timeout is sized for the cold path."""
        if hasattr(self.estimator, "pad_image"):
            # an AOT artifact serves ONE fixed frame shape: its adapter
            # letterboxes into it (runtime/aot.py::AotServingAdapter)
            im_pad, scale = self.estimator.pad_image(image)
        else:
            im_pad, scale, _ = padding(
                image, self.estimator.dest_size,
                self.estimator.config.MODEL.DOWNSAMPLE,
            )
        req = _Request(im_pad)
        self._queue.put(req)
        if not req.event.wait(timeout):
            raise TimeoutError("pose request timed out")
        if req.error is not None:
            raise req.error
        return req.humans, scale, im_pad.shape[:2]

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {
                        "status": "ok",
                        "model": server.estimator.model_name,
                        "device": str(server.estimator.device),
                    })
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/pose":
                    self._reply(404, {"error": "not found"})
                    return
                try:  # malformed input -> 400
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length)
                    image = _decode_image(
                        body, self.headers.get("Content-Type", "")
                    )
                except Exception as e:
                    self._reply(400, {"error": str(e)})
                    return
                try:  # device/server faults -> 500 (retryable)
                    t0 = time.perf_counter()
                    humans, scale, padded = server.submit(image)
                    self._reply(200, {
                        "humans": humans_to_json(humans, scale, padded),
                        "image_size": [
                            int(image.shape[0]), int(image.shape[1])
                        ],
                        "padded_size": [int(padded[0]), int(padded[1])],
                        "scale": round(float(scale), 6),
                        "latency_ms": round(
                            (time.perf_counter() - t0) * 1e3, 2
                        ),
                    })
                except Exception as e:
                    self._reply(500, {"error": str(e)})

        return Handler

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        self._httpd = ThreadingHTTPServer(
            (self.host, self.port), self._make_handler()
        )
        self.port = self._httpd.server_address[1]  # resolve port 0
        for target in (self._worker, self._httpd.serve_forever):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self, timeout: float = 30.0):
        """Stop serving and join the worker and HTTP threads."""
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        for t in self._threads:
            t.join(timeout)

    def serve_forever(self):
        self.start()
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            self.stop()
