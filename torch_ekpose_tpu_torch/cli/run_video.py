"""Video pose inference (reference run_video.py), pipelined. Needs cv2.

    python -m torch_ekpose_tpu_torch.cli.run_video -m vgg2016 -c ckpt.pth \\
        -v in.mp4 -o out.mp4

Unlike the reference — which decodes the entire video into memory first
(reference run_video.py:42-52) and then runs one synchronous
frame->device->host->C++ round trip per frame — this pipeline streams:
a reader thread prefetches frames into a bounded queue, and by default
(``--decode-backend device``) the forward pass and the pose decode both
run on the card. ``-b N`` batches N frames, each padded to one shape,
through three stages on their own threads.
"""

from __future__ import annotations

import argparse
import queue
import threading
import time

from torch_ekpose_tpu_torch.cli import common
from torch_ekpose_tpu_torch.evaluate.evaluator import DEVICE_BACKENDS
from torch_ekpose_tpu_torch.utils.human import draw_humans


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter
    )
    common.add_model_args(parser)
    parser.add_argument("-v", "--video", type=str, required=True)
    parser.add_argument("-o", "--output", type=str, default=None)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument(
        "-b", "--batch", type=int, default=1,
        help="frames per device batch (>1 raises throughput at the cost "
        "of ~batch frames of latency; requires --decode-backend device)",
    )
    parser.set_defaults(decode_backend="device")
    args = parser.parse_args(argv)
    if args.batch > 1 and args.decode_backend not in DEVICE_BACKENDS:
        parser.error("--batch > 1 requires --decode-backend device "
                     "(the batched path decodes on the card)")

    cv2 = common.require("cv2", "run_video")

    estimator = common.build_estimator(args)

    capture = cv2.VideoCapture(args.video)
    if not capture.isOpened():
        raise SystemExit(f"ERROR: cannot open {args.video}")
    fps = capture.get(cv2.CAP_PROP_FPS) or 30.0
    output = args.output or args.video.rsplit(".", 1)[0] + "_out.mp4"

    frames: "queue.Queue" = queue.Queue(maxsize=64)

    def reader():
        n = 0
        while True:
            ok, frame = capture.read()
            if not ok or (args.max_frames and n >= args.max_frames):
                break
            frames.put(frame)
            n += 1
        frames.put(None)
        capture.release()

    threading.Thread(target=reader, daemon=True).start()

    writer = None
    n_frames = 0
    t0 = time.time()
    warm = [0.0, 0]  # (time, frames) after the first device call returns

    def write_frame(frame, humans):
        nonlocal writer, n_frames
        out = draw_humans(frame, humans)
        if writer is None:
            writer = cv2.VideoWriter(
                output, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                (out.shape[1], out.shape[0]),
            )
        writer.write(out)
        n_frames += 1
        if not warm[0]:
            # the first device call included cuDNN's first call per shape
            # (and, in a fresh checkout, the kernels' build); steady-state
            # throughput starts here
            warm[0], warm[1] = time.time(), n_frames

    if args.batch > 1:
        # batched throughput mode, three pipeline stages on their own
        # threads: reader (decode video + pad to the one static shape) ->
        # device (batched forward + decode, one batch always in flight) ->
        # writer (draw + encode). Steady-state throughput is the max of
        # the three stages, not their sum.
        import numpy as np

        from torch_ekpose_tpu_torch.runtime.estimator import padding

        stride = estimator.config.MODEL.DOWNSAMPLE
        padded: "queue.Queue" = queue.Queue(maxsize=64)

        def padder():
            while True:
                frame = frames.get()
                if frame is None:
                    padded.put(None)
                    return
                im_pad, _, _ = padding(frame, estimator.dest_size, stride)
                padded.put((frame, im_pad))

        threading.Thread(target=padder, daemon=True).start()

        done: "queue.Queue" = queue.Queue(maxsize=8)
        errors = []

        def writer_loop():
            # on error: record it but keep draining so the sentinel flows
            # and upstream puts never deadlock on the bounded queue
            while True:
                item = done.get()
                if item is None:
                    return
                if errors:
                    continue
                try:
                    for frame, humans in zip(*item):
                        write_frame(frame, humans)
                except Exception as e:  # surface encode errors
                    errors.append(e)

        writer_thread = threading.Thread(target=writer_loop, daemon=True)
        writer_thread.start()

        # collector thread: blocking result fetches overlap the dispatch
        # and device compute of the next batches (several batches stay in
        # flight, hiding the device->host copy's latency)
        inflight: "queue.Queue" = queue.Queue(maxsize=4)

        def collector_loop():
            while True:
                item = inflight.get()
                if item is None:
                    done.put(None)
                    return
                if errors:
                    continue
                batch_frames, handle = item
                try:
                    done.put((batch_frames, estimator.collect_batch(handle)))
                except Exception as e:  # device errors must not hang joins
                    errors.append(e)

        collector_thread = threading.Thread(
            target=collector_loop, daemon=True
        )
        collector_thread.start()

        pending = []

        def dispatch():
            batch = [p for _, p in pending]
            batch += [batch[-1]] * (args.batch - len(batch))
            handle = estimator.estimate_batch_async(np.stack(batch))
            batch_frames = [f for f, _ in pending]
            pending.clear()
            inflight.put((batch_frames, handle))

        while not errors:
            item = padded.get()
            if item is None:
                break
            pending.append(item)
            if len(pending) == args.batch:
                dispatch()
        if pending and not errors:
            dispatch()
        inflight.put(None)
        collector_thread.join()
        writer_thread.join()
        if errors:
            raise errors[0]
    else:
        while True:
            frame = frames.get()
            if frame is None:
                break
            humans, _ = estimator.estimate(frame)
            write_frame(frame, humans)
    if writer is not None:
        writer.release()
    t_end = time.time()
    dt = t_end - t0
    msg = (
        f"INFO: {n_frames} frames in {dt:.1f}s "
        f"({n_frames / max(dt, 1e-9):.2f} FPS incl. warm-up"
    )
    if warm[0] and n_frames > warm[1]:
        steady = (n_frames - warm[1]) / max(t_end - warm[0], 1e-9)
        msg += f", {steady:.2f} FPS steady-state"
    print(msg + f") -> {output}")


if __name__ == "__main__":
    main()
