"""Live webcam pose inference with a rolling FPS meter
(reference run_webcam.py). Needs cv2.

    python -m torch_ekpose_tpu_torch.cli.run_webcam -m vgg2016 -c ckpt.pth
"""

from __future__ import annotations

import argparse
import platform
from collections import deque
from time import time

from torch_ekpose_tpu_torch.cli import common
from torch_ekpose_tpu_torch.utils.human import draw_humans


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter
    )
    common.add_model_args(parser)
    parser.add_argument("--camera", type=int, default=0)
    parser.add_argument("--headless", action="store_true",
                        help="no display window (prints FPS only)")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.set_defaults(decode_backend="device")
    args = parser.parse_args(argv)

    cv2 = common.require("cv2", "run_webcam")

    estimator = common.build_estimator(args)

    if platform.system() == "Darwin":
        capture = cv2.VideoCapture(args.camera, cv2.CAP_AVFOUNDATION)
    else:
        capture = cv2.VideoCapture(args.camera)
    if not capture.isOpened():
        raise SystemExit("ERROR: cannot open camera")

    frame_times: deque = deque(maxlen=60)
    fps_seen = []
    n = 0
    try:
        while True:
            ok, frame = capture.read()
            if not ok:
                break
            start = time()
            humans, _ = estimator.estimate(frame)
            out = draw_humans(frame, humans)
            frame_times.append(time() - start)
            fps = len(frame_times) / max(sum(frame_times), 1e-9)
            fps_seen.append(fps)
            if not args.headless:
                cv2.putText(
                    out, f"FPS: {fps:.1f}", (10, 30),
                    cv2.FONT_HERSHEY_SIMPLEX, 1.0, (0, 255, 0), 2,
                )
                cv2.imshow("torch_ekpose_tpu_torch", out)
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    break
            n += 1
            if args.max_frames and n >= args.max_frames:
                break
    finally:
        capture.release()
        if not args.headless:
            cv2.destroyAllWindows()
        if fps_seen:
            print(
                f"FPS  max {max(fps_seen):.1f}  "
                f"avg {sum(fps_seen) / len(fps_seen):.1f}  "
                f"min {min(fps_seen):.1f}"
            )


if __name__ == "__main__":
    main()
