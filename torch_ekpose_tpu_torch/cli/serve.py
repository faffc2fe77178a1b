"""HTTP pose-estimation server on a CUDA card (PyTorch port).

    python -m torch_ekpose_tpu_torch.cli.serve -m vgg2016 -c ckpt.pth \\
        --device cuda --host 0.0.0.0 --port 8000 --max-batch 8

    curl -X POST --data-binary @image.jpg http://localhost:8000/pose
    curl http://localhost:8000/healthz

``-c`` takes a reference-format PyTorch checkpoint (``module.`` prefixes
are stripped); without one the weights are random, drawn from ``--seed``.
Decoding a posted image needs cv2 or Pillow. The server always decodes
on the card, so ``--decode-backend`` takes ``device`` (or ``jax``) only.
"""

from __future__ import annotations

import argparse

from torch_ekpose_tpu_torch.cli import common
from torch_ekpose_tpu_torch.cli.common import (  # noqa: F401 (re-exported)
    _DTYPES, resolve_dtype)
from torch_ekpose_tpu_torch.evaluate.evaluator import DEVICE_BACKENDS
from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator
from torch_ekpose_tpu_torch.runtime.server import PoseServer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter
    )
    common.add_model_args(parser)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max-batch", type=int, default=8,
                        help="max frames sharing one estimate_batch call")
    parser.add_argument("--max-wait-ms", type=float, default=5.0,
                        help="micro-batching window")
    # the server batches frames and decodes on the card, as the JAX CLI's
    # parser.set_defaults(decode_backend="jax") does
    parser.set_defaults(decode_backend="device")
    return parser


def parse_args(argv=None) -> argparse.Namespace:
    """The command line, with ``--dtype`` resolved."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.decode_backend not in DEVICE_BACKENDS:
        parser.error(f"--decode-backend {args.decode_backend}: the server "
                     "batches frames and decodes them on the card (device)")
    resolve_dtype(args)
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    estimator = PoseEstimator(**common.estimator_kwargs(args))
    server = PoseServer(
        estimator, host=args.host, port=args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
    )
    print(f"INFO: serving pose estimation on http://{args.host}:{args.port} "
          f"({estimator.device})")
    server.serve_forever()


if __name__ == "__main__":
    main()
