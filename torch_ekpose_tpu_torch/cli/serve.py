"""HTTP pose-estimation server on a CUDA card (PyTorch port).

    python -m torch_ekpose_tpu_torch.cli.serve -m vgg2016 -c ckpt.pth \\
        --device cuda --host 0.0.0.0 --port 8000 --max-batch 8

    curl -X POST --data-binary @image.jpg http://localhost:8000/pose
    curl http://localhost:8000/healthz

``-c`` takes a reference-format PyTorch checkpoint (``module.`` prefixes
are stripped); without one the weights are random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse

import torch

from torch_ekpose_tpu_torch.runtime.checkpoint import load_torch_state_dict
from torch_ekpose_tpu_torch.runtime.estimator import PRECISIONS, PoseEstimator
from torch_ekpose_tpu_torch.runtime.server import PoseServer

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": "int8", "int8_static": "int8_static"}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter
    )
    parser.add_argument("-m", "--model", default="vgg2016", help="model name")
    parser.add_argument("-c", "--ckpt", default=None,
                        help="reference-format .pth checkpoint")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on")
    parser.add_argument("--dtype", default=None, choices=sorted(_DTYPES),
                        help="forward compute dtype (default bfloat16, or "
                        "float32 under --precision highest; int8 modes are "
                        "not ported yet and are refused)")
    parser.add_argument("--precision", default="fast", choices=PRECISIONS,
                        help="'highest' turns TF32 off in the forward and "
                        "implies --dtype float32 unless it is set")
    parser.add_argument("--preprocess", default="vgg",
                        choices=["vgg", "rtpose"])
    parser.add_argument("--dest-size", type=int, default=368,
                        help="long image side after resizing")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights when -c is absent")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max-batch", type=int, default=8,
                        help="max frames sharing one estimate_batch call")
    parser.add_argument("--max-wait-ms", type=float, default=5.0,
                        help="micro-batching window")
    return parser


def resolve_dtype(args) -> None:
    """Resolve an unset ``--dtype`` against ``--precision`` (idempotent),
    as the JAX package's CLI does: ``highest`` reproduces the reference's
    float32 numerics, so it turns the unset dtype into float32 (bf16
    operands would make it a no-op); an explicit ``--dtype`` always wins;
    ``highest`` with an int8 mode is a contradiction and is refused."""
    if args.dtype is None:
        args.dtype = "float32" if args.precision == "highest" else "bfloat16"
    if args.precision == "highest" and args.dtype in ("int8", "int8_static"):
        raise SystemExit(
            "--precision highest (true-f32 multiplies) cannot combine "
            f"with --dtype {args.dtype}; drop one of the two flags"
        )


def parse_args(argv=None) -> argparse.Namespace:
    """The command line, with ``--dtype`` resolved."""
    args = build_parser().parse_args(argv)
    resolve_dtype(args)
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.ckpt is None:
        print("WARNING: no checkpoint given; using random initialization")
        state_dict = None
    else:
        state_dict = load_torch_state_dict(args.ckpt)
    estimator = PoseEstimator(
        args.model, state_dict, device=args.device,
        compute_dtype=_DTYPES[args.dtype], precision=args.precision,
        preprocess=args.preprocess, dest_size=args.dest_size, seed=args.seed,
        # the server batches frames and decodes on the card, as the JAX
        # CLI's parser.set_defaults(decode_backend="jax") does
        decode_backend="device",
    )
    server = PoseServer(
        estimator, host=args.host, port=args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
    )
    print(f"INFO: serving pose estimation on http://{args.host}:{args.port} "
          f"({estimator.device})")
    server.serve_forever()


if __name__ == "__main__":
    main()
