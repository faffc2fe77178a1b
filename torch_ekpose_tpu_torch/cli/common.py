"""Shared CLI plumbing of the port: the model flags, checkpoint loading,
``--dtype`` resolution and estimator construction (counterpart of the
JAX package's ``cli/common.py``; reference lib/evaluate/estimator.py:7-42
``get_using_device`` / ``load_ckpt``).

Flags that mean the same thing keep the JAX CLI's names. ``--device``
(default ``cuda``) takes the place of ``--platform``, and ``--seed``
draws the random weights when ``-c`` is absent. The int8 dtypes and
``.msgpack`` checkpoints (the flax reader is not ported) are refused with
a clear error. The JAX CLI's flags the port has no use for
(``--s2d-blocks``, ``--num-devices``, ``--compilation-cache``) are left
out, so argparse refuses them.
"""

from __future__ import annotations

import argparse
import importlib
from typing import Optional

import torch

from torch_ekpose_tpu_torch.config import Config
from torch_ekpose_tpu_torch.decode.api import BACKENDS
from torch_ekpose_tpu_torch.runtime.checkpoint import load_torch_state_dict
from torch_ekpose_tpu_torch.runtime.estimator import PRECISIONS, PoseEstimator

__all__ = ["add_model_args", "build_estimator", "estimator_kwargs",
           "load_variables", "require",
           "resolve_dtype"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": "int8", "int8_static": "int8_static"}


def add_model_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-m", "--model", default="vgg2016", help="model name")
    parser.add_argument("-c", "--ckpt", default=None,
                        help="reference-format .pth/.pt checkpoint "
                        "(``module.`` prefixes are stripped)")
    parser.add_argument("--preprocess", default="vgg",
                        choices=["vgg", "rtpose"])
    parser.add_argument("--decode-backend", default="auto", choices=BACKENDS,
                        help="host decode of one image's maps: 'native' "
                        "(C++), 'numpy', 'auto' (native, else numpy); "
                        "'device' (alias 'jax') decodes on the card")
    parser.add_argument("--dtype", default=None, choices=sorted(_DTYPES),
                        help="forward compute dtype (default bfloat16, or "
                        "float32 under --precision highest; int8 modes are "
                        "not ported yet and are refused)")
    parser.add_argument("--precision", default="fast", choices=PRECISIONS,
                        help="'highest' turns TF32 off in the forward and "
                        "implies --dtype float32 unless it is set")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (the reference's "
                        "--device flag; the JAX CLI's --platform)")
    parser.add_argument("--dest-size", type=int, default=368,
                        help="inference resolution: the long image side is "
                        "resized to this before padding")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights when -c is absent")


def load_variables(model_name: str, ckpt: Optional[str]):
    """The ``state_dict`` of ``ckpt`` (a reference ``.pth``/``.pt``), or
    None, which makes :class:`PoseEstimator` draw random weights from
    ``--seed``."""
    if ckpt is None:
        print("WARNING: no checkpoint given; using random initialization")
        return None
    if not ckpt.endswith((".pth", ".pt")):
        raise SystemExit(
            f"cannot load {ckpt}: the port reads reference .pth/.pt "
            "checkpoints only (the flax .msgpack reader is not ported; the "
            "JAX package's runtime.export_torch_checkpoint writes a .pth)")
    print(f"INFO: loading reference checkpoint {ckpt} for {model_name}")
    return load_torch_state_dict(ckpt)


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


def require(module: str, user: str):
    """Import ``module``, or exit with a clear message that ``user`` needs
    it where it is not installed."""
    try:
        return importlib.import_module(module)
    except ImportError:
        raise SystemExit(
            f"{user} needs {module}, which is not installed") from None


def estimator_kwargs(args, config: Optional[Config] = None) -> dict:
    """:class:`PoseEstimator`'s arguments from the parsed flags (``--dtype``
    resolved, the checkpoint loaded)."""
    resolve_dtype(args)
    return dict(
        model_name=args.model,
        state_dict=load_variables(args.model, args.ckpt),
        config=config,
        device=args.device,
        compute_dtype=_DTYPES[args.dtype],
        precision=args.precision,
        preprocess=args.preprocess,
        dest_size=args.dest_size,
        decode_backend=args.decode_backend,
        seed=args.seed,
    )


def build_estimator(
    args: argparse.Namespace, config: Optional[Config] = None
) -> PoseEstimator:
    estimator = PoseEstimator(**estimator_kwargs(args, config))
    device = estimator.device
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "host")
    print(f">>>> Using {device} ({name}), {args.dtype}, decode "
          f"{estimator.decode_backend} <<<<")
    return estimator
