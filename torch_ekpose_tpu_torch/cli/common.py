"""Shared CLI plumbing of the port: the model flags, checkpoint loading,
``--dtype`` resolution and estimator construction (counterpart of the
JAX package's ``cli/common.py``; reference lib/evaluate/estimator.py:7-42
``get_using_device`` / ``load_ckpt``).

Flags that mean the same thing keep the JAX CLI's names. ``--device``
(default ``cuda``) takes the place of ``--platform``, and ``--seed``
draws the random weights when ``-c`` is absent. ``-c`` reads a
reference ``.pth``/``.pt`` (also the port's own ``cli.export`` output,
float or int8), a ``.ckpt`` of either trainer (the port's torch zip or
the JAX package's flax file) and the JAX package's native ``.msgpack``
(float32, bf16, int8 or calibrated int8, through
``runtime/flax_msgpack.py``; no flax needed). ``--dtype int8`` and
``int8_static`` serve vgg2016's int8 variant (``models/quant.py``); an
int8 checkpoint needs one of them. ``--num-devices N`` (``cli.eval``,
``cli.run_image``; :func:`add_mesh_arg`) spreads the work over N
devices: the first N CUDA devices, or N CPU "devices" under ``--device
cpu`` (one process, as the JAX tests' virtual CPU devices); more than
are visible is an error. ``--s2d-blocks N`` runs vgg2016's first N VGG19
blocks through the weight-exact space-to-depth decomposition
(``ops/s2d_conv.py``; refused with an int8 ``--dtype``, as by the JAX
CLI). The JAX CLI's ``--compilation-cache`` (an XLA cache) is left out,
so argparse refuses it.
"""

from __future__ import annotations

import argparse
import importlib
import os
import zipfile
from typing import Optional

import torch

from torch_ekpose_tpu_torch.config import Config
from torch_ekpose_tpu_torch.decode.api import BACKENDS
from torch_ekpose_tpu_torch.models.factory import MODEL_NAMES
from torch_ekpose_tpu_torch.models.quant import is_quantized
from torch_ekpose_tpu_torch.runtime.checkpoint import (
    load_flax_variables, load_torch_state_dict, state_dict_from_jax)
from torch_ekpose_tpu_torch.runtime.estimator import PRECISIONS, PoseEstimator
from torch_ekpose_tpu_torch.training.trainer import read_checkpoint

__all__ = ["add_mesh_arg", "add_model_args", "build_estimator",
           "build_parallel_estimator", "check_dtype", "estimator_kwargs",
           "load_variables", "require", "resolve_dtype"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": "int8", "int8_static": "int8_static"}


def add_model_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-m", "--model", default="vgg2016",
                        choices=MODEL_NAMES, help="model name")
    parser.add_argument("-c", "--ckpt", default=None,
                        help="checkpoint: reference-format .pth/.pt "
                        "(``module.`` prefixes are stripped; also the "
                        "port's cli.export output), a .ckpt of the port's "
                        "or the JAX package's cli.train, or the JAX "
                        "package's native .msgpack")
    parser.add_argument("--preprocess", default="vgg",
                        choices=["vgg", "rtpose"])
    parser.add_argument("--decode-backend", default="auto", choices=BACKENDS,
                        help="host decode of one image's maps: 'native' "
                        "(C++), 'numpy', 'auto' (native, else numpy); "
                        "'device' (alias 'jax') decodes on the card")
    parser.add_argument("--dtype", default=None, choices=sorted(_DTYPES),
                        help="forward compute dtype (default bfloat16, or "
                        "float32 under --precision highest); int8 = vgg2016 "
                        "with int8 weights and dynamic activation scales, "
                        "bf16 elsewhere; int8_static = calibrated static "
                        "scales (on the first frame served unless the "
                        "checkpoint was exported with cli.export --dtype "
                        "int8_static)")
    parser.add_argument("--precision", default="fast", choices=PRECISIONS,
                        help="'highest' turns TF32 off in the forward and "
                        "implies --dtype float32 unless it is set")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (the reference's "
                        "--device flag; the JAX CLI's --platform)")
    parser.add_argument("--s2d-blocks", type=int, default=0,
                        choices=[0, 1, 2, 3],
                        help="run the first N VGG19 blocks through the "
                        "weight-exact space-to-depth decomposition (vgg "
                        "family; the same checkpoint; ops/s2d_conv.py)")
    parser.add_argument("--dest-size", type=int, default=368,
                        help="inference resolution: the long image side is "
                        "resized to this before padding")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights when -c is absent")


def load_variables(model_name: str, ckpt: Optional[str]):
    """The ``state_dict`` of ``ckpt`` (a reference ``.pth``/``.pt``,
    without the parameters the reference builds for ``model_name`` but
    never uses; the model of a ``.ckpt`` either trainer wrote; or a JAX
    ``.msgpack``, float or int8), or None, which makes
    :class:`PoseEstimator` draw random weights from ``--seed``. A missing
    file, another suffix, or a flax file that is not ``model_name``'s
    exits with the reason."""
    if ckpt is None:
        print("WARNING: no checkpoint given; using random initialization")
        return None
    if not os.path.exists(ckpt):
        raise SystemExit(f"cannot load {ckpt}: no such file")
    if ckpt.endswith(".ckpt") and zipfile.is_zipfile(ckpt):
        print(f"INFO: loading the port trainer's checkpoint {ckpt} for "
              f"{model_name}")
        return read_checkpoint(ckpt)["model"]
    if ckpt.endswith((".ckpt", ".msgpack")):
        kind = "trainer" if ckpt.endswith(".ckpt") else "native"
        print(f"INFO: reading the JAX package's {kind} checkpoint {ckpt} "
              f"for {model_name}")
        try:
            if kind == "native":
                return load_flax_variables(ckpt, model_name)
            return state_dict_from_jax(read_checkpoint(ckpt), model_name)
        except (KeyError, TypeError, ValueError) as err:
            raise SystemExit(
                f"cannot load {ckpt}: not a {model_name} checkpoint of the "
                f"JAX package ({type(err).__name__}: {err})") from None
    if not ckpt.endswith((".pth", ".pt")):
        raise SystemExit(
            f"cannot load {ckpt}: the port reads .pth/.pt, .ckpt and "
            ".msgpack checkpoints")
    print(f"INFO: loading reference checkpoint {ckpt} for {model_name}")
    return load_torch_state_dict(ckpt, model_name)


def check_dtype(state_dict, dtype: str) -> None:
    """An int8 ``state_dict`` serves in the int8 modes only."""
    if state_dict is not None and dtype not in ("int8", "int8_static") \
            and is_quantized(state_dict):
        raise SystemExit(
            f"the checkpoint holds int8 weights: serve it with --dtype "
            f"int8 or int8_static, not {dtype}")


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
    state_dict = load_variables(args.model, args.ckpt)
    check_dtype(state_dict, args.dtype)
    return dict(
        model_name=args.model,
        state_dict=state_dict,
        config=config,
        device=args.device,
        compute_dtype=_DTYPES[args.dtype],
        precision=args.precision,
        preprocess=args.preprocess,
        dest_size=args.dest_size,
        decode_backend=args.decode_backend,
        s2d_blocks=args.s2d_blocks,
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


def add_mesh_arg(parser: argparse.ArgumentParser, what: str) -> None:
    parser.add_argument("--num-devices", type=int, default=0,
                        help=f"{what} over N devices (0 or 1: one device): "
                        "the first N CUDA devices, or N CPU devices under "
                        "--device cpu")


def build_parallel_estimator(args: argparse.Namespace, kind: str):
    """A ``ShardedPoseEstimator`` (``kind="sharded"``) or a
    ``SpatialPoseEstimator`` (``"spatial"``) over ``--num-devices``
    devices, with :func:`estimator_kwargs`' model and dtype."""
    from torch_ekpose_tpu_torch.parallel import (
        ShardedPoseEstimator, SpatialPoseEstimator, make_mesh)

    device = torch.device(args.device)
    devices = ([device] * args.num_devices if device.type != "cuda"
               else None)
    try:
        mesh = make_mesh(args.num_devices, devices=devices)
    except (RuntimeError, ValueError) as err:
        raise SystemExit(f"--num-devices {args.num_devices}: {err}") from None
    kwargs = estimator_kwargs(args)
    for key in ("device", "decode_backend"):
        kwargs.pop(key)
    cls = {"sharded": ShardedPoseEstimator,
           "spatial": SpatialPoseEstimator}[kind]
    estimator = cls(mesh=mesh, **kwargs)
    print(f">>>> Using {mesh.size} devices ({kind}: "
          f"{[str(d) for d in mesh.flat]}), {args.dtype}, decode on "
          f"{mesh.flat[0]} <<<<")
    return estimator
