"""Offline checkpoint conversion and quantization.

    # any checkpoint -> the port's own .pt (float32)
    python -m torch_ekpose_tpu_torch.cli.export -m vgg2016 -c ckpt.pth \
        -o vgg2016.pt

    # quantize once for int8 serving (then: run_image/serve/eval
    # --dtype int8 -c vgg2016_int8.pt)
    python -m torch_ekpose_tpu_torch.cli.export -m vgg2016 -c ckpt.msgpack \
        --dtype int8 -o vgg2016_int8.pt

    # int8 with static activation scales calibrated on real frames
    # (then: --dtype int8_static; no calibration at serving time)
    python -m torch_ekpose_tpu_torch.cli.export -m vgg2016 -c ckpt.pth \
        --dtype int8_static --calib-images frames/ -o vgg2016_int8s.pt

    # back to the reference's torch state_dict format
    python -m torch_ekpose_tpu_torch.cli.export -m vgg2016 -c ours.pt \
        --to-torch -o theirs.pth

    # an AOT deployment artifact for batch 8 of 368x432 frames on the
    # card (then: cli.serve --aot vgg2016.ekx; runtime/aot.py)
    python -m torch_ekpose_tpu_torch.cli.export -m vgg2016 -c ckpt.pth \
        --aot --dtype bfloat16 --batch 8 --input-size 368x432 \
        -o vgg2016.ekx

Counterpart of the JAX package's ``cli/export.py``. In: a reference
``.pth``/``.pt`` (or the port's own), a ``.ckpt`` of either trainer, or
the JAX package's native ``.msgpack`` (float or int8;
``cli/common.py::load_variables``). Out: the port's own ``.pt``, one
``torch.save`` ``state_dict`` in ``--dtype`` (``bfloat16``: the conv
parameters bf16, as ``models/factory.py::cast_params`` serves them;
``int8``/``int8_static``: ``models/quant.py``'s ``weight_q``, ``scale``,
``bias`` [and ``act_scale``] entries), or with ``--to-torch`` the
reference's float32 ``module.``-prefixed ``state_dict``, or with
``--aot`` a deployment artifact (``runtime/aot.py``: the batched serving
pipeline for one ``--batch`` and ``--input-size``, exported in ``--dtype``
on ``--device`` for that device's platform). Calibration and ``--aot``
run the model on ``--device`` (default ``cuda``); the other conversions
need no device.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import torch

from torch_ekpose_tpu_torch.cli.common import load_variables
from torch_ekpose_tpu_torch.models.factory import (
    MODEL_NAMES, cast_params, get_model)
from torch_ekpose_tpu_torch.models.quant import (
    is_quantized, quantize_variables)

__all__ = ["main"]

DTYPES = ("float32", "bfloat16", "int8", "int8_static")
IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-m", "--model", default="vgg2016",
                        choices=MODEL_NAMES)
    parser.add_argument("-c", "--ckpt", required=True,
                        help="input: .pth/.pt, .ckpt or .msgpack")
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("--dtype", default="float32", choices=DTYPES,
                        help="dtype of the exported weights (int8: "
                        "quantize once for the serving mode; int8_static "
                        "also calibrates static activation scales on "
                        "--calib-images; ignored with --to-torch)")
    parser.add_argument("--calib-images", default=None,
                        help="image file or directory for int8_static "
                        "calibration (representative production frames)")
    parser.add_argument("--dest-size", type=int, default=368,
                        help="inference resolution the calibration frames "
                        "are padded to (match serving)")
    parser.add_argument("--device", default="cuda",
                        help="torch device the calibration (and --aot's "
                        "export) runs on")
    parser.add_argument("--to-torch", action="store_true",
                        help="write the reference's float32 state_dict "
                        "(``module.`` keys) instead of the port's .pt")
    parser.add_argument("--aot", action="store_true",
                        help="write an AOT deployment artifact instead: the "
                        "batched serving pipeline as two torch.export "
                        "programs + metadata, loadable with "
                        "runtime.aot.load_pipeline on the same platform "
                        "(export on the card for the card)")
    parser.add_argument("--batch", type=int, default=1,
                        help="(--aot) batch size baked into the artifact")
    parser.add_argument("--input-size", default=None, metavar="HxW",
                        help="(--aot) fixed input frame size, e.g. "
                        "368x432; default: dest-size square")
    return parser


def _float_state(model_name: str, state) -> Dict[str, torch.Tensor]:
    """The float32 ``state_dict`` of ``model_name`` from a loaded one (a
    bf16 one is widened; the strict load refuses another model's)."""
    model = get_model(model_name, device="cpu")
    model.load_state_dict(state, strict=True)
    return model.state_dict()


def _calibration_frames(path: str, dest_size: int):
    """Padded BGR frames of ``path`` (a file or a directory), as the
    serving path pads them."""
    from torch_ekpose_tpu_torch.evaluate.evaluator import read_image_bgr
    from torch_ekpose_tpu_torch.runtime.estimator import padding

    if os.path.isdir(path):
        paths = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.lower().endswith(IMAGE_SUFFIXES))
    else:
        paths = [path]
    if not paths:
        raise SystemExit(f"no calibration images found under {path!r}")
    print(f"INFO: calibrating static int8 scales on {len(paths)} image(s)")
    return (padding(read_image_bgr(p), dest_size)[0] for p in paths)


def _static(args, state) -> Dict[str, torch.Tensor]:
    """``state`` quantized for the static model, with the act_scales a
    calibrated estimator measured on ``--calib-images``."""
    from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator

    model = get_model(args.model, device="meta", quantize="static")
    state = quantize_variables(state, model)
    est = PoseEstimator(args.model, state, device=args.device,
                        compute_dtype="int8_static",
                        dest_size=args.dest_size)
    est.calibrate(_calibration_frames(args.calib_images, args.dest_size))
    for key, value in est.model.state_dict().items():
        if key.endswith(".act_scale"):
            state[key] = value.cpu()
    return state


def _input_size(args):
    """(H, W) of ``--input-size``, default ``--dest-size`` square."""
    if not args.input_size:
        return args.dest_size, args.dest_size
    try:
        h, w = (int(v) for v in args.input_size.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--input-size must be HxW, got {args.input_size!r}")
    return h, w


def _export_aot(args, state) -> None:
    """Write an AOT deployment artifact (``runtime/aot.py``)."""
    from torch_ekpose_tpu_torch.runtime.aot import export_pipeline
    from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator

    h, w = _input_size(args)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
        args.dtype, args.dtype)
    est = PoseEstimator(args.model, state, device=args.device,
                        compute_dtype=dtype, dest_size=max(h, w))
    if args.dtype == "int8_static":
        est.calibrate(_calibration_frames(args.calib_images, args.dest_size))
    meta = export_pipeline(est, args.output, batch=args.batch, height=h,
                           width=w)
    size = os.path.getsize(args.output)
    print(f"INFO: wrote AOT artifact ({meta['platform']}, batch "
          f"{meta['batch']}, {h}x{w}, {args.dtype}; {size / 1e6:.1f} MB) "
          f"-> {args.output}")


def main(argv=None) -> None:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.dtype == "int8_static" and args.calib_images is None \
            and not args.to_torch:
        parser.error("--dtype int8_static requires --calib-images")
    state = load_variables(args.model, args.ckpt)
    if is_quantized(state):
        if args.to_torch or args.dtype in ("float32", "bfloat16"):
            raise SystemExit(
                f"{args.ckpt} holds int8 weights, which do not convert "
                "back to float; export from a float checkpoint")
    else:
        state = _float_state(args.model, state)

    if args.aot:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)),
                    exist_ok=True)
        _export_aot(args, state)
        return
    if args.to_torch:
        out = {f"module.{k}": v for k, v in state.items()}
        what = "reference-format float32 state_dict"
    elif args.dtype == "bfloat16":
        model = get_model(args.model, device="cpu")
        model.load_state_dict(state, strict=True)
        out = cast_params(model, torch.bfloat16).state_dict()
        what = "bfloat16 state_dict"
    elif args.dtype == "int8":
        out = quantize_variables(
            state, get_model(args.model, device="meta", quantize=True))
        what = "int8 state_dict"
    elif args.dtype == "int8_static":
        out = _static(args, state)
        what = "calibrated int8 state_dict"
    else:
        out, what = state, "float32 state_dict"
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    torch.save({k: v.detach().cpu().contiguous() for k, v in out.items()},
               args.output)
    n_bytes = sum(v.numel() * v.element_size() for v in out.values())
    print(f"INFO: wrote the {what} ({n_bytes / 1e6:.1f} MB) -> "
          f"{args.output}")


if __name__ == "__main__":
    main()
