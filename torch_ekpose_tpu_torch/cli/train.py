"""COCO keypoint training on one GPU (reference train.py).

    python -m torch_ekpose_tpu_torch.cli.train -m vgg2016 -d coco -b 16 \
        -e 100 --data-dir ./data/ --targets device

Counterpart of the JAX package's ``cli/train.py`` for one process on one
card: the same flags and defaults, with ``--device`` (default ``cuda``)
in place of the platform choice. ``--targets device`` rasterizes the
heatmap/PAF targets on the card inside the train step; ``--targets host``
rasterizes them in the loader's workers, as the reference does;
``--targets raw`` has the loader only decode (and place on a 432-pixel
canvas) and runs the whole augmentation on the card
(``data/device_aug.py``), and ``--raw-cache PREFIX`` replaces even the
decode by memory-mapped arrays (``data/raw_cache.py``), built on the
first run (this one process builds it; there is no other to wait for).

Refused, each naming the ROADMAP item that ports it: ``--zero1``,
``--spatial`` above 1, ``--coordinator``, ``--num-processes`` above 1 and
``--num-devices`` / ``--gpus`` above one device (item 7, with the
multi-process wait for the raw cache); ``--raw-cache`` without
``--targets raw``. ``--compilation-cache`` (a JAX
flag) and ``--process-id`` (a multi-host rank) have no meaning here, so
argparse refuses them.
"""

from __future__ import annotations

import argparse
import datetime
import glob
import os
import sys
from typing import Optional

import torch

from torch_ekpose_tpu_torch.cli import common
from torch_ekpose_tpu_torch.config import get_default_config
from torch_ekpose_tpu_torch.data import transforms as T
from torch_ekpose_tpu_torch.data.dataset import BatchLoader, CocoKeypoints
from torch_ekpose_tpu_torch.data.raw_cache import (
    RawArrayDataset, build_raw_cache, cache_exists)
from torch_ekpose_tpu_torch.models.factory import MODEL_NAMES, init_model
from torch_ekpose_tpu_torch.runtime.checkpoint import import_imagenet_vgg19
from torch_ekpose_tpu_torch.training import Logger, Trainer


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-m", "--model", type=str, default="vgg2016",
                        choices=MODEL_NAMES)
    parser.add_argument("-d", "--datasets", type=str, required=True)
    parser.add_argument("--data-dir", type=str, default="./data/")
    # defaults match the reference CLI (train.py:36-37)
    parser.add_argument("-b", "--batch_size", type=int, default=16)
    parser.add_argument("-e", "--epochs", type=int, default=100)
    parser.add_argument("-l", "--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=5e-4)
    parser.add_argument("--square_size", type=int, default=368)
    parser.add_argument("--save_epoch", type=int, default=20)
    parser.add_argument(
        "--workers", "--loader_workers", type=int, default=8,
        help="loader worker count (the reference's --loader_workers)",
    )
    parser.add_argument(
        "--training_curve", action="store_true",
        help="accepted for reference CLI compatibility; the curve PNG "
        "is always saved here (reference train.py:44 gates it)",
    )
    parser.add_argument(
        "--loader-mode", type=str, default="process",
        choices=["process", "thread"],
        help="loader workers: spawned processes (like the reference's "
        "DataLoader; the host pipeline is GIL-bound under threads) or "
        "threads (lighter, fine for small runs)",
    )
    parser.add_argument("--n-images", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (the reference's "
                        "--device; the JAX CLI's platform choice)")
    parser.add_argument("--num-devices", type=int, default=0,
                        help="devices to train on: one here (more is "
                        "ROADMAP Queue 1 item 7)")
    parser.add_argument(
        "--gpus", type=str, default=None, metavar="IDS",
        help="reference-compatibility alias (train.py:38 takes "
        "comma-separated CUDA ids): the COUNT of ids becomes "
        "--num-devices",
    )
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="micro-batches per optimizer step (fits the "
                        "reference's batch-128 recipe on one card)")
    parser.add_argument("--zero1", action="store_true",
                        help="shard Adam moments across devices "
                        "(ROADMAP Queue 1 item 7; refused here)")
    parser.add_argument("--spatial", type=int, default=1, metavar="K",
                        help="shard the image height over K devices "
                        "(ROADMAP Queue 1 item 7; only 1 here)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute backbone + CPM-branch activations "
                        "in the backward pass (torch.utils.checkpoint): "
                        "the same gradients, activation memory traded "
                        "for ~one extra forward")
    parser.add_argument("--targets", type=str, default="device",
                        choices=["device", "host", "raw"],
                        help="host: reference-shaped host pipeline; "
                        "device: targets rasterized on the card; raw: "
                        "the loader only decodes, the whole augmentation "
                        "runs on the card")
    parser.add_argument("--raw-cache", type=str, default=None,
                        metavar="PREFIX",
                        help="with --targets raw: memory-mapped decoded "
                        "training images at PREFIX_*.npy (built on the "
                        "first run), so an epoch decodes nothing")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="activation/compute dtype for the train step; "
                        "bfloat16 runs the convs at the tensor cores' "
                        "bf16 rate while params, optimizer moments, and "
                        "the loss stay float32")
    parser.add_argument("--pretrained_path", type=str, default=None,
                        help="resume checkpoint (.ckpt of this trainer) "
                        "or reference .pth")
    parser.add_argument(
        "--imagenet_pretrained", type=str, default=None, nargs="?",
        const="auto", metavar="VGG19_PTH",
        help="initialize the vgg2016 backbone from a torchvision "
        "ImageNet VGG19 classifier checkpoint (reference train.py:48 / "
        "vgg2016.py:137-143; implies a 5-epoch frozen-backbone warmup "
        "unless --warmup_epochs is given). With no value, looks in "
        "torchvision's cache (~/.cache/torch/hub/checkpoints/)",
    )
    parser.add_argument("--warmup_epochs", type=int, default=None,
                        help="frozen-backbone warmup epochs "
                        "(reference train.py:130-166; default 5 with "
                        "--imagenet_pretrained, else 0)")
    parser.add_argument("--logdir", type=str, default="./logs/")
    parser.add_argument("--out-dir", type=str, default="./checkpoints/")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="multi-host coordinator (ROADMAP Queue 1 "
                        "item 7; refused here)")
    parser.add_argument("--num-processes", type=int, default=1)
    return parser


def refuse_unported(args) -> None:
    """Exit on a flag whose path is not ported, naming its ROADMAP item,
    and on ``--raw-cache`` without ``--targets raw``."""
    n_dev = args.num_devices
    if args.gpus:
        n_dev = len([g for g in args.gpus.split(",") if g.strip() != ""])
    multi = {
        "--zero1": args.zero1,
        f"--spatial {args.spatial}": args.spatial > 1,
        "--coordinator": args.coordinator is not None,
        f"--num-processes {args.num_processes}": args.num_processes > 1,
        f"--num-devices/--gpus ({n_dev} devices)": n_dev > 1,
    }
    for flag, used in multi.items():
        if used:
            raise SystemExit(
                f"{flag}: multi-device and multi-host training is not "
                "ported yet (ROADMAP Queue 1 item 7); this trainer runs "
                "on one device")
    if args.raw_cache and args.targets != "raw":
        raise SystemExit("--raw-cache holds the decoded images of "
                         "--targets raw; add --targets raw or drop it")


def imagenet_state(args) -> dict:
    """vgg2016's seeded initialization with the backbone's first ten convs
    from a torchvision VGG19 checkpoint (``--imagenet_pretrained``)."""
    if args.model != "vgg2016":
        raise SystemExit(
            "--imagenet_pretrained applies to vgg2016 only (the "
            "reference's flag likewise feeds vgg2016.load_model)"
        )
    path = args.imagenet_pretrained
    if path == "auto":
        hits = sorted(glob.glob(os.path.expanduser(
            "~/.cache/torch/hub/checkpoints/vgg19-*.pth"
        )))
        if not hits:
            raise SystemExit(
                "--imagenet_pretrained: no vgg19-*.pth in "
                "~/.cache/torch/hub/checkpoints/ (pass an explicit path)"
            )
        path = hits[-1]
    cfg = get_default_config()
    model = init_model(
        args.model, generator=torch.Generator().manual_seed(cfg.TRAIN.seed),
        device="cpu")
    state = import_imagenet_vgg19(path, model.state_dict())
    print(f"INFO: backbone initialized from imagenet VGG19 ({path})")
    return state


def main(argv=None) -> Optional[Trainer]:
    """Parse ``argv`` and train; returns the main run's ``Trainer`` (None
    when a warmup was preempted)."""
    args = _parser().parse_args(argv)
    refuse_unported(args)

    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    log_dir = os.path.join(args.logdir, stamp)
    os.makedirs(log_dir, exist_ok=True)
    sys.stdout = Logger(os.path.join(log_dir, "logging.log"))
    try:
        return _train(args, log_dir)
    finally:
        sys.stdout.close()


def _train(args, log_dir: str) -> Optional[Trainer]:
    print("command line:", " ".join(sys.argv))
    device = torch.device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            and torch.cuda.is_available() else "host")
    print(f">>>> Training on {device} ({name}), {args.dtype} <<<<")
    cfg = get_default_config()
    cfg.TRAIN.batch_size = args.batch_size
    cfg.TRAIN.epochs = args.epochs
    cfg.TRAIN.lr = args.lr
    cfg.TRAIN.weight_decay = args.weight_decay
    cfg.TRAIN.square_size = args.square_size
    cfg.TRAIN.save_epoch = args.save_epoch

    def make_loader(mode: str, train: bool):
        root = os.path.join(args.data_dir, args.datasets, "images", mode)
        anno = os.path.join(
            args.data_dir, args.datasets, f"annotations_{mode}.json"
        )
        # raw mode: the TRAIN loader serves decode-only uint8 canvases
        # (the train step augments them on the card); validation never
        # augments, so its loader serves device-target items
        raw_train = args.targets == "raw" and train
        ds = CocoKeypoints(
            root, anno,
            preprocess=T.TRAIN_PREPROCESS(args.square_size),
            image_transform=(
                T.image_transform_train if train else T.image_transform
            ),
            target_mode="raw" if raw_train else (
                "device" if args.targets == "raw" else args.targets),
            input_size=args.square_size,
            n_images=args.n_images,
        )
        if raw_train and args.raw_cache:
            if not cache_exists(args.raw_cache):
                # the meta file lands last: a cut build is rebuilt
                print(f"INFO: building the raw cache {args.raw_cache} "
                      f"({len(ds)} images)")
                build_raw_cache(ds, args.raw_cache, progress=True)
            ds = RawArrayDataset(args.raw_cache)
        return BatchLoader(
            ds, args.batch_size, shuffle=train,
            num_workers=args.workers, drop_last=train,
            mode=args.loader_mode,
        )

    compute_dtype = (
        torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    )
    if args.warmup_epochs is None:
        # the reference runs a 5-epoch frozen-backbone warmup whenever it
        # starts from imagenet weights (train.py:130-166)
        args.warmup_epochs = 5 if args.imagenet_pretrained else 0

    state_dict = None
    if args.pretrained_path and args.pretrained_path.endswith(
        (".pth", ".pt")
    ):
        state_dict = common.load_variables(args.model, args.pretrained_path)
    if args.imagenet_pretrained:
        if state_dict is not None:
            raise SystemExit(
                "--imagenet_pretrained conflicts with a .pth "
                "--pretrained_path (both would set the backbone)"
            )
        state_dict = imagenet_state(args)

    # Resume decisions are made up front: when the main run will restore
    # a full-state checkpoint (an explicit *.ckpt or an auto-resume
    # preempt.ckpt), a warmup would only produce parameters that
    # restore() immediately discards.
    preempt_ckpt = os.path.join(args.out_dir, "preempt.ckpt")
    resume_explicit = bool(
        args.pretrained_path and args.pretrained_path.endswith(".ckpt")
    )
    resume_preempt = os.path.exists(preempt_ckpt)
    will_restore = resume_explicit or resume_preempt

    train_loader = make_loader("train", True)
    val_loader = make_loader("val", False)
    try:
        options = dict(
            config=cfg, log_dir=log_dir, targets=args.targets,
            device=args.device, compute_dtype=compute_dtype,
            grad_accum=args.grad_accum, remat=args.remat,
        )
        if args.warmup_epochs and will_restore:
            print(
                "INFO: skipping warmup: the main run restores a "
                "full-state checkpoint that would overwrite its result"
            )
        if args.warmup_epochs and not will_restore:
            print(f"INFO: {args.warmup_epochs}-epoch frozen-backbone "
                  "warmup")
            # own out_dir: the warmup optimizer holds only the head's
            # parameters, so its preempt.ckpt must never be picked up by
            # the main trainer's auto-resume
            warmup = Trainer(
                args.model, state_dict=state_dict,
                out_dir=os.path.join(args.out_dir, "warmup"),
                freeze_backbone=True, **options,
            )
            warmup.fit(
                train_loader, val_loader, epochs=args.warmup_epochs,
                save_epoch=0,
            )
            warmup.metrics.close()
            if warmup.preempted:
                print("INFO: preempted during warmup; exiting")
                return None
            state_dict = warmup.model.state_dict()

        trainer = Trainer(args.model, state_dict=state_dict,
                          out_dir=args.out_dir, **options)
        if resume_preempt:
            # A preemption checkpoint from a killed run: pick up where it
            # left off (the interrupted epoch re-runs in full). It wins
            # even over an explicit --pretrained_path *.ckpt: it is newer
            # state of THIS out_dir. Consumed on restore, so a later run
            # in this out_dir does not resume from stale state.
            if resume_explicit:
                print(f"WARNING: {preempt_ckpt} supersedes "
                      f"--pretrained_path {args.pretrained_path} (it is "
                      "newer state of this out_dir); delete the file to "
                      "restart from the explicit checkpoint instead")
            trainer.restore(preempt_ckpt)
            os.remove(preempt_ckpt)
            print(f"INFO: auto-resumed from {preempt_ckpt} "
                  f"at epoch {trainer.epoch} (checkpoint consumed)")
        elif resume_explicit:
            trainer.restore(args.pretrained_path)
            print(f"INFO: resumed from {args.pretrained_path} "
                  f"at epoch {trainer.epoch}")
        trainer.fit(train_loader, val_loader, epochs=args.epochs)
        trainer.metrics.close()
        return trainer
    finally:
        train_loader.close()
        val_loader.close()


if __name__ == "__main__":
    main()
