"""COCO keypoint training (reference train.py).

    python -m torch_ekpose_tpu_torch.cli.train -m vgg2016 -d coco -b 16 \
        -e 100 --data-dir ./data/ --targets device

Counterpart of the JAX package's ``cli/train.py``: the same flags and
defaults, with ``--device`` (default ``cuda``) in place of the platform
choice. ``--targets device`` rasterizes the heatmap/PAF targets on the
card inside the train step; ``--targets host`` rasterizes them in the
loader's workers, as the reference does; ``--targets raw`` has the loader
only decode (and place on a 432-pixel canvas) and runs the whole
augmentation on the card (``data/device_aug.py``), and ``--raw-cache
PREFIX`` replaces even the decode by memory-mapped arrays
(``data/raw_cache.py``), built on the first run.

Data parallelism is one process per device over ``torch.distributed``
(NCCL on cards, gloo under ``--device cpu``): ``--num-devices N`` (0: every
visible card) or ``--gpus IDS`` (those cards) starts N processes on this
host over a local rendezvous, or N / K with ``--spatial K``, each
splitting its images' height over K devices; each loads its shard of the
dataset at ``--batch_size / processes``. More devices than are visible
is an error. ``--coordinator host:port --num-processes P --process-id
I`` makes this process rank I of a P-process run across hosts, on its
``--gpus`` or on row ``I`` (modulo the rows) of the visible cards in
groups of K. ``--zero1`` shards Adam's moments
over the ranks. Rank 0 decides a resume, builds the raw cache while the
others wait for it (as long as it makes progress) and writes every file.
``--raw-cache`` without ``--targets raw`` is refused, and
``--compilation-cache`` (a JAX flag) is unknown to argparse.
"""

from __future__ import annotations

import argparse
import datetime
import glob
import json
import os
import socket
import sys
import time
from typing import Optional

import torch
import torch.distributed as dist

from torch_ekpose_tpu_torch.cli import common
from torch_ekpose_tpu_torch.config import get_default_config
from torch_ekpose_tpu_torch.data import transforms as T
from torch_ekpose_tpu_torch.data.dataset import BatchLoader, CocoKeypoints
from torch_ekpose_tpu_torch.data.raw_cache import (
    RawArrayDataset, build_raw_cache, cache_exists)
from torch_ekpose_tpu_torch.models.factory import MODEL_NAMES, init_model
from torch_ekpose_tpu_torch.parallel.mesh import (
    broadcast_flag, init_distributed, process_count, process_index,
    rank_devices)
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
                        help="data-parallel devices, one process each "
                        "(0: every visible card; one under --device cpu, "
                        "where N starts N CPU processes over gloo)")
    parser.add_argument(
        "--gpus", type=str, default=None, metavar="IDS",
        help="comma-separated CUDA ids to train on (reference "
        "train.py:38): rank r takes the r-th id, or the r-th K ids "
        "under --spatial K; with --coordinator, this process's K ids",
    )
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="micro-batches per optimizer step (fits the "
                        "reference's batch-128 recipe on one card)")
    parser.add_argument("--zero1", action="store_true",
                        help="shard Adam's moments across the ranks "
                        "(ZeRO-1): cuts optimizer memory by the rank "
                        "count, the same numerics")
    parser.add_argument("--spatial", type=int, default=1, metavar="K",
                        help="split each image's height over K devices "
                        "per process (halo rows exchanged at every conv): "
                        "a step spans more devices than its batch, or a "
                        "resolution one card cannot hold")
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
                        help="multi-host: rank 0's host:port; this process "
                        "is rank --process-id of --num-processes, one per "
                        "device (or per --spatial group)")
    parser.add_argument("--num-processes", type=int, default=1)
    parser.add_argument("--process-id", type=int, default=0)
    return parser


def check_flags(args) -> int:
    """Validate the device and batch flags before anything loads, as the
    JAX CLI does; returns the number of processes to start on this host
    (1 with ``--coordinator``: the others start elsewhere)."""
    if args.raw_cache and args.targets != "raw":
        raise SystemExit("--raw-cache holds the decoded images of "
                         "--targets raw; add --targets raw or drop it")
    cuda = torch.device(args.device).type == "cuda"
    if args.gpus and not cuda:
        raise SystemExit(f"--gpus {args.gpus} names CUDA devices: not with "
                         f"--device {args.device}")
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: training runs on the card "
                           "unless the caller asks for the CPU (--device "
                           "cpu)")
    visible = torch.cuda.device_count() if cuda else None
    args.gpu_ids = _gpu_ids(args.gpus, visible) if args.gpus else None
    if args.gpu_ids and not args.coordinator:
        n = len(args.gpu_ids)
        if args.num_devices and args.num_devices != n:
            raise SystemExit(
                f"--gpus lists {n} ids but --num-devices={args.num_devices}")
        args.num_devices = n
    if args.coordinator:
        if args.gpu_ids and len(args.gpu_ids) != args.spatial:
            raise SystemExit(
                f"--gpus {args.gpus}: with --coordinator it names this "
                f"process's --spatial {args.spatial} card(s)")
        if args.num_devices > 1:
            raise SystemExit(
                "--coordinator runs one process per device (or --spatial "
                "group): start one per device with its own --process-id "
                "instead of --num-devices")
        if not 0 <= args.process_id < args.num_processes:
            raise SystemExit(f"--process-id {args.process_id} is not a "
                             f"rank of --num-processes {args.num_processes}")
        n_dev = args.num_processes * args.spatial
        local = args.spatial
    else:
        if args.num_processes > 1 or args.process_id:
            raise SystemExit("--num-processes / --process-id take "
                             "--coordinator (rank 0's host:port)")
        n_dev = args.num_devices or (visible if cuda else 1)
        local = n_dev
    if visible is not None and local > visible:
        raise SystemExit(
            f"{local} CUDA devices asked for on this host, {visible} "
            "visible")
    if args.spatial < 1 or n_dev % args.spatial:
        raise SystemExit(f"--spatial {args.spatial} must divide the "
                         f"{n_dev}-device run")
    if args.spatial > 1:
        stride = get_default_config().MODEL.DOWNSAMPLE
        if args.square_size % args.spatial:
            raise SystemExit(
                f"--spatial {args.spatial} must divide --square_size "
                f"{args.square_size}: images split along their height")
        if args.targets == "host" and (args.square_size // stride) \
                % args.spatial:
            raise SystemExit(
                f"--spatial {args.spatial} must divide the "
                f"{args.square_size // stride}-row target grids "
                f"(--square_size {args.square_size} / stride {stride}) "
                "under --targets host; use --targets device or a spatial "
                f"factor dividing {args.square_size // stride}")
    dp = n_dev // args.spatial
    if args.batch_size % dp:
        raise SystemExit(
            f"--batch_size {args.batch_size} must divide evenly across "
            f"the {dp} data-parallel ranks of the {n_dev}-device run")
    args.world = dp
    return 1 if args.coordinator else dp


def _gpu_ids(text: str, visible: int) -> list:
    """``--gpus``' ids: distinct, each a visible CUDA device."""
    try:
        ids = [int(g) for g in text.split(",") if g.strip() != ""]
    except ValueError:
        raise SystemExit(f"--gpus {text}: comma-separated CUDA ids") \
            from None
    if not ids or len(set(ids)) != len(ids) or not all(
            0 <= i < visible for i in ids):
        raise SystemExit(f"--gpus {text}: distinct ids of the {visible} "
                         f"visible CUDA devices (0..{visible - 1})")
    return ids


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _devices(args, rank: int) -> tuple:
    """Rank ``rank``'s devices, its row of ``parallel.rank_devices``: the
    ``--spatial`` cards (of ``--gpus``, else of every visible card) or
    CPU devices its images' height splits over. The process group, the
    parameters and the ``Trainer`` all take them from here."""
    device = torch.device(args.device)
    if device.type != "cuda":
        return rank_devices(rank, args.spatial, [device] * args.spatial)
    ids = args.gpu_ids
    return rank_devices(rank, args.spatial, None if ids is None else [
        torch.device("cuda", i) for i in ids])


def _join(args, address: str, world: int, rank: int) -> None:
    """Join the run's process group as ``rank``; under NCCL on the first
    card of :func:`_devices`, where every collective of the rank runs."""
    cuda = torch.device(args.device).type == "cuda"
    init_distributed(
        address, world, rank,
        local_device_ids=([d.index for d in _devices(args, rank)] if cuda
                          else None),
        backend="nccl" if cuda else "gloo")


#: seconds without one more decoded image after which a rank waiting for
#: rank 0's raw cache gives up (the wait has no fixed length: a growing
#: cache is waited for however long it takes)
RAW_CACHE_STALL_S = 600.0


class _Counted:
    """A dataset whose reads are counted into ``<prefix>_progress.json``
    (every 2 s), which the ranks waiting for the cache watch."""

    def __init__(self, dataset, path: str):
        self.dataset, self.path = dataset, path
        self.done, self._written = 0, 0.0

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        item = self.dataset[index]
        self.done += 1
        if time.monotonic() - self._written > 2.0:
            self.write()
        return item

    def write(self, failed: Optional[str] = None) -> None:
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            json.dump({"done": self.done, "n": len(self.dataset),
                       "failed": failed}, f)
        os.replace(tmp, self.path)
        self._written = time.monotonic()


def build_cache_watched(dataset, prefix: str) -> None:
    """Rank 0's raw-cache build, its progress written beside it; a
    failure is written there too before it propagates."""
    counted = _Counted(dataset, f"{prefix}_progress.json")
    counted.write()
    try:
        build_raw_cache(counted, prefix, progress=True)
    except BaseException as err:
        counted.write(failed=f"{type(err).__name__}: {err}")
        raise
    os.remove(counted.path)


def wait_for_cache(prefix: str, poll: float = 2.0) -> None:
    """Wait for rank 0's raw cache: end when it is complete, or exit when
    rank 0 reports a failure or the count of decoded images has not
    moved for :data:`RAW_CACHE_STALL_S` seconds."""
    path = f"{prefix}_progress.json"
    seen, since = None, time.monotonic()
    while not cache_exists(prefix):
        try:
            with open(path) as f:
                state = json.load(f)
        except (OSError, json.JSONDecodeError):
            state = None
        if state and state.get("failed"):
            raise SystemExit(f"rank 0 failed to build the raw cache "
                             f"{prefix!r}: {state['failed']}")
        done = state and state.get("done")
        if done != seen:
            seen, since = done, time.monotonic()
        elif time.monotonic() - since > RAW_CACHE_STALL_S:
            raise SystemExit(
                f"rank {process_index()}: the raw cache {prefix!r} made no "
                f"progress for {RAW_CACHE_STALL_S:.0f} s ({seen} images "
                "decoded); rank 0 (the builder) is stuck or dead: check its "
                "log, delete any partial cache files, and restart")
        time.sleep(poll)


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
    """Parse ``argv`` and train; returns rank 0's ``Trainer`` (None when
    a warmup was preempted). In a local multi-process run this process is
    rank 0 and the other ranks are spawned."""
    args = _parser().parse_args(argv)
    local = check_flags(args)

    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    log_dir = os.path.join(args.logdir, stamp)
    os.makedirs(log_dir, exist_ok=True)
    if local > 1:
        return _run_local(args, log_dir, local)
    rank = args.process_id if args.coordinator else 0
    join = bool(args.coordinator) or (args.zero1
                                      and not dist.is_initialized())
    if args.coordinator:
        _join(args, args.coordinator, args.num_processes, rank)
    elif join:
        # ZeRO-1 needs a process group, even of one rank
        _join(args, f"localhost:{_free_port()}", 1, 0)
    return _run(args, log_dir, rank, leave=join)


def _cpu_threads(args) -> int:
    """Torch threads for one of ``args.world`` CPU ranks on this host
    (``OMP_NUM_THREADS`` wins): every rank at torch's default of every
    core makes gloo's collectives crawl."""
    if "OMP_NUM_THREADS" in os.environ:
        return torch.get_num_threads()
    return max(1, len(os.sched_getaffinity(0)) // args.world)


def _run_local(args, log_dir: str, world: int) -> Optional[Trainer]:
    """Ranks 1.. spawned, rank 0 here; a rank that fails ends them all."""
    import torch.multiprocessing as mp

    port = _free_port()
    others = mp.start_processes(_rank_main, args=(args, log_dir, port),
                                nprocs=world - 1, start_method="spawn",
                                join=False)
    threads = torch.get_num_threads()
    try:
        if torch.device(args.device).type != "cuda":
            torch.set_num_threads(_cpu_threads(args))
        _join(args, f"localhost:{port}", world, 0)
        trainer = _run(args, log_dir, 0, leave=True)
    except BaseException:
        for process in others.processes:
            if process.is_alive():
                process.terminate()
        raise
    finally:
        torch.set_num_threads(threads)
    while not others.join():
        pass
    return trainer


def _rank_main(index: int, args, log_dir: str, port: int) -> None:
    """Rank ``index + 1`` of a local multi-process run (spawned)."""
    if torch.device(args.device).type != "cuda":
        torch.set_num_threads(_cpu_threads(args))
    _join(args, f"localhost:{port}", args.world, index + 1)
    _run(args, log_dir, index + 1, leave=True)


def _run(args, log_dir: str, rank: int, leave: bool) -> Optional[Trainer]:
    """Train as rank ``rank``; rank 0 logs to ``<log_dir>/logging.log``.
    ``leave``: the process group this run joined is left at the end."""
    main_rank = rank == 0
    if main_rank:
        sys.stdout = Logger(os.path.join(log_dir, "logging.log"))
    try:
        return _train(args, log_dir, rank)
    finally:
        if main_rank:
            sys.stdout.close()
        if leave:
            dist.destroy_process_group()


def _train(args, log_dir: str, rank: int = 0) -> Optional[Trainer]:
    world = process_count()
    devices = _devices(args, rank)
    device = devices[0]
    if rank == 0:
        print("command line:", " ".join(sys.argv))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "host")
    extra = "".join([f", rank {rank} of {world}" if world > 1 else "",
                     f", spatial x{args.spatial}" if args.spatial > 1
                     else "", ", ZeRO-1" if args.zero1 else ""])
    print(f">>>> Training on {device} ({name}), {args.dtype}{extra} <<<<")
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
                if rank == 0:
                    print(f"INFO: building the raw cache {args.raw_cache} "
                          f"({len(ds)} images)")
                    build_cache_watched(ds, args.raw_cache)
                else:
                    wait_for_cache(args.raw_cache)
            ds = RawArrayDataset(args.raw_cache)
        # each rank loads its strided shard at its slice of the batch
        return BatchLoader(
            ds, args.batch_size // world, shuffle=train,
            num_workers=args.workers, drop_last=train,
            mode=args.loader_mode, shard=(rank, world),
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
    # one decision, rank 0's view (shared storage can lag behind its
    # write), reused by the warmup skip and the resume below
    resume_preempt = broadcast_flag(os.path.exists(preempt_ckpt))
    if resume_preempt and not os.path.exists(preempt_ckpt):
        raise SystemExit(
            f"{preempt_ckpt} exists on rank 0 but not here: a multi-host "
            "resume needs the checkpoint directory on shared storage")
    will_restore = resume_explicit or resume_preempt

    train_loader = make_loader("train", True)
    val_loader = make_loader("val", False)
    try:
        options = dict(
            config=cfg, log_dir=log_dir, targets=args.targets,
            device=devices, compute_dtype=compute_dtype,
            grad_accum=args.grad_accum, remat=args.remat, zero1=args.zero1,
        )
        verbose = rank == 0
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
                save_epoch=0, verbose=verbose,
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
            if world > 1:
                dist.barrier()          # nobody deletes before all restored
            if rank == 0:
                os.remove(preempt_ckpt)
            print(f"INFO: auto-resumed from {preempt_ckpt} "
                  f"at epoch {trainer.epoch} (checkpoint consumed)")
        elif resume_explicit:
            trainer.restore(args.pretrained_path)
            print(f"INFO: resumed from {args.pretrained_path} "
                  f"at epoch {trainer.epoch}")
        trainer.fit(train_loader, val_loader, epochs=args.epochs,
                    verbose=verbose)
        trainer.metrics.close()
        return trainer
    finally:
        train_loader.close()
        val_loader.close()


if __name__ == "__main__":
    main()
