"""The port's parallel command lines on the CPU: ``cli.train --device
cpu --num-devices 4 --spatial 2 --zero1`` (two data-parallel gloo ranks,
this process rank 0 and one spawned, each splitting its images' height
over two CPU devices), ``cli.eval --num-devices 2``
(``ShardedPoseEstimator`` over two CPU devices) and ``cli.run_image
--num-devices 2`` (``SpatialPoseEstimator``). Their numerics are held by
``tests/test_torch_parallel{,_train}.py`` and
``tests/test_torch_spatial.py``; here the flags reach them.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu_torch.cli import eval as cli_eval  # noqa: E402
from torch_ekpose_tpu_torch.cli import run_image  # noqa: E402
from torch_ekpose_tpu_torch.cli import train as cli_train  # noqa: E402
from torch_ekpose_tpu_torch.data.synthetic_coco import (  # noqa: E402
    write_coco_dataset)

torch.set_num_threads(2)  # xdist already runs one process per core

CPU = ["--device", "cpu", "--dtype", "float32", "--dest-size", "64"]


def test_cli_train_two_ranks_zero1_on_the_cpu(tmp_path, monkeypatch):
    """``--num-devices 4 --spatial 2 --zero1``: two ranks, each loading
    half the global batch and splitting it over two stripes; rank 0 (this
    process) returns its trainer and alone writes the log, the metrics
    and a checkpoint whose Adam state is whole."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data = tmp_path / "data"
    write_coco_dataset(str(data / "synth"), 4, 96, 128, mode="train", seed=1)
    write_coco_dataset(str(data / "synth"), 2, 96, 128, mode="val", seed=2,
                       first_img_id=5000)
    out, logs = tmp_path / "out", tmp_path / "logs"
    trainer = cli_train.main([
        "-m", "shufflenetV2_0.5x", "-d", "synth", "--data-dir", str(data),
        "--device", "cpu", "--square_size", "64", "-b", "4", "-e", "1",
        "--workers", "0", "--save_epoch", "1", "--num-devices", "4",
        "--spatial", "2", "--zero1", "--out-dir", str(out), "--logdir",
        str(logs)])
    assert (trainer.rank, trainer.world, trainer.step) == (0, 2, 1)
    saved = torch.load(out / "epoch_0.ckpt", weights_only=False)
    n_params = sum(1 for p in trainer.model.parameters())
    assert saved["step"] == 1 and len(saved["optimizer"]["state"]) == n_params
    (run,) = os.listdir(logs)
    with open(logs / run / "logging.log") as f:
        log = f.read()
    assert "rank 0 of 2, spatial x2, ZeRO-1" in log and "rank 1" not in log
    with open(logs / run / "metrics.jsonl") as f:
        names = [json.loads(line)["name"] for line in f]
    assert names.count("Loss/train") == 1


@pytest.fixture
def four_cards(monkeypatch):
    """Four visible CUDA devices, as far as the choice of devices reads
    them; ``set_device`` and the process group's start are recorded, not
    run."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda index: calls.append(("set_device", index)))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend,
                                                            kw["rank"])))
    return calls


def _checked(flags):
    args = cli_train._parser().parse_args(["-d", "synth"] + flags)
    return args, cli_train.check_flags(args)


def test_each_rank_joins_on_the_cards_it_trains_on(four_cards):
    """``--num-devices 4 --spatial 2`` on four cards: rank r's NCCL group
    starts on the first card of the two its ``Trainer`` splits images
    over (``cli.train._devices``, the parameters and every collective
    there), so no rank makes a second communicator on another card."""
    args, world = _checked(["--num-devices", "4", "--spatial", "2"])
    assert world == 2
    for rank in range(world):
        four_cards.clear()
        cli_train._join(args, "localhost:1", world, rank)
        devices = cli_train._devices(args, rank)
        assert devices == (torch.device("cuda", 2 * rank),
                           torch.device("cuda", 2 * rank + 1))
        assert four_cards == [("set_device", devices[0].index),
                              ("nccl", rank)]


@pytest.mark.parametrize("flags,want", [
    (["--gpus", "2,3"], {0: ["cuda:2"], 1: ["cuda:3"]}),
    (["--gpus", "3,0,2,1", "--spatial", "2"],
     {0: ["cuda:3", "cuda:0"], 1: ["cuda:2", "cuda:1"]}),
    (["--gpus", "1,3", "--spatial", "2", "--coordinator", "h:1",
      "--num-processes", "2", "--process-id", "1"],
     {1: ["cuda:1", "cuda:3"]}),
    (["--spatial", "2", "--coordinator", "h:1", "--num-processes", "4",
      "--process-id", "3"], {3: ["cuda:2", "cuda:3"]}),
    (["--gpus", "4"], "distinct ids of the 4 visible CUDA devices"),
    (["--gpus", "1,1"], "distinct ids"),
    (["--gpus", "0,1", "--num-devices", "3"], "lists 2 ids"),
    (["--gpus", "1", "--spatial", "2", "--coordinator", "h:1"],
     "this process's --spatial 2 card"),
], ids=["two_ids", "spatial_ids", "coordinator_ids", "coordinator_row",
        "not_visible", "repeated", "count", "coordinator_count"])
def test_gpus_name_the_ranks_cards(four_cards, flags, want):
    """``--gpus`` picks the cards the ranks train on (the reference's
    CUDA ids), rank r on the r-th id, or the r-th pair under ``--spatial
    2``; with ``--coordinator``, this process's cards. Ids that are not
    visible, repeat, or disagree with the counts exit naming why."""
    if isinstance(want, str):
        with pytest.raises(SystemExit, match=want):
            _checked(flags)
        return
    args, world = _checked(flags)
    assert world == (1 if args.coordinator else len(want))
    for rank, names in want.items():
        assert cli_train._devices(args, rank) == tuple(
            torch.device(n) for n in names)


@pytest.fixture
def coco_tree(tmp_path):
    root = tmp_path / "data" / "coco"
    golden = np.load(os.path.join(os.path.dirname(__file__), "data",
                                  "torch_eval_golden.npz"))
    inputs.write_eval_images(
        str(root / "images" / "val"), str(root / "annotations_val.json"),
        json.loads(str(golden["annotations"])))
    return str(tmp_path / "data")


def test_eval_num_devices_shards_each_batch(coco_tree, tmp_path, capsys):
    vis = str(tmp_path / "vis")
    cli_eval.main(CPU + ["-d", "coco", "--data-dir", coco_tree,
                         "--n-images", "4", "--num-devices", "2", "-b", "2",
                         "--json", "--vis-dir", vis])
    stdout = capsys.readouterr().out
    assert "2 devices (sharded" in stdout and "AP@OKS = " in stdout
    assert os.path.exists(os.path.join(vis, "results.json"))


def test_run_image_num_devices_splits_the_height(tmp_path, capsys):
    src = str(tmp_path / "a.png")
    frame = np.random.default_rng(0).integers(0, 256, (96, 128, 3), np.uint8)
    assert cv2.imwrite(src, frame)
    out = str(tmp_path / "out.png")
    run_image.main(CPU + ["-i", src, "-o", out, "--num-devices", "2"])
    stdout = capsys.readouterr().out
    assert "2 devices (spatial" in stdout and f"-> {out}" in stdout
    assert cv2.imread(out).shape == frame.shape
