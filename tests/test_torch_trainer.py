"""The port's ``Trainer`` and ``cli.train`` on the CPU.

``Trainer.fit`` + ``restore`` give the parameters, BN statistics and
Adam state back bitwise; a set ``preempted`` flag writes
``preempt.ckpt``, which ``cli.train`` resumes from and consumes;
``cli.train --device cpu`` runs end to end on rendered scenes (also from
a torchvision-style VGG19 file through the frozen-backbone warmup, and
with ``--targets raw`` with and without ``--raw-cache``, whose
per-batch draws repeat across a resume); the parallel flags validate
(or exit naming why they cannot run), and a flax file that is no trainer
checkpoint exits saying so; with no card and no ``--device cpu``
training raises; the serving CLIs load a checkpoint the trainer wrote.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ekpose_tpu_torch.cli import train as cli_train  # noqa: E402
from torch_ekpose_tpu_torch.cli.common import load_variables  # noqa: E402
from torch_ekpose_tpu_torch.config import get_default_config  # noqa: E402
from torch_ekpose_tpu_torch.data import transforms as T  # noqa: E402
from torch_ekpose_tpu_torch.data.dataset import (  # noqa: E402
    BatchLoader, CocoKeypoints)
from torch_ekpose_tpu_torch.data.synthetic_coco import (  # noqa: E402
    write_coco_dataset)
from torch_ekpose_tpu_torch.models.factory import init_model  # noqa: E402
from torch_ekpose_tpu_torch.runtime.checkpoint import (  # noqa: E402
    import_imagenet_vgg19)
from torch_ekpose_tpu_torch.runtime.estimator import (  # noqa: E402
    PoseEstimator, nhwc_to_nchw, preprocess)
from torch_ekpose_tpu_torch.training import Trainer  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

NAME, SIZE = "mobilenet_thin", 64


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    write_coco_dataset(str(root / "synth"), 4, 96, 128, mode="train",
                       seed=1)
    write_coco_dataset(str(root / "synth"), 2, 96, 128, mode="val", seed=2,
                       first_img_id=5000)
    return str(root)


def _loader(data_dir, mode="train", targets="device"):
    ds = CocoKeypoints(
        os.path.join(data_dir, "synth", "images", mode),
        os.path.join(data_dir, "synth", f"annotations_{mode}.json"),
        preprocess=T.TRAIN_PREPROCESS(SIZE),
        image_transform=T.image_transform_train, target_mode=targets,
        input_size=SIZE)
    return BatchLoader(ds, 2, shuffle=mode == "train", num_workers=0,
                       drop_last=mode == "train")


def _trainer(tmp_path, sub="run", **options):
    cfg = get_default_config()
    cfg.TRAIN.square_size = SIZE
    return Trainer(NAME, config=cfg, out_dir=str(tmp_path / sub / "ckpt"),
                   log_dir=str(tmp_path / sub / "logs"), device="cpu",
                   **options)


def _equal_state(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(got[key], value), key
        elif isinstance(value, dict):
            _equal_state(got[key], value)
        else:
            assert got[key] == value, key


def test_fit_and_restore_are_bitwise(tmp_path, data_dir):
    trainer = _trainer(tmp_path)
    curve = trainer.fit(_loader(data_dir), _loader(data_dir, "val"),
                        epochs=2, save_epoch=1, verbose=False)
    assert len(curve["train"]) == len(curve["val"]) == 2
    assert np.isfinite(curve["train"] + curve["val"]).all()
    ckpt = os.path.join(trainer.out_dir, "epoch_1.ckpt")
    assert os.path.exists(os.path.join(trainer.out_dir, "epoch_0.ckpt"))
    fresh = _trainer(tmp_path, "fresh")
    fresh.restore(ckpt)
    _equal_state(fresh.model.state_dict(), trainer.model.state_dict())
    _equal_state(fresh.optimizer.state_dict(),
                 trainer.optimizer.state_dict())
    assert (fresh.step, fresh.epoch) == (trainer.step, 2) == (4, 2)
    assert fresh.train_curve == trainer.train_curve
    assert fresh.scheduler.state_dict() == trainer.scheduler.state_dict()
    # one more step from each lands on the same parameters
    images, kpts = next(iter(_loader(data_dir)))
    for t in (trainer, fresh):
        t.train_step(torch.from_numpy(images), torch.from_numpy(kpts))
    _equal_state(fresh.model.state_dict(), trainer.model.state_dict())
    with open(os.path.join(tmp_path, "run", "logs", "metrics.jsonl")) as f:
        names = {json.loads(line)["name"] for line in f}
    assert {"Loss/train", "Loss/val", "BatchTime/train", "DataTime/train",
            "LearningRate", "max_ht/train"} <= names


class _PreemptAfter:
    """A loader that sets ``trainer.preempted`` after ``n`` batches."""

    def __init__(self, loader, trainer, n=1):
        self.loader, self.trainer, self.n = loader, trainer, n
        self.dataset = loader.dataset

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            if i == self.n:
                self.trainer.preempted = True
            yield batch


def test_preempt_checkpoint_is_resumed_by_the_cli(tmp_path, data_dir):
    out = tmp_path / "out"
    cfg = get_default_config()
    cfg.TRAIN.square_size = SIZE
    trainer = Trainer(NAME, config=cfg, out_dir=str(out),
                      log_dir=str(tmp_path / "logs0"), device="cpu")
    trainer.fit(_PreemptAfter(_loader(data_dir), trainer),
                _loader(data_dir, "val"), epochs=2, verbose=False)
    path = out / "preempt.ckpt"
    assert trainer.preempted and path.exists()
    assert trainer.train_curve == {"train": [], "val": []}
    saved = torch.load(path, weights_only=True)
    assert (saved["epoch"], saved["step"]) == (0, 1)

    resumed = cli_train.main([
        "-m", NAME, "-d", "synth", "--data-dir", data_dir, "--device", "cpu",
        "--square_size", str(SIZE), "-b", "2", "-e", "1", "--workers", "0",
        "--out-dir", str(out), "--logdir", str(tmp_path / "logs")])
    assert not path.exists()                      # consumed
    assert resumed.step == 1 + 2 and resumed.epoch == 0
    assert len(resumed.train_curve["train"]) == 1


def test_cli_train_runs_on_the_cpu(tmp_path, data_dir):
    """The single-GPU training command line, vgg2016 (the default
    model), at a CPU size."""
    trainer = cli_train.main([
        "-d", "synth", "--data-dir", data_dir, "--device", "cpu",
        "--square_size", "64", "-b", "2", "--n-images", "4", "-e", "1",
        "--workers", "0", "--save_epoch", "1", "--targets", "host",
        "--out-dir", str(tmp_path / "out"), "--logdir",
        str(tmp_path / "logs")])
    assert trainer.model_name == "vgg2016" and trainer.step == 2
    assert (tmp_path / "out" / "epoch_0.ckpt").exists()
    os.remove(tmp_path / "out" / "epoch_0.ckpt")    # 600 MB: vgg2016 + Adam
    logs = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "logs")
            for f in fs]
    assert {os.path.basename(p) for p in logs} >= {"metrics.jsonl",
                                                   "logging.log"}


def test_imagenet_backbone_and_warmup(tmp_path, data_dir):
    """``--imagenet_pretrained FILE``: the backbone's first ten convs
    come from a torchvision-style VGG19 file, then a frozen-backbone
    warmup epoch (its own out_dir) leaves them as they were."""
    rng = np.random.default_rng(0)
    model = init_model("vgg2016", generator=torch.Generator().manual_seed(0),
                       device="cpu")
    vgg19 = {"classifier.0.weight": torch.zeros(3, 3)}
    for idx in (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34):
        ref = model.state_dict().get(f"model0.backbone.{idx}.weight")
        shape = ref.shape if ref is not None else (512, 512, 3, 3)
        vgg19[f"features.{idx}.weight"] = torch.from_numpy(
            rng.normal(0, 0.01, shape).astype(np.float32))
        vgg19[f"features.{idx}.bias"] = torch.from_numpy(
            rng.normal(0, 0.01, shape[:1]).astype(np.float32))
    path = str(tmp_path / "vgg19-test.pth")
    torch.save(vgg19, path)

    state = import_imagenet_vgg19(path, model.state_dict())
    for key, value in model.state_dict().items():
        idx = key.split(".")[2] if key.startswith("model0.backbone.") else ""
        if idx in {"0", "2", "5", "7", "10", "12", "14", "16", "19", "21"}:
            assert torch.equal(state[key], vgg19[f"features.{idx}."
                                                 + key.split(".")[-1]])
        else:
            assert torch.equal(state[key], value), key
    bad = dict(vgg19)
    bad["features.5.weight"] = bad["features.5.weight"][:, :3]
    with pytest.raises(ValueError, match="shape"):
        import_imagenet_vgg19(bad, model.state_dict())
    with pytest.raises(ValueError, match="missing"):
        import_imagenet_vgg19({}, model.state_dict())

    out = tmp_path / "out"
    trainer = cli_train.main([
        "-d", "synth", "--data-dir", data_dir, "--device", "cpu",
        "--square_size", "64", "-b", "2", "--n-images", "2", "-e", "1",
        "--workers", "0", "--imagenet_pretrained", path,
        "--warmup_epochs", "1", "--out-dir", str(out),
        "--logdir", str(tmp_path / "logs")])
    assert (out / "warmup").is_dir() and trainer.step == 1
    os.remove(path)                   # 65 MB
    with open(next(os.path.join(d, "logging.log") for d, _, fs in
                   os.walk(tmp_path / "logs") if "logging.log" in fs)) as f:
        log = f.read()
    assert "backbone initialized from imagenet VGG19" in log
    assert "1-epoch frozen-backbone warmup" in log


def test_imagenet_import_matches_jax():
    """The port's ``import_imagenet_vgg19`` == the JAX package's, through
    ``export_torch_checkpoint``."""
    pytest.importorskip("jax")
    import torch_jax_models as tjm
    from torch_ekpose_tpu.runtime.checkpoint import (
        export_torch_checkpoint, import_imagenet_vgg19 as jax_import)
    from torch_ekpose_tpu_torch.runtime.checkpoint import state_dict_from_jax

    variables = tjm.jax_variables("vgg2016")
    rng = np.random.default_rng(1)
    vgg19 = {}
    for idx in (0, 2, 5, 7, 10, 12, 14, 16, 19, 21):
        w = variables["params"]["model0"][f"conv_{idx}"]["conv"]["kernel"]
        vgg19[f"features.{idx}.weight"] = rng.normal(
            0, 0.01, (w.shape[3], w.shape[2], 3, 3)).astype(np.float32)
        vgg19[f"features.{idx}.bias"] = rng.normal(
            0, 0.01, w.shape[3]).astype(np.float32)
    want = export_torch_checkpoint(jax_import(vgg19, variables), "vgg2016",
                                   prefix="")
    got = import_imagenet_vgg19(vgg19, state_dict_from_jax(variables))
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


@pytest.mark.parametrize("flags,item", [
    (["--targets", "raw", "--num-processes", "2"],
     "--num-processes / --process-id take --coordinator"),
    (["--targets", "raw", "--raw-cache", "cache", "--num-devices", "2"], 2),
    (["--zero1"], 1),
    (["--spatial", "2"], "--spatial 2 must divide the 1-device run"),
    (["--num-devices", "2"], 2),
    (["--gpus", "0,1"], "--gpus 0,1 names CUDA devices"),
    (["--coordinator", "localhost:1234"], 1),
    (["--num-processes", "2"],
     "--num-processes / --process-id take --coordinator"),
], ids=["raw", "raw_cache", "zero1", "spatial", "num_devices", "gpus",
        "coordinator", "num_processes"])
def test_unported_flags_are_refused(tmp_path, flags, item):
    """The JAX CLI's parallel flags (once refused here) and what stays
    refused, validated before anything loads: an int is the number of
    processes this host starts (``--device cpu``: gloo ranks), a string
    the reason a combination exits. They train in
    ``tests/test_torch_parallel_cli.py``."""
    args = cli_train._parser().parse_args(
        ["-d", "synth", "--device", "cpu", "--data-dir", str(tmp_path),
         "--logdir", str(tmp_path / "logs")] + flags)
    if isinstance(item, int):
        assert cli_train.check_flags(args) == item
    else:
        with pytest.raises(SystemExit, match=item):
            cli_train.check_flags(args)


def test_jax_only_flag_is_unknown(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        cli_train.main(["-d", "synth", "--compilation-cache", "x"])
    assert exc.value.code == 2
    assert "--compilation-cache" in capsys.readouterr().err


def test_process_id_is_unknown(tmp_path):
    """A multi-host launch line's rank without ``--coordinator`` is
    refused, not ignored: alone it would start an independent run writing
    to the same --out-dir; a rank outside ``--num-processes`` too."""
    for flags in (["--process-id", "1"],
                  ["--coordinator", "h:1", "--num-processes", "2",
                   "--process-id", "2"]):
        with pytest.raises(SystemExit, match="--process-id"):
            cli_train.main(["-d", "synth", "--device", "cpu", "--logdir",
                            str(tmp_path / "logs")] + flags)


def test_flax_checkpoint_is_refused(tmp_path, data_dir):
    """A flax file that holds no trainer state (the JAX package's trainer
    ``.ckpt`` restores: ``tests/test_torch_flax_reader.py``) exits naming
    what it holds, from ``restore``, ``cli.train`` and the serving
    loader."""
    flax = pytest.importorskip("flax.serialization")
    path = str(tmp_path / "epoch_3.ckpt")
    with open(path, "wb") as f:
        f.write(flax.msgpack_serialize({"params": {"w": np.zeros(3)}}))
    with pytest.raises(SystemExit, match="not a trainer checkpoint"):
        _trainer(tmp_path).restore(path)
    with pytest.raises(SystemExit, match="not a trainer checkpoint"):
        cli_train.main(["-m", NAME, "-d", "synth", "--data-dir", data_dir,
                        "--device", "cpu", "--square_size", "64", "-b", "2",
                        "-e", "1", "--workers", "0", "--pretrained_path",
                        path, "--out-dir", str(tmp_path / "out"),
                        "--logdir", str(tmp_path / "logs")])
    with pytest.raises(SystemExit, match="not a mobilenet_thin checkpoint"):
        load_variables(NAME, path)


def _cli_raw(data_dir, tmp_path, *extra):
    return cli_train.main(["-m", NAME, "-d", "synth", "--data-dir", data_dir,
                           "--device", "cpu", "--square_size", "64", "-b",
                           "2", "-e", "2", "--workers", "0", "--targets",
                           "raw", "--out-dir", str(tmp_path / "out"),
                           "--logdir", str(tmp_path / "logs"), *extra])


def test_cli_train_raw_runs_two_epochs(tmp_path, data_dir):
    """``--targets raw``: decode-only canvases, augmented in the step; two
    epochs, finite losses, checkpoints written; the validation loader
    still serves device-target items."""
    trainer = _cli_raw(data_dir, tmp_path, "--save_epoch", "1")
    losses = trainer.train_curve["train"] + trainer.train_curve["val"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert trainer.step == 4
    assert os.path.exists(tmp_path / "out" / "epoch_1.ckpt")


def test_cli_train_raw_cache_builds_then_reads(tmp_path, data_dir,
                                               monkeypatch):
    """``--raw-cache PREFIX``: the first run builds the cache (the raw
    loader's canvases, valid sizes and keypoints) and trains from it; a
    second run reads it without decoding an image and, its draws seeded by
    (seed, epoch, batch), trains to the same losses; ``--raw-cache``
    without ``--targets raw`` exits."""
    from torch_ekpose_tpu_torch.data import raw_cache

    prefix = str(tmp_path / "cache" / "synth")
    os.makedirs(os.path.dirname(prefix))
    first = _cli_raw(data_dir, tmp_path / "a", "--raw-cache", prefix)
    assert raw_cache.cache_exists(prefix)
    cached = raw_cache.RawArrayDataset(prefix)
    assert len(cached) == 4 and cached[0][0].shape == (432, 432, 3)
    monkeypatch.setattr(cli_train, "build_raw_cache", None)
    monkeypatch.setattr(CocoKeypoints, "_raw_item", None)
    again = _cli_raw(data_dir, tmp_path / "b", "--raw-cache", prefix)
    assert again.train_curve["train"] == first.train_curve["train"]
    with pytest.raises(SystemExit, match="--targets raw"):
        cli_train.main(["-d", "synth", "--data-dir", data_dir, "--device",
                        "cpu", "--raw-cache", prefix, "--logdir",
                        str(tmp_path / "logs")])


def test_raw_draws_repeat_by_epoch_and_batch():
    """A raw batch's augmentation generator depends on (seed, epoch,
    batch) alone, so a resumed epoch draws what it drew before."""
    from torch_ekpose_tpu_torch.data.device_aug import sample_params
    from torch_ekpose_tpu_torch.training.trainer import aug_generator

    def s(*key):
        return sample_params(4, aug_generator(*key))["s"].tolist()

    assert s(0, 3, 5) == s(0, 3, 5)
    assert len({tuple(s(*k)) for k in [(0, 3, 5), (0, 3, 6), (0, 4, 5),
                                       (1, 3, 5)]}) == 4


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_no_card_and_no_cpu_request_raises(tmp_path, data_dir):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(NAME, out_dir=str(tmp_path / "o"),
                log_dir=str(tmp_path / "l"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["-m", NAME, "-d", "synth", "--data-dir", data_dir,
                        "--workers", "0", "--out-dir", str(tmp_path / "o"),
                        "--logdir", str(tmp_path / "l")])


def test_serving_loads_the_trainers_checkpoint(tmp_path, data_dir):
    """Train 2 CPU steps, save; ``PoseEstimator`` built from that
    ``.ckpt`` through ``cli/common.py::load_variables`` has the trained
    weights, and its float32 maps equal the trained model's eval
    forward."""
    trainer = _trainer(tmp_path)
    trainer.fit(_loader(data_dir), None, epochs=1, save_epoch=1,
                verbose=False)
    path = os.path.join(trainer.out_dir, "epoch_0.ckpt")
    est = PoseEstimator(NAME, load_variables(NAME, path), device="cpu",
                        compute_dtype=torch.float32)
    _equal_state(est.model.state_dict(), trainer.model.state_dict())
    frames = np.random.default_rng(0).integers(0, 256, (2, 64, 72, 3),
                                               dtype=np.uint8)
    paf, heat = est.get_outputs_batch(frames)
    x = nhwc_to_nchw(preprocess(torch.from_numpy(frames), "vgg"))
    with torch.no_grad():
        (paf_t, heat_t), _ = trainer.model.eval()(x.contiguous())
    np.testing.assert_array_equal(paf, paf_t.permute(0, 2, 3, 1).numpy())
    np.testing.assert_array_equal(heat, heat_t.permute(0, 2, 3, 1).numpy())
