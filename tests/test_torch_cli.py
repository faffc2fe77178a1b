"""The port's command-line entry points on the CPU (``--device cpu``,
float32, small ``--dest-size``): ``run_image``, ``eval``,
``bench_latency``, ``vis_output``, ``run_video`` (both paths) and the
headless ``run_webcam``, driven as ``tests/test_cli_pipelines.py`` drives
the JAX package's; the card defaults of ``eval``; the options the port
refuses or leaves out; ``serve``'s device decode; and ``POST /pose``
through cv2 or Pillow (200, with people), answered 400 with one clear
message where neither is installed.
"""

import io
import json
import os
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu_torch.cli import (  # noqa: E402
    bench_latency,
    common,
    eval as cli_eval,
    run_image,
    run_video,
    run_webcam,
    serve,
    vis_output,
)
from torch_ekpose_tpu_torch.runtime import estimator as estimator_module  # noqa: E402,E501
from torch_ekpose_tpu_torch.runtime.estimator import (  # noqa: E402
    PoseEstimator,
)
from torch_ekpose_tpu_torch.runtime.server import PoseServer  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_eval_golden.npz")
#: every CLI call here: the CPU, float32, small frames
CPU = ["--device", "cpu", "--dtype", "float32", "--dest-size", "64"]


#: the image libraries each case hides: none (cv2 reads and writes),
#: cv2 (Pillow does), both (one clear error)
CODECS = {"cv2": (), "pillow": ("cv2",), "neither": ("cv2", "PIL")}


def _hide(monkeypatch, names):
    """Make ``import <name>`` fail for each of ``names``."""
    for name in names:
        monkeypatch.setitem(sys.modules, name, None)


def _frame(h=96, w=128, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _write_png(path, frame) -> str:
    assert cv2.imwrite(str(path), frame)
    return str(path)


@pytest.mark.parametrize("library", ["cv2", "pillow"])
def test_run_image_single_and_directory(tmp_path, monkeypatch, capsys,
                                        library):
    src = tmp_path / "in"
    src.mkdir()
    frames = {"a.png": _frame(), "b.png": _frame(80, 60, seed=1)}
    for name, frame in frames.items():
        _write_png(src / name, frame)
    _hide(monkeypatch, CODECS[library])
    out = str(tmp_path / "one" / "out.png")
    run_image.main(CPU + ["-i", str(src / "a.png"), "-o", out])
    run_image.main(CPU + ["--input-dir", str(src), "--output-dir",
                          str(tmp_path / "dir")])
    monkeypatch.undo()
    stdout = capsys.readouterr().out
    assert "people ->" in stdout and "b.png:" in stdout
    for path, name in ((out, "a.png"), (tmp_path / "dir" / "a.png", "a.png"),
                       (tmp_path / "dir" / "b.png", "b.png")):
        assert cv2.imread(str(path)).shape == frames[name].shape


def test_run_image_analyze(tmp_path):
    pytest.importorskip("matplotlib")
    src = _write_png(tmp_path / "in.png", _frame())
    run_image.main(CPU + ["-i", src, "-o", str(tmp_path / "out.png"), "-a"])
    assert os.path.getsize(tmp_path / "out_analyze.png") > 0


@pytest.fixture
def coco_tree(tmp_path):
    """``<data-dir>/coco/images/val`` + ``annotations_val.json``: the
    eval scenes as PNGs."""
    root = tmp_path / "data" / "coco"
    inputs.write_eval_images(
        str(root / "images" / "val"), str(root / "annotations_val.json"),
        json.loads(str(np.load(EVAL_GOLDEN)["annotations"])))
    return str(tmp_path / "data")


def test_eval_cli_on_cpu(coco_tree, tmp_path, capsys):
    vis = str(tmp_path / "vis")
    cli_eval.main(CPU + ["-d", "coco", "--data-dir", coco_tree,
                         "--n-images", "4", "--json", "--vis-dir", vis,
                         "--save", "2"])
    stdout = capsys.readouterr().out
    assert "AP@OKS = " in stdout and "decode auto" in stdout
    rows = inputs.eval_rows(os.path.join(vis, "results.json"))
    assert set(rows[:, 0]) <= {1, 2, 3, 4}
    assert sorted(os.listdir(vis)) == ["000000000001.png",
                                       "000000000003.png", "results.json"]


class _Stop(Exception):
    pass


@pytest.mark.parametrize("argv,want", [
    (["--device", "cuda"], (8, "device")),
    (["--device", "cuda:0", "--decode-backend", "native"], (8, "native")),
    (["--device", "cuda", "-b", "2"], (2, "device")),
    (["--device", "cpu"], (1, "auto")),
    (["--device", "cpu", "-b", "4", "--decode-backend", "jax"], (4, "jax")),
], ids=["cuda", "cuda_native", "cuda_b2", "cpu", "cpu_b4_jax"])
def test_eval_defaults_follow_the_device(monkeypatch, argv, want):
    """On a CUDA device an unset --batch is 8 and --decode-backend auto is
    the device decode, as the JAX CLI does on its TPU; explicit flags
    win; elsewhere the reference's batch 1 and host decode."""
    seen = {}

    def build(args):
        seen.update(vars(args))
        raise _Stop

    monkeypatch.setattr(common, "build_estimator", build)
    with pytest.raises(_Stop):
        cli_eval.main(argv + ["-d", "coco"])
    assert (seen["batch"], seen["decode_backend"]) == want


def test_eval_on_cuda_without_a_card_raises(coco_tree):
    """``--device cuda`` with no card fails; it does not carry on on the
    CPU."""
    with pytest.raises((AssertionError, RuntimeError)):
        cli_eval.main(["-d", "coco", "--data-dir", coco_tree,
                       "--dest-size", "64"])


def test_bench_latency_cli(capsys):
    bench_latency.main(CPU + ["--sizes", "64", "96", "--frames", "2"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["size"] for r in rows] == [64, 96]
    assert all(r["p50_ms"] > 0 and r["p99_ms"] >= r["p50_ms"] and r["fps"] > 0
               for r in rows)


def test_vis_output_writes_channel_grid(tmp_path):
    pytest.importorskip("matplotlib")
    src = _write_png(tmp_path / "img.png", _frame())
    out = str(tmp_path / "channels.png")
    vis_output.main(CPU + ["-i", src, "-o", out])
    assert os.path.getsize(out) > 0


@pytest.mark.parametrize("main,argv,error,needle", [
    (run_image.main, ["-c", "ckpt.msgpack", "-i", "x.png"], SystemExit,
     "msgpack"),
    (run_image.main, ["--dtype", "int8", "-m", "mobilenet_thin", "-i",
                      "x.png"], ValueError, "int8"),
    (run_image.main, ["--precision", "highest", "--dtype", "int8",
                      "-i", "x.png"], SystemExit, "--precision highest"),
], ids=["msgpack", "int8", "highest_int8"])
def test_refused_options(main, argv, error, needle):
    with pytest.raises(error, match=needle):
        main(["--device", "cpu"] + argv)


@pytest.mark.parametrize("main,argv", [
    (run_image.main, ["--s2d-blocks", "1", "-i", "x.png"]),
    (cli_eval.main, ["--compilation-cache", "/tmp/c", "-d", "coco"]),
    (serve.main, ["--s2d-blocks", "1"]),
], ids=["s2d", "compilation_cache", "s2d_serve"])
def test_flags_the_port_leaves_out_are_unknown(main, argv, capsys,
                                               monkeypatch):
    """The JAX CLI's XLA cache flag is not in the port's parsers, so
    argparse refuses it before anything is built; ``--s2d-blocks`` is
    parsed, and reaches the model the estimator builds."""
    if "--s2d-blocks" in argv:
        seen = {}

        def build(*args, **kwargs):
            seen.update(kwargs)
            raise _Stop

        monkeypatch.setattr(estimator_module, "init_model", build)
        with pytest.raises(_Stop):
            main(["--device", "cpu"] + argv)
        assert seen["s2d_blocks"] == 1
        return
    with pytest.raises(SystemExit) as exit_:
        main(["--device", "cpu"] + argv)
    assert exit_.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("main,argv,needle", [
    (run_image.main, ["--num-devices", "2", "-a", "-i", "x.png"],
     "--analyze is single-device only"),
    (cli_eval.main, ["--num-devices", "4", "-b", "6", "-d", "coco"],
     "--batch 6 must be a multiple of --num-devices 4"),
    (cli_eval.main, ["--num-devices", "4", "-b", "8", "-d", "coco"],
     "--num-devices 4: 4 devices asked for, but only 3"),
], ids=["num_devices_image", "num_devices_eval", "num_devices_visible"])
def test_mesh_flags_refuse_what_cannot_run(monkeypatch, main, argv, needle):
    """``--num-devices`` (``parallel/``) runs where it can
    (``tests/test_torch_parallel_cli.py``) and exits naming the reason
    where it cannot: ``--analyze`` over a split image, a batch that does
    not shard evenly, more devices than are visible."""
    from torch_ekpose_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "cuda_devices", lambda: [
        torch.device("cuda", i) for i in range(3)])
    with pytest.raises(SystemExit, match=needle):
        main(["--device", "cuda"] + argv)


@pytest.mark.parametrize("backend,ok", [
    (None, True), ("device", True), ("jax", True),
    ("auto", False), ("native", False), ("numpy", False),
], ids=["default", "device", "jax", "auto", "native", "numpy"])
def test_serve_decodes_on_the_card_only(backend, ok, capsys):
    """The server batches frames and always decodes on the card, so a
    host decode backend is refused, not silently ignored."""
    argv = [] if backend is None else ["--decode-backend", backend]
    if ok:
        assert serve.parse_args(argv).decode_backend in ("device", "jax")
    else:
        with pytest.raises(SystemExit):
            serve.parse_args(argv)
        assert "decodes them on the card" in capsys.readouterr().err


@pytest.mark.parametrize("main,argv,module", [
    (vis_output.main, ["-i", "x.png"], "matplotlib"),
    (run_image.main, ["-i", "x.png", "-a"], "matplotlib"),
    (run_video.main, ["-v", "x.mp4"], "cv2"),
    (run_webcam.main, ["--headless"], "cv2"),
], ids=["vis_output", "analyze", "run_video", "run_webcam"])
def test_missing_library_is_a_clear_exit(monkeypatch, main, argv, module):
    monkeypatch.setitem(sys.modules, module, None)
    with pytest.raises(SystemExit, match=f"needs {module}"):
        main(["--device", "cpu"] + argv)


# -- run_video / run_webcam, as tests/test_cli_pipelines.py drives them -----

@pytest.fixture(scope="module")
def tiny_video(tmp_path_factory):
    """18 frames at 120x160: with --batch 4 that is 4 full batches plus a
    2-frame remainder, driving the padded-dispatch path."""
    path = str(tmp_path_factory.mktemp("video") / "in.mp4")
    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (160, 120))
    rng = np.random.default_rng(0)
    for _ in range(18):
        writer.write(rng.integers(0, 255, (120, 160, 3), dtype=np.uint8))
    writer.release()
    return path


def _count_frames(path):
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def test_run_video_batched_pipeline(tiny_video, tmp_path, capsys):
    out = str(tmp_path / "out.mp4")
    run_video.main(CPU + ["-v", tiny_video, "-o", out, "-b", "4"])
    stdout = capsys.readouterr().out
    assert _count_frames(out) == 18
    assert "FPS" in stdout and "18 frames" in stdout


def test_run_video_single_frame_path(tiny_video, tmp_path):
    out = str(tmp_path / "out1.mp4")
    run_video.main(CPU + ["-v", tiny_video, "-o", out, "--max-frames", "3"])
    assert _count_frames(out) == 3


def test_run_video_batch_requires_device_decode(tiny_video):
    with pytest.raises(SystemExit):
        run_video.main(CPU + ["-v", tiny_video, "-b", "4",
                              "--decode-backend", "numpy"])


def test_run_video_pipeline_propagates_stage_errors(tiny_video, tmp_path,
                                                    monkeypatch):
    def boom(frame, humans):
        raise RuntimeError("draw failed")

    monkeypatch.setattr(run_video, "draw_humans", boom)
    with pytest.raises(RuntimeError, match="draw failed"):
        run_video.main(CPU + ["-v", tiny_video, "-o",
                              str(tmp_path / "err.mp4"), "-b", "4"])


class _FakeCapture:
    """Stands in for cv2.VideoCapture: endless random frames."""

    def __init__(self, *a, **kw):
        self._rng = np.random.default_rng(0)

    def isOpened(self):
        return True

    def read(self):
        return True, self._rng.integers(0, 255, (120, 160, 3),
                                        dtype=np.uint8)

    def release(self):
        pass


def test_run_webcam_headless(monkeypatch, capsys):
    monkeypatch.setattr(cv2, "VideoCapture", _FakeCapture)
    run_webcam.main(CPU + ["--headless", "--max-frames", "4"])
    out = capsys.readouterr().out
    assert "FPS" in out and "avg" in out and "min" in out


def test_run_webcam_unopenable_camera(monkeypatch):
    class Closed(_FakeCapture):
        def isOpened(self):
            return False

    monkeypatch.setattr(cv2, "VideoCapture", Closed)
    with pytest.raises(SystemExit, match="cannot open camera"):
        run_webcam.main(CPU + ["--headless"])


# -- POST /pose through each image library -----------------------------

@pytest.fixture(scope="module")
def replay_server():
    """A ``PoseServer`` on the port's CPU estimator whose forward replays
    the eval scenes' maps, so a posted frame decodes to people."""
    golden = np.load(EVAL_GOLDEN)
    est = PoseEstimator("vgg2016", device="cpu", compute_dtype=torch.float32)
    inputs.replay_forward(est, {
        i: (golden[f"heatmaps_{i}"], golden[f"pafs_{i}"])
        for i in inputs.EVAL_IDS})
    srv = PoseServer(est, port=0, max_batch=4, max_wait_ms=20.0).start()
    yield srv
    srv.stop()


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/pose", data=body,
        headers={"Content-Type": "application/octet-stream"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _scene(fmt: str) -> bytes:
    """Eval scene 2 (480x640, two people) as a PNG or JPEG body (a solid
    fill, which JPEG keeps within 1 of the value its maps are found by)."""
    body = io.BytesIO()
    Image.new("RGB", (640, 480), (inputs.EVAL_FILL * 2,) * 3).save(body, fmt)
    return body.getvalue()


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
@pytest.mark.parametrize("library", ["cv2", "pillow"])
def test_server_pose_png(replay_server, monkeypatch, library, fmt):
    """An eval scene posted as PNG or JPEG answers 200 with its people,
    through cv2 or (cv2 hidden) Pillow."""
    body = _scene(fmt)
    _hide(monkeypatch, CODECS[library])
    code, payload = _post(replay_server.port, body)
    assert code == 200, payload
    assert payload["image_size"] == [480, 640]
    assert len(payload["humans"]) == 2
    assert all(len(h["parts"]) == 18 for h in payload["humans"])


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
def test_server_without_codecs_is_a_400(replay_server, monkeypatch, fmt):
    body = _scene(fmt)
    _hide(monkeypatch, CODECS["neither"])
    code, payload = _post(replay_server.port, body)
    assert code == 400
    assert "needs cv2 or Pillow" in payload["error"]
