"""The port's AOT deployment artifact (``runtime/aot.py``) on the CPU:
export -> load -> serve reproduces the live estimator bit for bit and the
JAX package's people, with no model code loaded.

The artifact is written once, by ``cli.export --aot``, for
shufflenetV2_0.5x in float32 at batch 2 of 64x64 frames, on the JAX
package's weights (``tests/torch_jax_models.py``) with the stage-6 BN set
to make people (``torch_port_inputs.peaky_head_``). The decode program
alone is held against the JAX package's decode on synthetic scenes
(integer fields exact, float fields within rtol 1e-5). Export once ran
into two ``lru_cache``s that kept its traced tensors; a subprocess that
exports on a cold start and then serves eagerly must give a fresh
process's buffers. Also here: the three decode kernels' custom ops under
``torch.library.opcheck``, the serving adapter and CLIs, and the small
modules ``utils/hardware.py`` and ``utils/profiling.py``.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time
import urllib.request
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_jax_models as J  # noqa: E402
import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu.decode import device as D  # noqa: E402
from torch_ekpose_tpu.decode.synthetic import (  # noqa: E402
    canonical_humans, synth_scene)
from torch_ekpose_tpu.runtime import PoseEstimator as JaxEstimator  # noqa: E402
from torch_ekpose_tpu.runtime.checkpoint import convert_torch_checkpoint  # noqa: E402
from torch_ekpose_tpu.utils import profiling as jax_profiling  # noqa: E402
from torch_ekpose_tpu_torch.cli import export as cli_export  # noqa: E402
from torch_ekpose_tpu_torch.cli import serve as cli_serve  # noqa: E402
from torch_ekpose_tpu_torch.config import Config  # noqa: E402
from torch_ekpose_tpu_torch.decode import device as PD  # noqa: E402
from torch_ekpose_tpu_torch.runtime import aot  # noqa: E402
from torch_ekpose_tpu_torch.runtime.checkpoint import state_dict_from_jax  # noqa: E402
from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator  # noqa: E402
from torch_ekpose_tpu_torch.runtime.server import PoseServer  # noqa: E402
from torch_ekpose_tpu_torch.utils import hardware, profiling  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

MODEL = "shufflenetV2_0.5x"
FRAMES = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                           dtype=np.uint8)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
#: the JAX artifact's meta.json keys (torch_ekpose_tpu/runtime/aot.py)
JAX_META_KEYS = {"format_version", "jax_version", "model", "preprocess",
                 "platform", "batch", "height", "width", "stride",
                 "max_peaks", "subset_cap", "heatmap_shape", "paf_shape"}
DECODE_OPS = {"masked_peak_scores", "greedy_match", "merge_people"}


#: run as ``python -c CACHE_CHECK <export|fresh> <.pth> <out>``: the live
#: estimator's packed buffers of FRAMES into ``<out>.npy``, after an
#: export made on a cold start (nothing ran eagerly before it) or in a
#: fresh process
CACHE_CHECK = """
import sys
import numpy as np
import torch
torch.set_num_threads(2)
from torch_ekpose_tpu_torch.runtime import aot
from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator
mode, ckpt, out = sys.argv[1:]
est = PoseEstimator("shufflenetV2_0.5x", torch.load(ckpt), device="cpu",
                    compute_dtype=torch.float32, dest_size=64)
if mode == "export":
    aot.export_pipeline(est, out + ".ekx", 2, 64, 64)
frames = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                           dtype=np.uint8)
np.save(out, est._packed(frames).numpy())
"""

#: run as ``python -c LOAD_CHECK <artifact>``: serve one batch and fail
#: if jax, flax, the JAX package or the port's models were imported
LOAD_CHECK = """
import sys
import numpy as np
import torch
torch.set_num_threads(2)
from torch_ekpose_tpu_torch.runtime.aot import load_pipeline
pipe = load_pipeline(sys.argv[1])
out = pipe.packed(np.zeros(pipe.input_shape, np.uint8))
assert out.shape == (2, 4320), out.shape
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "torch_ekpose_tpu")
             or m.startswith("torch_ekpose_tpu_torch.models"))
assert not bad, bad
"""


def _start(*argv) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *argv], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc: subprocess.Popen) -> None:
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]


@pytest.fixture(scope="module")
def live(tmp_path_factory, request):
    """(the live port estimator, its weights as a .pth, the artifact
    cli.export --aot wrote from them, the CLI's output, the separate
    processes of the last tests: started here, so they run beside the
    others)."""
    port = PoseEstimator(MODEL, state_dict_from_jax(J.jax_variables(MODEL),
                                                    MODEL),
                         device="cpu", compute_dtype=torch.float32,
                         dest_size=64)
    inputs.peaky_head_(port, FRAMES)
    tmp = tmp_path_factory.mktemp("aot")
    ckpt, path = str(tmp / "peaky.pth"), str(tmp / "pose.ekx")
    torch.save(port.model.state_dict(), ckpt)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        cli_export.main(["-m", MODEL, "-c", ckpt, "--aot", "--device", "cpu",
                         "--batch", "2", "--input-size", "64x64",
                         "--dtype", "float32", "-o", path])
    procs = {mode: _start("-c", CACHE_CHECK, mode, ckpt, str(tmp / mode))
             for mode in ("export", "fresh")}
    procs["load"] = _start("-c", LOAD_CHECK, path)

    def stop():
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()
    request.addfinalizer(stop)
    return port, ckpt, path, out.getvalue(), procs, tmp


@pytest.fixture(scope="module")
def pipe(live):
    return aot.load_pipeline(live[2])


def _rewrite_meta(src: str, dst, **changes) -> str:
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for name in zin.namelist():
            data = zin.read(name)
            if name == "meta.json":
                data = json.dumps({**json.loads(data), **changes})
            zout.writestr(name, data)
    return str(dst)


def _ekpose_ops(program) -> list:
    """The ``ekpose::`` custom ops a program's graph calls, sorted."""
    return sorted(node.target.name().split("::")[1]
                  for node in program.graph.nodes
                  if node.op == "call_function"
                  and getattr(node.target, "namespace", None) == "ekpose")


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------

def test_artifact_contents(live):
    path, printed = live[2], live[3]
    with zipfile.ZipFile(path) as zf:
        infos = zf.infolist()
        meta = json.loads(zf.read("meta.json"))
    assert {i.filename for i in infos} == {"meta.json", "forward.pt2",
                                           "decode.pt2"}
    assert all(i.compress_type == zipfile.ZIP_STORED for i in infos)
    assert set(meta) == (JAX_META_KEYS - {"jax_version"}) | {
        "torch_version", "precision", "dtype"}
    assert meta == {
        "format_version": aot.FORMAT_VERSION, "torch_version":
        torch.__version__, "model": MODEL, "dtype": "float32",
        "precision": "fast", "preprocess": "vgg", "platform": "cpu",
        "batch": 2, "height": 64, "width": 64, "stride": 8, "max_peaks": 32,
        "subset_cap": 96, "heatmap_shape": [2, 8, 8, 19],
        "paf_shape": [2, 8, 8, 38]}
    assert aot.FORMAT_VERSION == 1
    assert "wrote AOT artifact (cpu, batch 2, 64x64, float32" in printed


def test_decode_program_holds_the_kernels_as_ops(pipe):
    """Each decode kernel is one custom-op node of the loaded decode
    program, and none of their twins' unrolled rounds is in it (the match
    twin alone would add more than 10 nodes for each of its K = 32
    rounds); the forward program holds the parameters."""
    assert _ekpose_ops(pipe._dec) == sorted(DECODE_OPS)
    calls = [n for n in pipe._dec.graph.nodes if n.op == "call_function"]
    assert len(calls) < 10 * 32
    assert _ekpose_ops(pipe._fwd) == []
    params = dict(pipe._fwd.named_parameters())
    assert len(params) > 50 and all(
        p.device.type == "cpu" for p in params.values())


def test_roundtrip_matches_live_and_jax(live, pipe):
    """The loaded artifact's packed buffers are bit-equal to the live
    estimator's, and its people are the live estimator's and the JAX
    package's ``PoseEstimator.estimate_batch`` ones, people found."""
    port = live[0]
    assert isinstance(pipe, aot.AotPipeline) and pipe.graph is None
    got = pipe.packed(FRAMES)
    np.testing.assert_array_equal(got.numpy(), port._packed(FRAMES).numpy())

    humans = pipe.estimate_batch(FRAMES)
    shared = convert_torch_checkpoint(
        {k: v.numpy() for k, v in port.model.state_dict().items()}, MODEL)
    ref = JaxEstimator(MODEL, shared, compute_dtype=jnp.float32,
                       decode_backend="jax", dest_size=64)
    want = [canonical_humans(h) for h in ref.estimate_batch(FRAMES)]
    assert [canonical_humans(h) for h in humans] == want
    assert [canonical_humans(h) for h in port.estimate_batch(FRAMES)] == want
    assert min(len(h) for h in humans) >= 1


def _blank_unused_slots(packed: np.ndarray, k: int) -> np.ndarray:
    """``packed`` with the refined coordinates of the peak slots that hold
    no peak (``peak_valid`` false) set to 0. Those slots refine a 5x5
    patch of whatever cells top-K filled them with; on synthetic scenes
    that can be a Gaussian tail near the float32 normal limit, where
    XLA's dot flushes each denormal product and torch's matmul flushes
    only the sums, so the argmax there may move by a pixel. No person
    refers to such a slot."""
    n = 18 * k
    out = packed.copy()
    unused = ~packed[:, 3 * n:4 * n].astype(bool)
    out[:, :2 * n].reshape(len(out), n, 2)[unused] = 0.0
    return out


def test_decode_program_matches_jax_on_synthetic_scenes():
    """The decode program, exported as ``export_pipeline`` exports it,
    on ``synth_scene`` scenes at 46x54: bit-equal to the port's eager
    decode, and against the JAX package's ``decode_jax_batched(...,
    use_pallas_loops=False)`` integer fields exact and float fields
    within rtol 1e-5, but for the coordinates of unused peak slots
    (:func:`_blank_unused_slots`); people found."""
    rng = np.random.default_rng(7)
    scenes = [synth_scene(rng, n) for n in (1, 3, 2)]
    heat = torch.from_numpy(np.stack([s[0] for s in scenes]))
    pafs = torch.from_numpy(np.stack([s[1] for s in scenes]))
    cfg = Config()
    decoder = PD.build_packed_decoder(cfg)
    program = torch.export.export(decoder, (heat, pafs), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    loaded = torch.export.load(io.BytesIO(buf.getvalue()))
    assert _ekpose_ops(loaded) == sorted(DECODE_OPS)
    with torch.no_grad():
        got = loaded.module()(heat, pafs).numpy()
        np.testing.assert_array_equal(got, decoder(heat, pafs).numpy())
    want = np.asarray(D.pack_result(D.decode_jax_batched(
        jnp.asarray(heat.numpy()), jnp.asarray(pafs.numpy()),
        use_pallas_loops=False)))
    k, cap = cfg.DECODE.max_peaks_per_part, cfg.DECODE.max_people * 3
    assert inputs.packed_mismatches(
        _blank_unused_slots(got, k), _blank_unused_slots(want, k), k, cap,
        rtol=1e-5) == []
    people = [len(PD.packed_to_humans(row, 46 * 8, 54 * 8, cfg))
              for row in got]
    assert min(people) >= 1, people


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_rejects_wrong_input(pipe):
    with pytest.raises(ValueError, match="expects input"):
        pipe.packed(FRAMES[:1])
    with pytest.raises(ValueError, match="expects input"):
        pipe.packed(np.zeros((2, 72, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="expects input"):
        pipe.packed(FRAMES.astype(np.float32))


@pytest.mark.parametrize("platform", ["cuda", "tpu"])
def test_rejects_wrong_platform(live, tmp_path, platform):
    """A CUDA artifact on a host without a card (this one), or an
    artifact of a platform the port has not."""
    path = _rewrite_meta(live[2], tmp_path / "x.ekx", platform=platform)
    with pytest.raises(ValueError, match="exported for"):
        aot.load_pipeline(path)


def test_rejects_future_format(live, tmp_path):
    path = _rewrite_meta(live[2], tmp_path / "x.ekx", format_version=999)
    with pytest.raises(ValueError, match="format"):
        aot.load_pipeline(path)


def test_export_refusals(live, tmp_path):
    """An unpadded size, a platform other than the estimator's device."""
    port = live[0]
    with pytest.raises(ValueError, match="stride"):
        aot.export_pipeline(port, str(tmp_path / "x.ekx"), 1, 65, 64)
    with pytest.raises(ValueError, match="platform"):
        aot.export_pipeline(port, str(tmp_path / "x.ekx"), 1, 64, 64,
                            platform="cuda")
    assert not (tmp_path / "x.ekx").exists()


def test_export_refuses_uncalibrated_int8_static(tmp_path):
    est = PoseEstimator("vgg2016", device="cpu", compute_dtype="int8_static",
                        seed=0)
    with pytest.raises(ValueError, match="calibrate"):
        aot.export_pipeline(est, str(tmp_path / "x.ekx"), 1, 64, 64)
    with pytest.raises(SystemExit):
        cli_export.main(["-c", "unused.pth", "--aot", "--device", "cpu",
                         "--dtype", "int8_static", "-o",
                         str(tmp_path / "x.ekx")])


def test_int8_artifact_matches_live(tmp_path):
    """vgg2016 ``int8`` (dynamic activation scales) at 64x64."""
    est = PoseEstimator("vgg2016", device="cpu", compute_dtype="int8",
                        seed=0, dest_size=64)
    path = str(tmp_path / "int8.ekx")
    meta = aot.export_pipeline(est, path, 1, 64, 64)
    assert meta["dtype"] == "int8"
    frames = FRAMES[:1]
    got = aot.load_pipeline(path).packed(frames).numpy()
    np.testing.assert_array_equal(got, est._packed(frames).numpy())


# ---------------------------------------------------------------------------
# separate processes: the cache repair, what loading imports
# ---------------------------------------------------------------------------

def test_export_leaves_eager_results_unchanged(live):
    """Export on a cold process, then the eager estimator: its buffers
    equal a fresh process's (export once left its traced tensors in the
    preprocess's and the decode's table caches)."""
    procs, tmp = live[4], live[5]
    for mode in ("export", "fresh"):
        _finish(procs[mode])
    after, fresh = np.load(tmp / "export.npy"), np.load(tmp / "fresh.npy")
    np.testing.assert_array_equal(after, fresh)
    assert min(len(PD.packed_to_humans(row, 64, 64)) for row in fresh) >= 1


def test_loading_imports_no_model_code(live):
    """``load_pipeline`` serves the artifact with jax, flax, the JAX
    package and the port's ``models`` absent from ``sys.modules``."""
    _finish(live[4]["load"])


# ---------------------------------------------------------------------------
# the decode kernels' custom ops
# ---------------------------------------------------------------------------

def _op_args(kernel: str):
    rng = np.random.default_rng(5)
    if kernel == "masked_peak_scores":
        maps = torch.from_numpy(inputs.nms_maps(rng, 2, 3, 8, 9))
        return (maps[:, 1:], 0.15)
    if kernel == "greedy_match":
        return (torch.from_numpy(inputs.match_scores(rng, 2, 6)),)
    tables = inputs.merge_inputs(rng, 2, 6, max_per_limb=3)
    return tuple(torch.from_numpy(tables[name]) for name in (
        "pair", "p1", "p2", "cid1", "cid2", "score", "n_valid",
        "peak_score")) + (12,)


@pytest.mark.parametrize("kernel", sorted(DECODE_OPS))
def test_decode_op_passes_opcheck(kernel):
    """Schema, fake (shapes only), autograd registration and AOT
    dispatch of ``ekpose::<kernel>`` on CPU inputs."""
    op = getattr(torch.ops.ekpose, kernel).default
    result = torch.library.opcheck(op, _op_args(kernel))
    assert set(result.values()) == {"SUCCESS"}, result


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_serving_adapter_letterboxes(pipe):
    adapter = aot.AotServingAdapter(pipe)
    assert adapter.model_name == f"{MODEL} (AOT cpu)"
    assert adapter.dest_size == 64 and str(adapter.device) == "cpu"
    frame = np.random.default_rng(1).integers(0, 256, (48, 96, 3),
                                              dtype=np.uint8)
    im_pad, scale = adapter.pad_image(frame)
    assert im_pad.shape == (64, 64, 3) and im_pad.dtype == np.uint8
    assert scale == pytest.approx(64 / 96)
    assert im_pad[:32].any() and not im_pad[32:].any()
    humans, scale2 = adapter.estimate(frame)
    assert scale2 == scale and isinstance(humans, list)
    # a partial batch is zero-padded; a batch past the artifact's refused
    want = pipe.estimate_batch(FRAMES)[0]
    got = adapter.estimate_batch(FRAMES[:1])
    assert len(got) == 1
    assert canonical_humans(got[0]) == canonical_humans(want)
    with pytest.raises(ValueError, match="exceeds"):
        adapter.estimate_batch(np.concatenate([FRAMES, FRAMES[:1]]))


def test_server_over_the_artifact_answers_a_png(pipe):
    cv2 = pytest.importorskip("cv2")
    adapter = aot.AotServingAdapter(pipe)
    srv = PoseServer(adapter, port=0, max_batch=pipe.batch,
                     max_wait_ms=5.0).start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health == {"status": "ok", "model": adapter.model_name,
                          "device": "cpu"}
        ok, png = cv2.imencode(".png", FRAMES[0])
        assert ok
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/pose", data=png.tobytes(),
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            payload = json.loads(resp.read())
    finally:
        srv.stop()
    want = pipe.estimate_batch(FRAMES)[0]
    assert len(payload["humans"]) == len(want) >= 1
    assert payload["padded_size"] == [64, 64] and payload["scale"] == 1.0


def test_serve_cli_takes_an_artifact(live, pipe, monkeypatch):
    """``cli.serve --aot``: the adapter over the loaded artifact, whose
    batch becomes ``--max-batch``; without ``--aot`` the estimator."""
    args = cli_serve.parse_args(["--aot", live[2], "--device", "cpu",
                                 "--max-batch", "8"])
    assert args.aot == live[2]
    monkeypatch.setattr(aot, "load_pipeline", lambda path: pipe)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        est = cli_serve.build_estimator(args)
    assert isinstance(est, aot.AotServingAdapter) and est.pipeline is pipe
    assert args.max_batch == 2
    assert "serving AOT artifact" in out.getvalue()
    assert cli_serve.parse_args(["--device", "cpu"]).aot is None


def test_export_cli_refuses_a_bad_input_size(live, tmp_path):
    with pytest.raises(SystemExit, match="HxW"):
        cli_export.main(["-m", MODEL, "-c", live[1], "--aot", "--device",
                         "cpu", "--input-size", "64by64", "-o",
                         str(tmp_path / "x.ekx")])


# ---------------------------------------------------------------------------
# utils/hardware.py and utils/profiling.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,bf16,fp32", [
    ("NVIDIA H100 80GB HBM3", 989e12, 67e12),
    ("NVIDIA H100 PCIe", 756e12, 51e12),
    ("NVIDIA H200", 989e12, 67e12),
    ("cpu", None, None),
])
def test_peak_flops_by_card_name(name, bf16, fp32):
    assert hardware.bf16_peak_flops(name) == bf16
    assert hardware.fp32_peak_flops(name) == fp32
    assert list(hardware.BF16_PEAK_FLOPS)[0] == "h100 pcie"


def test_step_timer_matches_jax(monkeypatch):
    """The port's ``StepTimer`` and the JAX package's, on the same clock
    readings (7 steps through a window of 5), keep the same samples and
    give the same stats."""
    readings = np.cumsum(np.random.default_rng(2).uniform(
        1e-3, 5e-2, 2 * 7)).tolist()
    clock = time.perf_counter

    def run(timer):
        ticks = iter(readings)
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        try:
            assert timer.stats() == {}
            for _ in range(7):
                with timer:
                    pass
        finally:
            monkeypatch.setattr(time, "perf_counter", clock)
        return timer

    port = run(profiling.StepTimer(window=5))
    ref = run(jax_profiling.StepTimer(window=5))
    assert len(port.samples) == 5 and port.samples == ref.samples
    assert port.stats() == ref.stats()
    assert set(port.stats()) == {"mean_ms", "p50_ms", "p99_ms", "fps"}


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path)):
        torch.ones(8).sum()
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(tmp_path / traces[0]) as f:
        assert "traceEvents" in json.load(f)
