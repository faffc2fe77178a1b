"""The port's serving slice end to end on the CPU, against the JAX
package's: estimator maps and packed decode on the same weights and
frames, the HTTP server, and a JAX-free import of the whole port.

Maps are float32 forwards on both sides, held within rtol 1e-4 and
atol 1e-4 * max|reference| (the conv sums run in another order; see
tests/test_torch_models.py). The decode of those maps must be equal.
"""

import ast
import inspect
import json
import os
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from torch_ekpose_tpu.decode import device as D  # noqa: E402
from torch_ekpose_tpu.decode.synthetic import canonical_humans  # noqa: E402
from torch_ekpose_tpu.runtime import PoseEstimator as JaxEstimator  # noqa: E402
import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu_torch.decode import device as PD  # noqa: E402
from torch_ekpose_tpu_torch.runtime.checkpoint import state_dict_from_jax  # noqa: E402
from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator  # noqa: E402
from torch_ekpose_tpu_torch.runtime.server import PoseServer  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

FRAMES = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                           dtype=np.uint8)


@pytest.fixture(scope="module")
def estimators(vgg_model_and_vars):
    variables = jax.device_get(vgg_model_and_vars[1])
    port = PoseEstimator("vgg2016", state_dict_from_jax(variables),
                         device="cpu", compute_dtype=torch.float32,
                         dest_size=64)
    ref = JaxEstimator("vgg2016", variables, compute_dtype=jnp.float32,
                       decode_backend="jax", dest_size=64)
    return port, ref


def test_estimate_batch_maps_and_decode_match_jax(estimators):
    port, ref = estimators
    humans = port.estimate_batch(FRAMES)
    assert len(humans) == 2
    assert [canonical_humans(h) for h in humans] == [
        canonical_humans(h) for h in ref.estimate_batch(FRAMES)]

    paf, heat = port.get_outputs_batch(FRAMES)
    paf_ref, heat_ref = ref.get_outputs_batch(FRAMES)
    assert paf.shape == (2, 8, 8, 38) and heat.shape == (2, 8, 8, 19)
    for got, want in ((paf, paf_ref), (heat, heat_ref)):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())

    # the port's decode of these maps == JAX's decode of the same maps
    cfg = port.config
    packed = PD.build_packed_decoder(cfg)(
        torch.from_numpy(heat), torch.from_numpy(paf)).numpy()
    packed_ref = np.asarray(D.build_packed_decoder(
        cfg, batched=True, pallas=False)(jnp.asarray(heat), jnp.asarray(paf)))
    assert inputs.packed_mismatches(
        packed, packed_ref, cfg.DECODE.max_peaks_per_part,
        cfg.DECODE.max_people * 3, rtol=1e-6) == []


def test_estimator_refuses_unported_options():
    """s2d_blocks is rejected naming its ROADMAP item; int8 serves the vgg
    family only, as in the JAX package."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PoseEstimator(device="cpu", s2d_blocks=1)
    with pytest.raises(ValueError, match="vgg family"):
        PoseEstimator("mobilenet_thin", device="cpu", compute_dtype="int8")
    with pytest.raises(ValueError, match="compute_dtype"):
        PoseEstimator(device="cpu", compute_dtype="int4")
    with pytest.raises(ValueError, match="precision"):
        PoseEstimator(device="cpu", precision="medium")
    with pytest.raises(ValueError, match="decode_backend"):
        PoseEstimator(device="cpu", decode_backend="oracle")


def test_estimator_defaults_are_the_jax_packages():
    """The card unless the caller asks for the CPU; ``decode_backend``
    defaults to ``"auto"`` as in the JAX package, and every backend name
    of ``decode/api.py`` is taken (``"jax"`` is the device decode)."""
    params = inspect.signature(PoseEstimator).parameters
    assert params["device"].default == "cuda"
    assert params["decode_backend"].default == inspect.signature(
        JaxEstimator).parameters["decode_backend"].default == "auto"
    for name, want in (("auto", "auto"), ("numpy", "numpy"),
                       ("native", "native"), ("device", "device"),
                       ("jax", "device")):
        est = PoseEstimator(device="cpu", decode_backend=name,
                            compute_dtype=torch.float32)
        assert est.decode_backend == want


@pytest.fixture(scope="module")
def server(estimators):
    srv = PoseServer(estimators[0], port=0, max_batch=4,
                     max_wait_ms=50.0).start()
    yield srv
    srv.stop()


def test_server_healthz(server):
    url = f"http://127.0.0.1:{server.port}/healthz"
    with urllib.request.urlopen(url, timeout=30) as resp:
        payload = json.loads(resp.read())
    assert payload == {"status": "ok", "model": "vgg2016", "device": "cpu"}


def test_server_pose_png(server):
    cv2 = pytest.importorskip("cv2")
    ok, png = cv2.imencode(".png", FRAMES[0][:48])
    assert ok
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}/pose", data=png.tobytes(),
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        payload = json.loads(resp.read())
    assert payload["humans"] == []
    assert payload["image_size"] == [48, 64]
    assert payload["padded_size"] == [48, 64]


def test_server_concurrent_submits(server):
    """Four threads submit at once; each gets its own answer, and the
    worker batches them."""
    results, errors = [None] * 4, []

    def call(i):
        try:
            results[i] = server.submit(FRAMES[i % 2], timeout=120)
        except Exception as e:  # reported by the assert below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    for humans, scale, padded in results:
        assert humans == [] and scale == 1.0 and tuple(padded) == (64, 64)


#: modules the port gained with on-card augmentation, the flax reader,
#: int8 serving, the parallel layer and the AOT artifact; the import
#: check must reach each
NEW_MODULES = ("cli.export", "data.device_aug", "data.raw_cache",
               "decode.legacy", "models.quant", "runtime.flax_msgpack",
               "parallel", "parallel.mesh", "parallel.inference",
               "parallel.spatial", "runtime.aot", "decode.synthetic",
               "utils.hardware", "utils.profiling")


def test_port_imports_without_jax():
    """Every module of the port (the ones in ``NEW_MODULES`` among them)
    imports with jax, flax, msgpack and the JAX package
    (``torch_ekpose_tpu``, ``torch_ekpose_tpu.*``) absent: the card has
    none of them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import torch_ekpose_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'msgpack', 'torch_ekpose_tpu'))\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n"
    )
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 63
    assert {f"torch_ekpose_tpu_torch.{m}" for m in NEW_MODULES} <= set(names)


@pytest.mark.parametrize("path", ["chip_smoke.py",
                                  "tests/torch_port_inputs.py",
                                  "tests/torch_parallel_workers.py",
                                  "tests/test_torch_gpu.py",
                                  "scripts/profile_torch_conv.py",
                                  "scripts/profile_torch_decode.py",
                                  "scripts/profile_torch_kernels.py",
                                  "scripts/profile_torch_match.py",
                                  "scripts/profile_torch_nms.py",
                                  "scripts/profile_torch_aot.py"])
def test_card_checks_name_only_the_port(path):
    """The card-side scripts, tests and the inputs they load import
    neither JAX nor the JAX package: the card has no JAX."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir)
    with open(os.path.join(root, path)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert names and not [
        n for n in names
        if n.split(".")[0] in ("jax", "jaxlib", "flax", "torch_ekpose_tpu")
    ]


def test_chip_smoke_refuses_without_card():
    """Without a CUDA card the smoke exits non-zero and prints no
    result line."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir)
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=120,
                         cwd=root, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_serve_cli_refuses_unported_dtype():
    """The serving CLI parses the reference's flags and refuses int8 for
    a model the int8 mode does not cover (a ds name, as the JAX package
    does) instead of serving bf16 under an int8 label."""
    from torch_ekpose_tpu_torch.cli import serve

    args = serve.build_parser().parse_args(
        ["-m", "vgg2016", "--device", "cpu", "--dtype", "float32",
         "--port", "0"])
    assert (args.model, args.device, args.dtype, args.port) == (
        "vgg2016", "cpu", "float32", 0)
    with pytest.raises(ValueError, match="int8"):
        serve.main(["--device", "cpu", "--dtype", "int8", "-m",
                    "mobilenet_thin"])
