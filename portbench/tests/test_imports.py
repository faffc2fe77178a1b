"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the port. Top-level module names are compared whole: the
port's name begins with the JAX package's."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from portbench import catalog

BANNED = {"jax", "jaxlib", "flax", "torch_ekpose_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=catalog.REPO, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=str(catalog.REPO)))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_port_load_no_jax():
    top = _loaded(
        "import portbench.run, portbench.calibrate, portbench.check\n"
        "import portbench.reference.vgg, portbench.reference.mobilenet\n"
        "import portbench.reference.decode\n"
        "import torch_ekpose_tpu_torch.runtime.estimator\n"
        "import torch_ekpose_tpu_torch.ops.nms, torch_ekpose_tpu_torch.ops.match\n"
        "import torch_ekpose_tpu_torch.ops.merge")
    assert "torch_ekpose_tpu_torch" in top
    assert not top & BANNED, top & BANNED


def test_reference_loads_nothing_of_the_port():
    top = _loaded("import portbench.reference.vgg, portbench.reference.mobilenet\n"
                  "import portbench.reference.decode, portbench.reference.common")
    assert "torch" in top
    assert not top & (BANNED | {"torch_ekpose_tpu_torch"})
