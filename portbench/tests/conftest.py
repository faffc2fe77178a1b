"""Fixtures of the benchmark's CPU tests: a folder of tiny cells (the
benchmark's own configurations in float32, 128x128 frames at batch 2, the
real cells' limits) and a runner of one cell on the CPU.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import json
import shutil
import time

import pytest

from portbench import catalog

#: tiny cell -> (configuration, the real cell whose limits it is held to)
TINY = {
    "mt-crowd": ("mobilenet_thin", "vgg2016-crowd-b8"),
    "mt-empty": ("mobilenet_thin", "mobilenet_thin-empty-b32"),
    "vgg-crowd": ("vgg2016", "vgg2016-crowd-b8"),
}


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(root folder, benchmark dict) of the tiny cells."""
    root = tmp_path_factory.mktemp("tiny")
    for folder in ("configs", "traffic", "limits"):
        (root / folder).mkdir()
    shutil.copytree(catalog.HERE / "metrics", root / "metrics")
    bench = catalog.load_benchmark()
    cells = []
    for name, (config, real) in TINY.items():
        cfg = catalog.load_config(config)
        cfg["dtype"] = "float32"
        (root / "configs" / f"{config}.json").write_text(json.dumps(cfg))
        traffic = catalog.load_traffic(catalog.workload(bench, real)["traffic"])
        size = 64 if config == "vgg2016" else 128
        traffic.update(batch=2, height=size, width=size, pool_batches=2,
                       inflight=2, warm_batches=2, trace_batches=4,
                       check_share=1.0)
        (root / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
        shutil.copy(catalog.HERE / "limits" / f"{real}.json",
                    root / "limits" / f"{name}.json")
        cells.append({"name": name, "config": config, "traffic": name,
                      "chips": 1, "why": "a CPU test"})
    bench["workloads"] = cells
    return root, bench


@pytest.fixture
def run_tiny(tiny):
    """Runs a tiny cell on the CPU: ``run_tiny(name, seed, **options)``."""
    from portbench.run import execute

    root, bench = tiny

    def run(name, seed, seconds=1.5, trace=False, control=False):
        return execute(name, seed, seconds, trace, device="cpu", root=root,
                       bench=bench, control=control, t0=time.perf_counter())

    return run
