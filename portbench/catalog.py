"""Finds the benchmark's parts by name: ``BENCHMARK.json`` at the root of
the checkout, and under ``portbench/`` one file per configuration
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``), cell's
correctness limits (``limits/<workload>.json``) and per-layer metric
(``metrics/<name>.py``, a ``read(run)`` function). A later cell, mix or
metric is a new file; no file here names one."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

__all__ = ["HERE", "REPO", "load_benchmark", "load_config", "load_limits",
           "load_reader", "load_traffic", "workload"]

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _file(root: Path, folder: str, name: str, suffix: str) -> Path:
    if not _NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    path = Path(root) / folder / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return path


def load_benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(name: str, root: Path = HERE) -> dict:
    with open(_file(root, "configs", name, ".json")) as f:
        return json.load(f)


def load_traffic(name: str, root: Path = HERE) -> dict:
    with open(_file(root, "traffic", name, ".json")) as f:
        return json.load(f)


def load_limits(name: str, root: Path = HERE) -> dict:
    with open(_file(root, "limits", name, ".json")) as f:
        return json.load(f)


def load_reader(name: str, root: Path = HERE):
    """The ``read(run)`` function of metric ``name``: it returns the
    metric's value, or None where the run holds nothing to read."""
    path = _file(root, "metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
