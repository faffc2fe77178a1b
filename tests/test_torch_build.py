"""``ops/_build.py``'s build steps, with a stand-in for nvcc: every
source compiles in its own process, all at once, then one link makes the
library; a failing source raises with its output and leaves nothing."""

import os
import stat
import textwrap

import pytest

from torch_ekpose_tpu_torch.ops import _build

# Writes the -o target and a ptxas-like line. A compile (-c) first marks
# itself started, then waits until every source has started: the build
# only finishes if the compiles run at the same time.
FAKE_NVCC = textwrap.dedent("""\
    #!/bin/bash
    out=""; prev=""; compile=0
    for a in "$@"; do
      [ "$prev" = "-o" ] && out="$a"
      [ "$a" = "-c" ] && compile=1
      prev="$a"
    done
    src="${@: -1}"
    if [ "$compile" = 1 ]; then
      touch "@MARKS@/$(basename "$src")"
      case "$src" in *@FAIL@) echo "error: no such thing in $src"; exit 2;; esac
      for i in $(seq 200); do
        [ "$(ls @MARKS@ | wc -l)" -ge @N@ ] && break
        sleep 0.05
      done
      [ "$(ls @MARKS@ | wc -l)" -ge @N@ ] || exit 3
    fi
    echo "ptxas info    : $(basename "$src")" >&2
    echo built > "$out"
    """)


def _fake_cuda(tmp_path, monkeypatch, fail="-none-"):
    marks = tmp_path / "marks"
    marks.mkdir()
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC.replace("@FAIL@", fail)
                    .replace("@MARKS@", str(marks))
                    .replace("@N@", str(len(_build.SOURCES))))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")


def test_build_compiles_sources_together_then_links(tmp_path, monkeypatch):
    _fake_cuda(tmp_path, monkeypatch)
    path = _build.build()
    assert path == _build.library_path() and path.read_text() == "built\n"
    report = _build.build_report()
    for name in _build.SOURCES:
        assert f"ptxas info    : {name}" in report
    assert f"ptxas info    : {os.path.splitext(_build.SOURCES[-1])[0]}.o" \
        in report                                  # the link's own output
    assert sorted(os.listdir(_build.BUILD_DIR)) == sorted(
        [path.name, path.with_suffix(".log").name])


def test_build_failure_raises_and_leaves_nothing(tmp_path, monkeypatch):
    _fake_cuda(tmp_path, monkeypatch, fail="conv_chain.cu")
    with pytest.raises(RuntimeError, match="no such thing in .*conv_chain"):
        _build.build()
    assert os.listdir(_build.BUILD_DIR) == []
