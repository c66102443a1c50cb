"""The kernels' build (``deepmerge_tpu_torch/ops/kernels/build.py``) with a
stand-in compiler, on the CPU: ``start`` returns while the builds run,
``load`` of a source that is built does not wait on one still compiling,
and two requests for one source compile it once.

The stand-in is a script in nvcc's place: it appends its source's name to
a log, sleeps as long as the source's first line says, then writes its
output (``-o``). ``build._open`` is replaced by a stub, since the output is
no shared library."""

import os
import stat
import sys
import threading
import time
import types

import pytest

from deepmerge_tpu_torch.ops.kernels import build

COMPILER = f"""#!{sys.executable}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
src = args[-1]
with open(src + ".log", "a") as f:
    f.write("compiled\\n")
time.sleep(float(open(src).readline()))
open(out, "w").write("built " + src)
"""


@pytest.fixture
def stand_in(tmp_path, monkeypatch):
    """csrc/ with a quick source (0 s) and a slow one (3 s), an empty build
    directory and the stand-in compiler; returns the source directory."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "quick.cu").write_text("0\n")
    (csrc / "slow.cu").write_text("3\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(COMPILER)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(build, "_open", lambda name: types.SimpleNamespace())
    monkeypatch.setattr(build, "_loaded", {})
    yield csrc
    build.wait(["quick", "slow"])


def _compiles(csrc, name):
    log = csrc / f"{name}.cu.log"
    return len(log.read_text().splitlines()) if log.exists() else 0


def test_started_build_returns_at_once(stand_in):
    t = time.perf_counter()
    build.start(["slow"])
    assert time.perf_counter() - t < 1.5
    assert not build.library_path("slow").exists()
    build.wait(["slow"])
    assert build.library_path("slow").exists()
    assert not [f for f in os.listdir(build.BUILD_DIR)
                if f.startswith("tmp")]


def test_load_of_a_built_source_does_not_wait(stand_in):
    build.build_all(["quick"])
    build.start(["slow"])
    t = time.perf_counter()
    build.load("quick", {})
    assert time.perf_counter() - t < 1.5
    assert not build.library_path("slow").exists()
    build.load("slow", {})  # waits for its build
    assert build.library_path("slow").exists()
    assert _compiles(stand_in, "quick") == 1


def test_two_requests_compile_a_source_once(stand_in):
    build.start(["slow"])
    build.start(["slow", "quick"])
    threads = [threading.Thread(target=build.load, args=("slow", {}))
               for _ in range(2)]
    for th in threads:
        th.start()
    build.load("slow", {})
    for th in threads:
        th.join()
    build.build_all(["slow", "quick"])
    assert _compiles(stand_in, "slow") == 1
    assert _compiles(stand_in, "quick") == 1
    assert build.library_path("slow").read_text().startswith("built ")
