"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` compiles it in seconds into a shared library under
``build/deepmerge_tpu_torch/`` at the repository root. The library name
carries a hash of the source and the flags, so an edited source rebuilds and
an unchanged one loads the cached build. ``start`` sets builds going and
returns; ``load`` of one source waits only for that source's build. A build
error raises; nothing falls back to another implementation.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "deepmerge_tpu_torch"

# --split-compile=0: nvcc optimizes a source's kernels in parallel threads
# (as many as the machine has). The largest source (fused_block_q8.cu, 75
# kernels) sets the pace of the sources built together: chip_smoke.py's
# build took 49.9 s with it against 98.5 s without on an 8-core H100 host
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "--split-compile=0",
)

_lock = threading.Lock()  # guards _loaded and _jobs, never held on nvcc
_loaded: dict[str, ctypes.CDLL] = {}
# nvcc/ptxas output of each build made in this process, by kernel name
build_logs: dict[str, str] = {}


class _Job:
    """One ``nvcc`` process compiling ``csrc/<name>.cu`` into ``tmp``,
    renamed to ``out`` once it succeeds. ``finish`` waits for it, once
    whoever calls it first (its own lock), and returns the error text or
    None."""

    def __init__(self, name: str, out: Path, tmp: str, proc):
        self.name, self.out, self.tmp, self.proc = name, out, tmp, proc
        self.lock = threading.Lock()
        self.done = False
        self.error = None

    def finish(self):
        with self.lock:
            if not self.done:
                build_logs[self.name] = self.proc.communicate()[0]
                if self.proc.returncode == 0:
                    os.replace(self.tmp, self.out)
                else:
                    self.error = (f"nvcc failed to build {self.name}.cu "
                                  f"(exit {self.proc.returncode}):\n"
                                  f"{build_logs[self.name]}")
                if os.path.exists(self.tmp):
                    os.unlink(self.tmp)
                self.done = True
                with _lock:
                    _jobs.pop(self.name, None)
        return self.error


# the builds under way, by kernel name
_jobs: dict[str, _Job] = {}


@atexit.register
def _stop_builds() -> None:
    """Ends the builds still under way when the process exits (an error
    elsewhere left them unwaited): no nvcc outlives its caller."""
    for job in list(_jobs.values()):
        job.proc.kill()
        job.proc.wait()
        if os.path.exists(job.tmp):
            os.unlink(job.tmp)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of deepmerge_tpu_torch are built from source at first use"
    )


def library_path(name: str) -> Path:
    """The cached build of ``csrc/<name>.cu``: its name hashes the source,
    every shared header of ``csrc/`` and the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def start(names) -> None:
    """Start one ``nvcc`` process for every ``csrc/<name>.cu`` of ``names``
    whose cached build is missing and that is not compiling already, and
    return at once: ``wait`` (or ``load``) waits for them."""
    with _lock:
        missing = [(n, library_path(n)) for n in names if n not in _jobs]
        missing = [(n, out) for n, out in missing if not out.exists()]
        if not missing:
            return
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for name, out in missing:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            _jobs[name] = _Job(name, out, tmp, proc)


def wait(names) -> None:
    """Wait for the builds of ``names`` that are under way (a source built
    already, or not started, returns at once). Raises ``RuntimeError``
    with the compiler output if any of them fails."""
    with _lock:
        jobs = [_jobs[n] for n in names if n in _jobs]
    failed = [e for e in (job.finish() for job in jobs) if e is not None]
    if failed:
        raise RuntimeError("\n".join(failed))


def build_all(names) -> None:
    """Compile every ``csrc/<name>.cu`` of ``names`` whose cached build is
    missing, one ``nvcc`` process each, all started together (``start``),
    and wait for them. Raises ``RuntimeError`` with the compiler output if
    any build fails."""
    start(names)
    wait(names)


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its cached build is missing (or wait
    for its build if one is under way; other sources' builds do not hold
    it up), then load it and declare ``signatures`` (entry point -> ctypes
    argument types; each returns a CUDA error code as ``int``). Raises ``RuntimeError`` with the
    compiler output on a failed build."""
    if name not in _loaded:
        build_all([name])
    with _lock:
        lib = _loaded.get(name) or _open(name)
        _loaded[name] = lib
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        return lib


def _open(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library_path(name)))
    lib.dm_error_string.argtypes = [ctypes.c_int]
    lib.dm_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code (the
    entry points return ``cudaGetLastError()`` after their launches)."""
    if err != 0:
        msg = lib.dm_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
