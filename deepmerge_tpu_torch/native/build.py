"""On-demand build of the native extensions (g++, CPython C API).

``ensure_built()`` compiles each .cpp into the package directory once and
caches the result (``*.so`` is gitignored); consumers fall back to pure
Python when the toolchain is missing. No pybind11 in the image — the
extensions use the raw C API. Several processes may build at once (the
test workers of a fresh checkout): each compiles to a file of its own and
renames it into place, so no process ever sees a partly written library.
"""

from __future__ import annotations

import os
import subprocess
import sysconfig
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()

_EXTENSIONS = {
    "_unionfind": "unionfind.cpp",
    "_rastercodec": "rastercodec.cpp",
}


def _so_path(name: str) -> str:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(_HERE, name + suffix)


def ensure_built(name: str) -> str | None:
    """Build extension ``name`` if needed; returns the .so path or None."""
    src = os.path.join(_HERE, _EXTENSIONS[name])
    out = _so_path(name)
    with _LOCK:
        if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
            return out
        include = sysconfig.get_paths()["include"]
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_HERE)
        os.close(fd)
        cmd = [
            "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
            f"-I{include}", src, "-o", tmp,
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
        except (OSError, subprocess.SubprocessError):
            return None
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out


def load(name: str):
    """Import a native extension, building it first. Returns None on failure.

    The extension is imported as a submodule of this package
    (``deepmerge_tpu_torch.native._unionfind``), so it never shares a
    ``sys.modules`` entry with another package's build of the same source.
    """
    if ensure_built(name) is None:
        return None
    try:
        import importlib

        return importlib.import_module(f"{__package__}.{name}")
    except Exception:
        return None
