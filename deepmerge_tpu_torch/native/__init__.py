"""Native (C++) host-side runtime components.

Built on demand via the CPython C API / ctypes (no pybind11 in the image);
every consumer must degrade gracefully to the pure-Python fallback when the
extension has not been built. See ``deepmerge_tpu_torch/native/build.py``.
"""
