"""Python face of the native TIFF codecs (with transparent fallback).

``lzw_decode``/``unpackbits`` are bit-exact C++ versions of the pure-Python
decoders in ``geodata.geotiff`` (the reference's raster substrate is GDAL's
C++ codecs, ``MyUtils1.py:319-323``). Both release the GIL, so the reader's
thread-pool block decode gets real parallelism.
"""

from __future__ import annotations

from deepmerge_tpu_torch.native import build

_ext = build.load("_rastercodec")


def available() -> bool:
    return _ext is not None


def lzw_decode(data: bytes, expected: int) -> bytes:
    if _ext is None:
        raise RuntimeError("native rastercodec unavailable")
    return _ext.lzw_decode(data, int(expected))


def unpackbits(data: bytes, expected: int) -> bytes:
    if _ext is None:
        raise RuntimeError("native rastercodec unavailable")
    return _ext.unpackbits(data, int(expected))
