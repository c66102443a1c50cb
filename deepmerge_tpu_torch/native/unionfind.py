"""Python face of the native union-find (with transparent fallback).

``connected_labels(n, edges)`` — dense connected-component labels, identical
semantics to ``deepmerge_tpu_torch.infer.merge.UnionFind`` (deterministic min-root
relabel) but in C++: the merge engine unions millions of edges per round on
mosaic-scale scenes.
"""

from __future__ import annotations

import numpy as np

from deepmerge_tpu_torch.native import build

_ext = build.load("_unionfind")


def available() -> bool:
    return _ext is not None


def connected_labels(n: int, edges: np.ndarray) -> tuple[np.ndarray, int]:
    if _ext is None:
        raise RuntimeError("native unionfind unavailable")
    e = np.ascontiguousarray(np.asarray(edges, np.int64).reshape(-1, 2))
    # the extension takes any buffer ('y*') — pass the array's memory
    # directly; tobytes() would memcpy tens of MB per merge round on
    # mosaic-scale edge lists
    buf = memoryview(e).cast("B") if e.size else b""
    raw, k = _ext.connected_labels(int(n), buf)
    return np.frombuffer(raw, np.int32).copy(), int(k)
