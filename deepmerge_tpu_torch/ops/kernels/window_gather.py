"""Per-point window gather (kernel K1) and its plain PyTorch version.

Counterpart of ``deepmerge_tpu/ops/pallas/window_gather.py``. The scene is
viewed 2-D as (H, W·C) uint8 so each window row is one contiguous byte run;
``starts`` holds each point's (row, byte column) origin. The JAX package
aligns origins down to the TPU's (32, 128) tile grid and gathers a slightly
larger window, folding the residual offset into the resize weights; the port
keeps exactly that geometry (``ops/patches.py``), so its patches are
bit-identical, while the CUDA kernel itself accepts any in-bounds origin.
"""

from __future__ import annotations

import ctypes

import torch

from deepmerge_tpu_torch.ops.kernels import build

ROW_ALIGN = 32     # row alignment of the JAX package's window origins
LANE_ALIGN = 128   # byte-column alignment of the same

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # scene, pitch, starts, n_points, rows, cols, vec, out, stream
    "dm_window_gather": [_P, _LL, _P, _I, _I, _I, _I, _P, _P],
}


def gather_windows_ref(scene2d: torch.Tensor, starts: torch.Tensor,
                       rows: int, cols: int) -> torch.Tensor:
    """Plain version: ``out[i] = scene2d[y:y+rows, x:x+cols]`` for
    ``(y, x) = starts[i]``, by advanced indexing."""
    ri = starts[:, 0:1].long() + torch.arange(rows, device=starts.device)
    ci = starts[:, 1:2].long() + torch.arange(cols, device=starts.device)
    return scene2d[ri[:, :, None], ci[:, None, :]]


_VECTOR_WIDTHS = (16, 8, 4)


def _check(scene2d, starts, rows, cols) -> tuple[int, ...]:
    """Validate the arguments; return which copy widths (of
    ``_VECTOR_WIDTHS``) divide every origin column. One device sync."""
    if scene2d.dtype != torch.uint8 or scene2d.dim() != 2:
        raise TypeError(f"scene2d must be 2-D uint8, got {scene2d.dtype} "
                        f"{tuple(scene2d.shape)}")
    if starts.dtype != torch.int32 or starts.dim() != 2 or starts.shape[1] != 2:
        raise TypeError(f"starts must be (B, 2) int32, got {starts.dtype} "
                        f"{tuple(starts.shape)}")
    if starts.device != scene2d.device:
        raise ValueError("starts and scene2d must be on the same device")
    if rows <= 0 or cols <= 0:
        raise ValueError(f"window must be non-empty, got {rows}x{cols}")
    if starts.shape[0] == 0:
        return _VECTOR_WIDTHS
    h, w = scene2d.shape
    col = starts[:, 1]
    y_lo, x_lo, y_hi, x_hi, *misaligned = torch.stack(
        [starts[:, 0].amin(), col.amin(), starts[:, 0].amax(), col.amax()]
        + [(col % v).amax() for v in _VECTOR_WIDTHS]
    ).tolist()
    if y_lo < 0 or x_lo < 0 or y_hi + rows > h or x_hi + cols > w:
        raise ValueError(
            f"window origins out of bounds: rows {y_lo}..{y_hi}+{rows} of "
            f"{h}, byte columns {x_lo}..{x_hi}+{cols} of {w}"
        )
    return tuple(v for v, m in zip(_VECTOR_WIDTHS, misaligned) if m == 0)


def _vector_width(scene2d, cols, out, origin_widths) -> int:
    """Largest copy width in bytes that divides every address the kernel
    forms: the row pitch, the window width, each origin column and both
    base pointers."""
    for vec in origin_widths:
        if (scene2d.stride(0) % vec == 0 and cols % vec == 0
                and scene2d.data_ptr() % vec == 0
                and out.data_ptr() % vec == 0):
            return vec
    return 1


def gather_windows(scene2d: torch.Tensor, starts: torch.Tensor,
                   rows: int, cols: int,
                   trusted_origins: bool = False) -> torch.Tensor:
    """Gather per-point windows: (B, rows, cols) uint8.

    Args:
      scene2d: (H, W·C) uint8 — the staged scene's rows, channel-flattened.
      starts: (B, 2) int32 — per-point (row, byte column) origins; every
        window must lie inside ``scene2d`` (checked, raises otherwise).
      rows, cols: window extent.
      trusted_origins: the caller guarantees that every window lies inside
        ``scene2d`` and that every byte column is a multiple of
        ``LANE_ALIGN``, as ``ops/patches`` forms them for points inside
        the scene. Skips the check and its device sync (the training
        steps run without host synchronisation).

    CPU tensors run ``gather_windows_ref``. CUDA tensors launch the CUDA
    kernel (``csrc/window_gather.cu``) and count the launch in
    ``gather_windows.launches``.
    """
    if trusted_origins:
        origin_widths = _check(scene2d, starts[:0], rows, cols)
    else:
        origin_widths = _check(scene2d, starts, rows, cols)
    if scene2d.device.type == "cpu":
        return gather_windows_ref(scene2d, starts, rows, cols)
    if scene2d.device.type != "cuda":
        raise ValueError(f"unsupported device {scene2d.device}")
    if scene2d.stride(1) != 1 or not starts.is_contiguous():
        raise ValueError("scene2d rows and starts must be contiguous")
    b = starts.shape[0]
    out = torch.empty((b, rows, cols), dtype=torch.uint8, device=scene2d.device)
    if b == 0:
        return out
    lib = build.load("window_gather", _SIGNATURES)
    vec = _vector_width(scene2d, cols, out, origin_widths)
    stream = torch.cuda.current_stream(scene2d.device).cuda_stream
    err = lib.dm_window_gather(
        scene2d.data_ptr(), scene2d.stride(0), starts.data_ptr(), b,
        rows, cols, vec, out.data_ptr(), stream,
    )
    build.check(lib, err, "dm_window_gather")
    gather_windows.launches += 1
    return out


gather_windows.launches = 0
