"""The exact patch stage of one scale slot in one kernel launch (kernel K1,
redesigned for Hopper), and its plain PyTorch version.

For a batch of sample points and one slot, ``patch_resize`` computes what
the exact path of ``ops/patches`` computes (uint8 rounding on, caps up to
256): each point's window origin in the JAX package's geometry
(``window_starts``), the crop and cv2 INTER_AREA resize as a row pass and a
column pass, the cv2 uint8 rounding and the product with 1/255, written
straight into the (B, p, p, co) patches. The CUDA kernel
(``csrc/patch_resize.cu``) replaces the TPU's window gather
(``deepmerge_tpu/ops/pallas/window_gather.py`` ``_gather_kernel``) together
with the two products and the rounding chain around it
(``deepmerge_tpu/ops/patches.py:275-322``).

Exactness. The INTER_AREA weights scaled by the window side s
(``resize_weights(...) * s``) are integers for the row pass once rounded to
bf16, as the JAX package rounds them (every s <= 256 at out 16..128), and so
are the uint8 pixels: every product and sum of the row pass is an exact
float32 integer below 2^24, in any order. The column weights stay float32,
and most of them are not integers (at out 128, 120 of the 128 window sides
have one that is not): the patches depend on those values bit for bit, and
integer-rounded column weights change pixels. The order of the column sum
moves x2 by an ulp or so, which the rounding to uint8 absorbs in practice;
the kernel sums in ascending source order. So the kernel takes its weights
from ``resize_weights`` itself (``resize_taps``) and never re-derives them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from deepmerge_tpu_torch.ops.kernels import build
from deepmerge_tpu_torch.ops.kernels import window_gather
from deepmerge_tpu_torch.ops.kernels.window_gather import (
    ROW_ALIGN,
    gather_windows_ref,
    pixel_align,
    window_starts,
)
from deepmerge_tpu_torch.ops.resize import resize_weights

# The JAX package's compiler turns ``x / 255.0`` into ``x * (1/255)``; the
# same float32 reciprocal keeps the patches bit-identical.
INV_255 = float(np.float32(1.0) / np.float32(255.0))

MAX_CAP = 256      # the exact path's largest window side (the sums < 2^24)
MAX_OUT = 256
CHANNELS = (1, 2, 4, 8)   # staged channel counts
OUT_DTYPES = (torch.float32, torch.bfloat16)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # scene, pitch, C, centers, scales, scale_stride, n_points, cap, out, pad,
    # a_px, co, first, w_rows, w_cols, taps, vec, out_bf16, out, plan, stream
    "dm_patch_resize": [_P, _LL, _I, _P, _P, _LL, _I, _I, _I, _I, _I, _I,
                        _P, _P, _P, _I, _I, _I, _P, _P, _P],
}

# ------------------------------------------------------------ launch plan
#
# One CTA of THREADS threads per (point, tile of output rows); the tile's
# row-pass result (tile rows x the window's columns, float32) lives in
# shared memory at a row stride of cap·C + 32 floats (the 16-byte load units
# overhang the window's columns by up to 15 bytes at each end). Tiles of 16
# rows, fewer where 16 would pass the 48 KB a CTA takes without opting in.
# The C entry point refuses any other plan.

THREADS = 256
TILE_ROWS = (16, 8, 4, 2, 1)
CTA_SHARED = 48 * 1024


def patch_resize_plan(cap: int, out: int, channels: int) -> dict:
    """The launch of ``patch_resize`` for window cap ``cap``, patch side
    ``out`` and ``channels`` staged channels: ``ints`` (tile rows, threads,
    shared bytes) as the C entry point takes them, the shared row stride in
    floats and the tiles a point. Raises ``ValueError`` for a shape the
    kernel does not take."""
    if not (2 <= cap <= MAX_CAP and cap % 2 == 0):
        raise ValueError(f"patch_resize takes even caps 2..{MAX_CAP}, "
                         f"got {cap}")
    if not 1 <= out <= MAX_OUT:
        raise ValueError(f"patch_resize takes patch sides 1..{MAX_OUT}, "
                         f"got {out}")
    if channels not in CHANNELS:
        raise ValueError(f"patch_resize takes {CHANNELS} staged channels, "
                         f"got {channels}")
    stride = -(-(cap * channels + 32) // 4) * 4
    tile = min(next(t for t in TILE_ROWS if t * stride * 4 <= CTA_SHARED), out)
    smem = tile * stride * 4
    return dict(ints=(tile, THREADS, smem), tile_rows=tile, threads=THREADS,
                smem=smem, stride=stride, tiles=-(-out // tile))


# --------------------------------------------------------- the tap table

class Taps(NamedTuple):
    """Per window side s = 1..cap and output index o (row s - 1): the first
    source index with a nonzero weight and ``taps`` weights from there on,
    zero past the last nonzero one. The same table serves rows and columns:
    ``rows`` holds the row pass's bf16-rounded weights, ``cols`` the column
    pass's float32 ones, each scaled by s."""

    first: torch.Tensor   # (cap, out) int32
    rows: torch.Tensor    # (cap, out, taps) float32 (bf16 values)
    cols: torch.Tensor    # (cap, out, taps) float32
    taps: int


def resize_taps(out: int, cap: int, device="cpu") -> Taps:
    """The tap table of patch side ``out`` for window sides 1..``cap``.

    Built from ``resize_weights`` at offset 0: the weights depend on the
    offset only through the integer ``j - offset``, so the weights at any
    offset are these, shifted, bit for bit. Computed on the CPU, then moved
    to ``device``.
    """
    dense, firsts, lasts = [], [], []
    for s0 in range(1, cap + 1, 32):   # bounds the (32, out, cap) slabs
        s = torch.arange(s0, min(s0 + 32, cap + 1), dtype=torch.int32)
        w = resize_weights(out, cap, s, torch.zeros_like(s))
        w = w * s.to(torch.float32)[:, None, None]
        nz = (w != 0).to(torch.int8)
        dense.append(w)
        firsts.append(nz.argmax(-1))
        lasts.append(cap - 1 - nz.flip(-1).argmax(-1))
    w, first, last = (torch.cat(t) for t in (dense, firsts, lasts))
    taps = int((last - first).max()) + 1
    idx = first[..., None] + torch.arange(taps)
    cols = torch.where(idx <= last[..., None],
                       w.gather(-1, idx.clamp(max=cap - 1)), 0.0)
    rows = cols.to(torch.bfloat16).to(torch.float32)
    return Taps(first.to(device, torch.int32), rows.to(device),
                cols.to(device), taps)


# ------------------------------------------------------------ plain version

def _left_top(center: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Window origin ``int(center - scale/2)``, truncated toward zero."""
    v = center.to(torch.float32) - scale.to(torch.float32) / 2.0
    return torch.trunc(v).to(torch.int32)


def slot_geometry(centers: torch.Tensor, scales: torch.Tensor, cap: int,
                  pad: int, channels: int):
    """One slot's window geometry: ``(starts, s, off_y, off_x)``, the
    gather origins of ``window_starts``, the window sides clamped to
    1..``cap``, and where each adaptive window starts inside its aligned
    window (row, pixel column)."""
    starts, y0a, px0a = window_starts(centers, cap, pad, channels)
    s = torch.clamp(scales, 1, cap)
    # window index of original coord y is y - (y0a - pad)
    off_y = _left_top(centers[:, 0], s) - y0a + pad
    off_x = _left_top(centers[:, 1], s) - px0a + pad
    return starts, s, off_y, off_x


def resize_windows_exact(windows: torch.Tensor, s, off_y, off_x, out: int,
                         channels: int, out_dtype=torch.float32):
    """The exact path's crop + resize of gathered (B, rows, cols) uint8
    windows into (B, out, out, C) patches, as two float32 products (TF32
    off): the row weights scaled by s and rounded to bf16 (integers), the
    column weights scaled by s in float32, one divide by s² at the end with
    the integer tie correction that makes the rounding floor(x2/s² + ½)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, win_rows, row_bytes = windows.shape
    win_px = row_bytes // channels
    s32 = s.to(torch.float32)[:, None, None]
    kr = (resize_weights(out, win_rows, s, off_y) * s32).to(torch.bfloat16)
    kc = resize_weights(out, win_px, s, off_x) * s32
    win = windows.to(torch.float32)
    x1 = torch.bmm(kr.to(torch.float32), win)  # (b, out, win_px*c)
    x1 = x1.reshape(b, out, win_px, channels)
    x2 = torch.einsum("bpj,bojc->bopc", kc, x1)
    s2 = s32[..., None] ** 2
    k = torch.floor(x2 / s2 + 0.5)
    # k·s² is an exact integer, and x2 - k·s² is exact (the two lie within
    # a factor of two of each other), so these sign tests move k exactly to
    # floor(x2/s² + ½) of the float32 x2
    d2 = 2.0 * (x2 - k * s2)
    k = k + (d2 >= s2).to(torch.float32)
    k = k - (d2 < -s2).to(torch.float32)
    return (k * INV_255).to(out_dtype)


def patch_resize_ref(padded_scene: torch.Tensor, centers: torch.Tensor,
                     scales: torch.Tensor, cap: int, out: int, pad: int,
                     out_channels: int | None = None,
                     out_dtype=torch.float32, chunk: int = 256):
    """Plain version of ``patch_resize``: per ``chunk`` points (bounding the
    float32 windows' memory), ``gather_windows_ref`` and
    ``resize_windows_exact``."""
    c = padded_scene.shape[-1]
    co = c if out_channels is None else out_channels
    scene2d = padded_scene.reshape(padded_scene.shape[0], -1)
    rows, cols = cap + ROW_ALIGN, (cap + pixel_align(c)) * c
    parts = []
    for i in range(0, centers.shape[0], chunk):
        starts, s, off_y, off_x = slot_geometry(
            centers[i : i + chunk], scales[i : i + chunk], cap, pad, c)
        windows = gather_windows_ref(scene2d, starts, rows, cols)
        parts.append(resize_windows_exact(windows, s, off_y, off_x, out, c,
                                          out_dtype)[..., :co])
    if not parts:
        return torch.empty((0, out, out, co), dtype=out_dtype,
                           device=padded_scene.device)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


# ------------------------------------------------------------ the kernel

def _load_width(scene2d: torch.Tensor, window_bytes: int) -> int:
    """Largest load unit in bytes (16, 4 or 1) that divides the row pitch,
    the scene's base address and the window's width; window origins are
    multiples of 128 bytes."""
    for vec in (16, 4):
        if (scene2d.stride(0) % vec == 0 and scene2d.data_ptr() % vec == 0
                and window_bytes % vec == 0):
            return vec
    return 1


def _device_taps(out: int, cap: int, device) -> Taps:
    key = (out, cap, device)
    if key not in patch_resize.tables:
        patch_resize.tables[key] = resize_taps(out, cap, device)
    return patch_resize.tables[key]


def patch_resize(padded_scene: torch.Tensor, centers: torch.Tensor,
                 scales: torch.Tensor, cap: int, out: int, pad: int,
                 out_channels: int | None = None, out_dtype=torch.float32,
                 trusted_origins: bool = False, chunk: int = 256):
    """Exact patches of one slot: (B, out, out, co) ``out_dtype`` in [0, 1].

    Args:
      padded_scene: (H + 2·pad, W + 2·pad, C) uint8, C staged (1, 2, 4, 8).
      centers: (B, 2) int32 pixel centers (row, col) in original coords.
      scales: (B,) int32 adaptive window sides of this slot (any stride).
      cap, out: the slot's window cap (even, <= 256) and patch side.
      pad: the scene's padding, ``scene_pad`` of every slot's cap.
      out_channels: keep the first ``co`` channels (None: all C).
      out_dtype: float32 or bfloat16.
      trusted_origins: the caller checked that every center lies inside
        the scene, so every window lies inside the padded scene. Skips the
        bounds check and its device sync; otherwise windows out of bounds
        raise ``ValueError``.
      chunk: points per pass of the plain version (the CPU path).

    CPU tensors run ``patch_resize_ref``. CUDA tensors launch
    ``csrc/patch_resize.cu``, one launch for all B points, counted in
    ``patch_resize.launches``; a shape the kernel does not take raises.
    """
    if padded_scene.dtype != torch.uint8 or padded_scene.dim() != 3:
        raise TypeError(f"padded_scene must be (H, W, C) uint8, got "
                        f"{padded_scene.dtype} {tuple(padded_scene.shape)}")
    if (centers.dtype != torch.int32 or centers.dim() != 2
            or centers.shape[1] != 2):
        raise TypeError(f"centers must be (B, 2) int32, got {centers.dtype} "
                        f"{tuple(centers.shape)}")
    if scales.dtype != torch.int32 or scales.shape != centers.shape[:1]:
        raise TypeError(f"scales must be (B,) int32, got {scales.dtype} "
                        f"{tuple(scales.shape)}")
    if not (centers.device == scales.device == padded_scene.device):
        raise ValueError("padded_scene, centers and scales must be on the "
                         "same device")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {OUT_DTYPES}")
    c = padded_scene.shape[-1]
    co = c if out_channels is None else out_channels
    if not 1 <= co <= c:
        raise ValueError(f"out_channels must be 1..{c}, got {co}")
    plan = patch_resize_plan(cap, out, c)
    scene2d = padded_scene.reshape(padded_scene.shape[0], -1)
    a_px = pixel_align(c)
    if not trusted_origins:
        starts, _, _ = window_starts(centers, cap, pad, c)
        window_gather._check(scene2d, starts, cap + ROW_ALIGN,
                             (cap + a_px) * c)
    if padded_scene.device.type == "cpu":
        return patch_resize_ref(padded_scene, centers, scales, cap, out, pad,
                                co, out_dtype, chunk)
    if padded_scene.device.type != "cuda":
        raise ValueError(f"unsupported device {padded_scene.device}")
    if not padded_scene.is_contiguous():
        raise ValueError("padded_scene must be contiguous")
    centers = centers.contiguous()
    b = centers.shape[0]
    dst = torch.empty((b, out, out, co), dtype=out_dtype,
                      device=padded_scene.device)
    if b == 0:
        return dst
    taps = _device_taps(out, cap, padded_scene.device)
    lib = build.load("patch_resize", _SIGNATURES)
    stream = torch.cuda.current_stream(padded_scene.device).cuda_stream
    err = lib.dm_patch_resize(
        scene2d.data_ptr(), scene2d.stride(0), c, centers.data_ptr(),
        scales.data_ptr(), scales.stride(0), b, cap, out, pad, a_px, co,
        taps.first.data_ptr(), taps.rows.data_ptr(), taps.cols.data_ptr(),
        taps.taps, _load_width(scene2d, (cap + a_px) * c),
        int(out_dtype == torch.bfloat16), dst.data_ptr(),
        (ctypes.c_int * 3)(*plan["ints"]), stream,
    )
    build.check(lib, err, "dm_patch_resize")
    patch_resize.launches += 1
    return dst


patch_resize.launches = 0
# tap tables by (out, cap, device), built at first use
patch_resize.tables = {}
