"""Multi-scale patch extraction from a device-resident scene (port of
``deepmerge_tpu/ops/patches.py``).

The scene lives zero-padded on the device as uint8. For each sample point
and scale slot, the window gather (kernel K1, ``ops/kernels/window_gather``)
copies a static-cap window whose origin is aligned down exactly as the JAX
package aligns it, and the crop + cv2 INTER_AREA resize runs as two batched
float32 matrix products whose weights (``ops/resize.py``) encode the crop.
The resulting patches are bit-identical to the JAX package's.

Reference semantics (the JAX package's, kept exactly): window top-left
``int(center - scale/2)`` truncated toward zero, zero padding outside the
scene, per-slot resize targets, and the inner/object/object+Δ/object+2Δ
adaptive scale ladder.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from deepmerge_tpu_torch.ops.kernels.window_gather import (
    LANE_ALIGN,
    ROW_ALIGN,
    gather_windows,
)
from deepmerge_tpu_torch.ops.resize import resize_weights


# The JAX package's compiler turns ``x / 255.0`` into ``x * (1/255)``; the
# same float32 reciprocal keeps the patches bit-identical.
_INV_255 = float(np.float32(1.0) / np.float32(255.0))


def adaptive_scales(inner, obj, patch_targets=(32, 64, 128, 1), device=None):
    """Adaptive scale ladder and factors.

    Args:
      inner, obj: int arrays or tensors (...,) — the per-region "inner" and
        "object" scale fields.
      patch_targets: per-slot resize targets.

    Returns scales (..., 4) int32 and factors (..., 4) float32 tensors.
    """
    inner = torch.as_tensor(inner, device=device).to(torch.int32)
    obj = torch.as_tensor(obj, device=device).to(torch.int32)
    interval = obj - inner
    scales = torch.stack(
        [inner, obj, obj + interval, obj + 2 * interval], dim=-1
    )
    targets = torch.tensor(patch_targets, dtype=torch.float32,
                           device=scales.device)
    return scales, scales.to(torch.float32) / targets


def slot_caps(max_scales, max_window: int = 512,
              align: int = 128) -> tuple[int, ...]:
    """Per-slot static window caps from the data's max adaptive scales."""
    caps = []
    for m in np.asarray(max_scales).tolist():
        c = min(int(-(-m // align)) * align, max_window)
        caps.append(max(c, align))
    return tuple(caps)


def staging_caps(inner, obj, patch_sizes, max_window: int,
                 scene_name: str = "") -> tuple[int, ...]:
    """Per-slot window caps from the data's max adaptive scales; warns when
    scales above ``max_window`` will be clamped (patch content then differs
    from the reference for those points)."""
    inner64 = np.asarray(inner).astype(np.int64)
    obj64 = np.asarray(obj).astype(np.int64)
    ladder = np.stack(
        [inner64, obj64, 2 * obj64 - inner64, 3 * obj64 - 2 * inner64], 1
    )
    max_scales = ladder.max(0)[: len(patch_sizes)]
    caps = slot_caps(max_scales, max_window)
    if int(max_scales.max(initial=0)) > max_window:
        warnings.warn(
            f"scene '{scene_name}': adaptive scales up to "
            f"{int(max_scales.max())} exceed data.max_window="
            f"{max_window}; windows will be clamped (patch content "
            f"differs from the reference for those points)",
            stacklevel=3,
        )
    return caps


def _pixel_align(channels: int) -> int:
    """Column alignment in pixels of the JAX package's window origins."""
    return math.lcm(LANE_ALIGN, channels) // channels


def staged_channels(channels: int) -> int:
    """Channel count scenes are staged with: the next power of two (a
    3-band scene stages as RGBA; the zero band is sliced off the patches)."""
    return 1 << (max(channels, 1) - 1).bit_length()


def scene_pad(caps: int | tuple[int, ...], channels: int) -> int:
    """Per-side zero padding: half the largest window plus the spill of the
    origin alignment on either axis (``channels`` may be the original band
    count; alignment uses the staged count)."""
    m = caps if isinstance(caps, int) else max(caps)
    return m // 2 + max(ROW_ALIGN, _pixel_align(staged_channels(channels)))


def pad_scene_device(tile: torch.Tensor, pad: int,
                     staged_c: int) -> torch.Tensor:
    """Zero-pad a raw (H, W, C) tile on its device: ``pad`` pixels per side,
    channels up to ``staged_c`` (byte-identical to the JAX package's)."""
    h, w, c = tile.shape
    out = torch.zeros((h + 2 * pad, w + 2 * pad, staged_c), dtype=tile.dtype,
                      device=tile.device)
    out[pad : pad + h, pad : pad + w, :c] = tile
    return out


def _left_top(center: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Window origin ``int(center - scale/2)``, truncated toward zero."""
    v = center.to(torch.float32) - scale.to(torch.float32) / 2.0
    return torch.trunc(v).to(torch.int32)


def window_starts(centers: torch.Tensor, cap: int, pad: int, channels: int):
    """Aligned window origins of one slot, as the JAX package forms them.

    Returns ``(starts, y0a, px0a)``: (B, 2) int32 (row, byte column) gather
    origins, and the aligned row / pixel-column origins the resize offsets
    are measured from.
    """
    a_px = _pixel_align(channels)
    y0 = centers[:, 0] + (pad - cap // 2)
    y0a = torch.div(y0, ROW_ALIGN, rounding_mode="floor") * ROW_ALIGN
    px0 = centers[:, 1] + (pad - cap // 2)
    px0a = torch.div(px0, a_px, rounding_mode="floor") * a_px
    starts = torch.stack([y0a, px0a * channels], dim=1).to(torch.int32)
    return starts.contiguous(), y0a, px0a


def _slot_patches(scene2d, centers, slot_scales, cap, out, pad, c,
                  quantize_uint8, out_dtype, trusted_origins):
    a_px = _pixel_align(c)
    win_rows = cap + ROW_ALIGN
    win_px = cap + a_px
    b = centers.shape[0]
    starts, y0a, px0a = window_starts(centers, cap, pad, c)
    windows = gather_windows(scene2d, starts, win_rows, win_px * c,
                             trusted_origins=trusted_origins)

    s = torch.clamp(slot_scales, 1, cap)
    # window index of original coord y is y - (y0a - pad)
    off_y = _left_top(centers[:, 0], s) - y0a + pad
    off_x = _left_top(centers[:, 1], s) - px0a + pad
    s32 = s.to(torch.float32)[:, None, None]

    if quantize_uint8 and cap <= 256:
        # Exact path (window sides s <= 256): the weights scaled by s are
        # small integers, bf16-exact for the row pass; uint8 pixels are
        # integers, so every product and every sum of pass 1 is an exact
        # float32 integer. Both passes run as float32 products (TF32 off);
        # one divide by s² at the end, with the integer tie-correction that
        # makes the rounding exactly floor(x2/s² + ½).
        kr = (resize_weights(out, win_rows, s, off_y) * s32).to(torch.bfloat16)
        kc = resize_weights(out, win_px, s, off_x) * s32
        win = windows.to(torch.float32).reshape(b, win_rows, win_px * c)
        x1 = torch.bmm(kr.to(torch.float32), win)  # (b, out, win_px*c)
        x1 = x1.reshape(b, out, win_px, c)
        x2 = torch.einsum("bpj,bojc->bopc", kc, x1)
        s2 = s32[..., None] ** 2
        k = torch.floor(x2 / s2 + 0.5)
        d2 = 2.0 * (x2 - k * s2)
        k = k + (d2 >= s2).to(torch.float32)
        k = k - (d2 < -s2).to(torch.float32)
        return (k * _INV_255).to(out_dtype)

    # caps above 256: float32 weights on float32 windows, cv2 rounding
    win = windows.to(torch.float32).reshape(b, win_rows, win_px * c)
    wr = resize_weights(out, win_rows, s, off_y)
    wc = resize_weights(out, win_px, s, off_x)
    x = torch.bmm(wr, win).reshape(b, out, win_px, c)
    x = torch.einsum("bpj,bojc->bopc", wc, x)
    if quantize_uint8:
        x = torch.floor(x + 0.5)
    return (x * _INV_255).to(out_dtype)


def extract_multiscale_patches(
    padded_scene: torch.Tensor,
    centers_yx: torch.Tensor,
    scales: torch.Tensor,
    patch_sizes: tuple[int, ...] = (32, 64, 128),
    caps: int | tuple[int, ...] = 512,
    chunk: int = 256,
    quantize_uint8: bool = True,
    out_channels: int | None = None,
    out_dtype: torch.dtype = torch.float32,
    trusted_origins: bool = False,
):
    """Per-point multi-scale patches.

    Args:
      padded_scene: (H + 2·pad, W + 2·pad, Cs) uint8 — ``pad_scene_device``
        output, ``pad = scene_pad(caps, C)``.
      centers_yx: (B, 2) int32 pixel centers (row, col) in original coords.
      scales: (B, S) int32 adaptive window sides, S >= len(patch_sizes).
      patch_sizes: per-slot output sides.
      caps: per-slot max window sides (even; scales clamp to them).
      chunk: points per pass, bounding transient window memory.
      quantize_uint8: emulate cv2-on-uint8 rounding.
      out_channels: slice patches to the original band count; None keeps
        the staged channels.
      out_dtype: patch dtype.
      trusted_origins: every center lies inside the scene (the caller
        checked it); the window gather then skips its bounds check and the
        device sync that check costs.

    Returns a tuple of (B, p, p, out_channels) ``out_dtype`` in [0, 1], one
    per patch size. The resize products need full float32: TF32 is turned
    off for them here (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32``), as the exact path requires.
    """
    n_slots = len(patch_sizes)
    if isinstance(caps, int):
        caps = (caps,) * n_slots
    if any(c % 2 for c in caps):
        raise ValueError(f"caps must be even, got {caps}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b = centers_yx.shape[0]
    c = padded_scene.shape[-1]
    pad = scene_pad(caps, c)
    co = c if out_channels is None else out_channels
    scene2d = padded_scene.reshape(padded_scene.shape[0], -1)
    centers_yx = centers_yx.to(torch.int32)
    outs = [[] for _ in range(n_slots)]
    for start in range(0, b, chunk):
        cen = centers_yx[start : start + chunk]
        scl = scales[start : start + chunk]
        for slot in range(n_slots):
            p = _slot_patches(
                scene2d, cen, scl[:, slot], caps[slot], patch_sizes[slot],
                pad, c, quantize_uint8, out_dtype, trusted_origins,
            )
            outs[slot].append(p[..., :co])
    return tuple(
        o[0] if len(o) == 1 else torch.cat(o, dim=0) for o in outs
    )
