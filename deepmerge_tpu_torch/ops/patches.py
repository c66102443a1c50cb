"""Multi-scale patch extraction from a device-resident scene (port of
``deepmerge_tpu/ops/patches.py``).

The scene lives zero-padded on the device as uint8. For each scale slot,
the patches come from a static-cap window per point whose origin is aligned
down exactly as the JAX package aligns it, cropped and resized with cv2
INTER_AREA by weights (``ops/resize.py``) that encode the crop. On the exact
path (uint8 rounding, caps up to 256) one launch of the fused patch kernel
(K1, ``ops/kernels/patch_resize``) does all of that for every point of the
slot. The float path gathers the windows (``ops/kernels/window_gather``) and
runs two batched float32 matrix products. The resulting patches are
bit-identical to the JAX package's.

Reference semantics (the JAX package's, kept exactly): window top-left
``int(center - scale/2)`` truncated toward zero, zero padding outside the
scene, per-slot resize targets, and the inner/object/object+Δ/object+2Δ
adaptive scale ladder.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from deepmerge_tpu_torch.ops.kernels.patch_resize import (
    INV_255,
    MAX_CAP,
    patch_resize,
    slot_geometry,
)
from deepmerge_tpu_torch.ops.kernels.window_gather import (
    ROW_ALIGN,
    gather_windows,
    pixel_align,
)
from deepmerge_tpu_torch.ops.resize import resize_weights


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


def staged_channels(channels: int) -> int:
    """Channel count scenes are staged with: the next power of two (a
    3-band scene stages as RGBA; the zero band is sliced off the patches)."""
    return 1 << (max(channels, 1) - 1).bit_length()


def scene_pad(caps: int | tuple[int, ...], channels: int) -> int:
    """Per-side zero padding: half the largest window plus the spill of the
    origin alignment on either axis (``channels`` may be the original band
    count; alignment uses the staged count)."""
    m = caps if isinstance(caps, int) else max(caps)
    return m // 2 + max(ROW_ALIGN, pixel_align(staged_channels(channels)))


def pad_scene_device(tile: torch.Tensor, pad: int,
                     staged_c: int) -> torch.Tensor:
    """Zero-pad a raw (H, W, C) tile on its device: ``pad`` pixels per side,
    channels up to ``staged_c`` (byte-identical to the JAX package's)."""
    h, w, c = tile.shape
    out = torch.zeros((h + 2 * pad, w + 2 * pad, staged_c), dtype=tile.dtype,
                      device=tile.device)
    out[pad : pad + h, pad : pad + w, :c] = tile
    return out


def pad_scene(scene: np.ndarray, caps: int | tuple[int, ...]) -> np.ndarray:
    """Host ``pad_scene_device``: an (H, W, C) numpy scene zero-padded by
    ``scene_pad(caps)`` per side, channels up to ``staged_channels`` (the
    JAX package's host layout, byte for byte)."""
    p = scene_pad(caps, scene.shape[-1])
    h, w, c = scene.shape
    out = np.zeros((h + 2 * p, w + 2 * p, staged_channels(c)), scene.dtype)
    out[p : p + h, p : p + w, :c] = scene
    return out


def points_inside(points_yx, h: int, w: int) -> bool:
    """Whether every (row, col) point lies inside an ``h`` x ``w`` image,
    checked on the host. The windows of such points lie inside the padded
    scene, so a caller that checked this may pass ``trusted_origins``."""
    yx = np.asarray(points_yx).reshape(-1, 2)
    return bool(((yx >= 0) & (yx < np.array([h, w]))).all())


def _float_slot_patches(scene2d, centers, slot_scales, cap, out, pad, c,
                        quantize_uint8, out_dtype, trusted_origins):
    """The float path of one slot (caps above 256, or no uint8 rounding):
    K1's gather, float32 weights on float32 windows (TF32 off), cv2
    rounding when asked."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    win_rows, win_px = cap + ROW_ALIGN, cap + pixel_align(c)
    b = centers.shape[0]
    starts, s, off_y, off_x = slot_geometry(centers, slot_scales, cap, pad, c)
    windows = gather_windows(scene2d, starts, win_rows, win_px * c,
                             trusted_origins=trusted_origins)
    win = windows.to(torch.float32).reshape(b, win_rows, win_px * c)
    wr = resize_weights(out, win_rows, s, off_y)
    wc = resize_weights(out, win_px, s, off_x)
    x = torch.bmm(wr, win).reshape(b, out, win_px, c)
    x = torch.einsum("bpj,bojc->bopc", wc, x)
    if quantize_uint8:
        x = torch.floor(x + 0.5)
    return (x * INV_255).to(out_dtype)


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
      chunk: points per pass of the float path and of the exact path's
        plain version (the CPU path), bounding their window memory.
      quantize_uint8: emulate cv2-on-uint8 rounding.
      out_channels: slice patches to the original band count; None keeps
        the staged channels.
      out_dtype: patch dtype.
      trusted_origins: every center lies inside the scene (the caller
        checked it, see ``points_inside``); the patch stage then skips its
        bounds check and the device sync that check costs.

    Returns a tuple of (B, p, p, out_channels) ``out_dtype`` in [0, 1], one
    per patch size. A slot with uint8 rounding and a cap up to 256 takes the
    exact path: on the card one ``patch_resize`` launch for all B points.
    Otherwise the slot takes the float path, K1's gather and two float32
    products, chunk by chunk. The float32 products need TF32 off: the paths
    that run them turn it off (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32``).
    """
    n_slots = len(patch_sizes)
    if isinstance(caps, int):
        caps = (caps,) * n_slots
    if any(c % 2 for c in caps):
        raise ValueError(f"caps must be even, got {caps}")
    b = centers_yx.shape[0]
    c = padded_scene.shape[-1]
    pad = scene_pad(caps, c)
    co = c if out_channels is None else out_channels
    scene2d = padded_scene.reshape(padded_scene.shape[0], -1)
    centers_yx = centers_yx.to(torch.int32)
    scales = scales.to(torch.int32)
    outs = []
    for slot, (cap, out) in enumerate(zip(caps, patch_sizes)):
        if quantize_uint8 and cap <= MAX_CAP:
            outs.append(patch_resize(
                padded_scene, centers_yx, scales[:, slot], cap, out, pad,
                out_channels=co, out_dtype=out_dtype,
                trusted_origins=trusted_origins, chunk=chunk))
            continue
        parts = [
            _float_slot_patches(
                scene2d, centers_yx[i : i + chunk],
                scales[i : i + chunk, slot], cap, out, pad, c,
                quantize_uint8, out_dtype, trusted_origins,
            )[..., :co]
            for i in range(0, b, chunk)
        ]
        outs.append(parts[0] if len(parts) == 1 else torch.cat(parts))
    return tuple(outs)
