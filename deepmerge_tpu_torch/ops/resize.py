"""Crop + cv2 INTER_AREA resize as weight matrices (port of
``deepmerge_tpu/ops/resize.py``).

``resize_weights`` builds, for a batch of adaptive windows, the (out, cap)
matrices that crop a window out of a static-cap one and resize it with
OpenCV's INTER_AREA semantics; ``ops/patches.py`` applies them as two
batched matrix products. The float32 operations run in the JAX package's
order (``r = s/out``, ``overlap/r``, ...), so every weight rounds to the same
bits — the exact-integer patch path depends on it.
"""

from __future__ import annotations

import numpy as np
import torch


def resize_weights(out_size: int, cap: int, scale: torch.Tensor,
                   offset: torch.Tensor) -> torch.Tensor:
    """Batched (B, out_size, cap) float32 crop+resize weights.

    Args:
      out_size: output side.
      cap: static window side (the padded input extent).
      scale: (B,) int — adaptive source window side ``s`` per item.
      offset: (B,) int — index inside the cap window where the adaptive
        window starts (source pixel ``i`` lives at cap index ``offset+i``).

    Returns weights ``W`` with ``out = W @ window_axis`` matching cv2
    INTER_AREA for both shrink (area average) and enlarge (OpenCV's
    INTER_AREA fallback blend).
    """
    dev = scale.device
    s = scale.to(torch.float32)[:, None, None]
    off = offset.to(torch.int32)[:, None, None]
    # source pixels per output pixel; the JAX package's compiler turns the
    # division by the constant into a product with its float32 reciprocal
    r = s * float(np.float32(1.0) / np.float32(out_size))

    o = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :, None]
    j = torch.arange(cap, dtype=torch.int32, device=dev)[None, None, :]
    i = (j - off).to(torch.float32)  # source-window coordinate of cap col j
    in_window = (i >= 0) & (i < s)

    # downscale: area overlap of [o*r, (o+1)*r) with [i, i+1)
    lo = o * r
    hi = (o + 1.0) * r
    overlap = torch.clamp(
        torch.minimum(hi, i + 1.0) - torch.maximum(lo, i), 0.0, 1.0
    )
    w_down = overlap / r

    # upscale: OpenCV INTER_AREA fallback coefficients
    sx = torch.floor(o * r)
    f = (o + 1.0) - (sx + 1.0) / r
    f = torch.where(f <= 0.0, 0.0, f - torch.floor(f))
    sx2 = torch.minimum(sx + 1.0, s - 1.0)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    w_up = (torch.where(i == sx, 1.0 - f, zero)
            + torch.where(i == sx2, f, zero))

    w = torch.where(r >= 1.0, w_down, w_up)
    return torch.where(in_window, w, zero)


def _apply_resize(x: torch.Tensor, wr: torch.Tensor, wc: torch.Tensor,
                  quantize_uint8: bool) -> torch.Tensor:
    """``wr @ x @ wc^T`` over an (H, W, C) image in float32 (TF32 off, as
    the JAX package's ``Precision.HIGHEST``), rounded as cv2 rounds uint8
    when asked."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = torch.einsum("oi,ijc->ojc", wr, x.to(torch.float32))
    x = torch.einsum("pj,ojc->opc", wc, x)
    return torch.floor(x + 0.5) if quantize_uint8 else x


def crop_resize(window: torch.Tensor, scale, offset_y, offset_x,
                out_size: int, quantize_uint8: bool = True) -> torch.Tensor:
    """Crop the adaptive sub-window of one (cap, cap, C) window of raw pixel
    values and resize it to (out_size, out_size, C) with cv2 INTER_AREA;
    float32 in [0, 1].

    ``scale`` is the adaptive window side, ``offset_y`` / ``offset_x`` where
    it starts inside ``window`` per axis. The two products take float32
    weights on both axes (not the exact patch path's bf16-rounded row
    weights). ``quantize_uint8`` emulates the reference's cv2-on-uint8
    rounding (``MyUtils1.py:207`` resizes the uint8 buffer, then ``/255``).
    """
    dev = window.device
    as1 = lambda v: torch.as_tensor(v, device=dev).reshape(1)
    wr = resize_weights(out_size, window.shape[0], as1(scale),
                        as1(offset_y))[0]
    wc = resize_weights(out_size, window.shape[1], as1(scale),
                        as1(offset_x))[0]
    return _apply_resize(window, wr, wc, quantize_uint8) / 255.0


def area_resize(image: torch.Tensor, out_size: int,
                quantize_uint8: bool = False) -> torch.Tensor:
    """Whole-image cv2 INTER_AREA resize (no crop): (H, W, C) →
    (out_size, out_size, C) float32, in the input's value range."""
    h, w = image.shape[0], image.shape[1]
    dev = image.device
    full = lambda n: torch.tensor([n], dtype=torch.int32, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    wr = resize_weights(out_size, h, full(h), zero)[0]
    wc = resize_weights(out_size, w, full(w), zero)[0]
    return _apply_resize(image, wr, wc, quantize_uint8)
