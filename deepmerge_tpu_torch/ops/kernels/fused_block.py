"""One pre-LN transformer block (kernel K2), a stage of blocks (kernel K3),
their w8a8 forms (kernel K4), and their plain PyTorch versions.

Counterpart of ``deepmerge_tpu/ops/pallas/fused_block.py`` (``fused_block``
and ``fused_block_chain``, the bf16 path and the ``quant`` path). A block's
parameters travel as the 13-tuple of the JAX package, in its order::

    (ln1_scale, ln1_bias, w_qkv, b_qkv, attn_bias, w_proj, b_proj,
     ln2_scale, ln2_bias, w_up, b_up, w_down, b_down)

with the LayerNorm parameters and the (H, N, N) attention bias in float32
and the rest in the activation dtype — but the weights in ``nn.Linear``'s
(out, in) layout, where the JAX package's are (in, out). The w8a8 path
takes the 17-tuple (18 with static activation scales) of
``quantize_block_params``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from deepmerge_tpu_torch.ops.kernels import build

LN_EPS = 1e-5
N_PARAMS = 13
HEAD_DIM = 64      # the attention kernel's head width
MAX_TOKENS = 256   # the attention kernel's longest sequence
MAX_WIDTH = 1024   # the LayerNorm kernel's widest row

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, out, B, N, C, H, hidden, params, qkv, att, r, h, stream
    "dm_block_forward": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # x, out, B, N, C, H, hidden, depth, params, qkv, att, r, h, stream
    "dm_chain_forward": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                         _P],
}
_SIGNATURES_Q8 = {
    # x, out, B, N, C, H, hidden, params, static, qkv, att, r, h, codes,
    # row_scale, stream
    "dm_block_forward_q8": [_P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P,
                            _P, _P, _P, _P],
    # x, out, B, N, C, H, hidden, depth, params, static, qkv, att, r, h,
    # codes, row_scale, stream
    "dm_chain_forward_q8": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P,
                            _P, _P, _P, _P, _P],
}
Q8_K_ALIGN = 128   # the int8 GEMM's K tile: C and the MLP width divide by it


# ------------------------------------------------------------ plain version

def _ln(x, scale, bias, eps=LN_EPS):
    m = x.to(torch.float32)
    mu = m.mean(-1, keepdim=True)
    v = ((m - mu) ** 2).mean(-1, keepdim=True)
    return (m - mu) * torch.rsqrt(v + eps) * scale + bias


def _mm(a, w):
    """``a @ w.T`` with float32 accumulation of the exact products."""
    return torch.matmul(a.to(torch.float32), w.to(torch.float32).t())


def gelu(x, exact: bool = False):
    """``jax.nn.gelu``: the tanh approximation, or the erf form if
    ``exact``."""
    if exact:
        return 0.5 * x * torch.erfc(-x * math.sqrt(0.5))
    k = math.sqrt(2.0 / math.pi)
    return x * (0.5 * (1.0 + torch.tanh(k * (x + 0.044715 * (x ** 3)))))


def attention_parts(qkv: torch.Tensor, bias: torch.Tensor, heads: int):
    """The TPU kernels' attention (``_attn_inner``, and the saved-probs
    kernel's forward) on a (B, N, 3C) qkv in the activation dtype: per head
    softmax(q·d^-½·kᵀ + bias) · v in f32, q scaled in the activation dtype,
    the numerators rounded to it for the value product and 1/Σe applied
    after that. Returns the output (B, N, C) in qkv's dtype, and the f32
    numerators e (B, H, N, N) and reciprocals 1/Σe (B, H, N, 1)."""
    dt = qkv.dtype
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    q = qkv[..., :c].reshape(b, n, heads, d) * d ** -0.5
    k = qkv[..., c : 2 * c].reshape(b, n, heads, d)
    v = qkv[..., 2 * c :].reshape(b, n, heads, d)
    logits = torch.einsum(
        "bnhd,bmhd->bhnm", q.to(torch.float32), k.to(torch.float32)
    ) + bias.to(torch.float32)[None]
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    recip = 1.0 / e.sum(-1, keepdim=True)
    av = torch.einsum(
        "bhnm,bmhd->bhnd", e.to(dt).to(torch.float32), v.to(torch.float32)
    )
    out = (av * recip).permute(0, 2, 1, 3).reshape(b, n, c).to(dt)
    return out, e, recip


def _attention(qkv: torch.Tensor, bias: torch.Tensor,
               heads: int) -> torch.Tensor:
    return attention_parts(qkv, bias, heads)[0]


def block_ref(x: torch.Tensor, params, heads: int,
              exact_gelu: bool = False) -> torch.Tensor:
    """Plain version of one block, with the TPU kernel's rounding points:
    f32 LayerNorm and accumulation, casts to x's dtype after each GEMM,
    softmax in f32 with the 1/Σe applied after e·v."""
    (l1s, l1b, wq, bq, bias, wp, bp, l2s, l2b, wu, bu, wd, bd) = params
    dt = x.dtype
    y = _ln(x, l1s, l1b).to(dt)
    qkv = _mm(y, wq).to(dt) + bq
    a = _attention(qkv, bias, heads)
    r = x + (_mm(a, wp).to(dt) + bp)
    y2 = _ln(r, l2s, l2b).to(dt)
    h1 = gelu(_mm(y2, wu) + bu.to(torch.float32), exact_gelu)
    return r + (_mm(h1.to(dt), wd).to(dt) + bd)


def chain_ref(x: torch.Tensor, params_list, heads: int,
              exact_gelu: bool = False) -> torch.Tensor:
    """Plain version of a stage: blocks back to back, cast to x's dtype
    between them."""
    for p in params_list:
        x = block_ref(x, p, heads, exact_gelu).to(x.dtype)
    return x


# ------------------------------------------------- w8a8: plain version
#
# Per-output-channel symmetric int8 weights, int8 activations with a
# per-row dynamic scale (or a calibrated static one), s8×s8→s32 products,
# bf16 attention: ``_block_math_q8`` and its helpers in the JAX package.

# The JAX package's compiler turns ``amax / 127.0`` into ``amax * (1/127)``
# (checked bit for bit on the CPU); the same float32 reciprocal keeps the
# scales, and so the int8 codes, identical.
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _scale_from_amax(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127``, or 1 where ``amax`` is 0, in float32."""
    amax = amax.to(torch.float32)
    return torch.where(amax > 0, amax * _INV_127, torch.ones_like(amax))


def _codes(t: torch.Tensor) -> torch.Tensor:
    """Round half to even and clip to ±127 (never -128), as int8."""
    return torch.clamp(torch.round(t), -127, 127).to(torch.int8)


def quantize_weight(w: torch.Tensor):
    """(out, in) float weight → (int8 (out, in), float32 scale (out,)).

    Symmetric per output channel: q = round(w / s), s = max|w| / 127 over
    the channel's row. The JAX package's weight is (in, out), so its
    per-column scale is this per-row one.
    """
    wf = w.to(torch.float32)
    s = _scale_from_amax(wf.abs().amax(dim=1))
    return _codes(wf / s[:, None]), s


def quantize_block_params(params, act_amax=None) -> tuple:
    """A block's 13-tuple → the w8a8 17-tuple, in the JAX package's order::

        (ln1_scale, ln1_bias, q_qkv, s_qkv, b_qkv, attn_bias, q_proj,
         s_proj, b_proj, ln2_scale, ln2_bias, q_up, s_up, b_up, q_down,
         s_down, b_down)

    With ``act_amax`` ((7,) calibrated activation abs-maxes, see
    ``block_act_amax``) an 18th entry of static scales (amax/127) follows.
    """
    (l1s, l1b, wq, bq, bias, wp, bp, l2s, l2b, wu, bu, wd, bd) = params
    f32 = lambda t: t.to(torch.float32)
    out = (f32(l1s), f32(l1b), *quantize_weight(wq), bq, bias,
           *quantize_weight(wp), bp, f32(l2s), f32(l2b),
           *quantize_weight(wu), bu, *quantize_weight(wd), bd)
    if act_amax is None:
        return out
    return out + (_scale_from_amax(act_amax),)


def _int_dot(codes: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``codes @ wq.T`` of int8 operands, exact, as float32: float64 holds
    every partial sum (|Σ| ≤ 127²·K < 2^53), and the one rounding to
    float32 is the int32 accumulator's own conversion."""
    acc = torch.matmul(codes.to(torch.float64), wq.to(torch.float64).t())
    return acc.to(torch.float32)


def _qdot(y: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor):
    """float32 (M, K) × int8 (N, K)ᵀ with a dynamic per-row activation
    scale; returns the dequantized float32 (M, N), scaled left to right
    (acc · s_row · s_w) as the JAX package's ``_qdot``."""
    sr = _scale_from_amax(y.abs().amax(dim=-1, keepdim=True))
    return _int_dot(_codes(y / sr), wq) * sr * s_w[None, :]


def _qdot_static(y: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
                 sr: torch.Tensor):
    """``_qdot`` with a calibrated static scale ``sr`` (0-d float32):
    codes = round(y · (1/sr)), dequantized as acc · (sr · s_w)."""
    return _int_dot(_codes(y * (1.0 / sr)), wq) * (sr * s_w)[None, :]


def block_ref_q8(x: torch.Tensor, qparams, heads: int,
                 exact_gelu: bool = False) -> torch.Tensor:
    """Plain version of one w8a8 block (``_block_math_q8``): the four GEMMs
    int8, their inputs quantized from float32 (the LayerNorm outputs and
    the GELU output are never cast to the activation dtype), attention as
    in ``block_ref``. ``qparams`` is the 17- or 18-tuple of
    ``quantize_block_params``."""
    (l1s, l1b, wq, sq, bq, bias, wp, sp, bp, l2s, l2b,
     wu, su, bu, wd, sd, bd) = qparams[:17]
    if len(qparams) == 18:
        s_act = qparams[17]
        qd = lambda t, w, s, i: _qdot_static(t, w, s, s_act[i])
    else:
        qd = lambda t, w, s, i: _qdot(t, w, s)
    dt = x.dtype
    b, n, c = x.shape
    y = _ln(x, l1s, l1b).reshape(b * n, c)
    qkv = (qd(y, wq, sq, 0).to(dt) + bq).reshape(b, n, 3 * c)
    a = _attention(qkv, bias, heads)
    p = qd(a.reshape(b * n, c).to(torch.float32), wp, sp, 1).to(dt) + bp
    r = x + p.reshape(b, n, c)
    y2 = _ln(r, l2s, l2b).reshape(b * n, c)
    h1 = gelu(qd(y2, wu, su, 2) + bu.to(torch.float32), exact_gelu)
    o = qd(h1, wd, sd, 3).to(dt) + bd
    return r + o.reshape(b, n, c)


def chain_ref_q8(x: torch.Tensor, qparams_list, heads: int,
                 exact_gelu: bool = False) -> torch.Tensor:
    """Plain version of a w8a8 stage: ``block_ref_q8`` back to back."""
    for p in qparams_list:
        x = block_ref_q8(x, p, heads, exact_gelu).to(x.dtype)
    return x


def block_act_amax(x: torch.Tensor, params, heads: int,
                   exact_gelu: bool = False):
    """Calibration forward of one block (the JAX package's plain-XLA
    ``block_act_amax``): the activation-dtype block with a softmax
    normalized before the value product, plus abs-max taps.

    Returns ``(out, amax)``, ``amax`` a (7,) float32 of the batch abs-maxes
    of (LN1 out, attention out, LN2 out, GELU out, q, k, v) — the four
    GEMM inputs that ``block_ref_q8`` quantizes and the three attention
    operands (unscaled slices of qkv).
    """
    (l1s, l1b, wq, bq, bias, wp, bp, l2s, l2b, wu, bu, wd, bd) = params
    dt = x.dtype
    b, n, c = x.shape
    d = c // heads
    f32 = torch.float32
    y = _ln(x, l1s, l1b)
    qkv = _mm(y.to(dt), wq).to(dt) + bq
    q = qkv[..., :c].reshape(b, n, heads, d) * d ** -0.5
    k = qkv[..., c : 2 * c].reshape(b, n, heads, d)
    v = qkv[..., 2 * c :].reshape(b, n, heads, d)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.to(f32), k.to(f32))
    prob = torch.softmax(logits + bias.to(f32)[None], dim=-1)
    a = torch.einsum("bhnm,bmhd->bnhd", prob.to(dt).to(f32), v.to(f32))
    a = a.reshape(b, n, c).to(dt)
    r = x + (_mm(a, wp).to(dt) + bp)
    y2 = _ln(r, l2s, l2b)
    h1 = gelu(_mm(y2.to(dt), wu).to(dt).to(f32) + bu.to(f32), exact_gelu)
    o = _mm(h1.to(dt), wd).to(dt) + bd
    amax = torch.stack([
        y.abs().max(), a.to(f32).abs().max(), y2.abs().max(), h1.abs().max(),
        qkv[..., :c].to(f32).abs().max(),
        qkv[..., c : 2 * c].to(f32).abs().max(),
        qkv[..., 2 * c :].to(f32).abs().max(),
    ])
    return r + o, amax


# -------------------------------------------------------------- CUDA path

def _check_x(x, heads, align):
    """(B, N, C) of an activation the CUDA blocks take: bf16, contiguous,
    C == heads·64 <= 1024 and a multiple of ``align``."""
    if x.dtype != torch.bfloat16 or x.dim() != 3 or not x.is_contiguous():
        raise TypeError(f"x must be a contiguous (B, N, C) bf16 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    b, n, c = x.shape
    if c != heads * HEAD_DIM or c > MAX_WIDTH or c % align:
        raise ValueError(f"the CUDA block needs C == heads*{HEAD_DIM} <= "
                         f"{MAX_WIDTH}, a multiple of {align}; got C={c}, "
                         f"heads={heads}")
    if not 1 <= n <= MAX_TOKENS or not 1 <= b <= 65535:
        raise ValueError(f"the CUDA block takes 1..{MAX_TOKENS} tokens and "
                         f"1..65535 samples, got B={b}, N={n}")
    return b, n, c


def _check_params(params_list, want, device, what):
    """Every block's parameters match ``want`` ((dtype, shape) each), lie
    contiguous on ``device`` and start on 16 bytes."""
    for p in params_list:
        if len(p) != len(want):
            raise ValueError(f"a {what} takes {len(want)} parameters, "
                             f"got {len(p)}")
        for i, (t, (dt, shape)) in enumerate(zip(p, want)):
            if (t.dtype != dt or tuple(t.shape) != shape
                    or t.device != device or not t.is_contiguous()
                    or t.data_ptr() % 16):
                raise ValueError(
                    f"{what} parameter {i}: want contiguous {dt} {shape} on "
                    f"{device}, got {t.dtype} {tuple(t.shape)} on "
                    f"{t.device}"
                )


def _check_cuda(x, params_list, heads):
    b, n, c = _check_x(x, heads, HEAD_DIM)
    hidden = params_list[0][9].shape[0]
    if hidden % 64:
        raise ValueError(f"MLP width must be a multiple of 64, got {hidden}")
    f32, bf = torch.float32, torch.bfloat16
    want = ((f32, (c,)), (f32, (c,)), (bf, (3 * c, c)), (bf, (3 * c,)),
            (f32, (heads, n, n)), (bf, (c, c)), (bf, (c,)),
            (f32, (c,)), (f32, (c,)), (bf, (hidden, c)), (bf, (hidden,)),
            (bf, (c, hidden)), (bf, (c,)))
    _check_params(params_list, want, x.device, "block")
    return b, n, c, hidden


def _launch(fn_name, x, params_list, heads):
    b, n, c, hidden = _check_cuda(x, params_list, heads)
    m = b * n
    out = torch.empty_like(x)
    qkv = torch.empty((m, 3 * c), dtype=x.dtype, device=x.device)
    att = torch.empty((m, c), dtype=x.dtype, device=x.device)
    r = torch.empty((m, c), dtype=x.dtype, device=x.device)
    h = torch.empty((m, hidden), dtype=x.dtype, device=x.device)
    flat = [t for p in params_list for t in p]
    ptrs = (ctypes.c_void_p * len(flat))(*[t.data_ptr() for t in flat])
    lib = build.load("fused_block", _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    shape = (b, n, c, heads, hidden)
    if fn_name == "dm_block_forward":
        err = lib.dm_block_forward(x.data_ptr(), out.data_ptr(), *shape, ptrs,
                                   qkv.data_ptr(), att.data_ptr(),
                                   r.data_ptr(), h.data_ptr(), stream)
    else:
        err = lib.dm_chain_forward(x.data_ptr(), out.data_ptr(), *shape,
                                   len(params_list), ptrs, qkv.data_ptr(),
                                   att.data_ptr(), r.data_ptr(), h.data_ptr(),
                                   stream)
    build.check(lib, err, fn_name)
    return out


def _require_tanh_gelu(exact_gelu):
    if exact_gelu:
        raise NotImplementedError(
            "exact (erf) GELU has no CUDA block kernel yet — it runs on the "
            "attention-only kernel path, ROADMAP.md queue B, K7"
        )


def fused_block(x: torch.Tensor, params, heads: int,
                exact_gelu: bool = False) -> torch.Tensor:
    """One pre-LN block, (B, N, C) → (B, N, C) in x's dtype.

    CPU tensors run ``block_ref``. CUDA tensors (bf16) launch the CUDA
    block (``csrc/fused_block.cu``, ``dm_block_forward``) and count the
    launch in ``fused_block.launches``.
    """
    if x.device.type == "cpu":
        return block_ref(x, params, heads, exact_gelu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _require_tanh_gelu(exact_gelu)
    out = _launch("dm_block_forward", x, [tuple(params)], heads)
    fused_block.launches += 1
    return out


def fused_block_chain(x: torch.Tensor, params_list, heads: int,
                      exact_gelu: bool = False) -> torch.Tensor:
    """A stage: ``len(params_list)`` blocks back to back.

    CPU tensors run ``chain_ref``. CUDA tensors (bf16) launch the CUDA
    chain (``csrc/fused_block.cu``, ``dm_chain_forward``) and count the
    launch in ``fused_block_chain.launches``.
    """
    if x.device.type == "cpu":
        return chain_ref(x, params_list, heads, exact_gelu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _require_tanh_gelu(exact_gelu)
    params_list = [tuple(p) for p in params_list]
    if not params_list:
        raise ValueError("a chain needs at least one block")
    out = _launch("dm_chain_forward", x, params_list, heads)
    fused_block_chain.launches += 1
    return out


fused_block.launches = 0
fused_block_chain.launches = 0


# --------------------------------------------------------- w8a8 CUDA path

def _check_cuda_q8(x, qparams_list, heads):
    b, n, c = _check_x(x, heads, Q8_K_ALIGN)
    width = len(qparams_list[0])
    if width not in (17, 18):
        raise ValueError(f"a w8a8 block takes 17 or 18 parameters, got "
                         f"{width}")
    hidden = qparams_list[0][11].shape[0]
    if hidden % Q8_K_ALIGN:
        raise ValueError(f"MLP width must be a multiple of {Q8_K_ALIGN}, "
                         f"got {hidden}")
    f32, bf, i8 = torch.float32, torch.bfloat16, torch.int8
    want = ((f32, (c,)), (f32, (c,)), (i8, (3 * c, c)), (f32, (3 * c,)),
            (bf, (3 * c,)), (f32, (heads, n, n)), (i8, (c, c)), (f32, (c,)),
            (bf, (c,)), (f32, (c,)), (f32, (c,)), (i8, (hidden, c)),
            (f32, (hidden,)), (bf, (hidden,)), (i8, (c, hidden)),
            (f32, (c,)), (bf, (c,)), (f32, (7,)))[:width]
    _check_params(qparams_list, want, x.device, "w8a8 block")
    return b, n, c, hidden, width == 18


def _launch_q8(fn_name, x, qparams_list, heads):
    b, n, c, hidden, static = _check_cuda_q8(x, qparams_list, heads)
    m = b * n
    dev = x.device
    out = torch.empty_like(x)
    qkv = torch.empty((m, 3 * c), dtype=x.dtype, device=dev)
    att = torch.empty((m, c), dtype=x.dtype, device=dev)
    r = torch.empty((m, c), dtype=x.dtype, device=dev)
    h = torch.empty((m, hidden), dtype=torch.float32, device=dev)
    codes = torch.empty((m, max(c, hidden)), dtype=torch.int8, device=dev)
    row_scale = torch.empty((m,), dtype=torch.float32, device=dev)
    flat = [t for p in qparams_list for t in p]
    ptrs = (ctypes.c_void_p * len(flat))(*[t.data_ptr() for t in flat])
    lib = build.load("fused_block_q8", _SIGNATURES_Q8)
    stream = torch.cuda.current_stream(dev).cuda_stream
    shape = (b, n, c, heads, hidden)
    scratch = (qkv.data_ptr(), att.data_ptr(), r.data_ptr(), h.data_ptr(),
               codes.data_ptr(), row_scale.data_ptr())
    if fn_name == "dm_block_forward_q8":
        err = lib.dm_block_forward_q8(x.data_ptr(), out.data_ptr(), *shape,
                                      ptrs, int(static), *scratch, stream)
    else:
        err = lib.dm_chain_forward_q8(x.data_ptr(), out.data_ptr(), *shape,
                                      len(qparams_list), ptrs, int(static),
                                      *scratch, stream)
    build.check(lib, err, fn_name)
    return out


def fused_block_q8(x: torch.Tensor, qparams, heads: int,
                   exact_gelu: bool = False) -> torch.Tensor:
    """One w8a8 block, (B, N, C) → (B, N, C) in x's dtype; ``qparams`` from
    ``quantize_block_params`` (17 entries, or 18 with static scales).

    CPU tensors run ``block_ref_q8``. CUDA tensors (bf16) launch the CUDA
    w8a8 block (``csrc/fused_block_q8.cu``, ``dm_block_forward_q8``) and
    count the launch in ``fused_block_q8.launches``.
    """
    if x.device.type == "cpu":
        return block_ref_q8(x, qparams, heads, exact_gelu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _require_tanh_gelu(exact_gelu)
    out = _launch_q8("dm_block_forward_q8", x, [tuple(qparams)], heads)
    fused_block_q8.launches += 1
    return out


def fused_block_chain_q8(x: torch.Tensor, qparams_list, heads: int,
                         exact_gelu: bool = False) -> torch.Tensor:
    """A w8a8 stage: ``len(qparams_list)`` blocks back to back.

    CPU tensors run ``chain_ref_q8``. CUDA tensors (bf16) launch the CUDA
    w8a8 chain (``csrc/fused_block_q8.cu``, ``dm_chain_forward_q8``) and
    count the launch in ``fused_block_chain_q8.launches``.
    """
    if x.device.type == "cpu":
        return chain_ref_q8(x, qparams_list, heads, exact_gelu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _require_tanh_gelu(exact_gelu)
    qparams_list = [tuple(p) for p in qparams_list]
    if not qparams_list:
        raise ValueError("a chain needs at least one block")
    out = _launch_q8("dm_chain_forward_q8", x, qparams_list, heads)
    fused_block_chain_q8.launches += 1
    return out


fused_block_q8.launches = 0
fused_block_chain_q8.launches = 0
