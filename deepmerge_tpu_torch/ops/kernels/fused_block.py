"""One pre-LN transformer block (kernel K2), a stage of blocks (kernel K3),
their w8a8 forms (kernel K4) with the int8 attention core of ``w8a8+attn``
(kernel K4a), the saved-activation training block (kernel K5) with its hand
backward, and their plain PyTorch versions.

Counterpart of ``deepmerge_tpu/ops/pallas/fused_block.py`` (``fused_block``
and ``fused_block_chain``: the bf16 path, its training path and the
``quant`` path). A block's parameters travel as the 13-tuple of the JAX
package, in its order::

    (ln1_scale, ln1_bias, w_qkv, b_qkv, attn_bias, w_proj, b_proj,
     ln2_scale, ln2_bias, w_up, b_up, w_down, b_down)

with the LayerNorm parameters and the (H, N, N) attention bias in float32
and the rest in the activation dtype — but the weights in ``nn.Linear``'s
(out, in) layout, where the JAX package's are (in, out). The w8a8 path
takes the 17-tuple (18 with static activation scales) of
``quantize_block_params``.

``fused_block`` and ``fused_block_chain`` are differentiable, as the JAX
package's are: under grad mode with an input that requires grad, a block
runs the training forward (K5 on CUDA), which also saves qkv, the
normalized probabilities, the pre-GELU activation and the post-attention
residual, and its backward ``block_train_bwd`` (plain torch on every
device, as the JAX package's ``_fused_block_bwd`` is plain XLA) reuses
them; a chain of several blocks runs K3 forward and recomputes the plain
block under autograd in its backward (``_fused_chain_bwd``). The w8a8
functions are inference-only.
"""

from __future__ import annotations

import contextlib
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
    # x, out, B, N, C, H, hidden, params, qkv, att, r, h, plan, stream
    "dm_block_forward": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                         _P],
    # x, out, B, N, C, H, hidden, depth, params, qkv, att, r, h, plan,
    # stream
    "dm_chain_forward": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                         _P, _P],
    # x, out, B, N, C, H, hidden, params, qkv, probs, gin, r, att, h, plan,
    # stream
    "dm_block_train_forward": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                               _P, _P, _P, _P, _P],
    # a, w, bias, resid, out, aux, M, N, K, epilogue, plan, stream
    "dm_gemm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
}
_SIGNATURES_Q8 = {
    # x, out, B, N, C, H, hidden, params, static, quant_attn, qkv, att, r,
    # h, codes, row_scale, row_amax, plan, stream
    "dm_block_forward_q8": [_P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P,
                            _P, _P, _P, _P, _P, _P, _P],
    # x, out, B, N, C, H, hidden, depth, params, static, quant_attn, qkv,
    # att, r, h, codes, row_scale, row_amax, plan, stream
    "dm_chain_forward_q8": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P,
                            _P, _P, _P, _P, _P, _P, _P, _P],
    # a, w, w_scale, row_scale, static_scale, bias, resid, out, codes,
    # out_row_scale, row_amax, out_scale, M, N, K, epilogue, plan, stream
    "dm_gemm_q8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                   _I, _I, _P, _P],
    # qkv, bias, s_qkv, out, B, N, C, H, plan, stream
    "dm_attention_q8": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
}
Q8_K_ALIGN = 128   # the s8 GEMM's K slab: C and the MLP width divide by it

# ------------------------------------------------------------ launch plans
#
# Each CUDA kernel's launch plan is computed here and passed to its C entry
# point, which refuses a plan it does not take (CUDA error "invalid
# argument"): one source of truth, checked on the CPU against the card's
# limits (tests/test_torch_plans.py).

SM_SHARED = 233_472          # an H100 SM's shared memory (228 KB)
CTA_SHARED_MAX = 232_448     # what one CTA may opt in to (227 KB)
CTA_SHARED_RESERVED = 1_024  # held back by the system for each resident CTA
SM_REGISTERS = 65_536
SM_THREADS = 2_048
SM_CTAS = 32
MAX_GRID_Y = 65_535

# The bf16 attention core (csrc/block_common.cuh): a CTA of `warps` warps
# per head and `samples` samples, K and V of a sample in shared memory at a
# row stride of 64 + 8 bf16, register arrays sized by a bucket of the
# 16-key tile count; 168 registers a thread at most (its launch bound of 12
# warps).
ATTN_KEY_TILE_BUCKETS = (1, 3, 4, 8, 12, 13, 16)
ATTN_ROW_BYTES = (HEAD_DIM + 8) * 2
ATTN_MAX_WARPS = 12
ATTN_REGISTERS = 168
ATTN_WARPS = 4
# samples a CTA: 4 from a batch of 512 on (fewer, longer CTAs: 1.60 against
# 1.80 ms at B 1024, N 192 on an H100), else 1 (enough CTAs to fill 132 SMs)
ATTN_SAMPLES_FROM_BATCH = 512

# K2's GEMM (csrc/fused_block.cu): 128x256 tiles, 64-wide K slabs in a
# 4-stage ring, two consumer warpgroups and a producer warp, a persistent
# grid of one CTA an SM; 224 registers a thread at most (its launch bound of
# one 288-thread CTA an SM).
GEMM_BM = 128
GEMM_BN = 256
GEMM_BK = 64
GEMM_STAGES = 4
GEMM_THREADS = 2 * 128 + 32
GEMM_SMEM = GEMM_STAGES * (GEMM_BM + GEMM_BN) * GEMM_BK * 2 + 1024 \
    + 2 * GEMM_STAGES * 8
GEMM_REGISTERS = 224
GEMM_EPILOGUES = ("bias_cast", "bias_residual", "bias_gelu", "bias_gelu_save")


def ctas_per_sm(threads: int, smem: int, registers: int) -> int:
    """How many CTAs of ``threads`` threads, ``smem`` bytes of shared memory
    and ``registers`` registers a thread fit one H100 SM at once (registers
    are granted a warp at a time in units of 256)."""
    per_warp = -(-registers * 32 // 256) * 256
    return min(SM_SHARED // (smem + CTA_SHARED_RESERVED),
               SM_REGISTERS // (per_warp * (threads // 32)),
               SM_THREADS // threads, SM_CTAS)


def attention_plan(b: int, n: int, heads: int, warps: int = ATTN_WARPS,
                   samples: int | None = None) -> dict:
    """The attention core's launch for ``b`` samples of ``n`` tokens and
    ``heads`` heads: ``ints`` (key-tile bucket, warps, samples, shared
    bytes) as the C entry points take them, the grid (heads, samples per
    CTA) and the CTAs that fit an SM. ``samples`` None: 4 from a batch of
    ``ATTN_SAMPLES_FROM_BATCH`` on, else 1. Raises ``ValueError`` for a
    launch the kernel does not take."""
    if samples is None:
        samples = 4 if b >= ATTN_SAMPLES_FROM_BATCH else 1
    if not 1 <= n <= MAX_TOKENS:
        raise ValueError(f"the attention core takes 1..{MAX_TOKENS} tokens, "
                         f"got {n}")
    if not 1 <= warps <= ATTN_MAX_WARPS or samples < 1:
        raise ValueError(f"the attention core takes 1..{ATTN_MAX_WARPS} warps "
                         f"and >= 1 samples a CTA, got {warps}, {samples}")
    key_tiles = -(-n // 16)
    bucket = next(t for t in ATTN_KEY_TILE_BUCKETS if t >= key_tiles)
    smem = 2 * key_tiles * 16 * ATTN_ROW_BYTES
    grid = (heads, -(-b // samples))
    if not 1 <= grid[1] <= MAX_GRID_Y or not 1 <= heads:
        raise ValueError(f"attention grid {grid} out of range")
    return dict(ints=(bucket, warps, samples, smem), key_tiles=key_tiles,
                bucket=bucket, warps=warps, samples=samples, smem=smem,
                grid=grid,
                ctas_per_sm=ctas_per_sm(warps * 32, smem, ATTN_REGISTERS))


def gemm_plan(m: int, n: int, k: int) -> dict:
    """K2's GEMM launch for out (m, n) = A (m, k) · W (n, k)ᵀ: ``ints``
    (tile rows, tile columns, K slab, stages, threads, shared bytes) as
    the C entry points take them, the grid (column tiles, row tiles) and
    the CTAs that fit an SM. TMA reads both operands in 64-wide K slabs
    with row strides of 2k bytes, which must be multiples of 16: raises
    ``ValueError`` unless k % 64 == 0 and n % 8 == 0 (the epilogue's
    column pairs and the bias's 16-byte rows)."""
    if m < 1 or k < GEMM_BK or k % GEMM_BK or n < 8 or n % 8:
        raise ValueError(f"the GEMM needs K % {GEMM_BK} == 0 and N % 8 == 0, "
                         f"got M={m}, N={n}, K={k}")
    grid = (-(-n // GEMM_BN), -(-m // GEMM_BM))
    if grid[1] > MAX_GRID_Y:
        raise ValueError(f"GEMM grid {grid} out of range (M={m})")
    return dict(ints=(GEMM_BM, GEMM_BN, GEMM_BK, GEMM_STAGES, GEMM_THREADS,
                      GEMM_SMEM),
                grid=grid, smem=GEMM_SMEM,
                ctas_per_sm=ctas_per_sm(GEMM_THREADS, GEMM_SMEM,
                                        GEMM_REGISTERS))


def block_plan(b: int, n: int, c: int, heads: int, hidden: int) -> tuple:
    """A block's plan as its C entry points take it: the attention core's
    ints, then the GEMM's, checked against every GEMM of the block (qkv,
    proj, up, down at M = b·n)."""
    m = b * n
    for rows, depth in ((3 * c, c), (c, c), (hidden, c), (c, hidden)):
        gemm = gemm_plan(m, rows, depth)
    return attention_plan(b, n, heads)["ints"] + gemm["ints"]


# K4's s8 GEMM (csrc/fused_block_q8.cu on csrc/wgmma_gemm.cuh): K2's plan
# with 128-value K slabs (Q8_K_ALIGN: 128 bytes, as K2's 64 bf16).
GEMM_Q8_EPILOGUES = ("bias_cast", "bias_residual", "bias_gelu",
                     "bias_gelu_codes", "acc")


def gemm_q8_plan(m: int, n: int, k: int) -> dict:
    """K4's s8 GEMM launch for out (m, n) = dq(A (m, k) · W (n, k)ᵀ):
    ``ints`` (tile rows, tile columns, K slab, stages, threads, shared
    bytes) as the C entry points take them, the tiles and the CTAs that fit
    an SM. TMA reads both operands in 128-byte K slabs: raises
    ``ValueError`` unless k % 128 == 0 and n % 8 == 0."""
    if m < 1 or k < Q8_K_ALIGN or k % Q8_K_ALIGN or n < 8 or n % 8:
        raise ValueError(f"the s8 GEMM needs K % {Q8_K_ALIGN} == 0 and "
                         f"N % 8 == 0, got M={m}, N={n}, K={k}")
    return dict(ints=(GEMM_BM, GEMM_BN, Q8_K_ALIGN, GEMM_STAGES,
                      GEMM_THREADS, GEMM_SMEM),
                tiles=-(-n // GEMM_BN) * -(-m // GEMM_BM), smem=GEMM_SMEM,
                ctas_per_sm=ctas_per_sm(GEMM_THREADS, GEMM_SMEM,
                                        GEMM_REGISTERS))


# K4a's int8 core (csrc/fused_block_q8.cu): a CTA of `warps` warps (even,
# at most 8) per head and `samples` samples, k codes in 80-byte rows and v
# codes transposed in shared memory, register arrays sized by a bucket of
# the 32-key step count; 168 registers a thread at most (the bf16 core's
# launch bound of 12 warps), 85 up to two steps (a launch bound of two
# such CTAs an SM).
ATTN_Q8_STEP_BUCKETS = (1, 2, 4, 6, 7, 8)
ATTN_Q8_MAX_WARPS = 8
ATTN_Q8_SHORT_REGISTERS = 85


def attention_q8_smem(n: int) -> int:
    """Shared bytes of one K4a CTA for ``n`` tokens (keys padded to 32):
    k codes (np x 80 B), v codes transposed (64 x (np + 16) B), k's row
    scales, v's column scales and a 64-lane partial abs-max for each eight
    threads of the largest CTA."""
    np_ = -(-n // 32) * 32
    return np_ * (HEAD_DIM + 16) + HEAD_DIM * (np_ + 16) + np_ * 4 \
        + HEAD_DIM * 4 + (ATTN_Q8_MAX_WARPS * 32 // 8) * HEAD_DIM * 4


def attention_q8_plan(b: int, n: int, heads: int, warps: int | None = None,
                      samples: int | None = None) -> dict:
    """K4a's core launch for ``b`` samples of ``n`` tokens and ``heads``
    heads: ``ints`` (32-key step bucket, warps, samples, shared bytes) as
    the C entry points take them, the grid and the CTAs that fit an SM.
    ``warps`` None: 2 where one 16-query tile holds every token (n <= 16),
    else ``ATTN_WARPS``; ``samples`` None: as ``attention_plan``. Raises
    ``ValueError`` for a launch the kernel does not take (even warps, at
    most ``ATTN_Q8_MAX_WARPS``)."""
    if warps is None:
        warps = 2 if n <= 16 else ATTN_WARPS
    if samples is None:
        samples = 4 if b >= ATTN_SAMPLES_FROM_BATCH else 1
    if not 1 <= n <= MAX_TOKENS:
        raise ValueError(f"the int8 attention core takes 1..{MAX_TOKENS} "
                         f"tokens, got {n}")
    if not 2 <= warps <= ATTN_Q8_MAX_WARPS or warps % 2 or samples < 1:
        raise ValueError(f"the int8 attention core takes an even 2.."
                         f"{ATTN_Q8_MAX_WARPS} warps and >= 1 samples a CTA,"
                         f" got {warps}, {samples}")
    steps = -(-n // 32)
    bucket = next(t for t in ATTN_Q8_STEP_BUCKETS if t >= steps)
    smem = attention_q8_smem(n)
    grid = (heads, -(-b // samples))
    if not 1 <= grid[1] <= MAX_GRID_Y or not 1 <= heads:
        raise ValueError(f"attention grid {grid} out of range")
    registers = ATTN_Q8_SHORT_REGISTERS if bucket <= 2 else ATTN_REGISTERS
    return dict(ints=(bucket, warps, samples, smem), steps=steps,
                bucket=bucket, warps=warps, samples=samples, smem=smem,
                grid=grid,
                ctas_per_sm=ctas_per_sm(warps * 32, smem, registers))


def block_plan_q8(b: int, n: int, c: int, heads: int, hidden: int,
                  quant_attn: bool = False) -> tuple:
    """A w8a8 block's plan as its C entry points take it: the attention
    core's ints (K2's core, or K4a's with ``quant_attn``), then each GEMM's
    (qkv, proj, up, down at M = b·n)."""
    m = b * n
    attn = (attention_q8_plan if quant_attn else attention_plan)(b, n, heads)
    gemms = (gemm_q8_plan(m, rows, depth)["ints"]
             for rows, depth in ((3 * c, c), (c, c), (hidden, c),
                                 (c, hidden)))
    return attn["ints"] + tuple(i for g in gemms for i in g)


def _plan_arg(ints):
    return (ctypes.c_int * len(ints))(*ints)


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


# ------------------------------- saved-activation training block: plain

def _attention_norm_first(qkv: torch.Tensor, bias: torch.Tensor,
                          heads: int):
    """The training block's attention (``_block_math_train``): as
    ``attention_parts``, but the probabilities p = e·(1/Σe) are rounded to
    the activation dtype before the value product, whose float32 sum is the
    output. Returns the output (B, N, C) and p (B, H, N, N), both in qkv's
    dtype."""
    dt, f32 = qkv.dtype, torch.float32
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    q = qkv[..., :c].reshape(b, n, heads, d) * d ** -0.5
    k = qkv[..., c : 2 * c].reshape(b, n, heads, d)
    v = qkv[..., 2 * c :].reshape(b, n, heads, d)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.to(f32), k.to(f32)) \
        + bias.to(f32)[None]
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = (e * (1.0 / e.sum(-1, keepdim=True))).to(dt)
    a = torch.einsum("bhnm,bmhd->bnhd", p.to(f32), v.to(f32))
    return a.reshape(b, n, c).to(dt), p


def block_train_ref(x: torch.Tensor, params, heads: int,
                    exact_gelu: bool = False):
    """Plain version of K5 (``_block_math_train``): one block's output and
    the residuals its backward reads, ``(out, (qkv, probs, gin, r))``, all
    in x's dtype: qkv (B, N, 3C), the normalized probabilities (B, H, N, N)
    (K6's layout; the JAX package concatenates the heads along each query
    row, (B, N, H·N)), the pre-GELU MLP activation gin = y2·W_up + b_up
    (B, N, hidden), kept in float32 for the GELU and saved rounded, and the
    post-attention residual r (B, N, C). The attention normalizes before
    its value product (``_attention_norm_first``), unlike ``block_ref``."""
    (l1s, l1b, wq, bq, bias, wp, bp, l2s, l2b, wu, bu, wd, bd) = params
    dt = x.dtype
    y = _ln(x, l1s, l1b).to(dt)
    qkv = _mm(y, wq).to(dt) + bq
    a, probs = _attention_norm_first(qkv, bias, heads)
    r = x + (_mm(a, wp).to(dt) + bp)
    y2 = _ln(r, l2s, l2b).to(dt)
    gin = _mm(y2, wu) + bu.to(torch.float32)
    out = r + (_mm(gelu(gin, exact_gelu).to(dt), wd).to(dt) + bd)
    return out, (qkv, probs, gin.to(dt), r)


def _ln_stats(x: torch.Tensor, eps: float = LN_EPS):
    """(x̂, 1/σ) of the two-pass float32 LayerNorm statistics."""
    m = x.to(torch.float32)
    mu = m.mean(-1, keepdim=True)
    rs = torch.rsqrt(((m - mu) ** 2).mean(-1, keepdim=True) + eps)
    return (m - mu) * rs, rs


def _ln_bwd(dy, xhat, rs, scale):
    """LayerNorm backward from the normalized input, float32: (dx,
    dscale, dbias)."""
    dxh = dy * scale
    dx = rs * (dxh - dxh.mean(-1, keepdim=True)
               - xhat * (dxh * xhat).mean(-1, keepdim=True))
    return dx, (dy * xhat).sum((0, 1)), dy.sum((0, 1))


@contextlib.contextmanager
def _products_for(dt: torch.dtype):
    """Float32 products of operands already rounded to ``dt``. With bf16
    operands (8 significant bits) TF32 (11) holds them exactly, so cuBLAS
    may take its TF32 tensor cores and still return the exact products
    summed in float32; any other dtype runs in full float32. The caller's
    setting is restored after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = dt == torch.bfloat16
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def block_train_bwd(x: torch.Tensor, params, saved, g: torch.Tensor,
                    heads: int, exact_gelu: bool = False):
    """The JAX package's ``_fused_block_bwd`` in torch: ``(dx, dparams)``
    of one block from its input, parameters, the residuals ``saved`` of
    ``block_train_ref`` (or K5) and the output gradient ``g``.

    Its rounding points, as the JAX package's: every product takes
    operands rounded to x's dtype and sums in float32; the GELU is
    re-derived from the saved (rounded) gin, the two LayerNorms with the
    two-pass statistics, the attention output as bf16(p·v); the qkv
    gradient stays float32 for its bias and is rounded only as a product
    operand; the bias gradient (H, N, N) sums over the batch in float32.
    dx comes in x's dtype and each parameter's gradient in that
    parameter's dtype."""
    (l1s, l1b, wq, bq, bias, wp, bp, l2s, l2b, wu, bu, wd, bd) = params
    qkv, probs, gin, r = saved
    f32, dt = torch.float32, x.dtype
    b, n, c = x.shape
    d = c // heads
    scale = d ** -0.5
    op = lambda t: t.to(dt).to(f32)  # a product operand, rounded to dt
    ein = torch.einsum
    with _products_for(dt):
        g32, gd = g.to(f32), op(g)
        # MLP: out = r + gelu(gin)·W_dn + b_dn
        with torch.enable_grad():
            gin32 = gin.detach().to(f32).requires_grad_(True)
            act = gelu(gin32, exact_gelu)
        dwd = ein("bnc,bnf->cf", gd, op(act.detach()))
        dact = ein("bnc,cf->bnf", gd, op(wd))
        dgin = torch.autograd.grad(act, gin32, dact)[0]
        del act, dact
        xhat2, rs2 = _ln_stats(r)
        dgin_t = op(dgin)
        dwu = ein("bnf,bnc->fc", dgin_t, op(xhat2 * l2s + l2b))
        dy2 = ein("bnf,fc->bnc", dgin_t, op(wu))
        del dgin_t
        dr_ln, dl2s, dl2b = _ln_bwd(dy2, xhat2, rs2, l2s)
        dr = g32 + dr_ln
        # projection: r = x + a·W_proj + b_proj
        q, k, v = (t.reshape(b, n, heads, d).to(f32)
                   for t in qkv.split(c, dim=-1))
        p = probs.to(f32)
        a = op(ein("bhnm,bmhd->bnhd", p, v)).reshape(b, n, c)
        drt = op(dr)
        dwp = ein("bnk,bnc->kc", drt, a)
        da = op(ein("bnk,kc->bnc", drt, op(wp))).reshape(b, n, heads, d)
        # attention, from the saved normalized probabilities
        dv = ein("bhnm,bnhd->bmhd", p, da)
        dp = ein("bnhd,bmhd->bhnm", da, v)
        dlog = p * (dp - (dp * p).sum(-1, keepdim=True))
        del dp
        dlt = op(dlog)
        dq = ein("bhnm,bmhd->bnhd", dlt, k) * scale
        dk = ein("bhnm,bnhd->bmhd", dlt, q) * scale
        dqkv = torch.cat([t.reshape(b, n, c) for t in (dq, dk, dv)], dim=-1)
        # qkv projection and LN1
        xhat1, rs1 = _ln_stats(x)
        dqkv_t = op(dqkv)
        dwq = ein("bnk,bnc->kc", dqkv_t, op(xhat1 * l1s + l1b))
        dy = ein("bnk,kc->bnc", dqkv_t, op(wq))
        dx_ln, dl1s, dl1b = _ln_bwd(dy, xhat1, rs1, l1s)
        grads = (dl1s, dl1b, dwq, dqkv.sum((0, 1)), dlog.sum(0), dwp,
                 dr.sum((0, 1)), dl2s, dl2b, dwu, dgin.sum((0, 1)), dwd,
                 g32.sum((0, 1)))
        dx = (dr + dx_ln).to(dt)
    return dx, tuple(gr.to(t.dtype) for gr, t in zip(grads, params))


def _block_xla(x: torch.Tensor, params, heads: int, exact_gelu: bool):
    """The JAX package's plain-XLA block (``_xla_block``, and the forward
    of ``block_act_amax``): the softmax normalized before the value
    product, the up product rounded to x's dtype before the bias. Returns
    the output and the activations ``block_act_amax`` taps: (LN1 out
    (f32), attention out, LN2 out (f32), GELU out, qkv)."""
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
    return r + o, (y, a, y2, h1, qkv)


def chain_grad_ref(x: torch.Tensor, params_list, heads: int,
                   exact_gelu: bool = False) -> torch.Tensor:
    """The function whose autograd gives a chain's gradients (the JAX
    package's ``_xla_chain``, recomputed in ``_fused_chain_bwd``):
    ``_block_xla`` block after block."""
    for p in params_list:
        x = _block_xla(x, p, heads, exact_gelu)[0]
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


def _int_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An einsum of int8 codes, exact, as float32: float64 holds every
    partial sum (|Σ| ≤ 127²·K < 2^53), and the one rounding to float32 is
    the int32 accumulator's own conversion."""
    return torch.einsum(eq, a.to(torch.float64),
                        b.to(torch.float64)).to(torch.float32)


def quantize_rows(t: torch.Tensor, static_scale=None):
    """``(codes, scale)`` of a float32 (M, K) activation as the w8a8 path
    quantizes a GEMM input: per row, codes rint(t / s) with s = max|row| /
    127 (1 for a zero row), scale (M,); or with ``static_scale`` (a
    calibrated scalar) codes rint(t · (1/s)) and that scale."""
    t = t.to(torch.float32)
    if static_scale is not None:
        return _codes(t * (1.0 / static_scale)), static_scale
    sr = _scale_from_amax(t.abs().amax(dim=-1))
    return _codes(t / sr[:, None]), sr


def _dequant(acc, w_scale, row_scale=None, static_scale=None):
    """Dequantized float32 s32 sums, in the JAX package's order: acc ·
    s_row · s_w left to right (``_qdot``), or acc · (s · s_w) with a static
    scale (``_qdot_static``)."""
    if static_scale is not None:
        return acc * (static_scale * w_scale)[None, :]
    return acc * row_scale[:, None] * w_scale[None, :]


def _qdot(y: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor):
    """float32 (M, K) × int8 (N, K)ᵀ with a dynamic per-row activation
    scale; returns the dequantized float32 (M, N), scaled left to right
    (acc · s_row · s_w) as the JAX package's ``_qdot``."""
    codes, sr = quantize_rows(y)
    return _dequant(_int_einsum("mk,nk->mn", codes, wq), s_w, row_scale=sr)


def _qdot_static(y: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
                 sr: torch.Tensor):
    """``_qdot`` with a calibrated static scale ``sr`` (0-d float32):
    codes = round(y · (1/sr)), dequantized as acc · (sr · s_w)."""
    codes, _ = quantize_rows(y, sr)
    return _dequant(_int_einsum("mk,nk->mn", codes, wq), s_w,
                    static_scale=sr)


# The int8 attention core of ``w8a8+attn`` (K4a): ``_attn_inner_q8`` and
# ``_attn_inner_q8s``. q and k are quantized per row over the head's d lanes
# (their scales separate out of the logits), v per column over the tokens
# (its scale separates out of p·v), and the softmax numerators e ∈ (0, 1],
# whose row maxima are exactly 1, take the fixed codes rint(127·e); the
# denominator is the sum of those codes, so the output is an exact convex
# combination under the quantized weights.

def _q8_operands(qkv: torch.Tensor, heads: int, static=None):
    """The int8 attention operands of a (B, N, 3C) qkv: ``(qi, sq, ki, sk,
    vi, sv)``, codes (B, N, H, D) int8 and float32 scales — per row (B, N,
    H, 1) for q and k, per column (B, 1, H, D) for v — or with ``static``
    (the calibrated (s_q, s_k, s_v), 0-d float32 each) those scalars, the
    codes then rint(t · (1/s))."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    q, k, v = (qkv[..., i * c : (i + 1) * c].reshape(b, n, heads, -1)
               .to(torch.float32) for i in range(3))
    if static is not None:
        s_q, s_k, s_v = static
        return (_codes(q * (1.0 / s_q)), s_q, _codes(k * (1.0 / s_k)), s_k,
                _codes(v * (1.0 / s_v)), s_v)
    sq = _scale_from_amax(q.abs().amax(-1, keepdim=True))
    sk = _scale_from_amax(k.abs().amax(-1, keepdim=True))
    sv = _scale_from_amax(v.abs().amax(1, keepdim=True))
    return _codes(q / sq), sq, _codes(k / sk), sk, _codes(v / sv), sv


def _attention_q8_core(qkv, bias, heads, static=None):
    b, n, c3 = qkv.shape
    d = c3 // 3 // heads
    scale = d ** -0.5
    qi, sq, ki, sk, vi, sv = _q8_operands(qkv, heads, static)
    acc = _int_einsum("bnhd,bmhd->bhnm", qi, ki)
    if static is None:
        # (acc · (s_q[n]·d^-½)) · s_k[m] + bias, left to right
        logits = acc * (sq * scale).permute(0, 2, 1, 3) \
            * sk.permute(0, 2, 3, 1)
    else:
        logits = acc * (sq * sk * scale)
    logits = logits + bias.to(torch.float32)[None]
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    pq = torch.round(e * 127.0)  # e ∈ (0, 1]: no clip
    av = _int_einsum("bhnm,bmhd->bnhd", pq, vi)
    recip = (1.0 / pq.sum(-1, keepdim=True)).permute(0, 2, 1, 3)
    return (av * recip * sv).reshape(b, n, -1).to(qkv.dtype)


def _attention_q8(qkv: torch.Tensor, bias: torch.Tensor,
                  heads: int) -> torch.Tensor:
    """Plain version of K4a with dynamic scales (``_attn_inner_q8``): (B,
    N, C) in qkv's dtype from a (B, N, 3C) qkv and an (H, N, N) bias. The
    logits are (acc · (s_q·d^-½)) · s_k + bias, the output (Σ pq·vi ·
    (1/Σ pq)) · s_v."""
    return _attention_q8_core(qkv, bias, heads)


def _attention_q8s(qkv: torch.Tensor, bias: torch.Tensor, heads: int,
                   s_q, s_k, s_v) -> torch.Tensor:
    """Plain version of K4a with calibrated static scales
    (``_attn_inner_q8s``): codes rint(t · (1/s)) of the scalars, logits
    acc · (s_q·s_k·d^-½) + bias, output (Σ pq·vi · (1/Σ pq)) · s_v."""
    return _attention_q8_core(qkv, bias, heads, (s_q, s_k, s_v))


def gemm_q8_ref(a: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                bias: torch.Tensor, epilogue: str, row_scale=None,
                static_scale=None, resid=None, out_scale=None):
    """Plain version of K4's s8 GEMM with one of its epilogues
    (``GEMM_Q8_EPILOGUES``): ``(out, aux)`` from int8 codes a (M, K), w (N,
    K) (nn.Linear's layout), w's scale (N,), the codes' row scales (M,)
    ``row_scale`` or calibrated scalar ``static_scale``, bias (N,) bf16 and,
    for ``bias_residual``, resid (M, N) bf16. dq is ``_qdot``'s (acc ·
    s_row · s_w) or ``_qdot_static``'s (acc · (s · s_w)); ``bias_cast``
    gives bf16(bf16(dq) + b), ``bias_residual`` bf16(resid + bf16(bf16(dq)
    + b)), ``bias_gelu`` the float32 h1 = gelu_tanh(dq + b) with aux =
    ``quantize_rows(h1)``, ``bias_gelu_codes`` h1's codes at the static
    ``out_scale``, ``acc`` the int32 sums themselves (aux None for all but
    ``bias_gelu``)."""
    if (row_scale is None) == (static_scale is None):
        raise ValueError("give one of row_scale and static_scale")
    if epilogue == "acc":
        return torch.einsum("mk,nk->mn", a.to(torch.float64),
                            w.to(torch.float64)).to(torch.int32), None
    y = _dequant(_int_einsum("mk,nk->mn", a, w), w_scale, row_scale,
                 static_scale)
    if epilogue in ("bias_gelu", "bias_gelu_codes"):
        h1 = gelu(y + bias.to(torch.float32))
        if epilogue == "bias_gelu":
            return h1, quantize_rows(h1)
        if out_scale is None:
            raise ValueError("bias_gelu_codes takes out_scale")
        return quantize_rows(h1, out_scale)[0], None
    if epilogue not in ("bias_cast", "bias_residual"):
        raise ValueError(f"unknown epilogue {epilogue!r}")
    out = y.to(bias.dtype) + bias
    if epilogue == "bias_residual":
        out = resid + out
    return out, None


def attention_q8_ref(qkv: torch.Tensor, bias: torch.Tensor, heads: int,
                     static=None) -> torch.Tensor:
    """Plain version of K4a's core alone: ``_attention_q8`` on a (B, N, 3C)
    qkv, or with ``static`` (the calibrated (s_q, s_k, s_v), a (3,) float32
    or three scalars) ``_attention_q8s``."""
    if static is None:
        return _attention_q8(qkv, bias, heads)
    return _attention_q8s(qkv, bias, heads, *static)


def block_ref_q8(x: torch.Tensor, qparams, heads: int,
                 exact_gelu: bool = False,
                 quant_attn: bool = False) -> torch.Tensor:
    """Plain version of one w8a8 block (``_block_math_q8``): the four GEMMs
    int8, their inputs quantized from float32 (the LayerNorm outputs and
    the GELU output are never cast to the activation dtype), attention as
    in ``block_ref`` or, with ``quant_attn``, int8 (``_attention_q8``; with
    the 18-tuple's static scales ``_attention_q8s`` on its entries 4–6).
    ``qparams`` is the 17- or 18-tuple of ``quantize_block_params``."""
    (l1s, l1b, wq, sq, bq, bias, wp, sp, bp, l2s, l2b,
     wu, su, bu, wd, sd, bd) = qparams[:17]
    s_act = qparams[17] if len(qparams) == 18 else None
    if s_act is not None:
        qd = lambda t, w, s, i: _qdot_static(t, w, s, s_act[i])
    else:
        qd = lambda t, w, s, i: _qdot(t, w, s)
    dt = x.dtype
    b, n, c = x.shape
    y = _ln(x, l1s, l1b).reshape(b * n, c)
    qkv = (qd(y, wq, sq, 0).to(dt) + bq).reshape(b, n, 3 * c)
    if quant_attn and s_act is not None:
        a = _attention_q8s(qkv, bias, heads, s_act[4], s_act[5], s_act[6])
    elif quant_attn:
        a = _attention_q8(qkv, bias, heads)
    else:
        a = _attention(qkv, bias, heads)
    p = qd(a.reshape(b * n, c).to(torch.float32), wp, sp, 1).to(dt) + bp
    r = x + p.reshape(b, n, c)
    y2 = _ln(r, l2s, l2b).reshape(b * n, c)
    h1 = gelu(qd(y2, wu, su, 2) + bu.to(torch.float32), exact_gelu)
    o = qd(h1, wd, sd, 3).to(dt) + bd
    return r + o.reshape(b, n, c)


def chain_ref_q8(x: torch.Tensor, qparams_list, heads: int,
                 exact_gelu: bool = False,
                 quant_attn: bool = False) -> torch.Tensor:
    """Plain version of a w8a8 stage: ``block_ref_q8`` back to back."""
    for p in qparams_list:
        x = block_ref_q8(x, p, heads, exact_gelu, quant_attn).to(x.dtype)
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
    out, (y, a, y2, h1, qkv) = _block_xla(x, params, heads, exact_gelu)
    c = x.shape[-1]
    f32 = torch.float32
    amax = torch.stack([
        y.abs().max(), a.to(f32).abs().max(), y2.abs().max(), h1.abs().max(),
        qkv[..., :c].to(f32).abs().max(),
        qkv[..., c : 2 * c].to(f32).abs().max(),
        qkv[..., 2 * c :].to(f32).abs().max(),
    ])
    return out, amax


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


def _on_cuda(t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA one
    (the kernel runs); any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cuda"


def _needs_grad(x: torch.Tensor, params_list) -> bool:
    """Grad mode is on and the activation or a parameter requires grad."""
    return torch.is_grad_enabled() and (
        x.requires_grad
        or any(t.requires_grad for p in params_list for t in p))


def _pointers(params_list):
    flat = [t for p in params_list for t in p]
    return (ctypes.c_void_p * len(flat))(*[t.data_ptr() for t in flat])


def _launch(fn_name, x, params_list, heads):
    b, n, c, hidden = _check_cuda(x, params_list, heads)
    m = b * n
    out = torch.empty_like(x)
    qkv = torch.empty((m, 3 * c), dtype=x.dtype, device=x.device)
    att = torch.empty((m, c), dtype=x.dtype, device=x.device)
    r = torch.empty((m, c), dtype=x.dtype, device=x.device)
    h = torch.empty((m, hidden), dtype=x.dtype, device=x.device)
    ptrs = _pointers(params_list)
    plan = _plan_arg(block_plan(b, n, c, heads, hidden))
    lib = build.load("fused_block", _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    shape = (b, n, c, heads, hidden)
    if fn_name == "dm_block_forward":
        err = lib.dm_block_forward(x.data_ptr(), out.data_ptr(), *shape, ptrs,
                                   qkv.data_ptr(), att.data_ptr(),
                                   r.data_ptr(), h.data_ptr(), plan, stream)
    else:
        err = lib.dm_chain_forward(x.data_ptr(), out.data_ptr(), *shape,
                                   len(params_list), ptrs, qkv.data_ptr(),
                                   att.data_ptr(), r.data_ptr(), h.data_ptr(),
                                   plan, stream)
    build.check(lib, err, fn_name)
    return out


def _require_tanh_gelu(exact_gelu):
    if exact_gelu:
        raise NotImplementedError(
            "exact (erf) GELU has no CUDA block kernel yet — it runs on the "
            "attention-only kernel path, ROADMAP.md queue B, K7"
        )


def fused_block_train(x: torch.Tensor, params, heads: int,
                      exact_gelu: bool = False):
    """K5, the training forward of one block: ``(out, (qkv, probs, gin,
    r))`` as ``block_train_ref`` returns them.

    CPU tensors run ``block_train_ref``. CUDA tensors (bf16) launch the
    CUDA training block (``csrc/fused_block.cu``,
    ``dm_block_train_forward``) and count the launch in
    ``fused_block_train.launches``.
    """
    if not _on_cuda(x):
        return block_train_ref(x, params, heads, exact_gelu)
    _require_tanh_gelu(exact_gelu)
    params = tuple(params)
    b, n, c, hidden = _check_cuda(x, [params], heads)
    empty = lambda *shape: torch.empty(shape, dtype=x.dtype, device=x.device)
    out, r, att = empty(b, n, c), empty(b, n, c), empty(b * n, c)
    qkv, probs = empty(b, n, 3 * c), empty(b, heads, n, n)
    gin, h = empty(b, n, hidden), empty(b * n, hidden)
    lib = build.load("fused_block", _SIGNATURES)
    err = lib.dm_block_train_forward(
        x.data_ptr(), out.data_ptr(), b, n, c, heads, hidden,
        _pointers([params]), qkv.data_ptr(), probs.data_ptr(),
        gin.data_ptr(), r.data_ptr(), att.data_ptr(), h.data_ptr(),
        _plan_arg(block_plan(b, n, c, heads, hidden)),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "dm_block_train_forward")
    fused_block_train.launches += 1
    return out, (qkv, probs, gin, r)


class _BlockTrain(torch.autograd.Function):
    """Forward through ``fused_block_train`` (K5 on CUDA), saving x, the
    parameters and the four residuals; backward ``block_train_bwd`` (the
    JAX package's ``_fused_block_vjp``)."""

    @staticmethod
    def forward(ctx, x, heads, exact_gelu, *params):
        out, saved = fused_block_train(x, params, heads, exact_gelu)
        ctx.save_for_backward(x, *params, *saved)
        ctx.heads, ctx.exact_gelu = heads, exact_gelu
        return out

    @staticmethod
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        dx, dparams = block_train_bwd(x, rest[:N_PARAMS], rest[N_PARAMS:], g,
                                      ctx.heads, ctx.exact_gelu)
        return (dx, None, None, *dparams)


class _ChainTrain(torch.autograd.Function):
    """Forward through the chain (K3 on CUDA), saving x and the parameters;
    backward by autograd of ``chain_grad_ref`` recomputed from them (the
    JAX package's ``_fused_chain_vjp``)."""

    @staticmethod
    def forward(ctx, x, heads, exact_gelu, *flat):
        ctx.save_for_backward(x, *flat)
        ctx.heads, ctx.exact_gelu = heads, exact_gelu
        return _chain_forward(x, _unflatten(flat), heads, exact_gelu)

    @staticmethod
    def backward(ctx, g):
        x, *flat = (t.detach().requires_grad_(True)
                    for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = chain_grad_ref(x, _unflatten(flat), ctx.heads,
                                 ctx.exact_gelu)
        dx, *dflat = torch.autograd.grad(out, [x, *flat], g)
        return (dx, None, None, *dflat)


def _unflatten(flat):
    return [tuple(flat[i : i + N_PARAMS])
            for i in range(0, len(flat), N_PARAMS)]


def fused_block(x: torch.Tensor, params, heads: int,
                exact_gelu: bool = False) -> torch.Tensor:
    """One pre-LN block, (B, N, C) → (B, N, C) in x's dtype.

    Under grad mode with an input that requires grad, the differentiable
    training path (``fused_block_train`` forward, ``block_train_bwd``
    backward). Otherwise CPU tensors run ``block_ref`` and CUDA tensors
    (bf16) launch the CUDA block (``csrc/fused_block.cu``,
    ``dm_block_forward``), counted in ``fused_block.launches``.
    """
    if _needs_grad(x, [params]):
        return _BlockTrain.apply(x, heads, exact_gelu, *params)
    if not _on_cuda(x):
        return block_ref(x, params, heads, exact_gelu)
    _require_tanh_gelu(exact_gelu)
    out = _launch("dm_block_forward", x, [tuple(params)], heads)
    fused_block.launches += 1
    return out


def _chain_forward(x, params_list, heads, exact_gelu):
    if not _on_cuda(x):
        return chain_ref(x, params_list, heads, exact_gelu)
    _require_tanh_gelu(exact_gelu)
    out = _launch("dm_chain_forward", x, params_list, heads)
    fused_block_chain.launches += 1
    return out


def fused_block_chain(x: torch.Tensor, params_list, heads: int,
                      exact_gelu: bool = False) -> torch.Tensor:
    """A stage: ``len(params_list)`` blocks back to back.

    CPU tensors run ``chain_ref``. CUDA tensors (bf16) launch the CUDA
    chain (``csrc/fused_block.cu``, ``dm_chain_forward``) and count the
    launch in ``fused_block_chain.launches``. Under grad mode with an input
    that requires grad, a single block takes ``fused_block``'s training
    path, and several blocks the chain forward with a backward that
    recomputes ``chain_grad_ref``.
    """
    params_list = [tuple(p) for p in params_list]
    if not params_list:
        raise ValueError("a chain needs at least one block")
    if _needs_grad(x, params_list):
        if len(params_list) == 1:
            return _BlockTrain.apply(x, heads, exact_gelu, *params_list[0])
        return _ChainTrain.apply(x, heads, exact_gelu,
                                 *(t for p in params_list for t in p))
    return _chain_forward(x, params_list, heads, exact_gelu)


fused_block.launches = 0
fused_block_chain.launches = 0
fused_block_train.launches = 0


# ----------------------------------------------------- K2's GEMM on its own

def gemm_ref(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
             epilogue: str, resid: torch.Tensor | None = None):
    """Plain version of K2's GEMM with one of its epilogues
    (``GEMM_EPILOGUES``): ``(out, aux)`` from a (M, K), nn.Linear's w (N,
    K), bias (N,) and, for ``bias_residual``, resid (M, N), all in a's
    dtype. The sum is float32; ``bias_cast`` gives bf16(bf16(acc) + b),
    ``bias_residual`` bf16(resid + bf16(bf16(acc) + b)), ``bias_gelu``
    bf16(gelu_tanh(acc + b)) and ``bias_gelu_save`` that and aux =
    bf16(acc + b) (aux is None for the others)."""
    dt = a.dtype
    acc = _mm(a, w)
    if epilogue in ("bias_gelu", "bias_gelu_save"):
        g = acc + bias.to(torch.float32)
        aux = g.to(dt) if epilogue == "bias_gelu_save" else None
        return gelu(g).to(dt), aux
    if epilogue not in ("bias_cast", "bias_residual"):
        raise ValueError(f"unknown epilogue {epilogue!r}")
    y = acc.to(dt) + bias
    if epilogue == "bias_residual":
        y = resid + y
    return y, None


def _check_gemm(a, w, bias, epilogue, resid):
    if epilogue not in GEMM_EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    want_resid = epilogue == "bias_residual"
    if want_resid != (resid is not None):
        raise ValueError(f"{epilogue} takes {'a' if want_resid else 'no'} "
                         "residual")
    tensors = (a, w, bias) + ((resid,) if want_resid else ())
    for t in tensors:
        if (t.dtype != torch.bfloat16 or not t.is_contiguous()
                or t.device != a.device or t.data_ptr() % 16):
            raise TypeError("the CUDA GEMM takes contiguous bf16 tensors on "
                            "one device, 16-byte aligned (TMA's bases)")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(f"a (M, K) and w (N, K), got {tuple(a.shape)} and "
                         f"{tuple(w.shape)}")
    m, k = a.shape
    n = w.shape[0]
    if tuple(bias.shape) != (n,) or (want_resid
                                     and tuple(resid.shape) != (m, n)):
        raise ValueError("bias must be (N,) and resid (M, N)")
    return m, n, k, gemm_plan(m, n, k)


def gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
         epilogue: str, resid: torch.Tensor | None = None):
    """K2's GEMM with one of its epilogues, on its own: ``(out, aux)`` as
    ``gemm_ref`` returns them. The blocks launch it from C; this entry
    serves its measurement and tests.

    CPU tensors run ``gemm_ref``. CUDA tensors (bf16, K % 64 == 0, N % 8
    == 0, 16-byte aligned) launch ``csrc/fused_block.cu`` (``dm_gemm``)
    and count the launch in ``gemm.launches``; anything else raises.
    """
    if not _on_cuda(a):
        return gemm_ref(a, w, bias, epilogue, resid)
    m, n, k, plan = _check_gemm(a, w, bias, epilogue, resid)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    aux = (torch.empty_like(out) if epilogue == "bias_gelu_save" else None)
    lib = build.load("fused_block", _SIGNATURES)
    err = lib.dm_gemm(a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                      resid.data_ptr() if resid is not None else None,
                      out.data_ptr(),
                      aux.data_ptr() if aux is not None else None,
                      m, n, k, GEMM_EPILOGUES.index(epilogue),
                      _plan_arg(plan["ints"]),
                      torch.cuda.current_stream(a.device).cuda_stream)
    build.check(lib, err, "dm_gemm")
    gemm.launches += 1
    return out, aux


gemm.launches = 0


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


def _launch_q8(fn_name, x, qparams_list, heads, quant_attn):
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
    row_amax = torch.empty((m,), dtype=torch.float32, device=dev)
    ptrs = _pointers(qparams_list)
    plan = _plan_arg(block_plan_q8(b, n, c, heads, hidden, quant_attn))
    lib = build.load("fused_block_q8", _SIGNATURES_Q8)
    stream = torch.cuda.current_stream(dev).cuda_stream
    shape = (b, n, c, heads, hidden)
    flags = (int(static), int(quant_attn))
    scratch = (qkv.data_ptr(), att.data_ptr(), r.data_ptr(), h.data_ptr(),
               codes.data_ptr(), row_scale.data_ptr(), row_amax.data_ptr())
    if fn_name == "dm_block_forward_q8":
        err = lib.dm_block_forward_q8(x.data_ptr(), out.data_ptr(), *shape,
                                      ptrs, *flags, *scratch, plan, stream)
    else:
        err = lib.dm_chain_forward_q8(x.data_ptr(), out.data_ptr(), *shape,
                                      len(qparams_list), ptrs, *flags,
                                      *scratch, plan, stream)
    build.check(lib, err, fn_name)
    return out


def _refuse_grad(x, qparams_list):
    if _needs_grad(x, qparams_list):
        raise RuntimeError(
            "the w8a8 block kernels are inference-only (as the JAX "
            "package's quant path): run them under torch.no_grad() or on "
            "inputs that do not require grad")


def fused_block_q8(x: torch.Tensor, qparams, heads: int,
                   exact_gelu: bool = False,
                   quant_attn: bool = False) -> torch.Tensor:
    """One w8a8 block, (B, N, C) → (B, N, C) in x's dtype; ``qparams`` from
    ``quantize_block_params`` (17 entries, or 18 with static scales);
    ``quant_attn`` runs the attention int8 too (K4a).

    CPU tensors run ``block_ref_q8``. CUDA tensors (bf16) launch the CUDA
    w8a8 block (``csrc/fused_block_q8.cu``, ``dm_block_forward_q8``) and
    count the launch in ``fused_block_q8.launches``, or with
    ``quant_attn`` in ``fused_block_q8_attn.launches``. Inference only.
    """
    _refuse_grad(x, [qparams])
    if not _on_cuda(x):
        return block_ref_q8(x, qparams, heads, exact_gelu, quant_attn)
    _require_tanh_gelu(exact_gelu)
    out = _launch_q8("dm_block_forward_q8", x, [tuple(qparams)], heads,
                     quant_attn)
    (fused_block_q8_attn if quant_attn else fused_block_q8).launches += 1
    return out


def fused_block_chain_q8(x: torch.Tensor, qparams_list, heads: int,
                         exact_gelu: bool = False,
                         quant_attn: bool = False) -> torch.Tensor:
    """A w8a8 stage: ``len(qparams_list)`` blocks back to back.

    CPU tensors run ``chain_ref_q8``. CUDA tensors (bf16) launch the CUDA
    w8a8 chain (``csrc/fused_block_q8.cu``, ``dm_chain_forward_q8``) and
    count the launch in ``fused_block_chain_q8.launches``, or with
    ``quant_attn`` in ``fused_block_chain_q8_attn.launches``. Inference
    only.
    """
    qparams_list = [tuple(p) for p in qparams_list]
    if not qparams_list:
        raise ValueError("a chain needs at least one block")
    _refuse_grad(x, qparams_list)
    if not _on_cuda(x):
        return chain_ref_q8(x, qparams_list, heads, exact_gelu, quant_attn)
    _require_tanh_gelu(exact_gelu)
    out = _launch_q8("dm_chain_forward_q8", x, qparams_list, heads,
                     quant_attn)
    (fused_block_chain_q8_attn if quant_attn
     else fused_block_chain_q8).launches += 1
    return out


def fused_block_q8_attn(x: torch.Tensor, qparams, heads: int,
                        exact_gelu: bool = False) -> torch.Tensor:
    """K4a: ``fused_block_q8`` with the int8 attention core."""
    return fused_block_q8(x, qparams, heads, exact_gelu, quant_attn=True)


def fused_block_chain_q8_attn(x: torch.Tensor, qparams_list, heads: int,
                              exact_gelu: bool = False) -> torch.Tensor:
    """K4a: ``fused_block_chain_q8`` with the int8 attention core."""
    return fused_block_chain_q8(x, qparams_list, heads, exact_gelu,
                                quant_attn=True)


fused_block_q8.launches = 0
fused_block_chain_q8.launches = 0
fused_block_q8_attn.launches = 0
fused_block_chain_q8_attn.launches = 0


# ------------------------------------ K4's s8 GEMM and K4a's core on their own

def _check_gemm_q8(a, w, w_scale, bias, epilogue, row_scale, static_scale,
                   resid, out_scale):
    if epilogue not in GEMM_Q8_EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if (row_scale is None) == (static_scale is None):
        raise ValueError("give one of row_scale and static_scale")
    if (epilogue == "bias_residual") != (resid is not None):
        raise ValueError(f"{epilogue} takes "
                         f"{'a' if resid is None else 'no'} residual")
    if (epilogue == "bias_gelu_codes") != (out_scale is not None):
        raise ValueError("bias_gelu_codes, and only it, takes out_scale")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(f"a (M, K) and w (N, K), got {tuple(a.shape)} and "
                         f"{tuple(w.shape)}")
    m, k = a.shape
    n = w.shape[0]
    i8, f32, bf = torch.int8, torch.float32, torch.bfloat16
    want = [(a, i8, (m, k)), (w, i8, (n, k)), (w_scale, f32, (n,)),
            (bias, bf, (n,))]
    if row_scale is not None:
        want.append((row_scale, f32, (m,)))
    else:
        want.append((static_scale, f32, (1,)))
    if resid is not None:
        want.append((resid, bf, (m, n)))
    if out_scale is not None:
        want.append((out_scale, f32, (1,)))
    for t, dt, shape in want:
        if (t.dtype != dt or tuple(t.shape) != shape
                or t.device != a.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise TypeError(f"the s8 GEMM wants a contiguous {dt} {shape} on "
                            f"{a.device}, 16-byte aligned (TMA's bases); got "
                            f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return m, n, k, gemm_q8_plan(m, n, k)


def gemm_q8(a: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
            bias: torch.Tensor, epilogue: str, row_scale=None,
            static_scale=None, resid=None, out_scale=None):
    """K4's s8 GEMM with one of its epilogues, on its own: ``(out, aux)``
    as ``gemm_q8_ref`` returns them (``static_scale`` and ``out_scale`` as
    (1,) tensors). The blocks launch it from C; this entry serves its
    measurement and tests.

    CPU tensors run ``gemm_q8_ref``. CUDA tensors (K % 128 == 0, N % 8 ==
    0, 16-byte aligned) launch ``csrc/fused_block_q8.cu`` (``dm_gemm_q8``;
    ``bias_gelu`` also runs the quantize pass of its codes) and count the
    launch in ``gemm_q8.launches``; anything else raises.
    """
    if not _on_cuda(a):
        return gemm_q8_ref(a, w, w_scale, bias, epilogue, row_scale,
                           static_scale, resid, out_scale)
    m, n, k, plan = _check_gemm_q8(a, w, w_scale, bias, epilogue,
                                   row_scale, static_scale, resid, out_scale)
    dev = a.device
    empty = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)
    codes = scales = amax = None
    if epilogue == "bias_gelu":
        out = empty((m, n), torch.float32)
        codes, scales = empty((m, n), torch.int8), empty((m,), torch.float32)
        amax = torch.zeros((m,), dtype=torch.float32, device=dev)
    elif epilogue == "bias_gelu_codes":
        out = empty((m, n), torch.int8)
    elif epilogue == "acc":
        out = empty((m, n), torch.int32)
    else:
        out = empty((m, n), torch.bfloat16)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = build.load("fused_block_q8", _SIGNATURES_Q8)
    err = lib.dm_gemm_q8(ptr(a), ptr(w), ptr(w_scale), ptr(row_scale),
                         ptr(static_scale), ptr(bias), ptr(resid), ptr(out),
                         ptr(codes), ptr(scales), ptr(amax), ptr(out_scale),
                         m, n, k, GEMM_Q8_EPILOGUES.index(epilogue),
                         _plan_arg(plan["ints"]),
                         torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "dm_gemm_q8")
    gemm_q8.launches += 1
    return out, ((codes, scales) if epilogue == "bias_gelu" else None)


def attention_q8(qkv: torch.Tensor, bias: torch.Tensor, heads: int,
                 static=None, plan=None) -> torch.Tensor:
    """K4a's int8 core on its own: (B, N, C) in qkv's dtype from a (B, N,
    3C) qkv and an (H, N, N) float32 bias, dynamic scales or ``static``
    (s_q, s_k, s_v) (a (3,) float32 tensor on the CUDA path).

    CPU tensors run ``attention_q8_ref``. CUDA tensors (bf16, d = 64, 1 <=
    N <= 256) launch ``csrc/fused_block_q8.cu`` (``dm_attention_q8``) with
    ``plan`` (an ``attention_q8_plan`` of these shapes; the default one if
    None) and count the launch in ``attention_q8.launches``; anything else
    raises.
    """
    if not _on_cuda(qkv):
        return attention_q8_ref(qkv, bias, heads, static)
    if qkv.dtype != torch.bfloat16 or qkv.dim() != 3 or \
            not qkv.is_contiguous():
        raise TypeError(f"qkv must be a contiguous (B, N, 3C) bf16 tensor, "
                        f"got {qkv.dtype} {tuple(qkv.shape)}")
    b, n, c3 = qkv.shape
    c = c3 // 3
    if c3 % 3 or c != heads * HEAD_DIM:
        raise ValueError(f"the int8 attention needs 3C with C == heads*"
                         f"{HEAD_DIM}; got 3C={c3}, heads={heads}")
    if (bias.dtype != torch.float32 or tuple(bias.shape) != (heads, n, n)
            or bias.device != qkv.device or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous float32 ({heads}, {n}, "
                         f"{n}) on {qkv.device}")
    if static is not None and (
            static.dtype != torch.float32 or tuple(static.shape) != (3,)
            or static.device != qkv.device or not static.is_contiguous()):
        raise ValueError("static must be a contiguous float32 (3,) tensor "
                         f"on {qkv.device}")
    plan = plan or attention_q8_plan(b, n, heads)
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    lib = build.load("fused_block_q8", _SIGNATURES_Q8)
    err = lib.dm_attention_q8(
        qkv.data_ptr(), bias.data_ptr(),
        None if static is None else static.data_ptr(), out.data_ptr(), b, n,
        c, heads, _plan_arg(plan["ints"]),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    build.check(lib, err, "dm_attention_q8")
    attention_q8.launches += 1
    return out


gemm_q8.launches = 0
attention_q8.launches = 0
