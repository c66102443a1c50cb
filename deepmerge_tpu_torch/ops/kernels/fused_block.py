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

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from deepmerge_tpu_torch.ops.kernels import build

LN_EPS = 1e-5
N_PARAMS = 13
# The attention cores' template instances: a head of width d (any multiple
# of HEAD_DIM_STEP up to 256) runs on the instance of width core_width(d),
# K's and V's lanes past d zero-filled (so they add 0) and never written.
# Any other width up to MAX_HEAD_DIM travels on a zero-padded layout of
# width round_up(d, HEAD_DIM_STEP) (``PaddedWidths``).
# The short cores have the instances of SHORT_CORE_WIDTHS only: a wider
# head takes the long route at every N. A head wider than 256 (up to
# MAX_HEAD_DIM) takes the long route's wide form, WIDE_CORE, which runs d
# in chunks of WIDE_LANES lanes
CORE_WIDTHS = (32, 64, 128, 256)
SHORT_CORE_WIDTHS = (32, 64, 128)
HEAD_DIM_STEP = 8    # 16-byte rows of bf16 (TMA's strides)
MAX_HEAD_DIM = 8192
WIDE_CORE = MAX_HEAD_DIM  # core_width of every head wider than 256
WIDE_LANES = 128
MAX_TOKENS = 256   # the short (register-resident) attention cores' longest
MAX_LONG_TOKENS = 16_384  # the long route's longest sequence
MAX_WIDTH = 1024   # the one-warp LayerNorm kernels' widest row
MAX_LONG_WIDTH = 8192  # the wide LayerNorm kernels' widest row

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# "widths" below: A (the attention's layout width), c_norm and d_scale (the
# true C of the LayerNorms' statistics and the true d of q's scale), as
# ``PaddedWidths.launch_widths`` gives them
_SIGNATURES = {
    # x, out, B, N, C, H, hidden, widths, params, qkv, att, r, h, h bytes,
    # plan, stream
    "dm_block_forward": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                         _P, _P, _L, _P, _P],
    # x, out, B, N, C, H, hidden, widths, depth, params, qkv, att, r, h,
    # h bytes, plan, stream
    "dm_chain_forward": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                         _P, _P, _P, _L, _P, _P],
    # x, out, B, N, C, H, hidden, widths, params, qkv, probs, gin, r, att,
    # h, h bytes, plan, stream
    "dm_block_train_forward": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                               _P, _P, _P, _P, _P, _P, _L, _P, _P],
    # a, w, bias, resid, out, aux, M, N, K, epilogue, plan, stream
    "dm_gemm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # x, w, b, y, M, C, c_norm, stream
    "dm_layer_norm": [_P, _P, _P, _P, _I, _I, _I, _P],
}
_SIGNATURES_Q8 = {
    # x, out, B, N, C, H, hidden, widths, params, static, quant_attn, qkv,
    # att, r, h, h bytes, codes, row_scale, row_amax, plan, stream
    "dm_block_forward_q8": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I,
                            _I, _P, _P, _P, _P, _L, _P, _P, _P, _P, _P],
    # x, out, B, N, C, H, hidden, widths, depth, params, static, quant_attn,
    # qkv, att, r, h, h bytes, codes, row_scale, row_amax, plan, stream
    "dm_chain_forward_q8": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                            _I, _I, _P, _P, _P, _P, _L, _P, _P, _P, _P, _P],
    # a, w, w_scale, row_scale, static_scale, bias, resid, out, codes,
    # out_row_scale, row_amax, out_scale, M, N, K, epilogue, plan, stream
    "dm_gemm_q8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                   _I, _I, _P, _P],
    # qkv, bias, s_qkv, out, B, N, C, H, d_scale, plan, scratch, scratch
    # bytes, stream
    "dm_attention_q8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _L, _P],
    # qkv, s_qkv, scratch, scratch bytes, B, N, C, H, stream
    "dm_attention_q8_prepass": [_P, _P, _P, _L, _I, _I, _I, _I, _P],
    # x, w, b, static_scale, codes, row_scale, M, C, c_norm, stream
    "dm_ln_quant": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}
Q8_K_SLAB = 128    # the s8 GEMM's K slab (128 bytes, as K2's 64 bf16)
# the GEMMs' K: rows a multiple of 16 bytes (TMA's stride), a K tail past
# the last whole slab read as zeros; the blocks' padded layouts round C,
# the attention's width and the MLP width up to it (``PaddedWidths``)
GEMM_K_ALIGN = 8   # bf16
Q8_K_ALIGN = 16    # int8

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

# The bf16 attention core (csrc/block_common.cuh), a template of the core
# width kD = core_width(d): a CTA of `warps` warps per head and `samples`
# samples, K and V of a sample in shared memory at a row stride of kD + 8
# bf16, register arrays sized by a bucket of the 16-key tile count; its
# launch bound is 12 warps (168 registers a thread) at widths 32 and 64,
# and 8 warps (255 registers) at width 128, whose O accumulators double.
# Every table below is keyed by the core width.
ATTN_KEY_TILE_BUCKETS = (1, 3, 4, 8, 12, 13, 16)
ATTN_MAX_WARPS = {32: 12, 64: 12, 128: 8}
ATTN_REGISTERS = {32: 168, 64: 168, 128: 255}
ATTN_WARPS = 4


def head_dim_ok(d: int) -> bool:
    """Whether the CUDA entry points take heads of width ``d``: any width
    up to ``MAX_HEAD_DIM``, as the JAX package's kernels do. A width that
    is not a multiple of ``HEAD_DIM_STEP`` (the only ones the C side's
    ``head_dim_ok`` takes) runs on the zero-padded layout of width
    ``round_up(d, HEAD_DIM_STEP)`` (``PaddedWidths``)."""
    return 1 <= d <= MAX_HEAD_DIM


def core_width(d: int) -> int:
    """The core instance a head of width ``d`` runs on (the C side's
    ``core_width``): 32 up to 32, 64 up to 64, 128 up to 128, 256 up to
    256, else the long route's wide form ``WIDE_CORE``."""
    return next((w for w in CORE_WIDTHS if d <= w), WIDE_CORE)


def wide_chunks(d: int) -> int:
    """The wide form's 128-lane chunks of a head of width ``d`` (its S
    products' chunks and its second pass's parts): ceil(d / 128)."""
    return -(-d // WIDE_LANES)


def attention_long_parts(d: int) -> int:
    """The long route's second-pass parts at head width ``d``: 1 up to
    128, 2 on the 256 instance, ``wide_chunks(d)`` on the wide form."""
    w = core_width(d)
    return wide_chunks(d) if w == WIDE_CORE else ATTN_LONG_PARTS[w]


def _refuse_head_dim(d: int, what: str) -> None:
    if not head_dim_ok(d):
        raise ValueError(
            f"{what} takes heads of width 1..{MAX_HEAD_DIM}, got {d}; wider "
            "heads are open work (ROADMAP.md)")


def check_head_dim(c: int, heads: int) -> int:
    """The head width ``c // heads`` if the attention cores take it
    (``head_dim_ok``; ``heads`` must divide ``c``, as the JAX package's
    reshape needs); raises ``ValueError`` otherwise."""
    d = c // heads if heads > 0 and c % heads == 0 else 0
    if not head_dim_ok(d):
        raise ValueError(
            f"the CUDA attention cores take heads of width 1..{MAX_HEAD_DIM}"
            f", got C={c} over {heads} heads; wider heads are open work "
            "(ROADMAP.md)")
    return d


def attn_row_bytes(head_dim: int) -> int:
    """The bf16 core's shared K/V row stride at head width ``head_dim``:
    kD + 8 bf16 at its core width kD, an odd multiple of 16 bytes
    (conflict-free ldmatrix)."""
    return (core_width(head_dim) + 8) * 2
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


# The long route of the bf16 core (csrc/block_common.cuh
# attention_long_kernel): a CTA takes 128 queries of one head and
# ATTN_LONG_SAMPLES samples at a time, two warpgroups a sample (64 query
# rows each, the wgmma M); warp 0 streams K and V by TMA through a ring in
# shared memory, in 64-key blocks, twice (the row max and Σe, then the
# probabilities and P·V; at width 256 pass 2 runs once for each of
# ATTN_LONG_PARTS halves of the head's lanes, O and V of 128 lanes a part,
# the S products recomputed), and the f32 bias in one of three forms
# (``attention_long_bias``): the CTA's 128 bias rows once (a slab) where
# they fit the bias region, its CTAs then taking several sample groups each
# (``attention_long_groups``); else a 128 x 64 tile a stage by TMA where
# N % 4 == 0; else row copies. The grid is (query blocks, sample groups,
# heads). Every variant takes all of a CTA's shared memory. Its plan's
# first int is ATTN_LONG_ROUTE, which no short plan has (their first int is
# a bucket >= 1). Registers a thread: ptxas's most over the variants of each
# width (nvcc 12.9, sm_90a; the launch bound of one CTA an SM allows 128 at
# 16 warps, 255 at 8; 8-16 bytes spill in the slab/row forms at width 32
# and with probabilities at 64; none at 256, 234-254 over its variants).
#
# Heads wider than 256 take the wide form (csrc/block_common.cuh
# attention_wide_kernel, core width WIDE_CORE): one sample and 8 warps a
# CTA, S summed over the head's 128-lane chunks, Q' made again from q's
# rows at each chunk; pass 2 computes S once more a key block and writes P
# = bf16(e) once into the CTA's slot of a scratch (``wide_scratch``: one
# slot of 128 x Np bf16 for each CTA of its persistent grid of about
# WIDE_CTAS CTAs, ``wide_sample_groups``), then runs P·V once for each of
# ``wide_chunks(d)`` 128-lane parts of O. Each step one 16 KB tile (K's
# chunk or V's part) through a ring of WIDE_SLOTS slots that a producer
# warpgroup fills (the CTA's third; the plan's 8 warps are the two
# consumer warpgroups), the bias with each key block's last chunk in one
# of three areas. Registers: 168 a thread at launch (ptxas, the bound of
# 384 threads), then setmaxnreg moves them to 232 in the consumers and 40
# in the producer warpgroup (csrc/block_common.cuh); 4 bytes spill in one
# variant (no probabilities, no tiles), and in two of the int8 core's.
ROUTES = ("short", "long")
ATTN_LONG_ROUTE = 0
ATTN_LONG_QUERIES = 128
ATTN_LONG_KEYS = 64
ATTN_LONG_SAMPLES = {32: 2, 64: 2, 128: 1, 256: 1, WIDE_CORE: 1}
ATTN_LONG_PARTS = {32: 1, 64: 1, 128: 1, 256: 2}
ATTN_LONG_WARPS = {d: 8 * s for d, s in ATTN_LONG_SAMPLES.items()}
ATTN_LONG_SMEM = CTA_SHARED_MAX
ATTN_LONG_SLAB_CTAS = 2048
ATTN_LONG_REGISTERS = {32: 128, 64: 128, 128: 223, 256: 254, WIDE_CORE: 168}
WIDE_SLOTS = 6
WIDE_CTAS = 132  # the wide form's persistent grid: an H100 SXM's SMs
WIDE_P_BLOCK = ATTN_LONG_QUERIES * ATTN_LONG_KEYS * 2  # bf16 P of a block
WIDE_Q8_SLOT = 9216  # K4a's ring slot: 8 KB of codes and k's scales, on 1 KB
# K4a's long route (csrc/fused_block_q8.cu): a pre-pass, one CTA of
# ATTN_Q8_PREPASS_THREADS a (sample, head), quantizes k and v once into
# scratch (``attention_q8_long_scratch``); then attention_q8_long_kernel
# runs the bf16 route's CTA (128 queries, two warpgroups a sample, all of a
# CTA's shared memory) on s8 wgmma, two samples a CTA (one at widths 128
# and 256; pass 2 in its parts at 256), with a ring of three stages of
# 64-key blocks of k and vᵀ codes (a part's rows) and k's scales. Registers
# a thread: ptxas's most over the variants of each width (nvcc 12.9,
# sm_90a; 12 bytes spill at width 64 with dynamic scales and bias rows or
# a slab; none at 256, 238-254 over its variants). Above 256 the wide form
# (attention_q8_prepass_wide_kernel, attention_q8_wide_kernel): the
# pre-pass also writes q's codes and row scales, the scratch at the wide
# width 128·ceil(d/128); the core takes k's codes in 128-lane chunks
# in the bf16 wide form's schedule and CTA (its registers too; the dynamic
# pre-pass 48 registers, 4 bytes spilled): a ring of WIDE_SLOTS slots of
# WIDE_Q8_SLOT bytes, pq's codes once a key block into slots of 128 x Np
# bytes after the pre-pass's operands.
ATTN_Q8_PREPASS_THREADS = 256
ATTN_Q8_LONG_STAGES = 3
ATTN_Q8_LONG_REGISTERS = {32: 128, 64: 128, 128: 226, 256: 254,
                          WIDE_CORE: 168}


def _route(n: int, route: str | None, head_dim: int) -> str:
    """The attention route of ``n`` tokens at head width ``head_dim``:
    the short core up to ``MAX_TOKENS``, the long route above, and at
    every N for a head wider than the short cores' widest instance;
    ``route`` forces one (the short route only where a short core has the
    width)."""
    short_ok = core_width(head_dim) in SHORT_CORE_WIDTHS
    if route is None:
        return "short" if n <= MAX_TOKENS and short_ok else "long"
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "short" and not short_ok:
        raise ValueError(f"the short attention cores take heads up to "
                         f"{SHORT_CORE_WIDTHS[-1]} wide, got {head_dim}: "
                         "wider heads take the long route")
    return route


def _long_bias_form(n: int, region: int) -> str:
    """The bias form of a long-route launch whose bias region holds
    ``region`` bytes (the C side's ``long_bias_mode``): "slab" where a
    CTA's 128 rows of n floats and their shift fit it, else "tiles" where
    n % 4 == 0, else "rows"."""
    if ATTN_LONG_QUERIES * n * 4 + 16 <= region:
        return "slab"
    return "tiles" if n % 4 == 0 else "rows"


def _long_bias_region(head_dim: int, probs: bool) -> int:
    """Bytes of the bf16 long route's bias region (the C side's
    ``attn_long_region_bytes`` at the core width, ``wide_region_bytes`` on
    the wide form): the CTA's shared bytes less 1 KB of alignment, the K/V
    ring (three stages, two with probabilities or at width 256, each a
    64-key block of K and of V's part of each sample; on the wide form
    WIDE_SLOTS slots of 16 KB, each K's 128-lane chunk or V's part), the
    probabilities' staging (16 x 72 bf16 a warp) and the barriers (two a
    stage or slot and the slab's)."""
    w = core_width(head_dim)
    staging = ATTN_LONG_WARPS[w] * 16 * (ATTN_LONG_KEYS + 8) * 2 \
        if probs else 0
    if w == WIDE_CORE:  # slots of K's 128-lane chunk or V's part
        stages = WIDE_SLOTS
        ring = stages * ATTN_LONG_KEYS * WIDE_LANES * 2
    else:
        stages = 2 if probs or w > SHORT_CORE_WIDTHS[-1] else 3
        samples = ATTN_LONG_SAMPLES[w]
        block = ATTN_LONG_KEYS * w * 2
        ring = stages * samples * (block + block // ATTN_LONG_PARTS[w])
    bars = -(-(2 * stages + 1) * 8 // 16) * 16
    return ATTN_LONG_SMEM - 1024 - ring - staging - bars


def _q8_long_region(head_dim: int) -> int:
    """Bytes of K4a's long-route bias region (the C side's
    ``q8_long_region_bytes``, ``q8_wide_region_bytes`` on the wide form):
    the CTA's shared bytes less 1 KB of alignment, the ring (three stages,
    each a 64-key block of k codes and of vᵀ codes (a part's rows) of each
    sample and k's 64 row scales of each, rounded up to 1 KB; on the wide
    form WIDE_SLOTS slots of WIDE_Q8_SLOT bytes, each k's 128-lane chunk
    with its scales or vᵀ's 128-row part) and the barriers (two a stage or
    slot and the slab's), at the core width."""
    w = core_width(head_dim)
    if w == WIDE_CORE:
        stages, stage = WIDE_SLOTS, WIDE_Q8_SLOT
    else:
        samples = ATTN_LONG_SAMPLES[w]
        tile = ATTN_LONG_KEYS * w
        part = tile // ATTN_LONG_PARTS[w]
        stages = ATTN_Q8_LONG_STAGES
        stage = -(-(samples * (tile + part)
                    + samples * ATTN_LONG_KEYS * 4) // 1024) * 1024
    bars = -(-(2 * stages + 1) * 8 // 16) * 16
    return ATTN_LONG_SMEM - 1024 - stages * stage - bars


def attention_long_bias(n: int, head_dim: int, probs: bool = False,
                        int8: bool = False) -> str:
    """The bias form of the long route at ``n`` tokens (``_long_bias_form``
    of its bias region): the bf16 core's, with ``probs`` that of the
    saved-probabilities kernels (K5, K6), with ``int8`` K4a's."""
    region = _q8_long_region(head_dim) if int8 else \
        _long_bias_region(head_dim, probs)
    return _long_bias_form(n, region)


def wide_sample_groups(b: int, n: int, heads: int) -> int:
    """The wide form's grid in y (the C side's ``wide_sample_groups``):
    enough sample rows that its persistent grid holds about ``WIDE_CTAS``
    CTAs, at most ``b``; the CTA of y takes samples y, y + grid y, ..."""
    per = -(-n // ATTN_LONG_QUERIES) * heads
    return min(b, -(-WIDE_CTAS // per))


def wide_slots(b: int, n: int, heads: int, block_bytes: int) -> int:
    """Bytes of the wide form's slots: one for each CTA of its grid,
    ``block_bytes`` for each 64-key block (``WIDE_P_BLOCK`` for the bf16
    core's P, 128 x 64 bf16; 8,192 for K4a's codes)."""
    ctas = -(-n // ATTN_LONG_QUERIES) * wide_sample_groups(b, n, heads) \
        * heads
    return ctas * -(-n // ATTN_LONG_KEYS) * block_bytes


def wide_scratch(b: int, n: int, heads: int, head_dim: int) -> int:
    """Bytes of the bf16 attention core's scratch at head width
    ``head_dim``: the wide form's P slots, and 0 on every other instance
    (which reads none)."""
    if core_width(head_dim) != WIDE_CORE:
        return 0
    return wide_slots(b, n, heads, WIDE_P_BLOCK)


def attention_long_groups(b: int, n: int, heads: int, head_dim: int,
                          probs: bool = False, int8: bool = False) -> int:
    """The long route's grid in y (the C side's ``long_sample_groups``):
    one CTA for each group of ``ATTN_LONG_SAMPLES`` samples, but in the
    slab form ceil(groups · (CTAs a group) / ``ATTN_LONG_SLAB_CTAS``)
    groups a CTA, the CTA of y taking groups y, y + grid y, ...; on the
    wide form ``wide_sample_groups``."""
    if core_width(head_dim) == WIDE_CORE:
        return wide_sample_groups(b, n, heads)
    groups = -(-b // ATTN_LONG_SAMPLES[core_width(head_dim)])
    if attention_long_bias(n, head_dim, probs, int8) != "slab":
        return groups
    per = -(-groups * -(-n // ATTN_LONG_QUERIES) * heads
            // ATTN_LONG_SLAB_CTAS)
    return -(-groups // per)


def q8_long_keys(n: int) -> int:
    """Keys of a (sample, head) in K4a's long-route scratch: n rounded up
    to whole 64-key blocks."""
    return -(-n // ATTN_LONG_KEYS) * ATTN_LONG_KEYS


def q8_scratch_width(d: int) -> int:
    """The lanes of a row of K4a's long-route scratch at head width ``d``:
    the core width up to 256, 128·ceil(d / 128) on the wide form."""
    w = core_width(d)
    return wide_chunks(d) * WIDE_LANES if w == WIDE_CORE else w


def attention_q8_long_scratch(b: int, n: int, c: int, heads: int) -> int:
    """Bytes of K4a's long-route scratch (the C side's ``q8_long_scratch``,
    ``q8_wide_scratch`` above 256) for b samples of n tokens and C = heads
    x d, at the width w = ``q8_scratch_width(d)``: k codes (b, heads, Np,
    w) and v codes transposed (b, heads, w, Np), int8; k's row scales (b,
    heads, Np) and v's column scales (b, heads, w), float32; Np =
    ``q8_long_keys(n)``; on the wide form also q's codes (b, heads, Np, w)
    and row scales (b, heads, Np), then the core's slots of pq's codes
    (``wide_slots``, 128 x Np bytes a CTA). The lanes past d hold code 0
    (and v's scale 1)."""
    d = c // heads
    np_, w = q8_long_keys(n), q8_scratch_width(d)
    if core_width(d) == WIDE_CORE:
        return b * heads * (3 * np_ * w + 8 * np_ + 4 * w) \
            + wide_slots(b, n, heads, ATTN_LONG_QUERIES * ATTN_LONG_KEYS)
    return b * heads * (2 * np_ * w + 4 * np_ + 4 * w)


def _long_plan(b: int, n: int, heads: int, head_dim: int, warps: int,
               samples: int, smem: int, registers: int, grid: tuple,
               what: str) -> dict:
    if not 1 <= n <= MAX_LONG_TOKENS:
        raise ValueError(f"{what} takes 1..{MAX_LONG_TOKENS} tokens, got "
                         f"{n}; longer sequences are open work (ROADMAP.md)")
    if not 1 <= heads <= MAX_GRID_Y or not 1 <= b <= MAX_GRID_Y:
        raise ValueError(f"attention grid {grid} out of range")
    return dict(ints=(ATTN_LONG_ROUTE, warps, samples, smem), route="long",
                warps=warps, samples=samples, smem=smem, grid=grid,
                head_dim=head_dim, core_width=core_width(head_dim),
                key_blocks=-(-n // ATTN_LONG_KEYS),
                parts=attention_long_parts(head_dim),
                ctas_per_sm=ctas_per_sm(warps * 32, smem, registers))


def attention_plan(b: int, n: int, heads: int, warps: int = ATTN_WARPS,
                   samples: int | None = None, head_dim: int = 64,
                   route: str | None = None, probs: bool = False) -> dict:
    """The attention core's launch for ``b`` samples of ``n`` tokens and
    ``heads`` heads of width ``head_dim`` (on the core instance of width
    ``core_width(head_dim)``, the plan's ``core_width``): ``ints``
    (key-tile bucket, warps, samples, shared bytes) as the C entry points
    take them, the ``route`` it takes, the grid (heads, samples per CTA)
    and the CTAs that fit an SM. ``samples`` None: 4 from a batch of
    ``ATTN_SAMPLES_FROM_BATCH`` on, else 1. Above ``MAX_TOKENS`` (or with
    ``route="long"``) the long route: ints (``ATTN_LONG_ROUTE``,
    ``ATTN_LONG_WARPS``, ``ATTN_LONG_SAMPLES``, ``ATTN_LONG_SMEM``) of the
    core width, grid (128-query blocks, sample groups, heads) and ``bias``
    form (both of the saved-probabilities variant with ``probs``);
    ``warps`` and ``samples`` do not apply. A head wider than 128 takes
    the long route at every N; a head wider than 256 its wide form
    (``core_width`` ``WIDE_CORE``), whose P·V runs in ``parts`` =
    ceil(d / 128) parts and whose ``scratch`` bytes (``wide_scratch``; 0
    on the other long instances) the C entry points take. Raises
    ``ValueError`` for a launch the kernels do not take."""
    _refuse_head_dim(head_dim, "the attention core")
    w = core_width(head_dim)
    if _route(n, route, head_dim) == "long":
        plan = _long_plan(
            b, n, heads, head_dim, ATTN_LONG_WARPS[w],
            ATTN_LONG_SAMPLES[w], ATTN_LONG_SMEM,
            ATTN_LONG_REGISTERS[w],
            (-(-n // ATTN_LONG_QUERIES),
             attention_long_groups(b, n, heads, head_dim, probs), heads),
            "the long attention route")
        plan.update(bias=attention_long_bias(n, head_dim, probs),
                    scratch=wide_scratch(b, n, heads, head_dim))
        return plan
    if samples is None:
        samples = 4 if b >= ATTN_SAMPLES_FROM_BATCH else 1
    if not 1 <= n <= MAX_TOKENS:
        raise ValueError(f"the attention core takes 1..{MAX_TOKENS} tokens, "
                         f"got {n}")
    max_warps = ATTN_MAX_WARPS[w]
    if not 1 <= warps <= max_warps or samples < 1:
        raise ValueError(f"the attention core takes 1..{max_warps} warps "
                         f"at width {head_dim} and >= 1 samples a CTA, got "
                         f"{warps}, {samples}")
    key_tiles = -(-n // 16)
    bucket = next(t for t in ATTN_KEY_TILE_BUCKETS if t >= key_tiles)
    smem = 2 * key_tiles * 16 * attn_row_bytes(head_dim)
    grid = (heads, -(-b // samples))
    if not 1 <= grid[1] <= MAX_GRID_Y or not 1 <= heads:
        raise ValueError(f"attention grid {grid} out of range")
    return dict(ints=(bucket, warps, samples, smem), route="short",
                key_tiles=key_tiles, bucket=bucket, warps=warps,
                samples=samples, smem=smem, grid=grid, head_dim=head_dim,
                core_width=w,
                ctas_per_sm=ctas_per_sm(warps * 32, smem,
                                        ATTN_REGISTERS[w]))


def gemm_plan(m: int, n: int, k: int) -> dict:
    """K2's GEMM launch for out (m, n) = A (m, k) · W (n, k)ᵀ: ``ints``
    (tile rows, tile columns, K slab, stages, threads, shared bytes) as
    the C entry points take them, the grid (column tiles, row tiles), the
    K slabs a tile takes (``k_slabs``, ceil(k / 64): a K tail past the last
    whole slab reads as zeros) and the CTAs that fit an SM. TMA reads both
    operands in 64-wide K slabs with row strides of 2k bytes, which must be
    multiples of 16: raises ``ValueError`` unless k % 8 == 0 and n % 8 == 0
    (the epilogue's column pairs and the bias's 16-byte rows)."""
    if m < 1 or k < GEMM_K_ALIGN or k % GEMM_K_ALIGN or n < 8 or n % 8:
        raise ValueError(f"the GEMM needs K % {GEMM_K_ALIGN} == 0 and "
                         f"N % 8 == 0, got M={m}, N={n}, K={k}")
    grid = (-(-n // GEMM_BN), -(-m // GEMM_BM))
    if grid[1] > MAX_GRID_Y:
        raise ValueError(f"GEMM grid {grid} out of range (M={m})")
    return dict(ints=(GEMM_BM, GEMM_BN, GEMM_BK, GEMM_STAGES, GEMM_THREADS,
                      GEMM_SMEM),
                grid=grid, smem=GEMM_SMEM, k_slabs=-(-k // GEMM_BK),
                ctas_per_sm=ctas_per_sm(GEMM_THREADS, GEMM_SMEM,
                                        GEMM_REGISTERS))


def block_plan(b: int, n: int, c: int, heads: int, hidden: int,
               a: int | None = None) -> tuple:
    """A block's plan as its C entry points take it: the attention core's
    ints (the route ``n`` takes), then the GEMM's, checked against every
    GEMM of the block (qkv, proj, up, down at M = b·n). ``a`` is the
    attention's width where a padded layout sets it apart from ``c``
    (``PaddedWidths.a``)."""
    m, a = b * n, a or c
    for rows, depth in ((3 * a, c), (c, a), (hidden, c), (c, hidden)):
        gemm = gemm_plan(m, rows, depth)
    return attention_plan(b, n, heads, head_dim=check_head_dim(a, heads)
                          )["ints"] + gemm["ints"]


# K4's s8 GEMM (csrc/fused_block_q8.cu on csrc/wgmma_gemm.cuh): K2's plan
# with 128-value K slabs (Q8_K_SLAB: 128 bytes, as K2's 64 bf16).
GEMM_Q8_EPILOGUES = ("bias_cast", "bias_residual", "bias_gelu",
                     "bias_gelu_codes", "acc")


def gemm_q8_plan(m: int, n: int, k: int) -> dict:
    """K4's s8 GEMM launch for out (m, n) = dq(A (m, k) · W (n, k)ᵀ):
    ``ints`` (tile rows, tile columns, K slab, stages, threads, shared
    bytes) as the C entry points take them, the tiles, the K slabs a tile
    takes (``k_slabs``, ceil(k / 128): a K tail reads as zeros) and the
    CTAs that fit an SM. TMA reads both operands in 128-byte K slabs with
    row strides of k bytes: raises ``ValueError`` unless k % 16 == 0 and
    n % 8 == 0."""
    if m < 1 or k < Q8_K_ALIGN or k % Q8_K_ALIGN or n < 8 or n % 8:
        raise ValueError(f"the s8 GEMM needs K % {Q8_K_ALIGN} == 0 and "
                         f"N % 8 == 0, got M={m}, N={n}, K={k}")
    return dict(ints=(GEMM_BM, GEMM_BN, Q8_K_SLAB, GEMM_STAGES,
                      GEMM_THREADS, GEMM_SMEM),
                tiles=-(-n // GEMM_BN) * -(-m // GEMM_BM),
                k_slabs=-(-k // Q8_K_SLAB), smem=GEMM_SMEM,
                ctas_per_sm=ctas_per_sm(GEMM_THREADS, GEMM_SMEM,
                                        GEMM_REGISTERS))


# K4a's int8 core (csrc/fused_block_q8.cu), a template of the core width
# kD = core_width(d): a CTA of `warps` warps (even, at most 8) per head and
# `samples` samples, k codes in rows of kD + 16 bytes and v codes
# transposed in shared memory, register arrays sized by a bucket of the
# 32-key step count; at
# widths 32 and 64, 168 registers a thread at most (the bf16 core's launch
# bound of 12 warps) and 85 up to two steps (a launch bound of two such
# CTAs an SM); at width 128, 255 (a launch bound of 8 warps) and 128.
ATTN_Q8_STEP_BUCKETS = (1, 2, 4, 6, 7, 8)
ATTN_Q8_MAX_WARPS = 8
ATTN_Q8_SHORT_REGISTERS = {32: 85, 64: 85, 128: 128}


def attention_q8_smem(n: int, head_dim: int = 64) -> int:
    """Shared bytes of one K4a CTA for ``n`` tokens (keys padded to 32)
    at head width ``head_dim``, on its core width d = ``core_width``: k
    codes (np x (d + 16) B), v codes transposed (d x (np + 16) B), k's row
    scales, v's column scales and a d-lane partial abs-max for each d/8
    threads of the largest CTA."""
    np_ = -(-n // 32) * 32
    d = core_width(head_dim)
    return np_ * (d + 16) + d * (np_ + 16) + np_ * 4 + d * 4 \
        + (ATTN_Q8_MAX_WARPS * 32 // (d // 8)) * d * 4


def attention_q8_plan(b: int, n: int, heads: int, warps: int | None = None,
                      samples: int | None = None,
                      head_dim: int = 64, route: str | None = None) -> dict:
    """K4a's core launch for ``b`` samples of ``n`` tokens and ``heads``
    heads of width ``head_dim``: ``ints`` (32-key step bucket, warps,
    samples, shared bytes) as the C entry points take them, the ``route``
    it takes, the grid and the CTAs that fit an SM. ``warps`` None: 2
    where one 16-query tile holds every token (n <= 16), else
    ``ATTN_WARPS``; ``samples`` None: as ``attention_plan``. Above
    ``MAX_TOKENS`` (or with ``route="long"``) its long route: the bf16
    route's ints (``ATTN_LONG_ROUTE``, ``ATTN_LONG_WARPS``,
    ``ATTN_LONG_SAMPLES``, ``ATTN_LONG_SMEM``) of the width, grid
    (128-query blocks, sample groups, heads), ``bias`` form, the
    pre-pass's grid (``prepass_grid``, a CTA a sample and head) and the
    ``scratch`` bytes both share; a head wider than 128 takes it at every
    N (above 256 its wide form). Raises ``ValueError`` for a launch the kernels do not take (even
    warps, at most ``ATTN_Q8_MAX_WARPS``)."""
    _refuse_head_dim(head_dim, "the int8 attention core")
    w = core_width(head_dim)
    if _route(n, route, head_dim) == "long":
        plan = _long_plan(
            b, n, heads, head_dim, ATTN_LONG_WARPS[w],
            ATTN_LONG_SAMPLES[w], ATTN_LONG_SMEM,
            ATTN_Q8_LONG_REGISTERS[w],
            (-(-n // ATTN_LONG_QUERIES),
             attention_long_groups(b, n, heads, head_dim, int8=True), heads),
            "the long int8 attention route")
        plan.update(bias=attention_long_bias(n, head_dim, int8=True),
                    prepass_grid=b * heads,
                    scratch=attention_q8_long_scratch(b, n, heads * head_dim,
                                                      heads))
        return plan
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
    smem = attention_q8_smem(n, head_dim)
    grid = (heads, -(-b // samples))
    if not 1 <= grid[1] <= MAX_GRID_Y or not 1 <= heads:
        raise ValueError(f"attention grid {grid} out of range")
    registers = (ATTN_Q8_SHORT_REGISTERS if bucket <= 2
                 else ATTN_REGISTERS)[w]
    return dict(ints=(bucket, warps, samples, smem), route="short",
                steps=steps, bucket=bucket, warps=warps, samples=samples,
                smem=smem, grid=grid, head_dim=head_dim, core_width=w,
                ctas_per_sm=ctas_per_sm(warps * 32, smem, registers))


def block_plan_q8(b: int, n: int, c: int, heads: int, hidden: int,
                  quant_attn: bool = False, a: int | None = None) -> tuple:
    """A w8a8 block's plan as its C entry points take it: the attention
    core's ints (K2's core, or K4a's with ``quant_attn``; the route ``n``
    takes), then each GEMM's (qkv, proj, up, down at M = b·n); ``a`` as
    ``block_plan``'s."""
    m, a = b * n, a or c
    attn = (attention_q8_plan if quant_attn else attention_plan)(
        b, n, heads, head_dim=check_head_dim(a, heads))
    gemms = (gemm_q8_plan(m, rows, depth)["ints"]
             for rows, depth in ((3 * a, c), (c, a), (hidden, c),
                                 (c, hidden)))
    return attn["ints"] + tuple(i for g in gemms for i in g)


def _plan_arg(ints):
    return (ctypes.c_int * len(ints))(*ints)


class CoreLaunches:
    """The launch count of a kernel that the wrappers launch from C (an
    attention core inside a block, a chain or an attention entry point; a
    LayerNorm inside a block): each wrapper adds the kernel's launches of
    its call. Read and reset as a wrapper's ``launches``."""

    def __init__(self):
        self.launches = 0


# the bf16 core (K2, K3, K4 without quant_attn, K5, K6, K7, K8;
# csrc/block_common.cuh attention_kernel, attention_long_kernel) and the
# int8 core (K4a; csrc/fused_block_q8.cu attention_q8_kernel,
# attention_q8_long_kernel), each by route
attention_short = CoreLaunches()
attention_long = CoreLaunches()
attention_q8_short = CoreLaunches()
attention_q8_long = CoreLaunches()
# the int8 long route's pre-pass (csrc/fused_block_q8.cu
# attention_q8_prepass_kernel), one launch with each of its cores, counts
# in its own wrapper's ``attention_q8_prepass.launches``


# the wide LayerNorm kernels (C > MAX_WIDTH): csrc/fused_block.cu's (K2,
# K3, K5) and csrc/fused_block_q8.cu's with the quantize (K4, K4a)
layer_norm_wide = CoreLaunches()
ln_quant_wide = CoreLaunches()


def count_core(plan_ints, int8: bool = False, blocks: int = 1) -> None:
    """Counts ``blocks`` launches of the attention core a plan (its ints,
    an attention plan's first) selects."""
    long = plan_ints[0] == ATTN_LONG_ROUTE
    if int8:
        (attention_q8_long if long else attention_q8_short).launches += blocks
        if long:
            attention_q8_prepass.launches += blocks
    else:
        (attention_long if long else attention_short).launches += blocks


def count_layer_norms(c: int, w8a8: bool, blocks: int = 1) -> None:
    """Counts the wide LayerNorm launches of ``blocks`` blocks of width
    ``c`` (two a block, none up to ``MAX_WIDTH``)."""
    if c > MAX_WIDTH:
        (ln_quant_wide if w8a8 else layer_norm_wide).launches += 2 * blocks


# ------------------------------------------------------- padded layouts
#
# The kernels read rows whose strides are multiples of 16 bytes (TMA): bf16
# widths that divide by 8, int8 GEMM rows by 16. A block of any other width
# runs on a zero-padded layout: the residual stream x at C' = round_up(C, 8)
# (16 for w8a8), the MLP at hidden' likewise, and the attention at A = H·d',
# d' = round_up(d, 8), each head's q, k and v rows at h·d' in qkv and the
# projection's input at H·d' (w8a8 also needs A % 16 == 0: an odd head count
# then takes d' = round_up(d, 16)). Every padded weight row and column,
# bias, LayerNorm scale and bias is 0 (a quantized weight's padded channel
# code 0 and scale 1, as ``_scale_from_amax`` gives a zero channel), so
# once x's padded lanes are 0 every padded lane of every intermediate (the
# residual, the LayerNorm outputs, qkv, the attention output, the GELU
# output and their int8 codes) is exactly 0, and no abs-max sees one. Two
# numbers would change: the kernels take the true C for the LayerNorms'
# statistics and the true d for q's scale d^-½. A wrapper pads once a call
# (a chain keeps the padded stream across its blocks) and unpads its
# output; nothing is cached.


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class PaddedWidths(NamedTuple):
    """A block's true widths and the zero-padded layout the kernels run
    it on (``padded_widths``): ``c``, ``heads`` and ``hidden`` true,
    ``c_pad``, ``d_pad`` and ``hidden_pad`` the layout's."""

    c: int
    heads: int
    hidden: int
    c_pad: int
    d_pad: int
    hidden_pad: int

    @property
    def d(self) -> int:
        return self.c // self.heads

    @property
    def a(self) -> int:
        """The attention's width on the layout, H·d'."""
        return self.heads * self.d_pad

    @property
    def aligned(self) -> bool:
        """Whether the layout is the true one (nothing to pad)."""
        return (self.c_pad, self.d_pad, self.hidden_pad) == (
            self.c, self.d, self.hidden)

    @property
    def launch_widths(self) -> tuple:
        """(A, c_norm, d_scale) as the blocks' C entry points take them."""
        return self.a, self.c, self.d

    def pad_x(self, x: torch.Tensor) -> torch.Tensor:
        """(..., C) → (..., C'), zeros past C."""
        return x if self.c_pad == self.c else F.pad(x, (0, self.c_pad - self.c))

    def unpad_x(self, y: torch.Tensor) -> torch.Tensor:
        """(..., C') → (..., C)."""
        return y if self.c_pad == self.c else y[..., :self.c].contiguous()

    def pad_heads(self, t: torch.Tensor, parts: int = 1,
                  value: float = 0.0) -> torch.Tensor:
        """(..., parts·H·d) → (..., parts·A): each head's d lanes at h·d'
        of its part (q, k, v of a qkv), ``value`` past them."""
        if self.d_pad == self.d:
            return t
        lead = t.shape[:-1]
        u = F.pad(t.reshape(*lead, parts, self.heads, self.d),
                  (0, self.d_pad - self.d), value=value)
        return u.reshape(*lead, parts * self.a)

    def unpad_heads(self, t: torch.Tensor, parts: int = 1) -> torch.Tensor:
        """(..., parts·A) → (..., parts·H·d), the inverse of
        ``pad_heads``."""
        if self.d_pad == self.d:
            return t
        lead = t.shape[:-1]
        u = t.reshape(*lead, parts, self.heads, self.d_pad)[..., :self.d]
        return u.reshape(*lead, parts * self.c)

    def pad_hidden(self, t: torch.Tensor, value: float = 0.0) -> torch.Tensor:
        """(..., hidden) → (..., hidden'), ``value`` past hidden."""
        n = self.hidden_pad - self.hidden
        return F.pad(t, (0, n), value=value) if n else t

    def unpad_hidden(self, t: torch.Tensor) -> torch.Tensor:
        """(..., hidden') → (..., hidden)."""
        n = self.hidden_pad - self.hidden
        return t[..., :self.hidden].contiguous() if n else t

    def _weights(self, wq, wp, wu, wd) -> tuple:
        """The four weights (nn.Linear's (out, in)) on the layout: qkv (3A,
        C'), proj (C', A), up (hidden', C'), down (C', hidden')."""
        h, d, c = self.heads, self.d, self.c
        dc, dd = self.c_pad - c, self.d_pad - d
        dh = self.hidden_pad - self.hidden
        wq = F.pad(wq.reshape(3, h, d, c), (0, dc, 0, dd)).reshape(
            3 * self.a, self.c_pad)
        wp = F.pad(F.pad(wp.reshape(c, h, d), (0, dd)).reshape(c, self.a),
                   (0, 0, 0, dc))
        return wq, wp, F.pad(wu, (0, dc, 0, dh)), F.pad(wd, (0, dh, 0, dc))

    def pad_params(self, params) -> tuple:
        """A block's 13-tuple on the layout (zeros past every true
        width)."""
        if self.aligned:
            return tuple(params)
        (l1s, l1b, wq, bq, bias, wp, bp, l2s, l2b, wu, bu, wd, bd) = params
        wq, wp, wu, wd = self._weights(wq, wp, wu, wd)
        x = self.pad_x
        return (x(l1s), x(l1b), wq, self.pad_heads(bq, 3), bias, wp, x(bp),
                x(l2s), x(l2b), wu, self.pad_hidden(bu), wd, x(bd))

    def pad_qparams(self, qparams) -> tuple:
        """A w8a8 block's 17- or 18-tuple on the layout: the quantized
        weights padded with code 0 and their scales with 1 (a zero
        channel's, so equal to quantizing the padded weight), the rest
        with zeros; the static scales as they are."""
        if self.aligned:
            return tuple(qparams)
        (l1s, l1b, wq, sq, bq, bias, wp, sp, bp, l2s, l2b,
         wu, su, bu, wd, sd, bd) = qparams[:17]
        wq, wp, wu, wd = self._weights(wq, wp, wu, wd)
        x = self.pad_x
        one = lambda t: F.pad(t, (0, self.c_pad - self.c), value=1.0)
        return (x(l1s), x(l1b), wq, self.pad_heads(sq, 3, 1.0),
                self.pad_heads(bq, 3), bias, wp, one(sp), x(bp), x(l2s),
                x(l2b), wu, self.pad_hidden(su, 1.0), self.pad_hidden(bu),
                wd, one(sd), x(bd)) + tuple(qparams[17:])


def padded_widths(c: int, heads: int, hidden: int = 0,
                  int8: bool = False) -> PaddedWidths:
    """The zero-padded layout of a block of width ``c``, ``heads`` heads
    and MLP width ``hidden`` (0 for an attention alone): C' and hidden'
    rounded up to ``GEMM_K_ALIGN`` (``Q8_K_ALIGN`` with ``int8``, the w8a8
    GEMMs), d' to ``HEAD_DIM_STEP`` (with ``int8`` to 16 where H·d' would
    not divide by 16). Raises ``ValueError`` for a head width the kernels
    do not take (``check_head_dim``)."""
    d = check_head_dim(c, heads)
    align = Q8_K_ALIGN if int8 else GEMM_K_ALIGN
    d_pad = _round_up(d, HEAD_DIM_STEP)
    if heads * d_pad % align:
        d_pad = _round_up(d, align)
    return PaddedWidths(c, heads, hidden, _round_up(c, align), d_pad,
                        _round_up(hidden, align))


# ------------------------------------------------------------ plain version

def _ln(x, scale, bias, eps=LN_EPS, width=None):
    """Two-pass float32 LayerNorm; with ``width`` (a zero-padded row's true
    C) the statistics over its first ``width`` lanes, the lanes past it
    (scale and bias 0) coming out 0."""
    m = x.to(torch.float32)
    t = m if width is None else m[..., :width]
    mu = t.mean(-1, keepdim=True)
    v = ((t - mu) ** 2).mean(-1, keepdim=True)
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


def q_scale(d: int, dt: torch.dtype) -> float:
    """d^-½ as the JAX package multiplies an activation of dtype ``dt`` by
    it: a weakly typed Python float takes the array's dtype there, so a
    bf16 q is scaled by d^-½ rounded to bf16 (0.125 exactly at d 64,
    0.1767578125 at 32, 0.08837890625 at 128; the attention kernels use the
    same factor)."""
    return torch.tensor(d ** -0.5, dtype=dt).item()


def attention_parts(qkv: torch.Tensor, bias: torch.Tensor, heads: int,
                    lanes: int | None = None, keys: int | None = None,
                    recompute: bool = False, head_dim: int | None = None):
    """The TPU kernels' attention (``_attn_inner``, and the saved-probs
    kernel's forward) on a (B, N, 3C) qkv in the activation dtype: per head
    softmax(q·d^-½·kᵀ + bias) · v in f32, q scaled in the activation dtype,
    the numerators rounded to it for the value product and 1/Σe applied
    after that. Returns the output (B, N, C) in qkv's dtype, and the f32
    numerators e (B, H, N, N) and reciprocals 1/Σe (B, H, N, 1).

    ``lanes`` (e.g. ``WIDE_LANES``) runs the long route's wide schedule:
    q·kᵀ summed in f32 over chunks of ``lanes`` of the head's lanes in
    chunk order, and the value product one part of ``lanes`` output lanes
    at a time (each part's columns are the unsplit product's); the same
    function, with the logits' f32 sums in another order.

    ``keys`` (e.g. ``ATTN_LONG_KEYS``, with ``lanes``) takes the keys in
    blocks of ``keys`` as the wide form's two passes do: the row max over
    the blocks' logits, then the logits, e against that max and P = e in
    the activation dtype made once for each block, and each part's value
    product summed over the blocks in order (f32). With ``recompute`` the
    blocks' logits, e and P are made again for each part instead (a second
    pass that computes q·kᵀ once for each part); the two give the same
    bits.

    ``head_dim`` is a zero-padded layout's true head width (its lanes past
    it zero in q, k and v), whose d^-½ scales q; by default the width of
    qkv's heads."""
    dt = qkv.dtype
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    q = (qkv[..., :c].reshape(b, n, heads, d)
         * q_scale(head_dim or d, dt)).to(torch.float32)
    k = qkv[..., c : 2 * c].reshape(b, n, heads, d).to(torch.float32)
    v = qkv[..., 2 * c :].reshape(b, n, heads, d).to(torch.float32)
    cuts = [slice(0, d)] if lanes is None else \
        [slice(i, min(i + lanes, d)) for i in range(0, d, lanes)]
    f32_bias = bias.to(torch.float32)

    def logits_of(s):  # the logits of keys s, summed over the chunks
        acc = 0
        for cut in cuts:
            acc = acc + torch.einsum("bnhd,bmhd->bhnm", q[..., cut],
                                     k[:, s][..., cut])
        return acc + f32_bias[None, :, :, s]

    if keys is not None:
        blocks = [slice(j, min(j + keys, n)) for j in range(0, n, keys)]
        m = torch.stack([logits_of(s).amax(-1) for s in blocks]).amax(0)
        m = m[..., None]
        e = torch.cat([torch.exp(logits_of(s) - m) for s in blocks], -1)
        recip = 1.0 / e.sum(-1, keepdim=True)
        p = [e[..., s].to(dt).to(torch.float32) for s in blocks]
        av = []
        for cut in cuts:
            part = 0
            for i, s in enumerate(blocks):
                pb = p[i] if not recompute else \
                    torch.exp(logits_of(s) - m).to(dt).to(torch.float32)
                part = part + torch.einsum("bhnm,bmhd->bhnd", pb,
                                           v[:, s][..., cut])
            av.append(part)
        av = torch.cat(av, -1)
    else:
        logits = logits_of(slice(0, n))
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        recip = 1.0 / e.sum(-1, keepdim=True)
        p = e.to(dt).to(torch.float32)
        av = torch.cat([torch.einsum("bhnm,bmhd->bhnd", p, v[..., cut])
                        for cut in cuts], -1)
    out = (av * recip).permute(0, 2, 1, 3).reshape(b, n, c).to(dt)
    return out, e, recip


def _attention(qkv: torch.Tensor, bias: torch.Tensor, heads: int,
               head_dim: int | None = None) -> torch.Tensor:
    return attention_parts(qkv, bias, heads, head_dim=head_dim)[0]


def block_ref(x: torch.Tensor, params, heads: int,
              exact_gelu: bool = False, width: int | None = None,
              head_dim: int | None = None) -> torch.Tensor:
    """Plain version of one block, with the TPU kernel's rounding points:
    f32 LayerNorm and accumulation, casts to x's dtype after each GEMM,
    softmax in f32 with the 1/Σe applied after e·v. ``width`` and
    ``head_dim``: the true C and d of a block on a zero-padded layout
    (``block_twin``), for the LayerNorms' statistics and q's scale."""
    (l1s, l1b, wq, bq, bias, wp, bp, l2s, l2b, wu, bu, wd, bd) = params
    dt = x.dtype
    y = _ln(x, l1s, l1b, width=width).to(dt)
    qkv = _mm(y, wq).to(dt) + bq
    a = _attention(qkv, bias, heads, head_dim)
    r = x + (_mm(a, wp).to(dt) + bp)
    y2 = _ln(r, l2s, l2b, width=width).to(dt)
    h1 = gelu(_mm(y2, wu) + bu.to(torch.float32), exact_gelu)
    return r + (_mm(h1.to(dt), wd).to(dt) + bd)


def chain_ref(x: torch.Tensor, params_list, heads: int,
              exact_gelu: bool = False, width: int | None = None,
              head_dim: int | None = None) -> torch.Tensor:
    """Plain version of a stage: blocks back to back, cast to x's dtype
    between them."""
    for p in params_list:
        x = block_ref(x, p, heads, exact_gelu, width, head_dim).to(x.dtype)
    return x


# ------------------------------- saved-activation training block: plain

def _attention_norm_first(qkv: torch.Tensor, bias: torch.Tensor,
                          heads: int, head_dim: int | None = None):
    """The training block's attention (``_block_math_train``): as
    ``attention_parts``, but the probabilities p = e·(1/Σe) are rounded to
    the activation dtype before the value product, whose float32 sum is the
    output. Returns the output (B, N, C) and p (B, H, N, N), both in qkv's
    dtype."""
    dt, f32 = qkv.dtype, torch.float32
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    q = qkv[..., :c].reshape(b, n, heads, d) * q_scale(head_dim or d, dt)
    k = qkv[..., c : 2 * c].reshape(b, n, heads, d)
    v = qkv[..., 2 * c :].reshape(b, n, heads, d)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.to(f32), k.to(f32)) \
        + bias.to(f32)[None]
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = (e * (1.0 / e.sum(-1, keepdim=True))).to(dt)
    a = torch.einsum("bhnm,bmhd->bnhd", p.to(f32), v.to(f32))
    return a.reshape(b, n, c).to(dt), p


def block_train_ref(x: torch.Tensor, params, heads: int,
                    exact_gelu: bool = False, width: int | None = None,
                    head_dim: int | None = None):
    """Plain version of K5 (``_block_math_train``): one block's output and
    the residuals its backward reads, ``(out, (qkv, probs, gin, r))``, all
    in x's dtype: qkv (B, N, 3C), the normalized probabilities (B, H, N, N)
    (K6's layout; the JAX package concatenates the heads along each query
    row, (B, N, H·N)), the pre-GELU MLP activation gin = y2·W_up + b_up
    (B, N, hidden), kept in float32 for the GELU and saved rounded, and the
    post-attention residual r (B, N, C). The attention normalizes before
    its value product (``_attention_norm_first``), unlike ``block_ref``.
    ``width`` and ``head_dim`` as ``block_ref``'s."""
    (l1s, l1b, wq, bq, bias, wp, bp, l2s, l2b, wu, bu, wd, bd) = params
    dt = x.dtype
    y = _ln(x, l1s, l1b, width=width).to(dt)
    qkv = _mm(y, wq).to(dt) + bq
    a, probs = _attention_norm_first(qkv, bias, heads, head_dim)
    r = x + (_mm(a, wp).to(dt) + bp)
    y2 = _ln(r, l2s, l2b, width=width).to(dt)
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
    q = qkv[..., :c].reshape(b, n, heads, d) * q_scale(d, dt)
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


def _attention_q8_core(qkv, bias, heads, static=None, head_dim=None):
    b, n, c3 = qkv.shape
    d = c3 // 3 // heads
    scale = (head_dim or d) ** -0.5
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


def _attention_q8(qkv: torch.Tensor, bias: torch.Tensor, heads: int,
                  head_dim: int | None = None) -> torch.Tensor:
    """Plain version of K4a with dynamic scales (``_attn_inner_q8``): (B,
    N, C) in qkv's dtype from a (B, N, 3C) qkv and an (H, N, N) bias. The
    logits are (acc · (s_q·d^-½)) · s_k + bias, the output (Σ pq·vi ·
    (1/Σ pq)) · s_v."""
    return _attention_q8_core(qkv, bias, heads, head_dim=head_dim)


def _attention_q8s(qkv: torch.Tensor, bias: torch.Tensor, heads: int,
                   s_q, s_k, s_v, head_dim: int | None = None) -> torch.Tensor:
    """Plain version of K4a with calibrated static scales
    (``_attn_inner_q8s``): codes rint(t · (1/s)) of the scalars, logits
    acc · (s_q·s_k·d^-½) + bias, output (Σ pq·vi · (1/Σ pq)) · s_v."""
    return _attention_q8_core(qkv, bias, heads, (s_q, s_k, s_v), head_dim)


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
                     static=None, head_dim: int | None = None) -> torch.Tensor:
    """Plain version of K4a's core alone: ``_attention_q8`` on a (B, N, 3C)
    qkv, or with ``static`` (the calibrated (s_q, s_k, s_v), a (3,) float32
    or three scalars) ``_attention_q8s``; ``head_dim`` as
    ``attention_parts``'."""
    if static is None:
        return _attention_q8(qkv, bias, heads, head_dim)
    return _attention_q8s(qkv, bias, heads, *static, head_dim=head_dim)


# K4a's long route as two plain twins: the pre-pass's operands in the
# layouts the core reads, and the core's two passes over 64-key blocks on
# them. v's transposed rows hold the keys of each 32-key half in the slot
# order of the core's pq fragments: key 16h + 8u + 2t + e at slot 16h + 4t
# + 2u + e (the short core's slot map).

def q8_slot(j: int) -> int:
    """The slot of key ``j`` in the pre-pass's transposed v rows (the C
    side's ``q8_slot``)."""
    return (j & ~15) | (((j >> 1) & 3) << 2) | (((j >> 3) & 1) << 1) | (j & 1)


def attention_q8_prepass_ref(qkv: torch.Tensor, heads: int, static=None):
    """Plain version of K4a's long-route pre-pass: ``(kc, ks, vs, vt)`` of
    a (B, N, 3C) qkv, the operands of ``_q8_operands`` laid out as the core
    reads them, keys padded to Np = ``q8_long_keys(N)``: k's codes (B, H,
    Np, D) int8 (0 past N), k's row scales (B, H, Np) float32 (1 past N),
    v's column scales (B, H, D) float32, v's codes transposed (B, H, D, Np)
    int8 in the slot order (``q8_slot``; 0 past N). With ``static`` the
    scales are None. Above d 256 (the wide form, whose pre-pass quantizes
    q too) also ``(qc, qs)``: q's codes (B, H, Np, D) and row scales (B, H,
    Np) in k's layout."""
    b, n, _ = qkv.shape
    np_ = q8_long_keys(n)
    qi, sq, ki, sk, vi, sv = _q8_operands(qkv, heads, static)
    d, dev = ki.shape[-1], qkv.device

    def rows(codes, scale):
        rc = torch.zeros((b, heads, np_, d), dtype=torch.int8, device=dev)
        rc[:, :, :n] = codes.permute(0, 2, 1, 3)
        if static is not None:
            return rc, None
        rs = torch.ones((b, heads, np_), dtype=torch.float32, device=dev)
        rs[:, :, :n] = scale[..., 0].permute(0, 2, 1)
        return rc, rs

    kc, ks = rows(ki, sk)
    vt = torch.zeros((b, heads, d, np_), dtype=torch.int8, device=dev)
    slots = torch.tensor([q8_slot(j) for j in range(n)], device=dev)
    vt[..., slots] = vi.permute(0, 2, 3, 1)
    out = (kc, ks, None if static is not None else sv[:, 0], vt)
    if core_width(d) == WIDE_CORE:
        out += rows(qi, sq)
    return out


def attention_q8_long_ref(qkv: torch.Tensor, bias: torch.Tensor, heads: int,
                          static=None) -> torch.Tensor:
    """Plain version of K4a's long route: the pre-pass's operands
    (``attention_q8_prepass_ref``) and q's codes as the core makes them,
    then the core's two passes over 64-key blocks: pass 1 the row max of
    the logits (dequantized in the JAX order, + bias, keys past N masked),
    pass 2 pq = rint(127·exp(l − max)) against the final max, its exact sum
    and pq·vi through v's slot order; out (B, N, C) in qkv's dtype. Every
    rounding is ``attention_q8_ref``'s, so the two agree bit for bit."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    scale = d ** -0.5
    kc, ks, vs, vt = attention_q8_prepass_ref(qkv, heads, static)[:4]
    np_ = kc.shape[2]
    q = qkv[..., :c].reshape(b, n, heads, d).to(torch.float32)
    if static is not None:
        s_q, s_k, s_v = static
        qi = _codes(q * (1.0 / s_q))
        cq = s_q * s_k * scale
        sv = s_v
    else:
        sq = _scale_from_amax(q.abs().amax(-1, keepdim=True))
        qi = _codes(q / sq)
        cq = (sq * scale).permute(0, 2, 1, 3)  # (B, H, N, 1)
        sv = vs[:, None]                       # (B, 1, H, D)
    dev = qkv.device
    key_slots = torch.tensor([q8_slot(j) for j in range(np_)], device=dev)
    vk = vt[..., key_slots]  # v's codes back in key order, (B, H, D, Np)
    bias_p = torch.zeros((heads, n, np_), dtype=torch.float32, device=dev)
    bias_p[..., :n] = bias.to(torch.float32)
    blocks = [slice(j, j + ATTN_LONG_KEYS)
              for j in range(0, np_, ATTN_LONG_KEYS)]

    def logits(sl):
        acc = _int_einsum("bnhd,bhmd->bhnm", qi, kc[:, :, sl])
        lg = acc * cq if static is not None \
            else acc * cq * ks[:, :, None, sl]
        lg = lg + bias_p[None, :, :, sl]
        past = torch.arange(sl.start, sl.stop, device=dev) >= n
        return lg.masked_fill(past, -math.inf)

    m = torch.full((b, heads, n, 1), -math.inf, device=dev)
    for sl in blocks:  # pass 1: the exact max
        m = torch.maximum(m, logits(sl).amax(-1, keepdim=True))
    av = torch.zeros((b, n, heads, d), device=dev)
    total = torch.zeros((b, heads, n, 1), device=dev)
    for sl in blocks:  # pass 2
        pq = torch.round(torch.exp(logits(sl) - m) * 127.0)
        av = av + _int_einsum("bhnm,bhdm->bnhd", pq, vk[..., sl])
        total = total + pq.sum(-1, keepdim=True)
    recip = (1.0 / total).permute(0, 2, 1, 3)
    return (av * recip * sv).reshape(b, n, c).to(qkv.dtype)


def block_ref_q8(x: torch.Tensor, qparams, heads: int,
                 exact_gelu: bool = False, quant_attn: bool = False,
                 width: int | None = None,
                 head_dim: int | None = None) -> torch.Tensor:
    """Plain version of one w8a8 block (``_block_math_q8``): the four GEMMs
    int8, their inputs quantized from float32 (the LayerNorm outputs and
    the GELU output are never cast to the activation dtype), attention as
    in ``block_ref`` or, with ``quant_attn``, int8 (``_attention_q8``; with
    the 18-tuple's static scales ``_attention_q8s`` on its entries 4–6).
    ``qparams`` is the 17- or 18-tuple of ``quantize_block_params``;
    ``width`` and ``head_dim`` as ``block_ref``'s."""
    (l1s, l1b, wq, sq, bq, bias, wp, sp, bp, l2s, l2b,
     wu, su, bu, wd, sd, bd) = qparams[:17]
    s_act = qparams[17] if len(qparams) == 18 else None
    if s_act is not None:
        qd = lambda t, w, s, i: _qdot_static(t, w, s, s_act[i])
    else:
        qd = lambda t, w, s, i: _qdot(t, w, s)
    dt = x.dtype
    b, n, c = x.shape
    y = _ln(x, l1s, l1b, width=width).reshape(b * n, c)
    qkv = (qd(y, wq, sq, 0).to(dt) + bq).reshape(b, n, -1)
    if quant_attn and s_act is not None:
        a = _attention_q8s(qkv, bias, heads, s_act[4], s_act[5], s_act[6],
                           head_dim)
    elif quant_attn:
        a = _attention_q8(qkv, bias, heads, head_dim)
    else:
        a = _attention(qkv, bias, heads, head_dim)
    p = qd(a.reshape(b * n, -1).to(torch.float32), wp, sp, 1).to(dt) + bp
    r = x + p.reshape(b, n, c)
    y2 = _ln(r, l2s, l2b, width=width).reshape(b * n, c)
    h1 = gelu(qd(y2, wu, su, 2) + bu.to(torch.float32), exact_gelu)
    o = qd(h1, wd, sd, 3).to(dt) + bd
    return r + o.reshape(b, n, c)


def chain_ref_q8(x: torch.Tensor, qparams_list, heads: int,
                 exact_gelu: bool = False, quant_attn: bool = False,
                 width: int | None = None,
                 head_dim: int | None = None) -> torch.Tensor:
    """Plain version of a w8a8 stage: ``block_ref_q8`` back to back."""
    for p in qparams_list:
        x = block_ref_q8(x, p, heads, exact_gelu, quant_attn, width,
                         head_dim).to(x.dtype)
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


# --------------------------------- the plain twin of the padded layouts

def block_twin(x: torch.Tensor, params, heads: int, exact_gelu: bool = False,
               quant_attn: bool = False, train: bool = False):
    """The CUDA blocks' plain twin on their zero-padded layout: what K2
    (``params`` a 13-tuple), K3 (a list of them), K4 (17- or 18-tuples;
    ``quant_attn``: K4a's core) and, with ``train``, K5 compute, in plain
    PyTorch. x and the parameters are padded as the wrappers pad them
    (``padded_widths``), the plain version runs on the layout with the
    LayerNorms' statistics over the true C and q's scale of the true d, and
    the output (with ``train`` also K5's residuals qkv, probs, gin, r) is
    cut back to the true widths."""
    chain = isinstance(params, list)
    plist = params if chain else [params]
    q8 = len(plist[0]) in (17, 18)
    lay = padded_widths(x.shape[-1], heads, plist[0][11 if q8 else 9].shape[0],
                        int8=q8)
    xp, kw = lay.pad_x(x), dict(width=lay.c, head_dim=lay.d)
    if q8:
        out = chain_ref_q8(xp, [lay.pad_qparams(p) for p in plist], heads,
                           exact_gelu, quant_attn, **kw)
        return lay.unpad_x(out)
    pp = [lay.pad_params(p) for p in plist]
    if train:
        out, (qkv, probs, gin, r) = block_train_ref(xp, pp[0], heads,
                                                    exact_gelu, **kw)
        return lay.unpad_x(out), (lay.unpad_heads(qkv, 3), probs,
                                  lay.unpad_hidden(gin), lay.unpad_x(r))
    return lay.unpad_x(chain_ref(xp, pp, heads, exact_gelu, **kw))


def attention_q8_twin(qkv: torch.Tensor, bias: torch.Tensor, heads: int,
                      static=None) -> torch.Tensor:
    """K4a's core alone on its zero-padded layout, in plain PyTorch: qkv's
    heads padded to d' (``PaddedWidths.pad_heads``), ``attention_q8_ref``
    with q's scale of the true d, the output's heads cut back."""
    lay = padded_widths(qkv.shape[-1] // 3, heads)
    out = attention_q8_ref(lay.pad_heads(qkv, 3), bias, heads, static, lay.d)
    return lay.unpad_heads(out)


# -------------------------------------------------------------- CUDA path

def _check_x(x, heads, align):
    """(B, N, C) of an activation the CUDA blocks take: bf16, contiguous,
    heads of a width the cores take (``check_head_dim``; widths that are
    not multiples of 8 on a zero-padded layout), C rounded up to ``align``
    (the padded layout's; the GEMMs' 16-byte rows) at most
    ``MAX_LONG_WIDTH`` (the wide LayerNorm kernels' row; one warp a row up
    to ``MAX_WIDTH``), N <= ``MAX_LONG_TOKENS`` (the long attention route
    above ``MAX_TOKENS``)."""
    if x.dtype != torch.bfloat16 or x.dim() != 3 or not x.is_contiguous():
        raise TypeError(f"x must be a contiguous (B, N, C) bf16 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    b, n, c = x.shape
    check_head_dim(c, heads)
    if _round_up(c, align) > MAX_LONG_WIDTH:
        raise ValueError(f"the CUDA block takes C <= {MAX_LONG_WIDTH}, got "
                         f"C={c}; wider rows are open work (ROADMAP.md)")
    if not 1 <= n <= MAX_LONG_TOKENS or not 1 <= b <= 65535:
        raise ValueError(f"the CUDA block takes 1..{MAX_LONG_TOKENS} tokens "
                         f"and 1..65535 samples, got B={b}, N={n} "
                         "(ROADMAP.md)")
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


def _padded_inputs(x, params_list, heads, int8):
    """A block's (or chain's) inputs on its zero-padded layout: ``(lay, x,
    params_list)``, x and the parameters padded (as they are where the
    layout is the true one), the parameters checked there (``want``: their
    dtypes and shapes at C', A, hidden')."""
    _check_x(x, heads, Q8_K_ALIGN if int8 else GEMM_K_ALIGN)
    hidden = params_list[0][11 if int8 else 9].shape[0]
    lay = padded_widths(x.shape[-1], heads, hidden, int8)
    pad = lay.pad_qparams if int8 else lay.pad_params
    return lay, lay.pad_x(x), [pad(p) for p in params_list]


def _check_cuda(x, params_list, heads):
    """Pads a bf16 block's inputs (``_padded_inputs``) and checks its
    parameters on the layout: ``(lay, x, params_list)``."""
    lay, x, params_list = _padded_inputs(x, params_list, heads, False)
    c, a, hidden, n = lay.c_pad, lay.a, lay.hidden_pad, x.shape[1]
    f32, bf = torch.float32, torch.bfloat16
    want = ((f32, (c,)), (f32, (c,)), (bf, (3 * a, c)), (bf, (3 * a,)),
            (f32, (heads, n, n)), (bf, (c, a)), (bf, (c,)),
            (f32, (c,)), (f32, (c,)), (bf, (hidden, c)), (bf, (hidden,)),
            (bf, (c, hidden)), (bf, (c,)))
    _check_params(params_list, want, x.device, "block")
    return lay, x, params_list


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


def _nbytes(t) -> int:
    """Bytes of a scratch tensor (0 for None), which the C entry points
    check against what their launch writes."""
    return 0 if t is None else t.numel() * t.element_size()


def _pointers(params_list):
    flat = [t for p in params_list for t in p]
    return (ctypes.c_void_p * len(flat))(*[t.data_ptr() for t in flat])


def _mlp_scratch(b, n, c, heads, hidden, x):
    """The bf16 blocks' h, (b·n, hidden) in x's dtype: the MLP's hidden
    activation, and during the attention (before the up GEMM writes it)
    the scratch of the core's wide form, so at least ``wide_scratch``
    bytes (``c`` the attention's width)."""
    elems = max(b * n * hidden,
                -(-wide_scratch(b, n, heads, c // heads) // x.element_size()))
    return torch.empty((elems,), dtype=x.dtype, device=x.device)


def _launch(fn_name, x, params_list, heads):
    """A bf16 block or chain on the card, on its padded layout: x and the
    parameters padded once, the output cut back to C."""
    lay, x, params_list = _check_cuda(x, params_list, heads)
    b, n, c = x.shape
    m, a, hidden = b * n, lay.a, lay.hidden_pad
    out = torch.empty_like(x)
    qkv = torch.empty((m, 3 * a), dtype=x.dtype, device=x.device)
    att = torch.empty((m, a), dtype=x.dtype, device=x.device)
    r = torch.empty((m, c), dtype=x.dtype, device=x.device)
    h = _mlp_scratch(b, n, a, heads, hidden, x)
    ptrs = _pointers(params_list)
    ints = block_plan(b, n, c, heads, hidden, a)
    plan = _plan_arg(ints)
    lib = build.load("fused_block", _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    shape = (b, n, c, heads, hidden, *lay.launch_widths)
    if fn_name == "dm_block_forward":
        err = lib.dm_block_forward(x.data_ptr(), out.data_ptr(), *shape, ptrs,
                                   qkv.data_ptr(), att.data_ptr(),
                                   r.data_ptr(), h.data_ptr(), _nbytes(h),
                                   plan, stream)
    else:
        err = lib.dm_chain_forward(x.data_ptr(), out.data_ptr(), *shape,
                                   len(params_list), ptrs, qkv.data_ptr(),
                                   att.data_ptr(), r.data_ptr(), h.data_ptr(),
                                   _nbytes(h), plan, stream)
    build.check(lib, err, fn_name)
    count_core(ints, blocks=len(params_list))
    count_layer_norms(c, False, len(params_list))
    return lay.unpad_x(out)


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
    ``dm_block_train_forward``) on the block's padded layout (its outputs
    and residuals cut back to the true widths, which the backward takes)
    and count the launch in ``fused_block_train.launches``.
    """
    if not _on_cuda(x):
        return block_train_ref(x, params, heads, exact_gelu)
    _require_tanh_gelu(exact_gelu)
    lay, x, (params,) = _check_cuda(x, [tuple(params)], heads)
    b, n, c = x.shape
    a, hidden = lay.a, lay.hidden_pad
    empty = lambda *shape: torch.empty(shape, dtype=x.dtype, device=x.device)
    out, r, att = empty(b, n, c), empty(b, n, c), empty(b * n, a)
    qkv, probs = empty(b, n, 3 * a), empty(b, heads, n, n)
    gin, h = empty(b, n, hidden), _mlp_scratch(b, n, a, heads, hidden, x)
    lib = build.load("fused_block", _SIGNATURES)
    ints = block_plan(b, n, c, heads, hidden, a)
    err = lib.dm_block_train_forward(
        x.data_ptr(), out.data_ptr(), b, n, c, heads, hidden,
        *lay.launch_widths, _pointers([params]), qkv.data_ptr(),
        probs.data_ptr(), gin.data_ptr(), r.data_ptr(), att.data_ptr(),
        h.data_ptr(), _nbytes(h), _plan_arg(ints),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "dm_block_train_forward")
    count_core(ints)
    count_layer_norms(c, False)
    fused_block_train.launches += 1
    return lay.unpad_x(out), (lay.unpad_heads(qkv, 3), probs,
                              lay.unpad_hidden(gin), lay.unpad_x(r))


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

    CPU tensors run ``gemm_ref``. CUDA tensors (bf16, K % 8 == 0, N % 8
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
    """Pads a w8a8 block's inputs (``_padded_inputs``) and checks its
    parameters on the layout: ``(lay, x, qparams_list, static)``."""
    width = len(qparams_list[0])
    if width not in (17, 18):
        raise ValueError(f"a w8a8 block takes 17 or 18 parameters, got "
                         f"{width}")
    lay, x, qparams_list = _padded_inputs(x, qparams_list, heads, True)
    c, a, hidden, n = lay.c_pad, lay.a, lay.hidden_pad, x.shape[1]
    f32, bf, i8 = torch.float32, torch.bfloat16, torch.int8
    want = ((f32, (c,)), (f32, (c,)), (i8, (3 * a, c)), (f32, (3 * a,)),
            (bf, (3 * a,)), (f32, (heads, n, n)), (i8, (c, a)), (f32, (c,)),
            (bf, (c,)), (f32, (c,)), (f32, (c,)), (i8, (hidden, c)),
            (f32, (hidden,)), (bf, (hidden,)), (i8, (c, hidden)),
            (f32, (c,)), (bf, (c,)), (f32, (7,)))[:width]
    _check_params(qparams_list, want, x.device, "w8a8 block")
    return lay, x, qparams_list, width == 18


def _launch_q8(fn_name, x, qparams_list, heads, quant_attn):
    """A w8a8 block or chain on the card, on its padded layout (as
    ``_launch``)."""
    lay, x, qparams_list, static = _check_cuda_q8(x, qparams_list, heads)
    b, n, c = x.shape
    m, a, hidden = b * n, lay.a, lay.hidden_pad
    dev = x.device
    out = torch.empty_like(x)
    qkv = torch.empty((m, 3 * a), dtype=x.dtype, device=dev)
    att = torch.empty((m, a), dtype=x.dtype, device=dev)
    r = torch.empty((m, c), dtype=x.dtype, device=dev)
    ints = block_plan_q8(b, n, c, heads, hidden, quant_attn, a)
    # h, free during the attention, is also K4a's long-route scratch, or
    # the bf16 core's on its wide form
    h_floats = m * hidden
    if quant_attn and ints[0] == ATTN_LONG_ROUTE:
        h_floats = max(h_floats,
                       -(-attention_q8_long_scratch(b, n, a, heads) // 4))
    elif not quant_attn:
        h_floats = max(h_floats, -(-wide_scratch(b, n, heads, lay.d_pad)
                                   // 4))
    h = torch.empty((h_floats,), dtype=torch.float32, device=dev)
    codes = torch.empty((m, max(a, hidden)), dtype=torch.int8, device=dev)
    row_scale = torch.empty((m,), dtype=torch.float32, device=dev)
    row_amax = torch.empty((m,), dtype=torch.float32, device=dev)
    ptrs = _pointers(qparams_list)
    plan = _plan_arg(ints)
    lib = build.load("fused_block_q8", _SIGNATURES_Q8)
    stream = torch.cuda.current_stream(dev).cuda_stream
    shape = (b, n, c, heads, hidden, *lay.launch_widths)
    flags = (int(static), int(quant_attn))
    scratch = (qkv.data_ptr(), att.data_ptr(), r.data_ptr(), h.data_ptr(),
               _nbytes(h), codes.data_ptr(), row_scale.data_ptr(),
               row_amax.data_ptr())
    if fn_name == "dm_block_forward_q8":
        err = lib.dm_block_forward_q8(x.data_ptr(), out.data_ptr(), *shape,
                                      ptrs, *flags, *scratch, plan, stream)
    else:
        err = lib.dm_chain_forward_q8(x.data_ptr(), out.data_ptr(), *shape,
                                      len(qparams_list), ptrs, *flags,
                                      *scratch, plan, stream)
    build.check(lib, err, fn_name)
    count_core(ints, int8=quant_attn, blocks=len(qparams_list))
    count_layer_norms(c, True, len(qparams_list))
    return lay.unpad_x(out)


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

    CPU tensors run ``gemm_q8_ref``. CUDA tensors (K % 16 == 0, N % 8 ==
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

    CPU tensors run ``attention_q8_ref``. CUDA tensors (bf16, d a width
    ``head_dim_ok`` takes, 1 <= N <= ``MAX_LONG_TOKENS``) launch
    ``csrc/fused_block_q8.cu`` (``dm_attention_q8``) with ``plan`` (an
    ``attention_q8_plan`` of these shapes, either route; the default one if
    None) and count the launch in ``attention_q8.launches``; anything else
    raises.
    """
    if not _on_cuda(qkv):
        return attention_q8_ref(qkv, bias, heads, static)
    b, n, c, d = _check_q8_qkv(qkv, heads, static)
    if (bias.dtype != torch.float32 or tuple(bias.shape) != (heads, n, n)
            or bias.device != qkv.device or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous float32 ({heads}, {n}, "
                         f"{n}) on {qkv.device}")
    plan = plan or attention_q8_plan(b, n, heads, head_dim=d)
    lay = padded_widths(c, heads)  # heads of d' lanes, zeros past d
    qkv = lay.pad_heads(qkv, 3)
    out = torch.empty((b, n, lay.a), dtype=qkv.dtype, device=qkv.device)
    scratch = None
    if plan["route"] == "long":
        scratch = torch.empty((plan["scratch"],), dtype=torch.uint8,
                              device=qkv.device)
    lib = build.load("fused_block_q8", _SIGNATURES_Q8)
    err = lib.dm_attention_q8(
        qkv.data_ptr(), bias.data_ptr(),
        None if static is None else static.data_ptr(), out.data_ptr(), b, n,
        lay.a, heads, d, _plan_arg(plan["ints"]),
        None if scratch is None else scratch.data_ptr(), _nbytes(scratch),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    build.check(lib, err, "dm_attention_q8")
    count_core(plan["ints"], int8=True)
    attention_q8.launches += 1
    return lay.unpad_heads(out)


def _check_q8_qkv(qkv, heads, static):
    """(B, N, C, d) of a packed qkv the int8 core's CUDA entries take."""
    if qkv.dtype != torch.bfloat16 or qkv.dim() != 3 or \
            not qkv.is_contiguous():
        raise TypeError(f"qkv must be a contiguous (B, N, 3C) bf16 tensor, "
                        f"got {qkv.dtype} {tuple(qkv.shape)}")
    b, n, c3 = qkv.shape
    if c3 % 3:
        raise ValueError(f"the int8 attention needs a packed 3C, got {c3}")
    c = c3 // 3
    d = check_head_dim(c, heads)
    if static is not None and (
            static.dtype != torch.float32 or tuple(static.shape) != (3,)
            or static.device != qkv.device or not static.is_contiguous()):
        raise ValueError("static must be a contiguous float32 (3,) tensor "
                         f"on {qkv.device}")
    return b, n, c, d


def attention_q8_prepass(qkv: torch.Tensor, heads: int, static=None):
    """K4a's long-route pre-pass on its own: ``(kc, ks, vs, vt)`` as
    ``attention_q8_prepass_ref`` gives them, from a (B, N, 3C) qkv with
    dynamic scales or ``static`` (s_q, s_k, s_v) (a (3,) float32 tensor on
    the CUDA path). The route launches it before each of its cores; this
    entry serves its measurement and tests.

    CPU tensors run ``attention_q8_prepass_ref``. CUDA tensors (bf16, d a
    width ``head_dim_ok`` takes, 1 <= N <= ``MAX_LONG_TOKENS``) launch
    ``csrc/fused_block_q8.cu`` (``dm_attention_q8_prepass``, one CTA a
    sample and head) into one scratch tensor, whose views of the d real
    lanes it returns (the scratch is ``q8_scratch_width(d)`` wide, its
    lanes past d code 0; above d 256 with q's codes and row scales), and
    count the launch in ``attention_q8_prepass``; anything else raises.
    """
    if not _on_cuda(qkv):
        return attention_q8_prepass_ref(qkv, heads, static)
    b, n, c, d = _check_q8_qkv(qkv, heads, static)
    if not 1 <= n <= MAX_LONG_TOKENS:
        raise ValueError(f"the pre-pass takes 1..{MAX_LONG_TOKENS} tokens, "
                         f"got {n} (ROADMAP.md)")
    np_ = q8_long_keys(n)
    lay = padded_widths(c, heads)  # heads of d' lanes, zeros past d
    qkv = lay.pad_heads(qkv, 3)
    scratch = torch.empty((attention_q8_long_scratch(b, n, lay.a, heads),),
                          dtype=torch.uint8, device=qkv.device)
    lib = build.load("fused_block_q8", _SIGNATURES_Q8)
    err = lib.dm_attention_q8_prepass(
        qkv.data_ptr(), None if static is None else static.data_ptr(),
        scratch.data_ptr(), _nbytes(scratch), b, n, lay.a, heads,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    build.check(lib, err, "dm_attention_q8_prepass")
    attention_q8_prepass.launches += 1
    w = q8_scratch_width(d)
    wide = core_width(d) == WIDE_CORE
    codes = b * heads * np_ * w
    kc = scratch[:codes].view(torch.int8).view(b, heads, np_, w)[..., :d]
    vt = scratch[codes:2 * codes].view(torch.int8).view(
        b, heads, w, np_)[:, :, :d]
    rows = b * heads * np_
    scales = scratch[(3 if wide else 2) * codes:].view(torch.float32)
    ks = scales[:rows].view(b, heads, np_)
    vs = scales[rows:rows + b * heads * w].view(b, heads, w)[..., :d]
    out = (kc, None, None, vt) if static is not None else (kc, ks, vs, vt)
    if wide:  # q's codes and row scales, in k's layout
        qc = scratch[2 * codes:3 * codes].view(torch.int8).view(
            b, heads, np_, w)[..., :d]
        qs = scales[rows + b * heads * w:2 * rows + b * heads * w].view(
            b, heads, np_)
        out += (qc, None if static is not None else qs)
    return out


gemm_q8.launches = 0
attention_q8.launches = 0
attention_q8_prepass.launches = 0


# ------------------------------------------- the blocks' LayerNorm alone

# Both LayerNorm kernels (csrc/fused_block.cu layer_norm_kernel, and
# csrc/fused_block_q8.cu ln_quant_kernel with the row quantize) keep a row
# in registers; their forms as the C dispatch picks them by row width:
# (widest row, 8-element vectors a lane, warps a row).
LN_FORMS = ((MAX_WIDTH, 4, 1), (1536, 6, 1), (2048, 8, 1), (3072, 6, 2),
            (4096, 8, 2), (MAX_LONG_WIDTH, 8, 4))


def layer_norm_form(c: int) -> tuple:
    """(8-element vectors a lane, warps a row) of the LayerNorm kernels
    (bf16, and w8a8 with the quantize) at row width ``c``: one warp a row
    up to 2048, two up to 4096, four above. Raises
    ``ValueError`` for a width no LayerNorm kernel takes (C % 8 != 0, or
    above ``MAX_LONG_WIDTH``)."""
    if c % 8 or not 8 <= c <= MAX_LONG_WIDTH:
        raise ValueError(f"the LayerNorm kernels take C % 8 == 0 up to "
                         f"{MAX_LONG_WIDTH}, got C={c} (ROADMAP.md)")
    return next((vec, warps) for top, vec, warps in LN_FORMS if c <= top)


def _check_rows(x, w, b):
    """(M, C) of a LayerNorm input the kernels take: contiguous bf16 rows,
    C % 8 == 0 (16-byte pieces), C <= ``MAX_LONG_WIDTH``
    (``layer_norm_form``), float32 (C,) scale and bias on x's device
    (16-byte aligned: the bf16 kernel reads them in 16-byte pieces)."""
    if (x.dtype != torch.bfloat16 or x.dim() != 2 or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise TypeError(f"x must be a contiguous (M, C) bf16 tensor, 16-byte "
                        f"aligned; got {x.dtype} {tuple(x.shape)}")
    m, c = x.shape
    if not 1 <= m < 2**31:
        raise ValueError(f"the LayerNorm kernels take 1 <= M < 2**31 rows, "
                         f"got ({m}, {c}) (ROADMAP.md)")
    layer_norm_form(c)
    for t in (w, b):
        if (t.dtype != torch.float32 or tuple(t.shape) != (c,)
                or t.device != x.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"scale and bias must be contiguous float32 "
                             f"({c},) on {x.device}, 16-byte aligned")
    return m, c


def layer_norm_ref(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Plain version of the blocks' LayerNorm: ``_ln`` (two-pass float32
    statistics) rounded to x's dtype, as K2, K3 and K5 feed their qkv and
    up GEMMs."""
    return _ln(x, w, b).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """The bf16 blocks' LayerNorm kernel on its own, (M, C) → (M, C) in x's
    dtype. The blocks launch it from C; this entry serves its measurement
    and tests.

    CPU tensors run ``layer_norm_ref``. CUDA tensors (bf16, C % 8 == 0, C
    <= ``MAX_LONG_WIDTH``) launch ``csrc/fused_block.cu``
    (``dm_layer_norm``: one warp a row up to 2048, two or four above, the
    row in registers; C > ``MAX_WIDTH`` counted in
    ``layer_norm_wide``); anything else raises.
    """
    if not _on_cuda(x):
        return layer_norm_ref(x, w, b)
    m, c = _check_rows(x, w, b)
    y = torch.empty_like(x)
    lib = build.load("fused_block", _SIGNATURES)
    err = lib.dm_layer_norm(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                            y.data_ptr(), m, c, c,
                            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "dm_layer_norm")
    if c > MAX_WIDTH:
        layer_norm_wide.launches += 1
    return y


def ln_quant_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 static_scale=None):
    """Plain version of the w8a8 blocks' LayerNorm + quantize: ``(codes,
    scale)`` of ``quantize_rows`` on the float32 ``_ln`` output, as K4 and
    K4a feed their qkv and up GEMMs (``static_scale`` a (1,) or 0-d
    float32 tensor, or None for dynamic row scales)."""
    if static_scale is not None:
        static_scale = static_scale.reshape(())
    return quantize_rows(_ln(x, w, b), static_scale)


def ln_quant(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             static_scale=None):
    """The w8a8 blocks' LayerNorm + quantize kernel on its own: ``(codes,
    scale)``, int8 (M, C) and float32 (M,) row scales (with
    ``static_scale``, a (1,) float32 tensor on the CUDA path, that scale
    in every row). The blocks launch it from C; this entry serves its
    measurement and tests.

    CPU tensors run ``ln_quant_ref``. CUDA tensors (bf16, C % 8 == 0, C <=
    ``MAX_LONG_WIDTH``) launch ``csrc/fused_block_q8.cu`` (``dm_ln_quant``:
    one warp a row up to 2048, two or four above, the row in registers, as
    ``layer_norm_form`` says; C > ``MAX_WIDTH`` counted in
    ``ln_quant_wide``); anything else raises.
    """
    if not _on_cuda(x):
        return ln_quant_ref(x, w, b, static_scale)
    m, c = _check_rows(x, w, b)
    if static_scale is not None and (
            static_scale.dtype != torch.float32
            or static_scale.numel() != 1 or static_scale.device != x.device):
        raise ValueError(f"static_scale must be a (1,) float32 tensor on "
                         f"{x.device}")
    codes = torch.empty((m, c), dtype=torch.int8, device=x.device)
    scale = torch.empty((m,), dtype=torch.float32, device=x.device)
    lib = build.load("fused_block_q8", _SIGNATURES_Q8)
    err = lib.dm_ln_quant(
        x.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if static_scale is None else static_scale.data_ptr(),
        codes.data_ptr(), scale.data_ptr(), m, c, c,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "dm_ln_quant")
    if c > MAX_WIDTH:
        ln_quant_wide.launches += 1
    return codes, scale
