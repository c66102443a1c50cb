"""The wide form's second pass as its kernels run it since it computes S
once a key block (csrc/block_common.cuh attention_wide_kernel,
csrc/fused_block_q8.cu attention_q8_wide_kernel), in plain form on the
CPU: P (bf16) or pq's codes (int8) made once for each 64-key block and
kept, then the value product once for each 128-lane part of the output
over the kept blocks. Held bit for bit to the schedule that made them
again for each part (``attention_parts(..., recompute=True)``,
``_split_q8``), and against the JAX package's ``_attn_inner`` /
``_attn_inner_q8`` (the Pallas kernels' inner functions, on the CPU) on
the same numpy inputs: bf16 within one bf16 ulp of max|JAX| (2^-7: the
logits' f32 sums run in another order, so an output's rounding may go
the other way), float32 within 1e-5, int8 within 1e-5 but for the rows
where ``exp``'s last bit moves a probability code
(``tests/test_torch_q8_plans.py``'s bounds: at most one row in a
thousand, and here at least one row of the 780 to 1152). Then the plans of the
scratch both kernels keep those blocks in: one slot of 128 x Np (bf16 or
codes) for each CTA of the wide form's persistent grid of about 132 CTAs
at every N, with the ring and bias areas within 227 KB.

Inputs are ``test_torch_head_widths.py``'s (2 heads, B 3) at d 264, 384
and 768 and N 12, 130 and 192 (one partial block, three blocks with a
partial one, three whole blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu.ops.pallas import fused_block as jfb
from deepmerge_tpu_torch.ops.kernels import fused_block as fb
from tests.test_torch_head_widths import B, BF16_ULP, HEADS, TOL, _qkv, _rel
from tests.test_torch_q8_plans import (ATTN_TOL, FLIPPED_ROW_TOL,
                                       FLIPPED_ROWS_MAX)
from tests.test_torch_widest_heads import KEYS, LANES, WIDE_TOL, _split_q8
from tests.torch_threads import one_torch_thread  # noqa: F401

CASES = [(d, n) for d in (264, 384, 768) for n in (12, 130, 192)]
IDS = [f"d{d}-n{n}" for d, n in CASES]


@pytest.mark.parametrize("d,n", CASES, ids=IDS)
def test_bf16_pass2_once_a_block(d, n):
    """P made once a key block, then P·V part by part: the same bits as P
    made again for each part, in bf16 and float32; within 2^-8 of
    max|out| of the unsplit attention (as ``test_bf16_wide_schedule``)
    and one bf16 ulp of ``_attn_inner`` (bf16), within 1e-5 of both in
    float32."""
    qkv, bias = _qkv(n, d, d + 3 * n)
    tb = torch.from_numpy(bias)
    for dt, jdt, tol, jtol in (
            (torch.bfloat16, jnp.bfloat16, WIDE_TOL, BF16_ULP),
            (torch.float32, jnp.float32, TOL, TOL)):
        tq = torch.from_numpy(qkv).to(dt)
        once, e, recip = fb.attention_parts(tq, tb, HEADS, lanes=LANES,
                                            keys=KEYS)
        again, e2, recip2 = fb.attention_parts(tq, tb, HEADS, lanes=LANES,
                                               keys=KEYS, recompute=True)
        assert torch.equal(once, again)
        assert torch.equal(e, e2) and torch.equal(recip, recip2)
        unsplit = fb.attention_parts(tq, tb, HEADS)[0]
        assert _rel(once, unsplit) <= tol
        want = jax.jit(lambda t, bb: jfb._attn_inner(
            t, bb, heads=HEADS, dtype=jdt))(
                jnp.asarray(tq.float().numpy(), dtype=jdt), bias)
        assert once.shape == (B, n, HEADS * d)
        assert _rel(once, want) <= jtol


@pytest.mark.parametrize("d,n", CASES, ids=IDS)
def test_q8_pass2_once_a_block(d, n):
    """pq's codes and Σpq made once a key block, then pq·v part by part:
    ``attention_q8_ref``'s output bit for bit, as the codes made again for
    each part give it; against ``_attn_inner_q8`` (float32) within 1e-5 of
    max|JAX| but for a rare row whose code sits on a rounding boundary."""
    qkv, bias = _qkv(n, d, d + 5 * n)
    tb = torch.from_numpy(bias)
    tq = torch.from_numpy(qkv).to(torch.bfloat16)
    once = _split_q8(tq, tb, HEADS, once=True)
    assert torch.equal(once, _split_q8(tq, tb, HEADS))
    assert torch.equal(once, fb.attention_q8_ref(tq, tb, HEADS))
    f32 = tq.float()
    got = _split_q8(f32, tb, HEADS, once=True)
    want = np.asarray(jax.jit(lambda t, bb: jfb._attn_inner_q8(
        t, bb, heads=HEADS, dtype=jnp.float32))(f32.numpy(), bias))
    err = (np.abs(got.numpy() - want) / np.abs(want).max()).reshape(
        B, n, HEADS, d).max(-1)
    assert (err > ATTN_TOL).sum() <= max(1, FLIPPED_ROWS_MAX * err.size)
    assert err.max() <= FLIPPED_ROW_TOL


# ---------------------------------------------------------------- plans

@pytest.mark.parametrize("b", [1, 16, 128, 240, 1024])
@pytest.mark.parametrize("n", [12, 48, 192, 257, 768, 4096])
def test_wide_scratch_plans(n, b):
    """The scratch the wide form keeps P in: the grid (query blocks,
    sample rows, heads) holds about 132 CTAs (at least one a query block
    and head, at most one a sample), and the bf16 scratch one slot of 128
    x Np bf16 for each (``wide_scratch``; 6.2 MB at N 192, B 1024: in
    L2), K4a's one of 128 x Np codes after the pre-pass's operands; the
    width-256 instance needs none."""
    for heads, d in ((2, 384), (1, 768), (1, 1536)):
        np_ = -(-n // 64) * 64
        qblocks = -(-n // 128)
        rows = fb.wide_sample_groups(b, n, heads)
        assert rows == min(b, -(-132 // (qblocks * heads)))
        ctas = qblocks * rows * heads
        assert ctas >= min(132, qblocks * heads * b)
        assert ctas < 132 + qblocks * heads
        plan = fb.attention_plan(b, n, heads, head_dim=d)
        assert plan["grid"] == (qblocks, rows, heads)
        assert plan["scratch"] == fb.wide_scratch(b, n, heads, d) \
            == ctas * 128 * np_ * 2
        q8 = fb.attention_q8_plan(b, n, heads, head_dim=d)
        assert q8["grid"] == plan["grid"]
        w = fb.q8_scratch_width(d)
        assert q8["scratch"] == b * heads * (3 * np_ * w + 8 * np_ + 4 * w) \
            + ctas * 128 * np_
        if n == 192 and b == 1024:
            assert plan["scratch"] == 132 * 128 * 192 * 2 < 50 * 2 ** 20
    assert fb.wide_scratch(b, n, 3, 256) == 0
    assert "scratch" in fb.attention_plan(b, max(n, 257), 3, head_dim=256)
    assert fb.attention_plan(b, max(n, 257), 3, head_dim=256)["scratch"] == 0


@pytest.mark.parametrize("probs", [False, True], ids=["plain", "probs"])
def test_wide_ring_fits_the_card(probs):
    """Both wide cores' shared memory: six ring slots (bf16: 16 KB, K's
    128-lane chunk or V's part; int8: 9 KB, k's chunk of codes with its
    64 scales or vᵀ's part, on 1 KB), three bias areas of 34,816 B in the
    region that is left, the probabilities' staging and 13 barriers within
    the 232,448 B a CTA may take."""
    bars = -(-(2 * fb.WIDE_SLOTS + 1) * 8 // 16) * 16
    assert (fb.WIDE_SLOTS, bars) == (6, 112)
    staging = 8 * 16 * 72 * 2 if probs else 0
    region = fb._long_bias_region(768, probs)
    assert 1024 + 6 * 16_384 + region + staging + bars == fb.CTA_SHARED_MAX
    assert region >= 3 * 128 * 68 * 4
    q8 = fb._q8_long_region(768)
    assert fb.WIDE_Q8_SLOT == -(-(8192 + 64 * 4) // 1024) * 1024
    assert 1024 + 6 * fb.WIDE_Q8_SLOT + q8 + bars == fb.CTA_SHARED_MAX
    assert q8 >= 3 * 128 * 68 * 4



@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("n", [12, 192, 768])
def test_mlp_scratch_holds_the_wide_slots(n, b):
    """The bf16 blocks hand the core their MLP buffer h as its scratch,
    with its byte count, which the C side checks against its own grid: h
    holds both the (b·n, hidden) activation and the wide form's slots
    (``wide_scratch``), whichever is larger."""
    for heads, d in ((2, 384), (1, 768)):
        c = heads * d
        x = torch.empty((b, n, c), dtype=torch.bfloat16)
        h = fb._mlp_scratch(b, n, c, heads, 4 * c, x)
        assert h.dtype == x.dtype
        assert fb._nbytes(h) == 2 * max(b * n * 4 * c,
                                        fb.wide_scratch(b, n, heads, d) // 2)
        assert fb._nbytes(h) >= fb.wide_scratch(b, n, heads, d)
    assert fb._nbytes(None) == 0
