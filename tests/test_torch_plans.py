"""Launch plans of the port's redesigned CUDA kernels, checked on the CPU.

The bf16 attention core (csrc/block_common.cuh) and K2's GEMM
(csrc/fused_block.cu) take their launch plans from
``ops/kernels/fused_block.py`` (``attention_plan``, ``gemm_plan``,
``block_plan``); the C entry points refuse any other. These tests hold the
plans to an H100's limits at every shape the S2Former family launches
(v3's 192/48/12 tokens, v5's 193/49/13, v1's 256, and a single token), and
the wrappers' checks to what the kernels take. They also hold the GEMM's
plain version (``gemm_ref``, the kernel's oracle on the card) to the plain
block whose four products it computes.
"""

import numpy as np
import pytest
import torch

from deepmerge_tpu_torch.ops.kernels import fused_block as fb

SHAPES = [192, 48, 12, 193, 49, 13, 256, 1]
C, HEADS, HIDDEN = 768, 12, 3072


@pytest.mark.parametrize("n", SHAPES)
def test_attention_plan_fits_the_card(n):
    for b in (1024, 240, 1):
        plan = fb.attention_plan(b, n, HEADS)
        bucket, warps, samples, smem = plan["ints"]
        assert bucket in fb.ATTN_KEY_TILE_BUCKETS
        assert bucket * 16 >= n and plan["key_tiles"] == -(-n // 16)
        # K and V of one sample: two (16-key padded) tiles of 144-byte rows
        assert smem == 2 * plan["key_tiles"] * 16 * 144
        assert smem <= fb.CTA_SHARED_MAX
        assert plan["ctas_per_sm"] >= (3 if n <= 193 else 2)
        assert warps <= fb.ATTN_MAX_WARPS[C // HEADS]
        assert plan["grid"] == (HEADS, -(-b // samples))
        assert plan["grid"][1] * samples >= b
        assert plan["grid"][1] <= fb.MAX_GRID_Y


@pytest.mark.parametrize("n", SHAPES)
def test_block_plan_meets_the_gemm_preconditions(n):
    b = 1024
    ints = fb.block_plan(b, n, C, HEADS, HIDDEN)
    assert ints[:4] == fb.attention_plan(b, n, HEADS)["ints"]
    bm, bn, bk, stages, threads, smem = ints[4:]
    assert (bm, bn, bk) == (fb.GEMM_BM, fb.GEMM_BN, 64)
    assert smem == stages * (bm + bn) * bk * 2 + 1024 + 2 * stages * 8
    assert smem <= fb.CTA_SHARED_MAX
    for rows, depth in ((3 * C, C), (C, C), (HIDDEN, C), (C, HIDDEN)):
        plan = fb.gemm_plan(b * n, rows, depth)
        assert plan["ints"] == tuple(ints[4:])
        # TMA: 64-wide K slabs, row strides and bases on 16 bytes
        assert depth % bk == 0 and (depth * 2) % 16 == 0 and rows % 8 == 0
        assert plan["grid"] == (-(-rows // bn), -(-(b * n) // bm))
        assert plan["ctas_per_sm"] >= 1
    assert threads == 2 * 128 + 32


@pytest.mark.parametrize("kwargs,match", [
    (dict(b=4, n=0, heads=2), "tokens"),
    # past the long route (N > 256 takes it; the short core's limit is
    # held by the forced short route in test_torch_long_shapes.py)
    (dict(b=4, n=fb.MAX_LONG_TOKENS + 1, heads=2), "tokens"),
    (dict(b=4, n=12, heads=2, warps=0), "warps"),
    (dict(b=4, n=12, heads=2, warps=13), "warps"),
    (dict(b=4, n=12, heads=2, samples=0), "samples"),
    (dict(b=70_000, n=12, heads=2, samples=1), "grid"),
])
def test_attention_plan_refuses(kwargs, match):
    with pytest.raises(ValueError, match=match):
        fb.attention_plan(**kwargs)


@pytest.mark.parametrize("m,n,k", [(256, 768, 100), (256, 12, 768),
                                   (0, 768, 768), (256, 768, 0)])
def test_gemm_plan_refuses(m, n, k):
    """K's rows must be a multiple of 16 bytes (K % 8 in bf16; a K tail
    past the last 64-wide slab is taken) and N a multiple of 8."""
    with pytest.raises(ValueError, match="K % 8"):
        fb.gemm_plan(m, n, k)


def test_gemm_wrapper_checks_refuse_what_the_kernel_does_not_take():
    bf = torch.bfloat16
    a, w = torch.zeros((64, 128), dtype=bf), torch.zeros((256, 128), dtype=bf)
    bias = torch.zeros((256,), dtype=bf)
    m, n, k, plan = fb._check_gemm(a, w, bias, "bias_cast", None)
    assert (m, n, k) == (64, 256, 128) and plan["grid"] == (1, 1)
    misaligned = torch.zeros((64 * 128 + 1,), dtype=bf)[1:].view(64, 128)
    with pytest.raises(TypeError, match="16-byte"):
        fb._check_gemm(misaligned, w, bias, "bias_cast", None)
    with pytest.raises(TypeError):
        fb._check_gemm(a.float(), w, bias, "bias_cast", None)
    with pytest.raises(ValueError, match="K % 8"):
        fb._check_gemm(a[:, :100].contiguous(), w[:, :100].contiguous(), bias,
                       "bias_cast", None)
    with pytest.raises(ValueError, match="residual"):
        fb._check_gemm(a, w, bias, "bias_residual", None)
    with pytest.raises(ValueError, match="epilogue"):
        fb._check_gemm(a, w, bias, "bias_relu", None)


def _block(rs, n, c=128, heads=2, hidden=256, dt=torch.bfloat16):
    r = lambda *shape, s=0.05: torch.from_numpy(
        (rs.standard_normal(shape) * s).astype(np.float32))
    params = (1.0 + r(c), r(c), r(3 * c, c).to(dt), r(3 * c).to(dt),
              r(heads, n, n, s=0.5), r(c, c).to(dt), r(c).to(dt),
              1.0 + r(c), r(c), r(hidden, c).to(dt), r(hidden).to(dt),
              r(c, hidden).to(dt), r(c).to(dt))
    x = torch.from_numpy(rs.standard_normal((3, n, c)).astype(np.float32))
    return x.to(dt), params, heads


@pytest.mark.parametrize("train", [False, True], ids=["block", "train"])
@pytest.mark.parametrize("n", [12, 13])
def test_gemm_ref_composes_the_plain_block(n, train):
    """The four epilogues of ``gemm_ref`` around the plain attention give
    ``block_ref`` bit for bit (and, around the training block's attention,
    ``block_train_ref``'s output and its saved pre-GELU activation, which
    ``bias_gelu_save`` writes): the GEMM's oracle has the block's rounding
    points."""
    x, p, heads = _block(np.random.default_rng(n), n)
    (l1s, l1b, wq, bq, bias, wp, bp, l2s, l2b, wu, bu, wd, bd) = p
    b, _, c = x.shape
    flat = lambda t: t.reshape(b * n, -1)
    y = fb._ln(x, l1s, l1b).to(x.dtype)
    qkv = fb.gemm_ref(flat(y), wq, bq, "bias_cast")[0].reshape(b, n, 3 * c)
    attention = fb._attention_norm_first if train else fb.attention_parts
    a = attention(qkv, bias, heads)[0]
    r = fb.gemm_ref(flat(a), wp, bp, "bias_residual", flat(x))[0]
    y2 = fb._ln(r, l2s, l2b).to(x.dtype)
    h, gin = fb.gemm_ref(y2, wu, bu, "bias_gelu_save")
    assert torch.equal(h, fb.gemm_ref(y2, wu, bu, "bias_gelu")[0])
    out = fb.gemm_ref(h, wd, bd, "bias_residual", r)[0].reshape(b, n, c)
    if train:
        want, saved = fb.block_train_ref(x, p, heads)
        assert torch.equal(gin.reshape(b, n, -1), saved[2])
    else:
        want = fb.block_ref(x, p, heads)
    assert torch.equal(out, want)
