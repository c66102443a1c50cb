"""Heads wider than 128 (192 and 256: on the attention cores' instance of
width 256, which only the long route has) through every kernel's plain
version of the PyTorch port, against the JAX package's Pallas kernels in
interpret mode, on the CPU, on the same numpy inputs; the launch plans at
width 256 (every N on the long route, the shared bytes within one CTA's,
the bias forms, the int8 pre-pass's scratch, ``core_width`` over
136..256); the long route's second pass split by output lanes, as the
width-256 kernels run it, against the unsplit schedule; and a whole model
of 2 heads of 192 (C 384) against the JAX forward on
``state_dict_from_flax`` weights.

The JAX kernels take d from the array's shape (``_attn_inner``,
``_attn_inner_q8``), so they define the function at every width;
``chip_smoke.py`` phase 3 holds the CUDA kernels to these same plain
versions on the card.

Inputs and tolerances are ``test_torch_head_widths.py``'s (2 heads, MLP
4C, B 3, N 13 unless said): relative to max|JAX|, float32 blocks and
chains 1e-5, w8a8 blocks 5e-3 in RMS (each row 1e-5 but where an int8
code on a rounding boundary flips: ``Q8_ROW_TOL``), the training block's
five outputs 2e-6, K6's output 1e-5 and its bf16 probabilities within one
bf16 ulp, K7 and K8 1e-5, the whole model 1e-5. K4a's long route's plain
version equals its short core's bit for bit.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu.config import ModelConfig as JaxModelConfig
from deepmerge_tpu.models.s2former import build_model, init_params
from deepmerge_tpu.ops.pallas import fused_attention as jfa
from deepmerge_tpu.ops.pallas import fused_block as jfb
from deepmerge_tpu_torch.compat.weights import state_dict_from_flax
from deepmerge_tpu_torch.config import ModelConfig
from deepmerge_tpu_torch.models.s2former import S2Former
from deepmerge_tpu_torch.ops.kernels import fused_attention as fa
from deepmerge_tpu_torch.ops.kernels import fused_block as fb
from tests.test_torch_head_widths import (B, BF16_ULP, CHAIN_TOL, HEADS,
                                          TOL, TRAIN_TOL, _f32, _jax,
                                          _params, _port, _qkv, _qparams,
                                          _rel, _x)
from tests.torch_threads import one_torch_thread  # noqa: F401

WIDTHS = [192, 256]
N = 13
KEYS = fb.ATTN_LONG_KEYS


# ------------------------------------------------------- bf16 block path

@pytest.mark.parametrize("d", WIDTHS)
def test_block_matches_pallas(d):
    rs = np.random.default_rng(d + N)
    p = _params(rs, N, d)
    x, xt = _x(rs, N, d)
    want = jfb.fused_block(x, _jax(p), heads=HEADS, block_b=2,
                           interpret=True)
    got = fb.block_ref(xt, _port(p), HEADS)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL, atol=TOL)
    torch.testing.assert_close(fb.fused_block(xt, _port(p), HEADS), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("d", WIDTHS)
def test_chain_matches_pallas(d):
    n = 12
    rs = np.random.default_rng(d + 1)
    plist = [_params(rs, n, d) for _ in range(2)]
    x, xt = _x(rs, n, d)
    want = jfb.fused_block_chain(x, tuple(_jax(p) for p in plist),
                                 heads=HEADS, block_b=2, interpret=True)
    got = fb.chain_ref(xt, [_port(p) for p in plist], HEADS)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL, atol=TOL)


# ------------------------------------------------------------ w8a8 path

# A w8a8 block's rows: those where no int8 code sits on a rounding boundary
# agree with JAX to float32 summation order; where the two libraries' last
# bit moves one (seen: 1-2 rows of B·N = 39 at N 13, at width 128 too:
# 6.0e-3), the row moves by up to a quant step, within the card's block
# bar (``chip_smoke.py`` TOL_BLOCK), and the block's RMS error stays within
# CHAIN_TOL.
Q8_ROW_TOL = 1e-5
FLIPPED_ROWS_MAX = 0.1
FLIPPED_ROW_TOL = 2e-2


@pytest.mark.parametrize("quant_attn", [False, True], ids=["bf16-attn",
                                                           "int8-attn"])
@pytest.mark.parametrize("d", WIDTHS)
def test_q8_block_matches_pallas(d, quant_attn):
    rs = np.random.default_rng(d + 3)
    p = _params(rs, N, d)
    x, xt = _x(rs, N, d)
    qp_j, qp_t = _qparams(p, x, False)
    want = _f32(jfb.fused_block(x, qp_j, heads=HEADS, interpret=True,
                                quant=True, quant_attn=quant_attn))
    got = fb.block_ref_q8(xt, qp_t, HEADS, quant_attn=quant_attn)
    diff = np.abs(_f32(got) - want)
    rows = diff.max(-1) / np.abs(want).max()
    assert (rows > Q8_ROW_TOL).mean() <= FLIPPED_ROWS_MAX
    assert rows.max() <= FLIPPED_ROW_TOL
    assert np.sqrt((diff ** 2).mean() / (want ** 2).mean()) <= CHAIN_TOL
    torch.testing.assert_close(
        fb.fused_block_q8(xt, qp_t, HEADS, quant_attn=quant_attn), got,
        rtol=0, atol=0)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("d", WIDTHS)
def test_q8_long_ref_is_the_short_core(d, static):
    """K4a's long-route plain version (the pre-pass's operands at the
    instance's layout, two passes over 64-key blocks) equals its short
    core's bit for bit: the route every N takes at these widths."""
    qkv, bias = _qkv(48, d, d + 7)
    tq = torch.from_numpy(qkv).to(torch.bfloat16)
    tb = torch.from_numpy(bias)
    st = (torch.tensor(0.03), torch.tensor(0.031), torch.tensor(0.029)) \
        if static else None
    assert torch.equal(fb.attention_q8_long_ref(tq, tb, HEADS, st),
                       fb.attention_q8_ref(tq, tb, HEADS, st))


# ---------------------------------------------------- training block (K5)

@pytest.mark.parametrize("d", WIDTHS)
def test_block_train_ref_matches_jax(d):
    """K5's plain version against ``_fused_block_train_forward`` in
    interpret mode: the output and the four saved residuals."""
    rs = np.random.default_rng(d + 5)
    p = _params(rs, N, d)
    x, xt = _x(rs, N, d)
    out, (qkv, probs, gin, r) = jax.jit(
        lambda x, p: jfb._fused_block_train_forward(
            x, p, HEADS, False, 2, True))(x, _jax(p))
    probs = _f32(probs).reshape(B, N, HEADS, N).transpose(0, 2, 1, 3)
    got_out, got = fb.block_train_ref(xt, _port(p), HEADS)
    for name, g, w in zip(("out", "qkv", "probs", "gin", "r"),
                          (got_out, *got), (out, qkv, probs, gin, r)):
        assert tuple(g.shape) == tuple(w.shape), name
        assert _rel(g, w) <= TRAIN_TOL, (name, _rel(g, w))


# ------------------------------------------------ attention (K6, K7, K8)

@pytest.mark.parametrize("d", WIDTHS)
def test_attention_probs_matches_pallas(d):
    qkv, bias = _qkv(N, d, d)
    j_out, j_probs = jfa._fused_qkv_probs_forward(
        jnp.asarray(qkv), jnp.asarray(bias), HEADS, 8, True)
    t_out, t_probs = fa.attention_probs_ref(
        torch.from_numpy(qkv), torch.from_numpy(bias), HEADS)
    assert _rel(t_out, j_out) <= TOL
    got, want = _f32(t_probs), _f32(j_probs)
    np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-12)


@pytest.mark.parametrize("d", WIDTHS)
def test_attention_qkv_matches_pallas(d):
    qkv, bias = _qkv(N, d, d + 1)
    want = jfa.fused_attention_qkv(jnp.asarray(qkv), jnp.asarray(bias),
                                   HEADS, interpret=True)
    got = fa.attention_qkv_ref(torch.from_numpy(qkv),
                               torch.from_numpy(bias), HEADS)
    assert tuple(got.shape) == (B, N, HEADS * d)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("d", WIDTHS)
def test_attention_bnhd_matches_pallas(d):
    qkv, bias = _qkv(N, d, d + 2)
    q, k, v = (qkv[..., i * HEADS * d:(i + 1) * HEADS * d].reshape(
        B, N, HEADS, d) for i in range(3))
    want = jfa.fused_attention(*(jnp.asarray(t) for t in (q, k, v)),
                               jnp.asarray(bias), interpret=True)
    got = fa.attention_bnhd_ref(*(torch.from_numpy(np.ascontiguousarray(t))
                                  for t in (q, k, v)),
                                torch.from_numpy(bias))
    assert tuple(got.shape) == (B, N, HEADS, d)
    assert _rel(got, want) <= TOL


# ------------------------------------ the long route's second pass in parts

def _split_q8(qkv, bias, heads, parts):
    """The int8 long route's schedule on the width-256 instance's operands
    (q, k and v codes zero past d, as the pre-pass and the core make them):
    pass 1 the exact row max over 64-key blocks, then pass 2 once for each
    of ``parts`` ranges of the 256 lanes, pq recomputed each time, Σpq
    summed in the first; the d real lanes of the output."""
    b, n, c3 = qkv.shape
    d = c3 // 3 // heads
    w = fb.core_width(d)
    qi, sq, ki, sk, vi, sv = fb._q8_operands(qkv, heads, None)
    pad = lambda t: torch.nn.functional.pad(t, (0, w - d))
    qi, ki, vi, sv = pad(qi), pad(ki), pad(vi), pad(sv)
    scale = d ** -0.5
    blocks = [slice(j, min(j + KEYS, n)) for j in range(0, n, KEYS)]

    def logits(s):
        acc = fb._int_einsum("bnhd,bmhd->bhnm", qi, ki[:, s])
        return acc * (sq * scale).permute(0, 2, 1, 3) \
            * sk[:, s].permute(0, 2, 3, 1) + bias[None, :, :, s]

    m = torch.full((b, heads, n, 1), -math.inf)
    for s in blocks:
        m = torch.maximum(m, logits(s).amax(-1, keepdim=True))
    lanes, total, outs = w // parts, 0, []
    for part in range(parts):
        av = 0
        for s in blocks:
            pq = torch.round(torch.exp(logits(s) - m) * 127.0)
            if part == 0:
                total = total + pq.sum(-1, keepdim=True)
            av = av + fb._int_einsum(
                "bhnm,bmhd->bnhd", pq,
                vi[:, s, :, part * lanes:(part + 1) * lanes])
        outs.append(av)
    recip = (1.0 / total).permute(0, 2, 1, 3)
    out = torch.cat(outs, -1) * recip * sv
    return out[..., :d].reshape(b, n, -1).to(qkv.dtype)


@pytest.mark.parametrize("n", [12, 48, 130])
@pytest.mark.parametrize("d", WIDTHS)
def test_q8_second_pass_in_parts_is_bit_identical(d, n):
    """The int8 route's second pass in two parts of 128 lanes on the
    256-lane instance, codes zero past d, gives ``attention_q8_ref``'s
    output bit for bit (integer sums are exact in any order), at stage 2's
    and stage 1's token counts and across a block edge."""
    qkv, bias = _qkv(n, d, d + n)
    tq = torch.from_numpy(qkv).to(torch.bfloat16)
    tb = torch.from_numpy(bias)
    parts = fb.ATTN_LONG_PARTS[fb.core_width(d)]
    assert parts == 2
    want = fb.attention_q8_ref(tq, tb, HEADS)
    assert torch.equal(_split_q8(tq, tb, HEADS, parts), want)
    assert torch.equal(_split_q8(tq, tb, HEADS, 1), want)


@pytest.mark.parametrize("d", WIDTHS)
def test_bf16_second_pass_in_parts(d):
    """The bf16 route's second pass by output lanes: e = exp(l − max)
    against the same final max in each part, so each part's columns of
    bf16(e)·v are the unsplit product's columns; against
    ``attention_parts`` within its bf16 bar."""
    n = 48
    qkv, bias = _qkv(n, d, d + 9)
    tq = torch.from_numpy(qkv).to(torch.bfloat16)
    tb = torch.from_numpy(bias)
    want, e, recip = fb.attention_parts(tq, tb, HEADS)
    b, c = B, HEADS * d
    v = tq[..., 2 * c:].reshape(b, n, HEADS, d).to(torch.float32)
    p = e.to(torch.bfloat16).to(torch.float32)
    lanes = fb.core_width(d) // fb.ATTN_LONG_PARTS[fb.core_width(d)]
    parts = [torch.einsum("bhnm,bmhd->bhnd", p, v[..., i:i + lanes])
             for i in range(0, d, lanes)]
    got = (torch.cat(parts, -1) * recip).permute(0, 2, 1, 3).reshape(
        b, n, c).to(torch.bfloat16)
    assert _rel(got, want) <= 2 ** -8


# ---------------------------------------------------------------- plans

@pytest.mark.parametrize("d", range(136, 257, 8))
def test_core_width_above_128(d):
    """Every width in (128, 256] runs on the 256 instance, on the long
    route at every N (the short cores have no such instance: a forced
    short route raises), and the plans carry both widths."""
    assert fb.head_dim_ok(d) and fb.core_width(d) == 256
    for plan in (fb.attention_plan, fb.attention_q8_plan):
        for n in (1, 12, 48, 192, 256, 768):
            p = plan(1024, n, 3, head_dim=d)
            assert p["route"] == "long" and p["ints"][0] == fb.ATTN_LONG_ROUTE
            assert (p["head_dim"], p["core_width"]) == (d, 256)
        with pytest.raises(ValueError, match="long route"):
            plan(1024, 192, 3, head_dim=d, route="short")


def _region(probs=False, int8=False):
    """The bias region at width 256 from the C side's layout: the CTA's
    232,448 shared bytes less 1 KB of alignment, the ring and the
    barriers; the bf16 ring two stages of K (32 KB) and half of V (16 KB),
    the probabilities' staging 8 warps of 16 x 72 bf16; K4a's three stages
    of k codes (16 KB), half of vᵀ's (8 KB) and k's 64 scales, on 1 KB."""
    if int8:
        return 232_448 - 1024 - 3 * 25_600 - 64
    return 232_448 - 1024 - 2 * 49_152 - (8 * 2304 if probs else 0) - 48


def test_wide_layout_fits_the_card():
    """Width 256's long routes: one sample and 8 warps a CTA, pass 2 in
    two parts, all of a CTA's shared memory with a bias region that holds
    two tile- or row-form stage areas (34,816 B each; three for K4a) and a
    slab up to N 259 (223 with probabilities, 301 for K4a), within the
    registers of one CTA an SM; the pre-pass's static shared memory."""
    w = 256
    assert (fb.ATTN_LONG_SAMPLES[w], fb.ATTN_LONG_WARPS[w],
            fb.ATTN_LONG_PARTS[w]) == (1, 8, 2)
    for probs, top in ((False, 259), (True, 223)):
        region = _region(probs)
        assert fb._long_bias_region(w, probs) == region
        assert region >= 2 * 128 * 68 * 4
        assert (region - 16) // (128 * 4) == top
        assert fb.attention_long_bias(top, w, probs) == "slab"
        assert fb.attention_long_bias(top + 1, w, probs) == (
            "tiles" if (top + 1) % 4 == 0 else "rows")
    region = _region(int8=True)
    assert fb._q8_long_region(w) == region >= 3 * 128 * 68 * 4
    assert (region - 16) // (128 * 4) == 301
    for regs in (fb.ATTN_LONG_REGISTERS[w], fb.ATTN_Q8_LONG_REGISTERS[w]):
        assert regs <= 255 and regs * 8 * 32 <= fb.SM_REGISTERS
    kparts = fb.ATTN_Q8_PREPASS_THREADS // (w // 8)
    assert kparts * w * 4 + w * 4 + w * 64 <= 48 * 1024


@pytest.mark.parametrize("d", WIDTHS)
def test_wide_plans(d):
    """The long routes' plans at width 256 for every N the model gives
    (stages 2 and 1: 12, 48; 192; past the short cores: 257, 768): the
    route's ints, 128-query blocks x sample groups x heads, the bias form
    of each N (a slab up to the region's rows, then tiles where N % 4 ==
    0, else rows), the pre-pass's grid and the scratch at the instance's
    width."""
    heads = 768 // d
    for n in (12, 48, 192, 257, 768):
        for b in (1, 240, 1024):
            for probs in (False, True):
                plan = fb.attention_plan(b, n, heads, head_dim=d, probs=probs)
                assert plan["ints"] == (fb.ATTN_LONG_ROUTE, 8, 1, 232_448)
                assert plan["ctas_per_sm"] == 1
                qblocks, groups, h = plan["grid"]
                assert qblocks == -(-n // 128) and h == heads
                slab = 128 * n * 4 + 16 <= _region(probs)
                assert plan["bias"] == ("slab" if slab else "tiles"
                                        if n % 4 == 0 else "rows")
                per = -(-b * qblocks * heads // 2048) if slab else 1
                assert groups == -(-b // per)
            q8 = fb.attention_q8_plan(b, n, heads, head_dim=d)
            np_ = -(-n // 64) * 64
            assert q8["ints"] == (fb.ATTN_LONG_ROUTE, 8, 1, 232_448)
            assert q8["bias"] == (
                "slab" if 128 * n * 4 + 16 <= _region(int8=True)
                else "tiles" if n % 4 == 0 else "rows")
            assert q8["prepass_grid"] == b * heads
            assert q8["scratch"] == b * heads * (2 * np_ * 256 + 4 * np_
                                                 + 4 * 256)
        assert fb.block_plan(1024, n, 768, heads, 3072)[:4] == \
            fb.attention_plan(1024, n, heads, head_dim=d)["ints"]
        assert fb.block_plan_q8(128, n, 768, heads, 3072, True)[:4] == \
            fb.attention_q8_plan(128, n, heads, head_dim=d)["ints"]


# ---------------------------------------------------------- whole model

def test_model_2x192_matches_jax():
    """The port's ``S2Former`` (the block kernels' plain versions) at 2
    heads of 192 (C 384), depth (1, 1, 1), float32, against the JAX
    ``build_model`` forward (its Pallas kernels in interpret mode) on
    ``state_dict_from_flax`` weights (qkv rows and bias-table columns
    crossing at a wide head), at the root scales 32, 64 and 128."""
    kw = dict(embed_dim=384, num_heads=2, depth=(1, 1, 1), out_dim=16,
              dtype="float32")
    mcfg, jcfg = ModelConfig(**kw), JaxModelConfig(**kw)
    jmodel = build_model(jcfg)
    variables = jax.tree.map(np.asarray,
                             init_params(jmodel, jax.random.key(0)))
    rs = np.random.default_rng(19)
    patches = [rs.random((2, s, s, 3), dtype=np.float32)
               for s in mcfg.input_image_scales]
    designed = rs.standard_normal((2, 19)).astype(np.float32)
    want = np.asarray(jmodel.apply(
        variables, tuple(jnp.asarray(p) for p in patches),
        jnp.asarray(designed), False))
    port = S2Former(mcfg)
    port.load_state_dict(state_dict_from_flax(variables["params"], mcfg),
                         strict=True)
    with torch.inference_mode():
        got = port.eval()([torch.from_numpy(p) for p in patches],
                          torch.from_numpy(designed)).numpy()
    assert dataclasses.asdict(mcfg)["num_heads"] == 2
    assert got.shape == want.shape == (2, 16)
    assert _rel(got, want) <= TOL
