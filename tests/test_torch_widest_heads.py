"""Heads wider than 256 (264, 384 and 768: the long route's wide form,
which takes d in 128-lane chunks) through every kernel's plain version of
the PyTorch port, against the JAX package's Pallas kernels in interpret
mode, on the CPU, on the same numpy inputs; the wide form's schedule (q·kᵀ
summed over 128-lane chunks, the second pass one 128-lane part of the
output at a time) against the unsplit one, bf16 and int8; the launch plans
from 264 to 8192 (every N on the long route, the shared bytes within one
CTA's, ceil(d / 128) parts, the int8 pre-pass's scratch, the refusals);
and a whole model of one head of 384 (C 384) against the JAX forward on
``state_dict_from_flax`` weights.

The JAX kernels take d from the array's shape (``_attn_inner``,
``_attn_inner_q8``), so they define the function at every width;
``chip_smoke.py`` phase 3 holds the CUDA kernels to these same plain
versions on the card.

Inputs and tolerances are ``test_torch_head_widths.py``'s (2 heads, MLP
4C, B 3, N 13 unless said): relative to max|JAX|, float32 blocks and
chains 1e-5 (of max|JAX|, not of each element: at C 768 and MLP 3072 an
output near 0 can sit 1.3e-5 from JAX's in absolute terms, 1.2e-6 of
max|JAX|, where the f32 sums run in another order), w8a8 blocks 5e-3 in RMS (each row 1e-5 but where an int8
code on a rounding boundary flips: ``test_torch_wide_heads.Q8_ROW_TOL``),
the training block's five outputs and its gradients 1e-5 of max|JAX|
(the 2e-6 of ``test_torch_head_widths.py`` holds up to d 384; at d 768,
C 1536 and MLP 6144, the f32 sums reach 3.3e-6; the gradients 4.0e-6,
within ``test_torch_train_block.py``'s 5e-4), K6's output 1e-5 and its
bf16 probabilities within one bf16 ulp, K7 and K8 1e-5, the whole model
1e-5. K4a's long route's plain version equals its short core's bit for
bit, and so does its schedule in 128-lane parts (integer sums). The bf16
wide schedule against the unsplit one: within 2^-8 of max|out| (one bf16
ulp: the logits' f32 sums run in another order, so a bf16 rounding of the
output may go the other way).
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
                                          TOL, _f32, _jax,
                                          _params, _port, _qkv, _qparams,
                                          _rel, _x)
from tests.test_torch_wide_heads import (FLIPPED_ROW_TOL, FLIPPED_ROWS_MAX,
                                         Q8_ROW_TOL)
from tests.torch_threads import one_torch_thread  # noqa: F401

WIDTHS = [264, 384, 768]
N = 13
KEYS = fb.ATTN_LONG_KEYS
LANES = fb.WIDE_LANES
WIDE_TRAIN_TOL = 1e-5
WIDE_TOL = 2 ** -8


# ------------------------------------------------------- bf16 block path

@pytest.mark.parametrize("d", WIDTHS)
def test_block_matches_pallas(d):
    rs = np.random.default_rng(d + N)
    p = _params(rs, N, d)
    x, xt = _x(rs, N, d)
    want = jfb.fused_block(x, _jax(p), heads=HEADS, block_b=2,
                           interpret=True)
    got = fb.block_ref(xt, _port(p), HEADS)
    assert _rel(got, want) <= TOL
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
    assert _rel(got, want) <= TOL


# ------------------------------------------------------------ w8a8 path

# every mode at 264 and 384; at 768 (C 1536) the dynamic scales, whose
# row and column maxima run over the widest rows (the static scales' codes
# are width-blind)
Q8_CASES = [(d, qa, st) for d in WIDTHS for qa in (False, True)
            for st in (False, True) if d < 768 or not st]


@pytest.mark.parametrize("d,quant_attn,static", Q8_CASES, ids=[
    f"{d}-{'int8' if qa else 'bf16'}-attn-{'static' if st else 'dynamic'}"
    for d, qa, st in Q8_CASES])
def test_q8_block_matches_pallas(d, quant_attn, static):
    rs = np.random.default_rng(d + 3)
    p = _params(rs, N, d)
    x, xt = _x(rs, N, d)
    qp_j, qp_t = _qparams(p, x, static)
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
    """K4a's long-route plain version (the pre-pass's operands, two passes
    over 64-key blocks) equals its short core's bit for bit at a forced N
    of 48 (<= 256): the route every N takes at these widths."""
    qkv, bias = _qkv(48, d, d + 7)
    tq = torch.from_numpy(qkv).to(torch.bfloat16)
    tb = torch.from_numpy(bias)
    st = (torch.tensor(0.03), torch.tensor(0.031), torch.tensor(0.029)) \
        if static else None
    assert torch.equal(fb.attention_q8_long_ref(tq, tb, HEADS, st),
                       fb.attention_q8_ref(tq, tb, HEADS, st))


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("d", WIDTHS)
def test_q8_prepass_ref_quantizes_q_too(d, static):
    """The wide form's pre-pass also gives q's codes and row scales, in
    k's layout (keys padded to 64 with code 0 and scale 1): the codes and
    scales of ``_q8_operands``, the JAX kernels' quantization."""
    n = 50
    qkv, _ = _qkv(n, d, d + 11)
    tq = torch.from_numpy(qkv).to(torch.bfloat16)
    st = (torch.tensor(0.03), torch.tensor(0.031), torch.tensor(0.029)) \
        if static else None
    out = fb.attention_q8_prepass_ref(tq, HEADS, st)
    assert len(out) == 6
    qc, qs = out[4:]
    qi, sq = fb._q8_operands(tq, HEADS, st)[:2]
    assert qc.shape == (B, HEADS, fb.q8_long_keys(n), d)
    assert torch.equal(qc[:, :, :n], qi.permute(0, 2, 1, 3))
    assert not qc[:, :, n:].any()
    if static:
        assert qs is None
    else:
        assert torch.equal(qs[:, :, :n], sq[..., 0].permute(0, 2, 1))
        assert bool((qs[:, :, n:] == 1).all())
    # at the 256 instance and below the pre-pass keeps its four operands
    assert len(fb.attention_q8_prepass_ref(
        torch.from_numpy(_qkv(n, 256, 1)[0]).to(torch.bfloat16), HEADS,
        st)) == 4


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
        assert _rel(g, w) <= WIDE_TRAIN_TOL, (name, _rel(g, w))


@pytest.mark.parametrize("d", WIDTHS)
def test_block_gradients_match_jax(d):
    """Gradients of x and of every parameter through the differentiable
    ``fused_block`` (K5's plain version and ``block_train_bwd``) against
    ``jax.grad`` of the JAX ``fused_block`` on the loss Σ out²."""
    rs = np.random.default_rng(d + 8)
    p = _params(rs, N, d)
    x, xt = _x(rs, N, d)

    def loss(x, p):
        out = jfb.fused_block(x, p, heads=HEADS, block_b=2, interpret=True)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    wx, wp = jax.jit(jax.grad(loss, argnums=(0, 1)))(x, _jax(p))
    xs = xt.clone().requires_grad_(True)
    ps = [t.clone().requires_grad_(True) for t in _port(p)]
    (fb.fused_block(xs, ps, HEADS).float() ** 2).sum().backward()
    assert _rel(xs.grad, wx) <= WIDE_TRAIN_TOL, _rel(xs.grad, wx)
    for i, (g, w) in enumerate(zip(ps, wp)):
        w = _f32(w)
        err = _rel(g.grad, w.T if i in (2, 5, 9, 11) else w)
        assert err <= WIDE_TRAIN_TOL, (i, err)


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


@pytest.mark.parametrize("n", [N, 257])
@pytest.mark.parametrize("d", WIDTHS)
def test_attention_qkv_matches_pallas(d, n):
    """K7 at N 13 and past the short cores' 256 tokens."""
    qkv, bias = _qkv(n, d, d + n)
    want = jfa.fused_attention_qkv(jnp.asarray(qkv), jnp.asarray(bias),
                                   HEADS, interpret=True)
    got = fa.attention_qkv_ref(torch.from_numpy(qkv),
                               torch.from_numpy(bias), HEADS)
    assert tuple(got.shape) == (B, n, HEADS * d)
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


# --------------------------------------------- the wide form's schedule

@pytest.mark.parametrize("n", [12, 130])
@pytest.mark.parametrize("d", WIDTHS)
def test_bf16_wide_schedule(d, n):
    """The bf16 wide form's schedule in plain form (``attention_parts``
    with ``lanes``): q·kᵀ summed over 128-lane chunks (the last one partial
    at d 264) and the value product one 128-lane part at a time, against
    the unsplit attention: the numerators within f32 summation order, the
    output within one bf16 ulp."""
    qkv, bias = _qkv(n, d, d + 9)
    tq = torch.from_numpy(qkv).to(torch.bfloat16)
    tb = torch.from_numpy(bias)
    want, e, recip = fb.attention_parts(tq, tb, HEADS)
    got, e_w, recip_w = fb.attention_parts(tq, tb, HEADS, lanes=LANES)
    assert _rel(got, want) <= WIDE_TOL
    assert _rel(e_w, e) <= 1e-5 and _rel(recip_w, recip) <= 1e-5
    same, _, _ = fb.attention_parts(tq, tb, HEADS, lanes=d)
    assert torch.equal(same, want)


def _split_q8(qkv, bias, heads, once=False):
    """The int8 wide form's schedule on its operands (codes zero past d, at
    the scratch's 128·ceil(d/128) lanes): S summed over 128-lane chunks,
    pass 1 the exact row max over 64-key blocks, pass 2 once for each
    128-lane part of the output, pq recomputed each time and Σpq summed in
    the first; with ``once`` the kernel's pass 2 since S is computed once a
    key block: pq's codes and Σpq made once for each block, then each
    part's value product over the stored codes. The d real lanes of the
    output."""
    b, n, c3 = qkv.shape
    d = c3 // 3 // heads
    w = fb.q8_scratch_width(d)
    qi, sq, ki, sk, vi, sv = fb._q8_operands(qkv, heads, None)
    pad = lambda t: torch.nn.functional.pad(t, (0, w - d))
    qi, ki, vi, sv = pad(qi), pad(ki), pad(vi), pad(sv)
    scale = d ** -0.5
    blocks = [slice(j, min(j + KEYS, n)) for j in range(0, n, KEYS)]
    chunks = [slice(i, i + LANES) for i in range(0, w, LANES)]

    def logits(s):
        acc = sum(fb._int_einsum("bnhd,bmhd->bhnm", qi[..., c],
                                 ki[:, s][..., c]) for c in chunks)
        return acc * (sq * scale).permute(0, 2, 1, 3) \
            * sk[:, s].permute(0, 2, 3, 1) + bias[None, :, :, s]

    m = torch.full((b, heads, n, 1), -math.inf)
    for s in blocks:
        m = torch.maximum(m, logits(s).amax(-1, keepdim=True))
    codes = lambda s: torch.round(torch.exp(logits(s) - m) * 127.0)
    total, outs = 0, []
    if once:
        pqs = [codes(s) for s in blocks]
        for pq in pqs:
            total = total + pq.sum(-1, keepdim=True)
    for part, c in enumerate(chunks):
        av = 0
        for i, s in enumerate(blocks):
            if once:
                pq = pqs[i]
            else:
                pq = codes(s)
                if part == 0:
                    total = total + pq.sum(-1, keepdim=True)
            av = av + fb._int_einsum("bhnm,bmhd->bnhd", pq, vi[:, s][..., c])
        outs.append(av)
    recip = (1.0 / total).permute(0, 2, 1, 3)
    out = torch.cat(outs, -1) * recip * sv
    return out[..., :d].reshape(b, n, -1).to(qkv.dtype)


@pytest.mark.parametrize("n", [12, 130])
@pytest.mark.parametrize("d", WIDTHS)
def test_q8_wide_schedule_is_bit_identical(d, n):
    """The int8 wide form's schedule (128-lane chunks of S, 128-lane parts
    of pass 2, codes zero past d) gives ``attention_q8_ref``'s output bit
    for bit: its sums are integers, exact in any order."""
    qkv, bias = _qkv(n, d, d + n)
    tq = torch.from_numpy(qkv).to(torch.bfloat16)
    tb = torch.from_numpy(bias)
    assert torch.equal(_split_q8(tq, tb, HEADS),
                       fb.attention_q8_ref(tq, tb, HEADS))


# ---------------------------------------------------------------- plans

def test_every_width_past_256_takes_the_wide_form():
    """Every d % 8 == 0 from 264 to 8192 runs on the wide form
    (``core_width`` ``WIDE_CORE``), on the long route at every N, in
    ceil(d / 128) parts, within one CTA's shared bytes and one CTA an SM;
    a forced short route raises."""
    for d in range(264, fb.MAX_HEAD_DIM + 1, 8):
        assert fb.head_dim_ok(d) and fb.core_width(d) == fb.WIDE_CORE
        for plan in (fb.attention_plan, fb.attention_q8_plan):
            p = plan(1024, 192, 1, head_dim=d)
            assert p["route"] == "long"
            assert p["ints"] == (fb.ATTN_LONG_ROUTE, 8, 1, fb.CTA_SHARED_MAX)
            assert p["parts"] == -(-d // 128)
            assert p["ctas_per_sm"] == 1
            assert (p["head_dim"], p["core_width"]) == (d, fb.WIDE_CORE)
    with pytest.raises(ValueError, match="long route"):
        fb.attention_plan(1024, 192, 2, head_dim=384, route="short")


@pytest.mark.parametrize("d", [8200, 8 * 1025, 388, 260])
def test_wide_refusals(d):
    """Above 8192 a width raises ``ValueError`` naming ROADMAP.md, from
    the plans and the CUDA entries' checks. Wide widths that are no
    multiple of 8 (388 and 260), refused before the zero-padded layouts,
    pass now on the wide form, with the plans of their layout's width
    round_up(d, 8)."""
    qkv = torch.zeros((2, 12, 3 * d), dtype=torch.bfloat16)
    bias = torch.zeros((1, 12, 12))
    if d > fb.MAX_HEAD_DIM:
        for plan in (fb.attention_plan, fb.attention_q8_plan):
            with pytest.raises(ValueError, match="ROADMAP.md"):
                plan(1024, 192, 1, head_dim=d)
        with pytest.raises(ValueError, match="ROADMAP.md"):
            fb.check_head_dim(2 * d, 2)
        with pytest.raises(ValueError, match="ROADMAP.md"):
            fa._check_cuda(qkv, bias, 1)
        return
    dp = -(-d // 8) * 8
    for plan in (fb.attention_plan, fb.attention_q8_plan):
        got, want = (plan(1024, 192, 1, head_dim=w) for w in (d, dp))
        assert got["ints"] == want["ints"] and got["parts"] == want["parts"]
        assert got["core_width"] == fb.WIDE_CORE
        assert got.get("scratch") == want.get("scratch")
    assert fb.check_head_dim(2 * d, 2) == d
    assert fa._check_cuda(qkv, bias, 1) == (2, 12, d, d)


def _region(probs=False, int8=False):
    """The wide form's bias region from the C side's layout: the CTA's
    232,448 shared bytes less 1 KB of alignment, the ring of six slots and
    the barriers (two a slot and the slab's, 112 B); the bf16 slots 16 KB
    (K's chunk or V's part), the probabilities' staging 8 warps of 16 x 72
    bf16; K4a's slots 9 KB (k's chunk of codes and its 64 scales, or vᵀ's
    part, on 1 KB)."""
    if int8:
        return 232_448 - 1024 - 6 * 9216 - 112
    return 232_448 - 1024 - 6 * 16_384 - (8 * 2304 if probs else 0) - 112


def test_wide_layout_fits_the_card():
    """The wide form's CTA: one sample and 8 warps, all of a CTA's shared
    memory with a bias region that holds three tile- or row-form areas
    (34,816 B each) and a slab up to N 259 (223 with probabilities, 343
    for K4a), within the registers of one CTA an SM; the pre-pass's
    static shared memory (8 KB of partial maxima, an 8 KB vᵀ tile)."""
    w = fb.WIDE_CORE
    assert (fb.ATTN_LONG_SAMPLES[w], fb.ATTN_LONG_WARPS[w]) == (1, 8)
    for probs, top in ((False, 259), (True, 223)):
        region = _region(probs)
        assert fb._long_bias_region(384, probs) == region
        assert region >= 3 * 128 * 68 * 4
        assert (region - 16) // (128 * 4) == top
        assert fb.attention_long_bias(top, 384, probs) == "slab"
        assert fb.attention_long_bias(top + 1, 384, probs) == (
            "tiles" if (top + 1) % 4 == 0 else "rows")
    region = _region(int8=True)
    assert fb._q8_long_region(768) == region >= 3 * 128 * 68 * 4
    assert (region - 16) // (128 * 4) == 343
    for regs in (fb.ATTN_LONG_REGISTERS[w], fb.ATTN_Q8_LONG_REGISTERS[w]):
        assert regs <= 255 and regs * 8 * 32 <= fb.SM_REGISTERS
    assert fb.ATTN_Q8_PREPASS_THREADS * 8 * 4 + 128 * 64 <= 48 * 1024


@pytest.mark.parametrize("d", [264, 384, 768, 1536, 8192])
def test_wide_plans(d):
    """The wide form's plans at the N the model gives (stages 2 and 1:
    12, 48; 192; past the short cores: 257, 768): the route's ints, grid
    (128-query blocks, sample rows of a persistent grid of about 132 CTAs,
    heads), the bias form of each N, the bf16 core's scratch (a slot of
    128 x Np bf16 for each CTA), the pre-pass's grid and K4a's scratch at
    128·ceil(d/128) lanes (k, vᵀ and q codes; k's and q's row scales, v's
    column scales; then a slot of 128 x Np codes for each CTA)."""
    heads = 2 if d <= 768 else 1
    wide = -(-d // 128) * 128
    for n in (12, 48, 192, 257, 768):
        np_ = -(-n // 64) * 64
        for b in (1, 240, 1024):
            for probs in (False, True):
                plan = fb.attention_plan(b, n, heads, head_dim=d, probs=probs)
                qblocks, groups, h = plan["grid"]
                assert qblocks == -(-n // 128) and h == heads
                slab = 128 * n * 4 + 16 <= _region(probs)
                assert plan["bias"] == ("slab" if slab else "tiles"
                                        if n % 4 == 0 else "rows")
                assert groups == min(b, -(-132 // (qblocks * heads)))
                assert plan["scratch"] == qblocks * groups * heads \
                    * 128 * np_ * 2
            q8 = fb.attention_q8_plan(b, n, heads, head_dim=d)
            assert q8["bias"] == (
                "slab" if 128 * n * 4 + 16 <= _region(int8=True)
                else "tiles" if n % 4 == 0 else "rows")
            assert q8["prepass_grid"] == b * heads
            assert q8["scratch"] == b * heads * (3 * np_ * wide + 8 * np_
                                                 + 4 * wide) \
                + qblocks * groups * heads * 128 * np_
            assert q8["grid"] == plan["grid"]
            assert fb.q8_scratch_width(d) == wide
        if heads * d <= fb.MAX_LONG_WIDTH:
            c = heads * d
            assert fb.block_plan(1024, n, c, heads, 4 * c)[:4] == \
                fb.attention_plan(1024, n, heads, head_dim=d)["ints"]
            assert fb.block_plan_q8(128, n, c, heads, 4 * c, True)[:4] == \
                fb.attention_q8_plan(128, n, heads, head_dim=d)["ints"]


# ---------------------------------------------------------- whole model

def test_model_1x384_matches_jax():
    """The port's ``S2Former`` (the block kernels' plain versions) at one
    head of 384 (C 384), depth (1, 1, 1), float32, against the JAX
    ``build_model`` forward (its Pallas kernels in interpret mode) on
    ``state_dict_from_flax`` weights, at the root scales 32, 64 and 128."""
    kw = dict(embed_dim=384, num_heads=1, depth=(1, 1, 1), out_dim=16,
              dtype="float32")
    mcfg, jcfg = ModelConfig(**kw), JaxModelConfig(**kw)
    jmodel = build_model(jcfg)
    variables = jax.tree.map(np.asarray,
                             init_params(jmodel, jax.random.key(0)))
    rs = np.random.default_rng(20)
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
    assert dataclasses.asdict(mcfg)["num_heads"] == 1
    assert got.shape == want.shape == (2, 16)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("heads", [1, 2])
def test_v3_builds_at_one_and_two_heads(heads):
    """v3 at embed 768 with ``model.num_heads`` 1 or 2 (d 768 or 384)
    builds, and its blocks' plans take the wide form at every stage's N."""
    m = S2Former(ModelConfig(num_heads=heads))
    d = 768 // heads
    assert m.cfg.num_heads == heads
    for n in (192, 48, 12):
        assert fb.block_plan(1024, n, 768, heads, 3072)[:4] == \
            (fb.ATTN_LONG_ROUTE, 8, 1, fb.CTA_SHARED_MAX)
        assert fb.attention_plan(1024, n, heads, head_dim=d)["parts"] == \
            d // 128
