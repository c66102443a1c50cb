"""Long sequences and wide rows on the port's plain versions, on the CPU.

The CUDA attention cores take N up to ``MAX_TOKENS`` (256) in registers and
longer sequences on a second route that streams the keys in blocks of 64,
twice; the LayerNorm kernels, bf16 and w8a8 alike, take a row in one
warp up to 2048 and in two or four warps above it. Here, against the JAX package as its own tests
run it (Pallas in interpret mode), on the same seeded numpy inputs and
weights:

* two whole models past 256 tokens: v5 at four scales with cube 8 (257 /
  65 / 17 tokens) and v3 with a 16x16 cube (768 / 192 / 48), float32,
  within 1e-5 of max|JAX| (``test_torch_variants.py``'s bound);
* a block at C 1152 (rows past the one-warp LayerNorm), N 12: ``_ln``
  within 1e-5, the bf16 block within 1e-5 in float32 and 2e-2 in bf16
  (``test_torch_head_widths.py``'s bounds), the w8a8 block within 2e-2
  with an RMS error within 1e-2 of its RMS (the bars the chip holds K4's
  block to): the two LayerNorms sum 1152 lanes in other orders, so an
  int8 code of qkv on a rounding boundary can flip, and through k and v
  it moves every row of the attention by up to one quant step;
* the long route's schedule as a key-blocked, two-pass plain twin of each
  core against the full plain version: the int8 core's codes and output
  bit for bit (an exact max and integer sums, each element by the same
  arithmetic), the bf16 core within 2e-2 of max|plain| (its Σe summed
  online in another order, its exp taken as 2^(x·log₂e), the bf16
  rounding of e against the same final max);
* the int8 long route's pre-pass (its plain twin, which the kernel
  matches bit for bit on the card) against the codes the JAX package
  forms, bit for bit, and the route's twin on those codes against
  ``_attn_inner_q8`` / ``_attn_inner_q8s``;
* the plans of the new routes and the new limits: the long routes' CTA
  (128 queries, two samples, 16 warps; one sample and 8 warps at width
  128) within the card's limits at every width, their grids and bias
  forms, K4a's pre-pass and scratch, and the LayerNorms' form at
  every width.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu.config import ModelConfig as JaxModelConfig
from deepmerge_tpu.models.s2former import build_model, init_params
from deepmerge_tpu.ops.pallas import fused_block as jfb
from deepmerge_tpu_torch.compat.weights import state_dict_from_flax
from deepmerge_tpu_torch.config import ModelConfig
from deepmerge_tpu_torch.models.s2former import S2Former
from deepmerge_tpu_torch.ops.kernels import fused_attention as fa
from deepmerge_tpu_torch.ops.kernels import fused_block as fb
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
BF16_TOL = 2e-2
Q8_TOL, Q8_RMS_TOL = 2e-2, 1e-2
KEYS = fb.ATTN_LONG_KEYS
LOG2E = float(np.float32(math.log2(math.e)))  # the kernel's f32 log₂e

MODELS = {
    # 4·8² + 1 = 257 tokens at stage 0: one past the short core
    "v5-4scales": dict(variant="v5", input_image_scales=(8, 16, 32, 64),
                       cube=8),
    # patches of 1/2/4 pixels on a 16x16 cube: 768 / 192 / 48 tokens
    "v3-cube16": dict(variant="v3", input_image_scales=(16, 32, 64),
                      cube=16),
}


@pytest.mark.parametrize("model", list(MODELS))
def test_model_past_256_tokens_matches_jax(model):
    """The port's ``S2Former`` (plain versions) against the JAX forward
    (Pallas in interpret mode) on ``state_dict_from_flax`` weights."""
    kw = dict(MODELS[model], embed_dim=32, num_heads=4, depth=(1, 1, 1),
              out_dim=16, dtype="float32")
    mcfg, jcfg = ModelConfig(**kw), JaxModelConfig(**kw)
    jmodel = build_model(jcfg)
    variables = jax.tree.map(np.asarray,
                             init_params(jmodel, jax.random.key(0)))
    rs = np.random.default_rng(3)
    patches = [rs.random((2, s, s, 3), dtype=np.float32)
               for s in mcfg.input_image_scales]
    designed = rs.standard_normal((2, 19)).astype(np.float32)
    want = np.asarray(jmodel.apply(
        variables, tuple(jnp.asarray(p) for p in patches),
        jnp.asarray(designed), False))
    port = S2Former(mcfg)
    port.load_state_dict(state_dict_from_flax(variables["params"], mcfg),
                         strict=True)
    tokens = []
    hook = port.blocks0[0].register_forward_pre_hook(
        lambda m, args: tokens.append(args[0].shape[1]))
    with torch.inference_mode():
        got = port.eval()([torch.from_numpy(p) for p in patches],
                          torch.from_numpy(designed)).numpy()
    hook.remove()
    assert tokens[0] > fb.MAX_TOKENS
    assert got.shape == want.shape == (2, 16)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


# ------------------------------------------------------- rows past 1024

WIDE_C, WIDE_HEADS, WIDE_N = 1152, 18, 12   # 18 heads of 64
DENSE = (2, 5, 9, 11)


def _wide_params(rs, n):
    c, h = WIDE_C, 4 * WIDE_C
    r = lambda *shape, s=0.03: (rs.standard_normal(shape) * s).astype(
        np.float32)
    return (1.0 + r(c), r(c), r(c, 3 * c), r(3 * c), r(WIDE_HEADS, n, n,
                                                       s=0.5),
            r(c, c), r(c), 1.0 + r(c), r(c), r(c, h), r(h), r(h, c), r(c))


def _port(p, dt=torch.float32):
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a.T if i in DENSE else a)).to(
            dt if i not in (0, 1, 4, 7, 8) else torch.float32)
        for i, a in enumerate(p))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_block_matches_jax(dtype):
    """LayerNorm and one block at C 1152 > ``MAX_WIDTH``: ``_ln`` and the
    kernels' plain versions (bf16 and w8a8) against the JAX package's."""
    rs = np.random.default_rng(11)
    p = _wide_params(rs, WIDE_N)
    x = rs.standard_normal((3, WIDE_N, WIDE_C)).astype(np.float32)
    assert WIDE_C > fb.MAX_WIDTH
    jx = jnp.asarray(x).astype(dtype)
    dt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(dt)
    want_ln = np.asarray(jfb._ln(jx.astype(jnp.float32), jnp.asarray(p[0]),
                                 jnp.asarray(p[1])))
    got_ln = fb._ln(tx, torch.from_numpy(p[0]), torch.from_numpy(p[1]))
    assert np.abs(got_ln.numpy() - want_ln).max() <= TOL * np.abs(
        want_ln).max()
    jp = tuple(jnp.asarray(a) if i in (0, 1, 4, 7, 8)
               else jnp.asarray(a).astype(dtype) for i, a in enumerate(p))
    want = np.asarray(jfb.fused_block(jx, jp, heads=WIDE_HEADS, block_b=2,
                                      interpret=True).astype(jnp.float32))
    got = fb.block_ref(tx, _port(p, dt), WIDE_HEADS).float().numpy()
    tol = TOL if dtype == "float32" else BF16_TOL
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    if dtype == "float32":
        jq = jfb.quantize_block_params(jp)
        want_q = np.asarray(jfb.fused_block(
            jx, jq, heads=WIDE_HEADS, block_b=2, interpret=True, quant=True))
        qp = fb.quantize_block_params(_port(p, dt))
        got_q = fb.block_ref_q8(tx, qp, WIDE_HEADS).numpy()
        diff = got_q - want_q
        assert np.abs(diff).max() <= Q8_TOL * np.abs(want_q).max()
        assert np.sqrt((diff ** 2).mean()) <= Q8_RMS_TOL * np.sqrt(
            (want_q ** 2).mean())


# --------------------------------- the long route's schedule, on the CPU

def _attention_inputs(seed, b=2, n=200, heads=3, d=32):
    rs = np.random.default_rng(seed)
    qkv = torch.from_numpy(rs.standard_normal(
        (b, n, 3 * heads * d)).astype(np.float32)).to(torch.bfloat16)
    bias = torch.from_numpy((rs.standard_normal((heads, n, n)) * 0.5).astype(
        np.float32))
    return qkv, bias, heads


def _blocked_bf16(qkv, bias, heads):
    """The bf16 long route's two passes over 64-key blocks: pass 1 the f32
    row max and Σe online (Σ rescaled by exp(m_old − m_new)), pass 2 e =
    exp(l − m) against the final max, P = bf16(e) into O, out =
    bf16(O·(1/Σe)); exp(x) as the kernel takes it, 2^(x·log₂e) with log₂e
    folded into the logits (l·log₂e − m·log₂e)."""
    f32 = torch.float32
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    q, k, v = (t.reshape(b, n, heads, d).to(f32)
               for t in (qkv[..., :c] * fb.q_scale(d, qkv.dtype),
                         qkv[..., c:2 * c], qkv[..., 2 * c:]))
    blocks = [slice(j, min(j + KEYS, n)) for j in range(0, n, KEYS)]
    logits = lambda s: torch.einsum("bnhd,bmhd->bhnm", q, k[:, s]) \
        + bias[None, :, :, s]
    m = torch.full((b, heads, n, 1), -math.inf)
    total = torch.zeros((b, heads, n, 1))
    for s in blocks:                       # pass 1
        lg = logits(s)
        new = torch.maximum(m, lg.amax(-1, keepdim=True))
        total = total * torch.exp2((m - new) * LOG2E) + torch.exp2(
            lg * LOG2E - new * LOG2E).sum(-1, keepdim=True)
        m = new
    o = torch.zeros((b, heads, n, d))
    for s in blocks:                       # pass 2
        e = torch.exp2(logits(s) * LOG2E - m * LOG2E)
        o = o + torch.einsum("bhnm,bmhd->bhnd", e.to(qkv.dtype).to(f32),
                             v[:, s])
    return (o * (1.0 / total)).permute(0, 2, 1, 3).reshape(b, n, c).to(
        qkv.dtype)


def _q8_logits_codes(qkv, bias, heads, static, blocks):
    """pq and the output of the int8 core, the keys in ``blocks`` (one
    slice: the full plain version's order; 64-key slices: the long
    route's two passes, with v's column scales from a pre-pass over all
    keys, as both take them)."""
    b, n, c3 = qkv.shape
    d = c3 // 3 // heads
    qi, sq, ki, sk, vi, sv = fb._q8_operands(qkv, heads, static)
    scale = d ** -0.5

    def logits(s):
        acc = fb._int_einsum("bnhd,bmhd->bhnm", qi, ki[:, s])
        if static is None:
            lg = acc * (sq * scale).permute(0, 2, 1, 3) \
                * sk[:, s].permute(0, 2, 3, 1)
        else:
            lg = acc * (sq * sk * scale)
        return lg + bias[None, :, :, s]

    m = torch.full((b, heads, n, 1), -math.inf)
    for s in blocks:                       # pass 1: the exact max
        m = torch.maximum(m, logits(s).amax(-1, keepdim=True))
    codes, av, total = [], 0, 0
    for s in blocks:                       # pass 2
        pq = torch.round(torch.exp(logits(s) - m) * 127.0)
        codes.append(pq)
        av = av + fb._int_einsum("bhnm,bmhd->bnhd", pq, vi[:, s])
        total = total + pq.sum(-1, keepdim=True)
    recip = (1.0 / total).permute(0, 2, 1, 3)
    out = (av * recip * sv).reshape(b, n, -1).to(qkv.dtype)
    return torch.cat(codes, -1), out


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("n", [200, 300])
def test_blocked_int8_core_is_bit_identical(n, static):
    """The int8 long route's schedule gives the full plain version's codes
    and output bit for bit, and that output is ``attention_q8_ref``'s."""
    qkv, bias, heads = _attention_inputs(n, n=n)
    scales = (torch.tensor(0.03), torch.tensor(0.031), torch.tensor(0.029)) \
        if static else None
    blocks = [slice(j, min(j + KEYS, n)) for j in range(0, n, KEYS)]
    codes_full, out_full = _q8_logits_codes(qkv, bias, heads, scales,
                                            [slice(0, n)])
    codes, out = _q8_logits_codes(qkv, bias, heads, scales, blocks)
    assert torch.equal(codes, codes_full)
    assert torch.equal(out, out_full)
    assert torch.equal(out, fb.attention_q8_ref(qkv, bias, heads, scales))
    # the port's twin of the route: the pre-pass's padded, slot-ordered
    # operands and the core's two passes over them
    assert torch.equal(fb.attention_q8_long_ref(qkv, bias, heads, scales),
                       out)


def _jax_q8_inputs(n, d, static, heads=2, b=2):
    """A (b, n, 3C) float32 qkv (a zero k row and a zero v lane included),
    its bias and, with ``static``, scales at 0.8 of each operand's
    abs-max / 127 (codes clipped)."""
    rs = np.random.default_rng(n + d + static)
    c = heads * d
    qkv = (rs.standard_normal((b, n, 3 * c)) * 2.0).astype(np.float32)
    qkv[0, 3, c:c + d] = 0.0          # a zero k row: scale 1, codes 0
    qkv[1, :, 2 * c + 5] = 0.0        # a zero v lane: scale 1, codes 0
    bias = (rs.standard_normal((heads, n, n)) * 0.5).astype(np.float32)
    s = tuple(np.float32(0.8 * np.abs(qkv[..., i * c:(i + 1) * c]).max()
                         / 127.0) for i in range(3)) if static else None
    return qkv, bias, heads, s


@jax.jit
def _jax_kv_codes(k, v):
    """k's and v's codes and scales as ``_attn_inner_q8`` forms them (its
    lines, over every head at once): per row over the d lanes for k, per
    lane over the tokens for v."""
    ka = jnp.max(jnp.abs(k), axis=-1, keepdims=True)
    sk = jnp.where(ka > 0, ka / 127.0, 1.0)
    ki = jnp.clip(jnp.round(k / sk), -127, 127).astype(jnp.int8)
    va = jnp.max(jnp.abs(v), axis=1, keepdims=True)
    sv = jnp.where(va > 0, va / 127.0, 1.0)
    vi = jnp.clip(jnp.round(v / sv), -127, 127).astype(jnp.int8)
    return ki, sk, vi, sv


@jax.jit
def _jax_kv_codes_static(k, v, s_k, s_v):
    """The same as ``_attn_inner_q8s`` forms them: rint(t · (1/s))."""
    rk, rv = 1.0 / s_k, 1.0 / s_v
    return (jnp.clip(jnp.round(k * rk), -127, 127).astype(jnp.int8),
            jnp.clip(jnp.round(v * rv), -127, 127).astype(jnp.int8))


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", [257, 768])
def test_q8_prepass_twin_matches_jax_codes(n, d, static):
    """The int8 long route's pre-pass (its plain twin, what the kernel is
    held to bit for bit on the card) against the codes the JAX package
    forms: k's codes (B, H, Np, d) and row scales (B, H, Np), v's column
    scales (B, H, d) and v's codes transposed (B, H, d, Np) in the slot
    order, equal to JAX's, bit for bit; padded keys (to Np, whole 64-key
    blocks) code 0 and scale 1."""
    qkv, _, heads, s = _jax_q8_inputs(n, d, static)
    b, c = qkv.shape[0], heads * d
    np_ = fb.q8_long_keys(n)
    assert np_ % fb.ATTN_LONG_KEYS == 0 and n <= np_ < n + 64
    k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, n, heads, d)
            for i in (1, 2))
    st = None if s is None else tuple(torch.tensor(x) for x in s)
    kc, ks, vs, vt = fb.attention_q8_prepass(torch.from_numpy(qkv), heads,
                                             st)
    if static:
        ki, vi = map(np.asarray, _jax_kv_codes_static(k, v, s[1], s[2]))
        assert ks is None and vs is None
    else:
        ki, sk, vi, sv = map(np.asarray, _jax_kv_codes(k, v))
        np.testing.assert_array_equal(ks[:, :, :n].numpy(),
                                      sk[..., 0].transpose(0, 2, 1))
        assert bool((ks[:, :, n:] == 1.0).all())
        np.testing.assert_array_equal(vs.numpy(), sv[:, 0])
    np.testing.assert_array_equal(kc[:, :, :n].numpy(),
                                  ki.transpose(0, 2, 1, 3))
    assert not kc[:, :, n:].any()
    slots = [fb.q8_slot(j) for j in range(np_)]
    assert sorted(slots) == list(range(np_))
    by_key = vt.numpy()[..., slots]  # back in key order
    np.testing.assert_array_equal(by_key[..., :n], vi.transpose(0, 2, 3, 1))
    assert not by_key[..., n:].any()


# the rare (token, head) row where exp differs in the last bit between the
# two libraries and moves a probability code rint(127·e) on a rounding
# boundary by one: tests/test_torch_q8_plans.py's bounds (one row of 3072
# seen at N 768)
Q8_ATTN_TOL = 1e-5
FLIPPED_ROWS_MAX = 1e-3
FLIPPED_ROW_TOL = 2e-2


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("n, d", [(257, 32), (768, 64)])
def test_q8_long_twin_matches_jax(n, d, static):
    """The port's int8 long route (``attention_q8_long_ref``: the pre-pass's
    operands, the core's two passes over 64-key blocks) against the jitted
    ``_attn_inner_q8`` / ``_attn_inner_q8s`` on the CPU (float32), within
    1e-5 of max|JAX| but for the rows where ``exp``'s last bit moves a
    code (``FLIPPED_ROWS_MAX``, ``FLIPPED_ROW_TOL``); and bit for bit the
    port's full plain version."""
    qkv, bias, heads, s = _jax_q8_inputs(n, d, static)
    b = qkv.shape[0]
    if static:
        want = jax.jit(lambda t, bb: jfb._attn_inner_q8s(
            t, bb, heads=heads, dtype=jnp.float32, s_q=s[0], s_k=s[1],
            s_v=s[2]))(qkv, bias)
        st = tuple(torch.tensor(x) for x in s)
    else:
        want = jax.jit(lambda t, bb: jfb._attn_inner_q8(
            t, bb, heads=heads, dtype=jnp.float32))(qkv, bias)
        st = None
    tq, tb = torch.from_numpy(qkv), torch.from_numpy(bias)
    got = fb.attention_q8_long_ref(tq, tb, heads, st)
    assert torch.equal(got, fb.attention_q8_ref(tq, tb, heads, st))
    want = np.asarray(want)
    err = (np.abs(got.numpy() - want) / np.abs(want).max()).reshape(
        b, n, heads, d).max(-1)
    assert (err > Q8_ATTN_TOL).mean() <= FLIPPED_ROWS_MAX
    assert err.max() <= FLIPPED_ROW_TOL


@pytest.mark.parametrize("n", [200, 300])
def test_blocked_bf16_core_matches_plain(n):
    """The bf16 long route's schedule against ``attention_parts``."""
    qkv, bias, heads = _attention_inputs(n + 1, n=n)
    want = fb.attention_parts(qkv, bias, heads)[0].float()
    got = _blocked_bf16(qkv, bias, heads).float()
    assert (got - want).abs().max() <= BF16_TOL * want.abs().max()


# ---------------------------------------------------------------- plans

def _bf16_long_region(d, probs):
    """The bf16 long route's bias region at width d, from the C side's
    layout: the CTA's 232,448 shared bytes less 1 KB of alignment, the K/V
    ring (three stages, two with probabilities; each a 64-key block of K
    and of V of each sample), the probabilities' staging (16 x 72 bf16 a
    warp) and the barriers (two a stage and the slab's, on 16 bytes)."""
    samples = 1 if d == 128 else 2
    stages = 2 if probs else 3
    staging = 8 * samples * 16 * 72 * 2 if probs else 0
    bars = 48 if probs else 64
    return 232_448 - 1024 - stages * 2 * samples * 64 * d * 2 - staging \
        - bars


def _bf16_long_grid(b, n, heads, d, probs=False):
    """(128-query blocks, sample groups, heads): a CTA a group of two
    samples (one at width 128), but where a CTA's 128 bias rows fit the
    bias region (the slab form) ceil(groups · CTAs-a-group / 2048) groups
    a CTA."""
    groups = -(-b // (1 if d == 128 else 2))
    qblocks = -(-n // 128)
    if 128 * n * 4 + 16 <= _bf16_long_region(d, probs):
        per = -(-groups * qblocks * heads // 2048)
        groups = -(-groups // per)
    return (qblocks, groups, heads)


def _q8_long_region(d):
    """K4a's long-route bias region at width d, from the C side's layout:
    the CTA's 232,448 shared bytes less 1 KB of alignment, three stages
    (each a 64-key block of k codes and of vᵀ codes of each sample, two
    but at width 128, and k's 64 row scales of each, rounded up to 1 KB)
    and the barriers (two a stage and the slab's, on 16 bytes)."""
    samples = 1 if d == 128 else 2
    stage = -(-(2 * samples * 64 * d + samples * 256) // 1024) * 1024
    return 232_448 - 1024 - 3 * stage - 64


def _q8_long_grid(b, n, heads, d):
    """The bf16 route's grid rule on K4a's bias region and samples."""
    groups = -(-b // (1 if d == 128 else 2))
    qblocks = -(-n // 128)
    if 128 * n * 4 + 16 <= _q8_long_region(d):
        per = -(-groups * qblocks * heads // 2048)
        groups = -(-groups // per)
    return (qblocks, groups, heads)


@pytest.mark.parametrize("d", fb.SHORT_CORE_WIDTHS)
def test_q8_long_layout_fits_the_card(d):
    """K4a's long route at each width: a stage of 9,216 (d 32) or 17,408
    bytes, a bias region that holds the tile and row forms' three stage
    areas (34,816 B each) and a slab up to N 397 (d 32) / 349, all within
    the 232,448 bytes one CTA may take; 16 warps and two samples a CTA (8
    and one at width 128) within the registers of one CTA an SM; the
    pre-pass's CTA (256 threads) and its static shared memory."""
    region = _q8_long_region(d)
    assert fb._q8_long_region(d) == region
    assert region >= 3 * 128 * 68 * 4 and region + 3 * (
        9216 if d == 32 else 17408) + 1024 + 64 == fb.CTA_SHARED_MAX
    top = (region - 16) // (128 * 4)
    assert top == (397 if d == 32 else 349)
    assert fb.attention_long_bias(top, d, int8=True) == "slab"
    assert fb.attention_long_bias(top + 1, d, int8=True) == (
        "tiles" if (top + 1) % 4 == 0 else "rows")
    warps = fb.ATTN_LONG_WARPS[d]
    assert warps == (8 if d == 128 else 16)
    assert fb.ATTN_Q8_LONG_REGISTERS[d] * warps * 32 <= fb.SM_REGISTERS
    kparts = fb.ATTN_Q8_PREPASS_THREADS // (d // 8)
    assert kparts * d * 4 + d * 4 + d * 64 <= 48 * 1024


@pytest.mark.parametrize("d", fb.SHORT_CORE_WIDTHS)
def test_long_route_plans(d):
    """Above ``MAX_TOKENS`` both cores take the long route. The bf16 core:
    its marker, 16 warps and two samples a CTA (8 and one at width 128),
    all of a CTA's shared memory (232,448 bytes), a grid of 128-query
    blocks x sample groups x heads (``_bf16_long_grid``). K4a's, since its
    redesign on wgmma: the same CTA and ints, the grid rule on its own bias
    region (``_q8_long_grid``), a pre-pass of
    one CTA a sample and head and
    the scratch both share (k and vᵀ codes, k's and v's scales). Both
    within the card's limits; at most ``MAX_TOKENS`` they return the short
    core's ints unless the long route is forced."""
    heads = 768 // d
    samples = 1 if d == 128 else 2
    for n in (fb.MAX_TOKENS + 1, 768, 4096, fb.MAX_LONG_TOKENS):
        for b in (1, 240, 1023):
            for probs in (False, True):
                plan = fb.attention_plan(b, n, heads, head_dim=d,
                                         probs=probs)
                assert plan["route"] == "long"
                assert plan["ints"] == (fb.ATTN_LONG_ROUTE, 8 * samples,
                                        samples, 232_448)
                assert plan["grid"] == _bf16_long_grid(b, n, heads, d, probs)
            q8 = fb.attention_q8_plan(b, n, heads, head_dim=d)
            np_ = -(-n // 64) * 64
            assert q8["route"] == "long"
            assert q8["ints"] == (fb.ATTN_LONG_ROUTE, 8 * samples, samples,
                                  232_448)
            assert q8["grid"] == _q8_long_grid(b, n, heads, d)
            assert q8["prepass_grid"] == b * heads
            assert q8["scratch"] == b * heads * (2 * np_ * d + 4 * np_
                                                 + 4 * d)
            for p in (plan, q8):
                assert p["smem"] <= fb.CTA_SHARED_MAX
                assert p["ctas_per_sm"] >= 1
    for n in (1, 192, fb.MAX_TOKENS):
        short = fb.attention_plan(1024, n, heads, head_dim=d)
        assert short["route"] == "short" and short["ints"][0] >= 1
        forced = fb.attention_plan(1024, n, heads, head_dim=d, route="long")
        assert forced["ints"][0] == fb.ATTN_LONG_ROUTE
        assert fb.attention_q8_plan(1024, n, heads, head_dim=d,
                                    route="long")["route"] == "long"
    assert fb.block_plan(1024, 768, 768, heads, 3072)[:4] == \
        fb.attention_plan(1024, 768, heads, head_dim=d)["ints"]
    assert fb.block_plan_q8(128, 768, 768, heads, 3072, True)[:4] == \
        fb.attention_q8_plan(128, 768, heads, head_dim=d)["ints"]


@pytest.mark.parametrize("n", [257, 768, fb.MAX_LONG_TOKENS])
@pytest.mark.parametrize("d", fb.CORE_WIDTHS)
def test_bf16_long_plan_fits_the_card(d, n):
    """The bf16 long route at each width: a CTA within the shared bytes
    one CTA may take and the registers of its launch bound (one CTA an
    SM: 128 a thread at 16 warps, 255 at 8), a grid whose 128-query blocks
    cover N once and whose CTAs take every sample once, and the bias form
    of each N (the slab at 257, tiles at 768 and 16,384)."""
    heads = 768 // d
    for b in (1, 127, 128, 1024):
        plan = fb.attention_plan(b, n, heads, head_dim=d)
        warps, samples, smem = plan["ints"][1:]
        assert warps == 8 * samples and smem == fb.CTA_SHARED_MAX
        assert fb.ATTN_LONG_REGISTERS[d] * warps * 32 <= fb.SM_REGISTERS
        assert plan["ctas_per_sm"] == 1
        qblocks, groups, h = plan["grid"]
        assert (qblocks - 1) * fb.ATTN_LONG_QUERIES < n \
            <= qblocks * fb.ATTN_LONG_QUERIES
        assert h == heads and 1 <= groups <= fb.MAX_GRID_Y
        # CTA y takes sample groups y, y + groups, ...: every group once
        total = -(-b // samples)
        taken = sorted(g for y in range(groups)
                       for g in range(y, total, groups))
        assert taken == list(range(total))
        assert plan["key_blocks"] == -(-n // fb.ATTN_LONG_KEYS)
        assert plan["bias"] == ("slab" if n == 257 else "tiles")


@pytest.mark.parametrize("c, form", [
    (8, (4, 1)), (768, (4, 1)), (1024, (4, 1)), (1032, (6, 1)),
    (1536, (6, 1)), (1544, (8, 1)), (2048, (8, 1)), (2056, (6, 2)),
    (3072, (6, 2)), (3080, (8, 2)), (4096, (8, 2)), (4104, (8, 4)),
    (8192, (8, 4)), (1540, None), (8200, None), (12, None)])
def test_layer_norm_form_by_width(c, form):
    """Which LayerNorm kernel form each width takes, bf16 and w8a8 (the row
    in registers):
    one warp a row and 4 vectors of 8 a lane up to 1024, one warp and 6 or
    8 vectors up to 2048, two warps and 6 or 8 vectors up to 4096, four
    warps and 8 vectors up to ``MAX_LONG_WIDTH``; refused above that and at
    C % 8 != 0, where
    ``_check_rows`` refuses too (the entries of both LayerNorms)."""
    bf = torch.bfloat16
    x = torch.zeros((2, c), dtype=bf)
    wb = (torch.zeros(c), torch.zeros(c))
    if form is None:
        with pytest.raises(ValueError, match="ROADMAP.md"):
            fb.layer_norm_form(c)
        with pytest.raises(ValueError, match="ROADMAP.md"):
            fb._check_rows(x, *wb)
        return
    vec, warps = fb.layer_norm_form(c)
    assert (vec, warps) == form
    assert 256 * vec * warps >= c
    assert fb._check_rows(x, *wb) == (2, c)


@pytest.mark.parametrize("c", [1032, 2056, 3072])
def test_layer_norm_entries_run_plain_versions_at_every_form(c):
    """The LayerNorm entries on CPU tensors at widths of the wider forms
    (one warp and 6 vectors, two warps): ``_ln`` rounded to bf16, and
    ``quantize_rows`` of it."""
    rs = np.random.default_rng(c)
    x = torch.from_numpy(rs.standard_normal((5, c)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(1.0 + 0.1 * rs.standard_normal(c).astype(
        np.float32))
    b = torch.from_numpy(0.1 * rs.standard_normal(c).astype(np.float32))
    assert torch.equal(fb.layer_norm(x, w, b), fb._ln(x, w, b).to(x.dtype))
    codes, scale = fb.ln_quant(x, w, b)
    want_c, want_s = fb.quantize_rows(fb._ln(x, w, b))
    assert torch.equal(codes, want_c) and torch.equal(scale, want_s)


def test_new_limits_and_refusals():
    """The long route stops at ``MAX_LONG_TOKENS``, the wide rows at
    ``MAX_LONG_WIDTH``; past them every check raises ``ValueError`` naming
    ROADMAP.md, and a route that is not one raises too."""
    assert fb.MAX_LONG_TOKENS >= 4096 and fb.MAX_LONG_WIDTH >= 8192
    for plan in (fb.attention_plan, fb.attention_q8_plan):
        with pytest.raises(ValueError, match="ROADMAP.md"):
            plan(4, fb.MAX_LONG_TOKENS + 1, 12)
        with pytest.raises(ValueError, match="route"):
            plan(4, 12, 12, route="medium")
    with pytest.raises(ValueError, match="tokens"):
        fb.attention_plan(4, fb.MAX_TOKENS + 1, 12, route="short")
    bf = torch.bfloat16
    assert fb._check_x(torch.zeros((2, 768, 768), dtype=bf), 12, 64) == \
        (2, 768, 768)
    assert fb._check_x(torch.zeros((2, 12, 1536), dtype=bf), 24, 128) == \
        (2, 12, 1536)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        fb._check_x(torch.zeros((1, 2, fb.MAX_LONG_WIDTH + 128), dtype=bf),
                    (fb.MAX_LONG_WIDTH + 128) // 64, 128)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        fb._check_x(torch.zeros((1, fb.MAX_LONG_TOKENS + 1, 64), dtype=bf),
                    1, 64)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        fa._check_tokens(1, fb.MAX_LONG_TOKENS + 1)
    fa._check_tokens(65535, fb.MAX_LONG_TOKENS)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        fb._check_rows(torch.zeros((2, fb.MAX_LONG_WIDTH + 8), dtype=bf),
                       torch.zeros(fb.MAX_LONG_WIDTH + 8),
                       torch.zeros(fb.MAX_LONG_WIDTH + 8))


def test_layer_norm_entries_run_their_plain_versions_on_the_cpu():
    """The LayerNorm kernels' entries on CPU tensors: ``_ln`` rounded to
    the activation dtype, and ``quantize_rows`` of it (dynamic and
    static), at a row wider than ``MAX_WIDTH``."""
    rs = np.random.default_rng(5)
    x = torch.from_numpy(rs.standard_normal((6, 1536)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(1.0 + 0.1 * rs.standard_normal(1536).astype(
        np.float32))
    b = torch.from_numpy(0.1 * rs.standard_normal(1536).astype(np.float32))
    assert torch.equal(fb.layer_norm(x, w, b), fb._ln(x, w, b).to(x.dtype))
    codes, scale = fb.ln_quant(x, w, b)
    want_c, want_s = fb.quantize_rows(fb._ln(x, w, b))
    assert torch.equal(codes, want_c) and torch.equal(scale, want_s)
    codes, scale = fb.ln_quant(x, w, b, torch.tensor([0.05]))
    assert torch.equal(codes, fb.quantize_rows(fb._ln(x, w, b),
                                               torch.tensor(0.05))[0])
