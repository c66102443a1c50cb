"""Launch plans, wrapper checks and plain versions of the w8a8 kernels
redesigned for Hopper: K4's s8 GEMM (``gemm_q8``, csrc/wgmma_gemm.cuh in
s8) and K4a's int8 attention core (``attention_q8``), on the CPU.

The plans are held to an H100's limits at every shape the S2Former family
launches (v3's 192/48/12 tokens, v5's 193/49/13, v1's 256) and at the M of
the slice (B 1024) and of the serving walk (B 2048); the C entry points
refuse any other plan. The plain versions are held to the JAX package on
the same seeded inputs: the GEMM's epilogues against ``_qdot`` /
``_qdot_static`` plus the bias, the residual or the GELU, bit for bit as
``tests/test_torch_quant.py`` holds ``_qdot`` (the s32 sums are exact and
every rounding is at the same point), except the float32 GELU, whose
``tanh`` may differ in the last bit between the two libraries (held to
1e-6 of max|JAX|; its codes on inputs whose GELU outputs sit away from a
rounding boundary are equal); the core against ``_attn_inner_q8`` /
``_attn_inner_q8s`` within 1e-5 of max|JAX|, the bound of
``tests/test_torch_quant_attn.py``, but for the rare (token, head) row
where ``exp`` differs in the last bit between the two libraries and moves
a probability code rint(127·e) that sits on a rounding boundary by one:
at most one row in a thousand (one of 2316 at N 193 with static scales),
each within 2e-2 of max|JAX| (5.0e-3 seen), one code's share of the row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu.ops.pallas import fused_block as jfb
from deepmerge_tpu_torch.ops.kernels import fused_block as fb

SHAPES = [12, 13, 48, 49, 192, 193, 256]
C, HEADS, HIDDEN = 768, 12, 3072
GELU_TOL = 1e-6
ATTN_TOL = 1e-5
FLIPPED_ROWS_MAX = 1e-3
FLIPPED_ROW_TOL = 2e-2


# ------------------------------------------------------------ plans

@pytest.mark.parametrize("b", [1024, 2048])
@pytest.mark.parametrize("n", SHAPES)
def test_gemm_q8_plan_fits_the_card(n, b):
    m = b * n
    for rows, depth in ((3 * C, C), (C, C), (HIDDEN, C), (C, HIDDEN)):
        plan = fb.gemm_q8_plan(m, rows, depth)
        bm, bn, bk, stages, threads, smem = plan["ints"]
        assert (bm, bn, bk, threads) == (128, 256, 128, 2 * 128 + 32)
        # K2's ring: A and W slabs of 128-byte rows, the same bytes a stage
        assert plan["ints"] == fb.gemm_plan(m, rows, depth)["ints"][:2] + (
            bk,) + fb.gemm_plan(m, rows, depth)["ints"][3:]
        # the ring, 1 KB of alignment room for the swizzle, a full and an
        # empty barrier a stage
        assert smem == stages * (bm + bn) * bk + 1024 + 2 * stages * 8
        assert smem <= fb.CTA_SHARED_MAX and plan["ctas_per_sm"] == 1
        # TMA: row strides (K bytes) and boxes on 16 bytes, whole K slabs
        assert depth % bk == 0 and rows % 8 == 0
        assert plan["tiles"] == -(-rows // bn) * -(-m // bm)


@pytest.mark.parametrize("b", [1024, 2048, 240, 1])
@pytest.mark.parametrize("n", SHAPES)
def test_attention_q8_plan_fits_the_card(n, b):
    plan = fb.attention_q8_plan(b, n, HEADS)
    bucket, warps, samples, smem = plan["ints"]
    assert bucket in fb.ATTN_Q8_STEP_BUCKETS
    assert bucket * 32 >= n and plan["steps"] == -(-n // 32)
    np_ = plan["steps"] * 32
    # k codes in 80-byte rows, v transposed (rows of np + 16 bytes), the
    # scales and 32 partial abs-maxes of 64 lanes (eight threads each)
    assert smem == np_ * 80 + 64 * (np_ + 16) + np_ * 4 + 256 + 32 * 256
    assert (np_ + 16) % 32 == 16  # an odd multiple of 16: no conflicts
    assert smem <= 48 * 1024 and warps % 2 == 0 and warps <= 8
    assert plan["ctas_per_sm"] >= 3
    assert plan["grid"] == (HEADS, -(-b // samples))
    assert plan["grid"][1] * samples >= b


@pytest.mark.parametrize("quant_attn", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("n", SHAPES)
def test_block_plan_q8_holds_each_gemm(n, quant_attn):
    b = 1024
    ints = fb.block_plan_q8(b, n, C, HEADS, HIDDEN, quant_attn)
    core = fb.attention_q8_plan if quant_attn else fb.attention_plan
    assert ints[:4] == core(b, n, HEADS)["ints"]
    gemms = [ints[4 + 6 * i: 10 + 6 * i] for i in range(4)]
    assert len(ints) == 4 + 4 * 6
    for got, (rows, depth) in zip(gemms, ((3 * C, C), (C, C), (HIDDEN, C),
                                          (C, HIDDEN))):
        assert got == fb.gemm_q8_plan(b * n, rows, depth)["ints"]


@pytest.mark.parametrize("m,n,k", [(256, 768, 40), (256, 768, 200),
                                   (256, 12, 768), (0, 768, 768),
                                   (256, 768, 0)])
def test_gemm_q8_plan_refuses(m, n, k):
    """K's rows must be a multiple of 16 bytes (K % 16 in int8; a K tail
    past the last 128-wide slab is taken) and N a multiple of 8."""
    with pytest.raises(ValueError, match="K % 16"):
        fb.gemm_q8_plan(m, n, k)


@pytest.mark.parametrize("kwargs,match", [
    (dict(b=4, n=0, heads=2), "tokens"),
    # past the long route (N > 256 takes it; the short core's limit is
    # held by the forced short route in test_torch_long_shapes.py)
    (dict(b=4, n=fb.MAX_LONG_TOKENS + 1, heads=2), "tokens"),
    (dict(b=4, n=12, heads=2, warps=0), "warps"),
    (dict(b=4, n=12, heads=2, warps=3), "warps"),
    (dict(b=4, n=12, heads=2, warps=10), "warps"),
    (dict(b=4, n=12, heads=2, samples=0), "samples"),
    (dict(b=70_000, n=12, heads=2, samples=1), "grid"),
])
def test_attention_q8_plan_refuses(kwargs, match):
    with pytest.raises(ValueError, match=match):
        fb.attention_q8_plan(**kwargs)


# --------------------------------------------------- wrapper checks

def _gemm_args(m=64, n=256, k=128):
    i8, f32, bf = torch.int8, torch.float32, torch.bfloat16
    return dict(a=torch.zeros((m, k), dtype=i8),
                w=torch.zeros((n, k), dtype=i8),
                w_scale=torch.ones((n,), dtype=f32),
                bias=torch.zeros((n,), dtype=bf))


@pytest.mark.parametrize("epilogue", fb.GEMM_Q8_EPILOGUES)
def test_gemm_q8_checks_take_what_the_kernel_takes(epilogue):
    kw = _gemm_args()
    extra = dict(row_scale=torch.ones((64,), dtype=torch.float32))
    if epilogue == "bias_residual":
        extra["resid"] = torch.zeros((64, 256), dtype=torch.bfloat16)
    if epilogue == "bias_gelu_codes":
        extra["out_scale"] = torch.ones((1,), dtype=torch.float32)
    m, n, k, plan = fb._check_gemm_q8(epilogue=epilogue, static_scale=None,
                                      **{**dict(resid=None, out_scale=None),
                                         **kw, **extra})
    assert (m, n, k) == (64, 256, 128) and plan["tiles"] == 1


@pytest.mark.parametrize("change,error,match", [
    (dict(a=torch.zeros((64, 128), dtype=torch.uint8)), TypeError, "int8"),
    (dict(w=torch.zeros((256, 128), dtype=torch.bfloat16)), TypeError,
     "int8"),
    (dict(w_scale=torch.ones((256,), dtype=torch.bfloat16)), TypeError,
     "float32"),
    (dict(bias=torch.zeros((256,), dtype=torch.float32)), TypeError,
     "bfloat16"),
    (dict(row_scale=torch.ones((63,), dtype=torch.float32)), TypeError,
     r"\(64,\)"),
    (dict(a=torch.zeros((64, 104), dtype=torch.int8),
          w=torch.zeros((256, 104), dtype=torch.int8)), ValueError, "K % 16"),
    (dict(w=torch.zeros((12, 128), dtype=torch.int8),
          w_scale=torch.ones((12,)), bias=torch.zeros((12,), dtype=torch.bfloat16)),
     ValueError, "N % 8"),
    (dict(a=torch.zeros((64, 256), dtype=torch.int8)), ValueError, "a \\(M, K\\)"),
    (dict(a=torch.zeros((64 * 128 + 1,), dtype=torch.int8)[1:].view(64, 128)),
     TypeError, "16-byte"),
    (dict(a=torch.zeros((128, 64), dtype=torch.int8).t()), TypeError,
     "contiguous"),
    (dict(static_scale=torch.ones((1,), dtype=torch.float32)), ValueError,
     "one of row_scale"),
    (dict(row_scale=None), ValueError, "one of row_scale"),
    (dict(epilogue="bias_relu"), ValueError, "epilogue"),
    (dict(epilogue="bias_residual"), ValueError, "residual"),
    (dict(resid=torch.zeros((64, 256), dtype=torch.bfloat16)), ValueError,
     "residual"),
    (dict(epilogue="bias_gelu_codes"), ValueError, "out_scale"),
    (dict(out_scale=torch.ones((1,))), ValueError, "out_scale"),
])
def test_gemm_q8_checks_refuse(change, error, match):
    kw = dict(_gemm_args(), epilogue="bias_cast",
              row_scale=torch.ones((64,), dtype=torch.float32),
              static_scale=None, resid=None, out_scale=None)
    kw.update(change)
    with pytest.raises(error, match=match):
        fb._check_gemm_q8(**kw)


def test_kernels_refuse_a_meta_device():
    """Any device but the CPU (the plain version) and CUDA (the kernel)
    raises."""
    kw = {k: v.to("meta") for k, v in _gemm_args().items()}
    with pytest.raises(ValueError, match="device"):
        fb.gemm_q8(**kw, epilogue="bias_cast",
                   row_scale=torch.ones((64,), device="meta"))
    qkv = torch.zeros((2, 12, 3 * 128), device="meta")
    with pytest.raises(ValueError, match="device"):
        fb.attention_q8(qkv, torch.zeros((2, 12, 12), device="meta"), 2)


# ---------------------------------------------- plain versions vs JAX

def _gemm_inputs(rs, m, k, n):
    """Seeded float32 activations (row 0 all zero) whose codes sit away
    from rounding boundaries, and a weight in the JAX layout."""
    s = np.exp(rs.uniform(-4, 0, (m, 1))).astype(np.float32)
    codes = rs.integers(-120, 121, (m, k)).astype(np.float32)
    y = ((codes + rs.uniform(-0.3, 0.3, (m, k))) * s).astype(np.float32)
    y[:, 0] = 127 * s[:, 0]
    y[0] = 0
    w = (rs.standard_normal((k, n)) * 0.05).astype(np.float32)
    return y, w


def _port_operands(y, wq, sw, static=None):
    """The port's operands of one GEMM: the activation's codes and scale
    (``quantize_rows``) and the weight in nn.Linear's layout."""
    a, s = fb.quantize_rows(torch.from_numpy(y), static)
    wt = torch.from_numpy(np.asarray(wq).T.copy())
    return a, s, wt, torch.from_numpy(np.array(sw))


@pytest.mark.parametrize("epilogue", ["bias_cast", "bias_residual",
                                      "bias_gelu", "acc"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_gemm_q8_cpu_matches_jax_qdot(epilogue, static):
    """``gemm_q8`` on CPU tensors against the JAX package's ``_qdot`` /
    ``_qdot_static`` with the block's epilogue around it: bf16(bf16(dq) +
    b), resid + that, gelu_tanh(dq + b) in float32, and the s32 sums."""
    rs = np.random.default_rng(len(epilogue) + 10 * static)
    m, k, n = 40, 256, 96
    y, w = _gemm_inputs(rs, m, k, n)
    wq, sw = jax.jit(jfb.quantize_weight)(jnp.asarray(w))
    s = np.float32(0.011) if static else None
    if static:
        dq = jax.jit(jfb._qdot_static)(jnp.asarray(y), wq, sw, jnp.float32(s))
    else:
        dq = jax.jit(jfb._qdot)(jnp.asarray(y), wq, sw)
    bias = (rs.standard_normal(n) * 0.1).astype(np.float32)
    bias_bf = jnp.asarray(bias, jnp.bfloat16)
    resid = jnp.asarray(rs.standard_normal((m, n)), jnp.bfloat16)
    a, sr, wt, swt = _port_operands(y, wq, sw,
                                    torch.tensor(s) if static else None)
    scale = dict(static_scale=sr.reshape(1)) if static else dict(row_scale=sr)
    kw = dict(resid=torch.from_numpy(np.asarray(resid, np.float32)).to(
        torch.bfloat16)) if epilogue == "bias_residual" else {}
    got, aux = fb.gemm_q8(a, wt, swt, torch.from_numpy(bias).to(
        torch.bfloat16), epilogue, **scale, **kw)
    f32 = lambda t: np.asarray(t, np.float32)
    if epilogue == "acc":
        want = np.asarray(a, np.int64) @ np.asarray(wt, np.int64).T
        np.testing.assert_array_equal(got.numpy(), want)
        return
    if epilogue == "bias_gelu":
        want = jax.jit(lambda t: jax.nn.gelu(t + bias_bf.astype(jnp.float32),
                                             approximate=True))(dq)
        err = np.abs(got.numpy() - f32(want)).max() / np.abs(f32(want)).max()
        assert got.dtype == torch.float32 and err <= GELU_TOL
        np.testing.assert_array_equal(aux[0].numpy(),
                                      fb.quantize_rows(got)[0].numpy())
        return
    want = dq.astype(jnp.bfloat16) + bias_bf
    if epilogue == "bias_residual":
        want = resid + want
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), f32(want))


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_gemm_q8_gelu_codes_match_jax(static):
    """The GELU epilogue's int8 codes for the down GEMM: with dynamic
    scales (``bias_gelu``'s aux) and at a static scale
    (``bias_gelu_codes``), equal to the codes the JAX package's ``_qdot`` /
    ``_qdot_static`` takes of its GELU output, on outputs away from a
    rounding boundary."""
    rs = np.random.default_rng(5 + static)
    m, k, n = 48, 128, 64
    y, w = _gemm_inputs(rs, m, k, n)
    wq, sw = jax.jit(jfb.quantize_weight)(jnp.asarray(w))
    bias = jnp.asarray((rs.standard_normal(n) * 0.1).astype(np.float32),
                       jnp.bfloat16)
    h1 = np.asarray(jax.jit(lambda t: jax.nn.gelu(
        jfb._qdot(t, wq, sw) + bias.astype(jnp.float32),
        approximate=True))(jnp.asarray(y)))
    a, sr, wt, swt = _port_operands(y, wq, sw)
    b_t = torch.from_numpy(np.asarray(bias, np.float32)).to(torch.bfloat16)
    if static:
        s_out = np.float32(0.7 * np.abs(h1).max() / 127)
        want = np.clip(np.round(h1 * (np.float32(1) / s_out)), -127, 127)
        got, _ = fb.gemm_q8(a, wt, swt, b_t, "bias_gelu_codes",
                            row_scale=sr, out_scale=torch.tensor([s_out]))
        q = h1 * (np.float32(1) / s_out)
    else:
        amax = np.abs(h1).max(-1, keepdims=True)
        s_out = np.where(amax > 0, amax * (np.float32(1) / np.float32(127)), 1).astype(
            np.float32)
        want = np.clip(np.round(h1 / s_out), -127, 127)
        _, (got, scales) = fb.gemm_q8(a, wt, swt, b_t, "bias_gelu",
                                      row_scale=sr)
        np.testing.assert_allclose(scales.numpy(), s_out[:, 0], rtol=1e-6)
        q = h1 / s_out
    safe = np.abs(q - np.floor(q) - 0.5) > 1e-3  # away from a boundary
    assert safe.mean() > 0.99
    np.testing.assert_array_equal(got.numpy()[safe], want[safe])


def _attn_inputs(rs, n, heads=4, b=3):
    c = heads * 64
    qkv = (rs.standard_normal((b, n, 3 * c)) * 2.0).astype(np.float32)
    qkv[0, 1, :64] = 0.0  # a zero q row: scale 1, zero codes
    bias = (rs.standard_normal((heads, n, n)) * 0.5).astype(np.float32)
    return qkv, bias, heads, c


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("n", [12, 13, 49, 193])
def test_attention_q8_cpu_matches_jax(n, static):
    """``attention_q8`` on CPU tensors against the jitted
    ``_attn_inner_q8`` / ``_attn_inner_q8s`` (float32)."""
    rs = np.random.default_rng(n + 100 * static)
    qkv, bias, heads, c = _attn_inputs(rs, n)
    if static:
        s = tuple(np.float32(0.8 * np.abs(qkv[..., i * c:(i + 1) * c]).max()
                             / 127.0) for i in range(3))
        want = jax.jit(lambda t, b: jfb._attn_inner_q8s(
            t, b, heads=heads, dtype=jnp.float32, s_q=s[0], s_k=s[1],
            s_v=s[2]))(qkv, bias)
        st = torch.tensor(s)
    else:
        want = jax.jit(lambda t, b: jfb._attn_inner_q8(
            t, b, heads=heads, dtype=jnp.float32))(qkv, bias)
        st = None
    before = fb.attention_q8.launches
    got = fb.attention_q8(torch.from_numpy(qkv), torch.from_numpy(bias),
                          heads, static=st)
    assert fb.attention_q8.launches == before  # the plain version ran
    want = np.asarray(want)
    assert got.shape == (3, n, c) and got.dtype == torch.float32
    err = (np.abs(got.numpy() - want) / np.abs(want).max()).reshape(
        3, n, heads, 64).max(-1)
    # a (token, head) row whose exp differs in the last bit where 127·e
    # sits on a rounding boundary takes one probability code one apart
    assert (err > ATTN_TOL).mean() <= FLIPPED_ROWS_MAX
    assert err.max() <= FLIPPED_ROW_TOL


# ------------------------------ the GEMM's oracle composes the block

def _block(rs, n, c=128, heads=2, hidden=256):
    r = lambda *shape, s=0.05: torch.from_numpy(
        (rs.standard_normal(shape) * s).astype(np.float32))
    bf = torch.bfloat16
    params = (1.0 + r(c), r(c), r(3 * c, c).to(bf), r(3 * c).to(bf),
              r(heads, n, n, s=0.5), r(c, c).to(bf), r(c).to(bf),
              1.0 + r(c), r(c), r(hidden, c).to(bf), r(hidden).to(bf),
              r(c, hidden).to(bf), r(c).to(bf))
    x = torch.from_numpy(rs.standard_normal((3, n, c)).astype(np.float32))
    return x.to(bf), params, heads


@pytest.mark.parametrize("quant_attn", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("n", [12, 13])
def test_gemm_q8_ref_composes_the_plain_block(n, static, quant_attn):
    """The kernel's launch sequence on the plain versions: LN + quantize,
    ``gemm_q8_ref`` with each epilogue (the up GEMM's codes from
    ``bias_gelu``'s aux, or ``bias_gelu_codes`` with static scales) and the
    core (``attention_q8_ref`` or the bf16 one) give ``block_ref_q8`` bit
    for bit: the GEMM's and the core's oracles have the block's rounding
    points."""
    x, p, heads = _block(np.random.default_rng(n + 10 * static), n)
    amax = fb.block_act_amax(x, p, heads)[1] if static else None
    qp = fb.quantize_block_params(p, amax)
    (l1s, l1b, wq, sq, bq, bias, wp, sp, bp, l2s, l2b,
     wu, su, bu, wd, sd, bd) = qp[:17]
    s_act = qp[17] if static else None
    b, _, c = x.shape
    flat = lambda t: t.reshape(b * n, -1)

    def quant(t, i):
        codes, scale = fb.quantize_rows(t, None if s_act is None
                                        else s_act[i])
        if s_act is None:
            return codes, dict(row_scale=scale)
        return codes, dict(static_scale=scale.reshape(1))

    a, sc = quant(flat(fb._ln(x, l1s, l1b)), 0)
    qkv = fb.gemm_q8_ref(a, wq, sq, bq, "bias_cast", **sc)[0]
    qkv = qkv.reshape(b, n, 3 * c)
    if quant_attn:
        att = fb.attention_q8_ref(qkv, bias, heads,
                                  None if s_act is None else s_act[4:7])
    else:
        att = fb._attention(qkv, bias, heads)
    a, sc = quant(flat(att).float(), 1)
    r = fb.gemm_q8_ref(a, wp, sp, bp, "bias_residual", resid=flat(x),
                       **sc)[0]
    a, sc = quant(fb._ln(r, l2s, l2b), 2)
    if static:
        h, _ = fb.gemm_q8_ref(a, wu, su, bu, "bias_gelu_codes",
                              out_scale=s_act[3], **sc)
        hc = dict(static_scale=s_act[3].reshape(1))
    else:
        _, (h, scale) = fb.gemm_q8_ref(a, wu, su, bu, "bias_gelu", **sc)
        hc = dict(row_scale=scale)
    out = fb.gemm_q8_ref(h, wd, sd, bd, "bias_residual", resid=r, **hc)[0]
    want = fb.block_ref_q8(x, qp, heads, quant_attn=quant_attn)
    assert torch.equal(out.reshape(b, n, c), want)
