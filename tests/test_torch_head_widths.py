"""Heads of width 32 and 128 through every kernel's plain version of the
PyTorch port, against the JAX package's Pallas kernels in interpret mode
(as its own tests run them), on the CPU, on the same numpy inputs; the
launch plans of both attention cores at their three instance widths
(32, 64, 128), and the widths they refuse; and whole models of 4 heads of 32
(the root ``eval.py``'s smoke model) and 2 heads of 128 against the JAX
package's forward.

Small sizes: 2 heads (C = 2·d), MLP 4C, B 3 (odd, so the JAX kernels'
batch tile of 2 pads), N 12, 13 and 48.

Tolerances, relative to max|JAX| unless said otherwise, each the bound of
the test file that holds the same function at width 64:
* bf16 block and chain, float32: 1e-5 (``test_torch_fused_block.py``);
  bf16 compute: 2e-2 (``test_torch_variants.py``).
* w8a8 blocks and chains, with and without the int8 attention, float32:
  5e-3, the bound of ``test_torch_quant_attn.py``, which holds the same
  plain versions to the same interpret-mode kernels (an int8 code on a
  rounding boundary can flip and move its row by one quant step; seen here
  1.1e-3 at width 32).
* the training block's five outputs, float32: 2e-6
  (``test_torch_train_block.py``).
* K6's output: 1e-5; its bf16 probabilities within one bf16 ulp and at
  least 99.9% bit-equal (``test_torch_attention.py``); K7 and K8: 1e-5
  in float32, 2e-2 in bf16 (``test_torch_attention_qkv.py``).
* whole models: 1e-5 in float32 (``test_torch_variants.py``).
* the bf16 q scaling: bit-equal (JAX multiplies a bf16 q by d^-½ rounded
  to bf16, a weakly typed Python float taking the array's dtype; at widths
  32 and 128 that factor is not the float32 one).
"""

import dataclasses
import functools

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

WIDTHS = [32, 128]
HEADS, B = 2, 3
DENSE = (2, 5, 9, 11)  # dense kernels of the 13-tuple: (in, out) in JAX
TOL = 1e-5
BF16_TOL = 2e-2
CHAIN_TOL = 5e-3
TRAIN_TOL = 2e-6
BF16_ULP = 2 ** -7


def _params(rs, n, d, dtype=np.float32):
    """One block's 13-tuple at head width ``d`` in the JAX layout,
    LayerNorm and bias in float32, the rest in ``dtype``."""
    c = HEADS * d
    r = lambda *shape, s=0.05: (rs.standard_normal(shape) * s).astype(
        np.float32)
    p = (1.0 + r(c), r(c), r(c, 3 * c), r(3 * c), r(HEADS, n, n, s=0.5),
         r(c, c), r(c), 1.0 + r(c), r(c), r(c, 4 * c), r(4 * c),
         r(4 * c, c), r(c))
    return tuple(a if i in (0, 1, 4, 7, 8) else a.astype(dtype)
                 for i, a in enumerate(p))


def _port(p):
    """JAX layout → port layout (dense kernels (out, in)), same dtypes."""
    out = []
    for i, a in enumerate(p):
        t = torch.from_numpy(np.ascontiguousarray(
            np.asarray(a, np.float32).T if i in DENSE
            else np.asarray(a, np.float32)))
        out.append(t.to(torch.bfloat16) if a.dtype != np.float32 else t)
    return tuple(out)


def _jax(p):
    return tuple(jnp.asarray(a) for a in p)


def _x(rs, n, d, dtype=np.float32):
    x = rs.standard_normal((B, n, HEADS * d)).astype(np.float32)
    xt = torch.from_numpy(x)
    if dtype != np.float32:
        return jnp.asarray(x).astype(dtype), xt.to(torch.bfloat16)
    return jnp.asarray(x), xt


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------ q scaling

@pytest.mark.parametrize("d", [32, 64, 128])
def test_bf16_q_scaling_is_jax_weakly_typed(d):
    """A bf16 q times d^-½: the port's factor (``q_scale``, which the
    CUDA cores take too) gives JAX's products bit for bit; the float32
    factor would not at widths 32 and 128."""
    rs = np.random.default_rng(d)
    q = rs.standard_normal(4096).astype(np.float32)
    want = _f32(jnp.asarray(q).astype(jnp.bfloat16) * d ** -0.5)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    got = _f32(qt * fb.q_scale(d, torch.bfloat16))
    np.testing.assert_array_equal(got, want)
    plain = _f32(qt * d ** -0.5)
    assert (plain != want).any() == (d != 64)
    assert fb.q_scale(d, torch.float32) == float(np.float32(d ** -0.5))


# ------------------------------------------------------- bf16 block path

@pytest.mark.parametrize("n", [13, 48])
@pytest.mark.parametrize("d", WIDTHS)
def test_block_matches_pallas(d, n):
    rs = np.random.default_rng(d + n)
    p = _params(rs, n, d)
    x, xt = _x(rs, n, d)
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
    torch.testing.assert_close(
        fb.fused_block_chain(xt, [_port(p) for p in plist], HEADS), got,
        rtol=0, atol=0)


@pytest.mark.parametrize("d", WIDTHS)
def test_bf16_block_matches_pallas(d):
    """bf16 activations and weights, as the model serves: q scaled by the
    bf16 factor on both sides."""
    n = 48
    rs = np.random.default_rng(d + 2)
    p = _params(rs, n, d, jnp.bfloat16)
    x, xt = _x(rs, n, d, jnp.bfloat16)
    want = jfb.fused_block(x, _jax(p), heads=HEADS, block_b=2,
                           interpret=True)
    got = fb.block_ref(xt, _port(p), HEADS)
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) <= BF16_TOL


# ------------------------------------------------------------ w8a8 path

Q8_MODES = {"dynamic": (False, False), "static": (True, False),
            "attn": (False, True), "static-attn": (True, True)}


def _qparams(p, x, static):
    """The w8a8 tuple in each package; with ``static``, 18 entries whose
    scales come from the JAX calibration on ``x`` (as
    ``test_torch_quant_attn.py``)."""
    amax = None
    if static:
        amax = jax.jit(functools.partial(
            jfb.block_act_amax, heads=HEADS, exact_gelu=False))(
                x, _jax(p))[1]
    qp_j = jax.jit(jfb.quantize_block_params)(_jax(p), amax)
    amax_t = torch.from_numpy(np.array(amax)) if static else None
    return qp_j, fb.quantize_block_params(_port(p), amax_t)


@pytest.mark.parametrize("mode", list(Q8_MODES))
@pytest.mark.parametrize("d", WIDTHS)
def test_q8_block_matches_pallas(d, mode):
    static, quant_attn = Q8_MODES[mode]
    n = 49 if quant_attn else 48
    rs = np.random.default_rng(d + 3)
    p = _params(rs, n, d)
    x, xt = _x(rs, n, d)
    qp_j, qp_t = _qparams(p, x, static)
    want = jfb.fused_block(x, qp_j, heads=HEADS, interpret=True, quant=True,
                           quant_attn=quant_attn)
    got = fb.block_ref_q8(xt, qp_t, HEADS, quant_attn=quant_attn)
    assert _rel(got, want) <= CHAIN_TOL
    torch.testing.assert_close(
        fb.fused_block_q8(xt, qp_t, HEADS, quant_attn=quant_attn), got,
        rtol=0, atol=0)


@pytest.mark.parametrize("mode", list(Q8_MODES))
@pytest.mark.parametrize("d", WIDTHS)
def test_q8_chain_matches_pallas(d, mode):
    """Two w8a8 blocks at N 13, each calibrated on its own input when
    static, against the JAX chain kernel."""
    static, quant_attn = Q8_MODES[mode]
    n = 13
    rs = np.random.default_rng(d + 4)
    ps = [_params(rs, n, d) for _ in range(2)]
    x, xt = _x(rs, n, d)
    h, qps_j, qps_t = x, [], []
    for p in ps:
        qp_j, qp_t = _qparams(p, h, static)
        qps_j.append(qp_j)
        qps_t.append(qp_t)
        h = jnp.asarray(fb.block_ref_q8(torch.from_numpy(np.array(h)),
                                        qp_t, HEADS,
                                        quant_attn=quant_attn).numpy())
    want = jfb.fused_block_chain(x, tuple(qps_j), heads=HEADS,
                                 interpret=True, quant=True,
                                 quant_attn=quant_attn)
    got = fb.chain_ref_q8(xt, qps_t, HEADS, quant_attn=quant_attn)
    assert _rel(got, want) <= CHAIN_TOL
    torch.testing.assert_close(
        fb.fused_block_chain_q8(xt, qps_t, HEADS, quant_attn=quant_attn),
        got, rtol=0, atol=0)


# ---------------------------------------------------- training block (K5)

@pytest.mark.parametrize("n", [12, 13])
@pytest.mark.parametrize("d", WIDTHS)
def test_block_train_ref_matches_jax(d, n):
    """K5's plain version against ``_fused_block_train_forward`` in
    interpret mode: the output and the four saved residuals."""
    rs = np.random.default_rng(d + n + 5)
    p = _params(rs, n, d)
    x, xt = _x(rs, n, d)
    out, (qkv, probs, gin, r) = jax.jit(
        lambda x, p: jfb._fused_block_train_forward(
            x, p, HEADS, False, 2, True))(x, _jax(p))
    probs = _f32(probs).reshape(B, n, HEADS, n).transpose(0, 2, 1, 3)
    got_out, got = fb.block_train_ref(xt, _port(p), HEADS)
    for name, g, w in zip(("out", "qkv", "probs", "gin", "r"),
                          (got_out, *got), (out, qkv, probs, gin, r)):
        assert tuple(g.shape) == tuple(w.shape), name
        assert _rel(g, w) <= TRAIN_TOL, (name, _rel(g, w))
    torch.testing.assert_close(fb.fused_block_train(xt, _port(p), HEADS)[0],
                               got_out, rtol=0, atol=0)


# ------------------------------------------------ attention (K6, K7, K8)

def _qkv(n, d, seed):
    rs = np.random.default_rng(seed)
    c = HEADS * d
    qkv = rs.standard_normal((B, n, 3 * c)).astype(np.float32)
    bias = (rs.standard_normal((HEADS, n, n)) * 0.5).astype(np.float32)
    return qkv, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", WIDTHS)
def test_attention_probs_matches_pallas(d, dtype):
    n = 48
    qkv, bias = _qkv(n, d, d)
    j_out, j_probs = jfa._fused_qkv_probs_forward(
        jnp.asarray(qkv).astype(dtype), jnp.asarray(bias), HEADS, 8, True)
    t_out, t_probs = fa.attention_probs_ref(
        torch.from_numpy(qkv).to(getattr(torch, dtype)),
        torch.from_numpy(bias), HEADS)
    tol = TOL if dtype == "float32" else 2 ** -8
    assert _rel(t_out, j_out) <= tol
    got, want = _f32(t_probs), _f32(j_probs)
    np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-12)
    assert (got == want).mean() >= 0.999


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", WIDTHS)
def test_attention_qkv_matches_pallas(d, dtype):
    n = 13
    qkv, bias = _qkv(n, d, d + 1)
    want = jfa.fused_attention_qkv(jnp.asarray(qkv).astype(dtype),
                                   jnp.asarray(bias), HEADS, interpret=True)
    got = fa.attention_qkv_ref(torch.from_numpy(qkv).to(
        getattr(torch, dtype)), torch.from_numpy(bias), HEADS)
    assert tuple(got.shape) == (B, n, HEADS * d)
    assert _rel(got, want) <= (TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", WIDTHS)
def test_attention_bnhd_matches_pallas(d, dtype):
    n = 12
    qkv, bias = _qkv(n, d, d + 2)
    q, k, v = (qkv[..., i * HEADS * d : (i + 1) * HEADS * d].reshape(
        B, n, HEADS, d) for i in range(3))
    want = jfa.fused_attention(*(jnp.asarray(t).astype(dtype)
                                 for t in (q, k, v)),
                               jnp.asarray(bias), interpret=True)
    got = fa.attention_bnhd_ref(*(torch.from_numpy(np.ascontiguousarray(
        t)).to(getattr(torch, dtype)) for t in (q, k, v)),
        torch.from_numpy(bias))
    assert tuple(got.shape) == (B, n, HEADS, d)
    assert _rel(got, want) <= (TOL if dtype == "float32" else BF16_TOL)


# ---------------------------------------------------------------- plans

PLAN_BATCHES = (1, 240, 1024, 2048)


@pytest.mark.parametrize("d", fb.SHORT_CORE_WIDTHS)
def test_attention_plans_fit_the_card(d):
    """Both cores' plans at every N of 1..256 and B up to 2048: the shared
    bytes the C side computes (``attn_smem_bytes``, ``attn_q8_layout``),
    within one CTA's opt-in, rows an odd multiple of 16 bytes apart
    (conflict-free ldmatrix), at least one CTA an SM, within the launch
    bound's warps and the grid's limits."""
    assert (fb.attn_row_bytes(d) // 16) % 2 == 1
    assert ((d + 16) // 16) % 2 == 1  # K4a's k-code rows
    for n in range(1, fb.MAX_TOKENS + 1):
        for b in PLAN_BATCHES:
            plan = fb.attention_plan(b, n, 6, head_dim=d)
            bucket, warps, samples, smem = plan["ints"]
            assert bucket in fb.ATTN_KEY_TILE_BUCKETS and bucket * 16 >= n
            assert smem == 2 * -(-n // 16) * 16 * (d + 8) * 2
            assert smem <= fb.CTA_SHARED_MAX and plan["ctas_per_sm"] >= 1
            assert warps <= fb.ATTN_MAX_WARPS[d]
            assert plan["grid"] == (6, -(-b // samples))
            assert plan["grid"][1] <= fb.MAX_GRID_Y

            q8 = fb.attention_q8_plan(b, n, 6, head_dim=d)
            bucket, warps, samples, smem = q8["ints"]
            np_ = -(-n // 32) * 32
            assert bucket in fb.ATTN_Q8_STEP_BUCKETS and bucket * 32 >= n
            assert smem == (np_ * (d + 16) + d * (np_ + 16) + np_ * 4
                            + d * 4 + 8 * 32 * 8 * 4)
            assert smem <= fb.CTA_SHARED_MAX and q8["ctas_per_sm"] >= 1
            assert warps % 2 == 0 and warps <= fb.ATTN_Q8_MAX_WARPS
            assert q8["grid"] == (6, -(-b // samples))


@pytest.mark.parametrize("d", fb.CORE_WIDTHS)
def test_block_plans_carry_the_head_width(d):
    """A block's plan holds its core's plan at the block's head width: the
    width comes from C and the heads, as the C entry points derive it."""
    c, heads, b, n = 768, 768 // d, 1024, 193
    assert fb.block_plan(b, n, c, heads, 4 * c)[:4] == fb.attention_plan(
        b, n, heads, head_dim=d)["ints"]
    for quant_attn, core in ((False, fb.attention_plan),
                             (True, fb.attention_q8_plan)):
        ints = fb.block_plan_q8(b, n, c, heads, 4 * c, quant_attn)
        assert ints[:4] == core(b, n, heads, head_dim=d)["ints"]


@pytest.mark.parametrize("d", [8200, 20, 4])
def test_other_widths_raise(d):
    """A width above 8192 raises ``ValueError`` naming ROADMAP.md, from
    the plans and from the checks every CUDA entry point runs; there is no
    fallback. Widths that are no multiple of 8 (20 and 4), refused before
    the zero-padded layouts, pass every check now, and their plans are
    those of the layout's width round_up(d, 8)."""
    heads = 4
    c = heads * d
    x = torch.zeros((2, 12, c), dtype=torch.bfloat16)
    qkv = torch.zeros((2, 12, 3 * c), dtype=torch.bfloat16)
    q = torch.zeros((2, 12, heads, d), dtype=torch.bfloat16)
    bias = torch.zeros((heads, 12, 12))
    if d > fb.MAX_HEAD_DIM:
        with pytest.raises(ValueError, match="ROADMAP.md"):
            fb.check_head_dim(c, heads)
        for plan in (fb.attention_plan, fb.attention_q8_plan):
            with pytest.raises(ValueError, match="ROADMAP.md"):
                plan(1024, 192, heads, head_dim=d)
        for align in (fb.GEMM_K_ALIGN, fb.Q8_K_ALIGN):
            with pytest.raises(ValueError, match="ROADMAP.md"):
                fb._check_x(x, heads, align)
        with pytest.raises(ValueError, match="ROADMAP.md"):
            fa._check_cuda(qkv, bias, heads)
        with pytest.raises(ValueError, match="ROADMAP.md"):
            fa._check_cuda_bnhd(q, q, q, bias)
        return
    assert fb.check_head_dim(c, heads) == d
    dp = -(-d // 8) * 8
    for plan in (fb.attention_plan, fb.attention_q8_plan):
        got = plan(1024, 192, heads, head_dim=d)
        assert got["ints"] == plan(1024, 192, heads, head_dim=dp)["ints"]
        assert (got["head_dim"], got["core_width"]) == (d, 32)
    for align in (fb.GEMM_K_ALIGN, fb.Q8_K_ALIGN):
        assert fb._check_x(x, heads, align) == (2, 12, c)
    assert fa._check_cuda(qkv, bias, heads) == (2, 12, c, d)
    assert fa._check_cuda_bnhd(q, q, q, bias) == (2, 12, heads, d)


def test_checks_separate_width_from_alignment():
    """The head width and the GEMMs' K rows are separate conditions: 4
    heads of 32 in C 128 pass both the bf16 (C % 8) and the w8a8 (C % 16)
    alignment as they are; 5 heads of 8 in C 40 pass the bf16 one as they
    are, and w8a8 runs them on the zero-padded layout of C' 48 with heads
    of 16 lanes (A 80), which the w8a8 GEMMs read."""
    x = torch.zeros((2, 12, 128), dtype=torch.bfloat16)
    assert fb._check_x(x, 4, fb.GEMM_K_ALIGN) == (2, 12, 128)
    assert fb._check_x(x, 4, fb.Q8_K_ALIGN) == (2, 12, 128)
    assert fb.padded_widths(128, 4, 512, int8=True).aligned
    x40 = torch.zeros((2, 12, 40), dtype=torch.bfloat16)
    assert fb._check_x(x40, 5, fb.GEMM_K_ALIGN) == (2, 12, 40)
    assert fb.padded_widths(40, 5, 160).aligned
    assert fb._check_x(x40, 5, fb.Q8_K_ALIGN) == (2, 12, 40)
    lay = fb.padded_widths(40, 5, 160, int8=True)
    assert (lay.c_pad, lay.d_pad, lay.a, lay.hidden_pad) == (48, 16, 80, 160)


# ---------------------------------------------------------- whole models

MODELS = {
    # the root eval.py's smoke model: embed 128, 4 heads of 32
    "4x32": dict(embed_dim=128, num_heads=4, depth=(2, 1, 1)),
    "2x128": dict(embed_dim=256, num_heads=2, depth=(2, 1, 1)),
}


@pytest.mark.parametrize("model", list(MODELS))
def test_model_matches_jax(model):
    """The port's ``S2Former`` (the block kernels' plain versions) against
    the JAX ``build_model`` forward (its Pallas kernels in interpret mode)
    on ``state_dict_from_flax`` weights, float32, at the root scales 32,
    64 and 128."""
    kw = dict(MODELS[model], out_dim=16, dtype="float32")
    mcfg, jcfg = ModelConfig(**kw), JaxModelConfig(**kw)
    jmodel = build_model(jcfg)
    variables = jax.tree.map(np.asarray,
                             init_params(jmodel, jax.random.key(0)))
    rs = np.random.default_rng(7)
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
    assert dataclasses.asdict(mcfg)["num_heads"] == kw["num_heads"]
    assert got.shape == want.shape == (2, 16)
    assert _rel(got, want) <= TOL
