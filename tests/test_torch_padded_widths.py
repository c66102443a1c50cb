"""Heads of widths the attention cores run padded (16, 48, 80, 96: on the
instances of width 32, 64, 128 and 128) through every kernel's plain
version of the PyTorch port, against the JAX package's Pallas kernels in
interpret mode, on the CPU, on the same numpy inputs; the launch plans at
those widths (the core width each takes, shared bytes at the instance's
width), the GEMMs' K slabs at K tails, and the widths and alignments still
refused; whole models of 2 heads of 48 (C 96) and 2 of 80 (C 160, a K tail
of both GEMMs: 160 % 64 = 32, 160 % 128 = 32) against the JAX forward.

The JAX kernels take d from the array's shape (``_attn_inner``,
``_attn_inner_q8``), so they define the function at every width; the
port's CUDA cores run these widths padded on the card, which
``chip_smoke.py`` phase 3 holds against these same plain versions.

Inputs and tolerances are ``test_torch_head_widths.py``'s (2 heads, MLP
4C, B 3): relative to max|JAX|, float32 blocks and chains 1e-5, w8a8
blocks 5e-3, the training block's five outputs 2e-6, K6's output 1e-5 and
its bf16 probabilities within one bf16 ulp, K7 and K8 1e-5, whole models
1e-5. K4a's long route's plain version equals its short core's bit for
bit at every width, as at 32, 64 and 128.
"""

import dataclasses

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

WIDTHS = [16, 48, 80, 96]


# ------------------------------------------------------- bf16 block path

@pytest.mark.parametrize("d", WIDTHS)
def test_block_matches_pallas(d):
    n = 13
    rs = np.random.default_rng(d + 100)
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
    rs = np.random.default_rng(d + 101)
    plist = [_params(rs, n, d) for _ in range(2)]
    x, xt = _x(rs, n, d)
    want = jfb.fused_block_chain(x, tuple(_jax(p) for p in plist),
                                 heads=HEADS, block_b=2, interpret=True)
    got = fb.chain_ref(xt, [_port(p) for p in plist], HEADS)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL, atol=TOL)


# ------------------------------------------------------------ w8a8 path

@pytest.mark.parametrize("quant_attn", [False, True], ids=["bf16-attn",
                                                           "int8-attn"])
@pytest.mark.parametrize("d", WIDTHS)
def test_q8_block_matches_pallas(d, quant_attn):
    """The w8a8 block with dynamic scales, its attention bf16 (K4) or int8
    (K4a)."""
    n = 49 if quant_attn else 48
    rs = np.random.default_rng(d + 102)
    p = _params(rs, n, d)
    x, xt = _x(rs, n, d)
    qp_j, qp_t = _qparams(p, x, False)
    want = jfb.fused_block(x, qp_j, heads=HEADS, interpret=True, quant=True,
                           quant_attn=quant_attn)
    got = fb.block_ref_q8(xt, qp_t, HEADS, quant_attn=quant_attn)
    assert _rel(got, want) <= CHAIN_TOL


@pytest.mark.parametrize("d", WIDTHS)
def test_q8_long_route_ref_equals_short(d):
    """K4a's long route's plain twins at a padded width: the pre-pass's
    operands have the head's d lanes, and the two-pass core equals the
    short core's plain version bit for bit, dynamic and static."""
    n = 70
    qkv, bias = _qkv(n, d, d + 103)
    qkv, bias = torch.from_numpy(qkv), torch.from_numpy(bias)
    for static in (None, (0.021, 0.023, 0.019)):
        kc, ks, vs, vt = fb.attention_q8_prepass_ref(qkv, HEADS, static)
        assert tuple(kc.shape) == (B, HEADS, 128, d)
        assert tuple(vt.shape) == (B, HEADS, d, 128)
        if static is None:
            assert tuple(vs.shape) == (B, HEADS, d)
        torch.testing.assert_close(
            fb.attention_q8_long_ref(qkv, bias, HEADS, static),
            fb.attention_q8_ref(qkv, bias, HEADS, static), rtol=0, atol=0)


# ---------------------------------------------------- training block (K5)

@pytest.mark.parametrize("d", WIDTHS)
def test_block_train_ref_matches_jax(d):
    """K5's plain version against ``_fused_block_train_forward`` in
    interpret mode: the output and the four saved residuals."""
    n = 13
    rs = np.random.default_rng(d + 104)
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


# ------------------------------------------------ attention (K6, K7, K8)

@pytest.mark.parametrize("d", WIDTHS)
def test_attention_probs_matches_pallas(d):
    n = 48
    qkv, bias = _qkv(n, d, d + 105)
    j_out, j_probs = jfa._fused_qkv_probs_forward(
        jnp.asarray(qkv), jnp.asarray(bias), HEADS, 8, True)
    t_out, t_probs = fa.attention_probs_ref(torch.from_numpy(qkv),
                                            torch.from_numpy(bias), HEADS)
    assert _rel(t_out, j_out) <= TOL
    got, want = _f32(t_probs), _f32(j_probs)
    np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-12)
    assert (got == want).mean() >= 0.999


@pytest.mark.parametrize("d", WIDTHS)
def test_attention_qkv_matches_pallas(d):
    n = 13
    qkv, bias = _qkv(n, d, d + 106)
    want = jfa.fused_attention_qkv(jnp.asarray(qkv), jnp.asarray(bias),
                                   HEADS, interpret=True)
    got = fa.attention_qkv_ref(torch.from_numpy(qkv), torch.from_numpy(bias),
                               HEADS)
    assert tuple(got.shape) == (B, n, HEADS * d)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("d", WIDTHS)
def test_attention_bnhd_matches_pallas(d):
    n = 12
    qkv, bias = _qkv(n, d, d + 107)
    q, k, v = (np.ascontiguousarray(
        qkv[..., i * HEADS * d: (i + 1) * HEADS * d].reshape(B, n, HEADS, d))
        for i in range(3))
    want = jfa.fused_attention(*(jnp.asarray(t) for t in (q, k, v)),
                               jnp.asarray(bias), interpret=True)
    got = fa.attention_bnhd_ref(*(torch.from_numpy(t) for t in (q, k, v)),
                                torch.from_numpy(bias))
    assert tuple(got.shape) == (B, n, HEADS, d)
    assert _rel(got, want) <= TOL


# ---------------------------------------------------------------- plans

@pytest.mark.parametrize("d", range(8, 129, 8))
def test_core_width(d):
    """Every width the cores take runs on the smallest instance that holds
    it, and the plans carry both widths."""
    w = fb.core_width(d)
    assert w in fb.CORE_WIDTHS and d <= w
    assert w == 32 or d > w // 2
    assert fb.head_dim_ok(d)
    for plan in (fb.attention_plan, fb.attention_q8_plan):
        for n in (192, 768):
            p = plan(1024, n, 768 // w, head_dim=d)
            assert (p["head_dim"], p["core_width"]) == (d, w)


@pytest.mark.parametrize("d", WIDTHS + [112])
def test_padded_plans_are_the_instances(d):
    """A padded width's plans are its instance's: the same ints (shared
    bytes at the instance's width, which the C entry points check), grid
    and bias forms, and the int8 long route's scratch at the instance's
    width (its lanes past d hold code 0)."""
    w, heads = fb.core_width(d), 6
    for n in (12, 48, 192, 193, 256):
        for b in (240, 1024):
            assert fb.attention_plan(b, n, heads, head_dim=d)["ints"] == \
                fb.attention_plan(b, n, heads, head_dim=w)["ints"]
            assert fb.attention_q8_plan(b, n, heads, head_dim=d)["ints"] == \
                fb.attention_q8_plan(b, n, heads, head_dim=w)["ints"]
        assert fb.attention_q8_smem(n, d) == fb.attention_q8_smem(n, w)
    for n in (257, 300, 768):
        for probs in (False, True):
            got = fb.attention_plan(128, n, heads, head_dim=d, probs=probs)
            want = fb.attention_plan(128, n, heads, head_dim=w, probs=probs)
            assert (got["ints"], got["grid"], got["bias"]) == \
                (want["ints"], want["grid"], want["bias"])
        q8 = fb.attention_q8_plan(128, n, heads, head_dim=d)
        np_ = -(-n // 64) * 64
        assert q8["scratch"] == fb.attention_q8_long_scratch(
            128, n, heads * d, heads) == 128 * heads * (
                2 * np_ * w + 4 * np_ + 4 * w)
    assert fb.attn_row_bytes(d) == (w + 8) * 2


@pytest.mark.parametrize("k,bf16_slabs,s8_slabs", [
    (768, 12, 6), (480, 8, 4), (160, 3, 2), (96, 2, 1), (40, 1, None),
    (1920, 30, 15), (8, 1, None), (16, 1, 1)])
def test_gemm_plans_take_k_tails(k, bf16_slabs, s8_slabs):
    """Both GEMMs take any K whose rows are a multiple of 16 bytes, the
    last slab's lanes past K read as zeros: ceil(K / 64) bf16 slabs,
    ceil(K / 128) int8 ones; the plan's ints (which the C side checks)
    stay the whole-slab ones."""
    p = fb.gemm_plan(1024, 768, k)
    assert p["k_slabs"] == bf16_slabs
    assert p["ints"] == fb.gemm_plan(1024, 768, 768)["ints"]
    if s8_slabs is None:
        with pytest.raises(ValueError, match="K % 16"):
            fb.gemm_q8_plan(1024, 768, k)
    else:
        q = fb.gemm_q8_plan(1024, 768, k)
        assert q["k_slabs"] == s8_slabs
        assert q["ints"] == fb.gemm_q8_plan(1024, 768, 768)["ints"]


@pytest.mark.parametrize("c,heads,align,match", [
    (4 * 8200, 4, fb.GEMM_K_ALIGN, "ROADMAP.md"),  # d 8200 > 8192
    (4 * 20, 4, fb.GEMM_K_ALIGN, "ROADMAP.md"),    # d 20, not a multiple of 8
    (40, 5, fb.Q8_K_ALIGN, "multiple of 16"),      # w8a8 at C % 16 != 0
])
def test_refusals_that_remain(c, heads, align, match):
    """What the cards' kernels still refuse, with ``ValueError`` and no
    fallback: heads wider than 8192. A head width that is no multiple of 8
    (4 heads of 20) and a w8a8 block whose C is no multiple of 16 (5 heads
    of 8), refused before the zero-padded layouts, now pass the checks and
    the plans: their blocks run on a layout the kernels read (``padded_widths``),
    while the GEMM alone still takes only 16-byte rows."""
    x = torch.zeros((2, 12, c), dtype=torch.bfloat16)
    d = c // heads
    if d > fb.MAX_HEAD_DIM:
        with pytest.raises(ValueError, match=match):
            fb._check_x(x, heads, align)
        for plan in (fb.attention_plan, fb.attention_q8_plan):
            with pytest.raises(ValueError, match="ROADMAP.md"):
                plan(1024, 192, heads, head_dim=d)
        return
    assert fb._check_x(x, heads, align) == (2, 12, c)
    lay = fb.padded_widths(c, heads, 4 * c, int8=align == fb.Q8_K_ALIGN)
    assert lay.c_pad % align == 0 and lay.a % align == 0
    assert lay.d_pad % fb.HEAD_DIM_STEP == 0 and lay.d_pad - d < align
    if align == fb.Q8_K_ALIGN:
        assert (lay.c_pad, lay.d_pad, lay.a) == (48, 16, 80)
        with pytest.raises(ValueError, match="K % 16"):
            fb.gemm_q8_plan(1024, 3 * c, c)
        assert fb.block_plan_q8(1024, 192, lay.c_pad, heads, lay.hidden_pad,
                                a=lay.a)
    else:
        assert (lay.c_pad, lay.d_pad) == (80, 24)
        for plan in (fb.attention_plan, fb.attention_q8_plan):
            assert plan(1024, 192, heads, head_dim=d)["ints"] == \
                plan(1024, 192, heads, head_dim=lay.d_pad)["ints"]


def test_bf16_q_scale_is_the_true_width():
    """A padded head scales q by its own d^-½ (rounded to bf16 as JAX's
    weak typing does), not its instance's."""
    for d in WIDTHS:
        assert fb.q_scale(d, torch.bfloat16) == float(
            torch.tensor(d ** -0.5).to(torch.bfloat16))
        assert fb.q_scale(d, torch.float32) == float(np.float32(d ** -0.5))
        assert fb.q_scale(d, torch.bfloat16) != fb.q_scale(
            fb.core_width(d), torch.bfloat16)


# ---------------------------------------------------------- whole models

MODELS = {
    "2x48": dict(embed_dim=96, num_heads=2, depth=(2, 1, 1)),
    # C 160: both GEMMs' K tails (160 % 64 = 32, 160 % 128 = 32)
    "2x80": dict(embed_dim=160, num_heads=2, depth=(2, 1, 1)),
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
    rs = np.random.default_rng(8)
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
