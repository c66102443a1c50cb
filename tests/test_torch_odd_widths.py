"""Widths the CUDA kernels read only on a zero-padded layout: heads whose
width is not a multiple of 8, and w8a8 residual or MLP widths that are not
multiples of 16 (``fused_block.PaddedWidths``). The layout's plain twin
(``fused_block.block_twin``, ``attention_q8_twin``,
``fused_attention.attention_twin``, ``attention_bnhd_twin``: what the
kernels compute there, the LayerNorms' statistics over the true C and q's
scale of the true d) against the JAX package's Pallas kernels in interpret
mode, on the CPU, on the same numpy inputs; the twin against the port's
plain versions at the true widths; the padded lanes; the quantized tuple's
padding; K5's gradients through the padding; the plans; and a whole v3
model at embed 52 with its blocks through the twin.

Small sizes: 4 heads of 13 (C 52), 3 of 20 (C 60), 6 of 15 (C 90, MLP 360,
which w8a8 pads to 368) and 1 of 260 (C 260, the wide form's widths), MLP
4C, B 3 (odd, so the JAX kernels' batch tile of 2 pads), N 12 and 48.

Bounds, each ``test_torch_head_widths.py``'s for the same function:
``TOL`` for the bf16 blocks, chains, K6 and K7/K8 in float32,
``CHAIN_TOL`` for w8a8, ``TRAIN_TOL`` for K5's outputs; K5's gradients
``test_torch_train_block.py``'s float32 bound (5e-4); the twin against the
unpadded plain versions 1e-6 of max|·| in float32, where only the order
of float32 sums may differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu.compat.torch_import import torch_state_dict_to_flax
from deepmerge_tpu.config import ModelConfig as JaxModelConfig
from deepmerge_tpu.models.s2former import build_model
from deepmerge_tpu.ops.pallas import fused_attention as jfa
from deepmerge_tpu.ops.pallas import fused_block as jfb
from deepmerge_tpu_torch.compat.weights import init_state_dict
from deepmerge_tpu_torch.config import ModelConfig
from deepmerge_tpu_torch.models import s2former
from deepmerge_tpu_torch.ops.kernels import fused_attention as fa
from deepmerge_tpu_torch.ops.kernels import fused_block as fb
from tests.test_torch_head_widths import CHAIN_TOL, TOL, TRAIN_TOL
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = {"4x13": (4, 13), "3x20": (3, 20), "6x15": (6, 15),
          "1x260": (1, 260)}
B = 3
DENSE = (2, 5, 9, 11)  # dense kernels of the 13-tuple: (in, out) in JAX
GRAD_TOL = 5e-4
TWIN_TOL = 1e-6


def _params(rs, n, heads, d):
    """One float32 block's 13-tuple in the JAX layout, C = heads·d, MLP
    4C."""
    c = heads * d
    r = lambda *shape, s=0.05: (rs.standard_normal(shape) * s).astype(
        np.float32)
    return (1.0 + r(c), r(c), r(c, 3 * c), r(3 * c), r(heads, n, n, s=0.5),
            r(c, c), r(c), 1.0 + r(c), r(c), r(c, 4 * c), r(4 * c),
            r(4 * c, c), r(c))


def _port(p):
    """JAX layout → the port's (dense kernels (out, in))."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a.T if i in DENSE
                                                       else a))
                 for i, a in enumerate(p))


def _jax(p):
    return tuple(jnp.asarray(a) for a in p)


def _inputs(shape, n, seed, depth=1):
    heads, d = SHAPES[shape]
    rs = np.random.default_rng(seed)
    ps = [_params(rs, n, heads, d) for _ in range(depth)]
    x = rs.standard_normal((B, n, heads * d)).astype(np.float32)
    return heads, d, ps, x


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------- the twin against JAX

@pytest.mark.parametrize("shape,n", [("4x13", 12), ("1x260", 12)])
def test_block_twin_matches_pallas(shape, n):
    heads, _, (p,), x = _inputs(shape, n, 1)
    want = jfb.fused_block(jnp.asarray(x), _jax(p), heads=heads, block_b=2,
                           interpret=True)
    got = fb.block_twin(torch.from_numpy(x), _port(p), heads)
    assert _rel(got, want) <= TOL


def test_chain_twin_matches_pallas():
    heads, _, ps, x = _inputs("4x13", 12, 2, depth=2)
    want = jfb.fused_block_chain(jnp.asarray(x), tuple(_jax(p) for p in ps),
                                 heads=heads, block_b=2, interpret=True)
    got = fb.block_twin(torch.from_numpy(x), [_port(p) for p in ps], heads)
    assert _rel(got, want) <= TOL


_quantize_j = jax.jit(jfb.quantize_block_params)


def _qparams(p, x, heads, static):
    """The w8a8 tuple in each package; with ``static``, 18 entries whose
    scales come from the calibration on ``x`` (the port's
    ``block_act_amax``, which ``test_torch_quant_attn.py`` holds to the JAX
    package's)."""
    amax = None
    if static:
        amax = fb.block_act_amax(torch.from_numpy(x), _port(p), heads)[1]
    qp_j = _quantize_j(_jax(p), None if amax is None else
                       jnp.asarray(amax.numpy()))
    return qp_j, fb.quantize_block_params(_port(p), amax)


@pytest.mark.parametrize("shape,n,static,quant_attn", [
    ("6x15", 48, False, False),   # the MLP's pad (360 -> 368)
    ("4x13", 12, True, True),
])
def test_q8_block_twin_matches_pallas(shape, n, static, quant_attn):
    heads, _, (p,), x = _inputs(shape, n, 3)
    qp_j, qp_t = _qparams(p, x, heads, static)
    want = jfb.fused_block(jnp.asarray(x), qp_j, heads=heads, interpret=True,
                           quant=True, quant_attn=quant_attn)
    got = fb.block_twin(torch.from_numpy(x), qp_t, heads,
                        quant_attn=quant_attn)
    assert _rel(got, want) <= CHAIN_TOL


@pytest.mark.parametrize("static,quant_attn", [(False, False)])
def test_q8_chain_twin_matches_pallas(static, quant_attn):
    """Two w8a8 blocks, each calibrated on its own input when static."""
    heads, _, ps, x = _inputs("4x13", 12, 4, depth=2)
    h, qps_j, qps_t = x, [], []
    for p in ps:
        qp_j, qp_t = _qparams(p, h, heads, static)
        qps_j.append(qp_j)
        qps_t.append(qp_t)
        h = fb.block_ref_q8(torch.from_numpy(np.array(h)), qp_t, heads,
                            quant_attn=quant_attn).numpy()
    want = jfb.fused_block_chain(jnp.asarray(x), tuple(qps_j), heads=heads,
                                 interpret=True, quant=True,
                                 quant_attn=quant_attn)
    got = fb.block_twin(torch.from_numpy(x), qps_t, heads,
                        quant_attn=quant_attn)
    assert _rel(got, want) <= CHAIN_TOL


def _qkv(shape, n, seed):
    heads, d = SHAPES[shape]
    rs = np.random.default_rng(seed)
    qkv = rs.standard_normal((B, n, 3 * heads * d)).astype(np.float32)
    bias = (rs.standard_normal((heads, n, n)) * 0.5).astype(np.float32)
    return heads, d, qkv, bias


@pytest.mark.parametrize("shape,n", [("4x13", 48)])
def test_k6_twin_matches_pallas(shape, n):
    heads, _, qkv, bias = _qkv(shape, n, 5)
    j_out, j_probs = jfa._fused_qkv_probs_forward(
        jnp.asarray(qkv), jnp.asarray(bias), heads, 8, True)
    out, probs = fa.attention_twin(torch.from_numpy(qkv),
                                   torch.from_numpy(bias), heads, probs=True)
    assert _rel(out, j_out) <= TOL
    np.testing.assert_allclose(_f32(probs), _f32(j_probs), rtol=2 ** -7,
                               atol=1e-12)


@pytest.mark.parametrize("shape", ["3x20"])
def test_k7_twin_matches_pallas(shape):
    heads, _, qkv, bias = _qkv(shape, 12, 6)
    want = jfa.fused_attention_qkv(jnp.asarray(qkv), jnp.asarray(bias), heads,
                                   interpret=True)
    got = fa.attention_twin(torch.from_numpy(qkv), torch.from_numpy(bias),
                            heads)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("shape", ["1x260"])
def test_k8_twin_matches_pallas(shape):
    heads, d, qkv, bias = _qkv(shape, 12, 7)
    q, k, v = (qkv[..., i * heads * d:(i + 1) * heads * d].reshape(
        B, 12, heads, d) for i in range(3))
    want = jfa.fused_attention(*(jnp.asarray(t) for t in (q, k, v)),
                               jnp.asarray(bias), interpret=True)
    got = fa.attention_bnhd_twin(*(torch.from_numpy(np.ascontiguousarray(t))
                                   for t in (q, k, v)),
                                 torch.from_numpy(bias))
    assert tuple(got.shape) == (B, 12, heads, d)
    assert _rel(got, want) <= TOL


def test_k5_twin_and_gradients_through_the_padding_match_jax():
    """K5 on the padded layout (its CUDA path: the inputs padded, the
    block on the layout, its output and residuals cut back, the hand
    backward at the true widths): the outputs against
    ``_fused_block_train_forward``, and the gradients of x and of every
    parameter for one output cotangent against ``_fused_block_bwd`` on
    those residuals."""
    heads, _, (p,), x = _inputs("4x13", 12, 8)
    g = np.random.default_rng(14).standard_normal(x.shape).astype(np.float32)
    def fwd_bwd(x, p, g):
        out, saved = jfb._fused_block_train_forward(x, p, heads, False, 2,
                                                    True)
        return out, saved, jfb._fused_block_bwd(heads, False, 2, True,
                                                (x, p, saved), g)

    out, saved, (wx, wp) = jax.jit(fwd_bwd)(jnp.asarray(x), _jax(p),
                                            jnp.asarray(g))
    qkv, probs, gin, r = saved
    probs = _f32(probs).reshape(B, 12, heads, 12).transpose(0, 2, 1, 3)
    xt = torch.from_numpy(x)
    got_out, got = fb.block_twin(xt, _port(p), heads, train=True)
    for name, a, w in zip(("out", "qkv", "probs", "gin", "r"),
                          (got_out, *got), (out, qkv, probs, gin, r)):
        assert tuple(a.shape) == tuple(w.shape), name
        assert _rel(a, w) <= TRAIN_TOL, (name, _rel(a, w))
    xs = xt.clone().requires_grad_(True)
    ps = [t.clone().requires_grad_(True) for t in _port(p)]
    twin = lambda x, p, h, e=False: fb.block_twin(x, p, h, e, train=True)
    orig = fb.fused_block_train
    fb.fused_block_train = twin
    try:
        fb.fused_block(xs, ps, heads).backward(torch.from_numpy(g))
    finally:
        fb.fused_block_train = orig
    np.testing.assert_allclose(_f32(xs.grad), _f32(wx), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    for i, (a, w) in enumerate(zip(ps, wp)):
        w = _f32(w)
        np.testing.assert_allclose(_f32(a.grad), w.T if i in DENSE else w,
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"parameter {i}")


# ------------------------------- the twin against the unpadded versions

@pytest.mark.parametrize("shape", list(SHAPES))
def test_twin_matches_the_unpadded_plain_versions(shape):
    """On the padded layout only the order of float32 sums may differ
    from the plain versions at the true widths: every twin within 1e-6
    of max|·|."""
    heads, _, ps, x = _inputs(shape, 12, 9, depth=2)
    xt, pt = torch.from_numpy(x), [_port(p) for p in ps]
    pairs = [(fb.block_twin(xt, pt[0], heads), fb.block_ref(xt, pt[0], heads)),
             (fb.block_twin(xt, pt, heads), fb.chain_ref(xt, pt, heads))]
    out, saved = fb.block_twin(xt, pt[0], heads, train=True)
    w_out, w_saved = fb.block_train_ref(xt, pt[0], heads)
    pairs += list(zip((out, *saved), (w_out, *w_saved)))
    for quant_attn in (False, True):
        qps = [fb.quantize_block_params(p) for p in pt]
        pairs.append((fb.block_twin(xt, qps, heads, quant_attn=quant_attn),
                      fb.chain_ref_q8(xt, qps, heads,
                                      quant_attn=quant_attn)))
    _, _, qkv, bias = _qkv(shape, 12, 10)
    qkv, bias = torch.from_numpy(qkv), torch.from_numpy(bias)
    pairs += [(fa.attention_twin(qkv, bias, heads),
               fa.attention_qkv_ref(qkv, bias, heads)),
              (fb.attention_q8_twin(qkv, bias, heads),
               fb.attention_q8_ref(qkv, bias, heads))]
    q, k, v = fa.split_qkv(qkv, heads)
    pairs.append((fa.attention_bnhd_twin(q, k, v, bias),
                  fa.attention_bnhd_ref(q, k, v, bias)))
    for i, (got, want) in enumerate(pairs):
        assert got.shape == want.shape, i
        assert _rel(got, want) <= TWIN_TOL, (i, _rel(got, want))


@pytest.mark.parametrize("shape", ["4x13", "6x15"])
@pytest.mark.parametrize("q8", [False, True])
def test_padded_lanes_stay_zero(shape, q8):
    """Once x's padded lanes are 0, a block (and K5's residuals) on the
    layout leaves every padded lane exactly 0."""
    heads, _, (p,), x = _inputs(shape, 12, 11)
    c, pt = x.shape[-1], _port(p)
    lay = fb.padded_widths(c, heads, 4 * c, int8=q8)
    assert not lay.aligned
    xp = lay.pad_x(torch.from_numpy(x))
    kw = dict(width=lay.c, head_dim=lay.d)
    if q8:
        out = fb.block_ref_q8(xp, lay.pad_qparams(fb.quantize_block_params(
            pt)), heads, quant_attn=True, **kw)
    else:
        out, (qkv, _, gin, r) = fb.block_train_ref(xp, lay.pad_params(pt),
                                                   heads, **kw)
        heads_lanes = qkv.reshape(B, 12, 3, heads, lay.d_pad)
        assert torch.count_nonzero(heads_lanes[..., lay.d:]) == 0
        assert torch.count_nonzero(gin[..., lay.hidden:]) == 0
        assert torch.count_nonzero(r[..., c:]) == 0
    assert out.shape[-1] == lay.c_pad
    assert torch.count_nonzero(out[..., c:]) == 0


@pytest.mark.parametrize("shape", list(SHAPES))
def test_quantize_then_pad_is_pad_then_quantize(shape):
    """The w8a8 tuple padded (codes 0, scales 1 past the true widths)
    equals quantizing the padded 13-tuple, static scales included."""
    heads, _, (p,), x = _inputs(shape, 12, 12)
    c, pt = x.shape[-1], _port(p)
    lay = fb.padded_widths(c, heads, 4 * c, int8=True)
    amax = torch.linspace(0.5, 2.0, 7)
    got = lay.pad_qparams(fb.quantize_block_params(pt, amax))
    want = fb.quantize_block_params(lay.pad_params(pt), amax)
    assert len(got) == len(want) == 18
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), i
    assert lay.c_pad % fb.Q8_K_ALIGN == lay.a % fb.Q8_K_ALIGN == \
        lay.hidden_pad % fb.Q8_K_ALIGN == 0


# ---------------------------------------------------------------- plans

@pytest.mark.parametrize("d,c", [(12, 144), (65, 780), (196, 784),
                                 (260, 780)])
def test_plans_at_odd_widths(d, c):
    """A head of width d runs on the instance, route and plan of its
    layout's width round_up(d, 8); a block's plan on the layout holds the
    GEMMs at C', A and hidden'; d above 128 takes the long route at every
    N, above 256 its wide form."""
    heads, dp = c // d, -(-d // 8) * 8
    lay = fb.padded_widths(c, heads, 4 * c)
    assert (lay.d, lay.d_pad, lay.a) == (d, dp, heads * dp)
    assert fb.core_width(d) == fb.core_width(dp)
    for n in (12, 48, 192, 768):
        for plan in (fb.attention_plan, fb.attention_q8_plan):
            got, want = (plan(256, n, heads, head_dim=w) for w in (d, dp))
            assert got["ints"] == want["ints"] and got["route"] == \
                want["route"]
            assert got["route"] == ("long" if n > 256 or d > 128
                                    else "short")
    ints = fb.block_plan(256, 192, lay.c_pad, heads, lay.hidden_pad, lay.a)
    assert ints[:4] == fb.attention_plan(256, 192, heads, head_dim=d)["ints"]
    q8 = fb.padded_widths(c, heads, 4 * c, int8=True)
    assert fb.block_plan_q8(256, 192, q8.c_pad, heads, q8.hidden_pad, True,
                            q8.a)[:4] == \
        fb.attention_q8_plan(256, 192, heads, head_dim=d)["ints"]


# ---------------------------------------------------------- whole model

MODEL = dict(embed_dim=52, num_heads=4, depth=(1, 1, 1), out_dim=16,
             input_image_scales=(16, 32, 64), cube=8, dtype="float32")


def _model_inputs(mcfg):
    rs = np.random.default_rng(13)
    patches = [rs.random((2, s, s, 3), dtype=np.float32)
               for s in mcfg.input_image_scales]
    return patches, rs.standard_normal((2, 19)).astype(np.float32)


def _forward(port, patches, designed):
    with torch.inference_mode():
        return port.eval()([torch.from_numpy(p) for p in patches],
                           torch.from_numpy(designed)).numpy()


def test_v3_at_embed_52_matches_jax(monkeypatch):
    """v3 at embed 52 with 4 heads of 13 (the smallest scales, cube and
    depth of the port's model tests), every block through the padded
    layout's twin (the block kernels' path), against the JAX
    ``build_model`` forward (its Pallas kernels in interpret mode) on the
    same weights: ``init_state_dict``'s, mapped onto the JAX model by
    ``torch_state_dict_to_flax``, float32."""
    mcfg, jcfg = ModelConfig(**MODEL), JaxModelConfig(**MODEL)
    jmodel = build_model(jcfg)
    patches, designed = _model_inputs(mcfg)
    j_in = (tuple(jnp.asarray(p) for p in patches), jnp.asarray(designed))
    unfused = build_model(JaxModelConfig(**MODEL, fused_block=False))
    template = jax.eval_shape(  # the same parameters, traced cheaper
        lambda k: unfused.init({"params": k}, *j_in, False),
        jax.random.key(0))
    sd = init_state_dict(mcfg, seed=0)
    variables = torch_state_dict_to_flax(sd, template)
    want = np.asarray(jax.jit(lambda v: jmodel.apply(v, *j_in, False))(
        variables))
    calls = []

    def twin(x, params, heads, exact_gelu=False):
        calls.append(len(params) if isinstance(params, list) else 1)
        return fb.block_twin(x, params, heads, exact_gelu)

    monkeypatch.setattr(s2former, "fused_block", twin)
    monkeypatch.setattr(s2former, "fused_block_chain",
                        lambda x, ps, heads, exact_gelu=False:
                        twin(x, list(ps), heads, exact_gelu))
    port = s2former.S2Former(mcfg)
    port.load_state_dict(sd, strict=True)
    got = _forward(port, patches, designed)
    assert sum(calls) == sum(MODEL["depth"])
    assert got.shape == want.shape == (2, 16)
    assert _rel(got, want) <= TOL


def test_unfused_v3_on_the_padded_heads_matches_the_true_widths(monkeypatch):
    """Off the block kernels, a head of 13 lanes makes its qkv on the
    attention kernels' padded layout (heads of 16) by a padded weight and
    projects from there: the same model as at the true widths, within
    1e-6 of max|·| in float32."""
    mcfg = ModelConfig(**MODEL, fused_block=False)
    patches, designed = _model_inputs(mcfg)
    port = s2former.S2Former(mcfg)
    port.load_state_dict(init_state_dict(mcfg, seed=0), strict=True)
    blocks = [b for b in port.modules()
              if isinstance(b, s2former.CrossScaleBlock)]
    assert len(blocks) == sum(MODEL["depth"])
    assert all(b._head_layout().d_pad == 16 for b in blocks)
    got = _forward(port, patches, designed)
    monkeypatch.setattr(s2former.CrossScaleBlock, "_head_layout",
                        lambda self: None)
    want = _forward(port, patches, designed)
    assert _rel(got, want) <= TWIN_TOL
