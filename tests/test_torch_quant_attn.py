"""The int8 attention core of ``quantize="w8a8+attn"`` (kernel K4a's plain
version) and the blocks, chains, models and slice that run it, against the
JAX package on the CPU, on the same numpy inputs.

The JAX side runs under ``jax.jit`` (its compiler turns ``amax / 127.0``
into a product with the float32 reciprocal, which the port mirrors) or, for
whole blocks and chains, through its Pallas kernels in interpret mode.

Tolerances (measured in brackets):
* the int8 codes of q, k (per row) and v (per column): equal.
* the attention core alone, float32: within 1e-5 of max|JAX| [1.2e-7]. Its
  arithmetic is the JAX package's step for step; only ``exp`` may differ in
  the last bit between the two libraries, which moves a probability code
  rint(127·e) by one where 127·e sits on a rounding boundary, a change of
  about 1/Σpq of a value row (rare at these sizes; none seen).
* a block and a chain of three blocks, float32: 5e-3 of max|JAX|, the w8a8
  chain's bound of ``tests/test_torch_quant.py`` [1.1e-7; one block at
  N 49 with static scales 1.4e-3]: an int8 code that sits on a rounding
  boundary can flip, in the attention too, where one v code of a key that
  takes most of a row's weight moves that token's output by one quant step
  of v (about max|v|/127), and the projection spreads it over the row.
* the tiny v3 and v5 models' embeddings: 2e-3 of max|JAX|, the w8a8
  slice's bound (``tests/test_torch_serving.py``); the slice's labels,
  rounds, label map and cluster count equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu.models.s2former import build_model, init_params
from deepmerge_tpu.ops.pallas import fused_block as jfb
from deepmerge_tpu_torch.compat.weights import state_dict_from_flax
from deepmerge_tpu_torch.models import s2former
from deepmerge_tpu_torch.models.s2former import S2Former
from deepmerge_tpu_torch.ops.kernels import fused_block as tfb
from tests.test_torch_quant import (
    B,
    CHAIN_TOL,
    HEADS,
    C,
    _jax,
    _jax_amax,
    _params,
    _port,
)
from tests.test_torch_serving import (  # noqa: F401 (fixtures)
    DCFG,
    J_DCFG,
    Q_TOL,
    _extractors,
    _gap_threshold,
    _jax as _jax_cfg,
    _quiet,
    _rel,
    jscene,
    scene_and_edges,
)

ATTN_TOL = 1e-5


def _init_variables(mcfg, seed):
    """JAX's initial variables of the tiny ``mcfg``, as numpy. The tree is
    the same on every block path, so it is built off the kernels and
    jitted, which is quicker than the kernels' interpret mode."""
    plain = build_model(_jax_cfg(dataclasses.replace(
        mcfg, quantize="", fused_block=False, fused_attention=False)))
    return jax.tree.map(np.asarray, jax.jit(
        lambda key: init_params(plain, key))(jax.random.key(seed)))
STATIC = pytest.mark.parametrize("static", [False, True],
                                 ids=["dynamic", "static"])


def _qkv(rs, n, heads=HEADS, c=C):
    """A (B, N, 3C) float32 qkv with one all-zero q row and one all-zero k
    row (scale 1, zero codes), and an (H, N, N) bias."""
    qkv = (rs.standard_normal((B, n, 3 * c)) * 2.0).astype(np.float32)
    qkv[0, 1, : c // heads] = 0.0
    qkv[1, 2, c : c + c // heads] = 0.0
    bias = (rs.standard_normal((heads, n, n)) * 0.5).astype(np.float32)
    return qkv, bias


def _static_scales(qkv, c=C):
    """Calibrated (s_q, s_k, s_v): the abs-max of each third over 127,
    shrunk so that some values saturate at ±127."""
    return tuple(np.float32(0.8 * np.abs(qkv[..., i * c : (i + 1) * c]).max()
                            / 127.0) for i in range(3))


def _columns_codes(t):
    """JAX's per-column codes of a 2-D float32 array (``quantize_weight``:
    the scale amax·(1/127) of each column, 1 for an all-zero one)."""
    q, _ = jax.jit(jfb.quantize_weight)(jnp.asarray(t))
    return np.asarray(q)


@pytest.mark.parametrize("n", [12, 49])
def test_attention_q8_codes_match_jax(n):
    """q and k codes per row over the head's lanes, v codes per column over
    the tokens: equal to the JAX package's (the same formula as
    ``_attn_inner_q8``'s, through its jitted ``quantize_weight``)."""
    rs = np.random.default_rng(n)
    qkv, _ = _qkv(rs, n)
    d = C // HEADS
    qi, _, ki, _, vi, _ = tfb._q8_operands(torch.from_numpy(qkv), HEADS)
    q, k, v = (qkv[..., i * C : (i + 1) * C].reshape(B, n, HEADS, d)
               for i in range(3))
    for got, rows in ((qi, q), (ki, k)):
        want = _columns_codes(rows.reshape(-1, d).T).T.reshape(rows.shape)
        np.testing.assert_array_equal(got.numpy(), want)
    want = _columns_codes(v.transpose(1, 0, 2, 3).reshape(n, -1))
    np.testing.assert_array_equal(
        vi.numpy(), want.reshape(n, B, HEADS, d).transpose(1, 0, 2, 3))
    assert not qi[0, 1, 0].any() and not ki[1, 2, 0].any()


@STATIC
@pytest.mark.parametrize("n", [12, 49])
def test_attention_q8_matches_jax(n, static):
    """``_attention_q8`` / ``_attention_q8s`` against the jitted
    ``_attn_inner_q8`` / ``_attn_inner_q8s`` (float32)."""
    rs = np.random.default_rng(10 + n)
    qkv, bias = _qkv(rs, n)
    if static:
        s = _static_scales(qkv)
        want = jax.jit(lambda t, b: jfb._attn_inner_q8s(
            t, b, heads=HEADS, dtype=jnp.float32, s_q=s[0], s_k=s[1],
            s_v=s[2]))(qkv, bias)
        got = tfb._attention_q8s(torch.from_numpy(qkv),
                                 torch.from_numpy(bias), HEADS,
                                 *(torch.tensor(v) for v in s))
    else:
        want = jax.jit(lambda t, b: jfb._attn_inner_q8(
            t, b, heads=HEADS, dtype=jnp.float32))(qkv, bias)
        got = tfb._attention_q8(torch.from_numpy(qkv),
                                torch.from_numpy(bias), HEADS)
    assert got.dtype == torch.float32 and got.shape == (B, n, C)
    assert _rel(got.numpy(), want) <= ATTN_TOL


def _qparams_pair(p, x, static):
    """The w8a8 tuple in each package; with ``static``, 18 entries whose
    scales come from the same abs-maxes, JAX's calibration on ``x`` (the
    two calibrations agree within 1e-5, ``tests/test_torch_quant.py``, but
    an ulp of an attention operand's scale flips the codes that sit on a
    rounding boundary)."""
    amax = _jax_amax(jnp.asarray(x), _jax(p))[1] if static else None
    qp_j = jax.jit(jfb.quantize_block_params)(_jax(p), amax)
    amax_t = torch.from_numpy(np.array(amax)) if static else None
    return qp_j, tfb.quantize_block_params(_port(p), amax_t)


@STATIC
@pytest.mark.parametrize("n", [48, 49])
def test_block_ref_q8_attn_matches_jax(n, static):
    """``block_ref_q8(quant_attn=True)`` against the JAX ``fused_block(...,
    quant=True, quant_attn=True)`` in interpret mode, with the 17- and the
    18-tuple."""
    rs = np.random.default_rng(20 + n)
    p = _params(rs, n)
    x = rs.standard_normal((B, n, C)).astype(np.float32)
    qp_j, qp_t = _qparams_pair(p, x, static)
    assert len(qp_t) == (18 if static else 17)
    want = np.asarray(jfb.fused_block(jnp.asarray(x), qp_j, heads=HEADS,
                                      interpret=True, quant=True,
                                      quant_attn=True))
    got = tfb.block_ref_q8(torch.from_numpy(x), qp_t, HEADS,
                           quant_attn=True)
    assert _rel(got.numpy(), want) <= CHAIN_TOL
    # the int8 attention is a different function from the bf16 one
    plain = tfb.block_ref_q8(torch.from_numpy(x), qp_t, HEADS)
    assert not torch.equal(plain, got)


@STATIC
def test_chain_ref_q8_attn_matches_jax(static):
    """Three blocks through ``chain_ref_q8(quant_attn=True)`` against the
    JAX ``fused_block_chain(..., quant=True, quant_attn=True)``."""
    n = 12
    rs = np.random.default_rng(31)
    ps = [_params(rs, n) for _ in range(3)]
    x = rs.standard_normal((B, n, C)).astype(np.float32)
    h, qps_j, qps_t = x, [], []
    for p in ps:   # each block calibrated on its own input, when static
        qp_j, qp_t = _qparams_pair(p, h, static)
        qps_j.append(qp_j)
        qps_t.append(qp_t)
        h = tfb.block_ref_q8(torch.from_numpy(h), qp_t, HEADS,
                             quant_attn=True).numpy()
    want = np.asarray(jfb.fused_block_chain(
        jnp.asarray(x), tuple(qps_j), heads=HEADS, interpret=True,
        quant=True, quant_attn=True))
    got = tfb.chain_ref_q8(torch.from_numpy(x), qps_t, HEADS,
                           quant_attn=True).numpy()
    assert _rel(got, want) <= CHAIN_TOL


def test_cpu_dispatch_runs_the_plain_version():
    """On CPU tensors the K4a wrappers run their plain versions and count
    no launch."""
    rs = np.random.default_rng(3)
    ps = [tfb.quantize_block_params(_port(_params(rs, 12)))
          for _ in range(2)]
    x = torch.from_numpy(rs.standard_normal((2, 12, C)).astype(np.float32))
    before = (tfb.fused_block_q8_attn.launches,
              tfb.fused_block_chain_q8_attn.launches)
    torch.testing.assert_close(
        tfb.fused_block_q8_attn(x, ps[0], HEADS),
        tfb.block_ref_q8(x, ps[0], HEADS, quant_attn=True), rtol=0, atol=0)
    torch.testing.assert_close(
        tfb.fused_block_chain_q8_attn(x, ps, HEADS),
        tfb.chain_ref_q8(x, ps, HEADS, quant_attn=True), rtol=0, atol=0)
    assert (tfb.fused_block_q8_attn.launches,
            tfb.fused_block_chain_q8_attn.launches) == before


# ------------------------------------------------------- models and slice


def _count_quant_attn(monkeypatch):
    """Record the ``quant_attn`` of every w8a8 block and chain call the
    model makes."""
    seen = []

    def wrap(fn):
        def wrapped(*a, quant_attn=False, **kw):
            seen.append(quant_attn)
            return fn(*a, quant_attn=quant_attn, **kw)
        return wrapped

    for name in ("fused_block_q8", "fused_block_chain_q8"):
        monkeypatch.setattr(s2former, name, wrap(getattr(s2former, name)))
    return seen


@pytest.mark.parametrize("variant", ["v3", "v5"])
def test_model_w8a8_attn_matches_jax(monkeypatch, variant):
    """A tiny v3 and v5 with ``quantize="w8a8+attn"`` (depth 1/2/1: one
    chain; v5 carries its extra token, N = 193/49/13 at full size): every
    block and chain call runs the int8 attention, and the embeddings agree
    with the JAX package's on the same parameters and inputs."""
    mcfg = _quiet(variant=variant, quantize="w8a8+attn", depth=(1, 2, 1))
    jcfg = _jax_cfg(mcfg)
    variables = _init_variables(mcfg, 1)
    rs = np.random.default_rng(5)
    patches = [rs.random((3, s, s, 3), dtype=np.float32)
               for s in mcfg.input_image_scales]
    designed = rs.standard_normal((3, 19)).astype(np.float32)
    want = np.asarray(jax.jit(build_model(jcfg).apply, static_argnums=3)(
        variables, tuple(jnp.asarray(p) for p in patches),
        jnp.asarray(designed), False))
    model = S2Former(mcfg)
    model.load_state_dict(state_dict_from_flax(
        variables["params"], mcfg, variables.get("batch_stats")),
        strict=True)
    seen = _count_quant_attn(monkeypatch)
    with torch.inference_mode():
        got = model.eval()([torch.from_numpy(p) for p in patches],
                           torch.from_numpy(designed)).numpy()
    assert seen == [True] * 3  # stage 0's block, stage 1's chain, stage 2
    assert _rel(got, want) <= Q_TOL, _rel(got, want)


def test_w8a8_attn_slice_matches_jax(scene_and_edges, jscene):
    """``segment_scene_device`` of the tiny v3 in ``w8a8+attn``: the
    embeddings within Q_TOL, and the labels, rounds, label map and cluster
    count equal to the JAX package's."""
    scene, edges, valid = scene_and_edges
    mcfg = _quiet(quantize="w8a8+attn")
    jx, tx = _extractors(mcfg, _init_variables(mcfg, 0)["params"])
    r = scene.regions.num_regions
    simi0 = np.asarray(jx.segment_scene_device(
        jscene, J_DCFG, edges, valid, num_regions=r, max_rounds=8)[0])
    kw = dict(num_regions=r, max_rounds=8, region_map=scene.labels,
              threshold=_gap_threshold(simi0, valid), with_embeddings=True)
    want = [np.asarray(a) for a in
            jx.segment_scene_device(jscene, J_DCFG, edges, valid, **kw)]
    got = [a.numpy() for a in
           tx.segment_scene_device(scene, DCFG, edges, valid, **kw)]
    assert _rel(got[5], want[5]) <= Q_TOL
    assert _rel(got[0][valid], want[0][valid]) <= Q_TOL
    for name, g, w in zip(("labels", "rounds", "label map", "n_clusters"),
                          got[1:5], want[1:5]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert int(got[2]) >= 1


def test_static_attn_config_still_refused():
    """``w8a8-static+attn`` stays refused by the configuration, as in the
    JAX package: the static K4a is reachable only through the kernel
    functions with an 18-tuple."""
    with pytest.raises(ValueError, match="w8a8-static\\+attn"):
        _quiet(quantize="w8a8-static+attn")
