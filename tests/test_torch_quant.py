"""The w8a8 block math of the PyTorch port (the plain version of kernel K4)
against the JAX package's, on the CPU, on the same numpy inputs.

The JAX side runs under ``jax.jit``, as the JAX package runs it: its
compiler turns ``amax / 127.0`` into a product with the float32
reciprocal, which the port mirrors, so weight scales, codes and the
dequantized products are compared bit for bit. The JAX package's Pallas
kernels run the same ``_block_math_q8``; it is the reference here (the
kernels' own parity tests in ``tests/test_quantize.py`` take minutes).

Tolerances of the whole block: in float32 the JAX package's own (rtol 6e-3,
atol 1e-3, ``tests/test_quantize.py:63-65``): the two sides sum the
LayerNorm and the attention in other orders, so a row on an int8 rounding
boundary can move by one quant step. A chain of three blocks is held to
5e-3 of its largest output magnitude, a flip in an early block being carried
through the later ones. In bf16, 2e-2 of the largest output magnitude: one
quant step plus a few bf16 ulps carried through the block.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu.ops.pallas import fused_block as jfb
from deepmerge_tpu_torch.ops.kernels import fused_block as tfb

C, HEADS, HIDDEN, B = 64, 4, 256, 3
RTOL, ATOL = 6e-3, 1e-3
BF16_TOL = 2e-2
CHAIN_TOL = 5e-3
DENSE = (2, 5, 9, 11)  # dense kernels of the 13-tuple: (in, out) in JAX


def _params(rs, n, dtype=np.float32):
    """One block's 13-tuple in the JAX layout, LayerNorm and bias in f32,
    the rest in ``dtype`` (as the model hands them to the kernel)."""
    r = lambda *shape, s=0.05: (rs.standard_normal(shape) * s).astype(
        np.float32)
    p = (1.0 + r(C), r(C), r(C, 3 * C), r(3 * C), r(HEADS, n, n, s=0.5),
         r(C, C), r(C), 1.0 + r(C), r(C), r(C, HIDDEN), r(HIDDEN),
         r(HIDDEN, C), r(C))
    keep_f32 = (0, 1, 4, 7, 8)
    return tuple(a if i in keep_f32 else a.astype(dtype)
                 for i, a in enumerate(p))


def _jax(p):
    return tuple(jnp.asarray(a) for a in p)


def _port(p):
    """JAX layout → port layout: dense kernels (out, in)."""
    out = []
    for i, a in enumerate(p):
        t = torch.from_numpy(np.ascontiguousarray(
            np.asarray(a, np.float32).T if i in DENSE
            else np.asarray(a, np.float32)))
        out.append(t.to(torch.bfloat16) if a.dtype != np.float32 else t)
    return tuple(out)


def _np(t):
    return t.to(torch.float32).numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _jax_block_q8(x, qp):
    """The JAX package's ``_block_math_q8`` on a 17/18-tuple, jitted."""
    s_act = None
    if len(qp) == 18:
        s_act = tuple(qp[17][i] for i in range(7))
    return jfb._block_math_q8(x, *qp[:17], heads=HEADS, exact_gelu=False,
                              s_act=s_act)


def _jax_amax(x, params):
    return jax.jit(functools.partial(jfb.block_act_amax, heads=HEADS,
                                     exact_gelu=False))(x, params)


# ----------------------------------------------------------- weights


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_quantize_weight_bit_exact(dtype):
    """Codes and scales equal bit for bit, an all-zero channel included
    (scale 1, all-zero codes)."""
    rs = np.random.default_rng(0)
    w = (rs.standard_normal((C, HIDDEN)) * 0.05).astype(dtype)
    w[:, 5] = 0
    q_j, s_j = jax.jit(jfb.quantize_weight)(jnp.asarray(w))
    wt = torch.from_numpy(np.asarray(w, np.float32).T.copy())
    if dtype != np.float32:
        wt = wt.to(torch.bfloat16)
    q_t, s_t = tfb.quantize_weight(wt)
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j).T)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert float(s_t[5]) == 1.0 and not q_t[5].any()


def test_quantize_block_params_matches_jax():
    """The 17- and 18-tuples: same order, codes and scales bit-exact."""
    rs = np.random.default_rng(1)
    p = _params(rs, 12)
    amax = np.abs(rs.standard_normal(7)).astype(np.float32)
    amax[3] = 0.0  # a zero tap gets scale 1
    want = jax.jit(jfb.quantize_block_params)(_jax(p), jnp.asarray(amax))
    got = tfb.quantize_block_params(_port(p), torch.from_numpy(amax))
    assert len(got) == len(want) == 18
    codes = {2, 6, 11, 14}  # int8 weights, (out, in) in the port
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = g.numpy() if g.dtype == torch.int8 else _np(g)
        np.testing.assert_array_equal(g, w.T if i in codes else w,
                                      err_msg=f"entry {i}")
    assert float(got[17][3]) == 1.0


# ------------------------------------------------- quantized products


def _off_boundary_rows(rs, m, k, zero_row=True):
    """(m, k) float32 rows whose values divided by their row scale sit
    at least 0.2 away from a .5 rounding boundary; one element per row is
    the row's abs-max. With ``zero_row`` row 0 is all zero (scale 1)."""
    s = np.exp(rs.uniform(-4, 1, (m, 1))).astype(np.float32)
    codes = rs.integers(-120, 121, (m, k)).astype(np.float32)
    frac = rs.uniform(-0.3, 0.3, (m, k)).astype(np.float32)
    y = ((codes + frac) * s).astype(np.float32)
    y[:, 0] = 127 * s[:, 0] * np.where(rs.random(m) < 0.5, -1, 1)
    if zero_row:
        y[0] = 0
    return y


@pytest.mark.parametrize("k", [64, 256])
def test_qdot_dynamic_bit_exact(k):
    """``_qdot``: row scales, codes, the exact s32 sums and the
    dequantization (acc · s_row · s_w) equal the JAX package's bit for bit;
    row 0 is all zero (row scale 1)."""
    rs = np.random.default_rng(k)
    y = _off_boundary_rows(rs, 40, k)
    w = (rs.standard_normal((k, 96)) * 0.05).astype(np.float32)
    wq, sw = jax.jit(jfb.quantize_weight)(jnp.asarray(w))
    want = np.asarray(jax.jit(jfb._qdot)(jnp.asarray(y), wq, sw))
    got = tfb._qdot(torch.from_numpy(y),
                    torch.from_numpy(np.asarray(wq).T.copy()),
                    torch.from_numpy(np.array(sw)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[0].any()


@pytest.mark.parametrize("k", [64, 256])
def test_qdot_static_bit_exact(k):
    """``_qdot_static``: codes round(y · (1/s)), saturating at ±127 for
    values beyond the calibrated range, dequantized as acc · (s · s_w)."""
    rs = np.random.default_rng(100 + k)
    s = np.float32(0.013)
    codes = rs.integers(-140, 141, (40, k)).astype(np.float32)
    y = ((codes + rs.uniform(-0.3, 0.3, codes.shape)) * s).astype(np.float32)
    w = (rs.standard_normal((k, 96)) * 0.05).astype(np.float32)
    wq, sw = jax.jit(jfb.quantize_weight)(jnp.asarray(w))
    want = np.asarray(jax.jit(jfb._qdot_static)(jnp.asarray(y), wq, sw,
                                                jnp.float32(s)))
    got = tfb._qdot_static(torch.from_numpy(y),
                           torch.from_numpy(np.asarray(wq).T.copy()),
                           torch.from_numpy(np.array(sw)),
                           torch.tensor(s))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------- whole block


@pytest.mark.parametrize("n", [48, 49])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_block_ref_q8_f32_matches_jax(n, static):
    rs = np.random.default_rng(n)
    p = _params(rs, n)
    x = rs.standard_normal((B, n, C)).astype(np.float32)
    amax_j = _jax_amax(jnp.asarray(x), _jax(p))[1] if static else None
    qp_j = jax.jit(jfb.quantize_block_params)(_jax(p), amax_j)
    want = np.asarray(jax.jit(_jax_block_q8)(jnp.asarray(x), qp_j))
    amax_t = tfb.block_act_amax(torch.from_numpy(x), _port(p), HEADS)[1] \
        if static else None
    got = tfb.block_ref_q8(torch.from_numpy(x),
                           tfb.quantize_block_params(_port(p), amax_t), HEADS)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_block_ref_q8_bf16_close_to_jax(static):
    n = 48
    rs = np.random.default_rng(7)
    p = _params(rs, n, jnp.bfloat16)
    x = rs.standard_normal((B, n, C)).astype(jnp.bfloat16)
    amax_j = _jax_amax(jnp.asarray(x), _jax(p))[1] if static else None
    qp_j = jax.jit(jfb.quantize_block_params)(_jax(p), amax_j)
    want = np.asarray(jax.jit(_jax_block_q8)(jnp.asarray(x), qp_j),
                      np.float32)
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    amax_t = tfb.block_act_amax(xt, _port(p), HEADS)[1] if static else None
    got = tfb.block_ref_q8(xt, tfb.quantize_block_params(_port(p), amax_t),
                           HEADS)
    assert got.dtype == torch.bfloat16
    err = np.abs(_np(got) - want).max() / np.abs(want).max()
    assert err <= BF16_TOL, err


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_chain_ref_q8_matches_jax(static):
    """Three blocks back to back, each with its own calibration when
    static (the JAX chain kernel runs ``_block_math_q8`` per block). Held
    to ``CHAIN_TOL`` of the largest output: a code that flips in block 0
    is carried, and grows, through the next two (measured: 1.4e-3 static,
    1.2e-7 dynamic)."""
    n = 48
    rs = np.random.default_rng(11)
    ps = [_params(rs, n) for _ in range(3)]
    x = rs.standard_normal((B, n, C)).astype(np.float32)
    want, qps_t = jnp.asarray(x), []
    for p in ps:
        amax = _jax_amax(want, _jax(p))[1] if static else None
        qp = jax.jit(jfb.quantize_block_params)(_jax(p), amax)
        qps_t.append(tfb.quantize_block_params(
            _port(p), torch.from_numpy(np.array(amax)) if static else None))
        want = jax.jit(_jax_block_q8)(want, qp)
    got = tfb.chain_ref_q8(torch.from_numpy(x), qps_t, HEADS).numpy()
    want = np.asarray(want)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= CHAIN_TOL, err


@pytest.mark.parametrize("n", [12, 49])
def test_block_act_amax_matches_jax(n):
    """The calibration forward: output and the seven abs-max taps within
    1e-5 (the same float32 operations, summed in other orders)."""
    rs = np.random.default_rng(20 + n)
    p = _params(rs, n)
    x = rs.standard_normal((B, n, C)).astype(np.float32)
    out_j, amax_j = _jax_amax(jnp.asarray(x), _jax(p))
    out_t, amax_t = tfb.block_act_amax(torch.from_numpy(x), _port(p), HEADS)
    assert amax_t.shape == (7,) and amax_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(amax_t.numpy(), np.asarray(amax_j), rtol=1e-5)


def test_cpu_dispatch_runs_the_plain_version():
    """On CPU tensors the K4 wrappers run their plain versions and count no
    launch."""
    rs = np.random.default_rng(3)
    ps = [tfb.quantize_block_params(_port(_params(rs, 12))) for _ in range(2)]
    x = torch.from_numpy(rs.standard_normal((2, 12, C)).astype(np.float32))
    before = (tfb.fused_block_q8.launches, tfb.fused_block_chain_q8.launches)
    torch.testing.assert_close(tfb.fused_block_q8(x, ps[0], HEADS),
                               tfb.block_ref_q8(x, ps[0], HEADS),
                               rtol=0, atol=0)
    torch.testing.assert_close(tfb.fused_block_chain_q8(x, ps, HEADS),
                               tfb.chain_ref_q8(x, ps, HEADS), rtol=0, atol=0)
    assert (tfb.fused_block_q8.launches,
            tfb.fused_block_chain_q8.launches) == before
