"""The inference attention kernels K7 (packed qkv) and K8 ((B, N, H, D)
q, k, v) of the PyTorch port against the JAX package, on the CPU: the plain
versions against ``fused_attention_qkv`` (``packed_pv`` off and on) and
``fused_attention`` run as the JAX package's own tests run them (the Pallas
kernels in interpret mode), and the gradients through the port's autograd
functions against ``jax.vjp`` of the same functions, at v3's and v5's
sequence lengths.

Tolerances, relative to max|JAX| (measured in brackets):
* forward float32: 1e-5 — the same float32 operations summed in other
  orders [≤ 6.4e-7]; bfloat16: 2e-2 — both sides round q·d^-½, the
  numerators and the output to bf16 at the same points, and a float32 sum
  in another order can round one of them the other way [≤ 1.1e-3].
* gradients float32: 1e-5 — both backward passes recompute the attention
  in float32 [≤ 8e-7].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu.ops.pallas.fused_attention import (
    fused_attention as jax_fused_attention,
)
from deepmerge_tpu.ops.pallas.fused_attention import fused_attention_qkv
from deepmerge_tpu_torch.ops.kernels import fused_attention as fa

HEADS, D, B = 2, 64, 3
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = 1e-5
TOKENS = (12, 49, 193)


def _inputs(n, seed):
    rs = np.random.default_rng(seed)
    c = HEADS * D
    qkv = rs.standard_normal((B, n, 3 * c)).astype(np.float32)
    bias = (rs.standard_normal((HEADS, n, n)) * 0.5).astype(np.float32)
    g = rs.standard_normal((B, n, c)).astype(np.float32)
    return qkv, bias, g


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def _bnhd(qkv):
    b, n, c3 = qkv.shape
    return [qkv[..., i * c3 // 3 : (i + 1) * c3 // 3].reshape(b, n, HEADS, D)
            for i in range(3)]


@pytest.mark.parametrize("packed", [False, True], ids=["k7", "k7-packed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", TOKENS)
def test_qkv_forward_matches_pallas(n, dtype, packed):
    qkv, bias, _ = _inputs(n, n)
    want = fused_attention_qkv(jnp.asarray(qkv).astype(dtype),
                               jnp.asarray(bias), HEADS, interpret=True,
                               packed_pv=packed)
    got = fa.fused_attention_qkv(_t(qkv, dtype), _t(bias), HEADS,
                                 packed_pv=packed)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (B, n, HEADS * D)
    assert _rel(got.float().numpy(), _np(want)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", TOKENS)
def test_bnhd_forward_matches_pallas(n, dtype):
    qkv, bias, _ = _inputs(n, n + 2)
    q, k, v = _bnhd(qkv)
    want = jax_fused_attention(*(jnp.asarray(t).astype(dtype)
                                 for t in (q, k, v)),
                               jnp.asarray(bias), interpret=True)
    got = fa.fused_attention(*(_t(t, dtype) for t in (q, k, v)), _t(bias))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (B, n, HEADS, D)
    assert _rel(got.float().numpy(), _np(want)) <= TOL[dtype]


@pytest.mark.parametrize("n", TOKENS)
def test_qkv_gradients_match_jax(n):
    """dqkv and dbias through ``fused_attention_qkv`` (``_fused_qkv_bwd``:
    the float32 recompute) against ``jax.vjp``."""
    qkv, bias, g = _inputs(n, n + 1)
    _, vjp = jax.vjp(
        lambda x, b: fused_attention_qkv(x, b, HEADS, interpret=True),
        jnp.asarray(qkv), jnp.asarray(bias))
    j_dqkv, j_dbias = vjp(jnp.asarray(g))
    tq = _t(qkv).requires_grad_(True)
    tb = _t(bias).requires_grad_(True)
    fa.fused_attention_qkv(tq, tb, HEADS).backward(_t(g))
    assert _rel(tq.grad.numpy(), np.asarray(j_dqkv)) <= GRAD_TOL
    assert _rel(tb.grad.numpy(), np.asarray(j_dbias)) <= GRAD_TOL


@pytest.mark.parametrize("n", TOKENS)
def test_bnhd_gradients_match_jax(n):
    """dq, dk, dv and dbias through ``fused_attention``
    (``_fused_attention_bwd``) against ``jax.vjp``."""
    qkv, bias, g = _inputs(n, n + 3)
    q, k, v = _bnhd(qkv)
    _, vjp = jax.vjp(
        lambda *a: jax_fused_attention(*a, interpret=True),
        *(jnp.asarray(t) for t in (q, k, v, bias)))
    want = vjp(jnp.asarray(g.reshape(B, n, HEADS, D)))
    ts = [_t(t).requires_grad_(True) for t in (q, k, v, bias)]
    fa.fused_attention(*ts).backward(_t(g.reshape(B, n, HEADS, D)))
    for t, w in zip(ts, want):
        assert t.grad.dtype == torch.float32
        assert _rel(t.grad.numpy(), np.asarray(w)) <= GRAD_TOL


def test_bf16_gradients_keep_the_input_dtypes():
    qkv, bias, g = _inputs(12, 4)
    tq = _t(qkv, "bfloat16").requires_grad_(True)
    tb = _t(bias).requires_grad_(True)
    fa.fused_attention_qkv(tq, tb, HEADS).backward(_t(g, "bfloat16"))
    assert tq.grad.dtype == torch.bfloat16 and tb.grad.dtype == torch.float32
    assert torch.isfinite(tq.grad.float()).all()


def test_cpu_wrappers_run_the_plain_versions():
    """On CPU tensors the K7 and K8 wrappers return their plain versions'
    results and count no launch; ``packed_pv`` needs an even head count."""
    qkv, bias, _ = _inputs(49, 5)
    q, k, v = (_t(t) for t in _bnhd(qkv))
    before = (fa.attention_qkv.launches, fa.attention_bnhd.launches)
    torch.testing.assert_close(
        fa.attention_qkv(_t(qkv), _t(bias), HEADS),
        fa.attention_qkv_ref(_t(qkv), _t(bias), HEADS), rtol=0, atol=0)
    torch.testing.assert_close(fa.attention_bnhd(q, k, v, _t(bias)),
                               fa.attention_bnhd_ref(q, k, v, _t(bias)),
                               rtol=0, atol=0)
    assert (fa.attention_qkv.launches, fa.attention_bnhd.launches) == before
    with pytest.raises(ValueError, match="even"):
        fa.fused_attention_qkv(_t(qkv[..., : 3 * D]), _t(bias[:1]), 1,
                               packed_pv=True)
