"""The saved-probs training attention (K6) of the PyTorch port against the
JAX package, on the CPU: the port's plain version against
``fused_attention_qkv(..., save_probs=True, interpret=True)`` (the Pallas
kernel in interpret mode), forward and, through ``jax.vjp`` and torch
autograd, backward, in float32 and bfloat16, at the three sequence lengths
of the v3 stages.

Tolerances (measured in brackets):
* ``out``: float32 within 1e-5 of max|out| — the same float32 operations
  summed in other orders [≤ 5e-7]; bfloat16 within 2^-8 of max|out| — one
  bf16 rounding of the output can land the other way [≤ 1.1e-3].
* ``probs`` (bf16 on both sides): each value within one bf16 ulp of
  JAX's (at most 2^-7 of the value), and at least 99.9% of them
  bit-equal: a float32 e·(1/Σe) summed in another order can round to the
  neighbouring bf16 [max |Δ| 6.1e-5, ≥ 99.99% equal].
* ``dqkv`` and ``dbias``: every product of the backward takes bf16
  operands on both sides and sums in float32; a probability or a dlogits
  that rounds to the other bf16 moves its products by one ulp. dqkv within
  1e-3 (float32) or 1e-2 (bfloat16, whose dqkv is itself rounded to bf16)
  of max|dqkv| and its RMS error within 1e-4 of its RMS; dbias within 1e-3
  of max|dbias| [dqkv ≤ 2e-4 / 2e-3, RMS ≤ 4.3e-5; dbias ≤ 1.4e-4].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu.ops.pallas.fused_attention import (
    _fused_qkv_probs_forward,
    fused_attention_qkv,
)
from deepmerge_tpu_torch.ops.kernels import fused_attention as fa

HEADS, D, B = 2, 64, 3
OUT_TOL = {"float32": 1e-5, "bfloat16": 2 ** -8}
DQKV_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
DQKV_RMS_TOL = 1e-4
DBIAS_TOL = 1e-3
BF16_ULP = 2 ** -7  # one bf16 ulp, relative to the value, at most


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [12, 48, 192])
def test_probs_forward_matches_pallas(dtype, n):
    qkv, bias, _ = _inputs(n, n)
    j_out, j_probs = _fused_qkv_probs_forward(
        jnp.asarray(qkv).astype(dtype), jnp.asarray(bias), HEADS, 8, True)
    t_out, t_probs = fa.attention_probs_ref(
        torch.from_numpy(qkv).to(getattr(torch, dtype)),
        torch.from_numpy(bias), HEADS)
    assert t_out.dtype == getattr(torch, dtype)
    assert t_probs.dtype == torch.bfloat16
    assert tuple(t_probs.shape) == (B, HEADS, n, n)
    assert _rel(t_out.float().numpy(), _np(j_out)) <= OUT_TOL[dtype]
    got, want = t_probs.float().numpy(), _np(j_probs)
    np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-12)
    assert (got == want).mean() >= 0.999
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=0.02)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [12, 48, 192])
def test_train_vjp_matches_jax(dtype, n):
    """The port's autograd (plain forward, ``attention_probs_bwd``) against
    ``jax.vjp`` of the JAX package's training attention."""
    qkv, bias, g = _inputs(n, n + 1)
    jq = jnp.asarray(qkv).astype(dtype)
    out, vjp = jax.vjp(
        lambda q, b: fused_attention_qkv(q, b, HEADS, interpret=True,
                                         save_probs=True),
        jq, jnp.asarray(bias))
    j_dqkv, j_dbias = vjp(jnp.asarray(g).astype(dtype))

    tq = torch.from_numpy(qkv).to(getattr(torch, dtype)).requires_grad_(True)
    tb = torch.from_numpy(bias).clone().requires_grad_(True)
    t_out = fa.fused_attention_train(tq, tb, HEADS)
    t_out.backward(torch.from_numpy(g).to(tq.dtype))
    assert _rel(t_out.detach().float().numpy(), _np(out)) <= OUT_TOL[dtype]
    assert tq.grad.dtype == tq.dtype and tb.grad.dtype == torch.float32
    got, want = tq.grad.float().numpy(), _np(j_dqkv)
    assert _rel(got, want) <= DQKV_TOL[dtype]
    rms = np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean())
    assert rms <= DQKV_RMS_TOL
    assert _rel(tb.grad.numpy(), np.asarray(j_dbias)) <= DBIAS_TOL


def test_cpu_wrapper_runs_the_plain_version():
    """On CPU tensors the K6 wrapper returns the plain version's result and
    counts no launch."""
    qkv, bias, _ = _inputs(12, 0)
    before = fa.attention_probs.launches
    got = fa.attention_probs(torch.from_numpy(qkv), torch.from_numpy(bias),
                             HEADS)
    want = fa.attention_probs_ref(torch.from_numpy(qkv),
                                  torch.from_numpy(bias), HEADS)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert fa.attention_probs.launches == before
