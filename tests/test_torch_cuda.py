"""CUDA kernels of the PyTorch port against their plain versions, on the
card. Every test here is marked ``cuda`` and skips without a card.

The file imports no JAX, so it also runs where JAX is not installed:
``python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py``.

Tolerances: the gather is a copy (bit-exact); the block kernels are held to
2e-2 of the plain version's largest magnitude — bf16 keeps 8 significant
bits and the two sides sum the products in other orders, so single
roundings can differ by one ulp and carry through the block. The w8a8
kernels are held to the same: their s32 sums are exact, but an f32
LayerNorm or GELU output one ulp apart can flip an int8 code on a rounding
boundary, one quant step. The output keeps the residual input, which
dominates its largest magnitude, so the RMS error of the block's own
contribution (out - x) over that contribution's RMS is held too: to 1e-2
for one block and 2.5e-2 for a stage, which a bias of the block left out
exceeds. The saved-probs attention (K6): its output to 2e-2 of max|plain|
(the block's bound), its bf16 probabilities, which lie in [0, 1], to 1e-2
absolute (a few bf16 ulps at 1), and the gradients of qkv and of the bias
through the autograd function, on the kernel's forward against the plain
one, to 2e-2 of their largest magnitude (the backward is the same code; a
probability one bf16 ulp apart moves its products by that ulp). The
inference attention kernels K7 and K8: their output to 2e-2 of
max|plain|, as K6's, and K7's gradients through its autograd function
(the float32 recompute backward, identical on both sides) on the kernel's
forward against the plain one, the same.
"""

import numpy as np
import pytest
import torch

from deepmerge_tpu_torch.ops.kernels import fused_attention as fa
from deepmerge_tpu_torch.ops.kernels.fused_block import (
    block_act_amax,
    block_ref,
    block_ref_q8,
    chain_ref,
    chain_ref_q8,
    fused_block,
    fused_block_chain,
    fused_block_chain_q8,
    fused_block_q8,
    quantize_block_params,
)
from deepmerge_tpu_torch.ops.kernels.window_gather import (
    gather_windows,
    gather_windows_ref,
)

pytestmark = pytest.mark.cuda
BLOCK_TOL = 2e-2
BLOCK_RMS_TOL = 1e-2
CHAIN_RMS_TOL = 2.5e-2
PROBS_TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel_err(got, want):
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def _contribution_rms_err(got, want, x):
    """RMS error of a block's contribution ``want - x`` over its RMS."""
    d = got.float() - want.float()
    contrib = want.float() - x.float()
    return float(d.pow(2).mean().sqrt() / contrib.pow(2).mean().sqrt())


def _assert_block_close(got, want, x, tol, rms_tol):
    assert _rel_err(got, want) <= tol
    assert _contribution_rms_err(got, want, x) <= rms_tol


@pytest.mark.parametrize("rows,cols,align", [(160, 640, 128), (33, 71, 1)])
def test_gather_matches_plain(cuda, rows, cols, align):
    g = torch.Generator().manual_seed(0)
    scene = torch.randint(0, 256, (400, 1216), dtype=torch.uint8, generator=g)
    n = 37
    ys = torch.randint(0, 400 - rows + 1, (n,), generator=g)
    xs = torch.randint(0, (1216 - cols) // align + 1, (n,), generator=g) * align
    starts = torch.stack([ys, xs], 1).to(torch.int32)
    s_dev, st_dev = scene.to(cuda), starts.to(cuda)
    before = gather_windows.launches
    got = gather_windows(s_dev, st_dev, rows, cols)
    torch.cuda.synchronize()
    assert gather_windows.launches == before + 1
    torch.testing.assert_close(got.cpu(), gather_windows_ref(scene, starts,
                                                             rows, cols),
                               rtol=0, atol=0)


def test_gather_rejects_out_of_bounds(cuda):
    scene = torch.zeros((64, 256), dtype=torch.uint8, device=cuda)
    starts = torch.tensor([[40, 0]], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="out of bounds"):
        gather_windows(scene, starts, 32, 128)


def _block_params(rs, n, c, heads, hidden, device):
    r = lambda *shape, s=0.05: torch.from_numpy(
        (rs.standard_normal(shape) * s).astype(np.float32))
    f32 = lambda t: t.to(device)
    bf = lambda t: t.to(device, torch.bfloat16)
    return (
        f32(1.0 + r(c)), f32(r(c)),
        bf(r(3 * c, c)), bf(r(3 * c)),
        f32(r(heads, n, n, s=0.5)),
        bf(r(c, c)), bf(r(c)),
        f32(1.0 + r(c)), f32(r(c)),
        bf(r(hidden, c)), bf(r(hidden)),
        bf(r(c, hidden)), bf(r(c)),
    )


@pytest.mark.parametrize("n", [12, 49, 192, 13, 193, 256])
def test_block_matches_plain(cuda, n):
    rs = np.random.default_rng(n)
    c, heads, hidden, b = 128, 2, 512, 5
    params = _block_params(rs, n, c, heads, hidden, cuda)
    x = torch.from_numpy(rs.standard_normal((b, n, c)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    before = fused_block.launches
    got = fused_block(x, params, heads)
    torch.cuda.synchronize()
    assert fused_block.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _assert_block_close(got, block_ref(x, params, heads), x, BLOCK_TOL,
                        BLOCK_RMS_TOL)


def test_chain_matches_plain(cuda):
    rs = np.random.default_rng(1)
    c, heads, hidden, b, n = 128, 2, 512, 3, 48
    plist = [_block_params(rs, n, c, heads, hidden, cuda) for _ in range(3)]
    x = torch.from_numpy(rs.standard_normal((b, n, c)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    x_before = x.clone()
    got = fused_block_chain(x, plist, heads)
    torch.cuda.synchronize()
    torch.testing.assert_close(x, x_before, rtol=0, atol=0)  # input intact
    _assert_block_close(got, chain_ref(x, plist, heads), x, 1.5 * BLOCK_TOL,
                        CHAIN_RMS_TOL)


def test_block_rejects_what_the_kernel_does_not_take(cuda):
    rs = np.random.default_rng(2)
    params = _block_params(rs, 12, 128, 2, 512, cuda)
    x = torch.zeros((2, 12, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fused_block(x.float(), params, 2)
    with pytest.raises(NotImplementedError):
        fused_block(x, params, 2, exact_gelu=True)
    with pytest.raises(ValueError, match="heads"):
        fused_block(x, params, 4)  # head width 32
    with pytest.raises(ValueError, match="parameter 2"):
        fused_block(x, params[:2] + (params[2].float(),) + params[3:], 2)


def _q8_inputs(rs, b, n, depth, static, cuda, c=128, heads=2, hidden=512):
    """bf16 activations and ``depth`` w8a8 parameter tuples on the card;
    with ``static`` each block is calibrated on its own plain input."""
    x = torch.from_numpy(rs.standard_normal((b, n, c)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    qps, h = [], x
    for _ in range(depth):
        p = _block_params(rs, n, c, heads, hidden, cuda)
        amax = block_act_amax(h, p, heads)[1] if static else None
        qp = quantize_block_params(p, amax)
        h = block_ref_q8(h, qp, heads).to(x.dtype)
        qps.append(tuple(t.contiguous() for t in qp))
    return x, qps, heads


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("n", [12, 49, 192, 193])
def test_q8_block_matches_plain(cuda, n, static):
    rs = np.random.default_rng(n)
    x, (qp,), heads = _q8_inputs(rs, 5, n, 1, static, cuda)
    assert len(qp) == (18 if static else 17)
    before = fused_block_q8.launches
    got = fused_block_q8(x, qp, heads)
    torch.cuda.synchronize()
    assert fused_block_q8.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _assert_block_close(got, block_ref_q8(x, qp, heads), x, BLOCK_TOL,
                        BLOCK_RMS_TOL)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_q8_chain_matches_plain(cuda, static):
    rs = np.random.default_rng(3)
    x, qps, heads = _q8_inputs(rs, 3, 48, 3, static, cuda)
    x_before = x.clone()
    before = fused_block_chain_q8.launches
    got = fused_block_chain_q8(x, qps, heads)
    torch.cuda.synchronize()
    assert fused_block_chain_q8.launches == before + 1
    torch.testing.assert_close(x, x_before, rtol=0, atol=0)  # input intact
    _assert_block_close(got, chain_ref_q8(x, qps, heads), x,
                        1.5 * BLOCK_TOL, CHAIN_RMS_TOL)


def test_q8_block_zero_row(cuda):
    """A token whose LayerNorm output is all zero (constant input row, zero
    LN bias) quantizes with row scale 1 to all-zero codes."""
    rs = np.random.default_rng(4)
    p = list(_block_params(rs, 12, 128, 2, 512, cuda))
    p[1] = torch.zeros_like(p[1])
    qp = quantize_block_params(tuple(p))
    x = torch.from_numpy(rs.standard_normal((2, 12, 128)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    x[0, 3] = 0.5
    got = fused_block_q8(x, qp, 2)
    want = block_ref_q8(x, qp, 2)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    _assert_block_close(got, want, x, BLOCK_TOL, BLOCK_RMS_TOL)


def test_q8_block_rejects_what_the_kernel_does_not_take(cuda):
    rs = np.random.default_rng(5)
    x, (qp,), heads = _q8_inputs(rs, 2, 12, 1, False, cuda)
    with pytest.raises(TypeError):
        fused_block_q8(x.float(), qp, heads)
    with pytest.raises(ValueError, match="17 or 18"):
        fused_block_q8(x, qp[:16], heads)
    with pytest.raises(ValueError, match="parameter 2"):
        fused_block_q8(x, qp[:2] + (qp[2].float(),) + qp[3:], heads)
    x64, (qp64,), h64 = _q8_inputs(rs, 2, 12, 1, False, cuda, c=64, heads=1,
                                   hidden=256)
    with pytest.raises(ValueError, match="multiple of 128"):
        fused_block_q8(x64, qp64, h64)


def _attention_inputs(rs, b, n, heads, cuda):
    c = heads * 64
    qkv = torch.from_numpy(rs.standard_normal((b, n, 3 * c)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    bias = torch.from_numpy((rs.standard_normal((heads, n, n)) * 0.5).astype(
        np.float32)).to(cuda)
    return qkv, bias


@pytest.mark.parametrize("n", [12, 48, 192, 13, 193, 256])
def test_attention_probs_matches_plain(cuda, n):
    rs = np.random.default_rng(n)
    qkv, bias = _attention_inputs(rs, 6, n, 3, cuda)
    before = fa.attention_probs.launches
    out, probs = fa.attention_probs(qkv, bias, 3)
    torch.cuda.synchronize()
    assert fa.attention_probs.launches == before + 1
    assert out.dtype == probs.dtype == torch.bfloat16
    assert out.shape == (6, n, 192) and probs.shape == (6, 3, n, n)
    want_out, want_probs = fa.attention_probs_ref(qkv, bias, 3)
    assert _rel_err(out, want_out) <= BLOCK_TOL
    assert float((probs.float() - want_probs.float()).abs().max()) <= PROBS_TOL


def test_attention_train_backward_matches_plain(cuda, monkeypatch):
    """dqkv and dbias through ``fused_attention_train`` with the kernel's
    forward, against the same function with the plain forward."""
    rs = np.random.default_rng(7)
    qkv, bias = _attention_inputs(rs, 4, 48, 2, cuda)
    g = torch.from_numpy(rs.standard_normal((4, 48, 128)).astype(
        np.float32)).to(cuda, torch.bfloat16)

    def grads():
        q = qkv.clone().requires_grad_(True)
        b = bias.clone().requires_grad_(True)
        fa.fused_attention_train(q, b, 2).backward(g)
        return q.grad, b.grad

    got = grads()
    monkeypatch.setattr(fa, "attention_probs", fa.attention_probs_ref)
    want = grads()
    torch.cuda.synchronize()
    for gg, w in zip(got, want):
        assert _rel_err(gg, w) <= BLOCK_TOL


def test_attention_probs_rejects_what_the_kernel_does_not_take(cuda):
    rs = np.random.default_rng(8)
    qkv, bias = _attention_inputs(rs, 2, 12, 2, cuda)
    with pytest.raises(TypeError):
        fa.attention_probs(qkv.float(), bias, 2)
    with pytest.raises(ValueError, match="heads"):
        fa.attention_probs(qkv, bias, 4)  # head width 32
    with pytest.raises(ValueError, match="bias"):
        fa.attention_probs(qkv, bias.to(torch.bfloat16), 2)
    q257, b257 = _attention_inputs(rs, 2, 257, 2, cuda)
    with pytest.raises(ValueError, match="tokens"):
        fa.attention_probs(q257, b257, 2)


@pytest.mark.parametrize("n", [12, 49, 192, 13, 193, 256])
def test_attention_qkv_matches_plain(cuda, n):
    """K7 at v3's, v5's and v1's (256) sequence lengths."""
    rs = np.random.default_rng(n + 1)
    qkv, bias = _attention_inputs(rs, 5, n, 3, cuda)
    before = fa.attention_qkv.launches
    out = fa.attention_qkv(qkv, bias, 3)
    torch.cuda.synchronize()
    assert fa.attention_qkv.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (5, n, 192)
    assert _rel_err(out, fa.attention_qkv_ref(qkv, bias, 3)) <= BLOCK_TOL


@pytest.mark.parametrize("n", [12, 193, 256])
def test_attention_bnhd_matches_plain(cuda, n):
    rs = np.random.default_rng(n + 2)
    qkv, bias = _attention_inputs(rs, 5, n, 3, cuda)
    q, k, v = (t.contiguous() for t in fa.split_qkv(qkv, 3))
    before = fa.attention_bnhd.launches
    out = fa.attention_bnhd(q, k, v, bias)
    torch.cuda.synchronize()
    assert fa.attention_bnhd.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (5, n, 3, 64)
    assert _rel_err(out, fa.attention_bnhd_ref(q, k, v, bias)) <= BLOCK_TOL


def test_attention_qkv_backward_matches_plain(cuda, monkeypatch):
    rs = np.random.default_rng(9)
    qkv, bias = _attention_inputs(rs, 4, 49, 2, cuda)
    g = torch.from_numpy(rs.standard_normal((4, 49, 128)).astype(
        np.float32)).to(cuda, torch.bfloat16)

    def grads():
        q = qkv.clone().requires_grad_(True)
        b = bias.clone().requires_grad_(True)
        fa.fused_attention_qkv(q, b, 2).backward(g)
        return q.grad, b.grad

    got = grads()
    monkeypatch.setattr(fa, "attention_qkv", fa.attention_qkv_ref)
    want = grads()
    torch.cuda.synchronize()
    for gg, w in zip(got, want):
        assert _rel_err(gg, w) <= BLOCK_TOL


def test_attention_kernels_reject_what_they_do_not_take(cuda):
    rs = np.random.default_rng(10)
    qkv, bias = _attention_inputs(rs, 2, 12, 2, cuda)
    with pytest.raises(TypeError):
        fa.attention_qkv(qkv.float(), bias, 2)
    q, k, v = (t.contiguous() for t in fa.split_qkv(qkv, 2))
    with pytest.raises(TypeError):
        fa.attention_bnhd(q, k, v.float(), bias)
    with pytest.raises(ValueError, match="bias"):
        fa.attention_bnhd(q, k, v, bias[:1])
    q257, b257 = _attention_inputs(rs, 2, 257, 2, cuda)
    with pytest.raises(ValueError, match="tokens"):
        fa.attention_qkv(q257, b257, 2)
