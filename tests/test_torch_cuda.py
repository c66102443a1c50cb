"""CUDA kernels of the PyTorch port against their plain versions, on the
card. Every test here is marked ``cuda`` and skips without a card.

The file imports no JAX, so it also runs where JAX is not installed:
``python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py``.

Tolerances: the gather is a copy (bit-exact); the fused patch kernel is
bit-exact too (its row pass is integer-exact, its column pass takes the
plain version's float32 weights, and the uint8 rounding absorbs the order
of their sum); the block kernels are held to
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
forward against the plain one, the same. The int8 attention core of
``w8a8+attn`` (K4a) inside the w8a8 block and chain: as K4 (one flipped
code on a rounding boundary, here also in the attention's q, k, v and
probability codes, one quant step). The training block (K5): its output
and its residual r as a block, its probabilities as K6's, its saved qkv
and pre-GELU activation to 2e-2 of max|plain| (bf16 roundings of the same
sums), and the gradients of x and of every parameter through its autograd
function, kernel forward against plain forward, to 2e-2 of their max. K4's
s8 GEMM alone: bit-identical to its plain version on every epilogue but
the float32 GELU (1e-5 of max|plain|: tanh in another library), whose
int8 codes and row scales are bit-identical to those of its own output;
K4a's core alone as K4a in the block, and bit-identical across its plans.
The label-map lookup (K9) and the int4 dot probe's variants (K10) are
integer functions: bit-exact.
"""

import numpy as np
import pytest
import torch

from deepmerge_tpu_torch.ops.kernels import fused_attention as fa
from deepmerge_tpu_torch.ops.kernels import fused_block as fb
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
from deepmerge_tpu_torch.ops.kernels import int4_dot as i4
from deepmerge_tpu_torch.ops.kernels import label_lookup as ll
from deepmerge_tpu_torch.ops.kernels import patch_resize as pr
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


def _padded_scene(bands, h, w, caps, seed):
    from deepmerge_tpu_torch.ops import patches as tp

    image = torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, (h, w, bands)).astype(np.uint8))
    pad = tp.scene_pad(caps, bands)
    return tp.pad_scene_device(image, pad, tp.staged_channels(bands)), pad


# (bands, width, cap, out, out dtype, load unit): the width sets the row
# pitch, and so which load unit (16, 4 or 1 bytes) the wrapper picks
@pytest.mark.parametrize("bands,w,cap,out,dtype,vec", [
    (3, 300, 128, 128, torch.bfloat16, 16),
    (3, 301, 128, 32, torch.float32, 4),
    (1, 301, 128, 64, torch.bfloat16, 1),
    (5, 200, 256, 16, torch.bfloat16, 16),
    (4, 252, 256, 64, torch.float32, 16),
])
def test_patch_resize_matches_plain(cuda, bands, w, cap, out, dtype, vec):
    padded, pad = _padded_scene(bands, 180, w, (cap,), seed=cap + out)
    rs = np.random.RandomState(out)
    n = 300
    centers = np.stack([rs.randint(0, 180, n), rs.randint(0, w, n)], 1)
    centers[:4] = [[0, 0], [179, w - 1], [0, w - 1], [179, 0]]
    centers = torch.from_numpy(centers.astype(np.int32))
    scales = torch.from_numpy(rs.randint(1, cap + 50, (n, 2)).astype(np.int32))
    scene2d = padded.reshape(padded.shape[0], -1)
    assert pr._load_width(scene2d.to(cuda), (cap + pr.pixel_align(
        padded.shape[-1])) * padded.shape[-1]) == vec
    before = pr.patch_resize.launches
    got = pr.patch_resize(padded.to(cuda), centers.to(cuda),
                          scales[:, 1].to(cuda), cap, out, pad,
                          out_channels=bands, out_dtype=dtype,
                          trusted_origins=True)
    torch.cuda.synchronize()
    assert pr.patch_resize.launches == before + 1
    want = pr.patch_resize_ref(padded, centers, scales[:, 1], cap, out, pad,
                               bands, dtype)
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def test_patch_resize_refuses(cuda, monkeypatch):
    padded, pad = _padded_scene(3, 64, 64, (128,), seed=0)
    centers = torch.tensor([[5, 5]], dtype=torch.int32, device=cuda)
    scales = torch.tensor([20], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="out of bounds"):
        pr.patch_resize(padded.to(cuda), centers - 400, scales, 128, 32, pad)
    with pytest.raises(ValueError, match="contiguous"):
        pr.patch_resize(padded.to(cuda).transpose(0, 1), centers, scales,
                        128, 32, pad)
    plan = pr.patch_resize_plan

    def bad_plan(cap, out, channels):
        p = plan(cap, out, channels)
        tile, threads, smem = p["ints"]
        return dict(p, ints=(tile, threads, smem + 4))

    monkeypatch.setattr(pr, "patch_resize_plan", bad_plan)
    with pytest.raises(RuntimeError, match="dm_patch_resize"):
        pr.patch_resize(padded.to(cuda), centers, scales, 128, 32, pad)


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


def _q8_inputs(rs, b, n, depth, static, cuda, c=128, heads=2, hidden=512,
               quant_attn=False):
    """bf16 activations and ``depth`` w8a8 parameter tuples on the card;
    with ``static`` each block is calibrated on its own plain input (along
    the plain chain with the int8 attention when ``quant_attn``)."""
    x = torch.from_numpy(rs.standard_normal((b, n, c)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    qps, h = [], x
    for _ in range(depth):
        p = _block_params(rs, n, c, heads, hidden, cuda)
        amax = block_act_amax(h, p, heads)[1] if static else None
        qp = quantize_block_params(p, amax)
        h = block_ref_q8(h, qp, heads, quant_attn=quant_attn).to(x.dtype)
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


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("n", [12, 49, 192, 193, 256])
def test_q8_attn_block_matches_plain(cuda, n, static):
    """K4a in the w8a8 block, at v3's, v5's and v1's lengths."""
    rs = np.random.default_rng(n + 40)
    x, (qp,), _ = _q8_inputs(rs, 5, n, 1, static, cuda, quant_attn=True)
    before = (fb.fused_block_q8_attn.launches, fused_block_q8.launches)
    got = fb.fused_block_q8_attn(x, qp, 2)
    torch.cuda.synchronize()
    assert (fb.fused_block_q8_attn.launches,
            fused_block_q8.launches) == (before[0] + 1, before[1])
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _assert_block_close(got, block_ref_q8(x, qp, 2, quant_attn=True), x,
                        BLOCK_TOL, BLOCK_RMS_TOL)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_q8_attn_chain_matches_plain(cuda, static):
    rs = np.random.default_rng(41)
    x, qps, _ = _q8_inputs(rs, 3, 49, 3, static, cuda, quant_attn=True)
    x_before = x.clone()
    before = fb.fused_block_chain_q8_attn.launches
    got = fb.fused_block_chain_q8_attn(x, qps, 2)
    torch.cuda.synchronize()
    assert fb.fused_block_chain_q8_attn.launches == before + 1
    torch.testing.assert_close(x, x_before, rtol=0, atol=0)  # input intact
    _assert_block_close(got, chain_ref_q8(x, qps, 2, quant_attn=True), x,
                        1.5 * BLOCK_TOL, CHAIN_RMS_TOL)


@pytest.mark.parametrize("n", [12, 49, 192, 193, 256])
def test_train_block_matches_plain(cuda, n):
    """K5's output and its four saved residuals."""
    rs = np.random.default_rng(n + 50)
    params = _block_params(rs, n, 128, 2, 512, cuda)
    x = torch.from_numpy(rs.standard_normal((5, n, 128)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    before = fb.fused_block_train.launches
    out, (qkv, probs, gin, r) = fb.fused_block_train(x, params, 2)
    torch.cuda.synchronize()
    assert fb.fused_block_train.launches == before + 1
    want_out, (w_qkv, w_probs, w_gin, w_r) = fb.block_train_ref(x, params, 2)
    assert probs.shape == (5, 2, n, n) and gin.shape == (5, n, 512)
    _assert_block_close(out, want_out, x, BLOCK_TOL, BLOCK_RMS_TOL)
    _assert_block_close(r, w_r, x, BLOCK_TOL, BLOCK_RMS_TOL)
    assert float((probs.float() - w_probs.float()).abs().max()) <= PROBS_TOL
    assert _rel_err(qkv, w_qkv) <= BLOCK_TOL
    assert _rel_err(gin, w_gin) <= BLOCK_TOL


def test_train_block_gradients_match_plain(cuda, monkeypatch):
    """The gradients of x and of every parameter through the
    differentiable block, on K5's forward against the plain one."""
    rs = np.random.default_rng(60)
    params = _block_params(rs, 49, 128, 2, 512, cuda)
    x = torch.from_numpy(rs.standard_normal((4, 49, 128)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    g = torch.from_numpy(rs.standard_normal((4, 49, 128)).astype(
        np.float32)).to(cuda, torch.bfloat16)

    def grads():
        xs = x.clone().requires_grad_(True)
        ps = [t.clone().requires_grad_(True) for t in params]
        fused_block(xs, ps, 2).backward(g)
        return [xs.grad] + [t.grad for t in ps]

    before = fb.fused_block_train.launches
    got = grads()
    assert fb.fused_block_train.launches == before + 1
    monkeypatch.setattr(fb, "fused_block_train", fb.block_train_ref)
    want = grads()
    torch.cuda.synchronize()
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.dtype == w.dtype
        assert _rel_err(a, w) <= BLOCK_TOL, i


# ------------------------------------------- the attention core's four forms

@pytest.mark.parametrize("n", [1, 13, 49, 192, 193, 256])
@pytest.mark.parametrize("form", ["k7", "probs", "norm_first",
                                  "probs_norm_first"])
def test_attention_core_forms_match_plain(cuda, n, form):
    """The core of block_common.cuh in each (kProbs, kNormFirst) form: K7
    (neither), K6 (kProbs), K8 (kNormFirst) and K5's attention (both, seen
    through its saved probabilities and output), at every length class."""
    rs = np.random.default_rng(n + 40)
    if form == "probs_norm_first":
        c, heads = 128, 2
        params = _block_params(rs, n, c, heads, 256, cuda)
        x = torch.from_numpy(rs.standard_normal((3, n, c)).astype(
            np.float32)).to(cuda, torch.bfloat16)
        out, saved = fb.fused_block_train(x, params, heads)
        want_out, want = fb.block_train_ref(x, params, heads)
        torch.cuda.synchronize()
        _assert_block_close(out, want_out, x, BLOCK_TOL, BLOCK_RMS_TOL)
        assert float((saved[1].float() - want[1].float()).abs().max()) \
            <= PROBS_TOL
        return
    qkv, bias = _attention_inputs(rs, 7, n, 3, cuda)
    if form == "k7":
        got, want = (fa.attention_qkv(qkv, bias, 3),
                     fa.attention_qkv_ref(qkv, bias, 3))
    elif form == "probs":
        (got, probs), (want, want_probs) = (
            fa.attention_probs(qkv, bias, 3),
            fa.attention_probs_ref(qkv, bias, 3))
        assert float((probs.float() - want_probs.float()).abs().max()) \
            <= PROBS_TOL
    else:
        q, k, v = (t.contiguous() for t in fa.split_qkv(qkv, 3))
        got, want = (fa.attention_bnhd(q, k, v, bias),
                     fa.attention_bnhd_ref(q, k, v, bias))
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= BLOCK_TOL


@pytest.mark.parametrize("warps,samples", [(4, 1), (12, 1), (4, 3), (8, 2)])
def test_attention_core_plans_agree(cuda, warps, samples):
    """K7 under other launch plans (warps a CTA, samples a CTA, a batch not
    divisible by the samples) computes the same bits as the default plan."""
    rs = np.random.default_rng(warps * 10 + samples)
    qkv, bias = _attention_inputs(rs, 7, 193, 3, cuda)
    plan = fb.attention_plan(7, 193, 3, warps=warps, samples=samples)
    got = fa.attention_qkv(qkv, bias, 3, plan=plan)
    want = fa.attention_qkv(qkv, bias, 3)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ------------------------------------------------------------ K2's GEMM

@pytest.mark.parametrize("epilogue", fb.GEMM_EPILOGUES)
def test_gemm_epilogues_match_plain(cuda, epilogue):
    """The wgmma GEMM with each epilogue at a ragged M (rows past the last
    128-row tile masked), against its plain version: the bf16 roundings at
    the same points, the f32 sums in another order."""
    rs = np.random.default_rng(len(epilogue))
    m, n, k = 197, 384, 192
    r = lambda *shape, s=1.0: torch.from_numpy(
        (rs.standard_normal(shape) * s).astype(np.float32)).to(
            cuda, torch.bfloat16)
    a, w, bias = r(m, k), r(n, k, s=0.1), r(n, s=0.1)
    resid = r(m, n) if epilogue == "bias_residual" else None
    before = fb.gemm.launches
    out, aux = fb.gemm(a, w, bias, epilogue, resid)
    torch.cuda.synchronize()
    assert fb.gemm.launches == before + 1
    want, want_aux = fb.gemm_ref(a, w, bias, epilogue, resid)
    assert out.shape == (m, n) and _rel_err(out, want) <= BLOCK_TOL
    if epilogue == "bias_gelu_save":
        assert _rel_err(aux, want_aux) <= BLOCK_TOL
    else:
        assert aux is None


def test_gemm_rejects_what_the_kernel_does_not_take(cuda):
    a = torch.zeros((64, 96), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((128, 96), dtype=torch.bfloat16, device=cuda)
    bias = torch.zeros((128,), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="K % 64"):
        fb.gemm(a, w, bias, "bias_cast")
    a = torch.zeros((64 * 128 + 1,), dtype=torch.bfloat16,
                    device=cuda)[1:].view(64, 128)  # 2 bytes off: no TMA base
    w = torch.zeros((128, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):
        fb.gemm(a, w, bias, "bias_cast")
    with pytest.raises(ValueError, match="residual"):
        fb.gemm(a.clone(), w, bias, "bias_residual")


# ---------------------------------------------- K4's s8 GEMM, K4a's core

@pytest.mark.parametrize("epilogue", fb.GEMM_Q8_EPILOGUES)
def test_gemm_q8_epilogues_match_plain(cuda, epilogue):
    """The s8 wgmma GEMM with each epilogue at a ragged M
    (rows past the last tile masked), dynamic row scales and a static
    scale, against its plain version: bit-identical but for the float32
    GELU (tanh in another library), whose codes and row scales are those
    of its own output."""
    rs = np.random.default_rng(len(epilogue))
    m, n, k = 197, 384, 256
    codes = lambda *shape: torch.from_numpy(
        rs.integers(-127, 128, shape, dtype=np.int8)).to(cuda)
    a, w = codes(m, k), codes(n, k)
    ws = torch.from_numpy(rs.uniform(3e-4, 9e-4, n).astype(np.float32)).to(
        cuda)
    bias = torch.from_numpy(rs.standard_normal(n).astype(np.float32)).to(
        cuda, torch.bfloat16)
    kw = {}
    if epilogue == "bias_residual":
        kw["resid"] = torch.from_numpy(rs.standard_normal((m, n)).astype(
            np.float32)).to(cuda, torch.bfloat16)
    if epilogue == "bias_gelu_codes":
        kw["out_scale"] = torch.tensor([0.02], device=cuda)
    for scale in (dict(row_scale=torch.from_numpy(rs.uniform(
            0.01, 0.05, m).astype(np.float32)).to(cuda)),
                  dict(static_scale=torch.tensor([0.03], device=cuda))):
        before = fb.gemm_q8.launches
        got, aux = fb.gemm_q8(a, w, ws, bias, epilogue, **scale, **kw)
        torch.cuda.synchronize()
        assert fb.gemm_q8.launches == before + 1
        want, _ = fb.gemm_q8_ref(a, w, ws, bias, epilogue, **scale, **kw)
        if epilogue == "bias_gelu":
            assert _rel_err(got, want) <= 1e-5
            codes_ref, scales_ref = fb.quantize_rows(got)
            assert torch.equal(aux[0], codes_ref)
            assert torch.equal(aux[1], scales_ref)
        else:
            assert torch.equal(got, want)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("n", [12, 13, 48, 49, 192, 193, 256])
def test_attention_q8_matches_plain(cuda, n, static):
    """K4a's int8 core alone against its plain version (the block's bound:
    a code one apart on a rounding boundary moves a row by a quant
    step)."""
    rs = np.random.default_rng(n + 90)
    qkv, bias = _attention_inputs(rs, 5, n, 3, cuda)
    st = None
    if static:
        st = torch.stack([qkv[..., i * 192:(i + 1) * 192].float().abs().max()
                          * 0.8 / 127 for i in range(3)]).contiguous()
    before = fb.attention_q8.launches
    got = fb.attention_q8(qkv, bias, 3, static=st)
    torch.cuda.synchronize()
    assert fb.attention_q8.launches == before + 1
    want = fb.attention_q8_ref(qkv, bias, 3, st)
    assert got.dtype == torch.bfloat16 and _rel_err(got, want) <= BLOCK_TOL


@pytest.mark.parametrize("warps,samples", [(2, 1), (4, 3), (8, 2)])
def test_attention_q8_plans_agree(cuda, warps, samples):
    """K4a's core under other launch plans (warps a CTA, samples a CTA, a
    batch not divisible by the samples) computes the same bits as the
    default plan."""
    rs = np.random.default_rng(warps * 10 + samples)
    qkv, bias = _attention_inputs(rs, 7, 193, 3, cuda)
    plan = fb.attention_q8_plan(7, 193, 3, warps=warps, samples=samples)
    got = fb.attention_q8(qkv, bias, 3, plan=plan)
    want = fb.attention_q8(qkv, bias, 3)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("r,hw,offset", [(2048, (64, 61), 0),
                                         (8192, (128, 128), 1),
                                         (40000, (33, 17), 0)])
def test_label_lookup_matches_plain(cuda, r, hw, offset):
    """K9 on a table staged in shared memory and on one read through the
    read-only cache (40000 entries), an odd pixel count (the scalar tail),
    a map 4 bytes off 16-byte alignment (the scalar path), and
    ids out of range on both sides."""
    g = torch.Generator().manual_seed(r)
    table = torch.randint(0, 10 ** 6, (r,), dtype=torch.int32, generator=g)
    n = hw[0] * hw[1]
    flat = torch.randint(-r - 5, 2 * r, (n + offset,), dtype=torch.int32,
                         generator=g)
    ids = flat[offset:].reshape(hw)
    dev_flat = flat.to(cuda)
    dev_ids = dev_flat[offset:].reshape(hw)
    before = ll.label_lookup.launches
    got = ll.label_lookup(table.to(cuda), dev_ids)
    torch.cuda.synchronize()
    assert ll.label_lookup.launches == before + 1
    torch.testing.assert_close(got.cpu(), ll.label_lookup_ref(table, ids),
                               rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["s8s8", "s8s4"])
def test_int4_dot_matches_plain(cuda, variant):
    """K10's s8 variants at M 256, K 192, N 384 (the s4 x s4 one is built
    alone, and chip_smoke.py reports whether it assembles)."""
    g = torch.Generator().manual_seed(len(variant))
    a = torch.randint(-128, 128, (256, 192), dtype=torch.int8, generator=g)
    bt = torch.randint(-8, 8, (384, 192), dtype=torch.int8, generator=g)
    if variant == "s8s4":
        bt = i4.pack_int4(bt)
    before = i4.int4_dot.launches
    got = i4.int4_dot(a.to(cuda), bt.to(cuda), variant)
    torch.cuda.synchronize()
    assert i4.int4_dot.launches == before + 1
    torch.testing.assert_close(got.cpu(), i4.int4_dot_ref(a, bt, variant),
                               rtol=0, atol=0)
