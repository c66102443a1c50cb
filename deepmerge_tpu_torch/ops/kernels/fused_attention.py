"""The attention kernels and their plain PyTorch versions: the saved-probs
training attention (kernel K6), the inference attention on the packed qkv
(kernel K7) and on (B, N, H, D) q, k, v (kernel K8), each differentiable
through an autograd function.

Counterpart of ``deepmerge_tpu/ops/pallas/fused_attention.py``:

* K6, ``fused_attention_qkv(..., save_probs=True)``: the forward
  (``_attn_qkv_probs_kernel``, :311) computes softmax(q·kᵀ·d^-½ + bias)·v
  from the packed (B, N, 3C) qkv projection and also emits the normalized
  probabilities in bf16; the backward (``_fused_qkv_train_bwd``, :392) takes
  dv and dp from the saved probabilities, then dlogits = p·(dp − Σ dp·p),
  the bias gradient summed over the batch, and dq and dk scaled by d^-½.
* K7, ``fused_attention_qkv(..., save_probs=False)`` (``_attn_qkv_kernel``,
  :143, and its head-pair packed form, :175, the same function): the same
  forward without the probabilities. Its backward (``_fused_qkv_bwd``, :294)
  is K8's.
* K8, ``fused_attention(q, k, v, bias)`` (``_attn_kernel``, :26): the same
  attention on (B, N, H, D) tensors, the softmax normalized before the value
  product. Its backward (``_fused_attention_bwd``, :72) recomputes the
  attention in float32 from q, k, v and the bias.

Numerics, as the JAX package's (the CPU tests hold them to it):

* Every forward scales q in the input dtype before the dot. K6 and K7
  multiply the unnormalized e, cast to the input dtype, by v and only then
  by the float32 reciprocal of Σe (:160-171, :333-337); K8 casts e / Σe to
  the input dtype before the product (:34-40).
* K6's probabilities are bf16 whatever the input type (:367), e·(1/Σe)
  rounded; its backward casts the incoming gradient, v, q, k and dlogits
  to bf16 and accumulates in float32 (:403-417), also in a float32 model.
  JAX's einsums there return float32 (``preferred_element_type``); here
  the bf16-rounded values are multiplied as float32 with TF32 off: every
  product of two bf16 values is exact in float32, so only the order of
  summation differs.
* K7's and K8's backward runs in float32 throughout, TF32 off, and returns
  the gradients in the inputs' dtypes.
* The bias gradients are summed over the batch in float32. The model
  gathers the bias from its table, so autograd adds them into the table
  (``index_add_``); on CUDA that uses atomics, whose order varies from run
  to run.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deepmerge_tpu_torch.ops.dropout import dropout
from deepmerge_tpu_torch.ops.kernels import build
from deepmerge_tpu_torch.ops.kernels.fused_block import (
    HEAD_DIM,
    MAX_TOKENS,
    _on_cuda,
    _plan_arg,
    _products_for,
    attention_parts,
    attention_plan,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # qkv, bias, out, probs, B, N, C, H, plan, stream
    "dm_attention_probs": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # qkv, bias, out, B, N, C, H, plan, stream
    "dm_attention": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    # q, k, v, bias, out, B, N, C, H, plan, stream
    "dm_attention_bnhd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
}


# ----------------------------------------------------------- plain versions

def attention_probs_ref(qkv: torch.Tensor, bias: torch.Tensor, heads: int):
    """Plain version of K6: ``(out, probs)`` from a (B, N, 3C) qkv and an
    (H, N, N) bias; out (B, N, C) in qkv's dtype, probs (B, H, N, N) bf16,
    with the TPU kernel's rounding points (module docstring)."""
    out, e, recip = attention_parts(qkv, bias, heads)
    return out, (e * recip).to(torch.bfloat16)


def attention_qkv_ref(qkv: torch.Tensor, bias: torch.Tensor,
                      heads: int) -> torch.Tensor:
    """Plain version of K7: (B, N, C) in qkv's dtype from a (B, N, 3C) qkv
    and an (H, N, N) bias."""
    return attention_parts(qkv, bias, heads)[0]


def attention_bnhd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: torch.Tensor, attn_drop: float = 0.0,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """Plain version of K8: (B, N, H, D) in q's dtype from (B, N, H, D) q,
    k, v and an (H, N, N) bias; q scaled in its dtype, the float32 softmax
    e / Σe cast to v's dtype before the value product. With ``attn_drop``
    (training), dropout on the float32 probabilities before that cast, its
    mask from ``generator``: the JAX package's attention off its kernels."""
    f32 = torch.float32
    qs = q * q.shape[-1] ** -0.5
    logits = torch.einsum("bnhd,bmhd->bhnm", qs.to(f32), k.to(f32)) \
        + bias.to(f32)[None]
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = dropout(e / e.sum(-1, keepdim=True), attn_drop, generator)
    return torch.einsum("bhnm,bmhd->bnhd", p.to(v.dtype).to(f32),
                        v.to(f32)).to(q.dtype)


def attention_probs_bwd(qkv: torch.Tensor, probs: torch.Tensor,
                        g: torch.Tensor, heads: int):
    """The JAX package's ``_fused_qkv_train_bwd`` in torch: ``(dqkv,
    dbias)`` from the saved qkv and bf16 probs and the output gradient
    ``g``; dqkv in qkv's dtype, dbias (H, N, N) float32. Every product takes
    bf16-rounded operands and sums in float32 (TF32 off)."""
    f32, bf = torch.float32, torch.bfloat16
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    scale = d ** -0.5
    r16 = lambda t: t.to(bf).to(f32)
    q, k, v = split_qkv(qkv, heads)
    g4 = r16(g.reshape(b, n, heads, d))
    p32 = probs.to(f32)
    with _products_for(torch.float32):
        dv = torch.einsum("bhnm,bnhd->bmhd", p32, g4)
        dp = torch.einsum("bnhd,bmhd->bhnm", g4, r16(v))
        dlogits = p32 * (dp - (dp * p32).sum(-1, keepdim=True))
        dbias = dlogits.sum(0)
        dl16 = r16(dlogits)
        dq = torch.einsum("bhnm,bmhd->bnhd", dl16, r16(k)) * scale
        dk = torch.einsum("bhnm,bnhd->bmhd", dl16, r16(q)) * scale
    dqkv = torch.cat([dq.reshape(b, n, c), dk.reshape(b, n, c),
                      dv.reshape(b, n, c)], dim=2)
    return dqkv.to(qkv.dtype), dbias


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor, g: torch.Tensor):
    """The JAX package's ``_fused_attention_bwd`` in torch: ``(dq, dk, dv,
    dbias)`` of softmax(q·kᵀ·d^-½ + bias)·v on (B, N, H, D) tensors, from
    the attention recomputed in float32 (TF32 off); the gradients in the
    inputs' dtypes."""
    f32 = torch.float32
    scale = q.shape[-1] ** -0.5
    q32, k32, v32, g32 = (t.to(f32) for t in (q, k, v, g))
    with _products_for(torch.float32):
        logits = torch.einsum("bnhd,bmhd->bhnm", q32 * scale, k32) \
            + bias.to(f32)[None]
        p = torch.softmax(logits, dim=-1)
        dv = torch.einsum("bhnm,bnhd->bmhd", p, g32)
        dp = torch.einsum("bnhd,bmhd->bhnm", g32, v32)
        dlogits = p * (dp - (dp * p).sum(-1, keepdim=True))
        dq = torch.einsum("bhnm,bmhd->bnhd", dlogits, k32) * scale
        dk = torch.einsum("bhnm,bnhd->bmhd", dlogits, q32) * scale
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dlogits.sum(0).to(bias.dtype))


def split_qkv(qkv: torch.Tensor, heads: int):
    """(B, N, 3C) → q, k, v, each a (B, N, H, D) view."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    return tuple(qkv[..., i * c : (i + 1) * c].reshape(b, n, heads, c // heads)
                 for i in range(3))


# -------------------------------------------------------------- CUDA path

def _check_tokens(b, n):
    if not 1 <= n <= MAX_TOKENS or not 1 <= b <= 65535:
        raise ValueError(f"the CUDA attention takes 1..{MAX_TOKENS} tokens "
                         f"and 1..65535 samples, got B={b}, N={n}")


def _check_bias(bias, heads, n, device):
    if (bias.dtype != torch.float32 or tuple(bias.shape) != (heads, n, n)
            or bias.device != device or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous float32 ({heads}, {n}, "
                         f"{n}) on {device}, got {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device}")


def _check_cuda(qkv, bias, heads):
    if qkv.dtype != torch.bfloat16 or qkv.dim() != 3 or \
            not qkv.is_contiguous():
        raise TypeError(f"qkv must be a contiguous (B, N, 3C) bf16 tensor, "
                        f"got {qkv.dtype} {tuple(qkv.shape)}")
    b, n, c3 = qkv.shape
    c = c3 // 3
    if c3 % 3 or c != heads * HEAD_DIM:
        raise ValueError(f"the CUDA attention needs 3C with C == heads*"
                         f"{HEAD_DIM}; got 3C={c3}, heads={heads}")
    _check_tokens(b, n)
    _check_bias(bias, heads, n, qkv.device)
    return b, n, c


def _check_cuda_bnhd(q, k, v, bias):
    for t in (q, k, v):
        if (t.dtype != torch.bfloat16 or t.dim() != 4 or not t.is_contiguous()
                or t.shape != q.shape or t.device != q.device
                or t.data_ptr() % 16):
            raise TypeError(
                f"q, k and v must be contiguous (B, N, H, {HEAD_DIM}) bf16 "
                f"tensors of one shape on one device, 16-byte aligned; got "
                f"{[(x.dtype, tuple(x.shape)) for x in (q, k, v)]}")
    b, n, heads, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the CUDA attention needs D == {HEAD_DIM}, got {d}")
    _check_tokens(b, n)
    _check_bias(bias, heads, n, q.device)
    return b, n, heads


def _lib():
    return build.load("fused_attention", _SIGNATURES)


def attention_probs(qkv: torch.Tensor, bias: torch.Tensor, heads: int):
    """K6: ``(out, probs)`` — out (B, N, C) in qkv's dtype, probs (B, H, N,
    N) bf16.

    CPU tensors run ``attention_probs_ref``. CUDA tensors (bf16, d = 64,
    1 <= N <= 256) launch ``csrc/fused_attention.cu``
    (``dm_attention_probs``) and count the launch in
    ``attention_probs.launches``; anything else raises.
    """
    if not _on_cuda(qkv):
        return attention_probs_ref(qkv, bias, heads)
    b, n, c = _check_cuda(qkv, bias, heads)
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    probs = torch.empty((b, heads, n, n), dtype=torch.bfloat16,
                        device=qkv.device)
    lib = _lib()
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    plan = _plan_arg(attention_plan(b, n, heads)["ints"])
    err = lib.dm_attention_probs(qkv.data_ptr(), bias.data_ptr(),
                                 out.data_ptr(), probs.data_ptr(), b, n, c,
                                 heads, plan, stream)
    build.check(lib, err, "dm_attention_probs")
    attention_probs.launches += 1
    return out, probs


def attention_qkv(qkv: torch.Tensor, bias: torch.Tensor, heads: int,
                  plan: dict | None = None) -> torch.Tensor:
    """K7: (B, N, C) in qkv's dtype.

    CPU tensors run ``attention_qkv_ref``. CUDA tensors (bf16, d = 64,
    1 <= N <= 256) launch ``csrc/fused_attention.cu`` (``dm_attention``)
    with ``plan`` (an ``attention_plan`` of these shapes, which the kernel
    checks; the default one if None) and count the launch in
    ``attention_qkv.launches``; anything else raises.
    """
    if not _on_cuda(qkv):
        return attention_qkv_ref(qkv, bias, heads)
    b, n, c = _check_cuda(qkv, bias, heads)
    plan = plan or attention_plan(b, n, heads)
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    lib = _lib()
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = lib.dm_attention(qkv.data_ptr(), bias.data_ptr(), out.data_ptr(),
                           b, n, c, heads, _plan_arg(plan["ints"]), stream)
    build.check(lib, err, "dm_attention")
    attention_qkv.launches += 1
    return out


def attention_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """K8: (B, N, H, D) in q's dtype.

    CPU tensors run ``attention_bnhd_ref``. CUDA tensors (bf16, D = 64,
    1 <= N <= 256) launch ``csrc/fused_attention.cu``
    (``dm_attention_bnhd``) and count the launch in
    ``attention_bnhd.launches``; anything else raises.
    """
    if not _on_cuda(q):
        return attention_bnhd_ref(q, k, v, bias)
    b, n, heads = _check_cuda_bnhd(q, k, v, bias)
    out = torch.empty_like(q)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.dm_attention_bnhd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                bias.data_ptr(), out.data_ptr(), b, n,
                                heads * HEAD_DIM, heads,
                                _plan_arg(attention_plan(b, n, heads)["ints"]),
                                stream)
    build.check(lib, err, "dm_attention_bnhd")
    attention_bnhd.launches += 1
    return out


attention_probs.launches = 0
attention_qkv.launches = 0
attention_bnhd.launches = 0


# ------------------------------------------------- differentiable entries

class _AttentionTrain(torch.autograd.Function):
    """Forward through ``attention_probs`` (K6 on CUDA), saving qkv and the
    bf16 probs; backward ``attention_probs_bwd``."""

    @staticmethod
    def forward(ctx, qkv, bias, heads):
        out, probs = attention_probs(qkv.contiguous(),
                                     bias.to(torch.float32).contiguous(),
                                     heads)
        ctx.save_for_backward(qkv, probs)
        ctx.heads = heads
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, probs = ctx.saved_tensors
        dqkv, dbias = attention_probs_bwd(qkv, probs, g, ctx.heads)
        return dqkv, dbias, None


class _AttentionQKV(torch.autograd.Function):
    """Forward through ``attention_qkv`` (K7 on CUDA), saving qkv and the
    bias; backward ``attention_bwd`` on the split q, k, v
    (``_fused_qkv_bwd``)."""

    @staticmethod
    def forward(ctx, qkv, bias, heads):
        bias = bias.to(torch.float32).contiguous()
        ctx.save_for_backward(qkv, bias)
        ctx.heads = heads
        return attention_qkv(qkv.contiguous(), bias, heads)

    @staticmethod
    def backward(ctx, g):
        qkv, bias = ctx.saved_tensors
        b, n, c3 = qkv.shape
        dq, dk, dv, dbias = attention_bwd(*split_qkv(qkv, ctx.heads), bias,
                                          g.reshape(b, n, ctx.heads, -1))
        dqkv = torch.cat([t.reshape(b, n, c3 // 3) for t in (dq, dk, dv)],
                         dim=2)
        return dqkv.to(qkv.dtype), dbias, None


class _AttentionBNHD(torch.autograd.Function):
    """Forward through ``attention_bnhd`` (K8 on CUDA); backward
    ``attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        bias = bias.to(torch.float32).contiguous()
        ctx.save_for_backward(q, k, v, bias)
        return attention_bnhd(q.contiguous(), k.contiguous(), v.contiguous(),
                              bias)

    @staticmethod
    def backward(ctx, g):
        return attention_bwd(*ctx.saved_tensors, g)


def fused_attention_train(qkv: torch.Tensor, bias: torch.Tensor,
                          heads: int) -> torch.Tensor:
    """softmax(q·kᵀ·d^-½ + bias)·v from the packed qkv, differentiable in
    qkv and bias: the JAX package's ``fused_attention_qkv(qkv, bias, heads,
    save_probs=True)``. Returns (B, N, C) in qkv's dtype."""
    return _AttentionTrain.apply(qkv, bias, heads)


def fused_attention_qkv(qkv: torch.Tensor, bias: torch.Tensor, heads: int,
                        packed_pv: bool = False) -> torch.Tensor:
    """softmax(q·kᵀ·d^-½ + bias)·v from the packed qkv, differentiable in
    qkv and bias: the JAX package's ``fused_attention_qkv(qkv, bias, heads,
    packed_pv=packed_pv)``. ``packed_pv`` is kept for that signature only
    and selects nothing: the TPU's head-pair packed kernel computes the same
    function (its packing fills 128-wide lanes), so both run K7; as there,
    it needs an even head count. Returns (B, N, C) in qkv's dtype."""
    if packed_pv and heads % 2:
        raise ValueError(f"packed_pv needs an even head count, got {heads}")
    return _AttentionQKV.apply(qkv, bias, heads)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ·d^-½ + bias)·v on (B, N, H, D) q, k, v, differentiable
    in all four: the JAX package's ``fused_attention``. Returns (B, N, H,
    D) in q's dtype."""
    return _AttentionBNHD.apply(q, k, v, bias)
