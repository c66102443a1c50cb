"""The saved-probs training attention (kernel K6), its plain PyTorch
version, and the differentiable attention every training block runs.

Counterpart of ``deepmerge_tpu/ops/pallas/fused_attention.py``'s
``fused_attention_qkv(..., save_probs=True)``: the forward
(``_attn_qkv_probs_kernel``, :311) computes softmax(q·kᵀ·d^-½ + bias)·v from
the packed (B, N, 3C) qkv projection and also emits the normalized
probabilities in bf16; the backward (``_fused_qkv_train_bwd``, :392) takes
dv and dp from the saved probabilities, then dlogits = p·(dp − Σ dp·p), the
bias gradient summed over the batch, and dq and dk scaled by d^-½.

Numerics, as the JAX package's (the CPU tests hold them to it):

* The probabilities are bf16 whatever the input type (:367), and the
  backward casts the incoming gradient, v, q, k and dlogits to bf16 and
  accumulates in float32 (:403-417) — also in a float32 model.
* JAX's einsums there return float32 (``preferred_element_type``). The
  backward here multiplies the bf16-rounded values as float32 with TF32
  off: every product of two bf16 values is exact in float32, so only the
  order of summation differs.
* The forward scales q in the input dtype before the dot (:323), multiplies
  the unnormalized e, cast to the input dtype, by v and only then by the
  float32 reciprocal of Σe (:333-337); the probabilities are e·(1/Σe)
  rounded to bf16 (:338).
* The bias gradient is summed over the batch in float32 (:412). The model
  gathers the bias from its table, so autograd scatter-adds it into the
  table; on CUDA that index backward uses atomics, whose order varies from
  run to run.
"""

from __future__ import annotations

import ctypes

import torch

from deepmerge_tpu_torch.ops.kernels import build
from deepmerge_tpu_torch.ops.kernels.fused_block import attention_parts

HEAD_DIM = 64             # the kernel's head width
TOKENS = (12, 48, 192)    # the sequence lengths of the three v3 stages

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # qkv, bias, out, probs, B, N, C, H, stream
    "dm_attention_probs": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
}


# ------------------------------------------------------------ plain version

def attention_probs_ref(qkv: torch.Tensor, bias: torch.Tensor, heads: int):
    """Plain version of K6: ``(out, probs)`` from a (B, N, 3C) qkv and an
    (H, N, N) bias; out (B, N, C) in qkv's dtype, probs (B, H, N, N) bf16,
    with the TPU kernel's rounding points (module docstring)."""
    out, e, recip = attention_parts(qkv, bias, heads)
    return out, (e * recip).to(torch.bfloat16)


def attention_probs_bwd(qkv: torch.Tensor, probs: torch.Tensor,
                        g: torch.Tensor, heads: int):
    """The JAX package's ``_fused_qkv_train_bwd`` in torch: ``(dqkv,
    dbias)`` from the saved qkv and bf16 probs and the output gradient
    ``g``; dqkv in qkv's dtype, dbias (H, N, N) float32. Every product takes
    bf16-rounded operands and sums in float32 (TF32 off)."""
    f32, bf = torch.float32, torch.bfloat16
    torch.backends.cuda.matmul.allow_tf32 = False
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    scale = d ** -0.5
    r16 = lambda t: t.to(bf).to(f32)
    q, k, v = (qkv[..., i * c : (i + 1) * c].reshape(b, n, heads, d)
               for i in range(3))
    g4 = r16(g.reshape(b, n, heads, d))
    p32 = probs.to(f32)
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


# -------------------------------------------------------------- CUDA path

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
    if n not in TOKENS or not 1 <= b <= 65535:
        raise ValueError(f"the CUDA attention takes N in {TOKENS} and "
                         f"1..65535 samples, got B={b}, N={n}")
    if (bias.dtype != torch.float32 or tuple(bias.shape) != (heads, n, n)
            or bias.device != qkv.device or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous float32 ({heads}, {n}, "
                         f"{n}) on {qkv.device}, got {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device}")
    return b, n, c


def attention_probs(qkv: torch.Tensor, bias: torch.Tensor, heads: int):
    """K6: ``(out, probs)`` — out (B, N, C) in qkv's dtype, probs (B, H, N,
    N) bf16.

    CPU tensors run ``attention_probs_ref``. CUDA tensors (bf16, d = 64,
    N in ``TOKENS``) launch ``csrc/fused_attention.cu``
    (``dm_attention_probs``) and count the launch in
    ``attention_probs.launches``; anything else raises.
    """
    if qkv.device.type == "cpu":
        return attention_probs_ref(qkv, bias, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    b, n, c = _check_cuda(qkv, bias, heads)
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    probs = torch.empty((b, heads, n, n), dtype=torch.bfloat16,
                        device=qkv.device)
    lib = build.load("fused_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = lib.dm_attention_probs(qkv.data_ptr(), bias.data_ptr(),
                                 out.data_ptr(), probs.data_ptr(), b, n, c,
                                 heads, stream)
    build.check(lib, err, "dm_attention_probs")
    attention_probs.launches += 1
    return out, probs


attention_probs.launches = 0


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


def fused_attention_train(qkv: torch.Tensor, bias: torch.Tensor,
                          heads: int) -> torch.Tensor:
    """softmax(q·kᵀ·d^-½ + bias)·v from the packed qkv, differentiable in
    qkv and bias: the JAX package's ``fused_attention_qkv(qkv, bias, heads,
    save_probs=True)``. Returns (B, N, C) in qkv's dtype."""
    return _AttentionTrain.apply(qkv, bias, heads)
