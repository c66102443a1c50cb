"""The int4 dot probe (kernel K10) and its plain PyTorch version.

Counterpart of the TPU probe ``tools/int4_dot_probe.py`` (``_mk``'s kernel):
int32 C (M, N) = A (M, K) · B (K, N) on integer operands, at the MLP's
shape (M 4096, K 768, N 3072), to ask whether an int4 rate would make a
w4a8 MLP worth having. No path of the package computes it. Hopper has no
int4 tensor-core rate, so every variant runs on the s8 ``wgmma`` GEMM
(``csrc/int4_dot.cuh``, on ``csrc/wgmma_gemm.cuh``):

* ``"s8s8"``: A (M, K) int8, Bᵀ (N, K) int8; the GEMM as K4 runs it, an
  int32 epilogue;
* ``"s8s4"``: A (M, K) int8, Bᵀ packed int4 (``pack_int4``: (N, K/2)
  uint8), widened to s8 between global and shared memory by a converter
  warpgroup: a w4a8 product. PTX has no mixed-operand (s8 × s4) product,
  the TPU probe's third variant;
* ``"s4s4"``: A and Bᵀ packed, (M, K/2) and (N, K/2), both widened.

B travels as Bᵀ, K contiguous, as ``wgmma`` reads an s8 operand.
"""

from __future__ import annotations

import ctypes

import torch

from deepmerge_tpu_torch.ops.kernels import build

VARIANTS = ("s8s8", "s4s4", "s8s4")
# the entry point of each variant (csrc/int4_dot.cu)
_ENTRY = {v: f"dm_int_dot_{v}" for v in VARIANTS}
# the shapes the kernels take: K a whole number of the GEMM's 128-value K
# slabs, N a multiple of 8 (the epilogue's column pairs), any M >= 1
K_ALIGN = 128
N_ALIGN = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
# a, bt, c, m, n, k, stream
_ARGS = [_P, _P, _P, _I, _I, _I, _P]


def pack_int4(x: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 values in [-8, 7], K even → (..., K/2) uint8, two a
    byte, the even index in the low nibble."""
    if x.dtype != torch.int8 or x.shape[-1] % 2:
        raise TypeError(f"pack_int4 takes int8 with an even last axis, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if x.numel() and (int(x.min()) < -8 or int(x.max()) > 7):
        raise ValueError("pack_int4: values outside [-8, 7]")
    u = x.to(torch.int16) & 0xF
    return (u[..., 0::2] | (u[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4``: (..., K/2) uint8 → (..., K) int8."""
    if p.dtype != torch.uint8:
        raise TypeError(f"unpack_int4 takes uint8, got {p.dtype}")
    u = p.to(torch.int16)
    nibbles = torch.stack([u & 0xF, u >> 4], dim=-1)
    return ((nibbles ^ 8) - 8).to(torch.int8).reshape(
        *p.shape[:-1], 2 * p.shape[-1])


def _operands(a: torch.Tensor, bt: torch.Tensor, variant: str):
    """A and Bᵀ widened to int8, (M, K) and (N, K)."""
    return (unpack_int4(a) if variant == "s4s4" else a,
            bt if variant == "s8s8" else unpack_int4(bt))


def int4_dot_ref(a: torch.Tensor, bt: torch.Tensor, variant: str
                 ) -> torch.Tensor:
    """Plain version: the exact integer product of the widened operands, as
    a float64 ``matmul`` (exact while every |sum| < 2^53) cast to int32."""
    a8, b8 = _operands(a, bt, variant)
    return torch.matmul(a8.to(torch.float64), b8.to(torch.float64).t()).to(
        torch.int32)


def _check(a, bt, variant) -> tuple[int, int, int]:
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    want_a = torch.uint8 if variant == "s4s4" else torch.int8
    want_b = torch.int8 if variant == "s8s8" else torch.uint8
    if (a.dtype, bt.dtype) != (want_a, want_b) or a.dim() != 2 \
            or bt.dim() != 2:
        raise TypeError(f"{variant}: A must be 2-D {want_a} and Bᵀ 2-D "
                        f"{want_b}, got {a.dtype} {tuple(a.shape)} and "
                        f"{bt.dtype} {tuple(bt.shape)}")
    m, ka = a.shape
    k = 2 * ka if variant == "s4s4" else ka
    kb = bt.shape[1] * (1 if variant == "s8s8" else 2)
    if kb != k:
        raise ValueError(f"{variant}: A holds K={k}, Bᵀ K={kb}")
    if a.device != bt.device:
        raise ValueError("A and Bᵀ must be on the same device")
    return m, bt.shape[0], k


def check_shape(m: int, n: int, k: int, variant: str) -> None:
    """Raises ``ValueError`` for a shape the kernels do not take: K a
    multiple of ``K_ALIGN`` (the GEMM's K slab; a packed row is then a
    multiple of 16 bytes, as TMA needs), N of ``N_ALIGN``, M >= 1."""
    if m < 1 or n < N_ALIGN or n % N_ALIGN or k < K_ALIGN or k % K_ALIGN:
        raise ValueError(
            f"{variant}: the kernels take K a multiple of {K_ALIGN}, N a "
            f"multiple of {N_ALIGN} and M >= 1; got M={m}, N={n}, K={k}")


def int4_dot(a: torch.Tensor, bt: torch.Tensor, variant: str
             ) -> torch.Tensor:
    """C (M, N) int32 = A · B for ``variant`` (module docstring).

    CPU tensors run ``int4_dot_ref``. CUDA tensors (contiguous, 16-byte
    aligned, K a multiple of ``K_ALIGN``, N of ``N_ALIGN``, any M) launch
    the variant's kernel and count the launch in ``int4_dot.launches``;
    anything else raises.
    """
    m, n, k = _check(a, bt, variant)
    if a.device.type == "cpu":
        return int4_dot_ref(a, bt, variant)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    check_shape(m, n, k, variant)
    if not (a.is_contiguous() and bt.is_contiguous()):
        raise ValueError("A and Bᵀ must be contiguous")
    if a.data_ptr() % 16 or bt.data_ptr() % 16:
        raise ValueError("A and Bᵀ must be 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    entry = _ENTRY[variant]
    lib = build.load("int4_dot", {entry: _ARGS})
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = getattr(lib, entry)(a.data_ptr(), bt.data_ptr(), out.data_ptr(),
                              m, n, k, stream)
    build.check(lib, err, entry)
    int4_dot.launches += 1
    return out


int4_dot.launches = 0
