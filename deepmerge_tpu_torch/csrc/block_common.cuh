// Pieces shared by the bf16 block kernels (fused_block.cu, K2/K3 and the
// training block K5), the w8a8 block kernels (fused_block_q8.cu, K4) and
// the attention kernels (fused_attention.cu: K6 saved-probs, K7 packed qkv,
// K8 (B, N, H, D)): warp reductions, bf16 rounding, the tanh GELU,
// cp.async, and the bf16 attention core, which K4 runs unchanged (the JAX
// package keeps the attention of its w8a8 block in bf16 unless `quant_attn`
// sends it to K4a's int8 core in fused_block_q8.cu: `_attn_inner`,
// deepmerge_tpu/ops/pallas/fused_block.py), K6 runs with kProbs set, K7
// as K2 does, K8 with kNormFirst on separate q, k, v, and K5 with kProbs
// and kNormFirst together (its probabilities are the normalized ones it
// multiplies by v).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr float kLnEps = 1e-5f;

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// jax.nn.gelu(approximate=True): x * 0.5 * (1 + tanh(√(2/π)(x + 0.044715x³)))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;
  return x * (0.5f * (1.0f + tanhf(k * (x + 0.044715f * (x * x * x)))));
}

// 16-byte asynchronous copy global → shared; zero-fills when !pred.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// LayerNorm row kernels: one warp per row, 8 rows per CTA
constexpr int kLnWarps = 8;
constexpr int kLnMaxVec = 4;  // 8-element vectors per lane: C <= 1024

// ------------------------------------------------------------- attention

constexpr int kHeadDim = 64;
constexpr int kHS = kHeadDim + 8;  // Q/K/V shared row stride (bf16): 144 B
constexpr int kAttnWarps = 8;
constexpr int kAttnThreads = kAttnWarps * 32;
constexpr int kMaxKeysPerLane = 8;  // N <= 256

// Shared memory of one attention CTA for n tokens (keys padded to the
// 16-wide MMA tile): K and V of the head, and per warp a 16-query Q block
// and a scratch block that holds its f32 logits, then (in place, row by
// row) its bf16 softmax numerators, then the f32 output of the value
// product. 170 KB at n = 192.
struct AttnLayout {
  int np, s_ld, p_ld;
  size_t k, v, q, s, bytes;
};

__host__ __device__ inline AttnLayout attn_layout(int n) {
  AttnLayout l;
  l.np = (n + 15) & ~15;
  l.s_ld = (l.np > kHeadDim ? l.np : kHeadDim) + 4;  // f32 row stride
  l.p_ld = l.np + 8;                                  // bf16 row stride
  l.k = 0;
  l.v = l.k + static_cast<size_t>(l.np) * kHS * sizeof(bf16);
  l.q = l.v + static_cast<size_t>(l.np) * kHS * sizeof(bf16);
  l.s = l.q + static_cast<size_t>(kAttnWarps) * 16 * kHS * sizeof(bf16);
  l.bytes = l.s + static_cast<size_t>(kAttnWarps) * 16 * l.s_ld * sizeof(float);
  return l;
}

// One CTA per (head, sample); each warp takes 16 queries at a time. Every
// region offset and row stride above is a multiple of 32 / 16 bytes, as
// the WMMA loads and stores require. The numerators of row r (2·p_ld bytes
// from byte 2·r·p_ld) only overwrite logits of rows <= r, which the warp
// already holds in registers when it writes them. With kProbs the kernel
// also stores each row's normalized probabilities bf16(e · 1/Σe) to
// probs (B, H, N, N), straight from the registers that hold e.
//
// q, k and v are the first rows of the three operands, each row `ld`
// elements apart: 3C within a packed (B·N, 3C) qkv (k = q + C, v = q + 2C),
// C for (B, N, H, 64) tensors. The output rows are C apart. With
// kNormFirst the numerators are normalized before the value product,
// bf16(e · (1/Σe)), and the product is the output (the (B, N, H, D) TPU
// kernel's order); without it the product of bf16(e) is scaled by 1/Σe.
template <bool kProbs, bool kNormFirst>
__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, long long ld,
                 const float* __restrict__ bias, bf16* __restrict__ out,
                 bf16* __restrict__ probs, int N, int C, float scale) {
  extern __shared__ __align__(128) unsigned char attn_smem[];
  const AttnLayout L = attn_layout(N);
  bf16* ks = reinterpret_cast<bf16*>(attn_smem + L.k);
  bf16* vs = reinterpret_cast<bf16*>(attn_smem + L.v);

  const int h = blockIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.y) * N;
  const int head_off = h * kHeadDim;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // K and V of the head, asynchronously, rows past N zero-filled
  for (int idx = threadIdx.x; idx < L.np * 8; idx += kAttnThreads) {
    const int j = idx >> 3;
    const int c = (idx & 7) * 8;
    const bool in = j < N;
    const long long off = in ? (row0 + j) * ld + head_off + c : 0;
    cp_async16(ks + j * kHS + c, k + off, in);
    cp_async16(vs + j * kHS + c, v + off, in);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  bf16* qs = reinterpret_cast<bf16*>(attn_smem + L.q) + warp * 16 * kHS;
  float* ss = reinterpret_cast<float*>(attn_smem + L.s) + warp * 16 * L.s_ld;
  bf16* ps = reinterpret_cast<bf16*>(ss);  // numerators, in place
  const float* bias_h = bias + static_cast<long long>(h) * N * N;
  const int key_tiles = L.np / 16;

  for (int rb = warp; rb < key_tiles; rb += kAttnWarps) {
    const int i0 = rb * 16;
    // the query block: copied raw, then q·d^-½ rounded to bf16 in place,
    // as the TPU kernel scales it
    for (int idx = lane; idx < 16 * 8; idx += 32) {
      const int r = idx >> 3;
      const int c = (idx & 7) * 8;
      const bool in = i0 + r < N;
      cp_async16(qs + r * kHS + c,
                 q + (in ? (row0 + i0 + r) * ld + head_off + c : 0), in);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    for (int idx = lane; idx < 16 * (kHeadDim / 2); idx += 32) {
      const int r = idx / (kHeadDim / 2);
      const int p = idx % (kHeadDim / 2);
      __nv_bfloat162* q2 =
          reinterpret_cast<__nv_bfloat162*>(qs + r * kHS + 2 * p);
      const float2 f = __bfloat1622float2(*q2);
      *q2 = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    __syncwarp();

    // logits S = Q·Kᵀ (16 x np, f32)
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wmma::load_matrix_sync(qa[kk], qs + kk * 16, kHS);
    for (int jt = 0; jt < key_tiles; ++jt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s_acc;
      wmma::fill_fragment(s_acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, ks + jt * 16 * kHS + kk * 16, kHS);
        wmma::mma_sync(s_acc, qa[kk], kb, s_acc);
      }
      wmma::store_matrix_sync(ss + jt * 16, s_acc, L.s_ld,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // softmax numerators per row: e = exp(l - max) in f32, rounded to bf16
    // for the value product; lane r keeps row r's 1/Σe (of the unrounded
    // e). The next row's bias is fetched while this row is reduced.
    float inv_row = 0.f;
    float bnext[kMaxKeysPerLane];
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      bnext[t] = (i0 < N && j < N) ? bias_h[static_cast<long long>(i0) * N + j]
                                   : 0.f;
    }
    for (int r = 0; r < 16; ++r) {
      const int i = i0 + r;
      float l[kMaxKeysPerLane];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < kMaxKeysPerLane; ++t) {
        const int j = lane + 32 * t;
        l[t] = (i < N && j < N) ? ss[r * L.s_ld + j] + bnext[t] : -INFINITY;
        mx = fmaxf(mx, l[t]);
      }
#pragma unroll
      for (int t = 0; t < kMaxKeysPerLane; ++t) {
        const int j = lane + 32 * t;
        bnext[t] = (i + 1 < N && r + 1 < 16 && j < N)
                       ? bias_h[static_cast<long long>(i + 1) * N + j]
                       : 0.f;
      }
      mx = warp_max(mx);
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxKeysPerLane; ++t) {
        l[t] = l[t] == -INFINITY ? 0.f : expf(l[t] - mx);
        s += l[t];
      }
      s = warp_sum(s);  // also orders the row's reads before its writes
      const float inv = 1.0f / s;
      if (lane == r) inv_row = inv;
      if (kProbs && i < N) {
        // the TPU kernel's probs: (e · (1/Σe)) rounded to bf16, e unrounded
        bf16* grow = probs + ((static_cast<long long>(blockIdx.y) * gridDim.x +
                               h) * N + i) * N;
#pragma unroll
        for (int t = 0; t < kMaxKeysPerLane; ++t) {
          const int j = lane + 32 * t;
          if (j < N) grow[j] = __float2bfloat16(l[t] * inv);
        }
      }
      bf16* prow = ps + r * L.p_ld;
#pragma unroll
      for (int t = 0; t < kMaxKeysPerLane; ++t) {
        const int j = lane + 32 * t;
        // a row past N has s = 0: its numerators stay 0
        const float e = kNormFirst ? (i < N ? l[t] * inv : 0.f) : l[t];
        if (j < L.np) prow[j] = __float2bfloat16(e);
      }
      __syncwarp();
    }

    // O = P·V (16 x 64, f32): all four column tiles in registers, then
    // stored over the numerators
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o_acc[4];
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) wmma::fill_fragment(o_acc[dt], 0.f);
    for (int kt = 0; kt < key_tiles; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, ps + kt * 16, L.p_ld);
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, vs + kt * 16 * kHS + dt * 16, kHS);
        wmma::mma_sync(o_acc[dt], pa, vb, o_acc[dt]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int dt = 0; dt < 4; ++dt)
      wmma::store_matrix_sync(ss + dt * 16, o_acc[dt], L.s_ld,
                              wmma::mem_row_major);
    __syncwarp();

    // out = bf16(O · 1/Σe), or bf16(O) when the numerators were normalized
    for (int idx = lane; idx < 16 * (kHeadDim / 2); idx += 32) {
      const int r = idx / (kHeadDim / 2);
      const int p = idx % (kHeadDim / 2);
      const float inv =
          kNormFirst ? 1.f : __shfl_sync(0xffffffffu, inv_row, r);
      if (i0 + r < N) {
        const float* orow = ss + r * L.s_ld + 2 * p;
        *reinterpret_cast<__nv_bfloat162*>(out + (row0 + i0 + r) * C +
                                           head_off + 2 * p) =
            __floats2bfloat162_rn(orow[0] * inv, orow[1] * inv);
      }
    }
    __syncwarp();  // the warp's Q and scratch are reused
  }
}

// The attention core: out (B·N, C) bf16 from q, k, v rows `ld` apart (see
// attention_kernel), and with kProbs the normalized probabilities
// (B, H, N, N) bf16.
template <bool kProbs, bool kNormFirst>
inline cudaError_t attention_launch(const bf16* q, const bf16* k,
                                    const bf16* v, long long ld,
                                    const float* bias, bf16* out, bf16* probs,
                                    int B, int N, int C, int H,
                                    cudaStream_t stream) {
  const AttnLayout L = attn_layout(N);
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<kProbs, kNormFirst>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.bytes));
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));
  attention_kernel<kProbs, kNormFirst>
      <<<dim3(H, B), kAttnThreads, L.bytes, stream>>>(q, k, v, ld, bias, out,
                                                      probs, N, C, scale);
  return cudaGetLastError();
}

// The attention core over a packed (B·N, 3C) qkv, with or without probs.
template <bool kProbs>
inline cudaError_t attention_qkv(const bf16* qkv, const float* bias,
                                 bf16* out, bf16* probs, int B, int N, int C,
                                 int H, cudaStream_t stream) {
  return attention_launch<kProbs, false>(qkv, qkv + C, qkv + 2 * C, 3LL * C,
                                         bias, out, probs, B, N, C, H,
                                         stream);
}

inline cudaError_t attention(const bf16* qkv, const float* bias, bf16* out,
                             int B, int N, int C, int H,
                             cudaStream_t stream) {
  return attention_qkv<false>(qkv, bias, out, nullptr, B, N, C, H, stream);
}

}  // namespace
