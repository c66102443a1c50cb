// Pieces shared by the bf16 block kernels (fused_block.cu, K2/K3 and the
// training block K5), the w8a8 block kernels (fused_block_q8.cu, K4) and
// the attention kernels (fused_attention.cu: K6 saved-probs, K7 packed qkv,
// K8 (B, N, H, D)): warp reductions, bf16 rounding, the tanh GELU,
// cp.async, ldmatrix and mma.sync, and the bf16 attention core, which K4
// runs unchanged (the JAX
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
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

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
constexpr int kKS = kHeadDim + 8;  // K/V shared row stride (bf16): 144 B
constexpr int kAttnMaxWarps = 12;
constexpr int kAttnPlanInts = 4;   // key-tile bucket, warps, samples, smem

// Shared memory of one attention CTA for n tokens: K and V of one sample
// and head, keys padded to the 16-wide MMA tile. 55,296 B at n = 192,
// 59,904 B at n = 193, 73,728 B at n = 256. The row stride of 144 B puts
// the eight rows of an ldmatrix 8x8 on eight different 4-bank groups.
__host__ __device__ inline int attn_smem_bytes(int n) {
  return 2 * ((n + 15) / 16) * 16 * kKS * static_cast<int>(sizeof(bf16));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a·b, m16n8k16, bf16 operands, f32 accumulators. Fragments (g =
// lane/4, t = lane%4): a rows g and g+8, columns 2t, 2t+1 and those + 8;
// b rows (k) 2t, 2t+1 and + 8, column g; d rows g and g+8, columns 2t,
// 2t+1. The accumulator layout of a 16x16 pair of tiles is the A layout.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// q·d^-½ of one query row's column pair, rounded to bf16 as the TPU kernel
// scales it; 0 for a row past N.
__device__ __forceinline__ uint32_t q_pair(const bf16* q, long long row,
                                           bool in, int col, float scale) {
  if (!in) return 0u;
  const float2 f = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(q + row + col));
  return pack_bf16(f.x * scale, f.y * scale);
}

// bias[i, j] and bias[i, j+1] of the head's (N, N) f32 bias for a logit
// pair, the indices clamped into the matrix so that every load is in
// bounds and none sits behind a branch (the loads of a tile's row can then
// all be in flight together); the caller masks what lies past N. One
// float2 load where N is even (j is even, so the pair is 8-byte aligned).
template <bool kEven>
__device__ __forceinline__ float2 bias_load(const float* bias_h, int i, int j,
                                            int N) {
  const float* row = bias_h + static_cast<long long>(min(i, N - 1)) * N;
  if (kEven) return *reinterpret_cast<const float2*>(row + min(j, N - 2));
  return make_float2(row[min(j, N - 1)], row[min(j + 1, N - 1)]);
}

// Adds the bias pair to a logit pair; keys past N become -inf, and a row
// past N keeps its logits (finite; never stored).
__device__ __forceinline__ void add_bias(float& x0, float& x1, float2 b, int i,
                                         int j, int N) {
  if (i < N) {
    x0 = j < N ? x0 + b.x : -INFINITY;
    x1 = j + 1 < N ? x1 + b.y : -INFINITY;
  }
}

// + bias over all 2·kKT 8-key tiles of a thread's rows ra and rb
template <int kKT, bool kEven>
__device__ __forceinline__ void add_bias_tiles(float (&s)[2 * kKT][4],
                                               const float* bias_h, int ra,
                                               int rb, int tig, int N) {
#pragma unroll
  for (int t = 0; t < 2 * kKT; ++t) {
    const int j = t * 8 + 2 * tig;
    const float2 ba = bias_load<kEven>(bias_h, ra, j, N);
    const float2 bb = bias_load<kEven>(bias_h, rb, j, N);
    add_bias(s[t][0], s[t][1], ba, ra, j, N);
    add_bias(s[t][2], s[t][3], bb, rb, j, N);
  }
}

__device__ __forceinline__ void store_pair(bf16* row, int j, int N, bool even,
                                           float v0, float v1) {
  if (j + 1 < N && even) {
    *reinterpret_cast<__nv_bfloat162*>(row + j) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (j < N) row[j] = __float2bfloat16(v0);
    if (j + 1 < N) row[j + 1] = __float2bfloat16(v1);
  }
}

// The bf16 attention core. A CTA of `warps` warps takes one head (blockIdx.x)
// for `samples` consecutive samples, one after another: K and V of the
// sample into shared memory (cp.async, rows past N zero-filled), then each
// warp takes 16-query tiles w, w + warps, ... of it:
//  * Q' = bf16(q·d^-½) straight from device memory into m16n8k16 A
//    fragments;
//  * S = Q'·Kᵀ with mma.sync, B fragments by ldmatrix from K: the 16 x np
//    logits stay in registers (4 f32 of each 8-key tile a thread, at most
//    128 at N 256), the f32 bias added in that layout (float2 loads where N
//    is even);
//  * the full-row max and Σe by quad shuffles (every key is in registers,
//    so no online rescaling), e = exp(l − max) in f32, 1/Σe of the
//    unrounded e;
//  * with kProbs, bf16(e·(1/Σe)) stored to probs (B, H, N, N);
//  * e (or, with kNormFirst, e·(1/Σe)) rounded to bf16 in registers as
//    the A fragments of P·V (the accumulator layout is the A layout), V's
//    B fragments by ldmatrix.trans;
//  * out = bf16(O · 1/Σe), or bf16(O) with kNormFirst, straight from the
//    accumulators.
// kKT (a bucket of the 16-key tile count ceil(N/16)) sizes the register
// arrays; tiles past ceil(N/16) are skipped. q, k and v are the first rows
// of the three operands, each row `ld` elements apart (3C within a packed
// (B·N, 3C) qkv, C for (B, N, H, 64) tensors); the output rows are C apart.
template <int kKT, bool kProbs, bool kNormFirst>
__global__ void __launch_bounds__(kAttnMaxWarps * 32)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, long long ld,
                 const float* __restrict__ bias, bf16* __restrict__ out,
                 bf16* __restrict__ probs, int B, int N, int C, int samples,
                 float scale) {
  extern __shared__ __align__(16) unsigned char attn_smem[];
  const int key_tiles = (N + 15) >> 4;
  const int np = key_tiles * 16;
  bf16* ks = reinterpret_cast<bf16*>(attn_smem);
  bf16* vs = ks + np * kKS;

  const int h = blockIdx.x;
  const int H = gridDim.x;
  const int head_off = h * kHeadDim;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int mi = lane >> 3;  // the 8x8 matrix this lane addresses
  const bool even = (N & 1) == 0;
  const float* bias_h = bias + static_cast<long long>(h) * N * N;

  for (int si = 0; si < samples; ++si) {
    const int b = blockIdx.y * samples + si;
    if (b >= B) break;
    const long long row0 = static_cast<long long>(b) * N;
    for (int idx = threadIdx.x; idx < np * 8; idx += blockDim.x) {
      const int j = idx >> 3;
      const int c = (idx & 7) * 8;
      const bool in = j < N;
      const long long off = in ? (row0 + j) * ld + head_off + c : 0;
      cp_async16(ks + j * kKS + c, k + off, in);
      cp_async16(vs + j * kKS + c, v + off, in);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    for (int qt = warp; qt < key_tiles; qt += warps) {
      const int ra = qt * 16 + g;  // this thread's two query rows
      const int rb = ra + 8;
      const long long qa = (row0 + ra) * ld + head_off;
      const long long qb = (row0 + rb) * ld + head_off;

      // S = Q'·Kᵀ, 16 d at a time
      float s[2 * kKT][4];
#pragma unroll
      for (int t = 0; t < 2 * kKT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        const int c0 = kk * 16 + 2 * tig;
        const uint32_t a[4] = {q_pair(q, qa, ra < N, c0, scale),
                               q_pair(q, qb, rb < N, c0, scale),
                               q_pair(q, qa, ra < N, c0 + 8, scale),
                               q_pair(q, qb, rb < N, c0 + 8, scale)};
#pragma unroll
        for (int jt = 0; jt < kKT; ++jt) {
          if (jt < key_tiles) {
            uint32_t bk[4];  // keys 0-7 (d lo, hi), keys 8-15 (d lo, hi)
            ldsm_x4(bk, ks + (jt * 16 + (mi >> 1) * 8 + (lane & 7)) * kKS +
                            kk * 16 + (mi & 1) * 8);
            mma_bf16(s[2 * jt], a, bk[0], bk[1]);
            mma_bf16(s[2 * jt + 1], a, bk[2], bk[3]);
          }
        }
      }

      // + bias, keys past N masked (tiles past ceil(N/16) too: their
      // logits are 0 and their keys past N); row max and Σe over the quad
      if (even)
        add_bias_tiles<kKT, true>(s, bias_h, ra, rb, tig, N);
      else
        add_bias_tiles<kKT, false>(s, bias_h, ra, rb, tig, N);
      float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
      for (int t = 0; t < 2 * kKT; ++t) {
        mxa = fmaxf(mxa, fmaxf(s[t][0], s[t][1]));
        mxb = fmaxf(mxb, fmaxf(s[t][2], s[t][3]));
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, o));
        mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, o));
      }
      float suma = 0.f, sumb = 0.f;
#pragma unroll
      for (int t = 0; t < 2 * kKT; ++t) {
        s[t][0] = expf(s[t][0] - mxa);
        s[t][1] = expf(s[t][1] - mxa);
        s[t][2] = expf(s[t][2] - mxb);
        s[t][3] = expf(s[t][3] - mxb);
        suma += s[t][0] + s[t][1];
        sumb += s[t][2] + s[t][3];
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        suma += __shfl_xor_sync(0xffffffffu, suma, o);
        sumb += __shfl_xor_sync(0xffffffffu, sumb, o);
      }
      const float inva = 1.0f / suma;
      const float invb = 1.0f / sumb;

      if (kProbs) {
        // the TPU kernel's probs: (e · (1/Σe)) rounded to bf16, e unrounded
        const long long prow = (static_cast<long long>(b) * H + h) * N;
        bf16* pa = probs + (prow + ra) * N;
        bf16* pb = probs + (prow + rb) * N;
#pragma unroll
        for (int t = 0; t < 2 * kKT; ++t) {
          if (t * 8 < np) {
            const int j = t * 8 + 2 * tig;
            if (ra < N)
              store_pair(pa, j, N, even, s[t][0] * inva, s[t][1] * inva);
            if (rb < N)
              store_pair(pb, j, N, even, s[t][2] * invb, s[t][3] * invb);
          }
        }
      }

      // P's A fragments in registers: bf16(e), or bf16(e·(1/Σe))
      const float fa = kNormFirst ? inva : 1.f;
      const float fb = kNormFirst ? invb : 1.f;
      uint32_t p[kKT][4];
#pragma unroll
      for (int jt = 0; jt < kKT; ++jt) {
        p[jt][0] = pack_bf16(s[2 * jt][0] * fa, s[2 * jt][1] * fa);
        p[jt][1] = pack_bf16(s[2 * jt][2] * fb, s[2 * jt][3] * fb);
        p[jt][2] = pack_bf16(s[2 * jt + 1][0] * fa, s[2 * jt + 1][1] * fa);
        p[jt][3] = pack_bf16(s[2 * jt + 1][2] * fb, s[2 * jt + 1][3] * fb);
      }

      // O = P·V (16 x 64, f32)
      float o[kHeadDim / 8][4];
#pragma unroll
      for (int dt = 0; dt < kHeadDim / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
#pragma unroll
      for (int jt = 0; jt < kKT; ++jt) {
        if (jt < key_tiles) {
#pragma unroll
          for (int dd = 0; dd < kHeadDim / 16; ++dd) {
            uint32_t bv[4];  // d lo (keys 0-7, 8-15), d hi (keys 0-7, 8-15)
            ldsm_x4_t(bv, vs + (jt * 16 + (mi & 1) * 8 + (lane & 7)) * kKS +
                              dd * 16 + (mi >> 1) * 8);
            mma_bf16(o[2 * dd], p[jt], bv[0], bv[1]);
            mma_bf16(o[2 * dd + 1], p[jt], bv[2], bv[3]);
          }
        }
      }

      // out = bf16(O · 1/Σe), or bf16(O) when the numerators were normalized
      const float oa = kNormFirst ? 1.f : inva;
      const float ob = kNormFirst ? 1.f : invb;
#pragma unroll
      for (int dt = 0; dt < kHeadDim / 8; ++dt) {
        const int col = head_off + dt * 8 + 2 * tig;
        if (ra < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (row0 + ra) * C + col) =
              __floats2bfloat162_rn(o[dt][0] * oa, o[dt][1] * oa);
        if (rb < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (row0 + rb) * C + col) =
              __floats2bfloat162_rn(o[dt][2] * ob, o[dt][3] * ob);
      }
    }
    __syncthreads();  // K and V are reloaded for the next sample
  }
}

template <int kKT, bool kProbs, bool kNormFirst>
inline cudaError_t attention_run(const bf16* q, const bf16* k, const bf16* v,
                                 long long ld, const float* bias, bf16* out,
                                 bf16* probs, int B, int N, int C, int H,
                                 int warps, int samples, int smem,
                                 cudaStream_t stream) {
  auto* kern = attention_kernel<kKT, kProbs, kNormFirst>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));
  const dim3 grid(H, (B + samples - 1) / samples);
  kern<<<grid, warps * 32, smem, stream>>>(q, k, v, ld, bias, out, probs, B,
                                           N, C, samples, scale);
  return cudaGetLastError();
}

// The attention core: out (B·N, C) bf16 from q, k, v rows `ld` apart (see
// attention_kernel), and with kProbs the normalized probabilities
// (B, H, N, N) bf16. `plan` is the wrapper's launch plan
// (ops/kernels/fused_block.py `attention_plan`): the 16-key tile bucket,
// the warps of a CTA, the samples of a CTA and the shared bytes; a plan
// the kernel does not take is refused with cudaErrorInvalidValue.
template <bool kProbs, bool kNormFirst>
inline cudaError_t attention_launch(const bf16* q, const bf16* k,
                                    const bf16* v, long long ld,
                                    const float* bias, bf16* out, bf16* probs,
                                    int B, int N, int C, int H,
                                    const int* plan, cudaStream_t stream) {
  const int kt = plan[0], warps = plan[1], samples = plan[2], smem = plan[3];
  if (N < 1 || N > 256 || kt * 16 < N || warps < 1 ||
      warps > kAttnMaxWarps || samples < 1 || smem != attn_smem_bytes(N))
    return cudaErrorInvalidValue;
#define DM_ATTN_CASE(KT)                                                  \
  case KT:                                                                \
    return attention_run<KT, kProbs, kNormFirst>(q, k, v, ld, bias, out,  \
                                                 probs, B, N, C, H, warps, \
                                                 samples, smem, stream);
  switch (kt) {
    DM_ATTN_CASE(1)
    DM_ATTN_CASE(3)
    DM_ATTN_CASE(4)
    DM_ATTN_CASE(8)
    DM_ATTN_CASE(12)
    DM_ATTN_CASE(13)
    DM_ATTN_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef DM_ATTN_CASE
}

// The attention core over a packed (B·N, 3C) qkv, with or without probs.
template <bool kProbs>
inline cudaError_t attention_qkv(const bf16* qkv, const float* bias,
                                 bf16* out, bf16* probs, int B, int N, int C,
                                 int H, const int* plan,
                                 cudaStream_t stream) {
  return attention_launch<kProbs, false>(qkv, qkv + C, qkv + 2 * C, 3LL * C,
                                         bias, out, probs, B, N, C, H, plan,
                                         stream);
}

inline cudaError_t attention(const bf16* qkv, const float* bias, bf16* out,
                             int B, int N, int C, int H, const int* plan,
                             cudaStream_t stream) {
  return attention_qkv<false>(qkv, bias, out, nullptr, B, N, C, H, plan,
                              stream);
}

}  // namespace
