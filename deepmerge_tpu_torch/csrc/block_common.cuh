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
// multiplies by v). Above 256 tokens each of them takes the core's long
// route (attention_long_kernel), and rows wider than 1024 the wide
// LayerNorm's helpers (ln_wide_stats).

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

// Wider rows (1024 < C <= kLnMaxWide): one CTA of kLnWideThreads a row, the
// row staged in shared memory as f32 (32 KB at the widest), the same two
// f32 passes for the statistics.
constexpr int kLnWideThreads = 256;
constexpr int kLnMaxWide = 8192;

// The sum (kMax false) or the max of v over the CTA, in every thread; `red`
// holds a float for each warp.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read by the previous reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
    r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// Stages bf16 row xr (C % 8 == 0) as f32 into v, each thread its own
// 8-element pieces (it alone reads them back), and returns the row's mean
// and rsqrt(var + eps), two passes in f32 as the TPU kernel's `_ln`.
__device__ __forceinline__ float2 ln_wide_stats(const bf16* xr, float* v,
                                                float* red, int C) {
  float s = 0.f;
  for (int k = threadIdx.x * 8; k < C; k += blockDim.x * 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + k);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      v[k + t] = __bfloat162float(e[t]);
      s += v[k + t];
    }
  }
  const float mu = block_reduce<false>(s, red) / static_cast<float>(C);
  float q = 0.f;
  for (int k = threadIdx.x * 8; k < C; k += blockDim.x * 8) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float d = v[k + t] - mu;
      q += d * d;
    }
  }
  const float rs =
      rsqrtf(block_reduce<false>(q, red) / static_cast<float>(C) + kLnEps);
  return make_float2(mu, rs);
}

// ------------------------------------------------------------- attention

// The head widths both attention cores take (the template parameter kD of
// attention_kernel here and of fused_block_q8.cu's attention_q8_kernel):
// the widths the S2Former family's configurations use. The C entry points
// derive the width as C / H and refuse any other.
__host__ __device__ constexpr bool head_dim_ok(int d) {
  return d == 32 || d == 64 || d == 128;
}

// K/V shared row stride (bf16) at head width d: 80, 144 or 272 bytes, each
// an odd multiple of 16, so the eight rows of an ldmatrix 8x8 fall on eight
// different 4-bank groups.
__host__ __device__ constexpr int attn_row(int d) { return d + 8; }

// A CTA's warps at most, which is also the launch bound: 12 (168 registers
// a thread) at widths 32 and 64; 8 (255 registers) at width 128, whose
// O accumulators (64 f32 a thread) come on top of up to 128 logits.
__host__ __device__ constexpr int attn_max_warps(int d) {
  return d == 128 ? 8 : 12;
}
constexpr int kAttnPlanInts = 4;   // key-tile bucket, warps, samples, smem

// Shared memory of one attention CTA for n tokens at head width d: K and V
// of one sample and head, keys padded to the 16-wide MMA tile. At d 64:
// 55,296 B at n = 192, 59,904 B at n = 193, 73,728 B at n = 256.
__host__ __device__ inline int attn_smem_bytes(int n, int d) {
  return 2 * ((n + 15) / 16) * 16 * attn_row(d) * static_cast<int>(sizeof(bf16));
}

// d^-1/2 as the TPU kernel applies it to a bf16 q: a weakly typed Python
// float takes the array's dtype in JAX, so the factor is d^-1/2 rounded to
// bf16 (0.125 exactly at d 64; 0.1767578125 at 32, 0.08837890625 at 128).
inline float bf16_q_scale(int d) {
  return __bfloat162float(
      __float2bfloat16(static_cast<float>(1.0 / sqrt(static_cast<double>(d)))));
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
// kD is the head width (32, 64 or 128): the q·kᵀ k-loop takes kD/16 steps
// and the O accumulators are 16 x kD. kKT (a bucket of the 16-key tile
// count ceil(N/16)) sizes the register arrays; tiles past ceil(N/16) are
// skipped. q, k and v are the first rows of the three operands, each row
// `ld` elements apart (3C within a packed (B·N, 3C) qkv, C for (B, N, H,
// kD) tensors); the output rows are C apart. `scale` is bf16_q_scale(kD).
template <int kD, int kKT, bool kProbs, bool kNormFirst>
__global__ void __launch_bounds__(attn_max_warps(kD) * 32)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, long long ld,
                 const float* __restrict__ bias, bf16* __restrict__ out,
                 bf16* __restrict__ probs, int B, int N, int C, int samples,
                 float scale) {
  extern __shared__ __align__(16) unsigned char attn_smem[];
  const int key_tiles = (N + 15) >> 4;
  const int np = key_tiles * 16;
  bf16* ks = reinterpret_cast<bf16*>(attn_smem);
  constexpr int kKS = attn_row(kD);
  bf16* vs = ks + np * kKS;

  const int h = blockIdx.x;
  const int H = gridDim.x;
  const int head_off = h * kD;
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
    for (int idx = threadIdx.x; idx < np * (kD / 8); idx += blockDim.x) {
      const int j = idx / (kD / 8);  // 16-byte pieces of a row
      const int c = (idx % (kD / 8)) * 8;
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
      for (int kk = 0; kk < kD / 16; ++kk) {
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

      // O = P·V (16 x kD, f32)
      float o[kD / 8][4];
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
#pragma unroll
      for (int jt = 0; jt < kKT; ++jt) {
        if (jt < key_tiles) {
#pragma unroll
          for (int dd = 0; dd < kD / 16; ++dd) {
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
      for (int dt = 0; dt < kD / 8; ++dt) {
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

template <int kD, int kKT, bool kProbs, bool kNormFirst>
inline cudaError_t attention_run(const bf16* q, const bf16* k, const bf16* v,
                                 long long ld, const float* bias, bf16* out,
                                 bf16* probs, int B, int N, int C, int H,
                                 int warps, int samples, int smem,
                                 cudaStream_t stream) {
  auto* kern = attention_kernel<kD, kKT, kProbs, kNormFirst>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, (B + samples - 1) / samples);
  kern<<<grid, warps * 32, smem, stream>>>(q, k, v, ld, bias, out, probs, B,
                                           N, C, samples, bf16_q_scale(kD));
  return cudaGetLastError();
}

template <int kD, bool kProbs, bool kNormFirst>
inline cudaError_t attention_width(const bf16* q, const bf16* k,
                                   const bf16* v, long long ld,
                                   const float* bias, bf16* out, bf16* probs,
                                   int B, int N, int C, int H, int kt,
                                   int warps, int samples, int smem,
                                   cudaStream_t stream) {
  if (warps > attn_max_warps(kD)) return cudaErrorInvalidValue;
#define DM_ATTN_CASE(KT)                                                     \
  case KT:                                                                   \
    return attention_run<kD, KT, kProbs, kNormFirst>(                        \
        q, k, v, ld, bias, out, probs, B, N, C, H, warps, samples, smem,     \
        stream);
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

// ------------------------------------------------ attention, long route
//
// The short core above holds a query tile's logits over every key in
// registers, and one sample's K and V in shared memory: N <= 256. The long
// route takes any N up to kAttnMaxLongTokens (and any N at all when a plan
// forces it). A CTA of four warps takes one head (blockIdx.y), one sample
// (blockIdx.z) and 64 queries (blockIdx.x, 16 a warp); K and V stream
// through shared memory in 64-key blocks, cp.async into two buffers, the
// next block's copy in flight during the current block's products. The
// fragments and products are the short core's: Q' = bf16(q·d^-½) in
// m16n8k16 A fragments for the whole run, K's B fragments by ldmatrix,
// V's by ldmatrix.trans, P's A fragments from the accumulators.
//
// JAX rounds e = exp(l − max) to bf16 against the row's final max before
// the value product (`_attn_inner`); a one-pass online softmax would round
// against a running max and rescale, moving every rounding point. So the
// keys are streamed twice:
//  * pass 1 (K only): the logits + bias of each block, the f32 row max and
//    Σe online (Σ rescaled by exp(m_old − m_new) when the max grows);
//  * pass 2 (K and V): the same logits again, e = exp(l − m) against the
//    final max; with kProbs bf16(e·(1/Σe)) stored; P = bf16(e), or
//    bf16(e·(1/Σe)) with kNormFirst, into O (f32); out = bf16(O·(1/Σe)),
//    or bf16(O) with kNormFirst.
// Keys past N are zero-filled and masked to −inf; query rows past N are
// computed on zero q and not stored. The bias is read once a pass, through
// the short core's clamped loads.
constexpr int kAttnLongRoute = 0;   // plan[0] of the long route
constexpr int kAttnLongWarps = 4;
constexpr int kAttnLongQueries = 16 * kAttnLongWarps;
constexpr int kAttnLongKeys = 64;   // keys of a streamed block
// The route's sequence limit. Every offset into q, k, v, the bias, the
// probabilities and the output is 64-bit, and the grid takes ceil(N/64)
// query blocks in x; what bounds N is the operands: one head's (N, N) f32
// bias is 1 GiB at 16,384.
constexpr int kAttnMaxLongTokens = 16384;

// Shared memory of one long-route CTA: two buffers of a 64-key block of K
// and of V at the short core's row stride. 20,480 / 36,864 / 69,632 B at
// head width 32 / 64 / 128.
__host__ __device__ constexpr int attn_long_smem_bytes(int d) {
  return 2 * 2 * kAttnLongKeys * attn_row(d) * static_cast<int>(sizeof(bf16));
}

// + bias over a block's eight 8-key tiles from key j0, keys past N masked
template <bool kEven>
__device__ __forceinline__ void add_bias_block(float (&s)[8][4],
                                               const float* bias_h, int ra,
                                               int rb, int j0, int tig,
                                               int N) {
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int j = j0 + t * 8 + 2 * tig;
    const float2 ba = bias_load<kEven>(bias_h, ra, j, N);
    const float2 bb = bias_load<kEven>(bias_h, rb, j, N);
    add_bias(s[t][0], s[t][1], ba, ra, j, N);
    add_bias(s[t][2], s[t][3], bb, rb, j, N);
  }
}

template <int kD, bool kProbs, bool kNormFirst>
__global__ void __launch_bounds__(kAttnLongWarps * 32)
attention_long_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, long long ld,
                      const float* __restrict__ bias, bf16* __restrict__ out,
                      bf16* __restrict__ probs, int N, int C, float scale) {
  extern __shared__ __align__(16) unsigned char attn_long_smem[];
  constexpr int kKS = attn_row(kD);
  constexpr int kBuf = kAttnLongKeys * kKS;  // one buffer of K or V
  bf16* ks = reinterpret_cast<bf16*>(attn_long_smem);
  bf16* vs = ks + 2 * kBuf;

  const int h = blockIdx.y;
  const int H = gridDim.y;
  const int b = blockIdx.z;
  const int head_off = h * kD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int mi = lane >> 3;  // the 8x8 matrix this lane addresses
  const bool even = (N & 1) == 0;
  const float* bias_h = bias + static_cast<long long>(h) * N * N;
  const long long row0 = static_cast<long long>(b) * N;
  const int ra = blockIdx.x * kAttnLongQueries + warp * 16 + g;
  const int rb = ra + 8;

  // Q' = bf16(q·d^-½) of the warp's 16 rows, A fragments of the d steps
  uint32_t qf[kD / 16][4];
  {
    const long long qa = (row0 + ra) * ld + head_off;
    const long long qb = (row0 + rb) * ld + head_off;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int c0 = kk * 16 + 2 * tig;
      qf[kk][0] = q_pair(q, qa, ra < N, c0, scale);
      qf[kk][1] = q_pair(q, qb, rb < N, c0, scale);
      qf[kk][2] = q_pair(q, qa, ra < N, c0 + 8, scale);
      qf[kk][3] = q_pair(q, qb, rb < N, c0 + 8, scale);
    }
  }

  const int kblocks = (N + kAttnLongKeys - 1) / kAttnLongKeys;
  const int steps = 2 * kblocks;  // pass 1, then pass 2
  // the copy of step s (block s mod kblocks; V too in pass 2) into buf
  auto stage = [&](int s, int buf) {
    const int j0 = (s % kblocks) * kAttnLongKeys;
    const bool with_v = s >= kblocks;
    bf16* kd = ks + buf * kBuf;
    bf16* vd = vs + buf * kBuf;
    for (int idx = threadIdx.x; idx < kAttnLongKeys * (kD / 8);
         idx += blockDim.x) {
      const int jj = idx / (kD / 8);  // 16-byte pieces of a row
      const int c = (idx % (kD / 8)) * 8;
      const bool in = j0 + jj < N;
      const long long off = in ? (row0 + j0 + jj) * ld + head_off + c : 0;
      cp_async16(kd + jj * kKS + c, k + off, in);
      if (with_v) cp_async16(vd + jj * kKS + c, v + off, in);
    }
    cp_async_commit();
  };

  float mxa = -INFINITY, mxb = -INFINITY;  // the quad's row maxima
  float suma = 0.f, sumb = 0.f;            // this thread's part of Σe
  float inva = 0.f, invb = 0.f;
  float o[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

  stage(0, 0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      stage(s + 1, (s + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kd = ks + (s & 1) * kBuf;
    const bf16* vd = vs + (s & 1) * kBuf;
    const int j0 = (s % kblocks) * kAttnLongKeys;

    // S = Q'·Kᵀ over the block's 64 keys, + bias
    float sc[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) {
        uint32_t bk[4];  // keys 0-7 (d lo, hi), keys 8-15 (d lo, hi)
        ldsm_x4(bk, kd + (jt * 16 + (mi >> 1) * 8 + (lane & 7)) * kKS +
                        kk * 16 + (mi & 1) * 8);
        mma_bf16(sc[2 * jt], qf[kk], bk[0], bk[1]);
        mma_bf16(sc[2 * jt + 1], qf[kk], bk[2], bk[3]);
      }
    }
    if (even)
      add_bias_block<true>(sc, bias_h, ra, rb, j0, tig, N);
    else
      add_bias_block<false>(sc, bias_h, ra, rb, j0, tig, N);

    if (s < kblocks) {
      // pass 1: the row max over the quad, Σe rescaled to it
      float bma = -INFINITY, bmb = -INFINITY;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        bma = fmaxf(bma, fmaxf(sc[t][0], sc[t][1]));
        bmb = fmaxf(bmb, fmaxf(sc[t][2], sc[t][3]));
      }
#pragma unroll
      for (int w = 1; w <= 2; w <<= 1) {
        bma = fmaxf(bma, __shfl_xor_sync(0xffffffffu, bma, w));
        bmb = fmaxf(bmb, __shfl_xor_sync(0xffffffffu, bmb, w));
      }
      const float na = fmaxf(mxa, bma), nb = fmaxf(mxb, bmb);
      float ea = 0.f, eb = 0.f;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        ea += expf(sc[t][0] - na) + expf(sc[t][1] - na);
        eb += expf(sc[t][2] - nb) + expf(sc[t][3] - nb);
      }
      suma = suma * expf(mxa - na) + ea;
      sumb = sumb * expf(mxb - nb) + eb;
      mxa = na;
      mxb = nb;
    } else {
      if (s == kblocks) {  // Σe over the quad, once
#pragma unroll
        for (int w = 1; w <= 2; w <<= 1) {
          suma += __shfl_xor_sync(0xffffffffu, suma, w);
          sumb += __shfl_xor_sync(0xffffffffu, sumb, w);
        }
        inva = 1.0f / suma;
        invb = 1.0f / sumb;
      }
      // pass 2: e against the final max
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        sc[t][0] = expf(sc[t][0] - mxa);
        sc[t][1] = expf(sc[t][1] - mxa);
        sc[t][2] = expf(sc[t][2] - mxb);
        sc[t][3] = expf(sc[t][3] - mxb);
      }
      if (kProbs) {
        // the TPU kernel's probs: (e · (1/Σe)) rounded to bf16
        const long long prow = (static_cast<long long>(b) * H + h) * N;
        bf16* pa = probs + (prow + ra) * N;
        bf16* pb = probs + (prow + rb) * N;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int j = j0 + t * 8 + 2 * tig;
          if (ra < N)
            store_pair(pa, j, N, even, sc[t][0] * inva, sc[t][1] * inva);
          if (rb < N)
            store_pair(pb, j, N, even, sc[t][2] * invb, sc[t][3] * invb);
        }
      }
      const float fa = kNormFirst ? inva : 1.f;
      const float fb = kNormFirst ? invb : 1.f;
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) {
        uint32_t p[4];
        p[0] = pack_bf16(sc[2 * jt][0] * fa, sc[2 * jt][1] * fa);
        p[1] = pack_bf16(sc[2 * jt][2] * fb, sc[2 * jt][3] * fb);
        p[2] = pack_bf16(sc[2 * jt + 1][0] * fa, sc[2 * jt + 1][1] * fa);
        p[3] = pack_bf16(sc[2 * jt + 1][2] * fb, sc[2 * jt + 1][3] * fb);
#pragma unroll
        for (int dd = 0; dd < kD / 16; ++dd) {
          uint32_t bv[4];  // d lo (keys 0-7, 8-15), d hi (keys 0-7, 8-15)
          ldsm_x4_t(bv, vd + (jt * 16 + (mi & 1) * 8 + (lane & 7)) * kKS +
                            dd * 16 + (mi >> 1) * 8);
          mma_bf16(o[2 * dd], p, bv[0], bv[1]);
          mma_bf16(o[2 * dd + 1], p, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // the buffer is refilled two steps on
  }

  // out = bf16(O · 1/Σe), or bf16(O) when the numerators were normalized
  const float oa = kNormFirst ? 1.f : inva;
  const float ob = kNormFirst ? 1.f : invb;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int col = head_off + dt * 8 + 2 * tig;
    if (ra < N)
      *reinterpret_cast<__nv_bfloat162*>(out + (row0 + ra) * C + col) =
          __floats2bfloat162_rn(o[dt][0] * oa, o[dt][1] * oa);
    if (rb < N)
      *reinterpret_cast<__nv_bfloat162*>(out + (row0 + rb) * C + col) =
          __floats2bfloat162_rn(o[dt][2] * ob, o[dt][3] * ob);
  }
}

template <int kD, bool kProbs, bool kNormFirst>
inline cudaError_t attention_long_run(const bf16* q, const bf16* k,
                                      const bf16* v, long long ld,
                                      const float* bias, bf16* out,
                                      bf16* probs, int B, int N, int C, int H,
                                      cudaStream_t stream) {
  auto* kern = attention_long_kernel<kD, kProbs, kNormFirst>;
  constexpr int smem = attn_long_smem_bytes(kD);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kAttnLongQueries - 1) / kAttnLongQueries, H, B);
  kern<<<grid, kAttnLongWarps * 32, smem, stream>>>(q, k, v, ld, bias, out,
                                                    probs, N, C,
                                                    bf16_q_scale(kD));
  return cudaGetLastError();
}

// The long route's plan (`attention_plan` with route "long"): the route's
// marker, its four warps, one sample a CTA and its shared bytes.
inline bool attn_long_plan_ok(const int* plan, int B, int N, int H, int d,
                              int smem_bytes) {
  return plan[0] == kAttnLongRoute && plan[1] == kAttnLongWarps &&
         plan[2] == 1 && plan[3] == smem_bytes && N >= 1 &&
         N <= kAttnMaxLongTokens && B >= 1 && B <= 65535 && H >= 1 &&
         H <= 65535 && head_dim_ok(d);
}

// The attention core: out (B·N, C) bf16 from q, k, v rows `ld` apart (see
// attention_kernel), and with kProbs the normalized probabilities
// (B, H, N, N) bf16. The head width is C / H, one of 32, 64 and 128.
// `plan` is the wrapper's launch plan (ops/kernels/fused_block.py
// `attention_plan` at that width): the 16-key tile bucket, the warps of a
// CTA, the samples of a CTA and the shared bytes of the short core, or
// the long route's plan (attn_long_plan_ok), which launches
// attention_long_kernel; a width or plan the kernels do not take is
// refused with cudaErrorInvalidValue.
template <bool kProbs, bool kNormFirst>
inline cudaError_t attention_launch(const bf16* q, const bf16* k,
                                    const bf16* v, long long ld,
                                    const float* bias, bf16* out, bf16* probs,
                                    int B, int N, int C, int H,
                                    const int* plan, cudaStream_t stream) {
  const int kt = plan[0], warps = plan[1], samples = plan[2], smem = plan[3];
  const int d = H > 0 && C % H == 0 ? C / H : 0;
  if (kt == kAttnLongRoute) {
    if (!attn_long_plan_ok(plan, B, N, H, d, attn_long_smem_bytes(d)))
      return cudaErrorInvalidValue;
    switch (d) {
      case 32:
        return attention_long_run<32, kProbs, kNormFirst>(
            q, k, v, ld, bias, out, probs, B, N, C, H, stream);
      case 64:
        return attention_long_run<64, kProbs, kNormFirst>(
            q, k, v, ld, bias, out, probs, B, N, C, H, stream);
      default:
        return attention_long_run<128, kProbs, kNormFirst>(
            q, k, v, ld, bias, out, probs, B, N, C, H, stream);
    }
  }
  if (!head_dim_ok(d) || N < 1 || N > 256 || kt * 16 < N || warps < 1 ||
      samples < 1 || smem != attn_smem_bytes(N, d))
    return cudaErrorInvalidValue;
  switch (d) {
    case 32:
      return attention_width<32, kProbs, kNormFirst>(
          q, k, v, ld, bias, out, probs, B, N, C, H, kt, warps, samples, smem,
          stream);
    case 64:
      return attention_width<64, kProbs, kNormFirst>(
          q, k, v, ld, bias, out, probs, B, N, C, H, kt, warps, samples, smem,
          stream);
    default:
      return attention_width<128, kProbs, kNormFirst>(
          q, k, v, ld, bias, out, probs, B, N, C, H, kt, warps, samples, smem,
          stream);
  }
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
