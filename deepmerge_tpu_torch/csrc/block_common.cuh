// Pieces shared by the bf16 block kernels (fused_block.cu, K2/K3 and the
// training block K5), the w8a8 block kernels (fused_block_q8.cu, K4) and
// the attention kernels (attention_probs.cu: K6 saved-probs;
// fused_attention.cu: K7 packed qkv, K8 (B, N, H, D)): warp reductions, bf16 rounding, the tanh GELU,
// cp.async, ldmatrix and mma.sync, and the bf16 attention core, which K4
// runs unchanged (the JAX
// package keeps the attention of its w8a8 block in bf16 unless `quant_attn`
// sends it to K4a's int8 core in fused_block_q8.cu: `_attn_inner`,
// deepmerge_tpu/ops/pallas/fused_block.py), K6 runs with kProbs set, K7
// as K2 does, K8 with kNormFirst on separate q, k, v, and K5 with kProbs
// and kNormFirst together (its probabilities are the normalized ones it
// multiplies by v). Above 256 tokens each of them takes the core's long
// route (attention_long_kernel, on hopper.cuh's TMA and wgmma). Both
// LayerNorms share group_reduce, the reduction over a row's warps.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

// LayerNorm row kernels: 8 warps a CTA, one warp a row up to C 1024
constexpr int kLnWarps = 8;
constexpr int kLnMaxVec = 4;  // 8-element vectors per lane: C <= 1024

// Wider rows, 1024 < C <= kLnMaxWide: both LayerNorms (fused_block.cu
// layer_norm_kernel, fused_block_q8.cu ln_quant_kernel) keep a row in
// registers, one warp a row up to C 2048, two or four warps above.
constexpr int kLnMaxWide = 8192;

// The sum (kMax false) or the max of v over the kGroup warps of the
// thread's row, in each of them: a warp's reduction, then (kGroup > 1) one
// float a warp through `red` (kLnWarps floats, one array for each
// reduction of a row), the group's warps meeting at a named barrier of
// their own (1 + group index).
template <int kGroup, bool kMax = false>
__device__ __forceinline__ float group_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  if constexpr (kGroup == 1) {
    return v;
  } else {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + warp / kGroup),
                 "n"(32 * kGroup)
                 : "memory");
    const int first = warp - warp % kGroup;
    float r = red[first];
#pragma unroll
    for (int i = 1; i < kGroup; ++i)
      r = kMax ? fmaxf(r, red[first + i]) : r + red[first + i];
    return r;
  }
}

// ------------------------------------------------------------- attention

// The head widths the attention cores take: any d with 8 <= d <= 8192 and
// d % 8 == 0 (16-byte rows of bf16; TMA's strides). A head of width d up to
// 256 runs on the core instance of width core_width(d), the template
// parameter kD of attention_kernel and attention_long_kernel here and of
// fused_block_q8.cu's int8 cores: 32, 64, 128 or 256. Lanes d..kD-1 of k
// and v are read as zeros (the int8 cores' q, k and v codes there are 0),
// so they carry no value into any output; only the d real lanes are
// written. The short cores have no instance of width 256 (their O
// accumulators, kD / 2 f32 a thread, would come on top of up to 128
// logits): above kShortMaxWidth every N takes the long route. A head wider
// than 256 runs on the long route's wide form (core_width kWideCore:
// attention_wide_kernel here, attention_q8_wide_kernel in fused_block_q8.cu),
// which takes d in 128-lane chunks. The C entry points derive the width as
// C / H and refuse any other, and any plan of the wrong route.
// A head whose true width is not a multiple of 8 travels on a zero-padded
// layout (ops/kernels/fused_block.py `PaddedWidths`): d is then the
// layout's width C / H, its lanes past the true width hold zeros in q, k
// and v, and the entry points take the true width `d_scale` for the
// softmax scale alone (scale_width_ok).
constexpr int kMaxHeadDim = 8192;
constexpr int kShortMaxWidth = 128;
constexpr int kWideCore = kMaxHeadDim;  // core_width of every d above 256
__host__ __device__ constexpr bool head_dim_ok(int d) {
  return d % 8 == 0 && d >= 8 && d <= kMaxHeadDim;
}
// The true head width whose d^-1/2 scales q, on a layout of width d: within
// the eight lanes below it (sixteen where an int8 block's GEMMs round the
// attention's width to 16 bytes, a head of width d_scale then taking a
// layout of round_up(d_scale, 16)).
__host__ __device__ constexpr bool scale_width_ok(int d_scale, int d) {
  return d_scale >= 1 && d_scale <= d && d_scale > d - 16;
}
// A block's widths: the residual stream's C (its LayerNorm statistics over
// the first Cn lanes) within the attention's A, whose buffer also holds
// the LayerNorm outputs.
__host__ __device__ constexpr bool block_widths_ok(int C, int A, int Cn) {
  return Cn >= 1 && Cn <= C && C <= A;
}
__host__ __device__ constexpr int core_width(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : d <= 256 ? 256
                                                                  : kWideCore;
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
// bf16 (0.125 exactly at d 64; 0.1767578125 at 32, 0.08837890625 at 128),
// at the head's true width d, not its core's.
inline float bf16_q_scale(int d) {
  return __bfloat162float(
      __float2bfloat16(static_cast<float>(1.0 / sqrt(static_cast<double>(d)))));
}

// Column c of q's head, clamped into its d lanes where q is a tensor of its
// own (K8's form, the only one normalized first without probabilities:
// kNormFirst && !kProbs), else c itself (lanes past d are then the next
// head's, or k's, in the same packed qkv row).
template <bool kClamp>
__device__ __forceinline__ int q_col(int c, int d) {
  return kClamp ? min(c, d - 2) : c;
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
// kD is the core's width (32, 64 or 128), d <= kD the head's (d % 8 == 0,
// core_width(d) == kD): K's and V's lanes past d are zero-filled in shared
// memory, so the kD-wide loops add 0 there whatever q holds, and of the
// 16 x kD O accumulators the d real columns are stored. q's lanes past d
// are the next head's (or, for the last head of a packed qkv, k's): in the
// row, finite. Only K8's q, a (B, N, H, d) tensor of its own (q_col),
// would read past its end there, so it clamps them to the head's own
// lanes. A branch around a step of the unrolled loops cost the
// full widths a quarter of their time, a predicate or a clamp of each q
// load 3-23% (the register-bound buckets most): the width enters the
// other cores' loops not at all. kKT (a bucket of the 16-key tile count ceil(N/16)) sizes
// the register arrays; tiles past ceil(N/16) are skipped. q, k and v are
// the first rows of the three operands, each row `ld` elements apart (3C
// within a packed (B·N, 3C) qkv, C for (B, N, H, d) tensors), head h's
// lanes d·h on; the output rows are C apart. `scale` is bf16_q_scale of the
// head's true width (d, or d_scale on a padded layout).
template <int kD, int kKT, bool kProbs, bool kNormFirst>
__global__ void __launch_bounds__(attn_max_warps(kD) * 32)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, long long ld,
                 const float* __restrict__ bias, bf16* __restrict__ out,
                 bf16* __restrict__ probs, int B, int N, int C, int d,
                 int samples, float scale) {
  extern __shared__ __align__(16) unsigned char attn_smem[];
  const int key_tiles = (N + 15) >> 4;
  const int np = key_tiles * 16;
  bf16* ks = reinterpret_cast<bf16*>(attn_smem);
  constexpr int kKS = attn_row(kD);
  bf16* vs = ks + np * kKS;

  const int h = blockIdx.x;
  const int H = gridDim.x;
  const int head_off = h * d;
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
      const bool in = j < N && c < d;
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
        constexpr bool kClamp = kNormFirst && !kProbs;  // K8's own q
        const int c0 = q_col<kClamp>(kk * 16 + 2 * tig, d);
        const int c1 = q_col<kClamp>(kk * 16 + 2 * tig + 8, d);
        const uint32_t a[4] = {q_pair(q, qa, ra < N, c0, scale),
                               q_pair(q, qb, rb < N, c0, scale),
                               q_pair(q, qa, ra < N, c1, scale),
                               q_pair(q, qb, rb < N, c1, scale)};
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
        // the d real columns (a branch, not a predicate of each store: the
        // per-column predicates, hoisted out of the tile loop, spilled the
        // register-bound buckets)
        if (dt * 8 >= d) break;
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
                                 float scale, cudaStream_t stream) {
  auto* kern = attention_kernel<kD, kKT, kProbs, kNormFirst>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, (B + samples - 1) / samples);
  const int d = C / H;
  kern<<<grid, warps * 32, smem, stream>>>(q, k, v, ld, bias, out, probs, B,
                                           N, C, d, samples, scale);
  return cudaGetLastError();
}

template <int kD, bool kProbs, bool kNormFirst>
inline cudaError_t attention_width(const bf16* q, const bf16* k,
                                   const bf16* v, long long ld,
                                   const float* bias, bf16* out, bf16* probs,
                                   int B, int N, int C, int H, int kt,
                                   int warps, int samples, int smem,
                                   float scale, cudaStream_t stream) {
  if (warps > attn_max_warps(kD)) return cudaErrorInvalidValue;
#define DM_ATTN_CASE(KT)                                                     \
  case KT:                                                                   \
    return attention_run<kD, KT, kProbs, kNormFirst>(                        \
        q, k, v, ld, bias, out, probs, B, N, C, H, warps, samples, smem,     \
        scale, stream);
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
// forces it): a CTA takes 128 queries (blockIdx.x) of one head (blockIdx.z,
// the slowest, so that one head's bias stays in L2 while its samples pass)
// and kSamples samples at a time, the groups blockIdx.y, blockIdx.y +
// gridDim.y, ... one after another.
//
// JAX rounds e = exp(l − max) to bf16 against the row's final max before
// the value product (`_attn_inner`); a one-pass online softmax would round
// against a running max and rescale, moving every rounding point. So the
// keys are streamed twice, in blocks of 64:
//  * pass 1 (K): the logits + bias of each block, the f32 row max and Σe
//    online (Σ rescaled by exp(m_old − m_new) when the max grows);
//  * pass 2 (K and V): the same logits again, e = exp(l − m) against the
//    final max; with kProbs bf16(e·(1/Σe)) stored; P = bf16(e), or
//    bf16(e·(1/Σe)) with kNormFirst, into O (f32); out = bf16(O·(1/Σe)),
//    or bf16(O) with kNormFirst.
// exp(x) is exp2f(x·log₂e), log₂e folded into the logits (one fused
// multiply-add and the special-function unit's 2^x). Keys past N are
// zero-filled and masked to −inf; query rows past N are computed and not
// stored.
//
// Bound on the H100: at B 128, N 768, d 64 the products take 0.23 ms at
// the bf16 peak (the two passes 1.5x that); the f32 (N, N) bias, read for
// every query row of every sample in both passes, is 7.2 GB, from L2 (one
// head's bias is 2.4 MB); the softmax's f32 work per logit is several
// times a product's issue slots, and its chains (logits, max, exp, sum)
// wait on the tensor cores and on each other, so what the kernel needs most
// is warps in flight. The design:
//  * a CTA of kSamples x 2 warpgroups, each 64 query rows (the wgmma M) of
//    one sample: two samples at d 32 and 64 (512 threads, 128 registers a
//    thread), one at d 128 and 256 (its O accumulators double); the two
//    samples read one bias tile;
//  * at d 256, pass 2 runs once for each half of the head's lanes
//    (attn_long_parts): the same S products again (the same operands in
//    the same wgmma order, so the same logits), O and V of 128 lanes a
//    part, so that O stays 64 f32 a thread, the width-128 instance's
//    budget beside Q''s 64 fragment registers; the probabilities are
//    stored in the first part only. Splitting P·V by output lanes changes
//    no sum (each lane's f32 sum runs over the keys in the same order).
//    The cost is a third S product a key block;
//  * a ring of kStages stages in shared memory (three; two with kProbs or
//    at d 256), each a 64-key block of K (and, in pass 2, V or its part) of
//    each sample by TMA from
//    4-D tensor maps over (d, H, N, B) (lanes past the head's d, rows past N
//    read as zeros) in the 128-byte swizzle (64-byte at width 32) that wgmma
//    reads (at d 256 only K's boxes that hold lanes below d: the rest are
//    zeroed once), completing on the stage's `full` mbarrier; warp 0
//    refills the stage of step it + 1 at step it, once every warpgroup has
//    released it (`empty`);
//  * the bias in one of three forms (attn_long_bias_mode): where the CTA's
//    128 bias rows fit the bias region, one bulk copy of them (a slab, read
//    for every sample the CTA takes: the grid then holds fewer CTAs, each
//    taking several sample groups); else, where a row is a multiple of 16
//    bytes, a 128 x 64 tile a stage by TMA (two 32-column boxes in the
//    128-byte swizzle, so a warp's reads of 8 rows hit each bank twice);
//    else a 272-byte bulk copy a row a stage (slow: many small copies);
//  * Q' = bf16(q·d^-½) of a warpgroup's 64 rows in wgmma A fragments in
//    registers for a sample (the mma.sync m16n8k16 A layout, which is a
//    warp's slice of wgmma's);
//  * S = Q'·Kᵀ by wgmma m64n64k16, K K-major from shared memory; the
//    accumulators are in the short core's layout, so the bias add, the
//    mask and the softmax are the short core's;
//  * O += P·V by wgmma m64n{d}k16 (two n64 halves at d 128 and in each
//    part at d 256), P as register A fragments made from the accumulators,
//    V MN-major from shared memory (transposed by the instruction);
//  * with kProbs, each warp stages its 16 x 64 bf16 probabilities in
//    shared memory and writes them in 16-byte pieces.
// Shared memory: kAttnLongSmem, one CTA an SM.
constexpr int kAttnLongRoute = 0;      // plan[0] of the long route
constexpr int kAttnLongQueries = 128;  // query rows of a CTA, 64 a warpgroup
constexpr int kAttnLongKeys = 64;      // keys of a streamed block
// The route's sequence limit. Every offset into q, k, v, the bias, the
// probabilities and the output is 64-bit; what bounds N is the operands:
// one head's (N, N) f32 bias is 1 GiB at 16,384.
constexpr int kAttnMaxLongTokens = 16384;
// A slab-form launch's CTAs: about 16 an SM of 132, each taking
// ceil(groups · CTAs-a-group / 2048) sample groups
constexpr int kAttnLongSlabCtas = 2048;
// Shared bytes of every long-route CTA (the most a CTA may take), of which
// up to 1 KB aligns the ring to the swizzle's 1024 bytes
constexpr int kAttnLongSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;

// Samples a CTA takes at a time, its warps, pass 2's parts (the output
// lanes split in kD / 128 parts above 128), the ring's stages (of width d,
// the instance's)
__host__ __device__ constexpr int attn_long_samples(int d) {
  return d >= 128 ? 1 : 2;
}
__host__ __device__ constexpr int attn_long_warps(int d) {
  return 8 * attn_long_samples(d);
}
__host__ __device__ constexpr int attn_long_parts(int d) {
  return d > kShortMaxWidth ? d / kShortMaxWidth : 1;
}
__host__ __device__ constexpr int attn_long_stages(int d, bool probs) {
  return probs || d > kShortMaxWidth ? 2 : 3;
}
// Bytes of one sample's 64-key block of K, and of V's part of it
__host__ __device__ constexpr int attn_long_kv_bytes(int d) {
  return kAttnLongKeys * d * static_cast<int>(sizeof(bf16));
}
__host__ __device__ constexpr int attn_long_v_bytes(int d) {
  return attn_long_kv_bytes(d) / attn_long_parts(d);
}
// A stage's bias area: the TMA tile (two 128 x 32 f32 boxes, 32 KB), or the
// row copies' tile, 128 rows of 64 keys and the up to 3 floats before them
// in their row's first 16 bytes, at a stride of 68 floats (272 B)
constexpr int kAttnLongBiasLd = kAttnLongKeys + 4;
constexpr int kAttnLongBiasBytes = kAttnLongQueries * kAttnLongBiasLd * 4;
// A warp's probability staging tile: 16 rows of 64 bf16 at a stride of 72
constexpr int kAttnLongProbsLd = kAttnLongKeys + 8;
constexpr int kAttnLongProbsBytes = 16 * kAttnLongProbsLd * 2;

// The CTA's shared memory from its 1024-aligned start: the K/V ring (stage
// st holds K of each sample, then V (its part) of each), the bias region
// (the stages' bias areas, or a slab), the warps' probability staging
// (kProbs), the barriers (each stage's full and empty, then the slab's).
__host__ __device__ constexpr int attn_long_stage_bytes(int d) {
  return attn_long_samples(d) * (attn_long_kv_bytes(d) + attn_long_v_bytes(d));
}
__host__ __device__ constexpr int attn_long_bar_bytes(int d, bool probs) {
  return ((2 * attn_long_stages(d, probs) + 1) * 8 + 15) / 16 * 16;
}
__host__ __device__ constexpr int attn_long_staging_bytes(int d, bool probs) {
  return probs ? attn_long_warps(d) * kAttnLongProbsBytes : 0;
}
__host__ __device__ constexpr int attn_long_region_off(int d, bool probs) {
  return attn_long_stages(d, probs) * attn_long_stage_bytes(d);
}
// 133,056 B at d 64 (128,976 with kProbs), 182,208 at d 32 (161,744),
// 133,056 at d 128 (147,408), 133,072 at d 256 (114,640)
__host__ __device__ constexpr int attn_long_region_bytes(int d, bool probs) {
  return kAttnLongSmem - 1024 - attn_long_region_off(d, probs) -
         attn_long_staging_bytes(d, probs) - attn_long_bar_bytes(d, probs);
}

enum AttnLongBias { kBiasSlab = 0, kBiasTiles = 1, kBiasRows = 2 };

// The bias form of a long-route launch whose bias region holds
// `region_bytes`: the slab where 128 rows of N floats and their first
// piece's shift fit it, tiles where N % 4 == 0, rows otherwise. (The bf16
// route: N <= 259 at d 64, 128 and 256, 251 at d 64 and 223 at d 256 with
// kProbs; K4a's, whose
// stages are smaller, see fused_block_q8.cu.)
__host__ __device__ inline int long_bias_mode(int N, int region_bytes) {
  if (static_cast<long long>(kAttnLongQueries) * N * 4 + 16 <= region_bytes)
    return kBiasSlab;
  return N % 4 == 0 ? kBiasTiles : kBiasRows;
}

__host__ __device__ inline int attn_long_bias_mode(int N, int d, bool probs) {
  return long_bias_mode(N, attn_long_region_bytes(d, probs));
}

// gridDim.y of a long-route launch in bias form `mode`: every group of
// `samples` samples its own CTA, but in the slab form ceil(groups · (CTAs
// a group) / kAttnLongSlabCtas) groups a CTA, CTA y taking groups y, y +
// gridDim.y, ...
__host__ __device__ inline int long_sample_groups(int B, int N, int H,
                                                  int samples, int mode) {
  const int groups = (B + samples - 1) / samples;
  if (mode != kBiasSlab) return groups;
  const long long ctas = static_cast<long long>(
      (N + kAttnLongQueries - 1) / kAttnLongQueries) * H;
  const long long per =
      (static_cast<long long>(groups) * ctas + kAttnLongSlabCtas - 1) /
      kAttnLongSlabCtas;
  return static_cast<int>((groups + per - 1) / per);
}

__host__ __device__ inline int attn_long_sample_groups(int B, int N, int H,
                                                       int d, bool probs) {
  return long_sample_groups(B, N, H, attn_long_samples(d),
                            attn_long_bias_mode(N, d, probs));
}

// The index within its 16-byte piece of the bias float at p (0..3).
__device__ __forceinline__ int bias_shift(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Warp 0's bias for a stage in the row form (a bias whose CTA rows fit no
// slab and are not 16-byte multiples): the CTA's 128 rows for the keys
// from j0 into the stage's area bt, row lane + 32·r (row N - 1 for rows
// past N) from the 16-byte piece that holds its key j0, one bulk copy a
// row at a stride of kAttnLongBiasLd floats; within the bias, a row's last
// floats past a whole piece are copied by its lane before the lane arrives
// on `bar` expecting its copies' bytes.
__device__ __forceinline__ void long_bias_rows(float* bt, const float* bias_h,
                                               const float* bias_end, int q0,
                                               int j0, int N, int lane,
                                               uint64_t* bar) {
  const float* src[4];
  int bytes[4], total = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = lane + 32 * r;
    const float* a =
        bias_h + static_cast<long long>(min(q0 + row, N - 1)) * N + j0;
    src[r] = a - bias_shift(a);
    const long long room = (bias_end - src[r]) * 4;
    bytes[r] = room >= kAttnLongBiasLd * 4
                   ? kAttnLongBiasLd * 4
                   : static_cast<int>(room & ~15LL);
    total += bytes[r];
    float* dst = bt + row * kAttnLongBiasLd;
    for (int t = bytes[r] / 4;
         t < kAttnLongBiasLd && src[r] + t < bias_end; ++t)
      dst[t] = src[r][t];
  }
  mbar_expect_tx(bar, total);
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (bytes[r] > 0)
      bulk_load(bt + (lane + 32 * r) * kAttnLongBiasLd, src[r], bytes[r],
                bar);
}

// Lane 0 of warp 0, in the slab form: the CTA's 128 bias rows of N floats
// from the 16-byte piece at slab_src (slab_shift floats before row q0's
// first) into `region` by one bulk copy; within the bias, its last floats
// past a whole piece copied here before the arrival on `bar`.
__device__ __forceinline__ void long_bias_slab(float* region,
                                               const float* slab_src,
                                               const float* bias_end, int N,
                                               int slab_shift,
                                               uint64_t* bar) {
  const long long want =
      (static_cast<long long>(kAttnLongQueries) * N + slab_shift) * 4;
  const long long room = (bias_end - slab_src) * 4;
  const int bytes = static_cast<int>(
      room >= ((want + 15) & ~15LL) ? (want + 15) & ~15LL : room & ~15LL);
  for (long long t = bytes / 4; t * 4 < want && slab_src + t < bias_end; ++t)
    region[t] = slab_src[t];
  mbar_expect_tx(bar, bytes);
  if (bytes > 0) bulk_load(region, slab_src, bytes, bar);
}

// Where the bias row of a thread's query row r (l within the CTA's 128)
// starts: in the slab, or within a stage's row-form tile; plus the
// quad's column 2·tig.
__device__ __forceinline__ int long_bias_lin(bool slab, int slab_shift,
                                             const float* bias_h, int l,
                                             int r, int N, int tig) {
  return (slab ? slab_shift + l * N
               : l * kAttnLongBiasLd +
                     bias_shift(bias_h +
                                static_cast<long long>(min(r, N - 1)) * N)) +
         2 * tig;
}

// In the tile form, the thread's pairs of row la in the first box, key
// tile t: 16-byte piece c = 2t + tig / 2 of a 128-byte row at piece
// c ^ (row mod 8), then 8·(tig mod 2) bytes; the second box 16 KB on,
// row lb 8 rows on (the same row mod 8)
__device__ __forceinline__ void long_tile_offsets(int (&toff)[4], int la,
                                                  int tig) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
    toff[t] = la * 32 + (((2 * t + (tig >> 1)) ^ (la & 7)) << 2) +
              2 * (tig & 1);
}

// d[kOff..] (m64 x n64, f32, wgmma's accumulator layout) += a (m64 x k16,
// bf16 register fragments) · b (n64 x k16 from the descriptor); kTransB 0
// for a K-major b, 1 for an MN-major one; kAcc false sets d to the product
// (its old values are not read).
template <int kTransB, bool kAcc = true, int kOff = 0, int kN>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[kN],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  static_assert(kOff + 32 <= kN, "accumulators in range");
  if constexpr (kAcc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : "+f"(d[kOff + 0]), "+f"(d[kOff + 1]), "+f"(d[kOff + 2]),
          "+f"(d[kOff + 3]), "+f"(d[kOff + 4]), "+f"(d[kOff + 5]),
          "+f"(d[kOff + 6]), "+f"(d[kOff + 7]), "+f"(d[kOff + 8]),
          "+f"(d[kOff + 9]), "+f"(d[kOff + 10]), "+f"(d[kOff + 11]),
          "+f"(d[kOff + 12]), "+f"(d[kOff + 13]), "+f"(d[kOff + 14]),
          "+f"(d[kOff + 15]), "+f"(d[kOff + 16]), "+f"(d[kOff + 17]),
          "+f"(d[kOff + 18]), "+f"(d[kOff + 19]), "+f"(d[kOff + 20]),
          "+f"(d[kOff + 21]), "+f"(d[kOff + 22]), "+f"(d[kOff + 23]),
          "+f"(d[kOff + 24]), "+f"(d[kOff + 25]), "+f"(d[kOff + 26]),
          "+f"(d[kOff + 27]), "+f"(d[kOff + 28]), "+f"(d[kOff + 29]),
          "+f"(d[kOff + 30]), "+f"(d[kOff + 31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(static_cast<int>(kAcc)), "n"(kTransB));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : "=f"(d[kOff + 0]), "=f"(d[kOff + 1]), "=f"(d[kOff + 2]),
          "=f"(d[kOff + 3]), "=f"(d[kOff + 4]), "=f"(d[kOff + 5]),
          "=f"(d[kOff + 6]), "=f"(d[kOff + 7]), "=f"(d[kOff + 8]),
          "=f"(d[kOff + 9]), "=f"(d[kOff + 10]), "=f"(d[kOff + 11]),
          "=f"(d[kOff + 12]), "=f"(d[kOff + 13]), "=f"(d[kOff + 14]),
          "=f"(d[kOff + 15]), "=f"(d[kOff + 16]), "=f"(d[kOff + 17]),
          "=f"(d[kOff + 18]), "=f"(d[kOff + 19]), "=f"(d[kOff + 20]),
          "=f"(d[kOff + 21]), "=f"(d[kOff + 22]), "=f"(d[kOff + 23]),
          "=f"(d[kOff + 24]), "=f"(d[kOff + 25]), "=f"(d[kOff + 26]),
          "=f"(d[kOff + 27]), "=f"(d[kOff + 28]), "=f"(d[kOff + 29]),
          "=f"(d[kOff + 30]), "=f"(d[kOff + 31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(static_cast<int>(kAcc)), "n"(kTransB));
  }
}

// The same at n32 (the value product at head width 32).
template <int kTransB, bool kAcc = true, int kOff = 0, int kN>
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[kN],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  static_assert(kOff + 16 <= kN, "accumulators in range");
  if constexpr (kAcc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
        "}\n"
        : "+f"(d[kOff + 0]), "+f"(d[kOff + 1]), "+f"(d[kOff + 2]),
          "+f"(d[kOff + 3]), "+f"(d[kOff + 4]), "+f"(d[kOff + 5]),
          "+f"(d[kOff + 6]), "+f"(d[kOff + 7]), "+f"(d[kOff + 8]),
          "+f"(d[kOff + 9]), "+f"(d[kOff + 10]), "+f"(d[kOff + 11]),
          "+f"(d[kOff + 12]), "+f"(d[kOff + 13]), "+f"(d[kOff + 14]),
          "+f"(d[kOff + 15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(static_cast<int>(kAcc)), "n"(kTransB));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
        "}\n"
        : "=f"(d[kOff + 0]), "=f"(d[kOff + 1]), "=f"(d[kOff + 2]),
          "=f"(d[kOff + 3]), "=f"(d[kOff + 4]), "=f"(d[kOff + 5]),
          "=f"(d[kOff + 6]), "=f"(d[kOff + 7]), "=f"(d[kOff + 8]),
          "=f"(d[kOff + 9]), "=f"(d[kOff + 10]), "=f"(d[kOff + 11]),
          "=f"(d[kOff + 12]), "=f"(d[kOff + 13]), "=f"(d[kOff + 14]),
          "=f"(d[kOff + 15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(static_cast<int>(kAcc)), "n"(kTransB));
  }
}

// O (64 x kD) += P (64 x 16 keys) · V (16 keys x kD), V's block at vt
// (rows of kBox values, kD / kBox boxes of 64 rows), keys 16·jt on.
template <int kD>
__device__ __forceinline__ void long_pv(float (&o)[kD / 2],
                                        const uint32_t (&p)[4],
                                        const unsigned char* vt, int jt) {
  constexpr int kBox = kD < 64 ? kD : 64;  // values of a swizzled row
  constexpr int kRow = kBox * 2;
  constexpr int kSlab = kAttnLongKeys * kRow;
  const unsigned char* base = vt + jt * 16 * kRow;
  if constexpr (kD == 32) {
    wgmma_m64n32k16_rs<1>(o, p, wgmma_desc_sw<kRow>(base, 8 * kRow));
  } else {
    wgmma_m64n64k16_rs<1>(o, p, wgmma_desc_sw<kRow>(base, 8 * kRow));
    if constexpr (kD == 128)
      wgmma_m64n64k16_rs<1, true, 32>(
          o, p, wgmma_desc_sw<kRow>(base + kSlab, 8 * kRow));
  }
}

// The 4-D tensor map of k or v as (d, H, N, B): a head's d lanes, heads d
// lanes apart, rows `ld` elements apart, samples N rows apart, boxes of
// (min(kD, 64) lanes, 1 head, 64 keys, 1 sample) in the swizzle of their
// row's bytes, kD = core_width(d); lanes past d, rows past N and samples
// past B read as 0 (d·2 bytes, the heads' stride, is a multiple of 16).
inline cudaError_t attn_long_map(CUtensorMap* map, const bf16* base,
                                 long long ld, int B, int N, int H, int d) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const int box = core_width(d) < 64 ? core_width(d) : 64;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(H),
      static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(d) * sizeof(bf16),
      static_cast<cuuint64_t>(ld) * sizeof(bf16),
      static_cast<cuuint64_t>(ld) * N * sizeof(bf16)};
  const cuuint32_t boxes[4] = {static_cast<cuuint32_t>(box), 1,
                               static_cast<cuuint32_t>(kAttnLongKeys), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(base), dims,
      strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}


// The 3-D tensor map of the bias, (N, N, H) f32, read in boxes of (32
// keys, 128 rows, 1 head) in the 128-byte swizzle (the tile form: N % 4 ==
// 0); rows and keys past N read as 0.
inline cudaError_t attn_long_bias_map(CUtensorMap* map, const float* bias,
                                      int N, int H) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(H)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N) * 4,
                                 static_cast<cuuint64_t>(N) * N * 4};
  const cuuint32_t boxes[3] = {32, kAttnLongQueries, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(bias), dims,
      strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The long route (see above). map_k and map_v are 4-D tensor maps over k
// and v as (d, H, N, B) (attn_long_map); kTiles: the bias in the tile
// form, map_b its map (attn_long_bias_map); else `slab` picks the slab form
// or the row form. q is read through its pointer (rows `ld` apart, as the
// short core reads it, its lanes past d as the short core reads them: K's
// are zero there); the output rows are C apart, of which head h's d lanes
// d·h on are written. kD = core_width(d). Steps of a sample group: pass 1
// over the kblocks key blocks, then pass 2 over them once for each of its
// kParts parts (part p: O's and V's lanes p·kOW on).
template <int kD, bool kProbs, bool kNormFirst, bool kTiles>
__global__ void __launch_bounds__(attn_long_warps(kD) * 32, 1)
attention_long_kernel(const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_b,
                      const bf16* __restrict__ q, long long ld,
                      const float* __restrict__ bias, bf16* __restrict__ out,
                      bf16* __restrict__ probs, int B, int N, int C, int d,
                      bool slab, float scale) {
  constexpr int kSamples = attn_long_samples(kD);
  constexpr int kStages = attn_long_stages(kD, kProbs);
  constexpr int kParts = attn_long_parts(kD);
  constexpr int kOW = kD / kParts;  // O's lanes of a part
  constexpr int kKV = attn_long_kv_bytes(kD);
  constexpr int kVP = attn_long_v_bytes(kD);  // a sample's V of a part
  constexpr int kStage = attn_long_stage_bytes(kD);
  constexpr int kArea = kAttnLongBiasBytes / 4;  // a stage's bias area, floats
  constexpr int kBox = kD < 64 ? kD : 64;  // values of a swizzled row
  constexpr int kRow = kBox * 2;
  constexpr int kBoxes = kD / kBox;        // TMA boxes of a row (2 at d 128)
  constexpr int kBoxBytes = kKV / kBoxes;  // a box of one sample's block
  extern __shared__ unsigned char attn_long_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(attn_long_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  float* region =
      reinterpret_cast<float*>(smem + attn_long_region_off(kD, kProbs));
  bf16* pstage = reinterpret_cast<bf16*>(
      smem + attn_long_region_off(kD, kProbs) +
      attn_long_region_bytes(kD, kProbs));
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(pstage) +
      attn_long_staging_bytes(kD, kProbs));
  uint64_t* empty = full + kStages;
  uint64_t* slab_full = empty + kStages;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kAttnLongQueries;
  const int h = blockIdx.z;
  const int H = gridDim.z;
  const int head_off = h * d;
  const float* bias_h = bias + static_cast<long long>(h) * N * N;
  const float* bias_end = bias + static_cast<long long>(H) * N * N;
  const bool rows_form = !kTiles && !slab;
  const int kblocks = (N + kAttnLongKeys - 1) / kAttnLongKeys;
  // a sample group's: pass 1, then pass 2 (each of its parts)
  const int steps = (1 + kParts) * kblocks;
  const int groups = (B + kSamples - 1) / kSamples;
  // the slab: the CTA's bias rows from the 16-byte piece that holds (q0, 0)
  const int slab_shift = bias_shift(bias_h + static_cast<long long>(q0) * N);
  const float* slab_src = bias_h + static_cast<long long>(q0) * N - slab_shift;
  // K's boxes that hold lanes below d (all of them at widths up to 128):
  // those past them are never loaded and stay zero
  const int kboxes = kParts == 1 ? kBoxes : (d + kBox - 1) / kBox;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the TMA arrival, and in the row form one a lane of warp 0
      mbar_init(&full[s], rows_form ? 1 + 32 : 1);
      mbar_init(&empty[s], attn_long_warps(kD) * 32);
    }
    mbar_init(slab_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kParts > 1) {
    // K's boxes past kboxes of every stage and sample, zeroed once for the
    // S products (wgmma reads them through the async proxy); V's lanes past
    // d only reach O's lanes past d, which are never stored
    const int zb = kKV - kboxes * kBoxBytes;  // bytes a stage and sample
    for (int i = threadIdx.x * 16; i < kStages * kSamples * zb;
         i += blockDim.x * 16) {
      const int u = i / zb;
      *reinterpret_cast<uint4*>(smem + (u / kSamples) * kStage +
                                (u % kSamples) * kKV + kboxes * kBoxBytes +
                                i % zb) = make_uint4(0u, 0u, 0u, 0u);
    }
    fence_proxy_async();
  }
  __syncthreads();

  // Warp 0's loads for global step g (sample group blockIdx.y + (g / steps)
  // · gridDim.y, block (g mod steps) mod kblocks, V (its part's lanes) too
  // in pass 2) into stage g mod kStages, once the warpgroups have released
  // its last use.
  auto produce = [&](int g) {
    const int grp = blockIdx.y + (g / steps) * gridDim.y;
    if (grp >= groups) return;
    const int b0 = grp * kSamples;
    const int live = min(kSamples, B - b0);
    const int s = g % steps;
    const int st = g % kStages;
    if (g >= kStages) mbar_wait(&empty[st], ((g / kStages) & 1) ^ 1);
    unsigned char* kv = smem + st * kStage;
    float* bt = region + st * kArea;
    const int j0 = (s % kblocks) * kAttnLongKeys;
    const bool with_v = s >= kblocks;
    if (lane == 0) {
      if constexpr (kParts == 1) {
        mbar_expect_tx(&full[st],
                       live * kKV * (with_v ? 2 : 1) +
                           (kTiles ? 2 * kAttnLongQueries * 128 : 0));
        for (int si = 0; si < live; ++si) {
#pragma unroll
          for (int x = 0; x < kBoxes; ++x) {
            const int off = si * kKV + x * kBoxBytes;
            tma_load_4d(kv + off, &map_k, &full[st], x * kBox, h, j0,
                        b0 + si);
            if (with_v)
              tma_load_4d(kv + kSamples * kKV + off, &map_v, &full[st],
                          x * kBox, h, j0, b0 + si);
          }
        }
      } else {
        // K's boxes below d; of the part's V boxes those below d
        constexpr int kPartBoxes = kBoxes / kParts;
        const int v0 = (s / kblocks - 1) * kPartBoxes;
        const int vboxes = with_v ? min(kPartBoxes, kboxes - v0) : 0;
        mbar_expect_tx(&full[st],
                       live * (kboxes + vboxes) * kBoxBytes +
                           (kTiles ? 2 * kAttnLongQueries * 128 : 0));
        for (int si = 0; si < live; ++si) {
          for (int x = 0; x < kboxes; ++x)
            tma_load_4d(kv + si * kKV + x * kBoxBytes, &map_k, &full[st],
                        x * kBox, h, j0, b0 + si);
          for (int x = 0; x < vboxes; ++x)
            tma_load_4d(kv + kSamples * kKV + si * kVP + x * kBoxBytes,
                        &map_v, &full[st], (v0 + x) * kBox, h, j0, b0 + si);
        }
      }
      if (kTiles) {
        tma_load_3d(bt, &map_b, &full[st], j0, q0, h);
        tma_load_3d(bt + kAttnLongQueries * 32, &map_b, &full[st], j0 + 32,
                    q0, h);
      }
    }
    if (rows_form)
      long_bias_rows(bt, bias_h, bias_end, q0, j0, N, lane, &full[st]);
  };

  if (warp == 0) {
    if (slab && lane == 0)
      long_bias_slab(region, slab_src, bias_end, N, slab_shift, slab_full);
    produce(0);
    __syncwarp();
  }

  // Warpgroup wg takes rows 64·(wg & 1) of the CTA's queries of the
  // group's sample wg >> 1; warp wq of it 16 of them, this thread rows ra
  // and ra + 8 (g = lane / 4) and the quad's columns.
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int si = wg >> 1;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int la = (wg & 1) * 64 + wq * 16 + g;  // rows within the CTA's 128
  const int lb = la + 8;
  const int ra = q0 + la;
  const int rb = q0 + lb;
  const bool even = (N & 1) == 0;
  const int lin_a = long_bias_lin(slab, slab_shift, bias_h, la, ra, N, tig);
  const int lin_b = long_bias_lin(slab, slab_shift, bias_h, lb, rb, N, tig);
  int toff[4];
  long_tile_offsets(toff, la, tig);
  if (slab) mbar_wait(slab_full, 0);

  uint32_t qf[kD / 16][4];  // Q' of the thread's rows, A fragments
  // a part's O, wgmma's layout: o[4i..4i+3] its columns 8i + 2·tig, + 1
  float o[kOW / 2];
  int it = 0;       // the global step
  for (int grp = blockIdx.y; grp < groups; grp += gridDim.y) {
    const int b = grp * kSamples + si;
    const bool live = b < B;
    const long long row0 = static_cast<long long>(b) * N;
    {
      const long long qa = (row0 + ra) * ld + head_off;
      const long long qb = (row0 + rb) * ld + head_off;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        // lanes past d: the next head's, or K8's clamped (K's are 0 there)
        constexpr bool kClamp = kNormFirst && !kProbs;  // K8's own q
        const int c0 = q_col<kClamp>(kk * 16 + 2 * tig, d);
        const int c1 = q_col<kClamp>(kk * 16 + 2 * tig + 8, d);
        qf[kk][0] = q_pair(q, qa, live && ra < N, c0, scale);
        qf[kk][1] = q_pair(q, qb, live && rb < N, c0, scale);
        qf[kk][2] = q_pair(q, qa, live && ra < N, c1, scale);
        qf[kk][3] = q_pair(q, qb, live && rb < N, c1, scale);
      }
    }
    float mxa = -INFINITY, mxb = -INFINITY;  // the quad's row maxima
    float suma = 0.f, sumb = 0.f;            // this thread's part of Σe
    float inva = 0.f, invb = 0.f;
#pragma unroll
    for (int i = 0; i < kOW / 2; ++i) o[i] = 0.f;

    // out = bf16(O · 1/Σe), or bf16(O) when the numerators were normalized:
    // part `part`'s lanes of the head, those below d
    auto store = [&](int part) {
      const float oa = kNormFirst ? 1.f : inva;
      const float ob = kNormFirst ? 1.f : invb;
#pragma unroll
      for (int dt = 0; dt < kOW / 8; ++dt) {
        const int lane0 = part * kOW + dt * 8;
        const int col = head_off + lane0 + 2 * tig;
        const bool real = live && lane0 < d;
        if (real && ra < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (row0 + ra) * C + col) =
              __floats2bfloat162_rn(o[4 * dt] * oa, o[4 * dt + 1] * oa);
        if (real && rb < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (row0 + rb) * C + col) =
              __floats2bfloat162_rn(o[4 * dt + 2] * ob, o[4 * dt + 3] * ob);
      }
    };

    for (int s = 0; s < steps; ++s, ++it) {
      if (warp == 0) {
        produce(it + 1);
        __syncwarp();
      }
      const int st = it % kStages;
      mbar_wait(&full[st], (it / kStages) & 1);
      const unsigned char* kt = smem + st * kStage + si * kKV;
      const int j0 = (s % kblocks) * kAttnLongKeys;

      // S = Q'·Kᵀ over the block's 64 keys: k step kk reads lanes 16·kk
      // on, in TMA box 16·kk / kBox, 32 bytes a step along its rows (every
      // step of the instance: K's lanes past d are 0, and a branch between
      // the wgmmas could have ptxas serialize them at every width)
      float sc[32];  // the logits of the block, the accumulator layout
      // every register a wgmma reads is written before its fence: the
      // compiler may not sink those writes past it
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) fence_acc(qf[kk]);
      wgmma_fence();
      wgmma_m64n64k16_rs<0, false>(sc, qf[0], wgmma_desc_sw<kRow>(kt));
#pragma unroll
      for (int kk = 1; kk < kD / 16; ++kk)
        wgmma_m64n64k16_rs<0>(
            sc, qf[kk],
            wgmma_desc_sw<kRow>(kt + kk * 16 / kBox * (kKV / kBoxes)) +
                (kk * 16 % kBox) / 8);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      // and read after its wait: Q''s fragments stay live to the next step
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) fence_acc(qf[kk]);

      // + bias; keys past N masked where the block reaches them. The
      // bias pair of key tile t: row la at ba[off(t)], row lb 8 rows on
      const float* ba;
      int lbo;  // row lb's offset from row la's
      if constexpr (kTiles) {
        ba = region + st * kArea;
        lbo = 8 * 32;
      } else {
        ba = (slab ? region + j0 : region + st * kArea) + lin_a;
        lbo = lin_b - lin_a;
      }
      auto off = [&](int t) {  // t is unrolled: an immediate but in tiles
        return kTiles ? toff[t & 3] + (t >> 2) * (kAttnLongQueries * 32)
                      : 8 * t;
      };
      auto pair = [&](const float* p) {
        return kTiles || even ? *reinterpret_cast<const float2*>(p)
                              : make_float2(p[0], p[1]);
      };
      if (j0 + kAttnLongKeys <= N) {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float2 pa = pair(ba + off(t)), pb = pair(ba + off(t) + lbo);
          sc[4 * t] += pa.x;
          sc[4 * t + 1] += pa.y;
          sc[4 * t + 2] += pb.x;
          sc[4 * t + 3] += pb.y;
        }
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int j = j0 + t * 8 + 2 * tig;
          add_bias(sc[4 * t], sc[4 * t + 1], pair(ba + off(t)), ra, j, N);
          add_bias(sc[4 * t + 2], sc[4 * t + 3], pair(ba + off(t) + lbo), rb,
                   j, N);
        }
      }

      if (s < kblocks) {
        // pass 1: the row max over the quad, Σe rescaled to it
        float bma = -INFINITY, bmb = -INFINITY;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          bma = fmaxf(bma, fmaxf(sc[4 * t], sc[4 * t + 1]));
          bmb = fmaxf(bmb, fmaxf(sc[4 * t + 2], sc[4 * t + 3]));
        }
#pragma unroll
        for (int w = 1; w <= 2; w <<= 1) {
          bma = fmaxf(bma, __shfl_xor_sync(0xffffffffu, bma, w));
          bmb = fmaxf(bmb, __shfl_xor_sync(0xffffffffu, bmb, w));
        }
        const float na = fmaxf(mxa, bma), nb = fmaxf(mxb, bmb);
        const float la2 = na * kLog2e, lb2 = nb * kLog2e;
        float ea = 0.f, eb = 0.f;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          ea += exp2f(fmaf(sc[4 * t], kLog2e, -la2)) +
                exp2f(fmaf(sc[4 * t + 1], kLog2e, -la2));
          eb += exp2f(fmaf(sc[4 * t + 2], kLog2e, -lb2)) +
                exp2f(fmaf(sc[4 * t + 3], kLog2e, -lb2));
        }
        suma = suma * exp2f((mxa - na) * kLog2e) + ea;
        sumb = sumb * exp2f((mxb - nb) * kLog2e) + eb;
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
        if constexpr (kParts > 1) {
          if (s > kblocks && s % kblocks == 0) {  // the next part's first
            store(s / kblocks - 2);
#pragma unroll
            for (int i = 0; i < kOW / 2; ++i) o[i] = 0.f;
          }
        }
        // pass 2: e against the final max
        const float la2 = mxa * kLog2e, lb2 = mxb * kLog2e;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          sc[4 * t] = exp2f(fmaf(sc[4 * t], kLog2e, -la2));
          sc[4 * t + 1] = exp2f(fmaf(sc[4 * t + 1], kLog2e, -la2));
          sc[4 * t + 2] = exp2f(fmaf(sc[4 * t + 2], kLog2e, -lb2));
          sc[4 * t + 3] = exp2f(fmaf(sc[4 * t + 3], kLog2e, -lb2));
        }
        if (kProbs && (kParts == 1 || s < 2 * kblocks)) {
          // the TPU kernel's probs, (e · (1/Σe)) rounded to bf16 (in the
          // first part): the warp's 16 x 64 tile staged in shared memory,
          // then rows of 16-byte pieces
          bf16* pw = pstage + warp * (16 * kAttnLongProbsLd);
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const int c = t * 8 + 2 * tig;
            *reinterpret_cast<uint32_t*>(pw + g * kAttnLongProbsLd + c) =
                pack_bf16(sc[4 * t] * inva, sc[4 * t + 1] * inva);
            *reinterpret_cast<uint32_t*>(pw + (g + 8) * kAttnLongProbsLd +
                                         c) =
                pack_bf16(sc[4 * t + 2] * invb, sc[4 * t + 3] * invb);
          }
          __syncwarp();
#pragma unroll
          for (int i4 = 0; i4 < 4; ++i4) {
            const int r = i4 * 4 + (lane >> 3);  // the warp's row
            const int c = (lane & 7) * 8;        // its 8 keys
            const int i = q0 + la - g + r;
            const int j = j0 + c;
            if (live && i < N && j < N) {
              const bf16* from = pw + r * kAttnLongProbsLd + c;
              bf16* to =
                  probs + ((static_cast<long long>(b) * H + h) * N + i) * N + j;
              if ((N & 7) == 0) {
                *reinterpret_cast<uint4*>(to) =
                    *reinterpret_cast<const uint4*>(from);
              } else {
                for (int e = 0; e < 8 && j + e < N; ++e) to[e] = from[e];
              }
            }
          }
          __syncwarp();
        }
        // P's A fragments: bf16(e), or bf16(e·(1/Σe)); O += P·V
        const float fa = kNormFirst ? inva : 1.f;
        const float fb = kNormFirst ? invb : 1.f;
        uint32_t p[4][4];
#pragma unroll
        for (int jt = 0; jt < 4; ++jt) {
          p[jt][0] = pack_bf16(sc[8 * jt] * fa, sc[8 * jt + 1] * fa);
          p[jt][1] = pack_bf16(sc[8 * jt + 2] * fb, sc[8 * jt + 3] * fb);
          p[jt][2] = pack_bf16(sc[8 * jt + 4] * fa, sc[8 * jt + 5] * fa);
          p[jt][3] = pack_bf16(sc[8 * jt + 6] * fb, sc[8 * jt + 7] * fb);
        }
        const unsigned char* vt =
            smem + st * kStage + kSamples * kKV + si * kVP;
        fence_acc(o);
#pragma unroll
        for (int jt = 0; jt < 4; ++jt) fence_acc(p[jt]);
        wgmma_fence();
#pragma unroll
        for (int jt = 0; jt < 4; ++jt) long_pv<kOW>(o, p[jt], vt, jt);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(o);
#pragma unroll
        for (int jt = 0; jt < 4; ++jt) fence_acc(p[jt]);
      }
      mbar_arrive(&empty[st]);  // this thread is done with the stage
    }
    store(kParts - 1);
  }
}

template <int kD, bool kProbs, bool kNormFirst, bool kTiles>
inline cudaError_t attention_long_launch(const CUtensorMap& map_k,
                                         const CUtensorMap& map_v,
                                         const CUtensorMap& map_b,
                                         const bf16* q, long long ld,
                                         const float* bias, bf16* out,
                                         bf16* probs, int B, int N, int C,
                                         int H, bool slab, float scale,
                                         cudaStream_t stream) {
  auto* kern = attention_long_kernel<kD, kProbs, kNormFirst, kTiles>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kAttnLongSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kAttnLongQueries - 1) / kAttnLongQueries,
                  attn_long_sample_groups(B, N, H, kD, kProbs), H);
  const int d = C / H;
  kern<<<grid, attn_long_warps(kD) * 32, kAttnLongSmem, stream>>>(
      map_k, map_v, map_b, q, ld, bias, out, probs, B, N, C, d, slab, scale);
  return cudaGetLastError();
}

template <int kD, bool kProbs, bool kNormFirst>
inline cudaError_t attention_long_run(const bf16* q, const bf16* k,
                                      const bf16* v, long long ld,
                                      const float* bias, bf16* out,
                                      bf16* probs, int B, int N, int C, int H,
                                      float scale, cudaStream_t stream) {
  const int mode = attn_long_bias_mode(N, kD, kProbs);
  CUtensorMap map_k, map_v, map_b;
  cudaError_t e = attn_long_map(&map_k, k, ld, B, N, H, C / H);
  if (e != cudaSuccess) return e;
  if ((e = attn_long_map(&map_v, v, ld, B, N, H, C / H)) != cudaSuccess)
    return e;
  if (mode == kBiasTiles) {
    if ((e = attn_long_bias_map(&map_b, bias, N, H)) != cudaSuccess) return e;
    return attention_long_launch<kD, kProbs, kNormFirst, true>(
        map_k, map_v, map_b, q, ld, bias, out, probs, B, N, C, H, false,
        scale, stream);
  }
  return attention_long_launch<kD, kProbs, kNormFirst, false>(
      map_k, map_v, map_k, q, ld, bias, out, probs, B, N, C, H,
      mode == kBiasSlab, scale, stream);
}

// ------------------------------------------ attention, long route, wide form
//
// Heads wider than 256 (core_width(d) == kWideCore; d % 8 == 0 up to
// kMaxHeadDim): one head of any embed width the blocks take. The width-256
// instance keeps Q' of a warpgroup's rows as wgmma A fragments for the
// whole sample (64 registers a thread) and a 64-key block of K in a stage
// (32 KB); neither grows past 256 lanes beside O and the bias. The wide
// form keeps the long route's rounding contract (keys streamed twice, e
// against the row's final max, P·V in f32 over the keys in order) and
// takes d in 128-lane chunks (kWideLanes):
//  * S = Σ_c Q'_c·K_cᵀ, chunk c's 8 k-steps of wgmma m64n64k16 into the
//    same accumulators in chunk order (the same sums, in the same order, as
//    one product over every lane); K_c, 64 keys x 128 lanes (two TMA boxes
//    of 64 lanes, 16 KB), one chunk a step;
//  * Q'_c = bf16(q·d^-½) of the thread's rows made again at each step from
//    q's rows in device memory (L2), straight into the A fragments (q_pair,
//    the rounding of every other instance), a step ahead; lanes past d
//    give 0;
//  * pass 1 as the long route's, at each block's last chunk;
//  * pass 2 computes S once a key block: the same chunk products again (the
//    same wgmma sequence, so the same logits), e against the final max at
//    the block's last chunk, the probabilities stored (kProbs) and P =
//    bf16(e), or bf16(e·1/Σe) with kNormFirst, written once: the thread's
//    16 A-fragment registers of the block into the CTA's slot of a scratch
//    in device memory. Then O += P·V_c over the key blocks once for each
//    128-lane part c of O (O 64 f32 a thread), each thread reading back
//    the P it wrote, a step ahead. A key block costs
//    2·ceil(d/128) chunk products of S (pass 1 and pass 2) and ceil(d/128)
//    of P·V; S is never recomputed for a part;
//  * every step is one 16 KB tile (K's chunk, or V's part of a block)
//    through a ring of kWideSlots slots that a producer warp of its own
//    keeps filled (warp 8: a third warpgroup, which gives its registers
//    to the two consumer warpgroups by setmaxnreg, 40 to 232 a thread;
//    with one warp more and no such move, the four schedulers' register
//    files capped every thread at 168, and ptxas spilled); a step's
//    wgmma group is waited on at the next step (wait_group 1), so the
//    tensor cores take the next chunk (or block) while it completes,
//    except at a block's last chunk (the softmax reads its logits) and a
//    part's last block (O is stored). No divergent code runs in a consumer
//    warpgroup while a group is in flight (ptxas would serialize the
//    wgmmas: C7518); Q''s (and P's) fragments alternate between two
//    register sets, even and odd steps, Q' loaded a step ahead without a
//    branch;
//  * the bias (tiles or row copies) with each block's last chunk, in one of
//    kWideAreas areas taken in turn by the block ends, or the slab once, as
//    the long route reads it.
// K's boxes wholly past d (the last chunk's second where d mod 128 is in
// (0, 64]) are not loaded: the producer zeroes that box of the slot before
// the slot's arrival, so no TMA box lies wholly outside the tensor. V's
// boxes past d reach only O's lanes past d, which are never stored.
// The grid is persistent: (query blocks, wide_sample_groups, heads), about
// kWideCtas CTAs in all (one an SM of the H100), CTA y taking samples y,
// y + gridDim.y, ...; the scratch holds one slot of 128 x Np bf16 (Np = N
// rounded up to 64) for each CTA of the grid, reused sample after sample,
// so it stays in L2 (6.2 MB at N 192; the wrapper's
// ops/kernels/fused_block.py `wide_scratch` bytes).
// Shared memory: the ring (six slots, 96 KB), the bias region (three tile
// or row areas, or a slab up to N 259; 223 with probabilities), the
// probabilities' staging, the barriers.
constexpr int kWideLanes = 128;  // a chunk of d in S, a part of O in pass 2
constexpr int kWideSlots = 6;
// two consumer warpgroups and the producer's
constexpr int kWideCtaThreads = 3 * 128;
// Registers a thread after setmaxnreg: 8 consumer warps at 232 and 4
// producer warps at 40 take 64,512 of the SM's 65,536
__device__ __forceinline__ void wide_producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void wide_consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}
constexpr int kWideAreas = 3;  // bias areas of the tile and row forms
constexpr int kWideBox = kAttnLongKeys * 128;  // 64 lanes of 64 keys, bf16
constexpr int kWideSlot = 2 * kWideBox;        // a chunk of K, a part of V
// the persistent grid's CTAs: one for each SM of an H100 SXM
constexpr int kWideCtas = 132;
__host__ __device__ constexpr int wide_chunks(int d) {
  return (d + kWideLanes - 1) / kWideLanes;
}
__host__ __device__ constexpr int wide_staging_bytes(bool probs) {
  return probs ? 8 * kAttnLongProbsBytes : 0;
}
__host__ __device__ constexpr int wide_bar_bytes() {
  return ((2 * kWideSlots + 1) * 8 + 15) / 16 * 16;
}
// 133,008 B (114,576 with probabilities)
__host__ __device__ constexpr int wide_region_bytes(bool probs) {
  return kAttnLongSmem - 1024 - kWideSlots * kWideSlot -
         wide_staging_bytes(probs) - wide_bar_bytes();
}
// gridDim.y of a wide-form launch (either core): enough sample rows that
// the grid holds about kWideCtas CTAs, at most B
__host__ __device__ inline int wide_sample_groups(int B, int N, int H) {
  const long long per =
      static_cast<long long>((N + kAttnLongQueries - 1) / kAttnLongQueries) *
      H;
  const long long want = (kWideCtas + per - 1) / per;
  return static_cast<int>(want < B ? want : B);
}
// Bytes of the wide form's slots (either core): one a CTA of its grid,
// `block_bytes` a 64-key block (kWidePBlock of the bf16 core's P; K4a's
// codes half that). The launches refuse a smaller scratch.
constexpr int kWidePBlock = kAttnLongQueries * kAttnLongKeys * 2;
__host__ __device__ inline long long wide_slot_bytes(int B, int N, int H,
                                                     int block_bytes) {
  const long long ctas =
      static_cast<long long>((N + kAttnLongQueries - 1) / kAttnLongQueries) *
      wide_sample_groups(B, N, H) * H;
  return ctas * ((N + kAttnLongKeys - 1) / kAttnLongKeys) * block_bytes;
}

// The wide form (see above); arguments as attention_long_kernel's, and the
// scratch `pscr` (16-byte aligned, its slots 128 x Np bf16 each). Steps of
// a sample: pass 1 over the key blocks' chunks, pass 2's S over them, then
// its P·V over the parts' blocks.
template <bool kProbs, bool kNormFirst, bool kTiles>
__global__ void __launch_bounds__(kWideCtaThreads, 1)
attention_wide_kernel(const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_b,
                      const bf16* __restrict__ q, long long ld,
                      const float* __restrict__ bias, bf16* __restrict__ out,
                      bf16* __restrict__ probs, int B, int N, int C, int d,
                      bool slab, float scale, uint4* __restrict__ pscr) {
  constexpr int kArea = kAttnLongBiasBytes / 4;  // a bias area, floats
  extern __shared__ unsigned char attn_wide_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(attn_wide_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  float* region = reinterpret_cast<float*>(smem + kWideSlots * kWideSlot);
  bf16* pstage = reinterpret_cast<bf16*>(smem + kWideSlots * kWideSlot +
                                         wide_region_bytes(kProbs));
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(pstage) + wide_staging_bytes(kProbs));
  uint64_t* empty = full + kWideSlots;
  uint64_t* slab_full = empty + kWideSlots;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kAttnLongQueries;
  const int h = blockIdx.z;
  const int H = gridDim.z;
  const int head_off = h * d;
  const float* bias_h = bias + static_cast<long long>(h) * N * N;
  const float* bias_end = bias + static_cast<long long>(H) * N * N;
  const bool rows_form = !kTiles && !slab;
  const int kblocks = (N + kAttnLongKeys - 1) / kAttnLongKeys;
  const int nc = wide_chunks(d);        // chunks of S, parts of P·V
  const int pass_steps = kblocks * nc;  // a pass over the blocks' chunks
  const int steps = 3 * pass_steps;     // a sample's: pass 1, S, P·V
  // K's boxes below d in the last chunk: 2, or 1
  const int last_boxes = (d - (nc - 1) * kWideLanes + 63) / 64;
  const int slab_shift = bias_shift(bias_h + static_cast<long long>(q0) * N);
  const float* slab_src = bias_h + static_cast<long long>(q0) * N - slab_shift;
  // the CTA's slot: thread t's 16-byte piece i of block kb's P at
  // (kb·4 + i)·256 + t
  uint4* slot =
      pscr + (static_cast<long long>(blockIdx.z * gridDim.y + blockIdx.y) *
                  gridDim.x +
              blockIdx.x) *
                 kblocks * 1024;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWideSlots; ++s) {
      // the TMA arrival, and in the row form one a lane of the producer warp
      mbar_init(&full[s], rows_form ? 1 + 32 : 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(slab_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The bias area of the block end at global step g (sample-local step s of
  // pass `pass`, block kb): the CTA's block ends take the areas in turn. An
  // area comes back kWideAreas block ends later, at least 2·kWideAreas =
  // kWideSlots steps on (nc >= 2), so its producer waits for the slot of a
  // step at or after the one that read it to be released.
  auto area = [&](int g, int pass, int kb) {
    return region +
           ((g / steps) * 2 * kblocks + pass * kblocks + kb) % kWideAreas *
               kArea;
  };

  // The producer warp's loads for global step g (sample blockIdx.y + (g /
  // steps) · gridDim.y; step s = g mod steps: pass 1, pass 2's S, each over
  // the key blocks' chunks, then its P·V over each part's blocks) into slot
  // g mod kWideSlots, once every consumer has released its last use: K's
  // chunk, at a block's last chunk with the bias; or V's part.
  auto produce = [&](int g) {
    const int b = blockIdx.y + (g / steps) * gridDim.y;
    if (b >= B) return;
    const int s = g % steps;
    const int st = g % kWideSlots;
    if (g >= kWideSlots) mbar_wait(&empty[st], ((g / kWideSlots) & 1) ^ 1);
    unsigned char* kv = smem + st * kWideSlot;
    const int pass = s / pass_steps;
    const int r = s % pass_steps;
    if (pass == 2) {  // V's part r / kblocks of block r mod kblocks
      const int part = r / kblocks;
      const int j0 = (r % kblocks) * kAttnLongKeys;
      const int vb = min(2, (d - part * kWideLanes + 63) / 64);
      if (lane == 0) {
        mbar_expect_tx(&full[st], vb * kWideBox);
        for (int x = 0; x < vb; ++x)
          tma_load_4d(kv + x * kWideBox, &map_v, &full[st],
                      part * kWideLanes + x * 64, h, j0, b);
      }
      if (rows_form) mbar_expect_tx(&full[st], 0);
      return;
    }
    const int c = r % nc;
    const int kb = r / nc;
    const int j0 = kb * kAttnLongKeys;
    const bool last = c == nc - 1;
    const int kbx = last ? last_boxes : 2;
    float* bt = area(g, pass, kb);
    if (kbx == 1) {
      // K's second box lies wholly past d: zeros for the S product (wgmma
      // reads them through the async proxy)
      for (int i = lane; i < kWideBox / 16; i += 32)
        reinterpret_cast<uint4*>(kv + kWideBox)[i] = make_uint4(0u, 0u, 0u, 0u);
      fence_proxy_async();
      __syncwarp();
    }
    if (lane == 0) {
      mbar_expect_tx(&full[st],
                     kbx * kWideBox +
                         (kTiles && last ? 2 * kAttnLongQueries * 128 : 0));
      for (int x = 0; x < kbx; ++x)
        tma_load_4d(kv + x * kWideBox, &map_k, &full[st],
                    c * kWideLanes + x * 64, h, j0, b);
      if (kTiles && last) {
        tma_load_3d(bt, &map_b, &full[st], j0, q0, h);
        tma_load_3d(bt + kAttnLongQueries * 32, &map_b, &full[st], j0 + 32,
                    q0, h);
      }
    }
    if (rows_form) {
      if (!last) {
        mbar_expect_tx(&full[st], 0);
        return;
      }
      long_bias_rows(bt, bias_h, bias_end, q0, j0, N, lane, &full[st]);
    }
  };

  if (warp >= 8) {  // the producer warpgroup: warp 8 loads, 9-11 idle
    wide_producer_regs();
    if (warp == 8) {
      if (slab && lane == 0)
        long_bias_slab(region, slab_src, bias_end, N, slab_shift, slab_full);
      __syncwarp();
      for (int g = 0; blockIdx.y + (g / steps) * gridDim.y < B; ++g) {
        produce(g);
        __syncwarp();
      }
    }
    return;
  }
  wide_consumer_regs();

  // Warpgroup wg takes rows 64·wg of the CTA's queries; warp wq of it 16
  // of them, this thread rows ra and ra + 8 (g = lane / 4) and the quad's
  // columns.
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int la = wg * 64 + wq * 16 + g;
  const int lb = la + 8;
  const int ra = q0 + la;
  const int rb = q0 + lb;
  const bool even = (N & 1) == 0;
  const int lin_a = long_bias_lin(slab, slab_shift, bias_h, la, ra, N, tig);
  const int lin_b = long_bias_lin(slab, slab_shift, bias_h, lb, rb, N, tig);
  int toff[4];
  long_tile_offsets(toff, la, tig);
  if (slab) mbar_wait(slab_full, 0);

  float o[kWideLanes / 2];  // a part's O, wgmma's layout
  float sc[32];             // a key block's logits, summed over its chunks
  // Q' of the even and the odd S steps and of the next step; P's A
  // fragments of the even and the odd P·V steps and of the next step
  uint32_t qe[kWideLanes / 16][4], qo[kWideLanes / 16][4],
      qn[kWideLanes / 16][4];
  uint32_t pe[4][4], po[4][4], pn[4][4];
  int it = 0;  // the global step
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const long long row0 = static_cast<long long>(b) * N;
    const long long qra = (row0 + ra) * ld + head_off;
    const long long qrb = (row0 + rb) * ld + head_off;
    // Q' of chunk c into qn: lanes 128c + 16kk + 2·tig (+ 8), 0 past d and
    // for rows past N (q_pair's values, without its branch: the pair is
    // read at q[0] there, always in bounds, and dropped)
    auto pair_of = [&](long long row, bool in, int col) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(q + (in ? row + col : 0)));
      return in ? pack_bf16(f.x * scale, f.y * scale) : 0u;
    };
    auto load_q = [&](int c) {
#pragma unroll
      for (int kk = 0; kk < kWideLanes / 16; ++kk) {
        const int c0 = c * kWideLanes + kk * 16 + 2 * tig;
        const int c1 = c0 + 8;
        qn[kk][0] = pair_of(qra, ra < N && c0 < d, c0);
        qn[kk][1] = pair_of(qrb, rb < N && c0 < d, c0);
        qn[kk][2] = pair_of(qra, ra < N && c1 < d, c1);
        qn[kk][3] = pair_of(qrb, rb < N && c1 < d, c1);
      }
    };
    // P of block kb into pn, from the slot
    auto load_p = [&](int kb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 v = slot[(kb * 4 + i) * 256 + threadIdx.x];
        pn[i][0] = v.x;
        pn[i][1] = v.y;
        pn[i][2] = v.z;
        pn[i][3] = v.w;
      }
    };
    load_q(0);
    float mxa = -INFINITY, mxb = -INFINITY;  // the quad's row maxima
    float suma = 0.f, sumb = 0.f;            // this thread's part of Σe
    float inva = 0.f, invb = 0.f;

    // out = bf16(O · 1/Σe), or bf16(O) with kNormFirst: part `part`'s
    // lanes of the head, those below d
    auto store = [&](int part) {
      const float oa = kNormFirst ? 1.f : inva;
      const float ob = kNormFirst ? 1.f : invb;
#pragma unroll
      for (int dt = 0; dt < kWideLanes / 8; ++dt) {
        const int lane0 = part * kWideLanes + dt * 8;
        const int col = head_off + lane0 + 2 * tig;
        const bool real = lane0 < d;
        if (real && ra < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (row0 + ra) * C + col) =
              __floats2bfloat162_rn(o[4 * dt] * oa, o[4 * dt + 1] * oa);
        if (real && rb < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (row0 + rb) * C + col) =
              __floats2bfloat162_rn(o[4 * dt + 2] * ob, o[4 * dt + 3] * ob);
      }
    };

    // S step t of the sample's 2·pass_steps (pass 1, then pass 2's S):
    // chunk t mod nc of block (t mod pass_steps) / nc, Q' in qf (made from
    // qn here), the last step's in qp
    auto s_step = [&](int t, uint32_t(&qf)[kWideLanes / 16][4],
                      uint32_t(&qp)[kWideLanes / 16][4]) {
      const int pass = t / pass_steps;
      const int r = t % pass_steps;
      const int c = r % nc;
      const int kb = r / nc;
      const int j0 = kb * kAttnLongKeys;
#pragma unroll
      for (int kk = 0; kk < kWideLanes / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) qf[kk][i] = qn[kk][i];
      if (t + 1 < 2 * pass_steps) load_q((t + 1) % nc);
      const int st = it % kWideSlots;
      mbar_wait(&full[st], (it / kWideSlots) & 1);
      const unsigned char* kt = smem + st * kWideSlot;

      // S += Q'_c·K_cᵀ: k step kk reads lanes 16·kk on of the chunk, in
      // box kk / 4, 32 bytes a step along its rows
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        fence_acc(sc);
      }
#pragma unroll
      for (int kk = 0; kk < kWideLanes / 16; ++kk) fence_acc(qf[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWideLanes / 16; ++kk)
        wgmma_m64n64k16_rs<0>(
            sc, qf[kk],
            wgmma_desc_sw<128>(kt + (kk >> 2) * kWideBox) + (kk & 3) * 2);
      wgmma_commit();
      // the last step's group has completed: within a block (c > 0) its
      // slot is released here (a block's last step releases its own)
      if (c < nc - 1) {
        wgmma_wait<1>();
#pragma unroll
        for (int kk = 0; kk < kWideLanes / 16; ++kk) fence_acc(qp[kk]);
        if (c > 0) mbar_arrive(&empty[(it - 1) % kWideSlots]);
        ++it;
        return;
      }
      wgmma_wait<0>();
      fence_acc(sc);
#pragma unroll
      for (int kk = 0; kk < kWideLanes / 16; ++kk) {
        fence_acc(qf[kk]);
        fence_acc(qp[kk]);
      }
      if (c > 0) mbar_arrive(&empty[(it - 1) % kWideSlots]);

      // + bias; keys past N masked where the block reaches them
      const float* ba;
      int lbo;
      if constexpr (kTiles) {
        ba = area(it, pass, kb);
        lbo = 8 * 32;
      } else {
        ba = (slab ? region + j0 : area(it, pass, kb)) + lin_a;
        lbo = lin_b - lin_a;
      }
      auto off = [&](int t4) {
        return kTiles ? toff[t4 & 3] + (t4 >> 2) * (kAttnLongQueries * 32)
                      : 8 * t4;
      };
      auto pair = [&](const float* p) {
        return kTiles || even ? *reinterpret_cast<const float2*>(p)
                              : make_float2(p[0], p[1]);
      };
      if (j0 + kAttnLongKeys <= N) {
#pragma unroll
        for (int t4 = 0; t4 < 8; ++t4) {
          const float2 pa = pair(ba + off(t4)), pb = pair(ba + off(t4) + lbo);
          sc[4 * t4] += pa.x;
          sc[4 * t4 + 1] += pa.y;
          sc[4 * t4 + 2] += pb.x;
          sc[4 * t4 + 3] += pb.y;
        }
      } else {
#pragma unroll
        for (int t4 = 0; t4 < 8; ++t4) {
          const int j = j0 + t4 * 8 + 2 * tig;
          add_bias(sc[4 * t4], sc[4 * t4 + 1], pair(ba + off(t4)), ra, j, N);
          add_bias(sc[4 * t4 + 2], sc[4 * t4 + 3], pair(ba + off(t4) + lbo),
                   rb, j, N);
        }
      }

      if (pass == 0) {
        // pass 1: the row max over the quad, Σe rescaled to it
        float bma = -INFINITY, bmb = -INFINITY;
#pragma unroll
        for (int t4 = 0; t4 < 8; ++t4) {
          bma = fmaxf(bma, fmaxf(sc[4 * t4], sc[4 * t4 + 1]));
          bmb = fmaxf(bmb, fmaxf(sc[4 * t4 + 2], sc[4 * t4 + 3]));
        }
#pragma unroll
        for (int w = 1; w <= 2; w <<= 1) {
          bma = fmaxf(bma, __shfl_xor_sync(0xffffffffu, bma, w));
          bmb = fmaxf(bmb, __shfl_xor_sync(0xffffffffu, bmb, w));
        }
        const float na = fmaxf(mxa, bma), nb = fmaxf(mxb, bmb);
        const float la2 = na * kLog2e, lb2 = nb * kLog2e;
        float ea = 0.f, eb = 0.f;
#pragma unroll
        for (int t4 = 0; t4 < 8; ++t4) {
          ea += exp2f(fmaf(sc[4 * t4], kLog2e, -la2)) +
                exp2f(fmaf(sc[4 * t4 + 1], kLog2e, -la2));
          eb += exp2f(fmaf(sc[4 * t4 + 2], kLog2e, -lb2)) +
                exp2f(fmaf(sc[4 * t4 + 3], kLog2e, -lb2));
        }
        suma = suma * exp2f((mxa - na) * kLog2e) + ea;
        sumb = sumb * exp2f((mxb - nb) * kLog2e) + eb;
        mxa = na;
        mxb = nb;
      } else {
        if (kb == 0) {  // Σe over the quad, once
#pragma unroll
          for (int w = 1; w <= 2; w <<= 1) {
            suma += __shfl_xor_sync(0xffffffffu, suma, w);
            sumb += __shfl_xor_sync(0xffffffffu, sumb, w);
          }
          inva = 1.0f / suma;
          invb = 1.0f / sumb;
        }
        // pass 2: e against the final max
        const float la2 = mxa * kLog2e, lb2 = mxb * kLog2e;
#pragma unroll
        for (int t4 = 0; t4 < 8; ++t4) {
          sc[4 * t4] = exp2f(fmaf(sc[4 * t4], kLog2e, -la2));
          sc[4 * t4 + 1] = exp2f(fmaf(sc[4 * t4 + 1], kLog2e, -la2));
          sc[4 * t4 + 2] = exp2f(fmaf(sc[4 * t4 + 2], kLog2e, -lb2));
          sc[4 * t4 + 3] = exp2f(fmaf(sc[4 * t4 + 3], kLog2e, -lb2));
        }
        if constexpr (kProbs) {
          // bf16(e · (1/Σe)), the warp's 16 x 64 tile staged in shared
          // memory, then rows of 16-byte pieces
          bf16* pw = pstage + warp * (16 * kAttnLongProbsLd);
#pragma unroll
          for (int t4 = 0; t4 < 8; ++t4) {
            const int cc = t4 * 8 + 2 * tig;
            *reinterpret_cast<uint32_t*>(pw + g * kAttnLongProbsLd + cc) =
                pack_bf16(sc[4 * t4] * inva, sc[4 * t4 + 1] * inva);
            *reinterpret_cast<uint32_t*>(pw + (g + 8) * kAttnLongProbsLd +
                                         cc) =
                pack_bf16(sc[4 * t4 + 2] * invb, sc[4 * t4 + 3] * invb);
          }
          __syncwarp();
#pragma unroll
          for (int i4 = 0; i4 < 4; ++i4) {
            const int rw = i4 * 4 + (lane >> 3);  // the warp's row
            const int cc = (lane & 7) * 8;        // its 8 keys
            const int i = q0 + la - g + rw;
            const int j = j0 + cc;
            if (i < N && j < N) {
              const bf16* from = pw + rw * kAttnLongProbsLd + cc;
              bf16* to = probs +
                         ((static_cast<long long>(b) * H + h) * N + i) * N +
                         j;
              if ((N & 7) == 0) {
                *reinterpret_cast<uint4*>(to) =
                    *reinterpret_cast<const uint4*>(from);
              } else {
                for (int e = 0; e < 8 && j + e < N; ++e) to[e] = from[e];
              }
            }
          }
          __syncwarp();
        }
        // P's A fragments, bf16(e) or bf16(e·(1/Σe)), into the slot
        const float fa = kNormFirst ? inva : 1.f;
        const float fb = kNormFirst ? invb : 1.f;
#pragma unroll
        for (int jt = 0; jt < 4; ++jt)
          slot[(kb * 4 + jt) * 256 + threadIdx.x] = make_uint4(
              pack_bf16(sc[8 * jt] * fa, sc[8 * jt + 1] * fa),
              pack_bf16(sc[8 * jt + 2] * fb, sc[8 * jt + 3] * fb),
              pack_bf16(sc[8 * jt + 4] * fa, sc[8 * jt + 5] * fa),
              pack_bf16(sc[8 * jt + 6] * fb, sc[8 * jt + 7] * fb));
      }
      mbar_arrive(&empty[st]);  // this thread is done with the slot
      ++it;
    };

    // P·V step u of the sample's pass_steps: O += P·V_part over block kb
    // (part u / kblocks, kb = u mod kblocks), P in pf (from pn), the last
    // step's in pp
    auto pv_step = [&](int u, uint32_t(&pf)[4][4], uint32_t(&pp)[4][4]) {
      const int part = u / kblocks;
      const int kb = u % kblocks;
#pragma unroll
      for (int jt = 0; jt < 4; ++jt)
#pragma unroll
        for (int i = 0; i < 4; ++i) pf[jt][i] = pn[jt][i];
      if (u + 1 < pass_steps) load_p((u + 1) % kblocks);
      const int st = it % kWideSlots;
      mbar_wait(&full[st], (it / kWideSlots) & 1);
      const unsigned char* vt = smem + st * kWideSlot;
      if (kb == 0) fence_acc(o);
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) fence_acc(pf[jt]);
      wgmma_fence();
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) long_pv<kWideLanes>(o, pf[jt], vt, jt);
      wgmma_commit();
      // the last step's slot, within a part (kb > 0), as in s_step
      if (kb < kblocks - 1) {
        wgmma_wait<1>();
#pragma unroll
        for (int jt = 0; jt < 4; ++jt) fence_acc(pp[jt]);
        if (kb > 0) mbar_arrive(&empty[(it - 1) % kWideSlots]);
      } else {
        wgmma_wait<0>();
        fence_acc(o);
#pragma unroll
        for (int jt = 0; jt < 4; ++jt) {
          fence_acc(pf[jt]);
          fence_acc(pp[jt]);
        }
        if (kb > 0) mbar_arrive(&empty[(it - 1) % kWideSlots]);
        mbar_arrive(&empty[st]);
        store(part);
#pragma unroll
        for (int i = 0; i < kWideLanes / 2; ++i) o[i] = 0.f;
      }
      ++it;
    };

    for (int t = 0; t < 2 * pass_steps; t += 2) {
      s_step(t, qe, qo);
      s_step(t + 1, qo, qe);
    }
    load_p(0);
#pragma unroll
    for (int i = 0; i < kWideLanes / 2; ++i) o[i] = 0.f;
    for (int u = 0; u < pass_steps; u += 2) {
      pv_step(u, pe, po);
      if (u + 1 < pass_steps) pv_step(u + 1, po, pe);
    }
  }
}

template <bool kProbs, bool kNormFirst, bool kTiles>
inline cudaError_t attention_wide_launch(const CUtensorMap& map_k,
                                         const CUtensorMap& map_v,
                                         const CUtensorMap& map_b,
                                         const bf16* q, long long ld,
                                         const float* bias, bf16* out,
                                         bf16* probs, int B, int N, int C,
                                         int H, int mode, void* scratch,
                                         float scale, cudaStream_t stream) {
  auto* kern = attention_wide_kernel<kProbs, kNormFirst, kTiles>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kAttnLongSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kAttnLongQueries - 1) / kAttnLongQueries,
                  wide_sample_groups(B, N, H), H);
  const int d = C / H;
  kern<<<grid, kWideCtaThreads, kAttnLongSmem, stream>>>(
      map_k, map_v, map_b, q, ld, bias, out, probs, B, N, C, d,
      mode == kBiasSlab, scale, static_cast<uint4*>(scratch));
  return cudaGetLastError();
}

// The wide form at head width C / H: K and V by the long route's 4-D maps
// (boxes of 64 lanes), the bias in the form its region takes, P through
// `scratch`.
template <bool kProbs, bool kNormFirst>
inline cudaError_t attention_wide_run(const bf16* q, const bf16* k,
                                      const bf16* v, long long ld,
                                      const float* bias, bf16* out,
                                      bf16* probs, int B, int N, int C, int H,
                                      void* scratch, float scale,
                                      cudaStream_t stream) {
  const int mode = long_bias_mode(N, wide_region_bytes(kProbs));
  CUtensorMap map_k, map_v, map_b;
  cudaError_t e = attn_long_map(&map_k, k, ld, B, N, H, C / H);
  if (e != cudaSuccess) return e;
  if ((e = attn_long_map(&map_v, v, ld, B, N, H, C / H)) != cudaSuccess)
    return e;
  if (mode == kBiasTiles) {
    if ((e = attn_long_bias_map(&map_b, bias, N, H)) != cudaSuccess) return e;
    return attention_wide_launch<kProbs, kNormFirst, true>(
        map_k, map_v, map_b, q, ld, bias, out, probs, B, N, C, H, mode,
        scratch, scale, stream);
  }
  return attention_wide_launch<kProbs, kNormFirst, false>(
      map_k, map_v, map_k, q, ld, bias, out, probs, B, N, C, H, mode, scratch,
      scale, stream);
}

// A long-route plan (`attention_plan` with route "long", or K4a's
// `attention_q8_plan`): the route's marker, the warps and samples of a CTA
// and its shared bytes as the route's kernel has them; N, B and H within
// the route's and the grid's limits.
inline bool attn_long_plan_ok(const int* plan, int B, int N, int H, int d,
                              int warps, int samples, int smem_bytes) {
  return plan[0] == kAttnLongRoute && plan[1] == warps &&
         plan[2] == samples && plan[3] == smem_bytes && N >= 1 &&
         N <= kAttnMaxLongTokens && B >= 1 && B <= 65535 && H >= 1 &&
         H <= 65535 && head_dim_ok(d);
}

// The attention core: out (B·N, C) bf16 from q, k, v rows `ld` apart (see
// attention_kernel), and with kProbs the normalized probabilities
// (B, H, N, N) bf16. The head width d is C / H (head_dim_ok), run on the
// core instance of width core_width(d). `plan` is the wrapper's launch
// plan (ops/kernels/fused_block.py `attention_plan` at that width): the
// 16-key tile bucket, the warps of a CTA, the samples of a CTA and the
// shared bytes of the short core (at the instance's width), or the long
// route's plan (attn_long_plan_ok), which launches attention_long_kernel
// (its q, k, v and bias 16-byte aligned), or on the wide form
// attention_wide_kernel with `scratch` (not null, 16-byte aligned, and
// `scratch_bytes` at least wide_slot_bytes's; unread elsewhere); a width,
// plan or scratch the kernels do not take is refused with
// cudaErrorInvalidValue.
template <bool kProbs, bool kNormFirst>
inline cudaError_t attention_launch(const bf16* q, const bf16* k,
                                    const bf16* v, long long ld,
                                    const float* bias, bf16* out, bf16* probs,
                                    int B, int N, int C, int H, int d_scale,
                                    const int* plan, void* scratch,
                                    long long scratch_bytes,
                                    cudaStream_t stream) {
  const int kt = plan[0], warps = plan[1], samples = plan[2], smem = plan[3];
  const int d = H > 0 && C % H == 0 ? C / H : 0;
  const int w = core_width(d);
  if (!scale_width_ok(d_scale, d)) return cudaErrorInvalidValue;
  const float scale = bf16_q_scale(d_scale);
  if (kt == kAttnLongRoute) {
    if (!head_dim_ok(d) ||
        !attn_long_plan_ok(plan, B, N, H, d, attn_long_warps(w),
                           attn_long_samples(w), kAttnLongSmem) ||
        ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(bias)) &
         15) != 0)
      return cudaErrorInvalidValue;
    switch (w) {
      case 32:
        return attention_long_run<32, kProbs, kNormFirst>(
            q, k, v, ld, bias, out, probs, B, N, C, H, scale, stream);
      case 64:
        return attention_long_run<64, kProbs, kNormFirst>(
            q, k, v, ld, bias, out, probs, B, N, C, H, scale, stream);
      case 128:
        return attention_long_run<128, kProbs, kNormFirst>(
            q, k, v, ld, bias, out, probs, B, N, C, H, scale, stream);
      case 256:
        return attention_long_run<256, kProbs, kNormFirst>(
            q, k, v, ld, bias, out, probs, B, N, C, H, scale, stream);
      case kWideCore:
        if (scratch == nullptr ||
            (reinterpret_cast<uintptr_t>(scratch) & 15) != 0 ||
            scratch_bytes < wide_slot_bytes(B, N, H, kWidePBlock))
          return cudaErrorInvalidValue;
        return attention_wide_run<kProbs, kNormFirst>(
            q, k, v, ld, bias, out, probs, B, N, C, H, scratch, scale,
            stream);
      default:
        return cudaErrorInvalidValue;
    }
  }
  // the short core: widths up to kShortMaxWidth (wider heads take the long
  // route at every N)
  if (!head_dim_ok(d) || w > kShortMaxWidth || N < 1 || N > 256 ||
      kt * 16 < N || warps < 1 || samples < 1 ||
      smem != attn_smem_bytes(N, w))
    return cudaErrorInvalidValue;
  switch (w) {
    case 32:
      return attention_width<32, kProbs, kNormFirst>(
          q, k, v, ld, bias, out, probs, B, N, C, H, kt, warps, samples, smem,
          scale, stream);
    case 64:
      return attention_width<64, kProbs, kNormFirst>(
          q, k, v, ld, bias, out, probs, B, N, C, H, kt, warps, samples, smem,
          scale, stream);
    case 128:
      return attention_width<128, kProbs, kNormFirst>(
          q, k, v, ld, bias, out, probs, B, N, C, H, kt, warps, samples, smem,
          scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The attention core over a packed (B·N, 3C) qkv, with or without probs.
template <bool kProbs>
inline cudaError_t attention_qkv(const bf16* qkv, const float* bias,
                                 bf16* out, bf16* probs, int B, int N, int C,
                                 int H, int d_scale, const int* plan,
                                 void* scratch, long long scratch_bytes,
                                 cudaStream_t stream) {
  return attention_launch<kProbs, false>(qkv, qkv + C, qkv + 2 * C, 3LL * C,
                                         bias, out, probs, B, N, C, H,
                                         d_scale, plan, scratch,
                                         scratch_bytes, stream);
}

inline cudaError_t attention(const bf16* qkv, const float* bias, bf16* out,
                             int B, int N, int C, int H, int d_scale,
                             const int* plan, void* scratch,
                             long long scratch_bytes, cudaStream_t stream) {
  return attention_qkv<false>(qkv, bias, out, nullptr, B, N, C, H, d_scale,
                              plan, scratch, scratch_bytes, stream);
}

}  // namespace
