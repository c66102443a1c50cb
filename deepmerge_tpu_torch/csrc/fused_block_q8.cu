// The w8a8 pre-LN transformer block (kernel K4) and a stage of such blocks,
// bf16 activations in and out, int8 GEMMs, for Hopper (sm_90a).
//
// Replaces the TPU kernels deepmerge_tpu/ops/pallas/fused_block.py
// `_block_kernel_q8` (math `_block_math_q8`, called through
// `_fused_block_forward` with quant=True) and the quant branch of
// `_chain_kernel` (called through `_fused_chain_forward`), both with dynamic
// per-row activation scales (`w8a8`) and with calibrated static scales, the
// 18th tuple entry (`w8a8-static`). The math, in its order:
//   y   = LN1(x)                           f32, never cast to bf16
//   qkv = bf16(bf16(dq(q(y)·Wqkv)) + bq)
//   a   = attention(qkv)                   bf16, K2's core, unchanged; with
//                                          `quant_attn` (`w8a8+attn`) the
//                                          int8 core K4a below
//   r   = bf16(x + bf16(bf16(dq(q(a)·Wproj)) + bp))
//   y2  = LN2(r)                           f32
//   h1  = gelu_tanh(dq(q(y2)·Wup) + bu)    f32
//   out = bf16(r + bf16(bf16(dq(q(h1)·Wdown)) + bd))
// where q(t) is int8 codes with a row scale and dq the dequantized s32 sum:
//   dynamic: s = max|t_row| > 0 ? max|t_row|·(1/127) : 1 for each row,
//            codes = clip(rint(t / s), ±127), dq = f32(acc)·s·s_w;
//   static:  s calibrated, codes = clip(rint(t·(1/s)), ±127),
//            dq = f32(acc)·(s·s_w).
// The 1/127 is the float32 reciprocal because the JAX package's compiler
// rewrites `amax / 127.0` so; every other division is IEEE (the build has
// no fast math) and the products of the dequantization are __fmul_rn, kept
// apart from the adds that follow them as the JAX package computes them.
// s_w is the weight's per-output-channel scale (`quantize_weight`).
//
// Bound on the H100: the four GEMMs carry the same 2.7 GOP per 192-token
// sample as K2's, on the int8 tensor cores (twice the bf16 rate). The
// design is K2's: a fixed sequence of launches from one C entry point,
// intermediates in device memory:
//   LN1+quantize → qkv GEMM → attention → quantize(a) → proj GEMM
//   (+residual) → LN2+quantize → up GEMM (+GELU) → [quantize(h1)] →
//   down GEMM (+residual).
// * The GEMMs are wgmma_gemm.cuh's, K2's kernel in s8: TMA loads of
//   128-byte K slabs (128 int8 values) in the 128-byte swizzle, wgmma
//   m64n256k32 with s32 accumulators (|Σ| <= 127²·K < 2^31 for K < 133,000,
//   so no saturation), a persistent grid, and an epilogue from the
//   accumulators that dequantizes and applies the bias, casts and GELU or
//   residual of its call. At K 768 a tile has six K slabs, half of bf16's,
//   so the epilogue weighs twice as much: its scales, biases and residual
//   pairs are read-only loads issued an eighth of the tile at a time,
//   ahead of the stores.
// * The GELU output never makes a second pass for its scale. With dynamic
//   scales the up GEMM's epilogue writes the f32 h1 and folds each row's
//   max|h1| into a per-row buffer (atomicMax on the bits of non-negative
//   floats, which order like integers: exact, independent of order); the
//   LN2 kernel before it zeroes the buffer, and the quantize pass after it
//   reads h1 once. With static scales the epilogue writes h1's int8 codes
//   straight away and no f32 h1 exists.
// * The row-quantize kernel of the attention output takes one warp per row
//   and reads the row twice (abs-max, then codes).

#include "block_common.cuh"
#include "wgmma_gemm.cuh"

namespace {

constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ signed char code_of(float q) {
  return static_cast<signed char>(
      __float2int_rn(fminf(fmaxf(rintf(q), -127.0f), 127.0f)));
}

// The code of x (x / s with dynamic scales, x·inv with static ones), or
// 0 for a lane that is not `live` (past a head's width). Selects, not a
// branch, and no zero dividend: a zero x takes the IEEE division's slow
// path (the padded lanes' codes by division cost K4a's short core 1.3-1.4x
// its time at padded widths on an H100).
__device__ __forceinline__ int lane_code(float x, bool live, bool dynamic,
                                         float s, float inv) {
  const float xl = live ? x : 1.0f;
  const int c = code_of(dynamic ? xl / s : xl * inv);
  return live ? c : 0;
}

// Eight codes of one row: q(t) with the row scale s (dynamic) or 1/s
// (static, `inv`), stored as one 8-byte word; zeros where not `live`.
__device__ __forceinline__ void store_codes8(const float* v, bool dynamic,
                                             float s, float inv,
                                             signed char* dst,
                                             bool live = true) {
  uint2 u;
  signed char* o = reinterpret_cast<signed char*>(&u);
#pragma unroll
  for (int t = 0; t < 8; ++t)
    o[t] = static_cast<signed char>(lane_code(v[t], live, dynamic, s, inv));
  *reinterpret_cast<uint2*>(dst) = u;
}

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int t = 0; t < 8; ++t) v[t] = __bfloat162float(e[t]);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// ---------------------------------------------------- LayerNorm + quantize

// The order in which ln_quant_kernel sums a row is fixed, not its forms'
// natural one: up to C 1024 a warp's (each lane one accumulator over its
// vectors, then the warp's sum), above a CTA's of kLnOrderWarps warps with
// one 8-element piece a thread at a time (piece j in thread j % 256, each
// thread one accumulator over its pieces in order, each warp's sum, then
// the warps' sums in order). Those were the one-warp and the one-CTA-a-row
// kernels this one replaced, so the w8a8 path's codes stay theirs bit for
// bit at every width. A lane holds the pieces of ln_order_slots such
// threads, one accumulator each: its vector i stands in for the thread of
// slot i % slots, and group warp g's slot r is that CTA's warp
// g + kGroup·r.
constexpr int kLnOrderWarps = 8;

__host__ __device__ constexpr int ln_order_slots(int vec, int group) {
  return vec == kLnMaxVec && group == 1 ? 1
         : (kLnOrderWarps / group < vec ? kLnOrderWarps / group : vec);
}

// The row's sum from each lane's kSlots accumulators `s`, in the order
// above, in every thread of the row's kGroup warps; `red` holds
// kLnWarps·kSlots floats (kGroup > 1), one array for each sum of a row.
template <int kGroup, int kSlots>
__device__ __forceinline__ float ordered_row_sum(const float (&s)[kSlots],
                                                 float* red) {
  float ws[kSlots];
#pragma unroll
  for (int r = 0; r < kSlots; ++r) ws[r] = warp_sum(s[r]);
  if constexpr (kGroup == 1) {
    float total = ws[0];
#pragma unroll
    for (int r = 1; r < kSlots; ++r) total += ws[r];
    return total;
  } else {
    const int warp = threadIdx.x >> 5;
    float* rr = red + (warp / kGroup) * (kGroup * kSlots);
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int r = 0; r < kSlots; ++r) rr[warp % kGroup + kGroup * r] = ws[r];
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + warp / kGroup),
                 "n"(32 * kGroup)
                 : "memory");
    float total = rr[0];
#pragma unroll
    for (int i = 1; i < kGroup * kSlots; ++i) total += rr[i];
    return total;
  }
}

// codes = q(LN(x)) per row with the f32 LayerNorm output (two-pass
// statistics, as the TPU kernel's `_ln`, summed in the order above), its
// row scale in row_scale.
// layer_norm_kernel's form (fused_block.cu): the row in registers, kGroup
// warps a row (kLnWarps / kGroup rows a CTA), kVec 8-element vectors a
// lane, C <= 256·kVec·kGroup; x, w and b in 16-byte loads. The LayerNorm
// output stays in the same registers: its abs-max over the row's warps
// (group_reduce as a max) and its codes come from there, eight codes a
// store. `static_scale` null means dynamic scales; `zero` (may be null)
// gets 0 at each row: the abs-max buffer that the next GEMM's epilogue
// folds into. Dispatch (ln_quant) as layer_norm's; the rows are
// memory-bound (2·C bytes in, C out). The statistics over the first Cn
// lanes, as layer_norm_kernel's (a zero-padded row's lanes past Cn come out
// 0, code 0, and leave the abs-max as it is).
template <int kVec, int kGroup>
__global__ void __launch_bounds__(kLnWarps * 32)
ln_quant_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b,
                const float* __restrict__ static_scale,
                signed char* __restrict__ codes, float* __restrict__ row_scale,
                float* __restrict__ zero, int M, int C, int Cn) {
  constexpr int kSlots = ln_order_slots(kVec, kGroup);
  // the two sums' floats and the abs-max's (kGroup > 1)
  __shared__ float red[2][kLnWarps * kSlots];
  __shared__ float red_max[kLnWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) *
                            (kLnWarps / kGroup) + warp / kGroup;
  if (kGroup == 1 && row >= M) return;
  const bool in = row < M;  // a group past M still joins the reductions
  const int first = (warp % kGroup) * 32 + lane;  // the thread's first vector
  const bf16* xr = x + (in ? row : 0) * C;
  float v[kVec][8];
  float s[kSlots];
#pragma unroll
  for (int r = 0; r < kSlots; ++r) s[r] = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int k = (first + 32 * kGroup * i) * 8;
    if (k < C) {
      load8(xr + k, v[i]);
#pragma unroll
      for (int t = 0; t < 8; ++t) s[i % kSlots] += v[i][t];
    }
  }
  const float mu =
      ordered_row_sum<kGroup>(s, red[0]) / static_cast<float>(Cn);
  float q[kSlots];
#pragma unroll
  for (int r = 0; r < kSlots; ++r) q[r] = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int k = (first + 32 * kGroup * i) * 8;
    if (k < C) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float d = k + t < Cn ? v[i][t] - mu : 0.f;
        q[i % kSlots] += d * d;
      }
    }
  }
  const float rs = rsqrtf(ordered_row_sum<kGroup>(q, red[1]) /
                              static_cast<float>(Cn) + kLnEps);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int k = (first + 32 * kGroup * i) * 8;
    if (k < C) {
      float ws[8], bs[8];
      load8(w + k, ws);
      load8(b + k, bs);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        v[i][t] = (v[i][t] - mu) * rs * ws[t] + bs[t];
        amax = fmaxf(amax, fabsf(v[i][t]));
      }
    }
  }
  const bool dynamic = static_scale == nullptr;
  float sc, inv = 0.f;
  if (dynamic) {
    amax = group_reduce<kGroup, true>(amax, red_max);
    sc = amax > 0.f ? amax * kInv127 : 1.0f;
  } else {
    sc = *static_scale;
    inv = 1.0f / sc;
  }
  if (!in) return;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int k = (first + 32 * kGroup * i) * 8;
    if (k < C) store_codes8(v[i], dynamic, sc, inv, codes + row * C + k);
  }
  if (first == 0) {
    row_scale[row] = sc;
    if (zero != nullptr) zero[row] = 0.f;
  }
}

// ------------------------------------------------------------ row quantize

// codes = q(x) per row of a bf16 (M, C) matrix, C % 8 == 0. One warp per
// row; the row is read twice (abs-max, then codes).
__global__ void __launch_bounds__(kLnWarps * 32)
row_quant_kernel(const bf16* __restrict__ x,
                 const float* __restrict__ static_scale,
                 signed char* __restrict__ codes,
                 float* __restrict__ row_scale, int M, int C) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kLnWarps + warp;
  if (row >= M) return;
  const bf16* xr = x + row * C;
  const bool dynamic = static_scale == nullptr;
  float v[8];
  float sc, inv = 0.f;
  if (dynamic) {
    float amax = 0.f;
    for (int k = lane * 8; k < C; k += 256) {
      load8(xr + k, v);
#pragma unroll
      for (int t = 0; t < 8; ++t) amax = fmaxf(amax, fabsf(v[t]));
    }
    amax = warp_max(amax);
    sc = amax > 0.f ? amax * kInv127 : 1.0f;
  } else {
    sc = *static_scale;
    inv = 1.0f / sc;
  }
  for (int k = lane * 8; k < C; k += 256) {
    load8(xr + k, v);
    store_codes8(v, dynamic, sc, inv, codes + row * C + k);
  }
  if (lane == 0) row_scale[row] = sc;
}

// codes = q(x) per row of the f32 GELU output (M, C) with dynamic scales,
// the row's abs-max already folded into row_amax by the up GEMM: one read
// of the row. One warp per row, C % 8 == 0.
__global__ void __launch_bounds__(kLnWarps * 32)
amax_quant_kernel(const float* __restrict__ x,
                  const float* __restrict__ row_amax,
                  signed char* __restrict__ codes,
                  float* __restrict__ row_scale, int M, int C) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kLnWarps + warp;
  if (row >= M) return;
  const float amax = row_amax[row];
  const float sc = amax > 0.f ? amax * kInv127 : 1.0f;
  float v[8];
  for (int k = lane * 8; k < C; k += 256) {
    load8(x + row * C + k, v);
    store_codes8(v, true, sc, 0.f, codes + row * C + k);
  }
  if (lane == 0) row_scale[row] = sc;
}

// -------------------------------------------------------------- int8 GEMM

// Launch plan of the s8 GEMM (ops/kernels/fused_block.py `gemm_q8_plan`
// writes the same six ints: tile rows, tile columns, K slab, stages,
// threads, shared bytes): K2's, 128x256 tiles and a 4-stage ring (193 KB),
// with 128-value (128-byte) K slabs; two consumer warpgroups and a
// producer warp, one CTA an SM.
constexpr int kQ8SlabK = 128, kQ8Stages = 4;
constexpr int kGemmQ8PlanInts = 6;

inline bool gemm_q8_plan_ok(const int* p) {
  return p[0] == kGemmBM && p[1] == kGemmBN && p[2] == kQ8SlabK &&
         p[3] == kQ8Stages && p[4] == kGemmThreads &&
         p[5] == gemm_smem_bytes(kQ8Stages);
}

enum QEpilogue {
  kQBiasCast = 0,       // bf16(bf16(dq) + b)
  kQBiasResidual = 1,   // bf16(resid + bf16(bf16(dq) + b))
  kQBiasGelu = 2,       // f32 gelu(dq + b), its row abs-max into row_amax
  kQBiasGeluCodes = 3,  // int8 codes of gelu(dq + b) at the static out_scale
  kQAcc = 4,            // the s32 sums themselves (the GEMM's own checks)
};

// The s8 GEMM's epilogue from the accumulators. The row scale is
// row_scale[m], or *static_scale when that is not null; out is bf16, f32
// or int8 by epilogue. Rows past M and columns past N are clamped for the
// loads and masked for the stores (and for the abs-max).
template <int kEpi>
struct EpiS8 {
  const float* w_scale;
  const float* row_scale;
  const float* static_scale;
  const bf16* bias;
  const bf16* resid;
  void* out;
  float* row_amax;
  const float* out_scale;

  __device__ __forceinline__ void store(const int (&d)[kGemmBN / 2],
                                        long long row_a, int n0, int tig,
                                        int M, int N) const {
    const long long row_b = row_a + 8;
    const long long ca = row_a < M ? row_a : M - 1;
    const long long cb = row_b < M ? row_b : M - 1;
    const bool stat = static_scale != nullptr;
    const float s_in = stat ? *static_scale : 0.f;
    const float sra = stat ? 0.f : __ldg(row_scale + ca);
    const float srb = stat ? 0.f : __ldg(row_scale + cb);
    float inv_out = 0.f;
    if constexpr (kEpi == kQBiasGeluCodes) inv_out = 1.0f / *out_scale;
    float amax_a = 0.f, amax_b = 0.f;
    // dq in the JAX order: (acc·s_row)·s_w, or acc·(s·s_w)
    auto dq = [&](int acc, float sr, float ws) {
      const float a = static_cast<float>(acc);  // round to nearest
      return stat ? __fmul_rn(a, __fmul_rn(s_in, ws))
                  : __fmul_rn(__fmul_rn(a, sr), ws);
    };
    // an eighth of the tile's columns at a time: its scales, biases and
    // residual pairs are loaded first, read-only (ld.global.nc), so that
    // their loads are in flight together ahead of the stores
#pragma unroll
    for (int part = 0; part < 8; ++part) {
      constexpr int kCols = kGemmBN / 64;  // column pairs per eighth
      float2 ws[kCols];
      uint32_t bq[kCols], ra[kCols], rb[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = n0 + (part * kCols + c) * 8 + 2 * tig;
        const int cc = col < N ? col : N - 2;
        ws[c] = __ldg(reinterpret_cast<const float2*>(w_scale + cc));
        bq[c] = __ldg(reinterpret_cast<const unsigned int*>(bias + cc));
        if constexpr (kEpi == kQBiasResidual) {
          ra[c] = __ldg(reinterpret_cast<const unsigned int*>(resid + ca * N +
                                                              cc));
          rb[c] = __ldg(reinterpret_cast<const unsigned int*>(resid + cb * N +
                                                              cc));
        } else {
          ra[c] = rb[c] = 0u;
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int i = part * kCols + c;
        const int col = n0 + i * 8 + 2 * tig;
        if (col >= N) continue;
        const long long oa = row_a * N + col, ob = row_b * N + col;
        if constexpr (kEpi == kQAcc) {
          int* o = static_cast<int*>(out);
          if (row_a < M)
            *reinterpret_cast<int2*>(o + oa) = make_int2(d[4 * i], d[4 * i + 1]);
          if (row_b < M)
            *reinterpret_cast<int2*>(o + ob) =
                make_int2(d[4 * i + 2], d[4 * i + 3]);
          continue;
        }
        const float2 bv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bq[c]));
        float y[4] = {dq(d[4 * i], sra, ws[c].x), dq(d[4 * i + 1], sra, ws[c].y),
                      dq(d[4 * i + 2], srb, ws[c].x),
                      dq(d[4 * i + 3], srb, ws[c].y)};
        if constexpr (kEpi == kQBiasGelu || kEpi == kQBiasGeluCodes) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            y[e] = gelu_tanh(__fadd_rn(y[e], (e & 1) ? bv.y : bv.x));
          if constexpr (kEpi == kQBiasGelu) {
            float* o = static_cast<float*>(out);
            if (row_a < M) {
              *reinterpret_cast<float2*>(o + oa) = make_float2(y[0], y[1]);
              amax_a = fmaxf(amax_a, fmaxf(fabsf(y[0]), fabsf(y[1])));
            }
            if (row_b < M) {
              *reinterpret_cast<float2*>(o + ob) = make_float2(y[2], y[3]);
              amax_b = fmaxf(amax_b, fmaxf(fabsf(y[2]), fabsf(y[3])));
            }
          } else {
            signed char* o = static_cast<signed char*>(out);
            if (row_a < M)
              *reinterpret_cast<char2*>(o + oa) = make_char2(
                  code_of(y[0] * inv_out), code_of(y[1] * inv_out));
            if (row_b < M)
              *reinterpret_cast<char2*>(o + ob) = make_char2(
                  code_of(y[2] * inv_out), code_of(y[3] * inv_out));
          }
        } else {
          bf16* o = static_cast<bf16*>(out);
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = round_bf16(y[e]) + ((e & 1) ? bv.y : bv.x);
          if constexpr (kEpi == kQBiasResidual) {
            const float2 rva = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&ra[c]));
            const float2 rvb = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&rb[c]));
            v[0] = rva.x + round_bf16(v[0]);
            v[1] = rva.y + round_bf16(v[1]);
            v[2] = rvb.x + round_bf16(v[2]);
            v[3] = rvb.y + round_bf16(v[3]);
          }
          if (row_a < M)
            *reinterpret_cast<__nv_bfloat162*>(o + oa) =
                __floats2bfloat162_rn(v[0], v[1]);
          if (row_b < M)
            *reinterpret_cast<__nv_bfloat162*>(o + ob) =
                __floats2bfloat162_rn(v[2], v[3]);
        }
      }
    }
    if constexpr (kEpi == kQBiasGelu) {
      // the quad holds the row's 256 columns of this tile
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        amax_a = fmaxf(amax_a, __shfl_xor_sync(0xffffffffu, amax_a, o));
        amax_b = fmaxf(amax_b, __shfl_xor_sync(0xffffffffu, amax_b, o));
      }
      if (tig == 0) {
        if (row_a < M)
          atomicMax(reinterpret_cast<int*>(row_amax + row_a),
                    __float_as_int(amax_a));
        if (row_b < M)
          atomicMax(reinterpret_cast<int*>(row_amax + row_b),
                    __float_as_int(amax_b));
      }
    }
  }
};

// out = epilogue(dq(Σ_k A[m, k]·W[n, k])): A (M, K) and W (N, K) row-major
// int8 codes (W in nn.Linear's layout), K % 16 == 0 (a K tail past the
// last 128-wide slab reads as zeros), N % 8 == 0 and
// 16-byte aligned bases (checked by the caller); `plan` is the GEMM's six
// ints, refused unless they are gemm_q8_plan's.
template <int kEpi>
cudaError_t gemm_s8(const signed char* A, const signed char* W,
                    const EpiS8<kEpi>& epi, int M, int N, int K,
                    const int* plan, cudaStream_t stream) {
  if (!gemm_q8_plan_ok(plan)) return cudaErrorInvalidValue;
  return wgmma_gemm<MmaS8, kQ8Stages>(A, W, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                                      epi, M, N, K, stream);
}

// One warp a row up to C 2048, two up to 4096, four above (up to
// kLnMaxWide), as layer_norm (fused_block.cu) dispatches; the statistics
// over the first Cn lanes (1 <= Cn <= C).
cudaError_t ln_quant(const bf16* x, const float* w, const float* b,
                     const float* static_scale, signed char* codes,
                     float* row_scale, float* zero, int M, int C, int Cn,
                     cudaStream_t stream) {
  const int rows = (M + kLnWarps - 1) / kLnWarps;
  if (Cn < 1 || Cn > C) return cudaErrorInvalidValue;
  if (C <= kLnMaxVec * 256)
    ln_quant_kernel<kLnMaxVec, 1><<<rows, kLnWarps * 32, 0, stream>>>(
        x, w, b, static_scale, codes, row_scale, zero, M, C, Cn);
  else if (C > kLnMaxWide || C % 8 != 0)
    return cudaErrorInvalidValue;
  else if (C <= 6 * 256)
    ln_quant_kernel<6, 1><<<rows, kLnWarps * 32, 0, stream>>>(
        x, w, b, static_scale, codes, row_scale, zero, M, C, Cn);
  else if (C <= 8 * 256)
    ln_quant_kernel<8, 1><<<rows, kLnWarps * 32, 0, stream>>>(
        x, w, b, static_scale, codes, row_scale, zero, M, C, Cn);
  else if (C <= 6 * 512)
    ln_quant_kernel<6, 2><<<(M + 3) / 4, kLnWarps * 32, 0, stream>>>(
        x, w, b, static_scale, codes, row_scale, zero, M, C, Cn);
  else if (C <= 8 * 512)
    ln_quant_kernel<8, 2><<<(M + 3) / 4, kLnWarps * 32, 0, stream>>>(
        x, w, b, static_scale, codes, row_scale, zero, M, C, Cn);
  else
    ln_quant_kernel<8, 4><<<(M + 1) / 2, kLnWarps * 32, 0, stream>>>(
        x, w, b, static_scale, codes, row_scale, zero, M, C, Cn);
  return cudaGetLastError();
}

cudaError_t row_quant(const bf16* x, const float* static_scale,
                      signed char* codes, float* row_scale, int M, int C,
                      cudaStream_t stream) {
  row_quant_kernel<<<(M + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0,
                     stream>>>(x, static_scale, codes, row_scale, M, C);
  return cudaGetLastError();
}

cudaError_t amax_quant(const float* x, const float* row_amax,
                       signed char* codes, float* row_scale, int M, int C,
                       cudaStream_t stream) {
  amax_quant_kernel<<<(M + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0,
                      stream>>>(x, row_amax, codes, row_scale, M, C);
  return cudaGetLastError();
}

// ------------------------------------------------- int8 attention (K4a)
//
// Replaces the `quant_attn` branch of the TPU kernels above:
// `_attn_inner_q8` (dynamic scales) and `_attn_inner_q8s` (calibrated
// static scales, entries 4-6 of the 18th tuple entry). Per head, in its
// order:
//   q, k: codes per row (token) over the head's d lanes, scale
//         s = max|row|·(1/127) (1 for a zero row), codes rint(t / s);
//   v:    codes per column (lane) over the N tokens, the same way;
//   (static: the scalars s_q, s_k, s_v, codes rint(t·(1/s)), clipped)
//   l  = (f32(qi·kiᵀ)·(s_q[n]·d^-½))·s_k[m] + bias   (static:
//        f32(qi·kiᵀ)·(s_q·s_k·d^-½) + bias), s32 sums on the int8 cores
//   pq = rint(127·exp(l − max_m l)), no clip: e lies in (0, 1]
//   out = bf16((f32(pq·vi)·(1/Σ_m pq))·s_v[lane])
// Products and sums stay separate roundings (__fmul_rn, __fadd_rn), as the
// JAX package computes them.
//
// Bound on the H100: as K2's core, the bytes of qkv, the f32 bias and the
// output. The design is the bf16 core's (block_common.cuh) on mma.sync
// m16n8k32 s8: a CTA of `warps` warps takes a head and `samples` samples,
// one after another; per sample the head's k codes (row scales in
// sk) go to shared memory in row order, rows of d + 16 bytes (48, 80 or
// 144: conflict-free ldmatrix), and its v codes, scaled by column (sv),
// transposed to
// [lane][key] for the value product's B fragments, each quantized from
// 16-byte loads issued four deep (the staging is bound by their latency:
// one load at a time cost it twice the core's time). Each warp then takes
// 16-query tiles:
//  * q straight from device memory into registers, quantized there: a
//    thread holds d/4 of a row's d lanes, the quad the whole row, so the
//    row abs-max takes two shuffles, and the codes are the logits' A
//    fragments (d/32 of them);
//  * S = qi·kiᵀ in s32 accumulators that stay in registers (4 a thread
//    for each 8-key tile), dequantized there in the JAX order with the
//    bias loaded branch-free (clamped indices, then masked);
//  * the row max by quad shuffles, pq = rint(127·e) and its exact integer
//    sum;
//  * P·V on m16n8k32 with pq taken from registers: the accumulators of
//    four 8-key tiles hold keys 8u + 2t, +1 of a 32-key step, the A
//    fragment wants positions 4t..4t+3 and 16+4t..+3, so V's keys are
//    stored in the order that maps one onto the other (the slot map), and
//    the s32 sums, exact, do not care about the order;
//  * out = bf16((f32(O)·(1/Σpq))·s_v) from the accumulators.
// kD is the core's width (32, 64 or 128; m16n8k32 needs kD % 32 == 0),
// d <= kD the head's (core_width(d) == kD): every scale (q's and k's rows,
// v's columns) is taken over the d real lanes alone, the lanes past d get
// code 0 (a padded v column scale 1, never read into an output), and only
// the d real output lanes are stored. kSteps (a bucket of the 32-key step
// count ceil(N/32)) sizes the register arrays; steps past ceil(N/32) are
// skipped. Keys past N get code 0 in k and v and pq 0; rows past N are
// computed on zero codes and not stored.

// k codes' row stride at head width d: 48, 80 or 144 bytes, each an odd
// multiple of 16 (conflict-free ldmatrix)
__host__ __device__ constexpr int q8_row(int d) { return d + 16; }
constexpr int kAttnQ8MaxWarps = 8;

// Shared memory of one K4a CTA for n tokens at head width d, keys padded
// to 32: k codes (np x (d + 16) B), v codes transposed (d x (np + 16) B:
// rows an odd multiple of 16 bytes apart, conflict-free for ldmatrix), k's
// row scales, v's column scales, v's partial column abs-maxes (one row of
// d for each d/8 threads of the largest CTA: 8,192 B at every width). At
// d 64: 37,888 B at n = 192, 47,360 B at n = 256.
struct AttnQ8Layout {
  int np, v_ld, kq, vt, sk, sv, red, bytes;
};

__host__ __device__ inline AttnQ8Layout attn_q8_layout(int n, int d) {
  AttnQ8Layout l;
  l.np = (n + 31) & ~31;
  l.v_ld = l.np + 16;
  l.kq = 0;
  l.vt = l.kq + l.np * q8_row(d);
  l.sk = l.vt + d * l.v_ld;
  l.sv = l.sk + l.np * static_cast<int>(sizeof(float));
  l.red = l.sv + d * static_cast<int>(sizeof(float));
  l.bytes = l.red + kAttnQ8MaxWarps * 32 / (d / 8) * d *
                        static_cast<int>(sizeof(float));
  return l;
}

// V's transposed rows keep the keys of each 32-key step in the order of
// the A fragments of pq: key 16h + 8u + 2t + e sits at slot
// 16h + 4t + 2u + e, where the A fragment (positions 4t..4t+3 and
// 16+4t..+3 of the thread's quad index t) takes it from the accumulators
// of 8-key tiles u = 0, 1 (and 2, 3 for h = 1).

// ldmatrix of two 8x8 b16 matrices (addresses from lanes 0-15)
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ uint32_t pack_s8(int c0, int c1, int c2, int c3) {
  return (static_cast<uint32_t>(c0) & 0xffu) |
         ((static_cast<uint32_t>(c1) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c2) & 0xffu) << 16) |
         (static_cast<uint32_t>(c3) << 24);
}

// d += a·b, m16n8k32, s8 operands, s32 accumulators. Fragments (g =
// lane/4, t = lane%4): a rows g (a[0], a[2]) and g+8 (a[1], a[3]), columns
// 4t..4t+3 (a[0], a[1]) and 16+4t..+3 (a[2], a[3]); b rows (k) 4t..4t+3
// (b0) and 16+4t..+3 (b1), column g; d rows g and g+8, columns 2t, 2t+1.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four bf16 of a q row (lanes col..col+3) as floats; 0 past N.
__device__ __forceinline__ void load4(const bf16* p, bool in, float* v) {
  uint2 u = make_uint2(0u, 0u);
  if (in) u = *reinterpret_cast<const uint2*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = __bfloat162float(e[t]);
}

// The logits of a thread's rows ra and rb over the four 8-key tiles of a
// 32-key step from t0: dequantized, + bias (clamped loads, as the bf16
// core), keys past N -inf (a row past N keeps finite logits; never
// stored).
template <bool kEven, bool kStatic>
__device__ __forceinline__ void q8_logits(const int (&s)[4][4],
                                          float (&l)[4][4], int t0,
                                          const float* sk, int np,
                                          const float* bias_h, int ra, int rb,
                                          int tig, int N, float ca, float cb) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int j = (t0 + t) * 8 + 2 * tig;
    const float2 ba = bias_load<kEven>(bias_h, ra, j, N);
    const float2 bb = bias_load<kEven>(bias_h, rb, j, N);
    float k0 = 1.f, k1 = 1.f;
    if constexpr (!kStatic) {
      const float2 kv =
          *reinterpret_cast<const float2*>(sk + (j < np ? j : np - 2));
      k0 = kv.x;
      k1 = kv.y;
    }
    auto dq = [&](int acc, float c, float kk) {
      const float a = static_cast<float>(acc);
      return kStatic ? __fmul_rn(a, c) : __fmul_rn(__fmul_rn(a, c), kk);
    };
    l[t][0] = __fadd_rn(dq(s[t][0], ca, k0), ba.x);
    l[t][1] = __fadd_rn(dq(s[t][1], ca, k1), ba.y);
    l[t][2] = __fadd_rn(dq(s[t][2], cb, k0), bb.x);
    l[t][3] = __fadd_rn(dq(s[t][3], cb, k1), bb.y);
    if (ra < N) {
      if (j >= N) l[t][0] = -INFINITY;
      if (j + 1 >= N) l[t][1] = -INFINITY;
    }
    if (rb < N) {
      if (j >= N) l[t][2] = -INFINITY;
      if (j + 1 >= N) l[t][3] = -INFINITY;
    }
  }
}

__device__ __forceinline__ int prob_code(float l, float mx) {
  return __float2int_rn(rintf(__fmul_rn(expf(l - mx), 127.0f)));
}

// q, k, v are the rows of a packed (B·N, 3C) bf16 qkv; out (B·N, C).
// s_qkv: the static (s_q, s_k, s_v) with kStatic, unused otherwise.
// The launch bound caps the registers: 168 a thread (the bf16 core's, 12
// warps), three 4-warp CTAs an SM; 85 up to two steps (N <= 64), where
// the short main loop leaves the staging's latency to hide, six CTAs an
// SM. At width 128 (64 s32 O accumulators a thread on top of up to 128
// logits) the bound is the CTA's own 8 warps: 255 registers, and 128 up
// to two steps.
template <int kD, int kSteps, bool kStatic>
__global__ void __launch_bounds__(
    (kD == 128 ? kAttnQ8MaxWarps : attn_max_warps(kD)) * 32,
    kSteps <= 2 ? 2 : 1)
attention_q8_kernel(const bf16* __restrict__ qkv,
                    const float* __restrict__ bias,
                    const float* __restrict__ s_qkv, bf16* __restrict__ out,
                    int B, int N, int C, int d, int samples, float scale) {
  constexpr int kTiles = 4 * kSteps;  // 8-key tiles
  constexpr int kOct = kD / 8;        // 16-byte pieces (8 lanes) of a row
  constexpr int kQ8Row = q8_row(kD);
  extern __shared__ __align__(16) unsigned char q8_smem[];
  const AttnQ8Layout L = attn_q8_layout(N, kD);
  signed char* kq = reinterpret_cast<signed char*>(q8_smem + L.kq);
  signed char* vt = reinterpret_cast<signed char*>(q8_smem + L.vt);
  float* sk = reinterpret_cast<float*>(q8_smem + L.sk);
  float* sv = reinterpret_cast<float*>(q8_smem + L.sv);
  float* red = reinterpret_cast<float*>(q8_smem + L.red);

  const int h = blockIdx.x;
  const long long ld = 3LL * C;
  const int head_off = h * d;
  const bf16* qb = qkv + head_off;
  const bf16* kb = qb + C;
  const bf16* vb = qb + 2 * C;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int mi = lane >> 3;  // the 8x8 matrix this lane addresses
  const int steps = L.np >> 5;
  const int q_tiles = (N + 15) >> 4;
  const bool even = (N & 1) == 0;
  const float* bias_h = bias + static_cast<long long>(h) * N * N;
  const unsigned full = 0xffffffffu;

  float s_q = 0.f, s_v = 0.f, inv_q = 0.f, inv_k = 0.f, inv_v = 0.f,
        c_static = 0.f;
  if constexpr (kStatic) {
    s_q = s_qkv[0];
    s_v = s_qkv[2];
    inv_q = 1.0f / s_q;
    inv_k = 1.0f / s_qkv[1];
    inv_v = 1.0f / s_v;
    c_static = __fmul_rn(__fmul_rn(s_q, s_qkv[1]), scale);
  }

  for (int si = 0; si < samples; ++si) {
    const int b = blockIdx.y * samples + si;
    if (b >= B) break;
    const long long row0 = static_cast<long long>(b) * N;

    // k codes: kOct threads a key (an octet of lanes each), the row's
    // abs-max over them, four keys' loads in flight at a time; keys past N
    // code 0, scale 1; lanes past d code 0
    for (int base = threadIdx.x; base < L.np * kOct;
         base += 4 * blockDim.x) {
      float v[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = base + u * blockDim.x;
#pragma unroll
        for (int t = 0; t < 8; ++t) v[u][t] = 0.f;
        if (idx < L.np * kOct && idx / kOct < N && (idx % kOct) * 8 < d)
          load8(kb + (row0 + idx / kOct) * ld + (idx % kOct) * 8, v[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = base + u * blockDim.x;
        float sc = 1.0f;
        if constexpr (!kStatic) {
          float amax = 0.f;
#pragma unroll
          for (int t = 0; t < 8; ++t) amax = fmaxf(amax, fabsf(v[u][t]));
#pragma unroll
          for (int o = 1; o < kOct; o <<= 1)
            amax = fmaxf(amax, __shfl_xor_sync(full, amax, o));
          sc = amax > 0.f ? amax * kInv127 : 1.0f;
        }
        if (idx < L.np * kOct) {
          store_codes8(v[u], !kStatic, sc, inv_k,
                       kq + (idx / kOct) * kQ8Row + (idx % kOct) * 8,
                       (idx % kOct) * 8 < d);
          if (idx % kOct == 0) sk[idx / kOct] = sc;
        }
      }
    }

    // v's column scales: a thread takes an octet of lanes over every
    // parts-th key, four keys' loads in flight at a time; the parts'
    // abs-maxes meet in shared memory
    if constexpr (!kStatic) {
      const int oct = threadIdx.x % kOct;
      const int part = threadIdx.x / kOct;
      const int parts = blockDim.x / kOct;
      float m[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int j0 = part; j0 < N; j0 += 4 * parts) {
        float v[4][8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u * parts;
#pragma unroll
          for (int t = 0; t < 8; ++t) v[u][t] = 0.f;
          if (j < N && oct * 8 < d)
            load8(vb + (row0 + j) * ld + oct * 8, v[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int t = 0; t < 8; ++t) m[t] = fmaxf(m[t], fabsf(v[u][t]));
      }
      float* r = red + part * kD + oct * 8;
      *reinterpret_cast<float4*>(r) = make_float4(m[0], m[1], m[2], m[3]);
      *reinterpret_cast<float4*>(r + 4) = make_float4(m[4], m[5], m[6], m[7]);
      __syncthreads();
      for (int dd = threadIdx.x; dd < kD; dd += blockDim.x) {
        float a = red[dd];
        for (int t = 1; t < parts; ++t) a = fmaxf(a, red[t * kD + dd]);
        sv[dd] = a > 0.f ? a * kInv127 : 1.0f;
      }
      __syncthreads();
    }

    // v codes, transposed: a thread takes an octet of lanes and the four
    // slots 4·grp..+3 of a 32-key step, keys 32s + 16h + 2t + {0, 1, 8, 9}
    // (the inverse of the slot map above), and writes one 4-byte word to
    // each of its eight lanes' rows
    for (int idx = threadIdx.x; idx < kOct * (L.np / 4); idx += blockDim.x) {
      const int oct = idx % kOct;
      const int grp = idx / kOct;
      const int j0 = (grp >> 3) * 32 + ((grp >> 2) & 1) * 16 + (grp & 3) * 2;
      float v[4][8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + (e & 1) + (e >> 1) * 8;
#pragma unroll
        for (int t = 0; t < 8; ++t) v[e][t] = 0.f;
        if (j < N && oct * 8 < d)
          load8(vb + (row0 + j) * ld + oct * 8, v[e]);
      }
      const bool live = oct * 8 < d;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int dd = oct * 8 + t;
        int c[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[e] = lane_code(v[e][t], live, !kStatic, kStatic ? 1.f : sv[dd],
                           inv_v);
        *reinterpret_cast<uint32_t*>(vt + dd * L.v_ld + 4 * grp) =
            pack_s8(c[0], c[1], c[2], c[3]);
      }
    }
    __syncthreads();

    for (int qt = warp; qt < q_tiles; qt += warps) {
      const int ra = qt * 16 + g;  // this thread's two query rows
      const int rb = ra + 8;
      const bf16* qa_row = qb + (row0 + ra) * ld + 4 * tig;
      const bf16* qb_row = qb + (row0 + rb) * ld + 4 * tig;

      // q codes: lanes 16c + 4t..+3 of rows ra and rb (0 past d)
      float va[kD / 16][4], vbq[kD / 16][4];
      float ma = 0.f, mb = 0.f;
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) {
        const bool in = 16 * c + 4 * tig < d;
        load4(qa_row + 16 * c, ra < N && in, va[c]);
        load4(qb_row + 16 * c, rb < N && in, vbq[c]);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          ma = fmaxf(ma, fabsf(va[c][t]));
          mb = fmaxf(mb, fabsf(vbq[c][t]));
        }
      }
      float sqa = s_q, sqb = s_q;
      if constexpr (!kStatic) {
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          ma = fmaxf(ma, __shfl_xor_sync(full, ma, o));
          mb = fmaxf(mb, __shfl_xor_sync(full, mb, o));
        }
        sqa = ma > 0.f ? ma * kInv127 : 1.0f;
        sqb = mb > 0.f ? mb * kInv127 : 1.0f;
      }
      uint32_t qa[kD / 32][4];  // A fragments of the 32-lane k steps
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) {
        const bool in = 16 * c + 4 * tig < d;
        int ca[4], cb[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          ca[t] = lane_code(va[c][t], in, !kStatic, sqa, inv_q);
          cb[t] = lane_code(vbq[c][t], in, !kStatic, sqb, inv_q);
        }
        qa[c >> 1][(c & 1) * 2] = pack_s8(ca[0], ca[1], ca[2], ca[3]);
        qa[c >> 1][(c & 1) * 2 + 1] = pack_s8(cb[0], cb[1], cb[2], cb[3]);
      }

      // S = qi·kiᵀ in s32, B fragments by ldmatrix from k's rows, then the
      // logits, one 32-key step at a time: the step's bias loads go out
      // together, and the compiler fence keeps the next step's from being
      // hoisted (all of them at once spilled at seven and eight steps)
      const float cqa = kStatic ? c_static : __fmul_rn(sqa, scale);
      const float cqb = kStatic ? c_static : __fmul_rn(sqb, scale);
      float l[kTiles][4];
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        if (st < steps) {
          int s4[4][4];
          float l4[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int t = 4 * st + u;
            const signed char* krow = kq + (t * 8 + (lane & 7)) * kQ8Row;
#pragma unroll
            for (int e = 0; e < 4; ++e) s4[u][e] = 0;
            if constexpr (kD == 32) {
              uint32_t bk[2];  // lanes 0-15, 16-31 of keys 8t..
              ldsm_x2(bk, krow + (mi & 1) * 16);
              mma_s8(s4[u], qa[0], bk[0], bk[1]);
            } else {
#pragma unroll
              for (int kc = 0; kc < kD / 64; ++kc) {
                uint32_t bk[4];  // lanes 64kc + 0-15, 16-31, 32-47, 48-63
                ldsm_x4(bk, reinterpret_cast<const bf16*>(krow + kc * 64 +
                                                          mi * 16));
                mma_s8(s4[u], qa[2 * kc], bk[0], bk[1]);
                mma_s8(s4[u], qa[2 * kc + 1], bk[2], bk[3]);
              }
            }
          }
          if (even)
            q8_logits<true, kStatic>(s4, l4, 4 * st, sk, L.np, bias_h, ra,
                                     rb, tig, N, cqa, cqb);
          else
            q8_logits<false, kStatic>(s4, l4, 4 * st, sk, L.np, bias_h, ra,
                                      rb, tig, N, cqa, cqb);
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) l[4 * st + u][e] = l4[u][e];
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) l[4 * st + u][e] = -INFINITY;
        }
        asm volatile("" ::: "memory");
      }

      // the row max over the quad, pq and Σpq
      float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        mxa = fmaxf(mxa, fmaxf(l[t][0], l[t][1]));
        mxb = fmaxf(mxb, fmaxf(l[t][2], l[t][3]));
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mxa = fmaxf(mxa, __shfl_xor_sync(full, mxa, o));
        mxb = fmaxf(mxb, __shfl_xor_sync(full, mxb, o));
      }
      // pq in the A fragments of the 32-key steps, straight from the
      // accumulator layout (see the slot map)
      uint32_t p[kSteps][4];
      int suma = 0, sumb = 0;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        int ca[4][2], cb[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = 4 * st + u;
          ca[u][0] = prob_code(l[t][0], mxa);
          ca[u][1] = prob_code(l[t][1], mxa);
          cb[u][0] = prob_code(l[t][2], mxb);
          cb[u][1] = prob_code(l[t][3], mxb);
          suma += ca[u][0] + ca[u][1];
          sumb += cb[u][0] + cb[u][1];
        }
        p[st][0] = pack_s8(ca[0][0], ca[0][1], ca[1][0], ca[1][1]);
        p[st][1] = pack_s8(cb[0][0], cb[0][1], cb[1][0], cb[1][1]);
        p[st][2] = pack_s8(ca[2][0], ca[2][1], ca[3][0], ca[3][1]);
        p[st][3] = pack_s8(cb[2][0], cb[2][1], cb[3][0], cb[3][1]);
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        suma += __shfl_xor_sync(full, suma, o);
        sumb += __shfl_xor_sync(full, sumb, o);
      }
      const float inva = suma > 0 ? 1.0f / static_cast<float>(suma) : 0.f;
      const float invb = sumb > 0 ? 1.0f / static_cast<float>(sumb) : 0.f;

      // O = pq·vi (16 x kD, s32), B fragments by ldmatrix from v's
      // transposed rows
      int o[kD / 8][4];
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] = 0;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        if (st < steps) {
#pragma unroll
          for (int dd = 0; dd < kD / 16; ++dd) {
            uint32_t bv[4];  // lanes 16dd..+7 (keys 0-15, 16-31), +8..+15
            ldsm_x4(bv, reinterpret_cast<const bf16*>(
                            vt + (dd * 16 + (mi >> 1) * 8 + (lane & 7)) *
                                     L.v_ld +
                            32 * st + (mi & 1) * 16));
            mma_s8(o[2 * dd], p[st], bv[0], bv[1]);
            mma_s8(o[2 * dd + 1], p[st], bv[2], bv[3]);
          }
        }
      }

      // out = bf16((O · 1/Σpq) · s_v), the d real lanes
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        const int col = dt * 8 + 2 * tig;
        const bool real = dt * 8 < d;
        const float v0 = kStatic ? s_v : sv[col];
        const float v1 = kStatic ? s_v : sv[col + 1];
        if (ra < N && real)
          *reinterpret_cast<__nv_bfloat162*>(out + (row0 + ra) * C +
                                             head_off + col) =
              __floats2bfloat162_rn(
                  __fmul_rn(__fmul_rn(static_cast<float>(o[dt][0]), inva), v0),
                  __fmul_rn(__fmul_rn(static_cast<float>(o[dt][1]), inva), v1));
        if (rb < N && real)
          *reinterpret_cast<__nv_bfloat162*>(out + (row0 + rb) * C +
                                             head_off + col) =
              __floats2bfloat162_rn(
                  __fmul_rn(__fmul_rn(static_cast<float>(o[dt][2]), invb), v0),
                  __fmul_rn(__fmul_rn(static_cast<float>(o[dt][3]), invb), v1));
      }
    }
    __syncthreads();  // k, v and their scales are restaged for the next sample
  }
}

template <int kD, int kSteps, bool kStatic>
inline cudaError_t attention_q8_run(const bf16* qkv, const float* bias,
                                    const float* s_qkv, bf16* out, int B,
                                    int N, int C, int H, int warps,
                                    int samples, int smem, float scale,
                                    cudaStream_t stream) {
  auto* kern = attention_q8_kernel<kD, kSteps, kStatic>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int d = C / H;
  const dim3 grid(H, (B + samples - 1) / samples);
  kern<<<grid, warps * 32, smem, stream>>>(qkv, bias, s_qkv, out, B, N, C,
                                           d, samples, scale);
  return cudaGetLastError();
}

template <int kD>
inline cudaError_t attention_q8_width(const bf16* qkv, const float* bias,
                                      const float* s_qkv, bf16* out, int B,
                                      int N, int C, int H, int kt, int warps,
                                      int samples, int smem, float scale,
                                      cudaStream_t stream) {
#define DM_ATTN_Q8_CASE(KS)                                                  \
  case KS:                                                                   \
    return s_qkv != nullptr                                                  \
               ? attention_q8_run<kD, KS, true>(qkv, bias, s_qkv, out, B, N, \
                                                C, H, warps, samples, smem,  \
                                                scale, stream)               \
               : attention_q8_run<kD, KS, false>(qkv, bias, nullptr, out, B, \
                                                 N, C, H, warps, samples,    \
                                                 smem, scale, stream);
  switch (kt) {
    DM_ATTN_Q8_CASE(1)
    DM_ATTN_Q8_CASE(2)
    DM_ATTN_Q8_CASE(4)
    DM_ATTN_Q8_CASE(6)
    DM_ATTN_Q8_CASE(7)
    DM_ATTN_Q8_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef DM_ATTN_Q8_CASE
}

// ------------------------------------------------- K4a, long route
//
// The int8 core for N > 256 (and any N a plan forces). JAX rounds pq =
// rint(127·exp(l − max)) against the row's final max, and v's dynamic
// scales are per column over all N keys (`_attn_inner_q8`), so the route
// is two launches:
//  * a pre-pass (attention_q8_prepass_kernel), one CTA a (sample, head),
//    quantizes each operand once: k's codes and row scales, v's column
//    scales over the N keys, and v's codes transposed to (d, keys), keys
//    contiguous, the K-major layout of an s8 wgmma B operand, in the slot
//    order of pq's fragments below (the short core's slot map); into
//    scratch, keys padded to a multiple of 64 with code 0 and scale 1;
//  * the core (attention_q8_long_kernel) on those codes, the bf16 long
//    route's schedule (block_common.cuh): a CTA takes 128 queries of one
//    head and attn_long_samples(d) samples at a time (two, one at widths
//    128 and 256; at width 64 one sample a CTA took 3.29 ms against two's
//    2.70 at B 128, N 768 on an H100), two warpgroups of 64 rows a sample;
//    k codes (and in pass 2 vᵀ codes) of a 64-key block of each sample,
//    with k's 64 row scales, by TMA into a three-stage ring that warp 0
//    refills a step ahead; the bias as TMA tiles, a slab or row copies, as
//    that route reads it;
//    - q's codes made in registers from the bf16 rows, as the short core
//      makes them: they are wgmma's register A fragments (a warp's slice of
//      m64k32 is mma.sync m16n8k32's A);
//    - S = qi·kiᵀ by wgmma m64n64k32 s8 (s32 sums), k K-major from shared
//      memory, each k step's 32 lanes a TMA box of its own in the 32-byte
//      swizzle;
//    - pass 1: the logits dequantized as the short core does (q8_logits)
//      + bias, masked, and the row max (exact, in any order);
//    - pass 2: the same logits, pq against the final max (prob_code), its
//      exact integer sum, then O += pq·vi by wgmma k32 s8 with pq
//      as register A fragments straight from the accumulator layout (the
//      slot order of vᵀ maps one onto the other) and vᵀ K-major from
//      shared memory (64-byte swizzle; q8_long_pv);
//    - out = bf16((f32(O)·(1/Σpq))·s_v);
//    - at width 256 pass 2 runs once for each half of the head's lanes
//      (attn_long_parts, as the bf16 route): the same codes and S again,
//      O and vᵀ of 128 lanes a part (O stays 64 s32 a thread beside q's
//      32 fragment registers), Σpq summed in the first part; s32 sums are
//      exact in any order.
// Every value goes through the short core's arithmetic (code_of,
// store_codes8, the same scales, __fmul_rn/__fadd_rn in the JAX order,
// prob_code, exact maxima and integer sums), so the codes and the output
// equal the short core's bit for bit wherever both run.
//
// Bound on the H100 at B 128, N 768, d 64: the bytes of qkv, the bias and
// the output, 0.19 ms; the three int8 products (S twice, P·V) 0.18 ms at
// the int8 peak; the logits' f32 work (about 27 operations a logit over
// both passes, 0.83 ms at the f32 peak) is what the kernel spends most
// on, so it keeps the bf16 route's warps in flight (four warpgroups at 128
// registers, two samples on each bias tile). The pre-pass moves 2·B·N·C
// bf16 in and as many int8 codes out.

constexpr int kQ8PrepassThreads = 256;
constexpr int kQ8LongStages = 3;


// Keys of a (sample, head) in the route's scratch: N rounded up to a
// whole 64-key block.
__host__ __device__ inline long long q8_long_np(int N) {
  return (static_cast<long long>(N) + kAttnLongKeys - 1) / kAttnLongKeys *
         kAttnLongKeys;
}

// The route's scratch for B samples of N tokens, H heads on the core of
// width kD = core_width(d) (the wrapper's ops/kernels/fused_block.py
// attention_q8_long_scratch): k codes (B, H, Np, kD), v codes transposed
// (B, H, kD, Np), k's row scales (B, H, Np) f32, v's column scales (B, H,
// kD) f32; the scales only with dynamic scales. The lanes past the head's
// d hold code 0 (and v's column scale 1), so the core's TMA maps and
// products run at the instance's width.
struct Q8LongScratch {
  signed char* kc;
  signed char* vt;
  float* ks;
  float* vs;
};

inline Q8LongScratch q8_long_scratch(void* base, int B, int N, int H, int d) {
  const long long codes = static_cast<long long>(B) * H * q8_long_np(N) * d;
  Q8LongScratch s;
  s.kc = static_cast<signed char*>(base);
  s.vt = s.kc + codes;
  s.ks = reinterpret_cast<float*>(s.vt + codes);
  s.vs = s.ks + static_cast<long long>(B) * H * q8_long_np(N);
  return s;
}

// The slot of key jl of a 64-key block in v's transposed rows: key 16h +
// 8u + 2t + e of each 32-key half at 16h + 4t + 2u + e.
__host__ __device__ constexpr int q8_slot(int jl) {
  return (jl & ~15) | (((jl >> 1) & 3) << 2) | (((jl >> 3) & 1) << 1) |
         (jl & 1);
}

// The pre-pass (see above) of (sample, head) blockIdx.x = b·H + h, a head
// of width d on the scratch of width kD = core_width(d).
template <int kD, bool kStatic>
__global__ void __launch_bounds__(kQ8PrepassThreads)
attention_q8_prepass_kernel(const bf16* __restrict__ qkv,
                            const float* __restrict__ s_qkv, Q8LongScratch sc,
                            int N, int C, int H) {
  constexpr int kOct = kD / 8;  // 16-byte pieces (8 lanes) of a row
  constexpr int kParts = kQ8PrepassThreads / kOct;
  __shared__ float red[kParts * kD];
  __shared__ float sv[kD];
  __shared__ __align__(16) signed char vtile[kD * kAttnLongKeys];
  const long long bh = blockIdx.x;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  const long long ld = 3LL * C;
  const long long np = q8_long_np(N);
  const long long row0 = static_cast<long long>(b) * N;
  const int d = C / H;
  const bf16* kb = qkv + C + h * d;
  const bf16* vb = qkv + 2 * C + h * d;
  const unsigned full = 0xffffffffu;
  float inv_k = 0.f, inv_v = 0.f;
  if constexpr (kStatic) {
    inv_k = 1.0f / s_qkv[1];
    inv_v = 1.0f / s_qkv[2];
  }

  // k codes: kOct threads a key (an octet of lanes each), the row's
  // abs-max over them (np·kOct is a multiple of the CTA: every thread
  // takes each turn, as the shuffles need)
  signed char* kc = sc.kc + bh * np * kD;
  for (long long idx = threadIdx.x; idx < np * kOct; idx += blockDim.x) {
    const long long j = idx / kOct;
    const int o = static_cast<int>(idx % kOct);
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (j < N && o * 8 < d) load8(kb + (row0 + j) * ld + o * 8, v);
    float s = 1.0f;
    if constexpr (!kStatic) {
      float amax = 0.f;
#pragma unroll
      for (int t = 0; t < 8; ++t) amax = fmaxf(amax, fabsf(v[t]));
#pragma unroll
      for (int w = 1; w < kOct; w <<= 1)
        amax = fmaxf(amax, __shfl_xor_sync(full, amax, w));
      s = amax > 0.f ? amax * kInv127 : 1.0f;
      if (o == 0) sc.ks[bh * np + j] = s;
    }
    store_codes8(v, !kStatic, s, inv_k, kc + j * kD + o * 8, o * 8 < d);
  }

  // v's column scales: a thread takes an octet of lanes over every
  // kParts-th key, four keys' loads in flight at a time
  if constexpr (!kStatic) {
    const int o = threadIdx.x % kOct;
    const int part = threadIdx.x / kOct;
    float m[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j0 = part; j0 < N; j0 += 4 * kParts) {
      float v[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u * kParts;
#pragma unroll
        for (int t = 0; t < 8; ++t) v[u][t] = 0.f;
        if (j < N && o * 8 < d) load8(vb + (row0 + j) * ld + o * 8, v[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int t = 0; t < 8; ++t) m[t] = fmaxf(m[t], fabsf(v[u][t]));
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) red[part * kD + o * 8 + t] = m[t];
    __syncthreads();
    for (int dd = threadIdx.x; dd < kD; dd += blockDim.x) {
      float a = red[dd];
      for (int p = 1; p < kParts; ++p) a = fmaxf(a, red[p * kD + dd]);
      const float s = a > 0.f ? a * kInv127 : 1.0f;
      sv[dd] = s;
      sc.vs[bh * kD + dd] = s;
    }
    __syncthreads();
  }

  // v codes, transposed: a 64-key block's codes into vtile (d rows of 64
  // slots), then the rows out in 16-byte pieces
  signed char* vt = sc.vt + bh * kD * np;
  for (long long j0 = 0; j0 < np; j0 += kAttnLongKeys) {
    for (int idx = threadIdx.x; idx < kAttnLongKeys * kOct;
         idx += blockDim.x) {
      const int jl = idx / kOct, o = idx % kOct;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (j0 + jl < N && o * 8 < d)
        load8(vb + (row0 + j0 + jl) * ld + o * 8, v);
      const int slot = q8_slot(jl);
      const bool live = o * 8 < d;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int dd = o * 8 + t;
        vtile[dd * kAttnLongKeys + slot] = static_cast<signed char>(
            lane_code(v[t], live, !kStatic, kStatic ? 1.f : sv[dd], inv_v));
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kD * kAttnLongKeys / 16; i += blockDim.x) {
      const int dd = i / (kAttnLongKeys / 16), c = i % (kAttnLongKeys / 16);
      *reinterpret_cast<uint4*>(vt + dd * np + j0 + c * 16) =
          *reinterpret_cast<const uint4*>(vtile + dd * kAttnLongKeys +
                                          c * 16);
    }
    __syncthreads();
  }
}

// d[kOff..kOff+31] (m64 x n64, s32, wgmma's accumulator layout) += a (m64 x
// k32 s8 register fragments, the mma.sync m16n8k32 A layout of each warp's
// 16 rows) · b (n64 x k32 s8, K-major from the descriptor).
template <int kOff = 0, int kN>
__device__ __forceinline__ void wgmma_s8_m64n64k32_rs(int (&d)[kN],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db) {
  static_assert(kOff + 32 <= kN, "accumulators in range");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[kOff + 0]), "+r"(d[kOff + 1]), "+r"(d[kOff + 2]),
        "+r"(d[kOff + 3]), "+r"(d[kOff + 4]), "+r"(d[kOff + 5]),
        "+r"(d[kOff + 6]), "+r"(d[kOff + 7]), "+r"(d[kOff + 8]),
        "+r"(d[kOff + 9]), "+r"(d[kOff + 10]), "+r"(d[kOff + 11]),
        "+r"(d[kOff + 12]), "+r"(d[kOff + 13]), "+r"(d[kOff + 14]),
        "+r"(d[kOff + 15]), "+r"(d[kOff + 16]), "+r"(d[kOff + 17]),
        "+r"(d[kOff + 18]), "+r"(d[kOff + 19]), "+r"(d[kOff + 20]),
        "+r"(d[kOff + 21]), "+r"(d[kOff + 22]), "+r"(d[kOff + 23]),
        "+r"(d[kOff + 24]), "+r"(d[kOff + 25]), "+r"(d[kOff + 26]),
        "+r"(d[kOff + 27]), "+r"(d[kOff + 28]), "+r"(d[kOff + 29]),
        "+r"(d[kOff + 30]), "+r"(d[kOff + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// The same at n32 (the value product at head width 32).
template <int kOff = 0, int kN>
__device__ __forceinline__ void wgmma_s8_m64n32k32_rs(int (&d)[kN],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db) {
  static_assert(kOff + 16 <= kN, "accumulators in range");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p;\n"
      "}\n"
      : "+r"(d[kOff + 0]), "+r"(d[kOff + 1]), "+r"(d[kOff + 2]),
        "+r"(d[kOff + 3]), "+r"(d[kOff + 4]), "+r"(d[kOff + 5]),
        "+r"(d[kOff + 6]), "+r"(d[kOff + 7]), "+r"(d[kOff + 8]),
        "+r"(d[kOff + 9]), "+r"(d[kOff + 10]), "+r"(d[kOff + 11]),
        "+r"(d[kOff + 12]), "+r"(d[kOff + 13]), "+r"(d[kOff + 14]),
        "+r"(d[kOff + 15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// O (64 x kD, s32) += pq (64 x 32 slots of k step ks) · vi, vᵀ's block at
// vt: kD rows of 64 slots in the 64-byte swizzle, in n32 pieces at widths
// 32 and 64 and n64 pieces at 128, each piece's rows on from the last.
// Not one n64 piece at width 64: there ptxas (CUDA 12.9) gave pq's
// fragments the physical registers that still held q's, which the PTX
// keeps live across the key loop, so every S product after the first P·V
// read pq as q (the same IGMMA A registers in the SASS, no restore in the
// loop; fences before and after do not change it). The n32 build keeps
// them apart, and phase 3 holds every width bit-exact against the plain
// twin, so a toolchain that does it again fails the check.
template <int kD>
__device__ __forceinline__ void q8_long_pv(int (&o)[kD / 2],
                                           const uint32_t (&p)[4],
                                           const unsigned char* vt, int ks) {
  const uint64_t db = wgmma_desc_sw<kAttnLongKeys>(vt) + 2 * ks;
  if constexpr (kD == 128) {
    wgmma_s8_m64n64k32_rs(o, p, db);
    wgmma_s8_m64n64k32_rs<32>(o, p, db + ((64 * kAttnLongKeys) >> 4));
  } else {
    wgmma_s8_m64n32k32_rs(o, p, db);
    if constexpr (kD == 64)
      wgmma_s8_m64n32k32_rs<16>(o, p, db + ((32 * kAttnLongKeys) >> 4));
  }
}

// The core's shared memory from its 1024-aligned start: the ring (stage st
// holds a 64-key block of k codes of each sample, then of vᵀ codes (a
// part's rows), then k's 64 row scales of each; a stage rounded up to 1
// KB), the bias region (the stages' bias areas, or a slab, as the bf16
// route's), the barriers (each stage's full and empty, then the slab's). A
// stage: 9,216 B at d 32, 17,408 at 64 and 128, 25,600 at 256; the bias
// region 203,712, 179,136 and 154,560 B (a slab up to N 397, 349 and 301).
__host__ __device__ constexpr int q8_long_tile_bytes(int d) {
  return kAttnLongKeys * d;
}
__host__ __device__ constexpr int q8_long_vt_bytes(int d) {
  return q8_long_tile_bytes(d) / attn_long_parts(d);
}
__host__ __device__ constexpr int q8_long_stage_bytes(int d) {
  return (attn_long_samples(d) *
              (q8_long_tile_bytes(d) + q8_long_vt_bytes(d)) +
          attn_long_samples(d) * kAttnLongKeys * 4 + 1023) /
         1024 * 1024;
}
__host__ __device__ constexpr int q8_long_region_off(int d) {
  return kQ8LongStages * q8_long_stage_bytes(d);
}
__host__ __device__ constexpr int q8_long_bar_bytes() {
  return ((2 * kQ8LongStages + 1) * 8 + 15) / 16 * 16;
}
__host__ __device__ constexpr int q8_long_region_bytes(int d) {
  return kAttnLongSmem - 1024 - q8_long_region_off(d) - q8_long_bar_bytes();
}

// The core (see above). map_k reads k codes as (d bytes, B·H·Np rows) in
// boxes of 32 bytes x 64 rows; map_v vᵀ codes as (Np bytes, B·H·d rows)
// in boxes of 64 bytes x kOW rows (a part's); kTiles: the bias in the tile
// form, map_b its map (attn_long_bias_map); else `slab` picks the slab form
// or the row form.
// q is read from the packed qkv (rows 3C apart; lanes past the head's
// width d as 0), the output rows are C apart (head h's d lanes d·h on are
// written); ks and vs are the pre-pass's scales (dynamic scales, kD wide),
// s_qkv the static (s_q, s_k, s_v). kD = core_width(d).
template <int kD, bool kStatic, bool kTiles>
__global__ void __launch_bounds__(attn_long_warps(kD) * 32, 1)
attention_q8_long_kernel(const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_b,
                         const bf16* __restrict__ qkv,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const float* __restrict__ bias,
                         const float* __restrict__ s_qkv,
                         bf16* __restrict__ out, int B, int N, int C, int d,
                         bool slab, float scale) {
  constexpr int kSamples = attn_long_samples(kD);
  constexpr int kStages = kQ8LongStages;
  constexpr int kParts = attn_long_parts(kD);
  constexpr int kOW = kD / kParts;  // O's lanes of a part
  constexpr int kTile = q8_long_tile_bytes(kD);
  constexpr int kVT = q8_long_vt_bytes(kD);  // a part's vᵀ codes
  constexpr int kStage = q8_long_stage_bytes(kD);
  constexpr int kScaleOff = kSamples * (kTile + kVT);  // k's row scales
  constexpr int kScaleBytes = kAttnLongKeys * 4;
  constexpr int kKBox = kAttnLongKeys * 32;  // a 32-lane box of k codes
  constexpr int kArea = kAttnLongBiasBytes / 4;  // a stage's bias area, floats
  extern __shared__ unsigned char q8_long_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(q8_long_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  float* region = reinterpret_cast<float*>(smem + q8_long_region_off(kD));
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + q8_long_region_off(kD) + q8_long_region_bytes(kD));
  uint64_t* empty = full + kStages;
  uint64_t* slab_full = empty + kStages;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kAttnLongQueries;
  const int h = blockIdx.z;
  const int H = gridDim.z;
  const int head_off = h * d;
  const long long ld = 3LL * C;
  const long long np = q8_long_np(N);
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

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the TMA arrival, and in the row form one a lane of warp 0
      mbar_init(&full[s], rows_form ? 1 + 32 : 1);
      mbar_init(&empty[s], attn_long_warps(kD) * 32);
    }
    mbar_init(slab_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Warp 0's loads for global step g (sample group blockIdx.y + (g / steps)
  // · gridDim.y, block (g mod steps) mod kblocks, vᵀ (its part's rows) too
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
    const int part = kParts == 1 ? 0 : s / kblocks - 1;  // pass 2's
    if (lane == 0) {
      mbar_expect_tx(&full[st],
                     live * (kTile + (with_v ? kVT : 0) +
                             (kStatic ? 0 : kScaleBytes)) +
                         (kTiles ? 2 * kAttnLongQueries * 128 : 0));
      for (int si = 0; si < live; ++si) {
        const long long bh = static_cast<long long>(b0 + si) * H + h;
#pragma unroll
        for (int x = 0; x < kD / 32; ++x)
          tma_load_2d(kv + si * kTile + x * kKBox, &map_k, &full[st], 32 * x,
                      static_cast<int>(bh * np + j0));
        if (with_v)
          tma_load_2d(kv + kSamples * kTile + si * kVT, &map_v, &full[st],
                      j0, static_cast<int>(bh * kD + part * kOW));
        if constexpr (!kStatic)
          bulk_load(kv + kScaleOff + si * kScaleBytes, ks + bh * np + j0,
                    kScaleBytes, &full[st]);
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
  const unsigned fullmask = 0xffffffffu;
  const int lin_a = long_bias_lin(slab, slab_shift, bias_h, la, ra, N, tig);
  const int lin_b = long_bias_lin(slab, slab_shift, bias_h, lb, rb, N, tig);
  int toff[4];
  long_tile_offsets(toff, la, tig);
  if (slab) mbar_wait(slab_full, 0);

  float s_q = 0.f, s_v = 0.f, inv_q = 0.f, c_static = 0.f;
  if constexpr (kStatic) {
    s_q = s_qkv[0];
    s_v = s_qkv[2];
    inv_q = 1.0f / s_q;
    c_static = __fmul_rn(__fmul_rn(s_q, s_qkv[1]), scale);
  }

  uint32_t qa[kD / 32][4];  // q codes of the thread's rows, A fragments
  // a part's O, wgmma's layout: o[4i..4i+3] its columns 8i + 2·tig, + 1
  int o[kOW / 2];
  int it = 0;     // the global step
  for (int grp = blockIdx.y; grp < groups; grp += gridDim.y) {
    const int b = grp * kSamples + si;
    const bool live = b < B;
    const long long row0 = static_cast<long long>(b) * N;
    const long long bh = static_cast<long long>(b) * H + h;

    // q codes: lanes 16c + 4·tig..+3 of rows ra and rb (0 past d), the
    // short core's
    float cqa, cqb;
    {
      const bf16* qa_row = qkv + (row0 + ra) * ld + head_off + 4 * tig;
      const bf16* qb_row = qkv + (row0 + rb) * ld + head_off + 4 * tig;
      float va[kD / 16][4], vb[kD / 16][4];
      float ma = 0.f, mb = 0.f;
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) {
        const bool in = 16 * c + 4 * tig < d;
        load4(qa_row + 16 * c, live && ra < N && in, va[c]);
        load4(qb_row + 16 * c, live && rb < N && in, vb[c]);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          ma = fmaxf(ma, fabsf(va[c][t]));
          mb = fmaxf(mb, fabsf(vb[c][t]));
        }
      }
      float sqa = s_q, sqb = s_q;
      if constexpr (!kStatic) {
#pragma unroll
        for (int w = 1; w <= 2; w <<= 1) {
          ma = fmaxf(ma, __shfl_xor_sync(fullmask, ma, w));
          mb = fmaxf(mb, __shfl_xor_sync(fullmask, mb, w));
        }
        sqa = ma > 0.f ? ma * kInv127 : 1.0f;
        sqb = mb > 0.f ? mb * kInv127 : 1.0f;
      }
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) {
        const bool in = 16 * c + 4 * tig < d;
        int ca[4], cb[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          ca[t] = lane_code(va[c][t], in, !kStatic, sqa, inv_q);
          cb[t] = lane_code(vb[c][t], in, !kStatic, sqb, inv_q);
        }
        qa[c >> 1][(c & 1) * 2] = pack_s8(ca[0], ca[1], ca[2], ca[3]);
        qa[c >> 1][(c & 1) * 2 + 1] = pack_s8(cb[0], cb[1], cb[2], cb[3]);
      }
      cqa = kStatic ? c_static : __fmul_rn(sqa, scale);
      cqb = kStatic ? c_static : __fmul_rn(sqb, scale);
    }
    float mxa = -INFINITY, mxb = -INFINITY;  // the thread's, then the quad's
    int suma = 0, sumb = 0;                  // this thread's part of Σpq
    float inva = 0.f, invb = 0.f;
#pragma unroll
    for (int i = 0; i < kOW / 2; ++i) o[i] = 0;

    // Σpq over the quad, once, and its reciprocals
    auto sums = [&]() {
#pragma unroll
      for (int w = 1; w <= 2; w <<= 1) {
        suma += __shfl_xor_sync(fullmask, suma, w);
        sumb += __shfl_xor_sync(fullmask, sumb, w);
      }
      inva = suma > 0 ? 1.0f / static_cast<float>(suma) : 0.f;
      invb = sumb > 0 ? 1.0f / static_cast<float>(sumb) : 0.f;
    };
    // out = bf16((O · 1/Σpq) · s_v): part `part`'s lanes of the head,
    // those below d
    auto store = [&](int part) {
#pragma unroll
      for (int dt = 0; dt < kOW / 8; ++dt) {
        const int lane0 = part * kOW + dt * 8;
        const int col = lane0 + 2 * tig;
        const bool real = live && lane0 < d;
        float v0 = s_v, v1 = s_v;
        if constexpr (!kStatic) {
          if (live) {
            const float2 sv =
                *reinterpret_cast<const float2*>(vs + bh * kD + col);
            v0 = sv.x;
            v1 = sv.y;
          }
        }
        if (real && ra < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (row0 + ra) * C +
                                             head_off + col) =
              __floats2bfloat162_rn(
                  __fmul_rn(__fmul_rn(static_cast<float>(o[4 * dt]), inva),
                            v0),
                  __fmul_rn(__fmul_rn(static_cast<float>(o[4 * dt + 1]),
                                      inva),
                            v1));
        if (real && rb < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (row0 + rb) * C +
                                             head_off + col) =
              __floats2bfloat162_rn(
                  __fmul_rn(__fmul_rn(static_cast<float>(o[4 * dt + 2]),
                                      invb),
                            v0),
                  __fmul_rn(__fmul_rn(static_cast<float>(o[4 * dt + 3]),
                                      invb),
                            v1));
      }
    };

    for (int s = 0; s < steps; ++s, ++it) {
      if (warp == 0) {
        produce(it + 1);
        __syncwarp();
      }
      const int st = it % kStages;
      mbar_wait(&full[st], (it / kStages) & 1);
      const unsigned char* stage = smem + st * kStage;
      const unsigned char* kt = stage + si * kTile;
      const int j0 = (s % kblocks) * kAttnLongKeys;

      // S = qi·kiᵀ over the block's 64 keys, 32 lanes a k step, each from
      // its own 32-byte box
      int sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0;
      // every register a wgmma reads is written before its fence: the
      // compiler may not sink those writes past it
      fence_acc(sc);
#pragma unroll
      for (int kk = 0; kk < kD / 32; ++kk) fence_acc(qa[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 32; ++kk)
        wgmma_s8_m64n64k32_rs(sc, qa[kk],
                              wgmma_desc_sw<32>(kt + kk * kKBox));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      // and read after its wait: q's fragments stay live to the next step
#pragma unroll
      for (int kk = 0; kk < kD / 32; ++kk) fence_acc(qa[kk]);

      // the logits, dequantized in the JAX order, + bias; keys past N
      // masked where the block reaches them (a row past N keeps finite
      // logits; never stored). The bias pair of key tile t: row la at
      // ba[off(t)], row lb lbo floats on
      const float* skp = reinterpret_cast<const float*>(
          stage + kScaleOff + si * kScaleBytes);
      const float* ba;
      int lbo;
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
      auto dq = [&](int acc, float c, float kk) {
        const float a = static_cast<float>(acc);
        return kStatic ? __fmul_rn(a, c) : __fmul_rn(__fmul_rn(a, c), kk);
      };
      float l[32];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int jl = t * 8 + 2 * tig;
        float k0 = 1.f, k1 = 1.f;
        if constexpr (!kStatic) {
          const float2 kv = *reinterpret_cast<const float2*>(skp + jl);
          k0 = kv.x;
          k1 = kv.y;
        }
        const float2 pa = pair(ba + off(t)), pb = pair(ba + off(t) + lbo);
        l[4 * t] = __fadd_rn(dq(sc[4 * t], cqa, k0), pa.x);
        l[4 * t + 1] = __fadd_rn(dq(sc[4 * t + 1], cqa, k1), pa.y);
        l[4 * t + 2] = __fadd_rn(dq(sc[4 * t + 2], cqb, k0), pb.x);
        l[4 * t + 3] = __fadd_rn(dq(sc[4 * t + 3], cqb, k1), pb.y);
      }
      if (j0 + kAttnLongKeys > N) {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int j = j0 + t * 8 + 2 * tig;
          if (ra < N) {
            if (j >= N) l[4 * t] = -INFINITY;
            if (j + 1 >= N) l[4 * t + 1] = -INFINITY;
          }
          if (rb < N) {
            if (j >= N) l[4 * t + 2] = -INFINITY;
            if (j + 1 >= N) l[4 * t + 3] = -INFINITY;
          }
        }
      }

      if (s < kblocks) {
        // pass 1: the row max (exact, in any order)
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          mxa = fmaxf(mxa, fmaxf(l[4 * t], l[4 * t + 1]));
          mxb = fmaxf(mxb, fmaxf(l[4 * t + 2], l[4 * t + 3]));
        }
      } else {
        if (s == kblocks) {  // the max over the quad, once
#pragma unroll
          for (int w = 1; w <= 2; w <<= 1) {
            mxa = fmaxf(mxa, __shfl_xor_sync(fullmask, mxa, w));
            mxb = fmaxf(mxb, __shfl_xor_sync(fullmask, mxb, w));
          }
        }
        if constexpr (kParts > 1) {
          if (s > kblocks && s % kblocks == 0) {  // the next part's first
            if (s == 2 * kblocks) sums();
            store(s / kblocks - 2);
#pragma unroll
            for (int i = 0; i < kOW / 2; ++i) o[i] = 0;
          }
        }
        // Σpq in the first part only (the later parts' codes are the same)
        const bool count = kParts == 1 || s < 2 * kblocks;
        // pass 2: pq in the A fragments of the block's two k steps (the
        // slot map) and its exact sum, then O += pq·vi
        uint32_t p[2][4];
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2) {
          int ca[4][2], cb[4][2];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int t = 4 * k2 + u;
            ca[u][0] = prob_code(l[4 * t], mxa);
            ca[u][1] = prob_code(l[4 * t + 1], mxa);
            cb[u][0] = prob_code(l[4 * t + 2], mxb);
            cb[u][1] = prob_code(l[4 * t + 3], mxb);
            if (count) {
              suma += ca[u][0] + ca[u][1];
              sumb += cb[u][0] + cb[u][1];
            }
          }
          p[k2][0] = pack_s8(ca[0][0], ca[0][1], ca[1][0], ca[1][1]);
          p[k2][1] = pack_s8(cb[0][0], cb[0][1], cb[1][0], cb[1][1]);
          p[k2][2] = pack_s8(ca[2][0], ca[2][1], ca[3][0], ca[3][1]);
          p[k2][3] = pack_s8(cb[2][0], cb[2][1], cb[3][0], cb[3][1]);
        }
        const unsigned char* vt = stage + kSamples * kTile + si * kVT;
        fence_acc(o);
        fence_acc(p[0]);
        fence_acc(p[1]);
        wgmma_fence();
        q8_long_pv<kOW>(o, p[0], vt, 0);
        q8_long_pv<kOW>(o, p[1], vt, 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(o);
        fence_acc(p[0]);
        fence_acc(p[1]);
      }
      mbar_arrive(&empty[st]);  // this thread is done with the stage
    }
    if constexpr (kParts == 1) sums();
    store(kParts - 1);
  }
}

// ------------------------------------------- K4a, long route, wide form
//
// Heads wider than 256 (core_width kWideCore, d % 8 == 0 up to 8192): the
// int8 long route in the bf16 wide form's schedule (block_common.cuh
// attention_wide_kernel), two launches as at the narrower widths:
//  * the pre-pass (attention_q8_prepass_wide_kernel), one CTA a (sample,
//    head), writes the scratch at the wide width Dw = 128·ceil(d / 128)
//    (lanes past d code 0, v's scale 1): k's codes and row scales, v's
//    column scales and v's codes transposed in the slot order, as at the
//    narrower widths, and here q's codes and row scales too: a row's
//    dynamic scale is over all its d lanes, which the core no longer holds
//    at once. A warp takes a q or k row (its abs-max over the row, then its
//    codes from a second read, L1/L2); a thread an octet of v's lanes over
//    every key (or every parts-th, where the octets are fewer than the
//    CTA's threads), four loads in flight; vᵀ a 64-key block and 128 lanes
//    at a time through shared memory;
//  * the core (attention_q8_wide_kernel): S = Σ_c qi_c·ki_cᵀ by wgmma
//    m64n64k32 s8 over 128-lane chunks (s32 sums, exact in any order), the
//    chunk's q codes from the scratch into the A fragments a step ahead,
//    k's chunk (four 32-byte boxes of 64 keys, 8 KB; at a block's last
//    chunk its 64 row scales and the bias) or vᵀ's part of a block (128
//    rows of 64 slots) one slot of a six-slot ring a step, filled by a
//    producer warpgroup of its own, each step's wgmma group waited on at
//    the next, as the bf16 wide form's; pass 1 the exact row max; pass 2
//    the s32 logits once a key block, pq's codes and their exact sum Σpq
//    from them, the codes written once (the thread's 8 A-fragment
//    registers of the block, 32 bytes) into the CTA's slot of the
//    scratch; then O += pq·vi over the blocks once for each 128-lane part
//    of O, each thread reading back its codes a step ahead. The logits, codes and output are the short core's arithmetic
//    (q8_logits' order, prob_code, __fmul_rn), so the output equals
//    attention_q8_ref's bit for bit.
// Scratch (attention_q8_long_scratch at d > 256): k, vᵀ and q codes
// (3·B·H·Np·Dw bytes), k's row scales (B·H·Np f32), v's column scales
// (B·H·Dw f32), q's row scales (B·H·Np f32), then the core's slots, one
// for each CTA of its persistent grid, 128 x Np bytes each.

__host__ __device__ constexpr int q8_wide_width(int d) {
  return wide_chunks(d) * kWideLanes;
}

struct Q8WideScratch {
  signed char* kc;
  signed char* vt;
  signed char* qc;
  float* ks;
  float* vs;
  float* qs;
  uint4* pc;  // the core's slots (16-byte aligned: Np % 64, Dw % 128 == 0)
};

inline Q8WideScratch q8_wide_scratch(void* base, int B, int N, int H,
                                     int d) {
  const long long np = q8_long_np(N), dw = q8_wide_width(d);
  const long long bh = static_cast<long long>(B) * H;
  Q8WideScratch s;
  s.kc = static_cast<signed char*>(base);
  s.vt = s.kc + bh * np * dw;
  s.qc = s.vt + bh * np * dw;
  s.ks = reinterpret_cast<float*>(s.qc + bh * np * dw);
  s.vs = s.ks + bh * np;
  s.qs = s.vs + bh * dw;
  s.pc = reinterpret_cast<uint4*>(s.qs + bh * np);
  return s;
}

// Bytes of the long route's scratch at head width d (the wrapper's
// attention_q8_long_scratch): the pre-pass's operands (q8_long_scratch's
// at the core width, q8_wide_scratch's on the wide form), and with `slots`
// the wide core's slots after them. The launches refuse a smaller one.
inline long long q8_scratch_bytes(int B, int N, int H, int d, bool slots) {
  const long long np = q8_long_np(N), bh = static_cast<long long>(B) * H;
  if (core_width(d) != kWideCore) {
    const long long w = core_width(d);
    return bh * (2 * np * w + 4 * np + 4 * w);
  }
  const long long dw = q8_wide_width(d);
  return bh * (3 * np * dw + 8 * np + 4 * dw) +
         (slots ? wide_slot_bytes(B, N, H, kAttnLongQueries * kAttnLongKeys)
                : 0);
}

// The wide pre-pass (see above) of (sample, head) blockIdx.x = b·H + h.
template <bool kStatic>
__global__ void __launch_bounds__(kQ8PrepassThreads)
attention_q8_prepass_wide_kernel(const bf16* __restrict__ qkv,
                                 const float* __restrict__ s_qkv,
                                 Q8WideScratch sc, int N, int C, int H) {
  __shared__ float red[kQ8PrepassThreads * 8];
  __shared__ __align__(16) signed char vtile[kWideLanes * kAttnLongKeys];
  const long long bh = blockIdx.x;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  const long long ld = 3LL * C;
  const long long np = q8_long_np(N);
  const long long row0 = static_cast<long long>(b) * N;
  const int d = C / H;
  const int dw = q8_wide_width(d);
  const int oct = dw / 8;  // 16-byte pieces (8 lanes) of a scratch row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float inv_q = 0.f, inv_k = 0.f, inv_v = 0.f;  // with static scales
  if constexpr (kStatic) {
    inv_q = 1.0f / s_qkv[0];
    inv_k = 1.0f / s_qkv[1];
    inv_v = 1.0f / s_qkv[2];
  }

  // q's and k's codes: a warp a row (rows past N: code 0, scale 1)
  for (int which = 0; which < 2; ++which) {
    const bf16* base = qkv + (which == 0 ? 0 : C) + h * d;
    signed char* codes = which == 0 ? sc.qc : sc.kc;
    float* scales = which == 0 ? sc.qs : sc.ks;
    const float inv = which == 0 ? inv_q : inv_k;
    for (long long j = warp; j < np; j += kQ8PrepassThreads / 32) {
      const bf16* src = base + (row0 + j) * ld;
      const bool in = j < N;
      float s = 1.0f;
      if constexpr (!kStatic) {
        float amax = 0.f;
        if (in) {
          for (int o = lane; o * 8 < d; o += 32) {
            float v[8];
            load8(src + o * 8, v);
#pragma unroll
            for (int t = 0; t < 8; ++t) amax = fmaxf(amax, fabsf(v[t]));
          }
        }
        amax = warp_max(amax);
        s = amax > 0.f ? amax * kInv127 : 1.0f;
        if (lane == 0) scales[bh * np + j] = s;
      }
      signed char* dst = codes + (bh * np + j) * dw;
      for (int o = lane; o < oct; o += 32) {
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        const bool live = o * 8 < d;
        if (in && live) load8(src + o * 8, v);
        store_codes8(v, !kStatic, s, inv, dst + o * 8, live);
      }
    }
  }

  // v's column scales over the N keys: thread t an octet t mod oct, over
  // every parts-th key from t / oct (parts = 256 / oct where the octets
  // are fewer than the threads; else each thread every 256th octet over
  // every key), four keys' loads in flight; the parts' maxima meet in
  // `red`
  const bf16* vb = qkv + 2 * C + h * d;
  if constexpr (!kStatic) {
    const int parts = oct >= kQ8PrepassThreads ? 1 : kQ8PrepassThreads / oct;
    const int part = oct >= kQ8PrepassThreads ? 0 : threadIdx.x / oct;
    const int o0 = oct >= kQ8PrepassThreads ? threadIdx.x : threadIdx.x % oct;
    for (int o = o0; o < oct && part < parts; o += kQ8PrepassThreads) {
      float m[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (o * 8 < d) {
        for (int j0 = part; j0 < N; j0 += 4 * parts) {
          float v[4][8];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = j0 + u * parts;
#pragma unroll
            for (int t = 0; t < 8; ++t) v[u][t] = 0.f;
            if (j < N) load8(vb + (row0 + j) * ld + o * 8, v[u]);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int t = 0; t < 8; ++t) m[t] = fmaxf(m[t], fabsf(v[u][t]));
        }
      }
      if (parts == 1) {
#pragma unroll
        for (int t = 0; t < 8; ++t)
          sc.vs[bh * dw + o * 8 + t] = m[t] > 0.f ? m[t] * kInv127 : 1.0f;
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) red[part * dw + o * 8 + t] = m[t];
      }
    }
    __syncthreads();
    if (parts > 1) {
      for (int dd = threadIdx.x; dd < dw; dd += kQ8PrepassThreads) {
        float a = red[dd];
        for (int p = 1; p < parts; ++p) a = fmaxf(a, red[p * dw + dd]);
        sc.vs[bh * dw + dd] = a > 0.f ? a * kInv127 : 1.0f;
      }
    }
    __syncthreads();  // the scales, in device memory, for the codes below
  }

  // v codes, transposed: 128 lanes of a 64-key block into vtile (128 rows
  // of 64 slots), then the rows out in 16-byte pieces
  signed char* vt = sc.vt + bh * dw * np;
  for (long long j0 = 0; j0 < np; j0 += kAttnLongKeys) {
    for (int c0 = 0; c0 < dw; c0 += kWideLanes) {
      for (int idx = threadIdx.x; idx < kAttnLongKeys * kWideLanes / 8;
           idx += kQ8PrepassThreads) {
        const int jl = idx / (kWideLanes / 8), o = idx % (kWideLanes / 8);
        const int lane0 = c0 + o * 8;
        const bool live = lane0 < d;
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (j0 + jl < N && live) load8(vb + (row0 + j0 + jl) * ld + lane0, v);
        const int slot = q8_slot(jl);
#pragma unroll
        for (int t = 0; t < 8; ++t)
          vtile[(o * 8 + t) * kAttnLongKeys + slot] =
              static_cast<signed char>(lane_code(
                  v[t], live, !kStatic,
                  kStatic ? 1.f : sc.vs[bh * dw + lane0 + t], inv_v));
      }
      __syncthreads();
      for (int i = threadIdx.x; i < kWideLanes * kAttnLongKeys / 16;
           i += kQ8PrepassThreads) {
        const int dd = i / (kAttnLongKeys / 16), cc = i % (kAttnLongKeys / 16);
        *reinterpret_cast<uint4*>(vt + (c0 + dd) * np + j0 + cc * 16) =
            *reinterpret_cast<const uint4*>(vtile + dd * kAttnLongKeys +
                                            cc * 16);
      }
      __syncthreads();
    }
  }
}

// The wide core's shared memory from its 1024-aligned start: the ring of
// kWideSlots slots (a slot: a 64-key block's 128-lane chunk of k codes and
// k's 64 row scales, or vᵀ's 128-row part of the block; on 1 KB, 9,216 B),
// the bias region (176,016 B: kWideAreas tile or row areas, or a slab up
// to N 343), the barriers.
constexpr int kQ8WideTile = kAttnLongKeys * kWideLanes;  // 8 KB of codes
constexpr int kQ8WideSlot =
    (kQ8WideTile + kAttnLongKeys * 4 + 1023) / 1024 * 1024;
__host__ __device__ constexpr int q8_wide_region_bytes() {
  return kAttnLongSmem - 1024 - kWideSlots * kQ8WideSlot - wide_bar_bytes();
}

// The wide core (see above). map_k reads k codes as (Dw bytes, B·H·Np
// rows) in boxes of 32 bytes x 64 rows, map_v vᵀ codes as (Np bytes,
// B·H·Dw rows) in boxes of 64 bytes x 128 rows; q's codes, the scales and
// the slots are the scratch `sc`'s; the bias and the output as
// attention_q8_long_kernel's; the grid as attention_wide_kernel's
// (persistent, one sample at a time).
template <bool kStatic, bool kTiles>
__global__ void __launch_bounds__(kWideCtaThreads, 1)
attention_q8_wide_kernel(const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_b,
                         Q8WideScratch sc, const float* __restrict__ bias,
                         const float* __restrict__ s_qkv,
                         bf16* __restrict__ out, int B, int N, int C, int d,
                         bool slab, float scale) {
  constexpr int kScaleOff = kQ8WideTile;  // k's row scales in a k slot
  constexpr int kScaleBytes = kAttnLongKeys * 4;
  constexpr int kKBox = kAttnLongKeys * 32;  // a 32-lane box of k codes
  constexpr int kArea = kAttnLongBiasBytes / 4;  // a bias area, floats
  extern __shared__ unsigned char q8_wide_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(q8_wide_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  float* region = reinterpret_cast<float*>(smem + kWideSlots * kQ8WideSlot);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + kWideSlots * kQ8WideSlot + q8_wide_region_bytes());
  uint64_t* empty = full + kWideSlots;
  uint64_t* slab_full = empty + kWideSlots;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kAttnLongQueries;
  const int h = blockIdx.z;
  const int H = gridDim.z;
  const int head_off = h * d;
  const long long np = q8_long_np(N);
  const int dw = q8_wide_width(d);
  const float* bias_h = bias + static_cast<long long>(h) * N * N;
  const float* bias_end = bias + static_cast<long long>(H) * N * N;
  const bool rows_form = !kTiles && !slab;
  const int kblocks = (N + kAttnLongKeys - 1) / kAttnLongKeys;
  const int nc = dw / kWideLanes;       // chunks of S, parts of P·V
  const int pass_steps = kblocks * nc;  // a pass over the blocks' chunks
  const int steps = 3 * pass_steps;     // a sample's: pass 1, S, P·V
  const int slab_shift = bias_shift(bias_h + static_cast<long long>(q0) * N);
  const float* slab_src = bias_h + static_cast<long long>(q0) * N - slab_shift;
  // the CTA's slot: thread t's 16-byte piece i of block kb's codes at
  // (kb·2 + i)·256 + t
  uint4* slot =
      sc.pc + (static_cast<long long>(blockIdx.z * gridDim.y + blockIdx.y) *
                   gridDim.x +
               blockIdx.x) *
                  kblocks * 512;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWideSlots; ++s) {
      mbar_init(&full[s], rows_form ? 1 + 32 : 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(slab_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the bias area of a block end, as attention_wide_kernel's
  auto area = [&](int g, int pass, int kb) {
    return region +
           ((g / steps) * 2 * kblocks + pass * kblocks + kb) % kWideAreas *
               kArea;
  };

  // The producer warp's loads for global step g (as
  // attention_wide_kernel's): k's chunk, at a block's last chunk with k's
  // scales and the bias; or vᵀ's part.
  auto produce = [&](int g) {
    const int b = blockIdx.y + (g / steps) * gridDim.y;
    if (b >= B) return;
    const int s = g % steps;
    const int st = g % kWideSlots;
    if (g >= kWideSlots) mbar_wait(&empty[st], ((g / kWideSlots) & 1) ^ 1);
    unsigned char* kv = smem + st * kQ8WideSlot;
    const int pass = s / pass_steps;
    const int r = s % pass_steps;
    const long long bh = static_cast<long long>(b) * H + h;
    if (pass == 2) {  // vᵀ's part r / kblocks of block r mod kblocks
      if (lane == 0) {
        mbar_expect_tx(&full[st], kQ8WideTile);
        tma_load_2d(kv, &map_v, &full[st], (r % kblocks) * kAttnLongKeys,
                    static_cast<int>(bh * dw + (r / kblocks) * kWideLanes));
      }
      if (rows_form) mbar_expect_tx(&full[st], 0);
      return;
    }
    const int c = r % nc;
    const int kb = r / nc;
    const int j0 = kb * kAttnLongKeys;
    const bool last = c == nc - 1;
    float* bt = area(g, pass, kb);
    if (lane == 0) {
      mbar_expect_tx(&full[st],
                     kQ8WideTile + (!kStatic && last ? kScaleBytes : 0) +
                         (kTiles && last ? 2 * kAttnLongQueries * 128 : 0));
#pragma unroll
      for (int x = 0; x < kWideLanes / 32; ++x)
        tma_load_2d(kv + x * kKBox, &map_k, &full[st],
                    c * kWideLanes + 32 * x, static_cast<int>(bh * np + j0));
      if (!kStatic && last)
        bulk_load(kv + kScaleOff, sc.ks + bh * np + j0, kScaleBytes,
                  &full[st]);
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

  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int la = wg * 64 + wq * 16 + g;
  const int lb = la + 8;
  const int ra = q0 + la;
  const int rb = q0 + lb;
  const bool even = (N & 1) == 0;
  const unsigned fullmask = 0xffffffffu;
  const int lin_a = long_bias_lin(slab, slab_shift, bias_h, la, ra, N, tig);
  const int lin_b = long_bias_lin(slab, slab_shift, bias_h, lb, rb, N, tig);
  int toff[4];
  long_tile_offsets(toff, la, tig);
  if (slab) mbar_wait(slab_full, 0);

  float s_v = 0.f, c_static = 0.f;
  if constexpr (kStatic) {
    s_v = s_qkv[2];
    c_static = __fmul_rn(__fmul_rn(s_qkv[0], s_qkv[1]), scale);
  }

  int o[kWideLanes / 2];  // a part's O, wgmma's layout
  int sci[32];            // a key block's s32 sums over its chunks
  // q's codes of the even and the odd S steps and of the next step; pq's
  // A fragments of the even and the odd P·V steps and of the next step
  uint32_t qe[kWideLanes / 32][4], qo[kWideLanes / 32][4],
      qn[kWideLanes / 32][4];
  uint32_t pe[2][4], po[2][4], pn[2][4];
  int it = 0;  // the global step
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const long long row0 = static_cast<long long>(b) * N;
    const long long bh = static_cast<long long>(b) * H + h;
    // q's dequantizing factors of the thread's rows (s_q·d^-½, as the
    // short core's), and its rows of codes in the scratch
    // (rows past N read row 0's and drop it, without a branch)
    const int ia = ra < N ? ra : 0, ib = rb < N ? rb : 0;
    const float qsa = kStatic ? 1.0f : sc.qs[bh * np + ia];
    const float qsb = kStatic ? 1.0f : sc.qs[bh * np + ib];
    const float cqa =
        kStatic ? c_static : __fmul_rn(ra < N ? qsa : 1.0f, scale);
    const float cqb =
        kStatic ? c_static : __fmul_rn(rb < N ? qsb : 1.0f, scale);
    const signed char* qra = sc.qc + (bh * np + ia) * dw;
    const signed char* qrb = sc.qc + (bh * np + ib) * dw;
    // q's codes of chunk c into qn, the mma.sync m16n8k32 A layout of each
    // k step: lanes 32kk + 4·tig..+3 and + 16 of rows ra, rb (0 past N;
    // read from row 0 there and dropped, without a branch)
    auto load_q = [&](int c) {
#pragma unroll
      for (int kk = 0; kk < kWideLanes / 32; ++kk) {
        const int l0 = c * kWideLanes + kk * 32 + 4 * tig;
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qra + l0);
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(qrb + l0);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(qra + l0 + 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(qrb + l0 + 16);
        qn[kk][0] = ra < N ? a0 : 0u;
        qn[kk][1] = rb < N ? b0 : 0u;
        qn[kk][2] = ra < N ? a1 : 0u;
        qn[kk][3] = rb < N ? b1 : 0u;
      }
    };
    // pq's codes of block kb into pn, from the slot
    auto load_p = [&](int kb) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint4 v = slot[(kb * 2 + i) * 256 + threadIdx.x];
        pn[i][0] = v.x;
        pn[i][1] = v.y;
        pn[i][2] = v.z;
        pn[i][3] = v.w;
      }
    };
    load_q(0);
    float mxa = -INFINITY, mxb = -INFINITY;  // the thread's, then the quad's
    int suma = 0, sumb = 0;                  // this thread's part of Σpq
    float inva = 0.f, invb = 0.f;

    // out = bf16((O · 1/Σpq) · s_v): part `part`'s lanes below d
    auto store = [&](int part) {
#pragma unroll
      for (int dt = 0; dt < kWideLanes / 8; ++dt) {
        const int lane0 = part * kWideLanes + dt * 8;
        const int col = lane0 + 2 * tig;
        const bool real = lane0 < d;
        float v0 = s_v, v1 = s_v;
        if constexpr (!kStatic) {
          const float2 sv =
              *reinterpret_cast<const float2*>(sc.vs + bh * dw + col);
          v0 = sv.x;
          v1 = sv.y;
        }
        if (real && ra < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (row0 + ra) * C +
                                             head_off + col) =
              __floats2bfloat162_rn(
                  __fmul_rn(__fmul_rn(static_cast<float>(o[4 * dt]), inva),
                            v0),
                  __fmul_rn(__fmul_rn(static_cast<float>(o[4 * dt + 1]),
                                      inva),
                            v1));
        if (real && rb < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (row0 + rb) * C +
                                             head_off + col) =
              __floats2bfloat162_rn(
                  __fmul_rn(__fmul_rn(static_cast<float>(o[4 * dt + 2]),
                                      invb),
                            v0),
                  __fmul_rn(__fmul_rn(static_cast<float>(o[4 * dt + 3]),
                                      invb),
                            v1));
      }
    };

    // S step t of the sample's 2·pass_steps (pass 1, then pass 2's S), as
    // attention_wide_kernel's: q's codes in qf (from qn), the last step's
    // in qp
    auto s_step = [&](int t, uint32_t(&qf)[kWideLanes / 32][4],
                      uint32_t(&qp)[kWideLanes / 32][4]) {
      const int pass = t / pass_steps;
      const int r = t % pass_steps;
      const int c = r % nc;
      const int kb = r / nc;
      const int j0 = kb * kAttnLongKeys;
#pragma unroll
      for (int kk = 0; kk < kWideLanes / 32; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) qf[kk][i] = qn[kk][i];
      if (t + 1 < 2 * pass_steps) load_q((t + 1) % nc);
      const int st = it % kWideSlots;
      mbar_wait(&full[st], (it / kWideSlots) & 1);
      const unsigned char* stage = smem + st * kQ8WideSlot;

      // S += qi_c·ki_cᵀ, 32 lanes a k step, each from its own 32-byte box
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sci[i] = 0;
        fence_acc(sci);
      }
#pragma unroll
      for (int kk = 0; kk < kWideLanes / 32; ++kk) fence_acc(qf[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWideLanes / 32; ++kk)
        wgmma_s8_m64n64k32_rs(sci, qf[kk],
                              wgmma_desc_sw<32>(stage + kk * kKBox));
      wgmma_commit();
      // the last step's group has completed: within a block (c > 0) its
      // slot is released here (a block's last step releases its own)
      if (c < nc - 1) {
        wgmma_wait<1>();
#pragma unroll
        for (int kk = 0; kk < kWideLanes / 32; ++kk) fence_acc(qp[kk]);
        if (c > 0) mbar_arrive(&empty[(it - 1) % kWideSlots]);
        ++it;
        return;
      }
      wgmma_wait<0>();
      fence_acc(sci);
#pragma unroll
      for (int kk = 0; kk < kWideLanes / 32; ++kk) {
        fence_acc(qf[kk]);
        fence_acc(qp[kk]);
      }
      if (c > 0) mbar_arrive(&empty[(it - 1) % kWideSlots]);

      // the logits, dequantized in the JAX order, + bias; keys past N
      // masked where the block reaches them
      const float* skp = reinterpret_cast<const float*>(stage + kScaleOff);
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
      auto dq = [&](int acc, float cq, float kk) {
        const float a = static_cast<float>(acc);
        return kStatic ? __fmul_rn(a, cq) : __fmul_rn(__fmul_rn(a, cq), kk);
      };
      float l[32];
#pragma unroll
      for (int t4 = 0; t4 < 8; ++t4) {
        const int jl = t4 * 8 + 2 * tig;
        float k0 = 1.f, k1 = 1.f;
        if constexpr (!kStatic) {
          const float2 kv = *reinterpret_cast<const float2*>(skp + jl);
          k0 = kv.x;
          k1 = kv.y;
        }
        const float2 pa = pair(ba + off(t4)), pb = pair(ba + off(t4) + lbo);
        l[4 * t4] = __fadd_rn(dq(sci[4 * t4], cqa, k0), pa.x);
        l[4 * t4 + 1] = __fadd_rn(dq(sci[4 * t4 + 1], cqa, k1), pa.y);
        l[4 * t4 + 2] = __fadd_rn(dq(sci[4 * t4 + 2], cqb, k0), pb.x);
        l[4 * t4 + 3] = __fadd_rn(dq(sci[4 * t4 + 3], cqb, k1), pb.y);
      }
      if (j0 + kAttnLongKeys > N) {
#pragma unroll
        for (int t4 = 0; t4 < 8; ++t4) {
          const int j = j0 + t4 * 8 + 2 * tig;
          if (ra < N) {
            if (j >= N) l[4 * t4] = -INFINITY;
            if (j + 1 >= N) l[4 * t4 + 1] = -INFINITY;
          }
          if (rb < N) {
            if (j >= N) l[4 * t4 + 2] = -INFINITY;
            if (j + 1 >= N) l[4 * t4 + 3] = -INFINITY;
          }
        }
      }

      if (pass == 0) {
        // pass 1: the row max (exact, in any order)
#pragma unroll
        for (int t4 = 0; t4 < 8; ++t4) {
          mxa = fmaxf(mxa, fmaxf(l[4 * t4], l[4 * t4 + 1]));
          mxb = fmaxf(mxb, fmaxf(l[4 * t4 + 2], l[4 * t4 + 3]));
        }
      } else {
        if (kb == 0) {  // the max over the quad, once
#pragma unroll
          for (int w = 1; w <= 2; w <<= 1) {
            mxa = fmaxf(mxa, __shfl_xor_sync(fullmask, mxa, w));
            mxb = fmaxf(mxb, __shfl_xor_sync(fullmask, mxb, w));
          }
        }
        // pq in the A fragments of the block's two k steps (the slot
        // map), its exact sum, the codes into the slot
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2) {
          int ca[4][2], cb[4][2];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int t4 = 4 * k2 + u;
            ca[u][0] = prob_code(l[4 * t4], mxa);
            ca[u][1] = prob_code(l[4 * t4 + 1], mxa);
            cb[u][0] = prob_code(l[4 * t4 + 2], mxb);
            cb[u][1] = prob_code(l[4 * t4 + 3], mxb);
            suma += ca[u][0] + ca[u][1];
            sumb += cb[u][0] + cb[u][1];
          }
          slot[(kb * 2 + k2) * 256 + threadIdx.x] =
              make_uint4(pack_s8(ca[0][0], ca[0][1], ca[1][0], ca[1][1]),
                         pack_s8(cb[0][0], cb[0][1], cb[1][0], cb[1][1]),
                         pack_s8(ca[2][0], ca[2][1], ca[3][0], ca[3][1]),
                         pack_s8(cb[2][0], cb[2][1], cb[3][0], cb[3][1]));
        }
      }
      mbar_arrive(&empty[st]);  // this thread is done with the slot
      ++it;
    };

    // P·V step u of the sample's pass_steps: O += pq·vi_part over block kb
    // (part u / kblocks, kb = u mod kblocks), the codes in pf (from pn),
    // the last step's in pp
    auto pv_step = [&](int u, uint32_t(&pf)[2][4], uint32_t(&pp)[2][4]) {
      const int part = u / kblocks;
      const int kb = u % kblocks;
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
        for (int i = 0; i < 4; ++i) pf[k2][i] = pn[k2][i];
      if (u + 1 < pass_steps) load_p((u + 1) % kblocks);
      const int st = it % kWideSlots;
      mbar_wait(&full[st], (it / kWideSlots) & 1);
      const unsigned char* vt = smem + st * kQ8WideSlot;
      if (kb == 0) fence_acc(o);
      fence_acc(pf[0]);
      fence_acc(pf[1]);
      wgmma_fence();
      q8_long_pv<kWideLanes>(o, pf[0], vt, 0);
      q8_long_pv<kWideLanes>(o, pf[1], vt, 1);
      wgmma_commit();
      // the last step's slot, within a part (kb > 0), as in s_step
      if (kb < kblocks - 1) {
        wgmma_wait<1>();
        fence_acc(pp[0]);
        fence_acc(pp[1]);
        if (kb > 0) mbar_arrive(&empty[(it - 1) % kWideSlots]);
      } else {
        wgmma_wait<0>();
        fence_acc(o);
        fence_acc(pf[0]);
        fence_acc(pf[1]);
        fence_acc(pp[0]);
        fence_acc(pp[1]);
        if (kb > 0) mbar_arrive(&empty[(it - 1) % kWideSlots]);
        mbar_arrive(&empty[st]);
        store(part);
#pragma unroll
        for (int i = 0; i < kWideLanes / 2; ++i) o[i] = 0;
      }
      ++it;
    };

    for (int t = 0; t < 2 * pass_steps; t += 2) {
      s_step(t, qe, qo);
      s_step(t + 1, qo, qe);
    }
    // Σpq over the quad, once, before the first part's output
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      suma += __shfl_xor_sync(fullmask, suma, w);
      sumb += __shfl_xor_sync(fullmask, sumb, w);
    }
    inva = suma > 0 ? 1.0f / static_cast<float>(suma) : 0.f;
    invb = sumb > 0 ? 1.0f / static_cast<float>(sumb) : 0.f;
    load_p(0);
#pragma unroll
    for (int i = 0; i < kWideLanes / 2; ++i) o[i] = 0;
    for (int u = 0; u < pass_steps; u += 2) {
      pv_step(u, pe, po);
      if (u + 1 < pass_steps) pv_step(u + 1, po, pe);
    }
  }
}

template <bool kStatic>
inline cudaError_t attention_q8_prepass_wide_run(const bf16* qkv,
                                                 const float* s_qkv,
                                                 const Q8WideScratch& sc,
                                                 int B, int N, int C, int H,
                                                 cudaStream_t stream) {
  attention_q8_prepass_wide_kernel<kStatic>
      <<<static_cast<unsigned>(static_cast<long long>(B) * H),
         kQ8PrepassThreads, 0, stream>>>(qkv, s_qkv, sc, N, C, H);
  return cudaGetLastError();
}

template <bool kStatic, bool kTiles>
inline cudaError_t attention_q8_wide_launch(
    const CUtensorMap& map_k, const CUtensorMap& map_v,
    const CUtensorMap& map_b, const Q8WideScratch& sc, const float* bias,
    const float* s_qkv, bf16* out, int B, int N, int C, int H, int mode,
    float scale, cudaStream_t stream) {
  auto* kern = attention_q8_wide_kernel<kStatic, kTiles>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kAttnLongSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kAttnLongQueries - 1) / kAttnLongQueries,
                  wide_sample_groups(B, N, H), H);
  const int d = C / H;
  kern<<<grid, kWideCtaThreads, kAttnLongSmem, stream>>>(
      map_k, map_v, map_b, sc, bias, s_qkv, out, B, N, C, d,
      mode == kBiasSlab, scale);
  return cudaGetLastError();
}

// The wide form's route: the wide pre-pass into `scratch`, then the core.
template <bool kStatic>
inline cudaError_t attention_q8_wide_run(const bf16* qkv, const float* bias,
                                         const float* s_qkv, bf16* out, int B,
                                         int N, int C, int H, void* scratch,
                                         float scale, cudaStream_t stream) {
  const int d = C / H;
  const Q8WideScratch sc = q8_wide_scratch(scratch, B, N, H, d);
  cudaError_t e = attention_q8_prepass_wide_run<kStatic>(qkv, s_qkv, sc, B,
                                                         N, C, H, stream);
  if (e != cudaSuccess) return e;
  const long long np = q8_long_np(N), dw = q8_wide_width(d);
  const long long bh = static_cast<long long>(B) * H;
  CUtensorMap map_k, map_v, map_b;
  e = tensor_map(&map_k, sc.kc, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, bh * np, dw,
                 kAttnLongKeys, 32, CU_TENSOR_MAP_SWIZZLE_32B);
  if (e != cudaSuccess) return e;
  e = tensor_map(&map_v, sc.vt, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, bh * dw, np,
                 kWideLanes, kAttnLongKeys, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e != cudaSuccess) return e;
  const int mode = long_bias_mode(N, q8_wide_region_bytes());
  if (mode == kBiasTiles) {
    if ((e = attn_long_bias_map(&map_b, bias, N, H)) != cudaSuccess) return e;
    return attention_q8_wide_launch<kStatic, true>(
        map_k, map_v, map_b, sc, bias, s_qkv, out, B, N, C, H, mode, scale,
        stream);
  }
  return attention_q8_wide_launch<kStatic, false>(
      map_k, map_v, map_k, sc, bias, s_qkv, out, B, N, C, H, mode, scale,
      stream);
}

template <int kD, bool kStatic>
inline cudaError_t attention_q8_prepass_run(const bf16* qkv,
                                            const float* s_qkv,
                                            const Q8LongScratch& sc, int B,
                                            int N, int C, int H,
                                            cudaStream_t stream) {
  attention_q8_prepass_kernel<kD, kStatic>
      <<<static_cast<unsigned>(static_cast<long long>(B) * H),
         kQ8PrepassThreads, 0, stream>>>(qkv, s_qkv, sc, N, C, H);
  return cudaGetLastError();
}

template <int kD, bool kStatic, bool kTiles>
inline cudaError_t attention_q8_long_launch(
    const CUtensorMap& map_k, const CUtensorMap& map_v,
    const CUtensorMap& map_b, const bf16* qkv, const Q8LongScratch& sc,
    const float* bias, const float* s_qkv, bf16* out, int B, int N, int C,
    int H, int mode, float scale, cudaStream_t stream) {
  auto* kern = attention_q8_long_kernel<kD, kStatic, kTiles>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kAttnLongSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid(
      (N + kAttnLongQueries - 1) / kAttnLongQueries,
      long_sample_groups(B, N, H, attn_long_samples(kD), mode), H);
  const int d = C / H;
  kern<<<grid, attn_long_warps(kD) * 32, kAttnLongSmem, stream>>>(
      map_k, map_v, map_b, qkv, sc.ks, sc.vs, bias, s_qkv, out, B, N, C, d,
      mode == kBiasSlab, scale);
  return cudaGetLastError();
}

// The long route: the pre-pass into `scratch`, then the core.
template <int kD, bool kStatic>
inline cudaError_t attention_q8_long_run(const bf16* qkv, const float* bias,
                                         const float* s_qkv, bf16* out, int B,
                                         int N, int C, int H, void* scratch,
                                         float scale, cudaStream_t stream) {
  const Q8LongScratch sc = q8_long_scratch(scratch, B, N, H, kD);
  cudaError_t e =
      attention_q8_prepass_run<kD, kStatic>(qkv, s_qkv, sc, B, N, C, H,
                                            stream);
  if (e != cudaSuccess) return e;
  const long long np = q8_long_np(N);
  const long long bh = static_cast<long long>(B) * H;
  CUtensorMap map_k, map_v, map_b;
  e = tensor_map(&map_k, sc.kc, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, bh * np, kD,
                 kAttnLongKeys, 32, CU_TENSOR_MAP_SWIZZLE_32B);
  if (e != cudaSuccess) return e;
  e = tensor_map(&map_v, sc.vt, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, bh * kD, np,
                 kD / attn_long_parts(kD), kAttnLongKeys,
                 CU_TENSOR_MAP_SWIZZLE_64B);
  if (e != cudaSuccess) return e;
  const int mode = long_bias_mode(N, q8_long_region_bytes(kD));
  if (mode == kBiasTiles) {
    if ((e = attn_long_bias_map(&map_b, bias, N, H)) != cudaSuccess) return e;
    return attention_q8_long_launch<kD, kStatic, true>(
        map_k, map_v, map_b, qkv, sc, bias, s_qkv, out, B, N, C, H, mode,
        scale, stream);
  }
  return attention_q8_long_launch<kD, kStatic, false>(
      map_k, map_v, map_k, qkv, sc, bias, s_qkv, out, B, N, C, H, mode,
      scale, stream);
}

template <int kD>
inline cudaError_t attention_q8_long_width(const bf16* qkv, const float* bias,
                                           const float* s_qkv, bf16* out,
                                           int B, int N, int C, int H,
                                           void* scratch, float scale,
                                           cudaStream_t stream) {
  return s_qkv != nullptr
             ? attention_q8_long_run<kD, true>(qkv, bias, s_qkv, out, B, N, C,
                                               H, scratch, scale, stream)
             : attention_q8_long_run<kD, false>(qkv, bias, nullptr, out, B, N,
                                                C, H, scratch, scale, stream);
}

// K4a over a packed (B·N, 3C) qkv; s_qkv null for dynamic scales. The head
// width d is C / H (head_dim_ok), run on the instance of width
// core_width(d). `plan` is the wrapper's `attention_q8_plan` at that
// width: the 32-key step bucket, the warps of a CTA (even, at most 8), the
// samples of a CTA and the shared bytes (at the instance's width), or
// the long route's plan (block_common.cuh attn_long_plan_ok, with the bf16
// route's CTA), which runs the pre-pass into `scratch` (not null, 16-byte
// aligned, `scratch_bytes` at least q8_scratch_bytes's) and
// attention_q8_long_kernel; a width, plan or scratch the kernels do not
// take is refused with cudaErrorInvalidValue.
cudaError_t attention_q8(const bf16* qkv, const float* bias,
                         const float* s_qkv, bf16* out, int B, int N, int C,
                         int H, int d_scale, const int* plan, void* scratch,
                         long long scratch_bytes, cudaStream_t stream) {
  const int kt = plan[0], warps = plan[1], samples = plan[2], smem = plan[3];
  const int d = H > 0 && C % H == 0 ? C / H : 0;
  const int w = core_width(d);
  if (!scale_width_ok(d_scale, d)) return cudaErrorInvalidValue;
  // d^-1/2 in float32, as the JAX package's f32 logits take a Python
  // float, at the head's true width (d, or d_scale on a padded layout)
  const float scale =
      static_cast<float>(1.0 / sqrt(static_cast<double>(d_scale)));
  if (kt == kAttnLongRoute) {
    if (!head_dim_ok(d) ||
        !attn_long_plan_ok(plan, B, N, H, d, attn_long_warps(w),
                           attn_long_samples(w), kAttnLongSmem) ||
        scratch == nullptr ||
        ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(bias) |
          reinterpret_cast<uintptr_t>(scratch)) &
         15) != 0 ||
        scratch_bytes < q8_scratch_bytes(B, N, H, d, true))
      return cudaErrorInvalidValue;
    switch (w) {
      case 32:
        return attention_q8_long_width<32>(qkv, bias, s_qkv, out, B, N, C, H,
                                           scratch, scale, stream);
      case 64:
        return attention_q8_long_width<64>(qkv, bias, s_qkv, out, B, N, C, H,
                                           scratch, scale, stream);
      case 128:
        return attention_q8_long_width<128>(qkv, bias, s_qkv, out, B, N, C,
                                            H, scratch, scale, stream);
      case 256:
        return attention_q8_long_width<256>(qkv, bias, s_qkv, out, B, N, C,
                                            H, scratch, scale, stream);
      case kWideCore:
        return s_qkv != nullptr
                   ? attention_q8_wide_run<true>(qkv, bias, s_qkv, out, B, N,
                                                 C, H, scratch, scale, stream)
                   : attention_q8_wide_run<false>(qkv, bias, nullptr, out, B,
                                                  N, C, H, scratch, scale,
                                                  stream);
      default:
        return cudaErrorInvalidValue;
    }
  }
  // the short core: widths up to kShortMaxWidth (wider heads take the long
  // route at every N)
  if (!head_dim_ok(d) || w > kShortMaxWidth || N < 1 || N > 256 ||
      kt * 32 < N || warps < 2 || warps % 2 || warps > kAttnQ8MaxWarps ||
      samples < 1 || smem != attn_q8_layout(N, w).bytes)
    return cudaErrorInvalidValue;
  switch (w) {
    case 32:
      return attention_q8_width<32>(qkv, bias, s_qkv, out, B, N, C, H, kt,
                                    warps, samples, smem, scale, stream);
    case 64:
      return attention_q8_width<64>(qkv, bias, s_qkv, out, B, N, C, H, kt,
                                    warps, samples, smem, scale, stream);
    case 128:
      return attention_q8_width<128>(qkv, bias, s_qkv, out, B, N, C, H, kt,
                                     warps, samples, smem, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The long route's pre-pass alone, at head width C / H (on the scratch of
// its instance's width, of at least q8_scratch_bytes's operands).
cudaError_t attention_q8_prepass(const bf16* qkv, const float* s_qkv,
                                 void* scratch, long long scratch_bytes,
                                 int B, int N, int C, int H,
                                 cudaStream_t stream) {
  const int d = H > 0 && C % H == 0 ? C / H : 0;
  if (!head_dim_ok(d) || N < 1 || N > kAttnMaxLongTokens || B < 1 ||
      H < 1 || scratch == nullptr ||
      ((reinterpret_cast<uintptr_t>(qkv) |
        reinterpret_cast<uintptr_t>(scratch)) &
       15) != 0 ||
      scratch_bytes < q8_scratch_bytes(B, N, H, d, false))
    return cudaErrorInvalidValue;
  if (core_width(d) == kWideCore) {
    const Q8WideScratch sc = q8_wide_scratch(scratch, B, N, H, d);
    return s_qkv != nullptr
               ? attention_q8_prepass_wide_run<true>(qkv, s_qkv, sc, B, N, C,
                                                     H, stream)
               : attention_q8_prepass_wide_run<false>(qkv, s_qkv, sc, B, N,
                                                      C, H, stream);
  }
  const Q8LongScratch sc = q8_long_scratch(scratch, B, N, H, core_width(d));
  switch (core_width(d)) {
#define DM_PREPASS_CASE(W)                                                  \
  case W:                                                                   \
    return s_qkv != nullptr                                                 \
               ? attention_q8_prepass_run<W, true>(qkv, s_qkv, sc, B, N, C, \
                                                   H, stream)               \
               : attention_q8_prepass_run<W, false>(qkv, s_qkv, sc, B, N,   \
                                                    C, H, stream);
    DM_PREPASS_CASE(32)
    DM_PREPASS_CASE(64)
    DM_PREPASS_CASE(128)
    DM_PREPASS_CASE(256)
#undef DM_PREPASS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------------- block

// Parameter order (17 pointers, 18 with static scales), as the TPU
// kernel's tuple: ln1 scale, ln1 bias (f32 [C]), q_qkv (int8 [3C, C]),
// s_qkv (f32 [3C]), b_qkv (bf16 [3C]), attention bias (f32 [H, N, N]),
// q_proj (int8 [C, C]), s_proj (f32 [C]), b_proj (bf16 [C]), ln2 scale,
// ln2 bias, q_up (int8 [hidden, C]), s_up (f32 [hidden]), b_up (bf16
// [hidden]), q_down (int8 [C, hidden]), s_down (f32 [C]), b_down (bf16
// [C]) and, with static scales, s_act (f32 [7]: LN1 out, attention out,
// LN2 out, GELU out, then the three attention operands q, k, v, which only
// K4a quantizes). Weights are in nn.Linear's (out, in) layout. quant_attn
// runs the attention on K4a's int8 core instead of the bf16 one.
// A block's plan (`block_plan_q8`): the attention core's four ints (K2's
// core, or K4a's with quant_attn), then the six of each GEMM: qkv, proj,
// up, down. Widths as fused_block.cu's block_forward: the residual
// stream's C, the attention's A, the LayerNorms' statistics over Cn lanes
// and q's scale of the head width d_scale.
cudaError_t block_forward_q8(const bf16* x, bf16* out, int B, int N, int C,
                             int H, int hidden, int A, int Cn, int d_scale,
                             const void* const* p, bool static_scales,
                             bool quant_attn, bf16* qkv, bf16* att, bf16* r,
                             float* h, long long h_bytes, signed char* codes,
                             float* rs, float* row_amax, const int* plan,
                             cudaStream_t stream) {
  if (!block_widths_ok(C, A, Cn)) return cudaErrorInvalidValue;
  const auto* l1s = static_cast<const float*>(p[0]);
  const auto* l1b = static_cast<const float*>(p[1]);
  const auto* wq = static_cast<const signed char*>(p[2]);
  const auto* sq = static_cast<const float*>(p[3]);
  const auto* bq = static_cast<const bf16*>(p[4]);
  const auto* bias = static_cast<const float*>(p[5]);
  const auto* wp = static_cast<const signed char*>(p[6]);
  const auto* sp = static_cast<const float*>(p[7]);
  const auto* bp = static_cast<const bf16*>(p[8]);
  const auto* l2s = static_cast<const float*>(p[9]);
  const auto* l2b = static_cast<const float*>(p[10]);
  const auto* wu = static_cast<const signed char*>(p[11]);
  const auto* su = static_cast<const float*>(p[12]);
  const auto* bu = static_cast<const bf16*>(p[13]);
  const auto* wd = static_cast<const signed char*>(p[14]);
  const auto* sd = static_cast<const float*>(p[15]);
  const auto* bd = static_cast<const bf16*>(p[16]);
  const float* s_act =
      static_scales ? static_cast<const float*>(p[17]) : nullptr;
  auto stat = [&](int i) { return s_act != nullptr ? s_act + i : nullptr; };
  const int* gp = plan + kAttnPlanInts;  // the four GEMMs' plans
  auto gemm_plan = [&](int i) { return gp + i * kGemmQ8PlanInts; };
  const int M = B * N;
  cudaError_t e;

  if ((e = ln_quant(x, l1s, l1b, stat(0), codes, rs, nullptr, M, C, Cn,
                    stream)) != cudaSuccess)
    return e;
  e = gemm_s8(codes, wq,
              EpiS8<kQBiasCast>{sq, rs, stat(0), bq, nullptr, qkv, nullptr,
                                nullptr},
              M, 3 * A, C, gemm_plan(0), stream);
  if (e != cudaSuccess) return e;
  // K4a's long route and the bf16 core's wide form take h, unused until
  // the up GEMM, as their scratch
  e = quant_attn ? attention_q8(qkv, bias, stat(4), att, B, N, A, H, d_scale,
                                plan, h, h_bytes, stream)
                 : attention(qkv, bias, att, B, N, A, H, d_scale, plan, h,
                             h_bytes, stream);
  if (e != cudaSuccess) return e;
  if ((e = row_quant(att, stat(1), codes, rs, M, A, stream)) != cudaSuccess)
    return e;
  e = gemm_s8(codes, wp,
              EpiS8<kQBiasResidual>{sp, rs, stat(1), bp, x, r, nullptr,
                                    nullptr},
              M, C, A, gemm_plan(1), stream);
  if (e != cudaSuccess) return e;
  if ((e = ln_quant(r, l2s, l2b, stat(2), codes, rs,
                    static_scales ? nullptr : row_amax, M, C, Cn, stream)) !=
      cudaSuccess)
    return e;
  const signed char* h_codes = codes;
  if (static_scales) {
    // h1's codes straight from the up GEMM, into the f32 buffer's room
    auto* hq = reinterpret_cast<signed char*>(h);
    e = gemm_s8(codes, wu,
                EpiS8<kQBiasGeluCodes>{su, rs, stat(2), bu, nullptr, hq,
                                       nullptr, stat(3)},
                M, hidden, C, gemm_plan(2), stream);
    h_codes = hq;
  } else {
    e = gemm_s8(codes, wu,
                EpiS8<kQBiasGelu>{su, rs, nullptr, bu, nullptr, h, row_amax,
                                  nullptr},
                M, hidden, C, gemm_plan(2), stream);
    if (e == cudaSuccess) e = amax_quant(h, row_amax, codes, rs, M, hidden,
                                         stream);
  }
  if (e != cudaSuccess) return e;
  return gemm_s8(h_codes, wd,
                 EpiS8<kQBiasResidual>{sd, rs, stat(3), bd, r, out, nullptr,
                                       nullptr},
                 M, C, hidden, gemm_plan(3), stream);
}

}  // namespace

extern "C" {

const char* dm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One w8a8 block: out = block(x). x and out are (B, N, C) bf16 and must not
// overlap. `static_scales` nonzero: each block has 18 parameters, the last
// its static activation scales. `quant_attn` nonzero: the attention runs
// int8 (K4a), with static scales too when `static_scales`. Scratch: qkv
// (B·N, 3A), att (B·N, A), r (B·N, C) bf16; h (B·N, hidden) f32 of
// `h_bytes`, and with quant_attn on the long route at least the route's
// scratch (attention_q8_long_scratch's bytes), without it on the bf16
// core's wide form at least its scratch (`wide_scratch`'s bytes; a smaller
// h is refused); codes (B·N, max(A,
// hidden)) int8; row_scale and row_amax (B·N) f32. Requires
// A == H·d with d % 8 == 0 and 8 <= d <= 8192, A % 16 == 0, C <= A, C % 16
// == 0, C <= 8192, hidden % 16 == 0, N <= 16384 and 16-byte aligned tensors
// (checked by the caller); `c_norm` and `d_scale` as dm_block_forward's
// (fused_block.cu). `plan` is the block's
// launch plan (ops/kernels/fused_block.py `block_plan_q8`, 28 ints); a
// plan the kernels do not take is refused. Returns cudaGetLastError().
int dm_block_forward_q8(const void* x, void* out, int B, int N, int C, int H,
                        int hidden, int A, int c_norm, int d_scale,
                        const void* const* params, int static_scales,
                        int quant_attn, void* qkv, void* att, void* r, void* h,
                        long long h_bytes, void* codes, void* row_scale,
                        void* row_amax, const int* plan,
                        cudaStream_t stream) {
  return static_cast<int>(block_forward_q8(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), B, N, C, H,
      hidden, A, c_norm, d_scale, params, static_scales != 0, quant_attn != 0,
      static_cast<bf16*>(qkv), static_cast<bf16*>(att),
      static_cast<bf16*>(r), static_cast<float*>(h), h_bytes,
      static_cast<signed char*>(codes), static_cast<float*>(row_scale),
      static_cast<float*>(row_amax), plan, stream));
}

// `depth` w8a8 blocks back to back: block 0 reads x and writes out, every
// later block updates out in place (a block reads its input for the last
// time in the proj GEMM, before the down GEMM writes its output). `params`
// holds depth x 17 (or 18) pointers, block after block. Same shapes,
// scratch and plan as dm_block_forward_q8.
int dm_chain_forward_q8(const void* x, void* out, int B, int N, int C, int H,
                        int hidden, int A, int c_norm, int d_scale, int depth,
                        const void* const* params, int static_scales,
                        int quant_attn, void* qkv, void* att, void* r, void* h,
                        long long h_bytes, void* codes, void* row_scale,
                        void* row_amax, const int* plan,
                        cudaStream_t stream) {
  const int width = static_scales != 0 ? 18 : 17;
  for (int i = 0; i < depth; ++i) {
    const void* in = i == 0 ? x : out;
    const int err = dm_block_forward_q8(
        in, out, B, N, C, H, hidden, A, c_norm, d_scale, params + width * i,
        static_scales,
        quant_attn, qkv, att, r, h, h_bytes, codes, row_scale, row_amax, plan,
        stream);
    if (err != 0) return err;
  }
  return 0;
}

// The w8a8 blocks' LayerNorm + quantize alone (its measurement and tests):
// codes (M, C) int8 and row_scale (M) f32 of q(LN(x)) from x (M, C) bf16
// and the f32 scale w and bias b (C), with the static scale *static_scale
// (not null) or dynamic row scales; one warp a row up to C 2048, two or
// four above, the statistics over the first `c_norm` lanes (a zero-padded
// row's true width; C without padding). Requires C % 8 == 0, C <= 8192,
// 1 <= c_norm <= C and 16-byte aligned rows (checked by the caller).
// Returns cudaGetLastError().
int dm_ln_quant(const void* x, const void* w, const void* b,
                const void* static_scale, void* codes, void* row_scale, int M,
                int C, int c_norm, cudaStream_t stream) {
  return static_cast<int>(ln_quant(
      static_cast<const bf16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const float*>(static_scale),
      static_cast<signed char*>(codes), static_cast<float*>(row_scale),
      nullptr, M, C, c_norm, stream));
}

// K4's s8 GEMM alone (its measurement and tests): out (M, N) = epilogue
// `epi` (0 bias_cast, 1 bias_residual: bf16; 2 bias_gelu: f32 h1, then its
// dynamic int8 codes (M, N) and row scales (M) from the abs-maxes the
// epilogue folds into row_amax, which the caller zeroes; 3
// bias_gelu_codes: h1's int8 codes at the static *out_scale; 4 acc: the
// s32 sums, (M, N) int32, no scale or bias read) of
// dq(A (M, K) · W (N, K)ᵀ), int8 codes, with the weight scale w_scale (N),
// the row scales row_scale (M) or the static scale *static_scale (not
// null), bias (N) bf16 and resid (M, N) bf16 for bias_residual. `plan` is
// the GEMM's six ints (ops/kernels/fused_block.py `gemm_q8_plan`).
// Requires K % 16 == 0, N % 8 == 0 and 16-byte aligned tensors (checked
// by the caller). Returns cudaGetLastError().
int dm_gemm_q8(const void* a, const void* w, const void* w_scale,
               const void* row_scale, const void* static_scale,
               const void* bias, const void* resid, void* out, void* codes,
               void* out_row_scale, void* row_amax, const void* out_scale,
               int M, int N, int K, int epi, const int* plan,
               cudaStream_t stream) {
  const auto* A = static_cast<const signed char*>(a);
  const auto* W = static_cast<const signed char*>(w);
  const auto* ws = static_cast<const float*>(w_scale);
  const auto* rs = static_cast<const float*>(row_scale);
  const auto* ss = static_cast<const float*>(static_scale);
  const auto* b = static_cast<const bf16*>(bias);
  const auto* rr = static_cast<const bf16*>(resid);
  auto* amax = static_cast<float*>(row_amax);
  cudaError_t e;
  switch (epi) {
    case kQBiasCast:
      e = gemm_s8(A, W,
                  EpiS8<kQBiasCast>{ws, rs, ss, b, nullptr, out, nullptr,
                                    nullptr},
                  M, N, K, plan, stream);
      break;
    case kQBiasResidual:
      e = gemm_s8(A, W,
                  EpiS8<kQBiasResidual>{ws, rs, ss, b, rr, out, nullptr,
                                        nullptr},
                  M, N, K, plan, stream);
      break;
    case kQBiasGelu:
      e = gemm_s8(A, W,
                  EpiS8<kQBiasGelu>{ws, rs, ss, b, nullptr, out, amax,
                                    nullptr},
                  M, N, K, plan, stream);
      if (e == cudaSuccess)
        e = amax_quant(static_cast<const float*>(out), amax,
                       static_cast<signed char*>(codes),
                       static_cast<float*>(out_row_scale), M, N, stream);
      break;
    case kQBiasGeluCodes:
      e = gemm_s8(A, W,
                  EpiS8<kQBiasGeluCodes>{ws, rs, ss, b, nullptr, out,
                                         nullptr,
                                         static_cast<const float*>(out_scale)},
                  M, N, K, plan, stream);
      break;
    case kQAcc:
      e = gemm_s8(A, W,
                  EpiS8<kQAcc>{ws, rs, ss, b, nullptr, out, nullptr, nullptr},
                  M, N, K, plan, stream);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// K4a's int8 core alone (its measurement and tests): out (B·N, C) bf16
// from a packed (B·N, 3C) bf16 qkv and the (H, N, N) f32 bias, with the
// static (s_q, s_k, s_v) (f32 [3]) or, if null, dynamic scales. `plan` is
// the wrapper's `attention_q8_plan` (the short core up to N 256, the long
// route above or when the plan forces it: its pre-pass writes `scratch`,
// of `scratch_bytes`, at least attention_q8_long_scratch's bytes).
// Requires C == H·d with d % 8 == 0 and 8 <= d <= 8192, and N <= 16384
// (checked by the caller); q's scale is the d^-1/2 of `d_scale`, the
// head's true width (d, or less on a zero-padded layout: block_common.cuh
// scale_width_ok). Returns cudaGetLastError().
int dm_attention_q8(const void* qkv, const void* bias, const void* s_qkv,
                    void* out, int B, int N, int C, int H, int d_scale,
                    const int* plan, void* scratch, long long scratch_bytes,
                    cudaStream_t stream) {
  return static_cast<int>(attention_q8(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(s_qkv), static_cast<bf16*>(out), B, N, C, H,
      d_scale, plan, scratch, scratch_bytes, stream));
}

// The long route's pre-pass alone (its measurement and tests): from a
// packed (B·N, 3C) bf16 qkv, with the static (s_q, s_k, s_v) or, if null,
// dynamic scales, into `scratch` (of `scratch_bytes`, at least
// attention_q8_long_scratch's operands): k codes (B, H, Np, d), v codes
// transposed (B, H, d, Np) in the slot order, k's row scales (B, H, Np)
// and v's column scales (B, H, d), f32, Np = N rounded up to 64. Returns
// cudaGetLastError().
int dm_attention_q8_prepass(const void* qkv, const void* s_qkv, void* scratch,
                            long long scratch_bytes, int B, int N, int C,
                            int H, cudaStream_t stream) {
  return static_cast<int>(attention_q8_prepass(
      static_cast<const bf16*>(qkv), static_cast<const float*>(s_qkv),
      scratch, scratch_bytes, B, N, C, H, stream));
}

}  // extern "C"
