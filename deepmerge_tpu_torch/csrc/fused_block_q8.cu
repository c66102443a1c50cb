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

#include "wgmma_gemm.cuh"

namespace {

constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ signed char code_of(float q) {
  return static_cast<signed char>(
      __float2int_rn(fminf(fmaxf(rintf(q), -127.0f), 127.0f)));
}

// Eight codes of one row: q(t) with the row scale s (dynamic) or 1/s
// (static, `inv`), stored as one 8-byte word.
__device__ __forceinline__ void store_codes8(const float* v, bool dynamic,
                                             float s, float inv,
                                             signed char* dst) {
  uint2 u;
  signed char* o = reinterpret_cast<signed char*>(&u);
#pragma unroll
  for (int t = 0; t < 8; ++t) o[t] = code_of(dynamic ? v[t] / s : v[t] * inv);
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

// codes = q(LN(x)) per row with the f32 LayerNorm output (two-pass
// statistics, as the TPU kernel's `_ln`), its row scale in row_scale. One
// warp per row, C <= 1024. `static_scale` null means dynamic scales;
// `zero` (may be null) gets 0 at each row: the abs-max buffer that the next
// GEMM's epilogue folds into.
__global__ void __launch_bounds__(kLnWarps * 32)
ln_quant_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b,
                const float* __restrict__ static_scale,
                signed char* __restrict__ codes, float* __restrict__ row_scale,
                float* __restrict__ zero, int M, int C) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kLnWarps + warp;
  if (row >= M) return;
  const bf16* xr = x + row * C;
  float v[kLnMaxVec][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxVec; ++i) {
    const int k = (lane + 32 * i) * 8;
    if (k < C) {
      load8(xr + k, v[i]);
#pragma unroll
      for (int t = 0; t < 8; ++t) s += v[i][t];
    }
  }
  const float mu = warp_sum(s) / static_cast<float>(C);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxVec; ++i) {
    if ((lane + 32 * i) * 8 < C) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float d = v[i][t] - mu;
        q += d * d;
      }
    }
  }
  const float rs = rsqrtf(warp_sum(q) / static_cast<float>(C) + kLnEps);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxVec; ++i) {
    const int k = (lane + 32 * i) * 8;
    if (k < C) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        v[i][t] = (v[i][t] - mu) * rs * w[k + t] + b[k + t];
        amax = fmaxf(amax, fabsf(v[i][t]));
      }
    }
  }
  const bool dynamic = static_scale == nullptr;
  float sc, inv = 0.f;
  if (dynamic) {
    amax = warp_max(amax);
    sc = amax > 0.f ? amax * kInv127 : 1.0f;
  } else {
    sc = *static_scale;
    inv = 1.0f / sc;
  }
#pragma unroll
  for (int i = 0; i < kLnMaxVec; ++i) {
    const int k = (lane + 32 * i) * 8;
    if (k < C) store_codes8(v[i], dynamic, sc, inv, codes + row * C + k);
  }
  if (lane == 0) {
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

// d (64 x 256 s32 over the warpgroup) += A (64 x 32) · W (256 x 32)ᵀ, int8,
// both K-major in shared memory.
struct MmaS8 {
  using Acc = int;
  static constexpr int kSlabK = kQ8SlabK;
  static __device__ __forceinline__ void mma(int (&d)[kGemmBN / 2],
                                             uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103,"
        "%104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127},"
        " %128, %129, p;\n"
        "}\n"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
          "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
          "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
          "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
          "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
          "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
          "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
};

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
// int8 codes (W in nn.Linear's layout), K % 128 == 0, N % 8 == 0 and
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

cudaError_t ln_quant(const bf16* x, const float* w, const float* b,
                     const float* static_scale, signed char* codes,
                     float* row_scale, float* zero, int M, int C,
                     cudaStream_t stream) {
  ln_quant_kernel<<<(M + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0,
                    stream>>>(x, w, b, static_scale, codes, row_scale, zero,
                              M, C);
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
//   q, k: codes per row (token) over the head's 64 lanes, scale
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
// sk) go to shared memory in row order, 80-byte rows (conflict-free
// ldmatrix), and its v codes, scaled by column (sv), transposed to
// [lane][key] for the value product's B fragments, each quantized from
// 16-byte loads issued four deep (the staging is bound by their latency:
// one load at a time cost it twice the core's time). Each warp then takes
// 16-query tiles:
//  * q straight from device memory into registers, quantized there: a
//    thread holds 16 of a row's 64 lanes, the quad the whole row, so the
//    row abs-max takes two shuffles, and the codes are the logits' A
//    fragments;
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
// kSteps (a bucket of the 32-key step count ceil(N/32)) sizes the register
// arrays; steps past ceil(N/32) are skipped. Keys past N get code 0 in k
// and v and pq 0; rows past N are computed on zero codes and not stored.

constexpr int kQ8Row = kHeadDim + 16;  // k codes' row stride: 80 B
constexpr int kAttnQ8MaxWarps = 8;
constexpr int kAttnQ8MaxParts = kAttnQ8MaxWarps * 32 / 8;  // 8-thread groups

// Shared memory of one K4a CTA for n tokens, keys padded to 32: k codes
// (np x 80 B), v codes transposed (64 x (np + 16) B: rows an odd multiple
// of 16 bytes apart, conflict-free for ldmatrix), k's row scales, v's
// column scales, v's partial column abs-maxes (one row of 64 for each
// eight threads). 37,888 B at n = 192, 47,360 B at n = 256.
struct AttnQ8Layout {
  int np, v_ld, kq, vt, sk, sv, red, bytes;
};

__host__ __device__ inline AttnQ8Layout attn_q8_layout(int n) {
  AttnQ8Layout l;
  l.np = (n + 31) & ~31;
  l.v_ld = l.np + 16;
  l.kq = 0;
  l.vt = l.kq + l.np * kQ8Row;
  l.sk = l.vt + kHeadDim * l.v_ld;
  l.sv = l.sk + l.np * static_cast<int>(sizeof(float));
  l.red = l.sv + kHeadDim * static_cast<int>(sizeof(float));
  l.bytes = l.red + kAttnQ8MaxParts * kHeadDim * static_cast<int>(sizeof(float));
  return l;
}

// V's transposed rows keep the keys of each 32-key step in the order of
// the A fragments of pq: key 16h + 8u + 2t + e sits at slot
// 16h + 4t + 2u + e, where the A fragment (positions 4t..4t+3 and
// 16+4t..+3 of the thread's quad index t) takes it from the accumulators
// of 8-key tiles u = 0, 1 (and 2, 3 for h = 1).

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
// SM.
template <int kSteps, bool kStatic>
__global__ void __launch_bounds__(kAttnMaxWarps * 32, kSteps <= 2 ? 2 : 1)
attention_q8_kernel(const bf16* __restrict__ qkv,
                    const float* __restrict__ bias,
                    const float* __restrict__ s_qkv, bf16* __restrict__ out,
                    int B, int N, int C, int samples, float scale) {
  constexpr int kTiles = 4 * kSteps;  // 8-key tiles
  extern __shared__ __align__(16) unsigned char q8_smem[];
  const AttnQ8Layout L = attn_q8_layout(N);
  signed char* kq = reinterpret_cast<signed char*>(q8_smem + L.kq);
  signed char* vt = reinterpret_cast<signed char*>(q8_smem + L.vt);
  float* sk = reinterpret_cast<float*>(q8_smem + L.sk);
  float* sv = reinterpret_cast<float*>(q8_smem + L.sv);
  float* red = reinterpret_cast<float*>(q8_smem + L.red);

  const int h = blockIdx.x;
  const long long ld = 3LL * C;
  const int head_off = h * kHeadDim;
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

    // k codes: eight threads a key (an octet of lanes each), the row's
    // abs-max over the eight, four keys' loads in flight at a time; keys
    // past N code 0, scale 1
    for (int base = threadIdx.x; base < L.np * 8; base += 4 * blockDim.x) {
      float v[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = base + u * blockDim.x;
#pragma unroll
        for (int t = 0; t < 8; ++t) v[u][t] = 0.f;
        if (idx < L.np * 8 && (idx >> 3) < N)
          load8(kb + (row0 + (idx >> 3)) * ld + (idx & 7) * 8, v[u]);
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
          for (int o = 1; o < 8; o <<= 1)
            amax = fmaxf(amax, __shfl_xor_sync(full, amax, o));
          sc = amax > 0.f ? amax * kInv127 : 1.0f;
        }
        if (idx < L.np * 8) {
          store_codes8(v[u], !kStatic, sc, inv_k,
                       kq + (idx >> 3) * kQ8Row + (idx & 7) * 8);
          if ((idx & 7) == 0) sk[idx >> 3] = sc;
        }
      }
    }

    // v's column scales: a thread takes an octet of lanes over every
    // parts-th key, four keys' loads in flight at a time; the parts'
    // abs-maxes meet in shared memory
    if constexpr (!kStatic) {
      const int oct = threadIdx.x & 7;
      const int part = threadIdx.x >> 3;
      const int parts = blockDim.x >> 3;
      float m[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int j0 = part; j0 < N; j0 += 4 * parts) {
        float v[4][8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u * parts;
#pragma unroll
          for (int t = 0; t < 8; ++t) v[u][t] = 0.f;
          if (j < N) load8(vb + (row0 + j) * ld + oct * 8, v[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int t = 0; t < 8; ++t) m[t] = fmaxf(m[t], fabsf(v[u][t]));
      }
      float* r = red + part * kHeadDim + oct * 8;
      *reinterpret_cast<float4*>(r) = make_float4(m[0], m[1], m[2], m[3]);
      *reinterpret_cast<float4*>(r + 4) = make_float4(m[4], m[5], m[6], m[7]);
      __syncthreads();
      if (threadIdx.x < kHeadDim) {
        float a = red[threadIdx.x];
        for (int t = 1; t < parts; ++t)
          a = fmaxf(a, red[t * kHeadDim + threadIdx.x]);
        sv[threadIdx.x] = a > 0.f ? a * kInv127 : 1.0f;
      }
      __syncthreads();
    }

    // v codes, transposed: a thread takes an octet of lanes and the four
    // slots 4·grp..+3 of a 32-key step, keys 32s + 16h + 2t + {0, 1, 8, 9}
    // (the inverse of the slot map above), and writes one 4-byte word to
    // each of its eight lanes' rows
    for (int idx = threadIdx.x; idx < 8 * (L.np / 4); idx += blockDim.x) {
      const int oct = idx & 7;
      const int grp = idx >> 3;
      const int j0 = (grp >> 3) * 32 + ((grp >> 2) & 1) * 16 + (grp & 3) * 2;
      float v[4][8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + (e & 1) + (e >> 1) * 8;
#pragma unroll
        for (int t = 0; t < 8; ++t) v[e][t] = 0.f;
        if (j < N) load8(vb + (row0 + j) * ld + oct * 8, v[e]);
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int dd = oct * 8 + t;
        int c[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[e] = code_of(kStatic ? v[e][t] * inv_v : v[e][t] / sv[dd]);
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

      // q codes: lanes 16c + 4t..+3 of rows ra and rb
      float va[4][4], vbq[4][4];
      float ma = 0.f, mb = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        load4(qa_row + 16 * c, ra < N, va[c]);
        load4(qb_row + 16 * c, rb < N, vbq[c]);
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
      uint32_t qa[2][4];  // A fragments of the two 32-lane k steps
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int ca[4], cb[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          ca[t] = code_of(kStatic ? va[c][t] * inv_q : va[c][t] / sqa);
          cb[t] = code_of(kStatic ? vbq[c][t] * inv_q : vbq[c][t] / sqb);
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
            uint32_t bk[4];  // lanes 0-15, 16-31, 32-47, 48-63 of keys 8t..
            ldsm_x4(bk, reinterpret_cast<const bf16*>(
                            kq + (t * 8 + (lane & 7)) * kQ8Row + mi * 16));
#pragma unroll
            for (int e = 0; e < 4; ++e) s4[u][e] = 0;
            mma_s8(s4[u], qa[0], bk[0], bk[1]);
            mma_s8(s4[u], qa[1], bk[2], bk[3]);
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

      // O = pq·vi (16 x 64, s32), B fragments by ldmatrix from v's
      // transposed rows
      int o[kHeadDim / 8][4];
#pragma unroll
      for (int dt = 0; dt < kHeadDim / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] = 0;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        if (st < steps) {
#pragma unroll
          for (int dd = 0; dd < kHeadDim / 16; ++dd) {
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

      // out = bf16((O · 1/Σpq) · s_v)
#pragma unroll
      for (int dt = 0; dt < kHeadDim / 8; ++dt) {
        const int col = dt * 8 + 2 * tig;
        const float v0 = kStatic ? s_v : sv[col];
        const float v1 = kStatic ? s_v : sv[col + 1];
        if (ra < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (row0 + ra) * C +
                                             head_off + col) =
              __floats2bfloat162_rn(
                  __fmul_rn(__fmul_rn(static_cast<float>(o[dt][0]), inva), v0),
                  __fmul_rn(__fmul_rn(static_cast<float>(o[dt][1]), inva), v1));
        if (rb < N)
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

template <int kSteps, bool kStatic>
inline cudaError_t attention_q8_run(const bf16* qkv, const float* bias,
                                    const float* s_qkv, bf16* out, int B,
                                    int N, int C, int H, int warps,
                                    int samples, int smem,
                                    cudaStream_t stream) {
  auto* kern = attention_q8_kernel<kSteps, kStatic>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));
  const dim3 grid(H, (B + samples - 1) / samples);
  kern<<<grid, warps * 32, smem, stream>>>(qkv, bias, s_qkv, out, B, N, C,
                                           samples, scale);
  return cudaGetLastError();
}

// K4a over a packed (B·N, 3C) qkv; s_qkv null for dynamic scales. `plan`
// is the wrapper's `attention_q8_plan`: the 32-key step bucket, the warps
// of a CTA (even, at most 8), the samples of a CTA and the shared bytes;
// a plan the kernel does not take is refused with cudaErrorInvalidValue.
cudaError_t attention_q8(const bf16* qkv, const float* bias,
                         const float* s_qkv, bf16* out, int B, int N, int C,
                         int H, const int* plan, cudaStream_t stream) {
  const int kt = plan[0], warps = plan[1], samples = plan[2], smem = plan[3];
  if (N < 1 || N > 256 || kt * 32 < N || warps < 2 || warps % 2 ||
      warps > kAttnQ8MaxWarps || samples < 1 ||
      smem != attn_q8_layout(N).bytes)
    return cudaErrorInvalidValue;
#define DM_ATTN_Q8_CASE(KS)                                                  \
  case KS:                                                                   \
    return s_qkv != nullptr                                                  \
               ? attention_q8_run<KS, true>(qkv, bias, s_qkv, out, B, N, C,  \
                                            H, warps, samples, smem, stream) \
               : attention_q8_run<KS, false>(qkv, bias, nullptr, out, B, N,  \
                                             C, H, warps, samples, smem,     \
                                             stream);
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
// up, down.
cudaError_t block_forward_q8(const bf16* x, bf16* out, int B, int N, int C,
                             int H, int hidden, const void* const* p,
                             bool static_scales, bool quant_attn, bf16* qkv,
                             bf16* att, bf16* r, float* h, signed char* codes,
                             float* rs, float* row_amax, const int* plan,
                             cudaStream_t stream) {
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

  if ((e = ln_quant(x, l1s, l1b, stat(0), codes, rs, nullptr, M, C,
                    stream)) != cudaSuccess)
    return e;
  e = gemm_s8(codes, wq,
              EpiS8<kQBiasCast>{sq, rs, stat(0), bq, nullptr, qkv, nullptr,
                                nullptr},
              M, 3 * C, C, gemm_plan(0), stream);
  if (e != cudaSuccess) return e;
  e = quant_attn
          ? attention_q8(qkv, bias, stat(4), att, B, N, C, H, plan, stream)
          : attention(qkv, bias, att, B, N, C, H, plan, stream);
  if (e != cudaSuccess) return e;
  if ((e = row_quant(att, stat(1), codes, rs, M, C, stream)) != cudaSuccess)
    return e;
  e = gemm_s8(codes, wp,
              EpiS8<kQBiasResidual>{sp, rs, stat(1), bp, x, r, nullptr,
                                    nullptr},
              M, C, C, gemm_plan(1), stream);
  if (e != cudaSuccess) return e;
  if ((e = ln_quant(r, l2s, l2b, stat(2), codes, rs,
                    static_scales ? nullptr : row_amax, M, C, stream)) !=
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
// (B·N, 3C), att (B·N, C), r (B·N, C) bf16; h (B·N, hidden) f32; codes
// (B·N, max(C, hidden)) int8; row_scale and row_amax (B·N) f32. Requires
// C == H·64, C % 128 == 0, C <= 1024, hidden % 128 == 0, N <= 256 and
// 16-byte aligned tensors (checked by the caller). `plan` is the block's
// launch plan (ops/kernels/fused_block.py `block_plan_q8`, 28 ints); a
// plan the kernels do not take is refused. Returns cudaGetLastError().
int dm_block_forward_q8(const void* x, void* out, int B, int N, int C, int H,
                        int hidden, const void* const* params,
                        int static_scales, int quant_attn, void* qkv,
                        void* att, void* r, void* h, void* codes,
                        void* row_scale, void* row_amax, const int* plan,
                        cudaStream_t stream) {
  return static_cast<int>(block_forward_q8(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), B, N, C, H,
      hidden, params, static_scales != 0, quant_attn != 0,
      static_cast<bf16*>(qkv), static_cast<bf16*>(att),
      static_cast<bf16*>(r), static_cast<float*>(h),
      static_cast<signed char*>(codes), static_cast<float*>(row_scale),
      static_cast<float*>(row_amax), plan, stream));
}

// `depth` w8a8 blocks back to back: block 0 reads x and writes out, every
// later block updates out in place (a block reads its input for the last
// time in the proj GEMM, before the down GEMM writes its output). `params`
// holds depth x 17 (or 18) pointers, block after block. Same shapes,
// scratch and plan as dm_block_forward_q8.
int dm_chain_forward_q8(const void* x, void* out, int B, int N, int C, int H,
                        int hidden, int depth, const void* const* params,
                        int static_scales, int quant_attn, void* qkv,
                        void* att, void* r, void* h, void* codes,
                        void* row_scale, void* row_amax, const int* plan,
                        cudaStream_t stream) {
  const int width = static_scales != 0 ? 18 : 17;
  for (int i = 0; i < depth; ++i) {
    const void* in = i == 0 ? x : out;
    const int err = dm_block_forward_q8(
        in, out, B, N, C, H, hidden, params + width * i, static_scales,
        quant_attn, qkv, att, r, h, codes, row_scale, row_amax, plan, stream);
    if (err != 0) return err;
  }
  return 0;
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
// Requires K % 128 == 0, N % 8 == 0 and 16-byte aligned tensors (checked
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
// the wrapper's `attention_q8_plan`. Requires C == H·64 and N <= 256
// (checked by the caller). Returns cudaGetLastError().
int dm_attention_q8(const void* qkv, const void* bias, const void* s_qkv,
                    void* out, int B, int N, int C, int H, const int* plan,
                    cudaStream_t stream) {
  return static_cast<int>(attention_q8(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(s_qkv), static_cast<bf16*>(out), B, N, C, H,
      plan, stream));
}

}  // extern "C"
