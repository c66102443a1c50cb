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
//   a   = attention(qkv)                   bf16, K2's core, unchanged
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
// sample as K2's, now on the int8 tensor cores (twice the bf16 rate); the
// float32 GELU output (4·C floats a token) and the row-quantize passes add
// memory traffic that K2 does not have. The design is K2's: a fixed
// sequence of launches from one C entry point, intermediates in device
// memory:
//   LN1+quantize → qkv GEMM → attention → quantize(a) → proj GEMM
//   (+residual) → LN2+quantize → up GEMM (+GELU, f32) → quantize(h1) →
//   down GEMM (+residual).
// * The GEMMs share one kernel: 128x128 output tiles, 128-byte-deep K
//   tiles, s8 WMMA 16x16x16 with s32 accumulation, a three-stage cp.async
//   pipeline, and an epilogue that dequantizes and applies the bias, casts
//   and GELU or residual of its call.
// * An s8 fragment is 16 bytes deep, and WMMA wants each fragment to start
//   on 32 bytes. Shared memory therefore keeps a K tile as eight slabs of
//   16-byte columns ([slab][row][16 B]), the slabs 2080 bytes apart: every
//   fragment is one contiguous, 32-byte-aligned run of 256 bytes, and the
//   eight 16-byte copies of one 128-byte global row fall on four bank
//   groups (a two-way conflict on the writes, none on the fragment reads).
// * The row-quantize kernel takes one warp per row and reads the row twice
//   (abs-max, then codes).
// Keeping activations on chip, wgmma and TMA are later work.

#include "block_common.cuh"

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
// warp per row, C <= 1024. `static_scale` null means dynamic scales.
__global__ void __launch_bounds__(kLnWarps * 32)
ln_quant_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b,
                const float* __restrict__ static_scale,
                signed char* __restrict__ codes, float* __restrict__ row_scale,
                int M, int C) {
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
  if (lane == 0) row_scale[row] = sc;
}

// ------------------------------------------------------------ row quantize

// codes = q(x) per row of a bf16 or f32 (M, C) matrix, C % 8 == 0. One warp
// per row; the row is read twice (abs-max, then codes).
template <typename T>
__global__ void __launch_bounds__(kLnWarps * 32)
row_quant_kernel(const T* __restrict__ x,
                 const float* __restrict__ static_scale,
                 signed char* __restrict__ codes,
                 float* __restrict__ row_scale, int M, int C) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kLnWarps + warp;
  if (row >= M) return;
  const T* xr = x + row * C;
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

// -------------------------------------------------------------- int8 GEMM

constexpr int kQBM = 128, kQBN = 128, kQBK = 128, kQStages = 3;
constexpr int kSlabs = kQBK / 16;              // 16-byte columns of a K tile
constexpr int kSlabStride = kQBM * 16 + 32;    // bytes; a multiple of 32
constexpr int kQTile = kSlabs * kSlabStride;   // one operand tile, bytes
constexpr int kQGemmThreads = 256;             // 8 warps: 2 (rows) x 4 (cols)
constexpr size_t kQGemmSmem = static_cast<size_t>(kQStages) * 2 * kQTile;

enum QEpilogue { kQBiasCast = 0, kQBiasResidual = 1, kQBiasGeluF32 = 2 };

// out[m, n] = epilogue(dq(Σ_k A[m, k]·W[n, k])). A (M, K) and W (N, K) are
// row-major int8 codes (W in nn.Linear's layout); K % 128 == 0 and
// N % 8 == 0 (checked by the caller). The row scale is row_scale[m], or
// *static_scale when that is not null. kQBiasCast and kQBiasResidual write
// bf16, kQBiasGeluF32 writes f32. Two CTAs of 97.5 KB fit one SM.
template <int kEpi>
__global__ void __launch_bounds__(kQGemmThreads, 2)
gemm_s8_kernel(const signed char* __restrict__ A,
               const signed char* __restrict__ W,
               const float* __restrict__ w_scale,
               const float* __restrict__ row_scale,
               const float* __restrict__ static_scale,
               const bf16* __restrict__ bias, const bf16* __restrict__ resid,
               void* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char q_smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * kQBN;
  const long long m0 = static_cast<long long>(blockIdx.y) * kQBM;
  const int k_tiles = K / kQBK;

  // a stage holds the A tile then the W tile; each thread starts four
  // 16-byte copies of each per K tile (eight threads to one 128-byte row),
  // zero-filling rows past M or N
  auto load_stage = [&](int stage, int kt) {
    unsigned char* as = q_smem + stage * 2 * kQTile;
    unsigned char* bs = as + kQTile;
    const int k0 = kt * kQBK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * kQGemmThreads;
      const int r = c >> 3;
      const int slab = c & 7;
      const int dst = slab * kSlabStride + r * 16;
      const long long gm = m0 + r;
      const bool in_m = gm < M;
      cp_async16(as + dst, in_m ? A + gm * K + k0 + slab * 16 : A, in_m);
      const int gn = n0 + r;
      const bool in_n = gn < N;
      cp_async16(bs + dst,
                 in_n ? W + static_cast<long long>(gn) * K + k0 + slab * 16
                      : W,
                 in_n);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int wm = warp >> 2;  // rows wm*64 .. +64
  const int wn = warp & 3;   // cols wn*32 .. +32

#pragma unroll
  for (int s = 0; s < kQStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kQStages - 2>();  // tile kt has landed
    __syncthreads();                // ... and tile kt-1's stage is free
    const int next = kt + kQStages - 1;
    if (next < k_tiles) load_stage(next % kQStages, next);
    cp_async_commit();
    const signed char* as = reinterpret_cast<const signed char*>(
        q_smem + (kt % kQStages) * 2 * kQTile);
    const signed char* bs = as + kQTile;
#pragma unroll
    for (int slab = 0; slab < kSlabs; ++slab) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                     wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                     wmma::col_major> bfr[2];
      const signed char* a_slab = as + slab * kSlabStride;
      const signed char* b_slab = bs + slab * kSlabStride;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], a_slab + (wm * 64 + i * 16) * 16, 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], b_slab + (wn * 32 + j * 16) * 16, 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline's shared memory becomes epilogue scratch

  // epilogue, one 16x16 fragment at a time through the warp's scratch
  int* cs = reinterpret_cast<int*>(q_smem) + warp * 256;
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;
  const float s_static = static_scale != nullptr ? *static_scale : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long gm = m0 + wm * 64 + i * 16 + er;
      const int gn = n0 + wn * 32 + j * 16 + ec;
      if (gm < M && gn < N) {
        const int* cv = cs + er * 16 + ec;
        float ws[8], y[8];
        load8(w_scale + gn, ws);
        float bb[8];
        load8(bias + gn, bb);
        const float sr = static_scale != nullptr ? 0.f : row_scale[gm];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float a = static_cast<float>(cv[t]);  // round to nearest
          y[t] = static_scale != nullptr
                     ? __fmul_rn(a, __fmul_rn(s_static, ws[t]))
                     : __fmul_rn(__fmul_rn(a, sr), ws[t]);
        }
        if constexpr (kEpi == kQBiasGeluF32) {
          float* o = static_cast<float*>(out) + gm * N + gn;
#pragma unroll
          for (int t = 0; t < 8; ++t) y[t] = gelu_tanh(__fadd_rn(y[t], bb[t]));
          *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
          *reinterpret_cast<float4*>(o + 4) =
              make_float4(y[4], y[5], y[6], y[7]);
        } else {
          float rr[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          if constexpr (kEpi == kQBiasResidual) load8(resid + gm * N + gn, rr);
          uint4 ov;
          bf16* o = reinterpret_cast<bf16*>(&ov);
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            float v = round_bf16(round_bf16(y[t]) + bb[t]);
            if constexpr (kEpi == kQBiasResidual) v = rr[t] + v;
            o[t] = __float2bfloat16(v);
          }
          *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + gm * N + gn) =
              ov;
        }
      }
      __syncwarp();
    }
  }
}

template <int kEpi>
cudaError_t gemm_s8(const signed char* A, const signed char* W,
                    const float* w_scale, const float* row_scale,
                    const float* static_scale, const bf16* bias,
                    const bf16* resid, void* out, int M, int N, int K,
                    cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      gemm_s8_kernel<kEpi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kQGemmSmem));
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kQBN - 1) / kQBN, (M + kQBM - 1) / kQBM);
  gemm_s8_kernel<kEpi><<<grid, kQGemmThreads, kQGemmSmem, stream>>>(
      A, W, w_scale, row_scale, static_scale, bias, resid, out, M, N, K);
  return cudaGetLastError();
}

cudaError_t ln_quant(const bf16* x, const float* w, const float* b,
                     const float* static_scale, signed char* codes,
                     float* row_scale, int M, int C, cudaStream_t stream) {
  ln_quant_kernel<<<(M + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0,
                    stream>>>(x, w, b, static_scale, codes, row_scale, M, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t row_quant(const T* x, const float* static_scale,
                      signed char* codes, float* row_scale, int M, int C,
                      cudaStream_t stream) {
  row_quant_kernel<T><<<(M + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0,
                        stream>>>(x, static_scale, codes, row_scale, M, C);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- block

// Parameter order (17 pointers, 18 with static scales), as the TPU
// kernel's tuple: ln1 scale, ln1 bias (f32 [C]), q_qkv (int8 [3C, C]),
// s_qkv (f32 [3C]), b_qkv (bf16 [3C]), attention bias (f32 [H, N, N]),
// q_proj (int8 [C, C]), s_proj (f32 [C]), b_proj (bf16 [C]), ln2 scale,
// ln2 bias, q_up (int8 [hidden, C]), s_up (f32 [hidden]), b_up (bf16
// [hidden]), q_down (int8 [C, hidden]), s_down (f32 [C]), b_down (bf16
// [C]) and, with static scales, s_act (f32 [7]: LN1 out, attention out,
// LN2 out, GELU out, then three attention operands this kernel does not
// quantize). Weights are in nn.Linear's (out, in) layout.
cudaError_t block_forward_q8(const bf16* x, bf16* out, int B, int N, int C,
                             int H, int hidden, const void* const* p,
                             bool static_scales, bf16* qkv, bf16* att,
                             bf16* r, float* h, signed char* codes,
                             float* rs, cudaStream_t stream) {
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
  const int M = B * N;
  cudaError_t e;

  if ((e = ln_quant(x, l1s, l1b, stat(0), codes, rs, M, C, stream)) !=
      cudaSuccess)
    return e;
  e = gemm_s8<kQBiasCast>(codes, wq, sq, rs, stat(0), bq, nullptr, qkv, M,
                          3 * C, C, stream);
  if (e != cudaSuccess) return e;
  if ((e = attention(qkv, bias, att, B, N, C, H, stream)) != cudaSuccess)
    return e;
  if ((e = row_quant(att, stat(1), codes, rs, M, C, stream)) != cudaSuccess)
    return e;
  e = gemm_s8<kQBiasResidual>(codes, wp, sp, rs, stat(1), bp, x, r, M, C, C,
                              stream);
  if (e != cudaSuccess) return e;
  if ((e = ln_quant(r, l2s, l2b, stat(2), codes, rs, M, C, stream)) !=
      cudaSuccess)
    return e;
  e = gemm_s8<kQBiasGeluF32>(codes, wu, su, rs, stat(2), bu, nullptr, h, M,
                             hidden, C, stream);
  if (e != cudaSuccess) return e;
  if ((e = row_quant(static_cast<const float*>(h), stat(3), codes, rs, M,
                     hidden, stream)) != cudaSuccess)
    return e;
  return gemm_s8<kQBiasResidual>(codes, wd, sd, rs, stat(3), bd, r, out, M,
                                 C, hidden, stream);
}

}  // namespace

extern "C" {

const char* dm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One w8a8 block: out = block(x). x and out are (B, N, C) bf16 and must not
// overlap. `static_scales` nonzero: each block has 18 parameters, the last
// its static activation scales. Scratch: qkv (B·N, 3C), att (B·N, C), r
// (B·N, C) bf16; h (B·N, hidden) f32; codes (B·N, max(C, hidden)) int8;
// row_scale (B·N) f32. Requires C == H·64, C % 128 == 0, C <= 1024,
// hidden % 128 == 0 and N <= 256 (checked by the caller). Returns
// cudaGetLastError().
int dm_block_forward_q8(const void* x, void* out, int B, int N, int C, int H,
                        int hidden, const void* const* params,
                        int static_scales, void* qkv, void* att, void* r,
                        void* h, void* codes, void* row_scale,
                        cudaStream_t stream) {
  return static_cast<int>(block_forward_q8(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), B, N, C, H,
      hidden, params, static_scales != 0, static_cast<bf16*>(qkv),
      static_cast<bf16*>(att), static_cast<bf16*>(r), static_cast<float*>(h),
      static_cast<signed char*>(codes), static_cast<float*>(row_scale),
      stream));
}

// `depth` w8a8 blocks back to back: block 0 reads x and writes out, every
// later block updates out in place (a block reads its input for the last
// time in the proj GEMM, before the down GEMM writes its output). `params`
// holds depth x 17 (or 18) pointers, block after block. Same shapes and
// scratch as dm_block_forward_q8.
int dm_chain_forward_q8(const void* x, void* out, int B, int N, int C, int H,
                        int hidden, int depth, const void* const* params,
                        int static_scales, void* qkv, void* att, void* r,
                        void* h, void* codes, void* row_scale,
                        cudaStream_t stream) {
  const int width = static_scales != 0 ? 18 : 17;
  for (int i = 0; i < depth; ++i) {
    const void* in = i == 0 ? x : out;
    const int err = dm_block_forward_q8(in, out, B, N, C, H, hidden,
                                        params + width * i, static_scales,
                                        qkv, att, r, h, codes, row_scale,
                                        stream);
    if (err != 0) return err;
  }
  return 0;
}

}  // extern "C"
