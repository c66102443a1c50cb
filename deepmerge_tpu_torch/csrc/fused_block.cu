// One pre-LN transformer block (kernel K2) and a stage of blocks run back to
// back (kernel K3), bf16 in and out, for Hopper (sm_90a).
//
// Replaces the TPU kernels deepmerge_tpu/ops/pallas/fused_block.py
// `_block_kernel` (math `_block_math`, called through
// `_fused_block_forward`) and the bf16 branch of `_chain_kernel` (called
// through `_fused_chain_forward`). The math, with its bf16 rounding points:
//   y   = bf16(LN1(x))                              LN in f32, eps 1e-5
//   qkv = bf16(bf16(y·Wqkv) + bq)                   f32 accumulation
//   a   = per head: softmax(q·d^-½·kᵀ + bias[h]) · v, the 1/Σe applied
//         after e·v, e rounded to bf16 for the value product
//   r   = bf16(x + bf16(bf16(a·Wproj) + bp))
//   h   = bf16(gelu_tanh(r'·Wup + bu)),  r' = bf16(LN2(r)), GELU in f32
//   out = bf16(r + bf16(bf16(h·Wdn) + bd))
//
// Bound on the H100: the four GEMMs (about 2.7 GFLOP per 192-token sample)
// make the block compute-bound. The TPU kernel keeps the whole block and
// every weight in 120 MB of VMEM; a 192-token bf16 activation alone is
// 288 KB a sample, more than an SM's 227 KB of shared memory, so the design
// here is a fixed sequence of seven launches from one C entry point, with
// the intermediates in device memory (about 2.7 GB of traffic per stage-0
// block at 1024 samples, well under the GEMM time):
//   LN1 → qkv GEMM → attention core → proj GEMM (+residual) → LN2 →
//   up GEMM (+GELU) → down GEMM (+residual).
// * The GEMMs share one tiled kernel: 128x128x64 tiles, bf16 tensor-core
//   MMAs (WMMA 16x16x16) with f32 accumulation, a three-stage cp.async
//   pipeline, and an epilogue that applies the bias, the casts and the GELU
//   or residual of its call.
// * LayerNorm is its own row kernel writing bf16 y. Normalizing inside the
//   GEMM's A loads (the first design) redid the work for every column tile
//   (18 of them for qkv, 24 for up) and cost the registers of a second CTA
//   per SM: those GEMMs ran at a third of the others' rate.
// * The attention core runs one CTA per (head, sample): K and V of the head
//   in shared memory, read straight out of the packed qkv; each warp takes
//   16 queries at a time, forms the logits with tensor-core MMAs, applies
//   the softmax in f32 and the value product with tensor-core MMAs.
// The chain entry point runs `depth` blocks on one activation buffer;
// keeping the activation on chip between blocks, and wgmma/TMA GEMMs, are
// later work.
//
// The helpers and the attention core live in block_common.cuh, shared
// with the w8a8 kernels (fused_block_q8.cu).

#include "block_common.cuh"

namespace {

// ------------------------------------------------------------- LayerNorm

// y = bf16((x - mean) * rsqrt(var + eps) * w + b) per row, statistics in
// f32 (two passes, as the TPU kernel's `_ln`). One warp per row.
__global__ void __launch_bounds__(kLnWarps * 32)
layer_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, bf16* __restrict__ y, int M,
                  int C) {
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
      const uint4 u = *reinterpret_cast<const uint4*>(xr + k);
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        v[i][t] = __bfloat162float(e[t]);
        s += v[i][t];
      }
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
#pragma unroll
  for (int i = 0; i < kLnMaxVec; ++i) {
    const int k = (lane + 32 * i) * 8;
    if (k < C) {
      uint4 u;
      bf16* o = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int t = 0; t < 8; ++t)
        o[t] = __float2bfloat16((v[i][t] - mu) * rs * w[k + t] + b[k + t]);
      *reinterpret_cast<uint4*>(y + row * C + k) = u;
    }
  }
}
// ------------------------------------------------------------------ GEMM

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3;
constexpr int kSK = kBK + 8;  // shared row stride (bf16): 144 B, 16 B aligned
constexpr int kTileElems = kBM * kSK;  // one operand tile (kBM == kBN)
constexpr int kGemmThreads = 256;      // 8 warps: 2 (rows) x 4 (cols)
constexpr size_t kGemmSmem =
    static_cast<size_t>(kStages) * 2 * kTileElems * sizeof(bf16);

enum Epilogue { kBiasCast = 0, kBiasResidual = 1, kBiasGelu = 2 };

// out[m, n] = epilogue(Σ_k A[m, k]·W[n, k]). A (M, K) and W (N, K) are
// row-major bf16 (W is nn.Linear's weight); K % 64 == 0 and N % 8 == 0
// (checked by the caller). Two CTAs of 108 KB fit one SM.
template <int kEpi>
__global__ void __launch_bounds__(kGemmThreads, 2)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
            const bf16* __restrict__ bias, const bf16* __restrict__ resid,
            bf16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  bf16* sm = reinterpret_cast<bf16*>(gemm_smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * kBN;
  const long long m0 = static_cast<long long>(blockIdx.y) * kBM;
  const int k_tiles = K / kBK;

  // a stage holds the A tile then the W tile; each thread issues four
  // 16-byte copies of each per K tile, zero-filling rows past M or N
  auto load_stage = [&](int stage, int kt) {
    bf16* as = sm + stage * 2 * kTileElems;
    bf16* bs = as + kTileElems;
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * kGemmThreads;
      const int r = c >> 3;
      const int kc = (c & 7) * 8;
      const long long gm = m0 + r;
      const bool in_m = gm < M;
      cp_async16(as + r * kSK + kc, in_m ? A + gm * K + k0 + kc : A, in_m);
      const int gn = n0 + r;
      const bool in_n = gn < N;
      cp_async16(bs + r * kSK + kc,
                 in_n ? W + static_cast<long long>(gn) * K + k0 + kc : W,
                 in_n);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int wm = warp >> 2;  // rows wm*64 .. +64
  const int wn = warp & 3;   // cols wn*32 .. +32

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed
    __syncthreads();               // ... and tile kt-1's stage is free
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(next % kStages, next);
    cp_async_commit();
    const bf16* as = sm + (kt % kStages) * 2 * kTileElems;
    const bf16* bs = as + kTileElems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], as + (wm * 64 + i * 16) * kSK + kk, kSK);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], bs + (wn * 32 + j * 16) * kSK + kk,
                               kSK);
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
  float* cs = reinterpret_cast<float*>(gemm_smem) + warp * 256;
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long gm = m0 + wm * 64 + i * 16 + er;
      const int gn = n0 + wn * 32 + j * 16 + ec;
      if (gm < M && gn < N) {
        const float* cv = cs + er * 16 + ec;
        const uint4 bv = *reinterpret_cast<const uint4*>(bias + gn);
        const bf16* bb = reinterpret_cast<const bf16*>(&bv);
        uint4 rv = zero;
        if constexpr (kEpi == kBiasResidual)
          rv = *reinterpret_cast<const uint4*>(resid + gm * N + gn);
        const bf16* rr = reinterpret_cast<const bf16*>(&rv);
        uint4 ov;
        bf16* o = reinterpret_cast<bf16*>(&ov);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          float y;
          if constexpr (kEpi == kBiasGelu) {
            y = gelu_tanh(cv[t] + __bfloat162float(bb[t]));
          } else {
            y = round_bf16(cv[t]) + __bfloat162float(bb[t]);
            if constexpr (kEpi == kBiasResidual)
              y = __bfloat162float(rr[t]) + round_bf16(y);
          }
          o[t] = __float2bfloat16(y);
        }
        *reinterpret_cast<uint4*>(out + gm * N + gn) = ov;
      }
      __syncwarp();
    }
  }
}

template <int kEpi>
cudaError_t gemm(const bf16* A, const bf16* W, const bf16* bias,
                 const bf16* resid, bf16* out, int M, int N, int K,
                 cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<kEpi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kGemmSmem));
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<kEpi><<<grid, kGemmThreads, kGemmSmem, stream>>>(
      A, W, bias, resid, out, M, N, K);
  return cudaGetLastError();
}

cudaError_t layer_norm(const bf16* x, const float* w, const float* b, bf16* y,
                       int M, int C, cudaStream_t stream) {
  layer_norm_kernel<<<(M + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0,
                      stream>>>(x, w, b, y, M, C);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- block

// Parameter order (13 pointers), as the TPU kernel's tuple: ln1 scale, ln1
// bias (f32 [C]), w_qkv (bf16 [3C, C]), b_qkv (bf16 [3C]), attention bias
// (f32 [H, N, N]), w_proj ([C, C]), b_proj, ln2 scale, ln2 bias, w_up
// ([hidden, C]), b_up, w_down ([C, hidden]), b_down. Weights are in
// nn.Linear's (out, in) layout.
constexpr int kParams = 13;

cudaError_t block_forward(const bf16* x, bf16* out, int B, int N, int C,
                          int H, int hidden, const void* const* p, bf16* qkv,
                          bf16* att, bf16* r, bf16* hbuf,
                          cudaStream_t stream) {
  const auto* l1s = static_cast<const float*>(p[0]);
  const auto* l1b = static_cast<const float*>(p[1]);
  const auto* wq = static_cast<const bf16*>(p[2]);
  const auto* bq = static_cast<const bf16*>(p[3]);
  const auto* bias = static_cast<const float*>(p[4]);
  const auto* wp = static_cast<const bf16*>(p[5]);
  const auto* bp = static_cast<const bf16*>(p[6]);
  const auto* l2s = static_cast<const float*>(p[7]);
  const auto* l2b = static_cast<const float*>(p[8]);
  const auto* wu = static_cast<const bf16*>(p[9]);
  const auto* bu = static_cast<const bf16*>(p[10]);
  const auto* wd = static_cast<const bf16*>(p[11]);
  const auto* bd = static_cast<const bf16*>(p[12]);
  const int M = B * N;
  bf16* y = att;  // the LN outputs live in the attention buffer: each is
                  // consumed by its GEMM before the buffer is written again
  cudaError_t e;

  if ((e = layer_norm(x, l1s, l1b, y, M, C, stream)) != cudaSuccess) return e;
  e = gemm<kBiasCast>(y, wq, bq, nullptr, qkv, M, 3 * C, C, stream);
  if (e != cudaSuccess) return e;

  if ((e = attention(qkv, bias, att, B, N, C, H, stream)) != cudaSuccess)
    return e;

  e = gemm<kBiasResidual>(att, wp, bp, x, r, M, C, C, stream);
  if (e != cudaSuccess) return e;
  if ((e = layer_norm(r, l2s, l2b, y, M, C, stream)) != cudaSuccess) return e;
  e = gemm<kBiasGelu>(y, wu, bu, nullptr, hbuf, M, hidden, C, stream);
  if (e != cudaSuccess) return e;
  return gemm<kBiasResidual>(hbuf, wd, bd, r, out, M, C, hidden, stream);
}

}  // namespace

extern "C" {

const char* dm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One block: out = block(x). x and out are (B, N, C) bf16 and must not
// overlap. Scratch: qkv (B·N, 3C), att (B·N, C), r (B·N, C), h (B·N,
// hidden), all bf16. Requires C == H·64, C % 64 == 0, C <= 1024,
// hidden % 64 == 0 and N <= 256 (checked by the caller). Returns
// cudaGetLastError().
int dm_block_forward(const void* x, void* out, int B, int N, int C, int H,
                     int hidden, const void* const* params, void* qkv,
                     void* att, void* r, void* h, cudaStream_t stream) {
  return static_cast<int>(block_forward(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), B, N, C, H, hidden,
      params, static_cast<bf16*>(qkv), static_cast<bf16*>(att),
      static_cast<bf16*>(r), static_cast<bf16*>(h), stream));
}

// `depth` blocks back to back: block 0 reads x and writes out, every later
// block updates out in place (a block reads its input for the last time in
// the proj GEMM, before the down GEMM writes its output). `params` holds
// depth x 13 pointers, block after block. Same shapes and scratch as
// dm_block_forward.
int dm_chain_forward(const void* x, void* out, int B, int N, int C, int H,
                     int hidden, int depth, const void* const* params,
                     void* qkv, void* att, void* r, void* h,
                     cudaStream_t stream) {
  for (int i = 0; i < depth; ++i) {
    const void* in = i == 0 ? x : out;
    const int err = dm_block_forward(in, out, B, N, C, H, hidden,
                                     params + kParams * i, qkv, att, r, h,
                                     stream);
    if (err != 0) return err;
  }
  return 0;
}

}  // extern "C"
