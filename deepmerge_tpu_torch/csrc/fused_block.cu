// One pre-LN transformer block (kernel K2), a stage of blocks run back to
// back (kernel K3) and the saved-activation training block (kernel K5), bf16
// in and out, for Hopper (sm_90a).
//
// Replaces the TPU kernels deepmerge_tpu/ops/pallas/fused_block.py
// `_block_kernel` (math `_block_math`, called through
// `_fused_block_forward`), the bf16 branch of `_chain_kernel` (called
// through `_fused_chain_forward`) and `_block_kernel_train` (math
// `_block_math_train`, called through `_fused_block_train_forward`). The
// math, with its bf16 rounding points:
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
// * The GEMMs share one warp-specialized kernel (wgmma_gemm.cuh, written
//   once for this file and K4's s8 GEMM): 128x256 output tiles, TMA loads
//   of 64-wide K slabs (128-byte swizzle) into a 4-stage ring of mbarriers
//   filled by one producer warp, two consumer warpgroups issuing wgmma
//   m64n256k16 (bf16 in, f32 accumulators) straight from shared memory,
//   and an epilogue from the accumulators that applies the bias, the casts
//   and the GELU or residual of its call. The grid is persistent (one
//   193 KB CTA an SM), so the producer loads the next tile's slabs during
//   an epilogue.
// * LayerNorm is its own row kernel writing bf16 y. Normalizing inside the
//   GEMM's A loads (the first design) redid the work for every column tile
//   (18 of them for qkv, 24 for up) and cost the registers of a second CTA
//   per SM: those GEMMs ran at a third of the others' rate.
// * The attention core (block_common.cuh): a CTA of four warps per head
//   and one to four samples, K and V in shared memory, the logits, the
//   softmax and P in mma.sync registers.
// The chain entry point runs `depth` blocks on one activation buffer;
// keeping the activation on chip between blocks is later work.
//
// K5 (`dm_block_train_forward`) is K2's sequence with three changes, and
// also writes what the backward (plain torch, the JAX package's
// `_fused_block_bwd`) reads instead of recomputing it:
// * qkv and r are outputs, not scratch;
// * the attention core normalizes before the value product, as
//   `_block_math_train` does, p = bf16(e·(1/Σe)), a = bf16(p·v), and also
//   stores p (kProbs with kNormFirst) in K6's (B, H, N, N) layout;
// * the up GEMM's epilogue also writes the pre-GELU gin = r'·Wup + bu,
//   rounded to bf16 (the GELU itself takes the f32 value).
// Its bound is K2's GEMM work plus the residuals' bytes: at B 240, N 192
// the probabilities alone are 212 MB a block, 0.06 ms at the memory rate
// against about 0.7 ms of GEMMs.
//
// The helpers and the attention core live in block_common.cuh, shared
// with the w8a8 kernels (fused_block_q8.cu).

#include "wgmma_gemm.cuh"

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

// Launch plan of the GEMM (ops/kernels/fused_block.py `gemm_plan` computes
// the same numbers and passes them in; the entry points refuse a plan that
// differs): wgmma_gemm.cuh's GEMM, 128x256 output tiles, 64-wide K slabs (128 bytes of bf16, the 128-byte swizzle's row) in
// a 4-stage ring, two consumer warpgroups of 64 rows each and one producer
// warp; 193 KB of shared memory and a persistent grid of one CTA an SM.
constexpr int kBK = 64, kStages = 4;
constexpr int kGemmSmem = gemm_smem_bytes(kStages);

enum Epilogue {
  kBiasCast = 0,
  kBiasResidual = 1,
  kBiasGelu = 2,
  kBiasGeluSave = 3,  // kBiasGelu that also writes bf16(acc + bias) to aux
};

// d (64 x 256 f32 over the warpgroup) += A (64 x 16) · W (256 x 16)ᵀ, bf16,
// both K-major in shared memory.
struct MmaBf16 {
  using Acc = float;
  static constexpr int kSlabK = kBK;
  static __device__ __forceinline__ void mma(float (&d)[kGemmBN / 2],
                                             uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87,"
        " %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103,"
        " %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119,"
        " %120, %121, %122, %123, %124, %125, %126, %127},"
        " %128, %129, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <int kEpi>
__device__ __forceinline__ void epilogue_pair(float c0, float c1, uint32_t bb,
                                              uint32_t rr, bf16* out,
                                              bf16* aux, long long off) {
  const float2 bv =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bb));
  float y0, y1;
  if constexpr (kEpi == kBiasGelu || kEpi == kBiasGeluSave) {
    const float g0 = c0 + bv.x, g1 = c1 + bv.y;
    if constexpr (kEpi == kBiasGeluSave)
      *reinterpret_cast<__nv_bfloat162*>(aux + off) =
          __floats2bfloat162_rn(g0, g1);
    y0 = gelu_tanh(g0);
    y1 = gelu_tanh(g1);
  } else {
    y0 = round_bf16(c0) + bv.x;
    y1 = round_bf16(c1) + bv.y;
    if constexpr (kEpi == kBiasResidual) {
      const float2 rv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rr));
      y0 = rv.x + round_bf16(y0);
      y1 = rv.y + round_bf16(y1);
    }
  }
  *reinterpret_cast<__nv_bfloat162*>(out + off) = __floats2bfloat162_rn(y0, y1);
}

// The bf16 epilogue from the accumulators: the bias, the casts and the GELU
// or residual of its call, an eighth of a tile's columns at a time, the
// residual pairs loaded first so that their loads are in flight together
// (rows past M and columns past N clamped for the loads, masked for the
// stores). aux (M, N) is written by kBiasGeluSave only.
template <int kEpi>
struct EpiBf16 {
  const bf16* bias;
  const bf16* resid;
  bf16* out;
  bf16* aux;

  __device__ __forceinline__ void store(const float (&d)[kGemmBN / 2],
                                        long long row_a, int n0, int tig,
                                        int M, int N) const {
    const long long la = (row_a < M ? row_a : M - 1) * N;
    const long long lb = (row_a + 8 < M ? row_a + 8 : M - 1) * N;
#pragma unroll
    for (int part = 0; part < 8; ++part) {
      constexpr int kCols = kGemmBN / 64;  // column pairs per eighth
      uint32_t ra[kCols], rb[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = n0 + (part * kCols + c) * 8 + 2 * tig;
        const int cc = col < N ? col : N - 2;
        if constexpr (kEpi == kBiasResidual) {
          ra[c] = *reinterpret_cast<const uint32_t*>(resid + la + cc);
          rb[c] = *reinterpret_cast<const uint32_t*>(resid + lb + cc);
        } else {
          ra[c] = rb[c] = 0u;
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int i = part * kCols + c;
        const int col = n0 + i * 8 + 2 * tig;
        if (col < N) {
          const uint32_t bb = *reinterpret_cast<const uint32_t*>(bias + col);
          if (row_a < M)
            epilogue_pair<kEpi>(d[4 * i], d[4 * i + 1], bb, ra[c], out, aux,
                                row_a * N + col);
          if (row_a + 8 < M)
            epilogue_pair<kEpi>(d[4 * i + 2], d[4 * i + 3], bb, rb[c], out,
                                aux, (row_a + 8) * N + col);
        }
      }
    }
  }
};

// The GEMM part of a launch plan, as gemm_plan writes it.
inline bool gemm_plan_ok(const int* p) {
  return p[0] == kGemmBM && p[1] == kGemmBN && p[2] == kBK && p[3] == kStages &&
         p[4] == kGemmThreads && p[5] == kGemmSmem;
}

// out[m, n] = epilogue(Σ_k A[m, k]·W[n, k]). A (M, K) and W (N, K) are
// row-major bf16 (W is nn.Linear's weight); K % 64 == 0, N % 8 == 0 and
// 16-byte aligned bases (checked by the caller).
template <int kEpi>
cudaError_t gemm(const bf16* A, const bf16* W, const bf16* bias,
                 const bf16* resid, bf16* out, int M, int N, int K,
                 cudaStream_t stream, bf16* aux = nullptr) {
  const EpiBf16<kEpi> epi{bias, resid, out, aux};
  return wgmma_gemm<MmaBf16, kStages>(
      A, W, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(bf16), epi, M, N, K,
      stream);
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

// A block's launch plan (ops/kernels/fused_block.py `block_plan`) holds the
// attention core's kAttnPlanInts, then the GEMM's six (gemm_plan_ok).
cudaError_t block_forward(const bf16* x, bf16* out, int B, int N, int C,
                          int H, int hidden, const void* const* p, bf16* qkv,
                          bf16* att, bf16* r, bf16* hbuf, const int* plan,
                          cudaStream_t stream) {
  if (!gemm_plan_ok(plan + kAttnPlanInts)) return cudaErrorInvalidValue;
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

  if ((e = attention(qkv, bias, att, B, N, C, H, plan, stream)) !=
      cudaSuccess)
    return e;

  e = gemm<kBiasResidual>(att, wp, bp, x, r, M, C, C, stream);
  if (e != cudaSuccess) return e;
  if ((e = layer_norm(r, l2s, l2b, y, M, C, stream)) != cudaSuccess) return e;
  e = gemm<kBiasGelu>(y, wu, bu, nullptr, hbuf, M, hidden, C, stream);
  if (e != cudaSuccess) return e;
  return gemm<kBiasResidual>(hbuf, wd, bd, r, out, M, C, hidden, stream);
}

// K5: block_forward that keeps qkv, the normalized probabilities (B, H, N,
// N), the pre-GELU gin (B·N, hidden) and r, all bf16, for the backward.
cudaError_t block_train_forward(const bf16* x, bf16* out, int B, int N,
                                int C, int H, int hidden,
                                const void* const* p, bf16* qkv, bf16* probs,
                                bf16* gin, bf16* r, bf16* att, bf16* hbuf,
                                const int* plan, cudaStream_t stream) {
  if (!gemm_plan_ok(plan + kAttnPlanInts)) return cudaErrorInvalidValue;
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
  bf16* y = att;  // as in block_forward
  cudaError_t e;

  if ((e = layer_norm(x, l1s, l1b, y, M, C, stream)) != cudaSuccess) return e;
  e = gemm<kBiasCast>(y, wq, bq, nullptr, qkv, M, 3 * C, C, stream);
  if (e != cudaSuccess) return e;
  e = attention_launch<true, true>(qkv, qkv + C, qkv + 2 * C, 3LL * C, bias,
                                   att, probs, B, N, C, H, plan, stream);
  if (e != cudaSuccess) return e;
  e = gemm<kBiasResidual>(att, wp, bp, x, r, M, C, C, stream);
  if (e != cudaSuccess) return e;
  if ((e = layer_norm(r, l2s, l2b, y, M, C, stream)) != cudaSuccess) return e;
  e = gemm<kBiasGeluSave>(y, wu, bu, nullptr, hbuf, M, hidden, C, stream,
                          gin);
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
// hidden % 64 == 0, N <= 256 and 16-byte aligned tensors (checked by the
// caller); `plan` is the wrapper's launch plan (`block_plan`), and a plan
// the kernels do not take is refused. Returns cudaGetLastError().
int dm_block_forward(const void* x, void* out, int B, int N, int C, int H,
                     int hidden, const void* const* params, void* qkv,
                     void* att, void* r, void* h, const int* plan,
                     cudaStream_t stream) {
  return static_cast<int>(block_forward(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), B, N, C, H, hidden,
      params, static_cast<bf16*>(qkv), static_cast<bf16*>(att),
      static_cast<bf16*>(r), static_cast<bf16*>(h), plan, stream));
}

// `depth` blocks back to back: block 0 reads x and writes out, every later
// block updates out in place (a block reads its input for the last time in
// the proj GEMM, before the down GEMM writes its output). `params` holds
// depth x 13 pointers, block after block. Same shapes, scratch and plan as
// dm_block_forward.
int dm_chain_forward(const void* x, void* out, int B, int N, int C, int H,
                     int hidden, int depth, const void* const* params,
                     void* qkv, void* att, void* r, void* h, const int* plan,
                     cudaStream_t stream) {
  for (int i = 0; i < depth; ++i) {
    const void* in = i == 0 ? x : out;
    const int err = dm_block_forward(in, out, B, N, C, H, hidden,
                                     params + kParams * i, qkv, att, r, h,
                                     plan, stream);
    if (err != 0) return err;
  }
  return 0;
}

// K5, the training forward of one block: out = block(x) with the attention
// normalized before its value product, and the backward's residuals: qkv
// (B·N, 3C), probs (B, H, N, N), gin (B·N, hidden) and r (B·N, C), bf16.
// Scratch: att (B·N, C), h (B·N, hidden), bf16. Same requirements and plan
// as dm_block_forward; no two buffers overlap.
int dm_block_train_forward(const void* x, void* out, int B, int N, int C,
                           int H, int hidden, const void* const* params,
                           void* qkv, void* probs, void* gin, void* r,
                           void* att, void* h, const int* plan,
                           cudaStream_t stream) {
  return static_cast<int>(block_train_forward(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), B, N, C, H,
      hidden, params, static_cast<bf16*>(qkv), static_cast<bf16*>(probs),
      static_cast<bf16*>(gin), static_cast<bf16*>(r), static_cast<bf16*>(att),
      static_cast<bf16*>(h), plan, stream));
}

// K2's GEMM alone (its measurement and tests): out (M, N) = epilogue
// `epi` (0 kBiasCast, 1 kBiasResidual, 2 kBiasGelu, 3 kBiasGeluSave) of
// A (M, K) · W (N, K)ᵀ with bias (N), resid (M, N) for kBiasResidual and
// aux (M, N) for kBiasGeluSave, all bf16. `plan` is the GEMM's
// six ints (ops/kernels/fused_block.py `gemm_plan`). Requires
// K % 64 == 0, N % 8 == 0 and 16-byte aligned tensors (checked by the
// caller). Returns cudaGetLastError().
int dm_gemm(const void* a, const void* w, const void* bias, const void* resid,
            void* out, void* aux, int M, int N, int K, int epi,
            const int* plan, cudaStream_t stream) {
  if (!gemm_plan_ok(plan)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* A = static_cast<const bf16*>(a);
  const auto* W = static_cast<const bf16*>(w);
  const auto* b = static_cast<const bf16*>(bias);
  const auto* rr = static_cast<const bf16*>(resid);
  auto* o = static_cast<bf16*>(out);
  switch (epi) {
    case kBiasCast:
      return static_cast<int>(gemm<kBiasCast>(A, W, b, rr, o, M, N, K, stream));
    case kBiasResidual:
      return static_cast<int>(
          gemm<kBiasResidual>(A, W, b, rr, o, M, N, K, stream));
    case kBiasGelu:
      return static_cast<int>(gemm<kBiasGelu>(A, W, b, rr, o, M, N, K, stream));
    case kBiasGeluSave:
      return static_cast<int>(gemm<kBiasGeluSave>(
          A, W, b, rr, o, M, N, K, stream, static_cast<bf16*>(aux)));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
