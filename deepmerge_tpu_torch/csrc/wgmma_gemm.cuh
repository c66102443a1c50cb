// The warp-specialized TMA + wgmma GEMM of the block kernels, written once
// for K2/K3/K5's bf16 GEMM (fused_block.cu) and K4's s8 GEMM
// (fused_block_q8.cu): out (M, N) = epilogue(A (M, K) · W (N, K)ᵀ), both
// operands row-major and K-major, as wgmma reads them from shared memory.
//
// * TMA loads 128-byte-deep K slabs of A and W (64 bf16 or 128 int8 values
//   a row, the 128-byte swizzle's row) into a ring of stages, each
//   completing on its `full` mbarrier; one producer warp keeps the ring
//   full and waits on each stage's `empty` barrier before refilling it.
// * Two consumer warpgroups issue wgmma m64n256 on the stages (four k steps
//   of 32 bytes a slab; the descriptor advances 32 bytes a step within the
//   swizzle atom) and release the stage before last once one wgmma group
//   is left in flight. Accumulators: 128 registers a thread, f32 or s32.
// * 128x256 output tiles, each warpgroup 64 rows of every tile (the
//   cooperative schedule). The grid is persistent: each CTA walks output
//   tiles blockIdx.x, blockIdx.x + gridDim.x, ... and the producer runs on
//   into the next tile's slabs during an epilogue. (A ping-pong schedule,
//   each warpgroup its own 64x256 tiles so that one's epilogue runs under
//   the other's products, was slower on all four s8 shapes of a block on
//   an H100: its 64-row tiles read each W slab twice as often.)
// The epilogue is the caller's functor: `epi.store(d, row, n0, tig, M, N)`
// with the thread's accumulators, its first row (the second is row + 8),
// the tile's first column and the thread's index in its quad.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (no link against libcuda)

#include "block_common.cuh"

namespace {

constexpr int kGemmBM = 128;          // output tile rows, 64 a warpgroup
constexpr int kGemmBN = 256;          // output tile columns (wgmma n256)
constexpr int kSlabBytes = 128;       // a K slab's row: the swizzle's row
constexpr int kGemmConsumers = 2;     // warpgroups
constexpr int kGemmThreads = kGemmConsumers * 128 + 32;  // + producer warp

// Shared bytes of a GEMM with `stages` stages: the ring, 1 KB for aligning
// it to the swizzle's 1024 bytes, the barriers.
__host__ __device__ constexpr int gemm_smem_bytes(int stages) {
  return stages * (kGemmBM + kGemmBN) * kSlabBytes + 1024 + 2 * stages * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA load of a (box rows) x 128-byte tile at (column c0, row c1) of a
// 2-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle
// (TMA's CU_TENSOR_MAP_SWIZZLE_128B): rows of 128 B, 8-row groups 1024 B
// apart; the tile starts on 1024 B. Adding 2 to the descriptor advances
// its start by 32 B, one k step (16 bf16 or 32 int8 values) within the
// swizzle atom.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving the accumulators across the asynchronous
// wgmma issue and wait.
__device__ __forceinline__ void fence_acc(float (&d)[kGemmBN / 2]) {
#pragma unroll
  for (int i = 0; i < kGemmBN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_acc(int (&d)[kGemmBN / 2]) {
#pragma unroll
  for (int i = 0; i < kGemmBN / 2; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The GEMM (see the head of this file). Mma supplies the accumulator type
// `Acc`, the values of a K slab `kSlabK` and `mma(d, da, db)`, one wgmma
// m64n256 k step with accumulator layout: warp w of the group holds rows
// 16w + lane/4 (d[4i], d[4i+1]) and + 8 (d[4i+2], d[4i+3]), columns
// 8i + 2·(lane%4) and + 1. Rows past M and columns past N read as zeros
// (TMA's out-of-range fill); the epilogue masks them.
template <class Mma, int kStages, class Epi>
__global__ void __launch_bounds__(kGemmThreads, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_w, const Epi epi,
                  int M, int N, int K) {
  using Acc = typename Mma::Acc;
  constexpr int kABytes = kGemmBM * kSlabBytes;
  constexpr int kStageBytes = (kGemmBM + kGemmBN) * kSlabBytes;
  extern __shared__ unsigned char gemm_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gemm_smem_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k_tiles = K / Mma::kSlabK;
  const int tiles_n = (N + kGemmBN - 1) / kGemmBN;
  const int tiles = tiles_n * ((M + kGemmBM - 1) / kGemmBM);
  auto tile_of = [&](int j) {
    return static_cast<int>(blockIdx.x + j * gridDim.x);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kGemmConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The producer: the CTA's tiles in order (row-block major, so that
  // neighbouring CTAs share A's rows), `it` counting K slabs over all of
  // them, so the ring runs on from one tile into the next.
  if (warp == kGemmConsumers * 4) {
    if (lane == 0) {
      int it = 0;
      for (int j = 0; tile_of(j) < tiles; ++j) {
        const int m0 = (tile_of(j) / tiles_n) * kGemmBM;
        const int n0 = (tile_of(j) % tiles_n) * kGemmBN;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          unsigned char* st = smem + s * kStageBytes;
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load_2d(st, &map_a, &full[s], kt * Mma::kSlabK, m0);
          tma_load_2d(st + kABytes, &map_w, &full[s], kt * Mma::kSlabK, n0);
        }
      }
    }
    return;
  }

  const int row_off = (warp >> 2) * 64;  // the group's rows of a tile
  Acc d[kGemmBN / 2];
  for (int j = 0; tile_of(j) < tiles; ++j) {
    const int m0 = (tile_of(j) / tiles_n) * kGemmBM;
    const int n0 = (tile_of(j) % tiles_n) * kGemmBN;
    int it = j * k_tiles;
#pragma unroll
    for (int i = 0; i < kGemmBN / 2; ++i) d[i] = 0;
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const unsigned char* st = smem + s * kStageBytes;
      const uint64_t da = wgmma_desc(st + row_off * kSlabBytes);
      const uint64_t db = wgmma_desc(st + kABytes);
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSlabBytes / 32; ++kk)
        Mma::mma(d, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      fence_acc(d);
      if (kt > 0) {
        wgmma_wait<1>();  // the previous slab's products are done
        fence_acc(d);
        mbar_arrive(&empty[(it - 1) % kStages]);
      }
    }
    wgmma_wait<0>();
    fence_acc(d);
    mbar_arrive(&empty[(it - 1) % kStages]);
    epi.store(d, m0 + row_off + (warp & 3) * 16 + (lane >> 2), n0, lane & 3,
              M, N);
  }
}

// cuTensorMapEncodeTiled, a driver call, reached through the runtime's
// entry-point query (no link against libcuda).
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The tensor map of a row-major (rows, K) matrix of `type` (elements of
// `elem` bytes) read in boxes of `box_rows` rows x 128 bytes with the
// 128-byte swizzle; out-of-range rows and columns read as 0.
inline cudaError_t tensor_map(CUtensorMap* map, const void* base,
                              CUtensorMapDataType type, int elem, int rows,
                              int K, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kSlabBytes / elem),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides,
                        box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launches the GEMM with A (M, K) and W (N, K) of `type`, a persistent
// grid of one CTA an SM (or one a tile, if fewer).
template <class Mma, int kStages, class Epi>
cudaError_t wgmma_gemm(const void* A, const void* W, CUtensorMapDataType type,
                       int elem, const Epi& epi, int M, int N, int K,
                       cudaStream_t stream) {
  if (K % Mma::kSlabK != 0 || N % 8 != 0 || M < 1)
    return cudaErrorInvalidValue;
  constexpr int kSmem = gemm_smem_bytes(kStages);
  CUtensorMap map_a, map_w;
  cudaError_t e = tensor_map(&map_a, A, type, elem, M, K, kGemmBM);
  if (e != cudaSuccess) return e;
  if ((e = tensor_map(&map_w, W, type, elem, N, K, kGemmBN)) != cudaSuccess)
    return e;
  auto* kern = wgmma_gemm_kernel<Mma, kStages, Epi>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  int device = 0, sms = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const long long tiles =
      static_cast<long long>((N + kGemmBN - 1) / kGemmBN) *
      ((M + kGemmBM - 1) / kGemmBM);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kern<<<grid, kGemmThreads, kSmem, stream>>>(map_a, map_w, epi, M, N, K);
  return cudaGetLastError();
}

}  // namespace
