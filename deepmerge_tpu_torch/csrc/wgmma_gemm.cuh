// The warp-specialized TMA + wgmma GEMM of the block kernels, written once
// for K2/K3/K5's bf16 GEMM (fused_block.cu), K4's s8 GEMM
// (fused_block_q8.cu) and K10's integer dot (int4_dot.cuh, which also feeds
// its consumers from a converter warpgroup): out (M, N) = epilogue(A (M, K)
// · W (N, K)ᵀ), both
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
// * Any K whose rows are a multiple of 16 bytes (TMA's stride): the last
//   slab of a K that is not a multiple of the slab reads its lanes past K
//   as zeros in A and in W (the tensor maps' true K extent), which add
//   nothing to the sums; TMA counts the whole box in its transaction bytes.
// The epilogue is the caller's functor: `epi.store(d, row, n0, tig, M, N)`
// with the thread's accumulators, its first row (the second is row + 8),
// the tile's first column and the thread's index in its quad.

#pragma once

#include "hopper.cuh"  // mbarriers, TMA, wgmma

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

// d (64 x 256 s32 over the warpgroup) += A (64 x 32) · W (256 x 32)ᵀ, int8,
// both K-major in shared memory.
struct MmaS8 {
  using Acc = int;
  static constexpr int kSlabK = kSlabBytes;  // 128 int8 values
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

// The consumer warpgroups' side of the GEMM (warps 0..4·kGemmConsumers-1
// of the CTA): for each of the CTA's output tiles, wgmma over the K slabs
// of the ring `smem` (stage s: A's kGemmBM rows, then W's kGemmBN, in
// 128-byte swizzled slabs) as each stage's `full` barrier completes,
// releasing each stage on `empty` once its products are done, then the
// epilogue. Shared with the probe's widened-operand kernel (int4_dot.cuh).
template <class Mma, int kStages, class Epi>
__device__ __forceinline__ void gemm_consume(const unsigned char* smem,
                                             uint64_t* full, uint64_t* empty,
                                             const Epi& epi, int M, int N,
                                             int K) {
  using Acc = typename Mma::Acc;
  constexpr int kABytes = kGemmBM * kSlabBytes;
  constexpr int kStageBytes = (kGemmBM + kGemmBN) * kSlabBytes;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k_tiles = (K + Mma::kSlabK - 1) / Mma::kSlabK;
  const int tiles_n = (N + kGemmBN - 1) / kGemmBN;
  const int tiles = tiles_n * ((M + kGemmBM - 1) / kGemmBM);
  auto tile_of = [&](int j) {
    return static_cast<int>(blockIdx.x + j * gridDim.x);
  };
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
  const int k_tiles = (K + Mma::kSlabK - 1) / Mma::kSlabK;
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

  gemm_consume<Mma, kStages>(smem, full, empty, epi, M, N, K);
}

// The tensor map of a row-major (rows, K) matrix of `type` (elements of
// `elem` bytes) read in boxes of `box_rows` rows x `box_bytes` bytes (128
// by default, the GEMM's slab) with `swizzle`; out-of-range rows and
// columns read as 0.
inline cudaError_t tensor_map(
    CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem,
    long long rows, long long K, int box_rows, int box_bytes = kSlabBytes,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_bytes / elem),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides,
                        box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launches the GEMM with A (M, K) and W (N, K) of `type`, a persistent
// grid of one CTA an SM (or one a tile, if fewer). K·elem must be a
// multiple of 16 bytes (K % 8 in bf16, K % 16 in int8), N % 8 == 0.
template <class Mma, int kStages, class Epi>
cudaError_t wgmma_gemm(const void* A, const void* W, CUtensorMapDataType type,
                       int elem, const Epi& epi, int M, int N, int K,
                       cudaStream_t stream) {
  if (K < 1 || (K * elem) % 16 != 0 || N % 8 != 0 || M < 1)
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
