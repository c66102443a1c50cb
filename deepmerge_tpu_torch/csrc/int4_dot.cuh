// The int4 dot probe (kernel K10): int32 C (M, N) = A (M, K) · B (K, N) on
// integer operands, on the s8 wgmma GEMM of wgmma_gemm.cuh for every
// operand mix.
//
// Replaces the TPU kernel tools/int4_dot_probe.py `_mk`'s `kern` (its
// pallas_call at :50), whose question is whether an int4 rate makes a w4a8
// MLP worth having, at the MLP's shape (M 4096, K 768, N 3072). Hopper's
// tensor cores have no int4 rate: wgmma has no int4 form, and mma.sync's
// m16n8k64 s4 ran at 36 TOP/s on an H100 (against 1,979 TOP/s of s8
// wgmma). So each variant multiplies int8 on wgmma m64n256k32 in 128x256
// output tiles, persistent CTAs and a ring of 128-value K slabs fed by TMA:
//   kS8S8  A and Bᵀ int8: the GEMM as K4 runs it (a producer warp, four
//          stages), with an epilogue that stores the s32 sums;
//   kS8S4  Bᵀ packed two int4 a byte (the w4a8 product), and
//   kS4S4  both packed: TMA brings a packed operand's slab (64 bytes a row)
//          into the upper half of its s8 slab's room in the stage, and a
//          converter warpgroup sign-extends it with byte permutes into the
//          128-byte-swizzled s8 slab that the consumers' descriptors read
//          (every packed piece loaded into registers before any widened
//          one is stored), fences its writes to the async proxy and
//          arrives on the stage's `full` barrier. Its thread 0 also issues
//          the TMA loads, three slabs ahead of the one it converts (K4's
//          four stages). The CTA is three warpgroups at 168 registers a
//          thread, which hold the consumers' 128 s32 accumulators (K4's
//          GEMM takes 154).
// PTX has no mixed-operand (s8 x s4) product; kS8S4 is how Hopper runs a
// w4a8 MLP's GEMM, its weights read in half the bytes.
//
// Layout: A row-major (M, Ka bytes), B as Bᵀ row-major (N, Kb bytes), K
// contiguous in both, nibble pairs low first (even k in the low nibble).
// Bound at the probe's shape: the int32 output (50 MB) over the memory
// rate, about 16 us, above the 19.3 G operations' 10 us at the int8 peak.

#pragma once

#include "wgmma_gemm.cuh"  // the GEMM, MmaS8, hopper.cuh

namespace {
namespace int_dot {

enum Variant { kS8S8 = 0, kS4S4 = 1, kS8S4 = 2 };

constexpr int kStagesS8 = 4;                // kS8S8's ring (K4's GEMM)
constexpr int kWideStages = 4;
constexpr int kPackedRow = kSlabBytes / 2;  // a packed slab's row: 64 B
constexpr int kConvThreads = 128;           // the converter warpgroup
constexpr int kWideThreads = kGemmConsumers * 128 + kConvThreads;

// The s32 sums as they are, int32 (M, N): rows past M and columns past N
// masked.
struct EpiI32 {
  int* c;

  __device__ __forceinline__ void store(const int (&d)[kGemmBN / 2],
                                        long long row_a, int n0, int tig,
                                        int M, int N) const {
    const long long row_b = row_a + 8;
#pragma unroll
    for (int i = 0; i < kGemmBN / 8; ++i) {
      const int col = n0 + i * 8 + 2 * tig;
      if (col >= N) continue;
      if (row_a < M)
        *reinterpret_cast<int2*>(c + row_a * N + col) =
            make_int2(d[4 * i], d[4 * i + 1]);
      if (row_b < M)
        *reinterpret_cast<int2*>(c + row_b * N + col) =
            make_int2(d[4 * i + 2], d[4 * i + 3]);
    }
  }
};

// The CTA's shared bytes: the stages (A's 128 and Bᵀ's 256 rows of s8
// slab), 1 KB of alignment, three barriers a stage: 197,728 B.
constexpr int kWideSmem =
    kWideStages * (kGemmBM + kGemmBN) * kSlabBytes + 1024 +
    3 * kWideStages * 8;

// Four int4 values sign-extended in place: each byte holds one in its low
// nibble; bit 3 set fills the high nibble (0x08 · 0x1E = 0xF0, no carry).
__device__ __forceinline__ uint32_t sext4(uint32_t x) {
  return x | ((x & 0x08080808u) * 0x1Eu);
}

// 8 packed bytes (16 int4 values, the low nibble first) as 16 s8 values.
__device__ __forceinline__ uint4 widen16(uint2 p) {
  uint4 w;
  uint32_t lo = p.x & 0x0F0F0F0Fu, hi = (p.x >> 4) & 0x0F0F0F0Fu;
  w.x = sext4(__byte_perm(lo, hi, 0x5140));  // values 0..3
  w.y = sext4(__byte_perm(lo, hi, 0x7362));  // values 4..7
  lo = p.y & 0x0F0F0F0Fu;
  hi = (p.y >> 4) & 0x0F0F0F0Fu;
  w.z = sext4(__byte_perm(lo, hi, 0x5140));
  w.w = sext4(__byte_perm(lo, hi, 0x7362));
  return w;
}

// The packed slab of kRows rows (64 bytes each, no swizzle) in the upper
// half of `dst` widened into the s8 slab of 128-byte rows at `dst` in the
// 128-byte swizzle (the 16-byte piece c of row r at piece c ^ (r mod 8)),
// as TMA would have stored it: each thread loads kRows / 32 packed pieces
// of 16 bytes (a fixed count, their loads in flight together), the
// converter warpgroup meets at a named barrier (the stores overwrite the
// packed slab), then each stores its pieces widened.
template <int kRows>
__device__ __forceinline__ void widen_slab(unsigned char* dst, int ctid) {
  constexpr int kPieces = kRows * (kPackedRow / 16) / kConvThreads;
  const unsigned char* raw = dst + kRows * kPackedRow;
  uint4 p[kPieces];
#pragma unroll
  for (int k = 0; k < kPieces; ++k)
    p[k] = *reinterpret_cast<const uint4*>(raw + (ctid + k * kConvThreads) *
                                                     16);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConvThreads) : "memory");
#pragma unroll
  for (int k = 0; k < kPieces; ++k) {
    const int i = ctid + k * kConvThreads;  // piece i of the slab
    const int r = i >> 2, c = 2 * (i & 3);  // its row and first s8 piece
    unsigned char* row = dst + r * kSlabBytes;
    *reinterpret_cast<uint4*>(row + ((c ^ (r & 7)) << 4)) =
        widen16(make_uint2(p[k].x, p[k].y));
    *reinterpret_cast<uint4*>(row + (((c + 1) ^ (r & 7)) << 4)) =
        widen16(make_uint2(p[k].z, p[k].w));
  }
}

// kS8S4 (kPackB) and kS4S4 (both): see the head of this file. map_a and
// map_b read a slab (128 bytes of an s8 operand's row, 64 of a packed
// one's) of kGemmBM / kGemmBN rows.
template <bool kPackA, bool kPackB>
__global__ void __launch_bounds__(kWideThreads, 1)
widened_dot_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   const EpiI32 epi, int M, int N, int K) {
  constexpr int kABytes = kGemmBM * kSlabBytes;
  constexpr int kStageBytes = (kGemmBM + kGemmBN) * kSlabBytes;
  // bytes TMA stores into a stage: s8 slabs as they are (kS8S4's A), and
  // packed slabs (to be widened)
  constexpr int kDirect =
      (kPackA ? 0 : kABytes) + (kPackB ? 0 : kGemmBN * kSlabBytes);
  constexpr int kPacked =
      (kPackA ? kGemmBM * kPackedRow : 0) + (kPackB ? kGemmBN * kPackedRow : 0);
  extern __shared__ unsigned char wide_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wide_smem_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kWideStages * kStageBytes);
  uint64_t* empty = full + kWideStages;
  uint64_t* raw_full = empty + kWideStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWideStages; ++s) {
      // the producer's arrival (with the direct bytes) and the converter's
      mbar_init(&full[s], 1 + kConvThreads);
      mbar_init(&empty[s], kGemmConsumers * 128);
      mbar_init(&raw_full[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kGemmConsumers * 128) {
    gemm_consume<MmaS8, kWideStages>(smem, full, empty, epi, M, N, K);
    return;
  }

  // The converter warpgroup: slab `it` of the CTA's tiles (in the
  // consumers' order) widened in stage it mod kWideStages, then its thread
  // 0 issues the loads of slab it + 3. That waits for the consumers to
  // release slab it - 1, which they do once slab it, just arrived, is in
  // flight: the ring never waits on itself.
  const int ctid = threadIdx.x - kGemmConsumers * 128;
  const int k_tiles = K / kSlabBytes;
  const int tiles_n = (N + kGemmBN - 1) / kGemmBN;
  const int tiles = tiles_n * ((M + kGemmBM - 1) / kGemmBM);
  const int mine = static_cast<int>(blockIdx.x) < tiles
                       ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                       : 0;
  const int total = mine * k_tiles;
  auto issue = [&](int it) {
    const int tile = blockIdx.x + (it / k_tiles) * gridDim.x;
    const int kt = it % k_tiles;
    const int m0 = (tile / tiles_n) * kGemmBM;
    const int n0 = (tile % tiles_n) * kGemmBN;
    const int s = it % kWideStages;
    if (it >= kWideStages) mbar_wait(&empty[s], ((it / kWideStages) & 1) ^ 1);
    unsigned char* st = smem + s * kStageBytes;
    if constexpr (kDirect > 0) {
      mbar_expect_tx(&full[s], kDirect);
      if constexpr (!kPackA)
        tma_load_2d(st, &map_a, &full[s], kt * kSlabBytes, m0);
      if constexpr (!kPackB)
        tma_load_2d(st + kABytes, &map_b, &full[s], kt * kSlabBytes, n0);
    } else {
      mbar_arrive(&full[s]);
    }
    mbar_expect_tx(&raw_full[s], kPacked);
    if constexpr (kPackA)
      tma_load_2d(st + kGemmBM * kPackedRow, &map_a, &raw_full[s],
                  kt * kPackedRow, m0);
    if constexpr (kPackB)
      tma_load_2d(st + kABytes + kGemmBN * kPackedRow, &map_b, &raw_full[s],
                  kt * kPackedRow, n0);
  };
  constexpr int kAhead = kWideStages - 1;
  if (ctid == 0)
    for (int it = 0; it < kAhead && it < total; ++it) issue(it);
  for (int it = 0; it < total; ++it) {
    const int s = it % kWideStages;
    mbar_wait(&raw_full[s], (it / kWideStages) & 1);
    unsigned char* st = smem + s * kStageBytes;
    if constexpr (kPackA) widen_slab<kGemmBM>(st, ctid);
    if constexpr (kPackB) widen_slab<kGemmBN>(st + kABytes, ctid);
    fence_proxy_async();  // the widened slab, to the consumers' wgmma
    mbar_arrive(&full[s]);
    if (ctid == 0 && it + kAhead < total) issue(it + kAhead);
  }
}

// The tensor map of one operand: an s8 one read in 128-byte slabs in the
// 128-byte swizzle (the GEMM's), a packed one in 64-byte slabs unswizzled.
inline cudaError_t operand_map(CUtensorMap* map, const void* base, bool packed,
                               int rows, int k, int box_rows) {
  return packed ? tensor_map(map, base, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                             rows, k / 2, box_rows, kPackedRow,
                             CU_TENSOR_MAP_SWIZZLE_NONE)
                : tensor_map(map, base, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                             rows, k, box_rows);
}

template <bool kPackA, bool kPackB>
cudaError_t widened_dot(const void* a, const void* bt, int* c, int m, int n,
                        int k, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  cudaError_t e = operand_map(&map_a, a, kPackA, m, k, kGemmBM);
  if (e != cudaSuccess) return e;
  if ((e = operand_map(&map_b, bt, kPackB, n, k, kGemmBN)) != cudaSuccess)
    return e;
  constexpr int kSmem = kWideSmem;
  auto* kern = widened_dot_kernel<kPackA, kPackB>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmem);
  if (e != cudaSuccess) return e;
  int device = 0, sms = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const long long tiles = static_cast<long long>((n + kGemmBN - 1) / kGemmBN) *
                          ((m + kGemmBM - 1) / kGemmBM);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kern<<<grid, kWideThreads, kSmem, stream>>>(map_a, map_b, EpiI32{c}, m, n,
                                              k);
  return cudaGetLastError();
}

// C (m, n) from A and Bᵀ holding k values a row (packed two a byte where
// the variant says). Refused unless m >= 1, n % 8 == 0 and k % 128 == 0
// (a K slab; packed rows then stay multiples of 16 bytes, as TMA needs);
// the caller checks 16-byte alignment.
template <int V>
cudaError_t launch(const void* a, const void* bt, int* c, int m, int n, int k,
                   cudaStream_t stream) {
  if (m < 1 || n < 8 || n % 8 || k < kSlabBytes || k % kSlabBytes)
    return cudaErrorInvalidValue;
  if constexpr (V == kS8S8)
    return wgmma_gemm<MmaS8, kStagesS8>(a, bt, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                        1, EpiI32{c}, m, n, k, stream);
  else
    return widened_dot<V == kS4S4, true>(a, bt, c, m, n, k, stream);
}

}  // namespace int_dot
}  // namespace
