// The int4 dot probe (kernel K10): int32 C (M, N) = A (M, K) · B (K, N) on
// integer operands, in one simple tiled kernel for every operand mix.
//
// Replaces the TPU kernel tools/int4_dot_probe.py `_mk`'s `kern` (its
// pallas_call at :50), whose question is whether an int4 rate makes a w4a8
// MLP worth having, at the MLP's shape (M 4096, K 768, N 3072). Hopper's
// wgmma has no int4 form, so the variants run on mma.sync:
//   kS8S8  s8 x s8, m16n8k32 (the instruction K4a uses): the baseline;
//   kS4S4  s4 x s4, m16n8k64, both operands packed two a byte;
//   kS8S4W s8 x (s4 widened): B stored packed in global memory, widened to
//          s8 on its way into shared memory, then the kS8S8 products.
// PTX has no mixed-operand (s8 x s4) mma, so the probe's third TPU variant
// has no instruction here; kS8S4W is how Hopper would run a w4a8 product.
//
// Layout: A row-major (M, Ka bytes), B as Bᵀ row-major (N, Kb bytes), K
// contiguous in both, nibble pairs low first (even k in the low nibble).
// In bytes, m16n8k64 s4 reads its fragments exactly as m16n8k32 s8 does
// (32 bytes of K an instruction), so the three variants share one tile
// walk: a CTA takes a 128 x 128 tile of C through 64-byte slices of K, its
// eight warps 64 x 32 each (4 x 4 mma tiles), A and B staged in shared
// memory at an 80-byte row pitch (fragment reads free of bank conflicts).
// No pipelining: a simple kernel that is right, timed beside the s8 wgmma
// GEMM of K4. Bound at the probe's shape: the int32 output (50 MB) over
// the memory rate, about 16 us, above the 19.3 G operations' 10 us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace int_dot {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;           // bytes of K a slice
constexpr int kPitch = kBK + 16;  // shared row pitch in bytes
constexpr int kThreads = 256;

enum Variant { kS8S8 = 0, kS4S4 = 1, kS8S4W = 2 };

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Bytes 2h and 2h+1 of w hold four signed nibbles, the low one first:
// those four as s8, the first in the low byte.
__device__ __forceinline__ uint32_t widen(uint32_t w, int h) {
  uint32_t out = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int nib = (w >> (16 * h + 4 * e)) & 0xF;
    out |= static_cast<uint32_t>(((nib ^ 8) - 8) & 0xFF) << (8 * e);
  }
  return out;
}

template <int V>
__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  if constexpr (V == kS4S4) {
    asm volatile(
        "mma.sync.aligned.m16n8k64.row.col.s32.s4.s4.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// ka: bytes of K in an A row; kb: bytes of K in a Bᵀ row in global memory
// (ka / 2 for kS8S4W, whose shared B rows hold ka widened bytes).
template <int V>
__global__ void __launch_bounds__(kThreads)
dot_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bt,
           int* __restrict__ c, int n, int ka, int kb) {
  __shared__ __align__(16) int8_t sa[kBM * kPitch];
  __shared__ __align__(16) int8_t sb[kBN * kPitch];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 warps along M, 4 along N
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = static_cast<long long>(blockIdx.y) * kBM;
  const long long col0 = static_cast<long long>(blockIdx.x) * kBN;
  int acc[4][4][4] = {};
  for (int k0 = 0; k0 < ka; k0 += kBK) {
    for (int i = tid; i < kBM * kBK / 16; i += kThreads) {
      const int r = i / (kBK / 16), ch = i % (kBK / 16);
      *reinterpret_cast<int4*>(sa + r * kPitch + ch * 16) = __ldg(
          reinterpret_cast<const int4*>(a + (row0 + r) * ka + k0) + ch);
    }
    if constexpr (V == kS8S4W) {
      // 16 packed bytes a thread, widened to 32 s8
      for (int i = tid; i < kBN * kBK / 32; i += kThreads) {
        const int r = i / (kBK / 32), ch = i % (kBK / 32);
        const int4 p = __ldg(reinterpret_cast<const int4*>(
                                 bt + (col0 + r) * kb + k0 / 2) + ch);
        int4* dst = reinterpret_cast<int4*>(sb + r * kPitch + ch * 32);
        dst[0] = make_int4(widen(p.x, 0), widen(p.x, 1), widen(p.y, 0),
                           widen(p.y, 1));
        dst[1] = make_int4(widen(p.z, 0), widen(p.z, 1), widen(p.w, 0),
                           widen(p.w, 1));
      }
    } else {
      for (int i = tid; i < kBN * kBK / 16; i += kThreads) {
        const int r = i / (kBK / 16), ch = i % (kBK / 16);
        *reinterpret_cast<int4*>(sb + r * kPitch + ch * 16) = __ldg(
            reinterpret_cast<const int4*>(bt + (col0 + r) * kb + k0) + ch);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = sa + (wm * 64 + i * 16 + g) * kPitch + kk + t * 4;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * kPitch);
        af[i][2] = ld32(p + 16);
        af[i][3] = ld32(p + 8 * kPitch + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = sb + (wn * 32 + j * 8 + g) * kPitch + kk + t * 4;
        bf[j][0] = ld32(p);
        bf[j][1] = ld32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma<V>(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long r = row0 + wm * 64 + i * 16 + g;
      const long long col = col0 + wn * 32 + j * 8 + t * 2;
      *reinterpret_cast<int2*>(c + r * n + col) =
          make_int2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<int2*>(c + (r + 8) * n + col) =
          make_int2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// C (m, n) from A and Bᵀ holding k values a row. The caller checks the
// tile multiples (m, n by 128; k by 64 bytes of A) and 16-byte alignment.
template <int V>
cudaError_t launch(const int8_t* a, const int8_t* bt, int* c, int m, int n,
                   int k, cudaStream_t stream) {
  const int ka = V == kS4S4 ? k / 2 : k;
  const int kb = V == kS8S8 ? k : k / 2;
  if (m <= 0 || n <= 0 || m % kBM || n % kBN || ka % kBK || (k & 1))
    return cudaErrorInvalidValue;
  dim3 grid(n / kBN, m / kBM);
  dot_kernel<V><<<grid, kThreads, 0, stream>>>(a, bt, c, n, ka, kb);
  return cudaGetLastError();
}

}  // namespace int_dot
