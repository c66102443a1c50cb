// The label-map relabel lookup (kernel K9): out[p] = table[map[p]].
//
// Replaces the TPU kernel tools/gather_probe.py `kern` (its pallas_call at
// :49), which computes the tail of merged_label_map
// (deepmerge_tpu/ops/labelprop.py:230, `dense[region_map_hw]`): every pixel
// of an (H, W) int32 superpixel map looks up its region's dense cluster id
// in an R-entry int32 table (R 2048 on the slice, 8192 on the walk's
// scenes). Ids out of range read as JAX's `dense[idx]` reads them: a
// negative id wraps once (idx + R), then the id is clamped to [0, R - 1].
//
// Bound on the H100: memory. Each pixel reads 4 bytes of map and writes 4
// bytes of output (32 MB at 2048², about 10 us at 3.35 TB/s); the table is
// at most a few tens of KB. The design keeps the table out of the stream:
// each CTA stages it once in shared memory (dynamic, the limit raised past
// 48 KB; tables too large for it are read through __ldg), then walks the
// map with a grid-stride loop of 16-byte int4 loads and stores, four in
// flight a thread, streaming (__ldcs / __stcs: the map is read once and
// the output not read back here). A scalar loop takes the tail when the
// pixel count is not a multiple of 4, or every pixel when a base address
// is not 16-byte aligned. The grid is a few CTAs an SM, so the table is
// staged a few hundred times, not once per tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;

__device__ __forceinline__ int slot(int i, int r) {
  if (i < 0) i += r;
  return min(max(i, 0), r - 1);
}

template <bool kShared>
__device__ __forceinline__ int read(const int* t, int i) {
  if constexpr (kShared) {
    return t[i];
  } else {
    return __ldg(t + i);
  }
}

template <bool kShared>
__device__ __forceinline__ int4 lookup4(const int* t, int4 m, int r) {
  return make_int4(read<kShared>(t, slot(m.x, r)),
                   read<kShared>(t, slot(m.y, r)),
                   read<kShared>(t, slot(m.z, r)),
                   read<kShared>(t, slot(m.w, r)));
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
lookup_kernel(const int* __restrict__ table, int r,
              const int* __restrict__ map, int* __restrict__ out,
              long long n, long long n4) {
  extern __shared__ int staged[];
  const int* t = table;
  if constexpr (kShared) {
    for (int i = threadIdx.x; i < r; i += kThreads)
      staged[i] = __ldg(table + i);
    __syncthreads();
    t = staged;
  }
  const int4* map4 = reinterpret_cast<const int4*>(map);
  int4* out4 = reinterpret_cast<int4*>(out);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (; v + (kUnroll - 1) * stride < n4; v += kUnroll * stride) {
    int4 m[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) m[k] = __ldcs(map4 + v + k * stride);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      __stcs(out4 + v + k * stride, lookup4<kShared>(t, m[k], r));
  }
  for (; v < n4; v += stride)
    __stcs(out4 + v, lookup4<kShared>(t, __ldcs(map4 + v), r));
  for (long long i = 4 * n4 + static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride)
    out[i] = read<kShared>(t, slot(map[i], r));
}

}  // namespace

extern "C" {

const char* dm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[p] = table[clamp(map[p])] for the n pixels of map. `vec` is 1 when
// map and out are 16-byte aligned (int4 loads and stores), else 0; `blocks`
// the grid size (a few CTAs an SM); `shared_bytes` the table's bytes when
// it is staged in shared memory (at most the card's opt-in limit), else 0
// for reads through __ldg. Returns cudaGetLastError() after the launch.
int dm_label_lookup(const int* table, int r, const int* map, int* out,
                    long long n, int vec, int blocks, int shared_bytes,
                    cudaStream_t stream) {
  if (n == 0) return 0;
  if (r <= 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = vec ? n / 4 : 0;
  if (shared_bytes > 0) {
    if (shared_bytes < r * static_cast<int>(sizeof(int)))
      return static_cast<int>(cudaErrorInvalidValue);
    if (shared_bytes > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          lookup_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          shared_bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    lookup_kernel<true><<<blocks, kThreads, shared_bytes, stream>>>(
        table, r, map, out, n, n4);
  } else {
    lookup_kernel<false><<<blocks, kThreads, 0, stream>>>(table, r, map, out,
                                                           n, n4);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
