// The exact patch stage of one scale slot in one launch (kernel K1,
// redesigned for Hopper): window origin, crop + cv2 INTER_AREA resize as a
// row pass and a column pass, the cv2 uint8 rounding and the 1/255 scale,
// written straight into the (B, p, p, co) patches.
//
// Replaces the TPU kernel deepmerge_tpu/ops/pallas/window_gather.py
// `_gather_kernel` (called at :114) together with the exact path of
// deepmerge_tpu/ops/patches.py:275-322 around it. On the TPU the gather
// copies each point's (cap + 32) x (cap + align) window to HBM, and two
// einsums and a rounding chain then run over the copies, chunk by chunk.
//
// Bound on the H100: bytes. For one slot of B points the function must
// read each point's s x s x C window and write B x p x p x co patches; at
// the slice's 1024 points of the 128 slot the bf16 output alone is about
// 100 MB (30 us at 3.35 TB/s), against about 0.3 G multiply-adds (a few us
// of the float32 units). So nothing intermediate goes to device memory: one
// CTA per (point, tile of output rows) reads only the window rows its tile
// needs, in 16-byte units from the window's 128-byte aligned origin (the
// staged scene, a few MB to tens of MB, stays in the 50 MB L2), keeps the
// row pass's result (tile rows x s x C, float32) in shared memory, and runs
// the column pass, the rounding and the store from there, consecutive
// threads on consecutive output elements. Launch plan: the wrapper's
// `patch_resize_plan` (ops/kernels/patch_resize.py), refused otherwise.
//
// Exactness (bit-identical to the plain version, patch_resize_ref):
//  - the weights come from the caller's tap table, built from
//    resize_weights itself: per window side s and output index, the first
//    source index with a nonzero weight and `taps` weights from there;
//  - the row pass multiplies bf16-integral weights by uint8 pixels: every
//    product and sum is an exact float32 integer below 2^24, in any order;
//  - the column pass uses float32 weights that are mostly not integers:
//    fmaf in ascending source order, zero weights skipped (they add
//    exactly nothing, and skipping them keeps every read inside the
//    adaptive window);
//  - the rounding floor(x2/s^2 + 1/2), its tie correction and the 1/255
//    product use __fdiv_rn / __fadd_rn / __fsub_rn / __fmul_rn, which the
//    compiler never contracts into FMAs, as the plain version runs them as
//    separate float32 operations.
//
// The window origin and the offset of the adaptive window inside it follow
// ops/kernels/window_gather.py `window_starts` and patch_resize.py
// `slot_geometry`. The caller checks (or vouches) that every window lies
// inside the scene; the kernel also clamps each row it reads to its window.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTileRows = 16;
constexpr int kMaxCap = 256;
constexpr int kMaxOut = 256;
constexpr int kSharedMax = 48 * 1024;
constexpr int kRowAlign = 32;
constexpr float kInv255 = 1.0f / 255.0f;

// shared row stride in floats: the 16-byte load units overhang the
// window's columns by up to 15 bytes at each end
int row_stride(int cap, int channels) {
  return (cap * channels + 32 + 3) / 4 * 4;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

template <int U> struct Unit;
template <> struct Unit<16> { using T = uint4; };
template <> struct Unit<4> { using T = uint32_t; };
template <> struct Unit<1> { using T = uint8_t; };

__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// grid (B, tiles of output rows); kThreads threads; dynamic shared memory
// tile_rows x stride floats
template <int U, typename OutT>
__global__ void __launch_bounds__(kThreads)
patch_resize_kernel(const uint8_t* __restrict__ scene, long long pitch,
                    int C, const int* __restrict__ centers,
                    const int* __restrict__ scales, long long scale_stride,
                    int cap, int out, int pad, int a_px, int co,
                    const int* __restrict__ first,
                    const float* __restrict__ w_rows,
                    const float* __restrict__ w_cols, int taps,
                    int tile_rows, int stride, OutT* __restrict__ dst) {
  extern __shared__ __align__(16) float x1[];
  using V = typename Unit<U>::T;
  const int b = blockIdx.x;
  const int o0 = blockIdx.y * tile_rows;
  const int rows = min(tile_rows, out - o0);
  const int cy = centers[2 * b], cx = centers[2 * b + 1];
  const int s = min(max(scales[b * scale_stride], 1), cap);

  // the aligned window origin (window_starts) and the adaptive window's
  // offset inside it: int(center - s/2), truncated toward zero
  const int y0a = floor_div(cy + pad - cap / 2, kRowAlign) * kRowAlign;
  const int px0a = floor_div(cx + pad - cap / 2, a_px) * a_px;
  const float half = __fdiv_rn(static_cast<float>(s), 2.0f);
  const int off_y = __float2int_rz(__fsub_rn(static_cast<float>(cy), half))
                    - y0a + pad;
  const int off_x = __float2int_rz(__fsub_rn(static_cast<float>(cx), half))
                    - px0a + pad;
  const int win_rows = cap + kRowAlign;
  const uint8_t* win = scene + static_cast<long long>(y0a) * pitch
                       + static_cast<long long>(px0a) * C;
  const long long tap0 = static_cast<long long>(s - 1) * out;

  // row pass: x1[r][sh + i*C + c] for the adaptive window's columns i < s,
  // loaded in U-byte units from the unit holding its first byte
  const int cb = off_x * C;
  const int u0 = cb / U;
  const int sh = cb - u0 * U;
  const int units = (sh + s * C + U - 1) / U;
  for (int it = threadIdx.x; it < rows * units; it += kThreads) {
    const int r = it / units;
    const int u = it - r * units;
    const long long row_taps = tap0 + o0 + r;
    const int f = first[row_taps];
    const float* w = w_rows + row_taps * taps;
    float acc[U];
#pragma unroll
    for (int k = 0; k < U; ++k) acc[k] = 0.0f;
    for (int t = 0; t < taps; ++t) {
      const float wt = __ldg(w + t);
      if (wt == 0.0f) continue;
      const int y = min(max(off_y + f + t, 0), win_rows - 1);
      union {
        V v;
        uint8_t b[U];
      } px;
      px.v = __ldg(reinterpret_cast<const V*>(
                       win + static_cast<long long>(y) * pitch) + u0 + u);
#pragma unroll
      for (int k = 0; k < U; ++k) {
        acc[k] = fmaf(wt, static_cast<float>(px.b[k]), acc[k]);
      }
    }
    float* x1_unit = x1 + r * stride + u * U;
    if constexpr (U % 4 == 0) {
#pragma unroll
      for (int k = 0; k < U; k += 4) {
        *reinterpret_cast<float4*>(x1_unit + k) =
            make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
      }
    } else {
      x1_unit[0] = acc[0];
    }
  }
  __syncthreads();

  // column pass, cv2 rounding, 1/255, store: element e of the tile is
  // (row r, column p, channel ch) of the output, in memory order
  const int per_row = out * co;
  const int n = rows * per_row;
  OutT* tile_out = dst + (static_cast<long long>(b) * out + o0) * per_row;
  const float s2 = __fmul_rn(static_cast<float>(s), static_cast<float>(s));
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / per_row;
    const int rem = e - r * per_row;
    const int p = rem / co;
    const int ch = rem - p * co;
    const long long col_taps = tap0 + p;
    const float* w = w_cols + col_taps * taps;
    const float* src = x1 + r * stride + sh + first[col_taps] * C + ch;
    float x2 = 0.0f;
    for (int t = 0; t < taps; ++t) {
      const float wt = __ldg(w + t);
      if (wt != 0.0f) x2 = fmaf(wt, src[t * C], x2);
    }
    float k = floorf(__fadd_rn(__fdiv_rn(x2, s2), 0.5f));
    const float d2 = __fmul_rn(2.0f, __fsub_rn(x2, __fmul_rn(k, s2)));
    if (d2 >= s2) k = __fadd_rn(k, 1.0f);
    if (d2 < -s2) k = __fsub_rn(k, 1.0f);
    store(__fmul_rn(k, kInv255), tile_out + e);
  }
}

template <int U, typename OutT>
cudaError_t launch(const uint8_t* scene, long long pitch, int C,
                   const int* centers, const int* scales,
                   long long scale_stride, int n_points, int cap, int out,
                   int pad, int a_px, int co, const int* first,
                   const float* w_rows, const float* w_cols, int taps,
                   void* dst, int tile_rows, int smem, cudaStream_t stream) {
  dim3 grid(n_points, (out + tile_rows - 1) / tile_rows);
  patch_resize_kernel<U, OutT><<<grid, kThreads, smem, stream>>>(
      scene, pitch, C, centers, scales, scale_stride, cap, out, pad, a_px,
      co, first, w_rows, w_cols, taps, tile_rows, row_stride(cap, C),
      static_cast<OutT*>(dst));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Exact patches of one slot for n_points points into dst (n_points, out,
// out, co), float32 or (out_bf16) bfloat16. `scales` holds each point's
// window side at a stride of scale_stride ints; `first`, `w_rows` and
// `w_cols` are the tap table of (out, cap); `vec` is the load unit in
// bytes (16, 4 or 1), dividing the row pitch, the scene's base address and
// the window's width. plan = (tile rows, threads, shared bytes) from
// patch_resize_plan. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape or plan the kernel does not take.
int dm_patch_resize(const uint8_t* scene, long long pitch, int C,
                    const int* centers, const int* scales,
                    long long scale_stride, int n_points, int cap, int out,
                    int pad, int a_px, int co, const int* first,
                    const float* w_rows, const float* w_cols, int taps,
                    int vec, int out_bf16, void* dst, const int* plan,
                    cudaStream_t stream) {
  const int tile_rows = plan[0], threads = plan[1], smem = plan[2];
  const bool shape_ok = cap >= 2 && cap <= kMaxCap && cap % 2 == 0 &&
                        out >= 1 && out <= kMaxOut &&
                        (C == 1 || C == 2 || C == 4 || C == 8) && co >= 1 &&
                        co <= C && taps >= 1 && n_points >= 0;
  if (!shape_ok || threads != kThreads || tile_rows < 1 ||
      tile_rows > kMaxTileRows || tile_rows > out ||
      smem != tile_rows * row_stride(cap, C) * 4 || smem > kSharedMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_points == 0) return 0;
#define DM_LAUNCH(U, T)                                                      \
  launch<U, T>(scene, pitch, C, centers, scales, scale_stride, n_points,     \
               cap, out, pad, a_px, co, first, w_rows, w_cols, taps, dst,    \
               tile_rows, smem, stream)
  cudaError_t err;
  switch (vec) {
    case 16:
      err = out_bf16 ? DM_LAUNCH(16, __nv_bfloat16) : DM_LAUNCH(16, float);
      break;
    case 4:
      err = out_bf16 ? DM_LAUNCH(4, __nv_bfloat16) : DM_LAUNCH(4, float);
      break;
    case 1:
      err = out_bf16 ? DM_LAUNCH(1, __nv_bfloat16) : DM_LAUNCH(1, float);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
#undef DM_LAUNCH
  return static_cast<int>(err);
}

}  // extern "C"
