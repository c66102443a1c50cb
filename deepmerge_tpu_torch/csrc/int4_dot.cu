// The int4 dot probe's s8 variants (kernel K10; int4_dot.cuh): s8 x s8 and
// s8 x (s4 widened to s8), both on mma.sync m16n8k32 s8. The s4 x s4
// variant is built on its own (int4_dot_s4.cu), so that these two stand
// whether or not ptxas takes its instruction for sm_90a.

#include "int4_dot.cuh"

extern "C" {

const char* dm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// C (m, n) int32 = A (m, k) s8 · Bᵀ (n, k) s8.
int dm_int_dot_s8s8(const int8_t* a, const int8_t* bt, int* c, int m, int n,
                    int k, cudaStream_t stream) {
  return static_cast<int>(
      int_dot::launch<int_dot::kS8S8>(a, bt, c, m, n, k, stream));
}

// C (m, n) int32 = A (m, k) s8 · Bᵀ (n, k) s4, Bᵀ packed (n, k / 2).
int dm_int_dot_s8s4(const int8_t* a, const int8_t* bt, int* c, int m, int n,
                    int k, cudaStream_t stream) {
  return static_cast<int>(
      int_dot::launch<int_dot::kS8S4W>(a, bt, c, m, n, k, stream));
}

}  // extern "C"
