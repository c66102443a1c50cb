// The int4 dot probe (kernel K10; int4_dot.cuh): s8 x s8, s8 x s4 and
// s4 x s4, all on the s8 wgmma GEMM (the packed operands widened to s8 on
// their way into shared memory).

#include "int4_dot.cuh"

extern "C" {

const char* dm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// C (m, n) int32 = A (m, k) s8 · Bᵀ (n, k) s8.
int dm_int_dot_s8s8(const void* a, const void* bt, int* c, int m, int n,
                    int k, cudaStream_t stream) {
  return static_cast<int>(
      int_dot::launch<int_dot::kS8S8>(a, bt, c, m, n, k, stream));
}

// C (m, n) int32 = A (m, k) s8 · Bᵀ (n, k) s4, Bᵀ packed (n, k / 2).
int dm_int_dot_s8s4(const void* a, const void* bt, int* c, int m, int n,
                    int k, cudaStream_t stream) {
  return static_cast<int>(
      int_dot::launch<int_dot::kS8S4>(a, bt, c, m, n, k, stream));
}

// C (m, n) int32 = A (m, k) s4 · Bᵀ (n, k) s4, packed (m, k / 2), (n, k / 2).
int dm_int_dot_s4s4(const void* a, const void* bt, int* c, int m, int n,
                    int k, cudaStream_t stream) {
  return static_cast<int>(
      int_dot::launch<int_dot::kS4S4>(a, bt, c, m, n, k, stream));
}

}  // extern "C"
