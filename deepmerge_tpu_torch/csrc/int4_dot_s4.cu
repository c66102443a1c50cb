// The int4 dot probe's s4 x s4 variant (kernel K10; int4_dot.cuh) on
// mma.sync m16n8k64 s4, both operands packed two a byte.

#include "int4_dot.cuh"

extern "C" {

const char* dm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// C (m, n) int32 = A (m, k) s4 · Bᵀ (n, k) s4, packed (m, k / 2), (n, k / 2).
int dm_int_dot_s4s4(const int8_t* a, const int8_t* bt, int* c, int m, int n,
                    int k, cudaStream_t stream) {
  return static_cast<int>(
      int_dot::launch<int_dot::kS4S4>(a, bt, c, m, n, k, stream));
}

}  // extern "C"
