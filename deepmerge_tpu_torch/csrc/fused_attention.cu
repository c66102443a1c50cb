// The saved-probs training attention (kernel K6), bf16, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepmerge_tpu/ops/pallas/fused_attention.py:311
// `_attn_qkv_probs_kernel` (called through `_fused_qkv_probs_forward`, the
// forward of `fused_attention_qkv(..., save_probs=True)`, which every
// training block runs). From the packed qkv projection (B, N, 3C), heads
// interleaved as (H, 64) within each C block, per head:
//   q'  = bf16(q · d^-½)                       scaled in the input dtype
//   e   = exp(q'·kᵀ + bias[h] − max)           f32 logits and softmax
//   out = bf16((bf16(e)·v) · (1/Σe))            f32 accumulation
//   p   = bf16(e · (1/Σe))                      the saved probabilities
// out is (B, N, C) bf16 and p (B, H, N, N) bf16, as the TPU kernel writes
// them whatever the input type. The backward (the JAX package's
// `_fused_qkv_train_bwd`, XLA einsums there) is plain torch in
// ops/kernels/fused_attention.py.
//
// Bound on the H100: bytes. At the stage-0 operating point (B 240, N 192,
// C 768, H 12) the kernel must read qkv (212 MB) and write out (71 MB) and
// p (212 MB): 0.50 GB, 0.15 ms at 3.35 TB/s; its 27 GFLOP of q·kᵀ and p·v
// take 0.03 ms at 989 TFLOP/s. The design is K2's attention core
// (block_common.cuh, one CTA per (head, sample), K and V of the head in
// shared memory, tensor-core MMAs for both products, softmax in f32
// registers) with one more store path: each lane writes the probabilities
// of its keys from the registers that hold e, so p costs one pass of writes
// and no extra reads. qkv is read once per (head, sample) except for the
// query rows, which every warp reads once more.

#include "block_common.cuh"

extern "C" {

const char* dm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out (B·N, C) and probs (B, H, N, N), both bf16, from qkv (B·N, 3C) bf16
// and bias (H, N, N) f32. Requires C == H·64 and N <= 256 (checked by the
// caller). Returns cudaGetLastError().
int dm_attention_probs(const void* qkv, const void* bias, void* out,
                       void* probs, int B, int N, int C, int H,
                       cudaStream_t stream) {
  return static_cast<int>(attention_launch<true>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<bf16*>(out), static_cast<bf16*>(probs), B, N, C, H,
      stream));
}

}  // extern "C"
