// The saved-probs training attention (K6), bf16, for Hopper (sm_90a), on
// the attention core of block_common.cuh (with kProbs), as
// fused_attention.cu's K7 and K8 but in a source of its own: an unfused
// model trains on K1 and K6 alone, so a caller can build this first and
// train while the other sources compile.
//
// K6 replaces deepmerge_tpu/ops/pallas/fused_attention.py:311
// `_attn_qkv_probs_kernel` (called through `_fused_qkv_probs_forward`, the
// forward of `fused_attention_qkv(..., save_probs=True)`, which every
// training block runs). From the packed qkv projection (B, N, 3C), heads
// interleaved as (H, d) within each C block, d = C / H (any multiple of 8
// up to 8192: on the core of width 32, 64, 128 or 256, or the long route's
// wide form above 256), per head:
//   q'  = bf16(q · d^-½)                       scaled in the input dtype
//   e   = exp(q'·kᵀ + bias[h] − max)           f32 logits and softmax
//   out = bf16((bf16(e)·v) · (1/Σe))            f32 accumulation
//   p   = bf16(e · (1/Σe))                      the saved probabilities
// out is (B, N, C) bf16 and p (B, H, N, N) bf16, as the TPU kernel writes
// them whatever the input type. The backward (the JAX package's
// `_fused_qkv_train_bwd`, XLA einsums there) is plain torch in
// ops/kernels/fused_attention.py.
//
// Bound on the H100: bytes. At the stage-0 operating point of training (B
// 240, N 192, C 768, H 12, d 64) K6 must read qkv (212 MB) and write out (71 MB)
// and p (212 MB): 0.50 GB, 0.15 ms at 3.35 TB/s; its 27 GFLOP of q·kᵀ and
// p·v take 0.03 ms at 989 TFLOP/s.
//
// The core as fused_attention.cu describes it, with one store path more:
// each thread writes the probabilities of its keys from the registers that
// hold e, so p costs one pass of writes and no extra reads. Launch plan:
// the wrapper's `attention_plan` (ops/kernels/fused_block.py, with
// probs=True), passed in `plan`.

#include "block_common.cuh"

extern "C" {

const char* dm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K6: out (B·N, C) and probs (B, H, N, N), both bf16, from qkv (B·N, 3C)
// bf16 and bias (H, N, N) f32. Requires C == H·d with d % 8 == 0 and
// 8 <= d <= 8192, 1 <= N <= 16384 and 16-byte aligned tensors (checked by
// the caller; refused here too). `scratch` (16-byte aligned, of
// `scratch_bytes`) holds at least the plan's `scratch` bytes on the wide
// form (d > 256; a smaller one is refused) and is unread elsewhere (null
// there). q is scaled by the d^-1/2 of `d_scale`, as dm_attention's.
// Returns cudaGetLastError().
int dm_attention_probs(const void* qkv, const void* bias, void* out,
                       void* probs, int B, int N, int C, int H,
                       int d_scale, const int* plan, void* scratch,
                       long long scratch_bytes, cudaStream_t stream) {
  return static_cast<int>(attention_qkv<true>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<bf16*>(out), static_cast<bf16*>(probs), B, N, C, H,
      d_scale, plan, scratch, scratch_bytes, stream));
}

}  // extern "C"
