// The attention kernels, bf16, for Hopper (sm_90a): the saved-probs
// training attention (K6), the inference attention on the packed qkv (K7)
// and on separate (B, N, H, D) q, k, v (K8). All three run the attention
// core of block_common.cuh, one CTA per (head, sample).
//
// K6 replaces deepmerge_tpu/ops/pallas/fused_attention.py:311
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
// K7 replaces fused_attention.py:143 `_attn_qkv_kernel` and :175
// `_attn_qkv_kernel_packed` (call :438, the forward of
// `fused_attention_qkv(..., save_probs=False)`, which every block off the
// block kernel runs at inference): the same q', e and out, without p. The
// packed TPU kernel computes the same function with two heads' value
// products as one block-diagonal product, to fill the TPU's 128-wide lanes;
// the H100's 16-wide MMA tiles need no such packing, so both launch this.
//
// K8 replaces fused_attention.py:26 `_attn_kernel` (call :117): the same
// attention on (B, N, H, D) q, k and v, whose rows are C apart instead of
// 3C, with the probabilities normalized before the value product,
// out = bf16(bf16(e · (1/Σe))·v), as that kernel orders it (its softmax
// divides by Σe; the product with the reciprocal can differ from the
// quotient in the last float32 bit, so a bf16 rounding may go the other
// way).
//
// Bound on the H100: bytes. At the stage-0 operating point of training (B
// 240, N 192, C 768, H 12) K6 must read qkv (212 MB) and write out (71 MB)
// and p (212 MB): 0.50 GB, 0.15 ms at 3.35 TB/s; its 27 GFLOP of q·kᵀ and
// p·v take 0.03 ms at 989 TFLOP/s. K7 and K8 at serving's B 1024 read 906
// MB of q, k and v and write 302 MB: 0.36 ms, against 0.12 ms of products.
// The design (the core of block_common.cuh): K and V of one (sample, head)
// in 55-74 KB of shared memory, so that three 4-warp CTAs fit an SM; each
// warp keeps its 16 x N logits in mma.sync accumulators, takes the row max
// and Σe by quad shuffles, adds the f32 bias from device memory in the
// accumulator layout, and feeds P to the value product from registers (the
// m16n8k16 accumulator layout is its A layout). K6 adds one store path:
// each thread writes the probabilities of its keys from the registers that
// hold e, so p costs one pass of writes and no extra reads. q is read once,
// k and v once per (head, sample). Launch plan: the wrapper's
// `attention_plan` (ops/kernels/fused_block.py), passed in `plan`.

#include "block_common.cuh"

extern "C" {

const char* dm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K6: out (B·N, C) and probs (B, H, N, N), both bf16, from qkv (B·N, 3C)
// bf16 and bias (H, N, N) f32. Requires C == H·64 and 1 <= N <= 256
// (checked by the caller). Returns cudaGetLastError().
int dm_attention_probs(const void* qkv, const void* bias, void* out,
                       void* probs, int B, int N, int C, int H,
                       const int* plan, cudaStream_t stream) {
  return static_cast<int>(attention_qkv<true>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<bf16*>(out), static_cast<bf16*>(probs), B, N, C, H, plan,
      stream));
}

// K7: out (B·N, C) bf16 from qkv (B·N, 3C) bf16 and bias (H, N, N) f32.
// Requires C == H·64 and 1 <= N <= 256. Returns cudaGetLastError().
int dm_attention(const void* qkv, const void* bias, void* out, int B, int N,
                 int C, int H, const int* plan, cudaStream_t stream) {
  return static_cast<int>(attention(static_cast<const bf16*>(qkv),
                                    static_cast<const float*>(bias),
                                    static_cast<bf16*>(out), B, N, C, H, plan,
                                    stream));
}

// K8: out (B, N, H, 64) bf16 from q, k, v (B, N, H, 64) bf16 and bias
// (H, N, N) f32, C = H·64. Requires 1 <= N <= 256 and 16-byte aligned
// tensors. Returns cudaGetLastError().
int dm_attention_bnhd(const void* q, const void* k, const void* v,
                      const void* bias, void* out, int B, int N, int C, int H,
                      const int* plan, cudaStream_t stream) {
  return static_cast<int>(attention_launch<false, true>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), C, static_cast<const float*>(bias),
      static_cast<bf16*>(out), nullptr, B, N, C, H, plan, stream));
}

}  // extern "C"
