// The inference attention kernels, bf16, for Hopper (sm_90a): on the
// packed qkv (K7) and on separate (B, N, H, D) q, k, v (K8). Both run the
// attention core of block_common.cuh, one CTA per (head, sample), or above
// 256 tokens (and at every N for heads wider than 128) its long route, one
// CTA per (128 queries, head, two samples; one at head widths 128 and 256,
// and on the wide form that takes heads wider than 256 in 128-lane
// chunks). The saved-probs training attention (K6) on the same core is
// attention_probs.cu, a source of its own: training needs only it, so it
// builds apart from these and sooner.
//
// K7 replaces fused_attention.py:143 `_attn_qkv_kernel` and :175
// `_attn_qkv_kernel_packed` (call :438, the forward of
// `fused_attention_qkv(..., save_probs=False)`, which every block off the
// block kernel runs at inference): from the packed qkv projection (B, N,
// 3C), heads interleaved as (H, d) within each C block, d = C / H (any
// multiple of 8 up to 8192: on the core of width 32, 64, 128 or 256, or
// the long route's wide form above 256), per head:
//   q'  = bf16(q · d^-½)                       scaled in the input dtype
//   e   = exp(q'·kᵀ + bias[h] − max)           f32 logits and softmax
//   out = bf16((bf16(e)·v) · (1/Σe))            f32 accumulation
// out (B, N, C) bf16. The packed TPU kernel computes the same function with
// two heads' value products as one block-diagonal product, to fill the
// TPU's 128-wide lanes; the H100's 16-wide MMA tiles need no such packing,
// so both launch this.
//
// K8 replaces fused_attention.py:26 `_attn_kernel` (call :117): the same
// attention on (B, N, H, D) q, k and v, whose rows are C apart instead of
// 3C, with the probabilities normalized before the value product,
// out = bf16(bf16(e · (1/Σe))·v), as that kernel orders it (its softmax
// divides by Σe; the product with the reciprocal can differ from the
// quotient in the last float32 bit, so a bf16 rounding may go the other
// way).
//
// Bound on the H100: bytes. K7 and K8 at serving's B 1024 (N 192, C 768,
// H 12, d 64) read 906 MB of q, k and v and write 302 MB: 0.36 ms at 3.35
// TB/s, against 0.12 ms of products at 989 TFLOP/s.
//
// The design (the core of block_common.cuh): K and V of one (sample, head)
// in 55-74 KB of shared memory, so that three 4-warp CTAs fit an SM; each
// warp keeps its 16 x N logits in mma.sync accumulators, takes the row max
// and Σe by quad shuffles, adds the f32 bias from device memory in the
// accumulator layout, and feeds P to the value product from registers (the
// m16n8k16 accumulator layout is its A layout). q is read once, k and v
// once per (head, sample). Launch plan: the wrapper's `attention_plan`
// (ops/kernels/fused_block.py), passed in `plan`.

#include "block_common.cuh"

extern "C" {

const char* dm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K7: out (B·N, C) bf16 from qkv (B·N, 3C) bf16 and bias (H, N, N) f32.
// Requires C == H·d with d % 8 == 0 and 8 <= d <= 8192, 1 <= N <= 16384
// and 16-byte aligned tensors (checked by the caller; refused here too);
// q is scaled by the d^-1/2 of `d_scale`, the head's true width (d, or
// less on a zero-padded layout: block_common.cuh scale_width_ok).
// `scratch` (16-byte aligned, of `scratch_bytes`) holds at least the
// plan's `scratch` bytes on the wide form (d > 256; a smaller one is
// refused) and is unread elsewhere (null there). Returns
// cudaGetLastError().
int dm_attention(const void* qkv, const void* bias, void* out, int B, int N,
                 int C, int H, int d_scale, const int* plan, void* scratch,
                 long long scratch_bytes, cudaStream_t stream) {
  return static_cast<int>(attention(static_cast<const bf16*>(qkv),
                                    static_cast<const float*>(bias),
                                    static_cast<bf16*>(out), B, N, C, H,
                                    d_scale, plan, scratch, scratch_bytes,
                                    stream));
}

// K8: out (B, N, H, d) bf16 from q, k, v (B, N, H, d) bf16 and bias
// (H, N, N) f32, C = H·d, d % 8 == 0 and 8 <= d <= 8192. Requires 1 <= N
// <= 16384 and 16-byte aligned tensors; `d_scale` and `scratch` as
// dm_attention's.
// Returns cudaGetLastError().
int dm_attention_bnhd(const void* q, const void* k, const void* v,
                      const void* bias, void* out, int B, int N, int C, int H,
                      int d_scale, const int* plan, void* scratch,
                      long long scratch_bytes, cudaStream_t stream) {
  return static_cast<int>(attention_launch<false, true>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), C, static_cast<const float*>(bias),
      static_cast<bf16*>(out), nullptr, B, N, C, H, d_scale, plan, scratch,
      scratch_bytes, stream));
}

}  // extern "C"
