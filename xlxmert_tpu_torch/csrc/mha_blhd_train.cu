// Fused multi-head attention over packed heads with a dropout mask: the
// forward of the training path's attention.
//
// Replaces the TPU kernel xlxmert_tpu/ops/attention.py::mha_blhd_train
// (:354; its forward _mha_blhd_train_fwd, body _mha_blhd_kernel :159 with
// mask_ref): q (B, Lq, H*D), k/v (B, Lk, H*D) with D = 64 and any row
// and batch stride (column slices of a projection are read in place),
// bias (B, Lk) bf16 or absent, mask (B, H, Lq, Lk) contiguous in the
// input type (the pre-scaled keep/keep_prob factors the model drew) or
// absent, out (B, Lq, H*D) contiguous. The mask multiplies the softmax
// probabilities after they are cast to the input type, before p v.
//
// bf16 inputs (the training default, fast or not) run attention_mma.cuh's
// tensor-core kernel with the mask operand; fp32 runs attention.cuh's
// CUDA-core body, exact to 1e-5. What bounds it on an H100: q, k, v and
// out move (2 Lq + 2 Lk) D elements per (b, h) and the mask Lq Lk more;
// at L = 64 the mask is a third of the traffic, and every byte is read
// once. The backward is a plain PyTorch recompute (ops/attention.py), as
// the JAX package's is an einsum.

#include "attention_mma.cuh"

extern "C" {

int mha_blhd_train_launch(const void* q, const void* k, const void* v,
                          const void* bias, const void* mask, void* out,
                          int B, int H, int Lq, int Lk, long long q_bs,
                          long long q_rs, long long k_bs, long long k_rs,
                          long long v_bs, long long v_rs, float scale,
                          int dtype, int fast, void* stream) {
  const long long o_rs = static_cast<long long>(H) * attention::D;
  const attention::Strides st = {{q_bs, attention::D, q_rs},
                                 {k_bs, attention::D, k_rs},
                                 {v_bs, attention::D, v_rs},
                                 {Lq * o_rs, attention::D, o_rs}};
  return attention_mma::launch_train(q, k, v, bias, mask, out, B, H, Lq, Lk,
                                     st, scale, dtype, fast, stream);
}

const char* mha_blhd_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
