// Fused multi-head attention over (B, H, L, D) operands, forward only.
//
// Replaces the TPU kernel xlxmert_tpu/ops/attention.py::fused_mha
// (_mha_kernel): q (B, H, Lq, D), k/v (B, H, Lk, D) with D = 64 and any
// batch, head and row stride (head-transposed views of a projection are
// read in place), bias (B, Lk) bf16 or absent, out (B, H, Lq, D)
// contiguous. The same device code as mha_blhd.cu: bf16 on tensor cores
// (attention_mma.cuh), fp32 on CUDA cores (attention.cuh), each header
// saying what bounds it on an H100; only the head stride differs.

#include "attention_mma.cuh"

extern "C" {

// Strides in elements: batch, head, row of q, then of k, then of v.
int fused_mha_launch(const void* q, const void* k, const void* v,
                     const void* bias, void* out, int B, int H, int Lq,
                     int Lk, long long q_bs, long long q_hs, long long q_rs,
                     long long k_bs, long long k_hs, long long k_rs,
                     long long v_bs, long long v_hs, long long v_rs,
                     float scale, int dtype, int fast, void* stream) {
  const long long o_hs = static_cast<long long>(Lq) * attention::D;
  const attention::Strides st = {{q_bs, q_hs, q_rs},
                                 {k_bs, k_hs, k_rs},
                                 {v_bs, v_hs, v_rs},
                                 {H * o_hs, o_hs, attention::D}};
  return attention_mma::launch(q, k, v, bias, out, B, H, Lq, Lk, st, scale,
                               dtype, fast, stream);
}

const char* fused_mha_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
