// Fused multi-head attention over packed heads, forward only.
//
// Replaces the TPU kernel xlxmert_tpu/ops/attention.py::mha_blhd
// (_mha_blhd_kernel): q (B, Lq, H*D), k/v (B, Lk, H*D) with D = 64 and
// any row and batch stride (the q/k/v thirds of one fused QKV projection
// are read in place), bias (B, Lk) bf16 or absent, out (B, Lq, H*D)
// contiguous. Head h is the column block [h*D, (h+1)*D): no transpose in
// device memory. bf16 inputs run on tensor cores (attention_mma.cuh),
// fp32 on CUDA cores (attention.cuh); each header says what bounds it on
// an H100 and what its design does about it.

#include "attention_mma.cuh"

extern "C" {

int mha_blhd_launch(const void* q, const void* k, const void* v,
                    const void* bias, void* out, int B, int H, int Lq,
                    int Lk, long long q_bs, long long q_rs, long long k_bs,
                    long long k_rs, long long v_bs, long long v_rs,
                    float scale, int dtype, int fast, void* stream) {
  const long long o_rs = static_cast<long long>(H) * attention::D;
  const attention::Strides st = {{q_bs, attention::D, q_rs},
                                 {k_bs, attention::D, k_rs},
                                 {v_bs, attention::D, v_rs},
                                 {Lq * o_rs, attention::D, o_rs}};
  return attention_mma::launch(q, k, v, bias, out, B, H, Lq, Lk, st, scale,
                               dtype, fast, stream);
}

const char* mha_blhd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
