// Fused multi-head attention on CUDA cores, forward only: the fp32 route
// of mha_blhd.cu (packed heads, (B, L, H*D)), fused_mha.cu ((B, H, L,
// D)) and mha_blhd_train.cu (packed heads with a dropout mask), whose
// bf16 route is attention_mma.cuh's tensor-core kernel. Only float is
// instantiated.
//
// Per (batch row, head): s = q k^T accumulated in fp32, times 1/sqrt(D),
// cast to the accumulator type (bf16 when `fast` and the inputs are
// bf16, else fp32), plus the additive key bias, softmax, p cast to the
// input type, [times the pre-scaled dropout mask, in the input type,]
// p v accumulated in fp32, stored in the input type. The mask is a
// template flag (kMask): the two serving kernels instantiate the body
// without it and compile to the code they had before it existed.
//
// Layout: each of q, k, v and the output has its own batch, head and row
// stride (elements); D = 64 is contiguous. Packed heads put head h at
// column h*D, so the q/k/v thirds of one fused QKV projection are read in
// place; (B, H, L, D) operands put it at h*L*D. bias (B, Lk) bf16 or
// absent.
//
// What bounds it on an H100: at L <= 64 and D = 64 each (b, h) pair does
// 4*Lq*Lk*D flops on (2*Lq + 2*Lk)*D*2 bytes, about 32 flop/byte at
// L = 64 -- far below the ~295 flop/byte where bf16 tensor cores take
// over, so the floor is the device-memory traffic of q, k, v and out.
// The design reads each operand once: one CTA per (b, h) stages its
// q/k/v tiles in shared memory (fp32, padded rows against bank
// conflicts), keeps the whole Lq x Lk score tile there, and writes only
// the context. The products run on CUDA cores with a 2-D register tile
// (8 rows x 4 columns of output per thread).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attention {

constexpr int kThreads = 128;  // 16 (columns) x 8 (rows) threads
constexpr int kMaxL = 64;
constexpr int D = 64;          // head dim of every LXMERT configuration

// Element strides of the batch, head and row dimensions of q, k, v and
// the output; the last dimension (D) is contiguous.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// value after a cast to T and back (p.astype(v.dtype) in the reference)
__device__ __forceinline__ float through(float x, float*) { return x; }
__device__ __forceinline__ float through(float x, __nv_bfloat16*) {
  return round_bf16(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Copies `rows` rows of D elements (global row stride `stride` elements)
// into fp32 shared memory with row stride `sstride`; rows in
// [rows, padded) are zero-filled. 16-byte global loads.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int sstride,
                                          const T* src, long long stride,
                                          int rows, int padded) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int idx = threadIdx.x; idx < padded * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * kVec;
    float* out = dst + r * sstride + c;
    if (r < rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * stride + c);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = to_f32(vals[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = 0.f;
    }
  }
}

// mask (kMask only): (B, H, Lq, Lk) contiguous, in the input type, the
// keep/keep_prob factors the caller drew.
template <typename T, bool kMask>
__device__ __forceinline__ void attend_body(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const __nv_bfloat16* __restrict__ bias,
    const T* __restrict__ mask, T* __restrict__ out, int H, int Lq, int Lk,
    const Strides& st, float scale, int round_scores) {
  constexpr int kCols = D / 16;  // output columns per thread in p.v
  extern __shared__ float smem[];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n_a = (Lq + 7) / 8;    // row groups of 8
  const int n_c = (Lk + 15) / 16;  // key groups of 16
  const int lq_pad = 8 * n_a;
  const int lk_pad = 16 * n_c;
  const int ps = lk_pad + 1;  // score row stride

  float* qs = smem;                      // lq_pad x (D+1)
  float* ks = qs + lq_pad * (D + 1);     // lk_pad x (D+1)
  float* vs = ks + lk_pad * (D + 1);     // Lk x D
  float* ps_ = vs + Lk * D;              // lq_pad x ps

  load_tile<T>(qs, D + 1, q + b * st.q[0] + h * st.q[1], st.q[2], Lq,
               lq_pad);
  load_tile<T>(ks, D + 1, k + b * st.k[0] + h * st.k[1], st.k[2], Lk,
               lk_pad);
  load_tile<T>(vs, D, v + b * st.v[0] + h * st.v[1], st.v[2], Lk, Lk);
  __syncthreads();

  // scores: thread (ty, tx) owns rows ty + 8a and keys tx + 16c
  {
    float acc[8][4];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
    // unrolled by 4 (here and in p.v): left rolled, the 64 x 64 case
    // took 0.43 ms instead of 0.25 ms at B=256 in chip_smoke.py on an H100
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = c < n_c ? ks[(tx + 16 * c) * (D + 1) + d] : 0.f;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        if (a < n_a) {
          const float qv = qs[(ty + 8 * a) * (D + 1) + d];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(qv, kv[c], acc[a][c]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int i = ty + 8 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        if (a < n_a && i < Lq && j < Lk) {
          float s = __fmul_rn(acc[a][c], scale);
          if (round_scores) s = round_bf16(s);
          if (bias != nullptr) {
            s = __fadd_rn(s, __bfloat162float(bias[b * Lk + j]));
            if (round_scores) s = round_bf16(s);
          }
          ps_[i * ps + j] = s;
        }
      }
    }
  }
  __syncthreads();

  // softmax: one warp per row, two keys per lane (Lk <= 64)
  {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    for (int i = warp; i < Lq; i += kThreads / 32) {
      float* row = ps_ + i * ps;
      const bool in0 = lane < Lk, in1 = lane + 32 < Lk;
      const float s0 = in0 ? row[lane] : -INFINITY;
      const float s1 = in1 ? row[lane + 32] : -INFINITY;
      float m = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float e0 = 0.f, e1 = 0.f;
      if (in0) {
        float x = __fsub_rn(s0, m);
        if (round_scores) x = round_bf16(x);
        e0 = expf(x);
        if (round_scores) e0 = round_bf16(e0);
      }
      if (in1) {
        float x = __fsub_rn(s1, m);
        if (round_scores) x = round_bf16(x);
        e1 = expf(x);
        if (round_scores) e1 = round_bf16(e1);
      }
      float sum = __fadd_rn(e0, e1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
      if (round_scores) sum = round_bf16(sum);
      const T* mrow = nullptr;
      if (kMask)
        mrow = mask + ((static_cast<long long>(b) * H + h) * Lq + i) * Lk;
      if (in0) {
        float p = __fdiv_rn(e0, sum);
        if (round_scores) p = round_bf16(p);
        p = through(p, static_cast<T*>(nullptr));
        // p and the mask are values of T: their product rounds once to T
        if (kMask) p = through(__fmul_rn(p, to_f32(mrow[lane])),
                               static_cast<T*>(nullptr));
        row[lane] = p;
      }
      if (in1) {
        float p = __fdiv_rn(e1, sum);
        if (round_scores) p = round_bf16(p);
        p = through(p, static_cast<T*>(nullptr));
        if (kMask) p = through(__fmul_rn(p, to_f32(mrow[lane + 32])),
                               static_cast<T*>(nullptr));
        row[lane + 32] = p;
      }
    }
  }
  __syncthreads();

  // context: thread (ty, tx) owns rows ty + 8a and columns tx + 16c
  {
    float acc[8][kCols];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[a][c] = 0.f;
#pragma unroll 4
    for (int j = 0; j < Lk; ++j) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[j * D + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        if (a < n_a) {
          const float p = ps_[(ty + 8 * a) * ps + j];
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[a][c] = fmaf(p, vv[c], acc[a][c]);
        }
      }
    }
    T* o = out + b * st.o[0] + h * st.o[1];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int i = ty + 8 * a;
      if (a < n_a && i < Lq) {
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          store(o + i * st.o[2] + tx + 16 * c, acc[a][c]);
      }
    }
  }
}

// The serving kernels' entry point (mha_blhd.cu, fused_mha.cu): no mask.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mha_blhd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const __nv_bfloat16* __restrict__ bias,
                    T* __restrict__ out, int H, int Lq, int Lk, Strides st,
                    float scale, int round_scores) {
  attend_body<T, false>(q, k, v, bias, nullptr, out, H, Lq, Lk, st, scale,
                        round_scores);
}

// The training kernel's entry point (mha_blhd_train.cu): p times mask.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mha_blhd_masked_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const __nv_bfloat16* __restrict__ bias,
                           const T* __restrict__ mask, T* __restrict__ out,
                           int H, int Lq, int Lk, Strides st, float scale,
                           int round_scores) {
  attend_body<T, true>(q, k, v, bias, mask, out, H, Lq, Lk, st, scale,
                       round_scores);
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v,
                 const void* bias, const void* mask, void* out, int B, int H,
                 int Lq, int Lk, const Strides& st, float scale,
                 int round_scores, cudaStream_t stream) {
  const int lq_pad = 8 * ((Lq + 7) / 8);
  const int lk_pad = 16 * ((Lk + 15) / 16);
  const size_t smem = sizeof(float) * (lq_pad * (D + 1) + lk_pad * (D + 1) +
                                       Lk * D + lq_pad * (lk_pad + 1));
  cudaError_t err;
  if (mask == nullptr) {
    auto kernel = mha_blhd_kernel<T>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<B * H, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const __nv_bfloat16*>(bias),
        static_cast<T*>(out), H, Lq, Lk, st, scale, round_scores);
  } else {
    auto kernel = mha_blhd_masked_kernel<T>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<B * H, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const __nv_bfloat16*>(bias),
        static_cast<const T*>(mask), static_cast<T*>(out), H, Lq, Lk, st,
        scale, round_scores);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attention

