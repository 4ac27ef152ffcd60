// Int8 attention over packed heads with calibrated static scales,
// forward only.
//
// Replaces no pallas_call: it is the card's counterpart of the two int8
// einsums of xlxmert_tpu/serving/lxmert_int8.py::_attention_core_int8
// (:276-298), which XLA lowers onto the TPU's matrix unit. q (B, Lq, H*D),
// k/v (B, Lk, H*D) bf16 with D = 64 and any row and batch stride (column
// slices of the fused projections are read in place), bias (B, Lk) bf16
// or absent, out (B, Lq, H*D) bf16 contiguous. Per (batch row, head):
//   q8 = clip(rint(f32(q) * q_inv), -127, 127), likewise k8 and v8;
//   s  = f32(q8 . k8^T as int32) * c_s + f32(bias)  (c_s = qs*ks/sqrt(D));
//   p  = softmax(s) over the keys in fp32: exp(s - max) / sum;
//   p8 = rint(p * 127);
//   out = bf16(f32(p8 . v8 as int32) * c_v)          (c_v = vs/127).
// Every multiply and add is a separately rounded fp32 operation (no
// contraction into an FMA), as in the plain version
// (ops/attention_int8.mha_int8_reference); only expf and the order of the
// softmax sum differ, which can move one p8 by 1 (ctx by at most vs).
//
// What bounds it on an H100: like mha_blhd, the bytes of q, k, v and the
// output, (2 Lq + 2 Lk) D bf16 per (b, h), read once; the int8 products
// (4 Lq Lk D operations) are far below the 1,979 TOP/s int8 peak. What
// bounds this simple design is its instruction issue per query row. One
// CTA of 128 threads per (b, h): q, k and v are quantized as they are
// loaded (16-byte vectors) into shared memory, k with its 64-byte rows
// padded to 17 words and v stored transposed (sm_90 has no 8-bit
// ldmatrix.trans) with its key dimension zero-padded to a multiple of 4
// (Lk = 8, 12, 20 are not multiples of 32). Each lane then keeps its
// keys (lane, lane + 32) of k8 and its output columns (lane, lane + 32)
// of the transposed v8 in registers for all of the CTA's rows; a warp
// takes two query rows at a time (their shuffles and divisions overlap):
// the scores with __dp4a against a broadcast q row, the row's max and
// sum from warp shuffles, p8 into the warp's row buffer, the context
// with __dp4a against the broadcast p8 row. A template flag drops the
// second key of each lane where Lk <= 32. The tensor cores (mma.sync
// m16n8k32.s8) are left for a redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mha_int8 {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 64;
constexpr int D = 64;
constexpr int kRowWords = D / 4;          // 16 int32 words of int8 a row
constexpr int kKStride = kRowWords + 1;   // padded against bank conflicts

__device__ __forceinline__ int quantize(float x, float inv) {
  int q = __float2int_rn(__fmul_rn(x, inv));
  return max(-127, min(127, q));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

// 8 bf16 (one 16-byte vector) -> 8 floats
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

template <bool kWide>  // Lk > 32: each lane owns keys lane and lane + 32
__global__ void __launch_bounds__(kThreads)
mha_int8_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ bias,
                __nv_bfloat16* __restrict__ out, int H, int Lq, int Lk,
                long long q_bs, long long q_rs, long long k_bs,
                long long k_rs, long long v_bs, long long v_rs,
                float q_inv, float k_inv, float v_inv, float c_s,
                float c_v) {
  constexpr int kVWords = kWide ? kMaxL / 4 : kMaxL / 8;  // p8 . v8 words
  __shared__ __align__(16) uint32_t q8[kMaxL * kRowWords];
  __shared__ uint32_t k8[kMaxL * kKStride];
  __shared__ __align__(16) uint8_t v8t[D * (kMaxL + 4)];  // (D, Lkp) rows
  __shared__ __align__(16) uint32_t p8[kWarps][2][kMaxL / 4];  // 2 rows a warp

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lkp = (Lk + 3) & ~3;                 // keys padded to 4
  // odd word stride of v8t's rows: lanes reading one word of 32 rows
  // hit 32 banks
  const int vt_words = (lkp / 4) | 1;
  const uint32_t* v8t_w = reinterpret_cast<const uint32_t*>(v8t);

  // quantize q and k into rows of packed int8; v into v8t (transposed)
  const __nv_bfloat16* qb = q + b * q_bs + h * D;
  const __nv_bfloat16* kb = k + b * k_bs + h * D;
  const __nv_bfloat16* vb = v + b * v_bs + h * D;
  for (int t = tid; t < Lq * 8; t += kThreads) {
    const int row = t >> 3, part = t & 7;
    float f[8];
    load8(qb + row * q_rs + part * 8, f);
    q8[row * kRowWords + part * 2] =
        pack4(quantize(f[0], q_inv), quantize(f[1], q_inv),
              quantize(f[2], q_inv), quantize(f[3], q_inv));
    q8[row * kRowWords + part * 2 + 1] =
        pack4(quantize(f[4], q_inv), quantize(f[5], q_inv),
              quantize(f[6], q_inv), quantize(f[7], q_inv));
  }
  for (int t = tid; t < Lk * 8; t += kThreads) {
    const int row = t >> 3, part = t & 7;
    float f[8];
    load8(kb + row * k_rs + part * 8, f);
    k8[row * kKStride + part * 2] =
        pack4(quantize(f[0], k_inv), quantize(f[1], k_inv),
              quantize(f[2], k_inv), quantize(f[3], k_inv));
    k8[row * kKStride + part * 2 + 1] =
        pack4(quantize(f[4], k_inv), quantize(f[5], k_inv),
              quantize(f[6], k_inv), quantize(f[7], k_inv));
  }
  for (int t = tid; t < lkp * 8; t += kThreads) {
    const int row = t >> 3, part = t & 7;
    float f[8];
    if (row < Lk) {
      load8(vb + row * v_rs + part * 8, f);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = 0.f;    // zero-padded keys
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v8t[(part * 8 + i) * vt_words * 4 + row] =
          (uint8_t)(quantize(f[i], v_inv) & 0xff);
  }
  __syncthreads();

  // this lane's keys (lane, lane + 32) and output columns (lane,
  // lane + 32) stay in registers for all of the CTA's rows
  const int j0 = lane, j1 = lane + 32;
  uint32_t kr0[kRowWords], kr1[kRowWords], vr0[kVWords], vr1[kVWords];
#pragma unroll
  for (int w = 0; w < kRowWords; ++w) {
    kr0[w] = j0 < Lk ? k8[j0 * kKStride + w] : 0u;
    kr1[w] = kWide && j1 < Lk ? k8[j1 * kKStride + w] : 0u;
  }
#pragma unroll
  for (int w = 0; w < kVWords; ++w) {
    const bool in = w < lkp / 4;
    vr0[w] = in ? v8t_w[lane * vt_words + w] : 0u;
    vr1[w] = in ? v8t_w[(lane + 32) * vt_words + w] : 0u;
  }
  const __nv_bfloat16* bias_b = bias ? bias + (long long)b * Lk : nullptr;
  const float bias0 = (bias_b && j0 < Lk) ? __bfloat162float(bias_b[j0])
                                          : 0.f;
  const float bias1 = (bias_b && j1 < Lk) ? __bfloat162float(bias_b[j1])
                                          : 0.f;

  // two query rows a warp at a time, for the instructions of one row's
  // shuffles and divisions to overlap the other's
  for (int i0 = warp; i0 < Lq; i0 += 2 * kWarps) {
    const bool has1 = i0 + kWarps < Lq;
    const int rows[2] = {i0, has1 ? i0 + kWarps : i0};
    int acc[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint4* qv = reinterpret_cast<const uint4*>(q8 + rows[r] *
                                                        kRowWords);
      acc[r][0] = acc[r][1] = 0;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const uint4 qw = qv[x];                  // a broadcast read
        const uint32_t w4[4] = {qw.x, qw.y, qw.z, qw.w};
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          acc[r][0] = __dp4a((int)w4[y], (int)kr0[4 * x + y], acc[r][0]);
          if (kWide)
            acc[r][1] = __dp4a((int)w4[y], (int)kr1[4 * x + y], acc[r][1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float s0 = j0 < Lk
          ? __fadd_rn(__fmul_rn((float)acc[r][0], c_s), bias0) : -INFINITY;
      const float s1 = kWide && j1 < Lk
          ? __fadd_rn(__fmul_rn((float)acc[r][1], c_s), bias1) : -INFINITY;
      const float m = warp_max(fmaxf(s0, s1));
      const float e0 = j0 < Lk ? expf(__fsub_rn(s0, m)) : 0.f;
      const float e1 = kWide && j1 < Lk ? expf(__fsub_rn(s1, m)) : 0.f;
      const float sum = warp_sum(__fadd_rn(e0, e1));
      // p in [0, 1]: p8 in [0, 127]; keys past Lk get 0
      uint8_t* prow = reinterpret_cast<uint8_t*>(p8[warp][r]);
      prow[j0] = (uint8_t)__float2int_rn(
          __fmul_rn(__fdiv_rn(e0, sum), 127.f));
      if (kWide)
        prow[j1] = (uint8_t)__float2int_rn(
            __fmul_rn(__fdiv_rn(e1, sum), 127.f));
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint4* pv = reinterpret_cast<const uint4*>(p8[warp][r]);
      int c0 = 0, c1 = 0;
#pragma unroll
      for (int x = 0; x < kVWords / 4; ++x) {
        const uint4 pw = pv[x];                  // a broadcast read
        const uint32_t w4[4] = {pw.x, pw.y, pw.z, pw.w};
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          c0 = __dp4a((int)w4[y], (int)vr0[4 * x + y], c0);
          c1 = __dp4a((int)w4[y], (int)vr1[4 * x + y], c1);
        }
      }
      if (r == 0 || has1) {
        __nv_bfloat16* o = out + ((long long)b * Lq + rows[r]) * H * D +
                           h * D;
        o[lane] = __float2bfloat16_rn(__fmul_rn((float)c0, c_v));
        o[lane + 32] = __float2bfloat16_rn(__fmul_rn((float)c1, c_v));
      }
    }
    __syncwarp();                                // p8 is reused
  }
}

}  // namespace mha_int8

extern "C" {

int mha_int8_launch(const void* q, const void* k, const void* v,
                    const void* bias, void* out, int B, int H, int Lq,
                    int Lk, long long q_bs, long long q_rs, long long k_bs,
                    long long k_rs, long long v_bs, long long v_rs,
                    float q_inv, float k_inv, float v_inv, float c_s,
                    float c_v, void* stream) {
  if (Lq < 1 || Lk < 1 || Lq > mha_int8::kMaxL || Lk > mha_int8::kMaxL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = Lk > 32 ? mha_int8::mha_int8_kernel<true>
                         : mha_int8::mha_int8_kernel<false>;
  kernel<<<B * H, mha_int8::kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), H, Lq, Lk, q_bs, q_rs, k_bs, k_rs,
      v_bs, v_rs, q_inv, k_inv, v_inv, c_s, c_v);
  return static_cast<int>(cudaGetLastError());
}

const char* mha_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
