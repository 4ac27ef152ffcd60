// Int8 dense layer: activation quantization, int8 x int8 -> int32 product
// on the tensor cores, dequantization and bias, bf16 out.
//
// Replaces the TPU kernel xlxmert_tpu/ops/int8_matmul.py::int8_dense_fused
// (_kernel), and carries the static-scale dense that the JAX package
// leaves to XLA (xlxmert_tpu/ops/quant.py::int8_dense_static). Two
// prologue modes over x (M, K) bf16:
//   dynamic: s = max(amax(|x_row|) / 127, 1e-8); x8 = round(x / s)
//            out = acc * s * scale[n] + bias[n]
//   static:  x8 = clip(round(x * inv_a), -127, 127)
//            out = acc * out_scale[n] + bias[n]
// Rounding is to nearest even (__float2int_rn), as jnp.round.
// w is (N, K) int8, row n = output channel n (nn.Linear layout).
//
// What bounds it on an H100: 2*M*N*K int8 ops on M*K*2 + N*K + M*N*2
// bytes, against 1,979 TOP/s and 3.35 TB/s (the ridge is ~590 ops per
// byte). chip_smoke.py's bound puts the serving shapes near that ridge,
// mostly on the bytes side: the text rows (M = 256*L = 2,048..5,120)
// need 0.6-1.0x as long for their operations as for their bytes, the
// visual rows (M = 16,384) 0.6-1.0x, and only the two FFN products there
// (768 -> 3,072 and 3,072 -> 768) are bound by operations, by ~2%. The
// answer head (M = 256) and the calibration shapes (M = 8*20, 8*64, 8)
// are bound by bytes, at M = 8 by reading w alone. The design
// feeds mma.sync.m16n8k32.s8 from shared memory: a 64 x 128 output tile
// per CTA of 4 warps (32 x 64 each), K in steps of 64; the activation
// tile is quantized on its way into shared memory, so the int8 copy of x
// never goes to device memory, and the dequantization happens on the
// int32 accumulators in registers. The dynamic mode first reduces its 64
// rows' amax over the whole K (re-read from L2 by every column tile).
// Edge tiles (M not a multiple of 64, N = 3,129) are masked. No
// pipelining, wgmma or TMA yet: those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kSK = kBK + 16;  // shared row stride in bytes: conflict-free
constexpr int kThreads = 128;

__device__ __forceinline__ int quantize(float x, float s, float inv_a,
                                        int dynamic) {
  const float y = dynamic ? __fdiv_rn(x, s) : __fmul_rn(x, inv_a);
  const int r = __float2int_rn(y);
  return min(max(r, -127), 127);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
    int8_dense_kernel(const __nv_bfloat16* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ col_scale,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int M, int N, int K,
                      float inv_a, int dynamic) {
  __shared__ __align__(16) int8_t a_s[kBM * kSK];
  __shared__ __align__(16) int8_t b_s[kBN * kSK];
  __shared__ float row_scale[kBM];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // mma groupID
  const int t = lane % 4;  // mma threadID_in_group
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  if (dynamic) {
    for (int r = warp; r < kBM; r += kThreads / 32) {
      const int m = m0 + r;
      float amax = 0.f;
      if (m < M) {
        const __nv_bfloat16* row = x + static_cast<long long>(m) * K;
        for (int k = lane * 8; k < K; k += 32 * 8) {
          const uint4 raw = *reinterpret_cast<const uint4*>(row + k);
          const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            amax = fmaxf(amax, fabsf(__bfloat162float(v[e])));
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      if (lane == 0) row_scale[r] = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
    }
    __syncthreads();
  }

  const int wm = (warp / 2) * 32;  // warp tile: 32 rows x 64 columns
  const int wn = (warp % 2) * 64;
  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // activation tile: 64 rows x 64 bf16, quantized into a_s
#pragma unroll
    for (int it = 0; it < (kBM * kBK / 8) / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx / (kBK / 8);
      const int c = (idx % (kBK / 8)) * 8;
      const int m = m0 + r;
      const int k = k0 + c;
      uint32_t lo = 0, hi = 0;
      if (m < M && k < K) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            x + static_cast<long long>(m) * K + k);
        const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
        const float s = dynamic ? row_scale[r] : 1.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lo |= (static_cast<uint32_t>(
                     quantize(__bfloat162float(v[e]), s, inv_a, dynamic)) &
                 0xffu)
                << (8 * e);
          hi |= (static_cast<uint32_t>(
                     quantize(__bfloat162float(v[e + 4]), s, inv_a, dynamic)) &
                 0xffu)
                << (8 * e);
        }
      }
      *reinterpret_cast<uint2*>(a_s + r * kSK + c) = make_uint2(lo, hi);
    }
    // weight tile: 128 rows (n) x 64 bytes (k)
#pragma unroll
    for (int it = 0; it < (kBN * kBK / 16) / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx / (kBK / 16);
      const int c = (idx % (kBK / 16)) * 16;
      const int n = n0 + r;
      const int k = k0 + c;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (n < N && k < K)
        raw = *reinterpret_cast<const uint4*>(
            w + static_cast<long long>(n) * K + k);
      *reinterpret_cast<uint4*>(b_s + r * kSK + c) = raw;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[2][4];
      uint32_t bf[8][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* base = a_s + (wm + i * 16 + g) * kSK + kk + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(base);
        af[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kSK);
        af[i][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kSK + 16);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int8_t* base = b_s + (wn + j * 8 + g) * kSK + kk + t * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(base);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // epilogue: acc element e sits at row g (+8 for e >= 2), column 2t + e%2
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm + i * 16 + g + half * 8;
      const int m = m0 + r;
      if (m >= M) continue;
      const float rs = dynamic ? row_scale[r] : 1.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + 2 * t + e;
          if (n >= N) continue;
          float val = __int2float_rn(acc[i][j][half * 2 + e]);
          if (dynamic) val = __fmul_rn(val, rs);
          val = __fmul_rn(val, col_scale[n]);
          if (bias != nullptr) val = __fadd_rn(val, bias[n]);
          out[static_cast<long long>(m) * N + n] = __float2bfloat16_rn(val);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x (M, K) bf16, w (N, K) int8, col_scale (N,) fp32: the weight scale
// (dynamic) or out_scale (static), bias (N,) fp32 or null, out (M, N)
// bf16. K must be a multiple of 16 and every pointer 16-byte aligned.
// Returns the launch's cudaError_t (0 on success).
int int8_dense_launch(const void* x, const void* w, const void* col_scale,
                      const void* bias, void* out, int M, int N, int K,
                      float inv_a, int dynamic, void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_dense_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(col_scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), M, N, K, inv_a, dynamic);
  return static_cast<int>(cudaGetLastError());
}

const char* int8_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
