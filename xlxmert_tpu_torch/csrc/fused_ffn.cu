// Fused FFN block, forward only: out = LN(W2 gelu(W1 x + b1) + b2 + x).
//
// Replaces the TPU kernel xlxmert_tpu/ops/ffn.py::fused_ffn (_kernel).
// x (M, 768) bf16; w1 (I, 768) and w2 (768, I) bf16 in nn.Linear's
// layout (row n = output channel n); b1 (I,), b2, g, beta (768,) fp32;
// out (M, 768) bf16. Rounding points, as the TPU kernel's: x W1 summed in
// fp32, + b1, gelu (tanh form or exact erfc) in fp32, h rounded to bf16;
// h W2 summed in fp32, + b2, + x; two-pass LayerNorm statistics in fp32
// (mean, then the mean of (y - mu)^2), rsqrt, times g, + beta, bf16 out.
//
// What bounds it on an H100: 4*M*768*I flops on M*768*4 + 2*768*I*2
// bytes: at I = 3,072 and M >= 256 that is above the ~295 flop/byte
// where the bf16 tensor cores, not device memory, set the floor (0.16 ms
// at M = 16,384 against 989 TFLOP/s). The design keeps the (M, I)
// intermediate out of device memory, as the TPU kernel does: one CTA of
// 8 warps owns 32 rows and all 768 output columns, whose fp32 sums stay
// in registers (96 a thread) for the whole loop over I. The TPU's
// sequential chunk axis becomes that loop: each 64-wide chunk of h is
// computed from the CTA's x rows (kept in shared memory), goes through
// gelu, is rounded to bf16 into shared memory and is multiplied into the
// output sums at once. Both products run on mma.sync.m16n8k16 (bf16 in,
// fp32 sums), each warp on 16 rows x 16 columns of a 64-column slice,
// its operands loaded with ldmatrix. The weights stream through an
// 8-stage cp.async ring of 64 x 64 tiles: 12 tiles of W1, then 12 of W2,
// per chunk; the LayerNorm epilogue reduces each row across the 4 warps
// of its row tile in shared memory.
//
// Measured on an H100 (chip_smoke.py; scripts/time_ffn_variants.py,
// which times this file with one part of a step taken away): up to
// M = 4,096 a launch is one wave, and one CTA's pass over I = 3,072 takes
// 0.42 ms, 1,152 steps of about 365 ns. Neither L2 nor the tensor cores
// set it: at M = 4,096, with 2 tiles in flight instead of 7 a pass takes
// 0.43 ms, with no weight loads 0.29 ms, with no barrier 0.32 ms, with
// no products 0.36 ms. A step is a serial chain on one CTA of 8 warps per SM: the
// ring wait, the barrier, the fragment loads and 4 dependent products
// per accumulator. More independent work per step and per SM (64-row
// wgmma tiles on two warpgroups, TMA) is the way out, and later work; so
// is the cost of the weights: every 32-row tile re-reads both of them
// (9.4 MB) from L2, as every TPU row tile re-read them from HBM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kH = 768;              // row width (hidden size)
constexpr int kBM = 32;              // rows per CTA
constexpr int kTile = 64;            // weight tile: 64 rows x 64 k
constexpr int kSlices = kH / kTile;  // W1 k-slices = W2 n-slices = 12
constexpr int kSteps = 2 * kSlices;  // weight tiles per chunk
constexpr int kThreads = 256;        // 8 warps: 2 row tiles x 4 col pairs
constexpr int kStages = 8;           // ring depth: 7 tiles in flight
constexpr int kXS = kH + 8;     // x row stride: 388 words, 4 mod 32
constexpr int kTS = kTile + 8;  // tile and h row stride: 36 words
constexpr int kSmemBytes =
    2 * (kBM * kXS + kBM * kTS + kStages * kTile * kTS) + 2 * kBM * 4 * 4;

// Four 8x8 bf16 matrices from shared memory; lanes 8j..8j+7 give the
// row addresses of matrix j, register j holds this lane's pair of it.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r,
                                            const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// waits until at most kStages - 2 of this thread's copy groups are
// pending
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16 in, fp32 sums. Not
// volatile: a register-only operation the compiler may schedule freely.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// jax.nn.gelu's order of operations, without fused multiply-adds
__device__ __forceinline__ float gelu(float h, int approx) {
  if (approx) {
    const float cube = __fmul_rn(__fmul_rn(h, h), h);
    const float inner = __fmul_rn(
        0.7978845834732056f, __fadd_rn(h, __fmul_rn(0.044715f, cube)));
    return __fmul_rn(h, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner))));
  }
  return __fmul_rn(__fmul_rn(0.5f, h),
                   erfcf(__fmul_rn(-h, 0.7071067690849304f)));
}

// Weight tile t of the sequence (chunk t / 24, step t % 24) into `dst`:
// steps 0..11 are W1 rows [c0, c0 + 64) x k [64 j, 64 j + 64), steps
// 12..23 are W2 rows [64 s, 64 s + 64) x k [c0, c0 + 64).
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int t,
                                          const __nv_bfloat16* w1,
                                          const __nv_bfloat16* w2, int I) {
  const int c0 = (t / kSteps) * kTile;
  const int j = t % kSteps;
#pragma unroll
  for (int it = 0; it < kTile * kTile / 8 / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / (kTile / 8);
    const int c = (idx % (kTile / 8)) * 8;
    const __nv_bfloat16* src =
        j < kSlices
            ? w1 + static_cast<long long>(c0 + r) * kH + j * kTile + c
            : w2 + static_cast<long long>((j - kSlices) * kTile + r) * I +
                  c0 + c;
    cp_async16(dst + r * kTS + c, src);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_ffn_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w1,
                     const float* __restrict__ b1,
                     const __nv_bfloat16* __restrict__ w2,
                     const float* __restrict__ b2,
                     const float* __restrict__ g,
                     const float* __restrict__ beta,
                     __nv_bfloat16* __restrict__ out, int M, int I,
                     float eps, int approx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* hs = xs + kBM * kXS;
  __nv_bfloat16* tiles = hs + kBM * kTS;
  float* red = reinterpret_cast<float*>(tiles + kStages * kTile * kTS);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;      // mma groupID
  const int tq = lane % 4;      // mma threadID_in_group
  const int mt = warp / 4;      // row tile: rows 16 mt .. 16 mt + 15
  const int np = warp % 4;      // column tiles 2 np, 2 np + 1 of a slice
  const int m0 = blockIdx.x * kBM;
  const int n_tiles = (I / kTile) * kSteps;
  // ldmatrix row addresses: this warp's A fragment (16 rows x 16 k) of a
  // [row][k] array, and its B fragments (8 columns x 32 k of a tile)
  const int a_off = 8 * (lane / 16);
  const int a_row = 16 * mt + lane % 8 + 8 * ((lane / 8) % 2);
  const int b_off = (16 * np + lane % 8) * kTS + 8 * (lane / 8);

  // x rows of this CTA (zeros past M), with the first weight tile, then
  // the rest of the ring
  for (int idx = tid; idx < kBM * (kH / 8); idx += kThreads) {
    const int r = idx / (kH / 8);
    const int c = (idx % (kH / 8)) * 8;
    if (m0 + r < M)
      cp_async16(xs + r * kXS + c,
                 x + static_cast<long long>(m0 + r) * kH + c);
    else
      *reinterpret_cast<uint4*>(xs + r * kXS + c) = make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(tiles + t * kTile * kTS, t, w1, w2, I);
    cp_async_commit();
  }

  float acc[kSlices][2][4];  // output sums: slice s, column tile 2 np + i
#pragma unroll
  for (int s = 0; s < kSlices; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][i][e] = 0.f;

  // Waits for tile t, then starts the copy of tile t + kStages - 1 into
  // the stage every warp has finished reading (tile t - 1's); returns
  // tile t.
  auto next_tile = [&](int t) -> const __nv_bfloat16* {
    cp_async_wait_ring();
    __syncthreads();
    const int ahead = t + kStages - 1;
    if (ahead < n_tiles)
      load_tile(tiles + (ahead % kStages) * kTile * kTS, ahead, w1, w2, I);
    cp_async_commit();
    return tiles + (t % kStages) * kTile * kTS;
  };
  // c[i] += a (this warp's 16 rows, 64 k from column k0 of `a`, row
  // stride `sa`) . tile (rows 8 (2 np + i).. x the same 64 k)^T
  auto mma_tile = [&](float (*c)[4], const __nv_bfloat16* a, int sa,
                      int k0, const __nv_bfloat16* tile) {
#pragma unroll
    for (int kp = 0; kp < kTile; kp += 32) {
      uint32_t b[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(b[i], tile + b_off + 8 * i * kTS + kp);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t af[4];
        ldmatrix_x4(af, a + a_row * sa + k0 + kp + 16 * half + a_off);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(c[i], af, b[i] + 2 * half);
      }
    }
  };

  int t = 0;
  for (int c0 = 0; c0 < I; c0 += kTile) {
    // h chunk: (32 x 64) = x (32 x 768) . W1[c0:c0+64]^T
    float hacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int j = 0; j < kSlices; ++j, ++t)
      mma_tile(hacc, xs, kXS, j * kTile, next_tile(t));
    // + b1, gelu, bf16 into hs (read after the next tile's barrier)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * mt + gq + 8 * half;
        const int col = 8 * (2 * np + i) + 2 * tq;
        const float h0 = gelu(__fadd_rn(hacc[i][2 * half], b1[c0 + col]),
                              approx);
        const float h1 = gelu(
            __fadd_rn(hacc[i][2 * half + 1], b1[c0 + col + 1]), approx);
        *reinterpret_cast<__nv_bfloat162*>(hs + row * kTS + col) =
            __floats2bfloat162_rn(h0, h1);
      }
    // output sums += h chunk (32 x 64) . W2[:, c0:c0+64]^T, slice by slice
#pragma unroll
    for (int s = 0; s < kSlices; ++s, ++t)
      mma_tile(acc[s], hs, kTS, 0, next_tile(t));
  }

  // epilogue: y = sums + b2 + x; each row's 768 columns lie on the 4
  // lanes of a quad in each of the 4 warps of its row tile. Rows of this
  // thread: 16 mt + 8 h + gq for h in {0, 1}.
  float* red_sum = red;            // [32 rows][4 column groups]
  float* red_sq = red + kBM * 4;
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int s = 0; s < kSlices; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * mt + 8 * (e / 2) + gq;
        const int c = s * kTile + 8 * (2 * np + i) + 2 * tq + e % 2;
        const float y = __fadd_rn(__fadd_rn(acc[s][i][e], b2[c]),
                                  __bfloat162float(xs[r * kXS + c]));
        acc[s][i][e] = y;
        sum[e / 2] += y;
      }
  // a row's total over its quad, then over the 4 warps, divided by 768
  auto row_mean = [&](float* v, float* buf, float* mean) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = v[h];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (tq == 0) buf[(16 * mt + 8 * h + gq) * 4 + np] = x;
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* b = buf + (16 * mt + 8 * h + gq) * 4;
      mean[h] = __fdiv_rn(b[0] + b[1] + b[2] + b[3],
                          static_cast<float>(kH));
    }
  };
  float mu[2], rstd[2];
  row_mean(sum, red_sum, mu);
  float sq[2] = {0.f, 0.f};
#pragma unroll
  for (int s = 0; s < kSlices; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = __fsub_rn(acc[s][i][e], mu[e / 2]);
        sq[e / 2] += __fmul_rn(d, d);
      }
  row_mean(sq, red_sq, rstd);
#pragma unroll
  for (int h = 0; h < 2; ++h) rstd[h] = rsqrtf(__fadd_rn(rstd[h], eps));
#pragma unroll
  for (int s = 0; s < kSlices; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 16 * mt + 8 * h + gq;
        const int c = s * kTile + 8 * (2 * np + i) + 2 * tq;
        if (row >= M) continue;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float n = __fmul_rn(__fsub_rn(acc[s][i][2 * h + e], mu[h]),
                                    rstd[h]);
          o[e] = __fadd_rn(__fmul_rn(n, g[c + e]), beta[c + e]);
        }
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<long long>(row) * kH + c) =
            __floats2bfloat162_rn(o[0], o[1]);
      }
}

}  // namespace

extern "C" {

// x (M, 768) bf16, w1 (I, 768) bf16, b1 (I,) fp32, w2 (768, I) bf16,
// b2 / g / beta (768,) fp32, out (M, 768) bf16; I a multiple of 64 and
// every pointer 16-byte aligned. approx: 1 = tanh gelu, 0 = exact.
// Returns the launch's cudaError_t (0 on success).
int fused_ffn_launch(const void* x, const void* w1, const void* b1,
                     const void* w2, const void* b2, const void* g,
                     const void* beta, void* out, int M, int I, float eps,
                     int approx, void* stream) {
  if (M < 1 || I < kTile || I % kTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fused_ffn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_ffn_kernel<<<(M + kBM - 1) / kBM, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(g), static_cast<const float*>(beta),
      static_cast<__nv_bfloat16*>(out), M, I, eps, approx);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_ffn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
