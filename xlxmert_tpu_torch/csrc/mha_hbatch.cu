// Packed-head attention with every head of a batch row in one CTA.
//
// Replaces the TPU kernel `kern` of `core_hbatch` in
// scripts/drive_attention_layout.py (the pl.pallas_call of its `core`):
// q (B, Lq, H*D), k/v (B, Lk, H*D) in bf16 with D = 64 and any row and
// batch stride (the q/k/v thirds of one fused QKV projection are read in
// place), bias (B, Lk) bf16 or absent (a null pointer), out (B, Lq, H*D)
// contiguous. It computes mha_blhd(fast=True)'s function with the TPU
// kernel's organisation: one batched contraction over (batch row, head)
// for the scores and one for the context, then the heads written back
// as whole rows. Roundings, in kern's order: fp32 q.k^T, times 1/sqrt(D)
// in fp32, rounded to bf16, + bias in bf16, softmax in bf16 (fp32 sum,
// rounded), p in bf16, fp32 p.v, rounded to bf16.
//
// Design. One CTA per batch row, one warp per head (12 warps at H = 12).
// The CTA reads k and v as whole rows of H*D bf16 (16-byte loads,
// neighbouring threads on neighbouring addresses) into shared memory
// with cp.async, and q likewise in tiles of 16 rows; each warp takes its
// head's columns from those rows. Both products run on tensor cores
// (mma.sync.m16n8k16 bf16 -> fp32): the score accumulators of a 16-row
// tile stay in registers through the softmax and become the A operand of
// p.v as they are (the m16n8 accumulator layout is the m16k16 operand
// layout), v is read with ldmatrix.trans. Each warp writes its head's
// context into the q tile it has consumed, and the CTA stores the tile
// as whole rows.
//
// Shared memory: at Lk = 64, q, k and v of one batch row would take
// 3 x 64 x 768 x 2 B = 288 KB, more than the 227 KB a CTA may have. k and
// v stay whole (2 x 64 rows) and q streams in 16-row tiles: with rows
// padded by 16 bytes (4 banks, so the fragment loads of 8 rows hit 32
// distinct banks) that is (128 + 16) x 1,552 B = 218 KB at Lk = 64, one
// CTA per SM; 124 KB at Lk <= 32. Keys past Lk are zero rows in shared
// memory (never read from device memory) and -inf scores; text lengths
// that are not multiples of 16 pad the key tiles this way.
//
// What bounds it on an H100: at L <= 64 each (b, h) does 4 Lq Lk D flops
// on (2 Lq + 2 Lk) D x 2 bytes, ~32 flop/byte, far below the ~295 where
// the tensor cores become the limit, so the floor is device memory; every
// operand byte is read once. One CTA per SM and no overlap of one row's
// loads with another's products are what a faster version would change
// (a persistent CTA with a ring of batch rows, TMA, wgmma).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hbatch {

constexpr int D = 64;           // head dim of every LXMERT configuration
constexpr int kMaxHeads = 12;   // warps per CTA
constexpr int kMaxL = 64;
constexpr int kTile = 16;       // q rows per tile (the m16 of the mma)
constexpr int kPad = 8;         // row padding in shared memory (elements)

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [0, padded) of hd bf16 each into shared memory (row stride rs);
// rows [rows, padded) are zero-filled, never read from device memory.
// Thread i takes the i-th 16-byte piece: whole rows, coalesced.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long row_stride, int rows,
                                          int padded, int hd, int rs) {
  const int pieces = hd / 8;
  for (int idx = threadIdx.x; idx < padded * pieces; idx += blockDim.x) {
    const int r = idx / pieces;
    const int c = (idx % pieces) * 8;
    bf16* d = dst + r * rs + c;
    if (r < rows)
      cp_async16(d, src + r * row_stride + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// KT: key tiles of 16 (Lk padded to 16 KT). Grid: B CTAs of 32 H threads.
template <int KT>
__global__ void __launch_bounds__(32 * kMaxHeads)
    mha_hbatch_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ bias, bf16* __restrict__ out,
                      int H, int Lq, int Lk, long long q_bs, long long q_rs,
                      long long k_bs, long long k_rs, long long v_bs,
                      long long v_rs, float scale) {
  constexpr int LKP = 16 * KT;  // padded keys
  constexpr int NT = 2 * KT;    // score tiles of 8 keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = H * D;
  const int rs = hd + kPad;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + LKP * rs;
  bf16* qs = vs + LKP * rs;  // the q tile, then the context tile
  const int b = blockIdx.x;
  const int h = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int t = lane % 4;  // fragment column pair

  const bf16* qb = q + b * q_bs;
  // group 0: k and the first q tile; group 1: v
  load_rows(ks, k + b * k_bs, k_rs, Lk, LKP, hd, rs);
  load_rows(qs, qb, q_rs, min(Lq, kTile), kTile, hd, rs);
  cp_async_commit();
  load_rows(vs, v + b * v_bs, v_rs, Lk, LKP, hd, rs);
  cp_async_commit();

  // this thread's keys are 8j + 2t + {0, 1}: their bias, or -inf past Lk
  float kbias[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = 8 * j + 2 * t + e;
      kbias[j][e] = key >= Lk ? -INFINITY
                    : bias != nullptr
                        ? __bfloat162float(bias[static_cast<long long>(b) * Lk
                                                + key])
                        : 0.f;
    }

  const bf16* qh = qs + h * D;
  const bf16* kh = ks + h * D;
  const bf16* vh = vs + h * D;
  for (int m0 = 0; m0 < Lq; m0 += kTile) {
    if (m0 == 0) {
      cp_async_wait<1>();
    } else {
      load_rows(qs, qb + m0 * q_rs, q_rs, min(Lq - m0, kTile), kTile, hd,
                rs);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();

    // scores: the tile's 16 rows against every key, fp32 accumulators
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = 16 * kk + 2 * t;
      qa[kk][0] = ld32(qh + g * rs + c);
      qa[kk][1] = ld32(qh + (g + 8) * rs + c);
      qa[kk][2] = ld32(qh + g * rs + c + 8);
      qa[kk][3] = ld32(qh + (g + 8) * rs + c + 8);
    }
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const bf16* krow = kh + (8 * j + g) * rs + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(s[j], qa[kk], ld32(krow + 16 * kk), ld32(krow + 16 * kk + 8));
    }

    // scale and round, + bias, row max (rows g and g + 8; a row's keys
    // are spread over the 4 threads of a quad)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float kb = kbias[j][e % 2];
        float x = round_bf16(__fmul_rn(s[j][e], scale));
        if (kb == -INFINITY)
          x = -INFINITY;
        else if (bias != nullptr)
          x = round_bf16(__fadd_rn(x, kb));
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    // exponentials in bf16, their fp32 sum rounded to bf16, p = e / sum
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = 0.f;
        if (kbias[j][e % 2] != -INFINITY)
          x = round_bf16(expf(round_bf16(__fsub_rn(s[j][e], mx[e / 2]))));
        s[j][e] = x;
        sum[e / 2] = __fadd_rn(sum[e / 2], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 1));
      sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 2));
      sum[r] = round_bf16(sum[r]);
    }

    // context: p (the score tiles, as A operands) times v
    float o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    if (m0 == 0) {
      cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          pa[2 * half + r] =
              pack_bf16(__fdiv_rn(s[2 * kk + half][2 * r], sum[r]),
                        __fdiv_rn(s[2 * kk + half][2 * r + 1], sum[r]));
        }
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vh + (16 * kk + lane % 16) * rs + 16 * n2 +
                                  (lane / 16) * 8);
        mma_bf16(o[2 * n2], pa, bv[0], bv[1]);
        mma_bf16(o[2 * n2 + 1], pa, bv[2], bv[3]);
      }
    }

    // this head's context into the consumed q tile, then whole rows out
    __syncwarp();
    bf16* ch = qs + h * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(ch + g * rs + 8 * n) =
          pack_bf16(o[n][0], o[n][1]);
      *reinterpret_cast<uint32_t*>(ch + (g + 8) * rs + 8 * n) =
          pack_bf16(o[n][2], o[n][3]);
    }
    __syncthreads();
    const int rows = min(Lq - m0, kTile);
    const int pieces = hd / 8;
    bf16* ob = out + (static_cast<long long>(b) * Lq + m0) * hd;
    for (int idx = threadIdx.x; idx < rows * pieces; idx += blockDim.x) {
      const int r = idx / pieces;
      const int c = (idx % pieces) * 8;
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(r) * hd + c) =
          *reinterpret_cast<const uint4*>(qs + r * rs + c);
    }
    __syncthreads();  // the next tile overwrites qs
  }
}

template <int KT>
int launch_kt(const void* q, const void* k, const void* v, const void* bias,
              void* out, int B, int H, int Lq, int Lk, long long q_bs,
              long long q_rs, long long k_bs, long long k_rs, long long v_bs,
              long long v_rs, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(bf16) * (2 * 16 * KT + kTile) * (H * D + kPad);
  auto kernel = mha_hbatch_kernel<KT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, 32 * H, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), H, Lq, Lk, q_bs, q_rs, k_bs, k_rs, v_bs,
      v_rs, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hbatch

extern "C" {

// bf16 only; bias (B, Lk) bf16 or null; scale float32(1/sqrt(64)) as the
// caller rounds it. Returns the launch's cudaError_t (0 on success).
int mha_hbatch_launch(const void* q, const void* k, const void* v,
                      const void* bias, void* out, int B, int H, int Lq,
                      int Lk, long long q_bs, long long q_rs, long long k_bs,
                      long long k_rs, long long v_bs, long long v_rs,
                      float scale, void* stream) {
  using namespace hbatch;
  if (B < 1 || H < 1 || H > kMaxHeads || Lq < 1 || Lk < 1 || Lq > kMaxL ||
      Lk > kMaxL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((Lk + 15) / 16) {
    case 1:
      return launch_kt<1>(q, k, v, bias, out, B, H, Lq, Lk, q_bs, q_rs, k_bs,
                          k_rs, v_bs, v_rs, scale, s);
    case 2:
      return launch_kt<2>(q, k, v, bias, out, B, H, Lq, Lk, q_bs, q_rs, k_bs,
                          k_rs, v_bs, v_rs, scale, s);
    case 3:
      return launch_kt<3>(q, k, v, bias, out, B, H, Lq, Lk, q_bs, q_rs, k_bs,
                          k_rs, v_bs, v_rs, scale, s);
    default:
      return launch_kt<4>(q, k, v, bias, out, B, H, Lq, Lk, q_bs, q_rs, k_bs,
                          k_rs, v_bs, v_rs, scale, s);
  }
}

const char* mha_hbatch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
