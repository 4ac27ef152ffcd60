// Fused multi-head attention in bf16 on Hopper's tensor cores, forward
// only: the bf16 route of mha_blhd.cu (packed heads, (B, L, H*D)), of
// fused_mha.cu ((B, H, L, D)) and, with a dropout mask, of
// mha_blhd_train.cu. Their fp32 route stays on attention.cuh's CUDA-core
// body, which is exact to 1e-5; on tensor cores fp32 would be TF32. The
// per-tile body (attend_tile, store_tile) is also mha_hbatch.cu's, so
// that kernel computes this one's bits in another organisation.
//
// Replaces the TPU kernels xlxmert_tpu/ops/attention.py::_mha_blhd_kernel
// (:159, called by mha_blhd, :256), ::_mha_kernel (:36, called by
// fused_mha) and, as the masked body (kMask), _mha_blhd_kernel with
// mask_ref (:159, called by mha_blhd_train, :354) for bf16 inputs. Per
// (batch row, head): s = q k^T accumulated in fp32, times 1/sqrt(D);
// with `fast` the scaled scores round to bf16, the bias adds in bf16 and
// the softmax runs in bf16 (its sum in fp32, rounded), as the
// reference's acc_dtype = bf16; without it scores and softmax stay fp32.
// p rounds to bf16 (with kMask: times the pre-scaled dropout factor,
// rounded to bf16 once more), p v accumulates in fp32 and is stored in
// bf16. These are attention.cuh's rounding points.
//
// What bounds it on an H100: each (b, h) pair does 4 Lq Lk D flops on
// (2 Lq + 2 Lk) D x 2 bytes, about 32 flop/byte at L = 64, far below the
// ~295 flop/byte where bf16 tensor cores become the limit, so the floor
// is the device-memory traffic of q, k, v and the context. The design
// reads every operand byte once, keeps the scores in registers, and
// keeps many small CTAs in flight so that one CTA's loads overlap
// another's products:
//   - one CTA per (batch row, head), one warp per 16-row q tile (1 to 4
//     warps, at most 28 KB of shared memory at Lq = Lk = 64: 8 CTAs per
//     SM). CTAs of 2 or 4 heads, which read k/v rows of 256 or 512
//     contiguous bytes instead of 128, measured slower at the 64-row
//     shapes and no faster at the text ones;
//   - the warp's m16n8k16 mma.sync tiles (bf16 -> fp32) cover its 16 rows
//     against every key; the score accumulators stay in registers
//     through the softmax (row max and sum by quad shuffles) and, packed
//     to bf16, are p v's A operand as they are (the m16n8 accumulator
//     layout is the m16k16 operand layout);
//   - operands stay bf16 in shared memory, loaded with 16-byte cp.async,
//     neighbouring threads on neighbouring addresses (each row is 128
//     contiguous bytes), rows padded by 16 bytes so the 8 rows of an
//     ldmatrix phase hit 32 distinct banks; q and k fragments come from
//     ldmatrix, v's from ldmatrix.trans;
//   - q and k arrive in one cp.async group and v in a second, which
//     lands while the scores and the softmax are computed;
//   - the bias row (Lk values) is read once per CTA, coalesced, into
//     shared memory; keys past Lk are zero rows in shared memory, never
//     read from device memory, and -inf scores;
//   - p = e times the row's reciprocal sum, not a division per score
//     (see the softmax below);
//   - with `fast`, a scaled score near a bf16 rounding tie is recomputed
//     in the plain version's fp32 order, so that it rounds as the plain
//     version's does (see the scores below);
//   - each warp writes its context into the q tile it has consumed and
//     stores it as whole 16-byte pieces of 128-byte rows.
//   - with kMask, the (Lq, Lk) mask of the (b, h) pair (a third of the
//     bytes at L = 64) is read once from device memory, straight into
//     the accumulator layout (4-byte pairs; 2-byte reads at odd Lk),
//     issued before the scores so that it lands during them; keys past
//     Lk and rows past Lq are not read.
// Not wgmma: its 64-row M tile would be mostly padding at Lq = 20, and
// the work is memory-bound, not product-bound.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"

namespace attention_mma {

using bf16 = __nv_bfloat16;
using attention::D;
using attention::kMaxL;
using attention::Strides;

constexpr int kRow = D + 8;  // shared row stride (elements): 144 B
// fp32 steps from a bf16 rounding midpoint within which a scaled score is
// recomputed in the plain version's order (near_bf16_tie, below)
constexpr int kTieUlps = 16;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// True where x lies within kTieUlps fp32 steps of a midpoint between two
// bf16 values, i.e. where another order of summing the products behind x
// can round it to the other neighbour.
__device__ __forceinline__ bool near_bf16_tie(float x) {
  const int low = static_cast<int>(__float_as_uint(x) & 0xffffu);
  return abs(low - 0x8000) <= kTieUlps;
}

// sum_d a[d] b[d] over one head's D bf16 values as the plain version's
// fp32 product sums it: one fused multiply-add per d, d = 0, 1, ..., D-1.
__device__ __noinline__ float dot_chain(const bf16* a, const bf16* b) {
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; d += 2) {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(a + d));
    const float2 y = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(b + d));
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

// Rows [0, padded) of one head (D elements each, global row stride
// row_stride) into shared memory with row stride kRow; rows [rows,
// padded) are zeroed, never read from device memory. Piece i (16 bytes)
// is column 8 (i % 8) of row i / 8: neighbouring threads read
// neighbouring addresses.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long row_stride, int rows,
                                          int padded) {
  for (int i = threadIdx.x; i < padded * (D / 8); i += blockDim.x) {
    const int c = (i % (D / 8)) * 8;
    const int r = i / (D / 8);
    bf16* d = dst + r * kRow + c;
    if (r < rows)
      cp_async16(d, src + r * row_stride + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// One warp's 16-row q tile of one (batch row, head) against all keys:
// the body that every bf16 kernel of the port runs (this file's kernel,
// and mha_hbatch.cu's). qh: the tile in shared memory (row stride kRow),
// which receives the context; ks, vs: the head's keys and values, 16 KT
// rows each, zero rows past Lk; kb: the Lk bias values in fp32, added
// where has_bias; mk: the dropout factors in the accumulator layout
// (kMask).
// kWaitV: v is still in flight in the caller's last cp.async group, and
// every thread of the CTA waits for it (cp.async.wait_group 0 and a
// barrier) after the softmax, before p v.
template <int KT, bool kFast, bool kMask, bool kWaitV>
__device__ __forceinline__ void attend_tile(
    bf16* qh, const bf16* ks, const bf16* vs, const float* kb,
    bool has_bias, uint32_t (&mk)[kMask ? 2 * KT : 1][2], int Lk,
    float scale) {
  constexpr int NT = 2 * KT;  // score tiles of 8 keys
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int t = lane % 4;  // fragment column pair

  // scores: the tile's 16 rows against every key, fp32 accumulators
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qa[kk], qh + (lane % 16) * kRow + 16 * kk + (lane / 16) * 8);
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // keys 8j..8j+7 at columns 32 half + [0, 32): b0/b1 of two k16 steps
      uint32_t kf[4];
      ldmatrix_x4(kf, ks + (8 * j + lane % 8) * kRow + 32 * half +
                          (lane / 8) * 8);
      mma_bf16(s[j], qa[2 * half], kf[0], kf[1]);
      mma_bf16(s[j], qa[2 * half + 1], kf[2], kf[3]);
    }
  }

  // scale (and round), + bias, row max over the keys below Lk (rows g and
  // g + 8; a row's keys are spread over the 4 threads of a quad). The
  // tensor cores add a row's products in another order than the plain
  // version's fp32 chain; when the bf16 rounding of the scaled score is
  // near a tie the two can round to neighbouring values, and in the bf16
  // softmax one such flip on a dominant key moves the context by up to
  // ~0.03 (0.0234 seen at 64 x 12 with the padding bias). Such a score is
  // recomputed as that chain: about one score in two thousand, which adds
  // 2-12 % to the kernel's time (scripts/time_attention_variants.py,
  // tie_off).
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * j + 2 * t + e % 2;
      float x = __fmul_rn(s[j][e], scale);
      if (kFast && key < Lk && near_bf16_tie(x))
        x = __fmul_rn(
            dot_chain(qh + (g + 8 * (e / 2)) * kRow, ks + key * kRow), scale);
      if (kFast) x = round_bf16(x);
      if (key >= Lk) {
        x = -INFINITY;
      } else if (has_bias) {
        x = __fadd_rn(x, kb[key]);
        if (kFast) x = round_bf16(x);
      }
      s[j][e] = x;
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  // exponentials (in bf16 when fast), their fp32 sum (rounded when fast)
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = 0.f;
      if (8 * j + 2 * t + e % 2 < Lk) {
        x = __fsub_rn(s[j][e], mx[e / 2]);
        if (kFast) x = round_bf16(x);
        x = expf(x);
        if (kFast) x = round_bf16(x);
      }
      s[j][e] = x;
      sum[e / 2] = __fadd_rn(sum[e / 2], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 1));
    sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 2));
    if (kFast) sum[r] = round_bf16(sum[r]);
  }
  // p = e * (1 / sum), rounded to bf16 once: p v's A operands. The
  // reference divides; the correctly rounded reciprocal times e is within
  // an fp32 step of e / sum, which moves a bf16 p only at a rounding
  // midpoint. A division per score costs more, most where the padding
  // bias zeroes e (a division of 0 leaves the division's fast path):
  // 0.0779 against 0.0578 ms at B=256, 64 x 64 with the bias, on an H100
  // SXM at 700 W (scripts/time_attention_variants.py, div). With kMask,
  // p rounds to bf16, then p times the mask rounds once more (two bf16
  // values, multiplied in fp32), as the plain version's p * mask.
  const float inv[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
  uint32_t pa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float p0 = __fmul_rn(s[2 * kk + half][2 * r], inv[r]);
        float p1 = __fmul_rn(s[2 * kk + half][2 * r + 1], inv[r]);
        if (kMask) {
          const float2 m = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  &mk[kMask ? 2 * kk + half : 0][r]));
          p0 = __fmul_rn(round_bf16(p0), m.x);
          p1 = __fmul_rn(round_bf16(p1), m.y);
        }
        pa[kk][2 * half + r] = pack_bf16(p0, p1);
      }

  if (kWaitV) {
    cp_async_wait<0>();
    __syncthreads();
  }

  // context: p times v, v's fragments transposed by ldmatrix
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vs + (16 * kk + lane % 16) * kRow + 16 * n2 +
                                (lane / 16) * 8);
      mma_bf16(o[2 * n2], pa[kk], bv[0], bv[1]);
      mma_bf16(o[2 * n2 + 1], pa[kk], bv[2], bv[3]);
    }

  // the context into the consumed q tile
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(qh + g * kRow + 8 * n + 2 * t) =
        pack_bf16(o[n][0], o[n][1]);
    *reinterpret_cast<uint32_t*>(qh + (g + 8) * kRow + 8 * n + 2 * t) =
        pack_bf16(o[n][2], o[n][3]);
  }
}

// The warp's context tile (attend_tile's qh, rows m0..m0+15 of the head)
// out as whole 16-byte pieces of 128-byte rows: ob is the head's row 0
// in device memory, row_stride its row stride; rows from Lq on are not
// written.
__device__ __forceinline__ void store_tile(bf16* ob, long long row_stride,
                                           const bf16* qh, int m0, int Lq) {
  const int lane = threadIdx.x % 32;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * (D / 8) / 32; ++i) {
    const int piece = 32 * i + lane;
    const int r = piece / (D / 8);
    const int c = (piece % (D / 8)) * 8;
    if (m0 + r < Lq)
      *reinterpret_cast<uint4*>(ob + (m0 + r) * row_stride + c) =
          *reinterpret_cast<const uint4*>(qh + r * kRow + c);
  }
}

// KT: key tiles of 16 (Lk padded to 16 KT); kFast: bf16 scores and
// softmax; kMask: p times the dropout mask. Grid: B * H CTAs, CTA (b, h)
// = (blockIdx.x / H, blockIdx.x % H), of 32 QT threads (QT = q tiles of
// 16 rows): warp w takes q tile w.
template <int KT, bool kFast, bool kMask>
__global__ void __launch_bounds__(32 * (kMaxL / 16))
    attend_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ bias,
                      const bf16* __restrict__ mask, bf16* __restrict__ out,
                      int H, int Lq, int Lk, Strides st, float scale) {
  constexpr int LKP = 16 * KT;  // padded keys
  constexpr int NT = 2 * KT;    // score tiles of 8 keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LQP = 16 * ((Lq + 15) / 16);
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // LQP rows
  bf16* ks = qs + LQP * kRow;                    // LKP rows
  bf16* vs = ks + LKP * kRow;                    // LKP rows
  float* kb = reinterpret_cast<float*>(vs + LKP * kRow);  // Lk bias

  // group 0: q and k; group 1: v, which lands during the softmax
  load_rows(qs, q + b * st.q[0] + h * st.q[1], st.q[2], Lq, LQP);
  load_rows(ks, k + b * st.k[0] + h * st.k[1], st.k[2], Lk, LKP);
  cp_async_commit();
  load_rows(vs, v + b * st.v[0] + h * st.v[1], st.v[2], Lk, LKP);
  cp_async_commit();
  if (bias != nullptr)
    for (int j = threadIdx.x; j < Lk; j += blockDim.x)
      kb[j] = __bfloat162float(bias[static_cast<long long>(b) * Lk + j]);

  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int t = lane % 4;  // fragment column pair
  const int m0 = 16 * (threadIdx.x / 32);
  bf16* qh = qs + m0 * kRow;  // this warp's q tile

  // the dropout mask, read once from device memory straight into the
  // accumulator layout while q, k and v land: mk[j][r] holds the factors
  // of row m0 + g + 8r at keys 8j + 2t and 8j + 2t + 1 (0 past Lq or Lk)
  uint32_t mk[kMask ? NT : 1][2];
  if (kMask) {
    const bf16* mb = mask + (static_cast<long long>(b) * H + h) * Lq * Lk;
    // pairs are 4-byte aligned when Lk is even (and the mask is)
    const bool pairs =
        Lk % 2 == 0 && (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + g + 8 * r;
        const int key = 8 * j + 2 * t;
        uint32_t val = 0u;
        if (row < Lq && key < Lk) {
          const bf16* p = mb + row * Lk + key;
          if (pairs) {
            val = *reinterpret_cast<const uint32_t*>(p);
          } else {
            val = *reinterpret_cast<const uint16_t*>(p);
            if (key + 1 < Lk)
              val |= static_cast<uint32_t>(
                         *reinterpret_cast<const uint16_t*>(p + 1))
                     << 16;
          }
        }
        mk[j][r] = val;
      }
  }

  cp_async_wait<1>();
  __syncthreads();
  attend_tile<KT, kFast, kMask, true>(qh, ks, vs, kb, bias != nullptr, mk,
                                      Lk, scale);
  store_tile(out + b * st.o[0] + h * st.o[1], st.o[2], qh, m0, Lq);
}

template <int KT, bool kFast, bool kMask>
int launch_kt(const bf16* q, const bf16* k, const bf16* v, const bf16* bias,
              const bf16* mask, bf16* out, int B, int H, int Lq, int Lk,
              const Strides& st, float scale, cudaStream_t stream) {
  const int qt = (Lq + 15) / 16;
  const size_t smem = sizeof(bf16) * (16 * qt + 2 * 16 * KT) * kRow +
                      sizeof(float) * Lk;
  auto kernel = attend_mma_kernel<KT, kFast, kMask>;
  kernel<<<B * H, 32 * qt, smem, stream>>>(q, k, v, bias, mask, out, H, Lq,
                                           Lk, st, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kFast, bool kMask>
int launch_fast(const bf16* q, const bf16* k, const bf16* v, const bf16* bias,
                const bf16* mask, bf16* out, int B, int H, int Lq, int Lk,
                const Strides& st, float scale, cudaStream_t s) {
  switch ((Lk + 15) / 16) {
    case 1:
      return launch_kt<1, kFast, kMask>(q, k, v, bias, mask, out, B, H, Lq,
                                        Lk, st, scale, s);
    case 2:
      return launch_kt<2, kFast, kMask>(q, k, v, bias, mask, out, B, H, Lq,
                                        Lk, st, scale, s);
    case 3:
      return launch_kt<3, kFast, kMask>(q, k, v, bias, mask, out, B, H, Lq,
                                        Lk, st, scale, s);
    default:
      return launch_kt<4, kFast, kMask>(q, k, v, bias, mask, out, B, H, Lq,
                                        Lk, st, scale, s);
  }
}

template <bool kMask>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* bias, const void* mask, void* out, int B, int H,
                int Lq, int Lk, const Strides& st, float scale, int fast,
                cudaStream_t s) {
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* bp = static_cast<const bf16*>(bias);
  const auto* mp = static_cast<const bf16*>(mask);
  auto* op = static_cast<bf16*>(out);
  if (fast)
    return launch_fast<true, kMask>(qp, kp, vp, bp, mp, op, B, H, Lq, Lk, st,
                                    scale, s);
  return launch_fast<false, kMask>(qp, kp, vp, bp, mp, op, B, H, Lq, Lk, st,
                                   scale, s);
}

inline bool valid(int B, int H, int Lq, int Lk, int dtype) {
  return B >= 1 && H >= 1 && Lq >= 1 && Lk >= 1 && Lq <= kMaxL &&
         Lk <= kMaxL && (dtype == 0 || dtype == 1);
}

// The serving kernels' entry point (mha_blhd.cu, fused_mha.cu). dtype 1
// (bf16): this file's tensor-core kernel; dtype 0 (fp32): attention.cuh's
// CUDA-core body. q/k/v/out with the strides of `st` (D contiguous), bias
// (B, Lk) bf16 or null, head dim 64, lengths 1..64; scale
// float32(1/sqrt(64)) as the caller rounds it; `fast` rounds the scores
// and softmax to bf16 (bf16 inputs only). Returns the launch's
// cudaError_t (0 on success).
inline int launch(const void* q, const void* k, const void* v,
                  const void* bias, void* out, int B, int H, int Lq, int Lk,
                  const Strides& st, float scale, int dtype, int fast,
                  void* stream) {
  if (!valid(B, H, Lq, Lk, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return attention::launch_typed<float>(q, k, v, bias, nullptr, out, B, H,
                                          Lq, Lk, st, scale, 0, s);
  return launch_bf16<false>(q, k, v, bias, nullptr, out, B, H, Lq, Lk, st,
                            scale, fast, s);
}

// The training kernel's entry point (mha_blhd_train.cu): launch's
// arguments and a dropout mask (B, H, Lq, Lk) contiguous in the input
// type, or null. bf16 runs this file's kernel with the mask operand;
// fp32 attention.cuh's masked body.
inline int launch_train(const void* q, const void* k, const void* v,
                        const void* bias, const void* mask, void* out, int B,
                        int H, int Lq, int Lk, const Strides& st, float scale,
                        int dtype, int fast, void* stream) {
  if (!valid(B, H, Lq, Lk, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return attention::launch_typed<float>(q, k, v, bias, mask, out, B, H, Lq,
                                          Lk, st, scale, 0, s);
  if (mask == nullptr)
    return launch_bf16<false>(q, k, v, bias, nullptr, out, B, H, Lq, Lk, st,
                              scale, fast, s);
  return launch_bf16<true>(q, k, v, bias, mask, out, B, H, Lq, Lk, st, scale,
                           fast, s);
}

}  // namespace attention_mma
