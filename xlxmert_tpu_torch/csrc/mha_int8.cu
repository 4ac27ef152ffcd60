// Int8 attention over packed heads with calibrated static scales, on
// Hopper's tensor cores, forward only.
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
// contraction into an FMA) and e / sum the IEEE quotient, as in the plain
// version (ops/attention_int8.mha_int8_reference); only expf and the
// order of the softmax sum differ, which can move one p8 by 1 (ctx by at
// most vs).
//
// What bounds it on an H100: like mha_blhd, the bytes of q, k, v and the
// output, (2 Lq + 2 Lk) D bf16 per (b, h), read once; the int8 products
// (4 Lq Lk D operations) are far below the 1,979 TOP/s int8 peak. A lane's
// serial row chain of __dp4a, shuffles, expf and divisions on the CUDA
// cores is bound by its instruction issue; this design moves both
// products onto the tensor cores and cuts the instructions around them:
//   - one CTA per (batch row, head), one warp per 16-row query tile (1 to
//     4 warps); keys padded to 32 KC (KC = 1 or 2 chunks of 32);
//   - q, k and v are read once, 16 bytes a thread, all of a CTA's loads in
//     flight at once (four k pieces and one v item a thread), and are
//     quantized in registers: x * inv, clamped, plus 1.5 * 2^23, whose low
//     byte is the rounded int8 (no trip through the conversion unit). A
//     warp's q rows go straight into its A fragments. k8 rows (80-byte
//     stride: the 8 rows of an ldmatrix phase hit 32 banks) and v8
//     transposed to (d, key) rows (sm_90 has no 8-bit ldmatrix.trans;
//     each thread transposes 4 keys x 4 d with __byte_perm and stores
//     whole words) go to shared memory. Nothing past Lk is loaded or
//     written: those keys' scores are masked and their p8 is 0;
//   - the scores are mma.sync m16n8k32 s8 x s8 -> s32 tiles, k8's B
//     fragments by ldmatrix. A thread's A fragment holds d 8t..8t+7 of
//     its rows (t: its column in the quad; one 16-byte load) where the
//     PTX layout names columns 4t..4t+3 and 16+4t..16+4t+3: k8's rows are
//     stored with the same permutation of d, and a sum of int32 products
//     does not depend on the order of d;
//   - the softmax runs on the accumulators in registers: the row max over
//     the thread's keys, then across the quad by shuffles; the row sum as
//     a butterfly over the key slots (keys 32, 16, 8, 4, 2, 1 apart), the
//     order of a warp's xor-shuffle sum over keys (lane, lane + 32);
//     e / sum from the row's IEEE reciprocal and two exact residual steps
//     (five instructions for the correctly rounded quotient, where a
//     division takes a dozen and a range check), skipped where e is 0.
//     Score tiles whose keys are all past Lk, and a tile's upper 8 rows
//     where all are past Lq, are skipped whole (warp-uniform);
//   - p8 becomes p . v8's A operand with no shuffle and no shared memory:
//     the accumulator of an m16n8 tile gives a thread columns 2t and
//     2t + 1, the m16k32 A operand wants columns 4t..4t+3 and
//     16+4t..16+4t+3. So k8's B fragments are loaded in a permuted key
//     order: in the 32-key chunk c, column n of score tile j (0..3, 8 keys
//     each) is key 32c + 16(j>>1) + 4(n>>1) + 2(j&1) + (n&1). A thread's
//     pairs in tiles 0 and 1 are then keys 4t..4t+3 (a0: row g, a1: row
//     g + 8), in tiles 2 and 3 keys 16+4t..16+4t+3 (a2, a3). ldmatrix
//     takes one row address per lane, so the permutation costs nothing;
//     the bias and the key < Lk mask are read through it. Both products
//     are exact int32 sums (|q8 . k8| <= 64 * 127^2 < 2^22), so neither
//     order changes a bit;
//   - ldmatrix of v8^T's rows gives p . v8's B fragments directly (b0:
//     keys 4t..4t+3 of column g); the int32 results become fp32 exactly
//     (the fp32 bits of 1.5 * 2^23 + n, minus 1.5 * 2^23);
//   - each warp stages its bf16 context in shared memory and stores it as
//     whole 16-byte pieces of 128-byte rows.
// Not wgmma: its 64-row M tile would be mostly padding at Lq = 8..20,
// and the work is memory-bound. What is left between it and its bound on
// an H100 (scripts/time_int8_attention_variants.py): the expf, the
// quantization, the quotient and the stores each take 7-11 % of its time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mha_int8 {

using bf16 = __nv_bfloat16;

constexpr int D = 64;
constexpr int kMaxL = 64;
constexpr int kKRow = D + 16;          // bytes of a k8 row in shared memory
constexpr int kORow = D + 8;           // bf16 of a staged context row
constexpr int kUnroll = 4;             // k pieces a thread loads at once
constexpr float kRound = 12582912.f;   // 1.5 * 2^23: its fp32 step is 1

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x * inv rounded to the nearest integer (ties to even) and clamped to
// +-127, as __float2int_rn and a clamp give it, returned as the fp32 bits
// of 1.5 * 2^23 + q: the low byte is q in two's complement. Clamping
// before the rounding addition is exact for every finite x.
__device__ __forceinline__ uint32_t quantize(float x, float inv) {
  return __float_as_uint(
      __fadd_rn(fminf(fmaxf(__fmul_rn(x, inv), -127.f), 127.f), kRound));
}

// the low bytes of four words in one, the first lowest
__device__ __forceinline__ uint32_t pack_low(uint32_t a, uint32_t b,
                                             uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// four bf16 (two words, the first lowest) -> four int8 in one word
__device__ __forceinline__ uint32_t quantize4(uint32_t lo, uint32_t hi,
                                              float inv) {
  return pack_low(quantize(__uint_as_float(lo << 16), inv),
                  quantize(__uint_as_float(lo & 0xffff0000u), inv),
                  quantize(__uint_as_float(hi << 16), inv),
                  quantize(__uint_as_float(hi & 0xffff0000u), inv));
}

// RN(a / b) for b in [1, 64] and RN(a / b) normal, from y = RN(1 / b)
__device__ __forceinline__ float quotient(float a, float b, float y) {
  const float q0 = __fmul_rn(a, y);
  const float q1 = __fmaf_rn(__fmaf_rn(-b, q0, a), y, q0);
  return __fmaf_rn(__fmaf_rn(-b, q1, a), y, q1);
}

// n as fp32, exactly, for |n| < 2^22
__device__ __forceinline__ float exact_float(int n) {
  return __fsub_rn(__int_as_float(0x4B400000 + n), kRound);
}

__device__ __forceinline__ uint4 load16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const uint8_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Shared memory of one CTA: k8 (32 KC rows of kKRow bytes), v8^T (D rows
// of 32 KC + 16 bytes), the bias (kMaxL floats), then a tile of 16 rows
// of kORow bf16 for each of its qt warps, which stages its context.
__host__ __device__ constexpr int smem_bytes(int kc, int qt) {
  return 32 * kc * kKRow + D * (32 * kc + 16) + 4 * kMaxL +
         qt * 16 * kORow * 2;
}

// v8^T item i < n (n = 8 ceil(Lk / 4)): keys 4kg..4kg+3 (kg = i / 8) by
// d 8p..8p+7 (p = i % 8), zero past Lk; eight lanes a key row
__device__ __forceinline__ void load_v(uint4 (&raw)[4], const bf16* vb,
                                       long long v_rs, int Lk, int n,
                                       int i) {
  const int kg = i / 8;
  const int p = i % 8;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = 4 * kg + r;
    raw[r] = i < n && key < Lk ? load16(vb + key * v_rs + 8 * p)
                               : make_uint4(0u, 0u, 0u, 0u);
  }
}

// the item's two 4 x 4 byte blocks, quantized and transposed in
// registers, as whole words of v8^T's rows d
template <int KP>
__device__ __forceinline__ void store_v(uint8_t* v8t, const uint4 (&raw)[4],
                                        float v_inv, int i) {
  constexpr int kVRow = KP + 16;
  const int kg = i / 8;
  const int p = i % 8;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t w[4];  // key 4kg + r: d 8p + 4 half + [0, 4)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w[r] = half ? quantize4(raw[r].z, raw[r].w, v_inv)
                  : quantize4(raw[r].x, raw[r].y, v_inv);
    const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
    const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
    uint8_t* dst = v8t + (8 * p + 4 * half) * kVRow + 4 * kg;
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo01, lo23, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + kVRow) =
        __byte_perm(lo01, lo23, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * kVRow) =
        __byte_perm(hi01, hi23, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * kVRow) =
        __byte_perm(hi01, hi23, 0x7632);
  }
}

// KC: key chunks of 32 (Lk padded to 32 KC). Grid: B * H CTAs, CTA (b, h)
// = (blockIdx.x / H, blockIdx.x % H), of 32 QT threads (QT = q tiles of
// 16 rows): warp w takes q tile w.
template <int KC>
__global__ void __launch_bounds__(32 * (kMaxL / 16))
mha_int8_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ bias,
                bf16* __restrict__ out, int H, int Lq, int Lk,
                long long q_bs, long long q_rs, long long k_bs,
                long long k_rs, long long v_bs, long long v_rs,
                float q_inv, float k_inv, float v_inv, float c_s,
                float c_v) {
  constexpr int KP = 32 * KC;       // padded keys
  constexpr int kVRow = KP + 16;    // bytes of a v8^T row
  constexpr int NT = 4 * KC;        // score tiles of 8 keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* k8 = smem_raw;
  uint8_t* v8t = k8 + KP * kKRow;
  float* kb = reinterpret_cast<float*>(v8t + D * kVRow);

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int t = lane % 4;  // fragment column group
  const int m0 = 16 * (tid / 32);
  bf16* st = reinterpret_cast<bf16*>(kb + kMaxL) + (tid / 32) * 16 * kORow;
  const bf16* qb = q + b * q_bs + h * D;
  const bf16* kbase = k + b * k_bs + h * D;
  const bf16* vb = v + b * v_bs + h * D;

  // this warp's q rows m0 + g and m0 + g + 8, d 8t..8t+7 and
  // 32+8t..32+8t+7, into registers (quantized after k and v are issued)
  uint4 qraw[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int row = m0 + g + 8 * r;
      qraw[r][kk] = row < Lq ? load16(qb + row * q_rs + 32 * kk + 8 * t)
                             : make_uint4(0u, 0u, 0u, 0u);
    }
  // this thread's first v item, in flight with q and k
  const int n_v = 8 * ((Lk + 3) / 4);
  uint4 vraw[4];
  load_v(vraw, vb, v_rs, Lk, n_v, tid);
  if (bias != nullptr)
    for (int j = tid; j < Lk; j += nthreads)
      kb[j] = __bfloat162float(bias[static_cast<long long>(b) * Lk + j]);

  // k8: piece i is d 8p..8p+7 (p = i % 8) of key i / 8; its two words go
  // to slots 32(p/4) + 4(p%4) and 16 more (the A fragments' order of d).
  // Rows past Lk are not written: their scores are masked, and no tile
  // wholly past Lk is read
  for (int i0 = tid; i0 < Lk * 8; i0 += kUnroll * nthreads) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * nthreads;
      raw[u] = i < Lk * 8 ? load16(kbase + (i / 8) * k_rs + 8 * (i % 8))
                          : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * nthreads;
      if (i < Lk * 8) {
        const int p = i % 8;
        uint8_t* dst = k8 + (i / 8) * kKRow + 32 * (p / 4) + 4 * (p % 4);
        *reinterpret_cast<uint32_t*>(dst) =
            quantize4(raw[u].x, raw[u].y, k_inv);
        *reinterpret_cast<uint32_t*>(dst + 16) =
            quantize4(raw[u].z, raw[u].w, k_inv);
      }
    }
  }

  // v8^T up to the key group of Lk, the first item from the registers
  // loaded above; keys past it are not written (their p8 is 0, and an
  // int8 product with 0 is 0 whatever the byte)
  for (int i = tid; i < n_v; i += nthreads) {
    if (i != tid) load_v(vraw, vb, v_rs, Lk, n_v, i);
    store_v<KP>(v8t, vraw, v_inv, i);
  }
  // q8's A fragments: [kk][0] row g, d 32kk+8t..+3; [1] row g + 8;
  // [2] row g, d 32kk+8t+4..+7; [3] row g + 8
  uint32_t qa[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = m0 + g + 8 * r < Lq;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      qa[kk][r] = in ? quantize4(qraw[r][kk].x, qraw[r][kk].y, q_inv) : 0u;
      qa[kk][2 + r] = in ? quantize4(qraw[r][kk].z, qraw[r][kk].w, q_inv)
                         : 0u;
    }
  }
  __syncthreads();
  // rows m0 + 8.. hold queries (warp-uniform); rows past Lq get -inf
  // scores, no exp, no quotient and no context
  const bool hi_live = m0 + 8 < Lq;

  // scores: ldmatrix's four matrices are d slots 0, 16, 32, 48; tile j's
  // column n is key 32(j/4) + 16((j%4)>>1) + 4(n>>1) + 2(j&1) + (n&1).
  // Tiles 4c + 2 and 4c + 3 hold keys 32c + [16, 32): where all are past
  // Lk (Lk <= 16, or 33..48) they are not computed (-inf scores, p8 = 0)
  bool live[NT];
  int s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    live[j] = 32 * (j / 4) + 16 * ((j % 4) >> 1) < Lk;
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0;
    if (!live[j]) continue;
    const int n = lane % 8;
    const int key = 32 * (j / 4) + 16 * ((j % 4) >> 1) + 4 * (n >> 1) +
                    2 * (j & 1) + (n & 1);
    uint32_t kf[4];
    ldmatrix_x4(kf, k8 + key * kKRow + 16 * (lane / 8));
    mma_s8(s[j], qa[0], kf[0], kf[1]);
    mma_s8(s[j], qa[1], kf[2], kf[3]);
  }

  // scale, + bias, row max (rows g and g + 8; a row's keys are spread
  // over the 4 threads of a quad); the thread's element e of tile j is
  // key 32(j/4) + 16((j%4)>>1) + 4t + 2(j&1) + (e&1), row g + 8(e/2)
  const bool has_bias = bias != nullptr;
  float x[NT][4];
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 32 * (j / 4) + 16 * ((j % 4) >> 1) + 4 * t +
                      2 * (j & 1) + (e & 1);
      float y = -INFINITY;
      if (live[j] && (e < 2 || hi_live) && key < Lk) {
        y = __fmul_rn(exact_float(s[j][e]), c_s);
        if (has_bias) y = __fadd_rn(y, kb[key]);
      }
      x[j][e] = y;
      mx[e / 2] = fmaxf(mx[e / 2], y);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float y = 0.f;
      if (live[j] && (e < 2 || hi_live) && x[j][e] != -INFINITY)
        y = expf(__fsub_rn(x[j][e], mx[e / 2]));
      x[j][e] = y;
    }
  // the row sum as a butterfly over the 64 key slots (padded keys add 0):
  // keys 32, 16, 8, 4, 2 and 1 apart added level by level, the order of
  // an xor-shuffle warp sum over keys (lane, lane + 32)
  float sum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float a[4];  // keys 4t + i, after the levels 32 and 16 apart
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = i >> 1, e = 2 * r + (i & 1);
      float lo = x[j][e], hi = x[j + 2][e];
      if (KC == 2) {
        lo = __fadd_rn(lo, x[j + 4][e]);
        hi = __fadd_rn(hi, x[j + 6][e]);
      }
      a[i] = __fadd_rn(lo, hi);
      a[i] = __fadd_rn(a[i], __shfl_xor_sync(0xffffffffu, a[i], 2));
      a[i] = __fadd_rn(a[i], __shfl_xor_sync(0xffffffffu, a[i], 1));
    }
    sum[r] = __fadd_rn(__fadd_rn(a[0], a[2]), __fadd_rn(a[1], a[3]));
  }
  // p8 = rint((e / sum) * 127) in [0, 127], in the low byte of w. e / sum
  // is the IEEE quotient RN(e / sum), by the row's reciprocal y =
  // RN(1 / sum) and two residual steps: q1 = RN(q0 + (e - sum q0) y) from
  // q0 = RN(e y) is within an ulp of e / sum, and then (Markstein, y
  // within half an ulp of 1 / sum) RN(q1 + (e - sum q1) y) is RN(e / sum);
  // each residual is exact in an fma. Where e / sum is below the normal
  // range the quotient may differ, but p * 127 rounds to 0 either way.
  const float y[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
  uint32_t w[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = 0.f;
      if (live[j] && (e < 2 || hi_live) && x[j][e] != 0.f)
        p = quotient(x[j][e], sum[e / 2], y[e / 2]);
      w[j][e] = __float_as_uint(__fadd_rn(__fmul_rn(p, 127.f), kRound));
    }
  // p8's A fragments, chunk c: [0] row g, keys 32c+4t..+3 (tiles 4c and
  // 4c + 1); [1] row g + 8; [2] row g, keys 32c+16+4t..+3 (tiles 4c + 2
  // and 4c + 3); [3] row g + 8
  uint32_t pa[KC][4];
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = 4 * c + 2 * half;
        pa[c][2 * half + r] = pack_low(w[j][2 * r], w[j][2 * r + 1],
                                       w[j + 1][2 * r], w[j + 1][2 * r + 1]);
      }

  // context: p8 . v8, v8^T's rows (d) by ldmatrix: matrix m of d tile
  // pair n2 is d tile 2 n2 + (m >> 1), keys 32c + 16 (m & 1) + [0, 16)
  int o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0;
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      const int m = lane / 8;
      uint32_t bv[4];
      ldmatrix_x4(bv, v8t + (16 * n2 + 8 * (m >> 1) + lane % 8) * kVRow +
                          32 * c + 16 * (m & 1));
      mma_s8(o[2 * n2], pa[c], bv[0], bv[1]);
      mma_s8(o[2 * n2 + 1], pa[c], bv[2], bv[3]);
    }

  // the context staged in the warp's tile, stored as 16-byte pieces of
  // 128-byte rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r == 1 && !hi_live) break;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(st + (g + 8 * r) * kORow + 8 * n +
                                         2 * t) =
          __floats2bfloat162_rn(__fmul_rn(exact_float(o[n][2 * r]), c_v),
                                __fmul_rn(exact_float(o[n][2 * r + 1]), c_v));
  }
  __syncwarp();
  bf16* ob = out + static_cast<long long>(b) * Lq * H * D + h * D;
#pragma unroll
  for (int i = 0; i < 16 * (D / 8) / 32; ++i) {
    const int piece = 32 * i + lane;
    const int r = piece / (D / 8);
    const int c = (piece % (D / 8)) * 8;
    if (m0 + r < Lq)
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(m0 + r) * H * D +
                                c) =
          *reinterpret_cast<const uint4*>(st + r * kORow + c);
  }
}

// The launch of (Lq, Lk): its kernel, threads and shared memory.
struct Launch {
  void (*kernel)(const bf16*, const bf16*, const bf16*, const bf16*, bf16*,
                 int, int, int, long long, long long, long long, long long,
                 long long, long long, float, float, float, float, float);
  int threads;
  int smem;
};

inline Launch launch_of(int Lq, int Lk) {
  const int qt = (Lq + 15) / 16;
  const int kc = (Lk + 31) / 32;
  return {kc == 2 ? mha_int8_kernel<2> : mha_int8_kernel<1>, 32 * qt,
          smem_bytes(kc, qt)};
}

inline bool valid(int Lq, int Lk) {
  return Lq >= 1 && Lk >= 1 && Lq <= kMaxL && Lk <= kMaxL;
}

}  // namespace mha_int8

extern "C" {

int mha_int8_launch(const void* q, const void* k, const void* v,
                    const void* bias, void* out, int B, int H, int Lq,
                    int Lk, long long q_bs, long long q_rs, long long k_bs,
                    long long k_rs, long long v_bs, long long v_rs,
                    float q_inv, float k_inv, float v_inv, float c_s,
                    float c_v, void* stream) {
  if (B < 1 || H < 1 || !mha_int8::valid(Lq, Lk))
    return static_cast<int>(cudaErrorInvalidValue);
  const mha_int8::Launch l = mha_int8::launch_of(Lq, Lk);
  l.kernel<<<B * H, l.threads, l.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), H, Lq, Lk, q_bs, q_rs, k_bs, k_rs,
      v_bs, v_rs, q_inv, k_inv, v_inv, c_s, c_v);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the (Lq, Lk) launch resident on one SM at once, by the card's
// occupancy calculator (0 for lengths the kernel refuses)
int mha_int8_resident(int Lq, int Lk) {
  if (!mha_int8::valid(Lq, Lk)) return 0;
  const mha_int8::Launch l = mha_int8::launch_of(Lq, Lk);
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, l.kernel, l.threads,
                                                    l.smem) != cudaSuccess)
    return 0;
  return n;
}

const char* mha_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
