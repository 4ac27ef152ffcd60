// Whole-block fused int8 chain of one encoder module, forward only:
//
//   y1 = LN1(bf16(deq(q(ctx) Wo)) + x)
//   y2 = LN2(bf16(deq(q(bf16(gelu(bf16(deq(q(y1) W1))))) W2)) + y1)  [FFN]
//   tail = bf16(deq(q(y2) Wq))                                       [tail]
//
// Replaces the TPU kernel xlxmert_tpu/ops/fused_block.py::fused_block
// (_make_kernel). ctx and x (M, 768) bf16; every weight int8 in
// nn.Linear's layout (row n = output channel n): wo (768, 768), w1
// (I, 768), w2 (768, I), wq (Nq, 768); each with an out_scale and a bias
// (N,) fp32; LayerNorm scales and biases (768,) fp32; out y (M, 768) and
// tail (M, Nq) bf16. Without the FFN y = y1; without the tail only y is
// written. Rounding points, as the int8 engine's: q(v) = clip(
// rint(v * inv), -127, 127) with a static scale per product; deq(acc) =
// acc * out_scale + bias in fp32 (__fmul_rn / __fadd_rn: no contraction),
// rounded to bf16; residual adds in fp32 rounded to bf16; LayerNorm with
// two-pass fp32 statistics, eps 1e-12; tanh gelu in fp32 from the bf16
// value, rounded to bf16. The integer products are exact in any order
// (a cluster's partial FFN2 sums too), so only the order of the
// LayerNorm sums and tanhf can differ from the plain version: a bf16
// step of y1, and one int8 step downstream.
//
// What bounds it on an H100: 2*M*768*(768 + 2 I + Nq) int8 operations
// against the weights (7.1 MB at I = 3,072, Nq = 2,304) plus M*768*2*3 +
// M*Nq*2 bytes of rows. A block with the FFN is bound by operations from
// M = 512 up: at M = 2,048 (B = 256, L = 8) 29 G ops take 14.6 us at
// 1,979 TOP/s and its 26 MB 7.8 us at 3.35 TB/s; at M = 16,384 0.117 ms
// against 0.047 ms. A block without the FFN (the cross outputs) is bound
// by bytes at every shape of the path, and so is every block at the
// batch-8 check shapes below M = 512. (chip_smoke.py computes the bound
// of each shape.) Inside the SM the limits are the weights' stream from
// L2 (every 64-row block reads all 7.1 MB: at 8,192 int8 operations a
// clock an SM that is 64 bytes a clock, ~15 TB/s over the card, against
// an L2 that gives well under half of that) and shared memory's 128
// bytes a clock, which wgmma's operand reads, TMA's writes and the
// epilogues share.
//
// What the design does about it (this file's earlier mma.sync version,
// one 32-row CTA of 8 warps streaming the weights through a cp.async
// ring, took 0.33 ms for one CTA's pass and 23.4 ms a mix forward):
//   - a cluster of 2 x split CTAs (ops/_plan.launch_plan: split 1, or 2
//     where the pairs would need a second, mostly empty wave) shares a
//     64-row block. Each CTA runs two consumer warpgroups and a producer
//     warp. Half p of the pair takes FFN2's 384 output columns [384 p, +
//     384) (3 accumulator tiles of 64 a warpgroup, 96 int32 registers a
//     thread: 192, with both halves in one CTA, had ptxas spill and
//     serialize every wgmma); both halves compute the same FFN1 chunks.
//     The split takes slices of the intermediate; the 2 x split CTAs take
//     equal parts of the out-projection's, the LayerNorms' and the
//     tail's columns. Partial FFN2 sums meet at the CTA that owns their
//     columns, the LayerNorms' row statistics at every CTA and the next
//     product's int8 operand in every CTA's buffer, all through
//     distributed shared memory;
//   - products are wgmma.m64n64k32.s32.s8.s8 with both operands in shared
//     memory. The int8 operand of every product (q(ctx), q(y1), q(y2)) is
//     quantized once per row block into a 64 x 768 buffer in the 128-byte
//     swizzle, and each 128-wide chunk of the FFN activation (dequantized,
//     gelu, quantized) into a 64 x 128 one: the (M, I) activation never
//     leaves the SM. Each warpgroup computes 64 of a chunk's columns;
//   - the weights stream as TMA boxes of 64 rows x 64 k (64-byte swizzle,
//     wgmma's B operand as it lands) through a 10-slot ring of 16 KB (two
//     boxes a warpgroup a step) in one sequence a launch (out-projection,
//     then per chunk 6 steps of W1 and 3 of W2, then the tail). The
//     producer warp waits for a slot's "empty" barrier and asks TMA for
//     the step; the consumers release a slot once the wgmma that read it
//     is done: no block barrier a step (thread 0 issuing the loads
//     behind a barrier a step was slower, PERF.md). A weight's TMA
//     descriptor is built once and kept;
//   - LayerNorm runs on the accumulators; the epilogues load their
//     vectors at clamped indices and select after (loads under branches
//     had waited for each other), and gelu is tanh's equivalent x / (1 +
//     exp(-2 u)) (tanhf made a chunk's gelu cost more than its
//     products).
// What bounds it now (scripts/time_ffn_variants.py --kernel
// fused_block; PERF.md): without the products 15 % less time, without
// the loads 6-11 % less; the rest is the pipeline's own cost per 16 KB
// step (wait, wgmma issue, release) and the epilogues' cluster barriers.
// Tried and dropped (PERF.md): a CTA owning all 768 columns, cluster
// splits of 4, TMA multicast of the weights over two row blocks or of W1
// over the pair, setmaxnreg (ptxas kept the consumers at 168 registers).

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kH = 768;               // row width (hidden size)
constexpr int kBM = 64;               // rows a CTA
constexpr int kThreads = 288;         // two consumer warpgroups, a producer
constexpr int kKSteps = kH / 64;      // 64-deep k steps of a 768-deep product
constexpr int kTiles = kH / 64;       // 64-wide column tiles of a row
constexpr int kChunk = 128;           // FFN intermediate columns a chunk
constexpr int kBox = 64 * 64;         // weight box: 64 rows x 64 k, int8
constexpr int kSlot = 4 * kBox;       // ring slot: two boxes a warpgroup
constexpr int kStages = 10;
constexpr int kOffQ = 0;                                  // q operand
constexpr int kOffH = kBM * kH;                           // h chunk
constexpr int kOffRing = kOffH + kBM * kChunk;            // weight ring
constexpr int kOffPart = kOffRing + kStages * kSlot;      // [2][64] f32
constexpr int kOffStats = kOffPart + 2 * kBM * 4;         // [2][4][64] f32
constexpr int kOffBar = kOffStats + 2 * 4 * kBM * 4;      // barriers
constexpr int kSmem = kOffBar + 2 * kStages * 8 + 1024;   // + alignment
static_assert(kSmem <= 232448, "fits an SM's shared memory");
static_assert(kBM * (kH / 4) * 4 <= kStages * kSlot,
              "the partial FFN2 sums a cluster exchanges fit the ring");

// one int8 product's epilogue: out_scale, bias and the static input
// scale of its operand
struct Dense {
  const float* so;
  const float* b;
  float inv;
};

struct Params {
  CUtensorMap wo, w1, w2, wq;
  const bf16* ctx;
  const bf16* x;
  bf16* y;
  bf16* tail;
  Dense out, f1, f2, q;
  const float *g1, *be1, *g2, *be2;
  int M, I, Nq, ffn, has_tail;
  float eps;
};

__device__ __forceinline__ int quant(float v, float inv) {
  return min(max(__float2int_rn(__fmul_rn(v, inv)), -127), 127);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// acc * out_scale + bias, rounded to bf16
__device__ __forceinline__ float dequant(int acc, float so, float b) {
  return bf16_round(__fadd_rn(__fmul_rn(__int2float_rn(acc), so), b));
}

// PyTorch's tanh gelu, 0.5 x (1 + tanh(u)) with u = sqrt(2/pi) (x +
// 0.044715 x^3) in its order of operations, taken as x / (1 + exp(-2 u))
// (the same value): an exponential and a division on the special
// function unit, where tanhf's ~40 instructions had made the gelu of a
// chunk cost more than its products. A few fp32 ulp from tanhf's.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(0.7978845608028654f,
                                __fadd_rn(x, __fmul_rn(0.044715f, cube)));
  return __fdividef(x, 1.f + __expf(-2.f * inner));
}

__device__ __forceinline__ uint16_t pack2(int a, int b) {
  return static_cast<uint16_t>((a & 0xff) | ((b & 0xff) << 8));
}

// stages of a k step when a CTA takes `tiles` column tiles: its two
// warpgroups split them (the first takes the odd one), two boxes each a
// stage
__device__ __forceinline__ int stages_for(int tiles) {
  const int n0 = (tiles + 1) / 2;
  return (n0 + 1) / 2;
}

// The cluster: 2 NI CTAs on one row block. Rank r = p NI + c takes the
// column half p (384 columns of the FFN's output), the slice c of the
// intermediate, and the r-th of 2 NI parts of the out-projection's, the
// LayerNorms' and the tail's columns.
template <int NI>
__global__ void __launch_bounds__(kThreads, 1)
    fused_block_kernel(const __grid_constant__ Params p) {
  constexpr int R = 2 * NI;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qbuf = smem + kOffQ;
  unsigned char* hbuf = smem + kOffH;
  float* part = reinterpret_cast<float*>(smem + kOffPart);
  float* stats = reinterpret_cast<float*>(smem + kOffStats);
  const uint32_t q_u32 = smem_u32(qbuf), h_u32 = smem_u32(hbuf);
  const uint32_t ring_u32 = smem_u32(smem + kOffRing);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int r0 = 16 * ((tid % 128) / 32) + g8;  // rows r0, r0 + 8
  const int r = static_cast<int>(cluster_rank());
  const int half = r / NI, slice = r % NI;
  const int m0 = (blockIdx.x / R) * kBM;
  const int M = p.M;

  // this CTA's work (ops/_plan.cta_work mirrors it): tiles [tA0, tA0 +
  // nA) of the out-projection's columns, which are the columns [own0,
  // own1) of y it normalises and writes; chunks [ch0, ch0 + nch) of the
  // intermediate; FFN2's columns [384 half, + 384); tail tiles [tC0, tC0
  // + nT). Every CTA of the cluster runs as many steps (stage counts
  // from the largest share).
  const int tA0 = kTiles * r / R;
  const int nA = kTiles * (r + 1) / R - tA0;
  const int nsA = stages_for((kTiles + R - 1) / R);
  const int own0 = kH * r / R, own1 = kH * (r + 1) / R;
  const int n_ch = p.ffn ? p.I / kChunk : 0;
  const int ch0 = n_ch * slice / NI;
  const int nch = n_ch / NI;
  const int n_t = p.has_tail ? p.Nq / 64 : 0;
  const int tC0 = n_t * r / R;
  const int nT = n_t * (r + 1) / R - tC0;
  const int nT_max = (n_t + R - 1) / R;
  const int n_full = nT_max / 6, rest = nT_max - 6 * n_full;
  const int stepsA = kKSteps * nsA;
  const int stepsB = 9 * nch;
  const int stepsC = 24 * n_full + (rest ? kKSteps * stages_for(rest) : 0);
  Ring<kStages> ring;
  ring.init(smem_u32(smem + kOffBar));
  if (tid == 0) fence_mbar_init();
  cluster_sync();

  // producer: step u's boxes; box i = 2 w + b is warpgroup w's b-th
  auto issue = [&](int u, int slot, uint32_t bar) {
    const CUtensorMap* map = &p.wo;
    int kc[4], row[4];
    bool on[4];
    if (u < stepsA) {
      const int kk = u / nsA, s = u % nsA, nA0 = (nA + 1) / 2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int w = i / 2, g = 2 * s + i % 2;
        on[i] = g < (w ? nA - nA0 : nA0);
        kc[i] = 64 * kk;
        row[i] = 64 * (tA0 + (w ? nA0 : 0) + g);
      }
    } else if ((u -= stepsA) < stepsB) {
      const int ch = ch0 + u / 9, s = u % 9;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int w = i / 2, b = i % 2;
        on[i] = true;
        if (s < 6) {  // W1 rows of the chunk's warpgroup half, k 2 steps
          kc[i] = 64 * (2 * s + b);
          row[i] = kChunk * ch + 64 * w;
        } else {      // W2: this half's output rows, k of the chunk
          const int f = 2 * (s - 6) + b;
          kc[i] = kChunk * ch + 64 * (f / 3);
          row[i] = 384 * half + 192 * w + 64 * (f % 3);
        }
      }
      map = s < 6 ? &p.w1 : &p.w2;
    } else {
      u -= stepsB;
      int pass = u / 24, v = u % 24, nP = 6;
      if (pass >= n_full) {
        pass = n_full;
        v = u - 24 * n_full;
        nP = rest;
      }
      const int ns = stages_for(nP), kk = v / ns, s = v % ns;
      const int mine = min(6, max(0, nT - 6 * pass)), m0t = (mine + 1) / 2;
      map = &p.wq;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int w = i / 2, g = 2 * s + i % 2;
        on[i] = g < (w ? mine - m0t : m0t);
        kc[i] = 64 * kk;
        row[i] = 64 * (tC0 + 6 * pass + (w ? m0t : 0) + g);
      }
    }
    mbar_expect_tx(bar, kBox * (on[0] + on[1] + on[2] + on[3]));
    const uint32_t dst = ring_u32 + slot * kSlot;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (on[i]) tma_load(dst + i * kBox, map, bar, kc[i], row[i]);
  };

  // The producer warp asks for the steps in order, as far as the
  // consumers' releases allow, but joins their cluster barriers at the
  // end of a phase first (LN1's, then the FFN's partial sums' and LN2's):
  // before them it may run STAGES - 1 steps into the next phase, whose
  // slots the last phase's steps released, except into the tail while
  // the partial sums of a split intermediate use the ring's memory.
  if (tid >= 256) {  // the producer warp
    const int total = stepsA + stepsB + stepsC;
    const bool drain = NI > 1 && p.ffn;
    const float inv1 = p.ffn ? p.f1.inv : (p.has_tail ? p.q.inv : 0.f);
    const int mark1 =
        min(stepsA + kStages - 1, drain ? stepsA + stepsB : total);
    const int mark2 = max(mark1, min(stepsA + stepsB + (drain ? 0 : kStages - 1),
                                     total));
    int u = 0;
    auto run = [&](int end) {
      if (tid == 256)
        for (; u < end; ++u) ring.produce(u, issue);
      __syncwarp();
    };
    run(mark1);
    for (int i = 0; i < 2 + (inv1 > 0.f); ++i) cluster_sync();
    if (p.ffn) {
      run(mark2);
      for (int i = 0; i < (NI > 1 ? 2 : 0) + 2 + p.has_tail; ++i)
        cluster_sync();
    }
    run(total);
    cluster_sync();  // the last one
    return;
  }


  // a byte pair of q(y) into the operand buffer of every CTA of this
  // row block
  auto put_q = [&](int off, uint16_t v) {
#pragma unroll
    for (int j = 0; j < R; ++j)
      st_cluster_u16(mapa(q_u32 + off, j), v);
  };
  // Each phase's products have accumulators of their own, which only
  // wgmma writes until the phase's last product (the first k step
  // starts the sums): an accumulator that other instructions write
  // between two products makes ptxas serialize every wgmma of the
  // kernel. An epilogue then leaves its pre-norm values there (float
  // bits).
  int accA[3][32], acc[3][32], accT[3][32];
  auto fence = [&](int (&a)[3][32]) {
#pragma unroll
    for (int g = 0; g < 3; ++g) fence_regs(a[g]);
  };
  // element e of accumulator tile g: row r0 + 8 ((e >> 1) & 1), column
  // cb0 + 64 g + 8 (e >> 2) + 2 t4 + (e & 1)
  //
  // LayerNorm of the rows whose pre-norm values v holds (float bits) in
  // tiles g < ng from column cb0, this CTA's columns [own0, own1);
  // the bf16 outputs to y and, when inv > 0, quantized with inv into the
  // operand buffer of every CTA of the row block.
  auto layer_norm = [&](int (&v)[3][32], int ng, int cb0, const float* gam,
                        const float* bet, float inv) {
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int c = cb0 + 64 * g + 8 * (e >> 2) + 2 * t4 + (e & 1);
        s[(e >> 1) & 1] +=
            g < ng && c >= own0 && c < own1 ? __int_as_float(v[g][e]) : 0.f;
      }
    float mu[2], var[2];
    row_total<R>(s, mu, part, stats, r, wg, r0);
#pragma unroll
    for (int h = 0; h < 2; ++h) mu[h] = __fdiv_rn(mu[h], static_cast<float>(kH));
    float sq[2] = {0.f, 0.f};
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int c = cb0 + 64 * g + 8 * (e >> 2) + 2 * t4 + (e & 1);
        const float d = __fsub_rn(__int_as_float(v[g][e]), mu[(e >> 1) & 1]);
        sq[(e >> 1) & 1] = __fadd_rn(
            sq[(e >> 1) & 1],
            g < ng && c >= own0 && c < own1 ? __fmul_rn(d, d) : 0.f);
      }
    row_total<R>(sq, var, part, stats + 4 * kBM, r, wg, r0);
    float rstd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rstd[h] = rsqrtf(__fadd_rn(__fdiv_rn(var[h], static_cast<float>(kH)),
                                 p.eps));
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int c = cb0 + 64 * g + 8 * (e >> 2) + 2 * t4;
        const int h = (e >> 1) & 1, rr = r0 + 8 * h;
        const float2 ga = ld_f2(gam, min(c, kH - 2)),
                     be = ld_f2(bet, min(c, kH - 2));
        if (!(g < ng && c >= own0 && c < own1)) continue;
        float o[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float n =
              __fmul_rn(__fsub_rn(__int_as_float(v[g][e + k]), mu[h]), rstd[h]);
          o[k] = bf16_round(
              __fadd_rn(__fmul_rn(n, k ? ga.y : ga.x), k ? be.y : be.x));
        }
        if (m0 + rr < M)
          *reinterpret_cast<__nv_bfloat162*>(
              p.y + static_cast<long long>(m0 + rr) * kH + c) =
              __floats2bfloat162_rn(o[0], o[1]);
        if (inv > 0.f)
          put_q(sw128_offset(rr, c), pack2(quant(o[0], inv), quant(o[1], inv)));
      }
    if (inv > 0.f) {
      fence_async_all();
      cluster_sync();
      fence_async_shared();
    }
  };

  // 0. q(ctx) of this CTA's rows (zeros past M) into the operand buffer
  for (int idx = tid; idx < kBM * (kH / 8); idx += 256) {
    const int rr = idx / (kH / 8), c = (idx % (kH / 8)) * 8;
    uint32_t lo = 0, hi = 0;
    if (m0 + rr < M) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          p.ctx + static_cast<long long>(m0 + rr) * kH + c);
      const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lo |= (static_cast<uint32_t>(quant(__bfloat162float(v[e]),
                                           p.out.inv)) & 0xffu) << (8 * e);
        hi |= (static_cast<uint32_t>(quant(__bfloat162float(v[e + 4]),
                                           p.out.inv)) & 0xffu) << (8 * e);
      }
    }
    *reinterpret_cast<uint2*>(qbuf + sw128_offset(rr, c)) = make_uint2(lo, hi);
  }
  fence_async_shared();
  consumer_sync();

  // descriptors: the operand's k step kk, 32-byte half j; step slot's
  // box b of this warpgroup, half j
  auto desc_q = [&](int kk, int j) {
    return desc_sw128(q_u32 + (kk >> 1) * 8192 + (kk & 1) * 64 + 32 * j);
  };
  auto desc_w = [&](int slot, int b, int j) {
    return desc_sw64(ring_u32 + slot * kSlot + (2 * wg + b) * kBox + 32 * j);
  };

  // 1. out-projection: this CTA's tiles, + x, LN1
  int t = 0;
  {
    const int nA0 = (nA + 1) / 2;
    const int nAw = wg ? nA - nA0 : nA0, cbA = 64 * (tA0 + (wg ? nA0 : 0));
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (s >= nsA) break;  // the same for the whole CTA
        const int slot = ring.wait(t);
        wgmma_fence();
        fence(accA);
        // stage 0: tiles 0 and 1, stage 1: tile 2, whether or not this
        // warpgroup has them (their sums are not used): a wgmma on a
        // path that a warpgroup may not take makes ptxas serialize them
#pragma unroll
        for (int b = 0; b < 2 - s; ++b)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wgmma_s8_ss(accA[2 * s + b], desc_q(kk, j), desc_w(slot, b, j),
                        kk > 0 || j > 0);
        wgmma_commit();
        fence(accA);
        wgmma_wait<1>();
        ring.release(t++);
      }
    }
    wgmma_wait<0>();
    fence(accA);
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        // rows past M and tiles past nAw read a valid element, unused
        const int rr = min(m0 + r0 + 8 * ((e >> 1) & 1), M - 1);
        const int c = min(cbA + 64 * g + 8 * (e >> 2) + 2 * t4, kH - 2);
        const float2 xv = ld_bf2(p.x, static_cast<long long>(rr) * kH + c);
        const float2 so = ld_f2(p.out.so, c), b = ld_f2(p.out.b, c);
        accA[g][e] = __float_as_int(
            bf16_round(__fadd_rn(dequant(accA[g][e], so.x, b.x), xv.x)));
        accA[g][e + 1] = __float_as_int(
            bf16_round(__fadd_rn(dequant(accA[g][e + 1], so.y, b.y), xv.y)));
      }
    // y1 goes to y (the FFN's residual, read back by its owner) or is y
    layer_norm(accA, nAw, cbA, p.g1, p.be1,
               p.ffn ? p.f1.inv : (p.has_tail ? p.q.inv : 0.f));
  }

  // 2. FFN over this CTA's chunks of the intermediate (both column
  // halves compute each chunk's h; each multiplies it into its own 384
  // columns); + y1, LN2
  if (p.ffn) {
    int hacc[32];
    for (int ci = 0; ci < nch; ++ci) {
      const int ch = ch0 + ci;
      // h chunk: this warpgroup's 64 of its 128 columns, k 2 steps a
      // stage (the first product starts the sums)
      for (int s = 0; s < 6; ++s) {
        const int slot = ring.wait(t);
        wgmma_fence();
        fence_regs(hacc);
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wgmma_s8_ss(hacc, desc_q(2 * s + b, j), desc_w(slot, b, j),
                        s > 0 || b > 0 || j > 0);
        wgmma_commit();
        fence_regs(hacc);
        wgmma_wait<1>();
        ring.release(t++);
      }
      wgmma_wait<0>();
      fence_regs(hacc);
      consumer_sync();  // both warpgroups are done with the last h chunk
      // deq, bf16, gelu, bf16, q into the h chunk
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int rr = r0 + 8 * ((e >> 1) & 1);
        const int c = 64 * wg + 8 * (e >> 2) + 2 * t4;
        const float2 so = ld_f2(p.f1.so, kChunk * ch + c),
                     b = ld_f2(p.f1.b, kChunk * ch + c);
        int qv[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float a1 = dequant(hacc[e + k], k ? so.y : so.x, k ? b.y : b.x);
          qv[k] = quant(bf16_round(gelu_tanh(a1)), p.f2.inv);
        }
        *reinterpret_cast<uint16_t*>(hbuf + sw128_offset(rr, c)) =
            pack2(qv[0], qv[1]);
      }
      fence_async_shared();
      consumer_sync();  // the whole chunk is in hbuf
      // this half's FFN2 sums += h chunk . W2[half, chunk]^T: box f =
      // 2 s + b of a warpgroup is k half f / 3, tile f % 3
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int slot = ring.wait(t);
        wgmma_fence();
        fence(acc);
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int f = 2 * s + b, ks = f / 3;
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wgmma_s8_ss(acc[f % 3], desc_sw128(h_u32 + 64 * ks + 32 * j),
                        desc_w(slot, b, j), ci > 0 || ks > 0 || j > 0);
        }
        wgmma_commit();
        fence(acc);
        wgmma_wait<1>();
        ring.release(t++);
      }
    }
    wgmma_wait<0>();
    fence(acc);
    const int cbB = 384 * half + 192 * wg;
    if (NI > 1) {
      // the partial sums of this half's columns to the slice that owns
      // them (in the ring's memory, which the cluster is done with)
      constexpr int W = 384 / NI;
      cluster_sync();
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int rr = r0 + 8 * ((e >> 1) & 1);
          const int c = cbB + 64 * g + 8 * (e >> 2) + 2 * t4;
          const int o = (c - 384 * half) / W;
          if (o == slice) continue;
          const int sl = slice < o ? slice : slice - 1;
          st_cluster_v2(
              mapa(ring_u32 + ((sl * kBM + rr) * W + c - 384 * half - o * W) * 4,
                   half * NI + o),
              acc[g][e], acc[g][e + 1]);
        }
      cluster_sync();
      const int* recv = reinterpret_cast<const int*>(smem + kOffRing);
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int rr = r0 + 8 * ((e >> 1) & 1);
          const int c = cbB + 64 * g + 8 * (e >> 2) + 2 * t4 + (e & 1);
          // another CTA's columns read a valid element, unused
          const int cl = min(max(c - own0, 0), W - 1);
#pragma unroll
          for (int sl = 0; sl < NI - 1; ++sl)
            acc[g][e] += recv[(sl * kBM + rr) * W + cl];
        }
    }
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        // rows past M read a valid row, unused
        const int rr = min(m0 + r0 + 8 * ((e >> 1) & 1), M - 1);
        const int c = cbB + 64 * g + 8 * (e >> 2) + 2 * t4;
        const float2 y1 = ld_bf2(p.y, static_cast<long long>(rr) * kH + c);
        const float2 so = ld_f2(p.f2.so, c), b = ld_f2(p.f2.b, c);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          acc[g][e + k] = __float_as_int(bf16_round(__fadd_rn(
              dequant(acc[g][e + k], k ? so.y : so.x, k ? b.y : b.x),
              k ? y1.y : y1.x)));
        }
      }
    layer_norm(acc, 3, cbB, p.g2, p.be2, p.has_tail ? p.q.inv : 0.f);
  }

  // 3. tail: the next module's projection of y, this CTA's tiles in
  // passes of up to 6 (3 a warpgroup)
  for (int pass = 0; 6 * pass < nT_max; ++pass) {
    const int nP = min(6, nT_max - 6 * pass), ns = stages_for(nP);
    const int mine = min(6, max(0, nT - 6 * pass)), m0t = (mine + 1) / 2;
    const int nPw = wg ? mine - m0t : m0t;
    const int cb = 64 * (tC0 + 6 * pass + (wg ? m0t : 0));
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (s >= ns) break;  // the same for the whole CTA
        const int slot = ring.wait(t);
        wgmma_fence();
        fence(accT);
        // stage 0: tiles 0 and 1, stage 1: tile 2, whether or not this
        // warpgroup has them (their sums are not used): a wgmma on a
        // path that a warpgroup may not take makes ptxas serialize them
#pragma unroll
        for (int b = 0; b < 2 - s; ++b)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wgmma_s8_ss(accT[2 * s + b], desc_q(kk, j), desc_w(slot, b, j),
                        kk > 0 || j > 0);
        wgmma_commit();
        fence(accT);
        wgmma_wait<1>();
        ring.release(t++);
      }
    }
    wgmma_wait<0>();
    fence(accT);
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int rr = r0 + 8 * ((e >> 1) & 1);
        const int c = cb + 64 * g + 8 * (e >> 2) + 2 * t4;
        const float2 so = ld_f2(p.q.so, min(c, p.Nq - 2)),
                     b = ld_f2(p.q.b, min(c, p.Nq - 2));
        if (g >= nPw || m0 + rr >= M) continue;
        *reinterpret_cast<__nv_bfloat162*>(
            p.tail + static_cast<long long>(m0 + rr) * p.Nq + c) =
            __floats2bfloat162_rn(dequant(accT[g][e], so.x, b.x),
                                  dequant(accT[g][e + 1], so.y, b.y));
      }
  }
  // no CTA leaves while another may still write to its shared memory
  cluster_sync();
}

template <int NI>
int launch(const Params& p, cudaStream_t stream) {
  auto kernel = fused_block_kernel<NI>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int blocks = (p.M + kBM - 1) / kBM;
  const cudaError_t err = launch_clusters(kernel, blocks * 2 * NI, kThreads,
                                          kSmem, 2 * NI, stream, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// ctx, x (M, 768) bf16; wo (768, 768), w1 (I, 768), w2 (768, I), wq
// (Nq, 768) int8; so_* and b_* (N,) fp32 of each product; g1, be1, g2,
// be2 (768,) fp32; y (M, 768) and tail (M, Nq) bf16. w1 null: no FFN (w2,
// so_1, ..., be2 unused); wq null: no tail. I and Nq multiples of 128,
// every pointer to rows and weights 16-byte aligned. inv_*: the static
// input scale of each product. split (1 or 2, dividing I / 128): the
// slices of the intermediate a row block's cluster of 2 x split CTAs
// takes (ops/_plan.launch_plan). Returns the launch's cudaError_t (0 on
// success).
int fused_block_launch(const void* ctx, const void* x, const void* wo,
                       const void* so_o, const void* b_o, const void* g1,
                       const void* be1, const void* w1, const void* so_1,
                       const void* b_1, const void* w2, const void* so_2,
                       const void* b_2, const void* g2, const void* be2,
                       const void* wq, const void* so_q, const void* b_q,
                       void* y, void* tail, int M, int I, int Nq,
                       float inv_out, float inv_1, float inv_2, float inv_q,
                       float eps, int split, void* stream) {
  if (M < 1 || (w1 && (I < kChunk || I % kChunk != 0)) ||
      (wq && (Nq < 128 || Nq % 128 != 0)) ||
      (w1 && (I / kChunk) % split != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  Params p;
  if (!weight_map(&p.wo, wo, kH, kH, false, 64) ||
      (w1 && (!weight_map(&p.w1, w1, I, kH, false, 64) ||
              !weight_map(&p.w2, w2, kH, I, false, 64))) ||
      (wq && !weight_map(&p.wq, wq, Nq, kH, false, 64)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!w1) p.w1 = p.w2 = p.wo;
  if (!wq) p.wq = p.wo;
  p.ctx = static_cast<const bf16*>(ctx);
  p.x = static_cast<const bf16*>(x);
  p.y = static_cast<bf16*>(y);
  p.tail = static_cast<bf16*>(tail);
  p.out = Dense{f(so_o), f(b_o), inv_out};
  p.f1 = Dense{f(so_1), f(b_1), inv_1};
  p.f2 = Dense{f(so_2), f(b_2), inv_2};
  p.q = Dense{f(so_q), f(b_q), inv_q};
  p.g1 = f(g1);
  p.be1 = f(be1);
  p.g2 = f(g2);
  p.be2 = f(be2);
  p.M = M;
  p.I = w1 ? I : 0;
  p.Nq = wq ? Nq : 0;
  p.ffn = w1 != nullptr;
  p.has_tail = wq != nullptr;
  p.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split == 1) return launch<1>(p, s);
  if (split == 2) return launch<2>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fused_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
