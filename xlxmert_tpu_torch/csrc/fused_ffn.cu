// Fused FFN block, forward only: out = LN(W2 gelu(W1 x + b1) + b2 + x).
//
// Replaces the TPU kernel xlxmert_tpu/ops/ffn.py::fused_ffn (_kernel).
// x (M, 768) bf16; w1 (I, 768) and w2 (768, I) bf16 in nn.Linear's
// layout (row n = output channel n); b1 (I,), b2, g, beta (768,) fp32;
// out (M, 768) bf16. Rounding points, as the TPU kernel's: x W1 summed in
// fp32, + b1, gelu (tanh form or exact erfc) in fp32, h rounded to bf16;
// h W2 summed in fp32, + b2, + x; two-pass LayerNorm statistics in fp32
// (mean, then the mean of (y - mu)^2), rsqrt, times g, + beta, bf16 out.
// The fp32 sums run in another order than the plain version's (and, in
// a cluster, as partial sums over slices of I): an output can move by a
// bf16 step.
//
// What bounds it on an H100: 4*M*768*I flops on M*768*4 + 2*768*I*2
// bytes: at I = 3,072 and M >= 256 that is above the ~295 flop/byte
// where the bf16 tensor cores, not device memory, set the floor (0.16 ms
// at M = 16,384 against 989 TFLOP/s). Inside the SM: every 64-row block
// reads both weights (9.4 MB) from L2, 64 bytes a clock at the SM's
// 4,096 bf16 flops a clock, ~15 TB/s over the card, against an L2 that
// gives well under half of that; and shared memory's 128 bytes a clock,
// shared by wgmma's operand reads and TMA's writes.
//
// What the design does about it (this file's earlier mma.sync version,
// one 32-row CTA of 8 warps, a serial chain of ~365 ns steps, took 0.42
// ms for one CTA's pass and 22.3 ms a mix forward):
//   - a cluster of 2 x split CTAs (ops/_plan.launch_plan: split 1, or 2
//     where the pairs would need a second, mostly empty wave) shares a
//     64-row block. Each CTA runs two consumer warpgroups and a producer
//     warp. Half p of the pair takes the output sums of the columns [384
//     p, + 384) (3 accumulator tiles of 64 a warpgroup, 96 fp32 registers
//     a thread: 192, with both halves in one CTA, had ptxas spill and
//     serialize the wgmma); both halves compute the same h chunks. The
//     split takes slices of I; its fp32 partial sums meet at the CTA that
//     owns their columns, and the LayerNorm's row statistics at every
//     CTA, through distributed shared memory;
//   - TMA lands the CTA's 64 rows of x once (12 boxes of 64 x 64,
//     128-byte swizzle) as FFN1's A operand; the residual is read again
//     by the epilogue. The intermediate is taken in chunks of 128: each
//     warpgroup computes 64 of a chunk's columns
//     (wgmma.m64n64k16.f32.bf16.bf16, both operands in shared memory), +
//     b1, gelu, rounds to bf16 into a shared 64 x 128 chunk (128-byte
//     swizzle) that both multiply into their sums: the (M, I) activation
//     never leaves the SM;
//   - the weights stream as TMA boxes of 64 rows x 64 k (wgmma's B
//     operand as it lands) through a 6-slot ring of 16 KB (a box a
//     warpgroup a step; 12 steps of W1 then 6 of W2 a chunk). The
//     producer warp waits for a slot's "empty" barrier and asks TMA for
//     the step; the consumers release a slot once the wgmma that read it
//     is done: no block barrier a step. A weight's TMA descriptor is
//     built once and kept;
//   - LayerNorm runs on the accumulators; the epilogues load their
//     vectors at clamped indices and select after, and the tanh gelu is
//     x / (1 + exp(-2 u)) (tanhf, with b1 loaded under a branch, made a
//     chunk's gelu cost more than its products).
// What bounds it now (scripts/time_ffn_variants.py; PERF.md): without
// the products 23 % less time, without the loads 3-13 % less; the rest
// is the pipeline's own cost per 16 KB step (wait, wgmma issue, release),
// the redundant FFN1 of the pair and the epilogue's cluster barriers.
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
constexpr int kKSteps = kH / 64;      // 64-deep k steps of FFN1
constexpr int kChunk = 128;           // intermediate columns a chunk
constexpr int kBox = 64 * 64 * 2;     // weight box: 64 rows x 64 k, bf16
constexpr int kSlot = 2 * kBox;       // ring slot: a box a warpgroup
constexpr int kStages = 6;
constexpr int kOffX = 0;                                  // x rows
constexpr int kOffH = kBM * kH * 2;                       // h chunk
constexpr int kOffRing = kOffH + kBM * kChunk * 2;        // weight ring
constexpr int kOffPart = kOffRing + kStages * kSlot;      // [2][64] f32
constexpr int kOffStats = kOffPart + 2 * kBM * 4;         // [2][4][64] f32
constexpr int kOffBar = kOffStats + 2 * 4 * kBM * 4;      // barriers
constexpr int kSmem = kOffBar + (2 * kStages + 1) * 8 + 1024;
static_assert(kSmem <= 232448, "fits an SM's shared memory");
static_assert(kBM * (kH / 4) * 4 <= kOffPart,
              "the partial sums a cluster exchanges fit the operands' "
              "and the ring's memory");

struct Params {
  CUtensorMap x_map, w1, w2;
  const bf16* x;
  const float *b1, *b2, *g, *beta;
  bf16* out;
  int M, I, approx;
  float eps;
};

// jax.nn.gelu's order of operations, without fused multiply-adds; the
// tanh form x (0.5 (1 + tanh(u))) taken as x / (1 + exp(-2 u)) (the same
// value): an exponential and a division on the special function unit
// instead of tanhf's ~40 instructions. A few fp32 ulp from tanhf's.
__device__ __forceinline__ float gelu_tanh(float h) {
  const float cube = __fmul_rn(__fmul_rn(h, h), h);
  const float inner = __fmul_rn(
      0.7978845834732056f, __fadd_rn(h, __fmul_rn(0.044715f, cube)));
  return __fdividef(h, 1.f + __expf(-2.f * inner));
}

__device__ __forceinline__ float gelu_erf(float h) {
  return __fmul_rn(__fmul_rn(0.5f, h),
                   erfcf(__fmul_rn(-h, 0.7071067690849304f)));
}

// The cluster: 2 NI CTAs on one row block. Rank r = p NI + c takes the
// output's column half p (384 columns: its sums and, when NI = 2, half
// of them to normalise) and the slice c of the intermediate; both halves
// of a slice compute the same h chunks.
template <int NI>
__global__ void __launch_bounds__(kThreads, 1)
    fused_ffn_kernel(const __grid_constant__ Params p) {
  constexpr int R = 2 * NI;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* hbuf = smem + kOffH;
  float* part = reinterpret_cast<float*>(smem + kOffPart);
  float* stats = reinterpret_cast<float*>(smem + kOffStats);
  const uint32_t x_u32 = smem_u32(smem + kOffX), h_u32 = smem_u32(hbuf);
  const uint32_t ring_u32 = smem_u32(smem + kOffRing);
  const uint32_t bars = smem_u32(smem + kOffBar);
  const uint32_t x_bar = bars + 2 * kStages * 8;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int r0 = 16 * ((tid % 128) / 32) + g8;  // rows r0, r0 + 8
  const int r = static_cast<int>(cluster_rank());
  const int half = r / NI, slice = r % NI;
  const int m0 = (blockIdx.x / R) * kBM;
  const int M = p.M, I = p.I;

  // this CTA's work (ops/_plan.cta_work mirrors it): chunks [ch0, ch0
  // + nch) of the intermediate (the last may be ragged: its columns past
  // I load as zeros and are set to 0), the sums of the columns [384 half,
  // + 384), the columns [own0, own1) of out
  const int n_ch = (I + kChunk - 1) / kChunk;
  const int nch = n_ch / NI, ch0 = nch * slice;
  const int own0 = kH * r / R, own1 = kH * (r + 1) / R;
  const int steps = 18 * nch;
  Ring<kStages> ring;
  ring.init(bars);
  if (tid == 0) {
    mbar_init(x_bar, 1);
    fence_mbar_init();
  }
  cluster_sync();

  // producer: step u's boxes, one a warpgroup: W1 rows of the chunk's
  // warpgroup half at k step s (s < 12), then W2's rows 384 half + 192 w
  // + 64 g at the chunk's k half ks (s = 12 + 3 ks + g)
  auto issue = [&](int u, int slot, uint32_t bar) {
    const int ch = ch0 + u / 18, s = u % 18;
    mbar_expect_tx(bar, kSlot);
    const uint32_t dst = ring_u32 + slot * kSlot;
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      if (s < 12)
        tma_load(dst + w * kBox, &p.w1, bar, 64 * s, kChunk * ch + 64 * w);
      else
        tma_load(dst + w * kBox, &p.w2, bar, kChunk * ch + 64 * ((s - 12) / 3),
                 384 * half + 192 * w + 64 * ((s - 12) % 3));
    }
  };

  if (tid >= 256) {  // the producer warp
    if (tid == 256) {  // this CTA's rows of x, once (zeros past M)
      mbar_expect_tx(x_bar, kKSteps * kBox);
      for (int kb = 0; kb < kKSteps; ++kb)
        tma_load(x_u32 + kb * kBox, &p.x_map, x_bar, 64 * kb, m0);
      for (int u = 0; u < steps; ++u) ring.produce(u, issue);
    }
    __syncwarp();
    // the consumers' cluster barriers: the partial sums' two (NI > 1),
    // the LayerNorm's two, the last one
    for (int i = 0; i < (NI > 1 ? 5 : 3); ++i) cluster_sync();
    return;
  }

  float acc[3][32];  // started by the first chunk's products
  auto fence_acc = [&]() {
#pragma unroll
    for (int g = 0; g < 3; ++g) fence_regs(acc[g]);
  };
  auto desc_w = [&](int slot, int j) {
    return desc_sw128(ring_u32 + slot * kSlot + wg * kBox + 32 * j);
  };
  mbar_wait(x_bar, 0);

  int t = 0;
  float hacc[32];
  for (int ci = 0; ci < nch; ++ci) {
    const int ch = ch0 + ci;
    // h chunk: this warpgroup's 64 of its 128 columns (the first
    // product starts the sums)
    for (int s = 0; s < kKSteps; ++s, ++t) {
      const int slot = ring.wait(t);
      wgmma_fence();
      fence_regs(hacc);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_bf16_ss(hacc, desc_sw128(x_u32 + s * kBox + 32 * j),
                      desc_w(slot, j), s > 0 || j > 0);
      wgmma_commit();
      fence_regs(hacc);
      wgmma_wait<1>();
      ring.release(t);
    }
    wgmma_wait<0>();
    fence_regs(hacc);
    // both warpgroups are done with the last chunk's FFN2 (its h)
    consumer_sync();
    // + b1, gelu, bf16 into the h chunk (read after the next step's
    // barrier); columns past I are 0. The gelu form is chosen once for
    // the loop, and b1 is read at a clamped index and selected after:
    // branches around the loads made each wait for its data.
    auto store_h = [&](auto gelu) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int rr = r0 + 8 * ((e >> 1) & 1);
        const int i = kChunk * ch + 64 * wg + 8 * (e >> 2) + 2 * t4;
        const float2 b = ld_f2(p.b1, min(i, I - 2));
        const float h0 = gelu(__fadd_rn(hacc[e], b.x));
        const float h1 = gelu(__fadd_rn(hacc[e + 1], b.y));
        *reinterpret_cast<__nv_bfloat162*>(
            hbuf + sw128_offset(rr, 2 * (i - kChunk * ch))) =
            __floats2bfloat162_rn(i < I ? h0 : 0.f, i + 1 < I ? h1 : 0.f);
      }
    };
    if (p.approx)
      store_h([](float h) { return gelu_tanh(h); });
    else
      store_h([](float h) { return gelu_erf(h); });
    fence_async_shared();
    consumer_sync();  // the whole chunk is in hbuf
    // this half's sums += h chunk . W2[half, chunk]^T
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int g = 0; g < 3; ++g, ++t) {
        const int slot = ring.wait(t);
        wgmma_fence();
        fence_acc();
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma_bf16_ss(acc[g], desc_sw128(h_u32 + ks * 8192 + 32 * j),
                        desc_w(slot, j), ci > 0 || ks > 0 || j > 0);
        wgmma_commit();
        fence_acc();
        wgmma_wait<1>();
        ring.release(t);
      }
    }
  }
  wgmma_wait<0>();
  fence_acc();

  // element e of accumulator tile g: row r0 + 8 ((e >> 1) & 1), column
  // cb + 64 g + 8 (e >> 2) + 2 t4 + (e & 1)
  const int cb = 384 * half + 192 * wg;
  if (NI > 1) {
    // the partial sums of this half's columns to the slice that owns
    // them, in the operands' and the ring's memory, which the cluster is
    // done with
    constexpr int W = 384 / NI;
    cluster_sync();
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int rr = r0 + 8 * ((e >> 1) & 1);
        const int c = cb + 64 * g + 8 * (e >> 2) + 2 * t4;
        const int o = (c - 384 * half) / W;
        if (o == slice) continue;
        const int sl = slice < o ? slice : slice - 1;
        st_cluster_v2(mapa(smem_u32(smem) +
                               ((sl * kBM + rr) * W + c - 384 * half - o * W) * 4,
                           half * NI + o),
                      __float_as_uint(acc[g][e]),
                      __float_as_uint(acc[g][e + 1]));
      }
    cluster_sync();
    // the slices' partial sums in slice order (this CTA's own in place)
    const float* recv = reinterpret_cast<const float*>(smem);
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int rr = r0 + 8 * ((e >> 1) & 1);
        const int c = cb + 64 * g + 8 * (e >> 2) + 2 * t4 + (e & 1);
        // another CTA's columns read a valid element, unused
        const int cl = min(max(c - own0, 0), W - 1);
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int sl = j < slice ? j : j - 1;
          v += j == slice ? acc[g][e] : recv[(sl * kBM + rr) * W + cl];
        }
        acc[g][e] = v;
      }
  }

  // y = sums + b2 + x; LayerNorm over the row's 768 columns
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      // rows past M read a valid row, unused
      const int rr = min(m0 + r0 + 8 * ((e >> 1) & 1), M - 1);
      const int c = cb + 64 * g + 8 * (e >> 2) + 2 * t4;
      const float2 xv = ld_bf2(p.x, static_cast<long long>(rr) * kH + c);
      const float2 b = ld_f2(p.b2, c);
      acc[g][e] = __fadd_rn(__fadd_rn(acc[g][e], b.x), xv.x);
      acc[g][e + 1] = __fadd_rn(__fadd_rn(acc[g][e + 1], b.y), xv.y);
      const bool own = c >= own0 && c < own1;
      s[(e >> 1) & 1] += own ? acc[g][e] + acc[g][e + 1] : 0.f;
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
      const int c = cb + 64 * g + 8 * (e >> 2) + 2 * t4 + (e & 1);
      const float d = __fsub_rn(acc[g][e], mu[(e >> 1) & 1]);
      sq[(e >> 1) & 1] += c >= own0 && c < own1 ? __fmul_rn(d, d) : 0.f;
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
      const int h = (e >> 1) & 1, rr = r0 + 8 * h;
      const int c = cb + 64 * g + 8 * (e >> 2) + 2 * t4;
      const float2 ga = ld_f2(p.g, c), be = ld_f2(p.beta, c);
      if (c < own0 || c >= own1 || m0 + rr >= M) continue;
      float o[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float n = __fmul_rn(__fsub_rn(acc[g][e + k], mu[h]), rstd[h]);
        o[k] = __fadd_rn(__fmul_rn(n, k ? ga.y : ga.x), k ? be.y : be.x);
      }
      *reinterpret_cast<__nv_bfloat162*>(
          p.out + static_cast<long long>(m0 + rr) * kH + c) =
          __floats2bfloat162_rn(o[0], o[1]);
    }
  // no CTA leaves while another may still write to its shared memory
  cluster_sync();
}

template <int NI>
int launch(const Params& p, cudaStream_t stream) {
  auto kernel = fused_ffn_kernel<NI>;
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

// x (M, 768) bf16, w1 (I, 768) bf16, b1 (I,) fp32, w2 (768, I) bf16,
// b2 / g / beta (768,) fp32, out (M, 768) bf16; I a multiple of 64 and
// every pointer 16-byte aligned. approx: 1 = tanh gelu, 0 = exact.
// split (1 or 2, dividing I's 128-wide chunks): the slices of the
// intermediate a row block's cluster of 2 x split CTAs takes
// (ops/_plan.launch_plan). Returns the launch's cudaError_t (0 on
// success).
int fused_ffn_launch(const void* x, const void* w1, const void* b1,
                     const void* w2, const void* b2, const void* g,
                     const void* beta, void* out, int M, int I, float eps,
                     int approx, int split, void* stream) {
  if (M < 1 || I < 64 || I % 64 != 0 ||
      ((I + kChunk - 1) / kChunk) % split != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  if (!encode(&p.x_map, x, M, kH, true, 64) ||
      !weight_map(&p.w1, w1, I, kH, true, 64) ||
      !weight_map(&p.w2, w2, kH, I, true, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  p.x = static_cast<const bf16*>(x);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.g = static_cast<const float*>(g);
  p.beta = static_cast<const float*>(beta);
  p.out = static_cast<bf16*>(out);
  p.M = M;
  p.I = I;
  p.approx = approx;
  p.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split == 1) return launch<1>(p, s);
  if (split == 2) return launch<2>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fused_ffn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
