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
// value, rounded to bf16. The integer products are exact, so only the
// order of the LayerNorm sums and tanhf can differ from the plain
// version: a bf16 step of y1, and one int8 step downstream.
//
// What bounds it on an H100: 2*M*768*(768 + 2 I + Nq) int8 operations
// against the weights (7.1 MB at I = 3,072, Nq = 2,304) plus M*768*2*3 +
// M*Nq*2 bytes of rows. A block with the FFN is bound by operations from
// M = 512 up: at M = 2,048 (B = 256, L = 8) 29 G ops take 14.6 us at
// 1,979 TOP/s and its 26 MB 7.8 us at 3.35 TB/s; at M = 16,384 0.117 ms
// against 0.047 ms. A block without the FFN (the cross outputs) is bound
// by bytes at every shape of the path, and so is every block at the
// batch-8 check shapes below M = 512. (chip_smoke.py computes the bound
// of each shape.)
//
// Measured on an H100 (chip_smoke.py): one CTA's pass over a full block
// takes 0.33 ms (M <= 4,096 is one wave), 432 tile steps of ~760 ns;
// M = 16,384 (3.9 waves) takes 1.55 ms; per serving forward of the
// length mix 23.4 ms against a 1.71 ms bound, and against 42.7 ms for
// the same chain through the int8 dense kernel and eager glue.
//
// What the design does about it: one CTA of 8 warps owns 32 rows and all
// 768 output columns, so the whole chain runs on data that never leaves
// the SM: the 768 int32 sums of a row tile stay in registers (96 a
// thread) through the out-projection and again through FFN2; y1 sits in
// shared memory as bf16 (for the second residual), and the int8 operand
// of every product (q(ctx), then q(y1), then q(y2)) in one 32 x 768
// shared buffer. The 3,072-wide FFN activation is streamed in 128-wide
// chunks: each chunk of FFN1 is dequantized, rounded, passed through
// gelu, quantized into shared memory and multiplied into the FFN2 sums
// at once. With a static scale and exact int32 sums the chunking changes
// no bit. The weights do not fit an SM's shared memory (the FFN's alone
// are 4.5 MiB), so they stream through a 6-stage cp.async ring of
// 128 x 128-byte tiles in one sequence per launch (36 of Wo, 12 per FFN
// chunk, 6 per 128 tail columns: 432 for a full block), and the ring does
// not drain between the phases. Products are mma.sync.m16n8k32.s8 (as in
// int8_dense.cu); each warp computes 16 rows x 32 columns of a tile. The
// ragged last row tile is masked (rows past M read as zero and are not
// written). 32 rows a CTA give 64 CTAs at M = 2,048 on 132 SMs (one
// wave, half the card) and 512 at M = 16,384 (3.9 waves); the rows per
// CTA are a constant of this file, not tuned yet. Every 32-row tile
// re-reads all four weights from L2, as every TPU row block re-read them
// from HBM. No wgmma or TMA yet: those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kH = 768;              // row width (hidden size)
constexpr int kBM = 32;              // rows per CTA
constexpr int kTile = 128;           // weight tile: 128 rows (n) x 128 k
constexpr int kSlices = kH / kTile;  // 128-wide slices of a 768-wide row
constexpr int kThreads = 256;        // 8 warps: 2 row tiles x 4 col groups
constexpr int kStages = 6;           // ring depth: 5 tiles in flight
constexpr int kAS = kH + 16;         // int8 operand row stride: 4 mod 32 words
constexpr int kYS = kH + 8;          // y1 (bf16) row stride: 4 mod 32 words
constexpr int kTS = kTile + 16;      // tile and h chunk row stride: 36 words
constexpr int kTileBytes = kTile * kTS;
constexpr int kSmemBytes = kBM * kAS + 2 * kBM * kYS + kBM * kTS +
                           kStages * kTileBytes + 2 * kBM * 4 * 4;

struct Rows {
  const __nv_bfloat16* ctx;
  const __nv_bfloat16* x;
  __nv_bfloat16* y;
  __nv_bfloat16* tail;
  int M;
};

// one int8 product: weight, out_scale, bias and the static input scale
struct Dense {
  const int8_t* w;
  const float* so;
  const float* b;
  float inv;
};

struct Block {
  Dense out, w1, w2, q;     // w1.w == nullptr: no FFN; q.w == nullptr: no tail
  const float *g1, *be1, *g2, *be2;
  int I, Nq;
  float eps;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// waits until at most kStages - 2 of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

// c += a b: a 16x32 (row), b 32x8 (col), s8 in, s32 sums. Not volatile:
// a register-only operation the compiler may schedule freely.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ int quant(float v, float inv) {
  return min(max(__float2int_rn(__fmul_rn(v, inv)), -127), 127);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// acc * out_scale[n] + bias[n], rounded to bf16
__device__ __forceinline__ float dequant(int acc, const Dense& d, int n) {
  return bf16_round(__fadd_rn(__fmul_rn(__int2float_rn(acc), d.so[n]),
                              d.b[n]));
}

// PyTorch's tanh gelu in its order of operations, without fused
// multiply-adds: 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(0.7978845608028654f,
                                __fadd_rn(x, __fmul_rn(0.044715f, cube)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, tanhf(inner)));
}

__device__ __forceinline__ uint16_t pack2(int a, int b) {
  return static_cast<uint16_t>((a & 0xff) | ((b & 0xff) << 8));
}

// Tile t of the launch's weight sequence into `dst`: first the
// out-projection (k tile t / 6, column slice t % 6), then with the FFN
// 12 per 128-wide chunk c of the intermediate (6 of W1: rows c*128.., k
// tile j; 6 of W2: rows s*128.., k from c*128), then the tail (column
// slice u / 6, k tile u % 6).
__device__ __forceinline__ void load_tile(int8_t* dst, int t,
                                          const Block& p) {
  const int8_t* src;
  long long ld = kH;
  if (t < kSlices * kSlices) {
    src = p.out.w + static_cast<long long>((t % kSlices) * kTile) * kH +
          (t / kSlices) * kTile;
  } else {
    t -= kSlices * kSlices;
    const int n_ffn = p.w1.w ? (p.I / kTile) * 2 * kSlices : 0;
    if (t < n_ffn) {
      const int c = t / (2 * kSlices), j = t % (2 * kSlices);
      if (j < kSlices) {
        src = p.w1.w + static_cast<long long>(c * kTile) * kH + j * kTile;
      } else {
        src = p.w2.w + static_cast<long long>((j - kSlices) * kTile) * p.I +
              c * kTile;
        ld = p.I;
      }
    } else {
      t -= n_ffn;
      src = p.q.w + static_cast<long long>((t / kSlices) * kTile) * kH +
            (t % kSlices) * kTile;
    }
  }
#pragma unroll
  for (int it = 0; it < kTile * kTile / 16 / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / (kTile / 16);
    const int c = (idx % (kTile / 16)) * 16;
    cp_async16(dst + r * kTS + c, src + r * ld + c);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_block_kernel(Rows rows, Block p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* as = reinterpret_cast<int8_t*>(smem_raw);  // [32][kAS] operand
  __nv_bfloat16* y1s =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + kBM * kAS);  // [32][kYS]
  int8_t* hs = reinterpret_cast<int8_t*>(y1s + kBM * kYS);     // [32][kTS]
  int8_t* tiles = hs + kBM * kTS;
  float* red = reinterpret_cast<float*>(tiles + kStages * kTileBytes);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;  // mma groupID
  const int tq = lane % 4;  // mma threadID_in_group
  const int mt = warp / 4;  // row tile: rows 16 mt .. 16 mt + 15
  const int np = warp % 4;  // columns 32 np .. 32 np + 31 of a tile
  const int m0 = blockIdx.x * kBM;
  const bool ffn = p.w1.w != nullptr;
  const bool tail = p.q.w != nullptr;
  const int n_tiles = kSlices * kSlices +
                      (ffn ? (p.I / kTile) * 2 * kSlices : 0) +
                      (tail ? (p.Nq / kTile) * kSlices : 0);

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(tiles + t * kTileBytes, t, p);
    cp_async_commit();
  }

  // q(ctx) rows of this CTA into the operand buffer (zeros past M)
  for (int idx = tid; idx < kBM * (kH / 8); idx += kThreads) {
    const int r = idx / (kH / 8);
    const int c = (idx % (kH / 8)) * 8;
    uint32_t lo = 0, hi = 0;
    if (m0 + r < rows.M) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          rows.ctx + static_cast<long long>(m0 + r) * kH + c);
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lo |= (static_cast<uint32_t>(quant(__bfloat162float(v[e]),
                                           p.out.inv)) & 0xffu) << (8 * e);
        hi |= (static_cast<uint32_t>(quant(__bfloat162float(v[e + 4]),
                                           p.out.inv)) & 0xffu) << (8 * e);
      }
    }
    *reinterpret_cast<uint2*>(as + r * kAS + c) = make_uint2(lo, hi);
  }

  // Waits for tile t, then starts the copy of tile t + kStages - 1 into
  // the stage every warp has finished reading (tile t - 1's); returns
  // tile t. Its barrier also publishes the shared operands written
  // before it.
  auto next_tile = [&](int t) -> const int8_t* {
    cp_async_wait_ring();
    __syncthreads();
    const int ahead = t + kStages - 1;
    if (ahead < n_tiles)
      load_tile(tiles + (ahead % kStages) * kTileBytes, ahead, p);
    cp_async_commit();
    return tiles + (t % kStages) * kTileBytes;
  };
  // c[j] += a (this warp's 16 rows, 128 k from column k0 of `a`, row
  // stride `sa`) . tile (rows 32 np + 8 j .., the same 128 k)^T
  auto mma_tile = [&](int (*c)[4], const int8_t* a, int sa, int k0,
                      const int8_t* tile) {
#pragma unroll
    for (int kk = 0; kk < kTile; kk += 32) {
      const int8_t* ab = a + (16 * mt + gq) * sa + k0 + kk + 4 * tq;
      uint32_t af[4] = {ld32(ab), ld32(ab + 8 * sa), ld32(ab + 16),
                        ld32(ab + 8 * sa + 16)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* bb = tile + (32 * np + 8 * j + gq) * kTS + kk + 4 * tq;
        uint32_t bf[2] = {ld32(bb), ld32(bb + 16)};
        mma_s8(c[j], af, bf);
      }
    }
  };

  // acc[s][j][e] sits at row 16 mt + 8 (e / 2) + gq, column
  // 128 s + 32 np + 8 j + 2 tq + e % 2
  int acc[kSlices][4][4];
#pragma unroll
  for (int s = 0; s < kSlices; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][j][e] = 0;

  // a row's total over its quad, then over the 4 warps of its row tile,
  // divided by 768
  auto row_mean = [&](float* v, float* buf, float* mean) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = v[h];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (tq == 0) buf[(16 * mt + 8 * h + gq) * 4 + np] = s;
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* b = buf + (16 * mt + 8 * h + gq) * 4;
      mean[h] = __fdiv_rn(b[0] + b[1] + b[2] + b[3], static_cast<float>(kH));
    }
  };
  // LayerNorm of the 768-wide rows whose bf16-rounded pre-norm values
  // acc holds as float bits; leaves the bf16-rounded outputs there.
  // Its barriers also tell that every warp is done with the products.
  auto layer_norm = [&](const float* g, const float* be) {
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int s = 0; s < kSlices; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[e / 2] += __int_as_float(acc[s][j][e]);
    float mu[2], rstd[2];
    row_mean(sum, red, mu);
    float sq[2] = {0.f, 0.f};
#pragma unroll
    for (int s = 0; s < kSlices; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = __fsub_rn(__int_as_float(acc[s][j][e]), mu[e / 2]);
          sq[e / 2] = __fadd_rn(sq[e / 2], __fmul_rn(d, d));
        }
    row_mean(sq, red + kBM * 4, rstd);
#pragma unroll
    for (int h = 0; h < 2; ++h) rstd[h] = rsqrtf(__fadd_rn(rstd[h], p.eps));
#pragma unroll
    for (int s = 0; s < kSlices; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = s * kTile + 32 * np + 8 * j + 2 * tq + e % 2;
          const float n = __fmul_rn(
              __fsub_rn(__int_as_float(acc[s][j][e]), mu[e / 2]),
              rstd[e / 2]);
          acc[s][j][e] = __float_as_int(
              bf16_round(__fadd_rn(__fmul_rn(n, g[c]), be[c])));
        }
  };
  // the LayerNorm outputs in acc: to y when `last`, as bf16 into y1s
  // when `keep`, and quantized with `inv` into the operand buffer
  auto store = [&](bool last, bool keep, bool quantize, float inv) {
#pragma unroll
    for (int s = 0; s < kSlices; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * mt + 8 * h + gq;
          const int c = s * kTile + 32 * np + 8 * j + 2 * tq;
          const float v0 = __int_as_float(acc[s][j][2 * h]);
          const float v1 = __int_as_float(acc[s][j][2 * h + 1]);
          const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
          if (last && m0 + r < rows.M)
            *reinterpret_cast<__nv_bfloat162*>(
                rows.y + static_cast<long long>(m0 + r) * kH + c) = v;
          if (keep)
            *reinterpret_cast<__nv_bfloat162*>(y1s + r * kYS + c) = v;
          if (quantize)
            *reinterpret_cast<uint16_t*>(as + r * kAS + c) =
                pack2(quant(v0, inv), quant(v1, inv));
        }
  };

  // 1. out-projection, + x, LN1
  int t = 0;
  for (int kt = 0; kt < kSlices; ++kt) {
#pragma unroll
    for (int s = 0; s < kSlices; ++s, ++t)
      mma_tile(acc[s], as, kAS, kt * kTile, next_tile(t));
  }
#pragma unroll
  for (int s = 0; s < kSlices; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + 16 * mt + 8 * (e / 2) + gq;
        const int c = s * kTile + 32 * np + 8 * j + 2 * tq + e % 2;
        const float xv = row < rows.M
            ? __bfloat162float(rows.x[static_cast<long long>(row) * kH + c])
            : 0.f;
        acc[s][j][e] = __float_as_int(
            bf16_round(__fadd_rn(dequant(acc[s][j][e], p.out, c), xv)));
      }
  layer_norm(p.g1, p.be1);
  store(!ffn, ffn, ffn || tail, ffn ? p.w1.inv : p.q.inv);

  // 2. FFN, chunk by chunk of the intermediate; + y1, LN2
  if (ffn) {
#pragma unroll
    for (int s = 0; s < kSlices; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][j][e] = 0;
    for (int c0 = 0; c0 < p.I; c0 += kTile) {
      int hacc[4][4] = {};
      for (int kt = 0; kt < kSlices; ++kt, ++t)
        mma_tile(hacc, as, kAS, kt * kTile, next_tile(t));
      // deq, bf16, gelu, bf16, q: into hs (read after the next barrier)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * mt + 8 * h + gq;
          const int c = 32 * np + 8 * j + 2 * tq;
          int q2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a1 = dequant(hacc[j][2 * h + e], p.w1, c0 + c + e);
            q2[e] = quant(bf16_round(gelu_tanh(a1)), p.w2.inv);
          }
          *reinterpret_cast<uint16_t*>(hs + r * kTS + c) = pack2(q2[0], q2[1]);
        }
#pragma unroll
      for (int s = 0; s < kSlices; ++s, ++t)
        mma_tile(acc[s], hs, kTS, 0, next_tile(t));
    }
#pragma unroll
    for (int s = 0; s < kSlices; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * mt + 8 * (e / 2) + gq;
          const int c = s * kTile + 32 * np + 8 * j + 2 * tq + e % 2;
          acc[s][j][e] = __float_as_int(bf16_round(__fadd_rn(
              dequant(acc[s][j][e], p.w2, c),
              __bfloat162float(y1s[r * kYS + c]))));
        }
    layer_norm(p.g2, p.be2);
    store(true, false, tail, p.q.inv);
  }

  // 3. tail: the next module's projection of y, 128 columns at a time
  if (tail) {
    for (int n0 = 0; n0 < p.Nq; n0 += kTile) {
      int hacc[4][4] = {};
      for (int kt = 0; kt < kSlices; ++kt, ++t)
        mma_tile(hacc, as, kAS, kt * kTile, next_tile(t));
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + 16 * mt + 8 * h + gq;
          const int c = n0 + 32 * np + 8 * j + 2 * tq;
          if (row >= rows.M) continue;
          *reinterpret_cast<__nv_bfloat162*>(
              rows.tail + static_cast<long long>(row) * p.Nq + c) =
              __floats2bfloat162_rn(dequant(hacc[j][2 * h], p.q, c),
                                    dequant(hacc[j][2 * h + 1], p.q, c + 1));
        }
    }
  }
}

}  // namespace

extern "C" {

// ctx, x (M, 768) bf16; wo (768, 768), w1 (I, 768), w2 (768, I), wq
// (Nq, 768) int8; so_* and b_* (N,) fp32 of each product; g1, be1, g2,
// be2 (768,) fp32; y (M, 768) and tail (M, Nq) bf16. w1 null: no FFN (w2,
// so_1, ..., be2 unused); wq null: no tail. I and Nq multiples of 128,
// every pointer to rows and weights 16-byte aligned. inv_*: the static
// input scale of each product. Returns the launch's cudaError_t (0 on
// success).
int fused_block_launch(const void* ctx, const void* x, const void* wo,
                       const void* so_o, const void* b_o, const void* g1,
                       const void* be1, const void* w1, const void* so_1,
                       const void* b_1, const void* w2, const void* so_2,
                       const void* b_2, const void* g2, const void* be2,
                       const void* wq, const void* so_q, const void* b_q,
                       void* y, void* tail, int M, int I, int Nq,
                       float inv_out, float inv_1, float inv_2, float inv_q,
                       float eps, void* stream) {
  if (M < 1 || (w1 && (I < kTile || I % kTile != 0)) ||
      (wq && (Nq < kTile || Nq % kTile != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fused_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  auto dense = [&](const void* w, const void* so, const void* b, float inv) {
    return Dense{static_cast<const int8_t*>(w), f(so), f(b), inv};
  };
  const Rows rows{static_cast<const __nv_bfloat16*>(ctx),
                  static_cast<const __nv_bfloat16*>(x),
                  static_cast<__nv_bfloat16*>(y),
                  static_cast<__nv_bfloat16*>(tail), M};
  const Block p{dense(wo, so_o, b_o, inv_out),
                dense(w1, so_1, b_1, inv_1),
                dense(w2, so_2, b_2, inv_2),
                dense(wq, so_q, b_q, inv_q),
                f(g1), f(be1), f(g2), f(be2), I, Nq, eps};
  fused_block_kernel<<<(M + kBM - 1) / kBM, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(rows, p);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
