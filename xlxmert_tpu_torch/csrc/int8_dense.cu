// Int8 dense layer: activation quantization, int8 x int8 -> int32 product
// on Hopper's warpgroup tensor cores (wgmma), dequantization and bias,
// bf16 out.
//
// Replaces the TPU kernel xlxmert_tpu/ops/int8_matmul.py::int8_dense_fused
// (_kernel), and carries the static-scale dense that the JAX package
// leaves to XLA (xlxmert_tpu/ops/quant.py::int8_dense_static). Two
// prologue modes over x (M, K) bf16:
//   dynamic: s = max(amax(|x_row|) / 127, 1e-8); x8 = round(x / s)
//            out = acc * s * scale[n] + bias[n]
//   static:  x8 = clip(round(x * inv_a), -127, 127)
//            out = acc * out_scale[n] + bias[n]
// Rounding is to nearest even (__float2int_rn), as jnp.round; the
// epilogue is __int2float_rn, x s (dynamic), x scale[n], + bias[n],
// __float2bfloat16_rn, in that order, so the kernel is bit-equal to its
// plain version. w is (N, K) int8, row n = output channel n (nn.Linear
// layout).
//
// What bounds it on an H100: 2 M N K int8 operations on M K 2 + N K + M N
// 2 bytes, against 1,979 TOP/s and 3.35 TB/s (the ridge is ~590
// operations per byte). The serving path's two visual FFN products (M =
// 16,384: 768 -> 3,072 and 3,072 -> 768) are bound by operations; every
// other shape by bytes, the answer head (M = 256) and the calibration
// shapes (M = 8 .. 640) by reading w. Only wgmma reaches the int8 rate,
// and its operands have to keep coming: the design
//   - runs one or two consumer warpgroups per CTA (64 or 128 rows), each
//     issuing wgmma.m64nNk32.s32.s8.s8 (N = 64 or 128, one or two per k
//     step) on its own 64 rows, the int32 sums in registers;
//   - streams K in 64-wide steps through a ring of 4-5 stages in shared
//     memory, STAGES - 2 steps ahead of the products: one thread asks
//     TMA for each step's two boxes (x and w, zero-filled past M, N and
//     K) on the stage's mbarrier, so no other thread spends an
//     instruction on a copy; one barrier a step hands the stage back.
//     In development a ring filled by 16-byte cp.async from every
//     thread ran 20-30 % slower at the serving shapes, and a producer
//     warpgroup with "empty" mbarriers instead of the barrier (and
//     setmaxnreg 40 / 232) ran ~35 % slower: ptxas kept the 128 x 256
//     tile's consumers at 168 registers, with spills;
//   - takes w's tile (N, K) int8, K-major, as wgmma's B operand as TMA
//     lands it, in the 64-byte swizzle the descriptor names; w's TMA
//     descriptor is built once per weight and kept;
//   - lands the activation tile as bf16 (128-byte swizzle: the 8 rows of
//     a fragment read hit 32 banks) and quantizes it into registers in
//     wgmma's A fragment layout (A comes from registers): the int8 copy
//     of x never exists outside registers, as in the TPU kernel. Two
//     register sets alternate, so one step's quantization runs while the
//     previous step's wgmma is in flight (wgmma.wait_group 1). The
//     rounding adds 1.5 * 2^23 instead of converting (see quantize);
//   - dequantizes on the accumulators with col_scale and bias read once
//     per column tile into shared memory, stages the bf16 tile in the
//     two ring stages the next tile's prologue leaves free and stores
//     whole 16-byte pieces of rows (element stores where N is not a
//     multiple of 8: the answer heads). Stores of bf16 pairs straight
//     from the registers (8 rows x 16 bytes a warp) ran 10-20 % slower
//     at the visual shapes in development;
//   - runs as many CTAs as the card holds at once (1, 3 or 4 an SM, by
//     shared memory), each over a run of tiles, column tiles fastest:
//     the next tile's first steps load during one's epilogue, the CTAs
//     in flight share the rows of x they read through L2, and the
//     dynamic mode computes a row block's scales once, when a run
//     enters it;
//   - picks the 128 x 256 tile wherever it keeps half the SMs busy,
//     else 64 x 128, else 64 x 64 (at the text rows the underfilled 128
//     x 256 tile beat twice as many 128 x 128 or 64 x 128 ones, which
//     re-read x more).
// The small-M shapes (the answer head, M = 256; calibration, M = 8 ..
// 640) keep this kernel on 64-row tiles: a 64-row wgmma is mostly
// padding there, but those shapes are bound by reading w, which the
// ring streams.

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kBK = 64;     // K values (bytes of int8) per step

// WGS consumer warpgroups (64 rows each); NI the wgmma's N, NSUB wgmmas
// side by side per k step: a BM x BN output tile.
template <int WGS, int NI, int NSUB, int STAGES>
struct Tile {
  static constexpr int BM = 64 * WGS;
  static constexpr int BN = NI * NSUB;
  static constexpr int kThreads = 128 * WGS;
  static constexpr int kBBytes = BN * kBK;     // w tile, 64-byte swizzle
  static constexpr int kABytes = BM * 2 * kBK;  // x tile, 128-byte swizzle
  static constexpr int kSlot = kBBytes + kABytes;  // one ring stage
  static constexpr int kRing = STAGES * kSlot;
  static constexpr int kOutRow = 2 * BN;  // staged bf16 row (B), swizzled
  static constexpr int kSmem = 1024 + kRing + 4 * (4 * BN + BM) + 8 * STAGES;
  static_assert(kBBytes % 1024 == 0 && kSlot % 1024 == 0,
                "swizzled tiles stay 1024-aligned");
  static_assert(BM * kOutRow <= 2 * kSlot,
                "the output tile fits the two stages a prologue leaves");
};

#define I8_ACC8(i)                                                    \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),         \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x NI, int32, accumulated) += a (64 x 32 int8, registers) x b^T
// (NI x 32 int8, shared memory, descriptor)
template <int NI>
__device__ __forceinline__ void wgmma_s8(int (&d)[NI / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : I8_ACC8(0), I8_ACC8(8), I8_ACC8(16), I8_ACC8(24), I8_ACC8(32),
        I8_ACC8(40), I8_ACC8(48), I8_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : I8_ACC8(0), I8_ACC8(8), I8_ACC8(16), I8_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

#undef I8_ACC8

// x / s (dynamic) or x * inv_a (static), rounded to the nearest integer
// (ties to even) and clamped to +-127, as __float2int_rn and a clamp
// give it, returned as the fp32 bits of 1.5 * 2^23 + q: the low byte is
// q in two's complement. Clamping first and then adding 1.5 * 2^23 (whose
// fp32 step is 1, so the addition rounds to nearest even) is exact for
// every finite y and avoids the conversion unit (16 a clock per SM),
// which made the quantization the kernel's bound.
__device__ __forceinline__ uint32_t quantize(float x, float s, float inv_a,
                                             int dynamic) {
  const float y = dynamic ? __fdiv_rn(x, s) : __fmul_rn(x, inv_a);
  return __float_as_uint(
      __fadd_rn(fminf(fmaxf(y, -127.f), 127.f), 12582912.f));
}

// four bf16 (8 bytes) -> four int8 in one register, the first lowest
__device__ __forceinline__ uint32_t quantize4(uint2 raw, float s,
                                              float inv_a, int dynamic) {
  const uint32_t q0 = quantize(__uint_as_float(raw.x << 16), s, inv_a,
                               dynamic);
  const uint32_t q1 = quantize(__uint_as_float(raw.x & 0xffff0000u), s,
                               inv_a, dynamic);
  const uint32_t q2 = quantize(__uint_as_float(raw.y << 16), s, inv_a,
                               dynamic);
  const uint32_t q3 = quantize(__uint_as_float(raw.y & 0xffff0000u), s,
                               inv_a, dynamic);
  return __byte_perm(__byte_perm(q0, q1, 0x0040), __byte_perm(q2, q3, 0x0040),
                     0x5410);
}

template <int WGS, int NI, int NSUB, int STAGES>
__global__ void __launch_bounds__(128 * WGS, 1)
    int8_dense_kernel(const __grid_constant__ CUtensorMap tmx,
                      const __grid_constant__ CUtensorMap tmw,
                      const bf16* __restrict__ x,
                      const float* __restrict__ col_scale,
                      const float* __restrict__ bias,
                      bf16* __restrict__ out, int M, int N, int K,
                      float inv_a, int dynamic, int tiles_per_cta) {
  using T = Tile<WGS, NI, NSUB, STAGES>;
  constexpr int BM = T::BM, BN = T::BN, kThreads = T::kThreads;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // STAGES slots of a w tile (BN rows of 64 bytes, 64-byte swizzle) and
  // an x tile (BM rows of 64 bf16, 128-byte swizzle), as TMA lands them;
  // then col_scale and bias of two column tiles (by tile parity: one
  // tile's are written while the last one's epilogue may read its own),
  // the row scales and a barrier per slot. The epilogue stages the
  // output tile in the last two slots, which the next tile's prologue
  // leaves free.
  const uint32_t b_u32 = smem_u32(smem);
  const uint32_t a_u32 = b_u32 + T::kBBytes;
  const unsigned char* a_ring = smem + T::kBBytes;
  unsigned char* o_s = smem + (STAGES - 2) * T::kSlot;
  float* cs = reinterpret_cast<float*>(smem + T::kRing);  // 2 x BN
  float* bs = cs + 2 * BN;                                // 2 x BN
  float* rs = bs + 2 * BN;                                // BM
  const uint32_t bar_u32 = smem_u32(rs + BM);             // STAGES x 8 B

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int t = lane % 4;  // fragment column group
  const int r0 = 16 * (tid / 32) + g;  // this thread's rows: r0, r0 + 8
  const int KT = (K + kBK - 1) / kBK;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * n_tiles;
  const int first = blockIdx.x * tiles_per_cta;
  const int last = min(first + tiles_per_cta, tiles);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bar_u32 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // step kt of the tile at (m0, n0) into ring slot kt % STAGES: one
  // thread asks TMA for both boxes (full boxes: zeros past M, N and K)
  auto load_stage = [&](int m0, int n0, int kt) {
    if (tid == 0) {
      const int slot = kt % STAGES;
      const uint32_t bar = bar_u32 + 8 * slot;
      mbar_expect_tx(bar, T::kSlot);
      tma_load(b_u32 + slot * T::kSlot, &tmw, bar, kt * kBK, n0);
      tma_load(a_u32 + slot * T::kSlot, &tmx, bar, kt * kBK, m0);
    }
  };
  auto prologue = [&](int tile) {
    const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
    for (int s = 0; s < STAGES - 2 && s < KT; ++s) load_stage(m0, n0, s);
  };
  uint32_t phases = 0;  // bit s: the parity slot s's next wait waits past

  // A CTA takes the run of tiles [first, last), column tiles fastest:
  // the row block's scales (dynamic) are computed when the run enters a
  // row block, and the next tile's first steps load during this one's
  // epilogue.
  if (first < last) prologue(first);
  int scaled_m0 = -1;
  float s0 = 1.f, s1 = 1.f;
  for (int tile = first; tile < last; ++tile) {
    const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
    float* cst = cs + (tile & 1) * BN;
    float* bst = bs + (tile & 1) * BN;
    for (int c = tid; c < BN; c += kThreads) {
      const int n = n0 + c;
      cst[c] = n < N ? col_scale[n] : 0.f;
      bst[c] = (bias != nullptr && n < N) ? bias[n] : 0.f;
    }
    if (dynamic && m0 != scaled_m0) {
      for (int r = tid / 32; r < BM; r += kThreads / 32) {
        const int m = m0 + r;
        float amax = 0.f;
        if (m < M) {
          const bf16* row = x + static_cast<long long>(m) * K;
          for (int k = lane * 8; k < K; k += 32 * 8) {
            const uint4 raw = *reinterpret_cast<const uint4*>(row + k);
            const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              amax = fmaxf(amax, fabsf(__bfloat162float(v[e])));
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
        if (lane == 0) rs[r] = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
      }
      __syncthreads();
      s0 = rs[r0];
      s1 = rs[r0 + 8];
      scaled_m0 = m0;
    }

    int acc[NSUB][NI / 2];
#pragma unroll
    for (int i = 0; i < NSUB; ++i)
#pragma unroll
      for (int e = 0; e < NI / 2; ++e) acc[i][e] = 0;
    // A fragments: two sets, by the parity of the step, so that one
    // step's quantization never writes registers a wgmma in flight reads
    uint32_t af[2][2][4];

    for (int kt0 = 0; kt0 < KT; kt0 += 2) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int kt = kt0 + p;
        if (kt >= KT) break;
        const int slot = kt % STAGES;
        // every warpgroup is past step kt - 2's wgmma: its slot refills
        __syncthreads();
        if (kt + STAGES - 2 < KT) load_stage(m0, n0, kt + STAGES - 2);
        mbar_wait(bar_u32 + 8 * slot, (phases >> slot) & 1);
        phases ^= 1u << slot;

        // quantize x's tile into the A fragments: register 2h + rr holds
        // row r0 + 8 rr, columns 32 j + 16 h + 4t .. + 3; the tile's
        // 16-byte piece c of row r sits at c ^ (r % 8)
        const unsigned char* a_s = a_ring + slot * T::kSlot;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int r = r0 + 8 * rr;
              const uint2 raw = *reinterpret_cast<const uint2*>(
                  a_s + r * 128 + (((4 * j + 2 * h + t / 2) ^ (r % 8)) << 4) +
                  8 * (t % 2));
              af[p][j][2 * h + rr] =
                  quantize4(raw, rr ? s1 : s0, inv_a, dynamic);
            }
        const uint32_t b_s = b_u32 + slot * T::kSlot;
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < NSUB; ++i) fence_regs(acc[i]);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < NSUB; ++i)
            wgmma_s8<NI>(acc[i], af[p][j],
                         desc_sw64(b_s + i * NI * 64 + 32 * j));
        wgmma_commit();
#pragma unroll
        for (int i = 0; i < NSUB; ++i) fence_regs(acc[i]);
        wgmma_wait<1>();
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NSUB; ++i) fence_regs(acc[i]);
    __syncthreads();  // every warpgroup is done with the ring
    if (tile + 1 < last) prologue(tile + 1);

    // epilogue: element e of 8-column block j sits at row r0 (+8 for e
    // >= 2), column 8j + 2t + e % 2; dequantized into the staged tile
    // (16-byte piece c of row r at c ^ (r % 8): the 8 rows of a store hit
    // 32 banks), then whole 16-byte pieces of rows out (element stores
    // where N is not a multiple of 8: the answer heads)
#pragma unroll
    for (int i = 0; i < NSUB; ++i)
#pragma unroll
      for (int j = 0; j < NI / 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int c = i * NI + 8 * j + 2 * t;
          const int r = r0 + 8 * rr;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float val = __int2float_rn(acc[i][4 * j + 2 * rr + e]);
            if (dynamic) val = __fmul_rn(val, rr ? s1 : s0);
            val = __fmul_rn(val, cst[c + e]);
            if (bias != nullptr) val = __fadd_rn(val, bst[c + e]);
            v[e] = val;
          }
          *reinterpret_cast<__nv_bfloat162*>(
              o_s + r * T::kOutRow + (((c / 8) ^ (r % 8)) << 4) + 4 * t) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
    __syncthreads();
    const bool vec = N % 8 == 0;  // 16-byte aligned output rows
    for (int q = tid; q < BM * (BN / 8); q += kThreads) {
      const int r = q / (BN / 8), c = (q % (BN / 8)) * 8;
      const int m = m0 + r, n = n0 + c;
      if (m >= M || n >= N) continue;
      const unsigned char* src =
          o_s + r * T::kOutRow + (((c / 8) ^ (r % 8)) << 4);
      bf16* dst = out + static_cast<long long>(m) * N + n;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        const bf16* v = reinterpret_cast<const bf16*>(src);
        for (int e = 0; e < 8 && n + e < N; ++e) dst[e] = v[e];
      }
    }
    // the next tile's first step refills the staging slots (TMA, the
    // async proxy) only after its barrier, which every thread reaches
    // past these reads and this fence
    fence_async_shared();
  }
}

template <int WGS, int NI, int NSUB, int STAGES>
int launch_tile(const void* x, const void* w, const void* col_scale,
                const void* bias, void* out, int M, int N, int K,
                float inv_a, int dynamic, cudaStream_t stream) {
  using T = Tile<WGS, NI, NSUB, STAGES>;
  auto kernel = int8_dense_kernel<WGS, NI, NSUB, STAGES>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  CUtensorMap tmx, tmw;
  if (!encode(&tmx, x, M, K, true, T::BM) ||
      !weight_map(&tmw, w, N, K, false, T::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  // as many CTAs as the card runs at once (1, 3 or 4 an SM, by shared
  // memory), each over an equal run of tiles
  const int tiles = ((M + T::BM - 1) / T::BM) * ((N + T::BN - 1) / T::BN);
  int resident = kSms * (232448 / (T::kSmem + 1024));
  resident = resident < 1 ? 1 : resident;
  int ctas = tiles < resident ? tiles : resident;
  const int per = (tiles + ctas - 1) / ctas;
  ctas = (tiles + per - 1) / per;
  kernel<<<ctas, T::kThreads, T::kSmem, stream>>>(
      tmx, tmw, static_cast<const bf16*>(x),
      static_cast<const float*>(col_scale), static_cast<const float*>(bias),
      static_cast<bf16*>(out), M, N, K, inv_a, dynamic, per);
  return static_cast<int>(cudaGetLastError());
}

long long ctas(int M, int N, int bm, int bn) {
  return static_cast<long long>((M + bm - 1) / bm) * ((N + bn - 1) / bn);
}

}  // namespace

extern "C" {

// x (M, K) bf16, w (N, K) int8, col_scale (N,) fp32: the weight scale
// (dynamic) or out_scale (static), bias (N,) fp32 or null, out (M, N)
// bf16. K must be a multiple of 16 and every pointer 16-byte aligned.
// Launches on `stream`, allocates nothing. Returns the launch's
// cudaError_t (0 on success).
int int8_dense_launch(const void* x, const void* w, const void* col_scale,
                      const void* bias, void* out, int M, int N, int K,
                      float inv_a, int dynamic, void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the 128 x 256 tile wherever it keeps half the SMs busy, then 64 x
  // 128, then 64 x 64 for the smallest shapes (the header says why)
  if (ctas(M, N, 128, 256) >= kSms / 2)
    return launch_tile<2, 128, 2, 5>(x, w, col_scale, bias, out, M, N, K,
                                     inv_a, dynamic, s);
  if (ctas(M, N, 64, 128) >= kSms / 2)
    return launch_tile<1, 128, 1, 4>(x, w, col_scale, bias, out, M, N, K,
                                     inv_a, dynamic, s);
  return launch_tile<1, 64, 1, 4>(x, w, col_scale, bias, out, M, N, K,
                                  inv_a, dynamic, s);
}

const char* int8_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
