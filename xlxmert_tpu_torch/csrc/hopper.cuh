// Hopper building blocks shared by the TMA + wgmma kernels of the port
// (int8_dense.cu, fused_block.cu, fused_ffn.cu; mha_hbatch.cu takes the
// mbarriers): mbarriers with a bounded wait, TMA loads, a ring of weight
// tiles they fill, thread-block-cluster barriers and distributed shared
// memory, wgmma with both operands in shared memory, shared-memory
// matrix descriptors, and the weights' TMA descriptors, built once per
// weight through cuTensorMapEncodeTiled looked up at run time (no
// -lcuda).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace hopper {

constexpr int kSms = 132;  // SMs of an H100 SXM

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// the barriers' initialisation -> visible to the cluster (and TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// one arrival on a barrier of this CTA
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// the consumer warpgroups (the first 256 threads) only: named barrier 1
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Waits for the phase after `parity` of the barrier. A wait that never
// ends (a fault in the pipeline) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1ll << 24)) asm volatile("trap;\n");
  }
}

// TMA: the box at (c0 along K, c1 along rows) of `map` into shared memory
// at dst, completing on `bar`; elements past the tensor's edge land as 0
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// this thread's shared-memory writes -> visible to wgmma and TMA (the
// async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the same for writes into other CTAs' shared memory of the cluster
__device__ __forceinline__ void fence_async_all() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster; orders their memory
// operations (release / acquire at cluster scope)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// the shared::cluster address of `addr` (a shared::cta address) in CTA
// `rank` of the cluster
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster_u16(uint32_t addr, uint16_t v) {
  asm volatile("st.shared::cluster.u16 [%0], %1;\n" ::"r"(addr), "h"(v)
               : "memory");
}

__device__ __forceinline__ void st_cluster_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}

__device__ __forceinline__ void st_cluster_v2(uint32_t addr, uint32_t a,
                                              uint32_t b) {
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};\n" ::"r"(addr),
               "r"(a), "r"(b)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulators across
// the asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major tile: rows of 64 bytes in
// the 64-byte swizzle (8-row groups 512 bytes apart) or of 128 bytes in
// the 128-byte swizzle (1,024 apart); the leading offset is unused for a
// swizzled K-major operand. A k step inside a row advances the address.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Byte offset of byte `k` of row `r` in a K-major operand of 64-row
// blocks of 128-byte rows in the 128-byte swizzle (as TMA lands a box of
// 128-byte rows): block k / 128, 16-byte piece (k % 128) / 16 of row r at
// piece ^ (r % 8).
__device__ __forceinline__ int sw128_offset(int r, int k) {
  return (k >> 7) * 8192 + r * 128 + ((((k & 127) >> 4) ^ (r & 7)) << 4) +
         (k & 15);
}

// Two neighbouring fp32 values, or two bf16 values as fp32 (an 8- or
// 4-byte aligned pair). The epilogues load unconditionally (at a clamped
// index) and select afterwards: a load under a branch waits for its
// data before the next one issues.
__device__ __forceinline__ float2 ld_f2(const float* p, int i) {
  return *reinterpret_cast<const float2*>(p + i);
}

__device__ __forceinline__ float2 ld_bf2(const __nv_bfloat16* p,
                                         long long i) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
}

#define HOPPER_ACC8(c, i)                                                \
  "+" c(d[i]), "+" c(d[i + 1]), "+" c(d[i + 2]), "+" c(d[i + 3]),        \
      "+" c(d[i + 4]), "+" c(d[i + 5]), "+" c(d[i + 6]), "+" c(d[i + 7])
#define HOPPER_D32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"

// d (64 x 64, int32) = a (64 x 32 int8) x b^T (64 x 32 int8) + (acc ?
// d : 0), both from shared memory (descriptors). acc = 0 starts a sum
// without an instruction that writes d outside wgmma (which would make
// ptxas serialize the wgmma pipeline).
__device__ __forceinline__ void wgmma_s8_ss(int (&d)[32], uint64_t a,
                                            uint64_t b, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " HOPPER_D32
      ", %32, %33, p;\n}\n"
      : HOPPER_ACC8("r", 0), HOPPER_ACC8("r", 8), HOPPER_ACC8("r", 16),
        HOPPER_ACC8("r", 24)
      : "l"(a), "l"(b), "r"(acc)
      : "memory");
}

// d (64 x 64, fp32) = a (64 x 16 bf16) x b^T (64 x 16 bf16) + (acc ?
// d : 0), both K-major in shared memory (descriptors)
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[32], uint64_t a,
                                              uint64_t b, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_ACC8("f", 0), HOPPER_ACC8("f", 8), HOPPER_ACC8("f", 16),
        HOPPER_ACC8("f", 24)
      : "l"(a), "l"(b), "r"(acc)
      : "memory");
}

#undef HOPPER_D32
#undef HOPPER_ACC8

// A ring of STAGES slots of weight tiles in shared memory between a
// producer warp and two consumer warpgroups. Step u of a launch's
// sequence lands in slot u % STAGES: the producer waits for the slot's
// "empty" barrier, expects the step's bytes on its "full" barrier and
// asks TMA for its boxes; the consumers wait for "full", run the step's
// wgmma, and release a slot once the wgmma that read it is done (after
// the next step's wgmma.wait_group 1). No block barrier a step.
template <int STAGES>
struct Ring {
  uint32_t full, empty;  // STAGES barriers each, 8 bytes apart

  __device__ void init(uint32_t bars) {
    full = bars;
    empty = bars + 8 * STAGES;
    if (threadIdx.x == 0)
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full + 8 * s, 1);
        mbar_init(empty + 8 * s, 2);
      }
  }

  // producer: step u (`issue(u, slot, bar)` expects the step's bytes on
  // bar and loads its boxes)
  template <class Issue>
  __device__ __forceinline__ void produce(int u, Issue&& issue) {
    const int slot = u % STAGES;
    if (u >= STAGES) mbar_wait(empty + 8 * slot, ((u / STAGES) - 1) & 1);
    issue(u, slot, full + 8 * slot);
  }

  // consumers: waits for step t's tiles; returns its slot
  __device__ __forceinline__ int wait(int t) const {
    const int slot = t % STAGES;
    mbar_wait(full + 8 * slot, (t / STAGES) & 1);
    __syncwarp();  // wgmma needs the warp converged
    return slot;
  }

  // consumers, after step t's wgmma.wait_group 1: step t - 1's slot is
  // free (one arrival a warpgroup)
  __device__ __forceinline__ void release(int t) const {
    if (t > 0 && threadIdx.x % 128 == 0)
      mbar_arrive(empty + 8 * ((t - 1) % STAGES));
  }
};

// The C CTAs of a cluster share a 64-row block and meet through
// distributed shared memory. v[h]: this thread's part of row r0 + 8 h
// (r0 = 16 warp + lane / 4 of its warpgroup wg) -> out[h], the row's
// total over the quad, the two consumer warpgroups and the C CTAs (in
// rank order, so every CTA gets the same bits). part: [2][64] floats;
// stats: [C][64] floats at the same offset in every CTA.
template <int C>
__device__ __forceinline__ void row_total(float (&v)[2], float (&out)[2],
                                          float* part, float* stats, int rank,
                                          int wg, int r0) {
  const int t4 = threadIdx.x % 4, tid = threadIdx.x;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    v[h] += __shfl_xor_sync(0xffffffffu, v[h], 1);
    v[h] += __shfl_xor_sync(0xffffffffu, v[h], 2);
    if (t4 == 0) part[wg * 64 + r0 + 8 * h] = v[h];
  }
  consumer_sync();
  if (tid < 64) {
    const float cta = part[tid] + part[64 + tid];
    const uint32_t a = smem_u32(stats + rank * 64 + tid);
#pragma unroll
    for (int j = 0; j < C; ++j)
      st_cluster_u32(mapa(a, j), __float_as_uint(cta));
  }
  cluster_sync();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) s += stats[j * 64 + r0 + 8 * h];
    out[h] = s;
  }
}

// Launches `kernel` on a grid of `ctas` CTAs of `threads` in clusters of
// `cluster` CTAs (1: no cluster).
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, int ctas, int threads, int smem,
                            int cluster, cudaStream_t stream,
                            Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// cuTensorMapEncodeTiled, looked up in libcuda at run time (no -lcuda
// at build time)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (rows, K) row-major tensor cut in boxes of 64 K values x box_rows:
// bf16 in the 128-byte swizzle, int8 in the 64-byte one.
inline bool encode(CUtensorMap* map, const void* ptr, int rows, int K,
                   bool bf16_, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int elem = bf16_ ? 2 : 1;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * elem};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map,
            bf16_ ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_UINT8,
            2, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            bf16_ ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The weights' descriptors, built once per (weight, shape, type, box): a
// descriptor holds only the address and the shape, so a weight freed and
// another allocated at the same address with the same shape reuses it.
struct WeightMap {
  const void* w;
  int N, K, box;
  bool bf16_;
  CUtensorMap map;
};

inline bool weight_map(CUtensorMap* map, const void* w, int N, int K,
                       bool bf16_, int box) {
  static std::mutex lock;
  static std::vector<WeightMap> cache;
  std::lock_guard<std::mutex> guard(lock);
  for (const WeightMap& e : cache)
    if (e.w == w && e.N == N && e.K == K && e.box == box &&
        e.bf16_ == bf16_) {
      *map = e.map;
      return true;
    }
  if (!encode(map, w, N, K, bf16_, box)) return false;
  if (cache.size() >= 4096) cache.clear();
  cache.push_back({w, N, K, box, bf16_, *map});
  return true;
}

}  // namespace hopper
