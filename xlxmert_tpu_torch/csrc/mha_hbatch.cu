// Packed-head attention with the heads of a batch row walked by one CTA.
//
// Replaces the TPU kernel `kern` (scripts/drive_attention_layout.py:183)
// of `core_hbatch`, its pl.pallas_call at :210: q (B, Lq, H*D), k/v
// (B, Lk, H*D) in bf16 with D = 64, H <= 12 and any row and batch stride
// (the q/k/v thirds of one fused QKV projection are read in place), bias
// (B, Lk) bf16 or absent (a null pointer), out (B, Lq, H*D) contiguous.
// It computes mha_blhd(fast=True)'s function with the TPU kernel's
// organisation, all heads of a batch row in one program, and it computes
// it bit for bit as mha_blhd.cu does: every head runs attention_mma.cuh's
// per-tile body (attend_tile: tensor-core scores, the scores near a bf16
// rounding tie recomputed in the plain version's order, the bf16
// softmax, p as e times the row's reciprocal sum, p v).
//
// What bounds it on an H100: each (b, h) does 4 Lq Lk D flops on
// (2 Lq + 2 Lk) D x 2 bytes (q, k, v and the context), about 32 flop/byte
// at L = 64, far below the ~295 flop/byte where bf16 tensor cores become
// the limit: the floor is the device-memory traffic, every operand byte
// read once (0.0094 ms at B=256, 20 x 20; 0.030 at 64 x 64).
//
// Design. Grid (B, G): CTA (b, g) owns batch row b and heads
// [g H/G, (g+1) H/G); the host's plan (ops/_plan.hbatch_plan) takes G = 1
// at the serving batch and splits the heads only where B alone would
// leave the card nearly empty. The CTA's heads pass through a ring of
// `slots` slots in shared memory, a slot one head's q, k and v (rows
// padded by 16 bytes, keys past Lk zero rows), loaded with 16-byte
// cp.async pieces that arrive on the head's mbarrier. `lanes` heads are
// computed at once, a lane one warp a 16-row q tile (2 warps at Lq = 20,
// 4 at Lq = 64), and there are more slots than lanes: while the lanes
// compute, the next heads land. A lane meets only its own warps (a named
// barrier), so lanes drift apart and one lane's loads overlap another's
// products, as independent CTAs would. A head takes (LQP + 2 LKP) x 144
// B: 27,648 at 64 x 64, 13,824 at 20 x 20; a CTA takes at most 116 KB
// (8 slots at 20 x 20, 4 at 64 x 64), so all B=256 rows are resident in
// one wave on 132 SMs, two CTAs an SM (the old kernel held a row's whole
// k and v, 124-218 KB, one CTA an SM, 1.94 waves). Each warp writes its
// context into the q tile it has consumed and stores it as whole 16-byte
// pieces. The bias row is read once a CTA. mma.sync, not wgmma: a 64-row
// M tile would be mostly padding at Lq = 20.
//
// Measured (scripts/time_hbatch_variants.py, H100 SXM at 700 W): the
// per-head body is latency-bound (a warp's softmax, its conversions and
// shuffles), so at one CTA a row the warps at work an SM set the pace.
// One head at a time (2-4 warps a CTA) ran 2.279 ms a layout forward
// whatever the ring's depth, rounds of 2-4 heads in lockstep 1.386,
// lanes with a ring of their own 1.318, this shared ring 1.272 (B1 at
// the same shapes 1.110, the old kernel 1.792; chip_smoke: 1.282, B1
// 1.094, 45-55 % of the byte bound at B=256). 12 warps at 64 keys
// spill in the 80 registers they leave a thread (slower); a refill by
// the lane's last warp alone instead of the lane's barrier is slower.

#include "attention_mma.cuh"
#include "hopper.cuh"

namespace hbatch {

using namespace attention_mma;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;

constexpr int kMaxHeads = 12;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a CTA
constexpr int kMaxSlots = 8;

// Warps a CTA, at most, at KT key tiles, two CTAs an SM: 12 up to 32 keys
// (80 registers a thread), 8 beyond (128: at 64 keys the per-tile body
// spills in 80).
constexpr int max_warps(int KT) { return KT <= 2 ? 12 : 8; }

// Dynamic shared memory of a CTA: `slots` heads' q (16 qt rows), k and v
// (16 kt rows each), a barrier a head, then the Lk bias in fp32.
inline int smem_bytes(int qt, int kt, int slots, int heads, int Lk) {
  return slots * (16 * qt + 2 * 16 * kt) * kRow *
             static_cast<int>(sizeof(bf16)) +
         heads * 8 + Lk * static_cast<int>(sizeof(float));
}

// bar.sync on named barrier `id` (1..15; 0 is __syncthreads) by
// `threads` threads
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// one arrival on `bar` once this thread's cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// KT: key tiles of 16 (Lk padded to 16 KT). Grid (B, H / heads); 32 x
// lanes x QT threads (QT = q tiles of 16 rows). The CTA's heads pass
// through a ring of `slots` slots: head j lands in slot j % slots and is
// computed by lane j % lanes, warp w of the CTA taking q tile w % QT of
// lane w / QT's head. The lane that finishes head j loads head j + slots
// into its slot (its threads' cp.async copies arrive on head j + slots'
// barrier); the lane of that head waits for the barrier. A barrier a
// head, not a slot: successive heads of a slot are computed by other
// lanes, which may run ahead of each other by more than the one phase a
// parity can tell apart. A lane meets only its own warps (named barrier
// 1 + lane), before it reloads a slot. Two CTAs an SM of at most
// max_warps(KT) warps each (the plan's residency counts on the registers
// that leaves).
template <int KT>
__global__ void __launch_bounds__(32 * max_warps(KT), 2)
    mha_hbatch_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ bias, bf16* __restrict__ out,
                      int H, int Lq, int Lk, long long q_bs, long long q_rs,
                      long long k_bs, long long k_rs, long long v_bs,
                      long long v_rs, float scale, int heads, int lanes,
                      int slots) {
  constexpr int LKP = 16 * KT;  // padded keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LQP = 16 * ((Lq + 15) / 16);
  const int qt = LQP / 16;
  const int per_head = (LQP + 2 * LKP) * kRow;  // elements of a slot
  const int lane_threads = 32 * qt;
  const int p = threadIdx.x / lane_threads;  // this thread's lane
  const int tid = threadIdx.x % lane_threads;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const uint32_t full = smem_u32(ring + slots * per_head);  // 8 B a head
  float* kb = reinterpret_cast<float*>(ring + slots * per_head) + 2 * heads;
  const int b = blockIdx.x;
  const int h0 = blockIdx.y * heads;

  // The rows that no copy writes are zeroed once: q past Lq, k and v past
  // Lk. Later the q rows past Lq hold the finite context of an earlier
  // head's padding rows, which no stored row reads.
  const int pad_at[3] = {Lq, LQP + Lk, LQP + LKP + Lk};
  const int pad_rows[3] = {LQP - Lq, LKP - Lk, LKP - Lk};
  for (int s = 0; s < slots; ++s)
#pragma unroll
    for (int t = 0; t < 3; ++t)
      for (int i = threadIdx.x; i < pad_rows[t] * (D / 8); i += blockDim.x)
        *reinterpret_cast<uint4*>(ring + s * per_head +
                                  (pad_at[t] + i / (D / 8)) * kRow +
                                  (i % (D / 8)) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x == 0)
    for (int j = 0; j < heads; ++j) mbar_init(full + 8 * j, lane_threads);
  if (bias != nullptr)
    for (int j = threadIdx.x; j < Lk; j += blockDim.x)
      kb[j] = __bfloat162float(bias[static_cast<long long>(b) * Lk + j]);
  __syncthreads();

  // head j into slot j % slots by this lane's threads, 16-byte pieces,
  // neighbouring threads on neighbouring addresses
  auto fill = [&](int j) {
    bf16* s = ring + (j % slots) * per_head;
    const int col = (h0 + j) * D;
    const bf16* src[3] = {q + b * q_bs + col, k + b * k_bs + col,
                          v + b * v_bs + col};
    const long long rs[3] = {q_rs, k_rs, v_rs};
    const int rows[3] = {Lq, Lk, Lk};
    const int at[3] = {0, LQP, LQP + LKP};
#pragma unroll
    for (int t = 0; t < 3; ++t)
      for (int i = tid; i < rows[t] * (D / 8); i += lane_threads) {
        const int r = i / (D / 8);
        const int c = (i % (D / 8)) * 8;
        cp_async16(s + (at[t] + r) * kRow + c, src[t] + r * rs[t] + c);
      }
    cp_async_arrive(full + 8 * j);
  };
  for (int j = p; j < min(slots, heads); j += lanes) fill(j);

  const int m0 = 16 * (tid / 32);  // this warp's q tile
  const long long hd = static_cast<long long>(H) * D;
  bf16* ob = out + static_cast<long long>(b) * Lq * hd;
  uint32_t no_mask[1][2] = {{0u, 0u}};
  for (int j = p; j < heads; j += lanes) {
    mbar_wait(full + 8 * j, 0);
    bf16* s = ring + (j % slots) * per_head;
    bf16* qh = s + m0 * kRow;
    bf16* ks = s + LQP * kRow;
    attend_tile<KT, true, false, false>(qh, ks, ks + LKP * kRow, kb,
                                        bias != nullptr, no_mask, Lk, scale);
    store_tile(ob + (h0 + j) * D, hd, qh, m0, Lq);
    if (j + slots < heads) {
      bar_sync(1 + p, lane_threads);  // every warp of the lane is done
      fill(j + slots);
    }
  }
}

// the largest dynamic shared memory a CTA may ask for (valid() checks
// the plan's bytes against it)
template <int KT>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(mha_hbatch_kernel<KT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem);
}

template <int KT>
int launch_kt(const void* q, const void* k, const void* v, const void* bias,
              void* out, int B, int H, int Lq, int Lk, long long q_bs,
              long long q_rs, long long k_bs, long long k_rs, long long v_bs,
              long long v_rs, float scale, int groups, int heads, int lanes,
              int slots, int warps, int smem, cudaStream_t stream) {
  const cudaError_t err = allow_smem<KT>();
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_hbatch_kernel<KT><<<dim3(B, groups), 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), H, Lq, Lk, q_bs, q_rs, k_bs, k_rs, v_bs,
      v_rs, scale, heads, lanes, slots);
  return static_cast<int>(cudaGetLastError());
}

template <int KT>
int resident_kt(int warps, int smem) {
  if (allow_smem<KT>() != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, mha_hbatch_kernel<KT>, 32 * warps, smem) != cudaSuccess)
    return -1;
  return n;
}

// The plan the kernel takes: groups x heads = H, lanes of one warp a q
// tile (at most max_warps), at most one lane a head, 1 to 8 slots (at
// most one a head, and more than the lanes unless every head has one),
// and the bytes smem_bytes gives.
inline bool valid(int B, int H, int Lq, int Lk, int groups, int heads,
                  int lanes, int slots, int warps, int smem) {
  const int qt = (Lq + 15) / 16;
  const int kt = (Lk + 15) / 16;
  return B >= 1 && H >= 1 && H <= kMaxHeads && Lq >= 1 && Lk >= 1 &&
         Lq <= kMaxL && Lk <= kMaxL && groups >= 1 && heads >= 1 &&
         groups * heads == H && lanes >= 1 && lanes <= heads &&
         warps == lanes * qt && warps <= max_warps(kt) && slots >= 1 &&
         slots <= kMaxSlots && slots <= heads &&
         (slots > lanes || slots == heads) &&
         smem == smem_bytes(qt, kt, slots, heads, Lk) && smem <= kMaxSmem;
}

}  // namespace hbatch

extern "C" {

// bf16 only; bias (B, Lk) bf16 or null; scale float32(1/sqrt(64)) as the
// caller rounds it; the plan of ops/_plan.hbatch_plan (grid (B, groups),
// heads a CTA, lanes, ring slots, warps, dynamic shared memory bytes). A
// plan the kernel cannot take launches nothing and returns
// cudaErrorInvalidValue. Returns the launch's cudaError_t (0 on success).
int mha_hbatch_launch(const void* q, const void* k, const void* v,
                      const void* bias, void* out, int B, int H, int Lq,
                      int Lk, long long q_bs, long long q_rs, long long k_bs,
                      long long k_rs, long long v_bs, long long v_rs,
                      float scale, int groups, int heads, int lanes,
                      int slots, int warps, int smem, void* stream) {
  using namespace hbatch;
  if (!valid(B, H, Lq, Lk, groups, heads, lanes, slots, warps, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((Lk + 15) / 16) {
    case 1:
      return launch_kt<1>(q, k, v, bias, out, B, H, Lq, Lk, q_bs, q_rs, k_bs,
                          k_rs, v_bs, v_rs, scale, groups, heads, lanes,
                          slots, warps, smem, s);
    case 2:
      return launch_kt<2>(q, k, v, bias, out, B, H, Lq, Lk, q_bs, q_rs, k_bs,
                          k_rs, v_bs, v_rs, scale, groups, heads, lanes,
                          slots, warps, smem, s);
    case 3:
      return launch_kt<3>(q, k, v, bias, out, B, H, Lq, Lk, q_bs, q_rs, k_bs,
                          k_rs, v_bs, v_rs, scale, groups, heads, lanes,
                          slots, warps, smem, s);
    default:
      return launch_kt<4>(q, k, v, bias, out, B, H, Lq, Lk, q_bs, q_rs, k_bs,
                          k_rs, v_bs, v_rs, scale, groups, heads, lanes,
                          slots, warps, smem, s);
  }
}

// CTAs of a plan resident on one SM at once, as the card's occupancy
// calculator counts them (registers, shared memory, threads), or -1.
int mha_hbatch_resident(int Lk, int warps, int smem) {
  switch ((Lk + 15) / 16) {
    case 1: return hbatch::resident_kt<1>(warps, smem);
    case 2: return hbatch::resident_kt<2>(warps, smem);
    case 3: return hbatch::resident_kt<3>(warps, smem);
    default: return hbatch::resident_kt<4>(warps, smem);
  }
}

const char* mha_hbatch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
