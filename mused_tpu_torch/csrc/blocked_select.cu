// Stride-binned kNN candidates for one row block of a huge window: similarity
// tile -> mask -> max-accumulate into nbins residue bins, keeping the winning
// group id.  The (block, n) similarity strip never reaches device memory.
//
// Replaces the TPU kernels mused_tpu/ops/pallas/blocked_select.py:
// binned_candidates_pallas (K2: _kernel, _sim_tile, _stat_operands) and
// binned_candidates_pair_pallas (K3: _pair_kernel).  Same function: for
// rows [start, start+block) and every column c = g * nbins + slot, the
// similarity is set to -1e30 where the column is invalid or c is the row's
// own index, and bin (row, slot) keeps the largest value over the groups g
// and its g (strict >, groups in ascending order: the lowest group wins a
// tie).  Metrics: dot (bf16), jaccard (int8 counts, hoisted f32 row sums),
// chord (bf16, hoisted squared norms), chord3 and l1 (f32 coordinates).
//
// Design for Hopper, not a copy of the TPU tiling (that one keeps the whole
// 2048-row block and its (2048, nbins) accumulator resident in VMEM across a
// sequential column grid):
//   * dot / jaccard / chord run on wgmma: m64n128k16 bf16 x bf16 -> f32 and
//     m64n128k32 s8 x s8 -> s32, which compute what the MXU does (exact
//     products, f32 or exact integer sums).  A CTA owns an output tile of
//     128 rows x 128 slots: two consumer warpgroups (64 rows each) keep the
//     tile's 64 f32 accumulators, its running (value, group) best and the
//     packed int8 groups in registers (setmaxnreg moves registers from the
//     producer warpgroup to them), and one producer thread keeps a 6-stage
//     ring of 128-byte feature chunks full with TMA (128-byte swizzle, the
//     wgmma layout; zero fill past the ragged edges; mbarrier full / empty
//     pairs);
//   * the 64 groups are split into contiguous ranges over the CTAs of a
//     cluster (1, 2 or 4 CTAs, chosen at launch to fill the 132 SMs), which
//     all sweep the same rows tile: each CTA loads 128 / splits of its rows
//     once and multicasts them to every CTA of the cluster, so the rows
//     tile is fetched once per cluster, not once per CTA.  A CTA walks its
//     groups in ascending order with strict >; at the end the partials are
//     merged through distributed shared memory in cluster-rank order with
//     strict >, so the lowest group still wins a tie;
//   * the epilogue stages each group's column validity and statistics in
//     shared memory once, and keeps the -1e30 mask, the self-column test and
//     the unfused __fadd_rn / __fsub_rn / __fdiv_rn order, so jaccard and
//     chord stay bit-equal to the plain version;
//   * chord3 and l1 are coordinate metrics with 2-3 features: a CUDA-core
//     kernel in which each thread owns 2 slots and the CTA's 16 rows, with
//     unfused __fsub_rn / __fmul_rn / __fadd_rn in the JAX package's
//     summation order (coordinate 0, 1, 2), so values are bit-identical to
//     the plain version.  It keeps the running minimum distance (sim =
//     -dist) and spends no instruction per pair on masks: invalid columns
//     are loaded as +inf coordinates, which never win, and the self test
//     runs only in the (at most 2) groups that can hold a row's own column.
//     K3 runs two such metrics in one pass and shares the not-self test;
//     each of its outputs is bit-identical to a K2 launch.
//
// What bounds it on an H100: at the huge-window shape (n = 98,304,
// block = 2048, nbins = 1536) text is 1.65 TFLOP of bf16 tensor-core work
// (1.67 ms at 989 TFLOP/s) and tags 0.82 TOP of int8 (0.42 ms); their unique
// bytes (the column panel once) take 0.25 / 0.06 ms.  What the tiling moves
// from L2 instead: each of the 16 row tiles re-reads the column panel
// (12.9 GB for text) and, with 4-CTA clusters, each cluster reads its rows
// tile once per group step (3.2 GB), against 24.6 GB when every CTA
// streamed both tiles for all 64 groups.  So the L2 -> SM traffic, not the
// tensor cores, is expected to bound text and tags.  The coordinate
// metrics are bound by issued instructions: a (row, column) pair of K3 is
// 11 FP32 instructions of chord3 (3 sub, 3 mul, 2 add, and the compare and
// two selects of the running argmin) and 6 of l1 (2 sub, 1 add, 3 for the
// argmin), 3.4 G at the huge-window shape: 0.10 ms at the H100's 33.5 T
// FP32 instructions/s.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNeg = -1e30f;
enum Metric { kDot = 0, kJaccard = 1, kChord = 2, kChord3 = 3, kL1 = 4 };

// ---------------------------------------------------------------------------
// tensor-core kernel (dot, jaccard, chord): TMA ring -> wgmma -> binned max
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;                       // consumer warpgroups, 64 rows each
constexpr int kThreads = (kConsumers + 1) * 128;    // + one producer warpgroup
constexpr int kTileRows = 64 * kConsumers;          // 128
constexpr int kTileSlots = 128;
constexpr int kChunk = 128;                         // feature bytes per stage: one swizzle row
constexpr int kStages = 6;
constexpr int kTileBytes = kTileRows * kChunk;      // 16 KB per operand tile
constexpr int kStageBytes = 2 * kTileBytes;         // rows tile, then column tile
constexpr int kEmptyArrivals = kConsumers * 4;      // one per consumer warp, per cluster CTA
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8 +
                           2 * kTileSlots * (4 + 1);
constexpr int kSplitChoices[3] = {1, 2, 4};         // CTAs per cluster (group ranges)
constexpr int kFeatureAlign = 64;                  // feature bytes the entry point takes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
// true once the barrier's phase of parity `parity` has completed
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}
// Spin until the barrier's phase of parity `parity` completes.  A wait that
// outlasts ~20 s of SM clock traps (a launch error) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > 40000000000LL) __trap();
}
// Arrive on the barrier at the same shared-memory offset in cluster CTA
// `cta`.  Default (CTA-scope release) semantics: the arriving warp only
// signals that its wgmma reads of the stage are complete, so no memory fence
// is needed (a cluster-scope release compiles to MEMBAR.ALL.GPU per arrive).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, uint32_t cta, uint32_t self) {
  if (cta == self) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
  } else {
    asm volatile(
        "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
        "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n"
        ::"r"(bar), "r"(cta) : "memory");
  }
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void consumer_sync() {   // the two consumer warpgroups only
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// the same box into the same offset (and barrier) of every CTA in `mask`
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int c0, int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr, uint32_t cta) {
  float4 v;
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %4, %5;\n"
      "ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [ra];\n}\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr), "r"(cta) : "memory");
  return v;
}
__device__ __forceinline__ uint32_t ld_cluster_u32(uint32_t addr, uint32_t cta) {
  uint32_t v;
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %1, %2;\n"
      "ld.shared::cluster.u32 %0, [ra];\n}\n"
      : "=r"(v) : "r"(addr), "r"(cta) : "memory");
  return v;
}

// wgmma descriptor of a K-major tile in 128-byte-swizzled shared memory
// (rows of 128 bytes, 8-row atoms of 1024 bytes); +2 steps 32 bytes in K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
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
// keep the compiler from touching accumulators across the asynchronous MMA
__device__ __forceinline__ void reg_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void reg_fence(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// One warpgroup MMA over a 32-byte K step: D (64 x 128) (+)= A (64 x 32 B)
// B^T (128 x 32 B), both K-major in 128-byte-swizzled shared memory.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keep (sim, g) in slot e of a thread's accumulator if sim beats it.
__device__ __forceinline__ void take(float& best, uint32_t& packed, int e, float sim,
                                     int g) {
  if (sim > best) {
    best = sim;
    const int sh = (e & 3) * 8;
    packed = (packed & ~(0xFFu << sh)) | (static_cast<uint32_t>(g) << sh);
  }
}

// One cluster of `splits` CTAs owns a 128-row x 128-slot output tile; CTA z
// (the cluster rank, == blockIdx.x) sweeps groups [z, z + 1) * groups /
// splits.  Warpgroups 0-1 consume (64 rows each), warpgroup 2 produces.
// Accumulator element i of a consumer thread (warp w of its warpgroup, lane
// l): row 16 w + l / 4 + 8 ((i >> 1) & 1), slot 8 (i >> 2) + 2 (l & 3) + (i & 1).
template <int METRIC>
__global__ void __launch_bounds__(kThreads, 1)
binned_mma_kernel(const __grid_constant__ CUtensorMap cols_map,
                  const __grid_constant__ CUtensorMap rows_map,
                  const uint8_t* __restrict__ colv, const float* __restrict__ s_r,
                  const float* __restrict__ s_c, float* __restrict__ vals,
                  int8_t* __restrict__ grp, int n, int block, int kbytes, int nbins,
                  int start) {
  using Acc = std::conditional_t<METRIC == kJaccard, int, float>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sbase = smem_u32(base);
  const uint32_t full0 = sbase + kStages * kStageBytes, empty0 = full0 + kStages * 8;
  float* sc_s = reinterpret_cast<float*>(base + kStages * kStageBytes + 2 * kStages * 8);
  uint8_t* cs_s = reinterpret_cast<uint8_t*>(sc_s + 2 * kTileSlots);

  const int splits = static_cast<int>(gridDim.x);
  const uint32_t rank = cluster_rank();
  const int gper = n / nbins / splits, g_begin = static_cast<int>(rank) * gper;
  const int nk = (kbytes + kChunk - 1) / kChunk;
  const int steps = gper * nk;
  const int slot0 = blockIdx.y * kTileSlots, row0 = blockIdx.z * kTileRows;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kEmptyArrivals * splits);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();   // every CTA's barriers exist before any multicast or remote arrive

  if (wg == kConsumers) {
    // producer: one thread keeps the ring full.  The rows tile is shared by
    // the cluster: each CTA loads 128 / splits of its rows into every CTA.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      const int slice = kTileRows / splits;
      const uint16_t mask = static_cast<uint16_t>((1u << splits) - 1u);
      for (int t = 0; t < steps; ++t) {
        const int s = t % kStages;
        const uint32_t round = static_cast<uint32_t>(t / kStages);
        mbar_wait(empty0 + 8 * s, (round & 1u) ^ 1u);
        const uint32_t full = full0 + 8 * s, a = sbase + s * kStageBytes;
        mbar_expect_tx(full, kStageBytes);
        const int g = g_begin + t / nk, kc = (t % nk) * kChunk;
        tma_load(a + kTileBytes, &cols_map, full, kc, g * nbins + slot0);
        if (splits == 1)
          tma_load(a, &rows_map, full, kc, row0);
        else
          tma_load_multicast(a + rank * slice * kChunk, &rows_map, full, kc,
                             row0 + static_cast<int>(rank) * slice, mask);
      }
    }
    __syncwarp();
    cluster_sync();   // partials written
    cluster_sync();   // partials merged
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int w = tid >> 5, l = tid & 31, ct = threadIdx.x;   // ct: 0..255 over consumers
  float sr[2];
  int grow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wg * 64 + 16 * w + (l >> 2) + 8 * h;
    grow[h] = start + r;
    sr[h] = (METRIC != kDot && r < block) ? s_r[r] : 0.f;
  }
  float best[64];
  uint32_t bg[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) best[i] = kNeg;
#pragma unroll
  for (int i = 0; i < 16; ++i) bg[i] = 0u;
  Acc acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  const uint32_t a_off = wg * 64 * kChunk;   // this warpgroup's 64 rows of the rows tile

  auto release = [&](int t) {   // this warp is done reading stage t % kStages
    if (l == 0)
      for (int c = 0; c < splits; ++c)
        mbar_arrive_remote(empty0 + 8 * (t % kStages), static_cast<uint32_t>(c), rank);
  };

  int t = 0;
  for (int gl = 0; gl < gper; ++gl) {
    const int g = g_begin + gl, buf = gl & 1;
    if (ct < kTileSlots) {   // this group's column statistics, read after consumer_sync
      const int slot = slot0 + ct;
      cs_s[buf * kTileSlots + ct] = slot < nbins ? colv[g * nbins + slot] : 0;
    } else if (METRIC != kDot) {
      const int j = ct - kTileSlots, slot = slot0 + j;
      sc_s[buf * kTileSlots + j] = slot < nbins ? s_c[g * nbins + slot] : 0.f;
    }
    for (int kc = 0; kc < nk; ++kc, ++t) {
      const int s = t % kStages;
      mbar_wait(full0 + 8 * s, static_cast<uint32_t>(t / kStages) & 1u);
      const uint32_t a = sbase + s * kStageBytes;
      const uint64_t da = sw128_desc(a + a_off), db = sw128_desc(a + kTileBytes);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kChunk / 32; ++k) {
        if constexpr (METRIC == kJaccard)
          wgmma_s8(acc, da + 2 * k, db + 2 * k, (kc | k) != 0);
        else
          wgmma_bf16(acc, da + 2 * k, db + 2 * k, (kc | k) != 0);
      }
      wgmma_commit();
      if (kc + 1 < nk) {
        wgmma_wait<1>();   // the previous stage's products are done
        if (kc > 0) release(t - 1);
      } else {
        wgmma_wait<0>();
        if (kc > 0) release(t - 1);
        release(t);
      }
    }
    reg_fence(acc);
    consumer_sync();

    // epilogue: metric, mask, max-accumulate (each element has one owner)
    const uint8_t* cs = cs_s + buf * kTileSlots;
    const float* sc = sc_s + buf * kTileSlots;
    const int colbase = g * nbins + slot0;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int h = (i >> 1) & 1;
      const int cidx = 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
      float sim;
      if constexpr (METRIC == kDot) {
        sim = acc[i];
      } else if constexpr (METRIC == kJaccard) {
        // 0 / max(uni, 1e-9) is exactly +0: most tag pairs share no token,
        // so the division runs only where the intersection is not empty
        sim = 0.f;
        if (acc[i] != 0) {
          const float inter = static_cast<float>(acc[i]);
          const float uni = __fsub_rn(__fadd_rn(sr[h], sc[cidx]), inter);
          sim = __fdiv_rn(inter, fmaxf(uni, 1e-9f));
        }
      } else {   // chord: -max(s_r + s_c - 2 dot, 0)
        const float d2 = __fsub_rn(__fadd_rn(sr[h], sc[cidx]),
                                   __fmul_rn(2.f, static_cast<float>(acc[i])));
        sim = -fmaxf(d2, 0.f);
      }
      if (cs[cidx] == 0 || grow[h] == colbase + cidx) sim = kNeg;
      take(best[i], bg[i >> 2], i, sim, g);
    }
  }

  // merge the cluster's partials in rank order (strict >: the lowest group
  // range keeps a tie).  The ring is idle: every load was consumed.
  float* part_v = reinterpret_cast<float*>(base);                  // [128][128]
  uint8_t* part_g = base + kTileRows * kTileSlots * 4;              // [128][128]
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int row = wg * 64 + 16 * w + (l >> 2) + 8 * ((i >> 1) & 1);
    const int cidx = 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
    part_v[row * kTileSlots + cidx] = best[i];
    part_g[row * kTileSlots + cidx] = static_cast<uint8_t>((bg[i >> 2] >> (8 * (i & 3))) & 0xFFu);
  }
  cluster_sync();
  const int rows_per = kTileRows / splits;
  constexpr int kQuads = kTileSlots / 4;
  for (int q = ct; q < rows_per * kQuads; q += kConsumers * 128) {
    const int row = static_cast<int>(rank) * rows_per + q / kQuads;
    const int s4 = (q % kQuads) * 4;
    const uint32_t off_v = sbase + static_cast<uint32_t>(row * kTileSlots + s4) * 4u;
    const uint32_t off_g = sbase + kTileRows * kTileSlots * 4 + row * kTileSlots + s4;
    float bv[4];
    uint32_t gv = 0u;
    for (int z = 0; z < splits; ++z) {
      const float4 v = ld_cluster_f4(off_v, static_cast<uint32_t>(z));
      const uint32_t gz = ld_cluster_u32(off_g, static_cast<uint32_t>(z));
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (z == 0 || vv[j] > bv[j]) {
          bv[j] = vv[j];
          gv = (gv & ~(0xFFu << (8 * j))) | (gz & (0xFFu << (8 * j)));
        }
    }
    const int r = row0 + row;
    if (r < block) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int slot = slot0 + s4 + j;
        if (slot < nbins) {
          const size_t o = static_cast<size_t>(r) * nbins + slot;
          vals[o] = bv[j];
          grp[o] = static_cast<int8_t>((gv >> (8 * j)) & 0xFFu);
        }
      }
    }
  }
  cluster_sync();   // peers are done reading this CTA's partials
}

// ---------------------------------------------------------------------------
// coordinate kernel (chord3, l1; one metric, or a pair sharing the sweep)
// ---------------------------------------------------------------------------

constexpr int kCoordThreads = 128;
constexpr int kCoordSlots = 2;       // slots per thread, kCoordThreads apart
constexpr int kCoordRows = 16;       // rows per CTA; every thread sweeps all of them
constexpr float kFar = 1e30f;        // -kNeg: the running best distance starts here

template <int METRIC>
__host__ __device__ constexpr int coords() { return METRIC == kChord3 ? 3 : 2; }

// Distance of a coordinate metric, sim = -dist, in the plain version's
// unfused order (coordinate 0, 1, 2).  The plain version starts from
// acc = 0: 0 + x == x for the first term, which is >= +0 or NaN, so the
// add is dropped.  |.| is an operand modifier of the add.
template <int METRIC>
__device__ __forceinline__ float coord_dist(const float4& a, const float (&b)[3]) {
  if (METRIC == kChord3) {
    const float d0 = __fsub_rn(a.x, b[0]), d1 = __fsub_rn(a.y, b[1]), d2 = __fsub_rn(a.z, b[2]);
    return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
  }
  return __fadd_rn(fabsf(__fsub_rn(a.x, b[0])), fabsf(__fsub_rn(a.y, b[1])));
}

struct CoordOperand {
  const float* cols;     // (n, d) f32
  const float* rows;     // (block, d) f32
  const uint8_t* colv;   // (n,) bool
  int d;
  float* vals;           // (block, nbins)
  int8_t* grp;
};

// Column col's coordinates, +inf where the column is invalid or absent:
// every distance to it is then +inf or NaN, which never beats the running
// best (strict <), exactly as the plain version's -1e30 mask never beats its
// running max.  So invalid columns need no test in the pair loop.
template <int METRIC>
__device__ __forceinline__ void load_col(const CoordOperand& op, int col, bool in,
                                         float (&c)[3]) {
  float v[3] = {0.f, 0.f, 0.f};
  bool ok = false;
  if (in) {
#pragma unroll
    for (int k = 0; k < coords<METRIC>(); ++k) v[k] = op.cols[static_cast<size_t>(col) * op.d + k];
    ok = op.colv[col] != 0;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = ok ? v[k] : __int_as_float(0x7f800000);   // +inf
}

__device__ __forceinline__ float4 load_row(const CoordOperand& op, int r, int ncoords) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = op.rows + static_cast<size_t>(r) * op.d;
  x.x = p[0];
  x.y = p[1];
  if (ncoords == 3) x.z = p[2];
  return x;
}

// MB < 0: a single metric (K2); otherwise the pair (K3).  A thread owns
// kCoordSlots slots and the CTA's kCoordRows rows, and keeps the running
// minimum distance and its group per (row, slot, metric) in registers; the
// rows' coordinates are read from shared memory (one broadcast load per row
// and metric serves both slots), the columns' are loaded one group ahead
// into registers (each column is read by one thread only, so staging it in
// shared memory would add a store and a load per coordinate and reuse
// nothing).  Groups run in ascending order with strict <, so the lowest
// group wins a tie, as the plain version's first argmax.
template <int MA, int MB>
__global__ void __launch_bounds__(kCoordThreads)
binned_coord_kernel(CoordOperand A, CoordOperand B, int n, int block, int nbins,
                    int start) {
  constexpr bool kPair = MB >= 0;
  constexpr int kMB = kPair ? MB : MA;
  __shared__ float4 ra[kCoordRows], rb[kCoordRows];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kCoordRows;
  if (tid < kCoordRows) {
    const bool live = row0 + tid < block;
    ra[tid] = live ? load_row(A, row0 + tid, coords<MA>()) : make_float4(0.f, 0.f, 0.f, 0.f);
    if (kPair)
      rb[tid] = live ? load_row(B, row0 + tid, coords<kMB>()) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  int slot[kCoordSlots];
  bool in[kCoordSlots];
#pragma unroll
  for (int j = 0; j < kCoordSlots; ++j) {
    slot[j] = (blockIdx.x * kCoordSlots + j) * kCoordThreads + tid;
    in[j] = slot[j] < nbins;
  }
  if (!in[0]) return;

  float best_a[kCoordRows][kCoordSlots], best_b[kCoordRows][kCoordSlots];
  int g_a[kCoordRows][kCoordSlots], g_b[kCoordRows][kCoordSlots];
#pragma unroll
  for (int r = 0; r < kCoordRows; ++r)
#pragma unroll
    for (int j = 0; j < kCoordSlots; ++j) {
      best_a[r][j] = best_b[r][j] = kFar;
      g_a[r][j] = g_b[r][j] = 0;
    }
  const int groups = n / nbins;
  // Only the groups holding columns start + row0 .. start + row0 + 15 can
  // hold a row's own column: the self test runs for those (warp-uniform).
  const int self_lo = (start + row0) / nbins;
  const int self_hi = (start + row0 + kCoordRows - 1) / nbins;

  float ca[kCoordSlots][3], cb[kCoordSlots][3];
#pragma unroll
  for (int j = 0; j < kCoordSlots; ++j) {
    load_col<MA>(A, slot[j], in[j], ca[j]);
    if (kPair) load_col<kMB>(B, slot[j], in[j], cb[j]);
  }

  auto sweep = [&](int g, auto self_tag) {
    constexpr bool kSelf = decltype(self_tag)::value;
#pragma unroll
    for (int r = 0; r < kCoordRows; ++r) {
      const float4 xa = ra[r];
      float4 xb;
      if (kPair) xb = rb[r];
#pragma unroll
      for (int j = 0; j < kCoordSlots; ++j) {
        bool live = true;   // not the row's own column (shared by the pair)
        if constexpr (kSelf) live = start + row0 + r != g * nbins + slot[j];
        const float da = coord_dist<MA>(xa, ca[j]);
        if (live && da < best_a[r][j]) {
          best_a[r][j] = da;
          g_a[r][j] = g;
        }
        if constexpr (kPair) {
          const float db = coord_dist<kMB>(xb, cb[j]);
          if (live && db < best_b[r][j]) {
            best_b[r][j] = db;
            g_b[r][j] = g;
          }
        }
      }
    }
  };

  for (int g = 0; g < groups; ++g) {
    float na[kCoordSlots][3], nb[kCoordSlots][3];
    const bool more = g + 1 < groups;
#pragma unroll
    for (int j = 0; j < kCoordSlots; ++j) {
      load_col<MA>(A, (g + 1) * nbins + slot[j], more && in[j], na[j]);
      if (kPair) load_col<kMB>(B, (g + 1) * nbins + slot[j], more && in[j], nb[j]);
    }
    if (g == self_lo || g == self_hi) sweep(g, std::true_type{});
    else sweep(g, std::false_type{});
#pragma unroll
    for (int j = 0; j < kCoordSlots; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        ca[j][k] = na[j][k];
        if (kPair) cb[j][k] = nb[j][k];
      }
  }

  // sim = -dist: negation is exact, so the values are the plain version's bits
#pragma unroll
  for (int r = 0; r < kCoordRows; ++r) {
    if (row0 + r >= block) break;
#pragma unroll
    for (int j = 0; j < kCoordSlots; ++j) {
      if (!in[j]) continue;
      const size_t o = static_cast<size_t>(row0 + r) * nbins + slot[j];
      A.vals[o] = -best_a[r][j];
      A.grp[o] = static_cast<int8_t>(g_a[r][j]);
      if (kPair) {
        B.vals[o] = -best_b[r][j];
        B.grp[o] = static_cast<int8_t>(g_b[r][j]);
      }
    }
  }
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, fetched through the runtime (no -lcuda).
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A (rows, kbytes) row-major byte panel as 128-byte x box_rows TMA boxes,
// 128-byte swizzled, zero-filled past every edge.
bool byte_panel_map(CUtensorMap* map, const void* ptr, int rows, int kbytes, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kbytes), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kbytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kChunk), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int METRIC>
cudaError_t set_smem_attribute() {
  static const cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&binned_mma_kernel<METRIC>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  return e;
}

template <int METRIC>
cudaLaunchConfig_t mma_config(int splits, int slot_tiles, int row_tiles, cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, slot_tiles, row_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Group-range splits (the cluster size) for `tiles` output tiles over
// `groups` groups: the fewest waves x groups per CTA, ties to more splits
// (the rows tile is then fetched once for more CTAs).
template <int METRIC>
int choose_splits(int tiles, int groups) {
  static int active[3] = {-1, -1, -1};   // co-resident clusters per choice
  if (set_smem_attribute<METRIC>() != cudaSuccess) return 1;
  int best = 1;
  long long best_cost = -1;
  for (int c = 0; c < 3; ++c) {
    const int splits = kSplitChoices[c];
    if (groups % splits) continue;
    if (active[c] < 0) {
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = mma_config<METRIC>(splits, 1, 1, nullptr, &attr);
      int num = 0;
      active[c] = cudaOccupancyMaxActiveClusters(
                      &num, reinterpret_cast<const void*>(&binned_mma_kernel<METRIC>), &cfg) ==
                          cudaSuccess ? num : 0;
      cudaGetLastError();   // a refused query leaves no error behind
    }
    if (active[c] <= 0) continue;
    const long long cost =
        static_cast<long long>((tiles + active[c] - 1) / active[c]) * (groups / splits);
    if (best_cost < 0 || cost <= best_cost) {
      best_cost = cost;
      best = splits;
    }
  }
  return best;
}

template <int METRIC>
int mma_splits(int n, int block, int nbins) {
  return choose_splits<METRIC>(((nbins + kTileSlots - 1) / kTileSlots) *
                                   ((block + kTileRows - 1) / kTileRows),
                               n / nbins);
}

template <int METRIC>
cudaError_t launch_mma(const void* cols, const void* rows, const void* colv,
                       const float* s_r, const float* s_c, float* vals, int8_t* grp,
                       int n, int block, int kbytes, int nbins, int start,
                       cudaStream_t stream) {
  cudaError_t e = set_smem_attribute<METRIC>();
  if (e != cudaSuccess) return e;
  const int slot_tiles = (nbins + kTileSlots - 1) / kTileSlots;
  const int row_tiles = (block + kTileRows - 1) / kTileRows;
  const int splits = mma_splits<METRIC>(n, block, nbins);
  CUtensorMap cols_map, rows_map;
  if (!byte_panel_map(&cols_map, cols, n, kbytes, kTileSlots) ||
      !byte_panel_map(&rows_map, rows, block, kbytes, kTileRows / splits))
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = mma_config<METRIC>(splits, slot_tiles, row_tiles, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, binned_mma_kernel<METRIC>, cols_map, rows_map,
                         static_cast<const uint8_t*>(colv), s_r, s_c, vals, grp, n, block,
                         kbytes, nbins, start);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int MA, int MB>
cudaError_t launch_coord(const CoordOperand& a, const CoordOperand& b, int n, int block,
                         int nbins, int start, cudaStream_t stream) {
  const dim3 grid((nbins + kCoordThreads * kCoordSlots - 1) / (kCoordThreads * kCoordSlots),
                  (block + kCoordRows - 1) / kCoordRows);
  binned_coord_kernel<MA, MB><<<grid, kCoordThreads, 0, stream>>>(a, b, n, block, nbins,
                                                                  start);
  return cudaGetLastError();
}

bool shape_ok(int n, int block, int nbins) {
  return n > 0 && block > 0 && nbins > 0 && n % nbins == 0 && n / nbins <= 127;
}

}  // namespace

extern "C" {

// K2.  cols (n, k) and rows (block, k): bf16 for dot / chord, int8 for
// jaccard (k * bytes a multiple of 64, rows 16-byte aligned), f32 for chord3
// (k >= 3) / l1 (k >= 2).  colv (n,) bytes 0/1; s_r (block,) and s_c (n,)
// f32 statistics for jaccard / chord.  vals (block, nbins) f32, grp (block,
// nbins) int8.  Returns cudaGetLastError() after the launch.
int mused_binned_candidates(const void* cols, const void* rows, const void* colv,
                            const void* s_r, const void* s_c, void* vals, void* grp,
                            int n, int block, int k, int nbins, int start, int metric,
                            void* stream) {
  if (!shape_ok(n, block, nbins) || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sr = static_cast<const float*>(s_r);
  const float* sc = static_cast<const float*>(s_c);
  float* v = static_cast<float*>(vals);
  int8_t* gp = static_cast<int8_t*>(grp);
  const CoordOperand a{static_cast<const float*>(cols), static_cast<const float*>(rows),
                       static_cast<const uint8_t*>(colv), k, v, gp};
  switch (metric) {
    case kDot:
      if ((k * 2) % kFeatureAlign) break;
      return static_cast<int>(
          launch_mma<kDot>(cols, rows, colv, sr, sc, v, gp, n, block, k * 2, nbins, start, s));
    case kJaccard:
      if (k % kFeatureAlign) break;
      return static_cast<int>(
          launch_mma<kJaccard>(cols, rows, colv, sr, sc, v, gp, n, block, k, nbins, start, s));
    case kChord:
      if ((k * 2) % kFeatureAlign) break;
      return static_cast<int>(
          launch_mma<kChord>(cols, rows, colv, sr, sc, v, gp, n, block, k * 2, nbins, start, s));
    case kChord3:
      if (k < 3) break;
      return static_cast<int>(launch_coord<kChord3, -1>(a, a, n, block, nbins, start, s));
    case kL1:
      if (k < 2) break;
      return static_cast<int>(launch_coord<kL1, -1>(a, a, n, block, nbins, start, s));
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Group-range splits (CTAs per cluster) K2 takes for a tensor-core metric at
// this shape (1 for the coordinate metrics).
int mused_binned_candidates_splits(int n, int block, int nbins, int metric) {
  if (!shape_ok(n, block, nbins)) return 0;
  switch (metric) {
    case kDot: return mma_splits<kDot>(n, block, nbins);
    case kJaccard: return mma_splits<kJaccard>(n, block, nbins);
    case kChord: return mma_splits<kChord>(n, block, nbins);
    default: return 1;
  }
}

// K3: two coordinate metrics (chord3 / l1) over the same rows in one launch.
int mused_binned_candidates_pair(const void* cols_a, const void* rows_a, const void* colv_a,
                                 int k_a, int metric_a, const void* cols_b,
                                 const void* rows_b, const void* colv_b, int k_b,
                                 int metric_b, void* vals_a, void* grp_a, void* vals_b,
                                 void* grp_b, int n, int block, int nbins, int start,
                                 void* stream) {
  if (!shape_ok(n, block, nbins)) return static_cast<int>(cudaErrorInvalidValue);
  const CoordOperand a{static_cast<const float*>(cols_a), static_cast<const float*>(rows_a),
                       static_cast<const uint8_t*>(colv_a), k_a,
                       static_cast<float*>(vals_a), static_cast<int8_t*>(grp_a)};
  const CoordOperand b{static_cast<const float*>(cols_b), static_cast<const float*>(rows_b),
                       static_cast<const uint8_t*>(colv_b), k_b,
                       static_cast<float*>(vals_b), static_cast<int8_t*>(grp_b)};
  const bool a3 = metric_a == kChord3, b3 = metric_b == kChord3;
  if ((metric_a != kChord3 && metric_a != kL1) || (metric_b != kChord3 && metric_b != kL1) ||
      k_a < (a3 ? 3 : 2) || k_b < (b3 ? 3 : 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a3 && b3) return static_cast<int>(launch_coord<kChord3, kChord3>(a, b, n, block, nbins, start, s));
  if (a3) return static_cast<int>(launch_coord<kChord3, kL1>(a, b, n, block, nbins, start, s));
  if (b3) return static_cast<int>(launch_coord<kL1, kChord3>(a, b, n, block, nbins, start, s));
  return static_cast<int>(launch_coord<kL1, kL1>(a, b, n, block, nbins, start, s));
}

}  // extern "C"
