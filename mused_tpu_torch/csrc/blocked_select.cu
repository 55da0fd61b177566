// Stride-binned kNN candidates for one row block of a huge window: similarity
// tile -> mask -> max-accumulate into nbins residue bins, keeping the winning
// group id.  The (block, n) similarity strip never reaches device memory.
// Beside them, the union kernel writes a rebuilt row block of the fused
// adjacency from the kept candidates in one pass (its own section below).
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
//     each of its outputs is bit-identical to a K2 launch;
//   * K3 on two tensor-core metrics (the column-sharded sweep pairs tags
//     jaccard with text dot; embedding streams pair dot with dot) is one
//     launch of K2's tile program with twice the row tiles: blockIdx.z picks
//     the half, so each output is bit-identical to its K2 launch and the
//     pair fills the card with twice the CTAs of one K2 launch.  A mixed
//     pair (one tensor-core and one coordinate metric, generic streams
//     only) runs a simple CUDA-core kernel, right first and not fast;
//   * the row side is given whole: rows (block, K) and their statistics
//     s_r (block,) need not be a slice of the column panel, and `start` (the
//     rows' global index, read only by the self-column test) may be negative
//     or past n, as it is for a row block that lives on another column
//     shard;
//   * the postings route (dot on text, jaccard on tags, whose rows hold 1-5
//     nonzeros of 4096 / 2048 features): the caller hands the column
//     panel's postings (each feature's columns in ascending order with
//     their values, and a table of each feature's first entry at every
//     128-column step).  A CTA owns one row and walks all groups in steps of
//     whole groups (up to 8192 columns): its 8 warps split the step's
//     columns, each adding the row's nonzero features' postings into an f32
//     accumulator in shared memory, one feature after another in ascending
//     order (__syncwarp between them, no atomics: the same bits on every
//     launch; a bf16 or int8 product is exact, so each step rounds once).
//     Then every thread folds its two-slot pairs with K2's epilogue (the
//     self column cleared in the staged validity, jaccard's divisions only
//     where tokens meet, in a second pass that batches their s_c loads).
//     Pairs that share no feature keep similarity 0 and fill the bins they
//     win, since the epilogue visits every pair.  A CTA owns whole groups,
//     so there are no partials to merge.  K3's pair is one launch of the same
//     per-row program, grid z picking the half.  Its work is the dense pass
//     over n columns per row plus one multiply-add per postings entry that
//     the row's features meet (text on the synthetic stream: 166 M per
//     2048-row block, 0.83 n per row; tags 3.7 M).  The worst case is rows
//     of many common features: up to the token cap of 96 features, each in
//     every column, 96 n entries per row, added one at a time on CUDA cores
//     where the tensor-core route's work is fixed.  From this kernel's rate
//     on the synthetic stream (an estimate, not measured at that density),
//     past about 20 n entries per row the tensor-core route is faster.  The
//     rows' terms are read from the dense rows (128 at a time in shared
//     memory; a longer row re-reads them per step).
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
// FP32 instructions/s.  The postings route, counted on the nonzeros: 2
// operations per postings entry met (0.33 G for text's block, 5 us at the
// 67 TFLOP/s f32 rate) and the bytes of the rows, the postings and table rows
// of the features met, the statistics and the outputs (about 35 MB, 0.01
// ms); what holds it back is latency: per row 12-13 steps, each waiting on
// L2 for the table and entries and on two barriers, and the dense epilogue's
// 2 x n shared-memory accesses per row.
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

// One metric's operands on the tensor-core route: column validity, the
// hoisted statistics (s_r the rows', s_c the columns'; unread for dot), the
// outputs, and the feature width in bytes.
struct MmaHalf {
  const uint8_t* colv;
  const float* s_r;
  const float* s_c;
  float* vals;
  int8_t* grp;
  int kbytes;
};

// One cluster of `splits` CTAs owns a 128-row x 128-slot output tile; CTA z
// (the cluster rank, == blockIdx.x) sweeps groups [z, z + 1) * groups /
// splits.  Warpgroups 0-1 consume (64 rows each), warpgroup 2 produces.
// Accumulator element i of a consumer thread (warp w of its warpgroup, lane
// l): row 16 w + l / 4 + 8 ((i >> 1) & 1), slot 8 (i >> 2) + 2 (l & 3) + (i & 1).
// `start` is the global index of row 0, used only by the self-column test:
// any value (negative, or past n) is taken, so a row block from another
// column shard compares against this shard's columns as it should.
template <int METRIC>
__device__ __forceinline__ void mma_tile(const CUtensorMap* cols_map, const CUtensorMap* rows_map,
                                         const MmaHalf& op, int n, int block, int nbins,
                                         int start, int row_tile) {
  using Acc = std::conditional_t<METRIC == kJaccard, int, float>;
  const uint8_t* __restrict__ colv = op.colv;
  const float* __restrict__ s_r = op.s_r;
  const float* __restrict__ s_c = op.s_c;
  float* __restrict__ vals = op.vals;
  int8_t* __restrict__ grp = op.grp;
  const int kbytes = op.kbytes;
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
  const int slot0 = blockIdx.y * kTileSlots, row0 = row_tile * kTileRows;
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
        tma_load(a + kTileBytes, cols_map, full, kc, g * nbins + slot0);
        if (splits == 1)
          tma_load(a, rows_map, full, kc, row0);
        else
          tma_load_multicast(a + rank * slice * kChunk, rows_map, full, kc,
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
      wgmma_wait<1>();     // the previous stage's products are done
      if (kc > 0) release(t - 1);
    }
    // One unconditional wait for the group's last products, so no use of the
    // accumulators can precede it on any path: ptxas then injects no wait of
    // its own, which inside K3's per-half branch would serialize every wgmma.
    wgmma_wait<0>();
    release(t - 1);
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

// K2 on the tensor cores: grid (splits, slot tiles, row tiles).
template <int METRIC>
__global__ void __launch_bounds__(kThreads, 1)
binned_mma_kernel(const __grid_constant__ CUtensorMap cols_map,
                  const __grid_constant__ CUtensorMap rows_map,
                  const __grid_constant__ MmaHalf op, int n,
                  int block, int nbins, int start) {
  mma_tile<METRIC>(&cols_map, &rows_map, op, n, block, nbins, start,
                   static_cast<int>(blockIdx.z));
}

// K3 on two tensor-core metrics: grid (splits, slot tiles, 2 x row tiles);
// blockIdx.z < row_tiles runs half A, the rest half B, each with K2's tile
// program above, so each output is bit-equal to its K2 launch.  The metric
// of a half is a runtime value (one kernel for the nine pairs); every CTA of
// a cluster shares its blockIdx.z, so a cluster never mixes the halves.
__global__ void __launch_bounds__(kThreads, 1)
binned_mma_pair_kernel(const __grid_constant__ CUtensorMap cols_a,
                       const __grid_constant__ CUtensorMap rows_a,
                       const __grid_constant__ CUtensorMap cols_b,
                       const __grid_constant__ CUtensorMap rows_b,
                       const __grid_constant__ MmaHalf a,
                       const __grid_constant__ MmaHalf b, int metric_a, int metric_b,
                       int n, int block, int nbins, int start, int row_tiles) {
  const int z = static_cast<int>(blockIdx.z);
  const bool second = z >= row_tiles;
  const CUtensorMap* cols = second ? &cols_b : &cols_a;
  const CUtensorMap* rows = second ? &rows_b : &rows_a;
  const MmaHalf& op = second ? b : a;
  const int metric = second ? metric_b : metric_a, tile = second ? z - row_tiles : z;
  if (metric == kJaccard)
    mma_tile<kJaccard>(cols, rows, op, n, block, nbins, start, tile);
  else if (metric == kChord)
    mma_tile<kChord>(cols, rows, op, n, block, nbins, start, tile);
  else
    mma_tile<kDot>(cols, rows, op, n, block, nbins, start, tile);
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

__device__ __forceinline__ int floor_div(int a, int b) {   // b > 0
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

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
  // Floor division: a shard-local start may be negative, and the range may
  // lie wholly outside [0, groups), where no group runs the test.
  const int self_lo = floor_div(start + row0, nbins);
  const int self_hi = floor_div(start + row0 + kCoordRows - 1, nbins);

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
    if (g >= self_lo && g <= self_hi) sweep(g, std::true_type{});
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

// ---------------------------------------------------------------------------
// simple kernel (K3 on a mixed pair: one tensor-core metric, one coordinate)
// ---------------------------------------------------------------------------

constexpr int kSimpleThreads = 128;   // one slot per thread
constexpr int kSimpleRows = 8;        // rows per CTA
constexpr int kSimpleChunk = 32;      // features of the rows staged per step

struct SimpleHalf {
  const void* cols;      // (n, k): bf16 (dot / chord), int8 (jaccard), f32 (chord3 / l1)
  const void* rows;      // (block, k), the same type
  const uint8_t* colv;   // (n,) bytes 0/1
  const float* s_r;      // (block,) jaccard / chord row statistics
  const float* s_c;      // (n,) their column statistics
  float* vals;
  int8_t* grp;
  int k;
  int metric;
};

__device__ __forceinline__ float bf16_at(const void* p, size_t i) {   // exact widening
  return __uint_as_float(static_cast<uint32_t>(static_cast<const uint16_t*>(p)[i]) << 16);
}

// One launch for both halves of a pair that mixes the routes (grid z picks
// the half).  A thread owns one slot and the CTA's kSimpleRows rows and walks
// the groups in ascending order with strict >, as K2 does; the products are
// plain loops over the features (rows staged in shared memory).  Coordinate
// metrics and jaccard (integer counts) are bit-equal to the plain version;
// dot and chord sum in f32 in feature order, within the plain version's
// rounding.  Only generic numeric streams form such pairs: this kernel is
// right first, not fast.
__global__ void __launch_bounds__(kSimpleThreads)
binned_simple_kernel(const __grid_constant__ SimpleHalf a,
                     const __grid_constant__ SimpleHalf b, int n, int block, int nbins,
                     int start) {
  const SimpleHalf& h = blockIdx.z ? b : a;
  __shared__ float rf[kSimpleRows][kSimpleChunk];
  __shared__ int ri[kSimpleRows][kSimpleChunk];
  const int tid = threadIdx.x;
  const int slot = blockIdx.x * kSimpleThreads + tid;
  const int row0 = blockIdx.y * kSimpleRows;
  const bool in = slot < nbins;
  const bool coord = h.metric == kChord3 || h.metric == kL1;
  const bool stats = h.metric == kJaccard || h.metric == kChord;
  const int groups = n / nbins;
  float best[kSimpleRows], sr[kSimpleRows];
  int bg[kSimpleRows];
  float4 xr[kSimpleRows];
#pragma unroll
  for (int r = 0; r < kSimpleRows; ++r) {
    const bool live = row0 + r < block;
    best[r] = kNeg;
    bg[r] = 0;
    sr[r] = stats && live ? h.s_r[row0 + r] : 0.f;
    xr[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (coord && live) {
      const float* p = static_cast<const float*>(h.rows) + static_cast<size_t>(row0 + r) * h.k;
      xr[r].x = p[0];
      xr[r].y = p[1];
      if (h.metric == kChord3) xr[r].z = p[2];
    }
  }
  for (int g = 0; g < groups; ++g) {
    const int col = g * nbins + slot;
    float sim[kSimpleRows];
    if (coord) {
      if (in) {
        const float* p = static_cast<const float*>(h.cols) + static_cast<size_t>(col) * h.k;
        const float c[3] = {p[0], p[1], h.metric == kChord3 ? p[2] : 0.f};
#pragma unroll
        for (int r = 0; r < kSimpleRows; ++r)
          sim[r] = -(h.metric == kChord3 ? coord_dist<kChord3>(xr[r], c)
                                         : coord_dist<kL1>(xr[r], c));
      }
    } else {
      float accf[kSimpleRows];
      int acci[kSimpleRows];
#pragma unroll
      for (int r = 0; r < kSimpleRows; ++r) {
        accf[r] = 0.f;
        acci[r] = 0;
      }
      for (int k0 = 0; k0 < h.k; k0 += kSimpleChunk) {
        __syncthreads();   // the previous chunk is consumed
        for (int e = tid; e < kSimpleRows * kSimpleChunk; e += kSimpleThreads) {
          const int r = e / kSimpleChunk, kk = e % kSimpleChunk;
          const bool ok = row0 + r < block && k0 + kk < h.k;
          const size_t i = static_cast<size_t>(row0 + r) * h.k + k0 + kk;
          if (h.metric == kJaccard)
            ri[r][kk] = ok ? static_cast<const int8_t*>(h.rows)[i] : 0;
          else
            rf[r][kk] = ok ? bf16_at(h.rows, i) : 0.f;
        }
        __syncthreads();
        if (!in) continue;
        const int kend = min(kSimpleChunk, h.k - k0);
        const size_t c0 = static_cast<size_t>(col) * h.k + k0;
        for (int kk = 0; kk < kend; ++kk) {
          if (h.metric == kJaccard) {
            const int cv = static_cast<const int8_t*>(h.cols)[c0 + kk];
#pragma unroll
            for (int r = 0; r < kSimpleRows; ++r) acci[r] += ri[r][kk] * cv;
          } else {
            const float cv = bf16_at(h.cols, c0 + kk);
#pragma unroll
            for (int r = 0; r < kSimpleRows; ++r) accf[r] = fmaf(rf[r][kk], cv, accf[r]);
          }
        }
      }
      if (in) {
        const float sc = stats ? h.s_c[col] : 0.f;
#pragma unroll
        for (int r = 0; r < kSimpleRows; ++r) {
          if (h.metric == kDot) {
            sim[r] = accf[r];
          } else if (h.metric == kJaccard) {   // as K2's epilogue
            sim[r] = 0.f;
            if (acci[r] != 0) {
              const float inter = static_cast<float>(acci[r]);
              const float uni = __fsub_rn(__fadd_rn(sr[r], sc), inter);
              sim[r] = __fdiv_rn(inter, fmaxf(uni, 1e-9f));
            }
          } else {
            const float d2 = __fsub_rn(__fadd_rn(sr[r], sc), __fmul_rn(2.f, accf[r]));
            sim[r] = -fmaxf(d2, 0.f);
          }
        }
      }
    }
    if (!in || h.colv[col] == 0) continue;
#pragma unroll
    for (int r = 0; r < kSimpleRows; ++r)
      if (start + row0 + r != col && sim[r] > best[r]) {
        best[r] = sim[r];
        bg[r] = g;
      }
  }
  if (!in) return;
#pragma unroll
  for (int r = 0; r < kSimpleRows; ++r) {
    if (row0 + r >= block) break;
    const size_t o = static_cast<size_t>(row0 + r) * nbins + slot;
    h.vals[o] = best[r];
    h.grp[o] = static_cast<int8_t>(bg[r]);
  }
}

// ---------------------------------------------------------------------------
// postings kernel (dot on text, jaccard on tags: panels of a few nonzeros)
// ---------------------------------------------------------------------------

constexpr int kPostThreads = 256;
constexpr int kPostWarps = kPostThreads / 32;
constexpr int kPostUnit = 128;          // columns per step of the postings table
constexpr int kPostTerms = 128;         // a row's terms held in shared memory at once
constexpr int kPostStepCols = 8192;     // accumulator columns per step (whole groups)
constexpr int kPostMaxBins = 16384;
constexpr int kPostMisc = 16;           // ints: the warps' counts, the resume feature
constexpr int kPostAhead = 8;           // row tiles loaded ahead by the term extraction
constexpr int kPostChunk = 4;           // entries in flight per lane while adding a term
constexpr int kPostStageWords = kPostStepCols / 4 / kPostThreads;   // validity words a thread stages

// One half of the postings route: the dense row block (the row side), the
// column panel's postings (table (k, units + 1): the first entry of feature t
// at a column >= u * 128; cols / vals: the entries by feature, then column),
// column validity, the hoisted statistics (jaccard) and the outputs.
struct PostHalf {
  const void* rows;        // (block, k): bf16 for dot, int8 for jaccard
  const int* table;
  const int* pcols;
  const void* pvals;       // the panel's type
  const uint8_t* colv;
  const float* s_r;
  const float* s_c;
  float* vals;
  int8_t* grp;
  int k;
  int metric;
};

template <int METRIC>
using PostElem = std::conditional_t<METRIC == kJaccard, int8_t, uint16_t>;

__device__ __forceinline__ float post_value(uint16_t bits) {   // bf16 -> f32, exact
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}
__device__ __forceinline__ float post_value(int8_t v) { return static_cast<float>(v); }

size_t post_smem_bytes(int nbins) {
  const int gstep = nbins >= kPostStepCols ? 1 : kPostStepCols / nbins;
  return static_cast<size_t>(nbins) * 4 + static_cast<size_t>(gstep) * nbins * 4 +
         kPostTerms * 8 + kPostMisc * 4 + ((nbins + 15) / 16) * 16 +
         ((static_cast<size_t>(gstep) * nbins + 15) / 16) * 16 +
         static_cast<size_t>(gstep) * ((nbins + 511) / 512) * kPostThreads * 2;   // the list
}

// The row's nonzero features at or after f0, in ascending order, into
// term_f / term_v (at most kPostTerms); `next` is the first nonzero feature
// left out (k when none).  Block-wide: every thread calls it.
template <int METRIC>
__device__ void post_extract(const PostElem<METRIC>* row, int k, int f0, int* term_f,
                             float* term_v, int* misc, int& nt, int& next) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();                      // the previous list is consumed
  if (tid == 0) misc[kPostWarps] = k;
  __syncthreads();
  // a rolling window of kPostAhead tiles' loads in flight
  float ahead[kPostAhead];
#pragma unroll
  for (int j = 0; j < kPostAhead; ++j) {
    const int f = f0 + j * kPostThreads + tid;
    ahead[j] = f < k ? post_value(row[f]) : 0.f;
  }
  int total = 0;
  for (int t0 = f0; t0 < k; t0 += kPostThreads) {
    const int f = t0 + tid;
    const float v = ahead[0];
#pragma unroll
    for (int j = 0; j + 1 < kPostAhead; ++j) ahead[j] = ahead[j + 1];
    const int fa = f + kPostAhead * kPostThreads;
    ahead[kPostAhead - 1] = fa < k ? post_value(row[fa]) : 0.f;
    const bool nz = v != 0.f;
    const unsigned m = __ballot_sync(0xFFFFFFFFu, nz);
    if (lane == 0) misc[warp] = __popc(m);
    __syncthreads();
    int pos = total + __popc(m & ((1u << lane) - 1u)), tile = 0;
#pragma unroll
    for (int w = 0; w < kPostWarps; ++w) {
      const int c = misc[w];
      if (w < warp) pos += c;
      tile += c;
    }
    if (nz && pos < kPostTerms) {
      term_f[pos] = f;
      term_v[pos] = v;
    } else if (nz && pos == kPostTerms) {
      misc[kPostWarps] = f;
    }
    total += tile;
    __syncthreads();                    // misc[0 .. warps) is rewritten by the next tile
    if (total > kPostTerms) break;
  }
  nt = min(total, kPostTerms);
  next = misc[kPostWarps];
}

// kPostChunk entries of a term for one lane (e, e + 32, ...), as column
// offsets and values; c = -1 past the term's end.  All loads are issued
// before any is used, so a lane keeps kPostChunk in flight.
struct PostChunk {
  int c[kPostChunk];
  float p[kPostChunk];
};

template <int METRIC>
__device__ __forceinline__ PostChunk post_load(const int* __restrict__ pcols,
                                               const PostElem<METRIC>* __restrict__ pvals,
                                               int e, int e_end, int cbase) {
  PostChunk q;
#pragma unroll
  for (int u = 0; u < kPostChunk; ++u) {
    const int i = e + 32 * u;
    q.c[u] = i < e_end ? pcols[i] - cbase : -1;
    q.p[u] = i < e_end ? post_value(pvals[i]) : 0.f;
  }
  return q;
}

__device__ __forceinline__ void post_add(float* acc, const PostChunk& q, float rv) {
#pragma unroll
  for (int u = 0; u < kPostChunk; ++u)
    if (q.c[u] >= 0) acc[q.c[u]] = fmaf(rv, q.p[u], acc[q.c[u]]);
}

// Lane l's term (i0 + l) of the list: its entries in table steps [ua, ub).
__device__ __forceinline__ void post_range(const PostHalf& h, const int* term_f, int nt, int i0,
                                           int ua, int ub, int units, int& lo, int& hi) {
  const int i = i0 + (threadIdx.x & 31);
  if (i < nt) {
    const int* tr = h.table + static_cast<size_t>(term_f[i]) * (units + 1);
    lo = tr[ua];
    hi = tr[ub];
  }
}

// One warp adds the row's terms over its column range, whole table steps
// [ua, ub): per term the entries lo..hi of the table, kPostChunk per lane at a
// time, into the f32 accumulator (column c at acc[c - cbase]).  Terms go in
// ascending order with __syncwarp between them: a term's entries hold
// distinct columns, so no two lanes touch one address at once, and every
// (row, column) sum runs in the same order on every launch.  A product of
// two bf16 (or int8) values is exact in f32, so fmaf rounds once, as
// acc + r * v does.  The chunks of consecutive terms form one stream, each
// loaded before the one ahead of it is added; the first 32 terms' table
// entries (lo0, hi0) come loaded, a step ahead.
template <int METRIC>
__device__ void post_accumulate(const PostHalf& h, const int* term_f, const float* term_v,
                                int nt, int ua, int ub, int units, int cbase, float* acc,
                                int lo0, int hi0) {
  const int lane = threadIdx.x & 31;
  const int* __restrict__ pcols = h.pcols;
  const PostElem<METRIC>* __restrict__ pvals = static_cast<const PostElem<METRIC>*>(h.pvals);
  for (int i0 = 0; i0 < nt; i0 += 32) {
    int lo = lo0, hi = hi0;   // the first 32 terms' entries come loaded (lane = term)
    if (i0 > 0) {
      lo = hi = 0;
      post_range(h, term_f, nt, i0, ua, ub, units, lo, hi);
    }
    const int m = min(32, nt - i0);
    int j = 0, base = __shfl_sync(0xFFFFFFFFu, lo, 0), end = __shfl_sync(0xFFFFFFFFu, hi, 0);
    PostChunk cur = post_load<METRIC>(pcols, pvals, base + lane, end, cbase);
    for (;;) {   // base, end and j are warp-uniform
      int jn = j, bn = base + 32 * kPostChunk, en = end;
      if (bn >= end && ++jn < m) {            // this term is done: the next one's first chunk
        bn = __shfl_sync(0xFFFFFFFFu, lo, jn);
        en = __shfl_sync(0xFFFFFFFFu, hi, jn);
      }
      const bool more = jn < m;
      const PostChunk next = post_load<METRIC>(pcols, pvals, bn + lane, more ? en : 0, cbase);
      post_add(acc, cur, term_v[i0 + j]);
      if (!more) break;
      if (jn != j) __syncwarp();              // a term's adds land before the next term's
      j = jn;
      base = bn;
      end = en;
      cur = next;
    }
    __syncwarp();
  }
}

// A CTA owns one row of the block and walks every group in ascending order,
// a step of whole groups (up to kPostStepCols columns) at a time: its warps
// split the step's table steps, add the row's terms into the step's f32
// accumulator, then every thread folds its slots' columns into the running
// (value, group) best with K2's epilogue (the -1e30 mask, the self column,
// jaccard from the hoisted statistics, strict > in ascending groups).  A row
// of more than kPostTerms nonzero features takes its terms in windows of
// kPostTerms, in order, re-read per step.
template <int METRIC>
__device__ void post_row(const PostHalf& h, int n, int nbins, int start, int r,
                         uint8_t* smem) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const int groups = n / nbins, units = n / kPostUnit, gunits = nbins / kPostUnit;
  const int gstep = nbins >= kPostStepCols ? 1 : kPostStepCols / nbins;
  float* best = reinterpret_cast<float*>(smem);
  float* acc = best + nbins;
  int* term_f = reinterpret_cast<int*>(acc + static_cast<size_t>(gstep) * nbins);
  float* term_v = reinterpret_cast<float*>(term_f + kPostTerms);
  int* misc = reinterpret_cast<int*>(term_v + kPostTerms);
  uint8_t* bgrp = reinterpret_cast<uint8_t*>(misc + kPostMisc);
  uint8_t* cv_s = bgrp + ((nbins + 15) / 16) * 16;   // the step's column validity
  // jaccard's listed pairs: per thread, up to its (nbins / 512 rounded up) x
  // gstep float2 pairs of the step whose tokens meet, at stride kPostThreads
  uint16_t* plist = reinterpret_cast<uint16_t*>(cv_s + ((gstep * nbins + 15) / 16) * 16);
  const uint8_t* __restrict__ colv = h.colv;
  const float* __restrict__ s_c = h.s_c;

  for (int x = tid; x < nbins; x += kPostThreads) {
    best[x] = kNeg;
    bgrp[x] = 0;
  }
  for (int x = tid; x < gstep * nbins; x += kPostThreads) acc[x] = 0.f;
  const PostElem<METRIC>* row =
      static_cast<const PostElem<METRIC>*>(h.rows) + static_cast<size_t>(r) * h.k;
  const float sr = METRIC == kJaccard ? h.s_r[r] : 0.f;
  const int grow = start + r;

  int nt = 0, next = h.k;
  post_extract<METRIC>(row, h.k, 0, term_f, term_v, misc, nt, next);
  const bool whole = next >= h.k;       // the row's terms all fit: read once
  // this warp's share of a step's table steps
  auto range = [&](int gfirst, int& lo_step, int& hi_step) {
    const int u0 = gfirst * gunits, us = (min(groups, gfirst + gstep) - gfirst) * gunits;
    lo_step = u0 + us * warp / kPostWarps;
    hi_step = u0 + us * (warp + 1) / kPostWarps;
  };
  int ua, ub, lo = 0, hi = 0;
  range(0, ua, ub);
  if (whole) post_range(h, term_f, nt, 0, ua, ub, units, lo, hi);
  const bool words = (reinterpret_cast<uintptr_t>(colv) & 3u) == 0;

  for (int g0 = 0; g0 < groups; g0 += gstep) {
    const int g1 = min(groups, g0 + gstep);
    const int cbase = g0 * nbins, ncols = (g1 - g0) * nbins;
    range(g0, ua, ub);
    // the next step's table entries, loaded while this step runs
    int lo_n = 0, hi_n = 0;
    if (whole && g1 < groups) {
      int ua_n, ub_n;
      range(g1, ua_n, ub_n);
      post_range(h, term_f, nt, 0, ua_n, ub_n, units, lo_n, hi_n);
    }
    // the step's column validity, the row's own column cleared, staged in
    // shared memory for the epilogue: loaded into registers here, stored
    // after the accumulation, so the loads overlap it (the last step's
    // readers passed the barrier that ended it)
    const int self = grow - cbase;
    uint32_t cvw[kPostStageWords];
    const bool in_regs = words && ncols <= kPostStepCols;
    if (in_regs) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(colv + cbase);
#pragma unroll
      for (int j = 0; j < kPostStageWords; ++j) {
        const int w = tid + j * kPostThreads;
        cvw[j] = w < ncols / 4 ? src[w] : 0u;
      }
    } else {
      for (int x = tid; x < ncols; x += kPostThreads)
        cv_s[x] = x == self ? 0 : colv[cbase + x];
    }
    for (int f = 0;;) {
      if (!whole) {
        post_extract<METRIC>(row, h.k, f, term_f, term_v, misc, nt, next);
        lo = hi = 0;
        post_range(h, term_f, nt, 0, ua, ub, units, lo, hi);
      }
      if (ua < ub)
        post_accumulate<METRIC>(h, term_f, term_v, nt, ua, ub, units, cbase, acc, lo, hi);
      if (whole || next >= h.k) break;
      f = next;
    }
    if (in_regs) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(cv_s);
#pragma unroll
      for (int j = 0; j < kPostStageWords; ++j) {
        const int w = tid + j * kPostThreads;
        if (w < ncols / 4)
          dst[w] = w == (self >> 2) && self >= 0 ? cvw[j] & ~(0xFFu << (8 * (self & 3))) : cvw[j];
      }
    }
    __syncthreads();
    // epilogue, two slots per thread: each slot is one thread's for the whole
    // row, so best needs no sync.  Jaccard in two passes: the pairs whose
    // tokens meet (acc != 0) wait in this thread's list, so the warp loads
    // their column sums s_c once, after the zero pairs are folded; their
    // similarities are never 0, so the order of the passes changes no bin,
    // and each slot's listed pairs keep ascending groups.
    int listed = 0;
    for (int x = 2 * tid; x < nbins; x += 2 * kPostThreads) {
      float2 b = *reinterpret_cast<const float2*>(best + x);
      const uint32_t bg2 = *reinterpret_cast<const uint16_t*>(bgrp + x);
      int bg0 = static_cast<int>(bg2 & 0xFFu), bg1 = static_cast<int>(bg2 >> 8);
      for (int g = g0; g < g1; ++g) {
        const int ai = (g - g0) * nbins + x;
        const float2 a = *reinterpret_cast<const float2*>(acc + ai);
        const uint32_t v = *reinterpret_cast<const uint16_t*>(cv_s + ai);
        float s0 = a.x, s1 = a.y;
        if constexpr (METRIC == kJaccard) {
          if (a.x != 0.f || a.y != 0.f) {
            plist[listed++ * kPostThreads + tid] = static_cast<uint16_t>(ai);
            s0 = a.x != 0.f ? kNeg : 0.f;   // the listed halves wait for pass two
            s1 = a.y != 0.f ? kNeg : 0.f;
          } else {
            *reinterpret_cast<float2*>(acc + ai) = make_float2(0.f, 0.f);
          }
        } else {
          *reinterpret_cast<float2*>(acc + ai) = make_float2(0.f, 0.f);
        }
        if ((v & 0xFFu) == 0) s0 = kNeg;
        if ((v >> 8) == 0) s1 = kNeg;
        if (s0 > b.x) {
          b.x = s0;
          bg0 = g;
        }
        if (s1 > b.y) {
          b.y = s1;
          bg1 = g;
        }
      }
      *reinterpret_cast<float2*>(best + x) = b;
      *reinterpret_cast<uint16_t*>(bgrp + x) = static_cast<uint16_t>(bg0 | (bg1 << 8));
    }
    if constexpr (METRIC == kJaccard) {   // pass two: inter / (s_r + s_c - inter)
      for (int i0 = 0; i0 < listed; i0 += 4) {
        int ai4[4];
        float2 sc4[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {     // four pairs' column sums in flight
          ai4[u] = plist[min(i0 + u, listed - 1) * kPostThreads + tid];
          const int c = cbase + ai4[u];
          sc4[u] = make_float2(s_c[c], s_c[c + 1]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (i0 + u >= listed) break;
          const int ai = ai4[u];
          const int g = g0 + ai / nbins, x = ai - (g - g0) * nbins;
          const float2 a = *reinterpret_cast<const float2*>(acc + ai);
          *reinterpret_cast<float2*>(acc + ai) = make_float2(0.f, 0.f);
          const uint32_t v = *reinterpret_cast<const uint16_t*>(cv_s + ai);
          float2 b = *reinterpret_cast<const float2*>(best + x);
          const uint32_t bg2 = *reinterpret_cast<const uint16_t*>(bgrp + x);
          int bg0 = static_cast<int>(bg2 & 0xFFu), bg1 = static_cast<int>(bg2 >> 8);
          if (a.x != 0.f && (v & 0xFFu) != 0) {
            const float s0 =
                __fdiv_rn(a.x, fmaxf(__fsub_rn(__fadd_rn(sr, sc4[u].x), a.x), 1e-9f));
            if (s0 > b.x) {
              b.x = s0;
              bg0 = g;
            }
          }
          if (a.y != 0.f && (v >> 8) != 0) {
            const float s1 =
                __fdiv_rn(a.y, fmaxf(__fsub_rn(__fadd_rn(sr, sc4[u].y), a.y), 1e-9f));
            if (s1 > b.y) {
              b.y = s1;
              bg1 = g;
            }
          }
          *reinterpret_cast<float2*>(best + x) = b;
          *reinterpret_cast<uint16_t*>(bgrp + x) = static_cast<uint16_t>(bg0 | (bg1 << 8));
        }
      }
    }
    __syncthreads();
    lo = lo_n;
    hi = hi_n;
  }
  for (int x = tid; x < nbins; x += kPostThreads) {
    const size_t o = static_cast<size_t>(r) * nbins + x;
    h.vals[o] = best[x];
    h.grp[o] = static_cast<int8_t>(bgrp[x]);
  }
}

// K2 (grid z = 1) and K3 (grid z = 2: z picks the half) on the postings
// route: grid (block rows, 1, halves), so each K3 output is its K2 launch's.
__global__ void __launch_bounds__(kPostThreads, 4)
binned_postings_kernel(const __grid_constant__ PostHalf a, const __grid_constant__ PostHalf b,
                       int n, int nbins, int start) {
  extern __shared__ __align__(16) uint8_t post_smem[];
  const PostHalf& h = blockIdx.z ? b : a;
  const int r = static_cast<int>(blockIdx.x);
  if (h.metric == kJaccard)
    post_row<kJaccard>(h, n, nbins, start, r, post_smem);
  else
    post_row<kDot>(h, n, nbins, start, r, post_smem);
}

cudaError_t launch_postings(const PostHalf& a, const PostHalf& b, int halves, int n, int block,
                            int nbins, int start, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      binned_postings_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(post_smem_bytes(kPostMaxBins)));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(block, 1, halves);
  binned_postings_kernel<<<grid, kPostThreads, post_smem_bytes(nbins), stream>>>(a, b, n, nbins,
                                                                               start);
  return cudaGetLastError();
}

bool postings_shape_ok(int n, int block, int nbins, int metric, int k) {
  return n > 0 && block > 0 && k > 0 && n % kPostUnit == 0 && nbins % kPostUnit == 0 &&
         nbins <= kPostMaxBins && n % nbins == 0 && n / nbins <= 127 &&
         (metric == kDot || metric == kJaccard);
}

// ---------------------------------------------------------------------------
// the fused row block: candidate slabs + username equality, written once
// ---------------------------------------------------------------------------
//
// Element (r, c = g * nbins + s) of rows [start, start+block) is
//   OR_m (slab_m[r, s] == g) | (uid_rows[r] == uid_cols[g, s] & start + r != (g0 + g) * nbins + s)
// (cand_matvec.dense_rows_reference), stored as 0 / 1 in bool, bf16 or f32.
// A warp owns kUnionRows rows of 512 consecutive slots; each thread keeps
// its 16 slots' slab bytes in registers, so each slab byte is read once,
// then walks the groups: per group it reads its slots' uid_cols (from L2:
// groups x nbins int32, 0.6 MB) and writes its rows' 16 columns with 16-byte
// stores.  A thread's 16 slots are units of one store each (16 bool, 8 bf16
// or 4 f32 slots), the warp's lanes side by side in every unit, so each
// store instruction of a warp writes 512 consecutive bytes.  The slab test
// takes four slots per instruction (__vcmpeq4 against g in every byte; -1
// is no group id).  The stores stream past L2 (st.global.cs), which keeps
// the slabs and uid_cols there.  Bounded by the bytes written: 2048 x
// 151,552 f32 is 1.24 GB, 0.37 ms at 3.35 TB/s (0.24 ms at n = 98,304); the
// slabs and uids read add 3%.  No (block, n) intermediate exists.

constexpr int kUnionWords = 4;                          // 4 slots each: 16 slots per thread
constexpr int kUnionWarpSlots = 32 * 4 * kUnionWords;   // 512 consecutive slots per warp
constexpr int kUnionRows = 2;                           // rows per thread
constexpr int kUnionThreads = 256;
constexpr int kUnionMaxPlanes = 8;                      // slab planes held in registers
enum UnionOut { kUnionBool = 0, kUnionBf16 = 1, kUnionF32 = 2 };

struct UnionArgs {
  const uint8_t* slabs;   // (planes, block, nbins) int8 group ids, -1 where none
  const int* uid_rows;    // (block,), or null: no username term
  const int* uid_cols;    // (groups, nbins)
  uint8_t* out;           // (block, groups * nbins)
  int planes, block, nbins, groups, start, g0;
  bool vec;               // nbins % 16 == 0 and 16-byte aligned pointers
};

template <int OUT>
__host__ __device__ constexpr int union_bytes() {
  return OUT == kUnionBool ? 1 : (OUT == kUnionBf16 ? 2 : 4);
}

// Slot offset of word q (4 slots) of a lane in its warp's 512 slots: units
// of 16 / bytes slots, a unit of every lane side by side.
template <int OUT>
__device__ __forceinline__ int union_word_slot(int q, int lane) {
  constexpr int kUnit = 16 / union_bytes<OUT>();   // slots per 16-byte store
  constexpr int kWordsPerUnit = kUnit / 4;
  return (q / kWordsPerUnit) * 32 * kUnit + lane * kUnit + (q % kWordsPerUnit) * 4;
}

// One 16-byte store of unit k from the byte masks (0xFF or 0 per slot): 1 is
// bool 0x01, bf16 0x3F80, f32 0x3F800000.
template <int OUT>
__device__ __forceinline__ uint4 union_unit(const uint32_t (&w)[kUnionWords], int k) {
  if constexpr (OUT == kUnionBool) {
    return make_uint4(w[0] & 0x01010101u, w[1] & 0x01010101u, w[2] & 0x01010101u,
                      w[3] & 0x01010101u);
  } else if constexpr (OUT == kUnionBf16) {
    const uint32_t a = w[2 * k], b = w[2 * k + 1];
    return make_uint4(__byte_perm(a, 0, 0x1100) & 0x3F803F80u,
                      __byte_perm(a, 0, 0x3322) & 0x3F803F80u,
                      __byte_perm(b, 0, 0x1100) & 0x3F803F80u,
                      __byte_perm(b, 0, 0x3322) & 0x3F803F80u);
  } else {
    const uint32_t a = w[k];
    return make_uint4(__byte_perm(a, 0, 0x0000) & 0x3F800000u,
                      __byte_perm(a, 0, 0x1111) & 0x3F800000u,
                      __byte_perm(a, 0, 0x2222) & 0x3F800000u,
                      __byte_perm(a, 0, 0x3333) & 0x3F800000u);
  }
}

template <int M, int OUT>
__global__ void __launch_bounds__(kUnionThreads) union_rowblock_kernel(
    const __grid_constant__ UnionArgs a) {
  constexpr int kBytes = union_bytes<OUT>();
  constexpr int kUnits = kUnionWords * 4 * kBytes / 16;
  const int lane = threadIdx.x & 31;
  const int chunks = (a.nbins + kUnionWarpSlots - 1) / kUnionWarpSlots;
  const long long warp = (static_cast<long long>(blockIdx.x) * kUnionThreads + threadIdx.x) >> 5;
  const int r0 = static_cast<int>(warp / chunks) * kUnionRows;
  if (r0 >= a.block) return;
  const int base = static_cast<int>(warp % chunks) * kUnionWarpSlots;
  const int n = a.groups * a.nbins;
  const bool user = a.uid_rows != nullptr;
  int slot[kUnionWords];      // each word's first slot; a word lies wholly in or past nbins
#pragma unroll
  for (int q = 0; q < kUnionWords; ++q) slot[q] = base + union_word_slot<OUT>(q, lane);
  uint32_t slab[M][kUnionRows][kUnionWords];
  int urow[kUnionRows], self_g[kUnionRows], self_q[kUnionRows], self_b[kUnionRows];
#pragma unroll
  for (int rr = 0; rr < kUnionRows; ++rr) {
    const int r = r0 + rr;
    const bool live = r < a.block;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const bool held = live && m < a.planes;   // planes past a.planes hold no group
      const uint8_t* src = a.slabs + (static_cast<size_t>(m) * a.block + r) * a.nbins;
#pragma unroll
      for (int q = 0; q < kUnionWords; ++q) {
        uint32_t word = 0xFFFFFFFFu;   // -1 in every slot: no group
        if (held && a.vec) {
          if (slot[q] < a.nbins) word = __ldg(reinterpret_cast<const uint32_t*>(src + slot[q]));
        } else if (held) {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (slot[q] + b < a.nbins)
              word = (word & ~(0xFFu << (8 * b))) |
                     (static_cast<uint32_t>(src[slot[q] + b]) << (8 * b));
        }
        slab[m][rr][q] = word;
      }
    }
    urow[rr] = live && user ? a.uid_rows[r] : 0;
    // the row's own column, local to this shard's groups: (group, word, byte)
    const int own = a.start + r - a.g0 * a.nbins;
    const bool inside = live && own >= 0 && own < n;
    self_g[rr] = inside ? own / a.nbins : -1;
    self_q[rr] = -1;
    self_b[rr] = 0;
#pragma unroll
    for (int q = 0; q < kUnionWords; ++q) {
      const int d = own - self_g[rr] * a.nbins - slot[q];
      if (inside && d >= 0 && d < 4) {
        self_q[rr] = q;
        self_b[rr] = d;
      }
    }
  }
  for (int g = 0; g < a.groups; ++g) {
    const uint32_t gg = 0x01010101u * static_cast<uint32_t>(g);
    int uc[kUnionWords][4];
    if (user) {
      const int* src = a.uid_cols + static_cast<size_t>(g) * a.nbins;
#pragma unroll
      for (int q = 0; q < kUnionWords; ++q) {
        if (a.vec) {
          const int4 v = slot[q] < a.nbins ? __ldg(reinterpret_cast<const int4*>(src + slot[q]))
                                           : make_int4(0, 0, 0, 0);
          uc[q][0] = v.x;
          uc[q][1] = v.y;
          uc[q][2] = v.z;
          uc[q][3] = v.w;
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b) uc[q][b] = slot[q] + b < a.nbins ? src[slot[q] + b] : 0;
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kUnionRows; ++rr) {
      const int r = r0 + rr;
      if (r >= a.block) break;
      uint32_t w[kUnionWords];
#pragma unroll
      for (int q = 0; q < kUnionWords; ++q) {
        uint32_t x = 0;
#pragma unroll
        for (int m = 0; m < M; ++m) x |= __vcmpeq4(slab[m][rr][q], gg);
        if (user) {
          uint32_t u = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (uc[q][b] == urow[rr]) u |= 0xFFu << (8 * b);
          if (g == self_g[rr] && q == self_q[rr])   // not the row's own column
            u &= ~(0xFFu << (8 * self_b[rr]));
          x |= u;
        }
        w[q] = x;
      }
      uint8_t* row = a.out + (static_cast<size_t>(r) * n + static_cast<size_t>(g) * a.nbins) *
                                 kBytes;
      if (a.vec) {
#pragma unroll
        for (int k = 0; k < kUnits; ++k) {
          const int s = slot[k * kUnionWords / kUnits];   // the unit's first slot
          if (s < a.nbins)
            __stcs(reinterpret_cast<uint4*>(row + static_cast<size_t>(s) * kBytes),
                   union_unit<OUT>(w, k));
        }
      } else {
#pragma unroll
        for (int q = 0; q < kUnionWords; ++q) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int s = slot[q] + b;
            if (s >= a.nbins) continue;
            const bool on = (w[q] >> (8 * b)) & 1u;
            if constexpr (OUT == kUnionBool)
              row[s] = on;
            else if constexpr (OUT == kUnionBf16)
              reinterpret_cast<uint16_t*>(row)[s] = on ? 0x3F80u : 0u;
            else
              reinterpret_cast<uint32_t*>(row)[s] = on ? 0x3F800000u : 0u;
          }
        }
      }
    }
  }
}

template <int M>
cudaError_t launch_union_planes(const UnionArgs& a, int out, dim3 grid, cudaStream_t s) {
  if (out == kUnionBool)
    union_rowblock_kernel<M, kUnionBool><<<grid, kUnionThreads, 0, s>>>(a);
  else if (out == kUnionBf16)
    union_rowblock_kernel<M, kUnionBf16><<<grid, kUnionThreads, 0, s>>>(a);
  else
    union_rowblock_kernel<M, kUnionF32><<<grid, kUnionThreads, 0, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_union(const UnionArgs& a, int out, cudaStream_t s) {
  const long long warps = static_cast<long long>((a.block + kUnionRows - 1) / kUnionRows) *
                          ((a.nbins + kUnionWarpSlots - 1) / kUnionWarpSlots);
  const dim3 grid(static_cast<unsigned>((32 * warps + kUnionThreads - 1) / kUnionThreads));
  // planes rounded up to 1, 2, 4 or 8 held in registers: the extra hold no group
  if (a.planes <= 2) return a.planes == 1 ? launch_union_planes<1>(a, out, grid, s)
                                          : launch_union_planes<2>(a, out, grid, s);
  return a.planes <= 4 ? launch_union_planes<4>(a, out, grid, s)
                       : launch_union_planes<8>(a, out, grid, s);
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

// A tensor-core kernel (K2 for one metric, or the K3 pair) with its dynamic
// shared-memory attribute set once and its co-resident clusters per split
// choice, asked once.
struct MmaKernel {
  const void* fn;
  cudaError_t smem;
  int active[3];
};

MmaKernel make_mma_kernel(const void* fn) {
  MmaKernel k{fn, cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kSmemBytes), {-1, -1, -1}};
  return k;
}

template <int METRIC>
MmaKernel& mma_single() {
  static MmaKernel k = make_mma_kernel(reinterpret_cast<const void*>(&binned_mma_kernel<METRIC>));
  return k;
}

MmaKernel& mma_pair() {
  static MmaKernel k = make_mma_kernel(reinterpret_cast<const void*>(&binned_mma_pair_kernel));
  return k;
}

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
// (the rows tile is then fetched once for more CTAs).  Splits change no
// value: the partials merge in group order with strict >.
int choose_splits(MmaKernel& k, int tiles, int groups) {
  if (k.smem != cudaSuccess) return 1;
  int best = 1;
  long long best_cost = -1;
  for (int c = 0; c < 3; ++c) {
    const int splits = kSplitChoices[c];
    if (groups % splits) continue;
    if (k.active[c] < 0) {
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = mma_config(splits, 1, 1, nullptr, &attr);
      int num = 0;
      k.active[c] = cudaOccupancyMaxActiveClusters(&num, k.fn, &cfg) == cudaSuccess ? num : 0;
      cudaGetLastError();   // a refused query leaves no error behind
    }
    if (k.active[c] <= 0) continue;
    const long long cost =
        static_cast<long long>((tiles + k.active[c] - 1) / k.active[c]) * (groups / splits);
    if (best_cost < 0 || cost <= best_cost) {
      best_cost = cost;
      best = splits;
    }
  }
  return best;
}

int slot_tiles_of(int nbins) { return (nbins + kTileSlots - 1) / kTileSlots; }
int row_tiles_of(int block) { return (block + kTileRows - 1) / kTileRows; }

template <int METRIC>
int mma_splits(int n, int block, int nbins) {
  return choose_splits(mma_single<METRIC>(), slot_tiles_of(nbins) * row_tiles_of(block),
                       n / nbins);
}

int mma_pair_splits(int n, int block, int nbins) {
  return choose_splits(mma_pair(), 2 * slot_tiles_of(nbins) * row_tiles_of(block), n / nbins);
}

template <int METRIC>
cudaError_t launch_mma(const void* cols, const void* rows, const MmaHalf& op, int n, int block,
                       int nbins, int start, cudaStream_t stream) {
  MmaKernel& k = mma_single<METRIC>();
  if (k.smem != cudaSuccess) return k.smem;
  const int splits = mma_splits<METRIC>(n, block, nbins);
  CUtensorMap cols_map, rows_map;
  if (!byte_panel_map(&cols_map, cols, n, op.kbytes, kTileSlots) ||
      !byte_panel_map(&rows_map, rows, block, op.kbytes, kTileRows / splits))
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      mma_config(splits, slot_tiles_of(nbins), row_tiles_of(block), stream, &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, binned_mma_kernel<METRIC>, cols_map, rows_map,
                                           op, n, block, nbins, start);
  return e != cudaSuccess ? e : cudaGetLastError();
}

cudaError_t launch_mma_pair(const void* cols_a, const void* rows_a, const MmaHalf& a,
                            int metric_a, const void* cols_b, const void* rows_b,
                            const MmaHalf& b, int metric_b, int n, int block, int nbins,
                            int start, cudaStream_t stream) {
  MmaKernel& k = mma_pair();
  if (k.smem != cudaSuccess) return k.smem;
  const int splits = mma_pair_splits(n, block, nbins);
  CUtensorMap ca, ra, cb, rb;
  if (!byte_panel_map(&ca, cols_a, n, a.kbytes, kTileSlots) ||
      !byte_panel_map(&ra, rows_a, block, a.kbytes, kTileRows / splits) ||
      !byte_panel_map(&cb, cols_b, n, b.kbytes, kTileSlots) ||
      !byte_panel_map(&rb, rows_b, block, b.kbytes, kTileRows / splits))
    return cudaErrorInvalidValue;
  const int row_tiles = row_tiles_of(block);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      mma_config(splits, slot_tiles_of(nbins), 2 * row_tiles, stream, &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, binned_mma_pair_kernel, ca, ra, cb, rb, a, b,
                                           metric_a, metric_b, n, block, nbins, start,
                                           row_tiles);
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

cudaError_t launch_simple(const SimpleHalf& a, const SimpleHalf& b, int n, int block, int nbins,
                          int start, cudaStream_t stream) {
  const dim3 grid((nbins + kSimpleThreads - 1) / kSimpleThreads,
                  (block + kSimpleRows - 1) / kSimpleRows, 2);
  binned_simple_kernel<<<grid, kSimpleThreads, 0, stream>>>(a, b, n, block, nbins, start);
  return cudaGetLastError();
}

bool shape_ok(int n, int block, int nbins) {
  return n > 0 && block > 0 && nbins > 0 && n % nbins == 0 && n / nbins <= 127;
}

bool is_mma(int metric) { return metric == kDot || metric == kJaccard || metric == kChord; }
bool is_coord(int metric) { return metric == kChord3 || metric == kL1; }
int elem_bytes(int metric) { return metric == kJaccard ? 1 : (is_mma(metric) ? 2 : 4); }

// The operand widths a metric takes: tensor-core panels in whole 64-byte
// steps, coordinate panels with their 3 (chord3) or 2 (l1) coordinates.
bool width_ok(int metric, int k) {
  if (is_mma(metric)) return k > 0 && (k * elem_bytes(metric)) % kFeatureAlign == 0;
  if (is_coord(metric)) return k >= (metric == kChord3 ? 3 : 2);
  return false;
}

cudaError_t launch_coord_pair(const CoordOperand& a, int ma, const CoordOperand& b, int mb,
                              int n, int block, int nbins, int start, cudaStream_t s) {
  const bool a3 = ma == kChord3, b3 = mb == kChord3;
  if (a3 && b3) return launch_coord<kChord3, kChord3>(a, b, n, block, nbins, start, s);
  if (a3) return launch_coord<kChord3, kL1>(a, b, n, block, nbins, start, s);
  if (b3) return launch_coord<kL1, kChord3>(a, b, n, block, nbins, start, s);
  return launch_coord<kL1, kL1>(a, b, n, block, nbins, start, s);
}

cudaError_t launch_mma_metric(int metric, const void* cols, const void* rows, const MmaHalf& op,
                              int n, int block, int nbins, int start, cudaStream_t s) {
  if (metric == kJaccard) return launch_mma<kJaccard>(cols, rows, op, n, block, nbins, start, s);
  if (metric == kChord) return launch_mma<kChord>(cols, rows, op, n, block, nbins, start, s);
  return launch_mma<kDot>(cols, rows, op, n, block, nbins, start, s);
}

}  // namespace

extern "C" {

// K2.  cols (n, k) and rows (block, k): bf16 for dot / chord, int8 for
// jaccard (k * bytes a multiple of 64, rows 16-byte aligned), f32 for chord3
// (k >= 3) / l1 (k >= 2).  colv (n,) bytes 0/1; s_r (block,) and s_c (n,)
// f32 statistics for jaccard / chord.  `start` is the global index of the
// rows' first row, for the self-column test only (any value).  vals (block,
// nbins) f32, grp (block, nbins) int8.  Returns cudaGetLastError() after the
// launch.
int mused_binned_candidates(const void* cols, const void* rows, const void* colv,
                            const void* s_r, const void* s_c, void* vals, void* grp,
                            int n, int block, int k, int nbins, int start, int metric,
                            void* stream) {
  if (!shape_ok(n, block, nbins) || !width_ok(metric, k))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* v = static_cast<float*>(vals);
  int8_t* gp = static_cast<int8_t*>(grp);
  if (is_coord(metric)) {
    const CoordOperand a{static_cast<const float*>(cols), static_cast<const float*>(rows),
                         static_cast<const uint8_t*>(colv), k, v, gp};
    return static_cast<int>(metric == kChord3
                                ? launch_coord<kChord3, -1>(a, a, n, block, nbins, start, s)
                                : launch_coord<kL1, -1>(a, a, n, block, nbins, start, s));
  }
  const MmaHalf op{static_cast<const uint8_t*>(colv), static_cast<const float*>(s_r),
                   static_cast<const float*>(s_c), v, gp, k * elem_bytes(metric)};
  return static_cast<int>(launch_mma_metric(metric, cols, rows, op, n, block, nbins, start, s));
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

// The same for K3 on two tensor-core metrics.
int mused_binned_candidates_pair_splits(int n, int block, int nbins) {
  return shape_ok(n, block, nbins) ? mma_pair_splits(n, block, nbins) : 0;
}

// K3: two metrics over the same rows in one launch, any pair of the five.
// Each half takes K2's operands (cols, rows, colv, s_r, s_c, k, metric) and
// writes K2's outputs.  Two coordinate metrics share the coordinate kernel's
// sweep, two tensor-core metrics run K2's tile program per half, and a mixed
// pair runs the simple kernel.
int mused_binned_candidates_pair(const void* cols_a, const void* rows_a, const void* colv_a,
                                 const void* s_r_a, const void* s_c_a, int k_a, int metric_a,
                                 const void* cols_b, const void* rows_b, const void* colv_b,
                                 const void* s_r_b, const void* s_c_b, int k_b, int metric_b,
                                 void* vals_a, void* grp_a, void* vals_b, void* grp_b, int n,
                                 int block, int nbins, int start, void* stream) {
  if (!shape_ok(n, block, nbins) || !width_ok(metric_a, k_a) || !width_ok(metric_b, k_b))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_coord(metric_a) && is_coord(metric_b)) {
    const CoordOperand a{static_cast<const float*>(cols_a), static_cast<const float*>(rows_a),
                         static_cast<const uint8_t*>(colv_a), k_a,
                         static_cast<float*>(vals_a), static_cast<int8_t*>(grp_a)};
    const CoordOperand b{static_cast<const float*>(cols_b), static_cast<const float*>(rows_b),
                         static_cast<const uint8_t*>(colv_b), k_b,
                         static_cast<float*>(vals_b), static_cast<int8_t*>(grp_b)};
    return static_cast<int>(launch_coord_pair(a, metric_a, b, metric_b, n, block, nbins, start, s));
  }
  if (is_mma(metric_a) && is_mma(metric_b)) {
    const MmaHalf a{static_cast<const uint8_t*>(colv_a), static_cast<const float*>(s_r_a),
                    static_cast<const float*>(s_c_a), static_cast<float*>(vals_a),
                    static_cast<int8_t*>(grp_a), k_a * elem_bytes(metric_a)};
    const MmaHalf b{static_cast<const uint8_t*>(colv_b), static_cast<const float*>(s_r_b),
                    static_cast<const float*>(s_c_b), static_cast<float*>(vals_b),
                    static_cast<int8_t*>(grp_b), k_b * elem_bytes(metric_b)};
    return static_cast<int>(launch_mma_pair(cols_a, rows_a, a, metric_a, cols_b, rows_b, b,
                                            metric_b, n, block, nbins, start, s));
  }
  const SimpleHalf a{cols_a, rows_a, static_cast<const uint8_t*>(colv_a),
                     static_cast<const float*>(s_r_a), static_cast<const float*>(s_c_a),
                     static_cast<float*>(vals_a), static_cast<int8_t*>(grp_a), k_a, metric_a};
  const SimpleHalf b{cols_b, rows_b, static_cast<const uint8_t*>(colv_b),
                     static_cast<const float*>(s_r_b), static_cast<const float*>(s_c_b),
                     static_cast<float*>(vals_b), static_cast<int8_t*>(grp_b), k_b, metric_b};
  return static_cast<int>(launch_simple(a, b, n, block, nbins, start, s));
}

// K2 on the postings route (dot, jaccard): rows (block, k) bf16 / int8, the
// column panel's postings (table (k, n / 128 + 1) int32, cols int32, vals of
// the panel's type), colv (n,) bytes 0/1, s_r (block,) / s_c (n,) f32 for
// jaccard; n and nbins multiples of 128, nbins <= 16384.  Writes K2's
// outputs.  Returns cudaGetLastError() after the launch.
int mused_binned_postings(const void* rows, const void* table, const void* pcols,
                          const void* pvals, const void* colv, const void* s_r, const void* s_c,
                          void* vals, void* grp, int n, int block, int k, int nbins, int start,
                          int metric, void* stream) {
  if (!postings_shape_ok(n, block, nbins, metric, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const PostHalf a{rows, static_cast<const int*>(table), static_cast<const int*>(pcols), pvals,
                   static_cast<const uint8_t*>(colv), static_cast<const float*>(s_r),
                   static_cast<const float*>(s_c), static_cast<float*>(vals),
                   static_cast<int8_t*>(grp), k, metric};
  return static_cast<int>(
      launch_postings(a, a, 1, n, block, nbins, start, static_cast<cudaStream_t>(stream)));
}

// K3 on the postings route: two halves of K2's postings operands over the same
// rows of one n, in one launch; each output equals its K2 launch's.
int mused_binned_postings_pair(const void* rows_a, const void* table_a, const void* pcols_a,
                               const void* pvals_a, const void* colv_a, const void* s_r_a,
                               const void* s_c_a, int k_a, int metric_a, const void* rows_b,
                               const void* table_b, const void* pcols_b, const void* pvals_b,
                               const void* colv_b, const void* s_r_b, const void* s_c_b,
                               int k_b, int metric_b, void* vals_a, void* grp_a, void* vals_b,
                               void* grp_b, int n, int block, int nbins, int start,
                               void* stream) {
  if (!postings_shape_ok(n, block, nbins, metric_a, k_a) ||
      !postings_shape_ok(n, block, nbins, metric_b, k_b))
    return static_cast<int>(cudaErrorInvalidValue);
  const PostHalf a{rows_a, static_cast<const int*>(table_a), static_cast<const int*>(pcols_a),
                   pvals_a, static_cast<const uint8_t*>(colv_a),
                   static_cast<const float*>(s_r_a), static_cast<const float*>(s_c_a),
                   static_cast<float*>(vals_a), static_cast<int8_t*>(grp_a), k_a, metric_a};
  const PostHalf b{rows_b, static_cast<const int*>(table_b), static_cast<const int*>(pcols_b),
                   pvals_b, static_cast<const uint8_t*>(colv_b),
                   static_cast<const float*>(s_r_b), static_cast<const float*>(s_c_b),
                   static_cast<float*>(vals_b), static_cast<int8_t*>(grp_b), k_b, metric_b};
  return static_cast<int>(
      launch_postings(a, b, 2, n, block, nbins, start, static_cast<cudaStream_t>(stream)));
}


// The fused row block (block, groups * nbins) of a candidate block: slabs
// (planes, block, nbins) int8 (group id or -1), uid_rows (block,) int32 or
// null (no username term), uid_cols (groups, nbins) int32; `start` is the
// rows' global index and `g0` the global id of local group 0, both for the
// self test only.  out_dtype: 0 bool, 1 bf16, 2 f32.  Returns
// cudaGetLastError() after the launch.
int mused_union_rowblock(const void* slabs, const void* uid_rows, const void* uid_cols,
                         void* out, int planes, int block, int nbins, int groups, int start,
                         int g0, int out_dtype, void* stream) {
  if (planes < 1 || planes > kUnionMaxPlanes || block <= 0 || nbins <= 0 || groups <= 0 ||
      groups > 127 || out_dtype < kUnionBool || out_dtype > kUnionF32)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = nbins % 16 == 0 && aligned(slabs) && aligned(out) &&
                   (uid_rows == nullptr || aligned(uid_cols));
  const UnionArgs a{static_cast<const uint8_t*>(slabs), static_cast<const int*>(uid_rows),
                    static_cast<const int*>(uid_cols), static_cast<uint8_t*>(out), planes,
                    block, nbins, groups, start, g0, vec};
  return static_cast<int>(launch_union(a, out_dtype, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
