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
//   * a block (CTA) owns an output tile of 128 rows x 128 slots and loops
//     over the groups in ascending order; the (value, group) accumulator of
//     its tile stays in registers across that loop, so the TPU's sequential
//     j carry becomes a loop inside the CTA and needs no atomics;
//   * dot / jaccard / chord run on tensor cores with mma.sync: bf16 x bf16
//     -> f32 (m16n8k16) and s8 x s8 -> s32 (m16n8k32), which compute exactly
//     what the MXU does (exact products, f32 or exact integer sums).  Both
//     panels keep the feature axis contiguous, so every fragment is a 32-bit
//     shared-memory word.  64-byte feature chunks of the row and column tiles
//     are double-buffered with cp.async (zero-filled past the edges);
//   * chord3 and l1 are coordinate metrics with 2-3 features: a CUDA-core
//     kernel where each thread owns one slot and 16 rows, with unfused
//     __fsub_rn / __fmul_rn / __fadd_rn in the JAX package's summation order
//     (acc = 0, then coordinate 0, 1, 2), so values are bit-identical to the
//     plain version.  K3 runs two such metrics in one pass and shares the
//     not-self mask; each of its outputs is bit-identical to a K2 launch.
//
// What bounds it on an H100: at the huge-window shape (n = 98,304,
// block = 2048, nbins = 1536) text is 1.65 TFLOP of bf16 tensor-core work
// and tags 0.82 TOP of int8 per block; the CTA re-reads the column panel
// once per 128-row tile (12.9 GB of L2 traffic for text), and mma.sync
// without wgmma, TMA or a deeper pipeline reaches a fraction of the
// 989 TFLOP/s bf16 peak.  The coordinate metrics read 20 bytes per column
// per 16 rows and are a small share of a block.  wgmma, TMA staging and a
// persistent schedule are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNeg = -1e30f;
enum Metric { kDot = 0, kJaccard = 1, kChord = 2, kChord3 = 3, kL1 = 4 };

// ---------------------------------------------------------------------------
// tensor-core kernel (dot, jaccard, chord)
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;          // 8 warps: 2 (rows) x 4 (slots)
constexpr int kTileRows = 128;
constexpr int kTileSlots = 128;
constexpr int kChunk = 64;             // feature bytes per pipeline stage
constexpr int kRowBytes = 80;          // padded shared row: conflict-free fragments
constexpr int kRowWords = kRowBytes / 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// Accumulator element (i, j, e) of a thread: m-tile i (16 rows), n-tile j
// (8 slots), fragment element e: row gid + 8 * (e >> 1), slot 2 * tig + (e & 1).
template <int METRIC>
__global__ void __launch_bounds__(kThreads, 1)
binned_mma_kernel(const uint8_t* __restrict__ cols, const uint8_t* __restrict__ rows,
                  const uint8_t* __restrict__ colv, const float* __restrict__ s_r,
                  const float* __restrict__ s_c, float* __restrict__ vals,
                  int8_t* __restrict__ grp, int n, int block, int kbytes, int nbins,
                  int start) {
  using Acc = std::conditional_t<METRIC == kJaccard, int, float>;
  __shared__ __align__(16) uint8_t a_s[2][kTileRows * kRowBytes];
  __shared__ __align__(16) uint8_t b_s[2][kTileSlots * kRowBytes];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.y * kTileRows, slot0 = blockIdx.x * kTileSlots;
  const int groups = n / nbins;
  const int nk = kbytes / kChunk;

  float sr[8];   // row statistics of the thread's 8 rows (jaccard / chord)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm * 64 + i * 16 + gid + h * 8;
      sr[i * 2 + h] = (METRIC != kDot && r < block) ? s_r[r] : 0.f;
    }

  float best[64];
  uint32_t bg[16];
#pragma unroll
  for (int e = 0; e < 64; ++e) best[e] = kNeg;
#pragma unroll
  for (int e = 0; e < 16; ++e) bg[e] = 0u;

  for (int g = 0; g < groups; ++g) {
    const size_t col_base = static_cast<size_t>(g) * nbins + slot0;
    Acc acc[16][4];   // [m-tile * 4 + n-tile][fragment element]
#pragma unroll
    for (int t = 0; t < 16; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0;

    auto load = [&](int kc, int stage) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int idx = tid + q * kThreads;   // 512 16-byte pieces per tile
        const int r = idx >> 2, part = (idx & 3) * 16;
        const bool pa = row0 + r < block;
        cp_async16(&a_s[stage][r * kRowBytes + part],
                   pa ? rows + static_cast<size_t>(row0 + r) * kbytes + kc * kChunk + part
                      : rows,
                   pa);
        const bool pb = slot0 + r < nbins;
        cp_async16(&b_s[stage][r * kRowBytes + part],
                   pb ? cols + (col_base + r) * kbytes + kc * kChunk + part : cols, pb);
      }
      cp_async_commit();
    };

    load(0, 0);
    for (int kc = 0; kc < nk; ++kc) {
      if (kc + 1 < nk) {
        load(kc + 1, (kc + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const uint32_t* A = reinterpret_cast<const uint32_t*>(a_s[kc & 1]);
      const uint32_t* B = reinterpret_cast<const uint32_t*>(b_s[kc & 1]);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {      // two k-steps of 32 bytes per chunk
        const int w0 = ks * 8 + tig;
        uint32_t af[4][4], bf[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = wm * 64 + i * 16 + gid;
          af[i][0] = A[r * kRowWords + w0];
          af[i][1] = A[(r + 8) * kRowWords + w0];
          af[i][2] = A[r * kRowWords + w0 + 4];
          af[i][3] = A[(r + 8) * kRowWords + w0 + 4];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = wn * 32 + j * 8 + gid;
          bf[j][0] = B[c * kRowWords + w0];
          bf[j][1] = B[c * kRowWords + w0 + 4];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma(acc[i * 4 + j], af[i], bf[j]);
      }
      __syncthreads();   // this stage is refilled two chunks later
    }

    // epilogue: metric, mask, max-accumulate (each element has one owner)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int slot = slot0 + wn * 32 + j * 8 + tig * 2 + e1;
        if (slot >= nbins) continue;
        const int col = g * nbins + slot;
        const bool col_ok = colv[col] != 0;
        const float sc = METRIC != kDot ? s_c[col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = (i * 4 + j) * 4 + h * 2 + e1;
            const int grow = start + row0 + wm * 64 + i * 16 + gid + h * 8;
            float sim;
            if (METRIC == kDot) {
              sim = acc[i * 4 + j][h * 2 + e1];
            } else if (METRIC == kJaccard) {
              const float inter = static_cast<float>(acc[i * 4 + j][h * 2 + e1]);
              const float uni = __fsub_rn(__fadd_rn(sr[i * 2 + h], sc), inter);
              sim = __fdiv_rn(inter, fmaxf(uni, 1e-9f));
            } else {   // chord: -max(s_r + s_c - 2 dot, 0)
              const float d2 = __fsub_rn(__fadd_rn(sr[i * 2 + h], sc),
                                         __fmul_rn(2.f, static_cast<float>(acc[i * 4 + j][h * 2 + e1])));
              sim = -fmaxf(d2, 0.f);
            }
            if (!col_ok || grow == col) sim = kNeg;
            take(best[e], bg[e >> 2], e, sim, g);
          }
      }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int e = (i * 4 + j) * 4 + h * 2 + e1;
          const int r = row0 + wm * 64 + i * 16 + gid + h * 8;
          const int slot = slot0 + wn * 32 + j * 8 + tig * 2 + e1;
          if (r < block && slot < nbins) {
            const size_t o = static_cast<size_t>(r) * nbins + slot;
            vals[o] = best[e];
            grp[o] = static_cast<int8_t>((bg[e >> 2] >> ((e & 3) * 8)) & 0xFFu);
          }
        }
}

// ---------------------------------------------------------------------------
// coordinate kernel (chord3, l1; one metric, or a pair sharing the sweep)
// ---------------------------------------------------------------------------

constexpr int kCoordThreads = 256;   // one slot per thread
constexpr int kCoordRows = 16;       // rows per thread

template <int METRIC>
__device__ __forceinline__ float coord_sim(const float* a, const float* b) {
  float acc = 0.f;
  if (METRIC == kChord3) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float d = __fsub_rn(a[c], b[c]);
      acc = __fadd_rn(acc, __fmul_rn(d, d));
    }
  } else {
#pragma unroll
    for (int c = 0; c < 2; ++c) acc = __fadd_rn(acc, fabsf(__fsub_rn(a[c], b[c])));
  }
  return -acc;
}

template <int METRIC>
__host__ __device__ constexpr int coords() { return METRIC == kChord3 ? 3 : 2; }

struct CoordOperand {
  const float* cols;     // (n, d) f32
  const float* rows;     // (block, d) f32
  const uint8_t* colv;   // (n,) bool
  int d;
  float* vals;           // (block, nbins)
  int8_t* grp;
};

// MB < 0: a single metric (K2); otherwise the pair (K3).
template <int MA, int MB>
__global__ void __launch_bounds__(kCoordThreads)
binned_coord_kernel(CoordOperand A, CoordOperand B, int n, int block, int nbins,
                    int start) {
  constexpr bool kPair = MB >= 0;
  constexpr int kMB = kPair ? MB : MA;
  __shared__ float ra[kCoordRows][3], rb[kCoordRows][3];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kCoordRows;
  const int slot = blockIdx.x * kCoordThreads + tid;
  if (tid < kCoordRows * 3) {
    const int r = tid / 3, c = tid % 3;
    const bool in = row0 + r < block;
    ra[r][c] = (in && c < coords<MA>()) ? A.rows[static_cast<size_t>(row0 + r) * A.d + c]
                                        : 0.f;
    if (kPair)
      rb[r][c] = (in && c < coords<kMB>())
                     ? B.rows[static_cast<size_t>(row0 + r) * B.d + c] : 0.f;
  }
  __syncthreads();
  if (slot >= nbins) return;

  float best_a[kCoordRows], best_b[kCoordRows];
  int g_a[kCoordRows], g_b[kCoordRows];
#pragma unroll
  for (int r = 0; r < kCoordRows; ++r) {
    best_a[r] = best_b[r] = kNeg;
    g_a[r] = g_b[r] = 0;
  }
  const int groups = n / nbins;
  for (int g = 0; g < groups; ++g) {
    const int col = g * nbins + slot;
    float ca[3] = {0.f, 0.f, 0.f}, cb[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < coords<MA>(); ++c) ca[c] = A.cols[static_cast<size_t>(col) * A.d + c];
    const bool ok_a = A.colv[col] != 0;
    bool ok_b = false;
    if (kPair) {
#pragma unroll
      for (int c = 0; c < coords<kMB>(); ++c)
        cb[c] = B.cols[static_cast<size_t>(col) * B.d + c];
      ok_b = B.colv[col] != 0;
    }
#pragma unroll
    for (int r = 0; r < kCoordRows; ++r) {
      const bool not_self = start + row0 + r != col;   // shared by the pair
      float sim = coord_sim<MA>(ra[r], ca);
      if (!(ok_a && not_self)) sim = kNeg;
      if (sim > best_a[r]) { best_a[r] = sim; g_a[r] = g; }
      if (kPair) {
        float simb = coord_sim<kMB>(rb[r], cb);
        if (!(ok_b && not_self)) simb = kNeg;
        if (simb > best_b[r]) { best_b[r] = simb; g_b[r] = g; }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kCoordRows; ++r) {
    if (row0 + r >= block) break;
    const size_t o = static_cast<size_t>(row0 + r) * nbins + slot;
    A.vals[o] = best_a[r];
    A.grp[o] = static_cast<int8_t>(g_a[r]);
    if (kPair) {
      B.vals[o] = best_b[r];
      B.grp[o] = static_cast<int8_t>(g_b[r]);
    }
  }
}

template <int METRIC>
cudaError_t launch_mma(const void* cols, const void* rows, const void* colv,
                       const float* s_r, const float* s_c, float* vals, int8_t* grp,
                       int n, int block, int kbytes, int nbins, int start,
                       cudaStream_t stream) {
  const dim3 grid((nbins + kTileSlots - 1) / kTileSlots,
                  (block + kTileRows - 1) / kTileRows);
  binned_mma_kernel<METRIC><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(cols), static_cast<const uint8_t*>(rows),
      static_cast<const uint8_t*>(colv), s_r, s_c, vals, grp, n, block, kbytes, nbins,
      start);
  return cudaGetLastError();
}

template <int MA, int MB>
cudaError_t launch_coord(const CoordOperand& a, const CoordOperand& b, int n, int block,
                         int nbins, int start, cudaStream_t stream) {
  const dim3 grid((nbins + kCoordThreads - 1) / kCoordThreads,
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
      if ((k * 2) % kChunk) break;
      return static_cast<int>(
          launch_mma<kDot>(cols, rows, colv, sr, sc, v, gp, n, block, k * 2, nbins, start, s));
    case kJaccard:
      if (k % kChunk) break;
      return static_cast<int>(
          launch_mma<kJaccard>(cols, rows, colv, sr, sc, v, gp, n, block, k, nbins, start, s));
    case kChord:
      if ((k * 2) % kChunk) break;
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
