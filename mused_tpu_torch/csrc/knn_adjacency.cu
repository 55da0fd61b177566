// Directed kNN adjacency for one modality, fused: similarity -> mask -> exact
// top-k select with lax.top_k's tie rule -> 0/1 adjacency row.
//
// Replaces the TPU kernel mused_tpu/ops/pallas/affinity_kernel.py:
// knn_adjacency_pallas (_kernel, _sim_block).  Same function: metrics dot,
// euclidean (-(|r|^2 + |c|^2 - 2 r.c), norms hoisted), jaccard (inter /
// (|r| + |c| - inter), set sizes hoisted), l1 and chord3 (negative squared
// chord from coordinate differences); invalid, self and pad columns masked to
// -1e30; every column above the k-th value kept plus exactly (k - #above)
// columns tied at it, lowest index first; invalid rows emit nothing.
//
// Design for Hopper, not a copy of the TPU tiling (that one keeps a
// (256, n) strip in 128 MB of VMEM across a sequential grid).  Every call
// runs per chunk of rows a keys kernel, which stores each similarity's
// order-preserving uint32 key (masks applied) to a (chunk, ld) scratch in
// device memory (ld = n rounded up to 4, so rows are 16-byte aligned), then
// the select.  The wrapper sizes the chunk from free device memory, so
// up to n = 32,768 one chunk usually holds all rows.
//
// Keys kernels, split by what bounds each metric:
// * Contraction metrics (dot, euclidean, jaccard): row_stats (squared norms
//   or set sizes, once per call), then sim_keys: a CTA owns a 64 x 64 output
//   tile; 4 warps of 32 x 32 run mma.sync m16n8k8 TF32 -> f32 on 32-deep
//   feature chunks that a 3-stage cp.async pipeline stages in shared memory.
//   The mma's k positions are a fixed permutation of the features, the same
//   for rows and columns, so one conflict-free 128-bit load (16-byte slots
//   swizzled by row parity) feeds two 8-deep steps.  f32 operands take the
//   3xTF32 split: hi = tf32_rna(x), lo = tf32_rna(x - hi), sim = lo.hi +
//   hi.lo + hi.hi in one f32 accumulator, which keeps about f32 accuracy.  A
//   warp votes per 8-deep step: a step where its row or column fragment is
//   all zero is skipped before the split (it adds only zero products), and
//   each lo product is skipped where that lo fragment is zero.  So 0/1
//   jaccard and bf16-rounded inputs run one exact pass, and sparse rows skip
//   most steps.  x.x^T is symmetric, so a chunk of all n rows computes only
//   the tiles on and above the diagonal and mirrors the stores.
// * Coordinate metrics (l1, chord3; d <= 3 on the main path): coord_keys, a
//   CUDA-core tile of 32 rows x 256 columns per CTA, with unfused __fsub_rn /
//   __fmul_rn / __fadd_rn in the JAX package's order (bit-equal to the plain
//   version).
//
// Select: radix_select, exact and free of float compares (IEEE total order on
// the keys, so -0.0 < +0.0 exactly as lax.top_k orders them); one CTA of
// kRadixThreads per row, many rows in flight on every SM whatever n is.  A
// long row no longer fits a few warps' shared memory (128 KB at n =
// 32,768), so the keys stream from the scratch (L2 / HBM) in 16-byte loads.
// Three histogram passes over the row's digits (bits 31-21, 20-10, 9-0;
// 2048 / 2048 / 1024 bins in shared memory, increments aggregated per warp
// with __match_any_sync, since sparse rows hold thousands of equal keys)
// each pick the bin holding the k-th key by a CTA-wide suffix scan, so the
// third fixes the k-th key and counts its ties.  A fourth pass writes the
// row: every key above the k-th, and its ties too when all are kept; else
// the first (k - #above) ties by a CTA-wide prefix count in column order.
//
// What bounds it on an H100: at window 2000 the tensor-core similarity of
// text (3 x 32.8 GFLOP TF32 if dense; about 0.5 ms at 40% of the 495 TFLOP/s
// peak, but the zero-step skip removes most of it and staging the dense
// panels bounds tags and text), with the 16 MB scratch resident in the 50 MB
// L2.  At n = 32,768 bytes: the keys written once (4.3 GB), read four times
// by the radix select, and the (n, n) output written once (4.3 GB), about
// 26 GB or 8 ms at 3.35 TB/s per call, on top of text's and tags' tensor
// work.  mma.sync without wgmma, TMA or a persistent schedule is the known
// gap to the dense peak; a sparse route would remove the staging.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;    // masked similarity (matches the reference)

enum Metric { kDot = 0, kEuclidean = 1, kJaccard = 2, kL1 = 3, kChord3 = 4 };

// Order-preserving map of a float to uint32 (IEEE total order for non-NaN).
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(0xffffffffu, v);
}

// Key-scratch row stride: n rounded up to 4 keys (16-byte rows).
int key_stride(int n) { return (n + 3) & ~3; }

// ---------------------------------------------------------------------------
// exact top-k of each row: radix select, one CTA per row, keys streamed
// ---------------------------------------------------------------------------

constexpr int kRadixThreads = 256;
constexpr int kRadixBins = 2048;      // digits of 11, 11 and 10 bits

// One histogram increment per distinct bin per warp; every lane of the warp
// calls it (``on`` false: no increment).
__device__ __forceinline__ void hist_add(uint32_t* hist, uint32_t bin, bool on) {
  if (!__any_sync(0xffffffffu, on)) return;
  const unsigned peers = __match_any_sync(0xffffffffu, on ? bin : 0xffffffffu);
  if (on && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
}

// The row's 4 keys at columns c .. c + 3 (c a multiple of 4; the row is
// padded to 16 bytes); columns >= n read as in[j] = false.
__device__ __forceinline__ uint4 load4(const uint32_t* row, int c, int n, bool (&in)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) in[j] = c + j < n;
  return c < n ? *reinterpret_cast<const uint4*>(row + c) : make_uint4(0u, 0u, 0u, 0u);
}

// Writes 0/1 of columns c .. c + 3 that are < n.
__device__ __forceinline__ void store4(float* orow, int c, int n, const bool (&o)[4]) {
  if ((n & 3) == 0) {
    if (c < n)
      *reinterpret_cast<float4*>(orow + c) =
          make_float4(o[0] ? 1.f : 0.f, o[1] ? 1.f : 0.f, o[2] ? 1.f : 0.f, o[3] ? 1.f : 0.f);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < n) orow[c + j] = o[j] ? 1.f : 0.f;
  }
}

// Histogram pass PASS over the row: digit bits 31-21, 20-10 or 9-0 of the
// keys whose higher bits equal ``prefix``.  Pass 0 also counts real keys.
template <int NT, int PASS>
__device__ __forceinline__ int radix_pass(const uint32_t* row, int n, uint32_t prefix,
                                          uint32_t* hist) {
  constexpr int kShift = PASS == 0 ? 21 : PASS == 1 ? 10 : 0;
  constexpr uint32_t kMask = PASS == 2 ? 0x3ffu : 0x7ffu;
  const uint32_t real = order_key(0.5f * kNeg);   // key > real: a real value
  int n_real = 0;
#pragma unroll 2
  for (int base = 0; base < n; base += 4 * NT) {
    const int c = base + 4 * (int)threadIdx.x;
    bool in[4];
    const uint4 v = load4(row, c, n, in);
    const uint32_t kk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bool on = in[j];
      if (PASS == 0) n_real += on && kk[j] > real;
      if (PASS == 1) on = on && (kk[j] >> 21) == prefix;
      if (PASS == 2) on = on && (kk[j] >> 10) == prefix;
      hist_add(hist, (kk[j] >> kShift) & kMask, on);
    }
  }
  return n_real;
}

// The bin b of hist[0, NB) that holds the need-th largest key: S(b + 1) <
// need <= S(b), S(b) = the count in bins >= b.  res = {b, S(b + 1), hist[b]}.
// Starts and ends with a barrier.
template <int NT, int NB>
__device__ __forceinline__ void find_bin(const uint32_t* hist, int need, int* warp_tot,
                                         int* res) {
  constexpr int kPer = NB / NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int top = NB - 1 - (int)threadIdx.x * kPer;   // bins top, top - 1, ...
  __syncthreads();
  int local = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) local += hist[top - i];
  int incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int above = incl - local;
  for (int w = 0; w < warp; ++w) above += warp_tot[w];
  if (above < need && above + local >= need) {
    int s = above;
    for (int i = 0; i < kPer; ++i) {
      const int h = hist[top - i];
      if (s + h >= need) {
        res[0] = top - i;
        res[1] = s;
        res[2] = h;
        break;
      }
      s += h;
    }
  }
  __syncthreads();
}

template <int NT>
__device__ __forceinline__ void clear_hist(uint32_t* hist) {
  for (int i = threadIdx.x; i < kRadixBins; i += NT) hist[i] = 0u;
}

// Rows [row0, row0 + gridDim.x) from their keys (row r of the chunk at
// keys + r * ld), one CTA per row.
template <int NT>
__global__ void __launch_bounds__(NT)
radix_select_kernel(const uint32_t* __restrict__ keys, const uint8_t* __restrict__ valid,
                    float* __restrict__ out, int n, int ld, int row0, int k) {
  __shared__ uint32_t hist[kRadixBins];
  __shared__ int warp_tot[NT / 32];
  __shared__ int res[3];
  __shared__ int n_real;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = row0 + blockIdx.x;
  const uint32_t* row = keys + (size_t)blockIdx.x * ld;
  float* orow = out + (size_t)gr * n;

  int keff = 0;
  if (valid[gr]) {
    clear_hist<NT>(hist);
    if (threadIdx.x == 0) n_real = 0;
    __syncthreads();
    const int mine = warp_sum(radix_pass<NT, 0>(row, n, 0u, hist));
    if (lane == 0) atomicAdd(&n_real, mine);
    __syncthreads();
    keff = min(k, n_real);
  }
  if (keff == 0) {   // uniform across the CTA
    const bool none[4] = {false, false, false, false};
    for (int c = 4 * threadIdx.x; c < n; c += 4 * NT) store4(orow, c, n, none);
    return;
  }
  find_bin<NT, kRadixBins>(hist, keff, warp_tot, res);
  uint32_t prefix = res[0];
  int above = res[1];
  clear_hist<NT>(hist);
  __syncthreads();
  radix_pass<NT, 1>(row, n, prefix, hist);
  find_bin<NT, kRadixBins>(hist, keff - above, warp_tot, res);
  prefix = (prefix << 11) | res[0];
  above += res[1];
  clear_hist<NT>(hist);
  __syncthreads();
  radix_pass<NT, 2>(row, n, prefix, hist);
  find_bin<NT, 1024>(hist, keff - above, warp_tot, res);
  const uint32_t kth = (prefix << 10) | res[0];
  above += res[1];
  const int need = keff - above, ties = res[2];   // 1 <= need <= ties

  if (need == ties) {   // every tie kept
    for (int c = 4 * threadIdx.x; c < n; c += 4 * NT) {
      bool in[4];
      const uint4 v = load4(row, c, n, in);
      const bool o[4] = {in[0] && v.x >= kth, in[1] && v.y >= kth, in[2] && v.z >= kth,
                         in[3] && v.w >= kth};
      store4(orow, c, n, o);
    }
    return;
  }
  int taken = 0;   // ties kept so far, in column order
  for (int base = 0; base < n; base += 4 * NT) {
    const int c = base + 4 * (int)threadIdx.x;
    bool in[4];
    const uint4 v = load4(row, c, n, in);
    const uint32_t kk[4] = {v.x, v.y, v.z, v.w};
    bool tie[4];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      tie[j] = in[j] && kk[j] == kth;
      cnt += tie[j];
    }
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    int rank = taken + incl - cnt, total = 0;
    for (int w = 0; w < NT / 32; ++w) {
      const int t = warp_tot[w];
      if (w < warp) rank += t;
      total += t;
    }
    bool o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[j] = (in[j] && kk[j] > kth) || (tie[j] && rank < need);
      rank += tie[j];
    }
    store4(orow, c, n, o);
    taken += total;
    __syncthreads();   // warp_tot is rewritten next round
  }
}

// ---------------------------------------------------------------------------
// coordinate keys (l1, chord3): 32 rows x 256 columns per CTA
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;     // 8 warps
constexpr int kTileCols = 256;    // columns per tile: one per thread
constexpr int kCoordRows = 32;    // rows per tile
constexpr int kDk = 32;           // feature chunk staged in shared memory

// One feature step: column value b against the row values a[0..kCoordRows),
// in the reference's unfused order.
template <int METRIC>
__device__ __forceinline__ void accumulate(float (&acc)[kCoordRows], const float* a, float b) {
#pragma unroll
  for (int r = 0; r < kCoordRows; ++r) {
    if (METRIC == kL1) {   // |dt_taken| + |dt_upload|
      acc[r] = __fadd_rn(acc[r], fabsf(__fsub_rn(a[r], b)));
    } else {               // kChord3: ((dx^2 + dy^2) + dz^2)
      const float t = __fsub_rn(a[r], b);
      acc[r] = __fadd_rn(acc[r], __fmul_rn(t, t));
    }
  }
}

// Keys of rows [row0, row0 + rows) x all n columns.
template <int METRIC>
__global__ void __launch_bounds__(kThreads)
coord_keys_kernel(const float* __restrict__ x, const uint8_t* __restrict__ valid,
                  uint32_t* __restrict__ keys, int n, int d, int ld, int row0, int rows) {
  __shared__ float col_tile[kTileCols * (kDk + 1)];   // padded: no bank conflicts
  __shared__ float row_tile[kDk * kCoordRows];        // [kDk][kCoordRows]
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kTileCols;
  const int r0 = row0 + blockIdx.y * kCoordRows;
  const int row_end = row0 + rows;

  float acc[kCoordRows];
#pragma unroll
  for (int r = 0; r < kCoordRows; ++r) acc[r] = 0.f;
  for (int d0 = 0; d0 < d; d0 += kDk) {
    const int dk_n = min(kDk, d - d0);
    for (int i = tid; i < kTileCols * dk_n; i += kThreads) {
      const int cr = i / dk_n, cc = i - cr * dk_n;
      const int gc = c0 + cr;
      col_tile[cr * (kDk + 1) + cc] = gc < n ? x[(size_t)gc * d + d0 + cc] : 0.f;
    }
    for (int i = tid; i < kCoordRows * dk_n; i += kThreads) {
      const int rr = i / dk_n, cc = i - rr * dk_n;
      const int gr = r0 + rr;
      row_tile[cc * kCoordRows + rr] = gr < row_end ? x[(size_t)gr * d + d0 + cc] : 0.f;
    }
    __syncthreads();
    for (int dk = 0; dk < dk_n; ++dk)
      accumulate<METRIC>(acc, row_tile + dk * kCoordRows, col_tile[tid * (kDk + 1) + dk]);
    __syncthreads();
  }
  const int col = c0 + tid;
  if (col >= n) return;
  const bool col_ok = valid[col] != 0;
#pragma unroll
  for (int r = 0; r < kCoordRows; ++r) {
    const int gr = r0 + r;
    if (gr < row_end)
      keys[(size_t)(gr - row0) * ld + col] = order_key((col_ok && gr != col) ? -acc[r] : kNeg);
  }
}

// ---------------------------------------------------------------------------
// tensor-core route (dot, euclidean, jaccard)
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;          // 4 warps: 2 (rows) x 2 (cols), 32 x 32 each
constexpr int kTcTile = 64;              // output tile: 64 rows x 64 columns
constexpr int kTcK = 32;                 // features per pipeline stage
constexpr int kTcStages = 3;
constexpr int kTcStageFloats = 2 * kTcTile * kTcK;   // row tile + column tile
constexpr size_t kTcSmemBytes = (size_t)kTcStages * kTcStageFloats * sizeof(float);

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

// Round to TF32 (10 explicit mantissa bits), to nearest, ties away from zero.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Split v into TF32 hi and lo; set `bit` of f if lo != 0.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo, unsigned& f,
                                      unsigned bit) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
  if ((lo << 1) != 0u) f |= bit;
}

// Squared norms (euclidean) or set sizes (jaccard), one warp per row of d4
// float4s.
template <int METRIC>
__global__ void __launch_bounds__(256)
row_stats_kernel(const float4* __restrict__ x, float* __restrict__ stats, int n, int d4) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= n) return;
  float s = 0.f;
  for (int c = lane; c < d4; c += 32) {
    const float4 v = x[(size_t)r * d4 + c];
    s += METRIC == kEuclidean ? (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w)
                              : (v.x + v.y) + (v.z + v.w);
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) stats[r] = s;
}

// Keys of rows [row0, row0 + rows) x all n columns.  symmetric (rows == n):
// only tiles (ti <= tj) run and off-diagonal tiles mirror their stores.
template <int METRIC>
__global__ void __launch_bounds__(kTcThreads, 4)
sim_keys_kernel(const float* __restrict__ x, const uint8_t* __restrict__ valid,
                const float* __restrict__ stats, uint32_t* __restrict__ keys, int n,
                int d, int ld, int row0, int rows, int col_tiles, bool symmetric) {
  extern __shared__ __align__(16) float tc_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int gid = lane >> 2, tig = lane & 3;

  int ti, tj;
  if (symmetric) {   // blockIdx.x walks the upper triangle row by row
    int b = blockIdx.x;
    ti = 0;
    while (b >= col_tiles - ti) {
      b -= col_tiles - ti;
      ++ti;
    }
    tj = ti + b;
  } else {
    ti = blockIdx.x / col_tiles;
    tj = blockIdx.x % col_tiles;
  }
  const int r0 = row0 + ti * kTcTile, c0 = tj * kTcTile;
  const int row_end = row0 + rows;
  const int nk = (d + kTcK - 1) / kTcK;

  // 64 rows x 8 16-byte slots per operand per stage, 4 slots a thread each;
  // slot q of row r sits at q ^ 4 (r & 1): a quarter warp's 128-bit fragment
  // loads (rows gid, gid + 1) then cover all 32 banks once
  auto load = [&](int kc, int stage) {
    float* as = tc_smem + stage * kTcStageFloats;
    float* bs = as + kTcTile * kTcK;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = tid + q * kTcThreads;
      const int r = idx >> 3, slot = idx & 7;
      const int f = kc * kTcK + slot * 4;
      const int dst = r * kTcK + ((slot ^ ((r & 1) << 2)) << 2);
      const bool pa = f < d && r0 + r < row_end;
      cp_async16(as + dst, pa ? x + (size_t)(r0 + r) * d + f : x, pa);
      const bool pb = f < d && c0 + r < n;
      cp_async16(bs + dst, pb ? x + (size_t)(c0 + r) * d + f : x, pb);
    }
  };
  auto frag = [&](const float* t, int r, int p) {   // features 16p + 4 tig .. + 3
    return *reinterpret_cast<const float4*>(
        t + r * kTcK + ((((p << 2) + tig) ^ ((r & 1) << 2)) << 2));
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();   // chunk kc landed; everyone is done with chunk kc - 1
    const int next = kc + kTcStages - 1;
    if (next < nk) load(next, next % kTcStages);
    cp_async_commit();

    const float* as = tc_smem + (kc % kTcStages) * kTcStageFloats;
    const float* bs = as + kTcTile * kTcK;
#pragma unroll
    for (int p = 0; p < kTcK / 16; ++p) {
      // The mma's k positions (tig, tig + 4) of step t in {0, 1} are
      // features 16p + 4 tig + 2t and + 1, for rows and columns alike: a
      // permutation of the sum's terms, so one float4 feeds both steps.
      float4 av[2][2], bv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16 + gid;
        av[i][0] = frag(as, r, p);
        av[i][1] = frag(as, r + 8, p);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = frag(bs, wn * 32 + j * 8 + gid, p);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float a[2][4], b[4][2];
        uint32_t nz_a = 0, nz_b = 0;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a[i][0] = t ? av[i][0].z : av[i][0].x;
          a[i][1] = t ? av[i][1].z : av[i][1].x;
          a[i][2] = t ? av[i][0].w : av[i][0].y;
          a[i][3] = t ? av[i][1].w : av[i][1].y;
#pragma unroll
          for (int e = 0; e < 4; ++e) nz_a |= __float_as_uint(a[i][e]) << 1;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j][0] = t ? bv[j].z : bv[j].x;
          b[j][1] = t ? bv[j].w : bv[j].y;
          nz_b |= (__float_as_uint(b[j][0]) | __float_as_uint(b[j][1])) << 1;
        }
        // an all-zero fragment in the warp adds only zero products: skip
        if (__reduce_or_sync(0xffffffffu, (nz_a ? 1u : 0u) | (nz_b ? 2u : 0u)) != 3u)
          continue;
        uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
        unsigned f = 0;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) split(a[i][e], ah[i][e], al[i][e], f, 1u);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) split(b[j][e], bh[j][e], bl[j][e], f, 2u);
        f = __reduce_or_sync(0xffffffffu, f);
        auto row_lo = [&] {
          if (f & 1u)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
        };
        auto col_lo = [&] {
          if (f & 2u)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
        };
        // the lower tile's lo products go first, so a tile and its transpose
        // add the same products in the same order (the mirror is exact)
        if (r0 <= c0) {
          row_lo();
          col_lo();
        } else {
          col_lo();
          row_lo();
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
      }
    }
  }

  // epilogue: accumulator element (i, j, e) is row gid + 8 * (e >> 1) of
  // m-tile i, column 2 * tig + (e & 1) of n-tile j
  const bool mirror = symmetric && ti != tj;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + wm * 32 + i * 16 + gid + h * 8;
      if (row >= row_end) continue;
      const float s_r = METRIC != kDot ? stats[row] : 0.f;
      const bool row_ok = valid[row] != 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int col = c0 + wn * 32 + j * 8 + tig * 2 + e1;
          if (col >= n) continue;
          const float v = acc[i][j][h * 2 + e1];
          float sim;
          if (METRIC == kDot) {
            sim = v;
          } else if (METRIC == kJaccard) {
            const float uni = __fsub_rn(__fadd_rn(s_r, stats[col]), v);
            sim = uni > 0.f ? __fdiv_rn(v, fmaxf(uni, 1e-9f)) : 0.f;
          } else {   // kEuclidean
            sim = -__fsub_rn(__fadd_rn(s_r, stats[col]), __fmul_rn(2.f, v));
          }
          keys[(size_t)(row - row0) * ld + col] =
              order_key(valid[col] != 0 && row != col ? sim : kNeg);
          if (mirror)   // row0 == 0: column col is scratch row col
            keys[(size_t)col * ld + row] = order_key(row_ok ? sim : kNeg);
        }
    }
}

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------

template <int METRIC>
cudaError_t launch(const float* x, const uint8_t* valid, float* stats, uint32_t* keys,
                   float* out, int n, int d, int k, int chunk, cudaStream_t s) {
  constexpr bool kTensorCore = METRIC == kDot || METRIC == kEuclidean || METRIC == kJaccard;
  const int ld = key_stride(n);
  cudaError_t e;
  if constexpr (METRIC == kEuclidean || METRIC == kJaccard) {
    row_stats_kernel<METRIC><<<(n + 7) / 8, 256, 0, s>>>(
        reinterpret_cast<const float4*>(x), stats, n, d / 4);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if constexpr (kTensorCore) {
    e = cudaFuncSetAttribute(sim_keys_kernel<METRIC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmemBytes);
    if (e != cudaSuccess) return e;
  }

  const int col_tiles = (n + kTcTile - 1) / kTcTile;
  for (int row0 = 0; row0 < n; row0 += chunk) {
    const int rows = min(chunk, n - row0);
    if constexpr (kTensorCore) {
      const bool symmetric = rows == n;
      const int row_tiles = (rows + kTcTile - 1) / kTcTile;
      const int blocks = symmetric ? col_tiles * (col_tiles + 1) / 2 : row_tiles * col_tiles;
      sim_keys_kernel<METRIC><<<blocks, kTcThreads, kTcSmemBytes, s>>>(
          x, valid, stats, keys, n, d, ld, row0, rows, col_tiles, symmetric);
    } else {
      const dim3 grid((n + kTileCols - 1) / kTileCols, (rows + kCoordRows - 1) / kCoordRows);
      coord_keys_kernel<METRIC><<<grid, kThreads, 0, s>>>(x, valid, keys, n, d, ld, row0, rows);
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    radix_select_kernel<kRadixThreads><<<rows, kRadixThreads, 0, s>>>(keys, valid, out, n, ld,
                                                                     row0, k);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// x (n, d) f32 row-major; valid (n,) bytes 0/1; stats (n,) f32 scratch;
// keys (chunk, n rounded up to 4) uint32 scratch; out (n, n) f32; 1 <= k < n.
// dot / euclidean / jaccard need d % 4 == 0 and a 16-byte aligned x; chord3
// takes d = 3, l1 any d.  Rows run in chunks of `chunk` (n, or a multiple of
// the 64-row tile).  Launches row_stats (euclidean, jaccard), then per chunk
// the keys kernel and radix_select, on `stream`; returns the first launch
// error.
int mused_knn_adjacency(const void* x, const void* valid, void* stats, void* keys, void* out,
                        int n, int d, int k, int metric, int chunk, void* stream) {
  const bool tensor_core = metric == kDot || metric == kEuclidean || metric == kJaccard;
  if (n <= 0 || d <= 0 || k <= 0 || chunk <= 0 || (chunk < n && chunk % kTcTile) ||
      (tensor_core && (d % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)) ||
      (metric == kChord3 && d != 3))
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  float* st = static_cast<float*>(stats);
  uint32_t* ks = static_cast<uint32_t*>(keys);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case kDot: return (int)launch<kDot>(xf, v, st, ks, o, n, d, k, chunk, s);
    case kEuclidean: return (int)launch<kEuclidean>(xf, v, st, ks, o, n, d, k, chunk, s);
    case kJaccard: return (int)launch<kJaccard>(xf, v, st, ks, o, n, d, k, chunk, s);
    case kL1: return (int)launch<kL1>(xf, v, st, ks, o, n, d, k, chunk, s);
    case kChord3: return (int)launch<kChord3>(xf, v, st, ks, o, n, d, k, chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Shared memory per CTA: which 0 = sim_keys (dynamic), 1 = radix_select (static).
int mused_knn_smem_bytes(int which) {
  return which == 0 ? (int)kTcSmemBytes
                    : (int)(sizeof(uint32_t) * kRadixBins + sizeof(int) * (kRadixThreads / 32 + 4));
}

const char* mused_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
