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
// (256, n) strip in 128 MB of VMEM across a sequential grid).  Two routes,
// split by what bounds each metric:
//
// * Contraction metrics (dot, euclidean, jaccard): three kernels per call.
//   1. row_stats: squared norms (euclidean) or set sizes (jaccard), once.
//   2. sim_keys: a CTA owns a 64 x 64 output tile; 4 warps of 32 x 32 run
//      mma.sync m16n8k8 TF32 -> f32 on 32-deep feature chunks that a 3-stage
//      cp.async pipeline stages in shared memory.  The mma's k positions
//      are a fixed permutation of the features, the same for rows and
//      columns, so one conflict-free 128-bit load (16-byte slots swizzled by
//      row parity) feeds two 8-deep steps.  f32 operands take the 3xTF32
//      split: hi = tf32_rna(x), lo = tf32_rna(x - hi), sim = lo.hi + hi.lo +
//      hi.hi in one f32 accumulator, which keeps about f32 accuracy.  A warp
//      votes per 8-deep step: a step where its row or column fragment is all
//      zero is skipped before the split (it adds only zero products), and
//      each lo product is skipped where that lo fragment is zero.  So 0/1
//      jaccard and bf16-rounded inputs run one exact pass, and sparse rows
//      skip most steps.  The epilogue applies the metric and the mask and stores each
//      value's order-preserving uint32 key to a (rows, n) scratch in device
//      memory (16 MB at n = 2000, resident in the 50 MB L2).  x.x^T is
//      symmetric, so a call whose rows are all n computes only the tiles on
//      and above the diagonal and mirrors the stores.
//   3. select_keys: one warp per row copies the row's keys to shared memory
//      once and runs the exact select below.
// * Coordinate metrics (l1, chord3; d <= 3): selection-bound, so one
//   CUDA-core kernel keeps TM rows' keys for ALL n columns in shared memory,
//   with unfused __fsub_rn / __fmul_rn / __fadd_rn in the JAX package's
//   order (bit-equal to the plain version), then selects in place.
//
// Selection is exact and free of float compares: the k-th largest key is
// found by a 32-step bisection over the key space (IEEE total order, so
// -0.0 < +0.0 exactly as lax.top_k orders them), then every key above it is
// kept plus the first (k - #above) ties in column order via warp ballots.
//
// What bounds it on an H100 at the main path's widest modality (text,
// n = 2000, d = 4096): dense, 3 x 32.8 GFLOP = 98 GFLOP of TF32 tensor work,
// about 0.5 ms at 40% of the 495 TFLOP/s dense TF32 peak (dense unit rows
// measured 0.47 ms for sim_keys on an H100 SXM at 700 W); the 64-wide tiles
// re-read the panel once per tile row: 528 tiles x 2 x 64 rows x 16 KB,
// about 1.1 GB of L2 -> shared traffic; the key scratch is 16 MB written
// and read once; the select's 34 passes read shared memory.  Text rows hold
// about 4.5 nonzeros of 4096 and tags 1.2 of 2048, so the zero-step skip
// removes most tensor work and the staging of the dense panels bounds both
// (about 7 TB/s measured for text on that card).  mma.sync without wgmma,
// TMA or a persistent schedule is the known gap to the dense peak; a sparse
// route would remove the staging.
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

int max_smem_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)
      != cudaSuccess)
    return 0;
  return bytes;
}

// ---------------------------------------------------------------------------
// exact top-k of one row of order keys (one warp)
// ---------------------------------------------------------------------------

// keys: the row's n order keys (masked columns hold order_key(kNeg));
// writes the row's n 0/1 floats to orow.
__device__ void select_row(const uint32_t* keys, int n, int k, bool row_valid,
                           float* orow, int lane) {
  const uint32_t real = order_key(0.5f * kNeg);   // key > real: a real value
  int n_valid = 0;
  for (int c = lane; c < n; c += 32) n_valid += keys[c] > real;
  const int total = warp_sum(n_valid);
  const int keff = row_valid ? min(k, total) : 0;
  if (keff == 0) {
    for (int c = lane; c < n; c += 32) orow[c] = 0.f;
    return;
  }
  // largest key t with #{key >= t} >= keff, i.e. the keff-th largest key
  uint64_t lo = 0, hi = 1ull << 32;
  while (hi - lo > 1) {
    const uint64_t mid = (lo + hi) >> 1;
    int cnt = 0;
    for (int c = lane; c < n; c += 32) cnt += keys[c] >= (uint32_t)mid;
    if (warp_sum(cnt) >= keff) lo = mid; else hi = mid;
  }
  const uint32_t kth = (uint32_t)lo;
  int above = 0;
  for (int c = lane; c < n; c += 32) above += keys[c] > kth;
  const int need = keff - warp_sum(above);

  int taken = 0;   // ties kept so far, in column order
  for (int base = 0; base < n; base += 32) {
    const int c = base + lane;
    const uint32_t key = c < n ? keys[c] : 0u;
    const bool tie = c < n && key == kth;
    const unsigned m = __ballot_sync(0xffffffffu, tie);
    const int rank = taken + __popc(m & ((1u << lane) - 1u));
    if (c < n) orow[c] = (key > kth || (tie && rank < need)) ? 1.f : 0.f;
    taken += __popc(m);
  }
}

// ---------------------------------------------------------------------------
// coordinate route (l1, chord3): keys of TM rows x all columns in shared memory
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;     // 8 warps
constexpr int kTileCols = 256;    // columns per similarity tile: one per thread
constexpr int kDk = 32;           // feature chunk staged in shared memory

// One feature step: column value b against the TM row values a[0..TM), in
// the reference's unfused order.
template <int TM, int METRIC>
__device__ __forceinline__ void accumulate(float (&acc)[TM], const float* a, float b) {
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    if (METRIC == kL1) {   // |dt_taken| + |dt_upload|
      acc[r] = __fadd_rn(acc[r], fabsf(__fsub_rn(a[r], b)));
    } else {               // kChord3: ((dx^2 + dy^2) + dz^2)
      const float t = __fsub_rn(a[r], b);
      acc[r] = __fadd_rn(acc[r], __fmul_rn(t, t));
    }
  }
}

size_t coord_smem_bytes(int tm, int n_pad) {
  return ((size_t)tm * n_pad               // key strip
          + (size_t)kTileCols * (kDk + 1)  // column chunk (padded: no bank conflicts)
          + (size_t)kDk * tm)              // row chunk, [kDk][TM]
         * sizeof(float);
}

template <int TM, int METRIC>
__global__ void __launch_bounds__(kThreads)
knn_coord_kernel(const float* __restrict__ x, const uint8_t* __restrict__ valid,
                 float* __restrict__ out, int n, int d, int n_pad, int k) {
  extern __shared__ float smem[];
  uint32_t* strip = reinterpret_cast<uint32_t*>(smem);
  float* col_tile = smem + (size_t)TM * n_pad;
  float* row_tile = col_tile + kTileCols * (kDk + 1);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * TM;

  for (int c0 = 0; c0 < n_pad; c0 += kTileCols) {
    float acc[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[r] = 0.f;
    for (int d0 = 0; d0 < d; d0 += kDk) {
      const int dk_n = min(kDk, d - d0);
      for (int i = tid; i < kTileCols * dk_n; i += kThreads) {
        const int cr = i / dk_n, cc = i - cr * dk_n;
        const int gr = c0 + cr;
        col_tile[cr * (kDk + 1) + cc] = gr < n ? x[(size_t)gr * d + d0 + cc] : 0.f;
      }
      for (int i = tid; i < TM * dk_n; i += kThreads) {
        const int rr = i / dk_n, cc = i - rr * dk_n;
        const int gr = row0 + rr;
        row_tile[cc * TM + rr] = gr < n ? x[(size_t)gr * d + d0 + cc] : 0.f;
      }
      __syncthreads();
      for (int dk = 0; dk < dk_n; ++dk)
        accumulate<TM, METRIC>(acc, row_tile + dk * TM, col_tile[tid * (kDk + 1) + dk]);
      __syncthreads();
    }
    const int col = c0 + tid;
    const bool col_ok = col < n && valid[col] != 0;
#pragma unroll
    for (int r = 0; r < TM; ++r)
      strip[(size_t)r * n_pad + col] =
          order_key((col_ok && row0 + r != col) ? -acc[r] : kNeg);
  }
  __syncthreads();

  for (int r = warp; r < TM; r += kThreads / 32) {
    const int gr = row0 + r;
    if (gr < n)
      select_row(strip + (size_t)r * n_pad, n, k, valid[gr] != 0, out + (size_t)gr * n,
                 lane);
  }
}

// Largest row tile in {16, 8, 4, 2, 1} whose key strip fits shared memory.
int rows_per_block(int n) {
  const int n_pad = (n + kTileCols - 1) / kTileCols * kTileCols;
  const size_t limit = (size_t)max_smem_bytes();
  for (int tm = 16; tm >= 1; tm >>= 1)
    if (coord_smem_bytes(tm, n_pad) <= limit) return tm;
  return 0;
}

template <int TM, int METRIC>
cudaError_t launch_coord(const float* x, const uint8_t* valid, float* out, int n, int d,
                         int k, cudaStream_t stream) {
  const int n_pad = (n + kTileCols - 1) / kTileCols * kTileCols;
  const size_t smem = coord_smem_bytes(TM, n_pad);
  auto kern = knn_coord_kernel<TM, METRIC>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<(n + TM - 1) / TM, kThreads, smem, stream>>>(x, valid, out, n, d, n_pad, k);
  return cudaGetLastError();
}

template <int TM>
cudaError_t launch_coord_metric(int metric, const float* x, const uint8_t* valid,
                                float* out, int n, int d, int k, cudaStream_t s) {
  switch (metric) {
    case kL1: return launch_coord<TM, kL1>(x, valid, out, n, d, k, s);
    case kChord3: return launch_coord<TM, kChord3>(x, valid, out, n, d, k, s);
    default: return cudaErrorInvalidValue;
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
constexpr int kSelectMaxWarps = 8;

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
                int d, int row0, int rows, int col_tiles, bool symmetric) {
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
          keys[(size_t)(row - row0) * n + col] =
              order_key(valid[col] != 0 && row != col ? sim : kNeg);
          if (mirror)   // row0 == 0: column col is scratch row col
            keys[(size_t)col * n + row] = order_key(row_ok ? sim : kNeg);
        }
    }
}

// Exact top-k of rows [row0, row0 + rows) from their keys, one warp per row.
__global__ void __launch_bounds__(kSelectMaxWarps * 32)
select_keys_kernel(const uint32_t* __restrict__ keys, const uint8_t* __restrict__ valid,
                   float* __restrict__ out, int n, int row0, int rows, int k) {
  extern __shared__ uint32_t row_keys[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= rows) return;
  uint32_t* s = row_keys + (size_t)warp * n;
  const uint32_t* g = keys + (size_t)r * n;
  for (int c = lane; c < n; c += 32) s[c] = g[c];
  __syncwarp();
  const int gr = row0 + r;
  select_row(s, n, k, valid[gr] != 0, out + (size_t)gr * n, lane);
}

// Rows per select block: as many warps (<= 8) as rows of keys fit shared memory.
int select_warps(int n) {
  const size_t per_row = (size_t)n * sizeof(uint32_t);
  const size_t fit = (size_t)max_smem_bytes() / per_row;
  return (int)(fit < (size_t)kSelectMaxWarps ? fit : kSelectMaxWarps);
}

template <int METRIC>
cudaError_t launch_tc(const float* x, const uint8_t* valid, float* stats, uint32_t* keys,
                      float* out, int n, int d, int k, int chunk, cudaStream_t s) {
  if (METRIC != kDot) {
    row_stats_kernel<METRIC><<<(n + 7) / 8, 256, 0, s>>>(
        reinterpret_cast<const float4*>(x), stats, n, d / 4);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  auto sim = sim_keys_kernel<METRIC>;
  cudaError_t e = cudaFuncSetAttribute(sim, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kTcSmemBytes);
  if (e != cudaSuccess) return e;
  const int warps = select_warps(n);
  if (warps == 0) return cudaErrorInvalidValue;
  const size_t sel_smem = (size_t)warps * n * sizeof(uint32_t);
  e = cudaFuncSetAttribute(select_keys_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sel_smem);
  if (e != cudaSuccess) return e;

  const int col_tiles = (n + kTcTile - 1) / kTcTile;
  for (int row0 = 0; row0 < n; row0 += chunk) {
    const int rows = min(chunk, n - row0);
    const bool symmetric = rows == n;
    const int row_tiles = (rows + kTcTile - 1) / kTcTile;
    const int blocks = symmetric ? col_tiles * (col_tiles + 1) / 2 : row_tiles * col_tiles;
    sim<<<blocks, kTcThreads, kTcSmemBytes, s>>>(x, valid, stats, keys, n, d, row0, rows,
                                                 col_tiles, symmetric);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    select_keys_kernel<<<(rows + warps - 1) / warps, warps * 32, sel_smem, s>>>(
        keys, valid, out, n, row0, rows, k);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Coordinate route.  x (n, d) f32 row-major (chord3: d = 3; l1: any d),
// valid (n,) bytes 0/1, out (n, n) f32; 1 <= k < n.  Launches on `stream`
// and returns cudaGetLastError() after the launch.
int mused_knn_adjacency(const void* x, const void* valid, void* out, int n, int d,
                        int k, int metric, void* stream) {
  if (n <= 0 || d <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_per_block(n)) {
    case 16: return (int)launch_coord_metric<16>(metric, xf, v, o, n, d, k, s);
    case 8: return (int)launch_coord_metric<8>(metric, xf, v, o, n, d, k, s);
    case 4: return (int)launch_coord_metric<4>(metric, xf, v, o, n, d, k, s);
    case 2: return (int)launch_coord_metric<2>(metric, xf, v, o, n, d, k, s);
    case 1: return (int)launch_coord_metric<1>(metric, xf, v, o, n, d, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Tensor-core route (dot, euclidean, jaccard).  x (n, d) f32 row-major with
// d % 4 == 0 and a 16-byte aligned base; valid (n,) bytes 0/1; stats (n,)
// f32 scratch; keys (chunk, n) uint32 scratch; out (n, n) f32; 1 <= k < n.
// Rows run in chunks of `chunk` (n, or a multiple of the 64-row tile).  Launches row_stats (not for dot), then per
// chunk sim_keys and select_keys, on `stream`; returns the first launch error.
int mused_knn_adjacency_tc(const void* x, const void* valid, void* stats, void* keys,
                           void* out, int n, int d, int k, int metric, int chunk,
                           void* stream) {
  if (n <= 0 || d <= 0 || k <= 0 || chunk <= 0 || (chunk < n && chunk % kTcTile) ||
      d % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  float* st = static_cast<float*>(stats);
  uint32_t* ks = static_cast<uint32_t*>(keys);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case kDot: return (int)launch_tc<kDot>(xf, v, st, ks, o, n, d, k, chunk, s);
    case kEuclidean: return (int)launch_tc<kEuclidean>(xf, v, st, ks, o, n, d, k, chunk, s);
    case kJaccard: return (int)launch_tc<kJaccard>(xf, v, st, ks, o, n, d, k, chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Row tile the coordinate kernel picks for an n-row window (0: n does not fit).
int mused_knn_rows_per_block(int n) { return rows_per_block(n); }

// Dynamic shared memory of the tensor-core route's kernels at n rows:
// which 0 = sim_keys, 1 = select_keys.
int mused_knn_tc_smem_bytes(int n, int which) {
  return which == 0 ? (int)kTcSmemBytes : select_warps(n) * n * (int)sizeof(uint32_t);
}

const char* mused_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
