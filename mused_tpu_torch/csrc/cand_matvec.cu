// Products with the implicit fused-adjacency rows of a candidate block, as
// gathers over the block's kept candidates: the dense (block, n) 0/1 block
// never exists, and no kernel walks it.
//
// Replaces the TPU kernels mused_tpu/ops/pallas/cand_matvec.py:
// matvec_t_pallas (K4: _matvec_t_kernel, _mask_tile, _operands) and
// matvec_pallas (K5: _matvec_kernel).  Same function: the fused tile of
// local column group g is W[i, s] = OR_m (slab[m, i, s] == g), ORed with
// username equality uid_rows[i] == uid_cols[g, s] where the global row
// start + i differs from the global column (g0 + g) * nbins + s.  K4
// computes out_t (r, n) = x_t (r, block) @ W and the exact edge count
// sum(W); K5 computes out (block, r) = W @ y.  Operands x_t and y are bf16;
// sums are f32.
//
// Design for Hopper.  The block is sparse: budgeted_keep keeps k candidates
// per row and modality, so a 2048-row block of the huge window holds about
// 0.59 M edges among its 201 M entries (0.3%), and a row about 300.  The TPU
// kernel rebuilds the 0/1 tile of every column group from the slabs and
// multiplies it densely; here the work follows the edges.  Every kernel is
// CUDA-core integer and f32 work bounded by memory latency and L2 traffic,
// not by an arithmetic peak:
//   * mused_cand_lists, once per block (the fold's three products share
//     it), turns the slabs into lists in a memset and eight short launches,
//     into one workspace whose layout only this file knows (the caller asks
//     mused_cand_lists_layout for its size and the arrays' names and
//     places).  A warp per row walks the row's slots (4 per lane, word loads
//     of every plane), keeps each (slot, group) once over the planes (the
//     union is an OR), drops the entries whose column has the row's uid
//     other than its own (the username term counts those), counts them, and
//     after a one-CTA scan writes the row's local column ids in slot order
//     (rowptr / rowcols), counting each column as it goes (integer
//     atomics).  A scan of the column counts and a flat pass over the
//     entries drop each entry's row into its column's bucket; a warp per
//     column puts the bucket in row order (a rank by shuffles up to 32 rows, else a
//     bitmap of the block's rows in shared memory), so colrows is the same
//     on every launch.  Columns of more than kHeavy rows are listed as hubs.
//     With usernames it also ranks the block's rows by uid, numbers the
//     distinct uids, looks every column's uid up among them (binary search)
//     and lists each user's columns in column order (a counting sort over
//     1024-column chunks: per-chunk counts, one scan, a warp per chunk
//     placing its columns with __match_any_sync).  The exact edge count is
//     the list length plus, per column, its user's rows less its own row:
//     integers, so it stays exact;
//   * the username term is linear in n + block, whatever one user's size:
//     per-user sums of x's rows (K4) or y's rows (K5) are summed by warps
//     that each take 32 entries of the user-sorted lists; a user that spans
//     warps is summed from its pieces in warp order by the warp that arrives
//     last.  A column adds its user's sum less its own row (K4), a row its
//     user's sum less its own column (K5);
//   * K4 is a column gather.  x_t is first transposed to x (block, r rounded
//     to 8).  Light columns (kHeavy rows or fewer; the 260 K entries of 96 K
//     columns on the real block): a CTA stages an r tile of x (24 values of
//     all 2048 rows, 96 KB, two CTAs per SM) and a thread owns a column,
//     summing its staged rows in row order in 24 f32 registers and writing
//     its out_t values (a warp's 32 columns coalesced).  Heavy columns (the
//     times and places many rows share: 2 K columns with 330 K entries, up to
//     800 rows each): a CTA per column, each warp summing an eighth of the
//     rows with lanes over x's values, the eighths added in warp order;
//   * K5 is a row gather.  A warp owns a block row and an r chunk: its lanes
//     hold the row's list indices, broadcast them with shuffles and sum the
//     y rows (4-byte bf16 pairs, 16 rows in flight) in list order in f32
//     registers; y (13 MB at r = 66) stays in the 50 MB L2.
// No float atomics: every sum runs in an order fixed by the lists, so two
// launches give the same bits; on integer-valued operands every order is
// exact, so the kernels equal the plain versions bit for bit.
//
// What bounds them on an H100 at n = 98,304, block = 2048: the bytes of
// their outputs and inputs, each once.  The lists read the slabs (12.6 MB)
// and write the lists; K4 reads x_t and the column lists (about 3 MB) and
// writes out_t, 26 MB at r = 66 and 52 MB at r = 132; K5 reads y (13 MB)
// and the row lists; about 0.005-0.025 ms each.  The 2 r operations per
// edge are 0.08-0.16 GFLOP.  What the
// design spends instead is dependent loads: list indices, then rows of x or
// y, then per-user sums, each an L2 round trip, and launches (K4 runs 4
// kernels and a memset, K5 2 and a memset, the lists 8 and a memset).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // every kernel here but K4's
constexpr int kWarps = kThreads / 32;
constexpr int kScanTile = 2048;          // elements per CTA of a scan
constexpr int kQCols = 1024;             // columns per chunk of the user-column sort
constexpr int kSegChunk = 32;            // list entries per warp chunk of the user sums
constexpr int kHeavy = 64;               // K4: longer columns go to the heavy kernel
constexpr int kT4Threads = 512;          // K4's light kernel: a column per thread
constexpr int kT4Smem = 100 * 1024;      // its x tile per CTA: two CTAs per SM
constexpr int kMaxBlock = 32768;         // the row rank sort is quadratic in the block
constexpr unsigned kFull = 0xffffffffu;

struct Cand {
  const int8_t* slabs;     // (n_mod, block, nbins)
  const int* uid_rows;     // (block,) or null
  const int* uid_cols;     // (groups, nbins)
  int n_mod, block, nbins, groups, start, g0;
};

// The lists' arrays, in one int32 workspace (edges is one 64-bit count);
// kListNames names them in this order for the caller, and list_layout
// places them.  colcnt, edges, nhubs and hist stay last and in this order:
// one memset zeroes them.
enum Buf {
  kRowPtr, kRowCols, kColPtr, kColRows, kColTmp, kRowCnt, kRowUser, kUserPtr, kUserRows,
  kUids, kNu, kSUid, kColUser, kHOff, kUCols, kTiles, kHubs, kColCnt, kEdges, kNHubs, kHist,
  kNumBufs
};
constexpr const char* kListNames =
    "rowptr,rowcols,colptr,colrows,coltmp,rowcnt,row_user,userptr,userrows,uids,nu,suid,"
    "col_user,hoff,ucols,tiles,hubs,colcnt,edges,nhubs,hist";

struct Lists {
  int* a[kNumBufs];
  int q;                   // column chunks of the user-column sort
};

__device__ __forceinline__ unsigned long long* edges_of(const Lists& L) {
  return reinterpret_cast<unsigned long long*>(L.a[kEdges]);
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// Exclusive prefix of v over the CTA (kThreads threads, all of them call);
// *total gets the CTA's sum.
__device__ int block_excl_scan(int v, int* total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_incl_scan(v, lane);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int off = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sums[w];
    off += w < warp ? s : 0;
    tot += s;
  }
  __syncthreads();   // warp_sums is free for the next call
  *total = tot;
  return off + incl - v;
}

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// ---------------------------------------------------------------------------
// the lists
// ---------------------------------------------------------------------------

// Group g at (row, slot s) enters the row's list: 0 <= g < groups, and the
// username term does not already count its column (uid equal and not the
// row's own column, self_col local).  The caller drops groups an earlier
// plane holds there.
__device__ __forceinline__ bool kept(const Cand& c, int g, int s, int urow, long long self_col) {
  if (g < 0 || g >= c.groups) return false;
  const int col = g * c.nbins + s;
  return c.uid_rows == nullptr || c.uid_cols[col] != urow || col == self_col;
}

// A warp walks a row 128 slots at a time, 4 consecutive slots per lane;
// masks[t] holds slot s + t's planes (bit m) in the row's list.
struct RowWalk {
  size_t plane, rowb;
  int urow;
  long long self_col;
  bool words;              // <= 4 planes, 4-byte aligned slot words
  __device__ RowWalk(const Cand& c, int i)
      : plane(static_cast<size_t>(c.block) * c.nbins),
        rowb(static_cast<size_t>(i) * c.nbins),
        urow(c.uid_rows != nullptr ? c.uid_rows[i] : 0),
        self_col(static_cast<long long>(c.start) + i - static_cast<long long>(c.g0) * c.nbins),
        words(c.n_mod <= 4 && c.nbins % 4 == 0 &&
              (reinterpret_cast<uintptr_t>(c.slabs) & 3u) == 0) {}
  __device__ int group(const Cand& c, int m, int s) const {
    return c.slabs[m * plane + rowb + s];
  }
  // the four slots' groups of each plane (words); -1 bytes past nbins or n_mod
  __device__ void load(const Cand& c, int s, int (&w)[4]) const {
#pragma unroll
    for (int m = 0; m < 4; ++m)
      w[m] = m < c.n_mod && s < c.nbins
                 ? *reinterpret_cast<const int*>(c.slabs + m * plane + rowb + s) : -1;
  }
  __device__ void planes_of(const Cand& c, int s, const int (&w)[4], unsigned (&masks)[4]) const {
    int col[4][4], uc[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int g = static_cast<int8_t>(w[m] >> (8 * t));
        bool dup = false;
#pragma unroll
        for (int m2 = 0; m2 < m; ++m2) dup |= static_cast<int8_t>(w[m2] >> (8 * t)) == g;
        col[t][m] = g >= 0 && g < c.groups && !dup ? g * c.nbins + s + t : -1;
      }
#pragma unroll
    for (int t = 0; t < 4; ++t)            // the uid loads, issued together
#pragma unroll
      for (int m = 0; m < 4; ++m)
        uc[t][m] = c.uid_rows != nullptr && col[t][m] >= 0 ? c.uid_cols[col[t][m]] : 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      unsigned mask = 0u;
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (col[t][m] >= 0 &&
            (c.uid_rows == nullptr || uc[t][m] != urow || col[t][m] == self_col))
          mask |= 1u << m;
      masks[t] = mask;
    }
  }
  __device__ void planes(const Cand& c, int s, const int (&w)[4], unsigned (&masks)[4]) const {
    if (words) {
      planes_of(c, s, w, masks);
      return;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      unsigned mask = 0u;
      for (int m = 0; s + t < c.nbins && m < c.n_mod; ++m) {
        const int g = group(c, m, s + t);
        bool dup = false;
        for (int m2 = 0; m2 < m && !dup; ++m2) dup = group(c, m2, s + t) == g;
        if (!dup && kept(c, g, s + t, urow, self_col)) mask |= 1u << m;
      }
      masks[t] = mask;
    }
  }
  __device__ int column(const Cand& c, unsigned m, int s) const {
    return group(c, __ffs(m) - 1, s) * c.nbins + s;
  }
};

constexpr int kRound = 3;   // slot words a lane loads together: 3 x 128 slots a round

// Row i's entry count.
__device__ void count_row(const Cand& c, const Lists& L, int i, int lane) {
  const RowWalk rw(c, i);
  int total = 0;
  for (int s0 = 4 * lane; s0 < c.nbins; s0 += 128 * kRound) {
    int w[kRound][4];
#pragma unroll
    for (int k = 0; k < kRound; ++k)
      if (rw.words) rw.load(c, s0 + 128 * k, w[k]);
#pragma unroll
    for (int k = 0; k < kRound; ++k) {
      const int s = s0 + 128 * k;
      if (s >= c.nbins) break;
      unsigned masks[4];
      rw.planes(c, s, w[k], masks);
      total += __popc(masks[0]) + __popc(masks[1]) + __popc(masks[2]) + __popc(masks[3]);
    }
  }
  total = __reduce_add_sync(kFull, total);
  if (lane == 0) L.a[kRowCnt][i] = total;
}

// Row i's list, in slot order; each entry's row into colrows (sort_col
// overwrites it) and a count for its column.
__device__ void fill_row(const Cand& c, const Lists& L, int i, int lane) {
  const RowWalk rw(c, i);
  int* out = L.a[kRowCols] + L.a[kRowPtr][i];
  int* rows = L.a[kColRows] + L.a[kRowPtr][i];
  int done = 0;
  for (int s0 = 0; s0 < c.nbins; s0 += 128 * kRound) {
    int w[kRound][4];
#pragma unroll
    for (int k = 0; k < kRound; ++k)
      if (rw.words) rw.load(c, s0 + 128 * k + 4 * lane, w[k]);
#pragma unroll
    for (int k = 0; k < kRound; ++k) {
      if (s0 + 128 * k >= c.nbins) break;
      const int s = s0 + 128 * k + 4 * lane;
      unsigned masks[4] = {0u, 0u, 0u, 0u};
      if (s < c.nbins) rw.planes(c, s, w[k], masks);
      const int cnt = __popc(masks[0]) + __popc(masks[1]) + __popc(masks[2]) + __popc(masks[3]);
      const int incl = warp_incl_scan(cnt, lane);
      int pos = done + incl - cnt;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        for (unsigned m = masks[t]; m; m &= m - 1) {
          const int col = rw.column(c, m, s + t);
          rows[pos] = i;                 // each entry's row, for bucket_cols
          out[pos++] = col;
          atomicAdd(L.a[kColCnt] + col, 1);
        }
      done += __shfl_sync(kFull, incl, 31);
    }
  }
}

// Each entry's row into its column's bucket (in no order: sort_col orders
// each bucket); colcnt counts down to 0.
__device__ void bucket_cols(const Cand& c, const Lists& L, int t, int threads) {
  const int total = L.a[kRowPtr][c.block];
  for (int e = t; e < total; e += threads) {
    const int col = L.a[kRowCols][e];
    L.a[kColTmp][L.a[kColPtr][col] + atomicSub(L.a[kColCnt] + col, 1) - 1] = L.a[kColRows][e];
  }
}

// Column col's rows ascending (each row appears once per column): a rank
// by shuffles up to 32 rows, else a bitmap of the block's rows in shared
// memory (bits, ceil(block / 32) words for this warp) read in order.  A
// column of more than kHeavy rows joins the hub list (in no order).
__device__ void sort_col(const Lists& L, int col, int lane, unsigned* bits, int words) {
  const int lo = L.a[kColPtr][col], len = L.a[kColPtr][col + 1] - lo;
  const int* src = L.a[kColTmp] + lo;
  int* dst = L.a[kColRows] + lo;
  if (len > kHeavy && lane == 0) L.a[kHubs][atomicAdd(L.a[kNHubs], 1)] = col;   // K4's heavy kernel
  if (len <= 32) {
    const int v = lane < len ? src[lane] : INT_MAX;
    int rank = 0;
    for (int j = 0; j < len; ++j) rank += __shfl_sync(kFull, v, j) < v;
    if (lane < len) dst[rank] = v;
    return;
  }
  for (int w = lane; w < words; w += 32) bits[w] = 0u;
  __syncwarp();
  for (int j = lane; j < len; j += 32) {
    const int v = src[j];
    atomicOr(bits + (v >> 5), 1u << (v & 31));
  }
  __syncwarp();
  int done = 0;
  for (int w0 = 0; w0 < words; w0 += 32) {
    const unsigned b = w0 + lane < words ? bits[w0 + lane] : 0u;
    const int cnt = __popc(b);
    const int incl = warp_incl_scan(cnt, lane);
    int pos = done + incl - cnt;
    for (unsigned m = b; m; m &= m - 1) dst[pos++] = ((w0 + lane) << 5) + __ffs(m) - 1;
    done += __shfl_sync(kFull, incl, 31);
  }
  __syncwarp();            // bits is the next column's
}

// Rows of CTA cta (64 of them) ranked by (uid, row): suid / userrows in
// that order.  Four threads share a row, each counting a quarter of the
// block's rows.
__device__ void rank_rows(const Cand& c, const Lists& L, int cta) {
  constexpr int kStage = kThreads * 8, kRows = kThreads / 4;
  __shared__ int su[kStage];
  __shared__ int part[4][kRows];
  const int i = cta * kRows + (threadIdx.x % kRows), quarter = threadIdx.x / kRows;
  const int mine = i < c.block ? c.uid_rows[i] : 0;
  int rank = 0;
  for (int j0 = 0; j0 < c.block; j0 += kStage) {
    const int nj = min(kStage, c.block - j0);
    __syncthreads();
    for (int j = threadIdx.x; j < nj; j += kThreads) su[j] = c.uid_rows[j0 + j];
    __syncthreads();
    for (int j = quarter; j < nj; j += 4) {
      const int u = su[j];
      rank += (u < mine) | ((u == mine) & (j0 + j < i));
    }
  }
  part[quarter][threadIdx.x % kRows] = rank;
  __syncthreads();
  if (quarter == 0 && i < c.block) {
    const int k = threadIdx.x;
    rank = part[0][k] + part[1][k] + part[2][k] + part[3][k];
    L.a[kSUid][rank] = mine;
    L.a[kUserRows][rank] = i;
  }
}

// One CTA: the distinct uids (ascending), each user's rows, each row's user.
__device__ void number_users(const Cand& c, const Lists& L) {
  const int* su = L.a[kSUid];
  int carry = 0;
  for (int p0 = 0; p0 < c.block; p0 += kThreads) {
    const int p = p0 + threadIdx.x;
    const int fresh = p < c.block && (p == 0 || su[p] != su[p - 1]);
    int tot;
    const int u = carry + block_excl_scan(fresh, &tot) + fresh - 1;
    if (p < c.block) {
      if (fresh) {
        L.a[kUserPtr][u] = p;
        L.a[kUids][u] = su[p];
      }
      L.a[kRowUser][L.a[kUserRows][p]] = u;
    }
    carry += tot;
  }
  if (threadIdx.x == 0) {
    L.a[kNu][0] = carry;
    L.a[kUserPtr][carry] = c.block;
  }
}

// Column col's user (or -1), its count in its chunk, and its username edges.
__device__ void col_users(const Cand& c, const Lists& L, int cta) {
  const int n = c.groups * c.nbins;
  const int col = cta * kThreads + threadIdx.x;
  unsigned long long pairs = 0;
  if (col < n) {
    const int nu = L.a[kNu][0], want = c.uid_cols[col];
    const int* uids = L.a[kUids];
    int lo = 0, hi = nu;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (uids[mid] < want) lo = mid + 1;
      else hi = mid;
    }
    const int u = lo < nu && uids[lo] == want ? lo : -1;
    L.a[kColUser][col] = u;
    if (u >= 0) {
      atomicAdd(L.a[kHist] + static_cast<size_t>(u) * L.q + col / kQCols, 1);
      const long long self = static_cast<long long>(c.g0) * c.nbins + col - c.start;
      const bool own = self >= 0 && self < c.block && L.a[kRowUser][self] == u;
      pairs = L.a[kUserPtr][u + 1] - L.a[kUserPtr][u] - (own ? 1 : 0);
    }
  }
#pragma unroll
  for (int d = 16; d; d >>= 1) pairs += __shfl_down_sync(kFull, pairs, d);
  if ((threadIdx.x & 31) == 0 && pairs) atomicAdd(edges_of(L), pairs);
}

// Exclusive scan in -> out (out[count] = total) by reduce-then-scan over
// tiles of kScanTile; tiles holds the tile sums.
struct Scan {
  const int* in;
  int* out;
  int count;
  int* tiles;
};
struct Scans {
  Scan s[2];
  int ntiles[2];
};

__device__ void scan_reduce(const Scan& s, int t) {
  const int base = t * kScanTile;
  int v = 0;
  for (int j = threadIdx.x; j < kScanTile; j += kThreads)
    if (base + j < s.count) v += s.in[base + j];
  int tot;
  block_excl_scan(v, &tot);
  if (threadIdx.x == 0) s.tiles[t] = tot;
}

__device__ void scan_apply(const Scan& s, int t) {
  constexpr int kPer = kScanTile / kThreads;
  const int base = t * kScanTile;
  int off = 0;
  for (int j = threadIdx.x; j < t; j += kThreads) off += s.tiles[j];
  int before;
  block_excl_scan(off, &before);
  int v[kPer], sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = base + threadIdx.x * kPer + j;
    v[j] = e < s.count ? s.in[e] : 0;
    sum += v[j];
  }
  int tot;
  int run = before + block_excl_scan(sum, &tot);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = base + threadIdx.x * kPer + j;
    if (e < s.count) s.out[e] = run;
    run += v[j];
  }
  if (base + kScanTile >= s.count && threadIdx.x == kThreads - 1) s.out[s.count] = run;
}

// The whole of a short scan in one CTA (the row counts: at most
// kMaxBlock / kScanTile tiles), tile after tile.
__device__ void scan_whole(const Scan& s) {
  constexpr int kPer = kScanTile / kThreads;
  int carry = 0;
  for (int base = 0; base < s.count; base += kScanTile) {
    int v[kPer], sum = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = base + threadIdx.x * kPer + j;
      v[j] = e < s.count ? s.in[e] : 0;
      sum += v[j];
    }
    int tot;
    int run = carry + block_excl_scan(sum, &tot);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = base + threadIdx.x * kPer + j;
      if (e < s.count) s.out[e] = run;
      run += v[j];
    }
    carry += tot;
  }
  if (threadIdx.x == 0) s.out[s.count] = carry;
}

__device__ __forceinline__ bool pick_scan(const Scans& S, int narr, int* t, int* a) {
  for (*a = 0; *a < narr; ++*a) {
    if (*t < S.ntiles[*a]) return true;
    *t -= S.ntiles[*a];
  }
  return false;
}

// Launch 1: row counts (a warp per row); with usernames, the row ranks.
__global__ void __launch_bounds__(kThreads) lists_count_kernel(Cand c, Lists L, int row_ctas) {
  if (blockIdx.x < row_ctas) {
    const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (i < c.block) count_row(c, L, i, threadIdx.x & 31);
  } else {
    rank_rows(c, L, blockIdx.x - row_ctas);
  }
}

// Launch 2: rowptr, the row counts' scan (one CTA); with usernames, a
// second CTA numbers the users.
__global__ void __launch_bounds__(kThreads) rows_scan_kernel(Cand c, Lists L) {
  if (blockIdx.x == 0) scan_whole(Scan{L.a[kRowCnt], L.a[kRowPtr], c.block, nullptr});
  else number_users(c, L);
}

// Launch 3: the row lists and the column counts; with usernames, the
// columns' users and chunk counts; the edge count.
__global__ void __launch_bounds__(kThreads) lists_fill_kernel(Cand c, Lists L, int row_ctas) {
  if (blockIdx.x < row_ctas) {
    if (blockIdx.x == 0 && threadIdx.x == 0)
      atomicAdd(edges_of(L), static_cast<unsigned long long>(L.a[kRowPtr][c.block]));
    const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (i < c.block) fill_row(c, L, i, threadIdx.x & 31);
  } else {
    col_users(c, L, blockIdx.x - row_ctas);
  }
}

// Launches 4 and 5: the scans of the column counts and of the user-column
// chunk counts (reduce, then apply), tile t of the arrays in turn.
__global__ void __launch_bounds__(kThreads) scan_reduce_kernel(Scans S, int narr) {
  int t = blockIdx.x, a;
  if (pick_scan(S, narr, &t, &a)) scan_reduce(S.s[a], t);
}

__global__ void __launch_bounds__(kThreads) scan_apply_kernel(Scans S, int narr) {
  int t = blockIdx.x, a;
  if (pick_scan(S, narr, &t, &a)) scan_apply(S.s[a], t);
}

// Launch 6: each entry's row into its column's bucket (grid-stride).
__global__ void __launch_bounds__(kThreads) bucket_kernel(Cand c, Lists L) {
  bucket_cols(c, L, blockIdx.x * kThreads + threadIdx.x, gridDim.x * kThreads);
}

// Launch 7: each column bucket in row order.  Dynamic shared memory: a row
// bitmap per warp.
__global__ void __launch_bounds__(kThreads) lists_sort_kernel(Cand c, Lists L) {
  extern __shared__ unsigned bitmaps[];
  const int words = (c.block + 31) / 32, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kWarps + warp;
  if (col < c.groups * c.nbins) sort_col(L, col, threadIdx.x & 31, bitmaps + warp * words, words);
}

// Launch 8: chunk q's columns into their users' lists, in column order.
// Dynamic shared memory: block + kQCols ints.
__global__ void __launch_bounds__(kThreads) user_cols_kernel(Cand c, Lists L) {
  extern __shared__ int sm[];
  int* cur = sm;
  int* cu = sm + c.block;
  const int q = blockIdx.x, n = c.groups * c.nbins, nu = L.a[kNu][0];
  for (int u = threadIdx.x; u < nu; u += kThreads)
    cur[u] = L.a[kHOff][static_cast<size_t>(u) * L.q + q];
  const int c0 = q * kQCols, len = min(kQCols, n - c0);
  for (int j = threadIdx.x; j < len; j += kThreads) cu[j] = L.a[kColUser][c0 + j];
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  for (int b = 0; b < len; b += 32) {
    const int u = b + lane < len ? cu[b + lane] : -1;
    const unsigned peers = __match_any_sync(kFull, u);
    if (u >= 0) L.a[kUCols][cur[u] + __popc(peers & ((1u << lane) - 1u))] = c0 + b + lane;
    __syncwarp();
    if (u >= 0 && lane == __ffs(peers) - 1) cur[u] += __popc(peers);
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// segmented sums: the per-user sums and K4
// ---------------------------------------------------------------------------

// out[u, k] = sum over the entries e of segment u (ptr[u * pstride] ..
// ptr[(u + 1) * pstride]) of v[idx[e] * istride + k * kstride], in entry
// order; item_seg[idx[e]] is entry e's segment.  out (zero on entry: an
// empty segment stays 0) and arrive are zeroed by the launch.
// Lanes hold the k of this r chunk (32 * VPL values from blockIdx.y * 32 *
// VPL).  Persistent warps take chunks of ch entries: chunk w writes the
// segments that start and end in it, and leaves a piece of each segment
// that crosses one of its ends (slot 2w: began before it, 2w + 1: goes on
// after it); the warp that leaves a segment's last piece (counted in
// arrive, zero on entry) adds its pieces in chunk order.  So a segment of
// any length (a user owning the window) is summed by many warps, and the
// sums do not depend on the launch.
template <int VPL>
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const int* ptr, int pstride, const int* nseg_p, int nseg_max, const int* idx,
              const int* item_seg, int ch, const __nv_bfloat16* __restrict__ v, int r,
              long long kstride, long long istride, float* piece, int* arrive, float* out) {
  constexpr int kAhead = VPL <= 2 ? 16 : 8;    // entries whose values are loaded together
  const int lane = threadIdx.x & 31;
  const int kbase = blockIdx.y * 32 * VPL + lane;
  const int nseg = *nseg_p;
  if (nseg == 0) return;
  auto at = [&](int u) { return ptr[static_cast<size_t>(u) * pstride]; };
  const int total = at(nseg);
  int* arr = arrive + static_cast<size_t>(blockIdx.y) * nseg_max;
  const int warps = gridDim.x * kWarps;
  for (int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
       static_cast<long long>(w) * ch < total; w += warps) {
    const int e0 = w * ch, e1 = min(e0 + ch, total), cend = e0 + ch;
    int u = item_seg[idx[e0]];         // the segment of the chunk's first entry
    // segment bounds at(base + lane), held by the lanes
    int base = u;
    int bound = base + lane <= nseg ? at(base + lane) : INT_MAX;
    auto start_of = [&](int seg) {
      if (seg < base || seg - base > 30) {
        base = seg;
        bound = base + lane <= nseg ? at(base + lane) : INT_MAX;
      }
      return __shfl_sync(kFull, bound, seg - base);
    };
    float acc[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) acc[j] = 0.f;
    auto write = [&](int seg, const float (&sum)[VPL]) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int k = kbase + 32 * j;
        if (k < r) out[static_cast<size_t>(seg) * r + k] = sum[j];
      }
    };
    auto finish = [&](int seg) {       // segment seg's entries in this chunk are in acc
      const int s_lo = start_of(seg), s_hi = start_of(seg + 1);
      if (s_lo >= e0 && s_hi <= cend) {
        write(seg, acc);
      } else {
        const int slot = s_lo < e0 ? 2 * w : 2 * w + 1;
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const int k = kbase + 32 * j;
          if (k < r) piece[static_cast<size_t>(slot) * r + k] = acc[j];
        }
        __threadfence();
        __syncwarp();
        const int wa = s_lo / ch, wb = (s_hi - 1) / ch;
        int last = 0;
        if (lane == 0) last = atomicAdd(arr + seg, 1) == wb - wa;
        if (__shfl_sync(kFull, last, 0)) {
          __threadfence();
          float sum[VPL];
#pragma unroll
          for (int j = 0; j < VPL; ++j) {
            const int k = kbase + 32 * j;
            if (k >= r) continue;
            sum[j] = __ldcg(piece + static_cast<size_t>(2 * wa + 1) * r + k);
            for (int w2 = wa + 1; w2 <= wb; ++w2)
              sum[j] += __ldcg(piece + static_cast<size_t>(2 * w2) * r + k);
          }
          write(seg, sum);
        }
      }
#pragma unroll
      for (int j = 0; j < VPL; ++j) acc[j] = 0.f;
    };
    int s_hi = start_of(u + 1);
    for (int b = e0; b < e1; b += 32) {
      const int mine = b + lane < e1 ? idx[b + lane] : 0;
      const int cnt = min(32, e1 - b);
      for (int t = 0; t < cnt; t += kAhead) {
        float x[kAhead][VPL];
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
          const __nv_bfloat16* row =
              v + static_cast<long long>(__shfl_sync(kFull, mine, (t + a) & 31)) * istride;
#pragma unroll
          for (int j = 0; j < VPL; ++j) {
            const int k = kbase + 32 * j;
            x[a][j] = t + a < cnt && k < r ? __bfloat162float(row[k * kstride]) : 0.f;
          }
        }
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
          if (t + a >= cnt) break;
          const int e = b + t + a;
          while (s_hi <= e) {          // the segments that end before entry e
            finish(u);
            ++u;
            s_hi = start_of(u + 1);
          }
#pragma unroll
          for (int j = 0; j < VPL; ++j) acc[j] += x[a][j];
        }
      }
    }
    // the segment in progress, then the empty ones that start before cend
    while (u < nseg && start_of(u) < cend) {
      finish(u);
      ++u;
    }
  }
}

// ---------------------------------------------------------------------------
// K4: column gather
// ---------------------------------------------------------------------------

// x_t (r, block) -> xr (block, rp): rows of x contiguous, rp = r rounded up
// to 8 (16-byte rows; the pad columns 0).
__global__ void __launch_bounds__(kThreads)
transpose_kernel(const __nv_bfloat16* __restrict__ x_t, int r, int block, int rp,
                 __nv_bfloat16* __restrict__ xr) {
  __shared__ __nv_bfloat16 t[32][34];
  const int i0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int dy = ty; dy < 32; dy += kWarps) {
    const int k = k0 + dy, i = i0 + tx;
    t[dy][tx] = k < r && i < block ? x_t[static_cast<size_t>(k) * block + i]
                                   : __float2bfloat16(0.f);
  }
  __syncthreads();
  for (int dy = ty; dy < 32; dy += kWarps) {
    const int i = i0 + dy, k = k0 + tx;
    if (i < block && k < rp) xr[static_cast<size_t>(i) * rp + k] = t[tx][dy];
  }
}

// K4's username term for column col at values k0 .. k0 + cnt of acc: the
// column's user's rows (usum), less its own row when that is one of them.
struct UserTerm {
  const int* col_user;          // null: no usernames
  const int* row_user;
  const float* usum;            // (users, r)
  long long self_base;          // column c's own row is self_base + c
  int block;
  __device__ int own_row(int col, int u) const {
    const long long i = self_base + col;
    return i >= 0 && i < block && row_user[i] == u ? static_cast<int>(i) : -1;
  }
};

// The light columns (kHeavy entries or fewer): a thread per column and r
// tile of R values.  The CTA stages x's rows [i0, i0 + rows) of the tile
// (xs[i][k] = xr[i0 + i, r0 + k], 16-byte loads) and each thread sums its
// column's staged rows in row order (8 list indices loaded together) in R
// f32 registers, adds the username term and writes its out_t values (a
// warp's 32 columns coalesced).  A block longer than rows runs in row
// chunks, each adding to what the last wrote.
template <int R>
__global__ void __launch_bounds__(kT4Threads, 2)
matvec_t_light_kernel(Cand c, Lists L, const __nv_bfloat16* __restrict__ xr, int r, int rp,
                      int rows, UserTerm ut, float* __restrict__ out_t) {
  extern __shared__ __align__(16) uint8_t smem4[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int tid = threadIdx.x, r0 = blockIdx.y * R;
  const int n = c.groups * c.nbins;
  const int* colptr = L.a[kColPtr];
  const int* colrows = L.a[kColRows];
  for (int i0 = 0; i0 < c.block; i0 += rows) {
    const int i1 = min(i0 + rows, c.block), nrow = i1 - i0;
    __syncthreads();                   // the last chunk's tile is no longer read
    for (int p = tid; p < nrow * (R / 8); p += kT4Threads) {
      const int i = p / (R / 8), q = p - i * (R / 8);
      reinterpret_cast<uint4*>(xs)[p] =
          r0 + 8 * q < rp ? *reinterpret_cast<const uint4*>(xr + static_cast<size_t>(i0 + i) * rp +
                                                            r0 + 8 * q)
                          : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    const bool first = i0 == 0, last = i1 == c.block;
    for (int col = blockIdx.x * kT4Threads + tid; col < n; col += gridDim.x * kT4Threads) {
      int e = colptr[col];
      const int e1 = colptr[col + 1];
      if (e1 - e > kHeavy) continue;   // the heavy kernel's column
      float acc[R];
#pragma unroll
      for (int k = 0; k < R; ++k)
        acc[k] = first || r0 + k >= r ? 0.f : out_t[static_cast<size_t>(r0 + k) * n + col];
      for (; e < e1; e += 8) {
        int ix[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) ix[a] = e + a < e1 ? colrows[e + a] : INT_MAX;
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          if (ix[a] < i0 || ix[a] >= i1) continue;
          const uint4* xv = reinterpret_cast<const uint4*>(xs + (ix[a] - i0) * R);
#pragma unroll
          for (int q = 0; q < R / 8; ++q) {
            const uint4 w = xv[q];
            acc[8 * q + 0] += bf_lo(w.x);
            acc[8 * q + 1] += bf_hi(w.x);
            acc[8 * q + 2] += bf_lo(w.y);
            acc[8 * q + 3] += bf_hi(w.y);
            acc[8 * q + 4] += bf_lo(w.z);
            acc[8 * q + 5] += bf_hi(w.z);
            acc[8 * q + 6] += bf_lo(w.w);
            acc[8 * q + 7] += bf_hi(w.w);
          }
        }
      }
      if (last && ut.col_user != nullptr) {
        const int u = ut.col_user[col];
        if (u >= 0) {
#pragma unroll
          for (int k = 0; k < R; ++k)
            if (r0 + k < r) acc[k] += ut.usum[static_cast<size_t>(u) * r + r0 + k];
          const int self = ut.own_row(col, u);
          if (self >= 0) {
#pragma unroll
            for (int k = 0; k < R; ++k)
              if (r0 + k < r)
                acc[k] -= __bfloat162float(xr[static_cast<size_t>(self) * rp + r0 + k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (r0 + k < r) out_t[static_cast<size_t>(r0 + k) * n + col] = acc[k];
    }
  }
}

// The heavy columns (more than kHeavy entries, listed in hubs): a CTA per
// column and r chunk of 64 WPL values.  Its warps sum contiguous eighths of
// the column's rows (lanes hold bf16 pairs of x's rows, 16 rows loaded
// together), then the eighths are added in warp order, the username term
// added, and the column's out_t values written.
template <int WPL>
__global__ void __launch_bounds__(kThreads)
matvec_t_heavy_kernel(Cand c, Lists L, const __nv_bfloat16* __restrict__ xr, int r, int rp,
                      UserTerm ut, float* __restrict__ out_t) {
  constexpr int kVals = 64 * WPL, kAhead = WPL <= 2 ? 16 : 8;
  __shared__ float part[kWarps][kVals];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = c.groups * c.nbins, kb = blockIdx.y * kVals;
  const int nhubs = L.a[kNHubs][0];
  for (int h = blockIdx.x; h < nhubs; h += gridDim.x) {
    const int col = L.a[kHubs][h];
    const int c0 = L.a[kColPtr][col], len = L.a[kColPtr][col + 1] - c0;
    const int lo = c0 + len * warp / kWarps, hi = c0 + len * (warp + 1) / kWarps;
    float acc[WPL][2];
#pragma unroll
    for (int q = 0; q < WPL; ++q) acc[q][0] = acc[q][1] = 0.f;
    for (int b = lo; b < hi; b += 32) {
      const int mine = b + lane < hi ? L.a[kColRows][b + lane] : 0;
      const int cnt = min(32, hi - b);
      for (int t = 0; t < cnt; t += kAhead) {
        uint32_t w[kAhead][WPL];
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
          const int i = __shfl_sync(kFull, mine, (t + a) & 31);
#pragma unroll
          for (int q = 0; q < WPL; ++q) {
            const int k = kb + 2 * (lane + 32 * q);
            w[a][q] = t + a < cnt && k < rp
                          ? *reinterpret_cast<const uint32_t*>(xr + static_cast<size_t>(i) * rp + k)
                          : 0u;
          }
        }
#pragma unroll
        for (int a = 0; a < kAhead; ++a)
#pragma unroll
          for (int q = 0; q < WPL; ++q)
            if (t + a < cnt) {
              acc[q][0] += bf_lo(w[a][q]);
              acc[q][1] += bf_hi(w[a][q]);
            }
      }
    }
#pragma unroll
    for (int q = 0; q < WPL; ++q) {
      part[warp][2 * (lane + 32 * q)] = acc[q][0];
      part[warp][2 * (lane + 32 * q) + 1] = acc[q][1];
    }
    __syncthreads();
    const int u = ut.col_user != nullptr ? ut.col_user[col] : -1;
    const int self = u >= 0 ? ut.own_row(col, u) : -1;
    for (int v = threadIdx.x; v < kVals && kb + v < r; v += kThreads) {
      float s = part[0][v];
      for (int w2 = 1; w2 < kWarps; ++w2) s += part[w2][v];
      if (u >= 0) {
        s += ut.usum[static_cast<size_t>(u) * r + kb + v];
        if (self >= 0) s -= __bfloat162float(xr[static_cast<size_t>(self) * rp + kb + v]);
      }
      out_t[static_cast<size_t>(kb + v) * n + col] = s;
    }
    __syncthreads();                   // part is the next column's
  }
}

// ---------------------------------------------------------------------------
// K5: row gather
// ---------------------------------------------------------------------------

// out[i, k] for the r chunk of blockIdx.y: a warp per block row, lane items
// lane + 32 j (j < WPL); an item is a bf16 pair (PAIR: r even, y 4-byte
// aligned) or one value.
template <int WPL, bool PAIR>
__global__ void __launch_bounds__(kThreads)
matvec_kernel(Cand c, Lists L, const __nv_bfloat16* __restrict__ y, int r,
              const float* __restrict__ vsum, float* __restrict__ out) {
  constexpr int kV = PAIR ? 2 : 1;
  constexpr int kAhead = 16;           // list entries whose rows are loaded together
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= c.block) return;
  const int n = c.groups * c.nbins;
  int kk[WPL];                         // first value of each item
  bool live[WPL];
#pragma unroll
  for (int j = 0; j < WPL; ++j) {
    kk[j] = (blockIdx.y * 32 * WPL + lane + 32 * j) * kV;
    live[j] = kk[j] < r;
  }
  float acc[WPL][kV];
#pragma unroll
  for (int j = 0; j < WPL; ++j)
#pragma unroll
    for (int h = 0; h < kV; ++h) acc[j][h] = 0.f;
  auto load = [&](int col, int j) -> uint32_t {
    const __nv_bfloat16* row = y + static_cast<size_t>(col) * r + kk[j];
    if (PAIR) return *reinterpret_cast<const uint32_t*>(row);
    return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(row)) << 16;
  };
  auto add = [&](uint32_t w, int j, float sign) {
    if (PAIR) {
      acc[j][0] += sign * bf_lo(w);
      acc[j][kV - 1] += sign * bf_hi(w);
    } else {
      acc[j][0] += sign * bf_hi(w);
    }
  };
  const int e0 = L.a[kRowPtr][i], e1 = L.a[kRowPtr][i + 1];
  const int* cols = L.a[kRowCols];
  for (int b = e0; b < e1; b += 32) {
    const int mine = b + lane < e1 ? cols[b + lane] : 0;
    const int cnt = min(32, e1 - b);
    for (int t = 0; t < cnt; t += kAhead) {
      uint32_t w[kAhead][WPL];
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        const int col = __shfl_sync(kFull, mine, (t + a) & 31);
#pragma unroll
        for (int j = 0; j < WPL; ++j) w[a][j] = t + a < cnt && live[j] ? load(col, j) : 0u;
      }
#pragma unroll
      for (int a = 0; a < kAhead; ++a)
#pragma unroll
        for (int j = 0; j < WPL; ++j)
          if (t + a < cnt && live[j]) add(w[a][j], j, 1.f);
    }
  }
  if (c.uid_rows != nullptr) {         // the row's user's columns, less its own
    const int u = L.a[kRowUser][i];
#pragma unroll
    for (int j = 0; j < WPL; ++j)
#pragma unroll
      for (int h = 0; h < kV; ++h)
        if (live[j]) acc[j][h] += vsum[static_cast<size_t>(u) * r + kk[j] + h];
    const long long self = static_cast<long long>(c.start) + i - static_cast<long long>(c.g0) * c.nbins;
    if (self >= 0 && self < n && L.a[kColUser][self] == u) {
#pragma unroll
      for (int j = 0; j < WPL; ++j)
        if (live[j]) add(load(static_cast<int>(self), j), j, -1.f);
    }
  }
#pragma unroll
  for (int j = 0; j < WPL; ++j) {
    if (!live[j]) continue;
    float* dst = out + static_cast<size_t>(i) * r + kk[j];
    if (PAIR) *reinterpret_cast<float2*>(dst) = make_float2(acc[j][0], acc[j][kV - 1]);
    else dst[0] = acc[j][0];
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  return sms;
}

int tiles_of(long long count) {
  return count <= 0 ? 1 : static_cast<int>((count + kScanTile - 1) / kScanTile);
}

int chunks_of(int n) { return (n + kQCols - 1) / kQCols; }

// 4-byte words of K4's transposed x (block, rp) bf16, rounded up to 16 bytes.
long long xr_words(int block, int rp) {
  return (static_cast<long long>(block) * rp / 2 + 3) / 4 * 4;
}

Cand make_cand(const void* slabs, const void* uid_rows, const void* uid_cols, int n_mod,
               int block, int nbins, int groups, int start, int g0) {
  return Cand{static_cast<const int8_t*>(slabs), static_cast<const int*>(uid_rows),
              static_cast<const int*>(uid_cols), n_mod, block, nbins, groups, start, g0};
}

// What the list kernels take: up to 32 planes (plane bit masks), kMaxBlock
// rows (the row rank), int8 group ids, int32 entry and chunk offsets.
bool cand_ok(int n_mod, int block, int nbins, int groups) {
  return n_mod > 0 && n_mod <= 32 && block > 0 && block <= kMaxBlock && nbins > 0 &&
         groups > 0 && groups <= 127 &&
         static_cast<long long>(groups) * nbins < (1LL << 30) &&
         static_cast<long long>(block) * chunks_of(groups * nbins) < INT_MAX;
}

// The lists' arrays in one int32 workspace, in Buf order, each 16-byte
// aligned: offsets and sizes in words; returns the workspace's words.
long long list_layout(int n_mod, int block, int nbins, int groups, long long* offsets,
                      long long* sizes) {
  const long long n = static_cast<long long>(groups) * nbins, b = block;
  const long long cap = b * nbins * (n_mod < groups ? n_mod : groups);
  const long long q = chunks_of(static_cast<int>(n));
  const long long s[kNumBufs] = {
      b + 1, cap, n + 1, cap, cap, b, b, b + 1, b, b, 1, b, n, b * q + 1, n,
      tiles_of(n) + tiles_of(b * q), n, n, 2, 1, b * q};
  long long total = 0;
  for (int k = 0; k < kNumBufs; ++k) {
    offsets[k] = total;
    sizes[k] = s[k];
    total += (s[k] + 3) / 4 * 4;
  }
  return total;
}

Lists make_lists(void* workspace, int n_mod, int block, int nbins, int groups) {
  long long offsets[kNumBufs], sizes[kNumBufs];
  list_layout(n_mod, block, nbins, groups, offsets, sizes);
  Lists L;
  for (int b = 0; b < kNumBufs; ++b) L.a[b] = static_cast<int*>(workspace) + offsets[b];
  L.q = chunks_of(groups * nbins);
  return L;
}

// Scratch of the per-user sums: sums (nseg_max, r) f32, arrive (r chunks,
// nseg_max) int, pieces (2 (total_max / ch + 1), r) f32.
int seg_vpl(int r) { return r >= 256 ? 8 : (r + 31) / 32; }
int seg_rchunks(int r) { return (r + 32 * seg_vpl(r) - 1) / (32 * seg_vpl(r)); }
long long seg_words(int nseg_max, long long total_max, int ch, int r) {
  return static_cast<long long>(nseg_max) * r + static_cast<long long>(seg_rchunks(r)) * nseg_max +
         2 * (total_max / ch + 1) * r;
}

// K4's x rows are r rounded up to 8 values: 16-byte rows.
int rp8(int r) { return (r + 7) / 8 * 8; }

template <int VPL>
cudaError_t launch_segsum_vpl(const int* ptr, int pstride, const int* nseg_p, int nseg_max,
                              const int* idx, const int* item_seg, long long total_max, int ch,
                              const void* v, int r, long long kstride, long long istride,
                              float* piece, int* arrive, float* out, cudaStream_t st) {
  const long long ctas_needed = (total_max / ch + 1 + kWarps - 1) / kWarps;
  const int ctas = static_cast<int>(ctas_needed < 8LL * sm_count() ? ctas_needed : 8LL * sm_count());
  segsum_kernel<VPL><<<dim3(ctas, seg_rchunks(r)), kThreads, 0, st>>>(
      ptr, pstride, nseg_p, nseg_max, idx, item_seg, ch, static_cast<const __nv_bfloat16*>(v),
      r, kstride, istride, piece, arrive, out);
  return cudaGetLastError();
}

// The per-user sums, over scratch laid out as seg_words says (sums, then
// arrive: one memset zeroes both).
cudaError_t launch_segsum(const int* ptr, int pstride, const int* nseg_p, int nseg_max,
                          const int* idx, const int* item_seg, long long total_max, int ch,
                          const void* v, int r, long long kstride, long long istride,
                          void* scratch, cudaStream_t st) {
  float* sums = static_cast<float*>(scratch);
  int* arrive = reinterpret_cast<int*>(sums + static_cast<size_t>(nseg_max) * r);
  float* piece = reinterpret_cast<float*>(arrive + static_cast<size_t>(seg_rchunks(r)) * nseg_max);
  cudaError_t e = cudaMemsetAsync(
      sums, 0, (static_cast<size_t>(nseg_max) * r + static_cast<size_t>(seg_rchunks(r)) * nseg_max) * 4,
      st);
  if (e != cudaSuccess) return e;
  switch (seg_vpl(r)) {
#define SEG(V)                                                                               \
  case V:                                                                                    \
    return launch_segsum_vpl<V>(ptr, pstride, nseg_p, nseg_max, idx, item_seg, total_max, ch, \
                                v, r, kstride, istride, piece, arrive, sums, st);
    SEG(1) SEG(2) SEG(3) SEG(4) SEG(5) SEG(6) SEG(7) SEG(8)
#undef SEG
    default: return cudaErrorInvalidValue;
  }
}

template <int R>
cudaError_t launch_matvec_t_light(const Cand& c, const Lists& L, const __nv_bfloat16* xr, int r,
                                  int rp, const UserTerm& ut, void* out_t, cudaStream_t s) {
  int rows = kT4Smem / (R * 2) / 8 * 8;
  if (rows > c.block) rows = c.block;
  const size_t smem = static_cast<size_t>(rows) * R * 2;
  const cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&matvec_t_light_kernel<R>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int n = c.groups * c.nbins, tiles = (r + R - 1) / R;
  const int col_ctas = (n + kT4Threads - 1) / kT4Threads;
  int ctas = (2 * sm_count() + tiles - 1) / tiles;
  if (ctas > col_ctas) ctas = col_ctas;
  matvec_t_light_kernel<R><<<dim3(ctas, tiles), kT4Threads, smem, s>>>(
      c, L, xr, r, rp, rows, ut, static_cast<float*>(out_t));
  return cudaGetLastError();
}

template <int WPL>
cudaError_t launch_matvec_t_heavy(const Cand& c, const Lists& L, const __nv_bfloat16* xr, int r,
                                  int rp, const UserTerm& ut, void* out_t, cudaStream_t s) {
  const dim3 grid(4 * sm_count(), (rp + 64 * WPL - 1) / (64 * WPL));
  matvec_t_heavy_kernel<WPL><<<grid, kThreads, 0, s>>>(c, L, xr, r, rp, ut,
                                                       static_cast<float*>(out_t));
  return cudaGetLastError();
}

template <int WPL, bool PAIR>
cudaError_t launch_matvec(const Cand& c, const Lists& L, const void* y, int r, const float* vsum,
                          void* out, cudaStream_t s) {
  constexpr int kV = PAIR ? 2 : 1;
  const int items = (r + kV - 1) / kV;
  const dim3 grid((c.block + kWarps - 1) / kWarps, (items + 32 * WPL - 1) / (32 * WPL));
  matvec_kernel<WPL, PAIR><<<grid, kThreads, 0, s>>>(
      c, L, static_cast<const __nv_bfloat16*>(y), r, vsum, static_cast<float*>(out));
  return cudaGetLastError();
}

template <bool PAIR>
cudaError_t dispatch_matvec(const Cand& c, const Lists& L, const void* y, int r,
                            const float* vsum, void* out, cudaStream_t s) {
  const int items = PAIR ? (r + 1) / 2 : r;
  const int wpl = items <= 32 ? 1 : items <= 64 ? 2 : items <= 96 ? 3 : 4;
  switch (wpl) {
    case 1: return launch_matvec<1, PAIR>(c, L, y, r, vsum, out, s);
    case 2: return launch_matvec<2, PAIR>(c, L, y, r, vsum, out, s);
    case 3: return launch_matvec<3, PAIR>(c, L, y, r, vsum, out, s);
    default: return launch_matvec<4, PAIR>(c, L, y, r, vsum, out, s);
  }
}

}  // namespace

extern "C" {

// The names of the lists' arrays, comma-separated, in workspace order.
const char* mused_cand_list_names() { return kListNames; }

// The lists' workspace for a block of n_mod planes: each array's offset and
// size (int32 words, in mused_cand_list_names order), the workspace's
// words, and q, the column chunks of the user-column sort.  Returns
// cudaErrorInvalidValue for a block the list kernels do not take (cand_ok).
int mused_cand_lists_layout(int n_mod, int block, int nbins, int groups, long long* offsets,
                            long long* sizes, long long* words, int* q) {
  if (!cand_ok(n_mod, block, nbins, groups)) return static_cast<int>(cudaErrorInvalidValue);
  *words = list_layout(n_mod, block, nbins, groups, offsets, sizes);
  *q = chunks_of(groups * nbins);
  return 0;
}

// The lists of one candidate block (see the header note): slabs (n_mod,
// block, nbins) int8; uid_rows (block,) int32 or null; uid_cols (groups,
// nbins) int32; workspace of mused_cand_lists_layout's words.
int mused_cand_lists(const void* slabs, const void* uid_rows, const void* uid_cols, int n_mod,
                     int block, int nbins, int groups, int start, int g0, void* workspace,
                     void* stream) {
  if (!cand_ok(n_mod, block, nbins, groups)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Cand c = make_cand(slabs, uid_rows, uid_cols, n_mod, block, nbins, groups, start, g0);
  const Lists L = make_lists(workspace, n_mod, block, nbins, groups);
  const int q = L.q;
  const bool user = uid_rows != nullptr;
  const int n = groups * nbins;
  const int row_ctas = (block + kWarps - 1) / kWarps;
  const int* zero_end = user ? L.a[kHist] + static_cast<size_t>(block) * q : L.a[kNHubs] + 1;
  cudaError_t e = cudaMemsetAsync(L.a[kColCnt], 0,
                                  reinterpret_cast<const char*>(zero_end) -
                                      reinterpret_cast<const char*>(L.a[kColCnt]), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto launched = [&]() { return (e = cudaGetLastError()) == cudaSuccess; };
  const int rank_ctas = user ? (block + kThreads / 4 - 1) / (kThreads / 4) : 0;
  lists_count_kernel<<<row_ctas + rank_ctas, kThreads, 0, s>>>(c, L, row_ctas);
  if (!launched()) return static_cast<int>(e);
  rows_scan_kernel<<<user ? 2 : 1, kThreads, 0, s>>>(c, L);
  if (!launched()) return static_cast<int>(e);
  const int colu_ctas = user ? (n + kThreads - 1) / kThreads : 0;
  lists_fill_kernel<<<row_ctas + colu_ctas, kThreads, 0, s>>>(c, L, row_ctas);
  if (!launched()) return static_cast<int>(e);

  Scans cols{};                        // column counts, and the user-column chunk counts
  cols.s[0] = Scan{L.a[kColCnt], L.a[kColPtr], n, L.a[kTiles]};
  cols.ntiles[0] = tiles_of(n);
  cols.s[1] = Scan{L.a[kHist], L.a[kHOff], block * q, L.a[kTiles] + tiles_of(n)};
  cols.ntiles[1] = user ? tiles_of(static_cast<long long>(block) * q) : 0;
  scan_reduce_kernel<<<cols.ntiles[0] + cols.ntiles[1], kThreads, 0, s>>>(cols, 2);
  if (!launched()) return static_cast<int>(e);
  scan_apply_kernel<<<cols.ntiles[0] + cols.ntiles[1], kThreads, 0, s>>>(cols, 2);
  if (!launched()) return static_cast<int>(e);
  const long long cap = static_cast<long long>(block) * nbins * (n_mod < groups ? n_mod : groups);
  const int entry_ctas = static_cast<int>(
      (cap + kThreads - 1) / kThreads < 8LL * sm_count() ? (cap + kThreads - 1) / kThreads
                                                         : 8LL * sm_count());
  bucket_kernel<<<entry_ctas, kThreads, 0, s>>>(c, L);
  if (!launched()) return static_cast<int>(e);

  const int sort_ctas = (n + kWarps - 1) / kWarps;
  const size_t bitmap_bytes = static_cast<size_t>(kWarps) * ((block + 31) / 32) * sizeof(unsigned);
  lists_sort_kernel<<<sort_ctas, kThreads, bitmap_bytes, s>>>(c, L);
  if (!launched() || !user) return static_cast<int>(e);

  const size_t smem = (static_cast<size_t>(block) + kQCols) * sizeof(int);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(&user_cols_kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  user_cols_kernel<<<q, kThreads, smem, s>>>(c, L);
  return static_cast<int>(cudaGetLastError());
}

// f32 words of the per-call scratch of K4 (k4 = 1: the transposed x and,
// with usernames, the user sums over the block's rows) or K5 (k4 = 0: with
// usernames, the user sums over the groups * nbins columns) at width r.
long long mused_cand_scratch_words(int k4, int n_mod, int block, int nbins, int groups, int r,
                                   int users) {
  const long long n = static_cast<long long>(groups) * nbins;
  if (!k4) return users ? seg_words(block, n, kSegChunk, r) : 0;
  return xr_words(block, rp8(r)) + (users ? seg_words(block, block, kSegChunk, r) : 0);
}

// K4.  x_t (r, block) bf16; out_t (r, groups * nbins) f32; scratch of
// mused_cand_scratch_words(1, ...) f32 words.
int mused_cand_matvec_t(const void* slabs, const void* uid_rows, const void* uid_cols,
                        int n_mod, int block, int nbins, int groups, int start, int g0,
                        void* workspace, const void* x_t, int r, void* out_t, void* scratch,
                        void* stream) {
  if (!cand_ok(n_mod, block, nbins, groups) || r <= 0 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Cand c = make_cand(slabs, uid_rows, uid_cols, n_mod, block, nbins, groups, start, g0);
  const Lists L = make_lists(workspace, n_mod, block, nbins, groups);
  const int rp = rp8(r);
  __nv_bfloat16* xr = static_cast<__nv_bfloat16*>(scratch);
  transpose_kernel<<<dim3((block + 31) / 32, (rp + 31) / 32), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x_t), r, block, rp, xr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  UserTerm ut{};
  if (uid_rows) {
    // U[u] = sum of x's rows over user u's rows
    float* usum = static_cast<float*>(scratch) + xr_words(block, rp);
    e = launch_segsum(L.a[kUserPtr], 1, L.a[kNu], block, L.a[kUserRows], L.a[kRowUser], block,
                      kSegChunk, xr, r, 1, rp, usum, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    ut = UserTerm{L.a[kColUser], L.a[kRowUser], usum,
                  static_cast<long long>(g0) * nbins - start, block};
  }
  e = r <= 8 ? launch_matvec_t_light<8>(c, L, xr, r, rp, ut, out_t, s)
      : r <= 16 ? launch_matvec_t_light<16>(c, L, xr, r, rp, ut, out_t, s)
                : launch_matvec_t_light<24>(c, L, xr, r, rp, ut, out_t, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int words = rp / 2;
  e = words <= 32 ? launch_matvec_t_heavy<1>(c, L, xr, r, rp, ut, out_t, s)
      : words <= 64 ? launch_matvec_t_heavy<2>(c, L, xr, r, rp, ut, out_t, s)
      : words <= 96 ? launch_matvec_t_heavy<3>(c, L, xr, r, rp, ut, out_t, s)
                    : launch_matvec_t_heavy<4>(c, L, xr, r, rp, ut, out_t, s);
  return static_cast<int>(e);
}

// K5.  y (groups * nbins, r) bf16; out (block, r) f32; scratch of
// mused_cand_scratch_words(0, ...) f32 words when uid_rows is set.
int mused_cand_matvec(const void* slabs, const void* uid_rows, const void* uid_cols, int n_mod,
                      int block, int nbins, int groups, int start, int g0, void* workspace,
                      const void* y, int r, void* out, void* scratch, void* stream) {
  if (!cand_ok(n_mod, block, nbins, groups) || r <= 0 || (uid_rows && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Cand c = make_cand(slabs, uid_rows, uid_cols, n_mod, block, nbins, groups, start, g0);
  const Lists L = make_lists(workspace, n_mod, block, nbins, groups);
  const int n = groups * nbins;
  const float* vsum = nullptr;
  if (uid_rows) {
    // V[u] = sum of y's rows over user u's columns (ptr hoff[u * q])
    const cudaError_t e = launch_segsum(L.a[kHOff], L.q, L.a[kNu], block, L.a[kUCols],
                                        L.a[kColUser], n, kSegChunk, y, r, 1, r, scratch, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    vsum = static_cast<const float*>(scratch);
  }
  const bool pair = r % 2 == 0 && (reinterpret_cast<uintptr_t>(y) & 3u) == 0;
  const cudaError_t e = pair ? dispatch_matvec<true>(c, L, y, r, vsum, out, s)
                             : dispatch_matvec<false>(c, L, y, r, vsum, out, s);
  return static_cast<int>(e);
}

}  // extern "C"
