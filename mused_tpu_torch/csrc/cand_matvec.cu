// Products with the implicit fused-adjacency rows of a candidate block, built
// on the fly from its int8 candidate slabs: the dense (block, n) 0/1 block
// never exists in memory.
//
// Replaces the TPU kernels mused_tpu/ops/pallas/cand_matvec.py:
// matvec_t_pallas (K4: _matvec_t_kernel, _mask_tile, _operands) and
// matvec_pallas (K5: _matvec_kernel).  Same function: the fused tile of
// local column group g is W[i, s] = OR_m (slab[m, i, s] == g), ORed with
// username equality uid_rows[i] == uid_cols[g, s] where the global row
// start + i differs from the global column (g0 + g) * nbins + s (invalid
// uids are -1 on rows and -2 on columns, so they never match).  K4 computes
// out_t (r, n) = x_t (r, block) @ W and the exact edge count sum(W); K5
// computes out (block, r) = sum_g W_g @ y[g * nbins : (g + 1) * nbins].
// Operands x_t and y are bf16; sums are f32.
//
// Design for Hopper, not a copy of the TPU tiling (that one keeps the whole
// slab stack resident in VMEM and carries the edge count and K5's output
// across a sequential group grid):
//   * K4 runs on bf16 tensor cores (mma.sync m16n8k16, f32 accumulation), as
//     the TPU kernel runs on the MXU: bf16 x {0, 1} is exact, so only the
//     order of the f32 sums differs from the plain version (integer-valued
//     operands stay bit-equal).  M is x_t's rows (r, in tiles of 80 or 144),
//     N the slots, K the block's rows.  A CTA owns a 128-slot tile of one or
//     two groups (two when r <= 80, so each slab byte feeds both) and loops
//     over the block in 32-row chunks: the slab bytes, the x_t chunk and the
//     rows' uids are double-buffered with 16-byte cp.async; the 0/1 tile is
//     rebuilt once per chunk with packed byte compares (16 slab bytes XOR the
//     group id, a carry-free zero-byte test; the uid test per slot; each slab
//     word feeds both groups) and written as bf16
//     straight into the ldmatrix.trans layout of the B operand.  The edge
//     count is the popcount of the match bytes, an integer per CTA (counted
//     by the first r tile only) and one integer atomicAdd, so it stays exact;
//   * K5 runs on the same bf16 tensor cores: M is the block's rows, N the
//     live columns of y (r, padded in shared memory to 72 columns, or r tiles
//     of 144 above that), K the slots.  A CTA owns 128 block rows and a
//     range of 32-slot chunks (the ranges split the slots over about two
//     CTAs per SM); it walks its chunks, and inside each chunk every group.
//     A chunk's slab bytes are staged once and each thread keeps its 8 slots
//     x 2 rows of the first four planes in registers, so one slab byte feeds
//     all 64 groups; per group the thread rebuilds its A fragments in
//     registers with the packed zero-byte test (slots of a chunk are
//     permuted along K so that a thread's fragment bytes are 8 contiguous
//     slab bytes; y's rows are stored in the same permuted order, so the
//     product is unchanged).  y_g's chunk rows (4-byte cp.async, the live r
//     need not be a multiple of 8) and the chunk's uid columns go through a
//     3-stage ring, one __syncthreads per (chunk, group) step, and are read
//     with ldmatrix.trans.  Each split writes its partial sum and a second
//     pass adds the partials in split order, so the result is deterministic.
//
// What bounds them on an H100: at n = 98,304, block = 2048 a product is
// 2 * r * block * n, 26.6 GFLOP at the fold's live r = 66 (0.027 ms at the
// 989 TFLOP/s bf16 peak), 53.2 at r = 132.  K4's bytes are the slabs
// (4 x 3.1 MB), the uids and x_t once, out_t written once (26 MB at r = 66):
// about 0.012 ms.  What the design reads instead: every group's CTA re-reads
// its slab bytes (403 MB from L2 at r = 66, two groups per CTA; 805 MB at
// r = 132) and every CTA the whole x_t, so K4 is bound by L2 -> SM traffic
// and the rebuild's integer work, not by the tensor cores.  K5's bytes are
// the slabs once, y (13 MB at r = 66) and out (0.5 MB): 0.008 ms.  Its
// tensor cores do 72 / 66 of the live work; the rebuild (about 1.5 G
// integer operations for 201 M (row, group, slot) entries x 4 planes) and
// the shared-memory traffic of y (each warp reads the whole chunk) are
// expected to set its pace, not the bf16 rate.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

struct Cand {
  const int8_t* slabs;     // (n_mod, block, nbins)
  const int* uid_rows;     // (block,) or null
  const int* uid_cols;     // (groups, nbins)
  int n_mod, block, nbins, groups, start, g0;
};

// ---------------------------------------------------------------------------
// K4: bf16 tensor-core product with the rebuilt 0/1 tile
// ---------------------------------------------------------------------------

constexpr int kT4Threads = 256;               // 8 warps, 16 slots each
constexpr int kT4Slots = 128;                 // slots per tile
constexpr int kT4Depth = 32;                  // block rows per chunk (2 k16 steps)
constexpr int kT4Stages = 3;                  // cp.async ring: chunks in flight
constexpr int kWStride = kT4Slots * 2 + 16;   // bytes per W row: ldmatrix.trans conflict-free
constexpr int kXStride = kT4Depth * 2 + 16;   // bytes per x_t row: ldmatrix conflict-free

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&d)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&d)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(d[0]), "=r"(d[1]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 0x80 in each byte of x that is zero, 0 elsewhere (no carries between bytes).
__device__ __forceinline__ uint32_t zero_bytes(uint32_t x) {
  return ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

// Byte mask of the slots [0, nvalid) among the 4 slots of match word q.
__device__ __forceinline__ uint32_t slot_mask(int nvalid, int q) {
  const int k = nvalid - 4 * q;
  return k >= 4 ? 0xFFFFFFFFu : k <= 0 ? 0u : (1u << (8 * k)) - 1u;
}

// K4: out_t[r0 + m, g * nbins + s0 + s] = sum_i x_t[r0 + m, i] * W[i, g, s0 + s].
// grid.x = slot tiles, grid.y = group chunks of GPC, grid.z = r tiles of
// MT * 16 rows.  VEC: 16-byte cp.async staging (nbins % 16 == 0, block % 8
// == 0, aligned pointers); otherwise scalar loads into the same buffers.
template <int MT, int GPC, bool VEC>
__global__ void __launch_bounds__(kT4Threads, 2)
matvec_t_kernel(Cand c, const __nv_bfloat16* __restrict__ x_t, int r,
                float* __restrict__ out_t, int* __restrict__ edges) {
  constexpr int kXRows = MT * 16;
  extern __shared__ __align__(16) uint8_t smem[];
  const int slab_bytes = c.n_mod * kT4Depth * kT4Slots;          // one stage
  uint8_t* slab_s = smem;                                    // [stages][n_mod][32][128]
  uint8_t* x_s = slab_s + kT4Stages * slab_bytes;            // [stages][kXRows][kXStride]
  int* urow_s = reinterpret_cast<int*>(x_s + kT4Stages * kXRows * kXStride);  // [stages][32]
  uint8_t* w_s = reinterpret_cast<uint8_t*>(urow_s + kT4Stages * kT4Depth);   // [GPC][32][kWStride]
  int* ucol_s = reinterpret_cast<int*>(w_s + GPC * kT4Depth * kWStride);  // [GPC][128]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * kT4Slots;
  const int gbase = blockIdx.y * GPC;
  const int r0 = blockIdx.z * kXRows;
  const size_t n = static_cast<size_t>(c.groups) * c.nbins;
  const size_t plane = static_cast<size_t>(c.block) * c.nbins;
  const int rr = tid >> 3, seg = tid & 7;        // the W-build item: row, 16-slot segment
  const int nvalid = min(max(c.nbins - (s0 + seg * 16), 0), 16);
  const bool user = c.uid_rows != nullptr;

  for (int idx = tid; idx < GPC * kT4Slots; idx += kT4Threads) {
    const int gg = idx / kT4Slots, sl = idx % kT4Slots, g = gbase + gg;
    ucol_s[idx] = (g < c.groups && s0 + sl < c.nbins)
                      ? c.uid_cols[static_cast<size_t>(g) * c.nbins + s0 + sl] : -2;
  }

  auto stage = [&](int chunk, int buf) {
    const int i0 = chunk * kT4Depth;
    uint8_t* sl = slab_s + buf * slab_bytes;
    uint8_t* xs = x_s + buf * kXRows * kXStride;
    int* ur = urow_s + buf * kT4Depth;
    const int i = i0 + rr;
    if (VEC) {
      const bool ok = i < c.block && nvalid > 0;
      for (int m = 0; m < c.n_mod; ++m)
        cp_async16(sl + (m * kT4Depth + rr) * kT4Slots + seg * 16,
                   ok ? c.slabs + m * plane + static_cast<size_t>(i) * c.nbins + s0 + seg * 16
                      : c.slabs, ok);
      for (int p = tid; p < kXRows * 4; p += kT4Threads) {
        const int row = p >> 2, part = p & 3;
        const bool okx = r0 + row < r && i0 + part * 8 < c.block;
        cp_async16(xs + row * kXStride + part * 16,
                   okx ? x_t + static_cast<size_t>(r0 + row) * c.block + i0 + part * 8 : x_t,
                   okx);
      }
      if (user && tid < kT4Depth / 4) {
        const bool oku = i0 + tid * 4 < c.block;
        cp_async16(ur + tid * 4, oku ? c.uid_rows + i0 + tid * 4 : c.uid_rows, oku);
      }
      cp_async_commit();
    } else {
      for (int m = 0; m < c.n_mod; ++m)
        for (int j = 0; j < 16; ++j)
          sl[(m * kT4Depth + rr) * kT4Slots + seg * 16 + j] =
              (i < c.block && j < nvalid)
                  ? static_cast<uint8_t>(
                        c.slabs[m * plane + static_cast<size_t>(i) * c.nbins + s0 + seg * 16 + j])
                  : 0xFFu;
      for (int p = tid; p < kXRows * kT4Depth; p += kT4Threads) {
        const int row = p / kT4Depth, k = p % kT4Depth;
        reinterpret_cast<__nv_bfloat16*>(xs + row * kXStride)[k] =
            (r0 + row < r && i0 + k < c.block)
                ? x_t[static_cast<size_t>(r0 + row) * c.block + i0 + k]
                : __float2bfloat16(0.f);
      }
      if (user && tid < kT4Depth) ur[tid] = i0 + tid < c.block ? c.uid_rows[i0 + tid] : -1;
    }
  };

  float acc[GPC][MT][2][4];
#pragma unroll
  for (int gg = 0; gg < GPC; ++gg)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gg][mt][nt][e] = 0.f;
  int ones = 0;   // edges seen by this thread (one marker bit each)

  // VEC: chunks ch + 1 .. ch + kT4Stages - 1 are in flight while chunk ch is
  // used (one commit group per chunk, empty past the end, so the wait count
  // stays fixed); scalar: chunk ch + 1 is staged after chunk ch's products.
  const int chunks = (c.block + kT4Depth - 1) / kT4Depth;
  const int ahead = VEC ? kT4Stages - 1 : 1;
  for (int ch = 0; ch < ahead; ++ch) {
    if (ch < chunks) stage(ch, ch);
    else if (VEC) cp_async_commit();
  }
  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch % kT4Stages;
    if (VEC) cp_async_wait<kT4Stages - 2>();
    __syncthreads();   // chunk ch (and, on the first chunk, ucol_s) visible

    // rebuild: this thread's (row, 16-slot segment) of every group's tile.
    // eq[gg][q] holds 0x80 in each byte (slot) that is an edge of group
    // gbase + gg; each slab word is read once and tested against every group.
    {
      const int i = ch * kT4Depth + rr;
      const uint8_t* sl = slab_s + buf * slab_bytes + rr * kT4Slots + seg * 16;
      uint32_t eq[GPC][4];
#pragma unroll
      for (int gg = 0; gg < GPC; ++gg)
#pragma unroll
        for (int q = 0; q < 4; ++q) eq[gg][q] = 0u;
      for (int m = 0; m < c.n_mod; ++m) {
        const uint4 w = *reinterpret_cast<const uint4*>(sl + m * kT4Depth * kT4Slots);
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int gg = 0; gg < GPC; ++gg) {
          const uint32_t rep = static_cast<uint32_t>((gbase + gg) & 0xFF) * 0x01010101u;
#pragma unroll
          for (int q = 0; q < 4; ++q) eq[gg][q] |= zero_bytes(ws[q] ^ rep);
        }
      }
      const bool row_live = i < c.block;
      if (user && row_live) {
        const int urow = urow_s[buf * kT4Depth + rr];
#pragma unroll
        for (int gg = 0; gg < GPC; ++gg) {
          const long long self = static_cast<long long>(c.start) + i -
                                 static_cast<long long>(c.g0 + gbase + gg) * c.nbins - s0 -
                                 seg * 16;
          const int4* uc = reinterpret_cast<const int4*>(ucol_s + gg * kT4Slots + seg * 16);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int4 u = uc[q];
            const int us[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int b = 0; b < 4; ++b)
              if (us[b] == urow && self != 4 * q + b) eq[gg][q] |= 0x80u << (8 * b);
          }
        }
      }
#pragma unroll
      for (int gg = 0; gg < GPC; ++gg) {
        const bool live = row_live && gbase + gg < c.groups;
        uint32_t wv[8];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t e = eq[gg][q] & (live ? slot_mask(nvalid, q) : 0u);
          ones += __popc(e);
          // bytes 0 / 1 -> (slot 2j | slot 2j + 1 << 16) -> bf16 0 / 1.0 pairs
          const uint32_t bit = e >> 7;
          wv[2 * q] = __byte_perm(bit, 0u, 0x4140) * 0x3F80u;
          wv[2 * q + 1] = __byte_perm(bit, 0u, 0x4342) * 0x3F80u;
        }
        uint4* dst = reinterpret_cast<uint4*>(w_s + (gg * kT4Depth + rr) * kWStride + seg * 32);
        dst[0] = make_uint4(wv[0], wv[1], wv[2], wv[3]);
        dst[1] = make_uint4(wv[4], wv[5], wv[6], wv[7]);
      }
    }
    __syncthreads();   // W visible

    const uint8_t* xs = x_s + buf * kXRows * kXStride;
#pragma unroll
    for (int ks = 0; ks < kT4Depth / 16; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], xs + (mt * 16 + (lane & 15)) * kXStride + (ks * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int gg = 0; gg < GPC; ++gg) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, w_s + (gg * kT4Depth + ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                       kWStride + (warp * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[gg][mt][0], a[mt], b[0], b[1]);
          mma_bf16(acc[gg][mt][1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();   // W, and stage buf of chunk ch, are refilled next
    if (VEC) {
      if (ch + ahead < chunks) stage(ch + ahead, (ch + ahead) % kT4Stages);
      else cp_async_commit();
    } else if (ch + 1 < chunks) {
      stage(ch + 1, (ch + 1) % kT4Stages);
    }
  }

  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int gg = 0; gg < GPC; ++gg) {
    const int g = gbase + gg;
    if (g >= c.groups) break;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + mt * 16 + gid + 8 * (e >> 1);
          const int s = s0 + warp * 16 + nt * 8 + tig * 2 + (e & 1);
          if (row < r && s < c.nbins)
            out_t[static_cast<size_t>(row) * n + static_cast<size_t>(g) * c.nbins + s] =
                acc[gg][mt][nt][e];
        }
  }
  if (blockIdx.z == 0) {   // count each (group, slot tile) once
    ones = __reduce_add_sync(0xffffffffu, ones);
    if (lane == 0 && ones) atomicAdd(edges, ones);
  }
}

// ---------------------------------------------------------------------------
// K5: bf16 tensor-core product with the 0/1 tile rebuilt in registers
// ---------------------------------------------------------------------------

constexpr int kT5Threads = 256;   // 8 warps, 16 block rows each
constexpr int kT5Rows = 128;      // block rows per CTA
constexpr int kT5Slots = 32;      // slots per chunk: two k16 steps
constexpr int kT5Stages = 3;      // ring depth: (chunk, group) steps in flight
constexpr int kT5RegPlanes = 4;   // slab planes a thread keeps in registers

// Bytes per staged y row: an odd number of 16-byte units, so the 8 rows one
// ldmatrix reads fall in 8 different bank groups.
__host__ __device__ constexpr int t5_ystride(int nt) { return 16 * (nt | 1); }

// K order inside a chunk.  Logical k of step j (0, 1) of the m16n8k16 A
// fragment of thread t (= lane & 3) is k = 2t + e (a0 / a1) or 2t + 8 + e
// (a2 / a3); it is mapped to slot 8t + 4j + 2h + e (h = k >> 3), so a
// thread's A bytes of one row are the 8 contiguous slab bytes 8t .. 8t + 7.
// y's chunk row of slot p is stored at shared-memory row
// 16j + 8h + (p >> 3) * 2 + e, so the ldmatrix.trans row of logical k of
// step j is simply 16j + k: the same permutation on both operands leaves
// the product unchanged.
__device__ __forceinline__ int t5_yrow(int p) {
  return ((p >> 2) & 1) * 16 + ((p >> 1) & 1) * 8 + (p >> 3) * 2 + (p & 1);
}

// bytes 0 / 1 (or 2 / 3) of a 0x80-per-edge match word -> a bf16 0 / 1.0 pair
__device__ __forceinline__ uint32_t bf16_pair_lo(uint32_t e) {
  return __byte_perm(e >> 7, 0u, 0x4140) * 0x3F80u;
}
__device__ __forceinline__ uint32_t bf16_pair_hi(uint32_t e) {
  return __byte_perm(e >> 7, 0u, 0x4342) * 0x3F80u;
}

// K5 partial: dst[z][row, n0 + nn] = sum over split z's slot chunks and
// every group g of W[row, g, s] * y[g * nbins + s, n0 + nn].
// grid.x = r tiles of NT * 8 columns, grid.y = 128-row block tiles,
// grid.z = splits (contiguous ranges of 32-slot chunks).  VEC: cp.async
// staging (nbins % 16 == 0, r even, aligned pointers); otherwise plain
// loads into the same buffers.
template <int NT, int MINB, bool VEC>
__global__ void __launch_bounds__(kT5Threads, MINB)
matvec_kernel(Cand c, const __nv_bfloat16* __restrict__ y, int r, float* __restrict__ dst) {
  constexpr int kWords = NT * 4;             // 4-byte words of y per staged row
  constexpr int kYStride = t5_ystride(NT);
  extern __shared__ __align__(16) uint8_t smem[];
  const int slab_bytes = c.n_mod * kT5Rows * kT5Slots;           // one chunk
  uint8_t* slab_s = smem;                                         // [3][n_mod][128][32]
  uint8_t* y_s = slab_s + kT5Stages * slab_bytes;                 // [3][32][kYStride]
  int* ucol_s = reinterpret_cast<int*>(y_s + kT5Stages * kT5Slots * kYStride);   // [3][32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * NT * 8, i0 = blockIdx.y * kT5Rows;
  const int chunks = (c.nbins + kT5Slots - 1) / kT5Slots;
  const int c_begin = blockIdx.z * chunks / gridDim.z;
  const int steps = ((blockIdx.z + 1) * chunks / gridDim.z - c_begin) * c.groups;
  const size_t plane = static_cast<size_t>(c.block) * c.nbins;
  const bool user = c.uid_rows != nullptr;
  const int lrow = warp * 16 + gid;          // this thread's local rows: lrow, lrow + 8
  const int live_words = min(kWords, (r - n0 + 1) / 2);   // y words of this r tile
  int urow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + lrow + 8 * h;
    urow[h] = (user && i < c.block) ? c.uid_rows[i] : -1;
  }
  if (VEC) {   // the padding columns past r stay zero in every buffer
    for (int p = tid; p < kT5Stages * kT5Slots * kWords; p += kT5Threads) {
      const int w = p % kWords;
      if (w >= live_words)
        *reinterpret_cast<uint32_t*>(y_s + (p / kWords) * kYStride + w * 4) = 0u;
    }
  }

  // Stage the step (chunk c_begin + cl, group g) into ring buffer buf and,
  // on a chunk's first group, its slab bytes into slab buffer sbuf.
  // Out-of-range slab bytes are 0xFF (no group), uid columns -2, y zero.
  auto stage = [&](int cl, int g, int buf, int sbuf) {
    const int s0 = (c_begin + cl) * kT5Slots;
    if (g == 0) {      // the chunk's slab bytes, staged once for every group
      uint8_t* sl = slab_s + sbuf * slab_bytes;
      for (int p = tid; p < c.n_mod * kT5Rows * 2; p += kT5Threads) {
        const int m = p / (kT5Rows * 2), row = (p >> 1) % kT5Rows, part = p & 1;
        const int i = i0 + row, s = s0 + part * 16;
        uint8_t* d = sl + (m * kT5Rows + row) * kT5Slots + part * 16;
        const int8_t* src = c.slabs + m * plane + static_cast<size_t>(i) * c.nbins + s;
        if (VEC) {
          if (i < c.block && s < c.nbins) cp_async16(d, src, true);
          else *reinterpret_cast<uint4*>(d) = make_uint4(~0u, ~0u, ~0u, ~0u);
        } else {
          for (int j = 0; j < 16; ++j)
            d[j] = (i < c.block && s + j < c.nbins) ? static_cast<uint8_t>(src[j]) : 0xFFu;
        }
      }
    }
    uint8_t* ys = y_s + buf * kT5Slots * kYStride;
    const size_t yrow0 = static_cast<size_t>(g) * c.nbins + s0;
    if (VEC) {
      // warp w stages slots w, w + 8, w + 16, w + 24 (shared-memory rows
      // t5_yrow(w) + 2k), lane l their words l and l + 32
#pragma unroll
      for (int k = 0; k < kT5Slots / 8; ++k) {
        const int sl = warp + 8 * k;
        const bool ok = s0 + sl < c.nbins;
        const __nv_bfloat16* src = y + (yrow0 + sl) * r + n0;
        uint8_t* d = ys + (t5_yrow(warp) + 2 * k) * kYStride;
#pragma unroll
        for (int w = lane; w < kWords; w += 32)
          if (w < live_words) cp_async4(d + w * 4, ok ? src + 2 * w : y, ok);
      }
    } else {
      for (int p = tid; p < kT5Slots * kWords; p += kT5Threads) {
        const int sl = p / kWords, w = p % kWords, col = n0 + 2 * w;
        const bool ok = s0 + sl < c.nbins && col < r;
        const __nv_bfloat16* src = y + (yrow0 + sl) * r + col;
        __nv_bfloat16* db = reinterpret_cast<__nv_bfloat16*>(ys + t5_yrow(sl) * kYStride + w * 4);
        db[0] = ok ? src[0] : __float2bfloat16(0.f);
        db[1] = (ok && col + 1 < r) ? src[1] : __float2bfloat16(0.f);
      }
    }
    if (user) {
      int* uc = ucol_s + buf * kT5Slots;
      const int* src = c.uid_cols + static_cast<size_t>(g) * c.nbins + s0;
      if (VEC) {
        if (tid < kT5Slots / 4) {
          if (s0 + 4 * tid < c.nbins) cp_async16(uc + 4 * tid, src + 4 * tid, true);
          else *reinterpret_cast<int4*>(uc + 4 * tid) = make_int4(-2, -2, -2, -2);
        }
      } else if (tid < kT5Slots) {
        uc[tid] = s0 + tid < c.nbins ? src[tid] : -2;
      }
    }
    if (VEC) cp_async_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  // slab words of planes 0..3 of the current chunk: [plane][row lo slots
  // 0-3, 4-7, row hi slots 0-3, 4-7] (0xFF bytes for absent planes)
  uint32_t sw[kT5RegPlanes][4];
  const int off_lo = lrow * kT5Slots + 8 * tig, off_hi = off_lo + 8 * kT5Slots;
  // row lo's offset from its own column in group 0 of chunk c_begin, slot 8 tig
  const long long self0 = static_cast<long long>(c.start) + i0 + lrow -
                          static_cast<long long>(c.g0) * c.nbins - c_begin * kT5Slots - 8 * tig;

  // VEC: steps t + 1 .. t + kT5Stages - 1 are in flight while step t is used
  // (one commit group per step, empty past the end, so the wait count stays
  // fixed).  Step t + 2 is staged into the buffers step t - 1 used, after
  // the barrier that ends every thread's use of them; its chunk's slab
  // buffer is one the current chunk does not use.
  const int ahead = kT5Stages - 1;
  int st_cl = 0, st_g = 0, st_buf = 0, st_sbuf = 0;   // the next step to stage
  auto stage_next = [&]() {
    stage(st_cl, st_g, st_buf, st_sbuf);
    st_buf = st_buf + 1 == kT5Stages ? 0 : st_buf + 1;
    if (++st_g == c.groups) {
      st_g = 0;
      ++st_cl;
      st_sbuf = st_sbuf + 1 == kT5Stages ? 0 : st_sbuf + 1;
    }
  };
  for (int t = 0; t < ahead; ++t) {
    if (t < steps) stage_next();
    else if (VEC) cp_async_commit();
  }
  int cl = 0, g = 0, buf = 0, sbuf = 0;
  long long self = self0;
  for (int t = 0; t < steps; ++t) {
    if (VEC) cp_async_wait<kT5Stages - 2>();
    __syncthreads();   // step t visible; step t - 1's buffers free
    if (t + ahead < steps) stage_next();
    else if (VEC) cp_async_commit();

    const uint8_t* sl = slab_s + sbuf * slab_bytes;
    if (g == 0) {
#pragma unroll
      for (int m = 0; m < kT5RegPlanes; ++m) {
        uint2 lo = make_uint2(~0u, ~0u), hi = lo;
        if (m < c.n_mod) {
          lo = *reinterpret_cast<const uint2*>(sl + m * kT5Rows * kT5Slots + off_lo);
          hi = *reinterpret_cast<const uint2*>(sl + m * kT5Rows * kT5Slots + off_hi);
        }
        sw[m][0] = lo.x; sw[m][1] = lo.y; sw[m][2] = hi.x; sw[m][3] = hi.y;
      }
    }

    // rebuild: eq[q] holds 0x80 in each byte (slot) that is an edge of group
    // g.  nz accumulates, over the planes, 0x80 in each byte of slab ^ g
    // that is not zero (zero_bytes without its final not-and-mask).
    const uint32_t rep = static_cast<uint32_t>(g & 0xFF) * 0x01010101u;
    uint32_t nz[4] = {~0u, ~0u, ~0u, ~0u};
#pragma unroll
    for (int m = 0; m < kT5RegPlanes; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t x = sw[m][q] ^ rep;
        nz[q] &= ((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x;
      }
    for (int m = kT5RegPlanes; m < c.n_mod; ++m) {
      const uint2 lo = *reinterpret_cast<const uint2*>(sl + m * kT5Rows * kT5Slots + off_lo);
      const uint2 hi = *reinterpret_cast<const uint2*>(sl + m * kT5Rows * kT5Slots + off_hi);
      const uint32_t ws[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t x = ws[q] ^ rep;
        nz[q] &= ((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x;
      }
    }
    uint32_t eq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) eq[q] = ~nz[q] & 0x80808080u;
    if (user) {   // username equality, the row's own column excluded
      const int4* uc = reinterpret_cast<const int4*>(ucol_s + buf * kT5Slots + 8 * tig);
      const int4 u0 = uc[0], u1 = uc[1];
      const int us[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t m0 = 0u, m1 = 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          m0 |= us[b] == urow[h] ? 0x80u << (8 * b) : 0u;
          m1 |= us[4 + b] == urow[h] ? 0x80u << (8 * b) : 0u;
        }
        const long long d = self + 8 * h;   // the own column's slot among 8 tig .. 8 tig + 7
        if (d >= 0 && d < 4) m0 &= ~(0x80u << (8 * d));
        else if (d >= 4 && d < 8) m1 &= ~(0x80u << (8 * (d - 4)));
        eq[2 * h] |= m0;
        eq[2 * h + 1] |= m1;
      }
    }

    const uint8_t* ys = y_s + buf * kT5Slots * kYStride;
    const int mat = lane >> 3;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t a[4] = {bf16_pair_lo(eq[j]), bf16_pair_lo(eq[2 + j]),
                             bf16_pair_hi(eq[j]), bf16_pair_hi(eq[2 + j])};
      // matrix mat of an x4 load: k half mat & 1 of n tile nt + (mat >> 1)
      const uint8_t* brow = ys + (16 * j + 8 * (mat & 1) + (lane & 7)) * kYStride;
#pragma unroll
      for (int nt = 0; nt + 1 < NT; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, brow + (nt + (mat >> 1)) * 16);
        mma_bf16(acc[nt], a, b[0], b[1]);
        mma_bf16(acc[nt + 1], a, b[2], b[3]);
      }
      if (NT & 1) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, brow + (NT - 1) * 16);
        mma_bf16(acc[NT - 1], a, b[0], b[1]);
      }
    }

    buf = buf + 1 == kT5Stages ? 0 : buf + 1;
    self -= c.nbins;
    if (++g == c.groups) {
      g = 0;
      ++cl;
      sbuf = sbuf + 1 == kT5Stages ? 0 : sbuf + 1;
      self = self0 - static_cast<long long>(cl) * kT5Slots;
    }
  }

  float* out = dst + static_cast<size_t>(blockIdx.z) * c.block * r;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = i0 + lrow + 8 * (e >> 1), col = n0 + nt * 8 + 2 * tig + (e & 1);
      if (row < c.block && col < r) out[static_cast<size_t>(row) * r + col] = acc[nt][e];
    }
}

// out[e] = sum_z partial[z][e], in split order.
__global__ void sum_splits_kernel(const float* __restrict__ partial, int splits, size_t count,
                                  float* __restrict__ out) {
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < count;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += partial[z * count + e];
    out[e] = s;
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  return sms;
}

template <int MT, int GPC, bool VEC>
cudaError_t launch_matvec_t(const Cand& c, const void* x_t, int r, void* out_t, void* edges,
                            int r_tiles, cudaStream_t s) {
  const size_t smem = kT4Stages * (static_cast<size_t>(c.n_mod) * kT4Depth * kT4Slots +
                                   MT * 16 * kXStride + kT4Depth * sizeof(int)) +
                      GPC * kT4Depth * kWStride + GPC * kT4Slots * sizeof(int);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(&matvec_t_kernel<MT, GPC, VEC>),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((c.nbins + kT4Slots - 1) / kT4Slots, (c.groups + GPC - 1) / GPC, r_tiles);
  matvec_t_kernel<MT, GPC, VEC><<<grid, kT4Threads, smem, s>>>(
      c, static_cast<const __nv_bfloat16*>(x_t), r, static_cast<float*>(out_t),
      static_cast<int*>(edges));
  return cudaGetLastError();
}

// K5's n tile: 72 columns when r <= 72 (the fold's live r = 66), else r
// tiles of 144.
int t5_nt(int r) { return r <= 72 ? 9 : 18; }

template <int NT, int MINB, bool VEC>
cudaError_t prepare_matvec(int n_mod, size_t* smem) {
  *smem = kT5Stages * (static_cast<size_t>(n_mod) * kT5Rows * kT5Slots +
                       kT5Slots * t5_ystride(NT) + kT5Slots * sizeof(int));
  if (*smem > 227 * 1024) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(&matvec_kernel<NT, MINB, VEC>),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

// Splits that fill one wave: co-resident CTAs / output tiles, at most one
// per 32-slot chunk.
template <int NT, int MINB>
int matvec_splits(int n_mod, int block, int nbins, int r) {
  size_t smem = 0;
  if (prepare_matvec<NT, MINB, true>(n_mod, &smem) != cudaSuccess) return 1;
  int active = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &active, matvec_kernel<NT, MINB, true>, kT5Threads, smem) != cudaSuccess) {
    cudaGetLastError();   // a refused query leaves no error behind
    active = 1;
  }
  const int tiles = ((block + kT5Rows - 1) / kT5Rows) * ((r + NT * 8 - 1) / (NT * 8));
  const int chunks = (nbins + kT5Slots - 1) / kT5Slots;
  const int splits = (active > 1 ? active : 1) * sm_count() / tiles;
  return splits < 1 ? 1 : splits > chunks ? chunks : splits;
}

template <int NT, int MINB, bool VEC>
cudaError_t launch_matvec(const Cand& c, const void* y, int r, float* dst, int splits,
                          cudaStream_t s) {
  size_t smem = 0;
  const cudaError_t e = prepare_matvec<NT, MINB, VEC>(c.n_mod, &smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((r + NT * 8 - 1) / (NT * 8), (c.block + kT5Rows - 1) / kT5Rows, splits);
  matvec_kernel<NT, MINB, VEC><<<grid, kT5Threads, smem, s>>>(
      c, static_cast<const __nv_bfloat16*>(y), r, dst);
  return cudaGetLastError();
}

Cand make_cand(const void* slabs, const void* uid_rows, const void* uid_cols, int n_mod,
               int block, int nbins, int groups, int start, int g0) {
  return Cand{static_cast<const int8_t*>(slabs), static_cast<const int*>(uid_rows),
              static_cast<const int*>(uid_cols), n_mod, block, nbins, groups, start, g0};
}

bool cand_ok(int n_mod, int block, int nbins, int groups, int r) {
  return n_mod > 0 && block > 0 && nbins > 0 && groups > 0 && r > 0;
}

}  // namespace

extern "C" {

// Slot-range splits K5 uses for a (block, r) output of n_mod slab planes
// over nbins slots (one wave of co-resident CTAs, at most one split per
// 32-slot chunk); the caller passes a (splits, block, r) f32 scratch when
// this is > 1.
int mused_cand_matvec_splits(int n_mod, int block, int nbins, int r) {
  if (n_mod <= 0 || block <= 0 || nbins <= 0 || r <= 0) return 1;
  return t5_nt(r) == 9 ? matvec_splits<9, 2>(n_mod, block, nbins, r)
                       : matvec_splits<18, 1>(n_mod, block, nbins, r);
}

// K4.  slabs (n_mod, block, nbins) int8; uid_rows (block,) int32 or null
// (no username modality); uid_cols (groups, nbins) int32; x_t (r, block)
// bf16; out_t (r, groups * nbins) f32; edges one int32, set here.
int mused_cand_matvec_t(const void* slabs, const void* uid_rows, const void* uid_cols,
                        int n_mod, int block, int nbins, int groups, int start, int g0,
                        const void* x_t, int r, void* out_t, void* edges, void* stream) {
  if (!cand_ok(n_mod, block, nbins, groups, r)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(edges, 0, sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Cand c = make_cand(slabs, uid_rows, uid_cols, n_mod, block, nbins, groups, start, g0);
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  const bool vec = nbins % 16 == 0 && block % 8 == 0 && aligned(slabs) && aligned(x_t) &&
                   (uid_rows == nullptr || aligned(uid_rows));
  // r tiles of at most 144 rows; 80-row tiles take two groups per CTA
  const int r_tiles = (r + 143) / 144;
  const int tile_rows = (r + r_tiles - 1) / r_tiles;
  const bool narrow = tile_rows <= 80;
  if (narrow) {
    e = vec ? launch_matvec_t<5, 2, true>(c, x_t, r, out_t, edges, r_tiles, s)
            : launch_matvec_t<5, 2, false>(c, x_t, r, out_t, edges, r_tiles, s);
  } else {
    e = vec ? launch_matvec_t<9, 1, true>(c, x_t, r, out_t, edges, r_tiles, s)
            : launch_matvec_t<9, 1, false>(c, x_t, r, out_t, edges, r_tiles, s);
  }
  return static_cast<int>(e);
}

// K5.  y (groups * nbins, r) bf16; out (block, r) f32; scratch (splits,
// block, r) f32 when splits > 1 (see mused_cand_matvec_splits), else null.
int mused_cand_matvec(const void* slabs, const void* uid_rows, const void* uid_cols,
                      int n_mod, int block, int nbins, int groups, int start, int g0,
                      const void* y, int r, void* out, void* scratch, int splits,
                      void* stream) {
  if (!cand_ok(n_mod, block, nbins, groups, r) || splits < 1 ||
      splits > (nbins + kT5Slots - 1) / kT5Slots || (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Cand c = make_cand(slabs, uid_rows, uid_cols, n_mod, block, nbins, groups, start, g0);
  float* dst = static_cast<float*>(splits > 1 ? scratch : out);
  auto aligned = [](const void* p, unsigned a) {
    return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
  };
  const bool vec = nbins % 16 == 0 && r % 2 == 0 && aligned(slabs, 16) && aligned(y, 4) &&
                   (uid_rows == nullptr || aligned(uid_cols, 16));
  cudaError_t e;
  if (t5_nt(r) == 9) {
    e = vec ? launch_matvec<9, 2, true>(c, y, r, dst, splits, s)
            : launch_matvec<9, 2, false>(c, y, r, dst, splits, s);
  } else {
    e = vec ? launch_matvec<18, 1, true>(c, y, r, dst, splits, s)
            : launch_matvec<18, 1, false>(c, y, r, dst, splits, s);
  }
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t count = static_cast<size_t>(block) * r;
  sum_splits_kernel<<<static_cast<int>((count + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(scratch), splits, count, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
