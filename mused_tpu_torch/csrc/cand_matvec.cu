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
//   * K5 is a register-tiled f32 product on CUDA cores: a CTA owns 128 block
//     rows x 128 columns of r and loops over groups and 32-slot chunks, with
//     W (rebuilt with int32 compares, stored as 0.0 / 1.0) and y (bf16 ->
//     f32) staged in shared memory.  At the huge-window shape only 16 such
//     tiles exist, so the group range is split across CTAs (about two CTAs
//     per SM); each split writes its partial sum and a second pass adds the
//     partials in split order, so the result is deterministic.
//
// What bounds them on an H100: at n = 98,304, block = 2048 a product is
// 2 * r * block * n, 26.6 GFLOP at the fold's live r = 66 (0.027 ms at the
// 989 TFLOP/s bf16 peak), 53.2 at r = 132.  K4's bytes are the slabs
// (4 x 3.1 MB), the uids and x_t once, out_t written once (26 MB at r = 66):
// about 0.012 ms.  What the design reads instead: every group's CTA re-reads
// its slab bytes (403 MB from L2 at r = 66, two groups per CTA; 805 MB at
// r = 132) and every CTA the whole x_t, so K4 is bound by L2 -> SM traffic
// and the rebuild's integer work, not by the tensor cores.  K5 still runs
// FP32 FMA against the same bf16 tensor-core roof.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // 16 x 16 threads, 8 x 8 outputs each
constexpr int kTile = 128;
constexpr int kDepth = 32;
constexpr int kPad = kTile + 4;  // padded k-major rows: float4-aligned, few conflicts

struct Cand {
  const int8_t* slabs;     // (n_mod, block, nbins)
  const int* uid_rows;     // (block,) or null
  const int* uid_cols;     // (groups, nbins)
  int n_mod, block, nbins, groups, start, g0;
};

// Fused adjacency entry (local row i, local group g, slot s).
__device__ __forceinline__ bool fused_entry(const Cand& c, int i, int g, int s) {
  const size_t off = static_cast<size_t>(i) * c.nbins + s;
  const size_t plane = static_cast<size_t>(c.block) * c.nbins;
  bool m = false;
  for (int mod = 0; mod < c.n_mod; ++mod)
    m |= static_cast<int>(c.slabs[mod * plane + off]) == g;
  if (c.uid_rows != nullptr) {
    const bool same = c.uid_rows[i] == c.uid_cols[static_cast<size_t>(g) * c.nbins + s];
    m |= same && (c.start + i != (c.g0 + g) * c.nbins + s);
  }
  return m;
}

// acc[8][8] += a[kk][ty*8 + 0..7] (x) b[kk][tx*8 + 0..7] over one staged chunk.
__device__ __forceinline__ void tile_fma(float (&acc)[8][8], const float (*a)[kPad],
                                         const float (*b)[kPad], int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < kDepth; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&a[kk][ty * 8]);
    const float4 a1 = *reinterpret_cast<const float4*>(&a[kk][ty * 8 + 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&b[kk][tx * 8]);
    const float4 b1 = *reinterpret_cast<const float4*>(&b[kk][tx * 8 + 4]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

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

// K5 partial: dst[split][row, n0 + nn] = sum over the split's groups and
// slots of W[row, g, s] * y[g * nbins + s, n0 + nn].
// grid.x = r tiles, grid.y = block-row tiles, grid.z = splits.
__global__ void __launch_bounds__(kThreads)
matvec_kernel(Cand c, const __nv_bfloat16* __restrict__ y, int r, float* __restrict__ dst) {
  __shared__ __align__(16) float ws[kDepth][kPad];   // ws[kk][m] = W[i0 + m, g, s0 + kk]
  __shared__ __align__(16) float ys[kDepth][kPad];   // ys[kk][nn] = y[g*nbins + s0 + kk, n0 + nn]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kTile, i0 = blockIdx.y * kTile;
  const int splits = gridDim.z, z = blockIdx.z;
  const int g_begin = z * c.groups / splits, g_end = (z + 1) * c.groups / splits;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int g = g_begin; g < g_end; ++g) {
    for (int s0 = 0; s0 < c.nbins; s0 += kDepth) {
      for (int idx = tid; idx < kDepth * kTile; idx += kThreads) {
        const int kk = idx & (kDepth - 1), m = idx / kDepth;   // contiguous along the slab
        const int i = i0 + m, s = s0 + kk;
        ws[kk][m] = (i < c.block && s < c.nbins && fused_entry(c, i, g, s)) ? 1.f : 0.f;
      }
      for (int idx = tid; idx < kDepth * kTile; idx += kThreads) {
        const int nn = idx & (kTile - 1), kk = idx / kTile;    // contiguous along y's row
        const int s = s0 + kk, col = n0 + nn;
        ys[kk][nn] = (s < c.nbins && col < r)
                         ? __bfloat162float(y[(static_cast<size_t>(g) * c.nbins + s) * r + col])
                         : 0.f;
      }
      __syncthreads();
      tile_fma(acc, ws, ys, ty, tx);
      __syncthreads();
    }
  }

  float* out = dst + static_cast<size_t>(z) * c.block * r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = i0 + ty * 8 + i;
    if (row >= c.block) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx * 8 + j;
      if (col < r) out[static_cast<size_t>(row) * r + col] = acc[i][j];
    }
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

// Group-range splits K5 uses for a (block, r) output over `groups` groups;
// the caller passes a (splits, block, r) f32 scratch when this is > 1.
int mused_cand_matvec_splits(int block, int r, int groups) {
  const int tiles = ((block + kTile - 1) / kTile) * ((r + kTile - 1) / kTile);
  int splits = (2 * sm_count() + tiles - 1) / tiles;
  if (splits > groups) splits = groups;
  return splits < 1 ? 1 : splits;
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
  if (!cand_ok(n_mod, block, nbins, groups, r) || splits < 1 || splits > groups ||
      (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Cand c = make_cand(slabs, uid_rows, uid_cols, n_mod, block, nbins, groups, start, g0);
  float* dst = static_cast<float*>(splits > 1 ? scratch : out);
  const dim3 grid((r + kTile - 1) / kTile, (block + kTile - 1) / kTile, splits);
  matvec_kernel<<<grid, kThreads, 0, s>>>(c, static_cast<const __nv_bfloat16*>(y), r, dst);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t count = static_cast<size_t>(block) * r;
  sum_splits_kernel<<<static_cast<int>((count + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(scratch), splits, count, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
