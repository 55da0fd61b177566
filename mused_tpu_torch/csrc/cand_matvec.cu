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
//   * both are register-tiled f32 products on CUDA cores: a block (CTA) owns
//     a 128 x 128 output tile and each thread an 8 x 8 sub-tile; 32-deep
//     chunks of the operand (bf16 -> f32) and of W (rebuilt from the slabs
//     with int32 compares, stored as 0.0 / 1.0) are staged in shared memory.
//     W is 0/1, so every product is an exact copy of the operand and the
//     f32 sums are exact on integer-valued inputs in any order;
//   * K4: a CTA owns r rows x 128 slots of one group and loops over the
//     block's rows.  The edge count is an integer per-CTA partial (counted
//     once, by the CTAs of the first r tile) and one integer atomicAdd, so it
//     stays exact and its order does not matter;
//   * K5: a CTA owns 128 block rows x 128 columns of r and loops over groups
//     and 32-slot chunks.  At the huge-window shape only 16 such tiles exist,
//     so the group range is split across CTAs (about two CTAs per SM); each
//     split writes its partial sum and a second pass adds the partials in
//     split order, so the result is deterministic.
//
// What bounds it on an H100: at n = 98,304, block = 2048 a product is
// 2 * r * block * n = 51.5 GFLOP for r = 128 (103 for r = 256) of FP32 FMA,
// about 1 ms at the 67 TFLOP/s FP32 peak; the slabs (4 x 3.1 MB) and the
// operands stay in the 50 MB L2.  Rebuilding W costs 4-5 byte compares per
// element per r tile, small beside the 128 FMAs it feeds.  Tensor-core
// products (bf16 mma on the 0/1 tile) are later work.
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

// K4: out_t[r0 + m, g * nbins + s0 + n] = sum_i x_t[r0 + m, i] * W[i, g, s0 + n].
// grid.x = groups * slot tiles, grid.y = r tiles.
__global__ void __launch_bounds__(kThreads)
matvec_t_kernel(Cand c, const __nv_bfloat16* __restrict__ x_t, int r,
                float* __restrict__ out_t, int* __restrict__ edges) {
  __shared__ __align__(16) float xs[kDepth][kPad];   // xs[kk][m] = x_t[r0 + m, i0 + kk]
  __shared__ __align__(16) float ws[kDepth][kPad];   // ws[kk][n] = W[i0 + kk, g, s0 + n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int slot_tiles = (c.nbins + kTile - 1) / kTile;
  const int g = blockIdx.x / slot_tiles;
  const int s0 = (blockIdx.x % slot_tiles) * kTile;
  const int r0 = blockIdx.y * kTile;
  const bool count = blockIdx.y == 0;
  const size_t n = static_cast<size_t>(c.groups) * c.nbins;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  int ones = 0;

  for (int i0 = 0; i0 < c.block; i0 += kDepth) {
    for (int idx = tid; idx < kDepth * kTile; idx += kThreads) {
      const int kk = idx & (kDepth - 1), m = idx / kDepth;   // contiguous along the row
      const int row = r0 + m, i = i0 + kk;
      xs[kk][m] = (row < r && i < c.block)
                      ? __bfloat162float(x_t[static_cast<size_t>(row) * c.block + i]) : 0.f;
    }
    for (int idx = tid; idx < kDepth * kTile; idx += kThreads) {
      const int nn = idx & (kTile - 1), kk = idx / kTile;    // contiguous along the slab
      const int i = i0 + kk, s = s0 + nn;
      const bool w = i < c.block && s < c.nbins && fused_entry(c, i, g, s);
      ws[kk][nn] = w ? 1.f : 0.f;
      ones += w;
    }
    __syncthreads();
    tile_fma(acc, xs, ws, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + ty * 8 + i;
    if (row >= r) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = s0 + tx * 8 + j;
      if (s < c.nbins) out_t[row * n + static_cast<size_t>(g) * c.nbins + s] = acc[i][j];
    }
  }
  if (count) {
    ones = __reduce_add_sync(0xffffffffu, ones);
    if ((tid & 31) == 0 && ones) atomicAdd(edges, ones);
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
  const dim3 grid(groups * ((nbins + kTile - 1) / kTile), (r + kTile - 1) / kTile);
  matvec_t_kernel<<<grid, kThreads, 0, s>>>(c, static_cast<const __nv_bfloat16*>(x_t), r,
                                            static_cast<float*>(out_t),
                                            static_cast<int*>(edges));
  return static_cast<int>(cudaGetLastError());
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
