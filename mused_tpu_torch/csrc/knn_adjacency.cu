// Directed kNN adjacency for one modality, fused: similarity -> mask -> exact
// top-k select with lax.top_k's tie rule -> 0/1 adjacency row.
//
// Replaces the TPU kernel mused_tpu/ops/pallas/affinity_kernel.py:
// knn_adjacency_pallas (_kernel, _sim_block).  Same function: metrics dot,
// euclidean (negative squared distance), jaccard (inter / union with set
// sizes reduced here), l1 and chord3 (negative squared chord from
// coordinate differences); invalid, self and pad columns masked to -1e30;
// every column above the k-th value kept plus exactly (k - #above) columns
// tied at it, lowest index first; invalid rows emit nothing.
//
// Design for Hopper, not a copy of the TPU tiling (that one keeps a
// (256, n) strip in 128 MB of VMEM across a sequential grid):
//   * one block owns TM rows and builds their similarities against ALL n
//     columns into shared memory (a row's f32 strip is <= 128 KB for the
//     dense-window limit n <= 32768; TM = 16 rows fit at n = 2000);
//   * similarities are FP32 FFMA on CUDA cores: each thread owns one column
//     of a 256-column tile and TM accumulators; 32-deep feature chunks of
//     the column tile and the row tile are staged in shared memory, as
//     float4 loads whose next chunk is already in flight (in registers)
//     while the current one is computed when rows are 16-byte aligned;
//   * selection is exact and branch-free of floats: each warp takes a row,
//     maps similarities to their order-preserving uint32 keys (IEEE total
//     order, so -0.0 < +0.0 exactly as lax.top_k orders them), finds the
//     k-th largest key by a 32-step bisection over the key space, then
//     keeps key > kth plus the first (k - #above) ties in index order via
//     warp ballots.
//
// What bounds it on an H100: at the main path's widest modality (text,
// n = 2000, d = 4096) the similarity is 33 GFLOP of FP32 FFMA fed from
// shared memory (one column load + TM broadcast row loads per TM FMAs), so
// shared-memory bandwidth and the one-block-per-SM occupancy that a 130 KB
// strip leaves bound it, far below the 67 TFLOP/s FP32 peak.  Tensor-core
// operands (wgmma on bf16 / int8 tiles) and TMA staging are later work.
// The selection reads the strip 34 times per row and is a few percent of
// the similarity cost at d >= 2048; at d <= 3 (time, location) it dominates.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // 8 warps
constexpr int kTileCols = 256;    // columns per similarity tile: one per thread
constexpr int kDk = 32;           // feature chunk staged in shared memory
constexpr float kNeg = -1e30f;    // masked similarity (matches the reference)
constexpr int kVecsPerRow = kDk / 4;                          // float4 per chunk row
constexpr int kColVecs = kTileCols * kVecsPerRow / kThreads;   // float4 per thread

enum Metric { kDot = 0, kEuclidean = 1, kJaccard = 2, kL1 = 3, kChord3 = 4 };

// Order-preserving map of a float to uint32 (IEEE total order for non-NaN).
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(0xffffffffu, v);
}

// One feature step: column value b against the TM row values a[0..TM).
template <int TM, int METRIC>
__device__ __forceinline__ void accumulate(float (&acc)[TM], float& col_size,
                                           const float* a, float b) {
  if (METRIC == kJaccard) col_size += b;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    if (METRIC == kDot || METRIC == kJaccard) {
      acc[r] = fmaf(a[r], b, acc[r]);
    } else if (METRIC == kEuclidean) {
      const float t = a[r] - b;
      acc[r] = fmaf(t, t, acc[r]);
    } else if (METRIC == kL1) {
      // no contraction: |dt_taken| + |dt_upload| in the reference's order
      acc[r] = __fadd_rn(acc[r], fabsf(__fsub_rn(a[r], b)));
    } else {   // kChord3: ((dx^2 + dy^2) + dz^2), unfused like the reference
      const float t = __fsub_rn(a[r], b);
      acc[r] = __fadd_rn(acc[r], __fmul_rn(t, t));
    }
  }
}

size_t smem_floats(int tm, int n_pad) {
  return (size_t)tm * n_pad                // similarity strip
         + (size_t)kTileCols * (kDk + 1)   // column chunk (padded: no bank conflicts)
         + (size_t)kDk * tm                // row chunk, [kDk][TM]
         + (size_t)tm;                     // row set sizes (jaccard)
}

template <int TM, int METRIC>
__global__ void __launch_bounds__(kThreads)
knn_adjacency_kernel(const float* __restrict__ x, const uint8_t* __restrict__ valid,
                     float* __restrict__ out, int n, int d, int n_pad, int k) {
  extern __shared__ float smem[];
  float* strip = smem;
  float* col_tile = strip + (size_t)TM * n_pad;
  float* row_tile = col_tile + kTileCols * (kDk + 1);
  float* row_size = row_tile + kDk * TM;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * TM;

  if (METRIC == kJaccard) {   // row set sizes, one warp per row
    for (int r = warp; r < TM; r += kThreads / 32) {
      const int gr = row0 + r;
      float s = 0.f;
      if (gr < n)
        for (int c = lane; c < d; c += 32) s += x[(size_t)gr * d + c];
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) row_size[r] = s;
    }
  }

  // ---- similarities of the TM rows against every column -> strip --------
  // Rows 16-byte aligned (d % 4 == 0, the wide modalities): each 32-deep
  // chunk is staged as float4 loads with shift/mask indices, and the next
  // chunk's loads are issued into registers before the current chunk is
  // computed, so their latency hides behind the FMAs.  Small or odd d
  // (location, time) stages scalars.
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  for (int c0 = 0; c0 < n_pad; c0 += kTileCols) {
    float acc[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[r] = 0.f;
    float col_size = 0.f;

    if (vec) {
      float4 cpre[kColVecs];
      float4 rpre = make_float4(0.f, 0.f, 0.f, 0.f);
      auto load = [&](int d0) {
#pragma unroll
        for (int s = 0; s < kColVecs; ++s) {
          const int e = tid + s * kThreads;            // float4 index in the chunk
          const int gr = c0 + e / kVecsPerRow, gc = d0 + (e % kVecsPerRow) * 4;
          cpre[s] = (gr < n && gc < d)
                        ? *reinterpret_cast<const float4*>(x + (size_t)gr * d + gc)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        if (tid < TM * kVecsPerRow) {
          const int gr = row0 + tid / kVecsPerRow, gc = d0 + (tid % kVecsPerRow) * 4;
          rpre = (gr < n && gc < d)
                     ? *reinterpret_cast<const float4*>(x + (size_t)gr * d + gc)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      };
      load(0);
      for (int d0 = 0; d0 < d; d0 += kDk) {
        __syncthreads();   // everyone is done reading the previous chunk
#pragma unroll
        for (int s = 0; s < kColVecs; ++s) {
          const int e = tid + s * kThreads;
          float* dst = col_tile + (e / kVecsPerRow) * (kDk + 1) + (e % kVecsPerRow) * 4;
          dst[0] = cpre[s].x; dst[1] = cpre[s].y; dst[2] = cpre[s].z; dst[3] = cpre[s].w;
        }
        if (tid < TM * kVecsPerRow) {
          const int rr = tid / kVecsPerRow, cc = (tid % kVecsPerRow) * 4;
          row_tile[(cc + 0) * TM + rr] = rpre.x;
          row_tile[(cc + 1) * TM + rr] = rpre.y;
          row_tile[(cc + 2) * TM + rr] = rpre.z;
          row_tile[(cc + 3) * TM + rr] = rpre.w;
        }
        __syncthreads();
        if (d0 + kDk < d) load(d0 + kDk);   // in flight while this chunk computes
        const float* b = col_tile + tid * (kDk + 1);
        if (d - d0 >= kDk) {
#pragma unroll
          for (int dk = 0; dk < kDk; ++dk)
            accumulate<TM, METRIC>(acc, col_size, row_tile + dk * TM, b[dk]);
        } else {
          for (int dk = 0; dk < d - d0; ++dk)
            accumulate<TM, METRIC>(acc, col_size, row_tile + dk * TM, b[dk]);
        }
      }
    } else {
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
          accumulate<TM, METRIC>(acc, col_size, row_tile + dk * TM,
                                 col_tile[tid * (kDk + 1) + dk]);
        __syncthreads();
      }
    }

    const int col = c0 + tid;
    const bool col_ok = col < n && valid[col] != 0;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      float sim;
      if (METRIC == kDot) {
        sim = acc[r];
      } else if (METRIC == kJaccard) {
        const float uni = __fsub_rn(__fadd_rn(row_size[r], col_size), acc[r]);
        sim = uni > 0.f ? __fdiv_rn(acc[r], fmaxf(uni, 1e-9f)) : 0.f;
      } else {
        sim = -acc[r];
      }
      strip[(size_t)r * n_pad + col] = (col_ok && row0 + r != col) ? sim : kNeg;
    }
  }
  __syncthreads();

  // ---- exact top-k select, one warp per row ------------------------------
  for (int r = warp; r < TM; r += kThreads / 32) {
    const int gr = row0 + r;
    if (gr >= n) continue;
    const float* srow = strip + (size_t)r * n_pad;
    float* orow = out + (size_t)gr * n;

    int n_valid = 0;
    for (int c = lane; c < n_pad; c += 32) n_valid += srow[c] > 0.5f * kNeg;
    const int keff = valid[gr] ? min(k, warp_sum(n_valid)) : 0;
    if (keff == 0) {
      for (int c = lane; c < n; c += 32) orow[c] = 0.f;
      continue;
    }
    // largest key t with #{key >= t} >= keff, i.e. the keff-th largest key
    uint64_t lo = 0, hi = 1ull << 32;
    while (hi - lo > 1) {
      const uint64_t mid = (lo + hi) >> 1;
      int cnt = 0;
      for (int c = lane; c < n_pad; c += 32) cnt += order_key(srow[c]) >= (uint32_t)mid;
      if (warp_sum(cnt) >= keff) lo = mid; else hi = mid;
    }
    const uint32_t kth = (uint32_t)lo;
    int above = 0;
    for (int c = lane; c < n_pad; c += 32) above += order_key(srow[c]) > kth;
    const int need = keff - warp_sum(above);

    int taken = 0;   // ties kept so far, in column order
    for (int base = 0; base < n; base += 32) {
      const int c = base + lane;
      const uint32_t key = c < n ? order_key(srow[c]) : 0u;
      const bool tie = c < n && key == kth;
      const unsigned m = __ballot_sync(0xffffffffu, tie);
      const int rank = taken + __popc(m & ((1u << lane) - 1u));
      if (c < n) orow[c] = (key > kth || (tie && rank < need)) ? 1.f : 0.f;
      taken += __popc(m);
    }
  }
}

int max_smem_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)
      != cudaSuccess)
    return 0;
  return bytes;
}

// Largest row tile in {16, 8, 4, 2, 1} whose strip fits shared memory.
int rows_per_block(int n) {
  const int n_pad = (n + kTileCols - 1) / kTileCols * kTileCols;
  const size_t limit = (size_t)max_smem_bytes();
  for (int tm = 16; tm >= 1; tm >>= 1)
    if (smem_floats(tm, n_pad) * sizeof(float) <= limit) return tm;
  return 0;
}

template <int TM, int METRIC>
cudaError_t launch(const float* x, const uint8_t* valid, float* out, int n, int d,
                   int k, cudaStream_t stream) {
  const int n_pad = (n + kTileCols - 1) / kTileCols * kTileCols;
  const size_t smem = smem_floats(TM, n_pad) * sizeof(float);
  auto kern = knn_adjacency_kernel<TM, METRIC>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<(n + TM - 1) / TM, kThreads, smem, stream>>>(x, valid, out, n, d, n_pad, k);
  return cudaGetLastError();
}

template <int TM>
cudaError_t launch_metric(int metric, const float* x, const uint8_t* valid, float* out,
                          int n, int d, int k, cudaStream_t s) {
  switch (metric) {
    case kDot: return launch<TM, kDot>(x, valid, out, n, d, k, s);
    case kEuclidean: return launch<TM, kEuclidean>(x, valid, out, n, d, k, s);
    case kJaccard: return launch<TM, kJaccard>(x, valid, out, n, d, k, s);
    case kL1: return launch<TM, kL1>(x, valid, out, n, d, k, s);
    case kChord3: return launch<TM, kChord3>(x, valid, out, n, d, k, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (n, d) f32 row-major, valid (n,) bytes 0/1, out (n, n) f32; 1 <= k < n.
// Launches on `stream` and returns cudaGetLastError() after the launch.
int mused_knn_adjacency(const void* x, const void* valid, void* out, int n, int d,
                        int k, int metric, void* stream) {
  if (n <= 0 || d <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_per_block(n)) {
    case 16: return (int)launch_metric<16>(metric, xf, v, o, n, d, k, s);
    case 8: return (int)launch_metric<8>(metric, xf, v, o, n, d, k, s);
    case 4: return (int)launch_metric<4>(metric, xf, v, o, n, d, k, s);
    case 2: return (int)launch_metric<2>(metric, xf, v, o, n, d, k, s);
    case 1: return (int)launch_metric<1>(metric, xf, v, o, n, d, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Row tile the kernel picks for an n-row window (0: n does not fit).
int mused_knn_rows_per_block(int n) { return rows_per_block(n); }

const char* mused_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
