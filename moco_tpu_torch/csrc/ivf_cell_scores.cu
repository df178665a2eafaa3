// IVF cell scan: scores of each query against every row of each of its
// probed cells.
//
// Replaces the TPU kernel `_fused_cell_scores_kernel`
// (moco_tpu/serve/index.py:273, launched by `_fused_cell_scores_pallas`):
// there a grid step (query i, probe j) DMAs the cell tile
// cell_rows[probes[i, j]] (cell_cap, d), picked through scalar prefetch,
// and takes one (1, d) x (cell_cap, d)^T dot.
//
//   out[i, j, c] = sum_t queries[i, t] * cell_rows[probes[i, j], c, t]
//
// Bound: bytes. Each output is one d-long dot product, 2 flops per 4 bytes
// of cell row read, far below the card's ~20 flop/byte f32 balance point.
// At the serving shapes (d=128, cell_cap=512, nprobe=16, m<=128) the
// cell-major copy is 67 MB, more than the 50 MB L2, and a block streams
// its whole cell tile once.
//
// Design: one block per (query, probe) pair. The block loads its own probe
// id (the TPU's scalar prefetch). Each warp keeps the query in registers
// (lane l holds float4 number l, l+32, ...; one float4 per lane at d=128),
// walks the cell's rows with 16-byte loads where neighbouring lanes read
// neighbouring addresses, takes ROWS_PER_ITER rows per trip so several
// loads are in flight, and reduces each row with __shfl_xor_sync. A probe
// id outside [0, nlist) is never dereferenced: its scores are NaN.
// cp.async / TMA staging and bf16 cells are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVec = 4;  // float4 per lane: d <= 4 * 32 * 4 = 512
constexpr int kRowsPerIter = 4;

__global__ void __launch_bounds__(kThreads)
cell_scores_kernel(const float* __restrict__ queries,   // (m, d)
                   const float* __restrict__ cell_rows, // (nlist, cell_cap, d)
                   const int* __restrict__ probes,      // (m, nprobe)
                   float* __restrict__ out,             // (m, nprobe, cell_cap)
                   int nprobe, int nlist, int cell_cap, int d) {
  const int pair = blockIdx.x;  // i * nprobe + j
  const int i = pair / nprobe;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nvec = d >> 2;
  float* out_pair = out + static_cast<size_t>(pair) * cell_cap;

  const int cell = probes[pair];
  if (cell < 0 || cell >= nlist) {
    for (int c = threadIdx.x; c < cell_cap; c += kThreads) out_pair[c] = NAN;
    return;
  }

  const float4* q4 = reinterpret_cast<const float4*>(queries + static_cast<size_t>(i) * d);
  float4 q[kMaxVec];
#pragma unroll
  for (int v = 0; v < kMaxVec; ++v) {
    const int t = lane + 32 * v;
    q[v] = t < nvec ? q4[t] : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const float4* tile = reinterpret_cast<const float4*>(
      cell_rows + static_cast<size_t>(cell) * cell_cap * d);

  for (int r0 = warp * kRowsPerIter; r0 < cell_cap; r0 += kWarps * kRowsPerIter) {
    float acc[kRowsPerIter];
#pragma unroll
    for (int u = 0; u < kRowsPerIter; ++u) acc[u] = 0.f;
#pragma unroll
    for (int v = 0; v < kMaxVec; ++v) {
      const int t = lane + 32 * v;
      if (t < nvec) {
        float4 x[kRowsPerIter];
#pragma unroll
        for (int u = 0; u < kRowsPerIter; ++u) {
          const int r = r0 + u;
          x[u] = r < cell_cap ? tile[static_cast<size_t>(r) * nvec + t]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kRowsPerIter; ++u) {
          acc[u] = fmaf(q[v].x, x[u].x, acc[u]);
          acc[u] = fmaf(q[v].y, x[u].y, acc[u]);
          acc[u] = fmaf(q[v].z, x[u].z, acc[u]);
          acc[u] = fmaf(q[v].w, x[u].w, acc[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsPerIter; ++u) {
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], s);
    }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kRowsPerIter; ++u) {
        if (r0 + u < cell_cap) out_pair[r0 + u] = acc[u];
      }
    }
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// The caller has checked shapes, dtypes, contiguity, 16-byte alignment,
// d % 4 == 0 and d <= 512.
extern "C" int ivf_cell_scores_f32(const void* queries, const void* cell_rows,
                                   const void* probes, void* out, int m,
                                   int nprobe, int nlist, int cell_cap, int d,
                                   void* stream) {
  const long long pairs = static_cast<long long>(m) * nprobe;
  if (pairs == 0 || cell_cap == 0) return 0;
  cell_scores_kernel<<<static_cast<unsigned>(pairs), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries), static_cast<const float*>(cell_rows),
      static_cast<const int*>(probes), static_cast<float*>(out), nprobe, nlist,
      cell_cap, d);
  return static_cast<int>(cudaGetLastError());
}
