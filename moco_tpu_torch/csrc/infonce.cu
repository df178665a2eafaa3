// Fused streaming InfoNCE: forward statistics and the backward of the
// negative term, without materializing the (B, 1+K) logits.
//
// Replaces the TPU kernels of moco_tpu/ops/fused_infonce.py:
// - `_fwd_kernel` (:40, launched by `_forward` :94): per query row,
//     pos     = (q . k) / T
//     lse     = logsumexp([pos, q . queue_j / T for j < K])
//     n_above = #{j : q . queue_j / T > pos}
//   with the queue streamed tile by tile on one sequential grid that
//   carries a running (max m, sum l, count) in VMEM scratch;
// - `_bwd_kernel` (:71, launched by `_vjp_bwd` :158):
//     dq_neg = sum_j exp(q . queue_j / T - lse) * g_lse * queue_j / T
//   streaming the queue again. The positive term is added by the caller.
//
// Bound: operations. Each pass does 2*B*K*C flops (the backward twice
// that: it recomputes the scores and then takes the second product) in
// f32 on the CUDA cores, and reads the (K, C) queue once: at B=256,
// K=65536, C=128 that is 4.29 GFLOP against 33.5 MB, ~128 flop/byte, far
// above the card's f32 balance point of ~20 flop/byte.
//
// Design. The TPU walks K on one sequential grid; here K is split across
// CTAs as flash-decoding does, because B=256 rows alone would fill 4 of
// 132 SMs. Grid = (ceil(B/64), n_split); CTA (bx, s) takes query rows
// [64 bx, 64 bx + 64) and queue tiles [s*tps, (s+1)*tps) of 64 rows.
// - The CTA stages its 64 query rows in shared memory once, then streams
//   its queue rows in 64-row tiles through shared memory (row stride C|1,
//   odd, so the strided reads below hit 16 distinct banks).
// - 256 threads as 16 x 16: thread (ty, tx) owns query rows ty + 16 i and
//   keys tx + 16 j (i, j < 4), a 4 x 4 register tile of
//   s = (q . key) * inv_t in f32 FMA, summed over c = 0..C-1 in order.
//   Multiplying by inv_t (as the TPU kernel does) keeps the comparison
//   with pos rounding the same way.
// - Forward: each thread folds its tile into a running (m, l, count) per
//   row; at the end the 16 threads of a row (one half-warp) merge theirs
//   with xor shuffles and write per-split partials (n_split, B). A merge
//   kernel, one thread per row in split order, adds the positive once
//   (m = pos, l = 1) and writes pos, lse = m + log l and n_above.
// - Backward: p = exp(s - lse) * g_lse goes to shared memory and each
//   thread accumulates its (4 rows x NCOL cols) of p @ tile in
//   registers; the CTA writes its (64, C) partial to (n_split, B, C) and a
//   reduce kernel sums over splits in order and scales by inv_t. No
//   atomics: the result is the same bits on every run.
// Keys past K are masked (score -inf, p = 0), so any K works.
// Tensor-core (wgmma) and TMA-pipelined versions are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // query rows per CTA
constexpr int kTile = 64;     // queue rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxC = 256;

__host__ __device__ inline int odd_stride(int c) { return c | 1; }

// Load 64 rows of a row-major (n, C) matrix starting at row `row0` into
// shared memory with row stride ld; rows at or past n are zero.
__device__ inline void load_rows(float* dst, const float* __restrict__ src, int row0, int n,
                                 int C, int ld) {
  for (int idx = threadIdx.x; idx < kTile * C; idx += kThreads) {
    const int r = idx / C;
    const int c = idx - r * C;
    const int g = row0 + r;
    dst[r * ld + c] = g < n ? src[static_cast<size_t>(g) * C + c] : 0.f;
  }
}

// s[i][j] = (Q[ty + 16 i] . K[tx + 16 j]) * inv_t, f32 FMA in c order.
__device__ inline void score_tile(const float* qs, const float* ks, int C, int ld, int ty, int tx,
                                  float inv_t, float s[4][4]) {
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < C; ++c) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * ld + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * ld + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = acc[i][j] * inv_t;
}

// (m, l) of a logsumexp merged with (m2, l2); an empty side has l == 0.
__device__ inline void lse_merge(float& m, float& l, float m2, float l2) {
  if (l2 == 0.f) return;
  if (l == 0.f) {
    m = m2;
    l = l2;
    return;
  }
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

__global__ void __launch_bounds__(kThreads)
fwd_partial_kernel(const float* __restrict__ q,      // (B, C)
                   const float* __restrict__ k,      // (B, C)
                   const float* __restrict__ queue,  // (K, C)
                   float* __restrict__ pos_out,      // (B,)
                   float* __restrict__ m_part,       // (n_split, B)
                   float* __restrict__ l_part,       // (n_split, B)
                   int* __restrict__ c_part,         // (n_split, B)
                   int B, int K, int C, int tiles_per_split, float inv_t) {
  extern __shared__ float smem[];
  const int ld = odd_stride(C);
  float* qs = smem;               // (64, ld)
  float* ks = smem + kRows * ld;  // (64, ld)
  __shared__ float pos_s[kRows];

  const int row0 = blockIdx.x * kRows;
  const int split = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows(qs, q, row0, B, C, ld);
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int r = row0 + threadIdx.x;
    float dot = 0.f;
    if (r < B) {
      const float* kr = k + static_cast<size_t>(r) * C;
      for (int c = 0; c < C; ++c) dot = fmaf(qs[threadIdx.x * ld + c], kr[c], dot);
    }
    pos_s[threadIdx.x] = dot * inv_t;
    if (split == 0 && r < B) pos_out[r] = dot * inv_t;
  }
  __syncthreads();

  float pos[4], m[4], l[4];
  int cnt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pos[i] = pos_s[ty + 16 * i];
    m[i] = -INFINITY;
    l[i] = 0.f;
    cnt[i] = 0;
  }

  const int t_begin = split * tiles_per_split;
  const int n_tiles = (K + kTile - 1) / kTile;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  for (int t = t_begin; t < t_end; ++t) {
    const int key0 = t * kTile;
    load_rows(ks, queue, key0, K, C, ld);
    __syncthreads();
    float s[4][4];
    score_tile(qs, ks, C, ld, ty, tx, inv_t, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (key0 + tx + 16 * j < K) {
          tmax = fmaxf(tmax, s[i][j]);
          cnt[i] += s[i][j] > pos[i];
        }
      }
      if (tmax == -INFINITY) continue;
      const float mn = fmaxf(m[i], tmax);
      float sum = l[i] == 0.f ? 0.f : l[i] * expf(m[i] - mn);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (key0 + tx + 16 * j < K) sum += expf(s[i][j] - mn);
      }
      m[i] = mn;
      l[i] = sum;
    }
    __syncthreads();  // the tile is read; the next load may overwrite it
  }

  // merge the 16 threads of each row (one half-warp) in a fixed tree
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[i], off);
      const int c2 = __shfl_xor_sync(0xffffffffu, cnt[i], off);
      lse_merge(m[i], l[i], m2, l2);
      cnt[i] += c2;
    }
    const int r = row0 + ty + 16 * i;
    if (tx == 0 && r < B) {
      const size_t o = static_cast<size_t>(split) * B + r;
      m_part[o] = m[i];
      l_part[o] = l[i];
      c_part[o] = cnt[i];
    }
  }
}

__global__ void fwd_merge_kernel(const float* __restrict__ pos, const float* __restrict__ m_part,
                                 const float* __restrict__ l_part, const int* __restrict__ c_part,
                                 float* __restrict__ lse, int* __restrict__ n_above, int B,
                                 int n_split) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  float m = pos[r], l = 1.f;  // the positive, exactly once
  int cnt = 0;
  for (int s = 0; s < n_split; ++s) {
    const size_t o = static_cast<size_t>(s) * B + r;
    lse_merge(m, l, m_part[o], l_part[o]);
    cnt += c_part[o];
  }
  lse[r] = m + logf(l);
  n_above[r] = cnt;
}

template <int NCOL>
__global__ void __launch_bounds__(kThreads)
bwd_partial_kernel(const float* __restrict__ q,      // (B, C)
                   const float* __restrict__ queue,  // (K, C)
                   const float* __restrict__ lse,    // (B,)
                   const float* __restrict__ g_lse,  // (B,)
                   float* __restrict__ dq_part,      // (n_split, B, C)
                   int B, int K, int C, int tiles_per_split, float inv_t) {
  extern __shared__ float smem[];
  const int ld = odd_stride(C);
  constexpr int kPld = kTile + 1;
  float* qs = smem;                   // (64, ld)
  float* ks = qs + kRows * ld;        // (64, ld)
  float* ps = ks + kTile * ld;        // (64, 65)

  const int row0 = blockIdx.x * kRows;
  const int split = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows(qs, q, row0, B, C, ld);
  float row_lse[4], row_g[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    row_lse[i] = r < B ? lse[r] : 0.f;
    row_g[i] = r < B ? g_lse[r] : 0.f;
  }
  float acc[4][NCOL];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NCOL; ++j) acc[i][j] = 0.f;

  const int t_begin = split * tiles_per_split;
  const int n_tiles = (K + kTile - 1) / kTile;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  for (int t = t_begin; t < t_end; ++t) {
    const int key0 = t * kTile;
    load_rows(ks, queue, key0, K, C, ld);
    __syncthreads();
    float s[4][4];
    score_tile(qs, ks, C, ld, ty, tx, inv_t, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = key0 + tx + 16 * j < K;
        ps[(ty + 16 * i) * kPld + tx + 16 * j] =
            live ? expf(s[i][j] - row_lse[i]) * row_g[i] : 0.f;
      }
    __syncthreads();
    for (int kk = 0; kk < kTile; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kPld + kk];
#pragma unroll
      for (int j = 0; j < NCOL; ++j) {
        const int c = tx + 16 * j;
        const float b = c < C ? ks[kk * ld + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], b, acc[i][j]);
      }
    }
    __syncthreads();  // ks and ps are read; the next tile may overwrite them
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= B) continue;
    float* out = dq_part + (static_cast<size_t>(split) * B + r) * C;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const int c = tx + 16 * j;
      if (c < C) out[c] = acc[i][j];
    }
  }
}

__global__ void bwd_reduce_kernel(const float* __restrict__ dq_part, float* __restrict__ dq,
                                  int BC, int n_split, float inv_t) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= BC) return;
  float sum = 0.f;
  for (int s = 0; s < n_split; ++s) sum += dq_part[static_cast<size_t>(s) * BC + e];
  dq[e] = sum * inv_t;
}

size_t fwd_smem(int C) { return 2 * kRows * odd_stride(C) * sizeof(float); }
size_t bwd_smem(int C) {
  return (2 * kRows * odd_stride(C) + kRows * (kTile + 1)) * sizeof(float);
}

template <int NCOL>
cudaError_t launch_bwd(dim3 grid, size_t smem, cudaStream_t stream, const float* q,
                       const float* queue, const float* lse, const float* g_lse, float* dq_part,
                       int B, int K, int C, int tiles_per_split, float inv_t) {
  cudaError_t err = cudaFuncSetAttribute(bwd_partial_kernel<NCOL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bwd_partial_kernel<NCOL><<<grid, kThreads, smem, stream>>>(q, queue, lse, g_lse, dq_part, B, K,
                                                             C, tiles_per_split, inv_t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward statistics. The caller allocates every output and the partials
// (n_split, B) and has checked dtypes (f32, i32 counts), contiguity,
// 0 < C <= 256, B > 0, K > 0 and n_split * tiles_per_split >= ceil(K/64).
// Launches on `stream`; returns the cudaError_t (0 = success).
int infonce_fwd_f32(const void* q, const void* k, const void* queue, void* pos, void* lse,
                    void* n_above, void* m_part, void* l_part, void* c_part, int B, int K, int C,
                    int n_split, int tiles_per_split, float inv_t, void* stream) {
  if (B <= 0 || K <= 0 || C <= 0 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = fwd_smem(C);
  cudaError_t err = cudaFuncSetAttribute(fwd_partial_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kRows - 1) / kRows, n_split);
  fwd_partial_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(queue), static_cast<float*>(pos), static_cast<float*>(m_part),
      static_cast<float*>(l_part), static_cast<int*>(c_part), B, K, C, tiles_per_split, inv_t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_merge_kernel<<<(B + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(pos), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<const int*>(c_part),
      static_cast<float*>(lse), static_cast<int*>(n_above), B, n_split);
  return static_cast<int>(cudaGetLastError());
}

// Backward of the negative term: dq = inv_t * sum_j exp(s_j - lse) g_lse queue_j.
// Same checks as the forward; dq_part is (n_split, B, C) f32 scratch.
int infonce_bwd_f32(const void* q, const void* queue, const void* lse, const void* g_lse,
                    void* dq_part, void* dq, int B, int K, int C, int n_split,
                    int tiles_per_split, float inv_t, void* stream) {
  if (B <= 0 || K <= 0 || C <= 0 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_smem(C);
  const dim3 grid((B + kRows - 1) / kRows, n_split);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(queue);
  const float* lf = static_cast<const float*>(lse);
  const float* gf = static_cast<const float*>(g_lse);
  float* part = static_cast<float*>(dq_part);
  const int ncol = (C + 15) / 16;
  cudaError_t err;
  if (ncol <= 1)
    err = launch_bwd<1>(grid, smem, s, qf, kf, lf, gf, part, B, K, C, tiles_per_split, inv_t);
  else if (ncol <= 2)
    err = launch_bwd<2>(grid, smem, s, qf, kf, lf, gf, part, B, K, C, tiles_per_split, inv_t);
  else if (ncol <= 4)
    err = launch_bwd<4>(grid, smem, s, qf, kf, lf, gf, part, B, K, C, tiles_per_split, inv_t);
  else if (ncol <= 8)
    err = launch_bwd<8>(grid, smem, s, qf, kf, lf, gf, part, B, K, C, tiles_per_split, inv_t);
  else
    err = launch_bwd<16>(grid, smem, s, qf, kf, lf, gf, part, B, K, C, tiles_per_split, inv_t);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bc = B * C;
  bwd_reduce_kernel<<<(bc + 255) / 256, 256, 0, s>>>(part, static_cast<float*>(dq), bc, n_split,
                                                      inv_t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
