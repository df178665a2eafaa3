// Flash attention for the ViT: non-causal attention over (B*H, S, D)
// with its two backward kernels, any S (the tail is masked), D in
// {32, 64, 128}, f32 or bf16 inputs with f32 accumulation.
//
// Replaces the TPU kernels of moco_tpu/ops/flash_attention.py:
// - `_flash_kernel` (:73, launched by `_flash_forward` :150):
//     s = (q . k) * scale, keys >= S masked; out = softmax(s) v in the
//     input dtype, p rounded to the input dtype before the p.v product;
//     lse = logsumexp(s) in f32;
// - `_dq_kernel` (:177, launched by `_flash_backward_pallas` :290):
//     p = exp(s - lse); ds = p (g.v^T + coeff), coeff = g_lse - delta;
//     dq = scale * ds.k, ds rounded to the input dtype;
// - `_dkv_kernel` (:225, launched at :307):
//     dv = p^T.g (p rounded), dk = scale * ds^T.q (ds rounded); query rows
//     at or past S contribute nothing (the TPU kernel gives them LSE_PAD,
//     these kernels mask them by index).
// delta = sum(g * out) and coeff = g_lse - delta are (B*H, S) f32 inputs
// computed by the caller, as the TPU path computes delta outside its
// kernels (:278).
//
// Which kernel runs: bf16 inputs take the tensor-core forward
// (`flash_fwd_mma_kernel`), dq (`flash_dq_mma_kernel`) and dk/dv
// (`flash_dkv_mma_kernel`); f32 inputs take the CUDA-core
// `flash_fwd_kernel`, `flash_dq_kernel` and `flash_dkv_kernel` (TF32 would
// break the f32 tolerances the plain versions are held to). Each (kernel,
// dtype) has one code path.
//
// Bound. At the ViT's S = 197, D = 64 attention is bytes-bound on this
// card: the forward does 4 S^2 D flops against 4 S D elements moved, about
// 98 flop/byte in bf16 (the ridge is ~295). For the v3 path's 6144
// (b, h) pairs in bf16: forward 0.19 ms, dq 0.23 ms, dk/dv 0.28 ms at
// 3.35 TB/s (chip_smoke.py recomputes each bound from the shapes it runs).
// The padded 68 GFLOP of the bf16 forward (S to 208) take ~0.14 ms at half
// the tensor rate, so `mma.sync` is enough to reach the byte bound.
//
// Common design. The TPU kernel holds the whole K/V of a (b, h) in VMEM and
// walks it on a sequential grid. Here every CTA owns one 64-row tile of one
// (b, h) (query rows for the forward and dq, key rows for dk/dv) and
// streams the other side in 64-row tiles through shared memory. The grid
// is one-dimensional, B*H * ceil(S/64) CTAs (4 x 6144 at the path's
// shape), with a head's tiles adjacent in launch order so they find its
// streamed side in L2; any B*H works as long as the CTA count fits the
// grid's 2^31 - 1. Nothing carries across CTAs: no partials, no atomics.
//
// The bf16 tensor-core kernels (128 threads: 4 warps x 16 rows of the tile).
// - Products are `mma.sync.m16n8k16` bf16 -> f32 (HMMA). Operands are read
//   from shared memory by `ldmatrix` (`.trans` for the right operand of the
//   second product), from tiles whose rows are padded to D + 8 elements so
//   the eight 16-byte rows of each 8 x 8 matrix fall in distinct banks.
// - The streamed side goes through a 2-stage ring of 16-byte
//   `cp.async.cg` copies: tile t + 1 is in flight while tile t is used.
//   Rows at or past S are zero-filled, so 0 x garbage never makes a NaN.
// - Forward: each warp holds its 16 query rows as A fragments in registers,
//   takes S = Q.K^T into accumulator fragments, runs the online softmax on
//   them (running m and l per row, reduced over the quad by shuffles, l
//   summing the unrounded p), and converts p to bf16 straight into the A
//   fragment of O += P.V. P never touches shared memory.
// - dq: each warp holds its 16 query rows of Q and G as A fragments and
//   its rows' lse and coeff in registers; per 16-key chunk it takes S =
//   Q.K^T and dP = G.V^T, forms P = exp(scale S - lse) and dS = P (dP +
//   coeff) on the accumulator fragments, rounds dS to bf16 straight into
//   an A fragment and accumulates dQ += dS.K with K read transposed from
//   the same staged tile. Neither P nor dS touches shared memory.
// - dk/dv: each warp holds its 16 keys of K and V as A fragments and takes
//   the transposed scores S^T = K.Q^T and dP^T = V.G^T for one 16-query
//   chunk at a time; P^T = exp(scale S^T - lse[q]) and dS^T = P^T (dP^T +
//   coeff[q]) are formed in registers, rounded to bf16 in the A-fragment
//   layout, and accumulated as dV += P^T.G and dK += dS^T.Q with G and Q
//   read transposed from the same staged tile. Each of Q and G is staged
//   once; lse and coeff are staged beside them; no P/dS buffer, no barrier
//   between the two products.
// - Masking is tile-granular: only 16-key (forward, dq) or 16-query
//   (dk/dv) chunks holding an index below S are computed, and only the
//   last tile masks by index. At S = 197 that is 208 keys, not 256. Warps
//   whose 16 rows all lie past S do no math.
// - Rounding follows the TPU kernels: p rounded to bf16 relative to the
//   running max before p.v and lse = m + log(l) in f32 (forward); dS (from
//   the unrounded p) before dS.k, scale applied at the store (dq); p before
//   p^T.g, dS (from the unrounded p) before dS^T.q, scale applied to dK at
//   the store (dk/dv).
// - Shared memory per CTA: forward 5 tiles of 64 x (D + 8) bf16 (Q and two
//   stages of K and V), 46,080 bytes at D = 64; dq 6 tiles (Q, G, two
//   stages of K and V), 55,296 bytes; dk/dv 6 tiles (K, V, two stages of Q
//   and G) plus 1 KiB of lse/coeff, 56,320 bytes at D = 64.
//   Registers per thread (`ptxas -v`, ops/build.py NVCC_FLAGS, as
//   chip_smoke.py prints it): forward 90 / 128 / 214 at D = 32 / 64 / 128,
//   dq 78 / 126 / 219, dk/dv 96 / 166 / 255 with a 20-byte spill at D =
//   128. At D = 64 that is 4 forward or dq CTAs, or 3 dk/dv CTAs, per SM.
//
// The f32 CUDA-core kernels (256 threads, 16 x 16).
// - Operands are staged in two layouts: the "score" operands
//   (q, k, g, v as the left and right of q.k^T and g.v^T) transposed,
//   (D, 64), so the 256 threads (16 x 16) each take a 4 x 4 register tile
//   of the 64 x 64 scores with two float4 shared-memory loads per 16 FMAs;
//   the operand of the second product (v, k, q, g) row-major, (64, D).
// - P (or dS) goes to shared memory row-major, (64, 68), one float4 per
//   thread and row, and the second product reads it back as float4 over
//   four keys: each thread accumulates 4 rows x D/16 columns.
// - f32 FMAs on the CUDA cores; the TPU kernel's roundings of p and dS to
//   the input dtype are no-ops in f32.
// - The forward skips the warps whose rows all lie past S and the second
//   product stops at the tile's last valid key (rounded up to 4; those
//   entries of P and the operand rows are zero).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // rows of a tile: query rows or keys
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPld = kTile + 4;  // row stride of the P / dS tile (16-byte rows)
constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernel

__host__ __device__ constexpr int tiles_of(int S) { return (S + kTile - 1) / kTile; }

// The CTA's (b, h) and the first row of its 64-row tile, from the
// one-dimensional grid of B*H * ceil(S/64) CTAs (a head's tiles adjacent).
struct TileId {
  int bh, row0;
};
__device__ __forceinline__ TileId tile_id(int S) {
  const unsigned n_tiles = tiles_of(S);
  return {static_cast<int>(blockIdx.x / n_tiles), static_cast<int>(blockIdx.x % n_tiles) * kTile};
}

// Four consecutive elements of a row; `p` is 16-byte aligned because
// D % 4 == 0 and the wrapper checks the base.
__device__ inline void load4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

// Rows [row0, row0 + 64) of a (n, D) matrix into dst (D, 64), transposed;
// rows at or past n are zero. Lanes walk rows, so the stores to
// shared memory hit 32 distinct banks.
template <int D>
__device__ inline void load_t(float* dst, const float* __restrict__ src, int row0, int n) {
  for (int idx = threadIdx.x; idx < kTile * (D / 4); idx += kThreads) {
    const int r = idx % kTile;
    const int d = (idx / kTile) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < n) load4(src + static_cast<size_t>(row0 + r) * D + d, v);
#pragma unroll
    for (int c = 0; c < 4; ++c) dst[(d + c) * kTile + r] = v[c];
  }
}

// The same rows into dst (64, D), row-major.
template <int D>
__device__ inline void load_rows(float* dst, const float* __restrict__ src, int row0, int n) {
  for (int idx = threadIdx.x; idx < kTile * (D / 4); idx += kThreads) {
    const int r = idx / (D / 4);
    const int d = (idx % (D / 4)) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < n) load4(src + static_cast<size_t>(row0 + r) * D + d, v);
    *reinterpret_cast<float4*>(dst + r * D + d) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// The D/16 output columns of thread tx: runs of CW contiguous columns,
// CW = 4 (D >= 64) or 2 (D = 32), the runs 16 * CW apart, so each run is
// contiguous across the 16 threads of a row.
template <int D>
struct Cols {
  static constexpr int kN = D / 16;
  static constexpr int kCW = D >= 64 ? 4 : D / 16;
  static __device__ __forceinline__ int col(int tx, int n) {
    return kCW * tx + 16 * kCW * (n / kCW) + n % kCW;
  }
};

template <int D>
__device__ inline void load_cols(const float* row, int tx, float b[D / 16]) {
  using C = Cols<D>;
#pragma unroll
  for (int n = 0; n < C::kN; n += C::kCW) {
    const float* p = row + C::col(tx, n);
    if constexpr (C::kCW == 4) {
      const float4 x = *reinterpret_cast<const float4*>(p);
      b[n] = x.x; b[n + 1] = x.y; b[n + 2] = x.z; b[n + 3] = x.w;
    } else {
      const float2 x = *reinterpret_cast<const float2*>(p);
      b[n] = x.x; b[n + 1] = x.y;
    }
  }
}

// s[i][j] = sum_d A[d][4 ty + i] * B[d][4 tx + j] over transposed tiles.
template <int D>
__device__ inline void score_tile(const float* at, const float* bt, int ty, int tx,
                                  float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(at + d * kTile + 4 * ty);
    const float4 b = *reinterpret_cast<const float4*>(bt + d * kTile + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// Thread (ty, tx) writes its 4 x 4 tile into the row-major (64, kPld) tile.
__device__ inline void store_tile(float* dst, int ty, int tx, const float v[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(dst + (4 * ty + i) * kPld + 4 * tx) =
        make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
}

// acc[i][n] += sum_{k < kn} P[4 ty + i][k] * B[k][col(n)]: rows of P.
template <int D>
__device__ inline void acc_rows(float acc[4][D / 16], const float* p, const float* b, int kn,
                                int ty, int tx) {
  for (int k = 0; k < kn; k += 4) {
    float pv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(p + (4 * ty + i) * kPld + k);
      pv[i][0] = x.x; pv[i][1] = x.y; pv[i][2] = x.z; pv[i][3] = x.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float bv[D / 16];
      load_cols<D>(b + (k + kk) * D, tx, bv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < D / 16; ++n) acc[i][n] = fmaf(pv[i][kk], bv[n], acc[i][n]);
    }
  }
}

// acc[i][n] += sum_{k < kn} P[k][4 ty + i] * B[k][col(n)]: columns of P.
template <int D>
__device__ inline void acc_cols(float acc[4][D / 16], const float* p, const float* b, int kn,
                                int ty, int tx) {
  for (int k = 0; k < kn; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(p + k * kPld + 4 * ty);
    const float pv[4] = {x.x, x.y, x.z, x.w};
    float bv[D / 16];
    load_cols<D>(b + k * D, tx, bv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < D / 16; ++n) acc[i][n] = fmaf(pv[i], bv[n], acc[i][n]);
  }
}

// Max and sum over the 16 threads of a row: one half-warp (lane = 16 (ty % 2) + tx).
__device__ inline float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ inline float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__device__ inline void store_row(float* __restrict__ dst, int tx, const float v[D / 16],
                                 float mul) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n) dst[Cols<D>::col(tx, n)] = v[n] * mul;
}

__device__ inline int round4(int n) { return (n + 3) & ~3; }

template <int D>
constexpr size_t fwd_smem() {
  return (3 * D * kTile + kTile * kPld) * sizeof(float);
}
template <int D>
constexpr size_t dq_smem() {
  return (5 * D * kTile + kTile * kPld) * sizeof(float);
}
template <int D>
constexpr size_t dkv_smem() {
  return (6 * D * kTile + 2 * kTile * kPld) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
                 int S, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // (D, 64)
  float* kt = qt + D * kTile;    // (D, 64)
  float* vs = kt + D * kTile;    // (64, D)
  float* ps = vs + kTile * D;    // (64, kPld)
  const TileId id = tile_id(S);
  const int row0 = id.row0;
  const size_t base = static_cast<size_t>(id.bh) * S * D;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // a warp owns rows 8w .. 8w + 7 of the tile: skip it when all are padding
  const bool live = row0 + 8 * static_cast<int>(threadIdx.x / 32) < S;

  load_t<D>(qt, q + base, row0, S);
  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < D / 16; ++n) acc[i][n] = 0.f;
  }

  for (int key0 = 0; key0 < S; key0 += kTile) {
    __syncthreads();  // the previous tile is read
    load_t<D>(kt, k + base, key0, S);
    load_rows<D>(vs, v + base, key0, S);
    __syncthreads();
    if (!live) continue;
    float s[4][4];
    score_tile<D>(qt, kt, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = key0 + 4 * tx + j < S ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        s[i][j] = p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < D / 16; ++n) acc[i][n] *= corr;
    }
    store_tile(ps, ty, tx, s);
    __syncwarp();  // a row of P is written and read by one half-warp
    acc_rows<D>(acc, ps, vs, round4(min(kTile, S - key0)), ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 4 * ty + i;
    if (r >= S) continue;
#pragma unroll
    for (int n = 0; n < D / 16; ++n) acc[i][n] /= l[i];
    store_row<D>(out + base + static_cast<size_t>(r) * D, tx, acc[i], 1.f);
    if (tx == 0) lse[static_cast<size_t>(id.bh) * S + r] = m[i] + logf(l[i]);
  }
}

// The score phase both f32 CUDA-core backward kernels share: for query
// rows (ty) and keys (tx) of the staged tiles, p = exp(s * scale - lse) (0
// for a key or query past S) and ds = p * (g.v^T + coeff). Writes p to pt
// (when given) and ds to dst.
template <int D>
__device__ inline void backward_scores(const float* qt, const float* gt, const float* kt,
                                       const float* vt, const float lse_r[4],
                                       const float coeff_r[4], int q0, int key0, int S,
                                       float scale, int ty, int tx, float* pt, float* dst) {
  float s[4][4], dp[4][4];
  score_tile<D>(qt, kt, ty, tx, s);
  score_tile<D>(gt, vt, ty, tx, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool row_live = q0 + 4 * ty + i < S;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool live = row_live && key0 + 4 * tx + j < S;
      const float p = live ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
      dp[i][j] = live ? p * (dp[i][j] + coeff_r[i]) : 0.f;
      s[i][j] = p;
    }
  }
  if (pt != nullptr) store_tile(pt, ty, tx, s);
  store_tile(dst, ty, tx, dp);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ g,
                const float* __restrict__ lse, const float* __restrict__ coeff,
                float* __restrict__ dq, int S, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // (D, 64) query rows
  float* gt = qt + D * kTile;    // (D, 64)
  float* kt = gt + D * kTile;    // (D, 64) keys
  float* vt = kt + D * kTile;    // (D, 64)
  float* ks = vt + D * kTile;    // (64, D)
  float* ds = ks + kTile * D;    // (64, kPld)
  const TileId id = tile_id(S);
  const int row0 = id.row0;
  const size_t base = static_cast<size_t>(id.bh) * S * D;
  const size_t sbase = static_cast<size_t>(id.bh) * S;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const bool live = row0 + 8 * static_cast<int>(threadIdx.x / 32) < S;

  load_t<D>(qt, q + base, row0, S);
  load_t<D>(gt, g + base, row0, S);
  float lse_r[4], coeff_r[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 4 * ty + i;
    lse_r[i] = r < S ? lse[sbase + r] : 0.f;
    coeff_r[i] = r < S ? coeff[sbase + r] : 0.f;
#pragma unroll
    for (int n = 0; n < D / 16; ++n) acc[i][n] = 0.f;
  }

  for (int key0 = 0; key0 < S; key0 += kTile) {
    __syncthreads();
    load_t<D>(kt, k + base, key0, S);
    load_t<D>(vt, v + base, key0, S);
    load_rows<D>(ks, k + base, key0, S);
    __syncthreads();
    if (!live) continue;
    backward_scores<D>(qt, gt, kt, vt, lse_r, coeff_r, row0, key0, S, scale, ty, tx,
                          nullptr, ds);
    __syncwarp();  // a row of dS is written and read by one half-warp
    acc_rows<D>(acc, ds, ks, round4(min(kTile, S - key0)), ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 4 * ty + i;
    if (r < S) store_row<D>(dq + base + static_cast<size_t>(r) * D, tx, acc[i], scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ g,
                 const float* __restrict__ lse, const float* __restrict__ coeff,
                 float* __restrict__ dk, float* __restrict__ dv, int S, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;              // (D, 64) keys of this CTA
  float* vt = kt + D * kTile;    // (D, 64)
  float* qt = vt + D * kTile;    // (D, 64) query rows of the current tile
  float* gt = qt + D * kTile;    // (D, 64)
  float* qs = gt + D * kTile;    // (64, D)
  float* gs = qs + kTile * D;    // (64, D)
  float* pt = gs + kTile * D;    // (64, kPld): P[q][key]
  float* ds = pt + kTile * kPld; // (64, kPld): dS[q][key]
  const TileId id = tile_id(S);
  const int key0 = id.row0;
  const size_t base = static_cast<size_t>(id.bh) * S * D;
  const size_t sbase = static_cast<size_t>(id.bh) * S;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_t<D>(kt, k + base, key0, S);
  load_t<D>(vt, v + base, key0, S);
  // accumulators: keys 4 ty + i, columns col(n)
  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) dk_acc[i][n] = dv_acc[i][n] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kTile) {
    __syncthreads();
    load_t<D>(qt, q + base, q0, S);
    load_t<D>(gt, g + base, q0, S);
    load_rows<D>(qs, q + base, q0, S);
    load_rows<D>(gs, g + base, q0, S);
    float lse_r[4], coeff_r[4];  // query rows 4 ty + i of the score phase
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + 4 * ty + i;
      lse_r[i] = r < S ? lse[sbase + r] : 0.f;
      coeff_r[i] = r < S ? coeff[sbase + r] : 0.f;
    }
    __syncthreads();
    backward_scores<D>(qt, gt, kt, vt, lse_r, coeff_r, q0, key0, S, scale, ty, tx, pt, ds);
    __syncthreads();  // every thread reads columns written by all
    const int qn = round4(min(kTile, S - q0));
    acc_cols<D>(dv_acc, pt, gs, qn, ty, tx);
    acc_cols<D>(dk_acc, ds, qs, qn, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = key0 + 4 * ty + i;
    if (r >= S) continue;
    store_row<D>(dk + base + static_cast<size_t>(r) * D, tx, dk_acc[i], scale);
    store_row<D>(dv + base + static_cast<size_t>(r) * D, tx, dv_acc[i], 1.f);
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;  // 4 warps x 16 rows of a 64-row tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory without waiting; the
// destination is zero-filled instead when !valid (src must still be a
// valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one of this thread's committed groups (the newest
// tile of the ring) is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Four 8 x 8 bf16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and r[i] holds the thread's pair of it (row lane / 4, columns
// 2 (lane % 4) + {0, 1}; with .trans the same pair of the transpose).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col).
// Fragments (g = lane / 4, t = lane % 4): a = {(g, 2t..), (g + 8, 2t..),
// (g, 2t + 8..), (g + 8, 2t + 8..)}; b = {(2t.., g), (2t + 8.., g)};
// c = {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 (nearest even) in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a 16 x 16 chunk from the two accumulator fragments
// that hold its columns 0..7 and 8..15, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float lo[4], const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Row stride, in elements, of a staged (64, D) bf16 tile: the 16-byte pad
// puts the 8 rows an ldmatrix phase reads in 8 distinct bank groups.
template <int D>
__host__ __device__ constexpr int ld_of() { return D + 8; }
template <int D>
__host__ __device__ constexpr int tile_elems() { return kTile * ld_of<D>(); }

// Rows [row0, row0 + 64) of a (S, D) bf16 matrix into a (64, D + 8) tile
// by 16-byte cp.async, rows at or past S zero-filled.
template <int D>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* __restrict__ src, int row0,
                                           int S) {
  constexpr int kPieces = D / 8;  // 16-byte pieces of a row
#pragma unroll
  for (int i = 0; i < kTile * kPieces / kMmaThreads; ++i) {
    const int idx = threadIdx.x + i * kMmaThreads;
    const int r = idx / kPieces, c = (idx % kPieces) * 8;
    const bool valid = row0 + r < S;
    cp_async16(dst + r * ld_of<D>() + c, src + static_cast<size_t>(valid ? row0 + r : 0) * D + c,
               valid);
  }
}

// The A fragments of the warp's 16 rows of a staged tile (rows 16 warp ..),
// over D in chunks of 16.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t a[D / 16][4], const bf16* tile, int warp,
                                             int lane) {
  const bf16* p = tile + (16 * warp + (lane & 15)) * ld_of<D>() + (lane >> 4) * 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) ldsm_x4(a[kc], p + 16 * kc);
}

// acc[0..1] (16 x 16) = a . B^T over D, B = rows [r0, r0 + 16) of a staged
// tile (B^T is the "col" operand, so B's rows load untransposed).
template <int D>
__device__ __forceinline__ void mma_abt(float acc[2][4], const uint32_t a[D / 16][4],
                                        const bf16* tile, int r0, int lane) {
  const bf16* p = tile + (r0 + (lane & 7) + ((lane >> 4) << 3)) * ld_of<D>() +
                  ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t b[4];
    ldsm_x4(b, p + 16 * kc);
    mma_bf16(acc[0], a[kc], b[0], b[1]);
    mma_bf16(acc[1], a[kc], b[2], b[3]);
  }
}

// acc (16 x D) += a (16 x 16) . B, B = rows [r0, r0 + 16) of a staged tile
// (read transposed by ldmatrix).
template <int D>
__device__ __forceinline__ void mma_ab(float acc[D / 8][4], const uint32_t a[4], const bf16* tile,
                                       int r0, int lane) {
  const bf16* p = tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld_of<D>() + (lane >> 4) * 8;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    uint32_t b[4];
    ldsm_x4_t(b, p + 16 * n);
    mma_bf16(acc[2 * n], a, b[0], b[1]);
    mma_bf16(acc[2 * n + 1], a, b[2], b[3]);
  }
}

// Stores an accumulator (16 x D: rows g and g + 8 of the fragment, times
// mul) to rows row0 + {g, g + 8} of a (S, D) bf16 matrix, rows < S only.
template <int D>
__device__ __forceinline__ void store_acc(bf16* __restrict__ dst, const float acc[D / 8][4],
                                          int row0, int S, int lane, const float mul[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + (lane >> 2) + 8 * h;
    if (r >= S) continue;
    bf16* row = dst + static_cast<size_t>(r) * D + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + 8 * n) =
          pack_bf16(acc[n][2 * h] * mul[h], acc[n][2 * h + 1] * mul[h]);
  }
}

template <int D>
constexpr size_t fwd_mma_smem() {
  return 5 * tile_elems<D>() * sizeof(bf16);  // Q, 2 x K, 2 x V
}
template <int D>
constexpr size_t dq_mma_smem() {
  return 6 * tile_elems<D>() * sizeof(bf16);  // Q, G, 2 x K, 2 x V
}
template <int D>
constexpr size_t dkv_mma_smem() {
  return 6 * tile_elems<D>() * sizeof(bf16) + 4 * kTile * sizeof(float);  // K, V, 2 x (Q, G, lse, coeff)
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                     int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // (64, D + 8) query rows
  bf16* ks = qs + tile_elems<D>();                // 2 stages of (64, D + 8) keys
  bf16* vs = ks + 2 * tile_elems<D>();            // 2 stages of (64, D + 8) values
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane & 3;
  const TileId id = tile_id(S);
  const int row0 = id.row0;
  const size_t base = static_cast<size_t>(id.bh) * S * D;
  const int n_tiles = tiles_of(S);
  const bool live = row0 + 16 * warp < S;  // the warp has a query row < S

  stage_tile<D>(qs, q + base, row0, S);
  stage_tile<D>(ks, k + base, 0, S);
  stage_tile<D>(vs, v + base, 0, S);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g and g + 8; l per thread
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {  // the next tile into the other stage
      stage_tile<D>(ks + (stage ^ 1) * tile_elems<D>(), k + base, (t + 1) * kTile, S);
      stage_tile<D>(vs + (stage ^ 1) * tile_elems<D>(), v + base, (t + 1) * kTile, S);
    }
    cp_async_commit();
    cp_async_wait_one();  // tile t (and Q) have landed for this thread ...
    __syncthreads();     // ... and for every thread
    if (live) {
      if (t == 0) load_a_frags<D>(qf, qs, warp, lane);
      const bf16* kt = ks + stage * tile_elems<D>();
      const bf16* vt = vs + stage * tile_elems<D>();
      const int key0 = t * kTile;
      const int chunks = min(4, (S - key0 + 15) / 16);  // 16-key chunks holding a key < S
      const bool tail = key0 + kTile > S;
      float s[8][4];  // scores of keys key0 + 8j + 2 t4 + {0, 1}, rows g, g + 8
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < chunks) mma_abt<D>(&s[2 * c], qf, kt, 16 * c, lane);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= 2 * chunks) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (tail && key0 + 8 * j + 2 * t4 + (e & 1) >= S) x = kNegInf;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float ml[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the row max over the quad that holds the row
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float corr = exp2f((m[h] - mx[h]) * kLog2e);
        l[h] *= corr;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[n][2 * h] *= corr;
          o[n][2 * h + 1] *= corr;
        }
        m[h] = mx[h];
        ml[h] = mx[h] * kLog2e;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= 2 * chunks) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(s[j][e], kLog2e, -ml[e >> 1]));
          l[e >> 1] += p;  // the unrounded p
          s[j][e] = p;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= chunks) continue;
        uint32_t pa[4];
        acc_to_a(pa, s[2 * c], s[2 * c + 1]);  // p in bf16 for p.v
        mma_ab<D>(o, pa, vt, 16 * c, lane);
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }

  if (!live) return;
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / l[h];
    const int r = row0 + 16 * warp + (lane >> 2) + 8 * h;
    if (t4 == 0 && r < S) lse[static_cast<size_t>(id.bh) * S + r] = m[h] + logf(l[h]);
  }
  store_acc<D>(out + base, o, row0 + 16 * warp, S, lane, inv);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ coeff,
                    bf16* __restrict__ dq, int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // (64, D + 8) query rows
  bf16* gs = qs + tile_elems<D>();                // (64, D + 8) their gradient rows
  bf16* ks = gs + tile_elems<D>();                // 2 stages of (64, D + 8) keys
  bf16* vs = ks + 2 * tile_elems<D>();            // 2 stages of (64, D + 8) values
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane & 3;
  const TileId id = tile_id(S);
  const int row0 = id.row0;
  const size_t base = static_cast<size_t>(id.bh) * S * D;
  const size_t sbase = static_cast<size_t>(id.bh) * S;
  const int n_tiles = tiles_of(S);
  const bool live = row0 + 16 * warp < S;  // the warp has a query row < S
  const float sl2 = scale * kLog2e;

  stage_tile<D>(qs, q + base, row0, S);
  stage_tile<D>(gs, g + base, row0, S);
  stage_tile<D>(ks, k + base, 0, S);
  stage_tile<D>(vs, v + base, 0, S);
  cp_async_commit();

  // lse * log2(e) and coeff of the thread's rows g and g + 8, 0 past S (so
  // p = 1 and dS = 0 there: no inf or NaN, and those rows are not stored)
  float lse2[2], co[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 16 * warp + (lane >> 2) + 8 * h;
    lse2[h] = r < S ? lse[sbase + r] * kLog2e : 0.f;
    co[h] = r < S ? coeff[sbase + r] : 0.f;
  }

  uint32_t qf[D / 16][4], gf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {  // the next tile into the other stage
      stage_tile<D>(ks + (stage ^ 1) * tile_elems<D>(), k + base, (t + 1) * kTile, S);
      stage_tile<D>(vs + (stage ^ 1) * tile_elems<D>(), v + base, (t + 1) * kTile, S);
    }
    cp_async_commit();
    cp_async_wait_one();  // tile t (and Q, G) have landed for this thread ...
    __syncthreads();     // ... and for every thread
    if (live) {
      if (t == 0) {
        load_a_frags<D>(qf, qs, warp, lane);
        load_a_frags<D>(gf, gs, warp, lane);
      }
      const bf16* kt = ks + stage * tile_elems<D>();
      const bf16* vt = vs + stage * tile_elems<D>();
      const int key0 = t * kTile;
      const int chunks = min(4, (S - key0 + 15) / 16);  // 16-key chunks holding a key < S
      const bool tail = key0 + kTile > S;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= chunks) continue;
        float s[2][4], dp[2][4];  // rows g, g + 8 x keys key0 + 16c + 8j + 2 t4 + {0, 1}
        mma_abt<D>(s, qf, kt, 16 * c, lane);
        mma_abt<D>(dp, gf, vt, 16 * c, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(fmaf(s[j][e], sl2, -lse2[e >> 1]));
            if (tail && key0 + 16 * c + 8 * j + 2 * t4 + (e & 1) >= S) p = 0.f;
            dp[j][e] = p * (dp[j][e] + co[e >> 1]);  // dS from the unrounded p
          }
        uint32_t da[4];
        acc_to_a(da, dp[0], dp[1]);  // dS rounded to bf16 for ds.k
        mma_ab<D>(acc, da, kt, 16 * c, lane);
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }

  if (!live) return;
  const float mul[2] = {scale, scale};
  store_acc<D>(dq + base, acc, row0 + 16 * warp, S, lane, mul);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ coeff,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // (64, D + 8) keys of this CTA
  bf16* vs = ks + tile_elems<D>();                // (64, D + 8)
  bf16* qs = vs + tile_elems<D>();                // 2 stages of (64, D + 8) query rows
  bf16* gs = qs + 2 * tile_elems<D>();            // 2 stages of (64, D + 8)
  float* ls = reinterpret_cast<float*>(gs + 2 * tile_elems<D>());  // 2 stages of 64 lse
  float* cs = ls + 2 * kTile;                                       // 2 stages of 64 coeff
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane & 3;
  const TileId id = tile_id(S);
  const int key0 = id.row0;
  const size_t base = static_cast<size_t>(id.bh) * S * D;
  const size_t sbase = static_cast<size_t>(id.bh) * S;
  const int n_tiles = tiles_of(S);
  const bool live = key0 + 16 * warp < S;  // the warp has a key < S
  const float sl2 = scale * kLog2e;

  // lse and coeff of query rows [q0, q0 + 64): thread i < 64 copies lse[i],
  // thread 64 + i coeff[i] (4-byte copies: a row's base need not be 16-byte
  // aligned); zero past S
  auto stage_rows = [&](int stage, int q0) {
    const int i = threadIdx.x % kTile;
    const bool valid = q0 + i < S;
    const float* src = (threadIdx.x < kTile ? lse : coeff) + sbase + (valid ? q0 + i : 0);
    cp_async4((threadIdx.x < kTile ? ls : cs) + stage * kTile + i, src, valid);
  };

  stage_tile<D>(ks, k + base, key0, S);
  stage_tile<D>(vs, v + base, key0, S);
  stage_tile<D>(qs, q + base, 0, S);
  stage_tile<D>(gs, g + base, 0, S);
  stage_rows(0, 0);
  cp_async_commit();

  uint32_t kf[D / 16][4], vf[D / 16][4];
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      stage_tile<D>(qs + (stage ^ 1) * tile_elems<D>(), q + base, (t + 1) * kTile, S);
      stage_tile<D>(gs + (stage ^ 1) * tile_elems<D>(), g + base, (t + 1) * kTile, S);
      stage_rows(stage ^ 1, (t + 1) * kTile);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (live) {
      if (t == 0) {
        load_a_frags<D>(kf, ks, warp, lane);
        load_a_frags<D>(vf, vs, warp, lane);
      }
      const bf16* qt = qs + stage * tile_elems<D>();
      const bf16* gt = gs + stage * tile_elems<D>();
      const float* lt = ls + stage * kTile;
      const float* ct = cs + stage * kTile;
      const int q0 = t * kTile;
      const int chunks = min(4, (S - q0 + 15) / 16);  // 16-query chunks holding a row < S
      const bool tail = q0 + kTile > S;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= chunks) continue;
        float st[2][4], dpt[2][4];  // keys g, g + 8 x queries 16c + 8j + 2 t4 + {0, 1}
        mma_abt<D>(st, kf, qt, 16 * c, lane);
        mma_abt<D>(dpt, vf, gt, 16 * c, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 16 * c + 8 * j + 2 * t4;
          const float2 lse2 = *reinterpret_cast<const float2*>(lt + col);
          const float2 co2 = *reinterpret_cast<const float2*>(ct + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool odd = e & 1;
            float p = exp2f(fmaf(st[j][e], sl2, -(odd ? lse2.y : lse2.x) * kLog2e));
            if (tail && q0 + col + odd >= S) p = 0.f;
            dpt[j][e] = p * (dpt[j][e] + (odd ? co2.y : co2.x));  // dS from the unrounded p
            st[j][e] = p;
          }
        }
        uint32_t pa[4], da[4];
        acc_to_a(pa, st[0], st[1]);  // P^T rounded to bf16 for p^T.g
        acc_to_a(da, dpt[0], dpt[1]);  // dS^T rounded to bf16 for ds^T.q
        mma_ab<D>(dv_acc, pa, gt, 16 * c, lane);
        mma_ab<D>(dk_acc, da, qt, 16 * c, lane);
      }
    }
    __syncthreads();
  }

  if (!live) return;
  const float mul_k[2] = {scale, scale}, mul_v[2] = {1.f, 1.f};
  store_acc<D>(dk + base, dk_acc, key0 + 16 * warp, S, lane, mul_k);
  store_acc<D>(dv + base, dv_acc, key0 + 16 * warp, S, lane, mul_v);
}

// ---------------------------------------------------------------------------
// Launch and dispatch
// ---------------------------------------------------------------------------

// The grid's CTA count, B*H * ceil(S/64), fits its x dimension (2^31 - 1).
bool grid_fits(int BH, int S) {
  return BH > 0 && S > 0 && static_cast<long long>(BH) * tiles_of(S) <= 0x7fffffffLL;
}

// One launch of `kernel` over the one-dimensional grid of BH * ceil(S/64)
// CTAs (grid_fits(BH, S) holds) with `threads` threads and `smem` bytes of
// dynamic shared memory.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int threads, size_t smem, int BH, int S, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(BH) * static_cast<unsigned>(tiles_of(S));
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse, int BH,
                    int S, float scale, cudaStream_t st) {
  return launch(flash_fwd_kernel<D>, kThreads, fwd_smem<D>(), BH, S, st,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(out), static_cast<float*>(lse),
                S, scale);
}

template <int D>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int BH,
                     int S, float scale, cudaStream_t st) {
  return launch(flash_fwd_mma_kernel<D>, kMmaThreads, fwd_mma_smem<D>(), BH, S, st,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<bf16*>(out), static_cast<float*>(lse), S,
                scale);
}

template <int D>
cudaError_t dq_f32(const void* q, const void* k, const void* v, const void* g, const void* lse,
                   const void* coeff, void* dq_out, int BH, int S, float scale, cudaStream_t st) {
  return launch(flash_dq_kernel<D>, kThreads, dq_smem<D>(), BH, S, st,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(g),
                static_cast<const float*>(lse), static_cast<const float*>(coeff),
                static_cast<float*>(dq_out), S, scale);
}

template <int D>
cudaError_t dq_bf16(const void* q, const void* k, const void* v, const void* g, const void* lse,
                    const void* coeff, void* dq_out, int BH, int S, float scale, cudaStream_t st) {
  return launch(flash_dq_mma_kernel<D>, kMmaThreads, dq_mma_smem<D>(), BH, S, st,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(g),
                static_cast<const float*>(lse), static_cast<const float*>(coeff),
                static_cast<bf16*>(dq_out), S, scale);
}

template <int D>
cudaError_t dkv_f32(const void* q, const void* k, const void* v, const void* g, const void* lse,
                    const void* coeff, void* dk_out, void* dv_out, int BH, int S, float scale,
                    cudaStream_t st) {
  return launch(flash_dkv_kernel<D>, kThreads, dkv_smem<D>(), BH, S, st,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(g),
                static_cast<const float*>(lse), static_cast<const float*>(coeff),
                static_cast<float*>(dk_out), static_cast<float*>(dv_out), S, scale);
}

template <int D>
cudaError_t dkv_bf16(const void* q, const void* k, const void* v, const void* g, const void* lse,
                     const void* coeff, void* dk_out, void* dv_out, int BH, int S, float scale,
                     cudaStream_t st) {
  return launch(flash_dkv_mma_kernel<D>, kMmaThreads, dkv_mma_smem<D>(), BH, S, st,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(g),
                static_cast<const float*>(lse), static_cast<const float*>(coeff),
                static_cast<bf16*>(dk_out), static_cast<bf16*>(dv_out), S, scale);
}

// Calls F32<D>(args...) for dtype 0 (f32) or BF16<D>(args...) for dtype 1
// (bf16), D in {32, 64, 128}.
#define FLASH_DISPATCH(F32, BF16, dtype, D, ...)                                         \
  do {                                                                                   \
    if ((D) != 32 && (D) != 64 && (D) != 128) return cudaErrorInvalidValue;              \
    if ((dtype) == 0) {                                                                  \
      return (D) == 32 ? F32<32>(__VA_ARGS__)                                            \
             : (D) == 64 ? F32<64>(__VA_ARGS__) : F32<128>(__VA_ARGS__);                 \
    }                                                                                    \
    if ((dtype) == 1) {                                                                  \
      return (D) == 32 ? BF16<32>(__VA_ARGS__)                                           \
             : (D) == 64 ? BF16<64>(__VA_ARGS__) : BF16<128>(__VA_ARGS__);               \
    }                                                                                    \
    return cudaErrorInvalidValue;                                                        \
  } while (0)

cudaError_t fwd_any(int dtype, int D, const void* q, const void* k, const void* v, void* out,
                    void* lse, int BH, int S, float scale, cudaStream_t st) {
  FLASH_DISPATCH(fwd_f32, fwd_bf16, dtype, D, q, k, v, out, lse, BH, S, scale, st);
}

cudaError_t dq_any(int dtype, int D, const void* q, const void* k, const void* v, const void* g,
                   const void* lse, const void* coeff, void* dq_out, int BH, int S, float scale,
                   cudaStream_t st) {
  FLASH_DISPATCH(dq_f32, dq_bf16, dtype, D, q, k, v, g, lse, coeff, dq_out, BH, S, scale, st);
}

cudaError_t dkv_any(int dtype, int D, const void* q, const void* k, const void* v,
                    const void* g, const void* lse, const void* coeff, void* dk_out,
                    void* dv_out, int BH, int S, float scale, cudaStream_t st) {
  FLASH_DISPATCH(dkv_f32, dkv_bf16, dtype, D, q, k, v, g, lse, coeff, dk_out, dv_out, BH, S,
                 scale, st);
}

}  // namespace

extern "C" {

// All tensors are contiguous (B*H, S, D) in the input dtype (0 = f32,
// 1 = bf16) on the current device, lse and coeff (B*H, S) f32; the caller
// has checked shapes, dtypes, D in {32, 64, 128}, BH > 0, S > 0 and
// BH * ceil(S/64) <= 2^31 - 1 (the grid's CTA count), and allocated the
// outputs. Each launches on `stream` and returns the cudaError_t (0 =
// success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                        int BH, int S, int D, int dtype, float scale, void* stream) {
  if (!grid_fits(BH, S)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      fwd_any(dtype, D, q, k, v, out, lse, BH, S, scale, static_cast<cudaStream_t>(stream)));
}

int flash_attention_dq(const void* q, const void* k, const void* v, const void* g,
                       const void* lse, const void* coeff, void* dq_out, int BH, int S, int D,
                       int dtype, float scale, void* stream) {
  if (!grid_fits(BH, S)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dq_any(dtype, D, q, k, v, g, lse, coeff, dq_out, BH, S, scale,
                                 static_cast<cudaStream_t>(stream)));
}

int flash_attention_dkv(const void* q, const void* k, const void* v, const void* g,
                        const void* lse, const void* coeff, void* dk_out, void* dv_out, int BH,
                        int S, int D, int dtype, float scale, void* stream) {
  if (!grid_fits(BH, S)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dkv_any(dtype, D, q, k, v, g, lse, coeff, dk_out, dv_out, BH, S,
                                  scale, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
