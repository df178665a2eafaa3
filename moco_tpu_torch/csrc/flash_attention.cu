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
// Bound. At the ViT's S = 197, D = 64 attention is bytes-bound on this
// card: the forward does 4 S^2 D flops against 4 S D elements moved, about
// 98 flop/byte in bf16 (the ridge is ~295). For the v3 path's 6144
// (b, h) pairs in bf16: forward 0.19 ms, dq 0.23 ms, dk/dv 0.28 ms at
// 3.35 TB/s (chip_smoke.py recomputes each bound from the shapes it runs).
//
// Design. The TPU kernel holds the whole K/V of a (b, h) in VMEM and walks
// it on a sequential grid. Here every CTA owns one 64-row tile of one
// (b, h) (query rows for the forward and dq, key rows for dk/dv) and
// streams the other side in 64-row tiles through shared memory, with the
// forward's online softmax (running m, l and the output accumulator in
// registers). Grid = (ceil(S/64), B*H): 4 x 6144 CTAs at the path's shape.
// - Operands are converted to f32 as they are staged: the "score" operands
//   (q, k, g, v as the left and right of q.k^T and g.v^T) transposed,
//   (D, 64), so the 256 threads (16 x 16) each take a 4 x 4 register tile
//   of the 64 x 64 scores with two float4 shared-memory loads per 16 FMAs;
//   the operand of the second product (v, k, q, g) row-major, (64, D).
// - P (or dS) goes to shared memory row-major, (64, 68), one float4 per
//   thread and row, and the second product reads it back as float4 over
//   four keys: each thread accumulates 4 rows x D/16 columns.
// - f32 FMAs on the CUDA cores, in the TPU kernel's order of rounding:
//   products of the input-dtype values are exact in f32, p and dS are
//   rounded to the input dtype where the TPU kernel rounds them, sums stay
//   f32. Tensor cores (mma/wgmma) and TMA pipelining are later work; so is
//   dropping the padded tail's FLOPs (S = 197 pads to 256 keys).
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

template <typename T>
__device__ inline float to_f32(T x);
template <>
__device__ inline float to_f32<float>(float x) { return x; }
template <>
__device__ inline float to_f32<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ inline T from_f32(float x);
template <>
__device__ inline float from_f32<float>(float x) { return x; }
template <>
__device__ inline __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// x rounded to T and back (round to nearest even, as astype does).
template <typename T>
__device__ inline float round_to(float x) { return to_f32<T>(from_f32<T>(x)); }

// Four consecutive elements of a row; `p` is 8-byte (bf16) or 16-byte
// (f32) aligned because D % 4 == 0 and the wrapper checks the base.
__device__ inline void load4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ inline void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// Rows [row0, row0 + 64) of a (n, D) matrix into dst (D, 64), transposed,
// as f32; rows at or past n are zero. Lanes walk rows, so the stores to
// shared memory hit 32 distinct banks.
template <typename T, int D>
__device__ inline void load_t(float* dst, const T* __restrict__ src, int row0, int n) {
  for (int idx = threadIdx.x; idx < kTile * (D / 4); idx += kThreads) {
    const int r = idx % kTile;
    const int d = (idx / kTile) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < n) load4(src + static_cast<size_t>(row0 + r) * D + d, v);
#pragma unroll
    for (int c = 0; c < 4; ++c) dst[(d + c) * kTile + r] = v[c];
  }
}

// The same rows into dst (64, D), row-major, as f32.
template <typename T, int D>
__device__ inline void load_rows(float* dst, const T* __restrict__ src, int row0, int n) {
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

template <typename T, int D>
__device__ inline void store_row(T* __restrict__ dst, int tx, const float v[D / 16], float mul) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n) dst[Cols<D>::col(tx, n)] = from_f32<T>(v[n] * mul);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int S, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // (D, 64)
  float* kt = qt + D * kTile;    // (D, 64)
  float* vs = kt + D * kTile;    // (64, D)
  float* ps = vs + kTile * D;    // (64, kPld)
  const int row0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // a warp owns rows 8w .. 8w + 7 of the tile: skip it when all are padding
  const bool live = row0 + 8 * static_cast<int>(threadIdx.x / 32) < S;

  load_t<T, D>(qt, q + base, row0, S);
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
    load_t<T, D>(kt, k + base, key0, S);
    load_rows<T, D>(vs, v + base, key0, S);
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
        s[i][j] = round_to<T>(p);  // p in the input dtype for p.v
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
    store_row<T, D>(out + base + static_cast<size_t>(r) * D, tx, acc[i], 1.f);
    if (tx == 0) lse[static_cast<size_t>(blockIdx.y) * S + r] = m[i] + logf(l[i]);
  }
}

// The score phase both backward kernels share: for query rows (ty) and keys
// (tx) of the staged tiles, p = exp(s * scale - lse) (0 for a key or query
// past S) and ds = p * (g.v^T + coeff), each rounded where the TPU kernels
// round them. Writes round(p) to pt and round(ds) to dst when given.
template <typename T, int D>
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
      dp[i][j] = live ? round_to<T>(p * (dp[i][j] + coeff_r[i])) : 0.f;
      s[i][j] = round_to<T>(p);
    }
  }
  if (pt != nullptr) store_tile(pt, ty, tx, s);
  store_tile(dst, ty, tx, dp);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ g, const float* __restrict__ lse,
                const float* __restrict__ coeff, T* __restrict__ dq, int S, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // (D, 64) query rows
  float* gt = qt + D * kTile;    // (D, 64)
  float* kt = gt + D * kTile;    // (D, 64) keys
  float* vt = kt + D * kTile;    // (D, 64)
  float* ks = vt + D * kTile;    // (64, D)
  float* ds = ks + kTile * D;    // (64, kPld)
  const int row0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;
  const size_t sbase = static_cast<size_t>(blockIdx.y) * S;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const bool live = row0 + 8 * static_cast<int>(threadIdx.x / 32) < S;

  load_t<T, D>(qt, q + base, row0, S);
  load_t<T, D>(gt, g + base, row0, S);
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
    load_t<T, D>(kt, k + base, key0, S);
    load_t<T, D>(vt, v + base, key0, S);
    load_rows<T, D>(ks, k + base, key0, S);
    __syncthreads();
    if (!live) continue;
    backward_scores<T, D>(qt, gt, kt, vt, lse_r, coeff_r, row0, key0, S, scale, ty, tx,
                          nullptr, ds);
    __syncwarp();  // a row of dS is written and read by one half-warp
    acc_rows<D>(acc, ds, ks, round4(min(kTile, S - key0)), ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 4 * ty + i;
    if (r < S) store_row<T, D>(dq + base + static_cast<size_t>(r) * D, tx, acc[i], scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ g, const float* __restrict__ lse,
                 const float* __restrict__ coeff, T* __restrict__ dk, T* __restrict__ dv, int S,
                 float scale) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;              // (D, 64) keys of this CTA
  float* vt = kt + D * kTile;    // (D, 64)
  float* qt = vt + D * kTile;    // (D, 64) query rows of the current tile
  float* gt = qt + D * kTile;    // (D, 64)
  float* qs = gt + D * kTile;    // (64, D)
  float* gs = qs + kTile * D;    // (64, D)
  float* pt = gs + kTile * D;    // (64, kPld): P[q][key]
  float* ds = pt + kTile * kPld; // (64, kPld): dS[q][key]
  const int key0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;
  const size_t sbase = static_cast<size_t>(blockIdx.y) * S;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_t<T, D>(kt, k + base, key0, S);
  load_t<T, D>(vt, v + base, key0, S);
  // accumulators: keys 4 ty + i, columns col(n)
  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) dk_acc[i][n] = dv_acc[i][n] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kTile) {
    __syncthreads();
    load_t<T, D>(qt, q + base, q0, S);
    load_t<T, D>(gt, g + base, q0, S);
    load_rows<T, D>(qs, q + base, q0, S);
    load_rows<T, D>(gs, g + base, q0, S);
    float lse_r[4], coeff_r[4];  // query rows 4 ty + i of the score phase
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + 4 * ty + i;
      lse_r[i] = r < S ? lse[sbase + r] : 0.f;
      coeff_r[i] = r < S ? coeff[sbase + r] : 0.f;
    }
    __syncthreads();
    backward_scores<T, D>(qt, gt, kt, vt, lse_r, coeff_r, q0, key0, S, scale, ty, tx, pt, ds);
    __syncthreads();  // every thread reads columns written by all
    const int qn = round4(min(kTile, S - q0));
    acc_cols<D>(dv_acc, pt, gs, qn, ty, tx);
    acc_cols<D>(dk_acc, ds, qs, qn, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = key0 + 4 * ty + i;
    if (r >= S) continue;
    store_row<T, D>(dk + base + static_cast<size_t>(r) * D, tx, dk_acc[i], scale);
    store_row<T, D>(dv + base + static_cast<size_t>(r) * D, tx, dv_acc[i], 1.f);
  }
}

// One launch of `kernel` over grid (ceil(S/64), BH) with `smem` bytes.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, int BH, int S, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, BH);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out, void* lse, int BH,
                int S, float scale, cudaStream_t st) {
  return launch(flash_fwd_kernel<T, D>, fwd_smem<D>(), BH, S, st, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
                static_cast<float*>(lse), S, scale);
}

template <typename T, int D>
cudaError_t dq(const void* q, const void* k, const void* v, const void* g, const void* lse,
               const void* coeff, void* dq_out, int BH, int S, float scale, cudaStream_t st) {
  return launch(flash_dq_kernel<T, D>, dq_smem<D>(), BH, S, st, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(g),
                static_cast<const float*>(lse), static_cast<const float*>(coeff),
                static_cast<T*>(dq_out), S, scale);
}

template <typename T, int D>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* g, const void* lse,
                const void* coeff, void* dk_out, void* dv_out, int BH, int S, float scale,
                cudaStream_t st) {
  return launch(flash_dkv_kernel<T, D>, dkv_smem<D>(), BH, S, st, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(g),
                static_cast<const float*>(lse), static_cast<const float*>(coeff),
                static_cast<T*>(dk_out), static_cast<T*>(dv_out), S, scale);
}

// Calls FN<T, D>(args...) for dtype (0 = f32, 1 = bf16) and D in {32, 64, 128}.
#define FLASH_DISPATCH(FN, dtype, D, ...)                                              \
  do {                                                                                 \
    if ((D) != 32 && (D) != 64 && (D) != 128) return cudaErrorInvalidValue;            \
    if ((dtype) == 0) {                                                                \
      return (D) == 32 ? FN<float, 32>(__VA_ARGS__)                                    \
             : (D) == 64 ? FN<float, 64>(__VA_ARGS__) : FN<float, 128>(__VA_ARGS__);   \
    }                                                                                  \
    if ((dtype) == 1) {                                                                \
      return (D) == 32 ? FN<__nv_bfloat16, 32>(__VA_ARGS__)                            \
             : (D) == 64 ? FN<__nv_bfloat16, 64>(__VA_ARGS__)                          \
                         : FN<__nv_bfloat16, 128>(__VA_ARGS__);                        \
    }                                                                                  \
    return cudaErrorInvalidValue;                                                      \
  } while (0)

cudaError_t fwd_any(int dtype, int D, const void* q, const void* k, const void* v, void* out,
                    void* lse, int BH, int S, float scale, cudaStream_t st) {
  FLASH_DISPATCH(fwd, dtype, D, q, k, v, out, lse, BH, S, scale, st);
}

cudaError_t dq_any(int dtype, int D, const void* q, const void* k, const void* v, const void* g,
                   const void* lse, const void* coeff, void* dq_out, int BH, int S, float scale,
                   cudaStream_t st) {
  FLASH_DISPATCH(dq, dtype, D, q, k, v, g, lse, coeff, dq_out, BH, S, scale, st);
}

cudaError_t dkv_any(int dtype, int D, const void* q, const void* k, const void* v,
                    const void* g, const void* lse, const void* coeff, void* dk_out,
                    void* dv_out, int BH, int S, float scale, cudaStream_t st) {
  FLASH_DISPATCH(dkv, dtype, D, q, k, v, g, lse, coeff, dk_out, dv_out, BH, S, scale, st);
}

}  // namespace

extern "C" {

// All tensors are contiguous (B*H, S, D) in the input dtype (0 = f32,
// 1 = bf16) on the current device, lse and coeff (B*H, S) f32; the caller
// has checked shapes, dtypes, D in {32, 64, 128}, 0 < BH <= 65535 and
// S > 0, and allocated the outputs. Each launches on `stream` and returns
// the cudaError_t (0 = success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                        int BH, int S, int D, int dtype, float scale, void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      fwd_any(dtype, D, q, k, v, out, lse, BH, S, scale, static_cast<cudaStream_t>(stream)));
}

int flash_attention_dq(const void* q, const void* k, const void* v, const void* g,
                       const void* lse, const void* coeff, void* dq_out, int BH, int S, int D,
                       int dtype, float scale, void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dq_any(dtype, D, q, k, v, g, lse, coeff, dq_out, BH, S, scale,
                                 static_cast<cudaStream_t>(stream)));
}

int flash_attention_dkv(const void* q, const void* k, const void* v, const void* g,
                        const void* lse, const void* coeff, void* dk_out, void* dv_out, int BH,
                        int S, int D, int dtype, float scale, void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dkv_any(dtype, D, q, k, v, g, lse, coeff, dk_out, dv_out, BH, S,
                                  scale, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
