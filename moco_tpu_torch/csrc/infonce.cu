// Fused streaming InfoNCE: forward statistics and the backward of the
// negative term, without materializing the (B, 1+K) logits, on the TF32
// tensor cores as a three-term split product (f32-level results).
//
// Replaces the TPU kernels of moco_tpu/ops/fused_infonce.py:
// - `_fwd_kernel` (:40, launched by `_forward` :98): per query row,
//     pos     = (q . k) / T
//     lse     = logsumexp([pos, q . queue_j / T for j < K])
//     n_above = #{j : q . queue_j / T > pos}
//   with the queue streamed tile by tile on one sequential grid that
//   carries a running (max m, sum l, count) in VMEM scratch;
// - `_bwd_kernel` (:71, launched by `_vjp_bwd` :174):
//     dq_neg = sum_j exp(q . queue_j / T - lse) * g_lse * queue_j / T
//   streaming the queue again. The positive term is added by the caller.
//
// Bound: operations. The forward takes S = Q.queue^T, 2BKC flops; the
// backward recomputes S and takes dQ = P.queue, 4BKC. Done f32-exact on
// the TF32 tensor cores as three products each (below), that is 3 x 2BKC
// and 3 x 4BKC at 495 TFLOP/s: at B=256, K=65536, C=128, 0.026 ms and
// 0.052 ms, against 0.010 ms to read the 33.5 MB queue once at 3.35 TB/s
// (and 0.064 / 0.128 ms as f32 FMAs on the CUDA cores, 67 TFLOP/s).
//
// Precision. One TF32 product keeps 11 significant bits of each operand:
// at T = 0.2 on unit rows its logits are ~7e-4 off, which moves lse by
// ~2e-5 and puts n_above outside its float64 window (negatives within
// 1e-5 of pos) on a large share of rows. So each f32 operand x is split
// into hi = tf32(x) (round to nearest, ties away: cvt.rna.tf32.f32) and
// lo = tf32(x - hi), and each product is lo.hi + hi.lo + hi.hi, the
// small terms first, all accumulated in f32 by the tensor cores: the
// dropped lo.lo and the roundings of lo are ~2^-22 of each term, below
// f32's own 2^-24 per addition over C terms (logits ~2e-7 off in a numpy
// emulation). The split is done with integer operations (add half a TF32
// ulp, clear the 13 low bits; the tensor cores ignore the low 13 bits of
// lo themselves): the same value as cvt.rna.
//
// Design. K is split across CTAs as flash-decoding does (B = 256 rows
// alone would fill 1 or 2 of 132 SMs). Grid = (ceil(B/R), n_split): CTA
// (bx, s) takes query rows [R bx, R bx + R) and the queue's 64-row tiles
// [s tps, (s + 1) tps). A CTA is 8 warps (4 at C > 128); each warp takes
// MT m16 row tiles, which share every key fragment it reads: MT = 2 in
// the forward (R = 256, 128 at C > 128), MT = 1 in the backward, whose
// dQ accumulator takes CP / 2 registers per tile (R = 128, 64). At B =
// 256 the forward reads each queue tile from L2 once, the backward twice.
// Widths are zero-padded to CP in {32, 64, 128, 256}, a template
// parameter, so C = 128 does not pay for 256.
// - Shared memory: the CTA's R query rows (CP f32 each) once; a 2-stage
//   ring of queue stages of SK = 64 rows (32 at CP = 256, so a 64-row tile
//   is two stages) filled by 16-byte `cp.async` copies (4-byte copies
//   when C % 4 != 0 or a base is not 16-byte aligned), stage s + 1 in
//   flight while stage s is used; rows past B or K and columns past C
//   zero-filled. The forward takes 224 KiB, the backward 160 KiB (CP =
//   128 or 256): one CTA per SM.
// - The split, once per stage: when a stage has landed, the CTA splits
//   it in place into hi and a lo array beside the ring (one lo array
//   serves both stages, since one stage is in use at a time); the warps
//   then read ready TF32 operands. Splitting per fragment instead, right
//   after each warp's read, would repeat each element's split in all 8
//   warps. The query rows are split per fragment: each of their A
//   fragments serves all the stage's key fragments.
// - Layout: row-major with an XOR swizzle on the column, c ^ (8 h(r)),
//   h(r) = ((r >> 1) ^ 2 (r & 1)) & 3. A stage is read in two patterns:
//   16-byte reads of rows r0 + g, channels 4t.. (S = Q.stage^T, and the
//   Q fragments), and 4-byte reads of rows r0 + 2t (+1), channel c0 + g
//   (dQ = P.stage). No row padding keeps both free of bank conflicts; the
//   swizzle does (g = lane / 4, t = lane % 4).
// - Products: `mma.sync.m16n8k8` TF32 -> f32 (HMMA). A product's
//   reduction index may be permuted as long as both operands use the same
//   permutation: S takes channels (4t, 4t + 1) as k = (t, t + 4) of one
//   k-step and (4t + 2, 4t + 3) of the next, so each thread reads its A
//   and B fragments of two k-steps as one float4; dQ takes keys (2t,
//   2t + 1) as k = (t, t + 4), so the accumulator fragment of S (columns
//   2t, 2t + 1 of rows g, g + 8) is already the A fragment of P: no
//   shuffles, no P in shared memory. The three products of a k-step run
//   term by term over all the stage's key fragments, so independent
//   products separate two into the same accumulator.
// - Forward: each warp takes its 16 MT rows x SK keys of S = acc / T per
//   stage and folds them into a running (m, l, count) for its thread's
//   2 MT rows, comparing s > pos as the TPU kernel does (pos is the f32
//   FMA dot in channel order, one thread per row, so a tie rounds the
//   same way); at the end the quad that shares a row merges with shuffles
//   and writes per-split partials (n_split, B). `fwd_merge_kernel`, one
//   warp per row, merges the positive and the splits in a fixed order
//   and writes lse and n_above.
// - Backward: p = exp(s - lse) g_lse in f32 on the fragment, split, and
//   dQ (16 rows x CP per warp) accumulated in registers; the CTA writes
//   its partial to (n_split, B, C) and `bwd_reduce_kernel` sums the
//   splits in order and scales by 1/T.
// - Keys past K get no score (masked by index); warps whose rows all lie
//   past B do no math. No atomics: the result is the same bits on every
//   run.
//
// The cp.async and TF32 mma wrappers are shared with ivf_cell_scores.cu
// in tf32_mma.cuh.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kKeys = 64;  // queue rows per tile of the split plan
constexpr int kMaxC = 256;
constexpr float kLog2e = 1.4426950408889634f;

// Per padded width: warps and threads of a CTA, its query rows (MT m16
// tiles per warp, which share each key fragment), and queue rows per stage
// of the ring (a divisor of kKeys). The forward takes MT = 2, the backward
// MT = 1 (its dQ accumulator takes CP / 2 registers per m16 tile).
__host__ __device__ constexpr int warps_of(int cp) { return cp > 128 ? 4 : 8; }
__host__ __device__ constexpr int threads_of(int cp) { return 32 * warps_of(cp); }
__host__ __device__ constexpr int rows_of(int cp, int mt) { return 16 * mt * warps_of(cp); }
__host__ __device__ constexpr int stage_keys(int cp) { return cp > 128 ? 32 : 64; }
constexpr int kFwdMT = 2, kBwdMT = 1;
// Q, two stages and the lo array: 224 KiB for the forward at CP = 128 or
// 256, 160 KiB for the backward.
template <int CP, int MT>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(rows_of(CP, MT) + 3 * stage_keys(CP)) * CP * sizeof(float);
}

// Column of element (r, c) of a staged (rows, CP) array: c ^ 8 h(r). The
// XOR only moves 8-float groups, so 4-float groups stay contiguous.
__device__ __forceinline__ int swz(int r, int c) {
  return c ^ ((((r >> 1) ^ ((r & 1) << 1)) & 3) << 3);
}

// ---- staging and the split product ------------------------------------

// As cp_async16, 4 bytes.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
// Wait until at most one of this thread's committed groups (the newest
// stage of the ring) is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// x = hi + lo with hi = tf32(x) (nearest, ties away from zero, as
// cvt.rna.tf32.f32) and lo = x - hi exactly; lo is handed to the tensor
// cores rounded the same way (they read its 19 high bits).
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const float lo = x - __uint_as_float(hi);
  return {hi, __float_as_uint(lo) + 0x1000u};
}

// An A fragment split into hi and lo.
__device__ __forceinline__ void split4(const float x[4], uint32_t hi[4], uint32_t lo[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split(x[i]);
    hi[i] = s.hi;
    lo[i] = s.lo;
  }
}

__device__ __forceinline__ uint32_t lds(const float* p) { return __float_as_uint(*p); }

// Splits a landed stage of n floats in place (hi) and into lo.
template <int NTHREADS>
__device__ __forceinline__ void split_stage(float* hi, float* lo, int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * NTHREADS) {
    const float4 x = lds4(hi + i);
    const Split a = split(x.x), b = split(x.y), c = split(x.z), d = split(x.w);
    *reinterpret_cast<float4*>(hi + i) = make_float4(__uint_as_float(a.hi), __uint_as_float(b.hi),
                                                     __uint_as_float(c.hi), __uint_as_float(d.hi));
    *reinterpret_cast<float4*>(lo + i) = make_float4(__uint_as_float(a.lo), __uint_as_float(b.lo),
                                                     __uint_as_float(c.lo), __uint_as_float(d.lo));
  }
}

// acc[m][j] (rows 16m + g, 16m + g + 8 x keys 8j + 2t, 8j + 2t + 1) = the
// warp's 16 MT query rows (qw: rows 0.. of a staged block whose row index
// is 16 MT w + i) . the NT x 8 keys of a split stage (hi, lo), over CP
// channels. Channels 16 kc + 4t + {0, 1} are k = {t, t + 4} of the first
// k-step and + {2, 3} of the second, for A (rows g, g + 8) and B (key
// 8j + g) alike.
template <int CP, int NT, int MT>
__device__ __forceinline__ void score_stage(float acc[MT][NT][4], const float* qw,
                                            const float* hi, const float* lo, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
#pragma unroll 2
  for (int kc = 0; kc < CP / 16; ++kc) {
    const int c = swz(g, 16 * kc + 4 * t);  // rows 16m + g (+8) and 8j + g share h
    uint32_t ah[MT][2][4], al[MT][2][4];   // the A fragment of each m-tile and k-step
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float4 qa = lds4(qw + (16 * m + g) * CP + c), qb = lds4(qw + (16 * m + g + 8) * CP + c);
      const float a0[4] = {qa.x, qb.x, qa.y, qb.y}, a1[4] = {qa.z, qb.z, qa.w, qb.w};
      split4(a0, ah[m][0], al[m][0]);
      split4(a1, ah[m][1], al[m][1]);
    }
    uint32_t bh[NT][4], bl[NT][4];  // B fragments: k-step 0 is {0, 1}, k-step 1 is {2, 3}
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 h4 = lds4(hi + (8 * j + g) * CP + c), l4 = lds4(lo + (8 * j + g) * CP + c);
      bh[j][0] = __float_as_uint(h4.x); bh[j][1] = __float_as_uint(h4.y);
      bh[j][2] = __float_as_uint(h4.z); bh[j][3] = __float_as_uint(h4.w);
      bl[j][0] = __float_as_uint(l4.x); bl[j][1] = __float_as_uint(l4.y);
      bl[j][2] = __float_as_uint(l4.z); bl[j][3] = __float_as_uint(l4.w);
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)  // lo.hi, hi.lo, then hi.hi
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_tf32(acc[m][j], al[m][ks], bh[j][2 * ks], bh[j][2 * ks + 1]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_tf32(acc[m][j], ah[m][ks], bl[j][2 * ks], bl[j][2 * ks + 1]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_tf32(acc[m][j], ah[m][ks], bh[j][2 * ks], bh[j][2 * ks + 1]);
      }
  }
}

// Rows [row0, row0 + NROWS) of a row-major (n, C) matrix into a staged
// (NROWS, CP) array by cp.async, swizzled; rows at or past n and columns
// at or past C zero-filled. `vec`: 16-byte copies (C % 4 == 0 and a
// 16-byte aligned base), else 4-byte ones.
template <int CP, int NROWS, int NTHREADS>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int row0,
                                           int n, int C, bool vec) {
  if (vec) {
    constexpr int kPieces = CP / 4;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < NROWS * kPieces; idx += NTHREADS) {
      const int r = idx / kPieces, c = (idx % kPieces) * 4;
      const bool valid = row0 + r < n && c < C;
      cp_async16(dst + r * CP + swz(r, c),
                 valid ? src + static_cast<size_t>(row0 + r) * C + c : src, valid);
    }
  } else {
    for (int idx = threadIdx.x; idx < NROWS * CP; idx += NTHREADS) {
      const int r = idx / CP, c = idx % CP;
      const bool valid = row0 + r < n && c < C;
      cp_async4(dst + r * CP + swz(r, c),
                valid ? src + static_cast<size_t>(row0 + r) * C + c : src, valid);
    }
  }
}

// (m, l) of a logsumexp merged with (m2, l2); an empty side has l == 0.
__device__ inline void lse_merge(float& m, float& l, float m2, float l2) {
  if (l2 == 0.f) return;
  if (l == 0.f) {
    m = m2;
    l = l2;
    return;
  }
  if (m2 > m) {
    l = l * expf(m - m2) + l2;
    m = m2;
  } else {
    l += l2 * expf(m2 - m);
  }
}

// The CTA's query rows, its range of queue stages and its thread's place.
struct Work {
  int row0, split, s_begin, s_end, warp, lane;
  bool live;  // the warp has a query row < B
};
template <int CP, int MT>
__device__ __forceinline__ Work work_of(int B, int K, int tiles_per_split) {
  constexpr int kPer = kKeys / stage_keys(CP);  // stages per tile
  Work w;
  w.row0 = blockIdx.x * rows_of(CP, MT);
  w.split = blockIdx.y;
  w.s_begin = w.split * tiles_per_split * kPer;
  w.s_end = min(w.s_begin + tiles_per_split * kPer, (K + stage_keys(CP) - 1) / stage_keys(CP));
  w.warp = threadIdx.x / 32;
  w.lane = threadIdx.x % 32;
  w.live = w.row0 + 16 * MT * w.warp < B;
  return w;
}

// One step of the ring: stage st + 1 of the queue on its way into the
// other buffer, stage st landed and split for every thread.
template <int CP>
__device__ __forceinline__ void ring_step(float* ring, float* lo, const float* __restrict__ queue,
                                          int st, const Work& w, int K, int C, bool vec) {
  constexpr int kSK = stage_keys(CP), kT = threads_of(CP);
  const int buf = (st - w.s_begin) & 1;
  if (st + 1 < w.s_end)
    stage_rows<CP, kSK, kT>(ring + (buf ^ 1) * kSK * CP, queue, (st + 1) * kSK, K, C, vec);
  cp_async_commit();
  cp_async_wait_one();  // stage st has landed for this thread ...
  __syncthreads();     // ... and for every thread
  split_stage<kT>(ring + buf * kSK * CP, lo, kSK * CP);
  __syncthreads();
}

template <int CP>
__global__ void __launch_bounds__(threads_of(CP), 1)
infonce_fwd_mma_kernel(const float* __restrict__ q,      // (B, C)
                       const float* __restrict__ k,      // (B, C)
                       const float* __restrict__ queue,  // (K, C)
                       float* __restrict__ pos_out,      // (B,)
                       float* __restrict__ m_part,       // (n_split, B)
                       float* __restrict__ l_part,       // (n_split, B)
                       int* __restrict__ c_part,         // (n_split, B)
                       int B, int K, int C, int tiles_per_split, float inv_t, bool vec) {
  constexpr int kMT = kFwdMT, kR = rows_of(CP, kMT), kT = threads_of(CP);
  constexpr int kSK = stage_keys(CP), kNT = kSK / 8;
  static_assert(kR == kT, "one thread per query row takes pos");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // (R, CP) query rows
  float* ring = qs + kR * CP;       // 2 stages of (SK, CP) queue rows, split in place to hi
  float* lo = ring + 2 * kSK * CP;  // (SK, CP): lo of the stage in use
  __shared__ float pos_s[kR];
  const Work w = work_of<CP, kMT>(B, K, tiles_per_split);
  const int g = w.lane >> 2, t = w.lane & 3;

  stage_rows<CP, kR, kT>(qs, q, w.row0, B, C, vec);
  cp_async_commit();
  if (w.s_begin < w.s_end) stage_rows<CP, kSK, kT>(ring, queue, w.s_begin * kSK, K, C, vec);
  cp_async_commit();
  cp_async_wait_one();  // Q has landed for this thread ...
  __syncthreads();     // ... and for every thread
  {  // pos of row threadIdx.x: the f32 FMA dot in channel order
    const int i = threadIdx.x, r = w.row0 + i;
    float dot = 0.f;
    if (r < B) {
      const float* kr = k + static_cast<size_t>(r) * C;
      if (vec) {
#pragma unroll 8
        for (int c = 0; c < C; c += 4) {  // the swizzle keeps 4-channel groups in order
          const float4 a = lds4(qs + i * CP + swz(i, c));
          const float4 b = __ldg(reinterpret_cast<const float4*>(kr + c));
          dot = fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, dot))));
        }
      } else {
        for (int c = 0; c < C; ++c) dot = fmaf(qs[i * CP + swz(i, c)], kr[c], dot);
      }
    }
    pos_s[i] = dot * inv_t;
    if (w.split == 0 && r < B) pos_out[r] = dot * inv_t;
  }
  __syncthreads();

  // rows 16 (MT warp + m) + g (h = 0) and + g + 8 (h = 1) of the block
  float pos[kMT][2], m[kMT][2], l[kMT][2];
  int cnt[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pos[mt][h] = pos_s[16 * (kMT * w.warp + mt) + g + 8 * h];
      m[mt][h] = -INFINITY;
      l[mt][h] = 0.f;
      cnt[mt][h] = 0;
    }
  const float* qw = qs + 16 * kMT * w.warp * CP;

  for (int st = w.s_begin; st < w.s_end; ++st) {
    ring_step<CP>(ring, lo, queue, st, w, K, C, vec);
    if (w.live) {
      float acc[kMT][kNT][4];
      score_stage<CP, kNT, kMT>(acc, qw, ring + ((st - w.s_begin) & 1) * kSK * CP, lo, w.lane);
      const int key0 = st * kSK + 2 * t;  // key of acc[.][j][e]: key0 + 8j + (e & 1)
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float s = acc[mt][j][e] * inv_t;
            acc[mt][j][e] = s;
            if (key0 + 8 * j + (e & 1) < K) {
              tmax[e >> 1] = fmaxf(tmax[e >> 1], s);
              cnt[mt][e >> 1] += s > pos[mt][e >> 1];
            }
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (tmax[h] == -INFINITY) continue;  // no key < K in this stage
          const float mn = fmaxf(m[mt][h], tmax[h]), ml = mn * kLog2e;
          float sum = l[mt][h] == 0.f ? 0.f : l[mt][h] * exp2f((m[mt][h] - mn) * kLog2e);
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e)
              if (key0 + 8 * j + (e & 1) < K) sum += exp2f(fmaf(acc[mt][j][e], kLog2e, -ml));
          m[mt][h] = mn;
          l[mt][h] = sum;
        }
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }

  if (!w.live) return;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // merge the quad that shares the row, in a fixed tree
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m[mt][h], off);
        const float l2 = __shfl_xor_sync(0xffffffffu, l[mt][h], off);
        const int c2 = __shfl_xor_sync(0xffffffffu, cnt[mt][h], off);
        lse_merge(m[mt][h], l[mt][h], m2, l2);
        cnt[mt][h] += c2;
      }
      const int r = w.row0 + 16 * (kMT * w.warp + mt) + g + 8 * h;
      if (t == 0 && r < B) {
        const size_t o = static_cast<size_t>(w.split) * B + r;
        m_part[o] = m[mt][h];
        l_part[o] = l[mt][h];
        c_part[o] = cnt[mt][h];
      }
    }
}

// One warp per row: lane i merges splits [i n, (i + 1) n) in order (n =
// ceil(n_split / 32); lane 0 starts from the positive), then the lanes'
// ranges are merged left to right in a fixed tree. The same bits on every
// run.
__global__ void fwd_merge_kernel(const float* __restrict__ pos, const float* __restrict__ m_part,
                                 const float* __restrict__ l_part, const int* __restrict__ c_part,
                                 float* __restrict__ lse, int* __restrict__ n_above, int B,
                                 int n_split) {
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= B) return;  // the whole warp
  float m = lane == 0 ? pos[r] : 0.f, l = lane == 0 ? 1.f : 0.f;  // the positive, exactly once
  int cnt = 0;
  const int per = (n_split + 31) / 32, end = min((lane + 1) * per, n_split);
  for (int s = lane * per; s < end; ++s) {
    const size_t o = static_cast<size_t>(s) * B + r;
    lse_merge(m, l, m_part[o], l_part[o]);
    cnt += c_part[o];
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float m2 = __shfl_down_sync(0xffffffffu, m, off);
    const float l2 = __shfl_down_sync(0xffffffffu, l, off);
    const int c2 = __shfl_down_sync(0xffffffffu, cnt, off);
    if ((lane & (2 * off - 1)) == 0) {  // lane i takes the range that follows its own
      lse_merge(m, l, m2, l2);
      cnt += c2;
    }
  }
  if (lane == 0) {
    lse[r] = m + logf(l);
    n_above[r] = cnt;
  }
}

template <int CP>
__global__ void __launch_bounds__(threads_of(CP), 1)
infonce_bwd_mma_kernel(const float* __restrict__ q,      // (B, C)
                       const float* __restrict__ queue,  // (K, C)
                       const float* __restrict__ lse,    // (B,)
                       const float* __restrict__ g_lse,  // (B,)
                       float* __restrict__ dq_part,      // (n_split, B, C)
                       int B, int K, int C, int tiles_per_split, float inv_t, bool vec) {
  constexpr int kR = rows_of(CP, kBwdMT), kT = threads_of(CP);
  constexpr int kSK = stage_keys(CP), kNT = kSK / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // (R, CP) query rows
  float* ring = qs + kR * CP;       // 2 stages of (SK, CP) queue rows, split in place to hi
  float* lo = ring + 2 * kSK * CP;  // (SK, CP): lo of the stage in use
  const Work w = work_of<CP, kBwdMT>(B, K, tiles_per_split);
  const int g = w.lane >> 2, t = w.lane & 3;

  stage_rows<CP, kR, kT>(qs, q, w.row0, B, C, vec);
  if (w.s_begin < w.s_end) stage_rows<CP, kSK, kT>(ring, queue, w.s_begin * kSK, K, C, vec);
  cp_async_commit();

  float row_lse[2], row_g[2];  // rows g, g + 8 of the warp; 0 past B
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = w.row0 + 16 * w.warp + g + 8 * h;
    row_lse[h] = r < B ? lse[r] : 0.f;
    row_g[h] = r < B ? g_lse[r] : 0.f;
  }
  float dacc[CP / 8][4];  // dQ: rows g, g + 8 x channels 8i + 2t, 8i + 2t + 1
#pragma unroll
  for (int i = 0; i < CP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dacc[i][e] = 0.f;
  const float* qw = qs + 16 * w.warp * CP;

  for (int st = w.s_begin; st < w.s_end; ++st) {
    ring_step<CP>(ring, lo, queue, st, w, K, C, vec);
    if (w.live) {
      const float* hi = ring + ((st - w.s_begin) & 1) * kSK * CP;
      float acc[1][kNT][4];
      score_stage<CP, kNT, kBwdMT>(acc, qw, hi, lo, w.lane);
      const int key0 = st * kSK + 2 * t;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        // P of keys 8j + 2t (+1), rows g (+8); as the A fragment of dQ += P.stage
        // the keys are k = t (+4): {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)}
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s = acc[0][j][e] * inv_t;
          const int h = e >> 1;
          p[e] = key0 + 8 * j + (e & 1) < K ? exp2f((s - row_lse[h]) * kLog2e) * row_g[h] : 0.f;
        }
        const float pa[4] = {p[0], p[2], p[1], p[3]};
        uint32_t ph[4], pl[4];
        split4(pa, ph, pl);
        const int r0 = (8 * j + 2 * t) * CP;  // key 8j + 2t; key 8j + 2t + 1 follows
#pragma unroll
        for (int i = 0; i < CP / 8; ++i) {
          const int c0 = r0 + swz(2 * t, 8 * i + g), c1 = r0 + CP + swz(2 * t + 1, 8 * i + g);
          const uint32_t b0h = lds(hi + c0), b1h = lds(hi + c1);
          mma_tf32(dacc[i], pl, b0h, b1h);  // lo.hi, hi.lo, then hi.hi
          mma_tf32(dacc[i], ph, lds(lo + c0), lds(lo + c1));
          mma_tf32(dacc[i], ph, b0h, b1h);
        }
      }
    }
    __syncthreads();
  }

  if (!w.live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = w.row0 + 16 * w.warp + g + 8 * h;
    if (r >= B) continue;
    float* out = dq_part + (static_cast<size_t>(w.split) * B + r) * C;
#pragma unroll
    for (int i = 0; i < CP / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * i + 2 * t + e;
        if (c < C) out[c] = dacc[i][2 * h + e];
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

// ---- host side ----------------------------------------------------------

// 16-byte copies need rows of whole 16-byte pieces and aligned bases.
bool vec_ok(int C, const void* a, const void* b, const void* c) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                          reinterpret_cast<uintptr_t>(c);
  return C % 4 == 0 && bases % 16 == 0;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int cp_rows, int threads, size_t smem, int B, int n_split,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((B + cp_rows - 1) / cp_rows, n_split);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int CP>
cudaError_t fwd_cp(const float* q, const float* k, const float* queue, float* pos, float* m_part,
                   float* l_part, int* c_part, int B, int K, int C, int n_split,
                   int tiles_per_split, float inv_t, cudaStream_t s) {
  return launch(infonce_fwd_mma_kernel<CP>, rows_of(CP, kFwdMT), threads_of(CP),
                smem_bytes<CP, kFwdMT>(), B,
                n_split, s, q, k, queue, pos, m_part, l_part, c_part, B, K, C, tiles_per_split,
                inv_t, vec_ok(C, q, k, queue));
}

template <int CP>
cudaError_t bwd_cp(const float* q, const float* queue, const float* lse, const float* g_lse,
                   float* dq_part, int B, int K, int C, int n_split, int tiles_per_split,
                   float inv_t, cudaStream_t s) {
  return launch(infonce_bwd_mma_kernel<CP>, rows_of(CP, kBwdMT), threads_of(CP),
                smem_bytes<CP, kBwdMT>(), B,
                n_split, s, q, queue, lse, g_lse, dq_part, B, K, C, tiles_per_split, inv_t,
                vec_ok(C, q, queue, queue));
}

// F<CP>(args...) for the padded width of C (0 < C <= 256).
#define INFONCE_DISPATCH(F, C, ...)                      \
  ((C) <= 32 ? F<32>(__VA_ARGS__)                        \
   : (C) <= 64 ? F<64>(__VA_ARGS__)                      \
   : (C) <= 128 ? F<128>(__VA_ARGS__) : F<256>(__VA_ARGS__))

template <int CP>
int rows_cp(int mt) { return rows_of(CP, mt); }

}  // namespace

extern "C" {

// Query rows per CTA of the forward (forward != 0) or backward kernel at
// width C, 0 for a C the kernels do not take. The caller's split plan
// sizes the number of splits of K by it.
int infonce_query_rows(int C, int forward) {
  if (C <= 0 || C > kMaxC) return 0;
  return INFONCE_DISPATCH(rows_cp, C, forward ? kFwdMT : kBwdMT);
}

// Forward statistics. The caller allocates every output and the partials
// (n_split, B) and has checked dtypes (f32, i32 counts), contiguity,
// 0 < C <= 256, B > 0, K > 0 and n_split * tiles_per_split >= ceil(K/64).
// Launches on `stream`; returns the cudaError_t (0 = success).
int infonce_fwd_f32(const void* q, const void* k, const void* queue, void* pos, void* lse,
                    void* n_above, void* m_part, void* l_part, void* c_part, int B, int K, int C,
                    int n_split, int tiles_per_split, float inv_t, void* stream) {
  if (B <= 0 || K <= 0 || C <= 0 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = INFONCE_DISPATCH(
      fwd_cp, C, static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(queue), static_cast<float*>(pos), static_cast<float*>(m_part),
      static_cast<float*>(l_part), static_cast<int*>(c_part), B, K, C, n_split, tiles_per_split,
      inv_t, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_merge_kernel<<<(B + 7) / 8, 256, 0, s>>>(
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
  float* part = static_cast<float*>(dq_part);
  cudaError_t err = INFONCE_DISPATCH(
      bwd_cp, C, static_cast<const float*>(q), static_cast<const float*>(queue),
      static_cast<const float*>(lse), static_cast<const float*>(g_lse), part, B, K, C, n_split,
      tiles_per_split, inv_t, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bc = B * C;
  bwd_reduce_kernel<<<(bc + 255) / 256, 256, 0, s>>>(part, static_cast<float*>(dq), bc, n_split,
                                                      inv_t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
