// IVF cell scan: scores of each query against every row of each of its
// probed cells, on the TF32 tensor cores as a three-term split product
// (f32-level results).
//
// Replaces the TPU kernel `_fused_cell_scores_kernel`
// (moco_tpu/serve/index.py:273, launched by `_fused_cell_scores_pallas`):
// there a grid step (query i, probe j) DMAs the cell tile
// cell_rows[probes[i, j]] (cell_cap, d), picked through scalar prefetch,
// and takes one (1, d) x (cell_cap, d)^T dot.
//
//   out[i, j, c] = sum_t queries[i, t] * cell_rows[probes[i, j], c, t]
//
// Bound: bytes. Each distinct probed cell read once (cell_cap d f32), the
// queries, the probe ids and the (m, nprobe, cell_cap) scores once. At the
// serving shapes (d = 128, cell_cap = 512, nprobe = 16, m <= 128) that is
// 9.2 MB for the 19 cells the served features probe at m = 128 (2.8 us)
// and 71 MB for uniform probes, more than the 50 MB L2 (21 us). The
// products, f32-exact as three TF32 products (below), take 3 x 2 m nprobe
// cell_cap d flops at 495 TFLOP/s: 2.4 us at m = 128.
//
// The TPU's grid carried over, one block per (query, probe) pair, re-reads
// a cell once per pair that probes it (on the served path 2048 pairs fall
// on 19 cells: 537 MB asked of L2 where 5 MB would do), and at m = 1 its 16
// blocks leave most of the 132 SMs idle.
//
// Design: cell-major work items, each probed cell's rows read from device
// memory once.
// - Work items are (probed cell, chunk of R = 64 rows). No planning pass
//   and no host sync: every CTA reads the probe ids (m nprobe int32, 8 KB
//   at m = 128, two rounds of 1024 in flight at once; kept in shared memory
//   when there are at most 2048) and builds the same bitmap of probed cells (8192 cells per window; larger
//   nlist takes several windows), whose prefix counts number the items:
//   the s-th probed cell in ascending order owns items s chunks + r. The
//   grid is what the card holds at once (four 41 KiB CTAs per SM at d <=
//   128) and CTA b takes items b, b + grid, ...: at m = 1, 16 probed cells
//   make 128 items on 128 CTAs; for uniform probes at m = 128, 2048 items
//   take four rounds.
// - Per item, one thread starts a single bulk copy (TMA,
//   cp.async.bulk, completing on an mbarrier) of the chunk's rows, which
//   lie contiguous in device memory, into shared memory; meanwhile the CTA
//   compacts the pair indices i nprobe + j whose probe is the cell, in
//   ascending order (per-thread counts and a block scan; no atomics), and
//   gathers their query rows by 16-byte cp.async, 16 pairs per batch, zero
//   past the batch and past d. Per-row bulk copies (a 512-byte copy per
//   row) were measured slower: the copy engine's per-copy cost bounded them.
//   The CTAs sharing an SM overlap one another's copies, gathers and
//   products.
// - Products: S^T = chunk . Q^T by `mma.sync.m16n8k8` TF32 -> f32 (HMMA):
//   each of the 4 warps takes one m16 tile of chunk rows as A against the
//   batch's query rows as B, one n8 tile when the batch has at most 8
//   pairs (the common case) and two otherwise. Each f32 operand is split
//   into hi = tf32(x) and lo = x - hi, and each product is lo.hi + hi.lo +
//   hi.hi (one TF32 product keeps ~3 digits, the gate is 1e-5 on unit
//   vectors; split4r below), each term and k-step in an accumulator
//   of its own, summed in a fixed order at the end. Widths are padded to CP
//   in {32, 64, 128, 256, 512} (channels past d read as 0); the query rows
//   have a 16-float row pad so fragment reads are free of bank conflicts.
// - One writer per output and a fixed order over d: the same bits on every
//   call. A probe id outside [0, nlist) is never dereferenced: CTA b writes
//   NaN over the columns of chunks b, b + grid, ... of every such pair, so
//   each output is written by exactly one CTA.
// - What holds it back (PERF.md §6): within a CTA an item's chunk copy
//   and then its products run in sequence, and the CTAs of an SM fall into
//   step, so the card's memory idles while they compute. With uniform
//   probes at m = 32 (3.3 items per CTA) that leaves the kernel slower than
//   the per-pair kernel it replaced, which streams at the card's read rate.
//   A second chunk stage per CTA (half the CTAs per SM, with or without the
//   pairs sorted by cell once per CTA), the warp's chunk rows held in
//   registers so that the next copy starts before the products, L2
//   prefetches of the next item and staging by cp.async were each measured
//   no faster there. And a hot cell's pairs are scored by its chunks' 8
//   CTAs alone, batch after batch (on the served path ~108 pairs per cell,
//   7 batches, while most CTAs have no item).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kIds = 8;  // probe ids per thread per scan round (two 16-byte loads)
constexpr int kRound = kIds * kThreads;
constexpr int kWindow = 8192;  // cells per bitmap of probed cells
constexpr int kWords = kWindow / 32;
constexpr int kQ = 16;  // query rows per batch of pairs: two n8 tiles
constexpr int kListCap = kQ + kRound;  // less than one batch left over, plus one round
constexpr int kCacheIds = 2048;  // probe ids kept in shared memory (m nprobe at m = 128)
constexpr int kMaxDevices = 64;

constexpr int kR = 64;  // chunk rows per work item: one m16 tile per warp
static_assert(kR == 16 * kWarps, "each warp takes one m16 tile of the chunk");
// The row stride of the staged query rows per padded width CP, CP + 16
// floats: rows g and g + 1 of a fragment read then fall on the two halves
// of the 32 banks. The chunk holds its rows as they lie in device memory
// (stride d), one bulk copy.
__host__ __device__ constexpr int stride_of(int cp) { return cp + 16; }
// The chunk and a batch's query rows: 41 KiB at CP = 128, four CTAs per SM.
template <int CP>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(kR) * CP + kQ * stride_of(CP)) * sizeof(float);
}

// Wait until all of this thread's committed groups have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- bulk copies (TMA) and their barriers --------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrives on `bar` and makes its phase wait for `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory by the copy engine; completes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- the probe ids ----------------------------------------------------------

// The exclusive prefix of v over the CTA in thread order; `total` gets the
// sum. `scratch` holds kWarps ints; two barriers.
__device__ __forceinline__ int block_scan(int v, int* scratch, int& total) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += x;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  int before = incl - v;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? scratch[w] : 0;
    total += scratch[w];
  }
  __syncthreads();  // scratch is free again
  return before;
}

// kIds probe ids from ids + i0 (the probe array, or its copy in shared
// memory); ids at or past `pairs` read as 0 (the callers test i0 + v <
// pairs).
struct Ids {
  int v[kIds];
};
__device__ __forceinline__ Ids load_ids(const int* ids, int i0, int pairs) {
  Ids p;
  if (i0 + kIds <= pairs) {
    const int4* p4 = reinterpret_cast<const int4*>(ids + i0);  // 16-byte aligned
#pragma unroll
    for (int k = 0; k < kIds / 4; ++k) {
      const int4 x = p4[k];
      p.v[4 * k] = x.x;
      p.v[4 * k + 1] = x.y;
      p.v[4 * k + 2] = x.z;
      p.v[4 * k + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kIds; ++k) p.v[k] = i0 + k < pairs ? ids[i0 + k] : 0;
  }
  return p;
}

// The cell of the slot-th set bit of the window's bitmap (word_base: the
// set bits before each word).
__device__ __forceinline__ int select_cell(const unsigned* bits, const int* word_base, int slot) {
  int lo = 0, hi = kWords - 1;  // the last word whose base is <= slot holds it
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (word_base[mid] <= slot) lo = mid;
    else hi = mid - 1;
  }
  return 32 * lo + static_cast<int>(__fns(bits[lo], 0, slot - word_base[lo] + 1));
}

// ---- the products -------------------------------------------------------

// An operand split for the three products: x = hi + lo with hi = tf32(x)
// (nearest, ties away from zero) and lo = x - hi exactly; the tensor cores
// read lo's 19 high bits, and |lo| <= 2^-11 |x|, so what they drop is below
// 2^-21 |x|. Three operations per element where rounding lo as well (as
// infonce.cu does) takes four.
__device__ __forceinline__ void split4r(const float x[4], uint32_t hi[4], uint32_t lo[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = (__float_as_uint(x[i]) + 0x1000u) & 0xffffe000u;
    lo[i] = __float_as_uint(x[i] - __uint_as_float(hi[i]));
  }
}

// acc[q] (chunk rows g, g + 8 of cw x query rows 8q + 2t, 8q + 2t + 1 of
// qs) over CP channels: the chunk is the A operand (a warp's m16 tile of
// it) and the batch's query rows are B (NQ n8 tiles), so a batch of up to
// 8 pairs, the common case, takes one product per k-step and term. Rows
// are unswizzled (stride d for the chunk, whose channels past d read as 0;
// SP for the queries), and the channel order within 16 is permuted as in
// infonce.cu's score_stage, so each fragment of two k-steps is one 16-byte
// read. The chunk is split into hi and lo as its fragments are
// read: a warp reads each element of its tile once per batch, so a split
// pass (and a lo array) would split no fewer. The three products of each
// k-step go to six accumulators of their own, summed at the end in a fixed
// order: with one accumulator per tile, all 6 CP / 16 products of a tile
// would chain, each waiting for the one before.
template <int CP, int NQ>
__device__ __forceinline__ void score_chunk(float acc[NQ][4], const float* cw, const float* qs,
                                            int d, int lane) {
  constexpr int SP = stride_of(CP);
  const int g = lane >> 2, t = lane & 3;
  float part[NQ][6][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int u = 0; u < 6; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[q][u][e] = 0.f;
#pragma unroll 2
  for (int kc = 0; kc < CP / 16; ++kc) {
    const int c = 16 * kc + 4 * t;  // k-step 0 takes channels c, c + 1; k-step 1 c + 2, c + 3
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 ra = c < d ? lds4(cw + g * d + c) : z;  // past d: the next row's, read as 0
    const float4 rb = c < d ? lds4(cw + (g + 8) * d + c) : z;
    const float a0[4] = {ra.x, rb.x, ra.y, rb.y}, a1[4] = {ra.z, rb.z, ra.w, rb.w};
    uint32_t ah[2][4], al[2][4];
    split4r(a0, ah[0], al[0]);
    split4r(a1, ah[1], al[1]);
    uint32_t bh[NQ][4], bl[NQ][4];  // k-step 0 is {0, 1}, k-step 1 is {2, 3}
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float4 x = lds4(qs + (8 * q + g) * SP + c);
      const float b[4] = {x.x, x.y, x.z, x.w};
      split4r(b, bh[q], bl[q]);
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)  // lo.hi, hi.lo, hi.hi
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        mma_tf32(part[q][3 * ks], al[ks], bh[q][2 * ks], bh[q][2 * ks + 1]);
        mma_tf32(part[q][3 * ks + 1], ah[ks], bl[q][2 * ks], bl[q][2 * ks + 1]);
        mma_tf32(part[q][3 * ks + 2], ah[ks], bh[q][2 * ks], bh[q][2 * ks + 1]);
      }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q)  // (lo.hi + hi.lo) + hi.hi, k-step 0 then k-step 1
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float (&p)[6][4] = part[q];
      acc[q][e] = ((p[0][e] + p[1][e]) + p[2][e]) + ((p[3][e] + p[4][e]) + p[5][e]);
    }
}

// The warp's 16 chunk rows [16 w, 16 w + 16) against the batch's query
// rows; writes the scores of chunk rows < rows and query rows < count.
template <int CP, int NQ>
__device__ __forceinline__ void score_batch(const float* chunk, const float* qs,
                                            float* __restrict__ out, const int* list, int first,
                                            int count, int cell_cap, int d, int r0, int rows) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3, row0 = threadIdx.x / 32 * 16;
  float acc[NQ][4];
  score_chunk<CP, NQ>(acc, chunk + row0 * d, qs, d, lane);
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1), pair = 8 * q + 2 * t + (e & 1);
      if (row < rows && pair < count)
        out[static_cast<size_t>(list[first + pair]) * cell_cap + r0 + row] = acc[q][e];
    }
}

// ---- the kernel -------------------------------------------------------------

template <int CP>
__global__ void __launch_bounds__(kThreads, 4)
cell_scores_mma_kernel(const float* __restrict__ queries,   // (m, d)
                       const float* __restrict__ cell_rows, // (nlist, cell_cap, d)
                       const int* __restrict__ probes,      // (m, nprobe)
                       float* __restrict__ out,             // (m, nprobe, cell_cap)
                       int pairs, int nprobe, int nlist, int cell_cap, int d) {
  constexpr int SP = stride_of(CP);
  constexpr int kPer = kWords / kThreads, kPieces = CP / 4;
  extern __shared__ __align__(16) float smem[];
  float* chunk = smem;         // (R, d) chunk rows
  float* qs = chunk + kR * CP;  // (Q, SP) query rows of a batch of pairs
  __shared__ __align__(8) uint64_t bar;  // the chunk's bulk copy
  __shared__ int list[kListCap];      // the item's pairs, ascending
  __shared__ unsigned bits[kWords];   // the window's probed cells
  __shared__ int word_base[kWords];   // set bits before each word
  __shared__ int scratch[kWarps];
  __shared__ __align__(16) int ids_cache[kCacheIds];  // the probe ids, when they fit
  const int* ids = pairs <= kCacheIds ? ids_cache : probes;
  const int chunks = (cell_cap + kR - 1) / kR, b = blockIdx.x, n_cta = gridDim.x;
  uint32_t parity = 0;  // the phase of `bar` to wait for next
  int offset = 0;  // work items of the earlier windows, mod n_cta

  if (threadIdx.x == 0) {
    mbar_init(&bar);
    mbar_fence_init();
  }
  __syncthreads();

  for (int w0 = 0; w0 == 0 || w0 < nlist; w0 += kWindow) {
    // the window's probed cells; NaN over this CTA's chunks for bad ids
    const int w1 = min(w0 + kWindow, nlist);
    for (int i = threadIdx.x; i < kWords; i += kThreads) bits[i] = 0;
    __syncthreads();
    for (int base = 0; base < pairs; base += 2 * kRound) {  // two rounds' loads in flight at once
      const int j0 = base + threadIdx.x * kIds;
      const Ids p2[2] = {load_ids(probes, j0, pairs), load_ids(probes, j0 + kRound, pairs)};
#pragma unroll
      for (int h = 0; h < 2 * kIds; ++h) {
        const int v = h % kIds, i0 = j0 + h / kIds * kRound;
        const int c = p2[h / kIds].v[v];
        if (i0 + v >= pairs) continue;
        if (w0 == 0 && ids != probes) ids_cache[i0 + v] = c;
        if (c >= w0 && c < w1) {
          atomicOr(&bits[(c - w0) >> 5], 1u << ((c - w0) & 31));
        } else if (w0 == 0 && (c < 0 || c >= nlist)) {
          float* o = out + static_cast<size_t>(i0 + v) * cell_cap;
          for (int r = b; r < chunks; r += n_cta)
            for (int col = r * kR; col < min(r * kR + kR, cell_cap); ++col) o[col] = NAN;
        }
      }
    }
    __syncthreads();
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) cnt += __popc(bits[threadIdx.x * kPer + j]);
    int live;
    int before = block_scan(cnt, scratch, live);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      word_base[threadIdx.x * kPer + j] = before;
      before += __popc(bits[threadIdx.x * kPer + j]);
    }
    __syncthreads();

    // work items (slot, r) of the window, numbered slot * chunks + r after
    // the earlier windows' items; this CTA takes those congruent to b mod
    // n_cta. The chunk's copy overlaps the gathering of the cell's pairs
    // and their query rows; the CTAs sharing the SM overlap the rest.
    const int items = live * chunks;
    for (int i = (b - offset + n_cta) % n_cta; i < items; i += n_cta) {
      const int cell = w0 + select_cell(bits, word_base, i / chunks);
      const int r0 = i % chunks * kR, rows = min(kR, cell_cap - r0);
      if (threadIdx.x == 0) {  // the chunk's rows, contiguous in device memory: one copy
        const uint32_t bytes = static_cast<uint32_t>(rows) * d * sizeof(float);
        mbar_expect(&bar, bytes);
        bulk_copy(chunk, cell_rows + (static_cast<size_t>(cell) * cell_cap + r0) * d, bytes, &bar);
      }
      bool landed = false;
      int n = 0;  // pairs in the list (the same in every thread)
      for (int base = 0; base < pairs; base += kRound) {
        const int i0 = base + threadIdx.x * kIds;
        const Ids p = load_ids(ids, i0, pairs);
        int mine = 0;
#pragma unroll
        for (int v = 0; v < kIds; ++v) mine += i0 + v < pairs && p.v[v] == cell;
        int total;
        int at = n + block_scan(mine, scratch, total);
#pragma unroll
        for (int v = 0; v < kIds; ++v)
          if (i0 + v < pairs && p.v[v] == cell) list[at++] = i0 + v;
        n += total;
        __syncthreads();  // the list is written
        if (n < kQ && !(n > 0 && base + kRound >= pairs)) continue;
        for (int first = 0; first < n; first += kQ) {  // batches of Q pairs
          const int count = min(kQ, n - first);
          // the batch's query rows by 16-byte cp.async, zero past count and d
#pragma unroll 4
          for (int idx = threadIdx.x; idx < kQ * kPieces; idx += kThreads) {
            const int r = idx / kPieces, c = (idx % kPieces) * 4;
            const bool valid = r < count && c < d;
            const float* src = valid
                ? queries + static_cast<size_t>(list[first + r] / nprobe) * d + c : queries;
            cp_async16(qs + r * SP + c, src, valid);
          }
          cp_async_commit();
          if (!landed) {  // the chunk
            mbar_wait(&bar, parity);
            parity ^= 1;
            landed = true;
          }
          cp_async_wait_all();
          __syncthreads();  // every thread's query rows have landed
          if (count > 8)
            score_batch<CP, 2>(chunk, qs, out, list, first, count, cell_cap, d, r0, rows);
          else
            score_batch<CP, 1>(chunk, qs, out, list, first, count, cell_cap, d, r0, rows);
          __syncthreads();  // qs, the list and the chunk are refilled next
        }
        n = 0;
      }
    }
    offset = static_cast<int>((offset + static_cast<long long>(items)) % n_cta);
    __syncthreads();  // the bitmap is cleared next
  }
}

// CTAs of cell_scores_mma_kernel<CP> resident on the current card at once
// (0 on failure); the shared-memory limit is raised on first use per card.
template <int CP>
int resident_ctas(cudaError_t& err) {
  static int cached[kMaxDevices];
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return 0;
  if (dev < kMaxDevices && cached[dev]) return cached[dev];
  constexpr size_t smem = smem_bytes<CP>();
  int per_sm = 0, sms = 0;
  err = cudaFuncSetAttribute(cell_scores_mma_kernel<CP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cell_scores_mma_kernel<CP>,
                                                        kThreads, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return 0;
  const int n = per_sm > 0 ? per_sm * sms : 1;
  if (dev < kMaxDevices) cached[dev] = n;
  return n;
}

template <int CP>
cudaError_t launch_cp(const float* queries, const float* cell_rows, const int* probes,
                      float* out, int pairs, int nprobe, int nlist, int cell_cap, int d,
                      cudaStream_t stream) {
  cudaError_t err;
  const int resident = resident_ctas<CP>(err);
  if (err != cudaSuccess) return err;
  // one CTA per work item (probed cell, chunk) up to what the card holds
  // at once: more would only start CTAs that find no item
  const long long cells = nlist < pairs ? nlist : pairs;
  const long long items = (cells > 0 ? cells : 1) * ((cell_cap + kR - 1) / kR);
  const int n_cta = static_cast<int>(items < resident ? items : resident);
  cell_scores_mma_kernel<CP><<<n_cta, kThreads, smem_bytes<CP>(), stream>>>(
      queries, cell_rows, probes, out, pairs, nprobe, nlist, cell_cap, d);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// The caller has checked shapes, dtypes, contiguity, 16-byte alignment,
// d % 4 == 0, 0 < d <= 512 and m * nprobe <= 2^30.
extern "C" int ivf_cell_scores_f32(const void* queries, const void* cell_rows,
                                   const void* probes, void* out, int m,
                                   int nprobe, int nlist, int cell_cap, int d,
                                   void* stream) {
  const int pairs = m * nprobe;
  if (pairs == 0 || cell_cap == 0) return 0;
  const auto q = static_cast<const float*>(queries);
  const auto rows = static_cast<const float*>(cell_rows);
  const auto p = static_cast<const int*>(probes);
  const auto o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= 32) err = launch_cp<32>(q, rows, p, o, pairs, nprobe, nlist, cell_cap, d, s);
  else if (d <= 64) err = launch_cp<64>(q, rows, p, o, pairs, nprobe, nlist, cell_cap, d, s);
  else if (d <= 128) err = launch_cp<128>(q, rows, p, o, pairs, nprobe, nlist, cell_cap, d, s);
  else if (d <= 256) err = launch_cp<256>(q, rows, p, o, pairs, nprobe, nlist, cell_cap, d, s);
  else err = launch_cp<512>(q, rows, p, o, pairs, nprobe, nlist, cell_cap, d, s);
  return static_cast<int>(err);
}
