// PTX wrappers shared by the split-TF32 tensor-core kernels (infonce.cu,
// ivf_cell_scores.cu): 16-byte cp.async from global to shared memory and
// the TF32 m16n8k8 mma.sync. Everything is in an anonymous namespace: each
// kernel source that includes this header gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- PTX wrappers -----------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory without waiting; the destination
// is zero-filled instead when !valid (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// c (16 x 8, f32) += a (16 x 8, tf32, row) . b (8 x 8, tf32, col).
// Fragments (g = lane / 4, t = lane % 4): a = {(g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4)}; b = {(t, g), (t + 4, g)};
// c = {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

}  // namespace
