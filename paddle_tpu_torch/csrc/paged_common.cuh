// What the quantized paged-attention kernels (paged_attention_decode_quant.cu
// and the int8/int4 pass of paged_attention_append.cu) share: the 16-byte
// cp.async copies that stream pool rows into shared memory, and the walk to
// the next live block of a block table.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// First live block index (tables entry >= 0) in (j, j_last], or -1.
__device__ __forceinline__ int next_live(const int* row, int j, int j_last) {
  for (int n = j + 1; n <= j_last; ++n)
    if (row[n] >= 0) return n;
  return -1;
}

}  // namespace
