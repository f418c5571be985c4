// What the flash-attention kernels share: the tile shape, the mma.sync
// fragment helpers and the shared-memory tile copy of the backward
// (flash_attention_bwd.cu) and the paged append, and the dropout hash and
// bf16 packing that the forward (flash_attention_fwd.cu, built on
// sm90_common.cuh) uses too. The backward is right only if it rebuilds the
// forward's dropout mask bit for bit, so `keep_elem` lives here once (its
// plain twin is `keep_mask` in ops/kernels/flash_attention.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // q rows per tile (4 warps x 16)
constexpr int BK = 64;       // kv rows per tile
constexpr int NTHREADS = 128;
constexpr int PAD = 8;       // bf16 elements of padding per shared row

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  uint16_t l = *reinterpret_cast<uint16_t*>(&lo);
  uint16_t h = *reinterpret_cast<uint16_t*>(&hi);
  return (uint32_t)l | ((uint32_t)h << 16);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy rows [r0, r0 + 64) of a [rows, D] matrix (row stride `stride`
// elements) into shared memory, zero-filling rows past `nrows`.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long stride, int r0, int nrows) {
  constexpr int LD = D + PAD;
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < BK * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// The reference's `_keep_mask` (paddle_tpu/ops/kernels/flash_attention.py:48):
// a murmur3-style hash of the absolute (q-head, row, col) position, 32-bit
// wraparound, 31 bits compared with thr = int(p * 2^31).
__device__ __forceinline__ bool keep_elem(uint32_t seed, uint32_t bh,
                                          uint32_t row, uint32_t col,
                                          uint32_t sq, uint32_t sk,
                                          uint32_t thr) {
  uint32_t h = ((bh * sq + row) * sk + col) * 0x9E3779B9u + seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return (h & 0x7FFFFFFFu) >= thr;
}

}  // namespace
