// What the attention kernels share: the mma.sync fragment helpers of the
// paged kernels (csrc/paged_split.cuh) and of the int4 GEMM
// (int4_matmul.cu), the paged append's thread count,
// and the bf16 packing, the launch order and the dropout hash that the
// flash forward and backward
// (flash_attention_fwd.cu, flash_attention_bwd.cu, built on
// sm90_common.cuh) use too. The backward
// is right only if it rebuilds the forward's dropout mask bit for bit, so
// `keep_elem` lives here once (its plain twin is `keep_mask` in
// ops/kernels/flash_attention.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;   // the paged append's write passes

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// (a, b) as three bf16x2 terms whose sum is exactly (a, b): each term is
// the bf16 rounding of what the terms before it left (a float of 24
// significant bits in three of 8).
__device__ __forceinline__ void split3_bf16(float a, float b,
                                            uint32_t (&t)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    t[i] = *reinterpret_cast<const uint32_t*>(&h);
    a = __fsub_rn(a, __low2float(h));
    b = __fsub_rn(b, __high2float(h));
  }
}

// Heads per launch group of the flash kernels: a group's operands stay in L2.
constexpr int HEAD_GROUP = 16;

// The (head, tile) of the CTA launched `rank`-th (blocks launch in x-fastest
// order) over n_t tiles of each of n_h heads: heads in groups of HEAD_GROUP,
// and inside a group the tiles heaviest first across its heads, so that the
// long causal walks start early. The heaviest tile is the last if
// `heavy_last` (a q tile, whose causal walk grows with its index), else the
// first (a kv tile of the dK/dV walk).
__device__ __forceinline__ void group_tile(int rank, int n_t, int n_h,
                                           bool heavy_last, int& bh, int& t) {
  const int per_group = HEAD_GROUP * n_t;
  const int group = rank / per_group, r = rank % per_group;
  const int left = n_h - group * HEAD_GROUP;
  const int heads = left < HEAD_GROUP ? left : HEAD_GROUP;
  bh = group * HEAD_GROUP + r % heads;
  t = heavy_last ? n_t - 1 - r / heads : r / heads;
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
