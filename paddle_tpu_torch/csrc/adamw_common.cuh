// What the two AdamW kernels (fused_adamw.cu, fused_adamw_sr.cu) share:
// the step scalars, the update of one element in the reference's operation
// order with explicitly rounded float32 intrinsics (no FMA contraction, so
// each kernel is bit-identical to its plain PyTorch version), the loads of
// eight bf16 or float32 values as float, and the grid size.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Scalars {
  float b1, omb1, b2, omb2, eps, alpha, c2, lrwd;
};

__device__ __forceinline__ float adamw_one(float g, float& m, float& v,
                                           float mw, const Scalars& s) {
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(s.omb2, __fmul_rn(g, g)));
  const float denom = __fadd_rn(__fmul_rn(__fsqrt_rn(v), s.c2), s.eps);
  const float step = __fmul_rn(s.alpha, __fdiv_rn(m, denom));
  return __fsub_rn(__fsub_rn(mw, step), __fmul_rn(s.lrwd, mw));
}

// Elements [8*i, 8*i + 8) as float.
__device__ __forceinline__ void load8(const __nv_bfloat16* g, long i,
                                      float out[8]) {
  const uint4 raw = reinterpret_cast<const uint4*>(g)[i];
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(b[e]);
}

__device__ __forceinline__ void load8(const float* g, long i, float out[8]) {
  const float4 lo = reinterpret_cast<const float4*>(g)[2 * i];
  const float4 hi = reinterpret_cast<const float4*>(g)[2 * i + 1];
  out[0] = lo.x; out[1] = lo.y; out[2] = lo.z; out[3] = lo.w;
  out[4] = hi.x; out[5] = hi.y; out[6] = hi.z; out[7] = hi.w;
}

__device__ __forceinline__ float load1(const __nv_bfloat16* g, long i) {
  return __bfloat162float(g[i]);
}

__device__ __forceinline__ float load1(const float* g, long i) { return g[i]; }

constexpr int THREADS = 256;

// Blocks for a grid-stride pass over n elements, 8 per thread per
// iteration: enough to cover n once, at most 8 blocks per SM.
inline int grid_blocks(long n, int n_sm) {
  const long want = (n / 8 + THREADS - 1) / THREADS;
  return (int)(want < 1 ? 1 : (want > 8L * n_sm ? 8L * n_sm : want));
}

}  // namespace
