// Master-free AdamW with stochastic rounding for Hopper (sm_90a), in place.
//
// Replaces: paddle_tpu/ops/kernels/fused_adamw.py `_adamw_sr_kernel` (:244),
// the Pallas TPU kernel launched through `fused_adamw_sr_update` (:268).
//
// What it computes, per element i of the flattened tensor, in the
// reference's operation order (adamw_one in adamw_common.cuh, the same
// update as the multi-precision kernel with the bf16 param in the master's
// place):
//   g = float(g)                 (bf16, or float32 from gradient accumulation)
//   m = b1*float(m) + (1-b1)*g,  v = b2*float(v) + (1-b2)*(g*g)
//   p' = float(p) - alpha*(m/(sqrt(v)*c2 + eps)) - lrwd*float(p)
//   m, v -> bf16 (round to nearest even)
//   p -> bf16 by stochastic rounding (`_sr_round_bf16`, :226): the low 16
//        bits of hash(i, seed) are added to p's float32 bits modulo 2^32 and
//        the top 16 bits kept, so E[p_bf16] = p'.
// The hash is the reference's murmur3-style position hash of the flat
// index, in uint32_t (its plain twin is `position_hash` in
// ops/kernels/flash_attention.py; the same hash as `keep_elem` in
// flash_common.cuh). The reference hashes rows*cols + col of its 2-D tiling,
// which is the flat index whatever the tiling. The seed is the reference's
// per-(step, param) int32 seed (`sr_seed` in ops/kernels/fused_adamw.py),
// computed on the host. With every float operation an explicitly rounded
// intrinsic, the kernel gives the same bits as its plain PyTorch version: a
// contracted FMA would move p' by an ulp, and after the rounding that can
// flip a bf16 bit.
//
// Bound on the H100: bytes. Each element reads g (2 B, or 4 B as float32),
// p, m, v (2 B each) and writes p, m, v (2 B each): 14 B (16 B) for ~15
// operations, far below the card's ~295 operations per byte. So the kernel
// is one flat pass: a grid-stride loop of 16-byte loads and stores, 8
// elements per thread per iteration, then a scalar tail.
#include "adamw_common.cuh"

namespace {

__device__ __forceinline__ uint32_t position_hash(uint32_t idx,
                                                  uint32_t seed) {
  uint32_t h = idx * 0x9E3779B9u + seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint16_t sr_bf16_bits(float x, uint32_t idx,
                                                 uint32_t seed) {
  const uint32_t bits = __float_as_uint(x);
  return (uint16_t)((bits + (position_hash(idx, seed) & 0xFFFFu)) >> 16);
}

template <typename G>
__global__ void adamw_sr_kernel(const G* __restrict__ g,
                                __nv_bfloat16* __restrict__ p,
                                __nv_bfloat16* __restrict__ m,
                                __nv_bfloat16* __restrict__ v, long n,
                                Scalars s, uint32_t seed) {
  const long n8 = n / 8;
  const long stride = (long)gridDim.x * blockDim.x;
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long i = tid; i < n8; i += stride) {
    float gf[8], pf[8], mf[8], vf[8];
    load8(g, i, gf);
    load8(p, i, pf);
    load8(m, i, mf);
    load8(v, i, vf);
    uint4 praw, mraw, vraw;
    uint16_t* pb = reinterpret_cast<uint16_t*>(&praw);
    __nv_bfloat16* mb = reinterpret_cast<__nv_bfloat16*>(&mraw);
    __nv_bfloat16* vb = reinterpret_cast<__nv_bfloat16*>(&vraw);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float np = adamw_one(gf[e], mf[e], vf[e], pf[e], s);
      pb[e] = sr_bf16_bits(np, (uint32_t)(8 * i + e), seed);
      mb[e] = __float2bfloat16_rn(mf[e]);
      vb[e] = __float2bfloat16_rn(vf[e]);
    }
    reinterpret_cast<uint4*>(p)[i] = praw;
    reinterpret_cast<uint4*>(m)[i] = mraw;
    reinterpret_cast<uint4*>(v)[i] = vraw;
  }
  for (long i = n8 * 8 + tid; i < n; i += stride) {   // scalar tail
    float mi = __bfloat162float(m[i]), vi = __bfloat162float(v[i]);
    const float np = adamw_one(load1(g, i), mi, vi, __bfloat162float(p[i]),
                               s);
    p[i] = __ushort_as_bfloat16(sr_bf16_bits(np, (uint32_t)i, seed));
    m[i] = __float2bfloat16_rn(mi);
    v[i] = __float2bfloat16_rn(vi);
  }
}

template <typename G>
int launch(const void* g, void* p, void* m, void* v, long n, const Scalars& s,
           uint32_t seed, int n_sm, void* stream) {
  if (n <= 0 || n_sm <= 0 || n > 0xFFFFFFFFL) return (int)cudaErrorInvalidValue;
  adamw_sr_kernel<G><<<grid_blocks(n, n_sm), THREADS, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const G*>(g), static_cast<__nv_bfloat16*>(p),
      static_cast<__nv_bfloat16*>(m), static_cast<__nv_bfloat16*>(v), n, s,
      seed);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 grad
extern "C" int pt_fused_adamw_sr_bf16(const void* g, void* p, void* m,
                                      void* v, long n, float b1, float omb1,
                                      float b2, float omb2, float eps,
                                      float alpha, float c2, float lrwd,
                                      uint32_t seed, int n_sm, void* stream) {
  const Scalars s{b1, omb1, b2, omb2, eps, alpha, c2, lrwd};
  return launch<__nv_bfloat16>(g, p, m, v, n, s, seed, n_sm, stream);
}

// float32 grad (the mean of a gradient-accumulation cycle)
extern "C" int pt_fused_adamw_sr_bf16_gf32(const void* g, void* p, void* m,
                                           void* v, long n, float b1,
                                           float omb1, float b2, float omb2,
                                           float eps, float alpha, float c2,
                                           float lrwd, uint32_t seed, int n_sm,
                                           void* stream) {
  const Scalars s{b1, omb1, b2, omb2, eps, alpha, c2, lrwd};
  return launch<float>(g, p, m, v, n, s, seed, n_sm, stream);
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
