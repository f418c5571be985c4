// Fused multi-precision AdamW update for Hopper (sm_90a), in place.
//
// Replaces: paddle_tpu/ops/kernels/fused_adamw.py `_adamw_kernel` (:40),
// the Pallas TPU kernel launched through `fused_adamw_update` (:142).
//
// What it computes, per element, in the reference's operation order:
//   g = float(g)                 (bf16, or float32 from gradient accumulation)
//   m = b1*m + (1-b1)*g
//   v = b2*v + (1-b2)*(g*g)
//   denom = sqrt(v)*c2 + eps
//   mw = mw - alpha*(m/denom) - lrwd*mw
//   p_bf16 = bf16(mw)            (round to nearest even)
// with alpha = lr/bc1, c2 = 1/sqrt(bc2) and lrwd = lr*wd (0 when decay is
// masked) computed by the caller on the host. Every operation is an
// explicitly rounded intrinsic, so nvcc cannot contract a multiply and an
// add into an FMA: the result is the same bits as the plain PyTorch version
// (one IEEE-rounded float32 op per step) on the same inputs.
//
// Bound on the H100: bytes. Each element reads g (2 B, or 4 B as float32),
// m, v, master (4 B each) and writes m, v, master (4 B each) and p (2 B):
// 28 B (30 B) for ~12 flops, far below the card's ~295 flops per byte. So
// the kernel is one pass: a grid-stride loop of 16-byte loads and stores (8
// elements per thread per iteration: one uint4 of bf16 grads or two float4
// of float32 ones, two float4 each of m, v and master), then a scalar tail.
// Nothing is staged in shared memory. One template serves both grad types.
#include "adamw_common.cuh"

namespace {

template <typename G>
__global__ void adamw_kernel(const G* __restrict__ g, float* __restrict__ m,
                             float* __restrict__ v, float* __restrict__ mw,
                             __nv_bfloat16* __restrict__ p, long n,
                             Scalars s) {
  const long n8 = n / 8;
  const long stride = (long)gridDim.x * blockDim.x;
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long i = tid; i < n8; i += stride) {
    float gf[8];
    load8(g, i, gf);
    float4 mv[2], vv[2], wv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mv[h] = reinterpret_cast<const float4*>(m)[2 * i + h];
      vv[h] = reinterpret_cast<const float4*>(v)[2 * i + h];
      wv[h] = reinterpret_cast<const float4*>(mw)[2 * i + h];
    }
    float* mf = reinterpret_cast<float*>(mv);
    float* vf = reinterpret_cast<float*>(vv);
    float* wf = reinterpret_cast<float*>(wv);
    uint4 praw;
    __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(&praw);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      wf[e] = adamw_one(gf[e], mf[e], vf[e], wf[e], s);
      pb[e] = __float2bfloat16_rn(wf[e]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      reinterpret_cast<float4*>(m)[2 * i + h] = mv[h];
      reinterpret_cast<float4*>(v)[2 * i + h] = vv[h];
      reinterpret_cast<float4*>(mw)[2 * i + h] = wv[h];
    }
    reinterpret_cast<uint4*>(p)[i] = praw;
  }
  for (long i = n8 * 8 + tid; i < n; i += stride) {   // scalar tail
    float mi = m[i], vi = v[i];
    const float w = adamw_one(load1(g, i), mi, vi, mw[i], s);
    m[i] = mi;
    v[i] = vi;
    mw[i] = w;
    p[i] = __float2bfloat16_rn(w);
  }
}

template <typename G>
int launch(const void* g, void* m, void* v, void* mw, void* p, long n,
           const Scalars& s, int n_sm, void* stream) {
  if (n <= 0 || n_sm <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = grid_blocks(n, n_sm);
  adamw_kernel<G><<<blocks, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const G*>(g), static_cast<float*>(m), static_cast<float*>(v),
      static_cast<float*>(mw), static_cast<__nv_bfloat16*>(p), n, s);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 grad
extern "C" int pt_fused_adamw_bf16(const void* g, void* m, void* v, void* mw,
                                   void* p, long n, float b1, float omb1,
                                   float b2, float omb2, float eps,
                                   float alpha, float c2, float lrwd,
                                   int n_sm, void* stream) {
  const Scalars s{b1, omb1, b2, omb2, eps, alpha, c2, lrwd};
  return launch<__nv_bfloat16>(g, m, v, mw, p, n, s, n_sm, stream);
}

// float32 grad (the mean of a gradient-accumulation cycle)
extern "C" int pt_fused_adamw_bf16_gf32(const void* g, void* m, void* v,
                                        void* mw, void* p, long n, float b1,
                                        float omb1, float b2, float omb2,
                                        float eps, float alpha, float c2,
                                        float lrwd, int n_sm, void* stream) {
  const Scalars s{b1, omb1, b2, omb2, eps, alpha, c2, lrwd};
  return launch<float>(g, m, v, mw, p, n, s, n_sm, stream);
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
