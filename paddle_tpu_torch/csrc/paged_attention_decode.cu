// Paged-attention decode step for Hopper (sm_90a), bf16 pools, fp32 math.
//
// Replaces: paddle_tpu/ops/kernels/paged_attention.py `_decode_kernel`
// (:370), the Pallas TPU kernel launched through `paged_attention_decode`
// (:481), in its unquantized form with the fused new-token write.
//
// What it computes: for each sequence b and kv head, the G = Hq / Hkv query
// heads of one new token attend positions <= lens[b] of the sequence's
// blocks in pools [NB, Hkv, bs, D], found through tables [B, MB]. First the
// new K/V row is written at position lens[b] into block
// tables[b, min(lens[b] / bs, MB - 1)]; a -1 entry there routes the write
// to the pool's last block (the engine's scratch block), never to a real
// one. The walk covers blocks 0 .. lens[b] / bs only and skips -1 entries,
// so the dead tail is never read. fp32 online softmax, out =
// acc / max(l, 1e-30), P rounded to bf16 before the P@V product as the
// reference rounds it.
//
// Bound on the H100: bytes. One step reads each live K and V row once:
// at the smoke shape (B=8, Hkv=32, D=128, mean live length ~1000) that is
// ~90-130 MB, ~0.03-0.04 ms at 3.35 TB/s, against ~1 operation per byte —
// far below the ~295 operations per byte where the tensor cores would
// matter, so the math stays on the CUDA cores in fp32.
//
// Design (simple; no split-K, no TMA): one CTA of 128 threads per
// (kv head, sequence). The CTA's live blocks stream through shared memory
// with 16-byte cp.async copies, double-buffered: block j+1's K and V rows
// are in flight while block j is scored (one thread per position, 16-byte
// reads of padded rows, free of bank conflicts), folded into the fp32
// online softmax (one warp per query head) and accumulated into P@V (one
// thread per head-dim column). The new token's K/V comes from shared
// memory at its position, so the CTA never reads back its own write. The
// walk of one long sequence still runs on one SM: splitting it across
// CTAs (flash-decoding) is later work, as is filling the 132 SMs when GQA
// leaves only B*Hkv CTAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_common.cuh"

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXBS = 128;  // block size
constexpr int PAD = 8;      // bf16 elements of padding per shared row

// D: head dim; G: query heads per kv head (compile-time, so the per-head
// accumulators stay in registers)
template <int D, int G>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, long long q_bstride,
                    __nv_bfloat16* k_pool, __nv_bfloat16* v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens,
                    const __nv_bfloat16* __restrict__ new_k,
                    long long nk_bstride,
                    const __nv_bfloat16* __restrict__ new_v,
                    long long nv_bstride, __nv_bfloat16* __restrict__ out,
                    int Hq, int Hkv, int bs, int MB, int NB, float scale) {
  static_assert(D <= NTHREADS && MAXBS <= NTHREADS,
                "one thread per head-dim column and per block position");
  constexpr int LD = D + PAD;   // shared row stride in elements
  constexpr int CH = D / 8;     // 16-byte chunks per row
  extern __shared__ __align__(16) __nv_bfloat16 kv_s[];  // [2][K, V][bs][LD]
  __shared__ __align__(16) float q_s[G][D];
  __shared__ __align__(16) float nk_s[D];
  __shared__ float nv_s[D];
  __shared__ float p_s[G][MAXBS];
  __shared__ float m_s[G], l_s[G], a_s[G];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* trow = tables + (long)b * MB;
  const int L = lens[b];
  const int j_last = min(L / bs, MB - 1);
  const int slot = L - j_last * bs;
  const int phys_last = trow[j_last];
  const int tgt = phys_last < 0 ? NB - 1 : phys_last;
  const long stage = (long)2 * bs * LD;   // elements of one stage (K and V)

  // copy block j's live rows (K, then V) into shared stage `st`
  auto issue = [&](int j, int st) {
    const long base = ((long)trow[j] * Hkv + kvh) * bs * D;
    const int rows = min(bs, L - j * bs + 1);
    __nv_bfloat16* ks = kv_s + st * stage;
    __nv_bfloat16* vs = ks + (long)bs * LD;
    for (int i = tid; i < rows * CH; i += NTHREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      cp_async16(ks + r * LD + c, k_pool + base + (long)r * D + c);
      cp_async16(vs + r * LD + c, v_pool + base + (long)r * D + c);
    }
    cp_async_commit();
  };

  int j = (trow[0] >= 0) ? 0 : next_live(trow, 0, j_last);
  if (j >= 0) issue(j, 0);

  for (int i = tid; i < G * D; i += NTHREADS) {
    const int g = i / D, d = i % D;
    q_s[g][d] = __bfloat162float(
                    q[(long)b * q_bstride + (long)(kvh * G + g) * D + d]) *
                scale;
  }
  for (int d = tid; d < D; d += NTHREADS) {
    const __nv_bfloat16 kk = new_k[(long)b * nk_bstride + (long)kvh * D + d];
    const __nv_bfloat16 vv = new_v[(long)b * nv_bstride + (long)kvh * D + d];
    nk_s[d] = __bfloat162float(kk);
    nv_s[d] = __bfloat162float(vv);
    if (slot < bs) {
      const long off = (((long)tgt * Hkv + kvh) * bs + slot) * D + d;
      k_pool[off] = kk;
      v_pool[off] = vv;
    }
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  int st = 0;
  while (j >= 0) {
    const int jn = next_live(trow, j, j_last);
    if (jn >= 0) {
      issue(jn, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // block j resident; q_s, nk_s, m_s, l_s written
    const __nv_bfloat16* ks = kv_s + st * stage;
    const __nv_bfloat16* vs = ks + (long)bs * LD;
    const int n_valid = min(bs, L - j * bs + 1);
    const int new_row = (j == j_last) ? slot : -1;

    // scores: thread p scores position p against every query head, in
    // two accumulator chains (even and odd 16-byte chunks). bs <= NTHREADS,
    // so a thread owns at most one position (no loop for q to be hoisted
    // out of into registers)
    if (tid < n_valid) {
      const int p = tid;
      float part[2][G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[0][g] = part[1][g] = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float kf[8];
        if (p == new_row) {
          const float4 a = *reinterpret_cast<const float4*>(&nk_s[c * 8]);
          const float4 bb = *reinterpret_cast<const float4*>(&nk_s[c * 8 + 4]);
          kf[0] = a.x; kf[1] = a.y; kf[2] = a.z; kf[3] = a.w;
          kf[4] = bb.x; kf[5] = bb.y; kf[6] = bb.z; kf[7] = bb.w;
        } else {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(ks + p * LD + c * 8);
          const __nv_bfloat162* h2 =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h2[e]);
            kf[2 * e] = f.x;
            kf[2 * e + 1] = f.y;
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 qa = *reinterpret_cast<const float4*>(&q_s[g][c * 8]);
          const float4 qb =
              *reinterpret_cast<const float4*>(&q_s[g][c * 8 + 4]);
          part[c & 1][g] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] +
                            qa.w * kf[3] + qb.x * kf[4] + qb.y * kf[5] +
                            qb.z * kf[6] + qb.w * kf[7];
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) p_s[g][p] = part[0][g] + part[1][g];
    }
    __syncthreads();

    // online softmax: warp w updates query heads w, w + 4
    for (int g = warp; g < G; g += NWARPS) {
      float mx = -INFINITY;
      for (int i = lane; i < n_valid; i += 32) mx = fmaxf(mx, p_s[g][i]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int i = lane; i < n_valid; i += 32) {
        const float p = expf(p_s[g][i] - m_new);
        sum += p;
        p_s[g][i] = __bfloat162float(__float2bfloat16_rn(p));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // P @ V: thread d owns head-dim column d (D <= NTHREADS)
    if (tid < D) {
      const int d = tid;
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] *= a_s[g];
#pragma unroll 4
      for (int p = 0; p < n_valid; ++p) {
        const float vv =
            (p == new_row) ? nv_s[d] : __bfloat162float(vs[p * LD + d]);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] += p_s[g][p] * vv;
      }
    }
    __syncthreads();   // stage st and p_s are rewritten next iteration
    j = jn;
    st ^= 1;
  }

  if (tid < D) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      out[((long)b * Hq + kvh * G + g) * D + tid] =
          __float2bfloat16_rn(acc[g] / fmaxf(l_s[g], 1e-30f));
  }
}

template <int D, int G>
int launch(dim3 grid, cudaStream_t s, const __nv_bfloat16* q,
           long long q_bstride, __nv_bfloat16* k_pool, __nv_bfloat16* v_pool,
           const int* tables, const int* lens, const __nv_bfloat16* new_k,
           long long nk_bstride, const __nv_bfloat16* new_v,
           long long nv_bstride, __nv_bfloat16* out, int Hq, int Hkv, int bs,
           int MB, int NB, float scale) {
  const int smem = 2 * 2 * bs * (D + PAD) * (int)sizeof(__nv_bfloat16);
  static int smem_allowed = 0;   // the opt-in above 48 KB, set once per size
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  paged_decode_kernel<D, G><<<grid, NTHREADS, smem, s>>>(
      q, q_bstride, k_pool, v_pool, tables, lens, new_k, nk_bstride, new_v,
      nv_bstride, out, Hq, Hkv, bs, MB, NB, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pt_paged_attention_decode_bf16(
    const void* q, long long q_bstride, void* k_pool, void* v_pool,
    const void* tables, const void* lens, const void* new_k,
    long long nk_bstride, const void* new_v, long long nv_bstride, void* out,
    int B, int Hq, int Hkv, int D, int bs, int MB, int NB, float scale,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || bs <= 0 || bs > MAXBS || MB <= 0 ||
      NB <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kp = static_cast<__nv_bfloat16*>(k_pool);
  auto* vp = static_cast<__nv_bfloat16*>(v_pool);
  const auto* tp = static_cast<const int*>(tables);
  const auto* lp = static_cast<const int*>(lens);
  const auto* nkp = static_cast<const __nv_bfloat16*>(new_k);
  const auto* nvp = static_cast<const __nv_bfloat16*>(new_v);
  auto* op = static_cast<__nv_bfloat16*>(out);
#define PT_LAUNCH(DD, GG)                                                  \
  if (D == DD && Hq / Hkv == GG)                                           \
    return launch<DD, GG>(grid, s, qp, q_bstride, kp, vp, tp, lp, nkp,     \
                          nk_bstride, nvp, nv_bstride, op, Hq, Hkv, bs, MB, \
                          NB, scale);
  PT_LAUNCH(128, 1) PT_LAUNCH(128, 2) PT_LAUNCH(128, 4) PT_LAUNCH(128, 8)
  PT_LAUNCH(64, 1) PT_LAUNCH(64, 2) PT_LAUNCH(64, 4) PT_LAUNCH(64, 8)
#undef PT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
