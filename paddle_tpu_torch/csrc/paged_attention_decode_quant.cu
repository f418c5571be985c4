// Paged-attention decode step over QUANTIZED pools (int8 or int4) for
// Hopper (sm_90a): kernel B4, decode form.
//
// Replaces: paddle_tpu/ops/kernels/paged_attention.py `_decode_kernel`
// (:370) with quant="int8"|"int4" (:401-447), launched through
// `paged_attention_decode` (:481, pallas_call at :566).
//
// What it computes, for payload pools [NB, Hkv, bs, Dp] (int8: Dp = D;
// int4: Dp = D / 2, split-half nibbles), scales [NB, Hkv] (float32, one
// per physical block and kv head), tables [B, MB] (-1 = unallocated) and
// lens [B]:
// - the last live block j_last = min(lens[b] / bs, MB - 1) of every
//   sequence is rewritten under the quantized write rule (csrc/kv_quant.cuh):
//   dequantized, the new K/V row merged at slot lens[b] - j_last * bs, the
//   rows past it zeroed, the absmax scale recomputed and the block
//   requantized; payload and scale are stored at tables[b, j_last], or in
//   the pool's last (scratch) block when that entry is -1 (whose content is
//   then block 0's);
// - the G query heads of the kv head attend positions <= lens[b] of blocks
//   0 .. j_last (skipping -1 entries), each block dequantized with its
//   scale; the rewritten block is attended from its round-tripped values,
//   as the reference does. fp32 online softmax, P kept in fp32 (the
//   quantized reference never rounds it), out = acc / max(l, 1e-30).
//
// Bound on the H100: bytes. Each live K and V row is read once as int8
// (half of B2's bf16 bytes, a quarter for int4) plus one scale per block;
// at the smoke's timing shape that is ~0.014 ms (int8) and ~0.007 ms (int4)
// at 3.35 TB/s, against ~2 operations per byte.
//
// Design (B2's, simple first; no split-K, no TMA): one CTA of 128 threads
// per (kv head, sequence).
// - Before the walk the CTA loads the last live block's K and V payload
//   into shared memory and requantizes it there (kv_requant_block: a CTA
//   absmax reduction, then the quantization in place), and writes payload
//   and scale through to the pool. The walk attends that block from the
//   shared copy, so the new token is read as its round-tripped value and
//   the CTA never reads back its own global write.
// - Earlier live blocks stream through shared memory as int8 bytes with
//   16-byte cp.async copies, double-buffered (block j+1 in flight while
//   block j is used). Thread p scores position p against every query head
//   on the unscaled grid values and multiplies by the block's K scale;
//   one warp per query head runs the online softmax; thread d accumulates
//   column d of P @ V on grid values, scaled by the block's V scale.
#include "kv_quant.cuh"
#include "paged_common.cuh"

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXBS = 128;  // block size
constexpr int PADB = 16;    // bytes of padding per shared payload row

// D: head dim; G: query heads per kv head; BITS: 8 or 4
template <int D, int G, int BITS>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_quant_kernel(const __nv_bfloat16* __restrict__ q,
                          long long q_bstride, uint8_t* k_pool,
                          uint8_t* v_pool, float* k_scale, float* v_scale,
                          const int* __restrict__ tables,
                          const int* __restrict__ lens,
                          const __nv_bfloat16* __restrict__ new_k,
                          long long nk_bstride,
                          const __nv_bfloat16* __restrict__ new_v,
                          long long nv_bstride,
                          __nv_bfloat16* __restrict__ out, int Hq, int Hkv,
                          int bs, int MB, int NB, float scale) {
  static_assert(D <= NTHREADS && MAXBS <= NTHREADS,
                "one thread per head-dim column and per block position");
  constexpr int DP = D / kv_pack_factor<BITS>();   // payload bytes per row
  constexpr int LDB = DP + PADB;                   // shared row stride
  constexpr int CH = DP / 16;                      // 16-byte chunks per row
  // [2 stages][K, V][bs][LDB], then the rewritten last block [K, V][bs][LDB]
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(16) float q_s[G][D];
  __shared__ float p_s[G][MAXBS];
  __shared__ float m_s[G], l_s[G], a_s[G];
  __shared__ float red_s[NWARPS];
  __shared__ float last_scale_s[2];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* trow = tables + (long)b * MB;
  const int L = lens[b];
  const int j_last = min(L / bs, MB - 1);
  const int slot = L - j_last * bs;
  const int phys_last = trow[j_last];
  const int src = max(phys_last, 0);
  const int tgt = phys_last < 0 ? NB - 1 : phys_last;
  const long stage = (long)2 * bs * LDB;    // bytes of one stage (K and V)
  uint8_t* lk = smem + 2 * stage;           // rewritten last block, K
  uint8_t* lv = lk + (long)bs * LDB;        //                       V

  // copy block j's live rows (K, then V) into shared stage `st`; the last
  // block is read from its rewritten shared copy instead (empty group)
  auto issue = [&](int j, int st) {
    if (j != j_last) {
      const long base = ((long)trow[j] * Hkv + kvh) * bs * DP;
      const int rows = min(bs, L - j * bs + 1);
      uint8_t* ks = smem + st * stage;
      uint8_t* vs = ks + (long)bs * LDB;
      for (int i = tid; i < rows * CH; i += NTHREADS) {
        const int r = i / CH, c = (i % CH) * 16;
        cp_async16(ks + r * LDB + c, k_pool + base + (long)r * DP + c);
        cp_async16(vs + r * LDB + c, v_pool + base + (long)r * DP + c);
      }
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
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // ---- the last live block: load, requantize in shared memory, store ----
  {
    const long base = ((long)src * Hkv + kvh) * bs * DP;
    for (int i = tid; i < bs * CH; i += NTHREADS) {
      const int r = i / CH, c = (i % CH) * 16;
      *reinterpret_cast<uint4*>(lk + r * LDB + c) =
          *reinterpret_cast<const uint4*>(k_pool + base + (long)r * DP + c);
      *reinterpret_cast<uint4*>(lv + r * LDB + c) =
          *reinterpret_cast<const uint4*>(v_pool + base + (long)r * DP + c);
    }
    const float ks_old = k_scale[(long)src * Hkv + kvh];
    const float vs_old = v_scale[(long)src * Hkv + kvh];
    __syncthreads();
    const __nv_bfloat16* nk = new_k + (long)b * nk_bstride + (long)kvh * D;
    const __nv_bfloat16* nv = new_v + (long)b * nv_bstride + (long)kvh * D;
    const float ks_new = kv_requant_block<BITS, NTHREADS>(
        lk, LDB, ks_old, bs, DP, slot + 1,
        [&](int r) { return r == slot ? nk : nullptr; }, red_s);
    const float vs_new = kv_requant_block<BITS, NTHREADS>(
        lv, LDB, vs_old, bs, DP, slot + 1,
        [&](int r) { return r == slot ? nv : nullptr; }, red_s);
    const long obase = ((long)tgt * Hkv + kvh) * bs * DP;
    for (int i = tid; i < bs * CH; i += NTHREADS) {
      const int r = i / CH, c = (i % CH) * 16;
      *reinterpret_cast<uint4*>(k_pool + obase + (long)r * DP + c) =
          *reinterpret_cast<const uint4*>(lk + r * LDB + c);
      *reinterpret_cast<uint4*>(v_pool + obase + (long)r * DP + c) =
          *reinterpret_cast<const uint4*>(lv + r * LDB + c);
    }
    if (tid == 0) {
      k_scale[(long)tgt * Hkv + kvh] = ks_new;
      v_scale[(long)tgt * Hkv + kvh] = vs_new;
      last_scale_s[0] = ks_new;
      last_scale_s[1] = vs_new;
    }
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
    __syncthreads();   // block j resident; q_s, m_s, l_s, the last block
    const bool last = (j == j_last);
    const uint8_t* ks = last ? lk : smem + st * stage;
    const uint8_t* vs = last ? lv : smem + st * stage + (long)bs * LDB;
    const long sidx = (long)trow[j] * Hkv + kvh;
    const float ksc = last ? last_scale_s[0] : k_scale[sidx];
    const float vsc = last ? last_scale_s[1] : v_scale[sidx];
    const int n_valid = min(bs, L - j * bs + 1);

    // scores: thread p scores position p against every query head on the
    // grid values, in two accumulator chains, then scales by the block's
    // K scale
    if (tid < n_valid) {
      const int p = tid;
      float part[2][G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[0][g] = part[1][g] = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(ks + p * LDB + c * 16);
        const uint8_t* by = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
        for (int h = 0; h < kv_pack_factor<BITS>(); ++h) {
          const int d0 = c * 16 + h * DP;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float sum = 0.f;
#pragma unroll
            for (int e = 0; e < 16; ++e)
              sum += q_s[g][d0 + e] * kv_grid<BITS>(by[e], h);
            part[(c + h) & 1][g] += sum;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
        p_s[g][p] = (part[0][g] + part[1][g]) * ksc;
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
        p_s[g][i] = p;
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

    // P @ V: thread d owns head-dim column d, on grid values, then the
    // block's V scale
    if (tid < D) {
      const int d = tid;
      const int col = d < DP ? d : d - DP;
      const int h = d < DP ? 0 : 1;
      float blk[G];
#pragma unroll
      for (int g = 0; g < G; ++g) blk[g] = 0.f;
#pragma unroll 4
      for (int p = 0; p < n_valid; ++p) {
        const float vv = kv_grid<BITS>(vs[p * LDB + col], h);
#pragma unroll
        for (int g = 0; g < G; ++g) blk[g] += p_s[g][p] * vv;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = acc[g] * a_s[g] + blk[g] * vsc;
    }
    __syncthreads();   // stage st and p_s are rewritten next iteration
    j = jn;
    st ^= 1;
  }
  cp_async_wait<0>();

  if (tid < D) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      out[((long)b * Hq + kvh * G + g) * D + tid] =
          __float2bfloat16_rn(acc[g] / fmaxf(l_s[g], 1e-30f));
  }
}

template <int D, int G, int BITS>
int launch(dim3 grid, cudaStream_t s, const __nv_bfloat16* q,
           long long q_bstride, uint8_t* k_pool, uint8_t* v_pool,
           float* k_scale, float* v_scale, const int* tables, const int* lens,
           const __nv_bfloat16* new_k, long long nk_bstride,
           const __nv_bfloat16* new_v, long long nv_bstride,
           __nv_bfloat16* out, int Hq, int Hkv, int bs, int MB, int NB,
           float scale) {
  constexpr int LDB = D / kv_pack_factor<BITS>() + PADB;
  const int smem = 3 * 2 * bs * LDB;   // two stages and the last block
  static int smem_allowed = 0;   // the opt-in above 48 KB, set once per size
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_quant_kernel<D, G, BITS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  paged_decode_quant_kernel<D, G, BITS><<<grid, NTHREADS, smem, s>>>(
      q, q_bstride, k_pool, v_pool, k_scale, v_scale, tables, lens, new_k,
      nk_bstride, new_v, nv_bstride, out, Hq, Hkv, bs, MB, NB, scale);
  return (int)cudaGetLastError();
}

template <int BITS>
int dispatch(const void* q, long long q_bstride, void* k_pool, void* v_pool,
             void* k_scale, void* v_scale, const void* tables,
             const void* lens, const void* new_k, long long nk_bstride,
             const void* new_v, long long nv_bstride, void* out, int B,
             int Hq, int Hkv, int D, int bs, int MB, int NB, float scale,
             void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || bs <= 0 || bs > MAXBS || MB <= 0 ||
      NB <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kp = static_cast<uint8_t*>(k_pool);
  auto* vp = static_cast<uint8_t*>(v_pool);
  auto* ksp = static_cast<float*>(k_scale);
  auto* vsp = static_cast<float*>(v_scale);
  const auto* tp = static_cast<const int*>(tables);
  const auto* lp = static_cast<const int*>(lens);
  const auto* nkp = static_cast<const __nv_bfloat16*>(new_k);
  const auto* nvp = static_cast<const __nv_bfloat16*>(new_v);
  auto* op = static_cast<__nv_bfloat16*>(out);
#define PT_LAUNCH(DD, GG)                                                    \
  if (D == DD && Hq / Hkv == GG)                                             \
    return launch<DD, GG, BITS>(grid, s, qp, q_bstride, kp, vp, ksp, vsp,    \
                                tp, lp, nkp, nk_bstride, nvp, nv_bstride, op, \
                                Hq, Hkv, bs, MB, NB, scale);
  PT_LAUNCH(128, 1) PT_LAUNCH(128, 2) PT_LAUNCH(128, 4) PT_LAUNCH(128, 8)
  PT_LAUNCH(64, 1) PT_LAUNCH(64, 2) PT_LAUNCH(64, 4) PT_LAUNCH(64, 8)
#undef PT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#define PT_ENTRY(NAME, BITS)                                                 \
  extern "C" int NAME(const void* q, long long q_bstride, void* k_pool,      \
                      void* v_pool, void* k_scale, void* v_scale,            \
                      const void* tables, const void* lens,                  \
                      const void* new_k, long long nk_bstride,               \
                      const void* new_v, long long nv_bstride, void* out,    \
                      int B, int Hq, int Hkv, int D, int bs, int MB, int NB, \
                      float scale, void* stream) {                           \
    return dispatch<BITS>(q, q_bstride, k_pool, v_pool, k_scale, v_scale,    \
                          tables, lens, new_k, nk_bstride, new_v,            \
                          nv_bstride, out, B, Hq, Hkv, D, bs, MB, NB, scale, \
                          stream);                                           \
  }
PT_ENTRY(pt_paged_attention_decode_int8, 8)
PT_ENTRY(pt_paged_attention_decode_int4, 4)
#undef PT_ENTRY

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
