// Flash attention forward for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces: paddle_tpu/ops/kernels/flash_attention.py `_fwd_kernel` (:87),
// the Pallas TPU kernel launched through `flash_attention_fwd` (:376).
//
// What it computes: per (batch, q-head), online-softmax attention of q
// [B, Sq, Hq, D] over k/v [B, Sk, Hkv, D] (Paddle layout, no transpose),
// GQA by mapping q head h onto kv head h / (Hq / Hkv), optional causal mask
// aligned TOP-LEFT (row >= col, as the reference kernel masks), any Sq/Sk
// (the ragged edge is masked here, the reference needed block multiples).
// Writes out [B, Sq, Hq, D] bf16 and lse [B, Hq, Sq] fp32 with
// lse = m + log(max(l, 1e-30)) and out = acc / max(l, 1e-30).
// Optional dropout p, in the kernel as in the reference: l sums the
// unmasked probabilities (lse stays dropout-free for the backward), and P
// is masked and scaled by 1/(1-p) before P V. The mask is the reference's
// murmur position hash `_keep_mask` (:48) of (q-head, row, col) and an
// int32 seed, bit for bit (`keep_elem` in flash_common.cuh, shared with
// flash_attention_bwd.cu, which rebuilds the mask); the
// dropout-free form is a separate instantiation, untouched by it.
//
// Bound on the H100: operations. At the smoke shape (B=2, S=2048, H=32,
// D=128, causal) the work is 4*B*H*S^2*D/2 ~ 68.7 GFLOP against ~0.1 GB of
// q/k/v/out traffic, ~0.07 ms at 989 TFLOP/s bf16 — so the products must
// run on the tensor cores and K/V must be read from shared memory, not
// device memory, once per tile.
//
// Design (simple first; no TMA or wgmma yet):
// - one CTA = 4 warps = one (b*Hq + h, 64-row q tile); each warp owns 16
//   query rows and keeps them as bf16 mma A-fragments in registers;
// - the CTA walks 64-row K/V tiles staged in shared memory (2 x 17 KB with
//   16-byte row padding against bank conflicts) and stops at the last tile
//   the causal rule needs; causal q tiles are scheduled heaviest first;
// - S = Q K^T and O += P V both run as mma.sync.m16n8k16 bf16 -> fp32; the
//   S accumulator maps register-for-register onto the P A-fragment, so P
//   never leaves registers; m and l stay in fp32 registers per row.
#include <math.h>

#include "flash_common.cuh"

namespace {

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int Sq, int Sk, int Hq, int Hkv, float scale_log2,
                 int causal, uint32_t thr, float inv_keep, uint32_t seed) {
  constexpr int LD = D + PAD;
  constexpr int KD = D / 16;   // k-steps over the head dim
  constexpr int ND = D / 8;    // n8 tiles of the output row
  constexpr int NS = BK / 8;   // n8 tiles of one score tile
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BK * LD];

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - blockIdx.x;   // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long q_stride = (long)Hq * D;
  const long kv_stride = (long)Hkv * D;
  const __nv_bfloat16* qb = q + ((long)b * Sq * Hq + h) * D;
  const __nv_bfloat16* kb = k + ((long)b * Sk * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + ((long)b * Sk * Hkv + hk) * D;

  // stage the Q tile through Ks; each warp keeps its 16 rows as A fragments
  load_tile<D>(Ks, qb, q_stride, q0, Sq);
  __syncthreads();
  uint32_t qa[KD][4];
  {
    const int r = warp * 16 + g;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int c = kk * 16 + t * 2;
      qa[kk][0] = lds32(&Ks[r * LD + c]);
      qa[kk][1] = lds32(&Ks[(r + 8) * LD + c]);
      qa[kk][2] = lds32(&Ks[r * LD + c + 8]);
      qa[kk][3] = lds32(&Ks[(r + 8) * LD + c + 8]);
    }
  }
  __syncthreads();

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};   // per-thread partial row sums, reduced at the end
  const int row0 = q0 + warp * 16 + g;   // rows of c0,c1 (and +8: c2,c3)

  int n_kt = (Sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    load_tile<D>(Ks, kb, kv_stride, k0, Sk);
    load_tile<D>(Vs, vb, kv_stride, k0, Sk);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const __nv_bfloat16* kr = &Ks[(n * 8 + g) * LD + kk * 16 + t * 2];
        uint32_t bf[2] = {lds32(kr), lds32(kr + 8)};
        mma16816(s[n], qa[kk], bf);
      }
    }

    // mask, then the online-softmax update in log2 units
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + t * 2 + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        const bool ok = col < Sk && (!causal || col <= row);
        s[n][e] = ok ? s[n][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float msub[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      msub[r] = (mx[r] == -INFINITY) ? 0.f : mx[r];
      alpha[r] = exp2f(m[r] - msub[r]);   // m = -inf -> 0 (o and l are 0)
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - msub[e >> 1]);
        l[e >> 1] += s[n][e];
        if constexpr (DROPOUT) {
          const bool keep = keep_elem(seed, bh, row0 + (e >> 1) * 8,
                                      k0 + n * 8 + t * 2 + (e & 1), Sq, Sk,
                                      thr);
          s[n][e] = keep ? s[n][e] * inv_keep : 0.f;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }

    // O += P V: the score accumulators of n-tiles 2j, 2j+1 are exactly
    // the A fragment of P's 16-key slice j
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                        pack_bf16(s[2 * j][2], s[2 * j][3]),
                        pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                        pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const int key = j * 16 + t * 2;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int d = n * 8 + g;
        uint32_t bv[2] = {
            pack_raw(Vs[key * LD + d], Vs[(key + 1) * LD + d]),
            pack_raw(Vs[(key + 8) * LD + d], Vs[(key + 9) * LD + d])};
        mma16816(o[n], pa, bv);
      }
    }
    __syncthreads();   // the next tile overwrites Ks/Vs
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / lc;
    __nv_bfloat16* orow = out + ((long)(b * Sq + row) * Hq + h) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t * 2) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
    if (t == 0) lse[(long)bh * Sq + row] = m[r] * 0.6931471805599453f + logf(lc);
  }
}

template <int D>
cudaError_t launch(dim3 grid, cudaStream_t s, const __nv_bfloat16* q,
                   const __nv_bfloat16* k, const __nv_bfloat16* v,
                   __nv_bfloat16* out, float* lse, int Sq, int Sk, int Hq,
                   int Hkv, float scale_log2, int causal, int dropout,
                   uint32_t thr, float inv_keep, uint32_t seed) {
  if (dropout)
    flash_fwd_kernel<D, true><<<grid, NTHREADS, 0, s>>>(
        q, k, v, out, lse, Sq, Sk, Hq, Hkv, scale_log2, causal, thr,
        inv_keep, seed);
  else
    flash_fwd_kernel<D, false><<<grid, NTHREADS, 0, s>>>(
        q, k, v, out, lse, Sq, Sk, Hq, Hkv, scale_log2, causal, thr,
        inv_keep, seed);
  return cudaGetLastError();
}

}  // namespace

// `dropout` selects the masked form; `thr` is int(p * 2^31), `inv_keep` is
// float32(1 / (1 - p)) and `seed` carries the reference's seed bits.
extern "C" int pt_flash_attention_fwd_bf16(const void* q, const void* k,
                                           const void* v, void* out,
                                           void* lse, int B, int Sq, int Sk,
                                           int Hq, int Hkv, int D, float scale,
                                           int causal, int dropout,
                                           unsigned thr, float inv_keep,
                                           int seed, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* lp = static_cast<float*>(lse);
  if (D == 128)
    return (int)launch<128>(grid, s, qp, kp, vp, op, lp, Sq, Sk, Hq, Hkv,
                            scale_log2, causal, dropout, thr, inv_keep,
                            (uint32_t)seed);
  if (D == 64)
    return (int)launch<64>(grid, s, qp, kp, vp, op, lp, Sq, Sk, Hq, Hkv,
                           scale_log2, causal, dropout, thr, inv_keep,
                           (uint32_t)seed);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
