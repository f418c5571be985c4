// Flash attention backward for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces: paddle_tpu/ops/kernels/flash_attention.py `_bwd_dkv_kernel`
// (:174) and `_bwd_dq_kernel` (:229), the Pallas TPU kernels launched
// through `_bwd` (:272) from the custom VJP `_flash_vjp_bwd` (:411).
//
// What it computes (FA2 backward), per (batch, q-head) with q [B, Sq, Hq, D],
// k/v [B, Sk, Hkv, D], dO like q, the forward's dropout-free
// lse [B, Hq, Sq] and delta = rowsum(dO * O) [B, Hq, Sq] (float32):
//   P  = exp(scale * Q K^T - lse)          (causal: top-left, row >= col)
//   dP = dO V^T
//   with dropout p: Z = keep ? P/(1-p) : 0 and dP = keep ? dP/(1-p) : 0,
//   keep from the reference's murmur position hash over (q-head, row, col)
//   (`keep_elem` in flash_common.cuh, the forward's own),
//   so the mask is the forward's whatever the tiling
//   dS = P * (dP - delta)
//   dV = Z^T dO,  dK = scale * dS^T Q,  dQ = scale * dS K
// GQA sums dK and dV over the Hq / Hkv q-heads of each kv head in fp32.
//
// Bound on the H100: operations. At the training shape (B=4, S=2048, H=32,
// D=128, causal) the function needs five products over the visible half,
// 5 * 2 * B*H*D * S(S+1)/2 ~ 344 GFLOP (~0.35 ms at 989 TFLOP/s bf16)
// against ~0.54 GB of q, k, v, o, dO, lse in and dq, dk, dv out (~0.16 ms
// at 3.35 TB/s). So every product runs on the tensor cores and each tile is
// read from device memory into shared memory once per use.
//
// Design (simple first, like the forward: no TMA, no wgmma, no atomics):
// - `flash_bwd_dkv_kernel`: one CTA of 4 warps per (batch, kv head, 64-row
//   kv tile). K and V stay in shared memory; the CTA walks the q tiles
//   (64 rows) of every q head of its group from the causal start
//   (kv0 / 64) and recomputes S^T and dP^T for each, 32 q columns at a
//   time, so each warp holds its 16 kv rows' dK and dV accumulators in
//   fp32 registers for the whole walk. Summing the group inside the CTA
//   needs no second pass and no atomics.
// - `flash_bwd_dq_kernel`: one CTA per (batch, q head, 64-row q tile),
//   heaviest causal tiles first; it walks the kv tiles up to the causal
//   limit, recomputes S and dP, and keeps dQ in registers.
// So the pair runs seven products where the function needs five (S and dP
// twice); a single pass with dQ summed by atomics is a later step.
// - Every product is mma.sync.m16n8k16 bf16 -> fp32. A score accumulator
//   maps register-for-register onto an A fragment, so P, Z and dS go from
//   registers straight into the next product, rounded to bf16 as FA2 does.
//   Operands needed transposed (dO and Q for dV/dK, K for dQ) are read as
//   pairs of bf16 scalars from shared memory; ldmatrix.trans is the next
//   step. Shared memory (Q, dO, K, V tiles of 64 x (D + 8) bf16: 68 KB at
//   D = 128) is dynamic, above the 48 KB static limit.
#include <math.h>

#include "flash_common.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// The A fragment (16 rows x 16 cols at column c0) of a row-major tile in
// shared memory, rows r .. r + 15 starting at this warp's row r - g.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* s,
                                       int r, int c) {
  a[0] = lds32(&s[r * LD + c]);
  a[1] = lds32(&s[(r + 8) * LD + c]);
  a[2] = lds32(&s[r * LD + c + 8]);
  a[3] = lds32(&s[(r + 8) * LD + c + 8]);
}

// The B fragment of a product whose k index runs over the rows of a
// row-major tile (rows kr, kr+1, kr+8, kr+9 at column d): the transposed
// operand, read as bf16 pairs.
template <int LD>
__device__ __forceinline__ void load_bt(uint32_t b[2], const __nv_bfloat16* s,
                                        int kr, int d) {
  b[0] = pack_raw(s[kr * LD + d], s[(kr + 1) * LD + d]);
  b[1] = pack_raw(s[(kr + 8) * LD + d], s[(kr + 9) * LD + d]);
}

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;
  const float* delta;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int Sq, Sk, Hq, Hkv, causal;
  float scale, scale_log2, inv_keep;
  uint32_t thr, seed;
};

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const Args a) {
  constexpr int LD = D + PAD;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BK * LD;
  __nv_bfloat16* Qs = Vs + BK * LD;
  __nv_bfloat16* Os = Qs + BQ * LD;            // dO tile
  float* Ls = reinterpret_cast<float*>(Os + BQ * LD);   // lse * log2(e)
  float* Dl = Ls + BQ;                                  // delta

  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / a.Hkv, hk = blockIdx.y % a.Hkv;
  const int G = a.Hq / a.Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long q_stride = (long)a.Hq * D;
  const long kv_stride = (long)a.Hkv * D;
  load_tile<D>(Ks, a.k + ((long)b * a.Sk * a.Hkv + hk) * D, kv_stride, k0,
               a.Sk);
  load_tile<D>(Vs, a.v + ((long)b * a.Sk * a.Hkv + hk) * D, kv_stride, k0,
               a.Sk);

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int wr = warp * 16 + g;          // this thread's first kv row in tile
  const int kv_row0 = k0 + wr;           // rows of c0,c1 (and +8: c2,c3)
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  const int qt0 = a.causal ? k0 / BQ : 0;

  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const int bh = b * a.Hq + h;
    const __nv_bfloat16* qb = a.q + ((long)b * a.Sq * a.Hq + h) * D;
    const __nv_bfloat16* ob = a.dout + ((long)b * a.Sq * a.Hq + h) * D;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();                   // the last tile's readers are done
      load_tile<D>(Qs, qb, q_stride, q0, a.Sq);
      load_tile<D>(Os, ob, q_stride, q0, a.Sq);
      for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
        const bool in = q0 + i < a.Sq;
        Ls[i] = in ? a.lse[(long)bh * a.Sq + q0 + i] * LOG2E : 0.f;
        Dl[i] = in ? a.delta[(long)bh * a.Sq + q0 + i] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        // S^T and dP^T for 32 q columns: [16 kv rows x 32 q] per warp
        float s[4][4], dp[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t ka[4], va[4];
          load_a<LD>(ka, Ks, wr, kk * 16 + t * 2);
          load_a<LD>(va, Vs, wr, kk * 16 + t * 2);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int qr = hf * 32 + n * 8 + g;
            uint32_t bq[2] = {lds32(&Qs[qr * LD + kk * 16 + t * 2]),
                              lds32(&Qs[qr * LD + kk * 16 + t * 2 + 8])};
            mma16816(s[n], ka, bq);
            uint32_t bo[2] = {lds32(&Os[qr * LD + kk * 16 + t * 2]),
                              lds32(&Os[qr * LD + kk * 16 + t * 2 + 8])};
            mma16816(dp[n], va, bo);
          }
        }
        // s <- Z (the weights dV uses), dp <- dS
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kv = kv_row0 + (e >> 1) * 8;
            const int qc = hf * 32 + n * 8 + t * 2 + (e & 1);
            const int qi = q0 + qc;
            const bool ok = qi < a.Sq && kv < a.Sk && (!a.causal || qi >= kv);
            const float p = ok ? exp2f(s[n][e] * a.scale_log2 - Ls[qc]) : 0.f;
            float dpv = dp[n][e];
            float z = p;
            if constexpr (DROPOUT) {
              const bool keep = keep_elem(a.seed, bh, qi, kv, a.Sq, a.Sk,
                                          a.thr);
              z = keep ? p * a.inv_keep : 0.f;
              dpv = keep ? dpv * a.inv_keep : 0.f;
            }
            s[n][e] = z;
            dp[n][e] = p * (dpv - Dl[qc]);
          }
        }
        // dV += Z^T dO and dK += dS^T Q over these 32 q rows
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t za[4] = {
              pack_bf16(s[2 * j][0], s[2 * j][1]),
              pack_bf16(s[2 * j][2], s[2 * j][3]),
              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
          const uint32_t da[4] = {
              pack_bf16(dp[2 * j][0], dp[2 * j][1]),
              pack_bf16(dp[2 * j][2], dp[2 * j][3]),
              pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]),
              pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3])};
          const int kr = hf * 32 + j * 16 + t * 2;
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            uint32_t bo[2], bq[2];
            load_bt<LD>(bo, Os, kr, n * 8 + g);
            mma16816(dv[n], za, bo);
            load_bt<LD>(bq, Qs, kr, n * 8 + g);
            mma16816(dk[n], da, bq);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kv = kv_row0 + r * 8;
    if (kv >= a.Sk) continue;
    const long off = ((long)(b * a.Sk + kv) * a.Hkv + hk) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(a.dk + off + n * 8 + t * 2) =
          pack_bf16(dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(a.dv + off + n * 8 + t * 2) =
          pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const Args a) {
  constexpr int LD = D + PAD;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Os = Qs + BQ * LD;            // dO tile
  __nv_bfloat16* Ks = Os + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int n_qt = (a.Sq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - blockIdx.x;        // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long q_stride = (long)a.Hq * D;
  const long kv_stride = (long)a.Hkv * D;
  const __nv_bfloat16* kb = a.k + ((long)b * a.Sk * a.Hkv + hk) * D;
  const __nv_bfloat16* vb = a.v + ((long)b * a.Sk * a.Hkv + hk) * D;
  load_tile<D>(Qs, a.q + ((long)b * a.Sq * a.Hq + h) * D, q_stride, q0, a.Sq);
  load_tile<D>(Os, a.dout + ((long)b * a.Sq * a.Hq + h) * D, q_stride, q0,
               a.Sq);

  const int wr = warp * 16 + g;
  const int row0 = q0 + wr;                    // rows of c0,c1 (+8: c2,c3)
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    const bool in = row < a.Sq;
    lse2[r] = in ? a.lse[(long)bh * a.Sq + row] * LOG2E : 0.f;
    dl[r] = in ? a.delta[(long)bh * a.Sq + row] : 0.f;
  }
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  int n_kt = (a.Sk + BK - 1) / BK;
  if (a.causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                           // the last tile's readers
    load_tile<D>(Ks, kb, kv_stride, k0, a.Sk);
    load_tile<D>(Vs, vb, kv_stride, k0, a.Sk);
    __syncthreads();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t qa[4], oa[4];
        load_a<LD>(qa, Qs, wr, kk * 16 + t * 2);
        load_a<LD>(oa, Os, wr, kk * 16 + t * 2);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int kr = hf * 32 + n * 8 + g;
          uint32_t bk[2] = {lds32(&Ks[kr * LD + kk * 16 + t * 2]),
                            lds32(&Ks[kr * LD + kk * 16 + t * 2 + 8])};
          mma16816(s[n], qa, bk);
          uint32_t bv[2] = {lds32(&Vs[kr * LD + kk * 16 + t * 2]),
                            lds32(&Vs[kr * LD + kk * 16 + t * 2 + 8])};
          mma16816(dp[n], oa, bv);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e >> 1) * 8;
          const int col = k0 + hf * 32 + n * 8 + t * 2 + (e & 1);
          const bool ok = row < a.Sq && col < a.Sk &&
                          (!a.causal || row >= col);
          const float p =
              ok ? exp2f(s[n][e] * a.scale_log2 - lse2[e >> 1]) : 0.f;
          float dpv = dp[n][e];
          if constexpr (DROPOUT) {
            const bool keep = keep_elem(a.seed, bh, row, col, a.Sq, a.Sk,
                                        a.thr);
            dpv = keep ? dpv * a.inv_keep : 0.f;
          }
          dp[n][e] = p * (dpv - dl[e >> 1]);
        }
      }
      // dQ += dS K over these 32 kv rows
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t da[4] = {
            pack_bf16(dp[2 * j][0], dp[2 * j][1]),
            pack_bf16(dp[2 * j][2], dp[2 * j][3]),
            pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]),
            pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3])};
        const int kr = hf * 32 + j * 16 + t * 2;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t bk[2];
          load_bt<LD>(bk, Ks, kr, n * 8 + g);
          mma16816(dq[n], da, bk);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= a.Sq) continue;
    __nv_bfloat16* dst = a.dq + ((long)(b * a.Sq + row) * a.Hq + h) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8 + t * 2) =
          pack_bf16(dq[n][2 * r] * a.scale, dq[n][2 * r + 1] * a.scale);
  }
}

template <int D>
constexpr int dkv_smem() {
  return (2 * BK + 2 * BQ) * (D + PAD) * 2 + 2 * BQ * 4;
}

template <int D>
constexpr int dq_smem() {
  return (2 * BK + 2 * BQ) * (D + PAD) * 2;
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int smem, cudaStream_t s,
                   const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, int B, bool dropout, cudaStream_t s) {
  const dim3 grid((a.Sk + BK - 1) / BK, B * a.Hkv);
  return dropout
             ? launch(flash_bwd_dkv_kernel<D, true>, grid, dkv_smem<D>(), s, a)
             : launch(flash_bwd_dkv_kernel<D, false>, grid, dkv_smem<D>(), s,
                      a);
}

template <int D>
cudaError_t launch_dq(const Args& a, int B, bool dropout, cudaStream_t s) {
  const dim3 grid((a.Sq + BQ - 1) / BQ, B * a.Hq);
  return dropout
             ? launch(flash_bwd_dq_kernel<D, true>, grid, dq_smem<D>(), s, a)
             : launch(flash_bwd_dq_kernel<D, false>, grid, dq_smem<D>(), s, a);
}

int make_args(Args* a, const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* delta, void* dq,
              void* dk, void* dv, int B, int Sq, int Sk, int Hq, int Hkv,
              int D, float scale, int causal, float dropout_p_inv_keep,
              unsigned thr, int seed) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  a->q = static_cast<const __nv_bfloat16*>(q);
  a->k = static_cast<const __nv_bfloat16*>(k);
  a->v = static_cast<const __nv_bfloat16*>(v);
  a->dout = static_cast<const __nv_bfloat16*>(dout);
  a->lse = static_cast<const float*>(lse);
  a->delta = static_cast<const float*>(delta);
  a->dq = static_cast<__nv_bfloat16*>(dq);
  a->dk = static_cast<__nv_bfloat16*>(dk);
  a->dv = static_cast<__nv_bfloat16*>(dv);
  a->Sq = Sq;
  a->Sk = Sk;
  a->Hq = Hq;
  a->Hkv = Hkv;
  a->causal = causal;
  a->scale = scale;
  a->scale_log2 = scale * LOG2E;
  a->inv_keep = dropout_p_inv_keep;
  a->thr = thr;
  a->seed = (uint32_t)seed;
  return 0;
}

}  // namespace

// dK, dV of one backward. `dropout` selects the masked form; `thr` is
// int(p * 2^31) and `inv_keep` is float32(1 / (1 - p)).
extern "C" int pt_flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, float scale, int causal, int dropout,
    unsigned thr, float inv_keep, int seed, void* stream) {
  Args a;
  int bad = make_args(&a, q, k, v, dout, lse, delta, nullptr, dk, dv, B, Sq,
                      Sk, Hq, Hkv, D, scale, causal, inv_keep, thr, seed);
  if (bad) return bad;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(D == 128 ? launch_dkv<128>(a, B, dropout != 0, s)
                        : launch_dkv<64>(a, B, dropout != 0, s));
}

// dQ of one backward, same arguments.
extern "C" int pt_flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int Sq, int Sk,
    int Hq, int Hkv, int D, float scale, int causal, int dropout,
    unsigned thr, float inv_keep, int seed, void* stream) {
  Args a;
  int bad = make_args(&a, q, k, v, dout, lse, delta, dq, nullptr, nullptr, B,
                      Sq, Sk, Hq, Hkv, D, scale, causal, inv_keep, thr, seed);
  if (bad) return bad;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(D == 128 ? launch_dq<128>(a, B, dropout != 0, s)
                        : launch_dq<64>(a, B, dropout != 0, s));
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
