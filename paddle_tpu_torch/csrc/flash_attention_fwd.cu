// Flash attention forward for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces: paddle_tpu/ops/kernels/flash_attention.py `_fwd_kernel` (:87),
// the Pallas TPU kernel launched through `flash_attention_fwd` (:376).
//
// What it computes: per (batch, q-head), online-softmax attention of q
// [B, Sq, Hq, D] over k/v [B, Sk, Hkv, D] (Paddle layout, no transpose),
// GQA by mapping q head h onto kv head h / (Hq / Hkv), optional causal mask
// aligned TOP-LEFT (row >= col, as the reference kernel masks), any Sq/Sk
// (the ragged edge is masked here, the reference needed block multiples),
// D = 64 or 128. Writes out [B, Sq, Hq, D] bf16 and lse [B, Hq, Sq] fp32
// with lse = m + log(max(l, 1e-30)) and out = acc / max(l, 1e-30).
// Optional dropout p, in the kernel as in the reference: l sums the
// unmasked probabilities (lse stays dropout-free for the backward), and P
// is masked and scaled by 1/(1-p) before P V. The mask is the reference's
// murmur position hash `_keep_mask` (:48) of (q-head, row, col) and an
// int32 seed, bit for bit (`keep_elem` in flash_common.cuh, shared with
// flash_attention_bwd.cu, which rebuilds the mask); the dropout-free form
// is a separate instantiation, untouched by it.
//
// Bound on the H100: operations. At the smoke shape (B=2, S=2048, H=32,
// D=128, causal) the work is 4*B*H*D * S(S+1)/2 ~ 68.7 GFLOP against
// ~0.13 GB of q/k/v/out/lse traffic: ~0.07 ms at 989 TFLOP/s bf16 against
// ~0.04 ms at 3.35 TB/s. So the products must keep the tensor cores busy,
// and only wgmma reaches their full rate.
//
// Design (warp-specialised, after FlashAttention-3's forward):
// - one CTA = 3 warpgroups (384 threads) = one (b*Hq + h, 128-row q tile).
//   Heads go in groups of 16 (the q heads of one kv head stay together);
//   inside a group the q tiles launch heaviest first across all its heads,
//   so the longest causal CTAs start early and the light ones fill the
//   tail, while a group's K/V (16 MB at S = 2048, D = 128) stay in L2.
// - warpgroup 0 is the producer: it gives up its registers (setmaxnreg 24)
//   and one thread issues TMA loads: the Q tile once, then 128-row K and V
//   tiles through a 2-stage ring in shared memory. Each stage has a full
//   and an empty mbarrier for K and for V, so a K tile is released as soon
//   as its S product is done and the next K load starts a whole P V
//   product earlier. Loads run ahead of the math: the tensor cores never
//   wait for a synchronous copy. Rank-4 tensor maps (D, H, S, B) zero-fill
//   rows past S inside each batch entry: the ragged edge costs only a
//   column mask.
// - warpgroups 1 and 2 are consumers (setmaxnreg 240), 64 query rows each.
//   S = Q K^T is wgmma m64n128k16 with Q and K both read from shared memory
//   (K-major descriptors, 128-byte swizzle). The accumulator gives thread
//   (warp w, lane 4g + t) rows 16w + g and + 8 and columns 8j + 2t, + 1:
//   the mma.sync pattern, so the causal and ragged masks (only on the
//   diagonal and ragged tiles) and the dropout hash work on it as they
//   did. The online softmax runs in fp32 registers in log2 units, the
//   scale folded into the exponent's FMA; row statistics reduce over the
//   4 threads of a quad.
// - O += P V is wgmma m64nDk16 with A = P from registers (the S
//   accumulators of n-tiles 2j, 2j+1, packed to bf16, are P's k-slice j)
//   and B = V read in place through the MN-major (transposed) descriptor:
//   V is never transposed in memory.
// - within a consumer, tile kt issues S_kt and then O += P_{kt-1} V_{kt-1}
//   and runs the softmax of S_kt while the P V product is in flight
//   (FlashAttention-3's intra-warpgroup overlap); O is rescaled once that
//   product is waited on. The two consumers take turns to issue their
//   products (ping-pong on two named barriers), so one warpgroup's
//   softmax runs under the other's products.
// - epilogue: O / max(l, 1e-30) goes to bf16 in the warpgroup's own rows of
//   the Q tile (free once its last S product is done), then out in 16-byte
//   coalesced stores masked at Sq; lse is written masked at Sq.
// Shared memory: Q 32 KB + 2 x (K 32 KB + V 32 KB) at D = 128 (half at
// D = 64), dynamic. `fwd_launch_config` in ops/kernels/flash_attention.py
// states the same geometry; `pt_flash_attention_fwd_check_launch` holds
// the wrapper's numbers against the constants here.
#include <math.h>

#include <algorithm>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int FWD_BQ = 128;       // q rows per CTA: two consumers x 64
constexpr int FWD_BK = 128;       // kv rows per ring stage
constexpr int FWD_STAGES = 2;
constexpr int FWD_THREADS = 384;  // producer + two consumer warpgroups
constexpr int ROW_BYTES = 128;    // one 64-column block of a tile row
constexpr float LN2 = 0.6931471805599453f;

// Byte offsets of the dynamic shared memory, from its 1024-byte-aligned
// start; the first 1024 bytes of the allocation are alignment slack.
template <int D>
struct FwdSmem {
  static constexpr int kTileQ = FWD_BQ * D * 2;
  static constexpr int kTileKV = FWD_BK * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kKV = kTileQ;  // stage s: K at + 2s kTileKV, V after
  static constexpr int kBars = kTileQ + FWD_STAGES * 2 * kTileKV;
  // Q full; per stage K full, V full, K empty, V empty
  static constexpr int kNumBars = 1 + 4 * FWD_STAGES;
  static constexpr int kBytes = 1024 + kBars + 8 * kNumBars;
};

// The ring's mbarriers, 8 bytes each after the Q barrier at `bars`.
__device__ __forceinline__ uint32_t full_k(uint32_t bars, int s) {
  return bars + 8 * (1 + s);
}
__device__ __forceinline__ uint32_t full_v(uint32_t bars, int s) {
  return bars + 8 * (1 + FWD_STAGES + s);
}
__device__ __forceinline__ uint32_t empty_k(uint32_t bars, int s) {
  return bars + 8 * (1 + 2 * FWD_STAGES + s);
}
__device__ __forceinline__ uint32_t empty_v(uint32_t bars, int s) {
  return bars + 8 * (1 + 3 * FWD_STAGES + s);
}

// S = Q K^T for this warpgroup's 64 rows and a 128-row K tile; issued,
// not committed. k-step kk reads 16 columns: block kk / 4, bytes
// 32 (kk % 4) into each 128-byte row.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[FWD_BK / 2],
                                         uint32_t sQc, uint32_t sK) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n128k16_ss(
        sc,
        smem_desc(sQc + (kk / 4) * FWD_BQ * ROW_BYTES + (kk % 4) * 32, 16,
                  1024),
        smem_desc(sK + (kk / 4) * FWD_BK * ROW_BYTES + (kk % 4) * 32, 16,
                  1024),
        kk > 0);
}

// O += P V over a 128-row V tile; issued, not committed. Slice j takes
// P's k-slice j and V's rows 16j.. (2048 bytes on), MN-major: the
// 64-column blocks of D are FWD_BK rows apart.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[FWD_BK / 16][4],
                                         uint32_t sV) {
#pragma unroll
  for (int j = 0; j < FWD_BK / 16; ++j) {
    const uint64_t desc =
        smem_desc(sV + j * 16 * ROW_BYTES, FWD_BK * ROW_BYTES, 1024);
    if constexpr (D == 128)
      wgmma_m64n128k16_rs_mn(o, pa[j], desc, 1);
    else
      wgmma_m64n64k16_rs_mn(o, pa[j], desc, 1);
  }
}

// The online-softmax step of one score tile, in place: masks (on the
// diagonal and ragged tiles only), the running max m (log2 units, scaled),
// the per-thread partial sums l, the probabilities (dropped and rescaled
// with DROPOUT; l sums them before the drop), and alpha, the factor that
// carries O over to the new max.
template <bool DROPOUT>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[FWD_BK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int k0, int row0, int t, int Sq, int Sk, int causal, bool edge,
    float scale_log2, uint32_t bh, uint32_t thr, float inv_keep,
    uint32_t seed) {
  float mx[2] = {-INFINITY, -INFINITY};   // raw scores: scale > 0
#pragma unroll
  for (int j = 0; j < FWD_BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (edge) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        if (col >= Sk || (causal && col > row)) sc[4 * j + e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    }
  }
  float msub[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mnew = fmaxf(m[r], mx[r] * scale_log2);
    msub[r] = (mnew == -INFINITY) ? 0.f : mnew;
    alpha[r] = fast_exp2(m[r] - msub[r]);   // m = -inf -> 0 (o, l are 0)
    m[r] = mnew;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < FWD_BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = fast_exp2(fmaf(sc[4 * j + e], scale_log2, -msub[e >> 1]));
      l[e >> 1] += p;
      if constexpr (DROPOUT) {
        const bool keep = keep_elem(seed, bh, row0 + (e >> 1) * 8,
                                    k0 + 8 * j + 2 * t + (e & 1), Sq, Sk,
                                    thr);
        p = keep ? p * inv_keep : 0.f;
      }
      sc[4 * j + e] = p;
    }
  }
}

// P as the bf16 A operand: the S accumulators of n-tiles 2j, 2j+1 are
// P's k-slice j, register for register.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[FWD_BK / 16][4],
                                       const float (&sc)[FWD_BK / 2]) {
#pragma unroll
  for (int j = 0; j < FWD_BK / 16; ++j) {
    pa[j][0] = pack_bf16(sc[8 * j + 0], sc[8 * j + 1]);
    pa[j][1] = pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
    pa[j][2] = pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
    pa[j][3] = pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
  }
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int Sq, int Sk, int Hq, int Hkv, float scale_log2,
                 int causal, uint32_t thr, float inv_keep, uint32_t seed) {
  using L = FwdSmem<D>;
  constexpr int DB = D / 64;          // 64-column blocks per row
  constexpr int NO = D / 2;           // O accumulators per thread
  constexpr int NS = FWD_BK / 2;      // S accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (sbase - raw);
  const uint32_t sQ = sbase + L::kQ;
  const uint32_t bars = sbase + L::kBars;   // the Q barrier, then the ring's
  const uint32_t sKV = sbase + L::kKV;      // stage s: K, then V

  const int n_qt = (Sq + FWD_BQ - 1) / FWD_BQ;
  int bh, qt;
  // heaviest q tile (the last) first, in groups of heads (the note says why)
  group_tile(blockIdx.y * n_qt + blockIdx.x, n_qt, gridDim.y, true, bh, qt);
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * FWD_BQ;
  int n_kt = (Sk + FWD_BK - 1) / FWD_BK;
  if (causal) n_kt = min(n_kt, (q0 + FWD_BQ + FWD_BK - 1) / FWD_BK);

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(full_k(bars, s), 1);
      mbar_init(full_v(bars, s), 1);
      mbar_init(empty_k(bars, s), 8);   // one arrive per consumer warp
      mbar_init(empty_v(bars, s), 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: K tile kt waits for the S product of tile kt - 2 to
    // release its stage, V tile kt for the P V product of tile kt - 2 ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      mbar_arrive_expect_tx(bars, L::kTileQ);
      for (int db = 0; db < DB; ++db)
        tma_load_4d(sQ + db * FWD_BQ * ROW_BYTES, &tm_q, bars, db * 64, h,
                    q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % FWD_STAGES;
        const uint32_t free_phase = ((kt / FWD_STAGES) & 1) ^ 1;
        const uint32_t sK = sKV + 2 * s * L::kTileKV;
        const uint32_t sV = sK + L::kTileKV;
        mbar_wait(empty_k(bars, s), free_phase);
        mbar_arrive_expect_tx(full_k(bars, s), L::kTileKV);
        for (int db = 0; db < DB; ++db)
          tma_load_4d(sK + db * FWD_BK * ROW_BYTES, &tm_k, full_k(bars, s),
                      db * 64, hk, kt * FWD_BK, b);
        mbar_wait(empty_v(bars, s), free_phase);
        mbar_arrive_expect_tx(full_v(bars, s), L::kTileKV);
        for (int db = 0; db < DB; ++db)
          tma_load_4d(sV + db * FWD_BK * ROW_BYTES, &tm_v, full_v(bars, s),
                      db * 64, hk, kt * FWD_BK, b);
      }
    }
  } else {
    // ---- consumers ----
    setmaxnreg_inc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x & 127;
    const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int rbase = q0 + 64 * c;            // this warpgroup's first row
    const int row0 = rbase + 16 * w + g;      // rows of e = 0, 1 (+8: 2, 3)
    const uint32_t sQc = sQ + 64 * c * ROW_BYTES;
    // diagonal or ragged: the tile needs the per-element mask
    auto edge = [&](int k0) {
      return k0 + FWD_BK > Sk || (causal && k0 + FWD_BK - 1 > rbase);
    };

    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float sc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};   // per-thread partial row sums, reduced at the end
    float alpha[2];
    uint32_t pa[FWD_BK / 16][4];

    // The consumers take turns to issue their products (named barriers
    // 3 + c, FlashAttention-3's ping-pong): one warpgroup's softmax runs
    // under the other's products. Warpgroup 0 has the first turn; each
    // turn ends by handing the next to the other warpgroup, except the
    // last one of warpgroup 1, which nobody waits for.
    const int my_turn = 3 + c, their_turn = 4 - c;
    if (c == 0) named_barrier_arrive(my_turn, 256);

    // tile 0: S, softmax, P (O is still zero)
    mbar_wait(bars, 0);
    mbar_wait(full_k(bars, 0), 0);
    named_barrier_sync(my_turn, 256);
    wgmma_fence();
    fence_regs(sc);
    issue_qk<D>(sc, sQc, sKV);
    wgmma_commit();
    named_barrier_arrive(their_turn, 256);
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(empty_k(bars, 0));
    softmax_tile<DROPOUT>(sc, m, l, alpha, 0, row0, t, Sq, Sk, causal,
                          edge(0), scale_log2, bh, thr, inv_keep, seed);
    pack_p(pa, sc);

    // tile kt: issue S_kt and O += P_{kt-1} V_{kt-1}; the softmax of S_kt
    // runs while the P V product is in flight
    for (int kt = 1; kt < n_kt; ++kt) {
      const int s = kt % FWD_STAGES, sp = (kt - 1) % FWD_STAGES;
      const uint32_t sK = sKV + 2 * s * L::kTileKV;
      const uint32_t sVp = sKV + 2 * sp * L::kTileKV + L::kTileKV;
      const int k0 = kt * FWD_BK;
      mbar_wait(full_k(bars, s), (kt / FWD_STAGES) & 1);
      mbar_wait(full_v(bars, sp), ((kt - 1) / FWD_STAGES) & 1);
      named_barrier_sync(my_turn, 256);
      wgmma_fence();
      fence_regs(sc);
      fence_regs(o);
      issue_qk<D>(sc, sQc, sK);
      wgmma_commit();
      issue_pv<D>(o, pa, sVp);
      wgmma_commit();
      named_barrier_arrive(their_turn, 256);
      wgmma_wait<1>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(empty_k(bars, s));
      softmax_tile<DROPOUT>(sc, m, l, alpha, k0, row0, t, Sq, Sk, causal,
                            edge(k0), scale_log2, bh, thr, inv_keep, seed);
      wgmma_wait<0>();
      fence_regs(o);
      fence_pack(pa);
      if (lane == 0) mbar_arrive(empty_v(bars, sp));
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n + 0] *= alpha[0]; o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1]; o[4 * n + 3] *= alpha[1];
      }
      pack_p(pa, sc);
    }
    {
      const int sl = (n_kt - 1) % FWD_STAGES;
      mbar_wait(full_v(bars, sl), ((n_kt - 1) / FWD_STAGES) & 1);
      named_barrier_sync(my_turn, 256);
      wgmma_fence();
      fence_regs(o);
      issue_pv<D>(o, pa, sKV + 2 * sl * L::kTileKV + L::kTileKV);
      wgmma_commit();
      if (c == 0) named_barrier_arrive(their_turn, 256);
      wgmma_wait<0>();
      fence_regs(o);
      fence_pack(pa);
    }

    float lc[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      lc[r] = fmaxf(l[r], 1e-30f);
      inv[r] = 1.f / lc[r];
    }
    // bf16 O into this warpgroup's rows of the Q tile, in the tile's own
    // swizzled layout (16-byte chunk k of row r at chunk k ^ (r & 7)), so
    // the writes and the reads below are free of bank conflicts
    uint8_t* const oQ = gbase + (sQc - sbase);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rl = 16 * w + g + 8 * r;
        uint8_t* p = oQ + (j / 8) * FWD_BQ * ROW_BYTES + rl * ROW_BYTES +
                     (((j % 8) ^ (rl & 7)) * 16) + 4 * t;
        *reinterpret_cast<uint32_t*>(p) =
            pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
      }
    }
    named_barrier_sync(1 + c, 128);
    constexpr int CH = D / 8;   // 16-byte chunks per output row
    for (int i = tid; i < 64 * CH; i += 128) {
      const int rl = i / CH, cc = i % CH;
      const int row = rbase + rl;
      if (row < Sq) {
        const uint4 val = *reinterpret_cast<const uint4*>(
            oQ + (cc / 8) * FWD_BQ * ROW_BYTES + rl * ROW_BYTES +
            (((cc % 8) ^ (rl & 7)) * 16));
        *reinterpret_cast<uint4*>(out + ((long)(b * Sq + row) * Hq + h) * D +
                                  cc * 8) = val;
      }
    }
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < Sq) lse[(long)bh * Sq + row] = m[r] * LN2 + logf(lc[r]);
      }
    }
  }
}

template <int D, bool DROPOUT>
cudaError_t launch(dim3 grid, cudaStream_t s, const CUtensorMap& tq,
                   const CUtensorMap& tk, const CUtensorMap& tv,
                   __nv_bfloat16* out, float* lse, int Sq, int Sk, int Hq,
                   int Hkv, float scale_log2, int causal, uint32_t thr,
                   float inv_keep, uint32_t seed) {
  constexpr int smem = FwdSmem<D>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D, DROPOUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  flash_fwd_kernel<D, DROPOUT><<<grid, FWD_THREADS, smem, s>>>(
      tq, tk, tv, out, lse, Sq, Sk, Hq, Hkv, scale_log2, causal, thr,
      inv_keep, seed);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(dim3 grid, cudaStream_t s, const CUtensorMap& tq,
                     const CUtensorMap& tk, const CUtensorMap& tv,
                     __nv_bfloat16* out, float* lse, int Sq, int Sk, int Hq,
                     int Hkv, float scale_log2, int causal, int dropout,
                     uint32_t thr, float inv_keep, uint32_t seed) {
  if (dropout)
    return launch<D, true>(grid, s, tq, tk, tv, out, lse, Sq, Sk, Hq, Hkv,
                           scale_log2, causal, thr, inv_keep, seed);
  return launch<D, false>(grid, s, tq, tk, tv, out, lse, Sq, Sk, Hq, Hkv,
                          scale_log2, causal, thr, inv_keep, seed);
}

int kv_tiles(int qt, int Sk, int causal) {
  const int n = (Sk + FWD_BK - 1) / FWD_BK;
  return causal ? std::min(n, (qt * FWD_BQ + FWD_BQ + FWD_BK - 1) / FWD_BK)
                : n;
}

}  // namespace

// The wrapper's launch geometry (`fwd_launch_config`) against this
// kernel's: 0 if every number matches, else cudaErrorInvalidValue.
extern "C" int pt_flash_attention_fwd_check_launch(
    int B, int Sq, int Sk, int Hq, int D, int causal, int block_q,
    int block_k, int stages, int threads, int smem_bytes, int grid_x,
    int grid_y, int head_group, int heavy_kv_tiles) {
  const int n_qt = (Sq + FWD_BQ - 1) / FWD_BQ;
  const int smem = D == 128 ? FwdSmem<128>::kBytes
                            : D == 64 ? FwdSmem<64>::kBytes : -1;
  const bool ok = block_q == FWD_BQ && block_k == FWD_BK &&
                  stages == FWD_STAGES && threads == FWD_THREADS &&
                  smem_bytes == smem && grid_x == n_qt && grid_y == B * Hq &&
                  head_group == HEAD_GROUP &&
                  heavy_kv_tiles == kv_tiles(n_qt - 1, Sk, causal);
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// `dropout` selects the masked form; `thr` is int(p * 2^31), `inv_keep` is
// float32(1 / (1 - p)) and `seed` carries the reference's seed bits. The
// tensor maps are encoded here, per call.
extern "C" int pt_flash_attention_fwd_bf16(const void* q, const void* k,
                                           const void* v, void* out,
                                           void* lse, int B, int Sq, int Sk,
                                           int Hq, int Hkv, int D, float scale,
                                           int causal, int dropout,
                                           unsigned thr, float inv_keep,
                                           int seed, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv ||
      (D != 64 && D != 128) ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
          16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!bshd_tensor_map(&tq, q, B, Sq, Hq, D, FWD_BQ) ||
      !bshd_tensor_map(&tk, k, B, Sk, Hkv, D, FWD_BK) ||
      !bshd_tensor_map(&tv, v, B, Sk, Hkv, D, FWD_BK))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + FWD_BQ - 1) / FWD_BQ, B * Hq);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* lp = static_cast<float*>(lse);
  if (D == 128)
    return (int)launch_d<128>(grid, s, tq, tk, tv, op, lp, Sq, Sk, Hq, Hkv,
                              scale_log2, causal, dropout, thr, inv_keep,
                              (uint32_t)seed);
  return (int)launch_d<64>(grid, s, tq, tk, tv, op, lp, Sq, Sk, Hq, Hkv,
                           scale_log2, causal, dropout, thr, inv_keep,
                           (uint32_t)seed);
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
