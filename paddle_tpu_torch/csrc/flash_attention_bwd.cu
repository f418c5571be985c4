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
// at 3.35 TB/s). So every product runs on the tensor cores through wgmma,
// the only way to their full rate, and operands arrive by TMA ahead of the
// math.
//
// Design: the reference's two kernels, each warp-specialised like the
// forward (flash_attention_fwd.cu), on sm90_common.cuh. Seven products
// where the function needs five (S and dP are computed in both kernels),
// but no atomics: every sum runs in one fixed order, so two runs give the
// same bits (training's recompute gate compares grads bit for bit).
// - `flash_bwd_dkv_kernel`: one CTA = 3 warpgroups = one (batch, kv head,
//   128-row kv tile). Warpgroup 0 is the producer (setmaxnreg 24): one
//   thread loads K and V once by TMA, then streams 64-row Q and dO tiles
//   through a 2-stage mbarrier ring, for every q head of the GQA group from
//   the causal start (kv0 / 64) to the end; one warp loads each tile's 64
//   lse (times log2 e) and delta values with plain loads beside it (their
//   rows are Sq * 4 bytes apart, which TMA refuses for a ragged Sq), rows
//   at or past Sq as lse = +inf, so their P is 0 with no mask. Warpgroups 1
//   and 2 are consumers (setmaxnreg 240), 64 kv rows each, and hold dK and
//   dV in fp32 registers for the whole walk (64 + 64 a thread at D = 128,
//   so the q tile is 64 rows: S^T and dP^T take 32 + 32). Per q tile:
//   S^T = K Q^T and dP^T = V dO^T as wgmma m64n64k16 SS (both K-major);
//   P^T (and Z^T) in registers, where the accumulator's rows are kv
//   positions and its columns q positions, so the causal mask (on the
//   diagonal tile only) and keep_elem take the indices swapped back (the
//   thread's 32 keep bits are hashed while S^T and dP^T run);
//   dV += Z^T dO is issued as wgmma RS with dO read MN-major in place (the
//   forward's P V form) and, without dropout, runs while dS^T is computed;
//   then dK += dS^T Q, RS with Q MN-major. A consumer skips a q tile whose
//   every pair lies above the diagonal. The group's heads are summed inside
//   the CTA: no second pass.
// - `flash_bwd_dq_kernel`: one CTA per (batch, q head, 128-row q tile),
//   heaviest causal tiles first in groups of 16 heads (the forward's
//   order). Q, dO load once; the producer streams 128-row K and V tiles
//   through a 2-stage ring (K and V each with their own full and empty
//   barriers) up to the causal limit. Each consumer owns 64 q rows: S =
//   Q K^T and dP = dO V^T as m64n128k16 SS, dS in registers, dQ += dS K as
//   RS with K MN-major; V is released as soon as dP is done. Rows that TMA
//   zero-fills past Sk have K = V = 0, so they add nothing to dQ; only the
//   diagonal tile takes the causal mask. dQ is scaled once at the end, as
//   the reference scales it (:269).
// - in both kernels the two consumers take turns to issue their first two
//   products (S^T and dP^T, or S and dP; the forward's ping-pong on named
//   barriers), so one warpgroup's elementwise work runs under the other's
//   products instead of both idling the tensor cores at once.
// - epilogues: the scaled bf16 rows go into the warpgroup's own rows of a
//   tile it no longer reads (K and V for dK/dV, Q for dQ), in the tile's
//   swizzled layout, then out in 16-byte coalesced stores masked at S.
// Shared memory at D = 128 (dynamic, half the tiles at D = 64): dK/dV
// K 32 KB + V 32 KB + 2 x (Q 16 KB + dO 16 KB + 512 B of lse and delta);
// dQ Q 32 KB + dO 32 KB + 2 x (K 32 KB + V 32 KB). `bwd_launch_config` in
// ops/kernels/flash_attention.py states the same geometry;
// `pt_flash_attention_bwd_check_launch` holds it against the constants here.
#include <math.h>

#include <algorithm>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int BWD_THREADS = 384;  // producer + two consumer warpgroups
constexpr int DKV_STAGES = 2;     // dK/dV: Q/dO ring stages
constexpr int DQ_STAGES = 2;      // dQ: K/V ring stages
constexpr int ROW_BYTES = 128;    // one 64-column block of a tile row
constexpr float LOG2E = 1.4426950408889634f;
constexpr int DKV_BKV = 128;      // dK/dV: kv rows per CTA (two x 64)
constexpr int DKV_BQ = 64;        // dK/dV: q rows per ring stage
constexpr int DQ_BQ = 128;        // dQ: q rows per CTA (two x 64)
constexpr int DQ_BK = 128;        // dQ: kv rows per ring stage

// Byte offsets of the dynamic shared memory, from its 1024-byte-aligned
// start; the first 1024 bytes of the allocation are alignment slack.
template <int D>
struct DkvSmem {
  static constexpr int kTileKV = DKV_BKV * D * 2;   // K or V
  static constexpr int kTileQ = DKV_BQ * D * 2;     // one stage's Q or dO
  static constexpr int kK = 0;
  static constexpr int kV = kTileKV;
  // stage s: Q at kRing + 2 s kTileQ, dO after it
  static constexpr int kRing = 2 * kTileKV;
  static constexpr int kStatBytes = 2 * DKV_BQ * 4;   // lse * log2 e, delta
  static constexpr int kStat = kRing + DKV_STAGES * 2 * kTileQ;
  static constexpr int kBars = kStat + DKV_STAGES * kStatBytes;
  // K/V full; per stage full, empty
  static constexpr int kNumBars = 1 + 2 * DKV_STAGES;
  static constexpr int kBytes = 1024 + kBars + 8 * kNumBars;
};

template <int D>
struct DqSmem {
  static constexpr int kTileQ = DQ_BQ * D * 2;      // Q or dO
  static constexpr int kTileKV = DQ_BK * D * 2;     // one stage's K or V
  static constexpr int kQ = 0;
  static constexpr int kDO = kTileQ;
  // stage s: K at kRing + 2 s kTileKV, V after it
  static constexpr int kRing = 2 * kTileQ;
  static constexpr int kBars = kRing + DQ_STAGES * 2 * kTileKV;
  // Q/dO full; per stage K full, V full, K empty, V empty
  static constexpr int kNumBars = 1 + 4 * DQ_STAGES;
  static constexpr int kBytes = 1024 + kBars + 8 * kNumBars;
};

// The q tiles a dK/dV CTA walks per q head start at its first row's tile
// (causal) or at 0; a consumer whose 64 kv rows start at `kvc0` skips a q
// tile lying wholly above the diagonal.
__host__ __device__ __forceinline__ int dkv_first_q_tile(int kv0,
                                                         int causal) {
  return causal ? kv0 / DKV_BQ : 0;
}

// Two floats from shared memory. The load is volatile, so it stays after
// the wgmma wait before it: values read early would stay live, in
// registers, under the products.
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// d[64 x 64] = A B^T over D: A's 64 rows from a tile of A_ROWS rows per
// 64-column block, B's 64 rows from one of B_ROWS; both K-major. k-step kk
// reads 16 columns: block kk / 4, bytes 32 (kk % 4) into each 128-byte row.
template <int D, int A_ROWS, int B_ROWS>
__device__ __forceinline__ void issue_ss64(float (&d)[32], uint32_t sA,
                                           uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_ss(
        d,
        smem_desc(sA + (kk / 4) * A_ROWS * ROW_BYTES + (kk % 4) * 32, 16,
                  1024),
        smem_desc(sB + (kk / 4) * B_ROWS * ROW_BYTES + (kk % 4) * 32, 16,
                  1024),
        kk > 0);
}

// d[64 x 128] = A B^T over D, as issue_ss64 with 128 B rows.
template <int D, int A_ROWS, int B_ROWS>
__device__ __forceinline__ void issue_ss128(float (&d)[64], uint32_t sA,
                                            uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n128k16_ss(
        d,
        smem_desc(sA + (kk / 4) * A_ROWS * ROW_BYTES + (kk % 4) * 32, 16,
                  1024),
        smem_desc(sB + (kk / 4) * B_ROWS * ROW_BYTES + (kk % 4) * 32, 16,
                  1024),
        kk > 0);
}

// acc[64 x D] += A B: A from registers (KS k-slices of 16), B the first
// 16 KS rows of a tile of B_ROWS rows per 64-column block, read MN-major
// in place: slice j starts 16 j rows in, the blocks of D are B_ROWS rows
// apart.
template <int D, int KS, int B_ROWS>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const uint32_t (&a)[KS][4],
                                         uint32_t sB) {
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const uint64_t desc =
        smem_desc(sB + j * 16 * ROW_BYTES, B_ROWS * ROW_BYTES, 1024);
    if constexpr (D == 128)
      wgmma_m64n128k16_rs_mn(acc, a[j], desc, 1);
    else
      wgmma_m64n64k16_rs_mn(acc, a[j], desc, 1);
  }
}

// bf16 rows of an accumulator [64 x D] (times `mul`) into rows r0 .. r0+63
// of a swizzled tile of T_ROWS rows per block (16-byte chunk k of row r at
// chunk k ^ (r & 7), so these writes and the reads of store_rows are free
// of bank conflicts).
template <int D, int T_ROWS>
__device__ __forceinline__ void stage_rows(uint8_t* tile, int r0,
                                           const float (&acc)[D / 2],
                                           float mul, int w, int g, int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = r0 + 16 * w + g + 8 * r;
      uint8_t* p = tile + (j / 8) * T_ROWS * ROW_BYTES + rl * ROW_BYTES +
                   (((j % 8) ^ (rl & 7)) * 16) + 4 * t;
      *reinterpret_cast<uint32_t*>(p) =
          pack_bf16(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
}

// Rows r0 .. r0+63 of a staged tile out to `dst` (row `row` at
// dst + row * stride elements) in 16-byte stores, rows at or past S
// dropped; `tid` runs over the warpgroup's 128 threads.
template <int D, int T_ROWS>
__device__ __forceinline__ void store_rows(const uint8_t* tile, int r0,
                                           int row0, int S,
                                           __nv_bfloat16* dst, long stride,
                                           int tid) {
  constexpr int CH = D / 8;   // 16-byte chunks per row
  for (int i = tid; i < 64 * CH; i += 128) {
    const int rl = r0 + i / CH, cc = i % CH;
    const int row = row0 + i / CH;
    if (row < S) {
      const uint4 val = *reinterpret_cast<const uint4*>(
          tile + (cc / 8) * T_ROWS * ROW_BYTES + rl * ROW_BYTES +
          (((cc % 8) ^ (rl & 7)) * 16));
      *reinterpret_cast<uint4*>(dst + row * stride + cc * 8) = val;
    }
  }
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int Hq,
                     int Hkv, float scale, float scale_log2, int causal,
                     uint32_t thr, float inv_keep, uint32_t seed) {
  using L = DkvSmem<D>;
  constexpr int DB = D / 64;          // 64-column blocks per row
  constexpr int NA = D / 2;           // dK or dV accumulators per thread
  constexpr int KS = DKV_BQ / 16;     // k-slices of P^T over the q tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (sbase - raw);
  const uint32_t sK = sbase + L::kK, sV = sbase + L::kV;
  const uint32_t sRing = sbase + L::kRing;
  float* const stat = reinterpret_cast<float*>(gbase + L::kStat);
  const uint32_t sStat = sbase + L::kStat;
  const uint32_t bars = sbase + L::kBars;   // K/V full, then the ring's
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + DKV_STAGES + s); };

  const int n_kvt = (Sk + DKV_BKV - 1) / DKV_BKV;
  int bhk, kvt;
  group_tile(blockIdx.y * n_kvt + blockIdx.x, n_kvt, gridDim.y, false, bhk,
             kvt);
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int G = Hq / Hkv;
  const int kv0 = kvt * DKV_BKV;
  // every q head of the group, q tiles from qt0: one ring stage each
  const int qt0 = dkv_first_q_tile(kv0, causal);

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(full(s), 1 + 32);   // the TMA thread and the stat warp
      mbar_init(empty(s), 8);       // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: a stage is loaded again once both consumers have
    // released it (the tile DKV_STAGES back is done) ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      tma_prefetch(&tm_do);
      mbar_arrive_expect_tx(bars, 2 * L::kTileKV);
      for (int db = 0; db < DB; ++db) {
        tma_load_4d(sK + db * DKV_BKV * ROW_BYTES, &tm_k, bars, db * 64, hk,
                    kv0, b);
        tma_load_4d(sV + db * DKV_BKV * ROW_BYTES, &tm_v, bars, db * 64, hk,
                    kv0, b);
      }
      int s = 0;
      uint32_t ph = 0;   // the ring's stage and phase
      for (int h = hk * G; h < hk * G + G; ++h) {
        for (int q0 = qt0 * DKV_BQ; q0 < Sq; q0 += DKV_BQ) {
          const uint32_t sQ = sRing + 2 * s * L::kTileQ;
          mbar_wait(empty(s), ph ^ 1);
          mbar_arrive_expect_tx(full(s), 2 * L::kTileQ);
          for (int db = 0; db < DB; ++db) {
            tma_load_4d(sQ + db * DKV_BQ * ROW_BYTES, &tm_q, full(s),
                        db * 64, h, q0, b);
            tma_load_4d(sQ + L::kTileQ + db * DKV_BQ * ROW_BYTES, &tm_do,
                        full(s), db * 64, h, q0, b);
          }
          if (++s == DKV_STAGES) s = 0, ph ^= 1;
        }
      }
    } else if (threadIdx.x >= 32 && threadIdx.x < 64) {
      // the stat warp: lse (times log2 e) and delta of each stage's rows
      const int lane = threadIdx.x - 32;
      const float* lrow = lse + (long)(b * Hq + hk * G) * Sq;
      const float* drow = delta + (long)(b * Hq + hk * G) * Sq;
      int s = 0;
      uint32_t ph = 0;
      for (int gi = 0; gi < G; ++gi, lrow += Sq, drow += Sq) {
        for (int q = qt0 * DKV_BQ + lane; q - lane < Sq; q += DKV_BQ) {
          float* st = stat + s * 2 * DKV_BQ + lane;
          mbar_wait(empty(s), ph ^ 1);
          st[0] = q < Sq ? lrow[q] * LOG2E : INFINITY;
          st[DKV_BQ] = q < Sq ? drow[q] : 0.f;
          st[32] = q + 32 < Sq ? lrow[q + 32] * LOG2E : INFINITY;
          st[DKV_BQ + 32] = q + 32 < Sq ? drow[q + 32] : 0.f;
          mbar_arrive(full(s));
          if (++s == DKV_STAGES) s = 0, ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 kv rows each ----
    setmaxnreg_inc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x & 127;
    const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int kvc0 = kv0 + 64 * c;            // this warpgroup's first kv row
    const int kr0 = kvc0 + 16 * w + g;        // kv rows of e = 0, 1 (+8: 2, 3)
    const uint32_t sKc = sK + 64 * c * ROW_BYTES;
    const uint32_t sVc = sV + 64 * c * ROW_BYTES;

    float dka[NA], dva[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) dka[i] = dva[i] = 0.f;
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    uint32_t pz[KS][4], pd[KS][4];

    // The consumers take turns to issue their S^T and dP^T products (named
    // barriers 3 + c, the forward's ping-pong), so one warpgroup's
    // elementwise work runs under the other's products. Warpgroup 0 has
    // the first turn; each turn hands the next to the other warpgroup,
    // except the last one of warpgroup 1, which nobody waits for.
    const int my_turn = 3 + c, their_turn = 4 - c;
    int turns = G * ((Sq + DKV_BQ - 1) / DKV_BQ - qt0);   // left, with this
    if (c == 0) named_barrier_arrive(my_turn, 256);
    mbar_wait(bars, 0);
    int s = DKV_STAGES - 1;
    uint32_t ph = 1;   // the ring's stage and phase, advanced on entry
    for (int bh = b * Hq + hk * G; bh < b * Hq + hk * G + G; ++bh)
    for (int q0 = qt0 * DKV_BQ; q0 < Sq; q0 += DKV_BQ) {
      if (++s == DKV_STAGES) s = 0, ph ^= 1;
      const bool hand_on = --turns > 0 || c == 0;
      const uint32_t sQ = sRing + 2 * s * L::kTileQ;
      const uint32_t sDO = sQ + L::kTileQ;
      const uint32_t sSt = sStat + s * L::kStatBytes;
      mbar_wait(full(s), ph);
      named_barrier_sync(my_turn, 256);
      if (causal && q0 + DKV_BQ - 1 < kvc0) {   // all above the diagonal
        if (hand_on) named_barrier_arrive(their_turn, 256);
        if (lane == 0) mbar_arrive(empty(s));
        continue;
      }
      const bool diag = causal && q0 < kvc0 + 63;
      wgmma_fence();
      fence_regs(sc);
      fence_regs(dp);
      issue_ss64<D, DKV_BKV, DKV_BQ>(sc, sKc, sQ);
      wgmma_commit();
      issue_ss64<D, DKV_BKV, DKV_BQ>(dp, sVc, sDO);
      wgmma_commit();
      if (hand_on) named_barrier_arrive(their_turn, 256);
      // the dropout mask of this thread's 32 (kv, q) elements, bit 4 n + e,
      // hashed while the products run; a rolled loop keeps few hashes live
      uint32_t keep_bits = 0;
      if constexpr (DROPOUT) {
#pragma unroll 1
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            keep_bits |= (uint32_t)keep_elem(seed, bh, q0 + 8 * n + 2 * t +
                                             (e & 1), kr0 + 8 * (e >> 1), Sq,
                                             Sk, thr) << (4 * n + e);
      }
      wgmma_wait<1>();
      fence_regs(sc);
      // P^T in place (rows kv, columns q), Z^T packed for dV
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 l2 = lds_f2(sSt + 4 * (8 * n + 2 * t));
        float z[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 8 * n + 2 * t + (e & 1);
          const int kv = kr0 + 8 * (e >> 1);
          float p = fast_exp2(fmaf(sc[4 * n + e], scale_log2,
                                   -(e & 1 ? l2.y : l2.x)));
          if (diag && q0 + ql < kv) p = 0.f;
          sc[4 * n + e] = p;
          z[e] = p;
          if constexpr (DROPOUT)
            z[e] = (keep_bits >> (4 * n + e)) & 1u ? p * inv_keep : 0.f;
        }
        pz[n / 2][2 * (n % 2) + 0] = pack_bf16(z[0], z[1]);
        pz[n / 2][2 * (n % 2) + 1] = pack_bf16(z[2], z[3]);
      }
      wgmma_fence();
      fence_regs(dva);
      issue_rs<D, KS, DKV_BQ>(dva, pz, sDO);
      wgmma_commit();
      // with dropout the keep bits and their constants take the registers
      // that Z^T would hold in flight: there the dV product finishes first
      if constexpr (DROPOUT) {
        wgmma_wait<0>();
        fence_regs(dva);
        fence_pack(pz);
      } else {
        wgmma_wait<1>();
      }
      fence_regs(dp);
      // dS^T = P^T (dP^T - delta), packed for dK; without dropout it runs
      // under the dV product
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 d2 = lds_f2(sSt + 4 * (DKV_BQ + 8 * n + 2 * t));
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dpv = dp[4 * n + e];
          if constexpr (DROPOUT)
            dpv = (keep_bits >> (4 * n + e)) & 1u ? dpv * inv_keep : 0.f;
          ds[e] = sc[4 * n + e] * (dpv - (e & 1 ? d2.y : d2.x));
        }
        pd[n / 2][2 * (n % 2) + 0] = pack_bf16(ds[0], ds[1]);
        pd[n / 2][2 * (n % 2) + 1] = pack_bf16(ds[2], ds[3]);
      }
      wgmma_fence();
      fence_regs(dka);
      issue_rs<D, KS, DKV_BQ>(dka, pd, sQ);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_pack(pz);
      fence_pack(pd);
      if (lane == 0) mbar_arrive(empty(s));
    }

    // dK (scaled) and dV into this warpgroup's rows of the K and V tiles,
    // which only its own products read, then out
    stage_rows<D, DKV_BKV>(gbase + L::kK, 64 * c, dka, scale, w, g, t);
    stage_rows<D, DKV_BKV>(gbase + L::kV, 64 * c, dva, 1.f, w, g, t);
    named_barrier_sync(1 + c, 128);
    const long kv_stride = (long)Hkv * D;
    const long off = ((long)b * Sk * Hkv + hk) * D;
    store_rows<D, DKV_BKV>(gbase + L::kK, 64 * c, kvc0, Sk, dk + off,
                           kv_stride, tid);
    store_rows<D, DKV_BKV>(gbase + L::kV, 64 * c, kvc0, Sk, dv + off,
                           kv_stride, tid);
  }
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int Hq,
                    int Hkv, float scale, float scale_log2, int causal,
                    uint32_t thr, float inv_keep, uint32_t seed) {
  using L = DqSmem<D>;
  constexpr int DB = D / 64;          // 64-column blocks per row
  constexpr int NA = D / 2;           // dQ accumulators per thread
  constexpr int NS = DQ_BK / 2;       // S or dP accumulators per thread
  constexpr int KS = DQ_BK / 16;      // k-slices of dS over the kv tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (sbase - raw);
  const uint32_t sQ = sbase + L::kQ, sDO = sbase + L::kDO;
  const uint32_t sRing = sbase + L::kRing;   // stage s: K, then V
  const uint32_t bars = sbase + L::kBars;    // Q/dO full, then the ring's
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + DQ_STAGES + s); };
  auto empty_k = [&](int s) { return bars + 8 * (1 + 2 * DQ_STAGES + s); };
  auto empty_v = [&](int s) { return bars + 8 * (1 + 3 * DQ_STAGES + s); };

  const int n_qt = (Sq + DQ_BQ - 1) / DQ_BQ;
  int bh, qt;
  group_tile(blockIdx.y * n_qt + blockIdx.x, n_qt, gridDim.y, true, bh, qt);
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * DQ_BQ;
  int n_kt = (Sk + DQ_BK - 1) / DQ_BK;
  if (causal) n_kt = min(n_kt, (q0 + DQ_BQ + DQ_BK - 1) / DQ_BK);

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 8);   // one arrive per consumer warp
      mbar_init(empty_v(s), 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: K tile kt waits for the dQ product of tile kt - 2 to
    // release its stage, V tile kt for the dP product of tile kt - 2 ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      tma_prefetch(&tm_do);
      mbar_arrive_expect_tx(bars, 2 * L::kTileQ);
      for (int db = 0; db < DB; ++db) {
        tma_load_4d(sQ + db * DQ_BQ * ROW_BYTES, &tm_q, bars, db * 64, h, q0,
                    b);
        tma_load_4d(sDO + db * DQ_BQ * ROW_BYTES, &tm_do, bars, db * 64, h,
                    q0, b);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % DQ_STAGES;
        const uint32_t free_phase = ((kt / DQ_STAGES) & 1) ^ 1;
        const uint32_t sKs = sRing + 2 * s * L::kTileKV;
        mbar_wait(empty_k(s), free_phase);
        mbar_arrive_expect_tx(full_k(s), L::kTileKV);
        for (int db = 0; db < DB; ++db)
          tma_load_4d(sKs + db * DQ_BK * ROW_BYTES, &tm_k, full_k(s),
                      db * 64, hk, kt * DQ_BK, b);
        mbar_wait(empty_v(s), free_phase);
        mbar_arrive_expect_tx(full_v(s), L::kTileKV);
        for (int db = 0; db < DB; ++db)
          tma_load_4d(sKs + L::kTileKV + db * DQ_BK * ROW_BYTES, &tm_v,
                      full_v(s), db * 64, hk, kt * DQ_BK, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    setmaxnreg_inc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x & 127;
    const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int qc0 = q0 + 64 * c;               // this warpgroup's first row
    const int row0 = qc0 + 16 * w + g;         // rows of e = 0, 1 (+8: 2, 3)
    const uint32_t sQc = sQ + 64 * c * ROW_BYTES;
    const uint32_t sDOc = sDO + 64 * c * ROW_BYTES;
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const bool in = row < Sq;
      lse2[r] = in ? lse[(long)bh * Sq + row] * LOG2E : INFINITY;
      dl[r] = in ? delta[(long)bh * Sq + row] : 0.f;
    }

    float dqa[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) dqa[i] = 0.f;
    float sc[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = dp[i] = 0.f;
    uint32_t pd[KS][4];

    // turns to issue S and dP, as in the dK/dV kernel
    const int my_turn = 3 + c, their_turn = 4 - c;
    if (c == 0) named_barrier_arrive(my_turn, 256);
    mbar_wait(bars, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % DQ_STAGES;
      const uint32_t phase = (kt / DQ_STAGES) & 1;
      const uint32_t sKs = sRing + 2 * s * L::kTileKV;
      const int k0 = kt * DQ_BK;
      mbar_wait(full_k(s), phase);
      mbar_wait(full_v(s), phase);
      named_barrier_sync(my_turn, 256);
      wgmma_fence();
      fence_regs(sc);
      fence_regs(dp);
      issue_ss128<D, DQ_BQ, DQ_BK>(sc, sQc, sKs);
      wgmma_commit();
      issue_ss128<D, DQ_BQ, DQ_BK>(dp, sDOc, sKs + L::kTileKV);
      wgmma_commit();
      if (c == 0 || kt + 1 < n_kt) named_barrier_arrive(their_turn, 256);
      wgmma_wait<1>();
      fence_regs(sc);
      // P in place: the causal mask only on the diagonal tile
      const bool diag = causal && k0 + DQ_BK - 1 > qc0;
#pragma unroll
      for (int n = 0; n < NS / 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(fmaf(sc[4 * n + e], scale_log2, -lse2[e >> 1]));
          if (diag && k0 + 8 * n + 2 * t + (e & 1) > row0 + 8 * (e >> 1))
            p = 0.f;
          sc[4 * n + e] = p;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      if (lane == 0) mbar_arrive(empty_v(s));
      // dS = P (dP - delta), packed for dQ
#pragma unroll
      for (int n = 0; n < NS / 4; ++n) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dpv = dp[4 * n + e];
          if constexpr (DROPOUT) {
            const bool keep =
                keep_elem(seed, bh, row0 + 8 * (e >> 1),
                          k0 + 8 * n + 2 * t + (e & 1), Sq, Sk, thr);
            dpv = keep ? dpv * inv_keep : 0.f;
          }
          ds[e] = sc[4 * n + e] * (dpv - dl[e >> 1]);
        }
        pd[n / 2][2 * (n % 2) + 0] = pack_bf16(ds[0], ds[1]);
        pd[n / 2][2 * (n % 2) + 1] = pack_bf16(ds[2], ds[3]);
      }
      wgmma_fence();
      fence_regs(dqa);
      issue_rs<D, KS, DQ_BK>(dqa, pd, sKs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      fence_pack(pd);
      if (lane == 0) mbar_arrive(empty_k(s));
    }

    // dQ (scaled once) into this warpgroup's rows of the Q tile, then out
    stage_rows<D, DQ_BQ>(gbase + L::kQ, 64 * c, dqa, scale, w, g, t);
    named_barrier_sync(1 + c, 128);
    store_rows<D, DQ_BQ>(gbase + L::kQ, 64 * c, qc0, Sq,
                         dq + ((long)b * Sq * Hq + h) * D, (long)Hq * D, tid);
  }
}

struct Args {
  CUtensorMap tq, tk, tv, tdo;
  const float* lse;
  const float* delta;
  int B, Sq, Sk, Hq, Hkv, D, causal, dropout;
  float scale, scale_log2, inv_keep;
  uint32_t thr, seed;
};

template <int D, bool DROPOUT>
cudaError_t launch_dkv(const Args& a, __nv_bfloat16* dk, __nv_bfloat16* dv,
                       cudaStream_t s) {
  constexpr int smem = DkvSmem<D>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, DROPOUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.Sk + DKV_BKV - 1) / DKV_BKV, a.B * a.Hkv);
  flash_bwd_dkv_kernel<D, DROPOUT><<<grid, BWD_THREADS, smem, s>>>(
      a.tq, a.tk, a.tv, a.tdo, a.lse, a.delta, dk, dv, a.Sq, a.Sk, a.Hq,
      a.Hkv, a.scale, a.scale_log2, a.causal, a.thr, a.inv_keep, a.seed);
  return cudaGetLastError();
}

template <int D, bool DROPOUT>
cudaError_t launch_dq(const Args& a, __nv_bfloat16* dq, cudaStream_t s) {
  constexpr int smem = DqSmem<D>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, DROPOUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.Sq + DQ_BQ - 1) / DQ_BQ, a.B * a.Hq);
  flash_bwd_dq_kernel<D, DROPOUT><<<grid, BWD_THREADS, smem, s>>>(
      a.tq, a.tk, a.tv, a.tdo, a.lse, a.delta, dq, a.Sq, a.Sk, a.Hq, a.Hkv,
      a.scale, a.scale_log2, a.causal, a.thr, a.inv_keep, a.seed);
  return cudaGetLastError();
}

// The tensor maps and scalars of one call: Q and dO in boxes of q_rows
// rows, K and V of kv_rows; 0 or cudaErrorInvalidValue.
int make_args(Args* a, const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* delta,
              const void* out0, const void* out1, int B, int Sq, int Sk,
              int Hq, int Hkv, int D, float scale, int causal, int dropout,
              unsigned thr, float inv_keep, int seed, int q_rows,
              int kv_rows) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv ||
      (D != 64 && D != 128) ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(out0) |
       reinterpret_cast<uintptr_t>(out1)) % 16)
    return (int)cudaErrorInvalidValue;
  if (!bshd_tensor_map(&a->tq, q, B, Sq, Hq, D, q_rows) ||
      !bshd_tensor_map(&a->tdo, dout, B, Sq, Hq, D, q_rows) ||
      !bshd_tensor_map(&a->tk, k, B, Sk, Hkv, D, kv_rows) ||
      !bshd_tensor_map(&a->tv, v, B, Sk, Hkv, D, kv_rows))
    return (int)cudaErrorInvalidValue;
  a->lse = static_cast<const float*>(lse);
  a->delta = static_cast<const float*>(delta);
  a->B = B;
  a->Sq = Sq;
  a->Sk = Sk;
  a->Hq = Hq;
  a->Hkv = Hkv;
  a->D = D;
  a->causal = causal;
  a->dropout = dropout;
  a->scale = scale;
  a->scale_log2 = scale * LOG2E;
  a->inv_keep = inv_keep;
  a->thr = thr;
  a->seed = (uint32_t)seed;
  return 0;
}

int dkv_smem(int D) {
  return D == 128 ? DkvSmem<128>::kBytes : D == 64 ? DkvSmem<64>::kBytes : -1;
}

int dq_smem(int D) {
  return D == 128 ? DqSmem<128>::kBytes : D == 64 ? DqSmem<64>::kBytes : -1;
}

}  // namespace

// The wrapper's launch geometry (`bwd_launch_config`) against these
// kernels': 0 if every number matches, else cudaErrorInvalidValue. The last
// kv tile's first q tile and the last q tile's kv tiles pin the walks.
extern "C" int pt_flash_attention_bwd_check_launch(
    int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal, int threads,
    int dkv_stages, int dq_stages, int head_group, int dkv_block_kv,
    int dkv_block_q,
    int dkv_smem_bytes, int dkv_grid_x, int dkv_grid_y, int dkv_last_q_start,
    int dq_block_q, int dq_block_k, int dq_smem_bytes, int dq_grid_x,
    int dq_grid_y, int dq_last_kv_tiles) {
  const int n_kvt = (Sk + DKV_BKV - 1) / DKV_BKV;
  const int n_qt = (Sq + DQ_BQ - 1) / DQ_BQ;
  int n_kt = (Sk + DQ_BK - 1) / DQ_BK;
  if (causal) n_kt = std::min(n_kt, (n_qt * DQ_BQ + DQ_BK - 1) / DQ_BK);
  const bool ok =
      threads == BWD_THREADS && dkv_stages == DKV_STAGES &&
      dq_stages == DQ_STAGES &&
      head_group == HEAD_GROUP && dkv_block_kv == DKV_BKV &&
      dkv_block_q == DKV_BQ && dkv_smem_bytes == dkv_smem(D) &&
      dkv_grid_x == n_kvt && dkv_grid_y == B * Hkv &&
      dkv_last_q_start == dkv_first_q_tile((n_kvt - 1) * DKV_BKV, causal) &&
      dq_block_q == DQ_BQ && dq_block_k == DQ_BK &&
      dq_smem_bytes == dq_smem(D) && dq_grid_x == n_qt &&
      dq_grid_y == B * Hq && dq_last_kv_tiles == n_kt;
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// dK, dV of one backward. `dropout` selects the masked form; `thr` is
// int(p * 2^31) and `inv_keep` is float32(1 / (1 - p)). The tensor maps are
// encoded here, per call.
extern "C" int pt_flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, float scale, int causal, int dropout,
    unsigned thr, float inv_keep, int seed, void* stream) {
  Args a;
  const int bad = make_args(&a, q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk,
                            Hq, Hkv, D, scale, causal, dropout, thr, inv_keep,
                            seed, DKV_BQ, DKV_BKV);
  if (bad) return bad;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto* kp = static_cast<__nv_bfloat16*>(dk);
  auto* vp = static_cast<__nv_bfloat16*>(dv);
  if (D == 128)
    return (int)(dropout ? launch_dkv<128, true>(a, kp, vp, s)
                         : launch_dkv<128, false>(a, kp, vp, s));
  return (int)(dropout ? launch_dkv<64, true>(a, kp, vp, s)
                       : launch_dkv<64, false>(a, kp, vp, s));
}

// dQ of one backward, same arguments.
extern "C" int pt_flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int Sq, int Sk,
    int Hq, int Hkv, int D, float scale, int causal, int dropout,
    unsigned thr, float inv_keep, int seed, void* stream) {
  Args a;
  const int bad = make_args(&a, q, k, v, dout, lse, delta, dq, dq, B, Sq, Sk,
                            Hq, Hkv, D, scale, causal, dropout, thr, inv_keep,
                            seed, DQ_BQ, DQ_BK);
  if (bad) return bad;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto* qp = static_cast<__nv_bfloat16*>(dq);
  if (D == 128)
    return (int)(dropout ? launch_dq<128, true>(a, qp, s)
                         : launch_dq<128, false>(a, qp, s));
  return (int)(dropout ? launch_dq<64, true>(a, qp, s)
                       : launch_dq<64, false>(a, qp, s));
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
