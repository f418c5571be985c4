// Paged-attention append step for Hopper (sm_90a), fp32 math, over bf16
// pools (kernel B3) or quantized int8/int4 pools (kernel B4, append form).
//
// Replaces: paddle_tpu/ops/kernels/paged_attention.py `_append_kernel`
// (:662), the Pallas TPU kernel launched through `paged_attention_append`
// (:784, pallas_call at :868): its unquantized form with the fused
// multi-block write, and its quant="int8"|"int4" form (:689-750). It is the
// attention of the fused scheduler's mixed step: per sequence b, up to S
// new positions (q_lens[b] of them real) attend the pooled history plus
// their own chunk prefix.
//
// What it computes, for pools [NB, Hkv, bs, D], tables [B, MB] (-1 =
// unallocated), lens [B] (tokens already cached) and q_lens [B]:
// - bf16 pools: row i < q_lens[b] writes its new K/V at position
//   lens[b] + i into block tables[b, (lens[b] + i) / bs]; a -1 entry routes
//   the write to the pool's last block (the engine's scratch block), a
//   logical block >= MB drops; padding rows and q_lens == 0 slots write
//   nothing;
// - quantized pools (payload [NB, Hkv, bs, Dp], int8: Dp = D, int4:
//   Dp = D / 2 in split-half nibbles; scales [NB, Hkv]): every window block
//   w0 <= j <= j_last of a sequence with q_lens > 0 (w0 = min(lens / bs,
//   MB - 1), j_last = min((lens + q_lens - 1) / bs, MB - 1)) is rewritten
//   under the quantized write rule (csrc/kv_quant.cuh): the chunk rows that
//   land in it merged, its rows at or past lens + q_lens zeroed, older rows
//   re-rounded under the new absmax scale; payload and scale are stored at
//   tables[b, j], or in the scratch block for a -1 entry. A q_lens == 0
//   slot writes nothing;
// - row i attends positions <= lens[b] + i of blocks
//   0 .. (lens[b] + q_lens[b] - 1) / bs, skipping -1 entries (quantized:
//   each key dequantized with its block's scales, the window blocks read
//   from their round-tripped values, since the write pass runs first);
//   fp32 online softmax, out = acc / max(l, 1e-30). P is rounded to bf16
//   before P@V as the reference rounds it for bf16 pools; for quantized
//   pools the rounded factor is P * (the key's V scale), where the
//   reference keeps float32 (the one rounding this kernel adds to the
//   reference's math). Padding rows (i >= q_lens) and idle slots get zeros.
//
// Bound on the H100: bytes. At the smoke's parity shape (B=8, S=256,
// Hq=Hkv=32, D=128, block 64, 808 real rows over lens up to 1999) the
// bf16 function reads ~62 MB of cached K/V (3,762 positions), ~13 MB of new
// K/V and ~6.6 MB of q, and writes ~13 MB of K/V and ~6.6 MB of out:
// ~101 MB, ~0.030 ms at 3.35 TB/s, against ~6.7 GFLOP of products over
// 408,208 visible (query, key) pairs, ~0.007 ms at 989 TFLOP/s. So K/V
// must be read from device memory about once per (sequence, kv head) and
// the products must not be the limit: they run on the tensor cores
// (mma.sync is enough at ~4 operations per byte; wgmma's 64-row tiles
// would not fit the decode rows of a mixed step, which B3 also serves).
// Quantized pools move half the cached bytes (a quarter for int4) plus one
// scale per block. The two passes below read the new K/V a second time,
// out of the pool: that is this design's cost, not the function's.
//
// Two launches on one stream, so that no CTA races another CTA's write:
// - write pass, bf16: one CTA per (b, row i) copies the row's Hkv x D new
//   K and V values with 16-byte loads and stores into their block slots;
// - write pass, quantized: one CTA per (window block, kv head, sequence)
//   loads the block's stored K payload into shared memory, requantizes it
//   there with the chunk rows merged (kv_requant_block), stores payload and
//   scale, then does the same for V. The CTA owns its block, so no other
//   CTA races its write;
// - attention pass, bf16 (B3, `append_split_kernel`, csrc/paged_split.cuh,
//   the walk B2 shares): one CTA per (64-row query tile, kv head,
//   sequence); the tile runs over the G*S rows of the head group ordered
//   position-major (row r = i * G + g), so every K/V stage it reads serves
//   all G query heads. Pool blocks arrive by TMA through a 3-stage (D 128;
//   4 at D 64) mbarrier ring fed by a producer warp; S = Q K^T and
//   O += P V run on mma.sync.m16n8k16 with K and V fragments read by
//   ldmatrix from 128-byte-swizzled tiles. A tile whose rows are all
//   padding writes zeros. Long walks are split, not all walks: the last
//   real tile of a sequence, if it holds at most 32 real rows (a decode
//   row, a chunk's short tail), is split over kv into k <= 8 spans of at
//   least 256 positions (k * rows <= 64), walked by its own CTA and the
//   padding tiles' CTAs after it, its float32 partials merged in split
//   order by the last to finish (append_splits, mirrored by
//   `append_launch_config` and `append_tile_splits` in
//   ops/kernels/paged_attention.py). So the partials are at most a quarter
//   of the split tile's walk, and 0.1% of the function's bytes at the
//   timing shape (only the decode row over 2,000 positions splits, 4
//   ways). A chunk's 64-row tiles are not split: their partials would cost
//   up to half of their walk, and a chunk's tiles already run side by side.
// - attention pass, quantized (B4, `append_attn_kernel`, the first design):
//   one CTA = 4 warps per (b, kv head, 64-row query tile) walks 64-position
//   K/V tiles up to lens + (its last real row), skipping tiles whose
//   blocks are all -1, staged through shared memory with double-buffered
//   16-byte cp.async; the payload is unpacked in shared memory into bf16
//   tiles of its grid values, which bf16 holds exactly (|grid| <= 127):
//   the key's K scale multiplies its column of S in fp32, and its V scale
//   multiplies its column of P before P is rounded, so no dequantized value
//   is rounded. Its ring and split can take the bf16 walk's form once the
//   unpack moves between the stage's arrival and its products (ROADMAP
//   queue B).
//
// Measured (chip_smoke.py, tools/ab_paged.py, tools/paged_sweep.py on an
// H100 80GB HBM3 at 700 W): PERF.md, kernel table row 5. B3 takes
// 0.0850 ms at the timing shape, 2.8x its bound (the first design, one
// non-split walk per tile through a 2-stage cp.async buffer: 0.1883 ms);
// its chunk tiles are bound by L2, each re-reading its sequence's history.
#include <math.h>

#include "flash_common.cuh"
#include "kv_quant.cuh"
#include "paged_common.cuh"
#include "paged_split.cuh"

namespace {

constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXBS = 128;   // block size
constexpr int PADB = 16;     // bytes of padding per shared row

// ---- write pass, bf16: one CTA per (row i, sequence b) ---------------------
__global__ void __launch_bounds__(NTHREADS)
append_write_kernel(__nv_bfloat16* k_pool, __nv_bfloat16* v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens,
                    const int* __restrict__ qlens,
                    const __nv_bfloat16* __restrict__ new_k, long long nk_b,
                    long long nk_s, const __nv_bfloat16* __restrict__ new_v,
                    long long nv_b, long long nv_s, int Hkv, int D, int bs,
                    int MB, int NB) {
  const int i = blockIdx.x, b = blockIdx.y;
  if (i >= qlens[b]) return;
  const int pos = lens[b] + i;
  const int blk = pos / bs;
  if (blk >= MB) return;                     // past the table: dropped
  const int phys = tables[(long)b * MB + blk];
  const int tgt = phys < 0 ? NB - 1 : phys;  // -1 -> the scratch block
  const int slot = pos - blk * bs;
  const int ch = D / 8;                      // 16-byte chunks per head row
  const __nv_bfloat16* ks = new_k + (long)b * nk_b + (long)i * nk_s;
  const __nv_bfloat16* vs = new_v + (long)b * nv_b + (long)i * nv_s;
  for (int c = threadIdx.x; c < Hkv * ch; c += NTHREADS) {
    const int h = c / ch, d = (c % ch) * 8;
    const long dst = (((long)tgt * Hkv + h) * bs + slot) * D + d;
    *reinterpret_cast<uint4*>(k_pool + dst) =
        *reinterpret_cast<const uint4*>(ks + (long)h * D + d);
    *reinterpret_cast<uint4*>(v_pool + dst) =
        *reinterpret_cast<const uint4*>(vs + (long)h * D + d);
  }
}

// ---- write pass, quantized: one CTA per (window block, kv head, sequence) --
template <int BITS>
__global__ void __launch_bounds__(NTHREADS)
append_quant_write_kernel(uint8_t* k_pool, uint8_t* v_pool, float* k_scale,
                          float* v_scale, const int* __restrict__ tables,
                          const int* __restrict__ lens,
                          const int* __restrict__ qlens,
                          const __nv_bfloat16* __restrict__ new_k,
                          long long nk_b, long long nk_s,
                          const __nv_bfloat16* __restrict__ new_v,
                          long long nv_b, long long nv_s, int Hkv, int D,
                          int bs, int MB, int NB) {
  __shared__ __align__(16) uint8_t buf[MAXBS * (128 + PADB)];
  __shared__ float red_s[NWARPS];
  const int w = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int QL = qlens[b];
  if (QL <= 0) return;                       // idle slot: writes nothing
  const int L = lens[b];
  const int w0 = min(L / bs, MB - 1);
  const int j_last = min((L + QL - 1) / bs, MB - 1);
  const int j = w0 + w;
  if (j > j_last) return;
  const int phys = tables[(long)b * MB + j];
  const int src = max(phys, 0);              // -1: block 0's content ...
  const int tgt = phys < 0 ? NB - 1 : phys;  // ... parked in scratch
  const int Dp = D / kv_pack_factor<BITS>();
  const int ld = Dp + PADB;
  const int ch = Dp / 16;
  const int first = j * bs - L;              // chunk index of block row 0
  const int live_end = L + QL - j * bs;      // rows >= this are zeroed
  const long sbase = ((long)src * Hkv + kvh) * bs * Dp;
  const long obase = ((long)tgt * Hkv + kvh) * bs * Dp;
  for (int pass = 0; pass < 2; ++pass) {
    uint8_t* pool = pass ? v_pool : k_pool;
    float* scales = pass ? v_scale : k_scale;
    const __nv_bfloat16* nw = pass ? new_v : new_k;
    const long nb_ = pass ? nv_b : nk_b, ns_ = pass ? nv_s : nk_s;
    for (int i = threadIdx.x; i < bs * ch; i += NTHREADS) {
      const int r = i / ch, c = (i % ch) * 16;
      *reinterpret_cast<uint4*>(buf + r * ld + c) =
          *reinterpret_cast<const uint4*>(pool + sbase + (long)r * Dp + c);
    }
    const float s_old = scales[(long)src * Hkv + kvh];
    __syncthreads();
    const float s_new = kv_requant_block<BITS, NTHREADS>(
        buf, ld, s_old, bs, Dp, live_end,
        [&](int r) -> const __nv_bfloat16* {
          const int ci = first + r;
          return (ci >= 0 && ci < QL)
                     ? nw + (long)b * nb_ + (long)ci * ns_ + (long)kvh * D
                     : nullptr;
        },
        red_s);
    for (int i = threadIdx.x; i < bs * ch; i += NTHREADS) {
      const int r = i / ch, c = (i % ch) * 16;
      *reinterpret_cast<uint4*>(pool + obase + (long)r * Dp + c) =
          *reinterpret_cast<const uint4*>(buf + r * ld + c);
    }
    if (threadIdx.x == 0) scales[(long)tgt * Hkv + kvh] = s_new;
    __syncthreads();   // buf is reloaded by the next pass
  }
}

// ---- attention pass, quantized (B4): one CTA per (64-row tile, kv head,
// sequence) --------------------------------------------------------------
// BITS: 8 or 4; a pool holds payload bytes, with their scales
template <int D, int BITS>
__global__ void __launch_bounds__(NTHREADS)
append_attn_kernel(const __nv_bfloat16* __restrict__ q, long long q_b,
                   long long q_s, const uint8_t* __restrict__ k_pool,
                   const uint8_t* __restrict__ v_pool,
                   const int* __restrict__ tables,
                   const int* __restrict__ lens,
                   const int* __restrict__ qlens,
                   __nv_bfloat16* __restrict__ out, int S, int Hq, int Hkv,
                   int bs, int MB, float scale_log2,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale) {
  using T = uint8_t;
  constexpr int LD = D + PAD;       // shared row stride of a bf16 tile
  constexpr int RE = D * BITS / 8 / (int)sizeof(T);  // elements of a pool row
  constexpr int LDP = RE + PADB / (int)sizeof(T);    // ... of a staged row
  constexpr int CE = 16 / (int)sizeof(T);            // ... of a 16-byte chunk
  constexpr int KD = D / 16;   // k-steps over the head dim
  constexpr int ND = D / 8;    // n8 tiles of the output row
  constexpr int NS = BK / 8;   // n8 tiles of one score tile
  constexpr int CH = RE / CE;  // 16-byte chunks per pool row
  constexpr int CHO = D / 8;   // 16-byte chunks per output row
  // [2][K, V][BK][LDP] payload bytes as stored, then [K, V][BK][LD] bf16
  // grid tiles (the tiles the products read)
  extern __shared__ __align__(16) __nv_bfloat16 kv_s[];
  __shared__ int ok_s[2][BK];
  // [stage][K, V][key] its block's K scale * scale_log2, V scale
  __shared__ float sc_s[2][2][BK];

  const int G = Hq / Hkv;
  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int L = lens[b], QL = qlens[b];
  const int rows_total = S * G;
  const int r0 = tile * BQ;
  const int r_end = min(r0 + BQ, rows_total);

  if (r0 / G >= QL) {
    // every row of the tile is padding (or the slot is idle): zeros
    for (int c = threadIdx.x; c < (r_end - r0) * CHO; c += NTHREADS) {
      const int r = r0 + c / CHO, d = (c % CHO) * 8;
      const int i = r / G, gg = r % G;
      *reinterpret_cast<uint4*>(
          out + (((long)b * S + i) * Hq + kvh * G + gg) * D + d) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  const int i_last = min((r_end - 1) / G, QL - 1);
  const int n_pos = L + i_last + 1;          // positions the tile may see
  const int j_last = min((L + QL - 1) / bs, MB - 1);
  const int n_kt = (n_pos + BK - 1) / BK;
  const int* trow = tables + (long)b * MB;
  // bf16 elements of one stage
  const long stage = (long)2 * BK * LDP * (int)sizeof(T) / 2;

  // does K/V tile kt touch a live block?
  auto tile_live = [&](int kt) {
    const int j1 = min((kt * BK + BK - 1) / bs, j_last);
    for (int j = kt * BK / bs; j <= j1; ++j)
      if (trow[j] >= 0) return true;
    return false;
  };
  auto next_tile = [&](int kt) {
    for (int n = kt + 1; n < n_kt; ++n)
      if (tile_live(n)) return n;
    return -1;
  };
  // stage K/V tile kt into buffer st; dead rows are zero-filled
  auto issue = [&](int kt, int st) {
    T* ks = reinterpret_cast<T*>(kv_s + st * stage);
    T* vs = ks + (long)BK * LDP;
    if (threadIdx.x < BK) {
      const int pos = kt * BK + threadIdx.x;
      const int j = pos / bs;
      const bool live = pos < n_pos && j <= j_last && trow[j] >= 0;
      ok_s[st][threadIdx.x] = live ? 1 : 0;
      sc_s[st][0][threadIdx.x] =
          live ? k_scale[(long)trow[j] * Hkv + kvh] * scale_log2 : 0.f;
      sc_s[st][1][threadIdx.x] =
          live ? v_scale[(long)trow[j] * Hkv + kvh] : 0.f;
    }
    for (int c = threadIdx.x; c < BK * CH; c += NTHREADS) {
      const int r = c / CH, d = (c % CH) * CE;
      const int pos = kt * BK + r;
      const int j = pos / bs;
      const int phys = (pos < n_pos && j <= j_last) ? trow[j] : -1;
      if (phys >= 0) {
        const long src =
            (((long)phys * Hkv + kvh) * bs + (pos - j * bs)) * RE + d;
        cp_async16(ks + r * LDP + d, k_pool + src);
        cp_async16(vs + r * LDP + d, v_pool + src);
      } else {
        *reinterpret_cast<uint4*>(ks + r * LDP + d) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vs + r * LDP + d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };
  // quantized: unpack buffer st's payload into the bf16 grid tiles, which
  // follow the two stages
  auto unpack = [&](int st) {
    const uint8_t* kq = reinterpret_cast<const uint8_t*>(kv_s + st * stage);
    const uint8_t* vq = kq + (long)BK * LDP;
    __nv_bfloat16* kg = kv_s + 2 * stage;
    __nv_bfloat16* vg = kg + BK * LD;
    for (int c = threadIdx.x; c < BK * RE; c += NTHREADS) {
      const int r = c / RE, col = c % RE;
      const uint8_t kb = kq[r * LDP + col], vb = vq[r * LDP + col];
#pragma unroll
      for (int h = 0; h < kv_pack_factor<BITS>(); ++h) {
        const int d = col + h * RE;
        kg[r * LD + d] = __float2bfloat16_rn(kv_grid<BITS>(kb, h));
        vg[r * LD + d] = __float2bfloat16_rn(kv_grid<BITS>(vb, h));
      }
    }
  };

  int kt = tile_live(0) ? 0 : next_tile(0);
  if (kt >= 0) issue(kt, 0);

  // this thread's two query rows (the mma fragment rows g and g + 8), held
  // as bf16 A fragments straight from device memory
  int lim[2];
  uint32_t qa[KD][4];
  {
    const __nv_bfloat16* qrow[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + warp * 16 + g + hr * 8;
      const int i = r / G, gg = r % G;
      qrow[hr] = r < rows_total
                     ? q + (long)b * q_b + (long)i * q_s + (long)(kvh * G + gg) * D
                     : nullptr;
      lim[hr] = L + min(i, QL - 1);          // padding rows: last real row's set
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int c = kk * 16 + t * 2;
      qa[kk][0] = qrow[0] ? lds32(qrow[0] + c) : 0u;
      qa[kk][1] = qrow[1] ? lds32(qrow[1] + c) : 0u;
      qa[kk][2] = qrow[0] ? lds32(qrow[0] + c + 8) : 0u;
      qa[kk][3] = qrow[1] ? lds32(qrow[1] + c + 8) : 0u;
    }
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};   // per-thread partial row sums, reduced at the end

  int st = 0;
  while (kt >= 0) {
    const int kn = next_tile(kt);
    if (kn >= 0) {
      issue(kn, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile kt resident, its ok flags (and scales) written
    unpack(st);
    __syncthreads();   // the grid tiles are written
    const __nv_bfloat16* Ks = kv_s + 2 * stage;
    const __nv_bfloat16* Vs = Ks + (long)BK * LD;
    const int k0 = kt * BK;

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

    // mask (live block, causal against the row's absolute position), then
    // the online-softmax update in log2 units
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + t * 2 + (e & 1);
        const bool ok = ok_s[st][col] && (k0 + col) <= lim[e >> 1];
        // the key's K scale (times the softmax scale) too
        s[n][e] = ok ? s[n][e] * sc_s[st][0][col] : -INFINITY;
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
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }
    // P's column of each key takes that key's V scale (after l summed P)
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float* vsc = &sc_s[st][1][n * 8 + t * 2];
      s[n][0] *= vsc[0]; s[n][1] *= vsc[1];
      s[n][2] *= vsc[0]; s[n][3] *= vsc[1];
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
    __syncthreads();   // buffer st (and the grid tiles) are rewritten next
    kt = kn;
    st ^= 1;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + warp * 16 + g + hr * 8;
    if (r >= rows_total) continue;
    const int i = r / G, gg = r % G;
    const float inv = (i < QL) ? 1.f / fmaxf(l[hr], 1e-30f) : 0.f;
    __nv_bfloat16* orow = out + (((long)b * S + i) * Hq + kvh * G + gg) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t * 2) =
          pack_bf16(o[n][2 * hr] * inv, o[n][2 * hr + 1] * inv);
    }
  }
}

template <int D, int BITS>
int launch_attn(dim3 grid, cudaStream_t s, const __nv_bfloat16* q,
                long long q_b, long long q_s, const void* k_pool,
                const void* v_pool, const float* k_scale,
                const float* v_scale, const int* tables, const int* lens,
                const int* qlens, __nv_bfloat16* out, int S, int Hq, int Hkv,
                int bs, int MB, float scale_log2) {
  const int smem = 2 * 2 * BK * (D * BITS / 8 + PADB) +  // 2 stages, K and V
                   2 * BK * (D + PAD) * (int)sizeof(__nv_bfloat16);
  static int smem_allowed = 0;   // the opt-in above 48 KB, set once per size
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        append_attn_kernel<D, BITS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  append_attn_kernel<D, BITS><<<grid, NTHREADS, smem, s>>>(
      q, q_b, q_s, static_cast<const uint8_t*>(k_pool),
      static_cast<const uint8_t*>(v_pool), tables, lens, qlens, out, S,
      Hq, Hkv, bs, MB, scale_log2, k_scale, v_scale);
  return (int)cudaGetLastError();
}

// Both passes for quantized pools of BITS (8 or 4) with their scales.
template <int BITS>
int dispatch(const void* q, long long q_b, long long q_s, void* k_pool,
             void* v_pool, void* k_scale, void* v_scale, const void* tables,
             const void* lens, const void* qlens, const void* new_k,
             long long nk_b, long long nk_s, const void* new_v, long long nv_b,
             long long nv_s, void* out, int B, int S, int Hq, int Hkv, int D,
             int bs, int MB, int NB, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv || bs <= 0 || bs > MAXBS ||
      MB <= 0 || NB <= 0 || B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* ksp = static_cast<float*>(k_scale);
  auto* vsp = static_cast<float*>(v_scale);
  const auto* tp = static_cast<const int*>(tables);
  const auto* lp = static_cast<const int*>(lens);
  const auto* qlp = static_cast<const int*>(qlens);
  const auto* nkp = static_cast<const __nv_bfloat16*>(new_k);
  const auto* nvp = static_cast<const __nv_bfloat16*>(new_v);
  auto* op = static_cast<__nv_bfloat16*>(out);

  // a window covers at most ceil(S / bs) + 1 blocks
  const int NW = (S + bs - 1) / bs + 1;
  append_quant_write_kernel<BITS><<<dim3(NW, Hkv, B), NTHREADS, 0, s>>>(
      static_cast<uint8_t*>(k_pool), static_cast<uint8_t*>(v_pool), ksp,
      vsp, tp, lp, qlp, nkp, nk_b, nk_s, nvp, nv_b, nv_s, Hkv, D, bs, MB,
      NB);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int G = Hq / Hkv;
  const dim3 grid((S * G + BQ - 1) / BQ, Hkv, B);
  const float scale_log2 = scale * 1.4426950408889634f;
  if (D == 128)
    return launch_attn<128, BITS>(grid, s, qp, q_b, q_s, k_pool, v_pool, ksp,
                                  vsp, tp, lp, qlp, op, S, Hq, Hkv, bs, MB,
                                  scale_log2);
  return launch_attn<64, BITS>(grid, s, qp, q_b, q_s, k_pool, v_pool, ksp,
                               vsp, tp, lp, qlp, op, S, Hq, Hkv, bs, MB,
                               scale_log2);
}

// ---- attention pass, bf16 (B3): the split walk of paged_split.cuh -------
template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS, 2)
append_split_kernel(const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv,
                    const SplitParams p) {
  split_walk<D, false>(&tmk, &tmv, p);
}

// the q tiles of a head group: S*G rows in 64-row tiles
int append_tiles(int S, int G) { return (S * G + SPLIT_ROWS - 1) / SPLIT_ROWS; }

}  // namespace

extern "C" int pt_paged_attention_append_bf16(
    const void* q, long long q_b, long long q_s, void* k_pool, void* v_pool,
    const void* tables, const void* lens, const void* qlens,
    const void* new_k, long long nk_b, long long nk_s, const void* new_v,
    long long nv_b, long long nv_s, void* out, int B, int S, int Hq, int Hkv,
    int D, int bs, int MB, int NB, float scale, void* scratch,
    void* counters, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv || bs <= 0 || bs > MAXBS ||
      MB <= 0 || NB <= 0 || B > 65535 || Hkv > 65535 ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tk, tv;
  if (!split_pool_maps(&tk, &tv, k_pool, v_pool, NB, Hkv, bs, D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto* kp = static_cast<__nv_bfloat16*>(k_pool);
  auto* vp = static_cast<__nv_bfloat16*>(v_pool);
  const auto* tp = static_cast<const int*>(tables);
  const auto* lp = static_cast<const int*>(lens);
  const auto* qlp = static_cast<const int*>(qlens);
  append_write_kernel<<<dim3(S, B), NTHREADS, 0, s>>>(
      kp, vp, tp, lp, qlp, static_cast<const __nv_bfloat16*>(new_k), nk_b,
      nk_s, static_cast<const __nv_bfloat16*>(new_v), nv_b, nv_s, Hkv, D, bs,
      MB, NB);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  SplitParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.q_b = q_b;
  p.q_s = q_s;
  p.k_pool = kp;
  p.v_pool = vp;
  p.tables = tp;
  p.lens = lp;
  p.qlens = qlp;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.scratch = static_cast<float*>(scratch);
  p.counters = static_cast<int*>(counters);
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.bs = bs;
  p.MB = MB;
  p.NB = NB;
  p.krows = SPLIT_ROWS;
  p.scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid(append_tiles(S, Hq / Hkv), Hkv, B);
  if (D == 128)
    return (int)launch_split<128>(append_split_kernel<128>, grid, s, tk, tv,
                                  p);
  return (int)launch_split<64>(append_split_kernel<64>, grid, s, tk, tv, p);
}

// Holds the wrapper's launch geometry (append_launch_config) against the
// constants and the split rule's numbers here; 0 when every number agrees.
extern "C" int pt_paged_attention_append_check_launch(
    int B, int S, int Hq, int Hkv, int D, int bs, int MB, int grid_x,
    int grid_y, int grid_z, int smem_bytes, int stages, int threads,
    int krows, int max_splits, int split_max_rows, int split_min_pos) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || bs <= 0 || MB <= 0 ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  const int smem =
      D == 128 ? SplitSmem<128>::kBytes : SplitSmem<64>::kBytes;
  const bool ok = grid_x == append_tiles(S, Hq / Hkv) && grid_y == Hkv &&
                  grid_z == B && smem_bytes == smem &&
                  stages == split_stages(D) && threads == SPLIT_THREADS &&
                  krows == SPLIT_ROWS && max_splits == APPEND_MAX_SPLITS &&
                  split_max_rows == APPEND_SPLIT_MAX_ROWS &&
                  split_min_pos == APPEND_SPLIT_MIN_POS;
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// B3's split rule for one sequence, as the kernel applies it (for the card
// tests, which hold it against append_tile_splits).
extern "C" int pt_paged_attention_append_splits(int L, int QL, int S, int G,
                                                int bs, int MB) {
  return append_splits(L, QL, S, G, bs, MB, append_tiles(S, G));
}

#define PT_ENTRY(NAME, BITS)                                                  \
  extern "C" int NAME(const void* q, long long q_b, long long q_s,            \
                      void* k_pool, void* v_pool, void* k_scale,              \
                      void* v_scale, const void* tables, const void* lens,    \
                      const void* qlens, const void* new_k, long long nk_b,   \
                      long long nk_s, const void* new_v, long long nv_b,      \
                      long long nv_s, void* out, int B, int S, int Hq,        \
                      int Hkv, int D, int bs, int MB, int NB, float scale,    \
                      void* stream) {                                         \
    return dispatch<BITS>(q, q_b, q_s, k_pool, v_pool, k_scale, v_scale,      \
                          tables, lens, qlens, new_k, nk_b, nk_s, new_v,      \
                          nv_b, nv_s, out, B, S, Hq, Hkv, D, bs, MB, NB,      \
                          scale, stream);                                     \
  }
PT_ENTRY(pt_paged_attention_append_int8, 8)
PT_ENTRY(pt_paged_attention_append_int4, 4)
#undef PT_ENTRY

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
