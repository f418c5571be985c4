// The kv walk that kernels B2 (paged_attention_decode.cu) and B3 (the bf16
// form of paged_attention_append.cu) share on Hopper (sm_90a): a tile of
// query rows attends a span of whole pool blocks that arrive by TMA through
// an mbarrier ring, and a walk too long for one SM is split across CTAs
// whose fp32 partials merge in a fixed order.
//
// Pools [NB, Hkv, bs, D] bf16 are read as one 2-D tensor [NB*Hkv*bs, D]:
// the bs rows of (block, kv head) are consecutive, so a box of `br` rows
// and 64 columns (128 bytes, 128-byte swizzle) is one TMA load, and each
// row's columns land in 16-byte chunks XORed with (row & 7): ldmatrix then
// reads the mma.sync fragments without bank conflicts, unpadded. A block
// of bs <= 64 rows is one box (br = bs); a longer block is two (br =
// ceil(bs / 2)). A ring stage holds 64 tile rows of K and of V: box slots
// of brs = br rounded up to 8 rows (so every box starts 1024-byte aligned,
// as the swizzle wants), bps = 64 / brs of them. The producer packs only
// the live boxes of its walk into stages (a -1 table entry costs nothing)
// and writes each tile row's position, or -1, beside the stage.
//
// One CTA = 4 consumer warps + 1 producer warp (160 threads). The producer
// counts the walk's boxes, then issues them stage by stage; a stage is
// refilled once all four consumers have released it (empty barrier). The
// consumers hold q as bf16 A fragments and run S = q K^T and O += P V on
// mma.sync.m16n8k16 (bf16 in, fp32 out) 16 positions at a time, with the
// online softmax in fp32 registers in log2 units, P rounded to bf16 for the
// product. A tile of more than 16 real rows gives each warp 16 rows and
// every position (rows mode); a tile of at most 16 (a decode step's G
// heads, a chunk's short tail) gives every warp the same rows and a
// quarter of each stage's positions (positions mode), and the four warps'
// (m, l, acc) merge in shared memory at the end. The products are a small
// share of the work (the bound is bytes), so mma.sync's rate is enough.
//
// Merge: a walk split k ways writes (acc, m, l) of its real rows to float32
// scratch (rows region*krows + split*R + row, D + 2 floats each); the CTA
// whose atomicAdd on the (sequence, kv head) counter completes the count
// reads all k in split order 0, 1, ..., writes out = acc / max(l, 1e-30)
// and resets the counter to 0 for the next launch. The same inputs give
// the same bits on every run; no float atomics. A split that sees nothing
// (-1 blocks, rows masked causally) has m = -inf, l = 0 and weighs 0; a
// row that sees nothing at all comes out 0, as in the plain versions.
//
// Rows of a visited block past the walk's last position are read and
// masked, as the plain versions read whole blocks; box slots that TMA never
// fills are zeroed once at the start, so no stale shared memory enters P V.
//
// Quantized pools (BITS 8 or 4, kernel B4; csrc/kv_quant.cuh): payload
// [NB, Hkv, bs, Dp] bytes (int8: Dp = D; int4: Dp = D / 2, split-half
// nibbles) is read as a 2-D byte tensor [NB*Hkv*bs, Dp], one box of a
// whole row (Dp = 128, 64 or 32 bytes, swizzled at the same width, so
// ldmatrix reads it without bank conflicts). A stage is half (int8) or a
// quarter (int4) of a bf16 stage, so the ring is deeper (SplitSmem). The
// producer writes each tile row's k_scale * scale_log2 and v_scale beside
// its position. The consumers take mma.sync fragments straight from the
// byte tiles: ldmatrix (b16) gives a thread four bytes of one row, K's
// bytes 4t .. 4t + 3 of a 16-byte chunk (ldmatrix.trans: V's bytes 2g,
// 2g + 1 of two positions), and an exact byte-to-bf16 conversion (the grid
// values |g| <= 127 are bf16 numbers) pairs bytes (0, 2) and (1, 3). So a
// k-step holds head dims 16kk + 4t + {0, 2} and {1, 3}, and q's A
// fragments are loaded in that order; an output n8 tile holds every other
// dim of a chunk (int4: of a nibble half), and the epilogue writes each
// accumulator to its dim (quant_dim). S's columns are multiplied by the
// K factor before the mask and the max, P's columns by the V scale after
// l has summed P and before P is rounded to bf16, as the append kernel's
// first design did: no dequantized value is ever rounded (B4-decode keeps
// P * v_scale to float32 precision, as three exact bf16 terms; see
// paged_attention_decode.cu). Decode gives the
// last block j_last a split of its own: that CTA alone requantizes the
// block in shared memory once TMA has landed it (kv_requant, the write
// pass's operations, so payload and scale are bit for bit the plain
// version's), writes payload and scale back, and attends the block from
// the round-tripped values under the new scale, while the other splits
// walk the history.
#pragma once

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"   // mma16816, ldsm_x4, split3_bf16, pack_bf16
#include "kv_quant.cuh"       // kv_requant
#include "sm90_common.cuh"    // mbarriers, TMA, named barriers, tensor maps

namespace {

constexpr int SPLIT_ROWS = 64;   // q rows of a tile; tile rows of a stage
constexpr int SPLIT_CWARPS = 4;  // consumer warps
constexpr int SPLIT_CONSUMERS = 32 * SPLIT_CWARPS;
constexpr int SPLIT_THREADS = SPLIT_CONSUMERS + 32;   // + the producer warp
constexpr int SPLIT_BAR = 1;     // the consumers' named barrier

// B3's split rule (the last real tile of a sequence only): at most this
// many splits, for a tile of at most this many real rows, each split at
// least this many positions long.
constexpr int APPEND_MAX_SPLITS = 8;
constexpr int APPEND_SPLIT_MAX_ROWS = 32;
constexpr int APPEND_SPLIT_MIN_POS = 256;

// Stages of the ring: bf16 3 at D 128, 4 at D 64 (96 and 64 KB); a byte
// pool (BITS 8 or 4) as many as fit those bytes, at most 8.
__host__ __device__ constexpr int split_stages(int D, int BITS = 16) {
  return BITS == 16 ? (D == 128 ? 3 : 4)
         : ((D == 128 ? 98304 : 65536) / (2 * SPLIT_ROWS * D * BITS / 8) < 8
                ? (D == 128 ? 98304 : 65536) / (2 * SPLIT_ROWS * D * BITS / 8)
                : 8);
}

// Byte offsets of the dynamic shared memory from its 1024-byte-aligned
// start (the first 1024 bytes of the allocation are alignment slack):
// the ring, each tile row's position per stage, for a byte pool each tile
// row's K factor and V scale per stage, full and empty mbarriers, and two
// ints (the walk's box count, the last-CTA flag; a byte pool: then the
// requantization's scratch).
template <int D, int BITS = 16>
struct SplitSmem {
  static constexpr int kRowBytes = D * BITS / 8;     // a pool row as stored
  static constexpr int kStages = split_stages(D, BITS);
  static constexpr int kTile = SPLIT_ROWS * kRowBytes;   // one K or V tile
  static constexpr int kPos = kStages * 2 * kTile;
  static constexpr int kScl = kPos + kStages * SPLIT_ROWS * 4;
  static constexpr int kBars =
      kScl + (BITS < 16 ? kStages * 2 * SPLIT_ROWS * 4 : 0);
  static constexpr int kMisc = kBars + kStages * 16;
  // two ints; a byte pool's decode also keeps its block requantization's
  // reduction (8 words) and byte table (256 bytes) there
  static constexpr int kBytes = 1024 + kMisc + (BITS < 16 ? 304 : 16);
  // the epilogue's per-row (acc, m, l) reuse the ring
  static_assert(SPLIT_ROWS * (D + 2) * 4 <= kPos, "epilogue rows fit");
};

struct PoolBoxes {
  int br;    // rows of one TMA box
  int nbb;   // boxes per pool block
  int brs;   // tile rows of a box slot (br rounded up to 8)
  int bps;   // box slots per stage
};

__host__ __device__ inline PoolBoxes pool_boxes(int bs) {
  PoolBoxes x;
  x.nbb = bs <= SPLIT_ROWS ? 1 : 2;
  x.br = (bs + x.nbb - 1) / x.nbb;
  x.brs = (x.br + 7) & ~7;
  x.bps = SPLIT_ROWS / x.brs;
  return x;
}

// B3: the number of CTAs that walk the last real tile of a sequence with
// L cached positions and QL new rows (1: the tile is not split). Only a
// tile of few real rows (R <= APPEND_SPLIT_MAX_ROWS) splits, so the
// partials are at most R / 128 of its walk's bytes; the extra CTAs are the
// grid's padding tiles after it (n_tiles - 1 - t_last of them), so the
// host sizes the grid from S, G, Hkv and B alone. k * R <= 64: the
// scratch holds 64 rows per (sequence, kv head).
__host__ __device__ inline int append_splits(int L, int QL, int S, int G,
                                             int bs, int MB, int n_tiles) {
  const int ql = QL < S ? QL : S;
  const int real = ql * G;
  if (real <= 0) return 1;
  const int t_last = (real - 1) / SPLIT_ROWS;
  const int R = real - t_last * SPLIT_ROWS;
  if (R > APPEND_SPLIT_MAX_ROWS) return 1;
  const int max_lim = L + ql - 1;
  const int jl = max_lim / bs < MB - 1 ? max_lim / bs : MB - 1;
  const long long cap = (long long)MB * bs;
  const long long npos = (long long)max_lim + 1 < cap ? max_lim + 1 : cap;
  int k = n_tiles - t_last;
  k = k < APPEND_MAX_SPLITS ? k : APPEND_MAX_SPLITS;
  k = k < SPLIT_ROWS / R ? k : SPLIT_ROWS / R;
  k = k < npos / APPEND_SPLIT_MIN_POS ? k : (int)(npos / APPEND_SPLIT_MIN_POS);
  k = k < jl + 1 ? k : jl + 1;
  return k > 1 ? k : 1;
}

struct SplitParams {
  const __nv_bfloat16* q;   // row (b, i, head h) at q + b*q_b + i*q_s + h*D
  long long q_b, q_s;
  __nv_bfloat16* k_pool;    // B2: the new row's write
  __nv_bfloat16* v_pool;
  const int* tables;
  const int* lens;
  const int* qlens;         // B3 only
  const __nv_bfloat16* new_k;   // B2 only: [B, Hkv, D] rows at b * nk_b
  long long nk_b;
  const __nv_bfloat16* new_v;
  long long nv_b;
  __nv_bfloat16* out;       // row (b, i, h) at out + ((b*S + i)*Hq + h)*D
  float* scratch;           // partials: krows rows of D + 2 per (b, kv head)
  int* counters;            // one per (b, kv head), 0 between launches
  uint8_t* kq;              // B4: payload pools, their scales [NB, Hkv]
  uint8_t* vq;
  float* k_scale;
  float* v_scale;
  int S, Hq, Hkv, bs, MB, NB;
  int span;                 // B2: pool blocks per split
  int krows;
  float scale_log2;
};

// The byte offset of 16-byte chunk `chunk` of tile row `row` in a swizzled
// tile: 64-column blocks of 64 rows x 128 bytes, one after another.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)((chunk >> 3) * (SPLIT_ROWS * 128) + row * 128 +
                    (((chunk & 7) ^ (row & 7)) << 4));
}

// The same for a byte tile of RB-byte rows (RB = 128, 64 or 32), swizzled
// as TMA's 128-, 64- or 32-byte mode writes it: 16-byte chunk c of row r
// XORed with the bits of the row's offset above 128 bytes.
template <int RB>
__device__ __forceinline__ uint32_t swzb(int row, int chunk) {
  return (uint32_t)(row * RB +
                    ((chunk ^ ((row * RB >> 7) & (RB / 16 - 1))) << 4));
}

// Four int8 grid values (bytes 0-3 of w) as two exact bf16x2: bytes (0, 2)
// and (1, 3). Each byte, biased by 128, becomes the low byte of the float
// 2^23 + u; subtracting 2^23 + 128 leaves the value, whose high half is
// its bf16 (eight significant bits at most).
__device__ __forceinline__ void i8x4_bf16(uint32_t w, uint32_t& even,
                                          uint32_t& odd) {
  const uint32_t u = w ^ 0x80808080u;
  const float bias = 8388736.f;   // 2^23 + 128
  const uint32_t f0 = __float_as_uint(
      __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)), bias));
  const uint32_t f1 = __float_as_uint(
      __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)), bias));
  const uint32_t f2 = __float_as_uint(
      __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)), bias));
  const uint32_t f3 = __float_as_uint(
      __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)), bias));
  even = __byte_perm(f0, f2, 0x7632);
  odd = __byte_perm(f1, f3, 0x7632);
}

// The nibbles at bit `shift` of bytes 0 and 2 of w (int4, stored + 8) as
// an exact bf16x2: 128 + n in bf16, minus 136.
__device__ __forceinline__ uint32_t i4x2_bf16(uint32_t w, int shift) {
  uint32_t x = ((w >> shift) & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(
      *reinterpret_cast<const __nv_bfloat162*>(&x),
      __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The head dim of accumulator e (0, 1) of output n8 tile n for a thread of
// quad index t, on a byte pool of Dp-byte rows: int8 tile n = 2c + s holds
// dims 16c + 4t + 2e + s; int4 tile n = 4c + 2h + s holds nibble half h,
// dims h*Dp + 16c + 4t + 2e + s.
template <int BITS>
__device__ __forceinline__ int quant_dim(int n, int e, int t, int Dp) {
  if constexpr (BITS == 8) return 16 * (n >> 1) + 4 * t + 2 * e + (n & 1);
  return ((n >> 1) & 1) * Dp + 16 * (n >> 2) + 4 * t + 2 * e + (n & 1);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// O += P V for a thread that keeps only rows g of the 16-row tile (rows
// g + 8 are padding): their accumulators are temporaries.
__device__ __forceinline__ void mma16816_lo(float (&c)[2],
                                            const uint32_t a[4],
                                            const uint32_t b[2]) {
  float x[4] = {c[0], c[1], 0.f, 0.f};
  mma16816(x, a, b);
  c[0] = x[0];
  c[1] = x[1];
}

// Merges n entries of (acc[D], m, l) `stride` floats apart, in order, at
// columns d0 .. d0 + 7: acc and l rescaled to M, the largest m. All m =
// -inf (nothing seen) gives zeros. Partials in device memory are read past
// L1.
template <int D, bool GLOBAL>
__device__ __forceinline__ void merge8(const float* base, int n, long stride,
                                       int d0, float (&acc)[8], float& M,
                                       float& lsum) {
  auto ld = [](const float* p) {
    if constexpr (GLOBAL) return __ldcg(p);
    else return *p;
  };
  M = -INFINITY;
  for (int e = 0; e < n; ++e) M = fmaxf(M, ld(base + e * stride + D));
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  lsum = 0.f;
  if (M == -INFINITY) return;
  for (int e = 0; e < n; ++e) {
    const float* ep = base + e * stride;
    const float w = exp2f(ld(ep + D) - M);
    lsum += w * ld(ep + D + 1);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += w * ld(ep + d0 + i);
  }
}

// DECODE (B2): grid (split, kv head, b); the tile is the G query heads of
// one new token, the walk is blocks [split*span, +span) of 0 .. j_last,
// and the CTA owning j_last writes the new K/V row. Otherwise (B3): grid
// (64-row tile, kv head, b) over the S*G rows of a head group, row
// r = i*G + g; the pools already hold the chunk's rows (the write pass
// ran first). BITS 8 or 4: the same over a byte pool (B4); in decode the
// spans cover blocks 0 .. j_last - 1 and split k - 1 owns j_last alone.
template <int D, bool DECODE, int BITS = 16>
__device__ __forceinline__ void split_walk(const CUtensorMap* tmk,
                                           const CUtensorMap* tmv,
                                           const SplitParams& p) {
  using Sm = SplitSmem<D, BITS>;
  constexpr bool QUANT = BITS < 16;
  constexpr int STAGES = Sm::kStages;
  constexpr int KD = D / 16;   // k-steps of S over the head dim
  constexpr int ND = D / 8;    // n8 tiles of an output row
  constexpr int CH = D / 8;    // 16-byte chunks of a bf16 row
  constexpr int RB = Sm::kRowBytes;   // bytes of a pool row
  constexpr int NC = RB / 16;  // 16-byte chunks of a pool row
  constexpr int LDC = D + 2;   // floats of one (acc, m, l) row
  // rows a thread holds: g and g + 8 of its warp's 16, or only g in B2,
  // whose G <= 8 heads leave rows 8-15 of the tile empty
  constexpr int HR = DECODE ? 1 : 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (ring - raw);
  int* const pos_s = reinterpret_cast<int*>(smem + Sm::kPos);
  // byte pools: [stage][K factor, V scale][tile row]
  float* const scl_s = reinterpret_cast<float*>(smem + Sm::kScl);
  int* const misc = reinterpret_cast<int*>(smem + Sm::kMisc);
  const uint32_t bars = ring + Sm::kBars;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const int L = p.lens[b];
  const int QL = DECODE ? 1 : min(p.qlens[b], p.S);
  const int* trow = p.tables + (long)b * p.MB;
  const int region = b * p.Hkv + kvh;
  auto out_row = [&](int r) {
    return p.out + (((long)b * p.S + r / G) * p.Hq + kvh * G + r % G) * D;
  };
  auto zero_rows = [&](int ra, int rb) {
    for (int c = tid; c < (rb - ra) * CH; c += SPLIT_THREADS)
      *reinterpret_cast<uint4*>(out_row(ra + c / CH) + (c % CH) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  };

  // the tile's rows [r0, r0 + R) (all real), its split of k, and the walk:
  // blocks [jb, je), positions <= max_lim
  int r0, R, k, split, jb, je, max_lim;
  if constexpr (DECODE) {
    const int j_last = min(L / p.bs, p.MB - 1);
    split = blockIdx.x;
    if constexpr (QUANT) {
      const int nh = (j_last + p.span - 1) / p.span;   // history splits
      k = nh + 1;
      if (split >= k) return;
      jb = split < nh ? split * p.span : j_last;
      je = split < nh ? min(jb + p.span, j_last) : j_last + 1;
    } else {
      k = j_last / p.span + 1;
      if (split >= k) return;   // the span lies past the last live block
      jb = split * p.span;
      je = min(jb + p.span, j_last + 1);
    }
    r0 = 0;
    R = G;
    max_lim = L;
  } else {
    const int rows_total = p.S * G, real = max(QL, 0) * G;
    const int t = blockIdx.x, ta = t * SPLIT_ROWS;
    const int tb = min(ta + SPLIT_ROWS, rows_total);
    const int t_last = real > 0 ? (real - 1) / SPLIT_ROWS : -1;
    const int k_last =
        real > 0 ? append_splits(L, QL, p.S, G, p.bs, p.MB, gridDim.x) : 1;
    if (t > t_last) {
      // a tile of padding rows: zeros, then maybe a split of the last tile
      zero_rows(ta, tb);
      split = t - t_last;
      if (t_last < 0 || split >= k_last) return;
      r0 = t_last * SPLIT_ROWS;
      k = k_last;
    } else {
      r0 = ta;
      split = 0;
      k = t == t_last ? k_last : 1;
      zero_rows(min(real, tb), tb);   // the tile's own padding rows
    }
    R = min(SPLIT_ROWS, real - r0);
    max_lim = L + (r0 + R - 1) / G;
    const int J = min(max_lim / p.bs, p.MB - 1) + 1;
    jb = (int)((long long)J * split / k);
    je = (int)((long long)J * (split + 1) / k);
  }
  const bool pos_mode = R <= 16;
  const PoolBoxes bx = pool_boxes(p.bs);
  const bool owner = DECODE && split == k - 1;
  // B4-decode's owner walks j_last alone and loads it even when its entry
  // is -1 (block 0's content, requantized into scratch, not attended)
  const bool qowner = QUANT && owner;
  auto walked = [&](int j) { return qowner || trow[j] >= 0; };
  auto src_block = [&](int j) { return qowner ? max(trow[j], 0) : trow[j]; };

  if (warp == SPLIT_CWARPS) {   // the producer warp counts the walk's boxes
    if (lane == 0) {
      tma_prefetch(tmk);
      tma_prefetch(tmv);
    }
    int n = 0;
    for (int j = jb + lane; j < je; j += 32)
      if (walked(j))
        n += 1 + (bx.nbb == 2 && j * p.bs + bx.br <= max_lim);
    n = __reduce_add_sync(0xffffffffu, n);
    if (lane == 0) misc[0] = n;
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), SPLIT_CWARPS);
    }
    mbar_fence_init();
  }
  if constexpr (!QUANT) {
    if (bx.br < SPLIT_ROWS) {
      // box slots TMA may never fill: zeros, not stale bits, enter P V
      // (every byte of a byte pool is a finite grid value)
      for (int c = tid; c < STAGES * 2 * Sm::kTile / 16; c += SPLIT_THREADS)
        *reinterpret_cast<uint4*>(smem + c * 16) = make_uint4(0u, 0u, 0u, 0u);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
  }
  __syncthreads();
  const int n_boxes = misc[0];
  const int n_stages = (n_boxes + bx.bps - 1) / bx.bps;

  if (warp == SPLIT_CWARPS) {
    // producer: every lane walks the same cursor (block j, box bi); the
    // lanes write the stage's positions (and a byte pool's scales), lane 0
    // issues its TMA loads
    int j = jb, bi = 0;
    while (j < je && !walked(j)) ++j;
    auto advance = [&]() {
      if (++bi < bx.nbb && j * p.bs + bi * bx.br <= max_lim) return;
      bi = 0;
      do ++j; while (j < je && !walked(j));
    };
    for (int st = 0; st < n_stages; ++st) {
      const int s = st % STAGES;
      if (st >= STAGES) mbar_wait(empty(s), ((st / STAGES) - 1) & 1);
      const int nb = min(bx.bps, n_boxes - st * bx.bps);
      const int j0 = j, bi0 = bi;
      int* ps = pos_s + s * SPLIT_ROWS;
      float* ss = scl_s + s * 2 * SPLIT_ROWS;
      for (int kb = 0; kb < bx.bps; ++kb) {
        int p0 = 0, nr = 0;
        float kf = 0.f, vf = 0.f;
        if (kb < nb) {
          p0 = j * p.bs + bi * bx.br;
          nr = QUANT && trow[j] < 0 ? 0 : min(bx.br, p.bs - bi * bx.br);
          if constexpr (QUANT) {
            const long si = (long)src_block(j) * p.Hkv + kvh;
            kf = p.k_scale[si] * p.scale_log2;
            vf = p.v_scale[si];
          }
          advance();
        }
        for (int w = lane; w < bx.brs; w += 32) {
          ps[kb * bx.brs + w] = w < nr ? p0 + w : -1;
          if constexpr (QUANT) {
            ss[kb * bx.brs + w] = kf;
            ss[SPLIT_ROWS + kb * bx.brs + w] = vf;
          }
        }
      }
      for (int r = bx.bps * bx.brs + lane; r < SPLIT_ROWS; r += 32) {
        ps[r] = -1;
        if constexpr (QUANT) ss[r] = ss[SPLIT_ROWS + r] = 0.f;
      }
      __syncwarp();
      if (lane == 0) {
        if constexpr (QUANT)
          mbar_arrive_expect_tx(full(s), nb * 2 * bx.br * RB);
        else
          mbar_arrive_expect_tx(full(s), nb * 2 * (D / 64) * bx.br * 128);
      }
      j = j0;
      bi = bi0;
      for (int kb = 0; kb < nb; ++kb) {
        if (lane == 0) {
          const int row = (src_block(j) * p.Hkv + kvh) * p.bs + bi * bx.br;
          if constexpr (QUANT) {
            const uint32_t dst = ring + s * 2 * Sm::kTile + kb * bx.brs * RB;
            tma_load_2d(dst, tmk, full(s), 0, row);
            tma_load_2d(dst + Sm::kTile, tmv, full(s), 0, row);
          } else {
            const uint32_t dst = ring + s * 2 * Sm::kTile + kb * bx.brs * 128;
#pragma unroll
            for (int cb = 0; cb < D / 64; ++cb) {
              tma_load_2d(dst + cb * SPLIT_ROWS * 128, tmk, full(s), cb * 64,
                          row);
              tma_load_2d(dst + Sm::kTile + cb * SPLIT_ROWS * 128, tmv,
                          full(s), cb * 64, row);
            }
          }
        }
        advance();
      }
    }
    return;
  }

  // ---- consumers ----------------------------------------------------------
  const int g = lane >> 2, t = lane & 3;
  const int rbase = r0 + (pos_mode ? 0 : 16 * warp);
  const bool active = rbase < r0 + R;
  int lim[HR];
  uint32_t qa[KD][4];
  {
    const __nv_bfloat16* qrow[2] = {nullptr, nullptr};
#pragma unroll
    for (int hr = 0; hr < HR; ++hr) {
      const int r = rbase + g + 8 * hr;
      const int i = r / G;
      if (r < r0 + R)
        qrow[hr] = p.q + (long)b * p.q_b + (long)i * p.q_s +
                   (long)(kvh * G + r % G) * D;
      lim[hr] = L + min(i, QL - 1);
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if constexpr (QUANT) {
        // k-step kk holds dims 16kk + 4t + {0, 2} and + {1, 3}
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          uint2 x = make_uint2(0u, 0u);
          if (hr < HR && qrow[hr])
            x = *reinterpret_cast<const uint2*>(qrow[hr] + kk * 16 + t * 4);
          qa[kk][hr] = __byte_perm(x.x, x.y, 0x5410);
          qa[kk][hr + 2] = __byte_perm(x.x, x.y, 0x7632);
        }
      } else {
        const int c = kk * 16 + t * 2;
        qa[kk][0] = qrow[0] ? lds32(qrow[0] + c) : 0u;
        qa[kk][1] = HR == 2 && qrow[1] ? lds32(qrow[1] + c) : 0u;
        qa[kk][2] = qrow[0] ? lds32(qrow[0] + c + 8) : 0u;
        qa[kk][3] = HR == 2 && qrow[1] ? lds32(qrow[1] + c + 8) : 0u;
      }
    }
  }
  // B2: the CTA owning block j_last patches the new row into its last
  // stage (the pool row is written at the end, after every read)
  const int slot = L - (je - 1) * p.bs;
  const bool patch = !QUANT && owner && slot < p.bs && trow[je - 1] >= 0;

  if constexpr (QUANT && DECODE) {
    if (owner) {
      // B4-decode's owner: block j_last (box bi in stage bi) requantized
      // in place with the new row at `slot` and the rows past it zeroed,
      // payload and scale stored at tables[b, j_last] (the scratch block
      // for a -1 entry), then its rows attended under the new scale
      float* const red = reinterpret_cast<float*>(misc + 4);
      uint8_t* const table = reinterpret_cast<uint8_t*>(misc + 12);
      for (int st = 0; st < n_stages; ++st) mbar_wait(full(st), 0);
      const int phys = trow[je - 1];
      const long si = (long)max(phys, 0) * p.Hkv + kvh;
      const long ti = (long)(phys < 0 ? p.NB - 1 : phys) * p.Hkv + kvh;
      const bool two = bx.nbb == 2;
      const int br = bx.br;
      float ks_new = 0.f, vs_new = 0.f;
#pragma unroll 1
      for (int kv = 0; kv < 2; ++kv) {
        uint8_t* const tile = smem + kv * Sm::kTile;
        auto at = [&](int r, int c) {
          const int bi = two && r >= br;
          return tile + bi * 2 * Sm::kTile + swzb<RB>(r - bi * br, c >> 4) +
                 (c & 15);
        };
        const __nv_bfloat16* nrow =
            (kv ? p.new_v + (long)b * p.nv_b : p.new_k + (long)b * p.nk_b) +
            (long)kvh * D;
        const float sn = kv_requant<BITS, SPLIT_CONSUMERS>(
            at, (kv ? p.v_scale : p.k_scale)[si], p.bs, RB, slot + 1,
            [&](int r) { return r == slot ? nrow : nullptr; }, red, table,
            tid, [] { named_barrier_sync(SPLIT_BAR, SPLIT_CONSUMERS); });
        if (kv) vs_new = sn;
        else ks_new = sn;
        uint8_t* const dst = (kv ? p.vq : p.kq) + ti * p.bs * RB;
        for (int c = tid; c < p.bs * NC; c += SPLIT_CONSUMERS)
          *reinterpret_cast<uint4*>(dst + (long)(c / NC) * RB +
                                    (c % NC) * 16) =
              *reinterpret_cast<const uint4*>(at(c / NC, (c % NC) * 16));
      }
      if (tid == 0) {
        p.k_scale[ti] = ks_new;
        p.v_scale[ti] = vs_new;
      }
      for (int i = tid; i < n_stages * SPLIT_ROWS; i += SPLIT_CONSUMERS) {
        float* ss = scl_s + (i / SPLIT_ROWS) * 2 * SPLIT_ROWS + i % SPLIT_ROWS;
        ss[0] = ks_new * p.scale_log2;
        ss[SPLIT_ROWS] = vs_new;
      }
      named_barrier_sync(SPLIT_BAR, SPLIT_CONSUMERS);
    }
  }

  float o[ND][2 * HR];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 2 * HR; ++e) o[n][e] = 0.f;
  float m[HR], l[HR];   // l: per-thread partial row sums
#pragma unroll
  for (int hr = 0; hr < HR; ++hr) {
    m[hr] = -INFINITY;
    l[hr] = 0.f;
  }
  const int sl0 = pos_mode ? warp : 0;
  const int sl1 = pos_mode ? warp + 1 : SPLIT_ROWS / 16;
  // O += P V on one B fragment (rows g + 8 are padding in B2/B4-decode)
  auto pv = [](float (&acc)[2 * HR], const uint32_t (&a)[4],
               const uint32_t (&bf)[2]) {
    if constexpr (HR == 2) mma16816(acc, a, bf);
    else mma16816_lo(acc, a, bf);
  };
  // B4's S += q K^T on one B fragment; B4-decode keeps only rows g of S
  auto qk = [](float (&acc)[4], const uint32_t (&a)[4],
               const uint32_t (&bf)[2]) {
    if constexpr (HR == 2) {
      mma16816(acc, a, bf);
    } else {
      float lo[2] = {acc[0], acc[1]};
      mma16816_lo(lo, a, bf);
      acc[0] = lo[0];
      acc[1] = lo[1];
    }
  };

  for (int st = 0; st < n_stages; ++st) {
    const int s = st % STAGES;
    mbar_wait(full(s), (st / STAGES) & 1);
    const int* ps = pos_s + s * SPLIT_ROWS;
    const float* ss = scl_s + s * 2 * SPLIT_ROWS;
    const uint32_t kt = ring + s * 2 * Sm::kTile, vt = kt + Sm::kTile;
    if (patch && st == n_stages - 1) {
      if (tid < SPLIT_ROWS && ps[tid] == L) {
        const uint4* nk = reinterpret_cast<const uint4*>(
            p.new_k + (long)b * p.nk_b + (long)kvh * D);
        const uint4* nv = reinterpret_cast<const uint4*>(
            p.new_v + (long)b * p.nv_b + (long)kvh * D);
#pragma unroll 1   // once per CTA: keep its 16-byte loads out of registers
        for (int c = 0; c < CH; ++c) {
          *reinterpret_cast<uint4*>(smem + (kt - ring) + swz(tid, c)) = nk[c];
          *reinterpret_cast<uint4*>(smem + (vt - ring) + swz(tid, c)) = nv[c];
        }
      }
      named_barrier_sync(SPLIT_BAR, SPLIT_CONSUMERS);
    }
    if (active) {
      for (int sl = sl0; sl < sl1; ++sl) {
        const int tr0 = sl * 16;
        float sc[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
        if constexpr (QUANT) {
          // kf[2h + n]: positions tr0 + 8n .. + 7, bytes of chunk c + h
#pragma unroll
          for (int c = 0; c < NC; c += 2) {
            uint32_t kf[4];
            ldsm_x4(kf, kt + swzb<RB>(tr0 + (((lane >> 3) & 1) << 3) +
                                          (lane & 7),
                                      c + (lane >> 4)));
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int n = 0; n < 2; ++n) {
                const uint32_t x = kf[2 * h + n];
                uint32_t bb[2];
                if constexpr (BITS == 8) {
                  i8x4_bf16(x, bb[0], bb[1]);
                  qk(sc[n], qa[c + h], bb);
                } else {
                  bb[0] = i4x2_bf16(x, 0);
                  bb[1] = i4x2_bf16(x, 8);
                  qk(sc[n], qa[c + h], bb);
                  bb[0] = i4x2_bf16(x, 4);
                  bb[1] = i4x2_bf16(x, 12);
                  qk(sc[n], qa[c + h + NC], bb);
                }
              }
            }
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < KD; ++kk) {
            uint32_t kf[4];
            ldsm_x4(kf, kt + swz(tr0 + ((lane >> 4) << 3) + (lane & 7),
                                 2 * kk + ((lane >> 3) & 1)));
            const uint32_t b0[2] = {kf[0], kf[1]}, b1[2] = {kf[2], kf[3]};
            mma16816(sc[0], qa[kk], b0);
            mma16816(sc[1], qa[kk], b1);
          }
        }
        // mask (a live position at or before the row's own), then the
        // online-softmax update in log2 units; a byte pool's K factor
        // (k_scale * scale_log2) multiplies the column first
        float mx[HR], msub[HR], alpha[HR];
#pragma unroll
        for (int r = 0; r < HR; ++r) mx[r] = m[r];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 2 * HR; ++e) {
            const int col = tr0 + n * 8 + t * 2 + (e & 1);
            const int pp = ps[col];
            const bool ok = pp >= 0 && pp <= lim[e >> 1];
            const float f = QUANT ? ss[col] : p.scale_log2;
            sc[n][e] = ok ? sc[n][e] * f : -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
          }
        }
#pragma unroll
        for (int r = 0; r < HR; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          msub[r] = (mx[r] == -INFINITY) ? 0.f : mx[r];
          alpha[r] = exp2f(m[r] - msub[r]);   // m = -inf -> 0 (o, l are 0)
          m[r] = mx[r];
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 2 * HR; ++e) {
            sc[n][e] = exp2f(sc[n][e] - msub[e >> 1]);
            l[e >> 1] += sc[n][e];
          }
        }
#pragma unroll
        for (int n = 0; n < ND; ++n)
#pragma unroll
          for (int e = 0; e < 2 * HR; ++e) o[n][e] *= alpha[e >> 1];
        if constexpr (QUANT) {
          // P's column takes its key's V scale (after l summed P)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 2 * HR; ++e)
              sc[n][e] *= ss[SPLIT_ROWS + tr0 + n * 8 + t * 2 + (e & 1)];
        }
        // O += P V: the score accumulators are P's A fragment
        const uint32_t pa[4] = {
            pack_bf16(sc[0][0], sc[0][1]),
            HR == 2 ? pack_bf16(sc[0][2], sc[0][3]) : 0u,
            pack_bf16(sc[1][0], sc[1][1]),
            HR == 2 ? pack_bf16(sc[1][2], sc[1][3]) : 0u};
        // B4-decode keeps P * v_scale to float32 precision, as three exact
        // bf16 terms (three products a fragment): one bf16 rounding moves
        // an output of one or two positions by up to 2^-9 of itself, a
        // step of its bf16 rounding at [2, 4), more than PAGED_TOL
        constexpr int NTERM = QUANT && DECODE ? 3 : 1;
        uint32_t pt[NTERM][4];
        if constexpr (NTERM == 3) {
          uint32_t t0[3], t1[3];
          split3_bf16(sc[0][0], sc[0][1], t0);
          split3_bf16(sc[1][0], sc[1][1], t1);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            pt[i][0] = t0[i];
            pt[i][1] = 0u;
            pt[i][2] = t1[i];
            pt[i][3] = 0u;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) pt[0][i] = pa[i];
        }
        auto pvq = [&](float (&acc)[2 * HR], const uint32_t (&bf)[2]) {
#pragma unroll
          for (int i = NTERM - 1; i >= 0; --i) pv(acc, pt[i], bf);
        };
        if constexpr (QUANT) {
          // vf[2h], vf[2h + 1]: positions 0-7, 8-15 of chunk c + h, two
          // positions' bytes 2g, 2g + 1 a thread
#pragma unroll
          for (int c = 0; c < NC; c += 2) {
            uint32_t vf[4];
            ldsm_x4_trans(vf, vt + swzb<RB>(tr0 + (((lane >> 3) & 1) << 3) +
                                                (lane & 7),
                                            c + (lane >> 4)));
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int cc = c + h;
              if constexpr (BITS == 8) {
                uint32_t e0, o0, e1, o1;
                i8x4_bf16(vf[2 * h], e0, o0);
                i8x4_bf16(vf[2 * h + 1], e1, o1);
                const uint32_t be[2] = {e0, e1}, bo[2] = {o0, o1};
                pvq(o[2 * cc], be);
                pvq(o[2 * cc + 1], bo);
              } else {
#pragma unroll
                for (int hs = 0; hs < 4; ++hs) {   // nibble half, odd byte
                  const int sh = 4 * (hs >> 1) + 8 * (hs & 1);
                  const uint32_t bb[2] = {i4x2_bf16(vf[2 * h], sh),
                                          i4x2_bf16(vf[2 * h + 1], sh)};
                  pvq(o[4 * cc + hs], bb);
                }
              }
            }
          }
        } else {
#pragma unroll
          for (int nn = 0; nn < D / 16; ++nn) {
            uint32_t vf[4];
            ldsm_x4_trans(vf, vt + swz(tr0 + (((lane >> 3) & 1) << 3) + (lane & 7),
                                       2 * nn + (lane >> 4)));
            const uint32_t b0[2] = {vf[0], vf[1]}, b1[2] = {vf[2], vf[3]};
            pv(o[2 * nn], pa, b0);
            pv(o[2 * nn + 1], pa, b1);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }
#pragma unroll
  for (int r = 0; r < HR; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (!QUANT && owner && warp == 0 && slot < p.bs && lane < 2 * CH) {
    // B2's fused write, after every TMA read of this CTA has landed: the
    // new row at `slot` of block tables[b, j_last], or of the scratch
    // block (the pool's last) for a -1 entry; past the table, dropped
    const int phys = trow[je - 1];
    const long off =
        (((long)(phys < 0 ? p.NB - 1 : phys) * p.Hkv + kvh) * p.bs + slot) * D;
    const int c = lane % CH;
    const bool isv = lane >= CH;
    const __nv_bfloat16* src = (isv ? p.new_v + (long)b * p.nv_b
                                    : p.new_k + (long)b * p.nk_b) +
                               (long)kvh * D;
    *reinterpret_cast<uint4*>((isv ? p.v_pool : p.k_pool) + off + c * 8) =
        reinterpret_cast<const uint4*>(src)[c];
  }

  // ---- epilogue: each warp's rows to shared memory, then merged ---------
  named_barrier_sync(SPLIT_BAR, SPLIT_CONSUMERS);   // the ring is free
  float* const comb = reinterpret_cast<float*>(smem);   // [64][D + 2]
#pragma unroll
  for (int hr = 0; hr < HR; ++hr) {
    float* cr = comb + (16 * warp + g + 8 * hr) * LDC;
    if constexpr (QUANT) {
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          cr[quant_dim<BITS>(n, e, t, RB)] = o[n][2 * hr + e];
    } else {
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(cr + n * 8 + t * 2) =
            make_float2(o[n][2 * hr], o[n][2 * hr + 1]);
    }
    if (t == 0) {
      cr[D] = m[hr];
      cr[D + 1] = l[hr];
    }
  }
  named_barrier_sync(SPLIT_BAR, SPLIT_CONSUMERS);
  auto store = [&](int rr, int d0, const float (&acc)[8], float lsum) {
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    uint4 v;
    v.x = pack_bf16(acc[0] * inv, acc[1] * inv);
    v.y = pack_bf16(acc[2] * inv, acc[3] * inv);
    v.z = pack_bf16(acc[4] * inv, acc[5] * inv);
    v.w = pack_bf16(acc[6] * inv, acc[7] * inv);
    *reinterpret_cast<uint4*>(out_row(r0 + rr) + d0) = v;
  };
  // positions mode: four entries per row (one per warp), 16 rows apart
  const int n_ent = pos_mode ? SPLIT_CWARPS : 1;
  float* const part = p.scratch + ((long)region * p.krows + split * R) * LDC;
  for (int c = tid; c < R * CH; c += SPLIT_CONSUMERS) {
    const int rr = c / CH, d0 = (c % CH) * 8;
    float acc[8], M, lsum;
    merge8<D, false>(comb + rr * LDC, n_ent, 16 * LDC, d0, acc, M, lsum);
    if (k == 1) {
      store(rr, d0, acc, lsum);
    } else {
      float* dst = part + rr * LDC;
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[d0 + i] = acc[i];
      if (d0 == 0) {
        dst[D] = M;
        dst[D + 1] = lsum;
      }
    }
  }
  if (k == 1) return;
  // the last of the k CTAs merges the partials, split 0 first
  __threadfence();
  named_barrier_sync(SPLIT_BAR, SPLIT_CONSUMERS);
  if (tid == 0) misc[1] = atomicAdd(p.counters + region, 1) == k - 1;
  named_barrier_sync(SPLIT_BAR, SPLIT_CONSUMERS);
  if (!misc[1]) return;
  __threadfence();
  const float* first = p.scratch + (long)region * p.krows * LDC;
  for (int c = tid; c < R * CH; c += SPLIT_CONSUMERS) {
    const int rr = c / CH, d0 = (c % CH) * 8;
    float acc[8], M, lsum;
    merge8<D, true>(first + rr * LDC, k, (long)R * LDC, d0, acc, M, lsum);
    store(rr, d0, acc, lsum);
  }
  if (tid == 0) p.counters[region] = 0;
}

// ---- host ----------------------------------------------------------------

// Validates what every split launch needs and encodes the pools' maps:
// bf16 pools [NB, Hkv, bs, D] (BITS 16), or byte pools of D * BITS / 8
// bytes a row.
template <int BITS = 16>
inline bool split_pool_maps(CUtensorMap* tk, CUtensorMap* tv,
                            const void* k_pool, const void* v_pool, int NB,
                            int Hkv, int bs, int D) {
  const long long rows = (long long)NB * Hkv * bs;
  if (rows >= (1ll << 31) ||
      (reinterpret_cast<uintptr_t>(k_pool) |
       reinterpret_cast<uintptr_t>(v_pool)) % 16)
    return false;
  const int br = pool_boxes(bs).br;
  if constexpr (BITS == 16) {
    return tensor_map_2d(tk, k_pool, rows, D, br,
                         CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 64,
                         CU_TENSOR_MAP_SWIZZLE_128B) &&
           tensor_map_2d(tv, v_pool, rows, D, br,
                         CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 64,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  } else {
    const int dp = D * BITS / 8;
    const CUtensorMapSwizzle sw = dp == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : dp == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
    return tensor_map_2d(tk, k_pool, rows, dp, br,
                         CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, dp, sw) &&
           tensor_map_2d(tv, v_pool, rows, dp, br,
                         CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, dp, sw);
  }
}

// Launches `kernel` with SplitSmem<D, BITS>::kBytes of dynamic shared
// memory, opting in above 48 KB once per kernel.
template <int D, int BITS = 16, typename K>
cudaError_t launch_split(K kernel, dim3 grid, cudaStream_t s,
                         const CUtensorMap& tk, const CUtensorMap& tv,
                         const SplitParams& prm) {
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SplitSmem<D, BITS>::kBytes);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  kernel<<<grid, SPLIT_THREADS, SplitSmem<D, BITS>::kBytes, s>>>(tk, tv, prm);
  return cudaGetLastError();
}

}  // namespace
