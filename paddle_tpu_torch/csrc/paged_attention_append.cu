// Paged-attention append step for Hopper (sm_90a), bf16 pools, fp32 math.
//
// Replaces: paddle_tpu/ops/kernels/paged_attention.py `_append_kernel`
// (:662), the Pallas TPU kernel launched through `paged_attention_append`
// (:784, pallas_call at :868), in its unquantized form with the fused
// multi-block write. It is the attention of the fused scheduler's mixed
// step: per sequence b, up to S new positions (q_lens[b] of them real)
// attend the pooled history plus their own chunk prefix.
//
// What it computes, for pools [NB, Hkv, bs, D], tables [B, MB] (-1 =
// unallocated), lens [B] (tokens already cached) and q_lens [B]:
// - row i < q_lens[b] writes its new K/V at position lens[b] + i into block
//   tables[b, (lens[b] + i) / bs]; a -1 entry routes the write to the pool's
//   last block (the engine's scratch block), a logical block >= MB drops;
//   padding rows and q_lens == 0 slots write nothing;
// - row i attends positions <= lens[b] + i of blocks
//   0 .. (lens[b] + q_lens[b] - 1) / bs, skipping -1 entries; fp32 online
//   softmax, P rounded to bf16 before P@V as the reference rounds it,
//   out = acc / max(l, 1e-30). Padding rows (i >= q_lens) and idle slots
//   get zeros.
//
// Bound on the H100: bytes. At the smoke's parity shape (B=8, S=256,
// Hq=Hkv=32, D=128, block 64, 808 real rows over lens up to 1999) the
// function reads ~62 MB of cached K/V (3,762 positions), ~13 MB of new K/V
// and ~6.6 MB of q, and writes ~13 MB of K/V and ~6.6 MB of out: ~101 MB,
// ~0.030 ms at 3.35 TB/s, against ~6.7 GFLOP of products over 408,208
// visible (query, key) pairs, ~0.007 ms at 989 TFLOP/s. So K/V must be
// read from device memory about once per (sequence, kv head) and the
// products must not be the limit: they run on the tensor cores. The two
// passes below read the new K/V a second time, out of the pool (~13 MB
// more): that is this design's cost, not the function's.
//
// Design (simple first; no TMA or wgmma yet), two launches on one stream so
// that no CTA races another CTA's write:
// - write pass: one CTA per (b, row i) copies the row's Hkv x D new K and V
//   values with 16-byte loads and stores into their block slots;
// - attention pass: one CTA = 4 warps per (b, kv head, 64-row query tile).
//   The tile runs over the G*S rows of the head group ordered
//   position-major (row r = i * G + g), so a tile holds 64 / G chunk
//   positions and every K/V tile it stages serves all G query heads. A
//   tile whose rows are all padding writes zeros and returns. The CTA
//   walks 64-position K/V tiles up to lens + (its last real row), skipping
//   tiles whose blocks are all -1, staged through shared memory with
//   double-buffered 16-byte cp.async (tile t+1 in flight while tile t is
//   used). S = Q K^T and O += P V run on mma.sync.m16n8k16 bf16 -> fp32
//   with q held as A fragments in registers, the S accumulator reused as
//   P's A fragment, m and l in fp32 registers per row (the flash-forward
//   kernel's inner loop). Rows past a sequence's window are zero-filled in
//   shared memory and masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per CTA (4 warps x 16)
constexpr int BK = 64;       // key positions per K/V tile
constexpr int NTHREADS = 128;
constexpr int PAD = 8;       // bf16 elements of padding per shared row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  uint16_t l = *reinterpret_cast<uint16_t*>(&lo);
  uint16_t h = *reinterpret_cast<uint16_t*>(&hi);
  return (uint32_t)l | ((uint32_t)h << 16);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- write pass: one CTA per (row i, sequence b) ---------------------------
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

// ---- attention pass: one CTA per (64-row tile, kv head, sequence) ----------
template <int D>
__global__ void __launch_bounds__(NTHREADS)
append_attn_kernel(const __nv_bfloat16* __restrict__ q, long long q_b,
                   long long q_s, const __nv_bfloat16* __restrict__ k_pool,
                   const __nv_bfloat16* __restrict__ v_pool,
                   const int* __restrict__ tables,
                   const int* __restrict__ lens,
                   const int* __restrict__ qlens,
                   __nv_bfloat16* __restrict__ out, int S, int Hq, int Hkv,
                   int bs, int MB, float scale_log2) {
  constexpr int LD = D + PAD;
  constexpr int KD = D / 16;   // k-steps over the head dim
  constexpr int ND = D / 8;    // n8 tiles of the output row
  constexpr int NS = BK / 8;   // n8 tiles of one score tile
  constexpr int CH = D / 8;    // 16-byte chunks per row
  extern __shared__ __align__(16) __nv_bfloat16 kv_s[];  // [2][K, V][BK][LD]
  __shared__ int ok_s[2][BK];

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
    for (int c = threadIdx.x; c < (r_end - r0) * CH; c += NTHREADS) {
      const int r = r0 + c / CH, d = (c % CH) * 8;
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
  const long stage = (long)2 * BK * LD;      // elements of one stage

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
    __nv_bfloat16* ks = kv_s + st * stage;
    __nv_bfloat16* vs = ks + (long)BK * LD;
    if (threadIdx.x < BK) {
      const int pos = kt * BK + threadIdx.x;
      const int j = pos / bs;
      ok_s[st][threadIdx.x] =
          (pos < n_pos && j <= j_last && trow[j] >= 0) ? 1 : 0;
    }
    for (int c = threadIdx.x; c < BK * CH; c += NTHREADS) {
      const int r = c / CH, d = (c % CH) * 8;
      const int pos = kt * BK + r;
      const int j = pos / bs;
      const int phys = (pos < n_pos && j <= j_last) ? trow[j] : -1;
      if (phys >= 0) {
        const long src = (((long)phys * Hkv + kvh) * bs + (pos - j * bs)) * D + d;
        cp_async16(ks + r * LD + d, k_pool + src);
        cp_async16(vs + r * LD + d, v_pool + src);
      } else {
        *reinterpret_cast<uint4*>(ks + r * LD + d) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vs + r * LD + d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
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
    __syncthreads();   // tile kt resident, its ok flags written
    const __nv_bfloat16* Ks = kv_s + st * stage;
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
    __syncthreads();   // buffer st is refilled by the next iteration's issue
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

template <int D>
int launch_attn(dim3 grid, cudaStream_t s, const __nv_bfloat16* q,
                long long q_b, long long q_s, const __nv_bfloat16* k_pool,
                const __nv_bfloat16* v_pool, const int* tables,
                const int* lens, const int* qlens, __nv_bfloat16* out, int S,
                int Hq, int Hkv, int bs, int MB, float scale_log2) {
  const int smem = 2 * 2 * BK * (D + PAD) * (int)sizeof(__nv_bfloat16);
  static int smem_allowed = 0;   // the opt-in above 48 KB, set once per size
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        append_attn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  append_attn_kernel<D><<<grid, NTHREADS, smem, s>>>(
      q, q_b, q_s, k_pool, v_pool, tables, lens, qlens, out, S, Hq, Hkv, bs,
      MB, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pt_paged_attention_append_bf16(
    const void* q, long long q_b, long long q_s, void* k_pool, void* v_pool,
    const void* tables, const void* lens, const void* qlens,
    const void* new_k, long long nk_b, long long nk_s, const void* new_v,
    long long nv_b, long long nv_s, void* out, int B, int S, int Hq, int Hkv,
    int D, int bs, int MB, int NB, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv || bs <= 0 || bs > 128 ||
      MB <= 0 || NB <= 0 || B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kp = static_cast<__nv_bfloat16*>(k_pool);
  auto* vp = static_cast<__nv_bfloat16*>(v_pool);
  const auto* tp = static_cast<const int*>(tables);
  const auto* lp = static_cast<const int*>(lens);
  const auto* qlp = static_cast<const int*>(qlens);
  const auto* nkp = static_cast<const __nv_bfloat16*>(new_k);
  const auto* nvp = static_cast<const __nv_bfloat16*>(new_v);
  auto* op = static_cast<__nv_bfloat16*>(out);

  append_write_kernel<<<dim3(S, B), NTHREADS, 0, s>>>(
      kp, vp, tp, lp, qlp, nkp, nk_b, nk_s, nvp, nv_b, nv_s, Hkv, D, bs, MB,
      NB);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int G = Hq / Hkv;
  const dim3 grid((S * G + BQ - 1) / BQ, Hkv, B);
  const float scale_log2 = scale * 1.4426950408889634f;
  if (D == 128)
    return launch_attn<128>(grid, s, qp, q_b, q_s, kp, vp, tp, lp, qlp, op, S,
                            Hq, Hkv, bs, MB, scale_log2);
  return launch_attn<64>(grid, s, qp, q_b, q_s, kp, vp, tp, lp, qlp, op, S,
                         Hq, Hkv, bs, MB, scale_log2);
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
