// KV-pool quantization rules shared by the quantized paged kernels (B4:
// the int8/int4 instantiations of paged_attention_decode.cu and
// paged_attention_append.cu, on csrc/paged_split.cuh).
//
// Counterpart: paddle_tpu/ops/kernels/paged_attention.py `kv_unpack`,
// `kv_pack`, `kv_quantize`, `kv_block_scale` (:95-162), and the port's
// plain versions in paddle_tpu_torch/ops/kernels/paged_attention.py, which
// spell the same float operations, so payload and scales are bit-identical
// between kernel and plain version:
// - BITS 8: one int8 per element; BITS 4: split-half nibbles, byte j of a
//   row holds element j in its low nibble and element Dp + j (Dp = D / 2)
//   in its high nibble, each stored +8 (grid [-7, 7]);
// - dequantize: grid * scale, one rounded product;
// - block scale: absmax over the (block, kv head) * float32(1 / qmax) (the
//   product the reference's compiled paths store for `absmax / qmax`);
// - quantize: rint(x / max(scale, 1e-20)) (correctly rounded division,
//   ties to even), clipped to +-qmax.
// Every rounding is spelled with an intrinsic, so nvcc cannot contract it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

template <int BITS>
__device__ __forceinline__ float kv_qmax() {
  return BITS == 8 ? 127.f : 7.f;
}

template <int BITS>
__device__ __forceinline__ float kv_inv_qmax() {
  return BITS == 8 ? 0x1.020408p-7f : 0x1.24924ap-3f;   // float32(1 / qmax)
}

// elements per stored byte
template <int BITS>
__host__ __device__ constexpr int kv_pack_factor() {
  return BITS == 8 ? 1 : 2;
}

// grid value of half `h` (0: low nibble / the int8 itself, 1: high nibble)
template <int BITS>
__device__ __forceinline__ float kv_grid(uint8_t byte, int h) {
  if (BITS == 8) return (float)(int8_t)byte;
  return (float)((h ? (byte >> 4) : (byte & 0xF)) - 8);
}

__device__ __forceinline__ float kv_deq(float grid, float scale) {
  return __fmul_rn(grid, scale);
}

template <int BITS>
__device__ __forceinline__ float kv_block_scale(float absmax) {
  return __fmul_rn(absmax, kv_inv_qmax<BITS>());
}

template <int BITS>
__device__ __forceinline__ int kv_quant(float x, float scale) {
  const float q = rintf(__fdiv_rn(x, fmaxf(scale, 0x1.79ca1p-67f)));  // 1e-20
  return (int)fminf(fmaxf(q, -kv_qmax<BITS>()), kv_qmax<BITS>());
}

template <int BITS>
__device__ __forceinline__ uint8_t kv_pack(int lo, int hi) {
  if (BITS == 8) return (uint8_t)(int8_t)lo;
  return (uint8_t)((lo + 8) | ((hi + 8) << 4));
}

// The largest |grid value| of the four bytes of w (int4: eight nibbles).
template <int BITS>
__device__ __forceinline__ int kv_word_absmax(uint32_t w) {
  int m = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t byte = (w >> (8 * k)) & 0xFFu;
    if (BITS == 8)
      m = max(m, abs((int)(int8_t)byte));
    else
      m = max(m, max(abs((int)(byte & 0xFu) - 8), abs((int)(byte >> 4) - 8)));
  }
  return m;
}

// The quantized write rule on one (block, kv head), run by NT threads
// (`tid` 0 .. NT - 1) that `sync()` holds together. `at(r, c)` is the
// address of payload byte c of block row r (bs rows of Dp bytes; c a
// multiple of 4 gives a 4-byte-aligned word), stored under `old_scale`;
// element d of row r takes the value
//   new_row(r)[d]             where new_row(r) is not null (a written row),
//   0                         for r >= live_end (rows past the written end:
//                             stale content must not inflate the scale),
//   grid(r, d) * old_scale    otherwise (an old row).
// The threads reduce the block absmax (max is order-free, so the scale is
// exact), then requantize the payload in place under the new scale and
// return it. Each element takes the rule's operations (kv_deq, kv_quant,
// kv_pack), so the bits are those of a per-element loop; but an old row's
// value depends only on its stored byte, so an old byte's new byte is
// computed once per block, in a 256-entry table, and looked up; and its
// absmax is |grid| * old_scale, rounding being monotonic, so old rows
// reduce their |grid| in integers. `red` is 2 * NT / 32 words and `table`
// 256 bytes of shared scratch.
template <int BITS, int NT, class At, class NewRow, class Sync>
__device__ __forceinline__ float kv_requant(At at, float old_scale, int bs,
                                            int Dp, int live_end,
                                            NewRow new_row, float* red,
                                            uint8_t* table, int tid,
                                            Sync sync) {
  constexpr int P = kv_pack_factor<BITS>();
  constexpr int NW = NT / 32;
  const int W = Dp / 4;   // words of a row
  int gmax = 0;
  float nmax = 0.f;
  for (int i = tid; i < bs * W; i += NT) {
    const int r = i / W, c = (i - r * W) * 4;
    const __nv_bfloat16* nr = new_row(r);
    if (nr != nullptr) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int h = 0; h < P; ++h)
          nmax = fmaxf(nmax, fabsf(__bfloat162float(nr[c + e + h * Dp])));
    } else if (r < live_end) {
      gmax = max(gmax, kv_word_absmax<BITS>(
                           *reinterpret_cast<const uint32_t*>(at(r, c))));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    nmax = fmaxf(nmax, __shfl_xor_sync(0xffffffffu, nmax, off));
    gmax = max(gmax, __shfl_xor_sync(0xffffffffu, gmax, off));
  }
  int* const ired = reinterpret_cast<int*>(red) + NW;
  if ((tid & 31) == 0) {
    red[tid >> 5] = nmax;
    ired[tid >> 5] = gmax;
  }
  sync();
  nmax = red[0];
  gmax = ired[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) {
    nmax = fmaxf(nmax, red[w]);
    gmax = max(gmax, ired[w]);
  }
  const float scale =
      kv_block_scale<BITS>(fmaxf(nmax, kv_deq((float)gmax, old_scale)));
  for (int x = tid; x < 256; x += NT) {
    const int lo = kv_quant<BITS>(kv_deq(kv_grid<BITS>(x, 0), old_scale),
                                  scale);
    const int hi =
        P == 2 ? kv_quant<BITS>(kv_deq(kv_grid<BITS>(x, 1), old_scale), scale)
               : 0;
    table[x] = kv_pack<BITS>(lo, hi);
  }
  sync();
  for (int i = tid; i < bs * W; i += NT) {
    const int r = i / W, c = (i - r * W) * 4;
    uint32_t* const q = reinterpret_cast<uint32_t*>(at(r, c));
    const __nv_bfloat16* nr = new_row(r);
    uint32_t out = 0;
    if (nr != nullptr) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lo = kv_quant<BITS>(__bfloat162float(nr[c + e]), scale);
        const int hi =
            P == 2 ? kv_quant<BITS>(__bfloat162float(nr[c + e + Dp]), scale)
                   : 0;
        out |= (uint32_t)kv_pack<BITS>(lo, hi) << (8 * e);
      }
    } else if (r >= live_end) {
      out = BITS == 8 ? 0u : 0x88888888u;   // kv_pack of four zeros
    } else {
      const uint32_t w = *q;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out |= (uint32_t)table[(w >> (8 * e)) & 0xFFu] << (8 * e);
    }
    *q = out;
  }
  sync();   // payload requantized; red and table free for the next call
  return scale;
}
