// KV-pool quantization rules shared by the quantized paged kernels (B4:
// paged_attention_decode_quant.cu, and the int8/int4 instantiations of
// paged_attention_append.cu).
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

// The quantized write rule on one (block, kv head), run by a whole CTA of
// NT threads. `buf` holds the block's stored payload (bs rows of Dp bytes,
// row stride `ld`) under `old_scale`; element d of row r takes the value
//   new_row(r)[d]             where new_row(r) is not null (a written row),
//   0                         for r >= live_end (rows past the written end:
//                             stale content must not inflate the scale),
//   grid(r, d) * old_scale    otherwise.
// The CTA reduces the block absmax (max is order-free, so the scale is
// exact), then requantizes `buf` in place under the new scale and returns
// it. `red` is NT / 32 floats of shared scratch. Every thread must call it.
template <int BITS, int NT, class NewRow>
__device__ float kv_requant_block(uint8_t* buf, int ld, float old_scale,
                                  int bs, int Dp, int live_end,
                                  NewRow new_row, float* red) {
  constexpr int P = kv_pack_factor<BITS>();
  const int tid = threadIdx.x;
  auto value = [&](int r, int d, uint8_t byte, int h) {
    const __nv_bfloat16* nr = new_row(r);
    if (nr != nullptr) return __bfloat162float(nr[d]);
    if (r >= live_end) return 0.f;
    return kv_deq(kv_grid<BITS>(byte, h), old_scale);
  };
  float amax = 0.f;
  for (int i = tid; i < bs * Dp; i += NT) {
    const int r = i / Dp, c = i - r * Dp;
    const uint8_t byte = buf[r * ld + c];
#pragma unroll
    for (int h = 0; h < P; ++h)
      amax = fmaxf(amax, fabsf(value(r, c + h * Dp, byte, h)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((tid & 31) == 0) red[tid >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) amax = fmaxf(amax, red[w]);
  const float scale = kv_block_scale<BITS>(amax);
  for (int i = tid; i < bs * Dp; i += NT) {
    const int r = i / Dp, c = i - r * Dp;
    const uint8_t byte = buf[r * ld + c];
    const int lo = kv_quant<BITS>(value(r, c, byte, 0), scale);
    const int hi = P == 2 ? kv_quant<BITS>(value(r, c + Dp, byte, 1), scale)
                          : 0;
    buf[r * ld + c] = kv_pack<BITS>(lo, hi);
  }
  __syncthreads();   // buf requantized; red free for the next call
  return scale;
}
