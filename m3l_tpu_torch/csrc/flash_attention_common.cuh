// Element access and warp reductions shared by the attention kernels (flash_attention_kernels.cuh).
//
// The kernels read and write the packed rows as 32-bit words: one f32, or two bf16 of which the
// element at the lower address sits in the low half. All arithmetic is in f32.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace m3l {

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPerWord = 1;
  __device__ static void unpack(uint32_t w, float* f) { f[0] = __uint_as_float(w); }
  __device__ static uint32_t pack(const float* f) { return __float_as_uint(f[0]); }
  __device__ static float round(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  // a bf16 is the high half of an f32
  __device__ static void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static uint32_t pack(const float* f) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[0], f[1]);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace m3l
