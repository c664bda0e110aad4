// Element access and warp reductions shared by the attention kernels (flash_attention_kernels.cuh).
//
// The CUDA-core bodies read and write head rows as 32-bit words through Elem<T>, written for
// the element types they take: f32 only, since every bf16 input runs the tensor-core bodies.
// All arithmetic is in f32.
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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace m3l
