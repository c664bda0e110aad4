// Tensor-core building blocks shared by the bf16 attention bodies (sm_90a): the forward
// (flash_attention_fwd_mma.cuh) and the backward (flash_attention_bwd_mma.cuh).
//
// Both keep head tables (a whole head, or a tile of its rows) in shared memory as bf16, rows past
// N zeros up to a multiple of 16, a head dim padded with zeros to DHP = 16 * KD, and each row
// LD = DHP + 8 values long, so that the 8 row addresses of an ldmatrix fall on distinct banks. Products are mma.sync.m16n8k16
// (bf16 in, f32 accumulate) on fragments in registers: a 16 x 16 A tile as four 32-bit
// registers, a 16 x 8 accumulator tile c[4] holding rows lane / 4 (c[0], c[1]) and lane / 4 + 8
// (c[2], c[3]) at columns 2 * (lane % 4) and the next one.
#pragma once

#include "flash_attention_kernels.cuh"

namespace m3l {
namespace {

enum Body { kCudaCore = 0, kTensorCore = 1 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b for a 16x16 bf16 A tile (row major) and a 16x8 B tile (column major), f32 d.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 16 bytes from global to shared memory without passing through registers (cp.async); zeros
// where `valid` is false, and then `src` is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N committed groups of this thread's copies are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Rows r0 .. r0 + rows - 1 of operands x and y (head (b, h)) into the bf16 tables tx and ty (rows
// of LD values) by cp.async, zeros past n and past dh; the block's threads share the copies.
template <int KD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* tx, const In& x, __nv_bfloat16* ty, const In& y, int b, int h,
                                           int r0, int rows, int n, int dh) {
  constexpr int LD = 16 * KD + 8, VECS = 2 * KD;
  const uint32_t* xs = x.at(b, h);
  const uint32_t* ys = y.at(b, h);
  for (int i = threadIdx.x; i < rows * VECS; i += blockDim.x) {
    const int j = i / VECS, c = i % VECS, row = r0 + j;
    const bool real = row < n && c * 8 < dh;
    cp_async16(tx + j * LD + c * 8, real ? xs + (size_t)row * x.row + c * 4 : xs, real);
    cp_async16(ty + j * LD + c * 8, real ? ys + (size_t)row * y.row + c * 4 : ys, real);
  }
}

// The key bias of keys j0 .. j0 + rows - 1 into bs: 0 or the caller's bias for real keys (-1e30 on
// masked ones), -inf for the padding past n, which so joins neither a row max nor a sum.
__device__ __forceinline__ void stage_bias(float* bs, const float* bias_b, int j0, int rows, int n) {
  for (int j = threadIdx.x; j < rows; j += blockDim.x) bs[j] = j0 + j < n ? (bias_b ? bias_b[j0 + j] : 0.f) : -INFINITY;
}

// Rows r0 .. r0 + 15 of operand x (head (b, h)) as m16k16 A fragments straight from global
// memory: a[kk][r] holds row r0 + lane / 4 (+ 8 for odd r), columns 16 kk + 2 (lane % 4) (+ 8 for
// r >= 2) and the next one; zeros past n and past dh. The same values ldmatrix gives from a table.
template <int KD>
__device__ __forceinline__ void load_a_strip(uint32_t (&a)[KD][4], const In& x, int b, int h, int r0, int n, int dh,
                                             int lane) {
  const uint32_t* xb = x.at(b, h);
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + lane / 4 + 8 * (r % 2), w = kk * 8 + lane % 4 + 4 * (r / 2);
      a[kk][r] = row < n && 2 * w < dh ? xb[(size_t)row * x.row + w] : 0u;
    }
  }
}

// f32 accumulator tiles c[t] (rows x keys j0 + 8t .. + 7, m16n8 layout) -> the A operand of the
// next product over those 16 keys, as T bf16 terms: a[0] = bf16(c), a[1] = bf16(c - a[0]), ...
template <int T>
__device__ __forceinline__ void split_a(float (&c)[2][4], uint32_t (&a)[T][4]) {
#pragma unroll
  for (int s = 0; s < T; ++s) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // a[s][r]: tile r / 2, accumulator pair 2 * (r % 2)
      float& x0 = c[r / 2][2 * (r % 2)];
      float& x1 = c[r / 2][2 * (r % 2) + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      a[s][r] = *reinterpret_cast<const uint32_t*>(&h);
      x0 -= __low2float(h);  // exact: x and its bf16 rounding share the leading bits
      x1 -= __high2float(h);
    }
  }
}

// acc (16 x DHP) += a (16 x 16, T terms) times rows r0 .. r0 + 15 of the table ts (16 x DHP,
// through ldmatrix.trans); `toff` is this lane's offset.
template <int KD, int T>
__device__ __forceinline__ void accumulate(float (&acc)[2 * KD][4], const uint32_t (&a)[T][4],
                                           const __nv_bfloat16* ts, int toff) {
#pragma unroll
  for (int c = 0; c < KD; ++c) {
    uint32_t b[4];
    ldsm4_t(b, ts + toff + c * 16);
#pragma unroll
    for (int s = 0; s < T; ++s) {
      mma16816(acc[2 * c], a[s], b[0], b[1]);
      mma16816(acc[2 * c + 1], a[s], b[2], b[3]);
    }
  }
}

// Write rows r0 + lane / 4 and r0 + lane / 4 + 8 of a 16 x DHP accumulator, rows < n and
// columns < dh only, rounded to bf16.
template <int KD>
__device__ __forceinline__ void store_strip(const Out& out, int b, int h, const float (&acc)[2 * KD][4], int r0, int n,
                                            int dh, int lane) {
  uint32_t* base = out.at(b, h);
  const int r = r0 + lane / 4;
#pragma unroll
  for (int t = 0; t < 2 * KD; ++t) {
    if (t * 8 >= dh) break;
    const int w = t * 4 + lane % 4;
    if (r < n) base[(size_t)r * out.row + w] = bf16x2(acc[t][0], acc[t][1]);
    if (r + 8 < n) base[(size_t)(r + 8) * out.row + w] = bf16x2(acc[t][2], acc[t][3]);
  }
}

// Opens `smem` bytes of dynamic shared memory to `kernel` and asks for the SM's largest shared
// carveout; returns 0 or the CUDA error.
template <typename K>
int allow_mma_smem(K kernel, size_t smem) {
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace
}  // namespace m3l
