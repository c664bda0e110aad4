// Tensor-core building blocks shared by the attention bodies (sm_90a): the bf16 forward
// (flash_attention_fwd_mma.cuh) and backward (flash_attention_bwd_mma.cuh), and the f32 forward
// (flash_attention_fwd_tf32.cuh) and backward (flash_attention_bwd_tf32.cuh).
//
// bf16. Both keep head tables (a whole head, or a tile of its rows) in shared memory as bf16, rows past
// N zeros up to a multiple of 16, a head dim padded with zeros to DHP = 16 * KD, and each row
// LD = DHP + 8 values long, so that the 8 row addresses of an ldmatrix fall on distinct banks. Products are mma.sync.m16n8k16
// (bf16 in, f32 accumulate) on fragments in registers: a 16 x 16 A tile as four 32-bit
// registers, a 16 x 8 accumulator tile c[4] holding rows lane / 4 (c[0], c[1]) and lane / 4 + 8
// (c[2], c[3]) at columns 2 * (lane % 4) and the next one.
//
// f32 ("3xTF32"). A TF32 product keeps 11 significant bits of each operand, about 1e-3 relative,
// far outside the f32 bounds. So each f32 operand x enters as two TF32 terms, hi = tf32(x) and
// lo = tf32(x - hi) (to nearest, ties away: round_tf32), which hold x to about 2^-22, and each
// product is three mma.sync.m16n8k8 TF32 products into one f32 accumulator, lo hi + hi lo +
// hi hi (lo lo, below 2^-22 of the product, is dropped): CUTLASS's "fast f32". Tables are f32 in
// shared memory, rows past N zeros up to a multiple of 16, a head dim padded with zeros to
// DHP = 16 * KD, each row LD = DHP + 4 floats long. LD = 4 (mod 8) makes both reads of a table
// conflict-free: the direct one (lane reads row g, column t: bank 4g + t) and the transposed one
// (row 2t, column g: bank 8t + g), for g = lane / 4 and t = lane % 4. An m16n8k8 A fragment a[4]
// holds rows g (a[0], a[2]) and g + 8 (a[1], a[3]) at k columns t (a[0], a[1]) and t + 4; a B
// fragment b0, b1 the k rows t and t + 4 of column g; the accumulator the m16n8 layout above.
#pragma once

#include "flash_attention_common.cuh"

namespace m3l {
namespace {

enum Body { kTf32x3 = 0, kTensorCore = 1 };  // the f32 and the bf16 body

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

// ---------------------------------------------------------------------------------------------
// f32 through TF32 (3xTF32)
// ---------------------------------------------------------------------------------------------

// The f32 bits of x rounded to the nearest TF32 value, ties away from zero, by an integer add and
// an and: for finite x the result of cvt.rna.tf32.f32.
__device__ __forceinline__ uint32_t round_tf32(uint32_t bits) { return (bits + 0x1000u) & 0xffffe000u; }

// x as hi + lo, each a TF32 value in a 32-bit register; x - hi is exact in f32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(__float_as_uint(x));
  lo = round_tf32(__float_as_uint(x - __uint_as_float(hi)));
}

// d += a b for a 16x8 TF32 A tile (row major) and an 8x8 TF32 B tile (column major), f32 d. Not
// volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32 (B as its two f32 elements b0, b1): the two small terms first, then hi hi;
// and e += c f likewise, each product of the one chain issued between two of the other, so that
// neither waits on its own last product.
__device__ __forceinline__ void mma3_pair(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], float b0,
                                          float b1, float (&e)[4], const uint32_t (&ch)[4], const uint32_t (&cl)[4],
                                          float f0, float f1) {
  uint32_t bh0, bl0, bh1, bl1, fh0, fl0, fh1, fl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  split_tf32(f0, fh0, fl0);
  split_tf32(f1, fh1, fl1);
  mma1688(d, al, bh0, bh1);
  mma1688(e, cl, fh0, fh1);
  mma1688(d, ah, bl0, bl1);
  mma1688(e, ch, fl0, fl1);
  mma1688(d, ah, bh0, bh1);
  mma1688(e, ch, fh0, fh1);
}

// An m16n8 accumulator tile (16 rows x 8 columns j0 .. j0 + 7) as the split A operand of a product
// that sums over those 8 columns. The accumulator holds columns 2t and 2t + 1, the A fragment wants
// k = t and t + 4, so column 2t enters as k = t and column 2t + 1 as k = t + 4: the B operand's k
// rows must be read in that order, rows j0 + 2t (b0) and j0 + 2t + 1 (b1).
__device__ __forceinline__ void split_c_as_a(const float (&c)[4], uint32_t (&h)[4], uint32_t (&l)[4]) {
  split_tf32(c[0], h[0], l[0]);  // row g, column 2t
  split_tf32(c[2], h[1], l[1]);  // row g + 8, column 2t
  split_tf32(c[1], h[2], l[2]);  // row g, column 2t + 1
  split_tf32(c[3], h[3], l[3]);  // row g + 8, column 2t + 1
}

// How an f32 body holds the m16k8 A fragments of a 16-row strip: split once into registers (2 per
// element), or, for a head dim past 64 whose split strips would not fit the registers, read from
// global memory (L1) and split again at each use.
enum StripMode { kHeldSplit, kReload };

// Rows r0 .. r0 + 15 of operand x (head (b, h)) as split m16k8 A fragments for the 2 * KD k-steps
// of 8 columns; zeros past n and past dh.
template <int KD, int MODE>
struct AStrip {
  static constexpr int S = MODE == kHeldSplit ? 2 * KD : 1;
  uint32_t hi[S][4], lo[S][4];
  const uint32_t* xb;
  int stride, r0, n, dh;

  __device__ __forceinline__ void load(const In& x, int b, int h, int r0_, int n_, int dh_) {
    xb = x.at(b, h);
    stride = x.row, r0 = r0_, n = n_, dh = dh_;
    if constexpr (MODE == kHeldSplit) {
#pragma unroll
      for (int ks = 0; ks < 2 * KD; ++ks) fetch(ks, hi[ks], lo[ks]);
    }
  }

  __device__ __forceinline__ void fetch(int ks, uint32_t (&h)[4], uint32_t (&l)[4]) const {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + lane / 4 + 8 * (r % 2), col = 8 * ks + lane % 4 + 4 * (r / 2);
      const float x = row < n && col < dh ? __uint_as_float(xb[(size_t)row * stride + col]) : 0.f;
      split_tf32(x, h[r], l[r]);
    }
  }

  __device__ __forceinline__ void get(int ks, uint32_t (&h)[4], uint32_t (&l)[4]) const {
    if constexpr (MODE == kHeldSplit) {
#pragma unroll
      for (int r = 0; r < 4; ++r) h[r] = hi[ks][r], l[r] = lo[ks][r];
    } else {
      fetch(ks, h, l);
    }
  }
};

// Rows r0 .. r0 + rows - 1 of operands x and y (head (b, h)) into the f32 tables tx and ty (rows
// of 16 * KD + 4 floats) by cp.async, zeros past n and past dh; the block's threads share the copies.
template <int KD>
__device__ __forceinline__ void stage_rows_f32(float* tx, const In& x, float* ty, const In& y, int b, int h, int r0,
                                               int rows, int n, int dh) {
  constexpr int LD = 16 * KD + 4, VECS = 4 * KD;
  const uint32_t* xs = x.at(b, h);
  const uint32_t* ys = y.at(b, h);
  for (int i = threadIdx.x; i < rows * VECS; i += blockDim.x) {
    const int j = i / VECS, c = i % VECS, row = r0 + j;
    const bool real = row < n && c * 4 < dh;
    cp_async16(tx + j * LD + c * 4, real ? xs + (size_t)row * x.row + c * 4 : xs, real);
    cp_async16(ty + j * LD + c * 4, real ? ys + (size_t)row * y.row + c * 4 : ys, real);
  }
}

// Write rows r0 + lane / 4 and r0 + lane / 4 + 8 of a 16 x DHP f32 accumulator, rows < n and
// columns < dh only, two floats a store.
template <int KD>
__device__ __forceinline__ void store_strip_f32(const Out& out, int b, int h, const float (&acc)[2 * KD][4], int r0,
                                                int n, int dh, int lane) {
  uint32_t* base = out.at(b, h);
  const int r = r0 + lane / 4;
#pragma unroll
  for (int c = 0; c < 2 * KD; ++c) {
    if (c * 8 >= dh) break;
    const int w = c * 8 + 2 * (lane % 4);
    if (r < n) *reinterpret_cast<float2*>(base + (size_t)r * out.row + w) = make_float2(acc[c][0], acc[c][1]);
    if (r + 8 < n) *reinterpret_cast<float2*>(base + (size_t)(r + 8) * out.row + w) = make_float2(acc[c][2], acc[c][3]);
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
