// The bf16 attention backward on the tensor cores (sm_90a), shared by both interfaces.
//
// Replaces, for bf16 inputs, the two CUDA-core passes of flash_attention_kernels.cuh (which stay
// the f32 body, bit for bit, and the body of bf16 shapes too large for this one). Same function:
//
//   S = (Q K^T) * scale + bias[b];  A = exp(S - rowmax) / rowsum                     f32
//   dV = A^T g;  dA = g V^T;  D = rowsum(dA o A);  dS = (A o (dA - D)) * scale;
//   dQ = dS K;  dK = dS^T Q        (A unrounded; every sum in f32; each output rounded once)
//
// Precision. q, k, v and g are bf16, so S = Q K^T and dA = g V^T are exact products with f32
// sums on the tensor cores (mma.sync.m16n8k16, bf16 in, f32 accumulate). A and dS are f32 and
// are not: rounded once to bf16 they break the plain version's bound (24x-137x at N = 10, 33 and
// 192, emulated in tests/test_torch_attention_bwd_split.py). So each enters its product as kSplitTerms bf16
// terms, hi = bf16(x), lo = bf16(x - hi), which hold x to 16 bits, and each of dV, dQ and dK is
// two mma's per tile into one f32 accumulator.
//
// Layout: one block per (head, batch row) holds the whole head: Q, K, V and g of (b, h) staged
// once in shared memory as bf16, rows padded with zeros to a multiple of 16 and to a head dim
// that is a multiple of 16, each row 16 bytes longer than its data so that the 8 row addresses
// of an ldmatrix fall on distinct banks. Padded keys get the bias -inf (they join neither the
// max nor the sum; a fully masked row is uniform over its real keys, as the masked-key bias
// -1e30 gives in the plain version); padded query rows and head columns are never written.
//
//   phase 1, warps own 16-query strips: Q and g fragments in registers; sweep the keys 16 at a
//     time for S and dA with the online row max m, sum l and D = sum(e dA) / l, reduced over the
//     quad of lanes that holds a row; sweep again for A = e * (1 / l), dS and dQ = dS K (K
//     through ldmatrix.trans); write dQ; keep (m, 1 / l, D) of every query in shared memory.
//   phase 2 (after one __syncthreads), warps own 16-key strips: K and V fragments in registers;
//     sweep the queries 16 at a time for S^T and dA^T, A and dS from the stored statistics, and
//     dV += A^T g, dK += dS^T Q in registers; write dK and dV once.
//
// No atomics and no global scratch: the result is deterministic. S and dA are recomputed three
// times (twice in phase 1, once in phase 2), so the tensor cores do 24 * N^2 * Dh FLOP per head
// (12 products), where the function needs 10 * N^2 * Dh.
//
// Shape rule (bwd_body, decided before launch and read by the Python wrapper through the C
// entry points' *_bwd_body): bf16 inputs whose staged head fits the 227 KB a block can opt in to
// on sm_90 take this body; f32 inputs and larger bf16 heads take the CUDA-core passes. At
// Dh = 64 this body holds N <= 384, at Dh = 128 N <= 208.
#pragma once

#include "flash_attention_mma.cuh"

namespace m3l {
namespace {

constexpr int kMmaWarps = 6;           // warps per block (fewer when N < 96): N = 192 is 12 strips
constexpr int kSplitTerms = 2;         // bf16 terms of A and dS in their products

// Shared memory of the tensor-core body in bytes: four bf16 tables (Q, K, V, g) of np rows of
// ld values (np = N rounded up to 16, ld = Dh rounded up to 16, plus 8), the key bias (np f32)
// and the (m, 1 / l, D, 0) of every query (np float4).
inline size_t mma_smem_bytes(int n, int dh) {
  const size_t np = (n + 15) / 16 * 16, ld = (dh + 15) / 16 * 16 + 8;
  return 8 * np * ld + 20 * np;
}

inline int bwd_body(int n, int dh, int elem_bytes) {
  return elem_bytes == 2 && mma_smem_bytes(n, dh) <= kSmemOptin ? kTensorCore : kCudaCore;
}

// Dynamic shared memory of the body bwd_body picks, in bytes (the larger pass of the CUDA-core one).
inline size_t bwd_smem_bytes(int n, int dh, int elem_bytes) {
  if (bwd_body(n, dh, elem_bytes) == kTensorCore) return mma_smem_bytes(n, dh);
  return (size_t)bwd_layout(n, dh, elem_bytes, true).words * 4;
}

// x[t] = A_strip (16 x DHP, fragments xa) times rows r0 .. r0 + 15 of the table xs, transposed,
// for t the two 8-row halves; y likewise from ya and ys. `boff` is this lane's ldmatrix offset.
template <int KD>
__device__ __forceinline__ void two_products(const uint32_t (&xa)[KD][4], const uint32_t (&ya)[KD][4],
                                             const __nv_bfloat16* xs, const __nv_bfloat16* ys, int boff,
                                             float (&x)[2][4], float (&y)[2][4]) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[t][e] = y[t][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    uint32_t bx[4], by[4];
    ldsm4(bx, xs + boff + kk * 16);
    ldsm4(by, ys + boff + kk * 16);
    mma16816(x[0], xa[kk], bx[0], bx[1]);
    mma16816(x[1], xa[kk], bx[2], bx[3]);
    mma16816(y[0], ya[kk], by[0], by[1]);
    mma16816(y[1], ya[kk], by[2], by[3]);
  }
}

// Up to Dh = 64 two blocks share an SM at N = 192 (their shared memory allows two), so registers
// are capped at 65536 / (2 * 192) a thread there; wider heads run one block an SM.
template <int KD>  // head dim padded to 16 * KD
__global__ void __launch_bounds__(kMmaWarps * 32, KD <= 4 ? 2 : 1)
bwd_mma_kernel(BwdOperands o, const float* __restrict__ bias, int n, int dh, float scale) {
  constexpr int DHP = 16 * KD, LD = DHP + 8, VECS = DHP / 8;
  extern __shared__ __align__(16) uint32_t smem[];
  const int np = (n + 15) / 16 * 16;
  __nv_bfloat16* const tables = reinterpret_cast<__nv_bfloat16*>(smem);
  const __nv_bfloat16* qs = tables;
  const __nv_bfloat16* ks = tables + np * LD;
  const __nv_bfloat16* vs = tables + 2 * np * LD;
  const __nv_bfloat16* gs = tables + 3 * np * LD;
  float* const bs = reinterpret_cast<float*>(tables + 4 * np * LD);
  float4* const st = reinterpret_cast<float4*>(bs + np);  // (m, 1 / l, D, 0) per query; 16-byte aligned

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, step = blockDim.x / 32 * 16;

  // stage Q, K, V, g of (b, h), 16 bytes per load, zeros past N and past Dh
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const In& in = t == 0 ? o.q : t == 1 ? o.k : t == 2 ? o.v : o.g;
    const uint32_t* src = in.at(b, h);
    for (int i = threadIdx.x; i < np * VECS; i += blockDim.x) {
      const int j = i / VECS, c = i % VECS;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (j < n && c * 8 < dh) x = *reinterpret_cast<const uint4*>(src + (size_t)j * in.row + c * 4);
      *reinterpret_cast<uint4*>(tables + (t * np + j) * LD + c * 8) = x;
    }
  }
  const float* bias_b = bias ? bias + (size_t)b * n : nullptr;
  for (int j = threadIdx.x; j < np; j += blockDim.x) bs[j] = j < n ? (bias_b ? bias_b[j] : 0.f) : -INFINITY;
  __syncthreads();

  // this lane's ldmatrix offsets: an A tile (rows 0-15, two column halves); B from rows (two
  // 8-row halves as the two n-tiles, two column halves as k); B through .trans (rows as k)
  const int aoff = (lane % 16) * LD + (lane / 16) * 8;
  const int boff = (lane % 8 + (lane / 16) * 8) * LD + (lane / 8 % 2) * 8;
  const int toff = (lane % 8 + (lane / 8 % 2) * 8) * LD + (lane / 16) * 8;
  const int col = 2 * (lane % 4);  // accumulator columns col, col + 1 of each n-tile

  // phase 1: 16-query strips -> (m, l, D) and dQ
  for (int i0 = warp * 16; i0 < np; i0 += step) {
    uint32_t qa[KD][4], ga[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      ldsm4(qa[kk], qs + i0 * LD + aoff + kk * 16);
      ldsm4(ga[kk], gs + i0 * LD + aoff + kk * 16);
    }
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
    for (int j0 = 0; j0 < np; j0 += 16) {
      float s[2][4], da[2][4];
      two_products<KD>(qa, ga, ks + j0 * LD, vs + j0 * LD, boff, s, da);
      float mc[2] = {m[0], m[1]};
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[t][e] = fmaf(s[t][e], scale, bs[j0 + 8 * t + col + e % 2]);
          mc[e / 2] = fmaxf(mc[e / 2], s[t][e]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mc[r] = quad_max(mc[r]);
        const float corr = expf(m[r] - mc[r]);  // 0 on the first chunk, whose key 0 is real
        l[r] *= corr;
        d[r] *= corr;
        m[r] = mc[r];
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[t][e] - m[e / 2]);
          l[e / 2] += p;
          d[e / 2] = fmaf(p, da[t][e], d[e / 2]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      d[r] = quad_sum(d[r]) / l[r];
      l[r] = 1.f / l[r];  // A = e * (1 / l) from here on
      if (lane % 4 == 0) st[i0 + lane / 4 + 8 * r] = make_float4(m[r], l[r], d[r], 0.f);
    }

    float dq[2 * KD][4];
#pragma unroll
    for (int t = 0; t < 2 * KD; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[t][e] = 0.f;
    }
    for (int j0 = 0; j0 < np; j0 += 16) {
      float s[2][4], da[2][4];
      two_products<KD>(qa, ga, ks + j0 * LD, vs + j0 * LD, boff, s, da);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          const float a = expf(fmaf(s[t][e], scale, bs[j0 + 8 * t + col + e % 2]) - m[r]) * l[r];
          da[t][e] = (a * (da[t][e] - d[r])) * scale;  // dS
        }
      }
      uint32_t dsa[kSplitTerms][4];
      split_a(da, dsa);
      accumulate<KD>(dq, dsa, ks + j0 * LD, toff);
    }
    store_strip<KD>(o.dq, b, h, dq, i0, n, dh, lane);
  }
  __syncthreads();

  // phase 2: 16-key strips -> dK and dV over every query
  for (int j0 = warp * 16; j0 < np; j0 += step) {
    uint32_t ka[KD][4], va[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      ldsm4(ka[kk], ks + j0 * LD + aoff + kk * 16);
      ldsm4(va[kk], vs + j0 * LD + aoff + kk * 16);
    }
    const float bj[2] = {bs[j0 + lane / 4], bs[j0 + lane / 4 + 8]};
    float dk[2 * KD][4], dv[2 * KD][4];
#pragma unroll
    for (int t = 0; t < 2 * KD; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[t][e] = dv[t][e] = 0.f;
    }
    // padded queries need no guard: their q and g rows are zeros and their (m, 1 / l, D) finite
    for (int i0 = 0; i0 < np; i0 += 16) {
      float s[2][4], da[2][4];  // S^T and dA^T: rows keys, columns queries
      two_products<KD>(ka, va, qs + i0 * LD, gs + i0 * LD, boff, s, da);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 q = st[i0 + 8 * t + col + e % 2];
          const float a = expf(fmaf(s[t][e], scale, bj[e / 2]) - q.x) * q.y;
          s[t][e] = a;
          da[t][e] = (a * (da[t][e] - q.z)) * scale;
        }
      }
      uint32_t pa[kSplitTerms][4], dsa[kSplitTerms][4];
      split_a(s, pa);
      split_a(da, dsa);
      accumulate<KD>(dv, pa, gs + i0 * LD, toff);
      accumulate<KD>(dk, dsa, qs + i0 * LD, toff);
    }
    store_strip<KD>(o.dk, b, h, dk, j0, n, dh, lane);
    store_strip<KD>(o.dv, b, h, dv, j0, n, dh, lane);
  }
}

template <int KD>
int launch_bwd_mma_t(const BwdOperands& o, const float* bias, int batch, int heads, int n, int dh, float scale,
                     cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(n, dh);
  const int err = allow_mma_smem(bwd_mma_kernel<KD>, smem);
  if (err) return err;
  const int strips = (n + 15) / 16, warps = strips < kMmaWarps ? strips : kMmaWarps;
  bwd_mma_kernel<KD><<<dim3(heads, batch), warps * 32, smem, stream>>>(o, bias, n, dh, scale);
  return (int)cudaGetLastError();
}

// The backward on `stream` by the body bwd_body picks; returns cudaGetLastError() (0 on
// success). `bias` may be null; `stats` (f32, batch * heads * n * 3) is used by the CUDA-core body only.
inline int launch_bwd(const BwdOperands& o, const void* bias, void* stats, int batch, int heads, int n, int dh,
                      float scale, int elem_bytes, void* stream) {
  if (bwd_body(n, dh, elem_bytes) == kCudaCore)
    return launch_bwd_cuda_core(o, bias, stats, batch, heads, n, dh, scale, elem_bytes, stream);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bi = static_cast<const float*>(bias);
  switch ((dh + 15) / 16) {
    case 1: return launch_bwd_mma_t<1>(o, bi, batch, heads, n, dh, scale, s);
    case 2: return launch_bwd_mma_t<2>(o, bi, batch, heads, n, dh, scale, s);
    case 3: return launch_bwd_mma_t<3>(o, bi, batch, heads, n, dh, scale, s);
    case 4: return launch_bwd_mma_t<4>(o, bi, batch, heads, n, dh, scale, s);
    case 5: return launch_bwd_mma_t<5>(o, bi, batch, heads, n, dh, scale, s);
    case 6: return launch_bwd_mma_t<6>(o, bi, batch, heads, n, dh, scale, s);
    case 7: return launch_bwd_mma_t<7>(o, bi, batch, heads, n, dh, scale, s);
    case 8: return launch_bwd_mma_t<8>(o, bi, batch, heads, n, dh, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace m3l
