// The bf16 attention backward on the tensor cores (sm_90a), shared by both interfaces.
//
// The body of bf16 inputs; f32 inputs take bwd_tf32_kernel (flash_attention_bwd_tf32.cuh), which
// has this body's two phases in 3xTF32. Same function:
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
// Layout: one block per (head, batch row). Tables in shared memory are bf16, rows padded with
// zeros to a multiple of 16 and to a head dim that is a multiple of 16, each row 16 bytes longer
// than its data so that the 8 row addresses of an ldmatrix fall on distinct banks. Padded keys
// get the bias -inf (they join neither the max nor the sum; a fully masked row is uniform over
// its real keys, as the masked-key bias -1e30 gives in the plain version); padded query rows
// and head columns are never written.
//
//   phase 1, warps own 16-query strips: Q and g fragments in registers; sweep the keys 16 at a
//     time for S and dA with the online row max m, sum l and D = sum(e dA) / l, reduced over the
//     quad of lanes that holds a row; sweep again for A = e * (1 / l), dS and dQ = dS K (K
//     through ldmatrix.trans); write dQ and keep (m, 1 / l, D) of every query.
//   phase 2 (after one __syncthreads), warps own 16-key strips: K and V fragments in registers;
//     sweep the queries 16 at a time for S^T and dA^T, A and dS from the stored statistics, and
//     dV += A^T g, dK += dS^T Q in registers; write dK and dV once.
//
// A head whose Q, K, V, g, key bias and statistics fit the 227 KB a block can opt in to on sm_90
// (N <= 384 at Dh = 64, N <= 208 at Dh = 128) is staged whole, once, and the statistics stay in
// shared memory. A longer head streams: phase 1 sweeps K, V and the key bias in tiles of kBwdTile
// keys, all warps on one tile at a time (a round of W strips); its strips' Q and g fragments and
// phase 2's K and V fragments come straight from global memory, and the statistics go to a global
// f32 scratch (np float4 per head) from which phase 2 stages them with each tile of kBwdTile
// queries, Q and g. Chunks are visited 16 keys or queries at a time in the same order either way,
// so a head gives the same bits staged whole or streamed.
//
// No atomics: the result is deterministic. S and dA are recomputed three times (twice in phase 1,
// once in phase 2), so the tensor cores do 24 * N^2 * Dh FLOP per head (12 products), where the
// function needs 10 * N^2 * Dh.
//
// Body rule (bwd_body, read by the Python wrapper through the C entry points' *_bwd_body): bf16
// inputs take this body at any N, f32 inputs the 3xTF32 body.
#pragma once

#include "flash_attention_bwd_tf32.cuh"  // and flash_attention_mma.cuh

namespace m3l {
namespace {

constexpr int kMmaWarps = 6;           // warps per block (fewer when N < 96): N = 192 is 12 strips
constexpr int kSplitTerms = 2;         // bf16 terms of A and dS in their products
constexpr int kBwdTile = 128;          // keys or queries per staged tile of a head too long to stage whole

// Shared memory of one staged row: its Q, K, V and g rows (bf16, Dh rounded up to 16, plus 8),
// its key bias (f32) and its query's (m, 1 / l, D, 0) (float4).
inline size_t bwd_mma_row_bytes(int dh) { return 8 * ((dh + 15) / 16 * 16 + 8) + 20; }

// Rows per staged tile: the whole head (N rounded up to 16) where it fits, else kBwdTile.
inline int bwd_mma_tile(int n, int dh) {
  const int np = (n + 15) / 16 * 16;
  return np * bwd_mma_row_bytes(dh) <= kSmemOptin ? np : kBwdTile;
}

inline size_t bwd_mma_smem_bytes(int n, int dh) { return bwd_mma_tile(n, dh) * bwd_mma_row_bytes(dh); }

inline int bwd_body(int elem_bytes) { return elem_bytes == 2 ? kTensorCore : kTf32x3; }

// f32 scratch the backward needs, in floats: (m, 1 / l, D, 0) of every padded query for a streamed
// head of either body; none for a head staged whole.
inline size_t bwd_scratch_floats(int batch, int heads, int n, int dh, int elem_bytes) {
  if (bwd_body(elem_bytes) == kTf32x3) return bwd_tf32_scratch_floats(batch, heads, n, dh);
  const int np = (n + 15) / 16 * 16;
  return bwd_mma_tile(n, dh) == np ? 0 : (size_t)batch * heads * np * 4;
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
// are capped at 65536 / (2 * 192) a thread there; wider heads run one block an SM. `tile` is
// bwd_mma_tile: np for a head staged whole; `stats` the streamed head's scratch (else unused).
template <int KD>  // head dim padded to 16 * KD
__global__ void __launch_bounds__(kMmaWarps * 32, KD <= 4 ? 2 : 1)
bwd_mma_kernel(BwdOperands o, const float* __restrict__ bias, float4* __restrict__ stats, int n, int dh, float scale,
               int tile) {
  constexpr int DHP = 16 * KD, LD = DHP + 8;
  extern __shared__ __align__(16) uint32_t smem[];
  const int np = (n + 15) / 16 * 16, T = tile;
  const bool whole = T == np;  // block-uniform: the head is staged once, else tile by tile
  __nv_bfloat16* const qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const ks = qs + T * LD;
  __nv_bfloat16* const vs = qs + 2 * T * LD;
  __nv_bfloat16* const gs = qs + 3 * T * LD;
  float* const bs = reinterpret_cast<float*>(qs + 4 * T * LD);  // key bias of the staged keys
  float4* const st = reinterpret_cast<float4*>(bs + T);         // (m, 1 / l, D, 0) of the staged queries; 16-byte aligned

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, step = blockDim.x / 32 * 16;
  const float* bias_b = bias ? bias + (size_t)b * n : nullptr;
  float4* const gst = whole ? st : stats + ((size_t)b * gridDim.x + h) * np;  // where phase 1 writes the statistics

  if (whole) {
    stage_rows<KD>(qs, o.q, ks, o.k, b, h, 0, np, n, dh);
    stage_rows<KD>(vs, o.v, gs, o.g, b, h, 0, np, n, dh);
    stage_bias(bs, bias_b, 0, np, n);
    cp_async_wait_all();
    __syncthreads();
  }
  // a streamed head's tile from row t0: every warp has left the previous one before it is overwritten
  auto stage_keys = [&](int t0) {
    if (whole) return;
    __syncthreads();
    const int rows = min(T, np - t0);
    stage_rows<KD>(ks, o.k, vs, o.v, b, h, t0, rows, n, dh);
    stage_bias(bs, bias_b, t0, rows, n);
    cp_async_wait_all();
    __syncthreads();
  };
  auto stage_queries = [&](int t0) {
    if (whole) return;
    __syncthreads();
    const int rows = min(T, np - t0);
    stage_rows<KD>(qs, o.q, gs, o.g, b, h, t0, rows, n, dh);
    for (int i = threadIdx.x; i < rows; i += blockDim.x) cp_async16(st + i, gst + t0 + i, true);
    cp_async_wait_all();
    __syncthreads();
  };

  // this lane's ldmatrix offsets: an A tile (rows 0-15, two column halves); B from rows (two
  // 8-row halves as the two n-tiles, two column halves as k); B through .trans (rows as k)
  const int aoff = (lane % 16) * LD + (lane / 16) * 8;
  const int boff = (lane % 8 + (lane / 16) * 8) * LD + (lane / 8 % 2) * 8;
  const int toff = (lane % 8 + (lane / 8 % 2) * 8) * LD + (lane / 16) * 8;
  const int col = 2 * (lane % 4);  // accumulator columns col, col + 1 of each n-tile

  // phase 1: 16-query strips -> (m, l, D) and dQ; every warp runs every round (a streamed
  // head's tiles are staged by the whole block), a warp past the last strip only helps stage
  for (int base = 0; base < np; base += step) {
    const int i0 = base + warp * 16;
    const bool active = i0 < np;
    uint32_t qa[KD][4], ga[KD][4];
    if (whole && active) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        ldsm4(qa[kk], qs + i0 * LD + aoff + kk * 16);
        ldsm4(ga[kk], gs + i0 * LD + aoff + kk * 16);
      }
    } else if (!whole) {
      load_a_strip<KD>(qa, o.q, b, h, i0, n, dh, lane);
      load_a_strip<KD>(ga, o.g, b, h, i0, n, dh, lane);
    }
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
    for (int t0 = 0; t0 < np; t0 += T) {
      stage_keys(t0);
      const int rows = min(T, np - t0);
      for (int j0 = 0; active && j0 < rows; j0 += 16) {
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
    }
    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(l[r]);
        d[r] = quad_sum(d[r]) / l[r];
        l[r] = 1.f / l[r];  // A = e * (1 / l) from here on
        if (lane % 4 == 0) gst[i0 + lane / 4 + 8 * r] = make_float4(m[r], l[r], d[r], 0.f);
      }
    }

    float dq[2 * KD][4];
#pragma unroll
    for (int t = 0; t < 2 * KD; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[t][e] = 0.f;
    }
    for (int t0 = 0; t0 < np; t0 += T) {
      stage_keys(t0);
      const int rows = min(T, np - t0);
      for (int j0 = 0; active && j0 < rows; j0 += 16) {
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
    }
    if (active) store_strip<KD>(o.dq, b, h, dq, i0, n, dh, lane);
  }
  __syncthreads();  // the statistics (shared or global) are complete

  // phase 2: 16-key strips -> dK and dV over every query
  for (int base = 0; base < np; base += step) {
    const int j0 = base + warp * 16;
    const bool active = j0 < np;
    uint32_t ka[KD][4], va[KD][4];
    float bj[2];
    if (whole && active) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        ldsm4(ka[kk], ks + j0 * LD + aoff + kk * 16);
        ldsm4(va[kk], vs + j0 * LD + aoff + kk * 16);
      }
      bj[0] = bs[j0 + lane / 4];
      bj[1] = bs[j0 + lane / 4 + 8];
    } else if (!whole) {
      load_a_strip<KD>(ka, o.k, b, h, j0, n, dh, lane);
      load_a_strip<KD>(va, o.v, b, h, j0, n, dh, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = j0 + lane / 4 + 8 * r;
        bj[r] = j < n ? (bias_b ? bias_b[j] : 0.f) : -INFINITY;
      }
    }
    float dk[2 * KD][4], dv[2 * KD][4];
#pragma unroll
    for (int t = 0; t < 2 * KD; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[t][e] = dv[t][e] = 0.f;
    }
    // padded queries need no guard: their q and g rows are zeros and their (m, 1 / l, D) finite
    for (int t0 = 0; t0 < np; t0 += T) {
      stage_queries(t0);
      const int rows = min(T, np - t0);
      for (int i0 = 0; active && i0 < rows; i0 += 16) {
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
    }
    if (active) {
      store_strip<KD>(o.dk, b, h, dk, j0, n, dh, lane);
      store_strip<KD>(o.dv, b, h, dv, j0, n, dh, lane);
    }
  }
}

template <int KD>
int launch_bwd_mma_t(const BwdOperands& o, const float* bias, float* stats, int batch, int heads, int n, int dh,
                     float scale, cudaStream_t stream) {
  const size_t smem = bwd_mma_smem_bytes(n, dh);
  const int err = allow_mma_smem(bwd_mma_kernel<KD>, smem);
  if (err) return err;
  const int strips = (n + 15) / 16, warps = strips < kMmaWarps ? strips : kMmaWarps;
  bwd_mma_kernel<KD><<<dim3(heads, batch), warps * 32, smem, stream>>>(o, bias, reinterpret_cast<float4*>(stats), n, dh,
                                                                       scale, bwd_mma_tile(n, dh));
  return (int)cudaGetLastError();
}

// The backward on `stream` by the body bwd_body picks; returns cudaGetLastError() (0 on
// success). `bias` may be null; `stats` is f32 scratch of bwd_scratch_floats values (null when that is 0).
inline int launch_bwd(const BwdOperands& o, const void* bias, void* stats, int batch, int heads, int n, int dh,
                      float scale, int elem_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bi = static_cast<const float*>(bias);
  float* st = static_cast<float*>(stats);
  if (bwd_body(elem_bytes) == kTf32x3) return launch_bwd_tf32(o, bi, st, batch, heads, n, dh, scale, s);
  switch ((dh + 15) / 16) {
    case 1: return launch_bwd_mma_t<1>(o, bi, st, batch, heads, n, dh, scale, s);
    case 2: return launch_bwd_mma_t<2>(o, bi, st, batch, heads, n, dh, scale, s);
    case 3: return launch_bwd_mma_t<3>(o, bi, st, batch, heads, n, dh, scale, s);
    case 4: return launch_bwd_mma_t<4>(o, bi, st, batch, heads, n, dh, scale, s);
    case 5: return launch_bwd_mma_t<5>(o, bi, st, batch, heads, n, dh, scale, s);
    case 6: return launch_bwd_mma_t<6>(o, bi, st, batch, heads, n, dh, scale, s);
    case 7: return launch_bwd_mma_t<7>(o, bi, st, batch, heads, n, dh, scale, s);
    case 8: return launch_bwd_mma_t<8>(o, bi, st, batch, heads, n, dh, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace m3l
