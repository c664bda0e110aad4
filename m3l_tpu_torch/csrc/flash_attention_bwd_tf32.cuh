// The f32 attention backward on the tensor cores (sm_90a), shared by both interfaces.
//
// Same function as the bf16 body (flash_attention_bwd_mma.cuh), in f32:
//
//   S = (Q K^T) * scale + bias[b];  A = exp(S - rowmax) / rowsum                     f32
//   dV = A^T g;  dA = g V^T;  D = rowsum(dA o A);  dS = (A o (dA - D)) * scale;
//   dQ = dS K;  dK = dS^T Q        (A unrounded; every sum in f32)
//
// Precision ("3xTF32", flash_attention_mma.cuh): every product is three mma.sync.m16n8k8 TF32
// products of split operands into one f32 accumulator, S, dA, dQ, dK and dV alike, each held to
// about 2^-21 of its size, far inside flash_attention_qkv_bwd_tolerance's 2e-5 (emulated on the
// CPU in tests/test_torch_attention_f32_mma.py). dQ, dK and dV sum over a whole sweep, and the
// tensor cores round a running sum worse than an f32 add (their errors pile up in one direction):
// summed in the accumulators themselves, dK and dV erred by ~2e-6 of the sum of |terms|, 3-4x the
// plain version, and under DINO's block key masks, where a few kept keys take all the attention
// (|dV| to 13), by 2.6e-5 on the H100, past the bound. So each 8-key (phase 1) or 8-query (phase 2) step
// sums its products in an accumulator of its own, started at zero, and adds it to dQ, dK or dV
// in f32, as the forward adds each chunk's e V to O.
//
// Layout: one block per (head, batch row), W <= 8 warps (as many as make the rounds of strips
// even: 7 for the 13 strips of N = 196), running both phases; a streamed head (below) runs
// each phase as its own launch of one block per round of strips. Only the B side of each product is staged in shared memory
// as f32 (rows of Dh + 4 floats): the A side, a warp's own 16-row strip, is read straight from
// global memory and split once into registers (up to Dh = 64; a wider head reads it again from
// L1 at each use).
//
//   phase 1, warps own 16-query strips of Q and g, with K, V and the key bias staged: sweep the
//     keys 16 at a time for S and dA with the online row max m, sum l and D = sum(e dA) / l,
//     reduced over the quad of lanes that holds a row; sweep again for A = e * (1 / l), dS and
//     dQ = dS K (dS's accumulator as the A operand, keys in the order of split_c_as_a, so K is
//     read at rows 2t and 2t + 1); write dQ and keep (m, 1 / l, D) of every query.
//   phase 2 (after one __syncthreads), warps own 16-key strips of K and V, with Q, g and the
//     statistics staged: sweep the queries 8 at a time for S^T and dA^T, A and dS from the
//     statistics, and dV += A^T g, dK += dS^T Q in registers; write dK and dV once.
//
// A head whose two staged tables, key bias and statistics fit the 227 KB a block can opt in to on
// sm_90 (N <= 400 at Dh = 64, N <= 208 at Dh = 128) is staged whole, once a phase, and the
// statistics stay in shared memory. A longer head streams both phases' tables in tiles of
// kTf32BwdTile rows, all warps of a block on one tile at a time, and the statistics go to a
// global f32 scratch (np float4 per head) from which the phase 2 launch stages them with each
// tile of queries. Keys (phase 1) and queries (phase 2) are visited in the same order either way, so a
// head gives the same bits staged whole or streamed. Padded keys get the bias -inf; padded query
// rows compute on zeros (their q and g rows) and are never written; a fully masked row stays
// uniform over its real keys.
//
// No atomics: the result is deterministic. S and dA are recomputed three times (twice in phase 1,
// once in phase 2), so the body runs 9 N^2 Dh multiply-adds a head where the function needs 5,
// each as three TF32 products: 54 N^2 Dh FLOP of TF32 for the function's 10 N^2 Dh.
#pragma once

#include "flash_attention_mma.cuh"

namespace m3l {
namespace {

constexpr int kTf32BwdWarps = 8;   // at most, warps per block
constexpr int kTf32BwdTile = 128;  // keys or queries per staged tile of a head too long to stage whole

// Shared memory of one staged row: two f32 table rows (Dh rounded up to 16, plus 4), its key bias
// and its query's (m, 1 / l, D, 0) (float4).
inline size_t bwd_tf32_row_bytes(int dh) { return 8 * ((dh + 15) / 16 * 16 + 4) + 20; }

// Rows per staged tile: the whole head (N rounded up to 16) where it fits, else kTf32BwdTile.
inline int bwd_tf32_tile(int n, int dh) {
  const int np = (n + 15) / 16 * 16;
  return np * bwd_tf32_row_bytes(dh) <= kSmemOptin ? np : kTf32BwdTile;
}

inline size_t bwd_tf32_smem_bytes(int n, int dh) { return bwd_tf32_tile(n, dh) * bwd_tf32_row_bytes(dh); }

// f32 scratch of a streamed head: (m, 1 / l, D, 0) of every padded query; none for a head staged whole.
inline size_t bwd_tf32_scratch_floats(int batch, int heads, int n, int dh) {
  const int np = (n + 15) / 16 * 16;
  return bwd_tf32_tile(n, dh) == np ? 0 : (size_t)batch * heads * np * 4;
}

// Warps per block: at most kTf32BwdWarps, as few as keep the number of rounds of 16-row strips.
inline int bwd_tf32_warps(int n) {
  const int strips = (n + 15) / 16, rounds = (strips + kTf32BwdWarps - 1) / kTf32BwdWarps;
  return (strips + rounds - 1) / rounds;
}

// x[nt] += (A strip xa) times rows r0 + 8 nt .. + 7 of the table xs, transposed, for NT 8-row
// n-tiles; y likewise from ya and ys: the scores and dA (phase 1) or their transposes (phase 2).
template <int KD, int MODE, int NT>
__device__ __forceinline__ void two_products_tf32(const AStrip<KD, MODE>& xa, const AStrip<KD, MODE>& ya,
                                                  const float* xs, const float* ys, int r0, float (&x)[NT][4],
                                                  float (&y)[NT][4]) {
  constexpr int LD = 16 * KD + 4;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[nt][e] = y[nt][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < 2 * KD; ++kk) {
    uint32_t xh[4], xl[4], yh[4], yl[4];
    xa.get(kk, xh, xl);
    ya.get(kk, yh, yl);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int off = (r0 + 8 * nt + lane / 4) * LD + 8 * kk + lane % 4;
      mma3_pair(x[nt], xh, xl, xs[off], xs[off + 4], y[nt], yh, yl, ys[off], ys[off + 4]);
    }
  }
}

template <int KD>  // head dim padded to 16 * KD
__global__ void __launch_bounds__(kTf32BwdWarps * 32, 1)
bwd_tf32_kernel(BwdOperands o, const float* __restrict__ bias, float4* __restrict__ stats, int n, int dh, float scale,
                int tile, int phases) {
  constexpr int LD = 16 * KD + 4, KS = 2 * KD, MODE = KD <= 4 ? kHeldSplit : kReload;
  extern __shared__ __align__(16) uint32_t smem[];
  const int np = (n + 15) / 16 * 16, T = tile;
  const bool whole = T == np;  // block-uniform: each phase's tables staged once, else tile by tile
  float* const xs = reinterpret_cast<float*>(smem);  // phase 1: K; phase 2: Q
  float* const ys = xs + T * LD;                     // phase 1: V; phase 2: g
  float* const bs = ys + T * LD;                     // key bias of the staged keys
  float4* const st = reinterpret_cast<float4*>(bs + T);  // (m, 1 / l, D, 0) of the staged queries; 16-byte aligned

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  // this block's rounds of strips: all of them (one block a head), or every gridDim.x-th
  const int first = blockIdx.x * blockDim.x / 32 * 16, step = gridDim.x * blockDim.x / 32 * 16;
  const float* bias_b = bias ? bias + (size_t)b * n : nullptr;
  float4* const gst = whole ? st : stats + ((size_t)b * gridDim.y + h) * np;  // where phase 1 writes the statistics

  // a tile of keys (phase 1) or queries (phase 2) from row t0: every warp has left the previous
  // one before it is overwritten, and the first query tile waits for phase 1's statistics
  auto stage_keys = [&](int t0) {
    __syncthreads();
    const int rows = min(T, np - t0);
    stage_rows_f32<KD>(xs, o.k, ys, o.v, b, h, t0, rows, n, dh);
    stage_bias(bs, bias_b, t0, rows, n);
    cp_async_wait_all();
    __syncthreads();
  };
  auto stage_queries = [&](int t0) {
    __syncthreads();
    const int rows = min(T, np - t0);
    stage_rows_f32<KD>(xs, o.q, ys, o.g, b, h, t0, rows, n, dh);
    if (!whole) {
      for (int i = threadIdx.x; i < rows; i += blockDim.x) cp_async16(st + i, gst + t0 + i, true);
    }
    cp_async_wait_all();
    __syncthreads();
  };

  // phase 1: 16-query strips -> (m, l, D) and dQ; every warp runs every round (a streamed head's
  // tiles are staged by the whole block), a warp past the last strip only helps stage
  if (whole && (phases & 1)) stage_keys(0);
  for (int base = first; (phases & 1) && base < np; base += step) {
    const int i0 = base + warp * 16;
    const bool active = i0 < np;
    AStrip<KD, MODE> qa, ga;
    qa.load(o.q, b, h, i0, n, dh);
    ga.load(o.g, b, h, i0, n, dh);

    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
    for (int t0 = 0; t0 < np; t0 += T) {
      if (!whole) stage_keys(t0);
      const int rows = min(T, np - t0);
      for (int j0 = 0; active && j0 < rows; j0 += 16) {
        float s[2][4], da[2][4];
        two_products_tf32(qa, ga, xs, ys, j0, s, da);
        float mc[2] = {m[0], m[1]};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[nt][e] = fmaf(s[nt][e], scale, bs[j0 + 8 * nt + 2 * t4 + e % 2]);
            mc[e / 2] = fmaxf(mc[e / 2], s[nt][e]);
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
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = expf(s[nt][e] - m[e / 2]);
            l[e / 2] += p;
            d[e / 2] = fmaf(p, da[nt][e], d[e / 2]);
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
        if (t4 == 0) gst[i0 + g + 8 * r] = make_float4(m[r], l[r], d[r], 0.f);
      }
    }

    float dq[KS][4];
#pragma unroll
    for (int c = 0; c < KS; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[c][e] = 0.f;
    }
    for (int t0 = 0; t0 < np; t0 += T) {
      if (!whole) stage_keys(t0);
      const int rows = min(T, np - t0);
      for (int j0 = 0; active && j0 < rows; j0 += 16) {
        float s[2][4], da[2][4];
        two_products_tf32(qa, ga, xs, ys, j0, s, da);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t sh[4], sl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e / 2;
            const float a = expf(fmaf(s[nt][e], scale, bs[j0 + 8 * nt + 2 * t4 + e % 2]) - m[r]) * l[r];
            da[nt][e] = (a * (da[nt][e] - d[r])) * scale;  // dS
          }
          split_c_as_a(da[nt], sh, sl);
          const float* kr = xs + (j0 + 8 * nt + 2 * t4) * LD + g;  // keys 2t and 2t + 1, column g
#pragma unroll
          for (int c = 0; c < KS; c += 2) {
            float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};  // these 8 keys' dS K
            mma3_pair(p0, sh, sl, kr[8 * c], kr[LD + 8 * c], p1, sh, sl, kr[8 * c + 8], kr[LD + 8 * c + 8]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dq[c][e] += p0[e];
              dq[c + 1][e] += p1[e];
            }
          }
        }
      }
    }
    if (active) store_strip_f32<KD>(o.dq, b, h, dq, i0, n, dh, lane);
  }

  // phase 2: 16-key strips -> dK and dV over every query
  if (whole && (phases & 2)) stage_queries(0);
  for (int base = first; (phases & 2) && base < np; base += step) {
    const int j0 = base + warp * 16;
    const bool active = j0 < np;
    AStrip<KD, MODE> ka, va;
    ka.load(o.k, b, h, j0, n, dh);
    va.load(o.v, b, h, j0, n, dh);
    float bj[2];  // the bias of keys j0 + g and j0 + g + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = j0 + g + 8 * r;
      bj[r] = j < n ? (bias_b ? bias_b[j] : 0.f) : -INFINITY;
    }
    float dk[KS][4], dv[KS][4];
#pragma unroll
    for (int c = 0; c < KS; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[c][e] = dv[c][e] = 0.f;
    }
    // padded queries need no guard: their q and g rows are zeros and their (m, 1 / l, D) finite
    for (int t0 = 0; t0 < np; t0 += T) {
      if (!whole) stage_queries(t0);
      const int rows = min(T, np - t0);
      for (int i0 = 0; active && i0 < rows; i0 += 8) {
        float s[1][4], da[1][4];  // S^T, dA^T: rows keys, columns queries
        two_products_tf32(ka, va, xs, ys, i0, s, da);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 q = st[i0 + 2 * t4 + e % 2];
          const float a = expf(fmaf(s[0][e], scale, bj[e / 2]) - q.x) * q.y;
          s[0][e] = a;
          da[0][e] = (a * (da[0][e] - q.z)) * scale;
        }
        uint32_t ph[4], pl[4], sh[4], sl[4];
        split_c_as_a(s[0], ph, pl);
        split_c_as_a(da[0], sh, sl);
        const int off = (i0 + 2 * t4) * LD + g;  // queries 2t and 2t + 1, column g
#pragma unroll
        for (int c = 0; c < KS; ++c) {
          float pv[4] = {0.f, 0.f, 0.f, 0.f}, pk[4] = {0.f, 0.f, 0.f, 0.f};  // these 8 queries' A^T g and dS^T Q
          mma3_pair(pv, ph, pl, ys[off + 8 * c], ys[off + LD + 8 * c], pk, sh, sl, xs[off + 8 * c], xs[off + LD + 8 * c]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dv[c][e] += pv[e];
            dk[c][e] += pk[e];
          }
        }
      }
    }
    if (active) {
      store_strip_f32<KD>(o.dk, b, h, dk, j0, n, dh, lane);
      store_strip_f32<KD>(o.dv, b, h, dv, j0, n, dh, lane);
    }
  }
}

// A head staged whole runs both phases in one block per (head, batch row). A streamed head runs
// phase 1 and then phase 2 as two launches of one block per round of strips, so a long head
// spreads over the card; the statistics pass between them through the scratch.
template <int KD>
int launch_bwd_tf32_t(const BwdOperands& o, const float* bias, float* stats, int batch, int heads, int n, int dh,
                      float scale, cudaStream_t stream) {
  const size_t smem = bwd_tf32_smem_bytes(n, dh);
  int err = allow_mma_smem(bwd_tf32_kernel<KD>, smem);
  if (err) return err;
  const int tile = bwd_tf32_tile(n, dh), np = (n + 15) / 16 * 16, warps = bwd_tf32_warps(n);
  const int rounds = (np / 16 + warps - 1) / warps;
  float4* st = reinterpret_cast<float4*>(stats);
  if (tile == np) {
    bwd_tf32_kernel<KD><<<dim3(1, heads, batch), warps * 32, smem, stream>>>(o, bias, st, n, dh, scale, tile, 3);
    return (int)cudaGetLastError();
  }
  for (int phase = 1; phase <= 2; ++phase) {
    bwd_tf32_kernel<KD><<<dim3(rounds, heads, batch), warps * 32, smem, stream>>>(o, bias, st, n, dh, scale, tile, phase);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

inline int launch_bwd_tf32(const BwdOperands& o, const float* bias, float* stats, int batch, int heads, int n, int dh,
                           float scale, cudaStream_t s) {
  switch ((dh + 15) / 16) {
    case 1: return launch_bwd_tf32_t<1>(o, bias, stats, batch, heads, n, dh, scale, s);
    case 2: return launch_bwd_tf32_t<2>(o, bias, stats, batch, heads, n, dh, scale, s);
    case 3: return launch_bwd_tf32_t<3>(o, bias, stats, batch, heads, n, dh, scale, s);
    case 4: return launch_bwd_tf32_t<4>(o, bias, stats, batch, heads, n, dh, scale, s);
    case 5: return launch_bwd_tf32_t<5>(o, bias, stats, batch, heads, n, dh, scale, s);
    case 6: return launch_bwd_tf32_t<6>(o, bias, stats, batch, heads, n, dh, scale, s);
    case 7: return launch_bwd_tf32_t<7>(o, bias, stats, batch, heads, n, dh, scale, s);
    case 8: return launch_bwd_tf32_t<8>(o, bias, stats, batch, heads, n, dh, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace m3l
