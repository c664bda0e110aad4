// The attention kernels' bodies, shared by both interfaces (sm_90a).
//
// The packed pair (flash_attention_qkv_fwd.cu, flash_attention_qkv_bwd.cu) and the split-head
// pair (flash_attention_fwd.cu, flash_attention_bwd.cu) compute one function:
//
//   S = (Q K^T) * scale + bias[b];  A = exp(S - rowmax) / rowsum               f32
//   forward:  O = round_to_input_type(A) V                                     sums in f32
//   backward: dV = A^T g;  dA = g V^T;  dS = (A o (dA - rowsum(dA o A))) * scale;
//             dQ = dS K;  dK = dS^T Q   (A unrounded; every product and sum in f32)
//
// and differ only in where the head rows of (b, h) lie. A `Rows` descriptor holds that rule for
// one operand: the base pointer of block (b, h) and the row stride, in 32-bit words. Packed qkv
// (B, N, 3*H*Dh) is "batch B, heads H, row stride 3*H*Dh/E", q at word offset 0, k at H*Dh/E,
// v at 2*H*Dh/E; split q, k, v (B*H, N, Dh) are "batch B*H, heads 1, row stride Dh/E". The key
// bias is one f32 row of N per batch index (B rows, or B*H rows for the split layout). The
// arithmetic, and so every result bit, does not depend on the descriptor.
//
// Forward grid (ceil(N / 32), heads, batch): each block stages K and V of one (b, h) in shared
// memory (16-byte loads, K rows padded by one word so a warp's lanes, each on its own key, hit
// distinct banks), and 4 warps of 8 query rows each build their rows' f32 scores there.
//
// Backward: on the TPU one grid step holds all queries and keys of its batch rows and the grid
// runs in order. Here blocks run in parallel and dK, dV sum over all queries, so the kernel runs
// two deterministic passes (no atomics) on the caller's stream, one block of 4 warps per
// (32-row tile, head, batch row) each:
//
//   pass 1 (query tiles): stage K and V of (b, h); recompute the tile's full score rows, the row
//     max m and sum l, A and dA = g V^T, then D = rowsum(dA o A), dS and dQ = dS K. Writes dQ
//     and (m, l, D) to an f32 (batch, heads, N, 3) scratch the wrapper allocates.
//   pass 2 (key tiles): stage Q, g and (m, l, D) of (b, h); recompute A_ij = exp(s_ij - m_i) / l_i
//     and dS_ij for the tile's keys against every query, then dV_j = sum_i A_ij g_i and
//     dK_j = sum_i dS_ij q_i. Scores are summed over Dh in the same order in both passes (and
//     scaled with one explicit fma), so pass 2 recomputes pass 1's A bit for bit.
//
// Length. A head whose tables fit the shared memory a block can opt in to (N <= 348 forward,
// N <= 274 backward at Dh = 64) is staged whole, once. A longer head streams its K and V (forward,
// pass 1) or Q, g and statistics (pass 2) in tiles of kF32Tile rows, and the rows that need a
// whole row's max or sum sweep the tiles again: forward max, sum, then A V (three sweeps); pass 1
// max, sum, D, then dS and dQ (four). Every lane keeps its own keys in the same order (the tile
// is a multiple of 32) and every sequential sum runs over the keys or queries in order, so a
// head gives the same bits staged whole or streamed.
//
// These bodies compute on the CUDA cores in f32, the body of f32 inputs, bit for bit as first
// ported; every bf16 input runs the tensor-core bodies of flash_attention_fwd_mma.cuh and
// flash_attention_bwd_mma.cuh (the rules are fwd_body and bwd_body). The source notes of the
// four .cu files give the bounds on the H100.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "flash_attention_common.cuh"

namespace m3l {
namespace {  // each .cu is its own library: internal linkage keeps their kernels apart

constexpr int kWarps = 4;              // warps per block
constexpr int kRows = 8;               // query rows (forward, pass 1) or keys (pass 2) per warp
constexpr int kTile = kWarps * kRows;  // rows per block
constexpr int kMaxDh = 128;
constexpr int kF32Tile = 64;           // rows per staged tile of a head too long to stage whole; a multiple of 32
constexpr size_t kSmemOptin = 232448;  // sm_90: the most dynamic shared memory of one block

// One operand's head rows, in 32-bit words: head h of batch row b starts at
// base + b * batch + h * head, and its rows are `row` words apart.
template <typename W>
struct Rows {
  W* base;
  size_t batch;
  int head;
  int row;
  __device__ W* at(int b, int h) const { return base + b * batch + (size_t)h * head; }
};
using In = Rows<const uint32_t>;
using Out = Rows<uint32_t>;

inline bool valid_shape(int batch, int n, int heads, int dh, int elem_bytes) {
  return dh % 8 == 0 && dh <= kMaxDh && n >= 1 && batch >= 1 && heads >= 1 && (elem_bytes == 2 || elem_bytes == 4);
}

// ---------------------------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------------------------

struct FwdLayout {
  int dw;        // 32-bit words in one head row of q, k or v
  int kw;        // padded K row stride in words
  int vs_off;    // word offsets of V, Q and P in shared memory
  int qs_off;
  int ps_off;
  int words;     // total words
};

// Shared memory for a tile of kt keys (kt = N for a head staged whole).
__host__ __device__ inline FwdLayout fwd_layout(int kt, int dh, int elem_bytes) {
  FwdLayout l;
  l.dw = dh * elem_bytes / 4;
  l.kw = l.dw + 1;
  l.vs_off = (kt * l.kw + 3) / 4 * 4;   // V rows are read and written as 16-byte vectors
  l.qs_off = l.vs_off + kt * l.dw;
  l.ps_off = l.qs_off + kTile * dh;
  l.words = l.ps_off + kTile * kt;
  return l;
}

// Keys per staged tile: N where the whole head fits, else kF32Tile.
inline int fwd_tile(int n, int dh, int elem_bytes) {
  return (size_t)fwd_layout(n, dh, elem_bytes).words * 4 <= kSmemOptin ? n : kF32Tile;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
fwd_kernel(In q, In k, In v, const float* __restrict__ bias, Out out, int n, int dh, float scale, int kt) {
  constexpr int E = Elem<T>::kPerWord;
  constexpr int kLaneWords = 4 / E;    // dh <= 128: at most this many output words per lane
  extern __shared__ __align__(16) uint32_t smem[];

  const FwdLayout l = fwd_layout(kt, dh, sizeof(T));
  const int dw = l.dw, kw = l.kw;
  uint32_t* ks = smem;
  uint32_t* vs = smem + l.vs_off;
  float* qs = reinterpret_cast<float*>(smem + l.qs_off);
  float* ps = reinterpret_cast<float*>(smem + l.ps_off);
  const bool whole = kt == n;  // block-uniform: K and V staged once and the scores kept

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const uint32_t* qb = q.at(b, h);
  const uint32_t* kb = k.at(b, h);
  const uint32_t* vb = v.at(b, h);

  // each warp stages its own query rows in f32; rows past N are zeros and are never written
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = tile * kTile + warp * kRows;
  const bool active = q0 < n;  // warp-uniform: a warp past N only helps stage
  float* qw = qs + warp * kRows * dh;
  float* pw = ps + warp * kRows * kt;
  for (int i = lane; i < kRows * dw; i += 32) {
    const int r = i / dw, c = i % dw;
    float f[E];
    if (q0 + r < n) {
      Elem<T>::unpack(qb[(size_t)(q0 + r) * q.row + c], f);
    } else {
      for (int e = 0; e < E; ++e) f[e] = 0.f;
    }
    for (int e = 0; e < E; ++e) qw[r * dh + c * E + e] = f[e];
  }

  const float* bias_b = bias ? bias + (size_t)b * n : nullptr;
  float m[kRows], sum[kRows];  // each row's max and sum: lane partials, then the warp's
#pragma unroll
  for (int r = 0; r < kRows; ++r) m[r] = -INFINITY, sum[r] = 0.f;
  float acc[kRows][kLaneWords * E];  // O = A V: lane owns output words lane, lane + 32, ... of the row
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int t = 0; t < kLaneWords * E; ++t) acc[r][t] = 0.f;
  }

  // sweep 0: row max; 1: row sum; 2: A rounded to the input type (as A.astype(v.dtype)) and A V.
  // A head staged whole scores once and keeps e in place of its scores from sweep 1 on.
  for (int sweep = 0; sweep < 3; ++sweep) {
    for (int t0 = 0; t0 < n; t0 += kt) {
      const int cnt = min(kt, n - t0);
      if (!whole || (sweep == 0 && t0 == 0)) {
        // stage K (padded rows) and, for the last sweep or a whole head, V, 16 bytes per load
        if (!whole) __syncthreads();  // every warp has left the previous tile
        const int vecs = dw / 4;
        const bool with_v = whole || sweep == 2;
        for (int i = threadIdx.x; i < cnt * vecs; i += blockDim.x) {
          const int j = i / vecs, c = (i % vecs) * 4;
          const uint4 kv = *reinterpret_cast<const uint4*>(kb + (size_t)(t0 + j) * k.row + c);
          uint32_t* kd = ks + j * kw + c;
          kd[0] = kv.x;
          kd[1] = kv.y;
          kd[2] = kv.z;
          kd[3] = kv.w;
          if (with_v) *reinterpret_cast<uint4*>(vs + j * dw + c) = *reinterpret_cast<const uint4*>(vb + (size_t)(t0 + j) * v.row + c);
        }
        __syncthreads();
        // scores: lane j owns keys j, j + 32, ...; the rows of the warp share each K word
        for (int j = lane; active && j < cnt; j += 32) {
          float sc[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
          const uint32_t* kr = ks + j * kw;
#pragma unroll 4
          for (int c = 0; c < dw; ++c) {
            float kf[E];
            Elem<T>::unpack(kr[c], kf);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
#pragma unroll
              for (int e = 0; e < E; ++e) sc[r] = fmaf(qw[r * dh + c * E + e], kf[e], sc[r]);
            }
          }
          const float bj = bias_b ? bias_b[t0 + j] : 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) pw[r * kt + j] = sc[r] * scale + bj;
        }
        __syncwarp();
      }
      if (!active) continue;
      for (int r = 0; r < kRows; ++r) {
        float* pr = pw + r * kt;
        for (int j = lane; j < cnt; j += 32) {
          if (sweep == 0) {
            m[r] = fmaxf(m[r], pr[j]);
          } else if (sweep == 1) {
            const float e = expf(pr[j] - m[r]);
            if (whole) pr[j] = e;
            sum[r] += e;
          } else {
            pr[j] = Elem<T>::round((whole ? pr[j] : expf(pr[j] - m[r])) / sum[r]);
          }
        }
      }
      if (sweep < 2) continue;
      __syncwarp();
      for (int j = 0; j < cnt; ++j) {
        const uint32_t* vr = vs + j * dw;
        float vf[kLaneWords][E];
#pragma unroll
        for (int t = 0; t < kLaneWords; ++t) {
          const int c = lane + 32 * t;
          if (c < dw) {
            Elem<T>::unpack(vr[c], vf[t]);
          } else {
            for (int e = 0; e < E; ++e) vf[t][e] = 0.f;
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = pw[r * kt + j];
#pragma unroll
          for (int t = 0; t < kLaneWords; ++t) {
#pragma unroll
            for (int e = 0; e < E; ++e) acc[r][t * E + e] = fmaf(p, vf[t][e], acc[r][t * E + e]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (sweep == 0) m[r] = warp_max(m[r]);
      if (sweep == 1) sum[r] = warp_sum(sum[r]);
    }
  }
  if (!active) return;

  uint32_t* ob = out.at(b, h);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (q0 + r >= n) break;
#pragma unroll
    for (int t = 0; t < kLaneWords; ++t) {
      const int c = lane + 32 * t;
      if (c < dw) ob[(size_t)(q0 + r) * out.row + c] = Elem<T>::pack(&acc[r][t * E]);
    }
  }
}

template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int launch_fwd_t(In q, In k, In v, const float* bias, Out out, int batch, int heads, int n, int dh, float scale,
                 cudaStream_t stream) {
  const int kt = fwd_tile(n, dh, sizeof(T));
  const size_t smem = (size_t)fwd_layout(kt, dh, sizeof(T)).words * 4;
  const int err = allow_smem(fwd_kernel<T>, smem);
  if (err) return err;
  const dim3 grid((n + kTile - 1) / kTile, heads, batch);
  fwd_kernel<T><<<grid, kWarps * 32, smem, stream>>>(q, k, v, bias, out, n, dh, scale, kt);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------------------------

// Shared memory of either pass for tiles of kt rows (kt = N for a head staged whole), in 32-bit
// words: two padded (kt, Dh) head tables (pass 1: K and V; pass 2: Q and g), the warps' own rows
// in f32 (pass 1: q and g; pass 2: k and v), two f32 (kTile, kt) tiles (pass 1: scores/A and
// dA/dS; pass 2: A and dS transposed, one row per key), and in pass 2 the (m, l, D) of the
// staged queries.
struct BwdLayout {
  int dw;        // 32-bit words in one head row
  int kw;        // padded row stride of the staged tables
  int t1_off, own_a_off, own_b_off, p_off, d_off, st_off;
  int words;
};

__host__ __device__ inline BwdLayout bwd_layout(int kt, int dh, int elem_bytes, bool with_stats) {
  BwdLayout l;
  l.dw = dh * elem_bytes / 4;
  l.kw = l.dw + 1;
  l.t1_off = kt * l.kw;
  l.own_a_off = 2 * kt * l.kw;
  l.own_b_off = l.own_a_off + kTile * dh;
  l.p_off = l.own_b_off + kTile * dh;
  l.d_off = l.p_off + kTile * kt;
  l.st_off = l.d_off + kTile * kt;
  l.words = l.st_off + (with_stats ? 3 * kt : 0);
  return l;
}

// Rows per staged tile of both passes: N where the whole head fits (the larger pass, with its
// statistics), else kF32Tile.
inline int bwd_tile(int n, int dh, int elem_bytes) {
  return (size_t)bwd_layout(n, dh, elem_bytes, true).words * 4 <= kSmemOptin ? n : kF32Tile;
}

// Stage the rows r0 .. r0 + rows - 1 of the head rows at `a` and `b` (row strides a_row, b_row)
// into padded tables ta / tb, 16 bytes per load.
__device__ inline void stage_tables(const uint32_t* a, int a_row, const uint32_t* b, int b_row, int r0, int rows, int dw,
                                    int kw, uint32_t* ta, uint32_t* tb) {
  const int vecs = dw / 4;
  for (int i = threadIdx.x; i < rows * vecs; i += blockDim.x) {
    const int j = i / vecs, c = (i % vecs) * 4;
    const uint4 av = *reinterpret_cast<const uint4*>(a + (size_t)(r0 + j) * a_row + c);
    const uint4 bv = *reinterpret_cast<const uint4*>(b + (size_t)(r0 + j) * b_row + c);
    uint32_t* ad = ta + j * kw + c;
    uint32_t* bd = tb + j * kw + c;
    ad[0] = av.x; ad[1] = av.y; ad[2] = av.z; ad[3] = av.w;
    bd[0] = bv.x; bd[1] = bv.y; bd[2] = bv.z; bd[3] = bv.w;
  }
}

// Stage a warp's kRows rows (from row r0) of two head row sets in f32; rows past n are zeros.
template <typename T>
__device__ inline void stage_own(const uint32_t* a, int a_row, const uint32_t* b, int b_row, int r0, int n, int dw,
                                 int dh, float* fa, float* fb) {
  constexpr int E = Elem<T>::kPerWord;
  const int lane = threadIdx.x % 32;
  for (int i = lane; i < kRows * dw; i += 32) {
    const int r = i / dw, c = i % dw;
    float xa[E], xb[E];
    if (r0 + r < n) {
      Elem<T>::unpack(a[(size_t)(r0 + r) * a_row + c], xa);
      Elem<T>::unpack(b[(size_t)(r0 + r) * b_row + c], xb);
    } else {
      for (int e = 0; e < E; ++e) xa[e] = xb[e] = 0.f;
    }
    for (int e = 0; e < E; ++e) {
      fa[r * dh + c * E + e] = xa[e];
      fb[r * dh + c * E + e] = xb[e];
    }
  }
}

// For the table row `row` (padded words) and the warp's kRows own f32 rows: the dot product of
// every own row with the table row, for two table/own pairs at once. The sum runs over Dh in
// the same order in both passes.
template <typename T>
__device__ inline void dots(const uint32_t* ra, const uint32_t* rb, const float* fa, const float* fb, int dw,
                            int dh, float* acc_a, float* acc_b) {
  constexpr int E = Elem<T>::kPerWord;
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc_a[r] = acc_b[r] = 0.f;
#pragma unroll 4
  for (int c = 0; c < dw; ++c) {
    float xa[E], xb[E];
    Elem<T>::unpack(ra[c], xa);
    Elem<T>::unpack(rb[c], xb);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        acc_a[r] = fmaf(fa[r * dh + c * E + e], xa[e], acc_a[r]);
        acc_b[r] = fmaf(fb[r * dh + c * E + e], xb[e], acc_b[r]);
      }
    }
  }
}

// The operands of the backward: inputs q, k, v, the cotangent g, outputs dq, dk, dv.
struct BwdOperands {
  In q, k, v, g;
  Out dq, dk, dv;
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
bwd_dq_kernel(BwdOperands o, const float* __restrict__ bias, float* __restrict__ stats, int n, int dh, float scale,
              int kt) {
  constexpr int E = Elem<T>::kPerWord;
  constexpr int kLaneWords = 4 / E;    // dh <= 128: at most this many output words per lane
  extern __shared__ __align__(16) uint32_t smem[];

  const BwdLayout l = bwd_layout(kt, dh, sizeof(T), false);
  const int dw = l.dw, kw = l.kw;
  uint32_t* ks = smem;
  uint32_t* vs = smem + l.t1_off;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qw = reinterpret_cast<float*>(smem + l.own_a_off) + warp * kRows * dh;
  float* gw = reinterpret_cast<float*>(smem + l.own_b_off) + warp * kRows * dh;
  float* pw = reinterpret_cast<float*>(smem + l.p_off) + warp * kRows * kt;
  float* dsw = reinterpret_cast<float*>(smem + l.d_off) + warp * kRows * kt;
  const bool whole = kt == n;  // block-uniform: K and V staged once and the score rows kept

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = tile * kTile + warp * kRows;
  const bool active = q0 < n;  // warp-uniform: a warp past N only helps stage

  stage_own<T>(o.q.at(b, h), o.q.row, o.g.at(b, h), o.g.row, q0, n, dw, dh, qw, gw);
  const float* bias_b = bias ? bias + (size_t)b * n : nullptr;
  float m[kRows], sum[kRows], d[kRows];  // per row: lane partials, then the warp's
#pragma unroll
  for (int r = 0; r < kRows; ++r) m[r] = -INFINITY, sum[r] = d[r] = 0.f;
  float acc[kRows][kLaneWords * E];  // dQ = dS K: lane owns output words lane, lane + 32, ... of the row
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int t = 0; t < kLaneWords * E; ++t) acc[r][t] = 0.f;
  }

  // sweep 0: row max; 1: row sum; 2: A and D = rowsum(dA o A); 3: dS = (A o (dA - D)) * scale and
  // dQ. A head staged whole scores once and keeps e, then A, then dS in place of its scores.
  for (int sweep = 0; sweep < 4; ++sweep) {
    for (int t0 = 0; t0 < n; t0 += kt) {
      const int cnt = min(kt, n - t0);
      if (!whole || (sweep == 0 && t0 == 0)) {
        if (!whole) __syncthreads();  // every warp has left the previous tile
        stage_tables(o.k.at(b, h), o.k.row, o.v.at(b, h), o.v.row, t0, cnt, dw, kw, ks, vs);
        __syncthreads();
        // scores and dA = g V^T: lane j owns keys j, j + 32, ...
        for (int j = lane; active && j < cnt; j += 32) {
          float sc[kRows], da[kRows];
          dots<T>(ks + j * kw, vs + j * kw, qw, gw, dw, dh, sc, da);
          const float bj = bias_b ? bias_b[t0 + j] : 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            pw[r * kt + j] = fmaf(sc[r], scale, bj);
            dsw[r * kt + j] = da[r];
          }
        }
        __syncwarp();
      }
      if (!active) continue;
      for (int r = 0; r < kRows; ++r) {
        float* pr = pw + r * kt;
        float* dr = dsw + r * kt;
        for (int j = lane; j < cnt; j += 32) {
          if (sweep == 0) {
            m[r] = fmaxf(m[r], pr[j]);
          } else if (sweep == 1) {
            const float e = expf(pr[j] - m[r]);
            if (whole) pr[j] = e;
            sum[r] += e;
          } else if (sweep == 2) {
            const float a = (whole ? pr[j] : expf(pr[j] - m[r])) / sum[r];
            if (whole) pr[j] = a;
            d[r] = fmaf(dr[j], a, d[r]);
          } else {
            const float a = whole ? pr[j] : expf(pr[j] - m[r]) / sum[r];
            dr[j] = (a * (dr[j] - d[r])) * scale;
          }
        }
      }
      if (sweep < 3) continue;
      __syncwarp();
      for (int j = 0; j < cnt; ++j) {
        const uint32_t* kr = ks + j * kw;
        float kf[kLaneWords][E];
#pragma unroll
        for (int t = 0; t < kLaneWords; ++t) {
          const int c = lane + 32 * t;
          if (c < dw) {
            Elem<T>::unpack(kr[c], kf[t]);
          } else {
            for (int e = 0; e < E; ++e) kf[t][e] = 0.f;
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = dsw[r * kt + j];
#pragma unroll
          for (int t = 0; t < kLaneWords; ++t) {
#pragma unroll
            for (int e = 0; e < E; ++e) acc[r][t * E + e] = fmaf(p, kf[t][e], acc[r][t * E + e]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (sweep == 0) m[r] = warp_max(m[r]);
      if (sweep == 1) sum[r] = warp_sum(sum[r]);
      if (sweep == 2) d[r] = warp_sum(d[r]);
    }
  }
  if (!active) return;

  float* st = stats + ((size_t)(b * gridDim.y + h) * n) * 3;
  if (lane == 0) {
    for (int r = 0; r < kRows && q0 + r < n; ++r) {
      st[(q0 + r) * 3 + 0] = m[r];
      st[(q0 + r) * 3 + 1] = sum[r];
      st[(q0 + r) * 3 + 2] = d[r];
    }
  }
  uint32_t* ob = o.dq.at(b, h);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (q0 + r >= n) break;
#pragma unroll
    for (int t = 0; t < kLaneWords; ++t) {
      const int c = lane + 32 * t;
      if (c < dw) ob[(size_t)(q0 + r) * o.dq.row + c] = Elem<T>::pack(&acc[r][t * E]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
bwd_dkv_kernel(BwdOperands o, const float* __restrict__ bias, const float* __restrict__ stats, int n, int dh,
               float scale, int kt) {
  constexpr int E = Elem<T>::kPerWord;
  constexpr int kLaneWords = 4 / E;
  extern __shared__ __align__(16) uint32_t smem[];

  const BwdLayout l = bwd_layout(kt, dh, sizeof(T), true);
  const int dw = l.dw, kw = l.kw;
  uint32_t* qs = smem;
  uint32_t* gs = smem + l.t1_off;
  float* st = reinterpret_cast<float*>(smem + l.st_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* kwf = reinterpret_cast<float*>(smem + l.own_a_off) + warp * kRows * dh;
  float* vwf = reinterpret_cast<float*>(smem + l.own_b_off) + warp * kRows * dh;
  float* pa = reinterpret_cast<float*>(smem + l.p_off) + warp * kRows * kt;   // A, row r = key k0 + r
  float* pd = reinterpret_cast<float*>(smem + l.d_off) + warp * kRows * kt;   // dS, same layout
  const bool whole = kt == n;  // block-uniform: Q, g and the statistics staged once

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = tile * kTile + warp * kRows;
  const bool active = k0 < n;  // warp-uniform: a warp past N only helps stage

  stage_own<T>(o.k.at(b, h), o.k.row, o.v.at(b, h), o.v.row, k0, n, dw, dh, kwf, vwf);
  float bk[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) bk[r] = (bias && k0 + r < n) ? bias[(size_t)b * n + k0 + r] : 0.f;
  const float* st_src = stats + ((size_t)(b * gridDim.y + h) * n) * 3;

  // dV = A^T g and dK = dS^T Q: lane owns output words lane, lane + 32, ... of the head row
  float acc_v[kRows][kLaneWords * E], acc_k[kRows][kLaneWords * E];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int t = 0; t < kLaneWords * E; ++t) acc_v[r][t] = acc_k[r][t] = 0.f;
  }
  for (int t0 = 0; t0 < n; t0 += kt) {
    const int cnt = min(kt, n - t0);
    if (!whole) __syncthreads();  // every warp has left the previous tile
    stage_tables(o.q.at(b, h), o.q.row, o.g.at(b, h), o.g.row, t0, cnt, dw, kw, qs, gs);
    for (int i = threadIdx.x; i < 3 * cnt; i += blockDim.x) st[i] = st_src[3 * t0 + i];
    __syncthreads();
    if (!active) continue;

    // A and dS of the warp's keys against the tile's queries: lane i owns queries i, i + 32, ...
    for (int i = lane; i < cnt; i += 32) {
      float s[kRows], da[kRows];
      dots<T>(qs + i * kw, gs + i * kw, kwf, vwf, dw, dh, s, da);
      const float m = st[3 * i], sum = st[3 * i + 1], d = st[3 * i + 2];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float a = expf(fmaf(s[r], scale, bk[r]) - m) / sum;
        pa[r * kt + i] = a;
        pd[r * kt + i] = (a * (da[r] - d)) * scale;
      }
    }
    __syncwarp();
    for (int i = 0; i < cnt; ++i) {
      const uint32_t* qr = qs + i * kw;
      const uint32_t* gr = gs + i * kw;
      float qf[kLaneWords][E], gf[kLaneWords][E];
#pragma unroll
      for (int t = 0; t < kLaneWords; ++t) {
        const int c = lane + 32 * t;
        if (c < dw) {
          Elem<T>::unpack(qr[c], qf[t]);
          Elem<T>::unpack(gr[c], gf[t]);
        } else {
          for (int e = 0; e < E; ++e) qf[t][e] = gf[t][e] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float a = pa[r * kt + i], ds = pd[r * kt + i];
#pragma unroll
        for (int t = 0; t < kLaneWords; ++t) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            acc_v[r][t * E + e] = fmaf(a, gf[t][e], acc_v[r][t * E + e]);
            acc_k[r][t * E + e] = fmaf(ds, qf[t][e], acc_k[r][t * E + e]);
          }
        }
      }
    }
  }
  if (!active) return;

  uint32_t* dkb = o.dk.at(b, h);
  uint32_t* dvb = o.dv.at(b, h);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (k0 + r >= n) break;
#pragma unroll
    for (int t = 0; t < kLaneWords; ++t) {
      const int c = lane + 32 * t;
      if (c < dw) {
        dkb[(size_t)(k0 + r) * o.dk.row + c] = Elem<T>::pack(&acc_k[r][t * E]);
        dvb[(size_t)(k0 + r) * o.dv.row + c] = Elem<T>::pack(&acc_v[r][t * E]);
      }
    }
  }
}

template <typename T>
int launch_bwd_t(const BwdOperands& o, const float* bias, float* stats, int batch, int heads, int n, int dh, float scale,
                 cudaStream_t stream) {
  const int kt = bwd_tile(n, dh, sizeof(T));
  const size_t smem1 = (size_t)bwd_layout(kt, dh, sizeof(T), false).words * 4;
  const size_t smem2 = (size_t)bwd_layout(kt, dh, sizeof(T), true).words * 4;
  int err = allow_smem(bwd_dq_kernel<T>, smem1);
  if (err) return err;
  err = allow_smem(bwd_dkv_kernel<T>, smem2);
  if (err) return err;
  const dim3 grid((n + kTile - 1) / kTile, heads, batch);
  bwd_dq_kernel<T><<<grid, kWarps * 32, smem1, stream>>>(o, bias, stats, n, dh, scale, kt);
  err = (int)cudaGetLastError();
  if (err) return err;
  bwd_dkv_kernel<T><<<grid, kWarps * 32, smem2, stream>>>(o, bias, stats, n, dh, scale, kt);
  return (int)cudaGetLastError();
}

// Both CUDA-core passes (the f32 backward) on `stream`; returns cudaGetLastError() (0 on
// success). `bias` may be null; `stats` is f32 scratch of batch * heads * n * 3 values.
inline int launch_bwd_cuda_core(const BwdOperands& o, const void* bias, void* stats, int batch, int heads, int n, int dh,
                                float scale, void* stream) {
  return launch_bwd_t<float>(o, static_cast<const float*>(bias), static_cast<float*>(stats), batch, heads, n, dh, scale,
                             static_cast<cudaStream_t>(stream));
}

// A tensor's 32-bit words.
inline const uint32_t* words(const void* p) { return static_cast<const uint32_t*>(p); }
inline uint32_t* words(void* p) { return static_cast<uint32_t*>(p); }

}  // namespace
}  // namespace m3l
