// Fused multi-head attention backward on the packed qkv projection, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_qkv_kernel` (m3l_tpu/nn/flash_attention.py:280-310, launched by
// `_qkv_call` from the custom VJP `_flash_qkv_bwd`). Same function:
//
//   qkv (B, N, 3*H*Dh) = [q heads | k heads | v heads], g (B, N, H*Dh) the output cotangent
//   S = (Q_h K_h^T) * scale + bias[b];  A = exp(S - rowmax) / rowsum      f32, unrounded
//   dV = A^T g;  dA = g V^T;  dS = (A o (dA - rowsum(dA o A))) * scale;  dQ = dS K;  dK = dS^T Q
//   dqkv (B, N, 3*H*Dh) = [dq heads | dk heads | dv heads], each rounded once to the input type
//
// Every product and sum is in f32 (the forward rounds A to the input type before A.V; the
// backward, like the TPU kernel, uses the unrounded A). The bias gets no gradient.
//
// Design. On the TPU the grid runs in order, so one step holds all queries and keys of G batch
// rows. Here blocks run in parallel and dK, dV sum over all queries, so no block can carry them
// across a grid the way the TPU carries VMEM. Two deterministic passes (no atomics), one block
// of 4 warps per (32-row tile, head, batch row) each, both launched on the caller's stream:
//
//   pass 1 (query tiles): stage K and V of (b, h) in shared memory straight from the packed
//     rows; recompute the tile's full score rows in f32, the row max m and sum l, A and
//     dA = g V^T, then D = rowsum(dA o A), dS and dQ = dS K. Writes dQ and (m, l, D) to an f32
//     (B, H, N, 3) scratch the wrapper allocates (4.7 MB at B = 512, N = 192, H = 4).
//   pass 2 (key tiles): stage Q, g and (m, l, D) of (b, h); recompute A_ij = exp(s_ij - m_i) / l_i
//     and dS_ij for the tile's keys against every query, then dV_j = sum_i A_ij g_i and
//     dK_j = sum_i dS_ij q_i. The scores are summed over Dh in the same order in both passes
//     (and scaled with one explicit fma), so pass 2 recomputes pass 1's A bit for bit.
//
// A lane owns one key (pass 1) or one query (pass 2) while scores are built, and one output
// word while the products with K, Q or g are summed; the rows it reads are padded by one 32-bit
// word so the 32 lanes of a warp reading 32 rows hit 32 banks.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense). At the training shape B = 512,
// N = 192, H = 4, Dh = 64 in bf16 the function must read qkv (151.0 MB) and g (50.3 MB) and
// write dqkv (151.0 MB): 352 MB, 0.105 ms. Its products are 10*B*H*N*N*Dh = 48.3 GFLOP, 0.049 ms
// at the bf16 tensor-core rate, so the bytes bound it. At N = 10 (the MAE encoder on the kept
// tokens) it moves 18.4 MB, 5.5 us. This first version recomputes S and dA in both passes
// (14*B*H*N*N*Dh on the CUDA cores in f32, 67.6 GFLOP at N = 192, at least 1 ms at 67 TFLOP/s)
// and reads its operands from shared memory once per product: it is right first. Tensor cores
// (wgmma), TMA and one pass with register-resident accumulators are the later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "flash_attention_common.cuh"

namespace {

using m3l::Elem;
using m3l::warp_max;
using m3l::warp_sum;

constexpr int kWarps = 4;                  // warps per block
constexpr int kRows = 8;                   // query rows (pass 1) or keys (pass 2) per warp
constexpr int kTile = kWarps * kRows;      // rows per block
constexpr int kMaxDh = 128;

// Shared memory of either pass, in 32-bit words: two padded (N, Dh) head tables staged from the
// packed rows (pass 1: K and V; pass 2: Q and g), the warps' own rows in f32 (pass 1: q and g;
// pass 2: k and v), two f32 (kTile, N) tiles (pass 1: scores/A and dA/dS; pass 2: A and dS
// transposed, one row per key), and in pass 2 the (m, l, D) of every query.
struct Layout {
  int dw;        // 32-bit words in one head row
  int kw;        // padded row stride of the staged tables
  int t1_off, own_a_off, own_b_off, p_off, d_off, st_off;
  int words;
};

__host__ __device__ inline Layout layout(int n, int dh, int elem_bytes, bool with_stats) {
  Layout l;
  l.dw = dh * elem_bytes / 4;
  l.kw = l.dw + 1;
  l.t1_off = n * l.kw;
  l.own_a_off = 2 * n * l.kw;
  l.own_b_off = l.own_a_off + kTile * dh;
  l.p_off = l.own_b_off + kTile * dh;
  l.d_off = l.p_off + kTile * n;
  l.st_off = l.d_off + kTile * n;
  l.words = l.st_off + (with_stats ? 3 * n : 0);
  return l;
}

// Stage the head rows at word offsets a_off / b_off of the n packed rows of `src` (stride
// `row_words`) into padded tables ta / tb, 16 bytes per load.
__device__ inline void stage_tables(const uint32_t* src, int row_words, int a_off, const uint32_t* src_b,
                                    int row_words_b, int b_off, int n, int dw, int kw, uint32_t* ta,
                                    uint32_t* tb) {
  const int vecs = dw / 4;
  for (int i = threadIdx.x; i < n * vecs; i += blockDim.x) {
    const int j = i / vecs, c = (i % vecs) * 4;
    const uint4 av = *reinterpret_cast<const uint4*>(src + (size_t)j * row_words + a_off + c);
    const uint4 bv = *reinterpret_cast<const uint4*>(src_b + (size_t)j * row_words_b + b_off + c);
    uint32_t* ad = ta + j * kw + c;
    uint32_t* bd = tb + j * kw + c;
    ad[0] = av.x; ad[1] = av.y; ad[2] = av.z; ad[3] = av.w;
    bd[0] = bv.x; bd[1] = bv.y; bd[2] = bv.z; bd[3] = bv.w;
  }
}

// Stage a warp's kRows rows (from row r0) of two head slices in f32; rows past n are zeros.
template <typename T>
__device__ inline void stage_own(const uint32_t* src, int row_words, int a_off, const uint32_t* src_b,
                                 int row_words_b, int b_off, int r0, int n, int dw, int dh, float* fa,
                                 float* fb) {
  constexpr int E = Elem<T>::kPerWord;
  const int lane = threadIdx.x % 32;
  for (int i = lane; i < kRows * dw; i += 32) {
    const int r = i / dw, c = i % dw;
    float a[E], b[E];
    if (r0 + r < n) {
      Elem<T>::unpack(src[(size_t)(r0 + r) * row_words + a_off + c], a);
      Elem<T>::unpack(src_b[(size_t)(r0 + r) * row_words_b + b_off + c], b);
    } else {
      for (int e = 0; e < E; ++e) a[e] = b[e] = 0.f;
    }
    for (int e = 0; e < E; ++e) {
      fa[r * dh + c * E + e] = a[e];
      fb[r * dh + c * E + e] = b[e];
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

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
bwd_dq_kernel(const T* __restrict__ qkv, const float* __restrict__ bias, const T* __restrict__ gout,
              T* __restrict__ dqkv, float* __restrict__ stats, int n, int heads, int dh, float scale) {
  constexpr int E = Elem<T>::kPerWord;
  constexpr int kLaneWords = 4 / E;        // dh <= 128: at most this many output words per lane
  extern __shared__ __align__(16) uint32_t smem[];

  const Layout l = layout(n, dh, sizeof(T), false);
  const int dw = l.dw, kw = l.kw;
  uint32_t* ks = smem;
  uint32_t* vs = smem + l.t1_off;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qw = reinterpret_cast<float*>(smem + l.own_a_off) + warp * kRows * dh;
  float* gw = reinterpret_cast<float*>(smem + l.own_b_off) + warp * kRows * dh;
  float* pw = reinterpret_cast<float*>(smem + l.p_off) + warp * kRows * n;
  float* dsw = reinterpret_cast<float*>(smem + l.d_off) + warp * kRows * n;

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hd = heads * dh;
  const int row_words = 3 * hd / E, g_row_words = hd / E;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(qkv) + (size_t)b * n * row_words;
  const uint32_t* gsrc = reinterpret_cast<const uint32_t*>(gout) + (size_t)b * n * g_row_words;
  const int q_off = h * dh / E, k_off = (hd + h * dh) / E, v_off = (2 * hd + h * dh) / E, g_off = h * dh / E;
  const int q0 = tile * kTile + warp * kRows;

  stage_tables(src, row_words, k_off, src, row_words, v_off, n, dw, kw, ks, vs);
  stage_own<T>(src, row_words, q_off, gsrc, g_row_words, g_off, q0, n, dw, dh, qw, gw);
  __syncthreads();
  if (q0 >= n) return;  // warp-uniform; no block-wide barrier follows

  // scores and dA = g V^T: lane j owns keys j, j + 32, ...
  const float* bias_b = bias ? bias + (size_t)b * n : nullptr;
  for (int j = lane; j < n; j += 32) {
    float s[kRows], da[kRows];
    dots<T>(ks + j * kw, vs + j * kw, qw, gw, dw, dh, s, da);
    const float bj = bias_b ? bias_b[j] : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      pw[r * n + j] = fmaf(s[r], scale, bj);
      dsw[r * n + j] = da[r];
    }
  }
  __syncwarp();

  // per row: softmax in f32, D = rowsum(dA o A), dS = (A o (dA - D)) * scale
  float* st = stats + ((size_t)(b * heads + h) * n) * 3;
  for (int r = 0; r < kRows; ++r) {
    float* pr = pw + r * n;
    float* dr = dsw + r * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, pr[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float d = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float a = pr[j] / sum;
      pr[j] = a;
      d = fmaf(dr[j], a, d);
    }
    d = warp_sum(d);
    for (int j = lane; j < n; j += 32) dr[j] = (pr[j] * (dr[j] - d)) * scale;
    if (lane == 0 && q0 + r < n) {
      st[(q0 + r) * 3 + 0] = m;
      st[(q0 + r) * 3 + 1] = sum;
      st[(q0 + r) * 3 + 2] = d;
    }
  }
  __syncwarp();

  // dQ = dS K: lane owns output words lane, lane + 32, ... of the head row
  float acc[kRows][kLaneWords * E];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int t = 0; t < kLaneWords * E; ++t) acc[r][t] = 0.f;
  }
  for (int j = 0; j < n; ++j) {
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
      const float p = dsw[r * n + j];
#pragma unroll
      for (int t = 0; t < kLaneWords; ++t) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][t * E + e] = fmaf(p, kf[t][e], acc[r][t * E + e]);
      }
    }
  }

  uint32_t* ob = reinterpret_cast<uint32_t*>(dqkv) + (size_t)b * n * row_words;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (q0 + r >= n) break;
#pragma unroll
    for (int t = 0; t < kLaneWords; ++t) {
      const int c = lane + 32 * t;
      if (c < dw) ob[(size_t)(q0 + r) * row_words + q_off + c] = Elem<T>::pack(&acc[r][t * E]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
bwd_dkv_kernel(const T* __restrict__ qkv, const float* __restrict__ bias, const T* __restrict__ gout,
               T* __restrict__ dqkv, const float* __restrict__ stats, int n, int heads, int dh, float scale) {
  constexpr int E = Elem<T>::kPerWord;
  constexpr int kLaneWords = 4 / E;
  extern __shared__ __align__(16) uint32_t smem[];

  const Layout l = layout(n, dh, sizeof(T), true);
  const int dw = l.dw, kw = l.kw;
  uint32_t* qs = smem;
  uint32_t* gs = smem + l.t1_off;
  float* st = reinterpret_cast<float*>(smem + l.st_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* kwf = reinterpret_cast<float*>(smem + l.own_a_off) + warp * kRows * dh;
  float* vwf = reinterpret_cast<float*>(smem + l.own_b_off) + warp * kRows * dh;
  float* pa = reinterpret_cast<float*>(smem + l.p_off) + warp * kRows * n;   // A, row r = key k0 + r
  float* pd = reinterpret_cast<float*>(smem + l.d_off) + warp * kRows * n;   // dS, same layout

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hd = heads * dh;
  const int row_words = 3 * hd / E, g_row_words = hd / E;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(qkv) + (size_t)b * n * row_words;
  const uint32_t* gsrc = reinterpret_cast<const uint32_t*>(gout) + (size_t)b * n * g_row_words;
  const int q_off = h * dh / E, k_off = (hd + h * dh) / E, v_off = (2 * hd + h * dh) / E, g_off = h * dh / E;
  const int k0 = tile * kTile + warp * kRows;

  stage_tables(src, row_words, q_off, gsrc, g_row_words, g_off, n, dw, kw, qs, gs);
  const float* st_src = stats + ((size_t)(b * heads + h) * n) * 3;
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) st[i] = st_src[i];
  stage_own<T>(src, row_words, k_off, src, row_words, v_off, k0, n, dw, dh, kwf, vwf);
  __syncthreads();
  if (k0 >= n) return;  // warp-uniform; no block-wide barrier follows

  float bk[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) bk[r] = (bias && k0 + r < n) ? bias[(size_t)b * n + k0 + r] : 0.f;

  // A and dS of the warp's keys against every query: lane i owns queries i, i + 32, ...
  for (int i = lane; i < n; i += 32) {
    float s[kRows], da[kRows];
    dots<T>(qs + i * kw, gs + i * kw, kwf, vwf, dw, dh, s, da);
    const float m = st[3 * i], sum = st[3 * i + 1], d = st[3 * i + 2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float a = expf(fmaf(s[r], scale, bk[r]) - m) / sum;
      pa[r * n + i] = a;
      pd[r * n + i] = (a * (da[r] - d)) * scale;
    }
  }
  __syncwarp();

  // dV = A^T g and dK = dS^T Q: lane owns output words lane, lane + 32, ... of the head row
  float acc_v[kRows][kLaneWords * E], acc_k[kRows][kLaneWords * E];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int t = 0; t < kLaneWords * E; ++t) acc_v[r][t] = acc_k[r][t] = 0.f;
  }
  for (int i = 0; i < n; ++i) {
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
      const float a = pa[r * n + i], ds = pd[r * n + i];
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

  uint32_t* ob = reinterpret_cast<uint32_t*>(dqkv) + (size_t)b * n * row_words;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (k0 + r >= n) break;
    uint32_t* orow = ob + (size_t)(k0 + r) * row_words;
#pragma unroll
    for (int t = 0; t < kLaneWords; ++t) {
      const int c = lane + 32 * t;
      if (c < dw) {
        orow[k_off + c] = Elem<T>::pack(&acc_k[r][t * E]);
        orow[v_off + c] = Elem<T>::pack(&acc_v[r][t * E]);
      }
    }
  }
}

template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int launch(const void* qkv, const void* bias, const void* g, void* dqkv, void* stats, int b, int n, int heads,
           int dh, float scale, cudaStream_t stream) {
  const size_t smem1 = (size_t)layout(n, dh, sizeof(T), false).words * 4;
  const size_t smem2 = (size_t)layout(n, dh, sizeof(T), true).words * 4;
  int err = allow_smem(bwd_dq_kernel<T>, smem1);
  if (err) return err;
  err = allow_smem(bwd_dkv_kernel<T>, smem2);
  if (err) return err;
  const dim3 grid((n + kTile - 1) / kTile, heads, b);
  const T* q = static_cast<const T*>(qkv);
  const float* bi = static_cast<const float*>(bias);
  const T* go = static_cast<const T*>(g);
  T* out = static_cast<T*>(dqkv);
  float* st = static_cast<float*>(stats);
  bwd_dq_kernel<T><<<grid, kWarps * 32, smem1, stream>>>(q, bi, go, out, st, n, heads, dh, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  bwd_dkv_kernel<T><<<grid, kWarps * 32, smem2, stream>>>(q, bi, go, out, st, n, heads, dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory the larger of the two passes needs, in bytes.
size_t m3l_flash_qkv_bwd_smem_bytes(int n, int dh, int elem_bytes) {
  return (size_t)layout(n, dh, elem_bytes, true).words * 4;
}

// Launches both passes on `stream`; returns cudaGetLastError() (0 on success). `bias` may be
// null. `stats` is f32 scratch of b * heads * n * 3 values. The caller checks shapes: dh a
// multiple of 8 and at most 128, contiguous 16-byte aligned qkv, g and dqkv.
int m3l_flash_qkv_bwd(const void* qkv, const void* bias, const void* g, void* dqkv, void* stats, int b, int n,
                      int heads, int dh, float scale, int elem_bytes, void* stream) {
  if (dh % 8 != 0 || dh > kMaxDh || n < 1 || b < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) return launch<__nv_bfloat16>(qkv, bias, g, dqkv, stats, b, n, heads, dh, scale, s);
  if (elem_bytes == 4) return launch<float>(qkv, bias, g, dqkv, stats, b, n, heads, dh, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
