// The bf16 attention forward on the tensor cores (sm_90a), shared by both interfaces.
//
// The body of bf16 inputs; f32 inputs take fwd_tf32_kernel (flash_attention_fwd_tf32.cuh), which
// has this body's layout in 3xTF32. Same function:
//
//   S = (Q K^T) * scale + bias[b];  A = exp(S - rowmax) / rowsum;  O = round_bf16(A) V
//
// Precision. q, k and v are bf16, so S = Q K^T is exact products with f32 sums on the tensor
// cores (mma.sync.m16n8k16, bf16 in, f32 accumulate). One pass over the keys, 16 at a time, keeps
// an online row max m and sum l (f32) and rounds the unnormalised e = exp(s - m) to bf16 for
// O += e V, rescaling O and l when m grows; O is multiplied by 1 / l once at the end and rounded
// once to bf16. The plain version rounds the normalised A = e / l instead. Both roundings lie
// within half a bf16 ulp of the exact probability, so the two differ by at most one ulp of each,
// which flash_attention_qkv_tolerance allows (its eps * sum_j p_j |v_j| term). The arithmetic is
// emulated on the CPU in tests/test_torch_attention_fwd_mma.py.
//
// Layout: grid (ceil(strips / W), heads, batch), W <= 4 warps a block, each warp one strip of
// 16 queries whose Q fragments it reads straight from global memory into registers. Each block
// streams K and V of its (b, h) through shared memory (cp.async, 16 bytes a load; the layout of
// flash_attention_mma.cuh) with the key bias: the whole head as one tile where it fits the
// shared memory a block can opt in to (N <= 784 at Dh = 64, N <= 416 at Dh = 128), else tiles of
// kFwdKeyTile keys in two buffers, the next tile's copies in flight while the warps sweep the
// current one. The sweep visits the keys 16 at a time in the same order whatever the tiling, and
// the online max and sum carry over from tile to tile, so a head gives the same bits in one tile
// or many. Padded keys (in the last, ragged tile only) get the bias -inf, so they join neither
// the max nor the sum, and a fully masked row stays uniform over its real keys (bias -1e30, as
// in the plain version). Padded query rows compute on zeros and are never written. The first key
// chunk holds key 0, which is real, so the running max is finite after it and every later
// correction exp(m_old - m_new) is a number, 1 where nothing changed. The score tile never
// leaves registers: the two m16n8 accumulator tiles of a chunk's scores are re-packed as the
// m16k16 A operand of e V.
//
// Shared memory is K and V only, 292 bytes a key at Dh = 64 (four blocks an SM at N = 192) and
// 548 at Dh = 128. bf16 has one forward body, f32 the other (fwd_body).
#pragma once

#include "flash_attention_fwd_tf32.cuh"  // and flash_attention_mma.cuh

namespace m3l {
namespace {

constexpr int kFwdMmaWarps = 4;   // warps (16-query strips) per block, fewer when N < 64
constexpr int kFwdKeyTile = 128;  // keys per staged tile of a head too long to stage whole

// Shared memory of one staged key: its K and V rows (bf16, Dh rounded up to 16, plus 8) and its
// key bias (f32).
inline size_t fwd_mma_key_bytes(int dh) { return 4 * ((dh + 15) / 16 * 16 + 8) + 4; }

// Keys per staged tile: the whole head (N rounded up to 16) where it fits, else kFwdKeyTile.
inline int fwd_mma_tile(int n, int dh) {
  const int np = (n + 15) / 16 * 16;
  return np * fwd_mma_key_bytes(dh) <= kSmemOptin ? np : kFwdKeyTile;
}

// Shared memory of the tensor-core forward in bytes: one whole-head tile, or two buffers of a tile.
inline size_t fwd_mma_smem_bytes(int n, int dh) {
  const int kt = fwd_mma_tile(n, dh);
  return (kt == (n + 15) / 16 * 16 ? 1 : 2) * kt * fwd_mma_key_bytes(dh);
}

inline int fwd_body(int elem_bytes) { return elem_bytes == 2 ? kTensorCore : kTf32x3; }

template <int KD>  // head dim padded to 16 * KD
__global__ void __launch_bounds__(kFwdMmaWarps * 32, KD <= 4 ? 4 : 2)
fwd_mma_kernel(In q, In k, In v, const float* __restrict__ bias, Out out, int n, int dh, float scale, int kt) {
  constexpr int LD = 16 * KD + 8;
  extern __shared__ __align__(16) uint32_t smem[];
  const int np = (n + 15) / 16 * 16, tiles = (np + kt - 1) / kt;
  // buffer s: K (kt rows), V (kt rows), the key bias (kt f32)
  const size_t buf_bytes = (size_t)kt * (4 * LD + 4);
  auto ks_of = [&](int s) { return reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<char*>(smem) + s * buf_bytes); };

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i0 = (blockIdx.x * (blockDim.x / 32) + warp) * 16;  // this warp's strip
  const bool active = i0 < np;  // warp-uniform: a warp past the last strip only helps stage
  const float* bias_b = bias ? bias + (size_t)b * n : nullptr;

  // tile t of K, V and the key bias into buffer t % 2, as one cp.async group
  auto stage = [&](int t) {
    __nv_bfloat16* ks = ks_of(t % 2);
    const int t0 = t * kt, rows = min(kt, np - t0);
    stage_rows<KD>(ks, k, ks + kt * LD, v, b, h, t0, rows, n, dh);
    stage_bias(reinterpret_cast<float*>(ks + 2 * kt * LD), bias_b, t0, rows, n);
    cp_async_commit();
  };
  stage(0);  // the copies run while Q is read

  uint32_t qa[KD][4];
  load_a_strip<KD>(qa, q, b, h, i0, n, dh, lane);

  // this lane's ldmatrix offsets: K as the B operand (two 8-key halves as the two n-tiles, two
  // column halves as k); V through .trans (keys as k)
  const int boff = (lane % 8 + (lane / 16) * 8) * LD + (lane / 8 % 2) * 8;
  const int toff = (lane % 8 + (lane / 8 % 2) * 8) * LD + (lane / 16) * 8;
  const int col = 2 * (lane % 4);  // accumulator columns col, col + 1 of each n-tile

  float o[2 * KD][4];
#pragma unroll
  for (int t = 0; t < 2 * KD; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows lane / 4 and lane / 4 + 8
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      stage(t + 1);  // into the other buffer, which every warp left at the end of tile t - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = ks_of(t % 2);
    const __nv_bfloat16* vs = ks + kt * LD;
    const float* bs = reinterpret_cast<const float*>(ks + 2 * kt * LD);
    const int rows = min(kt, np - t * kt);
    for (int j0 = 0; active && j0 < rows; j0 += 16) {
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t bk[4];
        ldsm4(bk, ks + j0 * LD + boff + kk * 16);
        mma16816(s[0], qa[kk], bk[0], bk[1]);
        mma16816(s[1], qa[kk], bk[2], bk[3]);
      }
      float mc[2] = {m[0], m[1]};
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[t2][e] = fmaf(s[t2][e], scale, bs[j0 + 8 * t2 + col + e % 2]);
          mc[e / 2] = fmaxf(mc[e / 2], s[t2][e]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mc[r] = quad_max(mc[r]);
        const float corr = expf(m[r] - mc[r]);  // 0 on the first chunk, whose key 0 is real
        l[r] *= corr;
#pragma unroll
        for (int t2 = 0; t2 < 2 * KD; ++t2) {
          o[t2][2 * r] *= corr;
          o[t2][2 * r + 1] *= corr;
        }
        m[r] = mc[r];
      }
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[t2][e] = expf(s[t2][e] - m[e / 2]);
          l[e / 2] += s[t2][e];
        }
      }
      uint32_t pa[1][4];
      split_a(s, pa);  // e rounded once to bf16
      accumulate<KD>(o, pa, vs + j0 * LD, toff);
    }
    if (t + 2 < tiles) __syncthreads();  // tile t + 2 is staged into this buffer next
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = 1.f / quad_sum(l[r]);
#pragma unroll
  for (int t = 0; t < 2 * KD; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] *= l[e / 2];
  }
  store_strip<KD>(out, b, h, o, i0, n, dh, lane);
}

template <int KD>
int launch_fwd_mma_t(In q, In k, In v, const float* bias, Out out, int batch, int heads, int n, int dh, float scale,
                     cudaStream_t stream) {
  const size_t smem = fwd_mma_smem_bytes(n, dh);
  const int err = allow_mma_smem(fwd_mma_kernel<KD>, smem);
  if (err) return err;
  const int strips = (n + 15) / 16, warps = strips < kFwdMmaWarps ? strips : kFwdMmaWarps;
  const dim3 grid((strips + warps - 1) / warps, heads, batch);
  fwd_mma_kernel<KD><<<grid, warps * 32, smem, stream>>>(q, k, v, bias, out, n, dh, scale, fwd_mma_tile(n, dh));
  return (int)cudaGetLastError();
}

// The forward on `stream` by the body fwd_body picks; returns cudaGetLastError() (0 on
// success). `bias` may be null.
inline int launch_fwd(In q, In k, In v, const void* bias, Out out, int batch, int heads, int n, int dh, float scale,
                      int elem_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bi = static_cast<const float*>(bias);
  if (fwd_body(elem_bytes) == kTf32x3) return launch_fwd_tf32(q, k, v, bi, out, batch, heads, n, dh, scale, s);
  switch ((dh + 15) / 16) {
    case 1: return launch_fwd_mma_t<1>(q, k, v, bi, out, batch, heads, n, dh, scale, s);
    case 2: return launch_fwd_mma_t<2>(q, k, v, bi, out, batch, heads, n, dh, scale, s);
    case 3: return launch_fwd_mma_t<3>(q, k, v, bi, out, batch, heads, n, dh, scale, s);
    case 4: return launch_fwd_mma_t<4>(q, k, v, bi, out, batch, heads, n, dh, scale, s);
    case 5: return launch_fwd_mma_t<5>(q, k, v, bi, out, batch, heads, n, dh, scale, s);
    case 6: return launch_fwd_mma_t<6>(q, k, v, bi, out, batch, heads, n, dh, scale, s);
    case 7: return launch_fwd_mma_t<7>(q, k, v, bi, out, batch, heads, n, dh, scale, s);
    case 8: return launch_fwd_mma_t<8>(q, k, v, bi, out, batch, heads, n, dh, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace m3l
