// The f32 attention forward on the tensor cores (sm_90a), shared by both interfaces.
//
// Same function as the bf16 body (flash_attention_fwd_mma.cuh), in f32:
//
//   S = (Q K^T) * scale + bias[b];  A = exp(S - rowmax) / rowsum;  O = A V     all f32
//
// Precision ("3xTF32", flash_attention_mma.cuh). Q K^T and e V run as mma.sync.m16n8k8 TF32
// products with every f32 operand split into hi + lo TF32 terms and three products (lo hi, hi lo,
// hi hi) into one f32 accumulator: each product is held to about 2^-21 of its size where an f32
// FMA holds it to 2^-24, far inside flash_attention_qkv_tolerance's 1e-5 (the arithmetic is
// emulated on the CPU in tests/test_torch_attention_f32_mma.py). One pass over the keys, 16 at a
// time, keeps an online row max m and sum l in f32 and adds e V for the unnormalised
// e = exp(s - m), rescaling O and l when m grows; O is multiplied by 1 / l once at the end. The
// plain version divides first; the two differ by an f32 rounding of each probability. Each
// chunk's e V is summed by the tensor cores in an accumulator of its own and added to O in f32.
// Summed over the whole sweep in one accumulator, the tensor cores' rounding of their running sums
// dominated the error: err/tol 0.81 at (64, 196, 16, 64) with a key mask on the H100, against
// 0.12 emulated; per chunk, at most 0.33 at the shapes compare_kernels checks.
//
// Layout: grid (ceil(strips / W), heads, batch), W <= 4 warps a block, each warp one strip of 16
// queries whose Q fragments it reads straight from global memory and splits once into registers
// (up to Dh = 64; a wider head reads them again from L1 at each use, as its split strip would
// not fit the registers). Each block streams K and V of its (b, h) through shared memory as f32
// (cp.async, 16 bytes a load; rows of Dh + 4 floats, the layout of flash_attention_mma.cuh) with
// the key bias: the whole head as one tile where it fits the shared memory a block can opt in to
// (N <= 416 at Dh = 64, N <= 208 at Dh = 128), else tiles of kTf32FwdKeyTile keys in two buffers,
// the next tile's copies in flight while the warps sweep the current one. K is read as the B
// operand of Q K^T straight from its rows; V as the B operand of e V, whose A operand is the score
// accumulator itself with its keys visited in the order 0, 2, 4, 6, 1, 3, 5, 7 of each group of
// 8 (split_c_as_a), so V is read at rows 2t and 2t + 1 of column g. Both reads are free of bank
// conflicts. The sweep visits the keys 16 at a time in the same order whatever the tiling, and the
// online max and sum carry over from tile to tile, so a head gives the same bits in one tile or
// many. Padded keys get the bias -inf, so they join neither the max nor the sum, and a fully
// masked row stays uniform over its real keys (bias -1e30, as in the plain version). Padded query
// rows compute on zeros and are never written. The first key chunk holds key 0, which is real, so
// the running max is finite after it and every later correction exp(m_old - m_new) is a number.
//
// Shared memory is K and V only, 548 bytes a key at Dh = 64: two blocks an SM at N = 196.
#pragma once

#include "flash_attention_mma.cuh"

namespace m3l {
namespace {

constexpr int kTf32FwdWarps = 4;     // warps (16-query strips) per block, fewer when N < 64
constexpr int kTf32FwdKeyTile = 64;  // keys per staged tile of a head too long to stage whole

// Shared memory of one staged key: its K and V rows (f32, Dh rounded up to 16, plus 4) and its
// key bias.
inline size_t fwd_tf32_key_bytes(int dh) { return 8 * ((dh + 15) / 16 * 16 + 4) + 4; }

// Keys per staged tile: the whole head (N rounded up to 16) where it fits, else kTf32FwdKeyTile.
inline int fwd_tf32_tile(int n, int dh) {
  const int np = (n + 15) / 16 * 16;
  return np * fwd_tf32_key_bytes(dh) <= kSmemOptin ? np : kTf32FwdKeyTile;
}

inline size_t fwd_tf32_smem_bytes(int n, int dh) {
  const int kt = fwd_tf32_tile(n, dh);
  return (kt == (n + 15) / 16 * 16 ? 1 : 2) * kt * fwd_tf32_key_bytes(dh);
}

template <int KD>  // head dim padded to 16 * KD
__global__ void __launch_bounds__(kTf32FwdWarps * 32, 2)
fwd_tf32_kernel(In q, In k, In v, const float* __restrict__ bias, Out out, int n, int dh, float scale, int kt) {
  constexpr int LD = 16 * KD + 4, KS = 2 * KD;
  extern __shared__ __align__(16) uint32_t smem[];
  const int np = (n + 15) / 16 * 16, tiles = (np + kt - 1) / kt;
  // buffer s: K (kt rows), V (kt rows), the key bias (kt f32)
  const size_t buf_floats = (size_t)kt * (2 * LD + 1);
  auto ks_of = [&](int s) { return reinterpret_cast<float*>(smem) + s * buf_floats; };

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int i0 = (blockIdx.x * (blockDim.x / 32) + warp) * 16;  // this warp's strip
  const bool active = i0 < np;  // warp-uniform: a warp past the last strip only helps stage
  const float* bias_b = bias ? bias + (size_t)b * n : nullptr;

  // tile t of K, V and the key bias into buffer t % 2, as one cp.async group
  auto stage = [&](int t) {
    float* ks = ks_of(t % 2);
    const int t0 = t * kt, rows = min(kt, np - t0);
    stage_rows_f32<KD>(ks, k, ks + kt * LD, v, b, h, t0, rows, n, dh);
    stage_bias(ks + 2 * kt * LD, bias_b, t0, rows, n);
    cp_async_commit();
  };
  stage(0);  // the copies run while Q is read

  AStrip<KD, (KD <= 4 ? kHeldSplit : kReload)> qa;
  qa.load(q, b, h, i0, n, dh);

  float o[KS][4];
#pragma unroll
  for (int c = 0; c < KS; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      stage(t + 1);  // into the other buffer, which every warp left at the end of tile t - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = ks_of(t % 2);
    const float* vs = ks + kt * LD;
    const float* bs = vs + kt * LD;
    const int rows = min(kt, np - t * kt);
    for (int j0 = 0; active && j0 < rows; j0 += 16) {
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ah[4], al[4];
        qa.get(kk, ah, al);
        const float* kr = ks + (j0 + g) * LD + 8 * kk + t4;  // keys g and 8 + g
        mma3_pair(s[0], ah, al, kr[0], kr[4], s[1], ah, al, kr[8 * LD], kr[8 * LD + 4]);
      }
      float mc[2] = {m[0], m[1]}, corr[2];
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
        corr[r] = expf(m[r] - mc[r]);  // 0 on the first chunk, whose key 0 is real
        l[r] *= corr[r];
        m[r] = mc[r];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = expf(s[nt][e] - m[e / 2]);
          l[e / 2] += s[nt][e];
        }
      }
      // e V of this chunk in its own accumulator, added to the rescaled O in f32: the tensor
      // cores' sums then run over 16 keys, not over the whole sweep
      float pv[KS][4];
#pragma unroll
      for (int c = 0; c < KS; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[c][e] = 0.f;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t ph[4], pl[4];
        split_c_as_a(s[nt], ph, pl);
        const float* vr = vs + (j0 + 8 * nt + 2 * t4) * LD + g;  // keys 2t and 2t + 1, column g
#pragma unroll
        for (int c = 0; c < KS; c += 2)
          mma3_pair(pv[c], ph, pl, vr[8 * c], vr[LD + 8 * c], pv[c + 1], ph, pl, vr[8 * c + 8], vr[LD + 8 * c + 8]);
      }
#pragma unroll
      for (int c = 0; c < KS; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[c][e] = fmaf(o[c][e], corr[e / 2], pv[c][e]);
      }
    }
    if (t + 2 < tiles) __syncthreads();  // tile t + 2 is staged into this buffer next
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = 1.f / quad_sum(l[r]);
#pragma unroll
  for (int c = 0; c < KS; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] *= l[e / 2];
  }
  store_strip_f32<KD>(out, b, h, o, i0, n, dh, lane);
}

template <int KD>
int launch_fwd_tf32_t(In q, In k, In v, const float* bias, Out out, int batch, int heads, int n, int dh, float scale,
                      cudaStream_t stream) {
  const size_t smem = fwd_tf32_smem_bytes(n, dh);
  const int err = allow_mma_smem(fwd_tf32_kernel<KD>, smem);
  if (err) return err;
  const int strips = (n + 15) / 16, warps = strips < kTf32FwdWarps ? strips : kTf32FwdWarps;
  const dim3 grid((strips + warps - 1) / warps, heads, batch);
  fwd_tf32_kernel<KD><<<grid, warps * 32, smem, stream>>>(q, k, v, bias, out, n, dh, scale, fwd_tf32_tile(n, dh));
  return (int)cudaGetLastError();
}

inline int launch_fwd_tf32(In q, In k, In v, const float* bias, Out out, int batch, int heads, int n, int dh,
                           float scale, cudaStream_t s) {
  switch ((dh + 15) / 16) {
    case 1: return launch_fwd_tf32_t<1>(q, k, v, bias, out, batch, heads, n, dh, scale, s);
    case 2: return launch_fwd_tf32_t<2>(q, k, v, bias, out, batch, heads, n, dh, scale, s);
    case 3: return launch_fwd_tf32_t<3>(q, k, v, bias, out, batch, heads, n, dh, scale, s);
    case 4: return launch_fwd_tf32_t<4>(q, k, v, bias, out, batch, heads, n, dh, scale, s);
    case 5: return launch_fwd_tf32_t<5>(q, k, v, bias, out, batch, heads, n, dh, scale, s);
    case 6: return launch_fwd_tf32_t<6>(q, k, v, bias, out, batch, heads, n, dh, scale, s);
    case 7: return launch_fwd_tf32_t<7>(q, k, v, bias, out, batch, heads, n, dh, scale, s);
    case 8: return launch_fwd_tf32_t<8>(q, k, v, bias, out, batch, heads, n, dh, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace m3l
