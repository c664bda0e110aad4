// The bf16 attention forward on the tensor cores (sm_90a), shared by both interfaces.
//
// Replaces, for bf16 inputs, the CUDA-core body `fwd_kernel` of flash_attention_kernels.cuh
// (which stays the f32 body, bit for bit). Same function:
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
// stages K and V of its (b, h) in shared memory (cp.async, 16 bytes a load; the layout of
// flash_attention_mma.cuh) with the key bias; padded keys get the bias -inf, so they join neither
// the max nor the sum, and a fully masked row stays uniform over its real keys (bias -1e30, as in
// the plain version). Padded query rows compute on zeros and are never written. The first key
// chunk holds key 0, which is real, so the running max is finite after it and every later
// correction exp(m_old - m_new) is a number, 1 where nothing changed. The score tile never
// leaves registers: the two m16n8 accumulator tiles of a chunk's scores are re-packed as the
// m16k16 A operand of e V.
//
// Shared memory is K and V only, 292 bytes a key at Dh = 64 (four blocks an SM at N = 192) and
// 548 at Dh = 128, always less than the CUDA-core body needs for the same bf16 head (388 and 644
// bytes a key), so every bf16 shape that body took fits here: bf16 has one forward body, f32 the
// other (fwd_body).
#pragma once

#include "flash_attention_mma.cuh"

namespace m3l {
namespace {

constexpr int kFwdMmaWarps = 4;  // warps (16-query strips) per block, fewer when N < 64

// Shared memory of the tensor-core forward in bytes: K and V as bf16 tables of np rows of ld
// values (np = N rounded up to 16, ld = Dh rounded up to 16, plus 8) and the key bias (np f32).
inline size_t fwd_mma_smem_bytes(int n, int dh) {
  const size_t np = (n + 15) / 16 * 16, ld = (dh + 15) / 16 * 16 + 8;
  return 4 * np * ld + 4 * np;
}

inline int fwd_body(int elem_bytes) { return elem_bytes == 2 ? kTensorCore : kCudaCore; }

// Dynamic shared memory of the body fwd_body picks, in bytes.
inline size_t fwd_smem_bytes(int n, int dh, int elem_bytes) {
  if (fwd_body(elem_bytes) == kTensorCore) return fwd_mma_smem_bytes(n, dh);
  return (size_t)fwd_layout(n, dh, elem_bytes).words * 4;
}

template <int KD>  // head dim padded to 16 * KD
__global__ void __launch_bounds__(kFwdMmaWarps * 32, KD <= 4 ? 4 : 2)
fwd_mma_kernel(In q, In k, In v, const float* __restrict__ bias, Out out, int n, int dh, float scale) {
  constexpr int DHP = 16 * KD, LD = DHP + 8, VECS = DHP / 8;
  extern __shared__ __align__(16) uint32_t smem[];
  const int np = (n + 15) / 16 * 16;
  __nv_bfloat16* const ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const vs = ks + np * LD;
  float* const bs = reinterpret_cast<float*>(vs + np * LD);

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i0 = (blockIdx.x * (blockDim.x / 32) + warp) * 16;  // this warp's strip

  // stage K and V of (b, h), zeros past N and past Dh; the copies run while Q is read
  const uint32_t* kb = k.at(b, h);
  const uint32_t* vb = v.at(b, h);
  for (int i = threadIdx.x; i < np * VECS; i += blockDim.x) {
    const int j = i / VECS, c = i % VECS;
    const bool real = j < n && c * 8 < dh;
    cp_async16(ks + j * LD + c * 8, real ? kb + (size_t)j * k.row + c * 4 : kb, real);
    cp_async16(vs + j * LD + c * 8, real ? vb + (size_t)j * v.row + c * 4 : vb, real);
  }
  const float* bias_b = bias ? bias + (size_t)b * n : nullptr;
  for (int j = threadIdx.x; j < np; j += blockDim.x) bs[j] = j < n ? (bias_b ? bias_b[j] : 0.f) : -INFINITY;

  // this warp's Q strip as m16k16 A fragments: a[r] holds row lane / 4 (+ 8 for odd r), columns
  // 2 * (lane % 4) (+ 8 for r >= 2) and the next one, of each 16-column block kk
  uint32_t qa[KD][4];
  const uint32_t* qb = q.at(b, h);
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = i0 + lane / 4 + 8 * (r % 2), w = kk * 8 + lane % 4 + 4 * (r / 2);
      qa[kk][r] = row < n && 2 * w < dh ? qb[(size_t)row * q.row + w] : 0u;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (i0 >= np) return;  // warp-uniform; no barrier follows

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
  for (int j0 = 0; j0 < np; j0 += 16) {
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
#pragma unroll
      for (int t = 0; t < 2 * KD; ++t) {
        o[t][2 * r] *= corr;
        o[t][2 * r + 1] *= corr;
      }
      m[r] = mc[r];
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[t][e] = expf(s[t][e] - m[e / 2]);
        l[e / 2] += s[t][e];
      }
    }
    uint32_t pa[1][4];
    split_a(s, pa);  // e rounded once to bf16
    accumulate<KD>(o, pa, vs + j0 * LD, toff);
  }
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
  fwd_mma_kernel<KD><<<grid, warps * 32, smem, stream>>>(q, k, v, bias, out, n, dh, scale);
  return (int)cudaGetLastError();
}

// The forward on `stream` by the body fwd_body picks; returns cudaGetLastError() (0 on
// success). `bias` may be null.
inline int launch_fwd(In q, In k, In v, const void* bias, Out out, int batch, int heads, int n, int dh, float scale,
                      int elem_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bi = static_cast<const float*>(bias);
  if (fwd_body(elem_bytes) == kCudaCore) return launch_fwd_t<float>(q, k, v, bi, out, batch, heads, n, dh, scale, s);
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
