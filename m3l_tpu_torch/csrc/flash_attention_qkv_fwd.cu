// Fused multi-head attention forward on the packed qkv projection, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_qkv_kernel` (m3l_tpu/nn/flash_attention.py:263-277, launched by
// `_qkv_call` and `flash_attention_qkv`). Same function, re-thought for the GPU:
//
//   qkv (B, N, 3*H*Dh), row = [q heads | k heads | v heads], head h at column offset h*Dh
//   S = (Q_h K_h^T) * scale + bias[b]      f32, bias is 0 or -1e30 per key
//   A = exp(S - rowmax) / rowsum           f32
//   O_h = round_to_input_type(A) V_h       products summed in f32
//   out (B, N, H*Dh), head h written at column offset h*Dh, rounded to the input type
//
// Grid (ceil(N / 32), H, B). Each block stages K and V of one (b, h) in shared memory straight
// from the packed rows (16-byte loads, no head-split transpose through device memory), and
// 4 warps of 8 query rows each build their rows' scores in f32 in shared memory.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense). At the serving shape B = 512,
// N = 192, H = 4, Dh = 64 in bf16 the kernel must read qkv once (512*192*768*2 B = 151 MB) and
// write the output once (512*192*256*2 B = 50 MB): 201 MB, 60 us at 3.35 TB/s. QK^T and AV are
// 4*B*H*N*N*Dh = 19.3 GFLOP, 20 us at the bf16 tensor-core rate. So the bound is the bytes,
// about 60 us. This first version computes on the CUDA cores in f32 (67 TFLOP/s), where the
// same 19.3 GFLOP take at least 0.29 ms, and its shared-memory reads limit it further: it is
// right first. Tensor cores (wgmma), TMA and a ring of tiles are the later work that brings it
// towards the byte bound. K rows are padded by one 32-bit word so that the lanes of a warp,
// each on its own key, read distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                  // warps per block
constexpr int kRows = 8;                   // query rows per warp
constexpr int kTile = kWarps * kRows;      // query rows per block
constexpr int kMaxDh = 128;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPerWord = 1;
  __device__ static void unpack(uint32_t w, float* f) { f[0] = __uint_as_float(w); }
  __device__ static uint32_t pack(const float* f) { return __float_as_uint(f[0]); }
  __device__ static float round(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  // a bf16 is the high half of an f32; the element at the lower address sits in the low half
  __device__ static void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static uint32_t pack(const float* f) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[0], f[1]);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Layout {
  int dw;        // 32-bit words in one head row of q, k or v
  int kw;        // padded K row stride in words
  int vs_off;    // word offsets of V, Q and P in shared memory
  int qs_off;
  int ps_off;
  int words;     // total words
};

__host__ __device__ inline Layout layout(int n, int dh, int elem_bytes) {
  Layout l;
  l.dw = dh * elem_bytes / 4;
  l.kw = l.dw + 1;
  l.vs_off = (n * l.kw + 3) / 4 * 4;       // V rows are read and written as 16-byte vectors
  l.qs_off = l.vs_off + n * l.dw;
  l.ps_off = l.qs_off + kTile * dh;
  l.words = l.ps_off + kTile * n;
  return l;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
fwd_qkv_kernel(const T* __restrict__ qkv, const float* __restrict__ bias, T* __restrict__ out,
               int n, int heads, int dh, float scale) {
  constexpr int E = Elem<T>::kPerWord;
  constexpr int kLaneWords = 4 / E;        // dh <= 128: at most this many output words per lane
  extern __shared__ __align__(16) uint32_t smem[];

  const Layout l = layout(n, dh, sizeof(T));
  const int dw = l.dw, kw = l.kw;
  uint32_t* ks = smem;
  uint32_t* vs = smem + l.vs_off;
  float* qs = reinterpret_cast<float*>(smem + l.qs_off);
  float* ps = reinterpret_cast<float*>(smem + l.ps_off);

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hd = heads * dh;
  const int row_words = 3 * hd / E;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(qkv) + (size_t)b * n * row_words;
  const int q_off = h * dh / E, k_off = (hd + h * dh) / E, v_off = (2 * hd + h * dh) / E;

  // stage K (padded rows) and V of (b, h), 16 bytes per load
  const int vecs = dw / 4;
  for (int i = threadIdx.x; i < n * vecs; i += blockDim.x) {
    const int j = i / vecs, c = (i % vecs) * 4;
    const uint32_t* row = src + (size_t)j * row_words;
    const uint4 kv = *reinterpret_cast<const uint4*>(row + k_off + c);
    const uint4 vv = *reinterpret_cast<const uint4*>(row + v_off + c);
    uint32_t* kd = ks + j * kw + c;
    kd[0] = kv.x;
    kd[1] = kv.y;
    kd[2] = kv.z;
    kd[3] = kv.w;
    *reinterpret_cast<uint4*>(vs + j * dw + c) = vv;
  }

  // each warp stages its own query rows in f32; rows past N are zeros and are never written
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = tile * kTile + warp * kRows;
  float* qw = qs + warp * kRows * dh;
  float* pw = ps + warp * kRows * n;
  for (int i = lane; i < kRows * dw; i += 32) {
    const int r = i / dw, c = i % dw;
    float f[E];
    if (q0 + r < n) {
      Elem<T>::unpack(src[(size_t)(q0 + r) * row_words + q_off + c], f);
    } else {
      for (int e = 0; e < E; ++e) f[e] = 0.f;
    }
    for (int e = 0; e < E; ++e) qw[r * dh + c * E + e] = f[e];
  }
  __syncthreads();
  if (q0 >= n) return;  // warp-uniform; no block-wide barrier follows

  // scores: lane j owns keys j, j + 32, ...; the rows of the warp share each K word
  const float* bias_b = bias ? bias + (size_t)b * n : nullptr;
  for (int j = lane; j < n; j += 32) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    const uint32_t* kr = ks + j * kw;
#pragma unroll 4
    for (int c = 0; c < dw; ++c) {
      float kf[E];
      Elem<T>::unpack(kr[c], kf);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r] = fmaf(qw[r * dh + c * E + e], kf[e], acc[r]);
      }
    }
    const float bj = bias_b ? bias_b[j] : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) pw[r * n + j] = acc[r] * scale + bj;
  }
  __syncwarp();

  // row softmax in f32, then the probabilities rounded to the input type (as A.astype(v.dtype))
  for (int r = 0; r < kRows; ++r) {
    float* pr = pw + r * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, pr[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int j = lane; j < n; j += 32) pr[j] = Elem<T>::round(pr[j] / s);
  }
  __syncwarp();

  // O = A V: lane owns output words lane, lane + 32, ... of the head row
  float acc[kRows][kLaneWords * E];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int t = 0; t < kLaneWords * E; ++t) acc[r][t] = 0.f;
  }
  for (int j = 0; j < n; ++j) {
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
      const float p = pw[r * n + j];
#pragma unroll
      for (int t = 0; t < kLaneWords; ++t) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][t * E + e] = fmaf(p, vf[t][e], acc[r][t * E + e]);
      }
    }
  }

  uint32_t* ob = reinterpret_cast<uint32_t*>(out) + ((size_t)b * n * hd + (size_t)h * dh) / E;
  const int out_row_words = hd / E;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (q0 + r >= n) break;
#pragma unroll
    for (int t = 0; t < kLaneWords; ++t) {
      const int c = lane + 32 * t;
      if (c < dw) ob[(size_t)(q0 + r) * out_row_words + c] = Elem<T>::pack(&acc[r][t * E]);
    }
  }
}

template <typename T>
int launch(const void* qkv, const void* bias, void* out, int b, int n, int heads, int dh, float scale,
           cudaStream_t stream) {
  const size_t smem = (size_t)layout(n, dh, sizeof(T)).words * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fwd_qkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + kTile - 1) / kTile, heads, b);
  fwd_qkv_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias), static_cast<T*>(out), n, heads, dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
size_t m3l_flash_qkv_fwd_smem_bytes(int n, int dh, int elem_bytes) {
  return (size_t)layout(n, dh, elem_bytes).words * 4;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success). `bias` may be null.
// The caller checks shapes: dh a multiple of 8 and at most 128, 16-byte aligned contiguous rows.
int m3l_flash_qkv_fwd(const void* qkv, const void* bias, void* out, int b, int n, int heads, int dh,
                      float scale, int elem_bytes, void* stream) {
  if (dh % 8 != 0 || dh > kMaxDh || n < 1 || b < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) return launch<__nv_bfloat16>(qkv, bias, out, b, n, heads, dh, scale, s);
  if (elem_bytes == 4) return launch<float>(qkv, bias, out, b, n, heads, dh, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
