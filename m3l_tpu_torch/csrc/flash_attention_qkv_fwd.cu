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
// The kernel body is `fwd_kernel` in flash_attention_kernels.cuh, shared with the split-head
// forward (flash_attention_fwd.cu); this file gives it the packed addressing: grid
// (ceil(N / 32), H, B), each block staging K and V of one (b, h) straight from the packed rows
// (no head-split transpose through device memory).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense). At the serving shape B = 512,
// N = 192, H = 4, Dh = 64 in bf16 the kernel must read qkv once (512*192*768*2 B = 151 MB) and
// write the output once (512*192*256*2 B = 50 MB): 201 MB, 60 us at 3.35 TB/s. QK^T and AV are
// 4*B*H*N*N*Dh = 19.3 GFLOP, 20 us at the bf16 tensor-core rate. So the bound is the bytes,
// about 60 us. This first version computes on the CUDA cores in f32 (67 TFLOP/s), where the
// same 19.3 GFLOP take at least 0.29 ms, and its shared-memory reads limit it further: it is
// right first. Tensor cores (wgmma), TMA and a ring of tiles are the later work that brings it
// towards the byte bound.

#include "flash_attention_kernels.cuh"

extern "C" {

// Dynamic shared memory one block needs, in bytes.
size_t m3l_flash_qkv_fwd_smem_bytes(int n, int dh, int elem_bytes) {
  return (size_t)m3l::fwd_layout(n, dh, elem_bytes).words * 4;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success). `bias` may be null.
// The caller checks shapes: dh a multiple of 8 and at most 128, 16-byte aligned contiguous rows.
int m3l_flash_qkv_fwd(const void* qkv, const void* bias, void* out, int b, int n, int heads, int dh,
                      float scale, int elem_bytes, void* stream) {
  if (!m3l::valid_shape(b, n, heads, dh, elem_bytes)) return (int)cudaErrorInvalidValue;
  const int dw = dh * elem_bytes / 4, hw = heads * dw;
  const m3l::In q{m3l::words(qkv), (size_t)n * 3 * hw, dw, 3 * hw};
  const m3l::In k{q.base + hw, q.batch, dw, q.row}, v{q.base + 2 * hw, q.batch, dw, q.row};
  const m3l::Out o{m3l::words(out), (size_t)n * hw, dw, hw};
  return m3l::launch_fwd(q, k, v, bias, o, b, heads, n, dh, scale, elem_bytes, stream);
}

}  // extern "C"
