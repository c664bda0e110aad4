// Fused attention forward on split heads, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` (m3l_tpu/nn/flash_attention.py:40-52, launched by
// `_fwd_call` :99-117 under the v1 interface `flash_attention` :162-186). Same function as the
// packed forward (flash_attention_qkv_fwd.cu), on another layout:
//
//   q, k, v (B*H, N, Dh), one contiguous (N, Dh) block per (batch row, head)
//   S = (Q K^T) * scale + bias[bh]         f32, bias (B*H, N) is 0 or -1e30 per key
//   A = exp(S - rowmax) / rowsum           f32
//   O = round_to_input_type(A) V           products summed in f32
//   out (B*H, N, Dh), rounded to the input type
//
// The packed forward's two bodies and their rule (fwd_body): bf16 through mma.sync m16n8k16
// (`fwd_mma_kernel`, flash_attention_fwd_mma.cuh), f32 through 3xTF32 mma.sync m16n8k8
// (`fwd_tf32_kernel`, flash_attention_fwd_tf32.cuh). This file gives them the split addressing
// "batch B*H, heads 1, row stride Dh": grid (ceil(N / 64), 1, B*H). Every result equals the
// packed kernel's on the same numbers, bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): the same bytes and operations as
// the packed forward. At B*H = 2048, N = 192, Dh = 64 in bf16 it reads q, k, v once (151 MB)
// and writes the output once (50 MB): 60 us by bytes, against 20 us for the 19.3 GFLOP of QK^T
// and AV at the tensor-core rate. The tensor-core body does those products at the bf16 rate
// with the scores in registers, as in the packed forward; in f32 the same layout runs three TF32
// products for each f32 one (bound as in flash_attention_qkv_fwd.cu). The v1 interface's callers also pay
// the head-split copies around it in device memory, which the packed interface avoids.

#include "flash_attention_fwd_mma.cuh"

extern "C" {

// The body a launch of this element size takes: 1 the bf16 body, 0 the f32 (3xTF32) body.
int m3l_flash_fwd_body(int elem_bytes) { return m3l::fwd_body(elem_bytes); }

// Launches on `stream`; returns cudaGetLastError() (0 on success). `bias` (bh, n) may be null.
// The caller checks shapes: dh a multiple of 8 and at most 128, contiguous 16-byte aligned
// q, k, v and out.
int m3l_flash_fwd(const void* q, const void* k, const void* v, const void* bias, void* out, int bh, int n, int dh,
                  float scale, int elem_bytes, void* stream) {
  if (!m3l::valid_shape(bh, n, 1, dh, elem_bytes)) return (int)cudaErrorInvalidValue;
  const int dw = dh * elem_bytes / 4;
  const size_t batch = (size_t)n * dw;
  const m3l::In qr{m3l::words(q), batch, 0, dw}, kr{m3l::words(k), batch, 0, dw}, vr{m3l::words(v), batch, 0, dw};
  const m3l::Out o{m3l::words(out), batch, 0, dw};
  return m3l::launch_fwd(qr, kr, vr, bias, o, bh, 1, n, dh, scale, elem_bytes, stream);
}

}  // extern "C"
