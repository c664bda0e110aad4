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
// Two bodies, chosen by dtype before launch (fwd_body, flash_attention_fwd_mma.cuh), both shared
// with the split-head forward (flash_attention_fwd.cu); this file gives them the packed
// addressing: q, k and v read straight from their column offsets of the packed rows (no
// head-split transpose through device memory), the output written at its head's offset.
//   bf16: `fwd_mma_kernel`, grid (ceil(N / 64), H, B) of up to 4 warps, each warp a 16-query
//     strip on the tensor cores (mma.sync m16n8k16), K and V of (b, h) streamed through shared
//     memory (the whole head, or tiles of 128 keys), one pass over the keys with an online
//     softmax; the scores never leave registers.
//   f32: `fwd_tf32_kernel` (flash_attention_fwd_tf32.cuh), the same layout on the tensor cores in
//     3xTF32 (mma.sync m16n8k8, each f32 operand split into two TF32 terms, three products each),
//     K and V staged as f32 (the whole head, or tiles of 64 keys).
// Neither has a length limit.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, 495 TFLOP/s TF32 dense). At the serving
// and training shape B = 512, N = 192, H = 4, Dh = 64 in bf16 the kernel must read qkv once
// (512*192*768*2 B = 151 MB) and write the output once (512*192*256*2 B = 50 MB): 201 MB, 60 us at
// 3.35 TB/s. QK^T and AV are 4*B*H*N*N*Dh = 19.3 GFLOP, 20 us at the bf16 tensor-core rate. So the
// bound is the bytes, about 60 us. In f32 at the SSL shape B = 64, N = 196, H = 6, Dh = 64 it
// moves 77 MB (23 us) and does 3.78 GFLOP, which 3xTF32 runs as 11.3 GFLOP of TF32 products: 23 us
// at the dense TF32 rate, so bytes and operations bound it alike. (The 67 TFLOP/s of f32 FMA is no
// least time for this body.) Both bodies keep the scores in registers and stage K and V once per
// block of 64 queries (from L2 after the first block of a head); what is left is the N^2 exp a
// head, the online rescale of O and, in f32, the split of each B fragment as it is read.

#include "flash_attention_fwd_mma.cuh"

extern "C" {

// The body a launch of this element size takes: 1 the bf16 body, 0 the f32 (3xTF32) body.
int m3l_flash_qkv_fwd_body(int elem_bytes) { return m3l::fwd_body(elem_bytes); }

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
