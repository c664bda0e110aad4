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
// Every sum is in f32 (the forward rounds A to the input type before A.V; the backward, like the
// TPU kernel, uses the unrounded A). The bias gets no gradient.
//
// Two bodies, chosen by dtype before launch (bwd_body, flash_attention_bwd_mma.cuh),
// both shared with the split-head backward (flash_attention_bwd.cu); this file gives them the
// packed addressing: q, k, v and dq, dk, dv at their column offsets of the packed rows.
//   bf16: `bwd_mma_kernel`, one block per (head, batch row) on the tensor cores (mma.sync
//     m16n8k16), the whole head staged once in shared memory where it fits (N <= 384 at
//     Dh = 64), else streamed in tiles of 128 rows with (m, 1 / l, D) in an f32 (B, H, N16, 4)
//     scratch; A and dS enter their products as two bf16 terms (hi + lo).
//   f32: `bwd_tf32_kernel` (flash_attention_bwd_tf32.cuh), one block of up to 8 warps per
//     (head, batch row) in 3xTF32 (mma.sync m16n8k8, each f32 operand split into two TF32 terms,
//     three products each), the B side of each phase staged as f32 (K and V, then Q and g): the
//     whole head where it fits (N <= 400 at Dh = 64), else tiles of 128 rows with the same scratch.
// Neither has a length limit.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, 495 TFLOP/s TF32 dense). At the training
// shape B = 512, N = 192, H = 4, Dh = 64 in bf16 the function must read qkv (151.0 MB) and g (50.3 MB)
// and write dqkv (151.0 MB): 352 MB, 0.105 ms. Its products are 10*B*H*N*N*Dh = 48.3 GFLOP, 0.049 ms
// at the bf16 tensor-core rate, so the bytes bound it. At N = 10 (the MAE encoder on the kept
// tokens) it moves 18.4 MB, 5.5 us. The bf16 body recomputes S and dA three times and splits
// three products in two: 24*B*H*N*N*Dh = 116 GFLOP, 0.117 ms at the dense peak, so at the rate
// mma.sync reaches it is bound by its operations, not by the bytes. In f32 at the SSL shape
// B = 64, N = 196, H = 6, Dh = 64 the function moves 135 MB (40 us) and needs 9.44 GFLOP, 28.3 GFLOP
// of TF32 products in 3xTF32 (57 us at the dense TF32 rate): the operations bound it. The f32 body
// recomputes S and dA as the bf16 one does, 9*B*H*N*N*Dh multiply-adds, so it issues 1.8x the
// function's products, each as three TF32 mma's: 57 GFLOP of TF32 at that shape (N padded to 208).

#include "flash_attention_bwd_mma.cuh"

extern "C" {

// The body a launch of this element size takes: 1 the bf16 body, 0 the f32 (3xTF32) body.
int m3l_flash_qkv_bwd_body(int elem_bytes) { return m3l::bwd_body(elem_bytes); }

// The f32 scratch a launch at this shape needs, in floats (0: none).
size_t m3l_flash_qkv_bwd_scratch_floats(int b, int n, int heads, int dh, int elem_bytes) {
  return m3l::bwd_scratch_floats(b, heads, n, dh, elem_bytes);
}

// Launches the backward on `stream`; returns cudaGetLastError() (0 on success). `bias` may be
// null. `stats` is 16-byte aligned f32 scratch of m3l_flash_qkv_bwd_scratch_floats values (null
// when that is 0). The caller checks shapes: dh a multiple of 8 and at most 128, contiguous
// 16-byte aligned qkv, g and dqkv.
int m3l_flash_qkv_bwd(const void* qkv, const void* bias, const void* g, void* dqkv, void* stats, int b, int n,
                      int heads, int dh, float scale, int elem_bytes, void* stream) {
  if (!m3l::valid_shape(b, n, heads, dh, elem_bytes)) return (int)cudaErrorInvalidValue;
  const int dw = dh * elem_bytes / 4, hw = heads * dw;
  const size_t batch = (size_t)n * 3 * hw;
  const uint32_t* in = m3l::words(qkv);
  uint32_t* out = m3l::words(dqkv);
  const m3l::BwdOperands o{
      {in, batch, dw, 3 * hw}, {in + hw, batch, dw, 3 * hw}, {in + 2 * hw, batch, dw, 3 * hw},
      {m3l::words(g), (size_t)n * hw, dw, hw},
      {out, batch, dw, 3 * hw}, {out + hw, batch, dw, 3 * hw}, {out + 2 * hw, batch, dw, 3 * hw},
  };
  return m3l::launch_bwd(o, bias, stats, b, heads, n, dh, scale, elem_bytes, stream);
}

}  // extern "C"
