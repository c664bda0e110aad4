// Fused attention backward on split heads, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` (m3l_tpu/nn/flash_attention.py:55-83, launched by
// `_bwd_call` :120-141 from the custom VJP `_flash_bwd`). Same function as the packed backward
// (flash_attention_qkv_bwd.cu), returning separate arrays:
//
//   q, k, v, g (B*H, N, Dh); S = (Q K^T) * scale + bias[bh];  A = softmax(S)   f32, unrounded
//   dV = A^T g;  dA = g V^T;  dS = (A o (dA - rowsum(dA o A))) * scale;  dQ = dS K;  dK = dS^T Q
//   dq, dk, dv (B*H, N, Dh), each rounded once to the input type
//
// The bodies are the packed backward's, chosen by the same rule (bwd_body in
// flash_attention_bwd_mma.cuh), both one block per batch row B*H: bf16 on mma.sync m16n8k16, f32
// on 3xTF32 mma.sync m16n8k8 (flash_attention_bwd_tf32.cuh); a head too long for shared memory
// streams with an f32 scratch for (m, 1 / l, D) that m3l_flash_bwd_scratch_floats sizes. This
// file gives them the split addressing "batch B*H, heads 1, row stride Dh". Every result equals
// the packed backward's on the same numbers, bit for bit.
//
// Bound on an H100 SXM: the same bytes and operations as the packed backward. At B*H = 2048,
// N = 192, Dh = 64 in bf16 it reads q, k, v (151 MB) and g (50 MB) and writes dq, dk, dv
// (151 MB): 0.105 ms by bytes, against 0.049 ms for its 48.3 GFLOP at the tensor-core rate (the
// tensor-core body does 116 GFLOP: 0.117 ms at the dense peak); in f32 three TF32 products for
// each f32 one (bound as in flash_attention_qkv_bwd.cu).

#include "flash_attention_bwd_mma.cuh"

extern "C" {

// The body a launch of this element size takes: 1 the bf16 body, 0 the f32 (3xTF32) body.
int m3l_flash_bwd_body(int elem_bytes) { return m3l::bwd_body(elem_bytes); }

// The f32 scratch a launch at this shape needs, in floats (0: none).
size_t m3l_flash_bwd_scratch_floats(int bh, int n, int dh, int elem_bytes) {
  return m3l::bwd_scratch_floats(bh, 1, n, dh, elem_bytes);
}

// Launches the backward on `stream`; returns cudaGetLastError() (0 on success). `bias` (bh, n)
// may be null. `stats` is 16-byte aligned f32 scratch of m3l_flash_bwd_scratch_floats values
// (null when that is 0). The caller checks shapes: dh a multiple of 8 and at most 128,
// contiguous 16-byte aligned q, k, v, g, dq, dk and dv.
int m3l_flash_bwd(const void* q, const void* k, const void* v, const void* bias, const void* g, void* dq, void* dk,
                  void* dv, void* stats, int bh, int n, int dh, float scale, int elem_bytes, void* stream) {
  if (!m3l::valid_shape(bh, n, 1, dh, elem_bytes)) return (int)cudaErrorInvalidValue;
  const int dw = dh * elem_bytes / 4;
  const size_t batch = (size_t)n * dw;
  const m3l::BwdOperands o{
      {m3l::words(q), batch, 0, dw}, {m3l::words(k), batch, 0, dw}, {m3l::words(v), batch, 0, dw},
      {m3l::words(g), batch, 0, dw},
      {m3l::words(dq), batch, 0, dw}, {m3l::words(dk), batch, 0, dw}, {m3l::words(dv), batch, 0, dw},
  };
  return m3l::launch_bwd(o, bias, stats, bh, 1, n, dh, scale, elem_bytes, stream);
}

}  // extern "C"
