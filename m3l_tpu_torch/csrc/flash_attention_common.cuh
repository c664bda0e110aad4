// What every attention body shares (sm_90a): the operand descriptors, the shape rule and the
// shared-memory opt-in.
//
// The packed pair (flash_attention_qkv_fwd.cu, flash_attention_qkv_bwd.cu) and the split-head
// pair (flash_attention_fwd.cu, flash_attention_bwd.cu) compute one function:
//
//   S = (Q K^T) * scale + bias[b];  A = exp(S - rowmax) / rowsum               f32
//   forward:  O = round_to_input_type(A) V                                     sums in f32
//   backward: dV = A^T g;  dA = g V^T;  dS = (A o (dA - rowsum(dA o A))) * scale;
//             dQ = dS K;  dK = dS^T Q   (A unrounded; every sum in f32)
//
// and differ only in where the head rows of (b, h) lie. A `Rows` descriptor holds that rule for
// one operand: the base pointer of block (b, h) and the row stride, in 32-bit words. Packed qkv
// (B, N, 3*H*Dh) is "batch B, heads H, row stride 3*H*Dh/E", q at word offset 0, k at H*Dh/E,
// v at 2*H*Dh/E; split q, k, v (B*H, N, Dh) are "batch B*H, heads 1, row stride Dh/E" (E the
// elements a 32-bit word holds). The key bias is one f32 row of N per batch index (B rows, or
// B*H rows for the split layout). The arithmetic, and so every result bit, does not depend on
// the descriptor.
//
// Two bodies a direction, chosen by dtype before launch (fwd_body, bwd_body), both on the tensor
// cores: bf16 through mma.sync.m16n8k16 (flash_attention_fwd_mma.cuh, flash_attention_bwd_mma.cuh),
// f32 through mma.sync.m16n8k8 in TF32 with each operand split in two terms, three products
// where f32 has one (flash_attention_fwd_tf32.cuh, flash_attention_bwd_tf32.cuh). The source
// notes of the four .cu files give the bounds on the H100.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace m3l {
namespace {  // each .cu is its own library: internal linkage keeps their kernels apart

constexpr int kMaxDh = 128;
constexpr size_t kSmemOptin = 232448;  // sm_90: the most dynamic shared memory of one block

// One operand's head rows, in 32-bit words: head h of batch row b starts at
// base + b * batch + h * head, and its rows are `row` words apart.
template <typename W>
struct Rows {
  W* base;
  size_t batch;
  int head;
  int row;
  __device__ W* at(int b, int h) const { return base + b * batch + (size_t)h * head; }
};
using In = Rows<const uint32_t>;
using Out = Rows<uint32_t>;

// The operands of the backward: inputs q, k, v, the cotangent g, outputs dq, dk, dv.
struct BwdOperands {
  In q, k, v, g;
  Out dq, dk, dv;
};

inline bool valid_shape(int batch, int n, int heads, int dh, int elem_bytes) {
  return dh % 8 == 0 && dh <= kMaxDh && n >= 1 && batch >= 1 && heads >= 1 && (elem_bytes == 2 || elem_bytes == 4);
}

template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// A tensor's 32-bit words.
inline const uint32_t* words(const void* p) { return static_cast<const uint32_t*>(p); }
inline uint32_t* words(void* p) { return static_cast<uint32_t*>(p); }

}  // namespace
}  // namespace m3l
