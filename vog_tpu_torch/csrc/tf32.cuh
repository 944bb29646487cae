// 3xTF32 matrix products on Hopper's tensor cores (mma.sync m16n8k8),
// shared, through tiles.cuh, by the attention kernels (attention.cu,
// mm_attention.cu) and the head's backward (grounding_head.cu); the head's
// forward takes split_int for its wgmma fragments.
//
// Plain TF32 keeps 10 mantissa bits and misses the port's fp32 parity bound
// (1e-4 x max(1, max|ref|)).  3xTF32 splits each fp32 operand x into a TF32
// part big and a remainder small = x - big (split_int), and takes a.b
// as a_small.b_big + a_big.b_small + a_big.b_big (the small terms first; the
// small.small term lies below fp32 rounding): fp32-level accuracy at three
// mma a step.
//
// Fragment layouts of mma.m16n8k8 with .tf32 operands (PTX ISA), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 8, row-major):  a0 (g, t)    a1 (g+8, t)    a2 (g, t+4)    a3 (g+8, t+4)
//   B (8 x 8, k x n):       b0 (k=t, n=g)               b1 (k=t+4, n=g)
//   C (16 x 8):             c0 (g, 2t)   c1 (g, 2t+1)   c2 (g+8, 2t)   c3 (g+8, 2t+1)
//
// One pass ("default" precision, the production recipe's): JAX reads
// jax_default_matmul_precision="default" as TF32 on an NVIDIA card, one
// product a step with each operand rounded to TF32.  Each .cu builds twice
// (kernels/_build.py): as it is ("highest", kOnePass false, 3xTF32) and
// with -DVOG_ONE_PASS=1 ("default").  The fragment and k-step helpers take
// the pass count as a template parameter (split, mma_p, and tiles.cuh's
// helpers), so the "highest" instances compile to the 3xTF32 code.  A
// one-pass operand is rounded to nearest (cvt.rna, ties away from zero, as
// cuBLAS's TF32 products round) and not split: the tensor core reads only
// an operand's TF32 bits, so raw fp32 bits, or split_int's truncated big
// part, would truncate toward zero, a bias of one sign over a T=4000 sum.
//
// Each .cu that includes this header builds into its own library, so the
// helpers live in an anonymous namespace.

#pragma once

#include <stdint.h>

#ifndef VOG_ONE_PASS
#define VOG_ONE_PASS 0
#endif

namespace {

constexpr bool kOnePass = VOG_ONE_PASS != 0;  // this library's pass count: 1 or 3

// The split in two full-rate operations (no conversion instruction):
// big = x with its low 13 mantissa bits cleared (TF32 toward zero), small =
// x - big exactly, handed to the tensor core as it is (the unit reads only
// its TF32 bits).  |small| < 2^-10 |x|, so each operand keeps an error of at
// most 2^-20 |x|: a few 1e-6 relative on a product.
__device__ inline void split_int(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ inline void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b in 3xTF32 (the small terms first)
__device__ inline void mma3(float (&c)[4], const uint32_t (&ab)[4], const uint32_t (&as)[4],
                            const uint32_t (&bb)[2], const uint32_t (&bs)[2]) {
  mma(c, as, bb);
  mma(c, ab, bs);
  mma(c, ab, bb);
}

// x rounded to the nearest TF32 (ties away from zero), low 13 bits clear
__device__ inline uint32_t round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// an operand's parts: one pass, big = x rounded to TF32 (small unused, 0);
// three passes, split_int
template <bool kOne>
__device__ inline void split(float x, uint32_t& big, uint32_t& small) {
  if constexpr (kOne) {
    big = round_tf32(x);
    small = 0u;
  } else {
    split_int(x, big, small);
  }
}

// c += a . b in one TF32 pass (the big parts) or in 3xTF32
template <bool kOne>
__device__ inline void mma_p(float (&c)[4], const uint32_t (&ab)[4], const uint32_t (&as)[4],
                             const uint32_t (&bb)[2], const uint32_t (&bs)[2]) {
  if constexpr (kOne)
    mma(c, ab, bb);
  else
    mma3(c, ab, as, bb, bs);
}

}  // namespace
