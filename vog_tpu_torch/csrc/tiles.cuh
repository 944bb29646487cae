// Shared-memory tiles of (T, dh) fp32 matrices and the TF32 products
// over them (3xTF32, or one pass: tf32.cuh), shared by the attention kernels (attention.cu and
// mm_attention.cu, forward and backward); grounding_head.cu takes its
// cp.async helpers.
//
//  * The head dim is a compile-time parameter of every narrow kernel
//    instance (HeadDim<DK>: DK 64 or 128; a call pads dh up to the next
//    instance with zeros), so every loop over it unrolls and the loads run
//    ahead of the products.  Past 128 every attention kernel splits the
//    head dim over a thread block cluster (cluster.cuh): each block stages
//    and accumulates a 128-column slice, the score partials summed once
//    over the cluster; their fragment reads and products are this file's,
//    on 128-column slices (HeadDim<128>) or on 64-column halves of them
//    (``scores``' LD: a half's k-steps in a slice's row stride).
//  * A shared row holds DK floats plus 4: with a row stride of 4 (mod 8)
//    words, both kinds of fragment read below (rows g, columns t; and rows
//    2t, 2t+1, columns g) hit 32 distinct banks.
//  * Rows come in by cp.async (16-byte copies, zero-filled past T and past
//    dh), so a kernel can load tile i+1 while it multiplies tile i.
//  * P (or dS) passes from the C fragment of one product to the A fragment
//    of the next in registers, with no shuffle and no shared tile.  Within
//    a k-step of 8 keys the A fragment's column t is taken as key 2t and
//    its column t+4 as key 2t+1, and the B fragment's rows t and t+4 as
//    rows 2t and 2t+1 of V (or dO, Q, K): the sum over the 8 keys is
//    unchanged, and the C fragment (c0..c3 at (g, 2t), (g, 2t+1), (g+8,
//    2t), (g+8, 2t+1)) is then the A fragment (a0, a2, a1, a3) as it
//    stands.
//  * Masked keys take the finite -1e30 of the TPU kernels, keys past T are
//    excluded (-inf): a key's code is its frame id when valid, else
//    kMasked or kPast.
//  * The fragment and product helpers take the pass count (kOne: one TF32
//    pass, else 3xTF32; tf32.cuh) as a template parameter whose default is
//    the library's kOnePass.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32.cuh"  // split, mma_p (one pass or 3xTF32), kOnePass

namespace {

// An emit mode's stored score gradient (flash ds, mm comb): fp32, or bf16
// in a one-pass library, as the JAX package stores it at "default" on the
// chip (vog_tpu/kernels/attention.py:385-400, mm_attention.py:413-427)
using DsT = std::conditional_t<kOnePass, __nv_bfloat16, float>;
__device__ inline void store_ds(float* p, float x) { *p = x; }
__device__ inline void store_ds(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// A narrow kernel instance's head dims: DK the padded head dim of the
// score products, DV the output columns a block accumulates (all DK: one
// block a tile of rows)
template <int DK>
struct HeadDim {
  static_assert(DK == 64 || DK == 128, "instances: 64, 128 (past 128: the cluster kernels)");
  static constexpr int kND = DK / 8;                // k-steps of a score product
  static constexpr int kLd = DK + 4;                // shared row stride (floats)
  static constexpr int kDV = DK;                    // a block's output columns
  static constexpr int kNV = kDV / 8;               // their 8-wide column tiles
  static constexpr int kSlices = 1;                 // blocks over the columns
};
// Frames whose (F, F) bias table (up to 16 KB) a block holds in shared
// memory.  Past it the kernels read the head's table from device memory
// through the read-only cache: every table fits L2 (F = 160 is 100 KB a
// head), and a block's rows and keys each read a few rows of it (the
// cluster kernels do so at any F).
constexpr int kTableF = 64;
// Frames a block sums the frame-bias gradient over (the dq kernels): a
// launch with more frames gives every tile of rows ceil(F / 64) blocks,
// block z summing frames 64z..64z+63, so the sums keep their order and
// registers at any F.
constexpr int kFrameTile = 64;
constexpr float kNeg = -1e30f;
constexpr int kMasked = -1;
constexpr int kPast = -2;  // key index >= T

__host__ __device__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes; zero-fills the destination when !ok
__device__ inline void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ inline void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ inline void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ inline void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ inline void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Asynchronous copy, by a block of THREADS threads, of rows [row0, row0 +
// ROWS) of a (T, dh) matrix into shared memory (row stride DK + 4),
// zero-filled past T and from dh up to DK.  16-byte copies when
// ``vec`` (dh % 4 == 0, 16-byte aligned pointers), else 4-byte copies.
// The caller commits the group.
template <int ROWS, int THREADS, int DK>
__device__ inline void load_rows(float* dst, const float* __restrict__ src, int row0, int T,
                                 int dh, bool vec) {
  constexpr int kLd = HeadDim<DK>::kLd;
  if (vec) {
    constexpr int n4 = DK / 4;
    for (int idx = threadIdx.x; idx < ROWS * n4; idx += THREADS) {
      const int r = idx / n4, c = 4 * (idx % n4), row = row0 + r;
      const bool ok = row < T && c < dh;
      cp_async16(dst + r * kLd + c, ok ? src + (size_t)row * dh + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * DK; idx += THREADS) {
      const int r = idx / DK, c = idx % DK, row = row0 + r;
      const bool ok = row < T && c < dh;
      cp_async4(dst + r * kLd + c, ok ? src + (size_t)row * dh + c : src, ok);
    }
  }
}

template <bool kFrames>
__device__ inline int key_code(const float* __restrict__ key_mask, const int* __restrict__ fid,
                               int b, int j, int T) {
  return j >= T ? kPast : (key_mask[(size_t)b * T + j] > 0.f ? (kFrames ? fid[j] : 0) : kMasked);
}

// Where a kernel instance reads the frame bias, a template parameter, so
// that an instance of up to kTableF frames compiles as it would without
// the other case (its registers and code unchanged): no frames (the flash
// kernels' scalar bias), the head's (F, F) table staged in shared memory,
// or the table in device memory (F > kTableF).
enum TableMode : int { kNoTable = 0, kSmemTable = 1, kGlobalTable = 2 };

// the mode of a launch with F frames (F == 1: the flash kernels' scalar)
__host__ inline int table_mode(int F) { return F == 1 ? kNoTable : F <= kTableF ? kSmemTable : kGlobalTable; }

// the frame bias of (query frame fq, key frame fk): the shared copy fbs
// or the head's table fbg in device memory
template <int TM>
__device__ inline float table_bias(const float* fbs, const float* __restrict__ fbg, int F, int fq,
                                   int fk) {
  return TM == kSmemTable ? fbs[fq * F + fk] : __ldg(fbg + fq * F + fk);
}

// stage the head's (F, F) table into shared memory when it is held there
template <int TM, int THREADS>
__device__ inline void stage_table(float* fbs, const float* __restrict__ fbg, int F) {
  if (TM == kSmemTable)
    for (int i = threadIdx.x; i < F * F; i += THREADS) fbs[i] = fbg[i];
}

// the shared floats of a launch's (F, F) table: 0 when read from device memory
__host__ __device__ inline size_t table_floats(int F) { return F <= kTableF ? (size_t)F * F : 0; }

// split A fragment of the 16x8 tile at (0, k0) of a row-major shared X
// (row stride LD)
template <int LD, bool kOne = kOnePass>
__device__ inline void frag_a(const float* X, int k0, int g, int t, uint32_t (&ab)[4],
                              uint32_t (&as)[4]) {
  const float* p = X + g * LD + k0 + t;
  split<kOne>(p[0], ab[0], as[0]);
  split<kOne>(p[8 * LD], ab[1], as[1]);
  split<kOne>(p[4], ab[2], as[2]);
  split<kOne>(p[8 * LD + 4], ab[3], as[3]);
}

// split B fragment of the 8x8 tile at (k0, n0) of X^T, X a row-major shared
// matrix whose rows are the n index: b0 = X[n0+g][k0+t], b1 = X[n0+g][k0+t+4]
template <int LD, bool kOne = kOnePass>
__device__ inline void frag_bt(const float* X, int n0, int k0, int g, int t, uint32_t (&bb)[2],
                               uint32_t (&bs)[2]) {
  const float* p = X + (n0 + g) * LD + k0 + t;
  split<kOne>(p[0], bb[0], bs[0]);
  split<kOne>(p[4], bb[1], bs[1]);
}

// split B fragment of the 8x8 tile at (k0, n0) of a row-major shared X
// whose rows are the k index, rows in pair order (see a_from_c):
// b0 = X[k0+2t][n0+g], b1 = X[k0+2t+1][n0+g]
template <int LD, bool kOne = kOnePass>
__device__ inline void frag_b_pairs(const float* X, int k0, int n0, int g, int t,
                                    uint32_t (&bb)[2], uint32_t (&bs)[2]) {
  const float* p = X + (k0 + 2 * t) * LD + n0 + g;
  split<kOne>(p[0], bb[0], bs[0]);
  split<kOne>(p[LD], bb[1], bs[1]);
}

// the split A fragment of a C fragment whose 8 columns become the k index
// in pair order (column 2t -> k = t, column 2t+1 -> k = t+4)
template <bool kOne = kOnePass>
__device__ inline void a_from_c(const float (&c)[4], uint32_t (&ab)[4], uint32_t (&as)[4]) {
  split<kOne>(c[0], ab[0], as[0]);
  split<kOne>(c[2], ab[1], as[1]);
  split<kOne>(c[1], ab[2], as[2]);
  split<kOne>(c[3], ab[3], as[3]);
}

template <int NT>
__device__ inline void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
}

// c = X1 Y1^T and d = X2 Y2^T over the padded head dim DK, for the warp's
// 16 rows of X1, X2 (row-major shared, stride LD: DK + 4, or a cluster
// slice's kSliceLd for a 64-column half of it) and NT*8 rows of Y1, Y2.
// Each product is summed in two accumulator sets (even and odd k-steps),
// which halves its dependent mma chains; TWO = false computes c alone (d
// may then alias c).
// CH > 0: the loop over the k-steps runs in rolled iterations of CH
// unrolled k-steps (else unrolled whole), which bounds how far ahead of
// the products the fragment loads run, and so the registers they hold;
// the sums are the same (k-step ks goes to set ks & 1 either way).
template <int NT, bool TWO, int DK, bool kOne = kOnePass, int CH = 0, int LD = HeadDim<DK>::kLd>
__device__ inline void scores(float (&c)[NT][4], float (&d)[NT][4], const float* X1,
                              const float* Y1, const float* X2, const float* Y2, int g, int t) {
  float c2[2][NT][4], d2[2][NT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    zero(c2[p]);
    zero(d2[p]);
  }
  constexpr int ND = HeadDim<DK>::kND;
  constexpr int kCh = CH > 0 && CH < ND ? CH : ND;
  static_assert(kCh % 2 == 0 && ND % kCh == 0, "a chunk holds whole pairs of k-steps");
#pragma unroll 1
  for (int k0 = 0; k0 < ND; k0 += kCh) {
#pragma unroll
    for (int kk = 0; kk < kCh; ++kk) {
      const int ks = k0 + kk;
      uint32_t ab[4], as[4], bb[2], bs[2];
      frag_a<LD, kOne>(X1, 8 * ks, g, t, ab, as);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        frag_bt<LD, kOne>(Y1, 8 * j, 8 * ks, g, t, bb, bs);
        mma_p<kOne>(c2[kk & 1][j], ab, as, bb, bs);
      }
      if (TWO) {
        frag_a<LD, kOne>(X2, 8 * ks, g, t, ab, as);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          frag_bt<LD, kOne>(Y2, 8 * j, 8 * ks, g, t, bb, bs);
          mma_p<kOne>(d2[kk & 1][j], ab, as, bb, bs);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c[j][i] = c2[0][j][i] + c2[1][j][i];
      if (TWO) d[j][i] = d2[0][j][i] + d2[1][j][i];
    }
}

// an element of a matrix in device memory through the read-only cache, or
// 0 when !ok (a row past T, a column past dh)
__device__ inline float ldg0(const float* __restrict__ p, bool ok) { return ok ? __ldg(p) : 0.f; }

// acc[n] += A . Y over the warp's 16 rows: A the C fragments of a 16 x
// NT*8 tile (k in pair order), Y a row-major shared (NT*8, LD) tile, from
// the block's first column (NV*8 columns).
// Each 8-step's product is formed from zero and added to acc in fp32.
// Fed back as the mma's C operand over a whole axis, an accumulator's
// relative error grows with the chain's length (the tensor core's fp32
// sums are not rounded to nearest): at T=4000 (chip_smoke.py, H100),
// mm_bwd_dkv's dV, whose chain runs over A args a query tile, reached
// 1.4e-4 against an fp64 reference (3.0e-6 this way), and the train
// step's comparison failed on a leaf that the flash kernels' chains feed
// (1.2e-4 against its 1e-4 limit).  The four adds a product cost the
// flash kernels ~10 % (PERF.md).
template <int NT, int NV, int LD, bool kOne = kOnePass>
__device__ inline void accumulate(float (&acc)[NV][4], const float (&a)[NT][4], const float* Y,
                                  int g, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ab[4], as[4];
    a_from_c<kOne>(a[j], ab, as);
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      uint32_t bb[2], bs[2];
      frag_b_pairs<LD, kOne>(Y, 8 * j, 8 * n, g, t, bb, bs);
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma_p<kOne>(part, ab, as, bb, bs);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += part[i];
    }
  }
}

// out[r] = sum_d x[r, d] y[r, d] over (rows, dh) matrices, a warp a row of
// a 256-thread block (8 rows a block): a backward's delta
__device__ inline void row_dots(const float* __restrict__ x, const float* __restrict__ y,
                                float* __restrict__ out, int rows, int dh) {
  const int r = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= rows) return;
  float sum = 0.f;
  if (dh % 4 == 0 && aligned16(x) && aligned16(y)) {
    const float4* x4 = reinterpret_cast<const float4*>(x + (size_t)r * dh);
    const float4* y4 = reinterpret_cast<const float4*>(y + (size_t)r * dh);
    for (int c = lane; c < dh / 4; c += 32) {
      const float4 a = __ldg(x4 + c), b = __ldg(y4 + c);
      sum += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
    }
  } else {
    for (int d = lane; d < dh; d += 32) sum += x[(size_t)r * dh + d] * y[(size_t)r * dh + d];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) out[r] = sum;
}

__device__ inline float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ inline float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// this lane's 2 x 2 values of a (16 x NN*8) C-fragment accumulator to rows
// r0 and r0 + 8, columns c0 on, of a (T, dh) matrix, times mul0 (mul1)
template <int NN>
__device__ inline void store_rows(float* __restrict__ out, const float (&acc)[NN][4], int r0,
                                  int c0, int T, int dh, int t, float mul0, float mul1) {
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = c0 + 8 * n + 2 * t + e;
      if (col < dh) {
        if (r0 < T) out[(size_t)r0 * dh + col] = acc[n][e] * mul0;
        if (r0 + 8 < T) out[(size_t)(r0 + 8) * dh + col] = acc[n][2 + e] * mul1;
      }
    }
}

}  // namespace
