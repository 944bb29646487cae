// Fused cross-MLP grounding head forward, fp32 results:
//
//   logit[b,a,t] = w2 . relu( W1^T relu( wv[b,t] + wl[b,a] + Wx^T (vis[b,t] * arg[b,a]) ) + b1 ) + b2
//
// Replaces vog_tpu/kernels/grounding_head.py §_fwd_call (_fwd_kernel).  The
// plain math materialises four (B,A,T,D) intermediates; this kernel keeps
// them on chip and writes only the (B,A,T) logits.  At GT5 (B=16, A=5,
// T=200, D=512, Dh=256) the two products are 12.6 GFLOP against ~13 MB of
// inputs, so it is bound by operations.  Plain TF32 would miss the 1e-4
// parity bound, and fp32 FMA loops ran behind cuBLAS's fp32 GEMMs, so the
// products run on the tensor cores in 3xTF32: each fp32 operand is split
// into a TF32 part and a TF32 remainder, and a.b is taken as
// a_small.b_big + a_big.b_small + a_big.b_big (fp32-level accuracy, three
// mma.sync m16n8k8 per tile step).
//
// Design: a block owns (b, 16 tokens) for all A args, i.e. an (A*16, D)
// tile of cross rows built in shared memory (rows padded by 4 floats so
// the A-fragment reads hit distinct banks).  Each of 16 warps owns 32
// output columns of the first product for all rows, reading Wx fragments
// from L2 one k-step ahead; the relu'd hidden tile then overwrites the
// cross tile, each warp owns 16 columns of the second product, and the
// w2 dot is a shuffle + shared-memory reduction.  wgmma comes later.
//
// Backward (vog_tpu/kernels/grounding_head.py §_fused_head_bwd, all 9
// gradients).  The TPU kernel keeps the (D,D) and (D,Dh) weight-gradient
// accumulators resident in VMEM across its whole grid; a 1 MB fp32
// accumulator does not fit a block's 227 KB here, and blocks run in no
// order.  So two kernels.  The work is 6 B A T (D^2 + D Dh) = 37.7 GFLOP at
// GT5 (four row products and two weight products), bound by operations:
//
//   head_bwd_rows  per (b, 16 tokens) block, the forward's tiling: it
//                  recomputes z0, h and z1, forms dz1 = [z1 > 0] g w2, dh =
//                  dz1 W1^T, dz0 = [z0 > 0] dh and dcross = dz0 Wx^T (four
//                  3xTF32 products, one (A*16, D) shared tile reused for
//                  cross, h, dz1 and dz0 in turn); it writes dvis, dwv,
//                  per-block partials of darg, dwl, db1, dw2, and the cross
//                  rows, h, dz0, dz1 (B,A,T,.) for the second kernel.  Each
//                  warp streams its own weight columns by cp.async, 8
//                  k-rows a stage, into a ring of 3 stages in shared memory
//                  (``gemm_rows``: two stages ahead, warp syncs only), in
//                  place of loads from L2 one k-step ahead; a block-wide
//                  ring (one __syncthreads a stage) measured slower than
//                  those loads.  16 warps and the 165 KB tile hold one
//                  block an SM (the accumulators alone take the register
//                  file), so the GT5 grid of 13 x 16 = 208 blocks takes
//                  1.58 waves;
//   head_bwd_w     dWx = sum_rows cross^T dz0 and dW1 = sum_rows h^T dz1
//                  in one launch: a 128 x 64 output tile of either a block,
//                  8 warps of 32 x 32 (each split fragment feeds 2 or 4
//                  mma3), rows streamed 32 a stage by cp.async into a ring
//                  of 3, one partial per row chunk; 48 tiles x 11 chunks =
//                  528 blocks at GT5, two waves of two blocks an SM.
//
// The two overlap (``launch_bwd``): the batch rows whose row blocks fit one
// wave run first, and the weight kernel's chunks over their rows fill the
// SMs that the row kernel's second wave, on a second stream, leaves idle.
// Every partial is added up by the wrapper in a fixed order, so the
// gradients are the same on every run.  The previous design (the weight
// kernel staging 64 x 64 tiles synchronously with scalar loads and forming
// cross with two divisions an element, in two launches; the row kernel's
// weights read from L2 by every warp) took 1.8102 / 1.8190 ms at GT5
// (chip_smoke.py, H100 80GB HBM3, 700 W); this design's times are in
// PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles.cuh"  // cp.async; through it tf32.cuh: split, mma3, the fragment loaders

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kBT = 16;  // tokens per block: rows M = A * kBT, A m-tiles
constexpr int kMaxA = 5;
constexpr int kMaxD = 512;
constexpr int kMaxHid = 256;  // Dh
constexpr int kN1 = 32;  // first-product columns per warp (4 n-tiles)
constexpr int kN2 = 16;  // second-product columns per warp (2 n-tiles)

template <int A>
__global__ void __launch_bounds__(kThreads, 1)
head_fwd(const float* __restrict__ vis, const float* __restrict__ arg,
         const float* __restrict__ wv, const float* __restrict__ wl,
         const float* __restrict__ wx, const float* __restrict__ w1,
         const float* __restrict__ b1, const float* __restrict__ w2,
         const float* __restrict__ b2, float* __restrict__ out, int T, int D,
         int Dh) {
  constexpr int M = A * kBT;
  const int ld = D + 4;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kBT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;

  extern __shared__ float xs[];  // M x ld: the cross tile, then the hidden tile
  __shared__ float red[kWarps][M];

  for (int idx = tid; idx < M * D; idx += kThreads) {
    const int r = idx / D, kk = idx - r * D;  // kk fastest: coalesced reads
    const int a = r / kBT, t = t0 + r % kBT;
    xs[r * ld + kk] = t < T ? vis[((size_t)b * T + t) * D + kk] *
                                  arg[((size_t)b * A + a) * D + kk]
                            : 0.f;
  }
  __syncthreads();

  // ---- z0 = cross . Wx: warp columns nw .. nw+31, all A m-tiles ----------
  const int nw = warp * kN1;
  const bool w_ok = nw < D;  // D % 32 == 0: a warp's columns are all in or out
  float acc[A][4][4];
#pragma unroll
  for (int m = 0; m < A; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
  if (w_ok) {
    float braw[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) load_b(wx, D, 0, nw + 8 * j, lane, braw[j]);
    for (int k0 = 0; k0 < D; k0 += 8) {
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split(braw[j][0], bb[j][0], bs[j][0]);
        split(braw[j][1], bb[j][1], bs[j][1]);
      }
      if (k0 + 8 < D) {
#pragma unroll
        for (int j = 0; j < 4; ++j) load_b(wx, D, k0 + 8, nw + 8 * j, lane, braw[j]);
      }
#pragma unroll
      for (int m = 0; m < A; ++m) {
        uint32_t ab[4], as[4];
        load_a(xs, ld, 16 * m, k0, lane, ab, as);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma3(acc[m][j], ab, as, bb[j], bs[j]);
      }
    }
  }
  __syncthreads();  // every warp is done reading the cross tile
  if (w_ok) {
#pragma unroll
    for (int m = 0; m < A; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * m + g + (i >= 2 ? 8 : 0);
          const int n = nw + 8 * j + 2 * tq + (i & 1);
          const int a = r / kBT, t = t0 + r % kBT;
          const float z = t < T ? acc[m][j][i] + wv[((size_t)b * T + t) * D + n] +
                                      wl[((size_t)b * A + a) * D + n]
                                : 0.f;
          xs[r * ld + n] = fmaxf(z, 0.f);
        }
  }
  __syncthreads();

  // ---- z1 = h . W1 + b1: warp columns n2 .. n2+15 ------------------------
  const int n2 = warp * kN2;
  const bool w2_ok = n2 < Dh;  // Dh % 16 == 0
  float acc2[A][2][4];
#pragma unroll
  for (int m = 0; m < A; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc2[m][j][i] = 0.f;
  if (w2_ok) {
    float braw[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) load_b(w1, Dh, 0, n2 + 8 * j, lane, braw[j]);
    for (int k0 = 0; k0 < D; k0 += 8) {
      uint32_t bb[2][2], bs[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        split(braw[j][0], bb[j][0], bs[j][0]);
        split(braw[j][1], bb[j][1], bs[j][1]);
      }
      if (k0 + 8 < D) {
#pragma unroll
        for (int j = 0; j < 2; ++j) load_b(w1, Dh, k0 + 8, n2 + 8 * j, lane, braw[j]);
      }
#pragma unroll
      for (int m = 0; m < A; ++m) {
        uint32_t ab[4], as[4];
        load_a(xs, ld, 16 * m, k0, lane, ab, as);
#pragma unroll
        for (int j = 0; j < 2; ++j) mma3(acc2[m][j], ab, as, bb[j], bs[j]);
      }
    }
  }
  // w2 . relu(z1): this lane's columns, then the 4 lanes of a row, then warps
#pragma unroll
  for (int m = 0; m < A; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float part = 0.f;
      if (w2_ok) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n2 + 8 * j + 2 * tq + e;
            part += fmaxf(acc2[m][j][2 * h + e] + b1[n], 0.f) * w2[n];
          }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (tq == 0) red[warp][16 * m + g + 8 * h] = part;
    }
  __syncthreads();
  if (tid < M) {
    const int a = tid / kBT, t = t0 + tid % kBT;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][tid];
    if (t < T) out[((size_t)b * A + a) * T + t] = sum + b2[0];
  }
}

template <int A>
int launch(const float* vis, const float* arg, const float* wv,
           const float* wl, const float* wx, const float* w1,
           const float* b1, const float* w2, const float* b2, float* out,
           int B, int T, int D, int Dh, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)A * kBT * (D + 4);
  cudaError_t e = cudaFuncSetAttribute(
      head_fwd<A>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + kBT - 1) / kBT, B);
  head_fwd<A><<<grid, kThreads, smem, stream>>>(vis, arg, wv, wl, wx, w1, b1,
                                                w2, b2, out, T, D, Dh);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kRing = 3;                 // stages of a warp's weight ring
constexpr int kWarpSlab = 8 * (32 + 8);  // floats a stage: 8 k-rows of <= 32 columns

// acc[A][NT][4] += X (rows 16m.., shared, ld) . B for the warp's NT n-tiles
// at n0, over k in [0, K): B(k, n) = W[k * ldw + n] or, when trans,
// W[n * ldw + k].  The warp streams its own B columns by 16-byte cp.async,
// 8 k-rows a stage, into its ring of kRing stages in shared memory, two
// stages ahead of use, with no block barrier (a warp sync a stage).  A
// stage is [k][8 NT + 8] (conflict-free b reads of rows t and t + 4) or,
// when trans, [n][8] with the two 4-float halves of a row swapped on every
// other group of 4 rows (the reads of rows g and g + 4 then hit other
// banks).  Operands are split with split_int.
template <int A, int NT, bool trans>
__device__ inline void gemm_rows(float (&acc)[A][NT][4], const float* X, int ld,
                                 const float* __restrict__ W, int ldw, int n0, int K,
                                 float* ring, int lane) {
  constexpr int NC = 8 * NT, LDB = NC + 8;  // the warp's columns; a stage's row stride
  const int g = lane >> 2, t = lane & 3;
  const int nk = K / 8;
  auto load = [&](int s) {
    if (s < nk) {
      float* dst = ring + (s % kRing) * kWarpSlab;
      const int k0 = 8 * s;
#pragma unroll
      for (int c = lane; c < 2 * NC; c += 32) {  // 16-byte chunks
        if (trans) {  // rows n0 .. n0 + NC - 1 of W, columns k0 .. k0 + 7
          const int n = c >> 1, half = c & 1;
          cp_async16(dst + 8 * n + 4 * (half ^ ((n >> 2) & 1)),
                     W + (size_t)(n0 + n) * ldw + k0 + 4 * half, true);
        } else {  // rows k0 .. k0 + 7 of W, columns n0 .. n0 + NC - 1
          const int kk = c / (NC / 4), col = 4 * (c % (NC / 4));
          cp_async16(dst + kk * LDB + col, W + (size_t)(k0 + kk) * ldw + n0 + col, true);
        }
      }
    }
    cp_commit();  // an empty group past the last stage keeps the count
  };
  __syncwarp();  // every lane is done with the ring's previous product
  load(0);
  load(1);
  for (int s = 0; s < nk; ++s) {
    cp_wait<kRing - 2>();
    __syncwarp();  // the warp's copies of stage s are in; every lane is done with stage s - 1
    load(s + kRing - 1);
    const float* sb = ring + (s % kRing) * kWarpSlab;
    uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + g, sw = 4 * (g >> 2);  // (n >> 2) & 1 == g >> 2
      const float b0 = trans ? sb[8 * n + (t ^ sw)] : sb[t * LDB + n];
      const float b1 = trans ? sb[8 * n + ((t + 4) ^ sw)] : sb[(t + 4) * LDB + n];
      split_int(b0, bb[j][0], bs[j][0]);
      split_int(b1, bb[j][1], bs[j][1]);
    }
    const int k0 = 8 * s;
#pragma unroll
    for (int m = 0; m < A; ++m) {
      const float* p = X + (16 * m + g) * ld + k0 + t;
      uint32_t ab[4], as[4];
      split_int(p[0], ab[0], as[0]);
      split_int(p[8 * ld], ab[1], as[1]);
      split_int(p[4], ab[2], as[2]);
      split_int(p[8 * ld + 4], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma3(acc[m][j], ab, as, bb[j], bs[j]);
    }
  }
}

// sum of v over the 8 row groups of a warp (lanes with the same lane & 3)
__device__ inline float sum_rows8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

template <int A>
__global__ void __launch_bounds__(kThreads, 1)
head_bwd_rows(const float* __restrict__ vis, const float* __restrict__ arg,
              const float* __restrict__ wv, const float* __restrict__ wl,
              const float* __restrict__ wx, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const float* __restrict__ gin, float* __restrict__ cross_out,
              float* __restrict__ h_out,
              float* __restrict__ dz0_out, float* __restrict__ dz1_out,
              float* __restrict__ dvis, float* __restrict__ dwv,
              float* __restrict__ darg_part, float* __restrict__ dwl_part,
              float* __restrict__ db1_part, float* __restrict__ dw2_part, int T,
              int D, int Dh, int b_first) {
  constexpr int M = A * kBT;
  const int ld = D + 4, ld1 = Dh + 4;
  const int b = b_first + blockIdx.y;
  const int t0 = blockIdx.x * kBT;
  const size_t blk = (size_t)b * gridDim.x + blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;

  extern __shared__ float xs[];  // M x ld: cross, then h, dz1 (ld1), dz0
  float* ring = xs + M * ld + (threadIdx.x >> 5) * kRing * kWarpSlab;  // this warp's weight ring

  for (int idx = tid; idx < M * D; idx += kThreads) {
    const int r = idx / D, kk = idx - r * D;
    const int a = r / kBT, t = t0 + r % kBT;
    float x = 0.f;
    if (t < T) {  // the cross rows, also the weight kernel's dWx operand
      x = vis[((size_t)b * T + t) * D + kk] * arg[((size_t)b * A + a) * D + kk];
      cross_out[(((size_t)b * A + a) * T + t) * D + kk] = x;
    }
    xs[r * ld + kk] = x;
  }
  __syncthreads();

  // ---- z0 = cross . Wx (+ stems), h = relu(z0); warp columns nw .. nw+31 --
  const int nw = warp * kN1;
  const bool w_ok = nw < D;
  float acc[A][4][4];
#pragma unroll
  for (int m = 0; m < A; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
  if (w_ok) gemm_rows<A, 4, false>(acc, xs, ld, wx, D, nw, D, ring, lane);
  __syncthreads();  // every warp is done reading the cross tile
  uint32_t pos[(A * 16 + 31) / 32];  // z0 > 0 at this lane's (m, j, i)
#pragma unroll
  for (int w = 0; w < (A * 16 + 31) / 32; ++w) pos[w] = 0u;
  if (w_ok) {
#pragma unroll
    for (int m = 0; m < A; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * m + g + (i >= 2 ? 8 : 0);
          const int n = nw + 8 * j + 2 * tq + (i & 1);
          const int t = t0 + r % kBT;
          float z = 0.f;
          if (t < T) {
            z = acc[m][j][i] + wv[((size_t)b * T + t) * D + n] + wl[((size_t)b * A + m) * D + n];
            h_out[(((size_t)b * A + m) * T + t) * D + n] = fmaxf(z, 0.f);
          }
          const int bit = m * 16 + j * 4 + i;
          if (z > 0.f) pos[bit / 32] |= 1u << (bit % 32);
          xs[r * ld + n] = fmaxf(z, 0.f);
        }
  }
  __syncthreads();

  // ---- z1 = h . W1 + b1; dz1 = [z1 > 0] g w2; warp columns n2 .. n2+15 ----
  const int n2 = warp * kN2;
  const bool w2_ok = n2 < Dh;
  float acc2[A][2][4];
#pragma unroll
  for (int m = 0; m < A; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc2[m][j][i] = 0.f;
  if (w2_ok) gemm_rows<A, 2, false>(acc2, xs, ld, w1, Dh, n2, D, ring, lane);
  __syncthreads();  // every warp is done reading h
  if (w2_ok) {
    float pw2[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, pb1[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int m = 0; m < A; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * m + g + (i >= 2 ? 8 : 0);
          const int n = n2 + 8 * j + 2 * tq + (i & 1);
          const int t = t0 + r % kBT;
          const float gr = t < T ? gin[((size_t)b * A + m) * T + t] : 0.f;
          const float z1 = acc2[m][j][i] + b1[n];
          const float d = z1 > 0.f ? gr * w2[n] : 0.f;
          pw2[j][i & 1] += fmaxf(z1, 0.f) * gr;
          pb1[j][i & 1] += d;
          xs[r * ld1 + n] = d;
          if (t < T) dz1_out[(((size_t)b * A + m) * T + t) * Dh + n] = d;
        }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float sw = sum_rows8(pw2[j][e]), sb = sum_rows8(pb1[j][e]);
        if (g == 0) {
          const int n = n2 + 8 * j + 2 * tq + e;
          dw2_part[blk * Dh + n] = sw;
          db1_part[blk * Dh + n] = sb;
        }
      }
  }
  __syncthreads();

  // ---- dh = dz1 . W1^T; dz0 = [z0 > 0] dh (same layout as z0) ------------
#pragma unroll
  for (int m = 0; m < A; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
  if (w_ok) gemm_rows<A, 4, true>(acc, xs, ld1, w1, Dh, nw, Dh, ring, lane);
  __syncthreads();  // every warp is done reading dz1
  if (w_ok) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = nw + 8 * j + 2 * tq + (i & 1);
        const int t = t0 + g + (i >= 2 ? 8 : 0);
        float sv = 0.f;
#pragma unroll
        for (int m = 0; m < A; ++m) {
          const int bit = m * 16 + j * 4 + i;
          const float d = (pos[bit / 32] >> (bit % 32)) & 1u ? acc[m][j][i] : 0.f;
          acc[m][j][i] = d;
          sv += d;
          xs[(16 * m + g + (i >= 2 ? 8 : 0)) * ld + n] = d;
          if (t < T) dz0_out[(((size_t)b * A + m) * T + t) * D + n] = d;
        }
        if (t < T) dwv[((size_t)b * T + t) * D + n] = sv;
      }
#pragma unroll
    for (int m = 0; m < A; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sw = sum_rows8(acc[m][j][e] + acc[m][j][e + 2]);
          if (g == 0) dwl_part[(blk * A + m) * D + nw + 8 * j + 2 * tq + e] = sw;
        }
  }
  __syncthreads();

  // ---- dcross = dz0 . Wx^T; dvis = sum_a dcross arg_a, darg = sum_t dcross vis
#pragma unroll
  for (int m = 0; m < A; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
  if (w_ok) {
    gemm_rows<A, 4, true>(acc, xs, ld, wx, D, nw, D, ring, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nw + 8 * j + 2 * tq + e;
        float da[A];
#pragma unroll
        for (int m = 0; m < A; ++m) da[m] = 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = e + 2 * hh;
          const int t = t0 + g + 8 * hh;
          if (t >= T) continue;
          const float vtn = vis[((size_t)b * T + t) * D + n];
          float sv = 0.f;
#pragma unroll
          for (int m = 0; m < A; ++m) {
            sv = fmaf(acc[m][j][i], arg[((size_t)b * A + m) * D + n], sv);
            da[m] = fmaf(acc[m][j][i], vtn, da[m]);
          }
          dvis[((size_t)b * T + t) * D + n] = sv;
        }
#pragma unroll
        for (int m = 0; m < A; ++m) {
          const float sa = sum_rows8(da[m]);
          if (g == 0) darg_part[(blk * A + m) * D + n] = sa;
        }
      }
  }
}

// C[z] = sum over the rows R of chunk z of X[R]^T Y[R], for both weights
// in one launch: X the cross rows (dWx, Y = dz0) or h (dW1, Y = dz1), both
// (R, D), rows R = (b, a, t).  A block owns a 128 x 64 output tile of one
// of the two and chunk chunk0 + blockIdx.y of the rows [r_begin, r_end); its 8 warps own 32 x 32 each (a split A
// fragment feeds 4 mma3, a split B fragment 2).  Rows stream 32 a stage by
// 16-byte cp.async into a ring of 3 stages, one __syncthreads a stage.
constexpr int kWM = 128;            // output rows (X columns) a block
constexpr int kWN = 64;             // output columns (Y columns) a block
constexpr int kWK = 32;             // rows a stage
constexpr int kWStages = 3;
constexpr int kWThreads = 256;
constexpr int kWXld = kWM + 8;      // shared row strides: 8 (mod 32) words,
constexpr int kWYld = kWN + 8;      // conflict-free fragment reads
constexpr int kWStage = kWK * (kWXld + kWYld);  // floats a stage

__global__ void __launch_bounds__(kWThreads, 2)
head_bwd_w(const float* __restrict__ cross, const float* __restrict__ dz0,
           const float* __restrict__ h, const float* __restrict__ dz1,
           float* __restrict__ dwx_part, float* __restrict__ dw1_part, int D, int Dh,
           int r_begin, int r_end, int chunk0, int rows_per_chunk) {
  extern __shared__ float4 wsm4[];
  float* sm = reinterpret_cast<float*>(wsm4);  // kWStages x (X: kWK x kWXld, Y: kWK x kWYld)
  // tiles of dWx first (D/kWM x D/kWN), then of dW1 (D/kWM x Dh/kWN)
  const int tm = (D + kWM - 1) / kWM, tnx = (D + kWN - 1) / kWN;
  int tile = blockIdx.x;
  const bool first = tile < tm * tnx;
  if (!first) tile -= tm * tnx;
  const int tn = first ? tnx : (Dh + kWN - 1) / kWN;
  const int i0 = (tile / tn) * kWM, n0 = (tile % tn) * kWN;
  const int N = first ? D : Dh;
  const float* X = first ? cross : h;
  const float* Y = first ? dz0 : dz1;
  const int chunk = chunk0 + blockIdx.y;
  const int r_lo = r_begin + blockIdx.y * rows_per_chunk;
  const int r_hi = min(r_end, r_lo + rows_per_chunk);
  const int nst = r_hi > r_lo ? (r_hi - r_lo + kWK - 1) / kWK : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = 32 * (warp & 3), wn = 32 * (warp >> 2);

  auto stage = [&](int s) {
    if (s < nst) {
      float* xs = sm + (s % kWStages) * kWStage;
      float* ys = xs + kWK * kWXld;
      const int r0 = r_lo + s * kWK;
      for (int c = tid; c < kWK * (kWM + kWN) / 4; c += kWThreads) {
        if (c < kWK * kWM / 4) {  // X: 32 chunks of 16 bytes a row
          const int rr = c / (kWM / 4), col = 4 * (c % (kWM / 4)), row = r0 + rr;
          const bool ok = row < r_hi && i0 + col < D;
          cp_async16(xs + rr * kWXld + col, ok ? X + (size_t)row * D + i0 + col : X, ok);
        } else {  // Y: 16 chunks a row
          const int cy = c - kWK * kWM / 4;
          const int rr = cy / (kWN / 4), col = 4 * (cy % (kWN / 4)), row = r0 + rr;
          const bool ok = row < r_hi && n0 + col < N;
          cp_async16(ys + rr * kWYld + col, ok ? Y + (size_t)row * N + n0 + col : Y, ok);
        }
      }
    }
    cp_commit();  // an empty group past the last stage keeps the count
  };

  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;

  stage(0);
  stage(1);
  for (int s = 0; s < nst; ++s) {
    cp_wait<kWStages - 2>();
    __syncthreads();  // stage s is in; every warp is done with stage s - 1
    stage(s + kWStages - 1);
    const float* xs = sm + (s % kWStages) * kWStage;
    const float* ys = xs + kWK * kWXld;
#pragma unroll
    for (int k0 = 0; k0 < kWK; k0 += 8) {
      // A = X^T: a0 (i = g, k = tq), a1 (g + 8, tq), a2 (g, tq + 4), a3 (g + 8, tq + 4)
      uint32_t ab[2][4], as[2][4], bb[4][2], bs[4][2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* p = xs + (k0 + tq) * kWXld + wm + 16 * m + g;
        split_int(p[0], ab[m][0], as[m][0]);
        split_int(p[8], ab[m][1], as[m][1]);
        split_int(p[4 * kWXld], ab[m][2], as[m][2]);
        split_int(p[4 * kWXld + 8], ab[m][3], as[m][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* q = ys + (k0 + tq) * kWYld + wn + 8 * j + g;
        split_int(q[0], bb[j][0], bs[j][0]);
        split_int(q[4 * kWYld], bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma3(acc[m][j], ab[m], as[m], bb[j], bs[j]);
    }
  }

  float* out = first ? dwx_part + (size_t)chunk * D * D : dw1_part + (size_t)chunk * D * Dh;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = i0 + wm + 16 * m + g + 8 * hh;
        const int col = n0 + wn + 8 * j + 2 * tq;
        if (row < D && col < N)
          *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
              make_float2(acc[m][j][2 * hh], acc[m][j][2 * hh + 1]);
      }
}

// A second stream, and events, for the overlap in launch_bwd: made once a
// process for each device, at its first call there.
struct SideStream {
  cudaStream_t s = nullptr;
  cudaEvent_t in = nullptr, out = nullptr;
  int sms = 0;
};
constexpr int kMaxDevices = 64;

cudaError_t side_stream(SideStream*& out) {
  static SideStream sides[kMaxDevices];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  SideStream& x = sides[dev];
  if (x.s == nullptr) {
    e = cudaDeviceGetAttribute(&x.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaEventCreateWithFlags(&x.in, cudaEventDisableTiming);
    if (e == cudaSuccess) e = cudaEventCreateWithFlags(&x.out, cudaEventDisableTiming);
    if (e == cudaSuccess) e = cudaStreamCreateWithFlags(&x.s, cudaStreamNonBlocking);
    if (e != cudaSuccess) return e;
  }
  out = &x;
  return cudaSuccess;
}

// The row kernel's blocks of batch rows [b0, b1), then on the same stream
// the weight kernel over their rows in chunks [c0, c1).
template <int A>
cudaError_t launch_part(const float* vis, const float* arg, const float* wv, const float* wl,
                        const float* wx, const float* w1, const float* b1, const float* w2,
                        const float* gin, float* cross, float* h, float* dz0, float* dz1,
                        float* dvis, float* dwv, float* darg_part, float* dwl_part,
                        float* db1_part, float* dw2_part, float* dwx_part, float* dw1_part,
                        int T, int D, int Dh, int bb0, int bb1, int c0, int c1,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)A * kBT * (D + 4) + kWarps * kRing * kWarpSlab);
  head_bwd_rows<A><<<dim3((T + kBT - 1) / kBT, bb1 - bb0), kThreads, smem, stream>>>(
      vis, arg, wv, wl, wx, w1, b1, w2, gin, cross, h, dz0, dz1, dvis, dwv, darg_part,
      dwl_part, db1_part, dw2_part, T, D, Dh, bb0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int r0 = bb0 * A * T, r1 = bb1 * A * T;
  const int per = ((r1 - r0 + (c1 - c0) - 1) / (c1 - c0) + kWK - 1) / kWK * kWK;
  const int tiles = ((D + kWM - 1) / kWM) * ((D + kWN - 1) / kWN + (Dh + kWN - 1) / kWN);
  head_bwd_w<<<dim3(tiles, c1 - c0), kWThreads, sizeof(float) * kWStages * kWStage, stream>>>(
      cross, dz0, h, dz1, dwx_part, dw1_part, D, Dh, r0, r1, c0, per);
  return cudaGetLastError();
}

// The row kernel holds one block an SM, so at GT5 its 208 blocks take 1.58
// waves and the second leaves 56 SMs idle.  The batch rows whose blocks
// fit one wave (b < nb1) run first on the caller's stream, and the weight
// kernel's chunks over their rows follow there at once; the other batch
// rows' blocks run on a second stream, followed by their chunks, so the
// first chunks fill the SMs that the row kernel's second wave leaves
// idle.  The caller's stream waits for the second at the end.  The
// partials go to fixed chunks: the gradients do not depend on the overlap.
template <int A>
int launch_bwd(const float* vis, const float* arg, const float* wv, const float* wl,
               const float* wx, const float* w1, const float* b1, const float* w2,
               const float* gin, float* cross, float* h, float* dz0, float* dz1, float* dvis,
               float* dwv, float* darg_part, float* dwl_part, float* db1_part,
               float* dw2_part, float* dwx_part, float* dw1_part, int B, int T,
               int D, int Dh, int chunks, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)A * kBT * (D + 4) + kWarps * kRing * kWarpSlab);
  cudaError_t e = cudaFuncSetAttribute(
      head_bwd_rows<A>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(head_bwd_w, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(sizeof(float) * kWStages * kWStage));
  SideStream* side = nullptr;
  if (e == cudaSuccess) e = side_stream(side);
  if (e != cudaSuccess) return (int)e;
  const int nb1 = side->sms / ((T + kBT - 1) / kBT);
  const int c1 = (int)((long long)chunks * nb1 / B);
  if (nb1 < 1 || nb1 >= B || c1 < 1 || c1 >= chunks)  // no second wave, or too few chunks
    return (int)launch_part<A>(vis, arg, wv, wl, wx, w1, b1, w2, gin, cross, h, dz0, dz1, dvis,
                               dwv, darg_part, dwl_part, db1_part, dw2_part, dwx_part, dw1_part,
                               T, D, Dh, 0, B, 0, chunks, stream);
  e = cudaEventRecord(side->in, stream);  // the inputs are ready on the caller's stream
  if (e == cudaSuccess) e = cudaStreamWaitEvent(side->s, side->in, 0);
  if (e == cudaSuccess)
    e = launch_part<A>(vis, arg, wv, wl, wx, w1, b1, w2, gin, cross, h, dz0, dz1, dvis, dwv,
                       darg_part, dwl_part, db1_part, dw2_part, dwx_part, dw1_part, T, D, Dh,
                       0, nb1, 0, c1, stream);
  if (e == cudaSuccess)
    e = launch_part<A>(vis, arg, wv, wl, wx, w1, b1, w2, gin, cross, h, dz0, dz1, dvis, dwv,
                       darg_part, dwl_part, db1_part, dw2_part, dwx_part, dw1_part, T, D, Dh,
                       nb1, B, c1, chunks, side->s);
  if (e == cudaSuccess) e = cudaEventRecord(side->out, side->s);
  if (e == cudaSuccess) e = cudaStreamWaitEvent(stream, side->out, 0);
  return (int)e;
}

}  // namespace

// cross, h, dz0: (B, A, T, D) and dz1 (B, A, T, Dh) scratch between the
// two kernels; chunks: the row split of the weight-gradient kernel
// (dwx_part holds chunks x D x D, dw1_part chunks x D x Dh); darg/dwl partials hold
// B x ceil(T/16) x A x D, db1/dw2 partials B x ceil(T/16) x Dh.
extern "C" int vog_head_bwd(const float* vis, const float* arg, const float* wv,
                            const float* wl, const float* wx, const float* w1,
                            const float* b1, const float* w2, const float* gin,
                            float* cross, float* h, float* dz0, float* dz1, float* dvis,
                            float* dwv, float* darg_part, float* dwl_part,
                            float* db1_part, float* dw2_part, float* dwx_part,
                            float* dw1_part, int B, int A, int T, int D, int Dh,
                            int chunks, void* stream) {
  if (D < 32 || D > kMaxD || D % 32 != 0 || Dh < 16 || Dh > kMaxHid || Dh % 16 != 0 ||
      chunks < 1 || !aligned16(wx) || !aligned16(w1))  // the weights stream by 16-byte cp.async
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VOG_HEAD_BWD_CASE(n)                                                        \
  case n:                                                                           \
    return launch_bwd<n>(vis, arg, wv, wl, wx, w1, b1, w2, gin, cross, h, dz0, dz1, dvis, \
                         dwv, darg_part, dwl_part, db1_part, dw2_part, dwx_part,   \
                         dw1_part, B, T, D, Dh, chunks, s);
  switch (A) {
    VOG_HEAD_BWD_CASE(1)
    VOG_HEAD_BWD_CASE(2)
    VOG_HEAD_BWD_CASE(3)
    VOG_HEAD_BWD_CASE(4)
    VOG_HEAD_BWD_CASE(5)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VOG_HEAD_BWD_CASE
}

extern "C" int vog_head_fwd(const float* vis, const float* arg,
                            const float* wv, const float* wl, const float* wx,
                            const float* w1, const float* b1, const float* w2,
                            const float* b2, float* out, int B, int A, int T,
                            int D, int Dh, void* stream) {
  if (D < 32 || D > kMaxD || D % 32 != 0 || Dh < 16 || Dh > kMaxHid || Dh % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static_assert(kMaxA == 5, "the cases below cover A = 1..kMaxA");
#define VOG_HEAD_CASE(n) \
  case n:                \
    return launch<n>(vis, arg, wv, wl, wx, w1, b1, w2, b2, out, B, T, D, Dh, s);
  switch (A) {
    VOG_HEAD_CASE(1)
    VOG_HEAD_CASE(2)
    VOG_HEAD_CASE(3)
    VOG_HEAD_CASE(4)
    VOG_HEAD_CASE(5)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VOG_HEAD_CASE
}
