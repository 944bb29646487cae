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
// order.  So two kernels:
//
//   head_bwd_rows  per (b, 16 tokens) block, the forward's tiling: it
//                  recomputes z0, h and z1 (3xTF32, as the forward), forms
//                  dz1 = [z1 > 0] g w2, dh = dz1 W1^T, dz0 = [z0 > 0] dh and
//                  dcross = dz0 Wx^T on the tensor cores, one (A*16, D)
//                  shared tile reused for h, dz1 and dz0 in turn; it writes
//                  dvis, dwv, per-block partials of darg, dwl, db1, dw2, and
//                  h, dz0, dz1 (B,A,T,.) for the second kernel;
//   head_bwd_w     dWx = sum_rows cross^T dz0 (cross = vis * arg formed on
//                  the fly) and dW1 = sum_rows h^T dz1: 64 x 64 output tiles
//                  split over row chunks (3xTF32), one partial per chunk.
//
// Every partial is added up by the wrapper in a fixed order, so the
// gradients are the same on every run.  The work is 6 B A T (D^2 + D Dh)
// operations, bound by operations; the h/dz0/dz1 round trip is ~165 MB.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"  // split, mma3 and the fragment loaders

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kBT = 16;  // tokens per block: rows M = A * kBT, A m-tiles
constexpr int kMaxA = 5;
constexpr int kMaxD = 512;
constexpr int kMaxDh = 256;
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

// acc[A][NT][4] += X (rows 16m.., shared, ld) . B for the warp's NT n-tiles
// at n0, over k in [0, K); B(k, n) = W[k * ldw + n] or, when trans,
// W[n * ldw + k].  B fragments are read one k-step ahead.
template <int A, int NT, bool trans>
__device__ inline void gemm_rows(float (&acc)[A][NT][4], const float* X, int ld,
                                 const float* __restrict__ W, int ldw, int n0, int K,
                                 int lane) {
  float braw[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (trans) load_bt(W, ldw, 0, n0 + 8 * j, lane, braw[j]);
    else load_b(W, ldw, 0, n0 + 8 * j, lane, braw[j]);
  }
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      split(braw[j][0], bb[j][0], bs[j][0]);
      split(braw[j][1], bb[j][1], bs[j][1]);
    }
    if (k0 + 8 < K) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (trans) load_bt(W, ldw, k0 + 8, n0 + 8 * j, lane, braw[j]);
        else load_b(W, ldw, k0 + 8, n0 + 8 * j, lane, braw[j]);
      }
    }
#pragma unroll
    for (int m = 0; m < A; ++m) {
      uint32_t ab[4], as[4];
      load_a(X, ld, 16 * m, k0, lane, ab, as);
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
              const float* __restrict__ gin, float* __restrict__ h_out,
              float* __restrict__ dz0_out, float* __restrict__ dz1_out,
              float* __restrict__ dvis, float* __restrict__ dwv,
              float* __restrict__ darg_part, float* __restrict__ dwl_part,
              float* __restrict__ db1_part, float* __restrict__ dw2_part, int T,
              int D, int Dh) {
  constexpr int M = A * kBT;
  const int ld = D + 4, ld1 = Dh + 4;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kBT;
  const size_t blk = (size_t)b * gridDim.x + blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;

  extern __shared__ float xs[];  // M x ld: cross, then h, dz1 (ld1), dz0

  for (int idx = tid; idx < M * D; idx += kThreads) {
    const int r = idx / D, kk = idx - r * D;
    const int a = r / kBT, t = t0 + r % kBT;
    xs[r * ld + kk] = t < T ? vis[((size_t)b * T + t) * D + kk] *
                                  arg[((size_t)b * A + a) * D + kk]
                            : 0.f;
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
  if (w_ok) gemm_rows<A, 4, false>(acc, xs, ld, wx, D, nw, D, lane);
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
  if (w2_ok) gemm_rows<A, 2, false>(acc2, xs, ld, w1, Dh, n2, D, lane);
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
  if (w_ok) gemm_rows<A, 4, true>(acc, xs, ld1, w1, Dh, nw, Dh, lane);
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
    gemm_rows<A, 4, true>(acc, xs, ld, wx, D, nw, D, lane);
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

// C[z] = sum over rows R in chunk z of X[R]^T Y[R]: X (R, Dx) is vis * arg
// (cross) or h, Y (R, N) is dz0 or dz1, rows R = (b, a, t).  A 64 x 64
// output tile a block, 8 warps of 16 x 32, 3xTF32.
constexpr int kWT = 64;       // output tile edge
constexpr int kWK = 32;       // rows a stage
constexpr int kWld = kWT + 8; // shared row stride (conflict-free fragments)

__global__ void __launch_bounds__(256)
head_bwd_w(const float* __restrict__ vis, const float* __restrict__ arg,
           const float* __restrict__ X, const float* __restrict__ Y,
           float* __restrict__ part, int A, int T, int Dx, int N, int R,
           int rows_per_chunk) {
  __shared__ float Xs[kWK * kWld];
  __shared__ float Ys[kWK * kWld];
  const int n0 = blockIdx.x * kWT, i0 = blockIdx.y * kWT;
  const int r_lo = blockIdx.z * rows_per_chunk;
  const int r_hi = min(R, r_lo + rows_per_chunk);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int mt = warp % 4, nh = warp / 4;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int r0 = r_lo; r0 < r_hi; r0 += kWK) {
    __syncthreads();
    for (int idx = tid; idx < kWK * kWT; idx += 256) {
      const int rr = idx / kWT, c = idx % kWT, R0 = r0 + rr;
      float x = 0.f, y = 0.f;
      if (R0 < r_hi) {
        if (i0 + c < Dx) {
          if (X != nullptr) {
            x = X[(size_t)R0 * Dx + i0 + c];
          } else {
            const int bb = R0 / (A * T), rem = R0 - bb * A * T, a = rem / T, t = rem - a * T;
            x = vis[((size_t)bb * T + t) * Dx + i0 + c] * arg[((size_t)bb * A + a) * Dx + i0 + c];
          }
        }
        if (n0 + c < N) y = Y[(size_t)R0 * N + n0 + c];
      }
      Xs[rr * kWld + c] = x;
      Ys[rr * kWld + c] = y;
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < kWK; k0 += 8) {
      uint32_t ab[4], as[4];
      const float* p = Xs + (k0 + tq) * kWld + 16 * mt + g;
      split(p[0], ab[0], as[0]);          // (row g,     k tq)
      split(p[8], ab[1], as[1]);          // (row g + 8, k tq)
      split(p[4 * kWld], ab[2], as[2]);   // (row g,     k tq + 4)
      split(p[4 * kWld + 8], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bb[2], bs[2];
        const float* q = Ys + (k0 + tq) * kWld + 32 * nh + 8 * j + g;
        split(q[0], bb[0], bs[0]);
        split(q[4 * kWld], bb[1], bs[1]);
        mma3(acc[j], ab, as, bb, bs);
      }
    }
  }
  float* out = part + (size_t)blockIdx.z * Dx * N;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i0 + 16 * mt + g + (i >= 2 ? 8 : 0);
      const int col = n0 + 32 * nh + 8 * j + 2 * tq + (i & 1);
      if (row < Dx && col < N) out[(size_t)row * N + col] = acc[j][i];
    }
}

template <int A>
int launch_bwd(const float* vis, const float* arg, const float* wv, const float* wl,
               const float* wx, const float* w1, const float* b1, const float* w2,
               const float* gin, float* h, float* dz0, float* dz1, float* dvis,
               float* dwv, float* darg_part, float* dwl_part, float* db1_part,
               float* dw2_part, float* dwx_part, float* dw1_part, int B, int T,
               int D, int Dh, int chunks, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)A * kBT * (D + 4);
  cudaError_t e = cudaFuncSetAttribute(
      head_bwd_rows<A>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + kBT - 1) / kBT, B);
  head_bwd_rows<A><<<grid, kThreads, smem, stream>>>(
      vis, arg, wv, wl, wx, w1, b1, w2, gin, h, dz0, dz1, dvis, dwv, darg_part,
      dwl_part, db1_part, dw2_part, T, D, Dh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int R = B * A * T;
  const int per = ((R + chunks - 1) / chunks + kWK - 1) / kWK * kWK;
  dim3 gx((D + kWT - 1) / kWT, (D + kWT - 1) / kWT, chunks);
  head_bwd_w<<<gx, 256, 0, stream>>>(vis, arg, nullptr, dz0, dwx_part, A, T, D, D, R, per);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 g1((Dh + kWT - 1) / kWT, (D + kWT - 1) / kWT, chunks);
  head_bwd_w<<<g1, 256, 0, stream>>>(vis, arg, h, dz1, dw1_part, A, T, D, Dh, R, per);
  return (int)cudaGetLastError();
}

}  // namespace

// chunks: the row split of the weight-gradient kernel (dwx_part holds
// chunks x D x D, dw1_part chunks x D x Dh); darg/dwl partials hold
// B x ceil(T/16) x A x D, db1/dw2 partials B x ceil(T/16) x Dh.
extern "C" int vog_head_bwd(const float* vis, const float* arg, const float* wv,
                            const float* wl, const float* wx, const float* w1,
                            const float* b1, const float* w2, const float* gin,
                            float* h, float* dz0, float* dz1, float* dvis,
                            float* dwv, float* darg_part, float* dwl_part,
                            float* db1_part, float* dw2_part, float* dwx_part,
                            float* dw1_part, int B, int A, int T, int D, int Dh,
                            int chunks, void* stream) {
  if (D < 32 || D > kMaxD || D % 32 != 0 || Dh < 16 || Dh > kMaxDh || Dh % 16 != 0 ||
      chunks < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VOG_HEAD_BWD_CASE(n)                                                        \
  case n:                                                                           \
    return launch_bwd<n>(vis, arg, wv, wl, wx, w1, b1, w2, gin, h, dz0, dz1, dvis, \
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
  if (D < 32 || D > kMaxD || D % 32 != 0 || Dh < 16 || Dh > kMaxDh || Dh % 16 != 0)
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
