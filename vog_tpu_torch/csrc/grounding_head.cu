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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kBT = 16;  // tokens per block: rows M = A * kBT, A m-tiles
constexpr int kMaxA = 5;
constexpr int kMaxD = 512;
constexpr int kMaxDh = 256;
constexpr int kN1 = 32;  // first-product columns per warp (4 n-tiles)
constexpr int kN2 = 16;  // second-product columns per warp (2 n-tiles)

__device__ inline uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ inline void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
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

// A fragment of the 16x8 tile at (r0, k0) of a row-major shared matrix
__device__ inline void load_a(const float* X, int ld, int r0, int k0, int lane,
                              uint32_t (&big)[4], uint32_t (&small)[4]) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = X + (r0 + g) * ld + k0 + t;
  split(p[0], big[0], small[0]);
  split(p[8 * ld], big[1], small[1]);
  split(p[4], big[2], small[2]);
  split(p[8 * ld + 4], big[3], small[3]);
}

// raw B fragment of the 8x8 tile at (k0, n0) of a row-major global matrix
__device__ inline void load_b(const float* __restrict__ W, int ld, int k0, int n0, int lane,
                              float (&v)[2]) {
  const int g = lane >> 2, t = lane & 3;
  v[0] = __ldg(W + (size_t)(k0 + t) * ld + n0 + g);
  v[1] = __ldg(W + (size_t)(k0 + t + 4) * ld + n0 + g);
}

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

}  // namespace

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
