// Shared-QK multi-arg attention (VOGNet's decomposed first multimodal
// layer), fp32, forward and backward.  For every arg a:
//
//   o[b,h,a,i] = softmax_j( s_ij + cn[b,h,a,j] ) . vm,
//   s_ij = qm_i.km_j + fb[h, fid_i, fid_j], key-masked to -1e30
//
// with qm pre-scaled by the caller.  The forward also writes the per-arg
// row max m_a (over the keys < T of s + cn_a) and denominator den_a =
// sum_j exp(s + cn_a - m_a) >= 1, (B,H,A,T), which the backward reads.
//
// Forward: replaces vog_tpu/kernels/mm_attention.py §_fwd (_fwd_kernel),
// which stacks the A probability tiles into one (A*bq, bk) MXU matmul and
// keeps cn transposed as (BH, T, A) because Mosaic cannot reshape lanes
// into sublanes.  Here cn keeps its natural (B,H,A,T) layout.  At GT5
// (T=200, dh=128, A=5, B=16) the work is 0.66 GFLOP for the shared scores
// and 3.3 GFLOP for the A value products: bound by operations, on the
// tensor cores in 3xTF32 (tiles.cuh, as csrc/attention.cu's flash_fwd),
// since fp32 FMA alone (67 TFLOP/s) would take 0.059 ms.  Design (mm_fwd):
// a block of 4 warps owns 16 query rows and walks the keys in tiles of 32.
// A tile's work has three parts, each split evenly over the warps:
//  1. S = qm.km^T + fb[h, fid_i, fid_j], computed ONCE for all args: warp
//     w takes keys 8w..8w+7 (mma.sync m16n8k8, 3xTF32, in four
//     accumulator sets), biases and masks them into a shared 16 x 32 tile;
//  2. softmax: warp w takes 4 rows, a lane 4 keys of one row; per arg,
//     t_a = S + cn_a, the row's running max (over 8 lanes) and this lane's
//     part of its sum, the rescale factor, and P_a = exp(t_a - m_a) split
//     for 3xTF32 into a shared tile: every exp and split is done once a
//     block;
//  3. P.V: the A output accumulators of a row (A x 128 floats) do not fit
//     one warp's registers, so warp w owns columns 32w..32w+31 of every
//     arg (80 accumulators a lane at A=5): O_a = O_a alpha_a + P_a V, by
//     k-steps of 8 keys: V's B fragments are split once and serve every
//     arg (A x 4 independent accumulators a k-step), P_a's split A
//     fragments are read as they stand (16-byte reads, keys in the pair
//     order of tiles.cuh).
// The three parts run in turn, a __syncthreads after each (the S and P
// tiles are rewritten by the next tile).  K, V and the tile's cn come in by
// cp.async into a two-stage ring: tile i+1 loads while tile i is computed.
// 107 KB of shared memory at A=5, two blocks (8 warps) an SM.  A first
// version of this design in which every warp repeated the softmax for its
// own columns (P from the C fragments in registers) took 0.21 ms at GT5:
// its four-fold exps and splits, amortised over 32 columns, outweighed the
// products; a version that overlapped P.V of tile i with S of tile i+1
// (two syncs a tile, K loaded a tile ahead of V) measured no faster.
// The previous design (fp32 FMA: a warp two query rows, lane j scoring key
// j, two shuffle reductions a row per arg, float4 P.V loops) took 0.3044 /
// 0.3037 ms at GT5 (chip_smoke.py, H100 80GB HBM3, 700 W); this design's
// times are in PERF.md.
//
// Backward: mm_bwd_dkv, the counterpart of the TPU's dk/dv/dcn kernel in
// its default "emit" mode (vog_tpu/kernels/mm_attention.py
// §_make_bwd_dkv_kernel(True)).  A block owns 32 keys (a warp 4) and walks
// the query rows in tiles of 32, lane i taking query i: it recomputes
// p_a = exp(s + cn_a - m_a) from the saved per-arg row max and
// denominator, ds_a = p_a (g_a.vm - delta_a) / den_a, and accumulates
// dv = sum_a sum_i (p_a/den_a) g_a,i and dk = sum_i comb_i qm_i with
// comb = sum_a ds_a (masked), in registers, and dcn_a = sum_i ds_a per
// lane, reduced by a fixed shuffle tree at the end.  It also writes comb
// (B*H, T, T) through a shared-memory tile, coalesced; dq = comb . km and
// the frame-bias gradient are products over it outside the kernel, as in
// the TPU package.  Bound by fp32 operations (the A g_a.vm products and
// the A dv sums dominate).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tiles.cuh"  // cp.async row tiles, their 3xTF32 fragments

namespace {

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kFwdRows = 16;                    // query rows a block owns
constexpr int kFwdTile = 32;                    // keys a streamed tile (8 a warp in S)
constexpr int kFwdKT = kFwdTile / 8;            // k-steps of P.V over a tile
constexpr int kFwdCols = kMaxDh / kFwdWarps;    // output columns a warp owns in P.V
constexpr int kFwdNT = kFwdCols / 8;            // their 8-wide column tiles
constexpr int kSoftRows = kFwdRows / kFwdWarps;  // rows a warp owns in the softmax
constexpr int kSets = 4;                        // accumulator sets of the S chain
constexpr int kSLd = kFwdTile + 8;              // S tile row stride (conflict-free float2)
// split P tile: per row, per key pair (2k, 2k+1), (big, big, small, small);
// a row stride of 16 (mod 32) words keeps the 16-byte fragment reads
// conflict-free
constexpr int kPLd = 2 * kFwdTile + 16;

template <int A>
__global__ void __launch_bounds__(kFwdThreads, 2)
mm_fwd(const float* __restrict__ qm, const float* __restrict__ km,
       const float* __restrict__ vm, const float* __restrict__ cn,
       const float* __restrict__ key_mask, const float* __restrict__ fb,
       const int* __restrict__ fid, float* __restrict__ o,
       float* __restrict__ mrow, float* __restrict__ den, int H, int T,
       int dh, int F, bool vec) {
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kFwdRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);                  // kFwdRows x kLd
  float* Ks = Qs + kFwdRows * kLd;                               // 2 stages x kFwdTile x kLd
  float* Vs = Ks + 2 * kFwdTile * kLd;                           // 2 stages x kFwdTile x kLd
  float* Ps = Vs + 2 * kFwdTile * kLd;                           // A x kFwdRows x kPLd: split P
  float* Ss = Ps + A * kFwdRows * kPLd;                          // kFwdRows x kSLd: S of a tile
  float* Cs = Ss + kFwdRows * kSLd;                              // 2 stages x A x kFwdTile: cn
  float* Al = Cs + 2 * A * kFwdTile;                             // A x kFwdRows: rescale factors
  float* Ls = Al + A * kFwdRows;                                 // A x kFwdRows: final sums
  int* codes = reinterpret_cast<int*>(Ls + A * kFwdRows);       // 2 stages x kFwdTile
  float* fbs = reinterpret_cast<float*>(codes + 2 * kFwdTile);  // F x F

  const size_t base = (size_t)bh * T * dh;
  const float* kb = km + base;
  const float* vb = vm + base;
  const float* cb = cn + (size_t)bh * A * T;
  auto stage = [&](int s, int j0) {
    load_rows<kFwdTile, kFwdThreads>(Ks + s * kFwdTile * kLd, kb, j0, T, dh, vec);
    load_rows<kFwdTile, kFwdThreads>(Vs + s * kFwdTile * kLd, vb, j0, T, dh, vec);
    for (int i = tid; i < A * kFwdTile; i += kFwdThreads) {  // cn, zero past T
      const int a = i / kFwdTile, j = j0 + i % kFwdTile;
      cp_async4(Cs + s * A * kFwdTile + i, j < T ? cb + (size_t)a * T + j : cb, j < T);
    }
    if (tid < kFwdTile) codes[s * kFwdTile + tid] = key_code<true>(key_mask, fid, b, j0 + tid, T);
    cp_commit();
  };
  for (int i = tid; i < F * F; i += kFwdThreads) fbs[i] = fb[(size_t)h * F * F + i];
  load_rows<kFwdRows, kFwdThreads>(Qs, qm + base, q0, T, dh, vec);
  stage(0, 0);  // one group: Q and the first tile

  // S phase: rows g, g + 8 of the block, keys 8w..8w+7 of a tile
  const int fq0 = q0 + g < T ? fid[q0 + g] : 0, fq1 = q0 + g + 8 < T ? fid[q0 + g + 8] : 0;
  // softmax phase: row sr of the block, keys sk..sk+3 of a tile; the
  // running max of each arg, and this lane's part of its sum
  const int sr = kSoftRows * warp + (lane >> 3), sk = 4 * (lane & 7);
  float m[A], l[A];
  // P.V phase: rows g, g + 8, columns c0..c0+31, every arg
  const int c0 = kFwdCols * warp;
  float acc[A][kFwdNT][4];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    m[a] = kNeg;
    l[a] = 0.f;
    zero(acc[a]);
  }

  const int ntiles = (T + kFwdTile - 1) / kFwdTile;
  for (int it = 0; it < ntiles; ++it) {
    const int s = it & 1;
    cp_wait_all();
    __syncthreads();  // tile it is in; every warp is done with tile it - 1, its S and P
    if (it + 1 < ntiles) stage(s ^ 1, (it + 1) * kFwdTile);
    const float* Kt = Ks + s * kFwdTile * kLd;
    const float* Vt = Vs + s * kFwdTile * kLd;
    const float* Ct = Cs + s * A * kFwdTile;
    const int* ct = codes + s * kFwdTile;

    {  // S = Q K^T for keys 8w..8w+7, once for all args, biased and masked
      float cs[kSets][4];
#pragma unroll
      for (int q = 0; q < kSets; ++q) cs[q][0] = cs[q][1] = cs[q][2] = cs[q][3] = 0.f;
      const float* Kw = Kt + 8 * warp * kLd;
#pragma unroll
      for (int ks = 0; ks < kND; ++ks) {
        uint32_t ab[4], as[4], bb[2], bs[2];
        frag_a(Qs, 8 * ks, g, t, ab, as);
        frag_bt(Kw, 0, 8 * ks, g, t, bb, bs);
        mma3(cs[ks % kSets], ab, as, bb, bs);
      }
      const int j = 8 * warp + 2 * t;
      float x[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = ct[j + e];
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int q = 0; q < kSets; ++q) {
          s0 += cs[q][e];
          s1 += cs[q][2 + e];
        }
        if (c >= 0) {
          x[e] = s0 + fbs[fq0 * F + c];
          x[2 + e] = s1 + fbs[fq1 * F + c];
        } else {
          x[e] = x[2 + e] = c == kMasked ? kNeg : -INFINITY;
        }
      }
      *reinterpret_cast<float2*>(Ss + g * kSLd + j) = make_float2(x[0], x[1]);
      *reinterpret_cast<float2*>(Ss + (g + 8) * kSLd + j) = make_float2(x[2], x[3]);
    }
    __syncthreads();  // the whole S tile is in

    {  // per arg: t_a = S + cn_a, online max and sum, P_a split into the shared tile
      const float4 sv = *reinterpret_cast<const float4*>(Ss + sr * kSLd + sk);
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const float4 cv = *reinterpret_cast<const float4*>(Ct + a * kFwdTile + sk);
        float x[4] = {sv.x + cv.x, sv.y + cv.y, sv.z + cv.z, sv.w + cv.w};
        float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float mn = fmaxf(m[a], mx);
        const float al = expf(m[a] - mn);
        m[a] = mn;
        uint32_t pb[4], ps[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = expf(x[i] - mn);  // keys past T: 0
          split_int(x[i], pb[i], ps[i]);
        }
        l[a] = l[a] * al + ((x[0] + x[1]) + (x[2] + x[3]));
        float4* pr = reinterpret_cast<float4*>(Ps + (a * kFwdRows + sr) * kPLd + 2 * sk);
        pr[0] = make_float4(__uint_as_float(pb[0]), __uint_as_float(pb[1]), __uint_as_float(ps[0]),
                            __uint_as_float(ps[1]));
        pr[1] = make_float4(__uint_as_float(pb[2]), __uint_as_float(pb[3]), __uint_as_float(ps[2]),
                            __uint_as_float(ps[3]));
        if ((lane & 7) == 0) Al[a * kFwdRows + sr] = al;
      }
    }
    __syncthreads();  // every P_a and rescale factor is in

#pragma unroll
    for (int a = 0; a < A; ++a) {  // O_a *= alpha_a
      const float al0 = Al[a * kFwdRows + g], al1 = Al[a * kFwdRows + g + 8];
#pragma unroll
      for (int n = 0; n < kFwdNT; ++n) {
        acc[a][n][0] *= al0;
        acc[a][n][1] *= al0;
        acc[a][n][2] *= al1;
        acc[a][n][3] *= al1;
      }
    }
#pragma unroll
    for (int j = 0; j < kFwdKT; ++j) {  // O_a += P_a V over keys 8j..8j+7, every arg
      uint32_t bb[kFwdNT][2], bs[kFwdNT][2];  // V's split B fragments, shared by the args
#pragma unroll
      for (int n = 0; n < kFwdNT; ++n) frag_b_pairs(Vt + c0, 8 * j, 8 * n, g, t, bb[n], bs[n]);
#pragma unroll
      for (int a = 0; a < A; ++a) {
        // P_a's A fragment in pair order (k = t: key 8j+2t, k = t+4: key
        // 8j+2t+1), as tiles.cuh's a_from_c gives it; keys past T: p = 0
        const float* P0 = Ps + (a * kFwdRows + g) * kPLd + 4 * (4 * j + t);
        const float4 u = *reinterpret_cast<const float4*>(P0);
        const float4 w = *reinterpret_cast<const float4*>(P0 + 8 * kPLd);
        const uint32_t ab[4] = {__float_as_uint(u.x), __float_as_uint(w.x), __float_as_uint(u.y),
                                __float_as_uint(w.y)};
        const uint32_t as[4] = {__float_as_uint(u.z), __float_as_uint(w.z), __float_as_uint(u.w),
                                __float_as_uint(w.w)};
#pragma unroll
        for (int n = 0; n < kFwdNT; ++n) mma3(acc[a][n], ab, as, bb[n], bs[n]);
      }
    }
  }

  // the softmax lanes hold each row's max and their parts of its sum
#pragma unroll
  for (int a = 0; a < A; ++a) {
    float lt = l[a];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt += __shfl_xor_sync(0xffffffffu, lt, 4);  // >= 1 by construction
    if ((lane & 7) == 0) {
      Ls[a * kFwdRows + sr] = lt;
      const size_t row = ((size_t)bh * A + a) * T + q0 + sr;
      if (q0 + sr < T) {
        mrow[row] = m[a];
        den[row] = lt;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const size_t row = ((size_t)bh * A + a) * T;
    store_rows(o + row * dh, acc[a], q0 + g, c0, T, dh, t, 1.f / Ls[a * kFwdRows + g],
               1.f / Ls[a * kFwdRows + g + 8]);
  }
}

template <int A>
int launch(const float* qm, const float* km, const float* vm, const float* cn,
           const float* key_mask, const float* fb, const int* fid, float* o,
           float* mrow, float* den, int B, int H, int T, int dh, int F,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(kFwdRows + 4 * kFwdTile) * kLd +
                                       A * kFwdRows * kPLd + kFwdRows * kSLd +
                                       2 * A * kFwdTile + 2 * A * kFwdRows + F * F) +
                      sizeof(int) * 2 * kFwdTile;
  cudaError_t e = cudaFuncSetAttribute(
      mm_fwd<A>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec = dh % 4 == 0 && aligned16(qm) && aligned16(km) && aligned16(vm);
  dim3 grid((T + kFwdRows - 1) / kFwdRows, B * H);
  mm_fwd<A><<<grid, kFwdThreads, smem, stream>>>(
      qm, km, vm, cn, key_mask, fb, fid, o, mrow, den, H, T, dh, F, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward (emit mode)
// ---------------------------------------------------------------------------
constexpr int kWarps = 8;
constexpr int kC = kMaxDh / 32;  // output columns per lane (4*lane + c)

// Shared-memory row strides of the backward: dq = dh rounded up to 4 for
// Q and V, dk = dq + 4 for K (conflict-free float4 reads of K rows).
__host__ __device__ inline int stride_q(int dh) { return (dh + 3) / 4 * 4; }
__host__ __device__ inline int stride_k(int dh) { return stride_q(dh) + 4; }

// Stage rows [row0, row0 + rows) of a (T, dh) matrix into shared memory
// with row stride ``stride`` (>= dh rounded up to 4), zero-filling rows
// past T and columns past dh.  float4 copies when ``vec`` (dh % 4 == 0 and
// 16-byte aligned pointers), else scalar copies.
__device__ inline void stage_rows(float* __restrict__ dst, int stride,
                                  const float* __restrict__ src, int row0,
                                  int rows, int T, int dh, bool vec) {
  const int dq = (dh + 3) / 4 * 4;
  if (vec) {
    const int n4 = dh / 4;
    for (int idx = threadIdx.x; idx < rows * n4; idx += blockDim.x) {
      const int r = idx / n4, c = idx - r * n4, row = row0 + r;
      const float4 v = row < T
          ? __ldg(reinterpret_cast<const float4*>(src + (size_t)row * dh) + c)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(dst + r * stride)[c] = v;
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * dq; idx += blockDim.x) {
      const int r = idx / dq, d = idx - r * dq, row = row0 + r;
      dst[r * stride + d] = (row < T && d < dh) ? src[(size_t)row * dh + d] : 0.f;
    }
  }
}
constexpr int kKPW = 4;              // keys per warp
constexpr int kBKb = kWarps * kKPW;  // keys per block
constexpr int kBQt = 32;             // query rows per tile (lane i = row i)
constexpr int kCbs = kBQt + 1;       // comb tile row stride (no bank conflicts)

__device__ inline float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int A>
__global__ void __launch_bounds__(kWarps * 32)
mm_bwd_dkv(const float* __restrict__ qm, const float* __restrict__ km,
           const float* __restrict__ vm, const float* __restrict__ cn,
           const float* __restrict__ key_mask, const float* __restrict__ fb,
           const int* __restrict__ fid, const float* __restrict__ gout,
           const float* __restrict__ mrow, const float* __restrict__ den,
           const float* __restrict__ delta, float* __restrict__ dk,
           float* __restrict__ dv, float* __restrict__ dcn,
           float* __restrict__ comb, int H, int T, int dh, int F, bool vec) {
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kBKb;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int dq = stride_q(dh), dk4 = stride_k(dh), n4 = dq / 4;

  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // kBKb x dq (broadcast reads)
  float* Vs = Ks + kBKb * dq;                    // kBKb x dq
  float* Qs = Vs + kBKb * dq;                    // kBQt x dk4 (lane rows)
  float* Gs = Qs + kBQt * dk4;                   // A x kBQt x dk4: g_a rows
  float* Pn = Gs + A * kBQt * dk4;               // kWarps x A x kKPW x kBQt
  float* Cb = Pn + kWarps * A * kKPW * kBQt;     // kBKb x kCbs: comb^T tile
  float* Cs = Cb + kBKb * kCbs;                  // A x kBKb: cn of the keys
  float* St = Cs + A * kBKb;                     // 3 x A x kBQt: m, den, delta
  float* fbs = St + 3 * A * kBQt;                // F x F
  float* mks = fbs + F * F;                      // kBKb
  int* fks = reinterpret_cast<int*>(mks + kBKb); // kBKb
  int* fqs = fks + kBKb;                         // kBQt
  float* pn = Pn + warp * A * kKPW * kBQt;

  const size_t base = (size_t)bh * T * dh;
  for (int idx = tid; idx < F * F; idx += blockDim.x)
    fbs[idx] = fb[(size_t)h * F * F + idx];
  stage_rows(Ks, dq, km + base, k0, kBKb, T, dh, vec);
  stage_rows(Vs, dq, vm + base, k0, kBKb, T, dh, vec);
  for (int idx = tid; idx < A * kBKb; idx += blockDim.x) {
    const int a = idx / kBKb, j = idx % kBKb, kj = k0 + j;
    Cs[idx] = kj < T ? cn[((size_t)bh * A + a) * T + kj] : 0.f;
  }
  if (tid < kBKb) {
    const int kj = k0 + tid;
    mks[tid] = kj < T ? key_mask[(size_t)b * T + kj] : 0.f;
    fks[tid] = kj < T ? fid[kj] : 0;
  }

  float adk[kKPW][kC], adv[kKPW][kC], dc[kKPW][A];
#pragma unroll
  for (int kk = 0; kk < kKPW; ++kk) {
#pragma unroll
    for (int c = 0; c < kC; ++c) adk[kk][c] = adv[kk][c] = 0.f;
#pragma unroll
    for (int a = 0; a < A; ++a) dc[kk][a] = 0.f;
  }

  for (int q0 = 0; q0 < T; q0 += kBQt) {
    __syncthreads();  // the previous tile is consumed (and the keys staged)
    stage_rows(Qs, dk4, qm + base, q0, kBQt, T, dh, vec);
    for (int a = 0; a < A; ++a)
      stage_rows(Gs + a * kBQt * dk4, dk4, gout + ((size_t)bh * A + a) * T * dh, q0,
                 kBQt, T, dh, vec);
    for (int idx = tid; idx < A * kBQt; idx += blockDim.x) {
      const int a = idx / kBQt, r = idx % kBQt, qi = q0 + r;
      const size_t row = ((size_t)bh * A + a) * T + qi;
      St[idx] = qi < T ? mrow[row] : 0.f;
      St[A * kBQt + idx] = qi < T ? den[row] : 1.f;
      St[2 * A * kBQt + idx] = qi < T ? delta[row] : 0.f;
    }
    if (tid < kBQt) fqs[tid] = q0 + tid < T ? fid[q0 + tid] : 0;
    __syncthreads();

    const bool row_ok = q0 + lane < T;
    float s[kKPW], gv[A][kKPW];
#pragma unroll
    for (int kk = 0; kk < kKPW; ++kk) {
      s[kk] = 0.f;
#pragma unroll
      for (int a = 0; a < A; ++a) gv[a][kk] = 0.f;
    }
    const float4* q4 = reinterpret_cast<const float4*>(Qs + lane * dk4);
    for (int d4 = 0; d4 < n4; ++d4) {
      const float4 qv = q4[d4];
      float4 kv[kKPW], vv[kKPW];
#pragma unroll
      for (int kk = 0; kk < kKPW; ++kk) {
        const int kl = warp * kKPW + kk;
        kv[kk] = reinterpret_cast<const float4*>(Ks + kl * dq)[d4];
        vv[kk] = reinterpret_cast<const float4*>(Vs + kl * dq)[d4];
        s[kk] = dot4(qv, kv[kk], s[kk]);
      }
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const float4 gq = reinterpret_cast<const float4*>(Gs + (a * kBQt + lane) * dk4)[d4];
#pragma unroll
        for (int kk = 0; kk < kKPW; ++kk) gv[a][kk] = dot4(gq, vv[kk], gv[a][kk]);
      }
    }
    const int fq = fqs[lane];
#pragma unroll
    for (int kk = 0; kk < kKPW; ++kk) {
      const int kl = warp * kKPW + kk;
      const bool ok = row_ok && k0 + kl < T;
      const bool valid = mks[kl] > 0.f;
      const float sv = valid ? s[kk] + fbs[fq * F + fks[kl]] : kNeg;
      float cb = 0.f;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const float inv = 1.f / St[A * kBQt + a * kBQt + lane];  // den >= 1
        const float p = ok ? expf(sv + Cs[a * kBKb + kl] - St[a * kBQt + lane]) : 0.f;
        const float ds = p * ((gv[a][kk] - St[2 * A * kBQt + a * kBQt + lane]) * inv);
        cb += ds;
        dc[kk][a] += ds;
        pn[(a * kKPW + kk) * kBQt + lane] = p * inv;
      }
      Cb[kl * kCbs + lane] = valid ? cb : 0.f;
    }
    __syncwarp();
    // dv += sum_a (p_a/den_a)^T g_a, dk += comb^T qm; lane owns 4 columns
    if (4 * lane < dq) {
      for (int i = 0; i < kBQt; ++i) {
        const float4 qv = reinterpret_cast<const float4*>(Qs + i * dk4)[lane];
#pragma unroll
        for (int kk = 0; kk < kKPW; ++kk) {
          const float c = Cb[(warp * kKPW + kk) * kCbs + i];
          adk[kk][0] = fmaf(c, qv.x, adk[kk][0]);
          adk[kk][1] = fmaf(c, qv.y, adk[kk][1]);
          adk[kk][2] = fmaf(c, qv.z, adk[kk][2]);
          adk[kk][3] = fmaf(c, qv.w, adk[kk][3]);
        }
#pragma unroll
        for (int a = 0; a < A; ++a) {
          const float4 gq = reinterpret_cast<const float4*>(Gs + (a * kBQt + i) * dk4)[lane];
#pragma unroll
          for (int kk = 0; kk < kKPW; ++kk) {
            const float p = pn[(a * kKPW + kk) * kBQt + i];
            adv[kk][0] = fmaf(p, gq.x, adv[kk][0]);
            adv[kk][1] = fmaf(p, gq.y, adv[kk][1]);
            adv[kk][2] = fmaf(p, gq.z, adv[kk][2]);
            adv[kk][3] = fmaf(p, gq.w, adv[kk][3]);
          }
        }
      }
    }
    __syncthreads();  // the whole comb tile is in shared memory
    // emit comb[bh, q0 + r, k0 + j], keys fastest (coalesced)
    for (int idx = tid; idx < kBQt * kBKb; idx += blockDim.x) {
      const int r = idx / kBKb, j = idx % kBKb;
      if (q0 + r < T && k0 + j < T)
        comb[((size_t)bh * T + q0 + r) * T + k0 + j] = Cb[j * kCbs + r];
    }
  }

#pragma unroll
  for (int kk = 0; kk < kKPW; ++kk) {
    const int kj = k0 + warp * kKPW + kk;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      float d = dc[kk][a];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
      if (lane == 0 && kj < T) dcn[((size_t)bh * A + a) * T + kj] = d;
    }
    if (kj >= T) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = 4 * lane + c;
      if (d < dh) {
        dk[base + (size_t)kj * dh + d] = adk[kk][c];
        dv[base + (size_t)kj * dh + d] = adv[kk][c];
      }
    }
  }
}

template <int A>
int launch_bwd(const float* qm, const float* km, const float* vm, const float* cn,
               const float* key_mask, const float* fb, const int* fid,
               const float* gout, const float* mrow, const float* den,
               const float* delta, float* dk, float* dv, float* dcn,
               float* comb, int B, int H, int T, int dh, int F,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * kBKb * stride_q(dh) +
                                       (1 + A) * kBQt * stride_k(dh) +
                                       kWarps * A * kKPW * kBQt + kBKb * kCbs +
                                       A * kBKb + 3 * A * kBQt + F * F + kBKb) +
                      sizeof(int) * (kBKb + kBQt);
  cudaError_t e = cudaFuncSetAttribute(
      mm_bwd_dkv<A>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec = dh % 4 == 0 && aligned16(qm) && aligned16(km) && aligned16(vm) &&
                   aligned16(gout);
  dim3 grid((T + kBKb - 1) / kBKb, B * H);
  mm_bwd_dkv<A><<<grid, kWarps * 32, smem, stream>>>(
      qm, km, vm, cn, key_mask, fb, fid, gout, mrow, den, delta, dk, dv, dcn,
      comb, H, T, dh, F, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vog_mm_bwd(const float* qm, const float* km, const float* vm,
                          const float* cn, const float* key_mask,
                          const float* fb, const int* fid, const float* gout,
                          const float* mrow, const float* den,
                          const float* delta, float* dk, float* dv, float* dcn,
                          float* comb, int B, int H, int A, int T, int dh,
                          int F, void* stream) {
  if (dh > kMaxDh || dh < 1) return (int)cudaErrorInvalidValue;
  if (B * H == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VOG_MM_BWD_CASE(n)                                                    \
  case n:                                                                     \
    return launch_bwd<n>(qm, km, vm, cn, key_mask, fb, fid, gout, mrow, den, \
                         delta, dk, dv, dcn, comb, B, H, T, dh, F, s);
  switch (A) {
    VOG_MM_BWD_CASE(1)
    VOG_MM_BWD_CASE(2)
    VOG_MM_BWD_CASE(3)
    VOG_MM_BWD_CASE(4)
    VOG_MM_BWD_CASE(5)
    VOG_MM_BWD_CASE(6)
    VOG_MM_BWD_CASE(7)
    VOG_MM_BWD_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VOG_MM_BWD_CASE
}

extern "C" int vog_mm_fwd(const float* qm, const float* km, const float* vm,
                          const float* cn, const float* key_mask,
                          const float* fb, const int* fid, float* o,
                          float* mrow, float* den, int B, int H, int A, int T,
                          int dh, int F, void* stream) {
  if (dh > kMaxDh || dh < 1) return (int)cudaErrorInvalidValue;
  if (B * H == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VOG_MM_CASE(n) \
  case n:              \
    return launch<n>(qm, km, vm, cn, key_mask, fb, fid, o, mrow, den, B, H, T, dh, F, s);
  switch (A) {
    VOG_MM_CASE(1)
    VOG_MM_CASE(2)
    VOG_MM_CASE(3)
    VOG_MM_CASE(4)
    VOG_MM_CASE(5)
    VOG_MM_CASE(6)
    VOG_MM_CASE(7)
    VOG_MM_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VOG_MM_CASE
}
