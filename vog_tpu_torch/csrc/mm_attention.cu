// Shared-QK multi-arg attention forward (VOGNet's decomposed first
// multimodal layer), fp32.  For every arg a:
//
//   o[b,h,a,i] = softmax_j( s_ij + cn[b,h,a,j] ) . vm,
//   s_ij = qm_i.km_j + fb[h, fid_i, fid_j], key-masked to -1e30
//
// with qm pre-scaled by the caller.  Also writes the per-arg row max and
// denominator (B,H,A,T) that a backward pass needs.
//
// Replaces vog_tpu/kernels/mm_attention.py §_fwd (_fwd_kernel), which
// stacks the A probability tiles into one (A*bq, bk) MXU matmul and keeps
// cn transposed as (BH, T, A) because Mosaic cannot reshape lanes into
// sublanes.  Here cn keeps its natural (B,H,A,T) layout.  At GT5 (T=200,
// dh=128, A=5, B=16) the work is ~0.66 GFLOP for the shared scores and
// ~3.3 GFLOP for the A value products, bound by fp32 operations.  Design:
// as csrc/attention.cu, a warp owns two query rows and lane j scores key j
// of a 32-key tile ONCE for all args; then per arg a running max and
// denominator (every final denominator is >= 1, no epsilon) and an
// A x dh accumulator, 4 adjacent columns a lane; the probabilities go
// through shared memory so the P.V loop reads them and V as float4.  The (T,T) scores and
// the A value streams never reach device memory.
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

namespace {

constexpr int kWarps = 8;
constexpr int kQPW = 2;  // query rows per warp
constexpr int kBQ = kWarps * kQPW;
constexpr int kBK = 32;
constexpr int kMaxDh = 128;
constexpr int kC = kMaxDh / 32;  // output columns per lane (4*lane + c)
constexpr float kNeg = -1e30f;

// Shared-memory row strides, as in csrc/attention.cu: dq = dh rounded up to
// 4 for Q and V, dk = dq + 4 for K (conflict-free float4 reads of K rows).
__host__ __device__ inline int stride_q(int dh) { return (dh + 3) / 4 * 4; }
__host__ __device__ inline int stride_k(int dh) { return stride_q(dh) + 4; }
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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

template <int A>
__global__ void __launch_bounds__(kWarps * 32)
mm_fwd(const float* __restrict__ qm, const float* __restrict__ km,
       const float* __restrict__ vm, const float* __restrict__ cn,
       const float* __restrict__ key_mask, const float* __restrict__ fb,
       const int* __restrict__ fid, float* __restrict__ o,
       float* __restrict__ mrow, float* __restrict__ den, int H, int T,
       int dh, int F, bool vec) {
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int dq = stride_q(dh), dk = stride_k(dh), n4 = dq / 4;

  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // kBK x dk
  float* Vs = Ks + kBK * dk;                     // kBK x dq
  float* Qs = Vs + kBK * dq;                     // kBQ x dq
  float* Ps = Qs + kBQ * dq;                     // kWarps x kQPW x A x kBK
  float* Cs = Ps + kBQ * A * kBK;                // A x kBK
  float* fbs = Cs + A * kBK;                     // F x F
  float* mks = fbs + F * F;                      // kBK
  int* fks = reinterpret_cast<int*>(mks + kBK);
  float* pw = Ps + warp * kQPW * A * kBK;  // this warp's probabilities

  const size_t base = (size_t)bh * T * dh;
  for (int idx = tid; idx < F * F; idx += blockDim.x)
    fbs[idx] = fb[(size_t)h * F * F + idx];
  stage_rows(Qs, dq, qm + base, q0, kBQ, T, dh, vec);

  float m[kQPW][A], l[kQPW][A], acc[kQPW][A][kC];
  int fq[kQPW];
#pragma unroll
  for (int qq = 0; qq < kQPW; ++qq) {
    const int qi = q0 + warp * kQPW + qq;
    fq[qq] = qi < T ? fid[qi] : 0;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      m[qq][a] = kNeg;
      l[qq][a] = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[qq][a][c] = 0.f;
    }
  }
  const float4* q4 = reinterpret_cast<const float4*>(Qs + warp * kQPW * dq);

  for (int k0 = 0; k0 < T; k0 += kBK) {
    __syncthreads();
    stage_rows(Ks, dk, km + base, k0, kBK, T, dh, vec);
    stage_rows(Vs, dq, vm + base, k0, kBK, T, dh, vec);
    for (int idx = tid; idx < A * kBK; idx += blockDim.x) {
      const int a = idx / kBK, j = idx % kBK, kj = k0 + j;
      Cs[idx] = kj < T ? cn[((size_t)bh * A + a) * T + kj] : 0.f;
    }
    if (tid < kBK) {
      const int kj = k0 + tid;
      mks[tid] = kj < T ? key_mask[(size_t)b * T + kj] : 0.f;
      fks[tid] = kj < T ? fid[kj] : 0;
    }
    __syncthreads();

    const int nk = min(kBK, T - k0);
    const bool key_ok = lane < nk;
    // lane j scores key j once for all args, for the warp's kQPW rows
    float s[kQPW];
#pragma unroll
    for (int qq = 0; qq < kQPW; ++qq) s[qq] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(Ks + lane * dk);
    for (int d4 = 0; d4 < n4; ++d4) {
      const float4 kv = k4[d4];
#pragma unroll
      for (int qq = 0; qq < kQPW; ++qq) {
        const float4 qv = q4[qq * n4 + d4];
        s[qq] = fmaf(qv.x, kv.x, s[qq]);
        s[qq] = fmaf(qv.y, kv.y, s[qq]);
        s[qq] = fmaf(qv.z, kv.z, s[qq]);
        s[qq] = fmaf(qv.w, kv.w, s[qq]);
      }
    }

#pragma unroll
    for (int qq = 0; qq < kQPW; ++qq) {
      const float sq = mks[lane] > 0.f ? s[qq] + fbs[fq[qq] * F + fks[lane]] : kNeg;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const float t = key_ok ? sq + Cs[a * kBK + lane] : -INFINITY;
        float tmax = t;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
        const float m_new = fmaxf(m[qq][a], tmax);
        const float alpha = expf(m[qq][a] - m_new);
        const float p = key_ok ? expf(t - m_new) : 0.f;
        float psum = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        l[qq][a] = l[qq][a] * alpha + psum;
        m[qq][a] = m_new;
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[qq][a][c] *= alpha;
        pw[(qq * A + a) * kBK + lane] = p;
      }
    }
    __syncwarp();
    // P.V for all args: lane owns columns 4*lane..4*lane+3; V rows and p
    // come as float4 (keys past T have p = 0 and zero V rows)
    for (int j4 = 0; j4 < nk; j4 += 4) {
      float4 vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        vv[i] = 4 * lane < dq ? reinterpret_cast<const float4*>(Vs + (j4 + i) * dq)[lane]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int qq = 0; qq < kQPW; ++qq)
#pragma unroll
        for (int a = 0; a < A; ++a) {
          const float4 pp = reinterpret_cast<const float4*>(pw + (qq * A + a) * kBK)[j4 / 4];
          const float pj[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[qq][a][0] = fmaf(pj[i], vv[i].x, acc[qq][a][0]);
            acc[qq][a][1] = fmaf(pj[i], vv[i].y, acc[qq][a][1]);
            acc[qq][a][2] = fmaf(pj[i], vv[i].z, acc[qq][a][2]);
            acc[qq][a][3] = fmaf(pj[i], vv[i].w, acc[qq][a][3]);
          }
        }
    }
    __syncwarp();  // pw is rewritten by the next tile
  }

#pragma unroll
  for (int qq = 0; qq < kQPW; ++qq) {
    const int qi = q0 + warp * kQPW + qq;
    if (qi >= T) continue;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const float inv = 1.f / l[qq][a];  // >= 1 by construction
      const size_t row = ((size_t)bh * A + a) * T + qi;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int d = 4 * lane + c;
        if (d < dh) o[row * dh + d] = acc[qq][a][c] * inv;
      }
      if (lane == 0) {
        mrow[row] = m[qq][a];
        den[row] = l[qq][a];
      }
    }
  }
}

template <int A>
int launch(const float* qm, const float* km, const float* vm, const float* cn,
           const float* key_mask, const float* fb, const int* fid, float* o,
           float* mrow, float* den, int B, int H, int T, int dh, int F,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kBK * stride_k(dh) +
                                       kBK * stride_q(dh) + kBQ * stride_q(dh) +
                                       kBQ * A * kBK + A * kBK + F * F + kBK) +
                      sizeof(int) * kBK;
  cudaError_t e = cudaFuncSetAttribute(
      mm_fwd<A>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec = dh % 4 == 0 && aligned16(qm) && aligned16(km) && aligned16(vm);
  dim3 grid((T + kBQ - 1) / kBQ, B * H);
  mm_fwd<A><<<grid, kWarps * 32, smem, stream>>>(
      qm, km, vm, cn, key_mask, fb, fid, o, mrow, den, H, T, dh, F, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward (emit mode)
// ---------------------------------------------------------------------------
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
