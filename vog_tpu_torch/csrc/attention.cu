// Flash attention forward with a factored relative-frame bias, fp32.
//
//   o[b,h,i]  = softmax_j( q_i.k_j * scale + fb[h, fid_i, fid_j] ; key-masked ) . v
//   lse[b,h,i] = log-sum-exp of the same row
//
// Replaces vog_tpu/kernels/attention.py §_fwd_call (_fwd_kernel, _bias_block):
// the TPU kernel keeps the whole key axis of a 128-row q block in VMEM and
// needs no rescaling; it builds the bias tile with a one-hot matmul that
// exists for Mosaic.  On the H100 a block has at most 227 KB of shared
// memory, so this kernel runs an ONLINE softmax over 32-key tiles and reads
// the bias straight from the (F, F) table of its head, staged in shared
// memory, at fb[fid_i, fid_j].  At GT5 (T=200, dh=128) the work is ~1.3
// GFLOP for B=16, bound by fp32 operations (no tensor cores: TF32 would
// miss the 1e-4 parity bound).  Design: a warp owns four query rows (32 a
// block); lane j scores key j of the tile against all four with float4
// reads of shared memory, the warp reduces max and sum with shuffles and
// parks the probabilities in shared memory; in the P.V product each lane
// owns 4 adjacent output columns and reads V rows and probabilities as
// float4, each V element once for the four rows.  K rows are padded by four floats so the
// lanes' float4 reads hit distinct banks.  Masked keys
// take the finite -1e30 of the TPU kernel, so a row with every key masked
// stays finite; keys past T are excluded.
//
// Backward (recompute mode, as vog_tpu/kernels/attention.py §_flash_bwd with
// bwd_mode="recompute": the (T, T) score gradient never reaches device
// memory), two kernels:
//
//   flash_bwd_dkv  a block owns 32 keys (a warp 4) and walks the query rows
//                  in tiles of 32, lane i taking query i of the tile: it
//                  recomputes p = exp(s - lse) and ds = p (do.v - delta)
//                  and accumulates dv = sum_i p do_i and dk = scale sum_i
//                  ds q_i in registers, 4 adjacent columns a lane;
//   flash_bwd_dq   a block owns 32 query rows (a warp 4), as the forward,
//                  walks the key tiles and accumulates dq = scale sum_j ds
//                  k_j; it also sums ds by (query frame, key frame) in a
//                  fixed order (a lane per key frame, then per row) into
//                  one (F, F) partial per block, which the wrapper adds up
//                  in a fixed order: the frame-bias gradient is the same
//                  on every run (no float atomics).
//
// Bound by fp32 operations at GT5 (about 14 BH T^2 dh).  A batch row whose
// keys are all masked has lse = -1e30 + log T = -1e30 in fp32, so p is
// taken as 1/T there (the softmax of equal scores), which is what
// autograd of the plain forward gives; its ds is masked to 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kQPW = 4;  // query rows per warp
constexpr int kBQ = kWarps * kQPW;
constexpr int kBK = 32;
constexpr int kMaxDh = 128;
constexpr int kC = kMaxDh / 32;  // output columns per lane (4*lane + c)
constexpr float kNeg = -1e30f;

// Shared-memory row strides: dq = dh rounded up to 4 (zero padded) for Q
// and V, dk = dq + 4 for K, so that lane j's float4 reads of K row j fall
// in distinct banks.
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

__global__ void __launch_bounds__(kWarps * 32)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ key_mask,
          const float* __restrict__ fb, const int* __restrict__ fid,
          float* __restrict__ o, float* __restrict__ lse, int H, int T,
          int dh, int F, float scale, bool vec) {
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int dq = stride_q(dh), dk = stride_k(dh), n4 = dq / 4;

  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // kBK x dk
  float* Vs = Ks + kBK * dk;                     // kBK x dq
  float* Qs = Vs + kBK * dq;                     // kBQ x dq
  float* Ps = Qs + kBQ * dq;                     // kWarps x kQPW x kBK
  float* fbs = Ps + kBQ * kBK;                   // F x F
  float* mks = fbs + F * F;                      // kBK
  int* fks = reinterpret_cast<int*>(mks + kBK);  // kBK
  float* pw = Ps + warp * kQPW * kBK;  // this warp's probabilities

  const size_t base = (size_t)bh * T * dh;
  for (int idx = tid; idx < F * F; idx += blockDim.x)
    fbs[idx] = fb[(size_t)h * F * F + idx];
  stage_rows(Qs, dq, q + base, q0, kBQ, T, dh, vec);

  float m[kQPW], l[kQPW], acc[kQPW][kC];
  int fq[kQPW];
#pragma unroll
  for (int qq = 0; qq < kQPW; ++qq) {
    const int qi = q0 + warp * kQPW + qq;
    m[qq] = kNeg;
    l[qq] = 0.f;
    fq[qq] = qi < T ? fid[qi] : 0;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[qq][c] = 0.f;
  }
  const float4* q4 = reinterpret_cast<const float4*>(Qs + warp * kQPW * dq);

  for (int k0 = 0; k0 < T; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and Q/fb are staged)
    stage_rows(Ks, dk, k + base, k0, kBK, T, dh, vec);
    stage_rows(Vs, dq, v + base, k0, kBK, T, dh, vec);
    if (tid < kBK) {
      const int kj = k0 + tid;
      mks[tid] = kj < T ? key_mask[(size_t)b * T + kj] : 0.f;
      fks[tid] = kj < T ? fid[kj] : 0;
    }
    __syncthreads();

    const int nk = min(kBK, T - k0);
    const bool key_ok = lane < nk;
    // lane j scores key j against the warp's kQPW query rows
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
    float p[kQPW];
#pragma unroll
    for (int qq = 0; qq < kQPW; ++qq) {
      float sq = s[qq] * scale;
      sq = mks[lane] > 0.f ? sq + fbs[fq[qq] * F + fks[lane]] : kNeg;
      if (!key_ok) sq = -INFINITY;
      float tmax = sq;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[qq], tmax);
      const float alpha = expf(m[qq] - m_new);
      p[qq] = key_ok ? expf(sq - m_new) : 0.f;
      float psum = p[qq];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[qq] = l[qq] * alpha + psum;
      m[qq] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[qq][c] *= alpha;
      pw[qq * kBK + lane] = p[qq];
    }
    __syncwarp();
    // P.V: lane owns columns 4*lane..4*lane+3; V rows and p come as float4
    // (keys past T have p = 0 and zero V rows)
    for (int j4 = 0; j4 < nk; j4 += 4) {
      float4 vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        vv[i] = 4 * lane < dq ? reinterpret_cast<const float4*>(Vs + (j4 + i) * dq)[lane]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int qq = 0; qq < kQPW; ++qq) {
        const float4 pp = reinterpret_cast<const float4*>(pw + qq * kBK)[j4 / 4];
        const float pj[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[qq][0] = fmaf(pj[i], vv[i].x, acc[qq][0]);
          acc[qq][1] = fmaf(pj[i], vv[i].y, acc[qq][1]);
          acc[qq][2] = fmaf(pj[i], vv[i].z, acc[qq][2]);
          acc[qq][3] = fmaf(pj[i], vv[i].w, acc[qq][3]);
        }
      }
    }
    __syncwarp();  // pw is rewritten by the next tile
  }

#pragma unroll
  for (int qq = 0; qq < kQPW; ++qq) {
    const int qi = q0 + warp * kQPW + qq;
    if (qi >= T) continue;
    const float inv = 1.f / l[qq];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = 4 * lane + c;
      if (d < dh) o[base + (size_t)qi * dh + d] = acc[qq][c] * inv;
    }
    if (lane == 0) lse[(size_t)bh * T + qi] = m[qq] + logf(l[qq]);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
constexpr int kKPW = 4;               // keys per warp (dk/dv kernel)
constexpr int kBKb = kWarps * kKPW;   // keys per block (dk/dv kernel)
constexpr int kBQt = 32;              // query rows per tile (dk/dv kernel)
constexpr int kMaxFb = 64;            // frames the dq kernel's dfb takes

__device__ inline float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// 1 when batch row b has no valid key (every thread of the block agrees)
__device__ inline int all_masked(const float* __restrict__ key_mask, int b, int T) {
  int any = 0;
  for (int j = threadIdx.x; j < T; j += blockDim.x) any |= key_mask[(size_t)b * T + j] > 0.f;
  return !__syncthreads_or(any);
}

__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const float* __restrict__ key_mask, const float* __restrict__ fb,
              const int* __restrict__ fid, float* __restrict__ dk,
              float* __restrict__ dv, int H, int T, int dh, int F, float scale,
              bool vec) {
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kBKb;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int dq = stride_q(dh), dk4 = stride_k(dh), n4 = dq / 4;

  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // kBKb x dq (broadcast reads)
  float* Vs = Ks + kBKb * dq;                    // kBKb x dq
  float* Qs = Vs + kBKb * dq;                    // kBQt x dk4 (lane rows)
  float* Os = Qs + kBQt * dk4;                   // kBQt x dk4: dO rows
  float* Pw = Os + kBQt * dk4;                   // kWarps x kKPW x kBQt
  float* Dw = Pw + kWarps * kKPW * kBQt;         // the same, masked ds
  float* fbs = Dw + kWarps * kKPW * kBQt;        // F x F
  float* mks = fbs + F * F;                      // kBKb
  float* ls = mks + kBKb;                        // kBQt
  float* dls = ls + kBQt;                        // kBQt
  int* fks = reinterpret_cast<int*>(dls + kBQt); // kBKb
  int* fqs = fks + kBKb;                         // kBQt
  float* pw = Pw + warp * kKPW * kBQt;
  float* dw = Dw + warp * kKPW * kBQt;

  const size_t base = (size_t)bh * T * dh;
  for (int idx = tid; idx < F * F; idx += blockDim.x)
    fbs[idx] = fb[(size_t)h * F * F + idx];
  stage_rows(Ks, dq, k + base, k0, kBKb, T, dh, vec);
  stage_rows(Vs, dq, v + base, k0, kBKb, T, dh, vec);
  if (tid < kBKb) {
    const int kj = k0 + tid;
    mks[tid] = kj < T ? key_mask[(size_t)b * T + kj] : 0.f;
    fks[tid] = kj < T ? fid[kj] : 0;
  }
  const int none = all_masked(key_mask, b, T);  // also syncs the staging
  const float p_none = 1.f / (float)T;

  float adk[kKPW][kC], adv[kKPW][kC];
#pragma unroll
  for (int kk = 0; kk < kKPW; ++kk)
#pragma unroll
    for (int c = 0; c < kC; ++c) adk[kk][c] = adv[kk][c] = 0.f;

  for (int q0 = 0; q0 < T; q0 += kBQt) {
    __syncthreads();  // the previous query tile is consumed
    stage_rows(Qs, dk4, q + base, q0, kBQt, T, dh, vec);
    stage_rows(Os, dk4, dout + base, q0, kBQt, T, dh, vec);
    if (tid < kBQt) {
      const int qi = q0 + tid;
      ls[tid] = qi < T ? lse[(size_t)bh * T + qi] : 0.f;
      dls[tid] = qi < T ? delta[(size_t)bh * T + qi] : 0.f;
      fqs[tid] = qi < T ? fid[qi] : 0;
    }
    __syncthreads();

    // lane i: query q0 + i against the warp's kKPW keys
    const bool row_ok = q0 + lane < T;
    float s[kKPW], dp[kKPW];
#pragma unroll
    for (int kk = 0; kk < kKPW; ++kk) s[kk] = dp[kk] = 0.f;
    const float4* q4 = reinterpret_cast<const float4*>(Qs + lane * dk4);
    const float4* o4 = reinterpret_cast<const float4*>(Os + lane * dk4);
    for (int d4 = 0; d4 < n4; ++d4) {
      const float4 qv = q4[d4], ov = o4[d4];
#pragma unroll
      for (int kk = 0; kk < kKPW; ++kk) {
        const int kl = warp * kKPW + kk;
        s[kk] = dot4(qv, reinterpret_cast<const float4*>(Ks + kl * dq)[d4], s[kk]);
        dp[kk] = dot4(ov, reinterpret_cast<const float4*>(Vs + kl * dq)[d4], dp[kk]);
      }
    }
    const float li = ls[lane], di = dls[lane];
    const int fq = fqs[lane];
#pragma unroll
    for (int kk = 0; kk < kKPW; ++kk) {
      const int kl = warp * kKPW + kk;
      const bool ok = row_ok && k0 + kl < T;
      const bool valid = mks[kl] > 0.f;
      const float sc = valid ? s[kk] * scale + fbs[fq * F + fks[kl]] : kNeg;
      const float p = !ok ? 0.f : (none ? p_none : expf(sc - li));
      pw[kk * kBQt + lane] = p;
      dw[kk * kBQt + lane] = valid ? p * (dp[kk] - di) : 0.f;
    }
    __syncwarp();
    // dv += p^T dO, dk += ds^T Q over the tile's rows; lane owns 4 columns
    if (4 * lane < dq) {
      for (int i4 = 0; i4 < kBQt; i4 += 4) {
        float4 ov[4], qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ov[i] = reinterpret_cast<const float4*>(Os + (i4 + i) * dk4)[lane];
          qv[i] = reinterpret_cast<const float4*>(Qs + (i4 + i) * dk4)[lane];
        }
#pragma unroll
        for (int kk = 0; kk < kKPW; ++kk) {
          const float4 pp = reinterpret_cast<const float4*>(pw + kk * kBQt)[i4 / 4];
          const float4 dd = reinterpret_cast<const float4*>(dw + kk * kBQt)[i4 / 4];
          const float pj[4] = {pp.x, pp.y, pp.z, pp.w};
          const float dj[4] = {dd.x, dd.y, dd.z, dd.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            adv[kk][0] = fmaf(pj[i], ov[i].x, adv[kk][0]);
            adv[kk][1] = fmaf(pj[i], ov[i].y, adv[kk][1]);
            adv[kk][2] = fmaf(pj[i], ov[i].z, adv[kk][2]);
            adv[kk][3] = fmaf(pj[i], ov[i].w, adv[kk][3]);
            adk[kk][0] = fmaf(dj[i], qv[i].x, adk[kk][0]);
            adk[kk][1] = fmaf(dj[i], qv[i].y, adk[kk][1]);
            adk[kk][2] = fmaf(dj[i], qv[i].z, adk[kk][2]);
            adk[kk][3] = fmaf(dj[i], qv[i].w, adk[kk][3]);
          }
        }
      }
    }
    __syncwarp();  // pw/dw are rewritten by the next tile
  }

#pragma unroll
  for (int kk = 0; kk < kKPW; ++kk) {
    const int kj = k0 + warp * kKPW + kk;
    if (kj >= T) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = 4 * lane + c;
      if (d < dh) {
        dk[base + (size_t)kj * dh + d] = adk[kk][c] * scale;
        dv[base + (size_t)kj * dh + d] = adv[kk][c];
      }
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const float* __restrict__ key_mask, const float* __restrict__ fb,
             const int* __restrict__ fid, float* __restrict__ dqo,
             float* __restrict__ dfb_part, int H, int T, int dh, int F,
             float scale, bool vec) {
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int dq = stride_q(dh), dk4 = stride_k(dh), n4 = dq / 4;

  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // kBK x dk4 (lane rows)
  float* Vs = Ks + kBK * dk4;                    // kBK x dk4
  float* Qs = Vs + kBK * dk4;                    // kBQ x dq (broadcast reads)
  float* Os = Qs + kBQ * dq;                     // kBQ x dq: dO rows
  float* Dw = Os + kBQ * dq;                     // kWarps x kQPW x kBK
  float* fbs = Dw + kBQ * kBK;                   // F x F
  float* racc = fbs + F * F;                     // kBQ x F frame sums
  float* mks = racc + kBQ * F;                   // kBK
  int* fks = reinterpret_cast<int*>(mks + kBK);  // kBK
  float* dw = Dw + warp * kQPW * kBK;

  const size_t base = (size_t)bh * T * dh;
  for (int idx = tid; idx < F * F; idx += blockDim.x)
    fbs[idx] = fb[(size_t)h * F * F + idx];
  stage_rows(Qs, dq, q + base, q0, kBQ, T, dh, vec);
  stage_rows(Os, dq, dout + base, q0, kBQ, T, dh, vec);

  float acc[kQPW][kC], li[kQPW], di[kQPW], rs[kQPW][2];
  int fq[kQPW];
#pragma unroll
  for (int qq = 0; qq < kQPW; ++qq) {
    const int qi = q0 + warp * kQPW + qq;
    fq[qq] = qi < T ? fid[qi] : 0;
    li[qq] = qi < T ? lse[(size_t)bh * T + qi] : 0.f;
    di[qq] = qi < T ? delta[(size_t)bh * T + qi] : 0.f;
    rs[qq][0] = rs[qq][1] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[qq][c] = 0.f;
  }
  const float4* q4 = reinterpret_cast<const float4*>(Qs + warp * kQPW * dq);
  const float4* o4 = reinterpret_cast<const float4*>(Os + warp * kQPW * dq);

  for (int k0 = 0; k0 < T; k0 += kBK) {
    __syncthreads();
    stage_rows(Ks, dk4, k + base, k0, kBK, T, dh, vec);
    stage_rows(Vs, dk4, v + base, k0, kBK, T, dh, vec);
    if (tid < kBK) {
      const int kj = k0 + tid;
      mks[tid] = kj < T ? key_mask[(size_t)b * T + kj] : 0.f;
      fks[tid] = kj < T ? fid[kj] : -1;
    }
    __syncthreads();

    const int nk = min(kBK, T - k0);
    const bool key_ok = lane < nk;
    float s[kQPW], dp[kQPW];
#pragma unroll
    for (int qq = 0; qq < kQPW; ++qq) s[qq] = dp[qq] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(Ks + lane * dk4);
    const float4* v4 = reinterpret_cast<const float4*>(Vs + lane * dk4);
    for (int d4 = 0; d4 < n4; ++d4) {
      const float4 kv = k4[d4], vv = v4[d4];
#pragma unroll
      for (int qq = 0; qq < kQPW; ++qq) {
        s[qq] = dot4(q4[qq * n4 + d4], kv, s[qq]);
        dp[qq] = dot4(o4[qq * n4 + d4], vv, dp[qq]);
      }
    }
    const bool valid = key_ok && mks[lane] > 0.f;
#pragma unroll
    for (int qq = 0; qq < kQPW; ++qq) {
      const float sc = s[qq] * scale + fbs[fq[qq] * F + (key_ok ? fks[lane] : 0)];
      // masked keys (and every key of an all-masked row) give ds = 0
      dw[qq * kBK + lane] = valid ? expf(sc - li[qq]) * (dp[qq] - di[qq]) : 0.f;
    }
    __syncwarp();
    // dq += ds . K; lane owns 4 columns (keys past T have ds = 0, zero rows)
    if (4 * lane < dq) {
      for (int j4 = 0; j4 < nk; j4 += 4) {
        float4 kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          kv[i] = reinterpret_cast<const float4*>(Ks + (j4 + i) * dk4)[lane];
#pragma unroll
        for (int qq = 0; qq < kQPW; ++qq) {
          const float4 dd = reinterpret_cast<const float4*>(dw + qq * kBK)[j4 / 4];
          const float dj[4] = {dd.x, dd.y, dd.z, dd.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[qq][0] = fmaf(dj[i], kv[i].x, acc[qq][0]);
            acc[qq][1] = fmaf(dj[i], kv[i].y, acc[qq][1]);
            acc[qq][2] = fmaf(dj[i], kv[i].z, acc[qq][2]);
            acc[qq][3] = fmaf(dj[i], kv[i].w, acc[qq][3]);
          }
        }
      }
    }
    // frame sums: lane g owns key frames g and g + 32, keys in order
    for (int j = 0; j < nk; ++j) {
      const int fk = fks[j];
#pragma unroll
      for (int qq = 0; qq < kQPW; ++qq) {
        const float d = dw[qq * kBK + j];
        if (fk == lane) rs[qq][0] += d;
        if (fk == lane + 32) rs[qq][1] += d;
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int qq = 0; qq < kQPW; ++qq) {
    const int r = warp * kQPW + qq, qi = q0 + r;
    if (lane < F) racc[r * F + lane] = rs[qq][0];
    if (lane + 32 < F) racc[r * F + lane + 32] = rs[qq][1];
    if (qi >= T) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = 4 * lane + c;
      if (d < dh) dqo[base + (size_t)qi * dh + d] = acc[qq][c] * scale;
    }
  }
  __syncthreads();
  // this block's (F, F) partial: rows in order, those of query frame f
  float* part = dfb_part + ((size_t)bh * gridDim.x + blockIdx.x) * F * F;
  for (int cell = tid; cell < F * F; cell += blockDim.x) {
    const int f = cell / F, g = cell - f * F;
    float sum = 0.f;
    for (int r = 0; r < kBQ && q0 + r < T; ++r)
      if (fid[q0 + r] == f) sum += racc[r * F + g];
    part[cell] = sum;
  }
}

}  // namespace

extern "C" int vog_flash_bwd(const float* q, const float* k, const float* v,
                             const float* dout, const float* lse,
                             const float* delta, const float* key_mask,
                             const float* fb, const int* fid, float* dq,
                             float* dk, float* dv, float* dfb_part, int B,
                             int H, int T, int dh, int F, float scale,
                             void* stream) {
  if (dh > kMaxDh || dh < 1 || F < 1 || F > kMaxFb) return (int)cudaErrorInvalidValue;
  if (B * H == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = dh % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(dout);
  const int dqs = stride_q(dh), dks = stride_k(dh);
  const size_t smem_kv = sizeof(float) * ((size_t)2 * kBKb * dqs + 2 * kBQt * dks +
                                          2 * kWarps * kKPW * kBQt + F * F + kBKb +
                                          2 * kBQt) +
                         sizeof(int) * (kBKb + kBQt);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  dim3 grid_kv((T + kBKb - 1) / kBKb, B * H);
  flash_bwd_dkv<<<grid_kv, kWarps * 32, smem_kv, s>>>(
      q, k, v, dout, lse, delta, key_mask, fb, fid, dk, dv, H, T, dh, F, scale, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem_q = sizeof(float) * ((size_t)2 * kBK * dks + 2 * kBQ * dqs +
                                         kBQ * kBK + F * F + kBQ * F + kBK) +
                        sizeof(int) * kBK;
  e = cudaFuncSetAttribute(flash_bwd_dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  dim3 grid_q((T + kBQ - 1) / kBQ, B * H);
  flash_bwd_dq<<<grid_q, kWarps * 32, smem_q, s>>>(
      q, k, v, dout, lse, delta, key_mask, fb, fid, dq, dfb_part, H, T, dh, F, scale, vec);
  return (int)cudaGetLastError();
}

extern "C" int vog_flash_fwd(const float* q, const float* k, const float* v,
                             const float* key_mask, const float* fb,
                             const int* fid, float* o, float* lse, int B,
                             int H, int T, int dh, int F, float scale,
                             void* stream) {
  if (dh > kMaxDh || dh < 1) return (int)cudaErrorInvalidValue;
  if (B * H == 0 || T == 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)kBK * stride_k(dh) +
                                       kBK * stride_q(dh) +
                                       kBQ * stride_q(dh) + kBQ * kBK + F * F +
                                       kBK) +
                      sizeof(int) * kBK;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec = dh % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  dim3 grid((T + kBQ - 1) / kBQ, B * H);
  flash_fwd<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, key_mask, fb, fid, o, lse, H, T, dh, F, scale, vec);
  return (int)cudaGetLastError();
}
