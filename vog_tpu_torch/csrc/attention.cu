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

}  // namespace

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
