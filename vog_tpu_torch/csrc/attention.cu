// Flash attention with a factored relative-frame bias, fp32, forward and
// backward, on Hopper's tensor cores in 3xTF32.
//
//   o[b,h,i]   = softmax_j( q_i.k_j * scale + fb[h, fid_i, fid_j] ; key-masked ) . v
//   lse[b,h,i] = log-sum-exp of the same row
//
// Replaces vog_tpu/kernels/attention.py §_fwd_call (_fwd_kernel,
// _bias_block) and §_flash_bwd in both of its modes: "recompute"
// (_make_bwd_dkv_kernel(False), _bwd_dq_kernel) and "emit"
// (_make_bwd_dkv_kernel(True)).  The TPU forward keeps the whole key axis
// of a 128-row q block in VMEM and builds the bias tile with a one-hot
// matmul that exists for Mosaic.  A block here has at most 227 KB of shared memory, so these
// kernels run an online softmax over key tiles and read the bias from the
// head's (F, F) table in shared memory at fb[fid_i, fid_j].
//
// What bounds them on the H100: at GT5 (B=16, H=4, T=200, dh=128) the
// forward does 4 BH T^2 dh = 1.3 GFLOP on 26 MB, the backward 10 BH T^2 dh
// from the saved o and lse: both are bound by operations.  fp32 FMA runs at
// 67 TFLOP/s; the tensor cores run TF32 at 495, but plain TF32 (10 mantissa
// bits) misses the port's 1e-4 parity bound, so every product runs in
// 3xTF32 (tf32.cuh), 495 / 3 = 165 TFLOP/s of fp32-accurate work.  At GT5
// a grid has only 64 (b, h) x 4 blocks of 4 warps, two warps for each of
// the 528 schedulers, so latency is hidden within a warp or not at all,
// and the instruction stream around the products (operand splits,
// shared-memory fragment reads, addressing) weighs as much as the mma.
//
// Design, all three kernels:
//  * 4 warps; a warp owns 16 rows (query rows in flash_fwd and flash_bwd_dq,
//    key rows in flash_bwd_dkv), a block 64.  Every product is mma.sync
//    m16n8k8 in 3xTF32: S = Q K^T and O += P V forward; S, dP = dO V^T,
//    dV += P^T dO, dK += dS^T Q and dQ += dS K backward.  The operands are
//    split with split_int (two integer/fp32 operations, no conversion
//    instruction).
//  * The head dim is a compile-time parameter: instances at DK 64 and 128
//    (a call pads dh up to the next one with zeros), so every loop over it
//    unrolls and the loads run ahead of the products, and a dh-64 call
//    (the BERT tagger's) runs no k-steps on padding.  A score tile is
//    summed in two accumulator sets (even and odd k-steps) so that its
//    dependent mma chains are half as long.
//  * Past 128 every kernel is a cluster kernel (flash_fwd_cl,
//    flash_bwd_dkv_cl, flash_bwd_dq_cl), the head dim split over a thread
//    block cluster (cluster.cuh): ceil(dh / 128) blocks a tile of rows,
//    each staging by TMA and accumulating only its 128 columns, the score
//    partials (S, and dP backward) summed once over the cluster through
//    distributed shared memory in rank order.  The design it replaced (a
//    DK 256 instance, and past 256 the DK 128 instances' wide path) redid
//    the whole S (and dP) in every block of a tile, 2x at DK 256 and 8x at
//    dh 1024, the wide path's operands read fragment by fragment from L2;
//    the two designs' times on the H100 are in PERF.md (section 6).
//    flash_fwd_cl has 8 warps, a warp 16 rows and 64 of the block's 128
//    columns (cluster.cuh), so its 32 output accumulators a lane and the
//    32-key score tile fit without the spills of flash_fwd<128>.
//  * The resident rows (Q, or Q and dO, or K and V) stay in shared memory
//    and are split as their fragments are read.  The streamed tiles (K/V
//    in flash_fwd, 32 rows; K/V in flash_bwd_dq and Q/dO in
//    flash_bwd_dkv, 16 rows) come in by cp.async (16-byte copies,
//    zero-filled past T and past dh; by TMA in the cluster kernels) into a
//    two-stage ring: tile i+1 loads while tile i is multiplied, with one
//    __syncthreads a tile.  Shared memory: 101 KB a block at DK 128, two
//    blocks (8 warps) an SM, which at GT5 holds the whole grid (256
//    blocks) at once; 107-111 KB for the backward's cluster kernels (their
//    128 columns and the two partials), two blocks an SM; 123 KB for
//    flash_fwd_cl (8 warps), one block an SM.
//    The (F, F) bias table sits in shared memory up to 64 frames, and is
//    read from device memory (L2) past that (tiles.cuh §kTableF,
//    §TableMode), and by the cluster kernels at any F.
//  * Shared rows of DK + 4 floats (conflict-free fragment reads), and P
//    (and dS) passed from the C fragment of one product to the A fragment
//    of the next in registers by reading each 8-key step in pair order:
//    tiles.cuh says how.  Quad shuffles would cost 8 a fragment, a shared
//    tile a store, a warp sync and a load.
//  * The softmax statistics work on C fragments: a row's values sit in the
//    four lanes of a quad, so its max is two __shfl_xor_sync; the running
//    sum stays per lane and is summed over the quad once, at the end.
//  * Masked keys take the finite -1e30 of the TPU kernel, so a row with
//    every key masked stays finite (it averages V over the T real keys);
//    keys past T are excluded (-inf).  A single frame (F == 1, which is also
//    how the wrapper passes "no bias") adds the head's scalar fb[h] and
//    skips the frame-id lookups.
//
// Backward (recompute: the (T, T) score gradient never reaches device
// memory): flash_bwd_delta forms delta = rowsum(do * o), a warp a row, then
// two kernels:
//   flash_bwd_dkv  a block owns 64 keys and walks the query tiles: p =
//                  exp(s - lse), ds = p (dp - delta), dv += p^T do and
//                  dk += ds^T q, accumulated in registers;
//   flash_bwd_dq   a block owns 64 query rows and walks the key tiles:
//                  dq += ds k.  With F > 1 it also sums ds by (query frame,
//                  key frame) in a fixed order (a lane per key frame, keys
//                  in order, then rows in order) into one (F, F) partial
//                  per tile of rows, which the wrapper adds up in a fixed
//                  order: the frame-bias gradient is the same on every run
//                  (no float atomics).  Past 64 frames a tile of rows has
//                  ceil(F / 64) blocks, block z summing key frames
//                  64z..64z+63, each in that order (the cluster kernel:
//                  rank z of a group of clusters in grid.x, grid.z being
//                  the cluster's).  With F == 1 the gradient of the scalar
//                  is sum_ij ds_ij, zero for every row up to rounding
//                  (sum_j p_ij dp_ij = delta_i), so the pass is skipped and
//                  the wrapper returns zeros.
// Emit mode runs flash_bwd_dkv alone, with kEmit: it also stores the masked
// ds of every (query, key) to a (B*H, T, T) buffer from its C fragments
// (a warp's store writes 8 consecutive keys for each of 4 queries: whole
// 32-byte sectors; offsets in size_t, as B*H*T^2 passes 2^31 at B=16,
// T=4000), and the wrapper forms dq = scale ds.k and the frame-bias
// gradient as plain products over it, as the TPU package leaves them to
// XLA.  It writes 4 BH T^2 bytes (512 MB at P100, B=2) that the products
// read back, and saves the dq kernel's recompute of S and dP.
// A batch row whose keys are all masked has lse = -1e30 + log T = -1e30 in
// fp32, so p is taken as 1/T there (the softmax of equal scores), which is
// what autograd of the plain forward gives; its ds is masked to 0.
//
// Precision: this file builds twice (kernels/_build.py).  As it is, every
// product is 3xTF32 ("highest"); with -DVOG_ONE_PASS=1 every product is one
// TF32 pass, its operands rounded to nearest ("default", the production
// recipe's: tf32.cuh), and emit mode stores ds in bf16 (store_ds), as the JAX
// package does at "default" on the chip.  The kernels' code is the same:
// the pass count is a template parameter of tiles.cuh's helpers.
//
// The previous design (fp32 FMA loops on the CUDA cores, a warp per four
// rows, synchronous float4 staging of 32-row tiles) took 0.1327 / 0.1338 ms
// forward and 0.4111 / 0.4264 ms backward at GT5 (chip_smoke.py, H100 80GB
// HBM3, 700 W); this design's times are in PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tiles.cuh"  // cp.async row tiles, fragments, scores, accumulate (3xTF32), HeadDim
#include "cluster.cuh"  // the head dim split over a cluster: slices, barriers, TMA, partials
#include "device.cuh"  // DeviceGuard: every entry point runs on its tensors' device

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;  // rows a block owns
constexpr int kFwdTile = 32;        // rows of a streamed tile: forward
constexpr int kTileB = 16;          // rows of a streamed tile: backward
constexpr int kDsLd = kTileB + 1;   // row stride of a warp's ds tile (frame sums)

// the bias of (query frame fq, key code c >= 0): the head's (F, F) table
// at (fq, c) (tiles.cuh §table_bias), or with no table its scalar fb0
template <int TM>
__device__ inline float bias(const float* fbs, const float* __restrict__ fbg, float fb0, int F, int fq,
                             int c) {
  return TM == kNoTable ? fb0 : table_bias<TM>(fbs, fbg, F, fq, c);
}

// the head's table in device memory (kFrames), or null
__device__ inline const float* head_table(const float* __restrict__ fb, int h, int F, bool frames) {
  return frames ? fb + (size_t)h * F * F : nullptr;
}

// Shared memory a block: 101 KB at DK 128, two blocks (8 warps) an SM.
// DK 64 and 128 (past 128: flash_fwd_cl).
template <int DK, int TM>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ key_mask,
          const float* __restrict__ fb, const int* __restrict__ fid,
          float* __restrict__ o, float* __restrict__ lse, int H, int T,
          int dh, int F, float scale, bool vec) {
  using HD = HeadDim<DK>;
  constexpr int kLd = HD::kLd;
  constexpr int kTileF = kFwdTile;
  constexpr int NT = kTileF / 8;
  constexpr bool kFrames = TM != kNoTable;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);                // kRows x kLd
  float* Ks = Qs + kRows * kLd;                                // 2 stages x kTileF x kLd
  float* Vs = Ks + 2 * kTileF * kLd;                           // 2 stages x kTileF x kLd
  int* codes = reinterpret_cast<int*>(Vs + 2 * kTileF * kLd);  // 2 stages x kTileF
  float* fbs = reinterpret_cast<float*>(codes + 2 * kTileF);   // F x F (kSmemTable)
  const float* fbg = head_table(fb, h, F, kFrames);

  const size_t base = (size_t)bh * T * dh;
  const float* kb = k + base;
  const float* vb = v + base;
  auto stage = [&](int s, int j0) {
    load_rows<kTileF, kThreads, DK>(Ks + s * kTileF * kLd, kb, j0, T, dh, vec);
    load_rows<kTileF, kThreads, DK>(Vs + s * kTileF * kLd, vb, j0, T, dh, vec);
    if (tid < kTileF) codes[s * kTileF + tid] = key_code<kFrames>(key_mask, fid, b, j0 + tid, T);
    cp_commit();
  };
  stage_table<TM, kThreads>(fbs, fbg, F);
  const float fb0 = kFrames || fb == nullptr ? 0.f : fb[h];
  load_rows<kRows, kThreads, DK>(Qs, q + base, q0, T, dh, vec);
  stage(0, 0);  // one group: Q and the first K/V tile

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this lane's two rows
  const int fq0 = kFrames && r0 < T ? fid[r0] : 0;
  const int fq1 = kFrames && r1 < T ? fid[r1] : 0;
  const float* Qw = Qs + warp * 16 * kLd;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;  // l: this lane's part of the sum
  float acc[HD::kNV][4];
  zero(acc);

  const int ntiles = (T + kTileF - 1) / kTileF;
  for (int it = 0; it < ntiles; ++it) {
    const int s = it & 1;
    cp_wait_all();
    __syncthreads();  // tile it is in; every warp is done with tile it - 1
    if (it + 1 < ntiles) stage(s ^ 1, (it + 1) * kTileF);
    const float* Kt = Ks + s * kTileF * kLd;
    const float* Vt = Vs + s * kTileF * kLd;
    const int* ct = codes + s * kTileF;

    float sc[NT][4];  // S = Q K^T
    scores<NT, false, DK>(sc, sc, Qw, Kt, Qw, Kt, g, t);

    // online softmax on the C fragments: rows g (c0, c1) and g + 8 (c2, c3)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = ct[8 * j + 2 * t + e];
        float x0, x1;
        if (c >= 0) {
          x0 = sc[j][e] * scale + bias<TM>(fbs, fbg, fb0, F, fq0, c);
          x1 = sc[j][2 + e] * scale + bias<TM>(fbs, fbg, fb0, F, fq1, c);
        } else {
          x0 = x1 = c == kMasked ? kNeg : -INFINITY;
        }
        sc[j][e] = x0;
        sc[j][2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] = expf(sc[j][e] - mn0);
        sc[j][2 + e] = expf(sc[j][2 + e] - mn1);
        l0 += sc[j][e];
        l1 += sc[j][2 + e];
      }
#pragma unroll
    for (int n = 0; n < HD::kNV; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
    // O += P V (keys past T: p = 0, zero rows)
    accumulate<NT, HD::kNV, kLd>(acc, sc, Vt, g, t);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  store_rows(o + base, acc, r0, 0, T, dh, t, 1.f / l0, 1.f / l1);
  if (t == 0) {
    if (r0 < T) lse[(size_t)bh * T + r0] = m0 + logf(l0);
    if (r1 < T) lse[(size_t)bh * T + r1] = m1 + logf(l1);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// 1 when batch row b has no valid key (every thread of the block agrees)
__device__ inline int all_masked(const float* __restrict__ key_mask, int b, int T) {
  int any = 0;
  for (int j = threadIdx.x; j < T; j += blockDim.x) any |= key_mask[(size_t)b * T + j] > 0.f;
  return !__syncthreads_or(any);
}

// delta[r] = sum_d dout[r, d] o[r, d], a warp a row
__global__ void __launch_bounds__(256)
flash_bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
                float* __restrict__ delta, int rows, int dh) {
  row_dots(o, dout, delta, rows, dh);
}

// kEmit: also store the masked ds (B*H, T, T), query-major ("emit" mode).
// DK 64 and 128 (past 128: flash_bwd_dkv_cl).
template <int DK, int TM, bool kEmit>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const float* __restrict__ key_mask, const float* __restrict__ fb,
              const int* __restrict__ fid, float* __restrict__ dk,
              float* __restrict__ dv, DsT* __restrict__ ds, int H, int T, int dh,
              int F, float scale, bool vec) {
  using HD = HeadDim<DK>;
  static_assert(HD::kSlices == 1, "one block a tile of keys");
  constexpr int kLd = HD::kLd;
  constexpr int NT = kTileB / 8;
  constexpr bool kFrames = TM != kNoTable;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);               // kRows x kLd
  float* Vs = Ks + kRows * kLd;                               // kRows x kLd
  float* Qs = Vs + kRows * kLd;                               // 2 stages x kTileB x kLd
  float* Os = Qs + 2 * kTileB * kLd;                          // 2 stages x kTileB x kLd: dO
  float* ls = Os + 2 * kTileB * kLd;                          // 2 x kTileB: lse
  float* dls = ls + 2 * kTileB;                               // 2 x kTileB: delta
  int* fqs = reinterpret_cast<int*>(dls + 2 * kTileB);       // 2 x kTileB: query frame, -1 past T
  float* fbs = reinterpret_cast<float*>(fqs + 2 * kTileB);   // F x F (kSmemTable)
  const float* fbg = head_table(fb, h, F, kFrames);

  const size_t base = (size_t)bh * T * dh;
  const float* qb = q + base;
  const float* ob = dout + base;
  auto stage = [&](int s, int i0) {
    load_rows<kTileB, kThreads, DK>(Qs + s * kTileB * kLd, qb, i0, T, dh, vec);
    load_rows<kTileB, kThreads, DK>(Os + s * kTileB * kLd, ob, i0, T, dh, vec);
    if (tid < kTileB) {
      const int qi = i0 + tid;
      ls[s * kTileB + tid] = qi < T ? lse[(size_t)bh * T + qi] : 0.f;
      dls[s * kTileB + tid] = qi < T ? delta[(size_t)bh * T + qi] : 0.f;
      fqs[s * kTileB + tid] = qi < T ? (kFrames ? fid[qi] : 0) : -1;
    }
    cp_commit();
  };
  stage_table<TM, kThreads>(fbs, fbg, F);
  const float fb0 = kFrames || fb == nullptr ? 0.f : fb[h];
  load_rows<kRows, kThreads, DK>(Ks, k + base, k0, T, dh, vec);
  load_rows<kRows, kThreads, DK>(Vs, v + base, k0, T, dh, vec);
  stage(0, 0);  // one group: K, V and the first Q/dO tile
  const int none = all_masked(key_mask, b, T);
  const float p_none = 1.f / (float)T;

  const int kr0 = k0 + warp * 16 + g;  // this lane's keys: kr0 and kr0 + 8
  const int kc[2] = {key_code<kFrames>(key_mask, fid, b, kr0, T), key_code<kFrames>(key_mask, fid, b, kr0 + 8, T)};
  const float* Kw = Ks + warp * 16 * kLd;
  const float* Vw = Vs + warp * 16 * kLd;
  float adk[HD::kNV][4], adv[HD::kNV][4];
  zero(adk);
  zero(adv);

  const int ntiles = (T + kTileB - 1) / kTileB;
  for (int it = 0; it < ntiles; ++it) {
    const int s = it & 1;
    cp_wait_all();
    __syncthreads();  // tile it is in; every warp is done with tile it - 1
    if (it + 1 < ntiles) stage(s ^ 1, (it + 1) * kTileB);
    const float* Qt = Qs + s * kTileB * kLd;
    const float* Ot = Os + s * kTileB * kLd;
    const float* lt = ls + s * kTileB;
    const float* dlt = dls + s * kTileB;
    const int* ft = fqs + s * kTileB;

    // S^T = K Q^T and dP^T = V dO^T (16 keys x kTileB queries a warp)
    float st[NT][4], dpt[NT][4];
    scores<NT, true, DK>(st, dpt, Kw, Qt, Vw, Ot, g, t);

    // p and ds on the C fragments: key kr0 (c0, c1) and kr0 + 8 (c2, c3)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const float li = lt[col], di = dlt[col];
        const int fq = ft[col];  // -1: query past T
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int c = kc[r], i = 2 * r + e;
          const float x = c >= 0 ? st[j][i] * scale + bias<TM>(fbs, fbg, fb0, F, max(fq, 0), c) : kNeg;
          const float p = (fq < 0 || c == kPast) ? 0.f : (none ? p_none : expf(x - li));
          st[j][i] = p;
          dpt[j][i] = c >= 0 ? p * (dpt[j][i] - di) : 0.f;
        }
      }

    accumulate<NT, HD::kNV, kLd>(adv, st, Ot, g, t);   // dV += P^T dO
    accumulate<NT, HD::kNV, kLd>(adk, dpt, Qt, g, t);  // dK += dS^T Q
    if (kEmit) {  // ds[bh, q, k]: a store writes 8 consecutive keys for each of 4 queries
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = it * kTileB + 8 * j + 2 * t + e;
          if (qi >= T) continue;
          DsT* row = ds + ((size_t)bh * T + qi) * T;
          if (kr0 < T) store_ds(row + kr0, dpt[j][e]);
          if (kr0 + 8 < T) store_ds(row + kr0 + 8, dpt[j][2 + e]);
        }
    }
  }

  store_rows(dk + base, adk, kr0, 0, T, dh, t, scale, scale);
  store_rows(dv + base, adv, kr0, 0, T, dh, t, 1.f, 1.f);
}

// With frames, block z of a tile of rows sums ds over key frames
// 64z..64z+63 (z < ceil(F / 64)): a launch has ceil(F / 64) blocks a tile
// (grid.z), each summing its frames in the one fixed order, so the
// frame-bias gradient takes any F with the registers and the order of F <=
// 64; block 0 also computes dq.  DK 64 and 128 (past 128: flash_bwd_dq_cl).
template <int DK, int TM>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const float* __restrict__ key_mask, const float* __restrict__ fb,
             const int* __restrict__ fid, float* __restrict__ dqo,
             float* __restrict__ dfb_part, int H, int T, int dh, int F,
             float scale, bool vec) {
  using HD = HeadDim<DK>;
  static_assert(HD::kSlices == 1, "one column slice");
  constexpr int kLd = HD::kLd;
  constexpr int NT = kTileB / 8;
  // after the key loop the frame sums of the rows (kRows x kFrameTile) take the K/V ring's place
  static_assert(4 * kTileB * kLd >= kRows * kFrameTile, "the frame sums fit the K/V ring");
  constexpr bool kFrames = TM != kNoTable;
  // one block a tile of rows: the frames (if any) in one tile
  constexpr bool kOne = TM != kGlobalTable;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows, z = kOne ? 0 : blockIdx.z;
  const bool do_dq = z == 0;
  const int fbase = kFrameTile * z;              // frames 64z..64z+63
  const bool do_fr = kFrames && (kOne || fbase < F);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);                // kRows x kLd
  float* Os = Qs + kRows * kLd;                                // kRows x kLd: dO
  float* Ks = Os + kRows * kLd;                                // 2 stages x kTileB x kLd
  float* Vs = Ks + 2 * kTileB * kLd;                           // 2 stages x kTileB x kLd
  int* codes = reinterpret_cast<int*>(Vs + 2 * kTileB * kLd);  // 2 stages x kTileB
  float* fbs = reinterpret_cast<float*>(codes + 2 * kTileB);   // F x F (kSmemTable)
  float* dsw = fbs + table_floats(F);                           // kWarps x 16 x kDsLd (kFrames)
  const float* fbg = head_table(fb, h, F, kFrames);

  const size_t base = (size_t)bh * T * dh;
  const float* kb = k + base;
  const float* vb = v + base;
  auto stage = [&](int s, int j0) {
    load_rows<kTileB, kThreads, DK>(Ks + s * kTileB * kLd, kb, j0, T, dh, vec);
    load_rows<kTileB, kThreads, DK>(Vs + s * kTileB * kLd, vb, j0, T, dh, vec);
    if (tid < kTileB) codes[s * kTileB + tid] = key_code<kFrames>(key_mask, fid, b, j0 + tid, T);
    cp_commit();
  };
  stage_table<TM, kThreads>(fbs, fbg, F);
  const float fb0 = kFrames || fb == nullptr ? 0.f : fb[h];
  load_rows<kRows, kThreads, DK>(Qs, q + base, q0, T, dh, vec);
  load_rows<kRows, kThreads, DK>(Os, dout + base, q0, T, dh, vec);
  stage(0, 0);  // one group: Q, dO and the first K/V tile

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this lane's two rows
  const int fq0 = kFrames && r0 < T ? fid[r0] : 0;
  const int fq1 = kFrames && r1 < T ? fid[r1] : 0;
  const float li0 = r0 < T ? lse[(size_t)bh * T + r0] : 0.f;
  const float li1 = r1 < T ? lse[(size_t)bh * T + r1] : 0.f;
  const float di0 = r0 < T ? delta[(size_t)bh * T + r0] : 0.f;
  const float di1 = r1 < T ? delta[(size_t)bh * T + r1] : 0.f;
  const float* Qw = Qs + warp * 16 * kLd;
  const float* Ow = Os + warp * 16 * kLd;
  float* dw = dsw + warp * 16 * kDsLd;
  float acc[HD::kNV][4];
  zero(acc);
  // frame sums (do_fr): rs[r][x] sums ds of warp row r over the keys of
  // frame fbase + lane + 32 x
  float rs[16][2];
#pragma unroll
  for (int r = 0; r < 16; ++r) rs[r][0] = rs[r][1] = 0.f;

  const int ntiles = (T + kTileB - 1) / kTileB;
  for (int it = 0; it < ntiles; ++it) {
    const int s = it & 1;
    cp_wait_all();
    __syncthreads();  // tile it is in; every warp is done with tile it - 1
    if (it + 1 < ntiles) stage(s ^ 1, (it + 1) * kTileB);
    const float* Kt = Ks + s * kTileB * kLd;
    const float* Vt = Vs + s * kTileB * kLd;
    const int* ct = codes + s * kTileB;

    // S = Q K^T and dP = dO V^T (16 rows x kTileB keys a warp)
    float sc[NT][4], dp[NT][4];
    scores<NT, true, DK>(sc, dp, Qw, Kt, Ow, Vt, g, t);

    // ds on the C fragments (masked keys and keys past T give 0)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = ct[8 * j + 2 * t + e];
        float d0 = 0.f, d1 = 0.f;
        if (c >= 0) {
          const float x0 = sc[j][e] * scale + bias<TM>(fbs, fbg, fb0, F, fq0, c);
          const float x1 = sc[j][2 + e] * scale + bias<TM>(fbs, fbg, fb0, F, fq1, c);
          d0 = expf(x0 - li0) * (dp[j][e] - di0);
          d1 = expf(x1 - li1) * (dp[j][2 + e] - di1);
        }
        sc[j][e] = d0;
        sc[j][2 + e] = d1;
      }

    if (do_dq) accumulate<NT, HD::kNV, kLd>(acc, sc, Kt, g, t);  // dQ += dS K

    if (do_fr) {
      // the warp's ds tile through shared memory, then a lane per key
      // frame adds up its keys in order
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dw[g * kDsLd + 8 * j + 2 * t + e] = sc[j][e];
          dw[(g + 8) * kDsLd + 8 * j + 2 * t + e] = sc[j][2 + e];
        }
      __syncwarp();
      const int nk = min(kTileB, T - it * kTileB);
      for (int jj = 0; jj < nk; ++jj) {
        const int fk = ct[jj] - fbase;  // masked keys and keys past T: < 0
        if (fk == lane) {
#pragma unroll
          for (int r = 0; r < 16; ++r) rs[r][0] += dw[r * kDsLd + jj];
        } else if (fk == lane + 32) {
#pragma unroll
          for (int r = 0; r < 16; ++r) rs[r][1] += dw[r * kDsLd + jj];
        }
      }
      __syncwarp();  // dw is rewritten by the next tile
    }
  }

  if (do_dq) store_rows(dqo + base, acc, r0, 0, T, dh, t, scale, scale);
  if (!do_fr) return;
  __syncthreads();  // every warp is done with the K/V ring
  float* racc = Ks;  // kRows x kFrameTile: the rows' sums over this block's frames
  const int nf = min(kFrameTile, F - fbase);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int rr = warp * 16 + r;
    if (lane < nf) racc[rr * kFrameTile + lane] = rs[r][0];
    if (lane + 32 < nf) racc[rr * kFrameTile + lane + 32] = rs[r][1];
  }
  __syncthreads();
  // this block's columns fbase.. of the (F, F) partial: rows in order, those of query frame f
  float* part = dfb_part + ((size_t)bh * gridDim.x + blockIdx.x) * F * F;
  for (int cell = tid; cell < F * nf; cell += kThreads) {
    const int f = cell / nf, gk = cell - f * nf;
    float sum = 0.f;
    for (int r = 0; r < kRows && q0 + r < T; ++r)
      if (fid[q0 + r] == f) sum += racc[r * kFrameTile + gk];
    part[f * F + fbase + gk] = sum;
  }
}

// ---------------------------------------------------------------------------
// backward past head dim 128: the head dim split over a cluster (cluster.cuh)
// ---------------------------------------------------------------------------
// The narrow kernels' blocks (4 warps, 64 rows, 16-row streamed tiles) for
// column slice zs = z + n pass of a cluster of n blocks: the resident rows
// and the streamed tiles are the block's 128 columns, by TMA; each warp's
// partial S and dP over them are summed over the cluster in rank order, and
// the rest of a tile (p, ds, the masks, the accumulating products over the
// block's columns) is the narrow kernels'.  The frame table is read from
// device memory at any F.  The score products are rolled in chunks of
// kClChunk k-steps, S and dP one after the other, each stored to the
// partial as it is done: the narrow dkv kernel's two products of 16
// unrolled k-steps spill (ptxas), beside its 128 accumulators a lane.
constexpr int kClPart = kWarps * 32 * 4 * (kTileB / 8);  // floats of a block's partial S (or dP)
constexpr int kClChunk = 8;

// DK 128's fragments and products over the block's slice
using HS = HeadDim<kSlice>;

// The parts of flash_bwd_dkv_cl an instance computes: dK and dV (one pass,
// no other slices), or past 8 slices (the instances that add a block's
// other slices, kX) dV alone (S alone) or dK alone (S and dP, and emit
// mode's ds), one launch each a pass, so that the other slices' operand
// rows and reads fit beside 64 accumulators a lane, not 128 (spills)
enum DkvPart : int { kDkv = 0, kDvX = 1, kDkX = 2 };

template <int TM, bool kEmit, int kPart>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_cl(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap omap,
                 const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                 const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ key_mask, const float* __restrict__ fb, const int* __restrict__ fid,
                 float* __restrict__ dk, float* __restrict__ dv, DsT* __restrict__ ds, int H, int T, int dh,
                 int F, float scale, int pass) {
  constexpr int kLd = kSliceLd;
  constexpr int NT = kTileB / 8;
  constexpr bool kFrames = TM != kNoTable;
  constexpr bool kX = kPart != kDkv;          // other slices, read from device memory
  constexpr bool kDV = kPart != kDkX;         // dV += P^T dO
  constexpr bool kDK = kPart != kDvX;         // dP, ds and dK += dS^T Q
  const int z = (int)cg::this_cluster().block_rank();
  const int zs = slice_of<kX>(z, pass);  // the slice this block stages and accumulates
  const bool own = owns<kX>(zs, dh);     // (else it stages slice 0 and adds only its other slices' partials)
  const int cz = kSlice * (own ? zs : 0);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(128) float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);                // kRows x kLd
  float* Vs = Ks + kRows * kLd;                                // kRows x kLd
  float* Qs = Vs + kRows * kLd;                                // 2 stages x kTileB x kLd
  float* Os = Qs + 2 * kTileB * kLd;                           // 2 stages x kTileB x kLd: dO
  float* Sp = Os + 2 * kTileB * kLd;                           // kClPart: this block's partial S^T
  float* Dp = Sp + kClPart;                                    // kClPart: its partial dP^T
  float* ls = Dp + kClPart;                                    // 2 x kTileB: lse
  float* dls = ls + 2 * kTileB;                                // 2 x kTileB: delta
  int* fqs = reinterpret_cast<int*>(dls + 2 * kTileB);        // 2 x kTileB: query frame, -1 past T
  uint64_t* bars = reinterpret_cast<uint64_t*>(fqs + 2 * kTileB);  // K/V, then the Q/dO stages
  const float* fbg = head_table(fb, h, F, kFrames);
  const float fb0 = kFrames || fb == nullptr ? 0.f : fb[h];

  const size_t base = (size_t)bh * T * dh;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i);
    mbar_fence_init();
  }
  __syncthreads();
  auto stage = [&](int s, int i0) {
    if (tid == 0) {
      mbar_expect(bars + 1 + s, 2 * box_bytes(kTileB));
      tma_load(Qs + s * kTileB * kLd, &qmap, cz, i0, bh, bars + 1 + s);
      tma_load(Os + s * kTileB * kLd, &omap, cz, i0, bh, bars + 1 + s);
    }
    if (tid < kTileB) {
      const int qi = i0 + tid;
      ls[s * kTileB + tid] = qi < T ? lse[(size_t)bh * T + qi] : 0.f;
      dls[s * kTileB + tid] = qi < T ? delta[(size_t)bh * T + qi] : 0.f;
      fqs[s * kTileB + tid] = qi < T ? (kFrames ? fid[qi] : 0) : -1;
    }
  };
  if (tid == 0) {
    mbar_expect(bars, 2 * box_bytes(kRows));
    tma_load(Ks, &kmap, cz, k0, bh, bars);
    tma_load(Vs, &vmap, cz, k0, bh, bars);
  }
  stage(0, 0);
  const int none = all_masked(key_mask, b, T);
  const float p_none = 1.f / (float)T;

  const int kr0 = k0 + warp * 16 + g;  // this lane's keys: kr0 and kr0 + 8
  const int kc[2] = {key_code<kFrames>(key_mask, fid, b, kr0, T), key_code<kFrames>(key_mask, fid, b, kr0 + 8, T)};
  const float* Kw = Ks + warp * 16 * kLd;
  const float* Vw = Vs + warp * 16 * kLd;
  float adk[kDK ? HS::kNV : 1][4], adv[kDV ? HS::kNV : 1][4];
  zero(adk);
  zero(adv);
  mbar_wait(bars, 0);  // the K and V rows

  const int ntiles = (T + kTileB - 1) / kTileB;
  for (int it = 0; it < ntiles; ++it) {
    const int s = it & 1;
    __syncthreads();  // tile it's statistics are in; every warp is done with tile it - 1
    if (it + 1 < ntiles) stage(s ^ 1, (it + 1) * kTileB);
    mbar_wait(bars + 1 + s, (it >> 1) & 1);  // tile it's Q and dO
    const float* Qt = Qs + s * kTileB * kLd;
    const float* Ot = Os + s * kTileB * kLd;
    const float* lt = ls + s * kTileB;
    const float* dlt = dls + s * kTileB;
    const int* ft = fqs + s * kTileB;

    // S^T = K Q^T and dP^T = V dO^T (16 keys x kTileB queries a warp): the
    // block's partials, summed over the cluster
    float st[NT][4], dpt[NT][4];
    zero(st);
    if (own) scores<NT, false, kSlice, kOnePass, kClChunk>(st, st, Kw, Qt, Kw, Qt, g, t);
    if constexpr (kX) add_other_slices<NT>(st, k + base, q + base, k0 + warp * 16, it * kTileB, T, dh, z, pass, g, t);
    if (it > 0) cluster_wait();  // every peer has read this block's partials of tile it - 1
    put_partial<NT>(Sp, st, warp, lane);
    if constexpr (kDK) {
      zero(dpt);
      if (own) scores<NT, false, kSlice, kOnePass, kClChunk>(dpt, dpt, Vw, Ot, Vw, Ot, g, t);
      if constexpr (kX)
        add_other_slices<NT>(dpt, v + base, dout + base, k0 + warp * 16, it * kTileB, T, dh, z, pass, g, t);
      put_partial<NT>(Dp, dpt, warp, lane);
    }
    cluster_arrive();
    cluster_wait();  // every block's partials are in

    // p on the C fragments: key kr0 (c0, c1) and kr0 + 8 (c2, c3); then dV
    sum_partials<NT>(st, Sp, warp, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const float li = lt[col];
        const int fq = ft[col];  // -1: query past T
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int c = kc[r], i = 2 * r + e;
          const float x = c >= 0 ? st[j][i] * scale + bias<TM>(nullptr, fbg, fb0, F, max(fq, 0), c) : kNeg;
          st[j][i] = (fq < 0 || c == kPast) ? 0.f : (none ? p_none : expf(x - li));
        }
      }
    if constexpr (kDV) accumulate<NT, HS::kNV, kLd>(adv, st, Ot, g, t);  // dV += P^T dO
    if constexpr (kDK) {  // ds = p (dp - delta) on the valid keys, dK += dS^T Q
      sum_partials<NT>(dpt, Dp, warp, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float di = dlt[8 * j + 2 * t + e];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 2 * r + e;
            dpt[j][i] = kc[r] >= 0 ? st[j][i] * (dpt[j][i] - di) : 0.f;
          }
        }
    }
    cluster_arrive();  // this block is done with its peers' partials
    if constexpr (kDK) {
      accumulate<NT, HS::kNV, kLd>(adk, dpt, Qt, g, t);
      if (kEmit && zs == 0) {  // ds[bh, q, k], by one block of the cluster
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = it * kTileB + 8 * j + 2 * t + e;
            if (qi >= T) continue;
            DsT* row = ds + ((size_t)bh * T + qi) * T;
            if (kr0 < T) store_ds(row + kr0, dpt[j][e]);
            if (kr0 + 8 < T) store_ds(row + kr0 + 8, dpt[j][2 + e]);
          }
      }
    }
  }
  cluster_wait();  // no peer reads this block's partials any more
  if (!own) return;
  if constexpr (kDK) store_rows(dk + base, adk, kr0, cz, T, dh, t, scale, scale);
  if constexpr (kDV) store_rows(dv + base, adv, kr0, cz, T, dh, t, 1.f, 1.f);
}

// flash_bwd_dq over a cluster: block (tile of rows rt, group c) of rank z
// computes dq's slice zs (group 0) and, in pass 0 with frames, sums ds over
// frame tile c n + z (key frames 64 (c n + z) ..), in the narrow kernel's
// order, into its tile's (F, F) partial: each partial cell by one block.
// kPart: both (one pass), or past 8 slices (kX) dQ alone and the frame
// sums alone, two launches (dQ's 64 accumulators and the sums' 32 beside
// the other slices' reads spilled).
enum DqPart : int { kDq = 0, kDqX = 1, kFrX = 2 };

template <int TM, int kPart>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_cl(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap omap,
                const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ key_mask, const float* __restrict__ fb, const int* __restrict__ fid,
                float* __restrict__ dqo, float* __restrict__ dfb_part, int H, int T, int dh, int F, float scale,
                int pass) {
  constexpr int kLd = kSliceLd;
  constexpr int NT = kTileB / 8;
  static_assert(4 * kTileB * kLd >= kRows * kFrameTile, "the frame sums fit the K/V ring");
  constexpr bool kFrames = TM != kNoTable;
  constexpr bool kX = kPart != kDq;
  constexpr bool kQ = kPart != kFrX;                // dQ += dS K
  constexpr bool kFr = kFrames && kPart != kDqX;    // the frame sums
  const int z = (int)cg::this_cluster().block_rank();
  const int zs = slice_of<kX>(z, pass);
  const bool own = owns<kX>(zs, dh);
  const int cz = kSlice * (own ? zs : 0);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row_tiles = (T + kRows - 1) / kRows;
  const int rt = blockIdx.x % row_tiles, grp = blockIdx.x / row_tiles;
  const int q0 = rt * kRows;
  const bool do_dq = kQ && grp == 0 && own;
  const int fbase = kFrameTile * (grp * (int)gridDim.z + z);  // key frames fbase..fbase+63
  const bool do_fr = kFr && pass == 0 && fbase < F;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(128) float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);                // kRows x kLd
  float* Os = Qs + kRows * kLd;                                // kRows x kLd: dO
  float* Ks = Os + kRows * kLd;                                // 2 stages x kTileB x kLd
  float* Vs = Ks + 2 * kTileB * kLd;                           // 2 stages x kTileB x kLd
  float* Sp = Vs + 2 * kTileB * kLd;                           // kClPart: this block's partial S
  float* Dp = Sp + kClPart;                                    // kClPart: its partial dP
  int* codes = reinterpret_cast<int*>(Dp + kClPart);          // 2 stages x kTileB
  float* dsw = reinterpret_cast<float*>(codes + 2 * kTileB);  // kWarps x 16 x kDsLd (kFr)
  uint64_t* bars = reinterpret_cast<uint64_t*>(dsw + (kFr ? kWarps * 16 * kDsLd : 0));  // Q/dO, K/V stages
  const float* fbg = head_table(fb, h, F, kFrames);
  const float fb0 = kFrames || fb == nullptr ? 0.f : fb[h];

  const size_t base = (size_t)bh * T * dh;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i);
    mbar_fence_init();
  }
  __syncthreads();
  auto stage = [&](int s, int j0) {
    if (tid == 0) {
      mbar_expect(bars + 1 + s, 2 * box_bytes(kTileB));
      tma_load(Ks + s * kTileB * kLd, &kmap, cz, j0, bh, bars + 1 + s);
      tma_load(Vs + s * kTileB * kLd, &vmap, cz, j0, bh, bars + 1 + s);
    }
    if (tid < kTileB) codes[s * kTileB + tid] = key_code<kFrames>(key_mask, fid, b, j0 + tid, T);
  };
  if (tid == 0) {
    mbar_expect(bars, 2 * box_bytes(kRows));
    tma_load(Qs, &qmap, cz, q0, bh, bars);
    tma_load(Os, &omap, cz, q0, bh, bars);
  }
  stage(0, 0);

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this lane's two rows
  const int fq0 = kFrames && r0 < T ? fid[r0] : 0;
  const int fq1 = kFrames && r1 < T ? fid[r1] : 0;
  const float li0 = r0 < T ? lse[(size_t)bh * T + r0] : 0.f;
  const float li1 = r1 < T ? lse[(size_t)bh * T + r1] : 0.f;
  const float di0 = r0 < T ? delta[(size_t)bh * T + r0] : 0.f;
  const float di1 = r1 < T ? delta[(size_t)bh * T + r1] : 0.f;
  const float* Qw = Qs + warp * 16 * kLd;
  const float* Ow = Os + warp * 16 * kLd;
  float* dw = dsw + warp * 16 * kDsLd;
  float acc[kQ ? HS::kNV : 1][4];
  zero(acc);
  float rs[kFr ? 16 : 1][2];  // frame sums (do_fr), as flash_bwd_dq's
#pragma unroll
  for (int r = 0; r < (kFr ? 16 : 1); ++r) rs[r][0] = rs[r][1] = 0.f;
  mbar_wait(bars, 0);  // the Q and dO rows

  const int ntiles = (T + kTileB - 1) / kTileB;
  for (int it = 0; it < ntiles; ++it) {
    const int s = it & 1;
    __syncthreads();  // tile it's key codes are in; every warp is done with tile it - 1
    if (it + 1 < ntiles) stage(s ^ 1, (it + 1) * kTileB);
    mbar_wait(bars + 1 + s, (it >> 1) & 1);  // tile it's K and V
    const float* Kt = Ks + s * kTileB * kLd;
    const float* Vt = Vs + s * kTileB * kLd;
    const int* ct = codes + s * kTileB;

    // S = Q K^T and dP = dO V^T (16 rows x kTileB keys a warp): the block's
    // partials, summed over the cluster
    float sc[NT][4], dp[NT][4];
    zero(sc);
    zero(dp);
    if (own) scores<NT, false, kSlice, kOnePass, kClChunk>(sc, sc, Qw, Kt, Qw, Kt, g, t);
    if constexpr (kX) add_other_slices<NT>(sc, q + base, k + base, q0 + warp * 16, it * kTileB, T, dh, z, pass, g, t);
    if (it > 0) cluster_wait();  // every peer has read this block's partials of tile it - 1
    put_partial<NT>(Sp, sc, warp, lane);
    if (own) scores<NT, false, kSlice, kOnePass, kClChunk>(dp, dp, Ow, Vt, Ow, Vt, g, t);
    if constexpr (kX)
      add_other_slices<NT>(dp, dout + base, v + base, q0 + warp * 16, it * kTileB, T, dh, z, pass, g, t);
    put_partial<NT>(Dp, dp, warp, lane);
    cluster_arrive();
    cluster_wait();  // every block's partials are in
    sum_partials<NT>(sc, Sp, warp, lane);
    sum_partials<NT>(dp, Dp, warp, lane);
    cluster_arrive();  // this block is done with its peers' partials

    // ds on the C fragments (masked keys and keys past T give 0)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = ct[8 * j + 2 * t + e];
        float d0 = 0.f, d1 = 0.f;
        if (c >= 0) {
          const float x0 = sc[j][e] * scale + bias<TM>(nullptr, fbg, fb0, F, fq0, c);
          const float x1 = sc[j][2 + e] * scale + bias<TM>(nullptr, fbg, fb0, F, fq1, c);
          d0 = expf(x0 - li0) * (dp[j][e] - di0);
          d1 = expf(x1 - li1) * (dp[j][2 + e] - di1);
        }
        sc[j][e] = d0;
        sc[j][2 + e] = d1;
      }

    if constexpr (kQ)
      if (do_dq) accumulate<NT, HS::kNV, kLd>(acc, sc, Kt, g, t);  // dQ += dS K

    if constexpr (kFr)
    if (do_fr) {  // the warp's ds tile through shared memory, a lane per key frame
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dw[g * kDsLd + 8 * j + 2 * t + e] = sc[j][e];
          dw[(g + 8) * kDsLd + 8 * j + 2 * t + e] = sc[j][2 + e];
        }
      __syncwarp();
      const int nk = min(kTileB, T - it * kTileB);
      for (int jj = 0; jj < nk; ++jj) {
        const int fk = ct[jj] - fbase;  // masked keys and keys past T: < 0
        if (fk == lane) {
#pragma unroll
          for (int r = 0; r < 16; ++r) rs[r][0] += dw[r * kDsLd + jj];
        } else if (fk == lane + 32) {
#pragma unroll
          for (int r = 0; r < 16; ++r) rs[r][1] += dw[r * kDsLd + jj];
        }
      }
      __syncwarp();  // dw is rewritten by the next tile
    }
  }
  cluster_wait();  // no peer reads this block's partials any more

  if constexpr (kQ)
    if (do_dq) store_rows(dqo + base, acc, r0, cz, T, dh, t, scale, scale);
  if constexpr (kFr) {
    if (!do_fr) return;
    __syncthreads();  // every warp is done with the K/V ring
    float* racc = Ks;  // kRows x kFrameTile: the rows' sums over this block's frames
    const int nf = min(kFrameTile, F - fbase);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int rr = warp * 16 + r;
      if (lane < nf) racc[rr * kFrameTile + lane] = rs[r][0];
      if (lane + 32 < nf) racc[rr * kFrameTile + lane + 32] = rs[r][1];
    }
    __syncthreads();
    // this block's columns fbase.. of the (F, F) partial: rows in order, those of query frame f
    float* part = dfb_part + ((size_t)bh * row_tiles + rt) * F * F;
    for (int cell = tid; cell < F * nf; cell += kThreads) {
      const int f = cell / nf, gk = cell - f * nf;
      float sum = 0.f;
      for (int r = 0; r < kRows && q0 + r < T; ++r)
        if (fid[q0 + r] == f) sum += racc[r * kFrameTile + gk];
      part[f * F + fbase + gk] = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// forward past head dim 128: the head dim split over a cluster (cluster.cuh)
// ---------------------------------------------------------------------------
// flash_fwd's tile (64 query rows a block, 32-key tiles, the online
// softmax) for column slice zs = z + n pass of a cluster of n blocks, in 8
// warps: warp w takes rows 16 (w % 4).. and the 64 columns of half w / 4
// of the block's slice (cluster.cuh).  Per key tile it computes its
// partial S over those 64 columns and stores it; the cluster's 2n partials
// of its rows are summed in rank order, so every warp of the rows, in
// every block, holds the same S, the same running max and sum, and the same
// P bits; the warp accumulates O's 64 columns of its half.  Q and the K/V
// tiles (a two-stage ring) come in by TMA; the frame table is read from
// device memory at any F.  Slice 0's first half writes the LSE.  Past 8
// slices (kX) a block adds its other slices' partials from device memory
// (cluster.cuh §add_other_slices), each warp its half's columns of them.
constexpr int kClFwdWarps = 2 * kRowGroups;
constexpr int kClFwdThreads = kClFwdWarps * 32;
constexpr int kClFwdNT = kFwdTile / 8;                          // a warp's 8-key n-tiles
constexpr int kClFwdPart = kClFwdWarps * 32 * 4 * kClFwdNT;     // floats of the warps' partials
constexpr int kClFwdSums = kRowGroups * 32 * 4 * kClFwdNT;      // ... of the row groups' sums (cluster.cuh)
constexpr size_t kClFwdSmem = sizeof(float) * ((size_t)(kRows + 4 * kFwdTile) * kSliceLd + kClFwdPart +
                                               kClFwdSums) +
                              sizeof(int) * 2 * kFwdTile + 3 * sizeof(uint64_t);

template <int TM, bool kX>
__global__ void __launch_bounds__(kClFwdThreads, 1)
flash_fwd_cl(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ key_mask, const float* __restrict__ fb, const int* __restrict__ fid,
             float* __restrict__ o, float* __restrict__ lse, int H, int T, int dh, int F, float scale, int pass) {
  constexpr int kLd = kSliceLd;
  constexpr int NT = kClFwdNT;
  constexpr int NV = kHalf / 8;  // a warp's 8-column output tiles
  constexpr bool kFrames = TM != kNoTable;
  const int z = (int)cg::this_cluster().block_rank();
  const int zs = slice_of<kX>(z, pass);  // the slice this block stages and accumulates
  const bool own = owns<kX>(zs, dh);     // (else it stages slice 0 and adds only its other slices' partials)
  const int cz = kSlice * (own ? zs : 0);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % kRowGroups, hc = kHalf * (warp / kRowGroups);  // the warp's rows, its half's columns

  extern __shared__ __align__(128) float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);                       // kRows x kLd
  float* Ks = Qs + kRows * kLd;                                       // 2 stages x kFwdTile x kLd
  float* Vs = Ks + 2 * kFwdTile * kLd;                                // 2 stages x kFwdTile x kLd
  float* Sp = Vs + 2 * kFwdTile * kLd;                                // kClFwdPart: the warps' partial S
  float* Ss = Sp + kClFwdPart;                                        // kClFwdSums: the row groups' sums
  int* codes = reinterpret_cast<int*>(Ss + kClFwdSums);              // 2 stages x kFwdTile
  uint64_t* bars = reinterpret_cast<uint64_t*>(codes + 2 * kFwdTile);  // Q, then the K/V stages
  const float* fbg = head_table(fb, h, F, kFrames);
  const float fb0 = kFrames || fb == nullptr ? 0.f : fb[h];

  const size_t base = (size_t)bh * T * dh;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i);
    mbar_fence_init();
  }
  __syncthreads();
  auto stage = [&](int s, int j0) {
    if (tid == 0) {
      mbar_expect(bars + 1 + s, 2 * box_bytes(kFwdTile));
      tma_load(Ks + s * kFwdTile * kLd, &kmap, cz, j0, bh, bars + 1 + s);
      tma_load(Vs + s * kFwdTile * kLd, &vmap, cz, j0, bh, bars + 1 + s);
    }
    if (tid < kFwdTile) codes[s * kFwdTile + tid] = key_code<kFrames>(key_mask, fid, b, j0 + tid, T);
  };
  if (tid == 0) {
    mbar_expect(bars, box_bytes(kRows));
    tma_load(Qs, &qmap, cz, q0, bh, bars);
  }
  stage(0, 0);

  const int r0 = q0 + rg * 16 + g, r1 = r0 + 8;  // this lane's two rows
  const int fq0 = kFrames && r0 < T ? fid[r0] : 0;
  const int fq1 = kFrames && r1 < T ? fid[r1] : 0;
  const float* Qw = Qs + rg * 16 * kLd + hc;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;  // l: this lane's part of the sum
  float acc[NV][4];
  zero(acc);
  mbar_wait(bars, 0);  // the Q rows

  bool peers = false;  // a tile before this one: its sums may still be read
  const int ntiles = (T + kFwdTile - 1) / kFwdTile;
  for (int it = 0; it < ntiles; ++it) {
    const int s = it & 1;
    __syncthreads();  // tile it's key codes are in; every warp is done with tile it - 1
    if (it + 1 < ntiles) stage(s ^ 1, (it + 1) * kFwdTile);
    mbar_wait(bars + 1 + s, (it >> 1) & 1);  // tile it's K and V
    const float* Kt = Ks + s * kFwdTile * kLd + hc;
    const float* Vt = Vs + s * kFwdTile * kLd + hc;
    const int* ct = codes + s * kFwdTile;

    // S = Q K^T (16 rows x 32 keys a warp): the warp's partial over its 64
    // columns, summed over the block's two halves and the cluster's blocks
    float sc[NT][4];
    zero(sc);
    if (own) scores<NT, false, kHalf, kOnePass, kClChunk, kLd>(sc, sc, Qw, Kt, Qw, Kt, g, t);
    if constexpr (kX)
      add_other_slices<NT>(sc, q + base, k + base, q0 + rg * 16, it * kFwdTile, T, dh, z, pass, g, t, hc, kHalf);
    sum_halves<NT>(sc, Sp, Ss, warp, lane, peers);

    // online softmax on the C fragments: rows g (c0, c1) and g + 8 (c2, c3)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = ct[8 * j + 2 * t + e];
        float x0, x1;
        if (c >= 0) {
          x0 = sc[j][e] * scale + bias<TM>(nullptr, fbg, fb0, F, fq0, c);
          x1 = sc[j][2 + e] * scale + bias<TM>(nullptr, fbg, fb0, F, fq1, c);
        } else {
          x0 = x1 = c == kMasked ? kNeg : -INFINITY;
        }
        sc[j][e] = x0;
        sc[j][2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] = expf(sc[j][e] - mn0);
        sc[j][2 + e] = expf(sc[j][2 + e] - mn1);
        l0 += sc[j][e];
        l1 += sc[j][2 + e];
      }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
    accumulate<NT, NV, kLd>(acc, sc, Vt, g, t);  // O += P V over the half's columns
  }
  cluster_wait();  // no peer reads this block's sums any more

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (own) store_rows(o + base, acc, r0, cz + hc, T, dh, t, 1.f / l0, 1.f / l1);
  if (t == 0 && zs == 0 && hc == 0) {
    if (r0 < T) lse[(size_t)bh * T + r0] = m0 + logf(l0);
    if (r1 < T) lse[(size_t)bh * T + r1] = m1 + logf(l1);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DK>
int launch_fwd(const float* q, const float* k, const float* v, const float* key_mask, const float* fb,
               const int* fid, float* o, float* lse, int B, int H, int T, int dh, int F, float scale,
               cudaStream_t stream) {
  using HD = HeadDim<DK>;
  const bool frames = F > 1;
  const int tm = table_mode(F);
  const size_t smem = sizeof(float) * (size_t)(kRows + 4 * kFwdTile) * HD::kLd +
                      sizeof(int) * 2 * kFwdTile + (frames ? sizeof(float) * table_floats(F) : 0);
  auto fwd = tm == kNoTable ? flash_fwd<DK, kNoTable>
             : tm == kSmemTable ? flash_fwd<DK, kSmemTable> : flash_fwd<DK, kGlobalTable>;
  cudaError_t e = set_smem(fwd, smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec = dh % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  const dim3 grid((T + kRows - 1) / kRows, B * H);
  fwd<<<grid, kThreads, smem, stream>>>(q, k, v, key_mask, fb, fid, o, lse, H, T, dh, F, scale, vec);
  return (int)cudaGetLastError();
}

// Past head dim 128: flash_fwd_cl as clusters of n blocks (the wrapper's
// plan), one launch a pass (cluster.cuh §passes_of; dh % 4 == 0: the
// wrapper pads)
int launch_fwd_cl(const float* q, const float* k, const float* v, const float* key_mask, const float* fb,
                  const int* fid, float* o, float* lse, int B, int H, int T, int dh, int F, float scale, int n,
                  cudaStream_t s) {
  const int BH = B * H;
  CUtensorMap qr, kt, vt;  // the resident Q rows, the streamed K / V tiles
  cudaError_t e = row_map(&qr, q, BH, T, dh, kRows);
  if (e == cudaSuccess) e = row_map(&kt, k, BH, T, dh, kFwdTile);
  if (e == cudaSuccess) e = row_map(&vt, v, BH, T, dh, kFwdTile);
  if (e != cudaSuccess) return (int)e;
  const int passes = passes_of(dh, n);
  const bool frames = F > 1;
  auto fwd = passes > 1 ? (frames ? flash_fwd_cl<kGlobalTable, true> : flash_fwd_cl<kNoTable, true>)
                        : (frames ? flash_fwd_cl<kGlobalTable, false> : flash_fwd_cl<kNoTable, false>);
  for (int p = 0; p < passes; ++p) {
    e = launch_cluster(fwd, dim3((T + kRows - 1) / kRows, BH, n), kClFwdThreads, kClFwdSmem, n, s, qr, kt, vt,
                       q, k, key_mask, fb, fid, o, lse, H, T, dh, F, scale, p);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <int DK>
int launch_bwd(const float* q, const float* k, const float* v, const float* dout, const float* lse,
               const float* delta, const float* key_mask, const float* fb, const int* fid, float* dq,
               float* dk, float* dv, float* dfb_part, DsT* ds, int B, int H, int T, int dh, int F,
               float scale, cudaStream_t s) {
  using HD = HeadDim<DK>;
  const bool vec = dh % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(dout);
  const bool frames = F > 1;
  const int tiles = (T + kRows - 1) / kRows;
  const size_t rows_bytes = sizeof(float) * (size_t)(2 * kRows + 4 * kTileB) * HD::kLd;
  const int tm = table_mode(F);
  const size_t fb_bytes = frames ? sizeof(float) * table_floats(F) : 0;

  const size_t smem_kv = rows_bytes + sizeof(float) * 4 * kTileB + sizeof(int) * 2 * kTileB + fb_bytes;
  const bool emit = ds != nullptr;
  decltype(&flash_bwd_dkv<DK, kNoTable, true>) dkv =
      emit ? (tm == kNoTable ? flash_bwd_dkv<DK, kNoTable, true>
              : tm == kSmemTable ? flash_bwd_dkv<DK, kSmemTable, true>
                                 : flash_bwd_dkv<DK, kGlobalTable, true>)
           : (tm == kNoTable ? flash_bwd_dkv<DK, kNoTable, false>
              : tm == kSmemTable ? flash_bwd_dkv<DK, kSmemTable, false>
                                 : flash_bwd_dkv<DK, kGlobalTable, false>);
  cudaError_t e = set_smem(dkv, smem_kv);
  if (e != cudaSuccess) return (int)e;
  dkv<<<dim3(tiles, B * H), kThreads, smem_kv, s>>>(
      q, k, v, dout, lse, delta, key_mask, fb, fid, dk, dv, ds, H, T, dh, F, scale, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || emit) return (int)e;

  const size_t smem_q = rows_bytes + sizeof(int) * 2 * kTileB + fb_bytes +
                        (frames ? sizeof(float) * kWarps * 16 * kDsLd : 0);
  const int frame_tiles = frames ? (F + kFrameTile - 1) / kFrameTile : 0;
  decltype(&flash_bwd_dq<DK, kNoTable>) dqk =
      tm == kNoTable ? flash_bwd_dq<DK, kNoTable>
      : tm == kSmemTable ? flash_bwd_dq<DK, kSmemTable> : flash_bwd_dq<DK, kGlobalTable>;
  e = set_smem(dqk, smem_q);
  if (e != cudaSuccess) return (int)e;
  dqk<<<dim3(tiles, B * H, frame_tiles > 1 ? frame_tiles : 1), kThreads, smem_q, s>>>(
      q, k, v, dout, lse, delta, key_mask, fb, fid, dq, dfb_part, H, T, dh, F, scale, vec);
  return (int)cudaGetLastError();
}

// shared bytes of the cluster kernels: flash_bwd_dkv_cl, and flash_bwd_dq_cl with or without frames
constexpr size_t kClDkvSmem = sizeof(float) * ((size_t)(2 * kRows + 4 * kTileB) * kSliceLd + 2 * kClPart +
                                               4 * kTileB) +
                              sizeof(int) * 2 * kTileB + 3 * sizeof(uint64_t);
__host__ inline size_t cl_dq_smem(bool frames) {
  return sizeof(float) * ((size_t)(2 * kRows + 4 * kTileB) * kSliceLd + 2 * kClPart +
                          (frames ? kWarps * 16 * kDsLd : 0)) +
         sizeof(int) * 2 * kTileB + 3 * sizeof(uint64_t);
}

// Past head dim 128: flash_bwd_dkv_cl, then (recompute mode) flash_bwd_dq_cl,
// each as clusters of n blocks (the wrapper's plan), one launch a pass
// (cluster.cuh §passes_of; dh % 4 == 0: the wrapper pads).  The dq
// kernel's frame tiles (F > 64) are folded into grid.x: ceil(tiles of
// frames / n) groups of clusters, group c's rank z summing frame tile c n
// + z, group 0 also computing dq.
int launch_bwd_cl(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                  const float* delta, const float* key_mask, const float* fb, const int* fid, float* dq,
                  float* dk, float* dv, float* dfb_part, DsT* ds, int B, int H, int T, int dh, int F,
                  float scale, int n, cudaStream_t s) {
  const int BH = B * H;
  const bool frames = F > 1, emit = ds != nullptr;
  const int passes = passes_of(dh, n);
  const int tiles = (T + kRows - 1) / kRows;
  CUtensorMap qt, ot, kr, vr;  // the streamed Q / dO tiles, the resident K / V rows
  cudaError_t e = row_map(&qt, q, BH, T, dh, kTileB);
  if (e == cudaSuccess) e = row_map(&ot, dout, BH, T, dh, kTileB);
  if (e == cudaSuccess) e = row_map(&kr, k, BH, T, dh, kRows);
  if (e == cudaSuccess) e = row_map(&vr, v, BH, T, dh, kRows);
  if (e != cudaSuccess) return (int)e;
  const bool x = passes > 1;  // the instances that add a block's other slices
  using Dkv = decltype(&flash_bwd_dkv_cl<kNoTable, false, kDkv>);
  Dkv parts[2];  // one launch (dK and dV), or past 8 slices two (dV alone, then dK alone)
  if (!x)
    parts[0] = emit ? (frames ? flash_bwd_dkv_cl<kGlobalTable, true, kDkv> : flash_bwd_dkv_cl<kNoTable, true, kDkv>)
                    : (frames ? flash_bwd_dkv_cl<kGlobalTable, false, kDkv> : flash_bwd_dkv_cl<kNoTable, false, kDkv>);
  else {
    parts[0] = frames ? flash_bwd_dkv_cl<kGlobalTable, false, kDvX> : flash_bwd_dkv_cl<kNoTable, false, kDvX>;
    parts[1] = emit ? (frames ? flash_bwd_dkv_cl<kGlobalTable, true, kDkX> : flash_bwd_dkv_cl<kNoTable, true, kDkX>)
                    : (frames ? flash_bwd_dkv_cl<kGlobalTable, false, kDkX> : flash_bwd_dkv_cl<kNoTable, false, kDkX>);
  }
  for (int p = 0; p < passes; ++p)
    for (int i = 0; i < (x ? 2 : 1); ++i) {
      e = launch_cluster(parts[i], dim3(tiles, BH, n), kThreads, kClDkvSmem, n, s, qt, ot, kr, vr, q, k, v,
                         dout, lse, delta, key_mask, fb, fid, dk, dv, ds, H, T, dh, F, scale, p);
      if (e != cudaSuccess) return (int)e;
    }
  if (emit) return 0;
  CUtensorMap qr, orr, kt, vt;  // the resident Q / dO rows, the streamed K / V tiles
  e = row_map(&qr, q, BH, T, dh, kRows);
  if (e == cudaSuccess) e = row_map(&orr, dout, BH, T, dh, kRows);
  if (e == cudaSuccess) e = row_map(&kt, k, BH, T, dh, kTileB);
  if (e == cudaSuccess) e = row_map(&vt, v, BH, T, dh, kTileB);
  if (e != cudaSuccess) return (int)e;
  // dq (and the frame sums), a launch a pass; past 8 slices the frame sums in a launch of their own
  auto dqk = frames ? (x ? flash_bwd_dq_cl<kGlobalTable, kDqX> : flash_bwd_dq_cl<kGlobalTable, kDq>)
                    : (x ? flash_bwd_dq_cl<kNoTable, kDqX> : flash_bwd_dq_cl<kNoTable, kDq>);
  const int frame_tiles = frames ? (F + kFrameTile - 1) / kFrameTile : 0;
  const int groups = frames ? (frame_tiles + n - 1) / n : 1;
  for (int p = 0; p < passes; ++p) {
    e = launch_cluster(dqk, dim3(tiles * (x ? 1 : groups), BH, n), kThreads, cl_dq_smem(frames && !x), n, s,
                       qr, orr, kt, vt, q, k, v, dout, lse, delta, key_mask, fb, fid, dq, dfb_part, H, T, dh, F,
                       scale, p);
    if (e != cudaSuccess) return (int)e;
  }
  if (x && frames)
    e = launch_cluster(flash_bwd_dq_cl<kGlobalTable, kFrX>, dim3(tiles * groups, BH, n), kThreads,
                       cl_dq_smem(true), n, s, qr, orr, kt, vt, q, k, v, dout, lse, delta, key_mask, fb, fid, dq,
                       dfb_part, H, T, dh, F, scale, 0);
  return (int)e;
}

}  // namespace

// delta = rowsum(dout * o) of (rows, dh) matrices, the backward's input
extern "C" int vog_flash_delta(int device, const float* o, const float* dout, float* delta, int rows, int dh,
                               void* stream) {
  VOG_DEVICE_GUARD(device);
  if (rows == 0) return 0;
  flash_bwd_delta<<<(rows + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(o, dout, delta,
                                                                                rows, dh);
  return (int)cudaGetLastError();
}

// fb and fid may be null when F == 1 (no bias).  Recompute mode (ds null):
// dq, and dfb_part (B, H, ceil(T / 64), F, F), written only when F > 1.
// Emit mode (ds, (B*H, T, T), fp32, or bf16 in the one-pass library, not
// null): dk, dv and ds only; dq and dfb_part are not touched.  dh 64 and
// 128 (dh padded up to them), past 128 the cluster kernels (dh % 4 == 0,
// 16-byte-aligned rows) as clusters of n blocks (n is read only there).
extern "C" int vog_flash_bwd(int device, const float* q, const float* k, const float* v,
                             const float* dout, const float* lse,
                             const float* delta, const float* key_mask,
                             const float* fb, const int* fid, float* dq,
                             float* dk, float* dv, float* dfb_part, void* ds_out,
                             int B, int H, int T, int dh, int F, float scale, int n,
                             void* stream) {
  VOG_DEVICE_GUARD(device);
  if (dh < 1 || F < 1) return (int)cudaErrorInvalidValue;
  if (B * H == 0 || T == 0) return 0;
  DsT* ds = static_cast<DsT*>(ds_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 64)
    return launch_bwd<64>(q, k, v, dout, lse, delta, key_mask, fb, fid, dq, dk, dv, dfb_part, ds, B, H, T, dh, F,
                          scale, s);
  if (dh <= 128)
    return launch_bwd<128>(q, k, v, dout, lse, delta, key_mask, fb, fid, dq, dk, dv, dfb_part, ds, B, H, T, dh,
                           F, scale, s);
  if (dh % 4 != 0 || !cluster_fits(dh, n)) return (int)cudaErrorInvalidValue;
  return launch_bwd_cl(q, k, v, dout, lse, delta, key_mask, fb, fid, dq, dk, dv, dfb_part, ds, B, H, T, dh, F,
                       scale, n, s);
}

// Clusters of n blocks of the cluster kernels resident at once
// (cudaOccupancyMaxActiveClusters): which 0, flash_bwd_dkv_cl (recompute);
// 1, flash_bwd_dq_cl; 2, flash_fwd_cl; with frames when F > 1
extern "C" int vog_flash_clusters(int device, int n, int F, int which) {
  VOG_DEVICE_GUARD(device);
  const bool frames = F > 1;
  if (which == 0)
    return max_active_clusters(
        frames ? flash_bwd_dkv_cl<kGlobalTable, false, kDkv> : flash_bwd_dkv_cl<kNoTable, false, kDkv>, kThreads,
        kClDkvSmem, n);
  if (which == 1)
    return max_active_clusters(frames ? flash_bwd_dq_cl<kGlobalTable, kDq> : flash_bwd_dq_cl<kNoTable, kDq>,
                               kThreads, cl_dq_smem(frames), n);
  return max_active_clusters(frames ? flash_fwd_cl<kGlobalTable, false> : flash_fwd_cl<kNoTable, false>,
                             kClFwdThreads, kClFwdSmem, n);
}

// fb and fid may be null when F == 1 (no bias).  dh 64 and 128 (dh padded
// up to them), past 128 flash_fwd_cl (dh % 4 == 0, 16-byte-aligned rows)
// as clusters of n blocks (n is read only there).
extern "C" int vog_flash_fwd(int device, const float* q, const float* k, const float* v,
                             const float* key_mask, const float* fb,
                             const int* fid, float* o, float* lse, int B,
                             int H, int T, int dh, int F, float scale, int n,
                             void* stream) {
  VOG_DEVICE_GUARD(device);
  if (dh < 1 || F < 1) return (int)cudaErrorInvalidValue;
  if (B * H == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 64) return launch_fwd<64>(q, k, v, key_mask, fb, fid, o, lse, B, H, T, dh, F, scale, s);
  if (dh <= 128) return launch_fwd<128>(q, k, v, key_mask, fb, fid, o, lse, B, H, T, dh, F, scale, s);
  if (dh % 4 != 0 || !cluster_fits(dh, n)) return (int)cudaErrorInvalidValue;
  return launch_fwd_cl(q, k, v, key_mask, fb, fid, o, lse, B, H, T, dh, F, scale, n, s);
}
