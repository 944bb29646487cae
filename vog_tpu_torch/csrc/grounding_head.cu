// Fused cross-MLP grounding head forward, fp32 results:
//
//   logit[b,a,t] = w2 . relu( W1^T relu( wv[b,t] + wl[b,a] + Wx^T (vis[b,t] * arg[b,a]) ) + b1 ) + b2
//
// Replaces vog_tpu/kernels/grounding_head.py §_fwd_call (_fwd_kernel).  The
// plain math materialises four (B,A,T,D) intermediates; this kernel keeps
// them on chip and writes only the (B,A,T) logits.  The work is 2 B A T
// (D^2 + D Dh) (12.6 GFLOP at GT5: B=16, A=5, T=200, D=512, Dh=256; 31.5 at
// P100: B=2, T=4000) against ~13 MB of inputs: bound by operations.  Plain
// TF32 would miss the 1e-4 parity bound, so the products run on the tensor
// cores in 3xTF32: each fp32 operand x is split into big = x with its low 13
// mantissa bits cleared and small = x - big, and a.b is taken as
// a_small.b_big + a_big.b_small + a_big.b_big (fp32-level accuracy).
//
// On the H100 half of the bound needs ~250 TFLOP/s of TF32 issue, which
// mma.sync does not reach (60-110 in the port's kernels), so the products
// are Hopper's warpgroup wgmma (m64nNk8, A from registers, B from shared
// memory).  Design (head_fwd_prep + head_fwd):
//  * head_fwd_prep, once a call: Wx^T and W1^T as one stream in the order
//    head_fwd reads them, each 8-wide k-step in the K-major core matrices
//    that TF32 wgmma takes for B (8 n-rows x 4 k, 128 bytes), zero-padded
//    to D_pad = ceil(D / 64) 64 and Dh to 256, the k of a step in pair
//    order (slot t <- k 2t, slot t + 4 <- k 2t + 1) so that A fragments
//    come from float2 reads and, for the second product, straight from the
//    first product's accumulators; each 16 KB stage holds its weights split
//    once (big parts, then small parts), so no block splits them again;
//  * head_fwd: a persistent grid (one 128-thread block, one warpgroup, an
//    SM) walks the items (64 flattened (b, t) rows, one arg): the cross
//    tile vis * arg_a (64 x D_pad) is built in shared memory by cp.async
//    (the next item's rows prefetched into L2 meanwhile), then for each
//    64-column chunk of z0: acc1 = cross . Wx[:, chunk] (K = D_pad), then
//    h = relu(acc1 + wv + wl) is split in registers into the A fragments of
//    acc2 += h . W1[chunk, :] (N = 256): the (64, D) hidden tile never
//    exists, the z1 accumulator stays in registers over the chunks, and the
//    w2 dot ends the item with a 4-lane shuffle a row.  The stream comes in
//    by cp.async.bulk (the copy engine, an mbarrier a stage) into a ring of
//    4, three stages ahead, with no block barrier a stage; one wgmma group
//    a pair of z0 k-steps (four A fragment sets in flight) or a z1 k-step.
//    Items are (row tile, arg), so any A takes one launch and the grid
//    stays full (GT5: 250 items, P100: 625, on 132 SMs).
// What bounds it: the wgmma chains of one warpgroup (each k-step's group
// waits for the one before last, so the tensor pipe holds one or two small
// groups), then the weight loads (the ring is as deep as the 133 KB cross
// tile leaves room for: three stages ahead, about one bulk-copy latency),
// then the cross build at each item's start.  Tried first and not kept
// (slower than this design on the card): each stage split by the block
// itself between the wgmma groups, with a per-stage block barrier (the
// first design, times in PERF.md); a producer warpgroup splitting the
// stages (one stage of slack between the two roles); each thread copying
// only its own cross elements, 8 bytes at a time.
// The previous design (a 512-thread block owning (b, 16 tokens) for all A
// args, 3xTF32 mma.sync, every warp re-reading and re-splitting its weight
// columns from L2 one k-step ahead) took 0.3680 / 0.3651 ms at GT5 and
// 0.7205 ms at P100 (chip_smoke.py, H100 80GB HBM3, 700 W); this design's
// times are in PERF.md.
//
// Backward (vog_tpu/kernels/grounding_head.py §_fused_head_bwd, all 9
// gradients).  The TPU kernel keeps the (D,D) and (D,Dh) weight-gradient
// accumulators resident in VMEM across its whole grid; a 1 MB fp32
// accumulator does not fit a block's 227 KB here, and blocks run in no
// order.  The work is 6 B A T (D^2 + D Dh) = 37.7 GFLOP at GT5 (four row
// products and two weight products), bound by operations.  Up to D 512 and
// Dh 256 (the narrow path, every production shape) it runs on wgmma:
// head_bwd_prep, head_bwd_rows_wg, head_bwd_w_wg and head_bwd_finish (their
// section below says how).  Past either width (the wide path, W) two
// kernels on mma.sync:
//
//   head_bwd_rows  per (b, 16 tokens) block: it recomputes z0, h and z1,
//                  forms dz1 = [z1 > 0] g w2, dh = dz1 W1^T, dz0 = [z0 > 0]
//                  dh and dcross = dz0 Wx^T (four products; each warp
//                  streams its own weight columns by cp.async, 8 k-rows a
//                  stage, into a ring of 3: ``gemm_rows``); it writes dvis,
//                  dwv, per-block partials of darg, dwl, db1, dw2, and the
//                  cross rows, h, dz0, dz1 (B,A,T,.) for the second kernel;
//   head_bwd_w     dWx = sum_rows cross^T dz0 and dW1 = sum_rows h^T dz1
//                  in one launch: a 128 x 64 output tile of either a block,
//                  8 warps of 32 x 32, rows streamed 32 a stage by cp.async
//                  into a ring of 3, one partial per row chunk.
//
// The two overlap (``launch_bwd``): the batch rows whose row blocks fit one
// wave run first, and the weight kernel's chunks over their rows fill the
// SMs that the row kernel's second wave, on a second stream, leaves idle.
// Every partial is added up by the wrapper in a fixed order, so the
// gradients are the same on every run.  These two kernels ran the narrow
// path too until the wgmma design (their times there in PERF.md).
//
// Widths: D % 32 == 0 and Dh % 16 == 0 (the wrapper zero-pads others,
// exactly).  Up to D 512 and Dh 256 the kernels run their narrow path.
// Past either they take their wide path (template flag W): the
// forward computes z0 once, by K slices of 512 columns of the cross tile,
// into a scratch of device memory, then z1 a group of 256 columns at a
// time (the stream lays W1 out a group at a time after each chunk's z0
// stages; head_fwd's comment says more); the row
// kernel's warps walk column groups, over K slices of 512 staged from the
// (B, A, T, .) rows it writes for the weight kernel anyway (cross, h, dz1,
// dz0), its tile the narrow path's at D 512, so A = 5 fits at any D; the
// weight kernel's 128 x 64 tiles walk any D (the wrapper's row chunks fall
// with D, so its partials stay near D^2 floats).
//
// Precision: this file builds twice (kernels/_build.py).  As it is, every
// product is 3xTF32 ("highest"); with -DVOG_ONE_PASS=1 ("default", the
// production recipe's) every product is one TF32 pass, operands rounded to
// nearest (tf32.cuh): head_fwd_prep lays out one rounded part a stage (the
// weight stream halves, and the ring holds twice the stages in the same
// shared memory), each k-step issues one wgmma, not three, and the
// wide backward's mma.sync products take one pass (split, mma_p).  The
// operands stay fp32, as the JAX package keeps them.


#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

#include "tiles.cuh"  // cp.async; through it tf32.cuh: split, mma_p, round_tf32, kOnePass
#include "hopper.cuh"  // wgmma, mbarriers, bulk copies
#include "device.cuh"  // DeviceGuard: every entry point runs on its tensors' device

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kBT = 16;  // tokens per block of the backward's row kernel: rows M = A * kBT
// The widest D and Dh of the narrow path (whole cross tiles, one z1
// accumulator); past either the kernels take their wide path (W)
constexpr int kMaxD = 512;
constexpr int kMaxHid = 256;  // Dh
constexpr int kN1 = 32;  // first-product columns per warp (4 n-tiles)
constexpr int kN2 = 16;  // second-product columns per warp (2 n-tiles)

// ---------------------------------------------------------------------------
// forward: kernels
// ---------------------------------------------------------------------------
constexpr int kFRows = 64;           // rows of an item: 64 flattened (b, t) tokens, one arg
constexpr int kFThreads = 128;       // one warpgroup
constexpr int kNC = 64;              // z0 columns a chunk (acc1: 64 x 64)
constexpr int kNZ = 256;             // z1 columns, Dh padded (acc2: 64 x 256)
constexpr int kStep1 = kNC * 8;      // floats of a z0 k-step (2 KB)
constexpr int kStep2 = kNZ * 8;      // floats of a z1 k-step (8 KB)
constexpr int kParts = kOnePass ? 1 : 2;  // parts a weight is stored as: rounded, or big and small
constexpr int kStage = kParts * kStep2;   // floats a stage: 4 z0 k-steps or 1 z1 k-step, each part
constexpr int kFRing = 8 / kParts;   // stages of the weight ring (64 KB: loads 3 or 7 stages ahead)
constexpr int kWvLd = kNC + 8;       // row stride of the wv chunk tile (8 mod 32 words)
constexpr int kFK = kMaxD;           // the wide path's cross tile: a K slice of 512 columns
constexpr uint32_t kBigMask = 0xffffe000u;

// z1 column groups of 256 (the wide path's passes over z0; 1 up to Dh 256)
__host__ __device__ inline int hidden_groups(int Dh) { return (Dh + kNZ - 1) / kNZ; }
// floats of a chunk's weights: D_pad / 8 z0 k-steps, then 8 z1 k-steps a hidden group
__host__ __device__ inline int chunk_floats(int Dp, int nhg) { return Dp / 8 * kStep1 + 8 * nhg * kStep2; }

// The weight stream: stages of kStep2 weights, chunk c = 0 .. D_pad / 64 - 1
// after chunk: 4 z0 k-steps a stage (k 8s .. 8s + 7 of Wx's rows, columns
// 64c ..), then for each hidden group hg 8 stages of one z1 k-step (W1
// rows 64c + 8j .., columns 256 hg .. 256 hg + 255, zero past Dh).  A
// k-step is [k half][n / 8][n % 8][k slot 0-3]; slot u of half e holds k
// 2u + e of the step (pair order).  Each stage is stored twice: its big
// parts (low 13 mantissa bits cleared), then its small parts; in a
// one-pass library once, each weight rounded to the nearest TF32.
// the forward stream's float o (parts included)
// (``natural``: the z0 k-steps in natural order, slot u of half e holding k
// 4e + u, for an A operand read from shared memory; else in pair order)
__device__ inline float fwd_stream_value(size_t o, const float* __restrict__ wx, const float* __restrict__ w1,
                                         int D, int Dp, int Dh, bool natural = false) {
  const int per = chunk_floats(Dp, hidden_groups(Dh));
  const int stage = (int)(o / kStage), part = kOnePass ? 0 : (int)(o / kStep2) & 1;
  const int raw = stage * kStep2 + (int)(o % kStep2);  // the weight's place in the unsplit stream
  const int c = raw / per, r = raw - c * per;
  const int z1 = r >= Dp / 8 * kStep1;
  const int step = z1 ? (r - Dp / 8 * kStep1) / kStep2 : r / kStep1;  // z1: 8 hg + j
  const int w = z1 ? (r - Dp / 8 * kStep1) % kStep2 : r % kStep1;
  const int u = w & 3, n8 = (w >> 2) & 7, half = w / (z1 ? kStep2 / 2 : kStep1 / 2);
  const int ng = (w % (z1 ? kStep2 / 2 : kStep1 / 2)) >> 5;
  const int n = 8 * ng + n8, kk = 8 * (z1 ? step % 8 : step) + (natural && !z1 ? 4 * half + u : 2 * u + half);
  float v = 0.f;
  if (z1) {  // W1 row 64c + kk, column 256 hg + n
    const int k = kNC * c + kk, col = kNZ * (step / 8) + n;
    if (k < D && col < Dh) v = w1[(size_t)k * Dh + col];
  } else {  // Wx row kk, column 64c + n
    const int col = kNC * c + n;
    if (kk < D && col < D) v = wx[(size_t)kk * D + col];
  }
  if constexpr (kOnePass) return __uint_as_float(round_tf32(v));
  const float big = __uint_as_float(__float_as_uint(v) & kBigMask);
  return part ? v - big : big;
}

__global__ void __launch_bounds__(256)
head_fwd_prep(const float* __restrict__ wx, const float* __restrict__ w1,
              float* __restrict__ stream, int D, int Dp, int Dh) {
  const int total = kParts * (Dp / kNC) * chunk_floats(Dp, hidden_groups(Dh));
  for (int o = blockIdx.x * blockDim.x + threadIdx.x; o < total; o += gridDim.x * blockDim.x)
    stream[o] = fwd_stream_value(o, wx, w1, D, Dp, Dh);
}

// W: the wide path (D_pad > 512 or Dh > 256), where neither the whole
// cross tile (64 x D_pad floats: 133 KB at D 512) nor the z1 accumulator
// of Dh columns (128 registers a lane hold 256) fits.  An item runs in two
// phases.  (1) z0 = cross . Wx by K slices of kFK columns: the cross tile
// holds one slice, built once an item, and each chunk's stages of that
// slice add into the chunk's accumulators, which a thread keeps between
// slices in its own places of the block's scratch rows in device memory
// (``zs``, 64 x D_pad floats a block; its C-fragment elements, so no
// barrier orders them).  (2) For each group of 256 z1 columns, each chunk's
// h = relu(z0 + wv + wl) from the scratch feeds z1 += h . W1[chunk,
// group], and the group adds its part of the logit.  z0 is computed once;
// the stream is read in this order (``stream_stage``).
template <bool W>
__global__ void __launch_bounds__(kFThreads, 1)
head_fwd(const float* __restrict__ vis, const float* __restrict__ arg,
         const float* __restrict__ wv, const float* __restrict__ wl,
         const float* __restrict__ wstream, const float* __restrict__ b1,
         const float* __restrict__ w2, const float* __restrict__ b2,
         float* __restrict__ out, float* __restrict__ zs, int B, int A, int T, int D, int Dp,
         int Dh) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ldx = (W ? kFK : Dp) + 8;  // cross row stride: 8 mod 32 words, conflict-free float2 fragment reads
  extern __shared__ __align__(1024) float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // kFRing x kStage: a stage's big (or rounded) parts, then its small parts
  float* cross = ring + kFRing * kStage;          // kFRows x ldx
  float* wvs = cross + kFRows * ldx;              // kFRows x kWvLd: wv of the chunk's columns
  float* b1s = wvs + kFRows * kWvLd;              // kNZ, zero past Dh
  float* w2s = b1s + kNZ;                         // kNZ, zero past Dh
  uint64_t* full = reinterpret_cast<uint64_t*>(w2s + kNZ);  // kFRing: a stage has landed

  const int BT = B * T;
  const int nitems = (BT + kFRows - 1) / kFRows * A;
  const int nch = Dp / kNC, p1 = Dp / 32;  // chunks; z0 stages a chunk (4 k-steps a stage)
  const int nhg = W ? hidden_groups(Dh) : 1;  // z1 column groups: the wide path's passes of (2)
  const int nks = W ? (Dp + kFK - 1) / kFK : 1;  // K slices of the cross tile
  constexpr int kSliceStages = kFK / 32;         // z0 stages a full slice
  const int per_item = W ? nch * p1 + nhg * nch * 8 : nch * (p1 + 8);  // stages an item
  const int items = (nitems - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int total = items * per_item;     // stages this block reads
  // the stream's stage of an item's stage u: the narrow path reads the
  // stream in order; the wide path (1) slice by slice, each chunk's z0
  // stages of the slice, then (2) group by group, each chunk's 8 z1
  // stages of the group (a chunk holds its p1 z0 stages, then 8 a group)
  auto stream_stage = [&](int u) {
    if constexpr (!W) return u;
    const int L = p1 + 8 * nhg;
    if (u < nch * p1) {
      const int ks = min(u / (nch * kSliceStages), nks - 1), v = u - nch * kSliceStages * ks;
      const int sl = min(kSliceStages, p1 - kSliceStages * ks), c = v / sl;
      return c * L + kSliceStages * ks + (v - c * sl);
    }
    const int v = u - nch * p1, hg = v / (nch * 8), w = v - hg * nch * 8;
    return w / 8 * L + p1 + 8 * hg + w % 8;
  };

  if (tid == 0) {
    for (int r = 0; r < kFRing; ++r) mbar_init(full + r, 1);
    mbar_fence_init();
  }
  for (int i = tid; i < kNZ; i += kFThreads) {
    b1s[i] = i < Dh ? b1[i] : 0.f;
    w2s[i] = i < Dh ? w2[i] : 0.f;
  }
  __syncthreads();
  // stage q of the block's stream (stage q % per_item of an item) into ring slot q % kFRing
  auto issue = [&](int q) {
    if (q < total)
      bulk_load(ring + (q % kFRing) * kStage, wstream + (size_t)stream_stage(q % per_item) * kStage,
                kStage * 4, full + q % kFRing);
  };
  if (tid == 0)
    for (int q = 0; q < kFRing; ++q) issue(q);
  // after stage q's wgmmas are issued and every earlier stage's have
  // completed: refill the ring slot of stage q - 1
  auto refill = [&](int q) {
    if (tid == 0 && q >= 1) issue(q - 1 + kFRing);
  };

  const int r0 = 16 * warp + g;  // this thread's rows of an item: r0 and r0 + 8
  uint32_t fa[4][4], fs[4][4];    // A fragments (big, small; one pass: rounded, unused) of four k-steps in flight
  int q = 0;                      // the stage the next wgmma group reads
  for (int it = 0; it < items; ++it) {
    const int item = blockIdx.x + it * gridDim.x;
    const int row0 = item / A * kFRows, a = item % A;
    __syncthreads();  // every thread is done with the previous item's tiles
    // cross = vis * arg_a, columns k0 .. k0 + KW - 1 (KW = D_pad, or the
    // wide path's slice): the vis rows by cp.async (zero past BT and D),
    // then scaled in place
    auto build_cross = [&](int k0) {
      const int kw4 = W ? kFK / 4 : Dp / 4;
      for (int idx = tid; idx < kFRows * kw4; idx += kFThreads) {
        const int r = idx / kw4, c = 4 * (idx % kw4), n = row0 + r;
        const bool ok = n < BT && k0 + c < D;
        cp_async16(cross + r * ldx + c, ok ? vis + (size_t)n * D + k0 + c : vis, ok);
      }
      cp_commit();
      cp_wait_all();
#pragma unroll 4
      for (int idx = tid; idx < kFRows * kw4; idx += kFThreads) {  // the thread's own copies
        const int r = idx / kw4, c = 4 * (idx % kw4), n = row0 + r;
        if (n < BT && k0 + c < D) {
          float4* x = reinterpret_cast<float4*>(cross + r * ldx + c);
          const float4 w =
              __ldg(reinterpret_cast<const float4*>(arg + ((size_t)(n / T) * A + a) * D + k0 + c));
          const float4 v = *x;
          *x = make_float4(v.x * w.x, v.y * w.y, v.z * w.z, v.w * w.w);
        }
      }
    };
    if constexpr (!W) build_cross(0);
    if (it + 1 < items) {  // the next item's vis rows into L2 while this one runs
      const int nrow0 = (item + gridDim.x) / A * kFRows;
      for (int idx = tid; idx < kFRows * (Dp / 32); idx += kFThreads) {  // one 128-byte line each
        const int r = idx / (Dp / 32), c = 32 * (idx % (Dp / 32)), n = nrow0 + r;
        if (n < BT && c < D) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(vis + (size_t)n * D + c));
      }
    }
    // wl of this thread's rows (their (b, a)), read through L1 in the z1 epilogue
    const float* wl0 = wl + ((size_t)(min(row0 + r0, BT - 1) / T) * A + a) * D;
    const float* wl1 = wl + ((size_t)(min(row0 + r0 + 8, BT - 1) / T) * A + a) * D;
    float p0 = 0.f, p1r = 0.f;  // this thread's part of its two rows' logits
    if constexpr (W) {
      // this thread's z0 elements (its C-fragment places: rows r0, r0 + 8,
      // columns 8j + 2t, + 1 of a chunk) in the block's scratch rows
      float* z0r = zs + ((size_t)blockIdx.x * kFRows + r0) * Dp;
      float* z1r = z0r + 8 * (size_t)Dp;
      // (1) z0 = cross . Wx, a K slice of the cross tile at a time
#pragma unroll 1
      for (int ks = 0; ks < nks; ++ks) {
        __syncthreads();  // every thread has read its fragments of the slice before
        build_cross(kFK * ks);
        __syncthreads();
        const int sl = min(kSliceStages, p1 - kSliceStages * ks);
#pragma unroll 1
        for (int c = 0; c < nch; ++c) {
          float acc1[kNC / 2];  // the chunk's sums over the slices before (its own, so no barrier)
#pragma unroll
          for (int j = 0; j < kNC / 8; ++j) {
            const float2 zero2 = make_float2(0.f, 0.f);
            const float2 x0 = ks ? *reinterpret_cast<const float2*>(z0r + kNC * c + 8 * j + 2 * t) : zero2;
            const float2 x1 = ks ? *reinterpret_cast<const float2*>(z1r + kNC * c + 8 * j + 2 * t) : zero2;
            acc1[4 * j] = x0.x;
            acc1[4 * j + 1] = x0.y;
            acc1[4 * j + 2] = x1.x;
            acc1[4 * j + 3] = x1.y;
          }
#pragma unroll 1
          for (int s = 0; s < sl; ++s, ++q) {
            mbar_wait(full + q % kFRing, (q / kFRing) & 1);
            const float* sb = ring + (q % kFRing) * kStage;
#pragma unroll
            for (int pp = 0; pp < 2; ++pp) {  // a wgmma group of two k-steps
              float2 x[2][2];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int k0 = 8 * (4 * s + 2 * pp + h) + 2 * t;
                x[h][0] = *reinterpret_cast<const float2*>(cross + r0 * ldx + k0);
                x[h][1] = *reinterpret_cast<const float2*>(cross + (r0 + 8) * ldx + k0);
              }
              wg_wait<1>();  // the group that read fragment sets 2 pp, 2 pp + 1 has completed
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int f = 2 * pp + h;
                const float xs[4] = {x[h][0].x, x[h][1].x, x[h][0].y, x[h][1].y};
#pragma unroll
                for (int i = 0; i < 4; ++i) split<kOnePass>(xs[i], fa[f][i], fs[f][i]);
              }
              wg_fence();
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int f = 2 * pp + h, kk = 2 * pp + h;
                const uint64_t db = kmajor_desc(sb + kk * kStep1, kStep1 * 2, 128);
                if constexpr (!kOnePass) {
                  const uint64_t ds = kmajor_desc(sb + kStage / 2 + kk * kStep1, kStep1 * 2, 128);
                  wgmma_n64(acc1, fs[f], db);
                  wgmma_n64(acc1, fa[f], ds);
                }
                wgmma_n64(acc1, fa[f], db);
              }
              wg_commit();
            }
            refill(q);
          }
          wg_wait<0>();
#pragma unroll
          for (int j = 0; j < kNC / 8; ++j) {
            *reinterpret_cast<float2*>(z0r + kNC * c + 8 * j + 2 * t) = make_float2(acc1[4 * j], acc1[4 * j + 1]);
            *reinterpret_cast<float2*>(z1r + kNC * c + 8 * j + 2 * t) = make_float2(acc1[4 * j + 2], acc1[4 * j + 3]);
          }
        }
      }
      // (2) z1 += relu(z0 + wv + wl) . W1[chunk, group], a group of 256 columns a pass
#pragma unroll 1
      for (int hg = 0; hg < nhg; ++hg) {
        __syncthreads();  // every thread is done with the previous pass's b1 and w2
        for (int i = tid; i < kNZ; i += kFThreads) {  // zero past Dh
          const int n = kNZ * hg + i;
          b1s[i] = n < Dh ? b1[n] : 0.f;
          w2s[i] = n < Dh ? w2[n] : 0.f;
        }
        float acc2[kNZ / 2];
#pragma unroll
        for (int i = 0; i < kNZ / 2; ++i) acc2[i] = 0.f;
#pragma unroll 1
        for (int c = 0; c < nch; ++c) {
          __syncthreads();  // every thread is done with the previous chunk's wv
          for (int idx = tid; idx < kFRows * (kNC / 4); idx += kFThreads) {
            const int r = idx / (kNC / 4), cc = 4 * (idx % (kNC / 4)), n = row0 + r, col = kNC * c + cc;
            const bool ok = n < BT && col < D;
            cp_async16(wvs + r * kWvLd + cc, ok ? wv + (size_t)n * D + col : wv, ok);
          }
          cp_commit();
          float acc1[kNC / 2];  // z0 of the chunk, as (1) left it
#pragma unroll
          for (int j = 0; j < kNC / 8; ++j) {
            const float2 x0 = *reinterpret_cast<const float2*>(z0r + kNC * c + 8 * j + 2 * t);
            const float2 x1 = *reinterpret_cast<const float2*>(z1r + kNC * c + 8 * j + 2 * t);
            acc1[4 * j] = x0.x;
            acc1[4 * j + 1] = x0.y;
            acc1[4 * j + 2] = x1.x;
            acc1[4 * j + 3] = x1.y;
          }
          cp_wait_all();
          __syncthreads();  // every thread's wv copies are in
#pragma unroll
          for (int j = 0; j < kNC / 8; ++j, ++q) {
            const float2 v0 = *reinterpret_cast<const float2*>(wvs + r0 * kWvLd + 8 * j + 2 * t);
            const float2 v1 = *reinterpret_cast<const float2*>(wvs + (r0 + 8) * kWvLd + 8 * j + 2 * t);
            const int col = kNC * c + 8 * j + 2 * t;  // D is even: both columns or neither lie below D
            const float2 zero2 = make_float2(0.f, 0.f);
            const float2 l0 = col < D ? __ldg(reinterpret_cast<const float2*>(wl0 + col)) : zero2;
            const float2 l1 = col < D ? __ldg(reinterpret_cast<const float2*>(wl1 + col)) : zero2;
            const float hs[4] = {fmaxf(acc1[4 * j] + v0.x + l0.x, 0.f), fmaxf(acc1[4 * j + 2] + v1.x + l1.x, 0.f),
                                 fmaxf(acc1[4 * j + 1] + v0.y + l0.y, 0.f),
                                 fmaxf(acc1[4 * j + 3] + v1.y + l1.y, 0.f)};
            const int f = 2 + (j & 1);  // stage q - 2, the last to read set f, has completed
#pragma unroll
            for (int i = 0; i < 4; ++i) split<kOnePass>(hs[i], fa[f][i], fs[f][i]);
            mbar_wait(full + q % kFRing, (q / kFRing) & 1);
            wg_fence();
            const float* sb = ring + (q % kFRing) * kStage;
            const uint64_t db = kmajor_desc(sb, kStep2 / 2 * 4, 128);
            if constexpr (!kOnePass) {
              const uint64_t ds = kmajor_desc(sb + kStage / 2, kStep2 / 2 * 4, 128);
              wgmma_n256(acc2, fs[f], db);
              wgmma_n256(acc2, fa[f], ds);
            }
            wgmma_n256(acc2, fa[f], db);
            wg_commit();
            wg_wait<1>();  // stage q - 1 has completed
            refill(q);
          }
        }
        wg_wait<0>();
        // the group's part of the logit: w2 . relu(acc2 + b1) over its columns
#pragma unroll
        for (int j = 0; j < kNZ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = 8 * j + 2 * t + e;
            p0 += fmaxf(acc2[4 * j + e] + b1s[n], 0.f) * w2s[n];
            p1r += fmaxf(acc2[4 * j + 2 + e] + b1s[n], 0.f) * w2s[n];
          }
      }
    } else {
      float acc2[kNZ / 2];
#pragma unroll
      for (int i = 0; i < kNZ / 2; ++i) acc2[i] = 0.f;

#pragma unroll 1
      for (int c = 0; c < nch; ++c) {
        __syncthreads();  // the cross tile is in; every thread is done with the previous chunk's wv
        // wv of the chunk's columns, by cp.async (zero past D and BT)
        for (int idx = tid; idx < kFRows * (kNC / 4); idx += kFThreads) {
          const int r = idx / (kNC / 4), cc = 4 * (idx % (kNC / 4)), n = row0 + r, col = kNC * c + cc;
          const bool ok = n < BT && col < D;
          cp_async16(wvs + r * kWvLd + cc, ok ? wv + (size_t)n * D + col : wv, ok);
        }
        cp_commit();
        float acc1[kNC / 2];
#pragma unroll
        for (int i = 0; i < kNC / 2; ++i) acc1[i] = 0.f;

        // acc1 = cross . Wx[:, chunk]: p1 stages of 4 k-steps
#pragma unroll 1
        for (int s = 0; s < p1; ++s, ++q) {
          mbar_wait(full + q % kFRing, (q / kFRing) & 1);
          const float* sb = ring + (q % kFRing) * kStage;
#pragma unroll
          for (int pp = 0; pp < 2; ++pp) {  // a wgmma group of two k-steps
            float2 x[2][2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int k0 = 8 * (4 * s + 2 * pp + h) + 2 * t;
              x[h][0] = *reinterpret_cast<const float2*>(cross + r0 * ldx + k0);
              x[h][1] = *reinterpret_cast<const float2*>(cross + (r0 + 8) * ldx + k0);
            }
            wg_wait<1>();  // the group that read fragment sets 2 pp, 2 pp + 1 has completed
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int f = 2 * pp + h;
              // (g, t), (g+8, t), (g, t+4), (g+8, t+4)
              const float xs[4] = {x[h][0].x, x[h][1].x, x[h][0].y, x[h][1].y};
#pragma unroll
              for (int i = 0; i < 4; ++i) split<kOnePass>(xs[i], fa[f][i], fs[f][i]);
            }
            wg_fence();
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int f = 2 * pp + h, kk = 2 * pp + h;
              const uint64_t db = kmajor_desc(sb + kk * kStep1, kStep1 * 2, 128);
              if constexpr (!kOnePass) {
                const uint64_t ds = kmajor_desc(sb + kStage / 2 + kk * kStep1, kStep1 * 2, 128);
                wgmma_n64(acc1, fs[f], db);
                wgmma_n64(acc1, fa[f], ds);
              }
              wgmma_n64(acc1, fa[f], db);
            }
            wg_commit();
          }
          refill(q);  // the waits left only stage q's two groups in flight
        }
        wg_wait<0>();
        cp_wait_all();
        __syncthreads();  // acc1 is final; every thread's wv copies are in

        // acc2 += relu(acc1 + wv + wl) . W1[chunk, :]: 8 stages of one k-step
#pragma unroll
        for (int j = 0; j < kNC / 8; ++j, ++q) {
          const float2 v0 = *reinterpret_cast<const float2*>(wvs + r0 * kWvLd + 8 * j + 2 * t);
          const float2 v1 = *reinterpret_cast<const float2*>(wvs + (r0 + 8) * kWvLd + 8 * j + 2 * t);
          const int col = kNC * c + 8 * j + 2 * t;  // D is even: both columns or neither lie below D
          const float2 zero2 = make_float2(0.f, 0.f);
          const float2 l0 = col < D ? __ldg(reinterpret_cast<const float2*>(wl0 + col)) : zero2;
          const float2 l1 = col < D ? __ldg(reinterpret_cast<const float2*>(wl1 + col)) : zero2;
          // C fragment (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) -> A slots (g, t), (g+8, t), (g, t+4), (g+8, t+4)
          const float hs[4] = {fmaxf(acc1[4 * j] + v0.x + l0.x, 0.f), fmaxf(acc1[4 * j + 2] + v1.x + l1.x, 0.f),
                               fmaxf(acc1[4 * j + 1] + v0.y + l0.y, 0.f),
                               fmaxf(acc1[4 * j + 3] + v1.y + l1.y, 0.f)};
          const int f = 2 + (j & 1);  // stage q - 2, the last to read set f, has completed
#pragma unroll
          for (int i = 0; i < 4; ++i) split<kOnePass>(hs[i], fa[f][i], fs[f][i]);
          mbar_wait(full + q % kFRing, (q / kFRing) & 1);
          wg_fence();
          const float* sb = ring + (q % kFRing) * kStage;
          const uint64_t db = kmajor_desc(sb, kStep2 / 2 * 4, 128);
          if constexpr (!kOnePass) {
            const uint64_t ds = kmajor_desc(sb + kStage / 2, kStep2 / 2 * 4, 128);
            wgmma_n256(acc2, fs[f], db);
            wgmma_n256(acc2, fa[f], ds);
          }
          wgmma_n256(acc2, fa[f], db);
          wg_commit();
          wg_wait<1>();  // stage q - 1 has completed
          refill(q);
        }
      }
      wg_wait<0>();

      // logit = w2 . relu(acc2 + b1) + b2: this thread's columns, then the 4 lanes of a row
#pragma unroll
      for (int j = 0; j < kNZ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * j + 2 * t + e;
          p0 += fmaxf(acc2[4 * j + e] + b1s[n], 0.f) * w2s[n];
          p1r += fmaxf(acc2[4 * j + 2 + e] + b1s[n], 0.f) * w2s[n];
        }
    }
    p0 = quad_sum(p0);
    p1r = quad_sum(p1r);
    if (t == 0) {
      const int n0 = row0 + r0, n1 = n0 + 8;
      if (n0 < BT) out[((size_t)(n0 / T) * A + a) * T + n0 % T] = p0 + b2[0];
      if (n1 < BT) out[((size_t)(n1 / T) * A + a) * T + n1 % T] = p1r + b2[0];
    }
  }
}


// shared memory of head_fwd with a cross tile of kw columns (D_pad, or kFK on the wide path)
size_t fwd_smem(int kw) {
  return sizeof(float) * ((size_t)kFRing * kStage + (size_t)kFRows * (kw + 8) + kFRows * kWvLd +
                          2 * kNZ) +
         sizeof(uint64_t) * kFRing;
}

// The SM count of each device, read at its first forward there (a
// persistent grid of one block an SM).
constexpr int kMaxDevices = 64;

cudaError_t sm_count(int device, int& sms) {
  static std::atomic<int> counts[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  sms = counts[device].load(std::memory_order_relaxed);
  if (sms > 0) return cudaSuccess;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) counts[device].store(sms, std::memory_order_relaxed);
  return e;
}

// zs: the wide path's scratch, zs_blocks x 64 x D_pad floats (the grid
// takes at most zs_blocks blocks there)
int launch_fwd(const float* vis, const float* arg, const float* wv, const float* wl,
               const float* wstream, const float* b1, const float* w2, const float* b2,
               float* out, float* zs, int zs_blocks, int B, int A, int T, int D, int Dh, int device,
               cudaStream_t stream) {
  int sms = 0;
  cudaError_t e = sm_count(device, sms);
  if (e != cudaSuccess) return (int)e;
  const int Dp = (D + kNC - 1) / kNC * kNC;
  const bool wide = Dp > kMaxD || Dh > kMaxHid;
  if (wide && (zs == nullptr || zs_blocks < 1)) return (int)cudaErrorInvalidValue;
  if (wide && zs_blocks < sms) sms = zs_blocks;
  const size_t smem = fwd_smem(wide ? kFK : Dp);
  auto fwd = wide ? head_fwd<true> : head_fwd<false>;
  e = cudaFuncSetAttribute(fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int items = (B * T + kFRows - 1) / kFRows * A;
  fwd<<<items < sms ? items : sms, kFThreads, smem, stream>>>(vis, arg, wv, wl, wstream, b1, w2, b2,
                                                              out, zs, B, A, T, D, Dp, Dh);
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
// banks).  Operands are split with split (tf32.cuh: 3xTF32 or one pass).
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
      split<kOnePass>(b0, bb[j][0], bs[j][0]);
      split<kOnePass>(b1, bb[j][1], bs[j][1]);
    }
    const int k0 = 8 * s;
#pragma unroll
    for (int m = 0; m < A; ++m) {
      const float* p = X + (16 * m + g) * ld + k0 + t;
      uint32_t ab[4], as[4];
      split<kOnePass>(p[0], ab[0], as[0]);
      split<kOnePass>(p[8 * ld], ab[1], as[1]);
      split<kOnePass>(p[4], ab[2], as[2]);
      split<kOnePass>(p[8 * ld + 4], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_p<kOnePass>(acc[m][j], ab, as, bb[j], bs[j]);
    }
  }
}

// sum of v over the 8 row groups of a warp (lanes with the same lane & 3)
__device__ inline float sum_rows8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// The row kernel's wide path (D > 512 or Dh > 256): the four products as
// the narrow path's, each warp walking column groups (32 z0 columns, 16 z1
// columns a warp, 512 and 256 a group of the block), over K slices of kBK
// columns of their operand rows.  The operands (cross, h, dz1, dz0) are
// rows this kernel writes to device memory anyway, for the weight kernel:
// each slice is staged from there into the (A*16, kBK + 4) tile, the
// size of the narrow path's at D 512, so the tile and A = 5 fit at any D.
// The ReLU decisions of z0 come back from h (h > 0 iff z0 > 0).  Every
// global row this kernel reads back it wrote before a __syncthreads.
constexpr int kBK = kMaxD;

template <int A>
__device__ __forceinline__ void bwd_rows_wide(const float* __restrict__ vis, const float* __restrict__ arg,
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
  constexpr int ld = kBK + 4;
  const int b = b_first + blockIdx.y;
  const int t0 = blockIdx.x * kBT;
  const size_t blk = (size_t)b * gridDim.x + blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;

  extern __shared__ float xs[];  // M x ld: a K slice of cross, h, dz1 or dz0
  float* ring = xs + M * ld + (threadIdx.x >> 5) * kRing * kWarpSlab;  // this warp's weight ring

  for (int idx = tid; idx < M * D; idx += kThreads) {  // the cross rows, the first product's operand
    const int r = idx / D, kk = idx - r * D;
    const int a = r / kBT, t = t0 + r % kBT;
    if (t < T) cross_out[(((size_t)b * A + a) * T + t) * D + kk] =
        vis[((size_t)b * T + t) * D + kk] * arg[((size_t)b * A + a) * D + kk];
  }
  // columns [k0, k0 + kBK) of this block's rows of src (B, A, T, n), zero past T and n
  auto stage = [&](const float* src, int n, int k0) {
    __syncthreads();  // every warp is done with the tile; src's rows are written
    for (int idx = tid; idx < M * (kBK / 4); idx += kThreads) {
      const int r = idx / (kBK / 4), c = 4 * (idx % (kBK / 4));
      const int a = r / kBT, t = t0 + r % kBT;
      const bool ok = t < T && k0 + c < n;
      cp_async16(xs + r * ld + c, ok ? src + (((size_t)b * A + a) * T + t) * n + k0 + c : src, ok);
    }
    cp_commit();
    cp_wait_all();
    __syncthreads();
  };
  auto zero_acc = [&](auto& acc) {
#pragma unroll
    for (int m = 0; m < A; ++m)
#pragma unroll
      for (int j = 0; j < (int)(sizeof(acc[0]) / sizeof(acc[0][0])); ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
  };
  float acc[A][4][4];

  // ---- z0 = cross . Wx (+ stems), h = relu(z0) --------------------------
#pragma unroll 1
  for (int nb = 0; nb < D; nb += kWarps * kN1) {
    const int nw = nb + warp * kN1;
    zero_acc(acc);
#pragma unroll 1
    for (int k0 = 0; k0 < D; k0 += kBK) {
      stage(cross_out, D, k0);
      if (nw < D) gemm_rows<A, 4, false>(acc, xs, ld, wx + (size_t)k0 * D, D, nw, min(kBK, D - k0), ring, lane);
    }
    if (nw >= D) continue;
#pragma unroll
    for (int m = 0; m < A; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = nw + 8 * j + 2 * tq + (i & 1);
          const int t = t0 + g + (i >= 2 ? 8 : 0);
          if (t < T)
            h_out[(((size_t)b * A + m) * T + t) * D + n] =
                fmaxf(acc[m][j][i] + wv[((size_t)b * T + t) * D + n] + wl[((size_t)b * A + m) * D + n], 0.f);
        }
  }

  // ---- z1 = h . W1 + b1; dz1 = [z1 > 0] g w2 ------------------------------
#pragma unroll 1
  for (int nb = 0; nb < Dh; nb += kWarps * kN2) {
    const int n2 = nb + warp * kN2;
    float acc2[A][2][4];
    zero_acc(acc2);
#pragma unroll 1
    for (int k0 = 0; k0 < D; k0 += kBK) {
      stage(h_out, D, k0);
      if (n2 < Dh) gemm_rows<A, 2, false>(acc2, xs, ld, w1 + (size_t)k0 * Dh, Dh, n2, min(kBK, D - k0), ring, lane);
    }
    if (n2 >= Dh) continue;
    float pw2[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, pb1[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int m = 0; m < A; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = n2 + 8 * j + 2 * tq + (i & 1);
          const int t = t0 + g + (i >= 2 ? 8 : 0);
          const float gr = t < T ? gin[((size_t)b * A + m) * T + t] : 0.f;
          const float z1 = acc2[m][j][i] + b1[n];
          const float d = z1 > 0.f ? gr * w2[n] : 0.f;
          pw2[j][i & 1] += fmaxf(z1, 0.f) * gr;
          pb1[j][i & 1] += d;
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

  // ---- dh = dz1 . W1^T; dz0 = [h > 0] dh ----------------------------------
#pragma unroll 1
  for (int nb = 0; nb < D; nb += kWarps * kN1) {
    const int nw = nb + warp * kN1;
    zero_acc(acc);
#pragma unroll 1
    for (int k0 = 0; k0 < Dh; k0 += kBK) {
      stage(dz1_out, Dh, k0);
      if (nw < D) gemm_rows<A, 4, true>(acc, xs, ld, w1 + k0, Dh, nw, min(kBK, Dh - k0), ring, lane);
    }
    if (nw >= D) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = nw + 8 * j + 2 * tq + (i & 1);
        const int t = t0 + g + (i >= 2 ? 8 : 0);
        float sv = 0.f;
#pragma unroll
        for (int m = 0; m < A; ++m) {
          const size_t at = (((size_t)b * A + m) * T + t) * D + n;
          const float d = t < T && h_out[at] > 0.f ? acc[m][j][i] : 0.f;
          acc[m][j][i] = d;
          sv += d;
          if (t < T) dz0_out[at] = d;
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

  // ---- dcross = dz0 . Wx^T; dvis = sum_a dcross arg_a, darg = sum_t dcross vis
#pragma unroll 1
  for (int nb = 0; nb < D; nb += kWarps * kN1) {
    const int nw = nb + warp * kN1;
    zero_acc(acc);
#pragma unroll 1
    for (int k0 = 0; k0 < D; k0 += kBK) {
      stage(dz0_out, D, k0);
      if (nw < D) gemm_rows<A, 4, true>(acc, xs, ld, wx + k0, D, nw, min(kBK, D - k0), ring, lane);
    }
    if (nw >= D) continue;
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
  bwd_rows_wide<A>(vis, arg, wv, wl, wx, w1, b1, w2, gin, cross_out, h_out, dz0_out, dz1_out, dvis, dwv,
                   darg_part, dwl_part, db1_part, dw2_part, T, D, Dh, b_first);
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
        split<kOnePass>(p[0], ab[m][0], as[m][0]);
        split<kOnePass>(p[8], ab[m][1], as[m][1]);
        split<kOnePass>(p[4 * kWXld], ab[m][2], as[m][2]);
        split<kOnePass>(p[4 * kWXld + 8], ab[m][3], as[m][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* q = ys + (k0 + tq) * kWYld + wn + 8 * j + g;
        split<kOnePass>(q[0], bb[j][0], bs[j][0]);
        split<kOnePass>(q[4 * kWYld], bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_p<kOnePass>(acc[m][j], ab[m], as[m], bb[j], bs[j]);
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
// process for each device, at its first call there (the device of the
// tensors, which the entry point's guard has made current).
struct SideStream {
  cudaStream_t s = nullptr;
  cudaEvent_t in = nullptr, out = nullptr;
  int sms = 0;
};

cudaError_t side_stream(int device, SideStream*& out) {
  static SideStream sides[kMaxDevices];
  static std::mutex made;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(made);
  SideStream& x = sides[device];
  if (x.s == nullptr) {
    cudaError_t e = sm_count(device, x.sms);
    if (e == cudaSuccess) e = cudaEventCreateWithFlags(&x.in, cudaEventDisableTiming);
    if (e == cudaSuccess) e = cudaEventCreateWithFlags(&x.out, cudaEventDisableTiming);
    if (e == cudaSuccess) e = cudaStreamCreateWithFlags(&x.s, cudaStreamNonBlocking);
    if (e != cudaSuccess) return e;
  }
  out = &x;
  return cudaSuccess;
}

// shared memory of the wide row kernel: its tile of A * 16 rows of a K
// slice and the warps' weight rings
template <int A>
size_t rows_smem() {
  return sizeof(float) * ((size_t)A * kBT * (kBK + 4) + kWarps * kRing * kWarpSlab);
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
  head_bwd_rows<A><<<dim3((T + kBT - 1) / kBT, bb1 - bb0), kThreads, rows_smem<A>(), stream>>>(
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
               int D, int Dh, int chunks, int device, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      head_bwd_rows<A>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rows_smem<A>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(head_bwd_w, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(sizeof(float) * kWStages * kWStage));
  SideStream* side = nullptr;
  if (e == cudaSuccess) e = side_stream(device, side);
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

// ---------------------------------------------------------------------------
// backward, narrow path (D <= 512, Dh <= 256): the products on wgmma
// ---------------------------------------------------------------------------
//
// head_bwd_prep lays out, once a call, the forward's weight stream (z0's
// k-steps in natural order: their A operand comes from shared memory) and
// the streams of dh = dz1 . W1^T (chunk c: B(k, n) = W1[64c + n][k], k over
// Dh, pair order: A from registers) and dcross = dz0 . Wx^T (B(k, n) =
// Wx[64c + n][k], natural order), in the forward's format: 64-column
// chunks, k-steps of 8, 4 k-steps a stage, a stage's big then small parts
// or once rounded.
//
// head_bwd_rows_wg: a persistent grid, one block an SM of two consumer
// warpgroups and a producer warpgroup, walks the items: 64 rows of the
// flattened (b, a, t) rows, so a tile may hold two (b, a) and only the
// last one is short (at GT5 250 items, two rounds of the H100's 132 SMs;
// 64 tokens of one (b, a) took 320 items and three).  The consumers split
// each product's 64-column chunks (warpgroup w the chunks c = w mod 2),
// each with its own ring of weight stages; two producer warps fill each
// ring by cp.async.bulk, a stage as its slot is read (mbarriers both
// ways).  A warp that issues bulk copies waits for each copy, however
// deep its ring (tools/hopper_rates.cu: one warp of 8 KB copies moves a
// quarter of what four move), so the copies come from several warps;
// they bounded the kernel while one thread of each warpgroup issued
// them.  With the producer warpgroup ptxas reports 168 registers (384
// threads); setmaxnreg gives the consumers 240.
// An item:
//   (1) the cross tile vis * arg_a (64 x D_pad) built in shared memory in
//       K-major core matrices (tix; rounded to TF32 in a one-pass library),
//       also written out transposed for the weight kernel;
//   (2) for each own chunk, z0 = cross . Wx[:, c] with the A operand read
//       from the tile by wgmma (at "highest" the tile holds fp32, which
//       the tensor core reads as its big part, and the small parts come
//       from registers), h = relu(z0 + wv + wl) written out transposed
//       and, in place, the A operand of z1 += h . W1[c, :] (a 64 x 256
//       accumulator a warpgroup: its chunks' part), the ReLU decisions
//       kept as bits;
//   (3) the two z1 parts added through shared memory (the tile is free),
//       in a fixed order, so both warpgroups hold the same z1; dz1 = [z1 >
//       0] g w2 stays in their registers, and warpgroup 0 writes it and
//       the per-warp parts of db1 and dw2;
//   (4) for each own chunk dh = dz1 . W1^T[:, c], the A operand dz1's
//       registers as they stand (pair order); dz0 = [z0 > 0] dh into the
//       tile and out, the parts of dwl;
//   (5) for each own chunk dcross = dz0 . Wx^T[:, c] from the tile; out
//       dcross * arg_a (dvis's part of arg a) and the parts of darg =
//       sum_t dcross vis.
// A stage of 4 k-steps is one wgmma group, one group left in flight (at
// "highest" none in the tile products, which keeps phase (2)'s registers
// without a spill).  The parts of darg and dwl are column sums over a
// warp's 16 rows by (b, a): a slot of (b, a) a 16-row block that meets its
// rows (seg_sum).
//
// head_bwd_w_wg: dWx^T = sum_r dz0[r]^T crossT[:, r] and dW1^T = sum_r
// dz1[r]^T hT[:, r] in one launch, a 128 x 256 output tile (two consumer
// warpgroups of 64 x 256) and a chunk of rows a block.  TF32 wgmma takes
// only K-major operands, so the row kernel writes cross and h transposed,
// in groups of 32 rows: [r / 32][(r % 32) / 4][i][r % 4], where each
// 16-byte (i, 4 rows) piece is a row of a K-major core matrix and 256
// columns of 4 rows are one 4 KB bulk copy; the B operand is that, the A
// operand (dz0 or dz1 rows) comes from a row stage by fragment reads.  Two
// producer warps fill a ring of stages (32 rows: the A rows and 8 B
// pieces) in turn as the consumers free them.  Each block writes its
// chunk's part, transposed back.
//
// head_bwd_finish adds every part up in a fixed order: dvis and dwv over
// the args, dWx and dW1 over the chunks, darg and dwl over the slots, db1
// and dw2 over the (item, warp) parts.  No atomics: the gradients are the
// same on every run.
//
// At "highest" the B operands are stored as big and small parts (the
// transposed rows as two planes, the streams as two parts a stage) and
// each k-step is three wgmma; at "default" once, rounded to TF32.

constexpr int kBRows = 64;                   // rows (b, a, t) of an item
constexpr int kBThreads = 256;               // two warpgroups
constexpr int kBRing = kOnePass ? 5 : 2;     // stages (kStage: 8 or 16 KB) of each warpgroup's ring
constexpr int kBMaxMine = kMaxD / kNC / 2;   // chunks a warpgroup owns at most
constexpr int kTGroup = 32;                  // rows of a group of the transposed layout
// the producer warpgroup (two warps a ring), and the register file's split
// between it and the consumers (setmaxnreg: 128 x 24 + 256 x 240 <= 65536;
// without it the row kernel ran several times slower on the H100)
constexpr int kProdThreads = 128, kProdRegs = 24, kConsRegs = 240;

// floats of the backward's stream (head_bwd_prep): D_pad / 64 chunks of
// ceil(Dh / 32) dh stages, then of D_pad / 32 dcross stages, kStage each
__host__ __device__ inline size_t bwd_stream_floats(int Dp, int Dh) {
  return (size_t)(Dp / kNC) * ((Dh + 31) / 32 + Dp / 32) * kStage;
}

// the place of (row r, column i) in the transposed layout of D columns
__device__ inline size_t tpos(size_t r, int i, int D) {
  return ((r / kTGroup * 8 + (r % kTGroup) / 4) * (size_t)D + i) * 4 + (r & 3);
}

// the place of (row r, column k) in the row kernel's 64-row tile: K-major
// core matrices (8 rows x 4 columns, 128 contiguous bytes), [k / 4][r][k % 4]
__device__ inline int tix(int r, int k) { return ((k >> 2) * kBRows + r) * 4 + (k & 3); }

// x into a B operand: rounded to TF32 (one pass), or its big part at p and
// its small part a plane further (3xTF32)
__device__ inline void store_b(float* p, size_t plane, float x) {
  if constexpr (kOnePass) {
    *p = __uint_as_float(round_tf32(x));
  } else {
    const float big = __uint_as_float(__float_as_uint(x) & kBigMask);
    p[0] = big;
    p[plane] = x - big;
  }
}

// the forward's stream (Dh <= 256), then the backward's (bwd_stream_floats)
__global__ void __launch_bounds__(256)
head_bwd_prep(const float* __restrict__ wx, const float* __restrict__ w1, float* __restrict__ stream, int D,
              int Dp, int Dh) {
  const int nch = Dp / kNC, s2 = (Dh + 31) / 32, p1 = Dp / 32;
  const size_t first = (size_t)kParts * nch * chunk_floats(Dp, 1), total = first + bwd_stream_floats(Dp, Dh);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total; i += (size_t)gridDim.x * blockDim.x) {
    if (i < first) {
      stream[i] = fwd_stream_value(i, wx, w1, D, Dp, Dh, true);
      continue;
    }
    const size_t o = i - first;
    const int stage = (int)(o / kStage), part = kOnePass ? 0 : (int)(o / kStep2) & 1;
    const int w = (int)(o % kStep2), kk = w / kStep1, x = w % kStep1;
    const int u = x & 3, n = 8 * ((x >> 5) & 7) + ((x >> 2) & 7), e = x >> 8;
    const int kin = stage < nch * s2 ? 2 * u + e : 4 * e + u;  // dh in pair order, dcross in natural order
    float v = 0.f;
    if (stage < nch * s2) {  // dh: W1[64c + n][k]
      const int c = stage / s2, k = 8 * (4 * (stage % s2) + kk) + kin, row = kNC * c + n;
      if (row < D && k < Dh) v = w1[(size_t)row * Dh + k];
    } else {  // dcross: Wx[64c + n][k]
      const int st = stage - nch * s2, c = st / p1, k = 8 * (4 * (st % p1) + kk) + kin, row = kNC * c + n;
      if (row < D && k < D) v = wx[(size_t)row * D + k];
    }
    if constexpr (kOnePass) {
      stream[i] = __uint_as_float(round_tf32(v));
    } else {
      const float big = __uint_as_float(__float_as_uint(v) & kBigMask);
      stream[i] = part ? v - big : big;
    }
  }
}

// floats of the row kernel's first region: the cross (later dz0) tile, or
// the two warpgroups' z1 parts while they are added
__host__ __device__ inline int bwd_region(int Dp) {
  const int tile = kBRows * Dp, xchg = 2 * kBRows * kNZ;
  return tile > xchg ? tile : xchg;
}

size_t bwd_rows_smem(int Dp) {
  return sizeof(float) * ((size_t)bwd_region(Dp) + 2 * kBRing * kStage + 2 * kNZ) +
         sizeof(uint32_t) * kBMaxMine * kBThreads + sizeof(uint64_t) * 4 * kBRing;
}

__global__ void __launch_bounds__(kBThreads + kProdThreads, 1)
head_bwd_rows_wg(const float* __restrict__ vis, const float* __restrict__ arg, const float* __restrict__ wv,
                 const float* __restrict__ wl, const float* __restrict__ fstream,
                 const float* __restrict__ bstream, const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ gin, float* __restrict__ crossT, float* __restrict__ hT,
                 float* __restrict__ dz0g, float* __restrict__ dz1g, float* __restrict__ dvisp,
                 float* __restrict__ dargp, float* __restrict__ dwlp, float* __restrict__ db1p,
                 float* __restrict__ dw2p, int B, int A, int T, int D, int Dp, int Dh, size_t plane) {
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  extern __shared__ __align__(1024) float4 smem4[];
  // 64 x Dp (tix): cross, then dz0, rounded to TF32 in a one-pass library; or the z1 parts
  float* tile = reinterpret_cast<float*>(smem4);
  float* rings = tile + bwd_region(Dp);                      // 2 x kBRing x kStage: a warpgroup's ring each
  float* b1s = rings + 2 * kBRing * kStage;                  // kNZ, zero past Dh
  float* w2s = b1s + kNZ;                                    // kNZ, zero past Dh
  uint32_t* maskb = reinterpret_cast<uint32_t*>(w2s + kNZ);  // kBMaxMine x 256: z0 > 0 bits
  uint64_t* fulls = reinterpret_cast<uint64_t*>(maskb + kBMaxMine * kBThreads);  // 2 x kBRing: a stage is in
  uint64_t* empties = fulls + 2 * kBRing;  // 2 x kBRing: a stage is read (a lane of each consumer warp)

  // stages a chunk: z0 p1 (4 k-steps each) and z1 8 (one k-step each), dh s2, dcross p1
  const int nch = Dp / kNC, p1 = Dp / 32, s2 = (Dh + 31) / 32;
  const int R = B * A * T;  // rows (b, a, t), flattened (fewer than 2^31: R x D floats fit the card)
  const int nitems = (R + kBRows - 1) / kBRows;
  const int nslots = (T + 15) / 16 + 1;  // 16-row blocks that meet the rows of one (b, a), at most
  const int items = (nitems - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  // warpgroup w's chunks (c = w + 2i), and its stages an item: z0 + z1, dh, dcross
  auto mine_of = [&](int w) { return (nch - w + 1) / 2; };
  auto per_item_of = [&](int w) { return mine_of(w) * (2 * p1 + 8 + s2); };
  // the stream stage of an item's stage u of warpgroup w
  auto stage_src = [&](int w, int u) -> const float* {
    const int mn = mine_of(w), L0 = mn * (p1 + 8), L1 = mn * s2;
    if (u < L0) {
      const int i = u / (p1 + 8);
      return fstream + (size_t)((w + 2 * i) * (p1 + 8) + u - i * (p1 + 8)) * kStage;
    }
    u -= L0;
    if (u < L1) return bstream + (size_t)((w + 2 * (u / s2)) * s2 + u % s2) * kStage;
    u -= L1;
    return bstream + (size_t)(nch * s2 + (w + 2 * (u / p1)) * p1 + u % p1) * kStage;
  };
  if (tid == 0) {
    for (int r = 0; r < 2 * kBRing; ++r) {
      mbar_init(fulls + r, 1);
      mbar_init(empties + r, 4);
    }
    mbar_fence_init();
  }
  for (int i = tid; i < kNZ; i += kBThreads + kProdThreads) {
    b1s[i] = i < Dh ? b1[i] : 0.f;
    w2s[i] = i < Dh ? w2[i] : 0.f;
  }
  __syncthreads();
  // The producer warpgroup: its warp p fills warpgroup p / 2's ring with
  // the stages of parity p % 2, each as its slot is read (four issuing
  // warps: a warp waits for each of its copies).
  if (tid >= kBThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProdRegs));
    const int p = (tid - kBThreads) >> 5, w = p >> 1;
    if (lane == 0) {
      const int per = per_item_of(w), total = items * per;
      for (int q = p & 1; q < total; q += 2) {
        if (q >= kBRing) mbar_wait(empties + w * kBRing + q % kBRing, (q / kBRing - 1) & 1);
        bulk_load(rings + (w * kBRing + q % kBRing) * kStage, stage_src(w, q % per), kStage * 4,
                  fulls + w * kBRing + q % kBRing);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsRegs));
  const int mine = mine_of(wg);
  float* ring = rings + wg * kBRing * kStage;
  uint64_t* full = fulls + wg * kBRing;
  uint64_t* empty = empties + wg * kBRing;
  // after the wgmmas of stage q - 1 have completed: its slot is free
  auto refill = [&](int q) {
    if (lane == 0 && q >= 1) mbar_arrive(empty + (q - 1) % kBRing);
  };
  // the two consumer warpgroups alone (the producer warpgroup has left)
  auto sync_consumers = []() { asm volatile("bar.sync 1, %0;\n" ::"n"(kBThreads) : "memory"); };
  int q = 0;  // the stage this warpgroup reads next
  const int r0 = 16 * warp + g;  // this thread's rows of an item: r0 and r0 + 8
  uint32_t fs[2][4];  // "highest": z1's small A fragments, two sets in turn

  // acc = (the tile: cross or dz0) . (p1 stages of the stream): a chunk's 64
  // columns, the A operand read from shared memory by wgmma, one group a
  // stage of 4 k-steps and one group left in flight.  At "highest" the
  // tile holds fp32, which the tensor core reads as its big part (the low
  // bits ignored: split_int's big), and the small parts come from
  // registers, a stage's 4 k-steps.
  auto tile_product = [&](float (&acc)[32]) {
    uint32_t sm[4][4];  // "highest": a stage's small A fragments
    auto stage = [&](int s) {
      if constexpr (!kOnePass) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int k = 8 * (4 * s + kk) + t;  // (g, t), (g+8, t), (g, t+4), (g+8, t+4)
          const float xs[4] = {tile[tix(r0, k)], tile[tix(r0 + 8, k)], tile[tix(r0, k + 4)],
                               tile[tix(r0 + 8, k + 4)]};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t big;
            split_int(xs[i], big, sm[kk][i]);
          }
        }
      }
      mbar_wait(full + q % kBRing, (q / kBRing) & 1);
      const float* sb = ring + (q % kBRing) * kStage;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = kmajor_desc(tile + 2 * (4 * s + kk) * kBRows * 4, kBRows * 16, 128);
        const uint64_t db = kmajor_desc(sb + kk * kStep1, kStep1 * 2, 128);
        if constexpr (!kOnePass) {
          const uint64_t ds = kmajor_desc(sb + kStage / 2 + kk * kStep1, kStep1 * 2, 128);
          wgmma_n64(acc, sm[kk], db);
          wgmma_n64_ss(acc, da, ds);
        }
        wgmma_n64_ss(acc, da, db);
      }
      wg_commit();
      // stage q - 1 has completed (3xTF32: stage q too, whose fragments the
      // next stage rewrites; one set keeps the registers of phase (2))
      if constexpr (kOnePass) wg_wait<1>(); else wg_wait<0>();
      refill(q);
      ++q;
    };
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int s = 0; s < p1; ++s) stage(s);
    wg_wait<0>();
  };

  for (int it = 0; it < items; ++it) {
    const int item = blockIdx.x + it * gridDim.x;
    const int row0 = item * kBRows;  // the item's first row
    // this thread's rows rg0 = row0 + r0 and rg1 = rg0 + 8 (valid below R):
    // their (b, a) rows ba0, ba1 of arg, wl and the gradients' partials,
    // and their (b, t) rows vr0, vr1 of vis and wv
    const int rg0 = row0 + r0, rg1 = rg0 + 8;
    const bool ok0 = rg0 < R, ok1 = rg1 < R;
    const int ba0 = ok0 ? rg0 / T : 0, ba1 = ok1 ? rg1 / T : 0;
    const int vr0 = ok0 ? ba0 / A * T + (rg0 - ba0 * T) : 0, vr1 = ok1 ? ba1 / A * T + (rg1 - ba1 * T) : 0;
    // this warp's 16-row block and the (b, a) rows it meets (seg_sum)
    const int blk = row0 / 16 + warp, blk_last = min(R - 1, 16 * blk + 15);
    const int seg_lo = 16 * blk < R ? 16 * blk / T : 1, seg_hi = 16 * blk < R ? blk_last / T : 0;
    sync_consumers();  // every thread is done with the previous item's tile
    // part (BA, nslots, width) += this warp's column sums over its 16 rows, by (b, a):
    // a (b, a)'s rows T are met by its 16-row blocks in turn, slot = the
    // warp's block less that (b, a)'s first block (nslots = ceil(T / 16) + 1)
    // Rows past R hold zeros.  T >= 16 (the wrapper pads a shorter T), so
    // a block meets at most two (b, a): both sums straight-line (a loop
    // here, even one never taken, cost the kernel a third of its time at
    // P100).
    auto seg_sum = [&](float* __restrict__ part, int width, int col, float v0a, float v0b, float v1a, float v1b) {
      if (seg_lo > seg_hi) return;  // the block lies past R
      const bool m0 = ba0 == seg_lo, m1 = ba1 == seg_lo;
      const float s0 = sum_rows8((m0 ? v0a : 0.f) + (m1 ? v1a : 0.f));
      const float s1 = sum_rows8((m0 ? v0b : 0.f) + (m1 ? v1b : 0.f));
      if (g == 0 && col < width)
        *reinterpret_cast<float2*>(part + ((size_t)seg_lo * nslots + blk - seg_lo * T / 16) * width + col) =
            make_float2(s0, s1);
      if (seg_hi > seg_lo) {  // the next (b, a), slot 0 of its rows
        const float u0 = sum_rows8((m0 ? 0.f : v0a) + (m1 ? 0.f : v1a));
        const float u1 = sum_rows8((m0 ? 0.f : v0b) + (m1 ? 0.f : v1b));
        if (g == 0 && col < width)
          *reinterpret_cast<float2*>(part + ((size_t)seg_hi * nslots + blk - seg_hi * T / 16) * width + col) =
              make_float2(u0, u1);
      }
    };

    // (1) cross = vis * arg_a by cp.async (zero past T and D), scaled in place
    // a warp 8 rows x 4 column quads a pass: 64 contiguous bytes of each
    // row read, 8 contiguous rows of a core matrix written by 8 lanes
    auto cross_rc = [](int idx, int& r, int& c) {
      const int w = idx >> 5, lane = idx & 31;
      r = 8 * (w & 7) + (lane & 7);
      c = 4 * (4 * (w >> 3) + (lane >> 3));
    };
    int cr, cc;  // a thread's row of the tile is the same at every pass (256 threads: whole rounds of 8 warps)
    cross_rc(tid, cr, cc);
    const int crr = row0 + cr, cba = crr < R ? crr / T : 0;
    const float* vrow = vis + ((size_t)(cba / A) * T + (crr - cba * T)) * D;
    const float* arow = arg + (size_t)cba * D;
    for (int idx = tid; idx < kBRows * (Dp / 4); idx += kBThreads) {
      int r, c;
      cross_rc(idx, r, c);
      const bool ok = crr < R && c < D;
      cp_async16(tile + tix(r, c), ok ? vrow + c : vis, ok);
    }
    cp_commit();
    cp_wait_all();
    for (int idx = tid; idx < kBRows * (Dp / 4); idx += kBThreads) {  // the thread's own copies
      int r, c;
      cross_rc(idx, r, c);
      if (crr < R && c < D) {
        float4* x = reinterpret_cast<float4*>(tile + tix(r, c));
        const float4 w = __ldg(reinterpret_cast<const float4*>(arow + c));
        const float4 v = *x;
        *x = make_float4(v.x * w.x, v.y * w.y, v.z * w.z, v.w * w.w);
        // the cross rows out, transposed (row r's 4 columns c .. c + 3)
#pragma unroll
        for (int e = 0; e < 4; ++e) store_b(crossT + tpos(crr, c + e, D), plane, (&x->x)[e]);
        if constexpr (kOnePass) {
          const float4 y = *x;
          *x = make_float4(__uint_as_float(round_tf32(y.x)), __uint_as_float(round_tf32(y.y)),
                           __uint_as_float(round_tf32(y.z)), __uint_as_float(round_tf32(y.w)));
        }
      }
    }
    sync_consumers();

    // (2) z0 and z1 over this warpgroup's chunks
    float acc2[kNZ / 2];
#pragma unroll
    for (int i = 0; i < kNZ / 2; ++i) acc2[i] = 0.f;
    const float* wl0 = wl + (size_t)ba0 * D;
    const float* wl1 = wl + (size_t)ba1 * D;
#pragma unroll 1
    for (int i = 0; i < mine; ++i) {
      const int c = wg + 2 * i;
      float acc1[kNC / 2];
      tile_product(acc1);
      // h = relu(z0 + wv + wl) in place, the chunk's loads issued together
      // (no asm barrier between them), then written out and its bits kept
      uint32_t bits = 0u;
#pragma unroll
      for (int j = 0; j < kNC / 8; ++j) {
        const int col = kNC * c + 8 * j + 2 * t;  // D is even: both columns or neither lie below D
        const float2 zero2 = make_float2(0.f, 0.f);
        const float2 v0 = ok0 && col < D ? __ldg(reinterpret_cast<const float2*>(wv + (size_t)vr0 * D + col)) : zero2;
        const float2 v1 = ok1 && col < D ? __ldg(reinterpret_cast<const float2*>(wv + (size_t)vr1 * D + col)) : zero2;
        const float2 l0 = ok0 && col < D ? __ldg(reinterpret_cast<const float2*>(wl0 + col)) : zero2;
        const float2 l1 = ok1 && col < D ? __ldg(reinterpret_cast<const float2*>(wl1 + col)) : zero2;
        // C fragment (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1); rows past R and columns past D stay 0
        float* z = acc1 + 4 * j;
        z[0] += v0.x + l0.x;
        z[1] += v0.y + l0.y;
        z[2] += v1.x + l1.x;
        z[3] += v1.y + l1.y;
        if (!ok0 || col >= D) z[0] = z[1] = 0.f;
        if (!ok1 || col >= D) z[2] = z[3] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bits |= (z[e] > 0.f ? 1u : 0u) << (4 * j + e);
          z[e] = fmaxf(z[e], 0.f);
          if constexpr (kOnePass) z[e] = __uint_as_float(round_tf32(z[e]));  // z1's A operand and h's stores
        }
      }
#pragma unroll
      for (int j = 0; j < kNC / 8; ++j) {
        const int col = kNC * c + 8 * j + 2 * t;
        const float* z = acc1 + 4 * j;
        if (col < D) {
          if (ok0) {
            store_b(hT + tpos(rg0, col, D), plane, z[0]);
            store_b(hT + tpos(rg0, col + 1, D), plane, z[1]);
          }
          if (ok1) {
            store_b(hT + tpos(rg1, col, D), plane, z[2]);
            store_b(hT + tpos(rg1, col + 1, D), plane, z[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kNC / 8; ++j) {
        const float* z = acc1 + 4 * j;
        // h's C fragment as the A fragment of z1's k-step (pair order), as it
        // stands: rounded in place (one pass), or fp32, its big part (3xTF32)
        const uint32_t a4[4] = {__float_as_uint(z[0]), __float_as_uint(z[2]), __float_as_uint(z[1]),
                                __float_as_uint(z[3])};
        mbar_wait(full + q % kBRing, (q / kBRing) & 1);
        const int f = j & 1;
        if constexpr (!kOnePass) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = __uint_as_float(a4[e]);
            asm volatile("mov.b32 %0, %0;\n" : "+f"(x));  // after this k-step's wait (see phase (4))
            uint32_t big;
            split_int(x, big, fs[f][e]);
          }
        }
        wg_fence();
        const float* sb = ring + (q % kBRing) * kStage;
        const uint64_t db = kmajor_desc(sb, kStep2 / 2 * 4, 128);
        if constexpr (!kOnePass) {
          const uint64_t ds = kmajor_desc(sb + kStage / 2, kStep2 / 2 * 4, 128);
          wgmma_n256(acc2, fs[f], db);
          wgmma_n256(acc2, a4, ds);
        }
        wgmma_n256(acc2, a4, db);
        wg_commit();
        wg_wait<1>();  // stage q - 1 has completed
        refill(q);
        ++q;
      }
      wg_wait<0>();  // the last k-step has read acc1, which the next chunk rewrites
      maskb[i * kBThreads + tid] = bits;
    }

    // (3) z1 = the two warpgroups' parts, added in order; dz1 = [z1 > 0] g w2
    sync_consumers();  // both warpgroups are done with the cross tile
    float4* xchg = reinterpret_cast<float4*>(tile);
#pragma unroll
    for (int i = 0; i < kNZ / 8; ++i)
      xchg[(wg * (kNZ / 8) + i) * 128 + wt] = make_float4(acc2[4 * i], acc2[4 * i + 1], acc2[4 * i + 2], acc2[4 * i + 3]);
    sync_consumers();
    const float gr0 = ok0 ? gin[rg0] : 0.f, gr1 = ok1 ? gin[rg1] : 0.f;
#pragma unroll
    for (int i = 0; i < kNZ / 8; ++i) {
      const float4 x0 = xchg[i * 128 + wt], x1 = xchg[(kNZ / 8 + i) * 128 + wt];
      const float zs[4] = {x0.x + x1.x, x0.y + x1.y, x0.z + x1.z, x0.w + x1.w};
      float pw[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 8 * i + 2 * t + (e & 1);
        const float z1 = zs[e] + b1s[n], gr = e < 2 ? gr0 : gr1;
        acc2[4 * i + e] = z1 > 0.f ? gr * w2s[n] : 0.f;
        pw[e] = fmaxf(z1, 0.f) * gr;
      }
      if (wg == 0) {  // dz1 out, and the warp's partials of dw2 (relu(z1) g) and db1 (dz1) over its 16 rows
        const int n = 8 * i + 2 * t;
        if (n < Dh) {
          if (ok0) *reinterpret_cast<float2*>(dz1g + (size_t)rg0 * Dh + n) = make_float2(acc2[4 * i], acc2[4 * i + 1]);
          if (ok1) *reinterpret_cast<float2*>(dz1g + (size_t)rg1 * Dh + n) = make_float2(acc2[4 * i + 2], acc2[4 * i + 3]);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sw = sum_rows8(pw[e] + pw[e + 2]), sb = sum_rows8(acc2[4 * i + e] + acc2[4 * i + 2 + e]);
          if (g == 0 && n + e < Dh) {
            dw2p[((size_t)item * 4 + warp) * Dh + n + e] = sw;
            db1p[((size_t)item * 4 + warp) * Dh + n + e] = sb;
          }
        }
      }
    }
    if constexpr (kOnePass)  // dh's A operand, read from these registers as they stand
#pragma unroll
      for (int i = 0; i < kNZ / 2; ++i) acc2[i] = __uint_as_float(round_tf32(acc2[i]));
    sync_consumers();  // every thread has read the parts: the tile takes dz0 next

    // (4) dh = dz1 . W1^T[:, c]; dz0 = [z0 > 0] dh, into the tile and out
#pragma unroll 1
    for (int i = 0; i < mine; ++i) {
      const int c = wg + 2 * i;
      float acc[kNC / 2];
#pragma unroll
      for (int e = 0; e < kNC / 2; ++e) acc[e] = 0.f;
#pragma unroll
      for (int s = 0; s < kNZ / 32; ++s) {
        if (s < s2) {
          mbar_wait(full + q % kBRing, (q / kBRing) & 1);
          const float* sb = ring + (q % kBRing) * kStage;
          uint32_t fl[4][4];  // "highest": the stage's small A fragments
          if constexpr (!kOnePass) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int j = 4 * s + kk;
              float xs[4] = {acc2[4 * j], acc2[4 * j + 2], acc2[4 * j + 1], acc2[4 * j + 3]};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                // pinned after this stage's wait (asm volatile keeps its order), so the
                // splits of later stages are not hoisted into this one's registers
                asm volatile("mov.b32 %0, %0;\n" : "+f"(xs[e]));
                uint32_t big;
                split_int(xs[e], big, fl[kk][e]);
              }
            }
          }
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int j = 4 * s + kk;
            const uint64_t db = kmajor_desc(sb + kk * kStep1, kStep1 * 2, 128);
            // dz1's C fragment as the A fragment of hidden k-step j (pair order), as it
            // stands: rounded in place (one pass), or fp32, whose TF32 bits the tensor
            // core reads, its big part (3xTF32)
            const uint32_t a4[4] = {__float_as_uint(acc2[4 * j]), __float_as_uint(acc2[4 * j + 2]),
                                    __float_as_uint(acc2[4 * j + 1]), __float_as_uint(acc2[4 * j + 3])};
            if constexpr (!kOnePass) {
              const uint64_t ds = kmajor_desc(sb + kStage / 2 + kk * kStep1, kStep1 * 2, 128);
              wgmma_n64(acc, fl[kk], db);
              wgmma_n64(acc, a4, ds);
            }
            wgmma_n64(acc, a4, db);
          }
          wg_commit();
          // one pass: dz1 stays as it is, so one group stays in flight; 3xTF32:
          // the stage's fragments are rewritten by the next stage
          if constexpr (kOnePass) wg_wait<1>(); else wg_wait<0>();
          refill(q);
          ++q;
        }
      }
      wg_wait<0>();
      const uint32_t bits = maskb[i * kBThreads + tid];
#pragma unroll
      for (int j = 0; j < kNC / 8; ++j) {
        const int col = kNC * c + 8 * j + 2 * t;
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] = (bits >> (4 * j + e)) & 1u ? acc[4 * j + e] : 0.f;
        auto tv = [](float x) { return kOnePass ? __uint_as_float(round_tf32(x)) : x; };
        *reinterpret_cast<float2*>(tile + tix(r0, col)) = make_float2(tv(d[0]), tv(d[1]));
        *reinterpret_cast<float2*>(tile + tix(r0 + 8, col)) = make_float2(tv(d[2]), tv(d[3]));
        if (col < D) {
          if (ok0) *reinterpret_cast<float2*>(dz0g + (size_t)rg0 * D + col) = make_float2(d[0], d[1]);
          if (ok1) *reinterpret_cast<float2*>(dz0g + (size_t)rg1 * D + col) = make_float2(d[2], d[3]);
        }
        seg_sum(dwlp, D, col, d[0], d[1], d[2], d[3]);
      }
    }
    sync_consumers();  // the dz0 tile is whole

    // (5) dcross = dz0 . Wx^T[:, c]: dcross * arg_a out, darg = sum_t dcross vis by warp
    if (it + 1 < items) {  // the next item's vis and wv rows into L2 meanwhile (128-byte lines)
      const int nrow0 = row0 + gridDim.x * kBRows;
      for (int idx = tid; idx < 2 * kBRows * (D / 32); idx += kBThreads) {
        const int r = idx / (2 * (D / 32)), w = idx % (2 * (D / 32)), rr = nrow0 + r, pba = rr / T;
        const float* src = (w & 1 ? wv : vis) + ((size_t)(pba / A) * T + (rr - pba * T)) * D + 32 * (w >> 1);
        if (rr < R) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(src));
      }
    }
#pragma unroll 1
    for (int i = 0; i < mine; ++i) {
      const int c = wg + 2 * i;
      float acc[kNC / 2];
      tile_product(acc);
      float4 av[kNC / 8];  // arg at the two rows' (b, a)
      float2 x0[kNC / 8], x1[kNC / 8];  // the chunk's loads, issued together
#pragma unroll
      for (int j = 0; j < kNC / 8; ++j) {
        const int col = kNC * c + 8 * j + 2 * t;
        const float2 zero2 = make_float2(0.f, 0.f);
        const float2 a0 = ok0 && col < D ? __ldg(reinterpret_cast<const float2*>(arg + (size_t)ba0 * D + col)) : zero2;
        const float2 a1 = ok1 && col < D ? __ldg(reinterpret_cast<const float2*>(arg + (size_t)ba1 * D + col)) : zero2;
        x0[j] = ok0 && col < D ? __ldg(reinterpret_cast<const float2*>(vis + (size_t)vr0 * D + col)) : zero2;
        x1[j] = ok1 && col < D ? __ldg(reinterpret_cast<const float2*>(vis + (size_t)vr1 * D + col)) : zero2;
        av[j] = make_float4(a0.x, a0.y, a1.x, a1.y);
      }
#pragma unroll
      for (int j = 0; j < kNC / 8; ++j) {
        const int col = kNC * c + 8 * j + 2 * t;
        if (col >= D) continue;
        if (ok0)
          *reinterpret_cast<float2*>(dvisp + (size_t)rg0 * D + col) = make_float2(acc[4 * j] * av[j].x, acc[4 * j + 1] * av[j].y);
        if (ok1)
          *reinterpret_cast<float2*>(dvisp + (size_t)rg1 * D + col) =
              make_float2(acc[4 * j + 2] * av[j].z, acc[4 * j + 3] * av[j].w);
        seg_sum(dargp, D, col, acc[4 * j] * x0[j].x, acc[4 * j + 1] * x0[j].y, acc[4 * j + 2] * x1[j].x,
                acc[4 * j + 3] * x1[j].y);
      }
    }
  }
}

constexpr int kGM = 128;                          // output rows a block (dz columns j): two warpgroups of 64
constexpr int kGN = 256;                          // output columns a block (cross or h columns i)
constexpr int kGALd = kGM + 8;                    // A stage row stride: 8 (mod 32) words
constexpr int kGAStage = kTGroup * kGALd;         // floats: 32 rows of dz
constexpr int kGBPart = kTGroup * kGN;            // floats: 8 pieces of 4 rows x 256 columns
constexpr int kGStage = kGAStage + kParts * kGBPart;
constexpr int kGRing = kOnePass ? 4 : 2;
constexpr int kGThreads = 320;                    // two consumer warpgroups and two producer warps

size_t bwd_w_smem() { return sizeof(float) * (size_t)kGRing * kGStage + sizeof(uint64_t) * 2 * kGRing; }

// blockIdx.x: an output tile of dWx^T (ceil(D / 128) x ceil(D / 256) of
// them), then of dW1^T; blockIdx.y: a chunk of ``per`` row groups of 32.
// dz0 (groups x 32, D) and dz1 (groups x 32, Dh) rows, zero past R;
// crossT and hT the transposed layout (tpos), a plane each part, zero past R.
__global__ void __launch_bounds__(kGThreads, 1)
head_bwd_w_wg(const float* __restrict__ dz0, const float* __restrict__ dz1, const float* __restrict__ crossT,
              const float* __restrict__ hT, float* __restrict__ dwx_part, float* __restrict__ dw1_part, int D,
              int Dh, int groups, int per, size_t plane) {
  extern __shared__ __align__(1024) float4 gsm4[];
  float* sm = reinterpret_cast<float*>(gsm4);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kGRing * kGStage);
  uint64_t* empty = full + kGRing;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tn = (D + kGN - 1) / kGN, tmx = (D + kGM - 1) / kGM;
  int tile = blockIdx.x;
  const bool first = tile < tmx * tn;
  if (!first) tile -= tmx * tn;
  const int j0 = tile / tn * kGM, i0 = tile % tn * kGN;
  const int M = first ? D : Dh;
  const float* Y = first ? dz0 : dz1;
  const float* X = first ? crossT : hT;
  const int g_lo = blockIdx.y * per, nst = min(groups, g_lo + per) - g_lo;
  if (tid == 0) {
    for (int r = 0; r < kGRing; ++r) {
      mbar_init(full + r, 1);
      mbar_init(empty + r, 8);  // a consumer warp each
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producers, stages of parity warp - 8: lane l copies A row l, lanes 0 .. 8 kParts - 1 the B pieces
    const uint32_t abytes = 4 * min(kGM, M - j0), bbytes = 16 * min(kGN, D - i0);
    const uint32_t bytes = kTGroup * abytes + kParts * 8 * bbytes;
    for (int s = warp - 8; s < nst; s += 2) {
      const int slot = s % kGRing;
      if (s >= kGRing) mbar_wait(empty + slot, (s / kGRing - 1) & 1);
      if (lane == 0) mbar_expect(full + slot, bytes);
      __syncwarp();
      float* as = sm + slot * kGStage;
      const size_t grp = (size_t)g_lo + s;
      bulk_copy(as + lane * kGALd, Y + (grp * kTGroup + lane) * M + j0, abytes, full + slot);
      if (lane < 8 * kParts) {
        const int kq = lane & 7, p = lane >> 3;
        bulk_copy(as + kGAStage + p * kGBPart + kq * kGN * 4, X + p * plane + ((grp * 8 + kq) * D + i0) * 4, bbytes,
                  full + slot);
      }
    }
    return;
  }

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int m0 = 64 * wg + 16 * (warp & 3) + g;  // this thread's A rows (output rows j - j0): m0, m0 + 8
  float acc[kGN / 2];
#pragma unroll
  for (int i = 0; i < kGN / 2; ++i) acc[i] = 0.f;
  uint32_t fa[2][4], fs[2][4];
  for (int s = 0; s < nst; ++s) {
    const int slot = s % kGRing;
    mbar_wait(full + slot, (s / kGRing) & 1);
    const float* as = sm + slot * kGStage;
    const float* bs = as + kGAStage;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int f = kk & 1;
      const float* p = as + (8 * kk + t) * kGALd + m0;  // A(m, k) = dz[row k][column m]
      const float xs[4] = {p[0], p[8], p[4 * kGALd], p[4 * kGALd + 8]};
#pragma unroll
      for (int e = 0; e < 4; ++e) split<kOnePass>(xs[e], fa[f][e], fs[f][e]);
      wg_fence();
      // B: pieces 2 kk and 2 kk + 1 (rows 0-3, 4-7 of the k-step), 4 KB apart; 8-column groups 128 bytes apart
      const uint64_t db = kmajor_desc(bs + 2 * kk * kGN * 4, kGN * 16, 128);
      if constexpr (!kOnePass) {
        const uint64_t ds = kmajor_desc(bs + kGBPart + 2 * kk * kGN * 4, kGN * 16, 128);
        wgmma_n256(acc, fs[f], db);
        wgmma_n256(acc, fa[f], ds);
      }
      wgmma_n256(acc, fa[f], db);
      wg_commit();
      wg_wait<1>();
      if (kk == 0 && s > 0 && lane == 0) mbar_arrive(empty + (s - 1) % kGRing);  // stage s - 1 is read
    }
  }
  wg_wait<0>();
  // C fragment: acc[4q + e] at (m0 + 8 (e >> 1), column 8q + 2t + (e & 1)); out[i][j] = acc(j, i)
  float* out = (first ? dwx_part + (size_t)blockIdx.y * D * D : dw1_part + (size_t)blockIdx.y * D * Dh);
#pragma unroll
  for (int qq = 0; qq < kGN / 8; ++qq)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + m0 + 8 * (e >> 1), i = i0 + 8 * qq + 2 * t + (e & 1);
      if (j < M && i < D) out[(size_t)i * M + j] = acc[4 * qq + e];
    }
}

// The narrow backward's gradients from the kernels' parts, each a sum in a
// fixed order (16 bytes a thread; D % 4 == Dh % 4 == 0): dvis[b, t] =
// sum_a dvis_part[b, a, t] and dwv[b, t] = sum_a dz0[b, a, t]; dWx and dW1
// over the weight kernel's chunks; darg and dwl over their slots; db1 and
// dw2 over the row kernel's (item, warp) parts.
__global__ void __launch_bounds__(256)
head_bwd_finish(const float* __restrict__ dvisp, const float* __restrict__ dz0, const float* __restrict__ dwxp,
                const float* __restrict__ dw1p, const float* __restrict__ dargp, const float* __restrict__ dwlp,
                const float* __restrict__ db1p, const float* __restrict__ dw2p, float* __restrict__ dvis,
                float* __restrict__ dwv, float* __restrict__ dwx, float* __restrict__ dw1, float* __restrict__ darg,
                float* __restrict__ dwl, float* __restrict__ db1, float* __restrict__ dw2, int B, int A, int T, int D,
                int Dh, int chunks, int nslots, int nparts) {
  auto add = [](float4 a, float4 b) { return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w); };
  const int nq = Dh / 4;  // the last nq blocks: db1 and dw2, a column quad a block
  if ((int)blockIdx.x >= (int)gridDim.x - nq) {
    // a thread the parts tid, tid + 256, ... in order, then a fixed tree over the block
    __shared__ float4 red[2][256];
    const int c = blockIdx.x - (gridDim.x - nq);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    for (int pp = threadIdx.x; pp < nparts; pp += 256) {
      x = add(x, __ldg(reinterpret_cast<const float4*>(db1p) + (size_t)pp * nq + c));
      y = add(y, __ldg(reinterpret_cast<const float4*>(dw2p) + (size_t)pp * nq + c));
    }
    red[0][threadIdx.x] = x;
    red[1][threadIdx.x] = y;
    __syncthreads();
    for (int w = 128; w > 0; w >>= 1) {
      if ((int)threadIdx.x < w) {
        red[0][threadIdx.x] = add(red[0][threadIdx.x], red[0][threadIdx.x + w]);
        red[1][threadIdx.x] = add(red[1][threadIdx.x], red[1][threadIdx.x + w]);
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      reinterpret_cast<float4*>(db1)[c] = red[0][0];
      reinterpret_cast<float4*>(dw2)[c] = red[1][0];
    }
    return;
  }
  const size_t n1 = (size_t)B * T * D / 4, n2 = (size_t)D * D / 4, n3 = (size_t)D * Dh / 4;
  const size_t n4 = (size_t)B * A * D / 4, nb = gridDim.x - nq;
  const float4* v4 = reinterpret_cast<const float4*>(dvisp);
  const float4* z4 = reinterpret_cast<const float4*>(dz0);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n1 + n2 + n3 + n4; i += nb * blockDim.x) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (i < n1) {  // over the args (32-bit index math: fewer than 2^31 float4 a tensor)
      const unsigned d4 = D / 4, bt = (unsigned)i / d4, b = bt / T, tr = bt - b * T, c = (unsigned)i - bt * d4;
      for (int a = 0; a < A; ++a) {
        const size_t at = ((size_t)(b * A + a) * T + tr) * d4 + c;
        x = add(x, __ldg(v4 + at));
        y = add(y, __ldg(z4 + at));
      }
      reinterpret_cast<float4*>(dvis)[i] = x;
      reinterpret_cast<float4*>(dwv)[i] = y;
    } else if (i < n1 + n2 + n3) {  // over the chunks
      const bool first = i < n1 + n2;
      const size_t o = first ? i - n1 : i - n1 - n2, n = first ? n2 : n3;
      const float4* src = reinterpret_cast<const float4*>(first ? dwxp : dw1p) + o;
      for (int c = 0; c < chunks; ++c) x = add(x, __ldg(src + c * n));
      reinterpret_cast<float4*>(first ? dwx : dw1)[o] = x;
    } else {  // over the slots
      const unsigned o = (unsigned)(i - n1 - n2 - n3), ba = o / (D / 4), c = o - ba * (D / 4);
      for (int sl = 0; sl < nslots; ++sl) {
        const size_t at = (ba * nslots + sl) * (D / 4) + c;
        x = add(x, __ldg(reinterpret_cast<const float4*>(dargp) + at));
        y = add(y, __ldg(reinterpret_cast<const float4*>(dwlp) + at));
      }
      reinterpret_cast<float4*>(darg)[o] = x;
      reinterpret_cast<float4*>(dwl)[o] = y;
    }
  }
}

// The narrow path's backward: the two streams, the row kernel (a
// persistent grid), then the weight kernel (``chunks`` x ``per`` row groups)
int launch_bwd_wg(const float* vis, const float* arg, const float* wv, const float* wl, const float* wx,
                  const float* w1, const float* b1, const float* w2, const float* gin, float* wstream,
                  float* crossT, float* hT, float* dz0, float* dz1, float* dvisp, float* dargp,
                  float* dwlp, float* db1p, float* dw2p, float* dwx_part, float* dw1_part, float* const* out,
                  int B, int A, int T, int D, int Dh, int chunks, int per, int device, cudaStream_t stream) {
  int sms = 0;
  cudaError_t e = sm_count(device, sms);
  if (e != cudaSuccess) return (int)e;
  const int Dp = (D + kNC - 1) / kNC * kNC;
  const size_t R = (size_t)B * A * T;
  const int groups = (int)((R + kTGroup - 1) / kTGroup);
  if (chunks != (groups + per - 1) / per) return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)groups * kTGroup * D;
  // zero past R: the last row group of each transposed plane, the dz rows past R
  for (int p = 0; p < kParts && e == cudaSuccess; ++p) {
    const size_t last = (size_t)(groups - 1) * kTGroup * D;
    e = cudaMemsetAsync(crossT + p * plane + last, 0, sizeof(float) * kTGroup * D, stream);
    if (e == cudaSuccess) e = cudaMemsetAsync(hT + p * plane + last, 0, sizeof(float) * kTGroup * D, stream);
  }
  const size_t pad = (size_t)groups * kTGroup - R;
  if (e == cudaSuccess && pad) e = cudaMemsetAsync(dz0 + R * D, 0, sizeof(float) * pad * D, stream);
  if (e == cudaSuccess && pad) e = cudaMemsetAsync(dz1 + R * Dh, 0, sizeof(float) * pad * Dh, stream);
  // the slots of darg's and dwl's parts that no 16-row block meets stay 0
  const size_t slots = (size_t)B * A * ((T + 15) / 16 + 1) * D;
  if (e == cudaSuccess) e = cudaMemsetAsync(dargp, 0, sizeof(float) * slots, stream);
  if (e == cudaSuccess) e = cudaMemsetAsync(dwlp, 0, sizeof(float) * slots, stream);
  if (e != cudaSuccess) return (int)e;
  const size_t first = (size_t)kParts * (Dp / kNC) * chunk_floats(Dp, 1);
  const size_t total = first + bwd_stream_floats(Dp, Dh);
  head_bwd_prep<<<(int)((total + 255) / 256), 256, 0, stream>>>(wx, w1, wstream, D, Dp, Dh);
  const size_t rsm = bwd_rows_smem(Dp), wsm = bwd_w_smem();
  e = cudaFuncSetAttribute(head_bwd_rows_wg, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rsm);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(head_bwd_w_wg, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wsm);
  if (e != cudaSuccess) return (int)e;
  const int items = (int)((R + kBRows - 1) / kBRows);
  head_bwd_rows_wg<<<items < sms ? items : sms, kBThreads + kProdThreads, rsm, stream>>>(
      vis, arg, wv, wl, wstream, wstream + first, b1, w2, gin, crossT, hT, dz0, dz1, dvisp, dargp, dwlp, db1p, dw2p, B, A,
      T, D, Dp, Dh, plane);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((D + kGM - 1) / kGM + (Dh + kGM - 1) / kGM) * ((D + kGN - 1) / kGN);
  head_bwd_w_wg<<<dim3(tiles, chunks), kGThreads, wsm, stream>>>(dz0, dz1, crossT, hT, dwx_part, dw1_part, D, Dh,
                                                                 groups, per, plane);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nslots = (T + 15) / 16 + 1, nparts = 4 * items;
  const size_t n = ((size_t)B * T * D + (size_t)D * D + (size_t)D * Dh + (size_t)B * A * D) / 4;
  const int nb = (int)((n + 255) / 256 < 8 * (size_t)sms ? (n + 255) / 256 : 8 * (size_t)sms);
  head_bwd_finish<<<nb + Dh / 4, 256, 0, stream>>>(
      dvisp, dz0, dwx_part, dw1_part, dargp, dwlp, db1p, dw2p, out[0], out[1], out[2], out[3], out[4], out[5], out[6],
      out[7], B, A, T, D, Dh, chunks, nslots, nparts);
  return (int)cudaGetLastError();
}

}  // namespace

// The wide path (D > 512 or Dh > 256; D % 32 == 0, Dh % 16 == 0, the
// wrapper zero-pads other widths).  cross, h, dz0: (B, A, T, D) and dz1
// (B, A, T, Dh) scratch between the two kernels; chunks: the row split of
// the weight-gradient kernel (dwx_part holds chunks x D x D, dw1_part
// chunks x D x Dh); darg/dwl partials hold B x ceil(T/16) x A x D, db1/dw2
// partials B x ceil(T/16) x Dh.
extern "C" int vog_head_bwd(int device, const float* vis, const float* arg, const float* wv,
                            const float* wl, const float* wx, const float* w1,
                            const float* b1, const float* w2, const float* gin,
                            float* cross, float* h, float* dz0, float* dz1, float* dvis,
                            float* dwv, float* darg_part, float* dwl_part,
                            float* db1_part, float* dw2_part, float* dwx_part,
                            float* dw1_part, int B, int A, int T, int D, int Dh,
                            int chunks, void* stream) {
  VOG_DEVICE_GUARD(device);
  if (D < 32 || D % 32 != 0 || Dh < 16 || Dh % 16 != 0 || chunks < 1 || !aligned16(wx) ||
      !aligned16(w1) || (D <= kMaxD && Dh <= kMaxHid))  // the weights stream by 16-byte cp.async
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VOG_HEAD_BWD_CASE(n)                                                                          \
  case n:                                                                                             \
    return launch_bwd<n>(vis, arg, wv, wl, wx, w1, b1, w2, gin, cross, h, dz0, dz1, dvis, dwv, darg_part, \
                         dwl_part, db1_part, dw2_part, dwx_part, dw1_part, B, T, D, Dh, chunks, device, s);
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

// The narrow path (D <= 512, Dh <= 256; D % 32 == 0, Dh % 16 == 0; T >=
// 16, the wrapper pads a shorter one), any A.
// Scratch: wstream, the forward's stream (vog_head_fwd_prep's size at Dh
// <= 256) and then the backward's (kParts x D_pad / 64 x (ceil(Dh / 32) +
// D_pad / 32) x 2048 floats); crossT and hT kParts planes of ceil(R /
// 32) 32 x D floats (R = B A T rows (b, a, t)); dz0 and dz1 ceil(R / 32)
// 32 rows of D and Dh; dvis_part (B, A, T, D: dcross * arg_a); the parts
// darg_part and dwl_part (B A, ceil(T / 16) + 1, D: a slot a 16-row block
// that meets the (b, a)'s rows, the others zeroed here), db1_part and
// dw2_part (ceil(R / 64), 4, Dh), dwx_part (chunks, D, D) and dw1_part
// (chunks, D, Dh), chunks = ceil(ceil(R / 32) / per).  Out (head_bwd_finish):
// dvis, dwv (B, T, D), dwx (D, D), dw1 (D, Dh), darg, dwl (B, A, D), db1,
// dw2 (Dh).
extern "C" int vog_head_bwd_wg(int device, const float* vis, const float* arg, const float* wv, const float* wl,
                               const float* wx, const float* w1, const float* b1, const float* w2,
                               const float* gin, float* wstream, float* crossT, float* hT,
                               float* dz0, float* dz1, float* dvis_part, float* darg_part, float* dwl_part,
                               float* db1_part, float* dw2_part, float* dwx_part, float* dw1_part, float* dvis,
                               float* dwv, float* dwx, float* dw1, float* darg, float* dwl, float* db1, float* dw2,
                               int B, int A, int T, int D, int Dh, int chunks, int per, void* stream) {
  VOG_DEVICE_GUARD(device);
  if (D < 32 || D % 32 != 0 || Dh < 16 || Dh % 16 != 0 || D > kMaxD || Dh > kMaxHid || A < 1 || per < 1 ||
      (T > 0 && T < 16) || !aligned16(vis) || !aligned16(arg) || !aligned16(wstream) || !aligned16(crossT) ||
      !aligned16(hT) || !aligned16(dz0) || !aligned16(dz1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  float* const out[8] = {dvis, dwv, dwx, dw1, darg, dwl, db1, dw2};
  return launch_bwd_wg(vis, arg, wv, wl, wx, w1, b1, w2, gin, wstream, crossT, hT, dz0, dz1, dvis_part,
                       darg_part, dwl_part, db1_part, dw2_part, dwx_part, dw1_part, out, B, A, T, D, Dh,
                       chunks, per, device, static_cast<cudaStream_t>(stream));
}

// The forward's weight stream (head_fwd_prep): wstream holds kParts (2, or
// 1 in the one-pass library) x D_pad / 64 x (D_pad * 64 + 8 * ceil(Dh /
// 256) * 2048) floats, D_pad = ceil(D / 64) 64.  D % 32 == 0 and Dh % 16
// == 0 (the wrapper zero-pads other widths).
extern "C" int vog_head_fwd_prep(int device, const float* wx, const float* w1, float* wstream, int D, int Dh,
                                 void* stream) {
  VOG_DEVICE_GUARD(device);
  if (D < 32 || D % 32 != 0 || Dh < 16 || Dh % 16 != 0) return (int)cudaErrorInvalidValue;
  const int Dp = (D + kNC - 1) / kNC * kNC;
  const int total = kParts * (Dp / kNC) * chunk_floats(Dp, hidden_groups(Dh));
  head_fwd_prep<<<(total + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(wx, w1, wstream,
                                                                                    D, Dp, Dh);
  return (int)cudaGetLastError();
}

// The narrow backward's streams (head_bwd_prep, launched by vog_head_bwd_wg;
// here for a check against its plain version): wstream holds the forward's
// stream and then the backward's, as vog_head_bwd_wg takes them.
extern "C" int vog_head_bwd_prep(int device, const float* wx, const float* w1, float* wstream, int D, int Dh,
                                 void* stream) {
  VOG_DEVICE_GUARD(device);
  if (D < 32 || D % 32 != 0 || Dh < 16 || Dh % 16 != 0 || D > kMaxD || Dh > kMaxHid) return (int)cudaErrorInvalidValue;
  const int Dp = (D + kNC - 1) / kNC * kNC;
  const size_t total = (size_t)kParts * (Dp / kNC) * chunk_floats(Dp, 1) + bwd_stream_floats(Dp, Dh);
  head_bwd_prep<<<(int)((total + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(wx, w1, wstream, D, Dp,
                                                                                         Dh);
  return (int)cudaGetLastError();
}

// logits from the stream that vog_head_fwd_prep wrote; any A, D % 32 == 0,
// Dh % 16 == 0; past D 512 or Dh 256 (the wide path) zs holds zs_blocks x
// 64 x D_pad floats of scratch (else it may be null)
extern "C" int vog_head_fwd(int device, const float* vis, const float* arg, const float* wv,
                            const float* wl, const float* wstream, const float* b1,
                            const float* w2, const float* b2, float* out, float* zs,
                            int zs_blocks, int B, int A, int T, int D, int Dh, void* stream) {
  VOG_DEVICE_GUARD(device);
  if (D < 32 || D % 32 != 0 || Dh < 16 || Dh % 16 != 0 || A < 1 || !aligned16(vis) || !aligned16(arg) ||
      !aligned16(wv) || !aligned16(wl) || !aligned16(wstream))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  return launch_fwd(vis, arg, wv, wl, wstream, b1, w2, b2, out, zs, zs_blocks, B, A, T, D, Dh, device,
                    static_cast<cudaStream_t>(stream));
}
