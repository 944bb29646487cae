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
//
// Widths: D % 32 == 0 and Dh % 16 == 0 (the wrapper zero-pads others,
// exactly).  Up to D 512 and Dh 256 the kernels run as above (their narrow
// path).  Past either they take their wide path (template flag W): the
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
// backward's mma.sync products take one pass (split, mma_p).  The
// operands stay fp32, as the JAX package keeps them.


#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

#include "tiles.cuh"  // cp.async; through it tf32.cuh: split, mma_p, round_tf32, kOnePass
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
// forward: Hopper helpers (wgmma, mbarrier, bulk copy)
// ---------------------------------------------------------------------------

// shared-memory matrix descriptor of a K-major operand without swizzle:
// core matrices of 8 rows x 16 bytes, ``lbo`` bytes between the two core
// matrices of a k-step (k 0-3, 4-7), ``sbo`` bytes between 8-row groups
__device__ inline uint64_t kmajor_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3ffff) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32;
}
__device__ inline void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ inline void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// wait until at most N of the warpgroup's committed wgmma groups are in flight
template <int N>
__device__ inline void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
// ``bytes`` (a multiple of 16) from global to shared memory by the copy
// engine; the mbarrier completes when they have landed
__device__ inline void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// d (64 x 64, C-fragment order) += a (this warp's 16 x 8 rows, registers) . b (8 x 64,
// K-major in shared memory: the descriptor ``desc``), TF32 inputs, fp32 sums
__device__ inline void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

// d (64 x 256, C-fragment order) += a (this warp's 16 x 8 rows, registers) . b (8 x 256,
// K-major in shared memory: the descriptor ``desc``), TF32 inputs, fp32 sums
__device__ inline void wgmma_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

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
__global__ void __launch_bounds__(256)
head_fwd_prep(const float* __restrict__ wx, const float* __restrict__ w1,
              float* __restrict__ stream, int D, int Dp, int Dh) {
  const int per = chunk_floats(Dp, hidden_groups(Dh)), total = kParts * (Dp / kNC) * per;
  for (int o = blockIdx.x * blockDim.x + threadIdx.x; o < total; o += gridDim.x * blockDim.x) {
    const int stage = o / kStage, part = kOnePass ? 0 : (o / kStep2) & 1;
    const int raw = stage * kStep2 + o % kStep2;  // the weight's place in the unsplit stream
    const int c = raw / per, r = raw - c * per;
    const int z1 = r >= Dp / 8 * kStep1;
    const int step = z1 ? (r - Dp / 8 * kStep1) / kStep2 : r / kStep1;  // z1: 8 hg + j
    const int w = z1 ? (r - Dp / 8 * kStep1) % kStep2 : r % kStep1;
    const int u = w & 3, n8 = (w >> 2) & 7, half = w / (z1 ? kStep2 / 2 : kStep1 / 2);
    const int ng = (w % (z1 ? kStep2 / 2 : kStep1 / 2)) >> 5;
    const int n = 8 * ng + n8, kk = 8 * (z1 ? step % 8 : step) + 2 * u + half;
    float v = 0.f;
    if (z1) {  // W1 row 64c + kk, column 256 hg + n
      const int k = kNC * c + kk, col = kNZ * (step / 8) + n;
      if (k < D && col < Dh) v = w1[(size_t)k * Dh + col];
    } else {  // Wx row kk, column 64c + n
      const int col = kNC * c + n;
      if (kk < D && col < D) v = wx[(size_t)kk * D + col];
    }
    if constexpr (kOnePass) {
      stream[o] = __uint_as_float(round_tf32(v));
    } else {
      const float big = __uint_as_float(__float_as_uint(v) & kBigMask);
      stream[o] = part ? v - big : big;
    }
  }
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// The row kernel's narrow path (D <= 512, Dh <= 256): the (A*16, D) tile
// holds cross, h, dz1 and dz0 in turn, each warp 32 z0 and 16 z1 columns.
template <int A>
__device__ __forceinline__ void bwd_rows_narrow(const float* __restrict__ vis, const float* __restrict__ arg,
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

template <int A, bool W>
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
  if constexpr (W)
    bwd_rows_wide<A>(vis, arg, wv, wl, wx, w1, b1, w2, gin, cross_out, h_out, dz0_out, dz1_out, dvis, dwv,
                     darg_part, dwl_part, db1_part, dw2_part, T, D, Dh, b_first);
  else
    bwd_rows_narrow<A>(vis, arg, wv, wl, wx, w1, b1, w2, gin, cross_out, h_out, dz0_out, dz1_out, dvis, dwv,
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

// shared memory of the row kernel: its tile of A * 16 rows (of D + 4
// floats, or of a wide path's K slice) and the warps' weight rings
template <int A, bool W>
size_t rows_smem(int D) {
  return sizeof(float) * ((size_t)A * kBT * ((W ? kBK : D) + 4) + kWarps * kRing * kWarpSlab);
}

// The row kernel's blocks of batch rows [b0, b1), then on the same stream
// the weight kernel over their rows in chunks [c0, c1).
template <int A, bool W>
cudaError_t launch_part(const float* vis, const float* arg, const float* wv, const float* wl,
                        const float* wx, const float* w1, const float* b1, const float* w2,
                        const float* gin, float* cross, float* h, float* dz0, float* dz1,
                        float* dvis, float* dwv, float* darg_part, float* dwl_part,
                        float* db1_part, float* dw2_part, float* dwx_part, float* dw1_part,
                        int T, int D, int Dh, int bb0, int bb1, int c0, int c1,
                        cudaStream_t stream) {
  head_bwd_rows<A, W><<<dim3((T + kBT - 1) / kBT, bb1 - bb0), kThreads, rows_smem<A, W>(D), stream>>>(
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
template <int A, bool W>
int launch_bwd(const float* vis, const float* arg, const float* wv, const float* wl,
               const float* wx, const float* w1, const float* b1, const float* w2,
               const float* gin, float* cross, float* h, float* dz0, float* dz1, float* dvis,
               float* dwv, float* darg_part, float* dwl_part, float* db1_part,
               float* dw2_part, float* dwx_part, float* dw1_part, int B, int T,
               int D, int Dh, int chunks, int device, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      head_bwd_rows<A, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rows_smem<A, W>(D));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(head_bwd_w, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(sizeof(float) * kWStages * kWStage));
  SideStream* side = nullptr;
  if (e == cudaSuccess) e = side_stream(device, side);
  if (e != cudaSuccess) return (int)e;
  const int nb1 = side->sms / ((T + kBT - 1) / kBT);
  const int c1 = (int)((long long)chunks * nb1 / B);
  if (nb1 < 1 || nb1 >= B || c1 < 1 || c1 >= chunks)  // no second wave, or too few chunks
    return (int)launch_part<A, W>(vis, arg, wv, wl, wx, w1, b1, w2, gin, cross, h, dz0, dz1, dvis,
                               dwv, darg_part, dwl_part, db1_part, dw2_part, dwx_part, dw1_part,
                               T, D, Dh, 0, B, 0, chunks, stream);
  e = cudaEventRecord(side->in, stream);  // the inputs are ready on the caller's stream
  if (e == cudaSuccess) e = cudaStreamWaitEvent(side->s, side->in, 0);
  if (e == cudaSuccess)
    e = launch_part<A, W>(vis, arg, wv, wl, wx, w1, b1, w2, gin, cross, h, dz0, dz1, dvis, dwv,
                          darg_part, dwl_part, db1_part, dw2_part, dwx_part, dw1_part, T, D, Dh,
                          0, nb1, 0, c1, stream);
  if (e == cudaSuccess)
    e = launch_part<A, W>(vis, arg, wv, wl, wx, w1, b1, w2, gin, cross, h, dz0, dz1, dvis, dwv,
                          darg_part, dwl_part, db1_part, dw2_part, dwx_part, dw1_part, T, D, Dh,
                          nb1, B, c1, chunks, side->s);
  if (e == cudaSuccess) e = cudaEventRecord(side->out, side->s);
  if (e == cudaSuccess) e = cudaStreamWaitEvent(stream, side->out, 0);
  return (int)e;
}

}  // namespace

// D % 32 == 0, Dh % 16 == 0 (the wrapper zero-pads other widths).
// cross, h, dz0: (B, A, T, D) and dz1 (B, A, T, Dh) scratch between the
// two kernels; chunks: the row split of the weight-gradient kernel
// (dwx_part holds chunks x D x D, dw1_part chunks x D x Dh); darg/dwl partials hold
// B x ceil(T/16) x A x D, db1/dw2 partials B x ceil(T/16) x Dh.
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
      !aligned16(w1))  // the weights stream by 16-byte cp.async
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = D > kMaxD || Dh > kMaxHid;
#define VOG_HEAD_BWD_CASE(n)                                                                   \
  case n:                                                                                      \
    return wide ? launch_bwd<n, true>(vis, arg, wv, wl, wx, w1, b1, w2, gin, cross, h, dz0, dz1,  \
                                      dvis, dwv, darg_part, dwl_part, db1_part, dw2_part,      \
                                      dwx_part, dw1_part, B, T, D, Dh, chunks, device, s)      \
                : launch_bwd<n, false>(vis, arg, wv, wl, wx, w1, b1, w2, gin, cross, h, dz0, dz1, \
                                       dvis, dwv, darg_part, dwl_part, db1_part, dw2_part,     \
                                       dwx_part, dw1_part, B, T, D, Dh, chunks, device, s);
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
