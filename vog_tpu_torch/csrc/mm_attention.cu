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
// times are in PERF.md.  mm_fwd runs every "highest" instance.
//
// Forward at a one-pass precision ("default"), dh <= 128: mm_fwd_wg, on
// Hopper's wgmma (hopper.cuh).  Its work is mm_fwd's, 2 BH T^2 dh (1 + A):
// 3.93 GFLOP at GT5, 196.6 at P100 (BH 8, T 4000, A 5), 0.008 and 0.40 ms
// at 495 TF32 TFLOP/s; GT5 is bound by its 32.8 MB output (0.016 ms).
// mm_fwd's 16-row blocks (each K/V tile fetched once per 16 query rows),
// three phases a tile with a __syncthreads after each, and mma.sync held
// it at ~41 TFLOP/s (4.7608 ms at P100, 0.1648 at GT5; PERF.md, H100
// 80GB HBM3, 700 W), and its A = 8 instance spilled.  Two kernels:
//  * mm_fwd_prep_wg: km rounded to TF32 into scratch the wrapper
//    allocates (the streamed B operand of S), as mm_bwd_prep_wg rounds
//    g_a and qm;
//  * mm_fwd_wg: a block of 384 threads owns 64 query rows (wgmma's M):
//    two consumer warpgroups and a producer warpgroup (setmaxnreg 40 /
//    232).  The block's Q rows stay resident (32 KB, rounded to
//    TF32 in place once); the producer streams 32-key tiles, K (with the
//    tile's key codes and each arg's cn) and V in slots of their own, two
//    each, by 16-byte cp.async from all 128 threads, under mbarriers both
//    ways: a K slot is freed once the tile's scores and softmax are done,
//    a V slot once the consumers hold its fragments, so each loads a tile
//    ahead.  The per-arg output state sets the shape: O_a of 64 rows x 128
//    columns is 32 accumulators a thread an arg in each warpgroup when the
//    two warpgroups split the head dim (64 columns each; 160 at A = 5, a
//    launch's most: kernels/mm_attention.py §fwd_groups runs more in
//    groups, each launch writing its args in place into the outputs of
//    every arg, km rounded once a call).  TF32 wgmma reads K-major operands only, so
//    the value product is the transposed one mm_bwd_dkv_wg uses for dV^T:
//    O_a^T += V^T P_a^T, with V^T's A fragments read from the V tile as it
//    lies (in §wg_d_of_m's head-dim order, rounded in registers once a
//    k-step for every arg) and P_a staged [query][key] in K-major core
//    matrices as the B operand.  Each warpgroup computes the tile's
//    scores S = Q K^T (m64n32k8, both operands in shared memory) and the
//    frame bias and key masks, then per arg each row's max over the tile
//    (so the two warpgroups hold the same maxima with no exchange) and
//    the exps of its own 16 keys only (every exp once a block), their sum
//    into its part of the row sums, P_a rounded into the shared staging
//    tile.  The softmax is lazy, as FlashAttention-4's: a row's reference
//    max moves only where the tile's max passes it by more than kLazy (8;
//    a warp's 16 rows together, by a vote), so P <= e^8 and O_a^T is
//    rescaled only in the tiles that move a reference (the factors in the
//    order §fw_pos gives, a lane's 16 query columns of O^T in four 16-byte
//    reads, and a flag a warp); each lane keeps its part of the true max,
//    and the denominator is rebased onto it at the end.  The tile
//    pipeline: S of tile i + 1 and O_a^T of tile i (A x 4 m64n64k8) run
//    on the tensor core together, then the softmax of tile i + 1 (kept in
//    flight across it, the products' accumulators and V^T's fragments
//    beside the softmax's registers spilled at A = 5); the two
//    warpgroups meet on a named barrier once a tile (P of tile i + 1
//    whole, both done reading P of tile i: two staging buffers).  O_a^T is
//    rescaled before S of tile i + 1 is issued: ptxas serializes every
//    wgmma of a kernel in which a non-wgmma instruction reads or writes an
//    accumulator while any wgmma is in flight.  At the end each row's two
//    sums are added in order, O_a = (O_a^T)^T / sum is stored a float2
//    (two head-dim columns of a row) a store, and the row max and den (>=
//    1) are written in the meaning mm_bwd_prep_wg and mm_bwd_dkv_wg read.
//    Keys: masked -1e30, past T -inf (key_code<true>); rows past T are
//    not written; the frame table is read through the read-only cache at
//    any F; F and dh <= 128 are run-time, A a template parameter (1..5:
//    the accumulators and every arg loop static).  No atomics: a repeated
//    call is bitwise equal.  222 KB of shared memory, one block an SM:
//    GT5's 4 x 64 blocks 1.94 waves on 132 SMs, P100's 63 x 8 3.82.
//    Where its time goes: tools/mm_wg_phases.py --kernel fwd.
//
// Backward: the counterpart of the TPU's dk/dv/dcn kernel in both of its
// modes (vog_tpu/kernels/mm_attention.py §_make_bwd_dkv_kernel(True) in the
// default "emit" mode, (False) with §_bwd_dq_kernel in "recompute" mode),
// from the saved per-arg row max m_a and denominator den_a:
//   p_a = exp(s + cn_a - m_a),  ds_a = p_a (g_a.vm - delta_a) / den_a,
//   dv = sum_a (p_a / den_a)^T g_a,  comb = sum_a ds_a (valid keys),
//   dk = comb^T qm,  dcn_a = sum_i ds_a,
// and, in emit mode, comb (B*H, T, T) written out: dq = comb . km and the
// frame-bias gradient are products over it outside the kernel, as in the
// TPU package.
// At GT5 the kernel's work is 2 BH T^2 dh (2 + 2A) = 7.9 GFLOP (S, dK,
// and per arg dP_a and dV): bound by operations, so it runs on the tensor
// cores in 3xTF32 (the previous design, on the CUDA cores in fp32 FMA,
// issued about one shared-memory load for every 3-7 FMAs).  Two kernels:
//  * mm_bwd_delta: delta_a = rowsum(g_a * o_a), a warp a row;
//  * mm_bwd_dkv, modelled on csrc/attention.cu's flash_bwd_dkv: a block of
//    4 warps owns 64 keys (a warp 16), K and V resident in shared memory,
//    and walks the query rows in tiles of 16.  Per tile it computes S^T =
//    K Q^T + fb ONCE for all args; then per arg a, dP_a^T = V G_a^T, P_a^T
//    = exp(S^T + cn_a - m_a) / den_a, dV += P_a^T G_a (P passed from the C
//    to the A fragment in registers), ds_a = P_a^T (dP_a^T - delta_a)
//    added into comb^T and into this lane's dcn_a partial; after the last
//    arg, comb^T is masked, dK += comb^T Q, and comb is stored from the C
//    fragments (each store writes 8 consecutive keys of 4 query rows: whole
//    32-byte sectors).  Every product is mma.sync m16n8k8 in 3xTF32 through
//    tiles.cuh.  The stream is a ring over (query tile, arg) steps: each
//    step's g_a tile (and with arg 0 the tile's Q rows, m, den, delta and
//    frames) comes in by cp.async one step ahead, one __syncthreads a step.
//    dcn is reduced over the 4 lanes of a key by a fixed shuffle tree: the
//    gradients are the same on every run.  103 KB of shared memory at A=5,
//    two blocks (8 warps) an SM, so at GT5 the 4 x 64 = 256 blocks run as
//    one wave; warps whose keys all lie past T only load.
// The previous design (fp32 FMA on the CUDA cores: a lane a query row, 32
// keys a block, synchronous staging of Q and the A g_a tiles, 158 KB of
// shared memory, one block an SM) took 0.8822 / 0.8867 ms at GT5
// (chip_smoke.py, H100 80GB HBM3, 700 W); this design's times are in
// PERF.md.  mm_bwd_dkv runs every "highest" instance and recompute mode.
//
// Emit mode at "default" (the production recipe's: one TF32 pass, comb in
// bf16), dh <= 128: mm_bwd_dkv_wg, on Hopper's wgmma (hopper.cuh).  Its
// work is that of mm_bwd_dkv, 7.9 GFLOP at GT5 and 393 at P100 (BH 8, T
// 4000, A 5): 0.016 and 0.79 ms at 495 TF32 TFLOP/s.  mm_bwd_dkv's 16-row
// query tiles (each A fragment fed two 8-key products) and one
// __syncthreads a (tile, arg) step held it at 34-52 TFLOP/s (0.2287 ms at
// GT5, 7.6208 at P100; PERF.md "PR 21", run S, H100 80GB HBM3, 700 W), and
// its A = 5 instance spilled 112 bytes.  Two kernels:
//  * mm_bwd_prep_wg, a warp a row: delta_a as mm_bwd_delta forms it, and
//    the wgmma operands rounded to TF32 into scratch the wrapper allocates
//    (g_a's rows, qm's rows) with 1 / den_a;
//  * mm_bwd_dkv_wg: a block of 384 threads owns 128 keys, two consumer
//    warpgroups of 64 keys each (wgmma's M) and a producer warpgroup
//    (setmaxnreg: 40 registers, the consumers 232, as grounding_head.cu's
//    row kernel).  K and V of the block's keys stay resident (64 KB each),
//    in K-major core matrices (8 rows x 16 bytes), rounded to TF32 once.
//    The producer streams each query tile of 32 rows: its Q rows and
//    frames into one of two Q slots, then each arg's g_a rows with the
//    rows' m_a, 1 / den_a and delta_a into one of two g_a slots, in the
//    same core matrices, each slot as the consumers free it (mbarriers both
//    ways).  Each producer thread copies one row's 8 of 32 column groups by
//    16-byte cp.async (all 128 threads issue: PERF.md "PR 21" found a warp
//    that issues bulk copies waits for each; a bulk copy lands a row
//    contiguous, and no TMA box lands rows in these padded core matrices),
//    then fences them for the async proxy.
//    A consumer warpgroup, per query tile: S^T = K Q^T (64 keys x 32 rows,
//    16 k-steps of m64n32k8, both operands from shared memory) and the
//    frame bias, masks, once for all args; per arg, dP_a^T = V G_a^T
//    (m64n32k8) and, while it runs, P_a^T = exp(S^T + cn_a - m_a) / den_a
//    (no branch: 0 past T and at keys past T by a factor); then ds_a =
//    P_a^T (dP_a^T - delta_a), comb^T += ds_a, dcn_a's partial (a 4-lane
//    sum, added into shared memory by the key's one thread: the tiles in
//    order), and dV^T += G_a^T P_a: TF32 wgmma takes no transposed
//    operand, so P_a^T goes from the C fragments into a K-major staging
//    tile (the B operand) and the A fragments of G_a^T are read from the
//    g_a tile as it stands (a float2 gives two head-dim rows: the product's
//    M rows are the head dim in the order kernels/mm_attention.py
//    §wg_d_of_m mirrors).  After the last arg: comb^T masked to the valid
//    keys, dK^T += Q^T comb the same way, and comb in bf16 staged [query]
//    [key] and stored 16 bytes (8 keys) a store while that product runs.
//    dK^T and dV^T (128 head-dim rows x 64 keys, 64 registers each) stay
//    in the wgmma accumulators over every tile; a product's chain over T
//    keeps the tensor core's fp32 sums ("default": one TF32 pass, operands
//    to ~5e-4 already); dK, dV and dcn are written once.  No atomics: a
//    repeated call is bitwise equal.  226 KB of shared memory, one block an
//    SM: GT5's 2 x 64 blocks one wave, P100's 32 x 8 two.  The frame table
//    is read through the read-only cache at any F; A (1..8) is a run-time
//    argument: one instance.
// Where its time goes: tools/mm_wg_phases.py (clock64 phases a (query
// tile, arg) step; its readings in PERF.md "PR 23").  Tried first: the
// producer rounding each stage in place after its copies (its shared-memory
// reads wait behind the consumers' wgmma operand traffic, and it bounded
// the kernel); loads rounded on their way in, four in flight (slower
// still); each probability behind a branch (exp under a test); the dcn
// sums moved under dV^T (no faster).  The rounding pass before the kernel
// moves g_a once more through device memory, which GT5's short rows feel
// and P100's do not.
//
// Recompute mode: mm_bwd_dkv without the comb store (kEmit false), then
// mm_bwd_dq, the counterpart of §_bwd_dq_kernel: no (T, T) buffer (comb is
// 512 MB at P100, B=2, T=4000), for (2 + A) more products over every (i,
// j): S, each g_a.vm^T, and comb.km (229 GFLOP at P100, A=5: bound by
// operations, 1.39 ms of the bound).  On the H100 the products are 3xTF32
// mma.sync, whose fragments each warp splits as it reads them, so what
// bounds a kernel is how many products each split fragment feeds and how
// many warps hide the shared-memory latency.  The previous design (4
// warps an SM: a block of 32 query rows with all A g_a tiles resident,
// 139 KB; 16-key tiles, 8 keys a warp, so each split A fragment fed one
// product; the frame sums through a per-warp shared tile, a lane per
// frame) took 12.19 / 11.94 ms at P100 (chip_smoke.py, H100 80GB HBM3,
// 700 W), 19 TFLOP/s.  This design: a block of 8 warps owns 64 query rows
// (four row groups of 16, two key halves each) with its Q rows resident,
// and walks the keys in tiles of 64: a tile's km, vm, cn and key codes
// come in by cp.async once every warp is done with the tile before, and
// the steps (tile, arg) stream the arg's g_a rows by cp.async into a
// two-stage ring, one step ahead, as mm_bwd_dkv streams (query tile, arg):
// the A g_a tiles are never all resident (193 KB at A=8, F=64: any A, one
// block of 8 warps an SM), and each g_a row is read once a 64-key tile.
// Warp (row group r, key half k) takes the tile's keys 32k..32k+31 for its
// 16 rows (four 8-key n-tiles per split A fragment): S = Q K^T + fb at arg
// 0, kept in registers over the args; per arg gv_a = G_a V^T and ds_a =
// p_a (gv_a - delta_a) summed into comb on the valid keys (masked keys and
// keys past T give 0, as the TPU kernel masks ds); after
// the last arg dQ += comb K (comb's C fragments are the A fragments) and
// the frame sums rs += comb . onehot(key frames) on the tensor cores
// (frame_sums).  At the end the two key halves of a row group add their
// dQ and frame sums through shared memory in a fixed order, and the block
// writes one (F, F) frame-bias partial (rows in order) that the wrapper
// adds up in a fixed order: the gradients are the same on every run, with
// no atomics.  This design's times are in PERF.md.
//
// Head dims, frames and args.  The file builds twice, each its own
// library: the narrow instances, DK 128 (dh <= 128, zero padded), and with
// -DVOG_MM_CLUSTER=1 the cluster instances for every dh past 128
// (mm_fwd_cl, mm_bwd_dkv_cl, mm_bwd_dq_cl: the head dim split over a thread
// block cluster, cluster.cuh), so that nvcc builds the two sets of
// templates in parallel: 173.0 s and 82.3 s at "highest" in the smoke's
// [build] lines on the H100's host, where one library would take
// their sum, longer than any other library's build.  Each block of
// a cluster stages by TMA and accumulates its 128 columns, each score
// partial summed once over the cluster.  The design they replaced (a DK 256
// instance and, past 256, the DK 128 instances' wide path) redid the
// scores (and the A softmaxes, or the A score gradients) in every block of
// a tile; the two designs' times on the H100 are in PERF.md (section 6).
// The (F, F) bias table sits in shared memory up to 64 frames and is read
// from device memory past that, an instance each (tiles.cuh §TableMode: up
// to 64 frames the code and registers are those of a kernel without the
// other case; the cluster instances read it from device memory at any F);
// past 64 frames mm_bwd_dq gives a tile of rows ceil(F / 64) blocks (grid.z;
// mm_bwd_dq_cl: groups of clusters in grid.x), each summing 64 key frames
// in the fixed order.  A is a template parameter, 1..8 (mm_fwd_cl 1..7,
// 1..4 past dh 1024); the wrapper launches more args in groups of at most 8
// (mm_fwd_cl 7 or 4; kernels/mm_attention.py §arg_groups, §fwd_groups,
// §bwd_groups, the cluster's from kernels/_cluster.py §cluster_plan).
//
// Precision: this file builds twice (kernels/_build.py), as attention.cu:
// 3xTF32 ("highest") as it is, one TF32 pass ("default") with
// -DVOG_ONE_PASS=1, where emit mode also stores comb in bf16, as the JAX
// package does at "default" on the chip.  The pass count is a template
// parameter of the helpers (tiles.cuh, tf32.cuh), not of these kernels,
// so the template instances (A = 1..8 of three kernels, each at both
// table modes, tiles.cuh §TableMode; of the cluster kernels, with and
// without their other slices, kX) do not double in any of the four
// builds.  The one-pass narrow library holds no emit instance of
// mm_bwd_dkv and no instance of mm_fwd: its emit backward is
// mm_bwd_dkv_wg and its forward mm_fwd_wg, a fifth library (-DVOG_MM_WG=1)
// built beside the others.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tiles.cuh"  // cp.async row tiles, their 3xTF32 fragments, HeadDim
#include "cluster.cuh"  // the head dim split over a cluster: slices, barriers, TMA, partials
#include "hopper.cuh"  // wgmma, mbarriers, the proxy fence (mm_bwd_dkv_wg, mm_fwd_wg)
#include "device.cuh"  // DeviceGuard: every entry point runs on its tensors' device

// This library's kernels: the narrow instances (dh <= 128, zero padded to
// 128), or with -DVOG_MM_CLUSTER=1 the cluster instances (dh > 128), one
// library each (kernels/_build.py), so that nvcc builds the two sets of A
// = 1..8 instances in parallel; with -DVOG_MM_WG=1 (one pass only)
// mm_bwd_dkv_wg and mm_fwd_wg, the "default" emit backward and forward at
// dh <= 128, whose entry points vog_mm_bwd_wg and vog_mm_fwd_wg are that
// library's only ones.
#ifndef VOG_MM_CLUSTER
#define VOG_MM_CLUSTER 0
#endif
#ifndef VOG_MM_WG
#define VOG_MM_WG 0
#endif
static_assert(!VOG_MM_WG || (VOG_ONE_PASS && !VOG_MM_CLUSTER), "mm_bwd_dkv_wg, mm_fwd_wg: the one-pass library's part");

namespace {

constexpr int kDK = 128;
using HD = HeadDim<kDK>;
constexpr int kLd = HD::kLd;
constexpr int kND = HD::kND;
constexpr int kNV = HD::kNV;
// Shared memory of a block, at A = 8 and a shared (64, 64) table: 107-193 KB
// (two blocks an SM for mm_fwd and mm_bwd_dkv)
constexpr int kMinBlocks = 2;

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kFwdRows = 16;                    // query rows a block owns
constexpr int kFwdTile = 32;                    // keys a streamed tile (8 a warp in S)
constexpr int kFwdKT = kFwdTile / 8;            // k-steps of P.V over a tile
// Output columns a warp owns in P.V: 32 of the block's 128 (mm_fwd_cl:
// of its cluster slice's 128)
constexpr int kFwdCols = HD::kDV / kFwdWarps;
constexpr int kFwdNT = kFwdCols / 8;            // their 8-wide column tiles
constexpr int kSoftRows = kFwdRows / kFwdWarps;  // rows a warp owns in the softmax
constexpr int kSets = 4;                        // accumulator sets of the S chain
constexpr int kSLd = kFwdTile + 8;              // S tile row stride (conflict-free float2)
// split P tile: per row, per key pair (2k, 2k+1), (big, big, small, small);
// a row stride of 16 (mod 32) words keeps the 16-byte fragment reads
// conflict-free
constexpr int kPLd = 2 * kFwdTile + 16;

// 3xTF32 only: a one-pass forward at dh <= 128 is mm_fwd_wg's (launch
// below names no instance in a one-pass library)
template <int A, int TM>
__global__ void __launch_bounds__(kFwdThreads, kMinBlocks)
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
  float* fbs = reinterpret_cast<float*>(codes + 2 * kFwdTile);  // F x F (F <= kTableF)
  const float* fbg = fb + (size_t)h * F * F;

  const size_t base = (size_t)bh * T * dh;
  const float* kb = km + base;
  const float* vb = vm + base;
  const float* cb = cn + (size_t)bh * A * T;
  auto stage = [&](int s, int j0) {
    load_rows<kFwdTile, kFwdThreads, kDK>(Ks + s * kFwdTile * kLd, kb, j0, T, dh, vec);
    load_rows<kFwdTile, kFwdThreads, kDK>(Vs + s * kFwdTile * kLd, vb, j0, T, dh, vec);
    for (int i = tid; i < A * kFwdTile; i += kFwdThreads) {  // cn, zero past T
      const int a = i / kFwdTile, j = j0 + i % kFwdTile;
      cp_async4(Cs + s * A * kFwdTile + i, j < T ? cb + (size_t)a * T + j : cb, j < T);
    }
    if (tid < kFwdTile) codes[s * kFwdTile + tid] = key_code<true>(key_mask, fid, b, j0 + tid, T);
    cp_commit();
  };
  stage_table<TM, kFwdThreads>(fbs, fbg, F);
  load_rows<kFwdRows, kFwdThreads, kDK>(Qs, qm + base, q0, T, dh, vec);
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
        frag_a<kLd>(Qs, 8 * ks, g, t, ab, as);
        frag_bt<kLd>(Kw, 0, 8 * ks, g, t, bb, bs);
        mma_p<false>(cs[ks % kSets], ab, as, bb, bs);
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
          x[e] = s0 + table_bias<TM>(fbs, fbg, F, fq0, c);
          x[2 + e] = s1 + table_bias<TM>(fbs, fbg, F, fq1, c);
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
          split<false>(x[i], pb[i], ps[i]);
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
      for (int n = 0; n < kFwdNT; ++n)
        frag_b_pairs<kLd>(Vt + c0, 8 * j, 8 * n, g, t, bb[n], bs[n]);
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
        for (int n = 0; n < kFwdNT; ++n) mma_p<false>(acc[a][n], ab, as, bb[n], bs[n]);
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
  if constexpr (kOnePass) {  // the one-pass forward is mm_fwd_wg's (its own library)
    return (int)cudaErrorInvalidValue;
  } else {
    const size_t smem = sizeof(float) * ((size_t)(kFwdRows + 4 * kFwdTile) * kLd +
                                         A * kFwdRows * kPLd + kFwdRows * kSLd +
                                         2 * A * kFwdTile + 2 * A * kFwdRows + table_floats(F)) +
                        sizeof(int) * 2 * kFwdTile;
    auto fwd = F <= kTableF ? mm_fwd<A, kSmemTable> : mm_fwd<A, kGlobalTable>;
    cudaError_t e = cudaFuncSetAttribute(fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const bool vec = dh % 4 == 0 && aligned16(qm) && aligned16(km) && aligned16(vm);
    dim3 grid((T + kFwdRows - 1) / kFwdRows, B * H);
    fwd<<<grid, kFwdThreads, smem, stream>>>(
        qm, km, vm, cn, key_mask, fb, fid, o, mrow, den, H, T, dh, F, vec);
    return (int)cudaGetLastError();
  }
}

// ---------------------------------------------------------------------------
// forward past head dim 128: the head dim split over a cluster (cluster.cuh)
// ---------------------------------------------------------------------------
// mm_fwd's block (4 warps, 16 query rows, 32-key tiles, the three parts of
// a tile) for column slice zs = z + n pass of a cluster of n blocks: the
// block's Q rows and K/V tiles are its 128 columns, by TMA (K/V in a
// two-stage ring), and warp w's partial S over them (keys 8w..8w+7, four
// accumulator sets) is summed over the cluster in rank order before the
// bias and masks.  Every block then does the tile's A softmaxes on the same
// S, its own copy of the P_a tiles: a block's work a tile is the DK 128
// instance's (S over 128 columns, the A softmaxes, P.V over 128 columns),
// where sharing one rank's P_a would cost a second cluster barrier a tile
// and A x 16 x 80 floats of remote stores.  Slice 0's block (pass 0, rank
// 0) writes the row max and denominator.  The frame table is read from
// device memory at any F (one instance an arg count).
constexpr int kClSp = kFwdWarps * 32 * 4;  // floats of a block's partial S (fragment order)
// args a launch: 7, where A = 8's accumulators spilled (ptxas: 32-152 bytes
// in 3xTF32), and 4 past dh 1024 (the kX instances, for the build's time)
constexpr int kClArgs = 7;
constexpr int kClXArgs = 4;

// shared floats of mm_fwd_cl at A args (the mbarriers follow)
__host__ __device__ constexpr size_t fwd_cl_floats(int A) {
  return (size_t)(kFwdRows + 4 * kFwdTile) * kSliceLd + A * kFwdRows * kPLd + kFwdRows * kSLd + kClSp +
         2 * A * kFwdTile + 2 * A * kFwdRows + 2 * kFwdTile;
}

template <int A, bool kX>
__global__ void __launch_bounds__(kFwdThreads, 1)
mm_fwd_cl(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, const float* __restrict__ qm, const float* __restrict__ km,
          const float* __restrict__ cn, const float* __restrict__ key_mask, const float* __restrict__ fb,
          const int* __restrict__ fid, float* __restrict__ o, float* __restrict__ mrow,
          float* __restrict__ den, int H, int T, int dh, int F, int pass) {
  constexpr int kCLd = kSliceLd;
  const int z = (int)cg::this_cluster().block_rank();
  const int zs = slice_of<kX>(z, pass);  // the slice this block stages and accumulates
  const bool own = owns<kX>(zs, dh);     // (else it stages slice 0 and adds only its other slices' partials)
  const int cz = kSlice * (own ? zs : 0);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kFwdRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(128) float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);                  // kFwdRows x kCLd
  float* Ks = Qs + kFwdRows * kCLd;                              // 2 stages x kFwdTile x kCLd
  float* Vs = Ks + 2 * kFwdTile * kCLd;                          // 2 stages x kFwdTile x kCLd
  float* Ps = Vs + 2 * kFwdTile * kCLd;                          // A x kFwdRows x kPLd: split P
  float* Ss = Ps + A * kFwdRows * kPLd;                          // kFwdRows x kSLd: S of a tile
  float* Sp = Ss + kFwdRows * kSLd;                              // kClSp: this block's partial S
  float* Cs = Sp + kClSp;                                        // 2 stages x A x kFwdTile: cn
  float* Al = Cs + 2 * A * kFwdTile;                             // A x kFwdRows: rescale factors
  float* Ls = Al + A * kFwdRows;                                 // A x kFwdRows: final sums
  int* codes = reinterpret_cast<int*>(Ls + A * kFwdRows);       // 2 stages x kFwdTile
  uint64_t* bars = reinterpret_cast<uint64_t*>(codes + 2 * kFwdTile);  // Q, then the K/V stages
  const float* fbg = fb + (size_t)h * F * F;

  const size_t base = (size_t)bh * T * dh;
  const float* cb = cn + (size_t)bh * A * T;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i);
    mbar_fence_init();
  }
  __syncthreads();
  auto stage = [&](int s, int j0) {
    if (tid == 0) {
      mbar_expect(bars + 1 + s, 2 * box_bytes(kFwdTile));
      tma_load(Ks + s * kFwdTile * kCLd, &kmap, cz, j0, bh, bars + 1 + s);
      tma_load(Vs + s * kFwdTile * kCLd, &vmap, cz, j0, bh, bars + 1 + s);
    }
    for (int i = tid; i < A * kFwdTile; i += kFwdThreads) {  // cn, zero past T
      const int a = i / kFwdTile, j = j0 + i % kFwdTile;
      cp_async4(Cs + s * A * kFwdTile + i, j < T ? cb + (size_t)a * T + j : cb, j < T);
    }
    if (tid < kFwdTile) codes[s * kFwdTile + tid] = key_code<true>(key_mask, fid, b, j0 + tid, T);
    cp_commit();
  };
  if (tid == 0) {
    mbar_expect(bars, box_bytes(kFwdRows));
    tma_load(Qs, &qmap, cz, q0, bh, bars);
  }
  stage(0, 0);

  const int fq0 = q0 + g < T ? fid[q0 + g] : 0, fq1 = q0 + g + 8 < T ? fid[q0 + g + 8] : 0;
  const int sr = kSoftRows * warp + (lane >> 3), sk = 4 * (lane & 7);
  float m[A], l[A];
  const int c0 = cz + kFwdCols * warp;  // the warp's output columns in P.V
  float acc[A][kFwdNT][4];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    m[a] = kNeg;
    l[a] = 0.f;
    zero(acc[a]);
  }
  mbar_wait(bars, 0);  // the Q rows

  const int ntiles = (T + kFwdTile - 1) / kFwdTile;
  for (int it = 0; it < ntiles; ++it) {
    const int s = it & 1;
    cp_wait_all();
    __syncthreads();  // tile it's cn and codes are in; every warp is done with tile it - 1
    if (it + 1 < ntiles) stage(s ^ 1, (it + 1) * kFwdTile);
    mbar_wait(bars + 1 + s, (it >> 1) & 1);  // tile it's K and V
    const float* Kt = Ks + s * kFwdTile * kCLd;
    const float* Vt = Vs + s * kFwdTile * kCLd;
    const float* Ct = Cs + s * A * kFwdTile;
    const int* ct = codes + s * kFwdTile;

    {  // S = Q K^T for keys 8w..8w+7: this block's partial, summed over the cluster
      float cs[kSets][4];
#pragma unroll
      for (int q = 0; q < kSets; ++q) cs[q][0] = cs[q][1] = cs[q][2] = cs[q][3] = 0.f;
      if (own) {
        const float* Kw = Kt + 8 * warp * kCLd;
#pragma unroll
        for (int ks = 0; ks < kSlice / 8; ++ks) {
          uint32_t ab[4], as[4], bb[2], bs[2];
          frag_a<kCLd>(Qs, 8 * ks, g, t, ab, as);
          frag_bt<kCLd>(Kw, 0, 8 * ks, g, t, bb, bs);
          mma_p<kOnePass>(cs[ks % kSets], ab, as, bb, bs);
        }
      }
      float part[1][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = 0.f;
#pragma unroll
        for (int q = 0; q < kSets; ++q) x += cs[q][i];
        part[0][i] = x;
      }
      if constexpr (kX)
        add_other_slices<1>(part, qm + base, km + base, q0, it * kFwdTile + 8 * warp, T, dh, z, pass, g, t);
      if (it > 0) cluster_wait();  // every peer has read this block's partial of tile it - 1
      put_partial<1>(Sp, part, warp, lane);
      cluster_arrive();
      cluster_wait();  // every block's partial is in
      sum_partials<1>(part, Sp, warp, lane);
      cluster_arrive();  // this block is done with its peers' partials
      const int j = 8 * warp + 2 * t;
      float x[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = ct[j + e];
        if (c >= 0) {
          x[e] = part[0][e] + table_bias<kGlobalTable>(nullptr, fbg, F, fq0, c);
          x[2 + e] = part[0][2 + e] + table_bias<kGlobalTable>(nullptr, fbg, F, fq1, c);
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
          split<kOnePass>(x[i], pb[i], ps[i]);
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
      uint32_t bb[kFwdNT][2], bs[kFwdNT][2];
#pragma unroll
      for (int n = 0; n < kFwdNT; ++n)
        frag_b_pairs<kCLd>(Vt + kFwdCols * warp, 8 * j, 8 * n, g, t, bb[n], bs[n]);
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const float* P0 = Ps + (a * kFwdRows + g) * kPLd + 4 * (4 * j + t);
        const float4 u = *reinterpret_cast<const float4*>(P0);
        const float4 w = *reinterpret_cast<const float4*>(P0 + 8 * kPLd);
        const uint32_t ab[4] = {__float_as_uint(u.x), __float_as_uint(w.x), __float_as_uint(u.y),
                                __float_as_uint(w.y)};
        const uint32_t as[4] = {__float_as_uint(u.z), __float_as_uint(w.z), __float_as_uint(u.w),
                                __float_as_uint(w.w)};
#pragma unroll
        for (int n = 0; n < kFwdNT; ++n) mma_p<kOnePass>(acc[a][n], ab, as, bb[n], bs[n]);
      }
    }
  }
  cluster_wait();  // no peer reads this block's partial any more

#pragma unroll
  for (int a = 0; a < A; ++a) {
    float lt = l[a];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt += __shfl_xor_sync(0xffffffffu, lt, 4);  // >= 1 by construction
    if ((lane & 7) == 0) {
      Ls[a * kFwdRows + sr] = lt;
      const size_t row = ((size_t)bh * A + a) * T + q0 + sr;
      if (q0 + sr < T && zs == 0) {
        mrow[row] = m[a];
        den[row] = lt;
      }
    }
  }
  __syncthreads();
  if (!own) return;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const size_t row = ((size_t)bh * A + a) * T;
    store_rows(o + row * dh, acc[a], q0 + g, c0, T, dh, t, 1.f / Ls[a * kFwdRows + g],
               1.f / Ls[a * kFwdRows + g + 8]);
  }
}

// mm_fwd_cl's launches as clusters of n blocks (the wrapper's plan), one a
// pass (dh % 4 == 0: the wrapper pads), at most kClArgs args (kClXArgs
// past dh 1024)
template <int A>
int launch_cl(const float* qm, const float* km, const float* vm, const float* cn,
              const float* key_mask, const float* fb, const int* fid, float* o,
              float* mrow, float* den, int B, int H, int T, int dh, int F, int n, cudaStream_t stream) {
  if constexpr (A > kClArgs) {
    return (int)cudaErrorInvalidValue;
  } else {
  CUtensorMap qmap, kmap, vmap;
  cudaError_t e = row_map(&qmap, qm, B * H, T, dh, kFwdRows);
  if (e == cudaSuccess) e = row_map(&kmap, km, B * H, T, dh, kFwdTile);
  if (e == cudaSuccess) e = row_map(&vmap, vm, B * H, T, dh, kFwdTile);
  if (e != cudaSuccess) return (int)e;
  const int passes = passes_of(dh, n);
  const size_t smem = sizeof(float) * fwd_cl_floats(A) + 3 * sizeof(uint64_t);
  const dim3 grid((T + kFwdRows - 1) / kFwdRows, B * H, n);
  auto fwd = mm_fwd_cl<A, false>;
  if (passes > 1) {
    if constexpr (A > kClXArgs) return (int)cudaErrorInvalidValue;
    else fwd = mm_fwd_cl<A, true>;
  }
  for (int p = 0; p < passes; ++p) {
    e = launch_cluster(fwd, grid, kFwdThreads, smem, n, stream, qmap, kmap, vmap, qm, km, cn, key_mask, fb,
                       fid, o, mrow, den, H, T, dh, F, p);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
  }
}

// ---------------------------------------------------------------------------
// backward (emit mode)
// ---------------------------------------------------------------------------
constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kBwdKeys = 16 * kBwdWarps;  // keys a block owns (a warp 16)
constexpr int kBwdTile = 16;              // query rows of a streamed tile
constexpr int kBwdNT = kBwdTile / 8;      // its 8-wide column tiles

// delta[r] = sum_d g[r, d] o[r, d] over the (B*H*A*T, dh) rows, a warp a row
__global__ void __launch_bounds__(256)
mm_bwd_delta(const float* __restrict__ o, const float* __restrict__ gout,
             float* __restrict__ delta, int rows, int dh) {
  row_dots(o, gout, delta, rows, dh);
}

// kEmit: also store comb (B*H, T, T), query-major ("emit" mode).  dh <= 128
// (past 128: mm_bwd_dkv_cl).
template <int A, int TM, bool kEmit>
__global__ void __launch_bounds__(kBwdThreads, kMinBlocks)
mm_bwd_dkv(const float* __restrict__ qm, const float* __restrict__ km,
           const float* __restrict__ vm, const float* __restrict__ cn,
           const float* __restrict__ key_mask, const float* __restrict__ fb,
           const int* __restrict__ fid, const float* __restrict__ gout,
           const float* __restrict__ mrow, const float* __restrict__ den,
           const float* __restrict__ delta, float* __restrict__ dk,
           float* __restrict__ dv, float* __restrict__ dcn,
           DsT* __restrict__ comb, int H, int T, int dh, int F, bool vec) {
  constexpr int NT = kBwdNT;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kBwdKeys;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);              // kBwdKeys x kLd
  float* Vs = Ks + kBwdKeys * kLd;                           // kBwdKeys x kLd
  float* Qs = Vs + kBwdKeys * kLd;                           // 2 tiles x kBwdTile x kLd
  float* Gs = Qs + 2 * kBwdTile * kLd;                       // 2 steps x kBwdTile x kLd: g_a
  float* Ss = Gs + 2 * kBwdTile * kLd;                       // 2 tiles x 3 x A x kBwdTile: m, den, delta
  float* Cs = Ss + 2 * 3 * A * kBwdTile;                     // A x kBwdKeys: cn of the keys
  float* fbs = Cs + A * kBwdKeys;                            // F x F (F <= kTableF)
  int* fqs = reinterpret_cast<int*>(fbs + table_floats(F));  // 2 tiles x kBwdTile: query frames
  const float* fbg = fb + (size_t)h * F * F;

  const size_t base = (size_t)bh * T * dh;
  const float* qb = qm + base;
  const size_t arow = (size_t)bh * A * T;  // row (bh, a = 0, i = 0) of the (B,H,A,T) tensors
  const int ntiles = (T + kBwdTile - 1) / kBwdTile, nsteps = ntiles * A;
  // step j = (query tile j / A, arg j % A): its g_a tile, and with arg 0
  // the tile's Q rows, statistics and frames; one commit group a step
  auto stage = [&](int j) {
    const int it = j / A, a = j - it * A, i0 = it * kBwdTile;
    load_rows<kBwdTile, kBwdThreads, kDK>(Gs + (j & 1) * kBwdTile * kLd, gout + (arow + (size_t)a * T) * dh,
                                          i0, T, dh, vec);
    if (a == 0) {
      load_rows<kBwdTile, kBwdThreads, kDK>(Qs + (it & 1) * kBwdTile * kLd, qb, i0, T, dh, vec);
      float* st = Ss + (it & 1) * 3 * A * kBwdTile;
      for (int i = tid; i < 3 * A * kBwdTile; i += kBwdThreads) {  // zero past T
        const int w = i / (A * kBwdTile), r = i % (A * kBwdTile), qi = i0 + r % kBwdTile;
        const float* src = (w == 0 ? mrow : w == 1 ? den : delta) + arow + (size_t)(r / kBwdTile) * T + qi;
        cp_async4(st + i, qi < T ? src : mrow, qi < T);
      }
      if (tid < kBwdTile) {
        const int qi = i0 + tid;
        cp_async4(reinterpret_cast<float*>(fqs + (it & 1) * kBwdTile + tid),
                  reinterpret_cast<const float*>(qi < T ? fid + qi : fid), qi < T);
      }
    }
    cp_commit();
  };
  stage_table<TM, kBwdThreads>(fbs, fbg, F);
  for (int i = tid; i < A * kBwdKeys; i += kBwdThreads) {
    const int a = i / kBwdKeys, kj = k0 + i % kBwdKeys;
    Cs[i] = kj < T ? cn[arow + (size_t)a * T + kj] : 0.f;
  }
  load_rows<kBwdKeys, kBwdThreads, kDK>(Ks, km + base, k0, T, dh, vec);
  load_rows<kBwdKeys, kBwdThreads, kDK>(Vs, vm + base, k0, T, dh, vec);
  stage(0);  // one group: K, V and step 0

  // this lane's keys: kr0 = k0 + 16 warp + g and kr0 + 8 (rows g, g + 8 of
  // the warp's C fragments), query columns 8j + 2t + e of a tile
  const int kl0 = warp * 16 + g, kr0 = k0 + kl0;
  const int kc[2] = {key_code<true>(key_mask, fid, b, kr0, T), key_code<true>(key_mask, fid, b, kr0 + 8, T)};
  const bool active = k0 + warp * 16 < T;  // a warp whose keys are all past T only loads
  const float* Kw = Ks + warp * 16 * kLd;
  const float* Vw = Vs + warp * 16 * kLd;
  float adk[kNV][4], adv[kNV][4];
  zero(adk);
  zero(adv);
  float dc[A][2];  // this lane's part of dcn_a at its two keys
#pragma unroll
  for (int a = 0; a < A; ++a) dc[a][0] = dc[a][1] = 0.f;
  float st[NT][4], cb[NT][4];  // S^T (biased, masked) of the tile; comb^T = sum_a ds_a^T

  int j = 0;  // the step in flight
  auto advance = [&]() {
    cp_wait_all();
    __syncthreads();  // step j is in; every warp is done with step j - 1
    if (j + 1 < nsteps) stage(j + 1);
  };
  for (int it = 0; it < ntiles; ++it) {
    const int i0 = it * kBwdTile;
    const float* Qt = Qs + (it & 1) * kBwdTile * kLd;
    const float* Ss_t = Ss + (it & 1) * 3 * A * kBwdTile;
    advance();  // step (it, 0): the tile's Q, statistics and frames, and g_0
    if (active) {  // S^T = K Q^T + fb, once a query tile for all args; masked keys at kNeg
      scores<NT, false, kDK>(st, st, Kw, Qt, Kw, Qt, g, t);
      const int* ft = fqs + (it & 1) * kBwdTile;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int fq = ft[8 * n + 2 * t + e];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int c = kc[r];
            st[n][2 * r + e] = c >= 0 ? st[n][2 * r + e] + table_bias<TM>(fbs, fbg, F, fq, c) : kNeg;
          }
        }
      zero(cb);
    }
#pragma unroll 1
    for (int a = 0; a < A; ++a, ++j) {
      if (a > 0) advance();
      if (!active) continue;
      const float* Gt = Gs + (j & 1) * kBwdTile * kLd;
      const float* mt = Ss_t + a * kBwdTile;
      const float* dnt = mt + A * kBwdTile;
      const float* dlt = dnt + A * kBwdTile;
      float dpt[NT][4];  // dP_a^T = V G_a^T
      scores<NT, false, kDK>(dpt, dpt, Vw, Gt, Vw, Gt, g, t);

      // P_a^T = exp(S^T + cn_a - m_a) / den_a; ds_a = P_a^T (dP_a^T - delta_a)
      const float cn0 = Cs[a * kBwdKeys + kl0], cn1 = Cs[a * kBwdKeys + kl0 + 8];
      float pt[NT][4], ds0 = 0.f, ds1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * n + 2 * t + e;
          const bool qok = i0 + col < T;
          const float m = mt[col], inv = qok ? 1.f / dnt[col] : 0.f, dl = dlt[col];  // den >= 1
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 2 * r + e;
            const float p = !qok || kc[r] == kPast ? 0.f : expf(st[n][i] + (r ? cn1 : cn0) - m) * inv;
            const float ds = p * (dpt[n][i] - dl);
            pt[n][i] = p;
            cb[n][i] += ds;
            if (r) ds1 += ds;
            else ds0 += ds;
          }
        }
#pragma unroll
      for (int aa = 0; aa < A; ++aa)  // a static index keeps dc in registers
        if (aa == a) {
          dc[aa][0] += ds0;
          dc[aa][1] += ds1;
        }
      accumulate<NT, kNV, kLd>(adv, pt, Gt, g, t);  // dV += P_a^T G_a
    }
    if (!active) continue;

    // comb^T masked to the valid keys; dK += comb^T Q
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (kc[i >> 1] < 0) cb[n][i] = 0.f;
    accumulate<NT, kNV, kLd>(adk, cb, Qt, g, t);
    if (!kEmit) continue;
    // comb[bh, q, k]: a store writes 8 consecutive keys for each of 4 queries
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = i0 + 8 * n + 2 * t + e;
        if (qi >= T) continue;
        DsT* row = comb + ((size_t)bh * T + qi) * T;
        if (kr0 < T) store_ds(row + kr0, cb[n][e]);
        if (kr0 + 8 < T) store_ds(row + kr0 + 8, cb[n][2 + e]);
      }
  }

  // dcn: the four lanes of a key add their query columns, in a fixed order
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float d = quad_sum(dc[a][r]);
      const int kj = kr0 + 8 * r;
      if (t == 0 && active && kj < T) dcn[arow + (size_t)a * T + kj] = d;
    }
  if (!active) return;
  store_rows(dk + base, adk, kr0, 0, T, dh, t, 1.f, 1.f);
  store_rows(dv + base, adv, kr0, 0, T, dh, t, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// backward, recompute mode: dq and the frame-bias partials
// ---------------------------------------------------------------------------
// A block: kDqGroups row groups of 16 rows, each with two warps over the
// two halves of a key tile.
constexpr int kDqGroups = 4;
constexpr int kDqWarps = 2 * kDqGroups;
constexpr int kDqThreads = kDqWarps * 32;
constexpr int kDqRows = 16 * kDqGroups;   // query rows a block owns
constexpr int kDqTile = 64;               // keys of a tile: two halves, a warp's n-tiles
// scores' k-steps a rolled iteration (tiles.cuh): the kernel spilled more
// in chunks of 16 than unrolled whole
constexpr int kDqChunk = 16;
constexpr int kFrameTiles = kFrameTile / 8;  // 8-frame column tiles of a block's frame sums

// rs (a warp's 16 rows x the key frames fbase.., C fragments) += comb .
// onehot: comb's C fragments (NT tiles of 8 keys) are the A fragments (keys
// in pair order), the one-hot B fragment is exact in TF32 (1 where key 2t
// or 2t + 1 lies in frame fbase + 8f + g; masked keys and keys past T have
// codes < 0), so two mma a tile (small, then big) give the fp32 sum; one
// (comb rounded to TF32) in a one-pass library.  Each product is formed
// from zero and added in fp32 (a chain over T keys, as tiles.cuh §accumulate).
// NF: rs's 8-frame column tiles (mm_bwd_dq_cl: a warp's half of the 64).
template <int NT, int NF = kFrameTiles>
__device__ inline void frame_sums(float (&rs)[NF][4], const float (&comb)[NT][4],
                                  const int (&c)[NT][2], int F, int fbase, int g) {
  const uint32_t one = __float_as_uint(1.f);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t ab[4], as[4];
    a_from_c(comb[n], ab, as);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int f0 = fbase + 8 * f;
      if (f0 >= F) break;
      const uint32_t b[2] = {c[n][0] == f0 + g ? one : 0u, c[n][1] == f0 + g ? one : 0u};
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (!kOnePass) mma(part, as, b);
      mma(part, ab, b);
#pragma unroll
      for (int i = 0; i < 4; ++i) rs[f][i] += part[i];
    }
  }
}

// Block z of a tile of rows sums comb over key frames 64z..64z+63 (z <
// ceil(F / 64)), block 0 also computing dq, as csrc/attention.cu's
// flash_bwd_dq: grid.z = ceil(F / 64).  dh <= 128 (past 128: mm_bwd_dq_cl).
template <int A, int TM>
__global__ void __launch_bounds__(kDqThreads, 1)
mm_bwd_dq(const float* __restrict__ qm, const float* __restrict__ km,
          const float* __restrict__ vm, const float* __restrict__ cn,
          const float* __restrict__ key_mask, const float* __restrict__ fb,
          const int* __restrict__ fid, const float* __restrict__ gout,
          const float* __restrict__ mrow, const float* __restrict__ den,
          const float* __restrict__ delta, float* __restrict__ dq,
          float* __restrict__ dfb_part, int H, int T, int dh, int F, bool vec) {
  constexpr int NT = kDqTile / 16;  // a warp's 8-key n-tiles
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  // one block a tile of rows: the frames in one tile
  constexpr bool kOne = TM == kSmemTable;
  const int q0 = blockIdx.x * kDqRows, z = kOne ? 0 : blockIdx.z;
  const bool do_dq = kOne || z == 0;
  const int fbase = kFrameTile * z;    // key frames 64z..64z+63
  const bool do_fr = kOne || fbase < F;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % kDqGroups, kh = warp / kDqGroups;  // row group (16 rows), key half of a tile

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);      // kDqRows x kLd
  float* Gs = Qs + kDqRows * kLd;                    // 2 steps x kDqRows x kLd: g_a of the rows
  float* Ks = Gs + 2 * kDqRows * kLd;                // kDqTile x kLd
  float* Vs = Ks + kDqTile * kLd;                    // kDqTile x kLd
  float* Cs = Vs + kDqTile * kLd;                    // A x kDqTile: cn of the keys
  float* St = Cs + A * kDqTile;                      // 3 x A x kDqRows: m, 1 / den, delta
  float* fbs = St + 3 * A * kDqRows;                 // F x F (F <= kTableF)
  int* codes = reinterpret_cast<int*>(fbs + table_floats(F));  // kDqTile
  const float* fbg = fb + (size_t)h * F * F;

  const size_t base = (size_t)bh * T * dh;
  const size_t arow = (size_t)bh * A * T;  // row (bh, a = 0, i = 0) of the (B,H,A,T) tensors
  const float* kb = km + base;
  const float* vb = vm + base;
  const float* cb = cn + arow;
  const int ntiles = (T + kDqTile - 1) / kDqTile, nsteps = ntiles * A;
  // step j = (key tile j / A, arg j % A): its g_a rows, a step ahead
  auto stage = [&](int j) {
    const int a = j % A;
    load_rows<kDqRows, kDqThreads, kDK>(Gs + (j & 1) * kDqRows * kLd, gout + (arow + (size_t)a * T) * dh,
                                        q0, T, dh, vec);
    cp_commit();
  };
  // key tile it: its K and V rows, cn and key codes, once every warp is done with the tile before
  auto load_tile = [&](int it) {
    const int j0 = it * kDqTile;
    load_rows<kDqTile, kDqThreads, kDK>(Ks, kb, j0, T, dh, vec);
    load_rows<kDqTile, kDqThreads, kDK>(Vs, vb, j0, T, dh, vec);
    for (int i = tid; i < A * kDqTile; i += kDqThreads) {  // cn, zero past T
      const int aa = i / kDqTile, jj = j0 + i % kDqTile;
      cp_async4(Cs + i, jj < T ? cb + (size_t)aa * T + jj : cb, jj < T);
    }
    if (tid < kDqTile) codes[tid] = key_code<true>(key_mask, fid, b, j0 + tid, T);
    cp_commit();
  };
  stage_table<TM, kDqThreads>(fbs, fbg, F);
  for (int i = tid; i < 3 * A * kDqRows; i += kDqThreads) {  // rows past T: m 0, 1/den 1, delta 0
    const int w = i / (A * kDqRows), r = i % (A * kDqRows), qi = q0 + r % kDqRows;
    const size_t at = arow + (size_t)(r / kDqRows) * T + qi;
    St[i] = qi >= T ? (w == 1 ? 1.f : 0.f) : w == 0 ? mrow[at] : w == 1 ? 1.f / den[at] : delta[at];
  }
  load_rows<kDqRows, kDqThreads, kDK>(Qs, qm + base, q0, T, dh, vec);
  stage(0);
  load_tile(0);

  const int r0 = 16 * rg + g;  // this lane's rows of the block: r0 and r0 + 8
  const int fq0 = q0 + r0 < T ? fid[q0 + r0] : 0, fq1 = q0 + r0 + 8 < T ? fid[q0 + r0 + 8] : 0;
  const float* Qw = Qs + 16 * rg * kLd;
  float acc[kNV][4];  // dQ of the warp's 16 rows over its key half
  zero(acc);
  float rs[kFrameTiles][4];  // the rows' comb summed by key frame (C fragments, 16 x 64 frames)
  zero(rs);
  float sc[NT][4], comb[NT][4];  // S (biased) of the tile; comb = sum_a ds_a
  int c[NT][2];                  // codes of this lane's keys 8n + 2t + e of its half

  constexpr int kHalf = kDqTile / 2;
  const float* Kh = Ks + kHalf * kh * kLd;  // the warp's keys of a tile
  const float* Vh = Vs + kHalf * kh * kLd;
  const float* Ct = Cs + kHalf * kh;
  int j = 0;  // the step in flight
  for (int it = 0; it < ntiles; ++it) {
#pragma unroll 1
    for (int a = 0; a < A; ++a, ++j) {
      cp_wait_all();
      __syncthreads();  // step j (with arg 0, the tile) is in; every warp is done with step j - 1
      if (j + 1 < nsteps) stage(j + 1);
      if (a == 0) {  // S = Q K^T + fb, once a key tile for all args
        scores<NT, false, kDK, kOnePass, kDqChunk>(sc, sc, Qw, Kh, Qw, Kh, g, t);
        const int* ct = codes + kHalf * kh;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            c[n][e] = ct[8 * n + 2 * t + e];
            if (c[n][e] >= 0) {
              sc[n][e] += table_bias<TM>(fbs, fbg, F, fq0, c[n][e]);
              sc[n][2 + e] += table_bias<TM>(fbs, fbg, F, fq1, c[n][e]);
            }
          }
        zero(comb);
      }
      float gv[NT][4];  // gv_a = G_a V^T
      const float* Ga = Gs + ((j & 1) * kDqRows + 16 * rg) * kLd;
      scores<NT, false, kDK, kOnePass, kDqChunk>(gv, gv, Ga, Vh, Ga, Vh, g, t);
      const float* sm = St + a * kDqRows + r0;
      const float m0 = sm[0], m1 = sm[8];
      const float i0 = sm[A * kDqRows], i1 = sm[A * kDqRows + 8];
      const float d0 = sm[2 * A * kDqRows], d1 = sm[2 * A * kDqRows + 8];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c[n][e] >= 0) {  // ds_a on the valid keys; masked keys and keys past T give 0
            const float ca = Ct[a * kDqTile + 8 * n + 2 * t + e];
            comb[n][e] += expf(sc[n][e] + ca - m0) * i0 * (gv[n][e] - d0);
            comb[n][2 + e] += expf(sc[n][2 + e] + ca - m1) * i1 * (gv[n][2 + e] - d1);
          }
    }
    if (do_dq) accumulate<NT, kNV, kLd>(acc, comb, Kh, g, t);  // dQ += comb K
    if (do_fr) frame_sums<NT>(rs, comb, c, F, fbase, g);
    if (it + 1 < ntiles) {
      __syncthreads();  // every warp is done with the tile's K, V, cn and codes
      load_tile(it + 1);
    }
  }

  // the two key halves of a row group: half 1 hands its dQ and frame sums
  // to half 0 through shared memory (the g_a ring), which adds them in order
  __syncthreads();  // every warp is done with Gs
  float* red = Gs;                    // kDqRows x kLd
  float* racc = Gs + kDqRows * kLd;   // kDqRows x kFrameTile: frame sums of the rows
  auto put_rs = [&](bool add) {
#pragma unroll
    for (int f = 0; f < kFrameTiles; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 8 * f + 2 * t + (i & 1), r = r0 + (i >= 2 ? 8 : 0);
        if (fbase + col < F)
          racc[r * kFrameTile + col] = add ? racc[r * kFrameTile + col] + rs[f][i] : rs[f][i];
      }
  };
  if (kh == 1) {
    if (do_dq) {
#pragma unroll
      for (int n = 0; n < kNV; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          red[r0 * kLd + 8 * n + 2 * t + e] = acc[n][e];
          red[(r0 + 8) * kLd + 8 * n + 2 * t + e] = acc[n][2 + e];
        }
    }
    if (do_fr) put_rs(false);
  }
  __syncthreads();
  if (kh == 0) {
    if (do_dq) {
#pragma unroll
      for (int n = 0; n < kNV; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[n][e] += red[r0 * kLd + 8 * n + 2 * t + e];
          acc[n][2 + e] += red[(r0 + 8) * kLd + 8 * n + 2 * t + e];
        }
      store_rows(dq + base, acc, q0 + r0, 0, T, dh, t, 1.f, 1.f);
    }
    if (do_fr) put_rs(true);
  }
  if (!do_fr) return;
  __syncthreads();
  // this block's columns fbase.. of the (F, F) partial: rows in order, those of query frame f
  const int nf = min(kFrameTile, F - fbase);
  float* part = dfb_part + ((size_t)bh * gridDim.x + blockIdx.x) * F * F;
  for (int cell = tid; cell < F * nf; cell += kDqThreads) {
    const int f = cell / nf, gk = cell - f * nf;
    float sum = 0.f;
    for (int r = 0; r < kDqRows && q0 + r < T; ++r)
      if (fid[q0 + r] == f) sum += racc[r * kFrameTile + gk];
    part[f * F + fbase + gk] = sum;
  }
}

// delta, then mm_bwd_dkv; with comb (emit mode) it stores comb, else
// (recompute mode) mm_bwd_dq follows for dq and the frame-bias partials
template <int A>
int launch_bwd(const float* qm, const float* km, const float* vm, const float* cn,
               const float* key_mask, const float* fb, const int* fid,
               const float* gout, const float* out, const float* mrow, const float* den,
               float* delta, float* dk, float* dv, float* dcn, DsT* comb, float* dq,
               float* dfb_part, int B, int H, int T, int dh, int F, cudaStream_t stream) {
  const int rows = B * H * A * T;
  mm_bwd_delta<<<(rows + 7) / 8, 256, 0, stream>>>(out, gout, delta, rows, dh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = sizeof(float) * ((size_t)(2 * kBwdKeys + 4 * kBwdTile) * kLd +
                                       6 * A * kBwdTile + A * kBwdKeys + table_floats(F)) +
                      sizeof(int) * 2 * kBwdTile;
  const bool emit = comb != nullptr, smem_table = F <= kTableF;
  auto dkv = smem_table ? mm_bwd_dkv<A, kSmemTable, false> : mm_bwd_dkv<A, kGlobalTable, false>;
  if constexpr (kOnePass) {  // the one-pass emit backward is mm_bwd_dkv_wg's (its own library)
    if (emit) return (int)cudaErrorInvalidValue;
  } else if (emit) {
    dkv = smem_table ? mm_bwd_dkv<A, kSmemTable, true> : mm_bwd_dkv<A, kGlobalTable, true>;
  }
  e = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec = dh % 4 == 0 && aligned16(qm) && aligned16(km) && aligned16(vm) &&
                   aligned16(gout);
  dim3 grid((T + kBwdKeys - 1) / kBwdKeys, B * H);
  dkv<<<grid, kBwdThreads, smem, stream>>>(
      qm, km, vm, cn, key_mask, fb, fid, gout, mrow, den, delta, dk, dv, dcn,
      comb, H, T, dh, F, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || emit) return (int)e;
  const size_t smem_q = sizeof(float) * ((size_t)(3 * kDqRows + 2 * kDqTile) * kLd +
                                         A * kDqTile + 3 * A * kDqRows + table_floats(F)) +
                        sizeof(int) * kDqTile;
  auto dqk = smem_table ? mm_bwd_dq<A, kSmemTable> : mm_bwd_dq<A, kGlobalTable>;
  e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  const int frame_tiles = (F + kFrameTile - 1) / kFrameTile;
  const dim3 grid_q((T + kDqRows - 1) / kDqRows, B * H, frame_tiles);
  dqk<<<grid_q, kDqThreads, smem_q, stream>>>(
      qm, km, vm, cn, key_mask, fb, fid, gout, mrow, den, delta, dq, dfb_part, H, T, dh, F, vec);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// backward, emit mode at "default", dh <= 128: mm_bwd_dkv_wg on wgmma
// ---------------------------------------------------------------------------
// The production recipe's instance (one TF32 pass, comb in bf16), built as
// a library part of its own (-DVOG_MM_WG=1, with -DVOG_ONE_PASS=1): the
// kernel has no template parameter (A, F and dh <= 128 are run-time), so
// the part builds in seconds beside the other libraries.  The design note
// at the top of this file says how it works.
#if VOG_MM_WG
constexpr int kWgKeys = 64;                  // keys a consumer warpgroup owns: wgmma's M
constexpr int kWgBlockKeys = 2 * kWgKeys;    // keys a block owns: two consumer warpgroups
constexpr int kWgRows = 32;                  // query rows of a streamed tile: N of S^T and dP^T
constexpr int kWgCons = 256;                 // the consumer threads
constexpr int kWgThreads = kWgCons + 128;    // and a producer warpgroup
// setmaxnreg's split of the register file: 128 x 40 + 256 x 232 <= 65536
// (ptxas gives the 384-thread kernel 168 a thread)
constexpr int kWgProdRegs = 40, kWgConsRegs = 232;
constexpr int kWgArgs = 8;                   // args a launch takes at most (the wrapper's groups)
constexpr int kWgGroups = kDK / 4;           // 4-column groups of the padded head dim: core-matrix columns
// Shared tiles in K-major core matrices (hopper.cuh §kmajor_desc), element
// (row r, column c) at (c / 4) LD + 4 r + c % 4: 16 bytes of a row, 8 rows
// a 128-byte core matrix, LD floats between two 4-column groups.
constexpr int kWgKV = kWgGroups * kWgKeys * 4;  // K or V of a warpgroup's keys: LD 256
constexpr int kWgQLd = kWgRows * 4;             // a Q tile's LD: 128
constexpr int kWgQ = kWgGroups * kWgQLd;
// a g_a tile's LD: 16 floats of padding a group, so that the transposed
// A-fragment reads (two rows' float2 a lane) of dV^T hit 32 distinct banks
constexpr int kWgGLd = kWgRows * 4 + 16;
constexpr int kWgG = kWgGroups * kWgGLd;
// P_a^T, then comb^T, of a warpgroup as the B operand of dV^T and dK^T:
// rows the 64 keys, columns the 32 query rows (padded as the g_a tile: the
// float2 stores from the C fragments hit 32 distinct banks)
constexpr int kWgPLd = kWgKeys * 4 + 16;
constexpr int kWgP = (kWgRows / 4) * kWgPLd;
constexpr int kWgC = kWgRows * kWgKeys / 2;     // comb of a warpgroup in bf16, [query][key], in floats
constexpr int kWgStats = 3 * kWgRows;           // a g_a stage's m, 1 / den (0 past T) and delta
constexpr size_t kWgFloats = 2 * (size_t)kWgKV * 2 + 2 * kWgQ + 2 * kWgG + 2 * kWgStats + 2 * kWgRows +
                             2 * kWgP + 2 * kWgC + kWgArgs * kWgBlockKeys;
constexpr size_t kWgSmem = sizeof(float) * kWgFloats + 8 * sizeof(uint64_t);
static_assert(kWgSmem <= 232448, "a block's shared memory on the H100");

// (row r, column group c) of a core-matrix tile of row stride 4 and group stride ld
__device__ inline int cm_idx(int r, int c, int ld) { return c * ld + 4 * r; }

__device__ inline float4 round4(float4 v) {
  return make_float4(__uint_as_float(round_tf32(v.x)), __uint_as_float(round_tf32(v.y)),
                     __uint_as_float(round_tf32(v.z)), __uint_as_float(round_tf32(v.w)));
}

// dst = the A fragments of rows 64 h + 16 w + 2 g (+ 1: row g + 8) of X^T,
// X a (32, 128) core-matrix tile of group stride LD, k-step s (the
// tile's rows 8 s + t, + 4): a0, a1 from one float2 and a2, a3 from
// another.  X^T's rows are the product's M rows in the order
// kernels/mm_attention.py §wg_d_of_m mirrors: row 16 w + g is d = 16 w + 2 g,
// row 16 w + g + 8 is d + 1 (in each 64-row half h).
template <int LD>
__device__ inline void a_frags_t(uint32_t (&dst)[2][4][4], const float* X, int w, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float* p = X + cm_idx(8 * s + t, 16 * h + 4 * w + (g >> 1), LD) + 2 * (g & 1);
      const float2 lo = *reinterpret_cast<const float2*>(p);
      const float2 hi = *reinterpret_cast<const float2*>(p + 16);  // row + 4
      dst[h][s][0] = __float_as_uint(lo.x);
      dst[h][s][1] = __float_as_uint(lo.y);
      dst[h][s][2] = __float_as_uint(hi.x);
      dst[h][s][3] = __float_as_uint(hi.y);
    }
}

// acc[h] (64 x 64: head-dim rows 64 h .. in §wg_d_of_m's order, the warpgroup's keys) += X^T (A from
// registers, af) . B (the 32 x 64 staging tile Pw: P_a^T or comb^T)
__device__ inline void product_t(float (&acc)[2][32], const uint32_t (&af)[2][4][4], const float* Pw) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int s = 0; s < 4; ++s) wgmma_n64(acc[h], af[h][s], kmajor_desc(Pw + 2 * s * kWgPLd, kWgPLd * 4, 128));
}

// c (the warpgroup's 64 keys x 32 query rows) = X (its K or V, A) . Y^T (a
// Q or g_a tile of group stride YLD, B): 16 k-steps, one group (the caller
// commits and waits)
template <int YLD>
__device__ inline void scores_t(float (&c)[16], const float* X, const float* Y) {
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i] = 0.f;
  wg_fence();  // after the accumulator's zeros
#pragma unroll
  for (int s = 0; s < kWgGroups / 2; ++s)
    wgmma_n32_ss(c, kmajor_desc(X + 2 * s * kWgKeys * 4, kWgKeys * 16, 128),
                 kmajor_desc(Y + 2 * s * YLD, YLD * 4, 128));
}

// The pass before mm_bwd_dkv_wg, a warp a row: rows r < rows_g of the
// (B*H*A*T, dh) g_a and forward output: delta[r] = rowsum(g * o) (the
// arithmetic of mm_bwd_delta), g's row rounded to TF32 into gr and inv[r] =
// 1 / den[r]; rows_g + r' (r' < rows_q): qm's row r' rounded into qr.  The
// kernel's producer then copies its operands as they are (dh % 4 == 0,
// 16-byte rows: the wrapper pads).
__global__ void __launch_bounds__(256)
mm_bwd_prep_wg(const float* __restrict__ o, const float* __restrict__ g, const float* __restrict__ den,
               const float* __restrict__ q, float* __restrict__ delta, float* __restrict__ gr,
               float* __restrict__ inv, float* __restrict__ qr, int rows_g, int rows_q, int dh) {
  const int r = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r < rows_g) {
    const float4* x4 = reinterpret_cast<const float4*>(o + (size_t)r * dh);
    const float4* y4 = reinterpret_cast<const float4*>(g + (size_t)r * dh);
    float4* z4 = reinterpret_cast<float4*>(gr + (size_t)r * dh);
    float sum = 0.f;
    for (int c = lane; c < dh / 4; c += 32) {
      const float4 a = __ldg(x4 + c), b = __ldg(y4 + c);
      sum += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
      z4[c] = round4(b);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      delta[r] = sum;
      inv[r] = __frcp_rn(den[r]);  // den >= 1
    }
  } else if (r - rows_g < rows_q) {
    const size_t rq = (size_t)(r - rows_g) * dh;
    for (int c = lane; c < dh / 4; c += 32)
      reinterpret_cast<float4*>(qr + rq)[c] = round4(__ldg(reinterpret_cast<const float4*>(q + rq) + c));
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
mm_bwd_dkv_wg(const float* __restrict__ qr, const float* __restrict__ km, const float* __restrict__ vm,
              const float* __restrict__ cn, const float* __restrict__ key_mask, const float* __restrict__ fb,
              const int* __restrict__ fid, const float* __restrict__ gr, const float* __restrict__ mrow,
              const float* __restrict__ inv, const float* __restrict__ delta, float* __restrict__ dk,
              float* __restrict__ dv, float* __restrict__ dcn, __nv_bfloat16* __restrict__ comb, int H, int A,
              int T, int dh, int F, bool vec_comb) {
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kWgBlockKeys;
  const int tid = threadIdx.x, lane = tid & 31;

  extern __shared__ __align__(128) float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // 2 warpgroups x kWgKV
  float* Vs = Ks + 2 * kWgKV;                   // 2 warpgroups x kWgKV
  float* Qr = Vs + 2 * kWgKV;                   // 2 slots x kWgQ
  float* Gr = Qr + 2 * kWgQ;                    // 2 slots x kWgG
  float* Sr = Gr + 2 * kWgG;                    // 2 slots x kWgStats
  int* Fq = reinterpret_cast<int*>(Sr + 2 * kWgStats);                // 2 slots x kWgRows: query frames
  float* Ps = reinterpret_cast<float*>(Fq + 2 * kWgRows);             // 2 warpgroups x kWgP
  __nv_bfloat16* Cb = reinterpret_cast<__nv_bfloat16*>(Ps + 2 * kWgP);  // 2 warpgroups x kWgC floats
  float* Dc = Ps + 2 * kWgP + 2 * kWgC;                               // kWgArgs x kWgBlockKeys: dcn
  uint64_t* bars = reinterpret_cast<uint64_t*>(Dc + kWgArgs * kWgBlockKeys);
  uint64_t* qfull = bars;       // a Q slot is in (the producer warpgroup's 128 threads)
  uint64_t* qempty = bars + 2;  // a Q slot is read (a lane of each consumer warp)
  uint64_t* gfull = bars + 4;
  uint64_t* gempty = bars + 6;
  const float* fbg = fb + (size_t)h * F * F;
  const size_t base = (size_t)bh * T * dh;
  const size_t arow = (size_t)bh * A * T;  // row (bh, a = 0, i = 0) of the (B,H,A,T) tensors
  const int ntiles = (T + kWgRows - 1) / kWgRows;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(qfull + i, 128);
      mbar_init(gfull + i, 128);
      mbar_init(qempty + i, 8);
      mbar_init(gempty + i, 8);
    }
    mbar_fence_init();
  }
  for (int i = tid; i < kWgArgs * kWgBlockKeys; i += kWgThreads) Dc[i] = 0.f;
  // the block's K and V rows, resident: lanes over 8 rows x 4 column groups
  // (64 contiguous bytes of a row read, 4-way writes of 16 bytes: one pass)
  for (int i = tid; i < 2 * kWgBlockKeys * kWgGroups; i += kWgThreads) {
    const int x = i & 4095, r = ((x >> 2) & 7) + 8 * ((x >> 5) & 15), c = (x & 3) + 4 * (x >> 9);
    const int kj = k0 + r;
    const bool ok = kj < T && 4 * c < dh;
    const float* src = (i < 4096 ? km : vm) + base;
    float* dst = (i < 4096 ? Ks : Vs) + (r >> 6) * kWgKV + cm_idx(r & 63, c, kWgKeys * 4);
    cp_async16(dst, ok ? src + (size_t)kj * dh + 4 * c : src, ok);
  }
  cp_commit();
  cp_wait_all();
  __syncthreads();
  for (int i = tid; i < 2 * 2 * kWgKV / 4; i += kWgThreads) {  // rounded to TF32 in place (K and V)
    float4* p = reinterpret_cast<float4*>(Ks) + i;
    *p = round4(*p);
  }
  fence_proxy_async();
  __syncthreads();

  // The producer warpgroup: each thread one row of a tile (lanes over 8 rows
  // x 4 column groups) and 8 of its 32 groups, by 16-byte cp.async from the
  // rows mm_bwd_prep_wg rounded to TF32 (rounding them here, after the
  // copies, made the producer the kernel's bound: its shared-memory reads
  // wait behind the consumers' wgmma operand traffic), and a g_a stage's m,
  // 1 / den and delta by 4-byte cp.async (zero past T); once its copies
  // have landed, a fence for the async proxy and an arrival on the slot's
  // barrier.  The stream: per query tile its Q rows (and frames) into a Q
  // slot, then each arg's g_a rows and statistics into a g_a slot, each
  // slot as the consumers free it.
  if (tid >= kWgCons) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWgProdRegs));
    const int pt = tid - kWgCons, pr = ((pt >> 2) & 7) + 8 * (pt >> 5), pc = pt & 3;
    auto fill = [&](float* dst, int ld, const float* src, int i0) {
      const int row = i0 + pr;
#pragma unroll
      for (int i = 0; i < kWgGroups / 4; ++i) {
        const int c = pc + 4 * i;
        const bool ok = row < T && 4 * c < dh;
        cp_async16(dst + cm_idx(pr, c, ld), ok ? src + (size_t)row * dh + 4 * c : src, ok);
      }
      cp_commit();
    };
    auto land = [&](uint64_t* full) {
      cp_wait_all();
      fence_proxy_async();
      mbar_arrive(full);
    };
    int j = 0;  // g_a stages issued
    for (int it = 0; it < ntiles; ++it) {
      const int i0 = it * kWgRows, qs = it & 1;
      if (it >= 2) mbar_wait(qempty + qs, ((it >> 1) - 1) & 1);
      if (pt < kWgRows) Fq[qs * kWgRows + pt] = i0 + pt < T ? fid[i0 + pt] : 0;
      fill(Qr + qs * kWgQ, kWgQLd, qr + base, i0);
      land(qfull + qs);
      for (int a = 0; a < A; ++a, ++j) {
        const int gs = j & 1;
        if (j >= 2) mbar_wait(gempty + gs, ((j >> 1) - 1) & 1);
        if (pt < kWgStats) {  // rows past T: m 0, 1 / den 0 (p = 0), delta 0
          const int w = pt / kWgRows, qi = i0 + pt % kWgRows;
          const size_t at = arow + (size_t)a * T + (qi < T ? qi : 0);
          cp_async4(Sr + gs * kWgStats + pt, (w == 0 ? mrow : w == 1 ? inv : delta) + at, qi < T);
        }
        fill(Gr + gs * kWgG, kWgGLd, gr + (arow + (size_t)a * T) * dh, i0);
        land(gfull + gs);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsRegs));
  const int wg = tid >> 7, w = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  // this thread's keys (rows g, g + 8 of its warp's 16 in the C fragments):
  // the block's kl and kl + 8, and their codes
  const int kl = kWgKeys * wg + 16 * w + g, kr = k0 + kl;
  const int kc[2] = {key_code<true>(key_mask, fid, b, kr, T), key_code<true>(key_mask, fid, b, kr + 8, T)};
  const float live[2] = {kc[0] == kPast ? 0.f : 1.f, kc[1] == kPast ? 0.f : 1.f};  // p = 0 at keys past T
  const float* Kw = Ks + wg * kWgKV;
  const float* Vw = Vs + wg * kWgKV;
  float* Pw = Ps + wg * kWgP;
  __nv_bfloat16* Cw = Cb + wg * 2 * kWgC;
  // the warpgroup alone (named barrier 1 + wg)
  auto sync_wg = [&]() { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory"); };
  // dV^T and dK^T: rows (d) in §wg_d_of_m's order, columns the warpgroup's keys
  float dvt[2][32], dkt[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dvt[0][i] = dvt[1][i] = dkt[0][i] = dkt[1][i] = 0.f;
  // S^T (biased, masked) and comb^T of the tile: C fragment i = 4 n + 2 r + e
  // at key kl + 8 r, query column 8 n + 2 t + e
  float st[16], cb[16];
  uint32_t af[2][4][4];  // the A fragments of a transposed product

  int j = 0;  // the g_a stage read next
  for (int it = 0; it < ntiles; ++it) {
    const int i0 = it * kWgRows, qs = it & 1;
    const float* Qt = Qr + qs * kWgQ;
    mbar_wait(qfull + qs, (it >> 1) & 1);
    scores_t<kWgQLd>(st, Kw, Qt);  // S^T = K Q^T, once a query tile for all args
    wg_commit();
    float bias[16];  // the frame bias, loaded while the products run
    const int* fq = Fq + qs * kWgRows;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int f = fq[8 * n + 2 * t + e];
#pragma unroll
        for (int r = 0; r < 2; ++r) bias[4 * n + 2 * r + e] = __ldg(fbg + f * F + max(kc[r], 0));
      }
    wg_wait<0>();
    wg_fence_operand(st);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      st[i] = kc[(i >> 1) & 1] >= 0 ? st[i] + bias[i] : kNeg;  // masked keys and keys past T
      cb[i] = 0.f;
    }

#pragma unroll 1
    for (int a = 0; a < A; ++a, ++j) {
      const int gs = j & 1;
      const float* Gt = Gr + gs * kWgG;
      const float* ss = Sr + gs * kWgStats;
      const float cn0 = kr < T ? __ldg(cn + arow + (size_t)a * T + kr) : 0.f;
      const float cn1 = kr + 8 < T ? __ldg(cn + arow + (size_t)a * T + kr + 8) : 0.f;
      mbar_wait(gfull + gs, (j >> 1) & 1);
      float dp[16];  // dP_a^T = V G_a^T
      scores_t<kWgGLd>(dp, Vw, Gt);
      wg_commit();
      // while it runs: P_a^T = exp(S^T + cn_a - m_a) / den_a, 0 past T (1 / den
      // = 0 there) and at keys past T, without a branch (every exp is finite:
      // S^T + cn_a <= m_a but for rounding, or -1e30 at a masked key)
      float p[16];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float2 m = *reinterpret_cast<const float2*>(ss + 8 * n + 2 * t);
        const float2 inv = *reinterpret_cast<const float2*>(ss + kWgRows + 8 * n + 2 * t);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float c = r ? cn1 : cn0;
          p[4 * n + 2 * r] = expf(st[4 * n + 2 * r] + c - m.x) * (inv.x * live[r]);
          p[4 * n + 2 * r + 1] = expf(st[4 * n + 2 * r + 1] + c - m.y) * (inv.y * live[r]);
        }
      }
      float2 dl[4];  // delta_a at this lane's query columns
#pragma unroll
      for (int n = 0; n < 4; ++n) dl[n] = *reinterpret_cast<const float2*>(ss + 2 * kWgRows + 8 * n + 2 * t);
      wg_wait<0>();
      wg_fence_operand(dp);
      // ds_a = P_a^T (dP_a^T - delta_a)
      float d0 = 0.f, d1 = 0.f;  // this lane's part of dcn_a at its two keys
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // (key row e >> 1, query column e & 1)
          const int i = 4 * n + e;
          const float ds = p[i] * (dp[i] - (e & 1 ? dl[n].y : dl[n].x));
          cb[i] += ds;
          if (e >> 1) d1 += ds;
          else d0 += ds;
          dp[i] = __uint_as_float(round_tf32(p[i]));  // P_a^T, the B operand of dV^T
        }
      }
      d0 = quad_sum(d0);
      d1 = quad_sum(d1);
      if (t == 0) {  // each (arg, key) sum kept by one thread: the tiles add in order
        Dc[a * kWgBlockKeys + kl] += d0;
        Dc[a * kWgBlockKeys + kl + 8] += d1;
      }
      // P_a^T into the staging tile: row (key) kl + 8 r, columns 8 n + 2 t, + 1
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(Pw + cm_idx(16 * w + g + 8 * r, 2 * n + (t >> 1), kWgPLd) + 2 * (t & 1)) =
              make_float2(dp[4 * n + 2 * r], dp[4 * n + 2 * r + 1]);
      fence_proxy_async();
      a_frags_t<kWgGLd>(af, Gt, w, g, t);
      sync_wg();  // the whole P_a^T tile is in
      wg_fence();
      product_t(dvt, af, Pw);  // dV^T += G_a^T P_a^T^T
      wg_commit();
      wg_wait<0>();
      if (lane == 0) mbar_arrive(gempty + gs);  // this warp is done with the g_a stage
    }

    // comb^T on the valid keys: rounded into the staging tile (dK^T's B),
    // and in bf16 into the store tile [query][key]
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * n + 2 * r;
        const float c0 = kc[r] < 0 ? 0.f : cb[i], c1 = kc[r] < 0 ? 0.f : cb[i + 1];
        *reinterpret_cast<float2*>(Pw + cm_idx(16 * w + g + 8 * r, 2 * n + (t >> 1), kWgPLd) + 2 * (t & 1)) =
            make_float2(__uint_as_float(round_tf32(c0)), __uint_as_float(round_tf32(c1)));
        const int key = 16 * w + g + 8 * r, q = 8 * n + 2 * t;
        Cw[q * kWgKeys + key] = __float2bfloat16_rn(c0);
        Cw[(q + 1) * kWgKeys + key] = __float2bfloat16_rn(c1);
      }
    fence_proxy_async();
    a_frags_t<kWgQLd>(af, Qt, w, g, t);
    sync_wg();  // comb^T is whole
    wg_fence();
    product_t(dkt, af, Pw);  // dK^T += Q^T comb^T^T
    wg_commit();
    // comb (B*H, T, T) out while the product runs: 16 bytes (8 keys of a
    // query row) a store, a row's 64 keys 128 contiguous bytes
    const int key0 = k0 + kWgKeys * wg;
#pragma unroll
    for (int c = tid & 127; c < kWgRows * kWgKeys / 8; c += 128) {
      const int row = c >> 3, kk = 8 * (c & 7), qi = i0 + row;
      if (qi >= T || key0 + kk >= T) continue;
      __nv_bfloat16* dst = comb + ((size_t)bh * T + qi) * T + key0 + kk;
      const __nv_bfloat16* src = Cw + row * kWgKeys + kk;
      if (vec_comb && key0 + kk + 8 <= T) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && key0 + kk + e < T; ++e) dst[e] = src[e];
      }
    }
    wg_wait<0>();
    if (lane == 0) mbar_arrive(qempty + qs);  // this warp is done with the Q slot
  }

  // dcn, dK and dV of the warpgroup's keys: C fragment (h, 4 n + e) at d =
  // 64 h + 16 w + 2 g + (e >> 1) (§wg_d_of_m), key 8 n + 2 t + (e & 1)
  if (t == 0)
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (kr + 8 * r < T) dcn[arow + (size_t)a * T + kr + 8 * r] = Dc[a * kWgBlockKeys + kl + 8 * r];
  const int key0 = k0 + kWgKeys * wg;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * hh + 16 * w + 2 * g + (e >> 1), kj = key0 + 8 * n + 2 * t + (e & 1);
        if (kj < T && d < dh) {
          dv[base + (size_t)kj * dh + d] = dvt[hh][4 * n + e];
          dk[base + (size_t)kj * dh + d] = dkt[hh][4 * n + e];
        }
      }
}

// mm_bwd_prep_wg, then mm_bwd_dkv_wg (dh % 4 == 0, 16-byte-aligned rows:
// the wrapper pads; gr, qr and inv the wrapper's scratch, the size of gout,
// qm and den)
int launch_bwd_wg(const float* qm, const float* km, const float* vm, const float* cn, const float* key_mask,
                  const float* fb, const int* fid, const float* gout, const float* out, const float* mrow,
                  const float* den, float* delta, float* gr, float* qr, float* inv, float* dk, float* dv,
                  float* dcn, __nv_bfloat16* comb, int B, int H, int A, int T, int dh, int F, cudaStream_t stream) {
  const int rows = B * H * A * T, rows_q = B * H * T;
  mm_bwd_prep_wg<<<(rows + rows_q + 7) / 8, 256, 0, stream>>>(out, gout, den, qm, delta, gr, inv, qr, rows, rows_q,
                                                              dh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(mm_bwd_dkv_wg, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWgSmem);
  if (e != cudaSuccess) return (int)e;
  const bool vec_comb = T % 8 == 0 && aligned16(comb);  // every row's 8-key runs on 16 bytes
  const dim3 grid((T + kWgBlockKeys - 1) / kWgBlockKeys, B * H);
  mm_bwd_dkv_wg<<<grid, kWgThreads, kWgSmem, stream>>>(qr, km, vm, cn, key_mask, fb, fid, gr, mrow, inv,
                                                        delta, dk, dv, dcn, comb, H, A, T, dh, F, vec_comb);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// forward at "default", dh <= 128: mm_fwd_wg on wgmma
// ---------------------------------------------------------------------------
// The production recipe's forward (one TF32 pass) at dh <= 128, in the same
// library part as mm_bwd_dkv_wg; F and dh are run-time, A (1..kFwArgs) a
// template parameter.  The design note at the top of this file says how it
// works.
constexpr int kFwRows = 64;                  // query rows a block owns: wgmma's M
constexpr int kFwKeys = 32;                  // keys a streamed tile: N of S
constexpr int kFwArgs = 5;                   // args a launch takes at most (the wrapper's groups)
// setmaxnreg's split of the register file: 128 x 40 + 256 x 232 = 384 x 168
// (56 / 224 spilled in the consumers at A = 5; 40 in the producer until its
// loop over cn stayed rolled)
constexpr int kFwProdRegs = 40, kFwConsRegs = 232;
constexpr int kFwQLd = kFwRows * 4;          // the resident Q tile's LD (A of S): 256
constexpr int kFwQ = kWgGroups * kFwQLd;
constexpr int kFwKLd = kFwKeys * 4;          // a K tile's LD (B of S): 128
constexpr int kFwK = kWgGroups * kFwKLd;
// a V tile's LD: 16 floats of padding a group, so that the transposed
// A-fragment reads (two rows' float2 a lane) hit 32 distinct banks
constexpr int kFwVLd = kFwKeys * 4 + 16;
constexpr int kFwV = kWgGroups * kFwVLd;
// P_a of a tile, the B operand of O_a^T: rows the 64 query rows, columns
// the 32 keys (padded: the float2 stores from the C fragments hit 32
// distinct banks)
constexpr int kFwPLd = kFwRows * 4 + 16;
constexpr int kFwP = (kFwKeys / 4) * kFwPLd;
// a float2 a (arg, consumer thread): its rows' reference max, true max part or sum part
constexpr int kFwStats = kFwArgs * kWgCons * 2;
constexpr int kFwRow = kFwArgs * kFwRows;        // a value a (arg, query row), in §fw_pos order
constexpr int kFwFlags = kFwArgs * 4;            // a tile's rescale flags: an int a (arg, warp)
// a row's reference max moves only where a tile passes it by more than this
// (P <= e^8: the sums stay far inside fp32's range)
constexpr float kLazy = 8.f;
constexpr size_t kFwFloats = kFwQ + 2 * (size_t)kFwK + 2 * kFwV + 2 * kFwArgs * kFwP + 2 * kFwArgs * kFwKeys +
                             2 * kFwKeys + 3 * kFwStats + 4 * kFwRow + 4 * kFwFlags;
constexpr size_t kFwSmem = sizeof(float) * kFwFloats + 8 * sizeof(uint64_t);
static_assert(kFwSmem <= 232448, "a block's shared memory on the H100");
static_assert(2 * kFwRow <= 2 * kFwArgs * kFwP, "the row sums' exchange fits a P buffer");

// where a per-row value of query row q (0..63) sits in a 64-float vector:
// the 16 columns of a lane (t) of an O^T C fragment, q = 8 n + 2 t + e,
// are contiguous (16 t + 2 n + e), four 16-byte reads a lane
__device__ inline int fw_pos(int q) { return 16 * ((q >> 1) & 3) + 2 * (q >> 3) + (q & 1); }

// The pass before mm_fwd_wg: km rounded to TF32 into kr (the streamed B
// operand of S, which the producer copies as it is), n4 float4s
__global__ void __launch_bounds__(256)
mm_fwd_prep_wg(const float4* __restrict__ k, float4* __restrict__ kr, size_t n4) {
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < n4; i += (size_t)gridDim.x * 256)
    kr[i] = round4(__ldg(k + i));
}

template <int A>
__global__ void __launch_bounds__(kWgThreads, 1)
mm_fwd_wg(const float* __restrict__ qm, const float* __restrict__ kr, const float* __restrict__ vm,
          const float* __restrict__ cn, const float* __restrict__ key_mask, const float* __restrict__ fb,
          const int* __restrict__ fid, float* __restrict__ o, float* __restrict__ mrow, float* __restrict__ den,
          int H, int T, int dh, int F, int Aall, int a0) {
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kFwRows;
  const int tid = threadIdx.x, lane = tid & 31;

  extern __shared__ __align__(128) float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // kFwQ
  float* Ks = Qs + kFwQ;                        // 2 slots x kFwK
  float* Vs = Ks + 2 * kFwK;                    // 2 slots x kFwV
  float* Ps = Vs + 2 * kFwV;                    // 2 buffers x kFwArgs x kFwP
  float* Cs = Ps + 2 * kFwArgs * kFwP;          // 2 slots x kFwArgs x kFwKeys: cn, zero past T
  int* codes = reinterpret_cast<int*>(Cs + 2 * kFwArgs * kFwKeys);  // 2 slots x kFwKeys: key codes
  float* Ms = reinterpret_cast<float*>(codes + 2 * kFwKeys);      // kFwStats: each thread's rows' reference max
  float* Ts = Ms + kFwStats;                                        // kFwStats: its part of their true max
  float* Ls = Ts + kFwStats;                                        // kFwStats: its part of their sums
  float* Al = Ls + kFwStats;  // 2 warpgroups x 2 parities x kFwRow: the rescale factors of a tile
  int* Fl = reinterpret_cast<int*>(Al + 4 * kFwRow);  // 2 warpgroups x 2 parities x kFwFlags
  uint64_t* bars = reinterpret_cast<uint64_t*>(Fl + 4 * kFwFlags);
  uint64_t* kfull = bars;       // a K slot is in (the producer warpgroup's 128 threads)
  uint64_t* kempty = bars + 2;  // a K slot is read (a lane of each consumer warp)
  uint64_t* vfull = bars + 4;
  uint64_t* vempty = bars + 6;
  const size_t base = (size_t)bh * T * dh;
  const int ntiles = (T + kFwKeys - 1) / kFwKeys;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(kfull + i, 128);
      mbar_init(vfull + i, 128);
      mbar_init(kempty + i, 8);
      mbar_init(vempty + i, 8);
    }
    mbar_fence_init();
  }
  // the block's Q rows, resident: lanes over 8 rows x 4 column groups, then
  // rounded to TF32 in place once
  for (int i = tid; i < kFwRows * kWgGroups; i += kWgThreads) {
    const int r = ((i >> 2) & 7) + 8 * ((i >> 5) & 7), c = (i & 3) + 4 * (i >> 8);
    const int qi = q0 + r;
    const bool ok = qi < T && 4 * c < dh;
    cp_async16(Qs + cm_idx(r, c, kFwQLd), ok ? qm + base + (size_t)qi * dh + 4 * c : qm, ok);
  }
  cp_commit();
  cp_wait_all();
  __syncthreads();
  for (int i = tid; i < kFwQ / 4; i += kWgThreads) {
    float4* p = reinterpret_cast<float4*>(Qs) + i;
    *p = round4(*p);
  }
  fence_proxy_async();
  __syncthreads();

  // The producer warpgroup: each thread one row of a tile (lanes over 8 rows
  // x 4 column groups) and 8 of its 32 groups, by 16-byte cp.async (all 128
  // threads issue); a K stage also holds the tile's key codes and each
  // arg's cn (4-byte cp.async, zero past T).  Once its copies have landed,
  // a fence for the async proxy and an arrival on the slot's barrier.  K and
  // V have slots of their own: a K slot is freed once the tile's scores and
  // softmax are done, a V slot once the consumers hold its fragments, so
  // each loads a tile ahead.
  // the warpgroup's index, warp-uniform for the compiler (a shuffle from
  // lane 0): ptxas serializes the wgmma of code it cannot prove convergent
  const int wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (wgi == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kFwProdRegs));
    const int pt = tid - kWgCons, pr = ((pt >> 2) & 7) + 8 * (pt >> 5), pc = pt & 3;
    auto fill = [&](float* dst, int ld, const float* src, int j0) {
      const int row = j0 + pr;
#pragma unroll 1
      for (int i = 0; i < kWgGroups / 4; ++i) {
        const int c = pc + 4 * i;
        const bool ok = row < T && 4 * c < dh;
        cp_async16(dst + cm_idx(pr, c, ld), ok ? src + (size_t)row * dh + 4 * c : src, ok);
      }
      cp_commit();
    };
    auto land = [&](uint64_t* full) {
      cp_wait_all();
      fence_proxy_async();
      mbar_arrive(full);
    };
    const float* cb = cn + ((size_t)bh * Aall + a0) * T;  // this launch's args of the (B,H,Aall,T) cn
    for (int it = 0; it < ntiles; ++it) {
      const int s = it & 1, j0 = it * kFwKeys;
      if (it >= 2) mbar_wait(kempty + s, ((it >> 1) - 1) & 1);
      if (pt < kFwKeys) codes[s * kFwKeys + pt] = key_code<true>(key_mask, fid, b, j0 + pt, T);
      // each arg's cn (rolled: unrolled, the loop spills at 40 registers)
#pragma unroll 1
      for (int i = pt; i < A * kFwKeys; i += 128) {
        const int a = i / kFwKeys, j = j0 + i % kFwKeys;
        cp_async4(Cs + s * kFwArgs * kFwKeys + i, j < T ? cb + (size_t)a * T + j : cb, j < T);
      }
      fill(Ks + s * kFwK, kFwKLd, kr + base, j0);
      land(kfull + s);
      if (it >= 2) mbar_wait(vempty + s, ((it >> 1) - 1) & 1);
      fill(Vs + s * kFwV, kFwVLd, vm + base, j0);
      land(vfull + s);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kFwConsRegs));
  const int wg = wgi, w = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  // this thread's query rows in S (rows g, g + 8 of its warp's 16): the
  // block's r0 and r0 + 8, their frames' rows of the bias table
  const int r0 = 16 * w + g;
  const int fo0 = (h * F + (q0 + r0 < T ? fid[q0 + r0] : 0)) * F;
  const int fo1 = (h * F + (q0 + r0 + 8 < T ? fid[q0 + r0 + 8] : 0)) * F;
  float2* Mt = reinterpret_cast<float2*>(Ms) + tid;  // + a * kWgCons: this thread's rows' reference max, arg a
  float2* Tt = reinterpret_cast<float2*>(Ts) + tid;  // ... its part of their true max
  float2* Lt = reinterpret_cast<float2*>(Ls) + tid;  // ... its part of their sums
  float* Alw = Al + wg * 2 * kFwRow;                 // + parity * kFwRow + a * kFwRows: this warpgroup's factors
  int* Flw = Fl + wg * 2 * kFwFlags;                 // + parity * kFwFlags + 4 a + w: its warps' flags
  // the consumers alone (named barrier 1, 256 threads)
  auto sync_cons = [&]() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); };
  for (int a = 0; a < A; ++a) {
    Mt[a * kWgCons] = Tt[a * kWgCons] = make_float2(kNeg, kNeg);
    Lt[a * kWgCons] = make_float2(0.f, 0.f);
  }
  // O_a^T of the warpgroup's 64 head-dim columns (rows, in §wg_d_of_m's
  // order) x the 64 query rows: C fragment (a, 4 n + 2 r + e) at d = 64 wg +
  // 16 w + 2 g + r, query 8 n + 2 t + e
  float oa[A][32];
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) oa[a][i] = 0.f;
  // S of a tile, biased and masked: C fragment i = 4 n + 2 r + e at query
  // row r0 + 8 r, key 8 n + 2 t + e
  float sa[16];

  // S of tile it (in sa, its wgmma done): bias and key masks; then per arg
  // the online softmax over the tile's 32 keys.  Every warpgroup computes
  // each row's max over all of them, so the two hold the same reference
  // maxima with no exchange.  A row's reference m_a moves only where the
  // tile's max passes it by more than kLazy (a warp's 16 rows together,
  // decided by a vote): then m_a becomes the running max and the tile's
  // rescale factors exp(m_old - m_a) go into this warpgroup's parity
  // buffer with the warp's flag set; elsewhere the factor is 1 and the
  // flag clear, so O_a^T is rescaled only in the tiles that move a
  // reference.  Each lane also keeps its part of the true running max (the
  // row max written out).  P_a = exp(S + cn_a - m_a) (<= e^kLazy) at this
  // warpgroup's 16 keys (n = 2 wg, 2 wg + 1: every exp once a block) is
  // rounded to TF32 into the shared P tile, its sum into this thread's part
  auto softmax = [&](int it) {
    const int s = it & 1;
    const int* kc = codes + s * kFwKeys;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int2 c2 = *reinterpret_cast<const int2*>(kc + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = e ? c2.y : c2.x;
        const float b0 = __ldg(fb + fo0 + max(c, 0)), b1 = __ldg(fb + fo1 + max(c, 0));
        const float fill = c == kMasked ? kNeg : -INFINITY;  // a masked key, a key past T
        sa[4 * n + e] = c >= 0 ? sa[4 * n + e] + b0 : fill;
        sa[4 * n + 2 + e] = c >= 0 ? sa[4 * n + 2 + e] + b1 : fill;
      }
    }
    float* Pb = Ps + s * kFwArgs * kFwP;
    float* Alp = Alw + s * kFwRow;
    int* Flp = Flw + s * kFwArgs * 4;
    const float* ct = Cs + s * kFwArgs * kFwKeys + 2 * t;  // + a * kFwKeys: cn_a at this lane's keys
#pragma unroll 1
    for (int a = 0; a < A; ++a) {  // this lane's max of t_a = S + cn_a at its rows, the reference's move
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float2 c2 = *reinterpret_cast<const float2*>(ct + a * kFwKeys + 8 * n);
        mx0 = fmaxf(mx0, fmaxf(sa[4 * n] + c2.x, sa[4 * n + 1] + c2.y));
        mx1 = fmaxf(mx1, fmaxf(sa[4 * n + 2] + c2.x, sa[4 * n + 3] + c2.y));
      }
      const float2 mr = Mt[a * kWgCons], mt = Tt[a * kWgCons];
      Tt[a * kWgCons] = make_float2(fmaxf(mt.x, mx0), fmaxf(mt.y, mx1));
      const bool up = __any_sync(0xffffffffu, mx0 > mr.x + kLazy || mx1 > mr.y + kLazy);
      float al0 = 1.f, al1 = 1.f;
      {  // where up, the warp's rows take the running max as their reference (no branch
        // while the values' products run)
        const float q0 = quad_max(mx0), q1 = quad_max(mx1);
        const float m0 = up ? fmaxf(mr.x, q0) : mr.x, m1 = up ? fmaxf(mr.y, q1) : mr.y;
        al0 = __expf(mr.x - m0);
        al1 = __expf(mr.y - m1);
        Mt[a * kWgCons] = make_float2(m0, m1);
        const float2 lo = Lt[a * kWgCons];
        Lt[a * kWgCons] = make_float2(lo.x * al0, lo.y * al1);
      }
      if (t == 0) {
        Alp[a * kFwRows + fw_pos(r0)] = al0;
        Alp[a * kFwRows + fw_pos(r0 + 8)] = al1;
      }
      if (lane == 0) Flp[a * 4 + w] = up;
    }
#pragma unroll 1
    for (int a = 0; a < A; ++a) {
      const float2 mr = Mt[a * kWgCons];
      float* Pa = Pb + a * kFwP;
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // n = 2 wg + j, without indexing the registers at run time
        const float v0 = wg ? sa[8 + 4 * j] : sa[4 * j], v1 = wg ? sa[9 + 4 * j] : sa[1 + 4 * j];
        const float v2 = wg ? sa[10 + 4 * j] : sa[2 + 4 * j], v3 = wg ? sa[11 + 4 * j] : sa[3 + 4 * j];
        const float2 c2 = *reinterpret_cast<const float2*>(ct + a * kFwKeys + 8 * (2 * wg + j));
        const float p0 = __expf((v0 + c2.x) - mr.x), p1 = __expf((v1 + c2.y) - mr.x);
        const float p2 = __expf((v2 + c2.x) - mr.y), p3 = __expf((v3 + c2.y) - mr.y);
        l0 += p0 + p1;
        l1 += p2 + p3;
        float* pp = Pa + cm_idx(r0, 2 * (2 * wg + j) + (t >> 1), kFwPLd) + 2 * (t & 1);
        *reinterpret_cast<float2*>(pp) = make_float2(__uint_as_float(round_tf32(p0)), __uint_as_float(round_tf32(p1)));
        *reinterpret_cast<float2*>(pp + 32) =  // row r0 + 8
            make_float2(__uint_as_float(round_tf32(p2)), __uint_as_float(round_tf32(p3)));
      }
      const float2 lo = Lt[a * kWgCons];
      Lt[a * kWgCons] = make_float2(lo.x + l0, lo.y + l1);
    }
  };

  // the prologue: S and the softmax of tile 0
  mbar_wait(kfull, 0);
  scores_t<kFwKLd>(sa, Qs, Ks);
  wg_commit();
  wg_wait<0>();
  wg_fence_operand(sa);
  softmax(0);
  if (lane == 0) mbar_arrive(kempty);
  fence_proxy_async();
  sync_cons();  // P_0 is whole

  // the A fragments of V^T of tile it (this warpgroup's 64 head-dim rows, 4
  // k-steps of 8 keys), read from the V tile as it lies and rounded to
  // TF32: row 16 w + g is d = 64 wg + 16 w + 2 g, row 16 w + g + 8 is d + 1;
  // then O_a^T *= alpha_a of tile it, by query column, where a warp's flag
  // is set.  No wgmma is in flight here: ptxas serializes every wgmma of a
  // kernel that touches an accumulator between a wgmma's issue and its wait
  uint32_t vf[4][4];
  auto frags_rescale = [&](int it) {
    const int s = it & 1;
    mbar_wait(vfull + s, (it >> 1) & 1);
    const float* Vt = Vs + s * kFwV;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* p = Vt + cm_idx(8 * k + t, 16 * wg + 4 * w + (g >> 1), kFwVLd) + 2 * (g & 1);
      const float2 lo = *reinterpret_cast<const float2*>(p);
      const float2 hi = *reinterpret_cast<const float2*>(p + 16);  // row + 4
      vf[k][0] = round_tf32(lo.x);
      vf[k][1] = round_tf32(lo.y);
      vf[k][2] = round_tf32(hi.x);
      vf[k][3] = round_tf32(hi.y);
    }
    if (it == 0) return;
    const float* Alp = Alw + s * kFwRow;
    const int4* fl = reinterpret_cast<const int4*>(Flw + s * kFwFlags);
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int4 f = fl[a];
      if (!(f.x | f.y | f.z | f.w)) continue;
      const float4* al = reinterpret_cast<const float4*>(Alp + a * kFwRows + 16 * t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = al[j];  // n = 2 j (e 0, 1), n = 2 j + 1 (e 0, 1)
        oa[a][8 * j] *= v.x;
        oa[a][8 * j + 2] *= v.x;
        oa[a][8 * j + 1] *= v.y;
        oa[a][8 * j + 3] *= v.y;
        oa[a][8 * j + 4] *= v.z;
        oa[a][8 * j + 6] *= v.z;
        oa[a][8 * j + 5] *= v.w;
        oa[a][8 * j + 7] *= v.w;
      }
    }
  };
  // O_a^T += V^T P_a^T of tile it, every arg (one group)
  auto values = [&](int it) {
#pragma unroll
    for (int a = 0; a < A; ++a) wg_fence_operand(oa[a]);
    wg_fence();  // after the accumulators' and fragments' writes
    const float* Pb = Ps + (it & 1) * kFwArgs * kFwP;
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_n64(oa[a], vf[k], kmajor_desc(Pb + a * kFwP + 2 * k * kFwPLd, kFwPLd * 4, 128));
    wg_commit();
    if (lane == 0) mbar_arrive(vempty + (it & 1));  // this warp holds its V fragments
  };

  // Tile it: S of tile it + 1 and O_a^T of tile it on the tensor core
  // together, then the softmax of tile it + 1 (none in flight across it:
  // so 5 args a launch spill nothing); the two warpgroups meet once a tile
  // (P whole, the P buffer it overwrites next read by both).  The last
  // tile's values alone after the loop.
  int it = 0;
  for (; it + 1 < ntiles; ++it) {
    const int s1 = (it + 1) & 1;
    frags_rescale(it);
    mbar_wait(kfull + s1, ((it + 1) >> 1) & 1);
    scores_t<kFwKLd>(sa, Qs, Ks + s1 * kFwK);
    wg_commit();
    values(it);
    wg_wait<0>();  // S of tile it + 1 and the values of tile it
#pragma unroll
    for (int a = 0; a < A; ++a) wg_fence_operand(oa[a]);
    wg_fence_operand(sa);
    softmax(it + 1);
    if (lane == 0) mbar_arrive(kempty + s1);  // this warp is done with the K slot
    fence_proxy_async();
    sync_cons();  // P of tile it + 1 is whole; both warpgroups are done with P of tile it
  }
  frags_rescale(it);
  values(it);
  wg_wait<0>();
#pragma unroll
  for (int a = 0; a < A; ++a) wg_fence_operand(oa[a]);
  sync_cons();  // both warpgroups are done with the P buffers

  // The row sums: this thread's parts summed over its quad, the two
  // warpgroups' added in order (the P buffers are free)
  float* Lx = Ps;  // 2 warpgroups x kFwRow
  for (int a = 0; a < A; ++a) {
    const float2 lp = Lt[a * kWgCons];
    const float s0 = quad_sum(lp.x), s1 = quad_sum(lp.y);
    if (t == 0) {
      Lx[wg * kFwRow + a * kFwRows + fw_pos(r0)] = s0;
      Lx[wg * kFwRow + a * kFwRows + fw_pos(r0 + 8)] = s1;
    }
  }
  sync_cons();
  // the row max (the lanes' true max parts over the quad) and the
  // denominator relative to it, sum * exp(m_ref - max) (>= 1 by
  // construction), of rows < T
  const size_t arow = ((size_t)bh * Aall + a0) * T;  // row (bh, this launch's arg 0, i = 0) of the (B,H,Aall,T) tensors
  if (wg == 0)
    for (int a = 0; a < A; ++a) {
      const float2 mt = Tt[a * kWgCons], mr = Mt[a * kWgCons];
      const float m[2] = {quad_max(mt.x), quad_max(mt.y)}, ref[2] = {mr.x, mr.y};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = r0 + 8 * r, qi = q0 + q;
        if (t == 0 && qi < T) {
          mrow[arow + (size_t)a * T + qi] = m[r];
          den[arow + (size_t)a * T + qi] =
              (Lx[a * kFwRows + fw_pos(q)] + Lx[kFwRow + a * kFwRows + fw_pos(q)]) * expf(ref[r] - m[r]);
        }
      }
    }
  // O_a = (O_a^T)^T / den: a float2 (d, d + 1) a query row
  const int d = 64 * wg + 16 * w + 2 * g;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const float4* l0 = reinterpret_cast<const float4*>(Lx + a * kFwRows + 16 * t);
    const float4* l1 = reinterpret_cast<const float4*>(Lx + kFwRow + a * kFwRows + 16 * t);
    float* oo = o + (arow + (size_t)a * T) * dh;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 x = l0[j], y = l1[j];
      const float inv[4] = {1.f / (x.x + y.x), 1.f / (x.y + y.y), 1.f / (x.z + y.z), 1.f / (x.w + y.w)};
#pragma unroll
      for (int u = 0; u < 4; ++u) {  // n = 2 j + (u >> 1), e = u & 1
        const int n = 2 * j + (u >> 1), e = u & 1, qi = q0 + 8 * n + 2 * t + e;
        if (qi < T && d < dh)
          *reinterpret_cast<float2*>(oo + (size_t)qi * dh + d) =
              make_float2(oa[a][4 * n + e] * inv[u], oa[a][4 * n + 2 + e] * inv[u]);
      }
    }
  }
}

// mm_fwd_prep_wg (with the first group of args: a0 == 0), then mm_fwd_wg on
// args a0 .. a0 + A - 1 of Aall, written in place into the (B,H,Aall,...)
// outputs (dh % 4 == 0, 16-byte-aligned rows: the wrapper pads; kr the
// wrapper's scratch, the size of km, shared by a call's groups)
int launch_fwd_wg(const float* qm, const float* km, const float* vm, const float* cn, const float* key_mask,
                  const float* fb, const int* fid, float* kr, float* o, float* mrow, float* den, int B, int H,
                  int A, int T, int dh, int F, int Aall, int a0, cudaStream_t stream) {
  cudaError_t e;
  if (a0 == 0) {
    const size_t n4 = (size_t)B * H * T * dh / 4;
    const int blocks = (int)((n4 + 255) / 256 < 1056 ? (n4 + 255) / 256 : 1056);
    mm_fwd_prep_wg<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(km), reinterpret_cast<float4*>(kr),
                                                n4);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  auto fwd = A == 1   ? mm_fwd_wg<1>
             : A == 2 ? mm_fwd_wg<2>
             : A == 3 ? mm_fwd_wg<3>
             : A == 4 ? mm_fwd_wg<4>
                      : mm_fwd_wg<5>;
  e = cudaFuncSetAttribute(fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + kFwRows - 1) / kFwRows, B * H);
  fwd<<<grid, kWgThreads, kFwSmem, stream>>>(qm, kr, vm, cn, key_mask, fb, fid, o, mrow, den, H, T, dh, F, Aall, a0);
  return (int)cudaGetLastError();
}
#endif  // VOG_MM_WG

// ---------------------------------------------------------------------------
// backward past head dim 128: the head dim split over a cluster (cluster.cuh)
// ---------------------------------------------------------------------------
// Both kernels have 8 warps: warp w takes 16 rows (keys in mm_bwd_dkv_cl,
// queries in mm_bwd_dq_cl) and the 64 columns of half w / 4 of the block's
// 128-column slice (cluster.cuh).  Each score product (S once a tile, then
// each arg's product, one at a time) is the warp's partial over its 64
// columns, stored to the block's partial buffer at once and summed over the
// cluster's 2n partials of its rows in rank order, so every warp of those
// rows in every block holds the same bits, and only one product's
// fragments are live beside the accumulators: a warp's dK and dV (or dQ)
// are 64 columns, 64 floats a lane, where the narrow instances' 128 spill.
// The partial buffer is single: a block waits on the split cluster barrier
// of the round before (every peer has read it) only when its next partial
// is ready, so the wait hides behind that product.  The rows and tiles come
// in by TMA (mbarriers, two stages), the (B,H,A,T) statistics and cn by
// cp.async; the frame table is read from device memory at any F.  Past 8
// slices (kX) a block adds its other slices' partials from device memory
// (§add_other_slices), each warp its half's columns of them.  The partial
// of a round (A + 1 rounds a tile) is one product's: every product runs
// once a tile, against (A + 1) x slices in the design it replaced.
constexpr int kClWarps = 2 * kRowGroups;
constexpr int kClThreads = kClWarps * 32;
constexpr int kClNV = kHalf / 8;  // a warp's 8-column output tiles
constexpr int kClChunk = 8;       // scores' k-steps a rolled iteration: a half's 8 k-steps, whole
// args a launch of mm_bwd_dkv_cl and mm_bwd_dq_cl, at any passes: a warp's
// accumulators do not grow with A (only dcn's, two a lane an arg), and
// every launch redoes S
constexpr int kClBwdArgs = 8;

// mm_bwd_dkv_cl: the narrow kernel's tile (64 keys a block, 16-row query
// tiles, steps (query tile, arg)) in 8 warps, warp w's 16 keys 16 (w % 4)..
constexpr int kClDkvPart = kClWarps * 32 * 4 * kBwdNT;  // floats of the warps' partials
constexpr int kClDkvSums = kRowGroups * 32 * 4 * kBwdNT;  // ... of the key groups' sums (cluster.cuh)
// shared floats of mm_bwd_dkv_cl at A args (the mbarriers follow): K and V
// rows, the Q and g_a rings, the partials and sums, a step's m, den and
// delta (two stages), cn of the keys, the tiles' query frames
__host__ __device__ constexpr size_t dkv_cl_floats(int A) {
  return (size_t)(2 * kBwdKeys + 4 * kBwdTile) * kSliceLd + kClDkvPart + kClDkvSums + 2 * 3 * kBwdTile +
         A * kBwdKeys + 2 * kBwdTile;
}

template <int A, bool kEmit, bool kX>
__global__ void __launch_bounds__(kClThreads, 1)
mm_bwd_dkv_cl(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap gmap,
              const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
              const float* __restrict__ qm, const float* __restrict__ km, const float* __restrict__ vm,
              const float* __restrict__ cn, const float* __restrict__ key_mask, const float* __restrict__ fb,
              const int* __restrict__ fid, const float* __restrict__ gout, const float* __restrict__ mrow,
              const float* __restrict__ den, const float* __restrict__ delta, float* __restrict__ dk,
              float* __restrict__ dv, float* __restrict__ dcn, DsT* __restrict__ comb, int H, int T, int dh,
              int F, int pass) {
  constexpr int kCLd = kSliceLd;
  constexpr int NT = kBwdNT;
  const int z = (int)cg::this_cluster().block_rank();
  const int zs = slice_of<kX>(z, pass);  // the slice this block stages and accumulates
  const bool own = owns<kX>(zs, dh);     // (else it stages slice 0 and adds only its other slices' partials)
  const int cz = kSlice * (own ? zs : 0);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kBwdKeys;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp % kRowGroups, hc = kHalf * (warp / kRowGroups);  // the warp's keys, its half's columns
  const bool lead = zs == 0 && hc == 0;  // writes comb and dcn (every warp of the keys holds the same bits)

  extern __shared__ __align__(128) float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);              // kBwdKeys x kCLd
  float* Vs = Ks + kBwdKeys * kCLd;                          // kBwdKeys x kCLd
  float* Qs = Vs + kBwdKeys * kCLd;                          // 2 tiles x kBwdTile x kCLd
  float* Gs = Qs + 2 * kBwdTile * kCLd;                      // 2 steps x kBwdTile x kCLd: g_a
  float* Sp = Gs + 2 * kBwdTile * kCLd;                      // kClDkvPart: the warps' partials
  float* Sq = Sp + kClDkvPart;                               // kClDkvSums: the key groups' sums
  float* Ss = Sq + kClDkvSums;                               // 2 steps x 3 x kBwdTile: m, den, delta
  float* Cs = Ss + 2 * 3 * kBwdTile;                         // A x kBwdKeys: cn of the keys
  int* fqs = reinterpret_cast<int*>(Cs + A * kBwdKeys);     // 2 tiles x kBwdTile: query frames
  uint64_t* bars = reinterpret_cast<uint64_t*>(fqs + 2 * kBwdTile);  // K/V, then the step stages
  const float* fbg = fb + (size_t)h * F * F;

  const size_t base = (size_t)bh * T * dh;
  const size_t arow = (size_t)bh * A * T;  // row (bh, a = 0, i = 0) of the (B,H,A,T) tensors
  const int ntiles = (T + kBwdTile - 1) / kBwdTile, nsteps = ntiles * A;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i);
    mbar_fence_init();
  }
  __syncthreads();
  // step j = (query tile j / A, arg j % A): its g_a tile and statistics,
  // and with arg 0 the tile's Q rows and frames
  auto stage = [&](int j) {
    const int it = j / A, a = j - it * A, i0 = it * kBwdTile, sg = j & 1;
    if (tid == 0) {
      mbar_expect(bars + 1 + sg, box_bytes(kBwdTile) * (a == 0 ? 2 : 1));
      tma_load(Gs + sg * kBwdTile * kCLd, &gmap, cz, i0, bh * A + a, bars + 1 + sg);
      if (a == 0) tma_load(Qs + (it & 1) * kBwdTile * kCLd, &qmap, cz, i0, bh, bars + 1 + sg);
    }
    for (int i = tid; i < 3 * kBwdTile; i += kClThreads) {  // zero past T
      const int w = i / kBwdTile, qi = i0 + i % kBwdTile;
      const float* src = (w == 0 ? mrow : w == 1 ? den : delta) + arow + (size_t)a * T + qi;
      cp_async4(Ss + sg * 3 * kBwdTile + i, qi < T ? src : mrow, qi < T);
    }
    if (a == 0 && tid < kBwdTile) {
      const int qi = i0 + tid;
      cp_async4(reinterpret_cast<float*>(fqs + (it & 1) * kBwdTile + tid),
                reinterpret_cast<const float*>(qi < T ? fid + qi : fid), qi < T);
    }
    cp_commit();
  };
  for (int i = tid; i < A * kBwdKeys; i += kClThreads) {
    const int a = i / kBwdKeys, kj = k0 + i % kBwdKeys;
    Cs[i] = kj < T ? cn[arow + (size_t)a * T + kj] : 0.f;
  }
  if (tid == 0) {
    mbar_expect(bars, 2 * box_bytes(kBwdKeys));
    tma_load(Ks, &kmap, cz, k0, bh, bars);
    tma_load(Vs, &vmap, cz, k0, bh, bars);
  }
  stage(0);

  // this lane's keys: kr0 = k0 + 16 kg + g and kr0 + 8 (rows g, g + 8 of
  // the warp's C fragments), query columns 8n + 2t + e of a tile
  const int kl0 = kg * 16 + g, kr0 = k0 + kl0;
  const int kc[2] = {key_code<true>(key_mask, fid, b, kr0, T), key_code<true>(key_mask, fid, b, kr0 + 8, T)};
  const float* Kw = Ks + kg * 16 * kCLd + hc;
  const float* Vw = Vs + kg * 16 * kCLd + hc;
  float adk[kClNV][4], adv[kClNV][4];
  zero(adk);
  zero(adv);
  float dc[A][2];  // this lane's part of dcn_a at its two keys
#pragma unroll
  for (int a = 0; a < A; ++a) dc[a][0] = dc[a][1] = 0.f;
  float st[NT][4], cb[NT][4];  // S^T (biased, masked) of the tile; comb^T = sum_a ds_a^T
  mbar_wait(bars, 0);  // the K and V rows

  bool peers = false;  // a round before this one: its sums may still be read
  // c: the warp's partial -> the cluster's sum (cluster.cuh §sum_halves)
  auto round = [&](float (&c)[NT][4]) { sum_halves<NT>(c, Sp, Sq, warp, lane, peers); };
  int j = 0;  // the step in flight
  auto advance = [&]() {
    cp_wait_all();
    __syncthreads();  // step j's statistics are in; every warp is done with step j - 1
    if (j + 1 < nsteps) stage(j + 1);
    mbar_wait(bars + 1 + (j & 1), (j >> 1) & 1);  // step j's g_a (and Q) tile
  };
  for (int it = 0; it < ntiles; ++it) {
    const int i0 = it * kBwdTile;
    const float* Qt = Qs + (it & 1) * kBwdTile * kCLd + hc;
    advance();  // step (it, 0): the tile's Q and frames, and g_0
    // S^T = K Q^T + fb, once a query tile for all args; masked keys at kNeg
    zero(st);
    if (own) scores<NT, false, kHalf, kOnePass, kClChunk, kCLd>(st, st, Kw, Qt, Kw, Qt, g, t);
    if constexpr (kX)
      add_other_slices<NT>(st, km + base, qm + base, k0 + kg * 16, i0, T, dh, z, pass, g, t, hc, kHalf);
    round(st);
    const int* ft = fqs + (it & 1) * kBwdTile;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int fq = ft[8 * n + 2 * t + e];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int c = kc[r];
          st[n][2 * r + e] = c >= 0 ? st[n][2 * r + e] + table_bias<kGlobalTable>(nullptr, fbg, F, fq, c) : kNeg;
        }
      }
    zero(cb);
#pragma unroll 1
    for (int a = 0; a < A; ++a, ++j) {
      if (a > 0) advance();
      const float* Gt = Gs + (j & 1) * kBwdTile * kCLd + hc;
      const float* mt = Ss + (j & 1) * 3 * kBwdTile;
      const float* dnt = mt + kBwdTile;
      const float* dlt = dnt + kBwdTile;
      float dpt[NT][4];  // dP_a^T = V G_a^T, the cluster's sum
      zero(dpt);
      if (own) scores<NT, false, kHalf, kOnePass, kClChunk, kCLd>(dpt, dpt, Vw, Gt, Vw, Gt, g, t);
      if constexpr (kX)
        add_other_slices<NT>(dpt, vm + base, gout + (arow + (size_t)a * T) * dh, k0 + kg * 16, i0, T, dh, z, pass,
                             g, t, hc, kHalf);
      round(dpt);

      // P_a^T = exp(S^T + cn_a - m_a) / den_a; ds_a = P_a^T (dP_a^T - delta_a)
      const float cn0 = Cs[a * kBwdKeys + kl0], cn1 = Cs[a * kBwdKeys + kl0 + 8];
      float pt[NT][4], ds0 = 0.f, ds1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * n + 2 * t + e;
          const bool qok = i0 + col < T;
          const float m = mt[col], inv = qok ? 1.f / dnt[col] : 0.f, dl = dlt[col];  // den >= 1
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 2 * r + e;
            const float p = !qok || kc[r] == kPast ? 0.f : expf(st[n][i] + (r ? cn1 : cn0) - m) * inv;
            const float ds = p * (dpt[n][i] - dl);
            pt[n][i] = p;
            cb[n][i] += ds;
            if (r) ds1 += ds;
            else ds0 += ds;
          }
        }
#pragma unroll
      for (int aa = 0; aa < A; ++aa)  // a static index keeps dc in registers
        if (aa == a) {
          dc[aa][0] += ds0;
          dc[aa][1] += ds1;
        }
      accumulate<NT, kClNV, kCLd>(adv, pt, Gt, g, t);  // dV += P_a^T G_a, the half's columns
    }

    // comb^T masked to the valid keys; dK += comb^T Q
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (kc[i >> 1] < 0) cb[n][i] = 0.f;
    accumulate<NT, kClNV, kCLd>(adk, cb, Qt, g, t);
    if (!kEmit || !lead) continue;
    // comb[bh, q, k]: a store writes 8 consecutive keys for each of 4 queries
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = i0 + 8 * n + 2 * t + e;
        if (qi >= T) continue;
        DsT* row = comb + ((size_t)bh * T + qi) * T;
        if (kr0 < T) store_ds(row + kr0, cb[n][e]);
        if (kr0 + 8 < T) store_ds(row + kr0 + 8, cb[n][2 + e]);
      }
  }
  cluster_wait();  // no peer reads this block's sums any more

  // dcn: the four lanes of a key add their query columns, in a fixed order
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float d = quad_sum(dc[a][r]);
      const int kj = kr0 + 8 * r;
      if (t == 0 && lead && kj < T) dcn[arow + (size_t)a * T + kj] = d;
    }
  if (!own) return;
  store_rows(dk + base, adk, kr0, cz + hc, T, dh, t, 1.f, 1.f);
  store_rows(dv + base, adv, kr0, cz + hc, T, dh, t, 1.f, 1.f);
}

// mm_bwd_dq_cl (recompute mode): the narrow kernel's block (64 query rows,
// steps (key tile, arg), each arg's g_a rows of the block streamed a step
// ahead) in 8 warps, warp w's 16 rows 16 (w % 4).., with 32-key tiles (a
// warp's four 8-key n-tiles).  Per key tile S is summed once over the
// cluster, then each arg's g_a vm^T; comb = sum_a ds_a is summed on chip,
// and dq_z += comb K_z over the warp's half of the slice.  Every warp of
// the rows holds the same comb, so the frame sums split over the halves:
// half w / 4 sums 32 of the block's 64 key frames (frame_sums, on the
// tensor cores).  A tile of rows has groups of clusters in grid.x (as
// attention.cu's flash_bwd_dq_cl): rank z of group c sums frame tile c n
// + z (key frames 64 (c n + z)..) into its tile's (F, F) partial, rows in
// order, each cell by one block; group 0 also computes dq.
constexpr int kClDqTile = 32;                             // keys of a tile
constexpr int kClDqNT = kClDqTile / 8;                    // a warp's 8-key n-tiles
constexpr int kClDqRows = 16 * kRowGroups;                // query rows a block owns
constexpr int kClDqPart = kClWarps * 32 * 4 * kClDqNT;   // floats of the warps' partials
constexpr int kClDqSums = kRowGroups * 32 * 4 * kClDqNT;  // ... of the row groups' sums (cluster.cuh)
constexpr int kClFrameTiles = kFrameTiles / 2;            // a warp's 8-frame column tiles
// scores' k-steps a rolled iteration: unrolled whole, the half's 8 k-steps
// spilled 4-24 bytes (ptxas, at 255 registers); 4 spill none in 3xTF32 and
// 4 bytes in one pass, 2 none in one pass and 8 bytes in 3xTF32
constexpr int kClDqChunk = kOnePass ? 2 : 4;
// shared floats of mm_bwd_dq_cl at A args (the mbarriers follow): Q rows,
// the g_a ring, the K and V rings, the partials and sums, cn of the key
// tiles (two stages), the rows' m, 1 / den and delta, the key codes (two
// stages)
__host__ __device__ constexpr size_t dq_cl_floats(int A) {
  return (size_t)(3 * kClDqRows + 4 * kClDqTile) * kSliceLd + kClDqPart + kClDqSums + 2 * A * kClDqTile +
         3 * A * kClDqRows + 2 * kClDqTile;
}

template <int A, bool kX>
__global__ void __launch_bounds__(kClThreads, 1)
mm_bwd_dq_cl(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap gmap,
             const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
             const float* __restrict__ qm, const float* __restrict__ km, const float* __restrict__ vm,
             const float* __restrict__ cn, const float* __restrict__ key_mask, const float* __restrict__ fb,
             const int* __restrict__ fid, const float* __restrict__ gout, const float* __restrict__ mrow,
             const float* __restrict__ den, const float* __restrict__ delta, float* __restrict__ dq,
             float* __restrict__ dfb_part, int H, int T, int dh, int F, int pass) {
  constexpr int kCLd = kSliceLd;
  constexpr int NT = kClDqNT;
  const int z = (int)cg::this_cluster().block_rank();
  const int zs = slice_of<kX>(z, pass);
  const bool own = owns<kX>(zs, dh);
  const int cz = kSlice * (own ? zs : 0);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row_tiles = (T + kClDqRows - 1) / kClDqRows;
  const int rt = blockIdx.x % row_tiles, grp = blockIdx.x / row_tiles;
  const int q0 = rt * kClDqRows;
  const bool do_dq = grp == 0 && own;
  const int fbase = kFrameTile * (grp * (int)gridDim.z + z);  // key frames fbase..fbase+63
  const bool do_fr = pass == 0 && fbase < F;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % kRowGroups, half = warp / kRowGroups, hc = kHalf * half;

  extern __shared__ __align__(128) float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);              // kClDqRows x kCLd
  float* Gs = Qs + kClDqRows * kCLd;                         // 2 steps x kClDqRows x kCLd: g_a of the rows
  float* Ks = Gs + 2 * kClDqRows * kCLd;                     // 2 tiles x kClDqTile x kCLd
  float* Vs = Ks + 2 * kClDqTile * kCLd;                     // 2 tiles x kClDqTile x kCLd
  float* Sp = Vs + 2 * kClDqTile * kCLd;                     // kClDqPart: the warps' partials
  float* Sq = Sp + kClDqPart;                                // kClDqSums: the row groups' sums
  float* Cs = Sq + kClDqSums;                                // 2 tiles x A x kClDqTile: cn of the keys
  float* St = Cs + 2 * A * kClDqTile;                        // 3 x A x kClDqRows: m, 1 / den, delta
  int* codes = reinterpret_cast<int*>(St + 3 * A * kClDqRows);  // 2 tiles x kClDqTile
  uint64_t* bars = reinterpret_cast<uint64_t*>(codes + 2 * kClDqTile);  // Q, then the step stages
  const float* fbg = fb + (size_t)h * F * F;

  const size_t base = (size_t)bh * T * dh;
  const size_t arow = (size_t)bh * A * T;  // row (bh, a = 0, i = 0) of the (B,H,A,T) tensors
  const float* cb = cn + arow;
  const int ntiles = (T + kClDqTile - 1) / kClDqTile, nsteps = ntiles * A;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i);
    mbar_fence_init();
  }
  __syncthreads();
  // step j = (key tile j / A, arg j % A): its g_a rows, and with arg 0 the
  // tile's K and V rows, cn and key codes, a step ahead
  auto stage = [&](int j) {
    const int it = j / A, a = j - it * A, sg = j & 1, j0 = it * kClDqTile;
    if (tid == 0) {
      mbar_expect(bars + 1 + sg, box_bytes(kClDqRows) + (a == 0 ? 2 * box_bytes(kClDqTile) : 0));
      tma_load(Gs + sg * kClDqRows * kCLd, &gmap, cz, q0, bh * A + a, bars + 1 + sg);
      if (a == 0) {
        tma_load(Ks + (it & 1) * kClDqTile * kCLd, &kmap, cz, j0, bh, bars + 1 + sg);
        tma_load(Vs + (it & 1) * kClDqTile * kCLd, &vmap, cz, j0, bh, bars + 1 + sg);
      }
    }
    if (a == 0) {
      for (int i = tid; i < A * kClDqTile; i += kClThreads) {  // cn, zero past T
        const int aa = i / kClDqTile, jj = j0 + i % kClDqTile;
        cp_async4(Cs + (it & 1) * A * kClDqTile + i, jj < T ? cb + (size_t)aa * T + jj : cb, jj < T);
      }
      if (tid < kClDqTile) codes[(it & 1) * kClDqTile + tid] = key_code<true>(key_mask, fid, b, j0 + tid, T);
    }
    cp_commit();
  };
  for (int i = tid; i < 3 * A * kClDqRows; i += kClThreads) {  // rows past T: m 0, 1/den 1, delta 0
    const int w = i / (A * kClDqRows), r = i % (A * kClDqRows), qi = q0 + r % kClDqRows;
    const size_t at = arow + (size_t)(r / kClDqRows) * T + qi;
    St[i] = qi >= T ? (w == 1 ? 1.f : 0.f) : w == 0 ? mrow[at] : w == 1 ? 1.f / den[at] : delta[at];
  }
  if (tid == 0) {
    mbar_expect(bars, box_bytes(kClDqRows));
    tma_load(Qs, &qmap, cz, q0, bh, bars);
  }
  stage(0);

  const int r0 = 16 * rg + g;  // this lane's rows of the block: r0 and r0 + 8
  const int fq0 = q0 + r0 < T ? fid[q0 + r0] : 0, fq1 = q0 + r0 + 8 < T ? fid[q0 + r0 + 8] : 0;
  const float* Qw = Qs + 16 * rg * kCLd + hc;
  float acc[kClNV][4];  // dQ of the warp's 16 rows, its half's columns
  zero(acc);
  float rs[kClFrameTiles][4];  // the rows' comb summed by key frame: the half's 32 frames
  zero(rs);
  float sc[NT][4], comb[NT][4];  // S (biased) of the tile; comb = sum_a ds_a
  mbar_wait(bars, 0);  // the Q rows

  bool peers = false;  // a round before this one: its sums may still be read
  // x: the warp's partial -> the cluster's sum (cluster.cuh §sum_halves)
  auto round = [&](float (&x)[NT][4]) { sum_halves<NT>(x, Sp, Sq, warp, lane, peers); };
  int j = 0;  // the step in flight
  for (int it = 0; it < ntiles; ++it) {
    const float* Kt = Ks + (it & 1) * kClDqTile * kCLd + hc;
    const float* Vt = Vs + (it & 1) * kClDqTile * kCLd + hc;
    const float* Ct = Cs + (it & 1) * A * kClDqTile;
    const int* ct = codes + (it & 1) * kClDqTile;  // this lane's keys 8n + 2t + e: ct[8n + 2t + e]
#pragma unroll 1
    for (int a = 0; a < A; ++a, ++j) {
      cp_wait_all();
      __syncthreads();  // step j's cn and codes are in; every warp is done with step j - 1
      if (j + 1 < nsteps) stage(j + 1);
      mbar_wait(bars + 1 + (j & 1), (j >> 1) & 1);  // step j's g_a rows (and the tile's K and V)
      if (a == 0) {  // S = Q K^T + fb, once a key tile for all args
        zero(sc);
        if (own) scores<NT, false, kHalf, kOnePass, kClDqChunk, kCLd>(sc, sc, Qw, Kt, Qw, Kt, g, t);
        if constexpr (kX)
          add_other_slices<NT>(sc, qm + base, km + base, q0 + 16 * rg, it * kClDqTile, T, dh, z, pass, g, t, hc,
                               kHalf);
        round(sc);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = ct[8 * n + 2 * t + e];
            if (c >= 0) {
              sc[n][e] += table_bias<kGlobalTable>(nullptr, fbg, F, fq0, c);
              sc[n][2 + e] += table_bias<kGlobalTable>(nullptr, fbg, F, fq1, c);
            }
          }
        zero(comb);
      }
      float gv[NT][4];  // gv_a = G_a V^T, the cluster's sum
      zero(gv);
      const float* Ga = Gs + ((j & 1) * kClDqRows + 16 * rg) * kCLd + hc;
      if (own) scores<NT, false, kHalf, kOnePass, kClDqChunk, kCLd>(gv, gv, Ga, Vt, Ga, Vt, g, t);
      if constexpr (kX)
        add_other_slices<NT>(gv, gout + (arow + (size_t)a * T) * dh, vm + base, q0 + 16 * rg, it * kClDqTile, T,
                             dh, z, pass, g, t, hc, kHalf);
      round(gv);
      const float* sm = St + a * kClDqRows + r0;
      const float m0 = sm[0], m1 = sm[8];
      const float i0 = sm[A * kClDqRows], i1 = sm[A * kClDqRows + 8];
      const float d0 = sm[2 * A * kClDqRows], d1 = sm[2 * A * kClDqRows + 8];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (ct[8 * n + 2 * t + e] >= 0) {  // ds_a on the valid keys; masked keys and keys past T give 0
            const float ca = Ct[a * kClDqTile + 8 * n + 2 * t + e];
            comb[n][e] += expf(sc[n][e] + ca - m0) * i0 * (gv[n][e] - d0);
            comb[n][2 + e] += expf(sc[n][2 + e] + ca - m1) * i1 * (gv[n][2 + e] - d1);
          }
    }
    if (do_dq) accumulate<NT, kClNV, kCLd>(acc, comb, Kt, g, t);  // dQ += comb K
    if (do_fr) {  // the codes from shared memory (the tile's stage is rewritten two tiles on)
      int c[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) c[n][0] = ct[8 * n + 2 * t], c[n][1] = ct[8 * n + 2 * t + 1];
      frame_sums<NT>(rs, comb, c, F, fbase + 8 * kClFrameTiles * half, g);
    }
  }
  cluster_wait();  // no peer reads this block's sums any more

  if (do_dq) store_rows(dq + base, acc, q0 + r0, cz + hc, T, dh, t, 1.f, 1.f);
  if (!do_fr) return;
  __syncthreads();  // every warp is done with Gs
  float* racc = Gs;  // kClDqRows x kFrameTile: frame sums of the rows
#pragma unroll
  for (int f = 0; f < kClFrameTiles; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = 8 * (kClFrameTiles * half + f) + 2 * t + (i & 1), r = r0 + (i >= 2 ? 8 : 0);
      if (fbase + col < F) racc[r * kFrameTile + col] = rs[f][i];
    }
  __syncthreads();
  // this block's columns fbase.. of the (F, F) partial: rows in order, those of query frame f
  const int nf = min(kFrameTile, F - fbase);
  float* part = dfb_part + ((size_t)bh * row_tiles + rt) * F * F;
  for (int cell = tid; cell < F * nf; cell += kClThreads) {
    const int f = cell / nf, gk = cell - f * nf;
    float sum = 0.f;
    for (int r = 0; r < kClDqRows && q0 + r < T; ++r)
      if (fid[q0 + r] == f) sum += racc[r * kFrameTile + gk];
    part[f * F + fbase + gk] = sum;
  }
}

// delta, then mm_bwd_dkv_cl (and in recompute mode mm_bwd_dq_cl), each as
// clusters of n blocks (the wrapper's plan), one launch a pass (dh % 4 ==
// 0: the wrapper pads), at most kClBwdArgs args.
// mm_bwd_dq_cl's frame tiles (F > 64) are folded into grid.x: ceil(tiles of
// frames / n) groups of clusters in pass 0, group c's rank z summing frame
// tile c n + z, group 0 also computing dq.
template <int A>
int launch_bwd_cl(const float* qm, const float* km, const float* vm, const float* cn,
                  const float* key_mask, const float* fb, const int* fid,
                  const float* gout, const float* out, const float* mrow, const float* den,
                  float* delta, float* dk, float* dv, float* dcn, DsT* comb, float* dq,
                  float* dfb_part, int B, int H, int T, int dh, int F, int n, cudaStream_t s) {
  if constexpr (A > kClBwdArgs) {
    return (int)cudaErrorInvalidValue;
  } else {
  const int BH = B * H, passes = passes_of(dh, n);
  const bool emit = comb != nullptr, x = passes > 1;
  const int rows = BH * A * T;
  mm_bwd_delta<<<(rows + 7) / 8, 256, 0, s>>>(out, gout, delta, rows, dh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap qt, gt, kr, vr;  // the streamed Q / g_a tiles, the resident K / V rows
  e = row_map(&qt, qm, BH, T, dh, kBwdTile);
  if (e == cudaSuccess) e = row_map(&gt, gout, BH * A, T, dh, kBwdTile);
  if (e == cudaSuccess) e = row_map(&kr, km, BH, T, dh, kBwdKeys);
  if (e == cudaSuccess) e = row_map(&vr, vm, BH, T, dh, kBwdKeys);
  if (e != cudaSuccess) return (int)e;
  auto dkv = emit ? (x ? mm_bwd_dkv_cl<A, true, true> : mm_bwd_dkv_cl<A, true, false>)
                  : (x ? mm_bwd_dkv_cl<A, false, true> : mm_bwd_dkv_cl<A, false, false>);
  const size_t smem_kv = sizeof(float) * dkv_cl_floats(A) + 3 * sizeof(uint64_t);
  for (int p = 0; p < passes; ++p) {
    e = launch_cluster(dkv, dim3((T + kBwdKeys - 1) / kBwdKeys, BH, n), kClThreads, smem_kv, n, s, qt, gt, kr, vr,
                       qm, km, vm, cn, key_mask, fb, fid, gout, mrow, den, delta, dk, dv, dcn, comb, H, T, dh, F, p);
    if (e != cudaSuccess) return (int)e;
  }
  if (emit) return 0;
  CUtensorMap qr, gr, kt, vt;  // the resident Q rows, the streamed g_a rows, K / V tiles
  e = row_map(&qr, qm, BH, T, dh, kClDqRows);
  if (e == cudaSuccess) e = row_map(&gr, gout, BH * A, T, dh, kClDqRows);
  if (e == cudaSuccess) e = row_map(&kt, km, BH, T, dh, kClDqTile);
  if (e == cudaSuccess) e = row_map(&vt, vm, BH, T, dh, kClDqTile);
  if (e != cudaSuccess) return (int)e;
  auto dqk = x ? mm_bwd_dq_cl<A, true> : mm_bwd_dq_cl<A, false>;
  const int tiles = (T + kClDqRows - 1) / kClDqRows;
  const int groups = ((F + kFrameTile - 1) / kFrameTile + n - 1) / n;
  const size_t smem_q = sizeof(float) * dq_cl_floats(A) + 3 * sizeof(uint64_t);
  for (int p = 0; p < passes; ++p) {  // the frame groups in pass 0 (the frame sums' pass) only
    e = launch_cluster(dqk, dim3(tiles * (p == 0 ? groups : 1), BH, n), kClThreads, smem_q, n, s, qr, gr, kt, vt,
                       qm, km, vm, cn, key_mask, fb, fid, gout, mrow, den, delta, dq, dfb_part, H, T, dh, F, p);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
  }
}

}  // namespace

#if !VOG_MM_WG
// dh: at most 128 in the narrow library, past 128 (a multiple of 4, as
// clusters of n blocks; n is read only there) in the cluster library.
// delta: (B,H,A,T) scratch, written here from gout and the forward's out.
// Emit mode: comb (B*H, T, T), fp32 or, in the one-pass library, bf16, not
// null; dq and dfb_part are not touched.
// Recompute mode: comb null; dq (B,H,T,dh) and dfb_part (B, H, ceil(T /
// 64), F, F) are written.
extern "C" int vog_mm_bwd(int device, const float* qm, const float* km, const float* vm,
                          const float* cn, const float* key_mask,
                          const float* fb, const int* fid, const float* gout,
                          const float* out, const float* mrow, const float* den,
                          float* delta, float* dk, float* dv, float* dcn,
                          void* comb_out, float* dq, float* dfb_part, int B, int H,
                          int A, int T, int dh, int F, int n, void* stream) {
  VOG_DEVICE_GUARD(device);
  if (dh < 1 || F < 1 || (dh > 128) != (VOG_MM_CLUSTER != 0) ||
      (dh > 128 && (dh % 4 != 0 || !cluster_fits(dh, n))))
    return (int)cudaErrorInvalidValue;
  DsT* comb = static_cast<DsT*>(comb_out);
  if (comb == nullptr && (dq == nullptr || dfb_part == nullptr)) return (int)cudaErrorInvalidValue;
  if (B * H == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if VOG_MM_CLUSTER
#define VOG_MM_BWD_CASE(a)                                                                                     \
  case a:                                                                                                      \
    return launch_bwd_cl<a>(qm, km, vm, cn, key_mask, fb, fid, gout, out, mrow, den, delta, dk, dv, dcn, comb, \
                            dq, dfb_part, B, H, T, dh, F, n, s);
#else
#define VOG_MM_BWD_CASE(a)                                                                                  \
  case a:                                                                                                   \
    return launch_bwd<a>(qm, km, vm, cn, key_mask, fb, fid, gout, out, mrow, den, delta, dk, dv, dcn, comb, \
                         dq, dfb_part, B, H, T, dh, F, s);
#endif
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

extern "C" int vog_mm_fwd(int device, const float* qm, const float* km, const float* vm,
                          const float* cn, const float* key_mask,
                          const float* fb, const int* fid, float* o,
                          float* mrow, float* den, int B, int H, int A, int T,
                          int dh, int F, int n, void* stream) {
  VOG_DEVICE_GUARD(device);
  // the narrow library takes dh <= 128; the cluster library, dh > 128 (a
  // multiple of 4) as clusters of n blocks (n is read only there)
  if (dh < 1 || F < 1 || (dh > 128) != (VOG_MM_CLUSTER != 0) ||
      (dh > 128 && (dh % 4 != 0 || !cluster_fits(dh, n))))
    return (int)cudaErrorInvalidValue;
  if (B * H == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if VOG_MM_CLUSTER
#define VOG_MM_CASE(a) \
  case a:              \
    return launch_cl<a>(qm, km, vm, cn, key_mask, fb, fid, o, mrow, den, B, H, T, dh, F, n, s);
#else
#define VOG_MM_CASE(a) \
  case a:              \
    return launch<a>(qm, km, vm, cn, key_mask, fb, fid, o, mrow, den, B, H, T, dh, F, s);
#endif
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

// Clusters of n blocks of a cluster kernel at A args resident at once
// (cudaOccupancyMaxActiveClusters): which 0, mm_fwd_cl (A 5 or 7); 1,
// mm_bwd_dkv_cl (recompute); 2, mm_bwd_dq_cl (A 5 or 8); 0 in the narrow
// library
extern "C" int vog_mm_clusters(int device, int A, int n, int which) {
  VOG_DEVICE_GUARD(device);
#if VOG_MM_CLUSTER
  if (which == 0) {
    const size_t smem = sizeof(float) * fwd_cl_floats(A) + 3 * sizeof(uint64_t);
    switch (A) {
      case 5: return max_active_clusters(mm_fwd_cl<5, false>, kFwdThreads, smem, n);
      case 7: return max_active_clusters(mm_fwd_cl<7, false>, kFwdThreads, smem, n);
      default: return -(int)cudaErrorInvalidValue;
    }
  }
  const size_t smem = sizeof(float) * (which == 1 ? dkv_cl_floats(A) : dq_cl_floats(A)) + 3 * sizeof(uint64_t);
  switch (A) {
    case 5:
      return which == 1 ? max_active_clusters(mm_bwd_dkv_cl<5, false, false>, kClThreads, smem, n)
                        : max_active_clusters(mm_bwd_dq_cl<5, false>, kClThreads, smem, n);
    case 8:
      return which == 1 ? max_active_clusters(mm_bwd_dkv_cl<8, false, false>, kClThreads, smem, n)
                        : max_active_clusters(mm_bwd_dq_cl<8, false>, kClThreads, smem, n);
    default: return -(int)cudaErrorInvalidValue;
  }
#else
  return 0;
#endif
}
#else  // VOG_MM_WG
// The one-pass emit backward at dh <= 128 (kernels/mm_attention.py
// §bwd_route).  Scratch written here: delta and inv (B,H,A,T), gr
// (B,H,A,T,dh) and qr (B,H,T,dh); dk, dv (B,H,T,dh), dcn (B,H,A,T) and comb
// (B*H, T, T) bf16 written.  1 <= A <= 8; dh % 4 == 0 and every row matrix
// on 16 bytes (the wrapper pads).
extern "C" int vog_mm_bwd_wg(int device, const float* qm, const float* km, const float* vm, const float* cn,
                             const float* key_mask, const float* fb, const int* fid, const float* gout,
                             const float* out, const float* mrow, const float* den, float* delta, float* gr,
                             float* qr, float* inv, float* dk, float* dv, float* dcn, void* comb, int B, int H,
                             int A, int T, int dh, int F, void* stream) {
  VOG_DEVICE_GUARD(device);
  if (dh < 1 || dh > kDK || dh % 4 != 0 || F < 1 || A < 1 || A > kWgArgs || comb == nullptr ||
      !aligned16(qm) || !aligned16(km) || !aligned16(vm) || !aligned16(gout) || !aligned16(out) ||
      !aligned16(gr) || !aligned16(qr))
    return (int)cudaErrorInvalidValue;
  if (B * H == 0 || T == 0) return 0;
  return launch_bwd_wg(qm, km, vm, cn, key_mask, fb, fid, gout, out, mrow, den, delta, gr, qr, inv, dk, dv, dcn,
                       static_cast<__nv_bfloat16*>(comb), B, H, A, T, dh, F, static_cast<cudaStream_t>(stream));
}

// The one-pass forward at dh <= 128 (kernels/mm_attention.py §fwd_route),
// on args a0 .. a0 + A - 1 of the call's Aall (cn (B,H,Aall,T)).  Scratch
// written here with a0 == 0: kr (B,H,T,dh), km rounded to TF32 (a later
// group reads it); those args of o (B,H,Aall,T,dh), mrow and den
// (B,H,Aall,T) written.  1 <= A <= kFwArgs; dh % 4 == 0 and every row
// matrix on 16 bytes (the wrapper pads).
extern "C" int vog_mm_fwd_wg(int device, const float* qm, const float* km, const float* vm, const float* cn,
                             const float* key_mask, const float* fb, const int* fid, float* kr, float* o,
                             float* mrow, float* den, int B, int H, int A, int T, int dh, int F, int Aall, int a0,
                             void* stream) {
  VOG_DEVICE_GUARD(device);
  if (dh < 1 || dh > kDK || dh % 4 != 0 || F < 1 || A < 1 || A > kFwArgs || a0 < 0 || a0 + A > Aall ||
      !aligned16(qm) || !aligned16(km) || !aligned16(vm) || !aligned16(kr) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  if (B * H == 0 || T == 0) return 0;
  return launch_fwd_wg(qm, km, vm, cn, key_mask, fb, fid, kr, o, mrow, den, B, H, A, T, dh, F, Aall, a0,
                       static_cast<cudaStream_t>(stream));
}
#endif  // VOG_MM_WG
