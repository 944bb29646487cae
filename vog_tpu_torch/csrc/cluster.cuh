// The head dim split over a thread block cluster: the attention kernels'
// one design for head dims past 128 (attention.cu's flash_fwd_cl,
// flash_bwd_dkv_cl and flash_bwd_dq_cl; mm_attention.cu's mm_fwd_cl,
// mm_bwd_dkv_cl and mm_bwd_dq_cl).  It replaced a DK 256 instance of each
// kernel and, past 256, the DK 128 instances' wide path, whose blocks each
// redid a tile's whole score products (2x at DK 256, 8x at dh 1024), the
// wide path's operands read fragment by fragment from L2.
//
//  * A launch for dh > 128 has ceil(dh / 128) column slices.  Up to
//    kMaxCluster (8, the portable cluster size) of them are the blocks of
//    one cluster along grid.z: block cluster.block_rank() = z owns columns
//    [128z, 128z + 128) of the row matrices (Q, K, V, dO), stages only
//    those, and accumulates only those columns of the outputs.  Past 8
//    slices (dh > 1024) a block owns several slices, z + n p for passes p:
//    the C entry launches once a pass, and in pass p block z stages and
//    accumulates slice z + n p, and adds its other slices' score partials
//    read from device memory (add_other_slices), so that the cluster's sum
//    is still over every column.  A non-portable cluster of 16 would take
//    only dh <= 2048 and needs 16 SMs of one GPC at one block an SM.  The
//    cluster's size n is the caller's: kernels/_cluster.py §cluster_plan
//    decides it (ceil(slices / passes), passes = ceil(slices / 8)), and the
//    C entries take any 1 <= n <= min(8, slices) and launch passes_of(dh,
//    n) passes.
//  * The scores.  Per tile, each block computes its partial S_z = Q_z K_z^T
//    (and dP_z = dO_z V_z^T in the backward) over its 128 columns, stores it
//    to its own shared memory in fragment order (§put_partial), and after a
//    cluster barrier every block reads the n
//    partials through distributed shared memory (map_shared_rank) and adds
//    them in rank order 0..n-1: every block holds the same bits, and a
//    repeated call gives the same bits (no atomics).  The kernels of 8
//    warps (flash_fwd_cl and the mm backward's) split a block's slice once
//    more: warp w takes 16 rows (rg = w % 4) and the 64 columns of half w /
//    4 of the slice, and its partial over those 64 columns is added to its
//    pair's in the block before the cluster's sum (§sum_halves); it
//    accumulates only its half's output columns, so its accumulators are
//    half a narrow warp's (the narrow flash_fwd and mm backward instances
//    spill at 4 warps of 128 columns).  A block's partial is
//    single-buffered: after reading its peers' partials a block arrives on
//    the cluster barrier without waiting (cluster_arrive), and waits on it
//    only before it stores its next tile's partial, so no block overwrites
//    a partial that a peer still reads, and the wait hides behind the
//    tile's accumulating products.  Each block's last act is that wait:
//    none exits while a peer may read its shared memory.
//  * The streamed tiles (and the resident rows) come in by TMA
//    (cp.async.bulk.tensor, one thread issuing, completion on an mbarrier
//    a stage, a two-stage ring).  A matrix's tensor map is 3-D, (dh, T,
//    B*H) with boxes of `rows` x kSliceLd columns, so the box of slice z
//    lands as the rows of a shared tile of row stride 132 floats, the
//    stride the fragment reads of tiles.cuh are conflict-free at (its 4
//    extra columns, the next slice's or zeros past dh, are never read):
//    rows past T and columns past dh arrive as zeros.  TMA needs
//    16-byte-aligned rows: the wrappers pad a dh that is not a multiple
//    of 4 with zero columns (no score and no kept output column changes),
//    and the C entries refuse such a dh.  The maps are built on the host
//    by cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint
//    (no link against libcuda), and passed as __grid_constant__ kernel
//    parameters.
//  * Products: mma.sync m16n8k8 in 3xTF32 (or one pass) through tiles.cuh,
//    as the narrow instances.  The score products' operands are K-major and
//    could run as wgmma, but P.V, dS.K and P^T.dO read an MN-major operand,
//    which wgmma does not take in tf32; the split operands of "highest"
//    would also need two shared copies of each.  The one design keeps the
//    narrow instances' fragment code, and what this file adds is the
//    cluster, its barriers and the copies.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (types only: no link against libcuda)
#include <cuda_runtime.h>
#include <stdint.h>
#include <map>
#include <mutex>
#include <utility>  // std::forward, std::pair

#include "hopper.cuh"  // mbarriers (init, expected bytes, wait)
#include "tiles.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kSlice = 128;                     // columns a block stages and accumulates
constexpr int kSliceLd = HeadDim<128>::kLd;     // their shared row stride, the TMA box's width
constexpr int kMaxCluster = 8;                  // the portable cluster size
constexpr int kHalf = kSlice / 2;               // columns of a slice's half (the 8-warp kernels)
constexpr int kRowGroups = 4;                   // warps a half: 16 rows each (the 8-warp kernels)
static_assert(kSliceLd * 4 % 16 == 0, "a TMA box row is a whole number of 16 bytes");

// A head dim's 128-column slices, and the passes (launches) that a cluster
// of n blocks takes over them: block z of pass p owns slice z + n p
__host__ __device__ inline int slices_of(int dh) { return (dh + kSlice - 1) / kSlice; }
__host__ __device__ inline int passes_of(int dh, int n) { return (slices_of(dh) + n - 1) / n; }
// whether n blocks a cluster is a split of dh that the kernels take
inline bool cluster_fits(int dh, int n) { return n >= 1 && n <= kMaxCluster && n <= slices_of(dh); }

// A block's slice: without other slices (kX false, one pass) its rank z,
// else z + n pass (n = gridDim.z, the cluster's size: grid.z is one cluster)
template <bool kX>
__device__ inline int slice_of(int z, int pass) { return kX ? z + (int)gridDim.z * pass : z; }
// whether slice zs lies below dh's slices (always, without other slices)
template <bool kX>
__device__ inline bool owns(int zs, int dh) { return !kX || zs < slices_of(dh); }

// Bytes of a TMA box of `rows` rows
__host__ __device__ constexpr uint32_t box_bytes(int rows) { return (uint32_t)rows * kSliceLd * 4; }

// -- the cluster barrier, split in its two halves --------------------------
__device__ inline void cluster_arrive() { asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory"); }
__device__ inline void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

// -- TMA (its mbarriers: hopper.cuh) -----------------------------------------
// the box at (column c0, row r0, matrix bh) of `map` into dst, completing on bar
__device__ inline void tma_load(float* dst, const CUtensorMap* map, int c0, int r0, int bh, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(bh), "r"(smem_addr(bar))
      : "memory");
}

// -- the partials ----------------------------------------------------------
// A partial buffer holds, for each warp slot w, its lanes' NF C fragments,
// fragment j of lane l at float4 (w NF + j) 32 + l: a warp's store, and a
// peer's read of a slot through distributed shared memory, is 512
// contiguous bytes a fragment.  With a lane's NF float4 together (16 NF
// bytes apart a lane), and every warp reading 2n partials (the halves not
// added in the block first, §sum_halves), the 8-warp kernels took 1.1-4.5x
// as long (PERF.md, section 6).

// Store a lane's NF C fragments (4 floats each) at its place of slot `warp`
// of a partial buffer
template <int NF>
__device__ inline void put_partial(float* buf, const float (*c)[4], int warp, int lane) {
  float4* p = reinterpret_cast<float4*>(buf) + warp * NF * 32 + lane;
#pragma unroll
  for (int j = 0; j < NF; ++j) p[32 * j] = make_float4(c[j][0], c[j][1], c[j][2], c[j][3]);
}
// c += slot `warp` of a partial buffer in this block's shared memory
template <int NF>
__device__ inline void add_partial(float (*c)[4], const float* buf, int warp, int lane) {
  const float4* p = reinterpret_cast<const float4*>(buf) + warp * NF * 32 + lane;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const float4 v = p[32 * j];
    c[j][0] += v.x, c[j][1] += v.y, c[j][2] += v.z, c[j][3] += v.w;
  }
}
// c = the sum, in rank order 0..n-1, of the cluster's partials at this
// lane's place of slot `warp` (the same bits in every block of the cluster)
template <int NF>
__device__ inline void sum_partials(float (*c)[4], float* buf, int warp, int lane) {
  cg::cluster_group cl = cg::this_cluster();
  const int n = (int)gridDim.z;  // the cluster's blocks
#pragma unroll 1
  for (int r = 0; r < n; ++r) {
    const float4* p = reinterpret_cast<const float4*>(cl.map_shared_rank(buf, r)) + warp * NF * 32 + lane;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const float4 v = p[32 * j];
      if (r == 0) {
        c[j][0] = v.x, c[j][1] = v.y, c[j][2] = v.z, c[j][3] = v.w;
      } else {
        c[j][0] += v.x, c[j][1] += v.y, c[j][2] += v.z, c[j][3] += v.w;
      }
    }
  }
}

// One round of the 8-warp kernels: c, the warp's partial over its half's
// 64 columns, becomes the sum over the cluster of its rows' partials.  The
// two halves are added in the block first (half 0 + half 1, into slot rg
// of `sums`), so a peer reads n slots of a row group, not 2n: every warp
// then adds the n blocks' sums in rank order (the same bits in every warp
// of the rows, in every block).  `halves` (kRowGroups x 2 slots) is read
// only in the block; `sums` (kRowGroups slots) by the peers, and `peers`
// says whether a round before this one left sums that a peer may still
// read: the block waits on that round's split barrier before overwriting
// them.  Every thread of the block calls it (one block barrier and two
// cluster barriers, the second split).
template <int NF>
__device__ inline void sum_halves(float (*c)[4], float* halves, float* sums, int warp, int lane, bool& peers) {
  const int rg = warp % kRowGroups;
  put_partial<NF>(halves, c, warp, lane);
  if (peers) cluster_wait();  // every peer has read this block's sums of the round before
  __syncthreads();            // both halves of every row group are in
  if (warp < kRowGroups) {
    add_partial<NF>(c, halves, warp + kRowGroups, lane);
    put_partial<NF>(sums, c, rg, lane);
  }
  cluster_arrive();
  cluster_wait();  // every block's sums are in
  sum_partials<NF>(c, sums, rg, lane);
  cluster_arrive();  // this block is done with its peers' sums
  peers = true;
}

// The score partials of a block's other slices (passes > 1): c += X Y^T
// over columns [c0, c0 + cw) of each slice z + n p' (p' != pass, below
// slices; the 8-warp kernels: the warp's half of each), read
// from device memory through the read-only cache (rows x0 + g, x0 + g + 8
// of X, y0 + 8j + g of Y; zero past T and dh), a k-step at a time, in
// slice order: the fewest registers beside the block's accumulators, at
// the price of L2 latency, on a path that runs only past dh 1024
template <int NT>
__device__ inline void add_other_slices(float (&c)[NT][4], const float* __restrict__ X,
                                        const float* __restrict__ Y, int x0, int y0, int T, int dh, int z,
                                        int pass, int g, int t, int c0 = 0, int cw = kSlice) {
  const int n = (int)gridDim.z, slices = slices_of(dh), passes = passes_of(dh, n);
  const int xa = x0 + g, xb = xa + 8;
  const bool oka = xa < T, okb = xb < T;
  const float* pa = X + (size_t)(oka ? xa : 0) * dh;
  const float* pb = X + (size_t)(okb ? xb : 0) * dh;
#pragma unroll 1
  for (int p = 0; p < passes; ++p) {
    const int zs = z + n * p;
    if (p == pass || zs >= slices) continue;
    const int kend = min(kSlice * zs + c0 + cw, dh);
#pragma unroll 1
    for (int k = kSlice * zs + c0; k < kend; k += 8) {
      const int ka = k + t, kb = ka + 4;
      const bool ca = ka < kend, cb = kb < kend;
      uint32_t ab[4], as[4];
      split<kOnePass>(ldg0(pa + ka, oka && ca), ab[0], as[0]);
      split<kOnePass>(ldg0(pb + ka, okb && ca), ab[1], as[1]);
      split<kOnePass>(ldg0(pa + kb, oka && cb), ab[2], as[2]);
      split<kOnePass>(ldg0(pb + kb, okb && cb), ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int y = y0 + 8 * j + g;
        const bool oky = y < T;
        const float* py = Y + (size_t)(oky ? y : 0) * dh;
        uint32_t bb[2], bs[2];
        split<kOnePass>(ldg0(py + ka, oky && ca), bb[0], bs[0]);
        split<kOnePass>(ldg0(py + kb, oky && cb), bb[1], bs[1]);
        mma_p<kOnePass>(c[j], ab, as, bb, bs);
      }
    }
  }
}

// -- the host side ---------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The map of a (BH, T, dh) fp32 tensor at `base` (dh % 4 == 0, 16-byte
// aligned) in boxes of `rows` rows x kSliceLd columns; zeros past T and dh
inline cudaError_t row_map(CUtensorMap* map, const float* base, int BH, int T, int dh, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  if (dh % 4 != 0 || !aligned16(base)) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * 4, (cuuint64_t)T * dh * 4};
  const cuuint32_t box[3] = {(cuuint32_t)kSliceLd, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims, strides, box,
                         step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The launch configuration of a grid of clusters of (1, 1, n) blocks
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(dim3 grid, int threads, size_t smem, int n, cudaStream_t s) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = n;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Let `kernel` take `smem` bytes of dynamic shared memory on the current
// device: cudaFuncSetAttribute once a kernel, device and size, not at
// every launch (a host call of a few microseconds, five a backward)
inline cudaError_t allow_smem(const void* kernel, size_t smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> allowed;
  const std::lock_guard<std::mutex> lock(mu);
  size_t& have = allowed[{kernel, dev}];
  if (have >= smem) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) have = smem;
  return e;
}

// Launch `kernel` on `grid` as clusters of (1, 1, n) blocks
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int threads, size_t smem, int n, cudaStream_t s,
                           Args&&... args) {
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return e;
  const ClusterLaunch l(grid, threads, smem, n, s);
  e = cudaLaunchKernelEx(&l.cfg, kernel, std::forward<Args>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// How many clusters of (1, 1, n) blocks of `kernel` can be resident at once
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error
template <typename... Params>
int max_active_clusters(void (*kernel)(Params...), int threads, size_t smem, int n) {
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return -(int)e;
  const ClusterLaunch l(dim3(1, 1, n), threads, smem, n, nullptr);
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(&count, kernel, &l.cfg);
  return e == cudaSuccess ? count : -(int)e;
}

}  // namespace
