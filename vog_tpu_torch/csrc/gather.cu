// Row gather from a device-resident feature table: out[i] = table[clamp(rows[i])].
//
// Replaces vog_tpu/kernels/gather.py §gather_rows (_make_kernel), a Pallas
// manual-DMA kernel issuing one HBM->HBM copy per row through an 8-slot
// semaphore ring.  On the H100 the gather is bound by bytes: each
// requested row is read once and written once (GT5 feats rows are 800 x
// 128 bf16 = 200 KB; the serving path gathers 4 to 64 of them a call).
// To reach the memory rate the card needs several MB in flight, and a
// small call must still reach every SM.  Design: the n_req x row_bytes of
// a call are split evenly into pieces of one 16-byte unit a thread, 256 a
// block (4 KB), each row into the same number of pieces: 4 GT5 rows give
// 200 blocks, 64 rows 3,200, so every SM is busy at the smallest serving
// bucket and, at the largest, every resident thread has a load in flight
// (about 4 MB across the card).  Loads and stores carry streaming hints
// (ld.global.nc.L1::no_allocate, st.global.cs): nothing is read twice.
// Variants that kept 2, 4 or 8 independent loads in flight a thread in
// correspondingly fewer blocks, and the bulk copy engine (cp.async.bulk
// global -> shared -> global), measured slower at 64 rows (PERF.md).
// The copy is of bytes, so it is bitwise exact for f32,
// bf16 and int8.  Rows are clamped to [0, N-1] before any offset is
// formed.  A row whose byte width is not a multiple of 16 (or unaligned
// pointers) takes the same split with a byte a thread.

#include <cuda_runtime.h>
#include <stdint.h>
#include "device.cuh"  // DeviceGuard: every entry point runs on its tensors' device

namespace {

constexpr int kThreads = 256;  // units of a piece: one a thread

__device__ inline uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
__device__ inline void store_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}
__device__ inline uint8_t load_stream(const uint8_t* p) { return __ldg(p); }
__device__ inline void store_stream(uint8_t* p, uint8_t v) { *p = v; }

// U: uint4 (16-byte units) or uint8_t (bytes); a row is row_len units,
// block i * pieces + p copies units [p * kThreads, (p + 1) * kThreads) of
// request row i
template <typename U>
__global__ void __launch_bounds__(kThreads)
gather_rows_k(const U* __restrict__ table, const int* __restrict__ rows, U* __restrict__ out,
              long long n_rows, long long row_len, int pieces) {
  const int i = blockIdx.x / pieces, p = blockIdx.x - i * pieces;
  const long long v = (long long)p * kThreads + threadIdx.x;
  if (v >= row_len) return;
  long long r = rows[i];
  r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  store_stream(out + (long long)i * row_len + v, load_stream(table + r * row_len + v));
}

template <typename U>
int launch(const void* table, const int* rows, void* out, long long n_rows, long long row_len,
           long long n_req, cudaStream_t s) {
  const long long pieces = (row_len + kThreads - 1) / kThreads;
  if (n_req * pieces > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gather_rows_k<U><<<(unsigned)(n_req * pieces), kThreads, 0, s>>>(
      static_cast<const U*>(table), rows, static_cast<U*>(out), n_rows, row_len, (int)pieces);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vog_gather_rows(int device, const void* table, const int* rows, void* out,
                               long long n_rows, long long row_bytes,
                               long long n_req, void* stream) {
  VOG_DEVICE_GUARD(device);
  if (n_req == 0 || row_bytes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (row_bytes % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (aligned) return launch<uint4>(table, rows, out, n_rows, row_bytes / 16, n_req, s);
  return launch<uint8_t>(table, rows, out, n_rows, row_bytes, n_req, s);
}
