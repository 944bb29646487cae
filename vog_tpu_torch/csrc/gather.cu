// Row gather from a device-resident feature table: out[i] = table[clamp(rows[i])].
//
// Replaces vog_tpu/kernels/gather.py §gather_rows (_make_kernel), a Pallas
// manual-DMA kernel issuing one HBM->HBM copy per row through an 8-slot
// semaphore ring.  On the H100 the gather is bound by bytes: each
// requested row is read once and written once (GT5 feats rows are
// 800x128 bf16 = 200 KB).  Design: the row is split into 64 KB chunks, one
// block per (row, chunk), so a batch of 64 rows fills the card with ~256
// blocks; each thread moves 16-byte vectors with neighbouring threads on
// neighbouring addresses.  The copy is dtype-agnostic (bytes), so it is
// bitwise exact for f32, bf16 and int8.  Rows are clamped to [0, N-1]
// before any offset is formed.  Rows whose byte width is not a multiple of
// 16 take a byte loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunkBytes = 64 * 1024;

__global__ void gather_vec16(const uint4* __restrict__ table,
                             const int* __restrict__ rows,
                             uint4* __restrict__ out, long long n_rows,
                             long long row_vecs, long long chunk_vecs) {
  const long long i = blockIdx.x;
  long long r = rows[i];
  r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  const uint4* src = table + r * row_vecs;
  uint4* dst = out + i * row_vecs;
  const long long lo = (long long)blockIdx.y * chunk_vecs;
  long long hi = lo + chunk_vecs;
  if (hi > row_vecs) hi = row_vecs;
  for (long long v = lo + threadIdx.x; v < hi; v += kThreads) dst[v] = src[v];
}

__global__ void gather_bytes(const uint8_t* __restrict__ table,
                             const int* __restrict__ rows,
                             uint8_t* __restrict__ out, long long n_rows,
                             long long row_bytes, long long chunk_bytes) {
  const long long i = blockIdx.x;
  long long r = rows[i];
  r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  const uint8_t* src = table + r * row_bytes;
  uint8_t* dst = out + i * row_bytes;
  const long long lo = (long long)blockIdx.y * chunk_bytes;
  long long hi = lo + chunk_bytes;
  if (hi > row_bytes) hi = row_bytes;
  for (long long b = lo + threadIdx.x; b < hi; b += kThreads) dst[b] = src[b];
}

}  // namespace

extern "C" int vog_gather_rows(const void* table, const int* rows, void* out,
                               long long n_rows, long long row_bytes,
                               long long n_req, void* stream) {
  if (n_req == 0 || row_bytes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long chunks = (row_bytes + kChunkBytes - 1) / kChunkBytes;
  dim3 grid((unsigned)n_req, (unsigned)chunks);
  const bool aligned = (row_bytes % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (aligned) {
    gather_vec16<<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(table), rows, static_cast<uint4*>(out),
        n_rows, row_bytes / 16, kChunkBytes / 16);
  } else {
    gather_bytes<<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(table), rows, static_cast<uint8_t*>(out),
        n_rows, row_bytes, kChunkBytes);
  }
  return (int)cudaGetLastError();
}
