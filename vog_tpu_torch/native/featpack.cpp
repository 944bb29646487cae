// featpack: mmap-backed packed feature store with a multithreaded gather
// (the port's copy of vog_tpu/native/featpack.cpp).
//
// Features live in one flat little-endian float32 file, mapped read-only;
// a batch's fetch is N memcpy's from the page cache spread over threads,
// with the GIL released (called through ctypes by
// vog_tpu_torch/data/featpack.py).  Built with g++ at first use into
// vog_tpu_torch/build/ (vog_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Pack {
  int fd = -1;
  const uint8_t* base = nullptr;
  uint64_t size = 0;
};

}  // namespace

extern "C" {

// Open a pack file; returns an opaque handle (nullptr on failure).
void* fp_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* base = ::mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  ::madvise(base, st.st_size, MADV_WILLNEED);
  auto* p = new Pack;
  p->fd = fd;
  p->base = static_cast<const uint8_t*>(base);
  p->size = static_cast<uint64_t>(st.st_size);
  return p;
}

void fp_close(void* handle) {
  if (!handle) return;
  auto* p = static_cast<Pack*>(handle);
  if (p->base) ::munmap(const_cast<uint8_t*>(p->base), p->size);
  if (p->fd >= 0) ::close(p->fd);
  delete p;
}

uint64_t fp_size(void* handle) {
  return handle ? static_cast<Pack*>(handle)->size : 0;
}

// Copy n regions (src_offsets[i], nbytes[i]) from the pack into
// dst + dst_offsets[i], using up to nthreads worker threads.
// Returns 0 on success, -1 on a bounds error.
int fp_gather(void* handle, const uint64_t* src_offsets,
              const uint64_t* nbytes, const uint64_t* dst_offsets,
              uint8_t* dst, int64_t n, int nthreads) {
  if (!handle) return -1;
  auto* p = static_cast<Pack*>(handle);
  for (int64_t i = 0; i < n; ++i) {
    if (src_offsets[i] + nbytes[i] > p->size) return -1;
  }
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = static_cast<int>(n);

  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(dst + dst_offsets[i], p->base + src_offsets[i], nbytes[i]);
    }
  };
  if (nthreads == 1) {
    worker(0, n);
    return 0;
  }
  std::vector<std::thread> ts;
  ts.reserve(nthreads);
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    ts.emplace_back(worker, lo, hi);
  }
  for (auto& t : ts) t.join();
  return 0;
}

}  // extern "C"
