// Two rates of the H100 that shape the head backward's kernels
// (csrc/grounding_head.cu), measured with no other work on the card:
//  (1) cp.async.bulk copies into a ring of shared memory, one block an SM,
//      by one to four issuing warps (each its own ring, each copy waited on
//      its own mbarrier): bytes a clock an SM and clocks a stage;
//  (2) TF32 wgmma m64nNk8 back to back into one accumulator, 4 a commit
//      group, one group left in flight, by one or two warpgroups: clocks a
//      wgmma and multiply-adds a clock an SM.
// Build and run on the card:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o hopper_rates tools/hopper_rates.cu && ./hopper_rates
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

__device__ inline uint32_t sa(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }
__device__ inline void mbar_init(uint64_t* b, int c) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(sa(b)), "r"(c));
}
__device__ inline void mbar_wait(uint64_t* b, uint32_t ph) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{.reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0,1,0,p;}"
                 : "=r"(done) : "r"(sa(b)), "r"(ph) : "memory");
}
__device__ inline void bulk(void* d, const void* s, uint32_t n, uint64_t* b) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(sa(b)), "r"(n) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(sa(d)), "l"(s), "r"(n), "r"(sa(b)) : "memory");
}

// (1): warp w < warps streams `stages` copies of `bytes` from a 3 MB source into its ring of `ring`
__global__ void copies(const char* src, int stages, int ring, int bytes, int warps, unsigned long long* cyc) {
  extern __shared__ __align__(1024) unsigned char smb[];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* sm = smb + w * ring * bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smb + warps * ring * bytes) + w * ring;
  if (lane == 0 && w < warps) {
    for (int r = 0; r < ring; ++r) mbar_init(full + r, 1);
    asm volatile("fence.mbarrier_init.release.cluster;");
  }
  __syncthreads();
  const unsigned long long t0 = clock64();
  const int nsrc = (3 << 20) / bytes;
  if (w < warps && lane == 0) {
    for (int q = 0; q < stages; ++q) {
      if (q >= ring) mbar_wait(full + q % ring, ((q / ring) - 1) & 1);
      bulk(sm + (q % ring) * bytes, src + (size_t)(q % nsrc) * bytes, bytes, full + q % ring);
    }
    for (int q = stages; q < stages + ring; ++q) mbar_wait(full + q % ring, ((q / ring) - 1) & 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) cyc[blockIdx.x] = clock64() - t0;
}

__device__ inline uint64_t desc(const void* p) {  // K-major, no swizzle: k halves 1 KB apart, 8-row groups 128 B
  return (uint64_t)((sa(p) & 0x3ffff) >> 4) | (uint64_t)(1024 >> 4) << 16 | (uint64_t)(128 >> 4) << 32;
}
#define R8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
              "+f"(d[i + 6]), "+f"(d[i + 7])
__device__ inline void n64(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile("{.reg .pred p; setp.ne.b32 p, %34, 0; wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
               "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,"
               "%27,%28,%29,%30,%31}, %32, %33, p, 1, 1;}"
               : R8(0), R8(8), R8(16), R8(24) : "l"(a), "l"(b), "r"(1) : "memory");
}
__device__ inline void n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile("{.reg .pred p; setp.ne.b32 p, %66, 0; wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
               "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,"
               "%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,"
               "%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, %64, %65, p, 1, 1;}"
               : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56) : "l"(a), "l"(b), "r"(1) : "memory");
}

// (2): warpgroup w < wgs issues 4 x iters wgmmas of width N (64 or 128), A and B from shared memory
__global__ void __launch_bounds__(256, 1) products(int N, int iters, int wgs, unsigned long long* cyc, float* sink) {
  extern __shared__ __align__(1024) float sm[];
  const int wg = threadIdx.x / 128;
  for (int i = threadIdx.x; i < 32768; i += blockDim.x) sm[i] = 0.001f * (i & 7);
  __syncthreads();
  if (wg >= wgs) return;
  const float* a = sm + wg * 16384;
  const float* b = a + 8192;
  float d[64];
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  const unsigned long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (N == 64) n64(d, desc(a + kk * 512), desc(b + kk * 512));
      else n128(d, desc(a + kk * 512), desc(b + kk * 512));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  const unsigned long long t = clock64() - t0;
  float s = 0.f;
  for (int i = 0; i < 64; ++i) s += d[i];
  if (threadIdx.x % 128 == 0) cyc[blockIdx.x * 2 + wg] = t;
  if (s == 12345.f) sink[0] = s;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  char* src;
  unsigned long long* cyc;
  float* sink;
  cudaMalloc(&src, 3 << 20);
  cudaMemset(src, 0, 3 << 20);
  cudaMallocManaged(&cyc, 2 * sms * sizeof(unsigned long long));
  cudaMalloc(&sink, 4);
  const struct { int warps, ring, bytes; } cs[] = {{1, 5, 8192}, {1, 10, 8192}, {1, 4, 16384}, {1, 4, 32768},
                                                   {2, 5, 8192}, {4, 5, 8192}, {4, 2, 16384}};
  for (const auto& c : cs) {
    const int stages = 1000, smem = c.warps * (c.ring * c.bytes + 8 * c.ring);
    cudaFuncSetAttribute(copies, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    for (int rep = 0; rep < 2; ++rep) {
      copies<<<sms, 128, smem>>>(src, stages, c.ring, c.bytes, c.warps, cyc);
      cudaDeviceSynchronize();
    }
    double m = 0;
    for (int i = 0; i < sms; ++i) m += cyc[i];
    m /= sms;
    printf("(1) bulk copies: %d issuing warp(s), rings of %d x %d B: %.1f B a clock an SM, %.0f clocks a stage (%s)\n",
           c.warps, c.ring, c.bytes, (double)stages * c.bytes * c.warps / m, m / stages,
           cudaGetErrorString(cudaGetLastError()));
  }
  cudaFuncSetAttribute(products, cudaFuncAttributeMaxDynamicSharedMemorySize, 131072);
  for (int N : {64, 128})
    for (int wgs = 1; wgs <= 2; ++wgs) {
      const int iters = 2000;
      for (int rep = 0; rep < 2; ++rep) {
        products<<<sms, 256, 131072>>>(N, iters, wgs, cyc, sink);
        cudaDeviceSynchronize();
      }
      double c = 0;
      for (int i = 0; i < sms; ++i) c += cyc[2 * i];
      c /= sms;
      const double per = c / (4.0 * iters);
      printf("(2) TF32 wgmma m64n%dk8, %d warpgroup(s): %.1f clocks a wgmma, %.0f multiply-adds a clock an SM (%s)\n",
             N, wgs, per, 64.0 * N * 8 * wgs / per, cudaGetErrorString(cudaGetLastError()));
    }
  return 0;
}
