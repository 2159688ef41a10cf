// How fast one SM fills a ring of W stages in shared memory with bulk
// copies (cp.async.bulk on mbarriers, the recurrent kernels' streamed
// route, csrc/recur_chain.cuh), by cluster size, chunk size, ring depth,
// source region (L2-resident or not) and producer: a dedicated producer
// warp (0) against the copies taken in turn by the consuming warps (1,
// ring_turn, as the kernels do). 32 CTAs of 8 consuming warps; the
// consumers do no work. Prints ns a chunk and GB/s an SM (CTA 0's
// globaltimer). Standalone, for the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -DCTA_DST \
//       -o ring_copy_probe twotowermlretrieval_tpu_torch/tools/ring_copy_probe.cu
//   ./ring_copy_probe
//
// (-DCTA_DST adds the shared::cta destination of the copy beside the
// shared::cluster one the kernels use.)
#include <cstdio>
#include <cuda_runtime.h>
#include "../csrc/recur_chain.cuh"
using namespace recur_chain;

struct Args { const unsigned char* src; size_t region; int chunk, S, iters; int* sink; long long* out; };
__device__ __forceinline__ long long gtime() { long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }

#ifdef CTA_DST
__device__ __forceinline__ void copy_cta(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cta.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
      "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
#endif

// P 0: dedicated producer warp 8; P 1: round-robin (ring_turn) over warps 0-7
template <int P, bool CTA>
__global__ void __launch_bounds__(288, 1) ring(Args a) {
  extern __shared__ __align__(16) unsigned char sm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + (size_t)a.S * a.chunk);
  uint64_t* empty = full + a.S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned char* src = a.src + (size_t)blockIdx.x * a.region;
  const int per = (int)(a.region / a.chunk);
  int acc = 0;
  if (tid == 0) {
    for (int i = 0; i < a.S; ++i) { mbar_init(full + i, 1); mbar_init(empty + i, 8); }
    mbar_init_fence();
  }
  __syncthreads();
  auto copy = [&](int x, int st, uint64_t* bar) {
    mbar_arrive_expect_tx(bar, a.chunk);
#ifdef CTA_DST
    if (CTA) { copy_cta(sm + (size_t)st * a.chunk, src + (size_t)(x % per) * a.chunk, a.chunk, bar); return; }
#endif
    bulk_copy(sm + (size_t)st * a.chunk, src + (size_t)(x % per) * a.chunk, a.chunk, bar);
  };
  long long c0 = clock64(), t0 = gtime();
  if (P == 0 && warp == 8) {
    if (lane == 0)
      for (int x = 0; x < a.iters; ++x) {
        if (x >= a.S) mbar_wait(empty + x % a.S, ((x / a.S) + 1) & 1);
        copy(x, x % a.S, full + x % a.S);
      }
    return;
  }
  if (warp >= 8) return;
  if (P == 1 && tid == 0) for (int x = 0; x < a.S - 1; ++x) copy(x, x, full + x);
  for (int g = 0; g < a.iters; ++g) {
    if (P == 1) ring_turn(g, a.S, a.iters, 8, full, empty, copy);
    mbar_wait(full + g % a.S, (g / a.S) & 1);
    acc += sm[(size_t)(g % a.S) * a.chunk + lane * 16];
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + g % a.S);
  }
  if (blockIdx.x == 0 && tid == 0) { a.out[0] = clock64() - c0; a.out[1] = gtime() - t0; }
  if (acc == 12345) a.sink[0] = acc;
}

int main() {
  const size_t total = (size_t)132 * (2 << 20);
  unsigned char* buf; int* sink; long long* out;
  cudaMalloc(&buf, total); cudaMemset(buf, 1, total); cudaMalloc(&sink, 4); cudaMalloc(&out, 16);
  printf("producer cta_dst cluster nb chunk_kb S region_kb ns_per_chunk gb_s_per_sm\n");
  for (int rep = 0; rep < 2; ++rep)
  for (int p = 0; p < 2; ++p)
  for (int cta = 0; cta < 2; ++cta)
  for (int cl : {1, 8, 16})
  for (int chunk : {16384, 49152, 98304})
  for (int S : {2, 3})
  for (size_t region : {(size_t)256 << 10, (size_t)1200 << 10}) {
#ifndef CTA_DST
    if (cta) continue;
#endif
    if ((size_t)S * chunk + 16 * S > 227 * 1024) continue;
    const int nb = 32;
    Args a = {buf, region / chunk * chunk, chunk, S, 4000, sink, out};
    int smem = S * chunk + 16 * S;
    void (*k)(Args) = p == 0 ? (cta ? ring<0, true> : ring<0, false>) : (cta ? ring<1, true> : ring<1, false>);
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nb, 1, 1); cfg.blockDim = dim3(288, 1, 1); cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl; attr[0].val.clusterDim.y = 1; attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr; cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, k, a);
    if (err == cudaSuccess) err = cudaDeviceSynchronize();
    if (err != cudaSuccess) { printf("error %s\n", cudaGetErrorString(err)); return 1; }
    long long h[2]; cudaMemcpy(h, out, 16, cudaMemcpyDeviceToHost);
    double ns = (double)h[1] / a.iters;
    if (rep == 1) printf("%d %d %d %d %d %d %zu %.1f %.1f\n", p, cta, cl, nb, chunk >> 10, S, region >> 10, ns, chunk / ns);
  }
  return 0;
}
