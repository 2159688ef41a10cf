// Device helpers shared by the two recurrent kernels (rnn_fwd.cu and
// rnn_bwd.cu): the cell codes and gate counts, the conversions between the
// compute dtype and f32, thin wrappers of the PTX both chains are built
// from (cp.async, ldmatrix, mma.sync m16n8k16 bf16 with f32 accumulation,
// the cluster barrier's halves), the ring both stream W through where it
// does not fit (mbarriers, bulk copies, the turns in which the warps
// copy), and the split products that carry every product at f32 compute
// (split_bf16x3, mma_split, the f32 fragments). attention.cu and
// doc_mma.cuh take the PTX wrappers and the split too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace recur_chain {

enum Cell { kRNN = 0, kGRU = 1, kLSTM = 2 };

template <int CELL> struct NumGates;
template <> struct NumGates<kRNN> { static constexpr int G = 1; };
template <> struct NumGates<kGRU> { static constexpr int G = 3; };
template <> struct NumGates<kLSTM> { static constexpr int G = 4; };

constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory one block may use

__host__ __device__ constexpr size_t a16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// a hint that the 128-byte line at p is read soon: into L2 now
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}
// a copy of `width` = 16, 8 or 4 bytes (the same across the block)
__device__ __forceinline__ void cp_async_n(void* smem_dst, const void* gmem_src, int width) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  if (width == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
  else if (width == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem_src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src));
}
// the widest copy (16, 8 or 4 bytes) dividing `bits`, the byte offsets or-ed together
__device__ __forceinline__ int copy_width(int bits) {
  return bits % 16 == 0 ? 16 : bits % 8 == 0 ? 8 : 4;
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a . b, one m16n8k16 tile: bf16 operands, f32 accumulation
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ldmatrix x4 (and .trans) at a shared-memory address (a 32-bit offset in
// the shared window), for callers that work their addresses out as such
__device__ __forceinline__ void ldsm_x4_at(uint32_t* r, unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t_at(uint32_t* r, unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  ldsm_x4_at(r, static_cast<unsigned>(__cvta_generic_to_shared(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  ldsm_x4_t_at(r, static_cast<unsigned>(__cvta_generic_to_shared(p)));
}
// two 8x8 matrices (the addresses of lanes 0-15), transposed
__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// ---------------------------------------------------------------------------
// Split products: an f32-precision product on the bf16 tensor cores
// ---------------------------------------------------------------------------
// Every f32 value x splits exactly into three bf16 pieces, x = hi + mid +
// lo: hi = bf16(x), mid = bf16(x - hi), lo = x - hi - mid, each rounded to
// nearest even (8 significant bits each and the signs of the remainders
// cover f32's 24; bf16 has f32's exponent range). A product takes the six
// leading products of the pieces, mid.mid, lo.hi, hi.lo, mid.hi, hi.mid,
// hi.hi, smallest first (XLA's six-pass HIGHEST; utils/dtypes.py
// SPLIT_PRODUCTS), each one mma.sync m16n8k16 with f32 accumulation, and
// drops mid.lo, lo.mid and lo.lo: each entry is within 2^-23 (1 + 2^-7)
// sum_k |a_k b_k| of the exact product, plus its f32 sums' rounding
// (doc_mma.cuh, "The f32 path", gives the bound).
constexpr int PIECES = 3;

// The split of two f32 values x (low half) and y (high half) into three
// bf16 pairs, p[0] = hi, p[1] = mid, p[2] = lo: each piece is what the
// pieces before it leave, rounded to nearest even (the remainders are
// exact in f32), so hi + mid + lo is x (and y) exactly.
__device__ __forceinline__ void split_bf16x3(float x, float y, uint32_t (&p)[PIECES]) {
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);  // .x the low half
    p[i] = (uint32_t)__bfloat16_as_ushort(v.x) | ((uint32_t)__bfloat16_as_ushort(v.y) << 16);
    x -= __uint_as_float(p[i] << 16);
    y -= __uint_as_float(p[i] & 0xffff0000u);
  }
}

// the pieces of (x, y) into register j of each piece's fragment
template <int N>
__device__ __forceinline__ void split_into(float x, float y, uint32_t (&f)[PIECES][N], int j) {
  uint32_t p[PIECES];
  split_bf16x3(x, y, p);
#pragma unroll
  for (int i = 0; i < PIECES; ++i) f[i][j] = p[i];
}

// The six products of a split product, (A piece, B piece) with 0 = hi,
// 1 = mid, 2 = lo, smallest first: mid.mid, lo.hi, hi.lo, mid.hi, hi.mid,
// hi.hi
__host__ __device__ constexpr int split_a(int s) { return s == 0 || s == 3 ? 1 : s == 1 ? 2 : 0; }
__host__ __device__ constexpr int split_b(int s) { return s == 0 || s == 4 ? 1 : s == 2 ? 2 : 0; }

// d += a . b as a split product: one m16n8k16 tile, each operand's
// fragment in its three pieces
__device__ __forceinline__ void mma_split(float* d, const uint32_t (&a)[PIECES][4],
                                          const uint32_t (&b)[PIECES][2]) {
#pragma unroll
  for (int s = 0; s < 6; ++s)
    mma_bf16(d, a[split_a(s)][0], a[split_a(s)][1], a[split_a(s)][2], a[split_a(s)][3],
             b[split_b(s)][0], b[split_b(s)][1]);
}

// The A fragment (16 rows x k16, row-major) of f32 rows in shared memory,
// split: row r's k = 0 at a + r * ld (ld even, a 8-byte aligned). Lane
// (g, t) holds rows g and g + 8 at k = 2t, 2t + 1 and 2t + 8, 2t + 9.
// Where `half`, the tile has 8 rows: rows 8-15 are zeros, never read.
__device__ __forceinline__ void a_frag_f32(const float* a, int ld, bool half,
                                           uint32_t (&f)[PIECES][4]) {
  const int lane = threadIdx.x & 31;
  const float* r = a + (size_t)(lane >> 2) * ld + 2 * (lane & 3);
  const float2 x0 = *reinterpret_cast<const float2*>(r);
  const float2 x2 = *reinterpret_cast<const float2*>(r + 8);
  split_into(x0.x, x0.y, f, 0);
  split_into(x2.x, x2.y, f, 2);
  if (half) {
#pragma unroll
    for (int i = 0; i < PIECES; ++i) f[i][1] = f[i][3] = 0u;
  } else {
    const float2 x1 = *reinterpret_cast<const float2*>(r + 8 * ld);
    const float2 x3 = *reinterpret_cast<const float2*>(r + 8 * ld + 8);
    split_into(x1.x, x1.y, f, 1);
    split_into(x3.x, x3.y, f, 3);
  }
}

// The B fragment (k16 x 8 columns) of an f32 operand stored k-major in
// shared memory, [k][n] (B[k][n] at b[k * ld + n]), split. Lane (g, t)
// holds column g at k = 2t, 2t + 1 and 2t + 8, 2t + 9.
__device__ __forceinline__ void b_frag_f32_kn(const float* b, int ld, uint32_t (&f)[PIECES][2]) {
  const int lane = threadIdx.x & 31;
  const float* c = b + (size_t)(2 * (lane & 3)) * ld + (lane >> 2);
  split_into(c[0], c[ld], f, 0);
  split_into(c[8 * ld], c[9 * ld], f, 1);
}

// The same of an f32 operand stored n-major, [n][k] (B[k][n] at
// b[n * ld + k], ld even, b 8-byte aligned)
__device__ __forceinline__ void b_frag_f32_nk(const float* b, int ld, uint32_t (&f)[PIECES][2]) {
  const int lane = threadIdx.x & 31;
  const float* c = b + (size_t)(lane >> 2) * ld + 2 * (lane & 3);
  const float2 x0 = *reinterpret_cast<const float2*>(c);
  const float2 x1 = *reinterpret_cast<const float2*>(c + 8);
  split_into(x0.x, x0.y, f, 0);
  split_into(x1.x, x1.y, f, 1);
}

// the card's global timer, in nanoseconds (the instrumented builds' clock
// beside clock64())
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// the two halves of a cluster barrier: arrive (release) and wait (acquire),
// called in turn by every thread of every CTA of the cluster
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
// an arrive that orders none of this thread's memory operations: for a CTA
// that only read the shared memory the wait guards, whose reads have all
// returned (their values consumed) before it arrives
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A ring of W stages in shared memory, filled by bulk copies (the copy
// engine: cp.async.bulk, one thread a copy, completing on a "full"
// mbarrier by its byte count) and released by the consuming warps (one
// arrival each on an "empty" mbarrier). Stage g % S holds the g-th chunk a CTA consumes;
// chunk g's full phase has parity (g / S) & 1, and chunk g + S may be
// copied once chunk g's empty phase has completed.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// makes the barriers' initialisation visible to the copy engine and the cluster
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// one arrival that also announces `bytes` of copies the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// has the phase of this parity completed? (no waiting)
__device__ __forceinline__ bool mbar_test(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// wait for the phase of this parity to complete. A wait that never ends
// (a fault in the ring's bookkeeping) traps after 2^26 polls (seconds), so
// the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
#pragma unroll 1
  for (unsigned spins = 0; !done; ++spins) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (spins == (1u << 26)) __trap();
  }
}
// one bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global memory into this CTA's shared memory, completing
// on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// this CTA's shared memory at p, as the cluster address of the same offset
// in CTA `rank`'s shared memory
__device__ __forceinline__ unsigned peer_addr(const void* p, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}
// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from this CTA's shared memory to a peer's (cluster addresses of the
// destination and of the peer's mbarrier it completes on)
__device__ __forceinline__ void bulk_copy_to_peer(unsigned dst, const void* src, unsigned bytes,
                                                  unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(smem_addr(src)), "r"(bytes), "r"(bar)
      : "memory");
}
// orders this thread's writes to shared memory before later reads of the
// copy engine (a bulk copy's source)
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The copies of a ring, shared round-robin by its consuming warps: as
// chunk g begins, lane 0 of warp g % warps copies chunk g + S - 1 into the
// stage chunk g - 1 used, once every warp has released chunk g - 1 (chunks
// 0..S-2 are copied before the loop). Each copy's few mbarrier operations
// cost a warp about as much as a chunk's product, so no warp carries them
// all, and none waits long: a warp starting chunk g has released g - 1.
// copy(x, stage, full) starts chunk x's copy into `stage` on `full`.
template <typename Copy>
__device__ __forceinline__ void ring_turn(int g, int S, int total, int warps, uint64_t* full,
                                          uint64_t* empty, Copy copy) {
  const int x = g + S - 1;
  if (threadIdx.x % 32 == 0 && (int)(threadIdx.x / 32) == g % warps && x < total) {
    if (x >= S) mbar_wait(empty + x % S, ((x / S) + 1) & 1);
    copy(x, x % S, full + x % S);
  }
  __syncwarp();
}

// How many clusters of nc CTAs of `kernel` (threads each, a whole SM's
// shared memory each) the card holds at once, into *out. Clusters of more
// than 8 are allowed on the kernel first (not portable).
template <typename Kernel>
int cluster_slots(Kernel kernel, int nc, int threads, int* out) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err == cudaSuccess && nc > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = SMEM_LIMIT;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  *out = n;
  return 0;
}

}  // namespace recur_chain
