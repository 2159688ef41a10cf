// Gradient clip by global norm, then Adam: one multi-tensor update of every
// trainable leaf, computed on the card from device scalars alone.
//
// Replaces no TPU kernel. The JAX package's update (optax
// clip_by_global_norm then adam, twotowermlretrieval_tpu/train/train_step.py)
// is fused by XLA into a few loops over the leaves; the port's plain version
// (train/train_step.py apply_clip_and_adam's loop) takes about 18 launches a
// leaf, and its bias corrections are tensors built from host scalars. This
// source does the same arithmetic in two launches (two a group of MAX_LEAVES
// leaves):
//
// 1. adam_squares_kernel: each leaf's sum(g*g) into sq[L] f32. The leaves are
//    cut into tiles of TILE elements; a CTA sums a tile's squares in a fixed
//    order (each thread its groups of four elements in turn, then the warp's
//    butterfly, then the block's warps) into part[tile], and the last CTA to
//    finish (a counter in device memory, set back to 0 by that CTA) sums
//    each leaf's tiles in a fixed order into sq. The same inputs give the
//    same bits, whatever the CTAs' order or the pointers' alignment.
// 2. adam_update_kernel: every CTA sums sq in a fixed order, so all take the
//    same gnorm, scale = min(1, max_norm / max(gnorm, 1e-16)), and the bias
//    corrections 1 - b^count from the int32 step count in device memory
//    (powf, as torch's f32 pow). Each element then takes optax's arithmetic
//    in the plain loop's order, rounded after each operation as the loop's
//    torch operations round (the __f*_rn intrinsics: nothing is contracted
//    into an FMA the loop does not have). CTA 0 writes gnorm.
//
// The leaf table (the pointers of g, p, mu and nu and each leaf's size) is a
// kernel parameter passed by value (__grid_constant__): nothing is copied
// from the host to the card, so nothing synchronizes. sm_90 with CUDA 12.1
// takes 32,764 bytes of parameters; a Table of MAX_LEAVES is 30,728.
//
// What bounds it on Hopper: bytes. Each f32 element reads g twice (4 + 4)
// and p, mu, nu once and writes them (24): 32 bytes. Config 5's 89.6 M
// trainable elements take 0.86 ms at 3.35 TB/s, the GRU towers' 3.7 M
// 0.036 ms, where the two launches' latency is most of the time. Loads and
// stores are 16 bytes a thread where all four pointers of a leaf are
// 16-byte aligned, four scalars in the same order elsewhere and in a leaf's
// last group.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 8192;        // elements of a leaf a CTA takes at a time (ops/adam.py TILE)
constexpr int MAX_LEAVES = 640;   // leaves a launch (ops/adam.py LEAVES_PER_LAUNCH)
constexpr int CTAS_PER_SM = 2048 / THREADS;

// optax's constants as the plain loop's torch operations take them: a Python
// float scalar times an f32 tensor is computed with the scalar cast to f32.
constexpr float B1 = 0.9f;
constexpr float B2 = 0.999f;
constexpr float ONE_MINUS_B1 = static_cast<float>(1.0 - 0.9);
constexpr float ONE_MINUS_B2 = static_cast<float>(1.0 - 0.999);
constexpr float EPS = 1e-8f;
constexpr float MIN_NORM = 1e-16f;

struct Leaf {
  const float* g;
  float* p;
  float* mu;
  float* nu;
  long long n;  // elements
  int tile0;    // the leaf's first tile in the launch
  int sq;       // the leaf's entry in sq
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int leaves;
  int tiles;
};

struct Coef {
  float scale, bc1, bc2;
};

// the last leaf whose first tile is at or before `tile` (an empty leaf shares
// its first tile with the next, which holds the tile)
__device__ __forceinline__ int leaf_of(const Table& t, int tile) {
  int lo = 0, hi = t.leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].tile0 <= tile) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float warp_sum(float v) {
  // a butterfly: every lane ends with the same bits
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's sum, in thread 0; `red` is reusable when it returns
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < WARPS ? red[lane] : 0.f;
    v = warp_sum(v);
  }
  __syncthreads();
  return v;
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

__global__ void __launch_bounds__(THREADS)
    adam_squares_kernel(const __grid_constant__ Table t, float* __restrict__ part,
                        float* __restrict__ sq, unsigned* __restrict__ done) {
  __shared__ float red[WARPS];
  __shared__ bool last;
  for (int tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
    const Leaf& l = t.leaf[leaf_of(t, tile)];
    const long long start = static_cast<long long>(tile - l.tile0) * TILE;
    const int len = static_cast<int>(min(static_cast<long long>(TILE), l.n - start));
    const float* g = l.g + start;
    const bool vec = aligned16(g);
    float acc = 0.f;
    for (int e = 4 * threadIdx.x; e < len; e += 4 * THREADS) {
      if (vec && e + 4 <= len) {
        const float4 x = reinterpret_cast<const float4*>(g)[e >> 2];
        acc = __fmaf_rn(x.x, x.x, acc);
        acc = __fmaf_rn(x.y, x.y, acc);
        acc = __fmaf_rn(x.z, x.z, acc);
        acc = __fmaf_rn(x.w, x.w, acc);
      } else {
        for (int j = e; j < e + 4 && j < len; ++j) acc = __fmaf_rn(g[j], g[j], acc);
      }
    }
    acc = block_sum(acc, red);
    if (threadIdx.x == 0) part[tile] = acc;
  }
  // the last CTA to finish sums each leaf's tiles in order
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = w; i < t.leaves; i += WARPS) {
    const Leaf& l = t.leaf[i];
    const int tiles = static_cast<int>((l.n + TILE - 1) / TILE);
    float s = 0.f;
    for (int k = lane; k < tiles; k += 32) s += __ldcg(part + l.tile0 + k);
    s = warp_sum(s);
    if (lane == 0) sq[l.sq] = s;
  }
  if (threadIdx.x == 0) *done = 0u;
}

// one element in the plain loop's order:
//   g = g * scale; mu = mu * b1 + (1 - b1) * g; nu = nu * b2 + (1 - b2) * (g * g);
//   p = p + (-lr) * ((mu / bc1) / (sqrt(nu / bc2) + eps))
__device__ __forceinline__ void adam(float& p, float& mu, float& nu, float g, const Coef& c,
                                     float neg_lr) {
  const float gs = __fmul_rn(g, c.scale);
  mu = __fadd_rn(__fmul_rn(mu, B1), __fmul_rn(ONE_MINUS_B1, gs));
  nu = __fadd_rn(__fmul_rn(nu, B2), __fmul_rn(ONE_MINUS_B2, __fmul_rn(gs, gs)));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, c.bc2)), EPS);
  p = __fadd_rn(p, __fmul_rn(neg_lr, __fdiv_rn(__fdiv_rn(mu, c.bc1), den)));
}

__global__ void __launch_bounds__(THREADS)
    adam_update_kernel(const __grid_constant__ Table t, const float* __restrict__ sq, int n_sq,
                       const int* __restrict__ count, float max_norm, float neg_lr,
                       float* __restrict__ gnorm_out) {
  __shared__ Coef coef;
  if (threadIdx.x < 32) {
    float s = 0.f;
    for (int k = threadIdx.x; k < n_sq; k += 32) s += sq[k];
    s = warp_sum(s);
    if (threadIdx.x == 0) {
      const float gnorm = __fsqrt_rn(s);
      // torch.clamp's order, so a NaN norm gives a NaN factor as the loop's
      const float clipped = __fdiv_rn(max_norm, gnorm < MIN_NORM ? MIN_NORM : gnorm);
      const float c = static_cast<float>(*count);
      coef = Coef{clipped > 1.f ? 1.f : clipped, __fsub_rn(1.f, powf(B1, c)),
                  __fsub_rn(1.f, powf(B2, c))};
      if (blockIdx.x == 0) *gnorm_out = gnorm;
    }
  }
  __syncthreads();
  const Coef c = coef;
  for (int tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
    const Leaf& l = t.leaf[leaf_of(t, tile)];
    const long long start = static_cast<long long>(tile - l.tile0) * TILE;
    const int len = static_cast<int>(min(static_cast<long long>(TILE), l.n - start));
    const float* g = l.g + start;
    float* p = l.p + start;
    float* mu = l.mu + start;
    float* nu = l.nu + start;
    const bool vec = aligned16(g) && aligned16(p) && aligned16(mu) && aligned16(nu);
    for (int e = 4 * threadIdx.x; e < len; e += 4 * THREADS) {
      if (vec && e + 4 <= len) {
        const float4 G = reinterpret_cast<const float4*>(g)[e >> 2];
        float4 P = reinterpret_cast<float4*>(p)[e >> 2];
        float4 M = reinterpret_cast<float4*>(mu)[e >> 2];
        float4 V = reinterpret_cast<float4*>(nu)[e >> 2];
        adam(P.x, M.x, V.x, G.x, c, neg_lr);
        adam(P.y, M.y, V.y, G.y, c, neg_lr);
        adam(P.z, M.z, V.z, G.z, c, neg_lr);
        adam(P.w, M.w, V.w, G.w, c, neg_lr);
        reinterpret_cast<float4*>(p)[e >> 2] = P;
        reinterpret_cast<float4*>(mu)[e >> 2] = M;
        reinterpret_cast<float4*>(nu)[e >> 2] = V;
      } else {
        for (int j = e; j < e + 4 && j < len; ++j) {
          float pj = p[j], mj = mu[j], vj = nu[j];
          adam(pj, mj, vj, g[j], c, neg_lr);
          p[j] = pj;
          mu[j] = mj;
          nu[j] = vj;
        }
      }
    }
  }
}

int sm_count(int device) {
  static int counts[64];
  if (device < 0 || device >= 64) return 0;
  if (counts[device] == 0 &&
      cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  return counts[device];
}

// The table of one launch; false where a leaf is negative or the tiles
// overflow an int.
bool fill(Table& t, int leaves, const void* const* g, void* const* p, void* const* mu,
          void* const* nu, const long long* n, int sq0) {
  long long tiles = 0;
  for (int i = 0; i < leaves; ++i) {
    if (n[i] < 0) return false;
    t.leaf[i] = Leaf{static_cast<const float*>(g[i]),
                     p ? static_cast<float*>(p[i]) : nullptr,
                     mu ? static_cast<float*>(mu[i]) : nullptr,
                     nu ? static_cast<float*>(nu[i]) : nullptr,
                     n[i], static_cast<int>(tiles), sq0 + i};
    tiles += (n[i] + TILE - 1) / TILE;
    if (tiles > INT_MAX) return false;
  }
  t.leaves = leaves;
  t.tiles = static_cast<int>(tiles);
  return true;
}

// CTAs a launch: one a tile up to a full card, and one at least (the last CTA
// of the squares pass writes every leaf's sum; CTA 0 of the update writes gnorm)
int grid(int device, int tiles) {
  const int sms = sm_count(device);
  if (sms == 0) return 0;
  return tiles < 1 ? 1 : tiles < sms * CTAS_PER_SM ? tiles : sms * CTAS_PER_SM;
}

int squares(int device, int leaves, const void* const* g, const long long* n, int sq0, float* part,
            long long part_len, float* sq, unsigned* done, cudaStream_t stream) {
  Table t;
  if (!fill(t, leaves, g, nullptr, nullptr, nullptr, n, sq0) || t.tiles > part_len)
    return (int)cudaErrorInvalidValue;
  const int blocks = grid(device, t.tiles);
  if (blocks == 0) return (int)cudaErrorInvalidDevice;
  adam_squares_kernel<<<blocks, THREADS, 0, stream>>>(t, part, sq, done);
  return (int)cudaGetLastError();
}

int update(int device, int leaves, const void* const* g, void* const* p, void* const* mu,
           void* const* nu, const long long* n, const float* sq, int n_sq, const int* count,
           float max_norm, float neg_lr, float* gnorm, cudaStream_t stream) {
  Table t;
  if (!fill(t, leaves, g, p, mu, nu, n, 0)) return (int)cudaErrorInvalidValue;
  const int blocks = grid(device, t.tiles);
  if (blocks == 0) return (int)cudaErrorInvalidDevice;
  adam_update_kernel<<<blocks, THREADS, 0, stream>>>(t, sq, n_sq, count, max_norm, neg_lr, gnorm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The square sums of `leaves` (at most MAX_LEAVES) f32 gradients g[i] of
// n[i] elements each, into sq[sq0 + i]. part: f32 scratch of part_len >= the
// launch's tiles (sum of ceil(n[i] / TILE)); done: an unsigned counter in
// device memory, 0 before the launch and after it. device: the CUDA ordinal
// the tensors live on (this library carries its own runtime, whose current
// device is not PyTorch's). Returns cudaGetLastError() after the launch (0 on
// success).
int adam_squares_launch(int device, int leaves, const void* const* g, const long long* n, int sq0,
                        void* part, long long part_len, void* sq, void* done, void* stream) {
  if (leaves < 1 || leaves > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  auto* const s = static_cast<cudaStream_t>(stream);
  auto* const f = static_cast<float*>(part);
  auto* const q = static_cast<float*>(sq);
  auto* const d = static_cast<unsigned*>(done);
  return squares(device, leaves, g, n, sq0, f, part_len, q, d, s);
}

// Clip and Adam in place on `leaves` (at most MAX_LEAVES) f32 leaves: p[i],
// mu[i], nu[i] updated from g[i], n[i] elements each, all contiguous. The
// clip's norm is sqrt of the sum of sq[0 .. n_sq) (every leaf of the step);
// count: the int32 step count, already advanced to this step; gnorm: an f32
// scalar the norm is written to. neg_lr: -lr as f32.
int adam_update_launch(int device, int leaves, const void* const* g, void* const* p,
                       void* const* mu, void* const* nu, const long long* n, const void* sq,
                       int n_sq, const void* count, float max_norm, float neg_lr, void* gnorm,
                       void* stream) {
  if (leaves < 1 || leaves > MAX_LEAVES || n_sq < leaves) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  auto* const s = static_cast<cudaStream_t>(stream);
  auto* const q = static_cast<const float*>(sq);
  auto* const c = static_cast<const int*>(count);
  auto* const out = static_cast<float*>(gnorm);
  return update(device, leaves, g, p, mu, nu, n, q, n_sq, c, max_norm, neg_lr, out, s);
}

const char* adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
