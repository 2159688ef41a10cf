// Segment-max scan of the corpus: phase 1 of the exact top-k search.
//
// Replaces: twotowermlretrieval_tpu/ops/topk.py _segmax_kernel (called
// through fused_topk_segmax). Same contract: queries q [B, H] and docs
// [Npad, H] in the storage dtype (bf16 or f32), Npad a multiple of the
// 128-row segment. Scores docs . q^T are summed in f32; rows >= n_valid
// score NEG_INF (-3e38). Writes the maximum of each 128-row segment as
// segmax [S, B] f32 and, when asked (phase2="gather"), every masked score
// as cache [Npad, B] f32.
//
// What bounds it on Hopper: the bytes of the corpus. At 1,048,576 x 256
// bf16 the scan reads 512 MiB, 0.16 ms at 3.35 TB/s, while the products
// (2*B*H per row) are far below the card's rate; only [S, B] floats go
// back to memory.
//
// Design (the simple, correct first version): a block of 128 threads owns
// one segment at a time (grid-stride over segments); thread i owns doc row
// i of the segment and keeps its B running sums in registers, so the
// segment max is one block reduction and no score tile ever leaves the
// chip. The queries sit in shared memory as f32 for the block's lifetime
// (at most 32 x 256 x 4 = 32 KiB), read as broadcasts. Doc rows stream
// through shared memory in 128-byte column chunks, loaded with coalesced
// 16-byte loads and a 16-byte row pad so the per-row reads are free of
// bank conflicts. Products are f32 FMAs (a bf16 x bf16 product is exact in
// f32). Tensor-core products, TMA and double-buffered chunks are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG = 128;          // rows per segment == threads per block
constexpr int CHUNK_BYTES = 128;  // bytes of each doc row per staged chunk
constexpr int PITCH = CHUNK_BYTES + 16;
constexpr float NEG_INF = -3.0e38f;

__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(&raw);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// T: storage dtype; BQ: query rows held per thread (B <= BQ).
template <typename T, int BQ>
__global__ void __launch_bounds__(SEG) segmax_kernel(
    int B, int H, long long S, long long n_valid,
    const T* __restrict__ q, const T* __restrict__ docs,
    float* __restrict__ segmax, float* __restrict__ cache) {
  constexpr int VEC = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int KC = CHUNK_BYTES / sizeof(T);  // elements per staged chunk
  const int QP = H + 4;                        // padded query row (floats)

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                  // [BQ][QP]
  unsigned char* tile = smem + (size_t)BQ * QP * sizeof(float);  // [SEG][PITCH]
  float* red = reinterpret_cast<float*>(tile + SEG * PITCH);     // [SEG/32][BQ]

  for (int i = threadIdx.x; i < BQ * QP; i += SEG) {
    const int b = i / QP, k = i % QP;
    q_s[i] = (b < B && k < H) ? to_f(q[(size_t)b * H + k]) : 0.0f;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long s = blockIdx.x; s < S; s += gridDim.x) {
    const long long seg_row0 = s * SEG;
    float acc[BQ];
#pragma unroll
    for (int b = 0; b < BQ; ++b) acc[b] = 0.0f;

    for (int k0 = 0; k0 < H; k0 += KC) {
      const int vpr = (H - k0 < KC ? H - k0 : KC) / VEC;  // 16-byte vectors per row
      __syncthreads();  // the previous chunk (and the query load) is complete
      for (int i = threadIdx.x; i < SEG * vpr; i += SEG) {
        const int r = i / vpr, v = i % vpr;
        const uint4 val = *reinterpret_cast<const uint4*>(
            docs + (size_t)(seg_row0 + r) * H + k0 + v * VEC);
        *reinterpret_cast<uint4*>(tile + r * PITCH + v * 16) = val;
      }
      __syncthreads();
      for (int v = 0; v < vpr; ++v) {
        const uint4 raw = *reinterpret_cast<const uint4*>(tile + threadIdx.x * PITCH + v * 16);
        float x[VEC];
        unpack(raw, x);
        const float* qk = q_s + k0 + v * VEC;
#pragma unroll
        for (int b = 0; b < BQ; ++b) {
          const float4* qv = reinterpret_cast<const float4*>(qk + b * QP);
#pragma unroll
          for (int e = 0; e < VEC / 4; ++e) {
            const float4 qq = qv[e];
            acc[b] = fmaf(x[4 * e + 0], qq.x, acc[b]);
            acc[b] = fmaf(x[4 * e + 1], qq.y, acc[b]);
            acc[b] = fmaf(x[4 * e + 2], qq.z, acc[b]);
            acc[b] = fmaf(x[4 * e + 3], qq.w, acc[b]);
          }
        }
      }
    }

    const long long row = seg_row0 + threadIdx.x;
    if (row >= n_valid) {
#pragma unroll
      for (int b = 0; b < BQ; ++b) acc[b] = NEG_INF;
    }
    if (cache != nullptr) {
      float* dst = cache + (size_t)row * B;
      // unrolled over the compile-time BQ so acc stays in registers
#pragma unroll
      for (int b = 0; b < BQ; ++b)
        if (b < B) dst[b] = acc[b];
    }
#pragma unroll
    for (int b = 0; b < BQ; ++b) {
      float m = acc[b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) red[warp * BQ + b] = m;
    }
    __syncthreads();
    if (threadIdx.x < B) {
      float m = red[threadIdx.x];
#pragma unroll
      for (int w = 1; w < SEG / 32; ++w) m = fmaxf(m, red[w * BQ + threadIdx.x]);
      segmax[s * B + threadIdx.x] = m;
    }
    // the next segment's first __syncthreads orders these reads of red
    // before its writes
  }
}

template <typename T, int BQ>
int launch(int B, int H, long long npad, long long n_valid, const void* q, const void* docs,
           float* segmax, float* cache, cudaStream_t stream) {
  auto kernel = segmax_kernel<T, BQ>;
  const size_t smem =
      (size_t)BQ * (H + 4) * sizeof(float) + SEG * PITCH + (SEG / 32) * BQ * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long S = npad / SEG;
  long long grid = (long long)sms * 4;
  if (grid > S) grid = S;
  kernel<<<(unsigned)grid, SEG, smem, stream>>>(B, H, S, n_valid, static_cast<const T*>(q),
                                                static_cast<const T*>(docs), segmax, cache);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bq(int B, int H, long long npad, long long n_valid, const void* q, const void* docs,
                float* segmax, float* cache, cudaStream_t stream) {
  if (B <= 8) return launch<T, 8>(B, H, npad, n_valid, q, docs, segmax, cache, stream);
  if (B <= 16) return launch<T, 16>(B, H, npad, n_valid, q, docs, segmax, cache, stream);
  return launch<T, 32>(B, H, npad, n_valid, q, docs, segmax, cache, stream);
}

}  // namespace

extern "C" {

// is_bf16: q and docs are bf16 (else f32). 1 <= B <= 32; H a multiple of
// 8 (bf16) or 4 (f32); npad a multiple of 128; cache may be null.
// device: the CUDA ordinal the tensors live on (this library carries its
// own runtime, whose current device is not PyTorch's).
// Returns cudaGetLastError() after the launch (0 on success).
int segmax_launch(int device, int is_bf16, int B, int H, long long npad, long long n_valid,
                  const void* q, const void* docs, float* segmax, float* cache, void* stream) {
  if (B < 1 || B > 32 || npad % SEG != 0 || H % (is_bf16 ? 8 : 4) != 0)
    return (int)cudaErrorInvalidValue;
  if (npad == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_bq<__nv_bfloat16>(B, H, npad, n_valid, q, docs, segmax, cache, s);
  return dispatch_bq<float>(B, H, npad, n_valid, q, docs, segmax, cache, s);
}

const char* segmax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
