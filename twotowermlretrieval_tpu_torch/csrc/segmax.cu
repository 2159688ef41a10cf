// Segment-max scan of the corpus: phase 1 of the exact top-k search.
//
// Replaces two TPU kernels of twotowermlretrieval_tpu/ops/topk.py:
// - _segmax_kernel (called through fused_topk_segmax): queries q [B, H] and
//   docs [Npad, H] in the storage dtype (bf16 or f32);
// - _segmax_int8_kernel (called through fused_topk_segmax_int8): docs
//   [Npad, H] int8 quantized per row with scales [Npad] f32, queries bf16;
//   each score is multiplied by its row's scale after the sum.
// Same contract for both: Npad a multiple of the 128-row segment; scores
// docs . q^T are summed in f32; rows >= n_valid score NEG_INF (-3e38).
// Writes the maximum of each 128-row segment as segmax [S, B] f32 and, when
// asked (phase2="gather", bf16/f32 only), every masked score as cache
// [Npad, B] f32.
//
// What bounds it on Hopper: the bytes of the corpus. At 1,048,576 x 256
// bf16 the scan reads 512 MiB, 0.16 ms at 3.35 TB/s (int8: 256 MiB and the
// 4 MiB of scales, 0.081 ms), while the products (2*B*H per row) are far
// below the card's rate; only [S, B] floats go back to memory.
//
// Design (the simple, correct first version): a block of 128 threads owns
// one segment at a time (grid-stride over segments) and scores it with
// doc_tile.cuh (thread i owns doc row i, B sums in registers, rows staged
// through shared memory), so the segment max is one block reduction and no
// score tile ever leaves the chip. The int8 rows are converted to f32 in
// registers (exact); the per-row scale multiplies the f32 sum, as the TPU
// kernel does. Tensor-core products, TMA and double-buffered chunks are
// later work.

#include "doc_tile.cuh"

namespace {

using doc_tile::ROWS;
constexpr int SEG = ROWS;  // rows per segment == threads per block
constexpr float NEG_INF = -3.0e38f;

// T: storage dtype; TQ: query dtype; BQ: query rows held per thread (B <= BQ).
template <typename T, typename TQ, int BQ>
__global__ void __launch_bounds__(SEG) segmax_kernel(
    int B, int H, long long S, long long n_valid,
    const TQ* __restrict__ q, const T* __restrict__ docs, const float* __restrict__ scales,
    float* __restrict__ segmax, float* __restrict__ cache) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                        // [BQ][H + 4]
  unsigned char* tile = smem + (size_t)BQ * (H + 4) * sizeof(float);  // [SEG][PITCH]
  float* red = reinterpret_cast<float*>(tile + doc_tile::TILE_BYTES); // [SEG/32][BQ]

  doc_tile::load_queries<TQ, BQ>(B, H, q, q_s);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long s = blockIdx.x; s < S; s += gridDim.x) {
    const long long seg_row0 = s * SEG;
    float acc[BQ];
    doc_tile::score_tile<T, BQ>(H, docs, seg_row0, q_s, tile, acc);

    const long long row = seg_row0 + threadIdx.x;
    if (scales != nullptr) {
      const float sc = scales[row];
#pragma unroll
      for (int b = 0; b < BQ; ++b) acc[b] *= sc;
    }
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
    // the next segment's first __syncthreads (in score_tile) orders these
    // reads of red before its writes
  }
}

template <typename T, typename TQ, int BQ>
int launch(int B, int H, long long npad, long long n_valid, const void* q, const void* docs,
           const float* scales, float* segmax, float* cache, cudaStream_t stream) {
  auto kernel = segmax_kernel<T, TQ, BQ>;
  const size_t smem =
      (size_t)BQ * (H + 4) * sizeof(float) + doc_tile::TILE_BYTES + (SEG / 32) * BQ * sizeof(float);
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
  kernel<<<(unsigned)grid, SEG, smem, stream>>>(B, H, S, n_valid, static_cast<const TQ*>(q),
                                                static_cast<const T*>(docs), scales, segmax,
                                                cache);
  return (int)cudaGetLastError();
}

template <typename T, typename TQ>
int dispatch_bq(int B, int H, long long npad, long long n_valid, const void* q, const void* docs,
                const float* scales, float* segmax, float* cache, cudaStream_t stream) {
  if (B <= 8)
    return launch<T, TQ, 8>(B, H, npad, n_valid, q, docs, scales, segmax, cache, stream);
  if (B <= 16)
    return launch<T, TQ, 16>(B, H, npad, n_valid, q, docs, scales, segmax, cache, stream);
  return launch<T, TQ, 32>(B, H, npad, n_valid, q, docs, scales, segmax, cache, stream);
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
    return dispatch_bq<__nv_bfloat16, __nv_bfloat16>(B, H, npad, n_valid, q, docs, nullptr,
                                                     segmax, cache, s);
  return dispatch_bq<float, float>(B, H, npad, n_valid, q, docs, nullptr, segmax, cache, s);
}

// The per-row int8 index: q [B, H] bf16, docs [npad, H] int8, scales
// [npad] f32. 1 <= B <= 32; H a multiple of 16; npad a multiple of 128.
int segmax_int8_launch(int device, int B, int H, long long npad, long long n_valid,
                       const void* q, const void* docs, const float* scales, float* segmax,
                       void* stream) {
  if (B < 1 || B > 32 || npad % SEG != 0 || H % 16 != 0 || scales == nullptr)
    return (int)cudaErrorInvalidValue;
  if (npad == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  return dispatch_bq<int8_t, __nv_bfloat16>(B, H, npad, n_valid, q, docs, scales, segmax,
                                            nullptr, static_cast<cudaStream_t>(stream));
}

const char* segmax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
