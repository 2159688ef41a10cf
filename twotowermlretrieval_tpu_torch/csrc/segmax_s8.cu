// Segment-max scan of the per-segment int8 index: phase 1 of int8 serving.
//
// Replaces: twotowermlretrieval_tpu/ops/topk.py _segmax_s8_kernel (called
// through _segmax_s8_phase1 <- fused_topk_segmax_s8). Same contract:
// queries q [B, H] int8 (quantized per row), docs [Npad, H] int8 (quantized
// with one scale per seg-row segment), Npad a multiple of 128, seg 32, 64 or
// 128. Scores docs . q^T are exact int32 sums; the maximum of each seg-row
// segment is written as segmax [Npad / seg, B] f32 and, when asked
// (phase2="gather"), every score as cache [Npad, B] f32. Both are exact:
// |score| <= 127 * 127 * H < 2^24 for H <= 1040, so the conversion to f32
// loses nothing. There is no padding mask (as on the TPU): zero rows score
// 0, and the caller keeps one extra segment and masks by n_valid later.
//
// What bounds it on Hopper: the bytes of the corpus. 1,048,576 x 256 int8
// is 256 MiB, 0.080 ms at 3.35 TB/s; the 2*B*H int8 operations per row
// (8.6 G at B=16) take 0.004 ms at the 1,979 TOP/s tensor-core rate, and
// the segment maxima are 32x smaller than the corpus at B=16, seg=128.
//
// Design (the simple, correct first version): a block of 128 threads owns
// 128 consecutive rows, i.e. 128/seg whole segments (grid-stride over
// row blocks); thread i owns row i and keeps its B integer sums in
// registers. The int8 queries sit in shared memory packed four to an int32
// and are read as 16-byte broadcasts. Doc rows stream through shared memory
// in 128-byte column chunks (doc_tile.cuh's stage_chunk: coalesced 16-byte
// loads, a 16-byte row pad, free of bank conflicts); each 16-byte piece of a row
// meets each query in four __dp4a (four int8 products summed into an
// int32). The segment max runs on the integers (warp shuffles, then across
// the seg/32 warps of a segment through shared memory) and is converted to
// f32 once per segment and query. Integer tensor-core products (mma.sync or
// wgmma s8) and TMA are later speed work.

#include "doc_tile.cuh"

namespace {

using doc_tile::CHUNK_BYTES;
using doc_tile::PITCH;
using doc_tile::ROWS;

template <int BQ>
__global__ void __launch_bounds__(ROWS) segmax_s8_kernel(
    int B, int H, int seg, long long row_blocks,
    const int8_t* __restrict__ q, const int8_t* __restrict__ docs,
    float* __restrict__ segmax, float* __restrict__ cache) {
  const int HW = H / 4;   // int32 words per row
  const int QP = HW + 4;  // padded query row (words), a multiple of 4
  extern __shared__ __align__(16) unsigned char smem[];
  int* q_s = reinterpret_cast<int*>(smem);                           // [BQ][QP]
  unsigned char* tile = smem + (size_t)BQ * QP * sizeof(int);        // [ROWS][PITCH]
  int* red = reinterpret_cast<int*>(tile + doc_tile::TILE_BYTES);    // [ROWS/32][BQ]

  const int* q_words = reinterpret_cast<const int*>(q);
  for (int i = threadIdx.x; i < BQ * QP; i += ROWS) {
    const int b = i / QP, w = i % QP;
    q_s[i] = (b < B && w < HW) ? q_words[(size_t)b * HW + w] : 0;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int segs = ROWS / seg, warps_per_seg = seg / 32;
  for (long long blk = blockIdx.x; blk < row_blocks; blk += gridDim.x) {
    const long long row0 = blk * ROWS;
    int acc[BQ];
#pragma unroll
    for (int b = 0; b < BQ; ++b) acc[b] = 0;

    for (int k0 = 0; k0 < H; k0 += CHUNK_BYTES) {
      // begins with a barrier: the query load and the last reads of red are done
      const int vpr =
          doc_tile::stage_chunk(reinterpret_cast<const unsigned char*>(docs), row0, k0, H, tile);
      for (int v = 0; v < vpr; ++v) {
        const int4 d = *reinterpret_cast<const int4*>(tile + threadIdx.x * PITCH + v * 16);
        const int* qk = q_s + (k0 + v * 16) / 4;
#pragma unroll
        for (int b = 0; b < BQ; ++b) {
          const int4 qq = *reinterpret_cast<const int4*>(qk + b * QP);
          acc[b] = __dp4a(d.x, qq.x, acc[b]);
          acc[b] = __dp4a(d.y, qq.y, acc[b]);
          acc[b] = __dp4a(d.z, qq.z, acc[b]);
          acc[b] = __dp4a(d.w, qq.w, acc[b]);
        }
      }
    }

    const long long row = row0 + threadIdx.x;
    if (cache != nullptr) {
      float* dst = cache + (size_t)row * B;
#pragma unroll
      for (int b = 0; b < BQ; ++b)
        if (b < B) dst[b] = (float)acc[b];
    }
    // every segment spans whole warps (seg >= 32): reduce each warp first
#pragma unroll
    for (int b = 0; b < BQ; ++b) {
      int m = acc[b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) red[warp * BQ + b] = m;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < segs * B; i += ROWS) {
      const int s = i / B, b = i % B;
      int m = red[s * warps_per_seg * BQ + b];
      for (int w = 1; w < warps_per_seg; ++w) m = max(m, red[(s * warps_per_seg + w) * BQ + b]);
      segmax[(blk * segs + s) * B + b] = (float)m;
    }
  }
}

template <int BQ>
int launch(int B, int H, long long npad, int seg, const void* q, const void* docs,
           float* segmax, float* cache, cudaStream_t stream) {
  auto kernel = segmax_s8_kernel<BQ>;
  const size_t smem = (size_t)BQ * (H / 4 + 4) * sizeof(int) + doc_tile::TILE_BYTES +
                      (ROWS / 32) * BQ * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long row_blocks = npad / ROWS;
  long long grid = (long long)sms * 8;
  if (grid > row_blocks) grid = row_blocks;
  kernel<<<(unsigned)grid, ROWS, smem, stream>>>(B, H, seg, row_blocks,
                                                 static_cast<const int8_t*>(q),
                                                 static_cast<const int8_t*>(docs), segmax, cache);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, H] and docs [npad, H] int8, both 16-byte aligned; 1 <= B <= 32;
// H a multiple of 16 and at most 1040; npad a multiple of 128; seg 32, 64
// or 128; cache may be null. device: the CUDA ordinal the tensors live on.
// Returns cudaGetLastError() after the launch (0 on success).
int segmax_s8_launch(int device, int B, int H, long long npad, int seg, const void* q,
                     const void* docs, float* segmax, float* cache, void* stream) {
  if (B < 1 || B > 32 || H < 16 || H % 16 != 0 || H > 1040 || npad % ROWS != 0 ||
      (seg != 32 && seg != 64 && seg != 128))
    return (int)cudaErrorInvalidValue;
  if (npad == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 8) return launch<8>(B, H, npad, seg, q, docs, segmax, cache, s);
  if (B <= 16) return launch<16>(B, H, npad, seg, q, docs, segmax, cache, s);
  return launch<32>(B, H, npad, seg, q, docs, segmax, cache, s);
}

const char* segmax_s8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
