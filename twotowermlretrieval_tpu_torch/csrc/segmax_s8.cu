// Segment-max scan of the per-segment int8 index: phase 1 of int8 serving.
//
// Replaces: twotowermlretrieval_tpu/ops/topk.py _segmax_s8_kernel (called
// through _segmax_s8_phase1 <- fused_topk_segmax_s8). Same contract:
// queries q [B, H] int8 (quantized per row), docs [Npad, H] int8 (quantized
// with one scale per seg-row segment), Npad a multiple of 128, seg 32, 64 or
// 128. Scores docs . q^T are exact int32 sums (|score| <= 127 * 127 * H <
// 2^31 for every H the layouts take); the maximum of each seg-row segment
// is taken on the integers and converted to f32 once, rounding to nearest
// even as XLA's convert does, and written as segmax [Npad / seg, B] f32;
// when asked (phase2="gather") every score is converted alike and written
// as cache [Npad, B] f32. Rounding is monotone, so max-then-convert gives
// the bits of the TPU kernel's convert-then-max at every width, also where
// the scores pass 2^24 and round. There is no padding mask (as on the TPU):
// zero rows score 0, and the caller keeps one extra segment and masks by
// n_valid later.
//
// What bounds it on Hopper: the bytes of the corpus. 1,048,576 x 256 int8
// is 256 MiB, 0.080 ms at 3.35 TB/s; the 2*B*H int8 operations per row
// (8.6 G at B=16) take 0.004 ms at the 1,979 TOP/s tensor-core rate, and
// the segment maxima are 32x smaller than the corpus at B=16, seg=128. So
// the scan must keep enough bytes in flight on every SM, and the products
// must not add issue time of their own.
//
// Design (doc_mma.cuh, the s8 x s8 path): persistent blocks of 4 warps walk
// the 128-row tiles (blockIdx.x, + gridDim.x, ...); a tile is whole
// segments for every seg, and warp w's rows 32w .. 32w + 31 are one 32-row
// segment. Each tile streams through a ring of `stages` cp.async buffers of
// 128 bytes a row (16 KiB, swizzled, the k-tail zero-filled by the copy):
// the copies of the next stages, across tile boundaries, are in flight
// while the current one is multiplied, one barrier a stage. Products are
// mma.sync.m16n8k32 s8 x s8 with int32 accumulators (one mma per 32 bytes
// of a row and 8 queries, against 64 __dp4a on the CUDA cores); the
// query fragments sit in shared memory as int8 words in lane order. The
// segment max runs on the accumulators: rows g and g + 8 and the two m16
// tiles in registers, then shuffles across g (xor 4, 8, 16); seg 32 is then
// written, seg 64 and 128 go through shared memory across 2 or 4 warps,
// whose half of a double buffer waits for the next tile's ring barrier
// rather than a barrier of its own. The stages and the blocks a SM come
// from ops/topk.py s8_plan (mirroring s8_smem below): the most blocks a SM
// holds, then the deepest ring they leave room for, since each block waits
// at a barrier a stage and, from two blocks a SM, the bytes in flight no
// longer set the time. The cp.async ring was kept over TMA: it reads the
// corpus within a few percent of the rate at which the card reads the same
// bytes for a plain int64 max. No atomics: two calls give the same bits.

#include "doc_mma.cuh"

namespace {

using doc_mma::ROWS;
constexpr int MAX_STAGES = 8;

// Shared memory of segmax_s8_kernel: the ring, the query fragments and the
// warps' integer column maxima, two tiles' worth (ops/topk.py s8_plan
// mirrors it).
template <int NT>
size_t s8_smem(int stages, int H) {
  return doc_mma::scan_smem<doc_mma::S8>(stages, H, NT) +
         (size_t)2 * doc_mma::WARPS * NT * 8 * sizeof(int);
}

// NT = ceil(B / 8) n8 tiles of queries.
template <int NT>
__global__ void __launch_bounds__(doc_mma::THREADS, 4) segmax_s8_kernel(
    int B, int H, int seg, long long tiles, int stages, const int8_t* __restrict__ q,
    const int8_t* __restrict__ docs, float* __restrict__ segmax, float* __restrict__ cache) {
  using namespace doc_mma;
  constexpr int NC = NT * 8;  // query columns the fragments hold
  extern __shared__ __align__(128) unsigned char smem[];
  const int nck = chunks_of(H);
  unsigned char* ring = smem;  // [stages][ROWS][CHUNK]
  uint2* qf = reinterpret_cast<uint2*>(smem + (size_t)stages * STAGE_BYTES);  // [nck * 4][NT][32]
  int* red = reinterpret_cast<int*>(qf + (size_t)nck * Steps<S8>::K * NT * 32);  // [2][WARPS][NC]
  load_query_frags_s8(q, B, H, nck, NT, qf);

  const long long first = blockIdx.x, step = gridDim.x;
  const long long mine = tiles > first ? (tiles - 1 - first) / step + 1 : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto row0_of = [&](long long i) { return (first + i * step) * ROWS; };
  // seg 64 and 128: the maxima of the tile at row0 across its warps, from
  // the warps' column maxima in red_t
  const int per = seg / 32, segs = ROWS / seg;  // warps a segment, segments a tile
  auto finish = [&](long long row0, const int* red_t) {
    if (threadIdx.x < segs * B) {
      const int s = threadIdx.x / B, b = threadIdx.x % B;
      int m = red_t[s * per * NC + b];
      for (int w = 1; w < per; ++w) m = max(m, red_t[(s * per + w) * NC + b]);
      segmax[(size_t)(row0 / seg + s) * B + b] = __int2float_rn(m);
    }
  };
  long long prev = -1;  // row0 of the tile whose warp maxima wait in red
  int par = 0;          // the half of red the next tile writes
  auto done = [&](long long row0, int (&acc)[2][NT][4]) {
    if (cache != nullptr) {
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8
          float* dst = cache + (size_t)(row0 + acc_row(st, 2 * h)) * B;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int col = acc_col(j, 0);
            const float v0 = __int2float_rn(acc[st][j][2 * h]);
            const float v1 = __int2float_rn(acc[st][j][2 * h + 1]);
            if (col + 1 < B && (B & 1) == 0) {
              *reinterpret_cast<float2*>(dst + col) = make_float2(v0, v1);
            } else {
              if (col < B) dst[col] = v0;
              if (col + 1 < B) dst[col + 1] = v1;
            }
          }
        }
    }
    // the warp's 32 rows: the two m16 tiles, rows g and g + 8, then across g
    int mx[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        mx[j][c] = max(max(acc[0][j][c], acc[0][j][2 + c]), max(acc[1][j][c], acc[1][j][2 + c]));
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mx[j][c] = max(mx[j][c], __shfl_xor_sync(0xffffffffu, mx[j][c], off));
      }
    if (seg == 32) {  // one segment a warp
      if (lane < 4) {
        float* dst = segmax + (size_t)(row0 / 32 + warp) * B;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (acc_col(j, c) < B) dst[acc_col(j, c)] = __int2float_rn(mx[j][c]);
      }
      return;
    }
    // Across warps without a barrier of its own: the previous tile's warp
    // maxima, written before at least one of the ring's barriers, are
    // reduced now; this tile's go to the other half of red and wait for
    // the next tile (or the barrier after the loop). That half was last
    // read a tile ago, also before a ring barrier.
    if (prev >= 0) finish(prev, red + (par ^ 1) * WARPS * NC);
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        red[(par * WARPS + warp) * NC + acc_col(j, 0)] = mx[j][0];
        red[(par * WARPS + warp) * NC + acc_col(j, 1)] = mx[j][1];
      }
    }
    prev = row0;
    par ^= 1;
  };
  scan_tiles<S8, NT>(reinterpret_cast<const S8*>(docs), H, stages, mine, row0_of, ring, qf, done);
  if (prev >= 0) {  // the block's last tile (seg is the same for the whole block)
    __syncthreads();
    finish(prev, red + (par ^ 1) * WARPS * NC);
  }
}

template <int NT>
int launch(int B, int H, long long npad, int seg, int stages, int blocks, const void* q,
           const void* docs, float* segmax, float* cache, cudaStream_t stream) {
  auto kernel = segmax_s8_kernel<NT>;
  const size_t smem = s8_smem<NT>(stages, H);
  if (smem > (size_t)recur_chain::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // the next launch must not report it
      return (int)e;
    }
  }
  kernel<<<blocks, doc_mma::THREADS, smem, stream>>>(
      B, H, seg, npad / ROWS, stages, static_cast<const int8_t*>(q),
      static_cast<const int8_t*>(docs), segmax, cache);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, H] and docs [npad, H] int8, both 16-byte aligned; 1 <= B <= 32;
// H a multiple of 16; npad a multiple of 128; seg 32, 64 or 128; cache
// [npad, B] f32 or null. stages (2-8) and blocks (the grid) come from
// ops/topk.py s8_plan; a layout beyond a block's shared memory is refused.
// device: the CUDA ordinal the tensors live on. Returns cudaGetLastError()
// after the launch (0 on success).
int segmax_s8_launch(int device, int B, int H, long long npad, int seg, int stages, int blocks,
                     const void* q, const void* docs, float* segmax, float* cache, void* stream) {
  if (B < 1 || B > 32 || H < 16 || H % 16 != 0 || npad % ROWS != 0 ||
      (seg != 32 && seg != 64 && seg != 128) || stages < 2 || stages > MAX_STAGES || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (npad == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((B + 7) / 8) {
    case 1: return launch<1>(B, H, npad, seg, stages, blocks, q, docs, segmax, cache, s);
    case 2: return launch<2>(B, H, npad, seg, stages, blocks, q, docs, segmax, cache, s);
    case 3: return launch<3>(B, H, npad, seg, stages, blocks, q, docs, segmax, cache, s);
    default: return launch<4>(B, H, npad, seg, stages, blocks, q, docs, segmax, cache, s);
  }
}

const char* segmax_s8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
