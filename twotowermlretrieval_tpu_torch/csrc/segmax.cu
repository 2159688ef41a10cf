// Segment-max scan of the corpus: phase 1 of the exact top-k search.
//
// Replaces two TPU kernels of twotowermlretrieval_tpu/ops/topk.py:
// - _segmax_kernel (called through fused_topk_segmax): queries q [B, H] and
//   docs [Npad, H] in the storage dtype (bf16 or f32; f32 at
//   Precision.HIGHEST);
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
// 4 MiB of scales, 0.081 ms; f32: 1 GiB, 0.32 ms), while the products
// (2*B*H per row; six bf16 products per f32 one) are far below the card's
// tensor-core rate; only [S, B] floats go back to memory.
//
// Every storage dtype (segmax_mma_kernel): persistent blocks of 128
// threads, as many a SM as shared memory allows (ops/topk.py scan_plan),
// walk the segments (blockIdx.x, + gridDim.x, ...). Each segment is scored
// on the tensor cores by doc_mma.cuh, one 128-byte column stage of its 128
// rows at a time, through a ring of `stages` buffers fed by cp.async: the
// copies of the next stages (across segment boundaries) are in flight while
// the current one is multiplied, one barrier a stage. The row scale, the
// mask and the cache store act on the accumulator fragments; the segment
// max is a register reduction over each warp's 32 rows (then the lanes of
// a column), then one across the 4 warps through shared memory. No
// atomics: two calls give the same bits. f32 rows are split into three
// bf16 pieces in registers and scored with six products (doc_mma.cuh, "The
// f32 path": within 2^-23 (1 + 2^-7) sum_k |q_k d_k| of the exact product
// before the f32 sum's own rounding), their query fragments split once a
// call by a first small launch and carried through the ring stage by
// stage, so one pass over the corpus takes every width. bf16 and per-row
// int8 scans keep their query fragments resident in shared memory where
// that fits beside two blocks a SM (the served width), and elsewhere take
// the same ring route (RING): packed once a call by a first small launch
// (doc_mma.cuh pack_query_frags) and carried beside each stage's rows, so
// 32 queries at every tower width take one pass, bit for bit the resident
// route's scores.

#include "doc_mma.cuh"

namespace {

using doc_mma::ROWS;
constexpr int SEG = ROWS;  // rows per segment
constexpr float NEG_INF = -3.0e38f;

// Shared memory of segmax_mma_kernel: the ring, the query fragments
// (unless they ride the ring: RING) and the warps' column maxima
// (ops/topk.py scan_plan mirrors it).
template <typename T, int NT, bool RING>
size_t mma_smem(int stages, int H) {
  return doc_mma::scan_smem<T, RING>(stages, H, NT) +
         (size_t)doc_mma::WARPS * NT * 8 * sizeof(float);
}

// bf16 (T = bf16) or per-row int8 (T = int8_t, scales [Npad]) docs with
// bf16 queries q, or f32 docs (T = float); NT = ceil(B / 8) n8 tiles of
// queries. RING (always with f32): the query fragments qring in device
// memory (launch_query_frags) ride the ring; else each block builds them
// from q into shared memory.
template <typename T, int NT, bool RING>
__global__ void __launch_bounds__(doc_mma::THREADS, 4) segmax_mma_kernel(
    int B, int H, long long S, long long n_valid, int stages, const __nv_bfloat16* __restrict__ q,
    const uint2* __restrict__ qring, const T* __restrict__ docs,
    const float* __restrict__ scales, float* __restrict__ segmax, float* __restrict__ cache) {
  using namespace doc_mma;
  constexpr int NC = NT * 8;  // query columns the fragments hold
  extern __shared__ __align__(128) unsigned char smem[];
  const int nck = chunks_of(H * (int)sizeof(T));
  unsigned char* ring = smem;  // [stages][stage_bytes<T, RING>(NT)]
  unsigned char* after = smem + (size_t)stages * stage_bytes<T, RING>(NT);
  uint2* qf = reinterpret_cast<uint2*>(after);  // [nck * K][NT][32], unless they ride the ring
  float* red = reinterpret_cast<float*>(  // [WARPS][NC]
      after + (RING ? 0 : qfrag_bytes(nck, Steps<T>::K, NT)));
  if constexpr (RING) qf = const_cast<uint2*>(qring);
  else load_query_frags<T>(q, B, H, nck, NT, qf);

  const long long first = blockIdx.x, step = gridDim.x;
  const long long segs = S > first ? (S - 1 - first) / step + 1 : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto row0_of = [&](long long i) { return (first + i * step) * ROWS; };
  auto done = [&](long long row0, float (&acc)[2][NT][4]) {
    // the segment is scored: scale, mask, cache, maximum
    float mx[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) mx[j][0] = mx[j][1] = __int_as_float(0xff800000);  // -inf
#pragma unroll
    for (int st = 0; st < 2; ++st) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8
        const long long row = row0 + acc_row(st, 2 * h);
        const float sc = scales != nullptr ? scales[row] : 1.0f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float v = acc[st][j][2 * h + c];
            if (scales != nullptr) v *= sc;
            if (row >= n_valid) v = NEG_INF;
            const int col = acc_col(j, c);
            if (cache != nullptr && col < B) cache[(size_t)row * B + col] = v;
            mx[j][c] = fmaxf(mx[j][c], v);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mx[j][c] = fmaxf(mx[j][c], __shfl_xor_sync(0xffffffffu, mx[j][c], off));
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        red[warp * NC + acc_col(j, 0)] = mx[j][0];
        red[warp * NC + acc_col(j, 1)] = mx[j][1];
      }
    }
    __syncthreads();
    if (threadIdx.x < B) {
      float m = red[threadIdx.x];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w * NC + threadIdx.x]);
      segmax[(row0 / ROWS) * B + threadIdx.x] = m;
    }
    // the next stage's barrier orders these reads of red before its writes
  };
  scan_tiles<T, NT, RING>(docs, H, stages, segs, row0_of, ring, qf, done);
}

int allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) cudaGetLastError();  // the next launch must not report it
  return (int)e;
}

template <typename T, int NT, bool RING>
int launch_mma(int B, int H, long long npad, long long n_valid, int stages, int blocks,
               const void* q, const void* docs, const float* scales, float* segmax, float* cache,
               void* qf, cudaStream_t stream) {
  auto kernel = segmax_mma_kernel<T, NT, RING>;
  const size_t smem = mma_smem<T, NT, RING>(stages, H);
  if (smem > (size_t)recur_chain::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (const int e = allow_smem((const void*)kernel, smem)) return e;
  if constexpr (RING) {
    const int e = doc_mma::launch_query_frags<T, NT>(q, B, H, static_cast<uint2*>(qf), stream);
    if (e) return e;
  }
  kernel<<<blocks, doc_mma::THREADS, smem, stream>>>(
      B, H, npad / SEG, n_valid, stages,
      doc_mma::kSplit<T> ? nullptr : static_cast<const __nv_bfloat16*>(q),
      static_cast<const uint2*>(qf), static_cast<const T*>(docs), scales, segmax, cache);
  return (int)cudaGetLastError();
}

template <typename T, bool RING>
int dispatch_mma(int B, int H, long long npad, long long n_valid, int stages, int blocks,
                 const void* q, const void* docs, const float* scales, float* segmax,
                 float* cache, void* qf, cudaStream_t s) {
#define SEGMAX_MMA(NT)                                                                    \
  launch_mma<T, NT, RING>(B, H, npad, n_valid, stages, blocks, q, docs, scales, segmax, cache, \
                          qf, s)
  switch ((B + 7) / 8) {
    case 1: return SEGMAX_MMA(1);
    case 2: return SEGMAX_MMA(2);
    case 3: return SEGMAX_MMA(3);
    default: return SEGMAX_MMA(4);
  }
#undef SEGMAX_MMA
}

// bf16 and int8 rows: RING where the wrapper passes a workspace for the
// packed query fragments
template <typename T>
int dispatch_route(int B, int H, long long npad, long long n_valid, int stages, int blocks,
                 const void* q, const void* docs, const float* scales, float* segmax,
                 float* cache, void* qf, cudaStream_t s) {
  return qf != nullptr
             ? dispatch_mma<T, true>(B, H, npad, n_valid, stages, blocks, q, docs, scales, segmax,
                                     cache, qf, s)
             : dispatch_mma<T, false>(B, H, npad, n_valid, stages, blocks, q, docs, scales,
                                      segmax, cache, qf, s);
}

}  // namespace

extern "C" {

// storage: 0 f32 docs and queries, 1 bf16 docs and queries, 2 int8 docs
// (per row, scales [npad] f32) with bf16 queries. 1 <= B <= 32; H a
// multiple of 16 bytes' worth of the storage dtype; npad a multiple of 128;
// cache [npad, B] f32 or null (not with int8). stages (2-4) and blocks (the
// grid) come from ops/topk.py scan_plan; a layout beyond a block's shared
// memory is refused. qf: a workspace for the query fragments that ride the
// ring (a first launch writes them): f32 always, ceil(H / 32) * 6 * ceil(B
// / 8) * 256 bytes (three split pieces); bf16 and int8 where the plan's
// fragments ride the ring, ceil(H * elem / 128) * (4 bf16, 8 int8) *
// ceil(B / 8) * 256 bytes; null where they stay resident. device: the CUDA
// ordinal the tensors live on (this library carries its own runtime, whose
// current device is not PyTorch's). Returns cudaGetLastError() after the
// launches (0 on success).
int segmax_launch(int device, int storage, int B, int H, long long npad, long long n_valid,
                  int stages, int blocks, const void* q, const void* docs, const float* scales,
                  float* segmax, float* cache, void* qf, void* stream) {
  const int elem = storage == 0 ? 4 : storage == 1 ? 2 : 1;
  if (storage < 0 || storage > 2 || B < 1 || B > 32 || H < 1 || npad % SEG != 0 ||
      (H * elem) % 16 != 0 || blocks < 1 || (storage == 2) != (scales != nullptr) ||
      (storage == 2 && cache != nullptr) || (storage == 0 && qf == nullptr) || stages < 2 ||
      stages > 4)
    return (int)cudaErrorInvalidValue;
  if (npad == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (storage == 1)
    return dispatch_route<__nv_bfloat16>(B, H, npad, n_valid, stages, blocks, q, docs, nullptr,
                                         segmax, cache, qf, s);
  if (storage == 2)
    return dispatch_route<int8_t>(B, H, npad, n_valid, stages, blocks, q, docs, scales, segmax,
                                  nullptr, qf, s);
  return dispatch_mma<float, true>(B, H, npad, n_valid, stages, blocks, q, docs, nullptr, segmax,
                                   cache, qf, s);
}

const char* segmax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
