// Streaming exact top-k over the corpus: the running top-k kernels.
//
// Replaces two TPU kernels of twotowermlretrieval_tpu/ops/topk.py:
// - _fused_topk_kernel (called through fused_topk): docs [Npad, H] f32 or
//   bf16, queries q [B, H] in the same dtype;
// - _fused_topk_int8_kernel (called through fused_topk_int8): docs int8
//   quantized per row with scales [Npad] f32, queries bf16; each score is
//   multiplied by its row's scale after the sum.
// Same contract for both: scores q . d^T summed in f32; rows >= n_valid
// never rank; writes vals [B, k] f32, sorted descending, and ids [B, k]
// int32, ties to the lower id, NEG_INF / -1 where fewer than k rows are
// valid. The [B, N] scores never reach device memory.
//
// What bounds it on Hopper: the bytes of the corpus (at 1,048,576 x 256,
// 512 MiB in bf16, 0.16 ms at 3.35 TB/s; 260 MiB with the int8 scales,
// 0.081 ms). The products, 2*B*H per row, are far below the card's rate.
//
// Design (the simple, correct first version). Every score is packed with
// its row id into one 64-bit key that orders by value and then by the lower
// id, so all comparisons are one total order: the result is the same for
// any cut of the corpus into chunks and any thread timing. Launch 1 gives
// each block of 128 threads a chunk of whole 128-row tiles, scored with
// doc_tile.cuh (one thread per row, B sums in registers). Per query row the
// block keeps its best 128 keys sorted in shared memory; a tile's keys that
// beat the k-th are appended to a short list (a shared counter), and a
// merge by rank places them: each kept key moves down by the number of new
// keys above it, each new key lands at its rank among the kept (a binary
// search) plus the new keys above it, and whatever ranks 128th or lower
// drops. Once the list holds good keys few tiles bring any, so most tiles
// cost the scoring alone. Each block writes its k best keys per query row
// to a workspace; launch 2, one block of 1024 threads per query row,
// merges the chunks' keys the same way, 1024 at a time. Hence k <= 128. A
// threshold shared across blocks and tensor-core products are later speed
// work.

#include "doc_tile.cuh"

namespace {

using doc_tile::ROWS;
typedef unsigned long long u64;

constexpr int KP = 128;                 // keys kept per query row; k <= KP
constexpr int MERGE_THREADS = 1024;     // chunk keys read per merge step
constexpr float NEG_INF = -3.0e38f;

// Larger key == better: higher value, then lower row id. 0 is "empty".
__device__ __forceinline__ u64 make_key(float v, long long row) {
  if (v == 0.0f) v = 0.0f;  // -0 ranks as +0, as a float comparison has it
  unsigned u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)u << 32) | (u64)(0xFFFFFFFFu - (unsigned)row);
}

__device__ __forceinline__ float key_value(u64 key) {
  const unsigned u = (unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

__device__ __forceinline__ int key_id(u64 key) {
  return (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull));
}

// For every query row r < rows: merges its KP kept keys cur[r] (sorted
// descending, zeros at the end) with its cnt[r] new keys add[r] (any
// order, each above cur[r][k-1], all distinct) into out[r], the KP
// largest sorted descending. Keys are distinct, so the ranks are: each
// position of out[r] gets exactly one writer. Every thread of the block
// calls it; it ends with a barrier.
__device__ void rank_merge(const u64* cur, const u64* add, int add_stride, const int* cnt,
                           u64* out, int rows) {
  const int items = KP + add_stride;
  for (int p = threadIdx.x; p < rows * items; p += blockDim.x) {
    const int r = p / items, i = p % items;
    const int c = cnt[r];
    const u64* kept = cur + (size_t)r * KP;
    const u64* fresh = add + (size_t)r * add_stride;
    u64 key;
    int pos;
    if (i < KP) {
      key = kept[i];
      pos = i;
    } else {
      if (i - KP >= c) continue;
      key = fresh[i - KP];
      int lo = 0, hi = KP;  // kept keys above key
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (kept[mid] > key) lo = mid + 1; else hi = mid;
      }
      pos = lo;
    }
    for (int j = 0; j < c; ++j) pos += fresh[j] > key;
    if (pos < KP) out[(size_t)r * KP + pos] = key;
  }
  __syncthreads();
}

// Launch 1: the k best keys of each chunk of tiles_per_chunk tiles, per
// query row, into cand [chunks][B][k].
template <typename T, typename TQ, int BQ>
__global__ void __launch_bounds__(ROWS) topk_chunk_kernel(
    int B, int H, int k, long long npad, long long n_valid, int tiles_per_chunk,
    const TQ* __restrict__ q, const T* __restrict__ docs, const float* __restrict__ scales,
    u64* __restrict__ cand) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* kept = reinterpret_cast<u64*>(smem);                     // [2][BQ][KP], two buffers
  u64* fresh = kept + 2 * BQ * KP;                              // [BQ][ROWS] new keys
  float* q_s = reinterpret_cast<float*>(fresh + BQ * ROWS);     // [BQ][H + 4]
  unsigned char* tile = reinterpret_cast<unsigned char*>(q_s + (size_t)BQ * (H + 4));
  int* cnt = reinterpret_cast<int*>(tile + doc_tile::TILE_BYTES);  // [BQ]

  for (int i = threadIdx.x; i < BQ * KP; i += ROWS) kept[i] = 0ull;
  doc_tile::load_queries<TQ, BQ>(B, H, q, q_s);

  int cur = 0;  // which buffer of kept holds the keys (block-uniform)
  const long long begin = (long long)blockIdx.x * tiles_per_chunk * ROWS;
  long long end = begin + (long long)tiles_per_chunk * ROWS;
  if (end > npad) end = npad;
  for (long long row0 = begin; row0 < end; row0 += ROWS) {
    float acc[BQ];
    doc_tile::score_tile<T, BQ>(H, docs, row0, q_s, tile, acc);
    const long long row = row0 + threadIdx.x;
    if (scales != nullptr) {
      const float sc = scales[row];
#pragma unroll
      for (int b = 0; b < BQ; ++b) acc[b] *= sc;
    }
    if (threadIdx.x < BQ) cnt[threadIdx.x] = 0;
    __syncthreads();  // counts cleared; the last merge's reads are done
    const u64* kb = kept + cur * BQ * KP;
    bool any = false;
#pragma unroll
    for (int b = 0; b < BQ; ++b) {
      if (b < B && row < n_valid) {
        const u64 key = make_key(acc[b], row);
        if (key > kb[b * KP + k - 1]) {
          fresh[b * ROWS + atomicAdd(&cnt[b], 1)] = key;
          any = true;
        }
      }
    }
    if (__syncthreads_or(any)) {
      rank_merge(kb, fresh, ROWS, cnt, kept + (cur ^ 1) * BQ * KP, B);
      cur ^= 1;
    }
  }
  const u64* kb = kept + cur * BQ * KP;
  for (int i = threadIdx.x; i < B * k; i += ROWS) {
    const int b = i / k, j = i % k;
    cand[((size_t)blockIdx.x * B + b) * k + j] = kb[b * KP + j];
  }
}

// Launch 2: one block per query row merges the chunks' keys and writes
// the row's k best as values and ids.
__global__ void __launch_bounds__(MERGE_THREADS) topk_merge_kernel(
    int B, int k, int chunks, const u64* __restrict__ cand, float* __restrict__ vals,
    int* __restrict__ ids) {
  __shared__ u64 kept[2 * KP];
  __shared__ u64 fresh[MERGE_THREADS];
  __shared__ int cnt;
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < KP; i += blockDim.x) kept[i] = 0ull;
  int cur = 0;
  const long long total = (long long)chunks * k;
  for (long long c0 = 0; c0 < total; c0 += MERGE_THREADS) {
    if (threadIdx.x == 0) cnt = 0;
    __syncthreads();  // the zeroing, or the previous merge, is complete
    const long long c = c0 + threadIdx.x;
    bool in = false;
    if (c < total) {
      const u64 key = cand[((c / k) * B + b) * k + c % k];
      if (key > kept[cur * KP + k - 1]) {
        fresh[atomicAdd(&cnt, 1)] = key;
        in = true;
      }
    }
    if (__syncthreads_or(in)) {
      rank_merge(kept + cur * KP, fresh, MERGE_THREADS, &cnt, kept + (cur ^ 1) * KP, 1);
      cur ^= 1;
    }
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const u64 key = kept[cur * KP + j];
    vals[(size_t)b * k + j] = key ? key_value(key) : NEG_INF;
    ids[(size_t)b * k + j] = key ? key_id(key) : -1;
  }
}

// Shared memory of launch 1: two buffers of kept keys, the new keys of a
// tile, the queries, the staged tile and the counts.
size_t chunk_smem(int BQ, int H) {
  return (size_t)BQ * (2 * KP + ROWS) * sizeof(u64) + (size_t)BQ * (H + 4) * sizeof(float) +
         doc_tile::TILE_BYTES + BQ * sizeof(int);
}

template <typename T, typename TQ, int BQ>
int launch(int B, int H, int k, long long npad, long long n_valid, int tiles_per_chunk,
           const void* q, const void* docs, const float* scales, u64* cand, float* vals,
           int* ids, cudaStream_t stream) {
  auto kernel = topk_chunk_kernel<T, TQ, BQ>;
  const size_t smem = chunk_smem(BQ, H);
  if (smem > 48 * 1024) {
    // fails with cudaErrorInvalidValue where B and H need more than a block has
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch must not report it
      return (int)e;
    }
  }
  const long long tiles = npad / ROWS;
  const long long chunks = (tiles + tiles_per_chunk - 1) / tiles_per_chunk;
  kernel<<<(unsigned)chunks, ROWS, smem, stream>>>(
      B, H, k, npad, n_valid, tiles_per_chunk, static_cast<const TQ*>(q),
      static_cast<const T*>(docs), scales, cand);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  topk_merge_kernel<<<B, MERGE_THREADS, 0, stream>>>(B, k, (int)chunks, cand, vals, ids);
  return (int)cudaGetLastError();
}

template <typename T, typename TQ>
int dispatch_bq(int B, int H, int k, long long npad, long long n_valid, int tiles_per_chunk,
                const void* q, const void* docs, const float* scales, u64* cand, float* vals,
                int* ids, cudaStream_t s) {
  if (B <= 8)
    return launch<T, TQ, 8>(B, H, k, npad, n_valid, tiles_per_chunk, q, docs, scales, cand, vals,
                            ids, s);
  if (B <= 16)
    return launch<T, TQ, 16>(B, H, k, npad, n_valid, tiles_per_chunk, q, docs, scales, cand,
                             vals, ids, s);
  return launch<T, TQ, 32>(B, H, k, npad, n_valid, tiles_per_chunk, q, docs, scales, cand, vals,
                           ids, s);
}

}  // namespace

extern "C" {

// storage: 0 f32 docs and queries, 1 bf16 docs and queries, 2 int8 docs
// with scales [npad] f32 and bf16 queries. 1 <= B <= 32; 1 <= k <= 128;
// H a multiple of 16 bytes' worth of the storage dtype, and chunk_smem
// within a block's shared memory (at H = 1024, up to 16 query rows); npad a
// multiple of 128 below 2^31; cand: a workspace of ceil(npad / 128 / tiles_per_chunk)
// * B * k 64-bit keys. device: the CUDA ordinal the tensors live on.
// Returns cudaGetLastError() after the launches (0 on success).
int topk_stream_launch(int device, int storage, int B, int H, int k, long long npad,
                       long long n_valid, int tiles_per_chunk, const void* q, const void* docs,
                       const float* scales, void* cand, float* vals, int* ids, void* stream) {
  const int elem = storage == 0 ? 4 : storage == 1 ? 2 : 1;
  if (storage < 0 || storage > 2 || B < 1 || B > 32 || k < 1 || k > KP || H < 1 ||
      (H * elem) % 16 != 0 || npad < ROWS || npad % ROWS != 0 || npad >= (1ll << 31) ||
      tiles_per_chunk < 1 || (storage == 2) != (scales != nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* c = static_cast<u64*>(cand);
  if (storage == 0)
    return dispatch_bq<float, float>(B, H, k, npad, n_valid, tiles_per_chunk, q, docs, nullptr,
                                     c, vals, ids, s);
  if (storage == 1)
    return dispatch_bq<__nv_bfloat16, __nv_bfloat16>(B, H, k, npad, n_valid, tiles_per_chunk, q,
                                                     docs, nullptr, c, vals, ids, s);
  return dispatch_bq<int8_t, __nv_bfloat16>(B, H, k, npad, n_valid, tiles_per_chunk, q, docs,
                                            scales, c, vals, ids, s);
}

const char* topk_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
