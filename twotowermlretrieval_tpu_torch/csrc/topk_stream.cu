// Streaming exact top-k over the corpus: the running top-k kernels.
//
// Replaces two TPU kernels of twotowermlretrieval_tpu/ops/topk.py:
// - _fused_topk_kernel (called through fused_topk): docs [Npad, H] f32 or
//   bf16, queries q [B, H] in the same dtype (f32 at Precision.HIGHEST);
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
// 0.081 ms; 1 GiB in f32, 0.32 ms). The products, 2*B*H per row (six bf16
// products per f32 one), are far below the card's rate.
//
// Every score is packed with its row id into one 64-bit key that orders by
// value and then by the lower id, so all comparisons are one total order.
// Launch 1 gives each of its persistent blocks (as many a SM as shared
// memory allows, ops/topk.py scan_plan) a chunk of whole 128-row tiles.
// Tiles are scored on the tensor cores through doc_mma.cuh's ring of
// cp.async stages (the next stages' copies in flight while one is
// multiplied): bf16 and per-row int8 rows as bf16, f32 rows split into
// three bf16 pieces with six products (doc_mma.cuh, "The f32 path"), their
// query fragments split once a call by a first small launch and carried
// through the ring; bf16 and int8 query fragments stay resident in shared
// memory where that fits beside two blocks a SM, else ride the ring too
// (RING: packed once a call by the first launch), so 32 queries at every
// tower width take one pass. Per query row the block keeps its best k
// keys sorted in shared memory. A tile's key enters a list of new keys (a
// shared counter) only if it is strictly above the row's threshold:
// the larger of the block's own k-th key and a per-row threshold shared by
// all blocks in device memory (zeroed by the wrapper), which each block
// raises with atomicMax to its own k-th key whenever that improves. The
// result stays free of timing: keys are unique, a shared threshold is the
// k-th key of some block's list, so k keys are at least that large and a
// key strictly below it is not in the top k, while the key itself stays in
// its own block's list until k better ones replace it. So every key of the
// true top k reaches its block's final list in every run, and launch 2 picks
// the same k from the union. After each tile a warp a query row merges the
// new keys into the list: a few by rank (each key lands at its index in its
// own list plus the number of keys above it in the other), more by a
// bitonic sort in registers; whatever ranks k-th or lower drops. A tile
// none of whose keys passes costs one compare a key. Each block writes its
// k keys per query row to a workspace; launch 2, one block of 1024 threads
// per query row, keeps the chunks' keys at or above the row's final shared
// threshold and merges them (a block-wide sort and rank). k <= 128. Where
// the wrapper asks (many tiles, many query rows), both launches first run
// over a sample, every pilot_stride-th tile, and launch 2 leaves the
// sample's k-th key less one as the starting threshold (k keys of the
// corpus are at least that key, so the argument above holds), so that the
// main pass admits few keys and merges rarely.

#include "doc_mma.cuh"

namespace {

using doc_mma::ROWS;
typedef unsigned long long u64;

constexpr int KP = 128;                 // keys launch 2 keeps per query row; k <= KP
constexpr int MERGE_THREADS = 1024;     // chunk keys launch 2 reads at a time
constexpr int MERGE_FRESH = 2 * MERGE_THREADS;  // new keys launch 2 holds between merges
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

// Keys of arr [0, n), sorted descending, that are greater than key.
__device__ __forceinline__ int count_above(const u64* arr, int n, u64 key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (arr[mid] > key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Launch 2's merge, by the whole block: the row's kp kept keys (sorted
// descending, zeros at the end) and its c new keys fresh (any order, each
// above kept[kp-1], all distinct; room for the next power of two of them)
// into out, the kp largest sorted descending. The new keys are sorted first
// (a bitonic network over the next power of two, zeros filling the rest),
// then every key lands at its index in its own list plus the number of keys
// above it in the other (a binary search). Keys are distinct, so each
// position of out gets exactly one writer. Every thread of the block calls
// it, with c > 0; it ends with a barrier.
__device__ void block_merge(const u64* kept, u64* fresh, int c, u64* out, int kp) {
  int ln = 0;  // log2 of the power of two sorted
  while ((1 << ln) < c) ++ln;
  const int n = 1 << ln;
  for (int i = c + threadIdx.x; i < n; i += blockDim.x) fresh[i] = 0ull;
  __syncthreads();
  for (int ls = 1; ls <= ln; ++ls) {      // sorted runs of 2^ls
    for (int lj = ls - 1; lj >= 0; --lj) {  // partners 2^lj apart
      for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
        const int lo = ((i >> lj) << (lj + 1)) | (i & ((1 << lj) - 1));
        const u64 x = fresh[lo], y = fresh[lo + (1 << lj)];
        if ((x < y) == ((lo >> ls & 1) == 0)) {  // descending where bit ls of lo is 0
          fresh[lo] = y;
          fresh[lo + (1 << lj)] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < kp + c; i += blockDim.x) {
    const u64 key = i < kp ? kept[i] : fresh[i - kp];
    const int pos = i < kp ? i + count_above(fresh, c, key) : i - kp + count_above(kept, kp, key);
    if (pos < kp) out[pos] = key;
  }
  __syncthreads();
}

// Sorts the warp's 32 * E keys descending (E a power of two, 2^LE): key
// v[e] of lane l is element e * 32 + l. A bitonic network: partners within
// 32 elements trade through shuffles, partners further apart are two
// registers of one lane. Every loop has a constant trip count, so it unrolls
// and v stays in registers.
template <int E>
__device__ __forceinline__ void warp_sort_desc(u64 (&v)[E]) {
  constexpr int LE = E == 1 ? 0 : E == 2 ? 1 : E == 4 ? 2 : E == 8 ? 3 : 4;
  static_assert(1 << LE == E && E <= 16, "E: a power of two up to 16");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ls = 1; ls <= 5 + LE; ++ls) {  // sorted runs of 2^ls
#pragma unroll
    for (int lj = ls - 1; lj >= 0; --lj) {  // partners 2^lj apart
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const bool desc = (((e << 5) | lane) >> ls & 1) == 0;  // this pair's order
        if (lj >= 5) {
          const int pe = e ^ (1 << (lj - 5));  // the partner, in this lane
          if (pe > e) {
            const u64 x = v[e], y = v[pe];
            if ((x < y) == desc) {
              v[e] = y;
              v[pe] = x;
            }
          }
        } else {
          const u64 y = __shfl_xor_sync(0xffffffffu, v[e], 1 << lj);
          const bool first = (lane >> lj & 1) == 0;  // this lane holds the pair's first element
          const u64 hi = v[e] > y ? v[e] : y, lo = v[e] > y ? y : v[e];
          v[e] = first == desc ? hi : lo;
        }
      }
    }
  }
}

// One warp merges a row's kp kept keys (sorted descending, zeros at the
// end) with its c new keys (any order, distinct from the kept), the nonzero
// kept and the new keys at most 32 * E, into out: the kp largest, sorted
// descending.
template <int E>
__device__ __forceinline__ void warp_merge_e(const u64* kept, const u64* fresh, int c, u64* out,
                                             int kp) {
  const int lane = threadIdx.x & 31;
  const int m = count_above(kept, kp, 0ull);  // the kept keys; zeros fill the rest
  u64 v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    v[e] = i < m ? kept[i] : i - m < c ? fresh[i - m] : 0ull;
  }
  warp_sort_desc<E>(v);
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (e * 32 + lane < kp) out[e * 32 + lane] = v[e];
}

// One warp merges a row's kp kept keys (sorted descending, zeros at the
// end) with its c <= ROWS new keys (any order, distinct from the kept) into
// out, the kp largest sorted descending. Up to 32 new keys by rank, in
// registers: lane l holds kept keys l, l + 32, ... and new key l, and for
// each new key (a shuffle) every kept key below it moves down one place,
// while the new key lands at the count of kept and new keys above it (two
// ballots); more new keys by a sort over the fewest registers that hold
// them and the nonzero kept keys (<= 256).
__device__ __noinline__ void warp_merge(const u64* kept, const u64* fresh, int c, u64* out,
                                        int kp) {
  const int lane = threadIdx.x & 31;
  if (c <= 32) {
    u64 kv[KP / 32];
    int pk[KP / 32];
#pragma unroll
    for (int q = 0; q < KP / 32; ++q) {
      const int i = q * 32 + lane;
      kv[q] = i < kp ? kept[i] : 0ull;
      pk[q] = i;
    }
    const u64 f = lane < c ? fresh[lane] : 0ull;
    int pf = 0;
    for (int j = 0; j < c; ++j) {
      const u64 fj = __shfl_sync(0xffffffffu, f, j);
      int above = __popc(__ballot_sync(0xffffffffu, lane < c && f > fj));
#pragma unroll
      for (int q = 0; q < KP / 32; ++q) {
        pk[q] += fj > kv[q];  // zeros (empty places) move down too
        above += __popc(__ballot_sync(0xffffffffu, kv[q] > fj));
      }
      if (lane == j) pf = above;
    }
#pragma unroll
    for (int q = 0; q < KP / 32; ++q)
      if (q * 32 + lane < kp && pk[q] < kp) out[pk[q]] = kv[q];
    if (lane < c && pf < kp) out[pf] = f;
    return;
  }
  const int n = count_above(kept, kp, 0ull) + c;
  if (n <= 64) warp_merge_e<2>(kept, fresh, c, out, kp);
  else if (n <= 128) warp_merge_e<4>(kept, fresh, c, out, kp);
  else warp_merge_e<8>(kept, fresh, c, out, kp);
}

// A block's running lists in shared memory: kept [2][B][k] (two buffers),
// a tile's new keys fresh [B][ROWS] and their counts cnt [B], and the
// thresholds a key must beat, thr_s [B].
struct Lists {
  u64* kept;
  u64* fresh;
  u64* thr_s;
  int* cnt;
  unsigned which;  // bit r: the buffer of kept that holds row r's keys (block-uniform)
  u64 pending;     // threads < B: the shared threshold of row threadIdx.x, loaded a tile ago

  __host__ __device__ static size_t bytes(int B, int k) {
    return (size_t)B * (2 * k + ROWS + 1) * sizeof(u64) +
           recur_chain::a16((size_t)B * sizeof(int));
  }
  __device__ void carve(unsigned char* at, int B, int k) {
    kept = reinterpret_cast<u64*>(at);
    fresh = kept + 2 * B * k;
    thr_s = fresh + B * ROWS;
    cnt = reinterpret_cast<int*>(thr_s + B);
    which = 0u;
  }
  // Row r's kept keys: in buffer `side` (0, 1) of kept.
  __device__ u64* row(int r, int B, int k, unsigned side) const {
    return kept + ((size_t)side * B + r) * k;
  }
  // Every thread calls it; the caller's barrier orders it before any offer.
  // The thresholds start at the shared ones (a pilot's, or zero).
  __device__ void init(int B, int k, const u64* thr) {
    for (int i = threadIdx.x; i < 2 * B * k; i += blockDim.x) kept[i] = 0ull;
    if (threadIdx.x < B) {
      pending = *reinterpret_cast<const volatile u64*>(thr + threadIdx.x);
      thr_s[threadIdx.x] = pending;
      cnt[threadIdx.x] = 0;
    }
  }
  // Whether the key of query row b (on a valid row and column: live) beats
  // the row's threshold.
  __device__ bool beats(int b, u64 key, bool live) const { return live && key > thr_s[b]; }
  // Holds a key of query row b that beats its threshold.
  __device__ void hold(int b, u64 key) { fresh[b * ROWS + atomicAdd(&cnt[b], 1)] = key; }
  // After every thread offered a tile's keys: merge them into the rows that
  // got any (a warp a row, into the row's other buffer), raise the shared
  // thresholds thr [B] to those rows' new k-th keys, then refresh thr_s from
  // the k-th key and the shared threshold read a tile ago (so no thread
  // waits for that read) and clear the counts. Every thread calls it (B <=
  // blockDim.x); the next tile's barrier orders its writes before the next
  // offers.
  __device__ void close_tile(int B, int k, u64* thr) {
    __syncthreads();  // the offers are complete
    unsigned got = 0;  // rows with new keys
    for (int r = 0; r < B; ++r) got |= (unsigned)(cnt[r] > 0) << r;
    if (got) {
      const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
      for (int r = 0, i = 0; r < B; ++r) {
        if (!(got >> r & 1)) continue;
        if (i++ % warps == warp) {
          const unsigned side = which >> r & 1;
          warp_merge(row(r, B, k, side), fresh + r * ROWS, cnt[r], row(r, B, k, side ^ 1), k);
        }
      }
      __syncthreads();
      which ^= got;
    }
    const int b = threadIdx.x;
    if (b < B) {
      const u64 own = row(b, B, k, which >> b & 1)[k - 1];
      if (got >> b & 1) {
        if (own) atomicMax(thr + b, own);
        cnt[b] = 0;
      }
      thr_s[b] = own > pending ? own : pending;
      pending = *reinterpret_cast<volatile u64*>(thr + b);
    }
  }
  // The block's k keys per query row into cand [gridDim.x][B][k].
  __device__ void write(int B, int k, u64* cand) const {
    for (int i = threadIdx.x; i < B * k; i += blockDim.x)
      cand[(size_t)blockIdx.x * B * k + i] = row(i / k, B, k, which >> (i / k) & 1)[i % k];
  }
};

// Launch 1: the k best keys of each chunk of tiles_per_chunk tiles, per
// query row, into cand [chunks][B][k]; the tiles are every stride-th of the
// corpus (1: all of them; a pilot's sample: more). Each tile is scored on
// the tensor cores (doc_mma.cuh): bf16 (T = bf16) or per-row int8 (T =
// int8_t, scales [npad]) rows with bf16 queries q, or f32 rows (T =
// float); NT = ceil(B / 8). RING (always with f32): the query fragments
// qring in device memory (launch_query_frags) ride the ring; else each
// block builds them from q into shared memory.
template <typename T, int NT, bool RING>
__global__ void __launch_bounds__(doc_mma::THREADS, 3) topk_chunk_mma_kernel(
    int B, int H, int k, long long npad, long long n_valid, int tiles_per_chunk, int stride,
    int stages, const __nv_bfloat16* __restrict__ q, const uint2* __restrict__ qring,
    const T* __restrict__ docs, const float* __restrict__ scales, u64* __restrict__ thr,
    u64* __restrict__ cand) {
  using namespace doc_mma;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nck = chunks_of(H * (int)sizeof(T));
  unsigned char* ring = smem;  // [stages][stage_bytes<T, RING>(NT)]
  unsigned char* after = smem + (size_t)stages * stage_bytes<T, RING>(NT);
  uint2* qf = reinterpret_cast<uint2*>(after);  // [nck * K][NT][32], unless they ride the ring
  Lists lists;
  lists.carve(after + (RING ? 0 : qfrag_bytes(nck, Steps<T>::K, NT)), B, k);
  lists.init(B, k, thr);
  if constexpr (RING) qf = const_cast<uint2*>(qring);
  else load_query_frags<T>(q, B, H, nck, NT, qf);

  const long long first = (long long)blockIdx.x * tiles_per_chunk;
  long long tiles = (npad / ROWS + stride - 1) / stride - first;  // of this launch's tiles
  if (tiles > tiles_per_chunk) tiles = tiles_per_chunk;
  if (tiles < 0) tiles = 0;
  auto row0_of = [&](long long i) { return (first + i) * stride * ROWS; };
  auto done = [&](long long row0, float (&acc)[2][NT][4]) {
    // the key of accumulator element (st, h, j, c): its row, its scaled score
    auto key_of = [&](int st, int h, int j, int c, float sc) {
      const float v = acc[st][j][2 * h + c];
      return make_key(scales != nullptr ? v * sc : v, row0 + acc_row(st, 2 * h));
    };
    float sc[2][2];
    unsigned pass = 0;  // one bit an element: it beats its threshold
#pragma unroll
    for (int st = 0; st < 2; ++st) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8
        const long long row = row0 + acc_row(st, 2 * h);
        sc[st][h] = scales != nullptr && row < n_valid ? scales[row] : 1.0f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = acc_col(j, c), bit = ((st * 2 + h) * NT + j) * 2 + c;
            pass |= (unsigned)lists.beats(col, key_of(st, h, j, c, sc[st][h]),
                                          col < B && row < n_valid) << bit;
          }
      }
    }
    if (pass) {  // once the lists are good, most threads hold nothing
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (pass >> (((st * 2 + h) * NT + j) * 2 + c) & 1)
                lists.hold(acc_col(j, c), key_of(st, h, j, c, sc[st][h]));
    }
    lists.close_tile(B, k, thr);
  };
  scan_tiles<T, NT, RING>(docs, H, stages, tiles, row0_of, ring, qf, done);
  __syncthreads();
  lists.write(B, k, cand);
}

// Launch 2: one block per query row merges the chunks' keys and writes
// the row's k best as values and ids. Only keys above the row's final
// shared threshold thr[b] can rank, or equal to it where a block published
// it (launch 1 is complete), so few keys are left; they gather,
// MERGE_THREADS at a time, and are merged when the next batch could
// overflow or at the end. After a pilot (pilot 1) it writes no result:
// thr[b] becomes the k-th key of the sample less one, since k keys of the
// corpus are at least that key and the key itself must still pass.
__global__ void __launch_bounds__(MERGE_THREADS) topk_merge_kernel(
    int B, int k, int chunks, int pilot, u64* __restrict__ thr, const u64* __restrict__ cand,
    float* __restrict__ vals, int* __restrict__ ids) {
  __shared__ u64 kept[2 * KP];
  __shared__ u64 fresh[MERGE_FRESH];
  __shared__ int cnt;
  const int b = blockIdx.x;
  const u64 least = thr[b];
  for (int i = threadIdx.x; i < KP; i += blockDim.x) kept[i] = 0ull;
  if (threadIdx.x == 0) cnt = 0;
  int cur = 0;
  const long long total = (long long)chunks * k;
  for (long long c0 = 0; c0 < total; c0 += MERGE_THREADS) {
    __syncthreads();  // the zeroing, or the previous merge, is complete
    const long long c = c0 + threadIdx.x;
    if (c < total) {
      const u64 key = cand[((c / k) * B + b) * k + c % k];
      if (key >= least && key > kept[cur * KP + k - 1]) fresh[atomicAdd(&cnt, 1)] = key;
    }
    __syncthreads();
    const bool last = c0 + MERGE_THREADS >= total;
    if (cnt > (last ? 0 : MERGE_FRESH - MERGE_THREADS)) {  // block-uniform
      block_merge(kept + cur * KP, fresh, cnt, kept + (cur ^ 1) * KP, KP);
      cur ^= 1;
      if (threadIdx.x == 0) cnt = 0;
    }
  }
  __syncthreads();
  if (pilot) {
    if (threadIdx.x == 0) {
      const u64 kth = kept[cur * KP + k - 1];
      thr[b] = kth ? kth - 1 : 0ull;
    }
    return;
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const u64 key = kept[cur * KP + j];
    vals[(size_t)b * k + j] = key ? key_value(key) : NEG_INF;
    ids[(size_t)b * k + j] = key ? key_id(key) : -1;
  }
}

// Shared memory of launch 1 (ops/topk.py scan_plan mirrors it): the ring,
// the query fragments (unless they ride the ring: RING) and the lists.
template <typename T, int NT, bool RING>
size_t mma_smem(int stages, int B, int H, int k) {
  return doc_mma::scan_smem<T, RING>(stages, H, NT) + Lists::bytes(B, k);
}

int allow_smem(const void* kernel, size_t smem) {
  if (smem > (size_t)recur_chain::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) cudaGetLastError();  // the next launch must not report it
  return (int)e;
}

struct Args {
  int B, H, k;
  long long npad, n_valid;
  int tiles_per_chunk, stages, pilot_stride, pilot_tiles_per_chunk;
  const void *q, *docs;
  const float* scales;
  u64 *thr, *cand;
  float* vals;
  int* ids;
  uint2* qf;
  cudaStream_t stream;
  // blocks of a launch over every stride-th tile, tiles_per_chunk each
  int chunks(int per, int stride) const {
    const long long tiles = (npad / ROWS + stride - 1) / stride;
    return (int)((tiles + per - 1) / per);
  }
};

// Launch 1 (chunk: a kernel launcher of (blocks, tiles a block, stride)),
// then launch 2; first over a pilot's sample where pilot_stride > 1.
template <typename Chunk>
int run(const Args& a, Chunk chunk) {
  for (const bool pilot : {true, false}) {
    if (pilot && a.pilot_stride <= 1) continue;
    const int per = pilot ? a.pilot_tiles_per_chunk : a.tiles_per_chunk;
    const int stride = pilot ? a.pilot_stride : 1;
    chunk(a.chunks(per, stride), per, stride);
    if (const cudaError_t e = cudaGetLastError()) return (int)e;
    topk_merge_kernel<<<a.B, MERGE_THREADS, 0, a.stream>>>(
        a.B, a.k, a.chunks(per, stride), (int)pilot, a.thr, a.cand, a.vals, a.ids);
    if (const cudaError_t e = cudaGetLastError()) return (int)e;
  }
  return 0;
}

template <typename T, int NT, bool RING>
int launch_mma(const Args& a) {
  auto kernel = topk_chunk_mma_kernel<T, NT, RING>;
  const size_t smem = mma_smem<T, NT, RING>(a.stages, a.B, a.H, a.k);
  if (const int e = allow_smem((const void*)kernel, smem)) return e;
  if constexpr (RING) {
    const int e = doc_mma::launch_query_frags<T, NT>(a.q, a.B, a.H, a.qf, a.stream);
    if (e) return e;
  }
  return run(a, [&](int blocks, int per, int stride) {
    kernel<<<blocks, doc_mma::THREADS, smem, a.stream>>>(
        a.B, a.H, a.k, a.npad, a.n_valid, per, stride, a.stages,
        doc_mma::kSplit<T> ? nullptr : static_cast<const __nv_bfloat16*>(a.q), a.qf,
        static_cast<const T*>(a.docs), a.scales, a.thr, a.cand);
  });
}

template <typename T, bool RING>
int dispatch_mma(const Args& a) {
  switch ((a.B + 7) / 8) {
    case 1: return launch_mma<T, 1, RING>(a);
    case 2: return launch_mma<T, 2, RING>(a);
    case 3: return launch_mma<T, 3, RING>(a);
    default: return launch_mma<T, 4, RING>(a);
  }
}

// bf16 and int8 rows: RING where the wrapper passes a workspace for the
// packed query fragments
template <typename T>
int dispatch_route(const Args& a) {
  return a.qf != nullptr ? dispatch_mma<T, true>(a) : dispatch_mma<T, false>(a);
}

}  // namespace

extern "C" {

// storage: 0 f32 docs and queries, 1 bf16 docs and queries, 2 int8 docs
// with scales [npad] f32 and bf16 queries. 1 <= B <= 32; 1 <= k <= 128;
// H a multiple of 16 bytes' worth of the storage dtype; npad a multiple of
// 128 below 2^31. tiles_per_chunk (the grid is ceil(npad / 128 /
// tiles_per_chunk) blocks) and stages (2-4) come from
// ops/topk.py scan_plan, and a layout beyond a block's shared memory is
// refused. pilot_stride > 1 first runs both launches over every
// pilot_stride-th tile (pilot_tiles_per_chunk a block), whose k-th key
// seeds the shared thresholds. thr: B 64-bit keys, zero; cand: a workspace
// of the larger grid * B * k 64-bit keys; qf: a workspace for the query
// fragments that ride the ring (a first launch writes them): f32 always,
// ceil(H / 32) * 6 * ceil(B / 8) * 256 bytes (three split pieces); bf16 and
// int8 where the plan's fragments ride the ring, ceil(H * elem / 128) * (4
// bf16, 8 int8) * ceil(B / 8) * 256 bytes; null where they stay resident.
// device: the CUDA ordinal the tensors live on. Returns cudaGetLastError()
// after the launches (0 on success).
int topk_stream_launch(int device, int storage, int B, int H, int k, long long npad,
                       long long n_valid, int tiles_per_chunk, int stages, int pilot_stride,
                       int pilot_tiles_per_chunk, const void* q, const void* docs,
                       const float* scales, void* thr, void* cand, float* vals, int* ids,
                       void* qf, void* stream) {
  const int elem = storage == 0 ? 4 : storage == 1 ? 2 : 1;
  if (storage < 0 || storage > 2 || B < 1 || B > 32 || k < 1 || k > KP || H < 1 ||
      (H * elem) % 16 != 0 || npad < ROWS || npad % ROWS != 0 || npad >= (1ll << 31) ||
      tiles_per_chunk < 1 || pilot_stride < 1 ||
      (pilot_stride > 1 && pilot_tiles_per_chunk < 1) || (storage == 2) != (scales != nullptr) ||
      (storage == 0 && qf == nullptr) || stages < 2 || stages > 4)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const Args a{B, H, k, npad, n_valid, tiles_per_chunk, stages, pilot_stride,
               pilot_tiles_per_chunk, q, docs, scales,
               static_cast<u64*>(thr), static_cast<u64*>(cand), vals, ids,
               static_cast<uint2*>(qf), static_cast<cudaStream_t>(stream)};
  if (storage == 1) return dispatch_route<__nv_bfloat16>(a);
  if (storage == 2) return dispatch_route<int8_t>(a);
  return dispatch_mma<float, true>(a);
}

const char* topk_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
