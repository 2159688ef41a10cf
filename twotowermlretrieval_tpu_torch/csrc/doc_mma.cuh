// Tensor-core scoring of 128-row tiles of the corpus against up to 32
// queries, fed through a ring of cp.async stages. Shared by the bf16,
// per-row int8 and f32 scans of segmax.cu and topk_stream.cu (f32 below,
// "The f32 path") and by the s8 x s8 scan of segmax_s8.cu ("The s8 x s8
// path").
//
// A block of 128 threads (4 warps) scores one tile of ROWS = 128 doc rows
// at a time; warp w owns rows 32w .. 32w + 31 as two m16 tiles of
// mma.sync.m16n8k16 (bf16 in, f32 accumulation), the queries are the n side
// in NT = ceil(B / 8) n8 tiles. A bf16 times a bf16, and an int8 (exact in
// bf16, |v| <= 127) times a bf16, is exact in f32, so only the order of the
// f32 sums differs from a plain f32 product.
//
// Staging: a stage holds CHUNK = 128 bytes of each of the tile's 128 rows
// (64 bf16, 128 int8 or 32 f32 columns, 16 KiB), copied with 16-byte cp.async,
// eight threads a row. Bytes past the end of a row are zero-filled by the
// copy (src-size 0), so a k-tail short of a whole stage (H = 8, 24, 40 ...)
// multiplies zeros. Each thread reads whole 16-byte chunks of rows g and
// g + 8 of an m tile (g = lane / 4, chunk t + 4i for the lane's t = lane %
// 4), and a 16-byte chunk carries two k16 steps of bf16 (four of int8): the
// k positions of the mma are a permutation of the columns, the same one for
// the doc (A) and the query (B) fragments, so the sum is unchanged. The
// lanes of one 8-lane phase read rows g and g + 1, which hit the same four
// chunk positions unless the stage is swizzled: logical chunk c of row r
// lies at physical chunk c ^ ((r & 1) << 2), so each phase covers all 32
// banks.
//
// The query fragments (b0, b1 of every k16 step and n tile, in lane order)
// are read back with one 8-byte load a lane from shared memory:
// conflict-free, and free of the register pressure of holding 16 k steps x
// 4 n tiles in every thread. They take one of two routes (RING, a template
// argument of scan_tiles, stage_bytes and scan_smem). Resident: each block
// builds every stage's fragments once from device memory and keeps them,
// which takes shared memory that grows with H and B (53 stages x 4 k16
// steps x 4 n tiles x 256 bytes = 217,088 bytes at bf16 H=3360, B=32).
// Riding the ring: a small launch (pack_query_frags) writes them once a
// call to device memory in the same lane order, and each stage of the ring
// carries its columns' fragments after its 16 KiB of rows (4 KiB at bf16,
// 8 KiB at int8, four n tiles), so a block's shared memory does not grow
// with H and the corpus is read once at every width. Both routes feed
// score_stage the same words in the same order: the same bits.
//
// The f32 path: f32 rows times f32 queries with the precision of an f32
// product, as the JAX f32 scans ask (Precision.HIGHEST, which the TPU's
// MXU computes from bf16 pieces in several passes). Every f32 value x
// splits exactly into three bf16 pieces, x = hi + mid + lo: hi = bf16(x),
// mid = bf16(x - hi), lo = x - hi - mid, each rounded to nearest even
// (8 significant bits each and the signs of the remainders cover f32's
// 24, and bf16 has f32's exponent range). The kernel takes the six
// leading products, mid.mid, lo.hi, hi.lo, mid.hi, hi.mid, hi.hi (XLA's
// six-pass HIGHEST), each one mma.sync m16n8k16 with f32 accumulation,
// and drops mid.lo, lo.mid and lo.lo. |mid| <= 2^-8 (1 + 2^-8) |x| and
// |lo| <= 2^-16 |x|, so the dropped terms of one product x.y are at most
// (2^-23 (1 + 2^-8) + 2^-32) |x||y| < 2^-23 (1 + 2^-7) |x||y|. A score is
// then within 2^-23 (1 + 2^-7) sum_k |x_k y_k| of the exact dot product,
// plus the rounding of its f32 sum of 6H exact bf16 products (at most
// 6H 2^-24 sum_k |x_k y_k| in any order, far less in practice): for unit
// rows, within 1.21e-7 plus that rounding. ops/topk.py split_bf16x3 and
// split_scores are the same arithmetic on the CPU.
//
// An f32 stage holds 32 columns of each row, two k16 steps: lane (g, t)
// reads 16-byte chunk t + 4m of rows g and g + 8 (the bf16 path's swizzled
// chunks), whose four floats are its k slots 2t, 2t + 1 (a0 / a1) and
// 2t + 8, 2t + 9 (a2 / a3) of step m, and splits them in registers. The
// query fragments hold the three pieces of each (k16 step, n tile, lane);
// they are too large to stay resident at wide H (1,536 bytes a stage an n
// tile), so a small launch (split_query_frags) writes them once a call to
// device memory, and each stage of the ring carries its columns' fragments
// after its 16 KiB of rows: the corpus is read once at every width, and
// the shared memory a block needs does not grow with H.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "recur_chain.cuh"

namespace doc_mma {

constexpr int ROWS = 128;   // rows of a tile (a whole 128-row segment)
constexpr int WARPS = 4;    // two m16 tiles a warp
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 128;  // bytes of each row a stage holds
constexpr int STAGE_BYTES = ROWS * CHUNK;

// k16 steps a stage carries: 4 over 64 bf16 columns, 8 over 128 int8 ones,
// 2 over 32 f32 ones
template <typename T> struct Steps;
template <> struct Steps<__nv_bfloat16> { static constexpr int K = 4; };
template <> struct Steps<int8_t> { static constexpr int K = 8; };
template <> struct Steps<float> { static constexpr int K = 2; };

// The f32 path: its values split into PIECES bf16 pieces
// (recur_chain.cuh split_bf16x3); its query fragments always ride the ring
// (three pieces each do not fit resident at wide H).
template <typename T> constexpr bool kSplit = std::is_same<T, float>::value;
using recur_chain::PIECES;
// uint2 words of query fragment a (k16 step, n tile, lane): one, or one a
// piece on the f32 path
template <typename T> constexpr int kPieces = kSplit<T> ? PIECES : 1;

// The s8 x s8 path (segmax_s8.cu): int8 rows times int8 queries on
// mma.sync.m16n8k32 with int32 accumulators, exact in any order. Its
// fragments hold the same bytes as the bf16 path's (a register is 4 bytes
// of a row or of a query column, a step 32 bytes of k), so a stage carries
// 4 k32 steps, a 16-byte chunk two of them, the lanes read the same
// swizzled chunks, and the k permutation is the bf16 one counted in bytes.
// S8 tags its doc rows (one byte a column); Acc is each path's accumulator.
struct S8 { int8_t v; };
template <> struct Steps<S8> { static constexpr int K = 4; };  // k32 steps
template <typename T> struct Acc { using type = float; };
template <> struct Acc<S8> { using type = int; };

__host__ __device__ constexpr int chunks_of(int row_bytes) {
  return (row_bytes + CHUNK - 1) / CHUNK;
}

// Shared memory of the query fragments: a uint2 per (k16 step, n tile, lane).
__host__ __device__ constexpr size_t qfrag_bytes(int nchunks, int ksteps, int nt) {
  return (size_t)nchunks * ksteps * nt * 32 * 8;
}

// Bytes of one stage's query fragments: a uint2 per (k16 step, piece, n
// tile, lane).
template <typename T>
__host__ __device__ constexpr int frag_stage_bytes(int nt) {
  return (int)qfrag_bytes(1, Steps<T>::K * kPieces<T>, nt);
}

// Bytes of one stage of the ring: 128 bytes of each of the tile's rows,
// then, where the fragments ride the ring (RING), the stage's query
// fragments.
template <typename T, bool RING = kSplit<T>>
__host__ __device__ constexpr int stage_bytes(int nt) {
  return STAGE_BYTES + (RING ? frag_stage_bytes<T>(nt) : 0);
}

__device__ __forceinline__ int swz(int row, int c) { return c ^ ((row & 1) << 2); }

// 16 bytes to shared memory; src_bytes 0 zero-fills them
__device__ __forceinline__ void cp_async16_zfill(void* smem_dst, const void* gmem_src,
                                                 int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(src_bytes));
}

// cp.async.wait_group with a count known only at run time (stages - 2;
// the s8 scan's deeper rings up to 8 stages)
__device__ __forceinline__ void wait_stages(int pending) {
  switch (pending) {
    case 0: recur_chain::cp_async_wait<0>(); break;
    case 1: recur_chain::cp_async_wait<1>(); break;
    case 3: recur_chain::cp_async_wait<3>(); break;
    case 4: recur_chain::cp_async_wait<4>(); break;
    case 5: recur_chain::cp_async_wait<5>(); break;
    case 6: recur_chain::cp_async_wait<6>(); break;
    default: recur_chain::cp_async_wait<2>(); break;
  }
}

// Stage chunk kc (bytes [kc * CHUNK, kc * CHUNK + CHUNK)) of rows row0 ..
// row0 + 127 into buf. Every thread of the block calls it and then commits.
__device__ __forceinline__ void stage(const unsigned char* __restrict__ docs, long long row0,
                                      int kc, int row_bytes, unsigned char* buf) {
#pragma unroll
  for (int j = 0; j < ROWS * CHUNK / 16 / THREADS; ++j) {
    const int i = j * THREADS + threadIdx.x;
    const int r = i >> 3, c = i & 7;
    const int off = kc * CHUNK + c * 16;
    const unsigned char* src = docs + (size_t)(row0 + r) * row_bytes;
    const bool in = off < row_bytes;
    cp_async16_zfill(buf + r * CHUNK + swz(r, c) * 16, in ? src + off : src, in ? 16 : 0);
  }
}

// q[n][col], q[n][col + 1] as a bf16 pair (zero past B rows and H columns)
__device__ __forceinline__ uint32_t pack_bf16(const __nv_bfloat16* q, int n, int col, int B,
                                              int H) {
  const unsigned short lo = (n < B && col < H) ? __bfloat16_as_ushort(q[(size_t)n * H + col]) : 0;
  const unsigned short hi =
      (n < B && col + 1 < H) ? __bfloat16_as_ushort(q[(size_t)n * H + col + 1]) : 0;
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// The first column a lane's k slots (2t, 2t + 1 | 2t + 8, 2t + 9) of k16
// step m of a stage map to: four consecutive columns, the first two for
// b0 (a0, a1), the last two for b1 (a2, a3).
template <typename T>
__device__ __forceinline__ int slot_col(int m, int t) {
  if constexpr (sizeof(T) == 4) {
    return 4 * (t + 4 * m);  // chunk t + 4m
  } else if constexpr (sizeof(T) == 2) {
    return 8 * (t + 4 * (m >> 1)) + 4 * (m & 1);  // chunk t + 4 (m / 2), half m % 2
  } else {
    return 16 * (t + 4 * (m >> 2)) + 4 * (m & 3);  // chunk t + 4 (m / 4), word m % 4
  }
}

// Query fragment i of q [B, H] bf16 for T rows (bf16, or int8 scored as
// bf16): for k16 step m of stage kc, n tile j and lane (g, t), i = ((kc *
// KS + m) * nt + j) * 32 + lane holds query row j * 8 + g at the four
// columns of slot_col<T>(m, t) as b0 and b1 (zeros past B rows and H
// columns). Stage kc's fragments are one contiguous run.
template <typename T>
__device__ __forceinline__ uint2 query_frag(const __nv_bfloat16* __restrict__ q, int B, int H,
                                            int nt, int i) {
  constexpr int KS = Steps<T>::K;
  constexpr int COLS = CHUNK / (int)sizeof(T);  // columns a stage holds
  const int lane = i & 31, j = (i >> 5) % nt, step = (i >> 5) / nt;
  const int kc = step / KS, m = step % KS;
  const int n = j * 8 + (lane >> 2);
  const int col = kc * COLS + slot_col<T>(m, lane & 3);
  return make_uint2(pack_bf16(q, n, col, B, H), pack_bf16(q, n, col + 2, B, H));
}

// Build the query fragments of q [B, H] bf16 into qf, resident (the
// shared-memory route). Every thread calls it; the caller's first barrier
// orders it before any read.
template <typename T>
__device__ __forceinline__ void load_query_frags(const __nv_bfloat16* __restrict__ q, int B,
                                                 int H, int nchunks, int nt, uint2* qf) {
  const int total = nchunks * Steps<T>::K * nt * 32;
  for (int i = threadIdx.x; i < total; i += THREADS) qf[i] = query_frag<T>(q, B, H, nt, i);
}

// The same fragments into qf in device memory, once a call, for a scan
// whose fragments ride the ring: one thread a fragment.
template <typename T, int NT>
__global__ void __launch_bounds__(256) pack_query_frags(const __nv_bfloat16* __restrict__ q,
                                                        int B, int H, int nchunks,
                                                        uint2* __restrict__ qf) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nchunks * Steps<T>::K * NT * 32) qf[i] = query_frag<T>(q, B, H, NT, i);
}

// The s8 query fragments of q [B, H] int8 into qf: for lane (g, t) of
// k32 step m of stage kc and n tile j, the 4 bytes of query row j * 8 + g
// at the columns of the doc's a0 (b0) and a2 (b1) words, slot_col<bf16>
// counted in bytes (zeros past B rows and H columns; H is a multiple of 16,
// so a word is wholly in or out). Every thread calls it; the caller's first
// barrier orders it before any read.
__device__ __forceinline__ void load_query_frags_s8(const int8_t* __restrict__ q, int B, int H,
                                                    int nchunks, int nt, uint2* qf) {
  constexpr int KS = Steps<S8>::K;
  const int total = nchunks * KS * nt * 32;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int lane = i & 31, j = (i >> 5) % nt, step = (i >> 5) / nt;
    const int kc = step / KS, m = step % KS;
    const int n = j * 8 + (lane >> 2);
    const int col = kc * CHUNK + 2 * slot_col<__nv_bfloat16>(m, lane & 3);
    const int8_t* row = q + (size_t)n * H;
    const uint32_t w0 = (n < B && col < H) ? *reinterpret_cast<const uint32_t*>(row + col) : 0u;
    const uint32_t w1 =
        (n < B && col + 4 < H) ? *reinterpret_cast<const uint32_t*>(row + col + 4) : 0u;
    qf[i] = make_uint2(w0, w1);
  }
}

// d += a . b, one m16n8k32 tile: s8 operands, s32 accumulation (exact:
// the sums stay far below 2^31)
__device__ __forceinline__ void mma_s8(int* d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four int8 values (one 32-bit word, lowest column first) as two bf16
// pairs, exactly: each byte v becomes the float 2^23 + 128 + v (its bits
// built with a byte permute), minus 2^23 + 128; |v| <= 127 fits bf16's 8
// significant bits, so the bf16 is the float's top half.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t x = w ^ 0x80808080u;  // v + 128, unsigned
  const float bias = 8388736.0f;        // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540)) - bias;
  const float f1 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7541)) - bias;
  const float f2 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7542)) - bias;
  const float f3 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7543)) - bias;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

using recur_chain::split_bf16x3;

// The f32 query fragments of q [B, H] f32 into qf in device memory (zeros
// past B rows and H columns), for nchunks stages of 32 columns and NT n
// tiles: for k16 step m of stage kc, piece p, n tile j and lane (g, t),
// qf[(((kc * 2 + m) * PIECES + p) * NT + j) * 32 + lane] holds piece p of
// query row j * 8 + g at the four columns of slot_col<float>(m, t) as its
// b0 and b1, so stage kc's fragments are one contiguous run that rides the
// ring beside the stage's rows. One thread a (step, n tile, lane); H is a
// multiple of 4, so a lane's four columns are wholly in or out, and q rows
// are 16-byte aligned.
template <int NT>
__global__ void __launch_bounds__(256) split_query_frags(const float* __restrict__ q, int B,
                                                         int H, int nchunks,
                                                         uint2* __restrict__ qf) {
  constexpr int KS = Steps<float>::K;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nchunks * KS * NT * 32) return;
  const int lane = i & 31, j = (i >> 5) % NT, step = (i >> 5) / NT;  // step = kc * KS + m
  const int n = j * 8 + (lane >> 2);
  const int col = (step / KS) * 32 + slot_col<float>(step % KS, lane & 3);
  const float4 v = (n < B && col < H) ? *reinterpret_cast<const float4*>(q + (size_t)n * H + col)
                                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  uint32_t b0[PIECES], b1[PIECES];
  split_bf16x3(v.x, v.y, b0);
  split_bf16x3(v.z, v.w, b1);
#pragma unroll
  for (int p = 0; p < PIECES; ++p)
    qf[((size_t)(step * PIECES + p) * NT + j) * 32 + lane] = make_uint2(b0[p], b1[p]);
}

// Write the query fragments of a T scan at width H whose fragments ride
// the ring into qf, once a call: split_query_frags on the f32 path (q f32),
// else pack_query_frags (q bf16). Returns cudaGetLastError().
template <typename T, int NT>
int launch_query_frags(const void* q, int B, int H, uint2* qf, cudaStream_t stream) {
  const int nchunks = chunks_of(H * (int)sizeof(T));
  const int total = nchunks * Steps<T>::K * NT * 32;
  if constexpr (kSplit<T>)
    split_query_frags<NT><<<(total + 255) / 256, 256, 0, stream>>>(
        static_cast<const float*>(q), B, H, nchunks, qf);
  else
    pack_query_frags<T, NT><<<(total + 255) / 256, 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), B, H, nchunks, qf);
  return (int)cudaGetLastError();
}

// Stage kc's query fragments (qf as launch_query_frags wrote it) into dst,
// after the stage's rows. Every thread of the block calls it, beside stage.
template <typename T, int NT>
__device__ __forceinline__ void stage_query_frags(const uint2* __restrict__ qf, int kc,
                                                  unsigned char* dst) {
  constexpr int BYTES = frag_stage_bytes<T>(NT);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(qf) + (size_t)kc * BYTES;
  for (int i = threadIdx.x; i < BYTES / 16; i += THREADS)
    cp_async16_zfill(dst + i * 16, src + i * 16, 16);
}

// The f32 stage: acc[st][j][e] += the warp's two m16 tiles (st) times n
// tile j over the stage in buf, whose query fragments qf_stage follow its
// rows. Each k16 step splits the lane's doc values, then runs the six
// products, smallest first, each over every (st, j) before the next
// (consecutive mma.sync to different accumulators). Steps past `steps`
// (all tail) are skipped.
template <int NT>
__device__ __forceinline__ void score_stage_f32(const unsigned char* buf, const uint2* qf_stage,
                                                int steps, float (&acc)[2][NT][4]) {
  constexpr int KS = Steps<float>::K;
  // (doc piece, query piece) of the six products, smallest first
  constexpr int PA[6] = {1, 2, 0, 1, 0, 0};
  constexpr int PB[6] = {1, 0, 2, 0, 1, 0};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < KS; ++m) {
    if (m >= steps) break;
    uint32_t a[2][4][PIECES];  // [st][a0..a3][piece]
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const int r = warp * 32 + st * 16 + g;  // rows r and r + 8 share r's parity
      const int c = swz(r, t + 4 * m);
      const float4 lo = *reinterpret_cast<const float4*>(buf + r * CHUNK + c * 16);
      const float4 hi = *reinterpret_cast<const float4*>(buf + (r + 8) * CHUNK + c * 16);
      split_bf16x3(lo.x, lo.y, a[st][0]);
      split_bf16x3(hi.x, hi.y, a[st][1]);
      split_bf16x3(lo.z, lo.w, a[st][2]);
      split_bf16x3(hi.z, hi.w, a[st][3]);
    }
    uint2 b[NT][PIECES];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int p = 0; p < PIECES; ++p) b[j][p] = qf_stage[((m * PIECES + p) * NT + j) * 32 + lane];
#pragma unroll
    for (int s = 0; s < 6; ++s)
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          recur_chain::mma_bf16(acc[st][j], a[st][0][PA[s]], a[st][1][PA[s]], a[st][2][PA[s]],
                                a[st][3][PA[s]], b[j][PB[s]].x, b[j][PB[s]].y);
  }
}

// acc[st][j][e] += the warp's two m16 tiles (st) times n tile j over the
// stage in buf; the stage's k16 steps past `steps` (a stage that is all
// tail) are skipped, their columns being zeros anyway.
template <typename T, int NT>
__device__ __forceinline__ void score_stage(const unsigned char* buf, const uint2* qf_stage,
                                            int steps, float (&acc)[2][NT][4]) {
  constexpr int KS = Steps<T>::K;
  constexpr int PER = sizeof(T) == 2 ? 2 : 4;  // k16 steps a 16-byte chunk carries
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < KS / PER; ++i) {
    if (i * PER >= steps) break;
    uint4 lo[2], hi[2];
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const int r = warp * 32 + st * 16 + g;  // rows r and r + 8 share r's parity
      const int c = swz(r, t + 4 * i);
      lo[st] = *reinterpret_cast<const uint4*>(buf + r * CHUNK + c * 16);
      hi[st] = *reinterpret_cast<const uint4*>(buf + (r + 8) * CHUNK + c * 16);
    }
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int m = i * PER + p;
      uint2 b[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) b[j] = qf_stage[(m * NT + j) * 32 + lane];
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const uint32_t* L = reinterpret_cast<const uint32_t*>(&lo[st]);
        const uint32_t* Hh = reinterpret_cast<const uint32_t*>(&hi[st]);
        uint32_t a0, a1, a2, a3;
        if constexpr (sizeof(T) == 2) {
          a0 = L[2 * p];
          a2 = L[2 * p + 1];
          a1 = Hh[2 * p];
          a3 = Hh[2 * p + 1];
        } else {
          int8x4_to_bf16(L[p], a0, a2);
          int8x4_to_bf16(Hh[p], a1, a3);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
          recur_chain::mma_bf16(acc[st][j], a0, a1, a2, a3, b[j].x, b[j].y);
      }
    }
  }
}

// The s8 x s8 stage: acc[st][j][e] += the warp's two m16 tiles (st) times
// n tile j, int32 sums. As the bf16 path: lane (g, t) reads 16-byte chunk
// t + 4i of rows g and g + 8, whose words 2p and 2p + 1 are a0 / a1 and a2
// / a3 of k32 step 2i + p; chunk group i = 1 is skipped where `steps`
// (live_steps<S8>) leaves it all tail.
template <typename T, int NT>
__device__ __forceinline__ void score_stage(const unsigned char* buf, const uint2* qf_stage,
                                            int steps, int (&acc)[2][NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i * 2 >= steps) break;
    uint4 lo[2], hi[2];
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const int r = warp * 32 + st * 16 + g;
      const int c = swz(r, t + 4 * i);
      lo[st] = *reinterpret_cast<const uint4*>(buf + r * CHUNK + c * 16);
      hi[st] = *reinterpret_cast<const uint4*>(buf + (r + 8) * CHUNK + c * 16);
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int m = i * 2 + p;
      uint2 b[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) b[j] = qf_stage[(m * NT + j) * 32 + lane];
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const uint32_t* L = reinterpret_cast<const uint32_t*>(&lo[st]);
        const uint32_t* Hh = reinterpret_cast<const uint32_t*>(&hi[st]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_s8(acc[st][j], L[2 * p], Hh[2 * p], L[2 * p + 1], Hh[2 * p + 1], b[j].x, b[j].y);
      }
    }
  }
}

// The doc row and query column of accumulator element e of acc[st][j] for
// this thread, relative to the tile's first row.
__device__ __forceinline__ int acc_row(int st, int e) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return warp * 32 + st * 16 + (lane >> 2) + (e >= 2 ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int j, int e) {
  return j * 8 + 2 * (threadIdx.x & 3) + (e & 1);
}

// k16 steps of stage kc that hold real columns (the rest are zero-filled)
template <typename T>
__device__ __forceinline__ int live_steps(int kc, int row_bytes) {
  const int bytes = row_bytes - kc * CHUNK;
  const int chunks = bytes >= CHUNK ? 8 : (bytes + 15) / 16;
  // the k16 steps of chunk group i cover chunks 0..3 (i = 0) and 4..7 (i = 1)
  constexpr int PER = sizeof(T) == 4 ? 1 : sizeof(T) == 2 ? 2 : 4;
  return (chunks > 4 ? 2 : 1) * PER;
}

// k32 steps of stage kc of an s8 row: 2 a chunk group, as bf16's k16 steps
template <>
__device__ __forceinline__ int live_steps<S8>(int kc, int row_bytes) {
  return live_steps<__nv_bfloat16>(kc, row_bytes);
}

// Scores the block's `tiles` tiles of 128 rows (the i-th from row
// row0_of(i)) against the query fragments qf, streaming each through a ring
// of `stages` (2-4; the s8 scan's 2-8) buffers of stage_bytes<T, RING>: the
// copies of the next stages (across tile boundaries) are in flight while
// the current one is multiplied, one barrier a stage. qf: the fragments of
// every stage, resident in shared memory; where they ride the ring (RING,
// always on the f32 path), in device memory (launch_query_frags), each
// stage's copied into its buffer of the ring beside the rows. After a
// tile's last stage it calls done(row0, acc) with the tile's scores (f32,
// int32 on the s8 path; acc_row / acc_col place them). Every thread of the
// block calls it; done may hold barriers.
template <typename T, int NT, bool RING = kSplit<T>, typename RowOf, typename Done>
__device__ __forceinline__ void scan_tiles(const T* __restrict__ docs, int H, int stages,
                                           long long tiles, RowOf row0_of, unsigned char* ring,
                                           const uint2* qf, Done done) {
  static_assert(RING || !kSplit<T>, "the f32 path's query fragments ride the ring");
  constexpr int KS = Steps<T>::K;
  constexpr int SB = stage_bytes<T, RING>(NT);
  const int row_bytes = H * (int)sizeof(T);
  const int nck = chunks_of(row_bytes);
  const long long items = tiles * nck;  // (tile, stage) pairs, in order
  const unsigned char* base = reinterpret_cast<const unsigned char*>(docs);
  auto issue = [&](long long item) {
    if (item < items) {
      unsigned char* buf = ring + (item % stages) * SB;
      stage(base, row0_of(item / nck), (int)(item % nck), row_bytes, buf);
      if constexpr (RING) stage_query_frags<T, NT>(qf, (int)(item % nck), buf + STAGE_BYTES);
    }
    recur_chain::cp_async_commit();  // an empty group past the end keeps the count
  };
  for (int p = 0; p < stages - 1; ++p) issue(p);
  typename Acc<T>::type acc[2][NT][4];
  for (long long it = 0; it < items; ++it) {
    wait_stages(stages - 2);  // this thread's copies of item it have landed
    __syncthreads();          // everyone's have, and item it - 1's buffer is free
    issue(it + stages - 1);
    const int kc = (int)(it % nck);
    if (kc == 0) {
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[st][j][e] = 0;
    }
    const unsigned char* buf = ring + (it % stages) * SB;
    const uint2* qf_stage = RING ? reinterpret_cast<const uint2*>(buf + STAGE_BYTES)
                                 : qf + (size_t)kc * KS * NT * 32;
    if constexpr (kSplit<T>)
      score_stage_f32<NT>(buf, qf_stage, live_steps<T>(kc, row_bytes), acc);
    else
      score_stage<T, NT>(buf, qf_stage, live_steps<T>(kc, row_bytes), acc);
    if (kc == nck - 1) done(row0_of(it / nck), acc);
  }
  recur_chain::cp_async_wait<0>();
}

// Shared memory of the ring and (unless they ride it: RING) the resident
// query fragments of a T scan at width H.
template <typename T, bool RING = kSplit<T>>
__host__ __device__ constexpr size_t scan_smem(int stages, int H, int nt) {
  return RING ? (size_t)stages * stage_bytes<T, true>(nt)
              : (size_t)stages * STAGE_BYTES +
                    qfrag_bytes(chunks_of(H * (int)sizeof(T)), Steps<T>::K, nt);
}

}  // namespace doc_mma
