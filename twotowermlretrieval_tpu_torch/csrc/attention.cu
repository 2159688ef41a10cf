// Fused softmax attention over flattened heads, forward and backward.
//
// Replaces the two TPU kernels of twotowermlretrieval_tpu/ops/attention.py:
// - _fwd_kernel (called through _fused_attention_fwd):
//   out = softmax(q k^T * scale + bias[:, None, :]) v, with q, k, v [R, T, hd]
//   (f32 or bf16; R = batch * heads), bias [R, T] f32 over the key positions
//   (0 valid / -1e9 masked) and out [R, T, hd] f32;
// - _bwd_kernel (called through _fused_attention_bwd): recompute p, then
//   dv = p^T do, dp = do v^T, ds = p * (dp - rowsum(dp * p)) * scale,
//   dq = ds k, dk = ds^T q, each [R, T, hd] f32.
// Every product takes its operands rounded to the compute dtype (bf16 or
// f32) and sums in f32, as the TPU kernel's _bdot does; the scores stay
// f32, the scale multiplies each sum and the bias is added after that (two
// roundings, never contracted into one FMA), p = exp(s - max) / sum, and p
// is rounded to the compute dtype only as a product's operand. T <= 512 is
// taken whole, as the TPU kernel takes it: no online softmax.
//
// What bounds it on Hopper: bytes. At R = 4096, T = 128, hd = 32 with f32
// inputs the forward must move 270.5 MB (0.081 ms at 3.35 TB/s) for 8.6
// GFLOP (0.009 ms at the bf16 tensor-core rate), the backward 471.9 MB
// (0.141 ms) for 21.5 GFLOP. Anything T x T-shaped in device memory would
// multiply the bytes by about T / hd, so no score or probability leaves the
// SM.
//
// bf16 compute (the transformer's path): tensor-core tiles. Operands are
// staged in shared memory in bf16 (16-byte cp.async copies from bf16
// inputs; f32 inputs are rounded on the way) and reach the tensor cores
// through ldmatrix and mma.sync m16n8k16 (bf16 in, f32 accumulators). A
// warp owns 16 rows of a product. hd = 8 pads the depth of the hd
// contractions to 16 with zeros (exact).
// - Forward, one block per (row r, tile of up to 128 query rows, the
//   largest whose scores fit): S = Q K^T over the whole T in 16-key blocks,
//   scale and bias applied on the accumulators, each score computed once
//   and kept in shared memory as f32 (64 x 512 x 4 B = 128 KiB at T = 512);
//   the row maximum from the accumulators; then the row sum, exp(s - m)
//   kept in place of s; then O += P V with p = exp(s - m) / l rounded to
//   bf16 as the A operand. Each thread reads back only the scores it wrote
//   (the accumulator layout of two n8 tiles is the A layout of one k16
//   step), so the score store needs no barrier. Where K and V together do
//   not fit beside the scores (hd = 64, T = 512), V is loaded over K after
//   the score pass. The key loops are unrolled four deep, and where one
//   block fills the SM's shared memory (T = 512) two warps share each 16
//   rows, one half of the keys each, their maxima, sums and outputs
//   combined through shared memory in a fixed order: the ldmatrix and mma
//   latencies of one 16-key block hide behind the next ones' and the other
//   warps'.
// - Backward, launch 1 (per query tile): S, m and l as in the forward; dP =
//   dO V^T on the tensor cores, row = rowsum(dP * P) in f32 with the f32 p
//   (kept in place of exp(s - m)); then dP once more and dS = p * (dp -
//   row) * scale, kept in place of p; then dQ += dS K with dS rounded to
//   bf16 as the A operand; the three row statistics go to global memory.
//   Where K and V do not fit together, V is loaded over K after the score
//   pass and K over V again before dQ.
// - Backward, launch 2 (per tile of up to 64 keys): the query tiles in
//   order, each staged while the one before is used: s_ij recomputed with
//   the roles of launch 1 (Q the A operand, K the B operand, the same k
//   steps and tile positions), so p_ij is the p behind the stored
//   statistics, bit for bit; P and dS (bf16) go to shared memory and dV +=
//   P^T dO, dK += dS^T Q on the tensor cores (ldmatrix.trans forms the
//   transposed A operands).
// Key columns past T get a -inf score (out of both maximum and sum), rows
// past T are zero-filled, and a row whose keys are all masked by -1e9 stays
// uniform over its T real keys. No atomics: dk and dv sum over the query
// tiles in a fixed order, and two calls give the same bits, which a
// resumed training run relies on. ops/attention.py (attention_plan) picks
// the tiles and mirrors the shared-memory layouts below.
//
// f32 compute (the JAX f32 path asks for Precision.HIGHEST, which the
// TPU's MXU computes from bf16 pieces in several passes) runs the same
// structure on the same tensor cores with split operands: every f32 value
// x is three bf16 pieces, x = hi + mid + lo exactly (doc_mma.cuh, "The f32
// path", which states the error bound), and every product sums the six
// leading products of the pieces, mid.mid, lo.hi, hi.lo, mid.hi, hi.mid,
// hi.hi, each on mma.sync m16n8k16 with f32 accumulators, each over every
// tile of a group before the next (consecutive mma.sync to different
// accumulators). A bf16 input's mid and lo are zero, and the products
// that take them are skipped. Row r's keys and values stream through a
// ring of chunks of up to 64 keys: each chunk is copied with cp.async
// while the one before is used, then split once into three bf16 planes
// ([key][hd + 8] each) that every warp reads through ldmatrix; each
// score is computed once and kept in shared memory as f32, as above, and
// only the chunks stream, so every T up to 512 fits at every head width
// (query tiles of 16 to 128 rows, as large as fit beside their scores).
// The query tile's fragments (Q, dO) split in registers
// straight from device memory, P and dS in registers from the
// accumulator layout (the A layout of a k16 step).
// - Forward: K chunks (scores, maximum), the row sums in shared memory,
//   V chunks (O += P V).
// - Backward, launch 1: K chunks (scores), V chunks twice (dP for the row
//   term, then, from the last chunk back, for dS) and K chunks again (dQ
//   += dS K); launch 2 per key tile of up to 64, as above, K, V and each
//   query tile's Q, dO and statistics copied with cp.async, P and then dS
//   taking turns in one region of three bf16 planes (dV += P^T dO, then
//   dK += dS^T Q).
// The scale, bias, softmax and ds steps, the -inf past T, the uniform row
// of a fully masked query and the fixed summation order are the bf16
// route's. Six products make the operations six times the bf16 route's at
// a sixth of its rate (164.8 TFLOP/s): bytes still bound R = 4096, T =
// 128, hd = 32; operations bind T = 512, hd = 64 (0.013 ms forward, 0.033
// backward at R = 32), where the route is latency-bound instead (one block
// of 4 warps a SM beside 64 rows of T = 512 scores), so the kernels take
// two blocks a SM wherever hd <= 32. ops/attention.py (attention_plan)
// mirrors split_layout and dkv_split_layout below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "doc_mma.cuh"
#include "recur_chain.cuh"

namespace {

using recur_chain::cp_async16;
using recur_chain::cp_async4;
using recur_chain::cp_async_commit;
using recur_chain::cp_async_wait;
using recur_chain::ldsm_x2_t;
using recur_chain::ldsm_x4;
using recur_chain::ldsm_x4_t;
using recur_chain::mma_bf16;

constexpr int MAX_T = 512;
constexpr int SMEM_LIMIT = recur_chain::SMEM_LIMIT;


// the score of one (query, key) pair: (dot * scale) + bias, each rounded
__device__ __forceinline__ float score(float dot, float scale, float bias) {
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

// p * (dp - row) * scale, each step rounded as the TPU kernel's
__device__ __forceinline__ float dscore(float p, float dp, float row, float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, row)), scale);
}

// ---------------------------------------------------------------------------
// bf16 compute: tensor-core tiles
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

template <int HD>
struct Dims {
  static constexpr int HDK = HD < 16 ? 16 : HD;  // depth of the hd contractions (zero padded)
  static constexpr int LD = HDK + 8;             // a staged row: 16 bytes of pad, no bank conflict
  static constexpr int KS = HDK / 16;            // k16 steps over hd
  static constexpr int NT = HD / 8;              // n8 tiles over hd
};

__host__ __device__ constexpr size_t al16(size_t n) { return (n + 15) & ~size_t(15); }

// Shared-memory layouts (ops/attention.py's attention_plan mirrors the
// sizes). Tp: T rounded up to 16; rows: the query tile; kt: the key tile.
struct FwdLayout {
  size_t q, k, v, s, b, red, total;
};
template <int HD>
__host__ __device__ FwdLayout fwd_layout(int Tp, int rows, int kv_shared) {
  constexpr int LD = Dims<HD>::LD;
  FwdLayout L;
  size_t o = 0;
  L.q = o;
  o += al16((size_t)rows * LD * 2);
  L.k = o;
  o += al16((size_t)Tp * LD * 2);
  L.v = kv_shared ? L.k : o;
  if (!kv_shared) o += al16((size_t)Tp * LD * 2);
  L.s = o;
  o += (size_t)rows * Tp * 4;
  L.b = o;
  o += al16((size_t)Tp * 4);
  L.red = o;  // where two key halves meet: [2][rows / 16][32][2] f32
  o += (size_t)rows * 32;
  L.total = o;
  return L;
}

struct DqLayout {
  size_t q, d, k, v, s, b, red, total;
};
template <int HD>
__host__ __device__ DqLayout dq_layout(int Tp, int rows, int kv_shared) {
  constexpr int LD = Dims<HD>::LD;
  DqLayout L;
  size_t o = 0;
  L.q = o;
  o += al16((size_t)rows * LD * 2);
  L.d = o;
  o += al16((size_t)rows * LD * 2);
  L.k = o;
  o += al16((size_t)Tp * LD * 2);
  L.v = kv_shared ? L.k : o;
  if (!kv_shared) o += al16((size_t)Tp * LD * 2);
  L.s = o;
  o += (size_t)rows * Tp * 4;
  L.b = o;
  o += al16((size_t)Tp * 4);
  L.red = o;
  o += (size_t)rows * 32;
  L.total = o;
  return L;
}

// one staging buffer of launch 2: a query tile's q, do and statistics
struct DkvLayout {
  size_t k, v, st, st_q, st_d, st_m, st_size, p, ds, b, total;
};
template <int HD>
__host__ __device__ DkvLayout dkv_layout(int kt) {
  constexpr int LD = Dims<HD>::LD;
  DkvLayout L;
  L.st_q = 0;
  L.st_d = al16((size_t)kt * LD * 2);
  L.st_m = L.st_d + al16((size_t)kt * LD * 2);
  L.st_size = L.st_m + al16((size_t)3 * kt * 4);
  size_t o = 0;
  L.k = o;
  o += al16((size_t)kt * LD * 2);
  L.v = o;
  o += al16((size_t)kt * LD * 2);
  L.st = o;
  o += 2 * L.st_size;
  L.p = o;
  o += al16((size_t)kt * (kt + 8) * 2);
  L.ds = o;
  o += al16((size_t)kt * (kt + 8) * 2);
  L.b = o;
  o += al16((size_t)kt * 4);
  L.total = o;
  return L;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // to nearest even, as torch's cast
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// rows [0, n) of a [., HD] row-major source into dst [n][LD] bf16: rows past
// `valid` and the columns past HD zero; bf16 rows by cp.async (the caller
// commits), f32 rows rounded to nearest even on the way
template <typename TIn, int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, const TIn* __restrict__ src, int n,
                                           int valid, int tid, int nthreads) {
  constexpr int LD = Dims<HD>::LD, CH = Dims<HD>::HDK / 8;  // 16-byte chunks of a staged row
  if constexpr (sizeof(TIn) == 2) {
    for (int idx = tid; idx < n * CH; idx += nthreads) {
      const int r = idx / CH, c = (idx % CH) * 8;
      bf16* d = dst + r * LD + c;
      if (r >= valid || c >= HD)
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      else
        cp_async16(d, src + (size_t)r * HD + c);
    }
  } else {
    // f32: four chunks a thread in flight before any is rounded and stored
    constexpr int U = 4;
    for (int i0 = tid; i0 < n * CH; i0 += U * nthreads) {
      float4 a[U], b[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = i0 + u * nthreads, r = idx / CH, c = (idx % CH) * 8;
        const bool ok = idx < n * CH && r < valid && c < HD;
        const float4* g = reinterpret_cast<const float4*>(src + (size_t)r * HD + c);
        a[u] = ok ? __ldg(g) : make_float4(0.f, 0.f, 0.f, 0.f);
        b[u] = ok ? __ldg(g + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = i0 + u * nthreads, r = idx / CH, c = (idx % CH) * 8;
        if (idx < n * CH)
          *reinterpret_cast<uint4*>(dst + r * LD + c) =
              make_uint4(pack_bf16(a[u].x, a[u].y), pack_bf16(a[u].z, a[u].w),
                         pack_bf16(b[u].x, b[u].y), pack_bf16(b[u].z, b[u].w));
      }
    }
  }
}

// A fragments of 16 rows (from `base`, the first row) over the hd depth
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[Dims<HD>::KS][4], const bf16* base,
                                       int lane) {
#pragma unroll
  for (int ks = 0; ks < Dims<HD>::KS; ++ks)
    ldsm_x4(a[ks], base + (lane % 16) * Dims<HD>::LD + ks * 16 + (lane / 16) * 8);
}

// acc[h] (h = 0, 1: rows 0-7 and 8-15 of `rowb`) += A . B over the hd depth,
// B's 16 columns being the staged rows rowb.. (K or V as [n][k]):
// the scores of 16 keys, or dp of 16 keys
template <int HD>
__device__ __forceinline__ void prod16(float (&acc)[2][4], const uint32_t (&a)[Dims<HD>::KS][4],
                                       const bf16* rowb, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[h][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < Dims<HD>::KS; ++ks) {
    uint32_t b[4];
    ldsm_x4(b, rowb + ((lane / 16) * 8 + lane % 8) * Dims<HD>::LD + ks * 16 + ((lane / 8) % 2) * 8);
    mma_bf16(acc[0], a[ks][0], a[ks][1], a[ks][2], a[ks][3], b[0], b[1]);
    mma_bf16(acc[1], a[ks][0], a[ks][1], a[ks][2], a[ks][3], b[2], b[3]);
  }
}

// o[nt] += A . B for one k16 step, B = the 16 staged rows from `rowb` as [k][n]
// (V, K, dO or Q: n over hd), A given
template <int HD>
__device__ __forceinline__ void prod_hd(float (&o)[Dims<HD>::NT][4], uint32_t a0, uint32_t a1,
                                        uint32_t a2, uint32_t a3, const bf16* rowb, int lane) {
  constexpr int LD = Dims<HD>::LD;
  const bf16* p = rowb + (((lane / 8) % 2) * 8 + lane % 8) * LD;
  if constexpr (Dims<HD>::NT == 1) {
    uint32_t b[2];
    ldsm_x2_t(b, p);
    mma_bf16(o[0], a0, a1, a2, a3, b[0], b[1]);
  } else {
#pragma unroll
    for (int np = 0; np < Dims<HD>::NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, p + np * 16 + (lane / 16) * 8);
      mma_bf16(o[2 * np], a0, a1, a2, a3, b[0], b[1]);
      mma_bf16(o[2 * np + 1], a0, a1, a2, a3, b[2], b[3]);
    }
  }
}

// scores of one 16-key block from the accumulators: (dot * scale) + bias,
// element e of tile h at key kb*16 + h*8 + tig*2 + (e & 1); -inf past T
// (the bias there is -inf)
__device__ __forceinline__ void scores16(float (&s)[8], const float (&acc)[2][4],
                                         const float* b_s, int key0, float scale) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[h * 4 + e] = score(acc[h][e], scale, b_s[key0 + h * 8 + (e & 1)]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// a thread's 8 scores of a 16-key block, in its own slot of the warp's region
__device__ __forceinline__ void put8(float* slot, const float (&s)[8]) {
  reinterpret_cast<float4*>(slot)[0] = make_float4(s[0], s[1], s[2], s[3]);
  reinterpret_cast<float4*>(slot)[1] = make_float4(s[4], s[5], s[6], s[7]);
}
__device__ __forceinline__ void get8(const float* slot, float (&s)[8]) {
  const float4 a = reinterpret_cast<const float4*>(slot)[0];
  const float4 b = reinterpret_cast<const float4*>(slot)[1];
  s[0] = a.x, s[1] = a.y, s[2] = a.z, s[3] = a.w, s[4] = b.x, s[5] = b.y, s[6] = b.z, s[7] = b.w;
}

// element e of a 16-key block belongs to row gid (e in 0, 1, 4, 5) or gid + 8
__device__ __forceinline__ int upper(int e) { return (e >> 1) & 1; }

// p = exp(s - m) / l of a thread's 8 elements, f32
__device__ __forceinline__ void probs8(float (&p)[8], const float (&s)[8], const float (&m)[2],
                                       const float (&l)[2]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) p[e] = __fdiv_rn(expf(__fsub_rn(s[e], m[upper(e)])), l[upper(e)]);
}

// Scores of the warp's 16 query rows against its 16-key blocks [kb0, kb1),
// kept in the row group's region; returns the row maxima (rows gid, gid + 8)
template <int HD>
__device__ __forceinline__ void score_pass(float* sw, const uint32_t (&qa)[Dims<HD>::KS][4],
                                           const bf16* k_s, const float* b_s, int kb0, int kb1,
                                           float scale, int lane, float (&m)[2]) {
  const int tig = lane % 4;
  m[0] = m[1] = neg_inf();
#pragma unroll 4
  for (int kb = kb0; kb < kb1; ++kb) {
    float acc[2][4], s[8];
    prod16<HD>(acc, qa, k_s + (size_t)kb * 16 * Dims<HD>::LD, lane);
    scores16(s, acc, b_s, kb * 16 + tig * 2, scale);
#pragma unroll
    for (int e = 0; e < 8; ++e) m[upper(e)] = fmaxf(m[upper(e)], s[e]);
    put8(sw + (kb * 32 + lane) * 8, s);
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
}

// the row sums of exp(s - m), each thread's terms in key order, then the
// quad's; exp(s - m) is kept in place of s
__device__ __forceinline__ void sum_pass(float* sw, int kb0, int kb1, int lane,
                                         const float (&m)[2], float (&l)[2]) {
  l[0] = l[1] = 0.0f;
#pragma unroll 4
  for (int kb = kb0; kb < kb1; ++kb) {
    float s[8];
    float* slot = sw + (kb * 32 + lane) * 8;
    get8(slot, s);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s[e] = expf(__fsub_rn(s[e], m[upper(e)]));
      l[upper(e)] += s[e];
    }
    put8(slot, s);
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
}

// p = e / l of a thread's 8 elements (e = exp(s - m)), f32
__device__ __forceinline__ void div8(float (&p)[8], const float (&e)[8], const float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = __fdiv_rn(e[i], l[upper(i)]);
}

// How a block's warps share its query rows and keys: warp w takes the 16
// rows of row group w % groups and key half w / groups of `ks` (2 where
// one block fills the SM's shared memory, so that twice the warps hide the
// ldmatrix and mma latencies; else 1). The halves meet in `red` ([2]
// [groups][32][2] f32), their sums in a fixed order: half 0's, then half
// 1's.
struct Split {
  int groups, rg, half, ks, kb0, kb1;
  float* red;

  __device__ Split(int rows, int ks_, int Tp, int warp, float* red_) {
    groups = rows / 16;
    rg = warp % groups;
    half = warp / groups;
    ks = ks_;
    const int nkb = Tp / 16, per = (nkb + ks - 1) / ks;
    kb0 = half * per;
    kb1 = min(nkb, kb0 + per);
    red = red_;
  }

  // x (two values a thread, the quad's rows) combined over the halves:
  // their maximum, or half 0's plus half 1's
  __device__ void combine(float (&x)[2], int lane, bool sum) const {
    if (ks == 1) return;
    float* mine = red + ((half * groups + rg) * 32 + lane) * 2;
    const float* other = red + (((1 - half) * groups + rg) * 32 + lane) * 2;
    mine[0] = x[0];
    mine[1] = x[1];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
      x[i] = !sum ? fmaxf(x[i], other[i]) : half == 0 ? x[i] + other[i] : other[i] + x[i];
    __syncthreads();  // `red` is free again
  }

  // half 0's accumulators plus half 1's, through `scratch` (n floats a
  // thread of half 1, free by now); half 0 holds the sum
  template <int N>
  __device__ void combine_acc(float (&a)[N][4], float* scratch, int lane) const {
    if (ks == 1) return;
    float* slot = scratch + (size_t)(rg * 32 + lane) * N * 4;
    __syncthreads();  // every warp is done with what `scratch` held
    if (half == 1)
#pragma unroll
      for (int n = 0; n < N; ++n)
        reinterpret_cast<float4*>(slot)[n] = make_float4(a[n][0], a[n][1], a[n][2], a[n][3]);
    __syncthreads();
    if (half == 0)
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float4 b = reinterpret_cast<const float4*>(slot)[n];
        a[n][0] += b.x, a[n][1] += b.y, a[n][2] += b.z, a[n][3] += b.w;
      }
  }
};

template <typename TIn, int HD>
__global__ void __launch_bounds__(256) attention_fwd_mma(int T, int rows, int kv_shared, int ks,
                                                         float scale, const TIn* __restrict__ q,
                                                         const TIn* __restrict__ k,
                                                         const TIn* __restrict__ v,
                                                         const float* __restrict__ bias,
                                                         float* __restrict__ out) {
  using D = Dims<HD>;
  const int Tp = (T + 15) / 16 * 16;
  const FwdLayout L = fwd_layout<HD>(Tp, rows, kv_shared);
  extern __shared__ __align__(16) unsigned char tsm[];
  bf16* q_s = reinterpret_cast<bf16*>(tsm + L.q);
  bf16* k_s = reinterpret_cast<bf16*>(tsm + L.k);
  bf16* v_s = reinterpret_cast<bf16*>(tsm + L.v);
  float* s_s = reinterpret_cast<float*>(tsm + L.s);
  float* b_s = reinterpret_cast<float*>(tsm + L.b);
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const size_t r = blockIdx.x, base = r * T * HD;
  const int i0 = blockIdx.y * rows;

  stage_rows<TIn, HD>(q_s, q + base + (size_t)i0 * HD, rows, min(rows, T - i0), tid, nt);
  stage_rows<TIn, HD>(k_s, k + base, Tp, T, tid, nt);
  if (!kv_shared) stage_rows<TIn, HD>(v_s, v + base, Tp, T, tid, nt);
  cp_async_commit();
  for (int j = tid; j < Tp; j += nt) b_s[j] = j < T ? bias[r * T + j] : neg_inf();
  cp_async_wait<0>();
  __syncthreads();

  const Split sp(rows, ks, Tp, warp, reinterpret_cast<float*>(tsm + L.red));
  uint32_t qa[D::KS][4];
  load_a<HD>(qa, q_s + sp.rg * 16 * D::LD, lane);
  float* sw = s_s + (size_t)sp.rg * Tp * 16;  // the row group's scores, 256 floats a 16-key block
  float m[2], l[2];
  score_pass<HD>(sw, qa, k_s, b_s, sp.kb0, sp.kb1, scale, lane, m);
  sp.combine(m, lane, false);
  if (kv_shared) {  // V over K: every warp is done with K
    __syncthreads();
    stage_rows<TIn, HD>(v_s, v + base, Tp, T, tid, nt);
    cp_async_commit();
  }
  sum_pass(sw, sp.kb0, sp.kb1, lane, m, l);
  sp.combine(l, lane, true);
  if (kv_shared) {
    cp_async_wait<0>();
    __syncthreads();
  }

  float o[D::NT][4];
#pragma unroll
  for (int n = 0; n < D::NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
#pragma unroll 4
  for (int kb = sp.kb0; kb < sp.kb1; ++kb) {
    float ex[8], p[8];
    get8(sw + (kb * 32 + lane) * 8, ex);
    div8(p, ex, l);
    // the accumulator layout of the two n8 tiles is the A layout of this k16 step
    prod_hd<HD>(o, pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]), pack_bf16(p[4], p[5]),
                pack_bf16(p[6], p[7]), v_s + (size_t)kb * 16 * D::LD, lane);
  }
  sp.combine_acc(o, s_s, lane);
  if (sp.half != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + sp.rg * 16 + gid + h * 8;
    if (i < T)
#pragma unroll
      for (int n = 0; n < D::NT; ++n)
        *reinterpret_cast<float2*>(out + base + (size_t)i * HD + n * 8 + tig * 2) =
            make_float2(o[n][2 * h], o[n][2 * h + 1]);
  }
}

// Backward, launch 1 (per query tile): the row statistics and dq.
template <typename TIn, int HD>
__global__ void __launch_bounds__(256) attention_bwd_dq_mma(
    int R, int T, int rows, int kv_shared, int ks, float scale, const TIn* __restrict__ q,
    const TIn* __restrict__ k, const TIn* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ dout, float* __restrict__ dq, float* __restrict__ stats) {
  using D = Dims<HD>;
  const int Tp = (T + 15) / 16 * 16;
  const DqLayout L = dq_layout<HD>(Tp, rows, kv_shared);
  extern __shared__ __align__(16) unsigned char tsm[];
  bf16* q_s = reinterpret_cast<bf16*>(tsm + L.q);
  bf16* d_s = reinterpret_cast<bf16*>(tsm + L.d);
  bf16* k_s = reinterpret_cast<bf16*>(tsm + L.k);
  bf16* v_s = reinterpret_cast<bf16*>(tsm + L.v);
  float* s_s = reinterpret_cast<float*>(tsm + L.s);
  float* b_s = reinterpret_cast<float*>(tsm + L.b);
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const size_t r = blockIdx.x, base = r * T * HD;
  const int i0 = blockIdx.y * rows, valid = min(rows, T - i0);

  stage_rows<TIn, HD>(q_s, q + base + (size_t)i0 * HD, rows, valid, tid, nt);
  stage_rows<float, HD>(d_s, dout + base + (size_t)i0 * HD, rows, valid, tid, nt);
  stage_rows<TIn, HD>(k_s, k + base, Tp, T, tid, nt);
  if (!kv_shared) stage_rows<TIn, HD>(v_s, v + base, Tp, T, tid, nt);
  cp_async_commit();
  for (int j = tid; j < Tp; j += nt) b_s[j] = j < T ? bias[r * T + j] : neg_inf();
  cp_async_wait<0>();
  __syncthreads();

  const Split sp(rows, ks, Tp, warp, reinterpret_cast<float*>(tsm + L.red));
  uint32_t qa[D::KS][4], da[D::KS][4];
  load_a<HD>(qa, q_s + sp.rg * 16 * D::LD, lane);
  load_a<HD>(da, d_s + sp.rg * 16 * D::LD, lane);
  float* sw = s_s + (size_t)sp.rg * Tp * 16;
  float m[2], l[2], row[2] = {0.0f, 0.0f};
  score_pass<HD>(sw, qa, k_s, b_s, sp.kb0, sp.kb1, scale, lane, m);
  sp.combine(m, lane, false);
  if (kv_shared) {  // V over K: every warp is done with K until dq
    __syncthreads();
    stage_rows<TIn, HD>(v_s, v + base, Tp, T, tid, nt);
    cp_async_commit();
  }
  sum_pass(sw, sp.kb0, sp.kb1, lane, m, l);
  sp.combine(l, lane, true);
  if (kv_shared) {
    cp_async_wait<0>();
    __syncthreads();
  }

  // row = rowsum(dp * p), p in f32, kept in place of exp(s - m)
#pragma unroll 4
  for (int kb = sp.kb0; kb < sp.kb1; ++kb) {
    float acc[2][4], ex[8], p[8];
    prod16<HD>(acc, da, v_s + (size_t)kb * 16 * D::LD, lane);
    float* slot = sw + (kb * 32 + lane) * 8;
    get8(slot, ex);
    div8(p, ex, l);
#pragma unroll
    for (int e = 0; e < 8; ++e) row[upper(e)] = __fmaf_rn(acc[e / 4][e % 4], p[e], row[upper(e)]);
    put8(slot, p);
  }
  row[0] = quad_sum(row[0]);
  row[1] = quad_sum(row[1]);
  sp.combine(row, lane, true);

  // ds = p * (dp - row) * scale from dp once more, kept in place of p
#pragma unroll 4
  for (int kb = sp.kb0; kb < sp.kb1; ++kb) {
    float acc[2][4], p[8], ds[8];
    prod16<HD>(acc, da, v_s + (size_t)kb * 16 * D::LD, lane);
    float* slot = sw + (kb * 32 + lane) * 8;
    get8(slot, p);
#pragma unroll
    for (int e = 0; e < 8; ++e) ds[e] = dscore(p[e], acc[e / 4][e % 4], row[upper(e)], scale);
    put8(slot, ds);
  }
  if (kv_shared) {  // K over V again
    __syncthreads();
    stage_rows<TIn, HD>(k_s, k + base, Tp, T, tid, nt);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // dq += ds k, ds rounded to bf16 as the A operand (the accumulator layout)
  float g[D::NT][4];
#pragma unroll
  for (int n = 0; n < D::NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) g[n][e] = 0.0f;
#pragma unroll 4
  for (int kb = sp.kb0; kb < sp.kb1; ++kb) {
    float ds[8];
    get8(sw + (kb * 32 + lane) * 8, ds);
    prod_hd<HD>(g, pack_bf16(ds[0], ds[1]), pack_bf16(ds[2], ds[3]), pack_bf16(ds[4], ds[5]),
                pack_bf16(ds[6], ds[7]), k_s + (size_t)kb * 16 * D::LD, lane);
  }
  sp.combine_acc(g, s_s, lane);
  if (sp.half != 0) return;
  const size_t plane = (size_t)R * T;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + sp.rg * 16 + gid + h * 8;
    if (i < T) {
#pragma unroll
      for (int n = 0; n < D::NT; ++n)
        *reinterpret_cast<float2*>(dq + base + (size_t)i * HD + n * 8 + tig * 2) =
            make_float2(g[n][2 * h], g[n][2 * h + 1]);
      if (tig == 0) {
        stats[r * T + i] = m[h];
        stats[plane + r * T + i] = l[h];
        stats[2 * plane + r * T + i] = row[h];
      }
    }
  }
}

// Backward, launch 2 (per key tile): dk and dv, summed over the query tiles in order.
template <typename TIn, int HD>
__global__ void __launch_bounds__(128) attention_bwd_dkv_mma(
    int R, int T, int kt, float scale, const TIn* __restrict__ q, const TIn* __restrict__ k,
    const TIn* __restrict__ v, const float* __restrict__ bias, const float* __restrict__ dout,
    float* __restrict__ dk, float* __restrict__ dv, const float* __restrict__ stats) {
  using D = Dims<HD>;
  const DkvLayout L = dkv_layout<HD>(kt);
  extern __shared__ __align__(16) unsigned char tsm[];
  bf16* k_s = reinterpret_cast<bf16*>(tsm + L.k);
  bf16* v_s = reinterpret_cast<bf16*>(tsm + L.v);
  bf16* p_s = reinterpret_cast<bf16*>(tsm + L.p);    // [query][key] bf16
  bf16* ds_s = reinterpret_cast<bf16*>(tsm + L.ds);  // [query][key] bf16
  float* b_s = reinterpret_cast<float*>(tsm + L.b);
  const int pld = kt + 8;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const size_t r = blockIdx.x, base = r * T * HD, plane = (size_t)R * T;
  const int j0 = blockIdx.y * kt;
  const int nblk = (T + kt - 1) / kt;  // query tiles of kt rows

  stage_rows<TIn, HD>(k_s, k + base + (size_t)j0 * HD, kt, min(kt, T - j0), tid, nt);
  stage_rows<TIn, HD>(v_s, v + base + (size_t)j0 * HD, kt, min(kt, T - j0), tid, nt);
  for (int c = tid; c < kt; c += nt) b_s[c] = j0 + c < T ? bias[r * T + j0 + c] : neg_inf();
  // query tile blk into staging buffer buf (rows past T: zero q and do, m = 0, l = 1, row = 0)
  auto issue = [&](int blk, int buf) {
    unsigned char* st = tsm + L.st + (size_t)buf * L.st_size;
    const int i0 = blk * kt, valid = min(kt, T - i0);
    stage_rows<TIn, HD>(reinterpret_cast<bf16*>(st + L.st_q), q + base + (size_t)i0 * HD, kt,
                        valid, tid, nt);
    stage_rows<float, HD>(reinterpret_cast<bf16*>(st + L.st_d), dout + base + (size_t)i0 * HD, kt,
                          valid, tid, nt);
    float* sm = reinterpret_cast<float*>(st + L.st_m);
    for (int c = tid; c < kt; c += nt) {
      const bool ok = c < valid;
      const size_t at = r * T + i0 + c;
      sm[c] = ok ? stats[at] : 0.0f;
      sm[kt + c] = ok ? stats[plane + at] : 1.0f;
      sm[2 * kt + c] = ok ? stats[2 * plane + at] : 0.0f;
    }
    cp_async_commit();
  };
  issue(0, 0);

  float gk[D::NT][4], gv[D::NT][4];
#pragma unroll
  for (int n = 0; n < D::NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[n][e] = gv[n][e] = 0.0f;

#pragma unroll 1
  for (int blk = 0; blk < nblk; ++blk) {
    const int buf = blk & 1;
    if (blk + 1 < nblk) {
      issue(blk + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* st = tsm + L.st + (size_t)buf * L.st_size;
    const bf16* qb = reinterpret_cast<const bf16*>(st + L.st_q);
    const bf16* db = reinterpret_cast<const bf16*>(st + L.st_d);
    const float* sm = reinterpret_cast<const float*>(st + L.st_m);

    // P and dS of the warp's 16 queries against the key tile, as launch 1
    // computes them (Q the A operand, K the B operand)
    {
      uint32_t qa[D::KS][4], da[D::KS][4];
      load_a<HD>(qa, qb + warp * 16 * D::LD, lane);
      load_a<HD>(da, db + warp * 16 * D::LD, lane);
      const int qr = warp * 16 + gid;
      const float m[2] = {sm[qr], sm[qr + 8]};
      const float l[2] = {sm[kt + qr], sm[kt + qr + 8]};
      const float row[2] = {sm[2 * kt + qr], sm[2 * kt + qr + 8]};
#pragma unroll 2
      for (int kb = 0; kb < kt / 16; ++kb) {
        float acc[2][4], s[8], p[8], ds[8];
        prod16<HD>(acc, qa, k_s + (size_t)kb * 16 * D::LD, lane);
        scores16(s, acc, b_s, kb * 16 + tig * 2, scale);
        probs8(p, s, m, l);
        prod16<HD>(acc, da, v_s + (size_t)kb * 16 * D::LD, lane);
#pragma unroll
        for (int e = 0; e < 8; ++e) ds[e] = dscore(p[e], acc[e / 4][e % 4], row[upper(e)], scale);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = kb * 16 + h * 8 + tig * 2;
          *reinterpret_cast<uint32_t*>(p_s + qr * pld + col) = pack_bf16(p[4 * h], p[4 * h + 1]);
          *reinterpret_cast<uint32_t*>(p_s + (qr + 8) * pld + col) =
              pack_bf16(p[4 * h + 2], p[4 * h + 3]);
          *reinterpret_cast<uint32_t*>(ds_s + qr * pld + col) = pack_bf16(ds[4 * h], ds[4 * h + 1]);
          *reinterpret_cast<uint32_t*>(ds_s + (qr + 8) * pld + col) =
              pack_bf16(ds[4 * h + 2], ds[4 * h + 3]);
        }
      }
    }
    __syncthreads();

    // dv += p^T do, dk += ds^T q over this tile's queries, for the warp's 16 keys
#pragma unroll 2
    for (int ks = 0; ks < kt / 16; ++ks) {
      // A = P^T (keys x queries) from P stored [query][key]: ldmatrix.trans
      const int ar = ks * 16 + (lane / 16) * 8 + lane % 8, ac = warp * 16 + ((lane / 8) % 2) * 8;
      uint32_t a[4];
      ldsm_x4_t(a, p_s + ar * pld + ac);
      prod_hd<HD>(gv, a[0], a[1], a[2], a[3], db + (size_t)ks * 16 * D::LD, lane);
      ldsm_x4_t(a, ds_s + ar * pld + ac);
      prod_hd<HD>(gk, a[0], a[1], a[2], a[3], qb + (size_t)ks * 16 * D::LD, lane);
    }
    __syncthreads();  // the next tile's copies and P / dS overwrite what was read
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j0 + warp * 16 + gid + h * 8;
    if (j < T)
#pragma unroll
      for (int n = 0; n < D::NT; ++n) {
        const size_t o = base + (size_t)j * HD + n * 8 + tig * 2;
        *reinterpret_cast<float2*>(dk + o) = make_float2(gk[n][2 * h], gk[n][2 * h + 1]);
        *reinterpret_cast<float2*>(dv + o) = make_float2(gv[n][2 * h], gv[n][2 * h + 1]);
      }
  }
}
// ---------------------------------------------------------------------------
// f32 compute: split bf16 products on the tensor cores
// ---------------------------------------------------------------------------

using doc_mma::PIECES;
using doc_mma::split_bf16x3;

// Keys a chunk of the key ring holds (forward and the backward's first
// launch), and so the 16-key blocks of one group of products.
constexpr int KC = 64;
constexpr int GROUP = KC / 16;

// bf16 pieces an input value has: three for an f32 (hi, mid, lo), one for
// a bf16, whose mid and lo are zero (the products that take them are
// skipped: adding +0 leaves an f32 sum's bits as they are)
template <typename T> struct Pieces { static constexpr int N = PIECES; };
template <> struct Pieces<bf16> { static constexpr int N = 1; };

// The six products of a split product, (A piece, B piece) with 0 = hi,
// 1 = mid, 2 = lo, smallest first (utils/dtypes.py SPLIT_PRODUCTS):
// mid.mid, lo.hi, hi.lo, mid.hi, hi.mid, hi.hi
__host__ __device__ constexpr int piece_a(int s) { return s == 0 || s == 3 ? 1 : s == 1 ? 2 : 0; }
__host__ __device__ constexpr int piece_b(int s) { return s == 0 || s == 4 ? 1 : s == 2 ? 2 : 0; }
// whether product s takes only pieces its operands have (PA and PB of them)
template <int PA, int PB>
__host__ __device__ constexpr bool live(int s) { return piece_a(s) < PA && piece_b(s) < PB; }

// Shared memory of the forward and the backward's first launch
// (ops/attention.py attention_plan mirrors it): one chunk of kc keys as
// copied (f32-sized whatever the input dtype), its three bf16 planes
// ([kc][LD] each), the tile's f32 scores [rows][Tp] and the bias [Tp].
struct SplitLayout {
  size_t raw, planes, s, b, total;
  int kc;
};
template <int HD>
__host__ __device__ SplitLayout split_layout(int Tp, int rows) {
  constexpr int LD = Dims<HD>::LD;
  SplitLayout L;
  L.kc = Tp < KC ? Tp : KC;
  size_t o = 0;
  L.raw = o;
  o += al16((size_t)L.kc * HD * 4);
  L.planes = o;
  o += al16((size_t)PIECES * L.kc * LD * 2);
  L.s = o;
  o += (size_t)rows * Tp * 4;
  L.b = o;
  o += al16((size_t)Tp * 4);
  L.total = o;
  return L;
}

// Shared memory of the backward's second launch, kt keys a block: K and V
// (three planes each), one query tile's Q and dO as copied, two buffers of
// row statistics (this tile's, the next one's), the tile's Q and dO planes
// (where K and V, as copied, land first), one region of three planes
// ([query][key], kt + 8 a row) holding P, then dS, and the key tile's bias.
struct DkvSplitLayout {
  size_t k, v, rq, rd, st, st_size, q, d, pd, b, total;
};
template <int HD>
__host__ __device__ DkvSplitLayout dkv_split_layout(int kt) {
  constexpr int LD = Dims<HD>::LD;
  const size_t planes = al16((size_t)PIECES * kt * LD * 2);
  DkvSplitLayout L;
  L.st_size = al16((size_t)3 * kt * 4);
  size_t o = 0;
  L.k = o;
  o += planes;
  L.v = o;
  o += planes;
  L.rq = o;
  o += al16((size_t)kt * HD * 4);
  L.rd = o;
  o += al16((size_t)kt * HD * 4);
  L.st = o;
  o += 2 * L.st_size;
  L.q = o;
  o += planes;
  L.d = o;
  o += planes;
  L.pd = o;
  o += al16((size_t)PIECES * kt * (kt + 8) * 2);
  L.b = o;
  o += al16((size_t)kt * 4);
  L.total = o;
  return L;
}

// Rows [0, n) of src [., HD] (shared or device memory) as bf16 pieces into
// dst, piece p at dst + p * ps, each [n][LD]: rows past `valid` and the
// columns past HD zero. An f32 value splits into hi, mid and lo
// (doc_mma.cuh split_bf16x3); a bf16 one is its own hi (piece 0 only).
template <typename TIn, int HD>
__device__ __forceinline__ void split_rows(bf16* dst, size_t ps, const TIn* src, int n, int valid,
                                           int tid, int nthreads) {
  constexpr int LD = Dims<HD>::LD, G = Dims<HD>::HDK / 4;  // 4-column groups of a row
  for (int idx = tid; idx < n * G; idx += nthreads) {
    const int r = idx / G, c = (idx % G) * 4;
    const bool ok = r < valid && c < HD;
    bf16* d = dst + (size_t)r * LD + c;
    if constexpr (sizeof(TIn) == 4) {
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (ok) x = *reinterpret_cast<const float4*>(src + (size_t)r * HD + c);
      uint32_t lo[PIECES], hi[PIECES];
      split_bf16x3(x.x, x.y, lo);
      split_bf16x3(x.z, x.w, hi);
#pragma unroll
      for (int p = 0; p < PIECES; ++p)
        *reinterpret_cast<uint2*>(d + p * ps) = make_uint2(lo[p], hi[p]);
    } else {
      uint2 x = make_uint2(0u, 0u);
      if (ok) x = *reinterpret_cast<const uint2*>(src + (size_t)r * HD + c);
      *reinterpret_cast<uint2*>(d) = x;
    }
  }
}

// A fragments of 16 rows (row 0 at src in device memory; rows past `valid`
// zero) over the hd depth as bf16 pieces: a[p][ks] is piece p of k16 step
// ks in the A layout (rows g and g + 8, columns 2t, 2t + 1 and 8 on), the
// values load_a reads from the planes split_rows writes.
template <typename TIn, int HD>
__device__ __forceinline__ void load_a_split(uint32_t (&a)[Pieces<TIn>::N][Dims<HD>::KS][4],
                                             const TIn* src, int valid, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int ks = 0; ks < Dims<HD>::KS; ++ks) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = g + (j & 1) * 8, col = ks * 16 + (j >> 1) * 8 + 2 * t;
      const bool ok = row < valid && col < HD;
      if constexpr (sizeof(TIn) == 4) {
        float2 x = make_float2(0.0f, 0.0f);
        if (ok) x = *reinterpret_cast<const float2*>(src + (size_t)row * HD + col);
        uint32_t p[PIECES];
        split_bf16x3(x.x, x.y, p);
#pragma unroll
        for (int i = 0; i < PIECES; ++i) a[i][ks][j] = p[i];
      } else {
        a[0][ks][j] = ok ? *reinterpret_cast<const uint32_t*>(src + (size_t)row * HD + col) : 0u;
      }
    }
  }
}

// the A fragments (three pieces) of one k16 step from a thread's 8 f32
// values in the accumulator layout of two n8 tiles, which is the A layout
__device__ __forceinline__ void split_a(uint32_t (&a)[PIECES][4], const float (&x)[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t p[PIECES];
    split_bf16x3(x[2 * j], x[2 * j + 1], p);
#pragma unroll
    for (int i = 0; i < PIECES; ++i) a[i][j] = p[i];
  }
}

// the three pieces of (x, y) at element `at` of three planes ps apart
__device__ __forceinline__ void store_pieces(bf16* dst, size_t ps, size_t at, float x, float y) {
  uint32_t p[PIECES];
  split_bf16x3(x, y, p);
#pragma unroll
  for (int i = 0; i < PIECES; ++i) *reinterpret_cast<uint32_t*>(dst + i * ps + at) = p[i];
}

// acc[b][h] = A . B over the hd depth for the 16-key blocks b < nb of one
// group, B's columns the staged rows from rowb on (piece p at rowb + p *
// ps; K or V as [n][k]): the split products of A's PA pieces and B's PB,
// each over every (b, h) before the next, so that consecutive mma.sync go
// to different accumulators (up to 8 in flight).
template <int HD, int PA, int PB>
__device__ __forceinline__ void scores_group(float (&acc)[GROUP][2][4],
                                             const uint32_t (&a)[PA][Dims<HD>::KS][4],
                                             const bf16* rowb, size_t ps, int nb, int lane) {
  constexpr int LD = Dims<HD>::LD;
#pragma unroll
  for (int b = 0; b < GROUP; ++b)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][h][e] = 0.0f;
  const bf16* lrow = rowb + ((lane / 16) * 8 + lane % 8) * LD + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int ks = 0; ks < Dims<HD>::KS; ++ks) {
    uint32_t bf[GROUP][PB][4];
#pragma unroll
    for (int b = 0; b < GROUP; ++b) {
      if (b < nb) {
#pragma unroll
        for (int p = 0; p < PB; ++p) ldsm_x4(bf[b][p], lrow + p * ps + b * 16 * LD + ks * 16);
      }
    }
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      if (!live<PA, PB>(s)) continue;
      const int pa = piece_a(s) < PA ? piece_a(s) : 0, pb = piece_b(s) < PB ? piece_b(s) : 0;
#pragma unroll
      for (int b = 0; b < GROUP; ++b) {
        if (b < nb) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            mma_bf16(acc[b][h], a[pa][ks][0], a[pa][ks][1], a[pa][ks][2], a[pa][ks][3],
                     bf[b][pb][2 * h], bf[b][pb][2 * h + 1]);
        }
      }
    }
  }
}

// o[n] += A . B for one k16 step: A's PA pieces given, B the 16 staged rows
// from rowb on (piece p at rowb + p * ps) as [k][n], n over hd (V, K, dO
// or Q); the split products, each over every n tile before the next
template <int HD, int PA, int PB>
__device__ __forceinline__ void acc_hd(float (&o)[Dims<HD>::NT][4], const uint32_t (&a)[PA][4],
                                       const bf16* rowb, size_t ps, int lane) {
  constexpr int LD = Dims<HD>::LD, NT = Dims<HD>::NT;
  const bf16* lrow = rowb + (((lane / 8) % 2) * 8 + lane % 8) * LD;
  uint32_t bf[PB][NT][2];
#pragma unroll
  for (int p = 0; p < PB; ++p) {
    if constexpr (NT == 1) {
      ldsm_x2_t(bf[p][0], lrow + p * ps);
    } else {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t t[4];
        ldsm_x4_t(t, lrow + p * ps + np * 16 + (lane / 16) * 8);
        bf[p][2 * np][0] = t[0];
        bf[p][2 * np][1] = t[1];
        bf[p][2 * np + 1][0] = t[2];
        bf[p][2 * np + 1][1] = t[3];
      }
    }
  }
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    if (!live<PA, PB>(s)) continue;
    const int pa = piece_a(s) < PA ? piece_a(s) : 0, pb = piece_b(s) < PB ? piece_b(s) : 0;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma_bf16(o[n], a[pa][0], a[pa][1], a[pa][2], a[pa][3], bf[pb][n][0], bf[pb][n][1]);
  }
}

// The key ring of the forward and the backward's first launch: chunks of
// up to kc rows of K or V (one tensor a phase, each phase over every chunk
// in turn, forward or backward) are copied with cp.async into `raw` while
// the chunk before is in use, then split into the three planes every warp
// reads. Bit p of `of_v` says phase p streams V (else K), bit p of `back`
// that it runs from the last chunk to the first. Every thread of the block
// calls issue(0) once, then next(i) for i = 0, 1, ... in turn.
template <typename TIn, int HD>
struct KeyRing {
  const TIn* k;  // K and V at row r
  const TIn* v;
  unsigned of_v, back;
  int T, kc, nc, steps;
  unsigned char* raw;
  bf16* planes;

  __device__ size_t ps() const { return (size_t)kc * Dims<HD>::LD; }  // between two planes
  __device__ int rows_of(int c) const { return min(kc, T - c * kc); }
  __device__ bool is_v(int i) const { return (of_v >> (i / nc)) & 1u; }
  __device__ int chunk(int i) const { return (back >> (i / nc)) & 1u ? nc - 1 - i % nc : i % nc; }
  // a step whose chunk the planes hold already (the step before took it)
  __device__ bool held(int i) const {
    return i > 0 && is_v(i) == is_v(i - 1) && chunk(i) == chunk(i - 1);
  }

  __device__ void issue(int i) {
    if (i < steps && !held(i)) {
      const int c = chunk(i);
      const char* s = reinterpret_cast<const char*>((is_v(i) ? v : k) + (size_t)c * kc * HD);
      const int n = rows_of(c) * HD * (int)sizeof(TIn) / 16;
      for (int e = threadIdx.x; e < n; e += blockDim.x) cp_async16(raw + e * 16, s + e * 16);
    }
    cp_async_commit();
  }

  __device__ void next(int i) {
    cp_async_wait<0>();
    __syncthreads();  // chunk i has landed; every warp is done with the planes
    if (!held(i)) {
      const int n = rows_of(chunk(i));
      split_rows<TIn, HD>(planes, ps(), reinterpret_cast<const TIn*>(raw), (n + 15) / 16 * 16,
                          n, threadIdx.x, blockDim.x);
    }
    __syncthreads();
    issue(i + 1);  // `raw` is free again
  }
};

// Forward at f32 compute, one block per (row r, tile of `rows` query rows,
// 16 a warp): the warp's scores against each chunk of keys, kept in shared
// memory as f32, then the row sums, then O += P V over the chunks of
// values, p split in registers.
// Both kernels are built for two blocks a SM at hd <= 32 (at most 128
// registers a thread at 256 threads, so that one block's chunk waits and
// barriers hide behind the other's products), one at hd = 64, where the
// scores of T = 512 fill the SM's shared memory anyway.
template <typename TIn, int HD>
__global__ void __launch_bounds__(256, HD <= 32 ? 2 : 1) attention_fwd_split(int T, int rows, float scale,
                                                           const TIn* __restrict__ q,
                                                           const TIn* __restrict__ k,
                                                           const TIn* __restrict__ v,
                                                           const float* __restrict__ bias,
                                                           float* __restrict__ out) {
  using D = Dims<HD>;
  constexpr int PI = Pieces<TIn>::N;
  const int Tp = (T + 15) / 16 * 16;
  const SplitLayout L = split_layout<HD>(Tp, rows);
  extern __shared__ __align__(16) unsigned char tsm[];
  float* s_s = reinterpret_cast<float*>(tsm + L.s);
  float* b_s = reinterpret_cast<float*>(tsm + L.b);
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const size_t r = blockIdx.x, base = r * T * HD;
  const int i0 = blockIdx.y * rows + warp * 16;  // the warp's first query row
  const int nc = (T + L.kc - 1) / L.kc;
  // K (scores), then V (O += P V)
  KeyRing<TIn, HD> ring{k + base, v + base, 0b10u, 0u, T, L.kc, nc, 2 * nc,
                        tsm + L.raw, reinterpret_cast<bf16*>(tsm + L.planes)};
  ring.issue(0);
  for (int j = tid; j < Tp; j += nt) b_s[j] = j < T ? bias[r * T + j] : neg_inf();

  float* sw = s_s + (size_t)warp * Tp * 16;  // the warp's scores, 256 floats a 16-key block
  float m[2] = {neg_inf(), neg_inf()}, l[2];
  int i = 0;
  {
    uint32_t qa[PI][D::KS][4];
    load_a_split<TIn, HD>(qa, q + base + (size_t)i0 * HD, T - i0, lane);
    for (int c = 0; c < nc; ++c, ++i) {
      ring.next(i);
      const int nb = (ring.rows_of(c) + 15) / 16, kb0 = c * L.kc / 16;
      float acc[GROUP][2][4];
      scores_group<HD, PI, PI>(acc, qa, ring.planes, ring.ps(), nb, lane);
#pragma unroll
      for (int b = 0; b < GROUP; ++b) {
        if (b < nb) {
          float s[8];
          scores16(s, acc[b], b_s, (kb0 + b) * 16 + tig * 2, scale);
#pragma unroll
          for (int e = 0; e < 8; ++e) m[upper(e)] = fmaxf(m[upper(e)], s[e]);
          put8(sw + ((kb0 + b) * 32 + lane) * 8, s);
        }
      }
    }
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  sum_pass(sw, 0, Tp / 16, lane, m, l);

  float o[D::NT][4] = {};
  for (int c = 0; c < nc; ++c, ++i) {
    ring.next(i);
    const int nb = (ring.rows_of(c) + 15) / 16, kb0 = c * L.kc / 16;
#pragma unroll
    for (int b = 0; b < GROUP; ++b) {
      if (b < nb) {
        float ex[8], p[8];
        uint32_t pa[PIECES][4];
        get8(sw + ((kb0 + b) * 32 + lane) * 8, ex);
        div8(p, ex, l);
        split_a(pa, p);
        acc_hd<HD, PIECES, PI>(o, pa, ring.planes + (size_t)b * 16 * D::LD, ring.ps(), lane);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = i0 + gid + h * 8;
    if (row < T)
#pragma unroll
      for (int n = 0; n < D::NT; ++n)
        *reinterpret_cast<float2*>(out + base + (size_t)row * HD + n * 8 + tig * 2) =
            make_float2(o[n][2 * h], o[n][2 * h + 1]);
  }
}

// Backward at f32 compute, launch 1 (per query tile): the row statistics
// and dq, the ring streaming K (scores), V twice (dP for the row term,
// then for dS) and K again (dQ += dS K).
template <typename TIn, int HD>
__global__ void __launch_bounds__(256, HD <= 32 ? 2 : 1) attention_bwd_dq_split(
    int R, int T, int rows, float scale, const TIn* __restrict__ q, const TIn* __restrict__ k,
    const TIn* __restrict__ v, const float* __restrict__ bias, const float* __restrict__ dout,
    float* __restrict__ dq, float* __restrict__ stats) {
  using D = Dims<HD>;
  constexpr int PI = Pieces<TIn>::N;
  const int Tp = (T + 15) / 16 * 16;
  const SplitLayout L = split_layout<HD>(Tp, rows);
  extern __shared__ __align__(16) unsigned char tsm[];
  float* s_s = reinterpret_cast<float*>(tsm + L.s);
  float* b_s = reinterpret_cast<float*>(tsm + L.b);
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const size_t r = blockIdx.x, base = r * T * HD;
  const int i0 = blockIdx.y * rows + warp * 16;
  const int nc = (T + L.kc - 1) / L.kc;
  // K (scores), V (dP, the row term), V from its last chunk back (dP, dS:
  // the chunk the row term ended on is held), K (dQ += dS K)
  KeyRing<TIn, HD> ring{k + base, v + base, 0b0110u, 0b0100u, T, L.kc, nc, 4 * nc,
                        tsm + L.raw, reinterpret_cast<bf16*>(tsm + L.planes)};
  ring.issue(0);
  for (int j = tid; j < Tp; j += nt) b_s[j] = j < T ? bias[r * T + j] : neg_inf();

  float* sw = s_s + (size_t)warp * Tp * 16;
  float m[2] = {neg_inf(), neg_inf()}, l[2], row[2] = {0.0f, 0.0f};
  int i = 0;
  {
    uint32_t qa[PI][D::KS][4];
    load_a_split<TIn, HD>(qa, q + base + (size_t)i0 * HD, T - i0, lane);
    for (int c = 0; c < nc; ++c, ++i) {
      ring.next(i);
      const int nb = (ring.rows_of(c) + 15) / 16, kb0 = c * L.kc / 16;
      float acc[GROUP][2][4];
      scores_group<HD, PI, PI>(acc, qa, ring.planes, ring.ps(), nb, lane);
#pragma unroll
      for (int b = 0; b < GROUP; ++b) {
        if (b < nb) {
          float s[8];
          scores16(s, acc[b], b_s, (kb0 + b) * 16 + tig * 2, scale);
#pragma unroll
          for (int e = 0; e < 8; ++e) m[upper(e)] = fmaxf(m[upper(e)], s[e]);
          put8(sw + ((kb0 + b) * 32 + lane) * 8, s);
        }
      }
    }
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  sum_pass(sw, 0, Tp / 16, lane, m, l);

  {
    uint32_t da[PIECES][D::KS][4];
    load_a_split<float, HD>(da, dout + base + (size_t)i0 * HD, T - i0, lane);
    // row = rowsum(dp * p), p in f32, kept in place of exp(s - m)
    for (int c = 0; c < nc; ++c, ++i) {
      ring.next(i);
      const int nb = (ring.rows_of(c) + 15) / 16, kb0 = c * L.kc / 16;
      float acc[GROUP][2][4];
      scores_group<HD, PIECES, PI>(acc, da, ring.planes, ring.ps(), nb, lane);
#pragma unroll
      for (int b = 0; b < GROUP; ++b) {
        if (b < nb) {
          float ex[8], p[8];
          float* slot = sw + ((kb0 + b) * 32 + lane) * 8;
          get8(slot, ex);
          div8(p, ex, l);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            row[upper(e)] = __fmaf_rn(acc[b][e / 4][e % 4], p[e], row[upper(e)]);
          put8(slot, p);
        }
      }
    }
    row[0] = quad_sum(row[0]);
    row[1] = quad_sum(row[1]);
    // ds = p * (dp - row) * scale from dp once more, kept in place of p
    for (int c = nc - 1; c >= 0; --c, ++i) {
      ring.next(i);
      const int nb = (ring.rows_of(c) + 15) / 16, kb0 = c * L.kc / 16;
      float acc[GROUP][2][4];
      scores_group<HD, PIECES, PI>(acc, da, ring.planes, ring.ps(), nb, lane);
#pragma unroll
      for (int b = 0; b < GROUP; ++b) {
        if (b < nb) {
          float p[8], ds[8];
          float* slot = sw + ((kb0 + b) * 32 + lane) * 8;
          get8(slot, p);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            ds[e] = dscore(p[e], acc[b][e / 4][e % 4], row[upper(e)], scale);
          put8(slot, ds);
        }
      }
    }
  }

  // dq += ds k, ds split in registers (the accumulator layout)
  float g[D::NT][4] = {};
  for (int c = 0; c < nc; ++c, ++i) {
    ring.next(i);
    const int nb = (ring.rows_of(c) + 15) / 16, kb0 = c * L.kc / 16;
#pragma unroll
    for (int b = 0; b < GROUP; ++b) {
      if (b < nb) {
        float ds[8];
        uint32_t a[PIECES][4];
        get8(sw + ((kb0 + b) * 32 + lane) * 8, ds);
        split_a(a, ds);
        acc_hd<HD, PIECES, PI>(g, a, ring.planes + (size_t)b * 16 * D::LD, ring.ps(), lane);
      }
    }
  }
  const size_t plane = (size_t)R * T;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = i0 + gid + h * 8;
    if (qi < T) {
#pragma unroll
      for (int n = 0; n < D::NT; ++n)
        *reinterpret_cast<float2*>(dq + base + (size_t)qi * HD + n * 8 + tig * 2) =
            make_float2(g[n][2 * h], g[n][2 * h + 1]);
      if (tig == 0) {
        stats[r * T + qi] = m[h];
        stats[plane + r * T + qi] = l[h];
        stats[2 * plane + r * T + qi] = row[h];
      }
    }
  }
}

// Backward at f32 compute, launch 2 (per tile of kt keys): dk and dv,
// summed over the query tiles in order. K and V, then each query tile's Q,
// dO and row statistics, are copied with cp.async (the next tile's while
// this one is used); P and dS are recomputed with the roles, products and
// order of launch 1 (so p is the p behind the stored statistics, bit for
// bit) and take turns in one region of three planes: P for dV += P^T dO,
// then dS for dK += dS^T Q.
template <typename TIn, int HD>
__global__ void __launch_bounds__(128) attention_bwd_dkv_split(
    int R, int T, int kt, float scale, const TIn* __restrict__ q, const TIn* __restrict__ k,
    const TIn* __restrict__ v, const float* __restrict__ bias, const float* __restrict__ dout,
    float* __restrict__ dk, float* __restrict__ dv, const float* __restrict__ stats) {
  using D = Dims<HD>;
  constexpr int PI = Pieces<TIn>::N;
  const DkvSplitLayout L = dkv_split_layout<HD>(kt);
  extern __shared__ __align__(16) unsigned char tsm[];
  bf16* k_s = reinterpret_cast<bf16*>(tsm + L.k);
  bf16* v_s = reinterpret_cast<bf16*>(tsm + L.v);
  bf16* q_s = reinterpret_cast<bf16*>(tsm + L.q);
  bf16* d_s = reinterpret_cast<bf16*>(tsm + L.d);
  bf16* pd_s = reinterpret_cast<bf16*>(tsm + L.pd);  // P, then dS: [query][key], three planes
  unsigned char* rq = tsm + L.rq;
  unsigned char* rd = tsm + L.rd;
  float* b_s = reinterpret_cast<float*>(tsm + L.b);
  const size_t kps = (size_t)kt * D::LD;  // from one plane of K, V, Q or dO to the next
  const int pld = kt + 8;
  const size_t pps = (size_t)kt * pld;  // from one plane of P or dS to the next
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const size_t r = blockIdx.x, base = r * T * HD, plane = (size_t)R * T;
  const int j0 = blockIdx.y * kt, kvalid = min(kt, T - j0);
  const int nblk = (T + kt - 1) / kt;  // query tiles of kt rows
  // the statistics of query tile blk: [m, l, row][kt] f32
  auto stats_of = [&](int blk) {
    return reinterpret_cast<float*>(tsm + L.st + (size_t)(blk & 1) * L.st_size);
  };

  // query tile blk's Q and dO rows into rq and rd, its statistics into its
  // buffer (rows past T: m = 0, l = 1, row = 0)
  auto issue = [&](int blk) {
    const int i0 = blk * kt, valid = min(kt, T - i0);
    const char* sq = reinterpret_cast<const char*>(q + base + (size_t)i0 * HD);
    const char* sd = reinterpret_cast<const char*>(dout + base + (size_t)i0 * HD);
    const int nq = valid * HD * (int)sizeof(TIn) / 16, nd = valid * HD * 4 / 16;
    for (int e = tid; e < nq; e += nt) cp_async16(rq + e * 16, sq + e * 16);
    for (int e = tid; e < nd; e += nt) cp_async16(rd + e * 16, sd + e * 16);
    float* sm = stats_of(blk);
    for (int c = tid; c < kt; c += nt) {
      if (c < valid) {
        const size_t at = r * T + i0 + c;
        cp_async4(sm + c, stats + at);
        cp_async4(sm + kt + c, stats + plane + at);
        cp_async4(sm + 2 * kt + c, stats + 2 * plane + at);
      } else {
        sm[c] = 0.0f;
        sm[kt + c] = 1.0f;
        sm[2 * kt + c] = 0.0f;
      }
    }
    cp_async_commit();
  };
  {  // the key tile's K and V as copied, into the space of the Q and dO planes
    const char* sk = reinterpret_cast<const char*>(k + base + (size_t)j0 * HD);
    const char* sv = reinterpret_cast<const char*>(v + base + (size_t)j0 * HD);
    const int n = kvalid * HD * (int)sizeof(TIn) / 16;
    for (int e = tid; e < n; e += nt) {
      cp_async16(tsm + L.q + e * 16, sk + e * 16);
      cp_async16(tsm + L.d + e * 16, sv + e * 16);
    }
  }
  issue(0);  // one group: K, V and query tile 0
  for (int c = tid; c < kt; c += nt) b_s[c] = j0 + c < T ? bias[r * T + j0 + c] : neg_inf();
  cp_async_wait<0>();
  __syncthreads();
  split_rows<TIn, HD>(k_s, kps, reinterpret_cast<const TIn*>(tsm + L.q), kt, kvalid, tid, nt);
  split_rows<TIn, HD>(v_s, kps, reinterpret_cast<const TIn*>(tsm + L.d), kt, kvalid, tid, nt);

  float gk[D::NT][4] = {}, gv[D::NT][4] = {};
  // A = P^T or dS^T (keys x queries) from [query][key] planes: ldmatrix.trans
  const int ar = (lane / 16) * 8 + lane % 8, ac = warp * 16 + ((lane / 8) % 2) * 8;
#pragma unroll 1
  for (int blk = 0; blk < nblk; ++blk) {
    const int valid = min(kt, T - blk * kt);
    cp_async_wait<0>();
    __syncthreads();  // tile blk has landed; every warp is done with K and V as copied (blk 0)
                      // and with tile blk - 1
    split_rows<TIn, HD>(q_s, kps, reinterpret_cast<const TIn*>(rq), kt, valid, tid, nt);
    split_rows<float, HD>(d_s, kps, reinterpret_cast<const float*>(rd), kt, valid, tid, nt);
    __syncthreads();
    if (blk + 1 < nblk) issue(blk + 1);  // rq, rd and the other statistics buffer are free

    // P and dS of the warp's 16 queries against the key tile, as launch 1
    // computes them (Q the A operand, K the B operand); P to shared memory
    const int qr = warp * 16 + gid, nb = kt / 16;
    float ds[GROUP][8];
    {
      const float* sm = stats_of(blk);
      const float m[2] = {sm[qr], sm[qr + 8]};
      const float l[2] = {sm[kt + qr], sm[kt + qr + 8]};
      const float row[2] = {sm[2 * kt + qr], sm[2 * kt + qr + 8]};
      float acc[GROUP][2][4], p[GROUP][8];
      {
        uint32_t qa[PI][D::KS][4];
#pragma unroll
        for (int pp = 0; pp < PI; ++pp) load_a<HD>(qa[pp], q_s + pp * kps + warp * 16 * D::LD, lane);
        scores_group<HD, PI, PI>(acc, qa, k_s, kps, nb, lane);
      }
#pragma unroll
      for (int b = 0; b < GROUP; ++b) {
        if (b < nb) {
          float s[8];
          scores16(s, acc[b], b_s, b * 16 + tig * 2, scale);
          probs8(p[b], s, m, l);
        }
      }
      {
        uint32_t da[PIECES][D::KS][4];
#pragma unroll
        for (int pp = 0; pp < PIECES; ++pp)
          load_a<HD>(da[pp], d_s + pp * kps + warp * 16 * D::LD, lane);
        scores_group<HD, PIECES, PI>(acc, da, v_s, kps, nb, lane);
      }
#pragma unroll
      for (int b = 0; b < GROUP; ++b) {
        if (b < nb) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            ds[b][e] = dscore(p[b][e], acc[b][e / 4][e % 4], row[upper(e)], scale);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const size_t at = (size_t)qr * pld + b * 16 + h * 8 + tig * 2;
            store_pieces(pd_s, pps, at, p[b][4 * h], p[b][4 * h + 1]);
            store_pieces(pd_s, pps, at + 8 * pld, p[b][4 * h + 2], p[b][4 * h + 3]);
          }
        }
      }
    }
    __syncthreads();

    // dv += p^T do over this tile's queries, for the warp's 16 keys
#pragma unroll 1
    for (int ks = 0; ks < kt / 16; ++ks) {
      uint32_t a[PIECES][4];
#pragma unroll
      for (int pp = 0; pp < PIECES; ++pp)
        ldsm_x4_t(a[pp], pd_s + pp * pps + (ks * 16 + ar) * pld + ac);
      acc_hd<HD, PIECES, PIECES>(gv, a, d_s + (size_t)ks * 16 * D::LD, kps, lane);
    }
    __syncthreads();  // every warp is done with P
#pragma unroll
    for (int b = 0; b < GROUP; ++b) {
      if (b < nb) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t at = (size_t)qr * pld + b * 16 + h * 8 + tig * 2;
          store_pieces(pd_s, pps, at, ds[b][4 * h], ds[b][4 * h + 1]);
          store_pieces(pd_s, pps, at + 8 * pld, ds[b][4 * h + 2], ds[b][4 * h + 3]);
        }
      }
    }
    __syncthreads();

    // dk += ds^T q over this tile's queries, for the warp's 16 keys
#pragma unroll 1
    for (int ks = 0; ks < kt / 16; ++ks) {
      uint32_t a[PIECES][4];
#pragma unroll
      for (int pp = 0; pp < PIECES; ++pp)
        ldsm_x4_t(a[pp], pd_s + pp * pps + (ks * 16 + ar) * pld + ac);
      acc_hd<HD, PIECES, PI>(gk, a, q_s + (size_t)ks * 16 * D::LD, kps, lane);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j0 + warp * 16 + gid + h * 8;
    if (j < T)
#pragma unroll
      for (int n = 0; n < D::NT; ++n) {
        const size_t o = base + (size_t)j * HD + n * 8 + tig * 2;
        *reinterpret_cast<float2*>(dk + o) = make_float2(gk[n][2 * h], gk[n][2 * h + 1]);
        *reinterpret_cast<float2*>(dv + o) = make_float2(gv[n][2 * h], gv[n][2 * h + 1]);
      }
  }
}

struct Args {
  int R, T;
  float scale;
  const void *q, *k, *v;
  const float *bias, *dout;
  float *out, *dq, *dk, *dv, *stats;
  cudaStream_t stream;
  int rows, kv_shared, ks, kt;  // the query tile, V over K and key halves (bf16), the key tile
};

// Dynamic shared memory above 48 KB must be allowed first; a refusal (more
// than the SM holds) is returned and cleared, so no later check sees it.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// a tile of 16 to `most` rows, a multiple of 16 (one warp a 16 rows)
bool tile_ok(int rows, int most = 128) { return rows >= 16 && rows <= most && rows % 16 == 0; }

// ks key halves of a tile: two only where the block stays within 8 warps
// and each warp's accumulators fit the scores' region (Tp >= hd)
bool split_ok(int rows, int ks, int Tp, int hd) {
  return ks == 1 || (ks == 2 && rows <= 64 && Tp >= 32 && Tp >= hd);
}

template <typename TIn, bool CBF16, int HD>
int fwd(const Args& a) {
  if constexpr (CBF16) {
    const int Tp = (a.T + 15) / 16 * 16;
    if (!tile_ok(a.rows) || a.rows > Tp || !split_ok(a.rows, a.ks, Tp, HD))
      return (int)cudaErrorInvalidValue;
    const size_t smem = fwd_layout<HD>(Tp, a.rows, a.kv_shared).total;
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    auto kernel = attention_fwd_mma<TIn, HD>;
    if (const int e = allow_smem(kernel, smem)) return e;
    const dim3 grid(a.R, (a.T + a.rows - 1) / a.rows);
    kernel<<<grid, a.rows * 2 * a.ks, smem, a.stream>>>(
        a.T, a.rows, a.kv_shared, a.ks, a.scale, static_cast<const TIn*>(a.q),
        static_cast<const TIn*>(a.k), static_cast<const TIn*>(a.v), a.bias, a.out);
  } else {
    const int Tp = (a.T + 15) / 16 * 16;
    if (!tile_ok(a.rows) || a.rows > Tp) return (int)cudaErrorInvalidValue;
    const size_t smem = split_layout<HD>(Tp, a.rows).total;
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    auto kernel = attention_fwd_split<TIn, HD>;
    if (const int e = allow_smem(kernel, smem)) return e;
    const dim3 grid(a.R, (a.T + a.rows - 1) / a.rows);
    kernel<<<grid, a.rows * 2, smem, a.stream>>>(
        a.T, a.rows, a.scale, static_cast<const TIn*>(a.q), static_cast<const TIn*>(a.k),
        static_cast<const TIn*>(a.v), a.bias, a.out);
  }
  return (int)cudaGetLastError();
}

template <typename TIn, bool CBF16, int HD>
int bwd(const Args& a) {
  const TIn* q = static_cast<const TIn*>(a.q);
  const TIn* k = static_cast<const TIn*>(a.k);
  const TIn* v = static_cast<const TIn*>(a.v);
  if constexpr (CBF16) {
    const int Tp = (a.T + 15) / 16 * 16;
    if (!tile_ok(a.rows) || a.rows > Tp || !split_ok(a.rows, a.ks, Tp, HD) ||
        !tile_ok(a.kt, 64) || a.kt > Tp)
      return (int)cudaErrorInvalidValue;
    const size_t dq_smem = dq_layout<HD>(Tp, a.rows, a.kv_shared).total;
    const size_t dkv_smem = dkv_layout<HD>(a.kt).total;
    if (dq_smem > (size_t)SMEM_LIMIT || dkv_smem > (size_t)SMEM_LIMIT)
      return (int)cudaErrorInvalidValue;
    auto dq_kernel = attention_bwd_dq_mma<TIn, HD>;
    auto dkv_kernel = attention_bwd_dkv_mma<TIn, HD>;
    if (const int e = allow_smem(dq_kernel, dq_smem)) return e;
    if (const int e = allow_smem(dkv_kernel, dkv_smem)) return e;
    dq_kernel<<<dim3(a.R, (a.T + a.rows - 1) / a.rows), a.rows * 2 * a.ks, dq_smem, a.stream>>>(
        a.R, a.T, a.rows, a.kv_shared, a.ks, a.scale, q, k, v, a.bias, a.dout, a.dq, a.stats);
    if (const cudaError_t e = cudaGetLastError()) return (int)e;
    dkv_kernel<<<dim3(a.R, (a.T + a.kt - 1) / a.kt), a.kt * 2, dkv_smem, a.stream>>>(
        a.R, a.T, a.kt, a.scale, q, k, v, a.bias, a.dout, a.dk, a.dv, a.stats);
  } else {
    const int Tp = (a.T + 15) / 16 * 16;
    if (!tile_ok(a.rows) || a.rows > Tp || !tile_ok(a.kt, 64) || a.kt > Tp)
      return (int)cudaErrorInvalidValue;
    const size_t dq_smem = split_layout<HD>(Tp, a.rows).total;
    const size_t dkv_smem = dkv_split_layout<HD>(a.kt).total;
    if (dq_smem > (size_t)SMEM_LIMIT || dkv_smem > (size_t)SMEM_LIMIT)
      return (int)cudaErrorInvalidValue;
    auto dq_kernel = attention_bwd_dq_split<TIn, HD>;
    auto dkv_kernel = attention_bwd_dkv_split<TIn, HD>;
    if (const int e = allow_smem(dq_kernel, dq_smem)) return e;
    if (const int e = allow_smem(dkv_kernel, dkv_smem)) return e;
    dq_kernel<<<dim3(a.R, (a.T + a.rows - 1) / a.rows), a.rows * 2, dq_smem, a.stream>>>(
        a.R, a.T, a.rows, a.scale, q, k, v, a.bias, a.dout, a.dq, a.stats);
    if (const cudaError_t e = cudaGetLastError()) return (int)e;
    dkv_kernel<<<dim3(a.R, (a.T + a.kt - 1) / a.kt), a.kt * 2, dkv_smem, a.stream>>>(
        a.R, a.T, a.kt, a.scale, q, k, v, a.bias, a.dout, a.dk, a.dv, a.stats);
  }
  return (int)cudaGetLastError();
}

template <template <typename, bool, int> class Op, typename TIn, bool CBF16>
int by_width(int hd, const Args& a) {
  switch (hd) {
    case 8: return Op<TIn, CBF16, 8>::run(a);
    case 16: return Op<TIn, CBF16, 16>::run(a);
    case 32: return Op<TIn, CBF16, 32>::run(a);
    case 64: return Op<TIn, CBF16, 64>::run(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TIn, bool CBF16, int HD>
struct Fwd {
  static int run(const Args& a) { return fwd<TIn, CBF16, HD>(a); }
};

template <typename TIn, bool CBF16, int HD>
struct Bwd {
  static int run(const Args& a) { return bwd<TIn, CBF16, HD>(a); }
};

template <template <typename, bool, int> class Op>
int dispatch(int device, int in_bf16, int cdt_bf16, int hd, const Args& a) {
  if (a.R < 0 || a.T < 1 || a.T > MAX_T) return (int)cudaErrorInvalidValue;
  if (hd != 8 && hd != 16 && hd != 32 && hd != 64) return (int)cudaErrorInvalidValue;
  if (a.R == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (in_bf16)
    return cdt_bf16 ? by_width<Op, __nv_bfloat16, true>(hd, a)
                    : by_width<Op, __nv_bfloat16, false>(hd, a);
  return cdt_bf16 ? by_width<Op, float, true>(hd, a) : by_width<Op, float, false>(hd, a);
}

}  // namespace

extern "C" {

// q, k, v [R, T, hd] in bf16 (in_bf16) or f32, 16-byte aligned; bias [R, T]
// f32; out [R, T, hd] f32; cdt_bf16 rounds every product's operands to
// bf16, else every product is split (f32 compute). hd in {8, 16, 32, 64},
// 1 <= T <= 512. rows: query rows a block (16 to 128, a multiple of 16),
// from ops/attention.py attention_plan; bf16 compute also takes kv_shared
// (V staged over K) and ks (1, or 2: each tile's keys split over two
// warps), which f32 compute ignores. A layout beyond the SM's shared
// memory is refused. device: the CUDA ordinal the
// tensors live on (this library carries its own runtime, whose current
// device is not PyTorch's). Returns cudaGetLastError() after the launch (0
// on success).
int attention_fwd_launch(int device, int in_bf16, int cdt_bf16, int R, int T, int hd, float scale,
                         int rows, int kv_shared, int ks, const void* q, const void* k,
                         const void* v, const void* bias, void* out, void* stream) {
  Args a{R, T, scale, q, k, v, static_cast<const float*>(bias), nullptr,
         static_cast<float*>(out), nullptr, nullptr, nullptr, nullptr,
         static_cast<cudaStream_t>(stream), rows, kv_shared, ks, 0};
  return dispatch<Fwd>(device, in_bf16, cdt_bf16, hd, a);
}

// As the forward, plus the output cotangent dout [R, T, hd] f32; writes dq,
// dk, dv [R, T, hd] f32 and uses stats [3, R, T] f32 as scratch between its
// two launches. rows: query rows a block of the first launch (bf16
// compute, kv_shared: V staged over K, then K over V again; ks as the
// forward's), kt keys (and query rows a staged tile) a block of the second.
int attention_bwd_launch(int device, int in_bf16, int cdt_bf16, int R, int T, int hd, float scale,
                         int rows, int kv_shared, int ks, int kt, const void* q,
                         const void* k, const void* v, const void* bias, const void* dout,
                         void* dq, void* dk, void* dv, void* stats, void* stream) {
  Args a{R, T, scale, q, k, v, static_cast<const float*>(bias), static_cast<const float*>(dout),
         nullptr, static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
         static_cast<float*>(stats), static_cast<cudaStream_t>(stream), rows, kv_shared, ks, kt};
  return dispatch<Bwd>(device, in_bf16, cdt_bf16, hd, a);
}

const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
