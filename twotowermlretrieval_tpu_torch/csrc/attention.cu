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
// f32 compute keeps the CUDA-core kernels: TF32 tensor cores would round
// the operands, and the JAX f32 path asks for HIGHEST precision. One block
// per (row r, tile of up to 128 query rows) stages row r's keys and values
// in shared memory as f32, the whole T up to 256 keys and chunks of 256
// beyond (staged again for each pass, so every T up to 512 fits at every
// head width); each thread owns one query row and recomputes its scores
// from shared memory in three passes (maximum, sum, output), each over the
// keys in order. The backward is the same two launches as above, one thread
// per query (then key) row, every sum in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "recur_chain.cuh"

namespace {

using recur_chain::cp_async16;
using recur_chain::cp_async_commit;
using recur_chain::cp_async_wait;
using recur_chain::ldsm_x2_t;
using recur_chain::ldsm_x4;
using recur_chain::ldsm_x4_t;
using recur_chain::mma_bf16;

constexpr int TILE = 128;  // f32 compute: query (or key) rows per block, one per thread
constexpr int MAX_T = 512;
constexpr int SMEM_LIMIT = recur_chain::SMEM_LIMIT;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// the score of one (query, key) pair: (dot * scale) + bias, each rounded
__device__ __forceinline__ float score(float dot, float scale, float bias) {
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

// p * (dp - row) * scale, each step rounded as the TPU kernel's
__device__ __forceinline__ float dscore(float p, float dp, float row, float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, row)), scale);
}

// ---------------------------------------------------------------------------
// f32 compute: full f32 products on the CUDA cores
// ---------------------------------------------------------------------------

// n elements of src into dst as f32
template <typename TIn>
__device__ __forceinline__ void stage(const TIn* __restrict__ src, int n, float* dst) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = to_f32(src[e]);
}

template <typename TIn, int HD>
__device__ __forceinline__ void load_row(const TIn* __restrict__ src, float (&dst)[HD]) {
#pragma unroll
  for (int d = 0; d < HD; ++d) dst[d] = to_f32(src[d]);
}

// f32 dot product of a register row and a 16-byte aligned shared-memory
// row, summed in the order d = 0..HD-1 (fmaf is symmetric in its first two
// arguments, so dot(a, b) and dot(b, a) are the same float)
template <int HD>
__device__ __forceinline__ float dot(const float (&a)[HD], const float* __restrict__ b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 w = *reinterpret_cast<const float4*>(b + d);
    s = fmaf(a[d], w.x, s);
    s = fmaf(a[d + 1], w.y, s);
    s = fmaf(a[d + 2], w.z, s);
    s = fmaf(a[d + 3], w.w, s);
  }
  return s;
}

// y += a * x over a shared-memory row x
template <int HD>
__device__ __forceinline__ void axpy(float a, const float* __restrict__ x, float (&y)[HD]) {
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 w = *reinterpret_cast<const float4*>(x + d);
    y[d] = fmaf(a, w.x, y[d]);
    y[d + 1] = fmaf(a, w.y, y[d + 1]);
    y[d + 2] = fmaf(a, w.z, y[d + 2]);
    y[d + 3] = fmaf(a, w.w, y[d + 3]);
  }
}

template <int HD>
__device__ __forceinline__ void store_row(const float (&src)[HD], float* __restrict__ dst) {
#pragma unroll
  for (int d = 0; d < HD; ++d) dst[d] = src[d];
}

// Keys (or, in the backward's second launch, query rows) of the f32 kernels
// staged in shared memory at a time: the whole T where T <= F32_KEYS, else
// chunks of F32_KEYS, staged again for every pass over the keys. Each pass
// still walks the keys in order 0 .. T-1, so the sums and their rounding
// are those of one whole-T stage.
constexpr int F32_KEYS = 256;

// Shared memory of the f32 kernels (ops/attention.py attention_plan mirrors
// it): two [kc][hd] f32 operands and `vecs` [T] f32 vectors.
__host__ __device__ constexpr size_t f32_smem(int T, int hd, int vecs) {
  return (2 * (size_t)(T < F32_KEYS ? T : F32_KEYS) * hd + (size_t)vecs * T) * sizeof(float);
}

// Rows c0 .. c0 + kc - 1 (at most T) of two [T][HD] operands into a_s and
// b_s as f32; where one chunk holds the whole T, only its first call
// (c0 = 0, first) stages. Every thread of the block calls it.
template <typename TA, typename TB, int HD>
__device__ __forceinline__ void stage_chunk(const TA* __restrict__ a, const TB* __restrict__ b,
                                            int T, int c0, int kc, bool first, float* a_s,
                                            float* b_s) {
  if (kc >= T && !first) return;
  const int n = (T - c0 < kc ? T - c0 : kc) * HD;
  __syncthreads();  // the previous chunk's reads are complete
  stage<TA>(a + (size_t)c0 * HD, n, a_s);
  if (b != nullptr) stage<TB>(b + (size_t)c0 * HD, n, b_s);
  __syncthreads();
}

template <typename TIn, int HD>
__global__ void __launch_bounds__(TILE) attention_fwd_kernel(
    int T, float scale, const TIn* __restrict__ q, const TIn* __restrict__ k,
    const TIn* __restrict__ v, const float* __restrict__ bias, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int kc = T < F32_KEYS ? T : F32_KEYS;
  float* k_s = smem;                   // [kc][HD]
  float* v_s = k_s + (size_t)kc * HD;  // [kc][HD]
  float* b_s = v_s + (size_t)kc * HD;  // [T]
  const size_t r = blockIdx.x;
  const size_t base = r * T * HD;
  for (int j = threadIdx.x; j < T; j += blockDim.x) b_s[j] = bias[r * T + j];
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = i < T;  // rows past T stay for the barriers

  float qr[HD];
  load_row<TIn, HD>(q + base + (size_t)(live ? i : 0) * HD, qr);
  float m = __int_as_float(0xff800000);  // -inf
  for (int c0 = 0; c0 < T; c0 += kc) {
    stage_chunk<TIn, TIn, HD>(k + base, v + base, T, c0, kc, c0 == 0, k_s, v_s);
    const int n = T - c0 < kc ? T - c0 : kc;
    for (int j = 0; j < n; ++j) m = fmaxf(m, score(dot<HD>(qr, k_s + j * HD), scale, b_s[c0 + j]));
  }
  float l = 0.f;
  for (int c0 = 0; c0 < T; c0 += kc) {
    stage_chunk<TIn, TIn, HD>(k + base, v + base, T, c0, kc, false, k_s, v_s);
    const int n = T - c0 < kc ? T - c0 : kc;
    for (int j = 0; j < n; ++j)
      l += expf(score(dot<HD>(qr, k_s + j * HD), scale, b_s[c0 + j]) - m);
  }
  float o[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.f;
  for (int c0 = 0; c0 < T; c0 += kc) {
    stage_chunk<TIn, TIn, HD>(k + base, v + base, T, c0, kc, false, k_s, v_s);
    const int n = T - c0 < kc ? T - c0 : kc;
    for (int j = 0; j < n; ++j) {
      const float e = expf(score(dot<HD>(qr, k_s + j * HD), scale, b_s[c0 + j]) - m);
      axpy<HD>(__fdiv_rn(e, l), v_s + j * HD, o);
    }
  }
  if (live) store_row<HD>(o, out + base + (size_t)i * HD);
}

// Backward, launch 1 (per query row): the row statistics and dq.
template <typename TIn, int HD>
__global__ void __launch_bounds__(TILE) attention_bwd_dq_kernel(
    int R, int T, float scale, const TIn* __restrict__ q, const TIn* __restrict__ k,
    const TIn* __restrict__ v, const float* __restrict__ bias, const float* __restrict__ dout,
    float* __restrict__ dq, float* __restrict__ stats) {
  extern __shared__ __align__(16) float smem[];
  const int kc = T < F32_KEYS ? T : F32_KEYS;
  float* k_s = smem;                   // [kc][HD]
  float* v_s = k_s + (size_t)kc * HD;  // [kc][HD]
  float* b_s = v_s + (size_t)kc * HD;  // [T]
  const size_t r = blockIdx.x;
  const size_t base = r * T * HD;
  for (int j = threadIdx.x; j < T; j += blockDim.x) b_s[j] = bias[r * T + j];
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = i < T;  // rows past T stay for the barriers
  const int li = live ? i : 0;

  float qr[HD], dor[HD];
  load_row<TIn, HD>(q + base + (size_t)li * HD, qr);
  load_row<float, HD>(dout + base + (size_t)li * HD, dor);
  float m = __int_as_float(0xff800000);  // -inf
  for (int c0 = 0; c0 < T; c0 += kc) {
    stage_chunk<TIn, TIn, HD>(k + base, v + base, T, c0, kc, c0 == 0, k_s, v_s);
    const int n = T - c0 < kc ? T - c0 : kc;
    for (int j = 0; j < n; ++j) m = fmaxf(m, score(dot<HD>(qr, k_s + j * HD), scale, b_s[c0 + j]));
  }
  float l = 0.f;
  for (int c0 = 0; c0 < T; c0 += kc) {
    stage_chunk<TIn, TIn, HD>(k + base, v + base, T, c0, kc, false, k_s, v_s);
    const int n = T - c0 < kc ? T - c0 : kc;
    for (int j = 0; j < n; ++j)
      l += expf(score(dot<HD>(qr, k_s + j * HD), scale, b_s[c0 + j]) - m);
  }
  float row = 0.f;  // rowsum(dp * p), p in f32
  for (int c0 = 0; c0 < T; c0 += kc) {
    stage_chunk<TIn, TIn, HD>(k + base, v + base, T, c0, kc, false, k_s, v_s);
    const int n = T - c0 < kc ? T - c0 : kc;
    for (int j = 0; j < n; ++j) {
      const float p =
          __fdiv_rn(expf(score(dot<HD>(qr, k_s + j * HD), scale, b_s[c0 + j]) - m), l);
      row += dot<HD>(dor, v_s + j * HD) * p;
    }
  }
  float g[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) g[d] = 0.f;
  for (int c0 = 0; c0 < T; c0 += kc) {
    stage_chunk<TIn, TIn, HD>(k + base, v + base, T, c0, kc, false, k_s, v_s);
    const int n = T - c0 < kc ? T - c0 : kc;
    for (int j = 0; j < n; ++j) {
      const float p =
          __fdiv_rn(expf(score(dot<HD>(qr, k_s + j * HD), scale, b_s[c0 + j]) - m), l);
      const float ds = dscore(p, dot<HD>(dor, v_s + j * HD), row, scale);
      axpy<HD>(ds, k_s + j * HD, g);
    }
  }
  if (!live) return;
  store_row<HD>(g, dq + base + (size_t)i * HD);
  const size_t at = r * T + i, plane = (size_t)R * T;
  stats[at] = m;
  stats[plane + at] = l;
  stats[2 * plane + at] = row;
}

// Backward, launch 2 (per key row): dk and dv, summed over the query rows in order.
template <typename TIn, int HD>
__global__ void __launch_bounds__(TILE) attention_bwd_dkv_kernel(
    int R, int T, float scale, const TIn* __restrict__ q, const TIn* __restrict__ k,
    const TIn* __restrict__ v, const float* __restrict__ bias, const float* __restrict__ dout,
    float* __restrict__ dk, float* __restrict__ dv, const float* __restrict__ stats) {
  extern __shared__ __align__(16) float smem[];
  const int kc = T < F32_KEYS ? T : F32_KEYS;  // query rows a chunk
  float* q_s = smem;                     // [kc][HD]
  float* do_s = q_s + (size_t)kc * HD;   // [kc][HD]
  float* m_s = do_s + (size_t)kc * HD;   // [T] row maxima
  float* l_s = m_s + T;                  // [T] row sums
  float* row_s = l_s + T;                // [T] rowsum(dp * p)
  const size_t r = blockIdx.x;
  const size_t base = r * T * HD;
  const size_t plane = (size_t)R * T;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    m_s[i] = stats[r * T + i];
    l_s[i] = stats[plane + r * T + i];
    row_s[i] = stats[2 * plane + r * T + i];
  }
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = j < T;  // rows past T stay for the barriers
  const int lj = live ? j : 0;

  float kr[HD], vr[HD];
  load_row<TIn, HD>(k + base + (size_t)lj * HD, kr);
  load_row<TIn, HD>(v + base + (size_t)lj * HD, vr);
  const float bj = bias[r * T + lj];
  float gk[HD], gv[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) gk[d] = gv[d] = 0.f;
  for (int c0 = 0; c0 < T; c0 += kc) {
    stage_chunk<TIn, float, HD>(q + base, dout + base, T, c0, kc, c0 == 0, q_s, do_s);
    const int n = T - c0 < kc ? T - c0 : kc;
    for (int ii = 0; ii < n; ++ii) {
      const int i = c0 + ii;
      const float p =
          __fdiv_rn(expf(score(dot<HD>(kr, q_s + ii * HD), scale, bj) - m_s[i]), l_s[i]);
      axpy<HD>(p, do_s + ii * HD, gv);
      const float ds = dscore(p, dot<HD>(vr, do_s + ii * HD), row_s[i], scale);
      axpy<HD>(ds, q_s + ii * HD, gk);
    }
  }
  if (!live) return;
  store_row<HD>(gk, dk + base + (size_t)j * HD);
  store_row<HD>(gv, dv + base + (size_t)j * HD);
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
  extern __shared__ __align__(16) unsigned char tsm[];  // (`smem` is the f32 kernels' float[])
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
  extern __shared__ __align__(16) unsigned char tsm[];  // (`smem` is the f32 kernels' float[])
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
  extern __shared__ __align__(16) unsigned char tsm[];  // (`smem` is the f32 kernels' float[])
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

struct Args {
  int R, T;
  float scale;
  const void *q, *k, *v;
  const float *bias, *dout;
  float *out, *dq, *dk, *dv, *stats;
  cudaStream_t stream;
  int rows, kv_shared, ks, kt;  // bf16 compute: the query tile, V over K, key halves, key tile
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

// one thread per row of a tile: a warp multiple, at most TILE
int threads_for(int T) {
  const int t = (T + 31) / 32 * 32;
  return t < TILE ? t : TILE;
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
    auto kernel = attention_fwd_kernel<TIn, HD>;
    const size_t smem = f32_smem(a.T, HD, 1);
    if (const int e = allow_smem(kernel, smem)) return e;
    const int threads = threads_for(a.T);
    const dim3 grid(a.R, (a.T + threads - 1) / threads);
    kernel<<<grid, threads, smem, a.stream>>>(a.T, a.scale, static_cast<const TIn*>(a.q),
                                              static_cast<const TIn*>(a.k),
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
    auto dq_kernel = attention_bwd_dq_kernel<TIn, HD>;
    auto dkv_kernel = attention_bwd_dkv_kernel<TIn, HD>;
    const size_t dq_smem = f32_smem(a.T, HD, 1);
    const size_t dkv_smem = f32_smem(a.T, HD, 3);
    if (const int e = allow_smem(dq_kernel, dq_smem)) return e;
    if (const int e = allow_smem(dkv_kernel, dkv_smem)) return e;
    const int threads = threads_for(a.T);
    const dim3 grid(a.R, (a.T + threads - 1) / threads);
    dq_kernel<<<grid, threads, dq_smem, a.stream>>>(a.R, a.T, a.scale, q, k, v, a.bias, a.dout,
                                                    a.dq, a.stats);
    if (const cudaError_t e = cudaGetLastError()) return (int)e;
    dkv_kernel<<<grid, threads, dkv_smem, a.stream>>>(a.R, a.T, a.scale, q, k, v, a.bias, a.dout,
                                                      a.dk, a.dv, a.stats);
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
// bf16. hd in {8, 16, 32, 64}, 1 <= T <= 512. bf16 compute: rows query rows
// a block (16 to 128, a multiple of 16), kv_shared (V staged over K) and ks
// (1, or 2: each tile's keys split over two warps), from ops/attention.py
// attention_plan; f32 compute ignores them (f32_smem gives its shared
// memory). A layout beyond the SM's shared memory is refused. device: the CUDA ordinal the
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
// two launches. bf16 compute: rows query rows a block of the first launch
// (kv_shared: V staged over K, then K over V again; ks as the forward's),
// kt keys (and query rows a staged tile) a block of the second.
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
