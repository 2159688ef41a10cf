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
// roundings, never contracted into one FMA), and p = exp(s - max) / sum.
//
// What bounds it on Hopper: bytes. At R = 4096, T = 128, hd = 32 with f32
// inputs the forward must move 270.5 MB (0.081 ms at 3.35 TB/s) for 8.6
// GFLOP (0.009 ms at the bf16 tensor-core rate), the backward 471.9 MB
// (0.141 ms) for 21.5 GFLOP. Anything T x T-shaped in device memory would
// multiply the bytes by about T / hd, so no score or probability leaves the
// SM.
//
// Design (the simple, correct first version): one block per (row r, tile of
// up to 128 query rows). The block stages row r's keys and values for the
// whole T in shared memory (f32, already rounded to the compute dtype); each
// thread owns one query row, its q (and output) in registers, and
// recomputes its scores from shared memory (the threads of a warp read the
// same key row: a broadcast). Pass 1 takes the row maximum, pass 2 the row
// sum, pass 3 the output with p rounded to the compute dtype. The backward
// is two launches. The first (per query row) recomputes the row statistics
// (maximum, sum, rowsum(dp * p)) and dq, and stores the statistics as
// [3, R, T] floats. The second (per key row, with the row's queries and
// output cotangents in shared memory) recomputes each p_ij bit for bit (the
// same products in the same order, the stored statistics) and sums dk and
// dv over the query rows in order. No atomics: the results are
// deterministic, which a resumed training run relies on. The products are
// FMAs on the CUDA cores, about 2x (forward) and 2.2x (backward) the
// minimal multiply-adds because of the recomputation, so the kernels are
// bound by FMA throughput, not by the bytes; tensor-core tiles (mma.sync /
// wgmma), TMA and one pass with an online softmax are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;  // query (or key) rows per block, one per thread
constexpr int MAX_T = 512;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to the compute dtype (to nearest even, as torch's cast)
template <bool CBF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (CBF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// n elements of src into dst as f32, rounded to the compute dtype
template <typename TIn, bool CBF16>
__device__ __forceinline__ void stage(const TIn* __restrict__ src, int n, float* dst) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = rnd<CBF16>(to_f32(src[e]));
}

template <typename TIn, bool CBF16, int HD>
__device__ __forceinline__ void load_row(const TIn* __restrict__ src, float (&dst)[HD]) {
#pragma unroll
  for (int d = 0; d < HD; ++d) dst[d] = rnd<CBF16>(to_f32(src[d]));
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

// the score of one (query, key) pair: (dot * scale) + bias, each rounded
__device__ __forceinline__ float score(float dot, float scale, float bias) {
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

// p * (dp - row) * scale, each step rounded as the TPU kernel's
__device__ __forceinline__ float dscore(float p, float dp, float row, float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, row)), scale);
}

template <int HD>
__device__ __forceinline__ void store_row(const float (&src)[HD], float* __restrict__ dst) {
#pragma unroll
  for (int d = 0; d < HD; ++d) dst[d] = src[d];
}

template <typename TIn, bool CBF16, int HD>
__global__ void __launch_bounds__(TILE) attention_fwd_kernel(
    int T, float scale, const TIn* __restrict__ q, const TIn* __restrict__ k,
    const TIn* __restrict__ v, const float* __restrict__ bias, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                  // [T][HD]
  float* v_s = k_s + (size_t)T * HD;  // [T][HD]
  float* b_s = v_s + (size_t)T * HD;  // [T]
  const size_t r = blockIdx.x;
  const size_t base = r * T * HD;
  stage<TIn, CBF16>(k + base, T * HD, k_s);
  stage<TIn, CBF16>(v + base, T * HD, v_s);
  for (int j = threadIdx.x; j < T; j += blockDim.x) b_s[j] = bias[r * T + j];
  __syncthreads();
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  if (i >= T) return;

  float qr[HD];
  load_row<TIn, CBF16, HD>(q + base + (size_t)i * HD, qr);
  float m = __int_as_float(0xff800000);  // -inf
  for (int j = 0; j < T; ++j) m = fmaxf(m, score(dot<HD>(qr, k_s + j * HD), scale, b_s[j]));
  float l = 0.f;
  for (int j = 0; j < T; ++j) l += expf(score(dot<HD>(qr, k_s + j * HD), scale, b_s[j]) - m);
  float o[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.f;
  for (int j = 0; j < T; ++j) {
    const float e = expf(score(dot<HD>(qr, k_s + j * HD), scale, b_s[j]) - m);
    axpy<HD>(rnd<CBF16>(__fdiv_rn(e, l)), v_s + j * HD, o);
  }
  store_row<HD>(o, out + base + (size_t)i * HD);
}

// Backward, launch 1 (per query row): the row statistics and dq.
template <typename TIn, bool CBF16, int HD>
__global__ void __launch_bounds__(TILE) attention_bwd_dq_kernel(
    int R, int T, float scale, const TIn* __restrict__ q, const TIn* __restrict__ k,
    const TIn* __restrict__ v, const float* __restrict__ bias, const float* __restrict__ dout,
    float* __restrict__ dq, float* __restrict__ stats) {
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                  // [T][HD]
  float* v_s = k_s + (size_t)T * HD;  // [T][HD]
  float* b_s = v_s + (size_t)T * HD;  // [T]
  const size_t r = blockIdx.x;
  const size_t base = r * T * HD;
  stage<TIn, CBF16>(k + base, T * HD, k_s);
  stage<TIn, CBF16>(v + base, T * HD, v_s);
  for (int j = threadIdx.x; j < T; j += blockDim.x) b_s[j] = bias[r * T + j];
  __syncthreads();
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  if (i >= T) return;

  float qr[HD], dor[HD];
  load_row<TIn, CBF16, HD>(q + base + (size_t)i * HD, qr);
  load_row<float, CBF16, HD>(dout + base + (size_t)i * HD, dor);
  float m = __int_as_float(0xff800000);  // -inf
  for (int j = 0; j < T; ++j) m = fmaxf(m, score(dot<HD>(qr, k_s + j * HD), scale, b_s[j]));
  float l = 0.f;
  for (int j = 0; j < T; ++j) l += expf(score(dot<HD>(qr, k_s + j * HD), scale, b_s[j]) - m);
  float row = 0.f;  // rowsum(dp * p), p in f32
  for (int j = 0; j < T; ++j) {
    const float p = __fdiv_rn(expf(score(dot<HD>(qr, k_s + j * HD), scale, b_s[j]) - m), l);
    row += dot<HD>(dor, v_s + j * HD) * p;
  }
  float g[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) g[d] = 0.f;
  for (int j = 0; j < T; ++j) {
    const float p = __fdiv_rn(expf(score(dot<HD>(qr, k_s + j * HD), scale, b_s[j]) - m), l);
    const float ds = dscore(p, dot<HD>(dor, v_s + j * HD), row, scale);
    axpy<HD>(rnd<CBF16>(ds), k_s + j * HD, g);
  }
  store_row<HD>(g, dq + base + (size_t)i * HD);
  const size_t at = r * T + i, plane = (size_t)R * T;
  stats[at] = m;
  stats[plane + at] = l;
  stats[2 * plane + at] = row;
}

// Backward, launch 2 (per key row): dk and dv, summed over the query rows in order.
template <typename TIn, bool CBF16, int HD>
__global__ void __launch_bounds__(TILE) attention_bwd_dkv_kernel(
    int R, int T, float scale, const TIn* __restrict__ q, const TIn* __restrict__ k,
    const TIn* __restrict__ v, const float* __restrict__ bias, const float* __restrict__ dout,
    float* __restrict__ dk, float* __restrict__ dv, const float* __restrict__ stats) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // [T][HD]
  float* do_s = q_s + (size_t)T * HD;   // [T][HD]
  float* m_s = do_s + (size_t)T * HD;   // [T] row maxima
  float* l_s = m_s + T;                 // [T] row sums
  float* row_s = l_s + T;               // [T] rowsum(dp * p)
  const size_t r = blockIdx.x;
  const size_t base = r * T * HD;
  const size_t plane = (size_t)R * T;
  stage<TIn, CBF16>(q + base, T * HD, q_s);
  stage<float, CBF16>(dout + base, T * HD, do_s);
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    m_s[i] = stats[r * T + i];
    l_s[i] = stats[plane + r * T + i];
    row_s[i] = stats[2 * plane + r * T + i];
  }
  __syncthreads();
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= T) return;

  float kr[HD], vr[HD];
  load_row<TIn, CBF16, HD>(k + base + (size_t)j * HD, kr);
  load_row<TIn, CBF16, HD>(v + base + (size_t)j * HD, vr);
  const float bj = bias[r * T + j];
  float gk[HD], gv[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) gk[d] = gv[d] = 0.f;
  for (int i = 0; i < T; ++i) {
    const float p = __fdiv_rn(expf(score(dot<HD>(kr, q_s + i * HD), scale, bj) - m_s[i]), l_s[i]);
    axpy<HD>(rnd<CBF16>(p), do_s + i * HD, gv);
    const float ds = dscore(p, dot<HD>(vr, do_s + i * HD), row_s[i], scale);
    axpy<HD>(rnd<CBF16>(ds), q_s + i * HD, gk);
  }
  store_row<HD>(gk, dk + base + (size_t)j * HD);
  store_row<HD>(gv, dv + base + (size_t)j * HD);
}

struct Args {
  int R, T;
  float scale;
  const void *q, *k, *v;
  const float *bias, *dout;
  float *out, *dq, *dk, *dv, *stats;
  cudaStream_t stream;
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

template <typename TIn, bool CBF16, int HD>
int fwd(const Args& a) {
  auto kernel = attention_fwd_kernel<TIn, CBF16, HD>;
  const size_t smem = (2 * (size_t)a.T * HD + a.T) * sizeof(float);
  if (const int e = allow_smem(kernel, smem)) return e;
  const int threads = threads_for(a.T);
  const dim3 grid(a.R, (a.T + threads - 1) / threads);
  kernel<<<grid, threads, smem, a.stream>>>(a.T, a.scale, static_cast<const TIn*>(a.q),
                                            static_cast<const TIn*>(a.k),
                                            static_cast<const TIn*>(a.v), a.bias, a.out);
  return (int)cudaGetLastError();
}

template <typename TIn, bool CBF16, int HD>
int bwd(const Args& a) {
  auto dq_kernel = attention_bwd_dq_kernel<TIn, CBF16, HD>;
  auto dkv_kernel = attention_bwd_dkv_kernel<TIn, CBF16, HD>;
  const size_t dq_smem = (2 * (size_t)a.T * HD + a.T) * sizeof(float);
  const size_t dkv_smem = (2 * (size_t)a.T * HD + 3 * (size_t)a.T) * sizeof(float);
  if (const int e = allow_smem(dq_kernel, dq_smem)) return e;
  if (const int e = allow_smem(dkv_kernel, dkv_smem)) return e;
  const int threads = threads_for(a.T);
  const dim3 grid(a.R, (a.T + threads - 1) / threads);
  const TIn* q = static_cast<const TIn*>(a.q);
  const TIn* k = static_cast<const TIn*>(a.k);
  const TIn* v = static_cast<const TIn*>(a.v);
  dq_kernel<<<grid, threads, dq_smem, a.stream>>>(a.R, a.T, a.scale, q, k, v, a.bias, a.dout,
                                                  a.dq, a.stats);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  dkv_kernel<<<grid, threads, dkv_smem, a.stream>>>(a.R, a.T, a.scale, q, k, v, a.bias, a.dout,
                                                    a.dk, a.dv, a.stats);
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

// q, k, v [R, T, hd] in bf16 (in_bf16) or f32; bias [R, T] f32; out [R, T,
// hd] f32; cdt_bf16 rounds every product's operands to bf16. hd in {8, 16,
// 32, 64}, 1 <= T <= 512, and 2 * T * hd + T floats of shared memory must
// fit the SM (hd = 64: T <= 440). device: the CUDA ordinal the tensors live
// on (this library carries its own runtime, whose current device is not
// PyTorch's). Returns cudaGetLastError() after the launch (0 on success).
int attention_fwd_launch(int device, int in_bf16, int cdt_bf16, int R, int T, int hd, float scale,
                         const void* q, const void* k, const void* v, const void* bias,
                         void* out, void* stream) {
  Args a{R, T, scale, q, k, v, static_cast<const float*>(bias), nullptr,
         static_cast<float*>(out), nullptr, nullptr, nullptr, nullptr,
         static_cast<cudaStream_t>(stream)};
  return dispatch<Fwd>(device, in_bf16, cdt_bf16, hd, a);
}

// As the forward, plus the output cotangent dout [R, T, hd] f32; writes dq,
// dk, dv [R, T, hd] f32 and uses stats [3, R, T] f32 as scratch between its
// two launches.
int attention_bwd_launch(int device, int in_bf16, int cdt_bf16, int R, int T, int hd, float scale,
                         const void* q, const void* k, const void* v, const void* bias,
                         const void* dout, void* dq, void* dk, void* dv, void* stats,
                         void* stream) {
  Args a{R, T, scale, q, k, v, static_cast<const float*>(bias), static_cast<const float*>(dout),
         nullptr, static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
         static_cast<float*>(stats), static_cast<cudaStream_t>(stream)};
  return dispatch<Bwd>(device, in_bf16, cdt_bf16, hd, a);
}

const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
