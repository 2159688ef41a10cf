// Masked recurrent time loop (GRU / LSTM / RNN), forward, for all
// directions of one layer in one launch.
//
// Replaces: twotowermlretrieval_tpu/ops/rnn_scan.py _fwd_kernel (called
// through rnn_layer_fwd). Same contract: per-direction input projections
// xp [T, B, G*H] in original time order (already in the compute dtype),
// a [T, B] f32 mask, W_hh [D, H, G*H] in the compute dtype, b_hh [D, G*H]
// f32. Per step and direction: hp = round_cdt(h) . W_hh + b_hh (f32
// accumulation), gates in torch order (GRU r,z,n; LSTM i,f,g,o; RNN tanh),
// then the masked update h = m*h_new + (1-m)*h. Direction 1 walks time
// T-1-i, so nobody makes flipped copies. Outputs: the state history per
// direction [T, B, H] (f32, or the compute dtype), the LSTM cell history,
// and h_final [D, B, H] f32.
//
// What bounds it on Hopper: the recurrence is a chain of T dependent
// [BB, H] x [H, G*H] products, so the kernel is latency-bound, far from
// both the bytes and the operations roofline. The TPU kernel keeps W_hh
// resident in VMEM; at the main-path shape W_hh is 256 x 768 bf16 =
// 384 KiB per direction, more than one block's 227 KB of shared memory.
//
// Design (the simple, correct first version): one block per (direction,
// block of BB = 16 batch rows) loops over T inside the kernel. The state
// h stays in shared memory as f32, with a transposed copy rounded to the
// compute dtype for the product (the rounding the TPU kernel's _mm does).
// W_hh is re-read from L2 every step (768 KiB for both directions; L2
// holds 50 MB). Each thread owns one hidden column j and keeps the G*BB
// gate sums of that column in registers, so the gate math needs no
// exchange between threads; products are f32 FMAs (a bf16 x bf16 product
// is exact in f32). At the serving shape (B=16) only D=2 blocks are busy:
// splitting W_hh over a thread-block cluster (distributed shared memory)
// and tensor-core products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BB = 16;        // batch rows per block
constexpr int THREADS = 256;  // hidden columns handled concurrently

enum Cell { kRNN = 0, kGRU = 1, kLSTM = 2 };

template <int CELL> struct NumGates;
template <> struct NumGates<kRNN> { static constexpr int G = 1; };
template <> struct NumGates<kGRU> { static constexpr int G = 3; };
template <> struct NumGates<kLSTM> { static constexpr int G = 4; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// CT: compute dtype of xp and W_hh; OT: dtype of the state history.
template <int CELL, typename CT, typename OT>
__global__ void __launch_bounds__(THREADS) rnn_fwd_kernel(
    int T, int B, int H,
    const CT* __restrict__ xp0, const CT* __restrict__ xp1,
    const float* __restrict__ mask,
    const CT* __restrict__ w_hh, const float* __restrict__ b_hh,
    OT* __restrict__ out0, OT* __restrict__ out1,
    OT* __restrict__ cout0, OT* __restrict__ cout1,
    float* __restrict__ h_final) {
  constexpr int G = NumGates<CELL>::G;
  const int d = blockIdx.y;
  const int row0 = blockIdx.x * BB;
  const int GH = G * H;
  const CT* xp = d == 0 ? xp0 : xp1;
  OT* out = d == 0 ? out0 : out1;
  OT* cout = d == 0 ? cout0 : cout1;
  const CT* w = w_hh + (size_t)d * H * GH;
  const float* bias = b_hh + (size_t)d * GH;

  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;               // [BB][H] carried state, f32
  float* hT_s = smem + BB * H;     // [H][BB] state rounded to CT, transposed
  float* c_s = smem + 2 * BB * H;  // [BB][H] LSTM cell state, f32

  for (int i = threadIdx.x; i < BB * H; i += blockDim.x) {
    h_s[i] = 0.0f;
    hT_s[i] = 0.0f;
    if constexpr (CELL == kLSTM) c_s[i] = 0.0f;
  }
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int t = d == 0 ? step : T - 1 - step;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float acc[G][BB];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int r = 0; r < BB; ++r) acc[g][r] = 0.0f;

#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        float wv[G];
#pragma unroll
        for (int g = 0; g < G; ++g) wv[g] = to_f(w[(size_t)k * GH + g * H + j]);
        const float4* hv = reinterpret_cast<const float4*>(hT_s + k * BB);
        float hk[BB];
#pragma unroll
        for (int q = 0; q < BB / 4; ++q) {
          const float4 v = hv[q];
          hk[4 * q + 0] = v.x;
          hk[4 * q + 1] = v.y;
          hk[4 * q + 2] = v.z;
          hk[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int r = 0; r < BB; ++r) acc[g][r] = fmaf(hk[r], wv[g], acc[g][r]);
      }

#pragma unroll
      for (int r = 0; r < BB; ++r) {
        const int row = row0 + r;
        if (row < B) {
          const size_t tb = (size_t)t * B + row;
          const float m = mask[tb];
          const CT* x = xp + tb * GH;
          const float h_prev = h_s[r * H + j];
          float h_new;
          if constexpr (CELL == kGRU) {
            const float rg = sigmoid(to_f(x[j]) + (acc[0][r] + bias[j]));
            const float zg = sigmoid(to_f(x[H + j]) + (acc[1][r] + bias[H + j]));
            const float ng = tanhf(to_f(x[2 * H + j]) + rg * (acc[2][r] + bias[2 * H + j]));
            h_new = (1.0f - zg) * ng + zg * h_prev;
          } else if constexpr (CELL == kLSTM) {
            const float ig = sigmoid(to_f(x[j]) + (acc[0][r] + bias[j]));
            const float fg = sigmoid(to_f(x[H + j]) + (acc[1][r] + bias[H + j]));
            const float gg = tanhf(to_f(x[2 * H + j]) + (acc[2][r] + bias[2 * H + j]));
            const float og = sigmoid(to_f(x[3 * H + j]) + (acc[3][r] + bias[3 * H + j]));
            const float c_prev = c_s[r * H + j];
            const float c_new = fg * c_prev + ig * gg;
            h_new = og * tanhf(c_new);
            const float c = m * c_new + (1.0f - m) * c_prev;
            c_s[r * H + j] = c;
            cout[tb * H + j] = from_f<OT>(c);
          } else {
            h_new = tanhf(to_f(x[j]) + (acc[0][r] + bias[j]));
          }
          const float h = m * h_new + (1.0f - m) * h_prev;
          h_s[r * H + j] = h;  // column j is read and written by this thread only
          out[tb * H + j] = from_f<OT>(h);
        }
      }
    }
    __syncthreads();  // every thread is done reading hT_s for this step
    for (int j = threadIdx.x; j < H; j += blockDim.x)
#pragma unroll
      for (int r = 0; r < BB; ++r) hT_s[j * BB + r] = to_f(from_f<CT>(h_s[r * H + j]));
    __syncthreads();
  }

  for (int j = threadIdx.x; j < H; j += blockDim.x)
    for (int r = 0; r < BB; ++r)
      if (row0 + r < B) h_final[((size_t)d * B + row0 + r) * H + j] = h_s[r * H + j];
}

template <int CELL, typename CT, typename OT>
int launch(int T, int B, int H, int D, const void* xp0, const void* xp1, const float* mask,
           const void* w_hh, const float* b_hh, void* out0, void* out1, void* c0, void* c1,
           float* h_final, cudaStream_t stream) {
  auto kernel = rnn_fwd_kernel<CELL, CT, OT>;
  const size_t smem = (size_t)(CELL == kLSTM ? 3 : 2) * BB * H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((H + 31) / 32) * 32;
  if (threads > THREADS) threads = THREADS;
  const dim3 grid((B + BB - 1) / BB, D);
  kernel<<<grid, threads, smem, stream>>>(
      T, B, H, static_cast<const CT*>(xp0), static_cast<const CT*>(xp1), mask,
      static_cast<const CT*>(w_hh), b_hh, static_cast<OT*>(out0), static_cast<OT*>(out1),
      static_cast<OT*>(c0), static_cast<OT*>(c1), h_final);
  return (int)cudaGetLastError();
}

template <int CELL>
int dispatch_types(int cdt_bf16, int hist_bf16, int T, int B, int H, int D, const void* xp0,
                   const void* xp1, const float* mask, const void* w_hh, const float* b_hh,
                   void* out0, void* out1, void* c0, void* c1, float* h_final,
                   cudaStream_t stream) {
  if (!cdt_bf16)
    return launch<CELL, float, float>(T, B, H, D, xp0, xp1, mask, w_hh, b_hh, out0, out1, c0,
                                      c1, h_final, stream);
  if (hist_bf16)
    return launch<CELL, __nv_bfloat16, __nv_bfloat16>(T, B, H, D, xp0, xp1, mask, w_hh, b_hh,
                                                      out0, out1, c0, c1, h_final, stream);
  return launch<CELL, __nv_bfloat16, float>(T, B, H, D, xp0, xp1, mask, w_hh, b_hh, out0, out1,
                                            c0, c1, h_final, stream);
}

}  // namespace

extern "C" {

// cell: 0 RNN, 1 GRU, 2 LSTM. cdt_bf16: xp and W_hh are bf16 (else f32).
// hist_bf16: the state history is stored in bf16 (only with cdt_bf16).
// device: the CUDA ordinal the tensors live on (this library carries its
// own runtime, whose current device is not PyTorch's).
// Returns cudaGetLastError() after the launch (0 on success).
int rnn_fwd_launch(int device, int cell, int cdt_bf16, int hist_bf16, int T, int B, int H,
                   int D, const void* xp0, const void* xp1, const float* mask,
                   const void* w_hh, const float* b_hh, void* out0, void* out1, void* c0,
                   void* c1, float* h_final, void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (H % 4 != 0 || D < 1 || D > 2 || cell < 0 || cell > 2)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cell == kGRU)
    return dispatch_types<kGRU>(cdt_bf16, hist_bf16, T, B, H, D, xp0, xp1, mask, w_hh, b_hh,
                                out0, out1, c0, c1, h_final, s);
  if (cell == kLSTM)
    return dispatch_types<kLSTM>(cdt_bf16, hist_bf16, T, B, H, D, xp0, xp1, mask, w_hh, b_hh,
                                 out0, out1, c0, c1, h_final, s);
  return dispatch_types<kRNN>(cdt_bf16, hist_bf16, T, B, H, D, xp0, xp1, mask, w_hh, b_hh,
                              out0, out1, c0, c1, h_final, s);
}

const char* rnn_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
