// Masked recurrent time loop (GRU / LSTM / RNN), backward, for all
// directions of one layer in one launch.
//
// Replaces: twotowermlretrieval_tpu/ops/rnn_scan.py _bwd_kernel, both of
// its modes: split=False (called through rnn_layer_bwd: dW_hh and db_hh
// accumulated inside the kernel) and split=True (rnn_layer_bwd_split and
// _bwd_hoisted_call: the kernel emits dxp and, for GRU, dhp, and the
// weight gradient is one product outside).
//
// Contract (as the TPU kernel's): per direction, xp [T, B, G*H] in the
// compute dtype (CT), the saved state history outs [T, B, H] (HT: f32, or
// the compute dtype), the LSTM cell history, the cotangents douts
// [T, B, H] (HT), and a [T, B] f32 mask; W_hh [D, H, G*H] and its
// transposed copy [D, G*H, H] in CT, b_hh [D, G*H] f32, d_hfinal
// [D, B, H] f32. Direction d walks its own processing order backwards:
// absolute direction 0 visits t = T-1..0, direction 1 t = 0..T-1, and
// h_prev is the saved state at the neighbouring position (t-1, or t+1 for
// direction 1), zero at each direction's first position. Per step:
//   dh_t = dh + dout[t]; dh_new = m*dh_t; dh_direct = (1-m)*dh_t
//   hp = round_ct(h_prev) . round_ct(W) + b          (gate recompute)
//   gate cotangents dxp and dhp (they differ in GRU's candidate third)
//   dh = round_ct(dhp) . round_ct(W)^T + (GRU: dh_new*z) + dh_direct
//   dW += round_ct(h_prev)^T . round_ct(dhp), db += sum_rows dhp
// dxp (and, split, dhp) are written in CT. The rounding points are the
// TPU kernel's (_mm, _outer_acc and the cdt outputs).
//
// What bounds it on Hopper: like the forward, a chain of T dependent
// steps, each three [BB, H] x [H, G*H]-sized products per block (two for
// RNN, one fewer in split mode); latency- and FMA-bound, far from the
// bytes and tensor-core bounds.
//
// Design (the simple, correct first version; the forward kernel's
// layout): one block per (direction, BB = 16 batch rows) walks all of T.
// The dh (and dc) carry stays in shared memory as f32. W_hh and W_hh^T are
// read from L2 at every step, each with consecutive threads on
// consecutive columns. Thread j owns hidden column j for the gate math;
// the rounded dhp goes to shared memory for the chain product. The TPU
// grid runs its B blocks one after another into one VMEM accumulator;
// here blocks run concurrently and one [H, G*H] f32 partial (768 KiB at
// H=256) exceeds a block's shared memory, so every block accumulates its
// own partial dW in a global f32 workspace (each element owned by one
// thread: no atomics), and a second launch from this file sums the
// partials over the blocks in a fixed order. The result is the same run
// to run, which resume relies on.

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

// f32 value rounded to the compute dtype and back (exact upcast)
template <typename CT> __device__ __forceinline__ float round_ct(float x) {
  return to_f(from_f<CT>(x));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

struct Ptrs {
  const void* xp[2];
  const void* out[2];
  const void* c[2];
  const void* dout[2];
  void* dxp[2];
  void* dhp[2];
};

// CT: compute dtype of xp, W_hh, dxp, dhp; HT: dtype of the saved history
// and of the cotangents. dir0: the absolute direction of entry 0 (a
// one-direction call may run the backward tower direction alone).
template <int CELL, typename CT, typename HT>
__global__ void __launch_bounds__(THREADS) rnn_bwd_kernel(
    int T, int B, int H, int dir0, int split, Ptrs p, const float* __restrict__ mask,
    const CT* __restrict__ w_hh, const CT* __restrict__ w_hhT, const float* __restrict__ b_hh,
    const float* __restrict__ d_hfinal, float* __restrict__ ws_w, float* __restrict__ ws_b) {
  constexpr int G = NumGates<CELL>::G;
  const int e = blockIdx.y;  // entry of the per-direction arrays
  const int dabs = dir0 + e;
  const int rb = blockIdx.x;
  const int nrb = gridDim.x;
  const int row0 = rb * BB;
  const int GH = G * H;
  const CT* xp = static_cast<const CT*>(p.xp[e]);
  const HT* out = static_cast<const HT*>(p.out[e]);
  const HT* chist = static_cast<const HT*>(p.c[e]);
  const HT* dout = static_cast<const HT*>(p.dout[e]);
  CT* dxp = static_cast<CT*>(p.dxp[e]);
  CT* dhp_out = static_cast<CT*>(p.dhp[e]);
  const CT* w = w_hh + (size_t)e * H * GH;
  const CT* wT = w_hhT + (size_t)e * GH * H;
  const float* bias = b_hh + (size_t)e * GH;
  // this block's partials: [H][GH] and [GH]
  float* pw = split ? nullptr : ws_w + ((size_t)e * nrb + rb) * H * GH;
  float* pb = split ? nullptr : ws_b + ((size_t)e * nrb + rb) * GH;

  extern __shared__ __align__(16) float smem[];
  float* dh_s = smem;                   // [BB][H] dh carry, f32
  float* hT_s = dh_s + BB * H;          // [H][BB] h_prev rounded to CT, transposed
  float* dhp_s = hT_s + BB * H;         // [GH][BB] dhp rounded to CT, transposed
  float* db_s = dhp_s + (size_t)GH * BB;  // [GH] this block's db partial
  float* dc_s = db_s + GH;              // [BB][H] LSTM dc carry, f32

  for (int i = threadIdx.x; i < BB * H; i += blockDim.x) {
    const int r = i / H, j = i % H;
    const int row = row0 + r;
    dh_s[i] = row < B ? d_hfinal[((size_t)e * B + row) * H + j] : 0.0f;
    if constexpr (CELL == kLSTM) dc_s[i] = 0.0f;
  }
  for (int k = threadIdx.x; k < GH; k += blockDim.x) db_s[k] = 0.0f;
  if (!split)  // zero the partial dW: the same thread updates each element later
    for (int k = threadIdx.x; k < GH; k += blockDim.x)
      for (int i = 0; i < H; ++i) pw[(size_t)i * GH + k] = 0.0f;

  for (int step = 0; step < T; ++step) {
    const int t = dabs == 0 ? T - 1 - step : step;
    const bool first = step == T - 1;  // the direction's first position
    const int tprev = dabs == 0 ? t - 1 : t + 1;

    // h_prev (rounded to CT) for the gate recompute and the dW product
    for (int i = threadIdx.x; i < BB * H; i += blockDim.x) {
      const int r = i / H, j = i % H;  // consecutive threads read consecutive j
      const int row = row0 + r;
      float h = 0.0f;
      if (!first && row < B) h = to_f(out[((size_t)tprev * B + row) * H + j]);
      hT_s[j * BB + r] = round_ct<CT>(h);
    }
    __syncthreads();

    // gate recompute and the gate cotangents; thread j owns column j
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float acc[G][BB];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int r = 0; r < BB; ++r) acc[g][r] = 0.0f;
      if constexpr (CELL != kRNN) {  // RNN reads the saved output instead
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
      }

      float dbsum[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dbsum[g] = 0.0f;
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        const int row = row0 + r;
        float dhp[G];
#pragma unroll
        for (int g = 0; g < G; ++g) dhp[g] = 0.0f;
        if (row < B) {
          const size_t tb = (size_t)t * B + row;
          const float m = mask[tb];
          const float dh_t = dh_s[r * H + j] + to_f(dout[tb * H + j]);
          const float dh_new = dh_t * m;
          const float dh_direct = dh_t * (1.0f - m);
          const CT* x = xp + tb * GH;
          CT* dx = dxp + tb * GH;
          float h_prev = 0.0f;
          if (!first) h_prev = to_f(out[((size_t)tprev * B + row) * H + j]);
          float dxv[G];
          if constexpr (CELL == kGRU) {
            const float h_r = acc[0][r] + bias[j];
            const float h_z = acc[1][r] + bias[H + j];
            const float h_n = acc[2][r] + bias[2 * H + j];
            const float rg = sigmoid(to_f(x[j]) + h_r);
            const float zg = sigmoid(to_f(x[H + j]) + h_z);
            const float ng = tanhf(to_f(x[2 * H + j]) + rg * h_n);
            const float dz = dh_new * (h_prev - ng);
            const float dn_pre = dh_new * (1.0f - zg) * (1.0f - ng * ng);
            const float dr_pre = dn_pre * h_n * rg * (1.0f - rg);
            const float dz_pre = dz * zg * (1.0f - zg);
            dxv[0] = dr_pre;
            dxv[1] = dz_pre;
            dxv[2] = dn_pre;
            dhp[0] = dr_pre;
            dhp[1] = dz_pre;
            dhp[2] = dn_pre * rg;
            dh_s[r * H + j] = dh_new * zg + dh_direct;
          } else if constexpr (CELL == kLSTM) {
            float c_prev = 0.0f;
            if (!first) c_prev = to_f(chist[((size_t)tprev * B + row) * H + j]);
            const float dc_t = dc_s[r * H + j];
            float dc_new = dc_t * m;
            const float dc_direct = dc_t * (1.0f - m);
            const float ig = sigmoid(to_f(x[j]) + (acc[0][r] + bias[j]));
            const float fg = sigmoid(to_f(x[H + j]) + (acc[1][r] + bias[H + j]));
            const float gg = tanhf(to_f(x[2 * H + j]) + (acc[2][r] + bias[2 * H + j]));
            const float og = sigmoid(to_f(x[3 * H + j]) + (acc[3][r] + bias[3 * H + j]));
            const float c_new = fg * c_prev + ig * gg;
            const float tanh_c = tanhf(c_new);
            const float d_o = dh_new * tanh_c;
            dc_new = dc_new + dh_new * og * (1.0f - tanh_c * tanh_c);
            dxv[0] = dc_new * gg * ig * (1.0f - ig);
            dxv[1] = dc_new * c_prev * fg * (1.0f - fg);
            dxv[2] = dc_new * ig * (1.0f - gg * gg);
            dxv[3] = d_o * og * (1.0f - og);
#pragma unroll
            for (int g = 0; g < G; ++g) dhp[g] = dxv[g];
            dc_s[r * H + j] = dc_new * fg + dc_direct;
            dh_s[r * H + j] = dh_direct;
          } else {
            // h_new equals the saved output wherever m == 1, and dh_new
            // is 0 wherever m == 0
            const float h_t = to_f(out[tb * H + j]);
            dxv[0] = dh_new * (1.0f - h_t * h_t);
            dhp[0] = dxv[0];
            dh_s[r * H + j] = dh_direct;
          }
#pragma unroll
          for (int g = 0; g < G; ++g) {
            dx[g * H + j] = from_f<CT>(dxv[g]);
            if (CELL == kGRU && split) dhp_out[tb * GH + g * H + j] = from_f<CT>(dhp[g]);
            dbsum[g] += dhp[g];
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) dhp_s[(g * H + j) * BB + r] = round_ct<CT>(dhp[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) db_s[g * H + j] += dbsum[g];
    }
    __syncthreads();

    // dh chain: dh[r][j] += sum_k dhp[r][k] * W[j][k], read through W^T
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float acc[BB];
#pragma unroll
      for (int r = 0; r < BB; ++r) acc[r] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < GH; ++k) {
        const float wv = to_f(wT[(size_t)k * H + j]);
        const float4* dv = reinterpret_cast<const float4*>(dhp_s + k * BB);
#pragma unroll
        for (int q = 0; q < BB / 4; ++q) {
          const float4 v = dv[q];
          acc[4 * q + 0] = fmaf(v.x, wv, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(v.y, wv, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v.z, wv, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v.w, wv, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int r = 0; r < BB; ++r) dh_s[r * H + j] += acc[r];
    }

    // dW partial: each thread owns whole columns k of [H][GH]
    if (!split) {
      for (int k = threadIdx.x; k < GH; k += blockDim.x) {
        float dk[BB];
        const float4* dv = reinterpret_cast<const float4*>(dhp_s + k * BB);
#pragma unroll
        for (int q = 0; q < BB / 4; ++q) {
          const float4 v = dv[q];
          dk[4 * q + 0] = v.x;
          dk[4 * q + 1] = v.y;
          dk[4 * q + 2] = v.z;
          dk[4 * q + 3] = v.w;
        }
        // four rows at a time: their loads are in flight together (H % 4 == 0)
        for (int i0 = 0; i0 < H; i0 += 4) {
          float old[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) old[u] = pw[(size_t)(i0 + u) * GH + k];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4* hv = reinterpret_cast<const float4*>(hT_s + (i0 + u) * BB);
            float a = 0.0f;
#pragma unroll
            for (int q = 0; q < BB / 4; ++q) {
              const float4 v = hv[q];
              a = fmaf(v.x, dk[4 * q + 0], a);
              a = fmaf(v.y, dk[4 * q + 1], a);
              a = fmaf(v.z, dk[4 * q + 2], a);
              a = fmaf(v.w, dk[4 * q + 3], a);
            }
            pw[(size_t)(i0 + u) * GH + k] = old[u] + a;
          }
        }
      }
    }
    __syncthreads();  // dhp_s, hT_s and dh_s are rewritten next step
  }

  if (!split)
    for (int k = threadIdx.x; k < GH; k += blockDim.x) pb[k] = db_s[k];
}

// dw[e][i] = sum over row blocks rb (in order) of ws_w[e][rb][i]; db alike.
__global__ void rnn_bwd_reduce_kernel(int D, int nrb, long long nw, long long nb,
                                      const float* __restrict__ ws_w,
                                      const float* __restrict__ ws_b, float* __restrict__ dw,
                                      float* __restrict__ db) {
  const long long total = (long long)D * (nw + nb);
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    if (idx < (long long)D * nw) {
      const long long e = idx / nw, i = idx % nw;
      const float* src = ws_w + e * nrb * nw + i;
      float s = 0.0f;
      for (int rb = 0; rb < nrb; ++rb) s += src[rb * nw];
      dw[idx] = s;
    } else {
      const long long k = idx - (long long)D * nw;
      const long long e = k / nb, i = k % nb;
      const float* src = ws_b + e * nrb * nb + i;
      float s = 0.0f;
      for (int rb = 0; rb < nrb; ++rb) s += src[rb * nb];
      db[k] = s;
    }
  }
}

template <int CELL, typename CT, typename HT>
int launch(int T, int B, int H, int D, int dir0, int split, const Ptrs& p, const float* mask,
           const void* w_hh, const void* w_hhT, const float* b_hh, const float* d_hfinal,
           float* ws_w, float* ws_b, float* dw, float* db, cudaStream_t stream) {
  constexpr int G = NumGates<CELL>::G;
  auto kernel = rnn_bwd_kernel<CELL, CT, HT>;
  const size_t GH = (size_t)G * H;
  const size_t smem =
      ((size_t)(CELL == kLSTM ? 3 : 2) * BB * H + GH * BB + GH) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((H + 31) / 32) * 32;
  if (threads > THREADS) threads = THREADS;
  const int nrb = (B + BB - 1) / BB;
  const dim3 grid(nrb, D);
  kernel<<<grid, threads, smem, stream>>>(
      T, B, H, dir0, split, p, mask, static_cast<const CT*>(w_hh),
      static_cast<const CT*>(w_hhT), b_hh, d_hfinal, ws_w, ws_b);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split) return (int)e;
  const long long nw = (long long)H * GH, nb = (long long)GH;
  const long long total = (long long)D * (nw + nb);
  int blocks = (int)((total + 255) / 256);
  if (blocks > 4096) blocks = 4096;
  rnn_bwd_reduce_kernel<<<blocks, 256, 0, stream>>>(D, nrb, nw, nb, ws_w, ws_b, dw, db);
  return (int)cudaGetLastError();
}

template <int CELL>
int dispatch_types(int cdt_bf16, int hist_bf16, int T, int B, int H, int D, int dir0, int split,
                   const Ptrs& p, const float* mask, const void* w_hh, const void* w_hhT,
                   const float* b_hh, const float* d_hfinal, float* ws_w, float* ws_b,
                   float* dw, float* db, cudaStream_t stream) {
  if (!cdt_bf16)
    return launch<CELL, float, float>(T, B, H, D, dir0, split, p, mask, w_hh, w_hhT, b_hh,
                                      d_hfinal, ws_w, ws_b, dw, db, stream);
  if (hist_bf16)
    return launch<CELL, __nv_bfloat16, __nv_bfloat16>(T, B, H, D, dir0, split, p, mask, w_hh,
                                                      w_hhT, b_hh, d_hfinal, ws_w, ws_b, dw,
                                                      db, stream);
  return launch<CELL, __nv_bfloat16, float>(T, B, H, D, dir0, split, p, mask, w_hh, w_hhT,
                                            b_hh, d_hfinal, ws_w, ws_b, dw, db, stream);
}

}  // namespace

extern "C" {

// cell: 0 RNN, 1 GRU, 2 LSTM. cdt_bf16: xp, W_hh, W_hh^T, dxp and dhp are
// bf16 (else f32). hist_bf16: the history and the cotangents are bf16
// (only with cdt_bf16). dir0: absolute direction of entry 0. split: 0
// accumulates dW/db (workspaces ws_w [D, ceil(B/16), H, G*H] and ws_b
// [D, ceil(B/16), G*H] f32, results dw [D, H, G*H] and db [D, G*H]); 1
// emits dhp (GRU) instead and touches no workspace. Per-direction
// pointers the call does not use may be null. device: the CUDA ordinal
// the tensors live on. Returns cudaGetLastError() after the launches (0
// on success).
int rnn_bwd_launch(int device, int cell, int cdt_bf16, int hist_bf16, int split, int T, int B,
                   int H, int D, int dir0, const void* xp0, const void* xp1, const float* mask,
                   const void* out0, const void* out1, const void* c0, const void* c1,
                   const void* dout0, const void* dout1, const void* w_hh, const void* w_hhT,
                   const float* b_hh, const float* d_hfinal, void* dxp0, void* dxp1,
                   void* dhp0, void* dhp1, float* ws_w, float* ws_b, float* dw, float* db,
                   void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (H % 4 != 0 || D < 1 || D > 2 || dir0 < 0 || dir0 + D > 2 || cell < 0 || cell > 2)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  Ptrs p = {{xp0, xp1}, {out0, out1}, {c0, c1}, {dout0, dout1}, {dxp0, dxp1}, {dhp0, dhp1}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cell == kGRU)
    return dispatch_types<kGRU>(cdt_bf16, hist_bf16, T, B, H, D, dir0, split, p, mask, w_hh,
                                w_hhT, b_hh, d_hfinal, ws_w, ws_b, dw, db, s);
  if (cell == kLSTM)
    return dispatch_types<kLSTM>(cdt_bf16, hist_bf16, T, B, H, D, dir0, split, p, mask, w_hh,
                                 w_hhT, b_hh, d_hfinal, ws_w, ws_b, dw, db, s);
  return dispatch_types<kRNN>(cdt_bf16, hist_bf16, T, B, H, D, dir0, split, p, mask, w_hh,
                              w_hhT, b_hh, d_hfinal, ws_w, ws_b, dw, db, s);
}

const char* rnn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
