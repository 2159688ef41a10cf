// Staging and scoring one 128-row tile of the corpus against a few queries,
// for the f32 scans of segmax.cu and topk_stream.cu (stage_chunk, then the
// f32-sum scoring score_tile); the bf16, int8 and s8 scans stage through
// doc_mma.cuh's cp.async ring instead.
//
// A block of 128 threads owns a tile of 128 doc rows; thread i owns row i
// and keeps its BQ sums in registers. The queries sit in shared memory as
// f32 ([BQ][QP] floats, QP = H + 4), read as broadcasts. Doc rows stream
// through shared memory in 128-byte column chunks, loaded with coalesced
// 16-byte loads and a 16-byte row pad so the per-row reads are free of bank
// conflicts. Products are f32 FMAs: a bf16, int8 or f32 value times a bf16
// or f32 query value is exact in f32, so only the summation order differs
// from a plain f32 product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace doc_tile {

constexpr int ROWS = 128;         // rows per tile == threads per block
constexpr int CHUNK_BYTES = 128;  // bytes of each doc row per staged chunk
constexpr int PITCH = CHUNK_BYTES + 16;
constexpr int TILE_BYTES = ROWS * PITCH;  // shared memory the staging needs

__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(&raw);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[16]) {
  const int8_t* p = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = static_cast<float>(p[i]);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// q_s[b * QP + k] = q[b][k] as f32 (zero beyond B rows and H columns).
template <typename TQ, int BQ>
__device__ __forceinline__ void load_queries(int B, int H, const TQ* __restrict__ q, float* q_s) {
  const int QP = H + 4;
  for (int i = threadIdx.x; i < BQ * QP; i += ROWS) {
    const int b = i / QP, k = i % QP;
    q_s[i] = (b < B && k < H) ? to_f(q[(size_t)b * H + k]) : 0.0f;
  }
}

// Stages bytes [k0, k0 + n) of rows row0 .. row0 + ROWS - 1 of a row-major
// matrix with row_bytes bytes per row into tile ([ROWS][PITCH] bytes), n =
// min(CHUNK_BYTES, row_bytes - k0); returns n / 16, the 16-byte vectors per
// row. row_bytes and k0 are multiples of 16 and docs is 16-byte aligned.
// Every thread of the block calls it; it begins with a barrier (the caller's
// earlier reads of shared memory are complete) and ends with one (the chunk
// is staged).
__device__ __forceinline__ int stage_chunk(const unsigned char* __restrict__ docs, long long row0,
                                           int k0, int row_bytes, unsigned char* tile) {
  const int vpr = (row_bytes - k0 < CHUNK_BYTES ? row_bytes - k0 : CHUNK_BYTES) / 16;
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * vpr; i += ROWS) {
    const int r = i / vpr, v = i % vpr;
    const uint4 val =
        *reinterpret_cast<const uint4*>(docs + (size_t)(row0 + r) * row_bytes + k0 + v * 16);
    *reinterpret_cast<uint4*>(tile + r * PITCH + v * 16) = val;
  }
  __syncthreads();
  return vpr;
}

// acc[b] = sum_k docs[row0 + threadIdx.x][k] * q_s[b][k], f32 sums. Every
// thread of the block calls it; it begins with a barrier, so the caller's
// earlier reads of shared memory (and the query load) are complete.
// T: storage dtype (f32, bf16 or int8); docs rows are 16-byte aligned.
template <typename T, int BQ>
__device__ __forceinline__ void score_tile(int H, const T* __restrict__ docs, long long row0,
                                           const float* q_s, unsigned char* tile,
                                           float (&acc)[BQ]) {
  constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16-byte load
  const int QP = H + 4;
  const int row_bytes = H * (int)sizeof(T);
#pragma unroll
  for (int b = 0; b < BQ; ++b) acc[b] = 0.0f;
  for (int kb = 0; kb < row_bytes; kb += CHUNK_BYTES) {
    const int vpr =
        stage_chunk(reinterpret_cast<const unsigned char*>(docs), row0, kb, row_bytes, tile);
    const int k0 = kb / (int)sizeof(T);  // first element of the chunk
    for (int v = 0; v < vpr; ++v) {
      const uint4 raw = *reinterpret_cast<const uint4*>(tile + threadIdx.x * PITCH + v * 16);
      float x[VEC];
      unpack(raw, x);
      const float* qk = q_s + k0 + v * VEC;
#pragma unroll
      for (int b = 0; b < BQ; ++b) {
        const float4* qv = reinterpret_cast<const float4*>(qk + b * QP);
#pragma unroll
        for (int e = 0; e < VEC / 4; ++e) {
          const float4 qq = qv[e];
          acc[b] = fmaf(x[4 * e + 0], qq.x, acc[b]);
          acc[b] = fmaf(x[4 * e + 1], qq.y, acc[b]);
          acc[b] = fmaf(x[4 * e + 2], qq.z, acc[b]);
          acc[b] = fmaf(x[4 * e + 3], qq.w, acc[b]);
        }
      }
    }
  }
}

}  // namespace doc_tile
