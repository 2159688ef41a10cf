// Masked recurrent time loop (GRU / LSTM / RNN), backward, for all
// directions of one layer in one call.
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
// [T, B, H] (HT), and a [T, B] f32 mask; W_hh [D, H, G*H] in CT, b_hh
// [D, G*H] f32, d_hfinal [D, B, H] f32. Direction d walks its own
// processing order backwards: absolute direction 0 visits t = T-1..0,
// direction 1 t = 0..T-1, and h_prev is the saved state at the
// neighbouring position (t-1, or t+1 for direction 1), zero at each
// direction's first position. Per step:
//   dh_t = dh + dout[t]; dh_new = m*dh_t; dh_direct = (1-m)*dh_t
//   hp = round_ct(h_prev) . round_ct(W) + b          (gate recompute)
//   gate cotangents dxp and dhp (they differ in GRU's candidate third)
//   dh = round_ct(dhp) . round_ct(W)^T + (GRU: dh_new*z) + dh_direct
//   dW = sum_t round_ct(h_prev)^T . round_ct(dhp), db = sum_t,rows dhp (f32)
// dxp (and GRU's dhp) are written in CT. The rounding points are the TPU
// kernel's (_mm, _outer_acc and the cdt outputs).
//
// What bounds it on Hopper: the chain. Only dh_{t+1} <- dhp_t . W^T
// depends on the step before; at the main path's shapes the call moves
// 40-60 us worth of bytes and its products take 30-60 us at the
// tensor-core rate, while T = 128 dependent steps each pay a staging copy,
// the gate math, an exchange between SMs, a barrier and a product, none of
// them large enough to fill an SM. Per-step latency and instruction issue,
// not bytes or operations, set the time. So the design takes everything
// that is not on the chain out of the loop, and keeps one step short:
//
// 1. Gate recompute, off the chain: before the loop one product per
//    direction, hp = round(h_prev) . round(W) + b over all T*B rows
//    ([T*B, H] x [H, G*H], f32 into a workspace; the shifted history is
//    read in place). Chosen over a producer warpgroup computing step t+1's
//    hp beside step t's chain: the workspace (100 MB at D=2, T=128, B=128,
//    H=256) is cheap on an 80 GB card, the product runs on every SM at
//    once instead of on the chain's few, and the chain's SMs keep their
//    issue slots for the chain.
// 2. The serial loop carries only dh (and LSTM's dc). One thread-block
//    cluster of NC CTAs (NC <= 8, or up to 16 where 8 do not fit; launched
//    with the cluster attribute)
//    walks all T steps for R batch rows of one direction; CTA q owns HC
//    hidden columns j and the G gate columns g*H + j. Each CTA keeps its
//    rows of W, round(W[j, :]) for its j (W^T's columns, exactly the
//    col-major B operand of mma.sync), resident in shared memory for all T
//    steps (at H=256, bf16: 48 KiB per CTA for 32 columns). Per step:
//    cp.async brings the next step's hp, xp, h_prev, dout and mask for the
//    CTA's rows and columns into a second staging buffer; the gate math of
//    the CTA's own columns writes dxp (and GRU's dhp) to global memory,
//    adds the f32 dhp to a db partial and stores the rounded dhp in its
//    shared row block; the CTA pushes its slice of that block into every
//    peer's copy through distributed shared memory (16-byte stores, each
//    word read once); one cluster barrier (release/acquire), the row
//    blocks double-buffered so the next step's pushes cannot land on a
//    block a peer still reads; then dh[:, own] += round(dhp)[R, G*H] .
//    round(W)^T[G*H, own] on the tensor cores (ldmatrix and mma.sync
//    m16n8k16 bf16, f32 accumulation, four accumulators per tile for
//    latency; with few tiles two warps share one, each taking half of k).
//    Every index map is worked out once before the loop: all of a CTA's
//    warps issue through the same four schedulers, and bookkeeping
//    repeated per step cost more than the copies it drove.
//    The alternatives: exchanging the rounded dhp through L2 (global
//    writes, the barrier, cp.async reads of the whole row block) saved
//    little over the push when both were measured on the card; splitting
//    the product over k and reduce-scattering f32 partials moves R*H f32
//    per CTA per step instead of its G*R*HC dhp values. Both keep the
//    barrier; the push is the simplest.
// 3. Weight gradient, off the chain (split=False only): after the loop one
//    product per direction, dW = round(h_prev)^T . round(dhp) over all T*B
//    rows ([H, T*B] x [T*B, G*H]), split over T*B into S slices whose
//    partials a last launch sums in a fixed order together with the
//    clusters' db partials. No atomics anywhere: every call gives the same
//    bits, which resume relies on.
//
// Both products stream 128 x 128 tiles through a three-stage cp.async ring
// into ldmatrix and mma.sync. f32 compute (the JAX kernel's
// Precision.HIGHEST) takes every product on the same tensor cores as split
// products (recur_chain.cuh: three bf16 pieces a value, the six leading
// products of the pieces): a small launch (split_planes) writes the hi,
// mid and lo planes of each product's operands once a call into the
// wrapper's workspace, the ring carries all three, and each k16 step takes
// six mma.sync products; the chain keeps W and the dhp row block f32 in
// shared memory and splits each k16 step's fragments in registers (f32 at
// 8 rows: the m16 tile's rows 8-15 absent, never read). The chain's W held
// as three bf16 planes instead, split once a call (the same pieces, the
// same bits), ran 1.07-1.08x slower in its best layout at GRU H=1024 B=64
// and H=256 B=64 on an H100, level at H=256 B=128 (PERF.md section 6):
// its 6 bytes a value against 4 leave narrower chunks of W. Where a
// CTA's W rows do not fit beside the rest (wide layers), the chain streams
// them every step through a ring of S stages that runs on across steps,
// as the forward's does (csrc/rnn_fwd.cu): the wrapper's scratch holds W
// packed once per call (rnn_bwd_pack_w, one pass), so each stage is one
// bulk copy (cp.async.bulk), the copies taken in turn by the warps and
// completing on the stage's "full" mbarrier; every warp releases a stage
// on its "empty" mbarrier, and no block barrier is left on the route. A
// stage holds KW columns of a KC chunk: KC is where the four accumulators
// of the chain product restart, so the sums keep the order they had with
// one chunk buffer, and the pieces (multiples of 32 at bf16, starting on
// the first or third accumulator) only change when each part of W
// arrives. Each piece costs its warps about a microsecond beyond its
// bytes, so pieces are whole chunks, as many stages as fit, where the row
// block is exchanged whole; where it is exchanged in chunks, each behind a
// cluster barrier, two stages of the widest piece that leaves two, so the
// next piece lands during the barrier. Where no second stage fits beside
// a whole chunk, the ring has one: each chunk's copy then waits for the
// last reads of the one before. Where even the two rounded dhp row blocks do not fit (GRU past H=816 at bf16,
// LSTM past 608), the chain keeps one and pays a second, split cluster
// barrier a step: each CTA arrives after its product and waits before its
// next push, so no push lands on a block a peer still reads. Where even one
// row block does not fit beside the rest (GRU past about H=1700 at bf16,
// LSTM past about 1400, in clusters of 16), it is exchanged in chunks of
// XC columns: the gate math keeps the CTA's rounded dhp [R][G][HC], and
// per chunk the CTA pushes its words of the chunk into one of two
// alternating chunk buffers (its own and every peer's), one cluster
// barrier, then the chunk's product with W streamed in the same chunks. A
// push for chunk n lands on the buffer of chunk n - 2, which every CTA
// finished reading before the barrier of chunk n - 1; the accumulators
// run across the chunks, so the sums keep their order.
//
// Large batches (bf16, B >= 256; template argument WE): a cluster of at
// most 32 rows keeps W resident beside two row blocks and two staging
// buffers (210,688 of 232,448 bytes at GRU H=256), so B=1024 takes 64
// clusters, five waves of the card's 15 clusters of 8, each a whole time
// loop. The large-batch layout keeps W resident beside one row block and
// stages nothing, so a CTA takes 64-256 rows (GRU H=256 B=1024: 96 rows, 11
// clusters a direction, two waves). At those rows every part of a step
// grows with the rows (the instrumented build at GRU H=256 on an H100,
// PERF.md section 6: the cluster route's step 7.4 us at 32 rows; the same
// design at 96 rows 19.9, its push alone 5.5, about 24 GB/s of stores to
// the peers an SM), so the step is rebuilt around the copy engine:
// - the row block is nc regions [R][wide_ld], one a CTA's G*hc columns, so
//   the exchange is one bulk copy shared -> peer shared a peer
//   (cp.async.bulk ... shared::cluster.shared::cta), completing on the
//   peer's mbarrier; no thread pushes and no barrier waits for the data;
//   the product walks k in the order of the whole row block, each k16
//   step's 16 columns in one region, found through a table of offsets;
// - a CTA writes its region only once every peer has finished the last
//   product (the cluster barrier's wait, before the gate math), so no copy
//   still reads it;
// - each gate-math thread takes quads of four neighbouring columns of a
//   row: it loads their hp, xp, h_prev, dout and mask from L2 a word a
//   quad (the next step's rows prefetched to L2 a step ahead, a share a
//   CTA, once the step's first loads are out), the next quad's loads beside
//   the math of the one before, writes dxp, dhp and its region a word a
//   quad, and keeps their db partials in registers (after the loop they
//   pass through shared memory laid over W and the row block);
// - each warp runs its units' products in turn, each once its part of 32
//   rows is in (tiles of four units sharing each A fragment, or the units
//   of a warp interleaved, ran no faster: the first held the gate math back
//   through its registers, the second waited longer for the parts).
// Its sums keep the order of the cluster-route layout it stands in for, so
// it gives that layout's bits: a db partial per db_rows (16 or 32) rows,
// the partials summed in row order, and where that layout's product split k
// between two warps (halves), the two halves in turn, each in its own four
// accumulators.
// The instrumented build (-DRNN_BWD_PHASES, a library of its own that
// tools/bench_rnn_stream.py --step-phases asks for) adds the PHASES
// kernels: thread 0's clock64() cycles of each phase of a step. The
// wrapper (ops/rnn_scan.py, bwd_plan) picks NC, R, KC, XC, the staging
// depth, the row blocks, S and the large-batch layout, and knows the
// shared-memory layout below; the launcher refuses a plan that does not
// fit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "recur_chain.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace recur_chain;

constexpr int CHAIN_THREADS = 256;
constexpr int CHAIN_WARPS = CHAIN_THREADS / 32;
constexpr int UNITS_MAX = 4;  // (16 x 8) chain-product tiles per warp
// The large-batch layout: a thread's (row, column) elements of a step's
// gate math (a template argument WE: R * hc / CHAIN_THREADS rounded up to
// a multiple of WIDE_BATCH, at most 16, since a CTA's units hold R * hc <=
// UNITS_MAX * CHAIN_WARPS * 128), each keeping its G db partials in
// registers. A batch is a quad of WIDE_BATCH neighbouring columns of a row,
// its inputs loaded while the quad before runs its math.
constexpr int WIDE_BATCH = 4;
constexpr int WIDE_EPT_MAX = UNITS_MAX * CHAIN_WARPS * 16 * 8 / CHAIN_THREADS;

// The large-batch layout's row block: one region a CTA, [R][xld] of its
// G * hc columns (each CTA's copy of a peer's part of a region is one bulk
// copy), rows padded so that ldmatrix's eight 16-byte rows fall on
// distinct banks
__host__ __device__ constexpr int wide_ld(int G, int hc) {
  return G * hc + ((G * hc / 8) % 2 ? 16 : 8);
}
// The instrumented build (-DRNN_BWD_PHASES; never the shipped library):
// per CTA, the clock64() cycles of the time loop's phases, its whole
// loop's cycles and its %globaltimer nanoseconds
enum Phase { kInputs, kGate, kPushWait, kPush, kBarrier, kProduct, kPhases };
constexpr int PHASE_WORDS = kPhases + 2;

struct Ptrs {
  const void* xp[2];
  const void* out[2];
  const void* hr[2];  // the history rounded to the compute dtype (the products' operand)
  const void* c[2];
  const void* dout[2];
  void* dxp[2];
  void* dhp[2];
};

// ---------------------------------------------------------------------------
// the two chain-free products
// ---------------------------------------------------------------------------

struct GemmArgs {
  int T, B, H, GH, dir0, nsplit, klen;  // klen: rows of T*B per slice (MODE 1), a multiple of the K tile
  const void* hr[2];   // the state history rounded to bf16 (or its pieces), per direction
  const void* rhs[2];  // [K][GH] bf16 (or pieces) per direction: W_hh (MODE 0), dhp (MODE 1)
  size_t hr_plane, rhs_plane;  // split products: elements from one piece to the next
  const float* bias;   // [D][GH] (MODE 0)
  float* c;            // MODE 0: hp [D][T*B][GH]; MODE 1: partials [D][S][H][GH]
};

// Both products, per direction e (blockIdx.z = e * nsplit + slice):
// MODE 0, the gate recompute: hp[m][n] = sum_k round(h_prev(m))[k] W[k][n]
//   + b[n] over the T*B rows m = t*B + b, K = H.
// MODE 1, the weight gradient: part[s][i][n] = sum over the rows k = t*B + b
//   of slice s of round(h_prev(k))[i] dhp(k)[n].
// h_prev of row q = t*B + b is the history's row q - B (direction 0) or
// q + B (direction 1), zero where that falls outside [0, T*B): the
// shifted history is read in place.

// 128 x 128 tiles, 8 warps of 64 x 32, K in tiles of 32 through a
// three-stage cp.async ring (8-byte copies: rows are 8-byte aligned for
// any H divisible by 4; out-of-range rows and the shift's edge are
// zero-filled). Every operand is copied in its global layout and ldmatrix
// (.trans where the layout is k-major) forms the mma.sync fragments; rows
// are padded by 16 bytes, so the ldmatrix reads are free of bank conflicts.
// P: the bf16 pieces of each operand, 1 at bf16 compute; 3 at f32 (each
// operand split beforehand into its hi, mid and lo planes by split_planes,
// the ring carrying all three, and each k16 step taking the six products
// of recur_chain.cuh, smallest first, over the warp's 16 tiles in turn).
constexpr int TM = 128, TN = 128, TK = 32, TSTAGES = 3, TTHREADS = 256;
constexpr int A_LD_MK = TK + 8;  // A as [m][k] (MODE 0: history rows)
constexpr int A_LD_KM = TM + 8;  // A as [k][m] (MODE 1: history rows)
constexpr int B_LD = TN + 8;     // B as [k][n]
constexpr int A_TILE = TM * A_LD_MK > TK * A_LD_KM ? TM * A_LD_MK : TK * A_LD_KM;
constexpr int B_TILE = TK * B_LD;
constexpr int gemm_smem(int P) { return TSTAGES * P * (A_TILE + B_TILE) * 2; }
constexpr int KSLICE = 64;  // a weight-gradient slice's rows of T*B: a multiple of this

__device__ __forceinline__ void cp_async8_zfill(void* smem_dst, const void* src, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 8 : 0));
}
template <int MODE, int P>
__global__ void __launch_bounds__(TTHREADS) rnn_bwd_gemm(GemmArgs a) {
  extern __shared__ __align__(16) unsigned char gsm[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(gsm);  // [TSTAGES][P][A_TILE]
  __nv_bfloat16* Bs = As + TSTAGES * P * A_TILE;              // [TSTAGES][P][B_TILE]
  const int B = a.B, H = a.H, GH = a.GH, TB = a.T * a.B;
  const int e = blockIdx.z / a.nsplit, s = blockIdx.z % a.nsplit;
  const int shift = a.dir0 + e == 0 ? -B : B;
  const int M = MODE == 0 ? TB : H;
  const int k_begin = MODE == 0 ? 0 : s * a.klen;
  const int k_end = MODE == 0 ? H : min(TB, k_begin + a.klen);
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int tid = threadIdx.x;

  auto load_tile = [&](int k0, int st) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const __nv_bfloat16* hr = static_cast<const __nv_bfloat16*>(a.hr[e]) + p * a.hr_plane;
      const __nv_bfloat16* rhs = static_cast<const __nv_bfloat16*>(a.rhs[e]) + p * a.rhs_plane;
      __nv_bfloat16* as = As + (st * P + p) * A_TILE;
      __nv_bfloat16* bs = Bs + (st * P + p) * B_TILE;
#pragma unroll
      for (int i = 0; i < TM * TK / 4 / TTHREADS; ++i) {
        const int c = tid + i * TTHREADS;
        if (MODE == 0) {  // 128 rows m of 8 four-element chunks along k
          const int ml = c / 8, kl = (c % 8) * 4;
          const int q = m0 + ml, k = k0 + kl, src = q + shift;
          const bool ok = q < M && k < k_end && src >= 0 && src < TB;
          cp_async8_zfill(as + ml * A_LD_MK + kl, ok ? hr + (size_t)src * H + k : hr, ok);
        } else {  // 32 rows k of 32 chunks along m
          const int kl = c / 32, ml = (c % 32) * 4;
          const int q = k0 + kl, m = m0 + ml, src = q + shift;
          const bool ok = q < k_end && m < M && src >= 0 && src < TB;
          cp_async8_zfill(as + kl * A_LD_KM + ml, ok ? hr + (size_t)src * H + m : hr, ok);
        }
        const int kl = c / 32, nl = (c % 32) * 4;  // B: 32 rows k of 32 chunks along n
        const int k = k0 + kl, n = n0 + nl;
        const bool ok = k < k_end && n < GH;
        cp_async8_zfill(bs + kl * B_LD + nl, ok ? rhs + (size_t)k * GH + n : rhs, ok);
      }
    }
  };

  const int warp = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int lm = lane / 8, lr = lane % 8;  // the ldmatrix matrix this lane addresses, and its row
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
  const int nk = k_end > k_begin ? (k_end - k_begin + TK - 1) / TK : 0;
#pragma unroll
  for (int i = 0; i < TSTAGES - 1; ++i) {
    if (i < nk) load_tile(k_begin + i * TK, i);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<TSTAGES - 2>();
    __syncthreads();  // tile kt has landed; nobody reads tile kt - 1's stage any more
    const int nx = kt + TSTAGES - 1;
    if (nx < nk) load_tile(k_begin + nx * TK, nx % TSTAGES);
    cp_async_commit();
#pragma unroll
    for (int ks = 0; ks < TK; ks += 16) {
      uint32_t af[4][P][4], bfr[4][P][2];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const __nv_bfloat16* as = As + ((kt % TSTAGES) * P + p) * A_TILE;
        const __nv_bfloat16* bs = Bs + ((kt % TSTAGES) * P + p) * B_TILE;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (MODE == 0)
            ldsm_x4(af[mt][p], as + (wm + mt * 16 + lane % 16) * A_LD_MK + ks + (lane / 16) * 8);
          else
            ldsm_x4_t(af[mt][p],
                      as + (ks + (lm / 2) * 8 + lr) * A_LD_KM + wm + mt * 16 + (lm % 2) * 8);
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t t4[4];
          ldsm_x4_t(t4, bs + (ks + (lm % 2) * 8 + lr) * B_LD + wn + np * 16 + (lm / 2) * 8);
          bfr[2 * np][p][0] = t4[0];
          bfr[2 * np][p][1] = t4[1];
          bfr[2 * np + 1][p][0] = t4[2];
          bfr[2 * np + 1][p][1] = t4[3];
        }
      }
      // P = 1: the one product; P = 3: the six of the split, each over the 16 tiles
#pragma unroll
      for (int sp = 0; sp < (P == 1 ? 1 : 6); ++sp) {
        const int pa = P == 1 ? 0 : split_a(sp), pb = P == 1 ? 0 : split_b(sp);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[mt][nt], af[mt][pa][0], af[mt][pa][1], af[mt][pa][2], af[mt][pa][3],
                     bfr[nt][pb][0], bfr[nt][pb][1]);
      }
    }
  }
  cp_async_wait<0>();

  float* out = a.c + (MODE == 0 ? (size_t)e * M * GH : ((size_t)e * a.nsplit + s) * M * GH);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mt * 16 + gid + h * 8, n = n0 + wn + nt * 8 + tig * 2;
        if (m < M && n < GH) {  // n and n + 1 (G*H is even)
          float2 v = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          if (MODE == 0) {
            v.x += a.bias[(size_t)e * GH + n];
            v.y += a.bias[(size_t)e * GH + n + 1];
          }
          *reinterpret_cast<float2*>(out + (size_t)m * GH + n) = v;
        }
      }
}

// one of the two products over all D directions (and nsplit slices), P
// pieces an operand
template <int MODE, int P>
cudaError_t gemm(const GemmArgs& g, int D, cudaStream_t stream) {
  const int M = MODE == 0 ? g.T * g.B : g.H;
  auto kernel = rnn_bwd_gemm<MODE, P>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, gemm_smem(P));
  if (err != cudaSuccess) return err;
  const dim3 grid((M + TM - 1) / TM, (g.GH + TN - 1) / TN, D * g.nsplit);
  kernel<<<grid, TTHREADS, gemm_smem(P), stream>>>(g);
  return cudaGetLastError();
}

// x [n] f32 (n even, x 8-byte aligned) -> out [3][n] bf16: the hi, mid and
// lo planes of its values (recur_chain.cuh split_bf16x3), the f32 route's
// GEMM operands, written once a call
__global__ void split_planes(const float* __restrict__ x, size_t n, __nv_bfloat16* __restrict__ out) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n / 2;
       i += (size_t)gridDim.x * blockDim.x) {
    const float2 v = reinterpret_cast<const float2*>(x)[i];
    uint32_t p[PIECES];
    split_bf16x3(v.x, v.y, p);
#pragma unroll
    for (int k = 0; k < PIECES; ++k) reinterpret_cast<uint32_t*>(out + k * n)[i] = p[k];
  }
}

cudaError_t split_pieces(const void* x, size_t n, __nv_bfloat16* out, cudaStream_t stream) {
  const size_t blocks = (n / 2 + 255) / 256;
  split_planes<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      static_cast<const float*>(x), n, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the serial loop: the dh (and dc) chain, one cluster per (direction, R rows)
// ---------------------------------------------------------------------------

struct ChainArgs {
  int T, B, H, dir0, split;
  int R, hc, kp, kc, stages, blocks, xc;  // the plan (kp: G*H rounded up to 16; kc == kp: W
                                          // resident; blocks: dhp row blocks, 2 or 1; xc < kp:
                                          // the row block exchanged in chunks of xc columns)
  int S, kw;              // streamed: the W ring's stages of kw columns (pieces of kc chunks)
  Ptrs p;
  const float* mask;      // [T][B]
  const void* w_hh;       // [D][H][GH] CT
  const void* wpk;        // streamed: W packed by rnn_bwd_pack_w, [D][nc][pieces][hc][kw + pad]
  const float* hp;        // [D][T*B][GH] f32 (GRU, LSTM)
  const float* d_hfinal;  // [D][B][H]
  float* db_part;         // [D][parts][GH] (split == 0): a partial per db_rows rows
  int db_rows, khalf;     // the sums' order (below): rows a db partial, where k splits
  long long* phases;      // the instrumented build's [D][grid.x][PHASE_WORDS], else null
};

// Byte offsets of one chain CTA's shared memory (ops/rnn_scan.py's
// _bwd_smem_bytes mirrors the sizes): round(W) rows [hc][kp + pad] where
// resident, else the ring's S stages of [hc][kw + pad] (and, last, their
// full and empty barriers [2][S]), the
// rounded dhp row blocks [blocks][R][kp + pad] (exchanged in chunks: two
// chunk buffers [2][R][xc + pad] and the CTA's own rounded dhp [R][G][hc]),
// the staging buffers, the dh (and dc) carry [R][hc] and the db partial
// [G][R][hc], all f32 but W and dhp. One staging buffer: hp [G][R][hc] f32 and xp [G][R][hc] CT (GRU,
// LSTM), h1 [R][hc] HT (GRU h_prev, LSTM c_prev, RNN h_t), dout [R][hc]
// HT, mask [R] f32. No staging buffer (stages 0) is the large-batch
// layout: its row block is nc regions [R][wide_ld] (one a CTA) and each
// k16 step's offsets in them (int4), and it has an mbarrier a part of 32
// rows; the gate math reads its inputs from L2 and keeps the db partial in
// registers, which, after the loop, pass through [G][R][hc] f32 laid over
// W and the row block.
struct ChainSmem {
  size_t w, dhp, own, stage, dh, dc, db, bar, total;
  size_t st_hp, st_xp, st_h1, st_do, st_m, st_size;
};

template <int CELL, typename CT, typename HT>
__host__ __device__ ChainSmem chain_smem(int R, int hc, int kp, int kc, int stages,
                                         int blocks, int xc, int S, int kw, int nc) {
  constexpr int G = NumGates<CELL>::G;
  constexpr size_t padk = 16 / sizeof(CT);
  ChainSmem s;
  size_t o = 0;
  s.st_hp = o;
  if (CELL != kRNN) o += a16((size_t)G * R * hc * 4);
  s.st_xp = o;
  if (CELL != kRNN) o += a16((size_t)G * R * hc * sizeof(CT));
  s.st_h1 = o;
  o += a16((size_t)R * hc * sizeof(HT));
  s.st_do = o;
  o += a16((size_t)R * hc * sizeof(HT));
  s.st_m = o;
  o += a16((size_t)R * 4);
  s.st_size = o;
  o = 0;
  s.w = o;
  if (kc < kp)
    o += (size_t)S * a16((size_t)hc * (kw + padk) * sizeof(CT));
  else
    o += a16((size_t)hc * (kc + padk) * sizeof(CT));
  const int xw = xc < kp ? xc : kp;  // the columns of a row block held at once
  s.dhp = o;
  if (stages)
    o += a16((size_t)blocks * R * (xw + padk) * sizeof(CT));
  else  // the large-batch layout: a region a CTA, then the k16 steps' offsets
    o += a16((size_t)nc * R * wide_ld(G, hc) * sizeof(CT)) + (size_t)kp / 16 * 16;
  s.own = o;
  if (xw < kp) o += a16((size_t)R * G * hc * sizeof(CT));
  s.stage = o;
  o += (size_t)stages * s.st_size;
  s.dh = o;
  o += a16((size_t)R * hc * 4);
  s.dc = o;
  if (CELL == kLSTM) o += a16((size_t)R * hc * 4);
  s.db = o;
  if (stages) o += a16((size_t)G * R * hc * 4);
  s.bar = o;
  if (kc < kp) o += (size_t)16 * S;
  if (!stages) o += a16((size_t)8 * (R / 32));  // the large-batch layout's parts' mbarriers
  s.total = stages || o >= a16((size_t)G * R * hc * 4) ? o : a16((size_t)G * R * hc * 4);
  return s;
}

// A thread's fixed share of copying rows of `bytes_per_row` bytes: word
// wd (of `width` bytes) of rows r, r + rstep, ... (none unless active).
// `align_bits`: the byte offsets and strides involved, or-ed together.
struct RowCopy {
  int width, wd, r, rstep;
  bool active;
};
__device__ __forceinline__ RowCopy row_copy(int bytes_per_row, int align_bits, int tid) {
  RowCopy c;
  c.width = copy_width(align_bits | bytes_per_row);
  const int words = bytes_per_row / c.width;  // <= CHAIN_THREADS: own <= 256, 4 bytes
  c.rstep = CHAIN_THREADS / words;
  c.wd = tid % words;
  c.r = tid / words;
  c.active = c.r < c.rstep;
  return c;
}

// The gate math of one (row, column) element of a step: from the mask m,
// dh_t = dh + dout, h1 (GRU h_prev, LSTM c_prev, RNN h_t), each gate's hp
// and xp (GRU, LSTM) and LSTM's dc carry, the gate cotangents dxv and dhp
// (they differ in GRU's candidate third) and the next dh (and dc) carry.
// Both layouts run it, so both give the same bits.
template <int CELL>
__device__ __forceinline__ void gate_math(float m, float dh_t, float h1, const float* hpv,
                                          const float* xpv, float& dc, float* dxv, float* dhp,
                                          float& dh) {
  constexpr int G = NumGates<CELL>::G;
  const float dh_new = dh_t * m;
  const float dh_direct = dh_t * (1.0f - m);
  if constexpr (CELL == kGRU) {
    const float h_prev = h1;
    const float h_r = hpv[0], h_z = hpv[1], h_n = hpv[2];
    const float rg = sigmoid(xpv[0] + h_r);
    const float zg = sigmoid(xpv[1] + h_z);
    const float ng = tanhf(xpv[2] + rg * h_n);
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
    dh = dh_new * zg + dh_direct;
  } else if constexpr (CELL == kLSTM) {
    const float c_prev = h1;
    const float dc_t = dc;
    float dc_new = dc_t * m;
    const float dc_direct = dc_t * (1.0f - m);
    const float ig = sigmoid(xpv[0] + hpv[0]);
    const float fg = sigmoid(xpv[1] + hpv[1]);
    const float gg = tanhf(xpv[2] + hpv[2]);
    const float og = sigmoid(xpv[3] + hpv[3]);
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
    dc = dc_new * fg + dc_direct;
    dh = dh_direct;
  } else {
    // h_new equals the saved output wherever m == 1, and dh_new is 0
    // wherever m == 0
    const float h_t = h1;
    dxv[0] = dh_new * (1.0f - h_t * h_t);
    dhp[0] = dxv[0];
    dh = dh_direct;
  }
}

// Four neighbouring values of a row (a quad: 16 bytes of f32, 8 of bf16),
// loaded as one word and widened to f32, or rounded and stored as one
template <typename T> struct QuadWord { using type = float4; };
template <> struct QuadWord<__nv_bfloat16> { using type = uint2; };
__device__ __forceinline__ void quad_to_f(const float4& v, float (&o)[4]) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void quad_to_f(const uint2& v, float (&o)[4]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
  o[0] = __low2float(p[0]);
  o[1] = __high2float(p[0]);
  o[2] = __low2float(p[1]);
  o[3] = __high2float(p[1]);
}
template <typename T>
__device__ __forceinline__ void load_quad(const T* p, float (&o)[4]) {
  quad_to_f(__ldg(reinterpret_cast<const typename QuadWord<T>::type*>(p)), o);
}
template <typename T>
__device__ __forceinline__ void store_quad(T* p, const float (&v)[4]) {
  typename QuadWord<T>::type w;
  T* e = reinterpret_cast<T*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = from_f<T>(v[i]);
  *reinterpret_cast<typename QuadWord<T>::type*>(p) = w;
}

// Every index map below is fixed for the whole loop and worked out before
// it: a step spends its instructions on copies and arithmetic, since all of
// the CTA's warps issue through the same four schedulers. CHUNKED (the
// row block exchanged in chunks) is a template argument, so the whole-block
// path compiles as if the chunked one did not exist. WE > 0 is the
// large-batch layout (bf16, W resident, nothing staged; wide_step below),
// WE its gate-math elements a thread. Its sums keep the order of the
// layout it stands in for (db_rows, khalf), so it gives that layout's
// bits. PHASES (the instrumented build only) times the loop's phases.
template <int CELL, typename CT, typename HT, bool CHUNKED, bool STREAM, int WE = 0,
          bool PHASES = false>
__global__ void __launch_bounds__(CHAIN_THREADS, 1) rnn_bwd_chain_kernel(ChainArgs a) {
  constexpr bool WIDE = WE > 0;
  static_assert(WE <= WIDE_EPT_MAX && WE % WIDE_BATCH == 0, "whole batches of a CTA's units");
  constexpr int G = NumGates<CELL>::G;
  constexpr bool kSplit = sizeof(CT) == 4;  // f32 compute: split products
  constexpr int padk = 16 / sizeof(CT);
  constexpr int NT = CHAIN_THREADS;
  cg::cluster_group cluster = cg::this_cluster();
  const int T = a.T, B = a.B, H = a.H, GH = G * H;
  const int R = a.R, hc = a.hc, kp = a.kp, kc = a.kc;
  const int nc = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  const int cl = blockIdx.x / nc;
  const int e = blockIdx.y, dabs = a.dir0 + e;
  const int r0 = cl * R, j0 = q * hc;
  const int own = max(0, min(hc, H - j0));  // hidden columns this CTA owns (a multiple of 4)
  const int nrows = min(R, B - r0);         // rows of the cluster's block that exist
  const int tid = threadIdx.x;
  // chunked: the row block is exchanged xc columns at a time, each chunk
  // pushed, barriered and multiplied in turn (W streamed in the same chunks)
  constexpr bool chunked = CHUNKED;
  constexpr bool resident = !STREAM;  // the launcher's choice: kc >= kp
  const int S = a.S, kw = a.kw;
  const int wstride = (resident ? kc : kw) + padk, dstride = (chunked ? a.xc : kp) + padk;

  const CT* xp = static_cast<const CT*>(a.p.xp[e]);
  const HT* out = static_cast<const HT*>(a.p.out[e]);
  const HT* chist = static_cast<const HT*>(a.p.c[e]);
  const HT* dout = static_cast<const HT*>(a.p.dout[e]);
  CT* dxp = static_cast<CT*>(a.p.dxp[e]);
  CT* dhp_out = static_cast<CT*>(a.p.dhp[e]);
  const CT* w = static_cast<const CT*>(a.w_hh) + (size_t)e * H * GH;
  const float* hp = CELL == kRNN ? nullptr : a.hp + (size_t)e * T * B * GH;

  const ChainSmem L = chain_smem<CELL, CT, HT>(R, hc, kp, kc, a.stages, a.blocks, a.xc, S, kw, nc);
  const bool one_block = a.blocks == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  CT* wbuf = reinterpret_cast<CT*>(smem + L.w);  // resident W, or the ring's stages
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);  // [S], then empty [S]
  uint64_t* empty = full + S;
  CT* dhpb = reinterpret_cast<CT*>(smem + L.dhp);
  CT* ownb = reinterpret_cast<CT*>(smem + L.own);  // chunked: [R][G][hc]
  float* dh_s = reinterpret_cast<float*>(smem + L.dh);
  float* dc_s = reinterpret_cast<float*>(smem + L.dc);
  float* dbacc = reinterpret_cast<float*>(smem + L.db);  // WIDE: after the loop

  // resident: round(W)[j0 + n][k] -> wbuf[n][k] for n < hc, k < kp; zero
  // past the owned columns and past G*H. Copies of 16 bytes where W's rows
  // allow them (G*H a multiple of 8 at bf16), else 8 or 4.
  const int wcw = copy_width(GH * (int)sizeof(CT));
  auto load_w = [&](int k0) {
    const int words = kc * (int)sizeof(CT) / wcw;
#pragma unroll 1
    for (int idx = tid; idx < hc * words; idx += NT) {
      const int n = idx / words, wd = idx % words;
      const int k = k0 + wd * (wcw / (int)sizeof(CT));
      unsigned char* dst = reinterpret_cast<unsigned char*>(wbuf + (size_t)n * wstride) + wd * wcw;
      if (n < own && k < GH)
        cp_async_n(dst, w + (size_t)(j0 + n) * GH + k, wcw);
      else if (wcw == 16)
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      else if (wcw == 8)
        *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
      else
        *reinterpret_cast<uint32_t*>(dst) = 0u;
    }
    cp_async_commit();
  };

  // staging: hp and xp per gate (GRU, LSTM), h1 (GRU h_prev, LSTM c_prev,
  // RNN h_t), dout and the mask of one step, for the block's rows and the
  // CTA's columns; copies of 16 bytes on the main path
  const RowCopy c_hp = row_copy(own * 4, (GH | H | j0 | hc) * 4, tid);
  const RowCopy c_xp = row_copy(own * (int)sizeof(CT), (GH | H | j0 | hc) * (int)sizeof(CT), tid);
  const RowCopy c_h = row_copy(own * (int)sizeof(HT), (H | j0 | hc) * (int)sizeof(HT), tid);
  auto copy_rows = [&](const RowCopy& m, unsigned char* dst, const void* src, int ld_bytes,
                       int dst_row_bytes) {
    if (m.active)
#pragma unroll 1
      for (int r = m.r; r < nrows; r += m.rstep)
        cp_async_n(dst + r * dst_row_bytes + m.wd * m.width,
                   static_cast<const unsigned char*>(src) + (size_t)r * ld_bytes + m.wd * m.width,
                   m.width);
  };
  auto issue = [&](int step, int buf) {
    const int t = dabs == 0 ? T - 1 - step : step;
    const int tp = dabs == 0 ? t - 1 : t + 1;
    unsigned char* st = smem + L.stage + (size_t)buf * L.st_size;
    const size_t row0 = (size_t)t * B + r0;  // the block's first row at time t
    constexpr int hsz = sizeof(HT);
    if constexpr (CELL != kRNN) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        copy_rows(c_hp, st + L.st_hp + (size_t)g * R * hc * 4, hp + row0 * GH + g * H + j0,
                  GH * 4, hc * 4);
        copy_rows(c_xp, st + L.st_xp + (size_t)g * R * hc * sizeof(CT),
                  xp + row0 * GH + g * H + j0, GH * (int)sizeof(CT), hc * (int)sizeof(CT));
      }
      if (step != T - 1)  // h_prev / c_prev: zero at the first position
        copy_rows(c_h, st + L.st_h1, (CELL == kGRU ? out : chist) + ((size_t)tp * B + r0) * H + j0,
                  H * hsz, hc * hsz);
    } else {
      copy_rows(c_h, st + L.st_h1, out + row0 * H + j0, H * hsz, hc * hsz);
    }
    copy_rows(c_h, st + L.st_do, dout + row0 * H + j0, H * hsz, hc * hsz);
    if (tid < nrows) cp_async4(st + L.st_m + tid * 4, a.mask + row0 + tid);
    cp_async_commit();
  };

  // gate math: pairs (row, owned column) tid, tid + NT, ... in row-major order
  const int gm_r = tid / own, gm_c = tid % own, gm_dr = NT / own, gm_dc = NT % own;
  // the large-batch layout's: quads (row, 4 owned columns) tid, tid + NT, ...
  const int wq_r = tid / (own / 4), wq_c = tid % (own / 4) * 4, wq_dr = NT / (own / 4),
            wq_dc = NT % (own / 4) * 4;
  // the push: words of `pw` bytes (16 on the main path; 8 always divide:
  // own and H are multiples of 4, j0 of 8) of the CTA's G column ranges;
  // pu_tpr threads per row, rows pu_r, pu_r + pu_rstep, ...
  const int pw = ((own | H | j0) * (int)sizeof(CT)) % 16 == 0 ? 16 : 8;
  const int pu_words = own * (int)sizeof(CT) / pw, pu_lpr = G * pu_words;
  const int pu_tpr = min(pu_lpr, NT), pu_rstep = NT / pu_tpr;
  const int pu_l = tid % pu_tpr, pu_r = tid / pu_tpr;
  const int nx = chunked ? (kp + a.xc - 1) / a.xc : 1;  // exchange chunks a step
  // chunked: push the CTA's words of columns [x0, x0 + xc) from ownb into
  // chunk buffer `dst` of this CTA and of every peer; the tail past G*H of
  // the last chunk is zeroed locally (it held an earlier chunk's values)
  auto push_chunk = [&](CT* dst, int x0) {
    if (pu_r < pu_rstep) {
#pragma unroll 1
      for (int r = pu_r; r < nrows; r += pu_rstep)
#pragma unroll 1
        for (int l = pu_l; l < pu_lpr; l += pu_tpr) {
          const int g = l / pu_words, wd = l - g * pu_words;
          const int k = g * H + j0 + wd * (pw / (int)sizeof(CT));
          if (k < x0 || k >= x0 + a.xc) continue;
          const unsigned char* src = reinterpret_cast<const unsigned char*>(
              ownb + (size_t)r * G * hc + g * hc) + wd * pw;
          CT* at = dst + (size_t)r * dstride + (k - x0);
          if (pw == 16) {
            const uint4 v = *reinterpret_cast<const uint4*>(src);
#pragma unroll 1
            for (int pr = 0; pr < nc; ++pr) {
              const int peer = q + pr < nc ? q + pr : q + pr - nc;
              *reinterpret_cast<uint4*>(cluster.map_shared_rank(at, peer)) = v;
            }
          } else {
            const uint2 v = *reinterpret_cast<const uint2*>(src);
#pragma unroll 1
            for (int pr = 0; pr < nc; ++pr) {
              const int peer = q + pr < nc ? q + pr : q + pr - nc;
              *reinterpret_cast<uint2*>(cluster.map_shared_rank(at, peer)) = v;
            }
          }
        }
    }
    if (x0 + a.xc > GH) {
      const int c0 = GH - x0, cw = min(kp, x0 + a.xc) - GH;
      for (int i = tid; i < nrows * cw; i += NT)
        dst[(size_t)(i / cw) * dstride + c0 + i % cw] = from_f<CT>(0.0f);
    }
  };

  for (int i = tid; i < R * hc; i += NT) {
    const int r = i / hc, c = i % hc;
    dh_s[i] = (r < nrows && c < own) ? a.d_hfinal[((size_t)e * B + r0 + r) * H + j0 + c] : 0.0f;
    if constexpr (CELL == kLSTM) dc_s[i] = 0.0f;
  }
  if constexpr (!WIDE)
    for (int i = tid; i < G * R * hc; i += NT) dbacc[i] = 0.0f;
  // rows past the batch and columns past G*H stay zero in every block
  const int xld = wide_ld(G, hc);  // the large-batch layout's region rows
  const int blk_elems = WIDE ? nc * R * xld : a.blocks * R * dstride;
  for (int i = tid; i < blk_elems; i += NT) dhpb[i] = from_f<CT>(0.0f);
  // the large-batch layout: each k16 step's offset in the regions, with
  // the next three's (a step lies in one region: H and hc are multiples of
  // 16; column k = g*H + qq*hc + c is region qq's column g*hc + c), and the
  // exchange's mbarrier a part of 32 rows
  int4* koff4 = reinterpret_cast<int4*>(dhpb + blk_elems);
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem + L.bar);
  if constexpr (WIDE) {
    for (int s = tid; s < kp / 16; s += NT) {
      int o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = (s + i) * 16, j = k % H;
        o[i] = k < GH ? j / hc * R * xld + k / H * hc + j % hc : 0;
      }
      koff4[s] = make_int4(o[0], o[1], o[2], o[3]);
    }
    if (tid == 0) {
      for (int p = 0; p < R / 32; ++p) mbar_init(xbar + p, 1);
      mbar_init_fence();
    }
  }
  if constexpr (resident) {
    load_w(0);
  } else if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CHAIN_WARPS);  // every warp releases every piece
    }
    mbar_init_fence();
  }
  if (a.stages == 2) issue(0, 0);
  if constexpr (WIDE) cp_async_wait<0>();  // W (nothing is staged)
  cluster.sync();  // every CTA of the cluster runs, buffers zeroed, before the first push

  // streamed: a step multiplies np pieces of W, kw columns of a kc chunk at
  // a time (ppc to a chunk; the last chunk may hold fewer); the CTA's
  // piece x (of T * np, in the order they are multiplied) is its packed
  // piece x % np, copied into stage x % S (pieces 0..S-2 before the loop,
  // then one a turn, round-robin over the warps). A piece's copy is a
  // whole stage.
  const int ppc = (kc + kw - 1) / kw, nch = (kp + kc - 1) / kc;
  const int np = (nch - 1) * ppc + (kp - (nch - 1) * kc + kw - 1) / kw, total = T * np;
  const size_t stage_elems = (size_t)hc * wstride;
  const CT* wsrc = resident ? nullptr
                            : static_cast<const CT*>(a.wpk) + ((size_t)e * nc + q) * np * stage_elems;
  auto copy_piece = [&](int x, int st, uint64_t* bar) {
    const unsigned bytes = (unsigned)(stage_elems * sizeof(CT));
    mbar_arrive_expect_tx(bar, bytes);
    bulk_copy(wbuf + (size_t)st * stage_elems, wsrc + (size_t)(x % np) * stage_elems, bytes, bar);
  };
  if (!resident && tid == 0)
    for (int x = 0; x < S - 1 && x < total; ++x) copy_piece(x, x, full + x);
  // as piece g begins, one warp copies piece g + S - 1 (its turn in the
  // round), and every warp waits for piece g; each releases it after its
  // last read
  auto piece_begin = [&](int g) -> const CT* {
    ring_turn(g, S, total, CHAIN_WARPS, full, empty, copy_piece);
    mbar_wait(full + g % S, (g / S) & 1);
    return wbuf + (size_t)(g % S) * stage_elems;
  };
  auto piece_end = [&](int g) {
    __syncwarp();
    if (tid % 32 == 0) mbar_arrive(empty + g % S);
  };

  // the large-batch layout: the L2 prefetch of a step's inputs, CTA q
  // taking 1/nc of each of the cluster's contiguous blocks of nrows rows,
  // in 128-byte lines
  auto prefetch_rows = [&](const void* base, size_t row_bytes) {
    const size_t bytes = (size_t)nrows * row_bytes;
    const size_t slice = ((bytes + nc - 1) / nc + 127) / 128 * 128, begin = (size_t)q * slice;
    const size_t end = begin + slice < bytes ? begin + slice : bytes;
#pragma unroll 1
    for (size_t o = begin + (size_t)tid * 128; o < end; o += (size_t)NT * 128)
      prefetch_l2(static_cast<const unsigned char*>(base) + o);
  };
  auto prefetch_step = [&](int step) {
    const int t = dabs == 0 ? T - 1 - step : step;
    const size_t row0 = (size_t)t * B + r0;
    if constexpr (CELL != kRNN) {
      prefetch_rows(hp + row0 * GH, (size_t)GH * 4);
      prefetch_rows(xp + row0 * GH, (size_t)GH * sizeof(CT));
      if (step != T - 1)
        prefetch_rows((CELL == kGRU ? out : chist) + ((size_t)(dabs == 0 ? t - 1 : t + 1) * B + r0) * H,
                      (size_t)H * sizeof(HT));
    } else {
      prefetch_rows(out + row0 * H, (size_t)H * sizeof(HT));
    }
    prefetch_rows(dout + row0 * H, (size_t)H * sizeof(HT));
    if (q == 0 && tid * 32 < nrows) prefetch_l2(a.mask + row0 + tid * 32);
  };
  // the large-batch layout's db partials: element k of this thread's
  // gate math (row and column as gm_r, gm_c walk them), gate g
  float dbr[WIDE ? WE : 1][G];
#pragma unroll
  for (int k = 0; k < (WIDE ? WE : 1); ++k)
#pragma unroll
    for (int g = 0; g < G; ++g) dbr[k][g] = 0.0f;
  if constexpr (WIDE) prefetch_step(0);

  // PHASES: thread 0 adds each phase's clock64() cycles; every phase ends
  // at a block-wide point (a barrier, or one added here), so its view is
  // the CTA's
  long long ph_acc[kPhases], ph_last = 0, ph_t0 = 0;
  unsigned long long ns0 = 0;
  auto stamp = [&](int p) {
    if constexpr (PHASES) {
      if (tid == 0) {
        const long long now = clock64();
        ph_acc[p] += now - ph_last;
        ph_last = now;
      }
    }
  };
  if constexpr (PHASES) {
    for (int p = 0; p < kPhases; ++p) ph_acc[p] = 0;
    ph_t0 = ph_last = clock64();
    ns0 = global_ns();
  }

  const int warp = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  // The large-batch layout's step (WIDE; the kernel's note): the inputs'
  // first quad loaded; every peer done with the last product (so with our
  // copies into it, and our region is free); the gate math into this CTA's
  // region, each quad's math beside the next quad's loads, and as each
  // part of 32 rows is complete, one bulk copy of it to each peer,
  // completing on the peer's mbarrier of that part; then each unit's
  // product once its part is in, the A fragments found region by region,
  // each k16 step into the accumulator it had in the
  // cluster route (k in two halves where that route split it). So the
  // copies of a part fly while the next part's gate math and the first
  // parts' products run.
  auto wide_step = [&](int step, int t, bool first) {
    if constexpr (WIDE) {
      constexpr int NB = WE / WIDE_BATCH;
      const size_t row_t = (size_t)t * B + r0;
      const HT* h1src = CELL == kRNN ? out + row_t * H
                        : (CELL == kGRU ? out : chist) +
                              ((size_t)(first ? t : dabs == 0 ? t - 1 : t + 1) * B + r0) * H;
      CT* mine = dhpb + (size_t)q * R * xld;
      // a batch is one quad (WIDE_BATCH = 4 columns of a row) a thread:
      // quad i = tid + b * NT of the R x own/4 quads, in row-major order
      float ihp[2][4][G], ixp[2][4][G], ih1[2][4], ido[2][4], im[2];
      int ir[2], ic[2];
      int r = wq_r, c = wq_c;
      auto load = [&](int bb) {
        ir[bb] = r;
        ic[bb] = c;
        if (r < nrows) {
          const size_t x0 = (row_t + r) * GH + j0 + c;
          if constexpr (CELL != kRNN) {
#pragma unroll
            for (int g = 0; g < G; ++g) {
              float v[4], x[4];
              load_quad(hp + x0 + (size_t)g * H, v);
              load_quad(xp + x0 + (size_t)g * H, x);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                ihp[bb][e][g] = v[e];
                ixp[bb][e][g] = x[e];
              }
            }
          }
          if (CELL != kRNN && first) {
#pragma unroll
            for (int e = 0; e < 4; ++e) ih1[bb][e] = 0.0f;
          } else {
            load_quad(h1src + (size_t)r * H + j0 + c, ih1[bb]);
          }
          load_quad(dout + (row_t + r) * H + j0 + c, ido[bb]);
          im[bb] = __ldg(a.mask + row_t + r);
        }
        c += wq_dc;
        r += wq_dr;
        if (c >= own) {
          c -= own;
          ++r;
        }
      };
      auto compute = [&](int bb, int k0) {
        const int rr = ir[bb], cc = ic[bb];
        if (rr < nrows) {
          const int j = j0 + cc, sc = rr * hc + cc;
          const size_t tb = row_t + rr;
          float dxv[G][4], dhp[G][4], dhn[4], dc[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float dx1[G], dh1[G];
            dc[e] = CELL == kLSTM ? dc_s[sc + e] : 0.0f;
            gate_math<CELL>(im[bb], dh_s[sc + e] + ido[bb][e], ih1[bb][e], ihp[bb][e], ixp[bb][e],
                            dc[e], dx1, dh1, dhn[e]);
#pragma unroll
            for (int g = 0; g < G; ++g) {
              dxv[g][e] = dx1[g];
              dhp[g][e] = dh1[g];
              dbr[k0 + e][g] += dh1[g];
            }
          }
          *reinterpret_cast<float4*>(dh_s + sc) = make_float4(dhn[0], dhn[1], dhn[2], dhn[3]);
          if constexpr (CELL == kLSTM)
            *reinterpret_cast<float4*>(dc_s + sc) = make_float4(dc[0], dc[1], dc[2], dc[3]);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            store_quad(dxp + tb * GH + g * H + j, dxv[g]);
            if constexpr (CELL == kGRU) store_quad(dhp_out + tb * GH + g * H + j, dhp[g]);
            store_quad(mine + rr * xld + g * hc + cc, dhp[g]);
          }
        }
      };
      // part p: rows [32p, 32p + 32) of the cluster's nrows, on xbar[p]
      const int nparts = (nrows + 31) / 32;
      auto part_bytes = [&](int p) {
        const int rows = min(32, nrows - 32 * p);
        return (unsigned)((rows > 0 ? rows : 0) * xld * sizeof(CT));
      };

      load(0);
      __syncthreads();  // the last product's dh is in
      stamp(kInputs);
      if (step > 0) cluster_wait();
      stamp(kPushWait);
      if (tid == 0)
        for (int p = 0; p < R / 32; ++p) mbar_arrive_expect_tx(xbar + p, (nc - 1) * part_bytes(p));
      int sent = 0;  // parts whose copies are out
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b + 1 < NB) load((b + 1) & 1);
        compute(b & 1, b * WIDE_BATCH);
        // the next step's rows to L2, once this step's first loads are out
        // (ahead of them they held those loads back)
        if (b == 0 && step + 1 < T) prefetch_step(step + 1);
        fence_proxy_async_smem();  // the region's writes, before the copies read them
        __syncthreads();
        stamp(kGate);
        // the rows every thread has finished: their parts go to the peers
        const int done = min(nrows, (b + 1) * NT / (own / 4));
        // a peer's copy from lane 0 of warp pr % CHAIN_WARPS: the warps start
        // them side by side (a warp's lanes started theirs in turn)
        for (; sent < nparts && min(32 * sent + 32, nrows) <= done; ++sent)
          if (lane == 0)
            for (int pr = warp == 0 ? CHAIN_WARPS : warp; pr < nc; pr += CHAIN_WARPS) {
              const int peer = q + pr < nc ? q + pr : q + pr - nc;
              const CT* src = mine + (size_t)32 * sent * xld;
              bulk_copy_to_peer(peer_addr(src, peer), src, part_bytes(sent),
                                peer_addr(xbar + sent, peer));
            }
        stamp(kPush);
      }

      const int ntn = hc / 8, units = (R / 16) * ntn;
      // au[j] += the k16 steps kb + 64m + 16j < ke of the unit's A rows (row
      // offset ro, and the lane's 8 columns of the step) against its W
      // columns at bp, as the resident product below adds them; a k64
      // chunk's four steps' region offsets are one 16-byte read of koff4
      auto ksteps = [&](float (&au)[4][4], int ro, const CT* bp, int kb, int ke) {
        for (int kk = kb; kk < ke; kk += 64) {
          const int4 ko = koff4[kk / 16];
          uint32_t a0[4], a1[4], a2[4], a3[4], b01[4], b23[4];
          ldsm_x4(a0, dhpb + ko.x + ro);
          ldsm_x4(b01, bp + kk);  // B of the k16 steps at kk and kk + 16
          if (kk + 16 < ke) ldsm_x4(a1, dhpb + ko.y + ro);
          if (kk + 32 < ke) {
            ldsm_x4(a2, dhpb + ko.z + ro);
            ldsm_x4(b23, bp + kk + 32);
          }
          if (kk + 48 < ke) ldsm_x4(a3, dhpb + ko.w + ro);
          mma_bf16(au[0], a0[0], a0[1], a0[2], a0[3], b01[0], b01[1]);
          if (kk + 16 < ke) mma_bf16(au[1], a1[0], a1[1], a1[2], a1[3], b01[2], b01[3]);
          if (kk + 32 < ke) mma_bf16(au[2], a2[0], a2[1], a2[2], a2[3], b23[0], b23[1]);
          if (kk + 48 < ke) mma_bf16(au[3], a3[0], a3[1], a3[2], a3[3], b23[2], b23[3]);
        }
      };
#pragma unroll 1
      for (int u = 0; u < UNITS_MAX; ++u) {
        const int slot = warp + u * CHAIN_WARPS;
        if (slot >= units) break;
        const int mt = slot / ntn, nt = slot % ntn, ro = (mt * 16 + lane % 16) * xld + lane / 16 * 8;
        const CT* bp = wbuf + (size_t)(nt * 8 + lane % 8) * wstride + (lane / 8) * 8;
        stamp(kProduct);
        mbar_wait(xbar + mt / 2, step & 1);  // the unit's part is in from every peer
        stamp(kBarrier);
        float au[4][4], first_half[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) au[j][i] = 0.0f;
        ksteps(au, ro, bp, 0, a.khalf ? a.khalf : kp);
        if (a.khalf) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            first_half[i] = (au[0][i] + au[1][i]) + (au[2][i] + au[3][i]);
#pragma unroll
            for (int j = 0; j < 4; ++j) au[j][i] = 0.0f;
          }
          ksteps(au, ro, bp, a.khalf, kp);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rr = mt * 16 + gid + (i >= 2 ? 8 : 0), cc = nt * 8 + tig * 2 + (i & 1);
          float v = (au[0][i] + au[1][i]) + (au[2][i] + au[3][i]);
          if (a.khalf) v = first_half[i] + v;
          if (rr < R && cc < own) dh_s[rr * hc + cc] += v;
        }
      }
      if constexpr (PHASES) __syncthreads();
      stamp(kProduct);
      // this CTA no longer reads the regions (the peers may copy into them):
      // relaxed, since a release would first wait for the step's stores of
      // dxp and dhp to reach memory, which no peer reads
      cluster_arrive_relaxed();
    }
  };

  for (int step = 0; step < T; ++step) {
    const int t = dabs == 0 ? T - 1 - step : step;
    const bool first = step == T - 1;  // the direction's first position
    if constexpr (WIDE) {
      wide_step(step, t, first);
      continue;
    }
    int buf = 0;
    if (a.stages == 2) {
      buf = step & 1;
      if (step + 1 < T) {
        issue(step + 1, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      issue(step, 0);
      cp_async_wait<0>();
    }
    __syncthreads();
    stamp(kInputs);
    const unsigned char* st = smem + L.stage + (size_t)buf * L.st_size;
    const float* hp_st = reinterpret_cast<const float*>(st + L.st_hp);
    const CT* xp_st = reinterpret_cast<const CT*>(st + L.st_xp);
    const HT* h1_st = reinterpret_cast<const HT*>(st + L.st_h1);
    const HT* do_st = reinterpret_cast<const HT*>(st + L.st_do);
    const float* m_st = reinterpret_cast<const float*>(st + L.st_m);
    CT* mine = dhpb + (size_t)(one_block ? 0 : step & 1) * R * dstride;  // this step's row block
    const int RH = R * hc;

#pragma unroll 1
    for (int r = gm_r, c = gm_c; r < nrows;) {
      const int j = j0 + c, sc = r * hc + c;
      const size_t tb = (size_t)t * B + r0 + r;
      float hpv[G], xpv[G], dxv[G], dhp[G], dhn;
      if constexpr (CELL != kRNN) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          hpv[g] = hp_st[g * RH + sc];
          xpv[g] = to_f(xp_st[g * RH + sc]);
        }
      }
      const float h1 = CELL != kRNN && first ? 0.0f : to_f(h1_st[sc]);
      float dc = CELL == kLSTM ? dc_s[sc] : 0.0f;
      gate_math<CELL>(m_st[r], dh_s[sc] + to_f(do_st[sc]), h1, hpv, xpv, dc, dxv, dhp, dhn);
      dh_s[sc] = dhn;
      if constexpr (CELL == kLSTM) dc_s[sc] = dc;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        dxp[tb * GH + g * H + j] = from_f<CT>(dxv[g]);
        if constexpr (CELL == kGRU) dhp_out[tb * GH + g * H + j] = from_f<CT>(dhp[g]);
        dbacc[g * RH + sc] += dhp[g];
        if (chunked)
          ownb[(size_t)r * G * hc + g * hc + c] = from_f<CT>(dhp[g]);
        else
          mine[r * dstride + g * H + j] = from_f<CT>(dhp[g]);
      }
      c += gm_dc;
      r += gm_dr;
      if (c >= own) {
        c -= own;
        ++r;
      }
    }
    __syncthreads();
    stamp(kGate);
    // one row block: every peer has finished the last step's product on it
    if (one_block && step > 0) cluster_wait();
    stamp(kPushWait);

    // push this CTA's columns of the row block into every peer's copy: each
    // word is read once and stored to every peer (chunked: in the product)
    if (!chunked && pu_r < pu_rstep) {
      unsigned char* blk = reinterpret_cast<unsigned char*>(mine);
#pragma unroll 1
      for (int r = pu_r; r < nrows; r += pu_rstep)
#pragma unroll 1
        for (int l = pu_l; l < pu_lpr; l += pu_tpr) {
          const int g = l / pu_words, wd = l - g * pu_words;
          unsigned char* src = blk + ((size_t)r * dstride + g * H + j0) * sizeof(CT) + wd * pw;
          if (pw == 16) {
            const uint4 v = *reinterpret_cast<const uint4*>(src);
#pragma unroll 1
            for (int pr = 1; pr < nc; ++pr) {
              const int peer = q + pr < nc ? q + pr : q + pr - nc;
              *reinterpret_cast<uint4*>(cluster.map_shared_rank(src, peer)) = v;
            }
          } else {
            const uint2 v = *reinterpret_cast<const uint2*>(src);
#pragma unroll 1
            for (int pr = 1; pr < nc; ++pr) {
              const int peer = q + pr < nc ? q + pr : q + pr - nc;
              *reinterpret_cast<uint2*>(cluster.map_shared_rank(src, peer)) = v;
            }
          }
        }
    }
    if constexpr (PHASES) __syncthreads();
    stamp(kPush);
    if (!chunked) cluster.sync();  // release the pushes, acquire the peers'
    stamp(kBarrier);

    // the chain: dh[:, own] += round(dhp)[R, kp] . round(W)^T[kp, own]; the
    // A operand from the row block at column k0 (chunked: chunk buffer
    // step * nx + x alternating, its column 0)
    auto a_block = [&](int k0, int& aoff) -> CT* {
      if (!chunked) {
        aoff = k0;
        return mine;
      }
      const int x = k0 / a.xc;
      CT* buf = dhpb + (size_t)((step * nx + x) & 1) * R * dstride;
      push_chunk(buf, k0);
      cluster.sync();  // release this chunk's pushes, acquire the peers'
      aoff = 0;
      return buf;
    };
    {
      // (16 x 8) output tiles, one warp each (f32 at 8 rows: the tile's
      // rows 8-15 absent); with fewer tiles than half the warps (and W
      // resident), two warps share a tile, each taking half of k: the second
      // half's sums pass through this step's staging buffer (read by now) and
      // are added in a fixed order. f32: each k16 step's fragments split in
      // registers, six products (recur_chain.cuh mma_split).
      const int ntn = hc / 8, units = ((R + 15) / 16) * ntn;
      const bool halves = resident && 2 * units <= CHAIN_WARPS;
      const int khalf = (kp / 16 + 1) / 2 * 16;
      const bool half = R < 16;
      float acc[UNITS_MAX][4][4];  // four accumulators: four k16 steps in flight
#pragma unroll
      for (int u = 0; u < UNITS_MAX; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[u][j][i] = 0.0f;
      // f32: acc[u][j] += the k16 steps of columns [k0, k1) of the row block
      // at ap (its column 0) times W's at bp, step k going to accumulator
      // ((k - kz) / 16) % 4
      auto split_steps = [&](float (&au)[4][4], const CT* ap, const CT* bp, int k0, int k1,
                             int kz) {
        const float* a32 = reinterpret_cast<const float*>(ap);
        const float* b32 = reinterpret_cast<const float*>(bp);
#pragma unroll 2
        for (int kk = k0; kk < k1; kk += 16) {
          uint32_t af[PIECES][4], bf[PIECES][2];
          a_frag_f32(a32 + kk, dstride, half, af);
          b_frag_f32_nk(b32 + kk, wstride, bf);
          mma_split(au[((kk - kz) >> 4) & 3], af, bf);
        }
      };
      if constexpr (resident) {
        int aoff;
        const CT* ablk = a_block(0, aoff);
#pragma unroll
        for (int u = 0; u < UNITS_MAX; ++u) {
          const int slot = warp + u * CHAIN_WARPS;
          const int unit = halves ? slot % units : slot;
          const bool second = halves && slot >= units;
          if (slot < (halves ? 2 * units : units)) {
            const int mt = unit / ntn, nt = unit % ntn;
            const int kb = second ? khalf : 0, ke = halves && !second ? khalf : kp;
            if constexpr (kSplit) {
              split_steps(acc[u], ablk + (size_t)mt * 16 * dstride + aoff,
                          wbuf + (size_t)nt * 8 * wstride, kb, ke, kb);
              continue;
            }
            // ldmatrix rows: A's 16 rows by two k halves, B's 8 rows (n) by four k quarters
            const CT* ap = ablk + (size_t)(mt * 16 + lane % 16) * dstride + aoff + (lane / 16) * 8;
            const CT* bp = wbuf + (size_t)(nt * 8 + lane % 8) * wstride + (lane / 8) * 8;
            for (int kk = kb; kk < ke; kk += 64) {
              uint32_t a0[4], a1[4], a2[4], a3[4], b01[4], b23[4];
              ldsm_x4(a0, ap + kk);
              ldsm_x4(b01, bp + kk);  // B of the k16 steps at kk and kk + 16
              if (kk + 16 < ke) ldsm_x4(a1, ap + kk + 16);
              if (kk + 32 < ke) {
                ldsm_x4(a2, ap + kk + 32);
                ldsm_x4(b23, bp + kk + 32);
              }
              if (kk + 48 < ke) ldsm_x4(a3, ap + kk + 48);
              mma_bf16(acc[u][0], a0[0], a0[1], a0[2], a0[3], b01[0], b01[1]);
              if (kk + 16 < ke) mma_bf16(acc[u][1], a1[0], a1[1], a1[2], a1[3], b01[2], b01[3]);
              if (kk + 32 < ke) mma_bf16(acc[u][2], a2[0], a2[1], a2[2], a2[3], b23[0], b23[1]);
              if (kk + 48 < ke) mma_bf16(acc[u][3], a3[0], a3[1], a3[2], a3[3], b23[2], b23[3]);
            }
          }
        }
      } else {
        // W streamed in pieces: the k16 step at chunk offset 64m + 16j goes
        // to accumulator j, as it would with the whole chunk at once (a
        // piece starts on a multiple of 32 at bf16: accumulators 0 and 1,
        // or 2 and 3)
        int g = step * np;
        for (int k0 = 0; k0 < kp; k0 += kc) {
          const int klen = min(kc, kp - k0);
          int aoff;
          const CT* ablk = a_block(k0, aoff);
#pragma unroll 1
          for (int p0 = 0; p0 < klen; p0 += kw, ++g) {
            const int plen = min(kw, klen - p0);
            const CT* wk = piece_begin(g);
#pragma unroll
            for (int u = 0; u < UNITS_MAX; ++u) {
              const int slot = warp + u * CHAIN_WARPS;
              if (slot < units) {
                const int mt = slot / ntn, nt = slot % ntn;
                if constexpr (kSplit) {
                  // the piece's column 0 is the chunk's column p0
                  split_steps(acc[u], ablk + (size_t)mt * 16 * dstride + aoff + p0,
                              wk + (size_t)nt * 8 * wstride, 0, plen, -p0);
                  continue;
                }
                const CT* ap =
                    ablk + (size_t)(mt * 16 + lane % 16) * dstride + aoff + p0 + (lane / 16) * 8;
                const CT* bp = wk + (size_t)(nt * 8 + lane % 8) * wstride + (lane / 8) * 8;
#pragma unroll 2
                for (int kk = 0; kk < plen; kk += 32) {
                  uint32_t a0[4], a1[4], b[4];  // b: B of the k16 steps at kk and kk + 16
                  const bool two = kk + 16 < plen;
                  ldsm_x4(a0, ap + kk);
                  ldsm_x4(b, bp + kk);
                  if (two) ldsm_x4(a1, ap + kk + 16);
                  if (((p0 + kk) & 32) == 0) {
                    mma_bf16(acc[u][0], a0[0], a0[1], a0[2], a0[3], b[0], b[1]);
                    if (two) mma_bf16(acc[u][1], a1[0], a1[1], a1[2], a1[3], b[2], b[3]);
                  } else {
                    mma_bf16(acc[u][2], a0[0], a0[1], a0[2], a0[3], b[0], b[1]);
                    if (two) mma_bf16(acc[u][3], a1[0], a1[1], a1[2], a1[3], b[2], b[3]);
                  }
                }
              }
            }
            piece_end(g);
          }
        }
      }
      float* xpart = reinterpret_cast<float*>(smem + L.stage + (size_t)buf * L.st_size);
#pragma unroll
      for (int u = 0; u < UNITS_MAX; ++u) {
        const int slot = warp + u * CHAIN_WARPS;
        const int unit = halves ? slot % units : slot;
        if (halves && slot >= units && slot < 2 * units) {
          const int mt = unit / ntn, nt = unit % ntn;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = mt * 16 + gid + (i >= 2 ? 8 : 0), c = nt * 8 + tig * 2 + (i & 1);
            if (r < R)
              xpart[r * hc + c] = (acc[u][0][i] + acc[u][1][i]) + (acc[u][2][i] + acc[u][3][i]);
          }
        }
      }
      if (halves) __syncthreads();
#pragma unroll
      for (int u = 0; u < UNITS_MAX; ++u) {
        const int slot = warp + u * CHAIN_WARPS;
        if (slot < units) {
          const int mt = slot / ntn, nt = slot % ntn;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = mt * 16 + gid + (i >= 2 ? 8 : 0), c = nt * 8 + tig * 2 + (i & 1);
            if (r >= R) continue;
            float v = (acc[u][0][i] + acc[u][1][i]) + (acc[u][2][i] + acc[u][3][i]);
            if (halves) v += xpart[r * hc + c];
            if (c < own) dh_s[r * hc + c] += v;
          }
        }
      }
      if (halves) __syncthreads();  // the next step's copies overwrite the staging buffer
    }
    if constexpr (PHASES) __syncthreads();
    stamp(kProduct);
    if (one_block) cluster_arrive();  // this CTA no longer reads its row block
  }
  if constexpr (PHASES) {
    if (tid == 0) {
      long long* o = a.phases + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * PHASE_WORDS;
      for (int p = 0; p < kPhases; ++p) o[p] = ph_acc[p];
      o[kPhases] = clock64() - ph_t0;
      o[kPhases + 1] = (long long)(global_ns() - ns0);
    }
  }
  if (one_block) cluster_wait();  // no peer pushes into this CTA any more

  if (!a.split) {  // db partials of db_rows rows each, each summed over r in order
    __syncthreads();
    if constexpr (WIDE) {
      // the registers' partials through [G][R][hc] over W and the row block
      float* dbs = reinterpret_cast<float*>(smem);
      int r = wq_r, c = wq_c;
#pragma unroll
      for (int b = 0; b < WE / 4; ++b) {
        if (r < R)
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int g = 0; g < G; ++g) dbs[(g * R + r) * hc + c + e] = dbr[4 * b + e][g];
        c += wq_dc;
        r += wq_dr;
        if (c >= own) {
          c -= own;
          ++r;
        }
      }
      __syncthreads();
      dbacc = dbs;
    }
    const int dr = WIDE ? a.db_rows : R, groups = R / dr, parts = (B + dr - 1) / dr;
    for (int idx = tid; idx < groups * G * own; idx += CHAIN_THREADS) {
      const int gi = idx / (G * own), g = idx % (G * own) / own, c = idx % own;
      const int part = cl * groups + gi;
      if (part >= parts) continue;
      float s = 0.0f;
      for (int r = 0; r < dr; ++r) s += dbacc[(g * R + gi * dr + r) * hc + c];
      a.db_part[((size_t)e * parts + part) * GH + g * H + j0 + c] = s;
    }
  }
}

// dw[e][i] = sum over slices s (in order) of part[e][s][i]; db[e][k] = sum
// over the db partials (in order: a cluster's, or each db_rows rows' of the
// large-batch layout) of db_part[e][cl][k].
__global__ void rnn_bwd_reduce_kernel(int D, int nsplit, int ncl, int nw, int nb,
                                      const float* __restrict__ part,
                                      const float* __restrict__ db_part, float* __restrict__ dw,
                                      float* __restrict__ db) {
  const int total = D * (nw + nb);
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += gridDim.x * blockDim.x) {
    if (idx < D * nw) {
      const int e = idx / nw, i = idx % nw;
      const float* src = part + (size_t)e * nsplit * nw + i;
      float s = 0.0f;
      for (int k = 0; k < nsplit; ++k) s += src[(size_t)k * nw];
      dw[idx] = s;
    } else {
      const int k = idx - D * nw;
      const int e = k / nb, i = k % nb;
      const float* src = db_part + (size_t)e * ncl * nb + i;
      float s = 0.0f;
      for (int c = 0; c < ncl; ++c) s += src[(size_t)c * nb];
      db[k] = s;
    }
  }
}

// W [D][H][G*H] -> the streamed chain's packed W [D][nc][np][hc][kw + pad]:
// piece i (chunk c = i / ppc, its pp = i % ppc-th piece of kw columns) of
// CTA q holds round(W)[q*hc + n][c*kc + pp*kw + k] at row n, column k, and
// zeros past the piece, past G*H, past the CTA's own rows and in the
// padding, so that each piece is one contiguous copy.
struct PackArgs {
  int H, GH, nc, hc, kc, kp, kw, ppc, np, wstride, D;
  const void* w;
  void* wpk;
};

template <typename CT>
__global__ void rnn_bwd_pack_w(PackArgs p) {
  const size_t total = (size_t)p.D * p.nc * p.np * p.hc * p.wstride;
  const CT* w = static_cast<const CT*>(p.w);
  CT* dst = static_cast<CT*>(p.wpk);
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    size_t r = idx / p.wstride;
    const int k = (int)(idx - r * p.wstride);
    const int n = (int)(r % p.hc);
    r /= p.hc;
    const int i = (int)(r % p.np);
    r /= p.np;
    const int q = (int)(r % p.nc), e = (int)(r / p.nc);
    const int c = i / p.ppc, pp = i % p.ppc;
    const int klen = min(p.kc, p.kp - c * p.kc), plen = min(p.kw, klen - pp * p.kw);
    const int col = c * p.kc + pp * p.kw + k, j = q * p.hc + n;
    const bool ok = k < plen && col < p.GH && n < p.hc && j < p.H;
    dst[idx] = ok ? w[((size_t)e * p.H + j) * p.GH + col] : from_f<CT>(0.0f);
  }
}

struct Plan {
  int nc, R, hc, kc, stages, blocks, nsplit, xc, S, kw;
  int wide, db_rows, khalf;  // the large-batch layout and the order of its sums
};

template <int CELL, typename CT>
bool plan_ok(const Plan& pl, int H, int kp) {
  if (pl.nc < 1 || pl.nc > 16 || pl.hc < 8 || pl.hc % 8 || pl.nc * pl.hc < H ||
      (pl.nc - 1) * pl.hc >= H || pl.R < 8 || pl.R % 8 || pl.kc < 16 || pl.kc % 16 ||
      pl.stages < 0 || pl.stages > 2 || (pl.blocks != 1 && pl.blocks != 2) || pl.nsplit < 1 ||
      pl.xc < 16 || pl.xc % 16)
    return false;
  // the large-batch layout (and only it stages nothing): bf16, H and hc
  // multiples of 16 (each k16 step in one region; quads of columns), W
  // resident, the whole row block once, rows in whole db partials of 16 or
  // 32 rows and k split where the layout it stands in for split it
  if (pl.wide)
    return sizeof(CT) == 2 && H % 16 == 0 && pl.hc % 16 == 0 && pl.stages == 0 && pl.kc >= kp &&
           pl.xc >= kp &&
           pl.blocks == 1 &&
           pl.R % 32 == 0 && (pl.db_rows == 16 || pl.db_rows == 32) && pl.R % pl.db_rows == 0 &&
           pl.khalf >= 0 && pl.khalf < kp && pl.khalf % 16 == 0 &&
           (pl.R / 16) * (pl.hc / 8) <= UNITS_MAX * CHAIN_WARPS;
  if (pl.stages == 0 || pl.db_rows != pl.R || pl.khalf) return false;
  // streamed: pieces of kw columns of a kc chunk, whole k32 steps at bf16
  // (or the whole chunk)
  if (pl.kc < kp && (pl.S < 1 || pl.S > 8 || pl.kw < 16 || pl.kw % 16 || pl.kw > pl.kc ||
                     (sizeof(CT) == 2 && pl.kw % 32 && pl.kw != pl.kc)))
    return false;
  // chunked exchange: two chunk buffers, W streamed in the same chunks
  if (pl.xc < kp && (pl.blocks != 2 || pl.kc != pl.xc)) return false;
  // whole m16 tiles of rows (f32 also 8 rows, half a tile)
  const bool rows = pl.R % 16 == 0 || (sizeof(CT) == 4 && pl.R == 8);
  return rows && ((pl.R + 15) / 16) * (pl.hc / 8) <= UNITS_MAX * CHAIN_WARPS;
}

// bf16 elements of the split products' workspace (f32 compute): the
// pieces of the history [D][3][T*B*H], of W_hh [D][3][H*G*H] (GRU, LSTM:
// the gate recompute) and, for the weight gradient, of its dhp
// [D][3][T*B*G*H]
size_t split_elems(int cell, int T, int B, int H, int D, int split) {
  const int G = cell == kGRU ? 3 : cell == kLSTM ? 4 : 1;
  const size_t TB = (size_t)T * B, GH = (size_t)G * H;
  return 3 * (size_t)D * (TB * H + (cell != kRNN ? H * GH : 0) + (split ? 0 : TB * GH));
}

// the chain kernel a plan runs (PH: the instrumented one)
// (we: the large-batch layout's elements a thread, else 0)
template <int CELL, typename CT, typename HT, bool PH>
auto pick_chain(bool chunked, bool streamed, int we) {
  if (chunked) return rnn_bwd_chain_kernel<CELL, CT, HT, true, true, 0, PH>;
  if (streamed) return rnn_bwd_chain_kernel<CELL, CT, HT, false, true, 0, PH>;
  if constexpr (sizeof(CT) == 2) {
    if (we == 8) return rnn_bwd_chain_kernel<CELL, CT, HT, false, false, 8, PH>;
    if (we == 12) return rnn_bwd_chain_kernel<CELL, CT, HT, false, false, 12, PH>;
    if (we == 16) return rnn_bwd_chain_kernel<CELL, CT, HT, false, false, 16, PH>;
  }
  return rnn_bwd_chain_kernel<CELL, CT, HT, false, false, 0, PH>;
}

// the large-batch layout's gate-math elements a thread at R rows of hc
// columns: R * hc / CHAIN_THREADS rounded up to whole batches, at least 8
__host__ __device__ constexpr int wide_elems(int R, int hc) {
  return (R * hc + CHAIN_THREADS * WIDE_BATCH - 1) / (CHAIN_THREADS * WIDE_BATCH) * WIDE_BATCH < 8
             ? 8
             : (R * hc + CHAIN_THREADS * WIDE_BATCH - 1) / (CHAIN_THREADS * WIDE_BATCH) * WIDE_BATCH;
}

template <int CELL, typename CT, typename HT>
int launch(int T, int B, int H, int D, int dir0, int split, const Plan& pl, const Ptrs& p,
           const float* mask, const void* w_hh, void* wpk, long long wpk_elems,
           const float* b_hh, const float* d_hfinal, float* hp_ws, float* ws_w, float* ws_b,
           float* dw, float* db, void* split_ws, long long split_ws_elems, long long* phases,
           cudaStream_t stream) {
  constexpr bool kSplit = sizeof(CT) == 4;  // f32 compute: split products
  constexpr int P = kSplit ? PIECES : 1;
  constexpr int G = NumGates<CELL>::G;
  const int GH = G * H, kp = (GH + 15) / 16 * 16;
  if (!plan_ok<CELL, CT>(pl, H, kp)) return (int)cudaErrorInvalidValue;
  const int kc = pl.kc < kp ? pl.kc : kp;
  const bool streamed = kc < kp;
  const ChainSmem L = chain_smem<CELL, CT, HT>(pl.R, pl.hc, kp, kc, pl.stages, pl.blocks, pl.xc,
                                               pl.S, pl.kw, pl.nc);
  if (L.total > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int ncl = (B + pl.R - 1) / pl.R;
  const int nparts = (B + pl.db_rows - 1) / pl.db_rows;  // db partials a direction
  cudaError_t err;
  PackArgs pk = {};
  if (streamed) {  // the pieces' count, and the packed W's elements
    const int padk = 16 / (int)sizeof(CT), ppc = (kc + pl.kw - 1) / pl.kw;
    const int nch = (kp + kc - 1) / kc;
    const int np = (nch - 1) * ppc + (kp - (nch - 1) * kc + pl.kw - 1) / pl.kw;
    pk = {H, GH, pl.nc, pl.hc, kc, kp, pl.kw, ppc, np, pl.kw + padk, D, w_hh, wpk};
    if (wpk == nullptr ||
        wpk_elems != (long long)D * pl.nc * np * pl.hc * (pl.kw + padk))
      return (int)cudaErrorInvalidValue;
  }

  // f32: the GEMMs' operands split into their pieces, each once a call
  const size_t TB = (size_t)T * B;
  __nv_bfloat16* ws = static_cast<__nv_bfloat16*>(split_ws);
  __nv_bfloat16* hr_pieces = ws;                                  // [D][3][T*B*H]
  __nv_bfloat16* w_pieces = hr_pieces + 3 * D * TB * H;          // [D][3][H*GH]
  __nv_bfloat16* rhs_pieces = w_pieces + (CELL != kRNN ? 3 * (size_t)D * H * GH : 0);
  if (kSplit) {
    if (ws == nullptr || split_ws_elems != (long long)split_elems(CELL, T, B, H, D, split))
      return (int)cudaErrorInvalidValue;
    for (int e = 0; e < D; ++e) {
      if ((err = split_pieces(p.hr[e], TB * H, hr_pieces + 3 * e * TB * H, stream)) != cudaSuccess)
        return (int)err;
      if (CELL != kRNN &&
          (err = split_pieces(static_cast<const float*>(w_hh) + (size_t)e * H * GH, (size_t)H * GH,
                         w_pieces + 3 * e * (size_t)H * GH, stream)) != cudaSuccess)
        return (int)err;
    }
  }

  GemmArgs g = {};
  g.T = T;
  g.B = B;
  g.H = H;
  g.GH = GH;
  g.dir0 = dir0;
  for (int e = 0; e < 2; ++e)
    g.hr[e] = kSplit ? (e < D ? hr_pieces + 3 * e * TB * H : nullptr) : p.hr[e];
  g.hr_plane = kSplit ? TB * H : 0;
  if (CELL != kRNN) {  // the gate recompute, all T*B rows at once
    g.nsplit = 1;
    g.klen = H;
    for (int e = 0; e < D; ++e)
      g.rhs[e] = kSplit ? static_cast<const void*>(w_pieces + 3 * e * (size_t)H * GH)
                        : static_cast<const void*>(static_cast<const CT*>(w_hh) + (size_t)e * H * GH);
    g.rhs_plane = kSplit ? (size_t)H * GH : 0;
    g.bias = b_hh;
    g.c = hp_ws;
    if ((err = gemm<0, P>(g, D, stream)) != cudaSuccess) return (int)err;
  }

  ChainArgs c = {};
  c.T = T;
  c.B = B;
  c.H = H;
  c.dir0 = dir0;
  c.split = split;
  c.R = pl.R;
  c.hc = pl.hc;
  c.kp = kp;
  c.kc = kc;
  c.stages = pl.stages;
  c.blocks = pl.blocks;
  c.xc = pl.xc < kp ? pl.xc : kp;
  c.S = pl.S;
  c.kw = pl.kw;
  c.p = p;
  c.mask = mask;
  c.w_hh = w_hh;
  c.wpk = wpk;
  c.hp = hp_ws;
  c.d_hfinal = d_hfinal;
  c.db_part = ws_b;
  c.db_rows = pl.db_rows;
  c.khalf = pl.khalf;
  c.phases = phases;
  const int we = pl.wide ? wide_elems(pl.R, pl.hc) : 0;
  auto kernel = pick_chain<CELL, CT, HT, false>(pl.xc < kp, streamed, we);
  if (phases != nullptr) {
#ifdef RNN_BWD_PHASES
    kernel = pick_chain<CELL, CT, HT, true>(pl.xc < kp, streamed, we);
#else
    return (int)cudaErrorInvalidValue;  // only the instrumented build times phases
#endif
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  if (pl.nc > 8 &&  // clusters of more than 8 CTAs are not portable: allowed per kernel
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.nc * ncl, D, 1);
  cfg.blockDim = dim3(CHAIN_THREADS, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (streamed) {  // W packed piece by piece, one pass
    const long long grid = wpk_elems / 256 + 1;
    rnn_bwd_pack_w<CT><<<(int)(grid < 4096 ? grid : 4096), 256, 0, stream>>>(pk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if ((err = cudaLaunchKernelEx(&cfg, kernel, c)) != cudaSuccess) return (int)err;
  if ((err = cudaGetLastError()) != cudaSuccess || split) return (int)err;

  // the weight gradient over T*B rows in nsplit slices, then the fixed-order sums
  g.nsplit = pl.nsplit;
  g.klen = ((T * B + pl.nsplit - 1) / pl.nsplit + KSLICE - 1) / KSLICE * KSLICE;
  for (int e = 0; e < D; ++e) {
    const void* rhs = CELL == kGRU ? p.dhp[e] : p.dxp[e];
    if (kSplit) {
      __nv_bfloat16* pieces = rhs_pieces + 3 * e * TB * GH;
      if ((err = split_pieces(rhs, TB * GH, pieces, stream)) != cudaSuccess) return (int)err;
      rhs = pieces;
    }
    g.rhs[e] = rhs;
  }
  g.rhs_plane = kSplit ? TB * GH : 0;
  g.bias = nullptr;
  g.c = ws_w;
  if ((err = gemm<1, P>(g, D, stream)) != cudaSuccess) return (int)err;
  const int nw = H * GH, nb = GH;
  const int total = D * (nw + nb);
  int blocks = (total + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  rnn_bwd_reduce_kernel<<<blocks, 256, 0, stream>>>(D, pl.nsplit, nparts, nw, nb, ws_w, ws_b,
                                                     dw, db);
  return (int)cudaGetLastError();
}

// Op<CELL, CT, HT>::run(args...) for the cell and the (CT, HT) pair the flags name
template <template <int, typename, typename> class Op, typename... Args>
int dispatch(int cell, int cdt_bf16, int hist_bf16, Args... args) {
  if (cell == kGRU) {
    if (!cdt_bf16) return Op<kGRU, float, float>::run(args...);
    if (hist_bf16) return Op<kGRU, __nv_bfloat16, __nv_bfloat16>::run(args...);
    return Op<kGRU, __nv_bfloat16, float>::run(args...);
  }
  if (cell == kLSTM) {
    if (!cdt_bf16) return Op<kLSTM, float, float>::run(args...);
    if (hist_bf16) return Op<kLSTM, __nv_bfloat16, __nv_bfloat16>::run(args...);
    return Op<kLSTM, __nv_bfloat16, float>::run(args...);
  }
  if (!cdt_bf16) return Op<kRNN, float, float>::run(args...);
  if (hist_bf16) return Op<kRNN, __nv_bfloat16, __nv_bfloat16>::run(args...);
  return Op<kRNN, __nv_bfloat16, float>::run(args...);
}

template <int CELL, typename CT, typename HT>
struct Launch {
  template <typename... Args>
  static int run(Args... args) { return launch<CELL, CT, HT>(args...); }
};

// the clusters of nc CTAs the card holds at once (the whole-SM bound all
// the plans' layouts share)
template <int CELL, typename CT, typename HT>
struct Slots {
  static int run(int nc, int* out) {
    return cluster_slots(rnn_bwd_chain_kernel<CELL, CT, HT, false, false>, nc, CHAIN_THREADS,
                         out);
  }
};

}  // namespace

extern "C" {

// cell: 0 RNN, 1 GRU, 2 LSTM. cdt_bf16: xp, W_hh, dxp and dhp are bf16
// (else f32). hist_bf16: the history and the cotangents are bf16 (only
// with cdt_bf16). dir0: absolute direction of entry 0. The plan (from
// ops/rnn_scan.py bwd_plan): nc CTAs per cluster of hc hidden columns
// each, rows batch rows per cluster, W rows streamed in chunks of kc
// columns (kc >= G*H: resident) through a ring of wstages stages of kw
// columns each, 1 or 2 staging buffers, 2 or 1 dhp row blocks, nsplit
// slices of the weight-gradient product. wpk: where W streams, scratch of
// wpk_elems elements of the compute dtype for the packed W (bwd_plan's
// layout; the launcher checks the count), else null. hr0, hr1: the history in the compute dtype
// (the history itself when it is in that dtype already), the products'
// operand. hp_ws: [D, T*B, G*H] f32 (GRU, LSTM). dhp0, dhp1: GRU's dhp
// [T, B, G*H] in the compute dtype, in both modes (an output in split
// mode, the weight-gradient product's operand otherwise).
// split: 0 also computes dw [D, H, G*H] and db [D, G*H] through ws_w
// [D, nsplit, H, G*H] and ws_b [D, ceil(B/rows), G*H] f32; 1 touches
// neither. split_ws: at f32 compute, scratch of split_ws_elems bf16
// elements for the GEMMs' operands in pieces (rnn_bwd_split_elems; the
// launcher checks the count), else null. Per-direction pointers the call does not use may be null. xc:
// the columns of the dhp row block exchanged at a time (>= G*H: all; else
// in chunks, with kc == xc and two blocks). nc > 8 asks for clusters of
// more than 8 CTAs, which the launch allows. wide: the large-batch layout
// (bf16, W resident, stages 0, one row block), whose db partials each sum
// db_rows rows (ws_b [D, ceil(B/db_rows), G*H]; else db_rows == rows) and
// whose product sums k below khalf and from it apart (0: not split), the
// order of the layout it stands in for. phases: null, or (only in a build
// with -DRNN_BWD_PHASES) [D][nc * clusters][PHASE_WORDS] int64 for the
// chain's phase times. device: the CUDA ordinal the tensors live on.
// Returns cudaGetLastError() after the launches (0 on success).
int rnn_bwd_launch(int device, int cell, int cdt_bf16, int hist_bf16, int split, int T, int B,
                   int H, int D, int dir0, int nc, int rows, int hc, int kc, int stages,
                   int blocks, int nsplit, int xc, int wstages, int kw, int wide, int db_rows,
                   int khalf, const void* xp0,
                   const void* xp1, const float* mask,
                   const void* out0, const void* out1, const void* hr0, const void* hr1,
                   const void* c0, const void* c1,
                   const void* dout0, const void* dout1, const void* w_hh, void* wpk,
                   long long wpk_elems, const float* b_hh,
                   const float* d_hfinal, void* dxp0, void* dxp1, void* dhp0, void* dhp1,
                   float* hp_ws, float* ws_w, float* ws_b, float* dw, float* db,
                   void* split_ws, long long split_ws_elems, long long* phases, void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (H % 4 != 0 || D < 1 || D > 2 || dir0 < 0 || dir0 + D > 2 || cell < 0 || cell > 2)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const Ptrs p = {{xp0, xp1}, {out0, out1}, {hr0, hr1}, {c0, c1}, {dout0, dout1}, {dxp0, dxp1},
                  {dhp0, dhp1}};
  const Plan pl = {nc, rows, hc, kc, stages, blocks, nsplit, xc, wstages, kw, wide, db_rows, khalf};
  return dispatch<Launch>(cell, cdt_bf16, hist_bf16, T, B, H, D, dir0, split, pl, p, mask, w_hh,
                          wpk, wpk_elems, b_hh, d_hfinal, hp_ws, ws_w, ws_b, dw, db,
                          split_ws, split_ws_elems, phases, static_cast<cudaStream_t>(stream));
}

// How many clusters of nc chain CTAs (one a whole SM's shared memory) the
// card holds at once (cudaOccupancyMaxActiveClusters), into *out; the plans
// never launch a cluster size the card holds none of. Returns the CUDA error.
int rnn_bwd_cluster_slots(int device, int cell, int cdt_bf16, int hist_bf16, int nc, int* out) {
  if (cell < 0 || cell > 2 || nc < 1 || nc > 16) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  return dispatch<Slots>(cell, cdt_bf16, hist_bf16, nc, out);
}

// the bf16 elements of split_ws a call at f32 compute needs
long long rnn_bwd_split_elems(int cell, int T, int B, int H, int D, int split) {
  return (long long)split_elems(cell, T, B, H, D, split);
}

const char* rnn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
