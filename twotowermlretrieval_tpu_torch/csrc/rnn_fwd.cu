// Masked recurrent time loop (GRU / LSTM / RNN), forward, for all
// directions of one layer in one launch.
//
// Replaces: twotowermlretrieval_tpu/ops/rnn_scan.py _fwd_kernel (called
// through rnn_layer_fwd). Same contract: per-direction input projections
// xp [T, B, G*H] in original time order (already in the compute dtype CT),
// a [T, B] f32 mask, W_hh [D, H, G*H] in CT, b_hh [D, G*H] f32. Per step
// and direction: hp = round_ct(h) . W_hh + b_hh (f32 accumulation), gates
// in torch order (GRU r,z,n; LSTM i,f,g,o; RNN tanh), then the masked
// update h = m*h_new + (1-m)*h. Direction 1 walks time T-1-i, so nobody
// makes flipped copies. Outputs: the state history per direction
// [T, B, H] (HT: f32, or the compute dtype), the LSTM cell history, and
// h_final [D, B, H] f32. H is a multiple of 8 here: the wrapper
// (ops/rnn_scan.py) zero-pads other widths, which changes no real unit.
//
// What bounds it on Hopper: the chain. Step t's product needs all of step
// t-1's h, so T dependent steps each pay a product, the gate math, an
// exchange of h between SMs and a barrier; at the main path's shapes the
// call moves 20-160 us worth of bytes while T = 128 steps of even a few
// microseconds cost far more. Per-step latency sets the time, so the
// design keeps one step short and takes everything else off it:
//
// One thread-block cluster of NC CTAs (launched with the cluster
// attribute; NC <= 8, the portable size, or up to 16 where 8 CTAs would
// hold more columns than fit or stream W that 16 split further, allowed
// per kernel and only where the card holds such clusters) walks all T
// steps for R batch rows of one direction. CTA q
// owns HC hidden columns j in [q*HC, (q+1)*HC) and their G gate columns
// g*H + j. It keeps round(W_hh)[:, own] resident in shared memory for all
// T steps, stored [k][g*HC + c] (k-major, read as mma.sync's col-major B
// operand through ldmatrix.trans): at H=256 bf16 and HC=32, 53 KB. Every
// CTA holds the whole rounded h row block [R][H] twice (double-buffered).
// One step:
//   1. Each thread loads its own elements of this step's xp and mask into
//      registers (the next step's rows of xp are prefetched to L2 one step
//      ahead, so the loads overlap the product and hit L2).
//   2. hp[R, G*own] = round(h)[R, H] . round(W)[H, G*own] on the tensor
//      cores (ldmatrix + mma.sync m16n8k16 bf16, f32 accumulation). A warp
//      owns units of 16 rows x 8 columns with all G gates of them, so the
//      gate pre-activations of an element sit in one thread's registers.
//   3. The gate math in registers, with the f32 h carry (and LSTM's c) of
//      the thread's elements kept in registers for all T steps; the history
//      (and cell history) written to global memory.
//   4. The rounded h of the unit goes to the CTA's next row block; after a
//      __syncwarp the warp pushes its unit's 16-byte rows into every
//      peer's copy through distributed shared memory (with a bf16 history,
//      the same 16-byte words are the history's).
//   5. One cluster barrier (release/acquire). The row blocks alternate, so
//      a peer's push for step t+1 cannot land on a block still being read
//      at step t.
// No block-wide barrier on the resident path: everything but the cluster
// barrier is warp-local. Every index map is worked out before the loop.
// f32 compute (the JAX kernel's Precision.HIGHEST) runs the same units on
// the same tensor cores as split products (recur_chain.cuh), six
// mma.sync products a gate and k16 step, smallest first. W is split once
// a call into its three bf16 pieces, held as three planes (WP: split as
// it is loaded where resident, by rnn_fwd_pack_w_split where it streams,
// in stages of any multiple of 16 rows) and read by ldmatrix like bf16 W;
// where the planes do not keep the layout (f32 W resident where they
// would stream, or in stages of 32 rows or more where theirs would hold
// 16, and the widest layers, where two stages of 16 rows of planes do not
// fit beside the f32 h row block), W stays f32 and each k16 step's B
// fragment is split in registers. Both forms form the same
// products in the same order: the same bits. The planes cost 6 bytes a
// value against f32's 4, yet ran 1.02-1.42x faster in every layout timed
// on an H100 (PERF.md section 6): the step is bound by the splits'
// instructions, not W's bytes.
// The h row block stays f32, each k16 step's A fragment split in
// registers (a unit on the rows of the warp's unit before it takes that
// one's): three bf16 planes of it, split once by the thread that writes
// h, would take 6 bytes a value, and at H=1024 and 32 rows one such
// block is 197 KB. A unit's rows are 16, or 8 at f32 where a CTA holds no
// more (the m16 tile's rows 8-15 then zeros, never read); a row of h is
// pushed as two 16-byte words, and at f32 a step's xp is read after the
// product, whose fragments need the registers. No atomics and a fixed
// summation order: two calls give the same bits, and a row of length 0
// stays exactly zero.
//
// Wide layers (W streamed): where the CTA's columns of W do not fit beside
// the rest, they stream through a ring of S stages of KC rows each, every
// step. W does not depend on h, so nothing ties a copy to a step: the ring
// runs on across steps, and while step t multiplies its last chunk, runs
// its gate math and waits at the cluster barrier, step t+1's first chunks
// are already on their way. What bounds this route is how fast an SM draws
// W from L2 (a CTA reads its G*HC columns of all H rows every step: 1.2 MB
// at RNN H=3072), and on an H100 that is about 100-130 GB/s an SM, or
// 67 GB/s in clusters of 16, which fill a GPC and share its ~1 TB/s:
//   - The wrapper packs W once per call, CTA-major and chunk-major
//     ([D][NC][chunks][KC][G*HC + pad], the padding ldmatrix.trans reads
//     expect, zeros past H and past the CTA's own columns): one pass over
//     W by rnn_fwd_pack_w, so that every chunk is one contiguous block.
//   - Each chunk is one bulk copy (cp.async.bulk, the copy engine: no
//     consumer registers or instructions spent on addresses), completing
//     on the stage's "full" mbarrier by its byte count; every warp arrives
//     on the stage's "empty" mbarrier after its last read, and the stage
//     is copied into again once all have. No block barrier. (Chosen over a
//     TMA tensor map of W's own layout: its boxes would need a tensor-map
//     encode call from outside the runtime API this library links, and a
//     chunk of the packed W is one copy of any size.) The copies go round the warps (recur_chain.cuh ring_turn):
//     a copy's barrier operations cost a warp about as much as a chunk's
//     product, and one warp starting them all set the pace.
//   - Each chunk costs its warps about a microsecond beyond its bytes
//     whatever the ring's depth (the waits, the copy's start, the product's
//     dependent mma.sync), so the plan takes the fewest, largest chunks:
//     two stages of as many rows as fit, measured faster than deeper rings
//     of smaller chunks at every shape timed (PERF.md section 6).
//   - Room for the ring: where it saves chunks, the CTA keeps one h row
//     block (as the backward's chain does) and splits a second cluster
//     barrier a step: each CTA arrives once its product has read the block
//     and waits before writing the next h into it and pushing it into its
//     peers. At RNN H=3072 and R=16 that frees 98 KB.
// Each product still runs over k in ascending order, in the same 16-wide
// mma.sync steps into the same accumulators, so the results are those of
// the resident route and of any KC or S, bit for bit.
//
// Large batches (bf16; the plan's "wide" layouts, W resident): the card
// holds 15 clusters of 8 at once, and a CTA of 4 units a warp at most 128
// rows at H=256, so the export batch of 1024 rows took two waves, each a
// whole time loop. These layouts hold UNITS_WIDE = 6 units a warp (a
// template parameter, WIDE; 8 spilled registers and ran slower): 160 rows
// at H=256, 7 clusters a direction, one wave. At those rows the
// instrumented build (-DRNN_FWD_PHASES, PERF.md section 6) found the
// cluster route's exchange (each warp's 16-byte stores into every peer,
// about 24 GB/s an SM, then a cluster barrier) and the xp loads after the
// product a third of the step, so the step is built around the copy engine:
// - the h row block is NC regions [R][HC], one a CTA's columns (and one of
//   zeros where the CTAs' columns stop short of kp), their 16-byte words
//   swizzled instead of padded (swz), so a region holds nothing but h;
// - a CTA writes its region once every peer has finished the last product
//   (a relaxed cluster arrive after the product, the wait before the gate
//   math), then sends it to each peer in one bulk copy (cp.async.bulk
//   shared::cluster.shared::cta), completing on the peer's mbarrier; no
//   thread pushes and no barrier waits for the data;
// - the product waits for that mbarrier and walks each unit's k in
//   ascending order, the A fragments found through a table of each k32
//   step's offsets in the regions (koff);
// - each warp's units' xp and mask go to its slots of shared memory by
//   cp.async while the product runs.
// (Sending each region in parts as their units' gate math ends, with an
// mbarrier a part, ran no faster with two parts and slower with more: a
// bulk copy of a few KB costs about as much as one of 10 KB; so did k
// outer in the product with a warp's units on one column group sharing
// each B fragment, PERF.md section 6.) Each output still runs over k in
// ascending order in the same 16-wide mma.sync steps into one accumulator,
// so these layouts give the cluster route's bits. (Where W streams, h
// carried beside W through L2 in three waves of 48 rows ran level with the
// cluster route's five of 32 at GRU H=1024 B=1024, so W streams in the
// cluster route only.)
//
// The instrumented build (-DRNN_FWD_PHASES, a library of its own that
// tools/bench_rnn_stream.py --step-phases asks for) adds the PHASES
// kernels (bf16, W resident): thread 0's clock64() cycles of each phase of
// a step; the shipped library never has them.
//
// The wrapper (ops/rnn_scan.py, fwd_plan) picks NC, HC, R, KC, S and the
// row blocks and knows the shared-memory layout below (fwd_smem); the
// launcher refuses a plan that does not fit. R is chosen by how many
// clusters of NC the card holds at once (rnn_fwd_cluster_slots:
// cudaOccupancyMaxActiveClusters).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "recur_chain.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace recur_chain;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNITS_MAX = 4;   // (16 rows x 8 columns) units per warp (G tiles each)
constexpr int UNITS_WIDE = 6;  // the same, in the large-batch layouts
// the large-batch layouts' kernel for at most 5 units a warp (GRU, LSTM
// and RNN H=256 B=1024: 160 rows, 40 units a CTA): a sixth unit's
// accumulators, never used there, spilled registers at LSTM and GRU
constexpr int UNITS_WIDE_FEW = 5;
// The instrumented build (-DRNN_FWD_PHASES; never the shipped library):
// per CTA, thread 0's clock64() cycles of each phase of the time loop, the
// whole loop's cycles and its %globaltimer nanoseconds. kPeers: the wait
// for every peer to have read the one h row block; kPush: the pushes (the
// large-batch layout: starting its bulk copies); kBarrier: the cluster
// barrier that ends a step (the large-batch layout: the waits for the
// peers' copies)
enum Phase { kInputs, kProduct, kPeers, kGate, kPush, kBarrier, kPhases };
constexpr int PHASE_WORDS = kPhases + 2;

struct FwdArgs {
  int T, B, H;         // H: a multiple of 8
  int R, hc, kp, kc;   // the plan; kp: H rounded up to 32; kc >= kp: W resident
  int S, blocks;       // streamed: the W ring's stages; the h row blocks (2, or 1)
  const void* xp[2];   // [T][B][G*H] CT per direction
  const float* mask;   // [T][B]
  const void* w_hh;    // [D][H][G*H] CT
  const void* wpk;     // streamed: W packed by rnn_fwd_pack_w, [D][nc][chunks][kc][wld] CT
                       // (WP: rnn_fwd_pack_w_split, [D][nc][chunks][3][kc][wld] bf16)
  const float* b_hh;   // [D][G*H]
  void* out[2];        // [T][B][H] HT per direction
  void* cout[2];       // LSTM cell history, as out
  float* h_final;      // [D][B][H]
  long long* phases;   // the instrumented build's [D][grid.x][PHASE_WORDS], else null
};

// Byte offsets of one CTA's shared memory (ops/rnn_scan.py's
// _fwd_smem_bytes mirrors the sizes): round(W)[:, own] as [kp][wld] where
// resident, else the ring's S stages of [kc][wld] (WP: three bf16 planes
// of each, [3][kp or kc][wld]); the rounded h row
// blocks [blocks][R][hld] (two where resident); the bias of the own gate
// columns [G][HC] f32; streamed, the ring's full and empty barriers [2][S].
// The pads keep ldmatrix's eight 16-byte rows on distinct banks.
// The large-batch layouts (regions > 0) hold the h row block as `regions`
// regions [R][HC] instead, one a CTA's columns (and, where the cluster's
// columns stop short of kp, one of zeros), their 16-byte words swizzled
// in place of a pad (the kernel's swz), so that a region is one bulk copy
// of nothing but h; after the bias, each k32 step's four k8 offsets in the
// regions (int4); each warp's slots of its units' step xp [6][16][G x 8,
// padded to an odd number of 16-byte words] and mask [6][16] f32; then the
// exchange's mbarrier (every peer's region in).
struct FwdSmem {
  size_t w, h, bias, koff, xs, xm, bar, total;
  int wld, hld;
};

// WP (f32 compute): W held as its three bf16 pieces, [PIECES][rows][wld]
// a stage (or resident), instead of f32
template <typename CT, bool WP> struct WElem { using type = CT; };
template <> struct WElem<float, true> { using type = __nv_bfloat16; };

template <int CELL, typename CT, bool WP = false>
__host__ __device__ FwdSmem fwd_smem(int R, int hc, int kp, int kc, int S, int blocks,
                                     int regions = 0) {
  constexpr int G = NumGates<CELL>::G;
  constexpr int EPW = 16 / sizeof(CT);  // elements per 16 bytes
  using WT = typename WElem<CT, WP>::type;
  constexpr int WEPW = 16 / sizeof(WT), WPL = WP ? PIECES : 1;
  FwdSmem s;
  s.wld = G * hc + (sizeof(WT) == 2 && (G * hc / 8) % 2 == 1 ? 2 * WEPW : WEPW);
  s.hld = kp + EPW;
  const bool streamed = kc < kp;
  const int kw = streamed ? kc : kp;
  size_t o = 0;
  s.w = o;
  o += a16((size_t)WPL * kw * s.wld * sizeof(WT)) * (streamed ? S : 1);
  s.h = o;
  o += regions ? a16((size_t)regions * R * hc * sizeof(CT))
               : a16((size_t)blocks * R * s.hld * sizeof(CT));
  s.bias = o;
  o += a16((size_t)G * hc * 4);
  s.koff = o;
  if (regions) o += (size_t)kp / 32 * 16;
  s.xs = o;  // the warps' slots: WARPS x UNITS_WIDE units x 16 rows of G x 8 xp
  if (regions) o += a16((size_t)THREADS / 32 * 6 * 16 * (G * 8 + (G % 2 ? 0 : 8)) * sizeof(CT));
  s.xm = o;  // and of 16 mask values
  if (regions) o += a16((size_t)THREADS / 32 * 6 * 16 * 4);
  s.bar = o;
  if (streamed) o += (size_t)16 * S;
  if (regions) o += 16;
  s.total = o;
  return s;
}

// One element's step: x[g] the input projection, p[g] the product plus the
// bias, h (and LSTM's c) the f32 carry, updated under the mask m.
template <int CELL>
__device__ __forceinline__ void cell_update(const float* x, const float* p, float m, float& h,
                                            float& c) {
  float h_new;
  if constexpr (CELL == kGRU) {
    const float rg = sigmoid(x[0] + p[0]);
    const float zg = sigmoid(x[1] + p[1]);
    const float ng = tanhf(x[2] + rg * p[2]);
    h_new = (1.0f - zg) * ng + zg * h;
  } else if constexpr (CELL == kLSTM) {
    const float ig = sigmoid(x[0] + p[0]);
    const float fg = sigmoid(x[1] + p[1]);
    const float gg = tanhf(x[2] + p[2]);
    const float og = sigmoid(x[3] + p[3]);
    const float c_new = fg * c + ig * gg;
    h_new = og * tanhf(c_new);
    c = m * c_new + (1.0f - m) * c;
  } else {
    h_new = tanhf(x[0] + p[0]);
  }
  h = m * h_new + (1.0f - m) * h;
}

// Two neighbouring columns of the compute dtype: a bf16 pair in one
// register (bf16), or a float2 (f32)
template <typename CT> struct Pair { using type = __nv_bfloat162; };
template <> struct Pair<float> { using type = float2; };
__device__ __forceinline__ float pair_lo(float2 v) { return v.x; }
__device__ __forceinline__ float pair_hi(float2 v) { return v.y; }
__device__ __forceinline__ float pair_lo(__nv_bfloat162 v) { return __low2float(v); }
__device__ __forceinline__ float pair_hi(__nv_bfloat162 v) { return __high2float(v); }
template <typename P> __device__ __forceinline__ P pair_of(float x, float y);
template <> __device__ __forceinline__ float2 pair_of<float2>(float x, float y) {
  return make_float2(x, y);
}
template <> __device__ __forceinline__ __nv_bfloat162 pair_of<__nv_bfloat162>(float x, float y) {
  return __floats2bfloat162_rn(x, y);
}

// STREAM: W streams through the ring (a template argument, so the
// resident route compiles as if the ring did not exist); WP: f32 compute
// with W held as its bf16 pieces; U: the (16 x 8) units a warp holds at
// most (UNITS_WIDE: the large-batch layouts, bf16 with W resident);
// PHASES: the instrumented build's timing of a step (bf16, W resident)
template <int CELL, typename CT, typename HT, bool STREAM, bool WP, int U = UNITS_MAX,
          bool PHASES = false>
__global__ void __launch_bounds__(THREADS, 1) rnn_fwd_kernel(FwdArgs a) {
  static_assert(U == UNITS_MAX || (!STREAM && !WP && sizeof(CT) == 2),
                "the large-batch layouts: bf16, W resident");
  static_assert(!PHASES || (!STREAM && !WP && sizeof(CT) == 2), "timed: bf16, W resident");
  constexpr int G = NumGates<CELL>::G;
  constexpr bool kSplit = sizeof(CT) == 4;  // f32 compute: split products
  constexpr int EPW = 16 / sizeof(CT);
  constexpr int ROW_WORDS = 8 / EPW;  // 16-byte words of a unit row's 8 columns
  using XPair = typename Pair<CT>::type;  // two columns of xp
  using HPair = typename Pair<CT>::type;  // two columns of the h row block
  using WT = typename WElem<CT, WP>::type;  // W's elements in shared memory
  constexpr int WPL = WP ? PIECES : 1;      // W's planes
  cg::cluster_group cluster = cg::this_cluster();
  const int T = a.T, B = a.B, H = a.H, GH = G * H;
  const int R = a.R, hc = a.hc, kp = a.kp, kc = a.kc < a.kp ? a.kc : a.kp;
  constexpr bool resident = !STREAM;  // the launcher's choice: kc >= kp
  const int S = a.S;
  const bool one_block = a.blocks == 1;  // one h row block, a second cluster barrier a step
  const int nc = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  const int cl = blockIdx.x / nc;
  const int d = blockIdx.y;
  const int r0 = cl * R, j0 = q * hc;
  const int own = max(0, min(hc, H - j0));  // hidden columns this CTA owns (a multiple of 8)
  const int nrows = min(R, B - r0);         // rows of the cluster's block that exist
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const CT* xp = static_cast<const CT*>(a.xp[d]);
  HT* out = static_cast<HT*>(a.out[d]);
  HT* cout = static_cast<HT*>(a.cout[d]);
  const CT* w = static_cast<const CT*>(a.w_hh) + (size_t)d * H * GH;
  const float* bias = a.b_hh + (size_t)d * GH;

  // the large-batch layouts (WIDE): the h row block as regions (fwd_smem),
  // one a CTA's columns, and one of zeros where the cluster's columns stop
  // short of kp
  constexpr bool WIDE = U > UNITS_MAX;
  const int nreg = WIDE ? nc + (nc * hc < kp) : 0;
  const FwdSmem L = fwd_smem<CELL, CT, WP>(R, hc, kp, kc, S, a.blocks, nreg);
  const int wld = L.wld, hld = L.hld;
  extern __shared__ __align__(16) unsigned char smem[];
  WT* wbuf = reinterpret_cast<WT*>(smem + L.w);  // resident W, or the ring's stages
  const size_t pstride = (size_t)(resident ? kp : kc) * wld;  // WP: elements of a plane
  CT* hbuf = reinterpret_cast<CT*>(smem + L.h);
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);  // [S], then empty [S]
  uint64_t* empty = full + S;
  // WIDE: each k32 step's offsets in the regions; the exchange's mbarrier
  // (every peer's region in); this CTA's region; this warp's slots of its
  // units' xp and mask
  int4* koff = reinterpret_cast<int4*>(smem + L.koff);
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem + L.bar);
  CT* mine = WIDE ? hbuf + (size_t)q * R * hc : hbuf;
  const int xrow = G * 8 + (G % 2 ? 0 : 8);  // a slot row's elements: odd 16-byte words
  CT* xslot = reinterpret_cast<CT*>(smem + L.xs) + (size_t)(tid / 32) * U * 16 * xrow;
  float* mslot = reinterpret_cast<float*>(smem + L.xm) + (tid / 32) * U * 16;

  // resident: round(W)[k][g*H + j0 + c] -> wbuf[k][g*hc + c] for k < kp,
  // c < hc; zero past the owned columns and past H
  const int wpr = G * hc / EPW;  // 16-byte words of a wbuf row
  auto load_w = [&](int k0) {
    if constexpr (WP) {  // split in registers, each piece into its plane
      const int ppr = G * hc / 2;  // column pairs of a row
#pragma unroll 1
      for (int idx = tid; idx < kc * ppr; idx += THREADS) {
        const int k = idx / ppr, n = (idx % ppr) * 2;
        const int g = n / hc, c = n % hc;
        const float2 v = c < own && k0 + k < H
                             ? *reinterpret_cast<const float2*>(w + (size_t)(k0 + k) * GH + g * H +
                                                                j0 + c)
                             : make_float2(0.0f, 0.0f);
        uint32_t pc[PIECES];
        split_bf16x3(v.x, v.y, pc);
#pragma unroll
        for (int pl = 0; pl < PIECES; ++pl)
          *reinterpret_cast<uint32_t*>(wbuf + pl * pstride + (size_t)k * wld + n) = pc[pl];
      }
      return;
    }
#pragma unroll 1
    for (int idx = tid; idx < kc * wpr; idx += THREADS) {
      const int k = idx / wpr, n = (idx % wpr) * EPW;
      const int g = n / hc, c = n % hc;
      WT* dst = wbuf + (size_t)k * wld + n;
      if (c < own && k0 + k < H)
        cp_async16(dst, w + (size_t)(k0 + k) * GH + g * H + j0 + c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
  };

  // streamed: the CTA's chunk x (of T * nch, in the order they are
  // multiplied) is its packed W chunk x % nch, copied into stage x % S
  // (WP: a chunk is its three planes of kc rows, the rows past kp zeros)
  const int nch = (kp + kc - 1) / kc, total = T * nch;
  const size_t cstride = (size_t)WPL * kc * wld;  // elements of a packed chunk
  const WT* wsrc =
      resident ? nullptr : static_cast<const WT*>(a.wpk) + ((size_t)d * nc + q) * nch * cstride;
  auto copy_chunk = [&](int x, int st, uint64_t* bar) {
    const int c = x % nch;
    const unsigned bytes =
        (unsigned)((WP ? cstride : (size_t)min(kc, kp - c * kc) * wld) * sizeof(WT));
    mbar_arrive_expect_tx(bar, bytes);
    bulk_copy(wbuf + (size_t)st * cstride, wsrc + (size_t)c * cstride, bytes, bar);
  };

  // the h row blocks start at zero; rows past the batch and columns past
  // H are never written and stay zero
  {
    uint4* hz = reinterpret_cast<uint4*>(hbuf);
    const int words = WIDE ? (int)((L.bias - L.h) / 16)
                           : (int)(a.blocks * (size_t)R * hld * sizeof(CT) / 16);
    for (int i = tid; i < words; i += THREADS) hz[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if constexpr (WIDE) {
    // each k32 step's four k8 column groups k: region k / hc (the zero
    // region past the cluster's columns) times R * hc elements, shifted
    // left 6, with the group's chunk k % hc / 8 (< 64) in the low bits
    for (int st = tid; st < kp / 32; st += THREADS) {
      int o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = st * 32 + i * 8, rg = min(k / hc, nc);
        o[i] = ((rg * R * hc) << 6) | (rg < nc ? k % hc / 8 : 0);
      }
      koff[st] = make_int4(o[0], o[1], o[2], o[3]);
    }
    if (tid == 0) {
      mbar_init(xbar, 1);  // thread 0's arrival, and the copies' bytes
      mbar_init_fence();
    }
  }
  for (int i = tid; i < G * hc; i += THREADS) {
    const int g = i / hc, c = i % hc;
    bias_s[i] = c < own ? bias[g * H + j0 + c] : 0.0f;
  }
  if constexpr (resident) {
    load_w(0);
  } else if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, WARPS);  // every warp releases every chunk
    }
    mbar_init_fence();
  }
  cp_async_wait<0>();
  cluster.sync();  // every CTA of the cluster runs, its buffers ready, before the first push
  if (!resident && tid == 0)  // the ring's first S - 1 chunks
    for (int x = 0; x < S - 1 && x < total; ++x) copy_chunk(x, x, full + x);

  // the L2 prefetch of a step's xp rows: CTA q takes 1/nc of the cluster's
  // contiguous block [nrows][G*H], in 128-byte lines
  const size_t blk_bytes = (size_t)nrows * GH * sizeof(CT);
  const size_t pf_slice = ((blk_bytes + nc - 1) / nc + 127) / 128 * 128;
  const size_t pf_begin = (size_t)q * pf_slice;
  const size_t pf_end = pf_begin + pf_slice < blk_bytes ? pf_begin + pf_slice : blk_bytes;
  auto prefetch_step = [&](int t) {
    const unsigned char* base =
        reinterpret_cast<const unsigned char*>(xp + ((size_t)t * B + r0) * GH);
#pragma unroll 1
    for (size_t o = pf_begin + (size_t)tid * 128; o < pf_end; o += (size_t)THREADS * 128)
      prefetch_l2(base + o);
    if (q == 0 && tid * 32 < nrows) prefetch_l2(a.mask + (size_t)t * B + r0 + tid * 32);
  };
  // streamed: as chunk g begins, one warp copies chunk g + S - 1 (its turn
  // in the round), and every warp waits for chunk g; each releases it after
  // its last read
  auto chunk_begin = [&](int g) -> const WT* {
    ring_turn(g, S, total, WARPS, full, empty, copy_chunk);
    mbar_wait(full + g % S, (g / S) & 1);
    return wbuf + (size_t)(g % S) * cstride;
  };
  auto chunk_end = [&](int g) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + g % S);
  };

  const int gid = lane / 4, tig = lane % 4;
  const int ntn = hc / 8, units = ((R + 15) / 16) * ntn;
  const bool half = R < 16;  // f32 at 8 rows: each m16 tile's rows 8-15 are absent
  // this warp's units: u = warp + i * WARPS, rows mt*16.., columns nt*8..;
  // units past the owned columns or the existing rows stay off. A unit
  // keeps only its tile's first row and column; the offsets are worked out
  // from them where they are used (held per unit, they cost registers: on
  // an H100 LSTM's f32 kernels spilled 156-228 B a thread with them, 12-60
  // without, and LSTM H=1536 B=16 ran 1.2x faster, PERF.md section 6)
  int mt16[U], ucol[U];  // the unit's first row and first column within the CTA
  bool on[U];
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int u = warp + i * WARPS;
    const int mt = u / ntn, nt = u % ntn;
    on[i] = u < units && nt * 8 < own && mt * 16 < nrows;
    mt16[i] = mt * 16;
    ucol[i] = nt * 8;
  }
  // bf16: the ldmatrix A row offset; f32: the tile's first row
  auto arow = [&](int i) {
    return kSplit ? mt16[i] * hld : (mt16[i] + lane % 16) * hld + (lane / 16) * 8;
  };
  // f32: on the m16 tile of the unit before it, which is on
  auto same_rows = [&](int i) { return i > 0 && on[i - 1] && mt16[i - 1] == mt16[i]; };
  auto erow = [&](int i, int hh) { return mt16[i] + gid + hh * 8; };  // this lane's elements' rows
  auto prow = [&](int i) { return mt16[i] + lane % 16; };  // the row this lane pushes
  // WIDE: a region row's 16-byte words (chunks of 8 columns) are
  // swizzled, chunk c of row r at c ^ swz(r). A row of n = HC / 8 chunks,
  // n = p * odd with p the largest power of two (at most 8) dividing n,
  // puts 8 neighbouring rows on 8 / p distinct 16-byte bank groups p times
  // over; the swizzle's p values tell those apart, so an ldmatrix's eight
  // rows (and the gate math's stores) fall on distinct banks. It depends
  // on r % 16 alone (a unit's first row is a multiple of 16). The bytes of
  // a region's copy: the rows that exist. A lane's A row (its unit's rows
  // add to it) and B row, as shared-window addresses.
  const int swp = WIDE ? min(8, (hc / 8) & -(hc / 8)) : 1;
  const int sw_sh = swp == 1 ? 3 : swp == 2 ? 2 : swp == 4 ? 1 : 0, sw_m = swp - 1;
  auto swz = [&](int r) { return (r >> sw_sh) & sw_m; };
  const unsigned region_bytes = WIDE ? (unsigned)(nrows * hc * sizeof(CT)) : 0u;
  const unsigned a_lane = WIDE ? smem_addr(hbuf) + (lane % 16) * hc * 2 : 0u;
  const unsigned b_lane = WIDE ? smem_addr(wbuf) + lane * wld * 2 : 0u;
  const int a_sw = swz(lane % 16);
  float hcar[U][4], ccar[U][4];
#pragma unroll
  for (int i = 0; i < U; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) hcar[i][e] = ccar[i][e] = 0.0f;
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
  auto sync_stamp = [&](int p) {
    if constexpr (PHASES) {
      __syncthreads();
      stamp(p);
    }
  };
  if constexpr (PHASES) {
    for (int p = 0; p < kPhases; ++p) ph_acc[p] = 0;
    ph_t0 = ph_last = clock64();
    ns0 = global_ns();
  }

#pragma unroll 1
  for (int step = 0; step < T; ++step) {
    const int t = d == 0 ? step : T - 1 - step;
    const CT* cur = hbuf + (size_t)(one_block ? 0 : step & 1) * R * hld;
    CT* nxt = hbuf + (size_t)(one_block ? 0 : (step + 1) & 1) * R * hld;
    if (step + 1 < T) prefetch_step(d == 0 ? t + 1 : t - 1);
    const size_t tb = (size_t)t * B;
    if constexpr (WIDE) {
      // The large-batch layouts' step (the kernel's note): the xp and mask
      // of the warp's units to its slots while the product runs; every
      // peer's region in; the product, unit by unit; a relaxed arrival once
      // this CTA has read the regions, and the wait for every CTA's; the
      // gate math, each unit's h into this CTA's region; the region to
      // every peer
#pragma unroll
      for (int i = 0; i < U; ++i) {
        if (!on[i]) continue;
        CT* xs = xslot + (size_t)i * 16 * xrow;
        for (int c = lane; c < 16 * G; c += 32) {
          const int row = c / G, g = c - row * G;
          if (mt16[i] + row < nrows)
            cp_async16(xs + row * xrow + g * 8,
                       xp + (tb + r0 + mt16[i] + row) * GH + (size_t)g * H + j0 + ucol[i]);
        }
        if (lane < 16 && mt16[i] + lane < nrows)
          cp_async4(mslot + i * 16 + lane, a.mask + tb + r0 + mt16[i] + lane);
      }
      cp_async_commit();
      stamp(kInputs);
      if (step > 0) mbar_wait(xbar, (step - 1) & 1);  // every peer's region
      stamp(kBarrier);
      // each unit over k in ascending order, two k16 steps a k32 step into
      // its accumulators (the cluster route's order, so its bits), the A
      // fragments found region by region (koff: this lane's two k8 groups
      // of the step, offset by the unit's rows)
      float acc[U][G][4];
#pragma unroll
      for (int i = 0; i < U; ++i) {
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.0f;
        if (!on[i]) continue;
        const unsigned ro = a_lane + mt16[i] * hc * 2, bo = b_lane + ucol[i] * 2;
#pragma unroll 2
        for (int kk = 0; kk < kp; kk += 32) {
          const int4 ko = koff[kk / 32];
          const int v0 = lane < 16 ? ko.x : ko.y, v1 = lane < 16 ? ko.z : ko.w;
          uint32_t a0[4], a1[4];
          ldsm_x4_at(a0, ro + ((v0 >> 6) + (((v0 & 63) ^ a_sw) << 3)) * 2);
          ldsm_x4_at(a1, ro + ((v1 >> 6) + (((v1 & 63) ^ a_sw) << 3)) * 2);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            uint32_t b[4];  // B of the k16 steps at kk and kk + 16
            ldsm_x4_t_at(b, bo + (kk * wld + g * hc) * 2);
            mma_bf16(acc[i][g], a0[0], a0[1], a0[2], a0[3], b[0], b[1]);
            mma_bf16(acc[i][g], a1[0], a1[1], a1[2], a1[3], b[2], b[3]);
          }
        }
      }
      stamp(kProduct);
      // the next step's copies: thread 0's arrival on the exchange's
      // mbarrier with the bytes they bring (its wait above saw the phase
      // before), ahead of the arrival that lets the peers send; relaxed,
      // since a release would first wait for the history's stores, which
      // no peer reads
      if (tid == 0 && step + 1 < T) mbar_arrive_expect_tx(xbar, (nc - 1) * region_bytes);
      cluster_arrive_relaxed();  // this CTA no longer reads the regions
      cp_async_wait<0>();        // the warp's xp and mask in its slots
      __syncwarp();
      stamp(kInputs);
      cluster_wait();  // every CTA has read the regions: the next h may go in
      stamp(kPeers);
#pragma unroll
      for (int i = 0; i < U; ++i) {
        if (!on[i]) continue;
        const int col = ucol[i] + tig * 2;  // within the CTA
        const CT* xs = xslot + (size_t)i * 16 * xrow + tig * 2;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rr = gid + hh * 8, row = mt16[i] + rr;  // within the unit, the CTA
          const bool ok = row < nrows;
          const float m = ok ? mslot[i * 16 + rr] : 0.0f;
          float x[2][G], pv[2][G];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const XPair xv =
                ok ? *reinterpret_cast<const XPair*>(xs + rr * xrow + g * 8) : XPair{};
            const float2 bv = *reinterpret_cast<const float2*>(bias_s + g * hc + col);
            x[0][g] = pair_lo(xv);
            x[1][g] = pair_hi(xv);
            pv[0][g] = acc[i][g][2 * hh] + bv.x;
            pv[1][g] = acc[i][g][2 * hh + 1] + bv.y;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e)
            cell_update<CELL>(x[e], pv[e], m, hcar[i][2 * hh + e], ccar[i][2 * hh + e]);
          const float h0 = hcar[i][2 * hh], h1 = hcar[i][2 * hh + 1];
          // its region, the unit's word swizzled
          *reinterpret_cast<HPair*>(mine + row * hc + (((ucol[i] >> 3) ^ swz(row)) << 3) +
                                    tig * 2) = pair_of<HPair>(h0, h1);
          if (ok) {
            const size_t o = (tb + r0 + row) * H + j0 + col;
            if constexpr (sizeof(HT) == 4)
              *reinterpret_cast<float2*>(out + o) = make_float2(h0, h1);
            if constexpr (CELL == kLSTM) {
              const float c0 = ccar[i][2 * hh], c1 = ccar[i][2 * hh + 1];
              if constexpr (sizeof(HT) == 4)
                *reinterpret_cast<float2*>(cout + o) = make_float2(c0, c1);
              else
                *reinterpret_cast<__nv_bfloat162*>(cout + o) = __floats2bfloat162_rn(c0, c1);
            }
          }
        }
        __syncwarp();
        if constexpr (sizeof(HT) == 2) {  // the bf16 history: the rounded h, a row word
          const int r = prow(i);
          if (lane < 16 && r < nrows)
            *reinterpret_cast<uint4*>(out + (tb + r0 + r) * H + j0 + ucol[i]) =
                *reinterpret_cast<const uint4*>(mine + r * hc + (((ucol[i] >> 3) ^ swz(r)) << 3));
        }
      }
      stamp(kGate);
      // the region to every peer but at the last step: one bulk copy a peer
      // (the copy engine, shared -> peer shared), started by lanes of warp
      // 0 side by side, completing on the peer's mbarrier; the barrier
      // also orders every warp's writes before the next product
      if (step + 1 < T) {
        fence_proxy_async_smem();  // the region's writes, before the copies read them
        __syncthreads();
        if (warp == 0 && lane > 0 && lane < nc) {
          const int peer = q + lane < nc ? q + lane : q + lane - nc;
          bulk_copy_to_peer(peer_addr(mine, peer), mine, region_bytes, peer_addr(xbar, peer));
        }
      }
      stamp(kPush);
      continue;
    }

    // 1. this step's xp (pairs of columns) and mask of the thread's
    // elements, from L2 (prefetched a step ahead): at bf16 before the
    // product, so the loads overlap it; at f32, and where a warp holds more
    // than UNITS_MAX units, after it, where the split fragments or the
    // accumulators need the registers the pairs would hold (LSTM's four
    // gates with more than UNITS_MAX units: each unit's just before its
    // gate math)
    constexpr bool x_after = kSplit || U > UNITS_MAX, x_unit = U > UNITS_MAX && CELL == kLSTM;
    XPair xr[U][G][2];
    float mk[U][2];
    auto load_unit_x = [&](int i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = erow(i, hh);
        const bool ok = on[i] && row < nrows;
        mk[i][hh] = ok ? __ldg(a.mask + tb + r0 + row) : 0.0f;
        const CT* xrow = xp + (tb + r0 + row) * GH + j0 + ucol[i] + tig * 2;
#pragma unroll
        for (int g = 0; g < G; ++g)
          xr[i][g][hh] = ok ? __ldg(reinterpret_cast<const XPair*>(xrow + (size_t)g * H))
                            : XPair{};
      }
    };
    auto load_x = [&]() {
#pragma unroll
      for (int i = 0; i < U; ++i) load_unit_x(i);
    };
    if constexpr (!x_after) load_x();
    sync_stamp(kInputs);

    // 2. the product, one accumulator per (unit, gate), over rows
    // [k0, k0 + klen) of W held at wk (its row k0 first)
    float acc[U][G][4];
#pragma unroll
    for (int i = 0; i < U; ++i)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.0f;
    auto product = [&](const WT* wk, int k0, int klen) {
      if constexpr (WP) {
        // f32, W in its pieces: A split in registers as below, B's pieces
        // by ldmatrix from their planes, k32 steps and a last k16 step
        // where klen is an odd multiple of 16 (the same products in the
        // same order, so the same bits)
        const float* ap = reinterpret_cast<const float*>(cur) + k0;
        auto steps = [&](int kk, auto two_steps) {  // k16 steps at kk (and kk + 16)
          constexpr bool two = decltype(two_steps)::value;
          uint32_t af[2][PIECES][4];
#pragma unroll
          for (int i = 0; i < U; ++i) {
            if (!on[i]) continue;
            if (!same_rows(i)) {
              a_frag_f32(ap + arow(i) + kk, hld, half, af[0]);
              if constexpr (two) a_frag_f32(ap + arow(i) + kk + 16, hld, half, af[1]);
            }
            const WT* bp = wk + (size_t)(kk + lane) * wld + ucol[i];  // k rows kk + lane
#pragma unroll
            for (int g = 0; g < G; ++g) {
              uint32_t bq[PIECES][4], b0[PIECES][2], b1[PIECES][2];
#pragma unroll
              for (int pl = 0; pl < PIECES; ++pl) {
                if constexpr (two) {
                  ldsm_x4_t(bq[pl], bp + pl * pstride + g * hc);
                  b0[pl][0] = bq[pl][0];
                  b0[pl][1] = bq[pl][1];
                  b1[pl][0] = bq[pl][2];
                  b1[pl][1] = bq[pl][3];
                } else {  // rows kk..kk+15: the addresses of lanes 0-15
                  ldsm_x2_t(b0[pl], bp + pl * pstride + g * hc);
                }
              }
              mma_split(acc[i][g], af[0], b0);
              if constexpr (two) mma_split(acc[i][g], af[1], b1);
            }
          }
        };
        int kk = 0;
#pragma unroll 1
        for (; kk + 32 <= klen; kk += 32) steps(kk, std::true_type{});
        if (kk < klen) steps(kk, std::false_type{});
      } else if constexpr (kSplit) {
        // f32: each k16 step's fragments split in registers, six products a
        // gate; k16 steps outer, so a unit on the rows of the unit before it
        // (the same m16 tile) takes that unit's split A fragment
        const float* ap = reinterpret_cast<const float*>(cur) + k0;
        const float* bp = reinterpret_cast<const float*>(wk);
#pragma unroll 1
        for (int kk = 0; kk < klen; kk += 16) {
          uint32_t af[PIECES][4];
#pragma unroll
          for (int i = 0; i < U; ++i) {
            if (!on[i]) continue;
            if (!same_rows(i)) a_frag_f32(ap + arow(i) + kk, hld, half, af);
#pragma unroll
            for (int g = 0; g < G; ++g) {
              uint32_t bf[PIECES][2];
              b_frag_f32_kn(bp + (size_t)kk * wld + g * hc + ucol[i], wld, bf);
              mma_split(acc[i][g], af, bf);
            }
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < U; ++i) {
          if (!on[i]) continue;
          const CT* ap = cur + arow(i) + k0;
          const WT* bp = wk + (size_t)lane * wld + ucol[i];  // k rows kk + lane
#pragma unroll 2
          for (int kk = 0; kk < klen; kk += 32) {
            uint32_t a0[4], a1[4];
            ldsm_x4(a0, ap + kk);
            ldsm_x4(a1, ap + kk + 16);
#pragma unroll
            for (int g = 0; g < G; ++g) {
              uint32_t b[4];  // B of the k16 steps at kk and kk + 16
              ldsm_x4_t(b, bp + (size_t)kk * wld + g * hc);
              mma_bf16(acc[i][g], a0[0], a0[1], a0[2], a0[3], b[0], b[1]);
              mma_bf16(acc[i][g], a1[0], a1[1], a1[2], a1[3], b[2], b[3]);
            }
          }
        }
      }
    };
    if constexpr (resident) {
      product(wbuf, 0, kp);
    } else {
      int g = step * nch;
#pragma unroll 1
      for (int c = 0; c < nch; ++c, ++g) {
        const WT* wk = chunk_begin(g);
        product(wk, c * kc, min(kc, kp - c * kc));
        chunk_end(g);
      }
    }
    sync_stamp(kProduct);
    if (one_block) cluster_arrive();  // this CTA no longer reads the row block
    if constexpr (x_after && !x_unit) load_x();
    sync_stamp(kInputs);

    // 3. gate math, history, and h (bf16: rounded) into the next row block
    // (one block: kept in registers until every peer has read the block)
    HPair hnew[U][2];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (!on[i]) continue;
      if constexpr (x_unit) load_unit_x(i);
      const int col = ucol[i] + tig * 2;  // within the CTA
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = erow(i, hh);
        float x[2][G], p[2][G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float2 bv = *reinterpret_cast<const float2*>(bias_s + g * hc + col);
          x[0][g] = pair_lo(xr[i][g][hh]);
          x[1][g] = pair_hi(xr[i][g][hh]);
          p[0][g] = acc[i][g][2 * hh] + bv.x;
          p[1][g] = acc[i][g][2 * hh + 1] + bv.y;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e)
          cell_update<CELL>(x[e], p[e], mk[i][hh], hcar[i][2 * hh + e], ccar[i][2 * hh + e]);
        const float h0 = hcar[i][2 * hh], h1 = hcar[i][2 * hh + 1];
        hnew[i][hh] = pair_of<HPair>(h0, h1);
        if (!one_block && row < R)
          *reinterpret_cast<HPair*>(nxt + (size_t)row * hld + j0 + col) = hnew[i][hh];
        if (row < nrows) {
          const size_t o = (tb + r0 + row) * H + j0 + col;
          if constexpr (sizeof(HT) == 4)
            *reinterpret_cast<float2*>(out + o) = make_float2(h0, h1);
          if constexpr (CELL == kLSTM) {
            const float c0 = ccar[i][2 * hh], c1 = ccar[i][2 * hh + 1];
            if constexpr (sizeof(HT) == 4)
              *reinterpret_cast<float2*>(cout + o) = make_float2(c0, c1);
            else
              *reinterpret_cast<__nv_bfloat162*>(cout + o) = __floats2bfloat162_rn(c0, c1);
          }
        }
      }
    }
    sync_stamp(kGate);
    if (one_block) {
      cluster_wait();  // every CTA has read the block: the next h may go in
      stamp(kPeers);
#pragma unroll
      for (int i = 0; i < U; ++i) {
        if (!on[i]) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          if (erow(i, hh) < R)
            *reinterpret_cast<HPair*>(nxt + (size_t)erow(i, hh) * hld + j0 + ucol[i] + tig * 2) =
                hnew[i][hh];
      }
    }
    __syncwarp();

    // 4. push the units' rows (8 columns: one 16-byte word at bf16, two at
    // f32) into every peer's next row block; lanes 0-15 and 16-31 take
    // every other peer
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (!on[i] || prow(i) >= nrows) continue;
      CT* src = nxt + (size_t)prow(i) * hld + j0 + ucol[i];
      uint4 v[ROW_WORDS];
#pragma unroll
      for (int w = 0; w < ROW_WORDS; ++w) v[w] = reinterpret_cast<const uint4*>(src)[w];
#pragma unroll 1
      for (int pr = 1 + lane / 16; pr < nc; pr += 2) {
        const int peer = q + pr < nc ? q + pr : q + pr - nc;
        uint4* dst = reinterpret_cast<uint4*>(cluster.map_shared_rank(src, peer));
#pragma unroll
        for (int w = 0; w < ROW_WORDS; ++w) dst[w] = v[w];
      }
      if constexpr (sizeof(HT) == 2)  // the bf16 history is the rounded h itself
        if (lane < 16)
          *reinterpret_cast<uint4*>(out + (tb + r0 + prow(i)) * H + j0 + ucol[i]) = v[0];
    }
    sync_stamp(kPush);
    cluster.sync();  // 5. release the pushes, acquire the peers'
    stamp(kBarrier);
  }
  if constexpr (PHASES) {
    if (tid == 0) {
      long long* o = a.phases + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * PHASE_WORDS;
      for (int p = 0; p < kPhases; ++p) o[p] = ph_acc[p];
      o[kPhases] = clock64() - ph_t0;
      o[kPhases + 1] = (long long)(global_ns() - ns0);
    }
  }

#pragma unroll
  for (int i = 0; i < U; ++i) {
    if (!on[i]) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (erow(i, hh) < nrows) {
        float* hf = a.h_final + ((size_t)d * B + r0 + erow(i, hh)) * H + j0 + ucol[i] + tig * 2;
        *reinterpret_cast<float2*>(hf) = make_float2(hcar[i][2 * hh], hcar[i][2 * hh + 1]);
      }
  }
}

// W [D][H][G*H] -> the streamed route's packed W [D][nc][nch][kc][wld]:
// chunk c of CTA q holds round(W)[c*kc + k][g*H + q*hc + col] at row k,
// column g*hc + col, and zeros past H, past the CTA's own columns and in
// the padding, so that each chunk is one contiguous copy. 16-byte words:
// a word never straddles a gate or the own columns (multiples of 8).
struct PackArgs {
  int H, G, nc, hc, kc, kp, nch, wld, D;
  const void* w;
  void* wpk;
};

template <typename CT>
__global__ void rnn_fwd_pack_w(PackArgs p) {
  constexpr int EPW = 16 / sizeof(CT);
  const int wpr = p.wld / EPW, GH = p.G * p.H;
  const size_t words = (size_t)p.D * p.nc * p.nch * p.kc * wpr;
  const CT* w = static_cast<const CT*>(p.w);
  uint4* dst = static_cast<uint4*>(p.wpk);
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < words;
       idx += (size_t)gridDim.x * blockDim.x) {
    size_t r = idx / wpr;
    const int n = (int)(idx - r * wpr) * EPW;
    const int k = (int)(r % p.kc);
    r /= p.kc;
    const int c = (int)(r % p.nch);
    r /= p.nch;
    const int q = (int)(r % p.nc), d = (int)(r / p.nc);
    const int g = n / p.hc, col = n % p.hc, j0 = q * p.hc, row = c * p.kc + k;
    const int own = max(0, min(p.hc, p.H - j0));
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (g < p.G && col < own && row < p.H)
      v = *reinterpret_cast<const uint4*>(w + ((size_t)d * p.H + row) * GH + g * p.H + j0 + col);
    dst[idx] = v;
  }
}

// f32, W in its pieces: W [D][H][G*H] f32 -> [D][nc][nch][PIECES][kc][wld]
// bf16, chunk c of CTA q holding the hi, mid and lo planes of its kc rows
// as rnn_fwd_pack_w lays out one, zeros past H (a chunk is copied whole)
__global__ void rnn_fwd_pack_w_split(PackArgs p) {
  const int ppr = p.wld / 2, GH = p.G * p.H;
  const size_t pairs = (size_t)p.D * p.nc * p.nch * p.kc * ppr;
  const float* w = static_cast<const float*>(p.w);
  uint32_t* dst = static_cast<uint32_t*>(p.wpk);
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < pairs;
       idx += (size_t)gridDim.x * blockDim.x) {
    size_t r = idx / ppr;
    const int n = (int)(idx - r * ppr) * 2;
    const int k = (int)(r % p.kc);
    r /= p.kc;  // the chunk, (d * nc + q) * nch + c
    const int c = (int)(r % p.nch), q = (int)(r / p.nch % p.nc), d = (int)(r / p.nch / p.nc);
    const int g = n / p.hc, col = n % p.hc, j0 = q * p.hc, row = c * p.kc + k;
    const int own = max(0, min(p.hc, p.H - j0));
    float2 v = make_float2(0.0f, 0.0f);
    if (g < p.G && col < own && row < p.H)
      v = *reinterpret_cast<const float2*>(w + ((size_t)d * p.H + row) * GH + g * p.H + j0 + col);
    uint32_t pc[PIECES];
    split_bf16x3(v.x, v.y, pc);
    const size_t base = r * PIECES * p.kc * ppr + (size_t)k * ppr + n / 2;
#pragma unroll
    for (int pl = 0; pl < PIECES; ++pl) dst[base + (size_t)pl * p.kc * ppr] = pc[pl];
  }
}

struct Plan {
  int nc, R, hc, kc, S, blocks, wsplit;  // wsplit: f32, W in its bf16 pieces
  int wide;  // the large-batch layouts: UNITS_WIDE units a warp (bf16, W resident)
};

template <int CELL, typename CT>
bool plan_ok(const Plan& pl, int H, int kp) {
  // the bf16 product's k32 steps, the split product's k16 steps
  constexpr int kstep = sizeof(CT) == 2 ? 32 : 16;
  const bool streamed = pl.kc < kp;
  if (H % 8 || pl.nc < 1 || pl.nc > 16 || pl.hc < 8 || pl.hc % 8 || pl.nc * pl.hc < H ||
      (pl.nc - 1) * pl.hc >= H || pl.kc < kstep || pl.kc % kstep ||
      (streamed && (pl.S < 1 || pl.S > 8)))
    return false;
  // W in its pieces only at f32; the large-batch layouts only at bf16 with
  // W resident
  if ((pl.wsplit && sizeof(CT) != 4) || (pl.wide && (sizeof(CT) != 2 || streamed)))
    return false;
  // h rows: two blocks, or one (a second cluster barrier a step) where W
  // streams; the large-batch layouts: one, as regions
  if (pl.wide ? pl.blocks != 1 : pl.blocks != 2 && !(pl.blocks == 1 && streamed)) return false;
  // whole m16 tiles of rows (f32 also 8 rows, half a tile)
  const bool rows = pl.R % 16 == 0 || (sizeof(CT) == 4 && pl.R == 8);
  const int units = pl.wide ? UNITS_WIDE : UNITS_MAX;
  return pl.R >= 8 && rows && ((pl.R + 15) / 16) * (pl.hc / 8) <= units * WARPS;
}

template <int CELL, typename CT>
FwdSmem plan_smem(const Plan& pl, int kp, int kc) {
  const int regions = pl.wide ? pl.nc + (pl.nc * pl.hc < kp) : 0;  // the kernel's nreg
  return pl.wsplit ? fwd_smem<CELL, CT, true>(pl.R, pl.hc, kp, kc, pl.S, pl.blocks)
                   : fwd_smem<CELL, CT, false>(pl.R, pl.hc, kp, kc, pl.S, pl.blocks, regions);
}

// the packed W's elements of a streamed plan (rnn_fwd_pack_w's output; in
// its pieces, rnn_fwd_pack_w_split's, bf16)
template <int CELL, typename CT>
size_t packed_elems(const Plan& pl, int kp, int D) {
  const FwdSmem L = plan_smem<CELL, CT>(pl, kp, pl.kc);
  const int nch = (kp + pl.kc - 1) / pl.kc;
  return (size_t)D * pl.nc * nch * (pl.wsplit ? PIECES : 1) * pl.kc * L.wld;
}

// few: the large-batch layouts at most UNITS_WIDE_FEW units a warp
template <int CELL, typename CT, typename HT>
auto pick_kernel(bool streamed, bool wsplit, bool wide, bool few, bool phased) {
  (void)phased;
#ifdef RNN_FWD_PHASES
  if constexpr (sizeof(CT) == 2)
    if (phased && !streamed)
      return !wide ? rnn_fwd_kernel<CELL, CT, HT, false, false, UNITS_MAX, true>
             : few ? rnn_fwd_kernel<CELL, CT, HT, false, false, UNITS_WIDE_FEW, true>
                   : rnn_fwd_kernel<CELL, CT, HT, false, false, UNITS_WIDE, true>;
#endif
  if constexpr (sizeof(CT) == 4) {
    if (wsplit)
      return streamed ? rnn_fwd_kernel<CELL, CT, HT, true, true>
                      : rnn_fwd_kernel<CELL, CT, HT, false, true>;
  } else {
    if (wide)
      return few ? rnn_fwd_kernel<CELL, CT, HT, false, false, UNITS_WIDE_FEW>
                 : rnn_fwd_kernel<CELL, CT, HT, false, false, UNITS_WIDE>;
  }
  return streamed ? rnn_fwd_kernel<CELL, CT, HT, true, false>
                  : rnn_fwd_kernel<CELL, CT, HT, false, false>;
}

template <int CELL, typename CT, typename HT>
int launch(int T, int B, int H, int D, const Plan& pl, const void* xp0, const void* xp1,
           const float* mask, const void* w_hh, void* wpk, long long wpk_elems,
           const float* b_hh, void* out0, void* out1, void* c0, void* c1, float* h_final,
           long long* phases, cudaStream_t stream) {
  constexpr int G = NumGates<CELL>::G;
  const int kp = (H + 31) / 32 * 32;
  if (!plan_ok<CELL, CT>(pl, H, kp)) return (int)cudaErrorInvalidValue;
  const int kc = pl.kc < kp ? pl.kc : kp;
  const bool streamed = kc < kp;
  const FwdSmem L = plan_smem<CELL, CT>(pl, kp, kc);
  if (L.total > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (streamed &&
      (wpk == nullptr || wpk_elems != (long long)packed_elems<CELL, CT>(pl, kp, D)))
    return (int)cudaErrorInvalidValue;
  // phases: only the instrumented build times a step, and only at bf16 with W resident
#ifdef RNN_FWD_PHASES
  if (phases != nullptr && (sizeof(CT) != 2 || streamed)) return (int)cudaErrorInvalidValue;
#else
  if (phases != nullptr) return (int)cudaErrorInvalidValue;
#endif
  const int units = (pl.R + 15) / 16 * (pl.hc / 8);  // (16 x 8) units a CTA
  auto kernel = pick_kernel<CELL, CT, HT>(streamed, pl.wsplit, pl.wide,
                                          units <= UNITS_WIDE_FEW * WARPS, phases != nullptr);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  if (pl.nc > 8 &&  // clusters of more than 8 CTAs are not portable: allowed per kernel
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return (int)err;
  if (streamed) {  // W packed chunk by chunk, one pass
    PackArgs p = {H, G, pl.nc, pl.hc, kc, kp, (kp + kc - 1) / kc, L.wld, D, w_hh, wpk};
    const size_t words = (size_t)wpk_elems * (pl.wsplit ? 2 : sizeof(CT)) / 16;
    const int blocks = (int)(words / 256 + 1 < 4096 ? words / 256 + 1 : 4096);
    if (pl.wsplit)
      rnn_fwd_pack_w_split<<<blocks, 256, 0, stream>>>(p);
    else
      rnn_fwd_pack_w<CT><<<blocks, 256, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int ncl = (B + pl.R - 1) / pl.R;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.nc * ncl, D, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  FwdArgs a = {};
  a.T = T;
  a.B = B;
  a.H = H;
  a.R = pl.R;
  a.hc = pl.hc;
  a.kp = kp;
  a.kc = kc;
  a.S = pl.S;
  a.blocks = pl.blocks;
  a.xp[0] = xp0;
  a.xp[1] = xp1;
  a.mask = mask;
  a.w_hh = w_hh;
  a.wpk = wpk;
  a.b_hh = b_hh;
  a.out[0] = out0;
  a.out[1] = out1;
  a.cout[0] = c0;
  a.cout[1] = c1;
  a.h_final = h_final;
  a.phases = phases;
  if ((err = cudaLaunchKernelEx(&cfg, kernel, a)) != cudaSuccess) return (int)err;
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
    return cluster_slots(rnn_fwd_kernel<CELL, CT, HT, false, false>, nc, THREADS, out);
  }
};

}  // namespace

extern "C" {

// cell: 0 RNN, 1 GRU, 2 LSTM. cdt_bf16: xp and W_hh are bf16 (else f32).
// hist_bf16: the state history is stored in bf16 (only with cdt_bf16).
// H: a multiple of 8. The plan (from ops/rnn_scan.py fwd_plan): nc CTAs per
// cluster (up to 16; more than 8 is allowed on the kernel) of hc hidden
// columns each, rows batch rows per cluster, W rows resident (kc >= H
// rounded up to 32) or streamed through a ring of wstages stages of kc rows
// each, blocks h row blocks (2, or 1); wsplit (f32 compute): W held in
// shared memory as its three bf16 pieces instead of f32; wide (bf16, W
// resident, one h row block): the large-batch layouts, UNITS_WIDE units a
// warp. wpk: where W
// streams, scratch of wpk_elems elements of the compute dtype (wsplit:
// bf16) for the packed W (fwd_plan's layout; the launcher checks the
// count), else null. phases: null, or (only in a build with
// -DRNN_FWD_PHASES, at bf16 with W resident) [D][nc * clusters][PHASE_WORDS]
// int64 for the time loop's phase times. device: the CUDA
// ordinal the tensors live on (this library carries its own runtime, whose
// current device is not PyTorch's). Returns cudaGetLastError() after the
// launches (0 on success).
int rnn_fwd_launch(int device, int cell, int cdt_bf16, int hist_bf16, int T, int B, int H,
                   int D, int nc, int rows, int hc, int kc, int wstages, int blocks,
                   int wsplit, int wide, const void* xp0, const void* xp1, const float* mask,
                   const void* w_hh,
                   void* wpk, long long wpk_elems, const float* b_hh, void* out0, void* out1,
                   void* c0, void* c1, float* h_final, long long* phases, void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (D < 1 || D > 2 || cell < 0 || cell > 2) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const Plan pl = {nc, rows, hc, kc, wstages, blocks, wsplit, wide};
  return dispatch<Launch>(cell, cdt_bf16, hist_bf16, T, B, H, D, pl, xp0, xp1, mask, w_hh, wpk,
                          wpk_elems, b_hh, out0, out1, c0, c1, h_final, phases,
                          static_cast<cudaStream_t>(stream));
}

// How many clusters of nc CTAs (one a whole SM's shared memory) the card
// holds at once (cudaOccupancyMaxActiveClusters), into *out: fwd_plan's
// choice of rows, and whether a cluster size runs at all. Returns the CUDA
// error.
int rnn_fwd_cluster_slots(int device, int cell, int cdt_bf16, int hist_bf16, int nc, int* out) {
  if (cell < 0 || cell > 2 || nc < 1 || nc > 16) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  return dispatch<Slots>(cell, cdt_bf16, hist_bf16, nc, out);
}

const char* rnn_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
