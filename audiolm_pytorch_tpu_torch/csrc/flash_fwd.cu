// Flash-attention forward for Hopper (sm_90a), with the rel-pos bias read
// straight from its (2N-1, H) distance table, or an (H, N, M) float32 bias
// shared over the batch (or a (B, H, N, M) one, a bias a batch row) read
// tile by tile.
//
// Replaces the TPU kernel of the JAX package, ops/pallas/flash_attention.py
// `_kernel` (launched by `_flash_bh`, entries `flash_attention` and
// `_flash_forward`): online-softmax attention with an additive bias, an int8
// key mask, MQA k/v indexed bh / group, causal skipping of key tiles above
// the diagonal, ragged N and M, float32 m/l/acc, and the row logsumexp that a
// backward pass recomputes P from.
//
// What bounds it. At the flagship shape (B=4, H=8, N=2048, D=64, causal) the
// work is 4*B*H*N*N*D/2 = 17.2 GFLOP over ~38 MB of float32 inputs and
// outputs, so it is compute-bound: ~17 us at the 989 TFLOP/s bf16 tensor-core
// peak, ~0.10 ms for float32 as 3xTF32 (three TF32 products at 495 TFLOP/s);
// worked out from the shapes, not measured. With an (H, N, M) bias (the
// Coarse and Fine LMs') the bias adds 46 MB at the Fine LM's training shape
// (B=4, H=8, N=M=1201), 14 us at 3.35 TB/s, read again by each batch row,
// mostly from the 50 MB L2.
//
// Design (warp-specialised, on wgmma and TMA through csrc/wgmma.cuh). One
// block per (b*h, 64-query tile), on a one-dimensional grid (no limit on
// B*H or N but the grid's 2^31 - 1 blocks), the heaviest (last) query tiles
// launched first, of a producer warpgroup and one (bf16) or two (float32) consumer
// warpgroups; setmaxnreg gives the producer's registers to the consumers.
//   - The producer: one thread loads Q once and streams the 64-key K and V
//     tiles into a ring of stages by TMA (3-D maps (64, rows, planes), so a
//     head's ragged last tile reads zeros, never the next head), with full
//     and empty mbarriers. All its threads write each stage's table slice
//     and key flags (loaded a tile ahead into registers). In float32 they
//     also split Q, K and V into tf32 big/small pairs in place, a tile
//     behind the loads so the copy of the next one is in flight.
//   - The (H, N, M) bias (or a batch row's of a (B, H, N, M) one) is read
//     by the consumers themselves, each thread
//     its 32 elements of a tile straight from device memory while the
//     score product runs: its rows (M floats: 602, 603, 1201 in the Coarse
//     and Fine LMs) are not 16-byte multiples, which TMA needs; padding it
//     would copy it each call; and staging it in shared memory by the
//     producer's cp.async cost a third to a half of the kernel's time.
//   - The overlap of one tile's softmax with another's products comes from
//     two or more warpgroups on an SM: in bf16 (one consumer, ~58 KB and 80
//     registers a thread at launch) three blocks share an SM; in float32
//     (226 KB, one block an SM) the block's two consumers share its 64
//     query rows and take the key tiles in turn, each keeping its own (m,
//     l, O), and the second hands its state to the first through shared
//     memory at the end, which merges them in that fixed order: the same
//     bits every run. (A consumer that issued the next tile's S before its
//     softmax was slower: ptxas serialised its products; see PERF.md.)
// A consumer's tile: S = Q K^T is a wgmma (m64n64, Q and K from shared
// memory; float32 as three tf32 products a k-step). The epilogue works on
// the accumulators, whose per-warp layout is mma.sync's C layout, by the
// masking rule at the end of mma.cuh, in base-2 units (y = log2(e) (scale
// q.k + bias), p = 2^(y - m)): a key's flag is added (NEG + y rounds to
// NEG) only on tiles with a flagged key, and the causal test runs only on
// tiles that reach above a warp's rows; the online softmax takes its row
// max and sum across the 4 lanes of a quad. P V: in bf16 a wgmma with P
// from registers and V's tile as a transposed B; in float32 on mma.sync from
// V's split tiles (wgmma's tf32 takes K-major B only; a transposed copy of
// V's pair would take 32 KB more a stage, and the two float32 stages, Q
// and the bias blocks fill ~200 KB), each tile's product from zero and
// added on the CUDA cores (tc::add_tile's reason).
//
// Head dims. The native form is instantiated for D = 32, 64 and 128 (the
// wrapper zero-pads any other D up to 128 into the next of them), and in
// bf16 for D = 256 (the wrapper zero-pads bf16's 129 to 255 to it; the
// library refuses them unpadded); over 128 in float32, and over 256 in
// bf16, the column-sliced form below takes every D that is a multiple of 64
// (the wrapper zero-pads any other D to the next one). A D-wide row is D *
// sizeof(T) / 128 boxes of csrc/wgmma.cuh's 128-byte swizzle (a 32-wide
// bf16 row half of one, its other half read as zeros past the row's end),
// S = Q K^T runs over D * sizeof(T) / 32 k-steps, and P V one product a
// 64-column box. At D = 32 the block shapes are those of D = 64 with
// smaller tiles. At D = 128 every tile doubles, so a block's three stages
// (112 KB) leave room for one block an SM: bf16 always takes the
// two-consumer block; float32 (Q 64 KB and a stage of K and V 128 KB with
// their small parts) one consumer and one stage, and no setmaxnreg (255
// registers each), its ring ordering a tile's split before the next tile's
// load. Simple, not yet fast: see PERF.md.
//
// bf16 at D = 256 (flash_fwd_kernel<bf16, 256, true>). A 64 x 256 tile is
// 32 KB, a stage of K and V 64 KB, and O's 64 x 256 float32 accumulator 128
// registers a consumer thread. Of the two ways to give the block two
// consumer warpgroups, this one takes the rows form (ROWS): the consumers
// own the two 64-row halves of a 128-row query block, each with its own Q
// tile, and both take every key tile of a two-stage ring (Q 64 KB, two
// stages of 64 KB, the slices 2.6 KB: 199,328 bytes), setmaxnreg giving
// them 240 registers each and the producer 24. A key tile, loaded once from
// L2 by TMA, then serves 128 query rows, where the shared-rows form (the D
// = 128 block at 256: two consumers on 64 rows taking the key tiles in
// turn, merged at the end) would load it for every 64: at the flagship's 4
// x 4 x 2049, 320 MB from L2 instead of 588 (worked out from the shapes).
// There is no merge: a row's output comes from one consumer's walk over the
// key tiles in order, so the same bits every run. A consumer stops at its
// own rows' causal end (the first half's is a key tile short of the
// block's) and only hands the later stages back, as a half past N does
// with all of them. The price: half as many blocks as 64-row tiles (the
// Coarse LM's 4 x 2 x 603 runs 40).
//
// Over D = 128 in float32, over 256 in bf16 (flash_fwd_wide_kernel). In
// float32 at D = 256 Q alone with its tf32 small parts is 128 KB, a stage
// of K and V 256 KB: neither the tiles nor the accumulator of the native
// form fit. So a block owns one 64-wide slice of the output's columns and
// keeps a 16 x 64 strip of O a warp; S = Q K^T is summed over the depth 64
// columns at a time, each chunk's Q and K tiles (64 x 64, a pitch of 64 +
// 16 bytes) streamed by cp.async through a ring of two stages with V's
// slice after them, on mma.sync (csrc/mma.cuh's tc::Wide, chunk_nk,
// add_tile: 3xTF32 in float32, each chunk's product from zero). 4 warps,
// 68 KB (float32) or 36 KB (bf16), two blocks an SM, any D. Its price:
// every slice recomputes S, D / 64 times the native form's S products, and
// Q is read again for each key tile (mostly from L2). Slice 0 alone writes
// lse. Right first, not yet fast: PERF.md has its times.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int PLAN_SMS = 132;   // the H100's SMs, which the launch's choice of block fills
constexpr int BF16_DIM = 256;   // bf16's Hopper form over D = 128 (the wrapper pads bf16's
                                // 129 to 255 to it)
using tc::NEG;
constexpr float LN2 = 0.6931471805599453f;

// The block and its shared memory (offsets from its base, which the launch
// leaves 1024-byte aligned: the tiles' swizzle is taken on address bits):
// Q; the ring's stages of (K, V), each an operand tile (with its small
// parts in float32); per stage the table slice [128] ([256] for a 128-row
// block), the key flags [64] and two words that say whether any key of the
// tile is flagged; the barriers. Three shapes of block, chosen by the
// launch from the sizes (fwd_two; ops/kernels/flash_attention.py::
// fwd_plan states the rule):
//   - one consumer warpgroup: bf16 with three stages (~58 KB and 80
//     registers a thread at launch: three blocks share an SM and one's
//     softmax runs while another's products do), float32 where one key
//     tile is all there is (the cross form) with one stage (~97 KB: two
//     blocks an SM, where a second consumer would wait for nothing);
//   - two consumer warpgroups that take the key tiles in turn, with three
//     stages: float32 (226 KB, one block an SM), and bf16 where fewer than
//     two blocks an SM would run (the stage trainers' 4 x 4 x 602: 160
//     blocks), so each block's rows finish in half the time. After the loop
//     the second consumer's (O, m, l) take the first stage's place and the
//     first merges them;
//   - bf16 at D = 256 (ROWS): two consumer warpgroups on the two 64-row
//     halves of a 128-row query block, each its own Q tile, both taking
//     every key tile, with two stages (see the note at the top).
template <typename T, int D, bool TWO>
struct Fwd {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr bool WIDE = D > 64;  // D = 128, or bf16's 256
  static constexpr bool ROWS = D > 128;  // bf16's 256: a consumer a 64-row half
  static constexpr int NC = TWO ? 2 : 1;  // consumer warpgroups
  static constexpr int NT = 128 * (1 + NC);
  static constexpr int QB = ROWS ? 2 * BQ : BQ;  // query rows a block
  static constexpr int MIN_BLOCKS = TWO || (F32 && WIDE) ? 1 : F32 ? 2 : 3;
  // registers a thread: the producer's and a consumer's, within the launch's
  // (65536 / (NT * MIN_BLOCKS), rounded down to 8, each thread), handed over
  // by setmaxnreg (NREG); float32 at D = 128 (one consumer, one block an
  // SM) keeps 255 each; at D = 256 a consumer's O alone takes 128
  static constexpr bool NREG = !(F32 && WIDE);
  static constexpr int PRODUCER_REGS = ROWS ? 24 : TWO ? 56 : F32 ? 40 : 24;
  static constexpr int CONSUMER_REGS = ROWS ? 240 : TWO ? 224 : F32 ? 216 : 136;
  static constexpr int ST = ROWS ? 2 : F32 && !TWO ? 1 : 3;  // stages
  static constexpr int TILE = wg::tile_bytes<T, D>();
  static constexpr int NA = wg::acc_blocks<T, D>();  // the O accumulator's n-blocks
  static constexpr int TP = D + 8;  // the merge's pitch: float2 stores and reads without conflicts
  static constexpr int OPER = F32 ? 2 * TILE : TILE;
  static constexpr int STAGE0 = (ROWS ? NC : 1) * OPER;  // Q: a tile a consumer under ROWS
  static constexpr int STAGE = 2 * OPER;
  static constexpr int MISC = STAGE0 + ST * STAGE;
  static constexpr int SLICE = ROWS ? 256 : 128;  // a stage's table slice: QB + BK - 1 entries
  static constexpr int MISC_STAGE = (SLICE + 64 + 4) * 4;
  static constexpr int BARS = MISC + ST * MISC_STAGE;
  static constexpr size_t bytes = BARS + 128;
  static_assert(bytes <= 232448, "a block's shared memory");
  static_assert(!ROWS || (TWO && !F32), "the rows form: bf16, two consumers");
  static_assert(QB + BK - 1 <= SLICE, "the table slice fits");
  static_assert(NC == 1 || ROWS || ST * STAGE >= (BQ * TP + 2 * BQ) * 4, "the merge fits");
  static_assert((2 + 3 * ST) * 8 <= 128, "the barriers fit");
  static_assert(!NREG || ((PRODUCER_REGS + NC * CONSUMER_REGS) * MIN_BLOCKS * 128 <= 65536
                          && ((65536 / (NT * MIN_BLOCKS)) & ~7) * (1 + NC)
                                 == PRODUCER_REGS + NC * CONSUMER_REGS),
                "setmaxnreg hands over exactly the launch's registers");
  static_assert(NC <= ST, "a consumer waits on no stage two phases ahead");
};

template <typename T, int D, bool TWO>
__global__ void __launch_bounds__(Fwd<T, D, TWO>::NT, Fwd<T, D, TWO>::MIN_BLOCKS)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const float* __restrict__ tab,
                 const float* __restrict__ bias, const int8_t* __restrict__ kmask,
                 T* __restrict__ out, float* __restrict__ lse, int bh_count, int heads, int group,
                 int n, int m, float scale, int causal, int bias_batched) {
  using L = Fwd<T, D, TWO>;
  constexpr int ST = L::ST, NC = L::NC;
  extern __shared__ __align__(1024) unsigned char fwd_smem[];
  unsigned char* sm = fwd_smem;
  if (threadIdx.x == 0 && (tc::smem_u32(sm) & 1023) != 0) __trap();  // the tiles' swizzle
  T* Qs = reinterpret_cast<T*>(sm);
  T* Ql = reinterpret_cast<T*>(sm + L::TILE);  // float32 only
  auto Ks = [&](int s) { return reinterpret_cast<T*>(sm + L::STAGE0 + s * L::STAGE); };
  auto Kl = [&](int s) { return reinterpret_cast<T*>(sm + L::STAGE0 + s * L::STAGE + L::TILE); };
  auto Vs = [&](int s) { return reinterpret_cast<T*>(sm + L::STAGE0 + s * L::STAGE + L::OPER); };
  auto Vl = [&](int s) {
    return reinterpret_cast<T*>(sm + L::STAGE0 + s * L::STAGE + L::OPER + L::TILE);
  };
  // table slice: Bs[i] = log2(e) tab[q0 - k0 - (BK - 1) + i + n - 1, h],
  // so the bias of (q0 + r, k0 + c) is Bs[r - c + BK - 1]; then the key
  // flags; then two words, nonzero where a flag of keys 0-31 (32-63) is
  auto Bs = [&](int s) { return reinterpret_cast<float*>(sm + L::MISC + s * L::MISC_STAGE); };
  auto Fs = [&](int s) { return Bs(s) + L::SLICE; };
  auto As = [&](int s) { return reinterpret_cast<int*>(Bs(s) + L::SLICE + 64); };
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t *qload = bars, *qfull = bars + 1, *loaded = bars + 2, *full = loaded + ST,
           *empty = full + ST;

  // one-dimensional grid: the (b*h)s of a query tile run together
  const int bh = blockIdx.x % bh_count, qt = blockIdx.x / bh_count;
  constexpr int QB = L::QB;
  const int q0 = ((n + QB - 1) / QB - 1 - qt) * QB;  // the longest causal rows first
  const int h = bh % heads, b = bh / heads;
  // bias[h], or bias[b, h] of a per-batch bias
  const float* biash = bias != nullptr ? bias + (size_t)(bias_batched ? bh : h) * n * m : nullptr;
  // causal: key k is seen by query q iff k <= q + off (bottom-right aligned, m >= n)
  const int off = m - n;
  const int kv_end = tc::causal_end(causal, q0 + QB, off, m);
  const int ntiles = (kv_end + BK - 1) / BK;
  // ROWS: the second half's Q tile is loaded only where it has rows
  const int qtiles = L::ROWS && q0 + BQ < n ? 2 : 1;
  const int tid = threadIdx.x;

  if (tid == 0) {
    wg::mbar_init(qload, 1);
    wg::mbar_init(qfull, 128);
    for (int s = 0; s < ST; ++s) {
      wg::mbar_init(&loaded[s], 1);
      wg::mbar_init(&full[s], 128);
      wg::mbar_init(&empty[s], L::ROWS ? 256 : 128);  // ROWS: both consumers take every tile
    }
    wg::fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- the producer ----
    if constexpr (L::NREG) wg::setmaxnreg_dec<L::PRODUCER_REGS>();
    const int kvp = bh / group;
    if (tid == 0) {
      if constexpr (L::ROWS) {
        wg::mbar_arrive_tx(qload, qtiles * L::TILE);
        for (int i = 0; i < qtiles; ++i)
          wg::load_tile<T, D>(Qs + i * (L::TILE / sizeof(T)), &qmap, qload, q0 + i * BQ, bh);
      } else {
        wg::mbar_arrive_tx(qload, L::TILE);
        wg::load_tile<T, D>(Qs, &qmap, qload, q0, bh);
      }
    }
    // Tile it into stage it % ST: K and V by TMA, the table slice and key
    // flags from registers loaded a tile ahead (a load's latency, not the
    // copies', would otherwise pace the ring). A 128-row block's slice of
    // 191 entries: two a thread, the second from thread 128 on.
    float tab_r = 0.f, tab_r2 = 0.f, flag_r = 0.f;
    auto fetch = [&](int it) {
      const int k0 = it * BK;
      if (tab != nullptr && tid < QB + BK - 1)
        tab_r = tc::LOG2E * tc::tab_entry(tab, q0, k0, BK, tid, n, heads, h);
      if constexpr (L::ROWS)
        if (tab != nullptr && tid + 128 < QB + BK - 1)
          tab_r2 = tc::LOG2E * tc::tab_entry(tab, q0, k0, BK, tid + 128, n, heads, h);
      if (tid < BK) flag_r = tc::key_flag(kmask, b, m, k0 + tid);
    };
    auto issue = [&](int it) {
      const int s = it % ST, k0 = it * BK;
      const float tab_it = tab_r, tab_it2 = tab_r2, flag_it = flag_r;
      if (it + 1 < ntiles) fetch(it + 1);
      wg::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
      if (tid == 0) {
        if constexpr (L::F32) wg::mbar_arrive_tx(&loaded[s], 2 * L::TILE);
        else wg::mbar_expect_tx(&full[s], 2 * L::TILE);
        uint64_t* bar = L::F32 ? &loaded[s] : &full[s];
        wg::load_tile<T, D>(Ks(s), &kmap, bar, k0, kvp);
        wg::load_tile<T, D>(Vs(s), &vmap, bar, k0, kvp);
      }
      if (tab != nullptr && tid < QB + BK - 1) Bs(s)[tid] = tab_it;
      if constexpr (L::ROWS)
        if (tab != nullptr && tid + 128 < QB + BK - 1) Bs(s)[tid + 128] = tab_it2;
      if (tid < BK) {
        Fs(s)[tid] = flag_it;
        const unsigned any = __ballot_sync(0xffffffffu, flag_it != 0.f);
        if (tid % 32 == 0) As(s)[tid / 32] = any != 0u;
      }
      if constexpr (!L::F32) wg::mbar_arrive(&full[s]);
    };
    // float32: tile it's copies landed; split them, then hand the stage over
    auto finish = [&](int it) {
      const int s = it % ST;
      wg::mbar_wait(&loaded[s], (it / ST) & 1);
      wg::split_tile<L::TILE>(reinterpret_cast<float*>(Ks(s)), reinterpret_cast<float*>(Kl(s)),
                              tid, 128);
      wg::split_tile<L::TILE>(reinterpret_cast<float*>(Vs(s)), reinterpret_cast<float*>(Vl(s)),
                              tid, 128);
      wg::fence_proxy_async();
      wg::mbar_arrive(&full[s]);
    };
    fetch(0);
    if (ntiles > 0) issue(0);
    wg::mbar_wait(qload, 0);
    if constexpr (L::F32) {
      wg::split_tile<L::TILE>(reinterpret_cast<float*>(Qs), reinterpret_cast<float*>(Ql), tid,
                              128);
      wg::fence_proxy_async();
    }
    wg::mbar_arrive(qfull);
    for (int it = 1; it < ntiles; ++it) {
      // one stage: tile it - 1 handed over (and consumed) before tile it loads
      if constexpr (L::F32 && ST == 1) finish(it - 1);
      issue(it);
      if constexpr (L::F32 && ST > 1) finish(it - 1);
    }
    if constexpr (L::F32)
      if (ntiles > 0) finish(ntiles - 1);
    return;
  }

  // ---- the consumers: warpgroup c takes the key tiles c, c + NC, ...; in
  // the rows form every key tile, for its own 64-row half ----
  if constexpr (L::NREG) wg::setmaxnreg_inc<L::CONSUMER_REGS>();
  const int c = tid / 128 - 1, ctid = tid % 128, warp = ctid / 32, g = (ctid % 32) / 4,
            t = ctid % 4;
  const int qc = L::ROWS ? q0 + c * BQ : q0;  // this consumer's first query row
  const T* Qc = L::ROWS ? Qs + c * (L::TILE / sizeof(T)) : Qs;
  const int rl[2] = {warp * 16 + g, warp * 16 + g + 8};  // this thread's rows in the tile
  // this thread's rows of the (H, N, M) bias (rows past n: none)
  const float* brow[2] = {biash != nullptr && qc + rl[0] < n ? biash + (size_t)(qc + rl[0]) * m
                                                             : nullptr,
                          biash != nullptr && qc + rl[1] < n ? biash + (size_t)(qc + rl[1]) * m
                                                             : nullptr};
  // the rows form: the key tiles this half's rows attend (none for a half
  // past n); the block's later ones it only hands back
  const int own = !L::ROWS ? ntiles
                  : qc >= n ? 0 : (tc::causal_end(causal, qc + BQ, off, m) + BK - 1) / BK;
  float m_i[2] = {NEG, NEG}, l_i[2] = {0.f, 0.f};
  float o[4 * L::NA];
#pragma unroll
  for (int i = 0; i < 4 * L::NA; ++i) o[i] = 0.f;
  wg::mbar_wait(qfull, 0);

  for (int it = L::ROWS ? 0 : c; it < ntiles; it += L::ROWS ? 1 : NC) {
    const int s = it % ST, k0 = it * BK;
    wg::mbar_wait(&full[s], (it / ST) & 1);
    if (L::ROWS && it >= own) {
      wg::mbar_arrive(&empty[s]);
      continue;
    }
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wg::fence_acc(sc);
    wg::wgmma_fence();
    wg::gemm_nk<T, D>(sc, Qc, Ql, Ks(s), Kl(s));
    // The (H, N, M) bias: this thread's 32 elements straight from device
    // memory (mostly L2: the batch rows of a head run together), loaded
    // while the product runs. Its rows (M floats) are not 16-byte multiples,
    // which TMA needs; cp.async of 4 bytes by the producer, or of shifted
    // 16-byte chunks read back by scalar loads, took a third to a half of
    // the kernel's time at the Fine LM's shape (PERF.md).
    float bv[32];
    if (biash != nullptr) {
      const bool whole = k0 + BK <= m;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float* row = brow[(i / 2) & 1];
        const int kc = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        bv[i] = row != nullptr && (whole || kc < m) ? __ldg(row + kc) : 0.f;
      }
    }
    wg::wgmma_wait<0>();
    wg::fence_acc(sc);

    // The scores in base-2 units, y = log2(e) (scale q.k + bias) (the table
    // pre-scaled by the producer), so each p is one subtraction and one SFU
    // op: 2^(y - m), exactly 1 where y == m. By the masking rule of mma.cuh
    // (tc::score), a key's flag (NEG or -inf) is added (y + NEG rounds to
    // NEG, as |y| < 2^75), only on tiles with a flagged key, and the causal
    // mask is tested only on tiles that reach above this warp's rows.
    const float* bs = Bs(s) + (L::ROWS ? c * BQ : 0);  // this half's rows of the slice
    const float* fs = Fs(s);
    const float sl = scale * tc::LOG2E;
    const bool diag = causal && tc::above(k0 + BK - 1, qc + warp * 16, off);
    const bool flagged = As(s)[0] || As(s)[1];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int cc = 8 * j + 2 * t;
      const float2 f = flagged || diag ? *reinterpret_cast<const float2*>(fs + cc)
                                       : make_float2(0.f, 0.f);
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        float2 bb = make_float2(0.f, 0.f);
        if (tab != nullptr) {
          bb = make_float2(bs[rl[ri] - cc + BK - 1], bs[rl[ri] - cc + BK - 2]);
        } else if (biash != nullptr) {
          bb = make_float2(tc::LOG2E * bv[4 * j + 2 * ri], tc::LOG2E * bv[4 * j + 2 * ri + 1]);
        }
        float y0 = fmaf(sc[4 * j + 2 * ri], sl, bb.x), y1 = fmaf(sc[4 * j + 2 * ri + 1], sl, bb.y);
        if (diag) {
          const int qp = qc + rl[ri];
          y0 = tc::above(k0 + cc, qp, off) ? fminf(NEG, f.x) : y0 + f.x;
          y1 = tc::above(k0 + cc + 1, qp, off) ? fminf(NEG, f.y) : y1 + f.y;
        } else if (flagged) {
          y0 += f.x;
          y1 += f.y;
        }
        sc[4 * j + 2 * ri] = y0;
        sc[4 * j + 2 * ri + 1] = y1;
        mx[ri] = fmaxf(mx[ri], fmaxf(y0, y1));
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 1));
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 2));
      const float m_new = fmaxf(m_i[ri], mx[ri]);
      alpha[ri] = tc::ex2(m_i[ri] - m_new);
      m_i[ri] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = tc::ex2(sc[i] - m_i[(i / 2) & 1]);
      sc[i] = p;
      rs[(i / 2) & 1] += p;
    }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      rs[ri] += __shfl_xor_sync(0xffffffffu, rs[ri], 1);
      rs[ri] += __shfl_xor_sync(0xffffffffu, rs[ri], 2);
      l_i[ri] = l_i[ri] * alpha[ri] + rs[ri];
    }
    // O = O * alpha + P V
    if constexpr (L::F32) {
      wg::add_pk_split<D, true>(o, sc, reinterpret_cast<const float*>(Vs(s)),
                                reinterpret_cast<const float*>(Vl(s)), alpha);
    } else {
#pragma unroll
      for (int i = 0; i < 4 * L::NA; ++i) o[i] *= alpha[(i / 2) & 1];
      wg::fence_acc(o);
      uint32_t pa[4][4];
      wg::gemm_pk<L::NA / 8>(o, sc, pa, reinterpret_cast<const __nv_bfloat16*>(Vs(s)));
      wg::wgmma_wait<0>();
      wg::fence_acc(o);
    }
    wg::mbar_arrive(&empty[s]);
  }

  // two consumers on one set of rows: the second's (O, m, l) into the first
  // stage; the first merges them (the rows form: each writes its own rows)
  constexpr bool MERGE = NC == 2 && !L::ROWS;
  float* mo = reinterpret_cast<float*>(sm + L::STAGE0);
  float* mm = mo + BQ * L::TP;
  float* ml = mm + BQ;
  if constexpr (MERGE) {
    tc::bar_sync(1, 256);
    if (c == 1) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int ri = 0; ri < 2; ++ri)
          tc::store2(mo + rl[ri] * L::TP + 8 * j + 2 * t, o[4 * j + 2 * ri],
                     o[4 * j + 2 * ri + 1]);
      if (t == 0) {
        mm[rl[0]] = m_i[0], mm[rl[1]] = m_i[1];
        ml[rl[0]] = l_i[0], ml[rl[1]] = l_i[1];
      }
    }
    tc::bar_sync(1, 256);
    if (c == 1) return;
  }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float mn = m_i[ri], a0 = 1.f, a1 = 0.f, l = l_i[ri];
    if constexpr (MERGE) {
      const float m1 = mm[rl[ri]];
      mn = fmaxf(m_i[ri], m1);
      a0 = tc::ex2(m_i[ri] - mn), a1 = tc::ex2(m1 - mn);
      l = l_i[ri] * a0 + ml[rl[ri]] * a1;
    }
    const int qp = qc + rl[ri];
    if (qp >= n) continue;
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    T* orow = out + ((size_t)bh * n + qp) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      float2 o1 = make_float2(0.f, 0.f);
      if constexpr (MERGE) o1 = *reinterpret_cast<const float2*>(mo + rl[ri] * L::TP + 8 * j + 2 * t);
      tc::store2(orow + 8 * j + 2 * t, (o[4 * j + 2 * ri] * a0 + o1.x * a1) * inv,
                 (o[4 * j + 2 * ri + 1] * a0 + o1.y * a1) * inv);
    }
    // lse in natural units; a row whose keys are all masked keeps the masked
    // score, NEG, as its max (as the plain version's logsumexp does)
    if (t == 0)
      lse[(size_t)bh * n + qp] = (mn == NEG ? NEG : mn * LN2) + logf(l == 0.f ? 1.f : l);
  }
}

// ---- Head dims over 128: the column-sliced form (see the note at the top) ----
constexpr int WIDE_NT = 128;  // 4 warps, each 16 query rows
constexpr int WIDE_BLOCKS = 2;

// One block per (b*h, output slice, 64-query tile), on a one-dimensional
// grid, the longest causal rows first. Its ring items, a key tile's D / 64 +
// 1 of them: the chunks of (Q, K) for S = Q K^T, then V's slice for O += P
// V. The masking rule is K1's, each element's table entry, key flag and
// (H, N, M) bias read from device memory (L1 and L2) in the epilogue. Every
// slice forms the same S and softmax; slice 0 alone writes lse.
template <typename T>
__global__ void __launch_bounds__(WIDE_NT, WIDE_BLOCKS)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ tab, const float* __restrict__ bias,
                      const int8_t* __restrict__ kmask, T* __restrict__ out,
                      float* __restrict__ lse, int bh_count, int heads, int group, int n, int m,
                      int d, float scale, int causal, int bias_batched) {
  using W = tc::Wide<T>;
  constexpr int P = W::P, WC = tc::WC;
  extern __shared__ __align__(16) unsigned char fwd_wide_smem[];
  auto X = [&](int s) { return reinterpret_cast<T*>(fwd_wide_smem + s * W::STAGE); };
  auto Y = [&](int s) { return reinterpret_cast<T*>(fwd_wide_smem + s * W::STAGE + W::TILE); };
  const int nch = d / WC;  // chunks of the depth, and slices of the output
  const int bh = blockIdx.x % bh_count, slice = blockIdx.x / bh_count % nch;
  const int qt = blockIdx.x / bh_count / nch;
  const int q0 = ((n + BQ - 1) / BQ - 1 - qt) * BQ;  // the longest causal rows first
  const int h = bh % heads, b = bh / heads;
  const float* biash = bias != nullptr ? bias + (size_t)(bias_batched ? bh : h) * n * m : nullptr;
  const int off = m - n;
  const int kv_end = tc::causal_end(causal, q0 + BQ, off, m);
  const int ntiles = (kv_end + BK - 1) / BK;
  const int per = nch + 1, nitems = per * ntiles;
  const T* qb = q + (size_t)bh * n * d;
  const T* kb = k + (size_t)(bh / group) * m * d;
  const T* vb = v + (size_t)(bh / group) * m * d;
  auto issue = [&](int i) {
    const int s = i & 1, c = i % per, k0 = i / per * BK;
    if (c < nch) {
      tc::cp_chunk<T, WIDE_NT>(X(s), qb, q0, n, c * WC, d);
      tc::cp_chunk<T, WIDE_NT>(Y(s), kb, k0, m, c * WC, d);
    } else {
      tc::cp_chunk<T, WIDE_NT>(X(s), vb, k0, m, slice * WC, d);
    }
    tc::cp_async_commit();
  };

  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int rl[2] = {warp * 16 + g, warp * 16 + g + 8};  // this thread's rows in the tile
  const float* brow[2] = {biash != nullptr && q0 + rl[0] < n ? biash + (size_t)(q0 + rl[0]) * m
                                                             : nullptr,
                          biash != nullptr && q0 + rl[1] < n ? biash + (size_t)(q0 + rl[1]) * m
                                                             : nullptr};
  const float sl = scale * tc::LOG2E;
  float m_i[2] = {NEG, NEG}, l_i[2] = {0.f, 0.f};
  float o[8][4], sc[8][4];
  tc::zero(o);
  tc::zero(sc);
  if (nitems > 0) issue(0);
  for (int i = 0; i < nitems; ++i) {
    tc::cp_async_wait_all();
    __syncthreads();  // item i has landed; every warp is done with item i - 1's stage
    if (i + 1 < nitems) issue(i + 1);
    const int s = i & 1, c = i % per, k0 = i / per * BK;
    if (c == 0) tc::zero(sc);
    if (c < nch) {
      tc::chunk_nk<T>(sc, X(s), Y(s));
      continue;
    }
    // the scores in base-2 units by K1's masking rule (tc::score): the
    // key's flag added (y + NEG rounds to NEG), NEG above the diagonal
    // unless the flag is -inf
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e / 2, kp = k0 + 8 * j + 2 * t + (e & 1), qp = q0 + rl[ri];
        float bb = 0.f;
        if (tab != nullptr) {
          const int idx = qp - kp + n - 1;
          bb = idx >= 0 && idx < 2 * n - 1 ? tc::LOG2E * tab[(size_t)idx * heads + h] : 0.f;
        } else if (brow[ri] != nullptr && kp < m) {
          bb = tc::LOG2E * __ldg(brow[ri] + kp);
        }
        const float f = tc::key_flag(kmask, b, m, kp);
        float y = fmaf(sc[j][e], sl, bb);
        y = causal && tc::above(kp, qp, off) ? fminf(NEG, f) : y + f;
        sc[j][e] = y;
        mx[ri] = fmaxf(mx[ri], y);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 1));
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 2));
      const float m_new = fmaxf(m_i[ri], mx[ri]);
      alpha[ri] = tc::ex2(m_i[ri] - m_new);
      m_i[ri] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = tc::ex2(sc[j][e] - m_i[e / 2]);
        sc[j][e] = p;
        rs[e / 2] += p;
      }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      rs[ri] += __shfl_xor_sync(0xffffffffu, rs[ri], 1);
      rs[ri] += __shfl_xor_sync(0xffffffffu, rs[ri], 2);
      l_i[ri] = l_i[ri] * alpha[ri] + rs[ri];
    }
    tc::add_tile<T, WC, 8>(o, sc, X(s), P, alpha);  // O = O * alpha + P V (the slice)
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int qp = q0 + rl[ri];
    if (qp >= n) continue;
    const float l = l_i[ri], inv = 1.f / (l == 0.f ? 1.f : l);
    T* orow = out + ((size_t)bh * n + qp) * d + slice * WC;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      tc::store2(orow + 8 * j + 2 * t, o[j][2 * ri] * inv, o[j][2 * ri + 1] * inv);
    if (slice == 0 && t == 0)
      lse[(size_t)bh * n + qp] = (m_i[ri] == NEG ? NEG : m_i[ri] * LN2) + logf(l == 0.f ? 1.f : l);
  }
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* tab,
                        const void* bias, const void* kmask, void* out, void* lse, int bh,
                        int heads, int group, int n, int m, int d, float scale, int causal,
                        int bias_batched, cudaStream_t stream) {
  using W = tc::Wide<T>;
  static unsigned sized = 0;  // the devices whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 32 || !(sized >> dev & 1))) {
    err = cudaFuncSetAttribute(flash_fwd_wide_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)W::RING);
    if (err == cudaSuccess) sized |= 1u << dev;
  }
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)bh * (d / tc::WC) * ((n + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;  // the grid's x limit, 2^31 - 1
  flash_fwd_wide_kernel<T><<<(unsigned)blocks, WIDE_NT, W::RING, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(tab), static_cast<const float*>(bias),
      static_cast<const int8_t*>(kmask), static_cast<T*>(out), static_cast<float*>(lse), bh,
      heads, group, n, m, d, scale, causal, bias_batched);
  return cudaGetLastError();
}

// a head dim the column-sliced form takes: over 128 in float32 and over
// BF16_DIM in bf16, a multiple of its chunk
bool wide_dim(int d, bool bf16) { return d > (bf16 ? BF16_DIM : 128) && d % tc::WC == 0; }

// two consumer warpgroups a block (fwd_plan in ops/kernels/flash_attention.py);
// at D = 128 one shape a dtype: two in bf16, one in float32; at bf16's 256
// two, the rows form
bool fwd_two(bool f32, int bh, int n, int m, int d) {
  if (d > 64) return !f32;
  return f32 ? m > BK : (long long)bh * ((n + BQ - 1) / BQ) < 2 * PLAN_SMS;
}

template <typename T, int D, bool TWO>
cudaError_t launch(const void* q, const void* k, const void* v, const void* tab,
                   const void* bias, const void* kmask, void* out, void* lse, int bh, int heads,
                   int group, int n, int m, float scale, int causal, int bias_batched,
                   cudaStream_t stream) {
  using L = Fwd<T, D, TWO>;
  CUtensorMap qm, km, vm;
  cudaError_t err = wg::tile_map(&qm, q, sizeof(T), n, bh, D);
  if (err == cudaSuccess) err = wg::tile_map(&km, k, sizeof(T), m, bh / group, D);
  if (err == cudaSuccess) err = wg::tile_map(&vm, v, sizeof(T), m, bh / group, D);
  static unsigned sized = 0;  // the devices whose attribute is set, once per instantiation
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 32 || !(sized >> dev & 1))) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, D, TWO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
    if (err == cudaSuccess) sized |= 1u << dev;
  }
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)bh * ((n + L::QB - 1) / L::QB);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;  // the grid's x limit, 2^31 - 1
  flash_fwd_kernel<T, D, TWO><<<(unsigned)blocks, L::NT, L::bytes, stream>>>(
      qm, km, vm, static_cast<const float*>(tab), static_cast<const float*>(bias),
      static_cast<const int8_t*>(kmask), static_cast<T*>(out), static_cast<float*>(lse), bh,
      heads, group, n, m, scale, causal, bias_batched);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_shape(bool two, const void* q, const void* k, const void* v, const void* tab,
                         const void* bias, const void* kmask, void* out, void* lse, int bh,
                         int heads, int group, int n, int m, float scale, int causal,
                         int bias_batched, cudaStream_t stream) {
  if constexpr (D > 64)  // one block shape a dtype (fwd_two)
    return launch<T, D, sizeof(T) == 2>(q, k, v, tab, bias, kmask, out, lse, bh, heads, group,
                                        n, m, scale, causal, bias_batched, stream);
  else
    return two ? launch<T, D, true>(q, k, v, tab, bias, kmask, out, lse, bh, heads, group, n, m,
                                    scale, causal, bias_batched, stream)
               : launch<T, D, false>(q, k, v, tab, bias, kmask, out, lse, bh, heads, group, n,
                                     m, scale, causal, bias_batched, stream);
}

template <typename T>
cudaError_t launch_dim(int d, const void* q, const void* k, const void* v, const void* tab,
                       const void* bias, const void* kmask, void* out, void* lse, int bh,
                       int heads, int group, int n, int m, float scale, int causal,
                       int bias_batched, cudaStream_t stream) {
  constexpr bool BF16 = sizeof(T) == 2;
  if (wide_dim(d, BF16))
    return launch_wide<T>(q, k, v, tab, bias, kmask, out, lse, bh, heads, group, n, m, d, scale,
                          causal, bias_batched, stream);
  const bool two = fwd_two(sizeof(T) == 4, bh, n, m, d);
  switch (d) {
    case 32:
      return launch_shape<T, 32>(two, q, k, v, tab, bias, kmask, out, lse, bh, heads, group, n,
                                 m, scale, causal, bias_batched, stream);
    case 64:
      return launch_shape<T, 64>(two, q, k, v, tab, bias, kmask, out, lse, bh, heads, group, n,
                                 m, scale, causal, bias_batched, stream);
    case 128:
      return launch_shape<T, 128>(two, q, k, v, tab, bias, kmask, out, lse, bh, heads, group,
                                  n, m, scale, causal, bias_batched, stream);
    case BF16_DIM:  // bf16 only (float32 at 256 is column-sliced); 129-255 refused unpadded
      if constexpr (BF16)
        return launch<T, BF16_DIM, true>(q, k, v, tab, bias, kmask, out, lse, bh, heads, group,
                                         n, m, scale, causal, bias_batched, stream);
      break;
  }
  return cudaErrorInvalidValue;
}

// the plan of one block shape: consumers, stages, shared memory, blocks an SM
template <typename L>
void plan_of(int* out) {
  out[0] = L::NC;
  out[1] = L::ST;
  out[2] = (int)L::bytes;
  out[3] = L::MIN_BLOCKS;
}

template <typename T, int D>
void fwd_plan_of(bool two, int* out) {
  if constexpr (D > 64) plan_of<Fwd<T, D, sizeof(T) == 2>>(out);
  else if (two) plan_of<Fwd<T, D, true>>(out);
  else plan_of<Fwd<T, D, false>>(out);
}

}  // namespace

// q (bh, n, d); k, v (bh / group, m, d), d in 32, 64, 128, in bf16 256,
// or over those (float32 128, bf16 256) a multiple of 64; tab (2n-1, heads)
// float32 or null; bias float32 or null, at most one of the two: (heads,
// n, m) shared over the batch, or with bias_batched (bh / heads, heads, n,
// m); kmask (bh / heads, m) int8 or null; out (bh, n, d) in q's type; lse
// (bh, n) float32. q, k, v and bias 16-byte aligned. dtype 0 = float32, 1 =
// bfloat16. Returns a cudaError_t. (bias_batched comes last, after the
// stream: a library built before it takes the same call and ignores it, as
// tools/torch_flash_parent_ab.py loads an older checkout's behind these
// wrappers.)
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* tab,
                         const void* bias, const void* kmask, void* out, void* lse, int bh,
                         int heads, int group, int n, int m, int d, float scale, int causal,
                         int dtype, void* stream, int bias_batched) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tab != nullptr && bias != nullptr) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_dim<float>(d, q, k, v, tab, bias, kmask, out, lse, bh, heads, group, n, m,
                             scale, causal, bias_batched, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(d, q, k, v, tab, bias, kmask, out, lse, bh, heads, group,
                                     n, m, scale, causal, bias_batched, s);
  return cudaErrorInvalidValue;
}

// K1's block for these sizes, head dim and dtype: out[0] its consumer
// warpgroups, out[1] the ring's stages, out[2] its shared memory in bytes,
// out[3] the blocks an SM it is built for (ops/kernels/flash_attention.py::
// fwd_plan mirrors it)
extern "C" int flash_fwd_plan(int bh, int n, int m, int d, int dtype, int* out) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (wide_dim(d, dtype == 1)) {  // the column-sliced form: one consumer of the ring, two stages
    out[0] = 1;
    out[1] = 2;
    out[2] = (int)(dtype == 0 ? tc::Wide<float>::RING : tc::Wide<__nv_bfloat16>::RING);
    out[3] = WIDE_BLOCKS;
    return cudaSuccess;
  }
  const bool two = fwd_two(dtype == 0, bh, n, m, d);
  switch (d * 2 + dtype) {
    case 64: fwd_plan_of<float, 32>(two, out); break;
    case 65: fwd_plan_of<__nv_bfloat16, 32>(two, out); break;
    case 128: fwd_plan_of<float, 64>(two, out); break;
    case 129: fwd_plan_of<__nv_bfloat16, 64>(two, out); break;
    case 256: fwd_plan_of<float, 128>(two, out); break;
    case 257: fwd_plan_of<__nv_bfloat16, 128>(two, out); break;
    case 2 * BF16_DIM + 1: fwd_plan_of<__nv_bfloat16, BF16_DIM>(two, out); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}
