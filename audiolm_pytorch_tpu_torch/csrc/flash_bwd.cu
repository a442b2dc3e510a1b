// Flash-attention backward for Hopper (sm_90a): dq (K2) with, in the same
// launch, the gradient of the bias given: that of the (2N-1, H) rel-pos
// distance table (K4) or that of an (H, N, M) bias shared over the batch
// (K5); and dk/dv (K3). Each recomputes P = exp(S - lse) tile by tile from
// the forward's row logsumexp, so the (N, M) attention matrix never exists
// in device memory.
//
// Replaces the TPU kernels of the JAX package, ops/pallas/flash_attention.py:
//   K2 `_dq_kernel`      dq = scale * sum_k dS K, dS = P * (dP - Delta)
//   K3 `_dkv_kernel`     dK = scale * dS^T Q, dV = P^T dO, the MQA head sum
//                        folded into the accumulation
//   K4 `_dblocks_kernel` the bias gradient sum_b dS in per-delta-block form,
//                        folded into the table by AD of
//                        ops/relpos.py::delta_bias_blocks; here straight into
//                        dtab[q - k + N - 1, h]: partial sums inside K2's
//                        launch, added in a fixed order by a second pass
//   K5 `_dbias_kernel`   dbias = sum_b dS for a batch-shared (H, N, M) bias,
//                        inside K2's launch
// with the same semantics: masked keys at -1e30, keys past M at -inf, a row
// whose lse is <= -5e29 (every key masked) gets p = 0, padded query rows get
// no gradient. Delta = rowsum(dO * O) comes in precomputed (a torch
// reduction, as the JAX package leaves it to XLA).
//
// What bounds them. At the flagship training shape (B=4, H=8, N=2048, D=64,
// causal, MQA) one causal product over the attended (q, k) pairs is
// 2*D*B*H*N*(N+1)/2 = 8.6 GFLOP against ~17 MB of float32 q and dO and 2 MB
// of k and v, so both kernels are compute-bound: K2 does 3 products (25.8
// GFLOP: 0.156 ms as 3xTF32 at 495 TFLOP/s, 26 us in bf16 at 989), K3 does 4
// (34.4 GFLOP: 0.21 ms as 3xTF32, 35 us in bf16); worked out from the
// shapes, not measured. K4 and K5 need K2's dS tile and nothing else, so
// they live in its launch: each adds one add per attended pair, K4 its
// partial sums (9.2 MB of float32 at the flagship's training shape, written
// once and read once by its second pass), K5 the (H, N, M) float32 dbias
// written once (46 MB at the Fine LM's N = 1201, 14 us at 3.35 TB/s), where
// alone each would redo 2 of K2's 3 products to rebuild dS.
//
// Design, all on the tensor cores through csrc/mma.cuh (mma.sync, cp.async).
//   K2: one block per (batch row, head, 64-row query tile), the longest
//       causal rows first, as four strips of 16 query rows: a warp a strip
//       in bf16; in float32 two, each taking half of every key tile, whose
//       partial dq add at the end in a fixed order (8 warps: float32 holds
//       one block an SM, and 4 warps left the tensor cores waiting). Q and
//       dO are the block's fixed A operands: in bf16 their fragments stay in
//       registers; in float32 they are split into tf32 pairs once, into
//       shared memory in fragment order (registers for both would not fit).
//       The key tiles up to the diagonal stream through two stages of K and
//       V by cp.async, with the (H, N, M) bias's 64x64 float32 block, the
//       table slice and the key flags. Per tile S = Q K^T and dP = dO V^T;
//       the epilogue forms dS = P (dP - Delta) on the accumulators by the
//       masking rule at the end of mma.cuh; dq += dS K takes dS as the A
//       operand straight from the accumulators, each tile's product from
//       zero in float32 (tc::add_tile: dq sums over up to 2049 keys).
//   K4, inside K2 when dtab is given, then a second small pass: each strip
//       stores its 16 rows of the tile's dS skewed in shared memory
//       (element (r, c) at column c - r + 15), so that each of its 79
//       diagonals is a column; a lane sums a column into the strip's row of
//       the tile's 128 delta slots (two buffers, one a tile). After the
//       tile's block barrier, thread i < 128 adds the four strips' slots of
//       the delta it owns there (the block's local delta index = i mod 128),
//       in strip order, to a register, and writes each delta's sum once,
//       when the key tiles have passed it, to the block's row of a scratch
//       buffer (B, H, query tiles, 64 (key tiles + 1)). The second pass,
//       dtab_sum_kernel, adds those rows over the batch rows and then the
//       query tiles, in that order, into dtab. Every sum has a fixed order,
//       so dtab has the same bits every run, as the JAX package's
//       `_dblocks_kernel` sums in a fixed order (atomics had added the
//       partials in an order that changed from run to run). Inside the loop
//       only the strip's warps meet (a named barrier), besides the block
//       barrier a tile that was there already.
//   K5, inside K2 when dbias is given (an instantiation of its own, SUM):
//       the blocks of one (head, query tile), one per batch row, form a
//       thread-block cluster of the largest divisor of B up to 8. Each key
//       tile, every block stores its dS tile over the bias block it has just
//       read and arrives at the cluster's barrier; at the next tile, after
//       its two products, it waits there, and each rank sums its share of
//       the last tile's rows over the ranks in rank order through
//       map_shared_rank and writes them (one barrier a tile, its wait behind
//       a tile's products; four bias buffers, so the next two tiles' blocks
//       load while the cluster reads one tile's dS). With B <= 8 one cluster
//       holds the batch, so each dbias element is written once, in a fixed
//       order, with no atomics: the same bits every run. Only with B > 8
//       (B / cluster clusters per tile) do the clusters' partial tiles meet
//       by atomicAdd, in a buffer the wrapper zeroes. The tiles above the
//       causal diagonal, which no block visits, are written as zeros by the
//       cluster of their query tile (with atomics the zeroed buffer holds
//       them). Each block reads the bias block itself (the cluster's reads
//       meet in L2); it is not passed through distributed shared memory.
//   K3: one block of 4 warps per (query head, b*hk, 64-key tile), key tile 0
//       (the longest causal loop) first; the blocks of one (b*hk, key
//       tile), min(group, 8) of them, form a thread-block cluster, each
//       block taking group / cluster of the kv head's query heads. A block
//       loops over its heads' query tiles from the diagonal on, Q and dO
//       double-buffered by cp.async, with 4 products per tile in FA2's
//       backward order: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK +=
//       dS^T Q, P^T and dS^T going from the accumulators to the A operand
//       in registers, dO and Q the B operands (ldmatrix.trans in bf16). Its
//       partial dk and dv stay in registers; then the head sum runs over
//       distributed shared memory: each block stores its partials in its
//       own shared memory, cluster.sync(), and rank 0 adds them in rank
//       order through map_shared_rank and writes dk and dv once: no
//       atomics, no scratch in device memory, the same bits every run. Its
//       grid is group times the (b*hk, key tile) pairs, 1056 blocks at the
//       Semantic LM's training shape on 132 SMs, where one block per pair
//       looping all 8 heads left one wave waiting on its key-tile-0 blocks.
// wgmma and TMA are later work. Instantiated for D=64.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int ND = BQ + BK - 1; // deltas a tile covers
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
using tc::NEG;
static_assert(BQ == BK, "square tiles: the causal loops start at the diagonal tile");

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// K2: one block per (batch row, head, 64-row query tile), the blocks of one
// (head, query tile) a cluster when K5 runs (see the note at the top). Four
// strips of 16 query rows; a strip's rows of S, dP, dS and its partial dq
// belong to one warp in bf16 and to two in float32, each taking half the
// keys of a tile (float32 holds one block an SM, so it takes its 8 warps
// in one block). K5's sum is instantiated apart (SUM): its registers would
// slow the others.
template <typename T> struct K2Warps {
  static constexpr int per_strip = sizeof(T) == 4 ? 2 : 1;
  static constexpr int threads = 128 * per_strip;
};
// the warps of one strip: a named barrier (1 + strip), or __syncwarp for one warp
template <int WN>
__device__ __forceinline__ void strip_sync(int strip) {
  if constexpr (WN == 1) __syncwarp();
  else tc::bar_sync(1 + strip, 32 * WN);
}
constexpr int TPD = BK + 8;    // K2's float32 tiles' pitch (bias block, dS): 8 mod 32 banks
constexpr int SKP = BK + 16;   // K4's skewed dS rows: a strip's diagonals take BK + 15 columns
constexpr int DSL = 2 * BK;    // K4's delta slots a tile: a key tile meets BQ + BK - 1 deltas
static_assert(TPD % 4 == 0, "16-byte rows");

// Shared memory: two stages of (K tile, V tile, table slice [BQ + BK - 1],
// key flags [BK]); in float32 the tf32 pairs of Q and dO; then, with an
// (H, N, M) bias, its 64x64 blocks, two of them, or four with K5 (dS is
// written over the block just read and stays there while the cluster sums
// it), or with the table's gradient K4's skewed dS rows. Q and dO are
// staged, before the loop, in stage 1's K and V tiles; after it the second
// warps' partial dq meets the first's in stage 0.
template <typename T, int D>
struct DqSmem {
  static constexpr int P = tc::pitch<T, D>();
  static constexpr size_t tile = (size_t)BK * P * sizeof(T);  // BQ == BK rows
  static constexpr size_t stage = 2 * tile + (BQ + 2 * BK) * sizeof(float);
  static constexpr size_t fixed = 2 * (BQ / 16) * tc::AFixed<T, D>::bytes;  // Q, dO by strip
  static constexpr size_t base = 2 * stage + fixed;
  static constexpr size_t ftile = (size_t)BQ * TPD * sizeof(float);
  // K4's skewed rows, then its delta slots: two buffers of four strips
  static constexpr size_t skew = ((size_t)BQ * SKP + 2 * 4 * DSL) * sizeof(float);
  static_assert(skew <= 2 * ftile, "K4's skewed rows fit where a bias's blocks go");
  static_assert((size_t)BQ * TPD * sizeof(float) <= stage, "the partial dq fits in a stage");
  static_assert(tile % 16 == 0 && stage % 16 == 0 && fixed % 16 == 0, "16-byte aligned regions");
};

// K5's sum of one key tile: the blocks of a cluster of csize add their dS
// tiles (at dsm, pitch TPD, each in its own shared memory) in rank order,
// each block over its share of the rows, 16 bytes a read, and write them to
// out = dbias[h] (or add them, where other clusters share the tile)
template <int NT>
__device__ __forceinline__ void batch_sum_rows(const cg::cluster_group& cluster, float* dsm,
                                               float* out, int q0, int k0, int n, int m,
                                               bool atomic) {
  constexpr int V = BK / 4;  // float4s a row
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const int r_lo = rank * BQ / csize, count = ((rank + 1) * BQ / csize - r_lo) * V;
  for (int i = threadIdx.x; i < count; i += NT) {
    const int at = (r_lo + i / V) * (TPD / 4) + i % V;
    float4 sum = reinterpret_cast<const float4*>(cluster.map_shared_rank(dsm, 0))[at];
#pragma unroll
    for (int src = 1; src < MAX_CLUSTER; ++src)
      if (src < csize) {
        const float4 x = reinterpret_cast<const float4*>(cluster.map_shared_rank(dsm, src))[at];
        sum.x += x.x;
        sum.y += x.y;
        sum.z += x.z;
        sum.w += x.w;
      }
    const int r = q0 + r_lo + i / V, c = k0 + 4 * (i % V);
    if (r >= n) continue;
    const float v[4] = {sum.x, sum.y, sum.z, sum.w};
    float* o = out + (size_t)r * m + c;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      if (c + l >= m) break;
      if (atomic) atomicAdd(o + l, v[l]);
      else o[l] = v[l];
    }
  }
}

// K4's second pass: dtab[idx, h] = the sum over the batch rows, then the
// query tiles, of the K2 blocks' partial sums of the delta idx - (n - 1)
// (part: (b, heads, query tiles, 64 (key tiles + 1)); a block writes its
// local deltas a = q0 + BQ - 1 - delta < 64 (its key tiles + 1)); every
// element of dtab written.
constexpr int NT_DTAB = 256;
__global__ void __launch_bounds__(NT_DTAB)
dtab_sum_kernel(const float* __restrict__ part, float* __restrict__ dtab, int b, int heads,
                int n, int m, int causal) {
  const int idx = blockIdx.x * NT_DTAB + threadIdx.x, h = blockIdx.y;
  if (idx >= 2 * n - 1) return;
  const int nqt = (n + BQ - 1) / BQ, arow = BK * ((m + BK - 1) / BK + 1);
  const int delta = idx - (n - 1);
  float sum = 0.f;
  for (int bi = 0; bi < b; ++bi)
    for (int qt = 0; qt < nqt; ++qt) {
      const int q0 = qt * BQ, a = q0 + BQ - 1 - delta;
      const int kv_end = causal ? min(m, q0 + BQ) : m;
      if (a >= 0 && a < BK * ((kv_end + BK - 1) / BK + 1))
        sum += part[((size_t)(bi * heads + h) * nqt + qt) * arow + a];
    }
  dtab[(size_t)idx * heads + h] = sum;
}

template <typename T, int D, bool SUM>
__global__ void __launch_bounds__(K2Warps<T>::threads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, const float* __restrict__ tab,
                    const float* __restrict__ bias, const int8_t* __restrict__ kmask,
                    T* __restrict__ dq, float* __restrict__ dpart, float* __restrict__ dbias,
                    int heads, int group, int n, int m, float scale, int causal) {
  using S = DqSmem<T, D>;
  constexpr int P = S::P;
  constexpr int NT = K2Warps<T>::threads, WN = K2Warps<T>::per_strip;
  constexpr int KW = BK / WN;  // a warp's keys of a tile
  extern __shared__ __align__(16) unsigned char dq_smem[];
  unsigned char* smem = dq_smem;
  auto Ks = [&](int s) { return reinterpret_cast<T*>(smem + s * S::stage); };
  auto Vs = [&](int s) { return reinterpret_cast<T*>(smem + s * S::stage + S::tile); };
  // table slice: Bs[i] = tab[q0 - k0 - (BK - 1) + i + n - 1, h], so
  // the bias of (q0 + r, k0 + c) is Bs[r - c + BK - 1]; then the key flags
  auto Bs = [&](int s) { return reinterpret_cast<float*>(smem + s * S::stage + 2 * S::tile); };
  auto Fs = [&](int s) { return Bs(s) + BQ + BK; };
  // the bias block of tile `it`, then its dS; with K5 four of them, so
  // the cluster reads a tile's dS while the next two tiles' blocks load
  constexpr int NBUF = SUM ? 4 : 2;
  float* dense = reinterpret_cast<float*>(smem + S::base);
  auto Tb = [&](int it) { return dense + (it % NBUF) * BQ * TPD; };

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const int b = blockIdx.x, h = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // the longest causal rows first
  const size_t bh = (size_t)b * heads + h;
  const int tid = threadIdx.x, warp = tid / 32, gq = (tid % 32) / 4, t = tid % 4;
  const int strip = warp % 4, kh = warp / 4, kc0 = kh * KW;  // this warp's rows and keys
  const T* kb = k + (bh / group) * m * D;
  const T* vb = v + (bh / group) * m * D;
  const float* biash = bias != nullptr ? bias + (size_t)h * n * m : nullptr;
  // K4: a strip's dS, skewed so that a diagonal is a column. Element (r, c)
  // of the strip's 16 rows lies on the diagonal of (r - 8, c - 8), and a
  // thread holds both (rows gq and gq + 8), so it adds them first: their
  // sum goes to row gq of its warp's 8 rows, column c - gq + 15. The cells
  // off the band are zeros, written once.
  float* sk = dense + strip * 8 * WN * SKP;
  // K4's delta slots of tile it: dsl(it)[strip * DSL + a - k0] holds the
  // strip's sum of the delta q0 + BQ - 1 - a (a: the block's local index)
  auto dsl = [&](int it) { return dense + BQ * SKP + (it & 1) * 4 * DSL; };
  const int nkt = (m + BK - 1) / BK;
  float* prow = dpart != nullptr
                    ? dpart + (bh * gridDim.z + q0 / BQ) * (size_t)(BK * (nkt + 1)) : nullptr;
  int a_cur = -1;  // the local delta this thread sums now (thread i < DSL owns a = i mod DSL)
  float a_sum = 0.f;

  // causal (n == m): key k is seen by query q iff k <= q
  const int kv_end = causal ? min(m, q0 + BQ) : m;
  const int ntiles = (kv_end + BK - 1) / BK;

  // Tile `it`: K and V into stage it & 1 and the bias block into Tb(it) by
  // cp.async (one group); the table entry and key flag of this thread into
  // registers, which `stash` stores once this tile's compute has hidden
  // their latency.
  float tab_r = 0.f, flag_r = 0.f;
  auto issue = [&](int it) {
    const int k0 = it * BK, s = it & 1;
    tc::cp_tile<T, D, BK, NT>(Ks(s), P, kb, k0, m);
    tc::cp_tile<T, D, BK, NT>(Vs(s), P, vb, k0, m);
    if (biash != nullptr) tc::cp_block_f32<BQ, BK, NT>(Tb(it), TPD, biash, q0, k0, n, m);
    tc::cp_async_commit();
    if (tab != nullptr && tid < ND) tab_r = tc::tab_entry(tab, q0, k0, BK, tid, n, heads, h);
    if (tid < BK) flag_r = tc::key_flag(kmask, b, m, k0 + tid);
  };
  auto stash = [&](int it) {
    const int s = it & 1;
    if (tab != nullptr && tid < ND) Bs(s)[tid] = tab_r;
    if (tid < BK) Fs(s)[tid] = flag_r;
  };

  // Q and dO (in stage 1's K and V tiles) with tile 0; lse (+inf where p =
  // 0: padded or fully masked rows) and Delta of this thread's two rows
  tc::cp_tile<T, D, BQ, NT>(Ks(1), P, q + bh * n * D, q0, n);
  tc::cp_tile<T, D, BQ, NT>(Vs(1), P, g + bh * n * D, q0, n);
  issue(0);
  stash(0);
  const int rl[2] = {strip * 16 + gq, strip * 16 + gq + 8};  // this thread's rows in the tile
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int qp = q0 + rl[ri];
    const float l = qp < n ? lse[bh * n + qp] : INFINITY;
    lse_r[ri] = l > 0.5f * NEG ? l : INFINITY;
    dl_r[ri] = qp < n ? delta[bh * n + qp] : 0.f;
  }
  if (dpart != nullptr)
    for (int i = tid; i < BQ * SKP + 2 * 4 * DSL; i += NT) dense[i] = 0.f;
  tc::cp_async_wait_all();
  __syncthreads();
  typename tc::AFixed<T, D>::type qa, ga;
  if constexpr (sizeof(T) == 4) {
    // a strip's pairs, split by its first warp, read by both after the barrier
    uint4* fixed = reinterpret_cast<uint4*>(smem + 2 * S::stage);
    qa.s = fixed + strip * (tc::AFixed<T, D>::bytes / sizeof(uint4));
    ga.s = qa.s + (BQ / 16) * (tc::AFixed<T, D>::bytes / sizeof(uint4));
    if (kh == 0) {
      qa.load(Ks(1) + strip * 16 * P, P);
      ga.load(Vs(1) + strip * 16 * P, P);
    }
  } else {
    qa.load(Ks(1) + strip * 16 * P, P);
    ga.load(Vs(1) + strip * 16 * P, P);
  }
  __syncthreads();  // stage 1 is free for tile 1

  // K5 (SUM, with dbias): with several clusters per tile (B > 8) their
  // partial sums meet by atomics
  constexpr bool batch_sum = SUM;
  const bool atomic = batch_sum && csize < (int)gridDim.x;
  float* out = batch_sum ? dbias + (size_t)h * n * m : nullptr;  // dbias[h]
  float dqa[D / 8][4];
  tc::zero(dqa);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it & 1, k0 = it * BK;
    const bool next = it + 1 < ntiles;
    // with K5 the bias block's buffer last held tile it - 3's dS, which the
    // cluster read before the barrier of tile it - 2 (waited for at tile it - 1)
    if (next) issue(it + 1);

    float sc[KW / 8][4], ds[KW / 8][4];  // S, then dP and dS: rows queries, columns keys
    tc::zero(sc);
    tc::zero(ds);
    tc::gemm_nk<T, D, KW / 8>(sc, qa, Ks(s) + kc0 * P, P);
    tc::gemm_nk<T, D, KW / 8>(ds, ga, Vs(s) + kc0 * P, P);
    if (batch_sum && it > 0) {
      // K5 of the last tile: every block's dS is in (and the cluster is done
      // with the tile before), so its sum runs in rank order
      tc::cluster_wait();
      batch_sum_rows<NT>(cluster, Tb(it - 1), out, q0, k0 - BK, n, m, atomic);
    }

    const float* bs = Bs(s);
    const float* fs = Fs(s);
    const float* ts = Tb(it);
    // keys above the diagonal meet this warp's rows only near the diagonal
    const bool diag = causal && k0 + kc0 + KW - 1 > q0 + strip * 16;
#pragma unroll
    for (int j = 0; j < KW / 8; ++j) {
      const int c = kc0 + 8 * j + 2 * t;
      const float2 f = *reinterpret_cast<const float2*>(fs + c);
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        float2 bb = make_float2(0.f, 0.f);
        if (tab != nullptr) bb = make_float2(bs[rl[ri] - c + BK - 1], bs[rl[ri] - c + BK - 2]);
        else if (biash != nullptr) bb = *reinterpret_cast<const float2*>(ts + rl[ri] * TPD + c);
        const int qp = q0 + rl[ri];
        const float x0 = tc::score(fmaf(sc[j][2 * ri], scale, bb.x), f.x, diag && k0 + c > qp);
        const float x1 = tc::score(fmaf(sc[j][2 * ri + 1], scale, bb.y), f.y,
                                   diag && k0 + c + 1 > qp);
        ds[j][2 * ri] = tc::exp_rel(x0, lse_r[ri]) * (ds[j][2 * ri] - dl_r[ri]);
        ds[j][2 * ri + 1] = tc::exp_rel(x1, lse_r[ri]) * (ds[j][2 * ri + 1] - dl_r[ri]);
      }
    }
    if (dpart != nullptr) {
      // K4: the strip's diagonals, a lane per column of its skewed rows:
      // column x holds delta q0 - k0 + 16 strip + 15 - x, local index a =
      // k0 + 48 - 16 strip + x. Barriers: the strip's warps only.
      float* row = sk + (kh * 8 + gq) * SKP + kc0 + 2 * t - gq + 15;
#pragma unroll
      for (int j = -1; j < KW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          row[8 * j + e] = (j >= 0 ? ds[j][e] : 0.f) + (j + 1 < KW / 8 ? ds[j + 1][2 + e] : 0.f);
      strip_sync<WN>(strip);
      for (int x = tid % 32 + 32 * kh; x < BK + 15; x += 32 * WN) {
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int r = 0; r < 8 * WN; r += 2) {
          sum0 += sk[r * SKP + x];
          sum1 += sk[(r + 1) * SKP + x];
        }
        dsl(it)[strip * DSL + 48 - 16 * strip + x] = sum0 + sum1;
      }
    }
    if (batch_sum) {
      // K5: dS over the bias block just read (each thread's own elements),
      // for the cluster to sum at the next tile
      tc::store_acc(Tb(it) + strip * 16 * TPD + kc0, TPD, ds);
      tc::cluster_arrive();
    }
    const float one[2] = {1.f, 1.f};
    tc::add_tile<T, D, KW / 8>(dqa, ds, Ks(s) + kc0 * P, P, one);  // dq += dS K

    if (next) {
      stash(it + 1);
      tc::cp_async_wait_all();
    }
    __syncthreads();  // this stage is consumed and the next one has landed
    if (dpart != nullptr && tid < DSL) {
      // K4: the tile's four strips, in order, onto the delta this thread
      // owns in it; a delta the key tiles have passed is written once
      const int a = k0 + ((tid - k0) & (DSL - 1));
      if (a != a_cur) {
        if (a_cur >= 0) prow[a_cur] = a_sum;
        a_cur = a;
        a_sum = 0.f;
      }
      const float* d = dsl(it) + (a - k0);
      a_sum += ((d[0] + d[DSL]) + d[2 * DSL]) + d[3 * DSL];
    }
  }
  if (dpart != nullptr && tid < DSL && a_cur >= 0) prow[a_cur] = a_sum;
  if (batch_sum && ntiles > 0) {
    // K5 of the last tile; no block leaves while the cluster still reads its dS
    tc::cluster_wait();
    batch_sum_rows<NT>(cluster, Tb(ntiles - 1), out, q0, (ntiles - 1) * BK, n, m, atomic);
    tc::cluster_arrive_relaxed();
    tc::cluster_wait();
  }

  if constexpr (WN == 2) {
    // the second warp's partial dq (its half of the keys) onto the first's,
    // in that order, through stage 0
    float* part = reinterpret_cast<float*>(Ks(0)) + strip * 16 * TPD;
    if (kh == 1) tc::store_acc(part, TPD, dqa);
    __syncthreads();
    if (kh == 1) return;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dqa[j][e] += part[(gq + 8 * (e >> 1)) * TPD + 8 * j + 2 * t + (e & 1)];
  }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int qp = q0 + rl[ri];
    if (qp >= n) continue;
    T* o = dq + (bh * n + qp) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      tc::store2(o + 8 * j + 2 * t, dqa[j][2 * ri] * scale, dqa[j][2 * ri + 1] * scale);
  }
  // K5: the keys past the causal diagonal have dS = 0; no block visits them
  if (batch_sum && !atomic && kv_end < m) {
    const int r_lo = rank * BQ / csize, r_hi = (rank + 1) * BQ / csize, cols = m - kv_end;
    for (int i = tid; i < (r_hi - r_lo) * cols; i += NT / WN) {
      const int r = r_lo + i / cols;
      if (q0 + r < n) out[(size_t)(q0 + r) * m + kv_end + i % cols] = 0.f;
    }
  }
}

// K3: one block of 4 warps per (query head of the group, b*hk, 64-key tile),
// the blocks of one (b*hk, key tile) a thread-block cluster (see the note at
// the top). Each warp owns 16 keys: its rows of S^T, dP^T, dK and dV.
constexpr int NT3 = 128;          // K3's threads
constexpr int TP3 = BQ + 4;       // K3's bias tile pitch: rows are queries, read down the keys

// Shared memory: the K and V tiles; two stages of (Q tile, dO tile, lse
// [BQ], Delta [BQ], table slice [BQ + BK - 1]); the key flags; with an
// (H, N, M) bias two of its 64x64 blocks. After the loop the dK and dV
// partials of the cluster's head sum take the stages' place.
template <typename T, int D>
struct DkvSmem {
  static constexpr int P = tc::pitch<T, D>();
  static constexpr size_t tile = (size_t)BK * P * sizeof(T);  // BQ == BK rows
  static constexpr size_t stages = 2 * tile;
  static constexpr size_t stage = 2 * tile + (2 * BQ + BQ + BK) * sizeof(float);
  static constexpr size_t flags = stages + 2 * stage;
  static constexpr size_t base = flags + BK * sizeof(float);
  static constexpr size_t dense = 2 * (size_t)BQ * TP3 * sizeof(float);
  static constexpr int RP = D + 4;  // the partials' pitch in floats
  static constexpr size_t red = 2 * (size_t)BK * RP * sizeof(float);
  static_assert(red <= 2 * stage, "the partials fit in the stages");
  static_assert(tile % 16 == 0 && stage % 16 == 0, "16-byte aligned regions");
};

template <typename T, int D>
__global__ void __launch_bounds__(NT3)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ g, const float* __restrict__ lse,
                     const float* __restrict__ delta, const float* __restrict__ tab,
                     const float* __restrict__ bias, const int8_t* __restrict__ kmask,
                     T* __restrict__ dk, T* __restrict__ dv,
                     int heads, int hk, int n, int m, float scale, int causal) {
  using S = DkvSmem<T, D>;
  constexpr int P = S::P;
  extern __shared__ __align__(16) unsigned char dkv_smem[];
  unsigned char* smem = dkv_smem;
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BK * P;
  auto Qs = [&](int s) { return reinterpret_cast<T*>(smem + S::stages + s * S::stage); };
  auto Gs = [&](int s) { return reinterpret_cast<T*>(smem + S::stages + s * S::stage + S::tile); };
  // lse (+inf where p = 0: padded or fully masked rows), then Delta,
  // then the table slice: the bias of (q0 + c, k0 + r) is at [2 * BQ + c - r + BK - 1]
  auto Ls = [&](int s) {
    return reinterpret_cast<float*>(smem + S::stages + s * S::stage + 2 * S::tile);
  };
  float* Fs = reinterpret_cast<float*>(smem + S::flags);
  auto Ts = [&](int s) { return reinterpret_cast<float*>(smem + S::base) + s * BQ * TP3; };

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const int kvh = blockIdx.y;  // b * hk + kv head
  const int b = kvh / hk, kh = kvh % hk, group = heads / hk;
  const int k0 = blockIdx.z * BK;  // key tile 0, the longest causal loop, first
  const int tid = threadIdx.x, warp = tid / 32, gq = (tid % 32) / 4, t = tid % 4;

  // this block sums the heads kh * group + rank + csize * i of its kv head
  const int q_start = causal ? k0 : 0;
  const int nqt = q_start < n ? (n - q_start + BQ - 1) / BQ : 0;
  const int total = (group / csize) * nqt;

  float pre_row = 0.f, pre_tab = 0.f;  // this thread's lse or Delta, table entry, of the next stage
  auto issue = [&](int it) {
    const int h = kh * group + rank + csize * (it / nqt);
    const int q0 = q_start + (it % nqt) * BQ, s = it & 1;
    const size_t bh = (size_t)b * heads + h;
    tc::cp_tile<T, D, BQ, NT3>(Qs(s), P, q + bh * n * D, q0, n);
    tc::cp_tile<T, D, BQ, NT3>(Gs(s), P, g + bh * n * D, q0, n);
    if (bias != nullptr)
      tc::cp_block_f32<BQ, BK, NT3>(Ts(s), TP3, bias + (size_t)h * n * m, q0, k0, n, m);
    tc::cp_async_commit();
    const int qp = q0 + tid % BQ;
    if (tid < BQ) pre_row = qp < n ? lse[bh * n + qp] : INFINITY;
    else pre_row = qp < n ? delta[bh * n + qp] : 0.f;
    if (tab != nullptr && tid < BQ + BK - 1)
      pre_tab = tc::tab_entry(tab, q0, k0, BK, tid, n, heads, h);
  };
  auto stash = [&](int it) {
    float* ls = Ls(it & 1);
    ls[tid] = tid >= BQ || pre_row > 0.5f * NEG ? pre_row : INFINITY;
    if (tab != nullptr && tid < BQ + BK - 1) ls[2 * BQ + tid] = pre_tab;
  };

  tc::cp_tile<T, D, BK, NT3>(Ks, P, k + (size_t)kvh * m * D, k0, m);
  tc::cp_tile<T, D, BK, NT3>(Vs, P, v + (size_t)kvh * m * D, k0, m);
  if (total > 0) {
    issue(0);  // K and V join its group
    stash(0);
  }
  if (tid < BK) Fs[tid] = tc::key_flag(kmask, b, m, k0 + tid);
  tc::cp_async_wait_all();
  __syncthreads();

  const int kl[2] = {warp * 16 + gq, warp * 16 + gq + 8};  // this thread's keys in the tile
  const float fk[2] = {Fs[kl[0]], Fs[kl[1]]};
  const tc::ASmem<T> ka{Ks + warp * 16 * P, P}, va{Vs + warp * 16 * P, P};
  float dka[D / 8][4], dva[D / 8][4];
  tc::zero(dka);
  tc::zero(dva);

  for (int it = 0; it < total; ++it) {
    const int s = it & 1, q0 = q_start + (it % nqt) * BQ;
    if (it + 1 < total) issue(it + 1);

    float st[BQ / 8][4], dpt[BQ / 8][4];  // S^T and dP^T: rows keys, columns queries
    tc::zero(st);
    tc::zero(dpt);
    tc::gemm_nk<T, D, BQ / 8>(st, ka, Qs(s), P);
    tc::gemm_nk<T, D, BQ / 8>(dpt, va, Gs(s), P);

    const float* ls = Ls(s);
    const float* ts = Ts(s);
    // keys above the diagonal: only in the diagonal tile, and only for some warps
    const bool diag = causal && k0 + warp * 16 + 15 > q0;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1), ri = e / 2, kr = kl[ri];
        const float bc = tab != nullptr ? ls[2 * BQ + c - kr + BK - 1]
                         : bias != nullptr ? ts[c * TP3 + kr] : 0.f;
        const float x = tc::score(fmaf(st[j][e], scale, bc), fk[ri], diag && k0 + kr > q0 + c);
        const float p = tc::exp_rel(x, ls[c]);
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - ls[BQ + c]);
      }
    const float one[2] = {1.f, 1.f};
    tc::add_tile<T, D, BQ / 8>(dva, st, Gs(s), P, one);   // dV += P^T dO
    tc::add_tile<T, D, BQ / 8>(dka, dpt, Qs(s), P, one);  // dK += dS^T Q

    if (it + 1 < total) {
      stash(it + 1);
      tc::cp_async_wait_all();
    }
    __syncthreads();  // this stage is consumed and the next one has landed
  }

  // the head sum over the cluster: each block's partials into its own
  // shared memory, then rank 0 adds them in rank order and writes dk, dv once
  float* red = reinterpret_cast<float*>(smem + S::stages);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float* row = red + kl[ri] * S::RP + 8 * j + 2 * t;
      tc::store2(row, dka[j][2 * ri], dka[j][2 * ri + 1]);
      tc::store2(row + BK * S::RP, dva[j][2 * ri], dva[j][2 * ri + 1]);
    }
  cluster.sync();
  if (rank == 0) {
    for (int i = tid; i < BK * D; i += NT3) {
      const int r = i / D, c = i % D;
      if (k0 + r >= m) continue;
      float sk = 0.f, sv = 0.f;
      for (int src = 0; src < csize; ++src) {
        const float* part = cluster.map_shared_rank(red, src);
        sk += part[r * S::RP + c];
        sv += part[(BK + r) * S::RP + c];
      }
      const size_t o = ((size_t)kvh * m + k0 + r) * D + c;
      dk[o] = from_f<T>(sk * scale);
      dv[o] = from_f<T>(sv);
    }
  }
  cluster.sync();  // every block's partials stay until rank 0 has read them
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void *q, *k, *v, *g, *lse, *delta, *tab, *bias, *kmask;
  int b, heads, hk, n, m;
  float scale;
  int causal;
  cudaStream_t stream;
};

cudaLaunchAttribute cluster_attr(int size) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = size;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

// the largest divisor of x up to MAX_CLUSTER
int cluster_size(int x) {
  int c = MAX_CLUSTER;
  while (x % c) --c;
  return c;
}

// K2; o2 the gradient of the bias given, dtab (K4, then its second pass,
// with its partial sums in part) or dbias (K5), or null
template <typename T, int D>
cudaError_t launch_dq(const Args& a, void* dq, void* o2, void* part) {
  using S = DqSmem<T, D>;
  const bool dense = a.bias != nullptr, sum = dense && o2 != nullptr;
  auto kernel = sum ? flash_bwd_dq_kernel<T, D, true> : flash_bwd_dq_kernel<T, D, false>;
  cudaError_t err = set_smem(kernel, S::base + 4 * S::ftile);
  if (err != cudaSuccess) return err;
  // K5's cluster: the batch rows of one (head, query tile), at most MAX_CLUSTER
  cudaLaunchAttribute attr[1] = {cluster_attr(sum ? cluster_size(a.b) : 1)};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.b, a.heads, (a.n + BQ - 1) / BQ);
  cfg.blockDim = dim3(K2Warps<T>::threads);
  cfg.dynamicSmemBytes = S::base + (sum ? 4 * S::ftile : dense ? 2 * S::ftile
                                    : o2 != nullptr ? S::skew : 0);
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool dtab = !dense && o2 != nullptr;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.tab),
      static_cast<const float*>(a.bias), static_cast<const int8_t*>(a.kmask), static_cast<T*>(dq),
      static_cast<float*>(dtab ? part : nullptr), static_cast<float*>(dense ? o2 : nullptr),
      a.heads, a.heads / a.hk, a.n, a.m, a.scale, a.causal);
  if (err != cudaSuccess || !dtab) return err;
  const dim3 grid((2 * a.n - 1 + NT_DTAB - 1) / NT_DTAB, a.heads);
  dtab_sum_kernel<<<grid, NT_DTAB, 0, a.stream>>>(static_cast<const float*>(part),
                                                  static_cast<float*>(o2), a.b, a.heads, a.n,
                                                  a.m, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  using S = DkvSmem<T, D>;
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = set_smem(kernel, S::base + S::dense);
  if (err != cudaSuccess) return err;
  // the cluster: the query heads of one kv head, at most MAX_CLUSTER of them
  // (with more, each block loops over group / cluster heads)
  const int cluster = cluster_size(a.heads / a.hk);
  cudaLaunchAttribute attr[1] = {cluster_attr(cluster)};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, a.b * a.hk, (a.m + BK - 1) / BK);
  cfg.blockDim = dim3(NT3);
  cfg.dynamicSmemBytes = S::base + (a.bias != nullptr ? S::dense : 0);
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.tab),
      static_cast<const float*>(a.bias), static_cast<const int8_t*>(a.kmask),
      static_cast<T*>(dk), static_cast<T*>(dv), a.heads, a.hk, a.n, a.m, a.scale, a.causal);
}

// which: 0 dq (and the bias's gradient in o2 when not null), 1 dk/dv
template <typename T>
cudaError_t dispatch(int which, int d, const Args& a, void* o1, void* o2, void* part) {
  if (d != 64) return cudaErrorInvalidValue;
  if (a.tab != nullptr && a.bias != nullptr) return cudaErrorInvalidValue;
  if (which == 1) return launch_dkv<T, 64>(a, o1, o2);
  if (o2 != nullptr && (a.tab == nullptr ? a.bias == nullptr : a.n != a.m || part == nullptr))
    return cudaErrorInvalidValue;
  return launch_dq<T, 64>(a, o1, o2, part);
}

int run(int which, const void* q, const void* k, const void* v, const void* g,
        const void* lse, const void* delta, const void* tab, const void* bias,
        const void* kmask, void* o1, void* o2, void* part, int b, int heads, int hk, int n,
        int m, int d, float scale, int causal, int dtype, void* stream) {
  const Args a{q, k, v, g, lse, delta, tab, bias, kmask, b, heads, hk, n, m, scale, causal,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(which, d, a, o1, o2, part);
  if (dtype == 1) return dispatch<__nv_bfloat16>(which, d, a, o1, o2, part);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, g (b*heads, n, d); k, v (b*hk, m, d), in one dtype (0 float32, 1
// bfloat16); lse, delta (b*heads, n) float32; tab (2n-1, heads) float32 or
// null; bias (heads, n, m) float32 or null, at most one of tab and bias;
// kmask (b, m) int8 or null. Each returns a cudaError_t.

// dq (b*heads, n, d) in q's dtype; with dgrad not null also the gradient of
// the bias given, summed over the batch: with tab, dtab (2n-1, heads)
// float32, every element written (needs n == m, and part: float32 scratch
// of b * heads * ceil(n / 64) * 64 (ceil(m / 64) + 1) elements for K4's
// partial sums; K4's second pass is a launch of its own after K2's); with
// bias, dbias (heads, n, m) float32, every element written, zeroed by the
// caller when b > 8 (several clusters per tile meet by atomics there)
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                            const void* lse, const void* delta, const void* tab,
                            const void* bias, const void* kmask, void* dq, void* dgrad,
                            void* part, int b, int heads, int hk, int n, int m, int d,
                            float scale, int causal, int dtype, void* stream) {
  return run(0, q, k, v, g, lse, delta, tab, bias, kmask, dq, dgrad, part, b, heads, hk, n, m,
             d, scale, causal, dtype, stream);
}

// dk, dv (b*hk, m, d) in k's dtype
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                             const void* lse, const void* delta, const void* tab,
                             const void* bias, const void* kmask, void* dk, void* dv, int b,
                             int heads, int hk, int n, int m, int d, float scale, int causal,
                             int dtype, void* stream) {
  return run(1, q, k, v, g, lse, delta, tab, bias, kmask, dk, dv, nullptr, b, heads, hk, n, m,
             d, scale, causal, dtype, stream);
}
