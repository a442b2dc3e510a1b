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
// Design, all on the tensor cores (K2 through csrc/mma.cuh: mma.sync, cp.async).
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
//   K3 (warp-specialised, on wgmma and TMA through csrc/wgmma.cuh): one
//       block per (query head set, b*hk, 64-key tile, query chunk) of a
//       producer warpgroup and two consumer warpgroups; the blocks of one
//       (b*hk, key tile, chunk), min(group, 8) of them, form a thread-block
//       cluster, each taking group / cluster of the kv head's query heads.
//       K and V are loaded once by TMA (in float32 split once into tf32
//       big/small pairs in place, by tc::to_tf32's integer rounding); Q and
//       dO stream through a ring of stages by TMA, lse, Delta and the table
//       slice from registers loaded an item ahead (the (H, N, M) bias is
//       read by the consumers from device memory, as K1 reads it),
//       with full and empty mbarriers. The two consumers take the (head,
//       query tile) items in turn, from the diagonal on, each with its
//       partial dk and dv in registers: S^T = K Q^T and dP^T = V dO^T are
//       wgmma products (K-major A and B from shared memory; float32 as three
//       tf32 products a k-step); the epilogue forms P and dS = P (dP -
//       Delta) on the accumulators in base-2 units (lse pre-scaled), the
//       key flags added only when the tile has one; dV += P^T dO and dK +=
//       dS^T Q take P^T and dS^T from registers: in bf16 as wgmma with dO's
//       and Q's tiles as transposed B, in float32 on mma.sync from their
//       split tiles (wgmma's tf32 takes K-major B only, and transposed
//       copies of the two pairs would take 64 KB a stage, where K, V and two
//       stages already fill 226 KB of 227), each tile's product from zero in
//       float32 (tc::add_tile's reason). At the end the second consumer's
//       partials join the first's, then the head sum runs over distributed
//       shared memory: rank 0 adds the blocks' sums in rank order through
//       map_shared_rank and writes dk and dv once. Where that grid is under
//       one block per SM (the cross form: 4 x 8 x 2049 over 17 keys is one
//       key tile, 32 blocks), the query range is split into chunks of at
//       least 4 query tiles over more blocks, each cluster's rank 0 writes
//       its chunk's partial into scratch (allocated on the stream by the
//       launcher), and a second pass, dkv_sum_kernel, adds the chunks in
//       order (launches_dkv counts one call). No atomics anywhere: the same
//       bits every run. The plan (cluster, chunks) is dkv_plan, which
//       ops/kernels/flash_attention.py::dkv_plan states for the tests.
// Instantiated for D=64.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "wgmma.cuh"

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

  // causal: key k is seen by query q iff k <= q + off (bottom-right aligned, m >= n)
  const int off = m - n;
  const int kv_end = tc::causal_end(causal, q0 + BQ, off, m);
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
    const bool diag = causal && tc::above(k0 + kc0 + KW - 1, q0 + strip * 16, off);
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
        const float x0 = tc::score(fmaf(sc[j][2 * ri], scale, bb.x), f.x,
                                   diag && tc::above(k0 + c, qp, off));
        const float x1 = tc::score(fmaf(sc[j][2 * ri + 1], scale, bb.y), f.y,
                                   diag && tc::above(k0 + c + 1, qp, off));
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

// K3: one block per (query head set, b*hk, 64-key tile, query chunk) of a
// producer warpgroup and consumers (see the note at the top). The blocks
// of one (b*hk, key tile, query chunk) form a thread-block cluster over the
// kv head's query heads.
constexpr int PLAN_SMS = 132;  // the H100's SMs, which the launch plan fills

// Shared memory (offsets from a 1024-byte aligned base): K and V, each an
// operand tile (with its small parts in float32), fixed for the block; the
// ring's stages of (Q, dO); per stage lse [64], Delta [64] and the table
// slice [128]; the key flags [64] and two words that say whether any is
// set; the barriers. After the loop the dK and dV partials of the block's
// sums take the stages' place. One consumer warpgroup (bf16, ~85 KB and
// 128 registers a thread at launch: two blocks an SM), or two that take
// the items in turn (float32, 199 KB, one block an SM; and bf16 where
// fewer than two blocks an SM would run), chosen by dkv_plan.
template <typename T, bool TWO>
struct Dkv {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int NC = TWO ? 2 : 1;  // consumer warpgroups
  static constexpr int NT = 128 * (1 + NC);
  static constexpr int MIN_BLOCKS = TWO ? 1 : 2;
  static constexpr int PRODUCER_REGS = TWO ? 56 : 24;  // as Fwd's
  static constexpr int CONSUMER_REGS = TWO ? 224 : 232;
  static constexpr int ST = F32 ? 2 : 4;  // stages
  static constexpr int TILE = wg::tile_bytes<T>();
  static constexpr int OPER = F32 ? 2 * TILE : TILE;
  static constexpr int STAGE0 = 2 * OPER;
  static constexpr int STAGE = 2 * OPER;
  static constexpr int MISC = STAGE0 + ST * STAGE;
  static constexpr int MISC_STAGE = (64 + 64 + 128) * 4;
  static constexpr int FLAGS = MISC + ST * MISC_STAGE;
  static constexpr int BARS = FLAGS + (64 + 4) * 4;
  static constexpr int RP = 64 + 4;  // the partials' pitch in floats
  static constexpr size_t bytes = BARS + 128;
  static_assert(ST * STAGE >= 2 * BK * RP * 4, "the partials fit in the stages");
  static_assert((2 + 3 * ST) * 8 <= 128, "the barriers fit");
  static_assert(bytes <= 232448, "a block's shared memory");
  static_assert(((65536 / (NT * MIN_BLOCKS)) & ~7) * (1 + NC)
                    == PRODUCER_REGS + NC * CONSUMER_REGS,
                "setmaxnreg hands over exactly the launch's registers");
};

template <typename T, bool TWO>
__global__ void __launch_bounds__(Dkv<T, TWO>::NT, Dkv<T, TWO>::MIN_BLOCKS)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap gmap, const float* __restrict__ lse,
                     const float* __restrict__ delta, const float* __restrict__ tab,
                     const float* __restrict__ bias, const int8_t* __restrict__ kmask,
                     T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ part,
                     int heads, int hk, int n, int m, float scale, int causal, int qsplit) {
  using L = Dkv<T, TWO>;
  constexpr int ST = L::ST;
  extern __shared__ __align__(1024) unsigned char dkv_smem[];
  unsigned char* sm = dkv_smem;
  if (threadIdx.x == 0 && (tc::smem_u32(sm) & 1023) != 0) __trap();  // the tiles' swizzle
  T* Ks = reinterpret_cast<T*>(sm);
  T* Kl = reinterpret_cast<T*>(sm + L::TILE);
  T* Vs = reinterpret_cast<T*>(sm + L::OPER);
  T* Vl = reinterpret_cast<T*>(sm + L::OPER + L::TILE);
  auto Qs = [&](int s) { return reinterpret_cast<T*>(sm + L::STAGE0 + s * L::STAGE); };
  auto Ql = [&](int s) { return reinterpret_cast<T*>(sm + L::STAGE0 + s * L::STAGE + L::TILE); };
  auto Gs = [&](int s) { return reinterpret_cast<T*>(sm + L::STAGE0 + s * L::STAGE + L::OPER); };
  auto Gl = [&](int s) {
    return reinterpret_cast<T*>(sm + L::STAGE0 + s * L::STAGE + L::OPER + L::TILE);
  };
  // log2(e) lse (+inf where p = 0: padded or fully masked rows), then
  // Delta, then log2(e) times the table slice: the bias of (q0 + c, k0 + r)
  // is at [128 + c - r + BK - 1]
  auto Ls = [&](int s) { return reinterpret_cast<float*>(sm + L::MISC + s * L::MISC_STAGE); };
  float* Fs = reinterpret_cast<float*>(sm + L::FLAGS);
  int* Fany = reinterpret_cast<int*>(Fs + 64);  // nonzero where a flag of keys 0-31 (32-63) is
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t *kvload = bars, *kvfull = bars + 1, *loaded = bars + 2, *full = loaded + ST,
           *empty = full + ST;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const int kvh = blockIdx.y;  // b * hk + kv head
  const int b = kvh / hk, kh = kvh % hk, group = heads / hk;
  const int k0 = (blockIdx.z / qsplit) * BK, z = blockIdx.z % qsplit;
  // this block sums the heads kh * group + rank + csize * i of its kv head
  // over chunk z of the query tiles that see its keys; causal: the first
  // query that sees key k0 is k0 - off (off = m - n >= 0)
  const int off = m - n;
  const int q_start = causal ? max(0, k0 - off) : 0;
  const int nqt = q_start < n ? (n - q_start + BQ - 1) / BQ : 0;
  const int per = (nqt + qsplit - 1) / qsplit;
  const int qa = min(nqt, z * per), nq = min(nqt, qa + per) - qa;
  const int total = (group / csize) * nq;
  auto head = [&](int it) { return kh * group + rank + csize * (it / nq); };
  auto qtile = [&](int it) { return q_start + (qa + it % nq) * BQ; };
  const int tid = threadIdx.x;

  if (tid == 0) {
    wg::mbar_init(kvload, 1);
    wg::mbar_init(kvfull, 128);
    for (int s = 0; s < ST; ++s) {
      wg::mbar_init(&loaded[s], 1);
      wg::mbar_init(&full[s], 128);
      wg::mbar_init(&empty[s], 128);
    }
    wg::fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- the producer ----
    wg::setmaxnreg_dec<L::PRODUCER_REGS>();
    if (tid == 0) {
      wg::mbar_arrive_tx(kvload, 2 * L::TILE);
      wg::load_tile(Ks, &kmap, kvload, k0, kvh);
      wg::load_tile(Vs, &vmap, kvload, k0, kvh);
    }
    if (tid < BK) {
      const float f = tc::key_flag(kmask, b, m, k0 + tid);
      Fs[tid] = f;
      const unsigned any = __ballot_sync(0xffffffffu, f != 0.f);
      if (tid % 32 == 0) Fany[tid / 32] = any != 0u;
    }
    // Item it into stage it % ST: Q and dO by TMA, lse, Delta and the table
    // slice from registers loaded an item ahead (a load's latency, not the
    // copies', would otherwise pace the ring).
    float row_r = 0.f, tab_r = 0.f;
    auto fetch = [&](int it) {
      const int h = head(it), q0 = qtile(it);
      const size_t bh = (size_t)b * heads + h;
      const int qp = q0 + tid % BQ;
      if (tid < BQ) {
        const float x = qp < n ? lse[bh * n + qp] : INFINITY;
        row_r = x > 0.5f * NEG ? tc::LOG2E * x : INFINITY;
      } else {
        row_r = qp < n ? delta[bh * n + qp] : 0.f;
      }
      if (tab != nullptr && tid < BQ + BK - 1)
        tab_r = tc::LOG2E * tc::tab_entry(tab, q0, k0, BK, tid, n, heads, h);
    };
    auto issue = [&](int it) {
      const int s = it % ST, h = head(it), q0 = qtile(it);
      const size_t bh = (size_t)b * heads + h;
      const float row_it = row_r, tab_it = tab_r;
      if (it + 1 < total) fetch(it + 1);
      wg::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
      if (tid == 0) {
        if constexpr (L::F32) wg::mbar_arrive_tx(&loaded[s], 2 * L::TILE);
        else wg::mbar_expect_tx(&full[s], 2 * L::TILE);
        uint64_t* bar = L::F32 ? &loaded[s] : &full[s];
        wg::load_tile(Qs(s), &qmap, bar, q0, (int)bh);
        wg::load_tile(Gs(s), &gmap, bar, q0, (int)bh);
      }
      float* ls = Ls(s);
      ls[tid] = row_it;
      if (tab != nullptr && tid < BQ + BK - 1) ls[2 * BQ + tid] = tab_it;
      if constexpr (!L::F32) wg::mbar_arrive(&full[s]);
    };
    // float32: item it's copies landed; split them, then hand the stage over
    auto finish = [&](int it) {
      const int s = it % ST;
      wg::mbar_wait(&loaded[s], (it / ST) & 1);
      wg::split_tile(reinterpret_cast<float*>(Qs(s)), reinterpret_cast<float*>(Ql(s)), tid, 128);
      wg::split_tile(reinterpret_cast<float*>(Gs(s)), reinterpret_cast<float*>(Gl(s)), tid, 128);
      wg::fence_proxy_async();
      wg::mbar_arrive(&full[s]);
    };
    if (total > 0) {
      fetch(0);
      issue(0);
    }
    wg::mbar_wait(kvload, 0);
    if constexpr (L::F32) {
      wg::split_tile(reinterpret_cast<float*>(Ks), reinterpret_cast<float*>(Kl), tid, 128);
      wg::split_tile(reinterpret_cast<float*>(Vs), reinterpret_cast<float*>(Vl), tid, 128);
      wg::fence_proxy_async();
    }
    wg::mbar_arrive(kvfull);
    for (int it = 1; it < total; ++it) {
      issue(it);
      if constexpr (L::F32) finish(it - 1);
    }
    if constexpr (L::F32)
      if (total > 0) finish(total - 1);
    // the cluster's two barriers of the head sum below
    tc::cluster_arrive();
    tc::cluster_wait();
    tc::cluster_arrive_relaxed();
    tc::cluster_wait();
    return;
  }

  // ---- the consumers: warpgroup c takes the items c, c + NC, ... ----
  wg::setmaxnreg_inc<L::CONSUMER_REGS>();
  const int c = tid / 128 - 1, ctid = tid % 128, warp = ctid / 32, gq = (ctid % 32) / 4,
            t = ctid % 4;
  const int kl[2] = {warp * 16 + gq, warp * 16 + gq + 8};  // this thread's keys in the tile
  wg::mbar_wait(kvfull, 0);
  const float fk[2] = {Fs[kl[0]], Fs[kl[1]]};
  const bool flagged = Fany[0] || Fany[1];
  const float sl = scale * tc::LOG2E;
  float dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;

  for (int it = c; it < total; it += L::NC) {
    const int s = it % ST, q0 = qtile(it);
    wg::mbar_wait(&full[s], (it / ST) & 1);
    float st[32], dpt[32];  // S^T and dP^T: rows keys, columns queries
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    wg::fence_acc(st);
    wg::fence_acc(dpt);
    wg::wgmma_fence();
    wg::gemm_nk<T>(st, Ks, Kl, Qs(s), Ql(s));
    wg::gemm_nk<T>(dpt, Vs, Vl, Gs(s), Gl(s));
    // The (H, N, M) bias: this thread's 32 elements straight from device
    // memory, loaded while the products run (see flash_fwd.cu for why not
    // by TMA or through shared memory); rows past n and keys past m: none.
    float bv[32];
    if (bias != nullptr) {
      const float* bh_bias = bias + ((size_t)head(it) * n + q0) * m + k0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int cq = 8 * (i / 4) + 2 * t + (i & 1), kr = kl[(i / 2) & 1];
        bv[i] = q0 + cq < n && k0 + kr < m ? __ldg(bh_bias + (size_t)cq * m + kr) : 0.f;
      }
    }
    wg::wgmma_wait<0>();
    wg::fence_acc(st);
    wg::fence_acc(dpt);

    // p = 2^(y - log2(e) lse) with y = log2(e) (scale q.k + bias) (the table
    // and lse pre-scaled by the producer); the mask only where a key of the
    // tile is flagged or some lie above this warp's rows
    const float* ls = Ls(s);
    // keys above the diagonal: only in the diagonal tile, and only for some warps
    const bool diag = causal && tc::above(k0 + warp * 16 + 15, q0, off);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int cq = 8 * (i / 4) + 2 * t + (i & 1), ri = (i / 2) & 1, kr = kl[ri];
      float bc = 0.f;
      if (tab != nullptr) bc = ls[2 * BQ + cq - kr + BK - 1];
      else if (bias != nullptr) bc = tc::LOG2E * bv[i];
      // the masking rule of mma.cuh (tc::score): the key's flag added (y +
      // NEG rounds to NEG), NEG above the diagonal unless the flag is -inf
      float y = fmaf(st[i], sl, bc);
      if (diag) y = tc::above(k0 + kr, q0 + cq, off) ? fminf(NEG, fk[ri]) : y + fk[ri];
      else if (flagged) y += fk[ri];
      const float p = tc::ex2(y - ls[cq]);
      st[i] = p;
      dpt[i] = p * (dpt[i] - ls[BQ + cq]);
    }
    // dV += P^T dO; dK += dS^T Q
    if constexpr (L::F32) {
      float pa[8][4];
      wg::gemm_pk_split(pa, st, reinterpret_cast<const float*>(Gs(s)),
                        reinterpret_cast<const float*>(Gl(s)));
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dva[4 * j + e] += pa[j][e];
      wg::gemm_pk_split(pa, dpt, reinterpret_cast<const float*>(Qs(s)),
                        reinterpret_cast<const float*>(Ql(s)));
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[4 * j + e] += pa[j][e];
    } else {
      wg::fence_acc(dva);
      wg::fence_acc(dka);
      wg::wgmma_fence();
      uint32_t pa[4][4], da[4][4];
      wg::gemm_pk(dva, st, pa, reinterpret_cast<const __nv_bfloat16*>(Gs(s)));
      wg::gemm_pk(dka, dpt, da, reinterpret_cast<const __nv_bfloat16*>(Qs(s)));
      wg::wgmma_wait<0>();
      wg::fence_acc(dva);
      wg::fence_acc(dka);
    }
    wg::mbar_arrive(&empty[s]);
  }

  // The block's sum, second consumer into the first, into the first
  // stages; then the head sum over the cluster: rank 0 adds the blocks'
  // sums in rank order through map_shared_rank and writes dk and dv (or,
  // with the query range split, this chunk's partial): no atomics.
  float* red = reinterpret_cast<float*>(sm + L::STAGE0);
  if constexpr (L::NC == 2) {
    tc::bar_sync(1, 256);
    if (c == 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          float* row = red + kl[ri] * L::RP + 8 * j + 2 * t;
          tc::store2(row, dka[4 * j + 2 * ri], dka[4 * j + 2 * ri + 1]);
          tc::store2(row + BK * L::RP, dva[4 * j + 2 * ri], dva[4 * j + 2 * ri + 1]);
        }
    }
    tc::bar_sync(1, 256);
  }
  if (c == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        float* row = red + kl[ri] * L::RP + 8 * j + 2 * t;
        float2 k1 = make_float2(0.f, 0.f), v1 = make_float2(0.f, 0.f);
        if constexpr (L::NC == 2) {
          k1 = *reinterpret_cast<float2*>(row);
          v1 = *reinterpret_cast<float2*>(row + BK * L::RP);
        }
        tc::store2(row, dka[4 * j + 2 * ri] + k1.x, dka[4 * j + 2 * ri + 1] + k1.y);
        tc::store2(row + BK * L::RP, dva[4 * j + 2 * ri] + v1.x, dva[4 * j + 2 * ri + 1] + v1.y);
      }
  }
  tc::cluster_arrive();
  tc::cluster_wait();
  if (rank == 0) {
    const size_t plane = (size_t)gridDim.y * m * 64;  // one chunk's dk or dv partial
    for (int i = tid - 128; i < BK * 64; i += 128 * L::NC) {
      const int r = i / 64, cc = i % 64;
      if (k0 + r >= m) continue;
      float sk = 0.f, sv = 0.f;
      for (int src = 0; src < csize; ++src) {
        const float* p = cluster.map_shared_rank(red, src);
        sk += p[r * L::RP + cc];
        sv += p[(BK + r) * L::RP + cc];
      }
      const size_t o = ((size_t)kvh * m + k0 + r) * 64 + cc;
      if (part == nullptr) {
        dk[o] = from_f<T>(sk * scale);
        dv[o] = from_f<T>(sv);
      } else {
        part[z * plane + o] = sk;
        part[(qsplit + z) * plane + o] = sv;
      }
    }
  }
  // every block's partials stay until rank 0 has read them
  tc::cluster_arrive_relaxed();
  tc::cluster_wait();
}

// K3's second pass with the query range split over `qsplit` chunks: dk =
// scale * sum_z part_k[z], dv = sum_z part_v[z], in chunk order
template <typename T>
__global__ void dkv_sum_kernel(const float* __restrict__ part, T* __restrict__ dk,
                               T* __restrict__ dv, size_t plane, int qsplit, float scale) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < plane;
       i += (size_t)gridDim.x * blockDim.x) {
    float sk = 0.f, sv = 0.f;
    for (int z = 0; z < qsplit; ++z) {
      sk += part[z * plane + i];
      sv += part[(qsplit + z) * plane + i];
    }
    dk[i] = from_f<T>(sk * scale);
    dv[i] = from_f<T>(sv);
  }
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

// K3's launch plan, as ops/kernels/flash_attention.py::dkv_plan gives it:
// the cluster (the largest divisor of the group up to MAX_CLUSTER), the
// number of chunks the query range is split into, so that a grid below one
// block per SM fills the card (while each chunk keeps 4 query tiles), and
// two consumer warpgroups a block for float32, and for bf16 where fewer
// than two blocks an SM would run.
struct DkvPlan {
  int cluster, qsplit;
  bool two;
};

DkvPlan dkv_plan(bool f32, int b, int heads, int hk, int n, int m) {
  const int cluster = cluster_size(heads / hk);
  const long long base = (long long)cluster * b * hk * ((m + BK - 1) / BK);
  int qsplit = 1;
  if (base < PLAN_SMS) qsplit = max(1, min((int)(PLAN_SMS / base), (n + BQ - 1) / BQ / 4));
  return {cluster, qsplit, f32 || base * qsplit < 2 * PLAN_SMS};
}

template <typename T, bool TWO>
cudaError_t launch_dkv(const Args& a, const DkvPlan& plan, void* dk, void* dv) {
  using L = Dkv<T, TWO>;
  CUtensorMap qm, km, vm, gm;
  cudaError_t err = wg::tile_map(&qm, a.q, sizeof(T), a.n, a.b * a.heads);
  if (err == cudaSuccess) err = wg::tile_map(&gm, a.g, sizeof(T), a.n, a.b * a.heads);
  if (err == cudaSuccess) err = wg::tile_map(&km, a.k, sizeof(T), a.m, a.b * a.hk);
  if (err == cudaSuccess) err = wg::tile_map(&vm, a.v, sizeof(T), a.m, a.b * a.hk);
  auto kernel = flash_bwd_dkv_kernel<T, TWO>;
  static unsigned sized = 0;  // the devices whose attribute is set, once per instantiation
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 32 || !(sized >> dev & 1))) {
    err = set_smem(kernel, L::bytes);
    if (err == cudaSuccess) sized |= 1u << dev;
  }
  if (err != cudaSuccess) return err;
  // the query range split over chunks: their partials in scratch, summed
  // in chunk order by a second pass (one K3 call, two launches)
  const size_t plane = (size_t)a.b * a.hk * a.m * 64;
  float* part = nullptr;
  if (plan.qsplit > 1) {
    // the device's default pool keeps up to 64 MB it was given back, so
    // that the next call's allocation is served from the pool
    static unsigned kept = 0;
    if (dev < 32 && !(kept >> dev & 1)) {
      cudaMemPool_t pool;
      uint64_t keep = 64ull << 20;
      if (cudaDeviceGetDefaultMemPool(&pool, dev) == cudaSuccess &&
          cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold, &keep) == cudaSuccess)
        kept |= 1u << dev;
    }
    err = cudaMallocAsync(reinterpret_cast<void**>(&part),
                          2 * plan.qsplit * plane * sizeof(float), a.stream);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1] = {cluster_attr(plan.cluster)};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.cluster, a.b * a.hk, (a.m + BK - 1) / BK * plan.qsplit);
  cfg.blockDim = dim3(L::NT);
  cfg.dynamicSmemBytes = L::bytes;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, qm, km, vm, gm, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.tab),
      static_cast<const float*>(a.bias), static_cast<const int8_t*>(a.kmask),
      static_cast<T*>(dk), static_cast<T*>(dv), part, a.heads, a.hk, a.n, a.m, a.scale,
      a.causal, plan.qsplit);
  if (part == nullptr) return err;
  if (err == cudaSuccess) {
    dkv_sum_kernel<T><<<(unsigned)((plane + 255) / 256 < 1024 ? (plane + 255) / 256 : 1024), 256,
                        0, a.stream>>>(part, static_cast<T*>(dk), static_cast<T*>(dv), plane,
                                       plan.qsplit, a.scale);
    err = cudaGetLastError();
  }
  const cudaError_t freed = cudaFreeAsync(part, a.stream);
  return err != cudaSuccess ? err : freed;
}

// which: 0 dq (and the bias's gradient in o2 when not null), 1 dk/dv
template <typename T>
cudaError_t dispatch(int which, int d, const Args& a, void* o1, void* o2, void* part) {
  if (d != 64) return cudaErrorInvalidValue;
  if (a.tab != nullptr && a.bias != nullptr) return cudaErrorInvalidValue;
  if (which == 1) {
    const DkvPlan plan = dkv_plan(sizeof(T) == 4, a.b, a.heads, a.hk, a.n, a.m);
    if constexpr (sizeof(T) == 4) return launch_dkv<T, true>(a, plan, o1, o2);
    else
      return plan.two ? launch_dkv<T, true>(a, plan, o1, o2)
                      : launch_dkv<T, false>(a, plan, o1, o2);
  }
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

// K3's launch plan for these sizes and dtype (0 float32, 1 bfloat16): out[0]
// the cluster, out[1] the query chunks, out[2] the consumer warpgroups a
// block (ops/kernels/flash_attention.py::dkv_plan mirrors it)
extern "C" int flash_dkv_plan(int b, int heads, int hk, int n, int m, int dtype, int* out) {
  if (hk <= 0 || heads % hk || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  const DkvPlan plan = dkv_plan(dtype == 0, b, heads, hk, n, m);
  out[0] = plan.cluster;
  out[1] = plan.qsplit;
  out[2] = plan.two ? 2 : 1;
  return cudaSuccess;
}
