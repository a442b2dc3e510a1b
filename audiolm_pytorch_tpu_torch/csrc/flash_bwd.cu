// Flash-attention backward for Hopper (sm_90a): dq (K2) with, in the same
// launch, the gradient of the bias given: that of the (2N-1, H) rel-pos
// distance table (K4), that of an (H, N, M) bias shared over the batch
// (K5), or that of a (B, H, N, M) bias, a bias a batch row (dS itself);
// and dk/dv (K3). Each recomputes P = exp(S - lse) tile by tile from
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
//                        inside K2's launch; for a per-batch (B, H, N, M)
//                        bias (whose gradient the JAX package takes from a
//                        chunked XLA recurrence) dbias = dS, written by K2's
//                        consumer straight from its accumulators
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
// Design, all on the tensor cores, warp-specialised on wgmma and TMA through
// csrc/wgmma.cuh.
//   K2: one block per (batch row, head, 64-row query tile), on a
//       one-dimensional grid (batch rows fastest, so K5's clusters are
//       consecutive blocks), the longest causal rows first, of a producer
//       warpgroup and a consumer warpgroup. The producer's first thread loads the block's Q and dO
//       tiles once by TMA (3-D maps (64, rows, planes), so a head's ragged
//       last tile reads zeros) and streams the K and V tiles up to the
//       diagonal through a ring of stages (two in float32 and at bf16's D
//       = 256, three in bf16 up to D = 128)
//       with full and empty mbarriers; its threads write each stage's table
//       slice (log2(e) scaled) and key flags, loaded a tile ahead into
//       registers, and in float32 split Q, dO, K and V into tf32 big/small
//       pairs in place (tc::to_tf32), a tile behind the loads. The
//       consumer's warp w holds query rows 16w + g and + 8 (a strip): S = Q
//       K^T and dP = dO V^T are wgmma products (K-major A and B from shared
//       memory; float32 as three tf32 products a k-step); the (H, N, M)
//       bias is read straight from device memory while they run; the
//       epilogue forms P = 2^(y - log2(e) lse) in base-2 units and dS = P
//       (dP - Delta) on the accumulators by the masking rule at the end of
//       mma.cuh; dq += dS K takes dS from the accumulators as the A operand:
//       in bf16 a wgmma with K's tile as a transposed B, in float32 on
//       mma.sync from K's split tiles (wgmma's tf32 takes K-major B only),
//       each tile's product from zero, added in float32 (tc::add_tile: dq
//       sums over up to 2049 keys). One consumer warpgroup a block: the
//       grids of the port's shapes are 160 blocks and more (dq_plan), and
//       two blocks share an SM in bf16.
//   K4, inside K2 when dtab is given, then a second small pass: each strip
//       stores its 16 rows of the tile's dS skewed in shared memory
//       (element (r, c) at column c - r + 15), so that each of its 79
//       diagonals is a column; a lane sums a column into the strip's row of
//       the tile's 128 delta slots (two buffers, one a tile). After the
//       tile's barrier of the consumer warpgroup, thread i adds the four
//       strips' slots of the delta it owns there (the block's local delta
//       index = i mod 128), in strip order, to a register, and writes each
//       delta's sum once, when the key tiles have passed it, to the block's
//       row of a scratch buffer (B, H, query tiles, 64 (key tiles + 1)).
//       The second pass, dtab_sum_kernel, adds those rows over the batch
//       rows and then the query tiles, in that order, into dtab. Every sum
//       has a fixed order, so dtab has the same bits every run, as the JAX
//       package's `_dblocks_kernel` sums in a fixed order.
//   K5, inside K2 when dbias is given (an instantiation of its own, SUM):
//       the blocks of one (head, query tile), one per batch row, form a
//       thread-block cluster of the largest divisor of B up to 8. Each key
//       tile, the consumer stores its dS tile into one of two buffers and
//       tells every rank by a remote arrive on its cluster-scoped mbarrier.
//       The producer, once it has issued tile it (so its own consumer is
//       done with tile it - ST), waits there for tile it - ST, sums its
//       rank's share of that tile's rows over the ranks in rank order
//       through map_shared_rank, writes them and tells every rank the
//       buffer is free (a second mbarrier, which a consumer waits on before
//       it writes that buffer again; the producer waits on it before the
//       block exits). So the consumer never waits on the other ranks but to
//       reuse a buffer, no thread meets at barrier.cluster after the start,
//       and every wait traps after ~20 s instead of hanging. With B <= 8
//       one cluster holds the batch, so each dbias element is written once,
//       in a fixed order, with no atomics: the same bits every run. Only
//       with B > 8 (B / cluster clusters per tile) do the clusters' partial
//       tiles meet by atomicAdd, in a buffer the wrapper zeroes. The tiles
//       above the causal diagonal, which no block visits, are written as
//       zeros by the producers of the cluster of their query tile, after
//       their sums (with atomics the zeroed buffer holds them).
//   The per-batch bias's gradient (an instantiation of its own, EACH): a
//       (b, h) row's dS is its gradient, so each consumer thread writes its
//       32 elements of the tile's dS to dbias[b, h] as soon as it has them,
//       and the block's keys past its last tile as zeros: no cluster, no
//       atomics, every element written once, the same bits every run.
//   What holds K2 back (measured by tools/torch_flash_parent_ab.py,
//       PERF.md): one consumer warpgroup runs its two products, its
//       epilogue and its dq product in sequence, and the epilogue (bias,
//       masking rule, exponent, dS) paces bf16 at ~5x its bound; in float32
//       dS K runs on mma.sync from K's split tiles, and one block fills an
//       SM's shared memory. K4 adds the skewed stores and column sums a tile
//       and its second pass; K5 the cluster launch and a buffer's wait.
//   K3 (warp-specialised, on wgmma and TMA through csrc/wgmma.cuh): one
//       block per (query head set, b*hk, 64-key tile, query chunk), on a
//       one-dimensional grid in that order (a cluster's blocks consecutive), of a
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
// Head dims. The native forms are instantiated for D = 32, 64 and 128 (the
// wrapper zero-pads any other D up to 128 into the next of them), and for
// D = 256 (bf16: K2 flash_bwd_dq_kernel<bf16, 256, DB>, K3
// flash_bwd_dkv_pair_kernel; float32: the chunked forms
// flash_bwd_dq_chunk_kernel and flash_bwd_dkv_chunk_kernel; the wrapper
// zero-pads 129 to 255 to 256 in both dtypes); over 256 the column-sliced
// forms below take every D that is a multiple of 64 (any other D
// zero-padded to the next one). The native forms sit on csrc/wgmma.cuh's boxes: a
// D-wide row is D * sizeof(T) / 128 boxes (a 32-wide bf16 row half of one,
// read as zeros past the row's end), the products over D run D * sizeof(T)
// / 32 k-steps, and those whose N index is D (dq += dS K, dV += P^T dO, dK
// += dS^T Q) one product a 64-column box. At D = 32 every block shape is
// that of D = 64 with smaller tiles. At D = 128 every tile doubles: in bf16
// K2 keeps its three stages in one block an SM (160 KB with K5's buffers)
// and no setmaxnreg, K3 takes two consumers (168 KB); in float32 an operand
// with its small parts is 64 KB, so four of them (K2's Q, dO, K and V; K3's
// K, V, Q and dO) fill 256 KB, over the 227 KB a block may have. There the
// two streamed operands take turns in one slot (SEQ): K2 loads a key tile's
// V, forms dP = dO V^T, then loads K into the same slot for S = Q K^T and
// dq += dS K (Q, dO 128 KB + the slot 64 KB + K5's 32 KB = 225 KB); K3 loads
// an item's Q for S^T = K Q^T and P, its dO for dP^T, dS and dV += P^T dO,
// then Q again for dK += dS^T Q (K, V 128 KB + the slot 64 KB). One
// consumer, one block an SM, the slot's split ordered before the next load,
// no overlap: right, and simple, not yet fast (PERF.md). The products are
// the same, in the same order, as at the other head dims, so the sums keep
// their fixed order and bits. In bf16 at D = 256 every tile doubles again
// (32 KB): K2 keeps its block with two stages (231,200 bytes with K5's
// buffers, 1,248 under the limit; its consumer's dq 128 registers a
// thread), and K3 takes a block of its own, flash_bwd_dkv_pair_kernel, whose
// two consumers hold one gradient each and hand P^T and dS^T to each other
// (see there). S and dP are formed once a tile, as at every native D.
// In float32 at D = 256 an operand tile with its tf32 small parts is 128
// KB, so K2's Q and dO (or K3's K and V) split whole would alone fill 256
// KB, over the 227 KB a block may have. The chunked forms keep those two
// resident and unsplit (128 KB), each the A operand of its score product
// (S = Q K^T, dP = dO V^T; K3: S^T = K Q^T, dP^T = V dO^T), its fragment
// read into registers k-step by k-step and split there by the same
// tc::to_tf32 rounding (wgmma takes a tf32 A from registers, wgmma.cuh's
// gemm_nk_rs_chunk). The streamed operands come through a two-stage TMA
// ring 64 columns at a time (a 16 KB chunk, 32 KB with its small parts,
// split in place). The products whose N index is D (dq += dS K, dV += P^T
// dO, dK += dS^T Q) take their chunks again, split transposed (wgmma's tf32
// B is K-major only), and run on wgmma too, one 64-column chunk of the
// output a ring item, A from the registers or a hand-off (wg::split_tile_t,
// wg::add_pk_chunk): on mma.sync, reading B fragment by fragment, they took
// the largest share of both kernels' time (tools/torch_flash_ablate.py
// measures each part's). K2 keeps one consumer and its producer's splits
// (198,432 bytes and K5's 32 KB: 231,200), K3 the pair form's two consumers,
// each splitting the chunks it takes (231,824 bytes); see there. S and dP
// are formed once a tile.
//
// Over D = 256 (flash_bwd_dq_wide_kernel, flash_bwd_dkv_wide_kernel): a
// block owns one 64-wide slice of its output's columns (dq, or dk and dv) and
// keeps 16 x 64 strips of it a warp; S and dP (K2: rows queries; K3: S^T
// and dP^T, rows keys) are summed over the depth 64 columns at a time, each
// chunk's two operand tiles streamed by cp.async through a ring of two
// stages with the slice's operands after them, on mma.sync (csrc/mma.cuh's
// tc::Wide; 3xTF32 in float32, each chunk's product and each tile's dq, dk
// or dv product from zero, added in float32). 4 warps, two blocks an SM.
// One writer: only slice 0 of K2 writes the bias's gradient, so the sums
// keep a fixed order: K4's partial sums as the native K2 forms them (its
// skewed rows and delta slots after the ring) with the same second pass;
// K5's batch sum over a cluster of the batch rows' slice-0 blocks, each
// tile's dS added in rank order through batch_sum_rows between two cluster
// barriers (atomics only where B has no divisor cluster holding it all, as
// in the native form); the per-batch bias's dS written straight out. K3's
// block walks every query head of its kv head and their query tiles in
// order, no cluster and no query split: dk and dv written once, the same
// bits every run. The price: each slice recomputes S and dP (D / 64 times
// the native forms' products), and the operands are read again for each
// tile (mostly from L2). Right first, not yet fast: PERF.md has its times.
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
constexpr int BF16_DIM = 256;   // bf16's Hopper form of K2 and K3 over D = 128 (the
                                // wrapper pads bf16's 129 to 255 to it)
constexpr int F32_DIM = 256;    // float32's chunked form of K2 and K3 over D = 128 (the
                                // wrapper pads float32's 129 to 255 to it)
// K2's forms of the bias's gradient: none or K4's (the table's, by its
// dpart pointer), K5's batch sum, or a per-batch bias's dS
constexpr int DB_NONE = 0, DB_SUM = 1, DB_EACH = 2;
using tc::NEG;
static_assert(BQ == BK, "square tiles: the causal loops start at the diagonal tile");

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int SKP = BK + 16;   // K4's skewed dS rows: a strip's diagonals take BK + 15 columns
constexpr int DSL = 2 * BK;    // K4's delta slots a tile: a key tile meets BQ + BK - 1 deltas
constexpr int PLAN_SMS = 132;  // the H100's SMs, which the launch plans fill

// K2: one block per (batch row, head, 64-row query tile), the longest causal
// rows first, of a producer warpgroup and a consumer warpgroup (see the note
// at the top); the blocks of one (head, query tile) a cluster when K5 runs.
// The consumer's warp w holds query rows 16w + g and 16w + g + 8 of every
// product (the strip K4 works on). K5's sum is instantiated apart (SUM).
//
// Shared memory (offsets from a 1024-byte aligned base): Q and dO, each an
// operand tile (with its small parts in float32), fixed for the block; the
// ring's stages of (K, V); per stage log2(e) times the table slice [128],
// the key flags [64] and two words that say whether any key of the tile is
// flagged; the barriers; then, for the bias's gradient, K4's skewed dS rows
// and delta slots (24 KB) or K5's two dS buffers (2 x 16 KB, float32). The
// budget at D = 64: float32 with K5 64 + 2 x 64 + 32 KB and the rest,
// 231,072 of 232,448 bytes (two stages; one block an SM); bf16 16 + 3 x 16
// + 32 KB (three stages; ~99 KB, two blocks an SM, setmaxnreg giving the
// producer's registers to the consumer). Float32 at D = 128 (SEQ): a stage
// is one slot that K and V take in turn, two ring items a key tile. Bf16 at
// D = 256: Q and dO 64 KB, two stages of K and V 128 KB, the rest 1.8 KB
// (EXTRA 198,432 bytes), K4's buffers 24 KB (223,008) or K5's two dS
// buffers 32 KB (231,200: 1,248 bytes under the limit); one block an SM,
// no setmaxnreg, the consumer's dq 128 registers a thread.
template <typename T, int D, bool SUM>
struct Dq {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr bool WIDE = D > 64;  // D = 128, or bf16's 256
  static constexpr bool SEQ = F32 && WIDE;
  static constexpr int PER = SEQ ? 2 : 1;  // ring items a key tile: V then K, or both
  static constexpr int NT = 256;  // the producer warpgroup, then the consumer warpgroup
  static constexpr int MIN_BLOCKS = F32 || WIDE ? 1 : 2;
  static constexpr bool NREG = MIN_BLOCKS == 2;  // setmaxnreg: bf16 at D <= 64
  static constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 200;  // with NREG
  static constexpr int ST = SEQ ? 1 : F32 || D > 128 ? 2 : 3;  // stages
  static constexpr int TILE = wg::tile_bytes<T, D>();
  static constexpr int NA = wg::acc_blocks<T, D>();  // the dq accumulator's n-blocks
  static constexpr int OPER = F32 ? 2 * TILE : TILE;
  static constexpr int STAGE0 = 2 * OPER;
  static constexpr int STAGE = PER == 2 ? OPER : 2 * OPER;
  static constexpr int MISC = STAGE0 + ST * STAGE;
  static constexpr int MISC_STAGE = (128 + 64 + 4) * 4;
  static constexpr int BARS = MISC + ST * MISC_STAGE;
  static constexpr int EXTRA = BARS + 256;
  static constexpr int K4_BYTES = (BQ * SKP + 2 * 4 * DSL) * 4;
  static constexpr int K5_BYTES = 2 * BQ * BK * 4;
  static constexpr size_t most = EXTRA + (SUM ? K5_BYTES : K4_BYTES);
  static_assert(most <= 232448, "a block's shared memory");
  static_assert(MIN_BLOCKS == 1 || 2 * (most + 1024) <= 233472, "two bf16 blocks an SM");
  static_assert((2 + 3 * ST + 4) * 8 <= 256, "the barriers fit");
  static_assert(!NREG || ((65536 / (NT * MIN_BLOCKS)) & ~7) * 2 == PRODUCER_REGS + CONSUMER_REGS,
                "setmaxnreg hands over exactly the launch's registers");
};

// K5's dS tile in shared memory: 64 x 64 float32, the 16-byte group c / 4 of
// row r at group (c / 4) ^ (r % 8), so a warp's stores of its accumulators
// and a row's 16-byte reads spread over the banks
__device__ __forceinline__ int ds_at(int r, int c) {
  return r * BK + ((((c >> 2) ^ (r & 7))) << 2) + (c & 3);
}

// K5's sum of one key tile: the blocks of a cluster of csize add their dS
// tiles (at dsm, each in its own shared memory) in rank order, each block
// over its share of the rows, thread i of 128 a 16-byte group at a time,
// and write them to out = dbias[h] (or add them, where other clusters share
// the tile)
__device__ __forceinline__ void batch_sum_rows(const cg::cluster_group& cluster, float* dsm,
                                               float* out, int q0, int k0, int n, int m,
                                               bool atomic, int i0) {
  constexpr int V = BK / 4;  // 16-byte groups a row
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const int r_lo = rank * BQ / csize, count = ((rank + 1) * BQ / csize - r_lo) * V;
  for (int i = i0; i < count; i += 128) {
    const int r = r_lo + i / V, c4 = i % V;
    const int at = r * BK + ((c4 ^ (r & 7)) << 2);
    float4 sum = *reinterpret_cast<const float4*>(cluster.map_shared_rank(dsm, 0) + at);
#pragma unroll
    for (int src = 1; src < MAX_CLUSTER; ++src)
      if (src < csize) {
        const float4 x = *reinterpret_cast<const float4*>(cluster.map_shared_rank(dsm, src) + at);
        sum.x += x.x;
        sum.y += x.y;
        sum.z += x.z;
        sum.w += x.w;
      }
    const int row = q0 + r, c = k0 + 4 * c4;
    if (row >= n) continue;
    const float v[4] = {sum.x, sum.y, sum.z, sum.w};
    float* o = out + (size_t)row * m + c;
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
  // one-dimensional grid: each head's blocks in turn
  const int per_head = (2 * n - 1 + NT_DTAB - 1) / NT_DTAB;
  const int idx = blockIdx.x % per_head * NT_DTAB + threadIdx.x, h = blockIdx.x / per_head;
  if (idx >= 2 * n - 1) return;
  const int nqt = (n + BQ - 1) / BQ, arow = BK * ((m + BK - 1) / BK + 1);
  const int delta = idx - (n - 1);
  float sum = 0.f;
  for (int bi = 0; bi < b; ++bi) {
    const float* pb = part + (size_t)(bi * heads + h) * nqt * arow;
    // eight query tiles' loads in flight, then their adds in order
    for (int q8 = 0; q8 < nqt; q8 += 8) {
      float v[8];
      bool in[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qt = q8 + j, q0 = qt * BQ, a = q0 + BQ - 1 - delta;
        const int kv_end = causal ? min(m, q0 + BQ) : m;
        in[j] = qt < nqt && a >= 0 && a < BK * ((kv_end + BK - 1) / BK + 1);
        v[j] = in[j] ? pb[(size_t)qt * arow + a] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (in[j]) sum += v[j];
    }
  }
  dtab[(size_t)idx * heads + h] = sum;
}

template <typename T, int D, int DB>
__global__ void __launch_bounds__(Dq<T, D, DB == DB_SUM>::NT, Dq<T, D, DB == DB_SUM>::MIN_BLOCKS)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap gmap, const float* __restrict__ lse,
                    const float* __restrict__ delta, const float* __restrict__ tab,
                    const float* __restrict__ bias, const int8_t* __restrict__ kmask,
                    T* __restrict__ dq, float* __restrict__ dpart, float* __restrict__ dbias,
                    int bcount, int heads, int group, int n, int m, float scale, int causal,
                    int bias_batched) {
  constexpr bool SUM = DB == DB_SUM, EACH = DB == DB_EACH;
  using L = Dq<T, D, SUM>;
  constexpr int ST = L::ST, PER = L::PER;
  extern __shared__ __align__(1024) unsigned char dq_smem[];
  unsigned char* sm = dq_smem;
  if (threadIdx.x == 0 && (tc::smem_u32(sm) & 1023) != 0) __trap();  // the tiles' swizzle
  T* Qs = reinterpret_cast<T*>(sm);
  T* Ql = reinterpret_cast<T*>(sm + L::TILE);  // float32 only
  T* Gs = reinterpret_cast<T*>(sm + L::OPER);
  T* Gl = reinterpret_cast<T*>(sm + L::OPER + L::TILE);
  auto Ks = [&](int s) { return reinterpret_cast<T*>(sm + L::STAGE0 + s * L::STAGE); };
  auto Kl = [&](int s) { return reinterpret_cast<T*>(sm + L::STAGE0 + s * L::STAGE + L::TILE); };
  auto Vs = [&](int s) { return reinterpret_cast<T*>(sm + L::STAGE0 + s * L::STAGE + L::OPER); };
  auto Vl = [&](int s) {
    return reinterpret_cast<T*>(sm + L::STAGE0 + s * L::STAGE + L::OPER + L::TILE);
  };
  // table slice: Bs[i] = log2(e) tab[q0 - k0 - (BK - 1) + i + n - 1, h],
  // so the bias of (q0 + r, k0 + c) is Bs[r - c + BK - 1]; then the key
  // flags; then two words, nonzero where a flag of keys 0-31 (32-63) is.
  // In the stage of the key tile's first ring item.
  auto Bs = [&](int s) { return reinterpret_cast<float*>(sm + L::MISC + s * L::MISC_STAGE); };
  auto Fs = [&](int s) { return Bs(s) + 128; };
  auto As = [&](int s) { return reinterpret_cast<int*>(Bs(s) + 128 + 64); };
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t *qload = bars, *qfull = bars + 1, *loaded = bars + 2, *full = loaded + ST,
           *empty = full + ST, *dsready = empty + ST, *dsfree = dsready + 2;
  float* extra = reinterpret_cast<float*>(sm + L::EXTRA);

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  // one-dimensional grid: batch rows fastest, then heads, then query tiles
  const int b = blockIdx.x % bcount, h = blockIdx.x / bcount % heads;
  const int nqt = (n + BQ - 1) / BQ, qt = blockIdx.x / bcount / heads;
  const int q0 = (nqt - 1 - qt) * BQ;  // the longest causal rows first
  const size_t bh = (size_t)b * heads + h;
  // causal: key k is seen by query q iff k <= q + off (bottom-right aligned, m >= n)
  const int off = m - n;
  const int kv_end = tc::causal_end(causal, q0 + BQ, off, m);
  const int ntiles = (kv_end + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    wg::mbar_init(qload, 1);
    wg::mbar_init(qfull, 128);
    for (int s = 0; s < ST; ++s) {
      wg::mbar_init(&loaded[s], 1);
      wg::mbar_init(&full[s], 128);
      wg::mbar_init(&empty[s], 128);
    }
    for (int i = 0; i < 2; ++i) {  // K5: one arrival from each rank of the cluster
      wg::mbar_init(&dsready[i], csize);
      wg::mbar_init(&dsfree[i], csize);
    }
    wg::fence_barrier_init();
  }
  __syncthreads();
  if constexpr (SUM) {
    // every rank's barriers are initialised before any rank arrives on them
    tc::cluster_arrive();
    tc::cluster_wait();
  }
  // K5: dS of tile it in buffer it % 2; with several clusters per tile (B >
  // 8) their partial sums meet by atomics
  const bool atomic = SUM && csize < bcount;
  // dbias[h] (K5), or dbias[b, h] (a per-batch bias)
  float* out = SUM ? dbias + (size_t)h * n * m : EACH ? dbias + bh * n * m : nullptr;
  auto dsb = [&](int it) { return extra + (it & 1) * BQ * BK; };

  if (tid < 128) {
    // ---- the producer ----
    if constexpr (L::NREG) wg::setmaxnreg_dec<L::PRODUCER_REGS>();
    const int kvp = (int)(bh / group);
    if (tid == 0) {
      wg::mbar_arrive_tx(qload, 2 * L::TILE);
      wg::load_tile<T, D>(Qs, &qmap, qload, q0, (int)bh);
      wg::load_tile<T, D>(Gs, &gmap, qload, q0, (int)bh);
    }
    // Ring item i into stage i % ST: tile i / PER's K and V by TMA (SEQ: V,
    // then K, one an item), the table slice and key flags with the tile's
    // first item, from registers loaded a tile ahead (a load's latency, not
    // the copies', would otherwise pace the ring).
    float tab_r = 0.f, flag_r = 0.f;
    auto fetch = [&](int it) {
      const int k0 = it * BK;
      if (tab != nullptr && tid < BQ + BK - 1)
        tab_r = tc::LOG2E * tc::tab_entry(tab, q0, k0, BK, tid, n, heads, h);
      if (tid < BK) flag_r = tc::key_flag(kmask, b, m, k0 + tid);
    };
    auto issue = [&](int i) {
      const int s = i % ST, it = i / PER, k0 = it * BK;
      const bool first = i % PER == 0;
      const float tab_it = tab_r, flag_it = flag_r;
      if (first && it + 1 < ntiles) fetch(it + 1);
      wg::mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
      if (tid == 0) {
        if constexpr (L::F32) wg::mbar_arrive_tx(&loaded[s], (3 - PER) * L::TILE);
        else wg::mbar_expect_tx(&full[s], 2 * L::TILE);
        uint64_t* bar = L::F32 ? &loaded[s] : &full[s];
        if constexpr (L::SEQ) {
          wg::load_tile<T, D>(Ks(s), i % 2 ? &kmap : &vmap, bar, k0, kvp);
        } else {
          wg::load_tile<T, D>(Ks(s), &kmap, bar, k0, kvp);
          wg::load_tile<T, D>(Vs(s), &vmap, bar, k0, kvp);
        }
      }
      if (first) {
        if (tab != nullptr && tid < BQ + BK - 1) Bs(s)[tid] = tab_it;
        if (tid < BK) {
          Fs(s)[tid] = flag_it;
          const unsigned any = __ballot_sync(0xffffffffu, flag_it != 0.f);
          if (tid % 32 == 0) As(s)[tid / 32] = any != 0u;
        }
      }
      if constexpr (!L::F32) wg::mbar_arrive(&full[s]);
    };
    // float32: item i's copies landed; split them, then hand the stage over
    auto finish = [&](int i) {
      const int s = i % ST;
      wg::mbar_wait(&loaded[s], (i / ST) & 1);
      wg::split_tile<L::TILE>(reinterpret_cast<float*>(Ks(s)), reinterpret_cast<float*>(Kl(s)),
                              tid, 128);
      if constexpr (!L::SEQ)
        wg::split_tile<L::TILE>(reinterpret_cast<float*>(Vs(s)), reinterpret_cast<float*>(Vl(s)),
                                tid, 128);
      wg::fence_proxy_async();
      wg::mbar_arrive(&full[s]);
    };
    const int nitems = PER * ntiles;
    fetch(0);
    if (nitems > 0) issue(0);
    wg::mbar_wait(qload, 0);
    if constexpr (L::F32) {
      wg::split_tile<L::TILE>(reinterpret_cast<float*>(Qs), reinterpret_cast<float*>(Ql), tid,
                              128);
      wg::split_tile<L::TILE>(reinterpret_cast<float*>(Gs), reinterpret_cast<float*>(Gl), tid,
                              128);
      wg::fence_proxy_async();
    }
    // K5 of tile it (the producer's, so the consumer never waits on the
    // other ranks but to reuse a buffer): once every rank's dS is in, this
    // rank's share of its rows summed over the ranks in rank order; then
    // every rank told. Tile it - TS's (TS the tiles the ring holds), after
    // tile it's first item is issued: this block's consumer is done with it
    // by then.
    auto batch_sum = [&](int it) {
      wg::mbar_wait<true>(&dsready[it & 1], (it / 2) & 1);
      batch_sum_rows(cluster, dsb(it), out, q0, it * BK, n, m, atomic, tid);
      tc::bar_sync(2, 128);
      if (tid < csize) wg::mbar_arrive_remote(&dsfree[it & 1], tid);
    };
    constexpr int TS = ST > PER ? ST / PER : 1;
    wg::mbar_arrive(qfull);
    for (int i = 1; i < nitems; ++i) {
      // one stage: item i - 1 handed over (and consumed) before item i loads
      if constexpr (L::F32 && ST == 1) finish(i - 1);
      issue(i);
      if constexpr (L::F32 && ST > 1) finish(i - 1);
      if constexpr (SUM)
        if (i % PER == 0 && i / PER >= TS) batch_sum(i / PER - TS);
    }
    if constexpr (L::F32)
      if (nitems > 0) finish(nitems - 1);
    if constexpr (SUM) {
      for (int it = max(0, ntiles - TS); it < ntiles; ++it) batch_sum(it);
      // no block leaves while the cluster still reads its dS: each buffer's
      // last use freed by every rank
      wg::mbar_wait<true>(&dsfree[(ntiles - 1) & 1], ((ntiles - 1) / 2) & 1);
      if (ntiles >= 2) wg::mbar_wait<true>(&dsfree[ntiles & 1], ((ntiles - 2) / 2) & 1);
      // the keys past the causal diagonal have dS = 0; no block visits them
      if (!atomic && kv_end < m) {
        const int rank = (int)cluster.block_rank();
        const int r_hi = min((rank + 1) * BQ / csize, n - q0);
        for (int r = rank * BQ / csize; r < r_hi; ++r) {
          float* o = out + (size_t)(q0 + r) * m;
          for (int c = kv_end + tid; c < m; c += 128) o[c] = 0.f;
        }
      }
    }
    return;
  }

  // ---- the consumer ----
  if constexpr (L::NREG) wg::setmaxnreg_inc<L::CONSUMER_REGS>();
  const int ctid = tid - 128, warp = ctid / 32, lane = ctid % 32, gq = lane / 4, t = lane % 4;
  const int rl[2] = {warp * 16 + gq, warp * 16 + gq + 8};  // this thread's rows in the tile
  // bias[h], or bias[b, h] of a per-batch bias
  const float* biash = bias != nullptr ? bias + (bias_batched ? bh : h) * n * m : nullptr;
  // this thread's rows of the (H, N, M) bias (rows past n: none)
  const float* brow[2] = {biash != nullptr && q0 + rl[0] < n ? biash + (size_t)(q0 + rl[0]) * m
                                                             : nullptr,
                          biash != nullptr && q0 + rl[1] < n ? biash + (size_t)(q0 + rl[1]) * m
                                                             : nullptr};
  // log2(e) lse (+inf where p = 0: padded or fully masked rows) and Delta
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int qp = q0 + rl[ri];
    const float l = qp < n ? lse[bh * n + qp] : INFINITY;
    lse_r[ri] = l > 0.5f * NEG ? tc::LOG2E * l : INFINITY;
    dl_r[ri] = qp < n ? delta[bh * n + qp] : 0.f;
  }
  // K4: a strip's dS, skewed so that a diagonal is a column. Element (r, c)
  // of the strip's 16 rows lies on the diagonal of (r - 8, c - 8), and a
  // thread holds both (rows gq and gq + 8), so it adds them first: their
  // sum goes to row gq of the strip's 8 rows, column c - gq + 15. The cells
  // off the band are zeros, written once.
  float* sk = extra + warp * 8 * SKP;
  // K4's delta slots of tile it: dsl(it)[strip * DSL + a - k0] holds the
  // strip's sum of the delta q0 + BQ - 1 - a (a: the block's local index)
  auto dsl = [&](int it) { return extra + BQ * SKP + (it & 1) * 4 * DSL; };
  const int nkt = (m + BK - 1) / BK;
  float* prow = dpart != nullptr
                    ? dpart + (bh * nqt + q0 / BQ) * (size_t)(BK * (nkt + 1)) : nullptr;
  int a_cur = -1;  // the local delta this thread sums now (thread i owns a = i mod DSL)
  float a_sum = 0.f;
  if (dpart != nullptr) {
    for (int i = ctid; i < BQ * SKP + 2 * 4 * DSL; i += 128) extra[i] = 0.f;
    tc::bar_sync(1, 128);
  }
  const float sl = scale * tc::LOG2E;
  float dqa[4 * L::NA];
#pragma unroll
  for (int i = 0; i < 4 * L::NA; ++i) dqa[i] = 0.f;
  wg::mbar_wait(qfull, 0);

  for (int it = 0; it < ntiles; ++it) {
    // s: the stage of the tile's first item (its table slice and flags, and
    // V); ks: the one K lies in (SEQ: the next item's, in the same slot)
    const int i0 = PER * it, s = i0 % ST, ks = (i0 + PER - 1) % ST, k0 = it * BK;
    wg::mbar_wait(&full[s], (i0 / ST) & 1);
    float sc[32], ds[32];  // S, then dP and dS: rows queries, columns keys
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = ds[i] = 0.f;
    wg::fence_acc(sc);
    wg::fence_acc(ds);
    wg::wgmma_fence();
    if constexpr (L::SEQ) {
      wg::gemm_nk<T, D>(ds, Gs, Gl, Ks(s), Kl(s));  // V in the slot
    } else {
      wg::gemm_nk<T, D>(sc, Qs, Ql, Ks(s), Kl(s));
      wg::gemm_nk<T, D>(ds, Gs, Gl, Vs(s), Vl(s));
    }
    // The (H, N, M) bias: this thread's 32 elements straight from device
    // memory, loaded while the products run (see flash_fwd.cu for why not
    // by TMA or through shared memory); rows past n and keys past m: none.
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
    wg::fence_acc(ds);
    if constexpr (L::SEQ) {
      // V's item done with; K's into the slot for S = Q K^T
      wg::mbar_arrive(&empty[s]);
      wg::mbar_wait(&full[ks], ((i0 + 1) / ST) & 1);
      wg::wgmma_fence();
      wg::gemm_nk<T, D>(sc, Qs, Ql, Ks(ks), Kl(ks));
      wg::wgmma_wait<0>();
      wg::fence_acc(sc);
    }

    // p = 2^(y - log2(e) lse) with y = log2(e) (scale q.k + bias) (the table
    // pre-scaled by the producer), by the masking rule of mma.cuh
    // (tc::score): a key's flag added (y + NEG rounds to NEG) only on tiles
    // with a flagged key, NEG above the diagonal unless the flag is -inf,
    // tested only on tiles that reach above this warp's rows; then dS = P
    // (dP - Delta)
    const float* bs = Bs(s);
    const float* fs = Fs(s);
    const bool diag = causal && tc::above(k0 + BK - 1, q0 + warp * 16, off);
    const bool flagged = As(s)[0] || As(s)[1];
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
          const int qp = q0 + rl[ri];
          y0 = tc::above(k0 + cc, qp, off) ? fminf(NEG, f.x) : y0 + f.x;
          y1 = tc::above(k0 + cc + 1, qp, off) ? fminf(NEG, f.y) : y1 + f.y;
        } else if (flagged) {
          y0 += f.x;
          y1 += f.y;
        }
        const int e = 4 * j + 2 * ri;
        ds[e] = tc::ex2(y0 - lse_r[ri]) * (ds[e] - dl_r[ri]);
        ds[e + 1] = tc::ex2(y1 - lse_r[ri]) * (ds[e + 1] - dl_r[ri]);
      }
    }
    if (dpart != nullptr) {
      // K4: the strip's diagonals, a lane per column of its skewed rows:
      // column x holds delta q0 - k0 + 16 strip + 15 - x, local index a =
      // k0 + 48 - 16 strip + x
      float* row = sk + gq * SKP + 2 * t - gq + 15;
#pragma unroll
      for (int j = -1; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          row[8 * j + e] = (j >= 0 ? ds[4 * j + e] : 0.f) + (j + 1 < BK / 8 ? ds[4 * j + 6 + e] : 0.f);
      __syncwarp();
      for (int x = lane; x < BK + 15; x += 32) {
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int r = 0; r < 8; r += 2) {
          sum0 += sk[r * SKP + x];
          sum1 += sk[(r + 1) * SKP + x];
        }
        dsl(it)[warp * DSL + 48 - 16 * warp + x] = sum0 + sum1;
      }
    }
    if constexpr (EACH) {
      // a per-batch bias: this thread's dS elements are their gradient
      // (scalar stores: a row of m floats need not keep 8-byte alignment)
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int qp = q0 + rl[ri];
        if (qp >= n) continue;
        float* o = out + (size_t)qp * m + k0;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = 8 * j + 2 * t + e;
            if (k0 + cc < m) o[cc] = ds[4 * j + 2 * ri + e];
          }
      }
    }
    if constexpr (SUM) {
      // K5: dS into buffer it % 2 once every rank has summed tile it - 2
      // from it, then every rank told
      if (it >= 2) wg::mbar_wait<true>(&dsfree[it & 1], ((it / 2) - 1) & 1);
      float* dst = dsb(it);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int ri = 0; ri < 2; ++ri)
          tc::store2(dst + ds_at(rl[ri], 8 * j + 2 * t), ds[4 * j + 2 * ri], ds[4 * j + 2 * ri + 1]);
      tc::bar_sync(1, 128);
      if (ctid < csize) wg::mbar_arrive_remote(&dsready[it & 1], ctid);
    }
    // dq += dS K: in bf16 a wgmma with dS from the accumulators and K's tile
    // as a transposed B; in float32 on mma.sync from K's split tiles, from
    // zero, added in float32 (tc::add_tile's reason)
    if constexpr (L::F32) {
      wg::add_pk_split<D>(dqa, ds, reinterpret_cast<const float*>(Ks(ks)),
                          reinterpret_cast<const float*>(Kl(ks)));
    } else {
      wg::fence_acc(dqa);
      wg::wgmma_fence();
      uint32_t pa[4][4];
      wg::gemm_pk<L::NA / 8>(dqa, ds, pa, reinterpret_cast<const __nv_bfloat16*>(Ks(ks)));
      wg::wgmma_wait<0>();
      wg::fence_acc(dqa);
    }
    if (dpart != nullptr) {
      tc::bar_sync(1, 128);  // every strip's slots of this tile are in
      // K4: the tile's four strips, in order, onto the delta this thread
      // owns in it; a delta the key tiles have passed is written once
      const int a = k0 + ((ctid - k0) & (DSL - 1));
      if (a != a_cur) {
        if (a_cur >= 0) prow[a_cur] = a_sum;
        a_cur = a;
        a_sum = 0.f;
      }
      const float* d = dsl(it) + (a - k0);
      a_sum += ((d[0] + d[DSL]) + d[2 * DSL]) + d[3 * DSL];
    }
    wg::mbar_arrive(&empty[ks]);
  }
  if (dpart != nullptr && a_cur >= 0) prow[a_cur] = a_sum;
  if constexpr (EACH) {
    // the keys past the last tile (above the causal diagonal): dS = 0
    for (int r = 0; r < BQ && q0 + r < n; ++r)
      for (int c = ntiles * BK + ctid; c < m; c += 128) out[(size_t)(q0 + r) * m + c] = 0.f;
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int qp = q0 + rl[ri];
    if (qp >= n) continue;
    T* o = dq + (bh * n + qp) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      tc::store2(o + 8 * j + 2 * t, dqa[4 * j + 2 * ri] * scale, dqa[4 * j + 2 * ri + 1] * scale);
  }
}

// K3: one block per (query head set, b*hk, 64-key tile, query chunk) of a
// producer warpgroup and consumers (see the note at the top). The blocks
// of one (b*hk, key tile, query chunk) form a thread-block cluster over the
// kv head's query heads.
// Shared memory (offsets from a 1024-byte aligned base): K and V, each an
// operand tile (with its small parts in float32), fixed for the block; the
// ring's stages of (Q, dO); per stage lse [64], Delta [64] and the table
// slice [128]; the key flags [64] and two words that say whether any is
// set; the barriers. After the loop the dK and dV partials of the block's
// sums take the stages' place. One consumer warpgroup (bf16, ~85 KB and
// 128 registers a thread at launch: two blocks an SM), or two that take
// the items in turn (float32, 199 KB, one block an SM; and bf16 where
// fewer than two blocks an SM would run), chosen by dkv_plan. At D = 128
// bf16 takes two (168 KB), float32 one with a single slot that an item's
// Q, dO and Q again take in turn (SEQ, three ring items an item; the
// partials then take K's and V's place).
template <typename T, int D, bool TWO>
struct Dkv {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr bool WIDE = D > 64;  // D = 128
  static constexpr bool SEQ = F32 && WIDE;
  static constexpr int PER = SEQ ? 3 : 1;  // ring items an item: Q, dO, Q; or Q and dO
  static constexpr int NC = TWO ? 2 : 1;  // consumer warpgroups
  static constexpr int NT = 128 * (1 + NC);
  static constexpr int MIN_BLOCKS = TWO || SEQ ? 1 : 2;
  static constexpr bool NREG = !SEQ;  // setmaxnreg; float32 at D = 128 keeps 255 each
  static constexpr int PRODUCER_REGS = TWO && !WIDE ? 56 : 24;  // as Fwd's
  static constexpr int CONSUMER_REGS = TWO ? (WIDE ? 240 : 224) : 232;
  static constexpr int ST = SEQ ? 1 : F32 ? 2 : 4;  // stages
  static constexpr int TILE = wg::tile_bytes<T, D>();
  static constexpr int NA = wg::acc_blocks<T, D>();  // dk's and dv's n-blocks
  static constexpr int OPER = F32 ? 2 * TILE : TILE;
  static constexpr int STAGE0 = 2 * OPER;
  static constexpr int STAGE = SEQ ? OPER : 2 * OPER;
  static constexpr int MISC = STAGE0 + ST * STAGE;
  static constexpr int MISC_STAGE = (64 + 64 + 128) * 4;
  static constexpr int FLAGS = MISC + ST * MISC_STAGE;
  static constexpr int BARS = FLAGS + (64 + 4) * 4;
  static constexpr int RP = D + 4;  // the partials' pitch in floats
  static constexpr int RED = SEQ ? 0 : STAGE0;  // where the partials go after the loop
  static constexpr size_t bytes = BARS + 128;
  static_assert(MISC - RED >= 2 * BK * RP * 4, "the partials fit");
  static_assert((2 + 3 * ST) * 8 <= 128, "the barriers fit");
  static_assert(bytes <= 232448, "a block's shared memory");
  static_assert(!NREG || ((65536 / (NT * MIN_BLOCKS)) & ~7) * (1 + NC)
                             == PRODUCER_REGS + NC * CONSUMER_REGS,
                "setmaxnreg hands over exactly the launch's registers");
  static_assert(NC <= ST, "a consumer waits on no stage two phases ahead");
};

template <typename T, int D, bool TWO>
__global__ void __launch_bounds__(Dkv<T, D, TWO>::NT, Dkv<T, D, TWO>::MIN_BLOCKS)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap gmap, const float* __restrict__ lse,
                     const float* __restrict__ delta, const float* __restrict__ tab,
                     const float* __restrict__ bias, const int8_t* __restrict__ kmask,
                     T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ part,
                     int bhk, int heads, int hk, int n, int m, float scale, int causal,
                     int qsplit, int bias_batched) {
  using L = Dkv<T, D, TWO>;
  constexpr int ST = L::ST, PER = L::PER;
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
  // is at [128 + c - r + BK - 1]; in the stage of the item's first ring item
  auto Ls = [&](int s) { return reinterpret_cast<float*>(sm + L::MISC + s * L::MISC_STAGE); };
  float* Fs = reinterpret_cast<float*>(sm + L::FLAGS);
  int* Fany = reinterpret_cast<int*>(Fs + 64);  // nonzero where a flag of keys 0-31 (32-63) is
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t *kvload = bars, *kvfull = bars + 1, *loaded = bars + 2, *full = loaded + ST,
           *empty = full + ST;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  // one-dimensional grid: the cluster's ranks, then b * hk + kv head, then
  // (key tile, query chunk)
  const int kvh = blockIdx.x / csize % bhk;  // b * hk + kv head
  const int b = kvh / hk, kh = kvh % hk, group = heads / hk;
  const int zz = blockIdx.x / csize / bhk;
  const int k0 = (zz / qsplit) * BK, z = zz % qsplit;
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
    if constexpr (L::NREG) wg::setmaxnreg_dec<L::PRODUCER_REGS>();
    if (tid == 0) {
      wg::mbar_arrive_tx(kvload, 2 * L::TILE);
      wg::load_tile<T, D>(Ks, &kmap, kvload, k0, kvh);
      wg::load_tile<T, D>(Vs, &vmap, kvload, k0, kvh);
    }
    if (tid < BK) {
      const float f = tc::key_flag(kmask, b, m, k0 + tid);
      Fs[tid] = f;
      const unsigned any = __ballot_sync(0xffffffffu, f != 0.f);
      if (tid % 32 == 0) Fany[tid / 32] = any != 0u;
    }
    // Ring item i into stage i % ST: item i / PER's Q and dO by TMA (SEQ:
    // its Q, dO and Q, one a ring item), lse, Delta and the table slice with
    // the item's first, from registers loaded an item ahead (a load's
    // latency, not the copies', would otherwise pace the ring).
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
    auto issue = [&](int i) {
      const int s = i % ST, it = i / PER, h = head(it), q0 = qtile(it);
      const bool first = i % PER == 0;
      const size_t bh = (size_t)b * heads + h;
      const float row_it = row_r, tab_it = tab_r;
      if (first && it + 1 < total) fetch(it + 1);
      wg::mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
      if (tid == 0) {
        if constexpr (L::F32) wg::mbar_arrive_tx(&loaded[s], (L::SEQ ? 1 : 2) * L::TILE);
        else wg::mbar_expect_tx(&full[s], 2 * L::TILE);
        uint64_t* bar = L::F32 ? &loaded[s] : &full[s];
        if constexpr (L::SEQ) {
          wg::load_tile<T, D>(Qs(s), i % PER == 1 ? &gmap : &qmap, bar, q0, (int)bh);
        } else {
          wg::load_tile<T, D>(Qs(s), &qmap, bar, q0, (int)bh);
          wg::load_tile<T, D>(Gs(s), &gmap, bar, q0, (int)bh);
        }
      }
      if (first) {
        float* ls = Ls(s);
        ls[tid] = row_it;
        if (tab != nullptr && tid < BQ + BK - 1) ls[2 * BQ + tid] = tab_it;
      }
      if constexpr (!L::F32) wg::mbar_arrive(&full[s]);
    };
    // float32: item i's copies landed; split them, then hand the stage over
    auto finish = [&](int i) {
      const int s = i % ST;
      wg::mbar_wait(&loaded[s], (i / ST) & 1);
      wg::split_tile<L::TILE>(reinterpret_cast<float*>(Qs(s)), reinterpret_cast<float*>(Ql(s)),
                              tid, 128);
      if constexpr (!L::SEQ)
        wg::split_tile<L::TILE>(reinterpret_cast<float*>(Gs(s)), reinterpret_cast<float*>(Gl(s)),
                                tid, 128);
      wg::fence_proxy_async();
      wg::mbar_arrive(&full[s]);
    };
    const int nitems = PER * total;
    if (nitems > 0) {
      fetch(0);
      issue(0);
    }
    wg::mbar_wait(kvload, 0);
    if constexpr (L::F32) {
      wg::split_tile<L::TILE>(reinterpret_cast<float*>(Ks), reinterpret_cast<float*>(Kl), tid,
                              128);
      wg::split_tile<L::TILE>(reinterpret_cast<float*>(Vs), reinterpret_cast<float*>(Vl), tid,
                              128);
      wg::fence_proxy_async();
    }
    wg::mbar_arrive(kvfull);
    for (int i = 1; i < nitems; ++i) {
      // one stage: item i - 1 handed over (and consumed) before item i loads
      if constexpr (L::F32 && ST == 1) finish(i - 1);
      issue(i);
      if constexpr (L::F32 && ST > 1) finish(i - 1);
    }
    if constexpr (L::F32)
      if (nitems > 0) finish(nitems - 1);
    // the cluster's two barriers of the head sum below
    tc::cluster_arrive();
    tc::cluster_wait();
    tc::cluster_arrive_relaxed();
    tc::cluster_wait();
    return;
  }

  // ---- the consumers: warpgroup c takes the items c, c + NC, ... ----
  if constexpr (L::NREG) wg::setmaxnreg_inc<L::CONSUMER_REGS>();
  const int c = tid / 128 - 1, ctid = tid % 128, warp = ctid / 32, gq = (ctid % 32) / 4,
            t = ctid % 4;
  const int kl[2] = {warp * 16 + gq, warp * 16 + gq + 8};  // this thread's keys in the tile
  wg::mbar_wait(kvfull, 0);
  const float fk[2] = {Fs[kl[0]], Fs[kl[1]]};
  const bool flagged = Fany[0] || Fany[1];
  const float sl = scale * tc::LOG2E;
  float dka[4 * L::NA], dva[4 * L::NA];
#pragma unroll
  for (int i = 0; i < 4 * L::NA; ++i) dka[i] = dva[i] = 0.f;

  for (int it = c; it < total; it += L::NC) {
    const int i0 = PER * it, s = i0 % ST, q0 = qtile(it);
    wg::mbar_wait(&full[s], (i0 / ST) & 1);
    float st[32], dpt[32];  // S^T and dP^T: rows keys, columns queries
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    wg::fence_acc(st);
    wg::fence_acc(dpt);
    wg::wgmma_fence();
    wg::gemm_nk<T, D>(st, Ks, Kl, Qs(s), Ql(s));
    if constexpr (!L::SEQ) wg::gemm_nk<T, D>(dpt, Vs, Vl, Gs(s), Gl(s));
    // The (H, N, M) bias: this thread's 32 elements straight from device
    // memory, loaded while the products run (see flash_fwd.cu for why not
    // by TMA or through shared memory); rows past n and keys past m: none.
    float bv[32];
    if (bias != nullptr) {
      // bias[h], or bias[b, h] of a per-batch bias
      const float* bh_bias =
          bias + (((bias_batched ? (size_t)b * heads : 0) + head(it)) * n + q0) * m + k0;
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
      if constexpr (!L::SEQ) dpt[i] = p * (dpt[i] - ls[BQ + cq]);
    }
    if constexpr (L::SEQ) {
      // Q's item done with; dO's into the slot: dP^T = V dO^T, dS, dV += P^T
      // dO; then Q's again: dK += dS^T Q
      wg::mbar_arrive(&empty[s]);
      const int s1 = (i0 + 1) % ST, s2 = (i0 + 2) % ST;
      wg::mbar_wait(&full[s1], ((i0 + 1) / ST) & 1);
      wg::fence_acc(dpt);
      wg::wgmma_fence();
      wg::gemm_nk<T, D>(dpt, Vs, Vl, Qs(s1), Ql(s1));
      wg::wgmma_wait<0>();
      wg::fence_acc(dpt);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int cq = 8 * (i / 4) + 2 * t + (i & 1);
        dpt[i] = st[i] * (dpt[i] - ls[BQ + cq]);
      }
      wg::add_pk_split<D>(dva, st, reinterpret_cast<const float*>(Qs(s1)),
                          reinterpret_cast<const float*>(Ql(s1)));
      wg::mbar_arrive(&empty[s1]);
      wg::mbar_wait(&full[s2], ((i0 + 2) / ST) & 1);
      wg::add_pk_split<D>(dka, dpt, reinterpret_cast<const float*>(Qs(s2)),
                          reinterpret_cast<const float*>(Ql(s2)));
      wg::mbar_arrive(&empty[s2]);
      continue;
    }
    // dV += P^T dO; dK += dS^T Q
    if constexpr (L::F32) {
      wg::add_pk_split<D>(dva, st, reinterpret_cast<const float*>(Gs(s)),
                          reinterpret_cast<const float*>(Gl(s)));
      wg::add_pk_split<D>(dka, dpt, reinterpret_cast<const float*>(Qs(s)),
                          reinterpret_cast<const float*>(Ql(s)));
    } else {
      wg::fence_acc(dva);
      wg::fence_acc(dka);
      wg::wgmma_fence();
      uint32_t pa[4][4], da[4][4];
      wg::gemm_pk<L::NA / 8>(dva, st, pa, reinterpret_cast<const __nv_bfloat16*>(Gs(s)));
      wg::gemm_pk<L::NA / 8>(dka, dpt, da, reinterpret_cast<const __nv_bfloat16*>(Qs(s)));
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
  float* red = reinterpret_cast<float*>(sm + L::RED);
  if constexpr (L::NC == 2) {
    tc::bar_sync(1, 256);
    if (c == 1) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
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
    for (int j = 0; j < D / 8; ++j)
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
    const size_t plane = (size_t)bhk * m * D;  // one chunk's dk or dv partial
    for (int i = tid - 128; i < BK * D; i += 128 * L::NC) {
      const int r = i / D, cc = i % D;
      if (k0 + r >= m) continue;
      float sk = 0.f, sv = 0.f;
      for (int src = 0; src < csize; ++src) {
        const float* p = cluster.map_shared_rank(red, src);
        sk += p[r * L::RP + cc];
        sv += p[(BK + r) * L::RP + cc];
      }
      const size_t o = ((size_t)kvh * m + k0 + r) * D + cc;
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

// K3 in bf16 at D = 256: one block per (query head set, b*hk, 64-key tile,
// query chunk), its grid, cluster and query split those of flash_bwd_dkv_kernel
// (dkv_plan), of a producer warpgroup and two consumer warpgroups, one a
// gradient. dK and dV of 64 keys x 256 are 128 float32 registers a thread
// each, so one warpgroup cannot hold both, and the D <= 128 shape (two
// consumers taking the items in turn, each with both) would need 256. So
// both consumers take every item: consumer A holds dK, forms S^T = K Q^T and
// P^T; consumer B holds dV, forms dP^T = V dO^T. A hands P^T to B and B
// hands dS^T = P^T (dP^T - Delta) back; then A takes dK += dS^T Q and B dV
// += P^T dO, each on wgmma with the tile as a transposed B. Every product
// runs once an item and the two consumers carry equal work; A's dK product
// of one item runs while B forms the next item's dP^T. The hand-offs go
// through shared memory in the accumulator's own layout (thread i of A and
// thread i of B hold the same elements: 16-byte stores and loads at [j *
// 128 + i], no swizzle, no bank conflict): P^T as float32 (16 KB, so B forms
// dS from P as the other forms do), dS^T as the bf16 pairs of the A operand
// (8 KB, the bits gemm_pk packs), single-buffered, each behind a full and a
// free mbarrier (a writer waits for the reader to free the previous
// item's). dk and dv sum over the items in order, each in one warpgroup,
// then over the cluster in rank order: the same bits every run.
// Shared memory (offsets from a 1024-byte aligned base): K and V (64 KB);
// two stages of (Q, dO) (128 KB); per stage lse [64], Delta [64] and the
// table slice [128]; the key flags [64] and two words; P^T (16 KB) and dS^T
// (8 KB); the barriers: 223,632 bytes, one block an SM. After the loop the
// dK and dV partials (pitch D + 4, 133,120 bytes) take K's, V's and the
// ring's place.
template <typename T, int D>
struct DkvPair {
  static_assert(sizeof(T) == 2, "bf16 only: float32's tiles with their small parts do not fit");
  static constexpr int NT = 384;  // the producer, consumer A (dK), consumer B (dV)
  static constexpr int MIN_BLOCKS = 1;
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
  static constexpr int ST = 2;  // stages
  static constexpr int TILE = wg::tile_bytes<T, D>();
  static constexpr int NA = wg::acc_blocks<T, D>();  // dk's or dv's n-blocks
  static constexpr int STAGE0 = 2 * TILE;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int MISC = STAGE0 + ST * STAGE;
  static constexpr int MISC_STAGE = (64 + 64 + 128) * 4;
  static constexpr int FLAGS = MISC + ST * MISC_STAGE;
  static constexpr int PX = FLAGS + (64 + 4) * 4;  // P^T: 32 floats a thread of A
  static constexpr int DSX = PX + BK * BQ * 4;     // dS^T: 16 bf16 pairs a thread of B
  static constexpr int BARS = DSX + BK * BQ * 2;
  static constexpr int RP = D + 4;  // the partials' pitch in floats
  static constexpr size_t bytes = BARS + 128;
  static_assert(PX % 16 == 0 && DSX % 16 == 0, "16-byte hand-off stores");
  static_assert(MISC >= 2 * BK * RP * 4, "the partials fit in K's, V's and the ring's place");
  static_assert((2 + 2 * ST + 4) * 8 <= 128, "the barriers fit");
  static_assert(bytes <= 232448, "a block's shared memory");
  static_assert(((65536 / NT) & ~7) * 3 == PRODUCER_REGS + 2 * CONSUMER_REGS,
                "setmaxnreg hands over exactly the launch's registers");
};

template <typename T, int D>
__global__ void __launch_bounds__(DkvPair<T, D>::NT, DkvPair<T, D>::MIN_BLOCKS)
flash_bwd_dkv_pair_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap gmap, const float* __restrict__ lse,
                          const float* __restrict__ delta, const float* __restrict__ tab,
                          const float* __restrict__ bias, const int8_t* __restrict__ kmask,
                          T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ part,
                          int bhk, int heads, int hk, int n, int m, float scale, int causal,
                          int qsplit, int bias_batched) {
  using L = DkvPair<T, D>;
  constexpr int ST = L::ST;
  extern __shared__ __align__(1024) unsigned char dkv_pair_smem[];
  unsigned char* sm = dkv_pair_smem;
  if (threadIdx.x == 0 && (tc::smem_u32(sm) & 1023) != 0) __trap();  // the tiles' swizzle
  T* Ks = reinterpret_cast<T*>(sm);
  T* Vs = reinterpret_cast<T*>(sm + L::TILE);
  auto Qs = [&](int s) { return reinterpret_cast<T*>(sm + L::STAGE0 + s * L::STAGE); };
  auto Gs = [&](int s) { return reinterpret_cast<T*>(sm + L::STAGE0 + s * L::STAGE + L::TILE); };
  // log2(e) lse (+inf where p = 0), Delta, log2(e) times the table slice, as
  // flash_bwd_dkv_kernel's
  auto Ls = [&](int s) { return reinterpret_cast<float*>(sm + L::MISC + s * L::MISC_STAGE); };
  float* Fs = reinterpret_cast<float*>(sm + L::FLAGS);
  int* Fany = reinterpret_cast<int*>(Fs + 64);  // nonzero where a flag of keys 0-31 (32-63) is
  float4* px = reinterpret_cast<float4*>(sm + L::PX);
  uint4* dsx = reinterpret_cast<uint4*>(sm + L::DSX);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t *kvload = bars, *kvfull = bars + 1, *full = bars + 2, *empty = full + ST,
           *pready = empty + ST, *pfree = pready + 1, *dsready = pfree + 1, *dsfree = dsready + 1;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  // the grid as flash_bwd_dkv_kernel's: the cluster's ranks, then b * hk +
  // kv head, then (key tile, query chunk)
  const int kvh = blockIdx.x / csize % bhk;
  const int b = kvh / hk, kh = kvh % hk, group = heads / hk;
  const int zz = blockIdx.x / csize / bhk;
  const int k0 = (zz / qsplit) * BK, z = zz % qsplit;
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
      wg::mbar_init(&full[s], 128);
      wg::mbar_init(&empty[s], 256);  // both consumers take every item
    }
    wg::mbar_init(pready, 128);
    wg::mbar_init(pfree, 128);
    wg::mbar_init(dsready, 128);
    wg::mbar_init(dsfree, 128);
    wg::fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- the producer: flash_bwd_dkv_kernel's in bf16, one ring item an item ----
    wg::setmaxnreg_dec<L::PRODUCER_REGS>();
    if (tid == 0) {
      wg::mbar_arrive_tx(kvload, 2 * L::TILE);
      wg::load_tile<T, D>(Ks, &kmap, kvload, k0, kvh);
      wg::load_tile<T, D>(Vs, &vmap, kvload, k0, kvh);
    }
    if (tid < BK) {
      const float f = tc::key_flag(kmask, b, m, k0 + tid);
      Fs[tid] = f;
      const unsigned any = __ballot_sync(0xffffffffu, f != 0.f);
      if (tid % 32 == 0) Fany[tid / 32] = any != 0u;
    }
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
      const int s = it % ST, q0 = qtile(it);
      const size_t bh = (size_t)b * heads + head(it);
      const float row_it = row_r, tab_it = tab_r;
      if (it + 1 < total) fetch(it + 1);
      wg::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
      if (tid == 0) {
        wg::mbar_expect_tx(&full[s], 2 * L::TILE);
        wg::load_tile<T, D>(Qs(s), &qmap, &full[s], q0, (int)bh);
        wg::load_tile<T, D>(Gs(s), &gmap, &full[s], q0, (int)bh);
      }
      float* ls = Ls(s);
      ls[tid] = row_it;
      if (tab != nullptr && tid < BQ + BK - 1) ls[2 * BQ + tid] = tab_it;
      wg::mbar_arrive(&full[s]);
    };
    if (total > 0) {
      fetch(0);
      issue(0);
    }
    wg::mbar_wait(kvload, 0);
    wg::mbar_arrive(kvfull);
    for (int it = 1; it < total; ++it) issue(it);
    // the cluster's two barriers of the head sum below
    tc::cluster_arrive();
    tc::cluster_wait();
    tc::cluster_arrive_relaxed();
    tc::cluster_wait();
    return;
  }

  // ---- the consumers: A (threads 128-255) dK, B (256-383) dV ----
  wg::setmaxnreg_inc<L::CONSUMER_REGS>();
  const bool holds_dk = tid < 256;
  const int ctid = tid % 128, warp = ctid / 32, gq = (ctid % 32) / 4, t = ctid % 4;
  const int kl[2] = {warp * 16 + gq, warp * 16 + gq + 8};  // this thread's keys in the tile
  wg::mbar_wait(kvfull, 0);
  const float fk[2] = {Fs[kl[0]], Fs[kl[1]]};
  const bool flagged = Fany[0] || Fany[1];
  const float sl = scale * tc::LOG2E;
  float acc[4 * L::NA];  // dK (A) or dV (B): rows keys, columns the head dim
#pragma unroll
  for (int i = 0; i < 4 * L::NA; ++i) acc[i] = 0.f;
  const T* rows_op = holds_dk ? Ks : Vs;

  for (int it = 0; it < total; ++it) {
    const int s = it % ST, q0 = qtile(it);
    wg::mbar_wait(&full[s], (it / ST) & 1);
    // A: S^T = K Q^T, then P^T; B: dP^T = V dO^T, then dS^T (rows keys,
    // columns queries)
    float x[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.f;
    wg::fence_acc(x);
    wg::wgmma_fence();
    wg::gemm_nk<T, D>(x, rows_op, nullptr, holds_dk ? Qs(s) : Gs(s), nullptr);
    const float* ls = Ls(s);
    if (holds_dk) {
      // The (H, N, M) bias, loaded while the product runs, as in
      // flash_bwd_dkv_kernel
      float bv[32];
      if (bias != nullptr) {
        const float* bh_bias =
            bias + (((bias_batched ? (size_t)b * heads : 0) + head(it)) * n + q0) * m + k0;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int cq = 8 * (i / 4) + 2 * t + (i & 1), kr = kl[(i / 2) & 1];
          bv[i] = q0 + cq < n && k0 + kr < m ? __ldg(bh_bias + (size_t)cq * m + kr) : 0.f;
        }
      }
      wg::wgmma_wait<0>();
      wg::fence_acc(x);
      // p = 2^(y - log2(e) lse) by flash_bwd_dkv_kernel's masking rule
      const bool diag = causal && tc::above(k0 + warp * 16 + 15, q0, off);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int cq = 8 * (i / 4) + 2 * t + (i & 1), ri = (i / 2) & 1, kr = kl[ri];
        float bc = 0.f;
        if (tab != nullptr) bc = ls[2 * BQ + cq - kr + BK - 1];
        else if (bias != nullptr) bc = tc::LOG2E * bv[i];
        float y = fmaf(x[i], sl, bc);
        if (diag) y = tc::above(k0 + kr, q0 + cq, off) ? fminf(NEG, fk[ri]) : y + fk[ri];
        else if (flagged) y += fk[ri];
        x[i] = tc::ex2(y - ls[cq]);
      }
      // P^T to B once B has read the previous item's; dS^T back from B
      if (it > 0) wg::mbar_wait(pfree, (it - 1) & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        px[j * 128 + ctid] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      wg::mbar_arrive(pready);
      uint32_t da[4][4];
      wg::mbar_wait(dsready, it & 1);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint4 w = dsx[ks * 128 + ctid];
        da[ks][0] = w.x;
        da[ks][1] = w.y;
        da[ks][2] = w.z;
        da[ks][3] = w.w;
      }
      wg::mbar_arrive(dsfree);
      // dK += dS^T Q, Q's tile as a transposed B
      wg::fence_acc(acc);
      wg::gemm_rk<L::NA / 8>(acc, da, Qs(s));
      wg::wgmma_wait<0>();
      wg::fence_acc(acc);
    } else {
      wg::wgmma_wait<0>();
      wg::fence_acc(x);
      float p[32];
      wg::mbar_wait(pready, it & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 v = px[j * 128 + ctid];
        p[4 * j] = v.x;
        p[4 * j + 1] = v.y;
        p[4 * j + 2] = v.z;
        p[4 * j + 3] = v.w;
      }
      wg::mbar_arrive(pfree);
      // dS^T = P^T (dP^T - Delta), packed as the A operand of A's product
      uint32_t ds[4][4];
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = p[i] * (x[i] - ls[BQ + 8 * (i / 4) + 2 * t + (i & 1)]);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ds[ks][i] = tc::pack_bf16(x[8 * ks + 2 * i], x[8 * ks + 2 * i + 1]);
      if (it > 0) wg::mbar_wait(dsfree, (it - 1) & 1);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        dsx[ks * 128 + ctid] = make_uint4(ds[ks][0], ds[ks][1], ds[ks][2], ds[ks][3]);
      wg::mbar_arrive(dsready);
      // dV += P^T dO, dO's tile as a transposed B
      wg::fence_acc(acc);
      uint32_t pa[4][4];
      wg::gemm_pk<L::NA / 8>(acc, p, pa, Gs(s));
      wg::wgmma_wait<0>();
      wg::fence_acc(acc);
    }
    wg::mbar_arrive(&empty[s]);
  }

  // The partials (A's dK, B's dV) into K's, V's and the ring's place once
  // both consumers are done with them; then the head sum over the cluster
  // in rank order, as flash_bwd_dkv_kernel's: no atomics.
  float* red = reinterpret_cast<float*>(sm);
  tc::bar_sync(1, 256);
  float* mine = red + (holds_dk ? 0 : BK * L::RP);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
      tc::store2(mine + kl[ri] * L::RP + 8 * j + 2 * t, acc[4 * j + 2 * ri],
                 acc[4 * j + 2 * ri + 1]);
  tc::cluster_arrive();
  tc::cluster_wait();
  if (rank == 0) {
    const size_t plane = (size_t)bhk * m * D;  // one chunk's dk or dv partial
    for (int i = tid - 128; i < BK * D; i += 256) {
      const int r = i / D, cc = i % D;
      if (k0 + r >= m) continue;
      float sk = 0.f, sv = 0.f;
      for (int src = 0; src < csize; ++src) {
        const float* p = cluster.map_shared_rank(red, src);
        sk += p[r * L::RP + cc];
        sv += p[(BK + r) * L::RP + cc];
      }
      const size_t o = ((size_t)kvh * m + k0 + r) * D + cc;
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

// K2 in float32 at D = 256, the chunked form (see the note at the top): one
// block per (batch row, head, 64-row query tile), its grid, order and
// cluster flash_bwd_dq_kernel's, of a producer warpgroup and one consumer
// warpgroup. Q and dO are resident and unsplit, each the A operand of its
// score product, split k-step by k-step in registers
// (wg::gemm_nk_rs_chunk); K and V stream through a two-stage TMA ring 64
// columns at a time, each chunk split in place by the producer. A key
// tile's 12 ring items: K's four chunks for S = Q K^T, V's four for dP = dO
// V^T, then K's four again, split transposed (wg::split_tile_t), for dq +=
// dS K on wgmma with dS from the registers (wg::add_pk_chunk). K4, K5 and
// the per-batch dS as flash_bwd_dq_kernel's, in the same order.
// Shared memory (offsets from a 1024-byte aligned base): Q and dO, 64 KB
// each; two stages of a chunk and its small parts, 32 KB each; for each key
// tile's parity log2(e) times the table slice [128], the key flags [64] and
// two words (784 bytes each); the barriers (256): EXTRA 198,432 bytes; then
// K4's buffers (24 KB: 223,008) or K5's two dS buffers (32 KB: 231,200,
// 1,248 bytes under the limit). One block an SM; no setmaxnreg: the
// consumer's dq takes 128 registers a thread.
template <int D, bool SUM>
struct DqChunk {
  static_assert(D == F32_DIM, "float32's chunked form is laid out for D = 256");
  static constexpr int NT = 256;  // the producer warpgroup, then the consumer warpgroup
  static constexpr int MIN_BLOCKS = 1;
  static constexpr int ST = 2;  // stages
  static constexpr int NCH = D / wg::CHUNK;  // chunks of the depth
  static constexpr int PER = 3 * NCH;  // ring items a key tile: K's, V's, K's chunks
  static constexpr int TILE = wg::tile_bytes<float, D>();  // Q or dO, unsplit
  static constexpr int STAGE0 = 2 * TILE;
  static constexpr int STAGE = 2 * wg::CHUNK_BYTES;  // a chunk and its small parts
  static constexpr int MISC = STAGE0 + ST * STAGE;
  static constexpr int MISC_TILE = (128 + 64 + 4) * 4;
  static constexpr int BARS = MISC + 2 * MISC_TILE;
  static constexpr int EXTRA = BARS + 256;
  static constexpr int K4_BYTES = Dq<float, 64, false>::K4_BYTES;
  static constexpr int K5_BYTES = Dq<float, 64, false>::K5_BYTES;
  static constexpr size_t most = EXTRA + (SUM ? K5_BYTES : K4_BYTES);
  static_assert(EXTRA == 198432 && most <= 232448, "a block's shared memory");
  static_assert((1 + 3 * ST + 4) * 8 <= 256, "the barriers fit");
};

template <int D, int DB>
__global__ void __launch_bounds__(DqChunk<D, DB == DB_SUM>::NT, 1)
flash_bwd_dq_chunk_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap gmap, const float* __restrict__ lse,
                          const float* __restrict__ delta, const float* __restrict__ tab,
                          const float* __restrict__ bias, const int8_t* __restrict__ kmask,
                          float* __restrict__ dq, float* __restrict__ dpart,
                          float* __restrict__ dbias, int bcount, int heads, int group, int n,
                          int m, float scale, int causal, int bias_batched) {
  constexpr bool SUM = DB == DB_SUM, EACH = DB == DB_EACH;
  using L = DqChunk<D, SUM>;
  constexpr int ST = L::ST, PER = L::PER, NCH = L::NCH, CH = wg::CHUNK;
  extern __shared__ __align__(1024) unsigned char dq_chunk_smem[];
  unsigned char* sm = dq_chunk_smem;
  if (threadIdx.x == 0 && (tc::smem_u32(sm) & 1023) != 0) __trap();  // the tiles' swizzle
  float* Qs = reinterpret_cast<float*>(sm);
  float* Gs = reinterpret_cast<float*>(sm + L::TILE);
  auto Xh = [&](int s) { return reinterpret_cast<float*>(sm + L::STAGE0 + s * L::STAGE); };
  auto Xl = [&](int s) {
    return reinterpret_cast<float*>(sm + L::STAGE0 + s * L::STAGE + wg::CHUNK_BYTES);
  };
  // key tile it's table slice (as flash_bwd_dq_kernel's Bs), key flags and
  // two words, in the buffer of its parity
  auto Bs = [&](int it) { return reinterpret_cast<float*>(sm + L::MISC + (it & 1) * L::MISC_TILE); };
  auto Fs = [&](int it) { return Bs(it) + 128; };
  auto As = [&](int it) { return reinterpret_cast<int*>(Bs(it) + 128 + 64); };
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t *qload = bars, *loaded = bars + 1, *full = loaded + ST, *empty = full + ST,
           *dsready = empty + ST, *dsfree = dsready + 2;
  float* extra = reinterpret_cast<float*>(sm + L::EXTRA);

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  // one-dimensional grid: batch rows fastest, then heads, then query tiles
  const int b = blockIdx.x % bcount, h = blockIdx.x / bcount % heads;
  const int nqt = (n + BQ - 1) / BQ, qt = blockIdx.x / bcount / heads;
  const int q0 = (nqt - 1 - qt) * BQ;  // the longest causal rows first
  const size_t bh = (size_t)b * heads + h;
  const int off = m - n;
  const int kv_end = tc::causal_end(causal, q0 + BQ, off, m);
  const int ntiles = (kv_end + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    wg::mbar_init(qload, 1);
    for (int s = 0; s < ST; ++s) {
      wg::mbar_init(&loaded[s], 1);
      wg::mbar_init(&full[s], 128);
      wg::mbar_init(&empty[s], 128);
    }
    for (int i = 0; i < 2; ++i) {  // K5: one arrival from each rank of the cluster
      wg::mbar_init(&dsready[i], csize);
      wg::mbar_init(&dsfree[i], csize);
    }
    wg::fence_barrier_init();
  }
  __syncthreads();
  if constexpr (SUM) {
    tc::cluster_arrive();
    tc::cluster_wait();
  }
  const bool atomic = SUM && csize < bcount;
  float* out = SUM ? dbias + (size_t)h * n * m : EACH ? dbias + bh * n * m : nullptr;
  auto dsb = [&](int it) { return extra + (it & 1) * BQ * BK; };

  if (tid < 128) {
    // ---- the producer ----
    const int kvp = (int)(bh / group);
    if (tid == 0) {
      wg::mbar_arrive_tx(qload, 2 * L::TILE);
      wg::load_tile<float, D>(Qs, &qmap, qload, q0, (int)bh);
      wg::load_tile<float, D>(Gs, &gmap, qload, q0, (int)bh);
    }
    float tab_r = 0.f, flag_r = 0.f;
    auto fetch = [&](int it) {
      const int k0 = it * BK;
      if (tab != nullptr && tid < BQ + BK - 1)
        tab_r = tc::LOG2E * tc::tab_entry(tab, q0, k0, BK, tid, n, heads, h);
      if (tid < BK) flag_r = tc::key_flag(kmask, b, m, k0 + tid);
    };
    // Ring item i into stage i % ST: chunk j % NCH of K (j < NCH, and j >=
    // 2 NCH) or V, j = i % PER, by TMA; the table slice and key flags with
    // the tile's first item, from registers loaded a tile ahead
    auto issue = [&](int i) {
      const int s = i % ST, it = i / PER, j = i % PER;
      const float tab_it = tab_r, flag_it = flag_r;
      if (j == 0 && it + 1 < ntiles) fetch(it + 1);
      wg::mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
      if (tid == 0) {
        wg::mbar_arrive_tx(&loaded[s], wg::CHUNK_BYTES);
        wg::load_chunk(Xh(s), j / NCH == 1 ? &vmap : &kmap, &loaded[s], j % NCH * CH, it * BK,
                       kvp);
      }
      if (j == 0) {
        if (tab != nullptr && tid < BQ + BK - 1) Bs(it)[tid] = tab_it;
        if (tid < BK) {
          Fs(it)[tid] = flag_it;
          const unsigned any = __ballot_sync(0xffffffffu, flag_it != 0.f);
          if (tid % 32 == 0) As(it)[tid / 32] = any != 0u;
        }
      }
    };
    // item i's copies landed: split them in place (K's chunks for dq
    // transposed, as that product's B), then hand the stage over
    auto finish = [&](int i) {
      const int s = i % ST;
      wg::mbar_wait(&loaded[s], (i / ST) & 1);
      if (i % PER < 2 * NCH) wg::split_tile<wg::CHUNK_BYTES>(Xh(s), Xl(s), tid, 128);
      else wg::split_tile_t(Xh(s), Xl(s), tid, 3);
      wg::fence_proxy_async();
      wg::mbar_arrive(&full[s]);
    };
    // K5 of tile it, as flash_bwd_dq_kernel's: after tile it + 1's first
    // item is issued (and tile it's last split), so this block's consumer is
    // done with tile it's dS by then or soon
    auto batch_sum = [&](int it) {
      wg::mbar_wait<true>(&dsready[it & 1], (it / 2) & 1);
      batch_sum_rows(cluster, dsb(it), out, q0, it * BK, n, m, atomic, tid);
      tc::bar_sync(2, 128);
      if (tid < csize) wg::mbar_arrive_remote(&dsfree[it & 1], tid);
    };
    const int nitems = PER * ntiles;
    fetch(0);
    if (nitems > 0) issue(0);
    for (int i = 1; i < nitems; ++i) {
      issue(i);
      finish(i - 1);
      if constexpr (SUM)
        if (i % PER == 0) batch_sum(i / PER - 1);
    }
    if (nitems > 0) finish(nitems - 1);
    if constexpr (SUM) {
      if (ntiles > 0) batch_sum(ntiles - 1);
      // no block leaves while the cluster still reads its dS
      wg::mbar_wait<true>(&dsfree[(ntiles - 1) & 1], ((ntiles - 1) / 2) & 1);
      if (ntiles >= 2) wg::mbar_wait<true>(&dsfree[ntiles & 1], ((ntiles - 2) / 2) & 1);
      if (!atomic && kv_end < m) {
        const int rank = (int)cluster.block_rank();
        const int r_hi = min((rank + 1) * BQ / csize, n - q0);
        for (int r = rank * BQ / csize; r < r_hi; ++r) {
          float* o = out + (size_t)(q0 + r) * m;
          for (int c = kv_end + tid; c < m; c += 128) o[c] = 0.f;
        }
      }
    }
    return;
  }

  // ---- the consumer ----
  const int ctid = tid - 128, warp = ctid / 32, lane = ctid % 32, gq = lane / 4, t = lane % 4;
  const int rl[2] = {warp * 16 + gq, warp * 16 + gq + 8};  // this thread's rows in the tile
  const float* biash = bias != nullptr ? bias + (bias_batched ? bh : h) * n * m : nullptr;
  const float* brow[2] = {biash != nullptr && q0 + rl[0] < n ? biash + (size_t)(q0 + rl[0]) * m
                                                             : nullptr,
                          biash != nullptr && q0 + rl[1] < n ? biash + (size_t)(q0 + rl[1]) * m
                                                             : nullptr};
  float lse_r[2], dl_r[2];  // log2(e) lse (+inf where p = 0) and Delta
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int qp = q0 + rl[ri];
    const float l = qp < n ? lse[bh * n + qp] : INFINITY;
    lse_r[ri] = l > 0.5f * NEG ? tc::LOG2E * l : INFINITY;
    dl_r[ri] = qp < n ? delta[bh * n + qp] : 0.f;
  }
  // K4, as flash_bwd_dq_kernel's: a strip's skewed dS rows, the delta slots
  // of tile it (two buffers), and the delta this thread owns
  float* sk = extra + warp * 8 * SKP;
  auto dsl = [&](int it) { return extra + BQ * SKP + (it & 1) * 4 * DSL; };
  const int nkt = (m + BK - 1) / BK;
  float* prow = dpart != nullptr
                    ? dpart + (bh * nqt + q0 / BQ) * (size_t)(BK * (nkt + 1)) : nullptr;
  int a_cur = -1;
  float a_sum = 0.f;
  if (dpart != nullptr) {
    for (int i = ctid; i < BQ * SKP + 2 * 4 * DSL; i += 128) extra[i] = 0.f;
    tc::bar_sync(1, 128);
  }
  const float sl = scale * tc::LOG2E;
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  wg::mbar_wait(qload, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int i0 = PER * it, k0 = it * BK;  // i0 is even: chunk c's stage is c % 2
    float sc[32], ds[32], bv[32];  // S, then P; dP, then dS (rows queries, columns keys)
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    // S = Q K^T over K's chunks; the (H, N, M) bias read from device memory
    // while the last chunk's products run
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int i = i0 + c, s = c % ST;
      wg::mbar_wait(&full[s], (i / ST) & 1);
      wg::fence_acc(sc);
      wg::gemm_nk_rs_chunk(sc, Qs, c * CH, Xh(s), Xl(s), c == 0);
      if (c == NCH - 1 && biash != nullptr) {
        const bool whole = k0 + BK <= m;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const float* row = brow[(e / 2) & 1];
          const int kc = k0 + 8 * (e / 4) + 2 * t + (e & 1);
          bv[e] = row != nullptr && (whole || kc < m) ? __ldg(row + kc) : 0.f;
        }
      }
      wg::wgmma_wait<0>();
      wg::fence_acc(sc);
      wg::mbar_arrive(&empty[s]);
    }
    // p = 2^(y - log2(e) lse) by flash_bwd_dq_kernel's masking rule, into sc
    const float* bs = Bs(it);
    const float* fs = Fs(it);
    const bool diag = causal && tc::above(k0 + BK - 1, q0 + warp * 16, off);
    const bool flagged = As(it)[0] || As(it)[1];
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
        const int e = 4 * j + 2 * ri;
        float y0 = fmaf(sc[e], sl, bb.x), y1 = fmaf(sc[e + 1], sl, bb.y);
        if (diag) {
          const int qp = q0 + rl[ri];
          y0 = tc::above(k0 + cc, qp, off) ? fminf(NEG, f.x) : y0 + f.x;
          y1 = tc::above(k0 + cc + 1, qp, off) ? fminf(NEG, f.y) : y1 + f.y;
        } else if (flagged) {
          y0 += f.x;
          y1 += f.y;
        }
        sc[e] = tc::ex2(y0 - lse_r[ri]);
        sc[e + 1] = tc::ex2(y1 - lse_r[ri]);
      }
    }
    // dP = dO V^T over V's chunks, then dS = P (dP - Delta)
#pragma unroll
    for (int i = 0; i < 32; ++i) ds[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int i = i0 + NCH + c, s = c % ST;
      wg::mbar_wait(&full[s], (i / ST) & 1);
      wg::fence_acc(ds);
      wg::gemm_nk_rs_chunk(ds, Gs, c * CH, Xh(s), Xl(s), c == 0);
      wg::wgmma_wait<0>();
      wg::fence_acc(ds);
      wg::mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) ds[e] = sc[e] * (ds[e] - dl_r[(e / 2) & 1]);
    if (dpart != nullptr) {
      // K4: the strip's diagonals, as flash_bwd_dq_kernel's
      float* row = sk + gq * SKP + 2 * t - gq + 15;
#pragma unroll
      for (int j = -1; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          row[8 * j + e] = (j >= 0 ? ds[4 * j + e] : 0.f) + (j + 1 < BK / 8 ? ds[4 * j + 6 + e] : 0.f);
      __syncwarp();
      for (int x = lane; x < BK + 15; x += 32) {
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int r = 0; r < 8; r += 2) {
          sum0 += sk[r * SKP + x];
          sum1 += sk[(r + 1) * SKP + x];
        }
        dsl(it)[warp * DSL + 48 - 16 * warp + x] = sum0 + sum1;
      }
    }
    if constexpr (EACH) {
      // a per-batch bias: this thread's dS elements are their gradient
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int qp = q0 + rl[ri];
        if (qp >= n) continue;
        float* o = out + (size_t)qp * m + k0;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = 8 * j + 2 * t + e;
            if (k0 + cc < m) o[cc] = ds[4 * j + 2 * ri + e];
          }
      }
    }
    if constexpr (SUM) {
      // K5: dS into buffer it % 2 once every rank has summed tile it - 2
      // from it, then every rank told
      if (it >= 2) wg::mbar_wait<true>(&dsfree[it & 1], ((it / 2) - 1) & 1);
      float* dst = dsb(it);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int ri = 0; ri < 2; ++ri)
          tc::store2(dst + ds_at(rl[ri], 8 * j + 2 * t), ds[4 * j + 2 * ri], ds[4 * j + 2 * ri + 1]);
      tc::bar_sync(1, 128);
      if (ctid < csize) wg::mbar_arrive_remote(&dsready[it & 1], ctid);
    }
    // dq += dS K over K's chunks again (transposed), on wgmma with dS from
    // the registers, one 64-column chunk of dq each
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int i = i0 + 2 * NCH + c, s = c % ST;
      wg::mbar_wait(&full[s], (i / ST) & 1);
      wg::add_pk_chunk<D>(dqa, ds, Xh(s), Xl(s), c * CH);
      wg::mbar_arrive(&empty[s]);
    }
    if (dpart != nullptr) {
      tc::bar_sync(1, 128);  // every strip's slots of this tile are in
      const int a = k0 + ((ctid - k0) & (DSL - 1));
      if (a != a_cur) {
        if (a_cur >= 0) prow[a_cur] = a_sum;
        a_cur = a;
        a_sum = 0.f;
      }
      const float* d = dsl(it) + (a - k0);
      a_sum += ((d[0] + d[DSL]) + d[2 * DSL]) + d[3 * DSL];
    }
  }
  if (dpart != nullptr && a_cur >= 0) prow[a_cur] = a_sum;
  if constexpr (EACH) {
    for (int r = 0; r < BQ && q0 + r < n; ++r)
      for (int c = ntiles * BK + ctid; c < m; c += 128) out[(size_t)(q0 + r) * m + c] = 0.f;
  }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int qp = q0 + rl[ri];
    if (qp >= n) continue;
    float* o = dq + (bh * n + qp) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      tc::store2(o + 8 * j + 2 * t, dqa[4 * j + 2 * ri] * scale, dqa[4 * j + 2 * ri + 1] * scale);
  }
}

// K3 in float32 at D = 256, the chunked pair form: one block per (query head
// set, b*hk, 64-key tile, query chunk), its grid, cluster and query split
// those of flash_bwd_dkv_kernel (dkv_plan), of a producer warpgroup and two
// consumer warpgroups, one a gradient, as flash_bwd_dkv_pair_kernel's: dK
// and dV of 64 keys x 256 are 128 float32 registers a thread each. K and V
// are resident and unsplit, each the A operand of its score product, split
// k-step by k-step in registers. Q and dO stream through a two-stage TMA ring
// 64 columns at a time, in turns: stage 0 holds consumer A's chunks (Q),
// stage 1 consumer B's (dO), so each consumer waits only on its own stage
// and the two work at once. An item's 16 ring items: Q's and dO's four
// chunks in turns, A taking Q's for S^T = K Q^T and B dO's for dP^T = V
// dO^T; then both four again in turns, for dK += dS^T Q (A) and dV += P^T dO
// (B), on wgmma with the chunk split transposed (wg::split_tile_t,
// wg::add_pk_chunk). A consumer splits each chunk it takes in place itself
// (the producer only issues the copies): A's and B's splits run at once,
// where one producer's would take turns. A hands P^T to B and B hands dS^T
// = P^T (dP^T - Delta) back, both as float32 through shared memory in the
// accumulator's own layout, read k-step by k-step by the products, each
// behind a full and a free mbarrier; the producer's lse, Delta and table
// slice of an item behind one more (mready). dk and dv sum over the items in
// order, each in one warpgroup, then over the cluster in rank order: the
// same bits every run. Shared memory (offsets from a 1024-byte aligned
// base): K and V unsplit (128 KB); the two stages of a chunk and its small
// parts (64 KB); for each item's parity lse [64], Delta [64] and the table
// slice [128] (2 x 1,024 bytes); the key flags [64] and two words; P^T and
// dS^T (16 KB each); the barriers: 231,824 bytes, one block an SM. After the
// loop the dK and dV partials (pitch D + 4, 133,120 bytes) take K's, V's and
// the ring's place.
template <int D>
struct DkvChunk {
  static_assert(D == F32_DIM, "float32's chunked form is laid out for D = 256");
  static constexpr int NT = 384;  // the producer, consumer A (dK), consumer B (dV)
  static constexpr int MIN_BLOCKS = 1;
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
  static constexpr int ST = 2;  // stages: A's and B's
  static constexpr int NCH = D / wg::CHUNK;  // chunks of the depth
  static constexpr int PER = 4 * NCH;  // ring items an item: Q's and dO's, then both again
  static constexpr int TILE = wg::tile_bytes<float, D>();  // K or V, unsplit
  static constexpr int STAGE0 = 2 * TILE;
  static constexpr int STAGE = 2 * wg::CHUNK_BYTES;
  static constexpr int MISC = STAGE0 + ST * STAGE;
  static constexpr int MISC_ITEM = (64 + 64 + 128) * 4;
  static constexpr int FLAGS = MISC + 2 * MISC_ITEM;
  static constexpr int PX = FLAGS + (64 + 4) * 4;  // P^T: 32 floats a thread of A
  static constexpr int DSX = PX + BK * BQ * 4;     // dS^T: 32 floats a thread of B
  static constexpr int BARS = DSX + BK * BQ * 4;
  static constexpr int RP = D + 4;  // the partials' pitch in floats
  static constexpr size_t bytes = BARS + 128;
  static_assert(PX % 16 == 0 && DSX % 16 == 0, "16-byte hand-off stores");
  static_assert(MISC >= 2 * BK * RP * 4, "the partials fit in K's, V's and the ring's place");
  static_assert((2 + 2 * ST + 4 + 2) * 8 <= 128, "the barriers fit");
  static_assert(bytes == 231824 && bytes <= 232448, "a block's shared memory");
  static_assert(ST == 2 && PER % 2 == 0, "ring item i in stage i % 2: A's even, B's odd");
  static_assert(((65536 / NT) & ~7) * 3 == PRODUCER_REGS + 2 * CONSUMER_REGS,
                "setmaxnreg hands over exactly the launch's registers");
};

template <int D>
__global__ void __launch_bounds__(DkvChunk<D>::NT, 1)
flash_bwd_dkv_chunk_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap gmap,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const float* __restrict__ tab, const float* __restrict__ bias,
                           const int8_t* __restrict__ kmask, float* __restrict__ dk,
                           float* __restrict__ dv, float* __restrict__ part, int bhk, int heads,
                           int hk, int n, int m, float scale, int causal, int qsplit,
                           int bias_batched) {
  using L = DkvChunk<D>;
  constexpr int ST = L::ST, PER = L::PER, NCH = L::NCH, CH = wg::CHUNK;
  extern __shared__ __align__(1024) unsigned char dkv_chunk_smem[];
  unsigned char* sm = dkv_chunk_smem;
  if (threadIdx.x == 0 && (tc::smem_u32(sm) & 1023) != 0) __trap();  // the tiles' swizzle
  float* Ks = reinterpret_cast<float*>(sm);
  float* Vs = reinterpret_cast<float*>(sm + L::TILE);
  auto Xh = [&](int s) { return reinterpret_cast<float*>(sm + L::STAGE0 + s * L::STAGE); };
  auto Xl = [&](int s) {
    return reinterpret_cast<float*>(sm + L::STAGE0 + s * L::STAGE + wg::CHUNK_BYTES);
  };
  // item it's log2(e) lse, Delta and log2(e) times the table slice, as
  // flash_bwd_dkv_kernel's, in the buffer of its parity
  auto Ls = [&](int it) { return reinterpret_cast<float*>(sm + L::MISC + (it & 1) * L::MISC_ITEM); };
  float* Fs = reinterpret_cast<float*>(sm + L::FLAGS);
  int* Fany = reinterpret_cast<int*>(Fs + 64);  // nonzero where a flag of keys 0-31 (32-63) is
  float4* px = reinterpret_cast<float4*>(sm + L::PX);
  float4* dsx = reinterpret_cast<float4*>(sm + L::DSX);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t *kvload = bars, *kvfull = bars + 1, *loaded = bars + 2, *empty = loaded + ST,
           *pready = empty + ST, *pfree = pready + 1, *dsready = pfree + 1, *dsfree = dsready + 1,
           *mready = dsfree + 1;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  // the grid as flash_bwd_dkv_kernel's: the cluster's ranks, then b * hk +
  // kv head, then (key tile, query chunk)
  const int kvh = blockIdx.x / csize % bhk;
  const int b = kvh / hk, kh = kvh % hk, group = heads / hk;
  const int zz = blockIdx.x / csize / bhk;
  const int k0 = (zz / qsplit) * BK, z = zz % qsplit;
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
      wg::mbar_init(&empty[s], 128);  // the stage's consumer
      wg::mbar_init(&mready[s], 128);
    }
    wg::mbar_init(pready, 128);
    wg::mbar_init(pfree, 128);
    wg::mbar_init(dsready, 128);
    wg::mbar_init(dsfree, 128);
    wg::fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- the producer ----
    wg::setmaxnreg_dec<L::PRODUCER_REGS>();
    if (tid == 0) {
      wg::mbar_arrive_tx(kvload, 2 * L::TILE);
      wg::load_tile<float, D>(Ks, &kmap, kvload, k0, kvh);
      wg::load_tile<float, D>(Vs, &vmap, kvload, k0, kvh);
    }
    if (tid < BK) {
      const float f = tc::key_flag(kmask, b, m, k0 + tid);
      Fs[tid] = f;
      const unsigned any = __ballot_sync(0xffffffffu, f != 0.f);
      if (tid % 32 == 0) Fany[tid / 32] = any != 0u;
    }
    wg::mbar_arrive(kvfull);
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
    // Ring item i into stage i % 2, j = i % PER: chunk (j / 2) % NCH of the
    // item's Q (j even, A's) or dO (j odd, B's) by TMA. With the item's
    // first, its lse, Delta and table slice, from registers loaded an item
    // ahead, once stage 0 has been handed back from the previous item's last
    // Q chunk (both consumers then done with the buffer's previous item).
    const int nitems = PER * total;
    if (nitems > 0) fetch(0);
    for (int i = 0; i < nitems; ++i) {
      const int s = i % ST, it = i / PER, j = i % PER;
      const float row_it = row_r, tab_it = tab_r;
      if (j == 0 && it + 1 < total) fetch(it + 1);
      wg::mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
      if (tid == 0) {
        wg::mbar_arrive_tx(&loaded[s], wg::CHUNK_BYTES);
        wg::load_chunk(Xh(s), s == 0 ? &qmap : &gmap, &loaded[s], (j / 2) % NCH * CH,
                       qtile(it), (int)((size_t)b * heads + head(it)));
      }
      if (j == 0) {
        float* ls = Ls(it);
        ls[tid] = row_it;
        if (tab != nullptr && tid < BQ + BK - 1) ls[2 * BQ + tid] = tab_it;
        wg::mbar_arrive(&mready[it & 1]);
      }
    }
    // the cluster's two barriers of the head sum below
    tc::cluster_arrive();
    tc::cluster_wait();
    tc::cluster_arrive_relaxed();
    tc::cluster_wait();
    return;
  }

  // ---- the consumers: A (threads 128-255) dK, B (256-383) dV ----
  wg::setmaxnreg_inc<L::CONSUMER_REGS>();
  const bool holds_dk = tid < 256;
  const int ctid = tid % 128, warp = ctid / 32, gq = (ctid % 32) / 4, t = ctid % 4;
  const int kl[2] = {warp * 16 + gq, warp * 16 + gq + 8};  // this thread's keys in the tile
  const int s = holds_dk ? 0 : 1;  // this consumer's stage (and named barrier 2 + s)
  float* xh = Xh(s);
  float* xl = Xl(s);
  wg::mbar_wait(kvload, 0);
  wg::mbar_wait(kvfull, 0);
  const float fk[2] = {Fs[kl[0]], Fs[kl[1]]};
  const bool flagged = Fany[0] || Fany[1];
  const float sl = scale * tc::LOG2E;
  float acc[D / 2];  // dK (A) or dV (B): rows keys, columns the head dim
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // this consumer's ring item i (i % 2 == s) has landed: split it in place
  // (transposed for the dK and dV products) for the warpgroup's products
  auto take = [&](int i, bool transposed) {
    wg::mbar_wait(&loaded[s], (i / ST) & 1);
    if (transposed) wg::split_tile_t(xh, xl, ctid, 2 + s);
    else wg::split_tile<wg::CHUNK_BYTES>(xh, xl, ctid, 128);
    wg::fence_proxy_async();
    tc::bar_sync(2 + s, 128);
  };

  for (int it = 0; it < total; ++it) {
    const int i0 = PER * it + s, q0 = qtile(it);  // this consumer's first ring item
    const float* ls = Ls(it);
    float x[32];  // A: S^T, then P^T; B: dP^T, then dS^T (rows keys, columns queries)
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.f;
    // S^T = K Q^T (A) or dP^T = V dO^T (B) over the chunks; A reads the (H,
    // N, M) bias from device memory while the last chunk's products run
    float bv[32];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      take(i0 + 2 * c, false);
      wg::fence_acc(x);
      wg::gemm_nk_rs_chunk(x, holds_dk ? Ks : Vs, c * CH, xh, xl, c == 0);
      if (holds_dk && c == NCH - 1 && bias != nullptr) {
        const float* bh_bias =
            bias + (((bias_batched ? (size_t)b * heads : 0) + head(it)) * n + q0) * m + k0;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int cq = 8 * (e / 4) + 2 * t + (e & 1), kr = kl[(e / 2) & 1];
          bv[e] = q0 + cq < n && k0 + kr < m ? __ldg(bh_bias + (size_t)cq * m + kr) : 0.f;
        }
      }
      wg::wgmma_wait<0>();
      wg::fence_acc(x);
      wg::mbar_arrive(&empty[s]);
    }
    wg::mbar_wait(&mready[it & 1], (it >> 1) & 1);
    if (holds_dk) {
      // p = 2^(y - log2(e) lse) by flash_bwd_dkv_kernel's masking rule
      const bool diag = causal && tc::above(k0 + warp * 16 + 15, q0, off);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int cq = 8 * (e / 4) + 2 * t + (e & 1), ri = (e / 2) & 1, kr = kl[ri];
        float bc = 0.f;
        if (tab != nullptr) bc = ls[2 * BQ + cq - kr + BK - 1];
        else if (bias != nullptr) bc = tc::LOG2E * bv[e];
        float y = fmaf(x[e], sl, bc);
        if (diag) y = tc::above(k0 + kr, q0 + cq, off) ? fminf(NEG, fk[ri]) : y + fk[ri];
        else if (flagged) y += fk[ri];
        x[e] = tc::ex2(y - ls[cq]);
      }
      // P^T to B once B is done with the previous item's; dS^T back from B
      if (it > 0) wg::mbar_wait(pfree, (it - 1) & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        px[j * 128 + ctid] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      wg::mbar_arrive(pready);
      wg::mbar_wait(dsready, it & 1);
    } else {
      // dS^T = P^T (dP^T - Delta) to A once A is done with the previous item's
      wg::mbar_wait(pready, it & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 p = px[j * 128 + ctid];
        const float pj[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[4 * j + e] = pj[e] * (x[4 * j + e] - ls[BQ + 8 * j + 2 * t + (e & 1)]);
      }
      if (it > 0) wg::mbar_wait(dsfree, (it - 1) & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dsx[j * 128 + ctid] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      wg::mbar_arrive(dsready);
    }
    // dK += dS^T Q (A) or dV += P^T dO (B) over the transposed chunks, one
    // 64-column chunk of the gradient each, dS^T or P^T read from the
    // hand-off
    const float4* hand = holds_dk ? dsx : px;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      take(i0 + 2 * (NCH + c), true);
      wg::add_pk_chunk<D>(acc, hand, xh, xl, c * CH);
      wg::mbar_arrive(&empty[s]);
    }
    wg::mbar_arrive(holds_dk ? dsfree : pfree);
  }

  // The partials (A's dK, B's dV) into K's, V's and the ring's place once
  // both consumers are done with them; then the head sum over the cluster
  // in rank order, as flash_bwd_dkv_kernel's: no atomics.
  float* red = reinterpret_cast<float*>(sm);
  tc::bar_sync(1, 256);
  float* mine = red + (holds_dk ? 0 : BK * L::RP);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
      tc::store2(mine + kl[ri] * L::RP + 8 * j + 2 * t, acc[4 * j + 2 * ri],
                 acc[4 * j + 2 * ri + 1]);
  tc::cluster_arrive();
  tc::cluster_wait();
  if (rank == 0) {
    const size_t plane = (size_t)bhk * m * D;  // one chunk's dk or dv partial
    for (int i = tid - 128; i < BK * D; i += 256) {
      const int r = i / D, cc = i % D;
      if (k0 + r >= m) continue;
      float sk = 0.f, sv = 0.f;
      for (int src = 0; src < csize; ++src) {
        const float* p = cluster.map_shared_rank(red, src);
        sk += p[r * L::RP + cc];
        sv += p[(BK + r) * L::RP + cc];
      }
      const size_t o = ((size_t)kvh * m + k0 + r) * D + cc;
      if (part == nullptr) {
        dk[o] = sk * scale;
        dv[o] = sv;
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

// K2's block and kernel: Dq's, or for float32 at D = 256 DqChunk's
template <typename T, int D, int DB>
struct DqForm {
  using L = Dq<T, D, DB == DB_SUM>;
  static auto kernel() { return flash_bwd_dq_kernel<T, D, DB>; }
};
template <int DB>
struct DqForm<float, F32_DIM, DB> {
  using L = DqChunk<F32_DIM, DB == DB_SUM>;
  static auto kernel() { return flash_bwd_dq_chunk_kernel<F32_DIM, DB>; }
};

// K3's block and kernel: Dkv's (one or two consumers that take the items in
// turn), or at D = 256 the pair forms (one consumer a gradient): bf16's
// DkvPair, float32's chunked DkvChunk
template <typename T, int D, bool TWO>
struct DkvForm {
  using L = Dkv<T, D, TWO>;
  static auto kernel() { return flash_bwd_dkv_kernel<T, D, TWO>; }
};
template <bool TWO>
struct DkvForm<__nv_bfloat16, BF16_DIM, TWO> {
  using L = DkvPair<__nv_bfloat16, BF16_DIM>;
  static auto kernel() { return flash_bwd_dkv_pair_kernel<__nv_bfloat16, BF16_DIM>; }
};
template <bool TWO>
struct DkvForm<float, F32_DIM, TWO> {
  using L = DkvChunk<F32_DIM>;
  static auto kernel() { return flash_bwd_dkv_chunk_kernel<F32_DIM>; }
};

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

// ---- Head dims over 128: the column-sliced forms of K2 and K3 (see the
// note at the top) ----
constexpr int WIDE_NT = 128;  // 4 warps, each a 16-row strip of the tile
constexpr int WIDE_BLOCKS = 2;

// the (2n-1, heads) table's entry of (qp, kp) times log2(e), 0 outside it
__device__ __forceinline__ float tab_at(const float* tab, int qp, int kp, int n, int heads, int h) {
  const int idx = qp - kp + n - 1;
  return idx >= 0 && idx < 2 * n - 1 ? tc::LOG2E * tab[(size_t)idx * heads + h] : 0.f;
}

// K2: one block per (batch row, head, dq slice, 64-row query tile), batch
// rows fastest (K5's cluster: consecutive blocks of one slice), the longest
// causal rows first. Its ring items, a key tile's 2 D / 64 + 1 of them: the
// chunks of (Q, K) for S = Q K^T, the chunks of (dO, V) for dP = dO V^T,
// then K's slice for dq += dS K. The epilogue is K2's, each element's table
// entry, key flag and bias read from device memory. Slice 0 alone writes
// the bias's gradient: K4's partial sums (K2's skewed rows and delta slots
// after the ring in shared memory, the same second pass), K5's batch sum
// (dS into a tile after the ring, then the cluster's blocks add their tiles
// in rank order through batch_sum_rows between two cluster barriers: no
// atomics for B <= 8, as K2's), or the per-batch bias's dS.
template <typename T, int DB>
__global__ void __launch_bounds__(WIDE_NT, WIDE_BLOCKS)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const float* __restrict__ tab, const float* __restrict__ bias,
                         const int8_t* __restrict__ kmask, T* __restrict__ dq,
                         float* __restrict__ dpart, float* __restrict__ dbias, int bcount,
                         int heads, int group, int n, int m, int d, float scale, int causal,
                         int bias_batched) {
  constexpr bool SUM = DB == DB_SUM, EACH = DB == DB_EACH;
  using W = tc::Wide<T>;
  constexpr int P = W::P, WC = tc::WC;
  extern __shared__ __align__(16) unsigned char dq_wide_smem[];
  auto X = [&](int s) { return reinterpret_cast<T*>(dq_wide_smem + s * W::STAGE); };
  auto Y = [&](int s) { return reinterpret_cast<T*>(dq_wide_smem + s * W::STAGE + W::TILE); };
  float* extra = reinterpret_cast<float*>(dq_wide_smem + W::RING);  // K4's or K5's buffers

  cg::cluster_group cluster = cg::this_cluster();
  const int nch = d / WC;  // chunks of the depth, and slices of dq
  const int b = blockIdx.x % bcount, h = blockIdx.x / bcount % heads;
  const int slice = blockIdx.x / bcount / heads % nch;
  const int nqt = (n + BQ - 1) / BQ, qt = blockIdx.x / bcount / heads / nch;
  const int q0 = (nqt - 1 - qt) * BQ;  // the longest causal rows first
  const size_t bh = (size_t)b * heads + h;
  const int off = m - n;
  const int kv_end = tc::causal_end(causal, q0 + BQ, off, m);
  const int ntiles = (kv_end + BK - 1) / BK;
  const int per = 2 * nch + 1, nitems = per * ntiles;
  const bool lead = slice == 0;  // the one slice that writes the bias's gradient
  const bool atomic = SUM && (int)cluster.num_blocks() < bcount;
  float* out = SUM ? dbias + (size_t)h * n * m : EACH ? dbias + bh * n * m : nullptr;
  const T* qb = q + bh * n * d;
  const T* gb = g + bh * n * d;
  const T* kb = k + bh / group * m * d;
  const T* vb = v + bh / group * m * d;
  auto issue = [&](int i) {
    const int s = i & 1, c = i % per, k0 = i / per * BK;
    if (c < nch) {
      tc::cp_chunk<T, WIDE_NT>(X(s), qb, q0, n, c * WC, d);
      tc::cp_chunk<T, WIDE_NT>(Y(s), kb, k0, m, c * WC, d);
    } else if (c < 2 * nch) {
      tc::cp_chunk<T, WIDE_NT>(X(s), gb, q0, n, (c - nch) * WC, d);
      tc::cp_chunk<T, WIDE_NT>(Y(s), vb, k0, m, (c - nch) * WC, d);
    } else {
      tc::cp_chunk<T, WIDE_NT>(X(s), kb, k0, m, slice * WC, d);
    }
    tc::cp_async_commit();
  };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, t = lane % 4;
  const int rl[2] = {warp * 16 + gq, warp * 16 + gq + 8};  // this thread's rows in the tile
  const float* biash = bias != nullptr ? bias + (bias_batched ? bh : h) * n * m : nullptr;
  const float* brow[2] = {biash != nullptr && q0 + rl[0] < n ? biash + (size_t)(q0 + rl[0]) * m
                                                             : nullptr,
                          biash != nullptr && q0 + rl[1] < n ? biash + (size_t)(q0 + rl[1]) * m
                                                             : nullptr};
  float lse_r[2], dl_r[2];  // log2(e) lse (+inf where p = 0) and Delta
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int qp = q0 + rl[ri];
    const float l = qp < n ? lse[bh * n + qp] : INFINITY;
    lse_r[ri] = l > 0.5f * NEG ? tc::LOG2E * l : INFINITY;
    dl_r[ri] = qp < n ? delta[bh * n + qp] : 0.f;
  }
  // K4, as in flash_bwd_dq_kernel: a strip's skewed dS rows, then the delta
  // slots of tile it (two buffers), and the delta this thread owns
  const bool k4 = lead && dpart != nullptr;
  float* sk = extra + warp * 8 * SKP;
  auto dsl = [&](int it) { return extra + BQ * SKP + (it & 1) * 4 * DSL; };
  const int nkt = (m + BK - 1) / BK;
  float* prow = k4 ? dpart + (bh * nqt + q0 / BQ) * (size_t)(BK * (nkt + 1)) : nullptr;
  int a_cur = -1;
  float a_sum = 0.f;
  if (k4)
    for (int i = tid; i < BQ * SKP + 2 * 4 * DSL; i += WIDE_NT) extra[i] = 0.f;
  const float sl = scale * tc::LOG2E, one[2] = {1.f, 1.f};
  float dqa[8][4], sc[8][4], ds[8][4];  // dq's slice; S; dP, then dS
  tc::zero(dqa);
  tc::zero(sc);
  tc::zero(ds);
  if (nitems > 0) issue(0);
  for (int i = 0; i < nitems; ++i) {
    tc::cp_async_wait_all();
    __syncthreads();  // item i has landed; every warp is done with item i - 1's stage
    if (i + 1 < nitems) issue(i + 1);
    const int s = i & 1, c = i % per, it = i / per, k0 = it * BK;
    if (c == 0) {
      tc::zero(sc);
      tc::zero(ds);
    }
    if (c < nch) {
      tc::chunk_nk<T>(sc, X(s), Y(s));
      continue;
    }
    if (c < 2 * nch) {
      tc::chunk_nk<T>(ds, X(s), Y(s));
      continue;
    }
    // p = 2^(y - log2(e) lse) by K2's masking rule, then dS = P (dP - Delta)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e / 2, kp = k0 + 8 * j + 2 * t + (e & 1), qp = q0 + rl[ri];
        float bb = 0.f;
        if (tab != nullptr) bb = tab_at(tab, qp, kp, n, heads, h);
        else if (brow[ri] != nullptr && kp < m) bb = tc::LOG2E * __ldg(brow[ri] + kp);
        const float f = tc::key_flag(kmask, b, m, kp);
        float y = fmaf(sc[j][e], sl, bb);
        y = causal && tc::above(kp, qp, off) ? fminf(NEG, f) : y + f;
        ds[j][e] = tc::ex2(y - lse_r[ri]) * (ds[j][e] - dl_r[ri]);
      }
    const float* dsf = &ds[0][0];  // flat: element 4j + e, as flash_bwd_dq_kernel's
    if (k4) {
      float* row = sk + gq * SKP + 2 * t - gq + 15;
#pragma unroll
      for (int j = -1; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          row[8 * j + e] = (j >= 0 ? dsf[4 * j + e] : 0.f)
                           + (j + 1 < BK / 8 ? dsf[4 * j + 6 + e] : 0.f);
      __syncwarp();
      for (int x = lane; x < BK + 15; x += 32) {
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int r = 0; r < 8; r += 2) {
          sum0 += sk[r * SKP + x];
          sum1 += sk[(r + 1) * SKP + x];
        }
        dsl(it)[warp * DSL + 48 - 16 * warp + x] = sum0 + sum1;
      }
    }
    if (EACH && lead) {
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int qp = q0 + rl[ri];
        if (qp >= n) continue;
        float* o = out + (size_t)qp * m + k0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = 8 * j + 2 * t + e;
            if (k0 + cc < m) o[cc] = ds[j][2 * ri + e];
          }
      }
    }
    if (SUM && lead) {
      // K5: the tile's dS into shared memory, then every rank's share of
      // the rows summed over the cluster in rank order
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int ri = 0; ri < 2; ++ri)
          tc::store2(extra + ds_at(rl[ri], 8 * j + 2 * t), ds[j][2 * ri], ds[j][2 * ri + 1]);
      tc::cluster_arrive();
      tc::cluster_wait();
      batch_sum_rows(cluster, extra, out, q0, k0, n, m, atomic, tid);
      tc::cluster_arrive_relaxed();  // every rank's tile read before it is written again
      tc::cluster_wait();
    }
    tc::add_tile<T, WC, 8>(dqa, ds, X(s), P, one);  // dq += dS K (the slice)
    if (k4) {
      __syncthreads();  // every strip's slots of this tile are in
      const int a = k0 + ((tid - k0) & (DSL - 1));
      if (a != a_cur) {
        if (a_cur >= 0) prow[a_cur] = a_sum;
        a_cur = a;
        a_sum = 0.f;
      }
      const float* dd = dsl(it) + (a - k0);
      a_sum += ((dd[0] + dd[DSL]) + dd[2 * DSL]) + dd[3 * DSL];
    }
  }
  if (k4 && a_cur >= 0) prow[a_cur] = a_sum;
  if (EACH && lead) {
    // the keys past the last tile (above the causal diagonal): dS = 0
    for (int r = 0; r < BQ && q0 + r < n; ++r)
      for (int c = ntiles * BK + tid; c < m; c += WIDE_NT) out[(size_t)(q0 + r) * m + c] = 0.f;
  }
  if (SUM && lead && !atomic && kv_end < m) {
    // K5: the keys past the causal diagonal, this rank's share of the rows
    const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
    const int r_hi = min((rank + 1) * BQ / csize, n - q0);
    for (int r = rank * BQ / csize; r < r_hi; ++r) {
      float* o = out + (size_t)(q0 + r) * m;
      for (int c = kv_end + tid; c < m; c += WIDE_NT) o[c] = 0.f;
    }
  }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int qp = q0 + rl[ri];
    if (qp >= n) continue;
    T* o = dq + (bh * n + qp) * d + slice * WC;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      tc::store2(o + 8 * j + 2 * t, dqa[j][2 * ri] * scale, dqa[j][2 * ri + 1] * scale);
  }
}

// K3: one block per (b*hk + kv head, dk/dv slice, 64-key tile), kv heads
// fastest. It walks every query head of its kv head and, in each, the query
// tiles from the diagonal on, in that order; the ring items of a (head,
// query tile), 2 D / 64 + 1 of them: the chunks of (K, Q) for S^T = K Q^T,
// the chunks of (V, dO) for dP^T = V dO^T, then Q's and dO's slices for dK
// += dS^T Q and dV += P^T dO. The epilogue is K3's, each element's lse,
// Delta, table entry and bias read from device memory. No cluster, no
// query split: each block writes its slice of dk and dv once, summed in a
// fixed order, the same bits every run.
template <typename T>
__global__ void __launch_bounds__(WIDE_NT, WIDE_BLOCKS)
flash_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ g,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const float* __restrict__ tab, const float* __restrict__ bias,
                          const int8_t* __restrict__ kmask, T* __restrict__ dk,
                          T* __restrict__ dv, int bhk, int heads, int hk, int n, int m, int d,
                          float scale, int causal, int bias_batched) {
  using W = tc::Wide<T>;
  constexpr int P = W::P, WC = tc::WC;
  extern __shared__ __align__(16) unsigned char dkv_wide_smem[];
  auto X = [&](int s) { return reinterpret_cast<T*>(dkv_wide_smem + s * W::STAGE); };
  auto Y = [&](int s) { return reinterpret_cast<T*>(dkv_wide_smem + s * W::STAGE + W::TILE); };
  const int nch = d / WC;  // chunks of the depth, and slices of dk and dv
  const int kvh = blockIdx.x % bhk, slice = blockIdx.x / bhk % nch;
  const int k0 = blockIdx.x / bhk / nch * BK;
  const int b = kvh / hk, kh = kvh % hk, group = heads / hk;
  // causal: the first query that sees key k0 is k0 - off (off = m - n >= 0)
  const int off = m - n;
  const int q_start = causal ? max(0, k0 - off) : 0;
  const int nqt = q_start < n ? (n - q_start + BQ - 1) / BQ : 0;
  const int per = 2 * nch + 1, nitems = per * group * nqt;
  const T* kb = k + (size_t)kvh * m * d;
  const T* vb = v + (size_t)kvh * m * d;
  // item it: query head kh * group + it / nqt, its query tile it % nqt
  auto plane = [&](int it) { return (size_t)b * heads + kh * group + it / nqt; };
  auto qtile = [&](int it) { return q_start + it % nqt * BQ; };
  auto issue = [&](int i) {
    const int s = i & 1, c = i % per, it = i / per, q0 = qtile(it);
    const T* qb = q + plane(it) * n * d;
    const T* gb = g + plane(it) * n * d;
    if (c < nch) {
      tc::cp_chunk<T, WIDE_NT>(X(s), kb, k0, m, c * WC, d);
      tc::cp_chunk<T, WIDE_NT>(Y(s), qb, q0, n, c * WC, d);
    } else if (c < 2 * nch) {
      tc::cp_chunk<T, WIDE_NT>(X(s), vb, k0, m, (c - nch) * WC, d);
      tc::cp_chunk<T, WIDE_NT>(Y(s), gb, q0, n, (c - nch) * WC, d);
    } else {
      tc::cp_chunk<T, WIDE_NT>(X(s), qb, q0, n, slice * WC, d);
      tc::cp_chunk<T, WIDE_NT>(Y(s), gb, q0, n, slice * WC, d);
    }
    tc::cp_async_commit();
  };

  const int tid = threadIdx.x, warp = tid / 32, gq = (tid % 32) / 4, t = tid % 4;
  const int kl[2] = {warp * 16 + gq, warp * 16 + gq + 8};  // this thread's keys in the tile
  const float fk[2] = {tc::key_flag(kmask, b, m, k0 + kl[0]), tc::key_flag(kmask, b, m, k0 + kl[1])};
  const float sl = scale * tc::LOG2E, one[2] = {1.f, 1.f};
  float dka[8][4], dva[8][4], st[8][4], dpt[8][4];  // S^T and dP^T: rows keys, columns queries
  tc::zero(dka);
  tc::zero(dva);
  tc::zero(st);
  tc::zero(dpt);
  if (nitems > 0) issue(0);
  for (int i = 0; i < nitems; ++i) {
    tc::cp_async_wait_all();
    __syncthreads();  // item i has landed; every warp is done with item i - 1's stage
    if (i + 1 < nitems) issue(i + 1);
    const int s = i & 1, c = i % per, it = i / per;
    if (c == 0) {
      tc::zero(st);
      tc::zero(dpt);
    }
    if (c < nch) {
      tc::chunk_nk<T>(st, X(s), Y(s));
      continue;
    }
    if (c < 2 * nch) {
      tc::chunk_nk<T>(dpt, X(s), Y(s));
      continue;
    }
    const size_t bh = plane(it);
    const int h = (int)(bh % heads), q0 = qtile(it);
    const float* bh_bias =
        bias != nullptr ? bias + ((bias_batched ? bh : (size_t)h) * n) * m : nullptr;
    // p = 2^(y - log2(e) lse) by K3's masking rule, dS^T = P^T (dP^T - Delta)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int qp = q0 + 8 * j + 2 * t + x;
        const float l = qp < n ? lse[bh * n + qp] : INFINITY;
        const float l2 = l > 0.5f * NEG ? tc::LOG2E * l : INFINITY;
        const float dl = qp < n ? delta[bh * n + qp] : 0.f;
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          const int kp = k0 + kl[ri], e = 2 * ri + x;
          float bc = 0.f;
          if (tab != nullptr) bc = tab_at(tab, qp, kp, n, heads, h);
          else if (bh_bias != nullptr && qp < n && kp < m)
            bc = tc::LOG2E * __ldg(bh_bias + (size_t)qp * m + kp);
          float y = fmaf(st[j][e], sl, bc);
          y = causal && tc::above(kp, qp, off) ? fminf(NEG, fk[ri]) : y + fk[ri];
          const float p = tc::ex2(y - l2);
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - dl);
        }
      }
    tc::add_tile<T, WC, 8>(dva, st, Y(s), P, one);   // dV += P^T dO (the slice)
    tc::add_tile<T, WC, 8>(dka, dpt, X(s), P, one);  // dK += dS^T Q (the slice)
  }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int kp = k0 + kl[ri];
    if (kp >= m) continue;
    const size_t o = ((size_t)kvh * m + kp) * d + slice * WC;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      tc::store2(dk + o + 8 * j + 2 * t, dka[j][2 * ri] * scale, dka[j][2 * ri + 1] * scale);
      tc::store2(dv + o + 8 * j + 2 * t, dva[j][2 * ri], dva[j][2 * ri + 1]);
    }
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
  int bias_batched;  // the bias is (b, heads, n, m)
};

// a one-dimensional grid of `blocks`, or an error past its x limit of 2^31 - 1
cudaError_t grid_1d(long long blocks, dim3* grid) {
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  *grid = dim3((unsigned)blocks);
  return cudaSuccess;
}

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

// K2's launch plan, as ops/kernels/flash_attention.py::dq_plan gives it:
// the cluster (K5's: the largest divisor of the batch up to MAX_CLUSTER,
// else 1), the ring's stages, the block's shared memory with K5's buffers
// (sum) or K4's (else) and the blocks an SM it is built for
struct DqPlan {
  int cluster, stages, smem, blocks;
};

template <typename T, int D, bool SUM>
DqPlan dq_plan_of(int b) {
  using L = typename DqForm<T, D, SUM ? DB_SUM : DB_NONE>::L;
  return {SUM ? cluster_size(b) : 1, L::ST, (int)L::most, L::MIN_BLOCKS};
}

template <typename T, int D>
DqPlan dq_plan(int b, bool sum) {
  return sum ? dq_plan_of<T, D, true>(b) : dq_plan_of<T, D, false>(b);
}

// K2; o2 the gradient of the bias given, dtab (K4, then its second pass,
// with its partial sums in part) or dbias (K5, or a per-batch bias's), or
// null
template <typename T, int D, int DB>
cudaError_t launch_dq(const Args& a, void* dq, void* o2, void* part) {
  constexpr bool SUM = DB == DB_SUM;
  using L = typename DqForm<T, D, DB>::L;
  const bool dtab = a.bias == nullptr && o2 != nullptr;
  CUtensorMap qm, km, vm, gm;
  cudaError_t err = wg::tile_map(&qm, a.q, sizeof(T), a.n, a.b * a.heads, D);
  if (err == cudaSuccess) err = wg::tile_map(&gm, a.g, sizeof(T), a.n, a.b * a.heads, D);
  if (err == cudaSuccess) err = wg::tile_map(&km, a.k, sizeof(T), a.m, a.b * a.hk, D);
  if (err == cudaSuccess) err = wg::tile_map(&vm, a.v, sizeof(T), a.m, a.b * a.hk, D);
  auto kernel = DqForm<T, D, DB>::kernel();
  static unsigned sized = 0;  // the devices whose attribute is set, once per instantiation
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 32 || !(sized >> dev & 1))) {
    err = set_smem(kernel, L::most);
    if (err == cudaSuccess) sized |= 1u << dev;
  }
  if (err != cudaSuccess) return err;
  const DqPlan plan = dq_plan_of<T, D, SUM>(a.b);
  cudaLaunchAttribute attr[1] = {cluster_attr(plan.cluster)};
  cudaLaunchConfig_t cfg = {};
  err = grid_1d((long long)a.b * a.heads * ((a.n + BQ - 1) / BQ), &cfg.gridDim);
  if (err != cudaSuccess) return err;
  cfg.blockDim = dim3(L::NT);
  cfg.dynamicSmemBytes = L::EXTRA + (SUM ? L::K5_BYTES : dtab ? L::K4_BYTES : 0);
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, qm, km, vm, gm, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.tab),
      static_cast<const float*>(a.bias), static_cast<const int8_t*>(a.kmask), static_cast<T*>(dq),
      static_cast<float*>(dtab ? part : nullptr),
      static_cast<float*>(DB != DB_NONE ? o2 : nullptr), a.b, a.heads, a.heads / a.hk, a.n, a.m,
      a.scale, a.causal, a.bias_batched);
  if (err != cudaSuccess || !dtab) return err;
  dim3 grid;
  err = grid_1d((long long)(2 * a.n - 1 + NT_DTAB - 1) / NT_DTAB * a.heads, &grid);
  if (err != cudaSuccess) return err;
  dtab_sum_kernel<<<grid, NT_DTAB, 0, a.stream>>>(static_cast<const float*>(part),
                                                  static_cast<float*>(o2), a.b, a.heads, a.n,
                                                  a.m, a.causal);
  return cudaGetLastError();
}

// K3's launch plan, as ops/kernels/flash_attention.py::dkv_plan gives it:
// the cluster (the largest divisor of the group up to MAX_CLUSTER), the
// number of chunks the query range is split into, so that a grid below one
// block per SM fills the card (while each chunk keeps 4 query tiles; in
// float32's chunked form, below two blocks an SM, with 2), and
// two consumer warpgroups a block for float32, and for bf16 where fewer
// than two blocks an SM would run; at D = 128 two in bf16 and one (the
// SEQ slot) in float32; at D = 256 two, one a gradient (bf16's DkvPair,
// float32's DkvChunk).
struct DkvPlan {
  int cluster, qsplit;
  bool two;
};

DkvPlan dkv_plan(bool f32, int b, int heads, int hk, int n, int m, int d) {
  const int cluster = cluster_size(heads / hk);
  const long long base = (long long)cluster * b * hk * ((m + BK - 1) / BK);
  int qsplit = 1;
  if (base < PLAN_SMS) qsplit = max(1, min((int)(PLAN_SMS / base), (n + BQ - 1) / BQ / 4));
  // float32's chunked form at D = 256: its blocks are few and long (one
  // block an SM), so a grid under two blocks an SM is split further, into
  // chunks of at least 2 query tiles
  if (f32 && d == F32_DIM && base < 2 * PLAN_SMS)
    qsplit = max(qsplit, min((int)((2 * PLAN_SMS + base - 1) / base), (n + BQ - 1) / BQ / 2));
  return {cluster, qsplit, d > 64 ? !f32 || d == F32_DIM : f32 || base * qsplit < 2 * PLAN_SMS};
}

// K3's block shape L: out[0] its stages, out[1] its shared memory, out[2]
// the blocks an SM it is built for
template <typename L>
void dkv_shape_of(int* out) {
  out[0] = L::ST;
  out[1] = (int)L::bytes;
  out[2] = L::MIN_BLOCKS;
}

template <typename T, int D>
void dkv_shape(bool two, int* out) {
  if constexpr (D > 64) dkv_shape_of<typename DkvForm<T, D, sizeof(T) == 2>::L>(out);
  else if (two) dkv_shape_of<Dkv<T, D, true>>(out);
  else dkv_shape_of<Dkv<T, D, false>>(out);
}

template <typename T, int D, bool TWO>
cudaError_t launch_dkv(const Args& a, const DkvPlan& plan, void* dk, void* dv) {
  using L = typename DkvForm<T, D, TWO>::L;
  CUtensorMap qm, km, vm, gm;
  cudaError_t err = wg::tile_map(&qm, a.q, sizeof(T), a.n, a.b * a.heads, D);
  if (err == cudaSuccess) err = wg::tile_map(&gm, a.g, sizeof(T), a.n, a.b * a.heads, D);
  if (err == cudaSuccess) err = wg::tile_map(&km, a.k, sizeof(T), a.m, a.b * a.hk, D);
  if (err == cudaSuccess) err = wg::tile_map(&vm, a.v, sizeof(T), a.m, a.b * a.hk, D);
  auto kernel = DkvForm<T, D, TWO>::kernel();
  static unsigned sized = 0;  // the devices whose attribute is set, once per instantiation
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 32 || !(sized >> dev & 1))) {
    err = set_smem(kernel, L::bytes);
    if (err == cudaSuccess) sized |= 1u << dev;
  }
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1] = {cluster_attr(plan.cluster)};
  cudaLaunchConfig_t cfg = {};
  err = grid_1d((long long)plan.cluster * a.b * a.hk * ((a.m + BK - 1) / BK) * plan.qsplit,
                &cfg.gridDim);
  if (err != cudaSuccess) return err;
  // the query range split over chunks: their partials in scratch, summed
  // in chunk order by a second pass (one K3 call, two launches)
  const size_t plane = (size_t)a.b * a.hk * a.m * D;
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
  cfg.blockDim = dim3(L::NT);
  cfg.dynamicSmemBytes = L::bytes;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, qm, km, vm, gm, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.tab),
      static_cast<const float*>(a.bias), static_cast<const int8_t*>(a.kmask),
      static_cast<T*>(dk), static_cast<T*>(dv), part, a.b * a.hk, a.heads, a.hk, a.n, a.m,
      a.scale, a.causal, plan.qsplit, a.bias_batched);
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

// a head dim the column-sliced forms take: a multiple of their chunk over
// BF16_DIM in bf16, over F32_DIM in float32
bool wide_dim(int d, bool bf16) { return d > (bf16 ? BF16_DIM : F32_DIM) && d % tc::WC == 0; }

// the column-sliced K2's shared memory: the ring, then K4's or K5's buffers
template <typename T>
size_t dq_wide_smem(bool sum, bool dtab) {
  using L = Dq<T, 64, false>;  // K4's and K5's buffers are every form's
  return tc::Wide<T>::RING + (sum ? L::K5_BYTES : dtab ? L::K4_BYTES : 0);
}

// K2's column-sliced form; o2 as launch_dq's
template <typename T, int DB>
cudaError_t launch_dq_wide(const Args& a, int d, void* dq, void* o2, void* part) {
  constexpr bool SUM = DB == DB_SUM;
  const bool dtab = a.bias == nullptr && o2 != nullptr;
  auto kernel = flash_bwd_dq_wide_kernel<T, DB>;
  static unsigned sized = 0;  // the devices whose attribute is set, once per instantiation
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 32 || !(sized >> dev & 1))) {
    err = set_smem(kernel, dq_wide_smem<T>(true, false) > dq_wide_smem<T>(false, true)
                               ? dq_wide_smem<T>(true, false) : dq_wide_smem<T>(false, true));
    if (err == cudaSuccess) sized |= 1u << dev;
  }
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1] = {cluster_attr(SUM ? cluster_size(a.b) : 1)};
  cudaLaunchConfig_t cfg = {};
  err = grid_1d((long long)a.b * a.heads * (d / tc::WC) * ((a.n + BQ - 1) / BQ), &cfg.gridDim);
  if (err != cudaSuccess) return err;
  cfg.blockDim = dim3(WIDE_NT);
  cfg.dynamicSmemBytes = dq_wide_smem<T>(SUM, dtab);
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.tab),
      static_cast<const float*>(a.bias), static_cast<const int8_t*>(a.kmask), static_cast<T*>(dq),
      static_cast<float*>(dtab ? part : nullptr),
      static_cast<float*>(DB != DB_NONE ? o2 : nullptr), a.b, a.heads, a.heads / a.hk, a.n, a.m,
      d, a.scale, a.causal, a.bias_batched);
  if (err != cudaSuccess || !dtab) return err;
  dim3 grid;
  err = grid_1d((long long)(2 * a.n - 1 + NT_DTAB - 1) / NT_DTAB * a.heads, &grid);
  if (err != cudaSuccess) return err;
  dtab_sum_kernel<<<grid, NT_DTAB, 0, a.stream>>>(static_cast<const float*>(part),
                                                  static_cast<float*>(o2), a.b, a.heads, a.n,
                                                  a.m, a.causal);
  return cudaGetLastError();
}

// K3's column-sliced form
template <typename T>
cudaError_t launch_dkv_wide(const Args& a, int d, void* dk, void* dv) {
  auto kernel = flash_bwd_dkv_wide_kernel<T>;
  static unsigned sized = 0;  // the devices whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 32 || !(sized >> dev & 1))) {
    err = set_smem(kernel, tc::Wide<T>::RING);
    if (err == cudaSuccess) sized |= 1u << dev;
  }
  if (err != cudaSuccess) return err;
  dim3 grid;
  err = grid_1d((long long)a.b * a.hk * (d / tc::WC) * ((a.m + BK - 1) / BK), &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, WIDE_NT, tc::Wide<T>::RING, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.tab),
      static_cast<const float*>(a.bias), static_cast<const int8_t*>(a.kmask), static_cast<T*>(dk),
      static_cast<T*>(dv), a.b * a.hk, a.heads, a.hk, a.n, a.m, d, a.scale, a.causal,
      a.bias_batched);
  return cudaGetLastError();
}

// which: as dispatch's, for a head dim the column-sliced forms take
template <typename T>
cudaError_t dispatch_wide(int which, int d, const Args& a, void* o1, void* o2, void* part) {
  if (a.tab != nullptr && a.bias != nullptr) return cudaErrorInvalidValue;
  if (which == 1) return launch_dkv_wide<T>(a, d, o1, o2);
  if (o2 != nullptr && (a.tab == nullptr ? a.bias == nullptr : a.n != a.m || part == nullptr))
    return cudaErrorInvalidValue;
  if (a.bias != nullptr && o2 != nullptr)
    return a.bias_batched ? launch_dq_wide<T, DB_EACH>(a, d, o1, o2, part)
                          : launch_dq_wide<T, DB_SUM>(a, d, o1, o2, part);
  return launch_dq_wide<T, DB_NONE>(a, d, o1, o2, part);
}

// which: 0 dq (and the bias's gradient in o2 when not null), 1 dk/dv
template <typename T, int D>
cudaError_t dispatch(int which, const Args& a, void* o1, void* o2, void* part) {
  if (a.tab != nullptr && a.bias != nullptr) return cudaErrorInvalidValue;
  if (which == 1) {
    const DkvPlan plan = dkv_plan(sizeof(T) == 4, a.b, a.heads, a.hk, a.n, a.m, D);
    if constexpr (D > 64) return launch_dkv<T, D, sizeof(T) == 2>(a, plan, o1, o2);
    else if constexpr (sizeof(T) == 4) return launch_dkv<T, D, true>(a, plan, o1, o2);
    else
      return plan.two ? launch_dkv<T, D, true>(a, plan, o1, o2)
                      : launch_dkv<T, D, false>(a, plan, o1, o2);
  }
  if (o2 != nullptr && (a.tab == nullptr ? a.bias == nullptr : a.n != a.m || part == nullptr))
    return cudaErrorInvalidValue;
  if (a.bias != nullptr && o2 != nullptr)
    return a.bias_batched ? launch_dq<T, D, DB_EACH>(a, o1, o2, part)
                          : launch_dq<T, D, DB_SUM>(a, o1, o2, part);
  return launch_dq<T, D, DB_NONE>(a, o1, o2, part);
}

template <typename T>
cudaError_t dispatch_dim(int which, int d, const Args& a, void* o1, void* o2, void* part) {
  constexpr bool BF16 = sizeof(T) == 2;
  if (wide_dim(d, BF16)) return dispatch_wide<T>(which, d, a, o1, o2, part);
  switch (d) {
    case 32: return dispatch<T, 32>(which, a, o1, o2, part);
    case 64: return dispatch<T, 64>(which, a, o1, o2, part);
    case 128: return dispatch<T, 128>(which, a, o1, o2, part);
  }
  if constexpr (BF16) {
    if (d == BF16_DIM) return dispatch<T, BF16_DIM>(which, a, o1, o2, part);
  } else if (d == F32_DIM) {
    return dispatch<T, F32_DIM>(which, a, o1, o2, part);
  }
  return cudaErrorInvalidValue;
}

int run(int which, const void* q, const void* k, const void* v, const void* g,
        const void* lse, const void* delta, const void* tab, const void* bias,
        const void* kmask, void* o1, void* o2, void* part, int b, int heads, int hk, int n,
        int m, int d, float scale, int causal, int dtype, void* stream, int bias_batched) {
  const Args a{q, k, v, g, lse, delta, tab, bias, kmask, b, heads, hk, n, m, scale, causal,
               static_cast<cudaStream_t>(stream), bias_batched};
  if (dtype == 0) return dispatch_dim<float>(which, d, a, o1, o2, part);
  if (dtype == 1) return dispatch_dim<__nv_bfloat16>(which, d, a, o1, o2, part);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, g (b*heads, n, d); k, v (b*hk, m, d), d in 32, 64, 128, 256, or over
// 256 a multiple of 64, in one dtype
// (0 float32, 1 bfloat16); lse, delta (b*heads, n) float32; tab (2n-1, heads) float32 or
// null; bias float32 or null, at most one of tab and bias: (heads, n, m)
// shared over the batch, or with bias_batched (b, heads, n, m); kmask (b,
// m) int8 or null. Each returns a cudaError_t. (bias_batched comes last,
// after the stream: a library built before it takes the same call and
// ignores it, as tools/torch_flash_parent_ab.py loads an older checkout's
// behind these wrappers.)

// dq (b*heads, n, d) in q's dtype; with dgrad not null also the gradient of
// the bias given, summed over the batch: with tab, dtab (2n-1, heads)
// float32, every element written (needs n == m, and part: float32 scratch
// of b * heads * ceil(n / 64) * 64 (ceil(m / 64) + 1) elements for K4's
// partial sums; K4's second pass is a launch of its own after K2's); with
// bias, dbias (heads, n, m) float32, every element written, zeroed by the
// caller when b > 8 (several clusters per tile meet by atomics there); with
// a per-batch bias, dbias (b, heads, n, m) float32, dS itself, every element
// written once
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                            const void* lse, const void* delta, const void* tab,
                            const void* bias, const void* kmask, void* dq, void* dgrad,
                            void* part, int b, int heads, int hk, int n, int m, int d,
                            float scale, int causal, int dtype, void* stream,
                            int bias_batched) {
  return run(0, q, k, v, g, lse, delta, tab, bias, kmask, dq, dgrad, part, b, heads, hk, n, m,
             d, scale, causal, dtype, stream, bias_batched);
}

// dk, dv (b*hk, m, d) in k's dtype
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                             const void* lse, const void* delta, const void* tab,
                             const void* bias, const void* kmask, void* dk, void* dv, int b,
                             int heads, int hk, int n, int m, int d, float scale, int causal,
                             int dtype, void* stream, int bias_batched) {
  return run(1, q, k, v, g, lse, delta, tab, bias, kmask, dk, dv, nullptr, b, heads, hk, n, m,
             d, scale, causal, dtype, stream, bias_batched);
}

// K2's launch plan for these sizes, head dim, dtype (0 float32, 1 bfloat16)
// and form (1 with K5's sum, the (H, N, M) bias's gradient; 0 otherwise):
// out[0] the cluster, out[1] the ring's stages, out[2] the block's shared
// memory (with K5's buffers, or K4's), out[3] the blocks an SM it is built
// for (ops/kernels/flash_attention.py::dq_plan mirrors it)
extern "C" int flash_dq_plan(int b, int heads, int hk, int n, int m, int d, int dtype, int sum,
                             int* out) {
  if (hk <= 0 || heads % hk || b <= 0 || n <= 0 || m <= 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  DqPlan plan;
  if (wide_dim(d, dtype == 1)) {  // the column-sliced form: K5's cluster, two stages
    const size_t smem = dtype == 0 ? dq_wide_smem<float>(sum != 0, sum == 0)
                                   : dq_wide_smem<__nv_bfloat16>(sum != 0, sum == 0);
    plan = {sum ? cluster_size(b) : 1, 2, (int)smem, WIDE_BLOCKS};
  } else switch (d * 2 + dtype) {
    case 64: plan = dq_plan<float, 32>(b, sum != 0); break;
    case 65: plan = dq_plan<__nv_bfloat16, 32>(b, sum != 0); break;
    case 128: plan = dq_plan<float, 64>(b, sum != 0); break;
    case 129: plan = dq_plan<__nv_bfloat16, 64>(b, sum != 0); break;
    case 256: plan = dq_plan<float, 128>(b, sum != 0); break;
    case 257: plan = dq_plan<__nv_bfloat16, 128>(b, sum != 0); break;
    case 2 * BF16_DIM + 1: plan = dq_plan<__nv_bfloat16, BF16_DIM>(b, sum != 0); break;
    case 2 * F32_DIM: plan = dq_plan<float, F32_DIM>(b, sum != 0); break;
    default: return cudaErrorInvalidValue;
  }
  out[0] = plan.cluster;
  out[1] = plan.stages;
  out[2] = plan.smem;
  out[3] = plan.blocks;
  return cudaSuccess;
}

// K3's launch plan for these sizes, head dim and dtype (0 float32, 1
// bfloat16): out[0] the cluster, out[1] the query chunks, out[2] the
// consumer warpgroups a block, out[3] the ring's stages, out[4] the block's
// shared memory, out[5] the blocks an SM it is built for
// (ops/kernels/flash_attention.py::dkv_plan mirrors it)
extern "C" int flash_dkv_plan(int b, int heads, int hk, int n, int m, int d, int dtype,
                              int* out) {
  if (hk <= 0 || heads % hk || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  if (wide_dim(d, dtype == 1)) {  // the column-sliced form: no cluster or query chunks, 2 stages
    const int shape[6] = {1, 1, 1, 2,
                          (int)(dtype == 0 ? tc::Wide<float>::RING
                                           : tc::Wide<__nv_bfloat16>::RING), WIDE_BLOCKS};
    for (int i = 0; i < 6; ++i) out[i] = shape[i];
    return cudaSuccess;
  }
  const DkvPlan plan = dkv_plan(dtype == 0, b, heads, hk, n, m, d);
  switch (d * 2 + dtype) {
    case 64: dkv_shape<float, 32>(plan.two, out + 3); break;
    case 65: dkv_shape<__nv_bfloat16, 32>(plan.two, out + 3); break;
    case 128: dkv_shape<float, 64>(plan.two, out + 3); break;
    case 129: dkv_shape<__nv_bfloat16, 64>(plan.two, out + 3); break;
    case 256: dkv_shape<float, 128>(plan.two, out + 3); break;
    case 257: dkv_shape<__nv_bfloat16, 128>(plan.two, out + 3); break;
    case 2 * BF16_DIM + 1: dkv_shape<__nv_bfloat16, BF16_DIM>(plan.two, out + 3); break;
    case 2 * F32_DIM: dkv_shape<float, F32_DIM>(plan.two, out + 3); break;
    default: return cudaErrorInvalidValue;
  }
  out[0] = plan.cluster;
  out[1] = plan.qsplit;
  out[2] = plan.two ? 2 : 1;
  return cudaSuccess;
}
