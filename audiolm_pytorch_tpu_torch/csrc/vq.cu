// Nearest-code search of vector quantization for Hopper (sm_90a): for each
// row x of X (N, D), the index of the codebook row e of E (C, D) that
// minimises -2 x.e + |e|^2, the first index on ties.
//
// Replaces the TPU kernel of the JAX package, ops/pallas/vq.py `_kernel`
// (launched by `vq_nearest_code`, dispatched from ops/quantize.py
// `VectorQuantizeEMA.encode`): the (N, C) score matrix is never written to
// device memory, only the (N,) int32 indices.
//
// What bounds it. At the codec's shape (N = 800 rows of one quantizer for
// 8 clips of 2 s at 50 Hz, D = 512, C = 1024) the products are
// 2*N*C*D = 0.84 GFLOP: 5.1 us as 3xTF32 on the tensor cores (three TF32
// products at 495 TFLOP/s), against 3.7 MB of inputs, 1.1 us at 3.35 TB/s;
// at 1 to 7 rows the search reads E (2 MB, 0.6 us). Both are far below a
// launch's own latency, so what bounds it at every shape the port gives it
// is the length of each block's serial chain and how many SMs share the
// work (worked out from the shapes). The design before this one ran 16
// chunks of 32 dimensions in sequence in each block at ~2.2 us a chunk,
// the same at 1 row as at 800, on at most 104 blocks (24 at 192 rows).
//
// Design (warp-specialised, on wgmma and TMA through csrc/wgmma.cuh). One
// launch. A block is a producer warpgroup and a consumer warpgroup and
// takes a 64-row tile of X against 64-code tiles of E over a range of the
// dimensions, streamed 32 dimensions (one 128-byte swizzled row) at a time:
//   - The producer's first thread loads each chunk of X and E by TMA (2-D
//     maps; rows past N or C and columns past D read as zeros) into a ring
//     of stages with full and empty mbarriers, two chunks ahead. Its 128
//     threads split each chunk once into tf32 big/small tiles in place
//     (tc::to_tf32's integer rounding) while the consumer multiplies the
//     chunk before, and sum the squares of the code rows in the same pass,
//     each code's in a fixed order.
//   - The consumer takes S = X E^T of each chunk as three wgmma m64n64k8
//     tf32 products a k-step (3xTF32), from zero, and adds it to the
//     running x.e in float32: the tensor cores' accumulation truncates, and
//     a 512-deep sum inside the product would lose up to an ulp a product,
//     too close to the near-tie gate of 1e-5 of the score's terms.
//   - Each row's (score, index) minimum: scores -2 x.e + |e|^2 (one
//     rounding) in increasing code order with a strict <, then across the
//     quad (a row's 64 codes lie in one quad's accumulators) by (score,
//     index) pairs, so ties go to the first index whatever the order.
// The launch plan (vq_plan; ops/kernels/vq.py::vq_plan states it for the
// tests) spreads the search over the card: where row tiles x code tiles is
// under the SMs' count, the dimensions are split over the ranks of a
// thread-block cluster of 2, 4 or 8 (portable sizes), which add their
// partial x.e tiles and partial |e|^2 in rank order through distributed
// shared memory before the argmin (the same bits every run); the code
// tiles are spread over groups of blocks, each taking every G-th tile.
// Where a row tile has more than one group, each group's row minima go to
// a scratch row in device memory and the row tile's last block to arrive
// (a ticket, atomicInc, which leaves the counter at 0 again) merges the
// groups' minima by (score, index). So 1 row runs on 128 blocks (16 code
// tiles x 8 ranks), 192 rows on 192, 800 rows on 208 (16 groups). The
// scratch and tickets are static device memory of the library (at most
// 2 x 132 row tile x group slots), so launches on one device must not run
// concurrently on two streams; the port issues them on one stream. Rows
// with no score below +inf (NaN rows) get index 0.
//
// What holds it back (measured by tools/torch_flash_parent_ab.py, PERF.md):
// about half a microsecond a chunk a block with two blocks an SM, against a
// fifth of that of products. The 3xTF32 products read ~48 KB of shared
// memory a chunk and the split pass reads and writes ~48 KB more, so shared
// memory's bandwidth, with the split of every X chunk repeated for each
// code tile, is the likely limit. Two accumulator sets a consumer (one
// chunk's products running while the last one's are added) were slower
// with three stages, which then leave no load in flight, and with four,
// which leave one block an SM.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BN = 64;          // rows of X per tile (wgmma's M)
constexpr int BC = 64;          // codes per tile (wgmma's N)
constexpr int KC = 32;          // dimensions per chunk: 128 bytes of float32
constexpr int ST = 3;           // ring stages
constexpr int NT = 256;         // the producer warpgroup, then the consumer warpgroup
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int PLAN_SMS = 132;   // the H100's SMs, which the plan fills
constexpr int NONE = 0x7fffffff;
constexpr int CT = BN * KC * 4;  // bytes of one chunk tile (64 rows x 128 bytes)
static_assert(BN == BC, "X's and E's chunk tiles share a size");

// Shared memory (offsets from a 1024-byte aligned base): per stage the
// chunk tiles X big, X small, E big, E small; per stage the partial |e|^2
// of the tile whose last chunk it holds; the row minima; the barriers.
// After the loop, with the dimensions split, the partial x.e tile (pitch
// PP) and partial |e|^2 take the stages' place. ~99 KB: two blocks an SM.
constexpr int PP = BC + 4;
constexpr int STAGE = 4 * CT;
constexpr int E2 = ST * STAGE;
constexpr int BEST = E2 + ST * BC * 4;
constexpr int BARS = BEST + BN * 8;
constexpr size_t SMEM = BARS + 128;
static_assert(ST * STAGE >= (BN * PP + BC) * 4, "the partial tile fits in the stages");
static_assert((1 + 3 * ST) * 8 <= 128, "the barriers fit");

// row tile x group slots whose minima merge through device memory
constexpr int MERGE_SLOTS = 2 * PLAN_SMS;
__device__ float2 merge_rows[MERGE_SLOTS * BN];  // (score, index as int bits)
__device__ unsigned merge_ticket[PLAN_SMS];

__device__ __forceinline__ bool better(float s, int i, float s_best, int i_best) {
  return s < s_best || (s == s_best && i < i_best);
}

// the tile at s (64 rows x 32 floats, swizzled) split in place into tf32 big
// parts, its small parts into lo; thread i of 128 takes row i / 2, 16-byte
// parts 4 (i % 2) .. 4 (i % 2) + 3 (conflict-free), and returns the sum of
// their squares in that order
__device__ __forceinline__ float split_rows(float* s, float* lo, int i) {
  const int r = i >> 1;
  float sq = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int off = r * 32 + ((((i & 1) * 4 + q) ^ (r & 7)) << 2);
    const uint4 x = *reinterpret_cast<const uint4*>(s + off);
    const float f[4] = {__uint_as_float(x.x), __uint_as_float(x.y), __uint_as_float(x.z),
                        __uint_as_float(x.w)};
    uint4 h, l;
    tc::split(f[0], h.x, l.x);
    tc::split(f[1], h.y, l.y);
    tc::split(f[2], h.z, l.z);
    tc::split(f[3], h.w, l.w);
    *reinterpret_cast<uint4*>(s + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
#pragma unroll
    for (int e = 0; e < 4; ++e) sq = fmaf(f[e], f[e], sq);
  }
  return sq;
}

// acc (64 x 64) = A B^T over one chunk of 32 dimensions, A (rows) and B
// (codes) K-major split tiles; issued and committed, not waited for
__device__ __forceinline__ void chunk_product(float (&acc)[32], const float* ah, const float* al,
                                              const float* bh, const float* bl) {
#pragma unroll
  for (int ks = 0; ks < KC / 8; ++ks) {
    const uint64_t k = 2 * ks;  // 32 bytes a k-step, in 16-byte units
    const uint64_t dah = wg::desc(ah) + k, dbh = wg::desc(bh) + k;
#ifndef MMA_TF32_ONE_PASS
    wg::mma_tf32_ss(acc, dah, wg::desc(bl) + k, ks > 0);
    wg::mma_tf32_ss(acc, wg::desc(al) + k, dbh, 1);
    wg::mma_tf32_ss(acc, dah, dbh, 1);
#else
    wg::mma_tf32_ss(acc, dah, dbh, ks > 0);
#endif
  }
  wg::wgmma_commit();
}

// A one-dimensional grid of (ranks, groups, row tiles), ranks fastest (so
// any number of rows: the grid's x limit is 2^31 - 1 blocks); the ranks of
// one (group, row tile) a cluster, each taking a contiguous share of the
// chunks.
__global__ void __launch_bounds__(NT, 2)
vq_nearest_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap emap,
                  int32_t* __restrict__ out, int n, int c, int d4, int groups) {
  extern __shared__ __align__(1024) unsigned char vq_smem[];
  unsigned char* sm = vq_smem;
  if (threadIdx.x == 0 && (tc::smem_u32(sm) & 1023) != 0) __trap();  // the tiles' swizzle
  auto Xh = [&](int s) { return reinterpret_cast<float*>(sm + s * STAGE); };
  auto Xl = [&](int s) { return reinterpret_cast<float*>(sm + s * STAGE + CT); };
  auto Eh = [&](int s) { return reinterpret_cast<float*>(sm + s * STAGE + 2 * CT); };
  auto El = [&](int s) { return reinterpret_cast<float*>(sm + s * STAGE + 3 * CT); };
  auto E2s = [&](int s) { return reinterpret_cast<float*>(sm + E2) + s * BC; };
  float2* best = reinterpret_cast<float2*>(sm + BEST);  // the rows' (score, index bits)
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + BARS);
  uint64_t *loaded = bars, *full = bars + ST, *empty = bars + 2 * ST, *ticket = bars + 3 * ST;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ksplit = (int)cluster.num_blocks();
  const int grp = blockIdx.x / ksplit % groups, rt = blockIdx.x / ksplit / groups;
  const int r0 = rt * BN;
  const int code_tiles = (c + BC - 1) / BC, chunks = (d4 + KC - 1) / KC;
  const int my_tiles = (code_tiles - grp + groups - 1) / groups;  // tiles grp, grp + groups, ...
  const int c_lo = rank * chunks / ksplit, nch = (rank + 1) * chunks / ksplit - c_lo;
  const int total = my_tiles * nch;
  const int tid = threadIdx.x;

  if (tid == 0) {
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
    auto issue = [&](int it) {
      const int s = it % ST;
      wg::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
      if (tid == 0) {
        const int k0 = (c_lo + it % nch) * KC, code0 = (grp + groups * (it / nch)) * BC;
        wg::mbar_arrive_tx(&loaded[s], 2 * CT);
        wg::tma_load_2d(Xh(s), &xmap, &loaded[s], k0, r0);
        wg::tma_load_2d(Eh(s), &emap, &loaded[s], k0, code0);
      }
    };
    // chunk it landed: split X and E, |e|^2 of the tile when its last chunk
    // is in (the two halves of a code row added by the even thread), then
    // hand the stage over
    float e2 = 0.f;
    auto finish = [&](int it) {
      const int s = it % ST;
      wg::mbar_wait(&loaded[s], (it / ST) & 1);
      split_rows(Xh(s), Xl(s), tid);
      e2 += split_rows(Eh(s), El(s), tid);
      if (it % nch == nch - 1) {
        const float other = __shfl_xor_sync(0xffffffffu, e2, 1);
        if ((tid & 1) == 0) E2s(s)[tid >> 1] = e2 + other;
        e2 = 0.f;
      }
      wg::fence_proxy_async();
      wg::mbar_arrive(&full[s]);
    };
    // ST - 1 chunks' loads in flight: chunk it is split while the consumer
    // multiplies chunk it - 1, then chunk it + ST - 1 is loaded into the
    // stage chunk it - 1 frees
    for (int it = 0; it < ST - 1 && it < total; ++it) issue(it);
    for (int it = 0; it < total; ++it) {
      finish(it);
      if (it + ST - 1 < total) issue(it + ST - 1);
    }
    if (ksplit > 1) {  // the cluster's two barriers of the rank-order sum below
      tc::cluster_arrive();
      tc::cluster_wait();
      tc::cluster_arrive_relaxed();
      tc::cluster_wait();
    }
    return;
  }

  // ---- the consumer ----
  const int ctid = tid - 128, warp = ctid / 32, lane = ctid % 32, g = lane / 4, t = lane % 4;
  float sum[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i] = 0.f;
  float run_s[2] = {INFINITY, INFINITY};  // rows 16 warp + g and + 8
  int run_i[2] = {NONE, NONE};
  for (int it = 0; it < total; ++it) {
    const int s = it % ST;
    wg::mbar_wait(&full[s], (it / ST) & 1);
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
    wg::fence_acc(part);
    wg::wgmma_fence();
    chunk_product(part, Xh(s), Xl(s), Eh(s), El(s));
    wg::wgmma_wait<0>();
    wg::fence_acc(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[i] += part[i];
    if (ksplit == 1 && it % nch == nch - 1) {
      // the tile is done: its scores into the running minima; codes
      // code0 + 8 j + 2 t + (i & 1) rise with j and i: a strict < keeps the first
      const int code0 = (grp + groups * (it / nch)) * BC;
      const float* e2 = E2s(s);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 8 * j + 2 * t + (i & 1);
          const float sc = fmaf(-2.f, sum[4 * j + i], e2[col]);  // -2 x.e exact, one rounding
          if (code0 + col < c && sc < run_s[i / 2]) {
            run_s[i / 2] = sc;
            run_i[i / 2] = code0 + col;
          }
          sum[4 * j + i] = 0.f;
        }
    }
    wg::mbar_arrive(&empty[s]);
  }

  // the rows this block decides: (first, count) of the tile, each row's
  // minimum in best[]
  int row_lo = 0, rows = BN;
  if (ksplit == 1) {
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float s2 = __shfl_xor_sync(0xffffffffu, run_s[ri], off);
        const int i2 = __shfl_xor_sync(0xffffffffu, run_i[ri], off);
        if (better(s2, i2, run_s[ri], run_i[ri])) {
          run_s[ri] = s2;
          run_i[ri] = i2;
        }
      }
      if (t == 0) best[warp * 16 + 8 * ri + g] = make_float2(run_s[ri], __int_as_float(run_i[ri]));
    }
  } else {
    // the dimensions split over the cluster: this rank's partial x.e tile
    // and |e|^2 into the stages' place (every chunk is consumed), then each
    // rank adds its share of the rows over the ranks in rank order
    float* part = reinterpret_cast<float*>(sm);
    float* pe2 = part + BN * PP;
    tc::bar_sync(1, 128);  // every warp's products have read the stages
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int ri = 0; ri < 2; ++ri)
        tc::store2(part + (warp * 16 + 8 * ri + g) * PP + 8 * j + 2 * t, sum[4 * j + 2 * ri],
                   sum[4 * j + 2 * ri + 1]);
    if (ctid < BC) pe2[ctid] = total > 0 ? E2s((total - 1) % ST)[ctid] : 0.f;
    tc::cluster_arrive();
    tc::cluster_wait();
    row_lo = rank * BN / ksplit;
    rows = (rank + 1) * BN / ksplit - row_lo;
    const int code0 = grp * BC;  // one code tile a block when the dimensions are split
    for (int r = row_lo + warp; r < row_lo + rows; r += 4) {
      float bs = INFINITY;
      int bi = NONE;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = lane + 32 * h;
        float xe = 0.f, e2 = 0.f;
        for (int src = 0; src < ksplit; ++src) {
          const float* p = cluster.map_shared_rank(part, src);
          xe += p[r * PP + col];
          e2 += p[BN * PP + col];
        }
        const float sc = fmaf(-2.f, xe, e2);
        if (code0 + col < c && sc < bs) {
          bs = sc;
          bi = code0 + col;
        }
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float s2 = __shfl_xor_sync(0xffffffffu, bs, off);
        const int i2 = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(s2, i2, bs, bi)) {
          bs = s2;
          bi = i2;
        }
      }
      if (lane == 0) best[r] = make_float2(bs, __int_as_float(bi));
    }
    tc::cluster_arrive_relaxed();  // no block leaves while another reads its partials
    tc::cluster_wait();
  }
  tc::bar_sync(1, 128);  // best[] holds the block's rows

  if (groups == 1) {
    for (int r = row_lo + ctid; r < row_lo + rows; r += 128)
      if (r0 + r < n) {
        const int idx = __float_as_int(best[r].y);
        out[r0 + r] = idx == NONE ? 0 : idx;  // no score below +inf (NaN rows): the first code
      }
    return;
  }
  // several groups a row tile: this group's minima to its scratch row; the
  // row tile's last block to arrive merges the groups' in group order
  float2* slot = merge_rows + ((size_t)rt * groups + grp) * BN;
  for (int r = row_lo + ctid; r < row_lo + rows; r += 128) slot[r] = best[r];
  __threadfence();
  tc::bar_sync(1, 128);
  unsigned* last = reinterpret_cast<unsigned*>(ticket);
  if (ctid == 0) {
    const unsigned arrivals = (unsigned)(groups * ksplit);
    *last = atomicInc(&merge_ticket[rt], arrivals - 1) == arrivals - 1;
  }
  tc::bar_sync(1, 128);
  if (!*last) return;
  __threadfence();
  for (int r = ctid; r < BN; r += 128) {
    if (r0 + r >= n) continue;
    float bs = INFINITY;
    int bi = NONE;
    for (int g2 = 0; g2 < groups; ++g2) {
      const float2 v = __ldcg(merge_rows + ((size_t)rt * groups + g2) * BN + r);
      if (better(v.x, __float_as_int(v.y), bs, bi)) {
        bs = v.x;
        bi = __float_as_int(v.y);
      }
    }
    out[r0 + r] = bi == NONE ? 0 : bi;
  }
}

// K6's launch plan, as ops/kernels/vq.py::vq_plan gives it: where row
// tiles x code tiles is under the SMs' count, every code tile a group of
// its own and the chunks split over the smallest cluster (2, 4, 8; at most
// one rank a chunk) that fills the card; else no split, and the code tiles
// spread over the fewest groups that fill it.
struct VqPlan {
  int ksplit, groups;
};

VqPlan vq_plan(int n, int c, int d) {
  const int chunks = ((d + 3) / 4 * 4 + KC - 1) / KC;
  const long long rts = (n + BN - 1) / BN, cts = (c + BC - 1) / BC;
  int ksplit = 1, groups = 1;
  if (rts * cts < PLAN_SMS) {
    groups = (int)cts;
    while (ksplit < MAX_CLUSTER && 2 * ksplit <= chunks && rts * cts * ksplit < PLAN_SMS)
      ksplit *= 2;
  } else {
    while (groups < cts && rts * groups < PLAN_SMS) groups *= 2;
    if (groups > cts) groups = (int)cts;
  }
  return {ksplit, groups};
}

}  // namespace

// x (n, d) and cb (c, d) float32, row-major, d a multiple of 4 and both
// 16-byte aligned (TMA's rules; ops/kernels/vq.py pads other shapes with
// zero columns, which change no score); out (n,) int32. Any n: the grid is
// one-dimensional. One launch. Returns a cudaError_t.
extern "C" int vq_nearest(const void* x, const void* cb, void* out, int n, int c, int d,
                          void* stream) {
  if (n <= 0 || c <= 0 || d <= 0 || d % 4) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(cb) % 16)
    return cudaErrorInvalidValue;
  const int row_tiles = (n + BN - 1) / BN;
  const VqPlan plan = vq_plan(n, c, d);
  if (plan.groups > 1 && (row_tiles > PLAN_SMS || row_tiles * plan.groups > MERGE_SLOTS))
    return cudaErrorInvalidValue;  // the plan keeps merged tiles within the scratch
  const long long blocks = (long long)plan.ksplit * plan.groups * row_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;  // the grid's x limit, 2^31 - 1
  CUtensorMap xm, em;
  cudaError_t err = wg::matrix_map(&xm, x, n, d, BN);
  if (err == cudaSuccess) err = wg::matrix_map(&em, cb, c, d, BC);
  static unsigned sized = 0;  // the devices whose attribute is set
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 32 || !(sized >> dev & 1))) {
    err = cudaFuncSetAttribute(vq_nearest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM);
    if (err == cudaSuccess) sized |= 1u << dev;
  }
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.ksplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, vq_nearest_kernel, xm, em, static_cast<int32_t*>(out), n, c, d,
                            plan.groups);
}

// K6's launch plan for these sizes: out[0] the cluster (the ranks that split
// the dimensions), out[1] the code groups a row tile (ops/kernels/vq.py::
// vq_plan mirrors it)
extern "C" int vq_nearest_plan(int n, int c, int d, int* out) {
  if (n <= 0 || c <= 0 || d <= 0) return cudaErrorInvalidValue;
  const VqPlan plan = vq_plan(n, c, d);
  out[0] = plan.ksplit;
  out[1] = plan.groups;
  return cudaSuccess;
}
