// Flash-attention backward for Hopper (sm_90a): dq (K2), dk/dv (K3), the
// gradient of the (2N-1, H) rel-pos distance table (K4) and the gradient of
// an (H, N, M) bias shared over the batch (K5). Each recomputes
// P = exp(S - lse) tile by tile from the forward's row logsumexp, so the
// (N, M) attention matrix never exists in device memory.
//
// Replaces the TPU kernels of the JAX package, ops/pallas/flash_attention.py:
//   K2 `_dq_kernel`      dq = scale * sum_k dS K, dS = P * (dP - Delta)
//   K3 `_dkv_kernel`     dK = scale * dS^T Q, dV = P^T dO, the MQA head sum
//                        folded into the accumulation
//   K4 `_dblocks_kernel` the bias gradient sum_b dS in per-delta-block form,
//                        folded into the table by AD of
//                        ops/relpos.py::delta_bias_blocks; here straight into
//                        dtab[q - k + N - 1, h]
//   K5 `_dbias_kernel`   dbias = sum_b dS for a batch-shared (H, N, M) bias,
//                        each tile written once
// with the same semantics: masked keys at -1e30, keys past M at -inf, a row
// whose lse is <= -5e29 (every key masked) gets p = 0, padded query rows get
// no gradient. Delta = rowsum(dO * O) comes in precomputed (a torch
// reduction, as the JAX package leaves it to XLA).
//
// What bounds them. At the flagship training shape (B=4, H=8, N=2048, D=64,
// causal, MQA) one causal product over the attended (q, k) pairs is
// 2*D*B*H*N*(N+1)/2 = 8.6 GFLOP against ~17 MB of float32 q and dO and 2 MB
// of k and v, so both kernels are compute-bound: K2 does 3 products (25.8
// GFLOP, 0.385 ms at the 67 TFLOP/s float32 peak without tensor cores), K3
// does 4 (34.4 GFLOP: 0.21 ms as 3xTF32 at 495 TFLOP/s, 35 us in bf16 at
// 989); worked out from the shapes, not measured.
// K4 is fused into K2, since it needs K2's dS tile and nothing else: it adds
// one add per attended pair (B*H*N*(N+1)/2) and the (2N-1, H) float32
// table's read-modify-write to K2's work, where alone it would redo 2 of
// K2's 3 products (17.2 GFLOP) to rebuild dS.
//
// Design. K2 and K5, right and simple first: float32 FMAs on the CUDA
// cores, 256 threads as a 16x16 grid, each owning a 4x4 patch of a 64x64
// tile; tiles in shared memory transposed and padded against bank conflicts.
//   K2: one block per (b*h, 64-row query tile), heaviest tiles first; it loops
//       over the key tiles up to the diagonal and keeps dq in registers.
//   K4, inside K2 when the table's gradient is asked for: each key tile's dS,
//       already in shared memory for dq, is summed along its 127 diagonals,
//       then added with one atomicAdd per diagonal per tile into a float32
//       (2N-1, H) buffer the wrapper zeroes (the batch sum among them, in an
//       order that changes from run to run).
// With the table, the (H, N, N) bias and its gradient never exist in device
// memory: a tile loads the 127 table entries its deltas cover. With an
// (H, N, M) bias (the Coarse and Fine LMs'), K2 loads each tile's 64x64
// float32 block of bias[h] into the dS tile's shared memory, where each
// thread reads its own elements before it overwrites them (no extra shared
// memory, so no occupancy lost), K3 into a block of its own, and
//   K5: one block per (key tile, query tile, head), as the TPU grid
//       (H, nq, nk, B) with the batch innermost: the block loops over the
//       batch rows (and so over the kv head each query head reads, MQA),
//       recomputes S, P and dP (2 products) and sums dS in registers, then
//       writes its tile once; tiles above the causal diagonal are written as
//       zeros. No atomics, so the sum's order is fixed. It redoes 2 of K2's 3
//       products; fusing it into K2 with atomics, as K4 was, is later work.
//       At the Fine LM's training shape (B=4, H=8, N=M=1201, causal) those
//       are 5.9 GFLOP, 88 us at the float32 peak, against 46 MB of dbias
//       written and 46 MB of bias read, 28 us at 3.35 TB/s: compute-bound
//       (worked out from the shapes, not measured).
//   K3, on the tensor cores through csrc/mma.cuh (mma.sync, cp.async): one
//       block of 4 warps per (query head, b*hk, 64-key tile), key tile 0
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
// K2, K5: tensor cores, TMA and wgmma are later work. Instantiated for D=64.
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
constexpr int NT = 256;         // threads: a 16x16 grid of (ty, tx)
constexpr int PITCH = BQ + 1;   // transposed tiles, padded against bank conflicts
constexpr int ND = BQ + BK - 1; // deltas a tile covers
using tc::NEG;
static_assert(BQ == BK, "square tiles: the causal loops start at the diagonal tile");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows r0.. of a (rows, D) matrix into a transposed tile dst[c * PITCH + r],
// times `mul`; rows past `rows` are zero
template <typename T, int D>
__device__ __forceinline__ void load_t(float* dst, const T* src, int r0, int rows, float mul) {
  for (int i = threadIdx.x; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[c * PITCH + r] = r0 + r < rows ? to_f(src[(size_t)(r0 + r) * D + c]) * mul : 0.f;
  }
}

// Bs[i] = tab[q0 - k0 - (BK - 1) + i + n - 1, h]: the bias of delta
// (q0 + r) - (k0 + c) is Bs[r - c + BK - 1]
__device__ __forceinline__ void load_bias(float* Bs, const float* tab, int q0, int k0, int n,
                                          int h, int heads) {
  for (int i = threadIdx.x; i < ND; i += NT)
    Bs[i] = tc::tab_entry(tab, q0, k0, BK, i, n, heads, h);
}

// Ts[r * qs + c * ks] = bias_h[q0 + r, k0 + c] (r query, c key) of an (n, m)
// float32 bias plane, zero outside it; read coalesced along the keys. One of
// qs, ks is 1 and the other PITCH: query-major (K3, K5) or key-major (K2).
__device__ __forceinline__ void load_bias_tile(float* Ts, const float* bias_h, int q0, int k0,
                                               int n, int m, int qs, int ks) {
  for (int i = threadIdx.x; i < BQ * BK; i += NT) {
    const int r = i / BK, c = i % BK;
    Ts[r * qs + c * ks] = q0 + r < n && k0 + c < m ? bias_h[(size_t)(q0 + r) * m + k0 + c] : 0.f;
  }
}

// key flags: 0 attend, NEG masked, -inf past m
__device__ __forceinline__ void load_flags(float* Fs, const int8_t* kmask, int b, int k0, int m) {
  for (int i = threadIdx.x; i < BK; i += NT) Fs[i] = tc::key_flag(kmask, b, m, k0 + i);
}

// lse (+inf on padded rows, so p = 0 there) and Delta of query rows q0..
__device__ __forceinline__ void load_rows(float* Ls, float* Dl, const float* lse,
                                          const float* delta, int q0, int n) {
  for (int i = threadIdx.x; i < BQ; i += NT) {
    const bool in = q0 + i < n;
    Ls[i] = in ? lse[q0 + i] : INFINITY;
    Dl[i] = in ? delta[q0 + i] : 0.f;
  }
}

// p and dS of one (query row, key) pair from the raw product s = scale q.k,
// dp = dO.v, as the forward formed the logit
__device__ __forceinline__ void p_ds(float s, float dp, float bias, float flag, bool above,
                                     float lse, float delta, float& p, float& ds) {
  const float x = tc::score(s + bias, flag, above);
  p = lse > 0.5f * NEG ? expf(x - lse) : 0.f;
  ds = p * (dp - delta);
}

template <int D>
constexpr size_t smem_rows() {
  // Qs, Gs, Ks, Vs [D][PITCH]; dS^T [BK][PITCH]; bias [ND]; flags [BK]; lse, Delta [BQ]
  return sizeof(float) * (4 * D * PITCH + BK * PITCH + ND + BK + 2 * BQ);
}

// K2 (dq) with K4 (dtab, when not null) fused in. One block per (b*h, query tile).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ g, const float* __restrict__ lse,
                      const float* __restrict__ delta, const float* __restrict__ tab,
                      const float* __restrict__ bias, const int8_t* __restrict__ kmask,
                      T* __restrict__ dq,
                      float* __restrict__ dtab, int heads, int group, int n, int m,
                      float scale, int causal) {
  constexpr int DC = D / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // (scale q)^T
  float* Gs = Qs + D * PITCH;    // dO^T
  float* Ks = Gs + D * PITCH;    // k^T
  float* Vs = Ks + D * PITCH;    // v^T
  float* Ss = Vs + D * PITCH;    // dS^T: Ss[c * PITCH + r]; before dS, the (H, N, M) bias tile
  float* Bs = Ss + BK * PITCH;
  float* Fs = Bs + ND;
  float* Ls = Fs + BK;
  float* Dl = Ls + BQ;

  const int bh = blockIdx.y;
  const int h = bh % heads, b = bh / heads;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal rows first
  const float* biash = bias != nullptr ? bias + (size_t)h * n * m : nullptr;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* kb = k + (size_t)(bh / group) * m * D;
  const T* vb = v + (size_t)(bh / group) * m * D;

  load_t<T, D>(Qs, q + (size_t)bh * n * D, q0, n, scale);
  load_t<T, D>(Gs, g + (size_t)bh * n * D, q0, n, 1.f);
  load_rows(Ls, Dl, lse + (size_t)bh * n, delta + (size_t)bh * n, q0, n);

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int kv_end = causal ? min(m, q0 + BQ) : m;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    load_t<T, D>(Ks, kb, k0, m, 1.f);
    load_t<T, D>(Vs, vb, k0, m, 1.f);
    if (tab != nullptr) load_bias(Bs, tab, q0, k0, n, h, heads);
    if (biash != nullptr) load_bias_tile(Ss, biash, q0, k0, n, m, 1, PITCH);
    load_flags(Fs, kmask, b, k0, m);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], ga[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[d * PITCH + ty + 16 * i];
        ga[i] = Gs[d * PITCH + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = Ks[d * PITCH + tx + 16 * j];
        bv[j] = Vs[d * PITCH + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(ga[i], bv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float p, ds;
        // the bias tile's element is this thread's own, read before dS overwrites it
        const float bias_rc = tab != nullptr ? Bs[r - c + BK - 1]
                              : biash != nullptr ? Ss[c * PITCH + r] : 0.f;
        p_ds(s[i][j], dp[i][j], bias_rc, Fs[c], causal && k0 + c > q0 + r, Ls[r], Dl[r], p,
             ds);
        Ss[c * PITCH + r] = ds;
      }
    }
    __syncthreads();

    // dq[r][col] += sum_c dS[r][c] k[c][col]
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsr[i] = Ss[c * PITCH + ty + 16 * i];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float kk = Ks[(tx + 16 * cc) * PITCH + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(dsr[i], kk, acc[i][cc]);
      }
    }
    if (dtab != nullptr) {
      // K4: diagonal t holds the pairs r - c = t - (BK - 1), delta
      // q0 - k0 + t - (BK - 1); two threads per diagonal, each summing every other row
      const int t = tid >> 1, half = tid & 1;
      float sum = 0.f;
      if (t < ND) {
        const int r_lo = max(0, t - (BK - 1)), r_hi = min(BQ - 1, t);
        for (int r = r_lo + half; r <= r_hi; r += 2) sum += Ss[(r - t + BK - 1) * PITCH + r];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const int idx = q0 - k0 - (BK - 1) + t + n - 1;
      if (t < ND && half == 0 && sum != 0.f && idx >= 0 && idx < 2 * n - 1)
        atomicAdd(dtab + (size_t)idx * heads + h, sum);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= n) continue;
    T* o = dq + ((size_t)bh * n + qp) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) o[tx + 16 * cc] = from_f<T>(acc[i][cc] * scale);
  }
}

// K3: one block of 4 warps per (query head of the group, b*hk, 64-key tile),
// the blocks of one (b*hk, key tile) a thread-block cluster (see the note at
// the top). Each warp owns 16 keys: its rows of S^T, dP^T, dK and dV.
constexpr int NT3 = 128;          // K3's threads
constexpr int TP3 = BQ + 4;       // K3's bias tile pitch: rows are queries, read down the keys
constexpr int MAX_CLUSTER = 8;    // the portable cluster size

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
  // its own name: K2's and K5's dynamic shared memory is declared float
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

template <int D>
constexpr size_t smem_dbias() {
  // Qs, Gs, Ks, Vs [D][PITCH]; bias tile [BQ][PITCH]; flags [BK]; lse, Delta [BQ]
  return sizeof(float) * (4 * D * PITCH + BQ * PITCH + BK + 2 * BQ);
}

// K5. One block per (key tile, query tile, head); loops over the batch.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dbias_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ g, const float* __restrict__ lse,
                       const float* __restrict__ delta, const float* __restrict__ bias,
                       const int8_t* __restrict__ kmask, float* __restrict__ dbias,
                       int batch, int heads, int hk, int n, int m, float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;              // (scale q)^T
  float* Gs = Qs + D * PITCH;    // dO^T
  float* Ks = Gs + D * PITCH;    // k^T
  float* Vs = Ks + D * PITCH;    // v^T
  float* Ts = Vs + D * PITCH;    // bias tile: Ts[r * PITCH + c]
  float* Fs = Ts + BQ * PITCH;
  float* Ls = Fs + BK;
  float* Dl = Ls + BQ;

  const int k0 = blockIdx.x * BK, q0 = blockIdx.y * BQ, h = blockIdx.z;
  const int group = heads / hk;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* biash = bias + (size_t)h * n * m;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // causal: a tile wholly above the diagonal has p = 0, so dbias = 0 there
  if (!(causal && k0 > q0 + BQ - 1)) {
    load_bias_tile(Ts, biash, q0, k0, n, m, PITCH, 1);
    for (int b = 0; b < batch; ++b) {
      const int bh = b * heads + h;
      const int kvh = b * hk + h / group;
      __syncthreads();  // the previous batch row's tiles are consumed
      load_t<T, D>(Qs, q + (size_t)bh * n * D, q0, n, scale);
      load_t<T, D>(Gs, g + (size_t)bh * n * D, q0, n, 1.f);
      load_t<T, D>(Ks, k + (size_t)kvh * m * D, k0, m, 1.f);
      load_t<T, D>(Vs, v + (size_t)kvh * m * D, k0, m, 1.f);
      load_rows(Ls, Dl, lse + (size_t)bh * n, delta + (size_t)bh * n, q0, n);
      load_flags(Fs, kmask, b, k0, m);
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[4], ga[4], bk[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = Qs[d * PITCH + ty + 16 * i];
          ga[i] = Gs[d * PITCH + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bk[j] = Ks[d * PITCH + tx + 16 * j];
          bv[j] = Vs[d * PITCH + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i], bk[j], s[i][j]);
            dp[i][j] = fmaf(ga[i], bv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          float p, ds;
          p_ds(s[i][j], dp[i][j], Ts[r * PITCH + c], Fs[c], causal && k0 + c > q0 + r, Ls[r],
               Dl[r], p, ds);
          acc[i][j] += ds;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kp = k0 + tx + 16 * j;
      if (kp < m) dbias[((size_t)h * n + qp) * m + kp] = acc[i][j];
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
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a, void* dq, void* dtab) {
  constexpr size_t smem = smem_rows<D>();
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.n + BQ - 1) / BQ, a.b * a.heads);
  kernel<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.tab),
      static_cast<const float*>(a.bias), static_cast<const int8_t*>(a.kmask),
      static_cast<T*>(dq), static_cast<float*>(dtab),
      a.heads, a.heads / a.hk, a.n, a.m, a.scale, a.causal);
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
  const int group = a.heads / a.hk;
  int cluster = MAX_CLUSTER;
  while (group % cluster) --cluster;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
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

template <typename T, int D>
cudaError_t launch_dbias(const Args& a, void* dbias) {
  constexpr size_t smem = smem_dbias<D>();
  auto kernel = flash_bwd_dbias_kernel<T, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.m + BK - 1) / BK, (a.n + BQ - 1) / BQ, a.heads);
  kernel<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.bias),
      static_cast<const int8_t*>(a.kmask), static_cast<float*>(dbias),
      a.b, a.heads, a.hk, a.n, a.m, a.scale, a.causal);
  return cudaGetLastError();
}

// which: 0 dq (and dtab in o2 when not null), 1 dk/dv, 2 dbias
template <typename T>
cudaError_t dispatch(int which, int d, const Args& a, void* o1, void* o2) {
  if (d != 64) return cudaErrorInvalidValue;
  if (a.tab != nullptr && a.bias != nullptr) return cudaErrorInvalidValue;
  if (which == 1) return launch_dkv<T, 64>(a, o1, o2);
  if (which == 2) return a.bias == nullptr ? cudaErrorInvalidValue : launch_dbias<T, 64>(a, o1);
  if (o2 != nullptr && (a.tab == nullptr || a.n != a.m)) return cudaErrorInvalidValue;
  return launch_dq<T, 64>(a, o1, o2);
}

int run(int which, const void* q, const void* k, const void* v, const void* g,
        const void* lse, const void* delta, const void* tab, const void* bias,
        const void* kmask, void* o1, void* o2, int b, int heads, int hk, int n, int m, int d,
        float scale, int causal, int dtype, void* stream) {
  const Args a{q, k, v, g, lse, delta, tab, bias, kmask, b, heads, hk, n, m, scale, causal,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(which, d, a, o1, o2);
  if (dtype == 1) return dispatch<__nv_bfloat16>(which, d, a, o1, o2);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, g (b*heads, n, d); k, v (b*hk, m, d), in one dtype (0 float32, 1
// bfloat16); lse, delta (b*heads, n) float32; tab (2n-1, heads) float32 or
// null; bias (heads, n, m) float32 or null, at most one of tab and bias;
// kmask (b, m) int8 or null. Each returns a cudaError_t.

// dq (b*heads, n, d) in q's dtype; with dtab not null also the table's
// gradient, dtab (2n-1, heads) float32, zeroed by the caller (needs tab and n == m)
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                            const void* lse, const void* delta, const void* tab,
                            const void* bias, const void* kmask, void* dq, void* dtab, int b,
                            int heads, int hk, int n, int m, int d, float scale, int causal,
                            int dtype, void* stream) {
  return run(0, q, k, v, g, lse, delta, tab, bias, kmask, dq, dtab, b, heads, hk, n, m, d,
             scale, causal, dtype, stream);
}

// dk, dv (b*hk, m, d) in k's dtype
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                             const void* lse, const void* delta, const void* tab,
                             const void* bias, const void* kmask, void* dk, void* dv, int b,
                             int heads, int hk, int n, int m, int d, float scale, int causal,
                             int dtype, void* stream) {
  return run(1, q, k, v, g, lse, delta, tab, bias, kmask, dk, dv, b, heads, hk, n, m, d,
             scale, causal, dtype, stream);
}

// dbias (heads, n, m) float32, every element written (needs bias; tab and
// the second output are unused and null)
extern "C" int flash_bwd_dbias(const void* q, const void* k, const void* v, const void* g,
                               const void* lse, const void* delta, const void* tab,
                               const void* bias, const void* kmask, void* dbias, void* unused,
                               int b, int heads, int hk, int n, int m, int d, float scale,
                               int causal, int dtype, void* stream) {
  return run(2, q, k, v, g, lse, delta, tab, bias, kmask, dbias, unused, b, heads, hk, n, m, d,
             scale, causal, dtype, stream);
}
