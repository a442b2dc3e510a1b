// Flash-attention forward for Hopper (sm_90a), with the rel-pos bias read
// straight from its (2N-1, H) distance table, or an (H, N, M) float32 bias
// shared over the batch read tile by tile.
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
// Design (FA2's shape, on the tensor cores through csrc/mma.cuh). One block
// of 4 warps per (b*h, 64-query tile), the heaviest (last) query tiles
// launched first; each warp owns 16 query rows, whose Q fragments stay in
// registers for the whole loop (bf16, or split into tf32 big/small pairs).
// The 64-key K and V tiles are double-buffered in shared memory by cp.async,
// so the next tile loads while this one computes; so is the (H, N, M) bias's
// 64x64 float32 block. S = Q K^T is an mma product; each thread adds the
// bias, the key flags and the causal mask to its own accumulator elements
// (rows lane/4 and lane/4 + 8, columns 2*(lane%4) + {0, 1} of each 8-wide
// block), by the masking rule at the end of mma.cuh: the table's bias from
// the tile's 127-entry slice (the deltas q - k it covers), read ahead into
// registers while the previous tile computes; the causal test runs only on
// tiles that reach above a warp's rows. The online softmax works on those
// fragments, each p one SFU op (2^((x - m) log2 e), exactly 1 where x = m,
// so a row whose keys so far are all masked stays finite), with the row max
// and sum taken across the 4 lanes of a quad. P goes to the P V product as
// the A operand straight from the accumulators (rounded to bf16, or split to
// tf32), never through shared memory; V is the B operand through
// ldmatrix.trans (bf16) or 32-bit loads (float32). Instantiated for D=64, the head dim of every model on the
// port's path.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int NT = 128;         // 4 warps of 16 query rows
constexpr int TPITCH = BK + 8;  // the (H, N, M) bias tile's pitch: float2 reads without conflicts
using tc::NEG;

// Shared memory: two stages of (K tile, V tile, table slice [BQ + BK - 1],
// key flags [BK]), then with an (H, N, M) bias two of its 64x64 blocks.
// Q is staged, before the loop, in stage 1's K tile.
template <typename T, int D>
struct Smem {
  static constexpr int P = tc::pitch<T, D>();
  static constexpr size_t tile = (size_t)BK * P * sizeof(T);
  static constexpr size_t stage = 2 * tile + (BQ + 2 * BK) * sizeof(float);
  static constexpr size_t base = 2 * stage;
  static constexpr size_t dense = 2 * (size_t)BQ * TPITCH * sizeof(float);
  static_assert(tile % 16 == 0 && stage % 16 == 0, "16-byte aligned regions");
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ tab, const float* __restrict__ bias,
                 const int8_t* __restrict__ kmask,
                 T* __restrict__ out, float* __restrict__ lse, int heads, int group,
                 int n, int m, float scale, int causal) {
  using S = Smem<T, D>;
  constexpr int P = S::P;
  extern __shared__ __align__(16) unsigned char smem[];
  auto Ks = [&](int s) { return reinterpret_cast<T*>(smem + s * S::stage); };
  auto Vs = [&](int s) { return reinterpret_cast<T*>(smem + s * S::stage + S::tile); };
  // table slice: Bs[i] = tab[q0 - k0 - (BK - 1) + i + n - 1, h], so
  // the bias of (q0 + r, k0 + c) is Bs[r - c + BK - 1]; then the key flags
  auto Bs = [&](int s) { return reinterpret_cast<float*>(smem + s * S::stage + 2 * S::tile); };
  auto Fs = [&](int s) { return Bs(s) + BQ + BK; };
  auto Ts = [&](int s) { return reinterpret_cast<float*>(smem + S::base) + s * BQ * TPITCH; };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest causal rows first
  const int h = bh % heads, b = bh / heads;
  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const T* qb = q + (size_t)bh * n * D;
  const T* kb = k + (size_t)(bh / group) * m * D;
  const T* vb = v + (size_t)(bh / group) * m * D;
  const float* biash = bias != nullptr ? bias + (size_t)h * n * m : nullptr;

  // causal: key k is seen by query q iff k <= q + off (bottom-right aligned, m >= n)
  const int off = m - n;
  const int kv_end = tc::causal_end(causal, q0 + BQ, off, m);
  const int ntiles = (kv_end + BK - 1) / BK;

  // Tile `it` into stage it & 1: K, V and the bias block by cp.async (one
  // group); the table entry and key flag of this thread into registers,
  // which `stash` stores once this tile's compute has hidden their latency.
  float tab_r = 0.f, flag_r = 0.f;
  auto issue = [&](int it) {
    const int k0 = it * BK, s = it & 1;
    tc::cp_tile<T, D, BK, NT>(Ks(s), P, kb, k0, m);
    tc::cp_tile<T, D, BK, NT>(Vs(s), P, vb, k0, m);
    if (biash != nullptr) tc::cp_block_f32<BQ, BK, NT>(Ts(s), TPITCH, biash, q0, k0, n, m);
    tc::cp_async_commit();
    if (tab != nullptr && tid < BQ + BK - 1)
      tab_r = tc::tab_entry(tab, q0, k0, BK, tid, n, heads, h);
    if (tid < BK) flag_r = tc::key_flag(kmask, b, m, k0 + tid);
  };
  auto stash = [&](int it) {
    const int s = it & 1;
    if (tab != nullptr && tid < BQ + BK - 1) Bs(s)[tid] = tab_r;
    if (tid < BK) Fs(s)[tid] = flag_r;
  };

  // Q (in stage 1's K tile) with tile 0, then Q's fragments into registers
  tc::cp_tile<T, D, BQ, NT>(Ks(1), P, qb, q0, n);
  issue(0);
  stash(0);
  tc::cp_async_wait_all();
  __syncthreads();
  tc::ARegs<T, D> qf;
  qf.load(Ks(1) + warp * 16 * P, P);
  __syncthreads();  // stage 1 is free for tile 1

  const int rl[2] = {warp * 16 + g, warp * 16 + g + 8};  // this thread's rows in the tile
  float m_i[2] = {NEG, NEG}, l_i[2] = {0.f, 0.f};
  float o[D / 8][4];
  tc::zero(o);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it & 1, k0 = it * BK;
    if (it + 1 < ntiles) issue(it + 1);

    float sc[BK / 8][4];
    tc::zero(sc);
    tc::gemm_nk<T, D, BK / 8>(sc, qf, Ks(s), P);

    const float* bs = Bs(s);
    const float* fs = Fs(s);
    const float* ts = Ts(s);
    // keys above the diagonal meet this warp's rows only near the diagonal
    const bool diag = causal && tc::above(k0 + BK - 1, q0 + warp * 16, off);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 f = *reinterpret_cast<const float2*>(fs + c);
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        float2 bb = make_float2(0.f, 0.f);
        if (tab != nullptr) bb = make_float2(bs[rl[ri] - c + BK - 1], bs[rl[ri] - c + BK - 2]);
        else if (biash != nullptr) bb = *reinterpret_cast<const float2*>(ts + rl[ri] * TPITCH + c);
        const int qp = q0 + rl[ri];
        const float x0 = tc::score(fmaf(sc[j][2 * ri], scale, bb.x), f.x,
                                   diag && tc::above(k0 + c, qp, off));
        const float x1 = tc::score(fmaf(sc[j][2 * ri + 1], scale, bb.y), f.y,
                                   diag && tc::above(k0 + c + 1, qp, off));
        sc[j][2 * ri] = x0;
        sc[j][2 * ri + 1] = x1;
        mx[ri] = fmaxf(mx[ri], fmaxf(x0, x1));
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 1));
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 2));
      const float m_new = fmaxf(m_i[ri], mx[ri]);
      alpha[ri] = tc::exp_rel(m_i[ri], m_new);
      m_i[ri] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = tc::exp_rel(sc[j][e], m_i[e / 2]);
        sc[j][e] = p;
        rs[e / 2] += p;
      }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      rs[ri] += __shfl_xor_sync(0xffffffffu, rs[ri], 1);
      rs[ri] += __shfl_xor_sync(0xffffffffu, rs[ri], 2);
      l_i[ri] = l_i[ri] * alpha[ri] + rs[ri];
    }
    tc::add_tile<T, D, BK / 8>(o, sc, Vs(s), P, alpha);  // O = O * alpha + P V

    if (it + 1 < ntiles) {
      stash(it + 1);
      tc::cp_async_wait_all();
    }
    __syncthreads();  // this stage is consumed and the next one has landed
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int qp = q0 + rl[ri];
    if (qp >= n) continue;
    const float l = l_i[ri] == 0.f ? 1.f : l_i[ri];
    const float inv = 1.f / l;
    T* orow = out + ((size_t)bh * n + qp) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      tc::store2(orow + 8 * j + 2 * t, o[j][2 * ri] * inv, o[j][2 * ri + 1] * inv);
    if (t == 0) lse[(size_t)bh * n + qp] = m_i[ri] + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* tab,
                   const void* bias, const void* kmask, void* out, void* lse, int bh, int heads, int group,
                   int n, int m, float scale, int causal, cudaStream_t stream) {
  using S = Smem<T, D>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(S::base + S::dense));
  if (err != cudaSuccess) return err;
  const size_t smem = S::base + (bias != nullptr ? S::dense : 0);
  dim3 grid(bh, (n + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(tab), static_cast<const float*>(bias),
      static_cast<const int8_t*>(kmask),
      static_cast<T*>(out), static_cast<float*>(lse), heads, group, n, m, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, const void* tab,
                       const void* bias, const void* kmask, void* out, void* lse, int bh,
                       int heads, int group, int n, int m, float scale, int causal,
                       cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(q, k, v, tab, bias, kmask, out, lse, bh, heads, group, n, m,
                                  scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (bh, n, d); k, v (bh / group, m, d); tab (2n-1, heads) float32 or null;
// bias (heads, n, m) float32 or null, at most one of the two; kmask
// (bh / heads, m) int8 or null; out (bh, n, d) in q's type; lse (bh, n)
// float32. q, k, v 16-byte aligned. dtype 0 = float32, 1 = bfloat16.
// Returns a cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* tab,
                         const void* bias, const void* kmask, void* out, void* lse, int bh,
                         int heads, int group, int n, int m, int d, float scale, int causal,
                         int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tab != nullptr && bias != nullptr) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, tab, bias, kmask, out, lse, bh, heads, group, n, m,
                             scale, causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, tab, bias, kmask, out, lse, bh, heads, group,
                                     n, m, scale, causal, s);
  return cudaErrorInvalidValue;
}
