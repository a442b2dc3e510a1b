// Blocked causal local attention for Hopper (sm_90a): each query of window
// i (of any width w >= 1) attends the keys of windows i-1 and i at or before
// it, with an optional (H, w, 2w) float32 bias over (query in window, key in
// the two windows) and an optional (B, T) int8 key mask.
//
// Replaces the TPU kernel of the JAX package, ops/pallas/local_attention.py
// `_kernel` (launched by `_forward`, entry `local_attention_pallas`), and
// computes the function of the model's path, ops/attention.py
// `local_attention`: a disallowed (query, key) pair scores -1e9 (the bias is
// added before the mask, so a disallowed pair scores -1e9 whatever its bias)
// before one softmax over all 2w key slots, window 0 looks back on zero keys
// and values that are always disallowed, and the keys past T (the padding to
// a multiple of w) are zero and disallowed. So a query whose every key is
// masked gets the mean of the 2w value slots, as there; the Pallas kernel
// instead looks back on window 0 itself in window 0 (`idx_prev`), which
// differs in that case only.
//
// What bounds it. At the codec's shape (8 clips of 2 s: B = 8, H = 8,
// T = 100 at 50 Hz, D = 64, w = 128, so one window) the attended pairs are
// B*H*T*(T+1)/2 = 323,200, and the two products 4*D operations each: 83
// MFLOP, 0.5 us as 3xTF32 (three TF32 products at 495 TFLOP/s), 0.08 us in
// bf16, against 3.3 MB of q, k, v and out in float32, 1.0 us at 3.35 TB/s:
// bound by the bytes, and at this size the launch and the grid's single wave
// set the time (worked out from the shapes). At 10 s (T = 500, 4 windows)
// the pairs are 16x as many. The earlier design took the products as float32
// FMAs on the CUDA cores (bf16 too), over all 2w slots in every block, and
// its wrapper copied q, k and v to contiguous memory on every call.
//
// Design: the flash forward of this package (csrc/flash_fwd.cu, K1) with
// K7's masking rule, on the tensor cores through csrc/mma.cuh (bf16
// m16n8k16; float32 as 3xTF32 on m16n8k8). One block of 4 warps per (b*h,
// 64-query tile), on a one-dimensional grid (any T and B*H), each warp 16
// query rows whose Q fragments stay in registers; the 64-key tiles double-
// buffered by cp.async (K, V and the bias's 64x64 block), S = Q K^T and O +=
// P V as mma products with the online softmax on the accumulators (each
// tile's P V from zero and added in float32, exp as 2^((x - m) log2 e),
// exactly 1 at x = m). The tile walk is in absolute key positions: query
// tile [q0, q0 + 63] visits the keys from max(0, (floor(q0 / w) - 1) w) up
// to min(q0 + 63, T - 1), 64 at a time, and each row decides by its own
// window which of them it may see. Only those live key tiles are visited:
// the keys outside that range are no row's (window 0's look-back, keys past
// the tile's last query or at or past T), and a disallowed slot contributes
// exp(-1e9 - m) = 0 in float32 to every row that has an allowed key, so
// skipping them is exact; at the codec's 2 s shape (w = 128) that skips 5
// of every 8 (block, tile) steps, at 10 s 8 of 32. Two forms of the block
// (ALIGNED): where w is a multiple of 64 a query tile lies in one window,
// every visited key is at or past its look-back's first, and the bias
// arrives as one 64 x 64 block of that window's (w, 2w) table; otherwise a
// tile spans several windows (w < 64) or starts inside one, a row also
// tests the first key of its own look-back, and each row of the bias block
// is copied from its own window's row, 4 bytes at a time. A row with no
// allowed key at all (its running maximum is -1e9) gets the model path's
// answer explicitly: the mean of its own window's 2w value slots, zeros for
// window -1 and the padding, from the sums of the w-key windows the tile's
// rows meet, computed only in a block that holds such a row. q, k, v and out
// are read and written through their (batch, head, time) strides, so the
// codec's transposed (B, N, H, D) views need no copy.
// Instantiated for D = 32, 64 and 128 (the wrapper zero-pads any other D up
// to 128 into the next of them); in float32 at D = 128 Q's 3xTF32 fragments
// (128 registers a thread) would not fit beside O's, so Q stays in a tile of
// its own in shared memory and is read at each k-step, and O += P V runs 64
// columns at a time. Over D = 128 the column-sliced form
// (local_attn_wide_kernel) takes every D that is a multiple of 64 (any other
// D zero-padded to the next one): in float32 at D = 256 two stages of K and
// V tiles and Q's would take ~330 KB. A block owns one 64-wide slice of the
// output, S = Q K^T is summed over the depth 64 columns at a time (Q's and
// K's chunks streamed by cp.async through a ring of two stages, then V's
// slice; csrc/mma.cuh's tc::Wide), each row reads its key flag and bias
// element from device memory, and the keyless rows' window sums are taken in
// the slice's columns (65 windows x 64 floats fit the ring). Each slice
// recomputes S: D / 64 times the products of one pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int BQ = 64;             // queries per block
constexpr int BK = 64;             // key slots per tile
constexpr int NT = 128;            // 4 warps of 16 query rows
constexpr int TPITCH = BK + 8;     // the bias block's pitch: float2 reads without conflicts
constexpr float MASKED = -1e9f;    // the model path's score of a disallowed pair
constexpr int MAX_WINDOWS = BQ + 1;  // the w-key windows a tile's rows meet: at most 65 (w = 1)

// element strides of a (B, H, T, D) tensor whose last dimension is contiguous
struct Strides {
  long long b, h, t;
};

// Shared memory: two stages of (K tile, V tile, key flags [BK]), Q's tile
// where it stays in shared memory (QS), then with a bias two of its 64x64
// blocks. Otherwise Q is staged, before the loop, in stage 1's K tile and
// read into registers; after the loop the stages hold the sums of the
// windows' values for the rows without a key.
template <typename T, int D>
struct Smem {
  static constexpr int P = tc::pitch<T, D>();
  static constexpr bool QS = sizeof(T) == 4 && D > 64;
  static constexpr size_t tile = (size_t)BK * P * sizeof(T);
  static constexpr size_t stage = 2 * tile + BK * sizeof(float);
  static constexpr size_t base = 2 * stage + (QS ? tile : 0);
  static constexpr size_t dense = 2 * (size_t)BQ * TPITCH * sizeof(float);
  static_assert(tile % 16 == 0 && stage % 16 == 0, "16-byte aligned regions");
  static_assert(MAX_WINDOWS * D * sizeof(float) <= 2 * stage, "the windows' sums fit");
  static_assert(base + dense <= 232448, "a block's shared memory");
};

// Q's A operand: fragments in registers, or its tile in shared memory
template <typename T, int D, bool SMEM> struct QFrags { using type = tc::ARegs<T, D>; };
template <typename T, int D> struct QFrags<T, D, true> { using type = tc::ASmem<T>; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// The bias block of the key tile at kp0 where the tile's rows may lie in
// several windows: row r (query q0 + r of window i = (q0 + r) / w) takes
// bias[h, q0 + r - i w, kp0 - (i - 1) w + c], c = 0..63, zeros outside the
// row's 2w slots, by cp.async of 4 bytes. Thread x copies column x % 64 of
// rows x / 64, + 2, ...; it walks its rows' windows by steps of 2 queries.
__device__ __forceinline__ void cp_bias_rows(float* dst, const float* biash, int q0, int kp0,
                                             int w) {
  constexpr int STEP = NT / BK;  // rows apart
  const int c = threadIdx.x % BK, r1 = threadIdx.x / BK;
  int win = (q0 + r1) / w, j = q0 + r1 - win * w;  // the row's window and place in it
  for (int r = r1; r < BQ; r += STEP) {
    const int col = kp0 - (win - 1) * w + c;
    const bool in = col >= 0 && col < 2 * w;
    tc::cp_async4(dst + r * TPITCH + c, in ? biash + (size_t)j * 2 * w + col : biash, in);
    j += STEP;
    while (j >= w) {
      j -= w;
      ++win;
    }
  }
}

// ALIGNED: w is a multiple of BQ (see the note at the top)
template <typename T, int D, bool ALIGNED>
__global__ void __launch_bounds__(NT)
local_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ bias, const int8_t* __restrict__ kmask,
                  T* __restrict__ out, Strides sq, Strides sk, Strides sv, Strides so,
                  int bh_count, int heads, int t, int w, float scale) {
  using S = Smem<T, D>;
  constexpr int P = S::P;
  extern __shared__ __align__(16) unsigned char smem[];
  auto Ks = [&](int s) { return reinterpret_cast<T*>(smem + s * S::stage); };
  auto Vs = [&](int s) { return reinterpret_cast<T*>(smem + s * S::stage + S::tile); };
  auto Fs = [&](int s) {  // 0 where the slot holds a real, unmasked key
    return reinterpret_cast<float*>(smem + s * S::stage + 2 * S::tile);
  };
  auto Ts = [&](int s) { return reinterpret_cast<float*>(smem + S::base) + s * BQ * TPITCH; };

  // one-dimensional grid: the (b*h)s of a query tile run together
  const int bh = blockIdx.x % bh_count, h = bh % heads, b = bh / heads;
  const int q0 = blockIdx.x / bh_count * BQ;  // first query of the tile
  const int win0 = q0 / w;                    // its first row's window
  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4, t4 = tid % 4;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* biash = bias != nullptr ? bias + (size_t)h * w * 2 * w : nullptr;

  // the live keys: from the first row's look-back (none before key 0) to the
  // tile's last query (none at or past key T)
  const int k_lo = max(0, (win0 - 1) * w);
  const int k_hi = min(q0 + BQ - 1, t - 1);
  const int ntiles = (k_hi - k_lo) / BK + 1;  // k_hi >= k_lo: q0 < t

  // tile `it` (keys k_lo + BK it ...) into stage it & 1: K, V and the bias
  // block by cp.async (one group); this thread's key flag into a register,
  // which `stash` stores once this tile's compute has hidden its latency
  float flag_r = 0.f;
  auto issue = [&](int it) {
    const int kp0 = k_lo + it * BK, s = it & 1;
    tc::cp_tile<T, D, BK, NT>(Ks(s), P, kb, kp0, t, sk.t);
    tc::cp_tile<T, D, BK, NT>(Vs(s), P, vb, kp0, t, sv.t);
    if (biash != nullptr) {
      if constexpr (ALIGNED)  // one window: rows j0 .., slots kp0 - (win0 - 1) w ..
        tc::cp_block_f32<BQ, BK, NT>(Ts(s), TPITCH, biash, q0 - win0 * w, kp0 - (win0 - 1) * w,
                                     w, 2 * w);
      else
        cp_bias_rows(Ts(s), biash, q0, kp0, w);
    }
    tc::cp_async_commit();
    if (tid < BK) {
      const int kp = kp0 + tid;
      flag_r = kp < t && (kmask == nullptr || kmask[(size_t)b * t + kp] != 0) ? 0.f : 1.f;
    }
  };
  auto stash = [&](int it) {
    if (tid < BK) Fs(it & 1)[tid] = flag_r;
  };

  // Q (in stage 1's K tile, or its own) with tile 0, then Q's fragments
  // into registers
  T* qt = S::QS ? reinterpret_cast<T*>(smem + 2 * S::stage) : Ks(1);
  tc::cp_tile<T, D, BQ, NT>(qt, P, qb, q0, t, sq.t);
  issue(0);
  stash(0);
  tc::cp_async_wait_all();
  __syncthreads();
  typename QFrags<T, D, S::QS>::type qf;
  if constexpr (S::QS) {
    qf.s = qt + warp * 16 * P;
    qf.pitch = P;
  } else {
    qf.load(qt + warp * 16 * P, P);
  }
  __syncthreads();  // stage 1 is free for tile 1

  const int rl[2] = {warp * 16 + g, warp * 16 + g + 8};  // this thread's rows in the tile
  // each row's window, and the first key of its look-back (ALIGNED: at or
  // before k_lo, so never tested)
  int rwin[2], rfirst[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    rwin[ri] = (q0 + rl[ri]) / w;
    rfirst[ri] = (rwin[ri] - 1) * w;
  }
  float m_i[2] = {tc::NEG, tc::NEG}, l_i[2] = {0.f, 0.f};
  float o[D / 8][4];
  tc::zero(o);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it & 1, kp0 = k_lo + it * BK;
    if (it + 1 < ntiles) issue(it + 1);

    float sc[BK / 8][4];
    tc::zero(sc);
    tc::gemm_nk<T, D, BK / 8>(sc, qf, Ks(s), P);

    const float* fs = Fs(s);
    const float* ts = Ts(s);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      const float2 f = *reinterpret_cast<const float2*>(fs + c);
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        float2 bb = make_float2(0.f, 0.f);
        if (biash != nullptr) bb = *reinterpret_cast<const float2*>(ts + rl[ri] * TPITCH + c);
        // key kp0 + c is allowed for query q0 + r iff it is at or before the
        // query and at or after its look-back's first key
        const int last = q0 + rl[ri] - kp0, first = rfirst[ri] - kp0;
        bool ok0 = f.x == 0.f && c <= last, ok1 = f.y == 0.f && c + 1 <= last;
        if constexpr (!ALIGNED) {
          ok0 = ok0 && c >= first;
          ok1 = ok1 && c + 1 >= first;
        }
        const float x0 = ok0 ? fmaf(sc[j][2 * ri], scale, bb.x) : MASKED;
        const float x1 = ok1 ? fmaf(sc[j][2 * ri + 1], scale, bb.y) : MASKED;
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

  // rows with no allowed key (every score they saw was -1e9) take the mean
  // of their window's 2w value slots, as the model path's softmax over -1e9
  // everywhere: wsum[i] holds the sum of the values of window wl + i (keys
  // (wl + i) w .. + w - 1 inside [0, T)), wl the first row's look-back
  bool empty[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) empty[ri] = q0 + rl[ri] < t && !(m_i[ri] > MASKED);
  float* wsum = reinterpret_cast<float*>(smem);  // the stages: [windows][D]
  const int wl = win0 - 1;
  if (__syncthreads_or(empty[0] || empty[1])) {
    const int nwin = k_hi / w - wl + 1;
    for (int i = tid; i < nwin * D; i += NT) {
      const int col = i % D, wi = i / D;
      float sum = 0.f;
      for (int kp = max(0, (wl + wi) * w); kp < min((wl + wi + 1) * w, t); ++kp)
        sum += to_f(vb[kp * sv.t + col]);
      wsum[wi * D + col] = sum;
    }
    __syncthreads();
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int qp = q0 + rl[ri];
    if (qp >= t) continue;
    const float inv = 1.f / l_i[ri];  // l >= 1: the row's largest score gives exp(0)
    T* orow = out + b * so.b + h * so.h + qp * so.t;
    const float* prev = wsum + (rwin[ri] - 1 - wl) * D;  // its look-back's sums, then its own
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      if (empty[ri])
        tc::store2(orow + c, (prev[c] + prev[D + c]) / (2 * w),
                   (prev[c + 1] + prev[D + c + 1]) / (2 * w));
      else tc::store2(orow + c, o[j][2 * ri] * inv, o[j][2 * ri + 1] * inv);
    }
  }
}

template <typename T, int D, bool ALIGNED>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* kmask, void* out, const Strides (&st)[4], int bh, int heads,
                   int t, int w, float scale, cudaStream_t stream) {
  using S = Smem<T, D>;
  auto kernel = local_attn_kernel<T, D, ALIGNED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(S::base + S::dense));
  if (err != cudaSuccess) return err;
  const size_t smem = S::base + (bias != nullptr ? S::dense : 0);
  const long long blocks = (long long)bh * ((t + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;  // the grid's x limit, 2^31 - 1
  kernel<<<(unsigned)blocks, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const int8_t*>(kmask), static_cast<T*>(out),
      st[0], st[1], st[2], st[3], bh, heads, t, w, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_form(const void* q, const void* k, const void* v, const void* bias,
                        const void* kmask, void* out, const Strides (&st)[4], int bh, int heads,
                        int t, int w, float scale, cudaStream_t stream) {
#ifdef LOCAL_ATTN_ANY_WINDOW_BLOCK  // a timing variant: the any-window block at every window
  return launch<T, D, false>(q, k, v, bias, kmask, out, st, bh, heads, t, w, scale, stream);
#else
  return w % BQ == 0
             ? launch<T, D, true>(q, k, v, bias, kmask, out, st, bh, heads, t, w, scale, stream)
             : launch<T, D, false>(q, k, v, bias, kmask, out, st, bh, heads, t, w, scale, stream);
#endif
}

// ---- Head dims over 128: the column-sliced form (see the note at the top) ----
//
// One block per (b*h, output slice, 64-query tile), kv heads fastest, of 4
// warps. Its ring items, a key tile's D / 64 + 1 of them: the chunks of
// (Q, K) for S = Q K^T, then V's slice for O += P V, through csrc/mma.cuh's
// column-sliced tiles (tc::Wide). K7's rule as above, for any window: each
// row tests its own window's first key (where w is a multiple of 64 that
// test always passes), and reads its bias element and key flag from device
// memory. A row with no allowed key takes the mean of its window's value
// slots in its slice's columns, from the sums of those columns.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
local_attn_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ bias, const int8_t* __restrict__ kmask,
                       T* __restrict__ out, Strides sq, Strides sk, Strides sv, Strides so,
                       int bh_count, int heads, int t, int w, int d, float scale) {
  using W = tc::Wide<T>;
  constexpr int P = W::P, WC = tc::WC;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  auto X = [&](int s) { return reinterpret_cast<T*>(wide_smem + s * W::STAGE); };
  auto Y = [&](int s) { return reinterpret_cast<T*>(wide_smem + s * W::STAGE + W::TILE); };
  const int nch = d / WC;  // chunks of the depth, and slices of the output
  const int bh = blockIdx.x % bh_count, slice = blockIdx.x / bh_count % nch;
  const int h = bh % heads, b = bh / heads;
  const int q0 = blockIdx.x / bh_count / nch * BQ;  // first query of the tile
  const int win0 = q0 / w;
  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4, t4 = tid % 4;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* biash = bias != nullptr ? bias + (size_t)h * w * 2 * w : nullptr;
  const int k_lo = max(0, (win0 - 1) * w);
  const int k_hi = min(q0 + BQ - 1, t - 1);
  const int ntiles = (k_hi - k_lo) / BK + 1;  // k_hi >= k_lo: q0 < t
  const int per = nch + 1, nitems = per * ntiles;
  auto issue = [&](int i) {
    const int s = i & 1, c = i % per, kp0 = k_lo + i / per * BK;
    if (c < nch) {
      tc::cp_chunk<T, NT>(X(s), qb, q0, t, c * WC, sq.t);
      tc::cp_chunk<T, NT>(Y(s), kb, kp0, t, c * WC, sk.t);
    } else {
      tc::cp_chunk<T, NT>(X(s), vb, kp0, t, slice * WC, sv.t);
    }
    tc::cp_async_commit();
  };

  const int rl[2] = {warp * 16 + g, warp * 16 + g + 8};  // this thread's rows in the tile
  int rwin[2], rfirst[2];  // each row's window, and the first key of its look-back
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    rwin[ri] = (q0 + rl[ri]) / w;
    rfirst[ri] = (rwin[ri] - 1) * w;
  }
  float m_i[2] = {tc::NEG, tc::NEG}, l_i[2] = {0.f, 0.f};
  float o[8][4], sc[8][4];
  tc::zero(o);
  tc::zero(sc);
  issue(0);
  for (int i = 0; i < nitems; ++i) {
    tc::cp_async_wait_all();
    __syncthreads();  // item i has landed; every warp is done with item i - 1's stage
    if (i + 1 < nitems) issue(i + 1);
    const int s = i & 1, c = i % per, kp0 = k_lo + i / per * BK;
    if (c == 0) tc::zero(sc);
    if (c < nch) {
      tc::chunk_nk<T>(sc, X(s), Y(s));
      continue;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e / 2, kp = kp0 + 8 * j + 2 * t4 + (e & 1), qp = q0 + rl[ri];
        // key kp is allowed for query qp iff it is a real, unmasked key at or
        // before the query and at or after its look-back's first key
        const bool ok = kp < t && (kmask == nullptr || kmask[(size_t)b * t + kp] != 0)
                        && kp <= qp && kp >= rfirst[ri];
        float bb = 0.f;
        if (ok && biash != nullptr)
          bb = biash[(size_t)(qp - rwin[ri] * w) * 2 * w + kp - rfirst[ri]];
        const float x = ok ? fmaf(sc[j][e], scale, bb) : MASKED;
        sc[j][e] = x;
        mx[ri] = fmaxf(mx[ri], x);
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
    for (int j = 0; j < 8; ++j)
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
    tc::add_tile<T, WC, 8>(o, sc, X(s), P, alpha);  // O = O * alpha + P V (the slice)
  }

  // rows with no allowed key: the mean of their window's 2w value slots in
  // this slice's columns (wsum[i]: window wl + i's sums, in the ring)
  bool empty[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) empty[ri] = q0 + rl[ri] < t && !(m_i[ri] > MASKED);
  float* wsum = reinterpret_cast<float*>(wide_smem);  // [windows][WC]
  const int wl = win0 - 1;
  if (__syncthreads_or(empty[0] || empty[1])) {
    const int nwin = k_hi / w - wl + 1;
    for (int i = tid; i < nwin * WC; i += NT) {
      const int col = slice * WC + i % WC, wi = i / WC;
      float sum = 0.f;
      for (int kp = max(0, (wl + wi) * w); kp < min((wl + wi + 1) * w, t); ++kp)
        sum += to_f(vb[kp * sv.t + col]);
      wsum[i] = sum;
    }
    __syncthreads();
  }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int qp = q0 + rl[ri];
    if (qp >= t) continue;
    const float inv = 1.f / l_i[ri];
    T* orow = out + b * so.b + h * so.h + qp * so.t + slice * WC;
    const float* prev = wsum + (rwin[ri] - 1 - wl) * WC;  // its look-back's sums, then its own
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t4;
      if (empty[ri])
        tc::store2(orow + c, (prev[c] + prev[WC + c]) / (2 * w),
                   (prev[c + 1] + prev[WC + c + 1]) / (2 * w));
      else tc::store2(orow + c, o[j][2 * ri] * inv, o[j][2 * ri + 1] * inv);
    }
  }
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* bias,
                        const void* kmask, void* out, const Strides (&st)[4], int bh, int heads,
                        int t, int w, int d, float scale, cudaStream_t stream) {
  using W = tc::Wide<T>;
  static_assert(MAX_WINDOWS * tc::WC * sizeof(float) <= W::RING, "the windows' sums fit");
  auto kernel = local_attn_wide_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)W::RING);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)bh * (d / tc::WC) * ((t + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;  // the grid's x limit, 2^31 - 1
  kernel<<<(unsigned)blocks, NT, W::RING, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const int8_t*>(kmask), static_cast<T*>(out),
      st[0], st[1], st[2], st[3], bh, heads, t, w, d, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out (bh / heads, heads, t, d) in one type, each with element
// strides (batch, head, time) in `strides` (q's three, then k's, v's and
// out's), the last dimension contiguous, rows 16-byte aligned; bias (heads,
// w, 2w) float32 or null; kmask (bh / heads, t) int8 or null. Any window
// w >= 1 and any t >= 1, d in {32, 64, 128} or over 128 a multiple of 64.
// dtype 0 = float32, 1 =
// bfloat16. Returns a cudaError_t.
extern "C" int local_attn_fwd(const void* q, const void* k, const void* v, const void* bias,
                              const void* kmask, void* out, const long long* strides, int bh,
                              int heads, int t, int d, int w, float scale, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w <= 0 || t <= 0 || bh <= 0 || heads <= 0 || bh % heads) return cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  if (d > 128 && d % tc::WC == 0)  // the column-sliced form
    return dtype == 0 ? launch_wide<float>(q, k, v, bias, kmask, out, st, bh, heads, t, w, d,
                                           scale, s)
         : dtype == 1 ? launch_wide<__nv_bfloat16>(q, k, v, bias, kmask, out, st, bh, heads, t,
                                                   w, d, scale, s)
                      : cudaErrorInvalidValue;
  switch (d * 2 + dtype) {
    case 64: return launch_form<float, 32>(q, k, v, bias, kmask, out, st, bh, heads, t, w, scale, s);
    case 65:
      return launch_form<__nv_bfloat16, 32>(q, k, v, bias, kmask, out, st, bh, heads, t, w,
                                            scale, s);
    case 128:
      return launch_form<float, 64>(q, k, v, bias, kmask, out, st, bh, heads, t, w, scale, s);
    case 129:
      return launch_form<__nv_bfloat16, 64>(q, k, v, bias, kmask, out, st, bh, heads, t, w,
                                            scale, s);
    case 256:
      return launch_form<float, 128>(q, k, v, bias, kmask, out, st, bh, heads, t, w, scale, s);
    case 257:
      return launch_form<__nv_bfloat16, 128>(q, k, v, bias, kmask, out, st, bh, heads, t, w,
                                             scale, s);
  }
  return cudaErrorInvalidValue;
}
