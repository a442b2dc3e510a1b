// Flash-attention backward for Hopper (sm_90a): dq (K2), dk/dv (K3) and the
// gradient of the (2N-1, H) rel-pos distance table (K4). Each recomputes
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
// does 4 (34.4 GFLOP, 0.513 ms); worked out from the shapes, not measured.
// K4 is fused into K2, since it needs K2's dS tile and nothing else: it adds
// one add per attended pair (B*H*N*(N+1)/2) and the (2N-1, H) float32
// table's read-modify-write to K2's work, where alone it would redo 2 of
// K2's 3 products (17.2 GFLOP) to rebuild dS.
//
// Design. Right and simple first, as the forward: float32 FMAs on the CUDA
// cores, 256 threads as a 16x16 grid, each owning a 4x4 patch of a 64x64
// tile; tiles in shared memory transposed and padded against bank conflicts.
//   K2: one block per (b*h, 64-row query tile), heaviest tiles first; it loops
//       over the key tiles up to the diagonal and keeps dq in registers.
//   K4, inside K2 when the table's gradient is asked for: each key tile's dS,
//       already in shared memory for dq, is summed along its 127 diagonals,
//       then added with one atomicAdd per diagonal per tile into a float32
//       (2N-1, H) buffer the wrapper zeroes (the batch sum among them, in an
//       order that changes from run to run).
//   K3: one block per (b*hk, 64-key tile); it loops over the query heads of
//       its kv head and the query tiles from the diagonal on, with dk and dv
//       in registers, so the MQA sum needs no atomics. This replaces the
//       TPU's sequential (head, q-block) grid axis.
// The (H, N, N) bias and its gradient never exist in device memory: a tile
// loads the 127 table entries its deltas cover. Tensor cores, TMA and wgmma
// are later work. Instantiated for D=64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NT = 256;         // threads: a 16x16 grid of (ty, tx)
constexpr int PITCH = BQ + 1;   // transposed tiles, padded against bank conflicts
constexpr int ND = BQ + BK - 1; // deltas a tile covers
constexpr float NEG = -1e30f;   // the TPU kernel's mask value
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
  for (int i = threadIdx.x; i < ND; i += NT) {
    const int idx = q0 - k0 - (BK - 1) + i + n - 1;
    Bs[i] = idx >= 0 && idx < 2 * n - 1 ? tab[(size_t)idx * heads + h] : 0.f;
  }
}

// key flags: 0 attend, NEG masked, -inf past m
__device__ __forceinline__ void load_flags(float* Fs, const int8_t* kmask, int b, int k0, int m) {
  for (int i = threadIdx.x; i < BK; i += NT) {
    const int kp = k0 + i;
    Fs[i] = kp >= m ? -INFINITY : (kmask != nullptr && kmask[(size_t)b * m + kp] == 0) ? NEG : 0.f;
  }
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
  float x = s + bias;
  if (flag != 0.f) x = flag;
  else if (above) x = NEG;
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
                      const int8_t* __restrict__ kmask, T* __restrict__ dq,
                      float* __restrict__ dtab, int heads, int group, int n, int m,
                      float scale, int causal) {
  constexpr int DC = D / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // (scale q)^T
  float* Gs = Qs + D * PITCH;    // dO^T
  float* Ks = Gs + D * PITCH;    // k^T
  float* Vs = Ks + D * PITCH;    // v^T
  float* Ss = Vs + D * PITCH;    // dS^T: Ss[c * PITCH + r]
  float* Bs = Ss + BK * PITCH;
  float* Fs = Bs + ND;
  float* Ls = Fs + BK;
  float* Dl = Ls + BQ;

  const int bh = blockIdx.y;
  const int h = bh % heads, b = bh / heads;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal rows first
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
        p_ds(s[i][j], dp[i][j], tab != nullptr ? Bs[r - c + BK - 1] : 0.f, Fs[c],
             causal && k0 + c > q0 + r, Ls[r], Dl[r], p, ds);
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

template <int D>
constexpr size_t smem_dkv() {
  // Ks, Vs, Qs, Gs [D][PITCH]; P, dS [BQ][PITCH]; bias [ND]; flags [BK]; lse, Delta [BQ]
  return sizeof(float) * (4 * D * PITCH + 2 * BQ * PITCH + ND + BK + 2 * BQ);
}

// K3. One block per (b*hk, key tile); rows r of a thread are keys, columns c queries.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ g, const float* __restrict__ lse,
                     const float* __restrict__ delta, const float* __restrict__ tab,
                     const int8_t* __restrict__ kmask, T* __restrict__ dk, T* __restrict__ dv,
                     int heads, int hk, int n, int m, float scale, int causal) {
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;              // k^T
  float* Vs = Ks + D * PITCH;    // v^T
  float* Qs = Vs + D * PITCH;    // (scale q)^T
  float* Gs = Qs + D * PITCH;    // dO^T
  float* Ps = Gs + D * PITCH;    // P: Ps[c * PITCH + r], c query, r key
  float* Ss = Ps + BQ * PITCH;   // dS, the same layout
  float* Bs = Ss + BQ * PITCH;
  float* Fs = Bs + ND;
  float* Ls = Fs + BK;
  float* Dl = Ls + BQ;

  const int kvh = blockIdx.y;  // b * hk + kv head
  const int b = kvh / hk, kh = kvh % hk, group = heads / hk;
  const int k0 = blockIdx.x * BK;  // the longest causal loops first
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  load_t<T, D>(Ks, k + (size_t)kvh * m * D, k0, m, 1.f);
  load_t<T, D>(Vs, v + (size_t)kvh * m * D, k0, m, 1.f);
  load_flags(Fs, kmask, b, k0, m);

  float ak[4][DC], av[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) ak[i][c] = av[i][c] = 0.f;

  const int q_start = causal ? k0 : 0;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kh * group + hh;
    const int bh = b * heads + h;
    for (int q0 = q_start; q0 < n; q0 += BQ) {
      __syncthreads();  // the previous tile is consumed
      load_t<T, D>(Qs, q + (size_t)bh * n * D, q0, n, scale);
      load_t<T, D>(Gs, g + (size_t)bh * n * D, q0, n, 1.f);
      load_rows(Ls, Dl, lse + (size_t)bh * n, delta + (size_t)bh * n, q0, n);
      if (tab != nullptr) load_bias(Bs, tab, q0, k0, n, h, heads);
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[4], av_[4], bq[4], bg[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = Ks[d * PITCH + ty + 16 * i];
          av_[i] = Vs[d * PITCH + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bq[j] = Qs[d * PITCH + tx + 16 * j];
          bg[j] = Gs[d * PITCH + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i], bq[j], s[i][j]);
            dp[i][j] = fmaf(av_[i], bg[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;  // key
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;  // query
          float p, ds;
          p_ds(s[i][j], dp[i][j], tab != nullptr ? Bs[c - r + BK - 1] : 0.f, Fs[r],
               causal && k0 + r > q0 + c, Ls[c], Dl[c], p, ds);
          Ps[c * PITCH + r] = p;
          Ss[c * PITCH + r] = ds;
        }
      }
      __syncthreads();

      // dv[r][col] += sum_c P[c][r] dO[c][col]; dk[r][col] += sum_c dS[c][r] (scale q)[c][col]
#pragma unroll 2
      for (int c = 0; c < BQ; ++c) {
        float pr[4], sr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = Ps[c * PITCH + ty + 16 * i];
          sr[i] = Ss[c * PITCH + ty + 16 * i];
        }
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) {
          const float gg = Gs[(tx + 16 * cc) * PITCH + c];
          const float qq = Qs[(tx + 16 * cc) * PITCH + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            av[i][cc] = fmaf(pr[i], gg, av[i][cc]);
            ak[i][cc] = fmaf(sr[i], qq, ak[i][cc]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= m) continue;
    T* ok = dk + ((size_t)kvh * m + kp) * D;
    T* ov = dv + ((size_t)kvh * m + kp) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      ok[tx + 16 * cc] = from_f<T>(ak[i][cc]);
      ov[tx + 16 * cc] = from_f<T>(av[i][cc]);
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void *q, *k, *v, *g, *lse, *delta, *tab, *kmask;
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
      static_cast<const int8_t*>(a.kmask), static_cast<T*>(dq), static_cast<float*>(dtab),
      a.heads, a.heads / a.hk, a.n, a.m, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  constexpr size_t smem = smem_dkv<D>();
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.m + BK - 1) / BK, a.b * a.hk);
  kernel<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.tab),
      static_cast<const int8_t*>(a.kmask), static_cast<T*>(dk), static_cast<T*>(dv),
      a.heads, a.hk, a.n, a.m, a.scale, a.causal);
  return cudaGetLastError();
}

// which: 0 dq (and dtab in o2 when not null), 1 dk/dv
template <typename T>
cudaError_t dispatch(int which, int d, const Args& a, void* o1, void* o2) {
  if (d != 64) return cudaErrorInvalidValue;
  if (which == 1) return launch_dkv<T, 64>(a, o1, o2);
  if (o2 != nullptr && (a.tab == nullptr || a.n != a.m)) return cudaErrorInvalidValue;
  return launch_dq<T, 64>(a, o1, o2);
}

int run(int which, const void* q, const void* k, const void* v, const void* g,
        const void* lse, const void* delta, const void* tab, const void* kmask, void* o1,
        void* o2, int b, int heads, int hk, int n, int m, int d, float scale, int causal,
        int dtype, void* stream) {
  const Args a{q, k, v, g, lse, delta, tab, kmask, b, heads, hk, n, m, scale, causal,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(which, d, a, o1, o2);
  if (dtype == 1) return dispatch<__nv_bfloat16>(which, d, a, o1, o2);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, g (b*heads, n, d); k, v (b*hk, m, d), in one dtype (0 float32, 1
// bfloat16); lse, delta (b*heads, n) float32; tab (2n-1, heads) float32 or
// null; kmask (b, m) int8 or null. Each returns a cudaError_t.

// dq (b*heads, n, d) in q's dtype; with dtab not null also the table's
// gradient, dtab (2n-1, heads) float32, zeroed by the caller (needs tab and n == m)
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                            const void* lse, const void* delta, const void* tab,
                            const void* kmask, void* dq, void* dtab, int b, int heads, int hk,
                            int n, int m, int d, float scale, int causal, int dtype,
                            void* stream) {
  return run(0, q, k, v, g, lse, delta, tab, kmask, dq, dtab, b, heads, hk, n, m, d, scale,
             causal, dtype, stream);
}

// dk, dv (b*hk, m, d) in k's dtype
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                             const void* lse, const void* delta, const void* tab,
                             const void* kmask, void* dk, void* dv, int b, int heads, int hk,
                             int n, int m, int d, float scale, int causal, int dtype,
                             void* stream) {
  return run(1, q, k, v, g, lse, delta, tab, kmask, dk, dv, b, heads, hk, n, m, d, scale,
             causal, dtype, stream);
}
