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
// peak, ~0.26 ms at the 67 TFLOP/s float32 peak without tensor cores (worked
// out from the shapes, not measured).
//
// Design. Right and simple first: one block of 256 threads per (b*h, 64-row
// query tile) loops over 64-key tiles held in shared memory as float32; the
// products run as float32 FMAs on the CUDA cores (no tensor cores yet), each
// thread owning a 4x4 patch of the 64x64 score tile and a 4x(D/16) patch of
// the output. The bias never exists as (H, N, N): each key tile loads the
// 127 table entries its deltas q-k cover. With an (H, N, M) bias (the Coarse
// and Fine LMs' materialised bias), each key tile loads its 64x64 float32
// block of bias[h] into the P tile's shared memory instead (each thread
// reads its own elements there before it overwrites them with p, so the
// tile costs no shared memory and no occupancy), one coalesced pass. At the
// Fine LM's training shape (B=4, H=8, N=M=1201) the bias is 46 MB, 14 us at
// 3.35 TB/s, against 88 us for the causal products at the float32 peak, so
// the kernel stays compute-bound; each batch row reads it again, mostly from
// the 50 MB L2 (worked out from the shapes, not measured).
// wgmma/TMA come later. Instantiated for D=64, the head dim of every model
// on the port's path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int NT = 256;         // threads: a 16x16 grid of (ty, tx)
constexpr int PITCH = BQ + 1;   // transposed tiles, padded against bank conflicts
constexpr float NEG = -1e30f;   // the TPU kernel's mask value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // Qs [D][PITCH], Ks [D][PITCH], Vs [BK][D], Ps [BK][PITCH], bias [BQ+BK-1], key flags [BK]
  return sizeof(float) * (2 * D * PITCH + BK * D + BK * PITCH + BQ + BK - 1 + BK);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ tab, const float* __restrict__ bias,
                 const int8_t* __restrict__ kmask,
                 T* __restrict__ out, float* __restrict__ lse, int heads, int group,
                 int n, int m, float scale, int causal) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // q^T * scale
  float* Ks = Qs + D * PITCH;       // k^T
  float* Vs = Ks + D * PITCH;       // v, row-major
  float* Ps = Vs + BK * D;          // p^T; before p, the (H, N, M) bias tile
  float* Bs = Ps + BK * PITCH;      // bias for deltas q0-k0-(BK-1) .. q0-k0+BQ-1
  float* Fs = Bs + BQ + BK - 1;     // key flags: 0 in range, NEG masked, -inf past m

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int h = bh % heads;
  const int b = bh / heads;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* qb = q + (size_t)bh * n * D;
  const T* kb = k + (size_t)(bh / group) * m * D;
  const T* vb = v + (size_t)(bh / group) * m * D;
  const float* biash = bias != nullptr ? bias + (size_t)h * n * m : nullptr;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    Qs[c * PITCH + r] = q0 + r < n ? to_f(qb[(size_t)(q0 + r) * D + c]) * scale : 0.f;
  }

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // causal (n == m): key k is seen by query q iff k <= q
  const int kv_end = causal ? min(m, q0 + BQ) : m;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps/Bs/Fs are consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < m;
      Ks[c * PITCH + r] = in ? to_f(kb[(size_t)(k0 + r) * D + c]) : 0.f;
      Vs[r * D + c] = in ? to_f(vb[(size_t)(k0 + r) * D + c]) : 0.f;
    }
    if (tab != nullptr) {
      for (int i = tid; i < BQ + BK - 1; i += NT) {
        const int idx = q0 - k0 - (BK - 1) + i + n - 1;
        Bs[i] = idx >= 0 && idx < 2 * n - 1 ? tab[(size_t)idx * heads + h] : 0.f;
      }
    }
    if (biash != nullptr) {
      for (int i = tid; i < BQ * BK; i += NT) {
        const int r = i / BK, c = i % BK;
        Ps[c * PITCH + r] = q0 + r < n && k0 + c < m ? biash[(size_t)(q0 + r) * m + k0 + c] : 0.f;
      }
    }
    for (int i = tid; i < BK; i += NT) {
      const int kp = k0 + i;
      Fs[i] = kp >= m ? -INFINITY
              : (kmask != nullptr && kmask[(size_t)b * m + kp] == 0) ? NEG : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[d * PITCH + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[d * PITCH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float x = s[i][j];
        if (tab != nullptr) x += Bs[r - c + BK - 1];
        else if (biash != nullptr) x += Ps[c * PITCH + r];  // this thread's own element
        const float f = Fs[c];
        if (f != 0.f) x = f;
        if (causal && k0 + c > q0 + r && f == 0.f) x = NEG;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(tx + 16 * j) * PITCH + r] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[j * PITCH + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[j * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= n) continue;
    const float l = l_i[i] == 0.f ? 1.f : l_i[i];
    const float inv = 1.f / l;
    T* o = out + ((size_t)bh * n + qp) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[tx + 16 * c] = from_f<T>(acc[i][c] * inv);
    if (tx == 0) lse[(size_t)bh * n + qp] = m_i[i] + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* tab,
                   const void* bias, const void* kmask, void* out, void* lse, int bh, int heads, int group,
                   int n, int m, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BQ - 1) / BQ, bh);
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
// float32. dtype 0 = float32, 1 = bfloat16. Returns a cudaError_t.
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
