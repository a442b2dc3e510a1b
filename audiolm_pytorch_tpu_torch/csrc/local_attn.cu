// Blocked causal local attention for Hopper (sm_90a): each query of window
// i attends the keys of windows i-1 and i at or before it, with an optional
// (H, w, 2w) float32 bias over (query in window, key in the two windows)
// and an optional (B, T) int8 key mask.
//
// Replaces the TPU kernel of the JAX package, ops/pallas/local_attention.py
// `_kernel` (launched by `_forward`, entry `local_attention_pallas`), and
// computes the function of the model's path, ops/attention.py
// `local_attention`: a disallowed (query, key) pair scores -1e9 before one
// softmax over all 2w key slots, window 0 looks back on zero keys and
// values that are always disallowed, and the keys past T (the padding to a
// multiple of w) are zero and disallowed. So a query whose every key is
// masked gets the mean of the 2w value slots, as there; the Pallas kernel
// instead looks back on window 0 itself in window 0 (`idx_prev`), which
// differs in that case only.
//
// What bounds it. At the codec's shape (8 clips of 2 s: B = 8, H = 8,
// T = 100 at 50 Hz, D = 64, w = 128, so one window) the attended pairs are
// B*H*T*(T+1)/2 = 323,200, and the two products 4*D operations each: 83
// MFLOP, 1.2 us at the 67 TFLOP/s float32 peak, against 3.3 MB of q, k, v
// and out, 1.0 us at 3.35 TB/s (worked out from the shapes, not measured).
// Either way a few microseconds: the launch and the grid's single wave set
// the time at this size.
//
// Design. Right and simple first, in the form of the flash forward of this
// package (csrc/flash_fwd.cu): one block of 256 threads per (b*h, 64-query
// tile), the tile's queries in shared memory as float32, scaled; the 2w key
// slots of its window (w in {64, 128}: 2 or 4 tiles of 64) loaded tile by
// tile with an online softmax in float32, each thread a 4x4 patch of the
// 64x64 score tile and a 4x(D/16) patch of the output; float32 FMAs on the
// CUDA cores (no tensor cores yet). Every tile takes all 2w slots, the
// causally disallowed ones included, so the fully masked rows come out as
// the model's path gives them; that costs 4/3 of the causal band's work.
// The bias tile is read into the P tile's shared memory, each thread
// reading its own elements before it overwrites them with p.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;             // queries per block
constexpr int BK = 64;             // key slots per tile
constexpr int NT = 256;            // threads: a 16x16 grid of (ty, tx)
constexpr int PITCH = BQ + 1;      // transposed tiles, padded against bank conflicts
constexpr float MASKED = -1e9f;    // the model path's score of a disallowed pair

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // Qs [D][PITCH], Ks [D][PITCH], Vs [BK][D], Ps [BK][PITCH], key flags [BK]
  return sizeof(float) * (2 * D * PITCH + BK * D + BK * PITCH + BK);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
local_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ bias, const int8_t* __restrict__ kmask,
                  T* __restrict__ out, int heads, int t, int w, float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // q^T * scale
  float* Ks = Qs + D * PITCH;  // k^T
  float* Vs = Ks + D * PITCH;  // v, row-major
  float* Ps = Vs + BK * D;     // p^T; before p, the bias tile
  float* Fs = Ps + BK * PITCH; // 1 where the key slot is a real, unmasked key

  const int bh = blockIdx.y;
  const int h = bh % heads, b = bh / heads;
  const int q0 = blockIdx.x * BQ;   // first query of the tile
  const int win = q0 / w;           // its window (w is a multiple of BQ)
  const int j0 = q0 - win * w;      // the tile's first query within the window
  const int kbase = win * w - w;    // position of key slot 0: window win - 1
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* qb = q + (size_t)bh * t * D;
  const T* kb = k + (size_t)bh * t * D;
  const T* vb = v + (size_t)bh * t * D;
  const float* biash = bias != nullptr ? bias + (size_t)h * w * 2 * w : nullptr;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    Qs[c * PITCH + r] = q0 + r < t ? to_f(qb[(size_t)(q0 + r) * D + c]) * scale : 0.f;
  }

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int s0 = 0; s0 < 2 * w; s0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps/Fs are consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const int kp = kbase + s0 + r;
      const bool in = kp >= 0 && kp < t;
      Ks[c * PITCH + r] = in ? to_f(kb[(size_t)kp * D + c]) : 0.f;
      Vs[r * D + c] = in ? to_f(vb[(size_t)kp * D + c]) : 0.f;
    }
    if (biash != nullptr) {
      for (int i = tid; i < BQ * BK; i += NT) {
        const int r = i / BK, c = i % BK;
        Ps[c * PITCH + r] = biash[(size_t)(j0 + r) * 2 * w + s0 + c];
      }
    }
    for (int i = tid; i < BK; i += NT) {
      const int kp = kbase + s0 + i;
      Fs[i] = kp >= 0 && kp < t && (kmask == nullptr || kmask[(size_t)b * t + kp] != 0)
                  ? 1.f : 0.f;
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
        if (biash != nullptr) x += Ps[c * PITCH + r];  // this thread's own element
        // slot s0 + c is window win - 1 + (s0 + c) / w; causal in the band
        const bool allowed = Fs[c] != 0.f && s0 + c <= j0 + r + w;
        x = allowed ? x : MASKED;
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
    }
    __syncthreads();  // every thread has read its bias elements
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(tx + 16 * j) * PITCH + ty + 16 * i] = s[i][j];
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
    if (qp >= t) continue;
    const float inv = 1.f / l_i[i];  // l >= 1: the row's largest score gives exp(0)
    T* o = out + ((size_t)bh * t + qp) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[tx + 16 * c] = from_f<T>(acc[i][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* kmask, void* out, int bh, int heads, int t, int w, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(local_attn_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((t + BQ - 1) / BQ, bh);
  local_attn_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const int8_t*>(kmask), static_cast<T*>(out),
      heads, t, w, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out (bh, t, d) in one type; bias (heads, w, 2w) float32 or null;
// kmask (bh / heads, t) int8 or null. w in {64, 128}, d = 64. dtype 0 =
// float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int local_attn_fwd(const void* q, const void* k, const void* v, const void* bias,
                              const void* kmask, void* out, int bh, int heads, int t, int d,
                              int w, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d != 64 || (w != 64 && w != 128) || t <= 0 || bh <= 0 || bh > 65535)
    return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float, 64>(q, k, v, bias, kmask, out, bh, heads, t, w, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 64>(q, k, v, bias, kmask, out, bh, heads, t, w, scale, s);
  return cudaErrorInvalidValue;
}
