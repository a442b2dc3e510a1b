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
// 2*N*C*D = 0.84 GFLOP, 12.5 us at the 67 TFLOP/s float32 peak without
// tensor cores, against 3.7 MB of inputs, 1.1 us at 3.35 TB/s: bound by the
// operations (worked out from the shapes, not measured).
//
// Design. Right and simple first. A 64-row tile of X against 64-code tiles
// of E, staged through shared memory 32 dimensions at a time as float32;
// 256 threads, each a 4x4 patch of the score tile, float32 FMAs on the CUDA
// cores (no tensor cores yet). Each thread keeps a running (score, index)
// per row over its codes in increasing order, so a strict < keeps the first
// of equal scores; the 16 threads of a row reduce it by shuffles, comparing
// (score, index) pairs. With 13 row tiles at N = 800 one block per row tile
// would leave 119 of 132 SMs idle, so C is split across the grid's second
// axis too, and the blocks of one row tile meet in a 64-bit atomicMin on
// (order-preserving bits of the score << 32 | index): the smallest score
// wins, and of equal scores the lowest index, with no second pass over
// partial results. Two small kernels of the same launch set the (N,) packed
// minima to all ones first and unpack the indices last.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;         // rows per block
constexpr int BC = 64;         // codes per tile
constexpr int BD = 32;         // dimensions per shared-memory stage
constexpr int NT = 256;        // threads: a 16x16 grid of (ty, tx)
constexpr int PITCH = BN + 1;  // transposed tiles, padded against bank conflicts
constexpr int TARGET_BLOCKS = 2 * 132;  // two waves of the H100's SMs

// float -> unsigned with the same order (-0 is folded into +0 first, so
// the two zeros tie as they do for argmin)
__device__ __forceinline__ unsigned long long pack(float s, int idx) {
  unsigned int u = __float_as_uint(s == 0.f ? 0.f : s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned int>(idx);
}

__device__ __forceinline__ bool better(float s, int i, float s_best, int i_best) {
  return s < s_best || (s == s_best && i < i_best);
}

__global__ void vq_init_kernel(unsigned long long* __restrict__ best, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) best[i] = ~0ull;
}

__global__ void vq_unpack_kernel(const unsigned long long* __restrict__ best,
                                 int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = static_cast<int32_t>(best[i] & 0xffffffffull);
}

__global__ void __launch_bounds__(NT)
vq_nearest_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                  const float* __restrict__ e2, unsigned long long* __restrict__ best,
                  int n, int c, int d, int codes_per_block) {
  __shared__ float Xs[BD][PITCH];  // x^T, one 32-dimension stage of 64 rows
  __shared__ float Es[BD][PITCH];  // e^T, the same stage of 64 codes

  const int r0 = blockIdx.x * BN;
  const int c_begin = blockIdx.y * codes_per_block;
  const int c_end = min(c, c_begin + codes_per_block);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float s_best[4];
  int i_best[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s_best[i] = INFINITY;
    i_best[i] = 0x7fffffff;
  }

  for (int c0 = c_begin; c0 < c_end; c0 += BC) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += BD) {
      __syncthreads();  // the previous stage is consumed
      for (int e = tid; e < BN * BD; e += NT) {
        const int r = e / BD, k = e % BD;
        Xs[k][r] = r0 + r < n && d0 + k < d ? x[(size_t)(r0 + r) * d + d0 + k] : 0.f;
        Es[k][r] = c0 + r < c_end && d0 + k < d ? cb[(size_t)(c0 + r) * d + d0 + k] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < BD; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Xs[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Es[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    // codes c0 + tx + 16 j rise with j and with c0: a strict < keeps the first
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int code = c0 + tx + 16 * j;
      if (code >= c_end) continue;
      const float e = e2[code];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float s = fmaf(-2.f, acc[i][j], e);  // -2 x.e exact, one rounding
        if (s < s_best[i]) {
          s_best[i] = s;
          i_best[i] = code;
        }
      }
    }
  }

  // the 16 threads of a row (lanes tx of one half-warp) agree on its minimum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float s = __shfl_xor_sync(0xffffffffu, s_best[i], off);
      const int idx = __shfl_xor_sync(0xffffffffu, i_best[i], off);
      if (better(s, idx, s_best[i], i_best[i])) {
        s_best[i] = s;
        i_best[i] = idx;
      }
    }
    const int row = r0 + ty + 16 * i;
    if (tx == 0 && row < n && i_best[i] != 0x7fffffff)
      atomicMin(best + row, pack(s_best[i], i_best[i]));
  }
}

}  // namespace

// x (n, d) and cb (c, d) float32, e2 (c,) float32 = |e|^2 of each code;
// best (n,) 64-bit scratch; out (n,) int32. Returns a cudaError_t.
extern "C" int vq_nearest(const void* x, const void* cb, const void* e2, void* best, void* out,
                          int n, int c, int d, void* stream) {
  if (n <= 0 || c <= 0 || d <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* packed = static_cast<unsigned long long*>(best);
  const int row_tiles = (n + BN - 1) / BN;
  const int code_tiles = (c + BC - 1) / BC;
  if (row_tiles > 2147483647 / BN || code_tiles > 65535) return cudaErrorInvalidValue;
  // split C over enough blocks for two waves of the SMs, whole tiles each
  int splits = (TARGET_BLOCKS + row_tiles - 1) / row_tiles;
  splits = splits < 1 ? 1 : (splits > code_tiles ? code_tiles : splits);
  const int tiles_per_block = (code_tiles + splits - 1) / splits;
  splits = (code_tiles + tiles_per_block - 1) / tiles_per_block;

  vq_init_kernel<<<(n + 255) / 256, 256, 0, s>>>(packed, n);
  dim3 grid(row_tiles, splits);
  vq_nearest_kernel<<<grid, NT, 0, s>>>(static_cast<const float*>(x),
                                        static_cast<const float*>(cb),
                                        static_cast<const float*>(e2), packed, n, c, d,
                                        tiles_per_block * BC);
  vq_unpack_kernel<<<(n + 255) / 256, 256, 0, s>>>(packed, static_cast<int32_t*>(out), n);
  return cudaGetLastError();
}
