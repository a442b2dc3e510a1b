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
// products at 495 TFLOP/s), 12.5 us at the 67 TFLOP/s float32 FMA rate,
// against 3.7 MB of inputs, 1.1 us at 3.35 TB/s: bound by the operations
// (worked out from the shapes). The codec makes 12 such searches in
// sequence per round trip, so each launch's fixed cost counts as well: the
// earlier design took 5 launches a search (|e|^2 summed by two PyTorch ops, an
// init kernel, the search on the CUDA cores with two shared-memory loads
// per 4 FMAs, an unpack kernel).
//
// Design. One launch, on the tensor cores through csrc/mma.cuh: mma.sync
// m16n8k8 on TF32 in the 3xTF32 form, so float32 accuracy at a tensor-core
// rate. A block of 16 warps takes a 64-row tile of X against 128-code tiles
// of E, each warp a 16 x 32 block of the scores (4 row strips x 4 code
// quarters). D is streamed 32 dimensions at a time: both tiles' float32
// chunks come by cp.async into a ring of three stages, two chunks ahead,
// and one pass of the block splits each element once into its big and small
// tf32 parts, stored in the mma's fragment order, so a warp reads an
// operand by one 16-byte load and no warp splits again what another has
// split. Each chunk's product starts from zero and is added to the scores
// in float32: the tensor cores' accumulation truncates, and a 512-deep
// running sum inside the mma would lose up to an ulp a product, too close
// to the near-tie gate of 1e-5 of the score's terms. The same split pass
// sums the squares of the code rows, so |e|^2 costs no launch and no read
// of its own. The scores -2 x.e + |e|^2 go straight into a running (score,
// index) minimum per row, codes in increasing order with a strict <, then
// across the 4 lanes of a quad and the four code quarters by (score, index)
// pairs. C is split over the blocks of a thread-block cluster of up to 8
// (rank r takes code tiles r, r + 8, ...), so N = 800 makes 13 x 8 = 104
// blocks; the ranks' minima meet in distributed shared memory, rank 0
// compares them in rank order (the lower index wins a tie) and writes the
// int32 index. No scratch, no atomics, no second kernel.
//
// What holds it back (measured on an H100 by tools/torch_vq_ablate.py,
// PERF.md): each block runs its 16 chunks in sequence at ~2.2 us a chunk,
// the same at 1 row as at 800, and that time is the sum of the chunk's mma.sync products, its fragment loads
// from shared memory and its split pass: taking any one out saves its
// share, and none overlaps the others. A warp-specialised variant (8
// warps loading and splitting, 8 multiplying), 32 x 32 warp tiles, loads
// four chunks ahead or one barrier a chunk all measured the same. The next
// design to try keeps the operands out of registers: wgmma reads them from
// shared memory itself. The ablation tool builds its variants by matching
// exact lines of the chunk loop below (the cp.async copies of a chunk, the
// `// the split pass` comment, the `// the split chunk is in` barrier and the
// tc::mma2 call) and stops with a message when one no longer matches: an
// edit there updates the tool as well.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BN = 64;          // rows of X per block
constexpr int BC = 128;         // codes per tile
constexpr int KC = 32;          // dimensions per chunk
constexpr int KS = KC / 8;      // k-steps of the mma per chunk
constexpr int WQ = 32;          // codes of a warp's quarter of the tile
constexpr int NT = 512;         // 16 warps: 4 row strips of 16 x 4 code quarters of 32
constexpr int STAGES = 3;       // chunks in flight: two load while one is split
constexpr int RP = KC + 4;      // the float32 chunks' pitch: the split pass reads without conflicts
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int NONE = 0x7fffffff;

// Shared memory: a ring of float32 chunks (BN rows of X, then BC code rows,
// RP floats each); the split chunk in fragment order (X: per 16-row strip
// and k-step, 32 lanes' big parts then their small parts, 16 bytes each; E:
// per 8-code block and k-step, 32 lanes' {big, big, small, small}); |e|^2 of
// the tile's codes; each code quarter's row minima; the block's.
struct Smem {
  static constexpr size_t stage = (size_t)(BN + BC) * RP * sizeof(float);
  static constexpr size_t xsplit = STAGES * stage;
  static constexpr size_t esplit = xsplit + (size_t)(BN / 16) * KS * 64 * sizeof(uint4);
  static constexpr size_t e2 = esplit + (size_t)(BC / 8) * KS * 32 * sizeof(uint4);
  static constexpr size_t quarter = e2 + BC * sizeof(float);
  static constexpr size_t best = quarter + (BC / WQ) * BN * 2 * sizeof(float);
  static constexpr size_t bytes = best + BN * 2 * sizeof(float);
  static_assert(stage % 16 == 0, "16-byte aligned stages");
};

__device__ __forceinline__ bool better(float s, int i, float s_best, int i_best) {
  return s < s_best || (s == s_best && i < i_best);
}

__global__ void __launch_bounds__(NT, 1)
vq_nearest_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                  int32_t* __restrict__ out, int n, int c, int d, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto raw = [&](int s) { return reinterpret_cast<float*>(smem + s * Smem::stage); };
  uint4* xs = reinterpret_cast<uint4*>(smem + Smem::xsplit);
  uint4* es = reinterpret_cast<uint4*>(smem + Smem::esplit);
  float* e2s = reinterpret_cast<float*>(smem + Smem::e2);
  float* quart_s = reinterpret_cast<float*>(smem + Smem::quarter);  // [4][BN] scores
  int* quart_i = reinterpret_cast<int*>(quart_s + (BC / WQ) * BN);   // [4][BN] indices
  float* best_s = reinterpret_cast<float*>(smem + Smem::best);        // [BN], read by rank 0
  int* best_i = reinterpret_cast<int*>(best_s + BN);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const int r0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int mb = warp % 4, wq = warp / 4;  // this warp's row strip and code quarter

  // rank r takes code tiles r, r + csize, ... (csize <= code tiles: at least one)
  const int code_tiles = (c + BC - 1) / BC;
  const int my_tiles = (code_tiles - rank + csize - 1) / csize;
  const int chunks = (d + KC - 1) / KC;
  const int total = my_tiles * chunks;

  // chunk `it` (code tile rank + csize * (it / chunks), dimensions from
  // KC * (it % chunks)) of X and E into stage it % STAGES, zeros past n, c
  // and d, as one group of copies (an empty group past the last chunk)
  auto issue = [&](int it) {
    if (it < total) {
      float* dst = raw(it % STAGES);
      const int c0 = (rank + csize * (it / chunks)) * BC, k0 = (it % chunks) * KC;
      if (vec) {  // d % 4 == 0 and 16-byte aligned rows: 16-byte copies
        for (int i = tid; i < (BN + BC) * (KC / 4); i += NT) {
          const int r = i / (KC / 4), k = k0 + (i % (KC / 4)) * 4;
          const bool is_x = r < BN;
          const int row = is_x ? r0 + r : c0 + r - BN;
          const bool in = row < (is_x ? n : c) && k < d;
          const float* src = (is_x ? x : cb) + (in ? (size_t)row * d + k : 0);
          tc::cp_async16(dst + r * RP + k - k0, src, in);
        }
      } else {
        for (int i = tid; i < (BN + BC) * KC; i += NT) {
          const int r = i / KC, k = k0 + i % KC;
          const bool is_x = r < BN;
          const int row = is_x ? r0 + r : c0 + r - BN;
          const bool in = row < (is_x ? n : c) && k < d;
          const float* src = (is_x ? x : cb) + (in ? (size_t)row * d + k : 0);
          tc::cp_async4(dst + r * RP + k - k0, src, in);
        }
      }
    }
    tc::cp_async_commit();
  };

  float run_s[2] = {INFINITY, INFINITY};  // this thread's rows g and g + 8 of its strip
  int run_i[2] = {NONE, NONE};
  float sum[WQ / 8][4];  // x.e of the strip's 16 rows and the quarter's 32 codes
  float e2p = 0.f;       // squares of code 8 warp + g, dimensions = t (mod 4)
  tc::zero(sum);

  issue(0);
  issue(1);
  for (int it = 0; it < total; ++it) {
    tc::cp_async_wait<1>();
    __syncthreads();  // chunk it has landed; chunk it - 1's split is consumed
    const float* xr = raw(it % STAGES);
    const float* er = xr + BN * RP;
    // the split pass: X's fragments (one per thread: rows g and g + 8,
    // dimensions t and t + 4 of a k-step of a strip) ...
    {
      const int fl = tid % 32, ks = (tid / 32) % KS, fm = tid / (32 * KS);
      const float* p = xr + (fm * 16 + fl / 4) * RP + ks * 8 + fl % 4;
      uint4 hi, lo;
      tc::split(p[0], hi.x, lo.x);
      tc::split(p[8 * RP], hi.y, lo.y);
      tc::split(p[4], hi.z, lo.z);
      tc::split(p[8 * RP + 4], hi.w, lo.w);
      xs[(fm * KS + ks) * 64 + fl] = hi;
      xs[(fm * KS + ks) * 64 + 32 + fl] = lo;
    }
    // ... and E's (code block `warp`, every k-step: code g of the block,
    // dimensions t and t + 4), summing the squares of this thread's code
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float* p = er + (warp * 8 + g) * RP + ks * 8 + t;
      const float b0 = p[0], b1 = p[4];
      e2p = fmaf(b1, b1, fmaf(b0, b0, e2p));
      uint4 v;
      tc::split(b0, v.x, v.z);
      tc::split(b1, v.y, v.w);
      es[(warp * KS + ks) * 32 + lane] = v;
    }
    __syncthreads();  // the split chunk is in; stage it % STAGES is consumed
    issue(it + 2);

    // this chunk's products from zero, then added to the sums in float32
    float part[WQ / 8][4];
    tc::zero(part);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      tc::Frag<float>::A a;
      const uint4 ahi = xs[(mb * KS + ks) * 64 + lane], alo = xs[(mb * KS + ks) * 64 + 32 + lane];
      a.hi[0] = ahi.x, a.hi[1] = ahi.y, a.hi[2] = ahi.z, a.hi[3] = ahi.w;
      a.lo[0] = alo.x, a.lo[1] = alo.y, a.lo[2] = alo.z, a.lo[3] = alo.w;
#pragma unroll
      for (int jb = 0; jb < WQ / 8; jb += 2) {
        tc::Frag<float>::B b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint4 v = es[((wq * (WQ / 8) + jb + i) * KS + ks) * 32 + lane];
          b[i].hi[0] = v.x, b[i].hi[1] = v.y, b[i].lo[0] = v.z, b[i].lo[1] = v.w;
        }
        tc::mma2(part[jb], part[jb + 1], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < WQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[j][e] += part[j][e];

    if (it % chunks == chunks - 1) {
      // the tile is done: |e|^2 of its codes (the quad's four dimension
      // classes added in a fixed order), then the scores into the minima
      e2p += __shfl_xor_sync(0xffffffffu, e2p, 1);
      e2p += __shfl_xor_sync(0xffffffffu, e2p, 2);
      if (t == 0) e2s[8 * warp + g] = e2p;
      e2p = 0.f;
      __syncthreads();
      const int c0 = (rank + csize * (it / chunks)) * BC + wq * WQ;
      // codes c0 + 8 j + 2 t + (e & 1) rise with j and e: a strict < keeps the first
#pragma unroll
      for (int j = 0; j < WQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1), code = c0 + col;
          const float s = fmaf(-2.f, sum[j][e], e2s[wq * WQ + col]);  // -2 x.e exact, one rounding
          if (code < c && s < run_s[e / 2]) {
            run_s[e / 2] = s;
            run_i[e / 2] = code;
          }
        }
      tc::zero(sum);
    }
  }

  // the row minima: across the quad, then the four code quarters in order,
  // then the cluster
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float s = __shfl_xor_sync(0xffffffffu, run_s[i], off);
      const int idx = __shfl_xor_sync(0xffffffffu, run_i[i], off);
      if (better(s, idx, run_s[i], run_i[i])) {
        run_s[i] = s;
        run_i[i] = idx;
      }
    }
    if (t == 0) {
      quart_s[wq * BN + mb * 16 + 8 * i + g] = run_s[i];
      quart_i[wq * BN + mb * 16 + 8 * i + g] = run_i[i];
    }
  }
  __syncthreads();
  if (tid < BN) {
    float s = quart_s[tid];
    int idx = quart_i[tid];
    for (int q = 1; q < BC / WQ; ++q)
      if (better(quart_s[q * BN + tid], quart_i[q * BN + tid], s, idx)) {
        s = quart_s[q * BN + tid];
        idx = quart_i[q * BN + tid];
      }
    best_s[tid] = s;
    best_i[tid] = idx;
  }
  cluster.sync();  // every rank's minima are in its shared memory
  if (rank == 0 && tid < BN && r0 + tid < n) {
    float s = best_s[tid];
    int idx = best_i[tid];
    for (int src = 1; src < csize; ++src) {
      const float s2 = cluster.map_shared_rank(best_s, src)[tid];
      const int i2 = cluster.map_shared_rank(best_i, src)[tid];
      if (better(s2, i2, s, idx)) {
        s = s2;
        idx = i2;
      }
    }
    out[r0 + tid] = idx == NONE ? 0 : idx;  // no score below +inf (NaN rows): the first code
  }
  cluster.sync();  // no block leaves while rank 0 still reads its minima
}

}  // namespace

// x (n, d) and cb (c, d) float32, row-major; out (n,) int32. One launch.
// Returns a cudaError_t.
extern "C" int vq_nearest(const void* x, const void* cb, void* out, int n, int c, int d,
                          void* stream) {
  if (n <= 0 || c <= 0 || d <= 0) return cudaErrorInvalidValue;
  const int row_tiles = (n + BN - 1) / BN;
  const int code_tiles = (c + BC - 1) / BC;
  if (row_tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(vq_nearest_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Smem::bytes);
  if (err != cudaSuccess) return err;
  // the code tiles over a cluster of up to MAX_CLUSTER blocks per row tile
  const int csize = code_tiles < MAX_CLUSTER ? code_tiles : MAX_CLUSTER;
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
                  && reinterpret_cast<uintptr_t>(cb) % 16 == 0;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, row_tiles);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = Smem::bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, vq_nearest_kernel, static_cast<const float*>(x),
                            static_cast<const float*>(cb), static_cast<int32_t*>(out), n, c, d,
                            vec);
}
