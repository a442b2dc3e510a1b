// Hopper's warpgroup building blocks (sm_90a), shared by the flash-attention
// forward (flash_fwd.cu, K1), its dq and dk/dv kernels (flash_bwd.cu, K2 and
// K3) and the nearest-code search (vq.cu, K6): mbarriers (within a block and
// across a thread-block cluster), TMA tile loads, warpgroup matrix products
// (wgmma) from swizzled shared memory, and register hand-over between
// warpgroups (setmaxnreg). Written in inline PTX, like mma.cuh, whose
// masking rule, tf32 rounding and mma.sync product these kernels keep using.
//
// Tiles. Every operand tile is made of boxes of 64 rows of 128 bytes laid
// out as TMA's 128-byte swizzle writes them: the 16-byte chunk c of row r
// sits at chunk c ^ (r % 8) of that row, in 1024-byte blocks of 8 rows (each
// box starts 1024-byte aligned, as the swizzle is taken on address bits). A
// D-wide row of the flash kernels spans D * sizeof(T) / 128 such boxes, one
// after another (boxes<T, D>): a bf16 tile of 64 values a row is one box,
// of 128 values two, of 256 four; a float32 tile of 32, 64 or 128 values a
// row one, two or four (TMA loads each box as its own 128-byte-wide column
// range). A
// 32-wide bf16 row is half a box: TMA reads the box 64 columns wide from a
// tensor map whose rows end at 32, so columns 32-63 arrive as zeros, which
// add nothing to a product. K6 streams float32 rows 32 columns (one box) at
// a time. A wgmma descriptor names one box with the 128-byte swizzle mode
// and a stride of 1024 bytes between 8-row blocks; a product whose N index
// is contiguous (P V) runs once a box of 64 columns, so no descriptor ever
// spans two boxes along N (see desc).
//
// Float32 is 3xTF32, as in mma.cuh: an operand x is split into big =
// tf32(x) and small = tf32(x - big), by tc::to_tf32's integer rounding,
// once, into a pair of tiles of one layout (big over x in place, small in a
// second tile), and a*b is a_big*b_small + a_small*b_big + a_big*b_big.
// At D = 256 (flash_bwd.cu's chunked K2 and K3) a whole tile's pair does not
// fit beside the rest: the fixed A operand stays unsplit in shared memory
// and each k-step's fragment is split in registers by the same rounding,
// the same bits (gemm_nk_rs_chunk: wgmma takes a tf32 A from registers).
// Built with -DMMA_TF32_ONE_PASS (tests only) only a_big*b_big is kept.
// wgmma takes tf32 operands K-major only, so a float32 product whose B
// operand lies with its N index contiguous (P V, P^T dO, dS^T Q, dS K) runs
// on mma.sync instead, reading the B fragments from the split tiles
// (gemm_pk_split): a transposed second copy of those tiles would not fit
// beside the ring of stages (see flash_fwd.cu and flash_bwd.cu for the
// budgets). At D = 256 those operands stream through the ring a chunk at a
// time, so the producer splits the chunks these products take transposed
// (split_tile_t) and they run on wgmma too (gemm_pk_rs_chunk).
//
// Accumulators of a m64nN product are in mma.sync's C layout per warp: warp
// w of the warpgroup holds rows 16w + g and 16w + g + 8 (g = lane / 4),
// columns 8j + 2t and 8j + 2t + 1 (t = lane % 4) of n-block j, as
// acc[4j + 0..1] and acc[4j + 2..3]. So the score epilogue of mma.cuh's
// layout reads them as they stand, and an accumulator strip is the A
// operand of a register-sourced product as it stands (tc::a_from_acc).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace wg {

// ---- PTX primitives ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(tc::smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA) and the cluster
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(tc::smem_u32(bar))
               : "memory");
}

// the barrier's current phase also waits for `bytes` of TMA transfers
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(tc::smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(tc::smem_u32(bar)), "r"(bytes) : "memory");
}

// waits until the phase of the given parity has completed (a fresh barrier
// is in phase 0, so waiting for parity 1 returns at once); at cluster scope
// (CLUSTER) the phase's arrivals may come from other blocks of the cluster
// (mbar_arrive_remote), and their shared-memory stores before them are
// visible after it. A wait that has not completed after ~2^35 cycles (~20 s)
// traps: a fault in a protocol of barriers then ends the launch with an
// error instead of hanging the card.
template <bool CLUSTER = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = tc::smem_u32(bar);
  uint32_t done;
  long long start = 0;
  for (;;) {
    if constexpr (CLUSTER)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    else
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 35)) __trap();
  }
}

// one arrival on the barrier at `bar`'s offset in the shared memory of
// block `rank` of the cluster, releasing this thread's earlier stores (and,
// after a barrier of this block, its other threads') at cluster scope
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %0, %1;\n"
      " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n"
      :: "r"(tc::smem_u32(bar)), "r"(rank) : "memory");
}

// a box of a 2-D tensor map at coordinates (c0 innermost, c1) into shared
// memory, reported to `bar` as bytes arrive (zeros outside the tensor)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(tc::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(tc::smem_u32(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

// a box of a 3-D tensor map at coordinates (c0 innermost, c1, c2) into
// shared memory, reported to `bar` as bytes arrive (zeros outside the tensor)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(tc::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(tc::smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// orders this thread's shared-memory stores before later reads by the
// async proxy (wgmma's operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// an asynchronous product's issue or wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// the descriptor of a 128-byte-swizzled operand starting at s: 8-row
// blocks 1024 bytes apart. The leading byte offset is unused by a K-major
// operand; for an operand whose N index is contiguous it is the stride
// between 64-wide swizzle atoms along N, and every such product here covers
// one atom (a box: gemm_pk issues one product a box of a wider tile), so it
// is set to 1024 bytes as well and whichever of the two the hardware takes
// for the 8-row stride is right.
__device__ __forceinline__ uint64_t desc(const void* s) {
  const uint64_t a = tc::smem_u32(s);
  return ((a & 0x3ffff) >> 4) | ((uint64_t)(1024 >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32)
         | (1ull << 62);
}

#define WG_ACC32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_ACC32_OUT(d)                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),    \
  "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),              \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64) = A (64 x 16) B^T (+ d if acc), A and B K-major bf16 in shared memory
__device__ __forceinline__ void mma_bf16_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_ACC32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32_OUT(d)
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64) += A (64 x 16, registers) B, B (16 x 64) bf16 in shared memory
// with its N index contiguous (the transposed B)
__device__ __forceinline__ void mma_bf16_rs_t(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64) = A (64 x 8) B^T (+ d if acc), A and B K-major tf32 in shared memory
__device__ __forceinline__ void mma_tf32_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_ACC32
      ", %32, %33, p, 1, 1;\n}\n"
      : WG_ACC32_OUT(d)
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64) = A (64 x 8, registers) B^T (+ d if acc), B K-major tf32 in
// shared memory. A's fragment is mma.sync m16n8k8's per warp: a[0] row g,
// column t; a[1] row g + 8; a[2] column t + 4; a[3] both (g = lane / 4, t =
// lane % 4, rows of warp w from 16w)
__device__ __forceinline__ void mma_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_ACC32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

#undef WG_ACC32
#undef WG_ACC32_OUT

// ---- Host side: tensor maps ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q)
            == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the map of a (planes, rows, d) row-major tensor of 2-byte (bf16) or
// 4-byte (float32) elements (d in 32, 64, 128; in bf16 also 256), read as
// (64 or 32 columns) x 64-row boxes of 128 bytes a row, 128-byte swizzled;
// rows past `rows` of a plane read as zeros, never the next plane's, and so
// do columns past d (a 32-wide bf16 row's box: columns 32-63)
inline cudaError_t tile_map(CUtensorMap* map, const void* base, int elem_bytes, int rows,
                            int planes, int d = 64) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)d * elem_bytes, (cuuint64_t)d * elem_bytes * rows};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / elem_bytes), 64, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = encode(map, elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            3, const_cast<void*>(base), dims, strides, box, estr,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the map of a (rows, cols) row-major float32 matrix (cols a multiple of 4,
// the base 16-byte aligned: TMA's rules), read as 32-column x `box_rows`-row
// boxes of 128 bytes a row, 128-byte swizzled; reads outside the matrix
// give zeros
inline cudaError_t matrix_map(CUtensorMap* map, const void* base, int rows, int cols,
                              int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {4ull * cols};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
                            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- Tiles and products, built from the primitives above. ----

// the 128-byte boxes a D-wide row of T spans (a 32-wide bf16 row: one, half
// of it zeros)
template <typename T, int D>
__host__ __device__ constexpr int boxes() {
  return D * (int)sizeof(T) >= 128 ? D * (int)sizeof(T) / 128 : 1;
}

// bytes of one 64-row operand tile of D-wide rows of T (the big parts, for
// float32)
template <typename T, int D>
__host__ __device__ constexpr int tile_bytes() { return 8192 * boxes<T, D>(); }

// the 8-column n-blocks of a thread's 64 x D accumulator of a product whose
// N index is D (P V): a bf16 product covers whole boxes (a 32-wide row's
// padded half too, which stays zero), a float32 one D columns
template <typename T, int D>
__host__ __device__ constexpr int acc_blocks() {
  return sizeof(T) == 2 ? 8 * boxes<T, D>() : D / 8;
}

// a 64 x D tile of T at s (a row r) from `map` at row r0 of plane p, on
// `bar`: one TMA load a box
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* s, const CUtensorMap* map, uint64_t* bar, int r0,
                                          int p) {
#pragma unroll
  for (int j = 0; j < boxes<T, D>(); ++j)
    tma_load_3d(reinterpret_cast<unsigned char*>(s) + 8192 * j, map, bar,
                j * (128 / (int)sizeof(T)), r0, p);
}

// the float32 tile of `BYTES` at s split in place into its tf32 big parts,
// the small parts into lo (the same layout); `n` threads, this one `i` of
// them. Elementwise, so the swizzle does not matter.
template <int BYTES>
__device__ __forceinline__ void split_tile(float* s, float* lo, int i, int n) {
  uint4* hi4 = reinterpret_cast<uint4*>(s);
  uint4* lo4 = reinterpret_cast<uint4*>(lo);
  for (int c = i; c < BYTES / 16; c += n) {
    uint4 x = hi4[c], h, l;
    tc::split(__uint_as_float(x.x), h.x, l.x);
    tc::split(__uint_as_float(x.y), h.y, l.y);
    tc::split(__uint_as_float(x.z), h.z, l.z);
    tc::split(__uint_as_float(x.w), h.w, l.w);
    hi4[c] = h;
    lo4[c] = l;
  }
}

// the byte offset of element (r, c) of a 64-row float32 tile (32 columns a box)
__device__ __forceinline__ int f32_offset(int r, int c) {
  return (c >> 5) * 8192 + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4;
}

// acc (64 x 64) = A B^T over a depth of D, A and B K-major tiles in shared
// memory (a, b; in float32 the big parts, the small ones in al, bl), one
// 32-byte k-step at a time, four a box; the products issued and committed,
// not waited for
template <typename T, int D>
__device__ __forceinline__ void gemm_nk(float (&acc)[32], const T* a, const T* al, const T* b,
                                        const T* bl) {
  constexpr int KS = D * (int)sizeof(T) / 32;  // k-steps
  const unsigned char *ah = reinterpret_cast<const unsigned char*>(a),
                      *bh = reinterpret_cast<const unsigned char*>(b);
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int o = (ks >> 2) * 8192;  // the box
      mma_bf16_ss(acc, desc(ah + o) + 2 * (ks & 3), desc(bh + o) + 2 * (ks & 3), ks > 0);
    }
  } else {
    const unsigned char *alo = reinterpret_cast<const unsigned char*>(al),
                        *blo = reinterpret_cast<const unsigned char*>(bl);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int o = (ks >> 2) * 8192;  // the 32-column box
      const uint64_t k = 2 * (ks & 3);  // 32 bytes a k-step, in 16-byte units
      const uint64_t dah = desc(ah + o) + k, dbh = desc(bh + o) + k;
#ifndef MMA_TF32_ONE_PASS
      mma_tf32_ss(acc, dah, desc(blo + o) + k, ks > 0);
      mma_tf32_ss(acc, desc(alo + o) + k, dbh, 1);
      mma_tf32_ss(acc, dah, dbh, 1);
#else
      mma_tf32_ss(acc, dah, dbh, ks > 0);
#endif
    }
  }
  wgmma_commit();
}

// acc (64 x 64 NB) += A B as gemm_pk's, A already packed: a[k-step] the
// four bf16 pairs of this thread's accumulator positions (gemm_pk's
// packing); issued and committed, not waited for
template <int NB>
__device__ __forceinline__ void gemm_rk(float (&acc)[32 * NB], const uint32_t (&a)[4][4],
                                        const __nv_bfloat16* b) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const uint64_t db = desc(reinterpret_cast<const unsigned char*>(b) + 8192 * j);
    float(&box)[32] = *reinterpret_cast<float(*)[32]>(acc + 32 * j);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_bf16_rs_t(box, a[ks], db + 128 * ks);  // 16 rows of 128 B
  }
  wgmma_commit();
}

// acc (64 x 64 NB) += P (64 x 64, this warpgroup's accumulators) B, B a
// bf16 tile of NB boxes (64 columns each) in shared memory with its N index
// contiguous, one product a box into acc's n-blocks 8j ..; issued and
// committed, not waited for. P is packed into `a` once, every k-step's A
// first so the products issue back to back; the caller keeps `a` untouched
// until the products have completed.
template <int NB>
__device__ __forceinline__ void gemm_pk(float (&acc)[32 * NB], const float (&p)[32],
                                        uint32_t (&a)[4][4], const __nv_bfloat16* b) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[ks][i] = tc::pack_bf16(p[8 * ks + 2 * i], p[8 * ks + 2 * i + 1]);
  gemm_rk<NB>(acc, a, b);
}

// part (16 x 8 NB8, this warp's strip, mma.sync's C layout) = P (this
// warp's 16 x 64 strip of accumulators) B[:, c0 .. c0 + 8 NB8), B a split
// float32 tile (hi, lo; K rows of N columns, N contiguous) in shared memory,
// on mma.sync in 3xTF32. The k index of each 8-wide step is permuted as in
// mma.cuh (kk = t <-> row 2t, kk = t + 4 <-> row 2t + 1), so an accumulator
// pair is an A fragment as it stands.
template <int NB8>
__device__ __forceinline__ void gemm_pk_split(float (&part)[NB8][4], const float (&p)[32],
                                              const float* hi, const float* lo, int c0) {
  static_assert(NB8 % 2 == 0, "n-blocks go in pairs");
  const int l = tc::lane_id(), g = l >> 2, t = l & 3;
  const unsigned char* h8 = reinterpret_cast<const unsigned char*>(hi);
  const unsigned char* l8 = reinterpret_cast<const unsigned char*>(lo);
  tc::zero(part);
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    tc::Frag<float>::A a;
    tc::split(p[4 * ks + 0], a.hi[0], a.lo[0]);
    tc::split(p[4 * ks + 2], a.hi[1], a.lo[1]);
    tc::split(p[4 * ks + 1], a.hi[2], a.lo[2]);
    tc::split(p[4 * ks + 3], a.hi[3], a.lo[3]);
#pragma unroll
    for (int n = 0; n < NB8; n += 2) {
      tc::Frag<float>::B b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int o0 = f32_offset(8 * ks + 2 * t, c0 + 8 * (n + i) + g);
        const int o1 = f32_offset(8 * ks + 2 * t + 1, c0 + 8 * (n + i) + g);
        b[i].hi[0] = *reinterpret_cast<const uint32_t*>(h8 + o0);
        b[i].hi[1] = *reinterpret_cast<const uint32_t*>(h8 + o1);
        b[i].lo[0] = *reinterpret_cast<const uint32_t*>(l8 + o0);
        b[i].lo[1] = *reinterpret_cast<const uint32_t*>(l8 + o1);
      }
      tc::mma2(part[n], part[n + 1], a, b);
    }
  }
}

// acc (this warp's 16 x D strip, acc_blocks<float, D>() n-blocks) += P B,
// or with SCALED acc = acc * scale + P B, B a split float32 tile of D
// columns: 64 columns at a time, each from zero, added in float32
// (tc::add_tile's reason)
template <int D, bool SCALED = false>
__device__ __forceinline__ void add_pk_split(float (&acc)[D / 2], const float (&p)[32],
                                             const float* hi, const float* lo,
                                             const float* scale = nullptr) {
  constexpr int W = D < 64 ? D : 64;
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += W) {
    float part[W / 8][4];
    gemm_pk_split<W / 8>(part, p, hi, lo, c0);
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& a = acc[c0 / 2 + 4 * j + e];
        if constexpr (SCALED) a = a * scale[e / 2] + part[j][e];
        else a += part[j][e];
      }
  }
}

// ---- Float32 at D = 256: one 64-column chunk of the depth at a time ----
// An operand tile with its tf32 small parts is 128 KB at D = 256, so two
// such tiles do not fit in a block's shared memory. The kernels keep their
// two fixed operands whole and unsplit (each the A operand of a score
// product, split k-step by k-step in registers) and stream the other
// operands through the ring 64 columns at a time, each chunk split in place
// by the producer into a pair of 16 KB tiles (two 32-column boxes).

constexpr int CHUNK = 64;            // columns of the depth a streamed chunk holds
constexpr int CHUNK_BYTES = 16384;   // one 64-row float32 chunk: two boxes

// columns c0 .. c0 + 63 of rows r0 .. r0 + 63 of plane p of a float32
// tensor map into a chunk tile at s, on `bar`: one TMA load a 32-column box
__device__ __forceinline__ void load_chunk(float* s, const CUtensorMap* map, uint64_t* bar,
                                           int c0, int r0, int p) {
  tma_load_3d(s, map, bar, c0, r0, p);
  tma_load_3d(reinterpret_cast<unsigned char*>(s) + 8192, map, bar, c0 + 32, r0, p);
}

// acc (64 x 64) (+)= A B^T over columns c0 .. c0 + 63 of the depth: A a
// float32 tile of 64 rows in shared memory, unsplit (boxes of 32 columns,
// as load_tile lays them out), each k-step's fragment read into registers
// and split there by tc::split (the bits split_tile gives a tile); B the
// chunk's split tiles (bh, bl) in shared memory. 3xTF32 in gemm_nk's order,
// from zero where `first`. Each k-step is a group of its own, and at most
// three are in flight (a k-step's fragment is 8 registers, held until its
// products complete); returns with the last two not waited for.
__device__ __forceinline__ void gemm_nk_rs_chunk(float (&acc)[32], const float* a, int c0,
                                                 const float* bh, const float* bl, bool first) {
  const int l = tc::lane_id(), g = l >> 2, t = l & 3, r = (threadIdx.x & 127) / 32 * 16 + g;
  const unsigned char* a8 = reinterpret_cast<const unsigned char*>(a);
  const unsigned char *bh8 = reinterpret_cast<const unsigned char*>(bh),
                      *bl8 = reinterpret_cast<const unsigned char*>(bl);
#pragma unroll
  for (int ks = 0; ks < CHUNK / 8; ++ks) {
    const int c = c0 + 8 * ks + t;
    uint32_t hi[4], lo[4];
    tc::split(*reinterpret_cast<const float*>(a8 + f32_offset(r, c)), hi[0], lo[0]);
    tc::split(*reinterpret_cast<const float*>(a8 + f32_offset(r + 8, c)), hi[1], lo[1]);
    tc::split(*reinterpret_cast<const float*>(a8 + f32_offset(r, c + 4)), hi[2], lo[2]);
    tc::split(*reinterpret_cast<const float*>(a8 + f32_offset(r + 8, c + 4)), hi[3], lo[3]);
    const int o = (ks >> 2) * 8192;   // the chunk's 32-column box
    const uint64_t k = 2 * (ks & 3);  // 32 bytes a k-step, in 16-byte units
    const uint64_t dbh = desc(bh8 + o) + k;
    const int from = !first || ks > 0;
    wgmma_fence();  // the fragment's registers were just written
#ifndef MMA_TF32_ONE_PASS
    mma_tf32_rs(acc, hi, desc(bl8 + o) + k, from);
    mma_tf32_rs(acc, lo, dbh, 1);
    mma_tf32_rs(acc, hi, dbh, 1);
#else
    (void)lo;
    mma_tf32_rs(acc, hi, dbh, from);
#endif
    wgmma_commit();
    wgmma_wait<2>();
  }
}

// The split of a streamed chunk, transposed: the chunk at hi (64 rows of 64
// columns as TMA wrote it) becomes its split hi^T and lo^T (64 rows, the
// chunk's columns, of 64 positions, the chunk's rows in groups of 8 in the
// order 0, 2, 4, 6, 1, 3, 5, 7): the K-major B operand of a product whose
// N index the chunk's columns are (dq += dS K, dV += P^T dO, dK += dS^T Q;
// gemm_pk_rs_chunk, whose A fragment of k-step j holds k = t and t + 4
// where the accumulator layout holds columns 8j + 2t and 8j + 2t + 1). 128
// threads, this one i of them: warp w reads its 16-byte groups 4w .. 4w + 3
// of rows l and l + 32 (l its lane; conflict-free), every thread's reads
// done (named barrier `bar` of the 128) before any write; a warp's writes of
// one value each hit 32 positions of one row (conflict-free).
__device__ __forceinline__ void split_tile_t(float* hi, float* lo, int i, int bar) {
  const int w = i >> 5, l = i & 31;
  unsigned char* h8 = reinterpret_cast<unsigned char*>(hi);
  unsigned char* l8 = reinterpret_cast<unsigned char*>(lo);
  float4 v[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    v[q] = *reinterpret_cast<const float4*>(h8 + f32_offset(l + 32 * (q & 1), 16 * w + 4 * (q >> 1)));
  tc::bar_sync(bar, 128);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int r = l + 32 * (q & 1), p = (r & ~7) + ((r & 7) >> 1) + 4 * (r & 1);
    const float x[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = f32_offset(16 * w + 4 * (q >> 1) + e, p);
      uint32_t h, s;
      tc::split(x[e], h, s);
      *reinterpret_cast<uint32_t*>(h8 + o) = h;
      *reinterpret_cast<uint32_t*>(l8 + o) = s;
    }
  }
}

// k-step j's A values of a 64 x 64 accumulator-layout tile P (rows 16w + g
// and + 8; columns 8j + 2t and + 1) as wgmma's tf32 fragment holds them with
// k = t <-> column 2t and k = t + 4 <-> column 2t + 1: from registers, or
// from a hand-off in shared memory (thread i's values 4j .. 4j + 3 at pf[j *
// 128 + i])
__device__ __forceinline__ void pk_a(float (&a)[4], const float (&p)[32], int j) {
  a[0] = p[4 * j];
  a[1] = p[4 * j + 2];
  a[2] = p[4 * j + 1];
  a[3] = p[4 * j + 3];
}
__device__ __forceinline__ void pk_a(float (&a)[4], const float4* pf, int j) {
  const float4 v = pf[j * 128 + (threadIdx.x & 127)];
  a[0] = v.x;
  a[1] = v.z;
  a[2] = v.y;
  a[3] = v.w;
}

// part (64 x 64) = P B over k = 64, P a 64 x 64 accumulator-layout tile
// (pk_a's two sources), B a chunk split and transposed by split_tile_t (bh,
// bl) in shared memory: wgmma with A from registers, each k-step's fragment
// split by tc::split; 3xTF32 in gemm_nk's order, from zero. Each k-step is a
// group of its own, at most three in flight; returns with the last two not
// waited for.
template <class P>
__device__ __forceinline__ void gemm_pk_rs_chunk(float (&part)[32], const P& p, const float* bh,
                                                 const float* bl) {
  const unsigned char *bh8 = reinterpret_cast<const unsigned char*>(bh),
                      *bl8 = reinterpret_cast<const unsigned char*>(bl);
#pragma unroll
  for (int j = 0; j < CHUNK / 8; ++j) {
    float a[4];
    pk_a(a, p, j);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) tc::split(a[e], hi[e], lo[e]);
    const int o = (j >> 2) * 8192;   // the chunk's 32-position box
    const uint64_t k = 2 * (j & 3);  // 32 bytes a k-step, in 16-byte units
    const uint64_t dbh = desc(bh8 + o) + k;
    wgmma_fence();  // the fragment's registers were just written
#ifndef MMA_TF32_ONE_PASS
    mma_tf32_rs(part, hi, desc(bl8 + o) + k, j > 0);
    mma_tf32_rs(part, lo, dbh, 1);
    mma_tf32_rs(part, hi, dbh, 1);
#else
    (void)lo;
    mma_tf32_rs(part, hi, dbh, j > 0);
#endif
    wgmma_commit();
    wgmma_wait<2>();
  }
}

// acc (a 64 x D accumulator, this warpgroup's) columns c0 .. c0 + 63 += P
// B (gemm_pk_rs_chunk), the chunk's product from zero, added in float32
// (tc::add_tile's reason). c0 must be known once the caller's loop is
// unrolled, so that acc stays in registers.
template <int D, class P>
__device__ __forceinline__ void add_pk_chunk(float (&acc)[D / 2], const P& p, const float* bh,
                                             const float* bl, int c0) {
  float part[32];
  fence_acc(part);
  gemm_pk_rs_chunk(part, p, bh, bl);
  wgmma_wait<0>();
  fence_acc(part);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[c0 / 2 + i] += part[i];
}

}  // namespace wg
