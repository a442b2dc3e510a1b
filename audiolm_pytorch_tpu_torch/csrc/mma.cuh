// Warp-level tensor-core building blocks for Hopper (sm_90a), shared by the
// flash-attention forward (flash_fwd.cu, K1) and its dq and dk/dv kernels
// (flash_bwd.cu, K2 and K3).
//
// One template over the operand type serves both of the port's dtypes:
//   bf16:    mma.sync m16n8k16, bf16 inputs, float32 accumulators;
//   float32: mma.sync m16n8k8 on TF32 in the 3xTF32 form. Each operand x is
//            split as big = tf32(x) and small = tf32(x - big), both rounded to
//            nearest, ties away from zero (cvt.rna's rounding, done by integer
//            ops: see to_tf32), and a*b is taken as a_big*b_small +
//            a_small*b_big + a_big*b_big, the two cross terms first. Only
//            a_small*b_small (~2^-22 of the product) is dropped, so the result
//            keeps close to float32 accuracy at a tensor-core rate.
// Built with -DMMA_TF32_ONE_PASS (for tests only) the float32 product keeps
// just a_big*b_big: plain TF32, 4e-4 to 6e-4 of a float64 reference on the
// H100, the variant a float32 accuracy check has to reject.
//
// A warp computes a 16-row strip. Accumulators are in the C layout of the mma:
// for lane l, g = l / 4 and t = l % 4, n-block j holds rows g and g + 8,
// columns 8j + 2t and 8j + 2t + 1, as acc[j][0..1] (row g) and acc[j][2..3]
// (row g + 8). Tiles in shared memory are row-major with a pitch of D + 16
// bytes' worth of elements, so the 8 rows one ldmatrix (or one quarter-warp's
// loads) reads fall in distinct banks.
//
// Products (A from registers or shared memory, B from shared memory):
//   gemm_nk: acc (16 x 8NB) += A (16 x D) * B^T, B an n-major tile (8NB rows
//            of D): S = Q K^T in K1; S = Q K^T and dP = dO V^T in K2;
//            S^T = K Q^T and dP^T = V dO^T in K3.
//   gemm_pk: acc (16 x D) += P (16 x 8NB, straight from the accumulators of
//            a gemm_nk) * B, B a k-major tile (8NB rows of D): O += P V in K1;
//            dq += dS K in K2; dV += P^T dO and dK += dS^T Q in K3, through
//            add_tile, which keeps float32's long sums accurate (see there).
// An A operand fixed for a whole loop sits in registers (K1's Q, K2's bf16
// Q and dO: ARegs), is split into tf32 pairs once into shared memory (K2's
// float32 Q and dO: ASplit), or is read from shared memory at each use (K3's
// K and V: ASmem).
// bf16 B operands of gemm_pk come through ldmatrix.trans. ldmatrix moves
// 16-bit elements, so for float32 the fragments are read as 32-bit words
// instead, with the k index of each 8-wide step permuted (kk = t <-> column
// 2t, kk = t + 4 <-> column 2t + 1, the same permutation on both operands):
// that makes an accumulator pair (2t, 2t + 1) an A fragment as it stands and
// the Q and K reads float2 loads.
//
// The masking rule of the attention kernels' score epilogue (the key flags,
// the table slice, the causal mask and exp(x - m)) sits at the end, so K1,
// K2 and K3 form their scores alike.
//
// Why mma.sync and cp.async, not wgmma and TMA: this is the kernels' first
// tensor-core design, and mma.sync's per-warp fragments let the bias, mask
// and online-softmax epilogue work on registers with the layouts above and
// with no warpgroup synchronisation; wgmma (64-row warpgroup tiles, operands
// in swizzled shared memory), TMA and warp specialisation are the next step
// once this design has numbers.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace tc {

// ---- PTX primitives: everything below is written in terms of these. ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a * b: m16n8k16, bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b: m16n8k8, tf32 inputs, float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 2^x by the SFU, subnormal results flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// four 8x8 16-bit matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// 16 bytes global -> shared, asynchronously; zeros when !full (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0) : "memory");
}

// 4 bytes global -> shared, asynchronously; zero when !full
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits for every copy this thread issued; a __syncthreads() then shows them to the block
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the named barrier `id` (1 to 15; 0 is __syncthreads') of `count` threads,
// whole warps
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// the two halves of a thread-block cluster's barrier (every thread of every
// block of the cluster arrives, then waits; a thread alternates the two).
// The release arrive and the acquire wait make each block's shared-memory
// stores before it visible to the cluster after it; a relaxed arrive orders
// nothing, for a barrier that only says the reads before it are done.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---- Fragments and products, built from the primitives above. ----

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// row pitch, in elements, of a tile of D-wide rows: D + 16 bytes
template <typename T, int D>
constexpr int pitch() { return D + 16 / (int)sizeof(T); }

template <typename T> struct Frag;

template <> struct Frag<__nv_bfloat16> {
  static constexpr int K = 16;  // the k of one mma
  struct A { uint32_t x[4]; };
  struct B { uint32_t x[2]; };
};

template <> struct Frag<float> {
  static constexpr int K = 8;
  struct A { uint32_t hi[4], lo[4]; };  // big and small tf32 parts
  struct B { uint32_t hi[2], lo[2]; };
};

// x rounded to the nearest tf32, ties away from zero, as a 32-bit pattern:
// half a tf32 ulp (bit 12) added to the magnitude's bits, the 13 low bits
// cleared. For finite x these are the bits of cvt.rna.tf32.f32, by two
// integer ops at the full ALU rate, where a conversion issues at a quarter
// of it (float32 K1, K2 and K3 split every operand they read; PERF.md says
// what this saved). Built with -DMMA_TF32_CVT (for tests and timing only)
// it is the conversion instruction.
__device__ __forceinline__ uint32_t to_tf32(float x) {
#ifdef MMA_TF32_CVT
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
#else
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
#endif
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d0 += a b0 and d1 += a b1; float32's three products alternate between the
// two accumulators, so neither waits on its own chain
__device__ __forceinline__ void mma2(float (&d0)[4], float (&d1)[4],
                                     const Frag<__nv_bfloat16>::A& a,
                                     const Frag<__nv_bfloat16>::B (&b)[2]) {
  mma_bf16(d0, a.x, b[0].x);
  mma_bf16(d1, a.x, b[1].x);
}

__device__ __forceinline__ void mma2(float (&d0)[4], float (&d1)[4], const Frag<float>::A& a,
                                     const Frag<float>::B (&b)[2]) {
#ifndef MMA_TF32_ONE_PASS
  mma_tf32(d0, a.hi, b[0].lo);
  mma_tf32(d1, a.hi, b[1].lo);
  mma_tf32(d0, a.lo, b[0].hi);
  mma_tf32(d1, a.lo, b[1].hi);
#endif
  mma_tf32(d0, a.hi, b[0].hi);
  mma_tf32(d1, a.hi, b[1].hi);
}

// A of k-step ks from rows 0..15 of a row-major tile s
__device__ __forceinline__ void load_a(Frag<__nv_bfloat16>::A& a, const __nv_bfloat16* s,
                                       int pitch, int ks) {
  const int l = lane_id(), mi = l >> 3;
  ldsm_x4(a.x, s + ((mi & 1) * 8 + (l & 7)) * pitch + ks * 16 + (mi >> 1) * 8);
}

__device__ __forceinline__ void load_a(Frag<float>::A& a, const float* s, int pitch, int ks) {
  const int l = lane_id(), g = l >> 2, t = l & 3;
  const float2 r0 = *reinterpret_cast<const float2*>(s + g * pitch + ks * 8 + 2 * t);
  const float2 r1 = *reinterpret_cast<const float2*>(s + (g + 8) * pitch + ks * 8 + 2 * t);
  split(r0.x, a.hi[0], a.lo[0]);
  split(r1.x, a.hi[1], a.lo[1]);
  split(r0.y, a.hi[2], a.lo[2]);
  split(r1.y, a.hi[3], a.lo[3]);
}

// B of n-blocks j and j + 1 at k-step ks from an n-major tile s[n][k]
__device__ __forceinline__ void load_b_nk(Frag<__nv_bfloat16>::B (&b)[2],
                                          const __nv_bfloat16* s, int pitch, int j, int ks) {
  const int l = lane_id(), mi = l >> 3;
  uint32_t r[4];
  ldsm_x4(r, s + (8 * j + (mi >> 1) * 8 + (l & 7)) * pitch + ks * 16 + (mi & 1) * 8);
  b[0].x[0] = r[0];
  b[0].x[1] = r[1];
  b[1].x[0] = r[2];
  b[1].x[1] = r[3];
}

__device__ __forceinline__ void load_b_nk(Frag<float>::B (&b)[2], const float* s, int pitch,
                                          int j, int ks) {
  const int l = lane_id(), g = l >> 2, t = l & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 r = *reinterpret_cast<const float2*>(s + (8 * (j + i) + g) * pitch + ks * 8
                                                      + 2 * t);
    split(r.x, b[i].hi[0], b[i].lo[0]);
    split(r.y, b[i].hi[1], b[i].lo[1]);
  }
}

// B of n-blocks n and n + 1 at k-step ks from a k-major tile s[k][n]
__device__ __forceinline__ void load_b_kn(Frag<__nv_bfloat16>::B (&b)[2],
                                          const __nv_bfloat16* s, int pitch, int ks, int n) {
  const int l = lane_id(), mi = l >> 3;
  uint32_t r[4];
  ldsm_x4_t(r, s + (ks * 16 + (mi & 1) * 8 + (l & 7)) * pitch + 8 * n + (mi >> 1) * 8);
  b[0].x[0] = r[0];
  b[0].x[1] = r[1];
  b[1].x[0] = r[2];
  b[1].x[1] = r[3];
}

__device__ __forceinline__ void load_b_kn(Frag<float>::B (&b)[2], const float* s, int pitch,
                                          int ks, int n) {
  const int l = lane_id(), g = l >> 2, t = l & 3;
  const float* r0 = s + (ks * 8 + 2 * t) * pitch + 8 * n + g;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    split(r0[8 * i], b[i].hi[0], b[i].lo[0]);
    split(r0[pitch + 8 * i], b[i].hi[1], b[i].lo[1]);
  }
}

// A of k-step ks from accumulators p (16 x 8NB in the C layout), kept in registers
template <int NB>
__device__ __forceinline__ void a_from_acc(Frag<__nv_bfloat16>::A& a, const float (&p)[NB][4],
                                           int ks) {
  a.x[0] = pack_bf16(p[2 * ks][0], p[2 * ks][1]);
  a.x[1] = pack_bf16(p[2 * ks][2], p[2 * ks][3]);
  a.x[2] = pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]);
  a.x[3] = pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3]);
}

template <int NB>
__device__ __forceinline__ void a_from_acc(Frag<float>::A& a, const float (&p)[NB][4], int ks) {
  split(p[ks][0], a.hi[0], a.lo[0]);
  split(p[ks][2], a.hi[1], a.lo[1]);
  split(p[ks][1], a.hi[2], a.lo[2]);
  split(p[ks][3], a.hi[3], a.lo[3]);
}

// A operand held in registers for a whole loop (K1's Q)
template <typename T, int D>
struct ARegs {
  typename Frag<T>::A f[D / Frag<T>::K];
  __device__ __forceinline__ void load(const T* s, int pitch) {
#pragma unroll
    for (int ks = 0; ks < D / Frag<T>::K; ++ks) load_a(f[ks], s, pitch, ks);
  }
  __device__ __forceinline__ void get(typename Frag<T>::A& a, int ks) const { a = f[ks]; }
};

// A operand split into tf32 pairs once and kept in shared memory, in
// fragment order (K2's float32 Q and dO: registers for both would not fit).
// Each k-step holds 32 lanes x 16 bytes of big parts, then of small parts,
// so a lane reads its fragment by two conflict-free 16-byte loads. One warp
// loads it; the warps that share it read it after a barrier.
template <int D>
struct ASplit {
  static constexpr size_t bytes = (size_t)D / 8 * 64 * sizeof(uint4);  // one warp's
  uint4* s;  // this warp's region
  __device__ __forceinline__ void load(const float* src, int pitch) {
    const int l = lane_id();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      Frag<float>::A a;
      load_a(a, src, pitch, ks);
      s[ks * 64 + l] = make_uint4(a.hi[0], a.hi[1], a.hi[2], a.hi[3]);
      s[ks * 64 + 32 + l] = make_uint4(a.lo[0], a.lo[1], a.lo[2], a.lo[3]);
    }
  }
  __device__ __forceinline__ void get(Frag<float>::A& a, int ks) const {
    const int l = lane_id();
    const uint4 hi = s[ks * 64 + l], lo = s[ks * 64 + 32 + l];
    a.hi[0] = hi.x, a.hi[1] = hi.y, a.hi[2] = hi.z, a.hi[3] = hi.w;
    a.lo[0] = lo.x, a.lo[1] = lo.y, a.lo[2] = lo.z, a.lo[3] = lo.w;
  }
};

// the A operand a warp keeps for a whole loop: registers in bf16, split
// pairs in `bytes` of shared memory per warp in float32
template <typename T, int D> struct AFixed {
  using type = ARegs<T, D>;
  static constexpr size_t bytes = 0;
};
template <int D> struct AFixed<float, D> {
  using type = ASplit<D>;
  static constexpr size_t bytes = ASplit<D>::bytes;
};

// A operand read from shared memory at each use (K3's K and V)
template <typename T>
struct ASmem {
  const T* s;
  int pitch;
  __device__ __forceinline__ void get(typename Frag<T>::A& a, int ks) const {
    load_a(a, s, pitch, ks);
  }
};

// acc (16 x 8NB) += A (16 x D) * B^T, B an n-major tile of 8NB rows at s
template <typename T, int D, int NB, class ASrc>
__device__ __forceinline__ void gemm_nk(float (&acc)[NB][4], const ASrc& a, const T* s,
                                        int pitch) {
  static_assert(NB % 2 == 0, "n-blocks go in pairs");
#pragma unroll
  for (int ks = 0; ks < D / Frag<T>::K; ++ks) {
    typename Frag<T>::A fa;
    a.get(fa, ks);
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
      typename Frag<T>::B fb[2];
      load_b_nk(fb, s, pitch, j, ks);
      mma2(acc[j], acc[j + 1], fa, fb);
    }
  }
}

// acc (16 x D) += P (16 x 8NB, accumulators) * B, B a k-major tile of 8NB rows at s
template <typename T, int D, int NB>
__device__ __forceinline__ void gemm_pk(float (&acc)[D / 8][4], const float (&p)[NB][4],
                                        const T* s, int pitch) {
  static_assert(D % 16 == 0, "n-blocks go in pairs");
#pragma unroll
  for (int ks = 0; ks < 8 * NB / Frag<T>::K; ++ks) {
    typename Frag<T>::A fa;
    a_from_acc<NB>(fa, p, ks);
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      typename Frag<T>::B fb[2];
      load_b_kn(fb, s, pitch, ks, n);
      mma2(acc[n], acc[n + 1], fa, fb);
    }
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (&acc)[NB][4]) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// sum (16 x D) = sum * scale + P B. The tensor cores' float32 accumulation
// is not rounded to nearest (each product is aligned to the accumulator and
// its low bits dropped), so a long running sum inside the mma (K3's dk over
// 8 heads x 2049 queries, 3 products each in 3xTF32) loses up to an ulp of
// the sum per product: it read 2.4e-5 of a float64 reference on the H100. In float32 a tile's 64-deep product therefore
// starts from zero, losing an ulp of the tile's own sum at most, and the
// tiles add with rounding to nearest; bf16's tolerance needs none of that.
template <typename T, int D, int NB>
__device__ __forceinline__ void add_tile(float (&sum)[D / 8][4], const float (&p)[NB][4],
                                         const T* s, int pitch, const float (&scale)[2]) {
  if constexpr (sizeof(T) == 4) {
    float part[D / 8][4];
    zero(part);
    gemm_pk<T, D, NB>(part, p, s, pitch);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[j][e] = sum[j][e] * scale[e / 2] + part[j][e];
  } else {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[j][e] *= scale[e / 2];
    gemm_pk<T, D, NB>(sum, p, s, pitch);
  }
}

// rows r0 .. r0 + R - 1 of a (rows, D) row-major matrix into a tile at dst
// (pitch elements), by cp.async of 16 bytes; rows past `rows` are zeros.
// Every thread of the block (NT of them) takes a share.
template <typename T, int D, int R, int NT>
__device__ __forceinline__ void cp_tile(T* dst, int pitch, const T* src, int r0, int rows) {
  constexpr int E = 16 / (int)sizeof(T);  // elements per copy
  constexpr int CH = D / E;               // copies per row
  for (int i = threadIdx.x; i < R * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * E;
    const bool in = r0 + r < rows;
    cp_async16(dst + r * pitch + c, src + (size_t)(in ? r0 + r : 0) * D + c, in);
  }
}

// the R x C block at (r0, c0) of a (rows, cols) float32 plane into a tile at
// dst (pitch floats), by cp.async of 4 bytes (cols need not keep 16-byte
// alignment); zeros outside the plane
template <int R, int C, int NT>
__device__ __forceinline__ void cp_block_f32(float* dst, int pitch, const float* src, int r0,
                                             int c0, int rows, int cols) {
  static_assert(NT % C == 0, "a fixed column per thread");
  constexpr int STEP = NT / C;  // rows apart
  const int c = threadIdx.x % C, r1 = threadIdx.x / C;
  const bool col_in = c0 + c < cols;
  const float* from = src + (size_t)(r0 + r1) * cols + c0 + c;
  float* to = dst + r1 * pitch + c;
#pragma unroll 4
  for (int r = r1; r < R; r += STEP) {
    const bool in = col_in && r0 + r < rows;
    cp_async4(to, in ? from : src, in);
    from += (size_t)STEP * cols;
    to += STEP * pitch;
  }
}

// two adjacent elements of a row, in the output type
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// accumulators (16 x 8NB in the C layout) into rows 0..15 of a row-major
// float32 tile at s (pitch floats; with a pitch of 8 mod 32 the float2
// stores meet no bank conflict)
template <int NB>
__device__ __forceinline__ void store_acc(float* s, int pitch, const float (&acc)[NB][4]) {
  const int l = lane_id(), g = l >> 2, t = l & 3;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    store2(s + g * pitch + 8 * j + 2 * t, acc[j][0], acc[j][1]);
    store2(s + (g + 8) * pitch + 8 * j + 2 * t, acc[j][2], acc[j][3]);
  }
}

// ---- The score epilogue's masking rule, as the TPU kernel's. ----

constexpr float NEG = -1e30f;  // a masked score
constexpr float LOG2E = 1.4426950408889634f;

// the flag of key kp of batch row b: 0 attended, NEG masked, -inf past m
__device__ __forceinline__ float key_flag(const int8_t* kmask, int b, int m, int kp) {
  return kp >= m ? -INFINITY : (kmask != nullptr && kmask[(size_t)b * m + kp] == 0) ? NEG : 0.f;
}

// entry i of the (2n-1, heads) table's slice for the tile at (q0, k0), bk
// keys wide: the bias of (q0 + r, k0 + c) is entry r - c + bk - 1
__device__ __forceinline__ float tab_entry(const float* tab, int q0, int k0, int bk, int i,
                                           int n, int heads, int h) {
  const int idx = q0 - k0 - (bk - 1) + i + n - 1;
  return idx >= 0 && idx < 2 * n - 1 ? tab[(size_t)idx * heads + h] : 0.f;
}

// the score of one (query, key) from x = scale q.k + bias: the key's flag
// where it has one, NEG above the causal diagonal
__device__ __forceinline__ float score(float x, float flag, bool above) {
  return flag != 0.f ? flag : above ? NEG : x;
}

// exp(x - m) as 2^((x - m) log2 e), exactly 1 where x == m. A row whose keys
// so far are all masked has x == m == NEG, and exp(s - m) weighs those keys
// alike (then a later real key rescales them away, or lse says the row is
// empty); 2^(x log2 e - m log2 e) by one FMA would take the rounding error of
// m log2 e there, up to ~1e23, for the exponent, and give +inf.
__device__ __forceinline__ float exp_rel(float x, float m) { return ex2((x - m) * LOG2E); }

}  // namespace tc
