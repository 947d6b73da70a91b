// Tensor-core building blocks of the port's attention kernels (sm_90a):
// cp.async copies of row tiles into shared memory, and warp-level
// `mma.sync` products on fragments read from shared memory or taken from
// an accumulator, for fp32 inputs (3xTF32) and bf16 inputs (bf16 mma).
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8/k16"):
// lane = 4 g + t (g = groupID 0..7, t = thread in group 0..3).  An
// accumulator C of a 16 x 8 tile holds (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1) in c[0..3].
//   fp32  m16n8k8 .tf32: A (16 x 8) a0 (g, t), a1 (g+8, t), a2 (g, t+4),
//         a3 (g+8, t+4); B (8 x 8) b0 (k t, n g), b1 (k t+4, n g).
//   bf16  m16n8k16: A a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//         a3 (g+8, 2t+8..); B b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g);
//         two bf16 a register, the lower index in the lower half.
//
// 3xTF32: an fp32 operand x is split as hi = tf32(x), lo = tf32(x - hi)
// (round to nearest, ties away, as `cvt.rna`), and a b = hi_a hi_b + hi_a lo_b
// + lo_a hi_b with fp32 accumulation, which drops only lo_a lo_b (~2^-22 of
// the product).  One plain TF32 product keeps 11 bits (~2^-11): too coarse
// for the fp32 paths, which are held to the JAX package at 1e-5.
// `tf32_split_plain` in ops/attention_fullrow.py is the same split in torch.
//
// A product whose A operand is an accumulator (p v, ds k, pd^T do, ds^T q)
// takes A straight from registers.  bf16: the k16 step over accumulator
// tiles j = 2s, 2s+1 is exactly the A fragment.  tf32: the k8 step over
// tile j has its columns 2t, 2t+1 where A wants t, t+4, so the sum over k
// is taken in the permuted order k t <-> column 2t, k t+4 <-> column 2t+1,
// and the B operand is read in the same order (`load_b_kmajor`).  A sum
// over k does not depend on its order, so no shuffle is needed.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"

namespace unicore {

// ---- cp.async -------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared row stride, in elements, of a tile of Dp-wide rows: 16 bytes of
// pad a row, so the fragment reads below fall on 32 distinct banks and
// every row starts 16-byte aligned for cp.async.
template <typename T>
__host__ __device__ constexpr int tile_ld(int Dp) {
  return Dp + 16 / (int)sizeof(T);
}

// `rows` rows of a row-major (., D) matrix into shared memory (row stride
// ld), columns [D, Dp) zero-filled, by `nthreads` threads.  With
// `vec` (D * sizeof(T) a multiple of 16, so every row starts 16-byte
// aligned) the copy is cp.async in 16-byte chunks, to be waited for with
// cp_async_wait; otherwise plain loads and stores, visible after the
// next __syncthreads().
template <typename T>
__device__ __forceinline__ void load_rows_async(T* dst, int ld, const T* __restrict__ src,
                                                int rows, int D, int Dp, bool vec,
                                                int nthreads) {
  if (vec) {
    constexpr int kChunk = 16 / sizeof(T);  // elements a chunk
    const int cpr = Dp / kChunk;            // chunks a row
    for (int c = threadIdx.x; c < rows * cpr; c += nthreads) {
      const int r = c / cpr, col = (c - r * cpr) * kChunk;
      const bool ok = col < D;  // D is a multiple of kChunk here
      cp_async16(dst + r * ld + col, ok ? src + (size_t)r * D + col : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * Dp; e += nthreads) {
      const int r = e / Dp, col = e - r * Dp;
      dst[r * ld + col] = col < D ? src[(size_t)r * D + col] : from_f<T>(0.f);
    }
  }
}

// ---- fragments and products -------------------------------------------------

// x rounded to TF32, to nearest with ties away from zero: the value of
// `cvt.rna.tf32.f32`, computed with two integer operations on the bits
// (add half an ulp of the 10-bit mantissa, clear the 13 bits below it),
// which issue at a higher rate than the conversion.  Finite x only.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// hi = tf32(x); lo = tf32(x - hi), both rounded to nearest, ties away.  lo
// goes to the mma with only the half ulp added: the mma reads a .tf32
// operand's top 19 bits, so that is the same rounding with one integer
// operation fewer (lo is at most 2^-11 of x in magnitude).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Per-type products.  A and B fragments hold tf32 hi/lo halves for fp32
// inputs and packed bf16 pairs for bf16; kK is the k depth of one mma.
template <typename T> struct Mma;

template <> struct Mma<float> {
  static constexpr int kK = 8;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };

  // A rows row0.. row0+15 of a row-major shared tile, k columns k0..k0+7
  static __device__ __forceinline__ A load_a(const float* s, int ld, int row0, int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* p = s + (row0 + g) * ld + k0 + t;
    A a;
    split_tf32(p[0], a.hi[0], a.lo[0]);
    split_tf32(p[8 * ld], a.hi[1], a.lo[1]);
    split_tf32(p[4], a.hi[2], a.lo[2]);
    split_tf32(p[8 * ld + 4], a.hi[3], a.lo[3]);
    return a;
  }
  // B[k][n] = M[n][k] (M row-major in shared memory, one row per n)
  static __device__ __forceinline__ B load_b_nmajor(const float* s, int ld, int n0, int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* p = s + (n0 + g) * ld + k0 + t;
    B b;
    split_tf32(p[0], b.hi[0], b.lo[0]);
    split_tf32(p[4], b.hi[1], b.lo[1]);
    return b;
  }
  // B[k][n] = M[k][n] (one row per k), k in the permuted order of an
  // accumulator A: b0 from row k0 + 2t, b1 from row k0 + 2t + 1
  static __device__ __forceinline__ B load_b_kmajor(const float* s, int ld, int k0, int n0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* p = s + (k0 + 2 * t) * ld + n0 + g;
    B b;
    split_tf32(p[0], b.hi[0], b.lo[0]);
    split_tf32(p[ld], b.hi[1], b.lo[1]);
    return b;
  }
  // A from accumulator tiles: k step `ks` covers accumulator tile ks
  template <int NT>
  static __device__ __forceinline__ A a_from_acc(const float (&c)[NT][4], int ks) {
    A a;
    split_tf32(c[ks][0], a.hi[0], a.lo[0]);  // (g, 2t)    -> k t
    split_tf32(c[ks][2], a.hi[1], a.lo[1]);  // (g+8, 2t)  -> k t
    split_tf32(c[ks][1], a.hi[2], a.lo[2]);  // (g, 2t+1)  -> k t+4
    split_tf32(c[ks][3], a.hi[3], a.lo[3]);  // (g+8, 2t+1)
    return a;
  }
  // c += a b, 3xTF32: the small cross terms first, then the big one
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
};

template <> struct Mma<__nv_bfloat16> {
  static constexpr int kK = 16;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  using T = __nv_bfloat16;

  static __device__ __forceinline__ uint32_t word(const T* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ A load_a(const T* s, int ld, int row0, int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const T* p = s + (row0 + g) * ld + k0 + 2 * t;
    return A{{word(p), word(p + 8 * ld), word(p + 8), word(p + 8 * ld + 8)}};
  }
  static __device__ __forceinline__ B load_b_nmajor(const T* s, int ld, int n0, int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const T* p = s + (n0 + g) * ld + k0 + 2 * t;
    return B{{word(p), word(p + 8)}};
  }
  static __device__ __forceinline__ B load_b_kmajor(const T* s, int ld, int k0, int n0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const T* p = s + (k0 + 2 * t) * ld + n0 + g;
    return B{{pack_bf16(p[0], p[ld]), pack_bf16(p[8 * ld], p[9 * ld])}};
  }
  // k step `ks` covers accumulator tiles 2 ks and 2 ks + 1 (values already
  // rounded to bf16, so the pack is exact)
  template <int NT>
  static __device__ __forceinline__ A a_from_acc(const float (&c)[NT][4], int ks) {
    return A{{pack_bf16(c[2 * ks][0], c[2 * ks][1]), pack_bf16(c[2 * ks][2], c[2 * ks][3]),
              pack_bf16(c[2 * ks + 1][0], c[2 * ks + 1][1]),
              pack_bf16(c[2 * ks + 1][2], c[2 * ks + 1][3])}};
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    mma_bf16(c, a.r, b.r);
  }
};

}  // namespace unicore
