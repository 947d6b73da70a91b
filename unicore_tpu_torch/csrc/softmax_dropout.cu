// Fused softmax(+mask)(+bias)(+dropout), forward and backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of unicore_tpu/ops/softmax_dropout_pallas.py, the
// two halves of the `jax.custom_vjp` `_sd` (:322), both launched by `_run`
// (:254):
//   `_fwd_kernel` (:223), with its int8/int32 dequant `scale_ref` variant
//                 (`_row_probs` :204-220, launched by
//                 `quant_softmax_dropout_pallas` :443, `pallas_call` :305)
//                 through `unicore_quant_softmax_dropout_fwd`;
//   `_bwd_kernel` (:234).
//
// What they compute, per row of x viewed as (R, M, L) -- the softmax runs
// over the last dim in fp32 whatever the storage type (`_row_probs` :204):
//   forward   v = x (+ mask) (+ bias); p = exp(v - rowmax(v)) / rowsum(..);
//             y = p cast to the output type; with dropout
//             y = keep ? y / (1 - rate) : 0, the division done on the cast
//             value with (1 - rate) rounded to the output type, and the
//             quotient cast again (:226-231: `y / (1.0 - rate)` in the
//             output type);
//   backward  p recomputed exactly as the forward computes it and the keep
//             mask regenerated; dp = keep ? dy * (1 / (1 - rate)) : 0 in
//             fp32; ds = p * (dp - rowsum(dp * p)), written in fp32 (:236-247).
//             dx is ds cast to x's type and the extras' gradients are fp32
//             sums of ds over their broadcast dims, taken outside the kernel
//             as the JAX `_sd_bwd` (:335) takes them.
// Quantized input: x is int8, or the int32 sum of an int8 q.k^T product, and
// one fp32 `scale` read through a device pointer (no host sync) dequantizes
// it in the row pass: v = x * scale (+ mask) (+ bias), rounded before the
// adds; y is fp32.  The fp32 scores never exist as a tensor.  At BERT-base
// serving, (8, 12, 512, 512) int32 scores with the (8, 1, 1, 512) key mask
// and the (1, 12, 512, 512) rel-pos bias read 4 + 4 bytes and write 4 an
// element: about 64 us at 3.35 TB/s.
// A -inf in v (the Uni-Mol pair bias holds -inf at padded keys from its
// second layer on) gives p = 0 and ds = 0 there; the row max stays finite as
// long as one entry of the row is.
//
// Extras (mask, bias) are never broadcast in memory: each is read at
//   base(r) + m * row_stride + col * col_stride
// where base(r) decomposes the flattened leading row r over a list of
// leading dims, each with its own element stride (0 where the extra is
// broadcast).  The wrapper (ops/softmax_dropout.py) builds that list from
// `plan_extra`'s two layouts: `bcast` (every dim full or 1, the Evoformer's
// mixed per-dim broadcast included: the input's leading dims with the
// extra's strides) and `tile` (whole (M, L) slabs repeated: leading dims
// (R / rx, rx) with strides (0, M * L)) -- the index map of
// `_extra_row_index` (:112).  Extras are fp32 or bf16, read as fp32.
//
// Dropout: the TPU's `prng_random_bits` cannot be reproduced off the TPU, so
// the keep bits come from Philox4x32-10 (common.cuh) keyed on the int32 seed
// with the counter (col / 4, m, r, 0): one call gives four neighbouring
// columns' bits, and the backward regenerates the forward's mask without
// storing it.  Keep when bits >= min(int(rate * 2^32), 2^32 - 1), the TPU
// kernels' rule.  `philox_keep_plain(1, R, M, L, seed, rate)` in
// ops/attention_fullrow.py computes the same bits in torch integer ops.
//
// What bounds them on this card.  The forward reads x and writes y, the
// backward reads x and dy and writes fp32 ds: at the Uni-Mol training shape,
// fp32 (R, M, L) = (16 * 64, 128, 128), 134 MB and 201 MB, 0.040 and 0.060 ms
// at 3.35 TB/s.  ~10 flops an element are far below the H100's 20 fp32
// flops a byte, but the dropout adds a quarter of a Philox4x32-10 call an
// element: ten rounds of two 32-bit multiplies (hi and lo) and their xors,
// ~90 integer instructions a call, 4.2 M calls and ~12 M warp instructions
// at that shape, ~13 us of issue on 528 schedulers at 1.755 GHz -- a third
// of the bytes bound.  So the forward at rate 0.1 is bound by bytes only if
// the Philox work hides under the memory traffic.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (device ms at that shape,
// fp32; tools/fwd_ab.py and chip_smoke.py phase 3): the kernel this one
// replaces took 0.0495 at rate 0 (torch.softmax 0.0469) and 0.088-0.090 at
// rate 0.1: the dropout cost 0.039 ms (its Philox drawn after the row's two
// reductions, an IEEE division an element, one row a warp).  This one:
// 0.044-0.047 at rate 0 (torch.softmax 0.047), 0.043-0.048 at rate 0.1,
// 84-92% of the bytes bound; bf16 at rate 0.1 0.038-0.040; the backward
// 0.068 (0.071 before).
//
// What the design does about it: one pass over memory each way, the row in
// registers, and as many bytes in flight as the card needs.
//   * Rows up to 1024 long take one warp each (four warps a block): lane l
//     holds the quads 4l..4l+3 of every 128-column chunk, one Philox call's
//     worth.  At L = 128 a warp takes four rows and at L = 256 two, and
//     issues every row's loads before any reduction, so 2 KB of fp32 a warp
//     are in flight where one row gave 512 bytes.  Longer rows (up to the
//     gate's 8192) take a 256-thread block each, eight quads a thread in
//     registers.
//   * Each quad is one vector access: 16 bytes for fp32 and int32, 8 for
//     bf16, 4 for int8 (the wrappers hand over 16-byte aligned tensors).
//   * The keep bits depend on (r, m, col), not on x: they are drawn after
//     the loads are issued and before the first use of a loaded value, so
//     the Philox work overlaps the loads.
//   * No division an element: exp is ex2.approx of (v - max) log2(e) as one
//     FMA (the rounding of max log2(e) shifts every exponent of a row alike
//     and cancels in the normalisation), the row is normalised by one
//     correctly rounded reciprocal of its sum, and the dropout's y / div is
//     y * (1 / div) with one FMA correction, which is the correctly rounded
//     quotient (Markstein).  p differs from the JAX `e / sum` by a few fp32
//     ulps, inside the 1e-6 of chip_smoke.py's TOL["softmax"]; forward and
//     backward share load_rows, combine and row_probs, so the backward recomputes
//     exactly the forward's p, as the JAX kernels share `_row_probs`.
// Each choice against a copy with it undone (tools/fwd_ab.py, rate 0.1,
// fp32 / bf16, same card): the dropout's IEEE division 0.0561 / 0.0528
// against 0.0466 / 0.0393; one row a warp at L = 128 0.0493 / 0.0492; expf
// 0.0472 / 0.0438.  Four 4-byte accesses a quad (fp32 0.0474) and
// streaming cache hints on x and y (fp32 0.0476) measured within 2% of the
// 16-byte vectors with the default cache policy: the hints are not taken.
// Offsets are 64-bit; the grid's x dimension takes up to 2^31 - 1 blocks,
// far beyond R * M at B = 128, H = 64, L = 512.
#include <cstdint>

#include <math_constants.h>

#include "common.cuh"

namespace {

using namespace unicore;

constexpr int kMaxLead = 8;        // leading dims an extra's index map may take
constexpr int kMaxL = 8192;        // the gate's longest row
constexpr int kWarpRowMaxL = 1024; // rows up to this long take one warp
constexpr int kWarpsPerBlock = 4;
constexpr int kRowThreads = 256;   // threads of a long row's block
constexpr int kBlockQuads = kMaxL / (4 * kRowThreads);  // quads a thread holds of a long row
constexpr float kLog2e = 1.4426950408889634f;

// rows a warp takes at L = 128 CH: enough loads in flight at short rows
__host__ __device__ constexpr int rows_per_warp(int CH) {
  return CH <= 2 ? 4 / CH : 1;
}

struct Extra {
  const void* ptr;  // null: no extra
  int bf16;         // 0: fp32, 1: bf16
  int nlead;
  long long dims[kMaxLead];
  long long gstride[kMaxLead];  // elements per step of each dim; 0 = broadcast
  long long row_stride;         // elements per input row m; 0 = broadcast
  int col_stride;               // 1, or 0 when broadcast over columns
};

struct Drop {
  int on;
  uint32_t seed;
  uint32_t threshold;  // keep when bits >= threshold
  float div;           // forward: (1 - rate) rounded to the output type
  float scale;         // backward: fp32(1 / (1 - rate))
};

__device__ __forceinline__ long long extra_base(const Extra& e, long long r, int m) {
  long long g = 0;
  for (int d = e.nlead - 1; d >= 0; --d) {
    const long long n = e.dims[d];
    g += (r % n) * e.gstride[d];
    r /= n;
  }
  return g + (long long)m * e.row_stride;
}

// ---- quads: four neighbouring columns, one vector access ------------------

__device__ __forceinline__ void load_quad(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load_quad(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xFFFF0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xFFFF0000u);
}

__device__ __forceinline__ void load_quad(const int8_t* p, float (&v)[4]) {
  const int t = *reinterpret_cast<const int*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = (float)((int)((unsigned)t << (24 - 8 * j)) >> 24);
}

__device__ __forceinline__ void load_quad(const int32_t* p, float (&v)[4]) {
  const int4 t = *reinterpret_cast<const int4*>(p);
  v[0] = to_f(t.x);
  v[1] = to_f(t.y);
  v[2] = to_f(t.z);
  v[3] = to_f(t.w);
}

__device__ __forceinline__ void store_quad(float* p, const float (&y)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
}

// y already holds bf16 values: their top halves are the bf16 bits
__device__ __forceinline__ void store_quad(__nv_bfloat16* p, const float (&y)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2((__float_as_uint(y[0]) >> 16) | (__float_as_uint(y[1]) & 0xFFFF0000u),
                 (__float_as_uint(y[2]) >> 16) | (__float_as_uint(y[3]) & 0xFFFF0000u));
}

// an extra at the four columns c0..c0+3 of the row at `base`
__device__ __forceinline__ void extra_quad(const Extra& e, long long base, int c0,
                                           float (&v)[4]) {
  if (e.col_stride == 0) {
    const float s = e.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(e.ptr)[base])
                           : static_cast<const float*>(e.ptr)[base];
    v[0] = v[1] = v[2] = v[3] = s;
  } else if (e.bf16) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(e.ptr) + base + c0));
    v[0] = __uint_as_float(t.x << 16);
    v[1] = __uint_as_float(t.x & 0xFFFF0000u);
    v[2] = __uint_as_float(t.y << 16);
    v[3] = __uint_as_float(t.y & 0xFFFF0000u);
  } else {
    const float4 t = __ldg(reinterpret_cast<const float4*>(
        static_cast<const float*>(e.ptr) + base + c0));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
}

// ---- rows: v = x * sc (+ mask) (+ bias), then their softmax ---------------

// What a thread loads of RW rows: quad q of row i starts at column
// q * qstride + off (lane l of a warp: 128 q + 4 l; thread t of a long row's
// block: 1024 q + 4 t); a quad at or past L (a long row's last columns) is
// read at `off` and later set to -inf.  Rows past `rows` read the last row
// and are never stored.  Every load is issued before any value is used.
template <int RW, int NQ>
struct RowsIn {
  float x[RW][NQ][4], mk[RW][NQ][4], bs[RW][NQ][4];
};

template <typename TI, int RW, int NQ>
__device__ __forceinline__ void load_rows(RowsIn<RW, NQ>& in, const TI* x, long long row0,
                                          long long rows, int L, const Extra& mask,
                                          const Extra& bias, const long long (&r)[RW],
                                          const int (&m)[RW], int off, int qstride) {
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const TI* xr = x + (row0 + i < rows ? row0 + i : rows - 1) * L;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c0 = q * qstride + off;
      load_quad(xr + (c0 < L ? c0 : off), in.x[i][q]);
    }
  }
  if (mask.ptr != nullptr) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const long long base = extra_base(mask, r[i], m[i]);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int c0 = q * qstride + off;
        extra_quad(mask, base, c0 < L ? c0 : off, in.mk[i][q]);
      }
    }
  }
  if (bias.ptr != nullptr) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const long long base = extra_base(bias, r[i], m[i]);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int c0 = q * qstride + off;
        extra_quad(bias, base, c0 < L ? c0 : off, in.bs[i][q]);
      }
    }
  }
}

// in.x <- v = x * sc (+ mask) (+ bias), -inf past L.  sc is 1 for an
// fp32/bf16 x, where the product is x itself, bit for bit.
template <int RW, int NQ>
__device__ __forceinline__ void combine(RowsIn<RW, NQ>& in, float sc, bool has_mask,
                                        bool has_bias, int L, int off, int qstride) {
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = __fmul_rn(in.x[i][q][j], sc);
        if (has_mask) t += in.mk[i][q][j];
        if (has_bias) t += in.bs[i][q][j];
        in.x[i][q][j] = q * qstride + off < L ? t : -CUDART_INF_F;
      }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct WarpReduce {
  __device__ __forceinline__ float operator()(float v, bool is_max) const {
    return is_max ? warp_max(v) : warp_sum(v);
  }
};

// the block's max (is_max) or sum of v; every thread gets it
struct BlockReduce {
  float* red;  // kRowThreads / 32 + 1 floats of shared memory
  __device__ __forceinline__ float operator()(float v, bool is_max) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = is_max ? warp_max(v) : warp_sum(v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float t = lane < kRowThreads / 32 ? red[lane] : (is_max ? -CUDART_INF_F : 0.f);
      t = is_max ? warp_max(t) : warp_sum(t);
      if (lane == 0) red[kRowThreads / 32] = t;
    }
    __syncthreads();
    const float out = red[kRowThreads / 32];
    __syncthreads();  // red is reused by the next reduction
    return out;
  }
};

// v -> p = softmax over one row, in place, reduced over the row's threads
template <int NQ, typename Reduce>
__device__ __forceinline__ void row_probs(float (&v)[NQ][4], const Reduce& reduce) {
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) mx = fmaxf(mx, v[q][j]);
  mx = reduce(mx, true);
  const float ml = __fmul_rn(mx, kLog2e);
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[q][j] = ex2(__fmaf_rn(v[q][j], kLog2e, -ml));
      s += v[q][j];
    }
  s = reduce(s, false);
  const float rs = __frcp_rn(s);
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) v[q][j] *= rs;
}

// keep bits (bit j: column c0 + j, c0 a multiple of 4) of row (r, m)
__device__ __forceinline__ uint32_t keep_quad(const Drop& dr, long long r, int m, int c0) {
  const uint4 w = philox4x32_10(make_uint4((uint32_t)(c0 >> 2), (uint32_t)m, (uint32_t)r, 0u),
                                dr.seed, 0u);
  return (uint32_t)(w.x >= dr.threshold) | ((uint32_t)(w.y >= dr.threshold) << 1) |
         ((uint32_t)(w.z >= dr.threshold) << 2) | ((uint32_t)(w.w >= dr.threshold) << 3);
}

// y = p rounded to T; with dropout keep ? y / div : 0, the quotient rounded
// to T.  rd = 1 / div correctly rounded: q = y rd and one FMA correction
// give y / div correctly rounded (Markstein), without a division.
template <typename T>
__device__ __forceinline__ float drop_out(const Drop& dr, float rd, float p, bool keep) {
  const float y = round_to<T>(p);
  if (!dr.on) return y;
  if (!keep) return 0.f;
  const float qt = __fmul_rn(y, rd);
  return round_to<T>(__fmaf_rn(__fmaf_rn(-qt, dr.div, y), rd, qt));
}

__device__ __forceinline__ float drop_grad(const Drop& dr, float dy, bool keep) {
  if (!dr.on) return dy;
  return keep ? dy * dr.scale : 0.f;
}

// ---------------------------------------------------------------------------
// the kernels: a row up to 1024 long takes a warp (rows_per_warp(CH) rows
// a warp), a longer one a 256-thread block; both hold their rows in
// registers
// ---------------------------------------------------------------------------

// the (r, m) of rows row0 .. row0 + RW - 1, each one past the last
template <int RW>
__device__ __forceinline__ void row_index(long long row0, int M, long long (&r)[RW],
                                          int (&m)[RW]) {
  r[0] = row0 / M;
  m[0] = (int)(row0 % M);
#pragma unroll
  for (int i = 1; i < RW; ++i) {
    const bool wrap = m[i - 1] + 1 == M;
    r[i] = r[i - 1] + wrap;
    m[i] = wrap ? 0 : m[i - 1] + 1;
  }
}

// keep bits of every quad, drawn after the loads are issued: they need no x
template <int RW, int NQ>
__device__ __forceinline__ void keep_bits(uint32_t (&keep)[RW][NQ], const Drop& dr,
                                          const long long (&r)[RW], const int (&m)[RW], int L,
                                          int off, int qstride) {
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c0 = q * qstride + off;
      keep[i][q] = dr.on && c0 < L ? keep_quad(dr, r[i], m[i], c0) : 0xFu;
    }
}

// TI: the stored input (fp32, bf16, or int8/int32 with `scale`); TO: the
// output (the input's type, fp32 for a quantized input).  RW rows a
// thread group (a warp of NQ chunks of 128 columns, or a long row's block of
// NQ quads a thread)
template <typename TI, typename TO, int RW, int NQ, typename Reduce>
__device__ __forceinline__ void fwd_rows(const TI* __restrict__ x, const float* __restrict__ scale,
                                         const Extra& mask, const Extra& bias,
                                         TO* __restrict__ y, long long row0, long long rows,
                                         int M, int L, int off, int qstride, const Drop& dr,
                                         const Reduce& reduce) {
  long long r[RW];
  int m[RW];
  row_index(row0, M, r, m);
  RowsIn<RW, NQ> in;
  load_rows<TI, RW, NQ>(in, x, row0, rows, L, mask, bias, r, m, off, qstride);
  const float sc = scale != nullptr ? *scale : 1.f;
  uint32_t keep[RW][NQ];
  keep_bits(keep, dr, r, m, L, off, qstride);
  combine(in, sc, mask.ptr != nullptr, bias.ptr != nullptr, L, off, qstride);
  const float rd = dr.on ? __frcp_rn(dr.div) : 1.f;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (row0 + i >= rows) break;
    row_probs<NQ>(in.x[i], reduce);
    TO* yr = y + (row0 + i) * L;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c0 = q * qstride + off;
      if (c0 >= L) break;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = drop_out<TO>(dr, rd, in.x[i][q][j], (keep[i][q] >> j) & 1u);
      store_quad(yr + c0, o);
    }
  }
}

template <typename T, int RW, int NQ, typename Reduce>
__device__ __forceinline__ void bwd_rows(const T* __restrict__ x, const Extra& mask,
                                         const Extra& bias, const T* __restrict__ dy,
                                         float* __restrict__ ds, long long row0, long long rows,
                                         int M, int L, int off, int qstride, const Drop& dr,
                                         const Reduce& reduce) {
  long long r[RW];
  int m[RW];
  row_index(row0, M, r, m);
  RowsIn<RW, NQ> in;
  load_rows<T, RW, NQ>(in, x, row0, rows, L, mask, bias, r, m, off, qstride);
  float g[RW][NQ][4];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const T* gr = dy + (row0 + i < rows ? row0 + i : rows - 1) * L;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c0 = q * qstride + off;
      load_quad(gr + (c0 < L ? c0 : off), g[i][q]);
    }
  }
  uint32_t keep[RW][NQ];
  keep_bits(keep, dr, r, m, L, off, qstride);
  combine(in, 1.f, mask.ptr != nullptr, bias.ptr != nullptr, L, off, qstride);
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (row0 + i >= rows) break;
    row_probs<NQ>(in.x[i], reduce);
    float dot = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in_row = q * qstride + off < L;
        g[i][q][j] = in_row ? drop_grad(dr, g[i][q][j], (keep[i][q] >> j) & 1u) : 0.f;
        dot += g[i][q][j] * in.x[i][q][j];
      }
    dot = reduce(dot, false);
    float* dsr = ds + (row0 + i) * L;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c0 = q * qstride + off;
      if (c0 >= L) break;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = in.x[i][q][j] * (g[i][q][j] - dot);
      store_quad(dsr + c0, o);
    }
  }
}

template <typename TI, typename TO, int CH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
softmax_dropout_fwd_warp(const TI* __restrict__ x, const float* __restrict__ scale,
                         Extra mask, Extra bias, TO* __restrict__ y, long long rows, int M,
                         Drop dr) {
  constexpr int RW = rows_per_warp(CH);
  const long long row0 = ((long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * RW;
  if (row0 >= rows) return;
  fwd_rows<TI, TO, RW, CH>(x, scale, mask, bias, y, row0, rows, M, CH * 128,
                           (threadIdx.x & 31) * 4, 128, dr, WarpReduce{});
}

template <typename T, int CH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
softmax_dropout_bwd_warp(const T* __restrict__ x, Extra mask, Extra bias,
                         const T* __restrict__ dy, float* __restrict__ ds, long long rows,
                         int M, Drop dr) {
  constexpr int RW = rows_per_warp(CH);
  const long long row0 = ((long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * RW;
  if (row0 >= rows) return;
  bwd_rows<T, RW, CH>(x, mask, bias, dy, ds, row0, rows, M, CH * 128, (threadIdx.x & 31) * 4,
                      128, dr, WarpReduce{});
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(kRowThreads)
softmax_dropout_fwd_block(const TI* __restrict__ x, const float* __restrict__ scale,
                          Extra mask, Extra bias, TO* __restrict__ y, int M, int L, Drop dr) {
  __shared__ float red[kRowThreads / 32 + 1];
  fwd_rows<TI, TO, 1, kBlockQuads>(x, scale, mask, bias, y, blockIdx.x, gridDim.x, M, L,
                                   threadIdx.x * 4, 4 * kRowThreads, dr, BlockReduce{red});
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
softmax_dropout_bwd_block(const T* __restrict__ x, Extra mask, Extra bias,
                          const T* __restrict__ dy, float* __restrict__ ds, int M, int L,
                          Drop dr) {
  __shared__ float red[kRowThreads / 32 + 1];
  bwd_rows<T, 1, kBlockQuads>(x, mask, bias, dy, ds, blockIdx.x, gridDim.x, M, L,
                              threadIdx.x * 4, 4 * kRowThreads, dr, BlockReduce{red});
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// the kernels read and write quads as one vector: every row (a multiple of
// 128 elements) starts 16-byte aligned when its tensor does
bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// desc: [dtype (0 fp32, 1 bf16), nlead, row_stride, col_stride, dims[nlead],
// gstride[nlead]]; a null ptr means no extra
bool make_extra(const void* ptr, const long long* desc, Extra* e) {
  *e = Extra{};
  e->ptr = ptr;
  if (ptr == nullptr) return true;
  if (desc == nullptr) return false;
  const long long nlead = desc[1];
  if ((desc[0] != kFloat32 && desc[0] != kBFloat16) || nlead < 1 || nlead > kMaxLead)
    return false;
  e->bf16 = desc[0] == kBFloat16;
  e->nlead = (int)nlead;
  e->row_stride = desc[2];
  e->col_stride = (int)desc[3];
  for (int d = 0; d < nlead; ++d) {
    e->dims[d] = desc[4 + d];
    e->gstride[d] = desc[4 + nlead + d];
    if (e->dims[d] < 1 || (e->col_stride != 0 && e->gstride[d] % 4 != 0)) return false;
  }
  // quads of a full-width extra are one 16-byte (8 for bf16) read
  return e->col_stride == 0 || (e->row_stride % 4 == 0 && aligned16(ptr));
}

bool bad_geometry(long long R, int M, int L) {
  return R <= 0 || M <= 0 || L <= 0 || L % 128 != 0 || L > kMaxL ||
         R * M > 0x7fffffffLL * (L <= kWarpRowMaxL ? kWarpsPerBlock : 1);
}

// blocks of the warp route: kWarpsPerBlock warps of rows_per_warp(CH) rows
unsigned warp_grid(long long rows, int CH) {
  const long long per_block = (long long)kWarpsPerBlock * rows_per_warp(CH);
  return (unsigned)((rows + per_block - 1) / per_block);
}

template <typename TI, typename TO>
cudaError_t launch_fwd(const void* x, const float* scale, const Extra& mask,
                       const Extra& bias, void* y, long long R, int M, int L, const Drop& dr,
                       cudaStream_t s) {
  const long long rows = R * M;
  const TI* xt = static_cast<const TI*>(x);
  TO* yt = static_cast<TO*>(y);
  if (L > kWarpRowMaxL) {
    softmax_dropout_fwd_block<TI, TO><<<(unsigned)rows, kRowThreads, 0, s>>>(
        xt, scale, mask, bias, yt, M, L, dr);
    return cudaGetLastError();
  }
  const int threads = kWarpsPerBlock * 32;
  switch (L / 128) {
#define UNICORE_SD_FWD(CH)                                                                \
  case CH:                                                                                \
    softmax_dropout_fwd_warp<TI, TO, CH><<<warp_grid(rows, CH), threads, 0, s>>>(          \
        xt, scale, mask, bias, yt, rows, M, dr);                                          \
    break;
    UNICORE_SD_FWD(1) UNICORE_SD_FWD(2) UNICORE_SD_FWD(3) UNICORE_SD_FWD(4)
    UNICORE_SD_FWD(5) UNICORE_SD_FWD(6) UNICORE_SD_FWD(7) UNICORE_SD_FWD(8)
#undef UNICORE_SD_FWD
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const Extra& mask, const Extra& bias, const void* dy,
                       void* ds, long long R, int M, int L, const Drop& dr, cudaStream_t s) {
  const long long rows = R * M;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dy);
  float* dst = static_cast<float*>(ds);
  if (L > kWarpRowMaxL) {
    softmax_dropout_bwd_block<T><<<(unsigned)rows, kRowThreads, 0, s>>>(xt, mask, bias, gt, dst,
                                                                      M, L, dr);
    return cudaGetLastError();
  }
  const int threads = kWarpsPerBlock * 32;
  switch (L / 128) {
#define UNICORE_SD_BWD(CH)                                                                \
  case CH:                                                                                \
    softmax_dropout_bwd_warp<T, CH><<<warp_grid(rows, CH), threads, 0, s>>>(               \
        xt, mask, bias, gt, dst, rows, M, dr);                                            \
    break;
    UNICORE_SD_BWD(1) UNICORE_SD_BWD(2) UNICORE_SD_BWD(3) UNICORE_SD_BWD(4)
    UNICORE_SD_BWD(5) UNICORE_SD_BWD(6) UNICORE_SD_BWD(7) UNICORE_SD_BWD(8)
#undef UNICORE_SD_BWD
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x, y: (R, M, L) fp32 or bf16 (dtype), 16-byte aligned; mask/bias with their
// descriptors (16-byte aligned unless broadcast over columns), or null.  dropout: on, seed, threshold, and `div` = (1 - rate) rounded to the
// output type.
extern "C" int unicore_softmax_dropout_fwd(const void* x, const void* mask,
                                           const long long* mask_desc, const void* bias,
                                           const long long* bias_desc, void* y, long long R,
                                           int M, int L, int dropout, unsigned seed,
                                           unsigned threshold, float div, int dtype,
                                           void* stream) {
  Extra em, eb;
  if (bad_geometry(R, M, L) || !aligned16(x) || !aligned16(y) ||
      !make_extra(mask, mask_desc, &em) || !make_extra(bias, bias_desc, &eb))
    return (int)cudaErrorInvalidValue;
  const Drop dr{dropout, seed, threshold, div, 1.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)launch_fwd<float, float>(x, nullptr, em, eb, y, R, M, L, dr, s);
  if (dtype == kBFloat16)
    return (int)launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, nullptr, em, eb, y, R, M, L, dr,
                                                         s);
  return (int)cudaErrorInvalidValue;
}

// The quantized-input forward: x (R, M, L) int8 or int32 (in_dtype), `scale`
// one fp32 on the device, y (R, M, L) fp32; the rest as above.
extern "C" int unicore_quant_softmax_dropout_fwd(const void* x, const void* scale,
                                                 const void* mask, const long long* mask_desc,
                                                 const void* bias, const long long* bias_desc,
                                                 void* y, long long R, int M, int L,
                                                 int dropout, unsigned seed, unsigned threshold,
                                                 float div, int in_dtype, void* stream) {
  Extra em, eb;
  if (scale == nullptr || bad_geometry(R, M, L) || !aligned16(x) || !aligned16(y) ||
      !make_extra(mask, mask_desc, &em) || !make_extra(bias, bias_desc, &eb))
    return (int)cudaErrorInvalidValue;
  const Drop dr{dropout, seed, threshold, div, 1.f};
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kInt8)
    return (int)launch_fwd<int8_t, float>(x, sc, em, eb, y, R, M, L, dr, s);
  if (in_dtype == kInt32)
    return (int)launch_fwd<int32_t, float>(x, sc, em, eb, y, R, M, L, dr, s);
  return (int)cudaErrorInvalidValue;
}

// dy: (R, M, L) in x's type; ds: (R, M, L) fp32.  `scale` = fp32(1 / (1 - rate)).
extern "C" int unicore_softmax_dropout_bwd(const void* x, const void* mask,
                                           const long long* mask_desc, const void* bias,
                                           const long long* bias_desc, const void* dy, void* ds,
                                           long long R, int M, int L, int dropout,
                                           unsigned seed, unsigned threshold, float scale,
                                           int dtype, void* stream) {
  Extra em, eb;
  if (bad_geometry(R, M, L) || !aligned16(x) || !aligned16(dy) || !aligned16(ds) ||
      !make_extra(mask, mask_desc, &em) || !make_extra(bias, bias_desc, &eb))
    return (int)cudaErrorInvalidValue;
  const Drop dr{dropout, seed, threshold, 1.f, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return (int)launch_bwd<float>(x, em, eb, dy, ds, R, M, L, dr, s);
  if (dtype == kBFloat16)
    return (int)launch_bwd<__nv_bfloat16>(x, em, eb, dy, ds, R, M, L, dr, s);
  return (int)cudaErrorInvalidValue;
}
