// LayerNorm / RMSNorm forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of unicore_tpu/ops/fused_norm.py, the halves of
// the `jax.custom_vjp` `_fused_norm` (:231) behind `fused_layer_norm` /
// `fused_rms_norm`:
//   `_ln_fwd_kernel`  (:56, launched by `_ln_fwd` :81), with its mean/rstd
//                     outputs for training, and its int8 `scale_ref` variant
//                     (:60-63, launched by `quant_layer_norm_pallas` :281,
//                     `pallas_call` :124), both as `fused_norm_fwd_kernel` below;
//   `_ln_dx_kernel`   (:140, `pallas_call` :181) and
//   `_ln_dwdb_kernel` (:157, `pallas_call` :209), both launched by
//                     `_ln_bwd` :176, as ONE backward pass below.
//
// What they compute, per row of x (N, D), statistics in fp32 whatever the
// input type:
//   forward  two-pass, as the module's own jnp path does: mean, then
//            var = mean((x - mean)^2) (RMS: mean = 0, var = mean(x^2));
//            rstd = rsqrt(var + eps); y = (x - mean) * rstd * w (+ b), cast
//            back to the input type; mean and rstd stored as fp32 (N,) when
//            asked for (training), not at all otherwise (serving);
//   dx       x^ = (x - mean) * rstd, g = w * dy,
//            dx = (g - mean(g) - x^ * mean(g * x^)) * rstd (RMS: no mean(g));
//   dw, db   dw = sum over rows of dy * x^, db = sum over rows of dy, fp32,
//            rounded once to w's type.
// x (and y, dy, dx) is fp32, bf16 or fp16; w and b are fp32, bf16 or fp16
// (a --bf16 / --fp16 run casts them as the JAX trainer casts every floating
// parameter), read in place and widened to fp32 in registers.
//   quantized forward (LayerNorm only, no statistics written): the int8 row
//            dequantized as loaded, v = float(x) * scale rounded once, where
//            `scale` points at one fp32 value or at (D,) of them and is read
//            on the device (no host sync); then the forward above on v, fp32
//            out.  It reads 1 byte an element and writes 4: at the LM head's
//            (4096, 768) the floor is 4.7 us.
//
// What bounds them on this card: bytes.  The forward reads x and writes y
// (2 * N * D * itemsize, plus 8 * N of statistics in training); the backward
// reads x and dy and writes dx (3 * N * D * itemsize), plus the statistics
// (8 * N: mean and rstd; RMSNorm reads rstd alone, 4 * N) and the weight
// bytes (w read, dw and db written); each does ~10 flops per element, far
// below the H100's 295 flops-per-byte ridge.  At BERT's (4096, 768) fp32 the
// floors are 7.5 us forward and 11.3 us backward at 3.35 TB/s; at Uni-Mol's
// pair norms (262144, 64) the forward's is 40 us in fp32, 20 us in bf16, the
// backward's 60 and 30.
//
// What the design does about it.  Both directions cut a row the same way
// (`row_plan`): a team of TPR threads (a power of two, 1 to 256) holds a
// row, so at D <= 128 several rows share a warp (Uni-Mol's D = 64 fp32 row
// is 16 lanes, bf16 8) and wider rows take a warp or several.  Loads are 16
// bytes a thread (4 fp32 or 8 bf16/fp16 elements; 4 int8 elements, whose
// fp32 output is 16 bytes) when D allows it and every pointer is 16-byte
// aligned, else one element (any D, such as 33), in the same kernel.  Each
// thread owns vectors j * TPR + sub (j < K) of every row it visits, so its
// columns stay fixed while its block walks its rows.
//   * the forward (`fused_norm_fwd_kernel`) reads a row's K vectors of x once,
//     keeps them packed in registers through both sums (a segmented xor
//     shuffle, across warps through shared memory for TPR > 32) and writes
//     y from them, 16 bytes a store; each team's first thread writes the
//     row's mean and rstd.  The thread's w and b (and 7q's per-channel
//     scales) are read once: into registers where the thread's row and its
//     weights widened to fp32 take at most 224 bytes (rows to D = 512, int8
//     rows to 768),
//     else into shared memory, one copy
//     for the block's teams, filled while the first row's loads are in
//     flight, which leaves the registers to more rows in flight.  A row of
//     at most 32 bytes a thread has its successor read while its sums run.
//     Blocks take contiguous ranges of rows, so many that the grid is at
//     least four waves of what the SMs hold (the last wave evens out) and,
//     where a row is read ahead, two rows a team at least.  7q is the
//     same template with an int8 loader (4 elements a load) and an fp32
//     output.  Rows too wide for K vectors a thread (D > 8192 with 16-byte
//     loads, > 4096 with one element a load) take `fused_norm_fwd_wide_kernel`:
//     one row a block at a time in columns, x re-read through L1/L2 for the
//     second sum and the y write.
//   * the backward is one pass over x and dy that writes dx and dw/db
//     partial sums, then a small second launch that adds the partials.
//     Stage 1 (`fused_norm_bwd_kernel`) keeps x and dy packed in registers
//     between the row's two sums and its dx write, so they are read once; w
//     comes through L1 at each use, which leaves registers for more blocks
//     an SM.  Each thread adds dy * x^ and dy for its columns in fp32
//     registers, and at the end the block's copies of each column are added
//     in shared memory in a fixed order and written as ONE partial row per
//     block (grid * D * 2 floats).  Stage 2 (`fused_norm_bwd_finish_kernel`)
//     adds the partial rows in a fixed order: 32 columns x 16 row groups a
//     block, the groups combined by a fixed tree, and writes dw and db in
//     w's type, rounded once.  Rows too wide for the registers take
//     `fused_norm_bwd_wide_kernel`, the same design column-tiled: one row a
//     block at a time, the row sums in a pass over x and dy, dx in a second
//     that re-reads them through L1/L2, and the block's partial row added in
//     place in the scratch (one owner a column), then the same stage 2.
// No float atomics: y, the statistics, dx, dw and db are the same bits on
// every run.  A null dx skips the row sums and the dx write; a null dw skips
// the partials and stage 2.
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace unicore;

constexpr int kFwdThreads = 256;      // forward: threads a block
constexpr int kFwdHoldBytes = 224;    // forward: w, b held in registers to this many bytes a thread
constexpr int kFwdPrefetchBytes = 32; // forward: the next row's x read ahead to this many bytes
constexpr int kFwdMinWaves = 4;       // forward: the grid's waves, at least, where rows allow
constexpr int kBwdThreads = 256;      // backward stage 1: threads a block
constexpr int kMaxBlocksPerSm = 4;    // backward stage 1: persistent blocks an SM
constexpr int kMaxTprLog2 = 8;        // at most 256 threads a row
constexpr int kFinCols = 32;          // backward stage 2: columns a block
constexpr int kFinRows = 16;          // backward stage 2: partial-row groups a block

// elements of T a vector load takes: 16 bytes, but 4 for int8 rows, whose
// fp32 output is then written 16 bytes a store
template <typename T> constexpr int vec_of() { return sizeof(T) == 1 ? 4 : 16 / (int)sizeof(T); }

// VEC elements of T as one access: 16 bytes (8 for a 16-bit weight beside
// fp32 rows, 32 for an fp32 weight beside 16-bit rows, 4 for int8 rows),
// kept packed in registers and widened to fp32 where used; VEC 1 is one
// element
template <typename T, int VEC> struct Packed {
  static constexpr int kWords = VEC * (int)sizeof(T) / 4;
  uint32_t u[kWords];
};
template <typename T> struct Packed<T, 1> { T v; };

template <typename T> __device__ __forceinline__ float2 widen2(uint32_t u);
template <> __device__ __forceinline__ float2 widen2<__nv_bfloat16>(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
template <> __device__ __forceinline__ float2 widen2<__half>(uint32_t u) {
  return __half22float2(*reinterpret_cast<const __half2*>(&u));
}
template <typename T> __device__ __forceinline__ uint32_t narrow2(float a, float b);
template <> __device__ __forceinline__ uint32_t narrow2<__nv_bfloat16>(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // nearest even, as from_f
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <> __device__ __forceinline__ uint32_t narrow2<__half>(float a, float b) {
  const __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <typename T, int VEC>
__device__ __forceinline__ void load_packed(const T* p, Packed<T, VEC>& r) {
  if constexpr (VEC == 1) {
    r.v = *p;
  } else if constexpr (Packed<T, VEC>::kWords == 1) {
    r.u[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (Packed<T, VEC>::kWords == 2) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    r.u[0] = t.x;
    r.u[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < Packed<T, VEC>::kWords / 4; ++i) {
      const uint4 t = reinterpret_cast<const uint4*>(p)[i];
      r.u[4 * i] = t.x;
      r.u[4 * i + 1] = t.y;
      r.u[4 * i + 2] = t.z;
      r.u[4 * i + 3] = t.w;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void zero_packed(Packed<T, VEC>& r) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 1) {
      r.v = 0;
    } else {
      r.v = from_f<T>(0.f);
    }
  } else {
#pragma unroll
    for (int i = 0; i < Packed<T, VEC>::kWords; ++i) r.u[i] = 0u;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void widen(const Packed<T, VEC>& r, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f(r.v);
  } else if constexpr (sizeof(T) == 1) {  // int8, four to a word
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      v[i] = (float)(int8_t)((r.u[i / 4] >> (8 * (i % 4))) & 0xffu);
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __uint_as_float(r.u[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const float2 f = widen2<T>(r.u[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *p = from_f<T>(v[0]);
  } else {
    Packed<T, VEC> r;
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) r.u[i] = __float_as_uint(v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) r.u[i] = narrow2<T>(v[2 * i], v[2 * i + 1]);
    }
#pragma unroll
    for (int i = 0; i < Packed<T, VEC>::kWords / 4; ++i)
      reinterpret_cast<uint4*>(p)[i] =
          make_uint4(r.u[4 * i], r.u[4 * i + 1], r.u[4 * i + 2], r.u[4 * i + 3]);
  }
}

// w[c .. c + VEC) widened, or zeros past the row
template <typename W, int VEC>
__device__ __forceinline__ void load_w(const W* w, int c, bool in_row, float (&v)[VEC]) {
  Packed<W, VEC> r;
  if (in_row) {
    load_packed<W, VEC>(w + c, r);
  } else {
    zero_packed<W, VEC>(r);
  }
  widen<W, VEC>(r, v);
}

// ---------------------------------------------------------------------------
// the forward
// ---------------------------------------------------------------------------

// the dequant scales of columns [c, c + VEC): stride 0, the one value for
// the tensor; stride 1, scale[c ..] (zeros past the row)
template <int VEC>
__device__ __forceinline__ void load_scale(const float* scale, int stride, int c, bool in_row,
                                           float (&s)[VEC]) {
  if (stride == 0) {
    const float v = *scale;
#pragma unroll
    for (int e = 0; e < VEC; ++e) s[e] = v;
  } else {
    load_w<float, VEC>(scale, c, in_row, s);
  }
}

// a vector of the row in fp32: widened, and an int8 one dequantized, each
// value rounded once (__fmul_rn: as the plain version's multiply, whatever
// the compiler contracts around it); `s` is read for int8 rows only
template <typename T, int VEC>
__device__ __forceinline__ void row_values(const Packed<T, VEC>& p, const float (&s)[VEC],
                                           float (&v)[VEC]) {
  widen<T, VEC>(p, v);
  if constexpr (std::is_same<T, int8_t>::value) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = __fmul_rn(v[e], s[e]);
  }
}

// the sum of v over a team of 2**tpr_log2 threads, the same bits in each of
// them: a segmented xor shuffle (a + b and b + a are one value, so every
// lane ends with the same sum), then, for a team wider than a warp, the
// warps' sums in warp order through shared memory.  Two buffers taken in
// turn make one barrier a sum enough.  Every thread of the block calls it.
__device__ __forceinline__ float team_sum(float v, int tpr_log2,
                                          float (&red)[2][kFwdThreads / 32], int& buf) {
  const int tpr = 1 << tpr_log2;
  for (int o = 1; o < tpr && o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (tpr > 32) {
    const int warp = threadIdx.x >> 5, wpt = tpr >> 5, w0 = warp / wpt * wpt;
    if ((threadIdx.x & 31) == 0) red[buf][warp] = v;
    __syncthreads();
    v = 0.f;
    for (int k = 0; k < wpt; ++k) v += red[buf][w0 + k];
    buf ^= 1;
  }
  return v;
}

// whether the forward holds a thread's w and b (and 7q's scales) in
// registers: when its row vectors and their weights widened to fp32 (the
// compiler widens them once, outside the row loop) take at most
// kFwdHoldBytes; else the block keeps one copy in shared memory
template <typename T, int VEC, int K> __host__ __device__ constexpr bool fwd_holds_cols() {
  return K * VEC * ((int)sizeof(T) + 8) <= kFwdHoldBytes;
}

// whether the forward reads a row's successor while the row's sums run:
// when the thread's row vectors take at most kFwdPrefetchBytes
template <typename T, int VEC, int K> __host__ __device__ constexpr bool fwd_reads_ahead() {
  return K * VEC * (int)sizeof(T) <= kFwdPrefetchBytes;
}

// bytes of one column array of W in the forward's shared memory, rounded up
// to 16 so the next array's vectors stay aligned
template <typename W> __host__ __device__ __forceinline__ int fwd_cols_bytes(int D) {
  return (D * (int)sizeof(W) + 15) / 16 * 16;
}

// y (N, D) in O from x (N, D) in T: fp32, bf16 or fp16 rows with O = T, or
// int8 rows (dequantized by scale[c * scale_stride]) with O = float.  A
// team of 2**tpr_log2 threads holds a row; thread `sub` of a team owns
// vectors j * TPR + sub (j < K) of every row it visits, and block b takes
// row groups [b * per_block, (b + 1) * per_block), a group being one row a
// team.  mean_out and rstd_out both null: no statistics written.  b may be
// null.  Where the columns' w and b do not stay in registers, the launch
// gives the block dynamic shared memory for them: two arrays of
// fwd_cols_bytes<W>(D), and one of fwd_cols_bytes<float>(D) for 7q's
// per-channel scales.
template <typename T, typename O, typename W, int VEC, int K>
__global__ void __launch_bounds__(kFwdThreads)
fused_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale, int scale_stride,
                const W* __restrict__ w, const W* __restrict__ b, O* __restrict__ y,
                float* __restrict__ mean_out, float* __restrict__ rstd_out, long long N,
                int D, float eps, int rms, int tpr_log2, long long per_block) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  // w and b (and 7q's scales) of the thread's columns are read once: into
  // registers where they take few of them, else into shared memory, one
  // copy for the block's teams, which leaves the registers to more rows in
  // flight
  constexpr bool kHold = fwd_holds_cols<T, VEC, K>();
  constexpr int kHeld = kHold ? K : 1;
  constexpr bool kAhead = fwd_reads_ahead<T, VEC, K>();
  __shared__ float s_red[2][kFwdThreads / 32];
  extern __shared__ __align__(16) unsigned char s_cols[];
  const int tpr = 1 << tpr_log2;
  const int team = threadIdx.x >> tpr_log2, sub = threadIdx.x & (tpr - 1);
  const int teams = kFwdThreads >> tpr_log2;
  const int nv = D / VEC;
  const float inv_d = 1.f / (float)D;
  const bool has_b = b != nullptr;
  int buf = 0;
  W* s_w = reinterpret_cast<W*>(s_cols);
  W* s_b = reinterpret_cast<W*>(s_cols + fwd_cols_bytes<W>(D));
  float* s_sc = reinterpret_cast<float*>(s_cols + 2 * fwd_cols_bytes<W>(D));

  // the K vectors of row group g's row, packed as loaded (zeros past N, D)
  auto load_row = [&](long long g, Packed<T, VEC> (&xr)[K]) {
    const long long row = g * teams + team;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int v = j * tpr + sub;
      if (row < N && v < nv) {
        load_packed<T, VEC>(x + row * D + (long long)v * VEC, xr[j]);
      } else {
        zero_packed<T, VEC>(xr[j]);
      }
    }
  };
  const long long g_begin = (long long)blockIdx.x * per_block;
  const long long g_end = min((N + teams - 1) / teams, g_begin + per_block);
  Packed<T, VEC> xr[K], next[kAhead ? K : 1];
  load_row(g_begin, xr);  // in flight while the columns' weights arrive

  Packed<W, VEC> wr[kHeld], br[kHeld];
  float sc[kHeld][VEC];
  if constexpr (kHold) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int v = j * tpr + sub;
      if (v < nv) {
        load_packed<W, VEC>(w + v * VEC, wr[j]);
        if (has_b) {
          load_packed<W, VEC>(b + v * VEC, br[j]);
        } else {
          zero_packed<W, VEC>(br[j]);
        }
      } else {
        zero_packed<W, VEC>(wr[j]);
        zero_packed<W, VEC>(br[j]);
      }
      if constexpr (kQuant) load_scale<VEC>(scale, scale_stride, v * VEC, v < nv, sc[j]);
    }
  } else {
    // 16-byte copies where the rows take 16-byte vectors (every load of a
    // thread issued before its stores), single elements otherwise
    const bool per_channel = kQuant && scale_stride != 0;
    int tail = 0;  // the first column copied one at a time
    if constexpr (VEC > 1) {
      const int chunks = D * (int)sizeof(W) / 16;
      for (int c = threadIdx.x; c < chunks; c += kFwdThreads) {
        const uint4 tw = reinterpret_cast<const uint4*>(w)[c];
        const uint4 tb = has_b ? reinterpret_cast<const uint4*>(b)[c] : tw;
        reinterpret_cast<uint4*>(s_w)[c] = tw;
        reinterpret_cast<uint4*>(s_b)[c] = tb;
      }
      if (per_channel) {  // int8 rows take 4-element vectors: D % 4 == 0
        for (int c = threadIdx.x; c < D / 4; c += kFwdThreads)
          reinterpret_cast<float4*>(s_sc)[c] = reinterpret_cast<const float4*>(scale)[c];
      }
      tail = chunks * 16 / (int)sizeof(W);
    }
    for (int c = tail + threadIdx.x; c < D; c += kFwdThreads) {
      s_w[c] = w[c];
      if (has_b) s_b[c] = b[c];
      if (per_channel && VEC == 1) s_sc[c] = scale[c];
    }
    __syncthreads();
  }
  // the row's vector j in fp32 (dequantized for int8 rows)
  auto values = [&](const Packed<T, VEC>& p, int j, float (&xv)[VEC]) {
    if constexpr (kQuant && !kHold) {
      float s[VEC];
      const int v = j * tpr + sub;
      load_scale<VEC>(scale_stride != 0 ? s_sc : scale, scale_stride, v * VEC, v < nv, s);
      row_values<T, VEC>(p, s, xv);
    } else {
      row_values<T, VEC>(p, sc[kHold ? j : 0], xv);
    }
  };

  for (long long g = g_begin; g < g_end; ++g) {  // the same for the block
    const long long row = g * teams + team;
    if constexpr (kAhead) {
      if (g + 1 < g_end) load_row(g + 1, next);
    }
    // two passes over the registers: the mean (zeros add nothing), then the
    // mean of (x - mean)^2 over the row's own columns
    float mean = 0.f;
    if (!rms) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float xv[VEC];
        values(xr[j], j, xv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) s += xv[e];
      }
      mean = team_sum(s, tpr_log2, s_red, buf) * inv_d;
    }
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j * tpr + sub >= nv) continue;
      float xv[VEC];
      values(xr[j], j, xv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = xv[e] - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(team_sum(sq, tpr_log2, s_red, buf) * inv_d + eps);
    if (row < N) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int v = j * tpr + sub;
        if (v >= nv) continue;
        float xv[VEC], wv[VEC], bv[VEC], out[VEC];
        values(xr[j], j, xv);
        if constexpr (kHold) {
          widen<W, VEC>(wr[j], wv);
          widen<W, VEC>(br[j], bv);
        } else {
          load_w<W, VEC>(s_w, v * VEC, true, wv);
          load_w<W, VEC>(s_b, v * VEC, has_b, bv);
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float o = (xv[e] - mean) * rstd * wv[e];
          if (has_b) o += bv[e];
          out[e] = o;
        }
        store_vec<O, VEC>(y + row * D + (long long)v * VEC, out);
      }
      if (mean_out != nullptr && sub == 0) {
        mean_out[row] = mean;
        rstd_out[row] = rstd;
      }
    }
    if constexpr (kAhead) {
#pragma unroll
      for (int j = 0; j < K; ++j) xr[j] = next[j];
    } else {
      if (g + 1 < g_end) load_row(g + 1, xr);
    }
  }
}

// The forward for rows too wide to stay in registers: block b holds rows
// [b * per_block, (b + 1) * per_block) one at a time, and thread tid owns
// vectors tid, tid + 256, ... of each; the sums' passes and the y write
// read x (and w, b, the scales) through L1/L2.  Arguments as
// fused_norm_fwd_kernel's.
template <typename T, typename O, typename W, int VEC>
__global__ void __launch_bounds__(kFwdThreads)
fused_norm_fwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     int scale_stride, const W* __restrict__ w, const W* __restrict__ b,
                     O* __restrict__ y, float* __restrict__ mean_out,
                     float* __restrict__ rstd_out, long long N, int D, float eps, int rms,
                     long long per_block) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  __shared__ float s_red[2][kFwdThreads / 32];
  const int nv = D / VEC;
  const float inv_d = 1.f / (float)D;
  int buf = 0;
  const long long r_end = min(N, ((long long)blockIdx.x + 1) * per_block);
  for (long long row = (long long)blockIdx.x * per_block; row < r_end; ++row) {
    const T* xr = x + row * D;
    float mean = 0.f;
    if (!rms) {
      float s = 0.f;
      for (int v = threadIdx.x; v < nv; v += kFwdThreads) {
        Packed<T, VEC> p;
        load_packed<T, VEC>(xr + (long long)v * VEC, p);
        float sc[VEC], xv[VEC];
        if constexpr (kQuant) load_scale<VEC>(scale, scale_stride, v * VEC, true, sc);
        row_values<T, VEC>(p, sc, xv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) s += xv[e];
      }
      mean = team_sum(s, kMaxTprLog2, s_red, buf) * inv_d;
    }
    float sq = 0.f;
    for (int v = threadIdx.x; v < nv; v += kFwdThreads) {
      Packed<T, VEC> p;
      load_packed<T, VEC>(xr + (long long)v * VEC, p);
      float sc[VEC], xv[VEC];
      if constexpr (kQuant) load_scale<VEC>(scale, scale_stride, v * VEC, true, sc);
      row_values<T, VEC>(p, sc, xv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = xv[e] - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(team_sum(sq, kMaxTprLog2, s_red, buf) * inv_d + eps);
    for (int v = threadIdx.x; v < nv; v += kFwdThreads) {
      Packed<T, VEC> p;
      load_packed<T, VEC>(xr + (long long)v * VEC, p);
      float sc[VEC], xv[VEC], wv[VEC], bv[VEC], out[VEC];
      if constexpr (kQuant) load_scale<VEC>(scale, scale_stride, v * VEC, true, sc);
      row_values<T, VEC>(p, sc, xv);
      load_w<W, VEC>(w, v * VEC, true, wv);
      load_w<W, VEC>(b, v * VEC, b != nullptr, bv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float o = (xv[e] - mean) * rstd * wv[e];
        if (b != nullptr) o += bv[e];
        out[e] = o;
      }
      store_vec<O, VEC>(y + row * D + (long long)v * VEC, out);
    }
    if (mean_out != nullptr && threadIdx.x == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

// ---------------------------------------------------------------------------
// the backward
// ---------------------------------------------------------------------------

// Stage 1.  Block b takes rows [b * rows_per_block, min(N, (b + 1) *
// rows_per_block)); a team of 2**tpr_log2 threads holds a row; thread `sub`
// of a team owns vectors j * TPR + sub (j < K) of every row it visits.
// dx null: no row sums, no dx; part_w null: no dw/db partials.  part_b may
// be null (RMSNorm, or no bias).
template <typename T, typename W, int VEC, int K>
__global__ void __launch_bounds__(kBwdThreads)
fused_norm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                      const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                      const T* __restrict__ dy, T* __restrict__ dx,
                      float* __restrict__ part_w, float* __restrict__ part_b, long long N,
                      int D, int tpr_log2, long long rows_per_block, int rms) {
  __shared__ float s_comb[2][kBwdThreads * 8];        // a column round's copies
  __shared__ float s_red[2][kBwdThreads / 32][2];     // per-warp row sums, 2 buffers
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tpr = 1 << tpr_log2;
  const int team = tid >> tpr_log2, sub = tid & (tpr - 1);
  const int teams = kBwdThreads >> tpr_log2;
  const int nv = D / VEC;
  const float inv_d = 1.f / (float)D;
  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  const long long r_end = min(N, r_begin + rows_per_block);
  const bool want_dx = dx != nullptr, want_dw = part_w != nullptr;

  float aw[K][VEC], ab[K][VEC];
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) aw[j][e] = ab[j][e] = 0.f;
  }

  const long long iters = (r_end - r_begin + teams - 1) / teams;  // the same for the block
  for (long long it = 0; it < iters; ++it) {
    // x and dy stay packed in registers (fewer registers, more blocks an
    // SM) and are widened again for the dx write; w comes through L1
    const long long row = r_begin + it * teams + team;
    const bool ok = row < r_end;
    const float m = ok && !rms ? mean_in[row] : 0.f, rs = ok ? rstd_in[row] : 0.f;
    Packed<T, VEC> xr[K], dr[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int v = j * tpr + sub;
      if (ok && v < nv) {
        load_packed<T, VEC>(x + row * D + (long long)v * VEC, xr[j]);
        load_packed<T, VEC>(dy + row * D + (long long)v * VEC, dr[j]);
      } else {
        zero_packed<T, VEC>(xr[j]);
        zero_packed<T, VEC>(dr[j]);
      }
    }
    // the row sums and the thread's dw/db sums (a row past the range or a
    // column past D has dy = 0 and adds nothing)
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int v = j * tpr + sub;
      float xv[VEC], dv[VEC], wv[VEC];
      widen<T, VEC>(xr[j], xv);
      widen<T, VEC>(dr[j], dv);
      load_w<W, VEC>(w, v * VEC, v < nv, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = (xv[e] - m) * rs;
        if (want_dw) {
          aw[j][e] += dv[e] * xh;
          ab[j][e] += dv[e];
        }
        const float g = dv[e] * wv[e];
        s1 += g;
        s2 += g * xh;
      }
    }
    if (!want_dx) continue;
    // the row sums over the team: a segmented shuffle in the warp, then
    // across the team's warps through shared memory (double-buffered, so
    // one barrier an iteration)
    for (int o = 1; o < tpr && o < 32; o <<= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (tpr > 32) {
      const int buf = (int)(it & 1), wpt = tpr >> 5, w0 = team * wpt;
      if (lane == 0) {
        s_red[buf][warp][0] = s1;
        s_red[buf][warp][1] = s2;
      }
      __syncthreads();
      s1 = s2 = 0.f;
      for (int k = 0; k < wpt; ++k) {
        s1 += s_red[buf][w0 + k][0];
        s2 += s_red[buf][w0 + k][1];
      }
    }
    if (!ok) continue;
    const float c1 = rms ? 0.f : s1 * inv_d, c2 = s2 * inv_d;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int v = j * tpr + sub;
      if (v >= nv) continue;
      float xv[VEC], dv[VEC], wv[VEC], out[VEC];
      widen<T, VEC>(xr[j], xv);
      widen<T, VEC>(dr[j], dv);
      load_w<W, VEC>(w, v * VEC, true, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = (xv[e] - m) * rs;
        out[e] = (dv[e] * wv[e] - c1 - xh * c2) * rs;
      }
      store_vec<T, VEC>(dx + row * D + (long long)v * VEC, out);
    }
  }
  if (!want_dw) return;

  // the block's partial row: teams sharing a warp add by shuffles, then the
  // copies of each column (one a warp, or one a team when TPR >= 32) add in
  // shared memory in copy order, one round of TPR * VEC columns per j
  int copies = teams, copy = team;
  bool writer = true;
  if (tpr < 32) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        for (int o = tpr; o < 32; o <<= 1) {
          aw[j][e] += __shfl_xor_sync(0xffffffffu, aw[j][e], o);
          ab[j][e] += __shfl_xor_sync(0xffffffffu, ab[j][e], o);
        }
      }
    }
    copies = kBwdThreads / 32;
    copy = warp;
    writer = lane < tpr;
  }
  const int width = tpr * VEC;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (writer) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        s_comb[0][copy * width + sub * VEC + e] = aw[j][e];
        s_comb[1][copy * width + sub * VEC + e] = ab[j][e];
      }
    }
    __syncthreads();
    for (int c = tid; c < width; c += kBwdThreads) {
      const int col = j * width + c;
      if (col < D) {
        float a = 0.f, b = 0.f;
        for (int k = 0; k < copies; ++k) {
          a += s_comb[0][k * width + c];
          b += s_comb[1][k * width + c];
        }
        part_w[(size_t)blockIdx.x * D + col] = a;
        if (part_b != nullptr) part_b[(size_t)blockIdx.x * D + col] = b;
      }
    }
    __syncthreads();
  }
}

// Stage 1 for rows too wide to stay in registers: the block holds one row at
// a time and thread tid owns vectors tid, tid + 256, ... of every row.  One
// pass over x, dy and w takes the row sums and adds dy * x^ and dy into the
// block's partial row in place (each column has one owner, so no two
// threads touch one value); a second pass re-reads x, dy and w through
// L1/L2 for the dx write.  Arguments as fused_norm_bwd_kernel's.
template <typename T, typename W, int VEC>
__global__ void __launch_bounds__(kBwdThreads)
fused_norm_bwd_wide_kernel(const T* __restrict__ x, const W* __restrict__ w,
                           const float* __restrict__ mean_in,
                           const float* __restrict__ rstd_in, const T* __restrict__ dy,
                           T* __restrict__ dx, float* __restrict__ part_w,
                           float* __restrict__ part_b, long long N, int D,
                           long long rows_per_block, int rms) {
  __shared__ float s_red[2][kBwdThreads / 32][2];  // per-warp row sums, 2 buffers
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nv = D / VEC;
  const float inv_d = 1.f / (float)D;
  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  const long long r_end = min(N, r_begin + rows_per_block);
  const bool want_dx = dx != nullptr;
  float* pw = part_w == nullptr ? nullptr : part_w + (size_t)blockIdx.x * D;
  float* pb = part_b == nullptr ? nullptr : part_b + (size_t)blockIdx.x * D;

  for (long long row = r_begin; row < r_end; ++row) {
    const float m = rms ? 0.f : mean_in[row], rs = rstd_in[row];
    const T* xr = x + row * D;
    const T* dyr = dy + row * D;
    const bool first = row == r_begin;
    float s1 = 0.f, s2 = 0.f;
    for (int v = tid; v < nv; v += kBwdThreads) {
      Packed<T, VEC> xp, dp;
      load_packed<T, VEC>(xr + (long long)v * VEC, xp);
      load_packed<T, VEC>(dyr + (long long)v * VEC, dp);
      float xv[VEC], dv[VEC], wv[VEC];
      widen<T, VEC>(xp, xv);
      widen<T, VEC>(dp, dv);
      load_w<W, VEC>(w, v * VEC, true, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = (xv[e] - m) * rs;
        const int col = v * VEC + e;
        if (pw != nullptr) pw[col] = first ? dv[e] * xh : pw[col] + dv[e] * xh;
        if (pb != nullptr) pb[col] = first ? dv[e] : pb[col] + dv[e];
        const float g = dv[e] * wv[e];
        s1 += g;
        s2 += g * xh;
      }
    }
    if (!want_dx) continue;
    // the row sums over the block: a shuffle in each warp, then the warps'
    // sums in order through shared memory (double-buffered by row, so one
    // barrier a row)
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const int buf = (int)(row & 1);
    if (lane == 0) {
      s_red[buf][warp][0] = s1;
      s_red[buf][warp][1] = s2;
    }
    __syncthreads();
    s1 = s2 = 0.f;
    for (int k = 0; k < kBwdThreads / 32; ++k) {
      s1 += s_red[buf][k][0];
      s2 += s_red[buf][k][1];
    }
    const float c1 = rms ? 0.f : s1 * inv_d, c2 = s2 * inv_d;
    for (int v = tid; v < nv; v += kBwdThreads) {
      Packed<T, VEC> xp, dp;
      load_packed<T, VEC>(xr + (long long)v * VEC, xp);
      load_packed<T, VEC>(dyr + (long long)v * VEC, dp);
      float xv[VEC], dv[VEC], wv[VEC], out[VEC];
      widen<T, VEC>(xp, xv);
      widen<T, VEC>(dp, dv);
      load_w<W, VEC>(w, v * VEC, true, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = (xv[e] - m) * rs;
        out[e] = (dv[e] * wv[e] - c1 - xh * c2) * rs;
      }
      store_vec<T, VEC>(dx + row * D + (long long)v * VEC, out);
    }
  }
}

// Stage 2: out[col] = the partial rows' sum for col, in w's type.  Block
// (x, 0) does dw's columns [32 x, 32 x + 32), block (x, 1) db's; thread
// group `ty` adds rows ty, ty + 16, ... (four running sums, rows taken in
// turn, combined in a fixed order), then the 16 groups add by a fixed tree.
template <typename W>
__global__ void __launch_bounds__(kFinCols * kFinRows)
fused_norm_bwd_finish_kernel(const float* __restrict__ part_w,
                             const float* __restrict__ part_b, int G, int D,
                             W* __restrict__ dw, W* __restrict__ db) {
  __shared__ float s[kFinRows][kFinCols + 1];
  const float* part = blockIdx.y == 0 ? part_w : part_b;
  W* out = blockIdx.y == 0 ? dw : db;
  const int tx = threadIdx.x & (kFinCols - 1), ty = threadIdx.x / kFinCols;
  const int col = blockIdx.x * kFinCols + tx;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  if (col < D) {
    for (int g = ty; g < G; g += 4 * kFinRows) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = g + q * kFinRows;
        if (r < G) a[q] += part[(size_t)r * D + col];
      }
    }
  }
  s[ty][tx] = (a[0] + a[1]) + (a[2] + a[3]);
  __syncthreads();
#pragma unroll
  for (int h = kFinRows / 2; h > 0; h >>= 1) {
    if (ty < h) s[ty][tx] += s[ty + h][tx];
    __syncthreads();
  }
  if (ty == 0 && col < D) out[col] = from_f<W>(s[0][tx]);
}

// ---------------------------------------------------------------------------
// host side: how a row is cut, the grids, the launches
// ---------------------------------------------------------------------------

// How both directions cut a row: vec (1 or vec_of<T>()), K vectors a
// thread, 2**tpr_log2 threads a row; wide: the row does not fit K vectors a
// thread, so a wide kernel takes it (one row a block at a time); ok false
// for no rows or no columns
struct RowPlan {
  bool ok, wide;
  int vec, k, tpr_log2;
};

int log2_ceil(long long n) {
  int l = 0;
  while ((1LL << l) < n) ++l;
  return l;
}

// the smallest instantiated K >= k, or -1
int round_k(int k, const int* set, int n) {
  for (int i = 0; i < n; ++i)
    if (k <= set[i]) return set[i];
  return -1;
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = n > 0 ? n : 132;
  }
  return cached[dev];
}

// vectors of 4 elements (fp32, int8) with K 1-4, 6 or 8, of 8 (bf16, fp16)
// with K 1-4, single elements with K 4 or 16: at most 8192 columns in
// registers with vectors, 4096 without
template <typename T>
RowPlan row_plan(long long N, int D, bool aligned) {
  constexpr int kVec = vec_of<T>();
  static const int kSet4[] = {1, 2, 3, 4, 6, 8}, kSet8[] = {1, 2, 3, 4}, kSet1[] = {4, 16};
  RowPlan p{false, false, 1, 0, 0};
  if (N <= 0 || D <= 0) return p;
  p.vec = aligned && D % kVec == 0 ? kVec : 1;
  const long long nv = D / p.vec;
  const int* set = p.vec == 1 ? kSet1 : (kVec == 4 ? kSet4 : kSet8);
  const int nset = p.vec == 1 ? 2 : (kVec == 4 ? 6 : 4);
  int tl;
  if (p.vec != 1 && nv <= 32) {
    tl = log2_ceil(nv);  // rows share a warp
  } else {
    const int kmin = p.vec == 1 ? 4 : set[nset - 1];
    tl = log2_ceil((nv + kmin - 1) / kmin);
    if (p.vec != 1 && tl < 5) tl = 5;
    if (tl > kMaxTprLog2) tl = kMaxTprLog2;
  }
  p.tpr_log2 = tl;
  p.k = round_k((int)((nv + (1LL << tl) - 1) >> tl), set, nset);
  if (p.k < 0) {  // too wide for the registers: one row a block at a time
    p.wide = true;
    p.k = 0;
    p.tpr_log2 = kMaxTprLog2;
  }
  p.ok = true;
  return p;
}

// f(IntC<VEC>{}, IntC<K>{}) for row_plan's (vec, k) pairs; K 0, either vec:
// the wide kernel
template <int V> using IntC = std::integral_constant<int, V>;

template <typename T, typename F>
cudaError_t dispatch_shape(int vec, int k, F&& f) {
  constexpr int kVec = vec_of<T>();
  if (vec == 1) {
    if (k == 0) return f(IntC<1>{}, IntC<0>{});
    if (k == 4) return f(IntC<1>{}, IntC<4>{});
    if (k == 16) return f(IntC<1>{}, IntC<16>{});
    return cudaErrorInvalidValue;
  }
  if (vec != kVec) return cudaErrorInvalidValue;
  switch (k) {
    case 0: return f(IntC<kVec>{}, IntC<0>{});
    case 1: return f(IntC<kVec>{}, IntC<1>{});
    case 2: return f(IntC<kVec>{}, IntC<2>{});
    case 3: return f(IntC<kVec>{}, IntC<3>{});
    case 4: return f(IntC<kVec>{}, IntC<4>{});
    default: break;
  }
  if constexpr (kVec == 4) {
    if (k == 6) return f(IntC<4>{}, IntC<6>{});
    if (k == 8) return f(IntC<4>{}, IntC<8>{});
  }
  return cudaErrorInvalidValue;
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= (uintptr_t)p;
  return (bits & 15) == 0;
}

// blocks of a forward kernel an SM holds (at least 1); K 0 names the wide
// kernel
template <typename T, typename O, typename W, int VEC, int K>
int fwd_blocks_per_sm() {
  static int cached = 0;
  if (cached == 0) {
    int n = 0;
    if constexpr (K == 0) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, fused_norm_fwd_wide_kernel<T, O, W, VEC>, kFwdThreads, 0);
    } else {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, fused_norm_fwd_kernel<T, O, W, VEC, K>, kFwdThreads, 0);
    }
    cached = n < 1 ? 1 : n;
  }
  return cached;
}

// one forward launch: the row plan, and row groups (a row a team) split
// into contiguous ranges, so many that the grid is at least four waves of
// the blocks the SMs hold at once where the rows allow it (the hardware
// then evens out the last wave), one group a block below that
template <typename T, typename O, typename W>
cudaError_t launch_fwd(const void* x, const float* scale, int scale_stride, const void* w,
                       const void* b, void* y, void* mean, void* rstd, long long N, int D,
                       float eps, int rms, bool aligned, cudaStream_t stream) {
  const RowPlan p = row_plan<T>(N, D, aligned);
  if (!p.ok) return cudaErrorInvalidValue;
  return dispatch_shape<T>(p.vec, p.k, [&](auto vt, auto kt) {
    constexpr int VEC = decltype(vt)::value, K = decltype(kt)::value;
    const long long teams = K == 0 ? 1 : kFwdThreads >> p.tpr_log2;
    const long long groups = (N + teams - 1) / teams;
    const long long slots = (long long)sm_count() * fwd_blocks_per_sm<T, O, W, VEC, K>();
    const long long waves = slots * kFwdMinWaves;
    long long per_block = groups > waves ? groups / waves : 1;
    // a row read ahead needs a second row group in the block
    if (K > 0 && fwd_reads_ahead<T, VEC, K>() && per_block < 2) per_block = 2;
    const unsigned grid = (unsigned)((groups + per_block - 1) / per_block);
    const T* xt = static_cast<const T*>(x);
    const W* wt = static_cast<const W*>(w);
    const W* bt = static_cast<const W*>(b);
    O* yt = static_cast<O*>(y);
    float* mt = static_cast<float*>(mean);
    float* rt = static_cast<float*>(rstd);
    if constexpr (K == 0) {
      fused_norm_fwd_wide_kernel<T, O, W, VEC><<<grid, kFwdThreads, 0, stream>>>(
          xt, scale, scale_stride, wt, bt, yt, mt, rt, N, D, eps, rms, per_block);
    } else {
      // the columns' w, b (and per-channel scales) in shared memory where
      // they do not stay in registers
      int smem = 0;
      if constexpr (!fwd_holds_cols<T, VEC, K>()) {
        smem = 2 * fwd_cols_bytes<W>(D) + (scale_stride != 0 ? fwd_cols_bytes<float>(D) : 0);
        static int allowed = 48 << 10;  // the default a launch may take
        if (smem > allowed) {
          const cudaError_t err = cudaFuncSetAttribute(
              fused_norm_fwd_kernel<T, O, W, VEC, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
              smem);
          if (err != cudaSuccess) return err;
          allowed = smem;
        }
      }
      fused_norm_fwd_kernel<T, O, W, VEC, K><<<grid, kFwdThreads, smem, stream>>>(
          xt, scale, scale_stride, wt, bt, yt, mt, rt, N, D, eps, rms, p.tpr_log2, per_block);
    }
    return cudaGetLastError();
  });
}

// How stage 1 cuts a backward: the row plan, rows a block, blocks
struct BwdPlan {
  bool ok, wide;
  int vec, k, tpr_log2, grid;
  long long rows_per_block;
};

// blocks of `kernel` an SM holds, 1 to kMaxBlocksPerSm; K 0 names the wide
// kernel
template <typename T, typename W, int VEC, int K>
int blocks_per_sm() {
  static int cached = 0;
  if (cached == 0) {
    int n = 0;
    if constexpr (K == 0) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, fused_norm_bwd_wide_kernel<T, W, VEC>, kBwdThreads, 0);
    } else {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, fused_norm_bwd_kernel<T, W, VEC, K>, kBwdThreads, 0);
    }
    cached = n < 1 ? 1 : (n > kMaxBlocksPerSm ? kMaxBlocksPerSm : n);
  }
  return cached;
}

template <typename T, typename W>
BwdPlan make_plan(long long N, int D, bool aligned) {
  const RowPlan r = row_plan<T>(N, D, aligned);
  BwdPlan p{false, r.wide, r.vec, r.k, r.tpr_log2, 1, 0};
  if (!r.ok) return p;
  int occ = 0;
  if (dispatch_shape<T>(p.vec, p.k, [&](auto vt, auto kt) {
        occ = blocks_per_sm<T, W, decltype(vt)::value, decltype(kt)::value>();
        return cudaSuccess;
      }) != cudaSuccess)
    return p;
  const long long rows_per_iter = kBwdThreads >> p.tpr_log2;
  const long long iters = (N + rows_per_iter - 1) / rows_per_iter;
  const long long blocks = (long long)sm_count() * occ;
  p.rows_per_block = (iters + blocks - 1) / blocks * rows_per_iter;
  p.grid = (int)((N + p.rows_per_block - 1) / p.rows_per_block);
  p.ok = true;
  return p;
}

template <typename T, typename W>
cudaError_t launch_bwd(const BwdPlan& p, const void* x, const void* w, const void* mean,
                       const void* rstd, const void* dy, void* dx, void* dw, void* db,
                       float* partial, long long N, int D, int rms, cudaStream_t stream) {
  float* part_w = dw == nullptr ? nullptr : partial;
  float* part_b = db == nullptr || dw == nullptr ? nullptr : partial + (size_t)p.grid * D;
  cudaError_t err = dispatch_shape<T>(p.vec, p.k, [&](auto vt, auto kt) {
    constexpr int VEC = decltype(vt)::value, K = decltype(kt)::value;
    const T* xt = static_cast<const T*>(x);
    const W* wt = static_cast<const W*>(w);
    const float* mt = static_cast<const float*>(mean);
    const float* rt = static_cast<const float*>(rstd);
    const T* dyt = static_cast<const T*>(dy);
    if constexpr (K == 0) {
      fused_norm_bwd_wide_kernel<T, W, VEC><<<p.grid, kBwdThreads, 0, stream>>>(
          xt, wt, mt, rt, dyt, static_cast<T*>(dx), part_w, part_b, N, D, p.rows_per_block,
          rms);
    } else {
      fused_norm_bwd_kernel<T, W, VEC, K><<<p.grid, kBwdThreads, 0, stream>>>(
          xt, wt, mt, rt, dyt, static_cast<T*>(dx), part_w, part_b, N, D, p.tpr_log2,
          p.rows_per_block, rms);
    }
    return cudaGetLastError();
  });
  if (err != cudaSuccess || dw == nullptr) return err;
  const dim3 grid((D + kFinCols - 1) / kFinCols, part_b == nullptr ? 1 : 2);
  fused_norm_bwd_finish_kernel<W><<<grid, kFinCols * kFinRows, 0, stream>>>(
      part_w, part_b, p.grid, D, static_cast<W*>(dw), static_cast<W*>(db));
  return cudaGetLastError();
}

}  // namespace

// mean and rstd: fp32 (N,) outputs, or both null (no statistics written).
// dtype: x's and y's type code; wdtype: w's and b's (fp32, bf16 or fp16)
extern "C" int unicore_fused_norm_fwd(const void* x, const void* w, const void* b,
                                      void* y, void* mean, void* rstd, long long N, int D,
                                      float eps, int rms, int dtype, int wdtype,
                                      void* stream) {
  if (N <= 0 || D <= 0 || (mean == nullptr) != (rstd == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16({x, w, b, y});
  return (int)dispatch_float(dtype, [&](auto xt) {
    return dispatch_float(wdtype, [&](auto wt) {
      using T = typename decltype(xt)::type;
      using W = typename decltype(wt)::type;
      return launch_fwd<T, T, W>(x, nullptr, 0, w, b, y, mean, rstd, N, D, eps, rms, aligned,
                                 s);
    });
  });
}

// x: (N, D) int8; scale: fp32, one value (scale_stride 0) or (D,)
// (scale_stride 1), read on the device; w, b: fp32 (D,), b may be null;
// y: (N, D) fp32.  LayerNorm only; no statistics.
extern "C" int unicore_quant_layer_norm_fwd(const void* x, const void* scale,
                                            int scale_stride, const void* w, const void* b,
                                            void* y, long long N, int D, float eps,
                                            void* stream) {
  if (N <= 0 || D <= 0 || (scale_stride != 0 && scale_stride != 1))
    return (int)cudaErrorInvalidValue;
  const bool aligned = aligned16({x, w, b, y, scale_stride ? scale : nullptr});
  return (int)launch_fwd<int8_t, float, float>(x, static_cast<const float*>(scale),
                                               scale_stride, w, b, y, nullptr, nullptr, N, D,
                                               eps, 0, aligned,
                                               static_cast<cudaStream_t>(stream));
}

// fp32 scratch floats the backward needs for its dw/db partials (2 * grid *
// D), given x's and w's type codes and whether x, dy, dx and w are all
// 16-byte aligned; -1 for no rows or no columns, -2 for a bad type code
extern "C" long long unicore_fused_norm_bwd_scratch(long long N, int D, int dtype,
                                                    int wdtype, int aligned) {
  long long out = -2;
  dispatch_float(dtype, [&](auto xt) {
    return dispatch_float(wdtype, [&](auto wt) {
      using T = typename decltype(xt)::type;
      using W = typename decltype(wt)::type;
      const BwdPlan p = make_plan<T, W>(N, D, aligned != 0);
      out = p.ok ? 2LL * p.grid * D : -1;
      return cudaSuccess;
    });
  });
  return out;
}

// The backward in one call: stage 1 and, when dw is not null, stage 2, on
// `stream`.  dx (N, D) in x's type, or null for no dx; dw, db (D,) in w's
// type, db null for RMSNorm / no bias, both null for no dw/db; `partial`
// holds `partial_floats` fp32 (unicore_fused_norm_bwd_scratch's count).
// mean (unread for RMSNorm) and rstd: the forward's fp32 (N,) statistics.
extern "C" int unicore_fused_norm_bwd(const void* x, const void* w, const void* mean,
                                      const void* rstd, const void* dy, void* dx, void* dw,
                                      void* db, void* partial, long long partial_floats,
                                      long long N, int D, int rms, int dtype, int wdtype,
                                      void* stream) {
  if (N <= 0 || D <= 0 || (dx == nullptr && dw == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch_float(dtype, [&](auto xt) {
    return dispatch_float(wdtype, [&](auto wt) {
      using T = typename decltype(xt)::type;
      using W = typename decltype(wt)::type;
      const BwdPlan p = make_plan<T, W>(N, D, aligned16({x, dy, dx, w}));
      if (!p.ok || (dw != nullptr && (partial == nullptr ||
                                      partial_floats < 2LL * p.grid * D)))
        return cudaErrorInvalidValue;
      return launch_bwd<T, W>(p, x, w, mean, rstd, dy, dx, dw, db,
                              static_cast<float*>(partial), N, D, rms, s);
    });
  });
}

extern "C" const char* unicore_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
