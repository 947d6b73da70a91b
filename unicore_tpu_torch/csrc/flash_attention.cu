// Flash (online-softmax) attention with a grouped bias, forward and its
// three backward kernels, for Hopper (sm_90a).
//
// Replaces the TPU kernels of unicore_tpu/ops/flash_attention.py, the
// halves of the `jax.custom_vjp` `_flash` (:679):
//   `_fwd_kernel` (:93)   -> flash_fwd_kernel      (unicore_flash_attention_fwd)
//   `_dq_kernel`  (:311)  -> flash_dq_kernel       (unicore_flash_attention_dq)
//   `_dkv_kernel` (:341)  -> flash_dkv_kernel      (unicore_flash_attention_dkv)
//   `_db_kernel`  (:387)  -> flash_db_kernel, then flash_db_reduce_kernel
//                                                 (unicore_flash_attention_db)
//
// What they compute (the TPU kernels' maths, not their grid):
//   s = (q k^T) * sm_scale + bias[b / (B / Bb), Hb > 1 ? h : 0];
//   s = NEG_INF (-1e30) where the key is masked.
//   forward   online softmax over 64-key tiles in fp32: m' = max(m,
//             rowmax(s)), p = exp(s - m'), 0 at masked keys, l' = l e^(m -
//             m') + rowsum(p), acc' = acc e^(m - m') + dropout(p) v, with
//             dropout(p) = keep ? p / (1 - rate) : 0 rounded to v's type
//             before the product; out = acc * (l > 0 ? 1 / l : 0) and the
//             fp32 lse = m + log(max(l, 1e-37)).  A fully masked row gives
//             l = 0, out = 0 and lse ~ -1e30.
//   backward  p = exp(s - lse), 0 at masked keys (recomputed, never stored);
//             dp = do v^T, dropped as p (keep ? dp / (1 - rate) : 0);
//             ds = p * (dp - di), di = rowsum(out * do) in fp32 (computed
//             by the caller, as `_bwd` :524), 0 at masked keys;
//             dq = sm_scale ds k, dk = sm_scale ds^T q, dv = dropout(p)^T do,
//             with ds and dropout(p) rounded to the inputs' type before
//             their products (bf16, as the TPU kernels' astype);
//             dbias = the fp32 ds summed over the R = B / Bb batches of each
//             bias group, and over the heads when Hb == 1.
// q, k, v, out, do, dq, dk, dv: (B, H, L, D) fp32 or bf16; bias (Bb, 1|H,
// Lq, Lk) fp32; the key mask (B, Lk) int32, nonzero = masked; lse and di
// (B, H, Lq) fp32.  Lq, Lk multiples of 64 (the Python wrapper asks for 128,
// the TPU kernel's tiling; the router pads), D <= 128.
//
// Dropout: Philox4x32-10 keyed on the int32 seed with the counter (key
// column / 4, query row, head, batch) (common.cuh), the full-row kernels'
// stream: a flash call and a full-row call with the same seed drop the same
// probabilities, and every backward kernel regenerates the forward's mask.
//
// What bounds them on this card: operations.  Per call at the Evoformer's
// triangle attention (B = 256 rows, H = 4, L = 256, D = 32, fp32) the
// forward's two products are 4 B H L^2 D = 8.6 GFLOP (0.13 ms at the 67
// TFLOP/s fp32 rate) against 67 MB of traffic (0.02 ms); dq makes three
// products, dk/dv four, dbias two.
//
// What the design does about it (right and simple first; fp32 FMA, no
// tensor cores).  Every kernel runs 256 threads over 64 x 64 tiles: thread
// (ty, tx) = (tid / 16, tid % 16) owns rows 4 ty .. 4 ty + 3 of a tile and
// the four neighbouring columns 4 tx .. 4 tx + 3, so one Philox call gives
// its dropout bits of a row, and a row's 64 values live in 16 lanes of one
// warp (its max and sum are shuffles); products over D read row-major rows
// and transposed (D x 64) tiles from shared memory with 16-byte loads, free
// of bank conflicts; output columns tx + 16 j.  The TPU's sequential grid
// axis becomes a loop inside the block:
//   forward  one block per (batch, head, 64 query rows), looping over key
//            tiles; K and V staged transposed, m and l in registers, p
//            through shared memory into the p v product.
//   dq       one block per (batch, head, 64 query rows), looping over keys.
//   dk/dv    one block per (batch, head, 64 keys), looping over queries:
//            each block owns its dk and dv rows, so no atomics.
//   dbias    the TPU grid (group, head, q tile, k tile) looping over the R
//            batches of a group gives only 64 blocks at the triangle
//            attention (Bb = 1, H = 4, L = 256), each 256 batches long, for
//            132 SMs.  Here the R batches are split into chunks across
//            blocks (about 528 blocks in all), each block writes its chunk's
//            fp32 partial sum, and a second launch adds the chunks (and the
//            heads when Hb == 1) in a fixed order: deterministic, no atomics.
// Offsets are 64-bit; dynamic shared memory up to 189 KB (dk/dv at D = 128).
#include <cstdint>

#include "common.cuh"

namespace {

using namespace unicore;

constexpr int kThreads = 256;
constexpr int kTile = 64;          // query rows and key columns per tile
constexpr int kLdT = kTile + 4;    // row stride of transposed and p tiles
constexpr int kLdB = kTile + 1;    // row stride of the dk/dv bias tile
constexpr float kNegInf = -1e30f;  // NEG_INF of ops/flash_attention.py
constexpr int kDbBlocks = 528;     // dbias first-pass target: 4 blocks per SM

struct Geom {
  int B, H, Lq, Lk, D;
  int Bb, Hb;  // bias groups and heads (Bb = 0: no bias)
};

__host__ __device__ __forceinline__ int pad4(int D) { return (D + 3) & ~3; }

// the (Lq, Lk) bias slab batch b and head h read
__device__ __forceinline__ const float* bias_slab(const float* bias, const Geom& g, int b,
                                                  int h) {
  if (bias == nullptr) return nullptr;
  const int group = b / (g.B / g.Bb);
  return bias + ((size_t)group * g.Hb + (g.Hb > 1 ? h : 0)) * g.Lq * g.Lk;
}

// 64 rows of a row-major (rows, D) matrix -> dst (64 x ldr) fp32, columns
// [D, Dp) zero
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ldr, const T* __restrict__ src, int D,
                                          int Dp) {
  for (int e = threadIdx.x; e < kTile * Dp; e += kThreads) {
    const int r = e / Dp, c = e - r * Dp;
    dst[r * ldr + c] = c < D ? to_f(src[(size_t)r * D + c]) : 0.f;
  }
}

// 64 rows of a row-major (rows, D) matrix -> dst (Dp x kLdT) transposed,
// rows [D, Dp) zero.  Global reads coalesced; the shared writes conflict.
template <typename T>
__device__ __forceinline__ void load_transposed(float* dst, const T* __restrict__ src, int D,
                                                int Dp) {
  for (int e = threadIdx.x; e < kTile * Dp; e += kThreads) {
    const int r = e / Dp, c = e - r * Dp;
    dst[c * kLdT + r] = c < D ? to_f(src[(size_t)r * D + c]) : 0.f;
  }
}

__device__ __forceinline__ void unpack(const float4& v, float (&o)[4]) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

// s[i][e] = <row 4 ty + i of sA (64 x lda), column 4 tx + e of sBT (Dp x kLdT)>
__device__ __forceinline__ void tile_dots(const float* sA, int lda, const float* sBT, int Dp,
                                          int ty, int tx, float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
  for (int d = 0; d < Dp; d += 4) {
    float a[4][4], bt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      unpack(*reinterpret_cast<const float4*>(sA + (4 * ty + i) * lda + d), a[i]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      unpack(*reinterpret_cast<const float4*>(sBT + (d + u) * kLdT + 4 * tx), bt[u]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[i][e] += a[i][0] * bt[0][e] + a[i][1] * bt[1][e] + a[i][2] * bt[2][e] +
                   a[i][3] * bt[3][e];
  }
}

// acc[i][j] += sum_c sP[4 ty + i][c] * sXT[tx + 16 j][c] over the tile's 64
// columns c: (64 x 64) times (64 x D), the D side stored transposed
template <int NJ>
__device__ __forceinline__ void tile_times(const float* sP, const float* sXT, int Dp, int ty,
                                           int tx, float (&acc)[4][NJ]) {
  for (int c = 0; c < kTile; c += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      unpack(*reinterpret_cast<const float4*>(sP + (4 * ty + i) * kLdT + c), p[i]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d >= Dp) continue;
      float x[4];
      unpack(*reinterpret_cast<const float4*>(sXT + d * kLdT + c), x);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i][j] += p[i][0] * x[0] + p[i][1] * x[1] + p[i][2] * x[2] + p[i][3] * x[3];
    }
  }
}

// reductions over the 16 lanes (tx) that share a tile row
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[row][tx + 16 j] = scale * acc[i][j] for the thread's rows
template <typename T, int NJ>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, int D, int ty, int tx,
                                           const float (&acc)[4][NJ], float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dst[(size_t)(4 * ty + i) * D + d] = from_f<T>(scale * acc[i][j]);
    }
}

size_t query_major_smem(int D, int row_tiles, int t_tiles) {
  const int Dp = pad4(D);
  return sizeof(float) * ((size_t)row_tiles * kTile * (Dp + 4) + (size_t)t_tiles * Dp * kLdT +
                          (size_t)kTile * kLdT + kTile);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, const int* __restrict__ mask,
                 T* __restrict__ o, float* __restrict__ lse, Geom g, float sm_scale,
                 Dropout dr) {
  extern __shared__ __align__(16) float smem[];
  const int D = g.D, Dp = pad4(D), ldr = Dp + 4;
  float* sQ = smem;                  // 64 x ldr
  float* sKT = sQ + kTile * ldr;     // Dp x kLdT
  float* sVT = sKT + Dp * kLdT;      // Dp x kLdT
  float* sP = sVT + Dp * kLdT;       // 64 x kLdT
  int* sM = reinterpret_cast<int*>(sP + kTile * kLdT);  // 64

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * g.H + h;
  const float* slab = bias_slab(bias, g, b, h);

  load_rows(sQ, ldr, q + (bh * g.Lq + q0) * D, D, Dp);
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < g.Lk; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_transposed(sKT, k + (bh * g.Lk + k0) * D, D, Dp);
    load_transposed(sVT, v + (bh * g.Lk + k0) * D, D, Dp);
    if (tid < kTile) sM[tid] = mask == nullptr ? 0 : mask[(size_t)b * g.Lk + k0 + tid];
    __syncthreads();

    float s[4][4];
    tile_dots(sQ, ldr, sKT, Dp, ty, tx, s);
    int mk[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) mk[e] = sM[4 * tx + e];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float bb[4] = {0.f, 0.f, 0.f, 0.f};
      if (slab != nullptr)
        unpack(*reinterpret_cast<const float4*>(slab + (size_t)row * g.Lk + k0 + 4 * tx), bb);
      float mc = kNegInf;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = mk[e] ? kNegInf : s[i][e] * sm_scale + bb[e];
        mc = fmaxf(mc, s[i][e]);
      }
      const float mn = fmaxf(m[i], row_max16(mc));
      const float corr = expf(m[i] - mn);
      const uint32_t keep = dr.on ? keep4(dr, b, h, row, k0 + 4 * tx) : 0xFu;
      float p[4], ps = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = mk[e] ? 0.f : expf(s[i][e] - mn);
        ps += p[e];
        float pu = p[e];
        if (dr.on) pu = (keep >> e) & 1u ? pu * dr.scale : 0.f;
        p[e] = round_to<T>(pu);  // cast to v's type before p v
      }
      l[i] = corr * l[i] + row_sum16(ps);
      m[i] = mn;
      *reinterpret_cast<float4*>(sP + (4 * ty + i) * kLdT + 4 * tx) =
          make_float4(p[0], p[1], p[2], p[3]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    tile_times<NJ>(sP, sVT, Dp, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] *= inv;
    if (tx == 0) lse[bh * g.Lq + q0 + 4 * ty + i] = m[i] + logf(fmaxf(l[i], 1e-37f));
  }
  store_rows<T, NJ>(o + (bh * g.Lq + q0) * D, D, ty, tx, acc, 1.f);
}

// ---------------------------------------------------------------------------
// backward: ds of one (64 x 64) tile, shared by dq and dbias
// ---------------------------------------------------------------------------

// From the thread's s (q k^T) and dp (do v^T) values: ds, 0 at masked keys;
// `rounded` gets ds rounded to T (what enters a product), `ds32` the fp32 ds
template <typename T>
__device__ __forceinline__ void tile_ds(const float (&s)[4][4], const float (&dp)[4][4],
                                        const int (&mk)[4], const float* slab, const Geom& g,
                                        int b, int h, int q0, int k0, int ty, int tx,
                                        const float (&lse)[4], const float (&di)[4],
                                        float sm_scale, const Dropout& dr,
                                        float (&ds32)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    float bb[4] = {0.f, 0.f, 0.f, 0.f};
    if (slab != nullptr)
      unpack(*reinterpret_cast<const float4*>(slab + (size_t)row * g.Lk + k0 + 4 * tx), bb);
    const uint32_t keep = dr.on ? keep4(dr, b, h, row, k0 + 4 * tx) : 0xFu;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = mk[e] ? 0.f : expf(s[i][e] * sm_scale + bb[e] - lse[i]);
      float gp = dp[i][e];
      if (dr.on) gp = (keep >> e) & 1u ? gp * dr.scale : 0.f;
      ds32[i][e] = mk[e] ? 0.f : p * (gp - di[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ bias, const int* __restrict__ mask,
                const float* __restrict__ lse, const float* __restrict__ di,
                const T* __restrict__ dout, T* __restrict__ dq, Geom g, float sm_scale,
                Dropout dr) {
  extern __shared__ __align__(16) float smem[];
  const int D = g.D, Dp = pad4(D), ldr = Dp + 4;
  float* sQ = smem;                  // 64 x ldr
  float* sDO = sQ + kTile * ldr;     // 64 x ldr
  float* sKT = sDO + kTile * ldr;    // Dp x kLdT
  float* sVT = sKT + Dp * kLdT;      // Dp x kLdT
  float* sDS = sVT + Dp * kLdT;      // 64 x kLdT
  int* sM = reinterpret_cast<int*>(sDS + kTile * kLdT);  // 64

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * g.H + h;
  const float* slab = bias_slab(bias, g, b, h);

  load_rows(sQ, ldr, q + (bh * g.Lq + q0) * D, D, Dp);
  load_rows(sDO, ldr, dout + (bh * g.Lq + q0) * D, D, Dp);
  float lr[4], dil[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lr[i] = lse[bh * g.Lq + q0 + 4 * ty + i];
    dil[i] = di[bh * g.Lq + q0 + 4 * ty + i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < g.Lk; k0 += kTile) {
    __syncthreads();
    load_transposed(sKT, k + (bh * g.Lk + k0) * D, D, Dp);
    load_transposed(sVT, v + (bh * g.Lk + k0) * D, D, Dp);
    if (tid < kTile) sM[tid] = mask == nullptr ? 0 : mask[(size_t)b * g.Lk + k0 + tid];
    __syncthreads();

    float s[4][4], dp[4][4], ds[4][4];
    tile_dots(sQ, ldr, sKT, Dp, ty, tx, s);
    tile_dots(sDO, ldr, sVT, Dp, ty, tx, dp);
    int mk[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) mk[e] = sM[4 * tx + e];
    tile_ds<T>(s, dp, mk, slab, g, b, h, q0, k0, ty, tx, lr, dil, sm_scale, dr, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(sDS + (4 * ty + i) * kLdT + 4 * tx) =
          make_float4(round_to<T>(ds[i][0]), round_to<T>(ds[i][1]), round_to<T>(ds[i][2]),
                      round_to<T>(ds[i][3]));
    __syncthreads();
    tile_times<NJ>(sDS, sKT, Dp, ty, tx, acc);
  }
  store_rows<T, NJ>(dq + (bh * g.Lq + q0) * D, D, ty, tx, acc, sm_scale);
}

// ---------------------------------------------------------------------------
// dk, dv: one block per 64 keys, looping over the queries
// ---------------------------------------------------------------------------

size_t dkv_smem(int D, bool has_bias) {
  const int Dp = pad4(D);
  return sizeof(float) * ((size_t)2 * kTile * (Dp + 4) + (size_t)2 * Dp * kLdT +
                          (size_t)2 * kTile * kLdT + 2 * kTile +
                          (has_bias ? (size_t)kTile * kLdB : 0));
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, const int* __restrict__ mask,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv, Geom g,
                 float sm_scale, Dropout dr) {
  extern __shared__ __align__(16) float smem[];
  const int D = g.D, Dp = pad4(D), ldr = Dp + 4;
  float* sK = smem;                   // 64 x ldr: this block's keys
  float* sV = sK + kTile * ldr;       // 64 x ldr
  float* sQT = sV + kTile * ldr;      // Dp x kLdT: a query tile, transposed
  float* sDOT = sQT + Dp * kLdT;      // Dp x kLdT
  float* sPT = sDOT + Dp * kLdT;      // 64 keys x 64 queries: dropout(p), in T
  float* sDST = sPT + kTile * kLdT;   // 64 keys x 64 queries: ds, in T
  float* sLse = sDST + kTile * kLdT;  // 64
  float* sDi = sLse + kTile;          // 64
  float* sB = sDi + kTile;            // 64 queries x kLdB keys (with a bias)

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * g.H + h;
  const float* slab = bias_slab(bias, g, b, h);

  load_rows(sK, ldr, k + (bh * g.Lk + k0) * D, D, Dp);
  load_rows(sV, ldr, v + (bh * g.Lk + k0) * D, D, Dp);
  int mk[4];  // the thread's keys 4 ty + i
  float dka[4][NJ], dva[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mk[i] = mask == nullptr ? 0 : mask[(size_t)b * g.Lk + k0 + 4 * ty + i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[i][j] = dva[i][j] = 0.f;
  }

  for (int q0 = 0; q0 < g.Lq; q0 += kTile) {
    __syncthreads();
    load_transposed(sQT, q + (bh * g.Lq + q0) * D, D, Dp);
    load_transposed(sDOT, dout + (bh * g.Lq + q0) * D, D, Dp);
    if (tid < kTile) {
      sLse[tid] = lse[bh * g.Lq + q0 + tid];
      sDi[tid] = di[bh * g.Lq + q0 + tid];
    }
    if (slab != nullptr)
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int r = e / kTile, c = e - r * kTile;
        sB[r * kLdB + c] = slab[(size_t)(q0 + r) * g.Lk + k0 + c];
      }
    __syncthreads();

    // transposed tiles: st[i][e] = s of query 4 tx + e and key 4 ty + i
    float st[4][4], dpt[4][4];
    tile_dots(sK, ldr, sQT, Dp, ty, tx, st);
    tile_dots(sV, ldr, sDOT, Dp, ty, tx, dpt);
    float lq[4], dq_[4];
    unpack(*reinterpret_cast<const float4*>(sLse + 4 * tx), lq);
    unpack(*reinterpret_cast<const float4*>(sDi + 4 * tx), dq_);
    uint32_t keep[4];  // per query: the bits of keys 4 ty .. 4 ty + 3
#pragma unroll
    for (int e = 0; e < 4; ++e)
      keep[e] = dr.on ? keep4(dr, b, h, q0 + 4 * tx + e, k0 + 4 * ty) : 0xFu;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float pd[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float bb = slab != nullptr ? sB[(4 * tx + e) * kLdB + 4 * ty + i] : 0.f;
        const float p = mk[i] ? 0.f : expf(st[i][e] * sm_scale + bb - lq[e]);
        const bool kept = !dr.on || ((keep[e] >> i) & 1u);
        const float gp = kept ? dpt[i][e] * (dr.on ? dr.scale : 1.f) : 0.f;
        pd[e] = round_to<T>(kept ? p * (dr.on ? dr.scale : 1.f) : 0.f);
        ds[e] = round_to<T>(mk[i] ? 0.f : p * (gp - dq_[e]));
      }
      *reinterpret_cast<float4*>(sPT + (4 * ty + i) * kLdT + 4 * tx) =
          make_float4(pd[0], pd[1], pd[2], pd[3]);
      *reinterpret_cast<float4*>(sDST + (4 * ty + i) * kLdT + 4 * tx) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    tile_times<NJ>(sPT, sDOT, Dp, ty, tx, dva);
    tile_times<NJ>(sDST, sQT, Dp, ty, tx, dka);
  }
  store_rows<T, NJ>(dk + (bh * g.Lk + k0) * D, D, ty, tx, dka, sm_scale);
  store_rows<T, NJ>(dv + (bh * g.Lk + k0) * D, D, ty, tx, dva, 1.f);
}

// ---------------------------------------------------------------------------
// dbias: chunked partial sums, then an ordered reduction
// ---------------------------------------------------------------------------

struct DbPlan {
  int R;       // batches per bias group
  int rchunk;  // batches per block
  int chunks;  // blocks per (group, head, q tile, k tile)
};

DbPlan db_plan(const Geom& g) {
  const int R = g.B / g.Bb;
  const long long tiles = (long long)g.Bb * g.H * (g.Lq / kTile) * (g.Lk / kTile);
  long long want = (kDbBlocks + tiles - 1) / tiles;
  if (want > R) want = R;
  if (want < 1) want = 1;
  const int rchunk = (int)((R + want - 1) / want);
  return DbPlan{R, rchunk, (R + rchunk - 1) / rchunk};
}

// grid (k tiles, q tiles, (group * H + head) * chunks + chunk); partial is
// (chunks, Bb, H, Lq, Lk)
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_db_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ bias, const int* __restrict__ mask,
                const float* __restrict__ lse, const float* __restrict__ di,
                const T* __restrict__ dout, float* __restrict__ partial, Geom g, DbPlan pl,
                float sm_scale, Dropout dr) {
  extern __shared__ __align__(16) float smem[];
  const int D = g.D, Dp = pad4(D), ldr = Dp + 4;
  float* sQ = smem;                  // 64 x ldr
  float* sDO = sQ + kTile * ldr;     // 64 x ldr
  float* sKT = sDO + kTile * ldr;    // Dp x kLdT
  float* sVT = sKT + Dp * kLdT;      // Dp x kLdT
  int* sM = reinterpret_cast<int*>(sVT + Dp * kLdT);  // 64

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * kTile, q0 = blockIdx.y * kTile;
  const int chunk = blockIdx.z % pl.chunks;
  const int gh = blockIdx.z / pl.chunks, h = gh % g.H, grp = gh / g.H;
  const int r_end = min(pl.R, (chunk + 1) * pl.rchunk);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int r = chunk * pl.rchunk; r < r_end; ++r) {
    const int b = grp * pl.R + r;
    const size_t bh = (size_t)b * g.H + h;
    __syncthreads();
    load_rows(sQ, ldr, q + (bh * g.Lq + q0) * D, D, Dp);
    load_rows(sDO, ldr, dout + (bh * g.Lq + q0) * D, D, Dp);
    load_transposed(sKT, k + (bh * g.Lk + k0) * D, D, Dp);
    load_transposed(sVT, v + (bh * g.Lk + k0) * D, D, Dp);
    if (tid < kTile) sM[tid] = mask == nullptr ? 0 : mask[(size_t)b * g.Lk + k0 + tid];
    __syncthreads();

    float s[4][4], dp[4][4], ds[4][4], lr[4], dil[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lr[i] = lse[bh * g.Lq + q0 + 4 * ty + i];
      dil[i] = di[bh * g.Lq + q0 + 4 * ty + i];
    }
    tile_dots(sQ, ldr, sKT, Dp, ty, tx, s);
    tile_dots(sDO, ldr, sVT, Dp, ty, tx, dp);
    int mk[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) mk[e] = sM[4 * tx + e];
    tile_ds<T>(s, dp, mk, bias_slab(bias, g, b, h), g, b, h, q0, k0, ty, tx, lr, dil, sm_scale,
               dr, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += ds[i][e];
  }
  float* out = partial + (((size_t)chunk * g.Bb + grp) * g.H + h) * g.Lq * g.Lk;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(out + (size_t)(q0 + 4 * ty + i) * g.Lk + k0 + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// db (Bb, Hb, Lq, Lk) = sum over chunks (and over heads when Hb == 1) of the
// partials, always in the same order
__global__ void __launch_bounds__(kThreads)
flash_db_reduce_kernel(const float* __restrict__ partial, float* __restrict__ db, Geom g,
                       int chunks) {
  const size_t LL = (size_t)g.Lq * g.Lk;
  const size_t n = (size_t)g.Bb * g.Hb * LL;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (size_t)gridDim.x * kThreads) {
    const size_t idx = e % LL;
    const int gh = (int)(e / LL), hb = gh % g.Hb, grp = gh / g.Hb;
    const int h_lo = g.Hb > 1 ? hb : 0, h_hi = g.Hb > 1 ? hb + 1 : g.H;
    float sum = 0.f;
    for (int h = h_lo; h < h_hi; ++h)
      for (int c = 0; c < chunks; ++c)
        sum += partial[(((size_t)c * g.Bb + grp) * g.H + h) * LL + idx];
    db[e] = sum;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

bool bad_geometry(const Geom& g) {
  return g.B <= 0 || g.H <= 0 || g.B > 65535 || g.H > 65535 || g.Lq <= 0 || g.Lk <= 0 ||
         g.Lq % kTile != 0 || g.Lk % kTile != 0 || g.D <= 0 || g.D > 128 ||
         (g.Bb > 0 && (g.B % g.Bb != 0 || (g.Hb != 1 && g.Hb != g.H)));
}

// what every entry point hands its kernels
struct Args {
  const void *q, *k, *v, *bias, *mask, *lse, *di, *dout;
  void *out0, *out1;  // fwd: o, lse; dq: dq; dkv: dk, dv; db: partial, db
  Geom g;
  float sm_scale;
  Dropout dr;
  cudaStream_t stream;
};

template <typename K>
cudaError_t with_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct FwdLaunch {
  template <typename T, int NJ>
  cudaError_t run(const Args& a) const {
    const size_t smem = query_major_smem(a.g.D, 1, 2);
    auto kernel = flash_fwd_kernel<T, NJ>;
    cudaError_t err = with_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(a.g.Lq / kTile, a.g.H, a.g.B), kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const float*>(a.bias), static_cast<const int*>(a.mask),
        static_cast<T*>(a.out0), static_cast<float*>(a.out1), a.g, a.sm_scale, a.dr);
    return cudaGetLastError();
  }
};

struct DqLaunch {
  template <typename T, int NJ>
  cudaError_t run(const Args& a) const {
    const size_t smem = query_major_smem(a.g.D, 2, 2);
    auto kernel = flash_dq_kernel<T, NJ>;
    cudaError_t err = with_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(a.g.Lq / kTile, a.g.H, a.g.B), kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const float*>(a.bias), static_cast<const int*>(a.mask),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
        static_cast<const T*>(a.dout), static_cast<T*>(a.out0), a.g, a.sm_scale, a.dr);
    return cudaGetLastError();
  }
};

struct DkvLaunch {
  template <typename T, int NJ>
  cudaError_t run(const Args& a) const {
    const size_t smem = dkv_smem(a.g.D, a.bias != nullptr);
    auto kernel = flash_dkv_kernel<T, NJ>;
    cudaError_t err = with_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(a.g.Lk / kTile, a.g.H, a.g.B), kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const float*>(a.bias), static_cast<const int*>(a.mask),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
        static_cast<const T*>(a.dout), static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.g,
        a.sm_scale, a.dr);
    return cudaGetLastError();
  }
};

struct DbLaunch {
  DbPlan pl;
  template <typename T, int NJ>  // NJ unused: dbias writes no output rows
  cudaError_t run(const Args& a) const {
    const size_t smem = query_major_smem(a.g.D, 2, 2) - sizeof(float) * kTile * kLdT;
    auto kernel = flash_db_kernel<T>;
    cudaError_t err = with_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(a.g.Lk / kTile, a.g.Lq / kTile, a.g.Bb * a.g.H * pl.chunks), kThreads, smem,
             a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const float*>(a.bias), static_cast<const int*>(a.mask),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
        static_cast<const T*>(a.dout), static_cast<float*>(a.out0), a.g, pl, a.sm_scale, a.dr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t n = (size_t)a.g.Bb * a.g.Hb * a.g.Lq * a.g.Lk;
    const size_t blocks = (n + kThreads - 1) / kThreads;
    flash_db_reduce_kernel<<<(int)(blocks < 4096 ? blocks : 4096), kThreads, 0, a.stream>>>(
        static_cast<const float*>(a.out0), static_cast<float*>(a.out1), a.g, pl.chunks);
    return cudaGetLastError();
  }
};

// f.run<T, NJ>(a) for the dtype code and the head dim (NJ column groups of
// 16: D <= 32, 64, 128)
template <typename F>
cudaError_t dispatch(int dtype, const F& f, const Args& a) {
  const int D = a.g.D;
  if (dtype == kFloat32) {
    if (D <= 32) return f.template run<float, 2>(a);
    if (D <= 64) return f.template run<float, 4>(a);
    return f.template run<float, 8>(a);
  }
  if (dtype == kBFloat16) {
    if (D <= 32) return f.template run<__nv_bfloat16, 2>(a);
    if (D <= 64) return f.template run<__nv_bfloat16, 4>(a);
    return f.template run<__nv_bfloat16, 8>(a);
  }
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* bias, const void* mask,
               const void* lse, const void* di, const void* dout, void* out0, void* out1, int B,
               int H, int Lq, int Lk, int D, int Bb, int Hb, float sm_scale, int dropout,
               int seed, unsigned threshold, float keep_scale, void* stream) {
  const Geom g{B, H, Lq, Lk, D, bias == nullptr ? 0 : Bb, bias == nullptr ? 1 : Hb};
  return Args{q, k, v, bias, mask, lse, di, dout, out0, out1, g, sm_scale,
              make_dropout(dropout, seed, threshold, keep_scale),
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// o: (B, H, Lq, D) in the inputs' type; lse: (B, H, Lq) fp32
extern "C" int unicore_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, const void* mask, void* o,
    void* lse, int B, int H, int Lq, int Lk, int D, int Bb, int Hb, float sm_scale, int dropout,
    int seed, unsigned threshold, float keep_scale, int dtype, void* stream) {
  const Args a = make_args(q, k, v, bias, mask, nullptr, nullptr, nullptr, o, lse, B, H, Lq, Lk,
                           D, Bb, Hb, sm_scale, dropout, seed, threshold, keep_scale, stream);
  if (bad_geometry(a.g)) return (int)cudaErrorInvalidValue;
  return (int)dispatch(dtype, FwdLaunch{}, a);
}

// dq: (B, H, Lq, D) in the inputs' type; lse, di: (B, H, Lq) fp32
extern "C" int unicore_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* bias, const void* mask,
    const void* lse, const void* di, const void* dout, void* dq, int B, int H, int Lq, int Lk,
    int D, int Bb, int Hb, float sm_scale, int dropout, int seed, unsigned threshold,
    float keep_scale, int dtype, void* stream) {
  const Args a = make_args(q, k, v, bias, mask, lse, di, dout, dq, nullptr, B, H, Lq, Lk, D, Bb,
                           Hb, sm_scale, dropout, seed, threshold, keep_scale, stream);
  if (bad_geometry(a.g)) return (int)cudaErrorInvalidValue;
  return (int)dispatch(dtype, DqLaunch{}, a);
}

// dk, dv: (B, H, Lk, D) in the inputs' type
extern "C" int unicore_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* bias, const void* mask,
    const void* lse, const void* di, const void* dout, void* dk, void* dv, int B, int H, int Lq,
    int Lk, int D, int Bb, int Hb, float sm_scale, int dropout, int seed, unsigned threshold,
    float keep_scale, int dtype, void* stream) {
  const Args a = make_args(q, k, v, bias, mask, lse, di, dout, dk, dv, B, H, Lq, Lk, D, Bb, Hb,
                           sm_scale, dropout, seed, threshold, keep_scale, stream);
  if (bad_geometry(a.g)) return (int)cudaErrorInvalidValue;
  return (int)dispatch(dtype, DkvLaunch{}, a);
}

// floats of the fp32 scratch unicore_flash_attention_db needs; 0 for a
// geometry it refuses
extern "C" long long unicore_flash_attention_db_scratch(int B, int H, int Lq, int Lk, int Bb) {
  const Geom g{B, H, Lq, Lk, 1, Bb, 1};
  if (Bb <= 0 || bad_geometry(g)) return 0;
  return (long long)db_plan(g).chunks * Bb * H * Lq * Lk;
}

// db: (Bb, Hb, Lq, Lk) fp32, every element written; partial: the scratch
// of unicore_flash_attention_db_scratch floats
extern "C" int unicore_flash_attention_db(
    const void* q, const void* k, const void* v, const void* bias, const void* mask,
    const void* lse, const void* di, const void* dout, void* partial, void* db, int B, int H,
    int Lq, int Lk, int D, int Bb, int Hb, float sm_scale, int dropout, int seed,
    unsigned threshold, float keep_scale, int dtype, void* stream) {
  const Args a = make_args(q, k, v, bias, mask, lse, di, dout, partial, db, B, H, Lq, Lk, D, Bb,
                           Hb, sm_scale, dropout, seed, threshold, keep_scale, stream);
  if (bias == nullptr || bad_geometry(a.g)) return (int)cudaErrorInvalidValue;
  const DbPlan pl = db_plan(a.g);
  if ((long long)Bb * H * pl.chunks > 65535) return (int)cudaErrorInvalidValue;
  return (int)dispatch(dtype, DbLaunch{pl}, a);
}
