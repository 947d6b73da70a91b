// Full-row attention, forward and backward, for Hopper (sm_90a) tensor cores.
//
// Replaces the TPU kernels of unicore_tpu/ops/attention_fullrow.py:
//   `_fwd_kernel` (:110, launched by `_fwd` :160)  -> fullrow_fwd_kernel
//   `_bwd_kernel` (:205, launched by `_bwd` :289)  -> fullrow_dq_kernel, then
//                                                    fullrow_dkv_kernel
// the two halves of the `jax.custom_vjp` `_fullrow` (:370).
//
// What they compute (the TPU kernels' maths, not their block structure):
//   forward   s = (q k^T) * sm_scale + bias;  s = NEG_INF where the key is
//             masked;  p = exp(s - rowmax(s)), 0 where masked, times
//             (l > 0 ? 1/l : 0) with l = rowsum(p), so a fully-masked row
//             gives zeros;  dropout: pd = keep ? p / (1 - rate) : 0;
//             pd is cast to v's type, then o = pd v with fp32 accumulation.
//   backward  p recomputed as above and the keep mask regenerated;
//             dp = do v^T;  dp_keep = keep ? dp / (1 - rate) : 0;
//             di = rowsum(pd * dp);  ds = p * (dp_keep - di), 0 on masked
//             keys (as `_bwd_kernel` :256-259);  dv = pd^T do,
//             dq = sm_scale * ds k,  dk = sm_scale * ds^T q,
//             dbias = sum of ds over the batch (and over the heads when the
//             bias is shared across heads), in fp32.  bf16 inputs round pd
//             and ds to bf16 before the products, as the TPU kernel does.
// q, k, v, o, do, dq are (B, H, L, D) fp32 or bf16; bias is (1, 1|H, Lq, Lk)
// fp32; the key mask is (B, Lk) int32, nonzero = masked.  Lq, Lk are
// multiples of 128 up to 1024 and D <= 128, as the shared `supported()`
// gate routes (the kernels take multiples of 64; D is zero-padded to 16,
// 32, 64 or 128 in shared memory).
//
// Dropout: the TPU stream (pltpu.prng_random_bits) cannot be reproduced off
// the TPU, so the keep bits come from Philox4x32-10 (common.cuh) keyed on
// the int32 seed, with the counter (key column / 4, query row, head, batch):
// one Philox call gives the bits of four neighbouring key columns, and the
// backward regenerates exactly the forward's mask without storing it.  The
// keep rule is the TPU's: keep when bits >= min(int(rate * 2^32), 2^32 - 1)
// as uint32, scale by 1 / (1 - rate).  The plain version in
// ops/attention_fullrow.py computes the same bits in torch integer ops, so
// the two agree bit for bit on the mask.  A lane computes each call once
// and hands its four bits to the lanes that hold the other columns by
// shuffle: two lanes share a call in the query-major kernels, four in the
// key-major one, so no call is made twice.
//
// What bounds them on this card: operations.  At the main shape (B=8, H=12,
// L=512, D=64, fp32) the forward's two products are 6.44 GFLOP and the
// backward's five 16.1 GFLOP, against 19 and 34 us of fp32 traffic.  Held
// to fp32 accuracy, the least time is at the 3xTF32 rate (495 / 3 = 165
// TFLOP/s): 39 and 98 us; bf16 runs at 989 TFLOP/s.
//
// What the design does about it (FlashAttention-2's shape on mma.sync):
//   * Products on tensor cores (mma.cuh): fp32 inputs as 3xTF32 on
//     m16n8k8 (hi/lo split, three products, fp32 accumulators; never one
//     plain TF32 product), bf16 inputs as one m16n8k16 bf16 product.  The
//     split rounds with integer operations on the bits rather than
//     `cvt.rna.tf32.f32` (the same values), because the splits, not the
//     tensor cores, limit these kernels: on an H100 at the main shape the
//     backward took 1.18 ms with the conversion and 0.86 ms with integer
//     rounding, 0.74 ms with one integer operation fewer for lo (mma.cuh).
//   * Blocks of 4 warps; a warp owns 16 rows of a 64-row tile.  K/V (or Q
//     and do) tiles of 64 rows stream through a two-stage cp.async ring in
//     shared memory: the next tile's copy overlaps this tile's products.
//     Rows are padded by 16 bytes, so fragment reads hit 32 distinct banks.
//   * Scores never leave registers: the forward runs an online softmax
//     (running max and sum a row; a masked key adds exactly 0, a row with
//     every key masked ends with l = 0 and writes zeros), and the products
//     that take p or ds as their A operand take it straight from the
//     accumulator (mma.cuh).  For bf16 the forward rounds the unnormalised
//     dropped numerator before p v, where the TPU rounds the normalised
//     one; the two differ by about one bf16 rounding of each term.
//   * The bias is read from device memory (L2-resident: one (Lq, Lk) slab
//     per head, shared by the batch) at each lane's accumulator places,
//     for a whole tile into registers before the tile's barrier, so the
//     loads overlap the wait and the products.
//   * When a backward will follow, the forward writes the row statistic
//     lse = m + log(l) (fp32, (B, H, Lq)); the serving path writes none.
//   * Backward, two launches and no atomics for dq, dk, dv:
//       fullrow_dq_kernel (grid Lq/64 x H x B, query-major): di per row --
//         rowsum(do * o) from the saved output for fp32, and for bf16 a
//         first sweep summing the fp32 pd * dp as the TPU does (o is
//         rounded there) -- then p = exp(s - lse), dp, ds over the K/V
//         tiles, dq = sm_scale ds k in registers written once, and dbias
//         by fp32 atomicAdd (float2, two neighbouring keys an add) per
//         (b, h).  It writes di.
//       fullrow_dkv_kernel (grid Lk/64 x H x B, key-major): streams the q
//         and do tiles (64 rows; 32 at D > 64 to keep four accumulator
//         sets in registers), recomputes s^T, dp^T, p, the keep bits and
//         ds, and sums dv = pd^T do and dk = sm_scale ds^T q in registers,
//         written once as fp32: no zeroed buffers, and the same bits from
//         run to run.
//     Five products would do (FlashAttention-2 recomputes s and dp once,
//     key-major, and adds dq by atomics through a shared ds tile); that
//     form measured 0.85 ms against these two launches' 0.86 on an H100
//     (main shape, fp32, both with integer rounding): its shared ds tile,
//     two more barriers a tile and 25 M dq atomics cost what the two
//     products it saves cost, and its dq would change from run to run.
// Offsets are 64-bit; dynamic shared memory up to 202 KB (the dq kernel,
// fp32, D = 128).
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace unicore;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;          // rows a block owns, rows of a streamed tile
constexpr float kNegInf = -1e30f;  // NEG_INF of ops/flash_attention.py
constexpr unsigned kFull = 0xffffffffu;

struct Geom {
  int B, H, Lq, Lk, D, bias_heads;
  float sm_scale;
};

// The keep bits (bit w: key column c0 + w) a lane needs for its two rows of
// one 16 x 8 accumulator tile in the query-major kernels: the lane holds
// columns 2t, 2t+1 of rows g and g+8; lanes t and t^1 share the 4-column
// group, so the even one computes row g's call, the odd one row g+8's, and
// they swap.  Returns {row g bits, row g+8 bits}.
__device__ __forceinline__ uint2 keep_rows(const Dropout& dr, int b, int h, int row_g, int c0,
                                           int t) {
  const uint32_t mine = keep4(dr, b, h, row_g + ((t & 1) ? 8 : 0), c0);
  const uint32_t other = __shfl_xor_sync(kFull, mine, 1);
  return (t & 1) ? make_uint2(other, mine) : make_uint2(mine, other);
}

// The bias of one 64-key tile at a query-major lane's accumulator places
// (rows g, g+8 of `brow`; columns key0 + 8n + 2t, +1), as float2 loads;
// zeros without a bias.
template <int NT>
__device__ __forceinline__ void load_bias(float (&bv)[NT][4], const float* brow, int Lk,
                                          int key0, int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float2 a = make_float2(0.f, 0.f), c = a;
    if (brow != nullptr) {
      a = *reinterpret_cast<const float2*>(brow + key0 + n * 8 + 2 * t);
      c = *reinterpret_cast<const float2*>(brow + (size_t)8 * Lk + key0 + n * 8 + 2 * t);
    }
    bv[n][0] = a.x;
    bv[n][1] = a.y;
    bv[n][2] = c.x;
    bv[n][3] = c.y;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int DP>
size_t fwd_smem_bytes(int Lk) {
  return sizeof(T) * (size_t)5 * kTile * tile_ld<T>(DP) + sizeof(int) * (size_t)Lk;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
fullrow_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ bias, const int* __restrict__ mask,
                   T* __restrict__ o, float* __restrict__ lse, Geom gm, Dropout dr) {
  using M = Mma<T>;
  constexpr int LD = tile_ld<T>(DP);
  constexpr int NT = kTile / 8;  // accumulator tiles across 64 keys
  constexpr int NO = DP / 8;     // accumulator tiles across the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // 64 x LD
  T* sK = sQ + kTile * LD;                 // 2 stages of 64 x LD
  T* sV = sK + 2 * kTile * LD;             // 2 stages of 64 x LD
  int* sM = reinterpret_cast<int*>(sV + 2 * kTile * LD);  // Lk

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int D = gm.D, Lk = gm.Lk;
  const size_t bh = (size_t)b * gm.H + h;
  const bool vec = (D * sizeof(T)) % 16 == 0;
  const T* kb = k + bh * Lk * D;
  const T* vb = v + bh * Lk * D;

  load_rows_async(sQ, LD, q + (bh * gm.Lq + q0) * D, kTile, D, DP, vec, kThreads);
  load_rows_async(sK, LD, kb, kTile, D, DP, vec, kThreads);
  load_rows_async(sV, LD, vb, kTile, D, DP, vec, kThreads);
  cp_async_commit();
  for (int c = threadIdx.x; c < Lk; c += kThreads)
    sM[c] = mask == nullptr ? 0 : mask[(size_t)b * Lk + c];

  const int row = q0 + warp * 16 + g;  // this lane's rows: row, row + 8
  const float* brow =
      bias == nullptr
          ? nullptr
          : bias + ((size_t)(gm.bias_heads > 1 ? h : 0) * gm.Lq + row) * Lk;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-__int_as_float(0x7f800000), -__int_as_float(0x7f800000)};
  float l[2] = {0.f, 0.f};

  const int ntiles = Lk / kTile;
  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    if (j + 1 < ntiles) {
      load_rows_async(sK + (st ^ 1) * kTile * LD, LD, kb + (size_t)(j + 1) * kTile * D, kTile,
                      D, DP, vec, kThreads);
      load_rows_async(sV + (st ^ 1) * kTile * LD, LD, vb + (size_t)(j + 1) * kTile * D, kTile,
                      D, DP, vec, kThreads);
    }
    cp_async_commit();
    const int key0 = j * kTile;
    float bv[NT][4];  // this tile's bias, loaded before the wait and the products
    load_bias(bv, brow, Lk, key0, t);
    cp_async_wait<1>();  // tile j (and q) have landed
    __syncthreads();
    const T* cK = sK + st * kTile * LD;
    const T* cV = sV + st * kTile * LD;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += M::kK) {
      const typename M::A a = M::load_a(sQ, LD, warp * 16, kk);
#pragma unroll
      for (int n = 0; n < NT; ++n) M::mma(s[n], a, M::load_b_nmajor(cK, LD, n * 8, kk));
    }

    // scale, bias and mask; the running max of each row
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + n * 8 + 2 * t + (e & 1), r = e >> 1;
        const float x = sM[key] != 0 ? kNegInf : s[n][e] * gm.sm_scale + bv[n][e];
        s[n][e] = x;
        tmax[r] = fmaxf(tmax[r], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(tmax[r]));
      corr[r] = __expf(m[r] - mn);  // 0 on the first tile (m = -inf)
      m[r] = mn;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // numerators, their sum, dropout and the cast to v's type
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint2 keep = make_uint2(0xFu, 0xFu);
      if (dr.on) keep = keep_rows(dr, b, h, row, key0 + n * 8 + 4 * (t >> 1), t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + n * 8 + 2 * t + (e & 1), r = e >> 1;
        const float p = sM[key] != 0 ? 0.f : __expf(s[n][e] - m[r]);
        l[r] += p;
        float pd = p;
        if (dr.on) {
          const uint32_t bits = r ? keep.y : keep.x;
          pd = (bits >> (2 * (t & 1) + (e & 1))) & 1u ? p * dr.scale : 0.f;
        }
        s[n][e] = round_to<T>(pd);
      }
    }

    // acc += pd v
#pragma unroll
    for (int ks = 0; ks < kTile / M::kK; ++ks) {
      const typename M::A a = M::template a_from_acc<NT>(s, ks);
#pragma unroll
      for (int n = 0; n < NO; ++n)
        M::mma(acc[n], a, M::load_b_kmajor(cV, LD, ks * M::kK, n * 8));
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
  T* orow = o + (bh * gm.Lq + row) * D;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = n * 8 + 2 * t + (e & 1), r = e >> 1;
      if (d < D) orow[(size_t)r * 8 * D + d] = from_f<T>(acc[n][e] * inv[r]);
    }
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lse[bh * gm.Lq + row + 8 * r] = l[r] > 0.f ? m[r] + logf(l[r]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// backward, launch 1: di, dq and dbias, query-major
// ---------------------------------------------------------------------------

template <typename T, int DP>
size_t dq_smem_bytes(int Lk) {
  return sizeof(T) * (size_t)6 * kTile * tile_ld<T>(DP) + sizeof(int) * (size_t)Lk +
         sizeof(float) * 2 * kTile;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
fullrow_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ bias, const int* __restrict__ mask,
                  const T* __restrict__ o, const T* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ di_out,
                  T* __restrict__ dq, float* __restrict__ db, Geom gm, Dropout dr) {
  using M = Mma<T>;
  constexpr int LD = tile_ld<T>(DP);
  constexpr int NT = kTile / 8;
  constexpr int NO = DP / 8;
  // fp32: di = rowsum(do * o) from the saved output.  bf16: o is rounded,
  // so di is summed from the fp32 pd * dp in a first sweep, as the TPU does.
  constexpr bool kDiFromOut = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // 64 x LD
  T* sDO = sQ + kTile * LD;                // 64 x LD
  T* sK = sDO + kTile * LD;                // 2 stages
  T* sV = sK + 2 * kTile * LD;             // 2 stages
  float* sLse = reinterpret_cast<float*>(sV + 2 * kTile * LD);  // 64
  float* sDi = sLse + kTile;                                     // 64
  int* sM = reinterpret_cast<int*>(sDi + kTile);                 // Lk

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int D = gm.D, Lk = gm.Lk;
  const size_t bh = (size_t)b * gm.H + h;
  const bool vec = (D * sizeof(T)) % 16 == 0;
  const T* kb = k + bh * Lk * D;
  const T* vb = v + bh * Lk * D;
  const size_t qrow0 = bh * gm.Lq + q0;

  load_rows_async(sQ, LD, q + qrow0 * D, kTile, D, DP, vec, kThreads);
  load_rows_async(sDO, LD, dout + qrow0 * D, kTile, D, DP, vec, kThreads);
  for (int c = threadIdx.x; c < Lk; c += kThreads)
    sM[c] = mask == nullptr ? 0 : mask[(size_t)b * Lk + c];
  for (int r = threadIdx.x; r < kTile; r += kThreads) sLse[r] = lse[qrow0 + r];
  if (kDiFromOut) {
    for (int r = warp; r < kTile; r += kWarps) {
      const T* orow = o + (qrow0 + r) * D;
      const T* drow = dout + (qrow0 + r) * D;
      float sum = 0.f;
      for (int d = lane; d < D; d += 32) sum += to_f(orow[d]) * to_f(drow[d]);
      sum = warp_sum(sum);
      if (lane == 0) sDi[r] = sum;
    }
  }

  const int row = q0 + warp * 16 + g;
  const int lrow = warp * 16 + g;  // row within the block's tile
  const size_t brow_off = ((size_t)(gm.bias_heads > 1 ? h : 0) * gm.Lq + row) * Lk;
  const float* brow = bias == nullptr ? nullptr : bias + brow_off;
  float* dbrow = db == nullptr ? nullptr : db + brow_off;

  float dqa[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
  float di[2] = {0.f, 0.f};

  const int ntiles = Lk / kTile;
  // pass 0 (bf16 only): di; pass 1: ds, dq, dbias
  for (int pass = kDiFromOut ? 1 : 0; pass < 2; ++pass) {
    load_rows_async(sK, LD, kb, kTile, D, DP, vec, kThreads);
    load_rows_async(sV, LD, vb, kTile, D, DP, vec, kThreads);
    cp_async_commit();
    if (pass == 1) {
      if (!kDiFromOut) {
        // the first sweep's per-lane sums -> sDi
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float s = quad_sum(di[r]);
          if (t == 0) sDi[lrow + 8 * r] = s;
        }
      }
      __syncthreads();  // sDi complete
      di[0] = sDi[lrow];
      di[1] = sDi[lrow + 8];
      if (t == 0) {
        di_out[qrow0 + lrow] = di[0];
        di_out[qrow0 + lrow + 8] = di[1];
      }
    }
    for (int j = 0; j < ntiles; ++j) {
      const int st = j & 1;
      if (j + 1 < ntiles) {
        load_rows_async(sK + (st ^ 1) * kTile * LD, LD, kb + (size_t)(j + 1) * kTile * D,
                        kTile, D, DP, vec, kThreads);
        load_rows_async(sV + (st ^ 1) * kTile * LD, LD, vb + (size_t)(j + 1) * kTile * D,
                        kTile, D, DP, vec, kThreads);
      }
      cp_async_commit();
      const int key0 = j * kTile;
      float bv[NT][4];
      load_bias(bv, brow, Lk, key0, t);
      cp_async_wait<1>();
      __syncthreads();
      const T* cK = sK + st * kTile * LD;
      const T* cV = sV + st * kTile * LD;

      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP; kk += M::kK) {
        const typename M::A aq = M::load_a(sQ, LD, warp * 16, kk);
        const typename M::A ado = M::load_a(sDO, LD, warp * 16, kk);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          M::mma(s[n], aq, M::load_b_nmajor(cK, LD, n * 8, kk));
          M::mma(dp[n], ado, M::load_b_nmajor(cV, LD, n * 8, kk));
        }
      }

#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint2 keep = make_uint2(0xFu, 0xFu);
        if (dr.on) keep = keep_rows(dr, b, h, row, key0 + n * 8 + 4 * (t >> 1), t);
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + n * 8 + 2 * t + (e & 1), r = e >> 1;
          const float x = s[n][e] * gm.sm_scale + bv[n][e];
          const float p = sM[key] != 0 ? 0.f : __expf(x - sLse[lrow + 8 * r]);
          float dpk = dp[n][e];
          if (dr.on) {
            const uint32_t bits = r ? keep.y : keep.x;
            dpk = (bits >> (2 * (t & 1) + (e & 1))) & 1u ? dpk * dr.scale : 0.f;
          }
          if (pass == 0) {
            di[r] += p * dpk;  // rowsum(pd * dp) == rowsum(p * dp_keep)
          } else {
            ds[e] = p * (dpk - di[r]);  // 0 on masked keys: p is 0 there
          }
        }
        if (pass == 1) {
          if (dbrow != nullptr) {  // columns 2t, 2t+1 of rows g, g+8: float2 adds
#pragma unroll
            for (int r = 0; r < 2; ++r)
              atomicAdd(reinterpret_cast<float2*>(dbrow + (size_t)r * 8 * Lk + key0 + n * 8 +
                                                  2 * t),
                        make_float2(ds[2 * r], ds[2 * r + 1]));
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = round_to<T>(ds[e]);
        }
      }

      if (pass == 1) {  // dq += ds k
#pragma unroll
        for (int ks = 0; ks < kTile / M::kK; ++ks) {
          const typename M::A a = M::template a_from_acc<NT>(s, ks);
#pragma unroll
          for (int n = 0; n < NO; ++n)
            M::mma(dqa[n], a, M::load_b_kmajor(cK, LD, ks * M::kK, n * 8));
        }
      }
      __syncthreads();
    }
  }

  T* dqrow = dq + (bh * gm.Lq + row) * D;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = n * 8 + 2 * t + (e & 1);
      if (d < D) dqrow[(size_t)(e >> 1) * 8 * D + d] = from_f<T>(gm.sm_scale * dqa[n][e]);
    }
}

// ---------------------------------------------------------------------------
// backward, launch 2: dk and dv, key-major
// ---------------------------------------------------------------------------

// query rows of a streamed q / do tile: 32 at D > 64, where four
// accumulator sets (s^T, dp^T, dk, dv) would not fit in registers at 64
template <int DP>
__host__ __device__ constexpr int dkv_tile_q() {
  return DP <= 64 ? 64 : 32;
}

template <typename T, int DP>
size_t dkv_smem_bytes() {
  constexpr int TQ = dkv_tile_q<DP>();
  return sizeof(T) * (size_t)(2 * kTile + 4 * TQ) * tile_ld<T>(DP) + sizeof(float) * 4 * TQ;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
fullrow_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ bias, const int* __restrict__ mask,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ di, float* __restrict__ dk,
                   float* __restrict__ dv, Geom gm, Dropout dr) {
  using M = Mma<T>;
  constexpr int LD = tile_ld<T>(DP);
  constexpr int TQ = dkv_tile_q<DP>();
  constexpr int NT = TQ / 8;  // accumulator tiles across a query tile
  constexpr int NO = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // 64 x LD: this block's keys
  T* sV = sK + kTile * LD;                 // 64 x LD
  T* sQ = sV + kTile * LD;                 // 2 stages of TQ x LD
  T* sDO = sQ + 2 * TQ * LD;               // 2 stages of TQ x LD
  float* sLse = reinterpret_cast<float*>(sDO + 2 * TQ * LD);  // 2 stages of TQ
  float* sDi = sLse + 2 * TQ;                                  // 2 stages of TQ

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int D = gm.D, Lq = gm.Lq, Lk = gm.Lk;
  const size_t bh = (size_t)b * gm.H + h;
  const bool vec = (D * sizeof(T)) % 16 == 0;
  const T* qb = q + bh * Lq * D;
  const T* dob = dout + bh * Lq * D;
  const float* lseb = lse + bh * Lq;
  const float* dib = di + bh * Lq;

  load_rows_async(sK, LD, k + (bh * Lk + k0) * D, kTile, D, DP, vec, kThreads);
  load_rows_async(sV, LD, v + (bh * Lk + k0) * D, kTile, D, DP, vec, kThreads);
  auto load_q_tile = [&](int i, int st) {
    load_rows_async(sQ + st * TQ * LD, LD, qb + (size_t)i * TQ * D, TQ, D, DP, vec, kThreads);
    load_rows_async(sDO + st * TQ * LD, LD, dob + (size_t)i * TQ * D, TQ, D, DP, vec,
                    kThreads);
    for (int c = threadIdx.x; c < TQ / 2; c += kThreads) {  // TQ/4 chunks of each
      const int which = c / (TQ / 4), off = 4 * (c % (TQ / 4));
      cp_async16((which ? sDi : sLse) + st * TQ + off, (which ? dib : lseb) + i * TQ + off,
                 16);
    }
  };
  load_q_tile(0, 0);
  cp_async_commit();

  const int key = k0 + warp * 16 + g;  // this lane's keys: key, key + 8
  bool masked[2] = {false, false};
  if (mask != nullptr) {
    masked[0] = mask[(size_t)b * Lk + key] != 0;
    masked[1] = mask[(size_t)b * Lk + key + 8] != 0;
  }
  const float* bcol =
      bias == nullptr ? nullptr
                      : bias + (size_t)(gm.bias_heads > 1 ? h : 0) * Lq * Lk + key;
  // the lanes whose Philox calls this lane reads: same t, g of this group of 4
  const int src0 = (g & ~3) * 4 + t;
  const int gkey = k0 + warp * 16 + (g & ~3) + ((g & 2) ? 8 : 0);  // this lane's call

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int ntiles = Lq / TQ;
  for (int i = 0; i < ntiles; ++i) {
    const int st = i & 1;
    if (i + 1 < ntiles) load_q_tile(i + 1, st ^ 1);
    cp_async_commit();
    const int qt0 = i * TQ;
    float bv[NT][4];  // bias at (query qt0 + 8n + 2t + (e & 1), key + 8 (e >> 1))
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        bv[n][e] = bcol == nullptr
                       ? 0.f
                       : bcol[(size_t)(qt0 + n * 8 + 2 * t + (e & 1)) * Lk + 8 * (e >> 1)];
    cp_async_wait<1>();
    __syncthreads();
    const T* cQ = sQ + st * TQ * LD;
    const T* cDO = sDO + st * TQ * LD;
    const float* cL = sLse + st * TQ;
    const float* cD = sDi + st * TQ;

    // s^T = k q^T and dp^T = v do^T for this warp's 16 keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += M::kK) {
      const typename M::A ak = M::load_a(sK, LD, warp * 16, kk);
      const typename M::A av = M::load_a(sV, LD, warp * 16, kk);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        M::mma(s[n], ak, M::load_b_nmajor(cQ, LD, n * 8, kk));
        M::mma(dp[n], av, M::load_b_nmajor(cDO, LD, n * 8, kk));
      }
    }

#pragma unroll
    for (int n = 0; n < NT; ++n) {
      // keep bits: element (key + 8 (e >> 1), query 2t + (e & 1)) reads
      // call e of its group of four lanes, bit g % 4
      uint32_t calls[4] = {0xFu, 0xFu, 0xFu, 0xFu};
      if (dr.on) {
        const uint32_t mine =
            keep4(dr, b, h, qt0 + n * 8 + 2 * t + (g & 1), gkey);
#pragma unroll
        for (int c = 0; c < 4; ++c) calls[c] = __shfl_sync(kFull, mine, src0 + 4 * c);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * t + (e & 1), r = e >> 1;
        const float x = s[n][e] * gm.sm_scale + bv[n][e];
        const float p = masked[r] ? 0.f : __expf(x - cL[ql]);
        float pd = p, dpk = dp[n][e];
        if (dr.on) {
          const bool kept = (calls[e] >> (g & 3)) & 1u;
          pd = kept ? p * dr.scale : 0.f;
          dpk = kept ? dpk * dr.scale : 0.f;
        }
        dp[n][e] = round_to<T>(p * (dpk - cD[ql]));  // ds^T
        s[n][e] = round_to<T>(pd);                   // pd^T
      }
    }

    // dv += pd^T do, dk += ds^T q
#pragma unroll
    for (int ks = 0; ks < TQ / M::kK; ++ks) {
      const typename M::A ap = M::template a_from_acc<NT>(s, ks);
      const typename M::A as = M::template a_from_acc<NT>(dp, ks);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        M::mma(dva[n], ap, M::load_b_kmajor(cDO, LD, ks * M::kK, n * 8));
        M::mma(dka[n], as, M::load_b_kmajor(cQ, LD, ks * M::kK, n * 8));
      }
    }
    __syncthreads();
  }

  float* dkrow = dk + (bh * Lk + key) * D;
  float* dvrow = dv + (bh * Lk + key) * D;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = n * 8 + 2 * t + (e & 1);
      if (d < D) {
        dkrow[(size_t)(e >> 1) * 8 * D + d] = gm.sm_scale * dka[n][e];
        dvrow[(size_t)(e >> 1) * 8 * D + d] = dva[n][e];
      }
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

bool bad_geometry(const Geom& g) {
  return g.B <= 0 || g.H <= 0 || g.B > 65535 || g.H > 65535 || g.Lq <= 0 || g.Lk <= 0 ||
         g.Lq % kTile != 0 || g.Lk % kTile != 0 || g.Lk > 1024 ||
         g.D <= 0 || g.D > 128 || g.bias_heads <= 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int DP>
cudaError_t launch_fwd_dp(const void* q, const void* k, const void* v, const void* bias,
                          const void* mask, void* o, void* lse, const Geom& g, Dropout dr,
                          cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<T, DP>(g.Lk);
  auto kernel = fullrow_fwd_kernel<T, DP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(g.Lq / kTile, g.H, g.B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const int*>(mask), static_cast<T*>(o),
      static_cast<float*>(lse), g, dr);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_bwd_dp(const void* q, const void* k, const void* v, const void* bias,
                          const void* mask, const void* o, const void* dout, const void* lse,
                          void* di, void* dq, void* dk, void* dv, void* db, const Geom& g,
                          Dropout dr, cudaStream_t stream) {
  const size_t smem1 = dq_smem_bytes<T, DP>(g.Lk);
  auto k1 = fullrow_dq_kernel<T, DP>;
  cudaError_t err = allow_smem(k1, smem1);
  if (err != cudaSuccess) return err;
  k1<<<dim3(g.Lq / kTile, g.H, g.B), kThreads, smem1, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const int*>(mask),
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(di), static_cast<T*>(dq), static_cast<float*>(db), g, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem2 = dkv_smem_bytes<T, DP>();
  auto k2 = fullrow_dkv_kernel<T, DP>;
  err = allow_smem(k2, smem2);
  if (err != cudaSuccess) return err;
  k2<<<dim3(g.Lk / kTile, g.H, g.B), kThreads, smem2, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const int*>(mask),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<float*>(dk), static_cast<float*>(dv), g, dr);
  return cudaGetLastError();
}

// the head dim padded to a multiple of the bf16 mma's k (16): 16, 32, 64, 128
template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias,
                       const void* mask, void* o, void* lse, const Geom& g, Dropout dr,
                       cudaStream_t s) {
  if (g.D <= 16) return launch_fwd_dp<T, 16>(q, k, v, bias, mask, o, lse, g, dr, s);
  if (g.D <= 32) return launch_fwd_dp<T, 32>(q, k, v, bias, mask, o, lse, g, dr, s);
  if (g.D <= 64) return launch_fwd_dp<T, 64>(q, k, v, bias, mask, o, lse, g, dr, s);
  return launch_fwd_dp<T, 128>(q, k, v, bias, mask, o, lse, g, dr, s);
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* bias,
                       const void* mask, const void* o, const void* dout, const void* lse,
                       void* di, void* dq, void* dk, void* dv, void* db, const Geom& g,
                       Dropout dr, cudaStream_t s) {
  if (g.D <= 16)
    return launch_bwd_dp<T, 16>(q, k, v, bias, mask, o, dout, lse, di, dq, dk, dv, db, g, dr,
                                s);
  if (g.D <= 32)
    return launch_bwd_dp<T, 32>(q, k, v, bias, mask, o, dout, lse, di, dq, dk, dv, db, g, dr,
                                s);
  if (g.D <= 64)
    return launch_bwd_dp<T, 64>(q, k, v, bias, mask, o, dout, lse, di, dq, dk, dv, db, g, dr,
                                s);
  return launch_bwd_dp<T, 128>(q, k, v, bias, mask, o, dout, lse, di, dq, dk, dv, db, g, dr,
                               s);
}

}  // namespace

// lse: fp32 (B, H, Lq) row statistics for a backward, or null (serving).
extern "C" int unicore_fullrow_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, const void* mask,
    void* o, void* lse, int B, int H, int Lq, int Lk, int D, int bias_heads, float sm_scale,
    int dropout, int seed, unsigned threshold, float keep_scale, int dtype, void* stream) {
  const Geom g{B, H, Lq, Lk, D, bias_heads, sm_scale};
  if (bad_geometry(g)) return (int)cudaErrorInvalidValue;
  const Dropout dr = make_dropout(dropout, seed, threshold, keep_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return (int)launch_fwd<float>(q, k, v, bias, mask, o, lse, g, dr, s);
  if (dtype == kBFloat16)
    return (int)launch_fwd<__nv_bfloat16>(q, k, v, bias, mask, o, lse, g, dr, s);
  return (int)cudaErrorInvalidValue;
}

// Two launches: di, dq and dbias, then dk and dv.  o and lse are the
// forward's output and row statistics; di: fp32 (B, H, Lq) scratch; dq in
// the inputs' type; dk, dv: fp32 (B, H, Lk, D), written (no zeroing
// needed); db: fp32 (1, bias_heads, Lq, Lk) zeroed by the caller (the
// kernel adds into it), or null.
extern "C" int unicore_fullrow_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias, const void* mask,
    const void* o, const void* dout, const void* lse, void* di, void* dq, void* dk, void* dv,
    void* db, int B, int H, int Lq, int Lk, int D, int bias_heads, float sm_scale, int dropout,
    int seed, unsigned threshold, float keep_scale, int dtype, void* stream) {
  const Geom g{B, H, Lq, Lk, D, bias_heads, sm_scale};
  if (bad_geometry(g) || lse == nullptr || o == nullptr || (db != nullptr && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  const Dropout dr = make_dropout(dropout, seed, threshold, keep_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)launch_bwd<float>(q, k, v, bias, mask, o, dout, lse, di, dq, dk, dv, db, g, dr,
                                  s);
  if (dtype == kBFloat16)
    return (int)launch_bwd<__nv_bfloat16>(q, k, v, bias, mask, o, dout, lse, di, dq, dk, dv,
                                          db, g, dr, s);
  return (int)cudaErrorInvalidValue;
}
