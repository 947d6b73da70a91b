// The tensor-core attention forward shared by the full-row kernel
// (attention_fullrow.cu, `fullrow_fwd_kernel`) and the flash kernel
// (flash_attention.cu, `flash_fwd_kernel`): one block of 4 warps computes 64
// query rows of one (batch, head), a warp 16 of them.
//
//   s = (q k^T) * sm_scale + bias;  s = NEG_INF (-1e30) where the key is
//   masked;  an online softmax over 64-key tiles in fp32: m' = max(m,
//   rowmax(s)), p = exp(s - m'), exactly 0 at masked keys, l' = l e^(m - m')
//   + rowsum(p), acc' = acc e^(m - m') + dropout(p) v, with dropout(p) =
//   keep ? p / (1 - rate) : 0 rounded to v's type before the product; out =
//   acc * (l > 0 ? 1 / l : 0).  A fully masked row ends with l = 0 and
//   writes zeros.
//
// Products on tensor cores (mma.cuh): 3xTF32 for fp32 inputs (never one
// plain TF32 product), one bf16 mma for bf16.  Q stays in shared memory; K,
// V (and, for the flash kernel, the tile's key mask) stream through a
// two-stage cp.async ring, so the next tile's copy overlaps this tile's
// products; rows are padded by 16 bytes (fragment reads on 32 banks).
// Scores and p never leave registers: p v takes p from the accumulator.
// The tile's bias is read into registers before the tile's barrier, so its
// loads overlap the wait.  The dropout's Philox calls are shared by
// shuffle, two lanes a call (`keep_rows`).
//
// The two kernels differ only in where the key mask comes from and in the
// row statistic they write:
//   full-row (kFlash = false): Lk <= 1024, the batch's whole key mask
//     staged once; lse = m + log(l) where l > 0, else 0, and only when a
//     backward will follow (lse non-null);
//   flash (kFlash = true): Lk unbounded, the key mask staged a tile at a
//     time through the ring; lse = m + log(max(l, 1e-37)) always, so a fully
//     masked row gives lse ~ -1e30, as the JAX flash kernel's.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace unicore {

constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdTile = 64;          // query rows a block owns, keys of a streamed tile
constexpr float kFwdNegInf = -1e30f;  // NEG_INF of ops/flash_attention.py

// dynamic shared memory of one block: Q, two stages of K and V, the mask
template <typename T, int DP, bool kFlash>
size_t attention_fwd_smem(int Lk) {
  return sizeof(T) * (size_t)5 * kFwdTile * tile_ld<T>(DP) +
         sizeof(int) * (size_t)(kFlash ? 2 * kFwdTile : Lk);
}

// The block's 64 rows.  qt: its query rows (row-major, D wide); kb, vb: the
// (batch, head)'s Lk keys and values; mrow: the batch's key mask (Lk int32,
// nonzero = masked) or null; slab: the (batch, head)'s (Lq, Lk) bias (TB:
// fp32 or bf16) or null; ot: the block's output rows; lse_t: the block's 64 row statistics
// or null.  b, h, q0: the dropout counter's batch, head and first query row.
template <typename T, typename TB, int DP, bool kFlash>
__device__ __forceinline__ void attention_fwd_block(
    const T* __restrict__ qt, const T* __restrict__ kb, const T* __restrict__ vb,
    const int* __restrict__ mrow, const TB* __restrict__ slab, T* __restrict__ ot,
    float* __restrict__ lse_t, int Lk, int D, float sm_scale, const Dropout& dr, int b, int h,
    int q0, unsigned char* smem_raw) {
  using M = Mma<T>;
  constexpr int LD = tile_ld<T>(DP);
  constexpr int NT = kFwdTile / 8;  // accumulator tiles across 64 keys
  constexpr int NO = DP / 8;        // accumulator tiles across the head dim
  T* sQ = reinterpret_cast<T*>(smem_raw);                  // 64 x LD
  T* sK = sQ + kFwdTile * LD;                              // 2 stages of 64 x LD
  T* sV = sK + 2 * kFwdTile * LD;                          // 2 stages of 64 x LD
  int* sM = reinterpret_cast<int*>(sV + 2 * kFwdTile * LD);  // flash: 2 stages of 64; else Lk

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool vec = (D * sizeof(T)) % 16 == 0;
  auto load_kv = [&](int j, int st) {
    load_rows_async(sK + st * kFwdTile * LD, LD, kb + (size_t)j * kFwdTile * D, kFwdTile, D, DP,
                    vec, kFwdThreads);
    load_rows_async(sV + st * kFwdTile * LD, LD, vb + (size_t)j * kFwdTile * D, kFwdTile, D, DP,
                    vec, kFwdThreads);
    if (kFlash && mrow != nullptr) load_mask_async(sM + st * kFwdTile, mrow + j * kFwdTile);
  };
  load_rows_async(sQ, LD, qt, kFwdTile, D, DP, vec, kFwdThreads);
  load_kv(0, 0);
  cp_async_commit();
  if (!kFlash) {
    for (int c = threadIdx.x; c < Lk; c += kFwdThreads) sM[c] = mrow == nullptr ? 0 : mrow[c];
  } else if (mrow == nullptr) {
    for (int c = threadIdx.x; c < 2 * kFwdTile; c += kFwdThreads) sM[c] = 0;
  }

  const int row = q0 + warp * 16 + g;  // this lane's rows: row, row + 8
  const TB* brow = slab == nullptr ? nullptr : slab + (size_t)row * Lk;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-__int_as_float(0x7f800000), -__int_as_float(0x7f800000)};
  float l[2] = {0.f, 0.f};

  const int ntiles = Lk / kFwdTile;
  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    if (j + 1 < ntiles) load_kv(j + 1, st ^ 1);
    cp_async_commit();
    const int key0 = j * kFwdTile;
    float bv[NT][4];  // this tile's bias, loaded before the wait and the products
    load_bias(bv, brow, Lk, key0, t);
    cp_async_wait<1>();  // tile j (and q) have landed
    __syncthreads();
    const T* cK = sK + st * kFwdTile * LD;
    const T* cV = sV + st * kFwdTile * LD;
    const int* cM = kFlash ? sM + st * kFwdTile : sM + key0;  // the tile's 64 mask entries

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
    float tmax[2] = {kFwdNegInf, kFwdNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = n * 8 + 2 * t + (e & 1), r = e >> 1;
        const float x = cM[kc] != 0 ? kFwdNegInf : s[n][e] * sm_scale + bv[n][e];
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
        const int kc = n * 8 + 2 * t + (e & 1), r = e >> 1;
        const float p = cM[kc] != 0 ? 0.f : __expf(s[n][e] - m[r]);
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
    for (int ks = 0; ks < kFwdTile / M::kK; ++ks) {
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
  T* orow = ot + (size_t)(warp * 16 + g) * D;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = n * 8 + 2 * t + (e & 1), r = e >> 1;
      if (d < D) orow[(size_t)r * 8 * D + d] = from_f<T>(acc[n][e] * inv[r]);
    }
  if (lse_t != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lse_t[warp * 16 + g + 8 * r] = kFlash ? m[r] + logf(fmaxf(l[r], 1e-37f))
                                            : (l[r] > 0.f ? m[r] + logf(l[r]) : 0.f);
  }
}

}  // namespace unicore
