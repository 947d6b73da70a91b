// Flash (online-softmax) attention with a grouped bias, forward and backward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels of unicore_tpu/ops/flash_attention.py, the
// halves of the `jax.custom_vjp` `_flash` (:679):
//   `_fwd_kernel` (:93)   -> flash_fwd_kernel      (unicore_flash_attention_fwd)
//   `_dq_kernel`  (:311)  -> flash_dq_kernel       (unicore_flash_attention_dq)
//   `_dkv_kernel` (:341)  -> flash_dkv_kernel      (unicore_flash_attention_dkv)
//   `_db_kernel`  (:387)  -> folded into flash_dkv_kernel, then
//                            flash_db_reduce_kernel where partial sums remain
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
//             ds = p * (dp - di), di = rowsum(out * do) in fp32 (as `_bwd`
//             :524), 0 at masked keys;
//             dq = sm_scale ds k, dk = sm_scale ds^T q, dv = dropout(p)^T do,
//             with ds and dropout(p) rounded to the inputs' type before
//             their products (bf16, as the TPU kernels' astype);
//             dbias = the fp32 ds summed over the R = B / Bb batches of each
//             bias group, and over the heads when Hb == 1.
// q, k, v, out, do, dq, dk, dv: (B, H, L, D) fp32 or bf16; bias (Bb, 1|H,
// Lq, Lk) fp32, or bf16 with bf16 inputs (a template argument, TB: read in
// place, widened on load; dbias summed in fp32 whatever its type); the key
// mask (B, Lk) int32, nonzero = masked; lse and di
// (B, H, Lq) fp32.  Lq, Lk multiples of 64 (the Python wrapper asks for 128,
// the TPU kernel's tiling; the router pads), D <= 128.
//
// Dropout: Philox4x32-10 keyed on the int32 seed with the counter (key
// column / 4, query row, head, batch) (common.cuh), the full-row kernels'
// stream: a flash call and a full-row call with the same seed drop the same
// probabilities, and every backward kernel regenerates the forward's mask.
//
// What bounds them on this card: operations.  At the Evoformer's triangle
// attention (B = 256 rows, H = 4, L = 256, D = 32, fp32) one (L x L) by D
// product is 4.3 GFLOP against 67 MB of traffic for the whole backward
// (0.02 ms); the forward makes two products (8.6 GFLOP), the backward seven
// (dq three, dk/dv four), 30 GFLOP, whose least time held to fp32 accuracy
// is at the 3xTF32 rate (495 / 3 = 165 TFLOP/s): 0.052 and 0.182 ms.
//
// The forward (attention_fwd.cuh, the full-row forward's body, shared): 4
// warps of 16 rows a block, grid Lq/64 x H x B; Q resident in shared
// memory, K, V and the tile's key mask through a two-stage cp.async ring;
// s = q k^T and p v on tensor cores (3xTF32 / bf16, mma.cuh), scores and p
// in registers, the online softmax's max and sum by quad shuffles; the
// tile's bias read from the L2-resident slab into registers before the
// barrier; dropout bits from one Philox call shared by two lanes.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (device ms, chip_smoke.py
// phase 3): fp32 triangle attention with its bias and a key mask 0.249,
// 21% of the 3xTF32 bound, against 0.519-0.573 for the fp32-FMA kernel it
// replaces and 0.603 for SDPA; MSA-row (32, 8, 256, 32) 0.066 (SDPA 0.168); BERT's
// (2, 12, 1152, 64) at dropout 0.1 0.293 (SDPA 0.502).  bf16 loses to
// SDPA's bf16 kernels (triangle 0.156 against 0.113).
//
// The backward (the full-row backward's shape, attention_fullrow.cu, with
// the grouped bias; products from mma.cuh): blocks of 4 warps, a warp owns
// 16 rows; fp32 inputs run 3xTF32 on m16n8k8 (hi/lo split, three products,
// never one plain TF32 product), bf16 one m16n8k16 bf16 product; streamed
// 64-row tiles go through a two-stage cp.async ring (rows padded by 16
// bytes: fragment reads on 32 banks); scores never leave registers, and the
// products that take ds or dropout(p) as their A operand take it from the
// accumulator.  Two launches, plus an ordered reduction where dbias has
// partial sums:
//   flash_dq_kernel (grid Lq/64 x H x B, query-major): di = rowsum(o * do)
//     for its 64 rows (written for the second launch), then over the K/V
//     tiles (and their key mask) s, dp, p = exp(s - lse), ds, and dq =
//     sm_scale ds k in registers, written once.  The tile's bias is read
//     into registers before the tile's barrier.
//   flash_dkv_kernel (grid Lk/64 x H x groups * chunks, key-major): a block
//     owns 64 keys of one head and a chunk of consecutive batches of one
//     bias group; for each batch it streams the q, do, lse and di tiles (32
//     rows), recomputes s^T, dp^T, p, the keep bits and ds, sums dv = dropout(p)^T
//     do and dk = sm_scale ds^T q in registers and writes them once at the
//     batch's end.  The next batch's K/V tile loads into a second stage
//     during the last q tile of a batch.  dbias needs no product of its
//     own: the fp32 ds the block already holds is added to the block's own
//     slab of a partial sum (chunk, group, head, Lq, its 64 keys), which
//     only this block touches and in which the same lane owns the same
//     elements from batch to batch: the first batch stores, later ones
//     add; no atomics and no barrier.  The chunk plan takes the chunk
//     length with the fewest waves x batches a block over the card's
//     resident blocks (occupancy x SMs), the longest of equals.  Without
//     dbias every block takes one batch.
//   flash_db_reduce_kernel adds the chunks (and the heads when Hb == 1) in
//     a fixed order into db.  With one chunk and Hb == H (a per-batch bias,
//     or a group whose batches fit one block's chunk) the dk/dv kernel
//     writes db itself and there is no third launch.
//   dq, dk, dv and dbias repeat bit for bit from call to call.
// Measured on an H100 (80 GB HBM3, 700 W), device time, fp32 triangle
// attention with its bias and a key mask (chip_smoke.py phase 3): dq 0.357
// ms and dk/dv/dbias 0.620 ms, 0.977 ms for the backward -- 19% of the
// 3xTF32 bound, against 2.69 ms for the fp32-FMA kernels this replaces
// (whose separate dbias pass recomputed s and dp for every batch) and 1.35
// ms for SDPA's backward.  Choices, each against a copy with it undone
// (unicore_tpu_torch/tools/flash_bwd_ab.py, same card, dk/dv/dbias ms):
// the slab in L2-resident device memory, not shared memory (which leaves
// one block an SM): 0.617 against 1.127; all slab loads before any store
// (the compiler cannot prove the element addresses distinct and otherwise
// waits on each load after the previous store): 0.616 against 1.047;
// 32-row q tiles, not 64: 0.537 against 0.767 at D = 64; the occupancy
// hints at D = 32: dq 0.354 against 0.375 (bf16 0.199 against 0.225).
// Offsets are 64-bit; dynamic shared memory up to 203 KB (dq and dk/dv,
// fp32, D = 128).
#include <climits>
#include <cstdint>

#include "attention_fwd.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace unicore;

constexpr int kThreads = 256;      // the dbias reduction
constexpr int kBwdWarps = 4;       // the backward: a warp owns 16 rows
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kTile = 64;          // query rows and key columns per tile

struct Geom {
  int B, H, Lq, Lk, D;
  int Bb, Hb;  // bias groups and heads (Bb = 0: no bias)
};

// the (Lq, Lk) bias slab batch b and head h read
template <typename TB>
__device__ __forceinline__ const TB* bias_slab(const TB* bias, const Geom& g, int b, int h) {
  if (bias == nullptr) return nullptr;
  const int group = b / (g.B / g.Bb);
  return bias + ((size_t)group * g.Hb + (g.Hb > 1 ? h : 0)) * g.Lq * g.Lk;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// the body is attention_fwd.cuh's, shared with the full-row forward: the key
// mask staged a tile at a time (Lk is unbounded), the grouped bias slab,
// lse always.  At DP = 32 (the Evoformer's head dim) four blocks an SM
// (<= 128 registers), as the dq launch: fp32 triangle 0.254 ms against
// 0.268 with no hint and 0.265 with three (tools/fwd_ab.py)
template <typename T, typename TB, int DP>
__global__ void __launch_bounds__(kFwdThreads, DP == 32 ? 4 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const TB* __restrict__ bias, const int* __restrict__ mask,
                 T* __restrict__ o, float* __restrict__ lse, Geom g, float sm_scale,
                 Dropout dr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int D = g.D, Lk = g.Lk;
  const size_t bh = (size_t)b * g.H + h;
  attention_fwd_block<T, TB, DP, true>(
      q + (bh * g.Lq + q0) * D, k + bh * Lk * D, v + bh * Lk * D,
      mask == nullptr ? nullptr : mask + (size_t)b * Lk, bias_slab(bias, g, b, h),
      o + (bh * g.Lq + q0) * D, lse + bh * g.Lq + q0, Lk, D, sm_scale, dr, b, h, q0, smem_raw);
}

// ---------------------------------------------------------------------------
// backward, launch 1: di and dq, query-major
// ---------------------------------------------------------------------------

template <typename T, int DP>
size_t dq_smem_bytes() {
  return sizeof(T) * (size_t)6 * kTile * tile_ld<T>(DP) + sizeof(int) * 2 * kTile;
}

// at DP = 32 (the Evoformer's head dim) four blocks an SM (<= 128
// registers) measured 5% faster; larger DP spill there
template <typename T, typename TB, int DP>
__global__ void __launch_bounds__(kBwdThreads, DP == 32 ? 4 : 1)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const TB* __restrict__ bias, const int* __restrict__ mask,
                const float* __restrict__ lse, const T* __restrict__ o,
                const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ di_out,
                Geom g, float sm_scale, Dropout dr) {
  using M = Mma<T>;
  constexpr int LD = tile_ld<T>(DP);
  constexpr int NT = kTile / 8;  // accumulator tiles across 64 keys
  constexpr int NO = DP / 8;     // accumulator tiles across the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // 64 x LD
  T* sDO = sQ + kTile * LD;                // 64 x LD
  T* sK = sDO + kTile * LD;                // 2 stages of 64 x LD
  T* sV = sK + 2 * kTile * LD;             // 2 stages of 64 x LD
  int* sM = reinterpret_cast<int*>(sV + 2 * kTile * LD);  // 2 stages of 64

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int D = g.D, Lk = g.Lk;
  const size_t bh = (size_t)b * g.H + h;
  const size_t qrow0 = bh * g.Lq + q0;
  const bool vec = (D * sizeof(T)) % 16 == 0;
  const T* kb = k + bh * Lk * D;
  const T* vb = v + bh * Lk * D;
  const int* mb = mask == nullptr ? nullptr : mask + (size_t)b * Lk;
  auto load_kv = [&](int j, int st) {
    load_rows_async(sK + st * kTile * LD, LD, kb + (size_t)j * kTile * D, kTile, D, DP, vec,
                    kBwdThreads);
    load_rows_async(sV + st * kTile * LD, LD, vb + (size_t)j * kTile * D, kTile, D, DP, vec,
                    kBwdThreads);
    if (mb != nullptr) load_mask_async(sM + st * kTile, mb + j * kTile);
  };
  load_rows_async(sQ, LD, q + qrow0 * D, kTile, D, DP, vec, kBwdThreads);
  load_rows_async(sDO, LD, dout + qrow0 * D, kTile, D, DP, vec, kBwdThreads);
  load_kv(0, 0);
  cp_async_commit();

  // this lane's rows of the tile: lrow, lrow + 8.  di = rowsum(o * do) in
  // fp32, the four lanes of a row splitting its columns; lse and di stay in
  // registers
  const int lrow = warp * 16 + gr;
  float di[2], lr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = qrow0 + lrow + 8 * r;
    float sum = 0.f;
    for (int d = t; d < D; d += 4) sum += to_f(o[row * D + d]) * to_f(dout[row * D + d]);
    di[r] = quad_sum(sum);
    lr[r] = lse[row];
    if (t == 0) di_out[row] = di[r];
  }
  const TB* slab = bias_slab(bias, g, b, h);
  const TB* brow = slab == nullptr ? nullptr : slab + (size_t)(q0 + lrow) * Lk;

  float dqa[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  const int ntiles = Lk / kTile;
  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    if (j + 1 < ntiles) load_kv(j + 1, st ^ 1);
    cp_async_commit();
    const int key0 = j * kTile;
    float bv[NT][4];  // this tile's bias, loaded before the wait and the products
    load_bias(bv, brow, Lk, key0, t);
    cp_async_wait<1>();  // tile j (and q, do) have landed
    __syncthreads();
    const T* cK = sK + st * kTile * LD;
    const T* cV = sV + st * kTile * LD;
    const int* cM = sM + st * kTile;

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

    // p, the dropped dp, ds (rounded to T: the A operand of ds k)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint2 keep = make_uint2(0xFu, 0xFu);
      if (dr.on) keep = keep_rows(dr, b, h, q0 + lrow, key0 + n * 8 + 4 * (t >> 1), t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = n * 8 + 2 * t + (e & 1), r = e >> 1;
        const bool masked = mb != nullptr && cM[kc] != 0;
        const float p = masked ? 0.f : __expf(s[n][e] * sm_scale + bv[n][e] - lr[r]);
        float dpk = dp[n][e];
        if (dr.on) {
          const uint32_t bits = r ? keep.y : keep.x;
          dpk = (bits >> (2 * (t & 1) + (e & 1))) & 1u ? dpk * dr.scale : 0.f;
        }
        s[n][e] = round_to<T>(p * (dpk - di[r]));  // 0 on masked keys: p is 0 there
      }
    }

    // dq += ds k
#pragma unroll
    for (int ks = 0; ks < kTile / M::kK; ++ks) {
      const typename M::A a = M::template a_from_acc<NT>(s, ks);
#pragma unroll
      for (int n = 0; n < NO; ++n) M::mma(dqa[n], a, M::load_b_kmajor(cK, LD, ks * M::kK, n * 8));
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  T* dqrow = dq + (qrow0 + lrow) * D;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = n * 8 + 2 * t + (e & 1);
      if (d < D) dqrow[(size_t)(e >> 1) * 8 * D + d] = from_f<T>(sm_scale * dqa[n][e]);
    }
}

// ---------------------------------------------------------------------------
// backward, launch 2: dk, dv and dbias, key-major
// ---------------------------------------------------------------------------

// query rows of a streamed q / do tile: 32 (measured faster than 64 at
// every head dim, D = 64 most: 0.78 -> 0.54 ms at (2, 12, 1152, 64); and
// four accumulator sets fit in registers at D = 128)
constexpr int kTileQ = 32;

template <typename T, int DP>
size_t dkv_smem_bytes() {
  return sizeof(T) * (size_t)(4 * kTile + 4 * kTileQ) * tile_ld<T>(DP) +
         sizeof(float) * 4 * kTileQ;
}

// Which batches a block takes: grid z = group * chunks + chunk, a chunk
// being `rchunk` consecutive batches of one bias group of R (one group of
// B without a bias).  `direct`: one chunk and Hb == H, so the block's slab
// of dbias is final and goes straight into db.
struct DkvPlan {
  int R, rchunk, chunks, direct;
};

// at DP = 32 three blocks an SM (<= 168 registers) measured 2% faster
template <typename T, typename TB, int DP>
__global__ void __launch_bounds__(kBwdThreads, DP == 32 ? 3 : 1)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const TB* __restrict__ bias, const int* __restrict__ mask,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
                 float* __restrict__ db, Geom g, DkvPlan pl, float sm_scale, Dropout dr) {
  using M = Mma<T>;
  constexpr int LD = tile_ld<T>(DP);
  constexpr int TQ = kTileQ;
  constexpr int NT = TQ / 8;  // accumulator tiles across a query tile
  constexpr int NO = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // 2 stages of 64 x LD: a batch's keys
  T* sV = sK + 2 * kTile * LD;             // 2 stages of 64 x LD
  T* sQ = sV + 2 * kTile * LD;             // 2 stages of TQ x LD
  T* sDO = sQ + 2 * TQ * LD;               // 2 stages of TQ x LD
  float* sLse = reinterpret_cast<float*>(sDO + 2 * TQ * LD);  // 2 stages of TQ
  float* sDi = sLse + 2 * TQ;                                  // 2 stages of TQ

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y;
  const int grp = blockIdx.z / pl.chunks, chunk = blockIdx.z - grp * pl.chunks;
  const int b0 = grp * pl.R + chunk * pl.rchunk;
  const int nb = min(pl.rchunk, pl.R - chunk * pl.rchunk);  // this block's batches
  const int D = g.D, Lq = g.Lq, Lk = g.Lk;
  const bool vec = (D * sizeof(T)) % 16 == 0;
  const int nq = Lq / TQ;
  const int key = k0 + warp * 16 + gr;  // this lane's keys: key, key + 8

  // the bias and this block's dbias slab at the lane's keys (rows Lk apart)
  const TB* bcol = bias == nullptr ? nullptr : bias_slab(bias, g, b0, h) + key;
  float* dbcol = nullptr;
  if (db != nullptr)
    dbcol = db + (pl.direct ? (size_t)grp * g.Hb + h
                            : ((size_t)chunk * g.Bb + grp) * g.H + h) * Lq * Lk + key;

  auto load_kv = [&](int b, int st) {
    const size_t off = (((size_t)b * g.H + h) * Lk + k0) * D;
    load_rows_async(sK + st * kTile * LD, LD, k + off, kTile, D, DP, vec, kBwdThreads);
    load_rows_async(sV + st * kTile * LD, LD, v + off, kTile, D, DP, vec, kBwdThreads);
  };
  auto load_q = [&](int b, int i, int st) {
    const size_t row = ((size_t)b * g.H + h) * Lq + (size_t)i * TQ;
    load_rows_async(sQ + st * TQ * LD, LD, q + row * D, TQ, D, DP, vec, kBwdThreads);
    load_rows_async(sDO + st * TQ * LD, LD, dout + row * D, TQ, D, DP, vec, kBwdThreads);
    for (int c = threadIdx.x; c < TQ / 2; c += kBwdThreads) {  // TQ/4 chunks of each
      const int which = c / (TQ / 4), off = 4 * (c % (TQ / 4));
      cp_async16((which ? sDi : sLse) + st * TQ + off, (which ? di : lse) + row + off, 16);
    }
  };
  load_kv(b0, 0);
  load_q(b0, 0, 0);
  cp_async_commit();

  float dka[NO][4], dva[NO][4];
  bool masked[2] = {false, false};
  // one flat loop over (batch, q tile): the ring runs across batch ends
  const int iters = nb * nq;
  for (int it = 0; it < iters; ++it) {
    const int r = it / nq, i = it - r * nq;
    const int b = b0 + r, st = it & 1;
    if (it + 1 < iters) {
      const int r1 = (it + 1) / nq, i1 = it + 1 - r1 * nq;
      if (i1 == 0) load_kv(b0 + r1, r1 & 1);  // the stage batch r - 1 used
      load_q(b0 + r1, i1, st ^ 1);
    }
    cp_async_commit();
    if (i == 0) {
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
      if (mask != nullptr) {
        masked[0] = mask[(size_t)b * Lk + key] != 0;
        masked[1] = mask[(size_t)b * Lk + key + 8] != 0;
      }
    }
    const int qt0 = i * TQ;
    float bv[NT][4];  // bias at (query qt0 + 8n + 2t + (e & 1), key + 8 (e >> 1))
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        bv[n][e] = bcol == nullptr
                       ? 0.f
                       : to_f(bcol[(size_t)(qt0 + n * 8 + 2 * t + (e & 1)) * Lk +
                                   8 * (e >> 1)]);
    cp_async_wait<1>();
    __syncthreads();
    const T* cK = sK + (r & 1) * kTile * LD;
    const T* cV = sV + (r & 1) * kTile * LD;
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
      const typename M::A ak = M::load_a(cK, LD, warp * 16, kk);
      const typename M::A av = M::load_a(cV, LD, warp * 16, kk);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        M::mma(s[n], ak, M::load_b_nmajor(cQ, LD, n * 8, kk));
        M::mma(dp[n], av, M::load_b_nmajor(cDO, LD, n * 8, kk));
      }
    }

    // the slab's sums so far at this lane's elements: every load issued
    // before any store (one round trip to L2, not one an element)
    auto slab_at = [&](int n, int e) {
      return dbcol + (size_t)(qt0 + n * 8 + 2 * t + (e & 1)) * Lk + 8 * (e >> 1);
    };
    float dbs[NT][4];
    if (dbcol != nullptr && r > 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dbs[n][e] = *slab_at(n, e);
    }

#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t calls[4] = {0xFu, 0xFu, 0xFu, 0xFu};  // element e: bit g % 4 of calls[e]
      if (dr.on) keep_cols(dr, b, h, qt0 + n * 8, k0 + warp * 16, gr, t, calls);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * t + (e & 1), rr = e >> 1;
        const float p =
            masked[rr] ? 0.f : __expf(s[n][e] * sm_scale + bv[n][e] - cL[ql]);
        float pd = p, dpk = dp[n][e];
        if (dr.on) {
          const bool kept = (calls[e] >> (gr & 3)) & 1u;
          pd = kept ? p * dr.scale : 0.f;
          dpk = kept ? dpk * dr.scale : 0.f;
        }
        const float ds = p * (dpk - cD[ql]);  // 0 on masked keys: p is 0 there
        if (dbcol != nullptr) dbs[n][e] = r == 0 ? ds : dbs[n][e] + ds;  // in batch order
        dp[n][e] = round_to<T>(ds);  // ds^T
        s[n][e] = round_to<T>(pd);   // dropout(p)^T
      }
    }
    if (dbcol != nullptr) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) *slab_at(n, e) = dbs[n][e];
    }

    // dv += dropout(p)^T do, dk += ds^T q
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

    if (i == nq - 1) {  // the batch's dk and dv, written once
      const size_t row = ((size_t)b * g.H + h) * Lk + key;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = n * 8 + 2 * t + (e & 1);
          const size_t at = (row + (size_t)(e >> 1) * 8) * D + d;
          if (d < D) {
            dk[at] = from_f<T>(sm_scale * dka[n][e]);
            dv[at] = from_f<T>(dva[n][e]);
          }
        }
    }
    __syncthreads();  // every warp is done with stage st (and K/V) before refills
  }
}

// db (Bb, Hb, Lq, Lk) = the partial slabs (chunks, Bb, H, Lq, Lk) summed over
// the chunks (and the heads when Hb == 1), always in the same order; four
// floats a thread (Lk is a multiple of 64)
__global__ void __launch_bounds__(kThreads)
flash_db_reduce_kernel(const float4* __restrict__ partial, float4* __restrict__ db, Geom g,
                       int chunks) {
  const size_t LL = (size_t)g.Lq * g.Lk / 4;
  const size_t n = (size_t)g.Bb * g.Hb * LL;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (size_t)gridDim.x * kThreads) {
    const size_t idx = e % LL;
    const int gh = (int)(e / LL), hb = gh % g.Hb, grp = gh / g.Hb;
    const int h_lo = g.Hb > 1 ? hb : 0, h_hi = g.Hb > 1 ? hb + 1 : g.H;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int h = h_lo; h < h_hi; ++h)
      for (int c = 0; c < chunks; ++c) {
        const float4 x = partial[(((size_t)c * g.Bb + grp) * g.H + h) * LL + idx];
        sum.x += x.x;
        sum.y += x.y;
        sum.z += x.z;
        sum.w += x.w;
      }
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
  const void *q, *k, *v, *bias, *mask, *lse, *di, *o, *dout;
  void* out[4];  // fwd: o, lse; dq: dq, di; dkv: dk, dv, partial, db
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
  template <typename T, typename TB, int DP>
  cudaError_t run(const Args& a) const {
    const size_t smem = attention_fwd_smem<T, DP, true>(a.g.Lk);
    auto kernel = flash_fwd_kernel<T, TB, DP>;
    cudaError_t err = with_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(a.g.Lq / kTile, a.g.H, a.g.B), kFwdThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const TB*>(a.bias), static_cast<const int*>(a.mask),
        static_cast<T*>(a.out[0]), static_cast<float*>(a.out[1]), a.g, a.sm_scale, a.dr);
    return cudaGetLastError();
  }
};

struct DqLaunch {
  template <typename T, typename TB, int DP>
  cudaError_t run(const Args& a) const {
    const size_t smem = dq_smem_bytes<T, DP>();
    auto kernel = flash_dq_kernel<T, TB, DP>;
    cudaError_t err = with_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(a.g.Lq / kTile, a.g.H, a.g.B), kBwdThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const TB*>(a.bias), static_cast<const int*>(a.mask),
        static_cast<const float*>(a.lse), static_cast<const T*>(a.o),
        static_cast<const T*>(a.dout), static_cast<T*>(a.out[0]),
        static_cast<float*>(a.out[1]), a.g, a.sm_scale, a.dr);
    return cudaGetLastError();
  }
};

// The dk/dv kernel's batch plan for this card: without dbias one batch a
// block; with it, the chunk length rchunk with the fewest waves x batches a
// block, counting the blocks the card holds at once (occupancy x SMs), the
// longest of equals (fewer partial slabs to add)
template <typename T, typename TB, int DP>
cudaError_t dkv_plan(const Geom& g, bool want_db, DkvPlan& pl) {
  const int groups = g.Bb > 0 ? g.Bb : 1;
  const int R = g.B / groups;
  pl = DkvPlan{R, 1, R, 0};
  if (!want_db) return cudaSuccess;
  auto kernel = flash_dkv_kernel<T, TB, DP>;
  const size_t smem = dkv_smem_bytes<T, DP>();
  cudaError_t err = with_smem(kernel, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBwdThreads, smem);
  if (err != cudaSuccess) return err;
  const long long slots = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const long long per_chunk = (long long)groups * g.H * (g.Lk / kTile);
  long long best = LLONG_MAX;
  for (int rc = 1; rc <= R; ++rc) {
    const long long chunks = (R + rc - 1) / rc;
    const long long cost = (per_chunk * chunks + slots - 1) / slots * rc;
    if (cost <= best) {
      best = cost;
      pl.rchunk = rc;
      pl.chunks = (int)chunks;
    }
  }
  pl.direct = pl.chunks == 1 && g.Hb == g.H;
  return cudaSuccess;
}

// floats of the partial-sum scratch a plan needs (0 when dbias goes
// straight into db)
long long dkv_scratch(const Geom& g, const DkvPlan& pl) {
  return pl.direct ? 0 : (long long)pl.chunks * g.Bb * g.H * g.Lq * g.Lk;
}

struct DkvScratch {
  long long* floats;
  template <typename T, typename TB, int DP>
  cudaError_t run(const Args& a) const {
    DkvPlan pl;
    const cudaError_t err = dkv_plan<T, TB, DP>(a.g, true, pl);
    if (err == cudaSuccess) *floats = dkv_scratch(a.g, pl);
    return err;
  }
};

struct DkvLaunch {
  template <typename T, typename TB, int DP>
  cudaError_t run(const Args& a) const {
    float* partial = static_cast<float*>(a.out[2]);
    float* db = static_cast<float*>(a.out[3]);
    DkvPlan pl;
    cudaError_t err = dkv_plan<T, TB, DP>(a.g, db != nullptr, pl);
    if (err != cudaSuccess) return err;
    if (db != nullptr && !pl.direct && partial == nullptr) return cudaErrorInvalidValue;
    const size_t smem = dkv_smem_bytes<T, DP>();
    auto kernel = flash_dkv_kernel<T, TB, DP>;
    err = with_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const int groups = a.g.Bb > 0 ? a.g.Bb : 1;
    kernel<<<dim3(a.g.Lk / kTile, a.g.H, groups * pl.chunks), kBwdThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const TB*>(a.bias), static_cast<const int*>(a.mask),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
        static_cast<const T*>(a.dout), static_cast<T*>(a.out[0]), static_cast<T*>(a.out[1]),
        db == nullptr ? nullptr : (pl.direct ? db : partial), a.g, pl, a.sm_scale, a.dr);
    err = cudaGetLastError();
    if (err != cudaSuccess || db == nullptr || pl.direct) return err;
    const size_t n = (size_t)a.g.Bb * a.g.Hb * a.g.Lq * a.g.Lk / 4;
    const size_t blocks = (n + kThreads - 1) / kThreads;
    flash_db_reduce_kernel<<<(int)(blocks < 4096 ? blocks : 4096), kThreads, 0, a.stream>>>(
        static_cast<const float4*>(static_cast<const void*>(partial)),
        static_cast<float4*>(static_cast<void*>(db)), a.g, pl.chunks);
    return cudaGetLastError();
  }
};

// f.run<T, TB, DP>(a) with the head dim zero-padded to a multiple of the bf16
// mma's k (16): 16, 32, 64, 128
template <typename T, typename TB, typename F>
cudaError_t dispatch_dp(const F& f, const Args& a) {
  if (a.g.D <= 16) return f.template run<T, TB, 16>(a);
  if (a.g.D <= 32) return f.template run<T, TB, 32>(a);
  if (a.g.D <= 64) return f.template run<T, TB, 64>(a);
  return f.template run<T, TB, 128>(a);
}

// the inputs' type code, then the bias's
template <typename F>
cudaError_t dispatch(int dtype, int bias_dtype, const F& f, const Args& a) {
  return dispatch_attention(dtype, bias_dtype, [&](auto qt, auto bt) {
    return dispatch_dp<typename decltype(qt)::type, typename decltype(bt)::type>(f, a);
  });
}

Args make_args(const void* q, const void* k, const void* v, const void* bias, const void* mask,
               const void* lse, const void* di, const void* o, const void* dout, void* out0,
               void* out1, void* out2, void* out3, int B, int H, int Lq, int Lk, int D, int Bb,
               int Hb, float sm_scale, int dropout, int seed, unsigned threshold,
               float keep_scale, void* stream) {
  const Geom g{B, H, Lq, Lk, D, bias == nullptr ? 0 : Bb, bias == nullptr ? 1 : Hb};
  return Args{q, k, v, bias, mask, lse, di, o, dout, {out0, out1, out2, out3}, g, sm_scale,
              make_dropout(dropout, seed, threshold, keep_scale),
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// o: (B, H, Lq, D) in the inputs' type; lse: (B, H, Lq) fp32
extern "C" int unicore_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, const void* mask, void* o,
    void* lse, int B, int H, int Lq, int Lk, int D, int Bb, int Hb, float sm_scale, int dropout,
    int seed, unsigned threshold, float keep_scale, int dtype, int bias_dtype, void* stream) {
  const Args a = make_args(q, k, v, bias, mask, nullptr, nullptr, nullptr, nullptr, o, lse,
                           nullptr, nullptr, B, H, Lq, Lk, D, Bb, Hb, sm_scale, dropout, seed,
                           threshold, keep_scale, stream);
  if (bad_geometry(a.g)) return (int)cudaErrorInvalidValue;
  return (int)dispatch(dtype, bias_dtype, FwdLaunch{}, a);
}

// o, lse: the forward's output and row statistics; dq: (B, H, Lq, D) in the
// inputs' type; di: (B, H, Lq) fp32, written (rowsum(o * do)) for the dk/dv
// launch
extern "C" int unicore_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* bias, const void* mask,
    const void* lse, const void* o, const void* dout, void* dq, void* di, int B, int H, int Lq,
    int Lk, int D, int Bb, int Hb, float sm_scale, int dropout, int seed, unsigned threshold,
    float keep_scale, int dtype, int bias_dtype, void* stream) {
  const Args a = make_args(q, k, v, bias, mask, lse, nullptr, o, dout, dq, di, nullptr, nullptr,
                           B, H, Lq, Lk, D, Bb, Hb, sm_scale, dropout, seed, threshold,
                           keep_scale, stream);
  if (bad_geometry(a.g)) return (int)cudaErrorInvalidValue;
  return (int)dispatch(dtype, bias_dtype, DqLaunch{}, a);
}

// floats of fp32 scratch unicore_flash_attention_dkv needs for dbias with
// this geometry and these types (0: it writes db directly); -1 for a
// geometry or type it refuses
extern "C" long long unicore_flash_attention_dkv_scratch(int B, int H, int Lq, int Lk, int D,
                                                         int Bb, int Hb, int dtype,
                                                         int bias_dtype) {
  Args a{};
  a.g = Geom{B, H, Lq, Lk, D, Bb, Hb};
  long long floats = -1;
  if (Bb <= 0 || bad_geometry(a.g) ||
      dispatch(dtype, bias_dtype, DkvScratch{&floats}, a) != cudaSuccess)
    return -1;
  return floats;
}

// dk, dv: (B, H, Lk, D) in the inputs' type.  db: (Bb, Hb, Lq, Lk) fp32,
// every element written, or null (no dbias); partial: the fp32 scratch of
// unicore_flash_attention_dkv_scratch floats (null when that is 0)
extern "C" int unicore_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* bias, const void* mask,
    const void* lse, const void* di, const void* dout, void* dk, void* dv, void* partial,
    void* db, int B, int H, int Lq, int Lk, int D, int Bb, int Hb, float sm_scale, int dropout,
    int seed, unsigned threshold, float keep_scale, int dtype, int bias_dtype, void* stream) {
  const Args a = make_args(q, k, v, bias, mask, lse, di, nullptr, dout, dk, dv, partial, db, B,
                           H, Lq, Lk, D, Bb, Hb, sm_scale, dropout, seed, threshold, keep_scale,
                           stream);
  if (bad_geometry(a.g) || (db != nullptr && bias == nullptr)) return (int)cudaErrorInvalidValue;
  return (int)dispatch(dtype, bias_dtype, DkvLaunch{}, a);
}
