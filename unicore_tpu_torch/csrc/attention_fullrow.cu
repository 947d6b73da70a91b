// Full-row attention, forward and fused backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of unicore_tpu/ops/attention_fullrow.py:
//   `_fwd_kernel` (:110, launched by `_fwd` :160) and
//   `_bwd_kernel` (:205, launched by `_bwd` :289), the two halves of the
//   `jax.custom_vjp` `_fullrow` (:370).
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
// gate routes.
//
// Dropout: the TPU stream (pltpu.prng_random_bits) cannot be reproduced off
// the TPU, so the keep bits come from Philox4x32-10 (common.cuh) keyed on
// the int32 seed, with the counter (key column / 4, query row, head, batch):
// one Philox call gives the bits of four neighbouring key columns, and the
// backward regenerates exactly the forward's mask without storing it.  The
// keep rule is the TPU's: keep when bits >= min(int(rate * 2^32), 2^32 - 1)
// as uint32, scale by 1 / (1 - rate).  The plain version in
// ops/attention_fullrow.py computes the same bits in torch integer ops, so
// the two agree bit for bit on the mask.
//
// What bounds them on this card: operations.  Without tensor cores the
// forward's 4*B*H*L^2*D flops at the main shape (B=8, H=12, L=512, D=64:
// 6.44 GFLOP) take at least 96 us at the 67 TFLOP/s fp32 rate, the
// backward's 10*B*H*L^2*D (16.1 GFLOP: five products of that size) 240 us,
// while their fp32 traffic needs 19 and 34 us.
//
// What the design does about it: the TPU kernels keep whole (Lq, Lk) fp32
// blocks in 12 MB of VMEM; a Hopper block has at most 227 KB of shared
// memory.  Each block therefore takes one (b, h) and a tile of TQ query rows
// and keeps those rows' FULL score rows in dynamic shared memory, which
// keeps the one-shot softmax with no online rescaling.  K and V stream
// through a 64-row shared tile; the products are fp32 FMA from shared memory
// with 16-byte loads and register micro-tiles.  The forward takes TQ = 32
// (<= 182 KB at L = 1024, D = 128).  The backward holds two row sets, p and
// dp (64 KB each at TQ = 32, L = 512), so it takes TQ = 32 up to 512 keys
// and TQ = 16 above (186 KB at L = 1024, D = 128); the keep bits of a row
// live in one register per lane between its two passes.  dq is written
// directly.  dk, dv and dbias sum over query tiles (dbias over the batch
// too) and are accumulated in fp32 with atomicAdd into zeroed buffers: one
// add per element per query tile, no partial buffers.  The order of those
// adds changes from run to run, so their last bits do, and the tolerances
// allow it.  wgmma, TMA and a key-major dk/dv pass are left to a later PR.
#include <cstdint>

#include "common.cuh"

namespace {

using namespace unicore;

constexpr int kThreads = 256;
constexpr int kTileK = 64;        // key / value rows per shared tile
constexpr int kFwdTileQ = 32;     // query rows per forward block
constexpr float kNegInf = -1e30f; // NEG_INF of ops/flash_attention.py

struct Dropout {
  int on;
  uint32_t seed;
  uint32_t threshold;  // keep when bits >= threshold
  float scale;         // 1 / (1 - rate)
};

// keep bits (bit w for key column c0 + w) of four neighbouring columns
__device__ __forceinline__ uint32_t keep4(const Dropout& dr, int b, int h, int row, int c0) {
  const uint4 r = philox4x32_10(
      make_uint4((uint32_t)(c0 >> 2), (uint32_t)row, (uint32_t)h, (uint32_t)b), dr.seed, 0u);
  return (uint32_t)(r.x >= dr.threshold) | ((uint32_t)(r.y >= dr.threshold) << 1) |
         ((uint32_t)(r.z >= dr.threshold) << 2) | ((uint32_t)(r.w >= dr.threshold) << 3);
}

__host__ __device__ __forceinline__ int pad4(int D) { return (D + 3) & ~3; }

// Copy `rows` rows of a row-major (rows, D) tile into shared memory with row
// stride `ld`, converting to fp32 and zero-filling columns [D, Dp).
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          int rows, int D, int Dp) {
  for (int e = threadIdx.x; e < rows * Dp; e += kThreads) {
    const int r = e / Dp, c = e - r * Dp;
    dst[r * ld + c] = c < D ? to_f(src[(size_t)r * D + c]) : 0.f;
  }
}

// acc = <row i of sA, row key of src> for the TQ rows of sA and all Lk rows
// of src, which stream through the shared tile sKV; `epi(i, key, acc)`
// stores each.  Thread (rg, j) owns rows rg, rg+4, ... of column j of each
// 64-key tile.
template <int TQ, typename T, typename Epi>
__device__ __forceinline__ void rows_times_keys(const float* sA, float* sKV, int ld,
                                                const T* __restrict__ src, int Lk, int D,
                                                int Dp, Epi epi) {
  const int j = threadIdx.x % kTileK, rg = threadIdx.x / kTileK;
  for (int k0 = 0; k0 < Lk; k0 += kTileK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(sKV, ld, src + (size_t)k0 * D, kTileK, D, Dp);
    __syncthreads();
    float acc[TQ / 4];
#pragma unroll
    for (int r = 0; r < TQ / 4; ++r) acc[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(sKV + j * ld);
    for (int d4 = 0; d4 < Dp / 4; ++d4) {
      const float4 kv = krow[d4];
#pragma unroll
      for (int r = 0; r < TQ / 4; ++r) {
        const float4 a = reinterpret_cast<const float4*>(sA + (rg + 4 * r) * ld)[d4];
        acc[r] += a.x * kv.x + a.y * kv.y + a.z * kv.z + a.w * kv.w;
      }
    }
#pragma unroll
    for (int r = 0; r < TQ / 4; ++r) epi(rg + 4 * r, k0 + j, acc[r]);
  }
}

// acc[r] = columns 4*cg .. 4*cg+3 of row rg + r*nrg of (sP src), sP the
// (TQ, Lk) rows in shared memory, src (Lk, D) streaming through sKV.
template <int TQ, typename T>
__device__ __forceinline__ void probs_times_rows(const float* sP, int lds, float* sKV, int ld,
                                                 const T* __restrict__ src, int Lk, int D,
                                                 int Dp, float4 (&acc)[4]) {
  const int ncg = Dp / 4;
  const int nrg = kThreads / ncg;  // >= 8 since Dp <= 128
  const int cg = threadIdx.x % ncg, rg = threadIdx.x / ncg;
  const bool active = rg < nrg;
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < Lk; k0 += kTileK) {
    __syncthreads();  // sP complete / the previous tile's readers are done
    load_tile(sKV, ld, src + (size_t)k0 * D, kTileK, D, Dp);
    __syncthreads();
    if (!active) continue;
    for (int jj = 0; jj < kTileK; jj += 4) {
      const float4 v0 = *reinterpret_cast<const float4*>(sKV + (jj + 0) * ld + 4 * cg);
      const float4 v1 = *reinterpret_cast<const float4*>(sKV + (jj + 1) * ld + 4 * cg);
      const float4 v2 = *reinterpret_cast<const float4*>(sKV + (jj + 2) * ld + 4 * cg);
      const float4 v3 = *reinterpret_cast<const float4*>(sKV + (jj + 3) * ld + 4 * cg);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = rg + r * nrg;
        if (i < TQ) {
          const float4 p = *reinterpret_cast<const float4*>(sP + i * lds + k0 + jj);
          acc[r].x += p.x * v0.x + p.y * v1.x + p.z * v2.x + p.w * v3.x;
          acc[r].y += p.x * v0.y + p.y * v1.y + p.z * v2.y + p.w * v3.y;
          acc[r].z += p.x * v0.z + p.y * v1.z + p.z * v2.z + p.w * v3.z;
          acc[r].w += p.x * v0.w + p.y * v1.w + p.z * v2.w + p.w * v3.w;
        }
      }
    }
  }
}

// dst[i][d] = scale * acc, in probs_times_rows' thread layout
template <int TQ, typename T>
__device__ __forceinline__ void store_rows(const float4 (&acc)[4], T* dst, int D, int Dp,
                                           float scale) {
  const int ncg = Dp / 4, nrg = kThreads / ncg;
  const int cg = threadIdx.x % ncg, rg = threadIdx.x / ncg;
  if (rg >= nrg) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = rg + r * nrg;
    if (i >= TQ) continue;
    T* row = dst + (size_t)i * D;
    const float vals[4] = {acc[r].x, acc[r].y, acc[r].z, acc[r].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 4 * cg + c;
      if (d < D) row[d] = from_f<T>(scale * vals[c]);
    }
  }
}

// Unnormalised softmax numerators of one score row in place (one warp):
// returns 1 / rowsum, or 0 for a fully-masked row.
__device__ __forceinline__ float softmax_numerators(float* row, const int* sM, int Lk, int lane) {
  float m = -__int_as_float(0x7f800000);  // -inf
  for (int c = lane; c < Lk; c += 32) m = fmaxf(m, row[c]);
  m = warp_max(m);
  float l = 0.f;
  for (int c = lane; c < Lk; c += 32) {
    const float p = sM[c] != 0 ? 0.f : expf(row[c] - m);
    row[c] = p;
    l += p;
  }
  l = warp_sum(l);
  return l > 0.f ? 1.f / l : 0.f;
}

size_t fwd_smem_bytes(int Lk, int D) {
  const int ld = pad4(D) + 4, lds = Lk + 4;
  return sizeof(float) *
         ((size_t)(kFwdTileQ + kTileK) * ld + (size_t)kFwdTileQ * lds + Lk);
}

template <typename T, int TQ>
__global__ void __launch_bounds__(kThreads)
fullrow_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   const int* __restrict__ mask, T* __restrict__ o,
                   int H, int Lq, int Lk, int D, int bias_heads, float sm_scale,
                   Dropout dr) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = pad4(D);
  const int ld = Dp + 4;   // row stride of the Q and K/V tiles (16-byte rows)
  const int lds = Lk + 4;  // row stride of the score rows
  float* sQ = smem;                // TQ x ld
  float* sKV = sQ + TQ * ld;       // kTileK x ld
  float* sS = sKV + kTileK * ld;   // TQ x lds
  int* sM = reinterpret_cast<int*>(sS + TQ * lds);  // Lk

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const float* biasb =
      bias == nullptr ? nullptr
                      : bias + ((size_t)(bias_heads > 1 ? h : 0) * Lq + q0) * Lk;

  load_tile(sQ, ld, q + (bh * Lq + q0) * D, TQ, D, Dp);
  for (int c = tid; c < Lk; c += kThreads) sM[c] = mask == nullptr ? 0 : mask[(size_t)b * Lk + c];

  rows_times_keys<TQ>(sQ, sKV, ld, k + bh * Lk * D, Lk, D, Dp,
                      [&](int i, int key, float acc) {
                        float s = acc * sm_scale;
                        if (biasb != nullptr) s += biasb[(size_t)i * Lk + key];
                        sS[i * lds + key] = sM[key] != 0 ? kNegInf : s;
                      });
  __syncthreads();

  // one-shot softmax over each full row, then dropout: one warp per row
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = warp; i < TQ; i += kThreads / 32) {
    float* row = sS + i * lds;
    const float inv = softmax_numerators(row, sM, Lk, lane);
    for (int c0 = 4 * lane; c0 < Lk; c0 += 128) {
      const uint32_t keep = dr.on ? keep4(dr, b, h, q0 + i, c0) : 0xFu;
      float4 p = *reinterpret_cast<float4*>(row + c0);
      float pw[4] = {p.x * inv, p.y * inv, p.z * inv, p.w * inv};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if (dr.on) pw[w] = (keep >> w) & 1u ? pw[w] * dr.scale : 0.f;
        pw[w] = round_to<T>(pw[w]);  // cast to v's type before p v
      }
      *reinterpret_cast<float4*>(row + c0) = make_float4(pw[0], pw[1], pw[2], pw[3]);
    }
  }

  float4 acc[4];
  probs_times_rows<TQ>(sS, lds, sKV, ld, v + bh * Lk * D, Lk, D, Dp, acc);
  store_rows<TQ>(acc, o + (bh * Lq + q0) * D, D, Dp, 1.f);
}

int bwd_tile_q(int Lk) { return Lk <= 512 ? 32 : 16; }

size_t bwd_smem_bytes(int TQ, int Lk, int D) {
  const int ld = pad4(D) + 4, lds = Lk + 4;
  return sizeof(float) *
         ((size_t)(2 * TQ + kTileK) * ld + (size_t)2 * TQ * lds + Lk);
}

template <typename T, int TQ>
__global__ void __launch_bounds__(kThreads)
fullrow_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   const int* __restrict__ mask, const T* __restrict__ dout,
                   T* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                   float* __restrict__ db, int H, int Lq, int Lk, int D, int bias_heads,
                   float sm_scale, Dropout dr) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = pad4(D);
  const int ld = Dp + 4, lds = Lk + 4;
  float* sQ = smem;                // TQ x ld: q rows
  float* sDO = sQ + TQ * ld;       // TQ x ld: do rows
  float* sKV = sDO + TQ * ld;      // kTileK x ld: streamed K / V tiles
  float* sS = sKV + kTileK * ld;   // TQ x lds: s, then p, then pd (in T)
  float* sDP = sS + TQ * lds;      // TQ x lds: dp, then dp_keep, then ds (in T)
  int* sM = reinterpret_cast<int*>(sDP + TQ * lds);  // Lk

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const size_t brow = ((size_t)(bias_heads > 1 ? h : 0) * Lq + q0) * Lk;
  const float* biasb = bias == nullptr ? nullptr : bias + brow;
  float* dbb = db == nullptr ? nullptr : db + brow;
  const T* kb = k + bh * Lk * D;

  load_tile(sQ, ld, q + (bh * Lq + q0) * D, TQ, D, Dp);
  load_tile(sDO, ld, dout + (bh * Lq + q0) * D, TQ, D, Dp);
  for (int c = tid; c < Lk; c += kThreads) sM[c] = mask == nullptr ? 0 : mask[(size_t)b * Lk + c];

  rows_times_keys<TQ>(sQ, sKV, ld, kb, Lk, D, Dp, [&](int i, int key, float acc) {
    float s = acc * sm_scale;
    if (biasb != nullptr) s += biasb[(size_t)i * Lk + key];
    sS[i * lds + key] = sM[key] != 0 ? kNegInf : s;
  });
  rows_times_keys<TQ>(sDO, sKV, ld, v + bh * Lk * D, Lk, D, Dp,
                      [&](int i, int key, float acc) { sDP[i * lds + key] = acc; });
  __syncthreads();

  // per row (one warp): p, the regenerated keep mask, di, ds and dbias
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = warp; i < TQ; i += kThreads / 32) {
    float* srow = sS + i * lds;
    float* dprow = sDP + i * lds;
    const float inv = softmax_numerators(srow, sM, Lk, lane);
    uint32_t bits = 0;  // keep bits of this lane's columns (<= 32 at Lk <= 1024)
    float di = 0.f;
    for (int c0 = 4 * lane, t = 0; c0 < Lk; c0 += 128, t += 4) {
      const uint32_t keep = dr.on ? keep4(dr, b, h, q0 + i, c0) : 0xFu;
      bits |= keep << t;
      const float4 p4 = *reinterpret_cast<float4*>(srow + c0);
      const float4 g4 = *reinterpret_cast<float4*>(dprow + c0);
      const float pw[4] = {p4.x * inv, p4.y * inv, p4.z * inv, p4.w * inv};
      float gw[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if (dr.on) gw[w] = (keep >> w) & 1u ? gw[w] * dr.scale : 0.f;
        di += pw[w] * gw[w];  // rowsum(pd * dp) == rowsum(p * dp_keep)
      }
      *reinterpret_cast<float4*>(srow + c0) = make_float4(pw[0], pw[1], pw[2], pw[3]);
      *reinterpret_cast<float4*>(dprow + c0) = make_float4(gw[0], gw[1], gw[2], gw[3]);
    }
    di = warp_sum(di);
    for (int c0 = 4 * lane, t = 0; c0 < Lk; c0 += 128, t += 4) {
      const float4 p4 = *reinterpret_cast<float4*>(srow + c0);
      const float4 g4 = *reinterpret_cast<float4*>(dprow + c0);
      const float pw[4] = {p4.x, p4.y, p4.z, p4.w};
      const float gw[4] = {g4.x, g4.y, g4.z, g4.w};
      float pd[4], ds[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        ds[w] = sM[c0 + w] != 0 ? 0.f : pw[w] * (gw[w] - di);
        pd[w] = pw[w];
        if (dr.on) pd[w] = (bits >> (t + w)) & 1u ? pw[w] * dr.scale : 0.f;
        if (dbb != nullptr) atomicAdd(dbb + (size_t)i * Lk + c0 + w, ds[w]);
        pd[w] = round_to<T>(pd[w]);
        ds[w] = round_to<T>(ds[w]);
      }
      *reinterpret_cast<float4*>(srow + c0) = make_float4(pd[0], pd[1], pd[2], pd[3]);
      *reinterpret_cast<float4*>(dprow + c0) = make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
  }

  // dq = sm_scale * ds k (the row sets are complete after the first sync
  // inside probs_times_rows)
  float4 acc[4];
  probs_times_rows<TQ>(sDP, lds, sKV, ld, kb, Lk, D, Dp, acc);
  store_rows<TQ>(acc, dq + (bh * Lq + q0) * D, D, Dp, sm_scale);

  // dk += sm_scale * ds^T q and dv += pd^T do over this tile's rows: thread
  // (kg, cg) owns 4 keys x 4 columns per pass; shared memory is read-only
  // from here on
  const int ncg = Dp / 4, nkg = kThreads / ncg;
  const int cg = tid % ncg, kg = tid / ncg;
  if (kg >= nkg) return;
  float* dkb = dk + bh * Lk * D;
  float* dvb = dv + bh * Lk * D;
  for (int j = 4 * kg; j < Lk; j += 4 * nkg) {
    float ak[4][4], av[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) ak[a][c] = av[a][c] = 0.f;
    for (int i = 0; i < TQ; ++i) {
      const float4 s4 = *reinterpret_cast<const float4*>(sDP + i * lds + j);
      const float4 p4 = *reinterpret_cast<const float4*>(sS + i * lds + j);
      const float4 q4 = *reinterpret_cast<const float4*>(sQ + i * ld + 4 * cg);
      const float4 o4 = *reinterpret_cast<const float4*>(sDO + i * ld + 4 * cg);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w}, pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float qv[4] = {q4.x, q4.y, q4.z, q4.w}, ov[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ak[a][c] += sv[a] * qv[c];
          av[a][c] += pv[a] * ov[c];
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = 4 * cg + c;
        if (d < D) {
          atomicAdd(dkb + (size_t)(j + a) * D + d, sm_scale * ak[a][c]);
          atomicAdd(dvb + (size_t)(j + a) * D + d, av[a][c]);
        }
      }
  }
}

bool bad_geometry(int B, int H, int Lq, int Lk, int D, int tq) {
  return B <= 0 || H <= 0 || B > 65535 || H > 65535 || Lq <= 0 || Lk <= 0 ||
         Lq % tq != 0 || Lk % kTileK != 0 || Lk > 1024 || D <= 0 || D > 128;
}

Dropout make_dropout(int on, int seed, unsigned threshold, float scale) {
  return Dropout{on, (uint32_t)seed, threshold, scale};
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias,
                       const void* mask, void* o, int B, int H, int Lq, int Lk, int D,
                       int bias_heads, float sm_scale, Dropout dr, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(Lk, D);
  auto kernel = fullrow_fwd_kernel<T, kFwdTileQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Lq / kFwdTileQ, H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const int*>(mask), static_cast<T*>(o),
      H, Lq, Lk, D, bias_heads, sm_scale, dr);
  return cudaGetLastError();
}

template <typename T, int TQ>
cudaError_t launch_bwd_tq(const void* q, const void* k, const void* v, const void* bias,
                          const void* mask, const void* dout, void* dq, void* dk, void* dv,
                          void* db, int B, int H, int Lq, int Lk, int D, int bias_heads,
                          float sm_scale, Dropout dr, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(TQ, Lk, D);
  auto kernel = fullrow_bwd_kernel<T, TQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Lq / TQ, H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const int*>(mask),
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(db), H, Lq, Lk, D, bias_heads,
      sm_scale, dr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* bias,
                       const void* mask, const void* dout, void* dq, void* dk, void* dv,
                       void* db, int B, int H, int Lq, int Lk, int D, int bias_heads,
                       float sm_scale, Dropout dr, cudaStream_t stream) {
  if (bwd_tile_q(Lk) == 32)
    return launch_bwd_tq<T, 32>(q, k, v, bias, mask, dout, dq, dk, dv, db, B, H, Lq, Lk, D,
                                bias_heads, sm_scale, dr, stream);
  return launch_bwd_tq<T, 16>(q, k, v, bias, mask, dout, dq, dk, dv, db, B, H, Lq, Lk, D,
                              bias_heads, sm_scale, dr, stream);
}

}  // namespace

extern "C" int unicore_fullrow_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, const void* mask,
    void* o, int B, int H, int Lq, int Lk, int D, int bias_heads, float sm_scale,
    int dropout, int seed, unsigned threshold, float keep_scale, int dtype, void* stream) {
  if (bad_geometry(B, H, Lq, Lk, D, kFwdTileQ)) return (int)cudaErrorInvalidValue;
  const Dropout dr = make_dropout(dropout, seed, threshold, keep_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)launch_fwd<float>(q, k, v, bias, mask, o, B, H, Lq, Lk, D, bias_heads,
                                  sm_scale, dr, s);
  if (dtype == kBFloat16)
    return (int)launch_fwd<__nv_bfloat16>(q, k, v, bias, mask, o, B, H, Lq, Lk, D,
                                          bias_heads, sm_scale, dr, s);
  return (int)cudaErrorInvalidValue;
}

// dk, dv: fp32 (B, H, Lk, D) and db: fp32 (1, bias_heads, Lq, Lk) or null,
// all zeroed by the caller (the kernel adds into them).
extern "C" int unicore_fullrow_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias, const void* mask,
    const void* dout, void* dq, void* dk, void* dv, void* db, int B, int H, int Lq, int Lk,
    int D, int bias_heads, float sm_scale, int dropout, int seed, unsigned threshold,
    float keep_scale, int dtype, void* stream) {
  if (bad_geometry(B, H, Lq, Lk, D, bwd_tile_q(Lk)) || (db != nullptr && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  const Dropout dr = make_dropout(dropout, seed, threshold, keep_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)launch_bwd<float>(q, k, v, bias, mask, dout, dq, dk, dv, db, B, H, Lq, Lk,
                                  D, bias_heads, sm_scale, dr, s);
  if (dtype == kBFloat16)
    return (int)launch_bwd<__nv_bfloat16>(q, k, v, bias, mask, dout, dq, dk, dv, db, B, H,
                                          Lq, Lk, D, bias_heads, sm_scale, dr, s);
  return (int)cudaErrorInvalidValue;
}
