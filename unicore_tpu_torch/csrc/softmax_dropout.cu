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
// What bounds them on this card: bytes.  The forward reads x and writes y,
// the backward reads x and dy and writes fp32 ds; ~10 flops and a quarter
// of a Philox call per element are far below the H100's 20 fp32 flops per
// byte.  At the Uni-Mol training shape, fp32 (R, M, L) = (16 * 64, 128, 128),
// that is 134 MB and 201 MB: 0.040 and 0.060 ms at 3.35 TB/s.
//
// What the design does about it: one pass over memory each way.  Rows up
// to 1024 long take one warp each, four warps to a block, with the row in
// registers: lane l holds the four columns 4l..4l+3 of every 128-column
// chunk, which is exactly one Philox call's worth.  Longer rows (up to the
// gate's 8192) take one 256-thread block each, with the row in 32 KB of
// shared memory.  Offsets are 64-bit; the grid's x dimension takes up to
// 2^31 - 1 blocks, far beyond R * M at B = 128, H = 64, L = 512.
// Vectorised 16-byte loads and fusing the drop into the PV product are left
// to a later PR.
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

__device__ __forceinline__ float extra_at(const Extra& e, long long base, int col) {
  const long long i = base + (long long)col * e.col_stride;
  return e.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(e.ptr)[i])
                : static_cast<const float*>(e.ptr)[i];
}

// v = x * sc (+ mask) (+ bias) for the four columns c0..c0+3 of a row; sc is
// 1 for an fp32/bf16 x, where the product is x itself, bit for bit
template <typename TI>
__device__ __forceinline__ void load_quad(const TI* xr, float sc, const Extra& mask,
                                          long long mb, const Extra& bias, long long bb,
                                          int c0, float v[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float t = __fmul_rn(to_f(xr[c0 + j]), sc);
    if (mask.ptr != nullptr) t += extra_at(mask, mb, c0 + j);
    if (bias.ptr != nullptr) t += extra_at(bias, bb, c0 + j);
    v[j] = t;
  }
}

// keep flags of the four columns c0..c0+3 (c0 a multiple of 4) of row (r, m)
__device__ __forceinline__ void keep_quad(const Drop& dr, long long r, int m, int c0,
                                          bool keep[4]) {
  const uint4 w = philox4x32_10(make_uint4((uint32_t)(c0 >> 2), (uint32_t)m, (uint32_t)r, 0u),
                                dr.seed, 0u);
  keep[0] = w.x >= dr.threshold;
  keep[1] = w.y >= dr.threshold;
  keep[2] = w.z >= dr.threshold;
  keep[3] = w.w >= dr.threshold;
}

template <typename T>
__device__ __forceinline__ T drop_out(const Drop& dr, float p, bool keep) {
  const T y = from_f<T>(p);
  if (!dr.on) return y;
  return keep ? from_f<T>(to_f(y) / dr.div) : from_f<T>(0.f);
}

__device__ __forceinline__ float drop_grad(const Drop& dr, float dy, bool keep) {
  if (!dr.on) return dy;
  return keep ? dy * dr.scale : 0.f;
}

// ---------------------------------------------------------------------------
// rows up to 1024: one warp per row, the row in registers (CH chunks of 128)
// ---------------------------------------------------------------------------

template <typename TI, int CH>
__device__ __forceinline__ void warp_row_probs(const TI* xr, float sc, const Extra& mask,
                                               const Extra& bias, long long r, int m,
                                               int lane, float p[CH][4]) {
  const long long mb = mask.ptr != nullptr ? extra_base(mask, r, m) : 0;
  const long long bb = bias.ptr != nullptr ? extra_base(bias, r, m) : 0;
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    load_quad(xr, sc, mask, mb, bias, bb, c * 128 + lane * 4, p[c]);
#pragma unroll
    for (int j = 0; j < 4; ++j) mx = fmaxf(mx, p[c][j]);
  }
  mx = warp_max(mx);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[c][j] = expf(p[c][j] - mx);
      s += p[c][j];
    }
  }
  s = warp_sum(s);
#pragma unroll
  for (int c = 0; c < CH; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) p[c][j] = p[c][j] / s;
  }
}

// TI: the stored input (fp32, bf16, or int8/int32 with `scale`); TO: the
// output (the input's type, fp32 for a quantized input)
template <typename TI, typename TO, int CH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
softmax_dropout_fwd_warp(const TI* __restrict__ x, const float* __restrict__ scale,
                         Extra mask, Extra bias, TO* __restrict__ y, long long rows, int M,
                         Drop dr) {
  constexpr int L = CH * 128;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long r = row / M;
  const int m = (int)(row % M);
  float p[CH][4];
  warp_row_probs<TI, CH>(x + row * L, scale != nullptr ? *scale : 1.f, mask, bias, r, m,
                         lane, p);
  TO* yr = y + row * L;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int c0 = c * 128 + lane * 4;
    bool keep[4] = {true, true, true, true};
    if (dr.on) keep_quad(dr, r, m, c0, keep);
#pragma unroll
    for (int j = 0; j < 4; ++j) yr[c0 + j] = drop_out<TO>(dr, p[c][j], keep[j]);
  }
}

template <typename T, int CH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
softmax_dropout_bwd_warp(const T* __restrict__ x, Extra mask, Extra bias,
                         const T* __restrict__ dy, float* __restrict__ ds, long long rows,
                         int M, Drop dr) {
  constexpr int L = CH * 128;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long r = row / M;
  const int m = (int)(row % M);
  float p[CH][4], dp[CH][4];
  warp_row_probs<T, CH>(x + row * L, 1.f, mask, bias, r, m, lane, p);
  const T* gr = dy + row * L;
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int c0 = c * 128 + lane * 4;
    bool keep[4] = {true, true, true, true};
    if (dr.on) keep_quad(dr, r, m, c0, keep);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dp[c][j] = drop_grad(dr, to_f(gr[c0 + j]), keep[j]);
      dot += dp[c][j] * p[c][j];
    }
  }
  dot = warp_sum(dot);
  float* dsr = ds + row * L;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int c0 = c * 128 + lane * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) dsr[c0 + j] = p[c][j] * (dp[c][j] - dot);
  }
}

// ---------------------------------------------------------------------------
// rows over 1024: one block per row, the row in shared memory
// ---------------------------------------------------------------------------

// the block's max (is_max) or sum of v; every thread gets it
__device__ __forceinline__ float block_reduce(float v, bool is_max, float* red) {
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

// p of one row into srow; each thread touches only its own quads
template <typename TI>
__device__ __forceinline__ void block_row_probs(const TI* xr, float sc, const Extra& mask,
                                                const Extra& bias, long long r, int m, int L,
                                                float* srow, float* red) {
  const long long mb = mask.ptr != nullptr ? extra_base(mask, r, m) : 0;
  const long long bb = bias.ptr != nullptr ? extra_base(bias, r, m) : 0;
  float mx = -CUDART_INF_F;
  for (int c0 = threadIdx.x * 4; c0 < L; c0 += kRowThreads * 4) {
    float v[4];
    load_quad(xr, sc, mask, mb, bias, bb, c0, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      srow[c0 + j] = v[j];
      mx = fmaxf(mx, v[j]);
    }
  }
  mx = block_reduce(mx, true, red);
  float s = 0.f;
  for (int c0 = threadIdx.x * 4; c0 < L; c0 += kRowThreads * 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float e = expf(srow[c0 + j] - mx);
      srow[c0 + j] = e;
      s += e;
    }
  }
  s = block_reduce(s, false, red);
  for (int c0 = threadIdx.x * 4; c0 < L; c0 += kRowThreads * 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) srow[c0 + j] = srow[c0 + j] / s;
  }
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(kRowThreads)
softmax_dropout_fwd_block(const TI* __restrict__ x, const float* __restrict__ scale,
                          Extra mask, Extra bias, TO* __restrict__ y, int M, int L, Drop dr) {
  __shared__ float srow[kMaxL];
  __shared__ float red[kRowThreads / 32 + 1];
  const long long row = blockIdx.x;
  const long long r = row / M;
  const int m = (int)(row % M);
  block_row_probs<TI>(x + row * L, scale != nullptr ? *scale : 1.f, mask, bias, r, m, L,
                      srow, red);
  TO* yr = y + row * L;
  for (int c0 = threadIdx.x * 4; c0 < L; c0 += kRowThreads * 4) {
    bool keep[4] = {true, true, true, true};
    if (dr.on) keep_quad(dr, r, m, c0, keep);
#pragma unroll
    for (int j = 0; j < 4; ++j) yr[c0 + j] = drop_out<TO>(dr, srow[c0 + j], keep[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
softmax_dropout_bwd_block(const T* __restrict__ x, Extra mask, Extra bias,
                          const T* __restrict__ dy, float* __restrict__ ds, int M, int L,
                          Drop dr) {
  __shared__ float srow[kMaxL];
  __shared__ float red[kRowThreads / 32 + 1];
  const long long row = blockIdx.x;
  const long long r = row / M;
  const int m = (int)(row % M);
  block_row_probs<T>(x + row * L, 1.f, mask, bias, r, m, L, srow, red);
  const T* gr = dy + row * L;
  float dot = 0.f;
  for (int c0 = threadIdx.x * 4; c0 < L; c0 += kRowThreads * 4) {
    bool keep[4] = {true, true, true, true};
    if (dr.on) keep_quad(dr, r, m, c0, keep);
#pragma unroll
    for (int j = 0; j < 4; ++j) dot += drop_grad(dr, to_f(gr[c0 + j]), keep[j]) * srow[c0 + j];
  }
  dot = block_reduce(dot, false, red);
  float* dsr = ds + row * L;
  // dp is regenerated (dy re-read, the keep bits drawn again) rather than
  // held: the row's p already fills the 32 KB of shared memory
  for (int c0 = threadIdx.x * 4; c0 < L; c0 += kRowThreads * 4) {
    bool keep[4] = {true, true, true, true};
    if (dr.on) keep_quad(dr, r, m, c0, keep);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float dp = drop_grad(dr, to_f(gr[c0 + j]), keep[j]);
      dsr[c0 + j] = srow[c0 + j] * (dp - dot);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

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
    if (e->dims[d] < 1) return false;
  }
  return true;
}

bool bad_geometry(long long R, int M, int L) {
  return R <= 0 || M <= 0 || L <= 0 || L % 128 != 0 || L > kMaxL ||
         R * M > 0x7fffffffLL * (L <= kWarpRowMaxL ? kWarpsPerBlock : 1);
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
  const unsigned grid = (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int threads = kWarpsPerBlock * 32;
  switch (L / 128) {
#define UNICORE_SD_FWD(CH)                                                              \
  case CH:                                                                              \
    softmax_dropout_fwd_warp<TI, TO, CH><<<grid, threads, 0, s>>>(xt, scale, mask, bias, \
                                                                  yt, rows, M, dr);      \
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
  const unsigned grid = (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int threads = kWarpsPerBlock * 32;
  switch (L / 128) {
#define UNICORE_SD_BWD(CH)                                                                 \
  case CH:                                                                                 \
    softmax_dropout_bwd_warp<T, CH><<<grid, threads, 0, s>>>(xt, mask, bias, gt, dst, rows, \
                                                             M, dr);                       \
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

// x, y: (R, M, L) fp32 or bf16 (dtype); mask/bias with their descriptors, or
// null.  dropout: on, seed, threshold, and `div` = (1 - rate) rounded to the
// output type.
extern "C" int unicore_softmax_dropout_fwd(const void* x, const void* mask,
                                           const long long* mask_desc, const void* bias,
                                           const long long* bias_desc, void* y, long long R,
                                           int M, int L, int dropout, unsigned seed,
                                           unsigned threshold, float div, int dtype,
                                           void* stream) {
  Extra em, eb;
  if (bad_geometry(R, M, L) || !make_extra(mask, mask_desc, &em) ||
      !make_extra(bias, bias_desc, &eb))
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
  if (scale == nullptr || bad_geometry(R, M, L) || !make_extra(mask, mask_desc, &em) ||
      !make_extra(bias, bias_desc, &eb))
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
  if (bad_geometry(R, M, L) || !make_extra(mask, mask_desc, &em) ||
      !make_extra(bias, bias_desc, &eb))
    return (int)cudaErrorInvalidValue;
  const Drop dr{dropout, seed, threshold, 1.f, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return (int)launch_bwd<float>(x, em, eb, dy, ds, R, M, L, dr, s);
  if (dtype == kBFloat16)
    return (int)launch_bwd<__nv_bfloat16>(x, em, eb, dy, ds, R, M, L, dr, s);
  return (int)cudaErrorInvalidValue;
}
