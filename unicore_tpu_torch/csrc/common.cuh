// Shared helpers of the port's CUDA kernels: fp32 <-> storage-type casts,
// warp reductions and the Philox generator of the attention dropout.
// Every kernel computes in fp32 whatever it stores.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace unicore {

// dtype codes the Python wrappers pass (0 = float32, 1 = bfloat16; the
// quantized inputs 2 = int8, 3 = int32; 4 = float16, the norms' --fp16 type)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kInt8 = 2;
constexpr int kInt32 = 3;
constexpr int kFloat16 = 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
// round to nearest even, as XLA's and torch's int32 -> fp32 converts
__device__ __forceinline__ float to_f(int32_t x) { return __int2float_rn(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// A type as a value, for dispatching a run-time dtype code to a template
template <typename T> struct Tag { using type = T; };

// f(Tag<T>{}) for the float type T of `dtype` (fp32, bf16 or fp16)
template <typename F>
cudaError_t dispatch_float(int dtype, F&& f) {
  if (dtype == kFloat32) return f(Tag<float>{});
  if (dtype == kBFloat16) return f(Tag<__nv_bfloat16>{});
  if (dtype == kFloat16) return f(Tag<__half>{});
  return cudaErrorInvalidValue;
}

// Two neighbouring elements of an attention bias (p even-aligned), fp32 or
// bf16, widened to fp32: a bf16 bias is read in place at half the bytes.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// f(Tag<T>{}, Tag<TB>{}) for the attention kernels' q type T of `dtype`
// (fp32 or bf16) and bias type TB of `bias_dtype`: fp32 with either, bf16
// with bf16 q (a --bf16 run casts both)
template <typename F>
cudaError_t dispatch_attention(int dtype, int bias_dtype, F&& f) {
  if (dtype == kFloat32 && bias_dtype == kFloat32) return f(Tag<float>{}, Tag<float>{});
  if (dtype == kBFloat16 && bias_dtype == kFloat32)
    return f(Tag<__nv_bfloat16>{}, Tag<float>{});
  if (dtype == kBFloat16 && bias_dtype == kBFloat16)
    return f(Tag<__nv_bfloat16>{}, Tag<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

// x rounded to T and back: what a product in T sees of an fp32 value
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
// 1, 2, 3", SC'11): ten rounds of the 4x32 bijection on the counter, the
// key bumped by the Weyl constants between rounds.  The attention dropout
// keys it on the int32 seed and counts (key column / 4, query row, head,
// batch), so every pass regenerates the same bits and nothing is stored.
// `philox_keep_plain` in ops/attention_fullrow.py computes the same bits in
// torch integer ops.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The attention kernels' dropout (full-row and flash): keep a probability
// when its Philox bits are >= threshold, scale kept ones by 1 / (1 - rate).
struct Dropout {
  int on;
  uint32_t seed;
  uint32_t threshold;  // keep when bits >= threshold
  float scale;         // 1 / (1 - rate)
};

inline Dropout make_dropout(int on, int seed, unsigned threshold, float scale) {
  return Dropout{on, (uint32_t)seed, threshold, scale};
}

// keep bits (bit w for key column c0 + w, c0 a multiple of 4) of one query
// row: one Philox call on the counter (c0 / 4, row, head, batch)
__device__ __forceinline__ uint32_t keep4(const Dropout& dr, int b, int h, int row, int c0) {
  const uint4 r = philox4x32_10(
      make_uint4((uint32_t)(c0 >> 2), (uint32_t)row, (uint32_t)h, (uint32_t)b), dr.seed, 0u);
  return (uint32_t)(r.x >= dr.threshold) | ((uint32_t)(r.y >= dr.threshold) << 1) |
         ((uint32_t)(r.z >= dr.threshold) << 2) | ((uint32_t)(r.w >= dr.threshold) << 3);
}

}  // namespace unicore
