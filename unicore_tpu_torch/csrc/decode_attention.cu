// Single-query attention over a K/V cache for Hopper (sm_90a): the decode
// step's attention.
//
// Replaces the TPU kernel of unicore_tpu/ops/decode_attention.py,
// `_decode_kernel` (:98, launched by `_decode_pallas` :125 through
// `pallas_call` :161), with its fp32/bf16 and int8-KV variants.
//
// What it computes, per (batch b, head h), everything in fp32:
//   k_l = k_cache[b, h, l, :] (int8: times k_scale[h, :], channel by channel)
//   s_l = q[b, h, :] . k_l + bias[b, h, l]           (q is pre-scaled)
//   rows l > positions[b] are dead (-1e30 in the reference)
//   p = softmax(s) over the row; out[b, h, :] = sum_l p_l v_l (v dequantized
//   as k), cast once to q's type.
// The caches are (B, H, L, D) fp32/bf16 (q's type) or int8 with (H, D) fp32
// scales; positions (B,) int32 is read on the device (no host sync); bias
// (B, H, L) fp32 or null.  Dead rows are skipped, not read: the reference
// masks them to -1e30, and exp(-1e30 - m) is exactly 0 in fp32 because the
// query's own row (positions[b]) is live and m is finite, so skipping gives
// the same result and keeps junk in unwritten pages out of the read.
// positions[b] must lie in [0, L); the kernel clamps the live count to
// [1, L] so that a bad position cannot read out of bounds.
//
// What bounds it on this card: bytes.  Every live K and V element is read
// once and used for two flops, far below the H100's 295 flops-per-byte
// ridge.  At the serving shape (B, H, L, D) = (8, 12, 512, 64), fp32, every
// row live: 25.4 MB (K, V, the bias row, q and out) -> 7.6 us at 3.35 TB/s;
// with int8 caches 6.5 MB -> 1.9 us.
//
// What the design does about it: one block of 4 warps per (b, h).  Each warp
// takes a contiguous share of the live rows; within it, groups of G lanes
// (G the smallest power of two with 4 G >= D, at most 32) each take one row
// at a time, a lane loading 4 consecutive channels per load (16 bytes in
// fp32, 8 in bf16, 4 as char4 in int8; two loads per lane above D = 128),
// so neighbouring lanes read neighbouring addresses.  The group sums its
// dot product by shuffles and keeps a running max, sum and its lanes' share
// of the D-wide accumulator (online softmax); the groups then combine
// through shared memory, and the output is divided and cast once.  Offsets
// are 64-bit.  One block per (b, h) gives 96 blocks at the serving shape
// for 132 SMs, and each keeps few loads in flight: splitting the rows of a
// (b, h) across blocks with a second combine pass is left to a later PR.
#include <cstdint>

#include "common.cuh"

namespace {

using namespace unicore;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxLoads = 2;                      // 4-channel loads per lane
constexpr int kMaxHeadDim = 32 * 4 * kMaxLoads;   // 256
// groups x D <= 4 warps x (32 lanes x 4 channels x 2 loads)
constexpr int kAccFloats = kWarps * kMaxHeadDim;

// four consecutive channels of a row, as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// NL: 4-channel loads per lane (1 for D <= 128, 2 above)
template <typename TQ, typename TKV, bool kQuant, int NL>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kc,
                        const TKV* __restrict__ vc, const int* __restrict__ positions,
                        const float* __restrict__ bias, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, TQ* __restrict__ out, int H, int L,
                        int D, int G) {
  __shared__ float s_m[kThreads];
  __shared__ float s_l[kThreads];
  __shared__ float s_w[kThreads];
  __shared__ float s_acc[kAccFloats];
  __shared__ float s_total;

  const long long bh = blockIdx.x;
  const int h = (int)(bh % H);
  const int b = (int)(bh / H);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = 32 / G;  // rows a warp takes at once
  const int grp = lane / G, gl = lane % G;
  const int live = min(max(positions[b] + 1, 1), L);

  // this lane's channels: 4 (gl + j G) .. + 3, for the loads j < NL
  bool on[NL];
  float4 qv[NL], ks[NL], vs[NL], acc[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const int c = 4 * (gl + j * G);
    on[j] = c < D;
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    qv[j] = ks[j] = vs[j] = acc[j];
    if (on[j]) {
      qv[j] = load4(q + bh * D + c);
      if (kQuant) {
        ks[j] = load4(k_scale + (long long)h * D + c);
        vs[j] = load4(v_scale + (long long)h * D + c);
      }
    }
  }

  // this warp's contiguous share of the live rows [0, live)
  const int per_warp = (live + kWarps - 1) / kWarps;
  const int r0 = warp * per_warp;
  const int r1 = min(live, r0 + per_warp);
  const long long row0 = bh * L;  // (b, h, 0) in rows
  float m = -INFINITY, l = 0.f;
  // a trip count uniform across the warp: every lane reaches the shuffles
  for (int base = r0; base < r1; base += R) {
    const int r = base + grp;
    const bool valid = r < r1;
    const long long off = (row0 + (valid ? r : r0)) * D;
    float dot = 0.f;
    if (valid) {
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        if (!on[j]) continue;
        float4 k4 = load4(kc + off + 4 * (gl + j * G));
        if (kQuant) k4 = mul4(k4, ks[j]);
        dot += qv[j].x * k4.x + qv[j].y * k4.y + qv[j].z * k4.z + qv[j].w * k4.w;
      }
    }
    for (int o = G >> 1; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (!valid) continue;
    const float s = dot + (bias != nullptr ? bias[row0 + r] : 0.f);
    const float m_new = fmaxf(m, s);
    // corr is 0 on the group's first row; a row of -inf scores so far
    // (a -inf bias) keeps l and acc at 0 instead of making NaN
    const bool none = m_new == -INFINITY;
    const float corr = none ? 1.f : expf(m - m_new);
    const float p = none ? 0.f : expf(s - m_new);
    l = l * corr + p;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      if (!on[j]) continue;
      float4 v4 = load4(vc + off + 4 * (gl + j * G));
      if (kQuant) v4 = mul4(v4, vs[j]);
      acc[j].x = acc[j].x * corr + p * v4.x;
      acc[j].y = acc[j].y * corr + p * v4.y;
      acc[j].z = acc[j].z * corr + p * v4.z;
      acc[j].w = acc[j].w * corr + p * v4.w;
    }
    m = m_new;
  }

  // combine the groups: group g holds (m_g, l_g, acc_g[D]); an empty group
  // has l_g = 0 and weight 0
  const int gid = warp * R + grp;
  const int groups = kWarps * R;
  if (gl == 0) {
    s_m[gid] = m;
    s_l[gid] = l;
  }
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    if (!on[j]) continue;
    float* dst = s_acc + gid * D + 4 * (gl + j * G);
    dst[0] = acc[j].x;
    dst[1] = acc[j].y;
    dst[2] = acc[j].z;
    dst[3] = acc[j].w;
  }
  __syncthreads();
  if (warp == 0) {
    float mm = -INFINITY;
    for (int g = lane; g < groups; g += 32)
      if (s_l[g] > 0.f) mm = fmaxf(mm, s_m[g]);
    mm = warp_max(mm);
    float total = 0.f;
    for (int g = lane; g < groups; g += 32) {
      const float w = s_l[g] > 0.f ? expf(s_m[g] - mm) : 0.f;
      s_w[g] = w;
      total += s_l[g] * w;
    }
    total = warp_sum(total);
    if (lane == 0) s_total = total;
  }
  __syncthreads();
  const float inv = 1.f / s_total;
  for (int c = tid; c < D; c += kThreads) {
    float o = 0.f;
    for (int g = 0; g < groups; ++g) o += s_w[g] * s_acc[g * D + c];
    out[bh * D + c] = from_f<TQ>(o * inv);
  }
}

template <typename TQ, typename TKV, bool kQuant>
cudaError_t launch(const void* q, const void* k, const void* v, const void* positions,
                   const void* bias, const void* k_scale, const void* v_scale, void* out, int B,
                   int H, int L, int D, cudaStream_t stream) {
  const int quads = D / 4;
  int G = 1;
  while (G < quads && G < 32) G <<= 1;
  const int loads = (quads + G - 1) / G;
  const dim3 grid((unsigned)((long long)B * H));
#define UNICORE_DECODE_ARGS                                                              \
  static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),     \
      static_cast<const int*>(positions), static_cast<const float*>(bias),               \
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),            \
      static_cast<TQ*>(out), H, L, D, G
  if (loads == 1)
    decode_attention_kernel<TQ, TKV, kQuant, 1><<<grid, kThreads, 0, stream>>>(UNICORE_DECODE_ARGS);
  else
    decode_attention_kernel<TQ, TKV, kQuant, 2><<<grid, kThreads, 0, stream>>>(UNICORE_DECODE_ARGS);
#undef UNICORE_DECODE_ARGS
  return cudaGetLastError();
}

}  // namespace

// q, out: (B, H, D) in `dtype` (0 fp32, 1 bf16); k, v: (B, H, L, D) in q's
// type, or int8 when `quant` (then k_scale, v_scale: (H, D) fp32, else
// null); positions: (B,) int32; bias: (B, H, L) fp32 or null.  All
// contiguous.  D must be a multiple of 4 and at most 256.
extern "C" int unicore_decode_attention(const void* q, const void* k, const void* v,
                                        const void* positions, const void* bias,
                                        const void* k_scale, const void* v_scale, void* out,
                                        int B, int H, int L, int D, int dtype, int quant,
                                        void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || D <= 0 || D % 4 != 0 || D > kMaxHeadDim ||
      (long long)B * H > 0x7fffffffLL || (quant != 0) != (k_scale != nullptr) ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    if (quant)
      return (int)launch<float, int8_t, true>(q, k, v, positions, bias, k_scale, v_scale, out,
                                               B, H, L, D, s);
    return (int)launch<float, float, false>(q, k, v, positions, bias, k_scale, v_scale, out, B,
                                            H, L, D, s);
  }
  if (dtype == kBFloat16) {
    if (quant)
      return (int)launch<__nv_bfloat16, int8_t, true>(q, k, v, positions, bias, k_scale,
                                                       v_scale, out, B, H, L, D, s);
    return (int)launch<__nv_bfloat16, __nv_bfloat16, false>(q, k, v, positions, bias, k_scale,
                                                            v_scale, out, B, H, L, D, s);
  }
  return (int)cudaErrorInvalidValue;
}
