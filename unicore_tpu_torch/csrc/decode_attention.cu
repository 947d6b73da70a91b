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
// q is fp32, bf16 or fp16; the caches are (B, H, L, D) in q's type, fp32
// (a bf16 or fp16 model's decode step against the fp32 pool), or int8 with
// (H, D) fp32 scales; positions (B,) int32 is read on the device (no host
// sync); bias (B, H, L) fp32, bf16 or fp16, or null.  Every operand is read
// as fp32 in registers, as the TPU kernel upcasts its refs: no cast launch
// goes ahead of the kernel.  Dead rows are skipped, not read: the reference
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
// What the design does about it (flash-decoding): the rows of each (b, h)
// are split across S blocks (S from the wrapper's `choose_splits`, a
// function of B * H and L only, never of the positions), so that B * H * S
// blocks fill the card: 768 blocks of 64 rows at the serving shape where
// one block a (b, h) made 96 for 132 SMs.  A block streams its chunk's live
// rows through a two-stage ring in shared memory, each stage one bulk
// asynchronous copy (`cp.async.bulk`, completing on an mbarrier) of its K
// rows, its V rows and its bias entries: a chunk's rows are contiguous, so
// one thread puts many KB in flight before the first dot product, where
// loads issued row by row kept ~2 KB in flight an SM.  From shared memory,
// every row of a stage gets its dot product at once (128 / rows lanes a row,
// the rows' channel order rotated so that rows read different banks), the
// block takes the tile's max and sum (online softmax across tiles), and
// each thread accumulates one 4-channel quad of p v over its share of the
// rows.  A chunk past positions[b] reads
// nothing and writes l = 0.  Each block writes its partial (o[D], m, l) to
// a scratch slab; the last block of a (b, h) to arrive (a fence, then an
// atomic counter, which it resets to 0 for the next launch) combines the S
// partials in split order, so the result repeats bit for bit, and writes
// the output.  One launch a call: the decode step is host-bound, and a
// second combine launch or a counter memset would cost a launch.  With
// S = 1 the block writes the output itself.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace unicore;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxSplits = 512;
constexpr int kStageKV = 8192;     // K bytes of a stage (and as many of V)
constexpr int kMaxTileRows = 128;  // <= kThreads: one score a thread
// a stage: K and V spans (each up to 16 bytes early and late for the
// 16-byte alignment of a bulk copy) and the bias span
constexpr int kSpanPad = 32;
constexpr int kStageBytes = 2 * (kStageKV + kSpanPad) + kMaxTileRows * 4 + kSpanPad;

// rows of a stage: a power of two from 8 to 128 whose K rows fit kStageKV
// (so 128 / rows lanes a row, a power of two up to 16, score a row)
int tile_rows(int row_bytes) {
  int t = kMaxTileRows;
  while (t > 8 && t * row_bytes > kStageKV) t >>= 1;
  return t;
}

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
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// the 16-byte-aligned span of device memory enclosing [p, p + bytes): what
// one bulk copy takes; `off` is p's offset in it
struct Span {
  const char* src;
  int bytes;
  int off;
};

__device__ __forceinline__ Span span_of(const void* p, int bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t lo = a & ~static_cast<uintptr_t>(15);
  const uintptr_t hi = (a + bytes + 15) & ~static_cast<uintptr_t>(15);
  return {reinterpret_cast<const char*>(lo), bytes > 0 ? static_cast<int>(hi - lo) : 0,
          static_cast<int>(a - lo)};
}

// tile rows [r, r + n) of this (b, h) into stage `dst`, completing on `bar`
// (every thread calls it with the same arguments)
template <typename TKV, typename TB>
__device__ __forceinline__ void load_tile(char* dst, uint64_t* bar, const TKV* kc, const TKV* vc,
                                          const TB* bias, long long row, int n, int D) {
  const int rb = D * (int)sizeof(TKV);
  const Span sk = span_of(kc + row * D, n * rb);
  const Span sv = span_of(vc + row * D, n * rb);
  const Span sb =
      bias != nullptr ? span_of(bias + row, n * (int)sizeof(TB)) : Span{nullptr, 0, 0};
  // K at dst, V after K's span, the bias after V's
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, (uint32_t)(sk.bytes + sv.bytes + sb.bytes));
    bulk_g2s(dst, sk.src, sk.bytes, bar);
    bulk_g2s(dst + sk.bytes, sv.src, sv.bytes, bar);
    if (sb.bytes) bulk_g2s(dst + sk.bytes + sv.bytes, sb.src, sb.bytes, bar);
  }
}

template <typename TQ, typename TKV, typename TB, bool kQuant>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kc,
                        const TKV* __restrict__ vc, const int* __restrict__ positions,
                        const TB* __restrict__ bias, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, TQ* __restrict__ out,
                        float* __restrict__ partials, int* __restrict__ counters, int H, int L,
                        int D, int T, int S) {
  __shared__ __align__(128) char s_stage[2][kStageBytes];
  __shared__ float4 s_q[kMaxHeadDim / 4], s_ks[kMaxHeadDim / 4];  // q, the int8 k scales
  __shared__ float s_p[kMaxTileRows];
  __shared__ float s_red[2][kWarps];
  __shared__ __align__(8) uint64_t s_bar[2];
  __shared__ int s_last;

  const long long bh = blockIdx.x / S;
  const int split = (int)(blockIdx.x % S);
  const int h = (int)(bh % H);
  const int b = (int)(bh / H);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int live = min(max(positions[b] + 1, 1), L);
  const int chunk = (L + S - 1) / S;
  const int r_begin = split * chunk;
  const int n_rows = max(0, min(r_begin + chunk, live) - r_begin);
  const int ntiles = (n_rows + T - 1) / T;
  const long long row0 = bh * L + r_begin;  // (b, h, r_begin) in rows
  const int rb = D * (int)sizeof(TKV);

  if (tid == 0) {
    mbar_init(&s_bar[0], 1);
    mbar_init(&s_bar[1], 1);
    mbar_fence_init();
  }
  for (int c = tid; c < D / 4; c += kThreads) {
    s_q[c] = load4(q + bh * D + 4 * c);
    if (kQuant) s_ks[c] = load4(k_scale + (long long)h * D + 4 * c);
  }
  __syncthreads();
  for (int i = 0; i < 2 && i < ntiles; ++i)
    load_tile(s_stage[i], &s_bar[i], kc, vc, bias, row0 + i * T, min(T, n_rows - i * T), D);

  // scores: P = 128 / T lanes a row, each summing a share of its quads
  const int Q = D / 4, P = kThreads / T;
  const int srow = tid / P, sl = tid % P;
  const int rot = (srow * P) % Q;  // rows rotate their quads: no bank conflicts between rows
  // p v: this thread's quad and its share of the rows
  const int RG = kThreads / Q;
  const int quad = tid % Q, rg = tid / Q;
  const bool pv_on = rg < RG;
  const float4 vs = (kQuant && pv_on) ? load4(v_scale + (long long)h * D + 4 * quad)
                                      : make_float4(1.f, 1.f, 1.f, 1.f);
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = -INFINITY, l = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    const int st = i & 1;
    const int nr = min(T, n_rows - i * T);
    const long long row = row0 + i * T;
    const int rbytes = nr * rb;
    const Span sk = span_of(kc + row * D, rbytes);
    const Span sv = span_of(vc + row * D, rbytes);
    const char* kt = s_stage[st] + sk.off;
    const char* vt = s_stage[st] + sk.bytes + sv.off;
    const TB* bt = nullptr;
    if (bias != nullptr)
      bt = reinterpret_cast<const TB*>(s_stage[st] + sk.bytes + sv.bytes +
                                       span_of(bias + row, nr * (int)sizeof(TB)).off);
    mbar_wait(&s_bar[st], (i >> 1) & 1);

    // scores: every lane reaches the shuffles (P divides 32)
    {
      const bool valid = srow < nr;
      const TKV* kr = reinterpret_cast<const TKV*>(kt + (valid ? srow : 0) * rb);
      float dot = 0.f;
      if (valid) {
        for (int i = sl; i < Q; i += P) {
          const int qd = i + rot < Q ? i + rot : i + rot - Q;
          float4 k4 = load4(kr + 4 * qd);
          if (kQuant) k4 = mul4(k4, s_ks[qd]);
          const float4 q4 = s_q[qd];
          dot += q4.x * k4.x + q4.y * k4.y + q4.z * k4.z + q4.w * k4.w;
        }
      }
      for (int off = P >> 1; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (valid && sl == 0) s_p[srow] = dot + (bt != nullptr ? to_f(bt[srow]) : 0.f);
    }
    __syncthreads();

    // the tile's max, then its probabilities and their sum (online softmax:
    // a tile of -inf scores so far keeps l and o at 0 instead of NaN)
    const float s_mine = tid < nr ? s_p[tid] : -INFINITY;
    const float wmax = warp_max(s_mine);
    if (lane == 0) s_red[0][warp] = wmax;
    __syncthreads();
    const float m_new = fmaxf(m, fmaxf(fmaxf(s_red[0][0], s_red[0][1]),
                                       fmaxf(s_red[0][2], s_red[0][3])));
    const bool none = m_new == -INFINITY;
    const float corr = none ? 1.f : expf(m - m_new);
    const float p = (tid < nr && !none) ? expf(s_mine - m_new) : 0.f;
    if (tid < nr) s_p[tid] = p;
    const float wsum = warp_sum(p);
    if (lane == 0) s_red[1][warp] = wsum;
    __syncthreads();
    l = l * corr + ((s_red[1][0] + s_red[1][1]) + (s_red[1][2] + s_red[1][3]));
    m = m_new;

    if (pv_on) {
      o.x *= corr;
      o.y *= corr;
      o.z *= corr;
      o.w *= corr;
      for (int r = rg; r < nr; r += RG) {
        const float pr = s_p[r];
        float4 v4 = load4(reinterpret_cast<const TKV*>(vt + r * rb) + 4 * quad);
        if (kQuant) v4 = mul4(v4, vs);
        o.x += pr * v4.x;
        o.y += pr * v4.y;
        o.z += pr * v4.z;
        o.w += pr * v4.w;
      }
    }
    // every thread is done with stage st and s_p before the stage refills
    if (i + 2 < ntiles) fence_proxy_async();
    __syncthreads();
    if (i + 2 < ntiles)
      load_tile(s_stage[st], &s_bar[st], kc, vc, bias, row + 2 * T, min(T, n_rows - (i + 2) * T),
                D);
  }

  // this block's o: the row groups' quads summed in order (in the idle stage)
  float4* s_o = reinterpret_cast<float4*>(s_stage[0]);
  s_o[tid] = o;
  __syncthreads();
  if (S == 1) {
    const float inv = 1.f / l;
    for (int c = tid; c < D; c += kThreads) {
      float acc = 0.f;
      for (int g = 0; g < RG; ++g) acc += (&s_o[g * Q + c / 4].x)[c % 4];
      out[bh * D + c] = from_f<TQ>(acc * inv);
    }
    return;
  }
  float* part = partials + (bh * S + split) * (D + 2);
  for (int c = tid; c < D; c += kThreads) {
    float acc = 0.f;
    for (int g = 0; g < RG; ++g) acc += (&s_o[g * Q + c / 4].x)[c % 4];
    part[c] = acc;
  }
  if (tid == 0) {
    part[D] = m;
    part[D + 1] = l;
  }
  // the last block of this (b, h) to arrive combines the S partials
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // this block's partial before its arrival
    s_last = atomicAdd(&counters[bh], 1) == S - 1;
    if (s_last) {
      __threadfence();  // every block's partial before the reads below
      counters[bh] = 0;  // ready for the next launch
    }
  }
  __syncthreads();
  if (!s_last) return;
  // every thread reads every split's (m, l) and its channels' o, the loads
  // free of each other; weights exp(m_s - max) (0 for an empty chunk or one
  // of -inf scores); every sum in split order
  const float* base = partials + bh * S * (D + 2);
  float mm = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < S; ++s) {
    const float ms = __ldcg(base + s * (D + 2) + D), ls = __ldcg(base + s * (D + 2) + D + 1);
    mm = ls > 0.f ? fmaxf(mm, ms) : mm;
  }
  for (int c = tid; c < D; c += kThreads) {
    float acc = 0.f, total = 0.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) {
      const float* ps = base + s * (D + 2);
      const float ms = __ldcg(ps + D), ls = __ldcg(ps + D + 1), os = __ldcg(ps + c);
      const float w = ls > 0.f ? expf(ms - mm) : 0.f;
      total += ls * w;
      acc += w * os;
    }
    out[bh * D + c] = from_f<TQ>(acc / total);
  }
}

template <typename TQ, typename TKV, typename TB, bool kQuant>
cudaError_t launch(const void* q, const void* k, const void* v, const void* positions,
                   const void* bias, const void* k_scale, const void* v_scale, void* out,
                   void* partials, void* counters, int B, int H, int L, int D, int S,
                   cudaStream_t stream) {
  const int T = tile_rows(D * (int)sizeof(TKV));
  const dim3 grid((unsigned)((long long)B * H * S));
#define UNICORE_DECODE_ARGS                                                              \
  static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),     \
      static_cast<const int*>(positions), static_cast<const TB*>(bias),                  \
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),            \
      static_cast<TQ*>(out), static_cast<float*>(partials), static_cast<int*>(counters), \
      H, L, D, T, S
  decode_attention_kernel<TQ, TKV, TB, kQuant><<<grid, kThreads, 0, stream>>>(
      UNICORE_DECODE_ARGS);
#undef UNICORE_DECODE_ARGS
  return cudaGetLastError();
}

}  // namespace

// q, out: (B, H, D) in `dtype` (0 fp32, 1 bf16, 4 fp16); k, v: (B, H, L, D)
// in `kv_dtype` (q's type, or fp32), or int8 when `quant` (then
// k_scale, v_scale: (H, D) fp32, else null; `kv_dtype` is not read);
// positions: (B,) int32; bias: (B, H, L) in `bias_dtype` (0 fp32, 1 bf16,
// 4 fp16) or null.  All contiguous.  D must be a multiple of 4 and at most
// 256.  splits: the blocks a (b, h), 1 to min(L, 512); above 1, partials
// holds B * H * splits * (D + 2) fp32 and counters B * H int32 zeros, which
// the kernel leaves at zero (one launch at a time may use them).
extern "C" int unicore_decode_attention(const void* q, const void* k, const void* v,
                                        const void* positions, const void* bias,
                                        const void* k_scale, const void* v_scale, void* out,
                                        void* partials, void* counters, int B, int H, int L,
                                        int D, int dtype, int kv_dtype, int bias_dtype, int quant,
                                        int splits, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || D <= 0 || D % 4 != 0 || D > kMaxHeadDim ||
      splits < 1 || splits > kMaxSplits || splits > L ||
      (long long)B * H * splits > 0x7fffffffLL || (quant != 0) != (k_scale != nullptr) ||
      (k_scale == nullptr) != (v_scale == nullptr) ||
      (splits > 1 && (partials == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the bias's type, then the caches' under q's
  auto with_bias = [&](auto tq, auto tkv, auto quant_tag) -> int {
    using TQ = typename decltype(tq)::type;
    using TKV = typename decltype(tkv)::type;
    constexpr bool kQ = decltype(quant_tag)::value;
    if (bias == nullptr || bias_dtype == kFloat32)
      return (int)launch<TQ, TKV, float, kQ>(q, k, v, positions, bias, k_scale, v_scale, out,
                                             partials, counters, B, H, L, D, splits, s);
    if (bias_dtype == kBFloat16)
      return (int)launch<TQ, TKV, __nv_bfloat16, kQ>(q, k, v, positions, bias, k_scale, v_scale,
                                                     out, partials, counters, B, H, L, D,
                                                     splits, s);
    if (bias_dtype == kFloat16)
      return (int)launch<TQ, TKV, __half, kQ>(q, k, v, positions, bias, k_scale, v_scale, out,
                                              partials, counters, B, H, L, D, splits, s);
    return (int)cudaErrorInvalidValue;
  };
  using QuantOn = std::integral_constant<bool, true>;
  using QuantOff = std::integral_constant<bool, false>;
  // the caches under q's type: int8, q's own type, or fp32
  return (int)dispatch_float(dtype, [&](auto tq) -> cudaError_t {
    if (quant) return (cudaError_t)with_bias(tq, Tag<int8_t>{}, QuantOn{});
    if (kv_dtype == dtype) return (cudaError_t)with_bias(tq, tq, QuantOff{});
    if (kv_dtype == kFloat32) return (cudaError_t)with_bias(tq, Tag<float>{}, QuantOff{});
    return cudaErrorInvalidValue;
  });
}
