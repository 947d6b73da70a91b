// The fused optimizer pass of --fused-adam: the global L2 norm of the flat
// gradient (K-a) and one Adam(W) pass per flat buffer with the copy-back
// into the parameters' storage (K-b).
//
// Replaces the jnp functions of unicore_tpu/optim/multi_tensor.py,
// `multi_tensor_l2norm` (:232), `fused_adam_update` (:259) and
// `fused_copy_back` (:328).  The JAX package has no Pallas kernel there:
// XLA fuses each of them into one elementwise pass per flat buffer.  Eager
// PyTorch does not, so these two kernels keep that one-pass contract.
//
// Both are bound by bytes.  K-a reads 4 B an element (110M elements of
// BERT-base: 0.13 ms at 3.35 TB/s).  K-b reads g, m, v and the fp32 master
// and writes m, v, the master and, for a bf16/fp16 parameter, the rounded
// parameter: 28 B an element in fp32, 30 B with a bf16 parameter (~1 ms).
// The design is the simple one: one block per fixed span (K-a) or per chunk
// of the segment table (K-b), 16-byte loads of four elements.
//
// K-a runs in two stages and has no atomics: stage 1 writes one fp32
// partial sum of squares per span of kNormSpan elements (block b covers
// elements [b * kNormSpan, (b + 1) * kNormSpan), a fixed tree within the
// block); stage 2 sums every buffer's partials in index order in one block
// and writes the norm.  The same inputs give the same bits every run.  Each
// element is divided by the device scalar `denom` (the sample size times
// the loss scale) inside the reduction, so the gradient accumulator is not
// rewritten before the norm.  Because a partial is a fixed span of the
// buffer and an absent element adds an exact zero, the partials of a
// buffer cut at multiples of kNormSpan (one data-parallel rank's segment
// under --zero-stage 2, zero-padded at the end) are the whole buffer's
// partials: stage 1 alone (the sum-of-squares mode, `out` null) on each
// segment, the partials gathered in rank order, then stage 2 alone
// (`unicore_l2norm_final`) give the whole buffer's norm bit for bit.
//
// K-b reads the norm and `denom` from device memory: no host round trip
// between the two.  It runs on a whole group or on one rank's segment of
// it (--zero-stage >= 1): `offset` is the segment's first element in the
// group, which the chunk table is rebased on and the SR counter adds back,
// so a segment rounds as the whole buffer does.  A non-finite norm (an
// overflow) makes it return at once, leaving every buffer as it was: the
// trainer skips the update.  The arithmetic is the JAX op order with every
// operation rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn): nvcc may not contract
// any pair into an FMA, so the kernel and `fused_adam_plain` (torch ops,
// each rounded) agree bit for bit.  Decoupled decay applies per chunk
// from the segment table (each chunk lies in one parameter), not from a
// byte mask.  Under --bf16-sr the copy-back adds 16 bits of Philox4x32-10
// noise keyed on (k0, k1) = the run's (seed, update) key and counted from
// (element / 4, buffer id); `sr_noise_plain` draws the same bits in torch.
#include "common.cuh"

namespace unicore {
namespace {

constexpr int kNormThreads = 256;
// elements of one stage-1 partial (a multiple of 4 * kNormThreads *
// kNormBatch), and the float4 loads a thread keeps in flight, which do not
// change the bits.  8,192 and 8 (48 registers a thread) were the fastest of
// spans 8,192-131,072 with 4, 8 or 16 loads at 110M elements on an H100,
// level with a grid-stride grid; tools/l2norm_ab.py builds others with
// -DUNICORE_NORM_SPAN and -DUNICORE_NORM_BATCH.
#ifndef UNICORE_NORM_SPAN
#define UNICORE_NORM_SPAN 8192
#endif
#ifndef UNICORE_NORM_BATCH
#define UNICORE_NORM_BATCH 8
#endif
constexpr long long kNormSpan = UNICORE_NORM_SPAN;
constexpr int kNormVecs = (int)(kNormSpan / 4 / kNormThreads);  // float4 loads a thread
constexpr int kNormBatch = UNICORE_NORM_BATCH;
static_assert(kNormVecs % kNormBatch == 0, "the span must be a whole number of batches");
constexpr int kAdamThreads = 256;

// The block's sum in a fixed order: each warp's butterfly, then warp 0
// over the warps' sums.  Valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* smem) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = threadIdx.x < (blockDim.x >> 5) ? smem[threadIdx.x] : 0.f;
  if (warp == 0) v = warp_sum(v);
  return v;
}

__device__ __forceinline__ float sq_scaled(float x, float d) {
  const float y = __fdiv_rn(x, d);
  return __fmul_rn(y, y);
}

__device__ __forceinline__ float add_sq4(float acc, const float4 q, float d) {
  acc = __fadd_rn(acc, sq_scaled(q.x, d));
  acc = __fadd_rn(acc, sq_scaled(q.y, d));
  acc = __fadd_rn(acc, sq_scaled(q.z, d));
  return __fadd_rn(acc, sq_scaled(q.w, d));
}

// stage 1: partial[b] = sum over elements [b * kNormSpan, (b + 1) *
// kNormSpan) of x of (x / d)^2.  Thread t adds the float4 groups t, t +
// kNormThreads, ... of its span in order, each group's four elements in
// order; an element past n adds nothing (a zero would add an exact zero).
__global__ void __launch_bounds__(kNormThreads)
    l2norm_partial_kernel(const float* __restrict__ x, long long n,
                          const float* __restrict__ denom, float* __restrict__ partial) {
  __shared__ float smem[32];
  const float d = denom != nullptr ? *denom : 1.f;
  const long long base = (long long)blockIdx.x * kNormSpan;
  float acc = 0.f;
  if (base + kNormSpan <= n) {
    // batches of kNormBatch loads in flight, added in order
    const float4* x4 = reinterpret_cast<const float4*>(x + base) + threadIdx.x;
    for (int h = 0; h < kNormVecs; h += kNormBatch) {
      float4 q[kNormBatch];
#pragma unroll
      for (int i = 0; i < kNormBatch; ++i) q[i] = x4[(h + i) * kNormThreads];
#pragma unroll
      for (int i = 0; i < kNormBatch; ++i) acc = add_sq4(acc, q[i], d);
    }
  } else {
    for (int i = 0; i < kNormVecs; ++i) {
      const long long e = base + 4LL * (i * kNormThreads + threadIdx.x);
      if (e >= n) break;
      if (e + 4 <= n) {
        acc = add_sq4(acc, *reinterpret_cast<const float4*>(x + e), d);
      } else {
        for (long long k = e; k < n; ++k) acc = __fadd_rn(acc, sq_scaled(x[k], d));
      }
    }
  }
  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

// stage 2: out = sqrt(sum of the n partials), in index order per thread
__global__ void __launch_bounds__(1024)
    l2norm_final_kernel(const float* __restrict__ partial, int n, float* __restrict__ out) {
  __shared__ float smem[32];
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc = __fadd_rn(acc, partial[i]);
  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) out[0] = __fsqrt_rn(acc);
}

long long norm_blocks(long long n) {
  const long long b = (n + kNormSpan - 1) / kNormSpan;
  return b < 1 ? 1 : b;
}

struct AdamArgs {
  float beta1, beta2, omb1, omb2;  // omb = 1 - beta, rounded once on the host
  float eps, step_size;
  float decay_factor;  // 1 - step_size * weight_decay
  int decay_on;        // weight decay != 0
  float max_norm, clip_eps;
  int sr;              // stochastic rounding of a bf16 parameter
  uint32_t k0, k1, buffer_id;
  long long offset4;   // the segment's first element in the group, over 4
};

struct Elem {
  float p, m, v;
};

__device__ __forceinline__ void adam_elem(Elem& e, float g, bool decay, float d, float coef,
                                          const AdamArgs& a) {
  g = __fmul_rn(__fdiv_rn(g, d), coef);
  if (decay) e.p = __fmul_rn(e.p, a.decay_factor);
  e.m = __fadd_rn(__fmul_rn(e.m, a.beta1), __fmul_rn(g, a.omb1));
  e.v = __fadd_rn(__fmul_rn(e.v, a.beta2), __fmul_rn(__fmul_rn(g, g), a.omb2));
  const float u = __fdiv_rn(e.m, __fadd_rn(__fsqrt_rn(e.v), a.eps));
  e.p = __fsub_rn(e.p, __fmul_rn(u, a.step_size));
}

// the parameter's storage from the fp32 master: nearest-even, or under SR
// the top half of (bits + 16 noise bits), as ops/rounding.py
template <typename TP> __device__ __forceinline__ TP round_param(float x, uint32_t word, int sr);
template <> __device__ __forceinline__ float round_param<float>(float x, uint32_t, int) {
  return x;
}
template <> __device__ __forceinline__ __half round_param<__half>(float x, uint32_t, int) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 round_param<__nv_bfloat16>(float x, uint32_t word,
                                                                    int sr) {
  if (!sr) return __float2bfloat16(x);
  __nv_bfloat16_raw r;
  r.x = (unsigned short)((__float_as_uint(x) + (word >> 16)) >> 16);
  return __nv_bfloat16(r);
}

// the noise of element e of the segment: counted from its element in the
// whole group, (e + offset) / 4
__device__ __forceinline__ uint4 sr_words(const AdamArgs& a, long long e4) {
  e4 += a.offset4;
  return philox4x32_10(make_uint4((uint32_t)e4, (uint32_t)(e4 >> 32), a.buffer_id, 0u), a.k0,
                       a.k1);
}

__device__ __forceinline__ uint32_t pick(const uint4& w, int i) {
  return i == 0 ? w.x : (i == 1 ? w.y : (i == 2 ? w.z : w.w));
}

// One block per chunk: chunks[2 c] = its first element (a multiple of 4),
// chunks[2 c + 1] = its length * 2 + its decay flag.  `param` is null when
// the master is the parameters' own storage (an fp32 run).
template <typename TP>
__global__ void __launch_bounds__(kAdamThreads)
    fused_adam_kernel(float* __restrict__ master, TP* __restrict__ param, float* __restrict__ m,
                      float* __restrict__ v, const float* __restrict__ g,
                      const long long* __restrict__ chunks, const float* __restrict__ denom,
                      const float* __restrict__ gnorm, AdamArgs a) {
  float coef = 1.f;
  if (gnorm != nullptr) {
    const float gn = *gnorm;
    if (!isfinite(gn)) return;  // overflow: the update is skipped
    if (a.max_norm > 0.f) coef = fminf(__fdiv_rn(a.max_norm, __fadd_rn(gn, a.clip_eps)), 1.f);
  }
  const float d = denom != nullptr ? *denom : 1.f;
  const long long start = chunks[2 * blockIdx.x];
  const long long meta = chunks[2 * blockIdx.x + 1];
  const long long len = meta >> 1;
  const bool decay = (meta & 1) && a.decay_on;
  const long long len4 = len >> 2;
  for (long long j = threadIdx.x; j < len4; j += blockDim.x) {
    const long long e = start + 4 * j;
    const float4 g4 = *reinterpret_cast<const float4*>(g + e);
    float4 p4 = *reinterpret_cast<float4*>(master + e);
    float4 m4 = *reinterpret_cast<float4*>(m + e);
    float4 v4 = *reinterpret_cast<float4*>(v + e);
    Elem x{p4.x, m4.x, v4.x}, y{p4.y, m4.y, v4.y}, z{p4.z, m4.z, v4.z}, w{p4.w, m4.w, v4.w};
    adam_elem(x, g4.x, decay, d, coef, a);
    adam_elem(y, g4.y, decay, d, coef, a);
    adam_elem(z, g4.z, decay, d, coef, a);
    adam_elem(w, g4.w, decay, d, coef, a);
    *reinterpret_cast<float4*>(master + e) = make_float4(x.p, y.p, z.p, w.p);
    *reinterpret_cast<float4*>(m + e) = make_float4(x.m, y.m, z.m, w.m);
    *reinterpret_cast<float4*>(v + e) = make_float4(x.v, y.v, z.v, w.v);
    if (param != nullptr) {
      uint4 words = make_uint4(0u, 0u, 0u, 0u);
      if (a.sr) words = sr_words(a, e >> 2);
      param[e] = round_param<TP>(x.p, words.x, a.sr);
      param[e + 1] = round_param<TP>(y.p, words.y, a.sr);
      param[e + 2] = round_param<TP>(z.p, words.z, a.sr);
      param[e + 3] = round_param<TP>(w.p, words.w, a.sr);
    }
  }
  for (long long e = start + 4 * len4 + threadIdx.x; e < start + len; e += blockDim.x) {
    Elem x{master[e], m[e], v[e]};
    adam_elem(x, g[e], decay, d, coef, a);
    master[e] = x.p;
    m[e] = x.m;
    v[e] = x.v;
    if (param != nullptr) {
      const uint32_t word = a.sr ? pick(sr_words(a, e >> 2), (int)(e & 3)) : 0u;
      param[e] = round_param<TP>(x.p, word, a.sr);
    }
  }
}

}  // namespace
}  // namespace unicore

using namespace unicore;

// The stage-1 block count (fp32 partials) of a buffer of n elements, and
// the elements of one partial.
extern "C" long long unicore_l2norm_blocks(long long n) { return norm_blocks(n); }
extern "C" long long unicore_l2norm_span() { return kNormSpan; }

// The global L2 norm of `nbuf` fp32 buffers (device pointers in `bufs`,
// lengths in `sizes`, both host arrays), each element divided by the
// device scalar `denom` (null: by 1): stage 1 per buffer into `partial`
// (sum of unicore_l2norm_blocks floats), then stage 2 into `out` (one float).
extern "C" int unicore_multi_tensor_l2norm(const void* const* bufs, const long long* sizes,
                                          int nbuf, const void* denom, void* partial, void* out,
                                          void* stream) {
  if (nbuf <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  long long total = 0;
  for (int i = 0; i < nbuf; ++i) {
    if (sizes[i] < 0) return (int)cudaErrorInvalidValue;
    const long long blocks = norm_blocks(sizes[i]);
    l2norm_partial_kernel<<<(unsigned)blocks, kNormThreads, 0, s>>>(
        static_cast<const float*>(bufs[i]), sizes[i], static_cast<const float*>(denom),
        part + total);
    total += blocks;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (out == nullptr) return (int)cudaSuccess;
  if (total > (1LL << 30)) return (int)cudaErrorInvalidValue;
  l2norm_final_kernel<<<1, 1024, 0, s>>>(part, (int)total, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// Stage 2 alone: `out` = sqrt of the sum of `n` fp32 partials (stage 1's,
// gathered from the ranks' segments in rank order).
extern "C" int unicore_l2norm_final(const void* partial, long long n, void* out, void* stream) {
  if (n <= 0 || n > (1LL << 30)) return (int)cudaErrorInvalidValue;
  l2norm_final_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), (int)n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// One Adam(W) pass over a flat group: master, m, v, g fp32; param null (the
// master is the parameters) or the group's parameters in `param_dtype`
// (0 fp32, 1 bf16, 4 fp16); chunks: (n_chunks, 2) int64 on the device;
// denom, gnorm: device scalars or null; offset: the segment's first element
// in the group (a multiple of 4; 0 for a whole group), which SR counts
// from.
extern "C" int unicore_fused_adam(void* master, void* param, int param_dtype, void* m, void* v,
                                 const void* g, const void* chunks, int n_chunks,
                                 const void* denom, const void* gnorm, float beta1, float beta2,
                                 float omb1, float omb2, float eps, float step_size,
                                 float decay_factor, int decay_on, float max_norm,
                                 float clip_eps, int sr, unsigned k0, unsigned k1,
                                 unsigned buffer_id, long long offset, void* stream) {
  if (n_chunks <= 0 || offset < 0 || (offset & 3)) return (int)cudaErrorInvalidValue;
  if (sr && (param == nullptr || param_dtype != kBFloat16)) return (int)cudaErrorInvalidValue;
  const AdamArgs a{beta1,    beta2,    omb1, omb2, eps, step_size, decay_factor,
                   decay_on, max_norm, clip_eps, sr, k0, k1, buffer_id, offset >> 2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ch = static_cast<const long long*>(chunks);
  const auto* dn = static_cast<const float*>(denom);
  const auto* gn = static_cast<const float*>(gnorm);
  auto* ms = static_cast<float*>(master);
  auto* mm = static_cast<float*>(m);
  auto* vv = static_cast<float*>(v);
  const auto* gg = static_cast<const float*>(g);
  if (param == nullptr) {
    fused_adam_kernel<float><<<n_chunks, kAdamThreads, 0, s>>>(ms, nullptr, mm, vv, gg, ch, dn,
                                                               gn, a);
    return (int)cudaGetLastError();
  }
  return (int)dispatch_float(param_dtype, [&](auto tag) {
    using TP = typename decltype(tag)::type;
    fused_adam_kernel<TP><<<n_chunks, kAdamThreads, 0, s>>>(ms, static_cast<TP*>(param), mm, vv,
                                                            gg, ch, dn, gn, a);
    return cudaGetLastError();
  });
}
