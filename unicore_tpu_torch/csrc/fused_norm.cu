// LayerNorm / RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel unicore_tpu/ops/fused_norm.py `_ln_fwd_kernel`
// (:56, launched by `_ln_fwd` :81 for `fused_layer_norm` / `fused_rms_norm`),
// without its int8 `scale_ref` variant (that waits for quantized serving).
//
// What it computes, per row of x (N, D): fp32 statistics whatever the input
// type, two-pass as the module's own jnp path does (mean, then
// var = mean((x - mean)^2); RMS: mean = 0, var = mean(x^2)),
// y = (x - mean) * rsqrt(var + eps) * w (+ b), cast back to the input type.
// w and b are fp32.
//
// What bounds it on this card: bytes.  It reads x once and writes y once
// (2 * N * D * itemsize) and does ~8 flops per element, far below the
// H100's 295 flops-per-byte ridge; at the serve shape (N = 4096, D = 768,
// fp32) the floor is 25.2 MB / 3.35 TB/s = 7.5 us.
//
// What the design does about it: one warp per row, any row count (the TPU
// kernel's pad-to-8 rows is the TPU's sublane tiling and is not carried
// over), neighbouring lanes on neighbouring addresses so every pass is
// coalesced, and no shared memory or block-wide barrier: the row's second
// and third passes re-read it through L1/L2 (a 768-wide fp32 row is 3 KB;
// the whole serve-shape input fits the 50 MB L2).  Vectorised 16-byte loads
// and register-resident rows are left to a later PR.
#include <cstdint>

#include "common.cuh"

namespace {

using namespace unicore;

constexpr int kWarpsPerBlock = 4;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, T* __restrict__ y,
                      long long N, int D, float eps, int rms) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;
  const T* xr = x + row * D;
  T* yr = y + row * D;
  const float inv_d = 1.f / (float)D;

  float mean = 0.f;
  if (!rms) {
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += to_f(xr[c]);
    mean = warp_sum(s) * inv_d;
  }
  float sq = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = to_f(xr[c]) - mean;
    sq += d * d;
  }
  const float var = warp_sum(sq) * inv_d;
  const float rstd = rsqrtf(var + eps);
  for (int c = lane; c < D; c += 32) {
    float v = (to_f(xr[c]) - mean) * rstd * w[c];
    if (b != nullptr) v += b[c];
    yr[c] = from_f<T>(v);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   long long N, int D, float eps, int rms, cudaStream_t stream) {
  const long long blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_norm_fwd_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), N, D, eps, rms);
  return cudaGetLastError();
}

}  // namespace

extern "C" int unicore_fused_norm_fwd(const void* x, const void* w, const void* b,
                                      void* y, long long N, int D, float eps,
                                      int rms, int dtype, void* stream) {
  if (N <= 0 || D <= 0 || N > (long long)0x7fffffff * kWarpsPerBlock)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return (int)launch<float>(x, w, b, y, N, D, eps, rms, s);
  if (dtype == kBFloat16) return (int)launch<__nv_bfloat16>(x, w, b, y, N, D, eps, rms, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* unicore_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
