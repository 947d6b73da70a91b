// LayerNorm / RMSNorm forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of unicore_tpu/ops/fused_norm.py, the halves of
// the `jax.custom_vjp` `_fused_norm` (:231) behind `fused_layer_norm` /
// `fused_rms_norm`:
//   `_ln_fwd_kernel`  (:56, launched by `_ln_fwd` :81), with its mean/rstd
//                     outputs for training but without its int8 `scale_ref`
//                     variant (that waits for quantized serving);
//   `_ln_dx_kernel`   (:140, launched by `_ln_bwd` :176);
//   `_ln_dwdb_kernel` (:157, launched by `_ln_bwd` :176).
//
// What they compute, per row of x (N, D), statistics in fp32 whatever the
// input type:
//   forward  two-pass, as the module's own jnp path does: mean, then
//            var = mean((x - mean)^2) (RMS: mean = 0, var = mean(x^2));
//            rstd = rsqrt(var + eps); y = (x - mean) * rstd * w (+ b), cast
//            back to the input type; mean and rstd stored as fp32 (N,) when
//            asked for (training), not at all otherwise (serving);
//   dx       x^ = (x - mean) * rstd, g = w * dy,
//            dx = (g - mean(g) - x^ * mean(g * x^)) * rstd (RMS: no mean(g));
//   dw, db   dw = sum over rows of dy * x^, db = sum over rows of dy, fp32.
// w and b are fp32.
//
// What bounds them on this card: bytes.  The forward reads x and writes y
// (2 * N * D * itemsize), dx reads x and dy and writes dx (3 * N * D *
// itemsize), dw/db reads x and dy (2 * N * D * itemsize); each does ~10
// flops per element, far below the H100's 295 flops-per-byte ridge.  At the
// training shape (N = 4096, D = 768, fp32) the floors are 7.5, 11.3 and
// 7.5 us at 3.35 TB/s.
//
// What the design does about it: forward and dx take one warp per row, any
// row count (the TPU kernels' pad-to-8 rows is the TPU's sublane tiling and
// is not carried over), neighbouring lanes on neighbouring addresses so
// every pass is coalesced, and no shared memory or block-wide barrier: a
// row's later passes re-read it through L1/L2 (a 768-wide fp32 row is 3 KB).
// dw/db is a column reduction over all N rows, which the TPU kernel carries
// across its sequential grid in the resident output block; Hopper blocks run
// in no order, so it runs in two stages: blocks of 32 columns x 128 rows
// write fp32 partial sums, then one thread per column adds its partials in
// chunk order.  No atomics, so dw and db are the same bits on every run.
// Vectorised 16-byte loads and register-resident rows are left to a later PR.
#include <cstdint>

#include "common.cuh"

namespace {

using namespace unicore;

constexpr int kWarpsPerBlock = 4;
constexpr int kColTile = 32;        // dw/db stage 1: columns per block
constexpr int kRowGroups = 8;       // dw/db stage 1: threads down a column
constexpr int kRowsPerChunk = 128;  // dw/db stage 1: rows per block

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, T* __restrict__ y,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out,
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
  if (mean_out != nullptr && lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_norm_dx_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                     const T* __restrict__ dy, T* __restrict__ dx, long long N, int D,
                     int rms) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;
  const T* xr = x + row * D;
  const T* gr = dy + row * D;
  T* dr = dx + row * D;
  const float mean = mean_in[row], rstd = rstd_in[row];
  const float inv_d = 1.f / (float)D;

  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float g = to_f(gr[c]) * w[c];
    s1 += g;
    s2 += g * (to_f(xr[c]) - mean) * rstd;
  }
  const float c1 = rms ? 0.f : warp_sum(s1) * inv_d;
  const float c2 = warp_sum(s2) * inv_d;
  for (int c = lane; c < D; c += 32) {
    const float g = to_f(gr[c]) * w[c];
    const float xhat = (to_f(xr[c]) - mean) * rstd;
    dr[c] = from_f<T>((g - c1 - xhat * c2) * rstd);
  }
}

// stage 1: partial[chunk][col] over rows [chunk * 128, chunk * 128 + 128)
template <typename T>
__global__ void __launch_bounds__(kColTile * kRowGroups)
fused_norm_dwdb_partial_kernel(const T* __restrict__ x, const float* __restrict__ mean_in,
                               const float* __restrict__ rstd_in, const T* __restrict__ dy,
                               float* __restrict__ part_w, float* __restrict__ part_b,
                               long long N, int D) {
  __shared__ float sw[kRowGroups][kColTile + 1];
  __shared__ float sb[kRowGroups][kColTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kColTile + tx;
  const long long r0 = (long long)blockIdx.y * kRowsPerChunk;
  const long long r1 = min(N, r0 + kRowsPerChunk);
  float aw = 0.f, ab = 0.f;
  if (col < D) {
    for (long long r = r0 + ty; r < r1; r += kRowGroups) {
      const float g = to_f(dy[r * D + col]);
      aw += g * (to_f(x[r * D + col]) - mean_in[r]) * rstd_in[r];
      ab += g;
    }
  }
  sw[ty][tx] = aw;
  sb[ty][tx] = ab;
  __syncthreads();
  if (ty == 0 && col < D) {
    for (int r = 1; r < kRowGroups; ++r) {
      aw += sw[r][tx];
      ab += sb[r][tx];
    }
    part_w[(size_t)blockIdx.y * D + col] = aw;
    if (part_b != nullptr) part_b[(size_t)blockIdx.y * D + col] = ab;
  }
}

// stage 2: dw[col] (and db[col]) = the column's partials added in chunk order
__global__ void __launch_bounds__(256)
fused_norm_dwdb_finish_kernel(const float* __restrict__ part_w,
                              const float* __restrict__ part_b, float* __restrict__ dw,
                              float* __restrict__ db, int chunks, int D) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= D) return;
  float aw = 0.f, ab = 0.f;
  for (int c = 0; c < chunks; ++c) {
    aw += part_w[(size_t)c * D + col];
    if (db != nullptr) ab += part_b[(size_t)c * D + col];
  }
  dw[col] = aw;
  if (db != nullptr) db[col] = ab;
}

long long row_blocks(long long N) { return (N + kWarpsPerBlock - 1) / kWarpsPerBlock; }

bool bad_rows(long long N, int D) {
  return N <= 0 || D <= 0 || row_blocks(N) > 0x7fffffffLL;
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, const void* b, void* y, void* mean,
                       void* rstd, long long N, int D, float eps, int rms,
                       cudaStream_t stream) {
  fused_norm_fwd_kernel<T><<<(unsigned)row_blocks(N), kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), N, D, eps, rms);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dx(const void* x, const void* w, const void* mean, const void* rstd,
                      const void* dy, void* dx, long long N, int D, int rms,
                      cudaStream_t stream) {
  fused_norm_dx_kernel<T><<<(unsigned)row_blocks(N), kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const T*>(dy), static_cast<T*>(dx), N, D, rms);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dwdb(const void* x, const void* mean, const void* rstd, const void* dy,
                        void* partial, void* dw, void* db, long long N, int D,
                        cudaStream_t stream) {
  const long long chunks = (N + kRowsPerChunk - 1) / kRowsPerChunk;
  float* part_w = static_cast<float*>(partial);
  float* part_b = db == nullptr ? nullptr : part_w + chunks * D;
  const dim3 grid((D + kColTile - 1) / kColTile, (unsigned)chunks);
  fused_norm_dwdb_partial_kernel<T><<<grid, dim3(kColTile, kRowGroups), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const T*>(dy), part_w, part_b, N, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_norm_dwdb_finish_kernel<<<(D + 255) / 256, 256, 0, stream>>>(
      part_w, part_b, static_cast<float*>(dw), static_cast<float*>(db), (int)chunks, D);
  return cudaGetLastError();
}

}  // namespace

// mean and rstd: fp32 (N,) outputs, or both null (no statistics written)
extern "C" int unicore_fused_norm_fwd(const void* x, const void* w, const void* b,
                                      void* y, void* mean, void* rstd, long long N, int D,
                                      float eps, int rms, int dtype, void* stream) {
  if (bad_rows(N, D) || (mean == nullptr) != (rstd == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)launch_fwd<float>(x, w, b, y, mean, rstd, N, D, eps, rms, s);
  if (dtype == kBFloat16)
    return (int)launch_fwd<__nv_bfloat16>(x, w, b, y, mean, rstd, N, D, eps, rms, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int unicore_fused_norm_dx(const void* x, const void* w, const void* mean,
                                     const void* rstd, const void* dy, void* dx,
                                     long long N, int D, int rms, int dtype, void* stream) {
  if (bad_rows(N, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return (int)launch_dx<float>(x, w, mean, rstd, dy, dx, N, D, rms, s);
  if (dtype == kBFloat16)
    return (int)launch_dx<__nv_bfloat16>(x, w, mean, rstd, dy, dx, N, D, rms, s);
  return (int)cudaErrorInvalidValue;
}

// fp32 scratch floats the dw/db launch needs for N rows and D columns
extern "C" long long unicore_fused_norm_dwdb_scratch(long long N, int D) {
  return 2 * ((N + kRowsPerChunk - 1) / kRowsPerChunk) * (long long)D;
}

// dw, db: fp32 (D,); db may be null (RMSNorm).  `partial` holds
// unicore_fused_norm_dwdb_scratch(N, D) floats.
extern "C" int unicore_fused_norm_dwdb(const void* x, const void* mean, const void* rstd,
                                       const void* dy, void* partial, void* dw, void* db,
                                       long long N, int D, int dtype, void* stream) {
  if (N <= 0 || D <= 0 || (N + kRowsPerChunk - 1) / kRowsPerChunk > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)launch_dwdb<float>(x, mean, rstd, dy, partial, dw, db, N, D, s);
  if (dtype == kBFloat16)
    return (int)launch_dwdb<__nv_bfloat16>(x, mean, rstd, dy, partial, dw, db, N, D, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* unicore_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
