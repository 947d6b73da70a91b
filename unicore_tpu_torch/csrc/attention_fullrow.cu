// Full-row attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel unicore_tpu/ops/attention_fullrow.py `_fwd_kernel`
// (:110, launched by `_fwd` :160 for `fullrow_attention` :391), forward and
// eval only: in-kernel dropout comes with the backward kernel in the
// training slice, so the wrapper refuses dropout_rate != 0.
//
// What it computes (the TPU kernel's maths, not its block structure):
//   s = (q k^T) * sm_scale + bias;  s = NEG_INF where the key is masked;
//   p = exp(s - rowmax(s)); p = 0 where masked; p *= (l > 0 ? 1/l : 0)
//   with l = rowsum(p), so a fully-masked row gives zeros;
//   p is cast to v's type, then o = p v with fp32 accumulation.
// q, k, v, o are (B, H, L, D) fp32 or bf16; bias is (1, 1|H, Lq, Lk) fp32;
// the key mask is (B, Lk) int32, nonzero = masked.  Lq, Lk are multiples
// of 128 up to 1024 and D <= 128, as the shared `supported()` gate routes.
//
// What bounds it on this card: operations.  Without tensor cores the
// 4*B*H*L^2*D flops of the serve shape (B=8, H=12, L=512, D=64: 6.44 GFLOP)
// take at least 96 us at the 67 TFLOP/s fp32 rate, while its ~63 MB of
// fp32 traffic needs 19 us; in bf16 the tensor cores would make it
// memory-bound (37.7 MB, 11 us).
//
// What the design does about it: the TPU kernel keeps a whole (Lq, Lk) fp32
// score block in 12 MB of VMEM; a Hopper block has at most 227 KB of shared
// memory.  Each block therefore takes one (b, h) and a tile of 32 query
// rows and keeps those rows' FULL score rows (<= 1024 fp32 each, <= 128 KB)
// in dynamic shared memory, which keeps the one-shot softmax with no online
// rescaling.  K, then V, stream through a 64-row shared tile; both products
// are fp32 FMA from shared memory with 16-byte loads and register
// micro-tiles (8 scores or up to 4x4 outputs per thread).  At the serve
// shape that is 16 x 12 x 8 = 1,536 blocks of 92 KB, two resident per SM on
// 132 SMs.  wgmma and TMA are left to a later PR.
#include <cstdint>

#include "common.cuh"

namespace {

using namespace unicore;

constexpr int kThreads = 256;
constexpr int kTileQ = 32;        // query rows per block
constexpr int kTileK = 64;        // key / value rows per shared tile
constexpr float kNegInf = -1e30f; // NEG_INF of ops/flash_attention.py

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

size_t smem_bytes(int Lk, int D) {
  const int Dp = (D + 3) & ~3;
  const int ld = Dp + 4, lds = Lk + 4;
  return sizeof(float) * ((size_t)(kTileQ + kTileK) * ld + (size_t)kTileQ * lds + Lk);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fullrow_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   const int* __restrict__ mask, T* __restrict__ o,
                   int H, int Lq, int Lk, int D, int bias_heads, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = (D + 3) & ~3;
  const int ld = Dp + 4;   // row stride of the Q and K/V tiles (16-byte rows)
  const int lds = Lk + 4;  // row stride of the score rows
  float* sQ = smem;                    // kTileQ x ld
  float* sKV = sQ + kTileQ * ld;       // kTileK x ld
  float* sS = sKV + kTileK * ld;       // kTileQ x lds
  int* sM = reinterpret_cast<int*>(sS + kTileQ * lds);  // Lk

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTileQ, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const T* kb = k + bh * Lk * D;
  const T* vb = v + bh * Lk * D;
  const float* biasb =
      bias == nullptr ? nullptr
                      : bias + ((size_t)(bias_heads > 1 ? h : 0) * Lq + q0) * Lk;

  load_tile(sQ, ld, q + (bh * Lq + q0) * D, kTileQ, D, Dp);
  for (int c = tid; c < Lk; c += kThreads) sM[c] = mask == nullptr ? 0 : mask[(size_t)b * Lk + c];

  // ---- scores: thread (rg, j) owns rows rg, rg+4, ..., rg+28 of column j
  {
    const int j = tid % kTileK, rg = tid / kTileK;
    for (int k0 = 0; k0 < Lk; k0 += kTileK) {
      __syncthreads();  // the previous tile's readers are done
      load_tile(sKV, ld, kb + (size_t)k0 * D, kTileK, D, Dp);
      __syncthreads();
      float acc[kTileQ / 4];
#pragma unroll
      for (int r = 0; r < kTileQ / 4; ++r) acc[r] = 0.f;
      const float4* krow = reinterpret_cast<const float4*>(sKV + j * ld);
      for (int d4 = 0; d4 < Dp / 4; ++d4) {
        const float4 kv = krow[d4];
#pragma unroll
        for (int r = 0; r < kTileQ / 4; ++r) {
          const float4 qv = reinterpret_cast<const float4*>(sQ + (rg + 4 * r) * ld)[d4];
          acc[r] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
      }
      const int key = k0 + j;
      const bool masked = sM[key] != 0;
#pragma unroll
      for (int r = 0; r < kTileQ / 4; ++r) {
        const int i = rg + 4 * r;
        float s = acc[r] * sm_scale;
        if (biasb != nullptr) s += biasb[(size_t)i * Lk + key];
        sS[i * lds + key] = masked ? kNegInf : s;
      }
    }
  }
  __syncthreads();

  // ---- one-shot softmax over each full row: one warp per row
  {
    const int warp = tid >> 5, lane = tid & 31;
    for (int i = warp; i < kTileQ; i += kThreads / 32) {
      float* row = sS + i * lds;
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
      const float inv = l > 0.f ? 1.f / l : 0.f;
      // p is cast to v's type before p v, as the TPU kernel does
      for (int c = lane; c < Lk; c += 32) row[c] = to_f(from_f<T>(row[c] * inv));
    }
  }

  // ---- o = p v: thread (rg, cg) owns rows rg, rg+nrg, ... x 4 columns
  const int ncg = Dp / 4;
  const int nrg = kThreads / ncg;  // >= 8 since Dp <= 128
  const int cg = tid % ncg, rg = tid / ncg;
  const bool active = rg < nrg;
  float4 acc[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < Lk; k0 += kTileK) {
    __syncthreads();  // softmax done / the previous V tile's readers done
    load_tile(sKV, ld, vb + (size_t)k0 * D, kTileK, D, Dp);
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
        if (i < kTileQ) {
          const float4 p = *reinterpret_cast<const float4*>(sS + i * lds + k0 + jj);
          acc[r].x += p.x * v0.x + p.y * v1.x + p.z * v2.x + p.w * v3.x;
          acc[r].y += p.x * v0.y + p.y * v1.y + p.z * v2.y + p.w * v3.y;
          acc[r].z += p.x * v0.z + p.y * v1.z + p.z * v2.z + p.w * v3.z;
          acc[r].w += p.x * v0.w + p.y * v1.w + p.z * v2.w + p.w * v3.w;
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = rg + r * nrg;
    if (i >= kTileQ) continue;
    T* orow = o + (bh * Lq + q0 + i) * D;
    const float vals[4] = {acc[r].x, acc[r].y, acc[r].z, acc[r].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 4 * cg + c;
      if (d < D) orow[d] = from_f<T>(vals[c]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* mask, void* o, int B, int H, int Lq, int Lk, int D,
                   int bias_heads, float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(Lk, D);
  cudaError_t err = cudaFuncSetAttribute(
      fullrow_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Lq / kTileQ, H, B);
  fullrow_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const int*>(mask),
      static_cast<T*>(o), H, Lq, Lk, D, bias_heads, sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int unicore_fullrow_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, const void* mask,
    void* o, int B, int H, int Lq, int Lk, int D, int bias_heads, float sm_scale,
    int dtype, void* stream) {
  if (B <= 0 || H <= 0 || B > 65535 || H > 65535 || Lq <= 0 || Lk <= 0 ||
      Lq % kTileQ != 0 || Lk % kTileK != 0 || Lk > 1024 || D <= 0 || D > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)launch<float>(q, k, v, bias, mask, o, B, H, Lq, Lk, D, bias_heads, sm_scale, s);
  if (dtype == kBFloat16)
    return (int)launch<__nv_bfloat16>(q, k, v, bias, mask, o, B, H, Lq, Lk, D, bias_heads,
                                      sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
