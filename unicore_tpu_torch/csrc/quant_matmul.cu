// W8A8 dense for Hopper (sm_90a): int8 x (M, K) times int8 w (N, K),
// accumulated exactly in int32, with the dequantization, bias and
// activation fused into the epilogue.
//
// Replaces the TPU kernel of unicore_tpu/ops/quant_matmul.py: `_qmm_kernel`
// (:147), launched by `quant_matmul_pallas` (:215, `pallas_call` :246).
//
// What it computes, per output element (m, n):
//   acc = sum_k x[m, k] * w[n, k]                       (int32, exact)
//   y   = act(float(acc) * scale[n] + bias[n])          (fp32)
// `scale` is the combined dequant factor (activation scale x the weight's
// per-output-channel scale), `bias` may be null, and `act` is one of the
// `utils.get_activation_fn` table: linear, relu, gelu (exact erf),
// gelu_fast (tanh form), tanh, silu.  The TPU kernel keeps its int32 sum in
// the resident fp32 output block across a sequential K grid and runs the
// epilogue on the last K step; here one block owns its output tile for the
// whole K loop, so the epilogue runs once per element straight from
// registers and nothing but the fp32 result reaches device memory.
//
// Layout: w keeps nn.Linear's (N, K) layout, K-major like x.  Hopper's 8-bit
// tensor-core products (mma.sync and wgmma alike) take only K-major
// operands; the JAX package's (K, N) kernel is transposed once, when the
// model is prepared for serving, never per call.
//
// What bounds it on this card: at BERT-base serving shapes (M = 8 x 512 =
// 4096 rows, K 768 or 3072, N 768 to 3072) the bytes.  The fp32 output is
// 4 bytes an element against 2 * K int8 operations; at 3.35 TB/s and
// 1979 int8 TOP/s the floors are 12.7 us (in_proj, 768 -> 2304),
// 16.7 us (fc1, 768 -> 3072) and 9.8 us of operations (fc2, 3072 -> 768).
//
// What the design does about it: a simple, right kernel first.  Blocks of
// 256 threads own a 128 x 128 output tile; eight warps of 64 x 32 each run
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 on fragments read as
// 32-bit words straight from shared memory (every fragment register is four
// consecutive K bytes of one row, for x and w alike, so no ldmatrix is
// needed).  K steps of 64 bytes are double-buffered with cp.async (16 bytes
// a thread, zero-filled past M, N and K), and shared rows are padded to 80
// bytes so the eight rows a fragment read touches fall on distinct banks.
// Any M; K a multiple of 32 (16-byte copies never straddle the end of a
// row) and N a multiple of 8 (whole n8 fragments), which every BERT
// geometry meets.  TMA, wgmma and a persistent schedule are later work.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kThreads = 256;       // 8 warps: 2 down M x 4 across N
constexpr int kPitch = kBK + 16;    // shared bytes per tile row
constexpr int kChunks = kBK / 16;   // 16-byte copies per tile row

// activation codes (ops/quant_matmul.py `_ACTIVATIONS`)
constexpr int kLinear = 0, kRelu = 1, kGelu = 2, kGeluTanh = 3, kTanh = 4, kSilu = 5;

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(v, 0.f);
    case kGelu:
      return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
    case kGeluTanh: {
      const float inner = 0.79788456080286536f * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.f + tanhf(inner));
    }
    case kTanh:
      return tanhf(v);
    case kSilu:
      return v / (1.f + expf(-v));
    default:
      return v;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// one K step's tiles of x (rows m0..) and w (rows n0..) into shared memory
__device__ __forceinline__ void load_tiles(int8_t* sa, int8_t* sb, const int8_t* x,
                                           const int8_t* w, long long m0, int n0, int k0,
                                           long long M, int N, int K) {
  for (int c = threadIdx.x; c < kBM * kChunks; c += kThreads) {
    const int r = c / kChunks, kc = (c % kChunks) * 16;
    const bool ok = m0 + r < M && k0 + kc < K;
    cp_async16(sa + r * kPitch + kc, ok ? x + (m0 + r) * K + k0 + kc : x, ok ? 16 : 0);
  }
  for (int c = threadIdx.x; c < kBN * kChunks; c += kThreads) {
    const int r = c / kChunks, kc = (c % kChunks) * 16;
    const bool ok = n0 + r < N && k0 + kc < K;
    cp_async16(sb + r * kPitch + kc, ok ? w + (long long)(n0 + r) * K + k0 + kc : w,
               ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    float* __restrict__ y, long long M, int N, int K, int act) {
  __shared__ __align__(16) int8_t sa[2][kBM * kPitch];
  __shared__ __align__(16) int8_t sb[2][kBN * kPitch];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t = lane & 3;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (K + kBK - 1) / kBK;
  load_tiles(sa[0], sb[0], x, w, m0, n0, 0, M, N, K);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles)
      load_tiles(sa[cur ^ 1], sb[cur ^ 1], x, w, m0, n0, (kt + 1) * kBK, M, N, K);
    cp_async_commit();  // possibly empty: keeps "all but the newest" = tile kt
    cp_async_wait_one();
    __syncthreads();
    const int8_t* A = sa[cur];
    const int8_t* B = sb[cur];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* r0 = A + (wm + i * 16 + g) * kPitch + kk + t * 4;
        const int8_t* r8 = r0 + 8 * kPitch;
        af[i][0] = ld32(r0);
        af[i][1] = ld32(r8);
        af[i][2] = ld32(r0 + 16);
        af[i][3] = ld32(r8 + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* c0 = B + (wn + j * 8 + g) * kPitch + kk + t * 4;
        bf[j][0] = ld32(c0);
        bf[j][1] = ld32(c0 + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();  // the next step's copy overwrites this stage
  }

  // epilogue: c0, c1 at row g, columns 2t, 2t + 1; c2, c3 at row g + 8
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + j * 8 + t * 2;
    if (col >= N) continue;  // N % 8 == 0: col + 1 < N whenever col < N
    const float s0 = scale[col], s1 = scale[col + 1];
    const float b0 = bias != nullptr ? bias[col] : 0.f;
    const float b1 = bias != nullptr ? bias[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = m0 + wm + i * 16 + g + h * 8;
        if (row >= M) continue;
        // __fmul_rn: the product rounds before the bias is added, as in the
        // plain version (no fused multiply-add)
        float v0 = __fmul_rn((float)acc[i][j][2 * h], s0);
        float v1 = __fmul_rn((float)acc[i][j][2 * h + 1], s1);
        if (bias != nullptr) {
          v0 += b0;
          v1 += b1;
        }
        *reinterpret_cast<float2*>(y + row * N + col) =
            make_float2(activate(v0, act), activate(v1, act));
      }
    }
  }
}

}  // namespace

// x: (M, K) int8, w: (N, K) int8, both row-major and 16-byte aligned;
// scale: (N,) fp32; bias: (N,) fp32 or null; y: (M, N) fp32.
extern "C" int unicore_quant_matmul(const void* x, const void* w, const void* scale,
                                    const void* bias, void* y, long long M, int N, int K,
                                    int act, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0 || N % 8 != 0 || act < kLinear ||
      act > kSilu || (M + kBM - 1) / kBM > 0x7fffffffLL || (N + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((N + kBN - 1) / kBN));
  quant_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(y), M, N, K, act);
  return (int)cudaGetLastError();
}
