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
// gelu_fast (tanh form), tanh, silu.  The product rounds before the bias is
// added (`__fmul_rn`, no fused multiply-add), as in the plain version.  The
// TPU kernel keeps its int32 sum in the resident output block across a
// sequential K grid and runs the epilogue on the last K step; here a
// warpgroup keeps its sum in registers for the whole K loop, so the
// epilogue runs once per element and nothing but the fp32 result reaches
// device memory.
//
// Layout: w keeps nn.Linear's (N, K) layout, K-major like x: Hopper's 8-bit
// tensor-core products take only K-major operands; the JAX package's (K, N)
// kernel is transposed once, when the model is prepared for serving.
//
// What bounds it on this card: at BERT-base serving shapes (M = 8 x 512 =
// 4096 rows) the bytes at in_proj (768 -> 2304, 12.7 us: the fp32 output is
// 37.7 of 42.6 MB), out_proj and the LM head (768 -> 768, ~4.9 us) and fc1
// (768 -> 3072, 16.7 us), and the int8 operations at fc2 (3072 -> 768,
// 9.8 us at 1979 TOP/s).
//
// What the design does about it:
// * products on `wgmma.mma_async.m64nNk32.s32.s8.s8`, the only route to the
//   card's full int8 rate, both operands K-major in shared memory with
//   128-byte swizzle (a stage holds 128 bytes of K: four k32 products);
// * operands loaded by TMA (`cp.async.bulk.tensor.2d`) into a ring of 4-6
//   stages completed through mbarriers; out-of-bounds rows and K are
//   zero-filled by the copy, so any M, and K a multiple of 32, need no
//   masking before the epilogue;
// * warp roles: one producer warpgroup (one thread issues every copy, the
//   others leave; its registers go to the consumers through `setmaxnreg`),
//   two consumer warpgroups of 64 rows each of a 128-row tile;
// * persistent: at most one block an SM walks the output tiles, so one
//   tile's epilogue (scale, bias, activation, fp32 stores) runs while the
//   producer already loads the next tile's stages;
// * the fp32 output is most of the bytes at in_proj and fc1: the epilogue
//   writes each warpgroup's results, 64 x 32 at a time, into one of two
//   staging boxes in shared memory and a TMA store writes the box out
//   (whole lines, ragged edges skipped by the copy) while the warps go on
//   to the next box and the next tile's products;
// * the tile's width is 128, 192 or 256 columns, chosen by the wrapper
//   (`choose_tile_n` in ops/quant_matmul.py, a function of the shape) to
//   keep the last wave of tiles full: at N = 768, 128 x 192 tiles make 128
//   tiles for 132 SMs where 128 x 128 made 192.
// The three tensor maps are encoded on each call (host work of the wrapper;
// caching the weight's measured no difference).
// Any M below 2^31; K a multiple of 32 and N a multiple of 8 (TMA wants
// 16-byte row strides; the epilogue handles whole column pairs).
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace unicore;

constexpr int kBM = 128;            // tile rows: two consumer warpgroups of 64
constexpr int kBK = 128;            // K bytes a stage: one 128-byte swizzle row
constexpr int kThreads = 384;       // producer warpgroup + two consumers
constexpr int kMaxStages = 6;
constexpr int kStageBudget = 192 * 1024;  // shared bytes of the ring
// the epilogue's staging: two buffers a consumer warpgroup, each a TMA
// store's box of 64 rows x 32 fp32 columns (128 bytes, 128-byte swizzle)
constexpr int kEpiCols = 32;
constexpr int kEpiBox = 64 * kEpiCols;  // floats
constexpr int kEpiBytes = 2 * 2 * kEpiBox * 4;

__host__ __device__ constexpr int stage_bytes(int bn) { return (kBM + bn) * kBK; }

__host__ __device__ constexpr int stages_for(int bn) {
  const int s = kStageBudget / stage_bytes(bn);
  return s > kMaxStages ? kMaxStages : s;
}

__host__ __device__ constexpr int smem_bytes(int bn) {
  // the ring, the epilogue's staging, 1024 bytes to align the ring for the
  // swizzle, the full and empty barriers of every stage
  return stages_for(bn) * stage_bytes(bn) + kEpiBytes + 1024 + 2 * kMaxStages * 8;
}

// activation codes (ops/quant_matmul.py `_ACTIVATIONS`)
constexpr int kLinear = 0, kRelu = 1, kGelu = 2, kGeluTanh = 3, kTanh = 4, kSilu = 5;

// the activation is a template argument: the epilogue is unrolled over
// every accumulator register, and a runtime switch there put every
// activation's code at each of its ~100 sites, whose jumps missed the
// instruction cache at each site (~25 us a 128 x 192 tile on the H100, with
// or without products and stores)
template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if constexpr (ACT == kRelu) {
    return fmaxf(v, 0.f);
  } else if constexpr (ACT == kGelu) {
    return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  } else if constexpr (ACT == kGeluTanh) {
    const float inner = 0.79788456080286536f * (v + 0.044715f * v * v * v);
    return 0.5f * v * (1.f + tanhf(inner));
  } else if constexpr (ACT == kTanh) {
    return tanhf(v);
  } else if constexpr (ACT == kSilu) {
    return v / (1.f + expf(-v));
  } else {
    return v;
  }
}

// d[0 .. BN/2) += A (64 x 32, K-major) x B (BN x 32, K-major)^T, s32.
// Accumulator layout (every wgmma shape): warp w of the warpgroup holds rows
// 16 w + lane / 4 (registers 4 j, 4 j + 1) and 16 w + lane / 4 + 8 (4 j + 2,
// 4 j + 3), at columns 8 j + 2 (lane % 4) and the one after.
template <int BN>
__device__ void wgmma_s8(int* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<192>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}


template <int BN, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
quant_matmul_kernel(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmw,
                    const __grid_constant__ CUtensorMap tmy, const float* __restrict__ scale,
                    const float* __restrict__ bias, float* __restrict__ y, long long M, int N,
                    int K, int tiles_n, long long tiles) {
  constexpr int S = stages_for(BN);
  constexpr int kA = kBM * kBK, kStage = stage_bytes(BN);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* epi = reinterpret_cast<float*>(smem + S * kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * kStage + kEpiBytes);
  uint64_t* empty = full + S;
  const int ksteps = (K + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival with the stage's bytes
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full, tile after tile
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tmx);
      tma_prefetch_map(&tmw);
      int it = 0;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = static_cast<int>(t / tiles_n) * kBM;
        const int n0 = static_cast<int>(t % tiles_n) * BN;
        for (int ks = 0; ks < ksteps; ++ks, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          uint8_t* a = smem + s * kStage;
          mbar_arrive_expect_tx(&full[s], kStage);
          tma_load_2d(a, &tmx, ks * kBK, m0, &full[s]);
          tma_load_2d(a + kA, &tmw, ks * kBK, n0, &full[s]);
        }
      }
    }
  } else {
    // consumers: warpgroup c owns rows 64 c .. 64 c + 63 of each tile
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const bool lead = threadIdx.x % 128 == 0;  // issues the warpgroup's stores
    int it = 0, chunk = 0;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long long m0 = (t / tiles_n) * kBM;
      const int n0 = static_cast<int>(t % tiles_n) * BN;
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int prev = -1;
      for (int ks = 0; ks < ksteps; ++ks, ++it) {
        const int s = it % S;
        mbar_wait(&full[s], (it / S) & 1);
        const uint8_t* a = smem + s * kStage + c * 64 * kBK;
        const uint64_t da = desc_k_sw128(a), db = desc_k_sw128(smem + s * kStage + kA);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        // the previous step's products are done: its stage goes back
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
      }
      wgmma_wait<0>();
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

      // epilogue, while the producer fills the ring with the next tile: 32
      // columns at a time, the warpgroup's 64 x 32 results go to one of its
      // two staging boxes and leave by one TMA store, which writes whole
      // lines, skips rows and columns past the matrix, and drains while the
      // warps go on to the next chunk and the next tile's products
      const int er = lane >> 2, et = lane & 3;
#pragma unroll
      for (int jc = 0; jc < BN / 32; ++jc, ++chunk) {
        float* st = epi + (2 * c + (chunk & 1)) * kEpiBox;
        if (lead) bulk_wait_read<1>();  // the store two chunks back has read st
        named_barrier(1 + c, 128);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = jc * 4 + jj;
          const int col = n0 + j * 8 + 2 * et;
          const bool in = col < N;  // N % 8 == 0: col + 1 < N whenever col < N
          const float s0 = in ? __ldg(scale + col) : 0.f, s1 = in ? __ldg(scale + col + 1) : 0.f;
          const float b0 = in && bias != nullptr ? __ldg(bias + col) : 0.f;
          const float b1 = in && bias != nullptr ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = __fmul_rn(static_cast<float>(acc[4 * j + 2 * h]), s0);
            float v1 = __fmul_rn(static_cast<float>(acc[4 * j + 2 * h + 1]), s1);
            if (bias != nullptr) {
              v0 += b0;
              v1 += b1;
            }
            // row r, columns 8 jj + 2 et (+1): chunk 2 jj + et / 2 of the
            // row, swizzled with r % 8
            const int r = warp * 16 + er + 8 * h;
            *reinterpret_cast<float2*>(st + r * kEpiCols + (((2 * jj + (et >> 1)) ^ (r & 7)) << 2) +
                                       2 * (et & 1)) =
                make_float2(activate<ACT>(v0), activate<ACT>(v1));
          }
        }
        fence_proxy_async();  // the writes above, before the TMA reads them
        named_barrier(1 + c, 128);
        if (lead) {
          tma_store_2d(&tmy, st, n0 + jc * kEpiCols, static_cast<int>(m0) + c * 64);
          bulk_commit();
        }
      }
    }
    if (lead) bulk_wait<0>();
  }
}

template <int BN, int ACT>
int launch(const void* x, const void* w, const float* scale, const float* bias, float* y,
           long long M, int N, int K, cudaStream_t stream) {
  // the operands' maps and the output's (64-row boxes of 32 fp32 columns)
  CUtensorMap tx, tw, ty;
  const auto m = static_cast<unsigned long long>(M);
  if (!encode_map_sw128(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, m, K, kBM) ||
      !encode_map_sw128(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, N, K, BN) ||
      !encode_map_sw128(&ty, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, y, m, N, 64))
    return (int)cudaErrorInvalidValue;
  const int tiles_n = (N + BN - 1) / BN;
  const long long tiles = ((M + kBM - 1) / kBM) * tiles_n;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  constexpr int smem = smem_bytes(BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(quant_matmul_kernel<BN, ACT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = tiles < sms ? tiles : sms;
  quant_matmul_kernel<BN, ACT><<<(unsigned)grid, kThreads, smem, stream>>>(
      tx, tw, ty, scale, bias, y, M, N, K, tiles_n, tiles);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_act(const void* x, const void* w, const float* scale, const float* bias, float* y,
               long long M, int N, int K, int act, cudaStream_t stream) {
  switch (act) {
    case kRelu:
      return launch<BN, kRelu>(x, w, scale, bias, y, M, N, K, stream);
    case kGelu:
      return launch<BN, kGelu>(x, w, scale, bias, y, M, N, K, stream);
    case kGeluTanh:
      return launch<BN, kGeluTanh>(x, w, scale, bias, y, M, N, K, stream);
    case kTanh:
      return launch<BN, kTanh>(x, w, scale, bias, y, M, N, K, stream);
    case kSilu:
      return launch<BN, kSilu>(x, w, scale, bias, y, M, N, K, stream);
    default:
      return launch<BN, kLinear>(x, w, scale, bias, y, M, N, K, stream);
  }
}

}  // namespace

// x: (M, K) int8, w: (N, K) int8, both row-major and 16-byte aligned;
// scale: (N,) fp32; bias: (N,) fp32 or null; y: (M, N) fp32; tile_n: the
// output tile's width, 128, 192 or 256.
extern "C" int unicore_quant_matmul(const void* x, const void* w, const void* scale,
                                    const void* bias, void* y, long long M, int N, int K,
                                    int act, int tile_n, void* stream) {
  if (M <= 0 || M > 0x7fffffffLL || N <= 0 || K <= 0 || K % 32 != 0 || N % 8 != 0 ||
      act < kLinear || act > kSilu || ((reinterpret_cast<uintptr_t>(x) |
                                        reinterpret_cast<uintptr_t>(w)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sc = static_cast<const float*>(scale);
  const auto b = static_cast<const float*>(bias);
  const auto out = static_cast<float*>(y);
  switch (tile_n) {
    case 128:
      return launch_act<128>(x, w, sc, b, out, M, N, K, act, s);
    case 192:
      return launch_act<192>(x, w, sc, b, out, M, N, K, act, s);
    case 256:
      return launch_act<256>(x, w, sc, b, out, M, N, K, act, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
