// Scaled fp8 GEMM for Hopper, sm_90a: fp8 wgmma fed by a TMA ring.
//
// Replaces: src/repro/kernels/fp8_matmul.py, fp8_matmul (Pallas TPU kernel
// _kernel: (bm x bk) x (bn x bk) tiles, f32 VMEM accumulator over the
// sequential K grid axis, scale product applied once in the epilogue).
//
// What it computes:
//   y[m, n] = out_dtype( (sum_k float(xq[m, k]) * float(wq[n, k]))
//                        * (sx_inv * sw_inv) )
// xq (M, K) and wq (N, K) are fp8 (e4m3fn or e5m2, independently), row
// major; the two dequant scales are f32 scalars read from device memory, so
// no host sync precedes a launch and the launch can be captured in a CUDA
// graph. Any M and N; K's row stride must be a multiple of 16 bytes (TMA),
// so the wrapper zero-pads K to a multiple of 16 (zero products are exact).
//
// Bound on this card: operations. 2*M*N*K FLOPs at the 1,979 TFLOP/s fp8
// tensor-core peak against (M + N) * K + M * N * out bytes at 3.35 TB/s: the
// gate_proj product at 2048 tokens (2048 x 8192 x 2048) is 68.7 GFLOP, 34.7
// us at the peak.
//
// Design. One block of three warpgroups computes a 128 x 128 output tile.
// Warpgroup 2 is the producer: one thread keeps a ring of kStages shared-
// memory stages filled by TMA, each stage a 128-byte K slab of both operand
// tiles (128 rows x 128 bytes each, 128-byte swizzle), guarded by a "full"
// mbarrier (TMA bytes arrived) and an "empty" one (all eight consumer warps
// done). Warpgroups 0 and 1 are the consumers, 64 output rows each: per slab
// four wgmma.m64n128k32 fp8 products, both operands K-major straight from
// shared memory (the only layout fp8 wgmma takes, and the one xq and wq
// have). Tiles past the matrix edge are zero-filled by TMA; the epilogue
// masks the stores. The grid walks M fastest, so the blocks that share a
// weight tile run together and the weights are read from device memory
// about once. setmaxnreg moves registers from the producer to the consumers.
//
// Numerics: f32 accumulation, the reference's contract. Hopper's fp8 tensor
// cores sum with fewer bits than f32, so each 128-byte K slab (four k32
// products) accumulates into a fresh wgmma accumulator, and after
// wgmma.wait_group that partial sum is added into the f32 main accumulator
// in registers: the running sum never lives in the tensor core beyond 128
// products. The epilogue multiplies by sx_inv * sw_inv once and rounds to
// bf16 (or stores f32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 128;   // tile rows, cols, K bytes
constexpr int kStages = 5;
constexpr int kThreads = 384;                    // 2 consumer + 1 producer WG
constexpr int kTileBytes = kBM * kBK;            // one operand's slab
constexpr int kSmemBytes = 2 * kStages * kTileBytes + 2 * kStages * 8 + 1024;

// d = xq slab x wq slab (64 x 128 x 32), accumulated onto d unless !scale_d
template <int FX, int FW>
__device__ __forceinline__ void wgmma_fp8(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
#define REPRO_WGMMA_FP8(TA, TB)                                               \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k32.f32." TA "." TB " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "\
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "\
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "\
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "\
      "%58, %59, %60, %61, %62, %63"                                          \
      "}, %64, %65, p, 1, 1;\n}\n"                                            \
      :                                                                       \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),             \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),             \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),        \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),        \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),        \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),        \
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),        \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),        \
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),        \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),        \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),        \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                      \
      : "l"(da), "l"(db), "r"(scale_d))
  if constexpr (FX == 0 && FW == 0) REPRO_WGMMA_FP8("e4m3", "e4m3");
  else if constexpr (FX == 0 && FW == 1) REPRO_WGMMA_FP8("e4m3", "e5m2");
  else if constexpr (FX == 1 && FW == 0) REPRO_WGMMA_FP8("e5m2", "e4m3");
  else REPRO_WGMMA_FP8("e5m2", "e5m2");
#undef REPRO_WGMMA_FP8
}

__device__ __forceinline__ void store2(float a, float b, float* p, bool two,
                                       bool vec) {
  if (two && vec) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (two) p[1] = b;
  }
}
__device__ __forceinline__ void store2(float a, float b, __nv_bfloat16* p,
                                       bool two, bool vec) {
  if (two && vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    if (two) p[1] = __float2bfloat16_rn(b);
  }
}

template <int FX, int FW, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
fp8_matmul_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  const float* __restrict__ sx, const float* __restrict__ sw,
                  OutT* __restrict__ y, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023))
                              & 1023);
  uint8_t* a_tiles = smem;                          // kStages x 16 KB
  uint8_t* b_tiles = smem + kStages * kTileBytes;   // kStages x 16 KB
  uint64_t* full = reinterpret_cast<uint64_t*>(b_tiles
                                               + kStages * kTileBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x >> 7;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int nk = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);              // the 8 consumer warps
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {                                    // producer
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 2 * 128) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % kStages;
        const int round = kb / kStages;
        if (round > 0) hopper::mbar_wait(&empty[s], (round - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * kTileBytes);
        hopper::tma_load_2d(a_tiles + s * kTileBytes, &map_x, &full[s],
                            kb * kBK, m0);
        hopper::tma_load_2d(b_tiles + s * kTileBytes, &map_w, &full[s],
                            kb * kBK, n0);
      }
    }
  } else {                                          // consumers
    hopper::reg_alloc<232>();
    const int lane = threadIdx.x & 31;
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % kStages;
      hopper::mbar_wait(&full[s], (kb / kStages) & 1);
      const uint8_t* a = a_tiles + s * kTileBytes + wg * 64 * kBK;
      const uint8_t* b = b_tiles + s * kTileBytes;
      hopper::fence_regs(part);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 32; ++k)
        wgmma_fp8<FX, FW>(part, hopper::smem_desc(a + 32 * k, 16, 1024),
                          hopper::smem_desc(b + 32 * k, 16, 1024), k > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(part);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];   // promotion to f32
    }

    // accumulator layout: register j of thread (warp w, lane l) holds row
    // 16w + l/4 + 8 * ((j / 2) % 2), column 8 * (j / 4) + 2 * (l % 4) + j % 2
    const float scale = sx[0] * sw[0];
    const int w = (threadIdx.x >> 5) & 3;
    const int row0 = m0 + wg * 64 + w * 16 + (lane >> 2);
    const bool vec = (N & 1) == 0;
#pragma unroll
    for (int j = 0; j < 64; j += 2) {
      const int r = row0 + 8 * ((j >> 1) & 1);
      const int c = n0 + 8 * (j >> 2) + 2 * (lane & 3);
      if (r < M && c < N)
        store2(acc[j] * scale, acc[j + 1] * scale,
               y + static_cast<size_t>(r) * N + c, c + 1 < N, vec);
    }
  }
}

// a (rows, K) row-major fp8 matrix cut into 128 x 128-byte boxes
int fp8_map(CUtensorMap* map, const void* p, int rows, int K) {
  const uint64_t dims[2] = {static_cast<uint64_t>(K),
                            static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(K)};
  const uint32_t box[2] = {kBK, kBM};
  return hopper::make_map(map, p, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, dims,
                          strides, box, true);
}

template <int FX, int FW, typename OutT>
cudaError_t launch(const void* xq, const void* wq, const void* sx,
                   const void* sw, void* y, int M, int N, int K,
                   cudaStream_t st) {
  CUtensorMap mx, mw;
  int rc = fp8_map(&mx, xq, M, K);
  if (rc == 0) rc = fp8_map(&mw, wq, N, K);
  if (rc != 0) return static_cast<cudaError_t>(rc);
  auto kern = fp8_matmul_kernel<FX, FW, OutT>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  kern<<<grid, kThreads, kSmemBytes, st>>>(
      mx, mw, static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<OutT*>(y), M, N, K);
  return cudaGetLastError();
}

template <int FX, int FW>
cudaError_t launch_out(const void* xq, const void* wq, const void* sx,
                       const void* sw, void* y, int M, int N, int K, int out,
                       cudaStream_t st) {
  if (out == 0)
    return launch<FX, FW, __nv_bfloat16>(xq, wq, sx, sw, y, M, N, K, st);
  if (out == 1) return launch<FX, FW, float>(xq, wq, sx, sw, y, M, N, K, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x_fp8 / w_fp8: 0 e4m3fn, 1 e5m2. out_dtype: 0 bf16, 1 f32. sx / sw: one
// device f32 each. xq and wq 16-byte aligned with K a multiple of 16.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int fp8_matmul_launch(const void* xq, const void* wq,
                                 const void* sx, const void* sw, void* y,
                                 int M, int N, int K, int x_fp8, int w_fp8,
                                 int out_dtype, void* stream) {
  if (K % 16 != 0 || ((reinterpret_cast<uintptr_t>(xq)
                       | reinterpret_cast<uintptr_t>(wq)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_fp8 == 0 && w_fp8 == 0)
    e = launch_out<0, 0>(xq, wq, sx, sw, y, M, N, K, out_dtype, st);
  else if (x_fp8 == 0 && w_fp8 == 1)
    e = launch_out<0, 1>(xq, wq, sx, sw, y, M, N, K, out_dtype, st);
  else if (x_fp8 == 1 && w_fp8 == 0)
    e = launch_out<1, 0>(xq, wq, sx, sw, y, M, N, K, out_dtype, st);
  else if (x_fp8 == 1 && w_fp8 == 1)
    e = launch_out<1, 1>(xq, wq, sx, sw, y, M, N, K, out_dtype, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
