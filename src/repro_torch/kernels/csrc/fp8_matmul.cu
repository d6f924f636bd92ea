// Scaled fp8 GEMM for Hopper, sm_90a.
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
// no host sync precedes a launch. Any M, N, K: tiles past the edge read
// zeros and write nothing.
//
// Bound on this card: operations. 2*M*N*K FLOPs at the 1,979 TFLOP/s fp8
// tensor-core peak against (M + N) * K bytes at 3.35 TB/s: the gate_proj
// product at 2048 tokens (2048 x 8192 x 2048) is 68.7 GFLOP, 34.7 us at the
// peak.
//
// Design: the fp8 tensor cores through mma.sync.m16n8k32 (fp8 operands,
// f32 result). Hopper's fp8 tensor cores sum with fewer bits than f32, and
// the reference's contract is f32 accumulation, so every mma starts from a
// zero accumulator (32 products) and its result is added into f32 registers
// on the CUDA cores: the running sum never lives in the tensor core. A
// 256-thread block computes a 128 x 128 output tile with 8 warps of 64 x 32
// each (4 x 4 mma tiles); K advances 64 bytes a step, both operand tiles
// staged in shared memory through 16-byte loads (rows padded to 80 bytes,
// so the fragment loads of a warp hit 32 distinct banks). One stage, no
// asynchronous copies: wgmma, TMA and a pipelined ring are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kPad = 16;                    // bytes added to each smem row
constexpr int kThreads = 256;               // 8 warps: 2 (M) x 4 (N)
constexpr int kWM = 64, kWN = 32;           // warp tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;

// d = a * b (+ 0): one m16n8k32 fp8 product, f32 result
template <int FX, int FW>
__device__ __forceinline__ void mma_fp8(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
#define REPRO_MMA(TA, TB)                                                     \
  asm volatile(                                                               \
      "mma.sync.aligned.m16n8k32.row.col.f32." TA "." TB ".f32 "              \
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"          \
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])                        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),     \
        "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f))
  if constexpr (FX == 0 && FW == 0) REPRO_MMA("e4m3", "e4m3");
  else if constexpr (FX == 0 && FW == 1) REPRO_MMA("e4m3", "e5m2");
  else if constexpr (FX == 1 && FW == 0) REPRO_MMA("e5m2", "e4m3");
  else REPRO_MMA("e5m2", "e5m2");
#undef REPRO_MMA
}

__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// rows [r0, r0 + 128) x bytes [k0, k0 + 64) of a row-major (rows, K) fp8
// matrix into tile[row][byte]; thread t copies 32 bytes of row t / 2
__device__ __forceinline__ void load_tile(const uint8_t* __restrict__ src,
                                          int rows, int K, int r0, int k0,
                                          bool vec,
                                          uint8_t (*tile)[kBK + kPad]) {
  const int lr = threadIdx.x >> 1, lc = (threadIdx.x & 1) * 32;
  const int r = r0 + lr, c = k0 + lc;
  uint4* dst = reinterpret_cast<uint4*>(&tile[lr][lc]);
  if (r < rows && vec && c + 32 <= K) {
    const uint4* s = reinterpret_cast<const uint4*>(src + (size_t)r * K + c);
    dst[0] = s[0];
    dst[1] = s[1];
  } else {
    __align__(16) uint8_t v[32];
#pragma unroll
    for (int e = 0; e < 32; ++e)
      v[e] = (r < rows && c + e < K) ? src[(size_t)r * K + c + e] : 0;
    dst[0] = *reinterpret_cast<const uint4*>(v);
    dst[1] = *reinterpret_cast<const uint4*>(v + 16);
  }
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int FX, int FW, typename OutT>
__global__ void __launch_bounds__(kThreads)
fp8_matmul_kernel(const uint8_t* __restrict__ xq,
                  const uint8_t* __restrict__ wq,
                  const float* __restrict__ sx, const float* __restrict__ sw,
                  OutT* __restrict__ y, int M, int N, int K) {
  __shared__ __align__(16) uint8_t As[kBM][kBK + kPad];
  __shared__ __align__(16) uint8_t Bs[kBN][kBK + kPad];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;        // mma group / thread in group
  const int wm = (warp >> 2) * kWM, wn = (warp & 3) * kWN;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const bool vec = (K & 15) == 0 &&
                   ((reinterpret_cast<uintptr_t>(xq) |
                     reinterpret_cast<uintptr_t>(wq)) & 15) == 0;
  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    load_tile(xq, M, K, m0, k0, vec, As);
    load_tile(wq, N, K, n0, k0, vec, Bs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const uint8_t* r = &As[wm + i * 16 + g][kk + t * 4];
        a[i][0] = ld32(r);
        a[i][1] = ld32(r + 8 * (kBK + kPad));
        a[i][2] = ld32(r + 16);
        a[i][3] = ld32(r + 8 * (kBK + kPad) + 16);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint8_t* r = &Bs[wn + j * 8 + g][kk + t * 4];
        b[j][0] = ld32(r);
        b[j][1] = ld32(r + 16);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          float d[4];
          mma_fp8<FX, FW>(d, a[i], b[j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
        }
    }
    __syncthreads();
  }

  // c0, c1: row g, cols 2t, 2t+1; c2, c3: row g + 8, the same cols
  const float s = sx[0] * sw[0];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm + i * 16 + g + (e >> 1) * 8;
        const int c = n0 + wn + j * 8 + t * 2 + (e & 1);
        if (r < M && c < N) store(acc[i][j][e] * s, y + (size_t)r * N + c);
      }
}

template <int FX, int FW>
cudaError_t launch(const void* xq, const void* wq, const void* sx,
                   const void* sw, void* y, int M, int N, int K, int out,
                   cudaStream_t st) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const uint8_t* x = static_cast<const uint8_t*>(xq);
  const uint8_t* w = static_cast<const uint8_t*>(wq);
  const float* a = static_cast<const float*>(sx);
  const float* b = static_cast<const float*>(sw);
  if (out == 0)
    fp8_matmul_kernel<FX, FW, __nv_bfloat16><<<grid, kThreads, 0, st>>>(
        x, w, a, b, static_cast<__nv_bfloat16*>(y), M, N, K);
  else if (out == 1)
    fp8_matmul_kernel<FX, FW, float><<<grid, kThreads, 0, st>>>(
        x, w, a, b, static_cast<float*>(y), M, N, K);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// x_fp8 / w_fp8: 0 e4m3fn, 1 e5m2. out_dtype: 0 bf16, 1 f32. sx / sw: one
// device f32 each. Returns the cudaError_t of the launch (0 = launched).
extern "C" int fp8_matmul_launch(const void* xq, const void* wq,
                                 const void* sx, const void* sw, void* y,
                                 int M, int N, int K, int x_fp8, int w_fp8,
                                 int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_fp8 == 0 && w_fp8 == 0)
    e = launch<0, 0>(xq, wq, sx, sw, y, M, N, K, out_dtype, st);
  else if (x_fp8 == 0 && w_fp8 == 1)
    e = launch<0, 1>(xq, wq, sx, sw, y, M, N, K, out_dtype, st);
  else if (x_fp8 == 1 && w_fp8 == 0)
    e = launch<1, 0>(xq, wq, sx, sw, y, M, N, K, out_dtype, st);
  else if (x_fp8 == 1 && w_fp8 == 1)
    e = launch<1, 1>(xq, wq, sx, sw, y, M, N, K, out_dtype, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
