// Per-tensor fp8 quantization pair for Hopper, sm_90a: amax and scale_cast.
//
// Replaces: src/repro/kernels/quant_cast.py, amax (_amax_kernel, per-row-tile
// partials then jnp.max) and scale_cast (_cast_kernel), the two Pallas TPU
// kernels behind quantize_fp8.
//
// What they compute:
//   amax(x)             = max_i |float(x_i)|  as an f32 scalar; NaN if any
//                         x_i is NaN (written as the canonical 0x7fc00000)
//   scale_cast(x, s)[i] = fp8(float(x_i) * s), s read from device memory,
//                         rounded to nearest even, with the reference
//                         framework's special values: e4m3fn NaN or
//                         |y| > 464 -> 0x7f | sign (NaN); e5m2 NaN ->
//                         0x7e | sign, |y| >= 61440 -> 0x7c | sign (inf).
// The hardware conversion (cvt.rn.satfinite) rounds every in-range value to
// nearest even; the overflow rules above replace its saturation.
//
// Bound on this card: bytes. amax reads x once (2 bytes an element for
// bf16) and writes 4 bytes; scale_cast reads x once and writes one byte an
// element: a (2048, 8192) bf16 weight is 33.6 MB read, about 10 us at
// 3.35 TB/s. The design keeps them streaming: 256-thread blocks walk the
// tensor grid-stride in chunks of 8 elements (one 16-byte load of bf16 when
// the pointer is aligned), at most 8 blocks per SM. amax reduces in
// registers, then by warp shuffles, then across the block's warps in shared
// memory, and combines blocks with one atomicMax per block on the bit
// pattern of a non-negative float (monotone in its value; NaN, mapped to
// 0x7fc00000, orders above inf). No second pass and no host sync: the
// result stays in device memory for the scale computation that follows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                      // elements per chunk
constexpr int kMaxBlocks = 132 * 8;
constexpr uint32_t kCanonicalNaN = 0x7fc00000u;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 8 consecutive elements as floats; a 16-byte (bf16) or two 16-byte (f32)
// loads when `vec`, else element loads masked at n
template <typename T>
__device__ __forceinline__ void load8(const T* x, long long i, long long n,
                                      bool vec, float (&v)[kVec]) {
  if (vec && i + kVec <= n) {
    if constexpr (sizeof(T) == 2) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + i);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = to_float(h[e]);
    } else {
      const float4 a = *reinterpret_cast<const float4*>(x + i);
      const float4 b = *reinterpret_cast<const float4*>(x + i + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) v[e] = (i + e < n) ? to_float(x[i + e]) : 0.f;
}

__device__ __forceinline__ uint32_t abs_bits(float v) {
  const float a = fabsf(v);
  return isnan(a) ? kCanonicalNaN : __float_as_uint(a);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
amax_kernel(const T* __restrict__ x, long long n, unsigned int* out) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  uint32_t m = 0;
  const long long stride = (long long)gridDim.x * kThreads * kVec;
  for (long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * kVec;
       i < n; i += stride) {
    float v[kVec];
    load8(x, i, n, vec, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) m = max(m, abs_bits(v[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ uint32_t warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) atomicMax(out, m);
  }
}

template <int FMT>   // 0: e4m3fn, 1: e5m2
__device__ __forceinline__ uint8_t to_fp8(float y) {
  const uint8_t sign = (__float_as_uint(y) >> 24) & 0x80u;
  if (FMT == 0) {
    if (isnan(y) || fabsf(y) > 464.0f) return sign | 0x7f;
    return __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
  } else {
    if (isnan(y)) return sign | 0x7e;
    if (fabsf(y) >= 61440.0f) return sign | 0x7c;
    return __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E5M2);
  }
}

template <typename T, int FMT>
__global__ void __launch_bounds__(kThreads)
scale_cast_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  uint8_t* __restrict__ out, long long n) {
  // chunks start at multiples of 8 elements: 16-byte input loads need x
  // 16-byte aligned, the 8-byte store needs out 8-byte aligned
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 7) == 0;
  const float s = *scale;
  const long long stride = (long long)gridDim.x * kThreads * kVec;
  for (long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * kVec;
       i < n; i += stride) {
    float v[kVec];
    load8(x, i, n, vec, v);
    uint8_t q[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) q[e] = to_fp8<FMT>(__fmul_rn(v[e], s));
    if (vec && i + kVec <= n) {
      *reinterpret_cast<uint2*>(out + i) = *reinterpret_cast<const uint2*>(q);
    } else {
      for (int e = 0; e < kVec && i + e < n; ++e) out[i + e] = q[e];
    }
  }
}

int grid_for(long long n) {
  const long long chunks = (n + kVec - 1) / kVec;
  const long long blocks = (chunks + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1) : kMaxBlocks);
}

template <typename T, int FMT>
cudaError_t launch_cast(const void* x, const void* scale, void* out,
                        long long n, cudaStream_t st) {
  scale_cast_kernel<T, FMT><<<grid_for(n), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<uint8_t*>(out), n);
  return cudaGetLastError();
}

}  // namespace

// in_dtype: 0 bf16, 1 f32. `out` is one device uint32, zeroed by the caller.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int amax_launch(const void* x, long long n, int in_dtype,
                           void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned int* o = static_cast<unsigned int*>(out);
  switch (in_dtype) {
    case 0:
      amax_kernel<__nv_bfloat16><<<grid_for(n), kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), n, o);
      break;
    case 1:
      amax_kernel<float><<<grid_for(n), kThreads, 0, st>>>(
          static_cast<const float*>(x), n, o);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// in_dtype: 0 bf16, 1 f32. fp8: 0 e4m3fn, 1 e5m2. `scale` is one device f32.
extern "C" int scale_cast_launch(const void* x, const void* scale, void* out,
                                 long long n, int in_dtype, int fp8,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (in_dtype == 0 && fp8 == 0)
    e = launch_cast<__nv_bfloat16, 0>(x, scale, out, n, st);
  else if (in_dtype == 0 && fp8 == 1)
    e = launch_cast<__nv_bfloat16, 1>(x, scale, out, n, st);
  else if (in_dtype == 1 && fp8 == 0)
    e = launch_cast<float, 0>(x, scale, out, n, st);
  else if (in_dtype == 1 && fp8 == 1)
    e = launch_cast<float, 1>(x, scale, out, n, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
