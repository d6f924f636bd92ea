// Paged single-query decode attention (GQA form) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/paged_attention.py, paged_decode_attention
// (Pallas TPU kernel _kernel / _call), in its GQA form: bf16 or fp8-e4m3 KV
// with per-tensor k_scale / v_scale and a static integer window. The MLA form
// (v = None, q2/k2, scale_mode "mul") is refused by the Python wrapper.
//
// What it computes, per decode row b and KV head h (one CTA each):
//   live keys  lo <= pos < hi,  lo = max(0, len - window), hi = min(len, S)
//   s[g,pos]   = round_QT(sum_d q[g,d] * deq(k[pos,d])) / scale   (f32 sum)
//   p[g,pos]   = round_QT(exp(s - m[g]) / l[g])   with the FINAL row max m
//                and denominator l (exact two-phase softmax, no online
//                rescaling), keys outside [lo, hi) contributing exactly 0
//   out[g,d]   = sum_pos p[g,pos] * deq(v[pos,d])                  (f32 sum)
// deq(x) = round_QT(float(x) * scale) — the reference's _dequant: a unit
// scale is a plain upcast (float(x) * 1.0f is exact), any other an f32
// multiply then a cast to the compute dtype. round_QT rounds to the query
// dtype (bf16 in serving), reproducing the reference's bf16 score and
// probability casts. Rows with len == 0 write zeros. Pages outside the live
// range are never read; block-table entries of -1 read block 0.
//
// Bound on this card: the live K+V bytes it must read,
//   sum_b live_b * Hkv * (Dk + Dv) * elem_bytes  at 3.35 TB/s
// (plus q, tables and the output, all small). At the serving shapes (B=4,
// Hkv=8, G=4, D=64, S<=160) that is under a microsecond per layer, far
// below a launch, so this first version keeps the design simple and leaves
// speed to a later change: scores live in dynamic shared memory
// (G * n_pages * bs floats), one warp per key position computes all G
// scores with coalesced row loads and butterfly sums, and each thread owns
// (g, d) output pairs, reading V rows coalesced across threads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDkPerLane = 8;            // Dk <= 256
constexpr float kNeg = -3.402823466e+38f;   // finfo(float32).min

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_float<__nv_fp8_e4m3>(
    __nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// round an f32 value to the compute dtype and back (RNE)
template <typename QT> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(
    float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename QT> __device__ __forceinline__ QT from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v,
                    const int32_t* __restrict__ block_tables,
                    const int32_t* __restrict__ lengths, QT* __restrict__ out,
                    int Hkv, int G, int Dk, int Dv, int bs, int n_pages,
                    int window, float scale, float k_scale, float v_scale,
                    int round_scores, int round_probs) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int S = n_pages * bs;
  float* q_sh = smem;                 // G * Dk
  float* s_sh = q_sh + G * Dk;        // G * S scores, then probabilities
  float* m_sh = s_sh + G * S;         // G
  float* l_sh = m_sh + G;             // G
  int* blk_sh = reinterpret_cast<int*>(l_sh + G);   // n_pages
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  QT* o = out + (static_cast<size_t>(b) * Hkv + h) * G * Dv;
  const int len = lengths[b];
  const int hi = min(len, S);
  const int lo = max(0, len - window);
  if (len <= 0 || lo >= hi) {         // nothing live: zeros (block-uniform)
    for (int i = tid; i < G * Dv; i += kThreads) o[i] = from_float<QT>(0.f);
    return;
  }
  const int n_live = hi - lo;

  const QT* qb = q + (static_cast<size_t>(b) * Hkv + h) * G * Dk;
  for (int i = tid; i < G * Dk; i += kThreads) q_sh[i] = to_float(qb[i]);
  for (int j = tid; j < n_pages; j += kThreads)
    blk_sh[j] = max(block_tables[static_cast<size_t>(b) * n_pages + j], 0);
  __syncthreads();

  // phase 0: masked scores of the live keys, one warp per key position
  for (int pos = lo + warp; pos < hi; pos += kWarps) {
    const KT* krow = k + ((static_cast<size_t>(blk_sh[pos / bs]) * bs
                           + pos % bs) * Hkv + h) * Dk;
    float kv[kMaxDkPerLane];
#pragma unroll
    for (int j = 0; j < kMaxDkPerLane; ++j) {
      const int d = lane + 32 * j;
      kv[j] = d < Dk ? round_to<QT>(to_float(krow[d]) * k_scale) : 0.f;
    }
    for (int g = 0; g < G; ++g) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxDkPerLane; ++j) {
        const int d = lane + 32 * j;
        if (d < Dk) acc = fmaf(q_sh[g * Dk + d], kv[j], acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        const float s = round_scores ? round_to<QT>(acc) : acc;
        s_sh[g * S + pos] = s / scale;
      }
    }
  }
  __syncthreads();

  // phase 1: the final row max and denominator, one warp per query head
  for (int g = warp; g < G; g += kWarps) {
    float m = kNeg;
    for (int pos = lo + lane; pos < hi; pos += 32) m = fmaxf(m, s_sh[g * S + pos]);
    m = warp_max(m);
    float l = 0.f;
    for (int pos = lo + lane; pos < hi; pos += 32) l += expf(s_sh[g * S + pos] - m);
    l = warp_sum(l);
    if (lane == 0) {
      m_sh[g] = m;
      l_sh[g] = l;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * n_live; i += kThreads) {
    const int g = i / n_live, pos = lo + i % n_live;
    const float p = expf(s_sh[g * S + pos] - m_sh[g]) / l_sh[g];
    s_sh[g * S + pos] = round_probs ? round_to<QT>(p) : p;
  }
  __syncthreads();

  // phase 2: context, each thread owning (g, d) pairs
  for (int i = tid; i < G * Dv; i += kThreads) {
    const int g = i / Dv, d = i % Dv;
    const float* p = s_sh + g * S;
    float acc = 0.f;
    for (int pos = lo; pos < hi; ++pos) {
      const KT* vrow = v + ((static_cast<size_t>(blk_sh[pos / bs]) * bs
                             + pos % bs) * Hkv + h) * Dv;
      acc = fmaf(p[pos], round_to<QT>(to_float(vrow[d]) * v_scale), acc);
    }
    o[i] = from_float<QT>(acc);
  }
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* block_tables, const void* lengths, void* out,
                   int B, int Hkv, int G, int Dk, int Dv, int bs, int n_pages,
                   int window, float scale, float k_scale, float v_scale,
                   int round_scores, int round_probs, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(G) * Dk
                                       + static_cast<size_t>(G) * n_pages * bs
                                       + 2 * static_cast<size_t>(G))
                      + sizeof(int) * static_cast<size_t>(n_pages);
  auto kern = paged_decode_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(lengths), static_cast<QT*>(out), Hkv, G,
      Dk, Dv, bs, n_pages, window, scale, k_scale, v_scale, round_scores,
      round_probs);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* k,
                        const void* v, const void* bt, const void* len,
                        void* out, int B, int Hkv, int G, int Dk, int Dv,
                        int bs, int n_pages, int window, float scale,
                        float k_scale, float v_scale, int rs, int rp,
                        cudaStream_t st) {
  switch (kv_dtype) {
    case 0:
      return launch<QT, __nv_bfloat16>(q, k, v, bt, len, out, B, Hkv, G, Dk,
                                       Dv, bs, n_pages, window, scale,
                                       k_scale, v_scale, rs, rp, st);
    case 1:
      return launch<QT, float>(q, k, v, bt, len, out, B, Hkv, G, Dk, Dv, bs,
                               n_pages, window, scale, k_scale, v_scale, rs,
                               rp, st);
    case 2:
      return launch<QT, __nv_fp8_e4m3>(q, k, v, bt, len, out, B, Hkv, G, Dk,
                                       Dv, bs, n_pages, window, scale,
                                       k_scale, v_scale, rs, rp, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 bf16, 1 f32. kv_dtype: 0 bf16, 1 f32, 2 fp8 e4m3fn.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* block_tables,
    const void* lengths, void* out, int B, int Hkv, int G, int Dk, int Dv,
    int bs, int n_pages, int window, float scale, float k_scale,
    float v_scale, int round_scores, int round_probs, int q_dtype,
    int kv_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (q_dtype) {
    case 0:
      e = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k, v, block_tables, lengths,
                                     out, B, Hkv, G, Dk, Dv, bs, n_pages,
                                     window, scale, k_scale, v_scale,
                                     round_scores, round_probs, st);
      break;
    case 1:
      e = dispatch_kv<float>(kv_dtype, q, k, v, block_tables, lengths, out, B,
                             Hkv, G, Dk, Dv, bs, n_pages, window, scale,
                             k_scale, v_scale, round_scores, round_probs, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
