// Paged single-query decode attention for Hopper, sm_90a, on the CUDA
// cores: the MLA (absorbed latent) form, f32 queries, and any GQA call
// outside the tensor-core kernel's rule (kernels/paged_attention.py
// route: unrounded scores, f32 K/V, head dims not a multiple of 16 or over
// 256). The GQA serving form runs in csrc/paged_decode_gqa.cu.
//
// Replaces: src/repro/kernels/paged_attention.py, paged_decode_attention
// (Pallas TPU kernel _kernel / _call) in both of its forms:
//   GQA: bf16 or fp8-e4m3 K and V with per-tensor k_scale / v_scale, a
//        static integer window, scores and probabilities rounded to the
//        query dtype, scale_mode "div";
//   MLA: v = None (the values are the key storage itself, the ckv latents),
//        a second score operand q2 . k2 (the rope part, kr), scale_mode
//        "mul", f32 query, scores, probabilities and output.
//
// What it computes, per decode row b, KV head h and query head g:
//   live keys  lo <= pos < hi,  lo = max(0, len - window), hi = min(len, S)
//   s[g,pos]   = round_S(sum_d q[g,d] * deq(k[pos,d])
//                        + sum_e q2[g,e] * deq(k2[pos,e]))      (f32 sums)
//                then / scale ("div") or * scale ("mul")
//   p[g,pos]   = round_P(exp(s - m[g]) / l[g])   with the FINAL row max m
//                and denominator l (exact two-phase softmax, no online
//                rescaling), keys outside [lo, hi) contributing exactly 0
//   out[g,d]   = sum_pos p[g,pos] * deq(v[pos,d])                 (f32 sum)
// deq(x) = round_QT(float(x) * scale) — the reference's _dequant: a unit
// scale is a plain upcast (float(x) * 1.0f is exact), any other an f32
// multiply then a cast to the compute dtype. round_S / round_P round to the
// query dtype when the caller asks for it (bf16 in GQA serving) and are the
// identity otherwise (MLA). Rows with len == 0 write zeros. Pages outside
// the live range are never read; block-table entries of -1 read block 0.
//
// Bound on this card: the live key (and value) bytes it must read,
//   sum_b live_b * Hkv * (Dk + D2 + Dv) * elem_bytes  at 3.35 TB/s
// (in the MLA form the values are the keys, read once: Dk + D2 only), plus
// q, tables and the output. At the serving shapes that is about a
// microsecond per layer or less, so this version keeps the design simple:
// one block of 512 threads per (row, KV head, group of up to 8 query
// heads). The group's queries and scores live in dynamic shared memory (hg
// * (Dk + D2) + hg * n_pages * bs floats); one warp per key position forms
// the group's dot products, a few positions at a time, and reduces them
// together with butterfly sums; each thread owns one value column for a
// share of the group's heads, so a value row is read once for several
// heads. Splitting the heads is what lets the MLA form fit: 128 heads x 576
// f32 query values alone are 295 KB, over the 227 KB a block may use. The
// wrapper picks the largest group (8, 4, 2, 1) whose scores fit and that
// still gives half the SMs a block, and raises beyond a group of one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDkPerLane = 16;           // Dk <= 512
constexpr int kMaxD2PerLane = 4;            // D2 <= 128
constexpr int kMaxHG = 8;                   // query heads per block
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

// DKL: key values per lane (8: Dk <= 256; 16: Dk <= 512).
template <typename QT, typename KT, int DKL>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const QT* __restrict__ q2,
                    const KT* __restrict__ k2,
                    const int32_t* __restrict__ block_tables,
                    const int32_t* __restrict__ lengths, QT* __restrict__ out,
                    int Hkv, int G, int hg, int Dk, int D2, int Dv, int bs,
                    int n_pages, int window, float scale, int scale_mul,
                    float k_scale, float v_scale, int round_scores,
                    int round_probs) {
  extern __shared__ float smem[];
  const int n_groups = (G + hg - 1) / hg;
  const int h = blockIdx.x / n_groups, g0 = (blockIdx.x % n_groups) * hg;
  const int b = blockIdx.y;
  const int ng = min(hg, G - g0);     // heads of this block
  const int S = n_pages * bs;
  float* q_sh = smem;                 // hg * Dk
  float* q2_sh = q_sh + hg * Dk;      // hg * D2
  float* s_sh = q2_sh + hg * D2;      // hg * S scores, then probabilities
  float* m_sh = s_sh + hg * S;        // hg
  float* l_sh = m_sh + hg;            // hg
  int* blk_sh = reinterpret_cast<int*>(l_sh + hg);   // n_pages
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const size_t head0 = (static_cast<size_t>(b) * Hkv + h) * G + g0;
  QT* o = out + head0 * Dv;
  const int len = lengths[b];
  const int hi = min(len, S);
  const int lo = max(0, len - window);
  if (len <= 0 || lo >= hi) {         // nothing live: zeros (block-uniform)
    for (int i = tid; i < ng * Dv; i += kThreads) o[i] = from_float<QT>(0.f);
    return;
  }
  const int n_live = hi - lo;

  for (int i = tid; i < ng * Dk; i += kThreads)
    q_sh[i] = to_float(q[head0 * Dk + i]);
  for (int i = tid; i < ng * D2; i += kThreads)
    q2_sh[i] = to_float(q2[head0 * D2 + i]);
  for (int j = tid; j < n_pages; j += kThreads)
    blk_sh[j] = max(block_tables[static_cast<size_t>(b) * n_pages + j], 0);
  __syncthreads();

  // phase 0: masked scores of the live keys, one warp per key position, PP
  // positions at a time (their loads in flight together); the dot products
  // of all positions and heads are formed first and reduced together, so
  // the butterfly sums overlap
  constexpr int PP = 32 / DKL;
  for (int p0 = lo + warp; p0 < hi; p0 += kWarps * PP) {
    float kv[PP][DKL], k2v[PP][kMaxD2PerLane];
    size_t slot[PP];
#pragma unroll
    for (int u = 0; u < PP; ++u) {
      const int pos = min(p0 + kWarps * u, hi - 1);   // a repeat is unused
      slot[u] = (static_cast<size_t>(blk_sh[pos / bs]) * bs + pos % bs)
                * Hkv + h;
      const KT* krow = k + slot[u] * Dk;
#pragma unroll
      for (int j = 0; j < DKL; ++j) {
        const int d = lane + 32 * j;
        kv[u][j] = d < Dk ? round_to<QT>(to_float(krow[d]) * k_scale) : 0.f;
      }
      if (D2 > 0) {                   // block-uniform
#pragma unroll
        for (int j = 0; j < kMaxD2PerLane; ++j) {
          const int e = lane + 32 * j;
          k2v[u][j] = e < D2 ? round_to<QT>(to_float(k2[slot[u] * D2 + e])
                                            * k_scale)
                             : 0.f;
        }
      }
    }
    float acc[PP][kMaxHG], acc2[PP][kMaxHG];
#pragma unroll
    for (int u = 0; u < PP; ++u)
#pragma unroll
      for (int g = 0; g < kMaxHG; ++g) {
        acc[u][g] = 0.f;
        acc2[u][g] = 0.f;
        if (g < ng) {
#pragma unroll
          for (int j = 0; j < DKL; ++j) {
            const int d = lane + 32 * j;
            if (d < Dk) acc[u][g] = fmaf(q_sh[g * Dk + d], kv[u][j],
                                         acc[u][g]);
          }
          if (D2 > 0) {
#pragma unroll
            for (int j = 0; j < kMaxD2PerLane; ++j) {
              const int e = lane + 32 * j;
              if (e < D2) acc2[u][g] = fmaf(q2_sh[g * D2 + e], k2v[u][j],
                                            acc2[u][g]);
            }
          }
        }
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < PP; ++u)
#pragma unroll
        for (int g = 0; g < kMaxHG; ++g)
          if (g < ng) {
            acc[u][g] += __shfl_xor_sync(0xffffffffu, acc[u][g], off);
            if (D2 > 0)
              acc2[u][g] += __shfl_xor_sync(0xffffffffu, acc2[u][g], off);
          }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < PP; ++u) {
        const int pos = p0 + kWarps * u;
        if (pos >= hi) continue;
#pragma unroll
        for (int g = 0; g < kMaxHG; ++g) {
          if (g < ng) {
            const float a = D2 > 0 ? acc[u][g] + acc2[u][g] : acc[u][g];
            const float sc = round_scores ? round_to<QT>(a) : a;
            s_sh[g * S + pos] = scale_mul ? sc * scale : sc / scale;
          }
        }
      }
    }
  }
  __syncthreads();

  // phase 1: the final row max and denominator, one warp per query head
  for (int g = warp; g < ng; g += kWarps) {
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
  for (int i = tid; i < ng * n_live; i += kThreads) {
    const int g = i / n_live, pos = lo + i % n_live;
    const float p = expf(s_sh[g * S + pos] - m_sh[g]) / l_sh[g];
    s_sh[g * S + pos] = round_probs ? round_to<QT>(p) : p;
  }
  __syncthreads();

  // phase 2: context. A value row is read once for several heads: thread
  // t owns column t % Dv for heads t / Dv, t / Dv + kThreads / Dv, ...
  // (Dv <= kThreads). Each (head, column) sums its positions in order.
  const int hsplit = kThreads / Dv;
  const int g_first = tid / Dv, col = tid % Dv;
  if (g_first < hsplit) {
    float acc[kMaxHG];
#pragma unroll
    for (int i = 0; i < kMaxHG; ++i) acc[i] = 0.f;
    // VP value rows at a time: their loads in flight together, then the
    // products added in position order
    constexpr int VP = 8;
    for (int p0 = lo; p0 < hi; p0 += VP) {
      float vv[VP];
#pragma unroll
      for (int u = 0; u < VP; ++u) {
        const int pos = min(p0 + u, hi - 1);           // a repeat is unused
        const KT* vrow = v + ((static_cast<size_t>(blk_sh[pos / bs]) * bs
                               + pos % bs) * Hkv + h) * Dv;
        vv[u] = round_to<QT>(to_float(vrow[col]) * v_scale);
      }
#pragma unroll
      for (int u = 0; u < VP; ++u) {
        const int pos = p0 + u;
        if (pos >= hi) break;
#pragma unroll
        for (int i = 0; i < kMaxHG; ++i) {
          const int g = g_first + i * hsplit;
          if (g < ng) acc[i] = fmaf(s_sh[g * S + pos], vv[u], acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxHG; ++i) {
      const int g = g_first + i * hsplit;
      if (g < ng) o[g * Dv + col] = from_float<QT>(acc[i]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *q2, *k2, *block_tables, *lengths;
  void* out;
  int B, Hkv, G, hg, Dk, D2, Dv, bs, n_pages, window;
  float scale;
  int scale_mul;
  float k_scale, v_scale;
  int round_scores, round_probs;
};

template <typename QT, typename KT, int DKL>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(a.hg) * (a.Dk + a.D2)
                       + static_cast<size_t>(a.hg) * a.n_pages * a.bs
                       + 2 * static_cast<size_t>(a.hg))
      + sizeof(int) * static_cast<size_t>(a.n_pages);
  auto kern = paged_decode_kernel<QT, KT, DKL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int n_groups = (a.G + a.hg - 1) / a.hg;
  const dim3 grid(a.Hkv * n_groups, a.B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), static_cast<const QT*>(a.q2),
      static_cast<const KT*>(a.k2),
      static_cast<const int32_t*>(a.block_tables),
      static_cast<const int32_t*>(a.lengths), static_cast<QT*>(a.out), a.Hkv,
      a.G, a.hg, a.Dk, a.D2, a.Dv, a.bs, a.n_pages, a.window, a.scale,
      a.scale_mul, a.k_scale, a.v_scale, a.round_scores, a.round_probs);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t dispatch_dk(const Args& a, cudaStream_t st) {
  return a.Dk <= 256 ? launch<QT, KT, 8>(a, st) : launch<QT, KT, 16>(a, st);
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const Args& a, cudaStream_t st) {
  switch (kv_dtype) {
    case 0:
      return dispatch_dk<QT, __nv_bfloat16>(a, st);
    case 1:
      return dispatch_dk<QT, float>(a, st);
    case 2:
      return dispatch_dk<QT, __nv_fp8_e4m3>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 bf16, 1 f32. kv_dtype: 0 bf16, 1 f32, 2 fp8 e4m3fn. v may be
// k itself (the MLA form, Dv == Dk); q2 / k2 may be null with D2 == 0.
// hg: query heads per block (1..8). scale_mul: 1 multiplies the scores by
// scale, 0 divides them. Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* q2,
    const void* k2, const void* block_tables, const void* lengths, void* out,
    int B, int Hkv, int G, int hg, int Dk, int D2, int Dv, int bs,
    int n_pages, int window, float scale, int scale_mul, float k_scale,
    float v_scale, int round_scores, int round_probs, int q_dtype,
    int kv_dtype, void* stream) {
  if (hg < 1 || hg > kMaxHG || Dk > 32 * kMaxDkPerLane
      || D2 > 32 * kMaxD2PerLane || Dv > kThreads
      || (D2 > 0 && (q2 == nullptr || k2 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, q2, k2, block_tables, lengths, out, B, Hkv, G, hg,
               Dk, D2, Dv, bs, n_pages, window, scale, scale_mul, k_scale,
               v_scale, round_scores, round_probs};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (q_dtype) {
    case 0:
      e = dispatch_kv<__nv_bfloat16>(kv_dtype, a, st);
      break;
    case 1:
      e = dispatch_kv<float>(kv_dtype, a, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
