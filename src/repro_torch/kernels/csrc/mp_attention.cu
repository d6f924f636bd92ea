// Mixed-precision flash attention for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/mp_attention.py, mp_flash_attention (Pallas
// TPU kernel _kernel: grid (B, H, q blocks, k blocks) with the key blocks
// innermost and sequential, the running max, denominator and context in
// VMEM scratch, fully masked causal blocks skipped with pl.when).
//
// What it computes, for each batch b, head h and query row i:
//   q = float(q) * sq, k = float(k) * sk, v = float(v) * sv   (dequant first)
//   keys walked in blocks of bk = min(block_k, S), in order; per block
//     s[j]   = (sum_d q[i,d] * k[j,d]) * scale,  scale = 1/sqrt(D)   (f32)
//              causal: s[j] = -1e30 where j > i (top-left aligned)
//     m_new  = max(m, max_j s[j])                  (m starts at -1e30)
//     p[j]   = exp(s[j] - m_new),  corr = exp(m - m_new)
//     l      = l * corr + sum_j p[j]               (the unrounded p)
//     p[j]   = e4m3(p[j])                          (only with quant_probs)
//     acc    = acc * corr + sum_j p[j] * v[j,:]
//   out[i,:] = out_dtype(acc / max(l, 1e-30))
// With quant_probs the probabilities are rounded against the running max
// of the keys seen so far, so the result depends on bk: the kernel walks
// exactly the reference's key blocks. The query tiling does not enter the
// result: a key block that is masked for every row of a query tile is a
// no-op once any earlier block held a live key (p = exp(-1e30 - m) = 0 and
// corr = 1), and block 0 holds key 0, live for every row, so skipping such
// blocks changes nothing. Any T and S: rows past T are not written, keys
// past S do not exist (the reference refuses T % block_q and S % block_k).
//
// Bound on this card: operations. The two products take 2 * B * H * T * S
// * (D + Dv) FLOPs without the mask, about half with it, at the 989 TFLOP/s
// bf16 tensor-core peak (1,979 for fp8 operands); the bytes (q, k, v read
// once, out written once) are far fewer. At the llama3_1b width (B=1, H=32,
// T=S=4096, D=64) the causal products are 68.7 GFLOP, 69 us at the peak.
//
// Design: one block of 256 threads per (64-query tile, head, batch). The
// tile's queries stay in shared memory as f32; each key block's scores
// (64 x bk f32) are computed 64 keys at a time from a shared-memory key
// tile, each thread owning a 4 x 4 patch of rows and keys. One warp per
// row then takes the block's max, the exponentials, the denominator and
// the e4m3 rounding in place. The context accumulates in registers, each
// thread owning 4 rows x (Dv / 16) columns, from value tiles staged in the
// same shared memory as the keys. Products run on the CUDA cores in f32:
// a simple first version. Tensor cores (bf16 operands are exact in a bf16
// mma; e4m3 probabilities too) and a pipelined TMA ring are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;           // query rows per block
constexpr int kBT = 64;           // keys per shared-memory tile
constexpr int kRows = kBQ / 16;   // rows per thread (16 x 16 thread grid)
constexpr int kCols = kBT / 16;   // score columns per thread
constexpr int kMaxD = 256;
constexpr float kNeg = -1e30f;    // the reference's finite NEG_INF

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__nv_fp8_e4m3>(
    __nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
template <> __device__ __forceinline__ float to_f<__nv_fp8_e5m2>(
    __nv_fp8_e5m2 x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// rows x cols of src (row stride src_ld elements) into dst (stride dst_ld)
// as f32 times s; rows at or past n_rows read zeros
template <typename T>
__device__ __forceinline__ void stage(float* dst, int dst_ld,
                                      const T* __restrict__ src, int src_ld,
                                      int n_rows, int rows, int cols,
                                      float s) {
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols, c = i - r * cols;
    dst[r * dst_ld + c] =
        r < n_rows ? to_f(src[static_cast<size_t>(r) * src_ld + c]) * s
                   : 0.f;
  }
}

// NC: context columns per thread, ceil(Dv / 16) rounded up to 4, 8 or 16
template <typename In, int NC>
__global__ void __launch_bounds__(kThreads)
mp_flash_kernel(const In* __restrict__ q, const In* __restrict__ k,
                const In* __restrict__ v, const float* __restrict__ sq,
                const float* __restrict__ sk, const float* __restrict__ sv,
                void* __restrict__ out, int out_bf16, int H, int T, int S,
                int D, int Dv, int bk, float scale, int causal,
                int quant_probs) {
  extern __shared__ float smem[];
  const int ldq = D + 1;                   // odd strides: conflict-free
  const int ldkv = max(D, Dv) + 1;
  const int lds = bk + 1;
  float* q_sh = smem;                      // kBQ x ldq
  float* kv_sh = q_sh + kBQ * ldq;         // kBT x ldkv (keys, then values)
  float* s_sh = kv_sh + kBT * ldkv;        // kBQ x lds (scores, then p)
  float* m_sh = s_sh + kBQ * lds;          // running max per row
  float* l_sh = m_sh + kBQ;                // running denominator per row
  float* c_sh = l_sh + kBQ;                // this block's correction

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const In* qb = q + bh * T * D;
  const In* kb = k + bh * S * D;
  const In* vb = v + bh * S * Dv;
  const float fsq = *sq, fsk = *sk, fsv = *sv;

  stage(q_sh, ldq, qb + static_cast<size_t>(q0) * D, D, T - q0, kBQ, D,
        fsq);
  for (int r = tid; r < kBQ; r += kThreads) {
    m_sh[r] = kNeg;
    l_sh[r] = 0.f;
  }
  float acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + kBQ, T) - 1;   // the tile's last real row
  for (int k0 = 0; k0 < S; k0 += bk) {
    if (causal && k0 > q_last) break;        // masked for every row: no-op
    const int kn = min(bk, S - k0);

    // scores of this key block, kBT keys at a time
    for (int t0 = 0; t0 < kn; t0 += kBT) {
      const int tn = min(kBT, kn - t0);
      __syncthreads();                       // kv_sh is free again
      stage(kv_sh, ldkv, kb + static_cast<size_t>(k0 + t0) * D, D, tn, kBT,
            D, fsk);
      __syncthreads();
      float sacc[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sacc[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float qv[kRows], kv[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) qv[i] = q_sh[(tr + 16 * i) * ldq + d];
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          kv[j] = kv_sh[(tc + 16 * j) * ldkv + d];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = tr + 16 * i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = tc + 16 * j;
          if (c < tn) {
            float s = sacc[i][j] * scale;
            if (causal && k0 + t0 + c > q0 + r) s = kNeg;
            s_sh[r * lds + t0 + c] = s;
          }
        }
      }
    }
    __syncthreads();

    // online softmax of the block, one warp per row
    for (int r = warp; r < kBQ; r += kWarps) {
      float* sr = s_sh + r * lds;
      float mx = kNeg;
      for (int c = lane; c < kn; c += 32) mx = fmaxf(mx, sr[c]);
      mx = warp_max(mx);
      const float m_prev = m_sh[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < kn; c += 32) {
        float p = expf(sr[c] - m_new);
        sum += p;
        if (quant_probs) p = static_cast<float>(__nv_fp8_e4m3(p));
        sr[c] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_sh[r] = l_sh[r] * corr + sum;
        m_sh[r] = m_new;
        c_sh[r] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float corr = c_sh[tr + 16 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= corr;
    }

    // context: acc += p @ v, kBT keys at a time
    for (int t0 = 0; t0 < kn; t0 += kBT) {
      const int tn = min(kBT, kn - t0);
      __syncthreads();
      stage(kv_sh, ldkv, vb + static_cast<size_t>(k0 + t0) * Dv, Dv, tn,
            kBT, Dv, fsv);
      __syncthreads();
      for (int c = 0; c < tn; ++c) {
        float pv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          pv[i] = s_sh[(tr + 16 * i) * lds + t0 + c];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int d = tc + 16 * j;
          if (d < Dv) {
            const float vv = kv_sh[c * ldkv + d];
#pragma unroll
            for (int i = 0; i < kRows; ++i)
              acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
          }
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = tr + 16 * i;
    if (q0 + r >= T) continue;
    const float l = fmaxf(l_sh[r], 1e-30f);
    const size_t row = (bh * T + q0 + r) * Dv;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d = tc + 16 * j;
      if (d >= Dv) continue;
      const float o = acc[i][j] / l;
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[row + d] = __float2bfloat16(o);
      else
        static_cast<float*>(out)[row + d] = o;
    }
  }
}

template <typename In, int NC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* sq, const void* sk, const void* sv, void* out,
                   int out_bf16, int B, int H, int T, int S, int D, int Dv,
                   int bk, float scale, int causal, int quant_probs,
                   size_t smem, cudaStream_t stream) {
  auto kern = mp_flash_kernel<In, NC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const In*>(q), static_cast<const In*>(k),
      static_cast<const In*>(v), static_cast<const float*>(sq),
      static_cast<const float*>(sk), static_cast<const float*>(sv), out,
      out_bf16, H, T, S, D, Dv, bk, scale, causal, quant_probs);
  return cudaGetLastError();
}

template <typename In>
cudaError_t dispatch_cols(const void* q, const void* k, const void* v,
                          const void* sq, const void* sk, const void* sv,
                          void* out, int out_bf16, int B, int H, int T, int S,
                          int D, int Dv, int bk, float scale, int causal,
                          int quant_probs, size_t smem, cudaStream_t st) {
  if (Dv <= 64)
    return launch<In, 4>(q, k, v, sq, sk, sv, out, out_bf16, B, H, T, S, D,
                        Dv, bk, scale, causal, quant_probs, smem, st);
  if (Dv <= 128)
    return launch<In, 8>(q, k, v, sq, sk, sv, out, out_bf16, B, H, T, S, D,
                        Dv, bk, scale, causal, quant_probs, smem, st);
  return launch<In, 16>(q, k, v, sq, sk, sv, out, out_bf16, B, H, T, S, D, Dv,
                       bk, scale, causal, quant_probs, smem, st);
}

}  // namespace

// Dynamic shared memory one block needs (the wrapper checks it first).
extern "C" size_t mp_flash_attention_smem(int D, int Dv, int bk) {
  const int ldkv = (D > Dv ? D : Dv) + 1;
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 1)
                          + static_cast<size_t>(kBT) * ldkv
                          + static_cast<size_t>(kBQ) * (bk + 1) + 3 * kBQ);
}

// in_dtype: 0 bf16, 1 f32, 2 fp8 e4m3fn, 3 fp8 e5m2 (q, k and v alike).
// sq/sk/sv: one f32 each in device memory. out: bf16 (out_bf16) or f32.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int mp_flash_attention_launch(
    const void* q, const void* k, const void* v, const void* sq,
    const void* sk, const void* sv, void* out, int out_bf16, int in_dtype,
    int B, int H, int T, int S, int D, int Dv, int bk, float scale,
    int causal, int quant_probs, void* stream) {
  if (D < 1 || D > kMaxD || Dv < 1 || Dv > kMaxD || bk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = mp_flash_attention_smem(D, Dv, bk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (in_dtype) {
    case 0:
      e = dispatch_cols<__nv_bfloat16>(q, k, v, sq, sk, sv, out, out_bf16, B,
                                       H, T, S, D, Dv, bk, scale, causal,
                                       quant_probs, smem, st);
      break;
    case 1:
      e = dispatch_cols<float>(q, k, v, sq, sk, sv, out, out_bf16, B, H, T,
                               S, D, Dv, bk, scale, causal, quant_probs, smem,
                               st);
      break;
    case 2:
      e = dispatch_cols<__nv_fp8_e4m3>(q, k, v, sq, sk, sv, out, out_bf16, B,
                                       H, T, S, D, Dv, bk, scale, causal,
                                       quant_probs, smem, st);
      break;
    case 3:
      e = dispatch_cols<__nv_fp8_e5m2>(q, k, v, sq, sk, sv, out, out_bf16, B,
                                       H, T, S, D, Dv, bk, scale, causal,
                                       quant_probs, smem, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
