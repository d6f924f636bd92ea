// Mixed-precision flash attention for Hopper, sm_90a: bf16 wgmma fed by a
// TMA ring, and a CUDA-core kernel for f32 operands.
//
// Replaces: src/repro/kernels/mp_attention.py, mp_flash_attention (Pallas
// TPU kernel _kernel: grid (B, H, q blocks, k blocks) with the key blocks
// innermost and sequential, the running max, denominator and context in
// VMEM scratch, fully masked causal blocks skipped with pl.when).
//
// What it computes, for each batch b, head h and query row i (the contract;
// ref.mp_flash_attention_plain repeats it step for step):
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
// The query tiling does not enter the result: a key block masked for every
// row of a query tile is a no-op once an earlier block held a live key (p =
// 0, corr = 1), and block 0 holds key 0, live for every row.
//
// Bound on this card: operations. The two products take 2 * B * H * T * S
// * (D + Dv) FLOPs without the mask, about half with it; the bytes (q, k, v
// read once, out written once) are far fewer. At the llama3_1b width (B=1,
// H=32, T=S=4096, D=64) the causal products are 68.7 GFLOP: 69.5 us at the
// 989 TFLOP/s bf16 tensor-core peak. fp8 operands run the same bf16 products
// (below), so their bound is the bf16 one too; at the fp8 peak it would be
// 34.7 us.
//
// Tensor-core kernel (bf16, e4m3 and e5m2 operands), FA3-shaped: one block
// per (query tile, batch x head), heaviest causal tiles first, with NC
// consumer warpgroups of 64 query rows each (NC = 3 while Dv <= 128, else
// 2: the context takes Dv / 2 registers a thread) and one producer
// warpgroup. The producer loads Q once, then K and V tiles of 64 keys
// through a ring of 2-12 shared-memory stages by TMA (3-D maps over (D, S,
// B*H), 128-byte swizzle, rows past S zero-filled), each stage guarded by a
// "full" and an "empty" mbarrier. Each consumer computes S = Q K^T by wgmma
// m64n64k16 (both operands K-major in shared memory), the online softmax in
// registers, then O += P V by wgmma m64nDVk16 with P from registers as bf16
// (the accumulator's register layout is the A operand's) and V from shared
// memory MN-major (V is Dv-contiguous; bf16 wgmma transposes it through the
// descriptor). Key tiles wholly above the causal diagonal of the block are
// never loaded; a consumer skips those above its own 64 rows. setmaxnreg
// moves registers from the producer to the consumers. D is padded to a
// multiple of 64 and Dv to DV in {64, 128, 192, 256} by TMA's zero fill,
// which leaves every product unchanged. What bounds it in practice
// (PERF.md): each warpgroup's serial chain of product, softmax and product
// per key tile, then the K and V tiles every query tile re-reads from L2.
//
// Numerics of the tensor-core route:
// 1. Dequant scales: sq*sk*scale multiplies the f32 scores after the
//    product, sv the context at the end: exact in real arithmetic, f32
//    rounding apart.
// 2. fp8 operands are widened to bf16 in shared memory by the producer
//    warpgroup (TMA into a staging ring, then a conversion pass) before any
//    wgmma; the widening is exact, both formats being subsets of bf16. fp8
//    wgmma is not used: its accumulator keeps fewer bits than f32, and it
//    cannot read an MN-major V.
// 3. f32 operands have no exact tensor-core route: they go to the CUDA-core
//    kernel at the end of this file (the wrapper dispatches on dtype).
// 4. P V takes p as bf16: with quant_probs p is e4m3 and exact in bf16;
//    without, the rounding costs at most 2^-9 max|v| per output.
// 5. The denominator sums the unrounded f32 p.
// 6. With quant_probs, p is rounded against the running max after each
//    whole block of bk keys, so a block of more than one 64-key tile takes
//    two passes over its tiles: the block's max first, then the scores
//    recomputed, p, l and P V. Without quant_probs every 64-key tile is its
//    own block, which changes the result by f32 rounding only.
// 7. Keys past S or past the end of the current block are absent: their
//    score is -inf, so they enter neither the max nor l, and p = 0 exactly.
//    Causally masked keys keep the reference's finite -1e30.
// 8. Any T and S, D and Dv <= 256 (row lengths a multiple of 16 elements;
//    the wrapper pads them); rows past T are not written.
// 9. TMA maps are built on the host per call and passed as __grid_constant__
//    parameters; the scales stay device pointers, so a launch can be
//    captured in a CUDA graph.
//
// CUDA-core kernel (f32 operands only): the first version of this port, one
// block of 256 threads per (64-query tile, head, batch), products as f32
// FMAs, the reference's key blocks walked exactly, a block's scores staged
// in shared memory (so block_k is bounded by shared memory).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxD = 256;
constexpr float kNeg = -1e30f;    // the reference's finite NEG_INF

// ------------------------------------------------------------------------
// tensor-core kernel
// ------------------------------------------------------------------------

// consumer warpgroups of 64 query rows each, one more for the producer:
// three while the context fits 152 registers a thread (Dv <= 128), else two
template <int DV> constexpr int consumers() { return DV <= 128 ? 3 : 2; }
constexpr int kBN = 64;           // keys per tile
constexpr int kMaxStages = 12;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[96],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
      "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
      "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
      "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
      "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
      "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
      "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
      "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
      "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
      "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
      "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
      "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special-function unit; results below 2^-126 flush to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 fp8 values (one 8-byte chunk) widened to 8 bf16 (one 16-byte chunk),
// two at a time through f16 (cvt.f16x2.e4m3x2 / e5m2x2); exact, both fp8
// formats being subsets of f16 and of bf16
template <int F8>
__device__ __forceinline__ uint4 widen8(uint2 raw) {
  const uint16_t* pairs = reinterpret_cast<const uint16_t*>(&raw);
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        pairs[i], F8 == 1 ? __NV_E4M3 : __NV_E5M2);
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
    o[i] = pack_bf16(f.x, f.y);
  }
  return out;
}

// rows x width fp8 bytes (row-major staging) into bf16 128-byte swizzled
// column slabs of rows x 64 elements each, by the producer's widening warps
constexpr int kWiden = 96;
template <int F8>
__device__ __forceinline__ void widen_tile(const uint8_t* stg, uint8_t* dst,
                                           int rows, int width, int tid) {
  const int chunks = width / 8;                  // 8-byte chunks per row
  for (int i = tid; i < rows * chunks; i += kWiden) {
    const int r = i / chunks, c = i - r * chunks;
    const uint2 raw = *reinterpret_cast<const uint2*>(stg + r * width + 8 * c);
    *reinterpret_cast<uint4*>(dst + (c >> 3) * rows * 128
                              + hopper::swizzle128(r, (c & 7) * 16)) =
        widen8<F8>(raw);
  }
}

template <int N>
__device__ __forceinline__ void fence_u32(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// x = Q K^T over NS 64-column slabs of D: 4 * NS wgmma m64n64k16, fully
// unrolled (a loop that carries the accumulator would make ptxas serialize
// the wgmmas), then committed
template <int NS, int BQ>
__device__ __forceinline__ void qk_mma(float (&x)[32], const uint8_t* q,
                                       const uint8_t* k) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NS; ++kk) {
    const int off = (kk & 3) * 32;              // 16 bf16 along D
    wgmma_ss_n64(x, hopper::smem_desc(q + (kk >> 2) * BQ * 128 + off, 16,
                                      1024),
                 hopper::smem_desc(k + (kk >> 2) * kBN * 128 + off, 16, 1024),
                 kk > 0);
  }
  hopper::wgmma_commit();
}

struct Params {
  int T, S, dv_out, dp, bk, stages, causal, quant_probs, out_bf16, n_qtiles;
  float qk_log2;                  // scale * log2(e); sq and sk join it
};

// Shared memory, from a 1024-byte aligned base: Q (bq x dp bf16, dp / 64
// slabs of bq x 128 bytes), the ring (stages x 64 x max(dp, DV) bf16), for
// fp8 the staging of Q (bq x dp bytes) and of the ring (stages x 64 x
// max(dp, DV) bytes), then the barriers.
struct Layout {
  int q, ring, slot, q_stg, ring_stg, slot_stg, bars, total;
  __host__ __device__ Layout(int bq, int dp, int DV, int stages, bool fp8) {
    const int w = dp > DV ? dp : DV;
    slot = kBN * w * 2;
    slot_stg = fp8 ? kBN * w : 0;
    q = 0;
    ring = q + bq * dp * 2;
    q_stg = ring + stages * slot;
    ring_stg = q_stg + (fp8 ? bq * dp : 0);
    bars = ring_stg + stages * slot_stg;
    total = bars + 512 + 1024;      // barriers, then the alignment slack
  }
};

// The key tiles of one query block in the order the producer loads them:
// keys [0, kend) in blocks of bke = block_k (quant_probs) or 64 (without);
// a block [b0, bend) whose live part [b0, tend) spans nt > 1 tiles is
// walked twice (K tiles for the max, then K and V tiles), a one-tile block
// once (K, V). fn(t0, is_v) is called once per tile load. The consumers
// walk the same order in mp_flash_wgmma_kernel.
template <typename Fn>
__device__ __forceinline__ void walk(const Params& p, int kend, Fn fn) {
  const int bke = p.quant_probs ? p.bk : kBN;
  for (int b0 = 0; b0 < kend; b0 += bke) {
    const int tend = min(min(b0 + bke, p.S), kend);
    const int nt = (tend - b0 + kBN - 1) / kBN;
    if (nt > 1)
      for (int i = 0; i < nt; ++i) fn(b0 + i * kBN, false);
    for (int i = 0; i < nt; ++i) {
      fn(b0 + i * kBN, false);
      fn(b0 + i * kBN, true);
    }
  }
}

template <int DV, int F8, int NC = consumers<DV>(), int BQ = 64 * NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
mp_flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const float* __restrict__ sq,
                      const float* __restrict__ sk,
                      const float* __restrict__ sv, void* __restrict__ out,
                      const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023))
                              & 1023);
  const Layout L(BQ, p.dp, DV, p.stages, F8 != 0);
  uint8_t* q_sh = smem + L.q;
  uint8_t* ring = smem + L.ring;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* q_full = bars;              // Q in shared memory, as bf16
  uint64_t* q_ld = bars + 1;            // fp8 Q staged by TMA
  uint64_t* full = bars + 2;            // a ring stage holds bf16 operands
  uint64_t* empty = full + kMaxStages;  // all consumer warps are done
  uint64_t* ld = empty + kMaxStages;    // fp8 staging landed
  uint64_t* stg_free = ld + kMaxStages; // fp8 staging widened, reusable
  const int wg = threadIdx.x >> 7;
  const int qt = p.n_qtiles - 1 - static_cast<int>(blockIdx.x);
  const int q0 = qt * BQ, bh = blockIdx.y;
  const int q_last = min(q0 + BQ, p.T) - 1;
  const int kend = p.causal ? min(p.S, q_last + 1) : p.S;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, F8 ? kWiden : 1);
    hopper::mbar_init(q_ld, 1);
    for (int s = 0; s < p.stages; ++s) {
      hopper::mbar_init(&full[s], F8 ? kWiden : 1);
      hopper::mbar_init(&empty[s], 4 * NC);   // the consumer warps
      hopper::mbar_init(&ld[s], 1);
      hopper::mbar_init(&stg_free[s], kWiden / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == NC) {
    // ------------------------------------------------------------ producer
    hopper::reg_dealloc<NC == 3 ? 48 : 40>();
    const int tid = threadIdx.x - 128 * NC;
    int n = 0;
    if constexpr (F8 == 0) {
      if (tid == 0) {
        hopper::mbar_arrive_expect_tx(q_full, BQ * p.dp * 2);
        for (int j = 0; j < p.dp / 64; ++j)
          hopper::tma_load_3d(q_sh + j * BQ * 128, &map_q, q_full, 64 * j,
                              q0, bh);
        walk(p, kend, [&](int t0, bool is_v) {
          const int s = n % p.stages, round = n / p.stages;
          if (round > 0) hopper::mbar_wait(&empty[s], (round - 1) & 1);
          const int w = is_v ? DV : p.dp;
          hopper::mbar_arrive_expect_tx(&full[s], kBN * w * 2);
          for (int j = 0; j < w / 64; ++j)
            hopper::tma_load_3d(ring + s * L.slot + j * kBN * 128,
                                is_v ? &map_v : &map_k, &full[s], 64 * j,
                                t0, bh);
          ++n;
        });
      }
    } else {
      // fp8: thread 0 keeps TMA loads of the fp8 tiles in flight through a
      // staging ring of its own; warps 1-3 widen each staged tile to bf16
      // in its ring slot once the consumers have released that slot, then
      // free the staging slot. Neither side waits on the other's progress
      // beyond the two rings, so the loads run up to `stages` tiles ahead.
      uint8_t* q_stg = smem + L.q_stg;
      uint8_t* ring_stg = smem + L.ring_stg;
      if (tid == 0) {
        hopper::mbar_arrive_expect_tx(q_ld, BQ * p.dp);
        hopper::tma_load_3d(q_stg, &map_q, q_ld, 0, q0, bh);
        walk(p, kend, [&](int t0, bool is_v) {
          const int s = n % p.stages, round = n / p.stages;
          if (round > 0) hopper::mbar_wait(&stg_free[s], (round - 1) & 1);
          hopper::mbar_arrive_expect_tx(&ld[s], kBN * (is_v ? DV : p.dp));
          hopper::tma_load_3d(ring_stg + s * L.slot_stg,
                              is_v ? &map_v : &map_k, &ld[s], 0, t0, bh);
          ++n;
        });
      } else if (tid >= 32) {
        const int wtid = tid - 32;
        hopper::mbar_wait(q_ld, 0);
        widen_tile<F8>(q_stg, q_sh, BQ, p.dp, wtid);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(q_full);
        walk(p, kend, [&](int, bool is_v) {
          const int s = n % p.stages, round = n / p.stages;
          hopper::mbar_wait(&ld[s], round & 1);
          if (round > 0) hopper::mbar_wait(&empty[s], (round - 1) & 1);
          widen_tile<F8>(ring_stg + s * L.slot_stg, ring + s * L.slot, kBN,
                         is_v ? DV : p.dp, wtid);
          hopper::fence_proxy_async();
          hopper::mbar_arrive(&full[s]);
          __syncwarp();
          if ((tid & 31) == 0) hopper::mbar_arrive(&stg_free[s]);
          ++n;
        });
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    hopper::reg_alloc<NC == 3 ? 152 : 232>();
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
    const int t4 = lane & 3;
    // register j of a 64-row accumulator holds row row0 + 8 * ((j / 2) % 2)
    // and column 8 * (j / 4) + 2 * (lane % 4) + j % 2
    const int row0 = q0 + wg * 64 + w * 16 + (lane >> 2);
    const int wg_first = q0 + wg * 64, wg_last = wg_first + 63;
    const float qk = p.qk_log2 * sq[0] * sk[0];
    const uint8_t* q_wg = q_sh + wg * 64 * 128;
    float o[DV / 2], x[32];
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.f;
    hopper::mbar_wait(q_full, 0);

    // loads are numbered in the producer's order (walk); a slot is waited
    // for and released by number
    auto acquire = [&](int i) -> const uint8_t* {
      const int s = i % p.stages;
      hopper::mbar_wait(&full[s], (i / p.stages) & 1);
      return ring + s * L.slot;
    };
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[i % p.stages]);
    };
    auto issue_qk = [&](const uint8_t* slot) {      // x = Q K^T, committed
      hopper::fence_regs(x);
      switch (p.dp / 64) {          // a straight run of wgmmas per case
        case 1: qk_mma<1, BQ>(x, q_wg, slot); break;
        case 2: qk_mma<2, BQ>(x, q_wg, slot); break;
        case 3: qk_mma<3, BQ>(x, q_wg, slot); break;
        default: qk_mma<4, BQ>(x, q_wg, slot); break;
      }
    };
    // x scaled into the log2 domain, absent keys -inf, causally masked
    // ones -1e30
    auto mask_scores = [&](int t0, int bend) {
      hopper::fence_regs(x);
      const bool edge = t0 + kBN > bend ||
                        (p.causal && t0 + kBN - 1 > wg_first);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float v = x[j] * qk;
        if (edge) {
          const int key = t0 + 8 * (j >> 2) + 2 * t4 + (j & 1);
          if (key >= bend) v = -INFINITY;
          else if (p.causal && key > row0 + 8 * ((j >> 1) & 1)) v = kNeg;
        }
        x[j] = v;
      }
    };
    auto row_max = [&](float (&mx)[2]) {
      float part[2][4];                 // four short chains a row
#pragma unroll
      for (int j = 0; j < 8; ++j) part[j >> 2][j & 3] = -INFINITY;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        part[(j >> 1) & 1][(j >> 2) & 3] =
            fmaxf(part[(j >> 1) & 1][(j >> 2) & 3], x[j]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], fmaxf(fmaxf(part[h][0], part[h][1]),
                                   fmaxf(part[h][2], part[h][3])));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      }
    };
    // a new block's max: the running max moves, corr = exp(m_old - m_new)
    // rescales the denominator now and is returned for the context
    auto new_max = [&](const float (&mx)[2], float (&corr)[2]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], mx[h]);
        corr[h] = ex2(m[h] - m_new);
        m[h] = m_new;
        l[h] *= corr[h];
      }
    };
    auto rescale_o = [&](const float (&corr)[2]) {
#pragma unroll
      for (int j = 0; j < DV / 2; ++j) o[j] *= corr[(j >> 1) & 1];
    };
    // p from x against the running max; l sums it unrounded; P as the bf16
    // A operand of P V (the accumulator's layout is the A fragment's)
    uint32_t a[4][4];
    auto make_p = [&]() {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float pr = ex2(x[j] - m[(j >> 1) & 1]);
        l[(j >> 1) & 1] += pr;
        if (p.quant_probs) pr = static_cast<float>(__nv_fp8_e4m3(pr));
        x[j] = pr;
      }
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          a[kc][r] = pack_bf16(x[8 * kc + 2 * r], x[8 * kc + 2 * r + 1]);
    };
    auto issue_pv = [&](const uint8_t* slot) {      // O += P V, committed
      hopper::fence_regs(o);
      fence_u32(a);
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)            // 16 keys at a time
        wgmma_rs(o, a[kc],
                 hopper::smem_desc(slot + kc * 16 * 128, kBN * 128, 1024));
      hopper::wgmma_commit();
    };
    auto pv_done = [&]() {
      hopper::fence_regs(o);
      fence_u32(a);
    };

    if (!p.quant_probs) {
      // Every 64-key tile is its own block (the result changes by f32
      // rounding only); loads K0 V0 K1 V1 ... Tiles past this warpgroup's
      // causal limit are a no-op for its rows and only released. This
      // loop, apart from the block loop below, and Q K^T not issued beside
      // the last P V (ptxas then serializes the wgmmas, C7514) both
      // measured faster (PERF.md).
      const int nt = (kend + kBN - 1) / kBN;
      const int nt_live = p.causal ? min(nt, wg_last / kBN + 1) : nt;
      float mx[2], corr[2];
      for (int t = 0; t < nt_live; ++t) {
        const int t0 = t * kBN;
        issue_qk(acquire(2 * t));
        hopper::wgmma_wait<0>();
        release(2 * t);
        mask_scores(t0, min(t0 + kBN, p.S));
        mx[0] = mx[1] = -INFINITY;
        row_max(mx);
        new_max(mx, corr);
        rescale_o(corr);
        make_p();
        issue_pv(acquire(2 * t + 1));
        hopper::wgmma_wait<0>();
        pv_done();
        release(2 * t + 1);
      }
      for (int i = 2 * nt_live; i < 2 * nt; ++i) {
        acquire(i);
        release(i);
      }
    } else {
      // quant_probs: the reference's key blocks (the e4m3 rounding of p
      // depends on them). A block of more than one tile walks its K tiles
      // for the block's max first, then K and V; tiles past this
      // warpgroup's causal limit are only released.
      int n = 0;
      const int bke = p.bk;
      for (int b0 = 0; b0 < kend; b0 += bke) {
        const int bend = min(b0 + bke, p.S);
        const int nt = (min(bend, kend) - b0 + kBN - 1) / kBN;
        float mx[2] = {-INFINITY, -INFINITY}, corr[2];
        if (nt > 1) {
          for (int i = 0; i < nt; ++i, ++n) {
            const int t0 = b0 + i * kBN;
            const uint8_t* slot = acquire(n);
            if (!p.causal || t0 <= wg_last) {
              issue_qk(slot);
              hopper::wgmma_wait<0>();
              mask_scores(t0, bend);
              row_max(mx);
            }
            release(n);
          }
          new_max(mx, corr);
          rescale_o(corr);
        }
        for (int i = 0; i < nt; ++i, n += 2) {
          const int t0 = b0 + i * kBN;
          const bool live = !p.causal || t0 <= wg_last;
          const uint8_t* slot = acquire(n);
          if (live) {
            issue_qk(slot);
            hopper::wgmma_wait<0>();
            mask_scores(t0, bend);
            if (nt == 1) {
              row_max(mx);
              new_max(mx, corr);
              rescale_o(corr);
            }
          }
          release(n);
          slot = acquire(n + 1);
          if (live) {
            make_p();
            issue_pv(slot);
            hopper::wgmma_wait<0>();
            pv_done();
          }
          release(n + 1);
        }
      }
    }

    // out = O * sv / max(l, 1e-30), the 4 lanes of a row summed first
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      inv[h] = sv[0] / fmaxf(l[h], 1e-30f);
    }
    const bool vec = (p.dv_out & 1) == 0;
#pragma unroll
    for (int j = 0; j < DV / 2; j += 2) {
      const int r = row0 + 8 * ((j >> 1) & 1);
      const int c = 8 * (j >> 2) + 2 * t4;
      if (r >= p.T || c >= p.dv_out) continue;
      const float a = o[j] * inv[(j >> 1) & 1];
      const float b = o[j + 1] * inv[(j >> 1) & 1];
      const bool two = c + 1 < p.dv_out;
      const size_t at = (static_cast<size_t>(bh) * p.T + r) * p.dv_out + c;
      if (p.out_bf16) {
        __nv_bfloat16* y = static_cast<__nv_bfloat16*>(out) + at;
        if (two && vec) {
          *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(a, b);
        } else {
          y[0] = __float2bfloat16_rn(a);
          if (two) y[1] = __float2bfloat16_rn(b);
        }
      } else {
        float* y = static_cast<float*>(out) + at;
        if (two && vec) {
          *reinterpret_cast<float2*>(y) = make_float2(a, b);
        } else {
          y[0] = a;
          if (two) y[1] = b;
        }
      }
    }
  }
}

// ------------------------------------------------------------------------
// CUDA-core kernel, f32 operands
// ------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;           // query rows per block
constexpr int kBT = 64;           // keys per shared-memory tile
constexpr int kRows = kBQ / 16;   // rows per thread (16 x 16 thread grid)
constexpr int kCols = kBT / 16;   // score columns per thread

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
// times s; rows at or past n_rows read zeros
__device__ __forceinline__ void stage(float* dst, int dst_ld,
                                      const float* __restrict__ src,
                                      int src_ld,
                                      int n_rows, int rows, int cols,
                                      float s) {
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols, c = i - r * cols;
    dst[r * dst_ld + c] =
        r < n_rows ? src[static_cast<size_t>(r) * src_ld + c] * s
                   : 0.f;
  }
}

// NC: context columns per thread, ceil(Dv / 16) rounded up to 4, 8 or 16
template <int NC>
__global__ void __launch_bounds__(kThreads)
mp_flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ sq,
    const float* __restrict__ sk, const float* __restrict__ sv,
    void* __restrict__ out, int out_bf16, int H, int T, int S, int D, int Dv,
    int bk, float scale, int causal, int quant_probs) {
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
  const float* qb = q + bh * T * D;
  const float* kb = k + bh * S * D;
  const float* vb = v + bh * S * Dv;
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

// ------------------------------------------------------------------------
// launches
// ------------------------------------------------------------------------

template <int NC>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       const float* sq, const float* sk, const float* sv,
                       void* out, int out_bf16, int B, int H, int T, int S,
                       int D, int Dv, int bk, float scale, int causal,
                       int quant_probs, size_t smem, cudaStream_t stream) {
  auto kern = mp_flash_attention_f32_kernel<NC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, sq, sk, sv, out, out_bf16,
                                         H, T, S, D, Dv, bk, scale, causal,
                                         quant_probs);
  return cudaGetLastError();
}

size_t f32_smem(int D, int Dv, int bk) {
  const int ldkv = (D > Dv ? D : Dv) + 1;
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 1)
                          + static_cast<size_t>(kBT) * ldkv
                          + static_cast<size_t>(kBQ) * (bk + 1) + 3 * kBQ);
}

// a (B*H, rows, cols) row-major tensor cut into (box_rows, box_cols) boxes;
// bf16 boxes land 128-byte swizzled (wgmma's layout), fp8 ones plain
int attn_map(CUtensorMap* map, const void* p, bool fp8, int cols, int rows,
             int bh, int box_cols, int box_rows) {
  const uint64_t eb = fp8 ? 1 : 2;
  const uint64_t dims[3] = {static_cast<uint64_t>(cols),
                            static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(bh)};
  const uint64_t strides[2] = {cols * eb, static_cast<uint64_t>(rows) * cols
                                              * eb};
  const uint32_t box[3] = {static_cast<uint32_t>(box_cols),
                           static_cast<uint32_t>(box_rows), 1};
  return hopper::make_map(map, p, fp8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          3, dims, strides, box, !fp8);
}

template <int DV, int F8>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const float* sq, const float* sk, const float* sv,
                      void* out, Params p, int BH, int D, int Dv,
                      cudaStream_t stream) {
  constexpr bool fp8 = F8 != 0;
  CUtensorMap mq, mk, mv;
  constexpr int NC = consumers<DV>(), BQ = 64 * NC;
  p.n_qtiles = (p.T + BQ - 1) / BQ;
  int rc = attn_map(&mq, q, fp8, D, p.T, BH, fp8 ? p.dp : 64, BQ);
  if (rc == 0) rc = attn_map(&mk, k, fp8, D, p.S, BH, fp8 ? p.dp : 64, kBN);
  if (rc == 0) rc = attn_map(&mv, v, fp8, Dv, p.S, BH, fp8 ? DV : 64, kBN);
  if (rc != 0) return static_cast<cudaError_t>(rc);
  constexpr int kMaxSmem = 227 * 1024;
  int stages = kMaxStages;
  while (stages > 2 && Layout(BQ, p.dp, DV, stages, fp8).total > kMaxSmem)
    --stages;
  const int smem = Layout(BQ, p.dp, DV, stages, fp8).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  p.stages = stages;
  auto kern = mp_flash_wgmma_kernel<DV, F8>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.n_qtiles, BH);
  kern<<<grid, 128 * (NC + 1), smem, stream>>>(mq, mk, mv, sq, sk, sv, out, p);
  return cudaGetLastError();
}

template <int F8>
cudaError_t dispatch_dv(const void* q, const void* k, const void* v,
                        const float* sq, const float* sk, const float* sv,
                        void* out, const Params& p, int BH, int D, int Dv,
                        cudaStream_t st) {
  if (Dv <= 64)
    return launch_tc<64, F8>(q, k, v, sq, sk, sv, out, p, BH, D, Dv, st);
  if (Dv <= 128)
    return launch_tc<128, F8>(q, k, v, sq, sk, sv, out, p, BH, D, Dv, st);
  if (Dv <= 192)
    return launch_tc<192, F8>(q, k, v, sq, sk, sv, out, p, BH, D, Dv, st);
  return launch_tc<256, F8>(q, k, v, sq, sk, sv, out, p, BH, D, Dv, st);
}

}  // namespace

// Tensor-core route. in_dtype: 0 bf16, 2 fp8 e4m3fn, 3 fp8 e5m2 (q, k and v
// alike). D and Dv are the row lengths of q/k and v, multiples of 16 up to
// 256; out is (B, H, T, dv_out) with dv_out <= Dv, bf16 (out_bf16) or f32.
// Pointers 16-byte aligned; sq/sk/sv one f32 each in device memory; scale
// the score multiplier 1/sqrt(D) of the unpadded D. Returns the cudaError_t
// of the launch (0 = launched).
extern "C" int mp_flash_attention_launch(
    const void* q, const void* k, const void* v, const void* sq,
    const void* sk, const void* sv, void* out, int out_bf16, int in_dtype,
    int B, int H, int T, int S, int D, int Dv, int dv_out, int bk,
    float scale, int causal, int quant_probs, void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q)
                         | reinterpret_cast<uintptr_t>(k)
                         | reinterpret_cast<uintptr_t>(v);
  if (D < 16 || D > kMaxD || D % 16 || Dv < 16 || Dv > kMaxD || Dv % 16 ||
      dv_out < 1 || dv_out > Dv || bk < 1 || T < 1 || S < 1 || (addr & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.T = T;
  p.S = S;
  p.dv_out = dv_out;
  p.dp = (D + 63) / 64 * 64;
  p.bk = bk;
  p.stages = 0;
  p.causal = causal;
  p.quant_probs = quant_probs;
  p.out_bf16 = out_bf16;
  p.n_qtiles = 0;                   // set per query tile by launch_tc
  p.qk_log2 = scale * kLog2e;
  const float* fsq = static_cast<const float*>(sq);
  const float* fsk = static_cast<const float*>(sk);
  const float* fsv = static_cast<const float*>(sv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (in_dtype) {
    case 0:
      e = dispatch_dv<0>(q, k, v, fsq, fsk, fsv, out, p, B * H, D, Dv, st);
      break;
    case 2:
      e = dispatch_dv<1>(q, k, v, fsq, fsk, fsv, out, p, B * H, D, Dv, st);
      break;
    case 3:
      e = dispatch_dv<2>(q, k, v, fsq, fsk, fsv, out, p, B * H, D, Dv, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// CUDA-core route, f32 operands: dynamic shared memory one block needs (the
// wrapper checks it first), and the launch.
extern "C" size_t mp_flash_attention_f32_smem(int D, int Dv, int bk) {
  return f32_smem(D, Dv, bk);
}

extern "C" int mp_flash_attention_f32_launch(
    const void* q, const void* k, const void* v, const void* sq,
    const void* sk, const void* sv, void* out, int out_bf16, int B, int H,
    int T, int S, int D, int Dv, int bk, float scale, int causal,
    int quant_probs, void* stream) {
  if (D < 1 || D > kMaxD || Dv < 1 || Dv > kMaxD || bk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = f32_smem(D, Dv, bk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* a = static_cast<const float*>(sq);
  const float* b = static_cast<const float*>(sk);
  const float* c = static_cast<const float*>(sv);
  cudaError_t e;
  if (Dv <= 64)
    e = launch_f32<4>(fq, fk, fv, a, b, c, out, out_bf16, B, H, T, S, D, Dv,
                      bk, scale, causal, quant_probs, smem, st);
  else if (Dv <= 128)
    e = launch_f32<8>(fq, fk, fv, a, b, c, out, out_bf16, B, H, T, S, D, Dv,
                      bk, scale, causal, quant_probs, smem, st);
  else
    e = launch_f32<16>(fq, fk, fv, a, b, c, out, out_bf16, B, H, T, S, D, Dv,
                       bk, scale, causal, quant_probs, smem, st);
  return static_cast<int>(e);
}
