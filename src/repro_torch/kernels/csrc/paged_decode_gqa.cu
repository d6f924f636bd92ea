// Paged single-query decode attention for Hopper, sm_90a: the GQA form on
// the tensor cores (bf16 queries, bf16 or fp8-e4m3 K/V, Dk == Dv a multiple
// of 16 up to 256, up to 8 query heads per KV head and block).
//
// Replaces: src/repro/kernels/paged_attention.py, paged_decode_attention
// (Pallas TPU kernel _kernel / _call), GQA form: per-tensor k_scale /
// v_scale, a static integer window, scores and probabilities rounded to
// bf16. The MLA form and f32 queries stay in csrc/paged_attention.cu.
//
// What it computes, per decode row b, KV head h and query head g:
//   live keys  lo <= pos < hi,  lo = max(0, len - window), hi = min(len, S)
//   s[g,pos]   = round_bf16(sum_d q[g,d] * deq(k[pos,d]))   (f32 sums)
//                then / scale ("div") or * scale ("mul"), in f32
//   p[g,pos]   = round_bf16(exp(s - m[g]) / l[g])   with the FINAL row max
//                m and denominator l (exact two-phase softmax, no online
//                rescaling)
//   out[g,d]   = round_bf16(sum_pos p[g,pos] * deq(v[pos,d]))  (f32 sums)
// deq(x) = round_bf16(float(x) * scale): a unit scale is a plain upcast.
// Rows with len == 0 (or an empty window) write zeros.
//
// Bound on this card: the live K and V bytes, sum_b live_b * Hkv * 2 * D *
// elem_bytes, at 3.35 TB/s, plus q, the tables and the output. At the
// serving shape (B 4, Hkv 8, G 4, D 64, block 16, 136-160 keys a row) that
// is 1.2 MB, 0.37 us: far below what one dependent device-memory round trip
// costs. So the kernel is bound by latency there, and the design is about
// paying the memory latency as few times as possible:
//
// * One block of 8 warps per (row, KV head, group of up to 8 query heads).
//   The row's table entries, its length and the group's queries are loaded
//   together; then every warp issues all of its K and V copies at once.
// * Keys go in chunks of 128, one 16-key tile per warp. Each warp stages its
//   own tiles (K chunks first, then V chunks) into its rows of a ring of up
//   to 12 shared-memory slots with 16-byte cp.async.cg, one commit group per
//   slot, so up to 12 tiles per warp are in flight and a short table is in
//   flight whole. cp.async and not TMA: the rows of a page are gathered
//   through the block table one by one, a row may start or end anywhere
//   (the window, the length), and cp.async's source size of 0 zero-fills
//   every slot outside [lo, hi) for free; a TMA box would bring stale rows
//   that a second pass would have to clear. Slots below the window are never
//   staged (the first chunk starts at lo) and the tail past hi is
//   zero-filled, so NaN left in a live page's stale slots never reaches a
//   product (0 x NaN).
// * Because a warp reads only the rows it staged, the K and V loops need no
//   block barrier: cp.async.wait_group and __syncwarp. Only the softmax's
//   max and denominator (two barriers) and the final sum of the warps'
//   contexts (two barriers) cross warps.
// * Phase 0, scores: mma.sync.m16n8k16 bf16 -> f32 with the 16-key K tile as
//   A (ldmatrix) and the queries as B (n = 8 heads, held in registers for
//   the whole call). Taking K as the 16-row operand wastes no rows; the
//   heads fill 8 columns (4 of them at G 4). fp8 K (or a non-unit scale) is
//   widened to bf16 with k_scale in shared memory, in the warp's own rows,
//   before the product.
// * Phase 1, softmax: each warp takes the max (over the bf16 sums, scaled
//   once) and the sum of exp over its own keys, one head at a time across
//   all 32 lanes; the partials are combined in warp order (no atomics, so a
//   call is deterministic), and p is written as bf16 over the scores.
// * Phase 2, context: out^T = V^T P^T, again m16n8k16, V tiles by
//   ldmatrix.trans as A (16 value columns a product), P from shared memory
//   as B. Every warp works on its own key tiles; the per-warp f32 partials
//   are summed in warp order through shared memory.
// Scores and probabilities live in shared memory as bf16 over the whole
// table width (the score is the bf16 rounding of the sum; the division by
// the scale is redone, identically, where it is read), so a table of up to
// 86,688 keys at D 64 (72,128 at D 128) fits with one head a block.
//
// Measured on an H100 (paged_kernel_sweep.py, chip_smoke.py; numbers in
// PERF.md): at the serving shape the time is set by the chain set-up ->
// copies landed -> scores -> softmax -> context, about 1.7 + 1.7 + 0.7 +
// 1.2 + 1.7 us; one head a block is the fastest group there. At a long
// table (2048 keys a row) the K/V bytes, read once per head group through
// L2, set it instead.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;                   // keys of one mma tile
constexpr int kChunk = kTile * kWarps;      // keys of one ring slot
constexpr int kMaxHG = 8;                   // query heads of a block (mma N)
constexpr int kMaxSlots = 12;
constexpr float kNeg = -3.402823466e+38f;   // finfo(float32).min

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n of this thread's commit groups are pending
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 11: cp_async_wait<11>(); break;
    case 10: cp_async_wait<10>(); break;
    case 9: cp_async_wait<9>(); break;
    case 8: cp_async_wait<8>(); break;
    case 7: cp_async_wait<7>(); break;
    case 6: cp_async_wait<6>(); break;
    case 5: cp_async_wait<5>(); break;
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 -> f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float deq_fp8(uint8_t x, float scale) {
  __nv_fp8_e4m3 f;
  f.__x = x;
  return static_cast<float>(f) * scale;
}

// deq of the warp's 16 staged rows, in place: fp8 rows (raw_ld bytes a row,
// packed at the start of the region) become bf16 rows of ld elements; bf16
// rows are multiplied by a non-unit scale. All raw bytes are read into
// registers before any widened byte is written, since the two layouts
// overlap.
template <typename KT, int KS>
__device__ __forceinline__ void widen_rows(uint8_t* rows, int D, int ld,
                                           int raw_ld, float scale,
                                           int lane) {
  if constexpr (sizeof(KT) == 1) {
    constexpr int kPer = (KS + 1) / 2;        // 16 raw bytes a piece
    const int per_row = D / 16, pieces = 16 * per_row;
    uint4 raw[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = lane + 32 * u;
      if (e < pieces) {
        const int r = e / per_row, c = e - r * per_row;
        raw[u] = *reinterpret_cast<const uint4*>(rows + r * raw_ld + 16 * c);
      }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = lane + 32 * u;
      if (e < pieces) {
        const int r = e / per_row, c = e - r * per_row;
        const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw[u]);
        uint32_t w[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          w[j] = pack_bf16(deq_fp8(b[2 * j], scale),
                           deq_fp8(b[2 * j + 1], scale));
        uint4* dst = reinterpret_cast<uint4*>(rows + r * 2 * ld + 32 * c);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
    }
  } else {
    const int per_row = D / 8, pieces = 16 * per_row;   // 8 bf16 a piece
    for (int e = lane; e < pieces; e += 32) {
      const int r = e / per_row, c = e - r * per_row;
      uint4* p = reinterpret_cast<uint4*>(rows + r * 2 * ld + 16 * c);
      uint4 x = *p;
      uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[j]);
        w[j] = pack_bf16(__bfloat162float(h.x) * scale,
                         __bfloat162float(h.y) * scale);
      }
      *p = x;
    }
  }
  __syncwarp();
}

// KS: 16-wide steps of D the registers are sized for (D <= 16 * KS).
template <typename KT, int KS>
__global__ void __launch_bounds__(kThreads, 1)
paged_decode_gqa_kernel(const __nv_bfloat16* __restrict__ q,
                        const KT* __restrict__ k, const KT* __restrict__ v,
                        const int32_t* __restrict__ block_tables,
                        const int32_t* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out, int Hkv, int G,
                        int hg, int D, int bs, int n_pages, int window,
                        int n_slots, float scale, int scale_mul,
                        float k_scale, float v_scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr bool kFp8 = sizeof(KT) == 1;
  const int S = n_pages * bs, SP = (S + 7) & ~7;
  const int ld = D + 8;                       // bf16 row stride (elements)
  const int raw_ld = D + 16;                  // fp8 row stride (bytes)
  const int slot_bytes = kChunk * 2 * ld;
  // layout (the caller sizes it: kernels/paged_attention.py, _gqa_smem):
  // ring | scores (hg x SP bf16) | table row | warp partials
  uint8_t* ring = smem;
  __nv_bfloat16* s_sh =
      reinterpret_cast<__nv_bfloat16*>(ring + n_slots * slot_bytes);
  int* blk_sh = reinterpret_cast<int*>(s_sh + hg * SP);
  float* red_m = reinterpret_cast<float*>(blk_sh + n_pages);   // kWarps x 8
  float* red_l = red_m + kWarps * kMaxHG;                      // kWarps x 8
  float* red_o = reinterpret_cast<float*>(ring);   // kWarps x 8 x D, at the end

  const int n_groups = (G + hg - 1) / hg;
  const int h = blockIdx.x / n_groups, g0 = (blockIdx.x % n_groups) * hg;
  const int b = blockIdx.y;
  const int ng = min(hg, G - g0);             // heads of this block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, cq = lane & 3;    // mma fragment row / column
  const size_t head0 = (static_cast<size_t>(b) * Hkv + h) * G + g0;

  // set-up: the length, the table row and the queries, loaded together.
  // Every entry is read; only those of live pages are followed.
  const int len = lengths[b];
  for (int j = tid; j < n_pages; j += kThreads)
    blk_sh[j] = max(block_tables[static_cast<size_t>(b) * n_pages + j], 0);
  // queries as the mma's B operand: column n = head gq, rows k = d
  uint32_t qf[KS][2];
  {
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
        q + (head0 + min(gq, ng - 1)) * D);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const bool ok = gq < ng && 16 * ks < D;
      qf[ks][0] = ok ? qrow[8 * ks + cq] : 0u;
      qf[ks][1] = ok ? qrow[8 * ks + 4 + cq] : 0u;
    }
  }
  __syncthreads();

  __nv_bfloat16* o = out + head0 * D;
  const int hi = min(len, S);
  const int lo = max(0, len - window);
  if (len <= 0 || lo >= hi) {                 // nothing live: zeros
    for (int i = tid; i < ng * D; i += kThreads) o[i] = __float2bfloat16(0.f);
    return;
  }
  const int n_live = hi - lo;
  const int nck = (n_live + kChunk - 1) / kChunk;
  const int row_bytes = D * static_cast<int>(sizeof(KT));
  const int parts = row_bytes / 16;
  const int dst_ld = kFp8 ? raw_ld : 2 * ld;

  // load i of this warp (K chunks 0..nck-1, then V chunks) into its 16 rows
  // of ring slot `slot`; one commit group per load, empty past the end. Two
  // lanes a row: each finds its row's source once (one division, one table
  // entry) and issues every other 16-byte piece of it, all unrolled, so the
  // copies leave back to back.
  const int my_row = lane >> 1, my_part = lane & 1;
  auto issue = [&](int i, int slot) {
    if (i < 2 * nck) {
      const bool is_v = i >= nck;
      const int t0 = (is_v ? i - nck : i) * kChunk + kTile * warp;
      if (t0 < n_live) {
        const int pos = lo + t0 + my_row;
        const uint8_t* src = reinterpret_cast<const uint8_t*>(is_v ? v : k);
        int nbytes = 0;
        if (pos < hi) {
          const int page = pos / bs;
          src += ((static_cast<size_t>(blk_sh[page]) * bs + (pos - page * bs))
                      * Hkv + h) * row_bytes;
          nbytes = 16;
        }
        uint8_t* dst = ring + slot * slot_bytes + kTile * warp * 2 * ld
                       + my_row * dst_ld;
#pragma unroll
        for (int u = 0; u < KS; ++u) {
          const int part = my_part + 2 * u;
          if (part < parts)
            cp_async16(dst + 16 * part, src + (nbytes ? 16 * part : 0),
                       nbytes);
        }
      }
    }
    cp_async_commit();
  };
  // the warp's 16 bf16 rows in ring slot `slot`, widened first where needed
  auto tile = [&](int slot, float sc) {
    uint8_t* rows = ring + slot * slot_bytes + kTile * warp * 2 * ld;
    if (kFp8 || sc != 1.0f) widen_rows<KT, KS>(rows, D, ld, raw_ld, sc, lane);
    return reinterpret_cast<const __nv_bfloat16*>(rows);
  };

  for (int i = 0; i < n_slots; ++i) issue(i, i);
  int slot = 0;                               // the slot of the next load

  // phase 0: masked scores, each warp its own 16-key tiles. The row max is
  // taken over the bf16 sums (largest and smallest, heads 2cq and 2cq + 1):
  // the scale is applied once to the winner, as dividing or multiplying
  // by it is monotone (decreasing for a negative scale)
  float hi_s[2] = {kNeg, kNeg}, lo_s[2] = {-kNeg, -kNeg};
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;   // ldmatrix row
  const int lcol = (lane >> 4) * 8;                      // ldmatrix column
  for (int i = 0; i < nck; ++i) {
    cp_async_wait_dyn(n_slots - 1);
    __syncwarp();
    const int t0 = i * kChunk + kTile * warp;
    if (t0 < n_live) {
      const __nv_bfloat16* kt = tile(slot, k_scale);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (16 * ks < D) {
          uint32_t a[4];
          ldsm_x4(a, kt + lrow * ld + 16 * ks + lcol);
          mma_bf16(c, a, qf[ks][0], qf[ks][1]);
        }
      }
      // c: keys gq, gq + 8 (rows) x heads 2cq, 2cq + 1 (columns)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = t0 + gq + (e >> 1) * 8, g = 2 * cq + (e & 1);
        if (idx < n_live && g < ng) {
          const __nv_bfloat16 sb = __float2bfloat16(c[e]);
          s_sh[g * SP + idx] = sb;
          hi_s[e & 1] = fmaxf(hi_s[e & 1], __bfloat162float(sb));
          lo_s[e & 1] = fminf(lo_s[e & 1], __bfloat162float(sb));
        }
      }
    }
    __syncwarp();
    issue(i + n_slots, slot);
    slot = slot + 1 == n_slots ? 0 : slot + 1;
  }

  // phase 1: the final row max and denominator over all warps' partials
  auto scaled = [&](float sb) { return scale_mul ? sb * scale : sb / scale; };
  float mx[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      hi_s[j] = fmaxf(hi_s[j], __shfl_xor_sync(0xffffffffu, hi_s[j], off));
      lo_s[j] = fminf(lo_s[j], __shfl_xor_sync(0xffffffffu, lo_s[j], off));
    }
    // a head with no live key here keeps kNeg (its partial is unused)
    mx[j] = hi_s[j] == kNeg ? kNeg : scaled(scale > 0.f ? hi_s[j] : lo_s[j]);
  }
  if (gq == 0) {
    red_m[warp * kMaxHG + 2 * cq] = mx[0];
    red_m[warp * kMaxHG + 2 * cq + 1] = mx[1];
  }
  __syncthreads();
  // the sum of exp and then p, one head at a time, the warp's keys spread
  // over all its lanes (at one head a block only a quarter of the lanes
  // hold a score in the mma layout)
  auto score = [&](int g, int idx) {
    return scaled(__bfloat162float(s_sh[g * SP + idx]));
  };
  auto row_max = [&](int g) {
    float mg = red_m[g];
    for (int w = 1; w < kWarps; ++w) mg = fmaxf(mg, red_m[w * kMaxHG + g]);
    return mg;
  };
  const int nk = nck * kTile;                 // the warp's key slots
  for (int g = 0; g < ng; ++g) {
    const float mg = row_max(g);
    float lg = 0.f;
#pragma unroll 4
    for (int j = lane; j < nk; j += 32) {
      const int idx = (j >> 4) * kChunk + kTile * warp + (j & 15);
      if (idx < n_live) lg += expf(score(g, idx) - mg);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lg += __shfl_xor_sync(0xffffffffu, lg, off);
    if (lane == 0) red_l[warp * kMaxHG + g] = lg;
  }
  __syncthreads();
  // p over the scores, each warp its own keys (the ones its context reads)
  for (int g = 0; g < ng; ++g) {
    const float mg = row_max(g);
    float lg = red_l[g];
    for (int w = 1; w < kWarps; ++w) lg += red_l[w * kMaxHG + g];
#pragma unroll 4
    for (int j = lane; j < nk; j += 32) {
      const int idx = (j >> 4) * kChunk + kTile * warp + (j & 15);
      if (idx < n_live)
        s_sh[g * SP + idx] = __float2bfloat16(expf(score(g, idx) - mg) / lg);
    }
  }
  __syncwarp();

  // phase 2: context^T = V^T P^T over the warp's own key tiles
  float acc[KS][4];
#pragma unroll
  for (int mt = 0; mt < KS; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
  const int trow = (lane & 7) + (lane >> 4) * 8;         // ldmatrix.trans row
  const int tcol = ((lane >> 3) & 1) * 8;                // and column
  for (int i = nck; i < 2 * nck; ++i) {
    cp_async_wait_dyn(n_slots - 1);
    __syncwarp();
    const int t0 = (i - nck) * kChunk + kTile * warp;
    if (t0 < n_live) {
      const __nv_bfloat16* vt = tile(slot, v_scale);
      // P as B: column n = head gq, rows k = keys t0 + 2cq (+1), + 8
      uint32_t pb[2] = {0u, 0u};
      if (gq < ng) {
        const __nv_bfloat16* prow = s_sh + gq * SP;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int idx = t0 + 8 * j + 2 * cq;
          if (idx + 1 < n_live)
            pb[j] = *reinterpret_cast<const uint32_t*>(prow + idx);
          else if (idx < n_live)
            pb[j] = static_cast<uint32_t>(
                __bfloat16_as_ushort(prow[idx]));
        }
      }
#pragma unroll
      for (int mt = 0; mt < KS; ++mt) {
        if (16 * mt < D) {
          uint32_t a[4];
          ldsm_x4_t(a, vt + trow * ld + 16 * mt + tcol);
          mma_bf16(acc[mt], a, pb[0], pb[1]);
        }
      }
    }
    __syncwarp();
    issue(i + n_slots, slot);
    slot = slot + 1 == n_slots ? 0 : slot + 1;
  }
  cp_async_wait<0>();

  // the warps' partials summed in warp order; acc[mt]: value columns
  // 16 mt + gq (+ 8) x heads 2cq, 2cq + 1
  __syncthreads();                            // every warp is off the ring
#pragma unroll
  for (int mt = 0; mt < KS; ++mt) {
    if (16 * mt < D) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 16 * mt + gq + (e >> 1) * 8, g = 2 * cq + (e & 1);
        red_o[(warp * kMaxHG + g) * D + d] = acc[mt][e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < ng * D; i += kThreads) {
    float s = red_o[i];
    for (int w = 1; w < kWarps; ++w) s += red_o[w * kMaxHG * D + i];
    o[i] = __float2bfloat16(s);
  }
}

struct Args {
  const void *q, *k, *v, *block_tables, *lengths;
  void* out;
  int B, Hkv, G, hg, D, bs, n_pages, window, n_slots, smem;
  float scale;
  int scale_mul;
  float k_scale, v_scale;
};

template <typename KT, int KS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int smem = a.smem;
  auto kern = paged_decode_gqa_kernel<KT, KS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int n_groups = (a.G + a.hg - 1) / a.hg;
  const dim3 grid(a.Hkv * n_groups, a.B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v),
      static_cast<const int32_t*>(a.block_tables),
      static_cast<const int32_t*>(a.lengths),
      static_cast<__nv_bfloat16*>(a.out), a.Hkv, a.G, a.hg, a.D, a.bs,
      a.n_pages, a.window, a.n_slots, a.scale, a.scale_mul, a.k_scale,
      a.v_scale);
  return cudaGetLastError();
}

template <typename KT>
cudaError_t dispatch_d(const Args& a, cudaStream_t st) {
  if (a.D <= 16) return launch<KT, 1>(a, st);
  if (a.D <= 32) return launch<KT, 2>(a, st);
  if (a.D <= 64) return launch<KT, 4>(a, st);
  if (a.D <= 128) return launch<KT, 8>(a, st);
  return launch<KT, 16>(a, st);
}

}  // namespace

// q bf16 (B, Hkv, G, D); k / v (n_blocks, bs, Hkv, D) in kv_dtype (0 bf16,
// 2 fp8 e4m3fn), 16-byte aligned; out bf16 (B, Hkv, G, D). hg: query heads
// per block (1..8); n_slots: ring depth (2..12); smem: the block's dynamic
// shared memory in bytes, which the caller sizes for the kernel's layout
// (kernels/paged_attention.py, _gqa_smem). scale_mul: 1 multiplies the
// scores by scale, 0 divides them. Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int paged_decode_gqa_launch(
    const void* q, const void* k, const void* v, const void* block_tables,
    const void* lengths, void* out, int B, int Hkv, int G, int hg, int D,
    int bs, int n_pages, int window, int n_slots, int smem, float scale,
    int scale_mul, float k_scale, float v_scale, int kv_dtype, void* stream) {
  if (hg < 1 || hg > kMaxHG || D < 16 || D > 256 || D % 16 != 0
      || n_slots < 2 || n_slots > kMaxSlots || window < 1 || smem < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, block_tables, lengths, out, B, Hkv, G, hg, D, bs,
               n_pages, window, n_slots, smem, scale, scale_mul, k_scale,
               v_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (kv_dtype) {
    case 0:
      e = dispatch_d<__nv_bfloat16>(a, st);
      break;
    case 2:
      e = dispatch_d<__nv_fp8_e4m3>(a, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
