// Paged single-query decode attention for Hopper, sm_90a: the MLA (absorbed
// latent) form on the tensor cores — f32 queries q (Dk) and q2 (D2), bf16
// latents k (the ckv pages, which are also the values) and k2 (the kr
// pages), f32 scores, probabilities and output, no rounding, unit scales.
//
// Replaces: src/repro/kernels/paged_attention.py, paged_decode_attention
// (Pallas TPU kernel _kernel / _call), MLA form: v = None, a second score
// operand q2 . k2, a static integer window. Any other MLA-form call (f32 or
// fp8 latents, non-unit k_scale / v_scale, rounded scores, head dims this
// kernel does not take, a table too wide for its shared memory) stays in
// csrc/paged_attention.cu (kernels/paged_attention.py, route).
//
// What it computes, per decode row b, KV head h and query head g:
//   live keys  lo <= pos < hi,  lo = max(0, len - window), hi = min(len, S)
//   s[g,pos]   = (sum_d q[g,d] * k[pos,d] + sum_e q2[g,e] * k2[pos,e])
//                * scale ("mul") or / scale ("div"), in f32
//   p[g,pos]   = exp(s - m[g]) / l[g]  with the FINAL row max m and
//                denominator l (exact two-phase softmax)
//   out[g,d]   = sum_pos p[g,pos] * k[pos,d]                    (f32)
// Rows with len == 0 (or an empty window) write zeros.
//
// Exact products on bf16 tensor cores. Only the queries and the
// probabilities are f32; the latents are bf16. An f32 value x with
// 2^-100 <= |x| <= 3.39e38 (bf16's largest finite value) splits exactly
// into three bf16 values, hi = bf16(x), mid = bf16(x - hi) and
// lo = bf16(x - hi - mid), rounded to nearest: each subtraction is exact in
// f32, the three parts carry 8 + 8 + 8 significant bits, which covers
// f32's 24, and bf16 has f32's exponent range. (Below 2^-100 the lowest
// bits can fall under bf16's smallest subnormal; such a query or
// probability adds nothing an f32 sum of O(1) terms can hold.) A bf16 x
// bf16 product has at most 16 significant bits, so it is exact in f32. So
// three bf16 mma.sync products, one per plane, compute the f32 products
// x * k exactly; what is left to differ from the plain version is the
// order and rounding of the f32 sums, as in the CUDA-core kernel.
//
// Bound on this card: the live latent bytes, sum_b live_b * Hkv * (Dk + D2)
// * 2 (the values are the same bytes), plus q and the output, at 3.35
// TB/s; or the products, 3 x 2 * live * G * (Dk + D2 + Dk) on the bf16
// tensor cores at 989 TFLOP/s. At the serving cell (B 4, one latent head x
// 128 query heads, 512 + 64, block 16, 136-160 keys a row) that is
// max(0.869, 0.500) us, bytes; at 2048 keys a row 6.92 us, operations. The
// old f32 bound (the same operations at 67 TFLOP/s on the CUDA cores) is
// 2.461 us at the serving cell. A short table is bound by latency: the
// design pays the memory latency as few times as possible.
//
// Design:
// * One block of 16 warps per (row, KV head, group of up to 8 query heads),
//   or, for a table of more than 16 key tiles, a cluster of two such
//   blocks, each taking every other 16-key tile. The heads are the
//   mma.sync.m16n8k16 N = 8 columns; key tiles are the 16-row A operand (no
//   key row wasted). kernels/paged_attention.py picks the group (head_group,
//   counting the cluster's blocks), the split (mla_split) and the staging
//   (mla_slots).
// * Set-up: the group's f32 queries are loaded while the length and the
//   table row are; then the first copies are issued, and the queries q | q2
//   are split once into three bf16 planes in shared memory (plus a zero
//   row for absent heads), read as the B operand by ldmatrix at every
//   k-step. Held in registers they would take 216 (36 k-steps x 3 x 2).
// * Staging. Copies are 16-key x 64-column slabs of 2 KB, rows of 128 bytes
//   with their 16-byte chunks XOR-swizzled by the row (conflict-free
//   ldmatrix), each by 16-byte cp.async.cg: eight lanes a row and four rows
//   an instruction, so an instruction touches 4 rows' lines. Page rows are
//   gathered one by one through the block table, each lane's rows found
//   once a key tile. The first tile starts at lo and rows at or past hi are
//   zero-filled by a 0-byte source, so NaN in a live page's stale slots, or
//   in a block no live page references, never reaches a product.
//   - Resident (mla_slots 0; the serving cell): every slab of the block's
//     key tiles is copied once, the copies shared out over all warps (one
//     commit group, waited for before a block barrier), and read by both
//     products; ckv is read from memory once.
//   - Ring (longer tables): each warp streams its own slabs through a ring
//     of up to 12 slots (one commit group a slab; cp.async.wait_group and
//     __syncwarp, no block barrier): its key tiles' Dk / 64 ckv and D2 / 64
//     kr slabs, then its phase-2 value slabs, issued while phase 0 and the
//     softmax run; ckv is read twice, the second time from L2.
// * Phase 0, scores: warp w takes key tiles w, w + 16, ...; per slab every
//   fragment first (4 ldmatrix of K as A, 8 of the query planes as B), then
//   12 mma.sync into f32 accumulators kept per plane and k-step parity (six
//   independent chains, in registers: indexed only by unrolled loops); a
//   tile's score is their sum, scaled, stored as f32 (hg x its keys x 4 B).
// * Phase 1, softmax: the row max and denominator over the warps' partials
//   (lane g combines head g's in warp order), then over the cluster's two
//   blocks through distributed shared memory (rank order): no atomics, so a
//   call is deterministic. Each warp then writes p = exp(s - m) / l over
//   its own scores, its lanes over keys, every lane all heads.
// * Phase 2, context: out^T = V^T P^T. Warp w takes the value columns
//   64 (w % 8).. and the key tiles of parity w / 8; V^T by ldmatrix.trans,
//   P loaded as f32 and split into three bf16 planes in registers; three
//   mma.sync per 16-column tile, accumulators per plane. The two key
//   halves are summed in order through shared memory (over the query
//   planes), then the cluster's two blocks, rank order, each writing half
//   the outputs.
// * What the time was (paged_kernel_sweep.py on an H100; PERF.md): a first
//   version (8 warps, 2 KB slabs of 2 lanes a row) took 37.5 us at the
//   serving cell and as long with no copies at all (29 us): the time was
//   the warps' issue of per-step work — chiefly the accumulators, indexed
//   by a run-time k-step parity, living in local memory — not the memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kVGroups = 8;                 // phase 2: value column groups
constexpr int kKParts = kWarps / kVGroups;  // and key parts
constexpr int kTile = 16;                   // keys of one mma tile
constexpr int kSlab = 64;                   // latent columns of one copy
constexpr int kRowBytes = kSlab * 2;         // a slab row, 8 chunks of 16 B
constexpr int kSlabBytes = kTile * kRowBytes;
constexpr int kMaxHG = 8;                   // query heads of a block (mma N)
constexpr int kMaxSlots = 12;
constexpr int kPlanes = 3;
// float4 query pieces a thread loads: 8 heads x (512 + 128) / 4 / 512
constexpr int kQPer = (kMaxHG * (8 * 64 + 2 * 64) / 4 + 32 * 16 - 1) / (32 * 16);
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

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// byte offset of 16-byte chunk c of row r in a slab: chunks are XOR-swizzled
// by the row, so 8 consecutive rows' chunk c fall in 8 different banks
__device__ __forceinline__ int swz(int r, int c) {
  return r * kRowBytes + ((c ^ (r & 7)) << 4);
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

// x = hi + mid + lo exactly (see the note above): round to nearest, f32
// subtraction, no truncation
__device__ __forceinline__ void split3(float x, __nv_bfloat16 (&p)[kPlanes]) {
  p[0] = __float2bfloat16_rn(x);
  const float r = __fsub_rn(x, __bfloat162float(p[0]));
  p[1] = __float2bfloat16_rn(r);
  p[2] = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(p[1])));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// kSplit: blocks of a cluster, each taking every kSplit-th key tile (1: no
// split)
template <int kSplit>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads, 1)
paged_decode_mla_kernel(const float* __restrict__ q,
                        const float* __restrict__ q2,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ k2,
                        const int32_t* __restrict__ block_tables,
                        const int32_t* __restrict__ lengths,
                        float* __restrict__ out, int Hkv, int G, int hg,
                        int Dk, int D2, int bs, int n_pages, int window,
                        int n_slots, float scale, int scale_mul) {
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int S = n_pages * bs;
  const int TL = ((S + kTile - 1) / kTile + kSplit - 1) / kSplit;
  const int SP = TL * kTile;                  // this block's key slots
  const int DQ = Dk + D2, qld = DQ + 8;       // query plane row (bf16)
  const int nS1 = (Dk + kSlab - 1) / kSlab;   // ckv slabs of a row
  const int nS = nS1 + (D2 + kSlab - 1) / kSlab;
  // n_slots 0: every slab of the block's key tiles stays resident, slab j
  // of local tile u at (u nS + j); else each warp's ring of n_slots slabs
  const bool resident = n_slots == 0;
  // layout (the caller sizes it: kernels/paged_attention.py, _mla_smem):
  // slabs | query planes (3 hg rows + a zero row; after phase 0 the
  // block's context, hg x Dk f32) | scores, then probabilities (hg x SP
  // f32) | table row | warp partials | the block's max and denominator
  uint8_t* ring = smem;
  const int n_bufs = resident ? TL * nS : kWarps * n_slots;
  __nv_bfloat16* qp =
      reinterpret_cast<__nv_bfloat16*>(ring + n_bufs * kSlabBytes);
  __nv_bfloat16* qzero = qp + kPlanes * hg * qld;
  float* red_o = reinterpret_cast<float*>(qp);
  float* s_sh = reinterpret_cast<float*>(qzero + qld);
  int* blk_sh = reinterpret_cast<int*>(s_sh + hg * SP);
  float* red_m = reinterpret_cast<float*>(blk_sh + n_pages);   // kWarps x 8
  float* red_l = red_m + kWarps * kMaxHG;                      // kWarps x 8
  float* blk_m = red_l + kWarps * kMaxHG;                      // 8
  float* blk_l = blk_m + kMaxHG;                               // 8

  const int n_groups = (G + hg - 1) / hg;
  const int grp = blockIdx.x / kSplit;
  const int h = grp / n_groups, g0 = (grp % n_groups) * hg;
  const int b = blockIdx.y;
  const int ng = min(hg, G - g0);             // heads of this block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, cq = lane & 3;    // mma fragment row / column
  const size_t head0 = (static_cast<size_t>(b) * Hkv + h) * G + g0;

  // set-up: the length and the table row. Every entry is read; only those
  // of live pages are followed.
  const int len = lengths[b];
  // this thread's query values (float4 pieces e = tid + kThreads v of the
  // group's ng x (Dk + D2)), loaded now to overlap the table's load
  const int per_head = DQ / 4;
  float4 qv[kQPer];
#pragma unroll
  for (int v = 0; v < kQPer; ++v) {
    const int e = tid + kThreads * v;
    if (e < ng * per_head) {
      const int g = e / per_head, c = 4 * (e - g * per_head);
      qv[v] = c < Dk
          ? *reinterpret_cast<const float4*>(q + (head0 + g) * Dk + c)
          : *reinterpret_cast<const float4*>(q2 + (head0 + g) * D2 + c - Dk);
    }
  }
  for (int j = tid; j < n_pages; j += kThreads)
    blk_sh[j] = max(block_tables[static_cast<size_t>(b) * n_pages + j], 0);
  __syncthreads();

  float* o = out + head0 * Dk;
  const int hi = min(len, S);
  const int lo = max(0, len - window);
  if (len <= 0 || lo >= hi) {                 // nothing live: zeros (both
    for (int i = tid + rank * kThreads; i < ng * Dk;   // blocks of the
         i += kSplit * kThreads)                       // cluster return)
      o[i] = 0.f;
    return;
  }
  const int n_live = hi - lo;
  const int n_tiles = (n_live + kTile - 1) / kTile;
  // key tile t = rank + kSplit u is this block's local tile u; key slot
  // idx = t kTile + r of the row is local slot u kTile + r.
  // phase 0 and 1: local tiles warp, warp + kWarps, ..., every slab of
  // each; phase 2: value columns kSlab * vg.., local tiles kp, kp +
  // kKParts, ...
  const int my_n = rank < n_tiles ? (n_tiles - rank + kSplit - 1) / kSplit : 0;
  const int my_tiles = warp < my_n ? (my_n - warp + kWarps - 1) / kWarps : 0;
  const int vg = warp % kVGroups, kp = warp / kVGroups;
  const int L0 = my_tiles * nS;
  const int L = L0 + (vg < nS1 && kp < my_n
                          ? (my_n - kp + kKParts - 1) / kKParts : 0);
  const int vwidth = min(kSlab, Dk - kSlab * vg);
  auto live_keys = [&](int u) {               // live keys of local tile u
    return min(kTile, n_live - (rank + kSplit * u) * kTile);
  };

  // the ring: load number `iss` of this warp goes to slot iss % n_slots,
  // one commit group a load (empty past L). Eight lanes a row, four rows an
  // instruction, so each copy instruction touches 4 rows' 128-byte lines
  // (16 a slab, the least its 2 KB allow); each lane finds the sources of
  // its 4 rows once a key tile.
  const int my_piece = lane & 7, my_row0 = lane >> 3;
  const int bs_shift = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;
  int iss = 0, iss_u = warp, iss_j = 0;
  size_t row[kTile / 4];                      // the lane's rows of k / k2
  bool live[kTile / 4];
  auto find_rows = [&](int u) {
#pragma unroll
    for (int v = 0; v < kTile / 4; ++v) {
      const int pos = lo + (rank + kSplit * u) * kTile + my_row0 + 4 * v;
      live[v] = pos < hi;
      const int page = bs_shift >= 0 ? pos >> bs_shift : pos / bs;
      row[v] = live[v] ? (static_cast<size_t>(blk_sh[page]) * bs
                          + (pos - page * bs)) * Hkv + h
                       : 0;
    }
  };
  // slab j of the rows found (ckv columns 64 j.., then kr's) to dst
  auto copy_slab = [&](uint8_t* dst, int j) {
    const bool rope = j >= nS1;
    const int ld = rope ? D2 : Dk, c0 = kSlab * (rope ? j - nS1 : j);
    const __nv_bfloat16* src = (rope ? k2 : k) + c0;
    if (8 * my_piece < min(kSlab, ld - c0)) {
#pragma unroll
      for (int v = 0; v < kTile / 4; ++v)
        cp_async16(dst + swz(my_row0 + 4 * v, my_piece),
                   reinterpret_cast<const uint8_t*>(src + row[v] * ld)
                       + 16 * my_piece,
                   live[v] ? 16 : 0);
    }
  };
  // the ring's next load: this warp's score slabs, then its value slabs
  auto issue = [&](uint8_t* dst) {
    if (iss < L) {
      if (iss < L0) {
        if (iss_j == 0) find_rows(iss_u);
        copy_slab(dst, iss_j);
        if (++iss_j == nS) {
          iss_j = 0;
          iss_u += kWarps;
        }
      } else {
        find_rows(kp + kKParts * (iss - L0));
        copy_slab(dst, vg);
      }
    }
    cp_async_commit();
    ++iss;
  };
  auto slot_at = [&](int slot) {
    return ring + (warp * n_slots + slot) * kSlabBytes;
  };

  // every warp's first copies: resident, the block's slabs shared out over
  // all the warps (waited for before the barrier below); else a ring's
  // worth of its own
  if (resident) {
    for (int n = warp; n < my_n * nS; n += kWarps) {
      const int u = n / nS;
      find_rows(u);
      copy_slab(ring + n * kSlabBytes, n - u * nS);
    }
    // one group: cp.async.wait_group waits only for committed groups, so
    // uncommitted copies could still be landing when phase 0 reads them
    cp_async_commit();
  } else {
    for (int i = 0; i < n_slots; ++i) issue(slot_at(i));
  }

  // the group's queries q | q2 as three bf16 planes, plane-major, one row
  // of qld a head; the zero row stands in for absent heads
#pragma unroll
  for (int v = 0; v < kQPer; ++v) {
    const int e = tid + kThreads * v;
    if (e < ng * per_head) {
      const int g = e / per_head, c = 4 * (e - g * per_head);
      const float4 x = qv[v];
      __nv_bfloat16 p0[kPlanes], p1[kPlanes], p2[kPlanes], p3[kPlanes];
      split3(x.x, p0);
      split3(x.y, p1);
      split3(x.z, p2);
      split3(x.w, p3);
#pragma unroll
      for (int pl = 0; pl < kPlanes; ++pl)
        *reinterpret_cast<uint2*>(qp + (pl * hg + g) * qld + c) =
            make_uint2(pack2(p0[pl], p1[pl]), pack2(p2[pl], p3[pl]));
    }
  }
  for (int i = tid; i < qld / 8; i += kThreads)
    reinterpret_cast<uint4*>(qzero)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (resident) cp_async_wait<0>();
  __syncthreads();

  // phase 0: masked scores, each warp its own 16-key tiles, slab by slab.
  // B rows: lanes 0-15 hi plane, 16-31 mid plane (x4) and lanes 0-15 the
  // lo plane (x2), head lane & 7, columns + 0 / + 8
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;   // ldmatrix row
  const int lcol = lane >> 4;                            // and 8-column chunk
  const int bn = lane & 7, bcol = ((lane >> 3) & 1) * 8;
  const __nv_bfloat16* b_x4 =
      (bn < ng ? qp + ((lane >> 4) * hg + bn) * qld : qzero) + bcol;
  const __nv_bfloat16* b_x2 =
      (bn < ng ? qp + (2 * hg + bn) * qld : qzero) + bcol;
  float mx[2] = {kNeg, kNeg};                 // heads 2cq, 2cq + 1
  float c[2][kPlanes][4];                     // k-step parity x plane
  int slot = 0;                               // the slot of the next load
  int con_u = warp, con_j = 0;                // the tile and slab consumed
  for (int i = 0; i < L0; ++i) {
    if (!resident) cp_async_wait_dyn(n_slots - 1);
    __syncwarp();
    if (con_j == 0) {
#pragma unroll
      for (int par = 0; par < 2; ++par)
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[par][pl][e] = 0.f;
    }
    const bool rope = con_j >= nS1;
    const int c0 = (rope ? con_j - nS1 : con_j) * kSlab;
    const int steps = min(kSlab, (rope ? D2 : Dk) - c0) / 16;
    const int qc = (rope ? Dk : 0) + c0;      // query plane column
    const uint8_t* kt = resident ? ring + (con_u * nS + con_j) * kSlabBytes
                                 : slot_at(slot);
    if (steps == kSlab / 16) {
      // every fragment of the slab first, then the 12 products
      uint32_t a[4][4], bx[4][4], by[4][2];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        ldsm_x4(a[s], kt + swz(lrow, 2 * s + lcol));
        ldsm_x4(bx[s], b_x4 + qc + 16 * s);
        ldsm_x2(by[s], b_x2 + qc + 16 * s);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        mma_bf16(c[s & 1][0], a[s], bx[s][0], bx[s][1]);
        mma_bf16(c[s & 1][1], a[s], bx[s][2], bx[s][3]);
        mma_bf16(c[s & 1][2], a[s], by[s][0], by[s][1]);
      }
    } else {
      // a part-filled slab; unrolled, so c stays in registers
#pragma unroll
      for (int s = 0; s < kSlab / 16; ++s) {
        if (s < steps) {
          uint32_t a[4], bx[4], by[2];
          ldsm_x4(a, kt + swz(lrow, 2 * s + lcol));
          ldsm_x4(bx, b_x4 + qc + 16 * s);
          ldsm_x2(by, b_x2 + qc + 16 * s);
          mma_bf16(c[s & 1][0], a, bx[0], bx[1]);
          mma_bf16(c[s & 1][1], a, bx[2], bx[3]);
          mma_bf16(c[s & 1][2], a, by[0], by[1]);
        }
      }
    }
    if (con_j == nS - 1) {
      // c: keys gq, gq + 8 (rows) x heads 2cq, 2cq + 1 (columns)
      const int nl = live_keys(con_u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = gq + (e >> 1) * 8, g = 2 * cq + (e & 1);
        if (r < nl && g < ng) {
          const float sum = ((c[0][0][e] + c[1][0][e])
                             + (c[0][1][e] + c[1][1][e]))
                            + (c[0][2][e] + c[1][2][e]);
          const float sc = scale_mul ? sum * scale : sum / scale;
          s_sh[g * SP + con_u * kTile + r] = sc;
          mx[e & 1] = fmaxf(mx[e & 1], sc);
        }
      }
    }
    if (!resident) {
      __syncwarp();
      issue(slot_at(slot));
      slot = slot + 1 == n_slots ? 0 : slot + 1;
    }
    if (++con_j == nS) {
      con_j = 0;
      con_u += kWarps;
    }
  }

  // phase 1: the final row max and denominator — over the warps' partials
  // (lane g combines head g's in warp order), then over the cluster's
  // blocks through distributed shared memory (rank order) — then p =
  // exp(s - m) / l over the scores. Each warp takes the keys of its own key
  // tiles, its lanes the keys, every lane all heads (independent sums).
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], off));
  if (gq == 0) {
    red_m[warp * kMaxHG + 2 * cq] = mx[0];
    red_m[warp * kMaxHG + 2 * cq + 1] = mx[1];
  }
  __syncthreads();
  const int hl = lane & (kMaxHG - 1);         // the head this lane combines
  float m_l = red_m[hl];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m_l = fmaxf(m_l, red_m[w * kMaxHG + hl]);
  if constexpr (kSplit > 1) {
    if (warp == 0 && lane < kMaxHG) blk_m[lane] = m_l;
    cluster.sync();
    m_l = fmaxf(m_l, cluster.map_shared_rank(blk_m, rank ^ 1)[hl]);
  }
  float m_h[kMaxHG];
#pragma unroll
  for (int g = 0; g < kMaxHG; ++g) m_h[g] = __shfl_sync(0xffffffffu, m_l, g);
  const int nk = my_tiles * kTile;            // the warp's key slots
  auto slot_of = [&](int jj) {                // local key slot, live keys
    const int u = warp + kWarps * (jj >> 4), r = jj & 15;
    return r < live_keys(u) ? u * kTile + r : -1;
  };
  {
    float l_h[kMaxHG];
#pragma unroll
    for (int g = 0; g < kMaxHG; ++g) l_h[g] = 0.f;
    for (int jj = lane; jj < nk; jj += 32) {
      const int sl = slot_of(jj);
      if (sl >= 0) {
#pragma unroll
        for (int g = 0; g < kMaxHG; ++g)
          if (g < ng) l_h[g] += expf(s_sh[g * SP + sl] - m_h[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxHG; ++g) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        l_h[g] += __shfl_xor_sync(0xffffffffu, l_h[g], off);
    }
    if (lane < kMaxHG) {
      float mine = 0.f;
#pragma unroll
      for (int g = 0; g < kMaxHG; ++g) mine = lane == g ? l_h[g] : mine;
      red_l[warp * kMaxHG + lane] = mine;
    }
  }
  __syncthreads();
  float l_l = red_l[hl];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) l_l += red_l[w * kMaxHG + hl];
  if constexpr (kSplit > 1) {
    if (warp == 0 && lane < kMaxHG) blk_l[lane] = l_l;
    cluster.sync();
    const float peer = cluster.map_shared_rank(blk_l, rank ^ 1)[hl];
    l_l = rank == 0 ? l_l + peer : peer + l_l;
  }
  float l_h[kMaxHG];
#pragma unroll
  for (int g = 0; g < kMaxHG; ++g) l_h[g] = __shfl_sync(0xffffffffu, l_l, g);
  for (int jj = lane; jj < nk; jj += 32) {
    const int sl = slot_of(jj);
    if (sl >= 0) {
#pragma unroll
      for (int g = 0; g < kMaxHG; ++g)
        if (g < ng)
          s_sh[g * SP + sl] = expf(s_sh[g * SP + sl] - m_h[g]) / l_h[g];
    }
  }
  __syncthreads();

  // phase 2: context^T = V^T P^T, this warp's 64 value columns over its
  // key tiles; P as B (column n = head gq, rows k = keys), split into
  // three bf16 planes where it is loaded
  float acc[kPlanes][kSlab / 16][4];
#pragma unroll
  for (int pl = 0; pl < kPlanes; ++pl)
#pragma unroll
    for (int mt = 0; mt < kSlab / 16; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[pl][mt][e] = 0.f;
  const int trow = (lane & 7) + (lane >> 4) * 8;         // ldmatrix.trans row
  const int tcol = (lane >> 3) & 1;                      // and chunk
  const float* prow = s_sh + min(gq, ng - 1) * SP;
  for (int i = L0; i < L; ++i) {
    if (!resident) {
      cp_async_wait_dyn(n_slots - 1);
      __syncwarp();
    }
    const int u = kp + kKParts * (i - L0), nl = live_keys(u);
    uint32_t pb[kPlanes][2];
#pragma unroll
    for (int jx = 0; jx < 2; ++jx) {
      const int r = 8 * jx + 2 * cq;
      float2 pr = make_float2(0.f, 0.f);
      if (gq < ng && r < nl) {
        pr = *reinterpret_cast<const float2*>(prow + u * kTile + r);
        if (r + 1 >= nl) pr.y = 0.f;
      }
      __nv_bfloat16 s0[kPlanes], s1[kPlanes];
      split3(pr.x, s0);
      split3(pr.y, s1);
#pragma unroll
      for (int pl = 0; pl < kPlanes; ++pl) pb[pl][jx] = pack2(s0[pl], s1[pl]);
    }
    const uint8_t* vt = resident ? ring + (u * nS + vg) * kSlabBytes
                                 : slot_at(slot);
    if (vwidth == kSlab) {
      uint32_t a[kSlab / 16][4];
#pragma unroll
      for (int mt = 0; mt < kSlab / 16; ++mt)
        ldsm_x4_t(a[mt], vt + swz(trow, 2 * mt + tcol));
#pragma unroll
      for (int mt = 0; mt < kSlab / 16; ++mt)
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl)
          mma_bf16(acc[pl][mt], a[mt], pb[pl][0], pb[pl][1]);
    } else {
#pragma unroll
      for (int mt = 0; mt < kSlab / 16; ++mt) {
        if (16 * mt < vwidth) {
          uint32_t a[4];
          ldsm_x4_t(a, vt + swz(trow, 2 * mt + tcol));
#pragma unroll
          for (int pl = 0; pl < kPlanes; ++pl)
            mma_bf16(acc[pl][mt], a, pb[pl][0], pb[pl][1]);
        }
      }
    }
    if (!resident) {
      __syncwarp();
      issue(slot_at(slot));
      slot = slot + 1 == n_slots ? 0 : slot + 1;
    }
  }
  cp_async_wait<0>();

  // the contexts summed in a fixed order: in each block its two key
  // halves (kp 0 + kp 1) into red_o, over the query planes (free since
  // phase 0); then the cluster's two blocks (rank 0 + rank 1), each
  // writing half the outputs. acc[.][mt]: value columns 64 vg + 16 mt +
  // gq (+ 8) x heads 2cq, 2cq + 1
  auto for_each_out = [&](auto&& f) {
    if (vg < nS1) {
#pragma unroll
      for (int mt = 0; mt < kSlab / 16; ++mt) {
        if (16 * mt < vwidth) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = kSlab * vg + 16 * mt + gq + (e >> 1) * 8;
            const int g = 2 * cq + (e & 1);
            if (g < ng)
              f(g * Dk + d, (acc[0][mt][e] + acc[1][mt][e]) + acc[2][mt][e]);
          }
        }
      }
    }
  };
  if (kp == 1) for_each_out([&](int i, float x) { red_o[i] = x; });
  __syncthreads();
  if constexpr (kSplit == 1) {
    if (kp == 0) for_each_out([&](int i, float x) { o[i] = x + red_o[i]; });
  } else {
    if (kp == 0)
      for_each_out([&](int i, float x) { red_o[i] = x + red_o[i]; });
    cluster.sync();
    const float* r0 = cluster.map_shared_rank(red_o, 0);
    const float* r1 = cluster.map_shared_rank(red_o, 1);
    for (int i = tid + rank * kThreads; i < ng * Dk; i += kSplit * kThreads)
      o[i] = r0[i] + r1[i];
    cluster.sync();                           // the peer's reads are done
  }
}

}  // namespace

// q f32 (B, Hkv, G, Dk), q2 f32 (B, Hkv, G, D2) or null with D2 == 0; k
// bf16 (n_blocks, bs, Hkv, Dk), the values too; k2 bf16 (n_blocks, bs, Hkv,
// D2) or null; every pointer 16-byte aligned; out f32 (B, Hkv, G, Dk). Dk a
// multiple of 16 up to 512, D2 one up to 128. hg: query heads per block
// (1..8); n_slots: ring depth (2..12), or 0 to keep every slab of the
// block's key tiles resident; split: blocks of a cluster sharing a row's
// key tiles (1 or 2); smem: the block's dynamic shared
// memory in bytes, which the caller sizes for the kernel's layout
// (kernels/paged_attention.py, _mla_smem). scale_mul: 1 multiplies the
// scores by scale, 0 divides them. Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int paged_decode_mla_launch(
    const void* q, const void* q2, const void* k, const void* k2,
    const void* block_tables, const void* lengths, void* out, int B, int Hkv,
    int G, int hg, int Dk, int D2, int bs, int n_pages, int window,
    int n_slots, int split, int smem, float scale, int scale_mul,
    void* stream) {
  if (hg < 1 || hg > kMaxHG || Dk < 16 || Dk > kVGroups * kSlab || Dk % 16
      || D2 < 0 || D2 > 2 * kSlab || D2 % 16
      || (D2 > 0 && (q2 == nullptr || k2 == nullptr)) || n_slots == 1
      || n_slots < 0 || n_slots > kMaxSlots || (split != 1 && split != 2)
      || window < 1 || smem < 0 || B < 1 || bs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = split == 2 ? paged_decode_mla_kernel<2>
                         : paged_decode_mla_kernel<1>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_groups = (G + hg - 1) / hg;
  const dim3 grid(Hkv * n_groups * split, B);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(q2),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(k2),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(lengths), static_cast<float*>(out), Hkv, G,
      hg, Dk, D2, bs, n_pages, window, n_slots, scale, scale_mul);
  return static_cast<int>(cudaGetLastError());
}
