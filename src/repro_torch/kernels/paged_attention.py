"""Paged-attention decode: the CUDA kernels' wrapper.

Port of ``repro/kernels/paged_attention.py`` (the Pallas TPU kernel) in both
of its forms. Three kernels — CUDA C++ for ``sm_90a``, built with ``nvcc``
into plain C libraries and called through ``ctypes`` — share the work,
chosen by :func:`route` from the call's form and shape alone, before any
launch:

* ``"gqa_mma"``, ``csrc/paged_decode_gqa.cu``: the GQA serving form (bf16
  queries, bf16 or fp8 K/V, Dk == Dv a multiple of 16 up to 256, scores and
  probabilities rounded to bf16) on the tensor cores, pages staged by
  ``cp.async``;
* ``"mla_mma"``, ``csrc/paged_decode_mla.cu``: the MLA serving form (f32
  queries over bf16 latents, values read from the keys, unit scales, no
  rounding) on the tensor cores, each f32 operand split exactly into three
  bf16 planes, latent slabs staged by ``cp.async``;
* ``"cuda_core"``, ``csrc/paged_attention.cu``: everything else — f32 or
  fp8 latents, f32 queries over GQA K/V, other head dims, wider tables.

Each source says what it computes, what bounds it, and how.

Layout contract (as in the reference):

* ``q``: (B, Hkv, G, Dk) — one query token per row, GQA head groups;
* ``k``/``v``: (n_blocks, block_size, Hkv, D) block-major physical storage;
  ``v=None`` reads the values from ``k`` (the MLA form: the ``ckv``
  latents are both);
* ``q2``/``k2``: an optional second score operand, (B, Hkv, G, D2) and
  (n_blocks, block_size, Hkv, D2), whose product is added to the scores
  (the MLA form's rope part);
* ``block_tables``: (B, max_blocks) int32, -1 = unallocated (reads block 0);
* ``lengths``: (B,) int32 live-token count; with ``window``, keys at or
  below ``lengths[b] - 1 - window`` are masked too.

Each block of every kernel holds the scores of up to 8 query heads of one
(row, KV head) over its share of the block-table width in shared memory,
so the table width a call may take is bounded (:func:`max_context`): the
wrapper takes the largest head group (8, 4, 2, 1) that fits and still
gives half the SMs of the card a block, and raises beyond a group of one.
In the MLA form at block size 16 (576 f32 query values per head) the
CUDA-core kernel holds 6,624 table positions with groups of 8 and 54,144
in all; the MLA tensor-core kernel, whose long tables are split over a
cluster of two blocks, 71,616 with one head (f32 scores beside a ring of
2 slabs a warp). The GQA kernel keeps its scores as bf16: 86,688 positions
at D 64, 72,128 at D 128 and 43,008 at D 256, where :func:`route` sends a
wider table to the CUDA-core kernel (54,448).

A CPU tensor takes the plain version (``kernels/ref.py``). A CUDA tensor
launches a kernel or raises — nothing falls back. ``launches`` counts the
launches of this process, so a run can show the main path went through the
kernels; ``launches_by_route`` splits them by kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_decode_attention_ref

__all__ = ["paged_decode_attention", "launches", "launches_by_route",
           "route", "ROUTES", "BIG_WINDOW", "smem_bytes", "gqa_slots",
           "mla_slots", "mla_split", "head_group", "max_context"]

BIG_WINDOW = 1 << 30            # "no window" sentinel (fits int32)
launches = 0                    # kernel launches in this process
ROUTES = ("gqa_mma", "mla_mma", "cuda_core")
launches_by_route = dict.fromkeys(ROUTES, 0)

_Q_CODES = {torch.bfloat16: 0, torch.float32: 1}
_KV_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float8_e4m3fn: 2}
_MAX_DK, _MAX_D2, _MAX_DV = 512, 128, 512
_MAX_HG = 8                     # query heads per block
_MAX_SMEM = 227 * 1024          # dynamic shared memory a block may use
# csrc/paged_decode_gqa.cu: keys of one ring slot (8 warps x 16-key tiles),
# ring depth, the widest head, and its per-warp softmax partials
_GQA_WARPS, _GQA_MAX_SLOTS, _GQA_MAX_D = 8, 12, 256
_GQA_CHUNK = 16 * _GQA_WARPS
_GQA_RED_BYTES = 2 * 4 * _GQA_WARPS * _MAX_HG
_GQA_KV = {torch.bfloat16: 0, torch.float8_e4m3fn: 2}
# csrc/paged_decode_mla.cu: warps, phase 2's value column groups, 16-key x
# 64-column bf16 slabs, ring depth, the widest latents, and the softmax
# partials (the warps' and the block's)
_MLA_WARPS, _MLA_VGROUPS = 16, 8
_MLA_SLAB, _MLA_MAX_SLOTS = 64, 12
_MLA_SLAB_BYTES = 16 * _MLA_SLAB * 2
_MLA_MAX_DK, _MLA_MAX_D2 = _MLA_VGROUPS * _MLA_SLAB, 2 * _MLA_SLAB
_MLA_RED_BYTES = 4 * (2 * _MLA_WARPS + 2) * _MAX_HG
_fn = None
_gqa_fn = None
_mla_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load("paged_attention").paged_decode_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _mla_kernel_fn():
    global _mla_fn
    if _mla_fn is None:
        fn = _build.load("paged_decode_mla").paged_decode_mla_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _mla_fn = fn
    return _mla_fn


def _gqa_kernel_fn():
    global _gqa_fn
    if _gqa_fn is None:
        fn = _build.load("paged_decode_gqa").paged_decode_gqa_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _gqa_fn = fn
    return _gqa_fn


def route(q_dtype, kv_dtype, has_v: bool, D2: int, Dk: int, Dv: int,
          rounded: Optional[bool] = True, n_pages: int = 0, bs: int = 16, *,
          k_scale: float = 1.0, v_scale: float = 1.0) -> str:
    """The kernel a call takes, by its form and shape alone (never after a
    failure). ``rounded``: True when scores and probabilities are both
    rounded to the query dtype, False when neither is, None when one is.

    * ``"gqa_mma"`` (``csrc/paged_decode_gqa.cu``): bf16 queries over bf16
      or fp8-e4m3 K/V with values of their own (``v`` given), no second
      score operand (``D2 == 0``), ``Dk == Dv``, ``Dk % 16 == 0``, ``Dk <=
      256``, both roundings, and a table of ``n_pages`` pages of ``bs`` keys
      whose one-head scores fit in shared memory (:func:`max_context`);
    * ``"mla_mma"`` (``csrc/paged_decode_mla.cu``): f32 queries over bf16
      latents, values read from the keys (``v`` None), ``Dk`` and ``D2``
      multiples of 16 up to 512 and 128, no rounding, ``k_scale ==
      v_scale == 1``, and a table that fits the same way;
    * ``"cuda_core"`` (``csrc/paged_attention.cu``): every other call — f32
      or fp8 latents, non-unit scales, rounded MLA scores, f32 queries over
      GQA K/V, other head dims, and wider tables: at D 256 the CUDA-core
      kernel holds 54,448 keys to the GQA kernel's 43,008 (at D 64 and 128
      it holds fewer than the GQA kernel, and such a table raises; in the
      MLA form at 512 + 64 it holds 54,144 to the MLA kernel's 71,616)."""
    if (q_dtype == torch.bfloat16 and kv_dtype in _GQA_KV and has_v
            and D2 == 0 and Dk == Dv and Dk % 16 == 0
            and 16 <= Dk <= _GQA_MAX_D and rounded is True
            and _gqa_smem(1, Dk, n_pages, bs, 2) <= _MAX_SMEM):
        return "gqa_mma"
    if (q_dtype == torch.float32 and kv_dtype == torch.bfloat16
            and not has_v and Dv == Dk and Dk % 16 == 0
            and 16 <= Dk <= _MLA_MAX_DK and D2 % 16 == 0
            and 0 <= D2 <= _MLA_MAX_D2 and rounded is False
            and k_scale == 1.0 and v_scale == 1.0
            and _mla_smem(1, Dk, D2, n_pages, bs, 2) <= _MAX_SMEM):
        return "mla_mma"
    return "cuda_core"


def _gqa_smem(hg: int, D: int, n_pages: int, bs: int, slots: int) -> int:
    """Dynamic shared memory of the GQA kernel, which the wrapper passes to
    its launcher: the ring of ``slots`` 128-key slots of padded bf16 rows
    (D + 8), the group's bf16 scores over the table width (rounded up to 8),
    the table row and the warps' softmax partials."""
    sp = -(-(n_pages * bs) // 8) * 8
    return (slots * _GQA_CHUNK * 2 * (D + 8) + 2 * hg * sp + 4 * n_pages
            + _GQA_RED_BYTES)


def gqa_slots(hg: int, D: int, n_pages: int, bs: int) -> int:
    """Ring depth of the GQA kernel: one slot per load a row can need (K and
    V chunks of 128 keys over the table width), at most 12, fewer where the
    scores leave less room; 0 when not even 2 slots fit."""
    want = min(_GQA_MAX_SLOTS, max(2, 2 * -(-(n_pages * bs) // _GQA_CHUNK)))
    for slots in range(want, 1, -1):
        if _gqa_smem(hg, D, n_pages, bs, slots) <= _MAX_SMEM:
            return slots
    return 0


def mla_split(n_pages: int, bs: int) -> int:
    """Blocks of the MLA kernel's cluster sharing a row's key tiles (each
    takes every other tile): 2 once the table has more 16-key tiles than a
    block has warps, else 1."""
    return 2 if -(-(n_pages * bs) // 16) > _MLA_WARPS else 1


def _mla_smem(hg: int, Dk: int, D2: int, n_pages: int, bs: int,
              slots: int) -> int:
    """Dynamic shared memory of one block of the MLA kernel, which the
    wrapper passes to its launcher. A block takes its share of the table's
    16-key tiles (:func:`mla_split`) and holds the latent slabs (16 keys x
    64 columns of bf16) — every slab of its key tiles when ``slots`` is 0,
    else 16 warps' rings of ``slots`` — the group's queries as three bf16
    planes of rows Dk + D2 + 8 plus a zero row, its f32 scores over its key
    tiles, the table row and the softmax partials."""
    split = mla_split(n_pages, bs)
    tiles = -(-(-(-(n_pages * bs) // 16)) // split)
    n_slabs = -(-Dk // _MLA_SLAB) + -(-D2 // _MLA_SLAB)
    slabs = tiles * n_slabs if slots == 0 else slots * _MLA_WARPS
    return (slabs * _MLA_SLAB_BYTES + 2 * (3 * hg + 1) * (Dk + D2 + 8)
            + 4 * hg * 16 * tiles + 4 * n_pages + _MLA_RED_BYTES)


def mla_slots(hg: int, Dk: int, D2: int, n_pages: int, bs: int) -> int:
    """How the MLA kernel stages the latents: 0 when every slab of a
    block's key tiles fits in shared memory at once (each is then loaded
    once and read by both products); else the ring depth, one slot per
    slab a warp loads (its key tiles' ckv and kr slabs, then a value slab
    for each of half the block's key tiles), at most 12, fewer where the
    rest leaves less room; -1 when not even 2 fit."""
    if _mla_smem(hg, Dk, D2, n_pages, bs, 0) <= _MAX_SMEM:
        return 0
    tiles = -(-(-(-(n_pages * bs) // 16)) // mla_split(n_pages, bs))
    per_tile = -(-Dk // _MLA_SLAB) + -(-D2 // _MLA_SLAB)
    parts = _MLA_WARPS // _MLA_VGROUPS
    loads = -(-tiles // _MLA_WARPS) * per_tile + -(-tiles // parts)
    want = min(_MLA_MAX_SLOTS, max(2, loads))
    for slots in range(want, 1, -1):
        if _mla_smem(hg, Dk, D2, n_pages, bs, slots) <= _MAX_SMEM:
            return slots
    return -1


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def smem_bytes(hg: int, Dk: int, D2: int, n_pages: int, bs: int,
               route: str = "cuda_core") -> int:
    """Dynamic shared memory of one block. ``cuda_core``: the group's f32
    queries, its f32 scores over the table width, max and denominator per
    head, and the resolved block ids. ``gqa_mma``: the ring at the depth
    :func:`gqa_slots` picks (2 when none fits), bf16 scores, the table row
    and the softmax partials. ``mla_mma``: the latent slabs as
    :func:`mla_slots` stages them (a ring of 2 when nothing fits), the
    query planes and f32 scores."""
    if route == "gqa_mma":
        slots = gqa_slots(hg, Dk, n_pages, bs) or 2
        return _gqa_smem(hg, Dk, n_pages, bs, slots)
    if route == "mla_mma":
        slots = mla_slots(hg, Dk, D2, n_pages, bs)
        return _mla_smem(hg, Dk, D2, n_pages, bs, 2 if slots < 0 else slots)
    return 4 * (hg * (Dk + D2) + hg * n_pages * bs + 2 * hg) + 4 * n_pages


def head_group(G: int, Dk: int, D2: int, n_pages: int, bs: int,
               rows: int = 1, sms: int = 0, route: str = "cuda_core") -> int:
    """Query heads per block: the largest of min(G, 8), halved down to 1,
    whose shared memory fits and — given ``rows`` (decode rows x KV heads)
    and ``sms`` — whose grid gives at least half the SMs a block (smaller
    groups read the keys again for more blocks); 0 when not even one head
    fits. Measured on an H100 (``paged_kernel_sweep.py``, G 4, 136-160
    keys a row), the group this picks was the fastest of 1, 2 and 4, or
    within 1% of it: in the GQA kernel at 4, 8, 16 and 32 decode rows
    (groups of 1, 2, 4 and 4), in the MLA form at 4 rows (4). The MLA
    tensor-core kernel (``mla_mma``) counts the blocks of its clusters
    (:func:`mla_split`): at 4 rows it takes groups of 4 at the serving
    cell's 160 keys and of 8 at 2048 keys, split over clusters of two."""
    def fits(n: int) -> bool:
        return smem_bytes(n, Dk, D2, n_pages, bs, route) <= _MAX_SMEM

    # the MLA kernel's clusters put mla_split blocks on each group's row
    per = mla_split(n_pages, bs) if route == "mla_mma" else 1
    hg = min(G, _MAX_HG)
    while hg > 1 and (not fits(hg) or 2 * rows * -(-G // hg) * per < sms):
        hg = (hg + 1) // 2
    return hg if fits(hg) else 0


def max_context(Dk: int, D2: int, bs: int, hg: int = 1,
                route: str = "cuda_core") -> int:
    """The largest table width in keys (pages x ``bs``) a block of ``hg``
    heads holds (``gqa_mma`` and ``mla_mma``: with a ring of 2 slots)."""
    if route == "gqa_mma":
        n_pages = ((_MAX_SMEM - _gqa_smem(hg, Dk, 0, bs, 2))
                   // (2 * hg * bs + 4))
        while n_pages > 0 and _gqa_smem(hg, Dk, n_pages, bs, 2) > _MAX_SMEM:
            n_pages -= 1
    elif route == "mla_mma":
        n_pages = ((_MAX_SMEM - _mla_smem(hg, Dk, D2, 0, bs, 2))
                   // (2 * hg * bs + 4))
        while (n_pages > 0
               and _mla_smem(hg, Dk, D2, n_pages, bs, 2) > _MAX_SMEM):
            n_pages -= 1
    else:
        n_pages = (_MAX_SMEM - 4 * hg * (Dk + D2 + 2)) // (4 * hg * bs + 4)
    return max(n_pages, 0) * bs


def paged_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: Optional[torch.Tensor],
                           block_tables: torch.Tensor, lengths: torch.Tensor,
                           *, window: Optional[int] = None,
                           q2: Optional[torch.Tensor] = None,
                           k2: Optional[torch.Tensor] = None,
                           scale: float, scale_mode: str = "div",
                           score_dtype=None, probs_dtype=None,
                           k_scale: float = 1.0, v_scale: float = 1.0,
                           out_dtype=None) -> torch.Tensor:
    """Single-query paged attention: (B, Hkv, G, Dv) in ``out_dtype``.
    Rows whose ``lengths`` entry is 0 produce zeros."""
    kw = dict(window=window, q2=q2, k2=k2, scale=scale,
              scale_mode=scale_mode, score_dtype=score_dtype,
              probs_dtype=probs_dtype, k_scale=k_scale, v_scale=v_scale,
              out_dtype=out_dtype)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k, v, block_tables, lengths, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    return _launch(q, k, v, block_tables, lengths, **kw)


def _launch(q, k, v, block_tables, lengths, *, window, q2, k2, scale,
            scale_mode, score_dtype, probs_dtype, k_scale, v_scale,
            out_dtype) -> torch.Tensor:
    global launches
    has_v = v is not None
    v = k if v is None else v
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D: (B, Hkv, G, Dk) and "
                         "(n_blocks, block_size, Hkv, D)")
    B, Hkv, G, Dk = q.shape
    _, bs, Hkv_k, Dk_k = k.shape
    Dv = v.shape[-1]
    if (Hkv_k, Dk_k) != (Hkv, Dk) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if (q2 is None) != (k2 is None):
        raise ValueError("q2 and k2 come together")
    D2 = 0
    if q2 is not None:
        D2 = q2.shape[-1]
        if (q2.dim() != 4 or tuple(q2.shape[:3]) != (B, Hkv, G)
                or k2.dim() != 4 or tuple(k2.shape) != (*k.shape[:3], D2)):
            raise ValueError(f"q2/k2 shapes {tuple(q2.shape)}/"
                             f"{tuple(k2.shape)} do not match q "
                             f"{tuple(q.shape)} and k {tuple(k.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be (B={B}, max_blocks), got "
                         f"{tuple(block_tables.shape)}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be (B={B},), got "
                         f"{tuple(lengths.shape)}")
    n_pages = block_tables.shape[1]
    named = [("q", q), ("k", k), ("v", v), ("block_tables", block_tables),
             ("lengths", lengths)]
    if q2 is not None:
        named += [("q2", q2), ("k2", k2)]
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _Q_CODES:
        raise TypeError(f"q dtype {q.dtype} not in {list(_Q_CODES)}")
    if k.dtype not in _KV_CODES or v.dtype != k.dtype:
        raise TypeError(f"k/v dtypes {k.dtype}/{v.dtype}: both must be one "
                        f"of {list(_KV_CODES)}")
    if q2 is not None and (q2.dtype != q.dtype or k2.dtype != k.dtype):
        raise TypeError(f"q2/k2 dtypes {q2.dtype}/{k2.dtype} must be the "
                        f"q/k dtypes {q.dtype}/{k.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    for name, dt in (("score_dtype", score_dtype),
                     ("probs_dtype", probs_dtype), ("out_dtype", out_dtype)):
        if dt is not None and dt != q.dtype:
            raise TypeError(f"{name}={dt}: the kernel rounds only to the "
                            f"query dtype {q.dtype}")
    if scale_mode not in ("div", "mul"):
        raise ValueError(f"scale_mode must be 'div' or 'mul', got "
                         f"{scale_mode!r}")
    if window is None:
        window = BIG_WINDOW
    if isinstance(window, torch.Tensor) or int(window) < 1:
        raise ValueError(f"window must be None or a python int >= 1, got "
                         f"{window!r}")
    if Dk > _MAX_DK or D2 > _MAX_D2 or Dv > _MAX_DV:
        raise ValueError(f"head dims {Dk}/{D2}/{Dv} exceed "
                         f"{_MAX_DK}/{_MAX_D2}/{_MAX_DV}")
    n_rounded = (score_dtype is not None) + (probs_dtype is not None)
    form = (q.dtype, k.dtype, has_v, D2, Dk, Dv,
            {0: False, 1: None, 2: True}[n_rounded])
    scales = dict(k_scale=float(k_scale), v_scale=float(v_scale))
    rt = route(*form, n_pages=n_pages, bs=bs, **scales)
    hg = head_group(G, Dk, D2, n_pages, bs, rows=B * Hkv,
                    sms=_sm_count(q.device), route=rt)
    if hg == 0:
        widest = max(max_context(Dk, D2, bs, 1, r)
                     for r in {rt, route(*form, bs=bs, **scales)})
        raise ValueError(
            f"scores of one head x {n_pages * bs} keys need "
            f"{smem_bytes(1, Dk, D2, n_pages, bs, rt)} bytes of shared "
            f"memory, more than the {_MAX_SMEM} a block may use (the largest "
            f"table width at these dims is {widest} keys)")
    if B > 65535:
        raise ValueError(f"batch {B} too large for the grid")
    if rt == "gqa_mma" and (k.data_ptr() % 16 or v.data_ptr() % 16
                            or q.data_ptr() % 4):
        raise ValueError("the GQA kernel copies K/V rows 16 bytes at a time: "
                         "k and v must start 16-byte aligned, q 4-byte")
    if rt == "mla_mma" and any(t.data_ptr() % 16 for t in (
            q, k, *(() if q2 is None else (q2, k2)))):
        raise ValueError("the MLA kernel copies latent rows and loads "
                         "queries 16 bytes at a time: q, q2, k and k2 must "
                         "start 16-byte aligned")
    out = torch.empty((B, Hkv, G, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if not math.isfinite(scale) or scale == 0.0:
        raise ValueError(f"scale must be finite and nonzero, got {scale}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if rt == "gqa_mma":
            slots = gqa_slots(hg, Dk, n_pages, bs)
            rc = _gqa_kernel_fn()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                B, Hkv, G, hg, Dk, bs, n_pages, int(window), slots,
                _gqa_smem(hg, Dk, n_pages, bs, slots), float(scale),
                int(scale_mode == "mul"), float(k_scale), float(v_scale),
                _GQA_KV[k.dtype], stream)
        elif rt == "mla_mma":
            slots = mla_slots(hg, Dk, D2, n_pages, bs)
            rc = _mla_kernel_fn()(
                q.data_ptr(), None if q2 is None else q2.data_ptr(),
                k.data_ptr(), None if k2 is None else k2.data_ptr(),
                block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                B, Hkv, G, hg, Dk, D2, bs, n_pages, int(window), slots,
                mla_split(n_pages, bs),
                _mla_smem(hg, Dk, D2, n_pages, bs, slots), float(scale),
                int(scale_mode == "mul"), stream)
        else:
            rc = _kernel_fn()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if q2 is None else q2.data_ptr(),
                None if k2 is None else k2.data_ptr(),
                block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                B, Hkv, G, hg, Dk, D2, Dv, bs, n_pages, int(window),
                float(scale), int(scale_mode == "mul"), float(k_scale),
                float(v_scale), int(score_dtype is not None),
                int(probs_dtype is not None), _Q_CODES[q.dtype],
                _KV_CODES[k.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed "
                           f"({rt}): cudaError {rc}")
    launches += 1
    launches_by_route[rt] += 1
    return out
