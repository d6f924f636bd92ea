"""Paged-attention decode: the CUDA kernel's wrapper.

Port of ``repro/kernels/paged_attention.py`` (the Pallas TPU kernel) in both
of its forms. The kernel itself is ``csrc/paged_attention.cu`` — CUDA C++ for
``sm_90a``, built with ``nvcc`` into a plain C library and called through
``ctypes`` — and its source says what it computes, what bounds it, and how.

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

Each block of the kernel holds the scores of up to 8 query heads of one
(row, KV head) over the whole block-table width in shared memory, so the
table width a call may take is bounded (:func:`max_context`): the wrapper
takes the largest head group (8, 4, 2, 1) that fits and still gives half
the SMs of the card a block, and raises beyond a group of one. In the MLA form at block size 16 (576 f32 query values per
head) that is 6,624 table positions with groups of 8 and 54,144 in all.

A CPU tensor takes the plain version (``kernels/ref.py``). A CUDA tensor
launches the kernel or raises — nothing falls back. ``launches`` counts the
launches of this process, so a run can show the main path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_decode_attention_ref

__all__ = ["paged_decode_attention", "launches", "BIG_WINDOW", "smem_bytes",
           "head_group", "max_context"]

BIG_WINDOW = 1 << 30            # "no window" sentinel (fits int32)
launches = 0                    # kernel launches in this process

_Q_CODES = {torch.bfloat16: 0, torch.float32: 1}
_KV_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float8_e4m3fn: 2}
_MAX_DK, _MAX_D2, _MAX_DV = 512, 128, 512
_MAX_HG = 8                     # query heads per block
_MAX_SMEM = 227 * 1024          # dynamic shared memory a block may use
_fn = None


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


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def smem_bytes(hg: int, Dk: int, D2: int, n_pages: int, bs: int) -> int:
    """Dynamic shared memory of one block: the group's queries, its scores
    over the table width, max and denominator per head, and the resolved
    block ids."""
    return 4 * (hg * (Dk + D2) + hg * n_pages * bs + 2 * hg) + 4 * n_pages


def head_group(G: int, Dk: int, D2: int, n_pages: int, bs: int,
               rows: int = 1, sms: int = 0) -> int:
    """Query heads per block: the largest of min(G, 8), halved down to 1,
    whose shared memory fits and — given ``rows`` (decode rows x KV heads)
    and ``sms`` — whose grid gives at least half the SMs a block (smaller
    groups read the keys again for more blocks; measured on an H100 at the
    serving shapes, groups of 1 for GQA and of 4 for MLA were the fastest);
    0 when not even one head fits."""
    hg = min(G, _MAX_HG)
    while hg > 1 and (smem_bytes(hg, Dk, D2, n_pages, bs) > _MAX_SMEM
                      or 2 * rows * -(-G // hg) < sms):
        hg = (hg + 1) // 2
    return hg if smem_bytes(hg, Dk, D2, n_pages, bs) <= _MAX_SMEM else 0


def max_context(Dk: int, D2: int, bs: int, hg: int = 1) -> int:
    """The largest table width in keys (pages x ``bs``) a block of ``hg``
    heads holds."""
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
    hg = head_group(G, Dk, D2, n_pages, bs, rows=B * Hkv,
                    sms=_sm_count(q.device))
    if hg == 0:
        raise ValueError(
            f"scores of one head x {n_pages * bs} keys need "
            f"{smem_bytes(1, Dk, D2, n_pages, bs)} bytes of shared memory, "
            f"more than the {_MAX_SMEM} a block may use (the largest table "
            f"width at these dims is {max_context(Dk, D2, bs)} keys)")
    if B > 65535:
        raise ValueError(f"batch {B} too large for the grid")
    out = torch.empty((B, Hkv, G, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if not math.isfinite(scale) or scale == 0.0:
        raise ValueError(f"scale must be finite and nonzero, got {scale}")
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if q2 is None else q2.data_ptr(),
                None if k2 is None else k2.data_ptr(),
                block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                B, Hkv, G, hg, Dk, D2, Dv, bs, n_pages, int(window),
                float(scale), int(scale_mode == "mul"), float(k_scale),
                float(v_scale), int(score_dtype is not None),
                int(probs_dtype is not None), _Q_CODES[q.dtype],
                _KV_CODES[k.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out
