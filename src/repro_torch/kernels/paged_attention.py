"""Paged-attention decode: the CUDA kernel's wrapper.

Port of ``repro/kernels/paged_attention.py`` (the Pallas TPU kernel). The
kernel itself is ``csrc/paged_attention.cu`` — CUDA C++ for ``sm_90a``, built
with ``nvcc`` into a plain C library and called through ``ctypes`` — and its
source says what it computes, what bounds it, and how.

Layout contract (as in the reference):

* ``q``: (B, Hkv, G, Dk) — one query token per row, GQA head groups;
* ``k``/``v``: (n_blocks, block_size, Hkv, D) block-major physical storage;
* ``block_tables``: (B, max_blocks) int32, -1 = unallocated (reads block 0);
* ``lengths``: (B,) int32 live-token count; with ``window``, keys at or
  below ``lengths[b] - 1 - window`` are masked too.

A CPU tensor takes the plain version (``kernels/ref.py``). A CUDA tensor
launches the kernel or raises — nothing falls back. ``launches`` counts the
launches of this process, so a run can show the main path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_decode_attention_ref

__all__ = ["paged_decode_attention", "launches", "BIG_WINDOW"]

BIG_WINDOW = 1 << 30            # "no window" sentinel (fits int32)
launches = 0                    # kernel launches in this process

_Q_CODES = {torch.bfloat16: 0, torch.float32: 1}
_KV_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float8_e4m3fn: 2}
_MAX_DK = 256
_MAX_SMEM = 227 * 1024          # dynamic shared memory a block may use
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load("paged_attention").paged_decode_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def smem_bytes(G: int, Dk: int, n_pages: int, bs: int) -> int:
    """Dynamic shared memory of one block: q, the row's scores, max and
    denominator per head, and the resolved block ids."""
    return 4 * (G * Dk + G * n_pages * bs + 2 * G) + 4 * n_pages


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
    if v is None or q2 is not None or k2 is not None or scale_mode != "div":
        raise NotImplementedError(
            "the MLA form of paged decode attention (v=None, q2/k2, "
            "scale_mode='mul') lands with the MLA slice")
    return _launch(q, k, v, block_tables, lengths, window=window,
                   scale=scale, score_dtype=score_dtype,
                   probs_dtype=probs_dtype, k_scale=k_scale, v_scale=v_scale,
                   out_dtype=out_dtype)


def _launch(q, k, v, block_tables, lengths, *, window, scale, score_dtype,
            probs_dtype, k_scale, v_scale, out_dtype) -> torch.Tensor:
    global launches
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D: (B, Hkv, G, Dk) and "
                         "(n_blocks, block_size, Hkv, D)")
    B, Hkv, G, Dk = q.shape
    _, bs, Hkv_k, Dk_k = k.shape
    Dv = v.shape[-1]
    if (Hkv_k, Dk_k) != (Hkv, Dk) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be (B={B}, max_blocks), got "
                         f"{tuple(block_tables.shape)}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be (B={B},), got "
                         f"{tuple(lengths.shape)}")
    n_pages = block_tables.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _Q_CODES:
        raise TypeError(f"q dtype {q.dtype} not in {list(_Q_CODES)}")
    if k.dtype not in _KV_CODES or v.dtype != k.dtype:
        raise TypeError(f"k/v dtypes {k.dtype}/{v.dtype}: both must be one "
                        f"of {list(_KV_CODES)}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    for name, dt in (("score_dtype", score_dtype),
                     ("probs_dtype", probs_dtype), ("out_dtype", out_dtype)):
        if dt is not None and dt != q.dtype:
            raise TypeError(f"{name}={dt}: the kernel rounds only to the "
                            f"query dtype {q.dtype}")
    if window is None:
        window = BIG_WINDOW
    if isinstance(window, torch.Tensor) or int(window) < 1:
        raise ValueError(f"window must be None or a python int >= 1, got "
                         f"{window!r}")
    if Dk > _MAX_DK:
        raise ValueError(f"head dim {Dk} > {_MAX_DK}")
    smem = smem_bytes(G, Dk, n_pages, bs)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"scores of {G} heads x {n_pages * bs} keys need {smem} bytes of "
            f"shared memory, more than the {_MAX_SMEM} a block may use")
    if B > 65535 or Hkv > 65535:
        raise ValueError(f"grid ({Hkv}, {B}) too large")
    out = torch.empty((B, Hkv, G, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if not math.isfinite(scale) or scale == 0.0:
        raise ValueError(f"scale must be finite and nonzero, got {scale}")
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                B, Hkv, G, Dk, Dv, bs, n_pages, int(window), float(scale),
                float(k_scale), float(v_scale), int(score_dtype is not None),
                int(probs_dtype is not None), _Q_CODES[q.dtype],
                _KV_CODES[k.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out
