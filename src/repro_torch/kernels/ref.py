"""Plain PyTorch versions of the port's kernels (the allclose targets).

Port of ``repro/kernels/ref.py``'s paged-attention oracle: gather each row's
blocks into logical order, mask by length and window, softmax in f32 with
the reference path's intermediate casts. The CPU tests run it in place of
the CUDA kernel, and ``chip_smoke.py`` holds the kernel against it on the
card. Nothing on the serving path calls it when a card is present.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.quant.formats import true_div
from repro_torch.quant.qops import einsum_f32acc

__all__ = ["paged_deq", "paged_decode_attention_ref", "NEG"]

# the reference path's mask fill (finfo(f32).min, not -inf: a fully masked
# row softmaxes to uniform garbage instead of NaN)
NEG = torch.finfo(torch.float32).min


def paged_deq(cache: torch.Tensor, block_tables: torch.Tensor, dtype,
              scale: float) -> torch.Tensor:
    """Gather-to-logical-order dequant (``paged_gather`` semantics): a unit
    scale is a plain cast; any other scale multiplies in f32, then casts."""
    bs = cache.shape[1]
    B, npg = block_tables.shape
    g = cache[block_tables.clamp_min(0).long()]
    g = g.reshape(B, npg * bs, *cache.shape[2:])
    if scale != 1.0:
        return (g.float() * scale).to(dtype)
    return g.to(dtype)


def paged_decode_attention_ref(q, k, v, block_tables, lengths, *,
                               window: Optional[int] = None, q2=None, k2=None,
                               scale: float, scale_mode: str = "div",
                               score_dtype=None, probs_dtype=None,
                               k_scale: float = 1.0, v_scale: float = 1.0,
                               out_dtype=None) -> torch.Tensor:
    """Shapes as in :func:`repro_torch.kernels.paged_attention.
    paged_decode_attention`: ``q`` (B, Hkv, G, Dk); ``k``/``v`` (n_blocks,
    bs, Hkv, D); ``block_tables`` (B, max_blocks) int32; ``lengths`` (B,).
    Rows with length 0 give zeros."""
    out_dtype = q.dtype if out_dtype is None else out_dtype
    kg = paged_deq(k, block_tables, q.dtype, k_scale)    # (B, S, Hkv, Dk)
    s = einsum_f32acc("BKGD,BSKD->BKGS", q, kg, torch.float32)
    if q2 is not None:
        k2g = paged_deq(k2, block_tables, q2.dtype, k_scale)
        s = s + einsum_f32acc("BKGD,BSKD->BKGS", q2, k2g, torch.float32)
    if score_dtype is not None:
        s = s.to(score_dtype)
    s = s.float()
    s = true_div(s, scale) if scale_mode == "div" else s * scale
    S = kg.shape[1]
    lengths = lengths.to(device=q.device, dtype=torch.int32)
    kpos = torch.arange(S, dtype=torch.int32, device=q.device)[None, :]
    live = kpos < lengths[:, None]
    if window is not None:
        live &= kpos > (lengths[:, None] - 1 - window)
    s = torch.where(live[:, None, None, :], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    if probs_dtype is not None:
        p = p.to(probs_dtype)
    vg = paged_deq(k if v is None else v, block_tables, p.dtype, v_scale)
    o = einsum_f32acc("BKGS,BSKD->BKGD", p, vg, torch.float32)
    # rows with length 0 attend nothing in the kernel; zero them here too
    o = torch.where((lengths > 0)[:, None, None, None], o,
                    torch.zeros_like(o))
    return o.to(out_dtype)
