"""Plain PyTorch versions of the port's kernels (the allclose targets).

Port of ``repro/kernels/ref.py``: the fp8 quantization pair (``amax_ref``,
``scale_cast_ref``), the scaled fp8 GEMM (``fp8_matmul_ref``), the
paged-attention oracle (gather each row's blocks into logical order, mask by
length and window, softmax in f32 with the reference path's intermediate
casts) and the mixed-precision flash attention, both as the kernel computes
it (``mp_flash_attention_plain``, key block by key block) and as the
reference's materialized oracle (``mp_flash_attention_ref``). The CPU runs
them in place of the CUDA kernels, and ``chip_smoke.py`` holds each kernel
against them on the card.

fp8 special values. ``scale_cast_ref`` writes the reference framework's
bytes for every value a plain PyTorch cast would not: an e4m3fn NaN or
magnitude above the rounding midpoint 464 becomes NaN (``0x7f``, with the
value's sign), an e5m2 NaN becomes ``0x7e`` with its sign, and an e5m2
magnitude at or above its rounding midpoint 61440 becomes inf. Finite values
in range go through :func:`~repro_torch.quant.formats.cast_to` (round to
nearest even on both devices). ``amax_ref`` returns the canonical quiet NaN
(``0x7fc00000``) when any element is NaN. The CUDA kernels produce the same
bits, so kernel and plain version compare bitwise, NaN included.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

import repro_torch.device  # noqa: F401  (full-f32 matmul policy on the card)
from repro_torch.quant.formats import cast_to, true_div
from repro_torch.quant.qops import einsum_f32acc

__all__ = ["amax_ref", "scale_cast_ref", "fp8_matmul_ref", "paged_deq",
           "paged_decode_attention_ref", "mp_flash_attention_plain",
           "mp_flash_attention_ref", "NEG", "FLASH_NEG", "FP8_DTYPES"]

FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
# magnitudes from which the reference's round-to-nearest-even cast leaves
# the format: e4m3fn has no inf (NaN past 464), e5m2 overflows to inf
_E4M3_NAN_ABOVE = 464.0
_E5M2_INF_FROM = 61440.0
_CANONICAL_NAN = 0x7FC00000


def amax_ref(x: torch.Tensor) -> torch.Tensor:
    """max(|x|) in f32 as a 0-d tensor (NaN if any element is NaN)."""
    a = x.float().abs().amax()
    nan = torch.full((), _CANONICAL_NAN, dtype=torch.int32,
                     device=a.device).view(torch.float32)
    return torch.where(torch.isnan(a), nan, a)


def scale_cast_ref(x: torch.Tensor, scale, dtype=torch.float8_e4m3fn
                   ) -> torch.Tensor:
    """``(x.f32 * scale)`` cast to an fp8 ``dtype`` with the reference's
    bytes for special values (module docstring)."""
    if dtype not in FP8_DTYPES:
        raise TypeError(f"scale_cast_ref: {dtype} is not an fp8 dtype")
    y = x.float() * torch.as_tensor(scale, dtype=torch.float32,
                                    device=x.device)
    bits = cast_to(y, dtype).view(torch.uint8)
    sign = (y.view(torch.int32) < 0).to(torch.uint8) << 7
    nan = torch.isnan(y)
    if dtype == torch.float8_e4m3fn:
        special = nan | (y.abs() > _E4M3_NAN_ABOVE)
        bits = torch.where(special, sign | 0x7F, bits)
    else:
        bits = torch.where(nan, sign | 0x7E, bits)
        bits = torch.where(~nan & (y.abs() >= _E5M2_INF_FROM), sign | 0x7C,
                           bits)
    return bits.view(dtype)


def fp8_matmul_ref(xq: torch.Tensor, wq: torch.Tensor, sx_inv, sw_inv,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """``(Xq @ Wq^T) * sx_inv * sw_inv`` with exact f32 products and f32
    sums; ``xq`` (M, K), ``wq`` (N, K) in fp8, scales f32 scalars."""
    y = torch.matmul(xq.float(), wq.float().t())
    return (y * sx_inv * sw_inv).to(out_dtype)

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


# the flash kernel's mask fill: finite, so a masked score still enters the
# running max (reference ``mp_attention.py`` ``NEG_INF``)
FLASH_NEG = -1e30


def _dequant_f32(x: torch.Tensor, s) -> torch.Tensor:
    """``x.astype(f32) * s`` with ``s`` an f32 scalar (a number, multiplied
    in f32, or a tensor on ``x``'s device)."""
    if isinstance(s, torch.Tensor):
        return x.float() * s.float()
    return x.float() * float(s)


def mp_flash_attention_plain(q, k, v, sq=1.0, sk=1.0, sv=1.0, *,
                             causal: bool = True, block_k: int = 256,
                             quant_probs: bool = False,
                             out_dtype=torch.bfloat16,
                             scale: Optional[float] = None) -> torch.Tensor:
    """What the flash kernel computes, key block by key block.

    q (B, H, T, D), k (B, H, S, D), v (B, H, S, Dv); scales are dequant
    multipliers. Keys are walked in blocks of ``min(block_k, S)`` with an
    online softmax in f32: per block ``m_new = max(m, rowmax(s))``,
    ``p = exp(s - m_new)``, ``l = l * corr + sum(p)`` over the unrounded
    ``p``, and — with ``quant_probs`` — ``p`` rounded to e4m3 against that
    running max before ``p @ v``. The result therefore depends on
    ``block_k``. The causal mask is aligned top-left (key ``j`` is live for
    query ``i`` when ``j <= i``), as in the kernel, at any T and S; masked
    scores are the finite ``-1e30``. ``scale`` defaults to ``1/sqrt(D)``; a
    caller that zero-pads D passes the unpadded D's. Returns (B, H, T, Dv)
    in ``out_dtype``.
    """
    B, H, T, D = q.shape
    S = k.shape[2]
    bk = min(block_k, S)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qf = _dequant_f32(q, sq)
    kf = _dequant_f32(k, sk)
    vf = _dequant_f32(v, sv)
    m = torch.full((B, H, T, 1), FLASH_NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, T, v.shape[3]), dtype=torch.float32,
                      device=q.device)
    qi = torch.arange(T, device=q.device)[:, None]
    for j0 in range(0, S, bk):
        s = torch.matmul(qf, kf[:, :, j0:j0 + bk].transpose(-1, -2)) * scale
        if causal:
            ki = torch.arange(j0, j0 + s.shape[-1], device=q.device)[None]
            s = torch.where(ki <= qi, s, torch.full_like(s, FLASH_NEG))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        if quant_probs:
            p = p.to(torch.float8_e4m3fn).float()
        acc = acc * corr + torch.matmul(p, vf[:, :, j0:j0 + bk])
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).to(out_dtype)


def mp_flash_attention_ref(q, k, v, sq=1.0, sk=1.0, sv=1.0, *,
                           causal: bool = True, quant_probs: bool = False,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """The reference's materialized-softmax oracle, as it stands: its causal
    mask is aligned bottom-right (``tril(k=S-T)``), so it agrees with the
    kernel only at T == S, and its probabilities are rounded against the
    final row max rather than the running one."""
    T, S = q.shape[2], k.shape[2]
    qf = _dequant_f32(q, sq)
    kf = _dequant_f32(k, sk)
    vf = _dequant_f32(v, sv)
    s = true_div(torch.matmul(qf, kf.transpose(-1, -2)),
                 math.sqrt(q.shape[3]))
    if causal:
        mask = torch.ones((T, S), dtype=torch.bool,
                          device=q.device).tril(diagonal=S - T)
        s = torch.where(mask, s, torch.full_like(s, float("-inf")))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if quant_probs:
        p = p.to(torch.float8_e4m3fn).float()
    o = torch.matmul(p, vf) / torch.clamp_min(l, 1e-30)
    return o.to(out_dtype)
