"""Blocked (flash-style) attention in plain PyTorch (port of
``repro/nn/flash.py``).

Long prompts (``T >= flash_min_seq``) take this path instead of the
materialized-scores reference attention: a running max and denominator over
key blocks keep memory at O(T * block) instead of O(T^2). The reference
writes it in plain JAX, with no TPU kernel, so the port writes it in plain
PyTorch.

Numerics kept from the reference: GQA through the (Hkv, G) head reshape;
causal and window masks from positions; f32 scores and probabilities, the
probabilities rounded to the value dtype before ``p @ v``; a row with no
live key so far keeps ``m = -inf`` and contributes nothing (the guard);
``l = max(l, 1e-20)``. MP: the paper's ``qk_matmul`` and ``av_matmul``
operands are fake-quantized — q/k/v once up front (per tensor, per
sequence or per token as the context asks) and each block's probabilities
inside the loop — and both ops are registered as ``OpInfo``. Probe mode
never comes here: calibration takes the reference path.

One departure: the reference pads the sequence to a multiple of ``block``
and marks padded keys with position ``int32 min``, which its causal test
``k_pos <= q_pos`` lets through; when ``T % block != 0`` the padded zero
keys then enter every row's denominator. The port masks padded keys
explicitly, so it agrees with the reference attention at every length and
with the reference's flash wherever the length is a multiple of ``block``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.quant import qtensor
from repro_torch.quant.formats import get_format
from repro_torch.quant.qops import (OpInfo, QuantContext, act_quant_axes,
                                    einsum_f32acc)

__all__ = ["flash_attention"]

_I32 = torch.iinfo(torch.int32)


def _register(ctx: QuantContext, scope: str, q, k, v) -> None:
    if ctx.registry is None:
        return
    B, T, H, D = q.shape
    S = k.shape[1]
    ctx.registry.append(OpInfo(
        name=f"{scope}/qk_matmul", kind="bgemm", spec="BTHD,BSHD->BHTS",
        lhs_shape=(B, T, H, D), rhs_shape=tuple(k.shape),
        out_shape=(B, H, T, S), macs=B * H * T * S * D, weight_elems=0))
    ctx.registry.append(OpInfo(
        name=f"{scope}/av_matmul", kind="bgemm", spec="BHTS,BSHD->BTHD",
        lhs_shape=(B, H, T, S), rhs_shape=tuple(v.shape),
        out_shape=(B, T, H, D), macs=B * H * T * S * v.shape[-1],
        weight_elems=0))


def _mp_fmt(ctx: QuantContext, name: str) -> Optional[str]:
    if ctx.mode != "mp":
        return None
    f = ctx.format_for(name)
    return f if get_format(f).is_quantized else None


def flash_attention(ctx: QuantContext, scope: str, q: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool,
                    window: Optional[int], block: int = 1024) -> torch.Tensor:
    """q: (B, T, H, Dk), k: (B, S, Hkv, Dk), v: (B, S, Hkv, Dv) ->
    (B, T, H, Dv) in ``v``'s dtype. Self-attention: q and k positions are
    ``positions`` (B, T), and masked attention needs S <= T."""
    B, T, H, Dk = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // Hkv
    _register(ctx, scope, q, k, v)

    qk_fmt = _mp_fmt(ctx, f"{scope}/qk_matmul")
    av_fmt = _mp_fmt(ctx, f"{scope}/av_matmul")
    # token-granular scales keep (B, T) and reduce (H, D), the slices the
    # reference path's qk operands get
    axes = (2, 3) if ctx.act_scale_token else act_quant_axes(ctx, 4)
    if qk_fmt is not None:
        q = qtensor.fake_quant(q, qk_fmt, axis=axes)
        k = qtensor.fake_quant(k, qk_fmt, axis=axes)
    if av_fmt is not None:
        v = qtensor.fake_quant(v, av_fmt, axis=axes)
    p_axes = ((1, 2, 4) if ctx.act_scale_token
              else act_quant_axes(ctx, 5))

    dev = q.device
    nq, nk = -(-T // block), -(-S // block)
    pad_q, pad_k = nq * block - T, nk * block - S
    positions = positions.to(torch.int32)
    if causal or window is not None:
        if S > positions.shape[1]:
            raise ValueError("masked flash attention needs key positions")
        kpos = positions[:, :S]
    else:                        # unmasked: positions unused
        kpos = torch.zeros((B, S), dtype=torch.int32, device=dev)
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        positions = F.pad(positions, (0, pad_q), value=_I32.max)
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        kpos = F.pad(kpos, (0, pad_k), value=_I32.min)
    key_real = torch.arange(nk * block, device=dev) < S

    scale = 1.0 / math.sqrt(Dk)
    qb = q.reshape(B, nq, block, Hkv, G, Dk)
    kb = k.reshape(B, nk, block, Hkv, Dk)
    vb = v.reshape(B, nk, block, Hkv, Dv)
    qpb = positions.reshape(B, nq, block)
    kpb = kpos.reshape(B, nk, block)
    realb = key_real.reshape(nk, block)

    outs = []
    for qi in range(nq):
        qq, qp = qb[:, qi], qpb[:, qi]
        m = torch.full((B, Hkv, G, block), float("-inf"),
                       dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, block, Dv), dtype=torch.float32,
                          device=dev)
        for kj in range(nk):
            vv, kp = vb[:, kj], kpb[:, kj]
            s = einsum_f32acc("BTKGD,BSKD->BKGTS", qq, kb[:, kj],
                              torch.float32) * scale
            allow = realb[kj][None, None, :].expand(B, block, block)
            if causal:
                allow = allow & (kp[:, None, :] <= qp[:, :, None])
            if window is not None:
                allow = allow & (kp[:, None, :] > (qp[:, :, None] - window))
            s = torch.where(allow[:, None, None], s,
                            torch.full_like(s, float("-inf")))
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard rows with no live key so far
            m_safe = torch.where(torch.isneginf(m_new),
                                 torch.zeros_like(m_new), m_new)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.where(torch.isneginf(m), torch.zeros_like(m),
                               torch.exp(m - m_safe))
            l = l * corr + p.sum(dim=-1)
            pq = p.to(vv.dtype)
            if av_fmt is not None:
                # per-sequence / per-token scales here too, else co-batched
                # rows couple through the block-probability amax
                pq = qtensor.fake_quant(pq, av_fmt, axis=p_axes)
            pv = einsum_f32acc("BKGTS,BSKD->BKGTD", pq, vv, torch.float32)
            acc = acc * corr[..., None] + pv
            m = m_new
        l = torch.clamp_min(l, 1e-20)
        outs.append(acc / l[..., None])          # (B, Hkv, G, blk, Dv)
    out = torch.stack(outs, dim=1)               # (B, nq, Hkv, G, blk, Dv)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, nq * block, H, Dv)
    return out[:, :T].to(v.dtype)
