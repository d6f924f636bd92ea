"""High-level wrappers around the kernels (port of ``repro/kernels/ops.py``:
``fp8_linear``, ``quantize_fp8`` and ``flash_attention_mp``).

Shapes are padded to block multiples here, as in the reference, never
inside a kernel. The reference needs that padding (its blocks must divide
the shapes); the CUDA kernels take any shape, so the padding only keeps the
two packages' call sites alike. Unlike the reference, no padded shape is
refused: the reference's ``amax`` asserts ``M % min(256, M) == 0`` after
padding to 128, so it fails on ``M = 300``; the port takes it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import fp8_matmul as _mm
from repro_torch.kernels import mp_attention as _attn
from repro_torch.kernels import quant_cast as _qc
from repro_torch.quant import weight_cache
from repro_torch.quant.formats import get_format

__all__ = ["fp8_linear", "quantize_fp8", "flash_attention_mp"]

_BLOCK = 128                    # the reference wrapper's padding multiple


def _pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad both dims of a 2-D tensor up to multiples of ``mult``."""
    pad_r, pad_c = (-x.shape[0]) % mult, (-x.shape[1]) % mult
    if pad_r or pad_c:
        return F.pad(x, (0, pad_c, 0, pad_r))
    return x.contiguous()


def fp8_linear(x: torch.Tensor, w: torch.Tensor, *,
               fmt_name: str = "fp8_e4m3",
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ w^T with both operands quantized to fp8 (per-tensor scales).

    x: (M, C); w: (K, C), a weight. The amax and scale_cast kernels quantize
    ``x`` on every call and ``w`` once per format (two launches each; the
    padded ``(wq, sw_inv)`` is kept in :mod:`repro_torch.quant.weight_cache`
    while ``w`` is unchanged), the fp8 GEMM kernel multiplies (one launch);
    the scales never leave the device."""
    fmt = get_format(fmt_name)
    dt = fmt.dtype or torch.float8_e4m3fn
    M, C = x.shape
    K = w.shape[0]
    xq, sx_inv = _qc.quantize_fp8(_pad_to(x, _BLOCK), fmt.max_value, dt)
    wq, sw_inv = weight_cache.cached(
        w, ("kernel", fmt_name),
        lambda: _qc.quantize_fp8(_pad_to(w, _BLOCK), fmt.max_value, dt))
    y = _mm.fp8_matmul(xq, wq, sx_inv, sw_inv, out_dtype=out_dtype)
    return y[:M, :K]


def quantize_fp8(x: torch.Tensor, fmt_name: str = "fp8_e4m3") -> tuple:
    """``(xq, scale_inv)`` of ``x`` in the format's fp8 dtype."""
    fmt = get_format(fmt_name)
    return _qc.quantize_fp8(x, fmt.max_value, fmt.dtype)


def flash_attention_mp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, fmt_name=None, quant_probs=None,
                       block: int = 256) -> torch.Tensor:
    """(B, H, T, D) attention through the flash kernel. ``fmt_name=None``
    passes q/k/v through as they are (bf16); a format quantizes each of them
    per tensor over ``reshape(-1, D)`` with the amax and scale_cast kernels
    and then rounds the probabilities to e4m3 unless ``quant_probs`` says
    otherwise."""
    sq = sk = sv = 1.0
    if fmt_name is not None:
        D = q.shape[-1]
        qq, sq = quantize_fp8(q.reshape(-1, D), fmt_name)
        kq, sk = quantize_fp8(k.reshape(-1, D), fmt_name)
        vq, sv = quantize_fp8(v.reshape(-1, v.shape[-1]), fmt_name)
        q, k, v = qq.reshape(q.shape), kq.reshape(k.shape), vq.reshape(v.shape)
        if quant_probs is None:
            quant_probs = True
    return _attn.mp_flash_attention(q, k, v, sq, sk, sv, causal=causal,
                                    block_q=block, block_k=block,
                                    quant_probs=bool(quant_probs))
