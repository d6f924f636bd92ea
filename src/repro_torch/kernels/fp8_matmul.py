"""Scaled fp8 GEMM: the ``fp8_matmul`` kernel's wrapper.

Port of ``repro/kernels/fp8_matmul.py`` (Pallas TPU kernel)::

    Y = (Xq * sx_inv) @ (Wq * sw_inv)^T = (Xq @ Wq^T) * (sx_inv * sw_inv)

The kernel is ``csrc/fp8_matmul.cu`` — CUDA C++ for ``sm_90a`` (fp8 wgmma
fed by a TMA ring), built with ``nvcc`` into a plain C library and called
through ``ctypes`` — and the source says what it computes, what bounds it,
and how. It takes any shape: unlike the reference, no dimension must be a
multiple of a block. TMA needs 16-byte aligned rows, so the wrapper
zero-pads K to a multiple of 16 (:func:`pad_last`; zero products are exact)
and copies an operand whose address is not 16-byte aligned.

A CPU tensor takes the plain version (``kernels/ref.py``). A CUDA tensor
launches the kernel or raises — nothing falls back. ``launches`` counts the
launches of this process.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fp8_matmul_ref

__all__ = ["fp8_matmul", "pad_last", "launches"]

launches = 0                    # kernel launches in this process

_FP8_CODES = {torch.float8_e4m3fn: 0, torch.float8_e5m2: 1}
_OUT_CODES = {torch.bfloat16: 0, torch.float32: 1}
_MAX_GRID_Y = 65535
_ALIGN = 16                     # bytes: TMA's row stride and base alignment
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load("fp8_matmul").fp8_matmul_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def pad_last(x: torch.Tensor, mult: int) -> torch.Tensor:
    """``x`` with its last dim zero-padded to a multiple of ``mult``
    elements (any dtype, fp8 included: the bytes are padded), 16-byte
    aligned. Returns ``x`` itself when nothing needs changing."""
    pad = (-x.shape[-1]) % mult
    if pad:
        x = F.pad(x.contiguous().view(torch.uint8),
                  (0, pad * x.element_size())).view(x.dtype)
    elif x.data_ptr() % _ALIGN:
        x = x.clone()
    return x


def _scalar(name: str, s, device) -> torch.Tensor:
    s = torch.as_tensor(s, dtype=torch.float32, device=device)
    if s.numel() != 1:
        raise ValueError(f"fp8_matmul: {name} must be a scalar, got shape "
                         f"{tuple(s.shape)}")
    return s.reshape(1).contiguous()


def fp8_matmul(xq: torch.Tensor, wq: torch.Tensor, sx_inv, sw_inv, *,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """``xq`` (M, K) and ``wq`` (N, K) fp8; scales f32 scalars (device
    tensors or numbers). Returns (M, N) in ``out_dtype``."""
    global launches
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[1]:
        raise ValueError(f"fp8_matmul: need (M, K) x (N, K), got "
                         f"{tuple(xq.shape)} x {tuple(wq.shape)}")
    if xq.device.type == "cpu":
        return fp8_matmul_ref(xq, wq, sx_inv, sw_inv, out_dtype)
    if xq.device.type != "cuda" or wq.device != xq.device:
        raise ValueError(f"fp8_matmul: operands on {xq.device} and "
                         f"{wq.device}")
    if xq.dtype not in _FP8_CODES or wq.dtype not in _FP8_CODES:
        raise TypeError(f"fp8_matmul: operand dtypes {xq.dtype}/{wq.dtype} "
                        f"must be in {list(_FP8_CODES)}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"fp8_matmul: out_dtype {out_dtype} not in "
                        f"{list(_OUT_CODES)}")
    if not (xq.is_contiguous() and wq.is_contiguous()):
        raise ValueError("fp8_matmul: operands must be contiguous")
    M, K = xq.shape
    N = wq.shape[0]
    if max(M, N, K) >= 2 ** 31 or -(-N // 128) > _MAX_GRID_Y:
        raise ValueError(f"fp8_matmul: shape {(M, N, K)} too large")
    sx = _scalar("sx_inv", sx_inv, xq.device)
    sw = _scalar("sw_inv", sw_inv, xq.device)
    y = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    if y.numel() == 0 or K == 0:
        return y.zero_()
    xq, wq = pad_last(xq, _ALIGN), pad_last(wq, _ALIGN)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        rc = _kernel_fn()(xq.data_ptr(), wq.data_ptr(), sx.data_ptr(),
                          sw.data_ptr(), y.data_ptr(), M, N, xq.shape[1],
                          _FP8_CODES[xq.dtype], _FP8_CODES[wq.dtype],
                          _OUT_CODES[out_dtype], stream)
    if rc != 0:
        raise RuntimeError(f"fp8_matmul kernel launch failed: cudaError {rc}")
    launches += 1
    return y
