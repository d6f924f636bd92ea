"""Mixed-precision flash attention: the CUDA kernel's wrapper.

Port of ``repro/kernels/mp_attention.py`` (the Pallas TPU kernel
``mp_flash_attention``). The kernels are in ``csrc/mp_attention.cu`` — CUDA
C++ for ``sm_90a``, built with ``nvcc`` into a plain C library and called
through ``ctypes`` — and the source says what they compute, what bounds
them, and how. Two routes, chosen by the operands' dtype (:func:`route`):

* bf16, e4m3 and e5m2 operands take the tensor-core kernel (wgmma fed by a
  TMA ring; fp8 is widened to bf16 in shared memory, exactly). TMA needs
  rows of a multiple of 16 bytes, so the wrapper zero-pads D and Dv to
  multiples of 16 (:func:`~repro_torch.kernels.fp8_matmul.pad_last`) and
  keeps ``scale = 1/sqrt(D)`` of the unpadded D; zero columns change no
  score, and the padded output columns are never written.
* f32 operands, which have no exact tensor-core route, take the CUDA-core
  kernel; its shared memory bounds ``block_k`` (:func:`smem_bytes`).

Numerics kept from the reference (``kernels/ref.py``
``mp_flash_attention_plain`` repeats them step for step):

* q, k and v are dequantized as ``x.astype(f32) * s`` before the products;
  ``scale = 1/sqrt(D)`` multiplies the f32 scores; masked scores are the
  finite ``-1e30``; the output is ``acc / max(l, 1e-30)`` in ``out_dtype``;
  ``Dv`` may differ from ``D``.
* Keys are walked in blocks of ``min(block_k, S)``. With ``quant_probs`` the
  probabilities are rounded to e4m3 against the running max after each
  block while the denominator sums the unrounded ones, so the result
  depends on ``block_k``; the default is the reference's 256.
* The causal mask is aligned top-left (key ``j`` is live for query ``i``
  when ``j <= i``) at any T and S, as in the kernel; the reference's oracle
  aligns it bottom-right and agrees only at T == S.
* ``block_q`` is accepted for the reference's signature and does not enter
  the result (the kernel's source says why). Unlike the reference, T and S
  need not be multiples of the blocks.

A CPU tensor takes the plain version. A CUDA tensor launches the kernel or
raises — nothing falls back. ``launches`` counts the launches of this
process.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fp8_matmul import pad_last
from repro_torch.kernels.ref import mp_flash_attention_plain

__all__ = ["mp_flash_attention", "route", "smem_bytes", "launches"]

launches = 0                    # kernel launches in this process

# the tensor-core kernel's operand codes (fp8 widened to bf16 inside it)
_TC_CODES = {torch.bfloat16: 0, torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}
_OUT_CODES = {torch.bfloat16: 1, torch.float32: 0}
_MAX_D = 256
_MAX_SMEM = 227 * 1024          # dynamic shared memory a block may use
_BQ, _BT = 64, 64               # the f32 kernel's query tile and key tile
_ROW_ALIGN = 16                 # elements: D and Dv padded for TMA
# each route's C entry point in csrc/mp_attention.cu
_ENTRY = {"tensor_cores": "mp_flash_attention_launch",
          "f32_cuda_cores": "mp_flash_attention_f32_launch"}
_ARGTYPES = {"tensor_cores": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                              + [ctypes.c_float] + [ctypes.c_int] * 2
                              + [ctypes.c_void_p]),
             "f32_cuda_cores": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                                + [ctypes.c_float] + [ctypes.c_int] * 2
                                + [ctypes.c_void_p])}
_fns: dict = {}


def route(dtype) -> str:
    """The kernel that operands of ``dtype`` launch: ``"tensor_cores"``
    (bf16, e4m3, e5m2) or ``"f32_cuda_cores"`` (f32). Raises for any other
    dtype."""
    if dtype == torch.float32:
        return "f32_cuda_cores"
    if dtype in _TC_CODES:
        return "tensor_cores"
    raise TypeError(f"mp_flash_attention: operand dtype {dtype} not in "
                    f"{[*_TC_CODES, torch.float32]}")


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("mp_attention"), _ENTRY[name])
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def smem_bytes(D: int, Dv: int, bk: int) -> int:
    """Dynamic shared memory of one block of the f32 kernel: the query
    tile, one key or value tile, the key block's scores (rows padded by one
    float), and three floats per row (``csrc/mp_attention.cu`` computes the
    same). The tensor-core kernel fits any D, Dv <= 256 and any block_k."""
    return 4 * (_BQ * (D + 1) + _BT * (max(D, Dv) + 1) + _BQ * (bk + 1)
                + 3 * _BQ)


def _scalar(name: str, s, device) -> torch.Tensor:
    """A one-element f32 tensor on ``device``; a number is filled in place
    (no host-to-device copy, so calls can be captured in a CUDA graph)."""
    if not isinstance(s, torch.Tensor):
        return torch.full((1,), float(s), dtype=torch.float32, device=device)
    s = s.to(device=device, dtype=torch.float32)
    if s.numel() != 1:
        raise ValueError(f"mp_flash_attention: {name} must be a scalar, got "
                         f"shape {tuple(s.shape)}")
    return s.reshape(1).contiguous()


def mp_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       sq=1.0, sk=1.0, sv=1.0, *, causal: bool = True,
                       block_q: int = 256, block_k: int = 256,
                       quant_probs: bool = False,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """q, k, v: (B, H, T, D), (B, H, S, D), (B, H, S, Dv) in one dtype
    (bf16, f32 or fp8); ``sq``/``sk``/``sv`` the dequant multipliers
    (numbers or one-element tensors). Returns (B, H, T, Dv) in
    ``out_dtype``."""
    global launches
    del block_q                 # does not enter the result (docstring)
    if block_k < 1:
        raise ValueError(f"block_k must be >= 1, got {block_k}")
    if q.device.type == "cpu":
        return mp_flash_attention_plain(q, k, v, sq, sk, sv, causal=causal,
                                        block_k=block_k,
                                        quant_probs=quant_probs,
                                        out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"mp_flash_attention: unsupported device "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D (B, H, T, D)")
    B, H, T, D = q.shape
    S, Dv = k.shape[2], v.shape[3]
    if k.shape != (B, H, S, D) or v.shape[:3] != (B, H, S):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (q.dtype not in (*_TC_CODES, torch.float32) or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: all "
                        f"must be one of {[*_TC_CODES, torch.float32]}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"out_dtype {out_dtype} not in {list(_OUT_CODES)}")
    if D > _MAX_D or Dv > _MAX_D:
        raise ValueError(f"head dims {D}/{Dv} > {_MAX_D}")
    kind = route(q.dtype)
    bk = min(block_k, S) if S else 1
    if kind == "f32_cuda_cores":
        smem = smem_bytes(D, Dv, bk)
        if smem > _MAX_SMEM:
            raise ValueError(f"key blocks of {bk} need {smem} bytes of "
                             f"shared memory, more than the {_MAX_SMEM} a "
                             f"block may use; lower block_k")
    if H > 65535 or B > 65535 or (kind == "tensor_cores" and B * H > 65535):
        raise ValueError(f"grid ({B}, {H}) too large")
    out = torch.empty((B, H, T, Dv), dtype=out_dtype, device=q.device)
    if out.numel() == 0 or S == 0:
        return out.zero_()
    scales = [_scalar(n, s, q.device) for n, s in
              (("sq", sq), ("sk", sk), ("sv", sv))]
    scale = 1.0 / math.sqrt(D)          # of the unpadded D
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kind == "tensor_cores":
            q, k, v = (pad_last(t, _ROW_ALIGN) for t in (q, k, v))
            rc = _kernel_fn(kind)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                *(s.data_ptr() for s in scales), out.data_ptr(),
                _OUT_CODES[out_dtype], _TC_CODES[q.dtype], B, H, T, S,
                q.shape[3], v.shape[3], Dv, bk, scale, int(causal),
                int(quant_probs), stream)
        else:
            rc = _kernel_fn(kind)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                *(s.data_ptr() for s in scales), out.data_ptr(),
                _OUT_CODES[out_dtype], B, H, T, S, D, Dv, bk, scale,
                int(causal), int(quant_probs), stream)
    if rc != 0:
        raise RuntimeError(f"mp_flash_attention kernel launch failed "
                           f"({kind}): cudaError {rc}")
    launches += 1
    return out
