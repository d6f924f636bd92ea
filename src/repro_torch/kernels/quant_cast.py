"""Per-tensor fp8 quantization: the ``amax`` and ``scale_cast`` kernels'
wrappers and ``quantize_fp8``.

Port of ``repro/kernels/quant_cast.py`` (Pallas TPU kernels). The kernels are
``csrc/quant_cast.cu`` — CUDA C++ for ``sm_90a``, built with ``nvcc`` into a
plain C library and called through ``ctypes`` — and the source says what
they compute, what bounds them, and how.

A CPU tensor takes the plain version (``kernels/ref.py``). A CUDA tensor
launches the kernel or raises — nothing falls back. ``launches`` counts each
kernel's launches in this process, so a run can show the main path went
through them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import FP8_DTYPES, amax_ref, scale_cast_ref
from repro_torch.quant.formats import true_div

__all__ = ["amax", "scale_cast", "quantize_fp8", "launches"]

launches = {"amax": 0, "scale_cast": 0}      # kernel launches in this process

_IN_CODES = {torch.bfloat16: 0, torch.float32: 1}
_FP8_CODES = {torch.float8_e4m3fn: 0, torch.float8_e5m2: 1}
_fns: dict = {}


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("quant_cast"), f"{name}_launch")
        if name == "amax":
            fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_input(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _IN_CODES:
        raise TypeError(f"{name}: input dtype {x.dtype} not in "
                        f"{list(_IN_CODES)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty input")


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def amax(x: torch.Tensor) -> torch.Tensor:
    """max(|x|) over every element, as a 0-d f32 tensor on ``x``'s device
    (NaN if any element is NaN). No host sync."""
    if x.device.type == "cpu":
        return amax_ref(x)
    _check_input("amax", x)
    out = torch.zeros((), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel_fn("amax")(x.data_ptr(), x.numel(), _IN_CODES[x.dtype],
                                out.data_ptr(), stream)
    _check_rc("amax", rc)
    launches["amax"] += 1
    return out.view(torch.float32)


def scale_cast(x: torch.Tensor, scale, dtype=torch.float8_e4m3fn
               ) -> torch.Tensor:
    """``(x.f32 * scale)`` cast to the fp8 ``dtype``; ``scale`` is an f32
    scalar (a 0-d or one-element tensor on ``x``'s device, or a number)."""
    if x.device.type == "cpu":
        return scale_cast_ref(x, scale, dtype)
    _check_input("scale_cast", x)
    if dtype not in _FP8_CODES:
        raise TypeError(f"scale_cast: {dtype} is not one of "
                        f"{list(FP8_DTYPES)}")
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    if s.numel() != 1:
        raise ValueError(f"scale_cast: scale must be a scalar, got shape "
                         f"{tuple(s.shape)}")
    s = s.reshape(1).contiguous()
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel_fn("scale_cast")(x.data_ptr(), s.data_ptr(),
                                      out.data_ptr(), x.numel(),
                                      _IN_CODES[x.dtype], _FP8_CODES[dtype],
                                      stream)
    _check_rc("scale_cast", rc)
    launches["scale_cast"] += 1
    return out


def quantize_fp8(x: torch.Tensor, max_value: float = 448.0,
                 dtype=torch.float8_e4m3fn) -> tuple:
    """Returns ``(xq, scale_inv)``: the amax -> scale -> cast pipeline, with
    ``scale = max_value / max(amax, 1e-12)`` and ``scale_inv = 1 / scale``
    divided once each (``true_div``) and kept on the device."""
    a = amax(x)
    scale = true_div(max_value, torch.clamp_min(a, 1e-12))
    xq = scale_cast(x, scale, dtype=dtype)
    return xq, true_div(1.0, scale)
