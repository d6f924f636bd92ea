"""Scaled casting between BF16 and low-precision formats.

Port of ``repro/quant/qtensor.py``. ``quantize`` stores a tensor in the
target dtype with an amax scale (``scale = max_value / amax``);
``fake_quant`` quantizes and dequantizes in the source dtype, which is what
MP execution consumes. Emulated formats (fp4) round on a mini-float grid.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from repro_torch.distributed.sharding import amax_over
from repro_torch.quant.formats import Format, cast_to, get_format, true_div

__all__ = ["QTensor", "compute_scale", "quantize", "dequantize", "fake_quant"]

Axis = Union[None, int, Sequence[int]]


@dataclasses.dataclass
class QTensor:
    """A quantized tensor: low-precision payload + dequant scale.
    ``data * scale_inv`` reconstructs (an approximation of) the original."""

    data: torch.Tensor
    scale_inv: torch.Tensor      # scalar or per-channel, broadcastable to data
    fmt_name: str

    @property
    def fmt(self) -> Format:
        return get_format(self.fmt_name)

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.data.float() * self.scale_inv).to(dtype)


def _norm_axes(axis: Axis, ndim: int) -> tuple:
    if axis is None:
        return ()
    if isinstance(axis, int):
        axis = (axis,)
    return tuple(a % ndim for a in axis)


def compute_scale(x: torch.Tensor, fmt: Format, axis: Axis = None,
                  margin: float = 1.0, batch_rows: bool = False
                  ) -> torch.Tensor:
    """amax-based scale: ``scale = fmt.max_value / amax``. ``axis=None`` gives
    a per-tensor scalar; otherwise the reduced axes are kept with size 1. An
    empty ``axis`` tuple gives one scale per element. Inside a mesh step the
    amax is maxed over the ``model`` axis, and over ``data`` too when the
    amax reduces dim 0 of an operand whose rows are a batch split over
    ``data`` (``batch_rows``: an activation of a training step); see
    ``distributed.sharding``."""
    axes = _norm_axes(axis, x.ndim)
    if fmt.max_value is None:
        shape = () if axis is None else tuple(
            1 if a in axes else s for a, s in enumerate(x.shape))
        return torch.ones(shape, dtype=torch.float32, device=x.device)
    ax = x.float().abs()
    if axis is not None and not axes:
        amax = ax
    else:
        # x is this rank's block of an operand split over ``model`` along a
        # reduced axis, or the whole operand; either way the max over the
        # mesh is the whole operand's
        amax = amax_over(ax, None if axis is None else axes,
                         over_data=batch_rows and (axis is None or 0 in axes))
    amax = torch.clamp_min(amax, 1e-12)
    return true_div(fmt.max_value * margin, amax)


def quantize(x: torch.Tensor, fmt_name: str, axis: Axis = None,
             scale: Optional[torch.Tensor] = None,
             batch_rows: bool = False) -> QTensor:
    """Cast ``x`` into the target format with amax scaling (real storage;
    ``batch_rows`` as in :func:`compute_scale`)."""
    fmt = get_format(fmt_name)
    if scale is None:
        scale = compute_scale(x, fmt, axis, batch_rows=batch_rows)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    xf = x.float() * scale
    if fmt.dtype is not None:
        data = cast_to(xf, fmt.dtype)
    else:  # emulated format: store the rounded values in bf16
        data = _round_to_format(xf, fmt).to(torch.bfloat16)
    return QTensor(data=data, scale_inv=true_div(1.0, scale).float(),
                   fmt_name=fmt_name)


def dequantize(q: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return q.dequantize(dtype)


def fake_quant(x: torch.Tensor, fmt_name: str, axis: Axis = None,
               scale: Optional[torch.Tensor] = None,
               batch_rows: bool = False) -> torch.Tensor:
    """Quantize-dequantize; output has the dtype of ``x`` (identity for
    ``bf16``)."""
    fmt = get_format(fmt_name)
    if fmt.name == "bf16":
        return x
    return quantize(x, fmt_name, axis=axis, scale=scale,
                    batch_rows=batch_rows).dequantize(x.dtype)


def _round_to_format(xf: torch.Tensor, fmt: Format) -> torch.Tensor:
    """Round fp32 values to an emulated mini-float grid (RTNE, saturating)."""
    m = fmt.mantissa_bits
    bias = 2 ** (fmt.exponent_bits - 1) - 1
    emin = 1 - bias                       # minimum normal exponent
    absx = torch.clamp_max(xf.abs(), fmt.max_value)
    sign = torch.sign(xf)
    exp = torch.floor(torch.log2(torch.clamp_min(absx, 1e-38)))
    exp = torch.clamp_min(exp, emin)      # subnormals share emin spacing
    step = torch.exp2(exp - m)
    rounded = torch.round(true_div(absx, step)) * step
    rounded = torch.where(absx == 0.0, torch.zeros_like(rounded), rounded)
    return sign * torch.clamp_max(rounded, fmt.max_value)
