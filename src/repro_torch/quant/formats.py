"""Numerical format registry (PyTorch storage dtypes).

Mirrors ``repro/quant/formats.py``: for every format the mantissa width
``m_f`` (eq. 15 noise model), its relative noise variance ``alpha_f =
2^{-2 m_f} / 12`` (eq. 16), the storage dtype (None when emulated), byte
width and the largest finite magnitude used for amax scaling.

:func:`cast_to` is the one place a tensor enters a low-precision storage
dtype. PyTorch saturates an out-of-range float32 -> ``float8_e4m3fn`` cast
at +-448 (inf included), where the reference framework produces NaN for any
magnitude above the rounding midpoint 464. The port follows the reference,
so a supplied scale that overflows gives the same NaN in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["Format", "FORMATS", "get_format", "alpha", "cast_to", "BF16",
           "FP8_E4M3", "FP8_E5M2", "FP16", "FP4_E2M1", "PAPER_FORMATS",
           "true_div"]


@dataclasses.dataclass(frozen=True)
class Format:
    """A floating-point numerical format usable for MP execution."""

    name: str
    mantissa_bits: int
    exponent_bits: int
    bytes: float                      # storage bytes per element
    dtype: Optional[torch.dtype]      # None => emulated (fake-quant only)
    max_value: Optional[float]        # None => no scaling needed

    @property
    def alpha(self) -> float:
        """Per-element relative quantization-noise variance (eq. 16)."""
        return 2.0 ** (-2 * self.mantissa_bits) / 12.0

    @property
    def is_quantized(self) -> bool:
        return self.name != "bf16"


BF16 = Format("bf16", 8, 8, 2, torch.bfloat16, None)
FP8_E4M3 = Format("fp8_e4m3", 3, 4, 1, torch.float8_e4m3fn, 448.0)
FP8_E5M2 = Format("fp8_e5m2", 2, 5, 1, torch.float8_e5m2, 57344.0)
FP16 = Format("fp16", 10, 5, 2, torch.float16, 65504.0)
FP4_E2M1 = Format("fp4_e2m1", 1, 2, 0.5, None, 6.0)

FORMATS: dict[str, Format] = {
    f.name: f for f in (BF16, FP8_E4M3, FP8_E5M2, FP16, FP4_E2M1)
}

# The paper's experiment setting: F=2, {BF16, FP8-E4M3}.
PAPER_FORMATS = ("bf16", "fp8_e4m3")

# e4m3fn has no inf: magnitudes past the midpoint between its largest
# finite value (448) and the next binade step (480) become NaN
_E4M3_NAN_ABOVE = 464.0


def get_format(name: str) -> Format:
    try:
        return FORMATS[name]
    except KeyError as e:
        raise KeyError(
            f"unknown format {name!r}; known: {sorted(FORMATS)}") from e


def alpha(name: str) -> float:
    """alpha_f = 2^{-2 m_f} / 12 for a registered format name."""
    return get_format(name).alpha


def cast_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype)`` with the reference framework's overflow rule for
    ``float8_e4m3fn`` (NaN instead of PyTorch's saturation)."""
    if dtype == torch.float8_e4m3fn and x.dtype != dtype:
        xf = x.float()
        x = torch.where(xf.abs() > _E4M3_NAN_ABOVE,
                        torch.full_like(xf, float("nan")), xf)
    return x.to(dtype)


def true_div(num, den) -> torch.Tensor:
    """``num / den`` rounded once, as the reference divides. PyTorch turns a
    division by a host scalar into a multiply by its reciprocal on CUDA (and
    ``scalar / tensor`` into ``reciprocal(tensor) * scalar`` everywhere),
    which rounds twice; dividing two tensors on one device does not."""
    if not isinstance(den, torch.Tensor):
        den = torch.full((), den, dtype=num.dtype, device=num.device)
    if not isinstance(num, torch.Tensor):
        num = torch.full((), num, dtype=den.dtype, device=den.device)
    return torch.div(num, den)
