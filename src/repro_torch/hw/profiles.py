"""Hardware profile of the port's target card (port of
``repro/hw/profiles.py``).

Peak numbers per card. ``peak_flops`` maps format name -> dense FLOP/s when
*both* GEMM operands are in that format. The theoretical (TT) and roofline
(ET) gain tables of a calibration bundle are priced with these numbers; the
measured tier (``tabulate_measured_gains``) replaces them with times taken on
the card itself.

The one profile is the NVIDIA H100 SXM5 80GB at its 700 W power limit, from
NVIDIA's H100 data sheet (dense rates, without sparsity). A card run below
700 W (``nvidia-smi --query-gpu=power.limit``) runs slower under load than
these peaks.
"""
from __future__ import annotations

import dataclasses

__all__ = ["HWProfile", "H100_SXM"]


@dataclasses.dataclass(frozen=True)
class HWProfile:
    name: str
    peak_flops: dict          # fmt name -> FLOP/s per card
    hbm_bw: float             # bytes/s per card
    ici_bw: float             # bytes/s per inter-card link
    ici_links: int
    hbm_bytes: float
    vmem_bytes: float

    def flops(self, fmt: str) -> float:
        return self.peak_flops.get(fmt, self.peak_flops["bf16"])

    def mac_time(self, fmt: str) -> float:
        """Seconds per MAC (2 flops) in format ``fmt``."""
        return 2.0 / self.flops(fmt)

    def delta_T(self, fmt: str, ref: str = "bf16") -> float:
        """Per-MAC time gain of fmt vs the reference (paper Sec. 2.3.2)."""
        return self.mac_time(ref) - self.mac_time(fmt)


# NVIDIA H100 SXM5 80GB, 700 W (NVIDIA H100 Tensor Core GPU data sheet)
H100_SXM = HWProfile(
    name="h100_sxm",
    peak_flops={
        "bf16": 989.4e12,
        "fp16": 989.4e12,
        "fp8_e4m3": 1978.9e12,
        "fp8_e5m2": 1978.9e12,
        # Hopper has no fp4 tensor-core mode: an fp4 plan runs at the fp8 rate
        "fp4_e2m1": 1978.9e12,
    },
    hbm_bw=3.35e12,                   # HBM3
    # NVLink 4: 900 GB/s per card in all, 18 links of 50 GB/s (both ways)
    ici_bw=50e9,
    ici_links=18,
    hbm_bytes=80e9,
    # no software-managed scratch the size of a TPU's VMEM: this holds the
    # L2 cache (50 MB), the nearest on-chip store a whole operand may sit in
    vmem_bytes=50e6,
)
