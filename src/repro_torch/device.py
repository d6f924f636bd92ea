"""Device selection and the matmul precision policy of the port.

Entry points run on ``cuda`` unless the caller asks for the CPU; asking for
CUDA on a machine without a GPU raises instead of silently running on the
host.

Precision. The JAX package writes every quantizable product as
``jnp.einsum(..., preferred_element_type=f32)`` followed by a cast to the
operand dtype (``repro/quant/qops.py``): bf16 operands, fp32 accumulation,
one rounding to bf16 at the end. cuBLAS matches that only when it may not
reduce partial sums in bf16 (``allow_bf16_reduced_precision_reduction``) and
does not drop float32 operands to TF32 (``allow_tf32``); both are switched
off here, once, when this module is imported — every entry point resolves its
device through :func:`resolve_device`, so the policy is in place before the
first product runs.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device", "DeviceLike"]

DeviceLike = Union[None, str, torch.device]

torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
