"""Assigned input-shape cells and their abstract inputs (port of
``repro/configs/shapes.py``).

Every (arch x shape) cell runs exactly one step function:

* ``train_4k``    -> the loss (forward, backward and update);
* ``prefill_32k`` -> a serving prefill (TTFT, the paper's measured metric);
* ``decode_32k``  -> a decode step (1 new token, a KV cache of seq_len);
* ``long_500k``   -> a decode step at a 524288-token context, for the
  sub-quadratic archs only (SSM and hybrid).

The reference describes inputs as ``jax.ShapeDtypeStruct``; the port as
tensors on the ``meta`` device, which carry a shape and a dtype and hold no
memory.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM

__all__ = ["ShapeCell", "SHAPES", "SUBQUADRATIC", "ENCDEC_DEC_PROMPT",
           "VLM_PREFIX_TOKENS", "cell_supported", "input_specs"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

# archs with a sub-quadratic token-mixing path (may run long_500k)
SUBQUADRATIC = {"hymba_1p5b", "mamba2_370m"}

# decoder prompt length used for enc-dec prefill cells (encoder gets seq_len)
ENCDEC_DEC_PROMPT = 128
# image-token prefix length for the VLM stub
VLM_PREFIX_TOKENS = 576


def cell_supported(arch: str, shape_name: str) -> tuple:
    """(supported, reason)."""
    if shape_name == "long_500k" and arch not in SUBQUADRATIC:
        return False, "full-attention arch: 524k-token decode is quadratic-KV"
    return True, ""


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(model, cell: ShapeCell) -> dict:
    """Abstract inputs (``meta`` tensors) of the cell's step function."""
    B, S = cell.global_batch, cell.seq_len
    cfg = model.cfg
    if isinstance(model, EncDec):
        frames = _meta((B, S, cfg.d_model), torch.bfloat16)
        if cell.kind == "train":
            return {"frames": frames, "tokens": _meta((B, S)),
                    "labels": _meta((B, S))}
        if cell.kind == "prefill":
            return {"frames": frames, "tokens": _meta((B, ENCDEC_DEC_PROMPT))}
        return {"token": _meta((B, 1)), "pos": _meta(())}

    assert isinstance(model, LM)
    if cfg.prefix_embed:
        P = VLM_PREFIX_TOKENS
        prefix = _meta((B, P, cfg.d_model), torch.bfloat16)
        if cell.kind == "train":
            return {"tokens": _meta((B, S - P)), "labels": _meta((B, S - P)),
                    "prefix_embeds": prefix}
        if cell.kind == "prefill":
            return {"tokens": _meta((B, S - P)), "prefix_embeds": prefix}
        return {"token": _meta((B, 1)), "pos": _meta(())}

    if cell.kind == "train":
        return {"tokens": _meta((B, S)), "labels": _meta((B, S))}
    if cell.kind == "prefill":
        return {"tokens": _meta((B, S))}
    return {"token": _meta((B, 1)), "pos": _meta(())}
