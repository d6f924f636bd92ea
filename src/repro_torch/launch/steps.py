"""Serving step builders (port of the serving half of
``repro/launch/steps.py``).

PyTorch runs eagerly, so a "step" here is a plain closure over the model and
one ``QuantContext``; :func:`get_serving_step` memoizes the closures per
(model, kind, MP assignment, paged_attn) so every engine over one model
shares them. Nothing is compiled.
"""
from __future__ import annotations

import threading
import weakref
from typing import Optional

import torch

from repro_torch.core.mpconfig import as_assignment
from repro_torch.quant.qops import QuantContext

__all__ = ["make_prefill_step", "make_bucketed_prefill_step",
           "make_chunked_prefill_step", "make_decode_step",
           "make_paged_decode_step", "get_serving_step", "greedy_next_token",
           "merge_first_tokens"]


def _serving_ctx(mp) -> QuantContext:
    """One QuantContext policy for every serving step: per-*token* activation
    scales, so greedy tokens depend neither on which requests share the
    batch nor on how a prompt is padded into a bucket."""
    mp = as_assignment(mp)
    return (QuantContext(mode="mp", mp=mp, act_scale_token=True) if mp
            else QuantContext())


def make_prefill_step(model, mp: Optional[dict] = None):
    """(params, caches, tokens) -> (last-token logits, caches)."""
    ctx = _serving_ctx(mp)

    def prefill_step(params, caches, tokens):
        return model.prefill(params, tokens, caches, ctx)
    return prefill_step


def make_bucketed_prefill_step(model, mp: Optional[dict] = None):
    """(params, caches, tokens, start, valid) -> (last-valid logits, caches)
    over dense rings; ``tokens`` (B, Lb) padded to a power-of-two bucket."""
    ctx = _serving_ctx(mp)

    def prefill_step(params, caches, tokens, start, valid):
        return model.prefill_chunk(params, tokens, caches, ctx,
                                   start_pos=start, valid_len=valid)
    return prefill_step


def make_chunked_prefill_step(model, mp: Optional[dict] = None):
    """(params, caches, tokens, start, valid, block_tables) -> (logits,
    caches): the paged twin — the chunk's K/V goes straight into the pool's
    blocks."""
    ctx = _serving_ctx(mp)

    def prefill_step(params, caches, tokens, start, valid, block_tables):
        return model.prefill_chunk(params, tokens, caches, ctx,
                                   start_pos=start, valid_len=valid,
                                   block_tables=block_tables)
    return prefill_step


def make_decode_step(model, mp: Optional[dict] = None):
    """(params, caches, token, pos) -> (logits, caches) over dense rings."""
    ctx = _serving_ctx(mp)

    def decode_step(params, caches, token, pos):
        return model.decode_step(params, token, pos, caches, ctx)
    return decode_step


def make_paged_decode_step(model, mp: Optional[dict] = None,
                           paged_attn: str = "fused"):
    """(params, caches, token, pos, block_tables) -> (logits, caches).
    ``paged_attn="fused"`` attends block-major K/V in place through the CUDA
    kernel; ``"gather"`` keeps the reference path. Layers whose attention
    BGEMMs carry an MP format always gather."""
    ctx = _serving_ctx(mp)

    def decode_step(params, caches, token, pos, block_tables):
        return model.decode_step(params, token, pos, caches, ctx,
                                 block_tables=block_tables,
                                 paged_attn=paged_attn)
    return decode_step


_BUILDERS = {
    "prefill": make_prefill_step,
    "bucketed_prefill": make_bucketed_prefill_step,
    "chunked_prefill": make_chunked_prefill_step,
    "decode": make_decode_step,
    "paged_decode": make_paged_decode_step,
}

# model -> {(kind, mp key, paged_attn): step}, weak on the model
_SERVING_STEPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_SERVING_STEPS_LOCK = threading.Lock()


def _mp_cache_key(mp):
    mp = as_assignment(mp)
    return None if mp is None else tuple(sorted(mp.items()))


def get_serving_step(model, kind: str, mp=None,
                     paged_attn: Optional[str] = None):
    """Memoized serving step for ``model``. ``kind`` is one of
    ``prefill`` / ``bucketed_prefill`` / ``chunked_prefill`` / ``decode`` /
    ``paged_decode``; ``mp`` an assignment dict or an ``MPPlan``."""
    if kind not in _BUILDERS:
        raise ValueError(f"unknown serving step kind {kind!r}")
    if paged_attn is not None and kind != "paged_decode":
        raise ValueError("paged_attn only applies to kind='paged_decode'")
    key = (kind, _mp_cache_key(mp), paged_attn)
    with _SERVING_STEPS_LOCK:
        steps = _SERVING_STEPS.setdefault(model, {})
        fn = steps.get(key)
        if fn is None:
            if kind == "paged_decode":
                fn = make_paged_decode_step(model, mp=mp,
                                            paged_attn=paged_attn or "fused")
            else:
                fn = _BUILDERS[kind](model, mp=mp)
            steps[key] = fn
    return fn


def greedy_next_token(logits: torch.Tensor) -> torch.Tensor:
    """(B, T, V) logits -> (B,) int32 greedy token of the last position
    (first index on ties, as in the reference)."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def merge_first_tokens(cur_tok: torch.Tensor, new_tok: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Rows where ``mask`` is set take ``new_tok``, others keep ``cur_tok``.
    (B, 1) int32, stays on the device."""
    return torch.where(mask[:, None], new_tok[:, None], cur_tok)
