"""Chunked cross-entropy (port of ``repro/nn/losses.py``): the head matmul and
the CE run one sequence chunk at a time, so the (tokens x vocab) logits
tensor never materializes whole."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.distributed.sharding import dp_sum

__all__ = ["chunked_ce_loss"]


def chunked_ce_loss(head_fn: Callable, h: torch.Tensor, labels: torch.Tensor,
                    weights: Optional[torch.Tensor], chunk: int,
                    no_scan: bool = False) -> torch.Tensor:
    """head_fn(h_chunk) -> logits. h: (B, T, D); labels/weights: (B, T).
    Returns the weighted mean negative log-likelihood (f32 scalar), over
    the whole batch when a training mesh splits its rows."""
    B, T, _ = h.shape
    C = T if no_scan else min(chunk, T)
    if weights is None:
        weights = torch.ones((B, T), dtype=torch.float32, device=h.device)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    denom = torch.zeros((), dtype=torch.float32, device=h.device)
    for s in range(0, T, C):
        logits = head_fn(h[:, s:s + C]).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, s:s + C, None].long())[..., 0]
        w = weights[:, s:s + C].float()
        total = total + ((logz - gold) * w).sum()
        denom = denom + w.sum()
    # a training mesh splits the rows over ``data``: both sums are the
    # whole batch's (identities on one rank)
    total, denom = dp_sum(total), dp_sum(denom)
    return total / torch.clamp_min(denom, 1.0)
