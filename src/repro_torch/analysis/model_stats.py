"""Parameter accounting and MODEL_FLOPS for the roofline table (port of
``repro/analysis/model_stats.py``).

MODEL_FLOPS (the "useful" flops of a cell):

* train   : 6 * N_active_nonembed * tokens    (fwd 2N + bwd 4N)
* prefill : 2 * N_active_nonembed * tokens
* decode  : 2 * N_active_nonembed * batch     (one token per sequence)

MoE: routed experts contribute top_k/n_experts of their params to N_active
(shared experts fully). Embedding gathers are excluded; the LM head matmul
is included (it is a real GEMM): a tied head, or a model without an
``lm_head`` (the encoder-decoder's), counts the embedding matrix once.
"""
from __future__ import annotations

import math

from repro_torch.configs.shapes import ShapeCell

__all__ = ["param_stats", "model_flops"]


def param_stats(model) -> dict:
    specs = model.param_specs()
    cfg = model.cfg
    total = active = embed = 0
    moe = getattr(cfg, "moe", None)
    for path, ps in specs.items():
        n = math.prod(ps.shape)
        total += n
        if path.startswith("embed/"):
            embed += n
            continue  # gather, not a GEMM
        if moe is not None and "/experts/" in path:
            active += n * moe.top_k / moe.n_experts
        else:
            active += n
    if getattr(cfg, "tie_embeddings", False) or not any(
            p.startswith("lm_head") for p in specs):
        head_spec = specs.get("embed/w")
        if head_spec is not None:
            active += math.prod(head_spec.shape)
    return {"total": int(total), "active": float(active), "embed": int(embed)}


def model_flops(model, cell: ShapeCell) -> float:
    n = param_stats(model)["active"]
    if cell.kind == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch  # decode: one token per sequence
