"""Analytic FLOP/byte accounting from the quantizable-op registry (port of
``repro/analysis/analytic.py``).

A *counting twin* of the model (unrolled layers, unchunked loss and MoE,
reference attention) runs one cell's step with an op registry, and MACs and
bytes are summed over every registered op. Backward = 2x forward FLOPs
(standard); optimizer traffic adds 16 bytes/param (p, g, mu, nu rw
amortized). Elementwise and norm traffic is not counted (matmul-centric
accounting, as in the reference).

The reference traces with ``jax.eval_shape``; the port runs the step on
PyTorch's ``meta`` device: params, caches and inputs are ``meta`` tensors
built from the specs (:func:`meta_params`, :func:`meta_caches`,
``configs.shapes.input_specs``), every op computes shapes only, and nothing
is allocated on any device. No code on the counted paths reads a value back
to the host (the MoE routing, the SSD scan and the cache writes are
written without ``.item()`` or boolean indexing so that they capture as
CUDA graphs), so no path needs a detour here; a step that did would raise
on ``meta``, never fall back to a real device. Exact duplicate ops (the
encoder-decoder's cross K/V, projected for the prefill's attention and
again for the decode cache) are counted once, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.shapes import SHAPES, ShapeCell, input_specs
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM
from repro_torch.models.registry import build_model, get_config
from repro_torch.nn.spec import tree_from_flat
from repro_torch.quant.qops import QuantContext

__all__ = ["counting_twin", "analytic_costs", "terms_under_assignment",
           "meta_params", "meta_caches"]

_BYTES = 2.0  # bf16 operand/output bytes
_META = torch.device("meta")


def counting_twin(arch: str, cell: ShapeCell, overrides=None):
    """Full-size config reshaped so every op registers exactly once with
    global shapes."""
    ov = dict(scan_layers=False, remat=False, flash_min_seq=1 << 30,
              loss_chunk=cell.seq_len, **(overrides or {}))
    cfg = get_config(arch)
    if getattr(cfg, "moe", None) is not None:
        tokens = cell.global_batch * cell.seq_len
        ov["moe"] = dataclasses.replace(cfg.moe, token_chunk=max(tokens, 1))
    fields = {f.name for f in dataclasses.fields(cfg)}
    ov = {k: v for k, v in ov.items() if k in fields}
    return build_model(get_config(arch, **ov))


def meta_params(model) -> dict:
    """The model's param tree as ``meta`` tensors of the specs' shapes and
    dtypes."""
    return tree_from_flat({
        path: torch.empty(s.shape, dtype=s.dtype, device=_META)
        for path, s in model.param_specs().items()})


def meta_caches(model, cell: ShapeCell) -> dict:
    """The dense decode caches of ``cell`` (its batch, ``seq_len`` rows;
    an encoder-decoder's cross K/V of ``seq_len`` frames) on ``meta``."""
    B, S = cell.global_batch, cell.seq_len
    if isinstance(model, EncDec):
        return EncDec._materialize(model.cache_specs(B, S, enc_len=S), _META)
    return LM._materialize(model.cache_specs(B, S), _META)


def _trace_ops(model, cell: ShapeCell) -> list:
    registry: list = []
    ctx = QuantContext(registry=registry)
    ins = input_specs(model, cell)
    params = meta_params(model)
    with torch.no_grad():
        if cell.kind == "train":
            model.loss(params, ins, ctx)
        elif cell.kind == "prefill":
            caches = meta_caches(model, cell)
            if isinstance(model, EncDec):
                model.prefill(params, ins["frames"], ins["tokens"], caches,
                              ctx)
            else:
                model.prefill(params, ins["tokens"], caches, ctx,
                              prefix_embeds=ins.get("prefix_embeds"))
        else:
            caches = meta_caches(model, cell)
            model.decode_step(params, ins["token"], ins["pos"], caches, ctx)
    # dedupe exact duplicates (whisper's k/v projections traced both in
    # cross-attention and in the decode-cache precompute)
    seen, out = set(), []
    for op in registry:
        key = (op.name, op.lhs_shape, op.rhs_shape)
        if key not in seen:
            seen.add(key)
            out.append(op)
    return out


def analytic_costs(arch: str, shape_name, overrides=None) -> dict:
    """Global analytic costs for one cell (a name of ``SHAPES`` or a
    ``ShapeCell``): flops, bytes, param traffic.

    Also returns a compact per-op table so that the terms can be re-priced
    under an MP assignment without tracing again."""
    cell = (shape_name if isinstance(shape_name, ShapeCell)
            else SHAPES[shape_name])
    model = counting_twin(arch, cell, overrides)
    ops = _trace_ops(model, cell)
    fwd_flops = sum(2.0 * op.macs for op in ops)
    fwd_bytes = sum(_BYTES * (math.prod(op.lhs_shape)
                              + math.prod(op.rhs_shape)
                              + math.prod(op.out_shape)) for op in ops)
    n_params = sum(math.prod(s.shape) for s in model.param_specs().values())
    if cell.kind == "train":
        flops = 3.0 * fwd_flops
        byts = 3.0 * fwd_bytes + 16.0 * n_params
    else:
        flops = fwd_flops
        byts = fwd_bytes
    op_table = [
        {"name": op.name, "kind": op.kind, "macs": op.macs,
         "lhs": math.prod(op.lhs_shape), "rhs": math.prod(op.rhs_shape),
         "out": math.prod(op.out_shape)} for op in ops]
    return {"flops": flops, "bytes": byts, "n_ops": len(ops),
            "n_params": n_params, "fwd_flops": fwd_flops, "ops": op_table}


def terms_under_assignment(ana: dict, cell_kind: str, chips: int, hw,
                           assignment=None, ref: str = "bf16",
                           fused_quant: bool = False) -> dict:
    """Re-price the compute and memory roofline terms under an op->format
    map.

    Quantized ops run at the format's tensor-core rate; their GEMM operands
    move at the format's byte width. Activation operands also pay a
    requantization pass (read ref + write fmt) unless ``fused_quant`` (the
    quantization fused into the producer's epilogue). Collectives are
    format-independent here (activations cross the wire in bf16)."""
    from repro_torch.quant.formats import get_format
    assignment = assignment or {}
    ref_b = get_format(ref).bytes
    t_c = t_m_bytes = 0.0
    for op in ana["ops"]:
        fmt_name = assignment.get(op["name"], ref)
        fmt = get_format(fmt_name)
        t_c += 2.0 * op["macs"] / hw.flops(fmt_name)
        byts = (op["lhs"] + op["rhs"]) * fmt.bytes + op["out"] * ref_b
        if fmt.is_quantized and not fused_quant:
            act = op["lhs"] if op["kind"] == "linear" else op["lhs"] + op["rhs"]
            byts += act * (ref_b + fmt.bytes)  # requantization pass
        t_m_bytes += byts
    mult = 3.0 if cell_kind == "train" else 1.0
    t_m_bytes = t_m_bytes * mult + (16.0 * ana["n_params"]
                                    if cell_kind == "train" else 0.0)
    return {"t_compute": t_c * mult / chips,
            "t_memory": t_m_bytes / chips / hw.hbm_bw}
