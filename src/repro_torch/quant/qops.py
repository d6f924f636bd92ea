"""Quantizable op entry points (port of ``repro/quant/qops.py``).

Every linear operation the paper can quantize — linear layers (``L_lin``) and
the batched GEMMs inside attention (``L_BGEMM``) — goes through
:func:`qeinsum`. A :class:`QuantContext` selects the execution mode:

* ``plain`` — high-precision (BF16) execution;
* ``mp``    — operands of op ``name`` are fake-quantized to the assigned
              format (``impl="simulate"``), stored in it and dequantized at
              use (``impl="native"``), or, for a linear op, run through the
              fp8 CUDA kernels (``impl="kernel"``, below);
* ``probe`` — sensitivity calibration (Sec. 2.2): operands receive additive
              zero probes ``z + p`` and the unperturbed operands are captured
              (references, not copies) so the caller can evaluate
              ``s_l = ||z (.) dg/dz||^2`` (eq. 19).

``impl="kernel"`` is the port's counterpart of the reference's
``impl="pallas"`` (which the port refuses by name). A quantized linear op
goes through :func:`repro_torch.kernels.ops.fp8_linear` — per-tensor amax
scales, an fp8 GEMM with f32 accumulation — and returns before the registry
records it, as in the reference. On a CUDA tensor that launches the
hand-written kernels; on a CPU tensor it runs their plain versions. The
reference takes that branch only for a 2-D ``lhs``, which no model path
produces (every linear of ``LM`` sees ``(B, S, C)``). One departure: when the
context asks for per-tensor activation scales (``act_scale_axis`` None and
``act_scale_token`` False), an ``lhs`` of higher rank is flattened to
``(-1, C)``, sent through the kernel and reshaped back. Its quantization grid
is the one the reference's per-tensor fake-quant of the same tensor uses
(``max / max(amax, 1e-12)`` in both); only the products differ, by the bf16
rounding of the dequantized operands. Per-token and per-sequence contexts
(serving) keep the fake-quant branch unchanged.

A linear op's weight (``rhs``) is quantized once per format and kept
(:mod:`repro_torch.quant.weight_cache`) on both branches: as fp8 codes plus
a scale, dequantized at use, for fake quant; as the kernels' ``(wq,
sw_inv)`` inside ``fp8_linear``. The result is bit-equal to quantizing per
call. Activations and BGEMM operands are quantized per call. Under FSDP a
weight whose ``data`` ranks each hold a block is quantized on the block,
with the whole weight's scale, and its one-byte codes are gathered
(:func:`gathered_weight`).

When ``ctx.registry`` is a list, every op records an :class:`OpInfo`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.distributed.sharding import (dp_copy, dp_gather_param,
                                              dp_share, tp_copy)
from repro_torch.quant import qtensor, weight_cache
from repro_torch.quant.formats import get_format

__all__ = ["QuantContext", "OpInfo", "qeinsum", "linear", "bgemm",
           "einsum_f32acc", "gathered_weight"]

KIND_LINEAR = "linear"   # rhs is a weight tensor (persistent)
KIND_BGEMM = "bgemm"     # both operands are activations
_IMPLS = ("simulate", "native", "kernel")


@dataclasses.dataclass(frozen=True)
class OpInfo:
    """Static description of one quantizable op occurrence."""

    name: str
    kind: str                 # linear | bgemm
    spec: str                 # einsum spec
    lhs_shape: tuple
    rhs_shape: tuple
    out_shape: tuple
    macs: int                 # multiply-accumulates for one evaluation
    weight_elems: int         # persistent parameter elements (0 for bgemm)


@dataclasses.dataclass
class QuantContext:
    """Carries the execution mode through a model's apply function.

    ``act_scale_token`` (the serving policy): each activation operand keeps
    every batch/token einsum axis and reduces only feature/head axes, so a
    token's quantization grid depends on that token's features alone —
    greedy tokens then depend neither on which requests share a batch nor on
    bucket padding. ``act_scale_axis`` keeps one scale per slice of that
    axis instead. Weights keep per-tensor scales."""

    mode: str = "plain"                       # plain | mp | probe
    mp: Optional[dict] = None                 # op name -> format name
    impl: str = "simulate"                    # simulate | native | kernel
    probes: Optional[dict] = None             # op name -> (p_lhs, p_rhs)
    captures: Optional[dict] = None           # out: op name -> (lhs, rhs)
    registry: Optional[list] = None           # out: list[OpInfo]
    scales: Optional[dict] = None             # op name -> (s_lhs, s_rhs)
    default_format: str = "bf16"
    act_scale_axis: Optional[int] = None
    act_scale_token: bool = False
    # linear ops whose weight operand the caller passes quantized already
    # (FSDP's gathered codes: :func:`gathered_weight`)
    gathered: frozenset = frozenset()

    def format_for(self, name: str) -> str:
        if self.mp is None:
            return self.default_format
        return self.mp.get(name, self.default_format)


def _einsum_macs(spec: str, lhs_shape, rhs_shape) -> int:
    """MAC count of an einsum: product of all distinct dimension sizes."""
    a, b = spec.split("->")[0].split(",")
    dims: dict[str, int] = {}
    for labels, shape in ((a, lhs_shape), (b, rhs_shape)):
        for ch, s in zip(labels, shape):
            dims[ch] = int(s)
    return int(math.prod(dims.values()))


def _maybe_register(ctx: QuantContext, name: str, kind: str, spec: str,
                    lhs, rhs, out) -> None:
    if ctx.registry is None:
        return
    ctx.registry.append(OpInfo(
        name=name, kind=kind, spec=spec, lhs_shape=tuple(lhs.shape),
        rhs_shape=tuple(rhs.shape), out_shape=tuple(out.shape),
        macs=_einsum_macs(spec, lhs.shape, rhs.shape),
        weight_elems=(math.prod(rhs.shape) if kind == KIND_LINEAR else 0)))


def _quantize_operand(x: torch.Tensor, fmt_name: str, impl: str, scale,
                      axis=None, batch_rows: bool = False) -> torch.Tensor:
    """The operand as the MP matmul consumes it (``batch_rows``: an
    activation, whose dim 0 a training mesh splits over ``data``)."""
    fmt = get_format(fmt_name)
    if not fmt.is_quantized:
        return x
    if impl == "native" and fmt.dtype is not None:
        return qtensor.quantize(x, fmt_name, axis=axis, scale=scale,
                                batch_rows=batch_rows).dequantize(x.dtype)
    return qtensor.fake_quant(x, fmt_name, axis=axis, scale=scale,
                              batch_rows=batch_rows)


def _stored(q: qtensor.QTensor) -> tuple:
    """The kept form of a weight's ``QTensor``: an emulated format's codes
    (bf16 values on the fp4 grid, every one of which e4m3 holds exactly)
    at one byte each, beside the dequant scale as a host float (read once,
    here, so no use syncs)."""
    if q.data.dtype == torch.bfloat16:
        q = qtensor.QTensor(q.data.to(torch.float8_e4m3fn), q.scale_inv,
                            q.fmt_name)
    return q, float(q.scale_inv)


def _dequantized(codes: torch.Tensor, s_inv: float, q: qtensor.QTensor,
                 dtype) -> torch.Tensor:
    """Kept codes as the matmul consumes them (``_weight_operand``)."""
    if codes.element_size() == 1 or dtype == torch.float32:
        return codes.to(dtype).mul_(s_inv)
    return qtensor.QTensor(codes, q.scale_inv, q.fmt_name).dequantize(dtype)


def gathered_weight(ctx: "QuantContext", name: str, w: torch.Tensor,
                    dim: int) -> tuple:
    """(the whole of linear op ``name``'s weight, of which ``w`` is this
    rank's block along ``dim`` over ``data`` (FSDP), the context the op
    runs under). A weight that takes gradients, or that the op runs
    unquantized, is gathered as it is (``sharding.dp_gather_param``) and
    ``ctx`` returned unchanged. A constant weight the op quantizes (fake
    quant) is quantized on the block instead, with the whole weight's
    per-tensor scale (its amax maxed over ``data`` and ``model``), kept in
    the weight cache on the block, and only its one-byte codes are
    gathered: the codes of the whole weight bit for bit (the scale is per
    tensor), dequantized as :func:`_weight_operand` would; the context
    returned names the op in ``gathered``, so that the op takes them as
    they are."""
    fmt_name = ctx.format_for(name) if ctx.mode == "mp" else None
    if fmt_name is None or not get_format(fmt_name).is_quantized \
            or (torch.is_grad_enabled() and w.requires_grad) \
            or w.element_size() == 1:
        return dp_gather_param(w, dim), ctx
    if ctx.impl == "kernel":
        raise NotImplementedError(
            f"{name}: the fp8 kernels' padded weight form under FSDP (the "
            f"fake-quant forms gather a block's codes)")
    scale = None
    if ctx.scales is not None and name in ctx.scales:
        scale = ctx.scales[name][1]
    q, s_inv = weight_cache.cached(
        w, ("fsdp", fmt_name),
        lambda: _stored(qtensor.quantize(w, fmt_name, scale=scale,
                                         batch_rows=True)), scale=scale)
    whole = _dequantized(dp_gather_param(q.data, dim), s_inv, q, w.dtype)
    return whole, dataclasses.replace(ctx, gathered=ctx.gathered | {name})


def _weight_operand(w: torch.Tensor, fmt_name: str, scale) -> torch.Tensor:
    """A linear op's weight as the MP matmul consumes it: quantized once
    per format (per-tensor scale), dequantized at each use — the bits of
    :func:`_quantize_operand` on the same weight. One-byte codes widen
    exactly to ``w.dtype`` (bf16 holds every e4m3 and e5m2 value) and are
    multiplied by the host scale, which the kernel does in f32 and rounds
    once to ``w.dtype``: the f32 product ``QTensor.dequantize`` rounds, in
    two passes over 3 bytes an element instead of three over 11."""
    if not get_format(fmt_name).is_quantized:
        return w
    if w.requires_grad:               # not a constant: quantized per call
        # on a training mesh the ranks' rows' parts of the quantized
        # weight's gradient are summed before the cast's backward rounds
        # them, as on one device (and shared out again ahead of the step's
        # sum over ``data``)
        return dp_copy(_quantize_operand(dp_share(w), fmt_name, "simulate",
                                         scale))
    q, s_inv = weight_cache.cached(
        w, ("fake", fmt_name),
        lambda: _stored(qtensor.quantize(w, fmt_name, scale=scale)),
        scale=scale)
    return _dequantized(q.data, s_inv, q, w.dtype)


# Einsum labels that index batch or token positions in the op specs: B/T/S
# (batch, q-tokens, k-tokens), E/N (expert, token-within-expert) and
# lowercase b/c/q/k. Per-token quantization keeps these axes and reduces the
# rest. CONTRACT: these letters are reserved for batch/token axes in every
# qeinsum/bgemm spec.
_TOKEN_LABELS = frozenset("BTSENbcqk")


def _token_scale_axes(labels: str) -> tuple:
    """Reduce axes for an activation operand's per-token scale (possibly
    empty: a per-element scale — never a per-tensor fallback)."""
    return tuple(i for i, ch in enumerate(labels) if ch not in _TOKEN_LABELS)


def act_quant_axes(ctx: QuantContext, ndim: int) -> Optional[tuple]:
    """Scale-reduction axes for an activation operand: everything except the
    per-sequence axis (None -> per-tensor scale)."""
    if ctx.act_scale_axis is None:
        return None
    keep = ctx.act_scale_axis % ndim
    return tuple(a for a in range(ndim) if a != keep)


def einsum_f32acc(spec: str, lhs: torch.Tensor, rhs: torch.Tensor,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """``einsum`` with float32 accumulation and one rounding to
    ``out_dtype`` — the reference's ``preferred_element_type=f32`` product.
    When the result keeps a reduced-precision operand dtype, the operands
    stay as they are: cuBLAS on CUDA (reduced-precision reductions off, see
    ``repro_torch.device``) and the CPU's bf16 GEMM both accumulate in f32
    and round once. Widening bf16 operands to f32 is exact, but the CPU's
    f32 GEMM then sums in another order than XLA's CPU dot, and the f32
    sums round to different bf16 values in about one output of a thousand
    (a decode step's ``down_proj`` at M = 2); the bf16 GEMM agrees with the
    reference there. Otherwise the operands are widened to f32 first. A
    ``meta`` trace (the dry run's) takes the card's route."""
    if out_dtype == lhs.dtype and (
            lhs.device.type in ("cuda", "meta")
            or (lhs.dtype in (torch.bfloat16, torch.float16)
                and rhs.dtype == lhs.dtype)):
        return torch.einsum(spec, lhs, rhs.to(lhs.dtype))
    return torch.einsum(spec, lhs.float(), rhs.float()).to(out_dtype)


def _kernel_route(ctx: QuantContext, kind: str, lhs: torch.Tensor,
                  rhs: torch.Tensor) -> bool:
    """Whether a quantized op takes the fp8 kernels (module docstring)."""
    if ctx.impl != "kernel" or kind != KIND_LINEAR or rhs.ndim != 2:
        return False
    return lhs.ndim == 2 or (ctx.act_scale_axis is None
                             and not ctx.act_scale_token)


def _kernel_linear(lhs: torch.Tensor, rhs: torch.Tensor, fmt_name: str,
                   out_dtype) -> torch.Tensor:
    from repro_torch.kernels import ops as kops   # kernels import qops
    lead = lhs.shape[:-1]
    y = kops.fp8_linear(lhs.reshape(-1, lhs.shape[-1]), rhs,
                        fmt_name=fmt_name, out_dtype=out_dtype)
    return y.reshape(*lead, rhs.shape[0])


def qeinsum(ctx: QuantContext, name: str, spec: str, lhs: torch.Tensor,
            rhs: torch.Tensor, kind: str = KIND_LINEAR,
            out_dtype: Optional[torch.dtype] = None,
            copy_lhs: bool = False) -> torch.Tensor:
    """Quantizable einsum — the single entry point for L_lin and L_BGEMM.
    The product is rounded once to ``out_dtype`` (default: ``lhs``'s).
    ``copy_lhs``: ``lhs`` is whole on every rank of a mesh's ``model`` axis
    and ``rhs`` holds this rank's block of the output features; the operand
    as the product consumes it (quantized) passes through
    ``sharding.tp_copy``, so the ranks' parts of its gradient are summed
    before the quantization's backward sees them, as on one device."""
    out_dtype = out_dtype or lhs.dtype
    if ctx.mode == "probe":
        if ctx.probes is not None and name in ctx.probes:
            p_lhs, p_rhs = ctx.probes[name]
            if ctx.captures is not None:
                ctx.captures[name] = (lhs, rhs)
            lhs = lhs + p_lhs.to(lhs.dtype)
            rhs = rhs + p_rhs.to(rhs.dtype)
    elif ctx.mode == "mp":
        if ctx.impl not in _IMPLS:
            hint = (" — the port's fp8 kernels are impl='kernel'"
                    if ctx.impl == "pallas" else "")
            raise ValueError(f"QuantContext.impl={ctx.impl!r}: use one of "
                             f"{_IMPLS}{hint}")
        fmt_name = ctx.format_for(name)
        if get_format(fmt_name).is_quantized:
            s_lhs = s_rhs = None
            if ctx.scales is not None and name in ctx.scales:
                s_lhs, s_rhs = ctx.scales[name]
            if _kernel_route(ctx, kind, lhs, rhs):
                return _kernel_linear(tp_copy(lhs) if copy_lhs else lhs, rhs,
                                      fmt_name, out_dtype)
            if ctx.act_scale_token:
                a_l, b_l = spec.split("->")[0].split(",")
                lhs_axes = _token_scale_axes(a_l)
                rhs_axes = _token_scale_axes(b_l)
            else:
                lhs_axes = act_quant_axes(ctx, lhs.ndim)
                rhs_axes = act_quant_axes(ctx, rhs.ndim)
            lhs = _quantize_operand(lhs, fmt_name, ctx.impl, s_lhs, lhs_axes,
                                    batch_rows=True)
            if kind != KIND_LINEAR:
                rhs = _quantize_operand(rhs, fmt_name, ctx.impl, s_rhs,
                                        rhs_axes, batch_rows=True)
            elif name not in ctx.gathered:   # (else FSDP's gathered codes)
                rhs = _weight_operand(rhs, fmt_name, s_rhs)
    elif ctx.mode != "plain":
        raise ValueError(f"unknown QuantContext mode {ctx.mode!r}")
    if copy_lhs:
        lhs = tp_copy(lhs)
    out = einsum_f32acc(spec, lhs, rhs, out_dtype)
    _maybe_register(ctx, name, kind, spec, lhs, rhs, out)
    return out


def linear(ctx: QuantContext, name: str, x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None,
           out_dtype: Optional[torch.dtype] = None,
           copy_lhs: bool = False) -> torch.Tensor:
    """y = x @ w^T (+ b); w: (K, C) per eq. (8). ``x`` may have any leading
    dims; a 3-D ``w`` is an expert-grouped GEMM aligned with ``x``.
    ``out_dtype`` (default ``x``'s) is the product's one rounding (a
    row-parallel shard's partial sums stay f32 until they are summed);
    ``copy_lhs`` as in :func:`qeinsum`."""
    if w.dtype != x.dtype and w.element_size() == 1:
        w = w.to(x.dtype)            # fp8-stored weights: dequant at use
    if w.ndim == 2:
        xl = "BC" if x.ndim == 2 else "BSC" if x.ndim == 3 else None
        if xl is None:                # flatten exotic ranks
            lead = x.shape[:-1]
            y = linear(ctx, name, x.reshape(-1, x.shape[-1]), w, b,
                       out_dtype, copy_lhs)
            return y.reshape(*lead, w.shape[0])
        spec = f"{xl},KC->{xl[:-1]}K"
    elif w.ndim == 3 and x.ndim == 3:
        spec = "ENC,EKC->ENK"
    else:
        raise ValueError(f"unsupported linear ranks x={tuple(x.shape)} "
                         f"w={tuple(w.shape)}")
    y = qeinsum(ctx, name, spec, x, w, kind=KIND_LINEAR, out_dtype=out_dtype,
                copy_lhs=copy_lhs)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def bgemm(ctx: QuantContext, name: str, spec: str, a: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """Batched GEMM between two activations (qk_matmul / av_matmul)."""
    return qeinsum(ctx, name, spec, a, b, kind=KIND_BGEMM)
