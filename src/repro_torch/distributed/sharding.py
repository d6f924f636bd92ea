"""Logical-axis sharding rules and the serving mesh layout (port of
``repro/distributed/sharding.py``).

Every ParamSpec carries logical axis names; the rules map them to (tuples
of) mesh axes. Assignment is divisibility-checked: a dim that the mesh-axis
product does not divide (hymba's 5 attention heads of 16 values on a
3-way model axis, whisper's 51865 vocab) falls back to replication instead
of failing. Each mesh axis is used at most once per leaf.

DP  = batch over (pod, data)      TP = ffn/heads/vocab over model
EP  = experts over model          SP = sequence over model (MLA latents)
ZeRO-1 = optimizer state additionally sharded over data (largest free dim).

The rule functions take any object that names a mesh's axes and their
sizes: the reference tests' fake meshes (``axis_names`` and a ``shape``
mapping) and torch's ``DeviceMesh`` (``mesh_dim_names`` and a ``shape``
tuple). They return the reference's assignment as a plain tuple (one entry
per dim: an axis name, a tuple of names, or None; trailing Nones dropped,
as ``PartitionSpec`` prints), and :func:`placements` gives the same
assignment as DTensor placements.

Serving and training do not run the model on DTensors: each rank holds its
local shard of every leaf (:func:`local_shard`) and the layers call the
explicit collectives at the bottom of this module (``tp_*`` over the
``model`` axis, ``dp_*`` over ``data``) through the layout that
:func:`serving_layout_scope` makes current (:func:`training_layout` for a
train step). The collectives are differentiable, with Megatron's backward.
With no layout current they are identities, so the single-rank path runs
the code it ran before.

FSDP (``FSDP_RULES``, ZeRO-3): a layout carries the rules its leaves were
placed by, and :func:`data_split_dims` tells which dim of each leaf ``data``
splits. The model gathers such a leaf where it uses it
(:func:`dp_gather_param`, an all-gather over ``data`` whose backward
reduce-scatters the whole gradient into this rank's block), so every rank
holds only its block of the params, their gradients and their moments.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional

import torch

from repro_torch.nn.spec import ParamSpec

__all__ = ["DEFAULT_RULES", "FSDP_RULES", "partition_spec",
           "zero_partition_spec", "param_shardings", "placements",
           "batch_pspec", "named", "shard_hint", "axis_sizes", "local_shape",
           "local_shard", "data_split_dims", "dp_gather_param",
           "ServingMeshLayout", "training_layout", "serving_layout_scope",
           "current_serving_layout", "tp_sum", "tp_max", "tp_copy",
           "tp_gather", "tp_slice", "dp_sum", "dp_gather", "dp_copy", "dp_share", "amax_over",
           "gather_leaf", "mesh_max", "is_mesh_root", "CollectiveLog",
           "counting_collectives", "record_collective", "layer_stack_scope"]

# logical axis -> candidate mesh axes (tuple = shard jointly over all)
DEFAULT_RULES = {
    "vocab": ("model",),
    "ffn": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": ("model",),   # fallback when kv_heads % model != 0
    "kv_seq": ("model",),     # MLA latent cache: sequence-sharded
    "kv_lora": ("model",),
    "experts": ("model",),
    "ssm_inner": ("model",),
    "ssm_heads": ("model",),
    "embed": (),            # replicated (activations are batch-sharded)
    "layers": (),           # stacked-layer leading dim: never sharded
    "act_batch": ("pod", "data"),
    "kv_blocks": ("data",),   # paged-KV pool pages: device-sharded pool
    None: (),
}

# FSDP / ZeRO-3: additionally shard the replicated 'embed' dim of every
# weight over 'data' (and 'pod' when present)
FSDP_RULES = dict(DEFAULT_RULES, embed=("data", "pod"))


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a fake mesh, a ``DeviceMesh`` or such a
    mapping itself."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    shape = mesh.shape
    return {a: int(shape[a]) for a in mesh.axis_names}


def _mesh_size(sizes: dict, axes: tuple) -> int:
    return math.prod(sizes[a] for a in axes) if axes else 1


def partition_spec(spec: ParamSpec, mesh, rules: Optional[dict] = None
                   ) -> tuple:
    """The reference's per-dim mesh-axis assignment of ``spec``."""
    rules = rules or DEFAULT_RULES
    sizes = axis_sizes(mesh)
    parts = []
    used: set = set()
    for dim, ax in zip(spec.shape, spec.logical_axes):
        cands = tuple(a for a in rules.get(ax, ())
                      if a in sizes and a not in used)
        assigned = None
        # the full tuple first, then progressively shorter prefixes
        for k in range(len(cands), 0, -1):
            sub = cands[:k]
            if dim % _mesh_size(sizes, sub) == 0:
                assigned = sub if len(sub) > 1 else sub[0]
                used.update(sub)
                break
        parts.append(assigned)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def zero_partition_spec(spec: ParamSpec, mesh, rules: Optional[dict] = None
                        ) -> tuple:
    """Param assignment + ZeRO-1: one replicated dim also over 'data'."""
    base = partition_spec(spec, mesh, rules)
    sizes = axis_sizes(mesh)
    if "data" not in sizes:
        return base
    parts = list(base) + [None] * (len(spec.shape) - len(base))
    flat_used = {a for p in parts
                 for a in (p if isinstance(p, tuple) else (p,)) if a}
    if "data" in flat_used:
        return base
    # the largest divisible unassigned dim, later dims on ties (contiguous
    # shards)
    best = None
    for i, (dim, p) in enumerate(zip(spec.shape, parts)):
        if p is None and dim % sizes["data"] == 0 and dim > 1:
            if best is None or dim >= spec.shape[best]:
                best = i
    if best is not None:
        parts[best] = "data"
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements(pspec: tuple, mesh) -> tuple:
    """An assignment as DTensor placements, one per mesh axis (``Shard(d)``
    on every axis that shards dim ``d``, else ``Replicate()``)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, p in enumerate(pspec):
        for a in (p if isinstance(p, tuple) else (p,)):
            if a is not None:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def param_shardings(specs: dict, mesh, rules: Optional[dict] = None,
                    zero: bool = False) -> dict:
    """``{path: DTensor placements}`` of every spec."""
    fn = zero_partition_spec if zero else partition_spec
    return {path: placements(fn(s, mesh, rules), mesh)
            for path, s in specs.items()}


def shard_hint(x, *spec):
    """The reference's best-effort ``with_sharding_constraint``. Serving
    runs on each rank's local tensors, so there is nothing to constrain:
    the identity."""
    return x


def batch_pspec(mesh, extra_dims: int = 1) -> tuple:
    """Batch dim over (pod, data); the remaining dims replicated."""
    sizes = axis_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    lead = dp if len(dp) > 1 else (dp[0] if dp else None)
    return (lead,) + (None,) * extra_dims


def named(mesh, pspec: tuple) -> tuple:
    """The reference's ``NamedSharding(mesh, pspec)``: the DTensor
    placements of ``pspec`` on ``mesh``."""
    return placements(pspec, mesh)


def local_shape(shape: tuple, pspec: tuple, sizes: dict) -> tuple:
    """The shape of a rank's block of a leaf of ``shape`` under ``pspec``."""
    out = list(shape)
    for d, p in enumerate(pspec):
        axes = tuple(a for a in (p if isinstance(p, tuple) else (p,)) if a)
        out[d] //= _mesh_size(sizes, axes)
    return tuple(out)


def local_shard(t: torch.Tensor, pspec: tuple, sizes: dict,
                coords: dict) -> torch.Tensor:
    """Rank ``coords``'s block of ``t`` under ``pspec`` (contiguous, equal
    blocks in axis order, as a ``NamedSharding`` lays them out). A leaf
    that no axis splits is returned as it is, not copied."""
    out = t
    for d, p in enumerate(pspec):
        axes = tuple(a for a in (p if isinstance(p, tuple) else (p,)) if a)
        n = _mesh_size(sizes, axes)
        if n == 1:
            continue
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + coords[a]
        size = t.shape[d] // n
        out = out.narrow(d, idx * size, size)
    return out if out is t else out.contiguous()


# ---------------------------------------------------------------------------
# Serving mesh layout
# ---------------------------------------------------------------------------
# The paged-attention dispatch inside the model needs to know how serving
# state is laid out over the mesh: whether KV pages are sharded over
# ``data`` (block ids are then translated to shard-local ones) and whether
# the KV heads divide ``model``. A contextvar carries the layout;
# ``get_serving_step`` activates it around every step of a mesh engine.

@dataclasses.dataclass(frozen=True)
class ServingMeshLayout:
    """Static description of how serving state is spread over a mesh.

    ``shard_pages`` is True when the paged pool's block dim is sharded over
    ``data`` (``n_blocks % data == 0``); each shard then owns
    ``blocks_per_shard`` consecutive pages and keeps its own trash block at
    local id 0. Slots always shard over ``data`` (``n_slots % data == 0``
    is checked when the layout is planned). ``mesh`` is a ``DeviceMesh``
    for a layout that serves, or any object :func:`axis_sizes` reads for a
    host-side plan; only the former has this rank's coordinates and the
    process groups the collectives run over. ``rules`` are the rules the
    params were placed by (None: ``DEFAULT_RULES``), kept as a tuple of
    their items so that the layout hashes; a dict is converted."""
    mesh: object
    data: int
    model: int
    n_slots: int
    block_size: int = 0
    n_blocks: int = 0
    shard_pages: bool = False
    blocks_per_shard: int = 0
    rules: Optional[tuple] = None

    def __post_init__(self):
        if isinstance(self.rules, dict):
            object.__setattr__(self, "rules", tuple(self.rules.items()))

    @property
    def rule_map(self) -> dict:
        """The rules the params were placed by, as a dict."""
        return DEFAULT_RULES if self.rules is None else dict(self.rules)

    def fused_ok(self, batch: int, n_kv_heads: int) -> bool:
        """Can the fused paged kernel run per shard?"""
        return batch % self.data == 0 and n_kv_heads % self.model == 0

    @property
    def coords(self) -> dict:
        """This rank's index along every mesh axis."""
        names = self.mesh.mesh_dim_names
        return dict(zip(names, self.mesh.get_coordinate()))

    @property
    def sizes(self) -> dict:
        """``{axis: size}`` of the mesh's two axes."""
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.coords.get("data", 0)

    @property
    def model_index(self) -> int:
        return self.coords.get("model", 0)

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    @property
    def slots_per_shard(self) -> int:
        return self.n_slots // self.data

    def block_offset(self) -> int:
        """Global id of this rank's first page (0 for a replicated pool)."""
        return self.data_index * self.blocks_per_shard if self.shard_pages \
            else 0


def training_layout(mesh, rules: Optional[dict] = None
                    ) -> ServingMeshLayout:
    """The layout a training step runs under: the mesh's groups and this
    rank's coordinates, no slots or pages (the batch's rows split over
    ``data``, the weights by ``rules``)."""
    sizes = axis_sizes(mesh)
    return ServingMeshLayout(mesh=mesh, data=int(sizes.get("data", 1)),
                             model=int(sizes.get("model", 1)), n_slots=0,
                             rules=rules)


def data_split_dims(specs: dict, layout: ServingMeshLayout) -> dict:
    """``{path: the dim of the leaf that data splits}`` under the layout's
    rules, None for a leaf that is whole on every data rank (every leaf
    under ``DEFAULT_RULES``; under ``FSDP_RULES`` a leaf whose ``embed``
    ``data`` does not divide, as :func:`partition_spec` decides). A stacked
    leaf's leading ``layers`` dim is never split."""
    out = {}
    for path, spec in specs.items():
        pspec = partition_spec(spec, layout.sizes, layout.rule_map)
        out[path] = next((d for d, p in enumerate(pspec)
                          if "data" in (p if isinstance(p, tuple) else (p,))),
                         None)
    return out


_SERVING_LAYOUT: contextvars.ContextVar = contextvars.ContextVar(
    "serving_mesh_layout", default=None)


@contextlib.contextmanager
def serving_layout_scope(layout: Optional[ServingMeshLayout]):
    token = _SERVING_LAYOUT.set(layout)
    try:
        yield layout
    finally:
        _SERVING_LAYOUT.reset(token)


def current_serving_layout() -> Optional[ServingMeshLayout]:
    return _SERVING_LAYOUT.get()


# ---------------------------------------------------------------------------
# Collectives of a mesh step (identities without a current layout)
# ---------------------------------------------------------------------------
# Tensor parallelism here is the Megatron split the rules imply: a weight
# sharded on its output features gives each rank a slice of the features
# (gathered where the next op needs them whole), a weight sharded on its
# input features gives partial sums (summed over ``model``). Quantization
# scales are maxima over whole tensors or whole token rows, so they are
# maxed over ``model`` (a no-op for a replicated operand) and, for an
# activation whose rows a training batch splits, over ``data`` too. Every
# rank issues the same collectives in the same order: the model code is the
# same on all of them.
#
# Each collective is differentiable (training runs the same layers), with
# the Megatron backward: a sum's gradient is the identity, a gather's is
# this rank's block, a slice's is the gather of the blocks' gradients, and
# :func:`tp_copy` (the identity) sums its gradient over ``model``. The
# backward reads the groups saved at the forward: it may run on another
# thread, outside the layout's scope. Without gradients the collectives run
# as plain calls on their operands.


def _dist():
    import torch.distributed as dist
    return dist


# ---------------------------------------------------------------------------
# Collective accounting
# ---------------------------------------------------------------------------
# The reference reads a step's collectives out of its compiled HLO. The
# port issues them itself, each at one of a few call sites, so it counts
# them there: while a :class:`CollectiveLog` is on (:func:`counting_
# collectives`), every collective adds its result's bytes under its kind,
# split by whether it ran inside the model's layer stack (its forward, the
# recomputation of a checkpointed layer, or the backward of a collective
# issued there) or outside it (embedding, head, loss, optimizer). A step
# runs every layer and every microbatch, so these are totals, where XLA's
# HLO counts a loop body once.

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_IN_STACK: contextvars.ContextVar = contextvars.ContextVar(
    "in_layer_stack", default=False)
_LOG: list = []                 # the CollectiveLog on, if any


class CollectiveLog:
    """Bytes and counts of the collectives issued while it is on."""

    def __init__(self):
        self.bytes = {k: 0.0 for k in _COLLECTIVES}
        self.counts = {k: 0 for k in _COLLECTIVES}
        self.toplevel = 0.0
        self.inloop = 0.0

    def add(self, kind: str, nbytes: float, in_stack: bool) -> None:
        self.bytes[kind] += nbytes
        self.counts[kind] += 1
        if in_stack:
            self.inloop += nbytes
        else:
            self.toplevel += nbytes

    def summary(self) -> dict:
        """The keys of the reference's ``parse_collective_bytes``: bytes
        by kind, ``total``, ``toplevel``, ``inloop`` and ``counts``."""
        return {**self.bytes, "total": sum(self.bytes.values()),
                "toplevel": self.toplevel, "inloop": self.inloop,
                "counts": dict(self.counts)}


@contextlib.contextmanager
def counting_collectives():
    """Count every collective issued inside the block into the yielded
    :class:`CollectiveLog`."""
    log = CollectiveLog()
    _LOG.append(log)
    try:
        yield log
    finally:
        _LOG.remove(log)


def record_collective(kind: str, t: torch.Tensor) -> None:
    """Count ``t`` (a collective's result) into the logs that are on."""
    if _LOG:
        nbytes = float(t.numel() * t.element_size())
        for log in _LOG:
            log.add(kind, nbytes, _IN_STACK.get())


@contextlib.contextmanager
def layer_stack_scope(on: bool = True):
    """Mark the collectives issued inside the block as the layer stack's
    (the model runs each layer's body under it)."""
    token = _IN_STACK.set(on)
    try:
        yield
    finally:
        _IN_STACK.reset(token)


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _collective(name: str, old: str):
    """``torch.distributed``'s collective ``name``, else ``old``: torch
    2.13 renames ``all_gather_into_tensor`` and ``reduce_scatter_tensor``
    to ``all_gather_single`` and ``reduce_scatter_single`` and deprecates
    the old names, which older releases alone have."""
    dist = _dist()
    return getattr(dist, name, None) or getattr(dist, old)


def _gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ranks' blocks of ``x`` joined along ``dim``, contiguous: one
    ``all_gather_into_tensor`` into the blocks joined along dim 0 (the
    form gloo takes too), moved to ``dim``. One-byte values travel as
    ``uint8`` (gloo has no fp8 types)."""
    dim = dim % x.dim()
    byte = x.element_size() == 1 and x.dtype != torch.uint8
    y = x.contiguous()
    y = y.view(torch.uint8) if byte else y
    out = y.new_empty((n * y.shape[0],) + tuple(y.shape[1:]))
    _collective("all_gather_single", "all_gather_into_tensor")(
        out, y, group=group)
    out = out.view((n,) + tuple(y.shape)).movedim(0, dim).flatten(dim,
                                                                  dim + 1)
    out = out.view(x.dtype) if byte else out
    record_collective("all-gather", out)
    return out


def _scatter_sum(g: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """This rank's block along ``dim`` of ``g`` summed over the ranks of
    ``group``: one ``reduce_scatter_tensor`` in f32, rounded once to
    ``g``'s dtype (a bf16 leaf's summed gradient is then bf16, where the
    step's ``dp_sum`` of a whole leaf's gradient stays f32)."""
    y = g.float().unflatten(dim, (n, -1)).movedim(dim, 0).contiguous()
    out = y.new_empty(y.shape[1:])
    _collective("reduce_scatter_single", "reduce_scatter_tensor")(
        out, y.flatten(0, 1), group=group)
    record_collective("reduce-scatter", out)
    return out.to(g.dtype)


def _summed(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``group`` (a sum by default), laid
    out in memory as ``x`` is (a later reduction of it, such as a gradient
    norm's sum, then adds in the same order as on one device)."""
    dist = _dist()
    y = x.clone()
    flat = y.permute(sorted(range(y.dim()), key=lambda d: -y.stride(d)))
    if not flat.is_contiguous():
        y = flat = x.contiguous().clone()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)
    record_collective("all-reduce", y)
    return y


class _Sum(torch.autograd.Function):
    """All-reduce sum; the gradient passes as it is (the sum is replicated,
    so each rank's cotangent of it is already the whole)."""

    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """The identity; its gradient summed over the group (Megatron's "f":
    a replicated tensor feeding a rank's block of the features)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.in_stack = group, _IN_STACK.get()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with layer_stack_scope(ctx.in_stack):
            return _summed(g, ctx.group), None


class _Gather(torch.autograd.Function):
    """All-gather of the ranks' blocks along ``dim``; the gradient is this
    rank's block of the cotangent."""

    @staticmethod
    def forward(ctx, x, dim, group, n, index):
        ctx.dim, ctx.index, ctx.size = dim, index, x.shape[dim]
        return _gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size)
                .contiguous(), None, None, None, None)


class _GatherParam(torch.autograd.Function):
    """All-gather of the ``data`` ranks' blocks of a weight along ``dim``;
    the backward reduce-scatters the whole gradient (every rank's rows'
    part of it) into this rank's block, summed over ``data``."""

    @staticmethod
    def forward(ctx, w, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        ctx.in_stack = _IN_STACK.get()
        return _gather(w, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        with layer_stack_scope(ctx.in_stack):
            return (_scatter_sum(g, ctx.dim, ctx.group, ctx.n), None,
                    None, None)


class _Slice(torch.autograd.Function):
    """This rank's block of a replicated tensor; the gradient is the
    gather of every rank's block of the cotangent."""

    @staticmethod
    def forward(ctx, x, dim, local, group, n, index):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        ctx.in_stack = _IN_STACK.get()
        return x.narrow(dim, index * local, local).contiguous()

    @staticmethod
    def backward(ctx, g):
        with layer_stack_scope(ctx.in_stack):
            return (_gather(g, ctx.dim, ctx.group, ctx.n), None, None,
                    None, None, None)


def _amax(x: torch.Tensor, dims, groups) -> torch.Tensor:
    """``x``'s max over ``dims`` (see :func:`amax_over`), then over the
    ranks of each group."""
    if dims is None:
        m = x.amax()
    elif dims:
        m = x.amax(dim=dims, keepdim=True)
    else:
        m = x
    for group in groups:
        m = _summed(m, group, _dist().ReduceOp.MAX)
    return m


class _Amax(torch.autograd.Function):
    """The max of ``x`` over ``dims`` (all when None; none when ``()``,
    an elementwise max) and over the ranks of ``groups``. Its gradient goes
    to every element that holds the maximum, split evenly among all of
    them on all ranks (as ``torch.amax`` splits it among ties on one
    device): ``(g_sum / count) * mask``, the cotangent and the count of
    maxima summed over the groups. A replicated operand counts once per
    rank and its summed cotangent is split as many times, so the formula
    holds whether the ranks hold blocks of the operand or copies of it."""

    @staticmethod
    def forward(ctx, x, dims, groups):
        m = _amax(x, dims, groups)
        ctx.save_for_backward(x, m)
        ctx.dims, ctx.groups = dims, groups
        ctx.in_stack = _IN_STACK.get()
        return m

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        mask = x == m
        if ctx.dims is None:
            count = mask.sum()
        elif ctx.dims:
            count = mask.sum(dim=ctx.dims, keepdim=True)
        else:
            count = mask.long()
        with layer_stack_scope(ctx.in_stack):
            for group in ctx.groups:
                g, count = _summed(g, group), _summed(count, group)
        return (g / count) * mask, None, None


def _layout_axis(axis: str):
    """(group, size, this rank's index) of ``axis`` in the current layout,
    or None without one."""
    layout = _SERVING_LAYOUT.get()
    if layout is None:
        return None
    n = layout.data if axis == "data" else layout.model
    idx = layout.data_index if axis == "data" else layout.model_index
    return layout.group(axis), n, idx


def _sum_over(x: torch.Tensor, axis: str) -> torch.Tensor:
    got = _layout_axis(axis)
    if got is None:
        return x
    group = got[0]
    return _Sum.apply(x, group) if _grad(x) else _summed(x, group)


def tp_sum(x: torch.Tensor) -> torch.Tensor:
    """Partial sums of a row-parallel product, summed over ``model``."""
    return _sum_over(x, "model")


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """A sum over this rank's rows of a batch that ``data`` splits, summed
    over ``data`` (a training loss's numerator and denominator)."""
    return _sum_over(x, "data")


def tp_copy(x: torch.Tensor) -> torch.Tensor:
    """``x`` (whole on every rank) as the input of a weight that holds this
    rank's block of its output features: the identity, whose gradient is
    summed over ``model`` (each rank's is only its block's part)."""
    got = _layout_axis("model")
    if got is None or not _grad(x):
        return x
    return _Copy.apply(x, got[0])


class _Scaled(torch.autograd.Function):
    """The identity; its gradient multiplied by ``factor``."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def dp_copy(x: torch.Tensor) -> torch.Tensor:
    """``x`` (the same on every ``data`` rank) feeding this rank's rows: the
    identity, whose gradient is summed over ``data`` (each rank's holds its
    rows' part). Identity on a data axis of one rank."""
    got = _layout_axis("data")
    if got is None or got[1] == 1 or not _grad(x):
        return x
    return _Copy.apply(x, got[0])


def dp_share(x: torch.Tensor) -> torch.Tensor:
    """The identity, whose gradient is divided among the ``data`` ranks: a
    gradient :func:`dp_copy` already summed, ahead of the step's sum of
    every leaf's gradient over ``data``."""
    got = _layout_axis("data")
    if got is None or got[1] == 1 or not _grad(x):
        return x
    return _Scaled.apply(x, 1.0 / got[1])


def amax_over(x: torch.Tensor, dims=None, over_data: bool = False
              ) -> torch.Tensor:
    """``x.amax`` over ``dims`` (all when None, keepdim otherwise; ``()``
    keeps every element) and over ``model`` (and ``data`` with
    ``over_data``) under a current layout; differentiable as ``amax`` on
    one device (:class:`_Amax`)."""
    layout = _SERVING_LAYOUT.get()
    if layout is None:
        return _amax(x, dims, ())
    groups = (layout.group("model"),) + ((layout.group("data"),)
                                         if over_data else ())
    if _grad(x):
        return _Amax.apply(x, dims, groups)
    return _amax(x, dims, groups)


def tp_max(x: torch.Tensor) -> torch.Tensor:
    """An elementwise max over ``model`` (quantization scales of sharded
    operands)."""
    return amax_over(x, ())


def tp_gather(x: torch.Tensor, full: int, dim: int = -1) -> torch.Tensor:
    """The whole of a tensor whose ``dim`` is this rank's block of
    ``full`` values over ``model``; a tensor that already holds ``full``
    is returned as it is."""
    if x.shape[dim] == full:
        return x
    got = _layout_axis("model")
    if got is None or x.shape[dim] * got[1] != full:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is no model shard "
                         f"of {full}")
    group, n, idx = got
    dim = dim % x.dim()
    if _grad(x):
        return _Gather.apply(x, dim, group, n, idx)
    return _gather(x, dim, group, n)


def tp_slice(x: torch.Tensor, local: int, dim: int = -1) -> torch.Tensor:
    """This rank's block (of ``local`` values) of ``dim`` of a whole
    tensor; ``x`` itself when the block is the whole dim."""
    full = x.shape[dim]
    if local == full:
        return x
    got = _layout_axis("model")
    if got is None or local * got[1] != full:
        raise ValueError(f"no model shard of {local} in dim {dim} of "
                         f"{tuple(x.shape)}")
    group, n, idx = got
    if _grad(x):
        return _Slice.apply(x, dim % x.dim(), local, group, n, idx)
    return x.narrow(dim, idx * local, local)


def dp_gather(x: torch.Tensor) -> torch.Tensor:
    """Rows of every ``data`` shard, in slot order (a step's tokens,
    flags and logits read back on every rank)."""
    got = _layout_axis("data")
    if got is None:
        return x
    group, n, idx = got
    if _grad(x):
        return _Gather.apply(x, 0, group, n, idx)
    return _gather(x, 0, group, n)


def dp_gather_param(w: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole of a weight of which ``w`` is this rank's block along
    ``dim`` over ``data`` (FSDP), contiguous in the leaf's own layout. Its
    gradient is the whole gradient reduce-scattered over ``data``: this
    rank's block, already summed over the data ranks. The identity without
    a layout or on a data axis of one rank."""
    got = _layout_axis("data")
    if got is None or got[1] == 1:
        return w
    group, n, _ = got
    dim = dim % w.dim()
    if _grad(w):
        return _GatherParam.apply(w, dim, group, n)
    return _gather(w, dim, group, n)


# ---------------------------------------------------------------------------
# Whole leaves and host values over a mesh (checkpoints, the trainer)
# ---------------------------------------------------------------------------


def gather_leaf(t: torch.Tensor, pspec: tuple,
                layout: ServingMeshLayout) -> torch.Tensor:
    """The whole leaf of which ``t`` is this rank's block under ``pspec``
    (:func:`local_shard`'s inverse), on every rank of the layout's mesh:
    each split dim gathered over its axes, the last axis first."""
    for d, p in enumerate(pspec):
        for a in reversed(tuple(a for a in (p if isinstance(p, tuple)
                                            else (p,)) if a)):
            n = layout.data if a == "data" else layout.model
            if n > 1:
                t = _gather(t, d, layout.group(a), n)
    return t


def mesh_max(x: torch.Tensor, layout: ServingMeshLayout) -> torch.Tensor:
    """``x`` maxed over every rank of the layout's mesh (a barrier too)."""
    dist = _dist()
    for axis in ("model", "data"):
        x = _summed(x, layout.group(axis), dist.ReduceOp.MAX)
    return x


def is_mesh_root(layout: Optional[ServingMeshLayout]) -> bool:
    """True on the rank at the mesh's origin (every axis at 0), or with no
    mesh: the rank that prints and writes for the mesh."""
    return layout is None or not any(layout.coords.values())
