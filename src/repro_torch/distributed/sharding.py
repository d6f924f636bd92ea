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

Serving does not run the model on DTensors: each rank holds its local
shard of every leaf (:func:`local_shard`) and the layers call the explicit
collectives at the bottom of this module (``tp_*`` over the ``model``
axis, ``dp_gather`` over ``data``) through the layout that
:func:`serving_layout_scope` makes current. With no layout current they are
identities, so the single-rank path runs the code it ran before.
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
           "batch_pspec", "named", "shard_hint", "axis_sizes", "local_shard",
           "ServingMeshLayout", "serving_layout_scope",
           "current_serving_layout", "tp_sum", "tp_max",
           "tp_gather", "tp_slice", "dp_gather"]

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
    """``{axis name: size}`` of a fake mesh or a ``DeviceMesh``."""
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
    process groups the collectives run over."""
    mesh: object
    data: int
    model: int
    n_slots: int
    block_size: int = 0
    n_blocks: int = 0
    shard_pages: bool = False
    blocks_per_shard: int = 0

    def fused_ok(self, batch: int, n_kv_heads: int) -> bool:
        """Can the fused paged kernel run per shard?"""
        return batch % self.data == 0 and n_kv_heads % self.model == 0

    @property
    def coords(self) -> dict:
        """This rank's index along every mesh axis."""
        names = self.mesh.mesh_dim_names
        return dict(zip(names, self.mesh.get_coordinate()))

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
# Collectives of a serving step (identities without a current layout)
# ---------------------------------------------------------------------------
# Tensor parallelism here is the Megatron split the rules imply: a weight
# sharded on its output features gives each rank a slice of the features
# (gathered where the next op needs them whole), a weight sharded on its
# input features gives partial sums (summed over ``model``). Quantization
# scales are maxima over whole tensors or whole token rows, so they are
# maxed over ``model`` (a no-op for a replicated operand). Every rank
# issues the same collectives in the same order: the model code is the
# same on all of them.

def _all_reduce(x: torch.Tensor, op, axis: str) -> torch.Tensor:
    import torch.distributed as dist
    layout = _SERVING_LAYOUT.get()
    if layout is None:
        return x
    x = x.contiguous()
    dist.all_reduce(x, op=op, group=layout.group(axis))
    return x


def tp_sum(x: torch.Tensor) -> torch.Tensor:
    """Partial sums of a row-parallel product, summed over ``model``."""
    import torch.distributed as dist
    return _all_reduce(x, dist.ReduceOp.SUM, "model")


def tp_max(x: torch.Tensor) -> torch.Tensor:
    """An amax over ``model`` (quantization scales of sharded operands)."""
    import torch.distributed as dist
    return _all_reduce(x, dist.ReduceOp.MAX, "model")


def _all_gather(x: torch.Tensor, dim: int, axis: str, n: int) -> torch.Tensor:
    import torch.distributed as dist
    layout = _SERVING_LAYOUT.get()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=layout.group(axis))
    return torch.cat(parts, dim=dim)


def tp_gather(x: torch.Tensor, full: int, dim: int = -1) -> torch.Tensor:
    """The whole of a tensor whose ``dim`` is this rank's block of
    ``full`` values over ``model``; a tensor that already holds ``full``
    is returned as it is."""
    if x.shape[dim] == full:
        return x
    layout = _SERVING_LAYOUT.get()
    if layout is None or x.shape[dim] * layout.model != full:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is no model shard "
                         f"of {full}")
    return _all_gather(x, dim, "model", layout.model)


def tp_slice(x: torch.Tensor, local: int, dim: int = -1) -> torch.Tensor:
    """This rank's block (of ``local`` values) of ``dim`` of a whole
    tensor; ``x`` itself when the block is the whole dim."""
    full = x.shape[dim]
    if local == full:
        return x
    layout = _SERVING_LAYOUT.get()
    if layout is None or local * layout.model != full:
        raise ValueError(f"no model shard of {local} in dim {dim} of "
                         f"{tuple(x.shape)}")
    return x.narrow(dim, layout.model_index * local, local)


def dp_gather(x: torch.Tensor) -> torch.Tensor:
    """Rows of every ``data`` shard, in slot order (a step's tokens,
    flags and logits read back on every rank)."""
    layout = _SERVING_LAYOUT.get()
    if layout is None:
        return x
    return _all_gather(x, 0, "data", layout.data)
