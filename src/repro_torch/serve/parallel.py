"""Mesh-sharded serving: layout planning and state placement (port of
``repro/serve/parallel.py``).

The continuous-batching engine becomes tensor-parallel here and in the
layers' collectives, as in the reference: weights shard through the
logical-axis rules the trainer uses (``sharding.partition_spec``, with the
divisibility fallback, so e.g. GQA ``kv_heads % model != 0`` shards
``head_dim`` instead), the paged pool's block-major leaves shard over the
mesh through their ``kv_blocks`` / ``kv_heads`` axes, and slot-major
serving state (decode rows, SSM state, dense rings) shards over ``data``.

One :class:`~repro_torch.distributed.sharding.ServingMeshLayout` describes
the arrangement. :func:`make_serving_layout` plans it once per engine (the
pool geometry comes from ``PagedCachePool.plan_blocks``, so the allocator
and the layout cannot disagree); ``get_serving_step`` makes it current
around every step, and the pools allocate this rank's shard of their
tensors from :func:`local_specs`.

Each rank holds plain tensors, its own block of every leaf: serving does
not run on DTensors (ROADMAP.md, C10, says why not).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import ServingMeshLayout
from repro_torch.nn.spec import ParamSpec, flatten_paths, tree_from_flat

__all__ = ["make_serving_layout", "shard_serving_params", "shard_cache_tree",
           "data_sharding", "mesh_axis_sizes", "local_specs", "CACHE_RULES"]

# The rules the port's serving caches are placed by: the reference's, but
# a dense MLA latent cache is not split over its sequence (``kv_seq``): its
# latent dim (``kv_lora``) takes the model axis instead, as the paged
# latents' does. A ring written at any position would need a
# sequence-split scatter and gathers of the whole sequence; the latent
# split keeps the write local (ROADMAP.md, C, lists this placement).
CACHE_RULES = dict(shd.DEFAULT_RULES, kv_seq=())


def mesh_axis_sizes(mesh) -> tuple:
    """(data, model) extents of a serving mesh; absent axes count as 1."""
    sizes = shd.axis_sizes(mesh)
    return int(sizes.get("data", 1)), int(sizes.get("model", 1))


def make_serving_layout(mesh, *, n_slots: int, max_len: int,
                        block_size: int, n_blocks=None,
                        paged: bool = True) -> Optional[ServingMeshLayout]:
    """Plan how one engine's serving state spreads over ``mesh`` (None for
    ``mesh=None``: the single-rank engine). The slot count must divide
    ``data``: slots are the unit of data parallelism."""
    if mesh is None:
        return None
    data, model = mesh_axis_sizes(mesh)
    if n_slots % data != 0:
        raise ValueError(
            f"n_slots={n_slots} must divide the mesh's data axis ({data}): "
            f"decode slots shard over data")
    if not paged:
        return ServingMeshLayout(mesh=mesh, data=data, model=model,
                                 n_slots=n_slots)
    from repro_torch.serve.cache_pool import PagedCachePool
    n_blocks, shard_pages, bps = PagedCachePool.plan_blocks(
        n_slots, max_len, block_size, n_blocks=n_blocks, data_shards=data)
    return ServingMeshLayout(mesh=mesh, data=data, model=model,
                             n_slots=n_slots, block_size=block_size,
                             n_blocks=n_blocks, shard_pages=shard_pages,
                             blocks_per_shard=bps)


def _coords(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _local_shape(spec: ParamSpec, layout: ServingMeshLayout) -> tuple:
    sizes = shd.axis_sizes(layout.mesh)
    shape = list(spec.shape)
    for d, p in enumerate(shd.partition_spec(spec, layout.mesh,
                                             CACHE_RULES)):
        if spec.logical_axes[d] == "kv_blocks" and not layout.shard_pages:
            continue           # the allocator keeps one pool (plan_blocks)
        for a in (p if isinstance(p, tuple) else (p,)):
            if a is not None:
                shape[d] //= sizes[a]
    return tuple(shape)


def local_specs(specs: dict, layout: ServingMeshLayout) -> dict:
    """Flat cache specs with each rank's block shape under
    :data:`CACHE_RULES` (a sharded pool's ``kv_blocks`` dim is
    ``blocks_per_shard``, an unsharded pool's stays whole; slot-major
    leaves hold ``n_slots / data`` rows)."""
    return {k: ParamSpec(_local_shape(s, layout), s.logical_axes,
                         s.dtype, s.init, s.init_scale)
            for k, s in specs.items()}


def shard_serving_params(model, params: dict, mesh) -> dict:
    """This rank's block of every param leaf under the rules. A leaf that
    no mesh axis splits (everything on a 1x1 mesh) is the caller's own
    tensor, not a copy."""
    specs = model.param_specs()
    sizes, coords = shd.axis_sizes(mesh), _coords(mesh)
    flat = flatten_paths(params)
    missing = set(specs) ^ set(flat)
    if missing:
        raise ValueError(f"params do not match the model's specs: "
                         f"{sorted(missing)[:4]}")
    return tree_from_flat({
        p: shd.local_shard(v, shd.partition_spec(specs[p], mesh), sizes,
                           coords)
        for p, v in flat.items()})


def shard_cache_tree(model, caches: dict, flat_specs: dict, mesh) -> dict:
    """This rank's block of a whole materialized cache tree, leaf by leaf
    under its spec's logical axes and :data:`CACHE_RULES` (paged K/V and
    MLA latents: ``kv_blocks`` over data and ``kv_heads`` / ``head_dim`` /
    ``kv_lora`` over model; slot-major leaves: ``act_batch`` over
    data)."""
    from repro_torch.models.lm import cache_leaf
    sizes, coords = shd.axis_sizes(mesh), _coords(mesh)
    return model.assemble_cache_tree({
        k: shd.local_shard(cache_leaf(caches, k),
                           shd.partition_spec(s, mesh, CACHE_RULES), sizes,
                           coords)
        for k, s in flat_specs.items()})


def data_sharding(mesh, ndim: int) -> tuple:
    """Placements of per-slot host vectors (tokens, positions, block
    tables): the slot axis over ``data``, the rest replicated."""
    return shd.placements(("data",) + (None,) * (ndim - 1), mesh)
