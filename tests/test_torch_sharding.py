"""The port's sharding rules, serving mesh helpers and shard-aware paged pool
held against the reference's, on the host alone (no process group):

* ``partition_spec``, ``zero_partition_spec`` and ``FSDP_RULES`` give the
  reference's assignment for every ``ParamSpec`` of every smoke config's
  model and for every cache spec (dense and paged; GQA, MLA and SSM), on
  fake meshes (1,1), (2,1), (1,2), (2,2), (16,16) and (2,16,16) with
  ``pod``; ``placements`` says the same as DTensor placements;
* ``PagedCachePool.plan_blocks`` and ``size_n_blocks`` with ``data_shards``
  over a grid;
* the shard-aware admission test of the reference, and a seeded random
  stream of pool operations at two data shards against the reference pool,
  the books and the per-shard invariants equal after every operation;
* ``parse_mesh_spec`` / ``mesh_from_spec`` / ``make_production_mesh``, and
  the launcher's ``--mesh`` refused without ``--continuous``.
The mesh serving itself (ranks, collectives) is in
``test_torch_serve_mesh.py``."""
import itertools
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models.registry import ARCH_IDS  # noqa: E402
from repro.models.registry import get_model as jget  # noqa: E402
from repro.serve.cache_pool import PagedCachePool as JPool  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serve import PagedCachePool  # noqa: E402
from repro_torch.serve.parallel import local_specs  # noqa: E402


class FakeMesh:
    """The reference tests' fake mesh: axis names and sizes, no devices."""

    def __init__(self, **sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


MESHES = [FakeMesh(data=1, model=1), FakeMesh(data=2, model=1),
          FakeMesh(data=1, model=2), FakeMesh(data=2, model=2),
          FakeMesh(data=16, model=16),
          FakeMesh(pod=2, data=16, model=16)]


def _specs(model, jax_side: bool) -> dict:
    """Every param and cache spec of a model, by a name that says which."""
    out = {f"param:{k}": v for k, v in model.param_specs().items()}
    if getattr(model, "cache_needs_enc_len", False):
        out.update({f"cache:{k}": v for k, v in
                    model.cache_specs(4, 64, 48).items()})
    else:
        out.update({f"cache:{k}": v for k, v in
                    model.cache_specs(4, 64).items()})
        out.update({f"paged:{k}": v for k, v in
                    model.paged_cache_specs(4, 34, 16).items()})
    return out


def _ref(pspec) -> tuple:
    return tuple(pspec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_match_reference(arch):
    port, ref = _specs(get_model(arch, smoke=True), False), \
        _specs(jget(arch, smoke=True), True)
    assert port.keys() == ref.keys()
    for k in port:
        assert tuple(port[k].shape) == tuple(ref[k].shape), k
        assert tuple(port[k].logical_axes) == tuple(ref[k].logical_axes), k
    assert any(k.startswith("cache:") for k in port)
    for mesh in MESHES:
        for k, spec in port.items():
            r = ref[k]
            got = (shd.partition_spec(spec, mesh),
                   shd.partition_spec(spec, mesh, shd.FSDP_RULES),
                   shd.zero_partition_spec(spec, mesh))
            want = (_ref(jshd.partition_spec(r, mesh)),
                    _ref(jshd.partition_spec(r, mesh, jshd.FSDP_RULES)),
                    _ref(jshd.zero_partition_spec(r, mesh)))
            assert got == want, (arch, mesh.shape, k, got, want)
    # the same assignment as DTensor placements: one per mesh axis, Shard
    # on the dim each axis splits
    from torch.distributed.tensor import Replicate, Shard
    mesh = MESHES[3]
    for k, spec in port.items():
        ps = shd.partition_spec(spec, mesh)
        pl = shd.placements(ps, mesh)
        assert len(pl) == 2
        for axis, p in zip(("data", "model"), pl):
            dims = [d for d, a in enumerate(ps)
                    if axis in (a if isinstance(a, tuple) else (a,))]
            assert p == (Shard(dims[0]) if dims else Replicate()), (k, pl)


def test_rule_helpers_match_reference():
    for mesh in MESHES:
        assert shd.batch_pspec(mesh, 2) == _ref(jshd.batch_pspec(mesh, 2))
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES
    assert shd.FSDP_RULES == jshd.FSDP_RULES
    x = torch.ones(3)
    assert shd.shard_hint(x, "data") is x
    assert shd.current_serving_layout() is None
    lay = shd.ServingMeshLayout(mesh=MESHES[3], data=2, model=2, n_slots=4)
    with shd.serving_layout_scope(lay):
        assert shd.current_serving_layout() is lay
        assert lay.fused_ok(4, 2) and not lay.fused_ok(4, 1) \
            and not lay.fused_ok(3, 2)
    assert shd.current_serving_layout() is None
    # without a current layout the collectives are identities
    assert shd.tp_sum(x) is x and shd.tp_max(x) is x and shd.dp_gather(x) is x
    assert shd.tp_gather(x, 3) is x and shd.tp_slice(x, 3) is x


def test_local_shards_tile_the_leaf():
    """``local_shard`` over every coordinate of a mesh tiles the leaf: the
    blocks, put back where each coordinate says, give the whole tensor."""
    t = torch.arange(4 * 8 * 8, dtype=torch.float32).reshape(4, 8, 8)
    sizes = {"pod": 2, "data": 2, "model": 2}
    for ps in [("data", None, "model"), (None, ("pod", "data"), None),
               (("pod", "data"), "model"), ("model",), ()]:
        out = torch.full_like(t, -1.0)
        for coords in itertools.product(range(2), repeat=3):
            c = dict(zip(("pod", "data", "model"), coords))
            blk = shd.local_shard(t, ps, sizes, c)
            idx = []
            for d in range(t.dim()):
                p = ps[d] if d < len(ps) else None
                axes = tuple(a for a in (p if isinstance(p, tuple)
                                         else (p,)) if a)
                n, i = 1, 0
                for a in axes:
                    n, i = n * sizes[a], i * sizes[a] + c[a]
                size = t.shape[d] // n
                idx.append(slice(i * size, (i + 1) * size))
            out[tuple(idx)] = blk
        assert torch.equal(out, t), ps
    assert shd.local_shard(t, (None, None), sizes, dict.fromkeys(sizes, 0)) \
        is t


def test_local_cache_specs():
    """A rank's cache blocks: pages over data only when the layout shards
    them, KV heads (or head_dim) and MLA latents over model, a dense MLA
    cache over its latent dim, not its sequence (ROADMAP C)."""
    llama = get_model("llama3_1b", smoke=True)        # 2 KV heads of 32
    lay = shd.ServingMeshLayout(mesh=MESHES[3], data=2, model=2, n_slots=4,
                                block_size=16, n_blocks=34, shard_pages=True,
                                blocks_per_shard=17)
    paged = local_specs(llama.paged_cache_specs(4, 34, 16), lay)
    assert tuple(paged["layers/0@attn/k"].shape) == (17, 16, 1, 32)
    whole = shd.ServingMeshLayout(mesh=MESHES[3], data=2, model=2,
                                  n_slots=4, block_size=16, n_blocks=34)
    paged = local_specs(llama.paged_cache_specs(4, 34, 16), whole)
    assert tuple(paged["layers/0@attn/k"].shape) == (34, 16, 1, 32)
    ds = get_model("deepseek_v3_671b", smoke=True, moe_layers=(),
                   mtp_depth=0)
    dense = local_specs(ds.cache_specs(4, 64), lay)
    r = ds.cfg.mla_cfg.kv_lora_rank
    assert tuple(dense["layers/0@attn/ckv"].shape) == (2, 64, r // 2)
    assert tuple(dense["layers/0@attn/pos"].shape) == (2, 64)
    hy = get_model("hymba_1p5b", smoke=True)          # 1 KV head of 16
    dense = local_specs(hy.cache_specs(4, 64), lay)
    assert tuple(dense["layers/0@attn/k"].shape)[2:] == (1, 8)
    assert dense["layers/0@mamba/state"].shape[:2] == (2, hy.cfg.ssm.n_heads
                                                       // 2)


@pytest.mark.parametrize("data", [1, 2, 4])
def test_plan_blocks_and_sizing_match_reference(data):
    for n_slots, max_len, bs, n_blocks in itertools.product(
            (1, 2, 3, 4, 8), (16, 33), (4, 16), (None, 2, 7, 16, 33, 64)):
        try:
            want = JPool.plan_blocks(n_slots, max_len, bs, n_blocks=n_blocks,
                                     data_shards=data)
        except AssertionError:
            with pytest.raises(ValueError):
                PagedCachePool.plan_blocks(n_slots, max_len, bs,
                                           n_blocks=n_blocks,
                                           data_shards=data)
            continue
        got = PagedCachePool.plan_blocks(n_slots, max_len, bs,
                                         n_blocks=n_blocks, data_shards=data)
        assert got == tuple(want), (n_slots, max_len, bs, n_blocks, data)
    rng = np.random.default_rng(data)
    for _ in range(12):
        prof = [(int(rng.integers(1, 40)), int(rng.integers(0, 12)))
                for _ in range(int(rng.integers(1, 9)))]
        n_slots = int(rng.integers(1, 5)) * data
        bs = int(rng.choice([4, 8, 16]))
        assert PagedCachePool.size_n_blocks(prof, n_slots, bs,
                                            data_shards=data) == \
            JPool.size_n_blocks(prof, n_slots, bs, data_shards=data)


def _shard_invariants(pool) -> None:
    """Per shard: its slots' table entries are its own blocks and their
    multiset is the refcounts of its blocks; nothing free, cached or
    quarantined is mapped; no trash block anywhere."""
    assert pool.check_consistency()["ok"], pool.check_consistency()
    for d in range(pool.n_shards):
        rows = pool.block_tables[d * pool.slots_per_shard:
                                 (d + 1) * pool.slots_per_shard]
        mapped = Counter(int(b) for row in rows for b in row if b >= 0)
        mine = {b: n for b, n in pool._ref.items()
                if pool._shard_of_block(b) == d}
        assert mapped == Counter(mine), (d, mapped, mine)


def test_shard_aware_admission_and_affinity():
    """The reference's test on the port's pool: two data shards (host
    accounting alone), per-shard gating, cross-shard prefixes missing,
    admission on the shard with the longest chain; the invariants after
    every operation."""
    model = get_model("llama3_1b", smoke=True)
    pool = PagedCachePool(model, n_slots=2, max_len=32, block_size=8,
                          data_shards=2, device="cpu")
    assert pool.n_shards == 2 and pool.allocatable_blocks == 4
    p20 = np.random.default_rng(4).integers(0, 500, 20).astype(np.int32)
    dig = pool.prefix_digests(p20)
    s0 = pool.alloc_slot(20, 9, digests=dig)
    _shard_invariants(pool)
    assert pool._shard_of(s0) == 0          # empty pool: lowest shard wins
    pool.ensure_range(s0, 0, 20)
    pool.register_prefix(s0, 20)            # indexes blocks 0-1 on shard 0
    _shard_invariants(pool)
    s1 = pool.alloc_slot(20, 9, digests=dig)
    assert pool._shard_of(s1) == 1
    assert pool.matched_tokens(s1) == 0     # a cross-shard hit is a miss
    _shard_invariants(pool)
    pool.free_slot(s1)
    pool.free_slot(s0)
    _shard_invariants(pool)
    assert pool.n_cached_blocks == 2
    s2 = pool.alloc_slot(20, 9, digests=dig)
    assert pool._shard_of(s2) == 0          # prefix affinity beats -d tie
    assert pool.matched_tokens(s2) == 16
    _shard_invariants(pool)
    # shard 0 is loaded; a full-shard request still fits on shard 1
    assert pool.can_admit(32, 1)
    s3 = pool.alloc_slot(32, 1)
    assert pool._shard_of(s3) == 1
    _shard_invariants(pool)
    assert not pool.can_admit(8, 1)         # no free slot on either shard
    pool.free_slot(s3)
    pool.free_slot(s2)
    _shard_invariants(pool)
    assert pool.blocks_in_use == 0 and pool._reserved == 0


def _books(pool) -> dict:
    """Everything the sharded allocator decides, comparable across the
    packages."""
    return {"tables": pool.block_tables.tolist(), "ref": dict(pool._ref),
            "free": [list(f) for f in pool._free_blocks_by_shard],
            "cached": [list(c) for c in pool._cached_by_shard],
            "index": [dict(i) for i in pool._index_by_shard],
            "reserved": list(pool._reserved_by_shard),
            "slot_reserve": dict(pool._slot_reserve),
            "matched": dict(pool._slot_matched),
            "counters": (pool.prefix_hit_requests, pool.prefix_hit_blocks,
                         pool.prefix_hit_tokens, pool.cow_forks,
                         pool.reclaimed_cached_blocks),
            "free_slots": [list(s) for s in pool._free_slots_by_shard],
            "in_use": pool.blocks_in_use,
            "allocatable": pool.allocatable_blocks}


@pytest.mark.parametrize("seed", range(3))
def test_sharded_pool_matches_reference_step_by_step(seed):
    """Two data shards: admissions with digests from shared-prefix families
    (affinity, cross-shard misses), prefill chunks with registrations,
    decode writes, frees and a rare index invalidation, under block
    pressure; the books equal the reference pool's after every operation,
    and the per-shard invariants hold."""
    kw = dict(n_slots=4, max_len=32, block_size=4, n_blocks=22,
              data_shards=2)
    pool = PagedCachePool(get_model("llama3_1b", smoke=True), device="cpu",
                          **kw)
    ref = JPool(jget("llama3_1b", smoke=True), **kw)
    assert pool.n_shards == ref.n_shards == 2
    rng = np.random.default_rng(seed)
    fams = [rng.integers(0, 50, size=16).astype(np.int32) for _ in range(3)]
    live = {}
    ops = Counter()
    for _ in range(100):
        r = rng.random()
        if r < 0.3 and pool.n_free_slots:
            fam = fams[int(rng.integers(3))]
            plen = int(rng.integers(1, 17))
            cut = int(rng.integers(0, plen + 1))
            toks = np.concatenate([fam[:cut], rng.integers(
                0, 50, size=plen - cut).astype(np.int32)])
            mnew = int(rng.integers(1, 6))
            dig = pool.prefix_digests(toks)
            ok = pool.can_admit(plen, mnew, digests=dig)
            assert ok == ref.can_admit(plen, mnew, digests=dig)
            if ok:
                s = pool.alloc_slot(plen, mnew, digests=dig)
                assert s == ref.alloc_slot(plen, mnew, digests=dig)
                live[s] = [toks, pool.matched_tokens(s), plen,
                           plen + mnew - 1]
                ops["admit"] += 1
        elif r < 0.6 and any(v[1] < len(v[0]) for v in live.values()):
            pend = [s for s, v in sorted(live.items()) if v[1] < len(v[0])]
            s = pend[int(rng.integers(len(pend)))]
            toks, start = live[s][0], live[s][1]
            end = min(len(toks), start + int(rng.integers(1, 7)))
            for p in (pool, ref):
                p.ensure_range(s, start, end)
                p.register_prefix(s, end)
            live[s][1] = end
            ops["chunk"] += 1
        elif r < 0.8 and any(v[1] == len(v[0]) and v[2] < v[3]
                             for v in live.values()):
            s = [s for s, v in sorted(live.items())
                 if v[1] == len(v[0]) and v[2] < v[3]][0]
            pool.ensure_block(s, live[s][2])
            ref.ensure_block(s, live[s][2])
            live[s][2] += 1
            ops["decode"] += 1
        elif r < 0.98 and live:
            s = sorted(live)[int(rng.integers(len(live)))]
            pool.free_slot(s)
            ref.free_slot(s)
            del live[s]
            ops["free"] += 1
        elif r >= 0.98:
            pool.invalidate_prefix_index()
            ref.invalidate_prefix_index()
        assert _books(pool) == _books(ref)
        _shard_invariants(pool)
    assert ops["admit"] >= 8 and ops["chunk"] >= 8 and ops["free"] >= 4
    assert {pool._shard_of(s) for s in range(4)} == {0, 1}


def test_one_shard_keeps_the_single_device_books():
    """One shard: the trash block is 0, the free list pops block 1 first,
    the old single-shard names see the books."""
    pool = PagedCachePool(get_model("llama3_1b", smoke=True), n_slots=2,
                          max_len=16, block_size=4, device="cpu")
    assert pool.n_shards == 1 and pool.blocks_per_shard == pool.n_blocks
    assert pool._free_blocks == list(range(pool.n_blocks - 1, 0, -1))
    s = pool.alloc_slot(5, 2)
    pool.ensure_range(s, 0, 5)
    assert pool.block_tables[s, :2].tolist() == [1, 2]
    assert pool._free_blocks is pool._free_blocks_by_shard[0]


@pytest.mark.parametrize("spec", ["data=2,model=4", "model=8", "", "data=1",
                                  " data=3 , model=1 ", "data=2,data=4"])
def test_parse_mesh_spec_matches_reference(spec):
    assert tmesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)


def test_mesh_spec_refusals():
    for bad in ("pod=2", "data=x", "data", " data = 3"):
        with pytest.raises(ValueError):
            tmesh.parse_mesh_spec(bad)
        with pytest.raises(ValueError):
            jmesh.parse_mesh_spec(bad)
    with pytest.raises(ValueError):
        tmesh.parse_mesh_spec("model=0")
    # 1x1 and empty specs are the single-rank engine, as in the reference;
    # neither touches a process group
    for spec in (None, "", "data=1,model=1", {"data": 1, "model": 1}):
        assert tmesh.mesh_from_spec(spec) is None
        assert jmesh.mesh_from_spec(spec) is None
    with pytest.raises(RuntimeError, match="256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_launcher_refuses_mesh_without_continuous():
    from repro_torch.launch import serve as launcher
    with pytest.raises(SystemExit, match="--continuous"):
        launcher.main(["--smoke", "--device", "cpu", "--mesh",
                       "data=2,model=1"])


class FakeDeviceMesh:
    """What the placement helpers read of a ``DeviceMesh``: axis names, a
    shape tuple and this rank's coordinate."""

    def __init__(self, shape, coord):
        self.mesh_dim_names = ("data", "model")
        self.shape = tuple(shape)
        self._coord = list(coord)

    def get_coordinate(self):
        return self._coord


def test_param_and_cache_shards_tile_the_leaves():
    """``shard_serving_params`` and ``shard_cache_tree`` over the four
    coordinates of a (2, 2) mesh: each block has the rules' local shape, a
    leaf no axis splits is the caller's own tensor, and the blocks put back
    give the leaf (hymba: heads split mid-head, SSM state, conv history)."""
    from repro_torch.nn.spec import default_generator, flatten_paths
    from repro_torch.serve.parallel import (data_sharding,
                                            shard_cache_tree,
                                            shard_serving_params)
    from torch.distributed.tensor import Replicate, Shard
    model = get_model("hymba_1p5b", smoke=True)
    params = model.init(default_generator(0, "cpu"), "cpu")
    flat = flatten_paths(params)
    specs = model.param_specs()
    caches = model.init_cache(4, 16, "cpu")
    for t in flatten_paths(caches).values():
        t.copy_(torch.arange(t.numel()).reshape(t.shape).to(t.dtype))
    blocks = {}
    for coord in itertools.product(range(2), repeat=2):
        mesh = FakeDeviceMesh((2, 2), coord)
        local = flatten_paths(shard_serving_params(model, params, mesh))
        for p, t in local.items():
            ps = shd.partition_spec(specs[p], mesh)
            if not ps or all(a is None for a in ps):
                assert t is flat[p], p
            blocks.setdefault(p, []).append((coord, ps, t))
        ct = shard_cache_tree(model, caches, model.cache_specs(4, 16), mesh)
        assert set(flatten_paths(ct)) == set(flatten_paths(caches))
    for p, got in blocks.items():
        whole = torch.zeros_like(flat[p])
        for (dd, mm), ps, t in got:
            idx = [slice(None)] * whole.dim()
            for d, a in enumerate(ps):
                if a is not None:
                    i = {"data": dd, "model": mm}[a]
                    n = t.shape[d]
                    idx[d] = slice(i * n, (i + 1) * n)
            whole[tuple(idx)] = t
        assert torch.equal(whole, flat[p]), p
    mesh = FakeDeviceMesh((2, 2), (0, 0))
    assert data_sharding(mesh, 2) == (Shard(0), Replicate())
