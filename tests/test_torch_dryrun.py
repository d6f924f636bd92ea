"""The port's dry run (``repro_torch.launch.dryrun``) and its roofline and
report (``repro_torch.analysis.{roofline,report}``) against the
reference's: the same HLO text and records give the same numbers, the same
cells get the same decisions, and a small cell traced over a fake process
group gives the collectives counted by hand below."""
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.analysis import report as jreport  # noqa: E402
from repro.analysis import roofline as jroof  # noqa: E402
from repro.hw.profiles import HWProfile as JHW  # noqa: E402
from repro_torch.analysis import report as treport  # noqa: E402
from repro_torch.analysis import roofline as troof  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeCell  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.hw.profiles import H100_SXM  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.registry import get_smoke_config  # noqa: E402
from repro_torch.train import optim  # noqa: E402

# the same card's numbers in the reference's profile type
REF_H100 = JHW(**{f: getattr(H100_SXM, f) for f in (
    "name", "peak_flops", "hbm_bw", "ici_bw", "ici_links", "hbm_bytes",
    "vmem_bytes")})

# tests/test_sharding.py's fragment, and a module whose all-reduce sits in a
# while loop's body (called through a nested computation)
FRAGMENT = """
  %ag = bf16[64,1024]{1,0} all-gather(%x), replica_groups={}
  %ar.1 = f32[128]{0} all-reduce(%y), to_apply=%sum
  %rs = (f32[32]{0}, f32[32]{0}) reduce-scatter(%a, %b), dimensions={0}
  %a2a = bf16[8,16]{1,0} all-to-all(%z), dimensions={0}
  %cp = u8[4]{0} collective-permute(%w), source_target_pairs={{0,1}}
  %notacoll = f32[999]{0} add(%p, %q)
"""
WHILE_MODULE = """HloModule m

%inner (p: f32[16]) -> f32[16] {
  %p = f32[16]{0} parameter(0)
  ROOT %ar = f32[16]{0} all-reduce(%p), to_apply=%sum
}

%body (t: (s32[], f32[16])) -> (s32[], f32[16]) {
  %t = (s32[], f32[16]{0}) parameter(0)
  %c = f32[16]{0} call(%g), to_apply=%inner
  ROOT %tup = (s32[], f32[16]{0}) tuple(%i, %c)
}

ENTRY %main (a: f32[16]) -> f32[16] {
  %a = f32[16]{0} parameter(0)
  %ag = bf16[4,32]{1,0} all-gather(%a), dimensions={0}
  %w = (s32[], f32[16]{0}) while(%init), condition=%cond, body=%body
  ROOT %r = f32[16]{0} get-tuple-element(%w), index=1
}
"""


@pytest.mark.parametrize("text", [FRAGMENT, WHILE_MODULE],
                         ids=["fragment", "while"])
def test_parse_collective_bytes_matches_reference(text):
    got, want = troof.parse_collective_bytes(text), \
        jroof.parse_collective_bytes(text)
    assert got == want
    if text is WHILE_MODULE:
        assert got["inloop"] == 16 * 4 and got["toplevel"] == 4 * 32 * 2


def test_analyze_matches_reference():
    kw = dict(arch="qwen2p5_3b", shape="decode_32k", mesh_name="pod16x16",
              chips=256, cost={"flops": 3.0e12, "bytes accessed": 7.5e10},
              hlo_text=FRAGMENT, model_flops=6.1e14,
              memory_stats={"peak_estimate_bytes": 12345})
    got = troof.analyze(hw=H100_SXM, **kw).to_dict()
    assert got == jroof.analyze(hw=REF_H100, **kw).to_dict()
    # the port's own collective counts stand in for the HLO, same keys
    coll = troof.parse_collective_bytes(FRAGMENT)
    kw2 = dict(kw, hlo_text="")
    assert troof.analyze(hw=H100_SXM, collectives=coll, **kw2).to_dict() \
        == got
    assert troof.analyze(**kw).to_dict() == got      # H100_SXM by default


ANALYTIC = {"flops": 4.2e15, "bytes": 3.3e13, "n_ops": 10,
            "n_params": 3_000_000_000, "fwd_flops": 1.4e15, "ops": []}


def _records() -> list:
    roof = {"chips": 256, "flops_per_device": 1.1e12,
            "collective_bytes_per_device": 2.5e9, "model_flops": 1.0e15}
    ok = {"arch": "qwen2p5_3b", "shape": "train_4k", "mesh": "pod16x16",
          "status": "ok", "reason": "", "n_microbatches": 4,
          "optimizer": "adamw", "compile_s": 12.5,
          "memory_analysis": {"peak_estimate_bytes": 9.9e9},
          "roofline": roof,
          "collective_split": {"toplevel": 5e8, "inloop": 2e9}}
    old = dict(ok, shape="prefill_32k", collective_split=None)
    old.pop("collective_split")
    big = dict(ok, shape="decode_32k", fsdp=True,
               kv_cache_dtype="fp8_e4m3",
               memory_analysis={"peak_estimate_bytes": 2.1e10})
    skip = {"arch": "qwen2p5_3b", "shape": "long_500k", "mesh": "pod16x16",
            "status": "skip", "reason": "full-attention arch: 524k-token "
                                        "decode is quadratic-KV"}
    err = {"arch": "qwen2p5_32b", "shape": "train_4k", "mesh": "pod16x16",
           "status": "error", "reason": "NotImplementedError: ... A9e"}
    other = dict(ok, mesh="pod2x16x16")
    return [ok, old, big, skip, err, other]


@pytest.fixture
def analytic_dirs(tmp_path, monkeypatch):
    """The reference's ANALYTIC_CACHE and the port's analytic_dir, both
    holding the same costs for every cell of the records."""
    ref, port = tmp_path / "ref", tmp_path / "port"
    for d in (ref, port):
        d.mkdir()
        for shape in SHAPES:
            (d / f"qwen2p5_3b__{shape}.json").write_text(json.dumps(ANALYTIC))
    monkeypatch.setattr(jreport, "ANALYTIC_CACHE", str(ref))
    return str(port)


def test_refine_and_tables_match_reference(analytic_dirs, monkeypatch):
    recs = _records()
    for r in recs:
        if r["status"] == "ok":
            assert treport.refine(r, H100_SXM, analytic_dirs) == \
                jreport.refine(r, REF_H100)
    real = jreport.refine
    monkeypatch.setattr(jreport, "refine",
                        lambda rec, hw=REF_H100: real(rec, hw))
    for mesh in ("pod16x16", "pod2x16x16"):
        assert treport.roofline_table(recs, mesh, H100_SXM, analytic_dirs) \
            .replace("tensor-core", "MXU") == jreport.roofline_table(recs,
                                                                     mesh)
    # the dry-run table's fit column holds the peak against the card's
    # 80 GB (the reference's: 16 GB), its time column is trace_s /
    # compile_s; every other cell is the reference's
    got = treport.dryrun_table(recs).splitlines()
    want = jreport.dryrun_table(recs).splitlines()
    assert got[0] == want[0].replace("fits v5e-16G", "fits h100_sxm-80G") \
        .replace("compile s", "trace s")
    assert got[1:] == [w.replace("| NO |", "| yes |") for w in want[1:]]
    assert "| 21.00 | NO |" in want[4] and "| 21.00 | yes |" in got[4]


def test_port_record_is_not_rescaled(analytic_dirs):
    """A port record's collective bytes are totals: ``refine`` takes them
    as they are; the same record without the mark is rescaled by the
    collective multiplier, as the reference's."""
    rec = _records()[0]
    port = dict(rec, collectives_are_totals=True)
    got = treport.refine(port, H100_SXM, analytic_dirs)
    assert got["coll_multiplier"] == 1.0
    assert got["t_collective"] == 2.5e9 / H100_SXM.ici_bw
    ref = treport.refine(rec, H100_SXM, analytic_dirs)
    assert ref["coll_multiplier"] > 1.0
    assert ref["t_collective"] == (5e8 + 2e9 * ref["coll_multiplier"]) \
        / H100_SXM.ici_bw


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module. Importing it appends a 512-device
    flag to ``XLA_FLAGS``; the variable is put back after this module, so
    no later JAX subprocess in the worker inherits it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
        import repro.launch.dryrun as rd
        yield rd


class _FakeMesh:
    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


class _Sh:
    def __init__(self, spec):
        self.spec = spec


def _reference_plan(rd, arch, shape, multi_pod, models):
    from repro.analysis import model_stats
    from repro.configs.shapes import cell_supported
    from repro.distributed import sharding as shd
    cell = SHAPES[shape]
    ok, reason = cell_supported(arch, shape)
    if not ok:
        return {"status": "skip", "reason": reason}
    mesh = _FakeMesh(dryrun.MESHES[multi_pod][1])
    key = (arch, cell.kind == "train")
    if key not in models:
        models[key] = rd._build(arch, cell.kind, dict(rd.DRYRUN_OVERRIDES))
    model = models[key]
    specs = model.param_specs()

    def est(sp, rules):
        return rd._estimate_shard_bytes(
            sp, {p: _Sh(shd.partition_spec(s, mesh, rules))
                 for p, s in sp.items()}, mesh)

    rules = shd.DEFAULT_RULES
    fsdp = False
    pb = est(specs, rules)
    if pb > rd.FSDP_THRESHOLD_BYTES:
        rules, fsdp = shd.FSDP_RULES, True
        pb = est(specs, rules)
    kv = None
    if cell.kind == "decode" and hasattr(model.cfg, "kv_cache_dtype"):
        if est(model.cache_specs(cell.global_batch, cell.seq_len), rules) \
                > rd.KV_FP8_THRESHOLD_BYTES:
            kv = "fp8_e4m3"
    out = {"status": "ok", "param_bytes": pb, "fsdp": fsdp,
           "kv_cache_dtype": kv}
    if cell.kind == "train":
        out["optimizer"] = rd.optim.select_optimizer(
            model_stats.param_stats(model)["total"]).name
        out["n_microbatches"] = rd.DRYRUN_MICRO.get(arch, 4)
    return out


def test_decisions_match_reference(ref_dryrun):
    """Every arch of ASSIGNED, every shape, both meshes: the per-rank param
    bytes, FSDP, the fp8 KV cache, the optimizer, the microbatches and the
    skips are the reference's, by its thresholds."""
    assert sorted(dryrun.ASSIGNED) == sorted(ref_dryrun.ASSIGNED)
    assert dryrun.DRYRUN_OVERRIDES == ref_dryrun.DRYRUN_OVERRIDES
    assert dryrun.DRYRUN_MICRO == ref_dryrun.DRYRUN_MICRO
    assert (dryrun.FSDP_THRESHOLD_BYTES, dryrun.KV_FP8_THRESHOLD_BYTES) == \
        (ref_dryrun.FSDP_THRESHOLD_BYTES, ref_dryrun.KV_FP8_THRESHOLD_BYTES)
    models: dict = {}
    fsdp = set()
    for arch in dryrun.ASSIGNED:
        for shape in SHAPES:
            for multi_pod in (False, True):
                want = _reference_plan(ref_dryrun, arch, shape, multi_pod,
                                       models)
                got = dryrun.plan_cell(arch, shape, multi_pod)
                where = (arch, shape, multi_pod)
                assert got["status"] == want["status"], where
                if want["status"] == "skip":
                    assert got["reason"] == want["reason"]
                    continue
                assert got["param_bytes"] == pytest.approx(
                    want["param_bytes"], rel=1e-12), where
                for k in ("fsdp", "kv_cache_dtype", "n_microbatches"):
                    assert got.get(k) == want.get(k), (where, k)
                if "optimizer" in want:
                    assert got["optimizer"].name == want["optimizer"], where
                if got["fsdp"]:
                    fsdp.add(arch)
    # the two the reference shards with FSDP_RULES among the dense ones
    assert {"qwen2p5_32b", "llava_next_34b"} <= fsdp


SMOKE_MESH = {"data": 2, "model": 2}


def _local_bytes(specs, rules=None, zero=False):
    fn = tshd.zero_partition_spec if zero else tshd.partition_spec
    mesh = dryrun.MeshShape(SMOKE_MESH)
    return sum(math.prod(tshd.local_shape(s.shape, fn(s, mesh, rules),
                                          SMOKE_MESH)) * s.dtype.itemsize
               for s in specs.values())


@pytest.fixture
def no_group_after():
    import torch.distributed as dist
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def test_run_cell_decode_on_a_smoke_config(no_group_after):
    """llama3_1b's smoke config, 4 rows decoding over 16 cached positions on
    a fake (data 2, model 2) mesh. Every rank holds 2 rows; the collectives,
    counted by hand: in each of the L layers the row-parallel o_proj and
    down_proj sum their f32 partial products (2 x 128 x 4 bytes each) over
    model; outside the layers the vocab-split embedding's lookup is summed
    (2 x 128 bf16), the head's block of the logits gathered (2 x 512 bf16)
    and the rows' logits (4 x 512 bf16) and greedy tokens (4 int32)
    gathered over data."""
    cfg = get_smoke_config("llama3_1b")
    B, S, d, V, L = 4, 16, cfg.d_model, cfg.vocab_size, cfg.n_layers
    assert (d, V, cfg.dtype) == (128, 512, "bfloat16")
    cell = ShapeCell("decode_32k", "decode", S, B)
    rec = dryrun.run_cell("llama3_1b", "decode_32k", False, smoke=True,
                          cell=cell, mesh_axes=SMOKE_MESH)
    assert rec["status"] == "ok" and rec["backend"] == "fake"
    for k in ("trace_s", "memory_analysis", "cost_analysis", "roofline",
              "collective_split", "collectives_are_totals",
              "param_bytes_per_rank"):
        assert k in rec, k
    plan = dryrun.plan_cell("llama3_1b", "decode_32k", False, smoke=True,
                            cell=cell, mesh_axes=SMOKE_MESH)
    model = plan["model"]
    from repro_torch.serve.parallel import CACHE_RULES
    args = (_local_bytes(model.param_specs())
            + _local_bytes(model.cache_specs(B, S), CACHE_RULES)
            + (B // 2) * 4 + 4)                 # this rank's tokens, pos
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == args
    assert mem["peak_estimate_bytes"] >= args
    coll = rec["roofline"]["meta"]["collectives"]
    b = B // 2
    inloop = L * 2 * (b * d * 4)
    assert coll["inloop"] == inloop
    assert coll["all-reduce"] == inloop + b * d * 2
    assert coll["all-gather"] == b * V * 2 + B * V * 2 + B * 4
    assert coll["counts"] == {"all-gather": 3, "all-reduce": 2 * L + 1,
                              "reduce-scatter": 0, "all-to-all": 0,
                              "collective-permute": 0}
    assert rec["roofline"]["t_collective"] == coll["total"] / H100_SXM.ici_bw
    assert rec["cost_analysis"]["flops"] > 0


def test_run_cell_decode_replicates_rows_data_does_not_divide(
        no_group_after):
    """One row over data 2 (long_500k's single row over 16 data shards):
    ``steps.mesh_step`` leaves it whole on every rank, as the reference
    replicates a batch the data axis does not divide, and gathers nothing
    over data. Counted by hand: the layers' row-parallel sums as above for
    one row, the embedding's sum (1 x 128 bf16) and the head's block of
    the logits gathered over model (1 x 512 bf16)."""
    cfg = get_smoke_config("llama3_1b")
    B, S, d, V, L = 1, 16, cfg.d_model, cfg.vocab_size, cfg.n_layers
    cell = ShapeCell("decode_32k", "decode", S, B)
    rec = dryrun.run_cell("llama3_1b", "decode_32k", False, smoke=True,
                          cell=cell, mesh_axes=SMOKE_MESH)
    assert rec["status"] == "ok"
    plan = dryrun.plan_cell("llama3_1b", "decode_32k", False, smoke=True,
                            cell=cell, mesh_axes=SMOKE_MESH)
    from repro_torch.serve.parallel import CACHE_RULES
    args = (_local_bytes(plan["model"].param_specs())
            + _local_bytes(plan["model"].cache_specs(B, S), CACHE_RULES)
            + B * 4 + 4)                        # the whole token row, pos
    assert rec["memory_analysis"]["argument_size_in_bytes"] == args
    coll = rec["roofline"]["meta"]["collectives"]
    inloop = L * 2 * (B * d * 4)
    assert coll["inloop"] == inloop
    assert coll["all-reduce"] == inloop + B * d * 2
    assert coll["all-gather"] == B * V * 2
    assert coll["counts"]["all-gather"] == 1
    assert coll["counts"]["all-reduce"] == 2 * L + 1


def test_run_cell_train_on_a_smoke_config(no_group_after):
    """The train step over the same mesh: 8 rows of 16 tokens in 4
    microbatches, one row a rank each. In the layer stack, per layer and
    microbatch (counted by hand): the forward's two row-parallel f32 sums
    (1 x 16 x 128 x 4 bytes), the remat recomputation's o_proj sum (the
    checkpoint's recomputation stops at the last tensor the backward needs,
    before down_proj's sum), and the bf16 gradient sums of the five
    column-parallel ops' input (q, k, v, gate, up: Megatron's "f")."""
    cfg = get_smoke_config("llama3_1b")
    L, d, M = cfg.n_layers, cfg.d_model, 4
    cell = ShapeCell("train_4k", "train", 16, 8)
    rec = dryrun.run_cell("llama3_1b", "train_4k", False, smoke=True,
                          cell=cell, mesh_axes=SMOKE_MESH)
    assert rec["optimizer"] == "adamw" and rec["n_microbatches"] == M
    coll = rec["roofline"]["meta"]["collectives"]
    row = 16 * d
    assert coll["inloop"] == M * L * (3 * row * 4 + 5 * row * 2)
    plan = dryrun.plan_cell("llama3_1b", "train_4k", False, smoke=True,
                            cell=cell, mesh_axes=SMOKE_MESH)
    specs = plan["model"].param_specs()
    args = (_local_bytes(specs)
            + _local_bytes(optim.state_specs(specs, plan["optimizer"]),
                           zero=True)
            + 2 * (8 // 2) * 16 * 4)       # this rank's tokens and labels
    assert rec["memory_analysis"]["argument_size_in_bytes"] == args
    # outside the stack: at least every gradient summed over data in f32
    mesh = dryrun.MeshShape(SMOKE_MESH)
    assert coll["toplevel"] >= 4 * sum(
        math.prod(tshd.local_shape(s.shape, tshd.partition_spec(s, mesh),
                                   SMOKE_MESH)) for s in specs.values())


def test_refusals_name_their_items(no_group_after):
    """Cells the port does not run over a mesh raise before any group
    starts, naming their ROADMAP items; the sweep records them as errors.
    Moonlight's cells take FSDP too and still fail on their MoE layers."""
    for arch, shape, item in [("moonshot_v1_16b_a3b", "decode_32k", "C10"),
                              ("whisper_base", "train_4k", "C10"),
                              ("deepseek_v3_671b", "train_4k", "C10")]:
        with pytest.raises(NotImplementedError, match=item):
            dryrun.run_cell(arch, shape, False)


def _fsdp_smoke_train(monkeypatch):
    """The smoke train cell above with FSDP decided by the reference's
    rule (the threshold at 0 bytes): (record, plan, specs)."""
    monkeypatch.setattr(dryrun, "FSDP_THRESHOLD_BYTES", 0.0)
    cell = ShapeCell("train_4k", "train", 16, 8)
    kw = dict(smoke=True, cell=cell, mesh_axes=SMOKE_MESH)
    rec = dryrun.run_cell("llama3_1b", "train_4k", False, **kw)
    plan = dryrun.plan_cell("llama3_1b", "train_4k", False, **kw)
    return rec, plan, plan["model"].param_specs()


def test_run_cell_fsdp_on_a_smoke_config(no_group_after, monkeypatch):
    """A smoke train cell whose plan takes FSDP runs, and its record says
    so; every rank's arguments are the FSDP shapes' bytes: params and AdamW
    moments each split over data as well (ZeRO-3), counted by hand."""
    rec, plan, specs = _fsdp_smoke_train(monkeypatch)
    assert plan["fsdp"] and plan["rules"] is tshd.FSDP_RULES
    assert rec["status"] == "ok" and rec["fsdp"] is True
    args = (_local_bytes(specs, tshd.FSDP_RULES)
            + _local_bytes(optim.state_specs(specs, plan["optimizer"]),
                           tshd.FSDP_RULES, zero=True)
            + 2 * (8 // 2) * 16 * 4)       # this rank's tokens and labels
    assert rec["memory_analysis"]["argument_size_in_bytes"] == args
    assert args < _local_bytes(specs) + _local_bytes(
        optim.state_specs(specs, plan["optimizer"]), zero=True) \
        + 2 * (8 // 2) * 16 * 4


def test_run_cell_fsdp_collectives_by_hand(no_group_after, monkeypatch):
    """The FSDP train cell's gathers and reduce-scatters, counted by hand.
    Each microbatch gathers every layer's split leaves in its forward and
    again in the remat recomputation (the model block, in the leaf's
    dtype), and the embedding table (shared by the tied head) and the
    final norm once outside the layers; each gather's backward
    reduce-scatters the whole gradient once, in f32, into this rank's
    block. Outside the layers the head's logits are still gathered over
    model (1 x 16 x 512 bf16). The layers' other collectives are the
    default rules' (``test_run_cell_train_on_a_smoke_config``)."""
    rec, plan, specs = _fsdp_smoke_train(monkeypatch)
    L, d, M = plan["model"].cfg.n_layers, plan["model"].cfg.d_model, 4
    mesh = dryrun.MeshShape(SMOKE_MESH)
    gathered = {}         # path -> (gathered bytes, reduce-scattered bytes)
    for path, s in specs.items():
        block = tshd.local_shape(s.shape, tshd.partition_spec(s, mesh),
                                 SMOKE_MESH)
        n = math.prod(block) // (L if path.startswith("segments/") else 1)
        gathered[path] = (n * s.dtype.itemsize, n // 2 * 4)
    layer = [v for k, v in gathered.items() if k.startswith("segments/")]
    top = [gathered["embed/w"], gathered["final_norm/scale"]]
    assert len(layer) == 9 and len(gathered) == 11
    coll = rec["roofline"]["meta"]["collectives"]
    assert coll["counts"]["all-gather"] == M * (2 * L * 9 + 2 + 1)
    assert coll["counts"]["reduce-scatter"] == M * (L * 9 + 2)
    g_layer = sum(g for g, _ in layer)
    r_layer = sum(r for _, r in layer)
    assert coll["reduce-scatter"] == M * (L * r_layer
                                          + sum(r for _, r in top))
    logits = 16 * 512 * 2
    assert coll["all-gather"] == M * (2 * L * g_layer
                                      + sum(g for g, _ in top) + logits)
    row = 16 * d
    assert coll["inloop"] == M * L * (3 * row * 4 + 5 * row * 2
                                      + 2 * g_layer + r_layer)


def test_no_a9e_refusal_is_left():
    """FSDP execution (ROADMAP A9e) is written: no module of the port
    refuses it any more."""
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src", "repro_torch")
    hits = []
    for base, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(base, f)) as fh:
                    if "A9e" in fh.read():
                        hits.append(f)
    assert not hits, hits


def test_fake_group_refuses_a_live_group():
    import torch.distributed as dist
    with dryrun.fake_group(False, mesh_axes=SMOKE_MESH) as (prod, mesh):
        assert dist.get_world_size() == 4 and mesh.size() == 4
        with pytest.raises(RuntimeError, match="already up"):
            with dryrun.fake_group(False, mesh_axes=SMOKE_MESH):
                pass
    assert not dist.is_initialized()


def test_live_bytes_tracks_storage_until_freed():
    live = dryrun.LiveBytes()
    with live:
        a = torch.empty(256, 256, device="meta")
        b = a @ a
        assert live.live == 2 * 256 * 256 * 4
        del b
        assert live.live == 256 * 256 * 4
    assert live.peak == 2 * 256 * 256 * 4
    assert live.matmul_bytes == 3 * 256 * 256 * 4
    np.testing.assert_equal(a.shape, (256, 256))


def test_launchers_never_reach_a_fake_group():
    """Neither launcher imports the dry run or the fake backend: a fake
    group is started only by ``launch.dryrun.fake_group``."""
    import subprocess
    import sys
    code = ("import sys\n"
            "import repro_torch.launch.serve, repro_torch.launch.train\n"
            "bad = [m for m in ('repro_torch.launch.dryrun',\n"
            "       'torch.testing._internal.distributed.fake_pg')\n"
            "       if m in sys.modules]\n"
            "assert not bad, bad\n")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=src))
    assert r.returncode == 0, r.stderr[-2000:]
    text = open(dryrun.__file__).read()
    assert text.count('init_process_group("fake"') == 1
