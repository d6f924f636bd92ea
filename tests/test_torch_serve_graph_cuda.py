"""The paged decode step replayed as a CUDA graph
(``repro_torch.launch.steps.PagedDecodeStep``) against the same step run
eagerly, on the card: bit-equal logits and tokens for llama3_1b at full
width and DeepSeek-V3's smoke dense prefix (absorbed MLA decode), fused and
gather, plain and under an MP plan; two drains in a row over different
params, and a weight changed in place, each against its eager drain; the
launch counters against steps x layers; a failed capture raises; the
weight cache's operands against quantizing per call.

These tests need a CUDA device and skip without one. They import neither
``jax`` nor ``repro``, so they run on the card with::

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_serve_graph_cuda.py

Equality is exact on the rows that serve a request: the graph replays the
kernels the eager step launches, on the same inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.mpconfig import MPPlan  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import quant_cast as qc  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.serve import make_requests  # noqa: E402
from repro_torch.models.registry import (dense_prefix_overrides,  # noqa: E402
                                         get_model)
from repro_torch.nn.spec import default_generator  # noqa: E402
from repro_torch.quant import qops, weight_cache  # noqa: E402
from repro_torch.serve import ContinuousBatchingEngine  # noqa: E402

pytestmark = pytest.mark.gpu
DS = "deepseek_v3_671b"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA graph and the kernels "
                    "have no CPU mode")
    from repro_torch.device import resolve_device
    return resolve_device("cuda")


_MODELS: dict = {}


def _model(arch: str):
    if arch not in _MODELS:
        if arch == DS:
            m = get_model(DS, smoke=True, mla_absorb_decode=True,
                          **dense_prefix_overrides(DS, smoke=True))
        else:
            m = get_model(arch)
        _MODELS[arch] = m
    return _MODELS[arch]


def _params(model, seed=0):
    return model.init(default_generator(seed, "cuda"), "cuda")


def _plan(model) -> MPPlan:
    """fp8 on the linear ops of the second half of the layers and the last
    layer's BGEMMs (which then gathers)."""
    n = model.cfg.n_layers
    ops = ("attn/q_a_proj", "attn/q_b_proj", "attn/kv_a_proj",
           "attn/o_proj") if model.cfg.block_types[0] == "mla" else (
        "attn/q_proj", "attn/k_proj", "attn/v_proj", "attn/o_proj")
    mp = {f"layers/{i}/{op}": "fp8_e4m3" for i in range(n // 2, n)
          for op in ops + ("mlp/gate_proj", "mlp/up_proj", "mlp/down_proj")}
    mp[f"layers/{n - 1}/attn/qk_matmul"] = "fp8_e4m3"
    mp[f"layers/{n - 1}/attn/av_matmul"] = "fp8_e4m3"
    return MPPlan(assignment=mp, groups=[], objective="ET", tau=0.0,
                  budget=0.0, predicted_loss_mse=0.0, predicted_gain=0.0)


def _engine(model, mp, paged_attn, eager: bool):
    eng = ContinuousBatchingEngine(model, n_slots=4, max_len=48, mp=mp,
                                   block_size=16, paged_attn=paged_attn,
                                   device="cuda")
    step = (tsteps.make_paged_decode_step(model, mp=eng.mp,
                                          paged_attn=paged_attn)
            if eager else eng.decode_step)
    logits = []

    def recorded(params, caches, token, pos, block_tables):
        out = step(params, caches, token, pos, block_tables)
        # the live rows' logits (a graph's outputs are overwritten by the
        # next replay); a vacant row decodes garbage whose K/V writes all
        # land in the trash block, where the last of several writes to one
        # slot wins in no fixed order, eager or graphed
        logits.append(out[0][block_tables[:, 0] >= 0].clone())
        return out
    eng.decode_step = recorded
    return eng, logits


def _drain(eng, logits, params, reqs):
    del logits[:]
    out = eng.serve(params, reqs)
    torch.cuda.synchronize()
    toks = {rid: r.tokens for rid, r in out.results.items()}
    return out, toks, torch.cat(logits)


def _reqs(model, n=6):
    return make_requests(model.cfg.vocab_size, n, 24, 8, 2)


@pytest.mark.parametrize("paged_attn", ["fused", "gather"])
@pytest.mark.parametrize("mp", [False, True], ids=["plain", "mp"])
@pytest.mark.parametrize("arch", ["llama3_1b", DS])
def test_graphed_drain_equals_eager_drain(cuda, arch, mp, paged_attn):
    model = _model(arch)
    params = _params(model)
    plan = _plan(model) if mp else None
    reqs = _reqs(model)
    eager, e_log = _engine(model, plan, paged_attn, eager=True)
    _, e_toks, e_logits = _drain(eager, e_log, params, reqs)
    graphed, g_log = _engine(model, plan, paged_attn, eager=False)
    out, g_toks, g_logits = _drain(graphed, g_log, params, reqs)
    assert out.counters["graph_captures"] == 1
    assert out.counters["graph_replays"] == out.n_steps - 1
    assert g_toks.keys() == e_toks.keys()
    for rid in e_toks:
        np.testing.assert_array_equal(g_toks[rid], e_toks[rid])
    assert torch.equal(g_logits, e_logits)
    # the next drain over the same params and pool replays only
    again, g_toks2, g_logits2 = _drain(graphed, g_log, params, reqs)
    assert again.counters["graph_captures"] == 0
    assert again.counters["graph_replays"] == again.n_steps
    assert torch.equal(g_logits2, e_logits)


def test_drains_over_other_params_each_match_their_eager_drain(cuda):
    model = _model("llama3_1b")
    plan = _plan(model)
    reqs = _reqs(model, 4)
    graphed, g_log = _engine(model, plan, "fused", eager=False)
    for seed in (0, 1):
        params = _params(model, seed)
        eager, e_log = _engine(model, plan, "fused", eager=True)
        _, _, want = _drain(eager, e_log, params, reqs)
        out, _, got = _drain(graphed, g_log, params, reqs)
        assert out.counters["graph_captures"] == 1
        assert torch.equal(got, want)
        del params
    # a weight changed in place: quantized again, captured again
    params = _params(model, 2)
    _drain(graphed, g_log, params, reqs)
    w = params["layers"][str(model.cfg.n_layers - 1)]["mlp"]["up_proj"]["w"]
    w.mul_(1.5)
    out, _, got = _drain(graphed, g_log, params, reqs)
    assert out.counters["graph_captures"] == 1
    assert weight_cache.quantize_count(w, ("fake", "fp8_e4m3")) == 2
    eager, e_log = _engine(model, plan, "fused", eager=True)
    _, _, want = _drain(eager, e_log, params, reqs)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mp", [False, True], ids=["plain", "mp"])
def test_launch_counters_count_replays(cuda, mp):
    """Launches = decode steps x fused layers, all through ``gqa_mma``:
    the warm-up's launches and each replay's, never the capture's."""
    model = _model("llama3_1b")
    params = _params(model)
    plan = _plan(model) if mp else None
    reqs = _reqs(model)
    eng, log = _engine(model, plan, "fused", eager=False)
    for _ in range(2):                     # capture, then replays only
        n0 = tpa.launches
        routes0 = dict(tpa.launches_by_route)
        out, _, _ = _drain(eng, log, params, reqs)
        n_fused = model.cfg.n_layers - (1 if mp else 0)
        assert tpa.launches - n0 == out.n_steps * n_fused
        assert out.counters["kernel_launches"] == out.n_steps * n_fused
        assert tpa.launches_by_route["gqa_mma"] - routes0["gqa_mma"] == \
            out.n_steps * n_fused


def test_failed_capture_raises(cuda):
    model = _model("llama3_1b")
    inner = tsteps.make_paged_decode_step(model)

    def refuses_capture(*args):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("not capturable")
        return inner(*args)

    eng = ContinuousBatchingEngine(model, n_slots=2, max_len=48,
                                   device="cuda")
    eng.decode_step = tsteps.PagedDecodeStep(refuses_capture)
    with pytest.raises(RuntimeError, match="capture failed"):
        eng.serve(_params(model), _reqs(model, 2))


def test_fp8_linear_cached_weight_equals_per_call(cuda):
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(300, 2048, generator=g, device="cuda").bfloat16()
    w = (0.02 * torch.randn(8192, 2048, generator=g,
                            device="cuda")).bfloat16()
    n0 = dict(qc.launches)
    first, again = kops.fp8_linear(x, w), kops.fp8_linear(x, w)
    assert qc.launches["amax"] - n0["amax"] == 3        # x twice, w once
    xq, sx = qc.quantize_fp8(kops._pad_to(x, 128))
    wq, sw = qc.quantize_fp8(kops._pad_to(w, 128))
    from repro_torch.kernels import fp8_matmul as mm
    want = mm.fp8_matmul(xq, wq, sx, sw)[:300, :8192]
    assert torch.equal(first, want) and torch.equal(again, want)


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp8_e5m2", "fp4_e2m1"])
def test_cached_weight_operand_equals_per_call_on_the_card(cuda, fmt):
    """The weight cache's dequant (one-byte codes widened to bf16, times the
    host scale) against per-call fake quant of the same weight, bitwise."""
    g = torch.Generator(device="cuda").manual_seed(1)
    w = (0.02 * torch.randn(8192, 2048, generator=g,
                            device="cuda")).bfloat16()
    want = qops._quantize_operand(w, fmt, "simulate", None, None)
    assert torch.equal(qops._weight_operand(w, fmt, None), want)
    assert torch.equal(qops._weight_operand(w, fmt, None), want)
    assert weight_cache.quantize_count(w, ("fake", fmt)) == 1


@pytest.mark.parametrize("lengths", [(160, 152, 144, 136), (16, 40, 100, 9)])
def test_mla_kernel_replayed_in_a_graph_equals_eager(cuda, lengths):
    """The MLA kernel (route ``mla_mma``, latents resident in shared
    memory at the serving cell: B 4, 128 heads on one latent head, 512 +
    64) replayed back to back in a CUDA graph, a bf16 GEMM between calls
    to leave other data in shared memory, gives its eager output bit for
    bit every time: each copy it reads has landed (a copy it never
    committed to a group once did not, only under replay)."""
    rng = np.random.default_rng(3)
    B, H, R, DR, bs, n_pages = 4, 128, 512, 64, 16, 10
    n_blocks = 1 + B * n_pages
    tables = torch.from_numpy(rng.permutation(np.arange(1, n_blocks)).astype(
        np.int32).reshape(B, n_pages)).cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")

    def randn(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).cuda()
    ckv, kr = randn(n_blocks, bs, 1, R).bfloat16(), randn(
        n_blocks, bs, 1, DR).bfloat16()
    q1, q2 = randn(B, 1, H, R), randn(B, 1, H, DR)
    a, b = randn(2048, 2048).bfloat16(), randn(2048, 2048).bfloat16()

    def call():
        return tpa.paged_decode_attention(
            q1, ckv, None, tables, lens, q2=q2, k2=kr,
            scale=1.0 / np.sqrt(192.0), scale_mode="mul",
            out_dtype=torch.float32)
    assert tpa.route(torch.float32, torch.bfloat16, False, DR, R, R,
                     False, n_pages, bs) == "mla_mma"
    want = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
        a @ b
    torch.cuda.current_stream().wait_stream(side)
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for _ in range(8):
            outs.append(call())
            a @ b
    for _ in range(5):
        graph.replay()
        torch.cuda.synchronize()
        for o in outs:
            assert torch.equal(o, want)
