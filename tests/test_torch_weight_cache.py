"""Each constant weight quantized once per format
(``repro_torch.quant.weight_cache``): the cached path against the per-call
path it replaced, bit for bit, on the smoke llama under a serving plan and
under ``impl="kernel"``'s plain versions; one quantization per (weight,
format) across a continuous drain and across the measured tier's combos; a
weight changed in place, or new params, quantized again; activations and
BGEMM operands never cached.

Every comparison is exact (``torch.equal``): a constant weight's per-tensor
max |w| does not depend on the reduction order, and the quantization is
deterministic, so quantizing once gives the bits quantizing per call
gives."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

import repro_torch.core.pipeline as tpl  # noqa: E402
from repro_torch.core.mpconfig import MPPlan  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import quant_cast as qc  # noqa: E402
from repro_torch.launch.serve import make_requests  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.nn.spec import default_generator, flatten_paths  # noqa: E402
from repro_torch.quant import qops, weight_cache  # noqa: E402
from repro_torch.quant.qops import QuantContext  # noqa: E402
from repro_torch.serve import ContinuousBatchingEngine  # noqa: E402

LINEAR_OPS = ("attn/q_proj", "attn/k_proj", "attn/v_proj", "attn/o_proj",
              "mlp/gate_proj", "mlp/up_proj", "mlp/down_proj")


@pytest.fixture(scope="module")
def model():
    return get_model("llama3_1b", smoke=True)


@pytest.fixture
def params(model):
    """Fresh params per test, so each test sees its own cache entries."""
    return model.init(default_generator(0, "cpu"), "cpu")


def _plan(model, fmt="fp8_e4m3") -> dict:
    """Every linear op of every layer and the head in ``fmt``, plus one
    layer's BGEMMs (which are never cached)."""
    mp = {f"layers/{i}/{op}": fmt for i in range(model.cfg.n_layers)
          for op in LINEAR_OPS}
    mp["lm_head"] = fmt
    mp["layers/1/attn/qk_matmul"] = fmt
    return mp


def _tokens(model, shape=(2, 12), seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, model.cfg.vocab_size, shape).astype(np.int32))


def _per_call(monkeypatch):
    """The path before the cache: every weight quantized on every call —
    fake quant through ``_quantize_operand`` (per-tensor, as it was called
    for a linear op's weight), ``fp8_linear`` quantizing ``w`` anew."""
    monkeypatch.setattr(weight_cache, "cached",
                        lambda w, key, build, scale=None: build())
    monkeypatch.setattr(qops, "_weight_operand",
                        lambda w, fmt, scale: qops._quantize_operand(
                            w, fmt, "simulate", scale, None))


def _weight(params, op: str) -> torch.Tensor:
    flat = flatten_paths(params)
    return flat["embed/w" if op == "lm_head" else f"{op}/w"]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("impl", ["simulate", "native"])
@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp8_e5m2", "fp4_e2m1",
                                 "fp16"])
def test_serving_plan_cached_equals_per_call(monkeypatch, fmt, impl, dtype):
    """Fake quant with per-token activation scales (the serving context):
    the cached weight operand gives the per-call logits bit for bit, on the
    miss and on the hit, in the working type and in float32."""
    model = get_model("llama3_1b", smoke=True, dtype=dtype)
    params = model.init(default_generator(0, "cpu"), "cpu")
    ctx = QuantContext(mode="mp", mp=_plan(model, fmt), impl=impl,
                       act_scale_token=True)
    toks = _tokens(model)
    miss = model.apply(params, toks, ctx)
    hit = model.apply(params, toks, ctx)
    with monkeypatch.context() as m:
        _per_call(m)
        want = model.apply(params, toks, ctx)
    assert torch.equal(miss, want) and torch.equal(hit, want)


def test_kernel_route_cached_equals_per_call(model, params, monkeypatch):
    """``impl="kernel"`` (per-tensor activation scales, so every linear op
    takes ``fp8_linear``, here through the kernels' plain versions)."""
    ctx = QuantContext(mode="mp", mp=_plan(model), impl="kernel")
    toks = _tokens(model)
    miss = model.apply(params, toks, ctx)
    hit = model.apply(params, toks, ctx)
    with monkeypatch.context() as m:
        _per_call(m)
        want = model.apply(params, toks, ctx)
    assert torch.equal(miss, want) and torch.equal(hit, want)
    # fp8_linear on its own: the kept (wq, sw_inv) is the padded weight's
    x = torch.randn(5, 200, generator=torch.Generator().manual_seed(1))
    w = torch.randn(70, 200, generator=torch.Generator().manual_seed(2))
    x, w = x.to(torch.bfloat16), (0.02 * w).to(torch.bfloat16)
    first, again = kops.fp8_linear(x, w), kops.fp8_linear(x, w)
    wq, sw = weight_cache.cached(w, ("kernel", "fp8_e4m3"), None)
    assert wq.shape == (128, 256) and wq.dtype == torch.float8_e4m3fn
    with monkeypatch.context() as m:
        _per_call(m)
        want = kops.fp8_linear(x, w)
    assert torch.equal(first, want) and torch.equal(again, want)
    assert weight_cache.quantize_count(w, ("kernel", "fp8_e4m3")) == 1


def test_codes_are_one_byte_per_element(model, params):
    """The kept operand is fp8 codes plus a scale, never a second bf16
    copy of the weight (fp4's grid is kept in e4m3, which holds it)."""
    for fmt in ("fp8_e4m3", "fp8_e5m2", "fp4_e2m1"):
        model.apply(params, _tokens(model, (1, 4)),
                    QuantContext(mode="mp", mp=_plan(model, fmt),
                                 act_scale_token=True))
        w = _weight(params, "layers/0/mlp/gate_proj")
        q, s_inv = weight_cache.cached(w, ("fake", fmt), None)
        assert q.data.element_size() == 1 and q.data.shape == w.shape
        assert q.scale_inv.numel() == 1 and s_inv == float(q.scale_inv)


def test_one_quantization_per_weight_across_a_drain(model, params):
    """A continuous drain (prefill chunks and decode steps, fused and
    gather engines) under a plan quantizes each plan weight once; a second
    drain quantizes nothing."""
    mp = _plan(model)
    plan = MPPlan(assignment=dict(mp), groups=[], objective="ET", tau=0.0,
                  budget=0.0, predicted_loss_mse=0.0, predicted_gain=0.0)
    reqs = make_requests(model.cfg.vocab_size, 4, 12, 5, 2)
    n0 = weight_cache.quantizations
    for paged_attn in ("fused", "gather"):
        eng = ContinuousBatchingEngine(model, n_slots=2, max_len=32,
                                       block_size=4, mp=plan,
                                       paged_attn=paged_attn, device="cpu")
        out = eng.serve(params, reqs)
        assert out.n_steps > 0 and len(out.results) == 4
    linear = [op for op, f in mp.items() if not op.endswith("_matmul")]
    assert weight_cache.quantizations - n0 == len(linear)
    for op in linear:
        assert weight_cache.quantize_count(
            _weight(params, op), ("fake", "fp8_e4m3")) == 1, op
    eng.serve(params, reqs)
    assert weight_cache.quantizations - n0 == len(linear)


def test_one_quantization_per_weight_across_the_measured_tier(model,
                                                              params):
    """The measured tier's combos under ``impl="kernel"``: every linear
    weight is quantized once, however many combos set it to fp8."""
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, model.cfg.vocab_size, (2, 16))
                .astype(np.int32),
                "labels": rng.integers(0, model.cfg.vocab_size, (2, 16))
                .astype(np.int32)} for _ in range(2)]
    bundle = tpl.calibrate(model, params, batches, tpl.AMPOptions())
    toks = _tokens(model, (2, 16))
    runs = []

    def factory(assignment):
        ctx = QuantContext(mode="mp", mp=dict(assignment), impl="kernel")

        def run():
            model.apply(params, toks, ctx)
            runs.append(sum(f != "bf16" for f in assignment.values()))
        return run

    n0 = weight_cache.quantizations
    amax0 = qc.launches["amax"]
    tpl.tabulate_measured_gains(bundle, factory, n_warmup=1, n_iters=2)
    linear = {op.name for op in bundle.sens.ops if op.kind == "linear"}
    assert sum(runs) > 2 * len(linear)          # weights met many times
    assert weight_cache.quantizations - n0 == len(linear)
    for op in linear:
        assert weight_cache.quantize_count(
            _weight(params, op), ("kernel", "fp8_e4m3")) == 1, op
    assert qc.launches["amax"] == amax0         # plain versions count none


def test_changed_weight_or_new_params_are_quantized_again(model, params,
                                                          monkeypatch):
    """An in-place change (version counter), a swapped storage (data
    pointer) and new params are never served a stale operand."""
    ctx = QuantContext(mode="mp", mp=_plan(model), act_scale_token=True)
    toks = _tokens(model)
    model.apply(params, toks, ctx)
    key = ("fake", "fp8_e4m3")
    w = _weight(params, "layers/0/attn/q_proj")
    w.mul_(2.0)
    got = model.apply(params, toks, ctx)
    assert weight_cache.quantize_count(w, key) == 2
    w.data = w.data.clone() * 0.5
    got_swapped = model.apply(params, toks, ctx)
    assert weight_cache.quantize_count(w, key) == 3
    with monkeypatch.context() as m:
        _per_call(m)
        assert torch.equal(got_swapped, model.apply(params, toks, ctx))
        w.mul_(2.0)
        want = model.apply(params, toks, ctx)
        w.mul_(0.5)
    assert torch.equal(got, want)
    other = model.init(default_generator(1, "cpu"), "cpu")
    got_other = model.apply(other, toks, ctx)
    with monkeypatch.context() as m:
        _per_call(m)
        assert torch.equal(got_other, model.apply(other, toks, ctx))
    assert weight_cache.quantize_count(
        _weight(other, "layers/0/attn/q_proj"), key) == 1


def test_calibrated_scale_is_part_of_the_key(model, params):
    w = _weight(params, "layers/0/mlp/up_proj")
    x = torch.randn(3, w.shape[1]).to(torch.bfloat16)
    key = ("fake", "fp8_e4m3")
    outs = []
    for s in (None, 2.0, 2.0, torch.tensor(4.0)):
        ctx = QuantContext(mode="mp", mp={"up": "fp8_e4m3"},
                           act_scale_token=True,
                           scales=None if s is None else {"up": (1.0, s)})
        outs.append(qops.linear(ctx, "up", x, w))
    assert weight_cache.quantize_count(w, key) == 3
    assert torch.equal(outs[1], outs[2])
    assert not torch.equal(outs[0], outs[1])


def test_activations_and_bgemm_operands_are_never_cached(model):
    g = torch.Generator().manual_seed(5)
    a = torch.randn(2, 4, 2, 3, 8, generator=g).to(torch.bfloat16)
    b = torch.randn(2, 6, 2, 8, generator=g).to(torch.bfloat16)
    x = torch.randn(2, 4, 8, generator=g).to(torch.bfloat16)
    w = torch.randn(16, 8, generator=g).to(torch.bfloat16)
    w_grad = w.float().requires_grad_()
    ctx = QuantContext(mode="mp", mp={"qk": "fp8_e4m3", "lin": "fp8_e4m3",
                                      "g": "fp8_e4m3"},
                       act_scale_token=True)
    n0 = weight_cache.quantizations
    for _ in range(2):
        qops.bgemm(ctx, "qk", "BTKGD,BSKD->BKGTS", a, b)
        qops.linear(ctx, "lin", x, w)
        qops.linear(ctx, "g", x.float(), w_grad)
    assert weight_cache.quantizations - n0 == 1          # w alone, once
    for t in (a, b, x, w_grad):
        assert weight_cache.quantize_count(t) == 0
    assert weight_cache.quantize_count(w) == 1
