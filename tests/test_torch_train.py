"""The port's training math (``repro_torch.train.optim``,
``repro_torch.launch.steps.make_train_step``,
``repro_torch.distributed.grad_compress`` and ``remat``) against the
reference on the CPU.

Both packages get the same numpy inputs, made from a seed; weights are drawn
once and move to the port through ``bridge.params_from_flat`` and to the
reference as arrays.
Tolerances, stated per test:

* the learning-rate schedule is bitwise against the reference's op-by-op
  schedule (the port evaluates the CPU libm ``cosf`` it calls; inside a
  jitted step XLA fuses the schedule and may round it differently by an
  ulp, so the other comparisons take the reference op by op where they
  compare the rate);
* ``apply_updates`` on identical params, grads and state: new params within
  one bf16 ulp, state within 1e-6 relative, with an absolute floor of 1e-6
  of the leaf's largest value: the reference's compiled update may fuse a
  multiply and an add into one rounding (an FMA; seen in its slice-by-slice
  update of a chunked leaf), and where a moment's two terms cancel that
  ulp is large against their sum. The global gradient norm's f32 sums add
  in another order (the reference's XLA reduction against PyTorch's);
  where clipping is active the clip factor carries that difference into
  every state element, so the state is then held to 1e-6 plus twice the
  norms' relative difference;
* one train step on the smoke configs of four block families, each cut to
  two layers (the reference's compile time). Plain, in
  the configs' bf16: the loss within 1e-4 relative, the gradient norm
  within 3e-3 relative (bf16 activations that round the other way), new
  params within 2 lr + one bf16 ulp of the reference's (a near-zero
  gradient whose sign differs moves AdamW's first update by up to 2 lr).
  Since AdamW's first update is about lr times the gradient's sign, the
  params alone hold the gradients loosely; the gradients are held leaf by
  leaf through the first moment, ``mu/<path>`` = (1 - b1) * clip * grad in
  f32 after one step: ||mu - mu_ref|| within 0.25 of ||mu_ref|| for every
  leaf (read: at most 0.139, Mamba-2's ``D``; a flipped sign reads 2, a
  dropped gradient 1, two swapped leaves of similar norm about 1.4).
  Under a fixed MP plan (fp8 on every op of the last layer and on the
  head) the compute runs in float32, so that an fp8 rounding is not flipped
  by a bf16 ulp upstream: the loss within 2e-4 relative, the gradient norm
  within 3e-2 relative, the first moment within 0.1 of each leaf's norm
  (read: at most 0.044, Hymba) plus 5e-5 of the whole moment's norm (a
  leaf of the quantized layer keeps one element past the fp8 flush, a sum
  that cancels to ~1e-5 of the norm and differs by ~100% of itself in
  DeepSeek's ``kv_a_proj``). Both packages cast the cotangent of a
  fake-quant op to fp8 (the transpose of a dtype conversion), so most
  gradient below a quantized op is flushed to zero, and an element that
  survives the flush in one package and not the other moves the norm by a
  whole element; one op at a time the gradients agree to 1e-6 of the
  largest (``test_fake_quant_gradient_matches_reference``);
* DeepSeek's MoE layer routes each token to its top-k experts. In bf16
  a one-ulp difference of the router's input moves its probabilities by
  up to ~0.5%, so where the k-th and (k+1)-th probabilities nearly tie the
  two packages may pick different experts, and the loss then parts by more
  than any summation order. The repo's MoE near-tie rule (ROADMAP C4)
  holds such a step: every token whose expert set differs from the
  reference's must sit at a near-tie of the reference's probabilities
  (k-th minus (k+1)-th below 2^-8) or downstream of an earlier such flip
  (a later position of the same sequence, in a later MoE layer), and the
  port's step run on the reference's expert choices (its own router
  probabilities, gathered at the reference's indices) is held to the
  tolerances above;
* ``n_microbatches=2`` against one batch: the first moment within 1e-2 of
  each leaf's norm (read: 2.5e-3; a step that keeps one microbatch of the
  two reads 0.69 or more);
* ``compress_decompress`` and ``compress_tree`` bitwise; ``remat`` bitwise
  against no ``remat`` within the port.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.distributed import grad_compress as jgc  # noqa: E402
from repro.launch.steps import make_train_step as jstep  # noqa: E402
from repro.models.registry import get_model as jget  # noqa: E402
from repro.nn.spec import ParamSpec as JSpec  # noqa: E402
from repro.nn.spec import flatten_paths as jflat  # noqa: E402
from repro.nn.spec import tree_from_flat as jtree  # noqa: E402
from repro.quant import qops as jqops  # noqa: E402
from repro.train import optim as jo  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.distributed import grad_compress as tgc  # noqa: E402
from repro_torch.launch.steps import make_eval_step  # noqa: E402
from repro_torch.launch.steps import make_train_step as tstep  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402
from repro_torch.models.registry import depth_overrides  # noqa: E402
from repro_torch.models.registry import get_model as tget  # noqa: E402
from repro_torch.nn.spec import ParamSpec as TSpec  # noqa: E402
from repro_torch.nn.spec import default_generator, flatten_paths  # noqa: E402
from repro_torch.nn.spec import tree_from_flat  # noqa: E402
from repro_torch.quant import qops as tqops  # noqa: E402
from repro_torch.train import optim as to  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: an eager step is hundreds of small ops, and
    beside other test workers each op's thread team waits for cores (the
    trainer tests ran 300x slower under six workers with a team per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEP_ARCHS = ("llama3_1b", "deepseek_v3_671b", "mamba2_370m", "hymba_1p5b")
STEP_TOL = {"plain": dict(loss=1e-4, gnorm=3e-3, mu=0.25, mu_floor=0.0),
            "mp": dict(loss=2e-4, gnorm=3e-2, mu=0.1, mu_floor=5e-5)}


def _t(a: np.ndarray) -> torch.Tensor:
    """A numpy array (bf16 included) as a CPU tensor of its dtype."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else np.asarray(t, np.float32), np.float32)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _assert_moments_close(want: dict, got: dict, rtol: float,
                          floor: float = 0.0) -> None:
    """Every first-moment leaf ``mu/<path>`` of the flat state ``got``
    within ``rtol`` of its norm in ``want``, plus ``floor`` of the norm of
    the whole first moment, in the L2 norm of the difference."""
    mu = {p: _np(v).astype(np.float64) for p, v in want.items()
          if p.startswith("mu/")}
    assert mu and set(mu) == {p for p in got if p.startswith("mu/")}
    total = np.sqrt(sum(np.square(v).sum() for v in mu.values()))
    for path, a in mu.items():
        d = np.linalg.norm(a - _np(got[path]))
        assert d <= rtol * np.linalg.norm(a) + floor * total, (
            path, d / max(np.linalg.norm(a), 1e-30))


def _assert_params_close(jp: dict, tp: dict, slack: float) -> None:
    """Every new param within ``slack`` + one bf16 ulp of the reference's."""
    tf = flatten_paths(tp)
    for path, v in jflat(jp).items():
        a, b = _np(v), _np(tf[path])
        bad = np.abs(a - b) > slack + _bf16_ulp(np.maximum(np.abs(a),
                                                            np.abs(b)))
        assert not bad.any(), (path, np.abs(a - b).max())


# ---------------------------------------------------------------------------
# (a) the schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(lr=1e-3, warmup_steps=5, total_steps=200),
    dict(),
    dict(lr=3e-4, warmup_steps=20, total_steps=150, min_lr_ratio=0.05),
    dict(lr=1e-2, warmup_steps=0, total_steps=1)])
def test_lr_at_matches_reference_bitwise(cfg):
    jc, tc = jo.OptConfig(**cfg), to.OptConfig(**cfg)
    want = np.array([np.asarray(jo.lr_at(jc, jnp.asarray(s, jnp.int32)))
                     for s in range(201)])
    got = to.lr_at(tc, torch.arange(201, dtype=torch.int32)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_select_optimizer_switches_to_adafactor_at_100b():
    for n in (10 ** 9, 99 * 10 ** 9, 100 * 10 ** 9):
        assert (to.select_optimizer(n).name
                == jo.select_optimizer(n).name)
    assert to.select_optimizer(10 ** 11).name == "adafactor"


# ---------------------------------------------------------------------------
# (b) apply_updates
# ---------------------------------------------------------------------------

# a factored leaf, a rank-1 leaf, a rank-3 leaf over the lowered chunk size
# (updated slice by slice), a rank-3 leaf with a unit row axis (unfactored),
# and keys that sort as strings (layers/10 before layers/2)
OPT_SHAPES = {"embed/w": (64, 16), "layers/0/norm/scale": (16,),
              "layers/10/experts/w": (4, 8, 16), "layers/2/proj/w": (16, 32),
              "layers/2/b": (3, 1, 5)}


@pytest.mark.parametrize("clip", ["inactive", "active"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_apply_updates_matches_reference(monkeypatch, name, clip):
    for mod in (jo, to):
        monkeypatch.setattr(mod, "_CHUNKED_UPDATE_BYTES", 512)
    kw = dict(name=name, lr=1e-2, warmup_steps=2, total_steps=10,
              grad_clip=1e6 if clip == "inactive" else 1.0)
    jc, tc = jo.OptConfig(**kw), to.OptConfig(**kw)
    rng = np.random.default_rng(7)
    bf = ml_dtypes.bfloat16
    p = {k: rng.normal(0, 0.5, s).astype(bf) for k, s in OPT_SHAPES.items()}
    g = {k: rng.normal(0, 1, s).astype(bf) for k, s in OPT_SHAPES.items()}
    specs = to.state_specs({k: TSpec(s, (None,) * len(s))
                            for k, s in OPT_SHAPES.items()}, tc)
    jspecs = jo.state_specs({k: JSpec(s, (None,) * len(s))
                             for k, s in OPT_SHAPES.items()}, jc)
    assert {k: v.shape for k, v in specs.items()} == \
        {k: v.shape for k, v in jspecs.items()}
    st = {k: (np.array(3, np.int32) if k == "step" else
              rng.normal(0, 0.1, s.shape).astype(np.float32)
              if k.startswith("mu/") else
              rng.uniform(0.01, 1, s.shape).astype(np.float32))
          for k, s in specs.items()}
    if name == "adafactor":     # the sliced leaf's factors, chunked too
        assert any(k.startswith("vr/layers/10") for k in st)
    jp, js, jm = jo.apply_updates(
        jtree({k: jnp.asarray(v) for k, v in p.items()}),
        jtree({k: jnp.asarray(v) for k, v in g.items()}),
        jtree({k: jnp.asarray(v) for k, v in st.items()}), jc)
    tp = tree_from_flat({k: _t(v) for k, v in p.items()})
    ts = tree_from_flat({k: _t(v) for k, v in st.items()})
    before = {k: v._version for k, v in flatten_paths(tp).items()}
    tp2, ts2, tm = to.apply_updates(
        tp, tree_from_flat({k: _t(v) for k, v in g.items()}), ts, tc)
    assert tp2 is tp and ts2 is ts                      # in place
    assert all(v._version > before[k]
               for k, v in flatten_paths(tp).items())
    assert float(jm["lr"]) == tm["lr"].item()
    jn, tn = float(jm["grad_norm"]), tm["grad_norm"].item()
    dn = abs(jn - tn) / jn
    assert dn < 1e-6
    _assert_params_close(jp, tp, 0.0)
    rtol = 1e-6 if clip == "inactive" else 1e-6 + 2 * dn
    tf = flatten_paths(ts)
    for path, v in jflat(js).items():
        a, b = np.asarray(v), tf[path].numpy()
        if path == "step":
            assert int(a) == int(b) == 4
            continue
        np.testing.assert_allclose(b, a, rtol=rtol,
                                   atol=rtol * np.abs(a).max(), err_msg=path)


# ---------------------------------------------------------------------------
# (c) one train step on four block families
# ---------------------------------------------------------------------------


def _batch(vocab: int, B: int = 4, T: int = 32, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, T)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, T)).astype(np.int32)}


def _numpy_params(model, seed: int = 0) -> dict:
    """Random weights of ``model`` (a port model) as flat numpy arrays, bf16
    leaves as ``ml_dtypes.bfloat16``: the inputs both packages get."""
    return {k: (v.float().numpy().astype(ml_dtypes.bfloat16)
                if v.dtype == torch.bfloat16 else v.numpy())
            for k, v in flatten_paths(model.init(
                default_generator(seed, "cpu"), "cpu")).items()}


def _pair(arch: str, **ov) -> tuple:
    """Both packages' smoke model of ``arch`` cut to its first two layers
    (DeepSeek's: a dense and an MoE MLA layer, MTP kept; Hymba's: its
    global and a windowed layer), and their weights as numpy arrays."""
    ov.update(depth_overrides(arch, 2, smoke=True, keep_mtp=True))
    jm, tm = jget(arch, smoke=True, **ov), tget(arch, smoke=True, **ov)
    return jm, tm, _numpy_params(tm)


# a flip of a token's top-k expert set is a near-tie below this gap (the
# k-th minus the (k+1)-th router probability; ROADMAP C4)
ROUTE_FLIP_GAP = 2.0 ** -8


def _recording_top_k(monkeypatch, routes: list) -> None:
    """The reference's ``jax.lax.top_k`` recording each call's
    probabilities in call order (MoE chunks, layer by layer), inside
    ``jit`` too."""
    orig = jax.lax.top_k

    def top_k(probs, k):
        jax.debug.callback(lambda x: routes.append(np.asarray(x)), probs,
                           ordered=True)
        return orig(probs, k)
    monkeypatch.setattr(jax.lax, "top_k", top_k)


def _flips_at_near_ties(ref: list, got: list, k: int, seq_len: int,
                        n_tokens: int) -> int:
    """Assert the MoE near-tie rule (module docstring) over both packages'
    router probabilities, call by call (each MoE layer one call per chunk
    of its ``n_tokens`` tokens, layer by layer); returns the flips."""
    assert len(ref) == len(got), (len(ref), len(got))
    tainted: dict = {}     # sequence -> first flipped position, earlier layers
    layer: dict = {}       # the same, this layer
    n_flips = 0
    for i, (a, b) in enumerate(zip(ref, got)):
        rows = a.shape[0]
        per_layer = n_tokens // rows
        if i % per_layer == 0:
            for seq, pos in layer.items():
                tainted[seq] = min(tainted.get(seq, seq_len), pos)
            layer = {}
        start = (i % per_layer) * rows
        top_a = np.argsort(-a, axis=-1, kind="stable")[:, :k]
        top_b = np.argsort(-b, axis=-1, kind="stable")[:, :k]
        srt = -np.sort(-a, axis=-1)
        gaps = srt[:, k - 1] - srt[:, k]
        for r in range(rows):
            if set(top_a[r]) == set(top_b[r]):
                continue
            n_flips += 1
            seq, pos = divmod(start + r, seq_len)
            ok = gaps[r] < ROUTE_FLIP_GAP or tainted.get(seq, seq_len) <= pos
            assert ok, (f"MoE call {i}: token {start + r} routed to "
                        f"{sorted(top_b[r])}, the reference's "
                        f"{sorted(top_a[r])} at a gap of {gaps[r]:.3e}")
            layer[seq] = min(layer.get(seq, seq_len), pos)
    return n_flips


@pytest.mark.parametrize("mode", ["plain", "mp"])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_reference(arch, mode, monkeypatch):
    ov = {} if mode == "plain" else {"dtype": "float32"}
    jm, tm, flat = _pair(arch, **ov)
    last = tm.cfg.n_layers - 1
    mp = None if mode == "plain" else {
        n: "fp8_e4m3" for n in tm.serving_op_names()
        if n.startswith(f"layers/{last}/") or n == "lm_head"}
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jc, tc = jo.OptConfig(**kw), to.OptConfig(**kw)
    b = _batch(tm.cfg.vocab_size)
    args = (jtree({k: jnp.asarray(v) for k, v in flat.items()}),
            jo.init_state(jm.param_specs(), jc),
            {k: jnp.asarray(v) for k, v in b.items()})
    moe = bool(tm.cfg.moe_layers)
    ref_routes: list = []
    if moe:
        _recording_top_k(monkeypatch, ref_routes)
    jp, js, jmet = jax.jit(jstep(jm, jc, mp=mp))(*args)

    def port_step():
        return tstep(tm, tc, mp=mp)(
            params_from_flat(flat, tm.cfg, "cpu"),
            to.init_state(tm.param_specs(), tc, "cpu"),
            {k: torch.from_numpy(v) for k, v in b.items()})

    if moe:
        jax.effects_barrier()
        own: list = []
        route = tmoe.route_top_k

        def recording(probs, k):
            own.append(probs.detach().float().numpy().copy())
            return route(probs, k)
        monkeypatch.setattr(tmoe, "route_top_k", recording)
        port_step()
        _flips_at_near_ties(ref_routes, own, tm.cfg.moe.top_k,
                            b["tokens"].shape[1], b["tokens"].size)
        # the step on the reference's expert choices
        calls = iter(ref_routes)

        def forced(probs, k):
            idx = torch.from_numpy(np.argsort(
                -next(calls), axis=-1, kind="stable")[:, :k].copy())
            return probs.gather(-1, idx), idx
        monkeypatch.setattr(tmoe, "route_top_k", forced)
    tp, ts, tmet = port_step()
    tol = STEP_TOL[mode]
    jl, tl = float(jmet["loss"]), tmet["loss"].item()
    assert abs(jl - tl) <= tol["loss"] * abs(jl), (jl, tl)
    jn, tn = float(jmet["grad_norm"]), tmet["grad_norm"].item()
    assert abs(jn - tn) <= tol["gnorm"] * jn, (jn, tn)
    _assert_params_close(jp, tp, 2 * float(jmet["lr"]))
    _assert_moments_close(jflat(js), flatten_paths(ts), tol["mu"],
                          tol["mu_floor"])


@pytest.mark.parametrize("kind", ["linear", "bgemm"])
def test_fake_quant_gradient_matches_reference(kind):
    """One fake-quantized op's gradients, both operands, against the
    reference's: the fp8 cast's cotangent is cast to fp8 and back in both
    (no custom backward needed). f32 operands; 1e-6 of the largest
    gradient (the einsums' sums add in another order), and 1e-5 relative
    for the amax element, whose gradient through the scale sums over the
    whole operand."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 8, 32)).astype(np.float32)
    w = rng.normal(0, 0.2, (2, 8, 32) if kind == "bgemm"
                   else (16, 32)).astype(np.float32)
    spec = "BSC,BTC->BST" if kind == "bgemm" else "BSC,KC->BSK"
    up = rng.normal(0, 1, (2, 8, 8 if kind == "bgemm" else 16)).astype(
        np.float32)
    mp = {"op": "fp8_e4m3"}

    def jf(a, b):
        return jnp.sum(jqops.qeinsum(jqops.QuantContext(mode="mp", mp=mp),
                                     "op", spec, a, b, kind=kind) * up)

    jg = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = tqops.qeinsum(tqops.QuantContext(mode="mp", mp=mp), "op", spec,
                        tx, tw, kind=kind)
    tg = torch.autograd.grad((out * torch.from_numpy(up)).sum(), (tx, tw))
    for a, b in zip(jg, tg):
        a = np.asarray(a)
        assert np.count_nonzero(a) < a.size         # the fp8 flush
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5,
                                   atol=1e-6 * np.abs(a).max())


# ---------------------------------------------------------------------------
# (d) microbatches, in-place updates and the weight cache
# ---------------------------------------------------------------------------


def test_microbatches_match_one_batch():
    """``n_microbatches=2`` against one batch of 8, within the reference's
    own 0.02 (``tests/test_train.py``): the loss is a mean of the two
    microbatch means. The loss is taken before the update and the first
    update is about lr times the gradient's sign, so the gradients are held
    through the first moment: each leaf within 1e-2 of its norm."""
    m = tget("llama3_1b", smoke=True)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    b = {k: torch.from_numpy(v) for k, v in _batch(512, 8, 32, 3).items()}
    outs = []
    for n in (1, 2):
        p = m.init(default_generator(0, "cpu"), "cpu")
        s = to.init_state(m.param_specs(), to.OptConfig(**kw), "cpu")
        outs.append(tstep(m, to.OptConfig(**kw), n_microbatches=n)(p, s, b))
    (p1, s1, m1), (p2, s2, m2) = outs
    assert abs(m1["loss"].item() - m2["loss"].item()) < 0.02
    _assert_moments_close(flatten_paths(s1), flatten_paths(s2), 1e-2)
    for a, c in zip(flatten_paths(p1).values(), flatten_paths(p2).values()):
        np.testing.assert_allclose(a.float().numpy(), c.float().numpy(),
                                   atol=2e-2)


def test_update_in_place_refreshes_the_weight_cache():
    """Params trained in place under a plan's eval: the next eval under the
    plan equals one over fresh copies of the params, bit for bit (the fp8
    weight cache saw every weight's version move)."""
    m = tget("llama3_1b", smoke=True)
    p = m.init(default_generator(0, "cpu"), "cpu")
    mp = {n: "fp8_e4m3" for n in m.serving_op_names()}
    b = {k: torch.from_numpy(v) for k, v in _batch(512, 2, 16, 4).items()}
    ev = make_eval_step(m, mp=mp)
    before = ev(p, b)
    c = to.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    tstep(m, c)(p, to.init_state(m.param_specs(), c, "cpu"), b)
    after = ev(p, b)
    fresh = ev(tree_from_flat({k: v.clone() for k, v in
                               flatten_paths(p).items()}), b)
    assert torch.equal(after, fresh) and not torch.equal(after, before)


# ---------------------------------------------------------------------------
# (e) gradient compression
# ---------------------------------------------------------------------------


def test_compress_matches_reference_bitwise():
    rng = np.random.default_rng(11)
    g = {"a": rng.normal(0, 1e-3, (8, 16)).astype(np.float32),
         "layers": {"10": {"w": rng.normal(0, 1, (4, 4)).astype(
             ml_dtypes.bfloat16)},
             "2": {"w": rng.normal(0, 5, (3,)).astype(np.float32)}}}
    e = {"a": rng.normal(0, 1e-5, (8, 16)).astype(np.float32),
         "layers": {"10": {"w": rng.normal(0, 1e-2, (4, 4)).astype(
             np.float32)},
             "2": {"w": np.zeros(3, np.float32)}}}
    for fmt in ("fp8_e4m3", "fp8_e5m2"):
        jo_, je = jgc.compress_tree(jax.tree.map(jnp.asarray, g),
                                    jax.tree.map(jnp.asarray, e), fmt)
        to_, te = tgc.compress_tree(
            tree_from_flat({k: _t(v) for k, v in jflat(g).items()}),
            tree_from_flat({k: _t(v) for k, v in jflat(e).items()}), fmt)
        for jt, tt in ((jo_, to_), (je, te)):
            tf = flatten_paths(tt)
            for path, v in jflat(jt).items():
                assert str(tf[path].dtype).endswith(str(v.dtype)), path
                np.testing.assert_array_equal(_np(tf[path]), _np(v),
                                              err_msg=path)
    q, err = tgc.compress_decompress(_t(g["a"]), _t(e["a"]))
    jq, jerr = jgc.compress_decompress(jnp.asarray(g["a"]),
                                       jnp.asarray(e["a"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
    # compressed_psum without a mesh layout: the reference's over an axis
    # of one member (its four-rank form: test_torch_train_mesh.py)
    for fmt in ("fp8_e4m3", "fp8_e5m2"):
        got = tgc.compressed_psum(_t(g["a"]), "data", fmt)
        want = jax.vmap(lambda v: jgc.compressed_psum(v, "data", fmt),
                        axis_name="data")(jnp.asarray(g["a"])[None])[0]
        np.testing.assert_array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# (f) remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3_1b", "deepseek_v3_671b",
                                  "whisper_base"])
def test_remat_gives_the_same_gradients(arch):
    """Gradients of the loss with ``remat`` equal those without, bit for
    bit (DeepSeek's smoke config covers MoE, MLA and the MTP loss; Whisper
    the encoder and the decoder)."""
    grads = []
    for remat in (False, True):
        m = tget(arch, smoke=True, remat=remat)
        p = m.init(default_generator(0, "cpu"), "cpu")
        b = {k: torch.from_numpy(v) for k, v in
             _batch(m.cfg.vocab_size, 2, 16, 1).items()}
        if arch == "whisper_base":
            b["frames"] = torch.from_numpy(np.random.default_rng(2).normal(
                0, 1, (2, 24, m.cfg.d_model)).astype(np.float32))
        leaves = {k: v.requires_grad_() for k, v in
                  flatten_paths(p).items()}
        loss = m.loss(tree_from_flat(leaves), b, tqops.QuantContext())
        grads.append(dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True))))
    assert dataclasses.replace(m.cfg, remat=False) != m.cfg
    for k, g in grads[0].items():
        if g is None:
            assert grads[1][k] is None
        else:
            assert torch.equal(g, grads[1][k]), k
