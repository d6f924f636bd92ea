"""The port's checkpoints (``repro_torch.checkpoint``), its trainer
(``repro_torch.train.trainer``), the training launcher and the serving
launcher's ``--ckpt-dir``.

Checkpoints are held against the reference's ``CheckpointManager`` on the
CPU: a checkpoint written by either package restores in the other bit for
bit, with equal manifests (shapes, dtype names, digests), for f32, bf16,
fp8 and int32 leaves. The reference's ``Trainer`` fails on this tree (a
sharding error in its embedding gather), so the trainer's contract is
pinned within the port, as the reference's own tests state it: the loss
falls below 5.6 in 25 smoke steps, a resumed run equals a straight one
(bitwise on the CPU: the step-seeded stream and the eager step are
deterministic there), a corrupted checkpoint is quarantined, metrics are
written, and a straggler forces a checkpoint and exits with 17. Then the
reference's system loop (train, calibrate, solve, eval under the plan,
serve) at smoke size, and the two launchers.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.models.registry import get_model as jget  # noqa: E402
from repro.train import optim as jo  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.pipeline import AMPOptions  # noqa: E402
from repro_torch.core.pipeline import auto_mixed_precision  # noqa: E402
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import make_eval_step  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.nn.spec import flatten_paths  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train.optim import OptConfig  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: an eager step is hundreds of small ops, and
    beside other test workers each op's thread team waits for cores (the
    trainer tests ran 300x slower under six workers with a team per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FP8 = {"float8_e4m3fn": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn),
       "float8_e5m2": (ml_dtypes.float8_e5m2, torch.float8_e5m2)}


def _bits(x) -> np.ndarray:
    """The raw bytes of an array or tensor, as uint8."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous().reshape(-1)
        return x.view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _tree(rng, fp8=("float8_e4m3fn",)) -> dict:
    """A reference tree of every stored dtype: f32, bf16, fp8, int32, a
    0-d bf16 and the optimizer's 0-d step; NaN and inf among the bf16
    values."""
    x = rng.normal(0, 3, (5, 7)).astype(np.float32)
    x[0, :3] = (np.nan, np.inf, -np.inf)
    return {"params": {"embed": {"w": jnp.asarray(x)},
                       "layers": {"0": {"w": jnp.asarray(x, jnp.bfloat16),
                                        "s": jnp.asarray(x[1, 1],
                                                         jnp.bfloat16)}},
                       "q": {n: jnp.asarray(np.clip(x, -400, 400),
                                            FP8[n][0]) for n in fp8},
                       "i": jnp.asarray(np.arange(6, dtype=np.int32))},
            "opt": {"step": jnp.asarray(7, jnp.int32)}}


def _manifest(d: str, step: int) -> dict:
    with open(os.path.join(d, f"step_{step:010d}", "manifest.json")) as f:
        return json.load(f)


def test_checkpoints_restore_across_both_packages(tmp_path):
    """(g) The reference writes, the port restores; the port writes the
    restored tree again, the reference restores: every leaf bit for bit,
    in its dtype, and both manifests' array entries equal."""
    jt = _tree(np.random.default_rng(0))
    JManager(str(tmp_path / "j")).save(3, jt, extra={"loss": 1.5})
    step, tree, extra = CheckpointManager(str(tmp_path / "j")).restore(
        device="cpu")
    assert step == 3 and extra == {"loss": 1.5}
    want_dtypes = {"params/embed/w": torch.float32,
                   "params/layers/0/w": torch.bfloat16,
                   "params/layers/0/s": torch.bfloat16,
                   "params/i": torch.int32, "opt/step": torch.int32,
                   "params/q/float8_e4m3fn": torch.float8_e4m3fn}
    flat, jflat = flatten_paths(tree), flatten_paths(jt)
    assert {k: v.dtype for k, v in flat.items()} == want_dtypes
    for k, v in flat.items():
        assert tuple(v.shape) == jflat[k].shape, k
        np.testing.assert_array_equal(_bits(v), _bits(jflat[k]), err_msg=k)
    CheckpointManager(str(tmp_path / "t")).save(5, tree)
    step, back, _ = JManager(str(tmp_path / "t")).restore()
    assert step == 5
    for k, v in flatten_paths(back).items():
        assert str(v.dtype) == str(jflat[k].dtype), k
        np.testing.assert_array_equal(_bits(v), _bits(jflat[k]), err_msg=k)
    assert _manifest(str(tmp_path / "j"), 3)["arrays"] == \
        _manifest(str(tmp_path / "t"), 5)["arrays"]


def test_caveat_reference_e5m2_leaf_does_not_restore(tmp_path):
    """The reference writes an ``ml_dtypes`` e5m2 leaf under the npy
    descriptor ``<f1``, which numpy cannot read back, so neither package
    restores it; the port writes e5m2 as 1-byte void, which both read."""
    jt = _tree(np.random.default_rng(1), fp8=("float8_e5m2",))
    JManager(str(tmp_path / "j")).save(1, jt)
    assert JManager(str(tmp_path / "j")).latest_valid_step() is None
    assert CheckpointManager(str(tmp_path / "j")).latest_valid_step() is None
    q = torch.from_numpy(np.asarray(jt["params"]["q"]["float8_e5m2"]).view(
        np.uint8).copy()).view(torch.float8_e5m2)
    CheckpointManager(str(tmp_path / "t")).save(2, {"q": q})
    step, back, _ = JManager(str(tmp_path / "t")).restore()
    assert step == 2 and str(back["q"].dtype) == "float8_e5m2"
    np.testing.assert_array_equal(_bits(back["q"]), _bits(q))


def test_keep_n_and_quarantine(tmp_path):
    """(h) keep-N garbage collection, a staging directory never counted,
    a corrupted newest checkpoint walked past (by both packages), and
    ``only=`` reading one subtree."""
    d = str(tmp_path)
    cm = CheckpointManager(d, keep_n=2)
    tree = {"params": {"a": torch.arange(10, dtype=torch.float32)},
            "opt": {"b": torch.ones(3, 3, dtype=torch.bfloat16)}}
    for s in (1, 2, 3):
        tree["params"]["a"] += 1
        cm.save(s, tree, extra={"s": s})
    assert cm.all_steps() == [2, 3]
    os.makedirs(os.path.join(d, "step_0000000009.tmp"))
    assert cm.all_steps() == [2, 3] and cm.latest_valid_step() == 3
    path = os.path.join(d, "step_0000000003", "arrays.npz")
    with open(path, "r+b") as f:
        f.seek(200)
        f.write(b"\xde\xad\xbe\xef" * 8)
    assert cm.latest_valid_step() == 2
    assert JManager(d).latest_valid_step() == 2
    step, got, extra = cm.restore(device="cpu")
    assert step == 2 and extra == {"s": 2}
    assert torch.equal(got["params"]["a"],
                       torch.arange(10, dtype=torch.float32) + 2)
    _, only, _ = cm.restore(device="cpu", only="params")
    assert set(only) == {"params"}


def test_a_corrupted_step_is_saved_again_but_a_valid_one_is_not(tmp_path):
    """A step saved again after its checkpoint was corrupted replaces it
    (the old directory moved aside, the new one renamed into place, the old
    one deleted); saving over a valid checkpoint raises and leaves it
    whole. The reference's rename refuses both."""
    d = str(tmp_path / "t")
    cm = CheckpointManager(d)
    cm.save(1, {"a": torch.zeros(4)})
    with pytest.raises(FileExistsError):
        cm.save(1, {"a": torch.ones(4)})
    assert torch.equal(cm.restore(device="cpu")[1]["a"], torch.zeros(4))
    with open(os.path.join(d, "step_0000000001", "arrays.npz"), "r+b") as f:
        f.truncate(50)
    assert cm.latest_valid_step() is None
    cm.save(1, {"a": torch.ones(4)})
    assert sorted(os.listdir(d)) == ["step_0000000001"]
    assert torch.equal(cm.restore(device="cpu")[1]["a"], torch.ones(4))
    os.makedirs(os.path.join(d, "step_0000000002.old"))  # a crash's leftover
    assert cm.all_steps() == [1]
    jm = JManager(str(tmp_path / "j"))
    jm.save(1, {"a": jnp.zeros(4)})
    with pytest.raises(OSError):
        jm.save(1, {"a": jnp.ones(4)})


# ---------------------------------------------------------------------------
# the trainer's contract
# ---------------------------------------------------------------------------


def _data() -> SyntheticLM:
    return SyntheticLM(SyntheticConfig(vocab_size=512, batch=8, seq_len=64),
                       "cpu")


def _trainer(d: str, total_steps: int = 25, **kw) -> Trainer:
    kw.setdefault("log_every", 100)
    kw.setdefault("ckpt_every", 10)
    return Trainer(get_model("llama3_1b", smoke=True),
                   OptConfig(lr=1e-3, warmup_steps=5, total_steps=50), None,
                   TrainerConfig(total_steps=total_steps, ckpt_dir=d,
                                 metrics_path=os.path.join(d,
                                                           "metrics.jsonl"),
                                 **kw), device="cpu")


def test_trainer_loss_decreases(tmp_path):
    tr = _trainer(str(tmp_path))
    _, _, last = tr.fit(_data())
    # the first loss is near ln(512) = 6.24
    assert tr.history[0]["loss"] > 6.0 and last < 5.6


def test_trainer_resume_equals_straight_run(tmp_path):
    """20 steps, a restart that resumes at 20 and runs to 30, against a
    straight 30-step run: params and optimizer state bit for bit."""
    data = _data()
    d = str(tmp_path / "ck")
    _trainer(d, total_steps=20).fit(data)
    tr = _trainer(d, total_steps=30)
    step, _, _ = tr.init_or_resume(0)
    assert step == 20
    p2, o2, _ = tr.fit(data)
    assert [h["step"] for h in tr.history] == list(range(21, 31))
    p3, o3, _ = _trainer(str(tmp_path / "straight"), total_steps=30).fit(data)
    for a, b in ((p2, p3), (o2, o3)):
        fa, fb = flatten_paths(a), flatten_paths(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            assert torch.equal(fa[k], fb[k]), k


def test_trainer_quarantines_a_corrupted_checkpoint(tmp_path):
    d = str(tmp_path)
    _trainer(d, total_steps=20).fit(_data())
    steps = CheckpointManager(d).all_steps()
    assert steps == [10, 20]
    path = os.path.join(d, f"step_{steps[-1]:010d}", "arrays.npz")
    with open(path, "r+b") as f:
        f.seek(200)
        f.write(b"\xde\xad\xbe\xef" * 8)
    tr = _trainer(d, total_steps=25)
    step, _, _ = tr.init_or_resume(0)
    assert step == 10
    tr.fit(_data())
    assert [h["step"] for h in tr.history] == list(range(11, 26))


def test_trainer_writes_metrics(tmp_path):
    tr = _trainer(str(tmp_path), total_steps=12, log_every=5)
    tr.fit(_data())
    with open(os.path.join(str(tmp_path), "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 5, 10]
    assert all({"loss", "dt", "lr", "grad_norm"} <= set(r) for r in recs)


def test_straggler_forces_a_checkpoint_and_exits_17(tmp_path):
    """A step 10x the median of the ones before it (a patched clock:
    1 s a step, the 8th 10 s) writes a straggler record, checkpoints at
    that step although ``ckpt_every`` is not due, and exits with 17 under
    ``abort_on_straggler``."""
    d = str(tmp_path)
    tr = _trainer(d, total_steps=20, ckpt_every=100,
                  abort_on_straggler=True)
    # two readings a step (before and after it), one second apart, but
    # the 8th step's second reading 10 s after its first
    ticks = iter(np.cumsum([0.0] + [1.0] * 14 + [10.0] + [1.0] * 40))
    tr.clock = lambda: float(next(ticks))
    with pytest.raises(SystemExit) as e:
        tr.fit(_data())
    assert e.value.code == 17
    assert CheckpointManager(d).all_steps() == [8]
    with open(os.path.join(d, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert {"event": "straggler", "step": 8, "dt": 10.0,
            "median": 1.0} in recs


def test_mesh_waits_for_a9b(tmp_path):
    """What still waits after A9b's training half: ``Trainer(mesh=)`` and
    ``launch.train --mesh-*`` refuse expert (MoE) layers and
    encoder-decoder models, naming the ROADMAP item, before any process
    group is touched (the mesh training itself is held in
    ``test_torch_train_mesh.py``)."""
    for arch, kw in (("moonshot_v1_16b_a3b", {}),
                     ("whisper_base", {})):
        with pytest.raises(NotImplementedError, match="ROADMAP C10"):
            Trainer(get_model(arch, smoke=True, **kw), OptConfig(), object(),
                    TrainerConfig(ckpt_dir=str(tmp_path)), device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP C10"):
            ttrain.main(["--smoke", "--device", "cpu", "--arch", arch,
                         "--mesh-data", "2", "--ckpt-dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# the system loop and the launchers
# ---------------------------------------------------------------------------


def test_full_system_loop(tmp_path):
    """The reference's system loop at smoke size, in the port: train 40
    steps, solve a TT plan at tau 0.01 on the trained model, the eval loss
    under the plan within 5% of the plain one, and greedy tokens served
    under the plan agreeing with plain serving on more than 60%."""
    m = get_model("llama3_1b", smoke=True)
    data = _data()
    tr = Trainer(m, OptConfig(lr=1e-3, warmup_steps=5, total_steps=60), None,
                 TrainerConfig(total_steps=40, ckpt_every=20,
                               ckpt_dir=str(tmp_path / "ck"), log_every=100),
                 device="cpu")
    params, _, last_loss = tr.fit(data)
    assert last_loss < 5.5
    calib = [data.batch_at(1000 + i) for i in range(3)]
    plan = auto_mixed_precision(m, params, calib,
                                AMPOptions(tau=0.01, objective="TT"))
    assert plan.n_quantized > 0
    assert plan.predicted_loss_mse <= plan.budget * (1 + 1e-9)
    evals = [data.batch_at(2000 + i) for i in range(3)]
    d_ref = np.mean([float(make_eval_step(m)(params, b)) for b in evals])
    d_mp = np.mean([float(make_eval_step(m, plan.assignment)(params, b))
                    for b in evals])
    assert abs(d_mp - d_ref) / d_ref < 0.05
    prompt = {"tokens": data.batch_at(3000)["tokens"][:2, :16]}
    out_ref = ServeEngine(m, device="cpu").generate(params, dict(prompt),
                                                    max_new_tokens=8)
    out_mp = ServeEngine(m, mp=plan.assignment, device="cpu").generate(
        params, dict(prompt), max_new_tokens=8)
    agree = float(np.mean(np.asarray(out_ref.tokens)
                          == np.asarray(out_mp.tokens)))
    assert agree > 0.6, agree


def test_launchers_train_then_serve_the_checkpoint(tmp_path, capsys):
    """``launch.train --smoke --device cpu`` then ``launch.serve
    --ckpt-dir``: the launcher serves the trained params (bit for bit the
    trainer's), and a checkpoint in the reference trainer's layout (its
    ``CheckpointManager``, ``{"params", "opt"}``) serves the same way."""
    d = str(tmp_path / "ck")
    params, last = ttrain.main([
        "--smoke", "--device", "cpu", "--steps", "12", "--batch", "4",
        "--seq", "32", "--ckpt-dir", d, "--ckpt-every", "6"])
    assert CheckpointManager(d).all_steps() == [6, 12]
    m = get_model("llama3_1b", smoke=True)
    step, restored = tserve.restore_params(m, d, "cpu")
    assert step == 12
    for k, v in flatten_paths(params).items():
        assert torch.equal(v, flatten_paths(restored)[k]), k
    serve = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
             "8", "--new-tokens", "4"]
    tserve.main(serve + ["--ckpt-dir", d])
    assert f"params of step 12 restored from {d}" in capsys.readouterr().out
    jm = jget("llama3_1b", smoke=True)
    jc = jo.OptConfig()
    JManager(str(tmp_path / "j")).save(
        4, {"params": jm.init(jax.random.key(1)),
            "opt": jo.init_state(jm.param_specs(), jc)})
    tserve.main(serve + ["--ckpt-dir", str(tmp_path / "j")])
    assert "params of step 4 restored" in capsys.readouterr().out
    with pytest.raises(ValueError, match="does not hold"):
        tserve.restore_params(get_model("qwen2p5_3b", smoke=True), d, "cpu")
