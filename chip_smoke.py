#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out chiprun_out/chip_smoke.json]

Phases, each of which raises (and so exits non-zero) when it fails:

1. print the card's name and power limit, build every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel);
2. hold the paged-decode kernel against its plain PyTorch version at the
   serving shapes (B=4, Hkv=8, G=4, D=64, block 16, up to 160 keys): bf16
   and scaled fp8-e4m3 KV, window None and 7, a vacant row (all -1 table,
   length 0), and NaN in blocks no live page references; then time kernel,
   plain version and ``scaled_dot_product_attention`` over gathered K/V;
3. serve Llama-3.2-1B at full width (random weights from a seeded
   generator) through the launcher's code path — 8 requests, 4 slots,
   128-token prompts, 32 new tokens, one arrival every 2 steps — on the
   continuous engine with fused and with gather decode attention, and on
   the one-shot engine; check launch counts, that the logits behind every
   token agree up to each request's first divergence, and that a
   divergence sits only at a near-tie of the reference's logits (the
   logits are read off the engines' step closures, which this script
   wraps; the engines compute no diagnostics);
4. the same checks under an MP plan (fp8 on every linear op of layers
   8-15, plus the attention BGEMMs of layer 15, which then takes the
   gather path): the continuous gather drain against the one-shot engine,
   the fused drain against the gather drain;
5. print the kernel table and the serving numbers as JSON lines;
6. print ``{"ok": true, "device": {...}}`` as the last line.

Exits non-zero without a result when no CUDA device is visible or the
package is not beside this script.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# phase 2 shapes: the serving drain's decode step at full width
B, HKV, G, D, BS, MAX_LEN = 4, 8, 4, 64, 16, 160
# kernel vs plain version: 2 bf16 ulps at |o| ~ 1, absolute and relative —
# f32 sums taken in another order may flip the bf16 rounding of a score or
# a probability, which moves an output by about one ulp
KERNEL_TOL = 2.0 ** -6
# two correct serving paths see the same context up to their first token
# divergence; where they sum attention in other f32 orders, a bf16 attention
# output moves by about one ulp, and after 16 layers the bf16 logits
# (|logit| in [2, 4), ulp 1/64) by a few ulps: 4 measured fused vs gather
# on an H100 (PERF.md), so 8 ulps
LOGIT_TOL = 0.125
# a greedy token may differ between two correct paths only where the
# reference's top-two logit gap is below this (divergences seen: <= 2 ulps)
MARGIN_BOUND = 0.125
# under the MP plan an activation that differs by one bf16 rounding can cross
# an e4m3 rounding boundary and move by a whole fp8 step (1/8 of its value)
# in each of 8 quantized layers, so the kernel's comparison under the plan
# allows twice as much
LOGIT_TOL_MP = 0.25
MARGIN_BOUND_MP = 0.25
HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                  # dense tensor-core bf16 peak
SERVE = dict(requests=8, n_slots=4, prompt_len=128, new_tokens=32,
             arrival_every=2, block_size=16)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def eager_ms(torch, fn, iters: int, warmup: int = 5) -> float:
    """Mean time per call of ``fn()`` over ``iters`` back-to-back eager
    calls, CUDA events around the run: the host's launch overhead included
    whenever it exceeds the device time."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, calls: int = 20, replays: int = 25) -> float:
    """Mean device time per call of ``fn()``: ``calls`` calls captured in a
    CUDA graph, the graph replayed ``replays`` times between CUDA events, so
    no host launch overhead enters."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


# ---------------------------------------------------------------------------
# phase 2: kernel against its plain version
# ---------------------------------------------------------------------------


def paged_case(torch, seed: int, kv_dtype, poison_value: float,
               lengths=(MAX_LEN, 100, BS, 0)):
    """Block tables with every hazard the pool produces: rows of several
    lengths (a page boundary, mid-page, one page), a vacant row (all -1,
    length 0) and dead entries pointing at poisoned blocks."""
    from repro_torch.quant.formats import cast_to
    rng = np.random.default_rng(seed)
    n_pages = MAX_LEN // BS
    n_live = B * n_pages
    n_blocks = 1 + n_live + 4
    poison = np.arange(1 + n_live, n_blocks)
    perm = rng.permutation(np.arange(1, 1 + n_live))
    lengths = np.asarray(lengths, np.int32)
    tables = np.full((B, n_pages), -1, np.int32)
    c = 0
    for b in range(B):
        if lengths[b] == 0:
            continue                          # vacant row: all entries -1
        used = -(-int(lengths[b]) // BS)
        tables[b, :used] = perm[c:c + used]
        c += used
        for pg in range(used, n_pages):       # dead entries may be stale ids
            if rng.random() < 0.5:
                tables[b, pg] = rng.choice(poison)

    def fill(shape):
        x = rng.normal(size=shape).astype(np.float32)
        x[poison] = poison_value
        return cast_to(torch.from_numpy(x).cuda(), kv_dtype)

    k = fill((n_blocks, BS, HKV, D))
    v = fill((n_blocks, BS, HKV, D))
    q = torch.from_numpy(rng.normal(size=(B, HKV, G, D)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    return (q, k, v, torch.from_numpy(tables).cuda(),
            torch.from_numpy(lengths).cuda())


def kernel_phase(torch) -> dict:
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_decode_attention_ref
    common = dict(scale=math.sqrt(D), scale_mode="div",
                  score_dtype=torch.bfloat16, probs_dtype=torch.bfloat16,
                  out_dtype=torch.bfloat16)
    max_err = 0.0
    for kv_name, kv_dtype, ks, vs in (("bf16", torch.bfloat16, 1.0, 1.0),
                                      ("fp8_e4m3", torch.float8_e4m3fn,
                                       0.5, 2.0)):
        for window in (None, 7):
            # finite poison, so the plain version (which multiplies zero
            # probabilities into every gathered block) stays finite
            args = paged_case(torch, 0, kv_dtype, 224.0)
            kw = dict(common, window=window, k_scale=ks, v_scale=vs)
            got = pa.paged_decode_attention(*args, **kw)
            want = paged_decode_attention_ref(*args, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            max_err = max(max_err, err)
            ok = torch.allclose(got.float(), want.float(), rtol=KERNEL_TOL,
                                atol=KERNEL_TOL)
            log(f"kernel vs plain: kv {kv_name} window {window}: max abs err "
                f"{err:.3e} (tol {KERNEL_TOL:g})")
            if not ok:
                raise AssertionError(f"kernel disagrees with its plain "
                                     f"version: kv {kv_name} window {window}")
            if got[3].abs().max().item() != 0.0:
                raise AssertionError("vacant row (length 0) is not zero")
            # NaN in blocks only dead entries reference must never be read
            nan_args = paged_case(torch, 0, kv_dtype, float("nan"))
            got_nan = pa.paged_decode_attention(*nan_args, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(got_nan.float()).all():
                raise AssertionError("kernel read a block no live page "
                                     "references")
            if not torch.equal(got_nan, got):
                raise AssertionError("NaN in unreferenced blocks changed the "
                                     "kernel's output")
    log(f"kernel vs plain: all cases within tolerance, max abs err "
        f"{max_err:.3e}")
    return {"max_abs_err": max_err}


def time_kernel(torch) -> dict:
    """Kernel, plain version and the SDPA yardstick at a mid-drain decode
    step (rows at 160, 152, 144, 136 keys), bound from this input."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_decode_attention_ref, paged_deq
    import torch.nn.functional as F
    lengths = (160, 152, 144, 136)
    q, k, v, bt, ln = paged_case(torch, 1, torch.bfloat16, 0.0, lengths)
    kw = dict(scale=math.sqrt(D), scale_mode="div",
              score_dtype=torch.bfloat16, probs_dtype=torch.bfloat16,
              out_dtype=torch.bfloat16)
    n0 = pa.launches

    def kernel():
        return pa.paged_decode_attention(q, k, v, bt, ln, **kw)

    def plain():
        return paged_decode_attention_ref(q, k, v, bt, ln, **kw)

    ms, ms_eager = device_ms(torch, kernel), eager_ms(torch, kernel, 500)
    t0 = time.perf_counter()
    for _ in range(200):
        kernel()
    host_ms = (time.perf_counter() - t0) / 200 * 1e3   # enqueue only
    torch.cuda.synchronize()
    pa.launches = n0                  # timing launches are not path launches
    plain_ms, plain_eager = device_ms(torch, plain), eager_ms(torch, plain, 50)
    # SDPA over K/V gathered beforehand (not timed): (B, H, S, D) operands
    kg = paged_deq(k, bt, torch.bfloat16, 1.0).permute(0, 2, 1, 3)
    vg = paged_deq(v, bt, torch.bfloat16, 1.0).permute(0, 2, 1, 3)
    kg = kg.repeat_interleave(G, dim=1).contiguous()
    vg = vg.repeat_interleave(G, dim=1).contiguous()
    qs = q.reshape(B, HKV * G, 1, D)
    S = kg.shape[2]
    mask = (torch.arange(S, device="cuda")[None, :]
            < ln[:, None]).reshape(B, 1, 1, S)
    def library():
        return F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask)

    lib_ms, lib_eager = device_ms(torch, library), eager_ms(torch, library,
                                                           500)
    live = sum(lengths)
    nbytes = (q.numel() * 2 + live * HKV * 2 * D * 2 + bt.numel() * 4
              + ln.numel() * 4 + B * HKV * G * D * 2)
    ops = 2 * live * HKV * G * 2 * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "ms_eager": ms_eager, "plain_ms_eager": plain_eager,
            "library_ms_eager": lib_eager, "host_enqueue_ms": host_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "bound_ops": ops}


# ---------------------------------------------------------------------------
# phases 3 and 4: serving
# ---------------------------------------------------------------------------


def first_divergence(a: np.ndarray, b: np.ndarray) -> int:
    diff = np.nonzero(a != b)[0]
    return int(diff[0]) if diff.size else len(a)


def record_steps(eng, names) -> list:
    """Wrap the engine's step closures ``names`` (instance attributes; the
    engine itself computes no diagnostics) so every call appends ``(name,
    logits, *inputs)`` to the returned list. Only references are kept: no
    copy, no host sync, so the timed drain runs as it would unrecorded."""
    events = []

    def wrap(name, step):
        def recorded(params, caches, *inputs):
            logits, caches = step(params, caches, *inputs)
            events.append((name, logits, *inputs))
            return logits, caches
        return recorded

    for name in names:
        setattr(eng, name, wrap(name, getattr(eng, name)))
    return events


def continuous_logits(events, reqs) -> dict:
    """rid -> (n_tokens, V) logits behind each greedy token of a continuous
    drain. A prefill row belongs to the request whose prompt it carries
    (one prefill per prompt: chunked prefill is not ported); a decode row
    belongs to its slot's request while its block table is live (rows not
    decoding get all -1)."""
    import torch
    by_prompt = {np.asarray(r.tokens, np.int32).tobytes(): r.rid
                 for r in reqs}
    slot_rid, rows = {}, {r.rid: [] for r in reqs}
    for name, logits, *inputs in events:
        if name == "prefill_chunk_step":
            tok, _, valid, _ = inputs
            tok, valid = tok.cpu().numpy(), valid.cpu().numpy()
            live = np.nonzero(valid)[0]
            for s in live:
                slot_rid[s] = by_prompt[tok[s, :valid[s]].tobytes()]
        else:
            live = np.nonzero(inputs[2][:, 0].cpu().numpy() >= 0)[0]
        for s in live:
            rows[slot_rid[s]].append(logits[s, -1])
    return {rid: torch.stack(r) for rid, r in rows.items()}


def oneshot_logits(events, reqs) -> dict:
    """rid -> (n_tokens, V) logits of the one-shot engine (batch order)."""
    import torch
    steps = torch.stack([logits[:, -1] for _, logits, *_ in events], dim=1)
    return {r.rid: steps[i] for i, r in enumerate(reqs)}


def top2_gaps(logits) -> np.ndarray:
    top = logits.float().topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]).cpu().numpy()


def compare(name: str, got: dict, ref: dict, *, tol: float, bound: float,
            failures: list) -> dict:
    """Two drains of the same requests, each ``rid -> (tokens, logits)``.

    * Logits: up to and including each request's first token divergence
      both paths saw the same context, so their logits must agree within
      ``tol`` (max abs error over the vocabulary).
    * Tokens: equal up to the first divergence, which may sit only where
      the reference's top-two gap is below ``bound``.

    Logs and returns the share of tokens before divergences, the max logit
    error and the share of reference positions whose gap is below ``bound``
    (what the token rule alone would let through). Appends what fails to
    ``failures``, so every comparison is logged before the phase raises."""
    agreed = total = n_near = 0
    err, problems = 0.0, []
    for rid in sorted(ref):
        (a, la), (r, lr) = got[rid], ref[rid]
        a, r = np.asarray(a), np.asarray(r)
        for tok, lg in ((a, la), (r, lr)):      # the recorder's own check
            if lg.shape[0] != len(tok) or not np.array_equal(
                    lg.float().argmax(-1).cpu().numpy(), tok):
                raise AssertionError(f"{name}: logits recorded for request "
                                     f"{rid} do not give its tokens")
        i = first_divergence(a, r)
        n = min(i + 1, len(r))
        err = max(err, (la[:n].float() - lr[:n].float()).abs().max().item())
        gaps = top2_gaps(lr)
        n_near += int((gaps < bound).sum())
        agreed += i
        total += len(r)
        if i < len(r):
            log(f"{name}: request {rid} diverges at token {i} where the "
                f"reference's top-2 gap is {gaps[i]:.4f}")
            if not gaps[i] < bound:
                problems.append(f"request {rid} diverges at token {i} with a "
                                f"top-2 gap {gaps[i]:.4f} >= {bound}")
    out = {"token_share": agreed / max(total, 1), "max_logit_err": err,
           "near_tie_share": n_near / max(total, 1)}
    log(f"{name}: {100 * out['token_share']:.2f}% of tokens agree before "
        f"any divergence; logits before divergence max abs err {err:.4f} "
        f"(tol {tol}); {100 * out['near_tie_share']:.2f}% of reference "
        f"positions have a top-2 gap below {bound}")
    if not err <= tol:
        problems.append(f"logits differ by {err:.4f} > {tol}")
    failures.extend(f"{name}: {p}" for p in problems)
    return out


def run_continuous(torch, model, params, reqs, *, mp=None, paged_attn):
    """Warm-up drain of one request, then the recorded drain of ``reqs``.
    Returns (summary, launches in the recorded drain, rid -> (tokens,
    logits))."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(
        model, n_slots=SERVE["n_slots"],
        max_len=SERVE["prompt_len"] + SERVE["new_tokens"], mp=mp,
        block_size=SERVE["block_size"], paged_attn=paged_attn, device="cuda")
    eng.serve(params, reqs[:1])
    events = record_steps(eng, ("prefill_chunk_step", "decode_step"))
    torch.cuda.synchronize()
    pa.launches = 0
    out = eng.serve(params, reqs)
    torch.cuda.synchronize()
    launches = pa.launches
    for r in reqs:
        res = out.results.get(r.rid)
        if res is None or res.status != "ok" or len(res.tokens) != \
                r.max_new_tokens:
            raise AssertionError(f"{paged_attn}: request {r.rid} did not "
                                 f"complete")
        if not ((res.tokens >= 0) & (res.tokens < model.cfg.vocab_size)).all():
            raise AssertionError(f"{paged_attn}: token out of range")
    logits = continuous_logits(events, reqs)
    return out, launches, {rid: (out.results[rid].tokens, logits[rid])
                           for rid in logits}


def run_oneshot(model, params, reqs, mp=None):
    """The one-shot engine on the same prompts, one batch. Returns (result,
    rid -> (tokens, logits))."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(model, mp=mp, device="cuda")
    batch = {"tokens": np.stack([r.tokens for r in reqs])}
    eng.generate(params, batch, max_new_tokens=2)       # warm-up
    events = record_steps(eng, ("prefill_step", "bucketed_prefill_step",
                                "decode_step"))
    out = eng.generate(params, batch, max_new_tokens=SERVE["new_tokens"])
    logits = oneshot_logits(events, reqs)
    return out, {r.rid: (out.tokens[i], logits[r.rid])
                 for i, r in enumerate(reqs)}


def serving_numbers(out) -> dict:
    return {"tokens_per_s": out.tokens_per_s,
            "ttft_p50_ms": out.counters["ttft_p50_s"] * 1e3,
            "n_decode_steps": out.n_steps,
            "kernel_launches": out.counters["kernel_launches"],
            "peak_blocks_in_use": out.counters["peak_blocks_in_use"]}


def serve_phase(torch) -> dict:
    """Phases 3 and 4 at full width on the card."""
    from repro_torch.launch.serve import make_model_and_params, make_requests
    t0 = time.perf_counter()
    model, params = make_model_and_params("llama3_1b", False, "cuda", seed=0)
    torch.cuda.synchronize()
    n_layers = model.cfg.n_layers
    log(f"{model.cfg.name}: {model.n_params() / 1e9:.3f}B params, "
        f"random init in {time.perf_counter() - t0:.1f} s")
    reqs = make_requests(model.cfg.vocab_size, SERVE["requests"],
                         SERVE["prompt_len"], SERVE["new_tokens"],
                         SERVE["arrival_every"])
    fused, n_fused, fused_tl = run_continuous(torch, model, params, reqs,
                                              paged_attn="fused")
    log(f"fused: {fused.n_steps} decode steps, {n_fused} kernel launches")
    if n_fused != fused.n_steps * n_layers or n_fused == 0:
        raise AssertionError(f"fused launches {n_fused} != "
                             f"{fused.n_steps} steps x {n_layers} layers")
    gather, n_gather, gather_tl = run_continuous(torch, model, params, reqs,
                                                 paged_attn="gather")
    if n_gather != 0:
        raise AssertionError(f"gather path launched the kernel {n_gather} "
                             f"times")
    oneshot, one_tl = run_oneshot(model, params, reqs)
    for rid in gather_tl:             # both run the same paged prefill
        if not torch.equal(fused_tl[rid][1][0], gather_tl[rid][1][0]):
            raise AssertionError(f"prefill logits of request {rid} differ "
                                 f"between fused and gather")
    failures = []
    plain = dict(tol=LOGIT_TOL, bound=MARGIN_BOUND, failures=failures)
    agree_fg = compare("fused vs gather", fused_tl, gather_tl, **plain)
    agree_go = compare("gather vs one-shot", gather_tl, one_tl, **plain)

    # phase 4: the MP plan
    from repro_torch.core.mpconfig import MPPlan
    assignment = {f"layers/{i}/{op}": "fp8_e4m3"
                  for i in range(n_layers // 2, n_layers)
                  for op in ("attn/q_proj", "attn/k_proj", "attn/v_proj",
                             "attn/o_proj", "mlp/gate_proj", "mlp/up_proj",
                             "mlp/down_proj")}
    last = n_layers - 1
    for op in ("qk_matmul", "av_matmul"):
        assignment[f"layers/{last}/attn/{op}"] = "fp8_e4m3"
    plan = MPPlan(assignment=assignment, groups=[], objective="ET", tau=0.0,
                  budget=0.0, predicted_loss_mse=0.0, predicted_gain=0.0)
    mp_out, n_mp, mp_tl = run_continuous(torch, model, params, reqs, mp=plan,
                                         paged_attn="fused")
    log(f"MP plan ({plan.n_quantized} fp8 ops): {mp_out.n_steps} decode "
        f"steps, {n_mp} kernel launches")
    if n_mp != mp_out.n_steps * (n_layers - 1):
        raise AssertionError(f"MP launches {n_mp} != {mp_out.n_steps} steps "
                             f"x {n_layers - 1} fused layers")
    # the plan's serving path against the one-shot engine, both on the
    # reference attention; then the kernel against it under the plan
    mp_gather, n_mp_gather, mp_gather_tl = run_continuous(
        torch, model, params, reqs, mp=plan, paged_attn="gather")
    if n_mp_gather != 0:
        raise AssertionError(f"MP gather path launched the kernel "
                             f"{n_mp_gather} times")
    _, mp_one_tl = run_oneshot(model, params, reqs, mp=plan)
    agree_mp_go = compare("MP gather vs MP one-shot", mp_gather_tl,
                          mp_one_tl, **plain)
    agree_mp_fg = compare("MP fused vs MP gather", mp_tl, mp_gather_tl,
                          tol=LOGIT_TOL_MP, bound=MARGIN_BOUND_MP,
                          failures=failures)
    if failures:
        raise AssertionError("; ".join(failures))
    return {
        "kernel_launches_main_path": n_fused,
        "agreement": {"fused_vs_gather": agree_fg,
                      "gather_vs_oneshot": agree_go,
                      "mp_gather_vs_mp_oneshot": agree_mp_go,
                      "mp_fused_vs_mp_gather": agree_mp_fg},
        "serving": {
            "fused": serving_numbers(fused),
            "gather": serving_numbers(gather),
            "oneshot": {"tokens_per_s": oneshot.tokens_per_s,
                        "ttft_ms": oneshot.ttft_s * 1e3},
            "mp_fused": serving_numbers(mp_out),
            "mp_gather": serving_numbers(mp_gather),
        },
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every number as JSON to this path")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    resolve_device("cuda")            # sets the matmul precision policy

    card = card_line()
    print(card, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        report_lines = {line.strip() for line in
                        _build.build_log(name).splitlines()
                        if "registers" in line or "spill" in line}
        for line in sorted(report_lines):
            log(f"ptxas {name}: {line}")

    report = {"card": card}
    report.update(kernel_phase(torch))
    report.update(time_kernel(torch))
    log("paged_decode_attention device time (CUDA graph): kernel "
        f"{report['ms'] * 1e3:.2f} us | plain {report['plain_ms'] * 1e3:.2f} "
        f"us | SDPA {report['library_ms'] * 1e3:.2f} us | bound "
        f"{report['bound_ms'] * 1e3:.3f} us ({report['bound_by']})")
    log("eager per call (launch overhead included): kernel "
        f"{report['ms_eager'] * 1e3:.2f} us | plain "
        f"{report['plain_ms_eager'] * 1e3:.2f} us | SDPA "
        f"{report['library_ms_eager'] * 1e3:.2f} us | wrapper enqueue "
        f"{report['host_enqueue_ms'] * 1e3:.2f} us")
    report.update(serve_phase(torch))

    kernels = [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:204",
        "launches": report["kernel_launches_main_path"],
        "max_abs_err": report["max_abs_err"],
        "ms": report["ms"],
        "kernel_ms": report["ms"],
        "plain_ms": report["plain_ms"],
        "bound_ms": report["bound_ms"],
        "bound_by": report["bound_by"],
        "library_ms": report["library_ms"],
    }]
    report["kernels"] = kernels
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=2))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"serving": report["serving"],
                      "agreement": report["agreement"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
