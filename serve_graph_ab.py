#!/usr/bin/env python3
"""Serving with the decode step run eagerly against the decode step
replayed as a CUDA graph, on one GPU, through the launcher's own profiler.

    python3 serve_graph_ab.py [--archs llama3_1b,deepseek_v3_671b,llama3_8b]
        [--out ab.json] [--arms eager,graph]

For each configuration at full width (random weights, seed 0; DeepSeek-V3's
dense prefix with absorbed MLA decode), plain and under a fixed MP plan (fp8
on the linear ops of the later half of the layers and the last layer's
BGEMMs, as ``chip_smoke.py`` serves), the serving cell of ``chip_smoke.py``
(8 requests, 4 slots, 128-token prompts, 32 new tokens, one arrival every 2
steps, block 16) is drained in turns by ``--arms`` (default eager,
graphed; ``eager,graph,graph,eager`` for a spread). Each arm: a warm-up
drain of one request (the graphed arm captures there), the
timed drain, then the same drain under ``torch.profiler``
(``launch.serve.profile_drain``: device busy time over the drain and its
share of the unprofiled drain's wall time; no trace file is written). The
graphed arm also times its
decode graph's replay between CUDA events (device time of one decode step,
no host in it). The eager arm swaps in the closure the graph captures
(``launch.steps.make_paged_decode_step``), so the two arms differ by the
graph alone. Prints one line per arm and, last, the card's name and power
limit; ``--out`` gets every number.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SERVE = dict(requests=8, n_slots=4, prompt_len=128, new_tokens=32,
             arrival_every=2, block_size=16)
DEEPSEEK = "deepseek_v3_671b"


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def model_for(arch: str):
    from repro_torch.launch.serve import make_model_and_params
    from repro_torch.models.registry import dense_prefix_overrides
    ov = {}
    if arch == DEEPSEEK:
        ov = dict(dense_prefix_overrides(arch), mla_absorb_decode=True)
    return make_model_and_params(arch, False, "cuda", seed=0, **ov)


def fixed_plan(model):
    from repro_torch.core.mpconfig import MPPlan
    n = model.cfg.n_layers
    mla = model.cfg.block_types[0] == "mla"
    attn = (("q_a_proj", "q_b_proj", "kv_a_proj", "kv_b_proj", "o_proj")
            if mla else ("q_proj", "k_proj", "v_proj", "o_proj"))
    first = 1 if mla else n // 2
    mp = {f"layers/{i}/{op}": "fp8_e4m3" for i in range(first, n)
          for op in [f"attn/{a}" for a in attn]
          + ["mlp/gate_proj", "mlp/up_proj", "mlp/down_proj"]}
    for op in ("qk_matmul", "av_matmul"):
        mp[f"layers/{n - 1}/attn/{op}"] = "fp8_e4m3"
    return MPPlan(assignment=mp, groups=[], objective="ET", tau=0.0,
                  budget=0.0, predicted_loss_mse=0.0, predicted_gain=0.0)


def replay_ms(torch, step, reps: int = 20) -> float:
    """Device ms of one replay of the step's decode graph."""
    graph = step._captured.graph
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run_arm(torch, model, params, reqs, plan, arm: str) -> dict:
    from repro_torch.launch.serve import profile_drain
    from repro_torch.launch.steps import make_paged_decode_step
    from repro_torch.serve import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(
        model, n_slots=SERVE["n_slots"],
        max_len=SERVE["prompt_len"] + SERVE["new_tokens"], mp=plan,
        block_size=SERVE["block_size"], device="cuda")
    graph_step = eng.decode_step
    if arm == "eager":
        eng.decode_step = make_paged_decode_step(model, mp=eng.mp)
    eng.serve(params, reqs[:1])
    torch.cuda.synchronize()
    out = eng.serve(params, reqs)
    torch.cuda.synchronize()
    prof = profile_drain(eng, params, reqs, None, out.total_s, top=5)
    c = out.counters
    rec = {"tokens_per_s": out.tokens_per_s,
           "ttft_p50_ms": c["ttft_p50_s"] * 1e3,
           "n_decode_steps": out.n_steps,
           "decode_wall_ms_per_step": out.decode_s / out.n_steps * 1e3,
           "drain_wall_ms": out.total_s * 1e3,
           "device_busy_ms": prof["device_busy_s"] * 1e3,
           "busy_share": prof["busy_share"],
           "graph_captures": c["graph_captures"],
           "graph_replays": c["graph_replays"],
           "kernel_launches": c["kernel_launches"],
           "top": prof["top"]}
    if arm == "graph":
        rec["replay_device_ms"] = replay_ms(torch, graph_step)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", default=f"llama3_1b,{DEEPSEEK},llama3_8b")
    ap.add_argument("--out", default=None)
    ap.add_argument("--arms", default="eager,graph")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_graph_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.serve import make_requests
    card = card_line()
    print(card, flush=True)
    report = {"card": card, "cell": SERVE, "runs": {}}
    for arch in args.archs.split(","):
        t0 = time.perf_counter()
        model, params = model_for(arch)
        reqs = make_requests(model.cfg.vocab_size, SERVE["requests"],
                             SERVE["prompt_len"], SERVE["new_tokens"],
                             SERVE["arrival_every"])
        print(f"[ab] {arch}: {model.n_params() / 1e9:.3f}B params "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        for label, plan in (("plain", None), ("mp", fixed_plan(model))):
            arms = []
            for arm in args.arms.split(","):
                rec = run_arm(torch, model, params, reqs, plan, arm)
                rec["arm"] = arm
                arms.append(rec)
                print(f"[ab] {arch} {label} {arm}: {rec['tokens_per_s']:.1f}"
                      f" tok/s | TTFT p50 {rec['ttft_p50_ms']:.2f} ms | "
                      f"decode {rec['decode_wall_ms_per_step']:.2f} ms/step "
                      f"wall | busy {rec['device_busy_ms']:.1f} ms of "
                      f"{rec['drain_wall_ms']:.1f} ms "
                      f"({100 * rec['busy_share']:.1f}%)"
                      + (f" | graph replay {rec['replay_device_ms']:.3f} ms"
                         f" device" if "replay_device_ms" in rec else "")
                      + f" | captures {rec['graph_captures']} replays "
                      f"{rec['graph_replays']}", flush=True)
            report["runs"][f"{arch}/{label}"] = arms
            if args.out:                    # kept as it grows
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                Path(args.out).write_text(json.dumps(report, indent=2))
        del model, params
        gc.collect()              # the model's decode graphs go with it
        torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
