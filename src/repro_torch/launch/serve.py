"""Serving launcher: one-shot batch or continuous batching on the paged KV
pool, plain, under an MP plan, or under a plan solved at serve time from a
calibration bundle.

    # continuous batching, staggered arrivals, full-width llama3_1b on the
    # GPU (--arch llama3_8b: Llama-3.1-8B's widths, 16 GB of weights)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_1b \
        --continuous --n-slots 4 --requests 8 --arrival-every 2 \
        --prompt-len 128 --new-tokens 32 [--mp-plan plan.json]

    # solve per serving SLA from a calibrate() artifact — no recalibration
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_1b \
        --continuous --calibration bundle.npz --tau 0.01 --objective ET

    # the same at smoke size on the CPU (plain PyTorch paths)
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --continuous \
        --device cpu

    # DeepSeek-V3's dense MLA prefix, absorbed decode through the MLA form
    # of the paged kernel; a one-shot prompt past --flash-min-seq prefills
    # through the blocked flash attention
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek_v3_671b --dense-prefix --mla-absorb-decode \
        --continuous
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --arch deepseek_v3_671b --dense-prefix --flash-min-seq 64 \
        --prompt-len 96 --batch 1

Weights are random, drawn from a ``torch.Generator`` seeded with 0 (no
checkpoint is in the repository); prompts come from numpy seeded with 1, as
in the reference launcher. An ``--mp-plan`` JSON saved by either package's
``MPPlan.save`` flows into either engine; ``--calibration`` loads a
``CalibrationBundle`` saved by either package, and ``--registry`` picks the
freshest bundle filed for this arch and these weights; both run the cheap IP
for ``--tau`` / ``--objective`` here. Reports TTFT and decode throughput;
continuous mode also reports the paged pool, the kernel launches and the
decode step's CUDA graph captures and replays (on the card the decode step
is captured once, in the warm-up drain, and replayed after).
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.core.mpconfig import MPPlan
from repro_torch.core.pipeline import CalibrationBundle
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.registry import dense_prefix_overrides, get_model
from repro_torch.nn.spec import default_generator
from repro_torch.serve import ContinuousBatchingEngine, Request, ServeEngine

__all__ = ["build_parser", "make_model_and_params", "make_requests",
           "load_plan", "check_bundle_ops", "solve_from_bundle",
           "registry_bundle", "report_continuous", "profile_drain", "main"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3_1b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke configuration")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--dense-prefix", action="store_true",
                    help="keep only the layers before the first MoE layer "
                         "and drop multi-token prediction (DeepSeek-V3: its "
                         "three dense MLA layers)")
    ap.add_argument("--mla-absorb-decode", action="store_true",
                    help="MLA decode in the latent space (the fused paged "
                         "kernel's MLA form)")
    ap.add_argument("--flash-min-seq", type=int, default=None,
                    help="prompt length from which prefill takes the "
                         "blocked flash attention (default: the config's)")
    ap.add_argument("--mp-plan", default=None, help="MPPlan json path")
    ap.add_argument("--calibration", default=None,
                    help="CalibrationBundle path (json/npz): solve the IP at "
                         "serve time instead of loading a fixed plan")
    ap.add_argument("--tau", type=float, default=None,
                    help="loss-MSE threshold for --calibration solves "
                         "(default: the bundle's calibration-time tau)")
    ap.add_argument("--objective", default=None, choices=("ET", "TT", "M"),
                    help="IP objective for --calibration solves")
    ap.add_argument("--registry", default=None,
                    help="bundle registry root: pick the freshest "
                         "calibration bundle compatible with this arch and "
                         "these weights' fingerprint, instead of trusting a "
                         "hand-passed --calibration path")
    ap.add_argument("--batch", type=int, default=4,
                    help="one-shot batch size")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--continuous", action="store_true",
                    help="serve a staggered request stream instead of one "
                         "batch")
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--arrival-every", type=int, default=2,
                    help="decode steps between request arrivals")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged KV block size in tokens")
    ap.add_argument("--n-blocks", type=int, default=None,
                    help="paged KV pool size incl. the trash block (default: "
                         "the worst case, which never backpressures)")
    ap.add_argument("--paged-attn", default=None, choices=("fused", "gather"),
                    help="paged decode attention: 'fused' (default) runs the "
                         "CUDA kernel over block-major KV; 'gather' keeps "
                         "the reference path")
    ap.add_argument("--profile", default=None, metavar="TRACE.json",
                    help="continuous mode: serve the stream once more under "
                         "torch.profiler, write its chrome trace here and "
                         "print the device busy share and the top kernels")
    return ap


def make_model_and_params(arch: str, smoke: bool, device: DeviceLike,
                          seed: int = 0, **overrides):
    """The model (config ``overrides`` applied) and its random params drawn
    on ``device``."""
    device = resolve_device(device)
    model = get_model(arch, smoke=smoke, **overrides)
    params = model.init(default_generator(seed, device), device)
    return model, params


def make_requests(vocab_size: int, n: int, prompt_len: int, new_tokens: int,
                  arrival_every: int, seed: int = 1) -> list:
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    tokens=rng.integers(0, vocab_size,
                                        prompt_len).astype(np.int32),
                    max_new_tokens=new_tokens, arrival=i * arrival_every)
            for i in range(n)]


def load_plan(path: str, model) -> MPPlan:
    plan = MPPlan.load(path)
    print(f"[serve] MP plan: {plan.n_quantized} ops quantized "
          f"(objective {plan.objective}, tau {plan.tau})")
    unknown = plan.unknown_ops(model.serving_op_names())
    if unknown:
        print(f"[serve] WARNING: {len(unknown)} plan ops not in this model "
              f"(e.g. {sorted(unknown)[:3]}) — they will NOT apply; was the "
              f"plan solved for a different arch?")
    return plan


def check_bundle_ops(model, bundle: CalibrationBundle, src: str) -> None:
    """Refuse a bundle calibrated on another model's op namespace."""
    unknown = bundle.unknown_ops(model.serving_op_names())
    if unknown:
        raise SystemExit(
            f"[serve] calibration bundle ({src}) has {len(unknown)} ops not "
            f"in this model (e.g. {sorted(unknown)[:3]}); was it calibrated "
            f"for a different arch?")


def solve_from_bundle(bundle: CalibrationBundle, tau, objective,
                      src: str) -> MPPlan:
    """Serve-time solve: run the cheap IP for the requested SLA."""
    plan = bundle.solve(tau=tau, objective=objective)
    tier = plan.meta.get("gain_tier", "analytic")
    print(f"[serve] solved from {src}: tau {plan.tau} objective "
          f"{plan.objective} -> {plan.n_quantized} ops quantized (predicted "
          f"gain {plan.predicted_gain:.3e} [{tier}], MSE "
          f"{plan.predicted_loss_mse:.3e} <= {plan.budget:.3e})")
    if tier == "roofline_fallback":
        print("[serve] note: no measured wall-clock gain table in this "
              "bundle — the solve used roofline gains (run "
              "tabulate_measured_gains + re-save to upgrade)")
    return plan


def registry_bundle(model, params, path: str) -> tuple:
    """Serve-time registry lookup: the freshest bundle compatible with the
    arch and the fingerprint of the weights actually served."""
    from repro_torch.core.pipeline import _params_fingerprint
    from repro_torch.core.registry import BundleRegistry
    arch = model.cfg.name
    fp = _params_fingerprint(params)
    bundle = BundleRegistry(path).find(arch, fp)
    print(f"[serve] registry match: arch {arch} fingerprint {fp} "
          f"(calib_hash {bundle.meta.get('calib_hash')})")
    return bundle, f"{path}:{arch}/{fp}"


def report_continuous(out, n_requests: int, n_slots: int) -> None:
    c = out.counters
    print(f"[serve] continuous: {n_requests} reqs via {n_slots} slots | "
          f"{out.n_steps} decode steps | {out.tokens_per_s:.1f} tok/s | "
          f"TTFT p50 {c['ttft_p50_s'] * 1e3:.2f} ms")
    print(f"[serve] paged KV: block_size {c['block_size']} | "
          f"{c['peak_blocks_in_use']}/{c['n_blocks'] - 1} blocks at peak | "
          f"peak KV {c['peak_kv_bytes'] / 1e6:.2f} MB | "
          f"{c['blocked_admissions']} blocked admissions")
    print(f"[serve] decode attention ({c['paged_attn']}): "
          f"{c['kernel_launches']} kernel launches over {out.n_steps} steps "
          f"| {c['prefill_chunks']} prefill steps")
    print(f"[serve] decode step: {c['graph_captures']} CUDA graph captures, "
          f"{c['graph_replays']} replays")


def profile_drain(eng, params, reqs, trace_path: Optional[str],
                  unprofiled_wall_s: float, top: int = 12) -> dict:
    """Serve ``reqs`` once under ``torch.profiler`` (CPU + CUDA activity),
    write the chrome trace (unless ``trace_path`` is None: an eager drain's
    trace takes tens of seconds to write), and print the device time of
    the drain — the
    sum over device-side events (kernels, copies) — against the wall time of
    the same drain served without the profiler, which slows only the host,
    and the device events that took the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if eng.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = eng.serve(params, reqs)
    if trace_path is not None:
        prof.export_chrome_trace(trace_path)
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy_s = sum(r[0] for r in rows) * 1e-6
    res = {"wall_s": unprofiled_wall_s, "profiled_wall_s": out.total_s,
           "device_busy_s": busy_s,
           "busy_share": busy_s / unprofiled_wall_s,
           "n_decode_steps": out.n_steps,
           "top": [{"kernel": k, "device_ms": us / 1e3, "count": n}
                   for us, n, k in rows[:top]]}
    print(f"[serve] profile: device busy {busy_s * 1e3:.1f} ms over "
          f"{out.n_steps} decode steps | drain wall {unprofiled_wall_s * 1e3:.1f}"
          f" ms unprofiled ({100 * res['busy_share']:.1f}% busy), "
          f"{out.total_s * 1e3:.1f} ms profiled | trace {trace_path}")
    for r in res["top"]:
        print(f"[serve]   {r['device_ms']:9.3f} ms  x{r['count']:<6d} "
              f"{r['kernel'][:90]}")
    return res


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    ov = dense_prefix_overrides(args.arch, args.smoke) \
        if args.dense_prefix else {}
    if args.mla_absorb_decode:
        ov["mla_absorb_decode"] = True
    if args.flash_min_seq is not None:
        ov["flash_min_seq"] = args.flash_min_seq
    model, params = make_model_and_params(args.arch, args.smoke, device,
                                          **ov)
    print(f"[serve] {model.cfg.name} on {device}: random-init params "
          f"({model.n_params() / 1e6:.1f}M)")
    if sum(map(bool, (args.mp_plan, args.calibration, args.registry))) > 1:
        raise SystemExit("--mp-plan, --calibration and --registry are "
                         "mutually exclusive")
    if (args.tau is not None or args.objective is not None) \
            and not (args.calibration or args.registry):
        raise SystemExit("--tau/--objective select a serve-time solve and "
                         "require --calibration or --registry")
    plan = bundle = None
    if args.calibration:
        bundle, src = CalibrationBundle.load(args.calibration), \
            args.calibration
    elif args.registry:
        bundle, src = registry_bundle(model, params, args.registry)
    if bundle is not None:
        check_bundle_ops(model, bundle, src)
        plan = solve_from_bundle(bundle, args.tau, args.objective, src)
    elif args.mp_plan:
        plan = load_plan(args.mp_plan, model)
    if args.continuous:
        eng = ContinuousBatchingEngine(
            model, n_slots=args.n_slots,
            max_len=args.prompt_len + args.new_tokens, mp=plan,
            block_size=args.block_size, n_blocks=args.n_blocks,
            paged_attn=args.paged_attn, device=device)
        reqs = make_requests(model.cfg.vocab_size, args.requests,
                             args.prompt_len, args.new_tokens,
                             args.arrival_every)
        eng.serve(params, reqs[:1])                  # warm-up
        out = eng.serve(params, reqs)
        report_continuous(out, args.requests, args.n_slots)
        if args.profile:
            profile_drain(eng, params, reqs, args.profile, out.total_s)
    elif args.profile:
        raise SystemExit("--profile traces the continuous engine; pass "
                         "--continuous")
    else:
        eng = ServeEngine(model, mp=plan, device=device)
        rng = np.random.default_rng(1)
        prompt = {"tokens": rng.integers(0, model.cfg.vocab_size,
                                         (args.batch, args.prompt_len))}
        eng.generate(params, prompt, max_new_tokens=2)       # warm-up
        out = eng.generate(params, prompt, max_new_tokens=args.new_tokens)
        print(f"[serve] TTFT {out.ttft_s * 1e3:.2f} ms | decode "
              f"{out.tokens_per_s:.1f} tok/s | batch {args.batch} x "
              f"{args.new_tokens} new tokens")
    if device.type == "cuda":
        torch.cuda.synchronize(device)


if __name__ == "__main__":
    main()
