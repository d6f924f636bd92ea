"""Serving launcher: one-shot batch or continuous batching on the paged KV
pool (or dense per-slot rings), plain, under an MP plan, or under a plan
solved at serve time from a calibration bundle.

    # continuous batching, staggered arrivals, full-width llama3_1b on the
    # GPU (--arch llama3_8b: Llama-3.1-8B's widths, 16 GB of weights;
    # --dense-slots for the dense rings)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_1b \
        --continuous --n-slots 4 --requests 8 --arrival-every 2 \
        --prompt-len 128 --new-tokens 32 [--mp-plan plan.json]

    # solve per serving SLA from a calibrate() artifact — no recalibration
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_1b \
        --continuous --calibration bundle.npz --tau 0.01 --objective ET

    # the same at smoke size on the CPU (plain PyTorch paths)
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --continuous \
        --device cpu

    # Mixture-of-Experts: Moonlight's config (48 MoE layers, 56 GB of
    # bf16 weights) and DeepSeek-V3 at 5 of its 61 layers (its dense MLA
    # layers and MoE layers 3-4, 53 GB), absorbed decode through the MLA
    # form of the paged kernel
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch moonshot_v1_16b_a3b --continuous
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek_v3_671b --n-layers 5 --mla-absorb-decode --continuous

    # DeepSeek-V3's dense MLA prefix, absorbed decode through the MLA form
    # of the paged kernel; a one-shot prompt past --flash-min-seq prefills
    # through the blocked flash attention
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek_v3_671b --dense-prefix --mla-absorb-decode \
        --continuous
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --arch deepseek_v3_671b --dense-prefix --flash-min-seq 64 \
        --prompt-len 96 --batch 1

Weights are random, drawn from a ``torch.Generator`` seeded with 0, or,
with ``--ckpt-dir``, the params of the newest valid checkpoint there (one
written by ``python -m repro_torch.launch.train`` or by the reference's
trainer); prompts come from numpy seeded with 1, as in the reference
launcher::

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --continuous --ckpt-dir /tmp/ck

An ``--mp-plan`` JSON saved by either package's
``MPPlan.save`` flows into either engine; ``--calibration`` loads a
``CalibrationBundle`` saved by either package, and ``--registry`` picks the
freshest bundle filed for this arch and these weights; both run the cheap IP
for ``--tau`` / ``--objective`` here. Reports TTFT and decode throughput;
continuous mode also reports the paged pool's peak KV bytes against the
dense slots', the kernel launches, the steps' CUDA graph captures and
replays by kind (on the card each step is captured once per input shape,
mostly in the warm-up drain, and replayed after), the prefill chunks,
buckets and decode stalls, and the prefix cache's hits, copy-on-write forks
and preemptions. As in the reference, the continuous engine shares prompt
prefixes across requests (``--no-prefix-cache`` turns it off) and lets a
higher-priority request preempt; ``--chunk-len`` / ``--chunk-budget`` split
long prompts into chunks interleaved with decode steps.

Serving robustness, as in the reference: ``--adaptive-tau`` walks a ladder
of plans solved from the bundle under load, ``--inject-faults`` serves
under a fault schedule (``--max-retries`` bounds the retries),
``--guardrail-every`` holds the plan to its loss-MSE budget with a shadow
step, and ``--n-blocks auto`` sizes the paged pool from the request
profile::

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --continuous --inject-faults 'nan_page@step=3;hung_step@step=5' \
        --n-blocks auto
"""
from __future__ import annotations

import argparse
import contextlib
import io
from typing import Optional

import numpy as np
import torch

from repro_torch.core.mpconfig import MPPlan
from repro_torch.core.pipeline import CalibrationBundle
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.registry import (dense_prefix_overrides,
                                         depth_overrides, get_model)
from repro_torch.nn.spec import default_generator, flatten_paths
from repro_torch.serve import ContinuousBatchingEngine, Request, ServeEngine

__all__ = ["build_parser", "make_model_and_params", "restore_params",
           "make_requests",
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
    ap.add_argument("--n-layers", type=int, default=None,
                    help="keep only the first N layers and drop multi-token "
                         "prediction (DeepSeek-V3 past its dense prefix on "
                         "one card: 5, its dense layers and MoE layers 3-4)")
    ap.add_argument("--mla-absorb-decode", action="store_true",
                    help="MLA decode in the latent space (the fused paged "
                         "kernel's MLA form)")
    ap.add_argument("--flash-min-seq", type=int, default=None,
                    help="prompt length from which prefill takes the "
                         "blocked flash attention (default: the config's)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of the newest valid checkpoint "
                         "in this directory instead of random ones")
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
    ap.add_argument("--adaptive-tau", type=float, default=None,
                    help="enable load-adaptive MP (continuous mode; needs "
                         "--calibration or --registry): serve under a tau "
                         "ladder starting at this base, escalating to more "
                         "aggressive plans as the queue grows and restoring "
                         "as it drains")
    ap.add_argument("--adaptive-levels", type=int, default=3,
                    help="tau ladder depth (base * factor**i)")
    ap.add_argument("--adaptive-factor", type=float, default=2.0)
    ap.add_argument("--adaptive-every", type=int, default=2,
                    help="controller evaluation cadence in engine ticks")
    ap.add_argument("--adaptive-dwell", type=int, default=4,
                    help="min ticks between plan swaps")
    ap.add_argument("--adaptive-queue-high", type=int, default=2,
                    help="queue-depth watermark that triggers escalation")
    ap.add_argument("--adaptive-queue-low", type=int, default=0,
                    help="queue-depth watermark below which to restore")
    ap.add_argument("--inject-faults", default=None,
                    help="deterministic fault schedule for the continuous "
                         "engine, e.g. 'nan_page@step=3,slot=0;"
                         "alloc_failure@step=5,slot=1' (kind@k=v,...; a "
                         "bare number is the step); see "
                         "repro_torch.serve.FaultSpec")
    ap.add_argument("--max-retries", type=int, default=1,
                    help="bounded per-request retries after a contained "
                         "fault before the request is marked failed")
    ap.add_argument("--guardrail-every", type=int, default=None,
                    help="enable the tau-anchored numerical guardrail: run a "
                         "high-precision shadow step every N decode steps and "
                         "compare logit MSE against the active plan's "
                         "loss-MSE budget (continuous mode with an MP plan)")
    ap.add_argument("--guardrail-margin", type=float, default=4.0,
                    help="breach when shadow MSE > margin * budget")
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
    ap.add_argument("--n-blocks", default=None,
                    help="paged KV pool size incl. the trash block: an int, "
                         "'auto' to size from the request profile (p95 "
                         "live-block demand x headroom, see "
                         "PagedCachePool.size_n_blocks), or omit for the "
                         "worst case (never backpressures)")
    ap.add_argument("--chunk-len", type=int, default=None,
                    help="split prompts into prefill chunks of this many "
                         "tokens, interleaved with decode steps (continuous "
                         "mode; prompts are length-bucketed either way)")
    ap.add_argument("--chunk-budget", type=int, default=1,
                    help="max prefill chunk steps between decode steps "
                         "(bounds per-request decode stall while a long "
                         "prompt prefills)")
    ap.add_argument("--mesh", default=None, metavar="data=N,model=M",
                    help="serve the continuous engine over a (data, model) "
                         "mesh: one process a rank, started by torchrun "
                         "(NCCL on CUDA, gloo on the CPU); 1x1 is the "
                         "single-rank engine, as in the reference; rank 0 "
                         "prints")
    ap.add_argument("--dense-slots", action="store_true",
                    help="use monolithic per-slot rings instead of paged "
                         "KV blocks (continuous mode)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable cross-request prefix sharing (paged "
                         "continuous engines content-hash admitted prompts "
                         "against resident blocks by default and skip "
                         "prefill for matched full blocks)")
    ap.add_argument("--paged-attn", default=None, choices=("fused", "gather"),
                    help="paged decode attention: 'fused' (default) runs the "
                         "CUDA kernel over block-major KV; 'gather' keeps "
                         "the reference path")
    ap.add_argument("--sync-engine", action="store_true",
                    help="lockstep drain: read every step's tokens back "
                         "before dispatching the next (continuous mode; "
                         "default is the pipelined drain that overlaps "
                         "token transfer with decode)")
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


def restore_params(model, ckpt_dir: str, device: DeviceLike) -> tuple:
    """(step, params): the ``params`` subtree of the newest valid
    checkpoint in ``ckpt_dir`` on ``device``, held to ``model``'s param
    paths and shapes (a checkpoint of another configuration raises)."""
    from repro_torch.checkpoint import CheckpointManager
    step, tree, _ = CheckpointManager(ckpt_dir).restore(
        device=resolve_device(device), only="params")
    params = tree.get("params", {})
    flat = flatten_paths(params)
    specs = model.param_specs()
    wrong = sorted(set(specs) ^ set(flat)) + sorted(
        p for p in set(specs) & set(flat)
        if tuple(flat[p].shape) != tuple(specs[p].shape))
    if wrong:
        raise ValueError(f"checkpoint step {step} in {ckpt_dir} does not "
                         f"hold {model.cfg.name}'s params: {wrong[:8]}")
    return step, params


def make_requests(vocab_size: int, n: int, prompt_len: int, new_tokens: int,
                  arrival_every: int, seed: int = 1) -> list:
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    tokens=rng.integers(0, vocab_size,
                                        prompt_len).astype(np.int32),
                    max_new_tokens=new_tokens, arrival=i * arrival_every)
            for i in range(n)]


def _serving_op_names(model) -> Optional[set]:
    """The op names a serving step runs, or None for an encoder-decoder,
    whose serving keeps its own op namespace (as in the reference)."""
    from repro_torch.models.encdec import EncDec
    if isinstance(model, EncDec):
        return None
    return model.serving_op_names()


def _unknown_ops(model, artifact) -> set:
    """The ops of a plan or bundle that this model's serving lacks."""
    known = _serving_op_names(model)
    return set() if known is None else artifact.unknown_ops(known)


def load_plan(path: str, model) -> MPPlan:
    plan = MPPlan.load(path)
    print(f"[serve] MP plan: {plan.n_quantized} ops quantized "
          f"(objective {plan.objective}, tau {plan.tau})")
    unknown = _unknown_ops(model, plan)
    if unknown:
        print(f"[serve] WARNING: {len(unknown)} plan ops not in this model "
              f"(e.g. {sorted(unknown)[:3]}) — they will NOT apply; was the "
              f"plan solved for a different arch?")
    return plan


def check_bundle_ops(model, bundle: CalibrationBundle, src: str) -> None:
    """Refuse a bundle calibrated on another model's op namespace."""
    unknown = _unknown_ops(model, bundle)
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
    if c["paged"]:
        print(f"[serve] paged KV: block_size {c['block_size']} | "
              f"{c['peak_blocks_in_use']}/{c['n_blocks'] - 1} blocks at peak"
              f" | peak KV {c['peak_kv_bytes'] / 1e6:.2f} MB vs dense "
              f"{c['dense_kv_bytes'] / 1e6:.2f} MB | "
              f"{c['blocked_admissions']} blocked admissions")
        print(f"[serve] decode attention ({c['paged_attn']}): "
              f"{c['kernel_launches']} kernel launches over {out.n_steps} "
              f"steps | {c['prefill_chunks']} prefill steps")
    else:
        print(f"[serve] dense KV slots: {c['dense_kv_bytes'] / 1e6:.2f} MB")
    kinds = ", ".join(f"{k} {n}/{c['graph_replays_by_kind'].get(k, 0)}"
                      for k, n in sorted(c["graph_captures_by_kind"].items()))
    print(f"[serve] steps: {c['graph_captures']} CUDA graph captures, "
          f"{c['graph_replays']} replays (captures/replays by kind: "
          f"{kinds or 'none'})")
    print(f"[serve] drain: {'lockstep' if c['sync'] else 'pipelined'} | "
          f"{c['wall_tokens_per_s']:.1f} wall tok/s | host blocked "
          f"{c['host_blocked_s_per_step'] * 1e3:.3f} ms/step | "
          f"{c['n_readbacks']} read-backs (mean batch "
          f"{c['readback_batch_mean']:.2f}, max "
          f"{c['readback_batch_max']}) | peak {c['steps_in_flight_peak']} "
          f"steps in flight | drain wait {c['drain_wait_s'] * 1e3:.2f} ms")
    print(f"[serve] requests: {c['n_cancelled']} cancelled or timed out | "
          f"{c['n_failed']} failed | {c['n_retried']} retried")
    if "adaptive" in c:
        a = c["adaptive"]
        print(f"[serve] adaptive MP: {a['downshifts']} downshifts / "
              f"{a['restores']} restores over taus {a['taus']} | "
              f"final tau {a['final_tau']:g} (level {a['final_level']}) "
              f"| swaps at steps "
              f"{[s['step'] for s in a['swaps']] or 'none'}")
    f = c["faults"]
    if f["seen"] or f["injected"]:
        inj_desc = ", ".join(f"{k}x{v}" for k, v in
                             sorted(f["injected"].items())) or "none"
        print(f"[serve] faults: injected {inj_desc} | "
              f"{f['contained']} contained / {f['retries']} retries / "
              f"{f['failed']} failed | "
              f"{f['quarantined_blocks']} blocks quarantined | "
              f"kernel faults {f['kernel_faults']}"
              + (" | degraded fused->gather"
                 if f["degraded_paged_attn"] else ""))
    g = c.get("guardrail")
    if g:
        print(f"[serve] guardrail: {g['checks']} shadow checks | "
              f"{g['breaches']} breaches | last MSE "
              f"{g['last_mse'] if g['last_mse'] is not None else 'n/a'}"
              + (f" | restored base plan at step {g['restored_at']}"
                 if g["restored_at"] is not None else ""))
    statuses = [r.status for r in out.results.values()]
    n_failed, n_retried = statuses.count("failed"), statuses.count("retried")
    if n_failed or n_retried:
        print(f"[serve] degraded results: {n_retried} retried "
              f"(bit-identical after re-prefill) | {n_failed} failed "
              f"(partial tokens returned)")
    print(f"[serve] prefill: {c['prefill_chunks']} chunk steps | "
          f"{c['prefill_buckets']} buckets for {c['distinct_prompt_lens']} "
          f"prompt lengths | {c['decode_stall_steps']} decode-stall chunk "
          f"steps (longest run {c['max_decode_stall_run']})")
    if c.get("prefix_cache"):
        print(f"[serve] prefix cache: {c['prefix_hit_requests']} hit "
              f"requests | {c['prefix_hit_tokens']} prompt tokens "
              f"skipped | {c['cow_forks']} COW forks | "
              f"{c['preemptions']} preemptions")


def profile_drain(eng, params, reqs, trace_path: Optional[str],
                  unprofiled_wall_s: float, top: int = 12,
                  sync: bool = False) -> dict:
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
        out = eng.serve(params, reqs, sync=sync)
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
    if args.mesh is not None and not args.continuous:
        raise SystemExit("--mesh shards the continuous engine; pass "
                         "--continuous")
    device = resolve_device(args.device)
    mesh = None
    if args.mesh is not None:
        from repro_torch.launch.mesh import mesh_from_spec
        # before the weights: it picks this rank's card
        mesh = mesh_from_spec(args.mesh, device)
    if mesh is not None:
        import torch.distributed as dist
        from repro_torch.launch.steps import release_mesh_steps
        model = None
        try:
            quiet = (contextlib.redirect_stdout(io.StringIO())
                     if dist.get_rank() != 0 else contextlib.nullcontext())
            with quiet:
                model = _serve(args, device, mesh)
        finally:
            if model is not None:     # its graphs hold the group's
                release_mesh_steps(model)     # collectives
            dist.destroy_process_group()
    else:
        _serve(args, device, None)


def _serve(args, device, mesh):
    """Serve as ``main`` says; returns the model."""
    if args.dense_prefix and args.n_layers is not None:
        raise SystemExit("--dense-prefix and --n-layers are exclusive")
    ov = dense_prefix_overrides(args.arch, args.smoke) \
        if args.dense_prefix else {}
    if args.n_layers is not None:
        ov = depth_overrides(args.arch, args.n_layers, args.smoke)
    if args.mla_absorb_decode:
        ov["mla_absorb_decode"] = True
    if args.flash_min_seq is not None:
        ov["flash_min_seq"] = args.flash_min_seq
    if args.ckpt_dir:
        model = get_model(args.arch, smoke=args.smoke, **ov)
        step, params = restore_params(model, args.ckpt_dir, device)
        print(f"[serve] {model.cfg.name} on {device}: params of step {step} "
              f"restored from {args.ckpt_dir} "
              f"({model.n_params() / 1e6:.1f}M)")
    else:
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
    if args.adaptive_tau is not None:
        if not (args.calibration or args.registry):
            raise SystemExit("--adaptive-tau re-solves under load and needs "
                             "--calibration or --registry")
        if not args.continuous:
            raise SystemExit("--adaptive-tau drives the continuous engine; "
                             "pass --continuous")
    if (args.inject_faults or args.guardrail_every) and not args.continuous:
        raise SystemExit("--inject-faults/--guardrail-every drive the "
                         "continuous engine; pass --continuous")
    plan = bundle = controller = None
    if args.calibration:
        bundle, src = CalibrationBundle.load(args.calibration), \
            args.calibration
    elif args.registry:
        bundle, src = registry_bundle(model, params, args.registry)
    if bundle is not None:
        check_bundle_ops(model, bundle, src)
        if args.adaptive_tau is not None:
            from repro_torch.serve import AdaptiveMPController
            controller = AdaptiveMPController.from_bundle(
                bundle, args.adaptive_tau, n_levels=args.adaptive_levels,
                factor=args.adaptive_factor,
                objective=args.objective or "ET",
                every=args.adaptive_every, dwell=args.adaptive_dwell,
                queue_high=args.adaptive_queue_high,
                queue_low=args.adaptive_queue_low)
            base = controller.plan
            print(f"[serve] adaptive MP: tau ladder "
                  f"{[f'{t:g}' for t in controller.taus]} (base plan "
                  f"quantizes {base.n_quantized} ops, "
                  f"tier {base.meta.get('gain_tier')})")
        else:
            plan = solve_from_bundle(bundle, args.tau, args.objective, src)
    elif args.mp_plan:
        plan = load_plan(args.mp_plan, model)
    if args.continuous:
        max_len = args.prompt_len + args.new_tokens
        n_blocks = args.n_blocks
        if n_blocks == "auto":
            from repro_torch.serve import PagedCachePool
            if args.dense_slots:
                raise SystemExit("--n-blocks auto sizes the paged pool; "
                                 "drop --dense-slots")
            profile = [(args.prompt_len, args.new_tokens)] * args.requests
            n_blocks = PagedCachePool.size_n_blocks(
                profile, args.n_slots, args.block_size)
            worst, _, _ = PagedCachePool.plan_blocks(args.n_slots, max_len,
                                                     args.block_size)
            print(f"[serve] auto-sized paged pool: {n_blocks} blocks "
                  f"(worst case {worst}) from {args.requests}-request "
                  f"profile at p95 live demand x1.25 headroom")
        elif n_blocks is not None:
            n_blocks = int(n_blocks)
            if args.dense_slots:
                raise SystemExit("--n-blocks sizes the paged pool; drop "
                                 "--dense-slots")
        injector = guardrail = None
        if args.inject_faults:
            from repro_torch.serve import FaultInjector
            injector = FaultInjector.parse(args.inject_faults)
            print(f"[serve] fault injection: {len(injector.specs)} scheduled "
                  f"({args.inject_faults})")
        if args.guardrail_every:
            from repro_torch.serve import NumericalGuardrail
            guardrail = NumericalGuardrail(every=args.guardrail_every,
                                           margin=args.guardrail_margin)
            print(f"[serve] guardrail: shadow step every "
                  f"{args.guardrail_every} decode steps, breach at "
                  f"{args.guardrail_margin:g}x the plan's loss-MSE budget")
        eng = ContinuousBatchingEngine(
            model, n_slots=args.n_slots, max_len=max_len, mp=plan,
            paged=not args.dense_slots, block_size=args.block_size,
            n_blocks=n_blocks, chunk_len=args.chunk_len,
            chunk_budget=args.chunk_budget,
            prefix_cache=False if args.no_prefix_cache else None,
            paged_attn=args.paged_attn, adaptive=controller,
            faults=injector, max_retries=args.max_retries,
            guardrail=guardrail, device=device, mesh=mesh)
        reqs = make_requests(model.cfg.vocab_size, args.requests,
                             args.prompt_len, args.new_tokens,
                             args.arrival_every)
        sync = args.sync_engine
        # the warm-up must not take the fault schedule or the guardrail's
        # one restore
        eng.faults, eng.guardrail = None, None
        eng.serve(params, reqs[:1], sync=sync)       # warm-up
        eng.faults, eng.guardrail = injector, guardrail
        out = eng.serve(params, reqs, sync=sync)
        report_continuous(out, args.requests, args.n_slots)
        if mesh is not None:
            m = out.counters["mesh"]
            print(f"[serve] mesh: data {m['data']} x model {m['model']} "
                  f"({'pages sharded' if m['shard_pages'] else 'pages whole'}"
                  f") | weights per rank {eng.rank_param_bytes / 1e6:.2f} MB"
                  f" | paged kernel launches on the shard "
                  f"{out.counters['mesh_kernel_launches']}")
        if args.profile:
            profile_drain(eng, params, reqs, args.profile, out.total_s,
                          sync=sync)
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
    return model


if __name__ == "__main__":
    main()
