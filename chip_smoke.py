#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out chiprun_out/chip_smoke.json]

Phases, each of which raises (and so exits non-zero) when it fails:

1. print the card's name and power limit, build every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel)
   and log the paged kernels' registers, shared memory and spills as
   ``nvcc -Xptxas -v`` reported them (phases 3 and 10 log the others);
2. hold the GQA form's tensor-core kernel (``csrc/paged_decode_gqa.cu``)
   against its plain PyTorch version at the serving shape (B=4, Hkv=8, G=4,
   D=64, block 16, up to 160 keys), at D=128 and at G 5 and 7: bf16 and
   scaled fp8-e4m3 KV, window None and 7, a vacant row (all -1 table,
   length 0), NaN in blocks no live page references and in the stale slots
   of live pages (past the length, below the window), two calls bit-equal;
   then time it, the CUDA-core kernel that served the form before, the
   plain version and ``scaled_dot_product_attention`` over gathered K/V at
   the serving shape, at D=128 and at a long table (2048 keys a row);
3. hold the fp8 kernels against their plain versions at the model's
   shapes: ``amax`` and ``scale_cast`` bitwise on the activations (2048,
   2048) and the weights (8192, 2048), (2048, 8192), (128256, 2048), plus
   NaN, inf and values straddling the e4m3/e5m2 overflow midpoints;
   ``fp8_matmul`` and ``fp8_linear`` within 2^-6 of the largest output at
   the q/gate/down/lm_head shapes and at M=300; log the kernels'
   registers, shared memory and spills; then time each kernel,
   its plain version, the PyTorch call that computes the same function
   (``torch.linalg.vector_norm(x, inf)``, ``torch._scaled_mm``), the
   bf16 ``torch.matmul`` of the same product, and ``fp8_linear`` with its
   weight quantized once (the weight cache) and per call;
4. serve Llama-3.2-1B at full width (random weights from a seeded
   generator) through the launcher's code path — 8 requests, 4 slots,
   128-token prompts, 32 new tokens, one arrival every 2 steps — on the
   continuous engine with fused and with gather decode attention, and on
   the one-shot engine. The decode step is a CUDA graph, captured in each
   engine's warm-up drain and only replayed in the timed drain (captures
   and replays are checked and printed); every graphed drain is held bit
   for bit, on every live row, against the same drain with the decode
   step run eagerly. Check launch counts (every fused launch through the
   GQA kernel, route ``gqa_mma``), that the logits behind every token
   agree up to each request's first divergence, and that a divergence sits
   only at a near-tie of the reference's logits (the logits are read off
   the engines' step closures, which this script wraps; the engines
   compute no diagnostics);
5. the same checks under a fixed MP plan (fp8 on every linear op of layers
   8-15, plus the attention BGEMMs of layer 15, which then takes the
   gather path): the continuous gather drain against the one-shot engine,
   the fused drain against the gather drain, each graphed drain against
   its eager twin;
6. Algorithm 1 at full width and depth: ``calibrate`` over 4 synthetic
   batches of (2, 256) tokens (sensitivities from probe gradients,
   partition, roofline/theoretical/memory tables for the H100), with its
   seconds and peak device memory; save the bundle as npz, reload it, and
   check the reloaded bundle solves to the identical plan;
7. the measured tier at ``WallClockGainModel``'s own repeats (2 warm-up, 5
   timed runs a combo): ``tabulate_measured_gains`` times a full forward
   of a (4, 512) prompt under ``impl="kernel"`` for every combo of every
   group; the fp8 kernels' launch counters must rise by 1 amax + 1
   scale_cast + 1 fp8_matmul per fp8 linear op per run (the activation),
   plus 1 amax + 1 scale_cast once for each weight set to fp8 (the weight
   cache); prints how many groups gain beyond the base forward's spread;
8. solve the measured ET plan (and TT, M), serve it through
   ``python -m repro_torch.launch.serve --calibration`` at phase 4's cell,
   and in process hold the MP continuous (gather) drain against the MP
   one-shot engine under the ET and TT plans;
9. paper Fig. 3a: the loss under each plan with ``impl="kernel"`` and with
   ``impl="simulate"``, and the measured loss MSE against the plan's
   predicted one;
10. kernel 4, ``mp_flash_attention``: its entry point
    ``flash_attention_mp`` once in bf16 and once with ``fmt_name=
    "fp8_e4m3"`` at the llama3_1b width (B=1, H=32, T=S=4096, D=64; the
    launch counters set to 0 just before and read just after: no model
    path calls it), then the kernel against its plain version there, at
    DeepSeek-V3's width (H=128, D=192, Dv=128) and at a small T != S case
    (bf16 both masks; fp8 with e4m3 probabilities at key blocks of 256 and
    96; f32 operands, which take the CUDA-core kernel), its registers and
    spills logged, and timed beside
    ``scaled_dot_product_attention(is_causal=True)``;
11. the MLA form's tensor-core kernel (``csrc/paged_decode_mla.cu``, route
    ``mla_mma``; B=4, 128 heads on one latent head, latents 512 + 64, block
    16) against its plain version: page boundaries, mid-page, a vacant row,
    16 keys, windows, two calls bit-equal, NaN in dead blocks and in stale
    slots of live pages; the CUDA-core kernel (route forced) at the same
    cases; then both kernels, the plain version and SDPA over the gathered
    latents timed at the serving cell, 16 keys and 2048 keys a row, with
    the exact route's bound and the f32 one;
12. a long prompt: llama3_1b at its flash threshold (4096) with one
    8192-token prompt through the one-shot engine (blocked flash
    attention) against the same prompt at a threshold of 2^30 (reference
    attention): prefill logits, first tokens and TTFT;
13. Llama-3.1-8B at its published widths (32 layers, d_head 128, untied
    head; 8.03 B random parameters, 16 GB): phases 4 and 5 at phase 4's
    cell (every fused launch through ``gqa_mma`` at D 128; the fixed plan
    puts fp8 on the linear ops of layers 16-31 and the BGEMMs of layer
    31), then ``calibrate`` over phase 6's batches at the largest depth
    whose probes and backward fit in 85% of the card (the depth is printed
    on a line of its own), with its seconds and peak memory;
14. DeepSeek-V3's dense prefix at full width (three MLA layers, random
    weights): phase 4's cell through the absorbed decode, fused and gather
    (each graphed drain against its eager twin), the one-shot engine and
    the expanded decode, then under a fixed MP plan (fused, gather,
    one-shot); the MLA kernel's launches (all through route ``mla_mma``)
    equal decode steps x fused layers; then a 4096-token prompt as in
    phase 12;
15. print the kernel table and the serving and calibration numbers as JSON
    lines, then ``{"ok": true, "device": {...}}`` as the last line. Every
    phase's seconds are printed.

Exits non-zero without a result when no CUDA device is visible or the
package is not beside this script.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
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
# DeepSeek's dense prefix under its MP plan: 16 fp8 linear ops at widths of
# 1536 to 18432 in 2 of its 3 layers, with f32 latent attention whose cuBLAS
# sums differ in order between the one-shot and continuous batch shapes;
# measured 0.2402 (gather vs one-shot) and 0.2852 (fused vs gather) on an
# H100 against the llama bounds above, so 16 bf16 ulps at |logit| in [4, 8)
LOGIT_TOL_MLA_MP = 0.5
MARGIN_BOUND_MLA_MP = 0.5
HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                  # dense tensor-core bf16 peak
FP8_FLOPS = 1979e12                  # dense tensor-core fp8 peak
F32_FLOPS = 67e12                    # float32 outside the tensor cores
# fp8 GEMM vs its plain version: products of two fp8 values are exact in
# f32, sums run in another order, one rounding to bf16 — two bf16 ulps of
# the largest output
MM_TOL = 2.0 ** -6
# Algorithm 1 at full width: calibration batches, the measured tier's prompt
# and the loss-MSE threshold of the served plan
CAL_BATCHES, CAL_SHAPE = 4, (2, 256)
TIER_PROMPT = (4, 512)
TAU = 0.05
DEVICE = "cuda"
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


@contextlib.contextmanager
def forced_route(pa, rt: str):
    """Every paged call inside takes route ``rt`` (``pa``: the module
    ``repro_torch.kernels.paged_attention``)."""
    chosen = pa.route
    pa.route = lambda *a, **k_: rt
    try:
        yield
    finally:
        pa.route = chosen


# ---------------------------------------------------------------------------
# phase 2: kernel against its plain version
# ---------------------------------------------------------------------------


def paged_case(torch, seed: int, kv_dtype, poison_value: float,
               lengths=(MAX_LEN, 100, BS, 0), d: int = D, g: int = G):
    """Block tables with every hazard the pool produces: rows of several
    lengths (a page boundary, mid-page, one page), a vacant row (all -1,
    length 0) and dead entries pointing at poisoned blocks. One decode row
    per entry of ``lengths``."""
    from repro_torch.quant.formats import cast_to
    rng = np.random.default_rng(seed)
    n_pages = -(-max(max(lengths), MAX_LEN) // BS)
    rows = len(lengths)
    n_live = rows * n_pages
    n_blocks = 1 + n_live + 4
    poison = np.arange(1 + n_live, n_blocks)
    perm = rng.permutation(np.arange(1, 1 + n_live))
    lengths = np.asarray(lengths, np.int32)
    tables = np.full((rows, n_pages), -1, np.int32)
    c = 0
    for b in range(rows):
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

    k = fill((n_blocks, BS, HKV, d))
    v = fill((n_blocks, BS, HKV, d))
    q = torch.from_numpy(rng.normal(size=(rows, HKV, g, d)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    return (q, k, v, torch.from_numpy(tables).cuda(),
            torch.from_numpy(lengths).cuda())


def poison_stale(torch, k, v, tables, lengths, window) -> int:
    """NaN (byte 0xFF: NaN in bf16 and in e4m3fn) in every slot of a live
    page that holds no live key — past the row's length and below its
    window — in place; returns the number of slots poisoned."""
    blocks, offs = [], []
    for b, L in enumerate(lengths.tolist()):
        lo = 0 if window is None else max(0, L - window)
        for pos in range(-(-L // BS) * BS):
            if pos >= L or pos < lo:
                blocks.append(int(tables[b, pos // BS]))
                offs.append(pos % BS)
    if blocks:
        for t in (k, v):
            t.view(torch.uint8)[blocks, offs] = 0xFF
    return len(blocks)


# phase 2's shapes for the GQA kernel beside the serving one: llama3_8b's
# d_head and the group sizes of the repo's GQA configs that do not divide 8
GQA_CHECKS = {"serving": dict(d=D, g=G), "d128": dict(d=128, g=G),
              "g5": dict(d=D, g=5), "g7": dict(d=D, g=7)}
# the shapes the kernel is timed at: the serving cell's mid-drain decode
# step, the same at llama3_8b's d_head, and a long table (2048 keys a row)
GQA_TIMES = {"serving": dict(d=D, lengths=(160, 152, 144, 136)),
             "d128": dict(d=128, lengths=(160, 152, 144, 136)),
             "long": dict(d=D, lengths=(2048,) * 4)}


def kernel_phase(torch) -> dict:
    """The GQA kernel against its plain version at each ``GQA_CHECKS``
    shape and hazard: bf16 and scaled fp8 K/V, window None and 7, a vacant
    row, NaN in blocks no live page references, NaN in the stale slots of
    live pages (past the length, below the window); repeated calls must be
    bit-equal."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_decode_attention_ref
    max_err, cases, bitwise = 0.0, 0, 0
    for shape, dims in GQA_CHECKS.items():
        common = dict(scale=math.sqrt(dims["d"]), scale_mode="div",
                      score_dtype=torch.bfloat16, probs_dtype=torch.bfloat16,
                      out_dtype=torch.bfloat16)
        for kv_name, kv_dtype, ks, vs in (("bf16", torch.bfloat16, 1.0, 1.0),
                                          ("fp8_e4m3", torch.float8_e4m3fn,
                                           0.5, 2.0)):
            for window in (None, 7):
                name = f"{shape} kv {kv_name} window {window}"
                # finite poison, so the plain version (which multiplies zero
                # probabilities into every gathered block) stays finite
                args = paged_case(torch, 0, kv_dtype, 224.0, **dims)
                kw = dict(common, window=window, k_scale=ks, v_scale=vs)
                n0 = dict(pa.launches_by_route)
                got = pa.paged_decode_attention(*args, **kw)
                want = paged_decode_attention_ref(*args, **kw)
                again = pa.paged_decode_attention(*args, **kw)
                torch.cuda.synchronize()
                if pa.launches_by_route["gqa_mma"] != n0["gqa_mma"] + 2:
                    raise AssertionError(f"{name}: not launched through "
                                         f"gqa_mma")
                err = (got.float() - want.float()).abs().max().item()
                max_err = max(max_err, err)
                cases += 1
                bitwise += int(torch.equal(got, want))
                log(f"GQA kernel vs plain: {name}: max abs err {err:.3e} "
                    f"(tol {KERNEL_TOL:g}), bitwise "
                    f"{bool(torch.equal(got, want))}")
                if not torch.allclose(got.float(), want.float(),
                                      rtol=KERNEL_TOL, atol=KERNEL_TOL):
                    raise AssertionError(f"kernel disagrees with its plain "
                                         f"version: {name}")
                if not torch.equal(again, got):
                    raise AssertionError(f"{name}: two calls differ")
                if got[3].abs().max().item() != 0.0:
                    raise AssertionError("vacant row (length 0) is not zero")
                # NaN in blocks only dead entries reference, then also in
                # the stale slots of live pages, must never be read
                q, k, v, bt, ln = paged_case(torch, 0, kv_dtype,
                                             float("nan"), **dims)
                got_nan = pa.paged_decode_attention(q, k, v, bt, ln, **kw)
                n_stale = poison_stale(torch, k, v, bt.cpu(), ln.cpu(),
                                       window)
                got_stale = pa.paged_decode_attention(q, k, v, bt, ln, **kw)
                torch.cuda.synchronize()
                for what, t in (("a block no live page references", got_nan),
                                (f"{n_stale} stale slots of live pages",
                                 got_stale)):
                    if not torch.isfinite(t.float()).all():
                        raise AssertionError(f"{name}: NaN in {what} "
                                             f"reached the output")
                    if not torch.equal(t, got):
                        raise AssertionError(f"{name}: NaN in {what} changed "
                                             f"the output")
    log(f"GQA kernel vs plain: {cases} cases within tolerance, max abs err "
        f"{max_err:.3e}, bitwise equal in {bitwise} of {cases}")
    return {"max_abs_err": max_err, "gqa_cases": cases,
            "gqa_bitwise_cases": bitwise}


def time_kernel(torch) -> dict:
    """At each ``GQA_TIMES`` shape: the GQA kernel (CUDA graph, L2-warm, and
    with inputs rotated past L2), the CUDA-core kernel that served the form
    before (route forced, as the baseline), the plain version and the SDPA
    yardstick, with the bound from the shape's inputs. The serving shape's
    numbers are also returned at the top level."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_decode_attention_ref, paged_deq
    import torch.nn.functional as F
    out = {}
    n0, n0_route = pa.launches, dict(pa.launches_by_route)
    for shape, dims in GQA_TIMES.items():
        d, lengths = dims["d"], dims["lengths"]
        q, k, v, bt, ln = paged_case(torch, 1, torch.bfloat16, 0.0, lengths,
                                     d=d)
        kw = dict(scale=math.sqrt(d), scale_mode="div",
                  score_dtype=torch.bfloat16, probs_dtype=torch.bfloat16,
                  out_dtype=torch.bfloat16)

        def kernel(*a):
            return pa.paged_decode_attention(*(a or (q, k, v, bt, ln)), **kw)

        def plain():
            return paged_decode_attention_ref(q, k, v, bt, ln, **kw)

        rec = {"ms": device_ms(torch, kernel),
               "ms_cold": timed(torch, kernel, q, k, v, bt, ln),
               "ms_eager": eager_ms(torch, kernel, 500)}
        t0 = time.perf_counter()
        for _ in range(200):
            kernel()
        rec["host_enqueue_ms"] = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
        with forced_route(pa, "cuda_core"):
            rec["cuda_core_ms"] = device_ms(torch, kernel)
        rec["plain_ms"] = device_ms(torch, plain)
        rec["plain_ms_eager"] = eager_ms(torch, plain, 50)
        # SDPA over K/V gathered beforehand (not timed): (B, H, S, D)
        kg = paged_deq(k, bt, torch.bfloat16, 1.0).permute(0, 2, 1, 3)
        vg = paged_deq(v, bt, torch.bfloat16, 1.0).permute(0, 2, 1, 3)
        kg = kg.repeat_interleave(G, dim=1).contiguous()
        vg = vg.repeat_interleave(G, dim=1).contiguous()
        qs = q.reshape(B, HKV * G, 1, d)
        S = kg.shape[2]
        mask = (torch.arange(S, device="cuda")[None, :]
                < ln[:, None]).reshape(B, 1, 1, S)

        def library():
            return F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask)

        rec["library_ms"] = device_ms(torch, library)
        rec["library_ms_eager"] = eager_ms(torch, library, 500)
        live = sum(lengths)
        nbytes = (q.numel() * 2 + live * HKV * 2 * d * 2 + bt.numel() * 4
                  + ln.numel() * 4 + B * HKV * G * d * 2)
        ops = 2 * live * HKV * G * 2 * d
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
        rec.update(bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bound_bytes=nbytes, bound_ops=ops, d=d,
                   lengths=list(lengths),
                   head_group=pa.head_group(G, d, 0, bt.shape[1], BS,
                                            rows=B * HKV,
                                            sms=pa._sm_count(q.device),
                                            route="gqa_mma"))
        log(f"paged_decode_attention GQA {shape} (D {d}, keys {lengths}, "
            f"head group {rec['head_group']}): kernel {rec['ms'] * 1e3:.2f} "
            f"us (inputs past L2 {rec['ms_cold'] * 1e3:.2f}) | CUDA-core "
            f"kernel {rec['cuda_core_ms'] * 1e3:.2f} us | plain "
            f"{rec['plain_ms'] * 1e3:.2f} us | SDPA "
            f"{rec['library_ms'] * 1e3:.2f} us | bound "
            f"{rec['bound_ms'] * 1e3:.3f} us ({rec['bound_by']})")
        out[shape] = rec
    pa.launches = n0                  # timing launches are not path launches
    pa.launches_by_route.update(n0_route)
    res = dict(out["serving"])
    res["gqa_times"] = out
    return res


# ---------------------------------------------------------------------------
# phase 3: the fp8 kernels against their plain versions
# ---------------------------------------------------------------------------

# (tokens, d_model) activations and the linear weights of llama3_1b
ACT = (2048, 2048)
WEIGHTS = {"q_proj": (2048, 2048), "gate_proj": (8192, 2048),
           "down_proj": (2048, 8192), "lm_head": (128256, 2048)}


def hazard_values(torch):
    """Values straddling e4m3fn's 448/464/480 and e5m2's 57344/61440,
    +-inf, +-NaN, +-0 and subnormal magnitudes."""
    return torch.tensor([0.0, -0.0, 1e-9, -3e-6, 447.9, 448.0, 455.0, 463.9,
                         464.0, 464.1, 479.9, 480.0, -470.0, 57000.0, 61439.0,
                         61440.0, -61440.0, 70000.0, float("inf"),
                         -float("inf"), float("nan"), -float("nan"), 3.4e38,
                         -1.0], device=DEVICE)


def randn(torch, shape, seed: int, scale: float, dtype):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=DEVICE) * scale).to(dtype)


def same_bits(torch, got, want) -> bool:
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    view = torch.int32 if got.element_size() == 4 else torch.uint8
    return bool(torch.equal(got.view(view), want.view(view)))


L2_BYTES = 50e6                      # H100 L2 cache


def timed(torch, fn, *args, warm: bool = False) -> float:
    """Device ms per call of ``fn(*args)`` from a CUDA graph
    (``device_ms``). The graph's calls take turns over copies of ``args``
    whose bytes together exceed twice the L2 cache, so each call reads its
    inputs from device memory as a forward pass finds its weights, unless
    ``warm``, which times one set of inputs resident in L2. The number of
    captured calls and replays comes from one eager call, so a measurement
    takes about 0.2 s whatever the call's size. Each copy is called once
    before the graph is captured."""
    nbytes = sum(a.numel() * a.element_size() for a in args)
    n = 1 if warm else int(min(16, max(1, math.ceil(2 * L2_BYTES /
                                                     max(nbytes, 1)))))
    copies = [args] + [tuple(a.clone() for a in args) for _ in range(n - 1)]
    for c in copies:            # every copy's first call (a weight operand
        fn(*c)                  # kept by the weight cache is made here)
    turn = [0]

    def call():
        fn(*copies[turn[0] % n])
        turn[0] += 1

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    t = max(time.perf_counter() - t0, 1e-6)
    calls = n * max(1, int(min(20, max(1, 0.01 / t))) // n)
    replays = int(min(25, max(2, 0.2 / (calls * t))))
    return device_ms(torch, call, calls=calls, replays=replays)


def ptxas_report(name: str) -> list:
    """Each kernel of ``csrc/<name>.cu`` as ``nvcc -Xptxas -v`` reported it
    at this run's build: registers, static shared memory and spill bytes."""
    import re
    from repro_torch.kernels import _build
    out, cur = [], None
    for line in _build.build_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1), "registers": None, "smem_bytes": None,
                   "spill_stores": None, "spill_loads": None}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    for r in out:
        # a short label from the mangled name (identifiers are prefixed by
        # their length): the one ending in "kernel", then its int arguments
        k, label = r["kernel"], r["kernel"]
        for m in re.finditer(r"\d+", k):
            # a hash before the prefix may end in digits: try each suffix
            for j in range(len(m.group())):
                ident = k[m.end():m.end() + int(m.group()[j:])]
                if ident.endswith("kernel"):
                    rest = k[m.end() + len(ident):]
                    label = ident + "<" + ",".join(
                        re.findall(r"Li(\d+)E", rest)
                        + (["fp8"] if "fp8" in rest else
                           ["bf16"] if "bfloat16" in rest else [])) + ">"
        log(f"ptxas {name}: {label}: {r['registers']} registers, "
            f"{r['smem_bytes']} bytes static smem, spills "
            f"{r['spill_stores']}/{r['spill_loads']} bytes (stores/loads)")
    return out


def fp8_check_phase(torch) -> dict:
    """amax and scale_cast bitwise, fp8_matmul and fp8_linear within
    MM_TOL of the largest output, at the model's shapes."""
    from repro_torch.kernels import fp8_matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_cast as qc
    from repro_torch.kernels.ref import (amax_ref, fp8_matmul_ref,
                                         scale_cast_ref)
    fp8 = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
    failures, n_bitwise = [], 0
    shapes = {"act": ACT, **WEIGHTS}
    for i, (name, shape) in enumerate(shapes.items()):
        x = randn(torch, shape, 10 + i, 1.0 if name == "act" else 0.02,
                  torch.bfloat16)
        a = qc.amax(x)
        n_bitwise += 1
        if not same_bits(torch, a, amax_ref(x)):
            failures.append(f"amax {name} {shape}")
        scale = 448.0 / torch.clamp_min(a, 1e-12)
        for fmt, dt in fp8.items():
            n_bitwise += 1
            if not same_bits(torch, qc.scale_cast(x, scale, dt),
                             scale_cast_ref(x, scale, dt)):
                failures.append(f"scale_cast {fmt} {name} {shape}")
        del x
    haz = hazard_values(torch)
    for dtype in (torch.bfloat16, torch.float32):
        x = randn(torch, ACT, 20, 60.0, dtype)
        x.view(-1)[:4 * haz.numel()] = haz.repeat(4).to(dtype)
        finite = torch.where(torch.isnan(x), torch.zeros_like(x), x)
        nan_one = finite.clone()
        nan_one[ACT[0] // 2, 7] = float("nan")
        for label, t in (("hazards", finite), ("nan", nan_one)):
            n_bitwise += 1
            if not same_bits(torch, qc.amax(t), amax_ref(t)):
                failures.append(f"amax {label} {dtype}")
        for fmt, dt in fp8.items():
            for s in (1.0, 0.37, 4.0):
                st = torch.tensor(s, device=DEVICE)
                n_bitwise += 1
                if not same_bits(torch, qc.scale_cast(x, st, dt),
                                 scale_cast_ref(x, st, dt)):
                    failures.append(f"scale_cast {fmt} {dtype} scale {s}")
    torch.cuda.synchronize()
    log(f"amax / scale_cast vs plain: {n_bitwise - len(failures)} of "
        f"{n_bitwise} cases bitwise equal")

    mm_err, mm_rel, lin_rel = 0.0, 0.0, 0.0
    cases = [(name, ACT[0], shape) for name, shape in WEIGHTS.items()]
    cases.append(("m300", 300, WEIGHTS["q_proj"]))
    for j, (name, M, (N, K)) in enumerate(cases):
        x = randn(torch, (M, K), 30 + j, 1.0, torch.bfloat16)
        w = randn(torch, (N, K), 40 + j, 0.02, torch.bfloat16)
        xq, sx = qc.quantize_fp8(x)
        wq, sw = qc.quantize_fp8(w)
        want = fp8_matmul_ref(xq, wq, sx, sw)
        top = float(want.float().abs().max())
        err = float((mm.fp8_matmul(xq, wq, sx, sw).float()
                     - want.float()).abs().max())
        y = ops.fp8_linear(x, w)
        lin = float((y.float() - want.float()).abs().max())
        mm_err, mm_rel = max(mm_err, err), max(mm_rel, err / top)
        lin_rel = max(lin_rel, lin / top)
        log(f"fp8_matmul {name} ({M}x{N}x{K}): max abs err {err:.3e} "
            f"({err / top:.2e} of max|Y| {top:.3g}); fp8_linear "
            f"{lin / top:.2e}")
        if not (err <= MM_TOL * top and lin <= MM_TOL * top):
            failures.append(f"fp8_matmul/fp8_linear {name}")
        del x, w, xq, wq, want, y
    torch.cuda.synchronize()
    if failures:
        raise AssertionError("fp8 kernels disagree with their plain "
                             "versions: " + "; ".join(failures))
    log(f"fp8 kernels vs plain: all cases pass (bitwise; GEMM within "
        f"{MM_TOL:g} of max|Y|, worst {mm_rel:.2e}, promotion every 128 "
        f"products)")
    return {"fp8_bitwise_cases": n_bitwise, "fp8_matmul_max_abs_err": mm_err,
            "fp8_matmul_max_rel_err": mm_rel, "fp8_linear_max_rel_err":
            lin_rel, "fp8_ptxas": {n: ptxas_report(n) for n in (
                "quant_cast", "fp8_matmul")}}


def fp8_linear_per_call(x, w):
    """``ops.fp8_linear`` as it was before the weight cache: both operands
    quantized on every call (the before number of its time)."""
    from repro_torch.kernels import fp8_matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_cast as qc
    xq, sx = qc.quantize_fp8(ops._pad_to(x, 128))
    wq, sw = qc.quantize_fp8(ops._pad_to(w, 128))
    return mm.fp8_matmul(xq, wq, sx, sw)[:x.shape[0], :w.shape[0]]


def fp8_time_phase(torch) -> dict:
    """Device time per call of each fp8 kernel, its plain version and the
    PyTorch call computing the same function, at every model shape; the
    bound is the larger of the bytes each call must move at 3.35 TB/s and
    its operations at the fp8 peak (a max or a multiply per element counts
    as one operation, beside which bytes always bound)."""
    from repro_torch.kernels import fp8_matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_cast as qc
    from repro_torch.kernels.ref import (amax_ref, fp8_matmul_ref,
                                         scale_cast_ref)
    n0 = dict(qc.launches), mm.launches
    out = {"amax": {}, "scale_cast": {}, "fp8_matmul": {}, "fp8_linear": {}}

    def bound(nbytes, ops_):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops_ / FP8_FLOPS
        return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"

    for i, (name, shape) in enumerate({"act": ACT, **WEIGHTS}.items()):
        x = randn(torch, shape, 50 + i, 0.02, torch.bfloat16)
        n = x.numel()
        s = 448.0 / torch.clamp_min(qc.amax(x), 1e-12)
        b_ms, b_by = bound(2 * n + 4, n)
        out["amax"][name] = {
            "shape": list(shape), "ms": timed(torch, qc.amax, x),
            "ms_l2_warm": timed(torch, qc.amax, x, warm=True),
            "plain_ms": timed(torch, amax_ref, x),
            "library_ms": timed(torch, lambda t: torch.linalg.vector_norm(
                t, float("inf")), x),
            "bound_ms": b_ms, "bound_by": b_by}
        b_ms, b_by = bound(3 * n + 4, n)
        out["scale_cast"][name] = {
            "shape": list(shape), "ms": timed(torch, qc.scale_cast, x, s),
            "ms_l2_warm": timed(torch, qc.scale_cast, x, s, warm=True),
            "plain_ms": timed(torch, scale_cast_ref, x, s),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        del x
    for j, (name, (N, K)) in enumerate(WEIGHTS.items()):
        M = ACT[0]
        x = randn(torch, (M, K), 60 + j, 1.0, torch.bfloat16)
        w = randn(torch, (N, K), 70 + j, 0.02, torch.bfloat16)
        xq, sx = qc.quantize_fp8(x)
        wq, sw = qc.quantize_fp8(w)
        q = (xq, wq, sx, sw)
        b_ms, b_by = bound((M + N) * K + 2 * M * N + 8, 2 * M * N * K)
        rec = {"shape": [M, N, K], "ms": timed(torch, mm.fp8_matmul, *q),
               "plain_ms": timed(torch, fp8_matmul_ref, *q),
               "bound_ms": b_ms, "bound_by": b_by,
               "bf16_matmul_ms": timed(torch, lambda a, b: torch.matmul(
                   a, b.t()), x, w)}
        try:
            rec["library_ms"] = timed(torch, lambda a, b, c, d: (
                torch._scaled_mm(a, b.t(), scale_a=c, scale_b=d,
                                 out_dtype=torch.bfloat16)), *q)
        except RuntimeError as e:          # the yardstick only, never the port
            rec["library_ms"], rec["library_error"] = None, str(e)[:200]
        rec["tflops"] = 2 * M * N * K / (rec["ms"] * 1e-3) / 1e12
        out["fp8_matmul"][name] = rec
        out["fp8_linear"][name] = {
            "shape": [M, N, K], "ms": timed(torch, ops.fp8_linear, x, w),
            "per_call_ms": timed(torch, fp8_linear_per_call, x, w),
            "bf16_matmul_ms": rec["bf16_matmul_ms"]}
        del x, w, xq, wq, q
    qc.launches.update(n0[0])            # timing launches are not path ones
    mm.launches = n0[1]
    for kern in ("amax", "scale_cast", "fp8_matmul", "fp8_linear"):
        for name, r in out[kern].items():
            extra = "".join(
                f" | {label} {r[k] * 1e3:.2f} us" for k, label in (
                    ("per_call_ms", "weight quantized per call"),
                    ("ms_l2_warm", "L2-warm"), ("plain_ms", "plain"),
                    ("library_ms", "library"), ("bf16_matmul_ms",
                                                "bf16 matmul"),
                    ("bound_ms", "bound")) if r.get(k) is not None)
            log(f"{kern} {name} {tuple(r['shape'])}: {r['ms'] * 1e3:.2f} us"
                f"{extra}")
    return out


# ---------------------------------------------------------------------------
# phases 4 and 5: serving
# ---------------------------------------------------------------------------


def first_divergence(a: np.ndarray, b: np.ndarray) -> int:
    diff = np.nonzero(a != b)[0]
    return int(diff[0]) if diff.size else len(a)


def record_steps(eng, names) -> list:
    """Wrap the engine's step closures ``names`` (instance attributes; the
    engine itself computes no diagnostics) so every call appends ``(name,
    logits, *inputs)`` to the returned list. Prefill logits and inputs are
    new tensors each call and are kept by reference; a paged decode step's
    are copied on the device, since its inputs are the engine's buffers,
    refilled every step, and a CUDA graph's logits are overwritten by its
    next replay. No host sync, so the timed drain runs as it would
    unrecorded, plus four small copies a decode step."""
    events = []

    def wrap(name, step):
        def recorded(params, caches, *inputs):
            out = step(params, caches, *inputs)
            logits = out[0]
            if len(out) == 3:                  # the paged decode step
                logits = logits.clone()
                inputs = tuple(t.clone() for t in inputs)
            events.append((name, logits, *inputs))
            return out
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


def run_continuous(torch, model, params, reqs, *, mp=None, paged_attn,
                   route=None, eager=False):
    """Warm-up drain of one request (on the card it captures the decode
    step's CUDA graph), then the recorded drain of ``reqs``, which must
    only replay it. Returns (summary, launches in the recorded drain, rid
    -> (tokens, logits)). With ``route``, every launch of the drain must
    have gone through that kernel (``paged_attention.route``). ``eager``
    swaps in the closure the graph captures, run eagerly: the yardstick
    the graphed drain is held to, bit for bit."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.steps import make_paged_decode_step
    from repro_torch.serve import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(
        model, n_slots=SERVE["n_slots"],
        max_len=SERVE["prompt_len"] + SERVE["new_tokens"], mp=mp,
        block_size=SERVE["block_size"], paged_attn=paged_attn, device=DEVICE)
    if eager:
        eng.decode_step = make_paged_decode_step(model, mp=eng.mp,
                                                 paged_attn=paged_attn)
    warm = eng.serve(params, reqs[:1])
    events = record_steps(eng, ("prefill_chunk_step", "decode_step"))
    torch.cuda.synchronize()
    pa.launches = 0
    pa.launches_by_route.update(dict.fromkeys(pa.ROUTES, 0))
    torch.cuda.reset_peak_memory_stats()
    out = eng.serve(params, reqs)
    torch.cuda.synchronize()
    out.counters["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    launches = pa.launches
    label = f"{model.cfg.name} {paged_attn}{' MP' if mp else ''}" \
        f"{' eager' if eager else ''}"
    caps = (warm.counters["graph_captures"], out.counters["graph_captures"],
            out.counters["graph_replays"])
    want = (0, 0, 0) if eager or DEVICE == "cpu" else (1, 0, out.n_steps)
    if caps != want:
        raise AssertionError(f"{label}: graph captures (warm-up, drain) and "
                             f"replays {caps}, expected {want}")
    log(f"{label}: {out.n_steps} decode steps; CUDA graph captures "
        f"{caps[0]} in the warm-up drain, {caps[1]} in the drain, "
        f"{caps[2]} replays; {launches} paged kernel launches; peak device "
        f"memory {out.counters['peak_device_gb']:.2f} GB")
    if route is not None and pa.launches_by_route[route] != launches:
        raise AssertionError(f"{paged_attn}: launches by route "
                             f"{pa.launches_by_route}, expected all {launches}"
                             f" through {route}")
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


def graph_vs_eager(name: str, graphed: dict, eager: dict,
                   failures: list) -> dict:
    """The graphed drain against the same drain with the decode step run
    eagerly: every token and every logit bit-equal."""
    import torch
    err, n_diff = 0.0, 0
    for rid in sorted(eager):
        (a, la), (r, lr) = graphed[rid], eager[rid]
        same = np.array_equal(a, r) and la.shape == lr.shape
        if la.shape == lr.shape:
            err = max(err, (la.float() - lr.float()).abs().max().item())
        n_diff += not (same and torch.equal(la, lr))
    log(f"{name}: graphed vs eager drain: {len(eager) - n_diff} of "
        f"{len(eager)} requests bit-equal (max logit diff {err:.4g})")
    if n_diff:
        failures.append(f"{name}: graphed drain differs from the eager one "
                        f"in {n_diff} requests (max logit diff {err:.4g})")
    return {"bit_equal_requests": len(eager) - n_diff,
            "max_logit_diff": err}


def run_oneshot(model, params, reqs, mp=None):
    """The one-shot engine on the same prompts, one batch. Returns (result,
    rid -> (tokens, logits))."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(model, mp=mp, device=DEVICE)
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
            "graph_captures": out.counters["graph_captures"],
            "graph_replays": out.counters["graph_replays"],
            "peak_device_gb": out.counters["peak_device_gb"],
            "peak_blocks_in_use": out.counters["peak_blocks_in_use"]}


def serve_phase(torch, model, params) -> dict:
    """Phases 4 and 5 at full width on the card (phase 13 runs them on
    llama3_8b): every drain graphed, and held bit for bit against the same
    drain with the decode step run eagerly."""
    from repro_torch.launch.serve import make_requests
    n_layers = model.cfg.n_layers
    reqs = make_requests(model.cfg.vocab_size, SERVE["requests"],
                         SERVE["prompt_len"], SERVE["new_tokens"],
                         SERVE["arrival_every"])
    failures = []
    fused, n_fused, fused_tl = run_continuous(torch, model, params, reqs,
                                              paged_attn="fused",
                                              route="gqa_mma")
    log(f"fused: {fused.n_steps} decode steps, {n_fused} kernel launches, "
        f"all through gqa_mma (D {model.cfg.d_head})")
    if n_fused != fused.n_steps * n_layers or n_fused == 0:
        raise AssertionError(f"fused launches {n_fused} != "
                             f"{fused.n_steps} steps x {n_layers} layers")
    eager, n_eager, eager_tl = run_continuous(torch, model, params, reqs,
                                              paged_attn="fused",
                                              route="gqa_mma", eager=True)
    if n_eager != n_fused:
        raise AssertionError(f"eager fused launches {n_eager} != graphed "
                             f"{n_fused}")
    graphs = {"fused": graph_vs_eager("fused", fused_tl, eager_tl, failures)}
    gather, n_gather, gather_tl = run_continuous(torch, model, params, reqs,
                                                 paged_attn="gather")
    if n_gather != 0:
        raise AssertionError(f"gather path launched the kernel {n_gather} "
                             f"times")
    _, _, gather_eager_tl = run_continuous(torch, model, params, reqs,
                                           paged_attn="gather", eager=True)
    graphs["gather"] = graph_vs_eager("gather", gather_tl, gather_eager_tl,
                                      failures)
    oneshot, one_tl = run_oneshot(model, params, reqs)
    for rid in gather_tl:             # both run the same paged prefill
        if not torch.equal(fused_tl[rid][1][0], gather_tl[rid][1][0]):
            raise AssertionError(f"prefill logits of request {rid} differ "
                                 f"between fused and gather")
    plain = dict(tol=LOGIT_TOL, bound=MARGIN_BOUND, failures=failures)
    agree_fg = compare("fused vs gather", fused_tl, gather_tl, **plain)
    agree_go = compare("gather vs one-shot", gather_tl, one_tl, **plain)

    # phase 5: a fixed MP plan
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
                                         paged_attn="fused", route="gqa_mma")
    log(f"MP plan ({plan.n_quantized} fp8 ops, layers {n_layers // 2}-"
        f"{last}): {mp_out.n_steps} decode steps, {n_mp} kernel launches")
    if n_mp != mp_out.n_steps * (n_layers - 1):
        raise AssertionError(f"MP launches {n_mp} != {mp_out.n_steps} steps "
                             f"x {n_layers - 1} fused layers")
    from repro_torch.quant import weight_cache
    kept, of = weight_cache.nbytes(torch.device(DEVICE))
    log(f"weight cache after the MP drains: {kept / 1e9:.3f} GB of fp8 "
        f"codes and scales for {of / 1e9:.3f} GB of bf16 weights "
        f"({kept / max(of, 1):.3f}x)")
    mp_eager, _, mp_eager_tl = run_continuous(
        torch, model, params, reqs, mp=plan, paged_attn="fused", eager=True)
    graphs["mp_fused"] = graph_vs_eager("MP fused", mp_tl, mp_eager_tl,
                                        failures)
    # the plan's serving path against the one-shot engine, both on the
    # reference attention; then the kernel against it under the plan
    mp_gather, n_mp_gather, mp_gather_tl = run_continuous(
        torch, model, params, reqs, mp=plan, paged_attn="gather")
    if n_mp_gather != 0:
        raise AssertionError(f"MP gather path launched the kernel "
                             f"{n_mp_gather} times")
    _, _, mp_gather_eager_tl = run_continuous(
        torch, model, params, reqs, mp=plan, paged_attn="gather", eager=True)
    graphs["mp_gather"] = graph_vs_eager("MP gather", mp_gather_tl,
                                         mp_gather_eager_tl, failures)
    _, mp_one_tl = run_oneshot(model, params, reqs, mp=plan)
    agree_mp_go = compare("MP gather vs MP one-shot", mp_gather_tl,
                          mp_one_tl, **plain)
    agree_mp_fg = compare("MP fused vs MP gather", mp_tl, mp_gather_tl,
                          tol=LOGIT_TOL_MP, bound=MARGIN_BOUND_MP,
                          failures=failures)
    if failures:
        raise AssertionError("; ".join(failures))
    log(f"{model.cfg.name} tokens/s graphed / eager: fused "
        f"{fused.tokens_per_s:.1f} / {eager.tokens_per_s:.1f}, MP fused "
        f"{mp_out.tokens_per_s:.1f} / {mp_eager.tokens_per_s:.1f}")
    return {
        "kernel_launches_main_path": n_fused,
        "weight_cache_gb": kept / 1e9, "weight_cache_of_bf16_gb": of / 1e9,
        "graph_vs_eager": graphs,
        "agreement": {"fused_vs_gather": agree_fg,
                      "gather_vs_oneshot": agree_go,
                      "mp_gather_vs_mp_oneshot": agree_mp_go,
                      "mp_fused_vs_mp_gather": agree_mp_fg},
        "serving": {
            "fused": serving_numbers(fused),
            "fused_eager": serving_numbers(eager),
            "gather": serving_numbers(gather),
            "oneshot": {"tokens_per_s": oneshot.tokens_per_s,
                        "ttft_ms": oneshot.ttft_s * 1e3},
            "mp_fused": serving_numbers(mp_out),
            "mp_fused_eager": serving_numbers(mp_eager),
            "mp_gather": serving_numbers(mp_gather),
        },
    }


# ---------------------------------------------------------------------------
# phases 6-9: Algorithm 1 at full width and depth
# ---------------------------------------------------------------------------


def calibration_phase(torch, model, params, workdir: Path) -> tuple:
    """Phase 6: sensitivities, partition and analytic gain tables over 4
    synthetic batches; the bundle saved as npz, reloaded, solved alike."""
    import dataclasses
    from repro_torch.core.pipeline import AMPOptions, CalibrationBundle, \
        calibrate
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.hw.profiles import H100_SXM
    data = SyntheticLM(SyntheticConfig(vocab_size=model.cfg.vocab_size,
                                       batch=CAL_SHAPE[0],
                                       seq_len=CAL_SHAPE[1]), DEVICE)
    batches = list(data.batches(0, CAL_BATCHES))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    bundle = calibrate(model, params, batches, AMPOptions(hw=H100_SXM))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    sens = np.array(sorted(bundle.sens.sensitivity.values()))
    n_groups = len(bundle.objectives["ET"]["groups"])
    log(f"calibrate: {len(bundle.sens.ops)} ops, {n_groups} groups, "
        f"{CAL_BATCHES} batches of {CAL_SHAPE} in {seconds:.1f} s; peak "
        f"device memory {peak / 1e9:.2f} GB (weights and batches "
        f"{base_mem / 1e9:.2f} GB)")
    log(f"calibrate: E[g] {bundle.sens.loss_mean:.4f} E[g^2] "
        f"{bundle.sens.loss_sq_mean:.4f}; s_l min {sens[0]:.3e} median "
        f"{np.median(sens):.3e} max {sens[-1]:.3e}")
    if not (np.isfinite(sens).all() and (sens > 0).all()
            and math.isfinite(bundle.sens.loss_mean)):
        raise AssertionError("calibration gave a non-finite or zero "
                             "sensitivity")
    if n_groups != 4 * model.cfg.n_layers + 1:
        raise AssertionError(f"{n_groups} groups, expected "
                             f"{4 * model.cfg.n_layers + 1}")
    path = workdir / "bundle.npz"
    bundle.save(str(path))
    loaded = CalibrationBundle.load(str(path))
    for obj in ("ET", "TT", "M"):
        a, b = bundle.solve(TAU, obj), loaded.solve(TAU, obj)
        if dataclasses.asdict(a) != dataclasses.asdict(b):
            raise AssertionError(f"reloaded bundle solves {obj} differently")
    log(f"bundle saved ({path.stat().st_size / 1e3:.1f} kB npz), reloaded; "
        f"ET/TT/M plans at tau {TAU} identical")
    return bundle, batches, {
        "seconds": seconds, "peak_gb": peak / 1e9,
        "weights_and_batches_gb": base_mem / 1e9,
        "n_ops": len(bundle.sens.ops), "n_groups": n_groups,
        "loss_mean": bundle.sens.loss_mean,
        "loss_sq_mean": bundle.sens.loss_sq_mean,
        "s_min": float(sens[0]), "s_median": float(np.median(sens)),
        "s_max": float(sens[-1])}


def measured_phase(torch, model, params, bundle) -> dict:
    """Phase 7: the measured wall-clock tier through the fp8 kernels, at
    ``WallClockGainModel``'s own repeats. The kernels' launch counters are
    set to 0 just before and read just after."""
    from repro_torch.core.pipeline import tabulate_measured_gains
    from repro_torch.core.timegain import WallClockGainModel
    from repro_torch.kernels import fp8_matmul as mm
    from repro_torch.kernels import quant_cast as qc
    from repro_torch.quant import weight_cache
    from repro_torch.quant.qops import QuantContext
    n_warmup = WallClockGainModel.n_warmup
    n_iters = WallClockGainModel.n_iters
    g = torch.Generator(device=DEVICE).manual_seed(7)
    prompt = torch.randint(0, model.cfg.vocab_size, TIER_PROMPT, generator=g,
                           device=DEVICE, dtype=torch.int32)
    linear = {op.name for op in bundle.sens.ops if op.kind == "linear"}
    times: dict = {}
    fp8_linear_runs = [0]
    fp8_weights: set = set()

    def run_factory(assignment):
        ctx = QuantContext(mode="mp", mp=dict(assignment), impl="kernel")
        key = tuple(sorted(n for n, f in assignment.items() if f != "bf16"))
        n_fp8 = sum(1 for n in key if n in linear)
        fp8_weights.update(n for n in key if n in linear)

        def run():
            t0 = time.perf_counter()
            with torch.no_grad():
                model.apply(params, prompt, ctx)
            torch.cuda.synchronize()
            times.setdefault(key, []).append(time.perf_counter() - t0)
            fp8_linear_runs[0] += n_fp8
        return run

    base = run_factory({})
    for _ in range(3):
        base()                                   # warm-up, not recorded
    times.clear()
    torch.cuda.synchronize()
    qc.launches.update(amax=0, scale_cast=0)
    mm.launches = 0
    wq0 = weight_cache.quantizations
    t0 = time.perf_counter()
    key = tabulate_measured_gains(bundle, run_factory, objective="ET",
                                  n_warmup=n_warmup, n_iters=n_iters)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"amax": qc.launches["amax"],
              "scale_cast": qc.launches["scale_cast"],
              "fp8_matmul": mm.launches}
    n_wq = weight_cache.quantizations - wq0
    want = {"amax": fp8_linear_runs[0] + n_wq,
            "scale_cast": fp8_linear_runs[0] + n_wq,
            "fp8_matmul": fp8_linear_runs[0]}
    n_runs = sum(len(v) for v in times.values())
    log(f"measured tier ({n_warmup} warm-up + {n_iters} timed runs a "
        f"combo): {len(times)} assignments, {n_runs} forwards of "
        f"{TIER_PROMPT} in {seconds:.1f} s; launches {counts} (expected "
        f"{want}: 1+1+1 per fp8 linear per run, plus 1 amax + 1 scale_cast "
        f"for each of the {n_wq} weights, quantized once)")
    if counts != want or counts["fp8_matmul"] == 0:
        raise AssertionError(f"fp8 kernel launches {counts} != {want}")
    if n_wq != len(fp8_weights):
        raise AssertionError(f"{n_wq} weight quantizations for "
                             f"{len(fp8_weights)} weights set to fp8")
    base_s = np.array(times[()]) * 1e3          # the tier's own base runs
    for _ in range(10):
        base()
    spread = np.array(times[()]) * 1e3
    log(f"base forward (all bf16): tier median {np.median(base_s):.3f} ms; "
        f"{spread.size} runs min {spread.min():.3f} median "
        f"{np.median(spread):.3f} max {spread.max():.3f} ms (spread "
        f"{spread.max() - spread.min():.3f} ms)")
    groups = bundle.objectives[key]["groups"]
    rows, lines = [], []
    for gi, (group, gains) in enumerate(zip(groups, bundle.objectives[key][
            "gains"])):
        gains = np.asarray(gains) * 1e3
        best = int(np.argmax(gains))
        rows.append({"group": gi, "ops": group,
                     "all_fp8_ms": float(gains[-1]),
                     "best_ms": float(gains[best]), "best_combo": best})
        short = ",".join(n.split("/")[-1].replace("_proj", "").replace(
            "_matmul", "") for n in group)
        lines.append(f"g{gi}[{short}] all-fp8 {gains[-1]:+.3f} best "
                     f"{gains[best]:+.3f}")
    for i in range(0, len(lines), 4):
        log("gain ms: " + " | ".join(lines[i:i + 4]))
    all_fp8 = np.array([r["all_fp8_ms"] for r in rows])
    log(f"per-group gain of the all-fp8 combo: min {all_fp8.min():+.3f} "
        f"median {np.median(all_fp8):+.3f} max {all_fp8.max():+.3f} ms; "
        f"{int((all_fp8 > 0).sum())} of {len(rows)} groups positive")
    base_spread = float(spread.max() - spread.min())
    best = np.array([r["best_ms"] for r in rows])
    n_beyond = int((best > base_spread).sum())
    log(f"{n_beyond} of {len(rows)} groups gain beyond the base forward's "
        f"spread ({base_spread:.3f} ms) with their best combo; "
        f"{int((all_fp8 > base_spread).sum())} with the all-fp8 combo")
    return {"seconds": seconds, "launches": counts, "n_forwards": n_runs,
            "n_warmup": n_warmup, "n_iters": n_iters,
            "weight_quantizations": n_wq, "base_spread_ms": base_spread,
            "groups_beyond_spread": n_beyond,
            "base_ms_tier": float(np.median(base_s)),
            "base_ms_runs": spread.tolist(), "groups": rows}


def solve_and_serve_phase(torch, model, params, bundle, workdir: Path,
                          failures: list) -> tuple:
    """Phase 8: the measured ET plan served through the launcher, and the
    MP continuous drain held against the MP one-shot engine in process."""
    from repro_torch.launch.serve import make_requests
    plans = {obj: bundle.solve(TAU, obj) for obj in ("ET", "TT", "M")}
    for obj, plan in plans.items():
        log(f"plan {obj} at tau {TAU}: {plan.n_quantized} ops fp8, "
            f"predicted gain {plan.predicted_gain:.4e}, loss MSE "
            f"{plan.predicted_loss_mse:.4e} <= {plan.budget:.4e} "
            f"[{plan.meta['gain_tier']}]")
    if plans["ET"].meta["gain_tier"] != "measured":
        raise AssertionError("the ET plan was not priced by the measured "
                             "table")
    path = workdir / "bundle_measured.npz"
    bundle.save(str(path))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "llama3_1b", "--continuous", "--calibration", str(path), "--tau",
           str(TAU), "--objective", "ET",
           "--n-slots", str(SERVE["n_slots"]),
           "--requests", str(SERVE["requests"]),
           "--arrival-every", str(SERVE["arrival_every"]),
           "--prompt-len", str(SERVE["prompt_len"]),
           "--new-tokens", str(SERVE["new_tokens"])]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       env=env, cwd=str(ROOT))
    for line in r.stdout.strip().splitlines():
        log(f"launcher: {line}")
    if r.returncode != 0:
        raise AssertionError(f"launcher exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    served = f"continuous: {SERVE['requests']} reqs"
    if "[measured]" not in r.stdout or served not in r.stdout:
        raise AssertionError("launcher did not serve the measured plan")
    log(f"launcher served the measured ET plan in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = make_requests(model.cfg.vocab_size, SERVE["requests"],
                         SERVE["prompt_len"], SERVE["new_tokens"],
                         SERVE["arrival_every"])
    agreement = {}
    for obj in ("ET", "TT"):
        _, _, cont = run_continuous(torch, model, params, reqs,
                                    mp=plans[obj], paged_attn="gather")
        _, one = run_oneshot(model, params, reqs, mp=plans[obj])
        agreement[obj] = compare(f"{obj} plan: MP gather vs MP one-shot",
                                 cont, one, tol=LOGIT_TOL,
                                 bound=MARGIN_BOUND, failures=failures)
    return plans, {"launcher_stdout": r.stdout[-4000:],
                   "agreement": agreement,
                   "plans": {o: {"n_fp8": p.n_quantized,
                                 "predicted_gain": p.predicted_gain,
                                 "predicted_loss_mse": p.predicted_loss_mse,
                                 "budget": p.budget,
                                 "gain_tier": p.meta["gain_tier"]}
                             for o, p in plans.items()}}


def fig3a_phase(torch, model, params, batches, plans) -> dict:
    """Phase 9: the loss under each plan through the fp8 kernels and
    through fake quantization, and the measured loss MSE (over the
    calibration batches, against the bf16 loss) beside the predicted one."""
    from repro_torch.quant.qops import QuantContext
    out = {}
    with torch.no_grad():
        plain = np.array([float(model.loss(params, b, QuantContext()))
                          for b in batches])
        for obj in ("ET", "TT"):
            plan = plans[obj]
            rec = {"predicted_mse": plan.predicted_loss_mse,
                   "n_fp8": plan.n_quantized}
            for impl in ("kernel", "simulate"):
                ctx = QuantContext(mode="mp", mp=plan.assignment, impl=impl)
                losses = np.array([float(model.loss(params, b, ctx))
                                   for b in batches])
                if not np.isfinite(losses).all():
                    raise AssertionError(f"{obj} plan, impl {impl}: "
                                         f"non-finite loss")
                rec[impl] = {"loss_mean": float(losses.mean()),
                             "mse": float(np.mean((losses - plain) ** 2))}
            rec["kernel_minus_simulate"] = (rec["kernel"]["loss_mean"]
                                            - rec["simulate"]["loss_mean"])
            log(f"Fig. 3a, {obj} plan ({plan.n_quantized} fp8 ops): loss "
                f"kernel {rec['kernel']['loss_mean']:.5f} simulate "
                f"{rec['simulate']['loss_mean']:.5f} (diff "
                f"{rec['kernel_minus_simulate']:+.2e}) bf16 "
                f"{plain.mean():.5f}; loss MSE measured kernel "
                f"{rec['kernel']['mse']:.3e} simulate "
                f"{rec['simulate']['mse']:.3e} predicted "
                f"{plan.predicted_loss_mse:.3e}")
            out[obj] = rec
    out["bf16_loss_mean"] = float(plain.mean())
    return out


# ---------------------------------------------------------------------------
# phase 13: Llama-3.1-8B at full width
# ---------------------------------------------------------------------------

LLAMA8B = "llama3_8b"
# of the card's memory a calibration may take: a linear fit of the peak
# over depths 1 and 3 underestimates deeper ones (depth 22 needed more than
# 81.8 GB where 1 -> 2 layers predicted 71.3 GB, on an H100)
CAL_MEMORY_SHARE = 0.75


def _bytes_of(tree) -> int:
    if isinstance(tree, dict):
        return sum(_bytes_of(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def llama8b_calibration(torch, cfg, params, batches) -> dict:
    """Algorithm 1's ``calibrate`` on llama3_8b over phase 6's batches at
    the largest depth whose probes and backward fit in
    ``CAL_MEMORY_SHARE`` of the card: the peaks at depths 1 and 3 (every
    layer's weights resident) give the per-layer cost of probes,
    gradients and activations, and the depth counts each kept layer's
    weights beside it; layers past the depth are freed first."""
    import dataclasses
    from repro_torch.core.pipeline import AMPOptions, calibrate
    from repro_torch.hw.profiles import H100_SXM
    from repro_torch.models.registry import build_model
    n = len(params["layers"])

    def run(depth):
        model = build_model(dataclasses.replace(
            cfg, n_layers=depth, block_types=cfg.block_types[:depth]))
        cut = dict(params, layers={str(i): params["layers"][str(i)]
                                   for i in range(depth)})
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        bundle = calibrate(model, cut, batches, AMPOptions(hw=H100_SXM))
        torch.cuda.synchronize()
        return model, bundle, time.perf_counter() - t0, \
            torch.cuda.max_memory_allocated()

    total = torch.cuda.get_device_properties(0).total_memory
    w_layer = _bytes_of(params["layers"]["0"])
    d3 = min(3, n)
    p1, p3 = run(1)[3], run(d3)[3]
    per_layer = (p3 - p1) / max(d3 - 1, 1)
    fixed = p1 - per_layer
    budget = CAL_MEMORY_SHARE * total
    need = fixed + n * per_layer
    depth = n if need <= budget else max(1, min(n, int(
        (budget - fixed + n * w_layer) // (per_layer + w_layer))))
    log(f"llama3_8b calibration depth: {depth} of {n} layers (peak at 1 / "
        f"{d3} layers {p1 / 1e9:.2f} / {p3 / 1e9:.2f} GB, so all {n} would "
        f"need about {need / 1e9:.1f} GB against {budget / 1e9:.1f} GB, "
        f"{CAL_MEMORY_SHARE:.0%} of the card's {total / 1e9:.1f} GB)")
    held = torch.cuda.memory_allocated()
    for i in range(depth, n):
        del params["layers"][str(i)]
    gc.collect()
    log(f"llama3_8b layers {depth}-{n - 1} freed: {held / 1e9:.2f} -> "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"({(n - depth) * w_layer / 1e9:.2f} GB of their weights)")
    model, bundle, seconds, peak = run(depth)
    sens = np.array(sorted(bundle.sens.sensitivity.values()))
    n_groups = len(bundle.objectives["ET"]["groups"])
    log(f"llama3_8b calibrate at depth {depth}: {len(bundle.sens.ops)} ops, "
        f"{n_groups} groups, {CAL_BATCHES} batches of {CAL_SHAPE} in "
        f"{seconds:.1f} s; peak device memory {peak / 1e9:.2f} GB")
    if not (np.isfinite(sens).all() and (sens > 0).all()
            and math.isfinite(bundle.sens.loss_mean)):
        raise AssertionError("llama3_8b calibration gave a non-finite or "
                             "zero sensitivity")
    if n_groups != 4 * depth + 1:
        raise AssertionError(f"{n_groups} groups, expected {4 * depth + 1}")
    plan = bundle.solve(TAU, "ET")
    log(f"llama3_8b ET plan at tau {TAU}: {plan.n_quantized} ops fp8 "
        f"[{plan.meta['gain_tier']}]")
    return {"depth": depth, "of_layers": n, "seconds": seconds,
            "peak_gb": peak / 1e9, "peak_depth1_gb": p1 / 1e9,
            "peak_depth3_gb": p3 / 1e9, "full_depth_need_gb": need / 1e9,
            "n_ops": len(bundle.sens.ops), "n_groups": n_groups,
            "loss_mean": bundle.sens.loss_mean,
            "s_min": float(sens[0]), "s_max": float(sens[-1]),
            "et_plan_n_fp8": plan.n_quantized}


def llama8b_phase(torch) -> dict:
    """Phase 13: Llama-3.1-8B-Instruct's published widths, random weights:
    phases 4 and 5's checks at phase 4's cell (every fused launch through
    ``gqa_mma`` at D 128; the fixed plan: fp8 on the linear ops of layers
    16-31 and the BGEMMs of layer 31), then calibration."""
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.launch.serve import make_model_and_params
    t0 = time.perf_counter()
    model, params = make_model_and_params(LLAMA8B, False, DEVICE, seed=0)
    torch.cuda.synchronize()
    cfg = model.cfg
    log(f"{LLAMA8B}: {model.n_params() / 1e9:.3f}B params ({cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, d_head {cfg.d_head}, untied head), "
        f"random init in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    torch.cuda.reset_peak_memory_stats()
    out = serve_phase(torch, model, params)
    out["serving_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    data = SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size,
                                       batch=CAL_SHAPE[0],
                                       seq_len=CAL_SHAPE[1]), DEVICE)
    batches = list(data.batches(0, CAL_BATCHES))
    del model                 # its decode graphs hold the params they read
    gc.collect()
    out["calibration"] = llama8b_calibration(torch, cfg, params, batches)
    return out


# ---------------------------------------------------------------------------
# phase 10: kernel 4, mixed-precision flash attention
# ---------------------------------------------------------------------------

# (B, H, T, S, D, Dv): llama3_1b's attention width and DeepSeek-V3's MLA
# prefill width at 4096 tokens, and one small T != S case
FLASH_SHAPES = {"llama3_1b": (1, 32, 4096, 4096, 64, 64),
                "deepseek_v3": (1, 128, 4096, 4096, 192, 128),
                "t_ne_s": (2, 4, 300, 700, 64, 64)}


def flash_agrees(torch, got, want, quant_probs: bool) -> tuple:
    """(ok, max abs err). Without quant_probs: two bf16 ulps at |o| ~ 1
    (KERNEL_TOL, absolute and relative). With it, a probability that the
    two f32 sum orders put on either side of an e4m3 rounding boundary
    moves by one e4m3 step (at most p/8), so an output by at most max|v|/8
    over a denominator of at least 1: max error 2^-3, and at most one
    output in 1000 beyond KERNEL_TOL."""
    err = (got.float() - want.float()).abs()
    beyond = err > KERNEL_TOL * (1 + want.float().abs())
    e = float(err.max())
    if not quant_probs:
        return not bool(beyond.any()), e
    return e <= 0.125 and float(beyond.float().mean()) <= 1e-3, e


def causal_pairs(T: int, S: int) -> int:
    """Live (query, key) pairs under the top-left causal mask."""
    return sum(min(i + 1, S) for i in range(T))


def flash_phase(torch) -> dict:
    """Kernel 4 against its plain version at the model widths, bf16 and
    through ``flash_attention_mp(fmt_name="fp8_e4m3")``; its launches are
    those of its entry point (no model path of either package calls it):
    one bf16 and one fp8 call at the llama3_1b width, counters set to 0
    just before and read just after. Then kernel, plain version and
    ``scaled_dot_product_attention(is_causal=True)`` (also top-left) timed
    at each width."""
    import torch.nn.functional as F
    from repro_torch.kernels import mp_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_cast as qc
    from repro_torch.kernels.ref import mp_flash_attention_plain

    def qkv(shape, seed):
        B_, H_, T_, S_, D_, Dv_ = shape
        return [randn(torch, s, seed + i, 1.0, torch.bfloat16)
                for i, s in enumerate(((B_, H_, T_, D_), (B_, H_, S_, D_),
                                       (B_, H_, S_, Dv_)))]

    # the entry point's run
    q, k, v = qkv(FLASH_SHAPES["llama3_1b"], 100)
    torch.cuda.synchronize()
    fa.launches = 0
    qc.launches.update(amax=0, scale_cast=0)
    bf16_out = ops.flash_attention_mp(q, k, v)
    fp8_out = ops.flash_attention_mp(q, k, v, fmt_name="fp8_e4m3")
    torch.cuda.synchronize()
    launches = fa.launches
    q_launches = dict(qc.launches)
    log(f"flash_attention_mp entry point: {launches} flash launches, "
        f"quantization launches {q_launches}")
    if launches != 2 or q_launches != {"amax": 3, "scale_cast": 3}:
        raise AssertionError(f"flash_attention_mp launches {launches} / "
                             f"{q_launches}, expected 2 / 3 amax + 3 "
                             f"scale_cast")
    failures, max_err, rec = [], 0.0, {}
    qs = [qc.quantize_fp8(x.reshape(-1, x.shape[-1])) for x in (q, k, v)]
    fp8_args = [a.reshape(x.shape) for (a, _), x in zip(qs, (q, k, v))] + [
        s for _, s in qs]
    checks = [("llama3_1b bf16", bf16_out, mp_flash_attention_plain(q, k, v),
               False),
              ("llama3_1b fp8", fp8_out, mp_flash_attention_plain(
                  *fp8_args, quant_probs=True), True)]
    for name in ("deepseek_v3", "t_ne_s"):
        qq, kk, vv = qkv(FLASH_SHAPES[name], 110)
        for causal in (True, False) if name == "t_ne_s" else (True,):
            checks.append((f"{name} causal={causal}",
                           fa.mp_flash_attention(qq, kk, vv, causal=causal),
                           mp_flash_attention_plain(qq, kk, vv,
                                                    causal=causal), False))
    # t_ne_s: fp8 operands with e4m3 probabilities at a ragged last key
    # block (700 keys: 256, 256, 188 and 96 x 7 + 28), two passes a block;
    # f32 operands through the CUDA-core kernel
    qz = [qc.quantize_fp8(x.reshape(-1, x.shape[-1])) for x in (qq, kk, vv)]
    fq = [a.reshape(x.shape) for (a, _), x in zip(qz, (qq, kk, vv))]
    sc = [s for _, s in qz]
    for bk in (256, 96):
        checks.append((f"t_ne_s fp8 quant_probs block_k={bk}",
                       fa.mp_flash_attention(*fq, *sc, block_k=bk,
                                             quant_probs=True),
                       mp_flash_attention_plain(*fq, *sc, block_k=bk,
                                                quant_probs=True), True))
    f32 = [x.float() for x in (qq, kk, vv)]
    checks.append(("t_ne_s f32 operands", fa.mp_flash_attention(*f32),
                   mp_flash_attention_plain(*f32), False))
    for name, got, want, quant_probs in checks:
        ok, e = flash_agrees(torch, got, want, quant_probs)
        max_err = max(max_err, e)
        log(f"mp_flash_attention vs plain: {name}: max abs err {e:.3e}")
        if not ok:
            failures.append(name)
    del checks, bf16_out, fp8_out, fq, f32
    if failures:
        raise AssertionError("mp_flash_attention disagrees with its plain "
                             "version: " + ", ".join(failures))
    n0 = fa.launches
    for name in ("llama3_1b", "deepseek_v3"):
        B_, H_, T_, S_, D_, Dv_ = FLASH_SHAPES[name]
        qq, kk, vv = qkv(FLASH_SHAPES[name], 120)
        nbytes = 2 * (qq.numel() + kk.numel() + vv.numel() + B_ * H_ * T_ * Dv_)
        ops_ = 2 * B_ * H_ * causal_pairs(T_, S_) * (D_ + Dv_)
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops_ / BF16_FLOPS
        r = {"shape": list(FLASH_SHAPES[name]),
             "ms": timed(torch, fa.mp_flash_attention, qq, kk, vv),
             "plain_ms": timed(torch, mp_flash_attention_plain, qq, kk, vv),
             "bound_ms": max(t_b, t_o) * 1e3,
             "bound_by": "bytes" if t_b >= t_o else "operations",
             "bound_ops": ops_}
        try:
            r["library_ms"] = timed(torch, lambda a, b, c:
                                    F.scaled_dot_product_attention(
                                        a, b, c, is_causal=True), qq, kk, vv)
        except RuntimeError as e:      # the yardstick only, never the port
            r["library_ms"], r["library_error"] = None, str(e)[:200]
        r["tflops"] = ops_ / (r["ms"] * 1e-3) / 1e12
        if name == "llama3_1b":
            qz = [qc.quantize_fp8(x.reshape(-1, x.shape[-1]))
                  for x in (qq, kk, vv)]
            fq = [a.reshape(x.shape) for (a, _), x in zip(qz, (qq, kk, vv))]
            sc = [s for _, s in qz]
            r["fp8_ms"] = timed(torch, lambda a, b, c: fa.mp_flash_attention(
                a, b, c, *sc, quant_probs=True), *fq)
            # without quant_probs: one pass a key tile, so the widening of
            # the fp8 operands is the only work beyond the bf16 run's
            r["fp8_no_quant_probs_ms"] = timed(
                torch, lambda a, b, c: fa.mp_flash_attention(a, b, c, *sc),
                *fq)
            r["fp8_bound_ms"] = max(nbytes / 2 / HBM_BYTES_PER_S,
                                    ops_ / FP8_FLOPS) * 1e3
        rec[name] = r
        lib = (f"{r['library_ms'] * 1e3:.1f} us" if r["library_ms"]
               else "n/a")
        log(f"mp_flash_attention {name} {tuple(r['shape'])}: "
            f"{r['ms'] * 1e3:.1f} us ({r['tflops']:.1f} TFLOP/s) | plain "
            f"{r['plain_ms'] * 1e3:.1f} us | SDPA {lib} | bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})"
            + (f" | fp8 operands {r['fp8_ms'] * 1e3:.1f} us (quant_probs), "
               f"{r['fp8_no_quant_probs_ms'] * 1e3:.1f} us (without)"
               if "fp8_ms" in r else ""))
    fa.launches = n0                  # timing launches are not path ones
    return {"flash_launches": launches, "flash_max_abs_err": max_err,
            "flash_times": rec, "flash_ptxas": ptxas_report("mp_attention")}


# ---------------------------------------------------------------------------
# phase 11: the MLA form of the paged kernel
# ---------------------------------------------------------------------------

# DeepSeek-V3's absorbed decode at the serving cell: 4 rows, 128 query heads
# on one latent KV head, latents 512 + 64, block 16
MLA_H, MLA_R, MLA_DR, MLA_SCALE_DIM = 128, 512, 64, 128 + 64
# f32 scores, probabilities and output: summation order only
MLA_TOL = 1e-4
# phase 11's checks (lengths, window): page boundaries, mid-page, one page,
# a vacant row; the serving cell's mid-drain step; 16 keys; windows
MLA_CHECKS = (((MAX_LEN, 100, BS, 0), None), ((160, 152, 144, 136), None),
              ((16, 16, 16, 16), None), ((MAX_LEN, 100, BS, 0), 7),
              ((160, 152, 37, 5), 40))
# the shapes the MLA form is timed at: the serving cell, 16 keys a row and a
# long table
MLA_TIMES = {"serving": (160, 152, 144, 136), "keys16": (16, 16, 16, 16),
             "long": (2048,) * 4}


def mla_case(torch, seed: int, lengths, poison_value: float):
    """As ``paged_case`` with ckv/kr pages and f32 queries."""
    rng = np.random.default_rng(seed)
    n_pages = -(-max(max(lengths), MAX_LEN) // BS)
    n_live = B * n_pages
    n_blocks = 1 + n_live + 4
    poison = np.arange(1 + n_live, n_blocks)
    perm = rng.permutation(np.arange(1, 1 + n_live))
    lengths = np.asarray(lengths, np.int32)
    tables = np.full((B, n_pages), -1, np.int32)
    c = 0
    for b in range(B):
        if lengths[b] == 0:
            continue
        used = -(-int(lengths[b]) // BS)
        tables[b, :used] = perm[c:c + used]
        c += used
        tables[b, used:] = rng.choice(poison, size=n_pages - used)

    def pages(width):
        x = rng.normal(size=(n_blocks, BS, 1, width)).astype(np.float32)
        x[poison] = poison_value
        return torch.from_numpy(x).cuda().to(torch.bfloat16)

    ckv, kr = pages(MLA_R), pages(MLA_DR)
    q1 = torch.from_numpy(rng.normal(size=(B, 1, MLA_H, MLA_R)).astype(
        np.float32)).cuda()
    q2 = torch.from_numpy(rng.normal(size=(B, 1, MLA_H, MLA_DR)).astype(
        np.float32)).cuda()
    args = (q1, ckv, None, torch.from_numpy(tables).cuda(),
            torch.from_numpy(lengths).cuda())
    kw = dict(q2=q2, k2=kr, scale=1.0 / math.sqrt(MLA_SCALE_DIM),
              scale_mode="mul", out_dtype=torch.float32)
    return args, kw


def mla_kernel_phase(torch) -> dict:
    """The MLA form's tensor-core kernel (route ``mla_mma``) against its
    plain version at each ``MLA_CHECKS`` case — a vacant row, dead entries
    on poisoned blocks, windows — with two calls bit-equal and NaN in blocks
    no live page references and in the stale slots of live pages leaving
    the output bit-identical; the CUDA-core kernel (route forced) against
    the plain version at the same cases. Then, at each ``MLA_TIMES`` shape,
    both kernels, the plain version and SDPA over the gathered latents, with
    two bounds: the exact route's (the operations three times, on the bf16
    tensor cores) and the f32 one (the operations on the CUDA cores)."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_decode_attention_ref, paged_deq
    max_err = core_err = 0.0
    n0, n0_route = pa.launches, dict(pa.launches_by_route)
    for lengths, window in MLA_CHECKS:
        name = f"lengths {lengths} window {window}"
        args, kw = mla_case(torch, 3, lengths, 224.0)
        kw["window"] = window
        before = pa.launches_by_route["mla_mma"]
        got = pa.paged_decode_attention(*args, **kw)
        again = pa.paged_decode_attention(*args, **kw)
        want = paged_decode_attention_ref(*args, **kw)
        with forced_route(pa, "cuda_core"):
            core = pa.paged_decode_attention(*args, **kw)
        torch.cuda.synchronize()
        if pa.launches_by_route["mla_mma"] != before + 2:
            raise AssertionError(f"MLA {name}: not launched through "
                                 f"mla_mma")
        err = float((got - want).abs().max())
        c_err = float((core - want).abs().max())
        max_err, core_err = max(max_err, err), max(core_err, c_err)
        log(f"MLA form vs plain: {name}: mla_mma max abs err {err:.3e}, "
            f"cuda_core {c_err:.3e} (rtol/atol {MLA_TOL:g})")
        for kernel, out in (("mla_mma", got), ("cuda_core", core)):
            if not torch.allclose(out, want, rtol=MLA_TOL, atol=MLA_TOL):
                raise AssertionError(f"the MLA form ({kernel}) disagrees "
                                     f"with its plain version: {name}")
        if not torch.equal(again, got):
            raise AssertionError(f"MLA {name}: two calls differ")
        if any(L == 0 for L in lengths) and \
                got[list(lengths).index(0)].abs().max().item() != 0.0:
            raise AssertionError("MLA: vacant row (length 0) is not zero")
        # NaN in blocks only dead entries reference, then also in the stale
        # slots of live pages, must never be read
        nan_args, nan_kw = mla_case(torch, 3, lengths, float("nan"))
        nan_kw["window"] = window
        got_nan = pa.paged_decode_attention(*nan_args, **nan_kw)
        _, ckv, _, bt, ln = nan_args
        n_stale = poison_stale(torch, ckv, nan_kw["k2"], bt.cpu(), ln.cpu(),
                               window)
        got_stale = pa.paged_decode_attention(*nan_args, **nan_kw)
        torch.cuda.synchronize()
        for what, t in (("a block no live page references", got_nan),
                        (f"{n_stale} stale slots of live pages", got_stale)):
            if not torch.isfinite(t).all() or not torch.equal(t, got):
                raise AssertionError(f"MLA {name}: NaN in {what} changed "
                                     f"the output")
    log(f"MLA form vs plain: {len(MLA_CHECKS)} cases within tolerance, "
        f"mla_mma max abs err {max_err:.3e}, cuda_core {core_err:.3e}")

    times = {}
    for shape, lengths in MLA_TIMES.items():
        args, kw = mla_case(torch, 4, lengths, 0.0)

        def kernel():
            return pa.paged_decode_attention(*args, **kw)

        def plain():
            return paged_decode_attention_ref(*args, **kw)

        q1, ckv, _, bt, ln = args
        kg = paged_deq(ckv, bt, torch.float32, 1.0)            # (B, S, 1, r)
        krg = paged_deq(kw["k2"], bt, torch.float32, 1.0)
        keys = torch.cat([kg, krg], -1).permute(0, 2, 1, 3).contiguous()
        vals = kg.permute(0, 2, 1, 3).contiguous()             # (B, 1, S, r)
        qs = torch.cat([q1, kw["q2"]], -1)                     # (B, 1, H, 576)
        S = keys.shape[2]
        mask = (torch.arange(S, device="cuda")[None, :]
                < ln[:, None]).reshape(B, 1, 1, S)

        def library():
            # the 128 heads share one latent head: they are its queries
            return F.scaled_dot_product_attention(qs, keys, vals,
                                                  attn_mask=mask,
                                                  scale=kw["scale"])

        want = plain()
        lib_err = float((library() - want).abs().max())
        rec = {"ms": device_ms(torch, kernel),
               "ms_eager": eager_ms(torch, kernel, 200),
               "plain_ms": device_ms(torch, plain),
               "library_ms": device_ms(torch, library),
               "library_max_abs_err": lib_err}
        with forced_route(pa, "cuda_core"):
            rec["cuda_core_ms"] = device_ms(torch, kernel)
        if shape != "long":
            # the earlier yardstick: SDPA over the latents expanded to 128 heads
            qh = qs.permute(0, 2, 1, 3).contiguous()           # (B, H, 1, 576)
            keys_h = keys.expand(B, MLA_H, S, keys.shape[-1])
            vals_h = vals.expand(B, MLA_H, S, vals.shape[-1])
            rec["library_expanded_ms"] = device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qh, keys_h, vals_h, attn_mask=mask, scale=kw["scale"]))
        live = sum(lengths)
        nbytes = (live * (MLA_R + MLA_DR) * 2
                  + B * MLA_H * (MLA_R + MLA_DR) * 4
                  + B * MLA_H * MLA_R * 4 + bt.numel() * 4 + ln.numel() * 4)
        ops_ = 2 * live * MLA_H * ((MLA_R + MLA_DR) + MLA_R)
        # exact route: each f32 operand as three bf16 planes, so three
        # times the operations on the bf16 tensor cores; f32: the same
        # operations on the CUDA cores
        t_b = nbytes / HBM_BYTES_PER_S
        t_x, t_f = 3 * ops_ / BF16_FLOPS, ops_ / F32_FLOPS
        rec.update(bound_ms=max(t_b, t_x) * 1e3,
                   bound_by="bytes" if t_b >= t_x else "operations",
                   bound_ms_f32=max(t_b, t_f) * 1e3,
                   bound_by_f32="bytes" if t_b >= t_f else "operations",
                   bound_bytes=nbytes, bound_ops=ops_, lengths=list(lengths),
                   head_group=pa.head_group(MLA_H, MLA_R, MLA_DR,
                                            bt.shape[1], BS, rows=B,
                                            sms=pa._sm_count(q1.device),
                                            route="mla_mma"))
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        log(f"paged_decode_attention MLA form {shape} (B={B}, H={MLA_H}, "
            f"{MLA_R}+{MLA_DR}, keys {lengths}, head group "
            f"{rec['head_group']}): mla_mma {rec['ms'] * 1e3:.2f} us | "
            f"cuda_core {rec['cuda_core_ms'] * 1e3:.2f} us | plain "
            f"{rec['plain_ms'] * 1e3:.2f} us | SDPA "
            f"{rec['library_ms'] * 1e3:.2f} us (max abs err vs plain "
            f"{lib_err:.2e}; over 128 expanded heads "
            f"{rec.get('library_expanded_ms', float('nan')) * 1e3:.2f} us) | "
            f"bound {rec['bound_ms'] * 1e3:.3f} us ({rec['bound_by']}, "
            f"{100 * rec['share_of_bound']:.1f}% of it), f32 bound "
            f"{rec['bound_ms_f32'] * 1e3:.3f} us ({rec['bound_by_f32']}) | "
            f"eager {rec['ms_eager'] * 1e3:.2f} us")
        times[shape] = rec
    pa.launches = n0                  # checks and timing are not the path
    pa.launches_by_route.update(n0_route)
    res = dict(times["serving"])
    res["mla_shapes"] = times
    return {"mla_max_abs_err": max_err, "mla_cuda_core_max_abs_err": core_err,
            "mla_times": res}


# ---------------------------------------------------------------------------
# phase 13: DeepSeek-V3's dense MLA prefix served at full width
# ---------------------------------------------------------------------------

DEEPSEEK = "deepseek_v3_671b"


def deepseek_models(torch):
    """The dense prefix (three MLA layers at the published widths), its
    absorbed-decode model and its expanded-decode model over one set of
    random weights."""
    from repro_torch.launch.serve import make_model_and_params
    from repro_torch.models.registry import dense_prefix_overrides, get_model
    ov = dense_prefix_overrides(DEEPSEEK)
    t0 = time.perf_counter()
    absorbed, params = make_model_and_params(DEEPSEEK, False, DEVICE, seed=0,
                                             mla_absorb_decode=True, **ov)
    torch.cuda.synchronize()
    log(f"{DEEPSEEK} dense prefix ({absorbed.cfg.n_layers} MLA layers, "
        f"d_model {absorbed.cfg.d_model}, {absorbed.cfg.n_heads} heads, "
        f"vocab {absorbed.cfg.vocab_size}): {absorbed.n_params() / 1e9:.3f}B "
        f"params, random init in {time.perf_counter() - t0:.1f} s")
    return absorbed, get_model(DEEPSEEK, **ov), params


def mla_serve_phase(torch, absorbed, expanded, params) -> dict:
    """Phase 4's cell on the dense MLA prefix: the absorbed decode through
    the MLA form of the paged kernel (fused) and through the gather path,
    the one-shot engine, the expanded decode (which always gathers) against
    its own one-shot engine; then under a fixed MP plan (fp8 on every
    linear op of layers 1-2 and on layer 2's attention BGEMMs, which then
    gathers): fused and gather drains and the one-shot engine. The kernel's
    launches must equal decode steps x fused layers."""
    from repro_torch.core.mpconfig import MPPlan
    from repro_torch.launch.serve import make_requests
    n_layers = absorbed.cfg.n_layers
    reqs = make_requests(absorbed.cfg.vocab_size, SERVE["requests"],
                         SERVE["prompt_len"], SERVE["new_tokens"],
                         SERVE["arrival_every"])
    fused, n_fused, fused_tl = run_continuous(torch, absorbed, params, reqs,
                                              paged_attn="fused",
                                              route="mla_mma")
    log(f"MLA fused: {fused.n_steps} decode steps, {n_fused} kernel "
        f"launches, all through mla_mma")
    if n_fused != fused.n_steps * n_layers or n_fused == 0:
        raise AssertionError(f"MLA fused launches {n_fused} != "
                             f"{fused.n_steps} steps x {n_layers} layers")
    failures = []
    eager, _, eager_tl = run_continuous(torch, absorbed, params, reqs,
                                        paged_attn="fused", route="mla_mma",
                                        eager=True)
    graphs = {"fused": graph_vs_eager("MLA fused", fused_tl, eager_tl,
                                      failures)}
    gather, n_gather, gather_tl = run_continuous(torch, absorbed, params,
                                                 reqs, paged_attn="gather")
    _, _, gather_eager_tl = run_continuous(torch, absorbed, params, reqs,
                                           paged_attn="gather", eager=True)
    graphs["gather"] = graph_vs_eager("MLA gather", gather_tl,
                                      gather_eager_tl, failures)
    expd, n_exp, exp_tl = run_continuous(torch, expanded, params, reqs,
                                         paged_attn="fused")
    if n_gather or n_exp:
        raise AssertionError(f"gather / expanded drains launched the kernel "
                             f"{n_gather} / {n_exp} times")
    oneshot, one_tl = run_oneshot(absorbed, params, reqs)
    exp_one, exp_one_tl = run_oneshot(expanded, params, reqs)
    plain = dict(tol=LOGIT_TOL, bound=MARGIN_BOUND, failures=failures)
    agree = {"fused_vs_gather": compare("MLA fused vs gather", fused_tl,
                                        gather_tl, **plain),
             "gather_vs_oneshot": compare("MLA gather vs one-shot",
                                          gather_tl, one_tl, **plain),
             "expanded_vs_oneshot": compare("MLA expanded vs its one-shot",
                                            exp_tl, exp_one_tl, **plain)}
    assignment = {f"layers/{i}/{op}": "fp8_e4m3"
                  for i in range(1, n_layers)
                  for op in ("attn/q_a_proj", "attn/q_b_proj",
                             "attn/kv_a_proj", "attn/kv_b_proj",
                             "attn/o_proj", "mlp/gate_proj", "mlp/up_proj",
                             "mlp/down_proj")}
    for op in ("qk_matmul", "av_matmul"):
        assignment[f"layers/{n_layers - 1}/attn/{op}"] = "fp8_e4m3"
    plan = MPPlan(assignment=assignment, groups=[], objective="ET", tau=0.0,
                  budget=0.0, predicted_loss_mse=0.0, predicted_gain=0.0)
    mp_f, n_mp, mp_f_tl = run_continuous(torch, absorbed, params, reqs,
                                         mp=plan, paged_attn="fused",
                                         route="mla_mma")
    if n_mp != mp_f.n_steps * (n_layers - 1):
        raise AssertionError(f"MLA MP launches {n_mp} != {mp_f.n_steps} "
                             f"steps x {n_layers - 1} fused layers")
    mp_eager, _, mp_eager_tl = run_continuous(
        torch, absorbed, params, reqs, mp=plan, paged_attn="fused",
        eager=True)
    graphs["mp_fused"] = graph_vs_eager("MLA MP fused", mp_f_tl,
                                        mp_eager_tl, failures)
    mp_g, _, mp_g_tl = run_continuous(torch, absorbed, params, reqs,
                                      mp=plan, paged_attn="gather")
    _, mp_one_tl = run_oneshot(absorbed, params, reqs, mp=plan)
    mp_tol = dict(tol=LOGIT_TOL_MLA_MP, bound=MARGIN_BOUND_MLA_MP,
                  failures=failures)
    agree["mp_gather_vs_mp_oneshot"] = compare(
        "MLA MP gather vs MP one-shot", mp_g_tl, mp_one_tl, **mp_tol)
    agree["mp_fused_vs_mp_gather"] = compare(
        "MLA MP fused vs MP gather", mp_f_tl, mp_g_tl, **mp_tol)
    if failures:
        raise AssertionError("; ".join(failures))
    log(f"MLA serving: {len(fused.results)} of {len(reqs)} requests served "
        f"by each drain; tok/s graphed (eager): fused "
        f"{fused.tokens_per_s:.1f} ({eager.tokens_per_s:.1f}), gather "
        f"{gather.tokens_per_s:.1f}, expanded {expd.tokens_per_s:.1f}, MP "
        f"fused {mp_f.tokens_per_s:.1f} ({mp_eager.tokens_per_s:.1f}; "
        f"{n_mp} launches)")
    return {"mla_kernel_launches_main_path": n_fused,
            "mla_agreement": agree,
            "mla_graph_vs_eager": graphs,
            "mla_serving": {
                "fused": serving_numbers(fused),
                "fused_eager": serving_numbers(eager),
                "mp_fused_eager": serving_numbers(mp_eager),
                "gather": serving_numbers(gather),
                "expanded": serving_numbers(expd),
                "oneshot": {"tokens_per_s": oneshot.tokens_per_s,
                            "ttft_ms": oneshot.ttft_s * 1e3},
                "expanded_oneshot": {"tokens_per_s": exp_one.tokens_per_s,
                                     "ttft_ms": exp_one.ttft_s * 1e3},
                "mp_fused": serving_numbers(mp_f),
                "mp_gather": serving_numbers(mp_g)}}


# ---------------------------------------------------------------------------
# phases 12 and 13: long prompts through the blocked flash attention
# ---------------------------------------------------------------------------

LONG_PROMPTS = {"llama3_1b": 8192, DEEPSEEK: 4096}


def long_prompt(torch, flash_model, ref_model, params, T: int,
                name: str) -> dict:
    """One T-token prompt through the one-shot engine twice: the model's
    own flash threshold (T >= flash_min_seq: blocked flash attention) and
    a threshold of 2^30 (the materialized reference attention). The
    prefill logits must agree within LOGIT_TOL; the first tokens must be
    equal unless the reference's top-two gap is a near-tie."""
    from repro_torch.serve import ServeEngine
    g = torch.Generator().manual_seed(T)
    tokens = torch.randint(0, flash_model.cfg.vocab_size, (1, T),
                           generator=g, dtype=torch.int32).numpy()
    if not T >= flash_model.cfg.flash_min_seq > 0:
        raise AssertionError(f"{name}: {T} tokens do not reach "
                             f"flash_min_seq {flash_model.cfg.flash_min_seq}")
    out = {}
    for path, model in (("flash", flash_model), ("reference", ref_model)):
        eng = ServeEngine(model, device=DEVICE)
        events = record_steps(eng, ("prefill_step", "bucketed_prefill_step"))
        eng.generate(params, {"tokens": tokens}, max_new_tokens=1)  # warm-up
        events.clear()
        torch.cuda.reset_peak_memory_stats()
        res = eng.generate(params, {"tokens": tokens}, max_new_tokens=1)
        (step, logits, *_), = events
        want_step = "prefill_step" if path == "flash" else \
            "bucketed_prefill_step"
        if step != want_step:
            raise AssertionError(f"{name} {path}: prefill went through "
                                 f"{step}, expected {want_step}")
        out[path] = {"ttft_ms": res.ttft_s * 1e3,
                     "first_token": int(res.tokens[0, 0]),
                     "logits": logits[0, -1].float(),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del eng, events
    err = float((out["flash"]["logits"] - out["reference"]["logits"]).abs()
                .max())
    gap = float(top2_gaps(out["reference"]["logits"][None])[0])
    same = out["flash"]["first_token"] == out["reference"]["first_token"]
    rec = {"tokens": T, "max_logit_err": err, "ref_top2_gap": gap,
           "first_token_equal": same}
    for path in ("flash", "reference"):
        rec[path] = {k: v for k, v in out[path].items() if k != "logits"}
    log(f"long prompt {name} ({T} tokens): first token flash "
        f"{out['flash']['first_token']} reference "
        f"{out['reference']['first_token']} (top-2 gap {gap:.4f}); logits max"
        f" abs err {err:.4f} (tol {LOGIT_TOL}); TTFT flash "
        f"{out['flash']['ttft_ms']:.1f} ms (peak {out['flash']['peak_gb']:.1f}"
        f" GB) reference {out['reference']['ttft_ms']:.1f} ms (peak "
        f"{out['reference']['peak_gb']:.1f} GB)")
    if not err <= LOGIT_TOL:
        raise AssertionError(f"{name}: long-prompt logits differ by {err:.4f}"
                             f" > {LOGIT_TOL}")
    if not (same or gap < MARGIN_BOUND):
        raise AssertionError(f"{name}: first tokens differ at a top-2 gap of "
                             f"{gap:.4f}")
    return rec


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
    report_ptxas = {n: ptxas_report(n) for n in ("paged_decode_gqa",
                                                  "paged_decode_mla",
                                                  "paged_attention")}
    # phases 3 and 10 report the rest

    report = {"card": card, "phase_seconds": {}, "paged_ptxas": report_ptxas}

    def phase(name, fn, *a):
        t = time.perf_counter()
        res = fn(*a)
        torch.cuda.synchronize()
        report["phase_seconds"][name] = time.perf_counter() - t
        log(f"phase {name}: {report['phase_seconds'][name]:.1f} s")
        return res

    report.update(phase("paged kernel checks", kernel_phase, torch))
    report.update(phase("paged kernel times", time_kernel, torch))
    log("paged_decode_attention GQA serving shape, device time (CUDA "
        "graph): kernel "
        f"{report['ms'] * 1e3:.2f} us | plain {report['plain_ms'] * 1e3:.2f} "
        f"us | SDPA {report['library_ms'] * 1e3:.2f} us | bound "
        f"{report['bound_ms'] * 1e3:.3f} us ({report['bound_by']})")
    log("eager per call (launch overhead included): kernel "
        f"{report['ms_eager'] * 1e3:.2f} us | plain "
        f"{report['plain_ms_eager'] * 1e3:.2f} us | SDPA "
        f"{report['library_ms_eager'] * 1e3:.2f} us | wrapper enqueue "
        f"{report['host_enqueue_ms'] * 1e3:.2f} us")
    report.update(phase("fp8 kernel checks", fp8_check_phase, torch))
    report["fp8_times"] = phase("fp8 kernel times", fp8_time_phase, torch)

    from repro_torch.launch.serve import make_model_and_params
    t0 = time.perf_counter()
    model, params = make_model_and_params("llama3_1b", False, "cuda", seed=0)
    torch.cuda.synchronize()
    log(f"{model.cfg.name}: {model.n_params() / 1e9:.3f}B params, "
        f"random init in {time.perf_counter() - t0:.1f} s")
    report.update(phase("serving", serve_phase, torch, model, params))

    failures: list = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        bundle, batches, report["calibration"] = phase(
            "calibration", calibration_phase, torch, model, params,
            Path(tmp))
        report["measured_tier"] = phase("measured tier", measured_phase,
                                        torch, model, params, bundle)
        plans, report["plan_serving"] = phase(
            "solve and serve", solve_and_serve_phase, torch, model, params,
            bundle, Path(tmp), failures)
    report["fig3a"] = phase("fig3a", fig3a_phase, torch, model, params,
                            batches, plans)
    if failures:
        raise AssertionError("; ".join(failures))

    report.update(phase("flash kernel", flash_phase, torch))
    report.update(phase("MLA kernel", mla_kernel_phase, torch))
    from repro_torch.models.registry import dense_prefix_overrides, get_model
    report["long_prompt"] = {"llama3_1b": phase(
        "long prompt llama3_1b", long_prompt, torch, model,
        get_model("llama3_1b", flash_min_seq=1 << 30), params,
        LONG_PROMPTS["llama3_1b"], "llama3_1b")}
    del model, params, bundle, batches
    gc.collect()                      # the model's decode graphs go with it
    torch.cuda.empty_cache()
    report["llama3_8b"] = phase("llama3_8b", llama8b_phase, torch)
    gc.collect()
    torch.cuda.empty_cache()
    absorbed, expanded, ds_params = deepseek_models(torch)
    report.update(phase("MLA serving", mla_serve_phase, torch, absorbed,
                        expanded, ds_params))
    report["long_prompt"][DEEPSEEK] = phase(
        f"long prompt {DEEPSEEK}", long_prompt, torch, absorbed,
        get_model(DEEPSEEK, flash_min_seq=1 << 30, mla_absorb_decode=True,
                  **dense_prefix_overrides(DEEPSEEK)), ds_params,
        LONG_PROMPTS[DEEPSEEK], DEEPSEEK)

    t = report["fp8_times"]
    launches = report["measured_tier"]["launches"]
    kernels = [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "dispatch": "gqa_mma",
        "source": "src/repro_torch/kernels/csrc/paged_decode_gqa.cu",
        "replaces": "src/repro/kernels/paged_attention.py:204",
        "launches": report["kernel_launches_main_path"],
        "launches_llama3_8b": report["llama3_8b"][
            "kernel_launches_main_path"],
        "max_abs_err": report["max_abs_err"],
        "ms": report["ms"],
        "kernel_ms": report["ms"],
        "plain_ms": report["plain_ms"],
        "bound_ms": report["bound_ms"],
        "bound_by": report["bound_by"],
        "library_ms": report["library_ms"],
    }]
    # the fp8 kernels at the gate_proj weight / product, 2048 tokens
    for name, src, line, err in (
            ("amax", "quant_cast", "quant_cast.py:32", 0.0),
            ("scale_cast", "quant_cast", "quant_cast.py:50", 0.0),
            ("fp8_matmul", "fp8_matmul", "fp8_matmul.py:47",
             report["fp8_matmul_max_abs_err"])):
        r = t[name]["gate_proj"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": f"src/repro/kernels/{line}",
            "launches": launches[name], "max_abs_err": err,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    f = report["flash_times"]["llama3_1b"]
    kernels.append({
        "name": "mp_flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mp_attention.cu",
        "replaces": "src/repro/kernels/mp_attention.py:76",
        "launches": report["flash_launches"],
        "max_abs_err": report["flash_max_abs_err"],
        "ms": f["ms"], "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
        "bound_by": f["bound_by"], "library_ms": f["library_ms"]})
    m = report["mla_times"]
    kernels.append({
        "name": "paged_decode_attention_mla", "route": "cuda",
        "dispatch": "mla_mma",
        "source": "src/repro_torch/kernels/csrc/paged_decode_mla.cu",
        "replaces": "src/repro/kernels/paged_attention.py:204",
        "launches": report["mla_kernel_launches_main_path"],
        "max_abs_err": report["mla_max_abs_err"],
        "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "bound_ms_f32": m["bound_ms_f32"],
        "bound_by_f32": m["bound_by_f32"], "cuda_core_ms": m["cuda_core_ms"],
        "library_ms": m["library_ms"]})
    report["kernels"] = kernels
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=2))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"serving": report["serving"],
                      "agreement": report["agreement"],
                      "graph_vs_eager": report["graph_vs_eager"]}),
          flush=True)
    l8 = report["llama3_8b"]
    print(json.dumps({"llama3_8b": {
        k: l8[k] for k in ("serving", "agreement", "graph_vs_eager",
                           "serving_peak_gb", "calibration")}}), flush=True)
    print(json.dumps({"mla_serving": report["mla_serving"],
                      "mla_agreement": report["mla_agreement"],
                      "mla_graph_vs_eager": report["mla_graph_vs_eager"],
                      "long_prompt": report["long_prompt"],
                      "flash_times": report["flash_times"],
                      "mla_times": report["mla_times"],
                      "gqa_times": report["gqa_times"],
                      "gqa_bitwise_cases": [report["gqa_bitwise_cases"],
                                            report["gqa_cases"]]}),
          flush=True)
    mt = report["measured_tier"]
    print(json.dumps({"calibration": report["calibration"],
                      "measured_tier": {k: mt[k] for k in (
                          "seconds", "n_warmup", "n_iters", "n_forwards",
                          "weight_quantizations", "base_ms_tier",
                          "base_spread_ms", "groups_beyond_spread")},
                      "fp8_linear": t["fp8_linear"],
                      "plans": report["plan_serving"]["plans"],
                      "fig3a": report["fig3a"],
                      "phase_seconds": report["phase_seconds"]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
