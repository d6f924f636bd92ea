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
   D=64, block 16, up to 160 keys), at D=128, at G 5 and 7, and at D=128
   with G 5, 6 and 12 (4 KV heads), phase 18's configs, and with G 7
   (LLaVA's, at 4 and 8 decode rows: a partial last head group): bf16 and
   scaled fp8-e4m3 KV, window None and 7, a vacant row (all -1 table,
   length 0), NaN in blocks no live page references and in the stale slots
   of live pages (past the length, below the window), two calls bit-equal;
   then time it, the CUDA-core kernel that served the form before, the
   plain version and ``scaled_dot_product_attention`` over gathered K/V at
   the serving shape, at D=128, at D=128 over 4 KV heads of 12
   (starcoder2_15b) and at a long table (2048 keys a row);
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
   the one-shot engine. Every serving step is a CUDA graph: each engine's
   warm-up drain captures the decode step and its prompt's prefill
   bucket, its prefill step is then run once at every other bucket the
   timed drain can take (every row inactive), capturing each, and the
   timed drain only replays (captures per step kind and replays are
   checked and printed); every graphed drain is held bit for bit, on
   every live row of every step, against the same drain with both steps
   run eagerly. Check launch counts (every fused launch through the
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
7. the measured tier over CUDA graphs at ``WallClockGainModel``'s own
   repeats (2 warm-up, 5 timed runs a combo): ``tabulate_measured_gains``
   times a full forward of a (2, 256) prompt under ``impl="kernel"`` for
   every combo of every group, each assignment one graph
   (``launch.steps.GraphedForward``, the counterpart of the reference's
   ``jax.jit`` of ``model.apply``: captured at its first call, replayed
   after, released when the next assignment is built). Run once (two
   runs gave different ET plans: ROADMAP C3), after 5 s of base replays
   that settle the card's clocks, with the
   base captured anew every 120 assignments: each run checks the fp8
   kernels' launches (1 amax + 1 scale_cast + 1 fp8_matmul per fp8
   linear op in each eager warm-up and in each capture, the capture's
   times its replays, plus 1 amax + 1 scale_cast once for each weight
   set to fp8: the weight cache), prints the base replay's spread over 20
   replays, the base captures' medians, their spread and the card's
   clocks after each, the groups whose best combo gains beyond either
   spread, the run's seconds and its ET plan; then the capture placement
   check (captures of the base kept side by side, in one pool and in
   their own, replayed in turns on the host clock and between CUDA
   events, and what a capture costs in each), and paper Fig. 3b on the
   run's plan: the sum of its per-group measured gains against
   its end-to-end measured gain;
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
13. Llama-3.1-8B at its published widths (d_head 128, untied head),
    served at 2 of its 32 layers (the cut is printed): phases 4 and 5 at
    phase 4's cell (every fused launch through ``gqa_mma`` at D 128; the
    fixed plan puts fp8 on the linear ops and the BGEMMs of layer 1),
    phase 17's pipelined drain against the lockstep one, then
    ``calibrate`` over phase 6's batches on all 32 layers' config at the
    largest depth whose probes and backward fit in 75% of the card
    (``fitted_calibration``: the depth, a cut, the predicted and measured
    peaks are printed), with its seconds and peak memory;
14. DeepSeek-V3's dense prefix at full width (three MLA layers, random
    weights): phase 4's cell through the absorbed decode, fused and gather
    (each graphed drain against its eager twin), the one-shot engine and
    the expanded decode, then under a fixed MP plan (fused, gather,
    one-shot); the MLA kernel's launches (all through route ``mla_mma``)
    equal decode steps x fused layers; then a 4096-token prompt as in
    phase 12;
15. prefix caching, priority preemption and chunked prefill in the
    continuous engine (phases 4, 5, 13 and 14 serve with the prefix cache
    off). On llama3_1b at full width, each drain fused and gather, graphed
    (the warm-up drain captures once; the drain, forks and preemptions
    included, only replays) and held bit for bit against its eager twin:
    8 requests sharing a 96-token system prompt plus 32 tokens of their
    own, the last repeating the first's whole prompt (a copy-on-write
    fork), with the prefix cache on and off; six priority-0 requests in a
    pool that holds three, and a priority-1 request at step 10 that
    preempts one (resumed through the prefix cache), against the drain
    without preemption; three decoding requests and a 2048-token prompt at
    step 8 in chunks of 256, one chunk step between decode steps, against
    one chunk. Prefix hits, forks, prefill tokens, TTFT and tokens/s on
    and off, preemptions and the priority-1 TTFT, chunks and decode
    stalls are printed; the twins agree at the near-tie rule and the
    number of bit-equal requests is printed. Then a short shared-prefix
    drain on phase 14's DeepSeek dense prefix (forks of latent blocks,
    ``mla_mma`` over borrowed pages);
16. (phases 4-15 above run the engine's default drain, which is
    pipelined since phase 17 was added);
17. the pipelined drain against the lockstep one (``serve(sync=True)``),
    each graphed after its own warm-up, bit for bit on every token and
    every live row's logits: phase 4's llama3_1b cell fused and gather,
    plain and under phase 5's plan, a steady decode drain (4 requests of
    128 + 128 tokens arriving at once, fused, plain and under the plan),
    phase 15's three drains, and phase 4's cell and the steady drain fused
    on llama3_8b (in phase 13) and on DeepSeek's prefix (after phase 15's
    MLA drain); both drains' tokens/s, wall tokens/s, wall per decode
    step, host time blocked per step, read-back batch mean and peak steps
    in flight are printed. Then the control plane at phase 4's cell: a
    cancel from ``on_token`` (lockstep: exactly 3 tokens kept; pipelined:
    a prefix), ``timeout_steps``, ``shutdown()``, and an ``on_token`` that
    raises (re-raised, the pool's books settled, the engine serves again);
18. the four other dense configs at their published widths, random weights
    (qwen2p5_3b: QKV bias, tied head, G 8; nemotron_4_15b: relu2 MLP,
    layernorm, 256000-entry head, G 6; starcoder2_15b: gelu MLP, layernorm,
    G 12; qwen2p5_32b: G 5, QKV bias), each served at 1 layer
    (``DENSE_CONFIGS``: the script's time limit): phases 4 and 5's
    checks at phase 4's cell (every fused launch through ``gqa_mma``; the
    gather drains without eager twins), the fixed plan on the later half
    of the layers (at 1 layer that is layer 0 with its BGEMMs, which leaves
    no layer to kernel 5: only the plan's gather drains run), peak device
    memory, and qwen2p5_3b calibrated at the
    largest depth that fits, as in phase 13; each model is freed before
    the next;
19. (run after phase 17, on its model) dense-ring serving: phase 4's
    requests on dense per-slot rings (``paged=False``), pipelined,
    lockstep and in chunks of 64, each graphed and held bit for bit
    against its eager twin; pipelined against lockstep bit for bit; dense
    against the paged gather drain and chunks against one chunk at the
    near-tie rule, with the bit-equal requests counted;
20. (run after phase 19) the serving cell's TTFT: phase 4's cell with the
    prefill step eager beside the decode graph (the serving path before
    prefill was graphed) and with every step graphed, one arm each (eager,
    then graphed): TTFT p50 and p99, wall tokens/s, the p99
    decode stall and the device busy share of a profiled drain; then
    ``ServeEngine.ttft`` at 1 and 4 prompts of 128 tokens, graphed and
    eager;
21. (run after phase 20, on its model) serving robustness at phase 4's
    cell, fused, pipelined, every step graphed, on one engine: the fault
    matrix (one fault of each kind at ticks 4-8: every request ends with a
    result, those no fault touched bit-equal to the fault-free drain, the
    others at the near-tie rule; a NaN page flagged through kernel 5 and
    quarantined; consistent books, no quarantined block handed out
    again); two hung steps degrading fused to gather; the guardrail under
    phase 8's ET plan every 4 steps (its MSEs against the plan's budget,
    no breach, tokens bit-equal to the drain without it) and a forced
    breach restoring the unquantized plan mid-drain; the cost of a
    guardrail every 16 steps when nothing breaches (wall tokens/s, in
    turns); a 3-level tau ladder from phase 6's bundle (budgets the ET
    plan's predicted loss MSE / 16, / 4, / 1) under the arrival burst
    (its swaps, the captures each plan's warm-up made) and a ladder of
    one level bit-equal to the fixed plan. Every plan, the shadow step
    and the gather step are captured in warm-ups: no drain captures, and
    every step of every drain is a replay. Phases 2 and 11 also hold the
    GQA and MLA kernels to carrying a NaN in a live key to every output of
    its row and of no other. Throughout the script, a drain without a
    fault injector that reports a kernel fault or a degradation fails it;
22. Mixture-of-Experts and multi-token prediction at full width, random
    weights from a seeded generator, each model freed before the next:
    first kernels 1-3 on the router's form (f32 (512, d_model) by f32
    (E, d_model), f32 out, E 8, 64 and 256) against their plain versions;
    then Moonlight's config (``moonshot_v1_16b_a3b``: 48 MoE layers of 64
    experts top-6, 16 heads over 16 KV heads, 28.1 B parameters; served
    at 8 layers, ``MOONLIGHT_DEPTH``, the cut printed) and
    DeepSeek-V3 at depth 5 (its three dense MLA layers and MoE layers 3
    and 4 of 256 experts top-8 plus one shared, MTP off for serving; the
    cut is printed) at phase 4's cell: fused (every launch through
    ``gqa_mma`` at a head group of 1, or ``mla_mma``; decode steps x
    layers) against its eager twin and its lockstep twin bit for bit, and
    against gather; under a fixed plan (fp8 on every linear op of
    Moonlight's later half; on DeepSeek's last layer, its routed experts
    left in bf16; and the last layer's BGEMMs) fused against gather.
    Fused and gather may part at a routing flip: each MoE layer's top-k
    router probabilities are recorded inside
    every step's graph (``RouterRecorder``); the tokens whose expert set
    differs are printed with their k-th to (k+1)-th probability gap, the
    logits are held within the near-tie bound up to each request's first
    flip or token divergence, a first flip must sit at a gap below 2^-8,
    and a token divergence at a logit near-tie or after such a flip. Then
    each configuration calibrated (DeepSeek with its MTP module, whose
    block takes the last kept layer's kind: dense at the depth the fit
    allows) at the depth ``fitted_calibration`` gives, its groups counted
    by ``core.graphs`` and from the block kinds;
23. Mamba-2 370M and Hymba 1.5B at full width, random weights from a
    seeded generator, each freed before the next (calibrated at full
    depth, served at ``SSM_SERVE_DEPTH`` layers, the cuts printed: 8 of
    Mamba-2's 48; Hymba's first 4 of 32, its global layer 0 and three
    windowed ones): first kernels 1-3
    at their linear shapes (Mamba-2's in_proj N 4384, Hymba's N 6482 at K
    1600 and its tied head N 32001) and kernel 5 at Hymba's heads (D 64,
    5 KV heads of 5) with its 1024-key window over tables longer than it,
    against their plain versions; then phase 4's cell, every drain
    graphed: paged (Hymba fused through ``gqa_mma``, decode steps x
    layers) against its eager twin and its lockstep twin bit for bit,
    Hymba fused against gather, dense rings against the paged drain, and
    under a fixed plan (the later half's linears and the last layer's
    BGEMMs, the SSD products among them) against its eager twin and
    gather; Hymba's 1536-token request chunked at 256 (its windowed layers
    then attend tables longer than the window) fused against gather; each
    configuration calibrated at full depth (seconds, peak memory, groups
    against ``core.graphs``), its ET plan solved, and the paper's Random
    and Prefix baselines (Fig. 2) at the plan's budget with their predicted
    gains and loss MSEs beside the IP's;
24. Whisper-base (the encoder-decoder) at full width and depth and
    LLaVA-NeXT-34B (a prefix of image embeddings) at full width, random
    weights from seeded generators, each freed before the next: first
    kernels 1-3 at both models' linear shapes (Whisper's at M 3000, its
    tied head N 51865, and N 51866 and 51872 beside it; LLaVA's at M 2816
    up to N 64000 and K 20480) against their plain versions, and timed
    beside ``torch._scaled_mm`` (phase 3's checks and timings);
    Whisper calibrated over 4 batches of (2, 1500, 512) frames and (2,
    256) tokens, its peak held against a fit from 1 and 2 layer pairs and
    its groups counted by ``core.graphs`` and from the layer kinds; the
    measured tier over graphed forwards of one request's row of such a
    batch through kernels 1-3 (their launches checked) on the fit's model
    of 2 layer pairs (the cut is printed), Fig. 3b and Fig. 2
    on its ET plan; then
    4 requests of 1500 frames, a 4-token prompt and 64 new tokens through
    ``ServeEngine.generate``, graphed against eager bit for bit, plain (its
    logits also against full forwards) and under the ET plan, with TTFT
    and decode tokens/s. LLaVA at 2 of its 60 layers (the cut printed):
    phase 4's cell on text, fused (every launch through ``gqa_mma`` at G
    7) against its eager twin and its lockstep twin bit for bit and
    against gather and one-shot, plain and under the later-half plan; 4
    one-shot requests of a 576-position image prefix and 128 tokens, 32
    new (the first token's logits against a full forward); then
    ``fitted_calibration`` over batches that carry the prefix;
25. (run after phase 21, before phase 13) training: llama3_1b at full
    width and depth (random weights from a seeded generator), AdamW from
    ``select_optimizer``, 30 steps of (8, 256) synthetic tokens through
    ``Trainer.run``, the mean of the last 5 losses at least 0.5 nat below
    the first; the step's wall and device times (CUDA events), tokens/s,
    the model-FLOP share of the bf16 dense peak (3 x 2 x the forward MACs
    of ``analysis.analytic``) and the peak memory beside its arithmetic.
    Before training, an engine serves the random weights under an fp8
    plan on every linear op. Then the last step's checkpoint restored
    through ``launch.serve``'s ``--ckpt-dir`` path (bit-equal to the
    trained params), calibrated as phase 6 does, its TT plan at tau 0.01
    held to the reference's 5% on the eval loss, and 4 requests served
    under it and under the all-linear plan on that engine (its graphs and
    the weight cache saw every weight change in place) and on a fresh one
    over a copy of the params: tokens equal. Then the first 2 of the 16
    layers at full width: 10 steps checkpointed, resumed at 10 to 20,
    against a straight 20 (bitwise or the largest difference printed,
    bound 2e-2), the newest checkpoint corrupted and the resume walking
    back to the one before; every save and restore timed;
26. (run after phase 5, on its model) serving over a 1x1 (data, model)
    mesh: ``ContinuousBatchingEngine(mesh=make_local_mesh(1, 1))`` over an
    NCCL group of one rank (an in-memory store, no network; a group that
    fails to start fails the run) at phase 4's cell, plain and under
    phase 5's plan: every step graphed with its collectives, every fused
    launch of kernel 5 made through the layers' mesh branch (its counter
    equal to the drain's launches: 1088 plain, 1020 under the plan) and the
    tokens equal, bit for bit, to phases 4 and 5's engine without a mesh;
    the phase's seconds, the weights' bytes per rank and the captures are
    printed, and the process group is destroyed at its end;
27. (run after phase 25) training over a 1x1 (data, model) mesh of one
    NCCL rank (a new group, destroyed at the phase's end):
    ``Trainer(mesh=make_local_mesh(1, 1))`` on llama3_1b at full width and
    depth takes phase 25's first 5 loss-leg steps, each loss and grad norm
    bit-equal to phase 25's; then, at 2 of 16 layers, 10 steps on the mesh
    and its checkpoint (gathered and written by the mesh's origin rank),
    resumed by the single-rank trainer: steps 11-20 bit-equal to phase
    25's straight run. Its seconds are printed beside the card's name and
    power limit (budget 30 s);
28. ``scan_layers`` and the dry run. The scan leg (run after phase 27):
    llama3_1b at full width and depth with its 16 layers stacked into one
    segment (``scan_layers=True``, ``remat=True``, ``remat_group=4``: the
    two-level remat), phase 25's initial weights stacked: the gradients at
    them equal to the unrolled model's leaf for leaf (or the first
    differing leaf and the largest difference printed), then phase 25's
    first 3 steps of (8, 256), each loss and grad norm held to phase 25's
    (bitwise, or the largest difference printed against the 2e-2 bound of
    phase 25's checkpoint leg), the peak memory beside phase 25's; then
    phase 4's cell served through a scan model holding phase 4's weights
    stacked, plain: the step graphs captured (no weight quantized), every
    fused launch through ``gqa_mma``, tokens bit-equal to phase 4's. The
    dry-run leg (run after phase 24, the last model's, so that the host
    trace has every phase since phase 7 to end in): ``python -m
    repro_torch.launch.dryrun`` of starcoder2_15b x
    train_4k and x decode_32k at pod16x16 (one rank of a fake 256-rank
    group, a ``meta`` trace) runs on the host in a process of its own,
    started after phase 7 with no card visible, at the lowest CPU
    priority; its records
    (trace seconds, argument bytes and peak estimate per rank, FLOPs,
    collective bytes by kind, the roofline's three terms against
    ``H100_SXM`` and the bottleneck) are printed here. Then the same
    rank's shard runs for real on the card over a fake 256-rank CUDA group
    (no collective moves data; no value is checked): decode_32k whole,
    train_4k cut to 2 of its 40 layers and 2 of its 8 microbatches of 2
    rows a rank (a global batch of 64) at full width (its whole shard took
    107.6 s a step), which the host also traces; and two FSDP shards of
    qwen2p5_32b (every weight's ``embed`` dim split over ``data`` too,
    gathered at use, gradients reduce-scattered): decode_32k whole (the
    reference's rule takes FSDP and an fp8 KV cache; 8 rows a rank) and
    train_4k cut to 4 layers (two remat groups of 2) and 2 microbatches,
    under ``FSDP_RULES``. Each: one warm-up and one step timed (CUDA
    events) against the roofline terms, and
    ``torch.cuda.max_memory_allocated`` above what was
    allocated before the cell against the meta peak estimate, within 20%
    (the fake group's gathers move nothing, so they cost the card no time).
    Each leg's seconds and their sum are printed (budget 40 s);
29. print the kernel table and the serving and calibration numbers as JSON
    lines, then ``{"ok": true, "device": {...}}`` as the last line. Every
    phase's seconds are printed.

Exits non-zero without a result when no CUDA device is visible or the
package is not beside this script.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()

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
# Hymba is served at its first 4 layers (``SSM_SERVE_DEPTH``); there its
# plain fused and gather logits part by 0.0427, and by 0.0469 for the
# 1536-token prompt over its window, within the attention models' bound
# (``LOGIT_TOL``). Under its ET plan (29 fp8 ops of those layers) they part
# by 0.2969 (PERF.md, an H100): its hybrid layers amplify a one-ulp
# attention difference (``hybrid_drift_probe.py``) and an fp8 rounding
# downstream turns it into whole fp8 steps, past ``LOGIT_TOL_MP``; so
# DeepSeek's MP bound, near-tie margins unchanged
LOGIT_TOL_HYBRID_MP = LOGIT_TOL_MLA_MP
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
# the measured tier's forward: the calibration batches' shape (a (4, 512)
# forward made phase 7's two graphed tabulations take 370 s of the
# script's 1200)
TIER_PROMPT = (2, 256)
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


def card_clocks() -> dict:
    """The card's SM clock (MHz), temperature (C) and power draw (W) as
    ``nvidia-smi`` reads them now (NaN where it cannot)."""
    keys = ("sm_mhz", "temp_c", "power_w")
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,"
                            "temperature.gpu,power.draw",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60)
        vals = r.stdout.strip().splitlines()[0].split(",")
    except (OSError, IndexError, subprocess.SubprocessError):
        vals = []
    out = {}
    for k, v in zip(keys, vals + ["nan"] * len(keys)):
        try:
            out[k] = float(v)
        except ValueError:
            out[k] = float("nan")
    return out


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
               lengths=(MAX_LEN, 100, BS, 0), d: int = D, g: int = G,
               hkv: int = HKV):
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

    k = fill((n_blocks, BS, hkv, d))
    v = fill((n_blocks, BS, hkv, d))
    q = torch.from_numpy(rng.normal(size=(rows, hkv, g, d)).astype(
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


def poison_live(torch, tensors, tables, lengths, row: int) -> None:
    """NaN (byte 0xFF, as ``poison_stale``) in the last live key slot of
    ``row``, every head, in place: the fault injector's ``nan_page``
    reaches attention so. The kernel must carry it to every output of the
    row and of no other row."""
    L = int(lengths[row])
    blk, off = int(tables[row, (L - 1) // BS]), (L - 1) % BS
    for t in tensors:
        t.view(torch.uint8)[blk, off] = 0xFF


def live_nan_reaches_row(torch, name: str, out, clean, row: int) -> None:
    """``out`` (a live key of ``row`` NaN) against ``clean``: that row all
    non-finite, every other row bit-equal."""
    others = [b for b in range(out.shape[0]) if b != row]
    if torch.isfinite(out[row].float()).any():
        raise AssertionError(f"{name}: NaN in a live key of row {row} did "
                             f"not reach every output of the row")
    if not torch.equal(out[others], clean[others]):
        raise AssertionError(f"{name}: NaN in row {row}'s live key changed "
                             f"another row")


# phase 2's shapes for the GQA kernel beside the serving one: llama3_8b's
# d_head, the group sizes of the repo's GQA configs that do not divide 8,
# the D 128 groups of the configs phase 18 serves (qwen2p5_32b G 5,
# nemotron_4_15b G 6, starcoder2_15b G 12 over 4 KV heads), Moonlight's
# multi-head attention in phase 22 (G 1: 16 query heads over 16 KV heads),
# Hymba's in phase 23 (25 query heads over 5 KV heads of D 64) and
# LLaVA's in phase 24 (56 query heads over 8 KV heads of D 128: G 7,
# whose last head group is a partial one: at 4 decode rows groups of 2, the
# last of 1; at 8 rows groups of 4, the last of 3)
GQA_CHECKS = {"serving": dict(d=D, g=G), "d128": dict(d=128, g=G),
              "g5": dict(d=D, g=5), "g7": dict(d=D, g=7),
              "d128_g5": dict(d=128, g=5), "d128_g6": dict(d=128, g=6),
              "d128_g12": dict(d=128, g=12, hkv=4),
              "d128_g1": dict(d=128, g=1, hkv=16),
              "hymba": dict(d=64, g=5, hkv=5),
              "llava": dict(d=128, g=7),
              "llava_rows8": dict(d=128, g=7, lengths=(MAX_LEN, 100, BS, 0,
                                                       160, 152, 144, 136))}
# the shapes the kernel is timed at: the serving cell's mid-drain decode
# step, the same at llama3_8b's d_head, at starcoder2_15b's heads (4 KV
# heads of 12 queries), at Moonlight's (16 KV heads of 1 query) and at
# Hymba's (5 KV heads of 5, D 64; also with its 1024-key window over
# tables of 1552 keys, phase 23's long request at its last step), at
# LLaVA's (8 KV heads of 7, D 128), and a long table (2048 keys a row)
SERVING_KEYS = (160, 152, 144, 136)
GQA_TIMES = {"serving": dict(d=D, lengths=SERVING_KEYS),
             "llava": dict(d=128, g=7, lengths=SERVING_KEYS),
             "d128": dict(d=128, lengths=SERVING_KEYS),
             "d128_g12": dict(d=128, g=12, hkv=4, lengths=SERVING_KEYS),
             "d128_g1": dict(d=128, g=1, hkv=16, lengths=SERVING_KEYS),
             "hymba": dict(d=64, g=5, hkv=5, lengths=SERVING_KEYS),
             "hymba_window": dict(d=64, g=5, hkv=5, lengths=(1552,) * 4,
                                  window=1024),
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
                # a NaN page (the fault injector's) in a live key of row 1
                # must reach that row: the engine's tripwire reads it there
                poison_live(torch, (k, v), bt.cpu(), ln.cpu(), 1)
                live_nan_reaches_row(torch, name, pa.paged_decode_attention(
                    q, k, v, bt, ln, **kw), got, 1)
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
        g, hkv = dims.get("g", G), dims.get("hkv", HKV)
        window = dims.get("window")
        q, k, v, bt, ln = paged_case(torch, 1, torch.bfloat16, 0.0, lengths,
                                     d=d, g=g, hkv=hkv)
        kw = dict(scale=math.sqrt(d), scale_mode="div",
                  score_dtype=torch.bfloat16, probs_dtype=torch.bfloat16,
                  out_dtype=torch.bfloat16, window=window)

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
        kg = kg.repeat_interleave(g, dim=1).contiguous()
        vg = vg.repeat_interleave(g, dim=1).contiguous()
        qs = q.reshape(B, hkv * g, 1, d)
        S = kg.shape[2]
        kpos = torch.arange(S, device="cuda")[None, :]
        mask = kpos < ln[:, None]
        if window is not None:
            mask &= kpos > ln[:, None] - 1 - window
        mask = mask.reshape(B, 1, 1, S)

        def library():
            return F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask)

        rec["library_ms"] = device_ms(torch, library)
        rec["library_ms_eager"] = eager_ms(torch, library, 500)
        # the keys the function must read: those inside each row's window
        live = sum(min(n, window or n) for n in lengths)
        nbytes = (q.numel() * 2 + live * hkv * 2 * d * 2 + bt.numel() * 4
                  + ln.numel() * 4 + B * hkv * g * d * 2)
        ops = 2 * live * hkv * g * 2 * d
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
        rec.update(bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bound_bytes=nbytes, bound_ops=ops, d=d, g=g, hkv=hkv,
                   lengths=list(lengths), window=window,
                   head_group=pa.head_group(g, d, 0, bt.shape[1], BS,
                                            rows=B * hkv,
                                            sms=pa._sm_count(q.device),
                                            route="gqa_mma"))
        log(f"paged_decode_attention GQA {shape} (D {d}, {hkv} KV heads of "
            f"{g}, keys {lengths}, window {window}, "
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


def fp8_check_phase(torch, M: int = ACT[0], weights: dict = WEIGHTS,
                    edge_cases: bool = True) -> dict:
    """amax and scale_cast bitwise, fp8_matmul and fp8_linear within
    MM_TOL of the largest output, on the (M, K) activation and each
    ``weights`` entry (N, K) (K of the first is the activation's width);
    ``edge_cases`` adds hazard values and a GEMM at M 300, no multiple of
    the tile."""
    from repro_torch.kernels import fp8_matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_cast as qc
    from repro_torch.kernels.ref import (amax_ref, fp8_matmul_ref,
                                         scale_cast_ref)
    fp8 = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
    failures, n_bitwise = [], 0
    act = (M, next(iter(weights.values()))[1])
    shapes = {"act": act, **weights}
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
    for dtype in (torch.bfloat16, torch.float32) if edge_cases else ():
        x = randn(torch, act, 20, 60.0, dtype)
        x.view(-1)[:4 * haz.numel()] = haz.repeat(4).to(dtype)
        finite = torch.where(torch.isnan(x), torch.zeros_like(x), x)
        nan_one = finite.clone()
        nan_one[M // 2, 7] = float("nan")
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

    mm_err, mm_rel, lin_rel, gemms = 0.0, 0.0, 0.0, {}
    cases = [(name, M, shape) for name, shape in weights.items()]
    if edge_cases:
        cases.append(("m300", 300, next(iter(weights.values()))))
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
        gemms[name] = {"shape": [M, N, K], "max_abs_err": err,
                       "fp8_linear_max_abs_err": lin, "max_abs_out": top}
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
            lin_rel, "fp8_gemms": gemms}


def fp8_linear_per_call(x, w):
    """``ops.fp8_linear`` as it was before the weight cache: both operands
    quantized on every call (the before number of its time)."""
    from repro_torch.kernels import fp8_matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_cast as qc
    xq, sx = qc.quantize_fp8(ops._pad_to(x, 128))
    wq, sw = qc.quantize_fp8(ops._pad_to(w, 128))
    return mm.fp8_matmul(xq, wq, sx, sw)[:x.shape[0], :w.shape[0]]


def fp8_time_phase(torch, M: int = ACT[0], weights: dict = WEIGHTS) -> dict:
    """Device time per call of each fp8 kernel, its plain version and the
    PyTorch call computing the same function, on the (M, K) activation and
    each (N, K) of ``weights``, as :func:`fp8_check_phase` takes them; the
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

    act = (M, next(iter(weights.values()))[1])
    for i, (name, shape) in enumerate({"act": act, **weights}.items()):
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
    for j, (name, (N, K)) in enumerate(weights.items()):
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
    logits, *inputs)`` to the returned list; a continuous engine's decode
    step appends ``(name, logits, running slots)``. Logits and inputs are
    copied on the device: a CUDA graph's logits are overwritten by its next
    replay, and a step's inputs are the engine's buffers or a graph's
    static inputs, refilled every call. No host sync, so the timed drain
    runs as it would unrecorded, plus a few small copies a step."""
    events, state = [], {}

    def wrap(name, step):
        def recorded(params, caches, *inputs):
            out = step(params, caches, *inputs)
            logits = out[0].clone()
            sched = state.get("sched")
            if name == "decode_step" and sched is not None:
                events.append((name, logits, sorted(sched.running),
                               None if ROUTER is None
                               else ROUTER.rows(logits.shape[0])))
            else:
                events.append((name, logits,
                               *(t.clone() for t in inputs)))
            return out
        return recorded

    for name in names:
        setattr(eng, name, wrap(name, getattr(eng, name)))
    if "prefill_chunk_step" in names:
        tick = eng._prefill_tick

        def ticked(params, pool, sched, now, *rest):
            # who owns each prefilling slot, and the length its prompt
            # (after a preemption: prompt + tokens so far) has
            state["sched"] = sched
            events.append(("tick", {s: (st.request.rid,
                                        st.effective_prompt_len)
                                    for s, st in sched.prefilling.items()}))
            return tick(params, pool, sched, now, *rest)
        eng._prefill_tick = ticked
    return events


def continuous_logits(events, reqs) -> dict:
    """rid -> (n_tokens, V) logits behind each greedy token of a continuous
    drain. A prefill row belongs to the request that owned its slot when
    the tick began, and gives a token only where its chunk ends the
    (effective) prompt: a prompt may take several chunks, start past 0 on
    a prefix hit, or come back longer after a preemption. A decode row
    belongs to the slot's last prefilled request while the slot runs."""
    import torch
    owner, slot_rid, rows = {}, {}, {r.rid: [] for r in reqs}
    for name, *rest in events:
        if name == "tick":
            owner = rest[0]
            continue
        logits, *inputs = rest
        if name == "prefill_chunk_step":
            start, valid = inputs[1].cpu().numpy(), inputs[2].cpu().numpy()
            live = []
            for s in np.nonzero(valid)[0]:
                rid, eff_len = owner[s]
                slot_rid[s] = rid
                if start[s] + valid[s] == eff_len:
                    live.append(s)
        else:
            live = inputs[0]
        for s in live:
            rows[slot_rid[s]].append(logits[s, -1])
    return {rid: torch.stack(r) for rid, r in rows.items()}


def resumed_rids(events, reqs) -> list:
    """Requests that prefilled a prompt longer than their own: resumed
    after a preemption."""
    plen = {r.rid: r.prompt_len for r in reqs}
    return sorted({rid for name, *rest in events if name == "tick"
                   for rid, eff_len in rest[0].values()
                   if eff_len > plen[rid]})


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


def eager_steps(eng) -> None:
    """Swap the engine's serving steps for the closures their graphs
    capture, run eagerly: the yardstick a graphed drain is held to."""
    from repro_torch.launch import steps as st
    if eng.paged:
        eng.decode_step = st.make_paged_decode_step(
            eng.model, mp=eng.mp, paged_attn=eng.paged_attn)
        eng.prefill_chunk_step = st.make_chunked_prefill_step(eng.model,
                                                              mp=eng.mp)
    else:
        eng.decode_step = st.make_decode_step(eng.model, mp=eng.mp)
        eng.prefill_chunk_step = (
            st.make_bucketed_prefill_step if eng.chunk_len is None
            else st.make_dense_chunked_prefill_step)(eng.model, mp=eng.mp)


def prefill_buckets(eng, longest: int) -> list:
    """Every bucket a prefill chunk of an engine can take for prompts of up
    to ``longest`` tokens (resumed ones included)."""
    from repro_torch.serve.engine import prefill_bucket
    top = prefill_bucket(min(longest, eng.chunk_len or longest),
                         eng.chunk_len, eng.min_bucket)
    out, b = [], eng.min_bucket
    while b < top:
        out.append(b)
        b *= 2
    return out + [top]


def warm_buckets(torch, eng, params, longest: int) -> list:
    """Run the engine's prefill step once at every bucket of
    :func:`prefill_buckets`, every row inactive (valid 0: a paged row
    writes the trash block, a dense one nothing): on the card each bucket
    captures here, so the drains after it replay only, as a drain whose
    buckets all came before does. The engine's pool must exist (a drain
    made it). The step runs over the params the engine's drains serve."""
    from repro_torch.serve.cache_pool import host_to_device
    pool, n = eng._pool, eng.n_slots
    buckets = prefill_buckets(eng, longest)
    with torch.no_grad():
        for b in buckets:
            inputs = [np.zeros((n, b), np.int32), np.ones(n, np.int32),
                      np.zeros(n, np.int32)]
            if eng.paged:
                inputs.append(np.full((n, pool.max_blocks), -1, np.int32))
            # the params the engine's drains serve (a mesh engine's: its
            # rank's shard), so the graphs stay bound to them
            eng.prefill_chunk_step(eng._local_params(params), pool.caches,
                                   *(host_to_device(a, eng.device)
                                     for a in inputs))
    return buckets


def kinds(by_kind: dict) -> str:
    return ", ".join(f"{k} {n}" for k, n in sorted(by_kind.items())) or "none"


def run_continuous(torch, model, params, reqs, *, mp=None, paged_attn,
                   route=None, eager=False, warm=None, name="",
                   events_out=None, steps_out=None, sync=False, **engine_kw):
    """Warm-up drain of ``warm`` (default: the first request; on the card
    it captures the decode step's and one prefill bucket's CUDA graphs),
    then the prefill step run at every other bucket the requests can take
    (:func:`warm_buckets`, capturing each), then the recorded drain of
    ``reqs``, which must only replay: every decode step and every prefill
    chunk one replay. Returns (summary, launches in the recorded drain,
    rid -> (tokens, logits)). With ``route``, every launch of the drain
    must have gone through that kernel (``paged_attention.route``).
    ``eager`` swaps in the closures the graphs capture, run eagerly
    (:func:`eager_steps`): the yardstick the graphed drain is held to, bit
    for bit. Both drains are pipelined (the engine's default) unless
    ``sync``. ``engine_kw`` overrides phase 4's engine (``paged=False``
    with ``paged_attn=None``: the dense rings); the prefix cache is off
    unless it turns it on, so phases 4, 5, 13 and 14 serve as they did
    before the engine had one."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import ContinuousBatchingEngine
    kw = dict(n_slots=SERVE["n_slots"],
              max_len=SERVE["prompt_len"] + SERVE["new_tokens"],
              block_size=SERVE["block_size"], prefix_cache=False)
    kw.update(engine_kw)
    if not kw.get("paged", True):
        kw = {k: v for k, v in kw.items() if k not in ("block_size",
                                                       "prefix_cache")}
    eng = ContinuousBatchingEngine(model, mp=mp, paged_attn=paged_attn,
                                   device=DEVICE, **kw)
    if eager:
        eager_steps(eng)
    warm = eng.serve(params, reqs[:1] if warm is None else warm, sync=sync)
    g0 = _graph_counts()
    buckets = warm_buckets(torch, eng, params, max(
        r.prompt_len + r.max_new_tokens for r in reqs))
    warm_caps = dict(warm.counters["graph_captures_by_kind"])
    for k, n in (_graph_counts()[0] - g0[0]).items():
        warm_caps[k] = warm_caps.get(k, 0) + n
    events = record_steps(eng, ("prefill_chunk_step", "decode_step"))
    torch.cuda.synchronize()
    pa.launches = 0
    pa.launches_by_route.update(dict.fromkeys(pa.ROUTES, 0))
    torch.cuda.reset_peak_memory_stats()
    out = eng.serve(params, reqs, sync=sync)
    torch.cuda.synchronize()
    out.counters["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    launches = pa.launches
    label = f"{model.cfg.name} {name}{' ' if name else ''}" \
        f"{paged_attn or 'dense'}" \
        f"{' chunks of ' + str(eng.chunk_len) if eng.chunk_len else ''}" \
        f"{' MP' if mp else ''}{' eager' if eager else ''}" \
        f"{' lockstep' if sync else ''}"
    c = out.counters
    out.counters["warm_graph_captures"] = sum(warm_caps.values())
    out.counters["warm_graph_captures_by_kind"] = warm_caps
    steps = out.n_steps + c["prefill_chunks"]
    if eager or DEVICE == "cpu":
        want = ({}, 0, 0)
    else:
        # the warm-up drain captured decode and its prompt's bucket; the
        # bucket warm-up each other bucket, once
        want = ({"paged_decode" if eng.paged else "decode": 1,
                 eng._prefill_kind: len(buckets)}, 0, steps)
    caps = (warm_caps, c["graph_captures"], c["graph_replays"])
    if caps != want:
        raise AssertionError(f"{label}: graph captures by kind (warm-up), "
                             f"captures and replays in the drain {caps}, "
                             f"expected {want}")
    log(f"{label}: {out.n_steps} decode steps, {c['prefill_chunks']} "
        f"prefill chunks; CUDA graph captures in the warm-ups "
        f"{kinds(warm_caps)} (buckets {buckets}), {c['graph_captures']} in "
        f"the drain, replays {kinds(c['graph_replays_by_kind'])}; "
        f"{launches} paged kernel launches; peak device memory "
        f"{out.counters['peak_device_gb']:.2f} GB")
    if route is not None and pa.launches_by_route[route] != launches:
        raise AssertionError(f"{label}: launches by route "
                             f"{pa.launches_by_route}, expected all {launches}"
                             f" through {route}")
    for r in reqs:
        res = out.results.get(r.rid)
        if res is None or res.status != "ok" or len(res.tokens) != \
                r.max_new_tokens:
            raise AssertionError(f"{label}: request {r.rid} did not "
                                 f"complete")
        if not ((res.tokens >= 0) & (res.tokens < model.cfg.vocab_size)).all():
            raise AssertionError(f"{label}: token out of range")
    logits = continuous_logits(events, reqs)
    if events_out is not None:
        events_out.extend(e for e in events if e[0] == "tick")
    if steps_out is not None:
        steps_out.extend(events)
    return out, launches, {rid: (out.results[rid].tokens, logits[rid])
                           for rid in logits}


def _graph_counts() -> tuple:
    from repro_torch.launch import steps as st
    return st.graph_captures.copy(), st.graph_replays.copy()


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
    c = out.counters
    return {"tokens_per_s": out.tokens_per_s,
            "wall_tokens_per_s": c["wall_tokens_per_s"],
            "ttft_p50_ms": c["ttft_p50_s"] * 1e3,
            "n_decode_steps": out.n_steps,
            "prefill_chunks": c["prefill_chunks"],
            "kernel_launches": c["kernel_launches"],
            "warm_graph_captures": c["warm_graph_captures_by_kind"],
            "graph_captures": c["graph_captures"],
            "graph_replays": c["graph_replays_by_kind"],
            "peak_device_gb": c["peak_device_gb"],
            "peak_blocks_in_use": c.get("peak_blocks_in_use"),
            "peak_kv_bytes": c["peak_kv_bytes"],
            "dense_kv_bytes": c["dense_kv_bytes"]}


def fixed_plan(model):
    """Phase 5's fixed MP plan: fp8 on every linear op of the later half of
    the layers, plus the last layer's attention BGEMMs (which then takes
    the gather path)."""
    from repro_torch.core.mpconfig import MPPlan
    n_layers = model.cfg.n_layers
    first = n_layers // 2
    assignment = {f"layers/{i}/{op}": "fp8_e4m3"
                  for i in range(first, n_layers)
                  for op in ("attn/q_proj", "attn/k_proj", "attn/v_proj",
                             "attn/o_proj", "mlp/gate_proj", "mlp/up_proj",
                             "mlp/down_proj")
                  if op != "mlp/gate_proj" or model.cfg.activation == "swiglu"}
    last = n_layers - 1
    for op in ("qk_matmul", "av_matmul"):
        assignment[f"layers/{last}/attn/{op}"] = "fp8_e4m3"
    return MPPlan(assignment=assignment, groups=[], objective="ET", tau=0.0,
                  budget=0.0, predicted_loss_mse=0.0, predicted_gain=0.0)


# phases 4 and 5's tokens, fused launches and tokens/s by model name, for
# phase 26
SERVED_TOKENS: dict = {}


def serve_phase(torch, model, params, gather_eager=True) -> dict:
    """Phases 4 and 5 at full width on the card (phases 13 and 18 run them
    on the larger configs): every drain graphed, and held bit for bit
    against the same drain with the decode step run eagerly (the gather
    drains only with ``gather_eager``); the fixed plan quantizes the later
    half of the layers."""
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
    if gather_eager:
        _, _, gather_eager_tl = run_continuous(
            torch, model, params, reqs, paged_attn="gather", eager=True)
        graphs["gather"] = graph_vs_eager("gather", gather_tl,
                                          gather_eager_tl, failures)
    oneshot, one_tl = run_oneshot(model, params, reqs)
    for rid in gather_tl:             # both run the same paged prefill
        if not torch.equal(fused_tl[rid][1][0], gather_tl[rid][1][0]):
            raise AssertionError(f"prefill logits of request {rid} differ "
                                 f"between fused and gather")
    plain = dict(tol=LOGIT_TOL, bound=MARGIN_BOUND, failures=failures)
    agree_fg = compare("fused vs gather", fused_tl, gather_tl, **plain)
    agree_go = compare("gather vs one-shot", gather_tl, one_tl, **plain)
    agree_fo = compare("fused vs one-shot", fused_tl, one_tl, **plain)

    # phase 5: a fixed MP plan. At one layer its BGEMMs are layer 0's, so
    # no layer is left to the kernel: the MP fused drains would repeat the
    # MP gather drains, and are not run
    plan = fixed_plan(model)
    first = n_layers // 2
    mp_fused = n_layers > 1
    if mp_fused:
        mp_out, n_mp, mp_tl = run_continuous(torch, model, params, reqs,
                                             mp=plan, paged_attn="fused",
                                             route="gqa_mma")
        log(f"MP plan ({plan.n_quantized} fp8 ops, layers {first}-"
            f"{n_layers - 1}): {mp_out.n_steps} decode steps, {n_mp} kernel "
            f"launches")
        if n_mp == 0 or n_mp != mp_out.n_steps * (n_layers - 1):
            raise AssertionError(f"MP launches {n_mp} != {mp_out.n_steps} "
                                 f"steps x {n_layers - 1} fused layers")
        mp_eager, _, mp_eager_tl = run_continuous(
            torch, model, params, reqs, mp=plan, paged_attn="fused",
            eager=True)
        graphs["mp_fused"] = graph_vs_eager("MP fused", mp_tl, mp_eager_tl,
                                            failures)
    else:
        log(f"MP plan ({plan.n_quantized} fp8 ops, layer 0 with its "
            f"BGEMMs): no layer is left to the kernel, so the MP fused "
            f"drains are not run")
    # the plan's serving path against the one-shot engine, both on the
    # reference attention; then the kernel against it under the plan
    mp_gather, n_mp_gather, mp_gather_tl = run_continuous(
        torch, model, params, reqs, mp=plan, paged_attn="gather")
    if n_mp_gather != 0:
        raise AssertionError(f"MP gather path launched the kernel "
                             f"{n_mp_gather} times")
    from repro_torch.quant import weight_cache
    kept, of = weight_cache.nbytes(torch.device(DEVICE))
    log(f"weight cache after the MP drains: {kept / 1e9:.3f} GB of fp8 "
        f"codes and scales for {of / 1e9:.3f} GB of bf16 weights "
        f"({kept / max(of, 1):.3f}x)")
    if gather_eager:
        _, _, mp_gather_eager_tl = run_continuous(
            torch, model, params, reqs, mp=plan, paged_attn="gather",
            eager=True)
        graphs["mp_gather"] = graph_vs_eager("MP gather", mp_gather_tl,
                                             mp_gather_eager_tl, failures)
    _, mp_one_tl = run_oneshot(model, params, reqs, mp=plan)
    agree = {"fused_vs_gather": agree_fg, "gather_vs_oneshot": agree_go,
             "fused_vs_oneshot": agree_fo,
             "mp_gather_vs_mp_oneshot": compare(
                 "MP gather vs MP one-shot", mp_gather_tl, mp_one_tl,
                 **plain)}
    serving = {"fused": serving_numbers(fused),
               "fused_eager": serving_numbers(eager),
               "gather": serving_numbers(gather),
               "oneshot": {"tokens_per_s": oneshot.tokens_per_s,
                           "ttft_ms": oneshot.ttft_s * 1e3},
               "mp_gather": serving_numbers(mp_gather)}
    if mp_fused:
        agree["mp_fused_vs_mp_gather"] = compare(
            "MP fused vs MP gather", mp_tl, mp_gather_tl, tol=LOGIT_TOL_MP,
            bound=MARGIN_BOUND_MP, failures=failures)
        serving.update(mp_fused=serving_numbers(mp_out),
                       mp_fused_eager=serving_numbers(mp_eager))
    if failures:
        raise AssertionError("; ".join(failures))
    SERVED_TOKENS[model.cfg.name] = {
        "plain": ({rid: tl[0] for rid, tl in fused_tl.items()}, n_fused,
                  fused.tokens_per_s)}
    if mp_fused:
        SERVED_TOKENS[model.cfg.name]["mp"] = (
            {rid: tl[0] for rid, tl in mp_tl.items()}, n_mp,
            mp_out.tokens_per_s)
        log(f"{model.cfg.name} tokens/s graphed / eager: fused "
            f"{fused.tokens_per_s:.1f} / {eager.tokens_per_s:.1f}, MP fused "
            f"{mp_out.tokens_per_s:.1f} / {mp_eager.tokens_per_s:.1f}")
    else:
        log(f"{model.cfg.name} tokens/s graphed / eager: fused "
            f"{fused.tokens_per_s:.1f} / {eager.tokens_per_s:.1f}")
    return {
        "kernel_launches_main_path": n_fused,
        "weight_cache_gb": kept / 1e9, "weight_cache_of_bf16_gb": of / 1e9,
        "graph_vs_eager": graphs,
        "mp_plan": {"fp8_ops": plan.n_quantized, "layers": [first,
                                                             n_layers - 1],
                    "fused_layers": n_layers - 1},
        "agreement": agree, "serving": serving}


# ---------------------------------------------------------------------------
# phase 26: serving over a (data, model) mesh
# ---------------------------------------------------------------------------

# the time budgets this script is held to by its maintainers (printed, not
# enforced: the run's own limit is 1200 s)
MESH_PHASE_BUDGET_S = 45.0
SCRIPT_BUDGET_S = 900.0


def mesh_phase(torch, model, params) -> dict:
    """Phase 26: phase 4's cell and phase 5's plan through the continuous
    engine over a 1x1 mesh of one NCCL rank, against phases 4 and 5's
    engine without a mesh (tokens bit for bit, the same fused launches, all
    made through the mesh branch)."""
    import torch.distributed as dist
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import make_requests
    from repro_torch.launch.steps import release_mesh_steps
    from repro_torch.nn.spec import flatten_paths
    from repro_torch.serve.parallel import shard_serving_params
    t0 = time.perf_counter()
    mesh = make_local_mesh(1, 1, device=DEVICE)
    try:
        backend = dist.get_backend()
        if DEVICE == "cuda" and backend != "nccl":
            raise AssertionError(f"mesh process group on {backend}, not "
                                 f"NCCL")
        local = shard_serving_params(model, params, mesh)
        rank_bytes = sum(t.numel() * t.element_size()
                         for t in flatten_paths(local).values())
        reqs = make_requests(model.cfg.vocab_size, SERVE["requests"],
                             SERVE["prompt_len"], SERVE["new_tokens"],
                             SERVE["arrival_every"])
        ref = SERVED_TOKENS[model.cfg.name]
        out = {"backend": backend, "mesh": [1, 1],
               "weights_bytes_per_rank": rank_bytes}
        for name, mp in (("plain", None), ("mp", fixed_plan(model))):
            res, launches, tl = run_continuous(
                torch, model, params, reqs, mp=mp, paged_attn="fused",
                route="gqa_mma", name="mesh 1x1", mesh=mesh)
            c = res.counters
            want_tokens, want_launches, want_tps = ref[name]
            if c["mesh"] != {"data": 1, "model": 1, "shard_pages": False}:
                raise AssertionError(f"mesh {name}: layout {c['mesh']}")
            if launches != want_launches or c["mesh_kernel_launches"] != \
                    launches or (launches == 0 and DEVICE == "cuda"):
                raise AssertionError(
                    f"mesh {name}: {launches} kernel launches, "
                    f"{c['mesh_kernel_launches']} through the mesh branch; "
                    f"the engine without a mesh made {want_launches}")
            differ = [rid for rid in want_tokens
                      if not np.array_equal(tl[rid][0], want_tokens[rid])]
            if differ:
                raise AssertionError(f"mesh {name}: tokens of requests "
                                     f"{differ} differ from the engine "
                                     f"without a mesh")
            out[name] = {
                "kernel_launches": launches,
                "mesh_kernel_launches": c["mesh_kernel_launches"],
                "decode_steps": res.n_steps,
                "warm_graph_captures_by_kind":
                    c["warm_graph_captures_by_kind"],
                "graph_captures": c["graph_captures"],
                "graph_replays": c["graph_replays"],
                "tokens_equal_no_mesh": True,
                "tokens_per_s": res.tokens_per_s,
                "tokens_per_s_no_mesh": want_tps,
                "wall_tokens_per_s": c["wall_tokens_per_s"]}
            log(f"mesh 1x1 {name}: {launches} kernel launches, all through "
                f"the mesh branch; tokens of all {len(want_tokens)} requests "
                f"equal to the engine without a mesh; captures in the "
                f"warm-ups {kinds(c['warm_graph_captures_by_kind'])}, "
                f"{c['graph_replays']} replays; {res.tokens_per_s:.1f} "
                f"tokens/s against {want_tps:.1f} without a mesh "
                f"({res.tokens_per_s / want_tps:.3f}x)")
    finally:
        # the mesh steps' graphs hold the group's collectives: they go first
        release_mesh_steps(model)
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 26 (mesh 1x1 over {backend}): {out['seconds']:.1f} s "
        f"(budget {MESH_PHASE_BUDGET_S:.0f} s), weights "
        f"{rank_bytes / 1e9:.3f} GB per rank"
        f"{'; ' + card_line() if DEVICE == 'cuda' else ''}")
    return out


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


# the base forward's spread: replays of its graph, timed as the tier times
# a combo (host clock around the replay and a synchronize)
SPREAD_RUNS = 20
# every combo is a capture of its own, so the noise a gain must beat is
# that of one capture against the next: the base forward is captured anew
# every BASE_RECAPTURE_EVERY assignments of a tabulation and timed as a
# combo is (4 more captures over the 578 assignments)
BASE_RECAPTURE_EVERY = 120
# seconds of base replays before a tabulation: a first tabulation that
# started on a card idle since calibration timed its base 0.49 ms (7%)
# below every later capture of it, so every combo seemed to lose
TIER_SETTLE_S = 5.0
# the reference's repeats for Fig. 3b (benchmarks/fig3_validation.py)
FIG3B_REPEATS = dict(n_warmup=2, n_iters=7)


def forward_inputs(prompt) -> tuple:
    """A forward's inputs after the params: a decoder-only model's prompt
    tensor, or an encoder-decoder's (tokens, frames)."""
    return prompt if isinstance(prompt, tuple) else (prompt,)


def prompt_shapes(prompt) -> str:
    return " + ".join(str(tuple(t.shape)) for t in forward_inputs(prompt))


class TierForwards:
    """The measured tier's ``run_factory`` over graphed forwards
    (``launch.steps.GraphedForward``, the counterpart of the reference's
    ``jax.jit(lambda p, t: model.apply(p, t, ctx))``): each assignment's
    first call runs the forward eagerly and captures it, later calls
    replay; the previous assignment's graph is released when the next is
    built (a graph of a forward holds its activations). The first
    forward built (the base) is kept until :meth:`close`, and every later
    capture allocates in its memory pool, so a released graph's blocks
    serve the next capture instead of being freed and allocated again.
    With ``recapture_every``, before every such number of assignments the
    base forward is captured anew and timed at the tier's repeats
    (``base_recaptures``: each capture's timed runs, in s); the card's
    clocks are read after the base's timed runs and after each capture
    anew (``clocks``). Counts, for
    the launch check, every call's fp8 linear ops in eager warm-ups and
    every capture's recorded launches times its replays."""

    def __init__(self, torch, model, params, prompt, linear: set,
                 recapture_every: int = 0):
        self.torch, self.model, self.params = torch, model, params
        self.inputs, self.linear = forward_inputs(prompt), linear
        self.recapture_every = recapture_every
        self.times: dict = {}
        self.base_recaptures: list = []
        self.clocks: list = []
        self.n_assignments = 0
        self.fp8_weights: set = set()
        self.warm = 0                  # fp8 linear ops in eager warm-ups
        self.replayed = {"amax": 0, "scale_cast": 0, "fp8_matmul": 0}
        self.recorded_per_op = True    # every capture records 1+1+1 per op
        self.n_captures = 0
        self.current = None
        self.keeper = None

    def _account(self, cur) -> None:
        fwd, n_fp8 = cur
        rec = fwd.step.recorded()
        for k in self.replayed:
            self.replayed[k] += rec.get(k, 0) * fwd.step.replays
            if fwd.step.captures:
                self.recorded_per_op &= rec.get(k, 0) == n_fp8
        self.n_captures += fwd.step.captures
        fwd.release()

    def release(self) -> None:
        cur, self.current = self.current, None
        if cur is not None and cur is not self.keeper:
            self._account(cur)

    def close(self) -> None:
        self.release()
        keeper, self.keeper = self.keeper, None
        if keeper is not None:
            self._account(keeper)

    def _recapture_base(self) -> None:
        from repro_torch.core.timegain import WallClockGainModel
        runs: list = []
        run = self._graph({}, runs)
        for _ in range(WallClockGainModel.n_warmup):
            run()
        runs.clear()
        for _ in range(WallClockGainModel.n_iters):
            run()
        self.base_recaptures.append(runs)
        self.clocks.append(card_clocks())

    def __call__(self, assignment):
        if self.recapture_every and self.n_assignments == 1:
            self.clocks.append(card_clocks())   # the base's runs are done
        if self.recapture_every and self.n_assignments and \
                self.n_assignments % self.recapture_every == 0:
            self._recapture_base()
        self.n_assignments += 1
        key = tuple(sorted(n for n, f in assignment.items() if f != "bf16"))
        return self._graph(assignment, self.times.setdefault(key, []))

    def _graph(self, assignment, times: list):
        from repro_torch.launch.steps import GraphedForward
        from repro_torch.quant.qops import QuantContext
        torch = self.torch
        self.release()
        ctx = QuantContext(mode="mp", mp=dict(assignment), impl="kernel")
        fp8 = [n for n, f in assignment.items() if f != "bf16"]
        n_fp8 = sum(1 for n in fp8 if n in self.linear)
        self.fp8_weights.update(n for n in fp8 if n in self.linear)
        pool = None if self.keeper is None else self.keeper[0].step.pool()
        fwd = GraphedForward(self.model, ctx, shared_pool=pool)
        self.current = (fwd, n_fp8)
        if self.keeper is None:
            self.keeper = self.current

        def run():
            t0 = time.perf_counter()
            first = fwd.step.captures == 0
            fwd(self.params, *self.inputs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if first:
                self.warm += n_fp8
        return run


# the capture placement check: captures of the base forward kept side by
# side in each pool layout, replayed in turns for as many rounds
PLACEMENT_CAPTURES = 4
PLACEMENT_ROUNDS = 20


def capture_placement(torch, model, params, prompt) -> dict:
    """Whether a replay's time belongs to its capture or to the clock: the
    base forward captured ``PLACEMENT_CAPTURES`` times in the first
    capture's memory pool (as the tier captures) and as many times in pools
    of their own, all kept, then replayed in turns for
    ``PLACEMENT_ROUNDS`` rounds, each replay timed on the host clock as the
    tier times it and between CUDA events. Captures whose medians differ
    beyond one capture's own replays differ by their capture (memory
    placement); a trend over the rounds that every capture shares is
    drift. Then, per layout, as many captures built, replayed once and
    released in turn, as the tier builds them, each timed: what sharing
    the pool saves a capture."""
    from repro_torch.launch.steps import GraphedForward
    from repro_torch.quant.qops import QuantContext
    ctx = QuantContext(mode="mp", mp={}, impl="kernel")
    layouts = ("one pool", "own pools")

    def build(keep):
        pool = keep.step.pool() if keep is not None else None
        fwd = GraphedForward(model, ctx, shared_pool=pool)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd(params, prompt)
        torch.cuda.synchronize()
        return fwd, (time.perf_counter() - t0) * 1e3

    kept = {m: [] for m in layouts}
    for _ in range(PLACEMENT_CAPTURES):
        for m in layouts:
            keep = kept[m][0] if m == "one pool" and kept[m] else None
            kept[m].append(build(keep)[0])
    host = {m: [[] for _ in range(PLACEMENT_CAPTURES)] for m in layouts}
    dev = {m: [[] for _ in range(PLACEMENT_CAPTURES)] for m in layouts}
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    for _ in range(PLACEMENT_ROUNDS):
        for i in range(PLACEMENT_CAPTURES):
            for m in layouts:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e0.record()
                kept[m][i](params, prompt)
                e1.record()
                torch.cuda.synchronize()
                host[m][i].append((time.perf_counter() - t0) * 1e3)
                dev[m][i].append(e0.elapsed_time(e1))
    for fwds in kept.values():
        for fwd in fwds:
            fwd.release()
    churn = {}
    for m in layouts:
        keep, ms = None, []
        for i in range(PLACEMENT_CAPTURES + 1):
            fwd, t = build(keep if m == "one pool" else None)
            if i == 0:
                keep = fwd
                continue
            ms.append(t)
            fwd.release()
        keep.release()
        churn[m] = ms
    out = {}
    for m in layouts:
        rec = {}
        for clock, t in (("host", host[m]), ("device", dev[m])):
            t = np.array(t)                       # (capture, round)
            med = np.median(t, axis=1)
            k = max(1, PLACEMENT_ROUNDS // 4)
            rec[clock] = {
                "medians_ms": med.tolist(),
                "across_captures_ms": float(med.max() - med.min()),
                "within_capture_ms": float(np.median(t.max(1) - t.min(1))),
                "drift_ms": float(np.median(t[:, -k:]) -
                                  np.median(t[:, :k]))}
        rec["capture_ms"] = churn[m]
        out[m] = rec
        h, d = rec["host"], rec["device"]
        log(f"capture placement, {m}: {PLACEMENT_CAPTURES} captures of the "
            f"base forward replayed in turns, {PLACEMENT_ROUNDS} rounds: "
            f"host-clock medians {[round(x, 3) for x in h['medians_ms']]} "
            f"ms (across captures {h['across_captures_ms']:.3f}, within one "
            f"capture {h['within_capture_ms']:.3f}, drift "
            f"{h['drift_ms']:+.3f}); device (CUDA events) "
            f"{[round(x, 3) for x in d['medians_ms']]} ms (across "
            f"{d['across_captures_ms']:.3f}, within "
            f"{d['within_capture_ms']:.3f}, drift {d['drift_ms']:+.3f}); a "
            f"capture built and released in turn "
            f"{np.median(churn[m]):.1f} ms (median of {len(churn[m])})")
    return out


def settle(torch, model, params, prompt, seconds: float) -> int:
    """Replays of the base forward's graph for ``seconds``, so that a
    tabulation's first timings meet the card at the clocks its sustained
    load runs at; returns the number of replays."""
    from repro_torch.launch.steps import GraphedForward
    from repro_torch.quant.qops import QuantContext
    fwd = GraphedForward(model, QuantContext(mode="mp", mp={},
                                             impl="kernel"))
    t0, n = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        fwd(params, *forward_inputs(prompt))
        n += 1
        if n % 16 == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    fwd.release()
    return n


def tier_run(torch, model, params, bundle, prompt, linear, k: int) -> dict:
    """One tabulation of the measured tier at ``WallClockGainModel``'s own
    repeats over graphed forwards, with the base forward captured anew
    every ``BASE_RECAPTURE_EVERY`` assignments; its launch check, the base
    replay's spread over ``SPREAD_RUNS`` replays of one capture and the
    spread of the base captures' medians, the groups gaining beyond each,
    and the ET plan it gives."""
    from repro_torch.core.pipeline import tabulate_measured_gains
    from repro_torch.core.timegain import WallClockGainModel
    from repro_torch.kernels import fp8_matmul as mm
    from repro_torch.kernels import quant_cast as qc
    from repro_torch.quant import weight_cache
    n_warmup = WallClockGainModel.n_warmup
    n_iters = WallClockGainModel.n_iters
    n_settle = settle(torch, model, params, prompt, TIER_SETTLE_S)
    fwds = TierForwards(torch, model, params, prompt, linear,
                        recapture_every=BASE_RECAPTURE_EVERY)
    weight_cache.clear()              # every run quantizes its weights once
    torch.cuda.synchronize()
    qc.launches.update(amax=0, scale_cast=0)
    mm.launches = 0
    wq0 = weight_cache.quantizations
    t0 = time.perf_counter()
    key = tabulate_measured_gains(bundle, fwds, objective="ET",
                                  n_warmup=n_warmup, n_iters=n_iters)
    fwds.close()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"amax": qc.launches["amax"],
              "scale_cast": qc.launches["scale_cast"],
              "fp8_matmul": mm.launches}
    n_wq = weight_cache.quantizations - wq0
    want = {"amax": fwds.warm + fwds.replayed["amax"] + n_wq,
            "scale_cast": fwds.warm + fwds.replayed["scale_cast"] + n_wq,
            "fp8_matmul": fwds.warm + fwds.replayed["fp8_matmul"]}
    times = fwds.times
    n_recap = len(fwds.base_recaptures)
    n_runs = sum(len(v) for v in times.values()) + \
        n_recap * (n_warmup + n_iters)
    log(f"measured tier run {k} ({n_warmup} warm-up + {n_iters} timed runs "
        f"a combo, CUDA graph replays): {len(times)} assignments and "
        f"{n_recap} more captures of the base, {fwds.n_captures} captures, "
        f"{n_runs} forwards of {prompt_shapes(prompt)} in "
        f"{seconds:.1f} s; launches {counts} (expected {want}: 1+1+1 per "
        f"fp8 linear in each eager warm-up ({fwds.warm}), the captures' "
        f"recorded launches x their replays {fwds.replayed}, plus 1 amax + "
        f"1 scale_cast for each of the {n_wq} weights, quantized once)")
    if counts != want or counts["fp8_matmul"] == 0:
        raise AssertionError(f"fp8 kernel launches {counts} != {want}")
    if not fwds.recorded_per_op:
        raise AssertionError("a capture did not record 1 amax + 1 "
                             "scale_cast + 1 fp8_matmul per fp8 linear op")
    if DEVICE != "cpu" and fwds.n_captures != len(times) + n_recap:
        raise AssertionError(f"{fwds.n_captures} captures for "
                             f"{len(times)} assignments and {n_recap} "
                             f"base captures")
    if n_wq != len(fwds.fp8_weights):
        raise AssertionError(f"{n_wq} weight quantizations for "
                             f"{len(fwds.fp8_weights)} weights set to fp8")
    n_captures = fwds.n_captures
    base_s = np.array(times[()]) * 1e3          # the tier's own base runs
    spread_s: list = []
    base = fwds._graph({}, spread_s)
    for _ in range(n_warmup):
        base()
    spread_s.clear()
    for _ in range(SPREAD_RUNS):
        base()
    fwds.close()
    spread = np.array(spread_s) * 1e3
    base_spread = float(spread.max() - spread.min())
    log(f"base forward (all bf16) run {k}: tier median "
        f"{np.median(base_s):.3f} ms; {spread.size} replays min "
        f"{spread.min():.3f} median {np.median(spread):.3f} max "
        f"{spread.max():.3f} ms (spread {base_spread:.3f} ms)")
    # the tier's own base and its captures anew, each a median of n_iters
    capture_meds = [float(np.median(base_s))] + [
        float(np.median(r)) * 1e3 for r in fwds.base_recaptures]
    across = max(capture_meds) - min(capture_meds)
    clocks = ", ".join(f"{c['sm_mhz']:.0f} MHz {c['temp_c']:.0f} C "
                       f"{c['power_w']:.0f} W" for c in fwds.clocks)
    log(f"base forward run {k}: {len(capture_meds)} captures in the "
        f"tabulation (every {BASE_RECAPTURE_EVERY} assignments, after "
        f"{n_settle} replays in {TIER_SETTLE_S:.0f} s to settle the card), "
        f"medians {', '.join(f'{m:.3f}' for m in capture_meds)} ms: spread "
        f"across captures {across:.3f} ms, "
        f"{across / max(base_spread, 1e-9):.1f}x one capture's replay "
        f"spread; the card after each: {clocks}")
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
    best = np.array([r["best_ms"] for r in rows])
    n_beyond = int((best > base_spread).sum())
    n_beyond_across = int((best > across).sum())
    log(f"{n_beyond} of {len(rows)} groups gain beyond the base replay's "
        f"spread ({base_spread:.3f} ms) with their best combo; "
        f"{int((all_fp8 > base_spread).sum())} with the all-fp8 combo; "
        f"{n_beyond_across} beyond the spread across captures "
        f"({across:.3f} ms)")
    plan = bundle.solve(TAU, "ET")
    log(f"measured tier run {k}: ET plan at tau {TAU}: "
        f"{plan.n_quantized} ops fp8 [{plan.meta['gain_tier']}], predicted "
        f"gain {plan.predicted_gain * 1e3:.3f} ms; the tier took "
        f"{seconds:.1f} s")
    log(f"measured tier run {k}: ET assignment "
        f"{sorted(plan.assignment)}")
    return {"seconds": seconds, "launches": counts, "n_forwards": n_runs,
            "n_captures": n_captures, "n_warmup": n_warmup,
            "n_iters": n_iters, "weight_quantizations": n_wq,
            "base_spread_ms": base_spread, "groups_beyond_spread": n_beyond,
            "base_capture_medians_ms": capture_meds,
            "base_capture_clocks": fwds.clocks, "settle_replays": n_settle,
            "spread_across_captures_ms": across,
            "groups_beyond_spread_across_captures": n_beyond_across,
            "base_ms_tier": float(np.median(base_s)),
            "base_ms_runs": spread.tolist(), "groups": rows,
            "et_plan": plan, "fwds": fwds}


def fig3b(torch, fwds, plan) -> dict:
    """Paper Fig. 3b (``benchmarks/fig3_validation.py:43-66``): the sum of
    the ET plan's per-group measured gains against the plan's end-to-end
    measured gain, both from graphed replays at the reference's repeats
    (``fwds``: a fresh :class:`TierForwards`)."""
    from repro_torch.core.timegain import WallClockGainModel
    gm = WallClockGainModel(run_factory=fwds, **FIG3B_REPEATS)
    total, n = 0.0, 0
    for group in plan.groups:
        sub = {op: plan.assignment[op] for op in group
               if op in plan.assignment}
        if not sub:
            continue
        total += gm.base_time() - gm._time(sub)
        n += 1
    full = gm.base_time() - gm._time(plan.assignment)
    fwds.close()
    log(f"Fig. 3b: sum of the ET plan's {n} per-group gains "
        f"{total * 1e3:+.3f} ms against its end-to-end gain "
        f"{full * 1e3:+.3f} ms (base {gm.base_time() * 1e3:.3f} ms, "
        f"{FIG3B_REPEATS['n_warmup']} warm-up + {FIG3B_REPEATS['n_iters']} "
        f"timed replays each)")
    return {"sum_group_gains_ms": total * 1e3, "end_to_end_gain_ms":
            full * 1e3, "groups_quantized": n,
            "base_ms": gm.base_time() * 1e3}


def measured_phase(torch, model, params, bundle) -> dict:
    """Phase 7: the measured wall-clock tier through the fp8 kernels over
    graphed forwards, at ``WallClockGainModel``'s own repeats, run
    once (two runs gave different ET plans: ROADMAP C3), then
    the capture placement check and Fig. 3b on its ET plan. The kernels'
    launch counters are set to 0 just before the tabulation and read just
    after."""
    g = torch.Generator(device=DEVICE).manual_seed(7)
    prompt = torch.randint(0, model.cfg.vocab_size, TIER_PROMPT, generator=g,
                           device=DEVICE, dtype=torch.int32)
    linear = {op.name for op in bundle.sens.ops if op.kind == "linear"}
    run = tier_run(torch, model, params, bundle, prompt, linear, 1)
    placement = capture_placement(torch, model, params, prompt)
    fig = fig3b(torch, TierForwards(torch, model, params, prompt, linear),
                run["et_plan"])
    out = {k: v for k, v in run.items() if k not in ("et_plan", "fwds")}
    out.update(et_n_fp8=run["et_plan"].n_quantized,
               et_assignment=sorted(run["et_plan"].assignment), fig3b=fig,
               placement=placement)
    return out


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
# phase 13 serves llama3_8b at 2 of its 32 layers (the script's time
# limit; 16 before phase 24 was added, 8 before phase 27, 4 before 28)
LLAMA8B_DEPTH = 2
# of the card's memory a calibration may take: a linear fit of the peak
# over depths 1 and 3 underestimates deeper ones (depth 22 needed more than
# 81.8 GB where 1 -> 2 layers predicted 71.3 GB, on an H100)
CAL_MEMORY_SHARE = 0.75


def expected_groups(cfg) -> int:
    """The partition's group count, counted from the block kinds and not
    from ``core.graphs``: a dense block (``attn`` or ``mla``) makes 4
    groups (the attention's projections and BGEMMs; o_proj; gate and up;
    down), an MoE block 5 (the same with the router on its own) or 3 with
    shared experts (the router's fan-out and the shared path join one
    group), and lm_head 1; the MTP block is in none."""
    moe = 3 if cfg.moe is not None and cfg.moe.n_shared_experts else 5
    return 1 + sum(moe if i in cfg.moe_layers else 4
                   for i in range(cfg.n_layers))


def _layer_bytes(cfg) -> tuple:
    """(bytes of each layer's own weights, bytes of the MTP module at each
    depth d (its block takes layer d-1's kind; 0 without MTP))."""
    from repro_torch.models.lm import LM
    from repro_torch.nn.spec import param_bytes
    model = LM(cfg)                   # specs only: no weight is made
    w = [param_bytes(model._layer_specs(cfg.layer_signature(i), "x"))
         for i in range(cfg.n_layers)]
    if not cfg.mtp_depth:
        return w, [0] * (cfg.n_layers + 1)
    head = 2 * cfg.d_model * cfg.d_model * 2 + cfg.d_model * 4
    return w, [0] + [head + w[d - 1] for d in range(1, cfg.n_layers + 1)]


def fitted_calibration(torch, arch: str, batches, n_layers=None) -> dict:
    """Algorithm 1's ``calibrate`` on ``arch``'s configuration (its first
    ``n_layers`` layers and its MTP module) over phase 6's batches at the
    largest depth whose probes and backward fit in ``CAL_MEMORY_SHARE`` of
    the card. Each depth is a model of its own, its random weights drawn
    from a seeded generator (the serving model is freed first). The fit:
    the peak at depth d is F + sum over the kept layers (and the MTP block,
    one more layer of the last kept kind) of their own weights w_i plus a
    per-kind cost c_k of probes, gradients and activations. F and c_k come
    from the peaks at two depths whose added layers are of kind k; a kind
    whose two depths cannot fit even at c_k's floor (an f32 probe and an
    f32 gradient of every weight, 4 w_i) is not measured, and the depth
    stops before its first layer (printed as a cut). Raises if the
    measured peak at the chosen depth exceeds the budget."""
    from repro_torch.core.pipeline import AMPOptions, build_groups, calibrate
    from repro_torch.hw.profiles import H100_SXM
    from repro_torch.models.registry import build_model, depth_overrides, \
        get_config

    def cut_cfg(depth):
        return get_config(arch, **depth_overrides(arch, depth,
                                                  keep_mtp=True))
    cfg = cut_cfg(n_layers or get_config(arch).n_layers)
    n = cfg.n_layers
    kind = [cfg.layer_signature(i) for i in range(n)]
    w, w_mtp = _layer_bytes(cfg)
    total = torch.cuda.get_device_properties(0).total_memory
    budget = CAL_MEMORY_SHARE * total

    def run(depth):
        model = build_model(cut_cfg(depth))
        params = model.init(torch.Generator(device=DEVICE).manual_seed(0),
                            DEVICE)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        bundle = calibrate(model, params, batches, AMPOptions(hw=H100_SXM))
        torch.cuda.synchronize()
        out = (model, bundle, time.perf_counter() - t0,
               torch.cuda.max_memory_allocated())
        del params
        gc.collect()
        return out

    cost: dict = {}                   # kind -> c_k
    fixed = None
    peaks = {}

    def layers_need(depth) -> float:
        layers = sum(w[i] + cost[kind[i]] for i in range(depth))
        mtp = w_mtp[depth] + (cost[kind[depth - 1]] if cfg.mtp_depth else 0)
        return layers + mtp

    def need(depth) -> float:
        return fixed + layers_need(depth)

    depth, cut = n, None
    for j in range(n):
        k = kind[j]
        if k in cost:
            continue
        run_len = next((r for r in range(n - j) if kind[j + r] != k), n - j)
        d1, d2 = j + 1, j + min(run_len, 3)
        if d2 == d1:
            depth, cut = j, f"a single layer of kind {k}: no second depth"
            break
        if fixed is not None:
            cost[k] = 4 * w[j]
            lb = need(d2)
            del cost[k]
            if lb > budget:
                depth = j
                cut = (f"layers {j}-{d2 - 1} of kind {k} ({w[j] / 1e9:.2f} GB "
                       f"of weights each) need at least {lb / 1e9:.1f} GB at "
                       f"4x their weights in f32 probes and gradients, over "
                       f"the {budget / 1e9:.1f} GB budget")
                break
        p1, p2 = run(d1)[3], run(d2)[3]
        peaks[d1], peaks[d2] = p1, p2
        added = sum(w[i] for i in range(d1, d2)) + w_mtp[d2] - w_mtp[d1]
        cost[k] = max(0.0, (p2 - p1 - added) / (d2 - d1))
        if fixed is None:
            fixed = p1 - layers_need(d1)
    if depth == 0:
        raise AssertionError(f"{cfg.name}: no depth can be calibrated: {cut}")

    def fit_depth(limit) -> int:
        d = limit
        while d > 1 and need(d) > budget:
            d -= 1
        return d

    # the peak grows faster than the first depths show (their peak is the
    # head's transient, a deep stack's its layers' probes and gradients),
    # so the first kind's cost is refit from a third depth near the one
    # the first two predict
    k0 = kind[0]
    first_run = next((r for r in range(n) if kind[r] != k0), n)
    d2 = max(peaks)
    if first_run > d2 and len([d for d in peaks if d <= first_run]) == 2:
        d3 = min(first_run, max(d2 + 1, int(0.75 * fit_depth(depth))))
        if d3 > d2:
            peaks[d3] = run(d3)[3]
            added = sum(w[i] for i in range(d2, d3)) + w_mtp[d3] - w_mtp[d2]
            cost[k0] = max(0.0, (peaks[d3] - peaks[d2] - added) / (d3 - d2))
            fixed = peaks[d2] - layers_need(d2)
    depth = fit_depth(depth)
    predicted = need(depth)
    log(f"{cfg.name} calibration depth: {depth} of {n} layers (peaks at "
        f"depths {', '.join(f'{d}: {p / 1e9:.2f}' for d, p in peaks.items())}"
        f" GB; fixed {fixed / 1e9:.2f} GB, per-layer cost beside each "
        f"layer's own weights "
        f"{', '.join(f'{k}: {c / 1e9:.2f}' for k, c in cost.items())} GB; "
        f"predicted peak {predicted / 1e9:.2f} GB against "
        f"{budget / 1e9:.1f} GB, {CAL_MEMORY_SHARE:.0%} of the card's "
        f"{total / 1e9:.1f} GB"
        f"{'; MTP block included' if cfg.mtp_depth else ''})")
    if depth < n:
        log(f"CUT: {cfg.name} calibration depth cut to {depth} of {n} "
            f"layers: {cut or 'all layers need ' + f'{need(n) / 1e9:.1f} GB'}")
    model, bundle, seconds, peak = run(depth)
    sens = np.array(sorted(bundle.sens.sensitivity.values()))
    n_groups = len(bundle.objectives["ET"]["groups"])
    want_groups = len(build_groups(model, AMPOptions(),
                                   quantizable=set(bundle.op_names))[1])
    hand = expected_groups(model.cfg)
    n_mtp = sum(1 for op in bundle.op_names if op.startswith("mtp/"))
    log(f"{cfg.name} calibrate at depth {depth}: {len(bundle.sens.ops)} ops "
        f"({n_mtp} of the MTP module, in no group), {n_groups} groups, "
        f"{CAL_BATCHES} batches of {CAL_SHAPE} in {seconds:.1f} s; peak "
        f"device memory {peak / 1e9:.2f} GB (predicted "
        f"{predicted / 1e9:.2f} GB)")
    if not (np.isfinite(sens).all() and (sens > 0).all()
            and math.isfinite(bundle.sens.loss_mean)):
        raise AssertionError(f"{cfg.name} calibration gave a non-finite or "
                             "zero sensitivity")
    if not n_groups == want_groups == hand:
        raise AssertionError(f"{n_groups} groups, core.graphs gives "
                             f"{want_groups}, the block kinds {hand}")
    if cfg.mtp_depth and not n_mtp:
        raise AssertionError(f"{cfg.name}: no MTP op was calibrated")
    if peak > budget:
        raise AssertionError(f"{cfg.name} calibration peak "
                             f"{peak / 1e9:.2f} GB over the "
                             f"{budget / 1e9:.1f} GB budget")
    plan = bundle.solve(TAU, "ET")
    if any(op.startswith("mtp/") for op in plan.assignment):
        raise AssertionError("the ET plan quantizes an MTP op")
    log(f"{cfg.name} ET plan at tau {TAU}: {plan.n_quantized} ops fp8 "
        f"[{plan.meta['gain_tier']}]")
    return {"depth": depth, "of_layers": n, "cut": cut, "seconds": seconds,
            "peak_gb": peak / 1e9, "predicted_peak_gb": predicted / 1e9,
            "fit_peaks_gb": {str(d): p / 1e9 for d, p in peaks.items()},
            "budget_gb": budget / 1e9,
            "n_ops": len(bundle.sens.ops), "n_mtp_ops": n_mtp,
            "n_groups": n_groups, "loss_mean": bundle.sens.loss_mean,
            "s_min": float(sens[0]), "s_max": float(sens[-1]),
            "et_plan_n_fp8": plan.n_quantized,
            "et_gain_tier": plan.meta["gain_tier"]}


def llama8b_phase(torch) -> dict:
    """Phase 13: Llama-3.1-8B-Instruct's published widths, random weights:
    phases 4 and 5's checks at phase 4's cell (every fused launch through
    ``gqa_mma`` at D 128; the fixed plan: fp8 on the linear ops of layers
    16-31 and the BGEMMs of layer 31), phase 17's pipelined drain against
    the lockstep one, then calibration."""
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.launch.serve import make_model_and_params
    from repro_torch.models.registry import get_config
    t0 = time.perf_counter()
    model, params = make_model_and_params(LLAMA8B, False, DEVICE, seed=0,
                                          n_layers=LLAMA8B_DEPTH)
    torch.cuda.synchronize()
    cfg = model.cfg
    log(f"CUT: {LLAMA8B} served at depth {LLAMA8B_DEPTH} of 32 (the "
        f"script's time limit; calibration fits its depth on all 32)")
    log(f"{LLAMA8B}: {model.n_params() / 1e9:.3f}B params ({cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, d_head {cfg.d_head}, untied head), "
        f"random init in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    torch.cuda.reset_peak_memory_stats()
    out = serve_phase(torch, model, params)
    out["serving_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["pipelined_vs_lockstep"] = pipeline_check(torch, model, params,
                                                  "gqa_mma")
    data = SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size,
                                       batch=CAL_SHAPE[0],
                                       seq_len=CAL_SHAPE[1]), DEVICE)
    batches = list(data.batches(0, CAL_BATCHES))
    del model, params         # its decode graphs hold the params they read
    gc.collect()
    torch.cuda.empty_cache()
    out["calibration"] = fitted_calibration(torch, LLAMA8B, batches)
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
        # a NaN page in a live latent of row 0 must reach that row
        poison_live(torch, (ckv, nan_kw["k2"]), bt.cpu(), ln.cpu(), 0)
        live_nan_reaches_row(torch, f"MLA {name}",
                             pa.paged_decode_attention(*nan_args, **nan_kw),
                             got, 0)
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
    # a model's memoized steps close over it, so the reference model,
    # dropped when this phase returns, is freed only by the cyclic
    # collector: its graph goes now, not inside a later phase's capture
    release_steps(ref_model)
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


# ---------------------------------------------------------------------------
# phase 15: prefix caching, priority preemption and chunked prefill
# ---------------------------------------------------------------------------

# llama3_1b: a 96-token system prompt (6 blocks) shared by 8 requests with 32
# tokens of their own; the last request repeats request 0's whole prompt (a
# full-prompt hit, whose tail chunk forks the last shared block)
SHARED = dict(requests=8, system=96, own=32, new_tokens=32, arrival_every=2)
# six priority-0 requests at step 0 in a pool that holds three worst cases,
# one priority-1 request at step 10
PREEMPT = dict(low=6, fits=3, prompt_len=128, new_tokens=32, high_at=10)
# three requests decode when a 2048-token prompt arrives at step 8
CHUNKED = dict(short=3, prompt_len=128, long_len=2048, new_tokens=32,
               long_at=8, chunk_len=256, chunk_budget=1)
# DeepSeek-V3's dense MLA prefix: a short shared-prefix drain
MLA_SHARED = dict(requests=6, system=64, own=32, new_tokens=16,
                  arrival_every=2)


def random_prompt(vocab: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=n).astype(
        np.int32)


def shared_prefix_requests(vocab, requests, system, own, new_tokens,
                           arrival_every, seed=15) -> list:
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, size=system).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(0, vocab, size=own)
                               .astype(np.int32)])
               for _ in range(requests - 1)]
    prompts.append(prompts[0].copy())
    return [Request(rid=i, tokens=p, max_new_tokens=new_tokens,
                    arrival=arrival_every * i) for i, p in enumerate(prompts)]


def warm_request(vocab: int, prompt_len: int, new_tokens: int) -> list:
    """The warm-up drain's request (it captures the decode graph): a prompt
    that shares no block with any measured one, so what it leaves in the
    prefix cache matches nothing."""
    from repro_torch.serve import Request
    return [Request(rid=0, tokens=random_prompt(vocab, prompt_len, 1515),
                    max_new_tokens=new_tokens)]


def bit_equal(a: dict, b: dict) -> int:
    """Requests whose tokens and logits are the same bits in both drains."""
    import torch
    return sum(int(np.array_equal(a[r][0], b[r][0])
                   and a[r][1].shape == b[r][1].shape
                   and torch.equal(a[r][1], b[r][1])) for r in b)


def drain_set(torch, model, params, reqs, warm, route, failures, name,
              **engine_kw) -> tuple:
    """One drain fused and gather, each graphed and eager: each graphed
    drain held bit for bit against its eager twin, the fused launches
    against decode steps x layers (all through ``route``), fused against
    gather at the near-tie rule. Returns (fused summary, its rid ->
    (tokens, logits), its launches, the gather summary, its tick events,
    the record)."""
    n_layers = model.cfg.n_layers
    events = []
    kw = dict(warm=warm, **engine_kw)
    f, n_f, f_tl = run_continuous(torch, model, params, reqs,
                                  paged_attn="fused", route=route,
                                  name=name, events_out=events, **kw)
    if n_f != f.n_steps * n_layers or n_f == 0:
        failures.append(f"{name}: fused launches {n_f} != {f.n_steps} "
                        f"steps x {n_layers} layers")
    _, _, fe_tl = run_continuous(torch, model, params, reqs,
                                 paged_attn="fused", route=route, eager=True,
                                 name=name, **kw)
    g, n_g, g_tl = run_continuous(torch, model, params, reqs,
                                  paged_attn="gather", name=name, **kw)
    _, _, ge_tl = run_continuous(torch, model, params, reqs,
                                 paged_attn="gather", eager=True, name=name,
                                 **kw)
    if n_g:
        failures.append(f"{name}: gather launched the kernel {n_g} times")
    rec = {"graph_vs_eager": {
               "fused": graph_vs_eager(f"{name} fused", f_tl, fe_tl,
                                       failures),
               "gather": graph_vs_eager(f"{name} gather", g_tl, ge_tl,
                                        failures)},
           "fused_vs_gather": compare(f"{name} fused vs gather", f_tl, g_tl,
                                      tol=LOGIT_TOL, bound=MARGIN_BOUND,
                                      failures=failures),
           "kernel_launches": n_f, "n_decode_steps": f.n_steps,
           "warm_graph_captures": f.counters["warm_graph_captures"],
           "graph_captures": f.counters["graph_captures"],
           "graph_replays": f.counters["graph_replays"],
           "tokens_per_s_fused": f.tokens_per_s,
           "tokens_per_s_gather": g.tokens_per_s}
    return f, f_tl, n_f, g, events, rec


def shared_prefix_drains(torch, model, params, spec: dict, route: str,
                         failures: list, name: str) -> dict:
    """``spec``'s shared-prefix requests with the prefix cache on (fused
    and gather, graphed and eager) and off (fused): every request after
    the first hits, the last forks; on against off at the near-tie rule."""
    reqs = shared_prefix_requests(model.cfg.vocab_size, **spec)
    plen = spec["system"] + spec["own"]
    warm = warm_request(model.cfg.vocab_size, plen, spec["new_tokens"])
    kw = dict(max_len=plen + spec["new_tokens"])
    on, on_tl, _, _, _, rec = drain_set(torch, model, params, reqs, warm,
                                        route, failures, f"{name} on",
                                        prefix_cache=True, **kw)
    off, _, off_tl = run_continuous(torch, model, params, reqs,
                                    paged_attn="fused", route=route,
                                    warm=warm, name=f"{name} off",
                                    prefix_cache=False, **kw)
    c, hit = on.counters, [r.rid for r in reqs[1:]]
    if c["prefix_hit_requests"] < len(hit) or c["cow_forks"] < 1:
        failures.append(f"{name}: {c['prefix_hit_requests']} prefix hits and"
                        f" {c['cow_forks']} forks, expected >= {len(hit)} "
                        f"and >= 1")
    rec["on_vs_off"] = compare(f"{name} on vs off", on_tl, off_tl,
                               tol=LOGIT_TOL, bound=MARGIN_BOUND,
                               failures=failures)
    rec["on_vs_off"]["bit_equal_requests"] = bit_equal(on_tl, off_tl)

    def ttft_ms(out):
        return float(np.median([out.results[r].ttft_s for r in hit])) * 1e3
    rec.update({
        key: c[key] for key in ("prefix_hit_requests", "prefix_hit_tokens",
                                "cow_forks", "reclaimed_cached_blocks")})
    rec.update(prefill_tokens_on=c["prefill_tokens"],
               prefill_tokens_off=off.counters["prefill_tokens"],
               ttft_hit_p50_ms_on=ttft_ms(on), ttft_hit_p50_ms_off=ttft_ms(off),
               tokens_per_s_on=on.tokens_per_s,
               tokens_per_s_off=off.tokens_per_s)
    log(f"{name}: {c['prefix_hit_requests']} hit requests, "
        f"{c['prefix_hit_tokens']} prompt tokens skipped, {c['cow_forks']} "
        f"forks; prefill tokens {c['prefill_tokens']} on / "
        f"{off.counters['prefill_tokens']} off; TTFT p50 of the hitting "
        f"requests {rec['ttft_hit_p50_ms_on']:.2f} ms on / "
        f"{rec['ttft_hit_p50_ms_off']:.2f} ms off; decode "
        f"{on.tokens_per_s:.1f} tok/s on / {off.tokens_per_s:.1f} off; "
        f"{rec['on_vs_off']['bit_equal_requests']} of {len(reqs)} requests "
        f"bit-equal on vs off; graph captures {rec['warm_graph_captures']} "
        f"(warm-up) + {rec['graph_captures']}, {rec['graph_replays']} "
        f"replays")
    return rec


def shared_setup(vocab: int) -> tuple:
    """Phase 15's shared-prefix requests and engine arguments."""
    plen = SHARED["system"] + SHARED["own"]
    return shared_prefix_requests(vocab, **SHARED), dict(
        max_len=plen + SHARED["new_tokens"], prefix_cache=True,
        warm=warm_request(vocab, plen, SHARED["new_tokens"]))


def preempt_setup(vocab: int) -> tuple:
    """Phase 15's preemption requests (the priority-1 one last) and engine
    arguments: a pool of ``fits`` worst cases."""
    from repro_torch.serve import Request
    c = PREEMPT
    reqs = [Request(rid=i, tokens=random_prompt(vocab, c["prompt_len"],
                                                1600 + i),
                    max_new_tokens=c["new_tokens"]) for i in range(c["low"])]
    reqs.append(Request(rid=c["low"], tokens=random_prompt(
        vocab, c["prompt_len"], 1700), max_new_tokens=c["new_tokens"],
        arrival=c["high_at"], priority=1))
    worst = -(-(c["prompt_len"] + c["new_tokens"] - 1) // SERVE["block_size"])
    return reqs, dict(max_len=c["prompt_len"] + c["new_tokens"],
                      n_blocks=1 + c["fits"] * worst, prefix_cache=True,
                      warm=warm_request(vocab, c["prompt_len"],
                                        c["new_tokens"]))


def chunked_setup(vocab: int) -> tuple:
    """Phase 15's chunked-prefill requests (the long one last), engine
    arguments, and the chunking arguments."""
    from repro_torch.serve import Request
    c = CHUNKED
    reqs = [Request(rid=i, tokens=random_prompt(vocab, c["prompt_len"],
                                                1800 + i),
                    max_new_tokens=c["new_tokens"]) for i in range(c["short"])]
    reqs.append(Request(rid=c["short"], tokens=random_prompt(
        vocab, c["long_len"], 1900), max_new_tokens=c["new_tokens"],
        arrival=c["long_at"]))
    return reqs, dict(max_len=c["long_len"] + c["new_tokens"],
                      warm=warm_request(vocab, c["prompt_len"],
                                        c["new_tokens"])), dict(
        chunk_len=c["chunk_len"], chunk_budget=c["chunk_budget"])


def prefix_phase(torch, model, params) -> dict:
    """Phase 15 on llama3_1b at full width (4 slots, block 16, graphed
    decode): the shared-prefix, preemption and chunked-prefill drains,
    each fused and gather, graphed and eager, against its twin without
    the feature."""
    vocab = model.cfg.vocab_size
    failures = []
    plain = dict(tol=LOGIT_TOL, bound=MARGIN_BOUND, failures=failures)
    out = {"shared_prefix": shared_prefix_drains(
        torch, model, params, SHARED, "gqa_mma", failures, "shared prefix")}

    c = PREEMPT
    reqs, kw = preempt_setup(vocab)
    high = reqs[-1]
    pre, pre_tl, _, _, events, rec = drain_set(
        torch, model, params, reqs, route="gqa_mma", failures=failures,
        name="preemption", **kw)
    kw.pop("warm")
    unint, _, unint_tl = run_continuous(
        torch, model, params, reqs, paged_attn="fused", route="gqa_mma",
        warm=warm_request(vocab, c["prompt_len"], c["new_tokens"]),
        name="uninterrupted", preemption=False, **kw)
    resumed = resumed_rids(events, reqs)
    if pre.counters["preemptions"] < 1 or not resumed:
        failures.append(f"preemption: {pre.counters['preemptions']} "
                        f"preemptions, resumed {resumed}")
    rec["vs_uninterrupted"] = compare("preempted vs uninterrupted", pre_tl,
                                      unint_tl, **plain)
    rec["resumed"] = {str(rid): {
        "bit_equal": bit_equal({rid: pre_tl[rid]}, {rid: unint_tl[rid]}) == 1,
        "first_divergence": first_divergence(pre_tl[rid][0],
                                             unint_tl[rid][0])}
        for rid in resumed}
    rec.update(preemptions=pre.counters["preemptions"],
               blocked_admissions=pre.counters["blocked_admissions"],
               reclaimed_cached_blocks=pre.counters["reclaimed_cached_blocks"],
               bit_equal_requests=bit_equal(pre_tl, unint_tl),
               # from admission, as the engine measures TTFT
               high_ttft_ms=pre.results[high.rid].ttft_s * 1e3,
               high_ttft_ms_uninterrupted=unint.results[high.rid].ttft_s
               * 1e3,
               # from arrival, in decode steps (the wait preemption cuts)
               high_ttft_steps=pre.results[high.rid].first_token_step
               - high.arrival,
               high_ttft_steps_uninterrupted=unint.results[
                   high.rid].first_token_step - high.arrival)
    log(f"preemption: {rec['preemptions']} preemptions, resumed {resumed} "
        f"({rec['resumed']}); {rec['bit_equal_requests']} of {len(reqs)} "
        f"requests bit-equal to the uninterrupted drain; the priority-1 "
        f"request's first token {rec['high_ttft_steps']} decode steps after "
        f"its arrival (without preemption {rec['high_ttft_steps_uninterrupted']}"
        f"), TTFT from admission {rec['high_ttft_ms']:.2f} ms (without "
        f"preemption {rec['high_ttft_ms_uninterrupted']:.2f} ms)")
    out["preemption"] = rec

    c = CHUNKED
    reqs, kw, chunks = chunked_setup(vocab)
    ch, ch_tl, _, _, _, rec = drain_set(
        torch, model, params, reqs, route="gqa_mma", failures=failures,
        name="chunked", **chunks, **kw)
    one, _, one_tl = run_continuous(torch, model, params, reqs,
                                    paged_attn="fused", route="gqa_mma",
                                    name="one chunk", **kw)
    cc, oc = ch.counters, one.counters
    if cc["max_decode_stall_run"] > c["chunk_budget"]:
        failures.append(f"chunked: a decoding slot stalled "
                        f"{cc['max_decode_stall_run']} chunk steps in a row")
    rec["vs_one_chunk"] = compare("chunked vs one chunk", ch_tl, one_tl,
                                  **plain)
    long_rid = reqs[-1].rid
    rec.update({k: cc[k] for k in ("prefill_chunks", "decode_stall_steps",
                                   "max_decode_stall_run",
                                   "decode_stall_p99_s")})
    rec.update(one_chunk={k: oc[k] for k in (
                   "prefill_chunks", "decode_stall_steps",
                   "max_decode_stall_run", "decode_stall_p99_s")},
               long_bit_equal=bit_equal({long_rid: ch_tl[long_rid]},
                                        {long_rid: one_tl[long_rid]}) == 1,
               bit_equal_requests=bit_equal(ch_tl, one_tl),
               long_ttft_ms=ch.results[long_rid].ttft_s * 1e3,
               long_ttft_ms_one_chunk=one.results[long_rid].ttft_s * 1e3,
               tokens_per_s_one_chunk=one.tokens_per_s)
    log(f"chunked: {cc['prefill_chunks']} prefill chunks, "
        f"{cc['decode_stall_steps']} stalled decode steps, longest run "
        f"{cc['max_decode_stall_run']}, stall p99 "
        f"{cc['decode_stall_p99_s'] * 1e3:.2f} ms (one chunk: "
        f"{oc['prefill_chunks']} chunks, p99 "
        f"{oc['decode_stall_p99_s'] * 1e3:.2f} ms); the long request's "
        f"tokens {'bit-equal' if rec['long_bit_equal'] else 'not bit-equal'}"
        f" to one chunk; {rec['bit_equal_requests']} of {len(reqs)} "
        f"requests bit-equal")
    out["chunked"] = rec
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def mla_prefix_phase(torch, absorbed, params) -> dict:
    """Phase 15 on DeepSeek-V3's dense prefix (absorbed decode): a short
    shared-prefix drain, whose forks copy the latent leaves and whose
    decode reads borrowed pages through ``mla_mma``."""
    failures = []
    rec = shared_prefix_drains(torch, absorbed, params, MLA_SHARED,
                               "mla_mma", failures, "MLA shared prefix")
    if failures:
        raise AssertionError("; ".join(failures))
    return rec


# ---------------------------------------------------------------------------
# phase 17: the pipelined drain against the lockstep one, the control plane
# ---------------------------------------------------------------------------


def drain_numbers(out) -> dict:
    """How a drain moved its tokens: decode and wall tokens/s, wall per
    decode step, host time blocked on transfers per step, read-backs."""
    c = out.counters
    return {"tokens_per_s": out.tokens_per_s,
            "wall_tokens_per_s": c["wall_tokens_per_s"],
            "wall_ms_per_step": out.decode_s / max(out.n_steps, 1) * 1e3,
            "host_blocked_ms_per_step": c["host_blocked_s_per_step"] * 1e3,
            "n_readbacks": c["n_readbacks"],
            "readback_batch_mean": c["readback_batch_mean"],
            "steps_in_flight_peak": c["steps_in_flight_peak"],
            "drain_wait_ms": c["drain_wait_s"] * 1e3,
            "ttft_p50_ms": c["ttft_p50_s"] * 1e3,
            "n_decode_steps": out.n_steps, "total_s": out.total_s}


def pipelined_vs_lockstep(torch, model, params, reqs, name: str,
                          failures: list, **kw) -> tuple:
    """The same drain pipelined (the engine's default) and lockstep, each
    graphed after its own warm-up drain: the same decode steps and
    launches, and every token and the logits of every live row bit-equal.
    Returns (the record, the lockstep drain's rid -> (tokens, logits))."""
    pipe, n_p, p_tl = run_continuous(torch, model, params, reqs, name=name,
                                     **kw)
    lock, n_l, l_tl = run_continuous(torch, model, params, reqs, name=name,
                                     sync=True, **kw)
    n_eq = bit_equal(p_tl, l_tl)
    label = f"{model.cfg.name} {name}{' ' if name else ''}" \
        f"{kw.get('paged_attn', '')}{' MP' if kw.get('mp') else ''}"
    if n_eq != len(l_tl) or n_p != n_l or pipe.n_steps != lock.n_steps:
        failures.append(f"{label}: pipelined vs lockstep {n_eq} of "
                        f"{len(l_tl)} requests bit-equal, steps {pipe.n_steps}"
                        f" / {lock.n_steps}, launches {n_p} / {n_l}")
    if pipe.counters["sync"] or not lock.counters["sync"]:
        failures.append(f"{label}: the drains ran in the wrong modes")
    rec = {"bit_equal_requests": n_eq, "requests": len(l_tl),
           "kernel_launches": n_p, "pipelined": drain_numbers(pipe),
           "lockstep": drain_numbers(lock)}
    p, q = rec["pipelined"], rec["lockstep"]
    log(f"{label}: pipelined vs lockstep {n_eq} of {len(l_tl)} requests "
        f"bit-equal | tokens/s {p['tokens_per_s']:.1f} / "
        f"{q['tokens_per_s']:.1f} | wall tokens/s "
        f"{p['wall_tokens_per_s']:.1f} / {q['wall_tokens_per_s']:.1f} | wall "
        f"per decode step {p['wall_ms_per_step']:.3f} / "
        f"{q['wall_ms_per_step']:.3f} ms | host blocked "
        f"{p['host_blocked_ms_per_step']:.3f} / "
        f"{q['host_blocked_ms_per_step']:.3f} ms a step | read-back batch "
        f"mean {p['readback_batch_mean']:.2f} / "
        f"{q['readback_batch_mean']:.2f} | peak steps in flight "
        f"{p['steps_in_flight_peak']} / {q['steps_in_flight_peak']}")
    return rec, l_tl


# steady decode: every request prefills in the first tick, then only decode
# steps run, so decode_s / steps is the wall of a decode step in both
# drains (in phase 4's cell the pipelined drain's decode_s spans the
# prefills that arrive mid-decode too)
STEADY = dict(requests=4, prompt_len=128, new_tokens=128)


def phase4_requests(model) -> list:
    from repro_torch.launch.serve import make_requests
    return make_requests(model.cfg.vocab_size, SERVE["requests"],
                         SERVE["prompt_len"], SERVE["new_tokens"],
                         SERVE["arrival_every"])


def steady_drains(torch, model, params, failures, **kw) -> dict:
    """``STEADY``'s decode-only drain pipelined against lockstep."""
    from repro_torch.launch.serve import make_requests
    reqs = make_requests(model.cfg.vocab_size, STEADY["requests"],
                         STEADY["prompt_len"], STEADY["new_tokens"], 0)
    rec, _ = pipelined_vs_lockstep(
        torch, model, params, reqs, "steady decode", failures,
        max_len=STEADY["prompt_len"] + STEADY["new_tokens"], **kw)
    return rec


def pipeline_check(torch, model, params, route: str) -> dict:
    """Phase 4's cell and the steady decode drain, fused and graphed,
    pipelined against lockstep (phase 17 on llama3_8b and DeepSeek's
    prefix)."""
    failures = []
    rec, _ = pipelined_vs_lockstep(torch, model, params,
                                   phase4_requests(model), "", failures,
                                   paged_attn="fused", route=route)
    rec["steady"] = steady_drains(torch, model, params, failures,
                                  paged_attn="fused", route=route)
    if failures:
        raise AssertionError("; ".join(failures))
    return rec


def control_plane(torch, model, params, reqs, ref: dict,
                  failures: list) -> dict:
    """At phase 4's cell, fused and graphed, one engine (its warm-up drain
    captures): a cancel issued by ``on_token`` at a request's third token
    keeps exactly 3 tokens in the lockstep drain and a prefix in the
    pipelined one; ``timeout_steps`` retires the request on the engine
    clock; ``shutdown`` returns partial results; an ``on_token`` that
    raises is re-raised with the pool's books settled, and the engine
    serves again. Every kept token is the lockstep drain's (``ref``)."""
    import dataclasses
    from repro_torch.serve import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(
        model, paged_attn="fused", device=DEVICE, n_slots=SERVE["n_slots"],
        max_len=SERVE["prompt_len"] + SERVE["new_tokens"],
        block_size=SERVE["block_size"], prefix_cache=False)
    eng.serve(params, reqs[:1])
    victim = reqs[0].rid

    def kept(name, res, rid=victim, n=None) -> int:
        toks, want = np.asarray(res.tokens), np.asarray(ref[rid][0])
        good = len(toks) <= len(want) and np.array_equal(
            toks, want[:len(toks)]) and (n is None or len(toks) == n)
        if not good:
            failures.append(f"control plane, {name}: request {rid} kept "
                            f"{toks.tolist()}, not {'the first ' + str(n) if n else 'a prefix'} "
                            f"of the lockstep drain's {want.tolist()}")
        return len(toks)

    def cancel_at(idx):
        return lambda rid, i, tok: eng.cancel(rid) if (
            rid == victim and i == idx) else None

    rec = {}
    for sync in (True, False):
        name = "lockstep cancel" if sync else "pipelined cancel"
        out = eng.serve(params, reqs, sync=sync, on_token=cancel_at(2))
        res = out.results[victim]
        n = kept(name, res, n=3 if sync else None)
        if res.status != "cancelled" or out.counters["n_cancelled"] != 1 \
                or n < 3:
            failures.append(f"control plane, {name}: status {res.status}, "
                            f"{out.counters['n_cancelled']} cancelled, {n} "
                            f"tokens")
        for r in reqs[1:]:
            if out.results[r.rid].status != "ok" or len(
                    out.results[r.rid].tokens) != r.max_new_tokens:
                failures.append(f"control plane, {name}: request {r.rid} "
                                f"did not complete")
        rec[name.replace(" ", "_") + "_kept"] = n
    timeout = 6
    timed = [dataclasses.replace(r, timeout_steps=timeout)
             if r.rid == victim else r for r in reqs]
    out = eng.serve(params, timed)
    res = out.results[victim]
    rec["timeout_kept"] = kept("timeout", res, n=timeout + 1)
    if res.status != "timeout" or res.finished_step != timeout:
        failures.append(f"control plane, timeout: status {res.status} at "
                        f"step {res.finished_step}")
    out = eng.serve(params, reqs, on_token=lambda rid, i, tok: eng.shutdown()
                    if (rid == victim and i == 4) else None)
    for rid, res in out.results.items():
        if res.status != "ok":
            kept("shutdown", res, rid)
    rec["shutdown"] = {"n_cancelled": out.counters["n_cancelled"],
                       "tokens_kept": sum(len(r.tokens)
                                          for r in out.results.values())}
    if out.counters["n_cancelled"] < 1 or len(out.results) != len(reqs):
        failures.append(f"control plane, shutdown: {out.counters}")

    def raises(rid, i, tok):
        if i == 3:
            raise RuntimeError("client went away")

    try:
        eng.serve(params, reqs, on_token=raises)
        failures.append("control plane: a raising on_token was swallowed")
    except RuntimeError as e:
        if "client went away" not in str(e):
            raise
    books = eng._pool.check_consistency()
    if not books["ok"] or eng._pool.n_free_slots != SERVE["n_slots"]:
        failures.append(f"control plane: books after the raise {books}")
    out = eng.serve(params, reqs)
    rec["after_raise_bit_equal_tokens"] = sum(
        np.array_equal(out.results[r.rid].tokens, ref[r.rid][0])
        for r in reqs)
    if any(out.results[r.rid].status != "ok" for r in reqs):
        failures.append("control plane: the drain after the raise failed")
    log(f"control plane: lockstep cancel kept {rec['lockstep_cancel_kept']} "
        f"tokens, pipelined cancel {rec['pipelined_cancel_kept']}, timeout "
        f"{rec['timeout_kept']} (step {timeout}); shutdown cancelled "
        f"{rec['shutdown']['n_cancelled']} requests keeping "
        f"{rec['shutdown']['tokens_kept']} tokens; a raising on_token "
        f"re-raised with settled books, then "
        f"{rec['after_raise_bit_equal_tokens']} of {len(reqs)} requests "
        f"bit-equal to the lockstep drain")
    return rec


def pipeline_phase(torch, model, params) -> dict:
    """Phase 17 on llama3_1b at full width: phase 4's cell fused and
    gather, plain and under phase 5's plan, the steady decode drain (fused,
    plain and under the plan), then phase 15's three drains, each
    pipelined against lockstep; then the control plane."""
    failures = []
    reqs = phase4_requests(model)
    plan = fixed_plan(model)
    out, ref = {}, None
    for label, mp in (("plain", None), ("mp", plan)):
        for attn in ("fused", "gather"):
            out[f"{label}_{attn}"], tl = pipelined_vs_lockstep(
                torch, model, params, reqs, "", failures, mp=mp,
                paged_attn=attn, route="gqa_mma" if attn == "fused" else None)
            ref = tl if ref is None else ref
        out[f"steady_{label}"] = steady_drains(
            torch, model, params, failures, mp=mp, paged_attn="fused",
            route="gqa_mma")
    vocab = model.cfg.vocab_size
    s_reqs, s_kw = shared_setup(vocab)
    p_reqs, p_kw = preempt_setup(vocab)
    c_reqs, c_kw, chunks = chunked_setup(vocab)
    for key, sreqs, kw in (("shared_prefix", s_reqs, s_kw),
                           ("preemption", p_reqs, p_kw),
                           ("chunked", c_reqs, dict(c_kw, **chunks))):
        out[key], _ = pipelined_vs_lockstep(
            torch, model, params, sreqs, key.replace("_", " "), failures,
            paged_attn="fused", route="gqa_mma", **kw)
    out["control"] = control_plane(torch, model, params, reqs, ref, failures)
    if failures:
        raise AssertionError("; ".join(failures))
    return out


# ---------------------------------------------------------------------------
# phases 19 and 20: dense-ring serving; the prefill graphs' TTFT
# ---------------------------------------------------------------------------

DENSE_CHUNK = 64


def dense_phase(torch, model, params) -> dict:
    """Phase 19 on llama3_1b at full width: phase 4's requests on dense
    per-slot rings (``paged=False``), pipelined and lockstep, and in chunks
    of ``DENSE_CHUNK`` (a 128-token prompt takes two, its second while the
    others decode), each graphed and held bit for bit against its eager
    twin; pipelined against lockstep bit for bit; dense against the paged
    gather drain and chunks against one chunk at the near-tie rule, with
    the number of bit-equal requests."""
    failures = []
    reqs = phase4_requests(model)
    dense = dict(paged_attn=None, paged=False, name="dense")
    d, n_d, d_tl = run_continuous(torch, model, params, reqs, **dense)
    _, _, de_tl = run_continuous(torch, model, params, reqs, eager=True,
                                 **dense)
    lock, _, lock_tl = run_continuous(torch, model, params, reqs, sync=True,
                                      **dense)
    ch, _, ch_tl = run_continuous(torch, model, params, reqs,
                                  chunk_len=DENSE_CHUNK, **dense)
    _, _, che_tl = run_continuous(torch, model, params, reqs, eager=True,
                                  chunk_len=DENSE_CHUNK, **dense)
    g, _, g_tl = run_continuous(torch, model, params, reqs,
                                paged_attn="gather")
    if n_d:
        failures.append(f"dense decode launched the paged kernel {n_d} "
                        f"times")
    if ch.counters["decode_stall_steps"] == 0:
        failures.append(f"no chunk of {DENSE_CHUNK} ran while others "
                        f"decoded")
    plain = dict(tol=LOGIT_TOL, bound=MARGIN_BOUND, failures=failures)
    n_lock = bit_equal(d_tl, lock_tl)
    if n_lock != len(reqs):
        failures.append(f"dense pipelined vs lockstep: {n_lock} of "
                        f"{len(reqs)} requests bit-equal")
    rec = {"graph_vs_eager": {
               "dense": graph_vs_eager("dense", d_tl, de_tl, failures),
               "dense_chunked": graph_vs_eager(
                   f"dense chunks of {DENSE_CHUNK}", ch_tl, che_tl,
                   failures)},
           "pipelined_vs_lockstep_bit_equal_requests": n_lock,
           "dense_vs_paged_gather": compare("dense vs paged gather", d_tl,
                                            g_tl, **plain),
           "chunked_vs_one_chunk": compare(
               f"dense chunks of {DENSE_CHUNK} vs one chunk", ch_tl, d_tl,
               **plain),
           "serving": {"dense": serving_numbers(d),
                       "dense_lockstep": serving_numbers(lock),
                       "dense_chunked": serving_numbers(ch),
                       "paged_gather": serving_numbers(g)}}
    rec["dense_vs_paged_gather"]["bit_equal_requests"] = bit_equal(d_tl, g_tl)
    rec["chunked_vs_one_chunk"]["bit_equal_requests"] = bit_equal(ch_tl, d_tl)
    log(f"dense rings: pipelined vs lockstep {n_lock} of {len(reqs)} "
        f"requests bit-equal; dense vs paged gather "
        f"{rec['dense_vs_paged_gather']['bit_equal_requests']}, chunks of "
        f"{DENSE_CHUNK} vs one chunk "
        f"{rec['chunked_vs_one_chunk']['bit_equal_requests']} bit-equal; "
        f"KV {d.counters['dense_kv_bytes'] / 1e6:.1f} MB dense vs "
        f"{g.counters['peak_kv_bytes'] / 1e6:.1f} MB paged at peak; wall "
        f"tok/s dense {d.counters['wall_tokens_per_s']:.1f}, lockstep "
        f"{lock.counters['wall_tokens_per_s']:.1f}, chunked "
        f"{ch.counters['wall_tokens_per_s']:.1f}, paged gather "
        f"{g.counters['wall_tokens_per_s']:.1f}")
    if failures:
        raise AssertionError("; ".join(failures))
    return rec


# phase 20's arms, in order (eager, graphed, graphed, eager before phase
# 27 was added: the repeats went to pay for it)
TTFT_ARMS = ("prefill_eager", "graphed")


def ttft_phase(torch, model, params) -> dict:
    """Phase 20 on llama3_1b at full width. Phase 4's cell (fused, graphed
    decode) with the prefill step run eagerly, as it ran before it was
    graphed, against every step graphed, in the order of ``TTFT_ARMS``;
    each arm drains pipelined and then lockstep: TTFT p50
    and p99 over the 8 requests (p99 of 8 is their maximum), wall
    tokens/s, the p99 decode stall; the first arm of each kind also
    profiles a pipelined drain for the device's busy share (device time
    of every kernel and copy over the unprofiled drain's wall). Then
    ``ServeEngine.ttft`` (median of 5 prefills after 2 warm-ups) at 1 and
    4 prompts of 128 tokens, graphed and with the bucketed step eager."""
    from repro_torch.launch import steps as st
    from repro_torch.launch.serve import profile_drain
    from repro_torch.serve import ContinuousBatchingEngine, ServeEngine
    reqs = phase4_requests(model)
    longest = SERVE["prompt_len"] + SERVE["new_tokens"]
    rec = {"prefill_eager": [], "graphed": []}
    for arm in TTFT_ARMS:
        eng = ContinuousBatchingEngine(
            model, paged_attn="fused", device=DEVICE, prefix_cache=False,
            n_slots=SERVE["n_slots"], max_len=longest,
            block_size=SERVE["block_size"])
        if arm == "prefill_eager":
            eng.prefill_chunk_step = st.make_chunked_prefill_step(model)
        eng.serve(params, reqs[:1])
        warm_buckets(torch, eng, params, longest)
        r = {}
        for mode, sync in (("pipelined", False), ("lockstep", True)):
            torch.cuda.synchronize()
            out = eng.serve(params, reqs, sync=sync)
            torch.cuda.synchronize()
            ttfts = sorted(x.ttft_s for x in out.results.values())
            c = out.counters
            r[mode] = {
                "ttft_p50_ms": ttfts[len(ttfts) // 2] * 1e3,
                "ttft_p99_ms": ttfts[min(len(ttfts) - 1,
                                         int(0.99 * len(ttfts)))] * 1e3,
                "wall_tokens_per_s": c["wall_tokens_per_s"],
                "decode_stall_p99_ms": c.get("decode_stall_p99_s",
                                             0.0) * 1e3,
                "wall_ms": out.total_s * 1e3,
                "graph_replays": c["graph_replays_by_kind"]}
            if mode == "pipelined" and not rec[arm]:
                prof = profile_drain(eng, params, reqs, None, out.total_s,
                                     top=5)
                r[mode].update(busy_share=prof["busy_share"],
                               device_busy_ms=prof["device_busy_s"] * 1e3)
        rec[arm].append(r)
        p, q = r["pipelined"], r["lockstep"]
        busy = (f"; device busy {100 * p['busy_share']:.1f}% of "
                f"{p['wall_ms']:.1f} ms" if "busy_share" in p else "")
        log(f"TTFT cell, prefill "
            f"{'eager' if arm == 'prefill_eager' else 'graphed'}: TTFT p50 "
            f"{p['ttft_p50_ms']:.2f} ms, p99 {p['ttft_p99_ms']:.2f} ms "
            f"pipelined, {q['ttft_p50_ms']:.2f} / {q['ttft_p99_ms']:.2f} ms "
            f"lockstep; wall {p['wall_tokens_per_s']:.1f} / "
            f"{q['wall_tokens_per_s']:.1f} tok/s; decode stall p99 "
            f"{p['decode_stall_p99_ms']:.2f} / {q['decode_stall_p99_ms']:.2f}"
            f" ms{busy}; replays {kinds(p['graph_replays'])}")
        del eng
    one = {}
    for n in (1, 4):
        batch = {"tokens": np.stack([r.tokens for r in reqs[:n]])}
        for arm in ("graphed", "eager"):
            eng = ServeEngine(model, device=DEVICE)
            if arm == "eager":
                eng.bucketed_prefill_step = st.make_bucketed_prefill_step(
                    model)
            one[f"batch{n}_{arm}_ms"] = eng.ttft(
                params, batch, SERVE["prompt_len"] + 1) * 1e3
        log(f"ServeEngine.ttft, {n} x {SERVE['prompt_len']} tokens: graphed "
            f"{one[f'batch{n}_graphed_ms']:.3f} ms, eager "
            f"{one[f'batch{n}_eager_ms']:.3f} ms")
    rec["serve_engine_ttft"] = one
    return rec


# ---------------------------------------------------------------------------
# phase 21: serving robustness
# ---------------------------------------------------------------------------

# one spec of each kind at ticks 4-8 of phase 4's cell (requests arrive at
# ticks 0, 2, ..., 14; a prefill first comes after tick 5 at tick 6)
FAULT_MATRIX = (("step_exception", dict(step=4, phase="decode")),
                ("step_exception", dict(step=5, phase="prefill")),
                ("nan_page", dict(step=6, slot=0, page=1)),
                ("nan_logits", dict(step=7, slot=1)),
                ("alloc_failure", dict(step=8, slot=2)),
                ("consumer_error", dict(step=8, slot=0)),
                ("consumer_stall", dict(step=5, hang_s=0.01)),
                ("hung_step", dict(step=6, phase="decode", hang_s=0.01)))
# the ladder: 3 levels, each tau twice the last (4x the loss-MSE budget);
# escalate at 2 queued requests (the scheduler counts the ones yet to
# arrive too), restore at none; occupancy never decides (the pool has room
# for twice the cell)
LADDER = dict(n_levels=3, factor=2.0, every=2, dwell=4, queue_high=2,
              queue_low=0, occ_high=1.0, occ_low=1.0)


@contextlib.contextmanager
def restored(eng, names):
    """The engine's attributes ``names`` as they were, on exit."""
    saved = {n: eng.__dict__[n] for n in names if n in eng.__dict__}
    try:
        yield
    finally:
        for n in names:
            if n in saved:
                setattr(eng, n, saved[n])
            else:
                eng.__dict__.pop(n, None)


@contextlib.contextmanager
def recording(eng):
    """``record_steps`` on the engine's steps, undone on exit."""
    with restored(eng, ("decode_step", "prefill_chunk_step",
                        "_prefill_tick")):
        yield record_steps(eng, ("prefill_chunk_step", "decode_step"))


@contextlib.contextmanager
def ticks(eng):
    """The owners of every prefill tick (slot -> (rid, effective prompt
    length)), whatever steps the engine swaps in."""
    events = []
    with restored(eng, ("_prefill_tick",)):
        tick = eng._prefill_tick

        def ticked(params, pool, sched, now, *rest):
            events.append(("tick", {
                s: (st.request.rid, st.effective_prompt_len)
                for s, st in sched.prefilling.items()}))
            return tick(params, pool, sched, now, *rest)
        eng._prefill_tick = ticked
        yield events


def touched_rids(events, reqs, out) -> set:
    """Requests a fault may have changed: any that did not end ``ok``, any
    that prefilled a longer prompt than its own (a retry) and any whose
    prefill ran in a chunk beside such a one (a larger bucket: another
    GEMM shape)."""
    plen = {r.rid: r.prompt_len for r in reqs}
    out_rids = {rid for rid, r in out.results.items() if r.status != "ok"}
    for name, owners in events:
        if any(eff > plen[rid] for rid, eff in owners.values()):
            out_rids |= {rid for rid, _ in owners.values()}
    return out_rids


def hold_drain(name: str, out, reqs, ref: dict, bit_rids, bound: float,
               failures: list) -> dict:
    """A drain against the fault-free one (``ref``: rid -> (tokens,
    logits)): every request has a result; ``bit_rids`` are bit-equal to
    it, the others agree up to a first divergence at a near-tie of the
    reference's logits; a request that did not complete keeps a prefix."""
    n_bit = n_near = 0
    for r in reqs:
        res = out.results.get(r.rid)
        if res is None:
            failures.append(f"{name}: request {r.rid} has no result")
            continue
        tok, (want, lw) = np.asarray(res.tokens), ref[r.rid]
        if res.status in ("ok", "retried") and len(tok) != len(want):
            failures.append(f"{name}: request {r.rid} ({res.status}) has "
                            f"{len(tok)} of {len(want)} tokens")
            continue
        if r.rid in bit_rids:
            if np.array_equal(tok, want[:len(tok)]):
                n_bit += 1
            else:
                failures.append(f"{name}: request {r.rid}, which no fault "
                                f"touched, differs from the fault-free "
                                f"drain")
            continue
        i = first_divergence(tok, want[:len(tok)])
        if i < len(tok):
            gap = float(top2_gaps(lw[i:i + 1])[0])
            log(f"{name}: request {r.rid} ({res.status}) diverges at token "
                f"{i} where the fault-free drain's top-2 gap is {gap:.4f}")
            if not gap < bound:
                failures.append(f"{name}: request {r.rid} diverges at token "
                                f"{i} with a top-2 gap {gap:.4f} >= {bound}")
        n_near += 1
    return {"bit_equal": n_bit, "near_tie_rule": n_near}


def graph_only(name: str, out, failures: list) -> None:
    """No capture in the drain, and every step a replay: the decode and
    prefill steps, and the shadow step of each guardrail check."""
    if DEVICE == "cpu":
        return                    # a CPU rehearsal: the steps run eagerly
    c = out.counters
    shadow = c.get("guardrail", {}).get("checks", 0)
    want = out.n_steps + c["prefill_chunks"] + shadow
    if c["graph_captures"] or c["graph_replays"] != want:
        failures.append(f"{name}: {c['graph_captures']} captures and "
                        f"{c['graph_replays']} replays in the drain, "
                        f"expected 0 and {want}")


def robustness_phase(torch, model, params, plan, bundle) -> dict:
    """Phase 21 on llama3_1b at full width, phase 4's cell (fused,
    pipelined, every step graphed) on one engine whose pool holds twice
    the cell, so that quarantined blocks never gate admission:

    * the fault matrix: one spec of each kind (``FAULT_MATRIX``) against
      the fault-free drain. Every request ends with a result; those no
      fault touched are bit-equal, the others held by the near-tie rule
      (a failed one keeps a prefix); ``nan_page`` is flagged (through
      kernel 5) and quarantined; the books are consistent after each
      drain and no quarantined block is handed out again;
    * two ``hung_step`` faults degrade the drain to the gather path, whose
      graph the warm-up captured;
    * the guardrail under ``plan`` (phase 8's ET plan, or its TT plan when
      the measured ET plan quantizes nothing; its own budget) at every 4
      steps: its MSEs against the budget, no breach, tokens
      bit-equal to the drain without it; a budget of 1e-12 restores the
      unquantized plan within the drain;
    * a 3-level ladder from ``bundle`` (phase 6's, ``plan``'s objective)
      under phase 4's burst, its budgets ``plan``'s predicted loss MSE /
      16, / 4 and / 1: the
      swaps, the captures each plan's warm-up made, none in the drain; a
      one-level ladder bit-equal to the fixed plan;
    * the cost when idle: the plan's drain without a guardrail against the
      same with one every 16 steps, in turns (off, on, on, off).

    No drain captures a graph: each step kind of each plan, the shadow
    step and the gather step are captured in warm-ups."""
    from repro_torch.launch import steps as st
    from repro_torch.serve import (AdaptiveMPController,
                                   ContinuousBatchingEngine, FaultInjector,
                                   FaultSpec, NumericalGuardrail)
    reqs = phase4_requests(model)
    longest = SERVE["prompt_len"] + SERVE["new_tokens"]
    n_pages = -(-longest // SERVE["block_size"])
    eng = ContinuousBatchingEngine(
        model, paged_attn="fused", device=DEVICE, prefix_cache=False,
        n_slots=SERVE["n_slots"], max_len=longest,
        block_size=SERVE["block_size"],
        n_blocks=1 + 2 * SERVE["n_slots"] * n_pages)
    failures, rec = [], {}

    def warm(label: str) -> int:
        """The warm-up drain and every bucket, on the engine's steps as
        they are; returns the captures."""
        g0 = sum(st.graph_captures.values())
        eng.serve(params, reqs[:1])
        warm_buckets(torch, eng, params, longest)
        n = sum(st.graph_captures.values()) - g0
        log(f"robustness warm-up, {label}: {n} CUDA graph captures")
        return n

    given = set()                 # blocks the allocator hands out

    def drain(name: str, **kw) -> tuple:
        """One drain; returns (summary, prefill tick owners). Checks the
        books, that no block quarantined before it was handed out, and
        that every step replayed a graph."""
        gone = set(eng._pool._quarantined)
        given.clear()
        with ticks(eng) as events:
            out = eng.serve(params, reqs, **kw)
        torch.cuda.synchronize()
        pool = eng._pool
        if not pool.check_consistency()["ok"]:
            failures.append(f"{name}: pool books inconsistent")
        if given & gone:
            failures.append(f"{name}: quarantined blocks "
                            f"{sorted(given & gone)} handed out again")
        graph_only(name, out, failures)
        return out, events

    warm_caps = {"plain fused": warm("plain, fused")}
    pool = eng._pool
    for fn in ("_alloc_block", "_alloc_block_unreserved"):
        def tracked(*a, _orig=getattr(pool, fn)):
            blk = _orig(*a)
            if blk is not None:
                given.add(int(blk))
            return blk
        setattr(pool, fn, tracked)
    with recording(eng) as events:
        base = eng.serve(params, reqs)
    torch.cuda.synchronize()
    graph_only("fault-free", base, failures)
    ref = continuous_logits(events, reqs)
    ref = {r.rid: (base.results[r.rid].tokens, ref[r.rid]) for r in reqs}

    # ---- the fault matrix ----
    matrix = {}
    for kind, kw in FAULT_MATRIX:
        name = f"fault {kind}" + (f" ({kw['phase']})" if "phase" in kw
                                  else "")
        eng.faults = FaultInjector([FaultSpec(kind=kind, **kw)])
        out, tick_ev = drain(name)
        eng.faults = None
        f = out.counters["faults"]
        bit = {r.rid for r in reqs} - touched_rids(tick_ev, reqs, out)
        held = hold_drain(name, out, reqs, ref, bit, MARGIN_BOUND, failures)
        statuses = {rid: r.status for rid, r in sorted(out.results.items())}
        if f["injected"] != {kind: 1}:
            failures.append(f"{name}: injected {f['injected']}")
        if kind in ("nan_page", "nan_logits") and not (
                f["seen"].get("nonfinite_logits", 0) >= 1
                and f["quarantined_blocks"] > 0):
            failures.append(f"{name}: the tripwire did not flag and "
                            f"quarantine the poisoned row ({f})")
        if f["kernel_faults"] != (1 if kind in ("step_exception",
                                                "hung_step") else 0) \
                or f["degraded_paged_attn"]:
            failures.append(f"{name}: kernel faults {f['kernel_faults']}, "
                            f"degraded {f['degraded_paged_attn']}")
        matrix[name] = {"statuses": statuses, "seen": f["seen"],
                        "contained": f["contained"], "retries": f["retries"],
                        "failed": f["failed"],
                        "quarantined_blocks": f["quarantined_blocks"],
                        "touched": sorted(set(statuses) - bit), **held,
                        "wall_tokens_per_s": out.counters[
                            "wall_tokens_per_s"]}
        log(f"{name}: statuses {statuses}; seen {f['seen']}; "
            f"{f['contained']} contained, {f['failed']} failed, "
            f"{f['quarantined_blocks']} blocks quarantined; "
            f"{held['bit_equal']} requests bit-equal to the fault-free drain,"
            f" {held['near_tie_rule']} held by the near-tie rule; "
            f"{out.counters['graph_replays']} replays, "
            f"{out.counters['graph_captures']} captures")
    rec["fault_matrix"] = matrix
    rec["quarantined_blocks"] = eng._pool.n_quarantined_blocks

    # ---- fused -> gather after kernel_fault_limit hung steps ----
    eng.paged_attn = "gather"
    eng.decode_step = st.get_serving_step(model, "paged_decode",
                                          paged_attn="gather")
    warm_caps["plain gather"] = warm("plain, gather")
    eng.paged_attn = "fused"
    eng.decode_step = st.get_serving_step(model, "paged_decode",
                                          paged_attn="fused")
    eng.faults = FaultInjector([
        FaultSpec("hung_step", step=4, hang_s=0.01),
        FaultSpec("hung_step", step=6, hang_s=0.01)])
    out, _ = drain("degraded")
    eng.faults = None
    f = out.counters["faults"]
    if not (f["kernel_faults"] == 2 and f["degraded_paged_attn"]
            and eng.paged_attn == "gather"):
        failures.append(f"degraded drain: kernel faults "
                        f"{f['kernel_faults']}, degraded "
                        f"{f['degraded_paged_attn']}")
    rec["degraded"] = dict(hold_drain("degraded", out, reqs, ref, set(),
                                      MARGIN_BOUND, failures),
                           kernel_faults=f["kernel_faults"],
                           replays=out.counters["graph_replays_by_kind"])
    log(f"degraded drain: {f['kernel_faults']} hung steps, fused -> gather "
        f"in the drain; {rec['degraded']['near_tie_rule']} requests held by "
        f"the near-tie rule; replays "
        f"{kinds(out.counters['graph_replays_by_kind'])}, "
        f"{out.counters['graph_captures']} captures")
    eng.paged_attn = "fused"
    eng.decode_step = st.get_serving_step(model, "paged_decode",
                                          paged_attn="fused")

    # ---- the guardrail under the plan (its restore serves the plain
    # steps, which the first warm-up captured; the shadow step is the plain
    # decode step) ----
    eng._swap_plan(plan)
    warm_caps["plan"] = warm(f"plan ({plan.n_quantized} ops fp8)")
    eng.guardrail = NumericalGuardrail(every=1, budget=1e9)
    g0 = sum(st.graph_captures.values())
    eng.serve(params, reqs[:1])                  # captures the shadow step
    warm_caps["shadow"] = sum(st.graph_captures.values()) - g0
    eng.guardrail = None
    with recording(eng) as events:
        off, _ = drain("plan, no guardrail")
    plan_ref = continuous_logits(events, reqs)
    plan_ref = {r.rid: (off.results[r.rid].tokens, plan_ref[r.rid])
                for r in reqs}
    mses = []
    eng.guardrail = grail = NumericalGuardrail(every=4)
    observe = grail.observe_mse

    def observed(now, mse, budget):
        mses.append((int(now), float(mse), budget))
        return observe(now, mse, budget)
    grail.observe_mse = observed
    on, _ = drain("plan, guardrail every 4")
    eng.guardrail = None
    g = on.counters["guardrail"]
    budget = grail.budget_for(plan)
    same = hold_drain("guardrail every 4", on, reqs, plan_ref,
                      {r.rid for r in reqs}, MARGIN_BOUND_MP, failures)
    if g["breaches"] or g["restored_at"] is not None or not g["checks"]:
        failures.append(f"guardrail: the honest plan breached or was never "
                        f"checked ({g})")
    log(f"guardrail every 4 under the plan: {g['checks']} checks, MSE "
        f"{', '.join(f'{m:.3e}' for _, m, _ in mses)} against the budget "
        f"{budget:.4e} x margin {grail.margin:g}; {g['breaches']} breaches; "
        f"{same['bit_equal']} of {len(reqs)} requests bit-equal to the drain "
        f"without it")
    rec["guardrail"] = {"checks": g["checks"], "mse": [m for _, m, _ in mses],
                        "budget": budget, "margin": grail.margin,
                        "breaches": g["breaches"],
                        "bit_equal_to_no_guardrail": same["bit_equal"]}
    eng._swap_plan(plan)
    eng.guardrail = NumericalGuardrail(every=4, budget=1e-12,
                                       max_breaches=2)
    out, _ = drain("plan, guardrail forced breach")
    eng.guardrail = None
    g = out.counters["guardrail"]
    if g["restored_at"] is None or eng.mp:
        failures.append(f"forced breach: the drain was not restored to the "
                        f"unquantized plan ({g})")
    if not all(r.status == "ok" for r in out.results.values()):
        failures.append("forced breach: a request did not complete")
    rec["guardrail_forced_breach"] = {"checks": g["checks"],
                                      "breaches": g["breaches"],
                                      "restored_at": g["restored_at"],
                                      "swaps": g["swaps"]}
    log(f"guardrail forced breach (budget 1e-12, 2 breaches): restored the "
        f"unquantized plan at step {g['restored_at']} after {g['checks']} "
        f"checks; every request completed")

    # ---- the cost when idle ----
    eng._swap_plan(plan)
    idle = {"off": [], "on": []}
    for arm in ("off", "on", "on", "off"):
        eng.guardrail = NumericalGuardrail(every=16) if arm == "on" else None
        out, _ = drain(f"idle cost, guardrail {arm}")
        idle[arm].append(out.counters["wall_tokens_per_s"])
        if arm == "on":
            hold_drain("idle cost, guardrail every 16", out, reqs, plan_ref,
                       {r.rid for r in reqs}, MARGIN_BOUND_MP, failures)
    eng.guardrail = None
    mean = {k: float(np.mean(v)) for k, v in idle.items()}
    rec["idle_cost"] = {"wall_tokens_per_s": idle,
                        "on_over_off": mean["on"] / mean["off"]}
    log(f"cost when idle, the plan's drain: wall tokens/s without a "
        f"guardrail {idle['off'][0]:.1f}, {idle['off'][1]:.1f}; with one "
        f"every 16 steps {idle['on'][0]:.1f}, {idle['on'][1]:.1f} "
        f"(on / off {rec['idle_cost']['on_over_off']:.4f})")

    # ---- load-adaptive MP ----
    # at phase 8's tau the budget does not bind (the measured gains decide
    # the plan, and twice the tau gives the same ops): the ladder's budgets
    # are the plan's predicted loss MSE / 16, / 4 and / 1, so each level
    # quantizes more ops than the last
    base = math.sqrt(plan.predicted_loss_mse / 16
                     / plan.meta["loss_sq_mean"])
    ctrl = AdaptiveMPController.from_bundle(bundle, base,
                                            objective=plan.objective,
                                            **LADDER)
    per_plan = {}
    for level in range(len(ctrl.taus)):
        p = ctrl.plan_for(level)
        eng._swap_plan(p)
        per_plan[f"tau {ctrl.taus[level]:g}"] = {
            "n_fp8": p.n_quantized,
            "captures": warm(f"ladder level {level}, tau "
                             f"{ctrl.taus[level]:g}, {p.n_quantized} ops "
                             f"fp8")}
    eng._swap_plan(ctrl.plan)
    eng.adaptive = ctrl
    out, _ = drain("adaptive ladder")
    eng.adaptive = None
    a = out.counters["adaptive"]
    if not (a["downshifts"] >= 1 and a["restores"] >= 1
            and a["final_level"] == 0):
        failures.append(f"adaptive: no downshift-restore cycle under the "
                        f"burst ({a})")
    if not all(r.status == "ok" for r in out.results.values()):
        failures.append("adaptive: a request did not complete")
    rec["adaptive"] = {"swaps": a["swaps"], "downshifts": a["downshifts"],
                       "restores": a["restores"], "plans": per_plan,
                       "wall_tokens_per_s": out.counters[
                           "wall_tokens_per_s"]}
    log(f"adaptive ladder taus {[f'{t:g}' for t in ctrl.taus]}: swaps "
        f"{[(s['step'], s['level']) for s in a['swaps']]} (tick, level); "
        f"{a['downshifts']} downshifts, {a['restores']} restores; captures "
        f"per plan in the warm-ups "
        f"{ {k: v['captures'] for k, v in per_plan.items()} }, "
        f"{out.counters['graph_captures']} in the drain")
    eng._swap_plan(ctrl.plan_for(0))
    with recording(eng) as events:
        fixed, _ = drain("ladder level 0, fixed")
    fixed_tl = continuous_logits(events, reqs)
    fixed_tl = {r.rid: (fixed.results[r.rid].tokens, fixed_tl[r.rid])
                for r in reqs}
    one = AdaptiveMPController(bundle=bundle, taus=ctrl.taus[:1],
                               objective=plan.objective,
                               **{k: v for k, v in LADDER.items()
                                  if k not in ("n_levels", "factor")})
    one._plans[0] = ctrl.plan_for(0)
    eng.adaptive = one
    out, _ = drain("one-level ladder")
    eng.adaptive = None
    never = hold_drain("one-level ladder", out, reqs, fixed_tl,
                       {r.rid for r in reqs}, MARGIN_BOUND_MP, failures)
    rec["adaptive"]["never_firing_bit_equal"] = never["bit_equal"]
    log(f"a ladder of one level: {never['bit_equal']} of {len(reqs)} "
        f"requests bit-equal to the fixed plan's drain")
    rec["warm_captures"] = warm_caps
    eng._swap_plan(None)
    if failures:
        raise AssertionError("; ".join(failures))
    return rec


# ---------------------------------------------------------------------------
# phase 18: the other dense configs at their published widths
# ---------------------------------------------------------------------------

# (config, depth served; None: the published one), the largest last; every
# fixed MP plan covers the later half of the layers. The three large
# configs serve 8 of their 32, 40 and 64 layers at full width: their eager
# twins (11.6 tokens/s for qwen2p5_32b at 64 layers) took up to 294 s of the
# script, which ran 1089.9 s of its 1200 s in one run at full depth
# ---------------------------------------------------------------------------
# phase 22: Mixture-of-Experts and multi-token prediction at full width
# ---------------------------------------------------------------------------

MOONLIGHT = "moonshot_v1_16b_a3b"
# DeepSeek-V3 past its dense prefix: its three dense MLA layers and MoE
# layers 3 and 4 at full width (26.6 B parameters), MTP off for serving
# (the launcher's ``--n-layers 5``)
DEEPSEEK_MOE_DEPTH = 5
# a first divergence between two drains of an MoE model may sit at a
# routing flip: a token whose top-k expert set differs between them, where
# the k-th and (k+1)-th router probabilities lie within this gap
ROUTE_FLIP_GAP = 2.0 ** -8
ROUTER = None                         # the RouterRecorder while phase 22 runs


class RouterRecorder:
    """Each MoE layer's top-(k+1) router probabilities and top-k experts of
    every row, written inside every serving step (its CUDA graph
    included) into a static buffer per (layer, rows): ``nn.moe``'s
    ``_one_chunk`` and ``route_top_k`` are wrapped while it is installed,
    and ``record_steps`` clones the decode step's buffers after each call.
    The wrapper takes the same stable sort as ``route_top_k``, so the
    served values are unchanged."""

    def __init__(self, torch):
        from repro_torch.nn import moe
        self.moe, self.bufs, self.scope = moe, {}, None
        self._chunk, self._top_k = moe._one_chunk, moe.route_top_k

        def one_chunk(p, ctx, scope, *a):
            self.scope = scope
            return self._chunk(p, ctx, scope, *a)

        def top_k(probs, k):
            vals, idx = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
            key = (self.scope, probs.shape[0])
            buf = self.bufs.get(key)
            if buf is None:
                buf = self.bufs[key] = (
                    torch.empty((probs.shape[0], k + 1), dtype=torch.float32,
                                device=probs.device),
                    torch.empty((probs.shape[0], k), dtype=torch.int64,
                                device=probs.device))
            with torch.no_grad():         # a buffer must not hold a graph
                buf[0].copy_(vals[:, :k + 1])
                buf[1].copy_(idx[:, :k])
            return vals[..., :k], idx[..., :k]

        moe._one_chunk, moe.route_top_k = one_chunk, top_k

    def remove(self) -> None:
        self.moe._one_chunk, self.moe.route_top_k = self._chunk, self._top_k

    def rows(self, n: int) -> dict:
        """scope -> (probabilities, experts) of a step over ``n`` rows."""
        return {scope: (v.clone(), i.clone())
                for (scope, r), (v, i) in self.bufs.items() if r == n}


def continuous_routes(events, reqs) -> dict:
    """rid -> per token of the drain: None for a prefill row (both drains
    of a comparison prefill alike), else {layer scope: (top-(k+1)
    probabilities, top-k experts)} of the decode row that gave it."""
    owner, slot_rid, rows = {}, {}, {r.rid: [] for r in reqs}
    for name, *rest in events:
        if name == "tick":
            owner = rest[0]
            continue
        if name == "prefill_chunk_step":
            _, _, start, valid, *_ = rest
            start, valid = start.cpu().numpy(), valid.cpu().numpy()
            for s in np.nonzero(valid)[0]:
                rid, eff_len = owner[s]
                slot_rid[s] = rid
                if start[s] + valid[s] == eff_len:
                    rows[rid].append(None)
        else:
            _, slots, routes = rest
            for s in slots:
                rows[slot_rid[s]].append(
                    {sc: (v[s].cpu().numpy(), i[s].cpu().numpy())
                     for sc, (v, i) in routes.items()})
    return rows


def _layer_order(scope: str) -> int:
    return int(scope.split("/")[1])


def first_flip(ra: list, rb: list, upto: int):
    """The first (token, layer) up to token ``upto`` whose top-k expert set
    differs between two drains' routes: (token, scope, the smaller of the
    two drains' k-th minus (k+1)-th probability, flipped (token, layer)
    pairs up to ``upto``), or None."""
    first, n_flips = None, 0
    for j in range(min(upto + 1, len(ra), len(rb))):
        if ra[j] is None or rb[j] is None:
            continue
        for sc in sorted(ra[j], key=_layer_order):
            (va, ia), (vb, ib) = ra[j][sc], rb[j][sc]
            if set(ia.tolist()) == set(ib.tolist()):
                continue
            n_flips += 1
            if first is None:
                k = ia.shape[0]
                gap = min(va[k - 1] - va[k], vb[k - 1] - vb[k])
                first = (j, sc, float(gap))
    return None if first is None else first + (n_flips,)


def compare_moe(name: str, got: dict, ref: dict, routes_got: dict,
                routes_ref: dict, *, tol: float, bound: float,
                failures: list) -> dict:
    """:func:`compare` for an MoE model: up to each request's first token
    divergence or first routing flip (a token whose top-k expert set
    differs between the drains), whichever comes first, the logits agree
    within ``tol``; the first flip's k-th to (k+1)-th probability gap must
    lie below ``ROUTE_FLIP_GAP``; and a token divergence may sit only at a
    near-tie of the reference's logits or at or after such a flip."""
    agreed = total = n_near = n_flip_req = 0
    err, problems = 0.0, []
    for rid in sorted(ref):
        (a, la), (r, lr) = got[rid], ref[rid]
        a, r = np.asarray(a), np.asarray(r)
        i = first_divergence(a, r)
        flip = first_flip(routes_got[rid], routes_ref[rid], i)
        stop = min(i + 1, len(r)) if flip is None else min(flip[0], i + 1)
        if stop:
            err = max(err, (la[:stop].float()
                            - lr[:stop].float()).abs().max().item())
        gaps = top2_gaps(lr)
        n_near += int((gaps < bound).sum())
        agreed += i
        total += len(r)
        if flip is not None:
            n_flip_req += 1
            j, sc, g, n_fl = flip
            log(f"{name}: request {rid}: expert set of {sc} differs at token "
                f"{j} (k-th / (k+1)-th probability gap {g:.3e}); "
                f"{n_fl} (token, layer) flips up to token "
                f"{min(i, len(r) - 1)}")
            if not g < ROUTE_FLIP_GAP:
                problems.append(f"request {rid}: routing flip at token {j} "
                                f"in {sc} with a gap {g:.3e} >= "
                                f"{ROUTE_FLIP_GAP:g}")
        if i < len(r):
            at_flip = flip is not None and flip[0] <= i
            log(f"{name}: request {rid} diverges at token {i} where the "
                f"reference's top-2 gap is {gaps[i]:.4f}"
                f"{' (after a routing flip)' if at_flip else ''}")
            if not (gaps[i] < bound or at_flip):
                problems.append(f"request {rid} diverges at token {i} with a "
                                f"top-2 gap {gaps[i]:.4f} >= {bound} and no "
                                f"routing flip before it")
    out = {"token_share": agreed / max(total, 1), "max_logit_err": err,
           "near_tie_share": n_near / max(total, 1),
           "requests_with_flips": n_flip_req}
    log(f"{name}: {100 * out['token_share']:.2f}% of tokens agree before "
        f"any divergence; logits before divergence or routing flip max abs "
        f"err {err:.4f} (tol {tol}); {n_flip_req} requests with a routing "
        f"flip; {100 * out['near_tie_share']:.2f}% of reference positions "
        f"have a top-2 gap below {bound}")
    if not err <= tol:
        problems.append(f"logits differ by {err:.4f} > {tol}")
    failures.extend(f"{name}: {p}" for p in problems)
    return out


def moe_plan(model, first: int, routed: bool = True):
    """Phase 5's plan on an MoE model: fp8 on every linear op (router,
    routed experts unless ``routed`` is False, shared experts, attention
    projections) of layers ``first`` on, plus the last layer's attention
    BGEMMs (which then gathers)."""
    from repro_torch.core.mpconfig import MPPlan
    last = model.cfg.n_layers - 1
    assignment = {op: "fp8_e4m3" for op in model.serving_op_names()
                  if op.startswith("layers/")
                  and int(op.split("/")[1]) >= first
                  and not op.endswith("_matmul")
                  and (routed or "/moe/experts/" not in op)}
    for op in ("qk_matmul", "av_matmul"):
        assignment[f"layers/{last}/attn/{op}"] = "fp8_e4m3"
    return MPPlan(assignment=assignment, groups=[], objective="ET", tau=0.0,
                  budget=0.0, predicted_loss_mse=0.0, predicted_gain=0.0)


def release_steps(model) -> None:
    """Drop the graphs of every serving step memoized on ``model`` (each
    holds its memory pool until the next drain rebinds it)."""
    for step in model.__dict__.get("_serving_steps", {}).values():
        step.release()


def moe_serve_phase(torch, model, params, route: str, plan_first: int,
                    routed: bool = True):
    """Phase 4's cell on an MoE model, every drain graphed: fused (route
    ``route``: every launch through it, decode steps x layers) against its
    eager twin bit for bit and against its lockstep twin bit for bit; fused
    against gather at the routing rule (:func:`compare_moe`); the same
    fused and gather drains under :func:`moe_plan` from layer
    ``plan_first`` (``routed``: with the routed experts). Vacant decode
    rows and bucket padding are routed and take capacity, as in the
    reference. Each drain's graphs are released after it."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.quant import weight_cache
    cfg = model.cfg
    n_layers = cfg.n_layers
    reqs = phase4_requests(model)
    failures: list = []
    routes: dict = {}

    def drain(label, **kw):
        events: list = []
        out = run_continuous(torch, model, params, reqs, steps_out=events,
                             **kw)
        routes[label] = continuous_routes(events, reqs)
        release_steps(model)
        gc.collect()
        return out

    fused, n_fused, fused_tl = drain("fused", paged_attn="fused",
                                     route=route)
    if n_fused != fused.n_steps * n_layers or n_fused == 0:
        raise AssertionError(f"{cfg.name} fused launches {n_fused} != "
                             f"{fused.n_steps} steps x {n_layers} layers")
    hg = None
    if route == "gqa_mma":
        n_pages = -(-(SERVE["prompt_len"] + SERVE["new_tokens"])
                    // SERVE["block_size"])
        hg = pa.head_group(cfg.n_heads // cfg.n_kv_heads, cfg.d_head, 0,
                           n_pages, SERVE["block_size"],
                           rows=SERVE["n_slots"] * cfg.n_kv_heads,
                           sms=pa._sm_count(torch.device(DEVICE)),
                           route=route)
    log(f"{cfg.name} fused: {fused.n_steps} decode steps, {n_fused} kernel "
        f"launches, all through {route}"
        f"{'' if hg is None else f' at a head group of {hg}'}")
    _, _, eager_tl = drain("fused_eager", paged_attn="fused", route=route,
                           eager=True)
    graphs = {"fused": graph_vs_eager(f"{cfg.name} fused", fused_tl,
                                      eager_tl, failures)}
    lock, n_lock, lock_tl = drain("fused_lockstep", paged_attn="fused",
                                  route=route, sync=True)
    n_eq = bit_equal(fused_tl, lock_tl)
    log(f"{cfg.name} fused: pipelined vs lockstep {n_eq} of {len(lock_tl)} "
        f"requests bit-equal (launches {n_fused} / {n_lock})")
    if n_eq != len(lock_tl) or n_lock != n_fused:
        failures.append(f"{cfg.name}: pipelined vs lockstep {n_eq} of "
                        f"{len(lock_tl)} bit-equal")
    gather, n_gather, gather_tl = drain("gather", paged_attn="gather")
    if n_gather:
        raise AssertionError(f"gather drain launched the kernel {n_gather} "
                             f"times")
    agree = {"fused_vs_gather": compare_moe(
        f"{cfg.name} fused vs gather", fused_tl, gather_tl, routes["fused"],
        routes["gather"], tol=LOGIT_TOL, bound=MARGIN_BOUND,
        failures=failures)}
    plan = moe_plan(model, plan_first, routed)
    mp_f, n_mp, mp_f_tl = drain("mp_fused", mp=plan, paged_attn="fused",
                                route=route)
    if n_mp != mp_f.n_steps * (n_layers - 1):
        raise AssertionError(f"{cfg.name} MP launches {n_mp} != "
                             f"{mp_f.n_steps} steps x {n_layers - 1} fused "
                             f"layers")
    kept, of = weight_cache.nbytes(torch.device(DEVICE))
    mp_g, _, mp_g_tl = drain("mp_gather", mp=plan, paged_attn="gather")
    agree["mp_fused_vs_mp_gather"] = compare_moe(
        f"{cfg.name} MP fused vs MP gather", mp_f_tl, mp_g_tl,
        routes["mp_fused"], routes["mp_gather"], tol=LOGIT_TOL_MP,
        bound=MARGIN_BOUND_MP, failures=failures)
    peak = max(mp_f.counters["peak_device_gb"],
               mp_g.counters["peak_device_gb"])
    log(f"{cfg.name} MP plan ({plan.n_quantized} fp8 ops, layers "
        f"{plan_first}-{n_layers - 1}"
        f"{'' if routed else ', routed experts left in bf16'}): weight "
        f"cache {kept / 1e9:.2f} GB of fp8 codes for {of / 1e9:.2f} GB of "
        f"bf16 weights; peak device memory {peak:.2f} GB")
    if failures:
        raise AssertionError("; ".join(failures))
    log(f"{cfg.name} tokens/s: fused {fused.tokens_per_s:.1f} (lockstep "
        f"{lock.tokens_per_s:.1f}), gather {gather.tokens_per_s:.1f}, MP "
        f"fused {mp_f.tokens_per_s:.1f}, MP gather {mp_g.tokens_per_s:.1f}")
    return {"kernel_launches_main_path": n_fused, "head_group": hg,
            "graph_vs_eager": graphs, "pipelined_vs_lockstep_bit_equal":
            n_eq, "agreement": agree,
            "mp_plan": {"fp8_ops": plan.n_quantized, "routed": routed,
                        "layers": [plan_first, n_layers - 1]},
            "weight_cache_gb": kept / 1e9,
            "serving": {"fused": serving_numbers(fused),
                        "fused_lockstep": serving_numbers(lock),
                        "gather": serving_numbers(gather),
                        "mp_fused": serving_numbers(mp_f),
                        "mp_gather": serving_numbers(mp_g)}}


def router_kernel_check(torch) -> dict:
    """Kernels 1-3 on the router's form under an fp8 assignment with
    ``impl="kernel"``: an f32 (tokens, d_model) activation times the f32
    (experts, d_model) router weight, f32 out, at N = E of the smoke and
    the two MoE configs, against the plain versions."""
    from repro_torch.kernels import fp8_matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_cast as qc
    out = {}
    for E, C in ((8, 2048), (64, 2048), (256, 7168)):
        x = randn(torch, (512, C), 11, 1.0, torch.float32)
        w = randn(torch, (E, C), 12, C ** -0.5, torch.float32)
        n0 = (qc.launches["amax"], mm.launches)
        got = ops.fp8_linear(x, w, out_dtype=torch.float32)
        launched = (qc.launches["amax"] - n0[0], mm.launches - n0[1])
        # the same call on CPU copies takes the plain versions
        want = ops.fp8_linear(x.cpu(), w.cpu(),
                              out_dtype=torch.float32).to(DEVICE)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        log(f"router form E {E} C {C}: fp8_linear (f32 in, f32 out) vs "
            f"plain max abs err {err:.3e} of max {scale:.3f}; amax + "
            f"fp8_matmul launches {launched}")
        if got.dtype != torch.float32 or launched != (2, 1) or \
                err > MM_TOL * scale:
            raise AssertionError(f"router form E {E}: dtype {got.dtype}, "
                                 f"launches {launched}, err {err:.3e}")
        out[str(E)] = err
    return out


# phase 22's two configurations: (arch, depth (None: all layers), other
# overrides, paged kernel route)
# (arch, serving depth, calibration depth (None: the whole config), extra
# config, decode route). Moonlight is served at 8 of its 48 layers (the
# script's time limit: at all 48 its drains took most of phase 22's 122 s);
# DeepSeek at its dense layers and two MoE layers
MOONLIGHT_DEPTH = 8
MOE_CONFIGS = ((MOONLIGHT, MOONLIGHT_DEPTH, None, {}, "gqa_mma"),
               (DEEPSEEK, DEEPSEEK_MOE_DEPTH, DEEPSEEK_MOE_DEPTH,
                dict(mla_absorb_decode=True), "mla_mma"))


def moe_config_phase(torch, arch: str, depth, cal_depth, extra: dict,
                     route: str) -> dict:
    """Phase 22 for one configuration: random weights from a seeded
    generator on the card at ``depth`` layers, served as
    :func:`moe_serve_phase` says (the plan on the later half of
    Moonlight's layers, on DeepSeek's last layer), then calibrated at the
    depth :func:`fitted_calibration` gives on its first ``cal_depth``
    layers (None: all) with the configuration's own MTP module
    (DeepSeek's: depth 1)."""
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.launch.serve import make_model_and_params
    from repro_torch.models.registry import depth_overrides, get_config
    from repro_torch.quant import weight_cache
    global ROUTER
    t0 = time.perf_counter()
    ov = dict(depth_overrides(arch, depth) if depth else {}, **extra)
    model, params = make_model_and_params(arch, False, DEVICE, seed=0, **ov)
    torch.cuda.synchronize()
    cfg = model.cfg
    weights_gb = torch.cuda.memory_allocated() / 1e9
    log(f"{arch}: {model.n_params() / 1e9:.3f}B params ({cfg.n_layers} "
        f"layers, MoE layers {cfg.moe_layers[0]}-{cfg.moe_layers[-1]} of "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, "
        f"{cfg.moe.n_shared_experts} shared, d_model {cfg.d_model}, "
        f"{cfg.n_heads} / {cfg.n_kv_heads} heads), random init in "
        f"{time.perf_counter() - t0:.1f} s, {weights_gb:.2f} GB on the card")
    full = get_config(arch)
    if cfg.n_layers < full.n_layers:
        why = (f"the script's time limit; all {full.n_layers} hold "
               f"{lm_bytes(full) / 1e9:.1f} GB of bf16 weights"
               if arch == MOONLIGHT else
               f"its dense layers and MoE layers {cfg.moe_layers[0]}-"
               f"{cfg.moe_layers[-1]}: all {full.n_layers} hold "
               f"{lm_bytes(full) / 1e12:.2f} TB of bf16 weights")
        log(f"CUT: {arch} served at depth {cfg.n_layers} of "
            f"{full.n_layers} ({why})")
    torch.cuda.reset_peak_memory_stats()
    ROUTER = RouterRecorder(torch)
    try:
        # Moonlight: the later half of its layers; DeepSeek: its last
        # layer without the routed experts, whose fp8 codes (11.3 GB) and
        # dequantized operand (7.5 GB a use) do not fit beside 53 GB
        if arch == MOONLIGHT:
            rec = moe_serve_phase(torch, model, params, route,
                                  cfg.n_layers // 2)
        else:
            rec = moe_serve_phase(torch, model, params, route,
                                  cfg.n_layers - 1, routed=False)
    finally:
        ROUTER.remove()
        ROUTER = None
    rec.update(weights_gb=weights_gb, n_params=model.n_params(),
               serving_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"{arch}: peak device memory while serving "
        f"{rec['serving_peak_gb']:.2f} GB")
    del model, params
    weight_cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    data = SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size,
                                       batch=CAL_SHAPE[0],
                                       seq_len=CAL_SHAPE[1]), DEVICE)
    rec["calibration"] = fitted_calibration(
        torch, arch, list(data.batches(0, CAL_BATCHES)), cal_depth)
    return rec


def lm_bytes(cfg) -> int:
    from repro_torch.models.lm import LM
    from repro_torch.nn.spec import param_bytes
    return param_bytes(LM(cfg).param_specs())


def moe_phase(torch) -> dict:
    """Phase 22: the fp8 kernels on the router's form, then Moonlight's
    config at full width (served at 8 of its 48 MoE layers, calibrated on
    all 48's config) and DeepSeek-V3 at depth 5 (three dense MLA layers
    and MoE layers 3 and 4, MTP off for serving), each freed before the
    next."""
    out = {"router_kernels": router_kernel_check(torch)}
    for arch, depth, cal_depth, extra, route in MOE_CONFIGS:
        out[arch] = moe_config_phase(torch, arch, depth, cal_depth, extra,
                                     route)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# served at 1 layer each (the script's time limit; 8 before phase 24 was
# added, 4 before phase 27, 2 before phase 28)
DENSE_CONFIGS = (("qwen2p5_3b", 1), ("nemotron_4_15b", 1),
                 ("starcoder2_15b", 1), ("qwen2p5_32b", 1))


def dense_config_phase(torch, arch: str, depth) -> dict:
    """Phase 18 for one config: random weights from a seeded device
    generator at its published widths and ``depth`` layers (None: all);
    phases 4 and 5's checks at phase 4's cell (every fused launch through
    ``gqa_mma``; the gather drains without eager twins); peak device
    memory; for qwen2p5_3b also calibration over phase 6's batches at the
    largest depth that fits."""
    from repro_torch.launch.serve import make_model_and_params
    from repro_torch.models.registry import get_config
    t0 = time.perf_counter()
    model, params = make_model_and_params(
        arch, False, DEVICE, seed=0,
        **({} if depth is None else {"n_layers": depth}))
    torch.cuda.synchronize()
    cfg = model.cfg
    weights_gb = torch.cuda.memory_allocated() / 1e9
    log(f"{arch}: {model.n_params() / 1e9:.3f}B params ({cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} "
        f"heads (G {cfg.n_heads // cfg.n_kv_heads}), d_head {cfg.d_head}, "
        f"{cfg.activation}, {cfg.norm}, "
        f"{'tied' if cfg.tie_embeddings else 'untied'} head"
        f"{', QKV bias' if cfg.qkv_bias else ''}), random init in "
        f"{time.perf_counter() - t0:.1f} s, {weights_gb:.2f} GB on the card")
    torch.cuda.reset_peak_memory_stats()
    out = serve_phase(torch, model, params, gather_eager=False)
    out.update(weights_gb=weights_gb, n_params=model.n_params(),
               serving_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"{arch}: peak device memory while serving "
        f"{out['serving_peak_gb']:.2f} GB")
    if arch == "qwen2p5_3b":
        from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
        data = SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size,
                                           batch=CAL_SHAPE[0],
                                           seq_len=CAL_SHAPE[1]), DEVICE)
        batches = list(data.batches(0, CAL_BATCHES))
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        out["calibration"] = fitted_calibration(torch, arch, batches)
    return out


# ---------------------------------------------------------------------------
# phase 23: Mamba-2 and Hymba (SSM and hybrid blocks), the paper's baselines
# ---------------------------------------------------------------------------

MAMBA = "mamba2_370m"
HYMBA = "hymba_1p5b"
# Hymba's request whose prompt outruns its 1024-token window, chunked at a
# multiple of its SSD chunk (256): its windowed layers read tables cut by
# the window from the fifth chunk on
WINDOW_CUT = dict(prompt_len=1536, chunk_len=256, new_tokens=16)
# Fig. 2's second budget: this share of the loss MSE of every op in fp8
FIG2_BINDING = 0.25
# the depths phase 23 serves at (the script's time limit: at full depth its
# drains took most of the phase's 174 s); both configs calibrate at full
# depth. Hymba's first 4 layers keep its global-attention layer 0 and
# three windowed ones
SSM_SERVE_DEPTH = {MAMBA: 8, HYMBA: 4}


def ssm_kernel_check(torch) -> dict:
    """Kernels 1-3 at the SSM configs' linear shapes (``impl="kernel"``
    form, bf16 in and out, 64 tokens): Mamba-2's in_proj (N 4384, K
    1024), Hymba's (N 6482, K 1600: K is no multiple of the GEMM's 128-byte
    slab) and Hymba's tied head (N 32001: bf16 output rows not 16-byte
    aligned), against the plain versions on CPU copies; then kernel 5 at
    Hymba's head shape (D 64, 5 KV heads of 5) with its 1024-key window
    over tables longer than it, against its plain version."""
    from repro_torch.kernels import fp8_matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import quant_cast as qc
    from repro_torch.kernels.ref import paged_decode_attention_ref
    out = {"fp8_linear": {}}
    for name, (N, K) in (("mamba2_in_proj", (4384, 1024)),
                         ("hymba_in_proj", (6482, 1600)),
                         ("hymba_lm_head", (32001, 1600))):
        x = randn(torch, (64, K), 21, 1.0, torch.bfloat16)
        w = randn(torch, (N, K), 22, K ** -0.5, torch.bfloat16)
        n0 = (qc.launches["amax"], mm.launches)
        got = ops.fp8_linear(x, w, out_dtype=torch.bfloat16)
        launched = (qc.launches["amax"] - n0[0], mm.launches - n0[1])
        want = ops.fp8_linear(x.cpu(), w.cpu(),
                              out_dtype=torch.bfloat16).to(DEVICE)
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        log(f"fp8_linear {name} (64 x {K} by {N} x {K}, bf16 out): kernel "
            f"vs plain max abs err {err:.3e} of max {scale:.3f}; amax + "
            f"fp8_matmul launches {launched}")
        if got.shape != (64, N) or launched[1] != 1 or \
                not err <= MM_TOL * scale:
            raise AssertionError(f"fp8_linear {name}: shape "
                                 f"{tuple(got.shape)}, launches {launched}, "
                                 f"err {err:.3e}")
        out["fp8_linear"][name] = err
    kw = dict(scale=8.0, scale_mode="div", score_dtype=torch.bfloat16,
              probs_dtype=torch.bfloat16, out_dtype=torch.bfloat16,
              window=1024)
    errs, bitwise = [], 0
    for kv_name, kv_dtype in (("bf16", torch.bfloat16),
                              ("fp8_e4m3", torch.float8_e4m3fn)):
        args = paged_case(torch, 2, kv_dtype, 224.0,
                          lengths=(1552, 1100, 1025, 0), d=64, g=5, hkv=5)
        n0 = pa.launches_by_route["gqa_mma"]
        got = pa.paged_decode_attention(*args, **kw)
        want = paged_decode_attention_ref(*args, **kw)
        torch.cuda.synchronize()
        if pa.launches_by_route["gqa_mma"] != n0 + 1:
            raise AssertionError(f"Hymba window kv {kv_name}: not launched "
                                 f"through gqa_mma")
        err = (got.float() - want.float()).abs().max().item()
        errs.append(err)
        bitwise += int(torch.equal(got, want))
        log(f"GQA kernel vs plain at Hymba's shape, window 1024 over tables "
            f"of 1552/1100/1025 keys, kv {kv_name}: max abs err {err:.3e} "
            f"(tol {KERNEL_TOL:g}), bitwise {bool(torch.equal(got, want))}")
        if not torch.allclose(got.float(), want.float(), rtol=KERNEL_TOL,
                              atol=KERNEL_TOL):
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"at Hymba's window, kv {kv_name}")
    out.update(window_max_abs_err=max(errs), window_bitwise=bitwise)
    return out


def fused_layers(model, plan) -> int:
    """Layers whose decode attention takes the kernel under ``plan``: the
    attention layers whose ``qk_matmul`` and ``av_matmul`` stay unquantized
    (``nn.layers.use_fused_paged``)."""
    cfg, asg = model.cfg, plan.assignment if plan is not None else {}
    return sum(1 for i, b in enumerate(cfg.block_types)
               if b in ("attn", "hybrid")
               and f"layers/{i}/attn/qk_matmul" not in asg
               and f"layers/{i}/attn/av_matmul" not in asg)


def ssm_serve_phase(torch, model, params, plan) -> dict:
    """Phase 4's cell on an SSM or hybrid model, plain and under ``plan``
    (the ET plan its calibration solved), every drain graphed: paged
    (fused; Hymba's kernel launches all through ``gqa_mma``, decode steps
    x the layers the plan leaves fused; Mamba-2 has no attention and
    launches none) against its eager twin and its lockstep twin bit for
    bit; Hymba fused against gather at the near-tie rule (under its plan
    with ``LOGIT_TOL_HYBRID_MP``), and its dense rings against the
    paged gather drain (bit-equal requests counted).
    Each drain's graphs are released after it."""
    cfg = model.cfg
    hybrid = "hybrid" in cfg.block_types
    route = "gqa_mma" if hybrid else None
    reqs = phase4_requests(model)
    failures: list = []
    out = {"graph_vs_eager": {}, "pipelined_vs_lockstep_bit_equal": {},
           "agreement": {}, "serving": {}, "kernel_launches": {},
           "mp_plan": {"fp8_ops": plan.n_quantized,
                       "fused_layers": fused_layers(model, plan)}}

    def drain(**kw):
        res = run_continuous(torch, model, params, reqs, **kw)
        release_steps(model)
        gc.collect()
        return res

    for label, mp in (("plain", None), ("mp", plan)):
        n_attn = fused_layers(model, mp)
        fused, n_fused, fused_tl = drain(mp=mp, paged_attn="fused",
                                         route=route)
        if n_fused != fused.n_steps * n_attn:
            raise AssertionError(f"{cfg.name} {label} fused launches "
                                 f"{n_fused} != {fused.n_steps} steps x "
                                 f"{n_attn} fused layers")
        _, _, eager_tl = drain(mp=mp, paged_attn="fused", route=route,
                               eager=True)
        out["graph_vs_eager"][label] = graph_vs_eager(
            f"{cfg.name} {label} fused", fused_tl, eager_tl, failures)
        lock, n_lock, lock_tl = drain(mp=mp, paged_attn="fused", route=route,
                                      sync=True)
        n_eq = bit_equal(fused_tl, lock_tl)
        log(f"{cfg.name} {label} fused: pipelined vs lockstep {n_eq} of "
            f"{len(lock_tl)} requests bit-equal (launches {n_fused} / "
            f"{n_lock})")
        if n_eq != len(lock_tl) or n_lock != n_fused:
            failures.append(f"{cfg.name} {label}: pipelined vs lockstep "
                            f"{n_eq} of {len(lock_tl)} bit-equal")
        out["pipelined_vs_lockstep_bit_equal"][label] = n_eq
        out["kernel_launches"][label] = n_fused
        out["serving"][f"{label}_fused"] = serving_numbers(fused)
        out["serving"][f"{label}_fused_lockstep"] = serving_numbers(lock)
        if not hybrid:
            continue
        bound = (dict(tol=LOGIT_TOL, bound=MARGIN_BOUND)
                 if mp is None else
                 dict(tol=LOGIT_TOL_HYBRID_MP, bound=MARGIN_BOUND_MP))
        gather, n_gather, gather_tl = drain(mp=mp, paged_attn="gather")
        if n_gather:
            raise AssertionError(f"gather drain launched the kernel "
                                 f"{n_gather} times")
        out["agreement"][f"{label}_fused_vs_gather"] = compare(
            f"{cfg.name} {label} fused vs gather", fused_tl, gather_tl,
            failures=failures, **bound)
        out["serving"][f"{label}_gather"] = serving_numbers(gather)
        if mp is None:
            dense, _, dense_tl = drain(paged_attn=None, paged=False,
                                       name="dense")
            agree = compare(f"{cfg.name} dense vs paged gather", dense_tl,
                            gather_tl, failures=failures, **bound)
            agree["bit_equal_requests"] = bit_equal(dense_tl, gather_tl)
            out["agreement"]["dense_vs_paged_gather"] = agree
            out["serving"]["dense"] = serving_numbers(dense)
    if failures:
        raise AssertionError("; ".join(failures))
    s = out["serving"]
    log(f"{cfg.name} tokens/s: fused {s['plain_fused']['tokens_per_s']:.1f} "
        f"(lockstep {s['plain_fused_lockstep']['tokens_per_s']:.1f}), under "
        f"the ET plan ({plan.n_quantized} fp8 ops) "
        f"{s['mp_fused']['tokens_per_s']:.1f}")
    out["kernel_launches_main_path"] = out["kernel_launches"]["plain"]
    return out


def window_cut_phase(torch, model, params) -> dict:
    """Hymba's ``WINDOW_CUT`` request, paged, chunked at 256 (the SSD
    chunk), fused against gather: from its fifth prompt chunk on, its
    windowed layers attend tables longer than their 1024-key window (the
    kernel and the gather path each cut them); fused launches all through
    ``gqa_mma``, decode steps x layers; logits at the near-tie rule."""
    from repro_torch.serve import Request
    spec = WINDOW_CUT
    vocab = model.cfg.vocab_size
    req = [Request(rid=0, tokens=random_prompt(vocab, spec["prompt_len"],
                                               2323),
                   max_new_tokens=spec["new_tokens"])]
    warm = warm_request(vocab, spec["chunk_len"], 2)
    kw = dict(chunk_len=spec["chunk_len"], warm=warm,
              max_len=spec["prompt_len"] + spec["new_tokens"])
    failures: list = []
    fused, n_fused, f_tl = run_continuous(torch, model, params, req,
                                          paged_attn="fused",
                                          route="gqa_mma", **kw)
    release_steps(model)
    gather, _, g_tl = run_continuous(torch, model, params, req,
                                     paged_attn="gather", **kw)
    release_steps(model)
    if n_fused != fused.n_steps * model.cfg.n_layers:
        raise AssertionError(f"window cut: launches {n_fused} != "
                             f"{fused.n_steps} x {model.cfg.n_layers}")
    window = model.cfg.sliding_window
    longest = spec["prompt_len"] + spec["new_tokens"] - 1
    agree = compare(f"{model.cfg.name} {spec['prompt_len']}-token prompt "
                    f"over a {window}-key window, fused vs gather", f_tl,
                    g_tl, tol=LOGIT_TOL, bound=MARGIN_BOUND,
                    failures=failures)
    if failures:
        raise AssertionError("; ".join(failures))
    n_windowed = model.cfg.n_layers - len(model.cfg.global_attn_layers)
    log(f"window cut: {fused.counters['prefill_chunks']} prefill chunks of "
        f"{spec['chunk_len']}, decode tables up to {longest} keys against "
        f"a {window}-key window on {n_windowed} of {model.cfg.n_layers} "
        f"layers; {n_fused} fused launches")
    return {"agreement": agree, "kernel_launches": n_fused,
            "prefill_chunks": fused.counters["prefill_chunks"],
            "longest_table": longest,
            "serving": {"fused": serving_numbers(fused),
                        "gather": serving_numbers(gather)}}


def table_gain(bundle, assignment: dict, objective: str = "ET") -> float:
    """An assignment's predicted gain on ``bundle``'s gain tables: each
    group's row for the combo the assignment gives its ops (ops in no
    group gain nothing)."""
    from repro_torch.core.timegain import enumerate_combos
    entry = bundle.objectives[objective]
    total = 0.0
    for group, gains in zip(entry["groups"], entry["gains"]):
        combo = tuple(assignment.get(n, bundle.ref_format) for n in group)
        total += float(gains[enumerate_combos(len(group),
                                              bundle.formats).index(combo)])
    return total


def fig2_rows(bundle, plan, name: str, objective: str = "ET") -> dict:
    """The paper's Fig. 2 on ``bundle``'s ``objective`` tables: the IP
    plan (``plan``, solved at ``TAU``), Random and Prefix (Sec. 3.1) at
    the plan's budget and at one that binds (``FIG2_BINDING`` of the loss
    MSE of every op in fp8), each with its predicted gain on the same
    tables and its predicted loss MSE."""
    from repro_torch.core.baselines import prefix_strategy, random_strategy
    names = bundle.op_names                  # execution (topological) order
    everything = bundle.sens.loss_mse(dict.fromkeys(names, "fp8_e4m3"))
    # the plan's tau, and one whose budget binds (a quarter of the loss MSE
    # of every op in fp8): at an ample budget every strategy takes all
    tight = math.sqrt(FIG2_BINDING * everything / bundle.sens.loss_sq_mean)
    fig2 = {}
    for tau in (TAU, tight):
        ip = plan if tau == TAU else bundle.solve(tau, "ET")
        if abs(table_gain(bundle, ip.assignment, objective)
               - ip.predicted_gain) > 1e-9 * max(1.0, abs(ip.predicted_gain)):
            raise AssertionError("the tables price the IP plan differently "
                                 "from the solver")
        rows = {}
        for label, asg in (("IP-ET", ip.assignment),
                           ("Random", random_strategy(names, bundle.sens,
                                                      ip.budget, seed=1)),
                           ("Prefix", prefix_strategy(names, bundle.sens,
                                                      ip.budget))):
            gain = table_gain(bundle, asg, objective)
            mse = bundle.sens.loss_mse(asg)
            rows[label] = {"n_fp8": len(asg), "predicted_gain": gain,
                           "predicted_loss_mse": mse}
            log(f"{name} Fig. 2 at tau {tau:.4g} (budget "
                f"{ip.budget:.4e} of {everything:.4e} for every op in fp8; "
                f"{ip.meta['gain_tier']} ET tables): {label:7s} "
                f"{len(asg):4d} of {len(names)} ops fp8, predicted gain "
                f"{gain * 1e3:.4f} ms, predicted loss MSE {mse:.4e}")
            if mse > ip.budget * (1 + 1e-9):
                raise AssertionError(f"{label} over the budget")
        fig2[f"tau_{tau:.4g}"] = dict(rows, budget=ip.budget)
    return fig2


def ssm_calibration(torch, model, params) -> tuple:
    """Algorithm 1 on the model at full depth (both configs fit the card
    with room to spare): phase 6's batches, seconds and peak memory,
    groups against ``core.graphs``, the ET plan at ``TAU``; then the
    paper's Random and Prefix baselines (Sec. 3.1, Fig. 2) at the plan's
    budget and at a budget that binds (``FIG2_BINDING``), each with its
    predicted gain on the same tables and its predicted loss MSE beside the
    IP's. Returns (record, the ET plan)."""
    from repro_torch.core.pipeline import AMPOptions, build_groups, calibrate
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.hw.profiles import H100_SXM
    cfg = model.cfg
    data = SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size,
                                       batch=CAL_SHAPE[0],
                                       seq_len=CAL_SHAPE[1]), DEVICE)
    batches = list(data.batches(0, CAL_BATCHES))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = calibrate(model, params, batches, AMPOptions(hw=H100_SXM))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    sens = np.array(sorted(bundle.sens.sensitivity.values()))
    n_groups = len(bundle.objectives["ET"]["groups"])
    want = len(build_groups(model, AMPOptions(),
                            quantizable=set(bundle.op_names))[1])
    n_ssd = sum(1 for op in bundle.op_names if op.endswith((
        "cb_matmul", "att_x_matmul", "bx_matmul", "c_state_matmul")))
    log(f"{cfg.name} calibrate at full depth ({cfg.n_layers} layers): "
        f"{len(bundle.sens.ops)} ops ({n_ssd} SSD products), {n_groups} "
        f"groups, {CAL_BATCHES} batches of {CAL_SHAPE} in {seconds:.1f} s; "
        f"peak device memory {peak / 1e9:.2f} GB")
    if not (np.isfinite(sens).all() and (sens >= 0).all()
            and math.isfinite(bundle.sens.loss_mean)):
        raise AssertionError(f"{cfg.name}: non-finite sensitivity")
    if n_groups != want or not n_ssd:
        raise AssertionError(f"{cfg.name}: {n_groups} groups, core.graphs "
                             f"gives {want}; {n_ssd} SSD ops")
    plan = bundle.solve(TAU, "ET")
    fig2 = fig2_rows(bundle, plan, cfg.name)
    return {"seconds": seconds, "peak_gb": peak / 1e9,
            "n_ops": len(bundle.sens.ops), "n_ssd_ops": n_ssd,
            "n_groups": n_groups, "loss_mean": bundle.sens.loss_mean,
            "et_plan_n_fp8": plan.n_quantized, "budget": plan.budget,
            "fig2": fig2}, plan


def kept_plan(plan, n_layers: int):
    """``plan`` with only the ops of the first ``n_layers`` layers (and the
    head): the ops a model cut to that depth runs."""
    from repro_torch.core.mpconfig import MPPlan
    asg = {op: f for op, f in plan.assignment.items()
           if not op.startswith("layers/") or int(op.split("/")[1]) < n_layers}
    return MPPlan(assignment=asg, groups=[], objective=plan.objective,
                  tau=plan.tau, budget=plan.budget,
                  predicted_loss_mse=plan.predicted_loss_mse,
                  predicted_gain=plan.predicted_gain)


def ssm_config_phase(torch, arch: str) -> dict:
    """Phase 23 for one configuration at full width, random weights from a
    seeded generator: calibrated at full depth with the baselines
    (:func:`ssm_calibration`), then served at ``SSM_SERVE_DEPTH`` layers
    (the cut printed) plain and under the solved ET plan's ops of those
    layers (:func:`ssm_serve_phase`), then Hymba's window cut
    (:func:`window_cut_phase`)."""
    from repro_torch.launch.serve import make_model_and_params
    from repro_torch.models.registry import depth_overrides
    t0 = time.perf_counter()
    model, params = make_model_and_params(arch, False, DEVICE, seed=0)
    torch.cuda.synchronize()
    cfg = model.cfg
    weights_gb = torch.cuda.memory_allocated() / 1e9
    ssm = cfg.ssm
    log(f"{arch}: {model.n_params() / 1e9:.3f}B params ({cfg.n_layers} "
        f"{cfg.block_types[0]} layers, d_model {cfg.d_model}, d_inner "
        f"{ssm.d_inner}, {ssm.n_heads} SSM heads of {ssm.head_dim}, d_state "
        f"{ssm.d_state}, SSD chunk {ssm.chunk}"
        + (f", {cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.d_head}, "
           f"window {cfg.sliding_window} but layers "
           f"{cfg.global_attn_layers}" if cfg.n_heads else "")
        + f", vocab {cfg.vocab_size}), random init in "
        f"{time.perf_counter() - t0:.1f} s, {weights_gb:.2f} GB on the card")
    calibration, plan = ssm_calibration(torch, model, params)
    n_params = model.n_params()
    depth = SSM_SERVE_DEPTH[arch]
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    model, params = make_model_and_params(arch, False, DEVICE, seed=0,
                                          **depth_overrides(arch, depth))
    plan = kept_plan(plan, depth)
    log(f"CUT: {arch} served at depth {depth} of {cfg.n_layers} (the "
        f"script's time limit; calibrated at full depth), under the ET "
        f"plan's {plan.n_quantized} fp8 ops of those layers"
        + (f"; layers {model.cfg.global_attn_layers} global, the others "
           f"windowed" if model.cfg.sliding_window else ""))
    torch.cuda.reset_peak_memory_stats()
    rec = ssm_serve_phase(torch, model, params, plan)
    if arch == HYMBA:
        rec["window_cut"] = window_cut_phase(torch, model, params)
    rec.update(weights_gb=weights_gb, n_params=n_params,
               serving_depth=depth,
               serving_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               calibration=calibration)
    log(f"{arch}: peak device memory while serving "
        f"{rec['serving_peak_gb']:.2f} GB")
    release_steps(model)
    return rec


def ssm_phase(torch) -> dict:
    """Phase 23: the kernels at the SSM configs' shapes, then Mamba-2 370M
    and Hymba 1.5B, each freed before the next."""
    out = {"kernels": ssm_kernel_check(torch)}
    for arch in (MAMBA, HYMBA):
        out[arch] = ssm_config_phase(torch, arch)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 24: Whisper (encoder-decoder) and LLaVA (prefix embeddings)
# ---------------------------------------------------------------------------

WHISPER = "whisper_base"
LLAVA = "llava_next_34b"
# 4 requests of Whisper's 30-s window (1500 encoder frames) with a 4-token
# decoder prompt and 64 new tokens, one batch through ServeEngine.generate
WHISPER_SERVE = dict(requests=4, frames=1500, prompt_len=4, new_tokens=64)
# calibration batches: (2, 1500, 512) frames with (2, 256) decoder tokens;
# the measured tier times forwards of the first batch's first row (one
# request: (1, 1500, 512) frames, 256 tokens)
WHISPER_CAL_FRAMES = 1500
WHISPER_TIER_ROWS = 1
# the measured tier tabulates Whisper cut to its first 2 of 6 layer pairs
# (the depth fit's calibrated model): its assignments scale with the
# groups, 21 of the full depth's 61 (the script's time limit)
WHISPER_TIER_DEPTH = 2
# LLaVA is served at 2 of its 60 layers (8 before phase 27, 4 before
# phase 28; the script's limit: 34.4 B parameters, 68.8 GB in bf16, at all
# 60)
LLAVA_DEPTH = 2
# one-shot: 4 requests of a 576-token image prefix (LLaVA's 24 x 24
# patches) and 128 text tokens, 32 new tokens
LLAVA_ONESHOT = dict(requests=4, prefix=576, prompt_len=128, new_tokens=32)
# kernels 1-3 at the two models' linear shapes (N, K), at the rows their
# path gives them: Whisper's encoder in the measured tier's forward (2 x
# 1500 frames), LLaVA's one-shot prefill (4 x (576 + 128) positions).
# Whisper's head (N 51865, odd) is also timed at N 51866 and 51872 (even,
# a multiple of 16), which isolates the cost of its unpaired stores
ENCDEC_VLM_GEMMS = {
    "whisper": (2 * WHISPER_CAL_FRAMES, {
        "q_proj": (512, 512), "up_proj": (2048, 512),
        "down_proj": (512, 2048), "lm_head": (51865, 512),
        "lm_head_n51866": (51866, 512), "lm_head_n51872": (51872, 512)}),
    "llava": (LLAVA_ONESHOT["requests"] * (LLAVA_ONESHOT["prefix"]
                                           + LLAVA_ONESHOT["prompt_len"]), {
        "q_proj": (7168, 7168), "k_proj": (1024, 7168),
        "gate_proj": (20480, 7168), "down_proj": (7168, 20480),
        "lm_head": (64000, 7168)})}


def encdec_vlm_kernels(torch) -> dict:
    """Kernels 1-3 at ``ENCDEC_VLM_GEMMS`` through :func:`fp8_check_phase`
    and :func:`fp8_time_phase` (Whisper's tied head has N 51865, no
    multiple of 16: its output rows are realigned as Hymba's N 32001
    were), each model's rows for its activation."""
    from repro_torch.kernels import fp8_matmul as mm
    from repro_torch.kernels import quant_cast as qc
    n0 = dict(qc.launches), mm.launches
    out = {}
    for model, (M, gemms) in ENCDEC_VLM_GEMMS.items():
        log(f"fp8 kernels at {model}'s shapes, {M} rows")
        out[model] = {"check": fp8_check_phase(torch, M, gemms,
                                               edge_cases=False),
                      "times": fp8_time_phase(torch, M, gemms)}
    qc.launches.update(n0[0])            # checks are not path launches
    mm.launches = n0[1]
    return out


def whisper_batches(torch, cfg, n: int, B: int, frames: int, T: int,
                    seed: int) -> list:
    """``n`` batches of bf16 frame embeddings (B, frames, d_model), decoder
    tokens and labels (B, T), from a seeded generator on the card."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    out = []
    for _ in range(n):
        f = torch.randn((B, frames, cfg.d_model), generator=g,
                        device=DEVICE).to(torch.bfloat16)
        tl = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=g,
                           device=DEVICE, dtype=torch.int32)
        out.append({"frames": f, "tokens": tl[:, :-1].contiguous(),
                    "labels": tl[:, 1:].contiguous()})
    return out


def whisper_calibration(torch, batches) -> tuple:
    """Algorithm 1 on Whisper at full width and depth over ``batches``,
    with the depth fit: fresh models of 1 and ``WHISPER_TIER_DEPTH``
    encoder and decoder layers
    (random weights from the seed the served model uses) give the peak's
    fixed part and per-layer-pair cost, which predict the full depth's
    peak; then the full model is built the same way, calibrated, and
    returned with its params, bundle, the fit's ``WHISPER_TIER_DEPTH``
    model, params and bundle (the measured tier's), and the record. Its
    groups are counted by
    ``core.graphs`` and from the layer kinds (an encoder layer makes 4, a
    decoder layer 6: self-attention's projections and BGEMMs, o_proj,
    cross-attention's, its o_proj, up, down; the head 1)."""
    from repro_torch.core.pipeline import AMPOptions, build_groups, calibrate
    from repro_torch.hw.profiles import H100_SXM
    from repro_torch.models.registry import build_model, depth_overrides, \
        get_config
    full = get_config(WHISPER)
    n = full.n_enc_layers

    def run(depth):
        model = build_model(get_config(WHISPER,
                                       **depth_overrides(WHISPER, depth)))
        params = model.init(torch.Generator(device=DEVICE).manual_seed(0),
                            DEVICE)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        bundle = calibrate(model, params, batches, AMPOptions(hw=H100_SXM))
        torch.cuda.synchronize()
        return (model, params, bundle, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated())

    peaks, tier = {}, None
    for d in (1, WHISPER_TIER_DEPTH):
        res = run(d)
        peaks[d] = res[4]
        if d == WHISPER_TIER_DEPTH:
            tier = res[:3]          # the measured tier's model
        del res
        gc.collect()
    per = (peaks[WHISPER_TIER_DEPTH] - peaks[1]) / (WHISPER_TIER_DEPTH - 1)
    predicted = peaks[1] + (n - 1) * per
    model, params, bundle, seconds, peak = run(n)
    sens = np.array(sorted(bundle.sens.sensitivity.values()))
    n_groups = len(bundle.objectives["ET"]["groups"])
    graph_groups = len(build_groups(model, AMPOptions(),
                                    quantizable=set(bundle.op_names))[1])
    hand = 4 * full.n_enc_layers + 6 * full.n_dec_layers + 1
    shapes = prompt_shapes((batches[0]["frames"], batches[0]["tokens"]))
    log(f"{WHISPER} calibrate at full depth ({n} + {full.n_dec_layers} "
        f"layers): {len(bundle.sens.ops)} ops, {n_groups} groups "
        f"(core.graphs {graph_groups}, the layer kinds {hand}), "
        f"{len(batches)} batches of {shapes} in {seconds:.1f} s; peak "
        f"device memory {peak / 1e9:.2f} GB against the depth fit's "
        f"{predicted / 1e9:.2f} GB (peaks at 1 and {WHISPER_TIER_DEPTH} "
        f"layer pairs {peaks[1] / 1e9:.2f}, "
        f"{peaks[WHISPER_TIER_DEPTH] / 1e9:.2f} GB)")
    if not (np.isfinite(sens).all() and (sens > 0).all()
            and math.isfinite(bundle.sens.loss_mean)):
        raise AssertionError(f"{WHISPER} calibration gave a non-finite or "
                             "zero sensitivity")
    if not n_groups == graph_groups == hand:
        raise AssertionError(f"{n_groups} groups, core.graphs gives "
                             f"{graph_groups}, the layer kinds {hand}")
    return model, params, bundle, tier, {
        "seconds": seconds, "peak_gb": peak / 1e9,
        "predicted_peak_gb": predicted / 1e9,
        "fit_peaks_gb": {str(d): p / 1e9 for d, p in peaks.items()},
        "n_ops": len(bundle.sens.ops), "n_groups": n_groups,
        "loss_mean": bundle.sens.loss_mean, "s_min": float(sens[0]),
        "s_max": float(sens[-1])}


def whisper_serve(torch, model, params, mp, label: str,
                  failures: list) -> dict:
    """``WHISPER_SERVE`` through ``ServeEngine.generate`` under ``mp``,
    graphed (the warm-up call at the same shapes captures the per-length
    prefill step and the decode step; the timed call only replays) and
    with both steps run eagerly (the closures the graphs capture): tokens
    and every step's logits bit for bit. Plain, the first token's logits
    are held to a full forward's (``model.apply``) over the same frames
    and prompt, and every decode step's to the full forward over the
    prompt and the tokens before it, within ``LOGIT_TOL``."""
    from repro_torch.launch import steps as st
    from repro_torch.quant.qops import QuantContext
    from repro_torch.serve import ServeEngine
    spec = WHISPER_SERVE
    cfg = model.cfg
    b = whisper_batches(torch, cfg, 1, spec["requests"], spec["frames"],
                        spec["prompt_len"], 31)[0]
    batch = {"frames": b["frames"], "tokens": b["tokens"]}
    max_len = spec["prompt_len"] + spec["new_tokens"]
    runs = {}
    for mode in ("graphed", "eager"):
        eng = ServeEngine(model, mp=mp, device=DEVICE)
        if mode == "eager":
            eng.prefill_step = st.make_prefill_step(model, mp)
            eng.decode_step = st.make_decode_step(model, mp)
        with torch.no_grad():
            eng.generate(params, batch, max_new_tokens=2, max_len=max_len)
        g0 = _graph_counts()
        events = record_steps(eng, ("prefill_step", "decode_step"))
        torch.cuda.synchronize()
        res = eng.generate(params, batch, max_new_tokens=spec["new_tokens"])
        g1 = _graph_counts()
        logits = torch.stack([e[1][:, -1] for e in events], dim=1)
        runs[mode] = (res, logits, sum((g1[0] - g0[0]).values()),
                      sum((g1[1] - g0[1]).values()))
        if not np.array_equal(logits.float().argmax(-1).cpu().numpy(),
                              res.tokens):
            raise AssertionError(f"{WHISPER} {label} {mode}: the recorded "
                                 f"logits do not give the tokens")
    (res, logits, caps, reps), (eres, elogits, _, _) = (runs["graphed"],
                                                        runs["eager"])
    # 1 prefill + new - 1 decodes, replays only (the CPU runs eagerly)
    want_reps = spec["new_tokens"] if DEVICE != "cpu" else 0
    same = np.array_equal(res.tokens, eres.tokens) and torch.equal(logits,
                                                                   elogits)
    diff = (logits.float() - elogits.float()).abs().max().item()
    log(f"{WHISPER} {label}: {spec['requests']} requests of "
        f"{spec['frames']} frames + {spec['prompt_len']} tokens, "
        f"{spec['new_tokens']} new: graphed drain captured {caps} and "
        f"replayed {reps} steps (expected 0 and {want_reps}); graphed vs "
        f"eager {'bit-equal' if same else 'DIFFER'} (max logit diff "
        f"{diff:.4g}); TTFT {res.ttft_s * 1e3:.2f} ms (eager "
        f"{eres.ttft_s * 1e3:.2f}), decode {res.tokens_per_s:.1f} tokens/s "
        f"(eager {eres.tokens_per_s:.1f})")
    if not same:
        failures.append(f"{WHISPER} {label}: graphed differs from eager "
                        f"(max logit diff {diff:.4g})")
    if (caps, reps) != (0, want_reps):
        failures.append(f"{WHISPER} {label}: captures {caps}, replays {reps}")
    if not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all() or \
            not torch.isfinite(logits.float()).all():
        failures.append(f"{WHISPER} {label}: tokens out of range or "
                        f"non-finite logits")
    out = {"ttft_ms": res.ttft_s * 1e3, "tokens_per_s": res.tokens_per_s,
           "eager_ttft_ms": eres.ttft_s * 1e3,
           "eager_tokens_per_s": eres.tokens_per_s,
           "graph_vs_eager_bit_equal": bool(same), "max_logit_diff": diff}
    if mp is None:
        toks = torch.cat([b["tokens"], torch.from_numpy(
            res.tokens[:, :-1]).to(DEVICE)], dim=1)
        with torch.no_grad():
            full = model.apply(params, {"frames": b["frames"],
                                        "tokens": toks}, QuantContext())
        full = full[:, spec["prompt_len"] - 1:]
        err = (full.float() - logits.float()).abs().max().item()
        log(f"{WHISPER} {label}: prefill and decode logits vs full forwards "
            f"over the same frames and tokens: max abs err {err:.4f} (tol "
            f"{LOGIT_TOL})")
        if not err <= LOGIT_TOL:
            failures.append(f"{WHISPER}: serving logits differ from the "
                            f"full forward by {err:.4f}")
        out["vs_full_forward_max_abs_err"] = err
    return out


def whisper_phase(torch) -> dict:
    """Phase 24's Whisper: calibrated at full width and depth with its
    depth fit (:func:`whisper_calibration`), the measured tier over graphed
    forwards of one row of a calibration batch (``WHISPER_TIER_ROWS``:
    frames and tokens) through kernels 1-3 under ``impl="kernel"``
    (:func:`tier_run`) on the fit's model of ``WHISPER_TIER_DEPTH`` layer
    pairs, Fig. 3b on its ET plan, Random and Prefix beside the IP on the
    measured tables (Fig. 2), then the full model served plain and under
    that plan (whose ops are those of its first layer pairs and the head:
    :func:`whisper_serve`)."""
    from repro_torch.models.registry import get_config
    cfg = get_config(WHISPER)
    failures: list = []
    batches = whisper_batches(torch, cfg, CAL_BATCHES, CAL_SHAPE[0],
                              WHISPER_CAL_FRAMES, CAL_SHAPE[1], 0)
    model, params, bundle, (tmodel, tparams, tbundle), cal = \
        whisper_calibration(torch, batches)
    log(f"{WHISPER}: {model.n_params() / 1e9:.4f}B params ({cfg.n_enc_layers}"
        f" encoder + {cfg.n_dec_layers} decoder layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.d_head}, d_ff "
        f"{cfg.d_ff}, {cfg.activation}, {cfg.norm}, vocab {cfg.vocab_size}, "
        f"tied head); calibrated and served at full depth")
    log(f"CUT: {WHISPER}'s measured tier at {WHISPER_TIER_DEPTH} of "
        f"{cfg.n_enc_layers} layer pairs ({len(tbundle.objectives['ET']['groups'])}"
        f" of {len(bundle.objectives['ET']['groups'])} groups; the script's "
        f"time limit)")
    gc.collect()
    torch.cuda.empty_cache()
    prompt = (batches[0]["tokens"][:WHISPER_TIER_ROWS],
              batches[0]["frames"][:WHISPER_TIER_ROWS])
    linear = {op.name for op in tbundle.sens.ops if op.kind == "linear"}
    run = tier_run(torch, tmodel, tparams, tbundle, prompt, linear, 1)
    plan = run["et_plan"]
    fig = fig3b(torch, TierForwards(torch, tmodel, tparams, prompt, linear),
                plan)
    fig2 = fig2_rows(tbundle, plan, WHISPER, objective="ET_wall")
    release_steps(tmodel)
    del batches, tmodel, tparams, tbundle
    gc.collect()
    torch.cuda.empty_cache()
    serving = {"plain": whisper_serve(torch, model, params, None, "plain",
                                      failures),
               "et_plan": whisper_serve(torch, model, params, plan,
                                        f"ET plan ({plan.n_quantized} fp8 "
                                        f"ops)", failures)}
    release_steps(model)
    if failures:
        raise AssertionError("; ".join(failures))
    tier = {k: v for k, v in run.items() if k not in ("et_plan", "fwds")}
    tier.update(et_n_fp8=plan.n_quantized, depth=WHISPER_TIER_DEPTH,
                et_assignment=sorted(plan.assignment), fig3b=fig)
    return {"n_params": model.n_params(), "calibration": cal,
            "measured_tier": tier, "fig2": fig2, "serving": serving}


def llava_prefix_oneshot(torch, model, params) -> dict:
    """``LLAVA_ONESHOT`` through ``ServeEngine.generate`` (graphed: the
    warm-up call at the same shapes captures the per-length prefill and the
    decode step): the image prefix's random embeddings at the token
    embeddings' scale, bf16. The first token's logits are held to a full
    forward over the same prefix and prompt within ``LOGIT_TOL``."""
    from repro_torch.quant.qops import QuantContext
    from repro_torch.serve import ServeEngine
    spec = LLAVA_ONESHOT
    cfg = model.cfg
    g = torch.Generator(device=DEVICE).manual_seed(41)
    prefix = (torch.randn((spec["requests"], spec["prefix"], cfg.d_model),
                          generator=g, device=DEVICE) * 0.02).to(
        torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (spec["requests"],
                                               spec["prompt_len"]),
                           generator=g, device=DEVICE, dtype=torch.int32)
    batch = {"prefix_embeds": prefix, "tokens": tokens}
    max_len = spec["prefix"] + spec["prompt_len"] + spec["new_tokens"]
    eng = ServeEngine(model, device=DEVICE)
    with torch.no_grad():
        eng.generate(params, batch, max_new_tokens=2, max_len=max_len)
    events = record_steps(eng, ("prefill_step", "decode_step"))
    g0 = _graph_counts()
    torch.cuda.reset_peak_memory_stats()
    res = eng.generate(params, batch, max_new_tokens=spec["new_tokens"])
    g1 = _graph_counts()
    caps, reps = sum((g1[0] - g0[0]).values()), sum((g1[1] - g0[1]).values())
    with torch.no_grad():
        full = model.apply(params, tokens, QuantContext(),
                           prefix_embeds=prefix)[:, -1]
    err = (full.float() - events[0][1][:, -1].float()).abs().max().item()
    want_reps = spec["new_tokens"] if DEVICE != "cpu" else 0
    log(f"{LLAVA} one-shot: {spec['requests']} requests of a "
        f"{spec['prefix']}-position image prefix + {spec['prompt_len']} "
        f"tokens, {spec['new_tokens']} new: TTFT {res.ttft_s * 1e3:.2f} ms, "
        f"decode {res.tokens_per_s:.1f} tokens/s, graph captures {caps} and "
        f"replays {reps} (expected 0 and {want_reps}); first "
        f"token's logits vs a full forward: max abs err {err:.4f} (tol "
        f"{LOGIT_TOL}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not err <= LOGIT_TOL or (caps, reps) != (0, want_reps) or \
            not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        raise AssertionError(f"{LLAVA} one-shot: err {err:.4f}, captures "
                             f"{caps}, replays {reps}")
    release_steps(model)
    return {"ttft_ms": res.ttft_s * 1e3, "tokens_per_s": res.tokens_per_s,
            "vs_full_forward_max_abs_err": err,
            "decode_position": spec["prefix"] + spec["prompt_len"]}


def llava_phase(torch) -> dict:
    """Phase 24's LLaVA at its published widths, served at ``LLAVA_DEPTH``
    layers (the cut printed): phases 4 and 5's checks at phase 4's cell on
    text (every fused launch through ``gqa_mma`` at G 7, decode steps x
    layers; the gather drains without eager twins; the plan on the later
    half of the layers), the fused drain pipelined against lockstep, the
    one-shot engine with a 576-position image prefix; then calibrated over
    batches that carry the prefix at the largest depth that fits
    (``fitted_calibration``)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import make_model_and_params
    from repro_torch.models.lm import LM
    from repro_torch.models.registry import get_config
    from repro_torch.nn.spec import param_bytes
    t0 = time.perf_counter()
    model, params = make_model_and_params(LLAVA, False, DEVICE, seed=0,
                                          n_layers=LLAVA_DEPTH)
    torch.cuda.synchronize()
    cfg, full = model.cfg, get_config(LLAVA)
    weights_gb = torch.cuda.memory_allocated() / 1e9
    n_pages = -(-(SERVE["prompt_len"] + SERVE["new_tokens"])
                // SERVE["block_size"])
    G = cfg.n_heads // cfg.n_kv_heads
    hg = pa.head_group(G, cfg.d_head, 0, n_pages, SERVE["block_size"],
                       rows=SERVE["n_slots"] * cfg.n_kv_heads,
                       sms=pa._sm_count(torch.device(DEVICE)),
                       route="gqa_mma")
    log(f"{LLAVA}: {model.n_params() / 1e9:.3f}B params ({cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} "
        f"heads (G {G}, head group {hg}: {-(-G // hg)} groups a KV head), "
        f"d_head {cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"rope theta {cfg.rope_theta:g}), random init in "
        f"{time.perf_counter() - t0:.1f} s, {weights_gb:.2f} GB on the card")
    log(f"CUT: {LLAVA} served at depth {cfg.n_layers} of {full.n_layers} "
        f"(the script's limit; all {full.n_layers} hold "
        f"{param_bytes(LM(full).param_specs()) / 1e9:.1f} GB of bf16 "
        f"weights, {LM(full).n_params() / 1e9:.1f}B params)")
    torch.cuda.reset_peak_memory_stats()
    out = serve_phase(torch, model, params, gather_eager=False)
    failures: list = []
    out["pipelined_vs_lockstep"], _ = pipelined_vs_lockstep(
        torch, model, params, phase4_requests(model), "", failures,
        paged_attn="fused", route="gqa_mma")
    if failures:
        raise AssertionError("; ".join(failures))
    release_steps(model)
    out["oneshot_prefix"] = llava_prefix_oneshot(torch, model, params)
    out.update(weights_gb=weights_gb, n_params=model.n_params(),
               head_group=hg,
               serving_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device=DEVICE).manual_seed(0)
    batches = []
    for _ in range(CAL_BATCHES):
        tl = torch.randint(0, cfg.vocab_size, (CAL_SHAPE[0],
                                               CAL_SHAPE[1] + 1),
                           generator=g, device=DEVICE, dtype=torch.int32)
        pre = (torch.randn((CAL_SHAPE[0], LLAVA_ONESHOT["prefix"],
                            cfg.d_model), generator=g, device=DEVICE)
               * 0.02).to(torch.bfloat16)
        batches.append({"tokens": tl[:, :-1].contiguous(),
                        "labels": tl[:, 1:].contiguous(),
                        "prefix_embeds": pre})
    log(f"{LLAVA} calibration batches: {CAL_BATCHES} of {CAL_SHAPE} text "
        f"tokens after a ({CAL_SHAPE[0]}, {LLAVA_ONESHOT['prefix']}, "
        f"{cfg.d_model}) image prefix (the loss over the text positions)")
    out["calibration"] = fitted_calibration(torch, LLAVA, batches)
    return out


def encdec_vlm_phase(torch) -> dict:
    """Phase 24: kernels 1-3 at Whisper's and LLaVA's linear shapes, then
    Whisper at full width and depth and LLaVA at full width, each freed
    before the next."""
    out = {"kernels": encdec_vlm_kernels(torch)}
    out[WHISPER] = whisper_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()
    out[LLAVA] = llava_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 25: training
# ---------------------------------------------------------------------------

# the loss leg: llama3_1b at full width and depth, AdamW from
# select_optimizer, 30 steps of (8, 256) synthetic tokens through
# Trainer.run; the mean of the last 5 losses must sit TRAIN_DROP nats below
# the first
TRAIN_LOSS = dict(batch=8, seq_len=256, steps=30, lr=6e-4, warmup=5)
TRAIN_DROP = 0.5
# the checkpoint leg: the first 2 of llama3_1b's 16 layers at full width
# (0.39 B parameters, 3.9 GB of checkpoint; 16 layers hold 12.4 GB), 10
# steps checkpointed, resumed at 10 to 20, against a straight 20; the
# reference's own bound on the two (tests/test_train.py). (20 steps resumed
# to 30 before phase 27 was added: a save and 20 steps went to pay for it)
TRAIN_CKPT_DEPTH = 2
TRAIN_RESUME_TOL = 2e-2
# the loop leg: the trained model calibrated as phase 6 does, its TT plan at
# tau 0.01 held to the reference's 5% on the eval loss
# (tests/test_system.py), then 4 requests served under it
TRAIN_TAU = 0.01
TRAIN_EVAL_TOL = 0.05
TRAIN_EVAL_BATCHES = 2
TRAIN_SERVE = dict(requests=4, prompt_len=64, new_tokens=16, arrival_every=0)
# the H100 SXM's dense bf16 tensor-core peak (NVIDIA data sheet), FLOP/s
BF16_DENSE_PEAK = 989e12


def train_data(cfg):
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    return SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size,
                                       batch=TRAIN_LOSS["batch"],
                                       seq_len=TRAIN_LOSS["seq_len"]), DEVICE)


def train_trainer(model, ckpt_dir: Path, total: int, every: int,
                  log_every: int = 1000, mesh=None):
    from repro_torch.train.optim import OptConfig, select_optimizer
    from repro_torch.train.trainer import Trainer, TrainerConfig
    opt = select_optimizer(model.n_params(), OptConfig(
        lr=TRAIN_LOSS["lr"], warmup_steps=TRAIN_LOSS["warmup"],
        total_steps=TRAIN_LOSS["steps"]))
    return Trainer(model, opt, mesh, TrainerConfig(
        total_steps=total, ckpt_every=every, ckpt_dir=str(ckpt_dir),
        log_every=log_every, metrics_path=str(ckpt_dir / "metrics.jsonl")),
        device=DEVICE)


@contextlib.contextmanager
def timed_checkpoints(out: list):
    """Every ``CheckpointManager.save`` and ``restore`` in the block, timed
    (seconds, kind, step, bytes of the arrays)."""
    from repro_torch.checkpoint import manager as cm
    save, restore = cm.CheckpointManager.save, cm.CheckpointManager.restore

    def timed_save(self, step, tree, extra=None, **kw):
        t0 = time.perf_counter()
        path = save(self, step, tree, extra, **kw)
        n = os.path.getsize(os.path.join(path, "arrays.npz"))
        out.append(("save", step, n, time.perf_counter() - t0))
        return path

    def timed_restore(self, step=None, device=None, only=None, **kw):
        t0 = time.perf_counter()
        res = restore(self, step, device, only, **kw)
        torch_sync()
        n = sum(t.numel() * t.element_size()
                for t in flat_tensors(res[1]))
        out.append(("restore", res[0], n, time.perf_counter() - t0))
        return res

    cm.CheckpointManager.save = timed_save
    cm.CheckpointManager.restore = timed_restore
    try:
        yield out
    finally:
        cm.CheckpointManager.save = save
        cm.CheckpointManager.restore = restore


def torch_sync() -> None:
    import torch
    if DEVICE != "cpu":
        torch.cuda.synchronize()


def flat_tensors(tree: dict) -> list:
    from repro_torch.nn.spec import flatten_paths
    return list(flatten_paths(tree).values())


def ckpt_numbers(events: list) -> list:
    rows = [{"kind": k, "step": s, "gb": n / 1e9, "seconds": t,
             "gb_per_s": n / 1e9 / t} for k, s, n, t in events]
    for r in rows:
        log(f"checkpoint {r['kind']} of step {r['step']}: {r['gb']:.2f} GB "
            f"in {r['seconds']:.2f} s ({r['gb_per_s']:.2f} GB/s; "
            f"{'SHA-256 and fsync included' if r['kind'] == 'save' else 'the newest valid step found by its digests, read and moved to the card'})")
    return rows


def all_linear_plan(model) -> dict:
    """fp8 on every linear op of every layer and on the head: every weight
    of the model then has quantized codes in the weight cache."""
    return {n: "fp8_e4m3" for n in model.serving_op_names()
            if not n.endswith(("qk_matmul", "av_matmul"))}


def train_serve(eng, params, mp, reqs) -> dict:
    """One lockstep drain of ``reqs`` on ``eng`` switched to the plan
    ``mp`` (the engine's own plan swap): rid -> greedy tokens."""
    eng._swap_plan(mp)
    out = eng.serve(params, reqs, sync=True)
    toks = {}
    for r in reqs:
        res = out.results[r.rid]
        if res.status != "ok" or len(res.tokens) != r.max_new_tokens:
            raise AssertionError(f"training: request {r.rid} did not "
                                 f"complete under the plan")
        toks[r.rid] = np.asarray(res.tokens)
    return toks


def training_loss_leg(torch, workdir: Path) -> tuple:
    """The loss leg (module comment at ``TRAIN_LOSS``). Before training, an
    engine serves the random weights under an all-linear fp8 plan, so the
    weight cache holds codes of every weight and the engine's graphs are
    bound to the very tensors the step then updates in place; the loop leg
    serves on it again."""
    from repro_torch.analysis.analytic import analytic_costs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.registry import get_model
    from repro_torch.serve import ContinuousBatchingEngine
    spec = TRAIN_LOSS
    model = get_model("llama3_1b")
    n_params = model.n_params()
    tr = train_trainer(model, workdir / "loss", spec["steps"], spec["steps"],
                       log_every=10)
    step0, params, opt_state = tr.init_or_resume(0)
    s = TRAIN_SERVE
    reqs = make_requests(model.cfg.vocab_size, s["requests"],
                         s["prompt_len"], s["new_tokens"], s["arrival_every"])
    eng = ContinuousBatchingEngine(
        model, n_slots=s["requests"], max_len=s["prompt_len"]
        + s["new_tokens"], mp=all_linear_plan(model), device=DEVICE,
        prefix_cache=False)
    eng.serve(params, reqs, sync=True)
    data = train_data(model.cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ckpts: list = []
    t0 = time.perf_counter()
    with timed_checkpoints(ckpts):
        tr.run(data, step0, params, opt_state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist = tr.history
    losses = [h["loss"] for h in hist]
    wall = np.array([h["dt"] for h in hist[1:]]) * 1e3
    dev = np.array([h["device_ms"] if h["device_ms"] is not None
                    else h["dt"] * 1e3 for h in hist[1:]])   # CPU: wall
    tokens = spec["batch"] * spec["seq_len"]
    flops = analytic_costs("llama3_1b", ShapeCell(
        "train_loss_leg", "train", spec["seq_len"], spec["batch"]))["flops"]
    wall_ms, dev_ms = float(np.median(wall)), float(np.median(dev))
    share = flops / (wall_ms / 1e3) / BF16_DENSE_PEAK
    gb = 1e9
    p_bytes = 2 * n_params
    state = {"params_gb": p_bytes / gb, "grads_gb": p_bytes / gb,
             "moments_gb": 8 * n_params / gb}
    first, tail = losses[0], float(np.mean(losses[-5:]))
    log(f"training loss leg: {model.cfg.name} at full width and depth "
        f"({n_params / 1e9:.3f}B params), AdamW (select_optimizer: "
        f"{tr.opt_cfg.name}, lr {spec['lr']:g}, warm-up {spec['warmup']}), "
        f"{spec['steps']} steps of {(spec['batch'], spec['seq_len'])} "
        f"tokens through Trainer.run in {seconds:.1f} s: loss {first:.4f} "
        f"first (ln {model.cfg.vocab_size} = "
        f"{math.log(model.cfg.vocab_size):.2f}), {tail:.4f} the mean of the "
        f"last 5 (drop {first - tail:.4f}, needed {TRAIN_DROP})")
    log(f"training step (eager, steps 2-{spec['steps']}): wall median "
        f"{wall_ms:.2f} ms (min {wall.min():.2f}, max {wall.max():.2f}), "
        f"device {dev_ms:.2f} ms between CUDA events (min {dev.min():.2f}, "
        f"max {dev.max():.2f}); {tokens / (wall_ms / 1e3):.0f} tokens/s; "
        f"model FLOPs {flops / 1e12:.2f} T a step (3 x 2 x forward MACs, "
        f"analysis.analytic), {share * 100:.1f}% of the bf16 dense peak "
        f"{BF16_DENSE_PEAK / 1e12:.0f} TFLOP/s at the wall median "
        f"({flops / (dev_ms / 1e3) / BF16_DENSE_PEAK * 100:.1f}% at the "
        f"device median)")
    log(f"training peak device memory {peak / gb:.2f} GB: bf16 params "
        f"{state['params_gb']:.2f} + bf16 grads {state['grads_gb']:.2f} + "
        f"f32 moments {state['moments_gb']:.2f} = "
        f"{sum(state.values()):.2f} GB of state; the rest activations, the "
        f"serving engine's pool and graphs, and the update's f32 "
        f"temporaries")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training: non-finite loss {losses}")
    if not tail <= first - TRAIN_DROP:
        raise AssertionError(f"training: the last 5 losses' mean {tail:.4f} "
                             f"is not {TRAIN_DROP} below the first "
                             f"{first:.4f}")
    rec = {"n_params": n_params, "losses": losses, "seconds": seconds,
           "grad_norms": [h["grad_norm"] for h in hist],
           "step_wall_ms": wall_ms, "step_device_ms": dev_ms,
           "step_wall_ms_all": [h["dt"] * 1e3 for h in hist],
           "step_device_ms_all": [h["device_ms"] for h in hist],
           "tokens_per_s": tokens / (wall_ms / 1e3),
           "model_flops_per_step": flops, "model_flop_share": share,
           "model_flop_share_device": flops / (dev_ms / 1e3)
           / BF16_DENSE_PEAK, "peak_gb": peak / gb, **state,
           "checkpoints": ckpt_numbers(ckpts)}
    return model, params, eng, reqs, tr, rec


def training_ckpt_leg(torch, workdir: Path) -> dict:
    """The checkpoint leg (module comment at ``TRAIN_CKPT_DEPTH``): 10
    steps through ``Trainer.fit`` (a checkpoint at 10), a new trainer
    resuming at 10 and running to 20 (checkpoint 20), against the trainer's
    step run 20 times straight (each step's loss and grad norm kept: phase
    27 is held to them); then the newest arrays.npz corrupted and the run
    resumed from the one before."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.registry import depth_overrides, get_model
    model = get_model("llama3_1b", **depth_overrides("llama3_1b",
                                                     TRAIN_CKPT_DEPTH))
    data = train_data(model.cfg)
    a, b = workdir / "resume", workdir / "straight"
    ckpts: list = []
    t0 = time.perf_counter()
    with timed_checkpoints(ckpts):
        train_trainer(model, a, 10, 10).fit(data, 0)
        tr = train_trainer(model, a, 20, 10)
        step, p, o = tr.init_or_resume(0)
        if step != 10:
            raise AssertionError(f"training: resumed at step {step}, not 10")
        p2, o2, _ = tr.run(data, step, p, o)
        # the straight run: the trainer's own step, 20 times, from the same
        # init, without checkpoints
        straight = train_trainer(model, b, 20, 20)
        _, p3, o3 = straight.init_or_resume(0)
        history = []
        for s in range(20):
            p3, o3, m = straight.train_step(p3, o3, data.batch_at(s))
            history.append((float(m["loss"]), float(m["grad_norm"])))
        diffs = {}
        for name, x, y in (("params", p2, p3), ("optimizer", o2, o3)):
            fx, fy = flat_tensors(x), flat_tensors(y)
            diffs[name] = max((u.float() - v.float()).abs().max().item()
                              for u, v in zip(fx, fy))
        bitwise = all(torch.equal(u, v) for u, v in zip(
            flat_tensors(p2) + flat_tensors(o2),
            flat_tensors(p3) + flat_tensors(o3)))
        del p, o, p2, o2, p3, o3
        steps = CheckpointManager(str(a)).all_steps()
        path = a / f"step_{steps[-1]:010d}" / "arrays.npz"
        with open(path, "r+b") as f:
            f.seek(200)
            f.write(b"\xde\xad\xbe\xef" * 8)
        back, _, _ = train_trainer(model, a, 20, 10).init_or_resume(0)
    seconds = time.perf_counter() - t0
    log(f"training checkpoint leg: {model.cfg.name} at {TRAIN_CKPT_DEPTH} "
        f"of 16 layers, full width ({model.n_params() / 1e9:.3f}B params): "
        f"10 steps checkpointed, resumed at 10 to 20, against a straight "
        f"20: {'bitwise equal' if bitwise else 'NOT bitwise'}; "
        f"largest difference params {diffs['params']:.3g}, optimizer state "
        f"{diffs['optimizer']:.3g} (bound {TRAIN_RESUME_TOL} on params, the "
        f"reference's); newest of steps {steps} corrupted: the trainer "
        f"resumes at {back}; {seconds:.1f} s")
    if diffs["params"] > TRAIN_RESUME_TOL:
        raise AssertionError(f"training: resumed params differ from the "
                             f"straight run by {diffs['params']:.3g}")
    if steps != [10, 20] or back != 10:
        raise AssertionError(f"training: steps {steps}, after corrupting "
                             f"the newest resumed at {back}; expected 10")
    return {"n_params": model.n_params(), "resume_bitwise": bitwise,
            "history": history, "resume_max_diff": diffs,
            "seconds": seconds,
            "quarantine": {"steps": steps, "resumed_at": back},
            "checkpoints": ckpt_numbers(ckpts)}


def training_loop_leg(torch, model, params, eng, reqs, tr,
                      workdir: Path) -> dict:
    """The loop leg: the loss leg's checkpoint restored through the serve
    launcher's ``--ckpt-dir`` path (``launch.serve.restore_params``), equal
    to the trained params bit for bit; calibrated as phase 6 does; the TT
    plan at ``TRAIN_TAU`` solved and held to the reference's 5% on the eval
    loss; then served on the engine that served before training (its
    graphs and the weight cache saw every weight change in place) and on a
    fresh engine over a copy of the restored params: greedy tokens equal,
    under the TT plan and under the all-linear plan the first engine served
    before training."""
    from repro_torch.core.pipeline import AMPOptions, calibrate
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.hw.profiles import H100_SXM
    from repro_torch.launch.serve import restore_params
    from repro_torch.launch.steps import make_eval_step
    from repro_torch.nn.spec import flatten_paths, tree_from_flat
    from repro_torch.serve import ContinuousBatchingEngine
    ckpts: list = []
    t0 = time.perf_counter()
    with timed_checkpoints(ckpts):
        step, restored = restore_params(model, tr.cfg.ckpt_dir, DEVICE)
    fr, fp = flatten_paths(restored), flatten_paths(params)
    if step != TRAIN_LOSS["steps"] or not all(
            torch.equal(fr[k], fp[k]) for k in fp):
        raise AssertionError(f"training: --ckpt-dir restored step {step}, "
                             f"params not the trained ones")
    cal = SyntheticLM(SyntheticConfig(vocab_size=model.cfg.vocab_size,
                                      batch=CAL_SHAPE[0],
                                      seq_len=CAL_SHAPE[1]), DEVICE)
    batches = list(cal.batches(0, CAL_BATCHES))
    tc = time.perf_counter()
    bundle = calibrate(model, restored, batches, AMPOptions(hw=H100_SXM))
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - tc
    plan = bundle.solve(TRAIN_TAU, "TT")
    data = train_data(model.cfg)
    evals = [data.batch_at(2000 + i) for i in range(TRAIN_EVAL_BATCHES)]
    plain = float(np.mean([make_eval_step(model)(restored, b).item()
                           for b in evals]))
    mp = float(np.mean([make_eval_step(model, plan.assignment)(
        restored, b).item() for b in evals]))
    rel = abs(mp - plain) / plain
    log(f"training loop leg: step {step} restored through launch.serve's "
        f"--ckpt-dir path in {ckpts[0][3]:.2f} s, bit-equal to the trained "
        f"params; calibrated ({CAL_BATCHES} batches of {CAL_SHAPE}) in "
        f"{cal_s:.1f} s: E[g] {bundle.sens.loss_mean:.4f} (phase 6 on random "
        f"weights: ~12.2); TT plan at tau {TRAIN_TAU}: {plan.n_quantized} ops "
        f"fp8, predicted loss MSE {plan.predicted_loss_mse:.4g} of budget "
        f"{plan.budget:.4g}; eval loss over {TRAIN_EVAL_BATCHES} batches "
        f"of {(TRAIN_LOSS['batch'], TRAIN_LOSS['seq_len'])}: plain "
        f"{plain:.4f}, under the plan {mp:.4f} ({rel * 100:.3f}%, bound "
        f"{TRAIN_EVAL_TOL * 100:.0f}%)")
    if plan.n_quantized == 0 or plan.predicted_loss_mse > plan.budget * (
            1 + 1e-9):
        raise AssertionError(f"training: TT plan quantizes "
                             f"{plan.n_quantized} ops, predicted "
                             f"{plan.predicted_loss_mse} over {plan.budget}")
    if not rel < TRAIN_EVAL_TOL:
        raise AssertionError(f"training: eval loss under the plan moved "
                             f"{rel * 100:.2f}%")
    ts = time.perf_counter()
    copy = tree_from_flat({k: v.clone() for k, v in fr.items()})
    fresh = ContinuousBatchingEngine(
        model, n_slots=eng.n_slots, max_len=eng.max_len, mp=None,
        device=DEVICE, prefix_cache=False)
    same = {}
    for name, assignment in (("TT", plan.assignment),
                             ("all-linear", all_linear_plan(model))):
        got = {}
        for label, e, p in (("trained", eng, params), ("fresh", fresh, copy)):
            got[label] = train_serve(e, p, assignment, reqs)
        same[name] = all(np.array_equal(got["trained"][r], got["fresh"][r])
                         for r in got["trained"])
        log(f"training: {len(reqs)} requests under the {name} plan on the "
            f"engine that served before training and on a fresh one over a "
            f"copy of the restored params: greedy tokens "
            f"{'equal' if same[name] else 'DIFFER'}")
    serve_s = time.perf_counter() - ts
    log(f"training loop leg: {time.perf_counter() - t0:.1f} s, of which the "
        f"restore {ckpts[0][3]:.1f}, calibration {cal_s:.1f}, the four "
        f"drains (their captures included) {serve_s:.1f}")
    if not all(same.values()):
        raise AssertionError(f"training: served tokens differ from a fresh "
                             f"engine's: {same}")
    return {"restore": ckpt_numbers(ckpts), "calibration_s": cal_s,
            "serve_s": serve_s, "seconds": time.perf_counter() - t0,
            "loss_mean": bundle.sens.loss_mean,
            "tt_n_fp8": plan.n_quantized, "eval_plain": plain,
            "eval_mp": mp, "eval_rel": rel, "tokens_equal": same}


def training_phase(torch) -> dict:
    """Phase 25 (after phase 21, on a model of its own): the loss, the
    checkpoint and the loop legs."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        workdir = Path(tmp)
        model, params, eng, reqs, tr, loss = training_loss_leg(torch,
                                                                workdir)
        t1 = time.perf_counter()
        loop = training_loop_leg(torch, model, params, eng, reqs, tr,
                                 workdir)
        t2 = time.perf_counter()
        release_steps(model)
        del model, params, eng, tr
        shutil.rmtree(workdir / "loss")       # 12.4 GB of checkpoint
        gc.collect()
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        ckpt = training_ckpt_leg(torch, workdir)
        t4 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    legs = {"loss_leg": t1 - t0, "loop_leg": t2 - t1, "release": t3 - t2,
            "checkpoint_leg": t4 - t3, "cleanup": time.perf_counter() - t4}
    log("training phase by leg (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in legs.items()) + f"; the loss leg's "
        f"training {loss['seconds']:.1f} of it")
    return {"loss_leg": loss, "checkpoint_leg": ckpt, "loop_leg": loop,
            "leg_seconds": legs}


# ---------------------------------------------------------------------------
# phase 27: training over a (data, model) mesh
# ---------------------------------------------------------------------------

# the loss leg's first steps through Trainer(mesh=) over a 1x1 mesh of one
# NCCL rank; the checkpoint leg's first 10 steps on that mesh, resumed from
# its checkpoint by the single-rank trainer to step 20. The budget is
# printed, not enforced.
TRAIN_MESH_STEPS = 5
TRAIN_MESH_BUDGET_S = 30.0


def bitwise_steps(name: str, want: list, got: list) -> None:
    """Fail unless each step's (loss, grad norm) is ``want``'s bit for
    bit."""
    bad = [(i, w, g) for i, (w, g) in enumerate(zip(want, got))
           if tuple(w) != tuple(g)]
    if len(want) != len(got) or bad:
        raise AssertionError(f"training over a mesh, {name}: steps differ "
                             f"from phase 25's (step, phase 25, mesh): "
                             f"{bad[:3]} ({len(got)} of {len(want)} steps)")


def train_mesh_phase(torch, training: dict) -> dict:
    """Phase 27 (after phase 25, whose ``training`` record it is held to):
    llama3_1b at full width over a 1x1 (data, model) mesh of one NCCL rank.
    The loss leg's first ``TRAIN_MESH_STEPS`` steps (full depth) through
    ``Trainer(mesh=)``: each step's loss and grad norm equal to phase 25's
    bit for bit (one rank's collectives are copies). At
    ``TRAIN_CKPT_DEPTH`` layers, 10 steps on the mesh and its checkpoint,
    then the single-rank trainer resumes from it: steps 11-20 equal to
    phase 25's straight run bit for bit."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import depth_overrides, get_model
    t0 = time.perf_counter()
    mesh = make_local_mesh(1, 1, device=DEVICE)
    out: dict = {}
    try:
        backend = dist.get_backend()
        if DEVICE == "cuda" and backend != "nccl":
            raise AssertionError(f"training mesh on {backend}, not NCCL")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
            tmp = Path(tmp)
            model = get_model("llama3_1b")
            data = train_data(model.cfg)
            tr = train_trainer(model, tmp / "loss", TRAIN_MESH_STEPS,
                               TRAIN_MESH_STEPS, mesh=mesh)
            _, p, o = tr.init_or_resume(0)
            t1 = time.perf_counter()
            got = []
            for s in range(TRAIN_MESH_STEPS):
                p, o, m = tr.train_step(p, o, data.batch_at(s))
                got.append((float(m["loss"]), float(m["grad_norm"])))
            torch_sync()
            loss_s = time.perf_counter() - t1
            loss = training["loss_leg"]
            want = list(zip(loss["losses"], loss["grad_norms"]))[
                :TRAIN_MESH_STEPS]
            bitwise_steps("loss leg", want, got)
            out["loss_leg"] = {"steps": got, "bitwise": True,
                               "train_s": loss_s}
            log(f"training over a 1x1 mesh ({backend}): {model.cfg.name} "
                f"at full width and depth, steps 1-{TRAIN_MESH_STEPS} of "
                f"phase 25's loss leg through Trainer(mesh=) in "
                f"{loss_s:.2f} s: losses and grad norms bit-equal to phase "
                f"25's ({got[0][0]:.4f} .. {got[-1][0]:.4f})")
            del tr, p, o, model
            gc.collect()
            torch.cuda.empty_cache()
            model = get_model("llama3_1b", **depth_overrides(
                "llama3_1b", TRAIN_CKPT_DEPTH))
            d = tmp / "ckpt"
            ckpts: list = []
            with timed_checkpoints(ckpts):
                train_trainer(model, d, 10, 10, mesh=mesh).fit(data, 0)
                single = train_trainer(model, d, 20, 10 ** 6)
                step, p, o = single.init_or_resume(0)
                if step != 10:
                    raise AssertionError(f"training over a mesh: the "
                                         f"single-rank trainer resumed at "
                                         f"{step}, not 10")
                got = []
                for s in range(10, 20):
                    p, o, m = single.train_step(p, o, data.batch_at(s))
                    got.append((float(m["loss"]), float(m["grad_norm"])))
            bitwise_steps("checkpoint leg", [tuple(h) for h in training[
                "checkpoint_leg"]["history"][10:20]], got)
            out["checkpoint_leg"] = {"steps": got, "bitwise": True,
                                     "checkpoints": ckpt_numbers(ckpts)}
            log(f"training over a 1x1 mesh: {TRAIN_CKPT_DEPTH} of 16 layers, "
                f"10 steps on the mesh and its checkpoint, resumed by the "
                f"single-rank trainer: steps 11-20 bit-equal to phase 25's "
                f"straight run")
            del single, p, o, model
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 27 (training over a 1x1 mesh): {out['seconds']:.1f} s "
        f"(budget {TRAIN_MESH_BUDGET_S:.0f} s)"
        f"{'; ' + card_line() if DEVICE == 'cuda' else ''}")
    return out


# ---------------------------------------------------------------------------
# phase 28: scan_layers and the dry run
# ---------------------------------------------------------------------------

# the scan leg: llama3_1b's 16 layers in one segment, remat in groups of 4
# (two-level: 4 groups of 4, no tail), phase 25's first SCAN_STEPS steps
SCAN_REMAT_GROUP = 4
SCAN_STEPS = 3
# the dry run's cells (pod16x16): name -> (arch, shape, overrides, global
# batch: None for the shape's), each traced on the host by a process of its
# own (DRYRUN_PROC, started after the measured tier); DRYRUN_ON_CARD also
# run on the card. train_4k's whole shard took 107.6 s a step on an H100,
# so the card runs its cut: 2 of 40 layers (two-level remat, one group of
# 2) and 2 of 8 microbatches of the same 2 rows a rank (a global batch of
# 64, not 256), at full width, held to its own trace. qwen2p5_32b's cells
# run FSDP: its decode_32k by the reference's rule, its train_4k cut to 4
# layers (two remat groups of 2) and 2 microbatches under FSDP_RULES
# ("rules": "fsdp"; so cut, the rule would keep the default rules). The
# card times one step of each after its warm-up (dryrun.TIMED_STEPS): a
# sample, not a median (on an H100, three steps of a train cut spread by
# under 0.5%, of a decode by up to 25%)
DRYRUN_CELLS = {
    "train_4k": ("starcoder2_15b", "train_4k", {}, None),
    "decode_32k": ("starcoder2_15b", "decode_32k", {}, None),
    "train_4k_cut": ("starcoder2_15b", "train_4k",
                     dict(n_layers=2, remat_group=2, n_microbatches=2), 64),
    "fsdp_decode_32k": ("qwen2p5_32b", "decode_32k", {}, None),
    "fsdp_train_4k_cut": ("qwen2p5_32b", "train_4k",
                          dict(n_layers=4, remat_group=2, n_microbatches=2,
                               rules="fsdp"), 64),
}
DRYRUN_ON_CARD = ("train_4k_cut", "decode_32k", "fsdp_train_4k_cut",
                  "fsdp_decode_32k")
# the card's peak allocation against the meta trace's live-storage peak
DRYRUN_PEAK_TOL = 0.20
# seconds the host trace may still take when phase 28 asks for it
DRYRUN_WAIT_S = 600.0
SCAN_DRYRUN_BUDGET_S = 40.0
DRYRUN_PROC: dict = {}


def start_host_dryrun() -> None:
    """Start the host's meta dry run of ``DRYRUN_CELLS`` in a process of its
    own, with no card visible and at the lowest CPU priority
    (``dryrun.run_cell`` one cell after the other, a JSON record each in a
    temporary directory), so it overlaps the card's phases;
    :func:`host_dryrun_records` collects it, and the process is killed at
    exit if it still runs."""
    import atexit
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    code = ("import dataclasses, json, os, sys\n"
            "os.nice(19)\n"
            "from repro_torch.configs.shapes import SHAPES\n"
            "from repro_torch.distributed.sharding import FSDP_RULES\n"
            "from repro_torch.launch.dryrun import run_cell\n"
            "for name, (arch, shape, ov, batch) in %r.items():\n"
            "    cell = batch and dataclasses.replace(SHAPES[shape],"
            " global_batch=batch)\n"
            "    if ov.get('rules') == 'fsdp':\n"
            "        ov = dict(ov, rules=FSDP_RULES)\n"
            "    rec = run_cell(arch, shape, False, overrides=ov, cell=cell)\n"
            "    with open(f'{sys.argv[1]}/{name}.json', 'w') as f:\n"
            "        json.dump(rec, f)\n"
            "    print(name, rec['status'], rec.get('trace_s'), flush=True)\n"
            % (DRYRUN_CELLS,))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    log_path = out / "dryrun.log"
    fh = open(log_path, "w")
    proc = subprocess.Popen([sys.executable, "-c", code, str(out)], env=env,
                            stdout=fh, stderr=subprocess.STDOUT,
                            cwd=str(ROOT))
    DRYRUN_PROC.update(proc=proc, out=out, log=log_path, fh=fh,
                       t0=time.perf_counter())

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        fh.close()
        shutil.rmtree(out, ignore_errors=True)
    atexit.register(stop)


def host_dryrun_records() -> tuple:
    """(records by cell, seconds waited): the host process's records,
    after waiting for it to end (at most ``DRYRUN_WAIT_S``); it failing
    fails the phase."""
    if not DRYRUN_PROC:
        start_host_dryrun()
    proc = DRYRUN_PROC["proc"]
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=DRYRUN_WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed"
    waited = time.perf_counter() - t0
    text = DRYRUN_PROC["log"].read_text()
    if rc != 0:
        raise AssertionError(f"the host dry run ended with {rc}: "
                             f"{text[-2000:]}")
    recs = {name: json.loads((DRYRUN_PROC["out"] / f"{name}.json")
                             .read_text()) for name in DRYRUN_CELLS}
    return recs, waited


def scan_grads(torch, model, flat: dict, batch: dict) -> tuple:
    """(loss, {path: gradient}) of ``model``'s plain loss at ``flat``."""
    from repro_torch.nn.spec import tree_from_flat
    from repro_torch.quant.qops import QuantContext
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    loss = model.loss(tree_from_flat(leaves), batch, QuantContext())
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(leaves[k]) if g is None
                           else g for k, g in zip(leaves, gs)}


def scan_train_leg(torch, training: dict) -> dict:
    """The scan leg's training half (module docstring, phase 28)."""
    from repro_torch.bridge import stack_layers
    from repro_torch.models.registry import get_model
    from repro_torch.nn.spec import flatten_paths, tree_from_flat
    from repro_torch.train import optim
    from repro_torch.nn.spec import default_generator
    unrolled = get_model("llama3_1b")
    scan = get_model("llama3_1b", scan_layers=True, remat=True,
                     remat_group=SCAN_REMAT_GROUP)
    data = train_data(unrolled.cfg)
    # phase 25's initial weights (Trainer.init_or_resume's seed 0)
    fu = flatten_paths(unrolled.init(default_generator(0, DEVICE), DEVICE))
    fs = stack_layers(fu, scan.cfg)
    batch = data.batch_at(0)
    lu, gu = scan_grads(torch, unrolled, fu, batch)
    del fu
    gu = stack_layers(gu, scan.cfg)
    ls, gs = scan_grads(torch, scan, fs, batch)
    first, worst = None, 0.0
    for k in gs:
        if not torch.equal(gu[k], gs[k]):
            d = float((gu[k].float() - gs[k].float()).abs().max())
            first = first or (k, d)
            worst = max(worst, d)
    del gu, gs
    grads = {"loss_equal": bool(torch.equal(lu, ls)),
             "leaves_equal": first is None, "first_differing_leaf": first,
             "max_abs_diff": worst}
    log(f"scan leg: gradients at phase 25's initial weights, 16 layers "
        f"stacked (remat in groups of {SCAN_REMAT_GROUP}) against the "
        f"unrolled model (no remat): loss "
        f"{'equal' if grads['loss_equal'] else 'DIFFERS'}, "
        + ("every leaf bit-equal" if first is None else
           f"first differing leaf {first[0]} by {first[1]:.3e}, the largest "
           f"difference {worst:.3e}"))
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scan_") as tmp:
        tr = train_trainer(scan, Path(tmp), SCAN_STEPS, 10 ** 6)
        p = tree_from_flat(fs)
        del fs
        o = optim.init_state(scan.param_specs(), tr.opt_cfg, DEVICE)
        torch_sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = []
        for s in range(SCAN_STEPS):
            p, o, m = tr.train_step(p, o, data.batch_at(s))
            got.append((float(m["loss"]), float(m["grad_norm"])))
        torch_sync()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        del p, o, tr
    loss = training["loss_leg"]
    want = list(zip(loss["losses"], loss["grad_norms"]))[:SCAN_STEPS]
    rel = max(abs(g - w) / max(abs(w), 1e-12)
              for gw, ww in zip(got, want) for g, w in zip(gw, ww))
    bitwise = got == want
    first_step = next((i for i, (g, w) in enumerate(zip(got, want))
                       if g != w), None)
    log(f"scan leg: phase 25's first {SCAN_STEPS} steps in {secs:.2f} s: "
        + ("losses and grad norms bit-equal to phase 25's" if bitwise else
           f"first differing step {first_step + 1} (scan {got[first_step]},"
           f" phase 25 {want[first_step]}), the largest relative "
           f"difference {rel:.3e} (bound {TRAIN_RESUME_TOL})")
        + f"; peak memory {peak / 1e9:.2f} GB against phase 25's "
        f"{loss['peak_gb']:.2f} GB (which also held a serving engine)")
    if len(got) != len(want) or not rel <= TRAIN_RESUME_TOL or \
            not all(math.isfinite(x) for g in got for x in g):
        raise AssertionError(f"scan leg: steps {got} against phase 25's "
                             f"{want}: {rel:.3e} beyond {TRAIN_RESUME_TOL}")
    return {"gradients": grads, "steps": got, "phase25_steps": want,
            "bitwise": bitwise, "max_rel_diff": rel, "train_s": secs,
            "peak_gb": peak / 1e9, "phase25_peak_gb": loss["peak_gb"]}


def scan_serve_leg(torch) -> dict:
    """The scan leg's serving half: phase 4's cell through a scan model
    holding phase 4's weights stacked, plain."""
    from repro_torch.bridge import stack_layers
    from repro_torch.launch.serve import make_model_and_params, make_requests
    from repro_torch.models.registry import get_model
    from repro_torch.nn.spec import flatten_paths, tree_from_flat
    from repro_torch.quant import weight_cache
    model, params = make_model_and_params("llama3_1b", False, DEVICE, seed=0)
    scan = get_model("llama3_1b", scan_layers=True)
    ps = tree_from_flat(stack_layers(flatten_paths(params), scan.cfg))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    reqs = make_requests(scan.cfg.vocab_size, SERVE["requests"],
                         SERVE["prompt_len"], SERVE["new_tokens"],
                         SERVE["arrival_every"])
    want_tokens, want_launches, want_tps = SERVED_TOKENS[model.cfg.name][
        "plain"]
    q0 = weight_cache.quantizations
    res, launches, tl = run_continuous(torch, scan, ps, reqs,
                                       paged_attn="fused", route="gqa_mma",
                                       name="scan")
    quantized = weight_cache.quantizations - q0
    differ = [rid for rid in want_tokens
              if not np.array_equal(tl[rid][0], want_tokens[rid])]
    release_steps(scan)
    if differ or launches != want_launches or quantized:
        raise AssertionError(f"scan serving: tokens of requests {differ} "
                             f"differ from phase 4's, {launches} launches "
                             f"against {want_launches}, {quantized} weight "
                             f"quantizations")
    c = res.counters
    log(f"scan serving: phase 4's cell through one stacked 16-layer "
        f"segment, plain: tokens of all {len(want_tokens)} requests equal "
        f"to phase 4's, {launches} kernel launches (phase 4: "
        f"{want_launches}), captures in the warm-ups "
        f"{kinds(c['warm_graph_captures_by_kind'])}, no weight quantized; "
        f"{res.tokens_per_s:.1f} tokens/s against phase 4's {want_tps:.1f}")
    return {"tokens_equal_phase4": True, "kernel_launches": launches,
            "weight_quantizations": quantized,
            "warm_graph_captures_by_kind": c["warm_graph_captures_by_kind"],
            "graph_replays": c["graph_replays"],
            "tokens_per_s": res.tokens_per_s, "tokens_per_s_phase4": want_tps}


def dryrun_card_leg(torch, host: dict) -> dict:
    """One rank's shard of each of ``DRYRUN_ON_CARD`` on the card (a fake
    256-rank CUDA group, made and destroyed by ``run_cell``), its peak above
    what was allocated before it held to the host trace's peak estimate."""
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.distributed.sharding import FSDP_RULES
    from repro_torch.launch.dryrun import run_cell
    out = {}
    bad = []
    for name in DRYRUN_ON_CARD:
        arch, shape, ov, batch = DRYRUN_CELLS[name]
        h = host[name]
        t0 = time.perf_counter()
        rec = run_cell(arch, shape, False,
                       overrides=dict(ov, rules=FSDP_RULES)
                       if ov.get("rules") == "fsdp" else ov, device=DEVICE,
                       cell=batch and dataclasses.replace(
                           SHAPES[shape], global_batch=batch))
        secs = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        card = rec["card"]
        est = h["memory_analysis"]["peak_estimate_bytes"]
        ratio = est / card["peak_above_baseline"]
        r = h["roofline"]
        step_s = card["median_ms"] / 1e3
        terms = {k: r[f"t_{k}"] for k in ("compute", "memory", "collective")}
        log(f"dry run on the card, {arch} x {name} {ov or ''}"
            f"{f' global batch {batch}' if batch else ''}"
            f"{' FSDP' if h.get('fsdp') else ''}"
            f"{' fp8 KV' if h.get('kv_cache_dtype') else ''} (one rank of "
            f"pod16x16, a fake 256-rank CUDA group): step median "
            f"{card['median_ms']:.2f} ms of "
            f"{[round(x, 2) for x in card['step_ms']]} against the roofline's"
            f" compute {terms['compute'] * 1e3:.2f}, memory "
            f"{terms['memory'] * 1e3:.2f}, collective "
            f"{terms['collective'] * 1e3:.2f} ms "
            f"({step_s / max(terms['compute'], terms['memory']):.2f}x the "
            f"larger on-card term; the collectives, FSDP's gathers and "
            f"reduce-scatters too, moved nothing); peak "
            f"{card['peak_above_baseline'] / 1e9:.3f} GB allocated above the "
            f"{card['baseline_allocated'] / 1e9:.3f} GB held before the cell "
            f"against the meta estimate {est / 1e9:.3f} GB (ratio "
            f"{ratio:.3f}, bound {1 - DRYRUN_PEAK_TOL:.2f}-"
            f"{1 + DRYRUN_PEAK_TOL:.2f}); {secs:.1f} s")
        if not abs(ratio - 1.0) <= DRYRUN_PEAK_TOL:
            bad.append(f"{name}: meta peak {est} against the card's "
                       f"{card['peak_above_baseline']}")
        out[name] = {**card, "peak_estimate_bytes": est, "ratio": ratio,
                     "seconds": secs, "roofline_terms_s": terms,
                     "overrides": ov}
    if bad:
        raise AssertionError("dry run: " + "; ".join(bad))
    return out


def scan_phase(torch, training: dict) -> dict:
    """Phase 28's scan leg (after phase 27; module docstring)."""
    t0 = time.perf_counter()
    out = {"scan_train": scan_train_leg(torch, training)}
    gc.collect()
    torch.cuda.empty_cache()
    out["scan_serve"] = scan_serve_leg(torch)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 28's scan leg: {out['seconds']:.1f} s")
    return out


def dryrun_phase(torch) -> dict:
    """Phase 28's dry-run leg (module docstring), run after the last
    model's phase, so that the host trace, started after phase 7, has every
    later phase's time to end in."""
    t0 = time.perf_counter()
    host, waited = host_dryrun_records()
    out = {"host_wait_s": waited}
    out["host"] = {}
    for name, rec in host.items():
        arch, shape, ov, batch = DRYRUN_CELLS[name]
        r = rec["roofline"]
        coll = r["meta"]["collectives"]
        mem = rec["memory_analysis"]
        log(f"dry run on the host, {arch} x {name} {ov or ''}"
            f"{f' global batch {batch}' if batch else ''}"
            f"{' FSDP' if rec.get('fsdp') else ''}"
            f"{' fp8 KV' if rec.get('kv_cache_dtype') else ''} (pod16x16, "
            f"rank 0 of a fake 256-rank group, meta): traced in "
            f"{rec['trace_s']} s; per "
            f"rank {mem['argument_size_in_bytes'] / 1e9:.3f} GB of arguments,"
            f" peak estimate {mem['peak_estimate_bytes'] / 1e9:.3f} GB; "
            f"{rec['cost_analysis']['flops']:.4e} FLOPs; collectives "
            + ", ".join(f"{k} {coll[k] / 1e9:.3f} GB ({coll['counts'][k]})"
                        for k in coll["counts"] if coll["counts"][k])
            + f" (in the layers {coll['inloop'] / 1e9:.3f} GB); roofline "
            f"against H100_SXM: compute {r['t_compute']:.4e} s, memory "
            f"{r['t_memory']:.4e} s, collective {r['t_collective']:.4e} s, "
            f"bottleneck {r['bottleneck']}"
            + (f", optimizer {rec['optimizer']}, "
               f"{rec['n_microbatches']} microbatches"
               if "optimizer" in rec else ""))
        out["host"][name] = {
            k: rec[k] for k in ("trace_s", "memory_analysis",
                                "cost_analysis", "collective_split")} | {
            "collectives": coll, "t_compute": r["t_compute"],
            "t_memory": r["t_memory"], "t_collective": r["t_collective"],
            "bottleneck": r["bottleneck"]}
    log(f"the host dry run took {time.perf_counter() - DRYRUN_PROC['t0']:.1f}"
        f" s beside the card's phases; phase 28 waited {waited:.1f} s for it")
    out["card"] = dryrun_card_leg(torch, host)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 28's dry-run leg: {out['seconds']:.1f} s")
    return out


def phase28_record(scan: dict, dryrun: dict) -> dict:
    """Phase 28's two legs and their seconds, printed against its budget."""
    out = {"scan": scan, "dryrun": dryrun,
           "seconds": scan["seconds"] + dryrun["seconds"]}
    log(f"phase 28 (scan_layers and the dry run): {out['seconds']:.1f} s "
        f"(scan leg {scan['seconds']:.1f} s, dry-run leg "
        f"{dryrun['seconds']:.1f} s, of which {dryrun['host_wait_s']:.1f} s "
        f"waiting for the host trace; budget {SCAN_DRYRUN_BUDGET_S:.0f} s)"
        f"{'; ' + card_line() if DEVICE == 'cuda' else ''}")
    return out


def no_silent_faults(engine_cls) -> None:
    """Every drain of ``engine_cls`` in this run: one served without a
    fault injector must report no kernel fault and no degradation (a real
    step error is never contained in silence)."""
    serve = engine_cls.serve

    def checked(self, *args, **kw):
        out = serve(self, *args, **kw)
        f = out.counters["faults"]
        if self.faults is None and (f["kernel_faults"]
                                    or f["degraded_paged_attn"]):
            raise AssertionError(f"a drain without an injector reported "
                                 f"kernel faults or a degradation: {f}")
        return out
    engine_cls.serve = checked


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
    from repro_torch.serve import ContinuousBatchingEngine
    resolve_device("cuda")            # sets the matmul precision policy
    no_silent_faults(ContinuousBatchingEngine)

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
    report["fp8_ptxas"] = {n: ptxas_report(n) for n in ("quant_cast",
                                                        "fp8_matmul")}
    report["fp8_times"] = phase("fp8 kernel times", fp8_time_phase, torch)

    from repro_torch.launch.serve import make_model_and_params
    t0 = time.perf_counter()
    model, params = make_model_and_params("llama3_1b", False, "cuda", seed=0)
    torch.cuda.synchronize()
    log(f"{model.cfg.name}: {model.n_params() / 1e9:.3f}B params, "
        f"random init in {time.perf_counter() - t0:.1f} s")
    report.update(phase("serving", serve_phase, torch, model, params))
    report["mesh"] = phase("mesh serving", mesh_phase, torch, model, params)

    failures: list = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        bundle, batches, report["calibration"] = phase(
            "calibration", calibration_phase, torch, model, params,
            Path(tmp))
        report["measured_tier"] = phase("measured tier", measured_phase,
                                        torch, model, params, bundle)
        # phase 28's host leg runs beside the later phases: after the tier,
        # whose host-clock timings it would perturb
        start_host_dryrun()
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
    report["prefix"] = phase("prefix cache, preemption, chunked prefill",
                             prefix_phase, torch, model, params)
    report["pipeline"] = phase("pipelined drain and control plane",
                               pipeline_phase, torch, model, params)
    report["dense_rings"] = phase("dense rings", dense_phase, torch, model,
                                  params)
    report["ttft_cell"] = phase("TTFT cell", ttft_phase, torch, model,
                                params)
    # the measured ET plan quantizes nothing when no group's measured gain
    # beats the noise (ROADMAP C3): the guardrail and the ladder then take
    # the TT plan, whose theoretical gains are positive for every fp8 op
    rplan = plans["ET"] if plans["ET"].n_quantized else plans["TT"]
    if rplan is not plans["ET"]:
        log(f"phase 21 serves the TT plan ({rplan.n_quantized} ops fp8): "
            f"the measured ET plan quantizes nothing")
    report["robustness"] = phase("serving robustness", robustness_phase,
                                 torch, model, params, rplan, bundle)
    del model, params, bundle, batches
    gc.collect()                      # the model's decode graphs go with it
    torch.cuda.empty_cache()
    report["training"] = phase("training", training_phase, torch)
    report["train_mesh"] = phase("training over a mesh", train_mesh_phase,
                                 torch, report["training"])
    scan = phase("scan layers", scan_phase, torch, report["training"])
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
    report["prefix_mla"] = phase("MLA prefix cache", mla_prefix_phase, torch,
                                 absorbed, ds_params)
    report["pipeline_mla"] = phase(f"pipelined drain {DEEPSEEK}",
                                   pipeline_check, torch, absorbed,
                                   ds_params, "mla_mma")
    del absorbed, expanded, ds_params
    gc.collect()
    torch.cuda.empty_cache()
    report["dense"] = {}
    for arch, depth in DENSE_CONFIGS:
        report["dense"][arch] = phase(arch, dense_config_phase, torch, arch,
                                      depth)
        gc.collect()                  # the model's graphs and weights
        torch.cuda.empty_cache()
    report["moe"] = phase("MoE and MTP", moe_phase, torch)
    gc.collect()
    torch.cuda.empty_cache()
    report["ssm"] = phase("Mamba-2 and Hymba", ssm_phase, torch)
    gc.collect()
    torch.cuda.empty_cache()
    report["encdec_vlm"] = phase("Whisper and LLaVA", encdec_vlm_phase,
                                 torch)
    gc.collect()
    torch.cuda.empty_cache()
    report["scan_dryrun"] = phase28_record(
        scan, phase("the dry run", dryrun_phase, torch))
    ev = report["encdec_vlm"]

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
        "launches_phase15": {k: report["prefix"][k]["kernel_launches"]
                             for k in ("shared_prefix", "preemption",
                                       "chunked")},
        "launches_phase17": {k: report["pipeline"][k]["kernel_launches"]
                             for k in ("plain_fused", "mp_fused",
                                       "shared_prefix", "preemption",
                                       "chunked")},
        "launches_phase18": {a: r["kernel_launches_main_path"]
                             for a, r in report["dense"].items()},
        "launches_phase22": report["moe"][MOONLIGHT][
            "kernel_launches_main_path"],
        "launches_phase23": {
            HYMBA: report["ssm"][HYMBA]["kernel_launches"],
            "window_cut": report["ssm"][HYMBA]["window_cut"][
                "kernel_launches"]},
        "launches_phase24": {LLAVA: ev[LLAVA][
            "kernel_launches_main_path"]},
        "llava": {k: report["gqa_times"]["llava"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "head_group")},
        "head_group_1": {k: report["gqa_times"]["d128_g1"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "hymba": {k: report["gqa_times"]["hymba"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "hymba_window": {k: report["gqa_times"]["hymba_window"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "window", "lengths")},
        "hymba_window_max_abs_err": report["ssm"]["kernels"][
            "window_max_abs_err"],
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
            "launches_whisper_tier": ev[WHISPER]["measured_tier"][
                "launches"][name],
            **({"max_abs_err_ssm_shapes": report["ssm"]["kernels"][
                "fp8_linear"]} if name == "fp8_matmul" else {}),
            "encdec_vlm_shapes": {
                m: ({g: {**rec["check"]["fp8_gemms"][g], **r_}
                     for g, r_ in rec["times"][name].items()}
                    if name == "fp8_matmul" else rec["times"][name]["act"])
                for m, rec in ev["kernels"].items()},
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
        "launches_phase15": {"shared_prefix":
                             report["prefix_mla"]["kernel_launches"]},
        "launches_phase22": report["moe"][DEEPSEEK][
            "kernel_launches_main_path"],
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
    print(json.dumps({"prefix_cache": report["prefix"],
                      "prefix_cache_mla": report["prefix_mla"]}), flush=True)
    print(json.dumps({"dense_rings": report["dense_rings"],
                      "ttft_cell": report["ttft_cell"]}), flush=True)
    print(json.dumps({"robustness": report["robustness"], "card": card}),
          flush=True)
    print(json.dumps({"pipeline": report["pipeline"],
                      "pipeline_llama3_8b": l8["pipelined_vs_lockstep"],
                      "pipeline_mla": report["pipeline_mla"]}), flush=True)
    print(json.dumps({"dense": {a: {k: r[k] for k in (
        "n_params", "weights_gb", "serving_peak_gb", "mp_plan", "serving",
        "agreement", "graph_vs_eager", "kernel_launches_main_path")
        if k in r} | ({"calibration": r["calibration"]}
                      if "calibration" in r else {})
        for a, r in report["dense"].items()}}), flush=True)
    print(json.dumps({"moe": {a: {k: r[k] for k in r if k != "serving"}
                              if isinstance(r, dict) and "serving" in r
                              else r for a, r in report["moe"].items()}}),
          flush=True)
    print(json.dumps({"ssm": report["ssm"], "card": card}), flush=True)
    print(json.dumps({"mesh": report["mesh"], "card": card}), flush=True)
    print(json.dumps({"training": report["training"], "card": card}),
          flush=True)
    print(json.dumps({"train_mesh": report["train_mesh"], "card": card}),
          flush=True)
    print(json.dumps({"scan_dryrun": report["scan_dryrun"], "card": card}),
          flush=True)
    print(json.dumps({"encdec_vlm": {
        WHISPER: {k: v for k, v in ev[WHISPER].items()},
        LLAVA: {k: v for k, v in ev[LLAVA].items() if k != "serving"},
        "kernels": ev["kernels"]}, "card": card}), flush=True)
    mt = report["measured_tier"]
    print(json.dumps({"calibration": report["calibration"],
                      "measured_tier": {k: mt[k] for k in (
                          "seconds", "n_warmup", "n_iters", "n_forwards",
                          "n_captures", "weight_quantizations",
                          "base_ms_tier", "base_spread_ms",
                          "groups_beyond_spread",
                          "spread_across_captures_ms",
                          "groups_beyond_spread_across_captures",
                          "et_n_fp8", "et_assignment", "fig3b",
                          "placement")},
                      "fp8_linear": t["fp8_linear"],
                      "plans": report["plan_serving"]["plans"],
                      "fig3a": report["fig3a"],
                      "phase_seconds": report["phase_seconds"]}), flush=True)
    total_s = time.perf_counter() - T_START
    log(f"chip_smoke: {total_s:.1f} s in all, the kernels' build included "
        f"(budget {SCRIPT_BUDGET_S:.0f} s); phase 26: "
        f"{report['mesh']['seconds']:.1f} s (budget "
        f"{MESH_PHASE_BUDGET_S:.0f} s); phase 27: "
        f"{report['train_mesh']['seconds']:.1f} s (budget "
        f"{TRAIN_MESH_BUDGET_S:.0f} s); phase 28: "
        f"{report['scan_dryrun']['seconds']:.1f} s (budget "
        f"{SCAN_DRYRUN_BUDGET_S:.0f} s)")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
