"""Serving engines (port of ``repro/serve/engine.py``).

* :class:`ServeEngine` — one-shot batch serving: bucketed prefill into dense
  rings, then lock-step greedy decode. It is the parity reference for the
  continuous engine.
* :class:`ContinuousBatchingEngine` — a request queue drains through a fixed
  pool of cache slots over the paged KV pool: requests are admitted
  mid-decode as slots free up (``Scheduler``), each admitted prompt is
  prefilled straight into its slot's blocks, and one decode step advances
  every occupied slot at its own depth. Decode attention runs through the
  CUDA paged-attention kernel (``paged_attn="fused"``, the default) or the
  reference gather path (``"gather"``). On CUDA the decode step is a CUDA
  graph, captured once and replayed (``launch/steps.PagedDecodeStep``):
  the engine keeps the pool's cache tensors and the step's input buffers
  across drains (the caches zeroed at each drain's start), so the graph
  stays bound to them, and fills the buffers with ``copy_`` before each
  step. ``counters`` report the drain's captures and replays.

This slice ports the lockstep drain only: every step's tokens are read back
before the next step is dispatched. Prefix caching, preemption, chunked
prefill, the pipelined drain, load-adaptive MP, fault injection, the
numerical guardrail, dense-ring continuous serving and mesh serving raise
``NotImplementedError`` naming the slice that brings them (ROADMAP.md).

Both engines accept ``mp`` as an op->format dict or an ``MPPlan``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.mpconfig import as_assignment
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import paged_attention as _paged_kernel
from repro_torch.launch import steps as _steps
from repro_torch.launch.steps import (get_serving_step, greedy_next_token,
                                      merge_first_tokens)
from repro_torch.serve.cache_pool import PagedCachePool, paged_block_bytes
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["ServeEngine", "ContinuousBatchingEngine", "GenResult",
           "ServeSummary", "prefill_bucket"]


def prefill_bucket(n: int, min_bucket: int = 8) -> int:
    """Padded length for a prefill of ``n`` real tokens: the next power of
    two, at least ``min_bucket``."""
    if n < 1:
        raise ValueError(n)
    return max(min_bucket, 1 << (n - 1).bit_length())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_params(params: dict, device: torch.device) -> None:
    dev = params["embed"]["w"].device
    if dev != device and not (dev.type == device.type == "cuda"
                              and device.index is None):
        raise ValueError(f"params live on {dev}, the engine on {device}")


@dataclasses.dataclass
class GenResult:
    tokens: np.ndarray            # (B, max_new_tokens) int32
    ttft_s: float
    decode_s: float
    tokens_per_s: float


@dataclasses.dataclass
class ServeSummary:
    """Outcome of draining a request queue through the continuous engine."""
    results: dict                     # rid -> RequestResult
    n_steps: int                      # decode steps executed
    decode_s: float                   # wall time inside decode steps
    total_s: float                    # wall time of the whole drain
    tokens_per_s: float               # decode-produced tokens / decode_s
    counters: dict = dataclasses.field(default_factory=dict)


class ServeEngine:
    """One-shot batch serving: prefill + lock-step greedy decode."""

    def __init__(self, model, mp=None, device: DeviceLike = None):
        self.model = model
        self.mp = as_assignment(mp)
        self.device = resolve_device(device)
        self.prefill_step = get_serving_step(model, "prefill", mp=self.mp)
        self.bucketed_prefill_step = get_serving_step(
            model, "bucketed_prefill", mp=self.mp)
        self.decode_step = get_serving_step(model, "decode", mp=self.mp)

    def _prefill(self, params, caches, tokens: torch.Tensor):
        """Bucketed prefill (prompt padded to a power of two and masked), or
        the per-length step once the bucket reaches ``flash_min_seq``."""
        B, T0 = tokens.shape
        Lb = prefill_bucket(T0)
        if Lb >= self.model.cfg.flash_min_seq:
            return self.prefill_step(params, caches, tokens)
        tok = F.pad(tokens, (0, Lb - T0))
        start = torch.zeros((B,), dtype=torch.int32, device=self.device)
        valid = torch.full((B,), T0, dtype=torch.int32, device=self.device)
        return self.bucketed_prefill_step(params, caches, tok, start, valid)

    def generate(self, params, batch: dict, max_new_tokens: int,
                 max_len: Optional[int] = None) -> GenResult:
        """``batch["tokens"]`` (B, T) prompts of one length -> greedy tokens."""
        _check_params(params, self.device)
        tokens = torch.as_tensor(np.asarray(batch["tokens"]),
                                 dtype=torch.int32).to(self.device)
        B, T0 = tokens.shape
        max_len = max_len or (T0 + max_new_tokens)
        caches = self.model.init_cache(B, max_len, self.device)
        with torch.no_grad():
            _sync(self.device)
            t0 = time.perf_counter()
            logits, caches = self._prefill(params, caches, tokens)
            out = [greedy_next_token(logits)]
            _sync(self.device)
            ttft = time.perf_counter() - t0
            t1 = time.perf_counter()
            for i in range(max_new_tokens - 1):
                logits, caches = self.decode_step(params, caches,
                                                  out[-1][:, None], T0 + i)
                out.append(greedy_next_token(logits))
            toks = torch.stack(out, dim=1).cpu().numpy()
            dt = time.perf_counter() - t1
        return GenResult(tokens=toks, ttft_s=ttft, decode_s=dt,
                         tokens_per_s=B * max_new_tokens / max(dt, 1e-9))


# options of the reference engine that later slices port
_LATER = {
    "paged=False": "dense-ring continuous serving lands with chunked "
                   "prefill, port slice 6",
    "prefix_cache": "prefix caching with copy-on-write lands in port "
                    "slice 4",
    "preemption": "priority preemption (resumed through the prefix cache) "
                  "lands in port slice 4",
    "chunk_len": "chunked prefill lands in port slice 6",
    "adaptive": "load-adaptive MP lands with serving robustness, port "
                "slice 7",
    "faults": "fault injection and containment land with serving "
              "robustness, port slice 7",
    "guardrail": "the numerical guardrail lands with serving robustness, "
                 "port slice 7",
    "mesh": "mesh-sharded serving lands with the multi-GPU slice",
    "sync=False": "the pipelined drain lands in port slice 5",
}


def _refuse(name: str):
    raise NotImplementedError(f"{name}: {_LATER[name]} (see ROADMAP.md)")


class ContinuousBatchingEngine:
    """Continuous batching over a fixed pool of paged cache slots.

    Each clock tick: admit arrived requests while slots and blocks allow
    (the block budget is the backpressure signal), run at most
    ``chunk_budget`` prefill steps while anything decodes (every prefilling
    slot's prompt co-batched, padded to the largest bucket), then one decode
    step over all ``n_slots`` rows with per-row positions and block tables.
    Vacant rows decode garbage whose K/V writes land in the trash block.
    """

    def __init__(self, model, n_slots: int = 4, max_len: int = 512,
                 mp=None, paged: bool = True, block_size: int = 16,
                 n_blocks: Optional[int] = None,
                 chunk_len: Optional[int] = None, chunk_budget: int = 1,
                 min_bucket: int = 8, paged_attn: Optional[str] = None,
                 mesh=None, prefix_cache: Optional[bool] = None,
                 preemption: bool = False, adaptive=None, faults=None,
                 guardrail=None, device: DeviceLike = None):
        if not paged:
            _refuse("paged=False")
        for name, val in (("prefix_cache", prefix_cache),
                          ("preemption", preemption),
                          ("chunk_len", chunk_len is not None),
                          ("adaptive", adaptive is not None),
                          ("faults", faults is not None),
                          ("guardrail", guardrail is not None),
                          ("mesh", mesh is not None)):
            if val:
                _refuse(name)
        if paged_attn is None:
            paged_attn = "fused"
        if paged_attn not in ("fused", "gather"):
            raise ValueError(f"paged_attn must be 'fused' or 'gather', got "
                             f"{paged_attn!r}")
        if chunk_budget < 1:
            raise ValueError(f"chunk_budget must be >= 1, got {chunk_budget}")
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.mp = as_assignment(mp)
        self.block_size = block_size
        self.n_blocks = n_blocks
        self.chunk_budget = chunk_budget
        self.min_bucket = min_bucket
        self.paged_attn = paged_attn
        self.device = resolve_device(device)
        self.prefill_chunk_step = get_serving_step(model, "chunked_prefill",
                                                   mp=self.mp)
        self.decode_step = get_serving_step(model, "paged_decode", mp=self.mp,
                                            paged_attn=paged_attn)
        self._kept = None         # (caches, host and device decode inputs)

    def _pool_and_inputs(self):
        """This drain's pool, over the cache tensors of the engine's last
        drain (zeroed), and the decode step's input buffers: pinned host
        arrays for positions and block tables, and device buffers for
        token, positions and block tables, filled with ``copy_`` each step.
        Keeping them keeps the decode graph bound across drains."""
        pool = PagedCachePool(self.model, self.n_slots, self.max_len,
                              block_size=self.block_size,
                              n_blocks=self.n_blocks, device=self.device,
                              caches=None if self._kept is None
                              else self._kept[0])
        if self._kept is None:
            dev, n, nb = self.device, self.n_slots, pool.max_blocks
            pin = dev.type == "cuda"
            host = (torch.zeros((n,), dtype=torch.int32, pin_memory=pin),
                    torch.zeros((n, nb), dtype=torch.int32, pin_memory=pin))
            inputs = tuple(torch.zeros(shape, dtype=torch.int32, device=dev)
                           for shape in ((n, 1), (n,), (n, nb)))
            self._kept = (pool.caches, host, inputs)
        return pool, self._kept[1], self._kept[2]

    def _admit(self, pool: PagedCachePool, sched: Scheduler,
               now: int) -> None:
        """Claim slots for admissible requests (FCFS within priority); the
        head of the queue waits while the block budget cannot cover it."""
        def gate(r):
            st = sched.states[r.rid]
            need = pool.blocks_for_request(st.effective_prompt_len,
                                           st.remaining_new_tokens)
            if need > pool.allocatable_blocks:
                raise ValueError(
                    f"request {r.rid} needs {need} KV blocks but the pool "
                    f"has only {pool.allocatable_blocks}; raise --n-blocks "
                    f"or shrink the request")
            return pool.can_admit(st.effective_prompt_len,
                                  st.remaining_new_tokens)

        while pool.n_free_slots:
            st = sched.pop_admissible(now, gate)
            if st is None:
                return
            req = st.request
            if req.prompt_len + req.max_new_tokens > self.max_len:
                raise ValueError(
                    f"request {req.rid}: {req.prompt_len}+"
                    f"{req.max_new_tokens} exceeds max_len {self.max_len}")
            slot = pool.alloc_slot(st.effective_prompt_len,
                                   st.remaining_new_tokens)
            sched.start_prefill(st, slot, now)
            st.wall_admitted = time.perf_counter()

    def _prefill_tick(self, params, pool: PagedCachePool, sched: Scheduler,
                      now: int):
        """One prefill step co-batching every prefilling slot's prompt over
        the full ``n_slots`` batch (inactive rows pass through with valid =
        0). Returns (device tokens, finished (slot, state) pairs, prompt
        tokens processed)."""
        cands = sorted(
            ((slot, st, st.prefill_pos,
              st.effective_prompt_len - st.prefill_pos)
             for slot, st in sched.prefilling.items()),
            key=lambda c: (-c[1].request.priority, c[3], c[0]))
        for slot, st, start, take in cands:
            pool.ensure_range(slot, start, start + take)
        bucket = max(prefill_bucket(take, self.min_bucket)
                     for *_, take in cands)
        tok = np.zeros((self.n_slots, bucket), np.int32)
        start_v = np.ones((self.n_slots,), np.int32)   # >0: leave row alone
        valid_v = np.zeros((self.n_slots,), np.int32)  # 0: inactive row
        for slot, st, start, take in cands:
            tok[slot, :take] = np.asarray(st.effective_tokens,
                                          np.int32)[start:start + take]
            start_v[slot] = start
            valid_v[slot] = take
        dev = self.device
        t0 = time.perf_counter()
        logits, pool.caches = self.prefill_chunk_step(
            params, pool.caches, torch.from_numpy(tok).to(dev),
            torch.from_numpy(start_v).to(dev),
            torch.from_numpy(valid_v).to(dev), pool.block_tables_device())
        nxt = greedy_next_token(logits)
        dt = time.perf_counter() - t0
        finished = []
        for slot, st, start, take in cands:
            st = sched.prefill_advance(slot, take, dt)
            if st.prefill_pos == st.effective_prompt_len:
                finished.append((slot, sched.finish_prefill(slot, None, now)))
        return nxt, finished, sum(c[3] for c in cands)

    def serve(self, params, requests: Sequence[Request], *,
              sync: bool = True) -> ServeSummary:
        """Drain ``requests`` (any arrival order) and return all results.
        Only the lockstep drain (``sync=True``) is ported."""
        if not sync:
            _refuse("sync=False")
        _check_params(params, self.device)
        pool, (pos_host, bt_host), (tok_in, pos_in, bt_in) = \
            self._pool_and_inputs()
        sched = Scheduler()
        for r in sorted(requests, key=lambda r: (r.arrival, r.rid)):
            sched.submit(r)
        retired = []
        cur_tok = torch.zeros((self.n_slots, 1), dtype=torch.int32,
                              device=self.device)
        now = n_steps = 0
        decode_s = 0.0
        peak_queue = peak_live = peak_blocks = peak_slots = 0
        prefill_chunks = prefill_tokens = decode_stall_steps = 0
        launches0 = _paged_kernel.launches
        graphs0 = _steps.graph_captures, _steps.graph_replays

        def deliver(nxt, deliveries):
            """Read one step's tokens back (this blocks on the step) and fill
            each (state, index, slot) placeholder."""
            arr = nxt.cpu().numpy()
            t_now = time.perf_counter()
            for st, idx, slot in deliveries:
                st.out_tokens[idx] = int(arr[slot])
                if idx == 0:
                    st.ttft_s = t_now - st.wall_admitted

        t_start = time.perf_counter()
        with torch.no_grad():
            while sched.has_work():
                self._admit(pool, sched, now)
                peak_queue = max(peak_queue, sched.queue_depth)
                chunks = 0
                while sched.prefilling and (not sched.running
                                            or chunks < self.chunk_budget):
                    if sched.running:
                        decode_stall_steps += 1
                    nxt, finished, n_tok = self._prefill_tick(
                        params, pool, sched, now)
                    prefill_chunks += 1
                    prefill_tokens += n_tok
                    chunks += 1
                    if finished:
                        mask = np.zeros((self.n_slots,), bool)
                        for slot, _ in finished:
                            mask[slot] = True
                        cur_tok = merge_first_tokens(
                            cur_tok, nxt, torch.from_numpy(mask).to(
                                self.device))
                        deliver(nxt, [(st, len(st.out_tokens) - 1, slot)
                                      for slot, st in finished])
                        for slot, st in finished:
                            if st.done:              # max_new_tokens == 1
                                retired.append(sched.retire(st, now))
                                pool.free_slot(slot)
                    self._admit(pool, sched, now)
                if sched.running:
                    pos = pos_host.numpy()
                    pos[:] = 0
                    for slot, st in sched.running.items():
                        pos[slot] = st.next_pos
                        pool.ensure_block(slot, st.next_pos)
                    peak_live = max(peak_live, sum(
                        st.next_pos + 1 for st in sched.running.values()))
                    peak_slots = max(peak_slots, len(sched.running))
                    peak_blocks = max(peak_blocks, pool.blocks_in_use)
                    # decode sees block tables only for running rows: a slot
                    # mid-prefill owns real blocks, and the vacant-row
                    # garbage write must go to the trash block
                    bt = bt_host.numpy()
                    bt[:] = pool.block_tables
                    for s in range(self.n_slots):
                        if s not in sched.running:
                            bt[s] = -1
                    t0 = time.perf_counter()
                    # the host arrays are pinned and rewritten only after
                    # the previous step's tokens were read back, so the
                    # copies need not wait for the device
                    tok_in.copy_(cur_tok)
                    pos_in.copy_(pos_host, non_blocking=True)
                    bt_in.copy_(bt_host, non_blocking=True)
                    _, pool.caches, nxt = self.decode_step(
                        params, pool.caches, tok_in, pos_in, bt_in)
                    cur_tok = nxt[:, None]
                    deliveries = []
                    for slot in list(sched.running):
                        st = sched.running[slot]
                        deliveries.append((st, len(st.out_tokens), slot))
                        sched.record_token(slot, None)
                    deliver(nxt, deliveries)
                    decode_s += time.perf_counter() - t0
                    n_steps += 1
                    for slot in list(sched.running):
                        st = sched.running[slot]
                        if st.done:
                            retired.append(sched.retire(st, now))
                            pool.free_slot(slot)
                    now += 1
                elif not sched.prefilling:
                    # idle: jump the clock to the next arrival
                    nxt_arrival = sched.next_arrival()
                    if nxt_arrival is None:
                        break
                    now = max(now + 1, nxt_arrival)
        total_s = time.perf_counter() - t_start
        results = {st.request.rid: sched.materialize(st) for st in retired}
        n_decoded = sum(max(len(r.tokens) - 1, 0) for r in results.values())
        ttfts = sorted(r.ttft_s for r in results.values())
        blk_bytes = paged_block_bytes(self.model, pool.block_size)
        counters = {
            "paged": True,
            "sync": True,
            "paged_attn": self.paged_attn,
            "n_decode_steps": n_steps,
            "kernel_launches": _paged_kernel.launches - launches0,
            "graph_captures": _steps.graph_captures - graphs0[0],
            "graph_replays": _steps.graph_replays - graphs0[1],
            "ttft_p50_s": ttfts[len(ttfts) // 2] if ttfts else 0.0,
            "wall_tokens_per_s": n_decoded / total_s if total_s > 0 else 0.0,
            "peak_queue_depth": peak_queue,
            "blocked_admissions": sched.blocked_admissions,
            "peak_live_tokens": peak_live,
            "peak_slots_in_use": peak_slots,
            "prefill_chunks": prefill_chunks,
            "prefill_tokens": prefill_tokens,
            "decode_stall_steps": decode_stall_steps,
            "block_size": pool.block_size,
            "n_blocks": pool.n_blocks,
            "peak_blocks_in_use": peak_blocks,
            "kv_bytes_per_block": blk_bytes,
            "peak_kv_bytes": peak_blocks * blk_bytes,
        }
        return ServeSummary(
            results=results, n_steps=n_steps, decode_s=decode_s,
            total_s=total_s,
            tokens_per_s=n_decoded / decode_s if decode_s > 0 else 0.0,
            counters=counters)
