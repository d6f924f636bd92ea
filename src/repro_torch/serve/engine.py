"""Serving engines (port of ``repro/serve/engine.py``).

TTFT (the paper's measured quantity) is the wall time of the prefill step:
:meth:`ServeEngine.ttft` is the median of ``n_iters`` prefills.

* :class:`ServeEngine` — one-shot batch serving: bucketed prefill into dense
  rings, then lock-step greedy decode. It is the parity reference for the
  continuous engine.
* :class:`ContinuousBatchingEngine` — a request queue drains through a fixed
  pool of cache slots: requests are admitted mid-decode as slots free up
  (``Scheduler``), each admitted prompt is prefilled into its slot, and one
  decode step advances every occupied slot at its own depth. The pool is
  paged by default (each prompt prefilled straight into its slot's
  blocks; decode attention through the CUDA paged-attention kernel,
  ``paged_attn="fused"``, or the reference gather path, ``"gather"``);
  ``paged=False`` keeps the dense per-slot rings (``CachePool``).

On CUDA every serving step is a CUDA graph, captured once per input shape
(a prefill bucket, the decode batch) and replayed
(``launch/steps.GraphedStep``), as the reference compiles every step once
per shape. The engines keep their caches (the continuous engine its pool,
with its prefix index) and the decode step's input buffers across calls,
so the graphs stay bound to them, and fill the buffers with ``copy_``
before each step. ``counters`` report the drain's captures and replays.

As in the reference, the continuous engine shares KV blocks across requests
by default (``prefix_cache``, copy-on-write, the index kept across drains),
lets a strictly higher-priority waiter evict a live request under block
pressure (``preemption``; the victim resumes by re-prefilling its prompt
and the tokens it had), splits long prompts into chunks interleaved with
decode steps (``chunk_len``, ``chunk_budget``), and drains pipelined: the
device runs up to ``max_in_flight`` steps ahead while a consumer thread
reads tokens back (``serve(sync=True)`` is the lockstep drain). Requests
can be cancelled (``cancel``, ``shutdown``, ``Request.timeout_steps``) and
streamed (``on_token``). As in the reference it contains faults (an
injector's schedule, ``faults``; a non-finite tripwire read back beside
each step's tokens; bounded retries through the resume path, poisoned-page
quarantine, fused -> gather degradation after repeated kernel faults),
holds an MP plan to its loss-MSE budget with a shadow step
(``guardrail``) and walks a ladder of plans under load (``adaptive``).

``ContinuousBatchingEngine(mesh=...)`` serves over a (data, model)
``DeviceMesh`` as the reference does: the layout is planned once
(``serve.parallel``), each ``serve()`` serves this rank's shard of the
params, the pool holds this rank's shard of the caches (slots and, when
they split evenly, pages over ``data``; KV heads over ``model``), and
every step runs through ``launch.steps.mesh_step``. Every rank runs the
same host scheduler and pool books; each step's tokens are gathered to
every rank, so their decisions agree. ``adaptive`` (host timings) and
expert layers are refused with a mesh.

Both engines accept ``mp`` as an op->format dict or an ``MPPlan``.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
import weakref
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.mpconfig import as_assignment
from repro_torch.core.sensitivity import as_tensor
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import paged_attention as _paged_kernel
from repro_torch.launch import steps as _steps
from repro_torch.launch.steps import (get_serving_step, greedy_next_token,
                                     merge_first_tokens, nonfinite_rows,
                                     shadow_logit_mse)
from repro_torch.models.lm import cache_tensors, ssm_tensors
from repro_torch.nn.spec import flatten_paths
from repro_torch.serve.cache_pool import (CachePool, PagedCachePool,
                                          dense_slot_bytes, host_to_device,
                                          paged_block_bytes, paged_slot_bytes)
from repro_torch.serve.faults import InjectedFault, poison_logit_rows
from repro_torch.serve.parallel import (make_serving_layout,
                                        shard_serving_params)
from repro_torch.serve.scheduler import (DONE, PREFILLING, RUNNING, WAITING,
                                         Request, Scheduler)

__all__ = ["ServeEngine", "ContinuousBatchingEngine", "GenResult",
           "ServeSummary", "prefill_bucket"]


def prefill_bucket(n: int, chunk_len: Optional[int] = None,
                   min_bucket: int = 8) -> int:
    """Padded length for a prefill chunk of ``n`` real tokens: the next
    power of two, at least ``min_bucket``, clamped to ``chunk_len`` when
    chunking is on."""
    if n < 1:
        raise ValueError(n)
    b = max(min_bucket, 1 << (n - 1).bit_length())
    if chunk_len is not None:
        if n > chunk_len:
            raise ValueError(f"chunk of {n} tokens exceeds chunk_len "
                             f"{chunk_len}")
        b = min(b, chunk_len)
    return b


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

    def tokens_for(self, rid: int) -> np.ndarray:
        return self.results[rid].tokens


def _tokens(batch: dict, device: torch.device) -> torch.Tensor:
    return as_tensor(batch["tokens"], device).to(torch.int32)


class ServeEngine:
    """One-shot batch serving: prefill + lock-step greedy decode.

    Prefill is length-bucketed (the prompt padded to a power of two and
    masked: one step per bucket, shared with the dense continuous engine);
    a prompt whose bucket reaches ``flash_min_seq`` takes the per-length
    step, which attends through the blocked flash attention, and so do an
    encoder-decoder's batches (``frames``, encoded at prefill) and a VLM's
    (``prefix_embeds``, prepended to the prompt), as in the reference. A
    batch key that the model does not take raises.
    :meth:`generate` and :meth:`ttft` prefill into caches the engine keeps
    for the last (batch, max_len) and resets in place, so that on CUDA the
    steps' graphs stay bound to one set of tensors; :meth:`init_caches`
    hands out fresh ones."""

    def __init__(self, model, mp=None, device: DeviceLike = None,
                 mesh=None):
        self.model = model
        self.mp = as_assignment(mp)
        self.device = resolve_device(device)
        # kept, unused, as in the reference: one-shot batches are served on
        # one rank; mesh serving is the continuous engine's
        self.mesh = mesh
        self.prefill_step = get_serving_step(model, "prefill", mp=self.mp)
        # an encoder-decoder's caches hold the cross K/V of enc_len frames
        self._encdec = getattr(model, "cache_needs_enc_len", False)
        self._bucketed = getattr(model, "supports_prefill_chunk", False)
        if self._bucketed:
            self.bucketed_prefill_step = get_serving_step(
                model, "bucketed_prefill", mp=self.mp)
        self.decode_step = get_serving_step(model, "decode", mp=self.mp)
        # which prefill steps this engine needed (a bucket, or ("legacy",
        # length)) against the prompt lengths it served
        self.prefill_compile_keys: set = set()
        self.prompt_lens_seen: set = set()
        self._caches = None       # ((batch, max_len, enc_len), the caches)
        self._pos = None          # the decode step's position, on the device

    def init_caches(self, batch: int, max_len: int, enc_len: int = 0) -> dict:
        """Fresh dense caches for ``batch`` sequences of ``max_len`` tokens;
        a model that declares ``cache_needs_enc_len`` (the encoder-decoder)
        also sizes its cross-attention K/V by ``enc_len`` frames."""
        if self._encdec:
            return self.model.init_cache(batch, max_len, enc_len,
                                         self.device)
        return self.model.init_cache(batch, max_len, self.device)

    def _kept_caches(self, batch: int, max_len: int,
                     enc_len: int = 0) -> dict:
        """The engine's caches for (batch, max_len, enc_len), reset in
        place: K/V zeroed and positions -1, as :meth:`init_caches` makes
        them."""
        key = (batch, max_len, enc_len)
        if self._caches is None or self._caches[0] != key:
            self._caches = None            # free the old ones first
            self._caches = (key, self.init_caches(batch, max_len, enc_len))
            return self._caches[1]
        caches = self._caches[1]
        for leaf, t in cache_tensors(caches):
            t.fill_(-1 if leaf == "pos" else 0)
        return caches

    def _inputs(self, batch: dict) -> tuple:
        """(tokens, the per-length prefill step's other inputs: an
        encoder-decoder's ``frames`` or a VLM's ``prefix_embeds``, on the
        engine's device). A key the model does not take raises: such a
        batch is never served as text alone."""
        tokens = _tokens(batch, self.device)
        if self._encdec:
            if batch.get("prefix_embeds") is not None:
                raise ValueError(f"{self.model.cfg.name} is an "
                                 f"encoder-decoder: it takes frames, not "
                                 f"prefix_embeds")
            if batch.get("frames") is None:
                raise KeyError(f"{self.model.cfg.name} is an "
                               f"encoder-decoder: its batches carry frames")
            return tokens, (as_tensor(batch["frames"], self.device),)
        if batch.get("frames") is not None:
            raise ValueError(f"{self.model.cfg.name} is decoder-only: it "
                             f"takes no frames")
        if batch.get("prefix_embeds") is not None:
            return tokens, (as_tensor(batch["prefix_embeds"],
                                      self.device),)
        return tokens, ()

    def _prefill(self, params, caches, tokens: torch.Tensor,
                 extra: tuple = ()):
        """Bucketed prefill, or the per-length step once the bucket reaches
        ``flash_min_seq`` and for batches with ``extra`` inputs (frames,
        prefix embeddings). Returns (last-token logits, caches, next
        token)."""
        B, T0 = tokens.shape
        self.prompt_lens_seen.add(int(T0))
        Lb = prefill_bucket(T0)
        if (extra or not self._bucketed
                or Lb >= self.model.cfg.flash_min_seq):
            self.prefill_compile_keys.add(("legacy", int(T0)))
            return self.prefill_step(params, caches, tokens, *extra)
        self.prefill_compile_keys.add(Lb)
        tok = F.pad(tokens, (0, Lb - T0))
        start = torch.zeros((B,), dtype=torch.int32, device=self.device)
        valid = torch.full((B,), T0, dtype=torch.int32, device=self.device)
        return self.bucketed_prefill_step(params, caches, tok, start, valid)

    def ttft(self, params, batch: dict, max_len: int, n_iters: int = 5,
             n_warmup: int = 2) -> float:
        """Median prefill wall time over ``n_iters`` runs after ``n_warmup``
        (the paper averages 5): the serving prefill path, bucket padding
        included; on CUDA the warm-ups capture the step's graph and the
        timed runs replay it."""
        _check_params(params, self.device)
        tokens, extra = self._inputs(batch)
        enc_len = extra[0].shape[1] if self._encdec else 0
        times = []
        with torch.no_grad():
            for i in range(n_warmup + n_iters):
                caches = self._kept_caches(tokens.shape[0], max_len, enc_len)
                _sync(self.device)
                t0 = time.perf_counter()
                self._prefill(params, caches, tokens, extra)
                _sync(self.device)
                if i >= n_warmup:
                    times.append(time.perf_counter() - t0)
        times.sort()
        return times[len(times) // 2]

    def generate(self, params, batch: dict, max_new_tokens: int,
                 max_len: Optional[int] = None) -> GenResult:
        """``batch["tokens"]`` (B, T) prompts of one length -> greedy
        tokens; an encoder-decoder's batch also carries ``frames`` (B,
        T_enc, d_model), a VLM's may carry ``prefix_embeds`` (B, P,
        d_model), which precede the prompt (decode starts at T + P)."""
        _check_params(params, self.device)
        tokens, extra = self._inputs(batch)
        B, T0 = tokens.shape
        n_extra = extra[0].shape[1] if extra else 0
        enc_len, prefix = (n_extra, 0) if self._encdec else (0, n_extra)
        max_len = max_len or (T0 + prefix + max_new_tokens)
        caches = self._kept_caches(B, max_len, enc_len)
        if self._pos is None:
            self._pos = torch.zeros((), dtype=torch.int32, device=self.device)
        toks = torch.empty((B, max_new_tokens), dtype=torch.int32,
                           device=self.device)
        with torch.no_grad():
            _sync(self.device)
            t0 = time.perf_counter()
            _, caches, nxt = self._prefill(params, caches, tokens, extra)
            toks[:, 0] = nxt
            _sync(self.device)
            ttft = time.perf_counter() - t0
            t1 = time.perf_counter()
            for i in range(max_new_tokens - 1):
                # one graph serves every position: the step reads it from
                # the device, and a step's token outputs are copied out
                # before the next replay overwrites them
                self._pos.fill_(T0 + prefix + i)
                _, caches, nxt = self.decode_step(params, caches,
                                                  toks[:, i:i + 1], self._pos)
                toks[:, i + 1] = nxt
            out = toks.cpu().numpy()
            dt = time.perf_counter() - t1
        return GenResult(tokens=out, ttft_s=ttft, decode_s=dt,
                         tokens_per_s=B * max_new_tokens / max(dt, 1e-9))


class _ImpossibleRequest(Exception):
    """Raised by the paged admission gate when a request's worst-case block
    need exceeds what the pool can ever hold. The engine decides whether
    that is a configuration error (a pool with nothing quarantined: a
    ``ValueError``) or the quarantine having shrunk the pool under a
    request that used to fit (it retires ``failed``)."""

    def __init__(self, st, need: int):
        super().__init__(need)
        self.st = st
        self.need = need


def _weights_of(params: dict) -> tuple:
    """(weak reference, in-place version) of every tensor of ``params``."""
    out = []

    def walk(tree):
        for v in tree.values():
            if isinstance(v, dict):
                walk(v)
            else:
                out.append((weakref.ref(v), v._version))
    walk(params)
    return tuple(out)


def _same_weights(a: tuple, b: tuple) -> bool:
    return len(a) == len(b) and all(
        ra() is not None and ra() is rb() and va == vb
        for (ra, va), (rb, vb) in zip(a, b))


@dataclasses.dataclass
class _HostSet:
    """One step's pinned host buffers: positions and (paged) block tables
    going in, its greedy tokens and non-finite flags coming out, and (on
    CUDA) the event recorded behind its copies."""
    pos: torch.Tensor
    bt: Optional[torch.Tensor]
    tok: torch.Tensor
    flag: torch.Tensor
    event: Optional[object]


def _seconds(timing) -> float:
    """A prefill chunk's time: host seconds, or a (start, end) pair of CUDA
    events read once the end has completed."""
    if isinstance(timing, tuple):
        start, end = timing
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    return timing


class ContinuousBatchingEngine:
    """Continuous batching over a fixed pool of cache slots, paged by
    default (``paged=False``: dense per-slot rings).

    Each clock tick: apply pending control (cancellations, shutdown,
    ``Request.timeout_steps``), admit arrived requests while slots and
    blocks allow (the block budget is the backpressure signal; with
    ``preemption`` a strictly higher-priority waiter gated on it evicts the
    lowest-priority, latest-admitted live request, which re-queues with its
    prompt and the tokens it had), run prefill chunk steps — freely while
    nothing decodes, else at most ``chunk_budget`` — each co-batching the
    next chunk of every prefilling slot (at most ``chunk_len`` tokens,
    padded to the largest bucket; priority, then shortest remaining
    prefill, then slot), then one decode step over all ``n_slots`` rows
    with per-row positions (and block tables). Vacant rows decode garbage
    whose K/V writes land in the trash block (paged), or in the row's own
    ring (dense), which its next occupant's first chunk resets. A dense
    row between two chunks of its prompt decodes at the position its next
    chunk starts at, which that chunk writes first.

    ``prefill_cobatch`` (the default) pads every prefilling slot's next
    chunk to the largest bucket and runs one step; ``False`` runs only the
    chunks of the first candidate's bucket each step, as the reference's
    legacy path does.

    With ``paged=False`` the prefill step is the bucketed one, or with
    ``chunk_len`` the ring-continuing chunked step over rings widened by
    ``chunk_len``; ``n_blocks``, ``paged_attn`` and ``prefix_cache=True``
    are refused, and preemption (which re-prefills through cached blocks)
    is off.

    ``chunk_len`` must be a multiple of an SSM arch's ``ssm.chunk``.

    ``prefix_cache`` (None: on for a paged pure-attention model, off for
    mamba and hybrid archs, whose slot-major SSM state no shared block
    holds; asking for it there raises) hashes each admitted prompt block
    by block against the pool's index, maps matched blocks into the slot's
    table and starts its prefill at the first unmatched token; a shared
    page in a chunk's write range is forked first (copy-on-write). The pool
    and its index outlive the drain, so a later drain hits what an earlier
    one indexed.

    :meth:`cancel` and :meth:`shutdown` may be called from any thread (an
    ``on_token`` callback included); the drain applies them at the top of
    the next tick, so a slot is never freed under a step being built.

    ``adaptive`` (an :class:`~repro_torch.serve.adaptive.
    AdaptiveMPController`, which then holds the base plan: ``mp`` is
    refused beside it) is consulted once per tick before admission and may
    swap every step to another ladder level's plan (:meth:`_swap_plan`:
    other memoized, on the card graphed, steps; the prefix index is
    dropped, as quantized K/V depends on the plan). ``faults`` (a
    :class:`~repro_torch.serve.faults.FaultInjector`) injects its schedule
    at the tick boundary, before each step, before each block allocation
    and at delivery. A faulted request keeps the tokens before its fault;
    it is retried through the resume path up to ``max_retries`` times
    (``RequestResult.status`` ``"retried"``), else retires ``"failed"``;
    the pages of a row whose logits went non-finite (each step's flags are
    read back with its tokens) are quarantined. ``kernel_fault_limit``
    step faults degrade fused paged attention to the gather path.
    ``guardrail`` (a :class:`~repro_torch.serve.adaptive.
    NumericalGuardrail`) runs an unquantized shadow decode step over the
    same inputs every ``every`` steps, before the active step, which then
    overwrites every cache slot the shadow wrote before any attention reads
    it; a breach of the plan's budget restores the base plan."""

    def __init__(self, model, n_slots: int = 4, max_len: int = 512,
                 mp=None, paged: bool = True, block_size: int = 16,
                 n_blocks: Optional[int] = None,
                 chunk_len: Optional[int] = None, chunk_budget: int = 1,
                 min_bucket: int = 8, paged_attn: Optional[str] = None,
                 mesh=None, prefix_cache: Optional[bool] = None,
                 preemption: bool = True, prefill_cobatch: bool = True,
                 adaptive=None, faults=None, max_retries: int = 1,
                 guardrail=None, kernel_fault_limit: int = 2,
                 device: DeviceLike = None):
        if getattr(model, "cache_needs_enc_len", False):
            raise NotImplementedError(
                "continuous batching currently serves decoder-only LMs")
        if mesh is not None and adaptive is not None:
            raise ValueError(
                "adaptive MP decides on host timings, which differ between "
                "a mesh's ranks (every rank must schedule the same steps)")
        if mesh is not None and any(
                model.cfg.layer_signature(i)[1]
                for i in range(model.cfg.n_layers)):
            raise NotImplementedError(
                "mesh serving of expert (MoE) layers: expert parallelism "
                "over a mesh is not ported yet (see ROADMAP.md, C)")
        if adaptive is not None:
            if mp is not None:
                raise ValueError(
                    "pass the base plan through the controller (its level-0 "
                    "tau), not both mp= and adaptive=")
            mp = adaptive.plan
        if int(max_retries) < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if int(kernel_fault_limit) < 1:
            raise ValueError(f"kernel_fault_limit must be >= 1, got "
                             f"{kernel_fault_limit}")
        if not paged and n_blocks is not None:
            raise ValueError("n_blocks only applies to paged mode; drop it "
                             "or remove paged=False")
        if paged_attn is not None and not paged:
            raise ValueError("paged_attn selects the paged decode-attention "
                             "implementation; drop it or remove paged=False")
        if prefix_cache and not paged:
            raise ValueError("prefix_cache shares paged KV blocks; drop it "
                             "or remove paged=False")
        if paged_attn is None:
            paged_attn = "fused"
        if paged_attn not in ("fused", "gather"):
            raise ValueError(f"paged_attn must be 'fused' or 'gather', got "
                             f"{paged_attn!r}")
        if chunk_len is not None and chunk_len < 1:
            raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
        ssm = getattr(model.cfg, "ssm", None)
        if chunk_len is not None and ssm is not None \
                and chunk_len % ssm.chunk != 0:
            raise ValueError(
                f"chunk_len {chunk_len} must be a multiple of the SSD chunk "
                f"({ssm.chunk}): engine chunk boundaries must align with "
                f"the SSD state recurrence for bit-exact resume (override "
                f"cfg.ssm.chunk or pick another chunk_len)")
        # slot-major SSM state cannot be rebuilt from shared KV blocks, so
        # a matched prefix could not skip prefill: SSM/hybrid archs turn
        # the prefix cache off, and asking for it is an error
        ssm_bytes = paged_slot_bytes(model, block_size) if paged else 0
        if prefix_cache and ssm_bytes > 0:
            raise ValueError(
                "prefix_cache is unavailable for SSM/hybrid archs: "
                "slot-major SSM state is not reconstructible from shared KV "
                "blocks, so a matched prefix could not skip prefill")
        if chunk_budget < 1:
            raise ValueError(f"chunk_budget must be >= 1, got {chunk_budget}")
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.adaptive = adaptive
        self.mp = as_assignment(mp)
        # the plan object: the guardrail reads its solved budget
        self._mp_plan = mp
        self.faults = faults
        self.max_retries = int(max_retries)
        self.guardrail = guardrail
        self.kernel_fault_limit = int(kernel_fault_limit)
        self.block_size = block_size
        self.n_blocks = n_blocks
        self.chunk_len = chunk_len
        self.chunk_budget = chunk_budget
        self.min_bucket = min_bucket
        self.paged_attn = paged_attn
        self.paged = bool(paged)
        # a paged pure-attention engine caches prefixes unless refused;
        # preemption resumes through the paged pool
        self.prefix_cache = self.paged and (
            bool(prefix_cache) if prefix_cache is not None
            else ssm_bytes == 0)
        self.preemption = bool(preemption) and self.paged
        self.prefill_cobatch = bool(prefill_cobatch)
        self.device = resolve_device(device)
        # the mesh's layout, planned once (the pool's geometry with it)
        self.mesh = mesh
        self.mesh_layout = make_serving_layout(
            mesh, n_slots=n_slots, max_len=max_len, block_size=block_size,
            n_blocks=n_blocks, paged=self.paged)
        if self.mesh_layout is not None and self.paged:
            self.n_blocks = self.mesh_layout.n_blocks
        self._sharded = None      # (the weights, this rank's shard of them)
        self._prefill_kind = ("chunked_prefill" if self.paged else
                              "dense_chunked_prefill" if chunk_len is not None
                              else "bucketed_prefill")
        self.prefill_chunk_step = self._step(self._prefill_kind)
        self.decode_step = self._step(
            "paged_decode" if self.paged else "decode",
            paged_attn if self.paged else None)
        # which prefill buckets this engine ran, against the prompt lengths
        # it served (kept across drains, as the graphs are)
        self.prefill_compile_keys: set = set()
        self.prompt_lens_seen: set = set()
        self._pool = None
        self._weights = ()        # the weights the pool's index was built on
        self._inputs = None       # device decode input buffers
        self._ring: list = []     # pinned host sets, one per step in flight
        self._ctl_lock = threading.Lock()
        self._cancel_pending: set = set()
        self._shutdown_flag = False

    def cancel(self, rid: int) -> None:
        """Ask for ``rid`` to be cancelled. Thread-safe; applied at the next
        tick: a waiting request leaves the queue, a live one frees its slot.
        The request retires with status ``"cancelled"`` and the tokens it
        had committed by then (possibly none)."""
        with self._ctl_lock:
            self._cancel_pending.add(rid)

    def shutdown(self) -> None:
        """Ask the running drain to stop: every unfinished request is
        cancelled at the next tick, the tokens in flight are delivered, and
        ``serve`` returns the partial results."""
        with self._ctl_lock:
            self._shutdown_flag = True

    def _step(self, kind: str, paged_attn: Optional[str] = None,
              mp="engine"):
        """The memoized step of ``kind`` under the engine's plan (or
        ``mp``) and mesh layout."""
        return get_serving_step(self.model, kind,
                                mp=self.mp if mp == "engine" else mp,
                                paged_attn=paged_attn,
                                mesh_layout=self.mesh_layout)

    def _local_params(self, params):
        """This rank's shard of ``params`` under a mesh, as the reference
        shards them at each ``serve()``: cut once per set of weights (the
        same tensors, unchanged in place, give the same shard, so the
        steps' graphs and the weight cache stay bound to it)."""
        if self.mesh is None:
            return params
        weights = _weights_of(params)
        if self._sharded is None or not _same_weights(self._sharded[0],
                                                      weights):
            self._sharded = (weights, shard_serving_params(
                self.model, params, self.mesh))
        return self._sharded[1]

    @property
    def rank_param_bytes(self) -> Optional[int]:
        """Bytes of the weights this rank holds (after a mesh ``serve``)."""
        if self._sharded is None:
            return None
        return sum(t.numel() * t.element_size()
                   for t in flatten_paths(self._sharded[1]).values())

    def _make_pool(self, params):
        """The engine's one pool, kept across drains with its prefix index
        (a prefix indexed by one drain is a hit in the next) and its cache
        tensors (the steps' graphs stay bound to them). The index is
        dropped when the weights are not the last drain's (other tensors,
        or one changed in place): its blocks hold K/V of those weights. A
        drain that raised with slots in use leaves books that cannot be
        trusted: the next one gets a new pool, with an empty index, over
        the same tensors, reset."""
        pool = self._pool
        weights = _weights_of(params)
        caches = None if pool is None else pool.caches
        if pool is not None and pool.n_free_slots == self.n_slots:
            pool.reset_counters()
            if not _same_weights(self._weights, weights):
                pool.invalidate_prefix_index()
        elif self.paged:
            pool = PagedCachePool(self.model, self.n_slots, self.max_len,
                                  block_size=self.block_size,
                                  n_blocks=self.n_blocks, device=self.device,
                                  caches=caches,
                                  mesh_layout=self.mesh_layout)
            self._pool = pool
        else:
            pool = CachePool(self.model, self.n_slots, self.max_len,
                             chunk_extra=self.chunk_len or 0,
                             device=self.device, caches=caches,
                             mesh_layout=self.mesh_layout)
            self._pool = pool
        self._weights = weights
        return pool

    def _swap_plan(self, plan) -> None:
        """Serve ``plan`` from the next step on: the steps of its assignment
        from the ``get_serving_step`` memo (a plan seen before selects its
        steps, on the card their graphs, again) and no prefix index, since
        blocks written under the old plan hold other K/V bytes."""
        self.mp = as_assignment(plan)
        self._mp_plan = plan
        self.prefill_chunk_step = self._step(self._prefill_kind)
        self.decode_step = self._step(
            "paged_decode" if self.paged else "decode",
            self.paged_attn if self.paged else None)
        if self._pool is not None:
            self._pool.invalidate_prefix_index()

    def _staging(self, pool, n_sets: int):
        """The decode step's device input buffers (token, positions and,
        paged, block tables: the graph is bound to them, so they stay
        single and are filled with stream-ordered ``copy_``) and ``n_sets``
        pinned host sets, one per step in flight, all kept across drains."""
        dev, n = self.device, self.n_slots
        tables = ((n, pool.max_blocks),) if self.paged else ()
        if self._inputs is None:
            self._inputs = tuple(torch.zeros(shape, dtype=torch.int32,
                                             device=dev)
                                 for shape in ((n, 1), (n,)) + tables)
        cuda = dev.type == "cuda"

        def pinned(shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, pin_memory=cuda)
        while len(self._ring) < n_sets:
            self._ring.append(_HostSet(
                pinned((n,)), pinned(tables[0]) if tables else None,
                pinned((n,)), pinned((n,), torch.bool),
                event=torch.cuda.Event() if cuda else None))
        return self._inputs, self._ring[:n_sets]

    def _digests(self, pool: PagedCachePool, st):
        """Chained prefix digests of the request's effective prompt (after
        a preemption the generated tokens extend the chain, so the resumed
        request matches its own still-cached blocks)."""
        if not self.prefix_cache:
            return None
        if st.digests is None:
            st.digests = pool.prefix_digests(st.effective_tokens)
        return st.digests

    def _admit(self, pool, sched: Scheduler, now: int, evict=None,
               on_impossible=None) -> None:
        """Claim slots for admissible requests (priority, then FCFS); in a
        paged pool the best waiter blocks the queue while the block budget
        cannot cover it. With ``evict`` (preemption), a gated waiter that
        outranks a live request evicts the scheduler's victim and admission
        retries; each round removes one victim, and equal priority never
        evicts. ``evict`` returns False when the drain is shutting down.
        A request no pool state can ever hold raises ``ValueError``, unless
        it fit the pool before quarantine shrank it: then
        ``on_impossible`` retires it."""
        gate = None
        if self.paged:
            def gate(r):
                st = sched.states[r.rid]
                need = pool.blocks_for_request(st.effective_prompt_len,
                                               st.remaining_new_tokens)
                if need > pool.allocatable_blocks:
                    raise _ImpossibleRequest(st, need)
                return pool.can_admit(st.effective_prompt_len,
                                      st.remaining_new_tokens,
                                      digests=self._digests(pool, st))

        while True:
            while pool.n_free_slots:
                try:
                    st = sched.pop_admissible(now, gate)
                except _ImpossibleRequest as exc:
                    if (on_impossible is not None
                            and pool.n_quarantined_blocks > 0
                            and exc.need <= pool.n_blocks - 1):
                        on_impossible(exc.st)
                        continue
                    raise ValueError(
                        f"request {exc.st.request.rid} needs {exc.need} KV "
                        f"blocks but the pool has only "
                        f"{pool.allocatable_blocks}; raise --n-blocks or "
                        f"shrink the request") from None
                if st is None:
                    break
                req = st.request
                if req.prompt_len + req.max_new_tokens > self.max_len:
                    raise ValueError(
                        f"request {req.rid}: {req.prompt_len}+"
                        f"{req.max_new_tokens} exceeds max_len "
                        f"{self.max_len}")
                self.prompt_lens_seen.add(req.prompt_len)
                start_at = 0
                if self.paged:
                    # matched prefix blocks are mapped in and skipped
                    slot = pool.alloc_slot(st.effective_prompt_len,
                                           st.remaining_new_tokens,
                                           digests=self._digests(pool, st))
                    start_at = pool.matched_tokens(slot)
                else:
                    slot = pool.alloc()
                sched.start_prefill(st, slot, now, start_at=start_at)
                if st.wall_admitted == 0.0:   # resumed: keep first admission
                    st.wall_admitted = time.perf_counter()
            if evict is None:
                return
            cand = sched.peek_admissible(now)
            if cand is None:
                return
            victim = sched.preempt_candidate(cand.request.priority)
            if victim is None or not evict(victim):
                return

    def _prefill_tick(self, params, pool, sched: Scheduler, now: int,
                      sync: bool = True):
        """One prefill step over the full ``n_slots`` batch (inactive rows
        pass through with valid = 0) co-batching the next chunk (at most
        ``chunk_len`` tokens) of every prefilling slot, or with
        ``prefill_cobatch=False`` of those in the first candidate's bucket;
        in a paged pool a borrowed page in a chunk's write range is forked
        first, and a slot whose pages cannot be allocated (injected, or the
        pool short after a quarantine) is dropped from the step. Returns
        (the chunk's time, device tokens, their non-finite flags, finished
        (slot, state) pairs, prompt tokens processed, states whose
        allocation failed); the tokens are None when every candidate's
        allocation failed and no step ran. The time is device time: the
        lockstep drain (``sync``) waits for the chunk; the pipelined one
        records a pair of CUDA events around it, read after the drain (on
        the CPU the host's time is the chunk's)."""
        cands = []
        for slot, st in sched.prefilling.items():
            start = st.prefill_pos
            take = st.effective_prompt_len - start
            if self.chunk_len is not None:
                take = min(take, self.chunk_len)
            cands.append((slot, st, start, take))
        # priority classes first, then the shortest remaining prefill (a
        # mostly cached prompt has a tiny remainder and jumps the line)
        cands.sort(key=lambda c: (-c[1].request.priority,
                                  c[1].effective_prompt_len
                                  - c[1].prefill_pos, c[0]))
        alloc_failed = []
        if self.paged:
            ok = []
            for slot, st, start, take in cands:
                try:
                    if self.faults is not None:
                        self.faults.on_alloc(slot)
                    pool.ensure_range(slot, start, start + take)
                except (InjectedFault, RuntimeError):
                    alloc_failed.append(st)
                    continue
                ok.append((slot, st, start, take))
            cands = ok
            if not cands:
                return 0.0, None, None, [], 0, alloc_failed
        if self.prefill_cobatch:
            # padding is masked per row: a smaller chunk's numerics do not
            # change in a larger bucket
            items = cands
            bucket = max(prefill_bucket(take, self.chunk_len,
                                        self.min_bucket)
                         for *_, take in items)
        else:
            bucket = prefill_bucket(cands[0][3], self.chunk_len,
                                    self.min_bucket)
            items = [c for c in cands if prefill_bucket(
                c[3], self.chunk_len, self.min_bucket) == bucket]
        self.prefill_compile_keys.add(bucket)
        tok = np.zeros((self.n_slots, bucket), np.int32)
        start_v = np.ones((self.n_slots,), np.int32)   # >0: leave row alone
        valid_v = np.zeros((self.n_slots,), np.int32)  # 0: inactive row
        for slot, st, start, take in items:
            tok[slot, :take] = np.asarray(st.effective_tokens,
                                          np.int32)[start:start + take]
            start_v[slot] = start
            valid_v[slot] = take
        dev = self.device
        events = None
        if not sync and dev.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.perf_counter()
        inputs = tuple(host_to_device(a, dev) for a in (tok, start_v,
                                                         valid_v))
        if self.paged:
            inputs += (pool.block_tables_device(),)
        # nxt may be the graph's static output: the caller merges and emits
        # it before the next prefill step replays
        logits, pool.caches, nxt = self.prefill_chunk_step(params, pool.caches,
                                                           *inputs)
        flag = nonfinite_rows(logits)
        if sync:
            _sync(dev)           # the stall counters hold device time
        dt = time.perf_counter() - t0
        if events is not None:
            events[1].record()
        if self.prefix_cache:
            # index the blocks this chunk filled: a later matcher's chunks
            # are queued after these writes on the same stream
            for slot, st, start, take in items:
                pool.register_prefix(slot, start + take)
        finished = []
        for slot, st, start, take in items:
            st = sched.prefill_advance(slot, take, dt)
            if st.prefill_pos == st.effective_prompt_len:
                finished.append((slot, sched.finish_prefill(slot, None, now)))
        return ((dt if events is None else events), nxt, flag, finished,
                sum(c[3] for c in items), alloc_failed)

    def serve(self, params, requests: Sequence[Request], *,
              sync: bool = False, on_token=None,
              max_in_flight: int = 8) -> ServeSummary:
        """Drain ``requests`` (any arrival order) and return all results.

        The drain is pipelined by default, as in the reference: this thread
        schedules by token counts alone (every request runs exactly
        ``max_new_tokens`` steps), so it never needs a token value. Each
        step's token vector is copied without blocking into a pinned host
        set of a ring of ``max_in_flight + 1``, an event is recorded behind
        the copy, and the set goes on a queue of ``max_in_flight`` entries
        (a full queue is the backpressure). A consumer thread drains the
        queue greedily, waits once per wakeup on the newest event, fills
        each request's token list, stamps its TTFT at delivery and fires
        ``on_token(rid, idx, token)`` in order per request. ``sync=True``
        is the lockstep drain: every step's tokens are read back (and
        ``on_token`` fired) before the next step is dispatched. Both run
        the same device schedule and the same on-device argmax, so their
        tokens are bit-equal.

        :meth:`cancel`, :meth:`shutdown` and ``Request.timeout_steps`` take
        effect at tick granularity; cancelled and timed-out requests keep
        the tokens they had committed (``RequestResult.status`` says
        which). An exception from ``on_token``, or from the consumer's
        copies and events, cancels every remaining request; the drain
        delivers what is in flight, settles the pool's books and re-raises
        it. Nothing falls back to the lockstep drain.

        Faults: each step's non-finite flags travel with its tokens (in the
        same pinned set); a flagged request, or one an injected consumer
        error hit, is contained at the next tick boundary (its tokens cut at
        the first bad one, its pages quarantined when they may hold NaN,
        then a retry or ``failed``); a step that raises an ``InjectedFault``
        contains every row it would have run. An error raised by
        ``on_token`` itself is not contained: it cancels everything and
        re-raises, as above."""
        if max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1, got "
                             f"{max_in_flight}")
        _check_params(params, self.device)
        params = self._local_params(params)
        pool = self._make_pool(params)
        step_in, ring = self._staging(pool, 1 if sync else max_in_flight + 1)
        tok_in, pos_in = step_in[:2]
        with self._ctl_lock:
            self._cancel_pending.clear()
            self._shutdown_flag = False
        sched = Scheduler()
        for r in sorted(requests, key=lambda r: (r.arrival, r.rid)):
            sched.submit(r)
        retired = []
        cur_tok = torch.zeros((self.n_slots, 1), dtype=torch.int32,
                              device=self.device)
        now = n_steps = 0
        decode_s = host_blocked_s = drain_wait_s = 0.0
        t_first_decode = None
        n_readbacks = inflight_peak = 0
        readback_sizes = []
        peak_queue = peak_live = peak_blocks = peak_slots = 0
        prefill_chunks = prefill_tokens = decode_stall_steps = 0
        stall_run = max_stall_run = 0
        stall_run_times = []      # prefill chunk times since the last step
        stall_times = []          # per decode step: its chunks' times
        launches0 = _paged_kernel.launches
        mesh_launches0 = _paged_kernel.mesh_launches
        graphs0 = (_steps.graph_captures.copy(), _steps.graph_replays.copy())
        adaptive_swaps = []       # plan swaps applied in this drain
        # ---- fault containment's books ----
        inj = self.faults
        grail = self.guardrail
        faults_seen: dict = {}    # containment events by fault kind
        faults_contained = faults_failed = fault_retries = 0
        kernel_faults = 0         # step exceptions and hung steps
        degraded = False          # fused paged attention -> gather
        poison_watch: set = set()     # slots with an injected NaN in flight
        last_fault_error = None
        guardrail_swaps = []      # forced restores (a breach)

        def stall_p99() -> float:
            """p99 of the last 256 decode steps' prefill stall. Pipelined on
            the card each chunk's time is a pair of events, read here by
            waiting for its end, so it is read only when the controller
            can act on it."""
            if not stall_times or self.adaptive.stall_high_s == float("inf"):
                return 0.0
            srt = np.sort(np.asarray([sum(_seconds(t) for t in ts)
                                      for ts in stall_times[-256:]],
                                     np.float64))
            return float(srt[min(len(srt) - 1, int(0.99 * len(srt)))])

        def consult_adaptive():
            """Feed the controller this tick's counters and apply its swap;
            once per tick, at the step boundary before admission."""
            if self.paged:
                occ = pool.blocks_in_use / max(pool.n_blocks - 1, 1)
            else:
                occ = 1.0 - pool.n_free_slots / self.n_slots
            newplan = self.adaptive.observe(
                now, queue_depth=sched.queue_depth,
                blocked=sched.blocked_admissions, occupancy=occ,
                stall_p99=stall_p99())
            if newplan is not None:
                self._swap_plan(newplan)
                adaptive_swaps.append({"step": int(now),
                                       "level": self.adaptive.level,
                                       "tau": self.adaptive.tau})

        # ---- delivery, shared by both drains ----
        q: queue.Queue = queue.Queue(maxsize=max_in_flight)
        free: queue.Queue = queue.Queue()      # ring sets not in flight
        for k in range(len(ring)):
            free.put(k)
        consumer_err = []

        def deliver(arr, flags, deliveries):
            """Fill each (state, index, slot) placeholder from a host token
            vector, stamp the first token's index whose logits were
            non-finite, stamp TTFT at delivery, fire the callback."""
            t_now = time.perf_counter()
            for st, idx, slot in deliveries:
                tok = int(arr[slot])
                st.out_tokens[idx] = tok
                if flags[slot] and st.fault_idx is None:
                    # the producer contains the request at the next tick
                    # boundary; the tokens before idx stay
                    st.fault_idx = idx
                    st.fault_kind = "nonfinite_logits"
                if idx == 0:
                    st.ttft_s = t_now - st.wall_admitted
                if inj is not None:
                    try:
                        inj.on_deliver(st.request.rid, slot)
                    except InjectedFault:
                        # an injected consumer error is contained per
                        # request; an error of on_token itself is not
                        if st.fault_idx is None:
                            st.fault_idx = idx
                            st.fault_kind = "consumer_error"
                        continue
                suppressed = st.fault_idx is not None and idx >= st.fault_idx
                if on_token is not None and not consumer_err \
                        and not suppressed:
                    on_token(st.request.rid, idx, tok)

        def consume():
            nonlocal n_readbacks
            stop = False
            while not stop:
                item = q.get()
                if item is None:
                    return
                batch = [item]
                while True:            # greedy: one wait per wakeup
                    try:
                        more = q.get_nowait()
                    except queue.Empty:
                        break
                    if more is None:
                        stop = True
                        break
                    batch.append(more)
                try:
                    # the newest event covers every earlier copy: they
                    # were all queued before it on the same stream
                    ev = ring[batch[-1][0]].event
                    if ev is not None:
                        ev.synchronize()
                    arrs = [(ring[k].tok.numpy().copy(),
                             ring[k].flag.numpy().copy()) for k, _ in batch]
                finally:
                    for k, _ in batch:
                        free.put(k)
                n_readbacks += 1
                readback_sizes.append(len(batch))
                for (arr, flg), (_, dl) in zip(arrs, batch):
                    try:
                        deliver(arr, flg, dl)
                    except BaseException as e:  # noqa: BLE001
                        # keep draining so the producer never waits on a
                        # full queue; re-raised from serve after the join
                        consumer_err.append(e)

        def consume_guarded():
            try:
                consume()
            except BaseException as e:  # noqa: BLE001 — an event or copy
                consumer_err.append(e)
                while True:            # release the producer until the end
                    item = q.get()
                    if item is None:
                        return
                    free.put(item[0])

        def acquire() -> int:
            """A ring set no step in flight uses: the consumer releases a
            set once it has waited on an event at or after the set's own,
            and the set's event is waited on again here before the producer
            rewrites its buffers."""
            nonlocal host_blocked_s
            t0 = time.perf_counter()
            k = free.get()
            if ring[k].event is not None:
                ring[k].event.synchronize()
            host_blocked_s += time.perf_counter() - t0
            return k

        def emit(nxt, flag, deliveries, k=None):
            """Hand one step's (n_slots,) device tokens and non-finite flags
            to delivery through one pinned set: read back now (lockstep) or
            queued for the consumer (pipelined)."""
            nonlocal host_blocked_s, n_readbacks, inflight_peak
            if k is None:
                k = 0 if sync else acquire()
            h = ring[k]
            h.tok.copy_(nxt, non_blocking=True)
            h.flag.copy_(flag, non_blocking=True)
            if h.event is not None:
                h.event.record()
            t0 = time.perf_counter()
            if sync:
                if h.event is not None:
                    h.event.synchronize()      # waits for the step
                arr, flg = h.tok.numpy().copy(), h.flag.numpy().copy()
                host_blocked_s += time.perf_counter() - t0
                n_readbacks += 1
                readback_sizes.append(1)
                try:
                    deliver(arr, flg, deliveries)
                except BaseException as e:  # noqa: BLE001 — on_token
                    # the same shutdown as the pipelined drain: cancel,
                    # settle the books, re-raise after the drain
                    consumer_err.append(e)
                return
            q.put((k, deliveries))             # blocks at max_in_flight
            host_blocked_s += time.perf_counter() - t0
            inflight_peak = max(inflight_peak, q.qsize())

        def evict(st) -> bool:
            # the resumed request re-prefills its prompt and every token it
            # has, so each placeholder must hold its value first
            while any(t is None for t in st.out_tokens):
                if consumer_err:
                    return False               # shutting down
                time.sleep(2e-4)
            # freeing blocks while steps are still in flight is safe: a
            # block's next writer is a step dispatched after this, and the
            # device runs the stream's work in order
            pool.free_slot(st.slot)
            sched.preempt(st, now)
            return True

        # ---- fault containment ----
        def flush_placeholders(st) -> bool:
            """Wait for the consumer to land every token of ``st`` in
            flight (a retry resumes from the tokens so far). False when
            nothing more will land (shutting down)."""
            while any(t is None for t in st.out_tokens):
                if consumer_err or sync:
                    # the lockstep drain delivers inline: a placeholder
                    # left means its emit never ran
                    return False
                time.sleep(2e-4)
            return True

        def maybe_degrade():
            """Past ``kernel_fault_limit`` step faults, fall back from the
            fused paged-attention kernel to the gather path: other memoized
            (on the card: graphed) steps, selected between two steps."""
            nonlocal degraded
            if (not degraded and self.paged and self.paged_attn == "fused"
                    and kernel_faults >= self.kernel_fault_limit):
                degraded = True
                self.paged_attn = "gather"
                self.decode_step = self._step("paged_decode", "gather")

        def contain(st, kind=None, quarantine=None):
            """Contain one faulted request: settle its deliveries in flight,
            cut its tokens at the first bad one, quarantine its pages when
            they may hold NaN, and requeue it for a retry (prompt and the
            tokens kept re-prefill through the resume path) or retire it
            ``failed`` with the tokens it kept."""
            nonlocal faults_contained, faults_failed, fault_retries
            if st.status == WAITING:
                return              # already contained in this sweep
            kind = kind or st.fault_kind or "fault"
            if not flush_placeholders(st):
                return              # shutting down; apply_control retires
            was_done = st.status == DONE
            if was_done and st.result_status not in ("ok", "retried"):
                return              # cancelled or timed out: terminal
            faults_seen[kind] = faults_seen.get(kind, 0) + 1
            if st.fault_idx is not None:
                del st.out_tokens[st.fault_idx:]
            if quarantine is None:
                quarantine = kind in ("nonfinite_logits", "nan_page")
            if st.status in (PREFILLING, RUNNING):
                if st.slot in poison_watch:
                    # an injected NaN is in flight for this slot: whatever
                    # fault got here first, its pages may hold it
                    quarantine = True
                poison_watch.discard(st.slot)
                if self.paged and quarantine:
                    pool.quarantine_slot(st.slot)
                pool.free_slot(st.slot)
            retry = (st.n_retries < self.max_retries
                     and kind != "consumer_error")
            if retry:
                if was_done:
                    # the flag landed after the deadline retired it
                    retired.remove(st)
                sched.requeue_for_retry(st, now)
                fault_retries += 1
                faults_contained += 1
            else:
                faults_failed += 1
                st.fault_kind = kind
                if was_done:
                    st.result_status = "failed"
                else:
                    retired.append(sched.retire(st, now, "failed"))

        def apply_faults():
            """The producer's containment sweep at a tick boundary: every
            request the tripwire or an injected delivery fault stamped."""
            for st in [st for st in sched.states.values()
                       if st.fault_idx is not None and st.status != WAITING]:
                contain(st)

        def impossible(st):
            """Quarantine shrank the pool below this request's worst-case
            need: it retires ``failed`` instead of ending the drain."""
            nonlocal faults_failed
            faults_seen["impossible_request"] = (
                faults_seen.get("impossible_request", 0) + 1)
            faults_failed += 1
            sched.remove_waiting(st.request.rid)
            retired.append(sched.retire(st, now, "failed"))

        def cancel_live(st, status):
            if st.status == WAITING:
                sched.remove_waiting(st.request.rid)
            elif st.status in (PREFILLING, RUNNING):
                # as in evict: later writers of its blocks come after this
                pool.free_slot(st.slot)
            retired.append(sched.retire(st, now, status))

        def apply_control():
            with self._ctl_lock:
                todo = self._cancel_pending
                self._cancel_pending = set()
                shutdown = self._shutdown_flag
            # a callback error is a shutdown: schedule nothing new, deliver
            # what is in flight, re-raise after the drain
            shutdown = shutdown or bool(consumer_err)
            for st in list(sched.states.values()):
                t = st.request.timeout_steps
                if (st.status != DONE and t is not None
                        and now >= st.request.arrival + t):
                    cancel_live(st, "timeout")
            if shutdown:
                todo = set(sched.states)
            for rid in sorted(todo):
                st = sched.states.get(rid)
                if st is not None and st.status != DONE:
                    cancel_live(st, "cancelled")

        consumer = None
        if not sync:
            consumer = threading.Thread(target=consume_guarded,
                                        name="serve-consumer", daemon=True)
            consumer.start()
        evict = evict if self.preemption else None
        t_start = time.perf_counter()
        try:
            with torch.no_grad():
                while True:
                    if not sched.has_work():
                        # a flag still in flight can requeue a retry: land
                        # every delivery, sweep once more, then stop
                        for st in list(retired):
                            flush_placeholders(st)
                        apply_faults()
                        if not sched.has_work():
                            break
                    apply_control()
                    if not sched.has_work():
                        continue
                    if inj is not None:
                        inj.tick(now)
                    apply_faults()
                    if not sched.has_work():
                        continue
                    if self.adaptive is not None:
                        consult_adaptive()
                    self._admit(pool, sched, now, evict, impossible)
                    peak_queue = max(peak_queue, sched.queue_depth)
                    chunks = 0
                    while sched.prefilling and (not sched.running
                                                or chunks < self.chunk_budget):
                        was_decoding = bool(sched.running)
                        try:
                            if (inj is not None
                                    and inj.on_step("prefill") == "hung"):
                                kernel_faults += 1
                                maybe_degrade()
                            timing, nxt, flag, finished, n_tok, alloc_failed \
                                = self._prefill_tick(params, pool, sched,
                                                     now, sync)
                        except InjectedFault as e:
                            # raised before any cache write: contain every
                            # prefilling row (a retry prefills from scratch)
                            last_fault_error = e
                            kernel_faults += 1
                            maybe_degrade()
                            for st in list(sched.prefilling.values()):
                                contain(st, kind="step_exception",
                                        quarantine=False)
                            chunks += 1
                            continue
                        for st in alloc_failed:
                            contain(st, kind="alloc_failure",
                                    quarantine=False)
                        chunks += 1
                        if nxt is None:         # every allocation failed
                            continue
                        prefill_chunks += 1
                        prefill_tokens += n_tok
                        if was_decoding:
                            decode_stall_steps += 1
                            stall_run += 1
                            max_stall_run = max(max_stall_run, stall_run)
                            stall_run_times.append(timing)
                        if finished:
                            mask = np.zeros((self.n_slots,), bool)
                            for slot, _ in finished:
                                mask[slot] = True
                            cur_tok = merge_first_tokens(
                                cur_tok, nxt,
                                host_to_device(mask, self.device))
                            # a resumed request's placeholder is its last
                            # entry
                            emit(nxt, flag,
                                 [(st, len(st.out_tokens) - 1, slot)
                                  for slot, st in finished])
                            for slot, st in finished:
                                if st.done:          # max_new_tokens == 1
                                    retired.append(sched.retire(st, now))
                                    pool.free_slot(slot)
                        self._admit(pool, sched, now, evict, impossible)
                    if sched.running:
                        k = 0 if sync else acquire()
                        h = ring[k]
                        pos = h.pos.numpy()
                        pos[:] = 0
                        held = ()
                        if not self.paged:
                            # a dense row between two chunks of its prompt
                            # decodes garbage into its own ring: at the
                            # position its next chunk writes first; its SSM
                            # state (no table marks the row) is put back
                            for slot, st in sched.prefilling.items():
                                pos[slot] = st.prefill_pos
                            held = sorted(sched.prefilling)
                        alloc_bad = []
                        for slot, st in sched.running.items():
                            pos[slot] = st.next_pos
                            if self.paged:
                                try:
                                    if inj is not None:
                                        inj.on_alloc(slot)
                                    pool.ensure_block(slot, st.next_pos)
                                except (InjectedFault, RuntimeError) as e:
                                    last_fault_error = e
                                    alloc_bad.append(st)
                        for st in alloc_bad:
                            contain(st, kind="alloc_failure",
                                    quarantine=False)
                        if not sched.running:  # every allocation failed
                            if not sync:
                                free.put(k)
                            now += 1
                            continue
                        peak_live = max(peak_live, sum(
                            st.next_pos + 1 for st in sched.running.values()))
                        peak_slots = max(peak_slots, len(sched.running))
                        if self.paged:
                            peak_blocks = max(peak_blocks, pool.blocks_in_use)
                            # decode sees block tables only for running
                            # rows: a slot mid-prefill maps real (possibly
                            # shared) blocks, and the vacant-row garbage
                            # write must go to the trash block
                            bt = h.bt.numpy()
                            bt[:] = pool.block_tables
                            for s in range(self.n_slots):
                                if s not in sched.running:
                                    bt[s] = -1
                        # injected poisons: a NaN page before the step (its
                        # attention reads it), a NaN logit row after it
                        nan_rows = None
                        if inj is not None:
                            for spec in inj.take_poisons():
                                slots = sorted(sched.running)
                                slot = (spec.slot if spec.slot in sched.running
                                        else slots[0])
                                live = [int(b) for b in pool.block_tables[slot]
                                        if int(b) >= 1] if self.paged else []
                                if spec.kind == "nan_page" and self.paged:
                                    if live:
                                        pool.poison_block(
                                            live[min(spec.page,
                                                     len(live) - 1)])
                                        poison_watch.add(slot)
                                else:   # nan_logits (a dense nan_page too)
                                    if nan_rows is None:
                                        nan_rows = np.zeros((self.n_slots,),
                                                            bool)
                                    nan_rows[slot] = True
                                    poison_watch.add(slot)
                        try:
                            if (inj is not None
                                    and inj.on_step("decode") == "hung"):
                                kernel_faults += 1
                                maybe_degrade()
                        except InjectedFault as e:
                            # raised before dispatch: the caches are intact;
                            # contain every running row
                            last_fault_error = e
                            kernel_faults += 1
                            maybe_degrade()
                            for st in list(sched.running.values()):
                                contain(st, kind="step_exception",
                                        quarantine=False)
                            if not sync:
                                free.put(k)    # nothing was queued from it
                            now += 1
                            continue
                        t0 = time.perf_counter()
                        if t_first_decode is None:
                            t_first_decode = t0
                        # the set's buffers are pinned and no step in flight
                        # reads them (acquire), so the copies need not wait
                        # for the device; the graph's own input buffers are
                        # filled in stream order
                        tok_in.copy_(cur_tok)
                        pos_in.copy_(h.pos, non_blocking=True)
                        if self.paged:
                            step_in[2].copy_(h.bt, non_blocking=True)
                        shadow = None
                        if (grail is not None and self.mp
                                and grail.restored_at is None
                                and n_steps % grail.every == 0):
                            # the unquantized shadow over the same inputs,
                            # before the active step: that step rewrites
                            # every cache slot the shadow wrote before its
                            # attention reads one
                            rows = sorted(sched.running)
                            ref_step = self._step(
                                "paged_decode" if self.paged else "decode",
                                self.paged_attn if self.paged else None,
                                mp=None)
                            # the caches are written in place: the shadow
                            # must not advance the SSM state the active
                            # step advances
                            kept = [t.clone() for t in ssm_tensors(
                                pool.caches)]
                            s_logits, _, _ = ref_step(params, pool.caches,
                                                      *step_in)
                            for t, k0 in zip(ssm_tensors(pool.caches), kept):
                                t.copy_(k0)
                            shadow = (s_logits,
                                      rows[(n_steps // grail.every)
                                           % len(rows)])
                        ssm_held = ssm_tensors(pool.caches) if held else []
                        if ssm_held:
                            held_rows = host_to_device(
                                np.asarray(held, np.int64), self.device)
                            ssm_held = [(t, t[held_rows].clone())
                                        for t in ssm_held]
                        logits, pool.caches, nxt = self.decode_step(
                            params, pool.caches, *step_in)
                        for t, k0 in ssm_held:
                            t[held_rows] = k0
                        if shadow is not None:
                            # one blocking scalar read-back per check; a
                            # NaN MSE (a poison, not a quantization error)
                            # never breaches
                            mse = float(shadow_logit_mse(logits, *shadow))
                            budget = grail.budget_for(self._mp_plan)
                            if grail.observe_mse(now, mse, budget):
                                self._swap_plan(
                                    self.adaptive.force_restore(now)
                                    if self.adaptive is not None else None)
                                guardrail_swaps.append(
                                    {"step": int(now), "mse": mse,
                                     "budget": budget})
                        if nan_rows is not None and nan_rows.any():
                            logits = poison_logit_rows(
                                logits, host_to_device(nan_rows,
                                                       self.device))
                            nxt = greedy_next_token(logits)
                        # nxt may be the graph's static output: the copy
                        # emit queues now runs before the next replay
                        # overwrites it
                        cur_tok = nxt[:, None]
                        deliveries = []
                        for slot in list(sched.running):
                            st = sched.running[slot]
                            deliveries.append((st, len(st.out_tokens), slot))
                            sched.record_token(slot, None)
                        emit(nxt, nonfinite_rows(logits), deliveries, k)
                        decode_s += time.perf_counter() - t0
                        n_steps += 1
                        stall_times.append(stall_run_times)
                        stall_run_times, stall_run = [], 0
                        # a request is done after max_new_tokens steps;
                        # no token value is read to decide
                        for slot in list(sched.running):
                            st = sched.running[slot]
                            if st.done:
                                if slot in poison_watch:
                                    # an injected NaN hit this row: land its
                                    # flag before its pages are freed
                                    poison_watch.discard(slot)
                                    flush_placeholders(st)
                                    if st.fault_idx is not None:
                                        contain(st)
                                        continue
                                retired.append(sched.retire(st, now))
                                pool.free_slot(slot)
                        now += 1
                    elif not sched.prefilling:
                        # idle: jump the clock to the next arrival
                        nxt_arrival = sched.next_arrival()
                        if nxt_arrival is None:
                            break
                        now = max(now + 1, nxt_arrival)
        finally:
            if consumer is not None:
                # deliver everything emitted before returning; this wait
                # overlaps no work left to dispatch, so it is not counted
                # as blocked
                t0 = time.perf_counter()
                q.put(None)
                consumer.join()
                drain_wait_s = time.perf_counter() - t0
        t_end = time.perf_counter()
        total_s = t_end - t_start
        if consumer_err:
            # every request was cancelled and its slot freed; a delivery
            # that died half-way cannot have moved the pool, but settle its
            # books so the engine's next drain reuses it
            if self.paged:
                pool.reconcile()
            raise consumer_err[0]
        if not sync and t_first_decode is not None:
            # the producer timed dispatch only: report the wall span from
            # the first decode dispatch to the drain's end
            decode_s = max(decode_s, t_end - t_first_decode)
        stall_s = [sum(_seconds(t) for t in ts) for ts in stall_times]
        results = {st.request.rid: sched.materialize(st) for st in retired}
        n_decoded = sum(max(len(r.tokens) - 1, 0) for r in results.values())
        ttfts = sorted(r.ttft_s for r in results.values())
        statuses = [st.result_status for st in retired]
        captures = _steps.graph_captures - graphs0[0]
        replays = _steps.graph_replays - graphs0[1]
        layout = self.mesh_layout
        counters = {
            "paged": self.paged,
            "mesh": (None if layout is None else
                     {"data": layout.data, "model": layout.model,
                      "shard_pages": layout.shard_pages}),
            "sync": bool(sync),
            "n_decode_steps": n_steps,
            "kernel_launches": _paged_kernel.launches - launches0,
            # of them, launched on this rank's shard by the mesh branch
            "mesh_kernel_launches": (_paged_kernel.mesh_launches
                                     - mesh_launches0),
            # CUDA graph captures and replays of every step kind
            "graph_captures": sum(captures.values()),
            "graph_replays": sum(replays.values()),
            "graph_captures_by_kind": dict(captures),
            "graph_replays_by_kind": dict(replays),
            "ttft_p50_s": ttfts[len(ttfts) // 2] if ttfts else 0.0,
            # the same window in both drains (submission to drain end): the
            # fair comparison of the lockstep and pipelined drains
            "wall_tokens_per_s": n_decoded / total_s if total_s > 0 else 0.0,
            # time this thread sat blocked on token transfers on the decode
            # path (lockstep: every read-back; pipelined: a full queue or
            # ring), how read-backs batched, how far the device ran ahead
            "host_blocked_s": host_blocked_s,
            "host_blocked_s_per_step": host_blocked_s / max(n_steps, 1),
            "drain_wait_s": drain_wait_s,
            "n_readbacks": n_readbacks,
            "readback_batch_max": int(max(readback_sizes, default=0)),
            "readback_batch_mean": (float(np.mean(readback_sizes))
                                    if readback_sizes else 0.0),
            "steps_in_flight_peak": inflight_peak,
            "n_cancelled": sum(s in ("cancelled", "timeout")
                               for s in statuses),
            "n_failed": statuses.count("failed"),
            "n_retried": statuses.count("retried"),
            "peak_queue_depth": peak_queue,
            "blocked_admissions": sched.blocked_admissions,
            "peak_live_tokens": peak_live,
            "peak_slots_in_use": peak_slots,
            # what dense slots of max_len would pin, paged or not
            "dense_kv_bytes": self.n_slots * dense_slot_bytes(self.model,
                                                              self.max_len),
            "prefill_chunks": prefill_chunks,
            "prefill_tokens": prefill_tokens,
            "prefill_cobatch": self.prefill_cobatch,
            "prefill_buckets": len(self.prefill_compile_keys),
            "distinct_prompt_lens": len(self.prompt_lens_seen),
            "preemptions": sched.preemptions,
            "decode_stall_steps": decode_stall_steps,
            "max_decode_stall_run": max_stall_run,
        }
        counters["faults"] = {
            "injected": dict(inj.fired) if inj is not None else {},
            "seen": dict(faults_seen),
            "contained": faults_contained,
            "retries": fault_retries,
            "failed": faults_failed,
            "kernel_faults": kernel_faults,
            "degraded_paged_attn": degraded,
            "quarantined_blocks": (pool.quarantined_blocks
                                   if self.paged else 0),
            "last_error": (repr(last_fault_error)
                           if last_fault_error is not None else None),
        }
        if grail is not None:
            counters["guardrail"] = {
                "every": grail.every,
                "margin": grail.margin,
                "checks": grail.checks,
                "breaches": grail.breaches,
                "last_mse": grail.last_mse,
                "restored_at": grail.restored_at,
                "swaps": list(guardrail_swaps),
            }
        if self.adaptive is not None:
            counters["adaptive"] = {
                "taus": list(self.adaptive.taus),
                "final_level": self.adaptive.level,
                "final_tau": self.adaptive.tau,
                "downshifts": self.adaptive.downshifts,
                "restores": self.adaptive.restores,
                "swaps": list(adaptive_swaps),
            }
        if self.paged:
            blk_bytes = paged_block_bytes(self.model, pool.block_size)
            counters.update({
                "paged_attn": self.paged_attn,
                "block_size": pool.block_size,
                "n_blocks": pool.n_blocks,
                "peak_blocks_in_use": peak_blocks,
                "free_blocks_final": pool.n_free_blocks,
                "kv_bytes_per_block": blk_bytes,
                "peak_kv_bytes": (peak_blocks * blk_bytes + self.n_slots
                                  * paged_slot_bytes(self.model,
                                                     pool.block_size)),
                # tokens whose prefill was skipped because a resident chain
                # of blocks already held them
                "prefix_cache": self.prefix_cache,
                "prefix_hit_requests": pool.prefix_hit_requests,
                "prefix_hit_blocks": pool.prefix_hit_blocks,
                "prefix_hit_tokens": pool.prefix_hit_tokens,
                "cow_forks": pool.cow_forks,
                "cached_blocks_final": pool.n_cached_blocks,
                "reclaimed_cached_blocks": pool.reclaimed_cached_blocks,
            })
        else:
            counters["peak_kv_bytes"] = counters["dense_kv_bytes"]
        if stall_s:
            arr = np.sort(np.asarray(stall_s, np.float64))
            counters["decode_stall_p50_s"] = float(arr[len(arr) // 2])
            counters["decode_stall_p99_s"] = float(
                arr[min(len(arr) - 1, int(0.99 * len(arr)))])
        return ServeSummary(
            results=results, n_steps=n_steps, decode_s=decode_s,
            total_s=total_s,
            tokens_per_s=n_decoded / decode_s if decode_s > 0 else 0.0,
            counters=counters)
