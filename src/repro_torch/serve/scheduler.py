"""Continuous-batching request scheduler (priority admission + preemption).

The port's own copy of ``repro/serve/scheduler.py`` (NumPy-only, unchanged
in behaviour: the same request streams give the same admission order and
the same preemption victims). The port's engine drives preemption; it does
not drive fault retries yet, whose support stays so the two copies do not
drift.

The scheduler is pure host-side bookkeeping: it owns the waiting queue and
the per-request prefill/decode state, and decides *which* request may enter
a cache slot at a given engine clock tick. All device work (prefill chunks,
batched decode) stays in the engine, so scheduling policy can evolve —
priority classes, preemption — without touching compiled code.

Admission order is by priority class (higher first), then earliest arrival,
then submission order — at uniform priority this degenerates to exactly the
old FCFS queue. The resource gate still applies only to the *best* arrived
candidate (no skip-ahead: a gated head blocks the queue and is counted in
``blocked_admissions``), which keeps backpressure semantics deterministic.
On top of that, the engine may **preempt**: when the best waiting request
outranks a live one and the gate is blocking, :meth:`preempt_candidate`
names the victim (lowest priority, then latest admitted, then highest
slot), and :meth:`preempt` re-queues it with ``resume_tokens`` = prompt +
every token generated so far. Re-prefilling that effective prompt replays
the victim's state bit-exactly (per-token quant scales make K/V a pure
function of the prefix), and with prefix caching on, its blocks are still
resident, so the resume costs one tail chunk.

Admission emits *prefill work items* rather than running prefill inline: a
popped request parks in ``prefilling`` (slot -> state) with a
``prefill_pos`` cursor, the engine advances it chunk by chunk
(``prefill_advance``), and the final chunk's greedy token promotes it to
``running`` (``finish_prefill``). The engine's step loop arbitrates chunk
steps against decode steps under a TTFT-aware budget, so a long prompt
never head-of-line-blocks in-flight decodes.

The clock is abstract: the engine advances it once per decode step, and a
request becomes admissible when ``arrival <= now``. Driving admission off a
deterministic step clock (instead of wall time) is what makes "a late request
arrives mid-decode" reproducible in tests.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Optional

import numpy as np

__all__ = ["Request", "RequestState", "RequestResult", "Scheduler"]

WAITING = "waiting"
PREFILLING = "prefilling"
RUNNING = "running"
DONE = "done"


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival`` is in engine clock ticks
    (decode steps); 0 means present from the start. ``timeout_steps``, if
    set, cancels the request (status ``"timeout"``) once the engine clock
    reaches ``arrival + timeout_steps`` before it finishes — step-based so
    timeout behavior is deterministic in tests. ``priority`` is the
    admission/preemption class: higher admits first, and only a strictly
    higher-priority waiter may evict a live request."""
    rid: int
    tokens: np.ndarray                # (T,) int32 prompt
    max_new_tokens: int
    arrival: int = 0
    timeout_steps: Optional[int] = None
    priority: int = 0

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.tokens).shape[0])


@dataclasses.dataclass(eq=False)     # identity equality: queue removal must
class RequestState:                  # never field-compare numpy token arrays
    request: Request
    status: str = WAITING
    slot: int = -1
    next_pos: int = 0                 # cache position of the next decode write
    prefill_pos: int = 0              # prompt tokens already prefilled
    wall_admitted: float = 0.0        # engine-set perf_counter at admission
    last_token: int = 0
    out_tokens: list = dataclasses.field(default_factory=list)
    ttft_s: float = 0.0
    admitted_step: int = -1
    first_token_step: int = -1        # engine clock when token 0 landed
    finished_step: int = -1
    # "ok" | "cancelled" | "timeout" | "retried" (completed after >= 1
    # fault retry) | "failed" (retry budget exhausted; tokens are the
    # last-known-good prefix)
    result_status: str = "ok"
    # preemption/resume: after an eviction the request re-prefills prompt +
    # everything it had generated (its *effective* prompt) and keeps
    # decoding where it left off
    resume_tokens: Optional[np.ndarray] = None
    n_preempted: int = 0
    digests: Optional[list] = None    # engine-cached prefix chain digests
    # fault containment: the consumer's tripwire stamps the index of the
    # first token produced from non-finite logits (tokens before it are
    # good); the engine truncates there and retries via resume. fault_kind
    # labels the cause for the counters.
    fault_idx: Optional[int] = None
    fault_kind: Optional[str] = None
    n_retries: int = 0
    _seq: int = -1                    # submission order (queue tiebreak)

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.request.max_new_tokens

    @property
    def effective_tokens(self) -> np.ndarray:
        """What prefill must process: the original prompt, or — after a
        preemption — prompt + all generated tokens."""
        return (self.request.tokens if self.resume_tokens is None
                else self.resume_tokens)

    @property
    def effective_prompt_len(self) -> int:
        return int(np.asarray(self.effective_tokens).shape[0])

    @property
    def remaining_new_tokens(self) -> int:
        """Decode steps still owed. The resumed prefill's final chunk
        produces the next token, so ``effective_prompt_len +
        remaining_new_tokens - 1`` never exceeds ``prompt_len +
        max_new_tokens - 1`` — the block budget is preemption-invariant."""
        return max(self.request.max_new_tokens - len(self.out_tokens), 0)


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: np.ndarray                # (<= max_new_tokens,) greedy continuation
    ttft_s: float
    admitted_step: int
    finished_step: int
    # "ok" | "cancelled" | "timeout" | "retried" | "failed" — "retried"
    # means the request completed (all max_new_tokens, bit-identical to a
    # fault-free run) after >= 1 fault-containment retry; "failed" means
    # the retry budget ran out and ``tokens`` holds the last-known-good
    # prefix produced before the fault
    status: str = "ok"
    # engine clock tick at which the first token was produced; with arrival
    # this gives a deterministic step-clock TTFT (first_token_step -
    # arrival), the unit the adaptive-tau SLA benchmarks price
    first_token_step: int = -1
    retries: int = 0                  # fault-containment retries consumed


class Scheduler:
    def __init__(self):
        self._queue: list = []                 # WAITING states, priority order
        self._next_seq = 0
        self.prefilling: dict = {}             # slot -> RequestState
        self.running: dict = {}                # slot -> RequestState
        self.states: dict = {}                 # rid -> RequestState
        # backpressure signal: times the arrived queue head was held back by
        # the engine's resource gate (e.g. not enough free KV blocks)
        self.blocked_admissions = 0
        self.preemptions = 0

    @staticmethod
    def _qkey(st: RequestState):
        return (-st.request.priority, st.request.arrival, st._seq)

    def _enqueue(self, st: RequestState) -> None:
        bisect.insort(self._queue, st, key=self._qkey)

    def submit(self, req: Request) -> RequestState:
        assert req.rid not in self.states, f"duplicate rid {req.rid}"
        st = RequestState(req)
        st._seq = self._next_seq
        self._next_seq += 1
        self.states[req.rid] = st
        self._enqueue(st)
        return st

    # ---- admission ----
    def has_work(self) -> bool:
        return (bool(self._queue) or bool(self.prefilling)
                or bool(self.running))

    def next_arrival(self) -> Optional[int]:
        """Earliest arrival among waiting requests (None if queue empty)."""
        return min((st.request.arrival for st in self._queue), default=None)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def _best_arrived(self, now: int) -> Optional[RequestState]:
        for st in self._queue:
            if st.request.arrival <= now:
                return st
        return None

    def peek_admissible(self, now: int) -> Optional[RequestState]:
        """The request :meth:`pop_admissible` would consider at ``now``
        (highest priority among arrived, FCFS within a class), without
        popping or gating it — the engine's preemption decision looks at
        this to ask whether the best waiter outranks a live slot."""
        return self._best_arrived(now)

    def pop_admissible(self, now: int, can_admit=None) -> Optional[RequestState]:
        """The best arrived request — priority class first, FCFS within a
        class — iff the resource gate accepts it. ``can_admit(request) ->
        bool`` is the engine's admission predicate (e.g. enough free KV
        blocks); a gated best candidate blocks the whole queue — no
        skip-ahead — and that head-of-line wait is counted in
        ``blocked_admissions``. At uniform priority this is exactly the old
        FCFS pop."""
        st = self._best_arrived(now)
        if st is not None:
            if can_admit is None or can_admit(st.request):
                self._queue.remove(st)
                return st
            self.blocked_admissions += 1
        return None

    # ---- preemption ----
    def preempt_candidate(self, min_priority: int) -> Optional[RequestState]:
        """The live (prefilling or running) request a strictly
        higher-priority waiter should evict: lowest priority first, then
        latest admitted, then highest slot — the cheapest progress to
        throw away, and deterministic. None when every live request has
        ``priority >= min_priority`` (equal priority never preempts, so
        two classes can't thrash each other)."""
        live = list(self.prefilling.values()) + list(self.running.values())
        live = [st for st in live if st.request.priority < min_priority]
        if not live:
            return None
        return max(live, key=lambda st: (-st.request.priority,
                                         st.admitted_step, st.slot))

    def preempt(self, st: RequestState, now: int) -> RequestState:
        """Evict a live request back to the waiting queue. Its effective
        prompt becomes prompt + every token generated so far (all token
        values must have landed — the engine flushes in-flight deliveries
        first), so the resumed prefill replays its state bit-exactly and
        its final chunk produces the *next* token via the normal
        finish-prefill path."""
        assert st.status in (PREFILLING, RUNNING), st.status
        if self.prefilling.get(st.slot) is st:
            del self.prefilling[st.slot]
        if self.running.get(st.slot) is st:
            del self.running[st.slot]
        assert all(t is not None for t in st.out_tokens), (
            f"rid {st.request.rid}: preempted with undelivered tokens")
        st.resume_tokens = np.concatenate([
            np.asarray(st.request.tokens, np.int32),
            np.asarray(st.out_tokens, np.int32)])
        st.digests = None                 # effective prompt changed
        st.status = WAITING
        st.slot = -1
        st.prefill_pos = 0
        st.n_preempted += 1
        self.preemptions += 1
        self._enqueue(st)                 # original seq: FCFS slot preserved
        return st

    # ---- fault containment ----
    def requeue_for_retry(self, st: RequestState, now: int) -> RequestState:
        """Bounded-retry resume after fault containment: like
        :meth:`preempt`, but the engine has already waited out in-flight
        deliveries, truncated the poisoned token tail (``fault_idx``) and
        released the slot — all that remains here is rebuilding the
        effective prompt from the surviving last-known-good prefix and
        re-queueing. Because resume is bit-exact, a retried request that
        completes is bit-identical to a fault-free run."""
        assert st.status != WAITING, st.status
        if self.prefilling.get(st.slot) is st:
            del self.prefilling[st.slot]
        if self.running.get(st.slot) is st:
            del self.running[st.slot]
        assert all(t is not None for t in st.out_tokens), (
            f"rid {st.request.rid}: retried with undelivered tokens")
        st.resume_tokens = np.concatenate([
            np.asarray(st.request.tokens, np.int32),
            np.asarray(st.out_tokens, np.int32)]) if st.out_tokens else None
        st.digests = None
        st.status = WAITING
        st.slot = -1
        st.prefill_pos = 0
        if not st.out_tokens:             # first token itself was poisoned
            st.first_token_step = -1
        st.fault_idx = None
        st.fault_kind = None
        st.n_retries += 1
        self._enqueue(st)
        return st

    # ---- chunked prefill lifecycle ----
    def start_prefill(self, st: RequestState, slot: int, now: int,
                      start_at: int = 0) -> None:
        """Claim ``slot`` for a request whose (effective) prompt will be
        prefilled in one or more chunk steps; the engine's step loop drives
        the chunks. ``start_at`` > 0 skips a cached prefix — those tokens'
        KV blocks are already mapped into the slot's table."""
        st.status = PREFILLING
        st.slot = slot
        st.prefill_pos = start_at
        if not st.out_tokens:             # a resumed request keeps its TTFT
            st.ttft_s = 0.0
        if st.admitted_step < 0:          # first admission only
            st.admitted_step = now
        self.prefilling[slot] = st

    def prefill_advance(self, slot: int, n_tokens: int,
                        dt_s: float) -> RequestState:
        """Record one completed chunk (``n_tokens`` prompt tokens) and fold
        its wall time into the request's TTFT. The engine overwrites
        ``ttft_s`` with the admission-to-first-token wall time when the
        final chunk lands (which also counts the decode steps interleaved
        between chunks); the chunk-dt sum here is the fallback for
        host-only scheduler use."""
        st = self.prefilling[slot]
        st.prefill_pos += n_tokens
        assert st.prefill_pos <= st.effective_prompt_len, (
            st.prefill_pos, st.effective_prompt_len)
        st.ttft_s += dt_s
        return st

    def finish_prefill(self, slot: int, first_token: int,
                       now: int) -> RequestState:
        """The final chunk produced the next greedy token: move to decode.
        For a fresh request that token is the first; for a resumed one it
        continues wherever the eviction cut off."""
        st = self.prefilling.pop(slot)
        st.status = RUNNING
        st.last_token = first_token
        st.out_tokens.append(first_token)
        if st.first_token_step < 0:   # a resumed request keeps its stamp
            st.first_token_step = now
        st.next_pos = st.effective_prompt_len
        self.running[slot] = st
        return st

    # ---- decode bookkeeping ----
    def record_token(self, slot: int, token: int) -> RequestState:
        st = self.running[slot]
        st.out_tokens.append(token)
        st.last_token = token
        st.next_pos += 1
        return st

    # ---- retirement ----
    def retire(self, st: RequestState, now: int,
               status: str = "ok") -> RequestState:
        """Drop ``st`` from the live sets and stamp its outcome, without
        materializing the result array. The async engine retires requests
        the moment their *step schedule* completes (token values may still
        be in flight to the host); :meth:`materialize` builds the
        ``RequestResult`` once every delivered value has landed."""
        if st.slot in self.running and self.running.get(st.slot) is st:
            del self.running[st.slot]
        if st.slot in self.prefilling and self.prefilling.get(st.slot) is st:
            del self.prefilling[st.slot]
        st.status = DONE
        st.finished_step = now
        if status == "ok" and st.n_retries > 0:
            status = "retried"    # completed, but only after containment
        st.result_status = status
        return st

    @staticmethod
    def materialize(st: RequestState) -> RequestResult:
        """Build the result record from a retired state. All token slots the
        request committed must be filled by now (no ``None`` placeholders)."""
        toks = st.out_tokens[:st.request.max_new_tokens]
        assert all(t is not None for t in toks), (
            f"rid {st.request.rid}: undelivered token placeholders at "
            f"materialize time (consumer did not drain?)")
        return RequestResult(
            rid=st.request.rid,
            tokens=np.asarray(toks, np.int32),
            ttft_s=st.ttft_s,
            admitted_step=st.admitted_step,
            finished_step=st.finished_step,
            status=st.result_status,
            first_token_step=st.first_token_step,
            retries=st.n_retries,
        )

    def finish(self, st: RequestState, now: int) -> RequestResult:
        return self.materialize(self.retire(st, now))

    # ---- cancellation ----
    def remove_waiting(self, rid: int) -> Optional[RequestState]:
        """Drop a still-queued request (cancellation before admission)."""
        for i, st in enumerate(self._queue):
            if st.request.rid == rid:
                del self._queue[i]
                return st
        return None
