"""Serving step builders (port of the serving half of
``repro/launch/steps.py``).

A step is a closure over the model and one ``QuantContext`` that returns
``(logits, caches, next_token)``; ``next_token`` is the (B,) int32 greedy
token of :func:`greedy_next_token`, computed inside the step so that on the
card it is part of the step's graph. :func:`get_serving_step` memoizes the
steps per (model, kind, MP assignment, paged_attn) so every engine over one
model shares them, as the reference memoizes its ``jax.jit`` of each. The
reference compiles every step once per input shape; on CUDA the port
captures every step as a CUDA graph once per input shape and replays it
(:class:`GraphedStep`).
"""
from __future__ import annotations

import importlib
import threading
from collections import Counter
from typing import Optional

import torch

from repro_torch.core.mpconfig import as_assignment
from repro_torch.quant.qops import QuantContext

__all__ = ["make_forward_step", "GraphedForward", "make_prefill_step",
           "make_bucketed_prefill_step", "make_chunked_prefill_step",
           "make_dense_chunked_prefill_step", "make_decode_step",
           "make_paged_decode_step", "GraphedStep", "get_serving_step",
           "greedy_next_token", "merge_first_tokens", "nonfinite_rows",
           "shadow_logit_mse", "graph_captures", "graph_replays"]

# CUDA graph captures and replays of serving steps in this process, by step
# kind (``GraphedStep.kind``)
graph_captures: Counter = Counter()
graph_replays: Counter = Counter()


def _serving_ctx(mp) -> QuantContext:
    """One QuantContext policy for every serving step: per-*token* activation
    scales, so greedy tokens depend neither on which requests share the
    batch nor on how a prompt is padded into a bucket."""
    mp = as_assignment(mp)
    return (QuantContext(mode="mp", mp=mp, act_scale_token=True) if mp
            else QuantContext())


def _with_next(logits: torch.Tensor, caches: dict) -> tuple:
    return logits, caches, greedy_next_token(logits)


def make_forward_step(model, ctx: QuantContext):
    """(params, caches, tokens) -> (logits (B, T, V), caches, None): the
    full forward ``model.apply`` under ``ctx`` as a step (``caches`` passes
    through untouched; no greedy token)."""
    def forward_step(params, caches, tokens):
        with torch.no_grad():
            return model.apply(params, tokens, ctx), caches, None
    return forward_step


class GraphedForward:
    """``(params, tokens) -> logits``: the port's counterpart of the
    reference's ``jax.jit(lambda p, t: model.apply(p, t, ctx))``, which
    the measured tier times (``benchmarks/fig3_validation.py``). On CUDA a
    :class:`GraphedStep` over :func:`make_forward_step`: one graph per
    input shape, whose first call runs the forward eagerly on a side stream
    (filling the weight cache) and captures it, later calls replay it and
    add the launches the capture recorded to the kernels' counters; a
    failed capture raises. On the CPU it runs eagerly. The logits are the
    graph's static output, overwritten by the next replay. ``release()``
    drops the graphs and the memory of the activations they hold (to
    ``shared_pool``'s free blocks, when it was given and lives on)."""

    def __init__(self, model, ctx: QuantContext, shared_pool=None):
        self.step = GraphedStep(make_forward_step(model, ctx), "forward",
                                max_captures=1, shared_pool=shared_pool)
        self._caches: dict = {}

    def __call__(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return self.step(params, self._caches, tokens)[0]

    def release(self) -> None:
        self.step.release()


def make_prefill_step(model, mp: Optional[dict] = None):
    """(params, caches, tokens) -> (last-token logits, caches, next_token)."""
    ctx = _serving_ctx(mp)

    def prefill_step(params, caches, tokens):
        return _with_next(*model.prefill(params, tokens, caches, ctx))
    return prefill_step


def make_bucketed_prefill_step(model, mp: Optional[dict] = None):
    """(params, caches, tokens, start, valid) -> (last-valid logits, caches,
    next_token) over dense rings; ``tokens`` (B, Lb) padded to a
    power-of-two bucket, ``start`` 0 for the rows being prefilled."""
    ctx = _serving_ctx(mp)

    def prefill_step(params, caches, tokens, start, valid):
        return _with_next(*model.prefill_chunk(
            params, tokens, caches, ctx, start_pos=start, valid_len=valid))
    return prefill_step


def make_chunked_prefill_step(model, mp: Optional[dict] = None):
    """(params, caches, tokens, start, valid, block_tables) -> (logits,
    caches, next_token): the paged twin — the chunk's K/V goes straight
    into the pool's blocks."""
    ctx = _serving_ctx(mp)

    def prefill_step(params, caches, tokens, start, valid, block_tables):
        return _with_next(*model.prefill_chunk(
            params, tokens, caches, ctx, start_pos=start, valid_len=valid,
            block_tables=block_tables))
    return prefill_step


def make_dense_chunked_prefill_step(model, mp: Optional[dict] = None):
    """(params, caches, tokens, start, valid) -> (logits, caches,
    next_token): chunked prefill over dense rings. As the bucketed step,
    but ``start`` may be past 0: a later chunk of a long prompt resumes
    where the last one stopped and attends over the earlier chunks through
    the slot's own ring. Windowed layers need their rings widened by the
    chunk length (``init_cache(..., chunk_extra=chunk_len)``)."""
    ctx = _serving_ctx(mp)

    def prefill_step(params, caches, tokens, start, valid):
        return _with_next(*model.prefill_chunk(
            params, tokens, caches, ctx, start_pos=start, valid_len=valid,
            chunk_ring=True))
    return prefill_step


def make_decode_step(model, mp: Optional[dict] = None):
    """(params, caches, token, pos) -> (logits, caches, next_token) over
    dense rings; ``pos`` a 0-d tensor for a lock-step batch or (B,)
    per-row positions (continuous batching)."""
    ctx = _serving_ctx(mp)

    def decode_step(params, caches, token, pos):
        return _with_next(*model.decode_step(params, token, pos, caches, ctx))
    return decode_step


def make_paged_decode_step(model, mp: Optional[dict] = None,
                           paged_attn: str = "fused"):
    """(params, caches, token, pos, block_tables) -> (logits, caches,
    next_token). ``paged_attn="fused"`` attends block-major K/V in place
    through the CUDA kernel; ``"gather"`` keeps the reference path. Layers
    whose attention BGEMMs carry an MP format always gather."""
    ctx = _serving_ctx(mp)

    def decode_step(params, caches, token, pos, block_tables):
        return _with_next(*model.decode_step(
            params, token, pos, caches, ctx, block_tables=block_tables,
            paged_attn=paged_attn))
    return decode_step


# every kernel launch counter of the port: (module, attribute)
_COUNTERS = (("paged_attention", "launches"),
             ("paged_attention", "launches_by_route"),
             ("quant_cast", "launches"), ("fp8_matmul", "launches"),
             ("mp_attention", "launches"))


def _read_counters() -> dict:
    out = {}
    for mod, attr in _COUNTERS:
        val = getattr(importlib.import_module(f"repro_torch.kernels.{mod}"),
                      attr)
        if isinstance(val, dict):
            out.update({(mod, attr, k): n for k, n in val.items()})
        else:
            out[(mod, attr, None)] = val
    return out


def _add_counters(delta: dict, times: int = 1) -> None:
    for (mod, attr, k), n in delta.items():
        if not n:
            continue
        m = importlib.import_module(f"repro_torch.kernels.{mod}")
        if k is None:
            setattr(m, attr, getattr(m, attr) + n * times)
        else:
            getattr(m, attr)[k] += n * times


def _edges(tree: dict, out: list) -> list:
    """Every (dict, key, value) edge of a nested dict, parents first."""
    for k, v in tree.items():
        out.append((tree, k, v))
        if isinstance(v, dict):
            _edges(v, out)
    return out


class _Captured:
    """One capture: the graph, what it is bound to, its static inputs and
    outputs, the launches one replay makes, and the cached weight operands
    it reads (a graph holds addresses, not tensors)."""

    def __init__(self, graph, params, caches, inputs, logits, next_token,
                 launches, held):
        self.graph = graph
        self.edges = _edges(params, _edges(caches, []))
        # the replay reads a changed weight itself, but not a changed
        # weight's quantized operand, which it captured: those weights'
        # in-place versions bind the graph too
        self.quantized = [(w, w._version) for w, _ in held]
        self.held = held
        self.inputs = inputs
        self.logits = logits
        self.next_token = next_token
        self.launches = launches

    def bound(self) -> bool:
        for parent, k, v in self.edges:
            if parent.get(k) is not v:
                return False
        return all(w._version == v for w, v in self.quantized)


class GraphedStep:
    """A serving step, ``(params, caches, *inputs) -> (logits, caches,
    next_token)`` (``next_token`` None for :func:`make_forward_step`).

    On the CPU it runs eagerly, as the caller asked for the CPU. On CUDA it
    is the port's counterpart of the reference's memoized ``jax.jit``,
    which compiles once per input shape: it keeps a table of CUDA graphs
    keyed by the inputs' shapes, dtypes and devices (a prefill bucket, a
    decode batch). The first call of a key runs the step once on a side
    stream (the warm-up, whose outputs it returns; it also fills the
    weight cache), then captures it; later calls of that key replay the
    graph. Every graph is bound to the params' and caches' nested dicts
    and tensors (identity) and to the in-place version of every weight
    whose quantized operand it reads from the weight cache: other params
    or caches drop the whole table, a changed weight the graph that read
    it, so a graph is never replayed over other tensors or a stale
    quantized weight. ``max_captures`` bounds the table (the per-length
    one-shot prefill keeps one graph: a long prompt's graph holds
    gigabytes); the captures of one step share one memory pool, which
    ``shared_pool`` (another step's ``pool()``) makes that step's: a
    series of graphs built and released one after another then reuses one
    pool's blocks instead of allocating its own.

    A capture reads its inputs from the tensors of the call it was made in
    (a view, of another graph's output say, is copied into a buffer of its
    own first): these are its static inputs, and a later call that passes
    other tensors has them copied in, in stream order. Logits and greedy
    token come out in static outputs, which the next replay of the same
    graph overwrites: a caller that keeps them clones them, or copies them
    in stream order before the next call.

    A capture that fails raises; on CUDA nothing falls back to eager. The
    capture records launches without making them, so it adds nothing to
    the kernels' launch counters, and each replay adds the launches it
    recorded. ``graph_captures`` / ``graph_replays`` (module level, by
    ``kind``) and ``captures`` / ``replays`` (this step) count them."""

    def __init__(self, fn, kind: str = "step",
                 max_captures: Optional[int] = None, shared_pool=None):
        self.fn = fn
        self.kind = kind
        self.max_captures = max_captures
        self.shared_pool = shared_pool   # another graph's pool, or None
        self._table: dict = {}           # input signature -> _Captured
        self._roots = None               # (params, caches) of the table
        self.captures = 0
        self.replays = 0

    def release(self) -> None:
        """Drop every graph (and so the memory pool they share)."""
        self._table.clear()
        self._roots = None

    def pool(self):
        """The memory pool this step's graphs share (None before its first
        capture, and on the CPU)."""
        if not self._table:
            return None
        return next(iter(self._table.values())).graph.pool()

    def recorded(self) -> Counter:
        """Kernel launches one replay of every kept graph adds, summed, by
        kernel: ``amax`` and ``scale_cast`` (``quant_cast``),
        ``fp8_matmul``, ``mp_attention`` and ``paged_attention``."""
        out: Counter = Counter()
        for cap in self._table.values():
            for (mod, attr, k), n in cap.launches.items():
                if attr == "launches":
                    out[k if k is not None else mod] += n
        return out

    def __call__(self, params, caches, *inputs):
        if not self._on_card(inputs):
            return self.fn(params, caches, *inputs)
        roots = self._roots
        if roots is None or params is not roots[0] or caches is not roots[1]:
            self.release()
            self._roots = (params, caches)
        key = tuple((tuple(t.shape), t.dtype, t.device) for t in inputs)
        cap = self._table.get(key)
        if cap is None or not cap.bound():
            self._table.pop(key, None)
            return self._capture(params, caches, key, inputs)
        for a, b in zip(inputs, cap.inputs):
            if a is not b:
                b.copy_(a, non_blocking=True)
        cap.graph.replay()
        self.replays += 1
        graph_replays[self.kind] += 1
        _add_counters(cap.launches)
        return cap.logits, caches, cap.next_token

    @staticmethod
    def _on_card(inputs) -> bool:
        return inputs[0].device.type == "cuda"

    def _warm_up(self, params, caches, inputs) -> tuple:
        """The step run eagerly on a side stream, ordered after the work
        queued before it and before the work queued after it."""
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            logits, caches, nxt = self.fn(params, caches, *inputs)
        main.wait_stream(side)
        for t in (logits, nxt):
            if t is not None:
                t.record_stream(main)
        return logits, caches, nxt

    def _record(self, params, caches, static, pool) -> tuple:
        """(graph, static logits, static next token) of the step captured
        over the ``static`` inputs, in ``pool`` (None: a new pool)."""
        graph = torch.cuda.CUDAGraph()
        # thread-local: the pipelined drain's consumer thread waits on
        # events and reads pinned memory while this thread captures; in the
        # global mode those calls from any thread invalidate the capture.
        # This thread's own unsafe calls still fail it
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            s_logits, _, s_next = self.fn(params, caches, *static)
        return graph, s_logits, s_next

    def _capture(self, params, caches, key, inputs):
        from repro_torch.quant import weight_cache
        if (self.max_captures is not None
                and len(self._table) >= self.max_captures):
            roots = self._roots
            self.release()               # its graphs' memory goes first
            self._roots = roots
        pool = self.pool() or self.shared_pool
        static = tuple(t if t._base is None else t.clone() for t in inputs)
        logits, caches, nxt = self._warm_up(params, caches, inputs)
        before = _read_counters()
        try:
            with weight_cache.holding() as held:
                graph, s_logits, s_next = self._record(params, caches,
                                                       static, pool)
        except Exception as e:
            raise RuntimeError(
                f"{self.kind} step: CUDA graph capture failed (on CUDA the "
                f"step does not run eagerly instead)") from e
        finally:
            after = _read_counters()
            delta = {k: after[k] - before.get(k, 0) for k in after}
            _add_counters(delta, times=-1)   # the capture launched nothing
        self._table[key] = _Captured(graph, params, caches, static, s_logits,
                                     s_next, delta, held)
        self.captures += 1
        graph_captures[self.kind] += 1
        return logits, caches, nxt


_BUILDERS = {
    "prefill": make_prefill_step,
    "bucketed_prefill": make_bucketed_prefill_step,
    "chunked_prefill": make_chunked_prefill_step,
    "dense_chunked_prefill": make_dense_chunked_prefill_step,
    "decode": make_decode_step,
    "paged_decode": make_paged_decode_step,
}

# {(kind, mp key, paged_attn): step}, kept on the model itself: a step's
# closure holds the model, so a table keyed weakly on the model would keep
# every model (and its graphs, with the params they are bound to) alive; on
# the model, the cycle goes with it
_STEPS_ATTR = "_serving_steps"
_SERVING_STEPS_LOCK = threading.Lock()


def _mp_cache_key(mp):
    mp = as_assignment(mp)
    return None if mp is None else tuple(sorted(mp.items()))


def get_serving_step(model, kind: str, mp=None,
                     paged_attn: Optional[str] = None) -> GraphedStep:
    """Memoized serving step for ``model``. ``kind`` is one of
    ``prefill`` / ``bucketed_prefill`` / ``chunked_prefill`` /
    ``dense_chunked_prefill`` / ``decode`` / ``paged_decode``; ``mp`` an
    assignment dict or an ``MPPlan``. Every kind is a :class:`GraphedStep`
    (one graph per input shape on CUDA; ``prefill``, the per-length
    one-shot step, keeps one at a time)."""
    if kind not in _BUILDERS:
        raise ValueError(f"unknown serving step kind {kind!r}")
    if paged_attn is not None and kind != "paged_decode":
        raise ValueError("paged_attn only applies to kind='paged_decode'")
    key = (kind, _mp_cache_key(mp), paged_attn)
    with _SERVING_STEPS_LOCK:
        steps = model.__dict__.setdefault(_STEPS_ATTR, {})
        fn = steps.get(key)
        if fn is None:
            if kind == "paged_decode":
                raw = make_paged_decode_step(model, mp=mp,
                                             paged_attn=paged_attn or "fused")
            else:
                raw = _BUILDERS[kind](model, mp=mp)
            fn = GraphedStep(raw, kind,
                             max_captures=1 if kind == "prefill" else None)
            steps[key] = fn
    return fn


def greedy_next_token(logits: torch.Tensor) -> torch.Tensor:
    """(B, T, V) logits -> (B,) int32 greedy token of the last position
    (first index on ties, as in the reference)."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def nonfinite_rows(logits: torch.Tensor) -> torch.Tensor:
    """(B, T, V) logits -> (B,) bool: the row's last-position logits hold a
    NaN or an inf. The serving engines' numerical tripwire: a reduction
    over a step's output (the step's own numerics are untouched), copied
    back beside the step's tokens."""
    return ~torch.isfinite(logits[:, -1]).all(dim=-1)


def shadow_logit_mse(logits: torch.Tensor, ref_logits: torch.Tensor,
                     row: int) -> torch.Tensor:
    """f32 mean squared error between one row's last-position logits under
    the active plan and under the unquantized shadow step: what the
    guardrail holds against the plan's loss-MSE budget."""
    a = logits[row, -1].float()
    b = ref_logits[row, -1].float()
    return torch.mean(torch.square(a - b))


def merge_first_tokens(cur_tok: torch.Tensor, new_tok: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Rows where ``mask`` is set take ``new_tok``, others keep ``cur_tok``.
    (B, 1) int32, stays on the device."""
    return torch.where(mask[:, None], new_tok[:, None], cur_tok)
