"""Serving step builders (port of the serving half of
``repro/launch/steps.py``).

A step is a closure over the model and one ``QuantContext``;
:func:`get_serving_step` memoizes the steps per (model, kind, MP assignment,
paged_attn) so every engine over one model shares them, as the reference
memoizes its ``jax.jit`` of each. The reference compiles every step; the
port compiles the one whose shapes are fixed for a drain, the paged decode
step: on CUDA it is captured once as a CUDA graph and replayed
(:class:`PagedDecodeStep`). Prefill steps run eagerly: their shapes vary.
"""
from __future__ import annotations

import importlib
import threading
from typing import Optional

import torch

from repro_torch.core.mpconfig import as_assignment
from repro_torch.quant.qops import QuantContext

__all__ = ["make_prefill_step", "make_bucketed_prefill_step",
           "make_chunked_prefill_step", "make_decode_step",
           "make_paged_decode_step", "PagedDecodeStep", "get_serving_step",
           "greedy_next_token", "merge_first_tokens", "graph_captures",
           "graph_replays"]

graph_captures = 0              # CUDA graph captures of decode steps
graph_replays = 0               # and their replays, in this process


def _serving_ctx(mp) -> QuantContext:
    """One QuantContext policy for every serving step: per-*token* activation
    scales, so greedy tokens depend neither on which requests share the
    batch nor on how a prompt is padded into a bucket."""
    mp = as_assignment(mp)
    return (QuantContext(mode="mp", mp=mp, act_scale_token=True) if mp
            else QuantContext())


def make_prefill_step(model, mp: Optional[dict] = None):
    """(params, caches, tokens) -> (last-token logits, caches)."""
    ctx = _serving_ctx(mp)

    def prefill_step(params, caches, tokens):
        return model.prefill(params, tokens, caches, ctx)
    return prefill_step


def make_bucketed_prefill_step(model, mp: Optional[dict] = None):
    """(params, caches, tokens, start, valid) -> (last-valid logits, caches)
    over dense rings; ``tokens`` (B, Lb) padded to a power-of-two bucket."""
    ctx = _serving_ctx(mp)

    def prefill_step(params, caches, tokens, start, valid):
        return model.prefill_chunk(params, tokens, caches, ctx,
                                   start_pos=start, valid_len=valid)
    return prefill_step


def make_chunked_prefill_step(model, mp: Optional[dict] = None):
    """(params, caches, tokens, start, valid, block_tables) -> (logits,
    caches): the paged twin — the chunk's K/V goes straight into the pool's
    blocks."""
    ctx = _serving_ctx(mp)

    def prefill_step(params, caches, tokens, start, valid, block_tables):
        return model.prefill_chunk(params, tokens, caches, ctx,
                                   start_pos=start, valid_len=valid,
                                   block_tables=block_tables)
    return prefill_step


def make_decode_step(model, mp: Optional[dict] = None):
    """(params, caches, token, pos) -> (logits, caches) over dense rings."""
    ctx = _serving_ctx(mp)

    def decode_step(params, caches, token, pos):
        return model.decode_step(params, token, pos, caches, ctx)
    return decode_step


def make_paged_decode_step(model, mp: Optional[dict] = None,
                           paged_attn: str = "fused"):
    """(params, caches, token, pos, block_tables) -> (logits, caches,
    next_token), run eagerly. ``paged_attn="fused"`` attends block-major
    K/V in place through the CUDA kernel; ``"gather"`` keeps the reference
    path. Layers whose attention BGEMMs carry an MP format always gather.
    ``get_serving_step`` wraps it in a :class:`PagedDecodeStep`."""
    ctx = _serving_ctx(mp)

    def decode_step(params, caches, token, pos, block_tables):
        logits, caches = model.decode_step(params, token, pos, caches, ctx,
                                           block_tables=block_tables,
                                           paged_attn=paged_attn)
        return logits, caches, greedy_next_token(logits)
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
        self.roots = (params, caches)
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

    def bound_to(self, params, caches, inputs) -> bool:
        if params is not self.roots[0] or caches is not self.roots[1]:
            return False
        for a, b in zip(inputs, self.inputs):
            if (a.shape, a.dtype, a.device) != (b.shape, b.dtype, b.device):
                return False
        for parent, k, v in self.edges:
            if parent.get(k) is not v:
                return False
        return all(w._version == v for w, v in self.quantized)


class PagedDecodeStep:
    """The paged decode step, ``(params, caches, token, pos, block_tables)
    -> (logits, caches, next_token)`` with ``next_token`` the (B,) int32
    greedy token of :func:`greedy_next_token`.

    On the CPU it runs eagerly, as the caller asked for the CPU. On CUDA it
    is the port's counterpart of the reference's memoized ``jax.jit``: the
    first call of a binding runs the step once on a side stream (the
    warm-up, whose outputs it returns; it also fills the weight cache), then
    captures it as a CUDA graph; later calls replay the graph. The binding
    is the params' and caches' nested dicts and tensors (identity), the
    in-place version of every weight whose quantized operand the graph
    reads from the weight cache, and the inputs' shapes, dtypes and
    devices; when any of them changes the step captures again, so a graph
    is never replayed over other tensors or a stale quantized weight. The
    graph reads token, positions and block tables from the tensors of the
    call it was captured in — its static inputs: the engine keeps those
    buffers across drains and fills them with ``copy_`` — and a call that
    passes other tensors has them copied in. Logits and greedy token come
    out in static outputs, which the next replay overwrites.

    A capture that fails raises; on CUDA nothing falls back to eager. The
    capture records launches without making them, so it adds nothing to
    the kernels' launch counters, and each replay adds the launches it
    recorded. ``graph_captures`` / ``graph_replays`` (module level) count
    captures and replays."""

    def __init__(self, fn):
        self.fn = fn
        self._captured: Optional[_Captured] = None

    def __call__(self, params, caches, token, pos, block_tables):
        global graph_replays
        if token.device.type != "cuda":
            return self.fn(params, caches, token, pos, block_tables)
        inputs = (token, pos, block_tables)
        cap = self._captured
        if cap is None or not cap.bound_to(params, caches, inputs):
            return self._capture(params, caches, inputs)
        for a, b in zip(inputs, cap.inputs):
            if a is not b:
                b.copy_(a)
        cap.graph.replay()
        graph_replays += 1
        _add_counters(cap.launches)
        return cap.logits, caches, cap.next_token

    def _capture(self, params, caches, inputs):
        global graph_captures
        from repro_torch.quant import weight_cache
        self._captured = None          # release the old graph and its pool
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            logits, caches, nxt = self.fn(params, caches, *inputs)
        main.wait_stream(side)
        for t in (logits, nxt):
            t.record_stream(main)
        graph = torch.cuda.CUDAGraph()
        before = _read_counters()
        try:
            with weight_cache.holding() as held, torch.cuda.graph(graph):
                s_logits, _, s_next = self.fn(params, caches, *inputs)
        except Exception as e:
            raise RuntimeError(
                "paged decode step: CUDA graph capture failed (on CUDA the "
                "step does not run eagerly instead)") from e
        finally:
            after = _read_counters()
            delta = {k: after[k] - before.get(k, 0) for k in after}
            _add_counters(delta, times=-1)   # the capture launched nothing
        self._captured = _Captured(graph, params, caches, inputs, s_logits,
                                   s_next, delta, held)
        graph_captures += 1
        return logits, caches, nxt


_BUILDERS = {
    "prefill": make_prefill_step,
    "bucketed_prefill": make_bucketed_prefill_step,
    "chunked_prefill": make_chunked_prefill_step,
    "decode": make_decode_step,
    "paged_decode": make_paged_decode_step,
}

# {(kind, mp key, paged_attn): step}, kept on the model itself: a step's
# closure holds the model, so a table keyed weakly on the model would keep
# every model (and its decode graphs, with the params they are bound to)
# alive; on the model, the cycle goes with it
_STEPS_ATTR = "_serving_steps"
_SERVING_STEPS_LOCK = threading.Lock()


def _mp_cache_key(mp):
    mp = as_assignment(mp)
    return None if mp is None else tuple(sorted(mp.items()))


def get_serving_step(model, kind: str, mp=None,
                     paged_attn: Optional[str] = None):
    """Memoized serving step for ``model``. ``kind`` is one of
    ``prefill`` / ``bucketed_prefill`` / ``chunked_prefill`` / ``decode`` /
    ``paged_decode``; ``mp`` an assignment dict or an ``MPPlan``."""
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
                fn = PagedDecodeStep(make_paged_decode_step(
                    model, mp=mp, paged_attn=paged_attn or "fused"))
            else:
                fn = _BUILDERS[kind](model, mp=mp)
            steps[key] = fn
    return fn


def greedy_next_token(logits: torch.Tensor) -> torch.Tensor:
    """(B, T, V) logits -> (B,) int32 greedy token of the last position
    (first index on ties, as in the reference)."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def merge_first_tokens(cur_tok: torch.Tensor, new_tok: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Rows where ``mask`` is set take ``new_tok``, others keep ``cur_tok``.
    (B, 1) int32, stays on the device."""
    return torch.where(mask[:, None], new_tok[:, None], cur_tok)
