"""Each constant weight quantized once per format.

A linear op's weight operand is the same on every call, so its quantized
form is computed once and kept beside the weight, as a deployment that
stores fp8 weights (the paper's setting) would. Two forms:

* ``("fake", fmt)`` — the fake-quant path of :func:`repro_torch.quant.qops.
  qeinsum`: the :class:`~repro_torch.quant.qtensor.QTensor` that
  ``qtensor.quantize`` returns, codes in the format's storage dtype (one
  byte for fp8; fp4's grid, whose eight magnitudes e4m3 holds exactly, is
  kept as e4m3) plus the f32 dequant scale. The caller dequantizes at use,
  which gives the bits that ``fake_quant`` gives per call.
* ``("kernel", fmt)`` — ``kernels.ops.fp8_linear``: ``(wq, sw_inv)`` of the
  zero-padded weight from the ``amax`` and ``scale_cast`` kernels.

An entry is weak on the weight (it goes when the weight goes) and is served
only while the weight's in-place version counter (``Tensor._version``),
data pointer, shape and dtype, and the calibrated scale it was quantized
with, are what they were; otherwise the weight is quantized again. A view
(one layer's slice of a ``scan_layers`` stack, made anew at every forward)
is kept under the tensor it views and its place there (storage offset,
shape, strides), so every forward's slice of one layer finds the entry the
first one made, each layer quantized on its own; views share their base's
version counter, so an in-place update of the stack invalidates every
layer's entry. A weight
that requires grad is not constant and is quantized per call. Activations
and BGEMM operands never come here: only ``qeinsum``'s ``rhs`` of a
``linear`` op and ``fp8_linear``'s ``w`` do.

The cache never quantizes while a CUDA graph is being captured: a graph
replays what it recorded, so a quantization recorded into it would run on
every replay. The decode step's warm-up fills the cache first; a miss
during capture raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Hashable, Optional

import torch
from torch.utils.weak import WeakIdKeyDictionary

__all__ = ["cached", "quantizations", "quantize_count", "holding", "nbytes",
           "clear"]

quantizations = 0               # weight quantizations done in this process

_LOCK = threading.Lock()
# weight (or the tensor a view views) -> {(view place, key): _Entry}
_ENTRIES: WeakIdKeyDictionary = WeakIdKeyDictionary()
_HOLDERS: list = []             # lists collecting the values served


@dataclasses.dataclass
class _Entry:
    stamp: tuple                # the weight's (version, data_ptr, shape, dtype)
    scale: object               # the scale it was quantized with
    scale_version: int
    value: object
    count: int                  # quantizations of this weight under this key
    w_bytes: int                # the weight's own bytes


def _stamp(w: torch.Tensor) -> tuple:
    return (w._version, w.data_ptr(), tuple(w.shape), w.dtype)


def _owner(w: torch.Tensor, key: Hashable) -> tuple:
    """(the tensor an entry is kept under, its key there)."""
    if w._base is None:
        return w, (None, key)
    return w._base, ((w.storage_offset(), tuple(w.shape), w.stride()), key)


def _scale_version(scale) -> int:
    return scale._version if isinstance(scale, torch.Tensor) else 0


def _same_scale(entry: _Entry, scale) -> bool:
    if isinstance(scale, torch.Tensor) or isinstance(entry.scale,
                                                     torch.Tensor):
        return (entry.scale is scale
                and entry.scale_version == _scale_version(scale))
    if scale is None or entry.scale is None:
        return scale is entry.scale
    return float(scale) == float(entry.scale)


def cached(w: torch.Tensor, key: Hashable, build: Callable[[], object],
           scale=None) -> object:
    """``build()``'s result for weight ``w`` under ``key``, computed once
    while ``w`` (and ``scale``) stay unchanged."""
    global quantizations
    if w.requires_grad:
        return build()
    owner, okey = _owner(w, key)
    with _LOCK:
        per_weight = _ENTRIES.get(owner)
        entry = None if per_weight is None else per_weight.get(okey)
        if (entry is not None and entry.stamp == _stamp(w)
                and _same_scale(entry, scale)):
            for holder in _HOLDERS:
                holder.append((w, entry.value))
            return entry.value
    if w.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"weight {tuple(w.shape)} ({key}) would be quantized inside a "
            f"CUDA graph capture; run the step once before capturing it")
    value = build()
    with _LOCK:
        per_weight = _ENTRIES.setdefault(owner, {})
        old = per_weight.get(okey)
        per_weight[okey] = _Entry(_stamp(w), scale, _scale_version(scale),
                                  value, 1 if old is None else old.count + 1,
                                  w.numel() * w.element_size())
        quantizations += 1
        for holder in _HOLDERS:
            holder.append((w, value))
    return value


def quantize_count(w: torch.Tensor, key: Optional[Hashable] = None) -> int:
    """How many times ``w`` was quantized under ``key`` (all keys if
    None)."""
    owner, okey = _owner(w, key)
    with _LOCK:
        per_weight = _ENTRIES.get(owner) or {}
        if key is not None:
            entry = per_weight.get(okey)
            return 0 if entry is None else entry.count
        return sum(e.count for (place, _), e in per_weight.items()
                   if place == okey[0])


@contextlib.contextmanager
def holding():
    """Collect ``(weight, value)`` for every value served inside the block
    into the yielded list, so a CUDA graph that reads the values can keep
    them alive (a graph holds addresses, not tensors) and notice when a
    weight changes in place."""
    held: list = []
    with _LOCK:
        _HOLDERS.append(held)
    try:
        yield held
    finally:
        with _LOCK:
            _HOLDERS.remove(held)


def _bytes(value) -> int:
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, (tuple, list)):
        return sum(_bytes(v) for v in value)
    if dataclasses.is_dataclass(value):
        return sum(_bytes(getattr(value, f.name))
                   for f in dataclasses.fields(value))
    return 0


def nbytes(device: Optional[torch.device] = None) -> tuple:
    """``(bytes kept, bytes of the weights they stand for)`` over every
    live entry (on ``device``'s type, if given)."""
    with _LOCK:
        items = [(w, e) for w, per in _ENTRIES.items()
                 for e in per.values()]
    items = [(w, e) for w, e in items
             if device is None or w.device.type == device.type]
    return (sum(_bytes(e.value) for _, e in items),
            sum(e.w_bytes for _, e in items))


def clear() -> None:
    """Drop every kept value (their memory goes once no CUDA graph holds
    them); the next use of a weight quantizes it again."""
    with _LOCK:
        _ENTRIES.clear()
