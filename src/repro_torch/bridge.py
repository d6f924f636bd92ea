"""Weights from flat numpy arrays into the port's param tree.

``params_from_flat`` takes ``{path: array}`` keyed by the flat param paths
both packages share (``embed/w``, ``layers/3/attn/q_proj/w``, ...) and
returns the nested tensor tree the port's ``LM`` (or, for an
``EncDecConfig``, ``EncDec``: ``embed/w``, ``enc/*``, ``dec/*`` and the two
``*_final_norm`` paths) consumes; for a ``scan_layers`` config the paths are
the stacked ``segments/s/...`` ones, which :func:`stack_layers` makes from
an unrolled model's. It raises on any
missing or extra path and on any shape mismatch, so weights meant for another
configuration never load silently.

Arrays in numpy's extension float types (``ml_dtypes.bfloat16``, the fp8
types) are rejected by ``torch.from_numpy``; they pass through float32,
which represents every such value exactly, and are then cast to the spec's
dtype.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.encdec import EncDec, EncDecConfig
from repro_torch.models.lm import LM, LMConfig
from repro_torch.nn.spec import tree_from_flat

__all__ = ["params_from_flat", "stack_layers"]

_NATIVE = (np.float32, np.float64, np.float16, np.int32, np.int64, np.bool_)


def _to_tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.type not in _NATIVE:
        a = a.astype(np.float32)
    # a private writable copy: arrays exported by other frameworks are often
    # read-only, and torch.from_numpy would alias them
    return torch.from_numpy(np.array(a, order="C", copy=True)).to(
        device=device, dtype=dtype)


def params_from_flat(flat: dict, cfg: Union[LMConfig, EncDecConfig],
                     device: DeviceLike = None) -> dict:
    """Build the nested param tree for ``cfg`` from ``flat`` (path -> array).
    """
    device = resolve_device(device)
    model = EncDec(cfg) if isinstance(cfg, EncDecConfig) else LM(cfg)
    specs = model.param_specs()
    missing = sorted(set(specs) - set(flat))
    extra = sorted(set(flat) - set(specs))
    if missing or extra:
        raise KeyError(f"param paths do not match {cfg.name}: missing "
                       f"{missing[:8]}{'...' if len(missing) > 8 else ''}, "
                       f"extra {extra[:8]}{'...' if len(extra) > 8 else ''}")
    out = {}
    for path, spec in specs.items():
        t = _to_tensor(flat[path], spec.dtype, device)
        if tuple(t.shape) != tuple(spec.shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)}, expected "
                             f"{tuple(spec.shape)}")
        out[path] = t
    return tree_from_flat(out)


def stack_layers(flat: dict, cfg: LMConfig) -> dict:
    """An unrolled model's flat params (``layers/i/...``) as the flat
    params of ``cfg``, a ``scan_layers`` config of the same model: each
    segment's leaves stacked over its layers (``segments/s/...``, numpy
    arrays or tensors as given), every other path (embedding, head, MTP
    block) as it is."""
    model = LM(cfg)
    segs = cfg.segments()
    out = {}
    for path in model.param_specs():
        if not path.startswith("segments/"):
            out[path] = flat[path]
            continue
        _, s, sub = path.split("/", 2)
        leaves = [flat[f"layers/{i}/{sub}"] for i in segs[int(s)][1]]
        out[path] = (torch.stack(leaves) if isinstance(leaves[0],
                                                       torch.Tensor)
                     else np.stack(leaves))
    return out
