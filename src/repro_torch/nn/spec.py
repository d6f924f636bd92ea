"""Specs-first parameter system (port of ``repro/nn/spec.py``).

Every model exposes ``param_specs() -> dict[path -> ParamSpec]``, a flat dict
keyed by '/'-separated paths — the same paths as the reference package, so
weights move between the two through numpy by path. Initialisation draws
from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["ParamSpec", "init_params", "tree_from_flat", "flatten_paths",
           "param_count", "param_bytes", "dtype_bytes", "default_generator"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    logical_axes: tuple          # one logical axis name (or None) per dim
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"         # normal | zeros | ones | scaled_normal
    init_scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.logical_axes), (
            f"shape {self.shape} vs axes {self.logical_axes}")


def _init_one(gen: torch.Generator, spec: ParamSpec,
              device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    scale = spec.init_scale
    if spec.init == "scaled_normal":  # 1/sqrt(fan_in) init
        fan_in = spec.shape[-1] if len(spec.shape) > 1 else spec.shape[0]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * scale).to(spec.dtype)


def tree_from_flat(flat: dict) -> dict:
    """'a/b/c' flat dict -> nested dicts."""
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def flatten_paths(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten_paths(v, path))
        else:
            flat[path] = v
    return flat


def init_params(gen: torch.Generator, specs: dict,
                device: DeviceLike = None) -> dict:
    """specs: flat path->ParamSpec. Draws in sorted path order from ``gen``
    (which must live on ``device``). Returns the nested param tree."""
    device = resolve_device(device)
    flat = {p: _init_one(gen, specs[p], device) for p in sorted(specs)}
    return tree_from_flat(flat)


def dtype_bytes(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def param_count(specs: dict) -> int:
    return sum(math.prod(s.shape) for s in specs.values())


def param_bytes(specs: dict) -> int:
    return sum(math.prod(s.shape) * dtype_bytes(s.dtype)
               for s in specs.values())


def default_generator(seed: int, device: DeviceLike = None
                      ) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    device = resolve_device(device)
    return torch.Generator(device=device).manual_seed(seed)
