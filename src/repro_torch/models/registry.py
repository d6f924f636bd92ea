"""Architecture registry: ``--arch <id>`` -> model builder.

Lists only what the port serves today; every id maps to
``repro_torch/configs/<id>.py`` exposing ``config(**overrides)`` (published
dims) and ``smoke_config()`` (same family, reduced dims for CPU tests).
"""
from __future__ import annotations

import importlib

from repro_torch.models.lm import LM, LMConfig

ARCH_IDS = ["llama3_1b"]


def canonical(arch: str) -> str:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; the port "
                       f"supports: {ARCH_IDS}")
    return arch


def _module(arch: str):
    return importlib.import_module(f"repro_torch.configs.{canonical(arch)}")


def get_config(arch: str, **overrides) -> LMConfig:
    return _module(arch).config(**overrides)


def get_smoke_config(arch: str, **overrides) -> LMConfig:
    return _module(arch).smoke_config(**overrides)


def build_model(cfg: LMConfig) -> LM:
    if not isinstance(cfg, LMConfig):
        raise TypeError(type(cfg))
    return LM(cfg)


def get_model(arch: str, smoke: bool = False, **overrides) -> LM:
    cfg = (get_smoke_config(arch, **overrides) if smoke
           else get_config(arch, **overrides))
    return build_model(cfg)
