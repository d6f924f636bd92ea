"""Architecture registry: ``--arch <id>`` -> model builder.

Lists only what the port serves today; every id maps to
``repro_torch/configs/<id>.py`` exposing ``config(**overrides)`` (published
dims) and ``smoke_config()`` (same family, reduced dims for CPU tests).
"""
from __future__ import annotations

import importlib

from repro_torch.models.lm import LM, LMConfig

ARCH_IDS = ["llama3_1b", "llama3_8b", "deepseek_v3_671b", "qwen2p5_3b",
            "qwen2p5_32b", "nemotron_4_15b", "starcoder2_15b"]


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


def dense_prefix_overrides(arch: str, smoke: bool = False) -> dict:
    """Overrides that keep the layers before an MoE configuration's first
    MoE layer and drop multi-token prediction: DeepSeek-V3's three dense MLA
    layers at its published widths (``{}`` for a dense configuration)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if not cfg.moe_layers and not cfg.mtp_depth:
        return {}
    n = min(cfg.moe_layers) if cfg.moe_layers else cfg.n_layers
    return dict(n_layers=n, block_types=tuple(cfg.block_types[:n]),
                moe_layers=(), mtp_depth=0)


def get_model(arch: str, smoke: bool = False, **overrides) -> LM:
    cfg = (get_smoke_config(arch, **overrides) if smoke
           else get_config(arch, **overrides))
    return build_model(cfg)
