"""Architecture registry: ``--arch <id>`` -> model builder.

Lists only what the port serves today; every id maps to
``repro_torch/configs/<id>.py`` exposing ``config(**overrides)`` (published
dims) and ``smoke_config()`` (same family, reduced dims for CPU tests).
"""
from __future__ import annotations

import importlib

from repro_torch.models.lm import LM, LMConfig

ARCH_IDS = ["llama3_1b", "llama3_8b", "deepseek_v3_671b", "qwen2p5_3b",
            "qwen2p5_32b", "nemotron_4_15b", "starcoder2_15b",
            "moonshot_v1_16b_a3b"]


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


def depth_overrides(arch: str, n_layers: int, smoke: bool = False,
                    keep_mtp: bool = False) -> dict:
    """Overrides that keep a configuration's first ``n_layers`` layers
    (block types and MoE layers cut alike) and, unless ``keep_mtp``, drop
    multi-token prediction, which serving does not read: DeepSeek-V3 past
    its dense prefix on one card (``n_layers=5``: three dense MLA layers
    and two MoE layers)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if not 0 < n_layers <= cfg.n_layers:
        raise ValueError(f"{arch} has {cfg.n_layers} layers, asked to keep "
                         f"{n_layers}")
    ov = dict(n_layers=n_layers, block_types=cfg.block_types[:n_layers],
              moe_layers=tuple(i for i in cfg.moe_layers if i < n_layers))
    return ov if keep_mtp else dict(ov, mtp_depth=0)


def dense_prefix_overrides(arch: str, smoke: bool = False) -> dict:
    """:func:`depth_overrides` at the layers before an MoE configuration's
    first MoE layer: DeepSeek-V3's three dense MLA layers at its published
    widths (``{}`` for a dense configuration)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if not cfg.moe_layers and not cfg.mtp_depth:
        return {}
    return depth_overrides(arch, min(cfg.moe_layers, default=cfg.n_layers),
                           smoke)


def get_model(arch: str, smoke: bool = False, **overrides) -> LM:
    cfg = (get_smoke_config(arch, **overrides) if smoke
           else get_config(arch, **overrides))
    return build_model(cfg)
