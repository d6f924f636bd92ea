"""Architecture registry: ``--arch <id>`` -> model builder.

Every id of the reference maps to ``repro_torch/configs/<id>.py`` exposing
``config(**overrides)`` (published dims) and ``smoke_config()`` (same
family, reduced dims for CPU tests). ``build_model`` gives an ``LM`` for an
``LMConfig`` and an ``EncDec`` for an ``EncDecConfig``.
"""
from __future__ import annotations

import importlib
from typing import Union

from repro_torch.models.encdec import EncDec, EncDecConfig
from repro_torch.models.lm import LM, LMConfig

ARCH_IDS = ["llama3_1b", "llama3_8b", "deepseek_v3_671b", "qwen2p5_3b",
            "qwen2p5_32b", "nemotron_4_15b", "starcoder2_15b",
            "moonshot_v1_16b_a3b", "mamba2_370m", "hymba_1p5b",
            "whisper_base", "llava_next_34b"]


def canonical(arch: str) -> str:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; the port "
                       f"supports: {ARCH_IDS}")
    return arch


def _module(arch: str):
    return importlib.import_module(f"repro_torch.configs.{canonical(arch)}")


def get_config(arch: str, **overrides) -> Union[LMConfig, EncDecConfig]:
    return _module(arch).config(**overrides)


def get_smoke_config(arch: str,
                     **overrides) -> Union[LMConfig, EncDecConfig]:
    return _module(arch).smoke_config(**overrides)


def build_model(cfg) -> Union[LM, EncDec]:
    if isinstance(cfg, EncDecConfig):
        return EncDec(cfg)
    if not isinstance(cfg, LMConfig):
        raise TypeError(type(cfg))
    return LM(cfg)


def depth_overrides(arch: str, n_layers: int, smoke: bool = False,
                    keep_mtp: bool = False) -> dict:
    """Overrides that keep a configuration's first ``n_layers`` layers
    (block types and MoE layers cut alike) and, unless ``keep_mtp``, drop
    multi-token prediction, which serving does not read: DeepSeek-V3 past
    its dense prefix on one card (``n_layers=5``: three dense MLA layers
    and two MoE layers). An encoder-decoder keeps its first ``n_layers``
    encoder layers and its first ``n_layers`` decoder layers."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if isinstance(cfg, EncDecConfig):
        if not 0 < n_layers <= min(cfg.n_enc_layers, cfg.n_dec_layers):
            raise ValueError(f"{arch} has {cfg.n_enc_layers} + "
                             f"{cfg.n_dec_layers} layers, asked to keep "
                             f"{n_layers} of each")
        return dict(n_enc_layers=n_layers, n_dec_layers=n_layers)
    if not 0 < n_layers <= cfg.n_layers:
        raise ValueError(f"{arch} has {cfg.n_layers} layers, asked to keep "
                         f"{n_layers}")
    ov = dict(n_layers=n_layers, block_types=cfg.block_types[:n_layers],
              moe_layers=tuple(i for i in cfg.moe_layers if i < n_layers))
    if cfg.global_attn_layers:
        ov["global_attn_layers"] = tuple(i for i in cfg.global_attn_layers
                                         if i < n_layers)
    return ov if keep_mtp else dict(ov, mtp_depth=0)


def dense_prefix_overrides(arch: str, smoke: bool = False) -> dict:
    """:func:`depth_overrides` at the layers before an MoE configuration's
    first MoE layer: DeepSeek-V3's three dense MLA layers at its published
    widths (``{}`` for a dense configuration)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if isinstance(cfg, EncDecConfig) or (not cfg.moe_layers
                                         and not cfg.mtp_depth):
        return {}
    return depth_overrides(arch, min(cfg.moe_layers, default=cfg.n_layers),
                           smoke)


def get_model(arch: str, smoke: bool = False,
              **overrides) -> Union[LM, EncDec]:
    cfg = (get_smoke_config(arch, **overrides) if smoke
           else get_config(arch, **overrides))
    return build_model(cfg)
