"""Per-layer KV-cache dequant scale calibration (scaled fp8 KV; port of
``repro/quant/kv_scales.py``).

An fp8_e4m3 KV cache written *unscaled* clips any key/value whose magnitude
exceeds the format max (448) and wastes the format's dynamic range when a
layer's amax sits far below it. The serving read paths (fused kernel and
gather path) carry per-tensor ``k_scale``/``v_scale`` dequant multipliers;
this module produces real values for them: run a calibration prefill with a
*bf16* cache, record each layer's per-entry amax at cache-write time, and
emit ``scale = amax / fp8_max``.

Usage::

    scales = calibrate_kv_scales(model, params, calib_batches)
    serving_model = LM(dataclasses.replace(model.cfg,
                                           kv_cache_dtype="fp8_e4m3",
                                           kv_dequant_scales=scales))

The returned value is the per-layer tuple ``LMConfig.kv_dequant_scales``
accepts: one ``(("k", s_k), ("v", s_v))`` pair-tuple per layer.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from repro_torch.core.sensitivity import params_device
from repro_torch.quant.qops import QuantContext

__all__ = ["calibrate_kv_scales", "FP8_E4M3_MAX"]

FP8_E4M3_MAX = 448.0


def calibrate_kv_scales(model, params, batches: Iterable, *,
                        fp8_max: float = FP8_E4M3_MAX) -> tuple:
    """Per-layer amax tracking at cache-write time -> dequant scales.

    Runs :meth:`LM.prefill` over ``batches`` (dicts with ``"tokens"``, or
    bare token arrays) on a clone of ``model`` with a bf16 cache, reduces
    each layer's cache entries ("k"/"v") to their absolute max across all
    batches, and returns ``amax / fp8_max`` per entry, rounded to f32.
    Entries that never exceed zero get unit scales.
    """
    cfg = model.cfg
    bf16 = type(model)(dataclasses.replace(cfg, kv_cache_dtype="bfloat16",
                                           kv_dequant_scales=None))
    device = params_device(params)
    ctx = QuantContext()
    amax: dict = {}                              # (layer_key, entry) -> float
    with torch.no_grad():
        for batch in batches:
            tokens = batch["tokens"] if isinstance(batch, dict) else batch
            tokens = torch.as_tensor(np.asarray(tokens) if not isinstance(
                tokens, torch.Tensor) else tokens).to(device)
            B, T = tokens.shape
            caches = bf16.init_cache(B, T, device)
            _, caches = bf16.prefill(params, tokens, caches, ctx)
            for lk, node in caches.items():
                for name, leaf in node.items():
                    if name == "pos":
                        continue
                    m = float(leaf.float().abs().max())
                    key = (lk, name)
                    amax[key] = max(amax.get(key, 0.0), m)

    out = []
    for i in range(cfg.n_layers):
        lk = f"layers/{i}"
        entries = sorted(n for (k, n) in amax if k == lk)
        if not entries:
            out.append(None)
            continue
        pairs = []
        for name in entries:
            m = amax[(lk, name)]
            s = m / float(fp8_max) if m > 0.0 else 1.0
            pairs.append((name, float(np.float32(s))))
        out.append(tuple(pairs))
    return tuple(out)
