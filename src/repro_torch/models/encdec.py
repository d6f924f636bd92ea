"""Encoder-decoder transformer, the Whisper-style backbone (port of
``repro/models/encdec.py``).

As in the reference, the audio frontend is a stub: a batch carries
precomputed frame embeddings ``frames`` (B, T_enc, d_model); the conv
mel-spectrogram stem is out of scope. Positions are sinusoidal, computed on
the fly, in the encoder and the decoder.

Three quirks of the reference are kept (each pinned by a test):

* the decoder's self-attention applies RoPE (theta 10000) on top of the
  sinusoidal positions;
* at prefill each decoder layer projects the encoder's K/V twice, once for
  its own cross-attention (``kv_x``) and once into the decode cache
  (:func:`repro_torch.nn.layers.cross_kv`): both see the same operands, so
  the cache holds the K/V the prefill attended, and an op registry records
  ``k_proj`` and ``v_proj`` twice, as the reference's does;
* the graph's cross ``k_proj``/``v_proj`` hang off ``cross_norm``
  (``core/graphs.py``), though they read the encoder output.

Caches (:meth:`EncDec.init_cache`) are nested dicts as the reference
assembles them: ``{"dec/i/self": {"k", "v", "pos"}, "dec/i/cross": {"k",
"v"}}``, the self-attention a dense ring of ``max_len`` rows and the cross
K/V of ``enc_len`` frames. They are written in place: the self ring by
the attention, the cross K/V copied in at prefill.

With ``remat`` each encoder layer, and each decoder layer run without
caches, runs under ``torch.utils.checkpoint`` when gradients are taken (the
reference's ``jax.checkpoint`` of the same bodies).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm import _DTYPES, _remat
from repro_torch.nn import layers as L
from repro_torch.nn.spec import ParamSpec, init_params, param_count
from repro_torch.quant import qops
from repro_torch.quant.formats import true_div
from repro_torch.quant.qops import QuantContext

__all__ = ["EncDecConfig", "EncDec"]


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    activation: str = "gelu"
    norm: str = "layernorm"
    loss_chunk: int = 1024
    flash_min_seq: int = 4096
    flash_block: int = 1024
    scan_layers: bool = False  # enc-dec stacks are small; unrolled only
    remat: bool = False
    dtype: str = "bfloat16"

    @property
    def n_layers(self) -> int:  # uniform API with LMConfig
        return self.n_enc_layers + self.n_dec_layers

    @property
    def enc_attn(self) -> L.AttnConfig:
        return L.AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                            self.d_head, causal=False, rope_theta=None,
                            flash_min_seq=self.flash_min_seq,
                            flash_block=self.flash_block)

    @property
    def dec_attn(self) -> L.AttnConfig:
        return L.AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                            self.d_head, causal=True, rope_theta=10000.0,
                            flash_min_seq=self.flash_min_seq,
                            flash_block=self.flash_block)


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(..., T) int positions -> (..., T, d) f32: sines then cosines."""
    half = d // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(true_div(-math.log(10000.0) * ar, float(half)))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncDec:
    # serving capability flags (engines dispatch on these): init_cache
    # takes the encoder length for the precomputed cross-attention K/V; no
    # bucketed or chunked prefill
    cache_needs_enc_len = True
    supports_prefill_chunk = False

    def __init__(self, cfg: EncDecConfig):
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.dtype]

    # ------------------------------------------------------------------
    # specs
    # ------------------------------------------------------------------
    def param_specs(self) -> dict:
        cfg = self.cfg
        specs: dict = {
            "embed/w": ParamSpec((cfg.vocab_size, cfg.d_model),
                                 ("vocab", "embed"), init="normal"),
        }
        specs.update(L.norm_specs("enc_final_norm", cfg.d_model, cfg.norm))
        specs.update(L.norm_specs("dec_final_norm", cfg.d_model, cfg.norm))
        for i in range(cfg.n_enc_layers):
            pre = f"enc/{i}"
            specs.update(L.norm_specs(f"{pre}/attn_norm", cfg.d_model,
                                      cfg.norm))
            specs.update(L.attn_specs(f"{pre}/attn", cfg.enc_attn))
            specs.update(L.norm_specs(f"{pre}/mlp_norm", cfg.d_model,
                                      cfg.norm))
            specs.update(L.mlp_specs(f"{pre}/mlp", cfg.d_model, cfg.d_ff,
                                     cfg.activation))
        for i in range(cfg.n_dec_layers):
            pre = f"dec/{i}"
            specs.update(L.norm_specs(f"{pre}/attn_norm", cfg.d_model,
                                      cfg.norm))
            specs.update(L.attn_specs(f"{pre}/attn", cfg.dec_attn))
            specs.update(L.norm_specs(f"{pre}/cross_norm", cfg.d_model,
                                      cfg.norm))
            specs.update(L.attn_specs(f"{pre}/cross", cfg.enc_attn))
            specs.update(L.norm_specs(f"{pre}/mlp_norm", cfg.d_model,
                                      cfg.norm))
            specs.update(L.mlp_specs(f"{pre}/mlp", cfg.d_model, cfg.d_ff,
                                     cfg.activation))
        return specs

    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> dict:
        """Random params drawn from ``generator`` (on ``device``)."""
        return init_params(generator, self.param_specs(), device)

    def n_params(self) -> int:
        return param_count(self.param_specs())

    # ------------------------------------------------------------------
    # encoder
    # ------------------------------------------------------------------
    def encode(self, params: dict, frames: torch.Tensor,
               ctx: QuantContext) -> torch.Tensor:
        cfg = self.cfg
        B, T, _ = frames.shape
        positions = torch.arange(T, dtype=torch.int32,
                                 device=frames.device)[None].expand(B, T)
        h = (frames.to(self.dtype)
             + _sinusoid(positions, cfg.d_model).to(self.dtype))
        for i in range(cfg.n_enc_layers):
            def body(p, h_, i=i):
                hn = L.apply_norm(p["attn_norm"], h_, cfg.norm)
                y, _ = L.attention(p["attn"], ctx, f"enc/{i}/attn",
                                   cfg.enc_attn, hn, positions)
                h_ = h_ + y
                hn = L.apply_norm(p["mlp_norm"], h_, cfg.norm)
                return h_ + L.apply_mlp(p["mlp"], ctx, f"enc/{i}/mlp", hn,
                                        cfg.activation)

            h = _remat(body, cfg.remat, params["enc"][str(i)], h)
        return L.apply_norm(params["enc_final_norm"], h, cfg.norm)

    # ------------------------------------------------------------------
    # decoder
    # ------------------------------------------------------------------
    def _decoder(self, params: dict, ctx: QuantContext,
                 tokens: torch.Tensor, enc_out: Optional[torch.Tensor], *,
                 caches: Optional[dict] = None, cache_pos=None):
        """The decoder stack over ``tokens`` (B, T). With ``enc_out`` its
        cross-attention attends the encoder output (and, with ``caches``,
        the cross K/V are written into them: prefill); without, it attends
        the cached cross K/V (decode at ``cache_pos``, a 0-d tensor).
        Returns (final-normed h, caches)."""
        cfg = self.cfg
        B, T = tokens.shape
        dev = tokens.device
        if cache_pos is None:
            positions = torch.arange(T, dtype=torch.int32,
                                     device=dev)[None].expand(B, T)
        else:
            cache_pos = torch.as_tensor(cache_pos, dtype=torch.int32,
                                        device=dev)
            positions = cache_pos.reshape(1, 1).expand(B, T)
        h = params["embed"]["w"][tokens.long()].to(self.dtype)
        h = h + _sinusoid(positions, cfg.d_model).to(self.dtype)
        for i in range(cfg.n_dec_layers):
            self_c = None if caches is None else caches[f"dec/{i}/self"]
            cross_c = None if caches is None else caches[f"dec/{i}/cross"]

            def body(p, h_, i=i, self_c=self_c, cross_c=cross_c):
                hn = L.apply_norm(p["attn_norm"], h_, cfg.norm)
                y, _ = L.attention(p["attn"], ctx, f"dec/{i}/attn",
                                   cfg.dec_attn, hn, positions, cache=self_c,
                                   cache_pos=cache_pos)
                h_ = h_ + y
                hn = L.apply_norm(p["cross_norm"], h_, cfg.norm)
                if enc_out is not None:
                    y, _ = L.attention(p["cross"], ctx, f"dec/{i}/cross",
                                       cfg.enc_attn, hn, positions,
                                       kv_x=enc_out, cross=True)
                    if cross_c is not None:
                        kv = L.cross_kv(p["cross"], ctx, f"dec/{i}/cross",
                                        cfg.enc_attn, enc_out)
                        for name, t in kv.items():
                            cross_c[name].copy_(t)
                else:
                    y, _ = L.attention(p["cross"], ctx, f"dec/{i}/cross",
                                       cfg.enc_attn, hn, positions,
                                       cache=cross_c, cross=True)
                h_ = h_ + y
                hn = L.apply_norm(p["mlp_norm"], h_, cfg.norm)
                return h_ + L.apply_mlp(p["mlp"], ctx, f"dec/{i}/mlp", hn,
                                        cfg.activation)

            h = _remat(body, cfg.remat and caches is None,
                       params["dec"][str(i)], h)
        return L.apply_norm(params["dec_final_norm"], h, cfg.norm), caches

    def _head(self, params: dict, ctx: QuantContext,
              h: torch.Tensor) -> torch.Tensor:
        return qops.linear(ctx, "lm_head", h, params["embed"]["w"])

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def apply(self, params: dict, batch: dict,
              ctx: QuantContext) -> torch.Tensor:
        """``batch`` {"frames", "tokens"} -> logits (B, T, V)."""
        enc_out = self.encode(params, batch["frames"], ctx)
        h, _ = self._decoder(params, ctx, batch["tokens"], enc_out)
        return self._head(params, ctx, h)

    def loss(self, params: dict, batch: dict,
             ctx: QuantContext) -> torch.Tensor:
        """Cross-entropy of the decoder's logits against ``labels``."""
        from repro_torch.nn.losses import chunked_ce_loss
        enc_out = self.encode(params, batch["frames"], ctx)
        h, _ = self._decoder(params, ctx, batch["tokens"], enc_out)
        # the head runs unchunked in probe mode and in an op inventory
        # trace, as the port's LM does (see ``LM._ce``)
        return chunked_ce_loss(lambda hi: self._head(params, ctx, hi), h,
                               batch["labels"], batch.get("weights"),
                               self.cfg.loss_chunk,
                               no_scan=(ctx.mode == "probe"
                                        or ctx.registry is not None))

    def cache_specs(self, batch: int, max_len: int, enc_len: int) -> dict:
        """Flat ``dec/i/<self|cross>/<leaf>`` specs of the decode caches."""
        cfg = self.cfg
        specs = {}
        for i in range(cfg.n_dec_layers):
            for k, ps in L.kv_cache_spec(cfg.dec_attn, batch, max_len,
                                         self.dtype).items():
                specs[f"dec/{i}/self/{k}"] = ps
            for k in ("k", "v"):
                specs[f"dec/{i}/cross/{k}"] = ParamSpec(
                    (batch, enc_len, cfg.n_kv_heads, cfg.d_head),
                    ("act_batch", None, "heads", None), self.dtype, "zeros")
        return specs

    @staticmethod
    def _materialize(specs: dict, device: torch.device) -> dict:
        """The cache tree of flat ``layer/leaf`` specs (positions -1)."""
        caches: dict = {}
        for key, s in specs.items():
            layer, leaf = key.rsplit("/", 1)
            caches.setdefault(layer, {})[leaf] = torch.full(
                s.shape, -1 if leaf == "pos" else 0, dtype=s.dtype,
                device=device)
        return caches

    def init_cache(self, batch: int, max_len: int, enc_len: int,
                   device: DeviceLike = None) -> dict:
        return self._materialize(self.cache_specs(batch, max_len, enc_len),
                                 resolve_device(device))

    def prefill(self, params: dict, frames: torch.Tensor,
                tokens: torch.Tensor, caches: dict, ctx: QuantContext):
        """Encode ``frames``, run the decoder over the prompt ``tokens``
        into ``caches``; returns (last-token logits, caches)."""
        enc_out = self.encode(params, frames, ctx)
        h, caches = self._decoder(params, ctx, tokens, enc_out,
                                  caches=caches)
        return self._head(params, ctx, h[:, -1:]), caches

    def decode_step(self, params: dict, token: torch.Tensor, pos,
                    caches: dict, ctx: QuantContext):
        """One token (B, 1) for every sequence at position ``pos`` (a
        scalar: a lock-step batch)."""
        h, caches = self._decoder(params, ctx, token, None, caches=caches,
                                  cache_pos=pos)
        return self._head(params, ctx, h), caches
