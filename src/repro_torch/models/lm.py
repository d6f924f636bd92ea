"""Decoder-only LM with dense attention or MLA blocks (port of
``repro/models/lm.py``).

Block types: ``attn`` (GQA, the llama family) and ``mla`` (DeepSeek-V3's
multi-head latent attention), each followed by a dense MLP or, for the
layers in ``moe_layers``, a Mixture-of-Experts layer
(:mod:`repro_torch.nn.moe`); ``mtp_depth`` adds DeepSeek-V3's multi-token
prediction module, which only :meth:`LM.loss` reads. ``LMConfig`` keeps
every field of the reference so that every configuration loads; the
features the port does not have yet — mamba/hybrid blocks, ``scan_layers``
and ``prefix_embed`` — raise ``NotImplementedError`` when the model is
built. Layers run unrolled in a Python loop, each with its own params and
op names (``layers/3/attn/q_proj``), so per-layer MP plans apply unchanged.

Params are the nested dict of tensors that :meth:`LM.init` returns (or
``repro_torch.bridge.params_from_flat`` builds from reference weights);
caches are nested dicts ``{"layers/i": {"k", "v"[, "pos"]}}`` for attention
layers and ``{"layers/i": {"ckv", "kr"[, "pos"]}}`` for MLA layers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn import layers as L
from repro_torch.nn.moe import MoEConfig, apply_moe, moe_specs  # noqa: F401
from repro_torch.nn.spec import ParamSpec, init_params, param_count
from repro_torch.quant import qops
from repro_torch.quant.formats import get_format
from repro_torch.quant.qops import QuantContext

BIG_WINDOW = 1 << 30

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    vocab_size: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    global_attn_layers: tuple = ()        # layers exempt from the window
    # MLA (block type "mla")
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    mla_absorb_decode: bool = False
    # mlp
    d_ff: int = 0
    activation: str = "swiglu"
    norm: str = "rmsnorm"
    # blocks
    block_types: tuple = ()               # len == n_layers
    moe_layers: tuple = ()
    moe: Optional[object] = None
    ssm: Optional[object] = None
    # head
    tie_embeddings: bool = False
    prefix_embed: bool = False
    mtp_depth: int = 0
    mtp_weight: float = 0.3
    # infra
    scan_layers: bool = False
    remat: bool = False
    remat_group: int = 8
    loss_chunk: int = 1024
    flash_min_seq: int = 4096
    flash_block: int = 1024
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"      # fp8_e4m3 halves decode cache HBM
    # paged KV dequant multipliers: None | ((entry, scale), ...) for every
    # layer | a per-layer tuple (len n_layers) of such pair-tuples
    kv_dequant_scales: Optional[tuple] = None
    param_dtype: str = "bfloat16"

    def __post_init__(self):
        if not self.block_types:
            object.__setattr__(self, "block_types", ("attn",) * self.n_layers)
        assert len(self.block_types) == self.n_layers
        sc = self.kv_dequant_scales
        if sc is not None:
            sc = tuple(sc)
            if self._scales_are_per_layer(sc):
                sc = tuple(None if e is None else
                           tuple((str(n), float(s)) for n, s in e)
                           for e in sc)
                if len(sc) != self.n_layers:
                    raise ValueError(
                        f"per-layer kv_dequant_scales has {len(sc)} entries "
                        f"for {self.n_layers} layers")
            else:
                sc = tuple((str(n), float(s)) for n, s in sc)
            object.__setattr__(self, "kv_dequant_scales", sc)

    @staticmethod
    def _scales_are_per_layer(sc: tuple) -> bool:
        first = next((e for e in sc if e is not None), None)
        if first is None:
            return True
        return not (len(first) == 2 and isinstance(first[0], str))

    def kv_scales_for(self, i: Optional[int]) -> Optional[tuple]:
        sc = self.kv_dequant_scales
        if sc is None:
            return None
        if self._scales_are_per_layer(sc):
            return None if i is None else sc[i]
        return sc

    @property
    def attn_cfg(self) -> L.AttnConfig:
        return self.attn_cfg_for(None)

    def attn_cfg_for(self, i: Optional[int]) -> L.AttnConfig:
        return L.AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                            self.d_head, qkv_bias=self.qkv_bias,
                            rope_theta=self.rope_theta,
                            window=self.sliding_window,
                            flash_min_seq=self.flash_min_seq,
                            flash_block=self.flash_block,
                            kv_dequant_scales=self.kv_scales_for(i))

    @property
    def mla_cfg(self) -> L.MLAConfig:
        return self.mla_cfg_for(None)

    def mla_cfg_for(self, i: Optional[int]) -> L.MLAConfig:
        return L.MLAConfig(self.d_model, self.n_heads, self.q_lora_rank,
                           self.kv_lora_rank, self.qk_nope_dim,
                           self.qk_rope_dim, self.v_head_dim, self.rope_theta,
                           flash_min_seq=self.flash_min_seq,
                           flash_block=self.flash_block,
                           absorb_decode=self.mla_absorb_decode,
                           kv_dequant_scales=self.kv_scales_for(i))

    def layer_signature(self, i: int) -> tuple:
        return (self.block_types[i], i in self.moe_layers)

    def window_for(self, i: int) -> Optional[int]:
        if self.sliding_window is None or i in self.global_attn_layers:
            return None
        return self.sliding_window


# the ROADMAP.md item that ports each family of layers or option
_ITEMS = {"scan_layers": "A9", "prefix_embed": "A8"}


def _unsupported(cfg: LMConfig) -> list:
    out = []
    other = sorted(set(cfg.block_types) - {"attn", "mla"})
    if other:
        out.append(f"block types {other} (mamba / hybrid: ROADMAP item A8)")
    for flag in ("scan_layers", "prefix_embed"):
        if getattr(cfg, flag):
            out.append(f"{flag} (ROADMAP item {_ITEMS[flag]})")
    return out


class LM:
    # serving capability flags (engines dispatch on these)
    cache_needs_enc_len = False
    supports_prefill_chunk = True

    def __init__(self, cfg: LMConfig):
        missing = _unsupported(cfg)
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(missing)} land with the port slice "
                f"of the ROADMAP.md item named")
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.dtype]

    # ------------------------------------------------------------------
    # specs
    # ------------------------------------------------------------------
    def _layer_specs(self, sig: tuple, prefix: str) -> dict:
        cfg = self.cfg
        block, is_moe = sig
        specs: dict = {}
        specs.update(L.norm_specs(f"{prefix}/attn_norm", cfg.d_model,
                                  cfg.norm))
        if block == "mla":
            specs.update(L.mla_specs(f"{prefix}/attn", cfg.mla_cfg))
        else:
            specs.update(L.attn_specs(f"{prefix}/attn", cfg.attn_cfg))
        if is_moe:
            specs.update(L.norm_specs(f"{prefix}/mlp_norm", cfg.d_model,
                                      cfg.norm))
            specs.update(moe_specs(f"{prefix}/moe", cfg.d_model, cfg.moe,
                                   cfg.activation))
        elif cfg.d_ff > 0:
            specs.update(L.norm_specs(f"{prefix}/mlp_norm", cfg.d_model,
                                      cfg.norm))
            specs.update(L.mlp_specs(f"{prefix}/mlp", cfg.d_model, cfg.d_ff,
                                     cfg.activation))
        return specs

    def _apply_param_dtype(self, specs: dict) -> dict:
        """Store >=2D matmul weights in cfg.param_dtype (fp8 serving)."""
        if self.cfg.param_dtype == "bfloat16":
            return specs
        dt = get_format(self.cfg.param_dtype).dtype
        out = {}
        for path, ps in specs.items():
            quantizable = (path.endswith("/w") and len(ps.shape) >= 2
                           and not path.startswith("embed"))
            out[path] = (ParamSpec(ps.shape, ps.logical_axes, dt, ps.init,
                                   ps.init_scale) if quantizable else ps)
        return out

    def param_specs(self) -> dict:
        cfg = self.cfg
        specs: dict = {"embed/w": ParamSpec((cfg.vocab_size, cfg.d_model),
                                            ("vocab", "embed"),
                                            init="normal")}
        specs.update(L.norm_specs("final_norm", cfg.d_model, cfg.norm))
        if not cfg.tie_embeddings:
            specs["lm_head/w"] = ParamSpec((cfg.vocab_size, cfg.d_model),
                                           ("vocab", "embed"),
                                           init="scaled_normal")
        for i in range(cfg.n_layers):
            specs.update(self._layer_specs(cfg.layer_signature(i),
                                           f"layers/{i}"))
        if cfg.mtp_depth > 0:
            specs["mtp/proj/w"] = ParamSpec((cfg.d_model, 2 * cfg.d_model),
                                            ("embed", None),
                                            init="scaled_normal")
            specs.update(L.norm_specs("mtp/norm", cfg.d_model, cfg.norm))
            specs.update(self._layer_specs(
                cfg.layer_signature(cfg.n_layers - 1), "mtp/block"))
        return self._apply_param_dtype(specs)

    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> dict:
        """Random params drawn from ``generator`` (on ``device``)."""
        return init_params(generator, self.param_specs(), device)

    def n_params(self) -> int:
        return param_count(self.param_specs())

    def serving_op_names(self) -> set:
        """Every quantizable op name a serving step runs (an MP plan naming
        anything else was solved for another model)."""
        ops = {"lm_head"}
        mlp = (("gate_proj", "up_proj", "down_proj")
               if self.cfg.activation == "swiglu" else ("up_proj",
                                                        "down_proj"))
        attn_ops = {"attn": ("q_proj", "k_proj", "v_proj", "o_proj",
                             "qk_matmul", "av_matmul"),
                    "mla": ("q_a_proj", "q_b_proj", "kv_a_proj", "kv_b_proj",
                            "o_proj", "qk_matmul", "av_matmul")}
        moe = ("router", "experts/gate_proj", "experts/up_proj",
               "experts/down_proj")
        for i in range(self.cfg.n_layers):
            ops.update(f"layers/{i}/attn/{n}"
                       for n in attn_ops[self.cfg.block_types[i]])
            if i in self.cfg.moe_layers:
                ops.update(f"layers/{i}/moe/{n}" for n in moe)
                if self.cfg.moe.n_shared_experts:
                    ops.update(f"layers/{i}/moe/shared/{n}" for n in mlp)
            elif self.cfg.d_ff > 0:
                ops.update(f"layers/{i}/mlp/{n}" for n in mlp)
        return ops

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _block(self, p: dict, ctx: QuantContext, scope: str, sig: tuple,
               h: torch.Tensor, positions: torch.Tensor, *, window="cfg",
               cache: Optional[dict] = None, cache_pos=None,
               block_tables: Optional[torch.Tensor] = None,
               chunk_valid: Optional[torch.Tensor] = None,
               chunk_start: Optional[torch.Tensor] = None,
               chunk_ring: bool = False,
               layer_idx: Optional[int] = None, paged_attn: str = "fused"):
        """One layer; returns (h, cache, aux), ``aux`` the MoE layer's
        f32 load-balance loss (the float 0.0 for a dense MLP, so a dense
        step launches nothing for it). ``layer_idx`` None (the MTP block)
        takes the config-wide attention settings."""
        cfg = self.cfg
        block, is_moe = sig
        aux = 0.0
        hn = L.apply_norm(p["attn_norm"], h, cfg.norm)
        if block == "mla":
            y, cache = L.mla_attention(p["attn"], ctx, f"{scope}/attn",
                                       cfg.mla_cfg_for(layer_idx), hn,
                                       positions, cache=cache,
                                       cache_pos=cache_pos,
                                       block_tables=block_tables,
                                       chunk_valid=chunk_valid,
                                       chunk_start=chunk_start,
                                       chunk_ring=chunk_ring,
                                       paged_attn=paged_attn)
        else:
            y, cache = L.attention(p["attn"], ctx, f"{scope}/attn",
                                   cfg.attn_cfg_for(layer_idx), hn,
                                   positions, cache=cache,
                                   cache_pos=cache_pos,
                                   block_tables=block_tables,
                                   chunk_valid=chunk_valid,
                                   chunk_start=chunk_start,
                                   chunk_ring=chunk_ring, window=window,
                                   paged_attn=paged_attn)
        h = h + y
        if is_moe:
            hn2 = L.apply_norm(p["mlp_norm"], h, cfg.norm)
            ym, aux = apply_moe(p["moe"], ctx, f"{scope}/moe", hn2, cfg.moe,
                                cfg.activation)
            h = h + ym
        elif cfg.d_ff > 0:
            hn2 = L.apply_norm(p["mlp_norm"], h, cfg.norm)
            h = h + L.apply_mlp(p["mlp"], ctx, f"{scope}/mlp", hn2,
                                cfg.activation)
        return h, cache, aux

    def _backbone(self, params: dict, ctx: QuantContext, h: torch.Tensor,
                  positions: torch.Tensor, *, caches: Optional[dict] = None,
                  cache_pos=None, block_tables=None, chunk_valid=None,
                  chunk_start=None, chunk_ring: bool = False,
                  paged_attn: str = "fused"):
        """Run every layer in a Python loop; caches are updated in place.
        Returns (final-normed h, the layers' summed MoE aux loss: 0.0
        without MoE layers)."""
        cfg = self.cfg
        aux_total = 0.0
        for i in range(cfg.n_layers):
            cache_i = None if caches is None else caches[f"layers/{i}"]
            h, _, aux_i = self._block(
                params["layers"][str(i)], ctx, f"layers/{i}",
                cfg.layer_signature(i), h, positions,
                window=cfg.window_for(i), cache=cache_i,
                cache_pos=cache_pos, block_tables=block_tables,
                chunk_valid=chunk_valid, chunk_start=chunk_start,
                chunk_ring=chunk_ring, layer_idx=i, paged_attn=paged_attn)
            aux_total = aux_total + aux_i
        return L.apply_norm(params["final_norm"], h, cfg.norm), aux_total

    def _embed(self, params: dict, tokens: torch.Tensor) -> tuple:
        emb = params["embed"]["w"][tokens.long()].to(self.dtype)
        B, T = emb.shape[0], emb.shape[1]
        positions = torch.arange(T, dtype=torch.int32,
                                 device=emb.device)[None].expand(B, T)
        return emb, positions

    def _head(self, params: dict, ctx: QuantContext,
              h: torch.Tensor) -> torch.Tensor:
        w = (params["embed"]["w"] if self.cfg.tie_embeddings
             else params["lm_head"]["w"])
        return qops.linear(ctx, "lm_head", h, w)

    def apply(self, params: dict, tokens: torch.Tensor,
              ctx: QuantContext) -> torch.Tensor:
        """Full forward -> logits (B, T, V)."""
        h, positions = self._embed(params, tokens)
        h, _ = self._backbone(params, ctx, h, positions)
        return self._head(params, ctx, h)

    def _ce(self, params: dict, ctx: QuantContext, h: torch.Tensor,
            labels: torch.Tensor, weights) -> torch.Tensor:
        from repro_torch.nn.losses import chunked_ce_loss
        # probe mode runs the head once over the whole sequence, so each op
        # is captured and probed once (as in the reference); so does an op
        # inventory trace, so its head operands have the probes' shapes (the
        # reference records one chunk there, and its calibration then fails
        # on a sequence longer than loss_chunk)
        return chunked_ce_loss(lambda hi: self._head(params, ctx, hi), h,
                               labels, weights, self.cfg.loss_chunk,
                               no_scan=(ctx.mode == "probe"
                                        or ctx.registry is not None))

    def loss(self, params: dict, batch: dict,
             ctx: QuantContext) -> torch.Tensor:
        """Cross-entropy, plus ``mtp_weight`` x the multi-token prediction
        loss when ``mtp_depth`` > 0, plus the MoE layers' aux loss."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        weights = batch.get("weights")
        h, positions = self._embed(params, tokens)
        h, aux = self._backbone(params, ctx, h, positions)
        loss = self._ce(params, ctx, h, labels, weights)
        if cfg.mtp_depth > 0:
            if weights is None:
                weights = torch.ones(tokens.shape, dtype=torch.float32,
                                     device=h.device)
            loss = loss + cfg.mtp_weight * self._mtp_loss(
                params, ctx, h, tokens, labels, weights)
        return loss + aux

    def _mtp_loss(self, params: dict, ctx: QuantContext, h: torch.Tensor,
                  tokens: torch.Tensor, labels: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
        """DeepSeek-V3 multi-token prediction: predict t+2 from (h_t,
        emb_{t+1}) through one more block of the last layer's kind."""
        cfg = self.cfg
        emb_next = params["embed"]["w"][labels.long()].to(self.dtype)
        hcat = torch.cat([h, emb_next], dim=-1)
        hm = qops.linear(ctx, "mtp/proj", hcat, params["mtp"]["proj"]["w"])
        hm = L.apply_norm(params["mtp"]["norm"], hm, cfg.norm)
        B, T = tokens.shape
        positions = torch.arange(T, dtype=torch.int32,
                                 device=hm.device)[None].expand(B, T)
        hm, _, _ = self._block(params["mtp"]["block"], ctx, "mtp/block",
                               cfg.layer_signature(cfg.n_layers - 1), hm,
                               positions)
        # targets: labels shifted by one more step
        tgt = F.pad(labels[:, 1:], (0, 1))
        w = F.pad(weights[:, 1:], (0, 1))
        return self._ce(params, ctx, hm, tgt, w)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    @property
    def kv_dtype(self) -> torch.dtype:
        return (torch.float8_e4m3fn if self.cfg.kv_cache_dtype == "fp8_e4m3"
                else self.dtype)

    def cache_specs(self, batch: int, max_len: int, ring_window: bool = True,
                    chunk_extra: int = 0) -> dict:
        """Flat ``layers/i@attn/<leaf>`` specs of the dense caches: KV rings
        for attention layers, full-length latents for MLA layers.
        ``ring_window=False`` keeps ``max_len`` rows for windowed layers
        (the window is then enforced by the mask alone); ``chunk_extra``
        widens windowed rings to ``window + chunk_extra`` rows, so that
        dense chunked prefill never evicts keys still in a query's window
        (engines pass their ``chunk_len``)."""
        cfg = self.cfg
        specs = {}
        for i in range(cfg.n_layers):
            leaves = (L.mla_cache_spec(cfg.mla_cfg, batch, max_len,
                                       self.kv_dtype)
                      if cfg.block_types[i] == "mla" else
                      L.kv_cache_spec(cfg.attn_cfg, batch, max_len,
                                      self.kv_dtype, ring=ring_window,
                                      chunk_extra=chunk_extra))
            for leaf, ps in leaves.items():
                specs[f"layers/{i}@attn/{leaf}"] = ps
        return specs

    def paged_cache_specs(self, n_slots: int, n_blocks: int,
                          block_size: int) -> dict:
        """Flat specs of the block-major paged store: K/V for attention
        layers, latents for MLA layers (neither keeps anything slot-major,
        so ``n_slots`` does not enter)."""
        cfg = self.cfg
        specs = {}
        for i in range(cfg.n_layers):
            leaves = (L.mla_page_spec(cfg.mla_cfg, n_blocks, block_size,
                                      self.kv_dtype)
                      if cfg.block_types[i] == "mla" else
                      L.kv_page_spec(cfg.attn_cfg, n_blocks, block_size,
                                     self.kv_dtype))
            for leaf, ps in leaves.items():
                specs[f"layers/{i}@attn/{leaf}"] = ps
        return specs

    @staticmethod
    def _materialize(specs: dict, device: torch.device) -> dict:
        out: dict = {}
        for key, s in specs.items():
            layer, leaf = key.split("@attn/")
            fill = -1 if leaf == "pos" else 0
            out.setdefault(layer, {})[leaf] = torch.full(
                s.shape, fill, dtype=s.dtype, device=device)
        return out

    def init_cache(self, batch: int, max_len: int, device: DeviceLike = None,
                   *, ring_window: bool = True, chunk_extra: int = 0) -> dict:
        return self._materialize(
            self.cache_specs(batch, max_len, ring_window=ring_window,
                             chunk_extra=chunk_extra), resolve_device(device))

    def init_paged_cache(self, n_slots: int, n_blocks: int, block_size: int,
                         device: DeviceLike = None) -> dict:
        return self._materialize(
            self.paged_cache_specs(n_slots, n_blocks, block_size),
            resolve_device(device))

    def paged_copy_block(self, caches: dict, src: int, dst: int) -> dict:
        """Copy physical block ``src`` into block ``dst`` on every page-major
        cache leaf (attention K/V, MLA latents): the pool's copy-on-write
        fork. In place, into the pool's own tensors: the paged decode step's
        CUDA graph is bound to their identity, so a copy that returned new
        tensors would force a capture on every fork. The copies run on the
        current stream, ordered after every step queued before them."""
        specs = self.paged_cache_specs(1, 1, 1)
        for key, spec in specs.items():
            if "kv_blocks" not in spec.logical_axes:
                continue
            layer, leaf = key.split("@attn/")
            t = caches[layer][leaf]
            ax = spec.logical_axes.index("kv_blocks")
            t.select(ax, int(dst)).copy_(t.select(ax, int(src)))
        return caches

    def prefill(self, params: dict, tokens: torch.Tensor, caches: dict,
                ctx: QuantContext):
        """Process the prompt into dense caches; returns (last-token logits,
        caches)."""
        h, positions = self._embed(params, tokens)
        h, _ = self._backbone(params, ctx, h, positions, caches=caches)
        return self._head(params, ctx, h[:, -1:]), caches

    def prefill_chunk(self, params: dict, tokens: torch.Tensor, caches: dict,
                      ctx: QuantContext, *, start_pos: torch.Tensor,
                      valid_len: torch.Tensor,
                      block_tables: Optional[torch.Tensor] = None,
                      chunk_ring: bool = False):
        """One padded prompt chunk for every cache row: ``tokens`` (B, Lb)
        padded to a bucket, ``start_pos`` (B,) absolute position of
        ``tokens[:, 0]`` (0 resets a dense row), ``valid_len`` (B,) real
        tokens per row (0 = row untouched). ``block_tables`` selects the
        paged layout; over dense rings ``chunk_ring`` attends the whole
        ring in logical order, so a chunk can continue a prompt (windowed
        rings need ``init_cache(chunk_extra=chunk_len)``). Returns (logits
        (B, 1, V) at each row's last valid position, caches)."""
        B, T = tokens.shape
        dev = tokens.device
        start = torch.as_tensor(start_pos, dtype=torch.int32, device=dev)
        valid = torch.as_tensor(valid_len, dtype=torch.int32, device=dev)
        emb = params["embed"]["w"][tokens.long()].to(self.dtype)
        ar = torch.arange(T, dtype=torch.int32, device=dev)[None]
        positions = start[:, None] + ar
        chunk_valid = ar < valid[:, None]
        h, _ = self._backbone(params, ctx, emb, positions, caches=caches,
                           chunk_valid=chunk_valid, chunk_start=start,
                           chunk_ring=chunk_ring, block_tables=block_tables)
        idx = torch.clamp_min(valid - 1, 0).long()   # inactive rows: garbage
        h_last = h[torch.arange(B, device=dev), idx][:, None]
        return self._head(params, ctx, h_last), caches

    def decode_step(self, params: dict, token: torch.Tensor, pos,
                    caches: dict, ctx: QuantContext, *,
                    block_tables: Optional[torch.Tensor] = None,
                    paged_attn: str = "fused"):
        """One token for every sequence. ``token`` (B, 1); ``pos`` a scalar
        for a lock-step batch or (B,) per-row positions. ``block_tables``
        (B, max_blocks) switches to the paged layout, where
        ``paged_attn="fused"`` attends through the CUDA kernel and
        ``"gather"`` through the reference path."""
        emb = params["embed"]["w"][token.long()].to(self.dtype)
        B = token.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=token.device)
        positions = (pos[:, None] if pos.dim() == 1
                     else pos.reshape(1, 1).expand(B, 1))
        h, _ = self._backbone(params, ctx, emb, positions, caches=caches,
                           cache_pos=pos, block_tables=block_tables,
                           paged_attn=paged_attn)
        return self._head(params, ctx, h), caches
