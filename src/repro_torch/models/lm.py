"""Decoder-only LM with dense attention or MLA blocks (port of
``repro/models/lm.py``).

Block types: ``attn`` (GQA, the llama family) and ``mla`` (DeepSeek-V3's
multi-head latent attention), each followed by a dense MLP. ``LMConfig``
keeps every field of the reference so that every configuration loads; the
features the port does not have yet — MoE layers, mamba/hybrid blocks,
``scan_layers``, ``prefix_embed`` and ``mtp_depth`` — raise
``NotImplementedError`` when the model is built. Layers run unrolled in a
Python loop, each with its own params and op names
(``layers/3/attn/q_proj``), so per-layer MP plans apply unchanged.

Params are the nested dict of tensors that :meth:`LM.init` returns (or
``repro_torch.bridge.params_from_flat`` builds from reference weights);
caches are nested dicts ``{"layers/i": {"k", "v"[, "pos"]}}`` for attention
layers and ``{"layers/i": {"ckv", "kr"[, "pos"]}}`` for MLA layers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn import layers as L
from repro_torch.nn.spec import ParamSpec, init_params, param_count
from repro_torch.quant import qops
from repro_torch.quant.formats import get_format
from repro_torch.quant.qops import QuantContext

BIG_WINDOW = 1 << 30

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The reference's MoE configuration (``repro/nn/moe.py``), kept so that
    MoE configurations load; a model with MoE layers is not built yet."""
    n_experts: int
    top_k: int
    d_expert_ff: int
    n_shared_experts: int = 0
    d_shared_ff: int = 0
    capacity_factor: float = 1.25
    token_chunk: int = 1024
    router_dtype: str = "float32"
    aux_loss_weight: float = 0.001


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

    def window_for(self, i: int) -> Optional[int]:
        if self.sliding_window is None or i in self.global_attn_layers:
            return None
        return self.sliding_window


def _unsupported(cfg: LMConfig) -> list:
    out = []
    other = sorted(set(cfg.block_types) - {"attn", "mla"})
    if other:
        out.append(f"block types {other} (mamba / hybrid)")
    if cfg.moe_layers:
        out.append("MoE layers")
    for flag in ("scan_layers", "prefix_embed", "mtp_depth"):
        if getattr(cfg, flag):
            out.append(flag)
    return out


class LM:
    # serving capability flags (engines dispatch on these)
    cache_needs_enc_len = False
    supports_prefill_chunk = True

    def __init__(self, cfg: LMConfig):
        missing = _unsupported(cfg)
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: not ported yet: {', '.join(missing)}")
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.dtype]

    # ------------------------------------------------------------------
    # specs
    # ------------------------------------------------------------------
    def _layer_specs(self, block: str, prefix: str) -> dict:
        cfg = self.cfg
        specs: dict = {}
        specs.update(L.norm_specs(f"{prefix}/attn_norm", cfg.d_model,
                                  cfg.norm))
        if block == "mla":
            specs.update(L.mla_specs(f"{prefix}/attn", cfg.mla_cfg))
        else:
            specs.update(L.attn_specs(f"{prefix}/attn", cfg.attn_cfg))
        if cfg.d_ff > 0:
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
            specs.update(self._layer_specs(cfg.block_types[i],
                                           f"layers/{i}"))
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
        for i in range(self.cfg.n_layers):
            ops.update(f"layers/{i}/attn/{n}"
                       for n in attn_ops[self.cfg.block_types[i]])
            if self.cfg.d_ff > 0:
                ops.update(f"layers/{i}/mlp/{n}" for n in mlp)
        return ops

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _block(self, p: dict, ctx: QuantContext, scope: str,
               h: torch.Tensor, positions: torch.Tensor, *, window="cfg",
               cache: Optional[dict] = None, cache_pos=None,
               block_tables: Optional[torch.Tensor] = None,
               chunk_valid: Optional[torch.Tensor] = None,
               chunk_start: Optional[torch.Tensor] = None,
               layer_idx: Optional[int] = None, paged_attn: str = "fused"):
        cfg = self.cfg
        hn = L.apply_norm(p["attn_norm"], h, cfg.norm)
        if cfg.block_types[layer_idx] == "mla":
            y, cache = L.mla_attention(p["attn"], ctx, f"{scope}/attn",
                                       cfg.mla_cfg_for(layer_idx), hn,
                                       positions, cache=cache,
                                       cache_pos=cache_pos,
                                       block_tables=block_tables,
                                       chunk_valid=chunk_valid,
                                       chunk_start=chunk_start,
                                       paged_attn=paged_attn)
        else:
            y, cache = L.attention(p["attn"], ctx, f"{scope}/attn",
                                   cfg.attn_cfg_for(layer_idx), hn,
                                   positions, cache=cache,
                                   cache_pos=cache_pos,
                                   block_tables=block_tables,
                                   chunk_valid=chunk_valid,
                                   chunk_start=chunk_start, window=window,
                                   paged_attn=paged_attn)
        h = h + y
        if cfg.d_ff > 0:
            hn2 = L.apply_norm(p["mlp_norm"], h, cfg.norm)
            h = h + L.apply_mlp(p["mlp"], ctx, f"{scope}/mlp", hn2,
                                cfg.activation)
        return h, cache

    def _backbone(self, params: dict, ctx: QuantContext, h: torch.Tensor,
                  positions: torch.Tensor, *, caches: Optional[dict] = None,
                  cache_pos=None, block_tables=None, chunk_valid=None,
                  chunk_start=None, paged_attn: str = "fused"):
        """Run every layer in a Python loop; caches are updated in place."""
        cfg = self.cfg
        for i in range(cfg.n_layers):
            cache_i = None if caches is None else caches[f"layers/{i}"]
            h, _ = self._block(params["layers"][str(i)], ctx, f"layers/{i}",
                               h, positions, window=cfg.window_for(i),
                               cache=cache_i, cache_pos=cache_pos,
                               block_tables=block_tables,
                               chunk_valid=chunk_valid,
                               chunk_start=chunk_start, layer_idx=i,
                               paged_attn=paged_attn)
        return L.apply_norm(params["final_norm"], h, cfg.norm)

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
        h = self._backbone(params, ctx, h, positions)
        return self._head(params, ctx, h)

    def loss(self, params: dict, batch: dict,
             ctx: QuantContext) -> torch.Tensor:
        from repro_torch.nn.losses import chunked_ce_loss
        h, positions = self._embed(params, batch["tokens"])
        h = self._backbone(params, ctx, h, positions)
        # probe mode runs the head once over the whole sequence, so each op
        # is captured and probed once (as in the reference); so does an op
        # inventory trace, so its head operands have the probes' shapes (the
        # reference records one chunk there, and its calibration then fails
        # on a sequence longer than loss_chunk)
        return chunked_ce_loss(lambda hi: self._head(params, ctx, hi), h,
                               batch["labels"], batch.get("weights"),
                               self.cfg.loss_chunk,
                               no_scan=(ctx.mode == "probe"
                                        or ctx.registry is not None))

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    @property
    def kv_dtype(self) -> torch.dtype:
        return (torch.float8_e4m3fn if self.cfg.kv_cache_dtype == "fp8_e4m3"
                else self.dtype)

    def cache_specs(self, batch: int, max_len: int) -> dict:
        """Flat ``layers/i@attn/<leaf>`` specs of the dense caches: KV rings
        for attention layers, full-length latents for MLA layers."""
        cfg = self.cfg
        specs = {}
        for i in range(cfg.n_layers):
            leaves = (L.mla_cache_spec(cfg.mla_cfg, batch, max_len,
                                       self.kv_dtype)
                      if cfg.block_types[i] == "mla" else
                      L.kv_cache_spec(cfg.attn_cfg, batch, max_len,
                                      self.kv_dtype))
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

    def init_cache(self, batch: int, max_len: int,
                   device: DeviceLike = None) -> dict:
        return self._materialize(self.cache_specs(batch, max_len),
                                 resolve_device(device))

    def init_paged_cache(self, n_slots: int, n_blocks: int, block_size: int,
                         device: DeviceLike = None) -> dict:
        return self._materialize(
            self.paged_cache_specs(n_slots, n_blocks, block_size),
            resolve_device(device))

    def prefill(self, params: dict, tokens: torch.Tensor, caches: dict,
                ctx: QuantContext):
        """Process the prompt into dense caches; returns (last-token logits,
        caches)."""
        h, positions = self._embed(params, tokens)
        h = self._backbone(params, ctx, h, positions, caches=caches)
        return self._head(params, ctx, h[:, -1:]), caches

    def prefill_chunk(self, params: dict, tokens: torch.Tensor, caches: dict,
                      ctx: QuantContext, *, start_pos: torch.Tensor,
                      valid_len: torch.Tensor,
                      block_tables: Optional[torch.Tensor] = None):
        """One padded prompt chunk for every cache row: ``tokens`` (B, Lb)
        padded to a bucket, ``start_pos`` (B,) absolute position of
        ``tokens[:, 0]`` (0 resets a dense row), ``valid_len`` (B,) real
        tokens per row (0 = row untouched). ``block_tables`` selects the
        paged layout. Returns (logits (B, 1, V) at each row's last valid
        position, caches)."""
        B, T = tokens.shape
        dev = tokens.device
        start = torch.as_tensor(start_pos, dtype=torch.int32, device=dev)
        valid = torch.as_tensor(valid_len, dtype=torch.int32, device=dev)
        emb = params["embed"]["w"][tokens.long()].to(self.dtype)
        ar = torch.arange(T, dtype=torch.int32, device=dev)[None]
        positions = start[:, None] + ar
        chunk_valid = ar < valid[:, None]
        h = self._backbone(params, ctx, emb, positions, caches=caches,
                           chunk_valid=chunk_valid, chunk_start=start,
                           block_tables=block_tables)
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
        h = self._backbone(params, ctx, emb, positions, caches=caches,
                           cache_pos=pos, block_tables=block_tables,
                           paged_attn=paged_attn)
        return self._head(params, ctx, h), caches
