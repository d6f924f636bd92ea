"""Decoder-only LM covering the dense, MoE, MLA, SSM and hybrid families
(port of ``repro/models/lm.py``).

Block types: ``attn`` (GQA, the llama family), ``mla`` (DeepSeek-V3's
multi-head latent attention), ``mamba`` (a Mamba-2 SSD block,
:mod:`repro_torch.nn.mamba`) and ``hybrid`` (Hymba: attention and mamba
heads in parallel on the shared input norm, averaged), each followed by a
dense MLP (none when ``d_ff`` is 0) or, for the layers in ``moe_layers``, a
Mixture-of-Experts layer (:mod:`repro_torch.nn.moe`); ``mtp_depth`` adds
DeepSeek-V3's multi-token prediction module, which only :meth:`LM.loss`
reads; ``prefix_embed`` (LLaVA) prepends a batch's ``prefix_embeds``
(precomputed patch embeddings) to the text tokens' embeddings in
``apply``, ``loss`` (whose cross-entropy covers the text positions only) and
``prefill``. ``LMConfig`` keeps every field of the reference so that every
configuration loads. Two execution modes, as in the reference:

* unrolled (the default): every layer has its own params and op names
  (``layers/3/attn/q_proj``), so per-layer MP plans apply unchanged; with
  ``remat`` each layer's body (and the MTP loss) runs under
  ``torch.utils.checkpoint`` whenever gradients are taken without caches,
  as the reference wraps it in ``jax.checkpoint``;
* ``scan_layers=True``: consecutive layers of one signature
  (:meth:`LMConfig.segments`) are stacked into segments, their params
  ``segments/{s}/...`` with a leading ``layers`` dim, walked slice by slice
  in a Python loop (the reference's ``jax.lax.scan``). Op names are per
  call site (``segments/1/attn/q_proj``), so an MP assignment keyed by a
  segment's name applies to every layer of it, each layer's slice
  quantized with its own scale. ``remat`` checkpoints each layer; with no
  caches and at least ``2 * remat_group`` layers in a segment, groups of
  ``remat_group`` layers are checkpointed as units too (the reference's
  two-level scheme), the remainder running as a plain tail. The MTP block
  keeps its own unstacked params.

Params are the nested dict of tensors that :meth:`LM.init` returns (or
``repro_torch.bridge.params_from_flat`` builds from reference weights).
Under a mesh layout whose rules split leaves over ``data`` (FSDP) each rank
holds its blocks of them, and the model gathers a leaf where it uses it
(:meth:`LM._gathered`): a layer's split leaves at the top of its body
(inside its checkpoint, so they live for one layer and the recomputation
gathers them again), the embedding table before the lookup, the head and
the final norm before theirs. Each rank computes its own rows with the
whole weights; nothing gathers an output.
Caches are nested dicts keyed by layer, as the reference assembles them:
``{"k", "v"[, "pos"]}`` for attention layers, ``{"ckv", "kr"[, "pos"]}``
for MLA layers, ``{"conv", "state"}`` (slot-major) for mamba layers and
``{"attn": {...}, "mamba": {...}}`` for hybrid layers. The flat spec keys
are ``layers/i@<attn|mamba>/<leaf>`` (``segments/s@...`` under
``scan_layers``, each leaf stacked over the segment's layers, which the
steps write slice by slice in place); :func:`cache_leaf` reads one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (current_serving_layout,
                                              data_split_dims,
                                              dp_gather_param,
                                              layer_stack_scope,
                                              serving_layout_scope,
                                              tp_gather, tp_sum)
from repro_torch.nn import layers as L
from repro_torch.nn import mamba as M
from repro_torch.nn.mamba import SSMConfig  # noqa: F401
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
                if self.scan_layers and len(set(sc)) > 1:
                    raise ValueError(
                        "scan_layers stacks layers into shared-trace "
                        "segments, so per-layer kv_dequant_scales must be "
                        "uniform — pass one global pair-tuple instead")
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
        """Dequant-scale pairs for layer ``i`` (None = unit scales).
        ``i=None`` (scan segments, the MTP block) gives the global pairs,
        or under a per-layer table its (uniform) first entry with
        ``scan_layers`` and None without."""
        sc = self.kv_dequant_scales
        if sc is None:
            return None
        if self._scales_are_per_layer(sc):
            if i is None:
                return sc[0] if self.scan_layers and sc else None
            return sc[i]
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

    def segments(self) -> list:
        """Consecutive layers grouped by signature: [(sig, [idx...]),
        ...]."""
        segs: list = []
        for i in range(self.n_layers):
            sig = self.layer_signature(i)
            if segs and segs[-1][0] == sig:
                segs[-1][1].append(i)
            else:
                segs.append((sig, [i]))
        return segs

    def scopes(self) -> list:
        """(scope, signature) of every call site of a block: one per layer
        (``layers/i``), or one per segment (``segments/s``) with
        ``scan_layers``."""
        if self.scan_layers:
            return [(f"segments/{s}", sig)
                    for s, (sig, _) in enumerate(self.segments())]
        return [(f"layers/{i}", self.layer_signature(i))
                for i in range(self.n_layers)]


def _remat(fn, on: bool, *args):
    """``fn(*args)``; with ``on`` and gradients enabled, under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward pass instead of kept, as the reference's
    ``jax.checkpoint`` of a layer's body. The gradients are the same."""
    if on and torch.is_grad_enabled():
        # the recomputation runs in the backward pass, maybe on another
        # thread: it runs under the mesh layout the forward saw
        layout = current_serving_layout()

        def body(*a):
            with serving_layout_scope(layout):
                return fn(*a)
        return torch.utils.checkpoint.checkpoint(body, *args,
                                                 use_reentrant=False)
    return fn(*args)


_BLOCKS = ("attn", "mla", "mamba", "hybrid")


def _slice(tree: dict, j: int) -> dict:
    """Layer ``j``'s views of a tree of stacked leaves (writes into a view
    land in the stack)."""
    return {k: _slice(v, j) if isinstance(v, dict) else v[j]
            for k, v in tree.items()}


def _unstack(tree: dict, n: int) -> list:
    """The ``n`` layers' trees of views of a tree of stacked params, one
    ``unbind`` per leaf: its backward stacks the layers' gradients in one
    op, where ``n`` separate slices would each add a zero-filled stack."""
    per = [dict() for _ in range(n)]
    for k, v in tree.items():
        parts = _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for j in range(n):
            per[j][k] = parts[j]
    return per


def cache_leaf(caches: dict, key: str) -> Optional[torch.Tensor]:
    """The tensor of flat cache key ``layers/i@<sub>/<leaf>`` in a cache
    tree (None where it has none): a hybrid layer nests its leaves under
    ``sub``, a single-kind layer holds them directly."""
    layer, rest = key.split("@", 1)
    sub, leaf = rest.split("/", 1)
    node = caches.get(layer)
    if node is None:
        return None
    if isinstance(node.get(sub), dict):
        node = node[sub]
    return node.get(leaf)


def cache_tensors(caches: dict):
    """Every (leaf name, tensor) of a cache tree, nested or not."""
    for name, v in caches.items():
        if isinstance(v, dict):
            yield from cache_tensors(v)
        else:
            yield name, v


def ssm_tensors(caches: dict) -> list:
    """The slot-major SSM leaves (``conv``, ``state``) of a cache tree, in
    layer order: what a step that must not advance some rows' state (a
    shadow step, a dense row between two prompt chunks) saves and puts
    back. A segment's stacked leaves (``scan_layers``) come as one view
    per layer, so that every tensor is slot-major."""
    out = []
    for key, node in caches.items():
        node = node.get("mamba", node)
        if "state" in node:
            pair = [node["conv"], node["state"]]
            if key.startswith("segments/"):
                pair = [t[j] for j in range(pair[0].shape[0]) for t in pair]
            out += pair
    return out


class LM:
    # serving capability flags (engines dispatch on these)
    cache_needs_enc_len = False
    supports_prefill_chunk = True

    def __init__(self, cfg: LMConfig):
        other = sorted(set(cfg.block_types) - set(_BLOCKS))
        if other:
            raise ValueError(f"{cfg.name}: unknown block types {other}")
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
        elif block in ("attn", "hybrid"):
            specs.update(L.attn_specs(f"{prefix}/attn", cfg.attn_cfg))
        if block in ("mamba", "hybrid"):
            specs.update(M.mamba_specs(f"{prefix}/mamba", cfg.ssm))
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
        if cfg.scan_layers:
            for s, (sig, idxs) in enumerate(cfg.segments()):
                layer = self._layer_specs(sig, f"segments/{s}")
                for path, ps in layer.items():
                    specs[path] = ParamSpec((len(idxs),) + ps.shape,
                                            ("layers",) + ps.logical_axes,
                                            ps.dtype, ps.init, ps.init_scale)
        else:
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
        attn_ops["hybrid"] = attn_ops["attn"]
        mamba_ops = ("in_proj", "out_proj", "cb_matmul", "att_x_matmul",
                     "bx_matmul", "c_state_matmul")
        moe = ("router", "experts/gate_proj", "experts/up_proj",
               "experts/down_proj")
        for scope, (block, is_moe) in self.cfg.scopes():
            ops.update(f"{scope}/attn/{n}" for n in attn_ops.get(block, ()))
            if block in ("mamba", "hybrid"):
                ops.update(f"{scope}/mamba/{n}" for n in mamba_ops)
            if is_moe:
                ops.update(f"{scope}/moe/{n}" for n in moe)
                if self.cfg.moe.n_shared_experts:
                    ops.update(f"{scope}/moe/shared/{n}" for n in mlp)
            elif self.cfg.d_ff > 0:
                ops.update(f"{scope}/mlp/{n}" for n in mlp)
        return ops

    # ------------------------------------------------------------------
    # FSDP: leaves split over data, gathered at use
    # ------------------------------------------------------------------
    def _fsdp_dims(self) -> dict:
        """``{param path: the dim data splits}`` of the leaves the current
        layout's rules split over ``data`` (empty without a layout, on a
        data axis of one rank, or under the default rules)."""
        layout = current_serving_layout()
        if layout is None or layout.data == 1 or layout.rules is None:
            return {}
        key = (layout.rules, layout.data, layout.model)
        memo = self.__dict__.setdefault("_fsdp_memo", {})
        if key not in memo:
            memo[key] = {p: d for p, d in data_split_dims(
                self.param_specs(), layout).items() if d is not None}
        return memo[key]

    def _gathered(self, tree: dict, prefix: str, ctx: QuantContext,
                  stacked: bool = False) -> tuple:
        """``tree`` (the params under ``prefix``) with every leaf that the
        layout splits over ``data`` gathered whole, and the context to run
        them under: a weight goes through ``qops.gathered_weight`` under
        its linear op's name (which may gather its codes and name the op
        in the context it returns), any other leaf through
        ``sharding.dp_gather_param``. ``stacked``: ``tree`` is one layer's
        slice of a segment's stacked leaves."""
        dims = self._fsdp_dims()
        if not dims:
            return tree, ctx

        def walk(node: dict, path: str) -> dict:
            nonlocal ctx
            out = {}
            for k, v in node.items():
                p = f"{path}/{k}"
                if isinstance(v, dict):
                    out[k] = walk(v, p)
                elif p not in dims:
                    out[k] = v
                elif k == "w":
                    out[k], ctx = qops.gathered_weight(ctx, path, v,
                                                       dims[p] - stacked)
                else:
                    out[k] = dp_gather_param(v, dims[p] - stacked)
            return out
        return walk(tree, prefix), ctx

    def _table(self, params: dict) -> torch.Tensor:
        """The embedding table, gathered whole under FSDP."""
        w = params["embed"]["w"]
        d = self._fsdp_dims().get("embed/w")
        return w if d is None else dp_gather_param(w, d)

    def _head_weight(self, params: dict, ctx: QuantContext,
                     table: Optional[torch.Tensor] = None) -> tuple:
        """The head's weight (the embedding table when tied), gathered
        whole under FSDP, and the context the head runs under
        (:meth:`_gathered`). A tied head takes ``table`` (the lookup's table)
        as it is when gradients flow through it: the lookup's and the
        head's parts of its gradient are then added on each rank before
        the one reduce-scatter, as the default rules add them before the
        step's one sum over ``data``."""
        if self.cfg.tie_embeddings:
            if table is not None and torch.is_grad_enabled() \
                    and table.requires_grad:
                return table, ctx
            path, w = "embed/w", params["embed"]["w"]
        else:
            path, w = "lm_head/w", params["lm_head"]["w"]
        d = self._fsdp_dims().get(path)
        if d is None:
            return w, ctx
        return qops.gathered_weight(ctx, "lm_head", w, d)

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _block(self, p: dict, ctx: QuantContext, scope: str, sig: tuple,
               h: torch.Tensor, positions: torch.Tensor, *, window="cfg",
               cache: Optional[dict] = None, cache_pos=None,
               block_tables: Optional[torch.Tensor] = None,
               chunk_valid: Optional[torch.Tensor] = None,
               chunk_start: Optional[torch.Tensor] = None,
               chunk_ring: bool = False, decode: bool = False,
               layer_idx: Optional[int] = None, paged_attn: str = "fused"):
        """One layer; returns (h, cache, aux), ``aux`` the MoE layer's
        f32 load-balance loss (the float 0.0 for a dense MLP, so a dense
        step launches nothing for it). ``layer_idx`` None (the MTP block)
        takes the config-wide attention settings. ``decode`` runs a mamba
        layer's recurrent step; in a paged decode a block-table row of -1
        (a vacant or mid-prefill slot) keeps its SSM state, as its K/V
        writes go to the trash block."""
        cfg = self.cfg
        block, is_moe = sig
        aux = 0.0
        hn = L.apply_norm(p["attn_norm"], h, cfg.norm)
        resume = None if chunk_start is None else chunk_start > 0
        row_valid = (block_tables[:, 0] >= 0
                     if decode and block_tables is not None else None)

        def mamba(m_cache):
            if decode:
                return M.apply_mamba_decode(p["mamba"], ctx,
                                            f"{scope}/mamba", cfg.ssm, hn,
                                            m_cache, row_valid=row_valid)
            return M.apply_mamba(p["mamba"], ctx, f"{scope}/mamba", cfg.ssm,
                                 hn, m_cache, chunk_valid=chunk_valid,
                                 resume=resume)

        def attention(a_cache):
            return L.attention(p["attn"], ctx, f"{scope}/attn",
                               cfg.attn_cfg_for(layer_idx), hn, positions,
                               cache=a_cache, cache_pos=cache_pos,
                               block_tables=block_tables,
                               chunk_valid=chunk_valid,
                               chunk_start=chunk_start, chunk_ring=chunk_ring,
                               window=window, paged_attn=paged_attn)

        if block == "mamba":
            y, cache = mamba(cache)
        elif block == "hybrid":
            ya, _ = attention(None if cache is None else cache["attn"])
            ym, _ = mamba(None if cache is None else cache["mamba"])
            y = 0.5 * (ya + ym)
        elif block == "mla":
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
            y, cache = attention(cache)
        h = h + y
        if is_moe:
            hn2 = L.apply_norm(p["mlp_norm"], h, cfg.norm)
            ym, aux = apply_moe(p["moe"], ctx, f"{scope}/moe", hn2, cfg.moe,
                                cfg.activation)
            h = h + ym
        elif cfg.d_ff > 0:
            hn2 = L.apply_norm(p["mlp_norm"], h, cfg.norm)
            h = h + L.apply_mlp(p["mlp"], ctx, f"{scope}/mlp", hn2,
                                cfg.activation, d_ff=cfg.d_ff)
        return h, cache, aux

    def _backbone(self, params: dict, ctx: QuantContext, h: torch.Tensor,
                  positions: torch.Tensor, *, caches: Optional[dict] = None,
                  cache_pos=None, block_tables=None, chunk_valid=None,
                  chunk_start=None, chunk_ring: bool = False,
                  decode: bool = False, paged_attn: str = "fused"):
        """Run every layer in a Python loop (a segment's layers slice by
        slice under ``scan_layers``); caches are updated in place. Returns
        (final-normed h, the layers' summed MoE aux loss: 0.0 without MoE
        layers)."""
        cfg = self.cfg
        kw = dict(cache_pos=cache_pos, block_tables=block_tables,
                  chunk_valid=chunk_valid, chunk_start=chunk_start,
                  chunk_ring=chunk_ring, decode=decode,
                  paged_attn=paged_attn)
        remat = cfg.remat and caches is None
        aux_total = 0.0
        if not cfg.scan_layers:
            for i in range(cfg.n_layers):
                cache_i = None if caches is None else caches[f"layers/{i}"]

                def body(p_i, h_, i=i, cache_i=cache_i):
                    with layer_stack_scope():
                        p_i, ctx_i = self._gathered(p_i, f"layers/{i}", ctx)
                        return self._block(
                            p_i, ctx_i, f"layers/{i}", cfg.layer_signature(i),
                            h_, positions, window=cfg.window_for(i),
                            cache=cache_i, layer_idx=i, **kw)

                h, _, aux_i = _remat(body, remat, params["layers"][str(i)], h)
                aux_total = aux_total + aux_i
            return self._final_norm(params, ctx, h), aux_total
        for s, (sig, idxs) in enumerate(cfg.segments()):
            scope = f"segments/{s}"
            n = len(idxs)
            p_layers = _unstack(params["segments"][str(s)], n)
            seg_cache = None if caches is None else caches[scope]

            def body(p_j, h_, j, scope=scope, sig=sig, idxs=idxs,
                     seg_cache=seg_cache):
                with layer_stack_scope():
                    p_j, ctx_j = self._gathered(p_j, scope, ctx,
                                                stacked=True)
                    return self._block(
                        p_j, ctx_j, scope, sig, h_, positions,
                        window=cfg.window_for(idxs[j]),
                        cache=(None if seg_cache is None
                               else _slice(seg_cache, j)), **kw)

            def run(lo, hi, h_, aux_, body=body, p_layers=p_layers):
                for j in range(lo, hi):
                    h_, _, aux_j = _remat(body, remat, p_layers[j], h_, j)
                    aux_ = aux_ + aux_j
                return h_, aux_

            G = cfg.remat_group
            main = (n // G) * G if G > 1 else 0
            if remat and main >= 2 * G:
                # two-level remat: each group of G layers is checkpointed as
                # a unit (its layers' inputs are recomputed from the group's
                # input in the backward pass), each layer inside it too; the
                # remainder runs as a tail of singly checkpointed layers
                for g0 in range(0, main, G):
                    h, aux_total = _remat(
                        lambda h_, a_, g0=g0, run=run: run(g0, g0 + G, h_,
                                                           a_),
                        True, h, aux_total)
                h, aux_total = run(main, n, h, aux_total)
            else:
                h, aux_total = run(0, n, h, aux_total)
        return self._final_norm(params, ctx, h), aux_total

    def _final_norm(self, params: dict, ctx: QuantContext,
                    h: torch.Tensor) -> torch.Tensor:
        return L.apply_norm(self._gathered(params["final_norm"], "final_norm",
                                           ctx)[0], h, self.cfg.norm)

    def _embed(self, params: dict, tokens: torch.Tensor,
               prefix_embeds: Optional[torch.Tensor] = None,
               table: Optional[torch.Tensor] = None) -> tuple:
        """Token embeddings (B, T, d) with ``prefix_embeds`` (B, P, d)
        prepended, and their positions 0 .. P + T - 1."""
        emb = self._lookup(params, tokens, table)
        if prefix_embeds is not None:
            emb = torch.cat([prefix_embeds.to(self.dtype), emb], dim=1)
        B, T = emb.shape[0], emb.shape[1]
        positions = torch.arange(T, dtype=torch.int32,
                                 device=emb.device)[None].expand(B, T)
        return emb, positions

    def _lookup(self, params: dict, tokens: torch.Tensor,
                table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings (from ``table``, the gathered table, when the
        caller holds it). Under a serving mesh whose model axis splits
        the vocabulary, each rank looks up the ids of its block (zeros for
        the others) and the blocks are summed: one nonzero term, exact."""
        w = self._table(params) if table is None else table
        V = self.cfg.vocab_size
        layout = current_serving_layout()
        if layout is None or w.shape[0] * layout.model != V:
            return w[tokens.long()].to(self.dtype)
        ids = tokens.long() - layout.model_index * w.shape[0]
        mine = (ids >= 0) & (ids < w.shape[0])
        emb = w[ids.clamp(0, w.shape[0] - 1)].to(self.dtype)
        emb = torch.where(mine[..., None], emb, torch.zeros_like(emb))
        return tp_sum(emb)

    def _head(self, params: dict, ctx: QuantContext, h: torch.Tensor,
              w: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits over the whole vocabulary (a mesh's blocks of it
        gathered over ``model``); ``w`` the head's weight when the caller
        holds it gathered already, ``ctx`` then the context
        :meth:`_head_weight` returned with it."""
        if w is None:
            w, ctx = self._head_weight(params, ctx)
        return tp_gather(L.col_linear(ctx, "lm_head", h, w,
                                      self.cfg.vocab_size),
                         self.cfg.vocab_size)

    def apply(self, params: dict, tokens: torch.Tensor, ctx: QuantContext,
              *, prefix_embeds: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
        """Full forward -> logits (B, P + T, V), P the prefix length."""
        h, positions = self._embed(params, tokens, prefix_embeds)
        h, _ = self._backbone(params, ctx, h, positions)
        return self._head(params, ctx, h)

    def _ce(self, params: dict, ctx: QuantContext, h: torch.Tensor,
            labels: torch.Tensor, weights,
            table: Optional[torch.Tensor] = None) -> torch.Tensor:
        from repro_torch.nn.losses import chunked_ce_loss
        # probe mode runs the head once over the whole sequence, so each op
        # is captured and probed once (as in the reference); so does an op
        # inventory trace, so its head operands have the probes' shapes (the
        # reference records one chunk there, and its calibration then fails
        # on a sequence longer than loss_chunk)
        w, hctx = self._head_weight(params, ctx, table)  # once for all chunks
        return chunked_ce_loss(lambda hi: self._head(params, hctx, hi, w), h,
                               labels, weights, self.cfg.loss_chunk,
                               no_scan=(ctx.mode == "probe"
                                        or ctx.registry is not None))

    def loss(self, params: dict, batch: dict,
             ctx: QuantContext) -> torch.Tensor:
        """Cross-entropy, plus ``mtp_weight`` x the multi-token prediction
        loss when ``mtp_depth`` > 0, plus the MoE layers' aux loss. With
        ``prefix_embeds`` in the batch the loss covers the text positions
        only."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        weights = batch.get("weights")
        prefix = batch.get("prefix_embeds")
        table = self._table(params)
        h, positions = self._embed(params, tokens, prefix, table)
        h, aux = self._backbone(params, ctx, h, positions)
        if prefix is not None:
            h = h[:, -tokens.shape[1]:]
        loss = self._ce(params, ctx, h, labels, weights, table)
        if cfg.mtp_depth > 0:
            if weights is None:
                weights = torch.ones(tokens.shape, dtype=torch.float32,
                                     device=h.device)
            loss = loss + cfg.mtp_weight * _remat(
                lambda h_: self._mtp_loss(params, ctx, h_, tokens, labels,
                                          weights, table), cfg.remat, h)
        return loss + aux

    def _mtp_loss(self, params: dict, ctx: QuantContext, h: torch.Tensor,
                  tokens: torch.Tensor, labels: torch.Tensor,
                  weights: torch.Tensor,
                  table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """DeepSeek-V3 multi-token prediction: predict t+2 from (h_t,
        emb_{t+1}) through one more block of the last layer's kind."""
        cfg = self.cfg
        mtp, ctx = self._gathered(params["mtp"], "mtp", ctx)
        emb_next = self._lookup(params, labels, table)
        hcat = torch.cat([h, emb_next], dim=-1)
        hm = qops.linear(ctx, "mtp/proj", hcat, mtp["proj"]["w"])
        hm = L.apply_norm(mtp["norm"], hm, cfg.norm)
        B, T = tokens.shape
        positions = torch.arange(T, dtype=torch.int32,
                                 device=hm.device)[None].expand(B, T)
        hm, _, _ = self._block(mtp["block"], ctx, "mtp/block",
                               cfg.layer_signature(cfg.n_layers - 1), hm,
                               positions)
        # targets: labels shifted by one more step
        tgt = F.pad(labels[:, 1:], (0, 1))
        w = F.pad(weights[:, 1:], (0, 1))
        return self._ce(params, ctx, hm, tgt, w, table)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    @property
    def kv_dtype(self) -> torch.dtype:
        return (torch.float8_e4m3fn if self.cfg.kv_cache_dtype == "fp8_e4m3"
                else self.dtype)

    def _assemble(self, one) -> dict:
        """Flat ``layers/i@<sub>/<leaf>`` specs from ``one(block) -> {sub:
        {leaf: spec}}``; under ``scan_layers`` ``segments/s@<sub>/<leaf>``,
        each stacked over the segment's layers (a leading ``layers``
        dim)."""
        specs = {}
        if self.cfg.scan_layers:
            for s, ((block, _), idxs) in enumerate(self.cfg.segments()):
                for sub, leaves in one(block).items():
                    for leaf, ps in leaves.items():
                        specs[f"segments/{s}@{sub}/{leaf}"] = ParamSpec(
                            (len(idxs),) + ps.shape,
                            ("layers",) + ps.logical_axes, ps.dtype, "zeros")
            return specs
        for i, block in enumerate(self.cfg.block_types):
            for sub, leaves in one(block).items():
                for leaf, ps in leaves.items():
                    specs[f"layers/{i}@{sub}/{leaf}"] = ps
        return specs

    def cache_specs(self, batch: int, max_len: int, ring_window: bool = True,
                    chunk_extra: int = 0) -> dict:
        """Flat ``layers/i@<attn|mamba>/<leaf>`` specs of the dense caches:
        KV rings for attention layers, full-length latents for MLA layers,
        conv history and state for mamba layers (both for hybrid ones).
        ``ring_window=False`` keeps ``max_len`` rows for windowed layers
        (the window is then enforced by the mask alone); ``chunk_extra``
        widens windowed rings to ``window + chunk_extra`` rows, so that
        dense chunked prefill never evicts keys still in a query's window
        (engines pass their ``chunk_len``)."""
        cfg = self.cfg

        def one(block) -> dict:
            out = {}
            if block == "mla":
                out["attn"] = L.mla_cache_spec(cfg.mla_cfg, batch, max_len,
                                               self.kv_dtype)
            elif block in ("attn", "hybrid"):
                out["attn"] = L.kv_cache_spec(
                    cfg.attn_cfg, batch, max_len, self.kv_dtype,
                    ring=ring_window, chunk_extra=chunk_extra)
            if block in ("mamba", "hybrid"):
                out["mamba"] = M.mamba_cache_spec(cfg.ssm, batch, self.dtype)
            return out

        return self._assemble(one)

    def paged_cache_specs(self, n_slots: int, n_blocks: int,
                          block_size: int) -> dict:
        """Flat specs for paged serving: attention K/V and MLA latents are
        block-major ``(n_blocks, block_size, ...)`` shared storage; SSM
        state has no sequence axis and stays slot-major ``(n_slots,
        ...)``."""
        cfg = self.cfg

        def one(block) -> dict:
            out = {}
            if block == "mla":
                out["attn"] = L.mla_page_spec(cfg.mla_cfg, n_blocks,
                                              block_size, self.kv_dtype)
            elif block in ("attn", "hybrid"):
                out["attn"] = L.kv_page_spec(cfg.attn_cfg, n_blocks,
                                             block_size, self.kv_dtype)
            if block in ("mamba", "hybrid"):
                out["mamba"] = M.mamba_cache_spec(cfg.ssm, n_slots,
                                                  self.dtype)
            return out

        return self._assemble(one)

    @staticmethod
    def assemble_cache_tree(flat: dict) -> dict:
        """Flat ``layers/i@<sub>/<leaf>`` keys -> the nested cache tree the
        engines carry, as the reference assembles it: a layer of one kind
        holds its leaves directly, a hybrid layer under ``"attn"`` and
        ``"mamba"``. The same structure for any leaf values (specs,
        tensors, placements)."""
        tree: dict = {}
        for key, v in flat.items():
            layer, rest = key.split("@", 1)
            sub, leaf = rest.split("/", 1)
            tree.setdefault(layer, {}).setdefault(sub, {})[leaf] = v
        return {layer: subs[next(iter(subs))] if len(subs) == 1 else subs
                for layer, subs in tree.items()}

    @classmethod
    def _materialize(cls, specs: dict, device: torch.device) -> dict:
        """The cache tree of flat specs (``pos`` rings at -1, the rest 0)."""
        return cls.assemble_cache_tree({
            key: torch.full(s.shape, -1 if key.endswith("/pos") else 0,
                            dtype=s.dtype, device=device)
            for key, s in specs.items()})

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
        fork (slot-major SSM state passes untouched). In place, into the
        pool's own tensors: the paged decode step's CUDA graph is bound to
        their identity, so a copy that returned new tensors would force a
        capture on every fork. The copies run on the
        current stream, ordered after every step queued before them."""
        specs = self.paged_cache_specs(1, 1, 1)
        for key, spec in specs.items():
            if "kv_blocks" not in spec.logical_axes:
                continue
            t = cache_leaf(caches, key)
            ax = spec.logical_axes.index("kv_blocks")
            t.select(ax, int(dst)).copy_(t.select(ax, int(src)))
        return caches

    def prefill(self, params: dict, tokens: torch.Tensor, caches: dict,
                ctx: QuantContext, *,
                prefix_embeds: Optional[torch.Tensor] = None):
        """Process the prompt (``prefix_embeds`` first, then ``tokens``) into
        dense caches; returns (last-token logits, caches)."""
        h, positions = self._embed(params, tokens, prefix_embeds)
        h, _ = self._backbone(params, ctx, h, positions, caches=caches)
        return self._head(params, ctx, h[:, -1:]), caches

    def prefill_chunk(self, params: dict, tokens: torch.Tensor, caches: dict,
                      ctx: QuantContext, *, start_pos: torch.Tensor,
                      valid_len: torch.Tensor,
                      block_tables: Optional[torch.Tensor] = None,
                      chunk_ring: bool = False):
        """One padded prompt chunk for every cache row: ``tokens`` (B, Lb)
        padded to a bucket, ``start_pos`` (B,) absolute position of
        ``tokens[:, 0]`` (0 starts a row afresh: its dense ``pos`` ring and its
        SSM state reset; a row past 0 resumes them), ``valid_len`` (B,) real
        tokens per row (0 = row untouched). ``block_tables`` selects the paged
        layout; over dense rings ``chunk_ring`` attends the whole ring in
        logical order, so a chunk can continue a prompt (windowed rings need
        ``init_cache(chunk_extra=chunk_len)``). Returns (logits (B, 1, V) at
        each row's last valid position, caches)."""
        B, T = tokens.shape
        dev = tokens.device
        start = torch.as_tensor(start_pos, dtype=torch.int32, device=dev)
        valid = torch.as_tensor(valid_len, dtype=torch.int32, device=dev)
        emb = self._lookup(params, tokens)
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
        ``"gather"`` through the reference path. Mamba layers take their
        recurrent step; in the paged layout a row whose table starts with
        -1 keeps its SSM state."""
        emb = self._lookup(params, token)
        B = token.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=token.device)
        positions = (pos[:, None] if pos.dim() == 1
                     else pos.reshape(1, 1).expand(B, 1))
        h, _ = self._backbone(params, ctx, emb, positions, caches=caches,
                              cache_pos=pos, block_tables=block_tables,
                              decode=True, paged_attn=paged_attn)
        return self._head(params, ctx, h), caches
