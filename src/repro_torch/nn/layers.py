"""Functional NN layers for the llama and DeepSeek-V3 paths (port of
``repro/nn/layers.py``).

Conventions (as in the reference):

* params are nested dicts of tensors; spec builders return flat
  ``path -> ParamSpec``;
* every quantizable matmul goes through ``repro_torch.quant.qops`` with an op
  name equal to its param-path prefix (``layers/3/attn/q_proj``), so MP plans
  written for the reference apply unchanged;
* weights are stored (out_features, in_features): ``y = x @ w^T + b``.

KV caches — two layouts share the attention math:

* dense ring (one-shot path): ``{"k": (B, W, Hkv, D), "v": ..., "pos": (B,
  W)}`` with ``pos`` the absolute position in each slot (-1 = empty);
* paged blocks (continuous serving): ``{"k": (n_blocks, block_size, Hkv,
  D), "v": ...}`` owned by a ``PagedCachePool``. Each decode row carries a
  block table (-1 = unallocated); logical position ``j*block_size + i`` lives
  at table entry ``j``, offset ``i``. Block 0 is the trash block that absorbs
  writes from vacant rows and padding.

Unlike the reference's pure functions, cache writes here update the cache
tensors in place (``index_put_``) and return the same dict: a decode step
then never copies the whole KV store.

Prompts at or beyond ``flash_min_seq`` attend through the blocked flash
attention of :mod:`repro_torch.nn.flash` (outside probe mode, as in the
reference). MLA (DeepSeek-V3's multi-head latent attention) keeps a latent
cache ``{"ckv", "kr"[, "pos"]}``; its absorbed paged decode runs the MLA form
of the paged-decode CUDA kernel.

Not ported: cross-attention, the dense chunked-prefill ring continuation
(``chunk_ring``), and the mesh branch of the paged kernel call.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.nn.spec import ParamSpec
from repro_torch.quant import qops
from repro_torch.quant.formats import cast_to, get_format, true_div
from repro_torch.quant.qops import QuantContext

__all__ = ["norm_specs", "row_mean", "apply_norm", "rope_table",
           "apply_rope", "mlp_specs", "apply_mlp", "AttnConfig", "attn_specs",
           "kv_cache_spec", "kv_page_spec", "paged_write", "paged_write_chunk",
           "paged_gather", "use_fused_paged", "paged_update_attend",
           "attention", "MLAConfig", "mla_specs", "mla_cache_spec",
           "mla_page_spec", "mla_attention"]

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_specs(prefix: str, dim: int, kind: str = "rmsnorm") -> dict:
    specs = {f"{prefix}/scale": ParamSpec((dim,), ("embed",), torch.float32,
                                          "ones")}
    if kind == "layernorm":
        specs[f"{prefix}/bias"] = ParamSpec((dim,), ("embed",), torch.float32,
                                            "zeros")
    return specs


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last dim, keepdim, summed in one fixed order: the row
    is zero-padded to a power of two and folded in halves, so each sum is
    a tree of elementwise adds. A row's mean then depends on that row
    alone. ``Tensor.mean`` picks its reduction order on the card from the
    number of rows (4 and 8 rows of 2048 sum in another order than 1024
    rows on an H100), so a token's norm, and through an fp8 rounding
    downstream its logits, would depend on how many requests share the
    batch."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    s = F.pad(x, (0, width - n)) if width != n else x
    while s.shape[-1] > 1:
        half = s.shape[-1] // 2
        s = s[..., :half] + s[..., half:]
    return s / n


def apply_norm(p: dict, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = row_mean(xf.square())
        y = xf * torch.rsqrt(var + eps) * p["scale"]
    elif kind == "layernorm":
        mu = row_mean(xf)
        var = row_mean((xf - mu).square())
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        raise ValueError(kind)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_table(positions: torch.Tensor, d_head: int, theta: float) -> tuple:
    """positions: (..., T) int -> (sin, cos) of shape (..., T, d_head//2)."""
    half = d_head // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(true_div(-math.log(theta) * ar, float(half)))
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (B, T, H, D); sin/cos: (B, T, D//2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    s = sin[..., None, :].float()
    c = cos[..., None, :].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":      # the reference's default gelu is the tanh form
        return F.gelu(x, approximate="tanh")
    if name == "relu2":     # squared ReLU
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def mlp_specs(prefix: str, d_model: int, d_ff: int, activation: str,
              bias: bool = False) -> dict:
    specs = {}
    if activation == "swiglu":
        specs[f"{prefix}/gate_proj/w"] = ParamSpec(
            (d_ff, d_model), ("ffn", "embed"), init="scaled_normal")
    specs[f"{prefix}/up_proj/w"] = ParamSpec((d_ff, d_model), ("ffn", "embed"),
                                             init="scaled_normal")
    specs[f"{prefix}/down_proj/w"] = ParamSpec(
        (d_model, d_ff), ("embed", "ffn"), init="scaled_normal")
    if bias:
        specs[f"{prefix}/up_proj/b"] = ParamSpec((d_ff,), ("ffn",),
                                                 init="zeros")
        specs[f"{prefix}/down_proj/b"] = ParamSpec((d_model,), ("embed",),
                                                   init="zeros")
    return specs


def apply_mlp(p: dict, ctx: QuantContext, scope: str, x: torch.Tensor,
              activation: str) -> torch.Tensor:
    if activation == "swiglu":
        g = qops.linear(ctx, f"{scope}/gate_proj", x, p["gate_proj"]["w"])
        u = qops.linear(ctx, f"{scope}/up_proj", x, p["up_proj"]["w"])
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        u = qops.linear(ctx, f"{scope}/up_proj", x, p["up_proj"]["w"],
                        p["up_proj"].get("b"))
        h = _act(activation, u.float()).to(x.dtype)
    return qops.linear(ctx, f"{scope}/down_proj", h, p["down_proj"]["w"],
                       p["down_proj"].get("b"))


# ---------------------------------------------------------------------------
# Attention (GQA, optional bias / sliding window)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qkv_bias: bool = False
    causal: bool = True
    rope_theta: Optional[float] = 10000.0   # None => NoPE
    window: Optional[int] = None            # sliding-window size
    flash_min_seq: int = 4096               # blocked attention above this q_len
    flash_block: int = 1024
    # per-tensor dequant multipliers for paged KV reads: ((entry, scale),
    # ...). One mapping feeds both paged read paths (the kernel's
    # in-register dequant and the gather's f32-multiply-then-cast), and
    # writes divide by it before the storage cast.
    kv_dequant_scales: Optional[tuple] = None


def attn_specs(prefix: str, cfg: AttnConfig) -> dict:
    dm, H, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    specs = {
        f"{prefix}/q_proj/w": ParamSpec((H * D, dm), ("heads", "embed"),
                                        init="scaled_normal"),
        f"{prefix}/k_proj/w": ParamSpec((Hkv * D, dm), ("heads", "embed"),
                                        init="scaled_normal"),
        f"{prefix}/v_proj/w": ParamSpec((Hkv * D, dm), ("heads", "embed"),
                                        init="scaled_normal"),
        f"{prefix}/o_proj/w": ParamSpec((dm, H * D), ("embed", "heads"),
                                        init="scaled_normal"),
    }
    if cfg.qkv_bias:
        for n, width in (("q_proj", H * D), ("k_proj", Hkv * D),
                         ("v_proj", Hkv * D)):
            specs[f"{prefix}/{n}/b"] = ParamSpec((width,), ("heads",),
                                                 init="zeros")
    return specs


def kv_cache_spec(cfg: AttnConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, ring: bool = True) -> dict:
    """Dense ring: ``W = min(max_len, window)`` rows (``ring=False`` keeps
    ``max_len``; the window is then enforced by the mask alone)."""
    W = (max_len if (cfg.window is None or not ring)
         else min(max_len, cfg.window))
    axes = ("act_batch", None, "kv_heads", "head_dim")
    return {
        "k": ParamSpec((batch, W, cfg.n_kv_heads, cfg.d_head), axes, dtype,
                       "zeros"),
        "v": ParamSpec((batch, W, cfg.n_kv_heads, cfg.d_head), axes, dtype,
                       "zeros"),
        "pos": ParamSpec((batch, W), ("act_batch", None), torch.int32,
                         "zeros"),
    }


def kv_page_spec(cfg: AttnConfig, n_blocks: int, block_size: int,
                 dtype=torch.bfloat16) -> dict:
    """Paged KV storage: ``n_blocks`` physical blocks of ``block_size``
    tokens, shared by all decode rows through block tables."""
    axes = ("kv_blocks", None, "kv_heads", "head_dim")
    return {
        "k": ParamSpec((n_blocks, block_size, cfg.n_kv_heads, cfg.d_head),
                       axes, dtype, "zeros"),
        "v": ParamSpec((n_blocks, block_size, cfg.n_kv_heads, cfg.d_head),
                       axes, dtype, "zeros"),
    }


def paged_write_chunk(cache: dict, tensors: dict, block_tables: torch.Tensor,
                      positions: torch.Tensor, valid: torch.Tensor) -> dict:
    """Scatter a whole prefill chunk into each row's physical blocks.
    ``positions`` (B, T) absolute positions; ``valid`` (B, T) bool — padded
    entries, vacant rows and unallocated pages go to the trash block 0."""
    bs = next(iter(cache.values())).shape[1]
    nb = block_tables.shape[1]
    page_idx = torch.clamp(positions.long() // bs, 0, nb - 1)
    page = torch.gather(block_tables.long(), 1, page_idx)         # (B, T)
    page = torch.where(valid, page, torch.full_like(page, -1)).clamp_min(0)
    off = positions.long() % bs
    for name, t in tensors.items():
        cache[name].index_put_((page, off), cast_to(t, cache[name].dtype))
    return cache


def paged_write(cache: dict, tensors: dict, block_tables: torch.Tensor,
                cache_pos: torch.Tensor) -> dict:
    """Scatter one new token per decode row into its physical block. Rows
    with an unallocated page (-1, e.g. vacant slots) write the trash block."""
    bs = next(iter(cache.values())).shape[1]
    B = block_tables.shape[0]
    cp = torch.as_tensor(cache_pos, device=block_tables.device).long()
    cp = cp.expand(B) if cp.dim() == 0 else cp
    page = torch.gather(block_tables.long(), 1, (cp // bs)[:, None])[:, 0]
    page = page.clamp_min(0)
    off = cp % bs
    for name, t in tensors.items():
        cache[name].index_put_((page, off), cast_to(t[:, 0],
                                                    cache[name].dtype))
    return cache


def paged_gather(cache: dict, block_tables: torch.Tensor, dtype,
                 scales: Optional[dict] = None) -> tuple:
    """Gather each row's blocks into logical order: (B, S, ...) tensors plus
    the (B, S) logical key positions (S = max_blocks * block_size). Entries
    past a row's length read stale or trash data; the causal mask removes
    them. ``scales`` applies the kernel's dequant semantics (f32 multiply,
    cast; a unit scale is a plain cast)."""
    bs = next(iter(cache.values())).shape[1]
    B, nb = block_tables.shape
    bt = block_tables.clamp_min(0).long()

    def deq(name, arr):
        g = arr[bt].reshape(B, nb * bs, *arr.shape[2:])
        s = 1.0 if scales is None else float(scales.get(name, 1.0))
        if s == 1.0:
            return g.to(dtype)
        return (g.float() * s).to(dtype)

    out = {name: deq(name, arr) for name, arr in cache.items()}
    kp = torch.arange(nb * bs, dtype=torch.int32,
                      device=block_tables.device)[None].expand(B, nb * bs)
    return out, kp


def use_fused_paged(ctx: QuantContext, scope: str, paged_attn: str) -> bool:
    """THE paged-decode kernel switch. The kernel replaces the reference
    path's two quantizable BGEMMs (``qk_matmul`` / ``av_matmul``), so it only
    serves layers where those run at full precision; probe mode and op
    inventory traces need the ``qops`` entry points and stay on gather."""
    assert paged_attn in ("fused", "gather"), paged_attn
    if paged_attn != "fused":
        return False
    if ctx.mode == "probe" or ctx.registry is not None:
        return False
    if ctx.mode == "mp":
        for op in ("qk_matmul", "av_matmul"):
            if get_format(ctx.format_for(f"{scope}/{op}")).is_quantized:
                return False
    return True


def paged_update_attend(cache: dict, tensors: dict, block_tables, positions,
                        cache_pos, chunk_valid, dtype, *, fused: bool,
                        scales: Optional[dict] = None) -> tuple:
    """Write the fresh K/V — one decode token (``cache_pos``) or a prefill
    chunk (``chunk_valid``) — into physical blocks, then gather the logical
    ``(B, S)`` layout (``(cache, g, kp)``), or for a fused decode step return
    ``(cache, None, None)``. Non-unit ``scales`` divide the fresh K/V in f32
    before the storage cast; fp8 storage saturates at the format's finite
    max (e4m3fn has no inf; an overflow would store NaN)."""
    if scales:
        tensors = {name: (t if float(scales.get(name, 1.0)) == 1.0
                          else true_div(t.float(), float(scales[name])))
                   for name, t in tensors.items()}

    def _saturate(name, t):
        cd = cache[name].dtype
        if cd.itemsize == 1 and cd.is_floating_point:
            fmax = float(torch.finfo(cd).max)
            return torch.clamp(t.float(), -fmax, fmax)
        return t

    tensors = {name: _saturate(name, t) for name, t in tensors.items()}
    if chunk_valid is not None:
        cache = paged_write_chunk(cache, tensors, block_tables, positions,
                                  chunk_valid)
    else:
        assert cache_pos is not None, "paged attention is decode-only"
        cache = paged_write(cache, tensors, block_tables, cache_pos)
        if fused:
            return cache, None, None
    g, kp = paged_gather(cache, block_tables, dtype, scales)
    return cache, g, kp


def _fused_paged_attention(cfg: AttnConfig, q: torch.Tensor, cache: dict,
                           block_tables: torch.Tensor,
                           positions: torch.Tensor, window,
                           scales: Optional[dict] = None) -> torch.Tensor:
    """GQA decode against block-major K/V: one kernel call per layer, no
    ``(B, S)`` gather. Returns (B, 1, H, Dv)."""
    from repro_torch.kernels.paged_attention import paged_decode_attention
    B, T, H, D = q.shape
    assert T == 1, "fused paged attention is single-query decode"
    Hkv = cfg.n_kv_heads
    qk = q.reshape(B, Hkv, H // Hkv, D)
    lengths = (positions[:, 0] + 1).to(torch.int32)
    sc = scales or {}
    o = paged_decode_attention(
        qk, cache["k"], cache["v"], block_tables.to(torch.int32), lengths,
        window=window, scale=math.sqrt(D), scale_mode="div",
        score_dtype=q.dtype, probs_dtype=q.dtype,
        k_scale=float(sc.get("k", 1.0)), v_scale=float(sc.get("v", 1.0)),
        out_dtype=q.dtype)
    return o.reshape(B, 1, H, o.shape[-1])


def _split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, d)


def _cache_roundtrip(t: torch.Tensor, cache_leaf: torch.Tensor,
                     dtype) -> torch.Tensor:
    """Pass fresh prefill K/V through the cache storage dtype before
    attending, so prefill sees exactly what later cache reads see."""
    if cache_leaf.dtype == t.dtype:
        return t
    return cast_to(t, cache_leaf.dtype).to(dtype)


def _cache_write_chunk(cache: dict, tensors: dict, positions: torch.Tensor,
                       valid: torch.Tensor, start: torch.Tensor) -> dict:
    """Masked bucketed-prefill write into the dense ring. Rows with start == 0
    get their ``pos`` ring reset to -1 first; rows with no valid entries are
    left untouched; only each row's last W valid entries are kept."""
    B, T = positions.shape
    W = cache["pos"].shape[1]
    end = start + valid.sum(dim=1).to(torch.int32)                 # (B,)
    keep = valid & (positions >= (end - W)[:, None])
    bidx = torch.arange(B, device=positions.device)[:, None].expand(B, T)
    rows, slots = bidx[keep], (positions.long() % W)[keep]
    cache["pos"].masked_fill_((start == 0)[:, None], -1)
    cache["pos"].index_put_((rows, slots), positions[keep].to(torch.int32))
    for name, t in tensors.items():
        cache[name].index_put_((rows, slots),
                               cast_to(t[keep], cache[name].dtype))
    return cache


def _cache_write(cache: dict, tensors: dict, positions: torch.Tensor,
                 cache_pos: Optional[torch.Tensor]) -> dict:
    """Write T new entries into the ring buffer. positions: (B, T)."""
    first = next(iter(tensors.values()))
    B, T = first.shape[0], first.shape[1]
    W = cache["pos"].shape[1]
    if cache_pos is None and T <= W:
        # prefill, fits: contiguous write at slot 0
        for name, t in tensors.items():
            cache[name][:, :T] = cast_to(t, cache[name].dtype)
        cache["pos"].fill_(-1)
        cache["pos"][:, :T] = positions.to(torch.int32)
    elif cache_pos is None:
        # prefill longer than the window: keep the last W entries
        idx = (positions[0, T - W:] % W).long()
        for name, t in tensors.items():
            cache[name][:, idx] = cast_to(t[:, T - W:], cache[name].dtype)
        cache["pos"][:, idx] = positions[:, T - W:].to(torch.int32)
    else:
        cp = torch.as_tensor(cache_pos, device=first.device).long()
        slot = (cp % W).expand(B) if cp.dim() == 0 else cp % W
        bidx = torch.arange(B, device=first.device)
        for name, t in tensors.items():
            cache[name].index_put_((bidx, slot),
                                   cast_to(t[:, 0], cache[name].dtype))
        cache["pos"].index_put_((bidx, slot), positions[:, 0].to(torch.int32))
    return cache


def _mask_from_pos(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                   window, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, Tq, Tk) boolean mask."""
    m = k_pos[:, None, :] >= 0
    if causal:
        m = m & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        m = m & (k_pos[:, None, :] > (q_pos[:, :, None] - window))
    if valid is not None:
        m = m & valid[:, None, :]
    return m


def attention(p: dict, ctx: QuantContext, scope: str, cfg: AttnConfig,
              x: torch.Tensor, positions: torch.Tensor, *,
              cache: Optional[dict] = None,
              cache_pos: Optional[torch.Tensor] = None,
              block_tables: Optional[torch.Tensor] = None,
              chunk_valid: Optional[torch.Tensor] = None,
              chunk_start: Optional[torch.Tensor] = None,
              window: Union[None, int, str] = "cfg",
              paged_attn: str = "fused"):
    """Self-attention; returns (y, cache).

    * no cache: training / full forward;
    * dense cache: prefill (``cache_pos`` None) or decode (``cache_pos``
      scalar or (B,));
    * bucketed prefill: ``chunk_valid`` (B, T) marks real tokens of a padded
      chunk starting at ``chunk_start`` (B,); paged caches take the chunk
      straight into blocks and attend the gathered logical layout;
    * paged decode: ``block_tables`` with a block-major cache — the new
      token is scattered into its page and, with ``paged_attn="fused"``,
      attended in place by the CUDA kernel; ``"gather"`` keeps the reference
      path. Layers whose attention BGEMMs carry an MP format always gather.
    """
    B, T, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if isinstance(window, str) and window == "cfg":
        window = cfg.window
    q = _split_heads(qops.linear(ctx, f"{scope}/q_proj", x, p["q_proj"]["w"],
                                 p["q_proj"].get("b")), H, D)
    k = _split_heads(qops.linear(ctx, f"{scope}/k_proj", x, p["k_proj"]["w"],
                                 p["k_proj"].get("b")), Hkv, D)
    v = _split_heads(qops.linear(ctx, f"{scope}/v_proj", x, p["v_proj"]["w"],
                                 p["v_proj"].get("b")), Hkv, D)
    if cfg.rope_theta is not None:
        sin, cos = rope_table(positions, D, cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)

    y_fused = None
    if cache is not None and block_tables is not None:
        fused = (chunk_valid is None and cfg.causal
                 and use_fused_paged(ctx, scope, paged_attn))
        kv_scales = dict(cfg.kv_dequant_scales or ())
        cache, g, kp = paged_update_attend(
            cache, {"k": k, "v": v}, block_tables, positions, cache_pos,
            chunk_valid, x.dtype, fused=fused, scales=kv_scales)
        if g is None:
            y_fused = _fused_paged_attention(cfg, q, cache, block_tables,
                                             positions, window,
                                             scales=kv_scales)
        else:
            k, v = g["k"], g["v"]
    elif cache is not None and chunk_valid is not None:
        cache = _cache_write_chunk(cache, {"k": k, "v": v}, positions,
                                   chunk_valid, chunk_start)
        k = _cache_roundtrip(k, cache["k"], x.dtype)
        v = _cache_roundtrip(v, cache["v"], x.dtype)
        kp = positions
    elif cache is not None:
        cache = _cache_write(cache, {"k": k, "v": v}, positions, cache_pos)
        if cache_pos is not None:
            # decode: attend over the ring buffer (upcast fp8 caches)
            k, v = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
            kp = cache["pos"]
        else:
            k = _cache_roundtrip(k, cache["k"], x.dtype)
            v = _cache_roundtrip(v, cache["v"], x.dtype)
            kp = positions
    else:
        kp = positions

    # flash for self-attention prefill and training; bucketed prefill never
    # flashes (bucket padding must not move a prompt across flash_min_seq:
    # the engines route such prompts to the per-length prefill instead)
    use_flash = (y_fused is None and cache_pos is None
                 and T >= cfg.flash_min_seq and ctx.mode != "probe"
                 and block_tables is None and chunk_valid is None
                 and T == k.shape[1])
    if y_fused is not None:
        y = y_fused
    elif use_flash:
        from repro_torch.nn.flash import flash_attention
        y = flash_attention(ctx, scope, q, k, v, positions,
                            causal=cfg.causal, window=window,
                            block=cfg.flash_block)
    else:
        mask = _mask_from_pos(positions, kp, cfg.causal, window, None)
        y = _reference_attention(ctx, scope, q, k, v, mask)
    y = y.reshape(B, T, H * D)
    y = qops.linear(ctx, f"{scope}/o_proj", y, p["o_proj"]["w"])
    return y, cache


def _reference_attention(ctx, scope, q, k, v, mask):
    """Materialized-scores attention: scores are the ``qk_matmul`` output in
    the activation dtype (bf16 rounding kept), probabilities are cast back to
    it before ``av_matmul``."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    Dv = v.shape[-1]
    qg = q.reshape(B, T, Hkv, G, D)
    scores = qops.bgemm(ctx, f"{scope}/qk_matmul", "BTKGD,BSKD->BKGTS", qg, k)
    scores = true_div(scores.float(), math.sqrt(D))
    neg = torch.finfo(torch.float32).min
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.full_like(scores, neg))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    y = qops.bgemm(ctx, f"{scope}/av_matmul", "BKGTS,BSKD->BTKGD", probs, v)
    return y.reshape(B, T, H, Dv)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    flash_min_seq: int = 4096
    flash_block: int = 1024
    # decode-time weight absorption (DeepSeek's own serving optimization):
    # score and attend in the latent space instead of re-expanding per-head
    # K/V over the whole cache every step
    absorb_decode: bool = False
    # paged KV-read dequant multipliers (entries "ckv", "kr"), as in
    # AttnConfig.kv_dequant_scales; non-unit scales take the gather path
    kv_dequant_scales: Optional[tuple] = None


def mla_specs(prefix: str, cfg: MLAConfig) -> dict:
    dm, H = cfg.d_model, cfg.n_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        f"{prefix}/q_a_proj/w": ParamSpec((r_q, dm), (None, "embed"),
                                          init="scaled_normal"),
        f"{prefix}/q_norm/scale": ParamSpec((r_q,), (None,), torch.float32,
                                            "ones"),
        f"{prefix}/q_b_proj/w": ParamSpec((H * (dn + dr), r_q),
                                          ("heads", None),
                                          init="scaled_normal"),
        f"{prefix}/kv_a_proj/w": ParamSpec((r_kv + dr, dm), (None, "embed"),
                                           init="scaled_normal"),
        f"{prefix}/kv_norm/scale": ParamSpec((r_kv,), (None,), torch.float32,
                                             "ones"),
        f"{prefix}/kv_b_proj/w": ParamSpec((H * (dn + dv), r_kv),
                                           ("heads", None),
                                           init="scaled_normal"),
        f"{prefix}/o_proj/w": ParamSpec((dm, H * dv), ("embed", "heads"),
                                        init="scaled_normal"),
    }


def mla_cache_spec(cfg: MLAConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> dict:
    """Dense latent cache: full length (MLA layers have no window)."""
    return {
        "ckv": ParamSpec((batch, max_len, cfg.kv_lora_rank),
                         ("act_batch", "kv_seq", "kv_lora"), dtype, "zeros"),
        "kr": ParamSpec((batch, max_len, cfg.qk_rope_dim),
                        ("act_batch", "kv_seq", None), dtype, "zeros"),
        "pos": ParamSpec((batch, max_len), ("act_batch", "kv_seq"),
                         torch.int32, "zeros"),
    }


def mla_page_spec(cfg: MLAConfig, n_blocks: int, block_size: int,
                  dtype=torch.bfloat16) -> dict:
    """Paged latent storage (see :func:`kv_page_spec`): (512 + 64) values a
    token and layer at DeepSeek-V3's widths."""
    return {
        "ckv": ParamSpec((n_blocks, block_size, cfg.kv_lora_rank),
                         ("kv_blocks", None, "kv_lora"), dtype, "zeros"),
        "kr": ParamSpec((n_blocks, block_size, cfg.qk_rope_dim),
                        ("kv_blocks", None, None), dtype, "zeros"),
    }


def mla_attention(p: dict, ctx: QuantContext, scope: str, cfg: MLAConfig,
                  x: torch.Tensor, positions: torch.Tensor, *,
                  cache: Optional[dict] = None,
                  cache_pos: Optional[torch.Tensor] = None,
                  block_tables: Optional[torch.Tensor] = None,
                  chunk_valid: Optional[torch.Tensor] = None,
                  chunk_start: Optional[torch.Tensor] = None,
                  paged_attn: str = "fused"):
    """MLA over a latent cache ``{"ckv", "kr"[, "pos"]}``; returns (y,
    cache). Branches as :func:`attention`. Chunk attention always takes the
    expanded (non-absorbed) path, as one-shot prefill does. Paged *absorbed*
    decode takes the MLA form of the paged kernel by default
    (``paged_attn="fused"``), scoring and attending the block-major latents
    in place; the expanded decode re-expands per-head K/V over the whole
    cache and therefore always gathers."""
    B, T, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim

    qa = qops.linear(ctx, f"{scope}/q_a_proj", x, p["q_a_proj"]["w"])
    qa = apply_norm(p["q_norm"], qa)
    q = qops.linear(ctx, f"{scope}/q_b_proj", qa, p["q_b_proj"]["w"])
    q = q.reshape(B, T, H, dn + dr)
    qn, qr = q[..., :dn], q[..., dn:]

    kva = qops.linear(ctx, f"{scope}/kv_a_proj", x, p["kv_a_proj"]["w"])
    ckv, kr = kva[..., :cfg.kv_lora_rank], kva[..., cfg.kv_lora_rank:]
    ckv = apply_norm(p["kv_norm"], ckv)

    sin, cos = rope_table(positions, dr, cfg.rope_theta)
    qr = apply_rope(qr, sin, cos)
    kr = apply_rope(kr[:, :, None, :], sin, cos)[:, :, 0, :]

    if cache is not None and block_tables is not None:
        # non-unit dequant scales take the gather path: the kernel's f32
        # dequant point cannot reproduce the gather path's bf16 rounding
        kv_scales = dict(cfg.kv_dequant_scales or ())
        unit_scales = all(float(kv_scales.get(n, 1.0)) == 1.0
                          for n in ("ckv", "kr"))
        fused = (chunk_valid is None and cfg.absorb_decode and unit_scales
                 and use_fused_paged(ctx, scope, paged_attn))
        cache, g, kp = paged_update_attend(
            cache, {"ckv": ckv, "kr": kr}, block_tables, positions,
            cache_pos, chunk_valid, x.dtype, fused=fused, scales=kv_scales)
        if g is None:
            return _mla_decode_absorbed_paged(p, ctx, scope, cfg, qn, qr,
                                              cache, block_tables, positions,
                                              scales=kv_scales)
        ckv, kr = g["ckv"], g["kr"]
        if chunk_valid is None and cfg.absorb_decode:
            return _mla_decode_absorbed(p, ctx, scope, cfg, qn, qr, ckv, kr,
                                        positions, kp, cache)
    elif cache is not None and chunk_valid is not None:
        cache = _cache_write_chunk(cache, {"ckv": ckv, "kr": kr}, positions,
                                   chunk_valid, chunk_start)
        ckv = _cache_roundtrip(ckv, cache["ckv"], x.dtype)
        kr = _cache_roundtrip(kr, cache["kr"], x.dtype)
        kp = positions
    elif cache is not None:
        cache = _cache_write(cache, {"ckv": ckv, "kr": kr}, positions,
                             cache_pos)
        if cache_pos is not None:
            ckv = cache["ckv"].to(x.dtype)
            kr = cache["kr"].to(x.dtype)
            kp = cache["pos"]
            if cfg.absorb_decode:
                return _mla_decode_absorbed(p, ctx, scope, cfg, qn, qr, ckv,
                                            kr, positions, kp, cache)
        else:
            ckv = _cache_roundtrip(ckv, cache["ckv"], x.dtype)
            kr = _cache_roundtrip(kr, cache["kr"], x.dtype)
            kp = positions
    else:
        kp = positions

    # expand the latents to per-head K (nope part) and V
    kvb = qops.linear(ctx, f"{scope}/kv_b_proj", ckv, p["kv_b_proj"]["w"])
    S = ckv.shape[1]
    kvb = kvb.reshape(B, S, H, dn + dv)
    kn, v = kvb[..., :dn], kvb[..., dn:]
    qf = torch.cat([qn, qr], dim=-1)
    kf = torch.cat([kn, kr[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    use_flash = (cache_pos is None and T >= cfg.flash_min_seq and T == S
                 and block_tables is None and chunk_valid is None)
    if use_flash:
        from repro_torch.nn.flash import flash_attention
        y = flash_attention(ctx, scope, qf, kf, v, positions, causal=True,
                            window=None, block=cfg.flash_block)
    else:
        mask = _mask_from_pos(positions, kp, True, None, None)
        y = _reference_attention(ctx, scope, qf, kf, v, mask)
    y = y.reshape(B, T, H * dv)
    y = qops.linear(ctx, f"{scope}/o_proj", y, p["o_proj"]["w"])
    return y, cache


def _absorb_weights(p: dict, cfg: MLAConfig) -> tuple:
    """W_uk (H, dn, r) and W_uv (H, dv, r) in f32 from ``kv_b_proj``."""
    H, dn, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    wkv = p["kv_b_proj"]["w"].reshape(H, dn + dv,
                                      cfg.kv_lora_rank).float()
    return wkv[:, :dn, :], wkv[:, dn:, :]


def _mla_decode_absorbed(p, ctx, scope, cfg: MLAConfig, qn, qr, ckv, kr,
                         positions, kp, cache):
    """Latent-space MLA decode: W_uk absorbed into q, W_uv into the output.
    scores = (qn W_uk) . ckv + qr . kr over the latent cache directly, in
    f32 (the reference's operand casts)."""
    B, T, H, dn = qn.shape
    w_uk, w_uv = _absorb_weights(p, cfg)
    q_lat = qops.qeinsum(ctx, f"{scope}/q_absorb", "BTHh,Hhr->BTHr",
                         qn.float(), w_uk, kind="linear")
    s_lat = qops.bgemm(ctx, f"{scope}/qk_matmul", "BTHr,BSr->BHTS", q_lat,
                       ckv)
    s_rope = torch.einsum("BTHd,BSd->BHTS", qr.float(), kr.float())
    scale = 1.0 / math.sqrt(dn + cfg.qk_rope_dim)
    s = (s_lat.float() + s_rope) * scale
    mask = _mask_from_pos(positions, kp, True, None, None)
    s = torch.where(mask[:, None], s,
                    torch.full_like(s, torch.finfo(torch.float32).min))
    probs = torch.softmax(s, dim=-1)
    ctx_lat = qops.bgemm(ctx, f"{scope}/av_matmul", "BHTS,BSr->BTHr", probs,
                         ckv.float())
    y = qops.qeinsum(ctx, f"{scope}/v_absorb", "BTHr,Hvr->BTHv", ctx_lat,
                     w_uv, kind="linear")
    y = y.reshape(B, T, H * cfg.v_head_dim).to(qn.dtype)
    y = qops.linear(ctx, f"{scope}/o_proj", y, p["o_proj"]["w"])
    return y, cache


def _mla_decode_absorbed_paged(p, ctx, scope, cfg: MLAConfig, qn, qr, cache,
                               block_tables, positions,
                               scales: Optional[dict] = None):
    """The kernel twin of :func:`_mla_decode_absorbed`: the latent scores
    (``q_lat . ckv + qr . kr``) and the latent context run in the MLA form
    of the paged kernel against the block-major latents — one shared KV
    "head", H query heads, values read from the same ``ckv`` blocks as the
    keys. The absorb products stay on ``qops``."""
    from repro_torch.kernels.paged_attention import paged_decode_attention
    B, T, H, dn = qn.shape
    if T != 1:
        raise ValueError("fused paged MLA is single-query decode")
    sc = scales or {}
    if any(float(sc.get(n, 1.0)) != 1.0 for n in ("ckv", "kr")):
        raise ValueError(
            f"{scope}: fused absorbed MLA decode does not support non-unit "
            f"kv_dequant_scales (got {sc}); use paged_attn='gather'")
    r = cfg.kv_lora_rank
    w_uk, w_uv = _absorb_weights(p, cfg)
    q_lat = qops.qeinsum(ctx, f"{scope}/q_absorb", "BTHh,Hhr->BTHr",
                         qn.float(), w_uk, kind="linear")
    lengths = (positions[:, 0] + 1).to(torch.int32)
    ctx_lat = paged_decode_attention(
        q_lat.reshape(B, 1, H, r).contiguous(),          # (B, Hkv=1, G=H, r)
        cache["ckv"][:, :, None, :], None,               # v = ckv
        block_tables.to(torch.int32), lengths,
        q2=qr.float().reshape(B, 1, H, cfg.qk_rope_dim).contiguous(),
        k2=cache["kr"][:, :, None, :],
        scale=1.0 / math.sqrt(dn + cfg.qk_rope_dim), scale_mode="mul",
        out_dtype=torch.float32)
    ctx_lat = ctx_lat.reshape(B, T, H, r)
    y = qops.qeinsum(ctx, f"{scope}/v_absorb", "BTHr,Hvr->BTHv", ctx_lat,
                     w_uv, kind="linear")
    y = y.reshape(B, T, H * cfg.v_head_dim).to(qn.dtype)
    y = qops.linear(ctx, f"{scope}/o_proj", y, p["o_proj"]["w"])
    return y, cache
