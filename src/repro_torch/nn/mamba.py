"""Mamba-2 (SSD, state-space duality) block — chunked matmul formulation
(port of ``repro/nn/mamba.py``).

The chunked SSD algorithm (Dao & Gu, arXiv:2405.21060) recasts the
selective state-space recurrence as block matmuls: intra-chunk quadratic
attention-like products plus an inter-chunk state recurrence. The four
products (``cb_matmul``, ``att_x_matmul``, ``bx_matmul``,
``c_state_matmul``) go through ``qops.bgemm``, so MP plans and calibration
cover them as they cover attention's BGEMMs. Their specs index batch and
token axes with the reserved lowercase letters ``b/c/q/k`` (per-token
activation scales keep those axes; ``repro_torch.quant.qops``).

The recurrence over chunks is a Python loop over a count fixed by the
input's shape, with no host sync, so a step that runs it records into a
CUDA graph. Decode is the O(1) recurrent update.

Under a serving mesh the block is tensor-parallel with what the rules
split over ``model``: ``in_proj``'s output is gathered whole (its packed
z/x/B/C/dt split does not fall on block boundaries), each rank runs the
depthwise conv over its block of channels and the recurrence over its
block of heads (the conv history and state hold those), the gated norm
over the gathered row, and ``out_proj`` on its block of ``d_inner``,
summed over ``model``.

Caches are ``{"conv": (B, d_conv - 1, conv_dim), "state": (B, H, P, N)
f32}``, slot-major, and updated in place (the engines' graphs are bound to
the pool's tensors). One departure that changes no value: the intra-chunk
decay ``exp(cum_q - cum_k)`` is taken only below the diagonal (``-inf``
above, whose exponential is exactly 0), where the reference exponentiates
every pair and zeroes the upper triangle afterwards; its forward bits are
the same, and an exponent past f32's range above the diagonal cannot turn
a probe's gradient into ``0 * inf``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import tp_gather, tp_slice
from repro_torch.nn.layers import apply_norm, col_linear, row_linear, row_mean
from repro_torch.nn.spec import ParamSpec
from repro_torch.quant import qops
from repro_torch.quant.qops import QuantContext

__all__ = ["SSMConfig", "mamba_specs", "apply_mamba", "mamba_cache_spec",
           "apply_mamba_decode"]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_inner: int
    d_state: int
    head_dim: int = 64
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 256

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def mamba_specs(prefix: str, cfg: SSMConfig) -> dict:
    dm, di, N, G, H = (cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_groups,
                       cfg.n_heads)
    d_in_proj = 2 * di + 2 * G * N + H  # z, x, B, C, dt
    f32 = torch.float32
    return {
        f"{prefix}/in_proj/w": ParamSpec((d_in_proj, dm),
                                         ("ssm_inner", "embed"),
                                         init="scaled_normal"),
        f"{prefix}/conv/w": ParamSpec((cfg.d_conv, cfg.conv_dim),
                                      (None, "ssm_inner"),
                                      init="scaled_normal"),
        f"{prefix}/conv/b": ParamSpec((cfg.conv_dim,), ("ssm_inner",),
                                      init="zeros"),
        f"{prefix}/A_log": ParamSpec((H,), ("ssm_heads",), f32, "zeros"),
        f"{prefix}/D": ParamSpec((H,), ("ssm_heads",), f32, "ones"),
        f"{prefix}/dt_bias": ParamSpec((H,), ("ssm_heads",), f32, "zeros"),
        f"{prefix}/norm/scale": ParamSpec((di,), ("ssm_inner",), f32,
                                          "ones"),
        f"{prefix}/out_proj/w": ParamSpec((dm, di), ("embed", "ssm_inner"),
                                          init="scaled_normal"),
    }


def _in_proj(p: dict, ctx: QuantContext, scope: str, cfg: SSMConfig,
             x: torch.Tensor) -> torch.Tensor:
    """The whole packed projection (gathered over a mesh's model axis)."""
    di, G, N = cfg.d_inner, cfg.n_groups, cfg.d_state
    full = 2 * di + 2 * G * N + cfg.n_heads
    return tp_gather(col_linear(ctx, f"{scope}/in_proj", x,
                                p["in_proj"]["w"], full), full)


def _my_heads(p: dict, cfg: SSMConfig, dim: int, xs: torch.Tensor,
              dt: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor) -> tuple:
    """This rank's block of the heads: ``xs`` / ``dt`` sliced along
    ``dim`` / the last dim, ``B_`` / ``C_`` expanded from groups to heads
    and sliced (then one group a head). The whole of them without a
    mesh."""
    Hl = p["A_log"].shape[0]
    if Hl == cfg.n_heads:
        return xs, dt, B_, C_
    rep = cfg.n_heads // cfg.n_groups
    return (tp_slice(xs, Hl, dim), tp_slice(dt, Hl, -1),
            tp_slice(torch.repeat_interleave(B_, rep, dim=dim), Hl, dim),
            tp_slice(torch.repeat_interleave(C_, rep, dim=dim), Hl, dim))


def _gated_norm(pn: dict, y: torch.Tensor) -> torch.Tensor:
    """``apply_norm`` of the whole row; with a norm scale that is a mesh
    rank's block, that block of the normed row (the same values)."""
    scale = pn["scale"]
    if scale.shape[-1] == y.shape[-1]:
        return apply_norm(pn, y)
    xf = y.float()
    yn = xf * torch.rsqrt(row_mean(xf.square()) + 1e-6)
    return (tp_slice(yn, scale.shape[-1]) * scale).to(y.dtype)


def _split_proj(cfg: SSMConfig, zxbcdt: torch.Tensor) -> tuple:
    di = cfg.d_inner
    return (zxbcdt[..., :di], zxbcdt[..., di:di + cfg.conv_dim],
            zxbcdt[..., di + cfg.conv_dim:])


def _silu_f32(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.silu(x.float()).to(dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 hist: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over time. xbc: (B, T, Cc); w: (k, Cc).
    ``hist`` (B, k-1, Cc): left context carried from an earlier prefill
    chunk (zeros give the plain zero-padded conv bit for bit)."""
    k, T = w.shape[0], xbc.shape[1]
    if hist is None:
        pad = F.pad(xbc, (0, 0, k - 1, 0))
    else:
        pad = torch.cat([hist.to(xbc.dtype), xbc], dim=1)
    out = sum(pad[:, i:i + T, :] * w[i] for i in range(k))
    return _silu_f32(out + b, xbc.dtype)


def _ssd_chunked(ctx: QuantContext, scope: str, cfg: SSMConfig,
                 x: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
                 C_: torch.Tensor, A: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None) -> tuple:
    """x: (B, T, H, P); dt: (B, T, H) f32; B_/C_: (B, T, G, N).
    Returns (y (B, T, H, P) in x's dtype, final state (B, H, P, N) f32)."""
    Bb, T, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    Q = min(cfg.chunk, T)
    nc = -(-T // Q)
    padT = nc * Q - T
    if padT:
        x = F.pad(x, (0, 0, 0, 0, 0, padT))
        dt = F.pad(dt, (0, 0, 0, padT))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, padT))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, padT))
    rep = H // G
    Bh = torch.repeat_interleave(B_, rep, dim=2)           # (B, T, H, N)
    Ch = torch.repeat_interleave(C_, rep, dim=2)
    xc = x.reshape(Bb, nc, Q, H, P)
    dtc = dt.reshape(Bb, nc, Q, H)
    Bc = Bh.reshape(Bb, nc, Q, H, N)
    Cc = Ch.reshape(Bb, nc, Q, H, N)

    dA = dtc * A                                           # A negative
    cum = torch.cumsum(dA, dim=2)                          # (B, nc, Q, H)
    cq = cum.movedim(3, 2)                                 # (B, nc, H, Q)
    below = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    diff = cq[..., :, None] - cq[..., None, :]
    L = torch.exp(torch.where(below, diff, -torch.inf))

    # scores = C_q . B_k (the SSD analogue of qk_matmul)
    scores = qops.bgemm(ctx, f"{scope}/cb_matmul", "bcqhn,bckhn->bchqk",
                        Cc, Bc)
    att = scores.float() * L * dtc.movedim(3, 2)[..., None, :]
    att = att.to(x.dtype)
    y_diag = qops.bgemm(ctx, f"{scope}/att_x_matmul", "bchqk,bckhp->bcqhp",
                        att, xc)

    # chunk states: sum_k B_k dt_k decay_k x_k -> (B, nc, H, P, N)
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)     # (B, nc, Q, H)
    Bx = (Bc * (decay_states * dtc)[..., None]).to(x.dtype)
    states = qops.bgemm(ctx, f"{scope}/bx_matmul", "bckhn,bckhp->bchpn",
                        Bx, xc)

    # inter-chunk recurrence: a loop over the (static) chunk count
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (B, nc, H)
    s = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c].float()
    prev_states = torch.stack(prev, dim=1)                # (B, nc, H, P, N)

    # off-diagonal contribution: C_q . state, scaled by the in-chunk decay
    Cdec = (Cc * torch.exp(cum)[..., None]).to(x.dtype)
    y_off = qops.bgemm(ctx, f"{scope}/c_state_matmul", "bcqhn,bchpn->bcqhp",
                       Cdec, prev_states.to(x.dtype))
    y = y_diag.float() + y_off.float()
    y = y.reshape(Bb, nc * Q, H, P)[:, :T]
    return y.to(x.dtype), s


def apply_mamba(p: dict, ctx: QuantContext, scope: str, cfg: SSMConfig,
                x: torch.Tensor, cache: Optional[dict] = None, *,
                chunk_valid: Optional[torch.Tensor] = None,
                resume: Optional[torch.Tensor] = None) -> tuple:
    """Full-sequence SSD; returns (y, cache), the cache written in place.

    Chunked or bucketed prefill: ``chunk_valid`` (B, T) marks real tokens
    of a padded chunk and ``resume`` (B,) the rows that continue an earlier
    chunk; those seed the conv with the cached ``d_conv - 1`` features and
    the recurrence with the cached state. Padded positions get dt = 0, an
    exact identity of the recurrence (decay 1, contribution 0), so a row
    with no valid token keeps its state bit for bit. Bit-exact resume also
    needs chunk boundaries at multiples of ``cfg.chunk`` (the engine
    refuses other ``chunk_len``)."""
    B, T, _ = x.shape
    H, P, G, N = cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
    zxbcdt = _in_proj(p, ctx, scope, cfg, x)
    z, xbc_raw, dt = _split_proj(cfg, zxbcdt)
    xbc_raw = tp_slice(xbc_raw, p["conv"]["w"].shape[1])   # my channels
    hist = None
    if chunk_valid is not None:
        assert cache is not None and resume is not None
        hist = torch.where(resume[:, None, None],
                           cache["conv"].to(xbc_raw.dtype),
                           torch.zeros((), dtype=xbc_raw.dtype,
                                       device=x.device))
    xbc = tp_gather(_causal_conv(xbc_raw, p["conv"]["w"], p["conv"]["b"],
                                 hist=hist), cfg.conv_dim)
    di = cfg.d_inner
    xs, dt, B_, C_ = _my_heads(
        p, cfg, 2, xbc[..., :di].reshape(B, T, H, P), dt,
        xbc[..., di:di + G * N].reshape(B, T, G, N),
        xbc[..., di + G * N:].reshape(B, T, G, N))
    dt = _softplus(dt.float() + p["dt_bias"])
    if chunk_valid is not None:
        dt = torch.where(chunk_valid[..., None], dt, 0.0)
    A = -torch.exp(p["A_log"])
    init_state = None
    if chunk_valid is not None:
        init_state = torch.where(resume[:, None, None, None],
                                 cache["state"].float(), 0.0)
    y, state = _ssd_chunked(ctx, scope, cfg, xs, dt, B_, C_, A,
                            init_state=init_state)
    y = y + xs * p["D"][:, None].to(x.dtype)
    y = tp_gather(y.reshape(B, T, -1), di)
    y = y * _silu_f32(z, x.dtype)
    y = _gated_norm(p["norm"], y)
    out = row_linear(ctx, f"{scope}/out_proj", y, p["out_proj"]["w"], di)

    if cache is not None:
        k1 = cfg.d_conv - 1
        if chunk_valid is not None:
            # each row's last k1 features before its padding, reaching
            # back into the carried history when the chunk is shorter
            ext = torch.cat([hist, xbc_raw], dim=1)
            vlen = chunk_valid.sum(dim=1)
            idx = vlen[:, None] + torch.arange(k1, device=x.device)[None]
            tail = torch.gather(ext, 1, idx[:, :, None].expand(
                B, k1, ext.shape[2]))
        else:
            tail = xbc_raw[:, -k1:, :]
            if tail.shape[1] < k1:
                tail = F.pad(tail, (0, 0, k1 - tail.shape[1], 0))
        cache["conv"].copy_(tail.to(cache["conv"].dtype))
        cache["state"].copy_(state.to(cache["state"].dtype))
    return out, cache


def mamba_cache_spec(cfg: SSMConfig, batch: int,
                     dtype=torch.bfloat16) -> dict:
    return {
        "conv": ParamSpec((batch, cfg.d_conv - 1, cfg.conv_dim),
                          ("act_batch", None, "ssm_inner"), dtype, "zeros"),
        "state": ParamSpec((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                           ("act_batch", "ssm_heads", None, None),
                           torch.float32, "zeros"),
    }


def apply_mamba_decode(p: dict, ctx: QuantContext, scope: str,
                       cfg: SSMConfig, x: torch.Tensor, cache: dict,
                       row_valid: Optional[torch.Tensor] = None) -> tuple:
    """One recurrent step. x: (B, 1, C); returns (y, cache), the cache
    written in place. ``row_valid`` (B,) bool: rows marked False keep their
    conv history and state bit for bit (vacant or mid-prefill slots of a
    continuous decode batch)."""
    B = x.shape[0]
    H, P, G, N = cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
    zxbcdt = _in_proj(p, ctx, scope, cfg, x)
    z, xbc, dt = _split_proj(cfg, zxbcdt)                  # (B, 1, *)
    w, b = p["conv"]["w"], p["conv"]["b"]
    xbc = tp_slice(xbc, w.shape[1])                        # my channels
    conv_hist = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)
    k = w.shape[0]
    conv_out = sum(conv_hist[:, i, :] * w[i] for i in range(k)) + b
    xbc1 = tp_gather(_silu_f32(conv_out, x.dtype), cfg.conv_dim)  # (B, Cc)
    di = cfg.d_inner
    xs, dt, B_, C_ = _my_heads(p, cfg, 1, xbc1[:, :di].reshape(B, H, P),
                               dt[:, 0],
                               xbc1[:, di:di + G * N].reshape(B, G, N),
                               xbc1[:, di + G * N:].reshape(B, G, N))
    if B_.shape[1] != xs.shape[1]:             # groups -> heads
        B_ = torch.repeat_interleave(B_, H // G, dim=1)
        C_ = torch.repeat_interleave(C_, H // G, dim=1)
    dt = _softplus(dt.float() + p["dt_bias"])              # (B, H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)

    state = cache["state"].float()
    dBx = torch.einsum("bhp,bhn->bhpn", dt[..., None] * xs.float(),
                       B_.float())
    state = state * dA[:, :, None, None] + dBx
    y = qops.bgemm(ctx, f"{scope}/c_state_matmul", "bhn,bhpn->bhp",
                   C_.float(), state)
    y = y + xs.float() * p["D"][:, None]
    y = tp_gather(y.reshape(B, 1, -1).to(x.dtype), di)
    y = y * _silu_f32(z, x.dtype)
    y = _gated_norm(p["norm"], y)
    out = row_linear(ctx, f"{scope}/out_proj", y, p["out_proj"]["w"], di)
    new_conv = conv_hist[:, 1:]
    if row_valid is not None:
        state = torch.where(row_valid[:, None, None, None], state,
                            cache["state"].float())
        new_conv = torch.where(row_valid[:, None, None], new_conv,
                               cache["conv"].to(new_conv.dtype))
    cache["conv"].copy_(new_conv.to(cache["conv"].dtype))
    cache["state"].copy_(state.to(cache["state"].dtype))
    return out, cache
