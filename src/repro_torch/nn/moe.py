"""Mixture-of-Experts layer (port of ``repro/nn/moe.py``): top-k routing,
capacity-based one-hot dispatch, optional shared experts (DeepSeek-V3 /
Moonlight style).

Tokens run in chunks of ``token_chunk`` (a Python loop over the reference's
``lax.scan``), so the (tokens x experts x capacity) dispatch tensors stay
bounded whatever the batch. Each chunk routes its tokens through an f32
router, keeps each expert's first ``cap`` (token, k) picks in token-major
order and drops the rest, as the reference does; the grouped expert GEMMs
go through ``qops.linear`` with 3-D weights (``"ENC,EKC->ENK"``: plain
products outside any kernel, in the reference as here).

Two departures, neither of which changes a value:

* ``torch.topk`` does not promise an order among ties, where
  ``jax.lax.top_k`` takes the lower index first; router probabilities tie
  whenever the router runs in fp8, so the top k come from a stable
  descending sort.
* ``jax.nn.one_hot`` gives a zero row for a position at or past ``cap``,
  where ``F.one_hot`` raises (and checks its input on the host): one-hots
  are comparisons with an ``arange`` here, so nothing syncs and the step
  stays capturable in a CUDA graph.

Probe mode and an op-inventory trace (``ctx.registry``) run every token in
one chunk: the probes are shaped from the trace, and in the reference the
trace records a chunk's shapes while the probes run over all tokens, so its
calibration fails past ``token_chunk`` tokens.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.nn.layers import apply_mlp, mlp_specs
from repro_torch.nn.spec import ParamSpec
from repro_torch.quant import qops
from repro_torch.quant.qops import QuantContext

__all__ = ["MoEConfig", "moe_specs", "apply_moe", "capacity",
           "route_top_k"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int
    n_shared_experts: int = 0
    d_shared_ff: int = 0
    capacity_factor: float = 1.25
    token_chunk: int = 1024       # tokens routed together (memory knob)
    router_dtype: str = "float32"
    aux_loss_weight: float = 0.001


def moe_specs(prefix: str, d_model: int, cfg: MoEConfig,
              activation: str = "swiglu") -> dict:
    E, dff = cfg.n_experts, cfg.d_expert_ff
    specs = {
        f"{prefix}/router/w": ParamSpec((E, d_model), ("experts", "embed"),
                                        torch.float32, "scaled_normal"),
        f"{prefix}/experts/gate_proj/w": ParamSpec(
            (E, dff, d_model), ("experts", "ffn", "embed"),
            init="scaled_normal"),
        f"{prefix}/experts/up_proj/w": ParamSpec(
            (E, dff, d_model), ("experts", "ffn", "embed"),
            init="scaled_normal"),
        f"{prefix}/experts/down_proj/w": ParamSpec(
            (E, d_model, dff), ("experts", "embed", "ffn"),
            init="scaled_normal"),
    }
    if cfg.n_shared_experts:
        specs.update(mlp_specs(f"{prefix}/shared", d_model,
                               cfg.d_shared_ff * cfg.n_shared_experts,
                               activation))
    return specs


def capacity(chunk: int, cfg: MoEConfig) -> int:
    """Slots per expert in a chunk of ``chunk`` tokens: the reference's
    ``max(1, int(chunk * K / E * capacity_factor))`` rounded up to a
    multiple of 8 (the rounding decides which tokens drop)."""
    cap = max(1, int(chunk * cfg.top_k / cfg.n_experts
                     * cfg.capacity_factor))
    return -(-cap // 8) * 8


def route_top_k(probs: torch.Tensor, k: int) -> tuple:
    """``(values, indices)`` of the ``k`` largest entries of each row,
    the lower index first among ties (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _one_chunk(p: dict, ctx: QuantContext, scope: str, xi: torch.Tensor,
               cfg: MoEConfig, cap: int, dtype: torch.dtype) -> tuple:
    """One chunk ``xi`` (t, C) -> (y (t, C) in ``dtype``, f32 aux)."""
    E, K = cfg.n_experts, cfg.top_k
    t = xi.shape[0]
    xf = xi.float()
    logits = qops.linear(ctx, f"{scope}/router", xf, p["router"]["w"])
    probs = torch.softmax(logits, dim=-1)                      # (t, E)
    topv, topi = route_top_k(probs, K)                         # (t, K)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    onehot = _one_hot(topi, E)                                 # (t, K, E)
    # position of each (token, k) in its expert's queue, token-major
    pos = torch.cumsum(onehot.reshape(-1, E), dim=0).reshape(t, K, E)
    pos = (pos - 1.0) * onehot                 # 0-based, 0 elsewhere
    keep = (pos < cap) & (onehot > 0)
    pos_oh = _one_hot(pos.to(torch.int32), cap)                # (t, K, E, cap)
    sel = onehot * keep
    disp = torch.einsum("tke,tkec->tec", sel, pos_oh)
    comb = torch.einsum("tk,tke,tkec->tec", topv, sel, pos_oh)
    xe = torch.einsum("tec,tC->eCc", disp, xf)
    xe = xe.permute(0, 2, 1).to(dtype)                          # (E, cap, C)
    g = qops.linear(ctx, f"{scope}/experts/gate_proj", xe,
                    p["experts"]["gate_proj"]["w"])
    u = qops.linear(ctx, f"{scope}/experts/up_proj", xe,
                    p["experts"]["up_proj"]["w"])
    h = F.silu(g.float()).to(dtype) * u
    ye = qops.linear(ctx, f"{scope}/experts/down_proj", h,
                     p["experts"]["down_proj"]["w"])            # (E, cap, C)
    yi = torch.einsum("tec,ecC->tC", comb, ye.float())
    # load-balance aux (Switch): E * sum_e f_e * P_e
    f_e = onehot.sum(1).mean(0)
    p_e = probs.mean(0)
    aux = E * torch.sum(f_e * p_e)
    return yi.to(dtype), aux


def apply_moe(p: dict, ctx: QuantContext, scope: str, x: torch.Tensor,
              cfg: MoEConfig, activation: str = "swiglu") -> tuple:
    """x: (B, T, C) -> (y, aux_loss)."""
    B, T, C = x.shape
    N = B * T
    xt = x.reshape(N, C)
    chunk = min(cfg.token_chunk, N)
    if ctx.mode == "probe" or ctx.registry is not None:
        chunk = N                  # module docstring
    n_chunks = -(-N // chunk)
    pad = n_chunks * chunk - N
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    cap = capacity(chunk, cfg)
    ys = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        yi, aux = _one_chunk(p, ctx, scope, xt[c * chunk:(c + 1) * chunk],
                             cfg, cap, x.dtype)
        ys.append(yi)
        aux_total = aux_total + aux
    y = torch.cat(ys)[:N].reshape(B, T, C)
    if cfg.n_shared_experts:
        y = y + apply_mlp(p["shared"], ctx, f"{scope}/shared", x, activation)
    return y, cfg.aux_loss_weight * aux_total / n_chunks
