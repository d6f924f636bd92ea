"""Optimizers with spec-aware state (port of ``repro/train/optim.py``).

AdamW for standard scales; Adafactor (factored second moment, no first
moment) from 100 B parameters, where full Adam state does not fit — the rule
lives in :func:`select_optimizer`. State layouts are derived from the
model's ``ParamSpec`` s (:func:`state_specs`), with the reference's flat
paths (``step``, ``mu/<path>``, ``nu/<path>``, ``vr/<path>``, ``vc/<path>``,
``v/<path>``), so a checkpoint's optimizer state moves between the two
packages by path.

:func:`apply_updates` updates params and state **in place** under
``torch.no_grad()`` (``Tensor.copy_`` and in-place arithmetic), so every
weight's ``_version`` moves and the fp8 weight cache
(:mod:`repro_torch.quant.weight_cache`) never serves codes of the weights
before the step.

Numerics follow the reference's f32 array math: the learning rate, the bias
corrections ``b1 ** t`` / ``b2 ** t`` and Adafactor's ``step ** -0.8`` are
f32 tensors, divisions by host scalars go through
:func:`repro_torch.quant.formats.true_div` (one rounding, as the reference
divides), the global gradient norm adds the leaves' sums in the
reference's leaf order (dict keys sorted at every level; over several
ranks each leaf's sum accumulated in f64 and rounded once), and the cosine of
the schedule is :func:`_cosf`, the CPU's libm ``cosf`` that the reference's
schedule calls op by op, evaluated in float64 tensor arithmetic (on the CPU
the schedule is then the reference's bit for bit).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding
from repro_torch.nn.spec import (ParamSpec, flatten_paths, sorted_leaves,
                                 tree_from_flat)
from repro_torch.quant.formats import true_div

__all__ = ["OptConfig", "select_optimizer", "init_state", "state_specs",
           "apply_updates", "lr_at", "MeshShards"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # adafactor
    decay_offset: float = 1e-30


def select_optimizer(n_params: int,
                     base: Optional[OptConfig] = None) -> OptConfig:
    base = base or OptConfig()
    if n_params >= 100e9 and base.name == "adamw":
        return dataclasses.replace(base, name="adafactor")
    return base


# glibc's single-precision sine/cosine (sysdeps/ieee754/flt-32): 2/pi
# scaled by 2^24, pi/2, the cosine and the sine polynomials
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")
_HPI = float.fromhex("0x1.921FB54442D18p0")
_C = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_S = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))


def _cosf(y: torch.Tensor) -> torch.Tensor:
    """``cosf`` of f32 ``y`` (|y| < 120) as the CPU's libm computes it: the
    argument reduced by pi/2 and a cosine or sine polynomial evaluated in
    float64, rounded once to f32. ``torch.cos`` on f32 takes another
    approximation and parts from it by an ulp in about one value of twenty,
    enough to move the schedule's learning rate. The schedule's argument
    lies in [0, pi]; larger ones take another reduction in libm."""
    x = y.double()
    # the quadrant n sits in bits 24..31 of the truncated x * 2^24 * 2/pi;
    # below 0.75 (libm compares the top 12 bits of |y| with pi/4's) there
    # is no reduction
    n = torch.div(torch.trunc(x * _HPI_INV).long() + 0x800000, 1 << 24,
                  rounding_mode="floor")
    n = torch.where(y.abs() < 0.75, torch.zeros_like(n), n)
    r = x - n.double() * _HPI
    r2 = r * r
    # cosine polynomial (n even), negated in quadrants 2 and 3
    neg = (1 - 2 * ((n >> 1) & 1)).double()
    c = [k * neg for k in _C]
    x4 = r2 * r2
    c2 = c[3] + r2 * c[4]
    c1 = c[0] + r2 * c[1]
    x6 = x4 * r2
    cos = (c1 + x4 * c[2]) + x6 * c2
    # sine polynomial (n odd) of the reduced argument, signed by quadrant:
    # + in 0 and 3, - in 1 and 2
    rs = r * (1 - 2 * ((n ^ (n >> 1)) & 1)).double()
    x3 = rs * r2
    s1 = _S[1] + r2 * _S[2]
    x7 = x3 * r2
    sin = (rs + x3 * _S[0]) + x7 * s1
    out = torch.where((n & 1) == 0, cos, sin).float()
    return torch.where(y.abs() < 2.0 ** -12, torch.ones_like(out), out)


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Warm-up then cosine decay to ``min_lr_ratio``: an f32 0-d tensor on
    ``step`` 's device (a Python int steps on the CPU)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp_max(true_div(step, float(max(cfg.warmup_steps, 1))),
                           1.0)
    prog = torch.clamp(true_div(step - cfg.warmup_steps,
                                float(max(cfg.total_steps - cfg.warmup_steps,
                                          1))), 0.0, 1.0)
    cos = 0.5 * (1 + _cosf(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def state_specs(param_specs: dict, cfg: OptConfig) -> dict:
    """Flat path -> ParamSpec dict of optimizer-state tensors."""
    out: dict = {"step": ParamSpec((), (), torch.int32, "zeros")}
    f32 = torch.float32
    for path, ps in param_specs.items():
        if cfg.name == "adamw":
            out[f"mu/{path}"] = ParamSpec(ps.shape, ps.logical_axes, f32,
                                          "zeros")
            out[f"nu/{path}"] = ParamSpec(ps.shape, ps.logical_axes, f32,
                                          "zeros")
        elif _factored(ps.shape):      # adafactor: row/col factors
            out[f"vr/{path}"] = ParamSpec(ps.shape[:-1],
                                          ps.logical_axes[:-1], f32, "zeros")
            out[f"vc/{path}"] = ParamSpec(
                ps.shape[:-2] + ps.shape[-1:],
                ps.logical_axes[:-2] + ps.logical_axes[-1:], f32, "zeros")
        else:
            out[f"v/{path}"] = ParamSpec(ps.shape, ps.logical_axes, f32,
                                         "zeros")
    return out


def init_state(param_specs: dict, cfg: OptConfig,
               device: DeviceLike = None) -> dict:
    """Zeroed optimizer state on ``device`` (nested, as the reference's)."""
    device = resolve_device(device)
    return tree_from_flat({
        path: torch.zeros(ps.shape, dtype=ps.dtype, device=device)
        for path, ps in state_specs(param_specs, cfg).items()})


# ---------------------------------------------------------------------------
# update
# ---------------------------------------------------------------------------


def _global_norm(tree: dict, shards: Optional["MeshShards"] = None
                 ) -> torch.Tensor:
    """The leaves' sums of squares added in f32 in the reference's leaf
    order, each leaf's f32 squares summed in f32 as the reference sums them.
    Over a mesh of several ranks they are summed in f64 and rounded once to
    f32 instead, so that a leaf's sum does not depend on how the mesh
    splits it (f32 partial sums would add in another order on every
    layout); one rank splits nothing, and its step keeps the f32 sums (an
    f64 sum cost llama3_1b's step 7.8 ms of device time on an H100). On a
    mesh the leaves are this rank's blocks: the sums of the leaves
    ``model`` splits are summed over it, and of the leaves ``data`` splits
    (FSDP) over ``data``; every other leaf counts once."""
    wide = shards is not None and shards.layout.data * shards.layout.model > 1
    sums = [torch.sum(torch.square(x.float()),
                      dtype=torch.float64 if wide else None)
            for _, x in sorted_leaves(tree)]
    if shards is not None and sums:
        lay = shards.layout
        paths = [path for path, _ in sorted_leaves(tree)]
        over_data = any(shards.data_split(p) for p in paths)
        keep = torch.tensor([
            (shards.model_split(p) or lay.model_index == 0)
            and (not over_data or shards.data_split(p)
                 or lay.data_index == 0) for p in paths],
            device=sums[0].device)
        vec = torch.where(keep, torch.stack(sums), 0.0)
        with sharding.serving_layout_scope(lay):
            vec = sharding.tp_sum(vec)
            if over_data:
                vec = sharding.dp_sum(vec)
        sums = list(vec.unbind())
    total = 0
    for x in sums:
        total = total + x.float()
    return torch.sqrt(total)


class MeshShards:
    """Where params and optimizer state lie on a (data, model) mesh: each
    param leaf is this rank's block under ``sharding.partition_spec`` of
    ``rules`` (the default rules when None), each state leaf its block
    under ``sharding.zero_partition_spec`` (ZeRO-1: AdamW's moments also
    split over ``data`` along their largest free dim). A data rank updates
    its block of the moments and of the param and then gathers the param
    over ``data``. A leaf the rules already split over ``data``
    (``FSDP_RULES``, ZeRO-3) keeps the param's blocks for its moments and
    is updated in place, block for block. Adafactor's factored means and
    its update's RMS span the whole leaf and are not reduced over the mesh:
    it is refused on more than one rank."""

    def __init__(self, param_specs: dict, cfg: OptConfig, mesh,
                 rules: Optional[dict] = None):
        self.layout = sharding.training_layout(mesh, rules)
        if cfg.name != "adamw" and self.layout.data * self.layout.model > 1:
            raise NotImplementedError(
                f"{cfg.name} over a {self.layout.data}x{self.layout.model} "
                f"mesh: its factored moments and update RMS span whole "
                f"leaves (ROADMAP item A9d); AdamW shards")
        self.params = {p: sharding.partition_spec(s, mesh, rules)
                       for p, s in param_specs.items()}
        self.state = {p: sharding.zero_partition_spec(s, mesh, rules)
                      for p, s in state_specs(param_specs, cfg).items()}

    @staticmethod
    def _axes(pspec: tuple, d: int) -> tuple:
        p = pspec[d] if d < len(pspec) else None
        return tuple(a for a in (p if isinstance(p, tuple) else (p,)) if a)

    def model_split(self, path: str) -> bool:
        spec = self.params[path]
        return any("model" in self._axes(spec, d) for d in range(len(spec)))

    def data_split(self, path: str) -> bool:
        """Whether the rules split the param itself over ``data`` (FSDP):
        its gradient then arrives as this rank's block, summed."""
        spec = self.params[path]
        return any("data" in self._axes(spec, d) for d in range(len(spec)))

    def zero_dim(self, path: str) -> Optional[int]:
        """The dim of ``path``'s moments that ``data`` splits (None: the
        moments are whole on every data rank)."""
        spec = self.state.get(f"mu/{path}", ())
        for d in range(len(spec)):
            if "data" in self._axes(spec, d):
                return d
        return None

    def local(self, pspecs: dict, flat: dict) -> dict:
        """This rank's block of every leaf of ``flat`` (whole tensors)."""
        lay = self.layout
        return {p: sharding.local_shard(v, pspecs[p], lay.sizes, lay.coords)
                for p, v in flat.items()}


# leaves larger than this (of rank >= 3) are updated one slice of their
# leading (stacked) dim at a time, bounding the f32 temporaries to a slice
_CHUNKED_UPDATE_BYTES = 256 * 1024 * 1024


def _update_one(cfg: OptConfig, step: torch.Tensor, lr: torch.Tensor, scale,
                p: torch.Tensor, g: torch.Tensor, st: dict) -> None:
    """The optimizer's elementwise math for one param (or one slice of a
    stacked one), written into ``p`` and the tensors of ``st``."""
    g = g.float() * scale
    pf = p.float()
    if cfg.name == "adamw":
        mu, nu = st["mu"], st["nu"]
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        t = step.float()
        one = torch.ones((), dtype=torch.float32, device=t.device)
        bc1 = 1 - torch.pow(one * cfg.b1, t)
        bc2 = 1 - torch.pow(one * cfg.b2, t)
        upd = torch.div(mu, bc1).div_(torch.div(nu, bc2).sqrt_().add_(
            cfg.eps))
    else:  # adafactor (no first moment)
        b2 = 1.0 - step.float() ** -0.8
        g2 = torch.square(g) + cfg.decay_offset
        if "vr" in st:
            vr, vc = st["vr"], st["vc"]
            vr.copy_(b2 * vr + (1 - b2) * torch.mean(g2, dim=-1))
            vc.copy_(b2 * vc + (1 - b2) * torch.mean(g2, dim=-2))
            rmean = torch.mean(vr, dim=-1, keepdim=True)
            vhat = (torch.div(vr, torch.clamp_min(rmean, 1e-30))[..., None]
                    * vc[..., None, :])
        else:
            v = st["v"]
            v.copy_(b2 * v + (1 - b2) * g2)
            vhat = v
        upd = g * torch.rsqrt(torch.clamp_min(vhat, 1e-30))
        # relative update clipping (Adafactor d=1.0; per slice when chunked)
        rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-30)
        upd = torch.div(upd, torch.clamp_min(rms, 1.0))
    if cfg.weight_decay and p.dim() >= 2:
        upd = upd + cfg.weight_decay * pf
    p.copy_((pf - lr * upd).to(p.dtype))


def _update_leaf(cfg: OptConfig, step, lr, scale, p: torch.Tensor,
                 g: torch.Tensor, st: dict) -> None:
    # vr/vc state only counts as factored if the slice stays >= 2-D
    chunk = (p.numel() * p.element_size() > _CHUNKED_UPDATE_BYTES
             and p.dim() >= 3 and p.shape[0] > 1
             and all(s.shape[:1] == p.shape[:1] for s in st.values()))
    if chunk:
        for i in range(p.shape[0]):
            _update_one(cfg, step, lr, scale, p[i], g[i],
                        {k: v[i] for k, v in st.items()})
    else:
        _update_one(cfg, step, lr, scale, p, g, st)


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict,
                  cfg: OptConfig, shards: Optional[MeshShards] = None
                  ) -> tuple:
    """One optimizer step, in place on ``params`` and ``state``. Returns
    ``(params, state, metrics)`` — the same trees, updated — with
    ``metrics`` ``{"lr", "grad_norm"}`` (0-d f32 tensors), as the
    reference returns its new trees. With ``shards`` the trees hold this
    rank's blocks (:class:`MeshShards`) and ``grads`` the whole batch's
    gradients of them (a leaf split over ``data``: its block's)."""
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    gnorm = _global_norm(grads, shards)
    scale = (torch.clamp_max(true_div(cfg.grad_clip,
                                      torch.clamp_min(gnorm, 1e-12)), 1.0)
             if cfg.grad_clip else 1.0)
    fg = flatten_paths(grads)
    fs = flatten_paths(state)
    for path, p in flatten_paths(params).items():
        st = {pre: fs[f"{pre}/{path}"] for pre in ("mu", "nu", "vr", "vc",
                                                   "v")
              if f"{pre}/{path}" in fs}
        d = None if shards is None or shards.data_split(path) \
            else shards.zero_dim(path)
        if d is None:
            _update_leaf(cfg, step, lr, scale, p, fg[path], st)
            continue
        lay = shards.layout
        n = p.shape[d] // lay.data
        blk = p.narrow(d, lay.data_index * n, n)
        _update_leaf(cfg, step, lr, scale, blk, fg[path].narrow(
            d, lay.data_index * n, n), st)
        with sharding.serving_layout_scope(lay):
            p.copy_(sharding.dp_gather(blk.movedim(d, 0)).movedim(0, d))
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}
