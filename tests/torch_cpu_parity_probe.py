"""Where the port and the JAX package part on the CPU, op by op (a
diagnostic, not a test file; about 30 s):

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu \
        python tests/torch_cpu_parity_probe.py

1. DeepSeek-V3's smoke dense MLA model in bf16, dense prefill and three
   absorbed decode steps, plain: each step's max logit difference and the
   first quantizable op whose output differs while its operands are the
   same bits, with bf16 products computed two ways on the CPU — the
   operands widened to f32 (an f32 GEMM) and kept in bf16 (the bf16 GEMM,
   f32 accumulation, one rounding), the port's ``qops.einsum_f32acc``.
2. The MLA form of paged decode at DeepSeek-V3's widths: the plain version
   and the interpret-mode Pallas kernel, each against a float64
   evaluation of the same bf16 latents, beside the f32 error bound of
   ``test_torch_paged_mla._f32_error_bound``.
"""
import math

import jax.numpy as jnp
import numpy as np
import torch

import repro.quant.qops as jqops
import repro_torch.quant.qops as tqops
from test_torch_mla import _ctx, _np, _pair
from test_torch_paged_mla import (BF16, F32, _deepseek_case,
                                  _f32_error_bound, jax_paged, tpa)


def _widened(spec, lhs, rhs, out_dtype):
    return torch.einsum(spec, lhs.float(), rhs.float()).to(out_dtype)


def mla_decode(einsum) -> None:
    tqops.einsum_f32acc, keep = einsum, tqops.einsum_f32acc
    jm, jp, tm, tp = _pair("bfloat16", True)
    rec = {"j": [], "t": []}
    jq, tq = jqops.qeinsum, tqops.qeinsum

    def wrap(side, fn, conv):
        def recorded(ctx, name, spec, lhs, rhs, *a, **k):
            out = fn(ctx, name, spec, lhs, rhs, *a, **k)
            rec[side].append((name, conv(lhs), conv(rhs), conv(out),
                              "bfloat16" in str(out.dtype)))
            return out
        return recorded

    jqops.qeinsum = wrap("j", jq, lambda x: np.asarray(
        x.astype(jnp.float32)))
    tqops.qeinsum = wrap("t", tq, _np)
    try:
        rng = np.random.default_rng(2)
        B, T, steps = 2, 11, 3
        toks = rng.integers(0, 512, (B, T)).astype(np.int32)
        nxt = rng.integers(0, 512, (steps, B, 1)).astype(np.int32)
        jc = jm.init_cache(B, T + steps)
        jl, jc = jm.prefill(jp, jnp.asarray(toks), jc, _ctx(None, False))
        tc = tm.init_cache(B, T + steps, "cpu")
        tl, tc = tm.prefill(tp, torch.from_numpy(toks), tc, _ctx(None, True))
        errs = [float(np.abs(_np(tl) - _np(jl)).max())]
        for i in range(steps):
            jl, jc = jm.decode_step(jp, jnp.asarray(nxt[i]),
                                    jnp.asarray(T + i, jnp.int32), jc,
                                    _ctx(None, False))
            tl, tc = tm.decode_step(tp, torch.from_numpy(nxt[i]), T + i, tc,
                                    _ctx(None, True))
            errs.append(float(np.abs(_np(tl) - _np(jl)).max()))
    finally:
        jqops.qeinsum, tqops.qeinsum = jq, tq
        tqops.einsum_f32acc = keep
    first = next(((k, n, int((yj != yt).sum()), yj.size)
                  for k, ((n, lj, rj, yj, bf), (_, lt, rt, yt, _))
                  in enumerate(zip(rec["j"], rec["t"]))
                  if bf and np.array_equal(lj, lt) and np.array_equal(rj, rt)
                  and not np.array_equal(yj, yt)), None)
    print(f"  max |logit diff| prefill, decode 1-3: {errs}")
    print("  first bf16-output op differing on bit-equal operands: "
          + ("none" if first is None else
             f"call {first[0]} {first[1]}, {first[2]} of {first[3]} "
             f"outputs"))


def _f64(q1, q2, ckv, kr, bt, ln, scale, window) -> np.ndarray:
    """The MLA decode in float64 on the same bf16 latents."""
    B, _, H, r = q1.shape
    bs, npg = ckv.shape[1], bt.shape[1]
    idx = torch.from_numpy(bt).clamp_min(0).long()
    g = torch.from_numpy(ckv).to(BF16).double()[idx].reshape(B, npg * bs, r)
    g2 = torch.from_numpy(kr).to(BF16).double()[idx].reshape(B, npg * bs,
                                                             -1)
    s = (torch.einsum("bhd,bsd->bhs", torch.from_numpy(q1[:, 0]).double(), g)
         + torch.einsum("bhd,bsd->bhs", torch.from_numpy(q2[:, 0]).double(),
                        g2)) * scale
    kpos = torch.arange(npg * bs)[None]
    L = torch.from_numpy(ln).long()
    live = kpos < L[:, None]
    if window is not None:
        live &= kpos > (L[:, None] - 1 - window)
    p = torch.nan_to_num(torch.softmax(
        torch.where(live[:, None], s, -math.inf), dim=-1))
    return torch.einsum("bhs,bsd->bhd", p, g)[:, None].numpy()


def paged_mla() -> None:
    for seed, window in ((0, None), (1, 9)):
        q1, q2, ckv, kr, bt, ln = _deepseek_case(seed)
        kw = dict(scale=1.0 / math.sqrt(128 + 64), scale_mode="mul",
                  window=window)
        want = np.asarray(jax_paged(
            jnp.asarray(q1), jnp.asarray(ckv, jnp.bfloat16), None,
            jnp.asarray(bt), jnp.asarray(ln), q2=jnp.asarray(q2),
            k2=jnp.asarray(kr, jnp.bfloat16), out_dtype=jnp.float32,
            interpret=True, **kw))
        got = tpa.paged_decode_attention(
            torch.from_numpy(q1), torch.from_numpy(ckv).to(BF16), None,
            torch.from_numpy(bt), torch.from_numpy(ln),
            q2=torch.from_numpy(q2), k2=torch.from_numpy(kr).to(BF16),
            out_dtype=F32, **kw).numpy()
        exact = _f64(q1, q2, ckv, kr, bt, ln, kw["scale"], window)
        bound = _f32_error_bound(q1, q2, ckv, kr, bt, ln, scale=kw["scale"],
                                 window=window)
        err = np.abs(got - want)
        i = np.unravel_index(np.argmax(err - 1e-6 - 1e-4 * np.abs(want)),
                             err.shape)
        ratio = err / np.maximum(1e-4 * np.abs(want) + bound, 1e-30)
        print(f"  seed {seed} window {window}: max |plain - f64| "
              f"{np.abs(got - exact).max():.3g}, max |Pallas - f64| "
              f"{np.abs(want - exact).max():.3g}; nearest to the old bound "
              f"at {tuple(int(x) for x in i)}: value {want[i]:.6g}, plain "
              f"- f64 {got[i] - exact[i]:.3g}, Pallas - f64 "
              f"{want[i] - exact[i]:.3g}; |plain - Pallas| over the f32 "
              f"bound at most {ratio.max():.3f}")


if __name__ == "__main__":
    for label, fn in (("bf16 operands widened to f32", _widened),
                      ("bf16 operands kept (the port)",
                       tqops.einsum_f32acc)):
        print(f"MLA bf16 plain decode, {label}:")
        mla_decode(fn)
    print("MLA paged decode at DeepSeek-V3's widths:")
    paged_mla()
