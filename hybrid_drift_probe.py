"""Where fused and gather decode part on a hybrid model (on the card).

For each model below, at full width with random weights from a seeded
generator: a 128-token prefill of 4 rows into a paged cache, then 32 decode
steps on two copies of that cache, one through the fused paged-decode
kernel and one through the gather path, teacher-forced with the fused
path's tokens, eagerly. Prints each layer's attention-output difference at
the first step (identical inputs) and each step's max logit difference:
llama3_1b (the yardstick), Hymba 1.5B, Hymba's widths with attention-only
blocks, and Hymba at 8 layers. ``chip_smoke.py``'s ``LOGIT_TOL_HYBRID_MP``
rests on it. About 100 s with the kernels' build:

    python3 hybrid_drift_probe.py
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def _clone(tree: dict) -> dict:
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def drift(torch, arch: str, steps: int = 32, **ov) -> None:
    from repro_torch.launch.serve import make_model_and_params
    from repro_torch.nn import layers as L
    from repro_torch.quant.qops import QuantContext
    model, params = make_model_and_params(arch, False, "cuda", seed=0, **ov)
    cfg = model.cfg
    B, T, bs = 4, 128, 16
    n_pages = -(-(T + steps) // bs)
    caches = model.init_paged_cache(B, 1 + B * n_pages, bs, "cuda")
    bt = torch.arange(1, 1 + B * n_pages, dtype=torch.int32,
                      device="cuda").reshape(B, n_pages)
    g = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g,
                         device="cuda", dtype=torch.int32)
    ctx, attention = QuantContext(), L.attention
    errs, mags = [], []
    with torch.no_grad():
        lg, caches = model.prefill_chunk(
            params, toks, caches, ctx,
            start_pos=torch.zeros(B, dtype=torch.int32, device="cuda"),
            valid_len=torch.full((B,), T, dtype=torch.int32, device="cuda"),
            block_tables=bt)
        paths = {"fused": _clone(caches), "gather": _clone(caches)}
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        for s in range(steps):
            pos = torch.full((B,), T + s, dtype=torch.int32, device="cuda")
            outs = {}
            for path, c in paths.items():
                ys = []

                def recorded(*a, **k):
                    y, cc = attention(*a, **k)
                    ys.append(y.float())
                    return y, cc
                L.attention = recorded
                try:
                    lg, _ = model.decode_step(params, tok, pos, c, ctx,
                                              block_tables=bt,
                                              paged_attn=path)
                finally:
                    L.attention = attention
                outs[path] = (lg[:, 0].float(), ys)
            (lf, yf), (lg_, yg) = outs["fused"], outs["gather"]
            errs.append((lf - lg_).abs().max().item())
            mags.append(lg_.abs().max().item())
            if s == 0:
                print(f"{cfg.name} {ov}: first step, attention output "
                      f"|fused - gather| per layer: "
                      + " ".join(f"{(a - b).abs().max().item():.2g}"
                                 for a, b in zip(yf, yg)), flush=True)
            tok = lf.argmax(-1).to(torch.int32)[:, None]
    print(f"{cfg.name} {ov}: max |logit| {max(mags):.3f}; max |fused - "
          f"gather| logit per step: " + " ".join(f"{x:.3f}" for x in errs),
          flush=True)
    del model, params, caches, paths
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("hybrid_drift_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    resolve_device("cuda")
    print(chip_smoke.card_line(), flush=True)
    _build.build()
    drift(torch, "llama3_1b")
    drift(torch, "hymba_1p5b")
    drift(torch, "hymba_1p5b", block_types=("attn",) * 32)
    drift(torch, "hymba_1p5b", n_layers=8, block_types=("hybrid",) * 8,
          global_attn_layers=(0,))
    return 0


if __name__ == "__main__":
    sys.exit(main())
