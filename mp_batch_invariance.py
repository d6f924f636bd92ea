"""Batch invariance of the port's serving paths under MP plans, on the card.

The continuous engine (4 slots, paged K/V gathered, requests arriving
over time) and the one-shot engine (all 8 prompts in one batch) serve the
same requests at full llama3_1b width; the serving context's per-token
activation scales promise that a request's logits depend on its own tokens
only. This script serves a set of MP plans through both engines (no fp8
op; each kind of op quantized in every layer; three random 55-op plans,
the size of a measured ET plan) and prints, for each plan, the max logit
difference before any token divergence and the first decode step at which
the logits differ. ``--arms`` also runs each plan with the norms' row mean
taken by ``Tensor.mean`` (whose summation order on the card depends on the
number of rows), the order the port used before ``row_mean``:

    python3 mp_batch_invariance.py [--arms fixed,tensor_mean]

About 2 minutes on an H100. It checks nothing and exits 0 once every plan
has been served; ``chip_smoke.py`` holds the measured plans to their
tolerances."""
import argparse
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def plans(names) -> list:
    kinds = sorted({n.split("/")[-1] for n in names})
    out = [("none", {})]
    out += [(k, {n: "fp8_e4m3" for n in names if n.split("/")[-1] == k})
            for k in kinds]
    for seed in range(3):
        picked = random.Random(seed).sample(sorted(names), 55)
        out.append((f"random55_{seed}", dict.fromkeys(picked, "fp8_e4m3")))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arms", default="fixed",
                    help="comma list of fixed (row_mean) and tensor_mean")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mp_batch_invariance: no CUDA device is visible",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.core.mpconfig import MPPlan
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import make_model_and_params, make_requests
    from repro_torch.nn import layers
    resolve_device("cuda")
    print(cs.card_line(), flush=True)
    model, params = make_model_and_params("llama3_1b", False, "cuda", seed=0)
    s = cs.SERVE
    reqs = make_requests(model.cfg.vocab_size, s["requests"],
                         s["prompt_len"], s["new_tokens"], s["arrival_every"])
    fixed = layers.row_mean
    means = {"fixed": fixed,
             "tensor_mean": lambda x: x.mean(dim=-1, keepdim=True)}
    for arm in args.arms.split(","):
        layers.row_mean = means[arm]
        for label, asg in plans(model.serving_op_names()):
            t = time.perf_counter()
            plan = MPPlan(assignment=asg, groups=[], objective="ET", tau=0.0,
                          budget=0.0, predicted_loss_mse=0.0,
                          predicted_gain=0.0) if asg else None
            _, _, cont = cs.run_continuous(torch, model, params, reqs,
                                           mp=plan, paged_attn="gather")
            _, one = cs.run_oneshot(model, params, reqs, mp=plan)
            res = cs.compare(f"{arm} {label}", cont, one, tol=cs.LOGIT_TOL,
                             bound=cs.MARGIN_BOUND, failures=[])
            first = []
            for rid in sorted(one):
                d = (cont[rid][1].float() - one[rid][1].float()).abs()
                nz = torch.nonzero(d.amax(-1)).flatten()
                first.append(int(nz[0]) if nz.numel() else None)
            print(f"{arm} {label} ({len(asg)} fp8 ops): max logit err "
                  f"{res['max_logit_err']:.4f}, tokens agree "
                  f"{100 * res['token_share']:.2f}%, first differing step "
                  f"by request {first} ({time.perf_counter() - t:.1f} s)",
                  flush=True)
    layers.row_mean = fixed
    return 0


if __name__ == "__main__":
    sys.exit(main())
