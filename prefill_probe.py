#!/usr/bin/env python3
"""Where a prefill chunk's time goes on the card: host enqueue against
device completion, with the prefix cache on and off.

    python3 prefill_probe.py [--reps 2]

Serves ``chip_smoke.py`` phase 15's shared-prefix drain (llama3_1b at full
width, random seeded weights: 8 requests sharing a 96-token system prompt
plus 32 tokens of their own, the last repeating the first's prompt) on the
continuous engine with the prefix cache on and off, ``--reps`` times each
in turns, each engine warmed up by an unrelated request first and then
by its prefill step at every bucket the drain can take (on the card each
captures its CUDA graph there, so the drain replays only). The prefill
step is wrapped: the card is synchronized before it, the host clock read
when the call returns (enqueue) and again after a synchronize
(completion). Prints, per drain, each request's TTFT (from admission, as
the engine measures it) and each chunk's bucket, real tokens, enqueue and
completion milliseconds, then the card's name and power limit and one
JSON line. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("prefill_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import make_model_and_params
    from repro_torch.serve import ContinuousBatchingEngine
    resolve_device("cuda")
    _build.build()
    model, params = make_model_and_params("llama3_1b", False, "cuda", seed=0)
    spec = cs.SHARED
    plen = spec["system"] + spec["own"]
    reqs = cs.shared_prefix_requests(model.cfg.vocab_size, **spec)
    warm = cs.warm_request(model.cfg.vocab_size, plen, spec["new_tokens"])
    runs = []
    for rep in range(args.reps):
        for on in (True, False):
            eng = ContinuousBatchingEngine(
                model, n_slots=cs.SERVE["n_slots"],
                max_len=plen + spec["new_tokens"],
                block_size=cs.SERVE["block_size"], prefix_cache=on,
                device="cuda")
            eng.serve(params, warm)
            cs.warm_buckets(torch, eng, params, plen + spec["new_tokens"])
            step, chunks = eng.prefill_chunk_step, []

            def timed(p, caches, tok, start, valid, bt, step=step,
                      chunks=chunks):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(p, caches, tok, start, valid, bt)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                chunks.append({"bucket": tok.shape[1],
                               "tokens": int(valid.sum()),
                               "enqueue_ms": (t1 - t0) * 1e3,
                               "total_ms": (t2 - t0) * 1e3})
                return out
            eng.prefill_chunk_step = timed
            out = eng.serve(params, reqs)
            run = {"rep": rep, "prefix_cache": on,
                   "ttft_ms": [out.results[r].ttft_s * 1e3
                               for r in sorted(out.results)],
                   "graph_captures": out.counters["graph_captures"],
                   "graph_replays": out.counters["graph_replays"],
                   "chunks": chunks}
            runs.append(run)
            print(f"rep {rep} prefix cache {'on ' if on else 'off'}: TTFT ms "
                  f"{[round(t, 2) for t in run['ttft_ms']]}; graph captures "
                  f"{run['graph_captures']}, replays {run['graph_replays']}",
                  flush=True)
            for c in chunks:
                print(f"    chunk bucket {c['bucket']:4d} tokens "
                      f"{c['tokens']:4d}: enqueue {c['enqueue_ms']:7.2f} ms,"
                      f" done {c['total_ms']:7.2f} ms", flush=True)
            del eng
    print(cs.card_line(), flush=True)
    print(json.dumps({"runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
