#!/usr/bin/env python3
"""Where the paged-decode kernel's time goes, on one GPU.

    python3 paged_kernel_sweep.py

Times ``csrc/paged_attention.cu`` at the serving cell's decode step (B=4,
block 16) in both forms — GQA (8 KV heads x 4, D 64, bf16) and MLA (one
latent head x 128, latents 512 + 64, f32 queries) — at 16 and at about 150
live keys a row:

* with every head-group size the wrapper could pick (1, 2, 4, 8), to check
  the group the wrapper does pick;
* cut off after its set-up and after its phase 0 (the scores), built as
  separate copies of the source with an early return, to see which phase
  the time grows in.

Device times come from CUDA graphs of 20 calls (``chip_smoke.device_ms``).
Prints the card's name and power limit first. Builds go to the kernels'
git-ignored build directory.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CUTS = {"set-up only": "  // phase 0: masked scores",
        "to phase 0": "  // phase 1: the final row max"}
LENGTHS = ((16, 16, 16, 16), (160, 152, 144, 136))


def build_cuts(build) -> dict:
    """Compile one copy of the kernel per cut, in parallel."""
    src = (build.CSRC / "paged_attention.cu").read_text()
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, marker in CUTS.items():
        if marker not in src:
            raise SystemExit(f"marker for {name!r} not in the source")
        cu = out_dir / f"{name.replace(' ', '_')}.cu"
        cu.write_text(src.replace(marker, "  return;\n" + marker, 1))
        lib = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib)
    libs = {}
    for name, (p, lib) in procs.items():
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise SystemExit(f"build of {name!r} failed:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("paged_kernel_sweep: no CUDA device is visible",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa
    print(cs.card_line(), flush=True)
    gqa_kw = dict(scale=8.0, score_dtype=torch.bfloat16,
                  probs_dtype=torch.bfloat16, out_dtype=torch.bfloat16)
    cases = []
    for lengths in LENGTHS:
        cases.append(("GQA", lengths,
                      cs.paged_case(torch, 1, torch.bfloat16, 0.0, lengths),
                      gqa_kw))
        args, kw = cs.mla_case(torch, 4, lengths, 0.0)
        cases.append(("MLA", lengths, args, kw))

    def time_case(args, kw) -> float:
        return cs.device_ms(torch, lambda: pa.paged_decode_attention(
            *args, **kw)) * 1e3

    picked = pa.head_group
    for form, lengths, args, kw in cases:
        row = []
        for hg in (1, 2, 4, 8):
            pa.head_group = lambda *a, hg=hg, **k: hg
            row.append(f"hg {hg} {time_case(args, kw):.2f} us")
        pa.head_group = picked
        print(f"{form} keys {lengths}: {' | '.join(row)} | picked "
              f"{time_case(args, kw):.2f} us", flush=True)
    full_fn = pa._kernel_fn()
    for name, lib in build_cuts(_build).items():
        fn = lib.paged_decode_attention_launch
        fn.argtypes, fn.restype = full_fn.argtypes, full_fn.restype
        pa._fn = fn
        for form, lengths, args, kw in cases:
            print(f"{form} keys {lengths}, {name}: "
                  f"{time_case(args, kw):.2f} us", flush=True)
    pa._fn = full_fn
    return 0


if __name__ == "__main__":
    sys.exit(main())
