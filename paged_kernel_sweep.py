#!/usr/bin/env python3
"""Where the paged-decode kernels' time goes, on one GPU.

    python3 paged_kernel_sweep.py [--forms gqa,mla]

Times the GQA form's tensor-core kernel (``csrc/paged_decode_gqa.cu``) at
the serving cell's decode step (B=4, 8 KV heads x 4, block 16, bf16) at D 64
and D 128 with 16 and about 150 live keys a row, at a long table (D 64,
2048 keys a row), and at 8, 16 and 32 rows of about 150 keys (D 64; 16 rows
at D 128 too), where the wrapper's rule picks groups of 2 and 4; and the
MLA form's tensor-core kernel (``csrc/paged_decode_mla.cu``: one latent
head x 128, latents 512 + 64, f32 queries) at 16, about 150 and 2048 keys
a row:

* with every head-group size the wrapper could pick (1, 2, 4; 8 for MLA),
  to check the group the wrapper does pick; the MLA kernel also with its
  key tiles in one block and split over a cluster of two; both forms also
  time the CUDA-core kernel that served them before (route forced);
* cut off at each phase boundary, built as separate copies of the source
  with an early return (after waiting for the copies in flight): the
  tensor-core kernels after the set-up (length, table row; the GQA kernel's
  queries too), after the first ring of copies has landed (the MLA
  kernel's query planes too), after the scores (phase 0) and after the
  softmax (phase 1); the CUDA-core kernel, route forced on the MLA cases,
  after its set-up and after its phase 0.

Device times come from CUDA graphs of 20 calls (``chip_smoke.device_ms``),
L2-warm. Prints the card's name and power limit first. Builds go to the
kernels' git-ignored build directory.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STOP = "  cp_async_wait<0>();\n  return;\n"
# source -> {cut: marker the early return goes in front of}
CUTS = {
    "paged_decode_gqa": {
        "set-up only": "  for (int i = 0; i < n_slots; ++i) issue(i, i);",
        "first ring landed": "  // phase 0: masked scores",
        "to phase 0": "  // phase 1: the final row max",
        "to phase 1": "  // phase 2: context",
    },
    "paged_decode_mla": {
        "set-up only": "  // every warp's first copies",
        "first ring landed": "  // phase 0: masked scores",
        "to phase 0": "  // phase 1: the final row max",
        "to phase 1": "  // phase 2: context",
    },
    "paged_attention": {
        "set-up only": "  // phase 0: masked scores",
        "to phase 0": "  // phase 1: the final row max",
    },
}
SHORT, MID, LONG = (16, 16, 16, 16), (160, 152, 144, 136), (2048,) * 4


def build_cuts(build, source: str) -> dict:
    """Compile one copy of ``csrc/<source>.cu`` per cut, in parallel."""
    src = (build.CSRC / f"{source}.cu").read_text()
    stop = STOP if source != "paged_attention" else "  return;\n"
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, marker in CUTS[source].items():
        if marker not in src:
            raise SystemExit(f"marker for {name!r} not in {source}.cu")
        cu = out_dir / f"{source}_{name.replace(' ', '_')}.cu"
        cu.write_text(src.replace(marker, stop + marker, 1))
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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--forms", default="gqa,mla",
                    help="comma-separated forms to time: gqa, mla")
    forms = set(ap.parse_args().forms.split(","))
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
    _build.build(["paged_decode_gqa", "paged_decode_mla", "paged_attention"])
    gqa = []
    for d, lengths in ((64, SHORT), (64, MID), (128, SHORT), (128, MID),
                       (64, LONG), (64, MID * 2), (64, MID * 4),
                       (128, MID * 4), (64, MID * 8)):
        if "gqa" not in forms:
            break
        kw = dict(scale=d ** 0.5, score_dtype=torch.bfloat16,
                  probs_dtype=torch.bfloat16, out_dtype=torch.bfloat16)
        gqa.append((f"GQA D {d} B {len(lengths)} keys {min(lengths)}-"
                    f"{max(lengths)}",
                    cs.paged_case(torch, 1, torch.bfloat16, 0.0, lengths,
                                  d=d), kw))
    mla = []
    for lengths in (SHORT, MID, LONG):
        if "mla" not in forms:
            break
        args, kw = cs.mla_case(torch, 4, lengths, 0.0)
        mla.append((f"MLA keys {min(lengths)}-{max(lengths)}", args, kw))

    def time_case(args, kw) -> float:
        return cs.device_ms(torch, lambda: pa.paged_decode_attention(
            *args, **kw)) * 1e3

    picked = pa.head_group
    for cases, groups in ((gqa, (1, 2, 4)), (mla, (1, 2, 4, 8))):
        for label, args, kw in cases:
            row = []
            for hg in groups:
                pa.head_group = lambda *a, hg=hg, **k: hg
                row.append(f"hg {hg} {time_case(args, kw):.2f} us")
            pa.head_group = picked
            row.append(f"picked {time_case(args, kw):.2f} us")
            if cases is mla:
                split = pa.mla_split
                for n in (1, 2):
                    pa.mla_split = lambda *a, n=n: n
                    row.append(f"split {n} {time_case(args, kw):.2f} us")
                pa.mla_split = split
            with cs.forced_route(pa, "cuda_core"):
                row.append(f"CUDA-core kernel {time_case(args, kw):.2f} us")
            print(f"{label}: {' | '.join(row)}", flush=True)
    for source, cases, attr, loader, rt in (
            ("paged_decode_gqa", gqa, "_gqa_fn", pa._gqa_kernel_fn, None),
            ("paged_decode_mla", mla, "_mla_fn", pa._mla_kernel_fn, None),
            ("paged_attention", mla, "_fn", pa._kernel_fn, "cuda_core")):
        if not cases:
            continue
        full_fn = loader()
        launch = full_fn.__name__
        for name, lib in build_cuts(_build, source).items():
            fn = getattr(lib, launch)
            fn.argtypes, fn.restype = full_fn.argtypes, full_fn.restype
            setattr(pa, attr, fn)
            for label, args, kw in cases:
                if rt is None:
                    t = time_case(args, kw)
                else:
                    with cs.forced_route(pa, rt):
                        t = time_case(args, kw)
                print(f"{label}, {source} {name}: {t:.2f} us", flush=True)
        setattr(pa, attr, full_fn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
