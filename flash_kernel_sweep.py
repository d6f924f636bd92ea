#!/usr/bin/env python3
"""Where kernel 4's time goes (``mp_flash_attention``), on one GPU.

    python3 flash_kernel_sweep.py

Times the tensor-core kernel of ``csrc/mp_attention.cu`` through its
wrapper, causal, at the llama3_1b attention width (B=1, H=32, T=S=4096, D
64) and at DeepSeek-V3's MLA prefill width (H=128, D 192, Dv 128):

* as built, with bf16 operands, with e4m3 operands (the producer widens
  them to bf16) and with e4m3 operands and ``quant_probs`` (two passes over
  each 256-key block);
* as copies of the source with parts of the consumers' work cut, bf16
  operands: without the softmax (P is the raw scores), without the two
  products (the softmax on stale registers), and with neither (the
  consumers only wait for each K and V tile and release it: the time the
  loads alone take). The cuts compute garbage; only their times mean
  anything.

Device times come from CUDA graphs (``chip_smoke.timed``, inputs resident
in L2). Prints the card's name and power limit first. Builds go to the
kernels' git-ignored build directory.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = {"llama3_1b": (1, 32, 4096, 4096, 64, 64),
          "deepseek_v3": (1, 128, 4096, 4096, 192, 128)}
# (marker, replacement) pairs in the consumers' loop without quant_probs
SOFTMAX = ("        mask_scores(t0, min(t0 + kBN, p.S));\n"
           "        mx[0] = mx[1] = -INFINITY;\n"
           "        row_max(mx);\n"
           "        new_max(mx, corr);\n"
           "        rescale_o(corr);\n"
           "        make_p();\n")
RAW_P = (SOFTMAX, "        hopper::fence_regs(x);\n"
                  "        for (int i = 0; i < 16; ++i)\n"
                  "          a[i >> 2][i & 3] = pack_bf16(x[2 * i], "
                  "x[2 * i + 1]);\n")
QK = ("        issue_qk(acquire(2 * t));\n        hopper::wgmma_wait<0>();\n",
      "        acquire(2 * t);\n")
PV = ("        issue_pv(acquire(2 * t + 1));\n        hopper::wgmma_wait<0>();\n"
      "        pv_done();\n", "        acquire(2 * t + 1);\n")
CUTS = {"no softmax": (RAW_P,), "no products": (QK, PV),
        "loads only": (QK, PV, (SOFTMAX, ""))}


def build_cuts(build) -> dict:
    """Compile one copy of the source per cut, in parallel."""
    src = (build.CSRC / "mp_attention.cu").read_text()
    out_dir = build.BUILD_DIR / "flash_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "hopper.cuh").write_text(
        (build.CSRC / "hopper.cuh").read_text())
    procs = {}
    for name, subs in CUTS.items():
        text = src
        for marker, repl in subs:
            if marker not in text:
                raise SystemExit(f"marker for {name!r} not in the source")
            text = text.replace(marker, repl)
        cu = out_dir / f"{name.replace(' ', '_')}.cu"
        cu.write_text(text)
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
        print("flash_kernel_sweep: no CUDA device is visible",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import mp_attention as fa
    from repro_torch.kernels import quant_cast as qc
    print(cs.card_line(), flush=True)
    inputs = {}
    for name, (B, H, T, S, D, Dv) in SHAPES.items():
        qkv = [cs.randn(torch, s, 200 + i, 1.0, torch.bfloat16)
               for i, s in enumerate(((B, H, T, D), (B, H, S, D),
                                      (B, H, S, Dv)))]
        quant = [qc.quantize_fp8(x.reshape(-1, x.shape[-1])) for x in qkv]
        fp8 = [a.reshape(x.shape) for (a, _), x in zip(quant, qkv)]
        inputs[name] = (qkv, fp8, [s for _, s in quant])

    def us(*args, **kw) -> float:
        return cs.timed(torch, lambda *a: fa.mp_flash_attention(*a, **kw),
                        *args, warm=True) * 1e3

    for name, (qkv, fp8, sc) in inputs.items():
        print(f"{name} {SHAPES[name]}: bf16 {us(*qkv):.1f} us | e4m3 "
              f"{us(*fp8, *sc):.1f} us | e4m3 quant_probs "
              f"{us(*fp8, *sc, quant_probs=True):.1f} us", flush=True)
    full_fn = fa._kernel_fn("tensor_cores")
    for cut, lib in build_cuts(_build).items():
        fn = lib.mp_flash_attention_launch
        fn.argtypes, fn.restype = full_fn.argtypes, full_fn.restype
        fa._fns["tensor_cores"] = fn
        row = [f"{name} {us(*qkv):.1f} us"
               for name, (qkv, _, _) in inputs.items()]
        print(f"{cut} (bf16): {' | '.join(row)}", flush=True)
    fa._fns["tensor_cores"] = full_fn
    return 0


if __name__ == "__main__":
    sys.exit(main())
