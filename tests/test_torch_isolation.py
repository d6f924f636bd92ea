"""The PyTorch port stands alone: it imports neither ``jax`` nor anything of
the reference package ``repro``, nor ``ml_dtypes`` (the card's machine has
none: checkpoints store bf16 and fp8 as raw bytes)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(
    r"^\s*(from|import)\s+(jax|repro|ml_dtypes)(\.|\s|$)")
# the training slice's modules, which must be among those checked
_TRAINING = ("repro_torch.train.optim", "repro_torch.train.trainer",
             "repro_torch.checkpoint.manager", "repro_torch.launch.train",
             "repro_torch.distributed.grad_compress")
# the mesh serving slice's modules, likewise
_MESH = ("repro_torch.distributed.sharding", "repro_torch.launch.mesh",
         "repro_torch.serve.parallel")
# the dry run's modules, likewise
_DRYRUN = ("repro_torch.launch.dryrun", "repro_torch.analysis.roofline",
           "repro_torch.analysis.report")


def _port_modules() -> list:
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_port_module_imports_with_jax_and_repro_blocked():
    mods = _port_modules()
    assert "repro_torch.serve.engine" in mods and len(mods) >= 20
    assert set(_TRAINING) <= set(mods)
    assert set(_MESH) <= set(mods)
    assert set(_DRYRUN) <= set(mods)
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'ml_dtypes')\n"
        "       and sys.modules[m]\n"
        "       or m.startswith(('jax.', 'jaxlib', 'repro.'))]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("ok")


def test_port_sources_never_import_jax_or_repro():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
                 for p in files
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if _FORBIDDEN.match(line)]
    assert not offenders, offenders
