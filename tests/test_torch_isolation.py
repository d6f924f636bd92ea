"""The PyTorch port stands alone: it imports neither ``jax`` nor anything of
the reference package ``repro``."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)")


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
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' and sys.modules[m]\n"
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
