"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded through ``ctypes`` — no PyTorch
headers, so a build takes seconds. Builds run at first use, into
``kernels/build/`` beside this file (listed in ``.gitignore``), named by a
digest of the source, the ``csrc`` headers it includes (``#include
"x.cuh"``, followed transitively) and the flags, so an edited source or
header rebuilds. All sources
asked for at once compile in parallel, one ``nvcc`` process each. The
compiler's ``-Xptxas -v`` report (registers, shared memory, spills) is kept
beside each library as ``<lib>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable, Optional

__all__ = ["build", "load", "build_log", "nvcc_path", "SOURCES", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("paged_attention", "paged_decode_gqa", "paged_decode_mla",
           "quant_cast", "fp8_matmul", "mp_attention")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LOADED: dict = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the default
    toolkit location. Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only where the toolkit is")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources_of(name: str) -> list:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes with quotes,
    transitively, in a fixed order."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = CSRC / inc.decode()
            if dep.is_file():
                todo.append(dep)
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in sources_of(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> dict:
    """Compile every named source that has no up-to-date library, all in
    parallel. Returns ``{name: library path}``; raises with the compiler's
    output if any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].is_file()]
    if not todo:
        return out
    nvcc = nvcc_path()
    procs = {}
    try:
        for n in todo:
            tmp = out[n].with_suffix(f".tmp{os.getpid()}")
            cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT),
                        tmp)
        failed = []
        for n, (p, tmp) in procs.items():
            log, _ = p.communicate()
            text = log.decode(errors="replace")
            out[n].with_suffix(".so.log").write_text(text)
            if p.returncode != 0:
                failed.append(f"--- {n} (nvcc exit {p.returncode}) ---\n"
                              f"{text}")
                continue
            os.replace(tmp, out[n])
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LOADED[name] = lib
        return lib


def build_log(name: str) -> str:
    """The compiler's report for the current build of ``name``."""
    p = library_path(name).with_suffix(".so.log")
    return p.read_text() if p.is_file() else ""
