"""Fault-tolerant checkpointing (port of ``repro/checkpoint/manager.py``),
in the reference's on-disk format, so a checkpoint written by either
package restores in the other bit for bit.

* **Atomicity** — a checkpoint is staged into ``step_<N>.tmp`` and renamed
  only after every array and the manifest (with per-array SHA-256 digests)
  are fsynced. A crash mid-save never corrupts the latest checkpoint.
* **Format** — ``arrays.npz`` holds every leaf as a full logical array,
  keyed by its param path with ``/`` replaced by ``\\x1f``;
  ``manifest.json`` holds each path's shape, dtype name and the first 16
  hex digits of the SHA-256 of its bytes. bf16 and fp8 leaves are stored
  as raw 2- and 1-byte void arrays under their dtype names (``bfloat16``,
  ``float8_e4m3fn``, ``float8_e5m2``): what numpy writes for the
  reference's ``ml_dtypes`` arrays, and what its restore decodes. The
  port reads them back by viewing the bytes as the torch dtype; it needs
  no ``ml_dtypes``.
* **Keep-N GC** and corrupted-checkpoint quarantine: restore walks back to
  the newest checkpoint whose digests are valid. A run resumed from an
  older checkpoint that reaches the corrupted one's step again replaces it:
  the old directory is moved aside, the new one renamed into place, then
  the old one deleted. A step whose checkpoint is valid is never saved
  over (the reference's rename fails on any existing directory).
"""
from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import shutil
import struct
import time
import warnings
import zipfile
from typing import Optional

import numpy as np
import numpy.lib.format as npf
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding
from repro_torch.nn.spec import flatten_paths, tree_from_flat

__all__ = ["CheckpointManager"]

_MANIFEST = "manifest.json"
# a save hands what it has written to the disk in the background each time
# this much more is written (an fsync costs a journal commit however little
# it flushes, so small checkpoints take the final one alone)
_FLUSH_BYTES = 256 << 20

# torch dtypes numpy has no type for: stored as void arrays of their width,
# named as ``ml_dtypes`` names them
_RAW = {torch.bfloat16: ("bfloat16", torch.int16),
        torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8),
        torch.float8_e5m2: ("float8_e5m2", torch.uint8)}
_FROM_NAME = {name: dt for dt, (name, _) in _RAW.items()}


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).data).hexdigest()[:16]


def _hashers() -> concurrent.futures.ThreadPoolExecutor:
    """Threads for the digests (SHA-256 releases the GIL): a checkpoint of
    a few GB hashes at the disk's rate instead of one core's."""
    return concurrent.futures.ThreadPoolExecutor(
        max_workers=min(8, os.cpu_count() or 1))


def _write_member(zf: zipfile.ZipFile, key: str, arr: np.ndarray) -> None:
    """``arr`` as the member ``key.npy``, the bytes ``np.savez`` writes
    (the same npy header, one stored zip64 member), its data handed to the
    zip writer in one buffer instead of numpy's 16 MiB copies."""
    with zf.open(key + ".npy", "w", force_zip64=True) as fid:
        npf.write_array_header_1_0(fid, npf.header_data_from_array_1_0(arr))
        fid.write(np.ascontiguousarray(arr).reshape(-1).view(np.uint8).data)


class _MemberReader:
    """The arrays of an npz of stored members (what ``np.savez`` and
    :func:`_write_member` write), each read with ``readinto`` from its
    offset instead of through the zip reader's chunks (the digests, not the
    zip's CRC-32s, are the integrity check). A member in another form
    raises."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._zip = zipfile.ZipFile(self._f)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._zip.close()
        self._f.close()

    def read(self, key: str) -> np.ndarray:
        info = self._zip.getinfo(key + ".npy")
        f = self._f
        f.seek(info.header_offset)
        local = f.read(30)
        if info.compress_type != zipfile.ZIP_STORED \
                or local[:4] != b"PK\x03\x04":
            raise ValueError(f"{key}: not a stored zip member")
        n, m = struct.unpack("<HH", local[26:30])
        f.seek(info.header_offset + 30 + n + m)
        version = npf.read_magic(f)
        if version not in ((1, 0), (2, 0)):
            raise ValueError(f"{key}: npy format {version}")
        shape, fortran, dtype = (npf.read_array_header_1_0(f)
                                 if version == (1, 0)
                                 else npf.read_array_header_2_0(f))
        if fortran or dtype.hasobject:
            raise ValueError(f"{key}: a Fortran-order or object array")
        arr = np.empty(shape, dtype)
        buf, got = arr.reshape(-1).view(np.uint8).data, 0
        while got < len(buf):
            n = f.readinto(buf[got:])
            if not n:
                raise ValueError(f"{key}: truncated member")
            got += n
        return arr


def _to_numpy(t: torch.Tensor) -> tuple:
    """(array, dtype name): a host copy of ``t``; bf16 / fp8 as void bytes."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype in _RAW:
        name, as_int = _RAW[t.dtype]
        arr = t.view(as_int).numpy()
        return arr.view(np.dtype(f"V{arr.itemsize}")), name
    arr = t.numpy()
    return arr, str(arr.dtype)


def _decode(arr: np.ndarray, dtype_str: str, device: torch.device,
            cut=None) -> torch.Tensor:
    """A stored array as a tensor of its own on ``device`` (the arrays of
    an npz are read-only buffers): void bytes viewed as the torch dtype the
    manifest names; ``cut`` (a function of the host tensor) takes a mesh
    rank's block of it before the copy."""
    with warnings.catch_warnings():
        # read before the copy below, never written
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable")
        if arr.dtype.kind == "V":
            raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
            t = torch.from_numpy(raw).view(_FROM_NAME[dtype_str]).reshape(
                arr.shape)
        else:
            t = torch.from_numpy(arr)
        if cut is not None:
            t = cut(t)
    return t.to(device, copy=True)


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def all_steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith((".tmp",
                                                               ".old")):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    # ------------------------------------------------------------------
    def save(self, step: int, tree: dict, extra: Optional[dict] = None,
             mesh=None, pspecs: Optional[dict] = None) -> str:
        """Blocking save; atomic via tmp-dir + rename. The digests are
        computed in threads while the arrays are written. With ``mesh``
        (a training mesh) ``tree`` holds this rank's blocks, each path's
        placed by ``pspecs[path]`` (whole where absent): every rank gathers
        each whole leaf, the mesh's origin rank writes them, and the mesh
        waits for the write. The bytes are those a save of the whole tree
        on one device writes."""
        if mesh is not None:
            return self._save_mesh(step, tree, extra, mesh, pspecs or {})
        final = self._step_dir(step)
        if os.path.exists(final) and self._validate(step):
            raise FileExistsError(f"{final} holds a valid checkpoint")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "extra": extra or {},
                    "arrays": {}}
        leaves = list(flatten_paths(tree).items())
        digests = {}
        with _hashers() as ex, \
                concurrent.futures.ThreadPoolExecutor(1) as copier, \
                concurrent.futures.ThreadPoolExecutor(1) as flusher:
            # each leaf's copy to the host runs while the one before it is
            # written, its digest in the pool beside both, and the disk
            # takes what is written while the next leaf is (the final fsync
            # below then has little left to wait for)
            nxt = copier.submit(_to_numpy, leaves[0][1]) if leaves else None
            with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                flushed, unflushed = None, 0
                with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED,
                                     allowZip64=True) as zf:
                    for i, (path, _) in enumerate(leaves):
                        arr, dtype_name = nxt.result()
                        if i + 1 < len(leaves):
                            nxt = copier.submit(_to_numpy, leaves[i + 1][1])
                        digests[path] = ex.submit(_digest, arr)
                        manifest["arrays"][path] = {"shape": list(arr.shape),
                                                    "dtype": dtype_name}
                        _write_member(zf, path.replace("/", "\x1f"), arr)
                        unflushed += arr.nbytes
                        if unflushed >= _FLUSH_BYTES and (
                                flushed is None or flushed.done()):
                            if flushed is not None:
                                flushed.result()
                            f.flush()
                            flushed = flusher.submit(os.fsync, f.fileno())
                            unflushed = 0
                if flushed is not None:
                    flushed.result()
                f.flush()
                os.fsync(f.fileno())
            for path, fut in digests.items():
                manifest["arrays"][path]["digest"] = fut.result()
        man_path = os.path.join(tmp, _MANIFEST)
        with open(man_path, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):     # a quarantined checkpoint of this step
            aside = final + ".old"
            if os.path.exists(aside):
                shutil.rmtree(aside)
            os.rename(final, aside)
            os.rename(tmp, final)
            shutil.rmtree(aside)
        else:
            os.rename(tmp, final)
        self._gc()
        return final

    def _save_mesh(self, step: int, tree: dict, extra, mesh,
                   pspecs: dict) -> str:
        layout = sharding.training_layout(mesh)
        root = sharding.is_mesh_root(layout)
        whole = {}
        for path, t in flatten_paths(tree).items():
            full = sharding.gather_leaf(t, pspecs.get(path, ()), layout)
            if root:
                whole[path] = full
        final = self._step_dir(step)
        err = None
        if root:
            try:
                self.save(step, tree_from_flat(whole), extra)
            except Exception as e:        # noqa: BLE001 (re-raised below)
                err = e
            del whole
        dev = next(iter(flatten_paths(tree).values())).device
        failed = sharding.mesh_max(torch.tensor([float(err is not None)],
                                                device=dev), layout)
        if err is not None:
            raise err
        if float(failed) > 0:
            raise RuntimeError(f"the mesh's writer failed to save step "
                               f"{step} in {self.dir}")
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def _read(self, step: int, check: bool, only: Optional[str] = None):
        """One pass over a checkpoint: (manifest, {path: (array, dtype
        name)}) for the arrays under the top-level key ``only`` (all when
        None, none when ""). With ``check``, every array's shape and digest
        is held to the manifest as it is read (the hashing in threads
        beside the reads), and a mismatch or an unreadable file gives
        None."""
        d = self._step_dir(step)
        try:
            with open(os.path.join(d, _MANIFEST)) as f:
                manifest = json.load(f)
            out, digests = {}, []
            with _hashers() as ex, \
                    _MemberReader(os.path.join(d, "arrays.npz")) as z:
                for path, info in manifest["arrays"].items():
                    keep = only is None or path.split("/", 1)[0] == only
                    if not (check or keep):
                        continue
                    arr = z.read(path.replace("/", "\x1f"))
                    if check:
                        if list(arr.shape) != info["shape"]:
                            return None
                        digests.append((ex.submit(_digest, arr),
                                        info["digest"]))
                    if keep:
                        out[path] = (arr, info["dtype"])
                if not all(f.result() == want for f, want in digests):
                    return None
            return manifest, out
        except Exception:
            if not check:
                raise
            return None

    def _validate(self, step: int) -> bool:
        return self._read(step, check=True, only="") is not None

    def latest_valid_step(self) -> Optional[int]:
        for s in reversed(self.all_steps()):
            if self._validate(s):
                return s
        return None

    def restore(self, step: Optional[int] = None, device: DeviceLike = None,
                only: Optional[str] = None, mesh=None,
                pspecs: Optional[dict] = None) -> tuple:
        """Returns (step, tree, extra), the tree's tensors on ``device``.
        ``step`` None takes the newest valid checkpoint, read once: each
        array is checked against its digest as it is read (the reference
        validates, then reads again). ``only`` (a top-level key, e.g.
        ``"params"``) keeps that subtree alone; the other arrays are read
        and hashed when ``step`` is None, else left on disk. With ``mesh``
        (the counterpart of the reference's ``shardings``) each rank reads
        the whole arrays and keeps its block of each path that ``pspecs``
        places (``sharding.local_shard``): a checkpoint saved on any mesh,
        or on one device, restores onto any other."""
        device = resolve_device(device)
        cut = None
        if mesh is not None:
            lay = sharding.training_layout(mesh)

            def cut(path, t):
                spec = (pspecs or {}).get(path)
                return t if spec is None else sharding.local_shard(
                    t, spec, lay.sizes, lay.coords)
        got = None
        if step is None:
            for s in reversed(self.all_steps()):
                got = self._read(s, check=True, only=only)
                if got is not None:
                    step = s
                    break
            if got is None:
                raise FileNotFoundError(f"no valid checkpoint in {self.dir}")
        else:
            got = self._read(step, check=False, only=only)
        manifest, arrays = got
        flat = {path: _decode(arr, dtype, device,
                              None if cut is None
                              else (lambda t, p=path: cut(p, t)))
                for path, (arr, dtype) in arrays.items()}
        return step, tree_from_flat(flat), manifest.get("extra", {})
