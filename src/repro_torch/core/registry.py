"""Bundle registry: calibration artifacts keyed by architecture, checkpoint
fingerprint, and calibration-set hash, with serve-time selection of the
freshest compatible bundle (port of ``repro/core/registry.py``).

A :class:`~repro_torch.core.pipeline.CalibrationBundle` already records everything
needed to decide compatibility (``meta["arch"]``,
``meta["params_fingerprint"]``, ``meta["calib_hash"]``); the registry is a
directory convention over those keys::

    <root>/<arch>/<fingerprint>/bundle-0000.npz
    <root>/<arch>/<fingerprint>/bundle-0001.npz     # newer calibration
    ...

``put(bundle)`` files an artifact under its own keys; ``find(arch,
fingerprint)`` returns the freshest artifact whose keys match, verifying the
loaded header against the directory it was found in (a hand-copied bundle in
the wrong slot is rejected, not silently served). ``launch/serve.py
--registry`` uses this to pick the bundle for the checkpoint it is actually
serving instead of trusting a hand-passed path.
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.core.pipeline import CalibrationBundle

__all__ = ["BundleRegistry"]


def _safe(component: str) -> str:
    """Filesystem-safe directory name for a key component."""
    return "".join(c if (c.isalnum() or c in "._-+") else "_"
                   for c in str(component))


class BundleRegistry:
    """Directory-backed registry of calibration bundles.

    Freshness is decided by file mtime (name as a deterministic tiebreak),
    so re-calibrating the same (arch, checkpoint) simply files a new artifact
    that future ``find`` calls prefer — no in-place overwrites.
    """

    def __init__(self, root: str):
        self.root = str(root)

    # ---- layout ----------------------------------------------------------
    def _dir(self, arch: str, fingerprint: str) -> str:
        return os.path.join(self.root, _safe(arch), _safe(fingerprint))

    def entries(self) -> list:
        """All (arch_dir, fingerprint_dir, path) triples on disk, unloaded."""
        out = []
        if not os.path.isdir(self.root):
            return out
        for arch in sorted(os.listdir(self.root)):
            adir = os.path.join(self.root, arch)
            if not os.path.isdir(adir):
                continue
            for fp in sorted(os.listdir(adir)):
                fdir = os.path.join(adir, fp)
                if not os.path.isdir(fdir):
                    continue
                for name in sorted(os.listdir(fdir)):
                    if name.endswith((".npz", ".json")):
                        out.append((arch, fp, os.path.join(fdir, name)))
        return out

    # ---- write -----------------------------------------------------------
    def put(self, bundle: CalibrationBundle, *, fmt: str = "npz") -> str:
        """File ``bundle`` under its own (arch, fingerprint) keys; returns
        the artifact path. Never overwrites: each put gets a fresh name."""
        arch = bundle.meta.get("arch")
        fingerprint = bundle.meta.get("params_fingerprint")
        if not arch or not fingerprint:
            raise ValueError(
                "bundle.meta lacks arch/params_fingerprint — calibrate() "
                "stamps both; a registry cannot key an anonymous bundle")
        d = self._dir(arch, fingerprint)
        os.makedirs(d, exist_ok=True)
        n = 0
        while True:
            path = os.path.join(d, f"bundle-{n:04d}.{fmt}")
            if not os.path.exists(path):
                break
            n += 1
        bundle.save(path)
        return path

    # ---- read ------------------------------------------------------------
    def find(self, arch: str, params_fingerprint: str,
             calib_hash: Optional[str] = None) -> CalibrationBundle:
        """Freshest compatible bundle for (arch, checkpoint [, calib set]).

        Candidates come from the keyed directory, newest mtime first; each
        is loaded and its *header* keys verified against the request (and
        against ``calib_hash`` when given — bundles predating calib hashes
        match any). Raises ``LookupError`` naming what the registry does
        hold when nothing matches.
        """
        d = self._dir(arch, params_fingerprint)
        candidates = []
        if os.path.isdir(d):
            for name in os.listdir(d):
                if name.endswith((".npz", ".json")):
                    path = os.path.join(d, name)
                    candidates.append((os.path.getmtime(path), name, path))
        rejected = []
        for _, _, path in sorted(candidates, reverse=True):
            try:
                bundle = CalibrationBundle.load(path)
            except Exception as e:
                # a corrupted artifact (truncated npz, bad JSON, partial
                # write) must not take the whole registry down: warn loudly
                # at skip time and fall through to the next-freshest
                # candidate, keeping the detail for the final LookupError
                print(f"[registry] warning: skipping corrupted bundle "
                      f"{path}: {e}")
                rejected.append(f"{path}: unreadable ({e})")
                continue
            meta = bundle.meta
            if meta.get("arch") != arch:
                rejected.append(f"{path}: header arch {meta.get('arch')!r} "
                                f"!= {arch!r}")
                continue
            if meta.get("params_fingerprint") != params_fingerprint:
                rejected.append(
                    f"{path}: header fingerprint "
                    f"{meta.get('params_fingerprint')!r} != "
                    f"{params_fingerprint!r}")
                continue
            if (calib_hash is not None
                    and meta.get("calib_hash") is not None
                    and meta.get("calib_hash") != calib_hash):
                rejected.append(f"{path}: calib_hash "
                                f"{meta.get('calib_hash')!r} != "
                                f"{calib_hash!r}")
                continue
            return bundle
        have = [f"{a}/{fp}" for a, fp, _ in self.entries()]
        detail = "; ".join(rejected) if rejected else "no candidates"
        raise LookupError(
            f"no compatible bundle for arch={arch!r} "
            f"fingerprint={params_fingerprint!r}"
            + (f" calib_hash={calib_hash!r}" if calib_hash else "")
            + f" under {self.root} ({detail}); registry holds: "
            + (", ".join(sorted(set(have))) if have else "nothing"))
