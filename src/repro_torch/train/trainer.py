"""Training loop with checkpoint/restart, straggler watchdog and metrics
(port of ``repro/train/trainer.py``).

Fault-tolerance contract, as in the reference:

* auto-resume from the latest digest-valid checkpoint (params + optimizer +
  step); the data stream is step-seeded (``data.batch_at(step)``), so a
  restart reproduces it exactly;
* atomic checkpoints every ``ckpt_every`` steps and at the last step
  (:class:`repro_torch.checkpoint.CheckpointManager`);
* straggler watchdog: a step longer than ``step_time_budget`` x the median
  of the last 50 step times writes a warning record, forces a checkpoint at
  the step and, with ``abort_on_straggler``, exits with code 17 so that the
  cluster manager reschedules the job;
* metrics: a JSONL record at step 1 and every ``log_every`` steps.

The step runs eagerly (:func:`repro_torch.launch.steps.make_train_step`);
the reference jits it with buffer donation, which the port's in-place
update makes unneeded. Each step's wall time is taken on ``clock`` (the
host's ``time.time``, as the reference's; a test may replace it) and, on
CUDA, its device time between two CUDA events: both land in ``history``.

Over a (data, model) ``mesh`` (``launch.mesh.make_local_mesh``; one process
a rank) each rank holds its block of the params (the sharding rules) and
of AdamW's moments (ZeRO-1) and runs ``make_train_step(..., mesh=)`` on its
rows of each global batch. Checkpoints hold whole leaves, gathered and
written by the mesh's origin rank, so they restore onto any mesh or onto
one device; that rank alone prints and writes metrics, and the straggler
decision reads the slowest rank's step time, so every rank checkpoints (and
exits 17) at the same step.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding
from repro_torch.launch.steps import make_train_step
from repro_torch.nn.spec import (default_generator, flatten_paths,
                                 tree_from_flat)
from repro_torch.train import optim

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 200
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep_n: int = 3
    log_every: int = 10
    n_microbatches: int = 1
    step_time_budget: float = 5.0      # x median -> straggler
    abort_on_straggler: bool = False
    metrics_path: Optional[str] = None


class Trainer:
    def __init__(self, model, opt_cfg: optim.OptConfig, mesh,
                 cfg: TrainerConfig, mp: Optional[dict] = None,
                 device: DeviceLike = None):
        self.model = model
        self.opt_cfg = opt_cfg
        self.mesh = mesh
        self.cfg = cfg
        self.device = resolve_device(device)
        self.specs = model.param_specs()
        self.train_step = make_train_step(model, opt_cfg,
                                          n_microbatches=cfg.n_microbatches,
                                          mp=mp, mesh=mesh)
        self.ckpt = CheckpointManager(cfg.ckpt_dir, cfg.keep_n)
        self.shards = self.train_step.shards
        self.layout = None if mesh is None else self.shards.layout
        # the mesh's origin rank prints and writes the metrics
        self.is_root = sharding.is_mesh_root(self.layout)
        self.clock: Callable[[], float] = time.time
        self._step_times: list = []
        # one record a step: step, loss, grad norm, wall seconds, device ms
        # (CUDA)
        self.history: list = []

    # ------------------------------------------------------------------
    def _pspecs(self) -> Optional[dict]:
        """Each checkpoint path's placement on the mesh (None without)."""
        if self.shards is None:
            return None
        return {**{f"params/{k}": v for k, v in self.shards.params.items()},
                **{f"opt/{k}": v for k, v in self.shards.state.items()}}

    def _latest_step(self) -> Optional[int]:
        """The newest valid checkpoint's step: on a mesh the origin rank
        checks the digests and every rank gets its answer."""
        if self.layout is None:
            return self.ckpt.latest_valid_step()
        step = self.ckpt.latest_valid_step() if self.is_root else None
        got = sharding.mesh_max(torch.tensor(
            [-1.0 if step is None else float(step)], device=self.device),
            self.layout)
        return None if float(got) < 0 else int(got)

    def init_or_resume(self, init_key=None) -> tuple:
        """Returns (start_step, params, opt_state): the newest valid
        checkpoint's, else fresh params drawn from ``init_key`` (a
        ``torch.Generator`` on the trainer's device, or a seed; default 0)
        and zeroed optimizer state. On a mesh, this rank's blocks of them:
        the whole tree is drawn (or read) as on one device and cut."""
        latest = self._latest_step()
        if latest is not None:
            step, tree, _ = self.ckpt.restore(
                latest, device=self.device, mesh=self.mesh,
                pspecs=self._pspecs())
            return step, tree["params"], tree["opt"]
        gen = (init_key if isinstance(init_key, torch.Generator)
               else default_generator(init_key or 0, self.device))
        params = self.model.init(gen, self.device)
        if self.shards is None:
            opt_state = optim.init_state(self.specs, self.opt_cfg,
                                         self.device)
            return 0, params, opt_state
        sh = self.shards
        params = tree_from_flat(sh.local(sh.params, flatten_paths(params)))
        sizes = sh.layout.sizes
        state = {p: torch.zeros(sharding.local_shape(s.shape, sh.state[p],
                                                     sizes),
                                dtype=s.dtype, device=self.device)
                 for p, s in optim.state_specs(self.specs,
                                               self.opt_cfg).items()}
        return 0, params, tree_from_flat(state)

    # ------------------------------------------------------------------
    def _log(self, rec: dict) -> None:
        if self.cfg.metrics_path and self.is_root:
            os.makedirs(os.path.dirname(self.cfg.metrics_path) or ".",
                        exist_ok=True)
            with open(self.cfg.metrics_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def _watchdog(self, dt: float, step: int) -> bool:
        """Returns True if this step is a straggler. On a mesh ``dt`` is the
        slowest rank's, so every rank decides alike (a rank that alone
        checkpointed would wait in the save's gathers for ever)."""
        if self.layout is not None:
            dt = float(sharding.mesh_max(torch.tensor(
                [dt], dtype=torch.float64, device=self.device), self.layout))
        self._step_times.append(dt)
        hist = self._step_times[-50:]
        if len(hist) < 5:
            return False
        med = statistics.median(hist[:-1])
        if dt > self.cfg.step_time_budget * med:
            self._log({"event": "straggler", "step": step, "dt": dt,
                       "median": med})
            return True
        return False

    # ------------------------------------------------------------------
    def fit(self, data, start_key=None, eval_fn: Optional[Callable] = None):
        """Resume or start (:meth:`init_or_resume`), then :meth:`run`.
        Returns (params, opt_state, last loss)."""
        step, params, opt_state = self.init_or_resume(start_key)
        return self.run(data, step, params, opt_state, eval_fn)

    def run(self, data, step: int, params: dict, opt_state: dict,
            eval_fn: Optional[Callable] = None):
        """Train from ``step`` to ``total_steps`` on ``params`` and
        ``opt_state`` (updated in place): the loop of :meth:`fit`, for a
        caller that holds the trees already."""
        last_loss = None
        force_ckpt = False
        cuda = self.device.type == "cuda"
        while step < self.cfg.total_steps:
            batch = data.batch_at(step)
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            t0 = self.clock()
            params, opt_state, metrics = self.train_step(params, opt_state,
                                                         batch)
            if cuda:
                ev[1].record()
            loss = float(metrics["loss"])
            dt = self.clock() - t0
            step += 1
            self.history.append({
                "step": step, "loss": loss,
                "grad_norm": float(metrics["grad_norm"]), "dt": dt,
                "device_ms": ev[0].elapsed_time(ev[1]) if cuda else None})
            straggler = self._watchdog(dt, step)
            force_ckpt |= straggler
            if step % self.cfg.log_every == 0 or step == 1:
                rec = {"step": step, "loss": loss, "dt": round(dt, 4),
                       "lr": float(metrics["lr"]),
                       "grad_norm": float(metrics["grad_norm"])}
                self._log(rec)
                if self.is_root:
                    print(f"step {step:5d} loss {loss:.4f} "
                          f"dt {dt*1e3:7.1f}ms gnorm "
                          f"{rec['grad_norm']:.3f}", flush=True)
            if step % self.cfg.ckpt_every == 0 or force_ckpt \
                    or step == self.cfg.total_steps:
                self.ckpt.save(step, {"params": params, "opt": opt_state},
                               extra={"loss": loss}, mesh=self.mesh,
                               pspecs=self._pspecs())
                force_ckpt = False
                if straggler and self.cfg.abort_on_straggler:
                    raise SystemExit(17)
            last_loss = loss
        if eval_fn is not None:
            eval_fn(params)
        return params, opt_state, last_loss

