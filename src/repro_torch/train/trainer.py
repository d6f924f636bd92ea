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
``mesh`` stays in the signature for the sharded trainer of ROADMAP item
A9b; until then it must be ``None``.
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
from repro_torch.launch.steps import make_train_step
from repro_torch.nn.spec import default_generator
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
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...) shards params and optimizer state over a "
                "mesh, which lands with the training half of ROADMAP item "
                "A9b (its serving half is ContinuousBatchingEngine(mesh=)); "
                "pass mesh=None (one device)")
        self.model = model
        self.opt_cfg = opt_cfg
        self.mesh = mesh
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(cfg.ckpt_dir, cfg.keep_n)
        self.specs = model.param_specs()
        self.train_step = make_train_step(model, opt_cfg,
                                          n_microbatches=cfg.n_microbatches,
                                          mp=mp)
        self.clock: Callable[[], float] = time.time
        self._step_times: list = []
        # one record a step: step, loss, wall seconds, device ms (CUDA)
        self.history: list = []

    # ------------------------------------------------------------------
    def init_or_resume(self, init_key=None) -> tuple:
        """Returns (start_step, params, opt_state): the newest valid
        checkpoint's, else fresh params drawn from ``init_key`` (a
        ``torch.Generator`` on the trainer's device, or a seed; default 0)
        and zeroed optimizer state."""
        latest = self.ckpt.latest_valid_step()
        if latest is not None:
            step, tree, _ = self.ckpt.restore(latest, device=self.device)
            return step, tree["params"], tree["opt"]
        gen = (init_key if isinstance(init_key, torch.Generator)
               else default_generator(init_key or 0, self.device))
        params = self.model.init(gen, self.device)
        opt_state = optim.init_state(self.specs, self.opt_cfg, self.device)
        return 0, params, opt_state

    # ------------------------------------------------------------------
    def _log(self, rec: dict) -> None:
        if self.cfg.metrics_path:
            os.makedirs(os.path.dirname(self.cfg.metrics_path) or ".",
                        exist_ok=True)
            with open(self.cfg.metrics_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def _watchdog(self, dt: float, step: int) -> bool:
        """Returns True if this step is a straggler."""
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
                "step": step, "loss": loss, "dt": dt,
                "device_ms": ev[0].elapsed_time(ev[1]) if cuda else None})
            straggler = self._watchdog(dt, step)
            force_ckpt |= straggler
            if step % self.cfg.log_every == 0 or step == 1:
                rec = {"step": step, "loss": loss, "dt": round(dt, 4),
                       "lr": float(metrics["lr"]),
                       "grad_norm": float(metrics["grad_norm"])}
                self._log(rec)
                print(f"step {step:5d} loss {loss:.4f} "
                      f"dt {dt*1e3:7.1f}ms gnorm {rec['grad_norm']:.3f}",
                      flush=True)
            if step % self.cfg.ckpt_every == 0 or force_ckpt \
                    or step == self.cfg.total_steps:
                self.ckpt.save(step, {"params": params, "opt": opt_state},
                               extra={"loss": loss})
                force_ckpt = False
                if straggler and self.cfg.abort_on_straggler:
                    raise SystemExit(17)
            last_loss = loss
        if eval_fn is not None:
            eval_fn(params)
        return params, opt_state, last_loss
