"""Training launcher (port of ``repro/launch/train.py``).

    # smoke size on the CPU (plain PyTorch paths)
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_1b \
        --smoke --device cpu --steps 40 --ckpt-dir /tmp/ck

    # full width on the GPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_1b \
        --steps 100 --batch 8 --seq 256 --ckpt-dir ck

Auto-resumes from the newest valid checkpoint in ``--ckpt-dir``, watches for
stragglers, checkpoints atomically and writes ``metrics.jsonl`` there;
``python -m repro_torch.launch.serve --ckpt-dir`` then serves the result.
Data is the step-seeded synthetic stream on the training device. The mesh
flags stay for the sharded trainer (ROADMAP item A9b) and take only 1
until then.
"""
from __future__ import annotations

import argparse

from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.train.optim import OptConfig, select_optimizer
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3_1b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke configuration")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="checkpoints/launch_train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--abort-on-straggler", action="store_true")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if (args.mesh_data, args.mesh_model) != (1, 1):
        raise NotImplementedError(
            f"--mesh-data {args.mesh_data} --mesh-model {args.mesh_model}: "
            "the sharded trainer lands with the training half of ROADMAP "
            "item A9b; the port trains on one device (both 1)")
    device = resolve_device(args.device)
    model = get_model(args.arch, smoke=args.smoke)
    print(f"[train] arch={args.arch} params={model.n_params():,} "
          f"device={device}")
    data = SyntheticLM(SyntheticConfig(vocab_size=model.cfg.vocab_size,
                                       batch=args.batch, seq_len=args.seq),
                       device)
    opt = select_optimizer(
        model.n_params(),
        OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                  total_steps=args.steps))
    tr = Trainer(model, opt, None,
                 TrainerConfig(total_steps=args.steps,
                               ckpt_every=args.ckpt_every,
                               ckpt_dir=args.ckpt_dir, log_every=10,
                               n_microbatches=args.microbatches,
                               abort_on_straggler=args.abort_on_straggler,
                               metrics_path=f"{args.ckpt_dir}/metrics.jsonl"),
                 device=device)
    params, _, last = tr.fit(data)
    done = "nothing left to train" if last is None else \
        f"final loss {last:.4f}"
    print(f"[train] done: {done} (ckpts: {args.ckpt_dir})")
    return params, last


if __name__ == "__main__":
    main()
