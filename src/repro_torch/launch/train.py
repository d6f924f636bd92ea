"""Training launcher (port of ``repro/launch/train.py``).

    # smoke size on the CPU (plain PyTorch paths)
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_1b \
        --smoke --device cpu --steps 40 --ckpt-dir /tmp/ck

    # full width on the GPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_1b \
        --steps 100 --batch 8 --seq 256 --ckpt-dir ck

    # over a (data, model) mesh, one process a rank (gloo on the CPU, NCCL
    # on the cards)
    OMP_NUM_THREADS=1 PYTHONPATH=src torchrun --nproc-per-node 4 \
        -m repro_torch.launch.train --smoke --device cpu \
        --mesh-data 2 --mesh-model 2 --steps 10 --ckpt-dir /tmp/ck

Auto-resumes from the newest valid checkpoint in ``--ckpt-dir``, watches for
stragglers, checkpoints atomically and writes ``metrics.jsonl`` there;
``python -m repro_torch.launch.serve --ckpt-dir`` then serves the result.
Data is the step-seeded synthetic stream on the training device. Over a
mesh every rank draws the whole batch and trains on its rows; the mesh's
origin rank alone prints, writes the metrics and the checkpoints (whole
leaves, so a run resumes on any mesh); the group is destroyed at the end.
"""
from __future__ import annotations

import argparse

import torch.distributed as dist

from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import is_mesh_root, training_layout
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import refuse_mesh
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
    device = resolve_device(args.device)
    model = get_model(args.arch, smoke=args.smoke)
    mesh = None
    if (args.mesh_data, args.mesh_model) != (1, 1):
        refuse_mesh(model)
        mesh = make_local_mesh(args.mesh_data, args.mesh_model, device)
    root = is_mesh_root(None if mesh is None else training_layout(mesh))
    say = print if root else (lambda *a, **k: None)
    say(f"[train] arch={args.arch} params={model.n_params():,} "
        f"device={device} mesh=({args.mesh_data},{args.mesh_model})")
    data = SyntheticLM(SyntheticConfig(vocab_size=model.cfg.vocab_size,
                                       batch=args.batch, seq_len=args.seq),
                       device)
    opt = select_optimizer(
        model.n_params(),
        OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                  total_steps=args.steps))
    tr = Trainer(model, opt, mesh,
                 TrainerConfig(total_steps=args.steps,
                               ckpt_every=args.ckpt_every,
                               ckpt_dir=args.ckpt_dir, log_every=10,
                               n_microbatches=args.microbatches,
                               abort_on_straggler=args.abort_on_straggler,
                               metrics_path=f"{args.ckpt_dir}/metrics.jsonl"),
                 device=device)
    try:
        params, _, last = tr.fit(data)
        done = "nothing left to train" if last is None else \
            f"final loss {last:.4f}"
        say(f"[train] done: {done} (ckpts: {args.ckpt_dir})", flush=True)
    finally:
        if mesh is not None:
            # results are printed and written first: a hang in the teardown
            # cannot lose them
            dist.destroy_process_group()
    return params, last


if __name__ == "__main__":
    main()
