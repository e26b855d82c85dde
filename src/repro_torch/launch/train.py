"""Training launcher. Counterpart of ``repro/launch/train.py`` with one
more flag, ``--device`` (default ``cuda``, which raises without a card).

Local smoke:   PYTHONPATH=src python -m repro_torch.launch.train --device cpu --model tiny-dense --steps 50
Reduced arch:  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b --reduced
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

from repro_torch.config import OptimizerConfig, ShardingConfig, TrainConfig
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import build_model
from repro_torch.training import Trainer


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny-dense")
    ap.add_argument("--arch", default=None,
                    help="assigned arch id; combined with --reduced")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = TrainConfig(
        model=args.model, batch_size=args.batch, seq_len=args.seq,
        steps=args.steps, checkpoint_dir=args.ckpt_dir,
        checkpoint_every=args.ckpt_every,
        optimizer=OptimizerConfig(lr=args.lr, total_steps=args.steps),
        sharding=ShardingConfig(gradient_accum=args.accum),
    )
    model = None
    if args.arch:
        mcfg = reduced_config(args.arch) if args.reduced \
            else get_config(args.arch)
        model = build_model(mcfg.replace(dtype="float32"),
                            sharding=cfg.sharding, param_dtype="float32",
                            device=args.device)
    trainer = Trainer(cfg, model=model, device=args.device)
    trainer.initialize(resume=not args.no_resume)
    trainer.train()


if __name__ == "__main__":
    main()
