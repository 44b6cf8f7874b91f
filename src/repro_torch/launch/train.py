"""Training entry point of the port: train a model on the synthetic Zipf
pipeline, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --reduced --device cpu --steps 100 [--ckpt DIR]

``--device`` defaults to ``cuda`` and fails without a card. ``--ckpt``
writes the reference's checkpoint layout (``training/checkpoint.py``),
which ``restore_checkpoint`` reads back into a parameter tree for an
``Engine``.
"""
from __future__ import annotations

import argparse

from repro_torch.config import ARCH_IDS, TrainConfig, get_arch
from repro_torch.training import Trainer
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import DataConfig, PrefetchLoader, \
    SyntheticDataset
from repro_torch.training.optimizer import tree_leaves


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for smoke runs)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tc = TrainConfig(learning_rate=args.lr,
                     warmup_steps=max(args.steps // 10, 5),
                     total_steps=args.steps)
    trainer = Trainer(cfg, tc, device=args.device)
    n = sum(t.numel() for t in tree_leaves(trainer.params))
    print(f"training {cfg.name}: {n / 1e6:.1f}M params, {args.steps} steps "
          f"on {trainer.device}")
    ds = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=args.seq_len,
                                     batch_size=args.batch))
    loader = PrefetchLoader(ds)
    try:
        hist = trainer.fit(loader, steps=args.steps, log_every=10)
    finally:
        loader.close()
    print(f"final loss {hist[-1]['loss']:.4f} (ppl {hist[-1]['ppl']:.1f})")
    if args.ckpt:
        save_checkpoint(args.ckpt, trainer.params, trainer.opt_state,
                        step=args.steps)
        print(f"checkpoint saved to {args.ckpt}")


if __name__ == "__main__":
    main()
