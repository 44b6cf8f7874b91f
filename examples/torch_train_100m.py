"""Train a ~100M-parameter model on the PyTorch port for a few hundred
steps on the synthetic Zipf pipeline, then save and restore its
checkpoint (the twin of ``examples/train_100m.py``).

    PYTHONPATH=src python examples/torch_train_100m.py --steps 200 \\
        --ckpt torch_100m_ckpt [--device cpu]
"""
import argparse
from dataclasses import replace

from repro_torch.config import TrainConfig, get_arch
from repro_torch.training import Trainer
from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.training.data import DataConfig, PrefetchLoader, SyntheticDataset
from repro_torch.training.optimizer import adamw_init, tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt", required=True,
                    help="the checkpoint directory (written)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # ~100M-param config: smollm-360m family narrowed (12L keeps CPU-feasible)
    cfg = replace(get_arch("smollm-360m"), name="smollm-100m", num_layers=12,
                  d_model=640, num_heads=10, num_kv_heads=5, head_dim=64,
                  d_ff=1706 * 1, vocab_size=49152, dtype="float32")
    tc = TrainConfig(learning_rate=6e-4, warmup_steps=20,
                     total_steps=args.steps)
    trainer = Trainer(cfg, tc, device=args.device)
    n = sum(x.numel() for x in tree_leaves(trainer.params))
    print(f"model: {cfg.name}, {n / 1e6:.1f}M params")

    ds = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=args.seq_len,
                                     batch_size=args.batch))
    loader = PrefetchLoader(ds)
    try:
        hist = trainer.fit(loader, steps=args.steps, log_every=20)
    finally:
        loader.close()
    assert hist[-1]["loss"] < hist[0]["loss"], "loss must decrease"
    save_checkpoint(args.ckpt, trainer.params, trainer.opt_state,
                    step=args.steps)
    p, o, s = restore_checkpoint(args.ckpt, trainer.params,
                                 adamw_init(trainer.params))
    print(f"checkpoint round-trip ok at step {s}; "
          f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")


if __name__ == "__main__":
    main()
