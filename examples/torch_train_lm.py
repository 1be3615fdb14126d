"""End-to-end training on the PyTorch port: train an LM for a few
hundred steps on the synthetic structured token stream, with checkpoints
and straggler monitoring (the port's counterpart of ``train_lm.py``).
Defaults are CPU-sized; --arch accepts any registry id of a decoder-only
model (use the -smoke variants on the CPU).

Run:  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 200
      PYTHONPATH=src python examples/torch_train_lm.py --arch smollm-360m --steps 300   # on the card
"""

import argparse

from repro_torch.configs.registry import get
from repro_torch.data.pipeline import DataConfig
from repro_torch.train import optim
from repro_torch.train.loop import TrainConfig, train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m-smoke")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="build/torch_train_ckpt")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    cfg = get(args.arch)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    tcfg = TrainConfig(
        steps=args.steps,
        microbatches=args.microbatches,
        ckpt_every=50,
        ckpt_dir=args.ckpt_dir,
        log_every=10,
        opt=optim.AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps),
    )
    out = train(cfg, dcfg, tcfg, device=args.device)
    losses = out["losses"]
    print(
        f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
        f"{len(losses)} steps; stragglers flagged: {len(out['stragglers'])}"
    )


if __name__ == "__main__":
    main()
