"""End-to-end PoUW training driver: the port of ``repro/launch/train.py``.

Runs the PNPCoin block chain with a training-step payload: every block is
one (or ``--microsteps``) train step(s), the state digest is chained into
the ledger, miners are credited, and periodic checkpoint blocks write a
full ``.npz`` (the reference's bytes, ``train/checkpoint.py``) whose
SHA-256 digest anchors the chain. The arguments, printed lines and files
(``ckpt_<block>.npz`` with its ``.meta.json``, ``ledger.json``,
``credits.json``) are the reference driver's, plus ``--device``: it trains
on the card unless that names another device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced 1

Any registered dense config trains at its own dtype (qwen3-0.6b: bf16
weights, float32 AdamW moments, through the tensor-core flash kernels);
``--reduced 1`` takes the small float32 variant.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.configs.base import InputShape, get_config, reduced
from repro_torch.core.pow_train import PoUWTrainer
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.steps import TrainHparams


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="pnpcoin-demo")
    ap.add_argument("--reduced", type=int, default=0)
    ap.add_argument("--blocks", type=int, default=200)
    ap.add_argument("--mode", choices=("full", "optimal"), default="full")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microsteps", type=int, default=1)
    ap.add_argument("--miners", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--pop", type=int, default=8)
    ap.add_argument("--sigma", type=float, default=0.02)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--out", default="experiments/train")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    shape = InputShape("cli", args.seq, args.batch, "train")
    hp = TrainHparams(peak_lr=args.lr, warmup_steps=max(args.blocks // 20, 5),
                      total_steps=args.blocks * args.microsteps)
    trainer = PoUWTrainer(cfg, shape, hp=hp, mode=args.mode,
                          n_miners=args.miners, pop_size=args.pop,
                          sigma=args.sigma,
                          block_microsteps=args.microsteps,
                          device=args.device)
    os.makedirs(args.out, exist_ok=True)

    t0 = time.time()
    for b in range(args.blocks):
        rec = trainer.run_block()
        if b % 10 == 0 or b == args.blocks - 1:
            dt = time.time() - t0
            print(f"block {rec.height:4d} mode={rec.mode} "
                  f"loss={rec.loss:.4f} chain={rec.block_hash[:12]} "
                  f"({dt:.1f}s)", flush=True)
        if args.ckpt_every and (b + 1) % args.ckpt_every == 0:
            path = os.path.join(args.out, f"ckpt_{b + 1}.npz")
            digest = save_checkpoint(path, trainer.state,
                                     {"block": b + 1,
                                      "ledger_tip": trainer.ledger.tip_hash})
            print(f"  checkpoint {path} sha256={digest[:16]}", flush=True)

    assert trainer.ledger.verify_chain()
    with open(os.path.join(args.out, "ledger.json"), "w") as f:
        f.write(trainer.ledger.to_json())
    with open(os.path.join(args.out, "credits.json"), "w") as f:
        json.dump(trainer.book.balances, f, indent=2)
    first = trainer.history[0].loss
    last = trainer.history[-1].loss
    print(f"done: {args.blocks} blocks, loss {first:.4f} -> {last:.4f}, "
          f"credits issued {trainer.book.total_issued:.1f}, chain verified.")


if __name__ == "__main__":
    main()
