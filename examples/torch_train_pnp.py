"""Proof-of-useful-work training through the chain API on the PyTorch/CUDA
port: the mirror of ``examples/train_pnp.py``. It trains the ~2M-param
pnpcoin-demo LM, each block one training step mined by a ``Node``
carrying a ``TrainingWorkload``, state digests chained into the ledger,
miners credited. On the card every step runs the attention forward and
backward as the hand-written flash kernels.

  PYTHONPATH=src python examples/torch_train_pnp.py [--blocks 300]   # the card
  PYTHONPATH=src python examples/torch_train_pnp.py --device cpu --blocks 3
"""
import argparse

from repro_torch.chain import Node, TrainingWorkload
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.pow_train import PoUWTrainer
from repro_torch.train.steps import TrainHparams

ap = argparse.ArgumentParser()
ap.add_argument("--blocks", type=int, default=300)
ap.add_argument("--batch", type=int, default=16)
ap.add_argument("--seq", type=int, default=128)
ap.add_argument("--miners", type=int, default=8)
ap.add_argument("--lr", type=float, default=1e-3)
ap.add_argument("--device", default=None,
                help="torch device; default: the CUDA card")
args = ap.parse_args()

cfg = get_config("pnpcoin-demo")
shape = InputShape("cli", args.seq, args.batch, "train")
hp = TrainHparams(peak_lr=args.lr, warmup_steps=max(args.blocks // 20, 5),
                  total_steps=args.blocks)
node = Node(device=args.device, workloads={"training": TrainingWorkload(
    lambda: PoUWTrainer(cfg, shape, hp=hp, mode="full",
                        n_miners=args.miners, device=args.device))})

for b in range(args.blocks):
    r = node.mine_block("training")
    if b % 10 == 0 or b == args.blocks - 1:
        print(f"block {r.record.height:4d} loss={r.payload.loss:.4f} "
              f"chain={r.record.block_hash[:12]} ({r.block_time_s:.2f}s)",
              flush=True)

s = node.state()
assert s.chain_valid
losses = [p.loss for p in node.chain_payloads()]
print(f"done: {args.blocks} blocks, loss {losses[0]:.4f} -> "
      f"{losses[-1]:.4f}, credits issued {s.total_issued:.1f}, "
      f"chain verified.")
