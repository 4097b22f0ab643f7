"""Optimal-mode ES mining through the chain API on the PyTorch/CUDA port:
the mirror of ``examples/es_search.py`` (§3.3 and §1 "next optimum in
hyperdimensional SGD"). Every block, each miner lane evaluates perturbed
parameter candidates; the lowest loss is "the result with most leading
zeros" and wins the block.

Two ``Node``s each carry a ``TrainingWorkload`` wrapping an identically
seeded optimal-mode trainer, mine alternately on a ``Network``, and the
peer re-executes every ES block on receive (verification doubles as
state sync: both nodes end at the same weights). The ES-gradient update
demo (reusing all submitted results) rides at the end. On the card every
candidate is scored through the flash forward's serving kernel.

  PYTHONPATH=src python examples/torch_es_search.py                 # the card
  PYTHONPATH=src python examples/torch_es_search.py --device cpu
"""
import argparse
import dataclasses

from repro_torch import random
from repro_torch.chain import Network, Node, TrainingWorkload
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import InputShape
from repro_torch.core import es as es_mod
from repro_torch.core.pow_train import PoUWTrainer
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.train.steps import make_eval_step, make_train_state

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device; default: the CUDA card")
device = ap.parse_args().device

# ES's signal-to-noise at LM scale requires a small payload and a fixed
# block batch ("find THE next optimum", §1): candidate 0 is always the
# incumbent, so the accepted loss never rises on the block batch.
cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b")),
                          n_layers=2, d_model=64, n_heads=2, n_kv_heads=1,
                          head_dim=32, d_ff=128, vocab_size=256)
shape = InputShape("es", 32, 8, "train")
N_BLOCKS = 8


def trainer_factory():
    # the same seed on every node: re-execution on receive must land on
    # bit-identical weights (that is the §3 req. 2 audit)
    return PoUWTrainer(cfg, shape, mode="optimal", n_miners=8, pop_size=32,
                       sigma=0.02, seed=0, fixed_batch=True, device=device)


net = Network.create(2, node_factory=lambda i: Node(
    node_id=i, device=device,
    workloads={"training": TrainingWorkload(trainer_factory)}))

print("== optimal-mode ES chain (2 nodes, winner-takes-block) ==")
for b in range(N_BLOCKS):
    res = net.mine(b % 2, "training")
    r = res.receipt
    assert not res.rejected_by, res.rejected_by
    print(f"  block {r.record.height}: miner=node{r.payload.origin} "
          f"winner={r.payload.winner} loss={r.payload.loss:.4f}")

losses = [p.loss for p in net.nodes[0].chain_payloads()]
print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
      f"converged: {net.converged()}")
assert net.converged()
books = {tuple(sorted(n.book.balances.items())) for n in net.nodes}
assert len(books) == 1, "credit books diverged"
print("credit balances:",
      {k: round(v, 1)
       for k, v in sorted(net.nodes[0].book.balances.items())})

# --- beyond-paper: ES-gradient update from the same submissions -----------
pipe = SyntheticTokenPipeline(cfg, shape, seed=3)
state = make_train_state(cfg, random.key(1), device)
eval_step = make_eval_step(cfg)
params = state.params
key = random.key(2)
fixed = pipe.batch(0)
losses0 = float(eval_step(params, fixed))
for step in range(20):
    key, sub = random.split(key)
    losses, best = es_mod.es_block(eval_step, params, fixed, sub,
                                   pop_size=32, sigma=0.02)
    params = es_mod.es_update(params, sub, losses, sigma=0.02, lr=0.05)
lossesN = float(eval_step(params, fixed))
print(f"ES-gradient (all submissions reused): {losses0:.4f} -> {lossesN:.4f}")
