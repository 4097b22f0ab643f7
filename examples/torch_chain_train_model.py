"""Real-model proof-of-useful-work on the PyTorch/CUDA port: two nodes
chain-train ``pnpcoin-demo``.

The mirror of ``examples/chain_train_model.py``. A 2-node ``Network``
mines four ``ModelTrainingWorkload`` blocks on the ~2M-parameter
``pnpcoin-demo`` LM (miners alternate; the other node verifies each
block by re-executing its microbatches on its own state and comparing
the canonical params digest bit for bit), then:

1. crash/recover: node 0's journal is replayed into a fresh shell by
   ``Node.recover``; the recovered chain and weights equal the donor's;
2. mid-chain reorg: the recovered node mines a private block, loses the
   fork race, and ``consider_chain`` rolls its optimizer back and
   re-syncs it onto the winning chain, digests equal.

On the card the attention forward and backward of every training step
run as the hand-written flash kernels.

  PYTHONPATH=src python examples/torch_chain_train_model.py            # the card
  PYTHONPATH=src python examples/torch_chain_train_model.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.chain import ChainStore, Network, Node
from repro_torch.chain.workloads import ModelTrainingWorkload
from repro_torch.configs import get_config

SEQ_LEN, BATCH, MICROSTEPS = 32, 4, 2

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device; default: the CUDA card")
device = ap.parse_args().device


def make_node(i: int, **kwargs) -> Node:
    wl = ModelTrainingWorkload(cfg=get_config("pnpcoin-demo"),
                               seq_len=SEQ_LEN, batch=BATCH,
                               block_microsteps=MICROSTEPS, n_miners=2,
                               device=device)
    return Node(node_id=i, classic_arg_bits=6, device=device,
                workloads={"model_train": wl}, **kwargs)


store = ChainStore()                 # node 0's durable journal
net = Network.create(2, node_factory=lambda i: make_node(
    i, **({"store": store} if i == 0 else {})))

# --- four real train-step blocks, miners alternating ----------------------
for b in range(4):
    res = net.mine(b % 2, "model_train")
    assert not res.rejected_by, f"peers rejected: {res.rejected_by}"
    p = res.receipt.payload
    print(f"height {res.receipt.record.height} [model_train] "
          f"miner=node{p.origin} step={p.train_height} "
          f"loss={p.loss:.4f} digest={p.state_digest[:16]}…")

assert net.converged(), (net.heights, net.tips)
a, b = net.nodes
digests = {n.workloads["model_train"].state_digest() for n in net.nodes}
assert len(digests) == 1, "model weights diverged"
books = {tuple(sorted(n.book.balances.items())) for n in net.nodes}
assert len(books) == 1, "credit books diverged"
print(f"\nconverged: height {a.ledger.height}, params digest "
      f"{digests.pop()[:16]}… on both nodes")

# --- crash/recover: journal replay into a fresh shell ---------------------
rec = Node.recover(store, node=make_node(0))
assert rec.last_recovery.adopted_height == a.ledger.height
assert [blk.block_hash for blk in rec.ledger.blocks] == \
    [blk.block_hash for blk in a.ledger.blocks]
assert rec.workloads["model_train"].state_digest() == \
    a.workloads["model_train"].state_digest()
assert rec.book.balances == a.book.balances
print(f"recovered: {rec.last_recovery.adopted_height} blocks replayed "
      f"from the journal, weights byte-identical")

# --- mid-chain reorg: private block loses the fork race -------------------
rec.mine_block("model_train")        # private: height 5, train step 4
r5 = b.mine_block("model_train")     # competing step 4 on the public chain
b.mine_block("classic")              # public chain wins on height
assert rec.consider_chain([blk for blk in b.ledger.blocks],
                          b.chain_payloads())
assert rec.workloads["model_train"].round == r5.payload.train_height + 1
assert rec.workloads["model_train"].state_digest() == \
    b.workloads["model_train"].state_digest()
assert np.isfinite(r5.payload.loss)
print(f"reorged: private step rolled back, re-synced to height "
      f"{rec.ledger.height}, weights bit-equal to the winning chain "
      f"(digest {b.workloads['model_train'].state_digest()[:16]}…)")
print("\nok")
