"""PNPCoin §4 use case — cellular docking brute force — as a chain
workload on the PyTorch/CUDA port (``repro_torch.chain.workloads.
DockingWorkload``); the mirror of ``examples/docking.py``:

  - pair space b = (n_r mod N_r + n_p * N_r)_2            (eq. 1)
  - 2-bit output: 01 binds / 00 no-bind / 10 did-not-terminate
  - bounded matcher (a relaxation loop with early exit, §3.2)
  - the data-bundle checksum is **bound into consensus**: the jash meta
    checksums the receptor/peptide tables, the committed ``jash_id``
    hashes the meta, and every verifier rebuilds the jash from its own
    local bundle — so a peer holding a tampered bundle rejects the
    block (demonstrated below), and vice versa.

Mined on a 2-node ``Network``: gossip, bit-exact re-verification on
receive, even §3.3 reward split on both books.

  PYTHONPATH=src python examples/torch_docking.py            # the card
  PYTHONPATH=src python examples/torch_docking.py --device cpu
"""
import argparse
import dataclasses

from repro_torch.chain import Network, Node
from repro_torch.chain.workloads import DockingBundle, DockingWorkload

N_R, N_P, SEED = 32, 32, 0

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device; default: the CUDA card")
device = ap.parse_args().device


def make_node(i: int) -> Node:
    return Node(node_id=i, device=device, workloads={
        "docking": DockingWorkload(n_r=N_R, n_p=N_P, seed=SEED,
                                   device=device)})


net = Network.create(2, node_factory=make_node)
bundle = net.nodes[0].workloads["docking"].bundle
print(f"data bundle: {N_R} receptors x {N_P} peptides, "
      f"sha256={bundle.checksum()[:16]}…")

res = net.mine(0, "docking")
p = res.receipt.payload
counts = {code: int((p.full.results[:, 0] == code).sum())
          for code in (1, 0, 2)}
print(f"pairs evaluated: {p.n_results}  binds: {counts[1]}  "
      f"no-bind: {counts[0]}  non-terminated: {counts[2]}")
print(f"merkle root: {p.merkle_root[:16]}…  accepted_by={res.accepted_by}")
assert not res.rejected_by

# -- the consensus data binding, negatively: a peer whose bundle was
#    tampered in p2p transit cannot re-derive the committed jash_id and
#    rejects the (honest) block outright -------------------------------
tampered = DockingBundle(
    receptors=bundle.receptors ^ 1, peptides=bundle.peptides)
bad_peer = Node(node_id=9, device=device, workloads={
    "docking": DockingWorkload(bundle=tampered, device=device)})
accepted = bad_peer.receive(res.receipt.record.to_block(), p, origin=0)
print(f"peer with tampered bundle accepts the block: {accepted}")
assert not accepted

# -- and a forged evidence table under the honest header fails quorum --
bad_results = p.full.results.copy()
bad_results[0, 0] ^= 1
forged = dataclasses.replace(
    p, full=dataclasses.replace(p.full, results=bad_results))
assert not net.nodes[1].workloads["docking"].verify(forged)
print("forged result table under the honest header: rejected by quorum")

assert net.converged() and all(n.audit_chain() for n in net.nodes)
books = {tuple(sorted(n.book.balances.items())) for n in net.nodes}
assert len(books) == 1
b0 = net.nodes[0].book
print(f"rewards: {b0.total_issued:.1f} split over {len(b0.balances)} "
      "miner lanes, identical on both nodes")
