"""The paper's §1 application list as chain workloads on the PyTorch/CUDA
port: the mirror of ``examples/np_problems.py``.

1. **Brute-force theorem proving**: ``SatWorkload``, each block decides
   one random 3-CNF exhaustively. A SAT block commits a satisfiability
   certificate the peer re-checks in O(clauses), with no re-mining, while
   an UNSAT refutation stays quorum-sampled.
2. **GAN inversion**: ``GanInversionWorkload``, each block is one
   optimal-mode refinement round over a latent grid; accepting a block
   zooms the grid around the winner (stateful: verification doubles as
   state sync, like training blocks).

Both families mine on a 2-node ``Network``: every block is gossiped,
re-verified bit for bit by the peer, and rewarded identically on both
credit books. On the card SAT runs the SHA-256 and Merkle kernels and the
GAN evaluates its grid there.

  PYTHONPATH=src python examples/torch_np_problems.py                # the card
  PYTHONPATH=src python examples/torch_np_problems.py --device cpu
"""
import argparse

from repro_torch.chain import Network, Node
from repro_torch.chain.workloads import GanInversionWorkload, SatWorkload

N_VARS, N_CLAUSES = 12, 48

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device; default: the CUDA card")
device = ap.parse_args().device


def make_node(i: int) -> Node:
    # fresh workload instances per node (same seeds, so both nodes hold
    # the same formula family and inverse problem)
    return Node(node_id=i, classic_arg_bits=6, device=device, workloads={
        "sat": SatWorkload(n_vars=N_VARS, n_clauses=N_CLAUSES, seed=1,
                           device=device),
        "gan": GanInversionWorkload(seed=0, grid_bits=10, device=device),
    })


net = Network.create(2, node_factory=make_node)

print("== brute-force SAT (full mode, §1 'theorem proving') ==")
for b in range(3):
    res = net.mine(b % 2, "sat")
    p = res.receipt.payload
    verdict = (f"SAT, witness={int.from_bytes(p.certificate, 'little')} "
               f"(peer checked {N_CLAUSES} clauses, no re-mine)"
               if p.certificate is not None
               else "UNSAT — exhaustively refuted (peer quorum-sampled)")
    print(f"  block {res.receipt.record.height}: 2^{N_VARS} assignments "
          f"-> {verdict}; accepted_by={res.accepted_by}")
    assert not res.rejected_by

print("== GAN inversion (optimal mode, §1) ==")
for b in range(4):                      # each refinement round is a block
    res = net.mine(b % 2, "gan")
    gan = net.nodes[0].workloads["gan"]
    print(f"  round {res.receipt.payload.train_height}: winner "
          f"arg={res.receipt.payload.best_arg:4d} "
          f"err={gan.inversion_error():.4f}")
    assert not res.rejected_by

err = net.nodes[0].workloads["gan"].inversion_error()
assert err < 1.0, err
# both nodes replayed every round -> bit-identical search state
assert (net.nodes[0].workloads["gan"].state_digest()
        == net.nodes[1].workloads["gan"].state_digest())
print(f"  inverted: ||G(z)-x*||^2 = {err:.4f} after 4 blocks "
      "(both nodes hold the same grid state)")

assert net.converged()
assert all(n.audit_chain() for n in net.nodes)
books = {tuple(sorted(n.book.balances.items())) for n in net.nodes}
assert len(books) == 1, "credit books diverged"
s = net.nodes[0].state()
print(f"converged: height {s.height}, credits {s.total_issued:.1f} "
      f"over {len(s.balances)} miners, books bit-identical")
