"""In-process multi-node PNPCoin network: broadcast, re-verify, fork
choice. The port of ``repro/chain/network.py``.

N ``Node`` instances share blocks by value. On every broadcast the peer
re-verifies the payload **bit-exactly** (full: quorum re-execution +
independent Merkle recomputation; optimal/classic: deterministic argmin
replay). When a peer's tip diverges, longest-valid-chain fork choice
applies: the strictly longer chain whose every payload re-verifies wins,
and the loser's ledger *and credit book* are rebuilt from the adopted
chain. A ``Network`` is one trust domain: a shared ``VerifyCache`` lets
each unique (block hash, payload object) be verified once.

Run a 2-node smoke on the card::

    PYTHONPATH=src python -m repro_torch.chain.network --nodes 2 --blocks 4
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

from repro_torch.chain.node import BlockReceipt, Node, VerifyCache
from repro_torch.chain.workload import BlockPayload
from repro_torch.core.ledger import Block
from repro_torch.device import DeviceLike


@dataclasses.dataclass
class BroadcastResult:
    receipt: BlockReceipt
    accepted_by: List[int]
    rejected_by: List[int]


class Network:
    """N nodes, block broadcast, longest-valid-chain convergence."""

    def __init__(self, nodes: Sequence[Node], *,
                 shared_verify_cache: bool = True) -> None:
        if not nodes:
            raise ValueError("a network needs at least one node")
        self.nodes = list(nodes)
        self.log: List[BroadcastResult] = []
        # one trust domain: a node that verified a payload spares every
        # other member the §3 req. 2 re-execution.  Constructing a
        # Network around existing nodes NEVER mutates them (a read-only
        # wrapper must not enroll live nodes into a new domain behind
        # the caller's back) — only ``create``, which builds the nodes
        # itself, enrolls via ``enroll_nodes``.
        self.verify_cache = VerifyCache() if shared_verify_cache else None

    def enroll_nodes(self) -> None:
        """Enroll member nodes into this network's trust domain.
        Explicit and opt-in: nodes that opted out
        (``use_verify_cache=False``) or already belong to a domain keep
        their configuration."""
        if self.verify_cache is None:
            return
        for node in self.nodes:
            if node.use_verify_cache and node.verify_cache is None:
                node.verify_cache = self.verify_cache

    @classmethod
    def create(cls, n_nodes: int,
               node_factory: Optional[Callable[[int], Node]] = None,
               shared_verify_cache: bool = True,
               **node_kwargs) -> "Network":
        if node_factory is None and "workloads" in node_kwargs:
            # one shared Workload instance across nodes would make every
            # "re-verification" compare a stateful workload's history
            # against itself — each node needs its own instances
            raise ValueError(
                "pass workloads via node_factory=lambda i: Node(node_id=i, "
                "workloads={...fresh instances...}) so every node gets its "
                "own Workload objects — sharing one instance across nodes "
                "voids independent re-verification")
        factory = node_factory or (lambda i: Node(node_id=i, **node_kwargs))
        net = cls([factory(i) for i in range(n_nodes)],
                  shared_verify_cache=shared_verify_cache)
        net.enroll_nodes()       # create owns these nodes — see __init__
        return net

    # -- mining + gossip ----------------------------------------------
    def mine(self, origin: int = 0,
             workload: Optional[str] = None) -> BroadcastResult:
        """One node mines one block and broadcasts it to all peers."""
        receipt = self.nodes[origin].mine_block(workload)
        return self.broadcast(origin, receipt.record.to_block(), receipt)

    def broadcast(self, origin: int, block: Block,
                  receipt: BlockReceipt) -> BroadcastResult:
        result = BroadcastResult(receipt=receipt, accepted_by=[origin],
                                 rejected_by=[])
        for i, peer in enumerate(self.nodes):
            if i == origin:
                continue
            if self.deliver(origin, i, block, receipt.payload):
                result.accepted_by.append(i)
            else:
                result.rejected_by.append(i)
        self.log.append(result)
        return result

    def deliver(self, origin: int, dest: int, block: Block,
                payload: BlockPayload) -> bool:
        """Deliver one block to one peer: fast path appends to the tip;
        on tip mismatch the peer pulls the origin's whole chain and runs
        longest-valid-chain fork choice.  Duplicate deliveries (the
        block hash is already in the peer's chain — gossip is
        at-least-once) are an idempotent no-op, skipping the pointless
        full-chain re-verification a chain pull would cost."""
        peer = self.nodes[dest]
        if peer.receive(block, payload, origin=origin):
            return True
        if peer.has_block(block.block_hash):
            return False
        src = self.nodes[origin]
        if not src.ledger.blocks:
            # nothing to pull (consider_chain treats an empty candidate
            # as a caller bug and raises)
            return False
        return peer.consider_chain(src.ledger.blocks, src.chain_payloads())

    def run(self, n_blocks: int,
            schedule: Optional[Sequence[Optional[str]]] = None
            ) -> List[BroadcastResult]:
        """Round-robin mining: block i is mined by node ``i % N`` with the
        workload named by ``schedule[i]`` (None -> default policy)."""
        out = []
        for i in range(n_blocks):
            wl = schedule[i] if schedule else None
            out.append(self.mine(origin=i % len(self.nodes), workload=wl))
        return out

    # -- convergence checks -------------------------------------------
    @property
    def tips(self) -> List[str]:
        return [n.ledger.tip_hash for n in self.nodes]

    @property
    def heights(self) -> List[int]:
        return [n.ledger.height for n in self.nodes]

    def converged(self) -> bool:
        """One chain: equal tips, every chain valid, and every Merkle
        root bit-identical across nodes at every height."""
        tips = set(self.tips)
        if len(tips) != 1:
            return False
        if not all(n.ledger.verify_chain() for n in self.nodes):
            return False
        roots = {tuple(b.merkle_root for b in n.ledger.blocks)
                 for n in self.nodes}
        return len(roots) == 1


def smoke(n_nodes: int = 2, n_blocks: int = 4, verbose: bool = True,
          device: DeviceLike = None) -> int:
    """2-node smoke: a queued jash block, an optimal block, then classic
    fallback; asserts full convergence.  Returns 0 on success."""
    from repro_torch.core.jash import Jash, JashMeta, collatz_jash

    def small_collatz(max_steps: int) -> Jash:
        base = collatz_jash(max_steps=max_steps)
        return Jash(base.name, base.fn,
                    JashMeta(arg_bits=9, res_bits=32, importance=0.8),
                    example_args=base.example_args)

    net = Network.create(n_nodes, classic_arg_bits=8, device=device)
    net.nodes[0].submit(small_collatz(128))
    net.nodes[1 % n_nodes].submit(small_collatz(64))

    schedule: List[Optional[str]] = ["full", "optimal"] + \
        [None] * max(n_blocks - 2, 0)
    for res in net.run(n_blocks, schedule):
        r = res.receipt.record
        if verbose:
            print(f"height {r.height} [{r.workload:8s}] "
                  f"miner=node{res.receipt.payload.origin} "
                  f"root={r.merkle_root[:16]}… "
                  f"accepted_by={res.accepted_by}")
        assert not res.rejected_by, f"peers rejected: {res.rejected_by}"

    assert net.converged(), (net.heights, net.tips)
    assert all(n.audit_chain() for n in net.nodes)
    books = {tuple(sorted(n.book.balances.items())) for n in net.nodes}
    assert len(books) == 1, "credit books diverged"
    if verbose:
        s = net.nodes[0].state()
        print(f"converged: {n_nodes} nodes, height {s.height}, "
              f"tip {s.tip_hash[:16]}…, credits {s.total_issued:.1f}")
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    raise SystemExit(smoke(args.nodes, args.blocks, device=args.device))
