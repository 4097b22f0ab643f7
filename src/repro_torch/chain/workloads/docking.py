"""``DockingWorkload`` — the paper's §4 cellular-docking walkthrough as
a chain payload, with the data bundle bound into consensus. The port of
``repro/chain/workloads/docking.py``.

§4's use case: screen every (receptor, peptide) pair with a bounded
matcher — pair space ``b = (n_r mod N_r + n_p * N_r)₂`` (eq. 1), 2-bit
output (01 binds / 00 no-bind / 10 did-not-terminate), the relaxation
loop converted to bounded complexity via ``bounded_while`` (§3.2).

What makes it more than a standalone script is the **data-bundle
checksum in the consensus path**: the per-receptor/peptide feature
tables are a ``DockingBundle`` whose sha256 goes into the jash meta
(``data_checksum``), and the meta is hashed into the committed
``jash_id``.  Every verifier rebuilds the jash from its *own local
bundle* and requires ``source_id()`` to match the committed id before
re-executing — so a peer whose bundle was tampered in p2p transit
rejects honest blocks (it cannot re-derive their id), and a miner who
screened tampered data cannot get its blocks past honest peers (wrong
id, or — if it forges the honest checksum — quorum re-execution
against the honest tables mismatches).  Data integrity is not a side
channel; it is part of block validity.

The matcher is a batch function on the workload's device: the bundle's
tables are put there when the jash is built, and the reference's uint32
arithmetic runs in int64 masked to 32 bits.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.chain.workload import (BlockContext, BlockPayload,
                                        PreparedWork, RewardEntries,
                                        _apply_rewards,
                                        _batched_stateless_verify,
                                        global_miner)
from repro_torch.core.executor import run_full
from repro_torch.core.jash import Jash, JashMeta, bounded_while
from repro_torch.core.ledger import merkle_root
from repro_torch.core.rewards import CreditBook, reward_full
from repro_torch.core.verify import quorum_verify
from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels.native import MASK32

# 2654435761 - 2**32: the same product modulo 2**32 as the reference's
# uint32 multiply, and a 32-bit operand times it stays inside int64
# (2654435761 itself would overflow once r ^ p >= 2**31)
_GOLDEN = 2654435761 - (1 << 32)


@dataclasses.dataclass(frozen=True)
class DockingBundle:
    """The §4 data bundle: per-receptor and per-peptide feature words,
    acquired out-of-band (the paper says p2p fileshare) and checksummed
    into the jash meta so consensus binds the exact bytes."""
    receptors: np.ndarray      # (n_r,) uint32
    peptides: np.ndarray       # (n_p,) uint32

    def checksum(self) -> str:
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(self.receptors, np.uint32).tobytes())
        h.update(np.ascontiguousarray(self.peptides, np.uint32).tobytes())
        return h.hexdigest()

    @classmethod
    def generate(cls, n_r: int = 32, n_p: int = 32,
                 seed: int = 0) -> "DockingBundle":
        """Deterministic stand-in for the fileshare download — every
        node generating with the same ``(n_r, n_p, seed)`` holds
        bit-identical tables."""
        rng = np.random.RandomState(seed & 0x7FFFFFFF)
        return cls(
            receptors=rng.randint(0, 1 << 16, (n_r,), dtype=np.uint32),
            peptides=rng.randint(0, 1 << 16, (n_p,), dtype=np.uint32))


def matcher_fn(bundle: DockingBundle, device: torch.device, *,
               max_steps: int, bind_threshold: int):
    """The bounded relaxation loop (paper §4 / Fig. 2-3 transform) over a
    1-D int64 batch of pair indices: binds if the energy drops under
    threshold fast enough."""
    receptors = torch.as_tensor(
        np.asarray(bundle.receptors, np.uint32).astype(np.int64),
        device=device)
    peptides = torch.as_tensor(
        np.asarray(bundle.peptides, np.uint32).astype(np.int64),
        device=device)
    n_r, n_p = len(bundle.receptors), len(bundle.peptides)

    def fn(b: torch.Tensor) -> torch.Tensor:
        r = receptors[b % n_r]
        # args past the pair space (a lane's padding, discarded by the
        # executor) read the last peptide, as the reference's clamped
        # gather does
        p = peptides[torch.clamp(b // n_r, max=n_p - 1)]
        e0 = (((r ^ p) * _GOLDEN) & MASK32) >> 16

        def cond(s):
            return s[0] > 100

        def body(s):
            e, t = s
            return (e - (e >> 3) - 1) & MASK32, t + 1

        (_, steps), terminated = bounded_while(
            cond, body, (e0, torch.zeros_like(e0)), max_steps=max_steps)
        # 01 binds / 00 no-bind / 10 did not terminate (§4)
        return torch.where(~terminated, 0b10,
                           torch.where(steps < bind_threshold, 0b01, 0b00))

    return fn


class DockingWorkload:
    """§4 docking brute force: one full screening campaign per block.

    Stateless; implements ``verify_batch`` (content-dedup + batched
    roots + batched quorum, like full mode — repeated screenings of one
    bundle produce byte-identical evidence, so a chain of docking
    blocks re-verifies at the cost of one).  Reward: even split over
    first submissions (§3.3 full-mode rule).  Mining and verification
    run on ``device`` (``None``: the CUDA card).
    """

    name = "docking"

    def __init__(self, bundle: Optional[DockingBundle] = None, *,
                 n_r: int = 32, n_p: int = 32, seed: int = 0,
                 max_steps: int = 64, bind_threshold: int = 24,
                 verify_fraction: float = 0.25,
                 device: DeviceLike = None) -> None:
        self.bundle = bundle if bundle is not None \
            else DockingBundle.generate(n_r, n_p, seed)
        self.n_r = len(self.bundle.receptors)
        self.n_p = len(self.bundle.peptides)
        self.max_steps = max_steps
        self.bind_threshold = bind_threshold
        self.verify_fraction = verify_fraction
        self.device = resolve(device)
        self._jash = self._build_jash()

    def _build_jash(self) -> Jash:
        fn = matcher_fn(self.bundle, self.device, max_steps=self.max_steps,
                        bind_threshold=self.bind_threshold)
        n_pairs = self.n_r * self.n_p
        arg_bits = max(int(np.ceil(np.log2(max(n_pairs, 2)))), 1)
        return Jash("docking-matcher", fn,
                    JashMeta(arg_bits=arg_bits, res_bits=2,
                             max_arg=n_pairs,
                             data_checksum=self.bundle.checksum(),
                             data_acquisition="p2p",
                             importance=0.9,
                             description="peptide-receptor docking "
                                         "(paper §4)"),
                    example_args=(torch.zeros(1, dtype=torch.int64,
                                              device=self.device),))

    # -- Workload protocol --------------------------------------------
    def prepare(self, ctx: BlockContext) -> PreparedWork:
        """Self-publishing: the campaign jash is fixed by the local
        bundle.  ``ctx.work`` sizing is ignored — a partial screening
        is not the §4 claim (and would change ``jash_id``, which the
        bundle checksum pins)."""
        return PreparedWork(ctx, self._jash)

    def mine(self, work: PreparedWork) -> BlockPayload:
        """Screen every pair on the card and Merkle-commit the result
        table."""
        ctx = work.ctx
        full = run_full(self._jash, lanes=ctx.lanes, device=self.device)
        return BlockPayload(
            workload=self.name, jash_id=self._jash.source_id(),
            merkle_root=full.commit_root(), n_results=len(full.args),
            origin=ctx.node_id, block_reward=ctx.block_reward,
            jash=self._jash, full=full)

    def _prechecks(self, payload: BlockPayload) -> bool:
        """Everything before the root + quorum work.  The first check is
        the consensus data binding: the committed id must equal the id
        this node derives from its **own** bundle — a tampered local
        bundle (or a block mined against one) fails here."""
        if payload.jash_id != self._jash.source_id():
            return False
        full = payload.full
        return (full is not None
                and len(full.args) == self._jash.meta.n_args
                and payload.winner is None
                and payload.state_digest == "")

    def verify(self, payload: BlockPayload) -> bool:
        """Full-mode audit against the local bundle: independent hashlib
        root recomputation plus quorum re-execution **with the locally
        built jash** — evidence closures are never executed, so forged
        checksums meet the honest tables and mismatch.  Stateless."""
        if not self._prechecks(payload):
            return False
        if merkle_root(list(payload.full.merkle_leaves),
                       backend="hashlib") != payload.merkle_root:
            return False
        return quorum_verify(self._jash, payload.full,
                             fraction=self.verify_fraction,
                             device=self.device).ok

    def verify_batch(self, payloads: Sequence[BlockPayload]) -> List[bool]:
        """``verify`` over a segment, bit-identical per payload.
        Byte-identical payloads (what deterministic re-screening of one
        bundle produces) collapse to one representative; distinct ones
        share one batched root recomputation and one stacked quorum
        dispatch (all docking blocks replay the *local* jash fn, which
        ``_prechecks`` already pinned via the committed id — the fn
        object still rides in the dedup key to keep the key's contract
        self-contained)."""

        def classify(p: BlockPayload):
            if not self._prechecks(p):
                return False
            key = (self._jash.fn, p.merkle_root,
                   hashlib.sha256(p.full.packed_words().tobytes())
                   .digest())
            return self._jash, key

        return _batched_stateless_verify(payloads, classify,
                                         fraction=self.verify_fraction,
                                         device=self.device)

    def reward(self, book: CreditBook, payload: BlockPayload
               ) -> RewardEntries:
        """§3.3 full-mode rule: even split over first submissions
        (``full.miner_of`` mapped into the origin node's lanes) —
        derived only from the payload, so rebuilt books agree."""
        staged = CreditBook()
        submitters = [global_miner(payload.origin, m)
                      for m in payload.full.miner_of]
        reward_full(staged, submitters, payload.block_reward)
        return _apply_rewards(book, staged)
