"""``SatWorkload`` — brute-force theorem proving as a chain payload. The
port of ``repro/chain/workloads/sat.py``.

The paper's §1 application list names "running Sledgehammer on randomly
generated theorems"; the propositional analogue is exhaustive 3-CNF
evaluation: a block's useful work is deciding one random 3-SAT instance
by evaluating every assignment (full mode, §3.3).

This is the repo's first **asymmetric** mine-hard/verify-cheap
workload.  Mining evaluates all ``2^n_vars`` assignments on the card
(each chunk's jash, then one SHA-256 launch for its hashes and leaf
digests, then one Merkle reduction for the commit); the *verdict* then
splits the verification cost:

* **SAT** — the miner commits a *satisfiability certificate* (the
  lowest satisfying assignment, 4 bytes) bound into the header via
  ``certificate_digest`` -> ``state_digest``.  A verifier re-checks the
  witness in **O(clauses)** host work — no device dispatch, no
  re-mining — exactly Bitcoin's find-hard/check-cheap shape, except the
  witness is a theorem's countermodel instead of a nonce.
* **UNSAT** — "this formula has no model" has no succinct witness
  (unless NP = coNP), so the exhaustive-refutation claim is checked the
  full-mode way: independent Merkle-root recomputation over the
  committed evaluation table plus quorum re-execution of a random
  sample, with an O(N) host scan asserting the table itself contains
  no satisfying row.

The formula family is deterministic: instance ``k`` of family ``seed``
is generated by a seeded ``RandomState``, and its clause arrays are
checksummed into the jash meta — the committed ``jash_id`` therefore
binds the exact formula bits, and verifiers **rebuild the instance
locally** (never trusting the evidence closure) before re-executing.
Names, meta and generator equal the reference's, so ``jash_id``s,
results and roots are the same bits in both packages.

The jash is a batch function, as every port jash is: the clause tables
are built on the workload's device when the jash is built, and a batch
of ``N`` assignments gathers its literals to ``(N, clauses, 3)``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.chain.workload import (BlockContext, BlockPayload,
                                        PreparedWork, RewardEntries,
                                        _apply_rewards,
                                        _batched_stateless_verify,
                                        certificate_digest, global_miner)
from repro_torch.core.executor import run_full
from repro_torch.core.jash import Jash, JashMeta
from repro_torch.core.ledger import merkle_root
from repro_torch.core.rewards import CreditBook, reward_full, reward_optimal
from repro_torch.core.verify import quorum_verify
from repro_torch.device import DeviceLike, resolve

_NAME_RE = re.compile(r"^sat3-(\d+)-k(\d+)$")


@dataclasses.dataclass(frozen=True)
class Cnf3:
    """One random 3-CNF instance: ``cl_vars[c, j]`` is the variable of
    literal ``j`` in clause ``c``, ``cl_neg[c, j]`` its polarity."""
    n_vars: int
    cl_vars: np.ndarray        # (n_clauses, 3) int64
    cl_neg: np.ndarray         # (n_clauses, 3) bool

    def checksum(self) -> str:
        """sha256 of the clause arrays — goes into the jash meta, so the
        committed ``jash_id`` binds the exact formula bits."""
        h = hashlib.sha256()
        h.update(np.int64(self.n_vars).tobytes())
        h.update(np.ascontiguousarray(self.cl_vars, np.int64).tobytes())
        h.update(np.ascontiguousarray(self.cl_neg, np.bool_).tobytes())
        return h.hexdigest()

    def unsat_count(self, assignment: int) -> int:
        """Number of clauses ``assignment`` leaves unsatisfied —
        O(clauses) host work, the certificate-check cost."""
        bits = (assignment >> np.arange(self.n_vars)) & 1
        lits = bits[self.cl_vars].astype(bool) ^ self.cl_neg
        return int(np.sum(~np.any(lits, axis=1)))


def random_cnf3(n_vars: int, n_clauses: int, seed: int) -> Cnf3:
    """Deterministic instance generator: every node calling with the
    same ``(n_vars, n_clauses, seed)`` builds bit-identical clauses."""
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    return Cnf3(n_vars=n_vars,
                cl_vars=rng.randint(0, n_vars, (n_clauses, 3)),
                cl_neg=rng.randint(0, 2, (n_clauses, 3)).astype(np.bool_))


def sat_fn(cnf: Cnf3, device: torch.device):
    """The jash function of one instance: unsatisfied clauses per
    assignment, over a 1-D int64 batch of assignments."""
    cl_vars = torch.as_tensor(cnf.cl_vars, dtype=torch.int64, device=device)
    cl_neg = torch.as_tensor(cnf.cl_neg, dtype=torch.bool, device=device)
    shifts = torch.arange(cnf.n_vars, dtype=torch.int64, device=device)

    def fn(args: torch.Tensor) -> torch.Tensor:
        bits = (args[:, None] >> shifts) & 1              # (N, n_vars)
        lits = bits[:, cl_vars].bool() ^ cl_neg           # (N, C, 3)
        return (~lits.any(dim=2)).sum(dim=1)

    return fn


class SatWorkload:
    """§1 "brute-force theorem proving": one 3-SAT decision per block.

    Stateless; implements ``verify_batch``.  A block either **proves**
    satisfiability (committed witness, O(clauses) verification) or
    **exhaustively refutes** it (committed evaluation table, quorum
    sampled) — the two paths are distinguished by the presence of the
    certificate, which the header signs via ``state_digest``.  Mining
    and verification run on ``device`` (``None``: the CUDA card).
    """

    name = "sat"
    _JASH_MEMO_MAX = 16

    def __init__(self, *, n_vars: int = 12, n_clauses: int = 48,
                 seed: int = 0, verify_fraction: float = 0.25,
                 device: DeviceLike = None) -> None:
        if not 1 <= n_vars <= 24:
            raise ValueError(f"n_vars must be in [1, 24], got {n_vars}")
        self.n_vars = n_vars
        self.n_clauses = n_clauses
        self.seed = seed
        self.verify_fraction = verify_fraction
        self.device = resolve(device)
        # jash objects memoized per instance index: a stable fn identity
        # is what lets the batched quorum group per instance and keeps the
        # clause tables on the card across the blocks of one instance
        self._jash_memo: Dict[int, Tuple[Cnf3, Jash]] = {}

    # -- deterministic instance family --------------------------------
    def instance(self, k: int) -> Tuple[Cnf3, Jash]:
        """Formula ``k`` of this family plus its jash (memoized)."""
        hit = self._jash_memo.get(k)
        if hit is not None:
            return hit
        cnf = random_cnf3(self.n_vars, self.n_clauses,
                          (self.seed * 0x9E3779B1 + k) & 0x7FFFFFFF)
        jash = Jash(f"sat3-{self.seed}-k{k}", sat_fn(cnf, self.device),
                    JashMeta(arg_bits=self.n_vars, res_bits=32,
                             data_checksum=cnf.checksum(),
                             description="random 3-CNF exhaustive "
                                         "decision (paper §1)"),
                    example_args=(torch.zeros(1, dtype=torch.int64,
                                              device=self.device),))
        if len(self._jash_memo) >= self._JASH_MEMO_MAX:
            self._jash_memo.pop(next(iter(self._jash_memo)))
        self._jash_memo[k] = (cnf, jash)
        return cnf, jash

    def _expected(self, payload: BlockPayload
                  ) -> Optional[Tuple[Cnf3, Jash]]:
        """Rebuild the instance a payload claims — **locally**, from the
        family generator, never from the evidence closure.  The claimed
        instance index rides in the jash name; the rebuilt
        ``source_id()`` (which hashes the clause checksum) must then
        match the committed ``jash_id``, so a payload lying about its
        index or formula bits is rejected before any execution."""
        if payload.jash is None:
            return None
        m = _NAME_RE.match(payload.jash.name)
        if m is None or int(m.group(1)) != self.seed:
            return None
        cnf, jash = self.instance(int(m.group(2)))
        if jash.source_id() != payload.jash_id:
            return None
        return cnf, jash

    # -- Workload protocol --------------------------------------------
    def prepare(self, ctx: BlockContext) -> PreparedWork:
        """Self-publishing: instance ``k = ctx.height`` by default (one
        fresh theorem per block).  The chain does not care *which*
        instance a block decides — consensus binds the formula bits via
        the checksum in ``jash_id`` — so ``ctx.work`` sizing is ignored:
        trimming the arg space would void the exhaustiveness claim."""
        _, jash = self.instance(ctx.height)
        return PreparedWork(ctx, jash)

    def mine(self, work: PreparedWork) -> BlockPayload:
        """Evaluate every assignment (full mode), then commit either the
        lowest satisfying assignment as the certificate (SAT) or the
        bare evaluation table (UNSAT refutation)."""
        ctx, jash = work.ctx, work.jash
        full = run_full(jash, lanes=ctx.lanes, device=self.device)
        sat_rows = np.nonzero(full.results[:, 0] == 0)[0]
        cert: Optional[bytes] = None
        winner: Optional[int] = None
        n_miners = int(full.miner_of.max()) + 1 if len(full.miner_of) else 1
        if len(sat_rows):
            witness = int(full.args[sat_rows[0]])
            cert = np.uint32(witness).tobytes()
            winner = global_miner(ctx.node_id,
                                  int(full.miner_of[sat_rows[0]]))
        return BlockPayload(
            workload=self.name, jash_id=jash.source_id(),
            merkle_root=full.commit_root(), n_results=len(full.args),
            winner=winner, state_digest=certificate_digest(cert),
            origin=ctx.node_id, block_reward=ctx.block_reward,
            jash=jash, full=full, n_miners=n_miners, certificate=cert)

    def _verify_certificate(self, cnf: Cnf3, jash: Jash,
                            payload: BlockPayload) -> bool:
        """The O(clauses) SAT path: digest-bind the witness to the
        header, then evaluate it against the locally rebuilt clauses.
        No device dispatch, no evidence table access — this is the
        whole asymmetry."""
        if certificate_digest(payload.certificate) != payload.state_digest:
            return False
        if len(payload.certificate) != 4:
            return False
        witness = int(np.frombuffer(payload.certificate, "<u4")[0])
        if witness >= jash.meta.n_args:
            return False
        if payload.winner is None or payload.n_miners < 1:
            return False
        if payload.winner != global_miner(payload.origin,
                                          witness % payload.n_miners):
            return False               # credit must follow the witness lane
        return cnf.unsat_count(witness) == 0

    def _refutation_prechecks(self, jash: Jash,
                              payload: BlockPayload) -> bool:
        """Everything the UNSAT path checks *before* the (batched or
        scalar) root + quorum work: the claim must be certificate-free,
        exhaustive, and self-consistent — a table containing a
        satisfying row refutes its own refutation."""
        full = payload.full
        if full is None or payload.certificate is not None:
            return False
        if payload.state_digest != "" or payload.winner is not None:
            return False
        if len(full.args) != jash.meta.n_args:
            return False                # not exhaustive — no refutation
        return not bool((full.results[:, 0] == 0).any())

    def verify(self, payload: BlockPayload) -> bool:
        """Certificate blocks verify in O(clauses); refutation blocks
        pay the full-mode audit (independent hashlib root + quorum
        re-execution **with the locally rebuilt jash**, so a payload
        pairing an honest checksum with an impostor function still
        re-executes against the real formula).  Stateless."""
        exp = self._expected(payload)
        if exp is None:
            return False
        cnf, jash = exp
        if payload.certificate is not None:
            return self._verify_certificate(cnf, jash, payload)
        if not self._refutation_prechecks(jash, payload):
            return False
        if merkle_root(list(payload.full.merkle_leaves),
                       backend="hashlib") != payload.merkle_root:
            return False
        return quorum_verify(jash, payload.full,
                             fraction=self.verify_fraction,
                             device=self.device).ok

    def verify_batch(self, payloads: Sequence[BlockPayload]) -> List[bool]:
        """``verify`` over a segment, bit-identical per payload.

        Certificate blocks are already O(clauses) each — they resolve
        during classification.  Refutation blocks batch the two O(N)
        costs across the segment via the shared
        ``_batched_stateless_verify`` engine (one SHA-256 launch and one
        Merkle reduction per shape group on the card), replaying against
        the locally rebuilt instance.  No content dedup: instance
        ``k = height`` makes same-chain SAT payloads distinct by
        construction, and classification already pins each payload to
        one local fn."""

        def classify(p: BlockPayload):
            exp = self._expected(p)
            if exp is None:
                return False
            cnf, jash = exp
            if p.certificate is not None:
                return self._verify_certificate(cnf, jash, p)
            if not self._refutation_prechecks(jash, p):
                return False
            return jash, None

        return _batched_stateless_verify(payloads, classify,
                                         fraction=self.verify_fraction,
                                         device=self.device)

    def reward(self, book: CreditBook, payload: BlockPayload
               ) -> RewardEntries:
        """SAT: the lane that found the witness takes the block (the
        find-hard/check-cheap shape pays the finder, as in Bitcoin).
        UNSAT: refutation was genuinely collective — even split over
        the first-submitter lanes of the evaluation table."""
        staged = CreditBook()
        if payload.winner is not None:
            reward_optimal(staged, payload.winner, payload.block_reward)
        else:
            submitters = [global_miner(payload.origin, m)
                          for m in payload.full.miner_of]
            reward_full(staged, submitters, payload.block_reward)
        return _apply_rewards(book, staged)
