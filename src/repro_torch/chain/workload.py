"""The ``Workload`` protocol: what a block's useful work *is*. The port of
``repro/chain/workload.py``: the full, optimal, classic and training
payloads.

Each is a ``Workload``: ``prepare(ctx) -> PreparedWork`` (resolve the
published jash against the block's work target), ``mine(work) ->
BlockPayload`` (produce the commitment + evidence), ``verify(payload)
-> bool`` (bit-exact re-execution — the §3 req. 2 determinism audit any
peer runs on receive), and ``reward(book, payload)`` (credit miners,
deterministically derivable from the payload so every node's book
agrees). Mining and verification run on the workload's device.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import (Callable, Dict, List, Optional, Protocol, Sequence,
                    Tuple, runtime_checkable)

import numpy as np
import torch

from repro_torch.core.authority import classic_jash
from repro_torch.core.executor import FullResult, run_full, run_optimal
from repro_torch.core.jash import Jash, JashMeta
from repro_torch.core.ledger import merkle_root
from repro_torch.core.rewards import CreditBook, reward_full, reward_optimal
from repro_torch.core.verify import (quorum_verify, quorum_verify_batched,
                                     recompute_roots_batched)
from repro_torch.device import DeviceLike, resolve

# Global miner-id lane: chain-level miner id = node_id * MINER_LANE +
# local lane, so per-node credit books agree on who earned what
# without coordinating id allocation.
MINER_LANE = 1 << 16


def global_miner(node_id: int, local: int) -> int:
    return int(node_id) * MINER_LANE + int(local)


class ChainError(RuntimeError):
    """A block failed verification or could not be committed."""


@dataclasses.dataclass(frozen=True)
class BlockContext:
    """Everything a workload needs to know about the block being mined.

    ``lanes`` is the miner partition on one card (``Node(n_lanes=k)``);
    lane ``l`` of node ``i`` is credited as ``global_miner(i, l)``. Lanes
    never change the mined bits, so peers verify with ``lanes=1``."""
    height: int
    prev_hash: str
    node_id: int = 0
    jash: Optional[Jash] = None        # RA publication ("queued"/"classic")
    source: str = "queued"
    work: Optional[int] = None         # args-per-block target (§3.1/§5)
    block_reward: float = 50.0
    lanes: int = 1                     # miner lanes on the card
    device: Optional[torch.device] = None


@dataclasses.dataclass(frozen=True)
class PreparedWork:
    """A resolved block assignment: the exact jash the miners will run."""
    ctx: BlockContext
    jash: Optional[Jash]


@dataclasses.dataclass
class BlockPayload:
    """Block commitment + in-process evidence.

    The committed fields (``jash_id`` .. ``state_digest``) are what the
    ledger header signs; the evidence fields carry enough for a peer to
    re-verify bit-exactly (in-process today, serialized on the wire
    later). The port's full, optimal and classic workloads fill none of
    ``loss`` .. ``micro_proof``; they keep the reference's names, order
    and defaults so later workloads and the journal read one layout.

    ``certificate`` is the verify-cheap evidence channel: a workload
    whose block carries a succinct proof (a SAT witness, an inclusion
    path, ...) puts the raw certificate bytes here and commits
    ``certificate_digest(certificate)`` as the block's ``state_digest``,
    so the header signs the certificate and a tampered certificate under
    an honest header fails the digest cross-check before the workload
    looks at it. Stateful workloads instead use ``state_digest`` for
    their chained state commitment; a workload is one or the other.
    ``train_height`` doubles as the generic stateful sequence index: the
    position of this block in the workload's own state chain (train step
    for training, refinement round for GAN inversion). ``micro_proof`` is
    the model-training evidence channel: a ``(block_microsteps, 64)
    uint8`` array of per-microstep ``(batch_digest, metrics_digest)``
    sha256 pairs whose leaves re-derive ``merkle_root``; a verifier
    checks the binding cheaply, then replays the microsteps and must
    reproduce every row bit-exactly (so a divergence is attributed to its
    exact microstep)."""
    workload: str                      # "full" | "optimal" | "classic"
    jash_id: str
    merkle_root: str
    n_results: int
    winner: Optional[int] = None       # global miner id
    best_res: Optional[str] = None
    state_digest: str = ""
    origin: int = 0                    # node id that mined the block
    block_reward: float = 50.0
    # evidence ----------------------------------------------------------
    jash: Optional[Jash] = None
    full: Optional[FullResult] = None
    best_arg: Optional[int] = None
    loss: Optional[float] = None
    train_height: Optional[int] = None
    n_miners: int = 1
    certificate: Optional[bytes] = None
    micro_proof: Optional[np.ndarray] = None


def certificate_digest(cert: Optional[bytes]) -> str:
    """Consensus binding for verify-cheap certificates: the hex digest a
    certificate-carrying workload commits as the block's
    ``state_digest``. ``None`` (no certificate) maps to the empty string,
    the value certificate-free blocks commit, so "this block claims no
    certificate" is itself header-signed: a relay can neither strip a
    certificate nor graft one on without breaking the digest
    cross-check."""
    if cert is None:
        return ""
    return hashlib.sha256(b"certificate:" + cert).hexdigest()


RewardEntries = Tuple[Tuple[int, float], ...]


def _apply_rewards(book: CreditBook, staged: CreditBook) -> RewardEntries:
    """Merge a staged book into ``book`` and return the applied entries."""
    entries = tuple(sorted(staged.balances.items()))
    for miner, amount in entries:
        book.credit(miner, amount)
    return entries


@runtime_checkable
class Workload(Protocol):
    """The block-payload contract every mining mode implements.

    Stateful workloads (whose ``verify`` advances local state) also expose
    ``snapshot()``/``restore(snap)`` so fork choice can roll them back.
    Stateless workloads may expose ``verify_batch(payloads) ->
    List[bool]``, which must accept/reject bit-identically to per-payload
    ``verify`` calls."""
    name: str

    def prepare(self, ctx: BlockContext) -> PreparedWork: ...

    def mine(self, work: PreparedWork) -> BlockPayload: ...

    def verify(self, payload: BlockPayload) -> bool: ...

    def reward(self, book: CreditBook, payload: BlockPayload
               ) -> RewardEntries: ...


def is_stateful(wl: object) -> bool:
    """True for workloads whose ``verify`` advances local state (they
    expose the ``snapshot``/``restore`` rollback pair)."""
    return hasattr(wl, "snapshot")


def verify_chain_batched(workloads: Dict[str, "Workload"],
                         payloads: Sequence[BlockPayload],
                         precleared: Optional[Sequence[bool]] = None
                         ) -> bool:
    """Re-verify a chain segment, batching stateless workloads.

    Accept/reject is identical to ``all(wl.verify(p) for p in
    payloads)``: stateless payloads are grouped per workload and handed to
    ``verify_batch``, then stateful payloads replay in chain order.
    ``precleared[i]`` marks payload ``i`` as already verified in this
    trust domain (a ``VerifyCache`` hit) — honored for stateless
    workloads only."""
    if precleared is not None and len(precleared) != len(payloads):
        raise ValueError("precleared must align with payloads")
    stateless: Dict[str, List[int]] = {}
    stateful_idx: List[int] = []
    for i, payload in enumerate(payloads):
        wl = workloads.get(payload.workload)
        if wl is None:
            return False
        if is_stateful(wl):
            stateful_idx.append(i)
        elif not (precleared is not None and precleared[i]):
            stateless.setdefault(payload.workload, []).append(i)
    for name, idxs in stateless.items():
        wl = workloads[name]
        group = [payloads[i] for i in idxs]
        if hasattr(wl, "verify_batch"):
            oks = wl.verify_batch(group)
        else:
            oks = [wl.verify(p) for p in group]
        if not all(oks):
            return False
    for i in stateful_idx:                  # chain order == replay order
        if not workloads[payloads[i].workload].verify(payloads[i]):
            return False
    return True


def _batched_stateless_verify(payloads: Sequence[BlockPayload],
                              classify, *, fraction: float,
                              device: torch.device) -> List[bool]:
    """The shared engine behind stateless ``verify_batch``: classify each
    payload, dedup byte-identical evidence, then batch the root
    recomputation (``recompute_roots_batched``) and the quorum
    re-execution (``quorum_verify_batched``).

    ``classify(payload)`` returns ``False``/``None`` (rejected), ``True``
    (accepted without batching) or ``(jash, dedup_key)`` (re-verify with
    ``jash``; ``dedup_key`` collapses byte-identical payloads, ``None``
    disables dedup)."""
    oks: List[Optional[bool]] = [None] * len(payloads)
    jashes: Dict[int, Jash] = {}
    rep_of: Dict[object, int] = {}     # dedup key -> first index
    dup_of: Dict[int, int] = {}        # duplicate index -> rep index
    live: List[int] = []
    for i, payload in enumerate(payloads):
        verdict = classify(payload)
        if verdict is None or isinstance(verdict, bool):
            oks[i] = bool(verdict)
            continue
        jash, key = verdict
        if key is not None:
            rep = rep_of.setdefault(key, i)
            if rep != i:
                dup_of[i] = rep
                continue
        jashes[i] = jash
        oks[i] = True
        live.append(i)
    roots = recompute_roots_batched([payloads[i].full for i in live],
                                    device=device)
    for i, root in zip(live, roots):
        if root != payloads[i].merkle_root:
            oks[i] = False
    live = [i for i in live if oks[i]]
    reports = quorum_verify_batched(
        [(jashes[i], payloads[i].full) for i in live], fraction=fraction,
        device=device)
    for i, report in zip(live, reports):
        if not report.ok:
            oks[i] = False
    for i, rep in dup_of.items():
        oks[i] = oks[rep]
    return oks


# ---------------------------------------------------------------------------
# full mode
# ---------------------------------------------------------------------------


def _sized(jash: Jash, work: Optional[int]) -> Jash:
    """Re-publish ``jash`` with the controller's args-per-block target
    (§3.1 granularity: ``max_arg`` trims below the power-of-two bound)."""
    if work is None or work >= jash.meta.n_args:
        return jash
    meta = dataclasses.replace(jash.meta, max_arg=max(int(work), 1))
    return Jash(jash.name, jash.fn, meta, example_args=jash.example_args)


class JashFullWorkload:
    """§3.3 full execution: every valid arg, Merkle-committed, reward
    split over first submissions with the §4 leading-zeros bonus."""

    name = "full"

    def __init__(self, *, verify_fraction: float = 0.25,
                 bonus_fraction: float = 0.1,
                 device: DeviceLike = None) -> None:
        self.verify_fraction = verify_fraction
        self.bonus_fraction = bonus_fraction
        self.device = resolve(device)

    def prepare(self, ctx: BlockContext) -> PreparedWork:
        """Resolve the published jash against the block's args-per-block
        target.  Raises ``ChainError`` without a publication — full mode
        never invents its own work."""
        if ctx.jash is None:
            raise ChainError("full workload needs a published jash")
        return PreparedWork(ctx, _sized(ctx.jash, ctx.work))

    def mine(self, work: PreparedWork) -> BlockPayload:
        """Evaluate every valid arg on the card and commit the Merkle root
        of the leaf digests (reduced on the card)."""
        ctx, jash = work.ctx, work.jash
        full = run_full(jash, lanes=ctx.lanes, device=ctx.device or self.device)
        return BlockPayload(
            workload=self.name, jash_id=jash.source_id(),
            merkle_root=full.commit_root(), n_results=len(full.args),
            origin=ctx.node_id, block_reward=ctx.block_reward,
            jash=jash, full=full)

    def verify(self, payload: BlockPayload) -> bool:
        """The §3 req. 2 determinism audit every peer runs on receive:
        (a) the committed ``jash_id`` must equal the evidence jash's
        ``source_id()``; (b) the committed root is recomputed
        *independently* with hashlib (not the device kernel that produced
        it) from the raw ``(arg, res)`` arrays; (c) a random
        ``verify_fraction`` of the arg space is re-executed bit-exactly."""
        full = payload.full
        if full is None or payload.jash is None:
            return False
        if payload.jash.source_id() != payload.jash_id:
            return False            # committed id must match the evidence
        if merkle_root(list(full.merkle_leaves),
                       backend="hashlib") != payload.merkle_root:
            return False
        return quorum_verify(payload.jash, full,
                             fraction=self.verify_fraction,
                             device=self.device).ok

    def verify_batch(self, payloads: Sequence[BlockPayload]) -> List[bool]:
        """``verify`` over a whole segment, bit-identical per payload;
        byte-identical payloads collapse to one representative."""

        def classify(p: BlockPayload):
            if (p.full is None or p.jash is None
                    or p.jash.source_id() != p.jash_id):
                return False
            # the fn object is part of the key: source_id() hashes only
            # name+meta, so a payload pairing honest evidence with a
            # different function must run its own quorum re-execution
            key = (p.jash.fn, p.jash_id, p.merkle_root,
                   hashlib.sha256(p.full.packed_words().tobytes())
                   .digest())
            return p.jash, key

        return _batched_stateless_verify(payloads, classify,
                                         fraction=self.verify_fraction,
                                         device=self.device)

    def reward(self, book: CreditBook, payload: BlockPayload
               ) -> RewardEntries:
        """Split the block reward evenly over first submissions plus the
        §4 leading-zeros bonus. Derived only from the payload, so every
        node's book stays bit-identical."""
        full = payload.full
        staged = CreditBook()
        submitters = [global_miner(payload.origin, m)
                      for m in full.miner_of]
        # §4: the miner whose submission hash has the most leading zeros
        # takes a bonus slice — lexicographic min over sha256(arg || res)
        bonus = None
        if self.bonus_fraction > 0.0 and len(full.hashes):
            idx = np.arange(len(full.hashes))
            for col in range(full.hashes.shape[1]):
                word = full.hashes[idx, col]
                idx = idx[word == word.min()]
                if len(idx) == 1:
                    break
            bonus = global_miner(payload.origin,
                                 int(full.miner_of[idx[0]]))
        reward_full(staged, submitters, payload.block_reward,
                    bonus_winner=bonus, bonus_fraction=self.bonus_fraction)
        return _apply_rewards(book, staged)


# ---------------------------------------------------------------------------
# optimal mode
# ---------------------------------------------------------------------------


def _optimal_leaf(opt) -> bytes:
    return (np.uint32(opt.best_arg).tobytes()
            + opt.best_res.astype("<u4").tobytes())


class JashOptimalWorkload:
    """§3.3 optimal execution: lowest res wins the whole block reward."""

    name = "optimal"

    # The replay is a pure function of (jash.fn, n_args), so a node
    # re-verifying many blocks over the same arg space may reuse its own
    # earlier replay (per instance: trust stays node-local).
    _REPLAY_MEMO_MAX = 8

    def __init__(self, *, device: DeviceLike = None) -> None:
        self.device = resolve(device)
        self._replay_memo: Dict[tuple, object] = {}

    def _replay(self, jash: Jash):
        key = (jash.fn, jash.meta.n_args)
        opt = self._replay_memo.get(key)
        if opt is None:
            opt = run_optimal(jash, device=self.device)
            if len(self._replay_memo) >= self._REPLAY_MEMO_MAX:
                self._replay_memo.pop(next(iter(self._replay_memo)))
            self._replay_memo[key] = opt
        return opt

    def prepare(self, ctx: BlockContext) -> PreparedWork:
        """Resolve the published jash against the args-per-block target;
        raises ``ChainError`` without a publication."""
        if ctx.jash is None:
            raise ChainError("optimal workload needs a published jash")
        return PreparedWork(ctx, _sized(ctx.jash, ctx.work))

    def mine(self, work: PreparedWork) -> BlockPayload:
        """Argmin over the arg space across ``ctx.lanes`` miner lanes; the
        winning lane's global miner id takes the block. Mining always
        executes for real (block times feed the difficulty controller)."""
        ctx, jash = work.ctx, work.jash
        opt = run_optimal(jash, lanes=ctx.lanes,
                          device=ctx.device or self.device)
        return BlockPayload(
            workload=self.name, jash_id=jash.source_id(),
            merkle_root=merkle_root([_optimal_leaf(opt)]),
            n_results=opt.n_evaluated,
            winner=global_miner(ctx.node_id, opt.winner),
            best_res=opt.best_res.tobytes().hex(),
            origin=ctx.node_id, block_reward=ctx.block_reward,
            jash=jash, best_arg=opt.best_arg)

    def verify(self, payload: BlockPayload) -> bool:
        """Deterministic argmin replay (§3 req. 2): the committed
        ``jash_id`` must match the evidence, the claimed winner's lane must
        belong to the claimed origin, and a single-lane re-execution must
        reproduce ``(best_arg, best_res)`` and the one-leaf Merkle root
        bit-exactly."""
        if payload.jash is None:
            return False
        if payload.jash.source_id() != payload.jash_id:
            return False            # committed id must match the evidence
        if (payload.winner is None
                or payload.winner // MINER_LANE != payload.origin):
            return False
        return self._replay_matches(payload, self._replay(payload.jash))

    @staticmethod
    def _replay_matches(payload: BlockPayload, opt) -> bool:
        return (opt.best_arg == payload.best_arg
                and opt.best_res.tobytes().hex() == payload.best_res
                and merkle_root([_optimal_leaf(opt)]) == payload.merkle_root)

    def verify_batch(self, payloads: Sequence[BlockPayload]) -> List[bool]:
        """``verify`` over a segment: each distinct arg space is replayed
        once and every payload compared against the shared replay."""
        oks = []
        for p in payloads:
            if (p.jash is None or p.jash.source_id() != p.jash_id
                    or p.winner is None
                    or p.winner // MINER_LANE != p.origin):
                oks.append(False)
                continue
            oks.append(self._replay_matches(p, self._replay(p.jash)))
        return oks

    def reward(self, book: CreditBook, payload: BlockPayload
               ) -> RewardEntries:
        """Winner takes the whole block reward."""
        staged = CreditBook()
        reward_optimal(staged, payload.winner, payload.block_reward)
        return _apply_rewards(book, staged)


# ---------------------------------------------------------------------------
# classic fallback (§3.4)
# ---------------------------------------------------------------------------


class ClassicSha256Workload(JashOptimalWorkload):
    """§3.4 back-compatibility: when the researcher queue is empty the
    chain mines plain double-SHA-256 blocks — an optimal-mode search over
    ``arg_bits`` nonces, lowest double-SHA-256 wins. ``Node.mine_block
    (None)`` selects it whenever the RA queue is empty. Verification and
    rewards are inherited from ``JashOptimalWorkload``."""

    name = "classic"

    def __init__(self, *, arg_bits: int = 10,
                 device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self.arg_bits = arg_bits
        self._base: Optional[Jash] = None

    def prepare(self, ctx: BlockContext) -> PreparedWork:
        """Publish the classic double-SHA-256 jash over this workload's
        nonce space."""
        if ctx.jash is not None:
            base = ctx.jash
        else:
            if self._base is None:
                self._base = classic_jash()
            base = self._base
        jash = Jash(base.name, base.fn,
                    JashMeta(arg_bits=self.arg_bits, res_bits=256,
                             description=base.meta.description),
                    example_args=base.example_args)
        return PreparedWork(ctx, _sized(jash, ctx.work))

    def journal_jash_fns(self) -> Dict[str, Callable]:
        """Journal-decode support (``Node.recover``): a jash function
        cannot be serialized, so decoding resolves it by name — the
        classic base jash is rebuilt locally and its (stable-identity)
        function registered under its wire name.  Workloads whose
        verification never executes ``payload.jash.fn`` (SAT, GAN
        inversion, docking, training) need no such hook."""
        if self._base is None:
            self._base = classic_jash()
        return {self._base.name: self._base.fn}


# ---------------------------------------------------------------------------
# training (PoUW) mode
# ---------------------------------------------------------------------------


class TrainingWorkload:
    """The §1 flagship payload: each block is one (or ``block_microsteps``)
    deterministic train step(s) of a ``core.pow_train.PoUWTrainer``; the
    post-step state digest is the chained commitment.

    Verification *is* re-execution: a peer receiving a training block
    advances its own (identically seeded) trainer one block and compares
    digests bit for bit (§3 req. 2), so the audit doubles as state sync
    and every node holds the model the chain says it should. A failed
    verify rolls the local trainer back, leaving state untouched.
    """

    name = "training"

    def __init__(self, trainer_factory: Callable[[], object]) -> None:
        self._factory = trainer_factory
        self._trainer = None
        self._self_check: Optional[BlockPayload] = None

    @property
    def trainer(self):
        if self._trainer is None:
            self._trainer = self._factory()
        return self._trainer

    def reset(self) -> None:
        """Back to genesis: the next access rebuilds the trainer from the
        factory (deterministic by seed). Fork choice calls this so an
        adopted chain is replayed from scratch and discarded local
        training blocks are truly unwound."""
        self._trainer = None
        self._self_check = None

    def is_pristine(self) -> bool:
        """True while the trainer has never been built: a snapshot of this
        state is just "reset me", so fork choice can checkpoint a node
        that has never mined or verified a training block without paying
        for a model build."""
        return self._trainer is None

    # -- the trainer replaces its state's tensors on every block, never
    #    changes them in place, so a snapshot holds references; the
    #    internal credit book is copied so a rolled-back verify mints
    #    nothing --------------------------------------------------------
    def snapshot(self):
        t = self.trainer
        return (t.state, t.key, list(t.ledger.blocks), list(t.history),
                dict(t.book.balances), t.book.total_issued)

    def restore(self, snap) -> None:
        t = self.trainer
        t.state, t.key = snap[0], snap[1]
        # copies, not the snapshot's own containers: ringed fork-choice
        # checkpoints outlive a restore, and the live trainer appends to
        # its ledger, history and book
        t.ledger.blocks = list(snap[2])
        t.history = list(snap[3])
        t.book.balances = dict(snap[4])
        t.book.total_issued = snap[5]

    def prepare(self, ctx: BlockContext) -> PreparedWork:
        """The published jash is the reviewed train step (the trainer
        re-derives the block's batch from (seed, height), so there is no
        per-block work sizing)."""
        return PreparedWork(ctx, self.trainer.step_jash)

    def mine(self, work: PreparedWork) -> BlockPayload:
        """Advance the local trainer one block and commit the post-step
        state digest. If this block later loses fork choice,
        ``consider_chain`` unwinds it via ``reset()`` and a replay of the
        adopted chain."""
        ctx = work.ctx
        t = self.trainer
        rec = t.run_block()
        blk = t.ledger.blocks[rec.height]
        self._self_check = payload = BlockPayload(
            workload=self.name, jash_id=blk.jash_id,
            merkle_root=blk.merkle_root, n_results=blk.n_results,
            winner=(None if blk.winner is None
                    else global_miner(ctx.node_id, blk.winner)),
            best_res=blk.best_res, state_digest=rec.state_digest,
            origin=ctx.node_id, block_reward=ctx.block_reward,
            loss=rec.loss, train_height=rec.height, n_miners=t.n_miners)
        return payload

    def verify(self, payload: BlockPayload) -> bool:
        """Stateful re-execution: a payload at the trainer's own height
        advances the local trainer one block and compares state digests
        and roots bit for bit; a mismatch restores the pre-verify snapshot
        (trainer state, history and credit book). Payloads below the local
        height check against history plus an incremental replay
        (``audit_block``), except the one-shot fast path for the payload
        this process just mined."""
        t = self.trainer
        h = payload.train_height
        if h is None or h > t.ledger.height:
            return False                      # out of order: can't replay
        if payload.jash_id != t.step_jash.source_id():
            return False                      # forged jash id
        if (payload.winner is not None
                and payload.winner // MINER_LANE != payload.origin):
            return False                      # ES winner outside its lane
        if h < t.ledger.height:
            # Already applied here. The node's immediate self-check of a
            # block it just mined is a one-shot fast path (the digest was
            # computed a moment ago; a replay adds no assurance and would
            # double the training). Every other call (audit, receive,
            # fork choice) checks history and re-executes on the cached
            # incremental replay trainer (§3 req. 2).
            fresh = payload is self._self_check
            self._self_check = None
            return (t.history[h].state_digest == payload.state_digest
                    and t.ledger.blocks[h].merkle_root
                    == payload.merkle_root
                    and (fresh or t.audit_block(h)))
        snap = self.snapshot()
        rec = t.run_block()                   # bit-exact re-execution
        ok = (rec.state_digest == payload.state_digest
              and t.ledger.blocks[h].merkle_root == payload.merkle_root)
        if not ok:
            self.restore(snap)
        return ok

    def reward(self, book: CreditBook, payload: BlockPayload
               ) -> RewardEntries:
        """Full-mode training splits the reward across the origin's
        ``n_miners`` lanes; ES (optimal) training pays the winning lane.
        Derived from the payload alone, so rebuilt books agree after a
        fork is adopted."""
        staged = CreditBook()
        if payload.winner is not None:        # optimal (ES) trainer mode
            reward_optimal(staged, payload.winner, payload.block_reward)
        else:                                 # full: split across miners
            submitters = [global_miner(payload.origin, m)
                          for m in range(payload.n_miners)]
            reward_full(staged, submitters, payload.block_reward)
        return _apply_rewards(book, staged)
