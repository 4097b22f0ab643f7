"""The ``Node``: one PNPCoin participant, the Fig. 1 loop behind a facade.

Composes the Runtime Authority (review + publication), the Ledger
(chained commitments), the CreditBook (rewards) and the
DifficultyController (§3.1/§5 args-per-block retargeting) behind four
calls::

    node = Node()
    node.submit(jash)          # researcher -> RA review
    receipt = node.mine_block()  # publish -> mine -> verify -> commit
    node.audit(height)         # re-verify any committed block
    node.state()               # typed snapshot of the whole node

Every committed block is self-verified *before* it is appended — a node
never extends its own chain with a payload a peer would reject.  The
``receive``/``consider_chain`` pair is the peer-side protocol
``chain/network.py`` drives: bit-exact re-verification on receive, and
longest-valid-chain fork choice when tips diverge.

The port of ``repro/chain/node.py``: the node mines and verifies on one
device (``device=None`` means the CUDA card). A ``Node(store=...)``
journals every commit to a ``ChainStore`` and ``Node.recover`` rebuilds
a node from one, written by either package. Signed origin binding
(``keyring``) is not ported yet.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.authority import ReviewReport, RuntimeAuthority
from repro_torch.core.difficulty import DifficultyController
from repro_torch.core.jash import Jash
from repro_torch.core.ledger import Block, Ledger
from repro_torch.core.rewards import CreditBook
from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels.native import KernelLaunchError
from repro_torch.chain.store import ChainStore, collect_jash_fns
from repro_torch.chain.workload import (
    BlockContext, BlockPayload, ChainError, ClassicSha256Workload,
    JashFullWorkload, JashOptimalWorkload, RewardEntries, Workload,
    is_stateful, verify_chain_batched,
)


# A fault of the card is not a block that fails re-verification: a replay
# that met one raises instead of truncating (and so rewriting) the journal.
_DEVICE_FAULTS = (torch.AcceleratorError, KernelLaunchError)


class VerifyCache:
    """Content-addressed record of payloads already verified in one
    *trust domain* (a pool of honest nodes sharing verification work —
    ``Network`` creates one and hands it to its nodes).

    An entry means "this exact payload object, committed under this
    ``block_hash``, passed workload verification on some node of the
    domain"; peers then skip re-running the §3 req. 2 re-execution and
    re-verify nothing but the cheap header/consensus checks.  Two
    guards keep cache hits consensus-identical to full verification:

    * hits require the **same payload object** (``is``), not just the
      same block hash — a Byzantine sender shipping tampered evidence
      under an honest header misses and gets fully verified;
    * only **stateless** workloads participate: training verification
      doubles as state sync and must replay on every node.

    The domain assumption is that member nodes run an identical
    verification policy (same workload parameters).  Nodes that do not
    — or adversarial-scenario nodes that must re-verify everything
    themselves — opt out with ``Node(use_verify_cache=False)``.

    ``maxsize`` bounds the cache (entries pin whole payloads — full
    evidence arrays included — and a long-running domain would
    otherwise retain every orphaned and reorged-away block forever).
    Eviction is **finality-aware**: once a member node reports a
    finalized height (``note_finalized``), entries at or below it are
    evicted first — a finalized block is never re-verified again (every
    member already holds it, and fork choice substitutes local evidence
    below the fork point), so they are pure dead weight.  With no
    finality information the policy degrades to plain FIFO.  An evicted
    block simply costs its next receiver one ordinary re-verification.
    ``hits``/``misses``/``evictions`` count the domain's traffic.
    """

    def __init__(self, maxsize: int = 4096) -> None:
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self._verified: Dict[str, BlockPayload] = {}
        self._heights: Dict[str, int] = {}
        self._finalized = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._verified)

    def check(self, block_hash: str, payload: BlockPayload) -> bool:
        """True iff this exact payload was already verified under this
        block hash somewhere in the trust domain."""
        if self._verified.get(block_hash) is payload:
            self.hits += 1
            return True
        self.misses += 1
        return False

    def note_finalized(self, height: int) -> None:
        """A member node finalized up to ``height`` — entries at or
        below it become preferred eviction victims."""
        if height > self._finalized:
            self._finalized = height

    def add(self, block_hash: str, payload: BlockPayload,
            height: Optional[int] = None) -> None:
        """Record a payload that just passed workload verification
        (``height`` is the block's chain height, fed to the
        finality-aware eviction policy when known)."""
        if block_hash not in self._verified:
            while len(self._verified) >= self.maxsize:
                self._evict_one()
            self._verified[block_hash] = payload
            if height is not None:
                self._heights[block_hash] = height

    def _evict_one(self) -> None:
        victim = None
        if self._finalized:
            for key, h in self._heights.items():
                if h <= self._finalized:           # finalized-behind first
                    victim = key
                    break
        if victim is None:
            victim = next(iter(self._verified))    # then plain FIFO
        self._verified.pop(victim)
        self._heights.pop(victim, None)
        self.evictions += 1


@dataclasses.dataclass(frozen=True)
class _ChainSnapshot:
    """Periodic per-node checkpoint fork choice restarts from: the
    credit book and stateful-workload state as of ``height`` committed
    blocks.  Ledger blocks and payloads are not stored — the common
    prefix up to the fork point is shared with the live chain."""
    height: int
    balances: Dict[int, float]
    total_issued: float
    wl_snaps: Tuple[Tuple[str, object], ...]   # stateful name -> snap


def _stateful_snapshot(wl) -> object:
    """Snapshot a stateful workload without forcing lazy state into
    existence: ``None`` stands for "pristine, restore == reset"."""
    if getattr(wl, "is_pristine", lambda: False)():
        return None
    return wl.snapshot()


def _stateful_restore(wl, snap) -> None:
    if snap is None:
        wl.reset()
    else:
        wl.restore(snap)


@dataclasses.dataclass(frozen=True)
class BlockRecord:
    """Typed view of one committed block (replaces the positional
    ``ledger.append(...)`` kwargs soup at the API boundary)."""
    height: int
    prev_hash: str
    block_hash: str
    workload: str
    jash_id: str
    merkle_root: str
    winner: Optional[int]
    best_res: Optional[str]
    n_results: int
    state_digest: str

    @classmethod
    def from_block(cls, blk: Block) -> "BlockRecord":
        return cls(height=blk.height, prev_hash=blk.prev_hash,
                   block_hash=blk.block_hash, workload=blk.mode,
                   jash_id=blk.jash_id, merkle_root=blk.merkle_root,
                   winner=blk.winner, best_res=blk.best_res,
                   n_results=blk.n_results, state_digest=blk.state_digest)

    def to_block(self) -> Block:
        """The ledger ``Block`` this record describes (what goes on the
        wire; the content hash is timestamp-free so it round-trips)."""
        return Block(height=self.height, prev_hash=self.prev_hash,
                     jash_id=self.jash_id, mode=self.workload,
                     merkle_root=self.merkle_root, winner=self.winner,
                     best_res=self.best_res, n_results=self.n_results,
                     state_digest=self.state_digest)


@dataclasses.dataclass(frozen=True)
class BlockReceipt:
    """What ``mine_block`` hands back: the committed record, the payload
    evidence (what peers re-verify), and the credits it minted.  A
    receipt only exists for a block that passed self-verification —
    ``mine_block`` raises ``ChainError`` otherwise."""
    record: BlockRecord
    payload: BlockPayload
    rewards: RewardEntries
    block_time_s: float


@dataclasses.dataclass(frozen=True)
class RecoveryReport:
    """What ``Node.recover`` did: how many journal blocks it replayed,
    the height it adopted after truncating damage (``truncated_records``
    counts journal records discarded — torn/corrupted tail plus blocks
    that failed re-verification), and the height after resyncing the
    lost tail from peers."""
    replayed: int
    adopted_height: int
    truncated_records: int
    resynced_height: int


@dataclasses.dataclass(frozen=True)
class NodeState:
    node_id: int
    height: int
    tip_hash: str
    queue_depth: int
    work: Optional[int]
    total_issued: float
    balances: Dict[int, float]
    chain_valid: bool


class Node:
    """One PNPCoin node: RA + ledger + credits + difficulty + workloads."""

    def __init__(self, *, node_id: int = 0,
                 workloads: Optional[Dict[str, Workload]] = None,
                 block_reward: float = 50.0,
                 classic_arg_bits: int = 10,
                 target_block_s: Optional[float] = None,
                 work: Optional[int] = None,
                 n_lanes: int = 1,
                 snapshot_interval: int = 8,
                 snapshot_ring: int = 4,
                 use_verify_cache: bool = True,
                 confirmation_depth: Optional[int] = None,
                 store: Optional[ChainStore] = None,
                 ra: Optional[RuntimeAuthority] = None,
                 device: DeviceLike = None) -> None:
        """``device`` is where the node mines and verifies (``None``: the
        CUDA card, and an error without one).

        ``n_lanes`` is multi-lane mining: partition full/optimal
        execution over ``n_lanes`` miner lanes on the card (lane ``l``
        earns as global miner ``node_id * MINER_LANE + l``).  Lane
        partitioning never changes the mined bits, so peers need no
        knowledge of a miner's lane count to verify its blocks.

        Every ``snapshot_interval`` committed blocks the node rings a
        fork-choice checkpoint (keeping the last ``snapshot_ring``), so
        ``consider_chain`` rebuilds from the newest checkpoint at or
        below the fork point instead of replaying from genesis.
        ``snapshot_interval=0`` (or a zero ring) disables checkpoints —
        fork choice then always replays from genesis, which is the
        reference behavior the incremental path must match bit-exactly.

        ``use_verify_cache=False`` keeps this node out of any shared
        ``VerifyCache`` a ``Network`` would attach — it then re-verifies
        every payload itself.

        ``confirmation_depth=k`` turns on **finality**: a block with
        ``k`` committed successors is checkpointed — ``consider_chain``
        rejects any reorg whose fork point crosses it, and finalization
        prunes old checkpoint-ring entries and retained payload
        evidence so long-running memory stays bounded (block *headers*
        are kept forever; they are what hash-links the chain).  With
        checkpoints enabled the ring must cover the non-final tail
        (``confirmation_depth <= (snapshot_ring - 1) *
        snapshot_interval``) — validated here, at construction.  ``None``
        (the default) keeps the pure longest-valid-chain behavior.

        ``store`` attaches a durable ``ChainStore`` journal: every
        commit and fork-choice rebuild is appended to it, and after a
        crash ``Node.recover(store, ...)`` rebuilds an equivalent node
        from the journal.  The store must be empty — recovery, not
        construction, is how a journal with history is adopted."""
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        if snapshot_interval < 0:
            raise ValueError(
                f"snapshot_interval must be >= 0, got {snapshot_interval}")
        if snapshot_ring < 0:
            raise ValueError(
                f"snapshot_ring must be >= 0, got {snapshot_ring}")
        if confirmation_depth is not None:
            if confirmation_depth < 1:
                raise ValueError(f"confirmation_depth must be >= 1, "
                                 f"got {confirmation_depth}")
            ring_span = (snapshot_ring - 1) * snapshot_interval
            if snapshot_interval > 0 and snapshot_ring > 0 \
                    and confirmation_depth > ring_span:
                raise ValueError(
                    f"confirmation_depth={confirmation_depth} exceeds the "
                    f"checkpoint ring's span of {ring_span} blocks "
                    f"((snapshot_ring - 1) * snapshot_interval = "
                    f"({snapshot_ring} - 1) * {snapshot_interval}) — an "
                    "allowed reorg inside the non-final tail could then "
                    "find no checkpoint at or below its fork point after "
                    "finality pruning; deepen the ring or lower the depth")
        self.device = resolve(device)
        self.node_id = node_id
        self.block_reward = block_reward
        self.n_lanes = n_lanes
        self.ra = ra if ra is not None else RuntimeAuthority(
            device=self.device)
        self.ledger = Ledger()
        self.book = CreditBook()
        self.workloads: Dict[str, Workload] = {
            "full": JashFullWorkload(device=self.device),
            "optimal": JashOptimalWorkload(device=self.device),
            "classic": ClassicSha256Workload(arg_bits=classic_arg_bits,
                                             device=self.device),
        }
        if workloads:
            for name, wl in workloads.items():
                self._check_registration(name, wl)
                self.workloads[name] = wl
        if target_block_s is not None and work is None:
            raise ValueError(
                "target_block_s without an initial work target is a no-op "
                "retargeter — pass work= (e.g. from "
                "repro_torch.core.difficulty.work_for_runtime) as well")
        self.work = work
        self.difficulty = (DifficultyController(target_block_s=target_block_s)
                           if target_block_s is not None else None)
        self._payloads: Dict[int, BlockPayload] = {}
        self.snapshot_interval = snapshot_interval
        self._snapshots: collections.deque = collections.deque(
            maxlen=snapshot_ring)
        self.use_verify_cache = use_verify_cache
        self.verify_cache: Optional[VerifyCache] = None
        self._hash_index: set = set()      # block hashes of self.ledger
        self._in_rebuild = False           # fork-choice commit loop
        self.confirmation_depth = confirmation_depth
        self._finalized = 0                # monotone finalized height
        self._evidence_floor = 0           # heights below: payload pruned
        self.finality_rejects = 0          # reorgs rejected at the fence
        if store is not None and not store.is_empty():
            raise ValueError(
                "store already holds journal records — a fresh node may "
                "not silently shadow an existing chain; use "
                "Node.recover(store, ...) to adopt it")
        self.store = store
        self._journal_mute = False         # recovery replay: don't re-log
        self.last_recovery: Optional[RecoveryReport] = None

    # -- workload registry --------------------------------------------
    @staticmethod
    def _check_registration(name: str, wl: Workload) -> None:
        """A registered workload's dict key must equal its ``name``
        attribute — payloads circulate under ``wl.name``, so a mismatch
        would make every block this node mines under the key
        unreceivable (``workloads[payload.workload]`` missing on every
        peer, including this node's own self-verify)."""
        wl_name = getattr(wl, "name", None)
        if wl_name != name:
            raise ValueError(
                f"workload registered under key {name!r} reports "
                f"name={wl_name!r} — payloads circulate under the "
                "workload's own .name, so the registry key must match")

    def register_workload(self, wl: Workload) -> None:
        """Register an additional workload family after construction
        under its own ``name``.
        Overwriting an existing family is refused — peers re-verify
        committed payloads against the registry, so silently swapping a
        family's semantics mid-chain would strand every block it
        already mined.  Registering a *stateful* family on a node with
        committed blocks is fine: ringed fork-choice checkpoints taken
        before registration simply restore it to pristine, which is
        exactly its state at those heights."""
        name = getattr(wl, "name", None)
        if not isinstance(name, str) or not name:
            raise ValueError(
                "workload has no usable .name attribute — the Workload "
                "protocol requires one (it is the wire name payloads "
                "circulate under)")
        if name in self.workloads:
            raise ValueError(
                f"workload {wl.name!r} already registered — build the "
                "node with workloads={...} to replace a default family")
        self.workloads[wl.name] = wl

    # -- researcher side ----------------------------------------------
    def submit(self, jash: Jash, veto: bool = False) -> ReviewReport:
        """Researcher submission -> the RA's §3.3 review pipeline."""
        return self.ra.submit(jash, veto=veto)

    # -- mining side --------------------------------------------------
    def mine_block(self, workload: Optional[str] = None) -> BlockReceipt:
        """Publish -> mine -> self-verify -> commit -> reward, one block.

        ``workload=None`` follows the paper's default policy: pop the
        RA queue and run **full** mode, falling back to **classic**
        SHA-256 when the queue is empty (§3.4).  Pass "optimal",
        "training" or "classic" to select the payload explicitly.
        """
        t0 = time.perf_counter()
        if workload in (None, "full", "optimal"):
            jash, source = self.ra.publish_next()
            if source == "queued":
                name = workload or "full"
            elif workload is None:
                name = "classic"            # §3.4 fallback, default policy
            else:
                raise ChainError(
                    f"workload {workload!r} requested explicitly but the "
                    "RA queue is empty — submit a jash first or mine with "
                    "the default policy (workload=None) for the classic "
                    "fallback")
        else:
            if workload not in self.workloads:
                raise ChainError(f"unknown workload {workload!r} "
                                 f"(have {sorted(self.workloads)})")
            jash, source, name = None, workload, workload

        wl = self.workloads[name]
        ctx = BlockContext(height=self.ledger.height,
                           prev_hash=self.ledger.tip_hash,
                           node_id=self.node_id, jash=jash, source=source,
                           work=self.work, block_reward=self.block_reward,
                           lanes=self.n_lanes, device=self.device)
        try:
            payload = wl.mine(wl.prepare(ctx))
            ok = wl.verify(payload)
        except Exception:
            if source == "queued":
                self.ra.requeue(jash)       # don't lose the submission
            raise
        if not ok:
            if source == "queued":
                self.ra.requeue(jash)
            raise ChainError(
                f"self-mined {name} block at height {ctx.height} failed "
                "verification — refusing to commit")
        record, rewards = self._commit(payload)
        if self.verify_cache is not None and not is_stateful(wl):
            # the self-verification above counts for the trust domain
            self.verify_cache.add(record.block_hash, payload,
                                  height=record.height)

        dt = time.perf_counter() - t0
        if self.difficulty is not None:
            self.difficulty.observe(dt)
            if self.work is not None:
                self.work = self.difficulty.propose_work(self.work)
        return BlockReceipt(record=record, payload=payload, rewards=rewards,
                            block_time_s=dt)

    def _commit(self, payload: BlockPayload
                ) -> Tuple[BlockRecord, RewardEntries]:
        blk = self.ledger.append(
            jash_id=payload.jash_id, mode=payload.workload,
            merkle=payload.merkle_root, winner=payload.winner,
            best_res=payload.best_res, n_results=payload.n_results,
            state_digest=payload.state_digest)
        self._hash_index.add(blk.block_hash)
        self._payloads[blk.height] = payload
        if self.store is not None and not self._journal_mute:
            self.store.append_commit(blk, payload)
        rewards = self.workloads[payload.workload].reward(self.book, payload)
        # during a fork-choice rebuild the stateful workloads already
        # sit at the *tail end* state (batched verification replayed
        # them before the commit loop), so a mid-loop checkpoint would
        # pair an intermediate height with end-of-chain trainer state —
        # consider_chain suppresses the ring and pushes one consistent
        # checkpoint at the adopted tip instead
        if (self.snapshot_interval > 0 and not self._in_rebuild
                and self.ledger.height % self.snapshot_interval == 0):
            self._push_snapshot()
        self._advance_finality()
        return BlockRecord.from_block(blk), rewards

    # -- finality ------------------------------------------------------
    @property
    def finalized_height(self) -> int:
        """Heights below this are final: ``consider_chain`` refuses any
        reorg whose fork point crosses it (always 0 with
        ``confirmation_depth=None``)."""
        return self._finalized

    def _advance_finality(self) -> None:
        if self.confirmation_depth is None:
            return
        new_final = self.ledger.height - self.confirmation_depth
        if new_final > self._finalized:
            self._finalized = new_final
            if self.verify_cache is not None:
                self.verify_cache.note_finalized(self._finalized)
            self._prune_finalized()

    def _prune_finalized(self) -> None:
        """Finalization drives pruning: drop checkpoint-ring entries and
        payload evidence below the newest checkpoint at or below the
        finalized height (the *anchor* — the deepest rebuild base any
        still-allowed reorg can need).  Headers stay forever; a chain
        of pruned heights remains hash-verifiable, its evidence is just
        no longer servable to joiners (weak subjectivity — see DESIGN.md
        §12)."""
        anchor = 0
        for snap in self._snapshots:
            if anchor < snap.height <= self._finalized:
                anchor = snap.height
        if anchor == 0:
            return
        if any(s.height < anchor for s in self._snapshots):
            keep = [s for s in self._snapshots if s.height >= anchor]
            self._snapshots = collections.deque(
                keep, maxlen=self._snapshots.maxlen)
        while self._evidence_floor < anchor:
            self._payloads.pop(self._evidence_floor, None)
            self._evidence_floor += 1

    # -- fork-choice checkpoints --------------------------------------
    def _push_snapshot(self) -> None:
        wl_snaps = tuple(
            (name, _stateful_snapshot(wl))
            for name, wl in self.workloads.items() if is_stateful(wl))
        self._snapshots.append(_ChainSnapshot(
            height=self.ledger.height,
            balances=dict(self.book.balances),
            total_issued=self.book.total_issued,
            wl_snaps=wl_snaps))

    def _snapshot_at(self, height: int) -> Optional[_ChainSnapshot]:
        """Newest ringed checkpoint at or below ``height`` (None means
        restart from genesis)."""
        best = None
        for snap in self._snapshots:
            if snap.height <= height and (best is None
                                          or snap.height > best.height):
                best = snap
        return best

    # -- verifier side ------------------------------------------------
    def audit(self, height: int) -> bool:
        """Re-verify a committed block: header fields must match the
        payload and the payload must re-verify bit-exactly (§3 req. 2)."""
        if not 0 <= height < self.ledger.height:
            raise ChainError(f"no block at height {height}")
        blk = self.ledger.blocks[height]
        payload = self._payloads.get(height)
        if payload is None:
            return False
        return (self._payload_matches(blk, payload)
                and self.workloads[payload.workload].verify(payload))

    def audit_chain(self, heights: Optional[Sequence[int]] = None) -> bool:
        """Batched ``audit``: re-verify many committed blocks (default:
        the whole chain) with the stateless workloads grouped into
        single dispatches.  Accept/reject equals ``all(self.audit(h)
        for h in heights)``; like ``audit``, this never consults the
        shared ``VerifyCache`` — an audit is this node proving the
        chain to itself.  The default range starts at the evidence
        floor: payloads below it were pruned at finalization, and a
        finalized block's evidence is by definition no longer held."""
        hs = list(range(self._evidence_floor, self.ledger.height)) \
            if heights is None else list(heights)
        payloads = []
        for h in hs:
            if not 0 <= h < self.ledger.height:
                raise ChainError(f"no block at height {h}")
            payload = self._payloads.get(h)
            if payload is None or not self._payload_matches(
                    self.ledger.blocks[h], payload):
                return False
            payloads.append(payload)
        return verify_chain_batched(self.workloads, payloads)

    def _payload_matches(self, blk: Block, payload: BlockPayload) -> bool:
        return (blk.jash_id == payload.jash_id
                and blk.mode == payload.workload
                and blk.merkle_root == payload.merkle_root
                and blk.winner == payload.winner
                and blk.best_res == payload.best_res
                and blk.n_results == payload.n_results
                and blk.state_digest == payload.state_digest
                and payload.workload in self.workloads)

    # -- peer protocol (driven by chain/network.py) -------------------
    def has_block(self, block_hash: str) -> bool:
        """True iff a block with this content hash is already committed
        — the duplicate check gossip layers run before treating a failed
        ``receive`` as a fork signal (at-least-once delivery must be an
        idempotent no-op, never a chain pull).  O(1) via a hash index
        maintained by commit/fork-choice (gossip runs this once per
        delivery, so a chain-length scan would be quadratic over a
        sim's lifetime)."""
        return block_hash in self._hash_index

    def receive(self, block: Block, payload: BlockPayload,
                origin: Optional[int] = None) -> bool:
        """Accept a broadcast block iff it extends our tip and the payload
        re-verifies bit-exactly.  Returns False on any mismatch (the
        network layer then falls back to ``consider_chain``).

        Reward-determining payload fields are enforced here, not in the
        workload: ``block_reward`` must equal this node's configured
        reward (a consensus parameter — a payload claiming more mints
        nothing), and ``origin`` (the transport-level sender the
        in-process network passes) must equal the payload's claimed
        origin."""
        if (block.height != self.ledger.height
                or block.prev_hash != self.ledger.tip_hash):
            return False
        if payload.block_reward != self.block_reward:
            return False
        if origin is not None and payload.origin != origin:
            return False
        if not self._payload_matches(block, payload):
            return False
        wl = self.workloads.get(payload.workload)
        if wl is None:
            return False
        shareable = not is_stateful(wl) and self.verify_cache is not None
        if not (shareable
                and self.verify_cache.check(block.block_hash, payload)):
            if not wl.verify(payload):
                return False
            if shareable:
                self.verify_cache.add(block.block_hash, payload,
                                      height=block.height)
        self._commit(payload)
        return True

    def consider_chain(self, blocks: Sequence[Block],
                       payloads: Sequence[BlockPayload]) -> bool:
        """Longest-valid-chain fork choice: adopt a competing chain iff it
        is strictly longer, links from genesis, and every payload
        re-verifies.  The ledger and credit book are rebuilt from the
        adopted payloads (credits follow the chain, not the node).

        The rebuild is **fork-point incremental**: hash links are still
        checked from genesis (cheap host work), but payload
        re-verification and ledger/book/trainer reconstruction restart
        from the newest ringed checkpoint at or below the fork point —
        everything before it is common prefix this node already
        verified when it committed it.  Stateless payloads of the
        candidate tail verify in one batched dispatch (minus shared
        ``VerifyCache`` hits); stateful ones replay in chain order from
        the checkpoint.  Accept/reject, adopted tips, and rebuilt books
        are bit-identical to a genesis replay (``snapshot_interval=0``
        forces that reference behavior).

        Malformed *calls* — an empty candidate or mismatched
        blocks/payloads lengths — raise ``ChainError`` (they are caller
        bugs, not losing forks); an invalid candidate *chain* returns
        False.  With finality on (``confirmation_depth``), a candidate
        whose fork point lies below our finalized height is refused
        however long it is (counted in ``finality_rejects`` — the fence
        that defeats long-range rewrites).  Below the fork point the
        sender's evidence is ignored in favor of our own retained
        payloads (bit-identical blocks ⇒ the evidence we committed), so
        a peer that pruned finalized evidence may serve ``None`` there;
        at or beyond the fork point every payload must be present and
        cross-check its header."""
        if len(blocks) == 0 or len(blocks) != len(payloads):
            raise ChainError(
                f"consider_chain needs aligned non-empty sequences — got "
                f"{len(blocks)} blocks and {len(payloads)} payloads")
        if len(blocks) <= self.ledger.height:
            return False
        prev = Ledger.GENESIS_HASH
        for i, blk in enumerate(blocks):
            if blk.height != i or blk.prev_hash != prev:
                return False
            prev = blk.block_hash
        # fork point: longest common block-hash prefix with our chain
        common = 0
        for ours, theirs in zip(self.ledger.blocks, blocks):
            if ours.block_hash != theirs.block_hash:
                break
            common += 1
        if self.confirmation_depth is not None and common < self._finalized:
            self.finality_rejects += 1
            return False
        use = list(payloads)
        for i in range(common):
            use[i] = self._payloads.get(i, use[i])
        # the block reward is a consensus parameter; origin attribution
        # inside a relayed chain is a signature problem (out of scope for
        # the in-process network) and is NOT re-checked here
        for i in range(common, len(blocks)):
            p = use[i]
            if (p is None or p.block_reward != self.block_reward
                    or not self._payload_matches(blocks[i], p)):
                return False
        snap = self._snapshot_at(common)
        start = snap.height if snap is not None else 0
        ring_snaps = dict(snap.wl_snaps) if snap is not None else {}
        # Stateful workloads (training) advance while verifying.  Roll
        # them back to the checkpoint so the candidate tail is replayed
        # on exactly the state the common prefix produced (a fork that
        # discards a local training block must rewind the trainer too,
        # or the node's future blocks are unverifiable by peers).  The
        # pre-fork state rolls everything back if the candidate fails.
        stateful = [(name, wl) for name, wl in self.workloads.items()
                    if is_stateful(wl)]
        rollback = [(wl, _stateful_snapshot(wl)) for _, wl in stateful]
        for name, wl in stateful:
            _stateful_restore(wl, ring_snaps.get(name))
        precleared = [False] * (len(use) - start)
        if self.verify_cache is not None:
            for i in range(start, len(use)):
                wl = self.workloads.get(use[i].workload)
                if (wl is not None and not is_stateful(wl)
                        and self.verify_cache.check(blocks[i].block_hash,
                                                    use[i])):
                    precleared[i - start] = True
        if not verify_chain_batched(self.workloads, use[start:],
                                    precleared=precleared):
            for wl, pre_fork in rollback:
                _stateful_restore(wl, pre_fork)
            return False
        # adopt: truncate to the checkpoint and rebuild from there (the
        # kept prefix is bit-identical between the two chains).  The
        # journal stays append-only across reorgs: one TRUNCATE record,
        # then the adopted tail as ordinary commits.
        if self.store is not None and start < self.ledger.height:
            self.store.append_truncate(start)
        del self.ledger.blocks[start:]
        self.book.balances = dict(snap.balances) if snap else {}
        self.book.total_issued = snap.total_issued if snap else 0.0
        self._payloads = {h: self._payloads[h]
                          for h in range(self._evidence_floor, start)}
        self._hash_index = {b.block_hash for b in self.ledger.blocks}
        # checkpoints past the fork point describe the abandoned branch
        keep = [s for s in self._snapshots if s.height <= common]
        self._snapshots = collections.deque(keep,
                                            maxlen=self._snapshots.maxlen)
        self._in_rebuild = True
        try:
            for blk, payload in zip(blocks[start:], use[start:]):
                self._commit(payload)
                if self.verify_cache is not None and not is_stateful(
                        self.workloads[payload.workload]):
                    self.verify_cache.add(blk.block_hash, payload,
                                          height=blk.height)
        finally:
            self._in_rebuild = False
        # one checkpoint at the adopted tip, where ledger, book, and
        # stateful workloads are all consistent again
        if self.snapshot_interval > 0 and self._snapshots.maxlen:
            self._push_snapshot()
        return True

    # -- introspection ------------------------------------------------
    def state(self) -> NodeState:
        """Typed snapshot of the whole node.  ``chain_valid`` re-walks
        the hash links from genesis (cheap header check only — use
        ``audit`` for payload re-verification); ``balances`` is a copy,
        so a held snapshot is immune to later fork-choice rebuilds."""
        return NodeState(node_id=self.node_id, height=self.ledger.height,
                         tip_hash=self.ledger.tip_hash,
                         queue_depth=self.ra.queue_depth, work=self.work,
                         total_issued=self.book.total_issued,
                         balances=dict(self.book.balances),
                         chain_valid=self.ledger.verify_chain())

    @property
    def records(self) -> List[BlockRecord]:
        """Typed view of the committed chain, genesis -> tip.  Reflects
        the *current* fork choice — a reorg replaces earlier entries."""
        return [BlockRecord.from_block(b) for b in self.ledger.blocks]

    def chain_payloads(self) -> List[Optional[BlockPayload]]:
        """Payload evidence for every committed block, chain order (what
        a peer pulls to run fork choice).  Heights whose evidence was
        pruned at finalization yield ``None`` — a puller substitutes its
        own retained evidence below the fork point (``consider_chain``),
        and a fresh joiner must bootstrap from a peer that still holds
        the full evidence (weak subjectivity; DESIGN.md §12)."""
        return [self._payloads.get(h) for h in range(self.ledger.height)]

    # -- crash recovery (the ChainStore journal) ----------------------
    @classmethod
    def recover(cls, store: ChainStore, *,
                peers: Sequence["Node"] = (),
                jash_fns: Optional[Dict[str, object]] = None,
                node: Optional["Node"] = None,
                **node_kwargs) -> "Node":
        """Rebuild a node from its durable journal after a crash.

        Reads the journal (damaged tails already truncated by
        ``ChainStore.read_chain``), replays the surviving chain through
        the **ordinary verify path** — a block that fails re-verification
        truncates the replay there instead of crashing — commits the
        adopted prefix, compacts the journal to it, and finally pulls
        each node in ``peers`` through ``consider_chain`` to resync the
        lost tail.  What happened is recorded in ``last_recovery``.

        The recovered node is built from ``node_kwargs`` (same
        constructor arguments as the crashed node, ``device`` among them
        — workload parameters are consensus policy, they are not
        journaled), or pass a pre-built fresh ``node=`` shell.
        ``jash_fns`` maps jash names to their functions for payload
        families whose evidence must be re-*executed* (full/optimal
        researcher jashes); the classic fallback and the application
        workloads resolve themselves."""
        if node is None:
            node = cls(**node_kwargs)
        if node.ledger.height != 0 or node.store is not None:
            raise ChainError(
                "Node.recover needs a fresh node shell (no committed "
                "blocks, no attached store)")
        fns = collect_jash_fns(node.workloads, jash_fns)
        read = store.read_chain(jash_fns=fns)
        adopted = node._replay_journal(read.blocks, read.payloads)
        truncated = read.truncated_records + (len(read.blocks) - adopted)
        if not read.clean or adopted < len(read.blocks):
            store.rewrite(read.blocks[:adopted], read.payloads[:adopted])
        node.store = store
        for peer in peers:
            if peer.ledger.height > node.ledger.height:
                node.consider_chain(list(peer.ledger.blocks),
                                    peer.chain_payloads())
        node.last_recovery = RecoveryReport(
            replayed=len(read.blocks), adopted_height=adopted,
            truncated_records=truncated,
            resynced_height=node.ledger.height)
        return node

    def _replay_journal(self, blocks: Sequence[Block],
                        payloads: Sequence[Optional[BlockPayload]]) -> int:
        """Commit the longest valid prefix of a journal chain; returns
        how many blocks were adopted.  Validity is exactly what
        ``consider_chain`` demands: genesis-rooted hash links,
        header/payload cross-checks, consensus reward, and bit-exact
        workload re-verification (on this node's device: a decoded
        ``FullResult`` names none).  A block whose verification raises is
        not adopted, except that a fault of the card is raised."""
        n = 0
        prev = Ledger.GENESIS_HASH
        for blk, payload in zip(blocks, payloads):
            if (blk.height != n or blk.prev_hash != prev
                    or payload is None
                    or payload.block_reward != self.block_reward
                    or not self._payload_matches(blk, payload)):
                break
            prev = blk.block_hash
            n += 1
        ok = 0
        try:
            if n and verify_chain_batched(self.workloads, payloads[:n]):
                ok = n
        except _DEVICE_FAULTS:
            raise
        except Exception:
            ok = 0
        if ok == 0 and n:
            # the batched pass failed somewhere — scan block by block
            # for the longest verifying prefix (stateful workloads
            # advance exactly as far as verification succeeds, which is
            # the adopted tail state); reset them first, the failed
            # batch may have advanced them partway
            for wl in self.workloads.values():
                if is_stateful(wl):
                    wl.reset()
            for i in range(n):
                try:
                    if not verify_chain_batched(self.workloads,
                                                payloads[i:i + 1]):
                        break
                except _DEVICE_FAULTS:
                    raise
                except Exception:
                    break
                ok = i + 1
        self._in_rebuild = True
        self._journal_mute = True      # replay must not re-journal
        try:
            for payload in payloads[:ok]:
                self._commit(payload)
        finally:
            self._in_rebuild = False
            self._journal_mute = False
        if ok and self.snapshot_interval > 0 and self._snapshots.maxlen:
            self._push_snapshot()
        return ok
