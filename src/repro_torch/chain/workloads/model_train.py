"""``ModelTrainingWorkload``: real-model proof-of-useful-work. The chain
trains a ``repro_torch.models`` transformer; the port of
``repro/chain/workloads/model_train.py``.

Each block runs ``block_microsteps`` microbatches of the
``train/steps.py`` training step on the workload's device and commits:

* ``state_digest``: sha256 of the canonical post-block params bytes
  (``train.steps.params_digest``: gathered to the host, little-endian,
  dtype and shape framed);
* ``merkle_root``: over per-microstep leaves ``height | micro |
  batch_digest | metrics_digest``, with the raw digest pairs shipped as
  ``BlockPayload.micro_proof`` evidence;
* ``train_height``: the stateful sequence index.

The data stream is keyed by ``(chain_seed, height, micro)``
(``SyntheticTokenPipeline.microbatch``), so a verifier re-derives the
miner's batches from the meta alone. Verification replays the block on
the verifier's own state and compares root, proof rows, loss and the
post-block params digest bit for bit; before replaying, it re-derives one
seeded-randomly-sampled microbatch from a fresh pipeline and checks it
against the stream. Success advances local state; any mismatch leaves it
untouched. ``snapshot``/``restore``/``reset`` give fork choice its
rollback, and the journal (``chain/store.py``) round-trips the payload,
so ``Node.recover`` replays model-train blocks like any other family.

The token batches, their digests, the proof framing, the root and the
jash id are the reference's bits. The float training is not: XLA and
torch round the same step differently in its last bits, so a block mined
by one package fails the other's re-execution (``verify`` returns False).
On one card two runs of the step give the same bits: the flash backward
sums in fixed orders with no atomics, the loss picks its gold logit by a
one-hot product (no scatter in its backward), and TF32 stays off.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import random
from repro_torch.chain.workload import (BlockContext, BlockPayload,
                                        PreparedWork, RewardEntries,
                                        _apply_rewards, global_miner)
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.jash import Jash, JashMeta
from repro_torch.core.ledger import merkle_root
from repro_torch.core.rewards import CreditBook, reward_full
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.device import DeviceLike, resolve
from repro_torch.train.steps import (TrainHparams, TrainState,
                                     make_train_state, make_train_step,
                                     params_digest, tree_digest)

# digest pair per microstep: sha256(batch) ++ sha256(metrics)
_PROOF_ROW = 64

# The CI micro instance of the family: a real (1-layer) transformer small
# enough for unit suites (the reference's, field for field). Its head dim
# is 16: on the card it trains through the flash kernels' hd 16 instances.
MICRO_CONFIG = ModelConfig(
    name="pnpcoin-micro", family="dense", n_layers=1, d_model=32,
    n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=128,
    tie_embeddings=True, remat=False, dtype="float32",
    citation="this work (CI micro model for the model_train suites)")

MICRO_KWARGS = dict(cfg=MICRO_CONFIG, seq_len=16, batch=2,
                    block_microsteps=2, n_miners=2)


class ModelTrainingWorkload:
    """Chain-train a real ``repro_torch.models`` transformer.

    Stateful (``snapshot``/``restore``/``reset``); rewards split across
    the origin's ``n_miners`` lanes like full-mode data-parallel SGD.
    Every consensus parameter (config body, input shape, seed, hparams,
    microsteps per block) is checksummed into the jash meta, so
    ``jash_id`` pins the exact training program."""

    name = "model_train"

    def __init__(self, *, cfg: Any = "pnpcoin-demo", seq_len: int = 32,
                 batch: int = 4, seed: int = 0, block_microsteps: int = 2,
                 hp: TrainHparams = TrainHparams(warmup_steps=4,
                                                 total_steps=512),
                 n_miners: int = 4, mesh=None,
                 device: DeviceLike = None) -> None:
        if block_microsteps < 1:
            raise ValueError(
                f"block_microsteps must be >= 1, got {block_microsteps} "
                "(a block with no microsteps commits no work)")
        if n_miners < 1:
            raise ValueError(f"n_miners must be >= 1, got {n_miners}")
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh: ROADMAP.md §1, item 6 (mesh and analysis "
                "tooling); the port trains on one device")
        self.cfg: ModelConfig = get_config(cfg) if isinstance(cfg, str) \
            else cfg
        self.seq_len, self.batch = seq_len, batch
        self.seed = seed
        self.block_microsteps = block_microsteps
        self.hp = hp
        self.n_miners = n_miners
        self.mesh = None
        self.device = resolve(device)
        self.shape = InputShape(f"chain{seq_len}x{batch}", seq_len, batch,
                                "train")
        self.pipeline = SyntheticTokenPipeline(self.cfg, self.shape,
                                               seed=seed)
        self._step = make_train_step(self.cfg, self.hp)
        # -- chained training state (built lazily on first block) ------
        self._state: Optional[TrainState] = None
        self._round = 0
        # committed fields of every block this instance applied, chain
        # order: (jash_id, merkle_root, state_digest, loss, proof bytes)
        self._history: List[Tuple[str, str, str, float, bytes]] = []
        self._jash: Optional[Jash] = None

    # -- consensus identity -------------------------------------------
    def _consensus_checksum(self) -> str:
        """Checksum over everything two nodes must agree on to train the
        same program: data meta, the full config body, hparams, and the
        per-block microstep count."""
        h = hashlib.sha256()
        h.update(self.pipeline.checksum().encode())
        h.update(repr(dataclasses.asdict(self.cfg)).encode())
        h.update(repr(self.hp).encode())
        h.update(np.int64(self.block_microsteps).tobytes())
        return h.hexdigest()

    def _step_jash(self) -> Jash:
        """The published train-step jash: one per workload (the chain
        position lives in ``train_height``)."""
        if self._jash is None:
            self._jash = Jash(
                name=f"model-train-{self.cfg.name}-{self.shape.name}"
                     f"-s{self.seed}",
                fn=self._step,
                meta=JashMeta(
                    arg_bits=32, res_bits=256,
                    data_checksum=self._consensus_checksum(),
                    data_acquisition="p2p", importance=1.0,
                    description=f"{self.block_microsteps} sharded "
                                f"{self.cfg.name} train microstep(s) "
                                "per block (real-model PoUW)"))
        return self._jash

    # -- chained state -------------------------------------------------
    @property
    def round(self) -> int:
        return self._round

    def _ensure_state(self) -> TrainState:
        if self._state is None:
            self._state = make_train_state(self.cfg, random.key(self.seed),
                                           self.device)
        return self._state

    def state_digest(self) -> str:
        """Canonical params digest of the current state: what the next
        mined block chains from, and what converged peers compare."""
        return params_digest(self._ensure_state())

    def snapshot(self):
        # every update replaces the state's tensors, so aliasing them is
        # safe; only the containers are copied
        return (self._round, self._state, list(self._history))

    def restore(self, snap) -> None:
        self._round = snap[0]
        self._state = snap[1]
        self._history = list(snap[2])

    def reset(self) -> None:
        """Back to round 0: fork choice calls this when an adopted chain
        must be replayed from genesis."""
        self._state = None
        self._round = 0
        self._history = []

    def is_pristine(self) -> bool:
        return self._round == 0 and not self._history

    # -- the block computation ----------------------------------------
    @staticmethod
    def _leaf(height: int, micro: int, batch_dig: bytes,
              metrics_dig: bytes) -> bytes:
        return (np.int64(height).tobytes() + np.int64(micro).tobytes()
                + batch_dig + metrics_dig)

    def _run_block(self, height: int):
        """Execute block ``height``'s microsteps on the current state.
        Functional: returns ``(new_state, batches, proof, root, loss)``
        without changing the workload, so a failed verify needs no
        rollback."""
        state = self._ensure_state()
        batches = [self.pipeline.microbatch(height, m)
                   for m in range(self.block_microsteps)]
        stacked: Dict[str, List[torch.Tensor]] = {}
        for b in batches:
            state, m = self._step(state, b)
            for k, v in m.items():
                stacked.setdefault(k, []).append(v)
        metrics = {k: torch.stack(v).cpu().numpy()
                   for k, v in stacked.items()}
        rows = []
        for m in range(self.block_microsteps):
            mh = hashlib.sha256()
            for k in sorted(metrics):
                mh.update(k.encode())
                mh.update(np.asarray(metrics[k][m], np.float64).tobytes())
            bd = bytes.fromhex(tree_digest(batches[m]))
            rows.append(np.frombuffer(bd + mh.digest(), np.uint8))
        proof = np.stack(rows)
        root = merkle_root([
            self._leaf(height, m, proof[m, :32].tobytes(),
                       proof[m, 32:].tobytes())
            for m in range(self.block_microsteps)])
        loss = float(np.asarray(metrics["loss"][-1], np.float64))
        return state, batches, proof, root, loss

    def _sampled_micro(self, payload: BlockPayload) -> int:
        """Seeded-random microstep index for the fresh-pipeline spot check,
        derived from the committed block fields, so miner and every
        verifier sample the same index and no miner can steer it."""
        h = hashlib.sha256(
            f"{payload.jash_id}|{payload.train_height}|"
            f"{payload.state_digest}".encode())
        return int.from_bytes(h.digest()[:8], "big") % self.block_microsteps

    # -- Workload protocol --------------------------------------------
    def prepare(self, ctx: BlockContext) -> PreparedWork:
        """Self-publishing: the block's jash is the (fixed) train step;
        ``ctx.work`` sizing is ignored (the data stream is the arg
        space)."""
        return PreparedWork(ctx, self._step_jash())

    def mine(self, work: PreparedWork) -> BlockPayload:
        """Run the block's microsteps and advance local state. If the block
        later loses fork choice, ``consider_chain`` unwinds the trainer
        via snapshot/``reset`` + replay."""
        ctx = work.ctx
        r = self._round
        jash_id = self._step_jash().source_id()
        new_state, _, proof, root, loss = self._run_block(r)
        self._state = new_state
        self._round = r + 1
        digest = params_digest(new_state)
        self._history.append((jash_id, root, digest, loss, proof.tobytes()))
        return BlockPayload(
            workload=self.name, jash_id=jash_id, merkle_root=root,
            n_results=self.block_microsteps, state_digest=digest,
            origin=ctx.node_id, block_reward=ctx.block_reward,
            loss=loss, train_height=r, n_miners=self.n_miners,
            micro_proof=proof)

    def verify(self, payload: BlockPayload) -> bool:
        """Stateful re-execution audit, doubling as state sync: replay the
        block's microsteps on this node's own state and compare root,
        proof rows, loss and post-block params digest bit for bit.
        Success advances local state; any mismatch leaves it untouched.
        Blocks already applied re-verify against the committed history;
        future heights are unverifiable (``False``) until the gap is
        filled."""
        r = payload.train_height
        if r is None or r > self._round:
            return False
        if payload.jash_id != self._step_jash().source_id():
            return False
        if (payload.n_results != self.block_microsteps
                or payload.n_miners != self.n_miners
                or payload.winner is not None):
            return False
        proof = payload.micro_proof
        if proof is None or tuple(np.shape(proof)) != \
                (self.block_microsteps, _PROOF_ROW):
            return False
        proof = np.ascontiguousarray(np.asarray(proof, np.uint8))
        # evidence must re-derive the committed root before any replay: a
        # relay cannot swap proof rows under an honest header
        if merkle_root([
                self._leaf(r, m, proof[m, :32].tobytes(),
                           proof[m, 32:].tobytes())
                for m in range(self.block_microsteps)]) \
                != payload.merkle_root:
            return False
        if r < self._round:
            hist = self._history[r]
            return (hist[0] == payload.jash_id
                    and hist[1] == payload.merkle_root
                    and hist[2] == payload.state_digest
                    and hist[3] == payload.loss
                    and hist[4] == proof.tobytes())
        # -- r == self._round: replay on OUR state ---------------------
        new_state, batches, ours, root, loss = self._run_block(r)
        # soundness precondition, asserted on every verify: a fresh
        # pipeline re-derives the sampled microbatch bit for bit from the
        # chain position alone
        idx = self._sampled_micro(payload)
        fresh = SyntheticTokenPipeline(self.cfg, self.shape, seed=self.seed)
        if tree_digest(fresh.microbatch(r, idx)) != \
                tree_digest(batches[idx]):
            return False
        if (root != payload.merkle_root
                or ours.tobytes() != proof.tobytes()
                or loss != payload.loss
                or params_digest(new_state) != payload.state_digest):
            return False
        self._state = new_state
        self._round = r + 1
        self._history.append((payload.jash_id, payload.merkle_root,
                              payload.state_digest, payload.loss,
                              proof.tobytes()))
        return True

    def verify_batch(self, payloads: Sequence[BlockPayload]) -> List[bool]:
        """Chain-order loop: each block's replay is the state advance the
        next block builds on, so stateful verification cannot be
        reordered, deduplicated or shared."""
        return [self.verify(p) for p in payloads]

    def reward(self, book: CreditBook, payload: BlockPayload
               ) -> RewardEntries:
        """Full-mode split: the origin's ``n_miners`` lanes share the block
        equally (``verify`` pins ``n_miners`` to the consensus value)."""
        staged = CreditBook()
        reward_full(staged,
                    [global_miner(payload.origin, m)
                     for m in range(payload.n_miners)],
                    payload.block_reward)
        return _apply_rewards(book, staged)
