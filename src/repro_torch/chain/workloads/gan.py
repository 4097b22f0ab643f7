"""``GanInversionWorkload``: §1 "finding the appropriate input to a
Generator", a stateful optimal-mode latent search as a chain payload. The
port of ``repro/chain/workloads/gan.py``.

The inverse problem: given a fixed generator ``G`` and a target ``x*``,
find ``z`` minimizing ``||G(z) - x*||²``. Each block is one refinement
round, an optimal-mode argmin over a pseudo-random latent grid centered on
the previous winner, and accepting a block **zooms** the grid (the center
moves to the winning latent, the scale halves), so the search state is
chained like the training workload's model state:

* the post-zoom ``(round, center, scale)`` digest is the committed
  ``state_digest``; a peer re-verifies by replaying the round on its own
  state and comparing digests bit for bit (§3 req. 2), so the audit
  doubles as state sync;
* verification is therefore **stateful**: it advances local state on
  success, restores the pre-verify snapshot on mismatch, and exposes the
  ``snapshot``/``restore``/``reset`` rollback trio so fork choice can
  unwind discarded rounds;
* ``BlockPayload.train_height`` carries the round index.

The generator weights, the target and every grid latent are drawn from
``repro_torch.random`` at the reference's keys, on the workload's device,
where the generator runs too. The round's jash takes a batch of args, as
every port jash does: ``fold_in`` over the args and ``normal`` under the
batch of keys give each arg the latent the reference's scalar call gives
it. The card's draws differ from the host's only where the two devices'
``log1p`` round apart, so nodes on the card agree bit for bit with each
other, and with a node on the host only as far as their float arithmetic
agrees, as for training.

GAN jash ids commit ``state_digest``, which holds the center's float
bytes: the reference and the port agree on round 0's id, and after it
only as far as their float arithmetic agrees.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import random
from repro_torch.chain.workload import (BlockContext, BlockPayload, MINER_LANE,
                                        PreparedWork, RewardEntries,
                                        _apply_rewards, global_miner)
from repro_torch.core.executor import run_optimal
from repro_torch.core.jash import Jash, JashMeta
from repro_torch.core.ledger import merkle_root
from repro_torch.core.rewards import CreditBook, reward_optimal
from repro_torch.device import DeviceLike, resolve


class GanInversionWorkload:
    """§1 GAN inversion: one grid-refinement round per block.

    Stateful (``snapshot``/``restore``/``reset``); the winner takes the
    block, as in optimal mode. ``verify_batch`` is a chain-order loop:
    stateful verification can be neither reordered nor deduplicated.
    Mining and verification run on ``device`` (``None``: the CUDA card).
    """

    name = "gan"

    def __init__(self, *, seed: int = 0, d_z: int = 8, d_x: int = 32,
                 grid_bits: int = 10, zoom: float = 0.5,
                 init_scale: float = 3.0,
                 device: DeviceLike = None) -> None:
        if not 0.0 < zoom < 1.0:
            raise ValueError(f"zoom must be in (0, 1), got {zoom}")
        self.seed = seed
        self.d_z, self.d_x = d_z, d_x
        self.grid_bits = grid_bits
        self.zoom = zoom
        self.init_scale = init_scale
        self.device = resolve(device)
        self._key = random.key(seed)
        k1, k2, k3 = random.split(self._key, 3)
        dev = self.device
        self._w1 = random.normal(k1.to(dev), (d_z, 64)) / float(np.sqrt(d_z))
        self._w2 = random.normal(k2.to(dev), (64, d_x)) / 8.0
        self._z_true = random.normal(k3.to(dev), (d_z,))
        self._x_target = self._generate(self._z_true)
        # -- chained search state -------------------------------------
        self._round = 0
        self._center = np.zeros(d_z, np.float32)
        self._scale = float(init_scale)
        # committed fields of every round this instance applied, round
        # order: (jash_id, best_arg, best_res, merkle_root, state_digest)
        self._history: List[Tuple[str, int, str, str, str]] = []
        self._jash_cache: Optional[Tuple[int, Jash]] = None

    # -- the fixed inverse problem ------------------------------------
    def _generate(self, z: torch.Tensor) -> torch.Tensor:
        return torch.tanh(z @ self._w1) @ self._w2

    def _draws(self, args: torch.Tensor) -> torch.Tensor:
        """The grid's standard-normal draws (n, d_z) for a batch of args,
        on the args' device: arg's row is ``normal(fold_in(key(seed), arg),
        (d_z,))``."""
        return random.normal(random.fold_in(self._key, args), (self.d_z,))

    def _latent(self, arg: int) -> torch.Tensor:
        """The grid is pseudo-random, not a lattice: arg -> a deterministic
        Gaussian perturbation of the current center."""
        zs = self._draws(torch.tensor([arg], device=self.device))[0]
        center = torch.as_tensor(self._center, device=self.device)
        return center + self._scale * zs / 3.0

    def inversion_error(self) -> float:
        """``||G(center) - x*||²`` of the current search state: what the
        chain is collectively minimizing (not monotone per round, but the
        zoom contracts the grid around ever-better winners)."""
        c = torch.as_tensor(self._center, device=self.device)
        return float(torch.sum(torch.square(self._generate(c)
                                            - self._x_target)))

    # -- chained state --------------------------------------------------
    @property
    def round(self) -> int:
        return self._round

    def state_digest(self) -> str:
        """Bit-exact commitment of ``(round, center, scale)``: what the
        block header signs and peers compare after replaying a round."""
        h = hashlib.sha256()
        h.update(np.int64(self._round).tobytes())
        h.update(np.ascontiguousarray(self._center, np.float32).tobytes())
        h.update(np.float64(self._scale).tobytes())
        return h.hexdigest()

    def snapshot(self):
        return (self._round, self._center.copy(), self._scale,
                list(self._history))

    def restore(self, snap) -> None:
        # copies, not the snapshot's own containers: ringed fork-choice
        # checkpoints outlive a restore
        self._round = snap[0]
        self._center = snap[1].copy()
        self._scale = snap[2]
        self._history = list(snap[3])
        self._jash_cache = None

    def reset(self) -> None:
        """Back to round 0: fork choice calls this when an adopted chain
        must be replayed from genesis."""
        self._round = 0
        self._center = np.zeros(self.d_z, np.float32)
        self._scale = float(self.init_scale)
        self._history = []
        self._jash_cache = None

    def is_pristine(self) -> bool:
        return self._round == 0 and not self._history

    def _round_jash(self) -> Jash:
        """The current round's jash: the inversion error over the latent
        grid of ``(center, scale)``, a batch of args at a time. The state
        digest is checksummed into the meta, so ``jash_id`` commits the
        exact grid this round searched. Cached per round."""
        if self._jash_cache is not None and \
                self._jash_cache[0] == self._round:
            return self._jash_cache[1]
        center = torch.as_tensor(self._center, device=self.device)
        scale = self._scale
        w1, w2, x_target = self._w1, self._w2, self._x_target
        draws = self._draws

        def fn(args: torch.Tensor) -> torch.Tensor:
            z = center + scale * draws(args) / 3.0
            err = torch.sum(torch.square(torch.tanh(z @ w1) @ w2 - x_target),
                            dim=-1)
            # lower res wins (§3.3); truncated to a 32-bit word
            return (err * 1e4).to(torch.int64)

        jash = Jash(f"gan-inv-{self.seed}-r{self._round}", fn,
                    JashMeta(arg_bits=self.grid_bits, res_bits=32,
                             data_checksum=self.state_digest(),
                             description="GAN-inversion latent grid "
                                         "refinement (paper §1)"),
                    example_args=(torch.tensor([0], dtype=torch.int64,
                                               device=self.device),))
        self._jash_cache = (self._round, jash)
        return jash

    def _zoom(self, best_arg: int) -> None:
        """Advance the search state: re-center on the winning latent and
        contract the grid. A pure function of (state, best_arg), so every
        node replaying the same round lands on the same bits."""
        z = self._latent(best_arg)
        self._center = z.cpu().numpy().astype(np.float32)
        self._scale *= self.zoom
        self._round += 1

    @staticmethod
    def _leaf(opt) -> bytes:
        return (np.uint32(opt.best_arg).tobytes()
                + opt.best_res.astype("<u4").tobytes())

    # -- Workload protocol --------------------------------------------
    def prepare(self, ctx: BlockContext) -> PreparedWork:
        """Self-publishing: the round's jash is derived from local state
        (``ctx.work`` sizing is ignored: the grid is the arg space)."""
        return PreparedWork(ctx, self._round_jash())

    def mine(self, work: PreparedWork) -> BlockPayload:
        """Argmin over the grid, then zoom. Mining advances the search
        state; if the block later loses fork choice, ``consider_chain``
        unwinds it via snapshot/``reset`` and a replay."""
        ctx = work.ctx
        r = self._round
        jash = work.jash
        opt = run_optimal(jash, lanes=ctx.lanes, device=self.device)
        root = merkle_root([self._leaf(opt)])
        self._zoom(opt.best_arg)
        digest = self.state_digest()
        best_res = opt.best_res.tobytes().hex()
        self._history.append((jash.source_id(), opt.best_arg, best_res,
                              root, digest))
        return BlockPayload(
            workload=self.name, jash_id=jash.source_id(),
            merkle_root=root, n_results=opt.n_evaluated,
            winner=global_miner(ctx.node_id, opt.winner),
            best_res=best_res, state_digest=digest,
            origin=ctx.node_id, block_reward=ctx.block_reward,
            jash=jash, best_arg=opt.best_arg, train_height=r)

    def verify(self, payload: BlockPayload) -> bool:
        """Stateful re-execution (§3 req. 2): a payload at the local round
        replays the argmin on this node's own grid state (never the
        evidence closure), compares ``(best_arg, best_res, root)`` bit for
        bit, then zooms and compares the post-zoom state digest. Success
        advances local state; any mismatch leaves it untouched. Rounds
        already applied re-verify against the committed history; future
        rounds are unverifiable (``False``) until the gap is filled."""
        r = payload.train_height
        if r is None or r > self._round:
            return False
        if (payload.winner is None
                or payload.winner // MINER_LANE != payload.origin):
            return False
        if r < self._round:
            hist = self._history[r]
            return (hist[0] == payload.jash_id
                    and hist[1] == payload.best_arg
                    and hist[2] == payload.best_res
                    and hist[3] == payload.merkle_root
                    and hist[4] == payload.state_digest)
        jash = self._round_jash()
        if jash.source_id() != payload.jash_id:
            return False
        opt = run_optimal(jash, device=self.device)   # our state, lanes=1
        best_res = opt.best_res.tobytes().hex()
        if (opt.best_arg != payload.best_arg
                or best_res != payload.best_res
                or merkle_root([self._leaf(opt)]) != payload.merkle_root):
            return False
        snap = self.snapshot()
        self._zoom(opt.best_arg)
        if self.state_digest() != payload.state_digest:
            self.restore(snap)
            return False
        self._history.append((payload.jash_id, opt.best_arg, best_res,
                              payload.merkle_root, payload.state_digest))
        return True

    def verify_batch(self, payloads: Sequence[BlockPayload]) -> List[bool]:
        """Chain-order loop: each round's replay is the state advance the
        next round builds on, so stateful verification cannot be
        reordered, deduplicated or shared."""
        return [self.verify(p) for p in payloads]

    def reward(self, book: CreditBook, payload: BlockPayload
               ) -> RewardEntries:
        """The winner takes the block: the lane that found the round's best
        latent (lane-checked against ``origin`` by ``verify``)."""
        staged = CreditBook()
        reward_optimal(staged, payload.winner, payload.block_reward)
        return _apply_rewards(book, staged)
