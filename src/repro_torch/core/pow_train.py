"""Proof-of-useful-work training: blocks are training steps. The port of
``repro/core/pow_train.py``.

Each block:

  1. the RA publishes the block's jash: the reviewed, bounded train step
     with the block's data-batch meta;
  2. miners execute it: **full** mode is synchronous data-parallel SGD
     (every miner's shard result is a submission), **optimal** mode is the
     ES candidate search of ``core/es.py``, where the lowest loss wins;
  3. results are Merkle-committed, the new state digest is chained into
     the ledger, and rewards are credited (full: split across miners;
     optimal: the winner takes the block).

A verifier re-derives the batch from (seed, step), re-runs the step on its
own trainer and must reproduce the state digest bit for bit (§3 req. 2).
On the card a full-mode step runs the flash forward's training instance
and the flash backward; an ES candidate is scored through the forward's
serving instance.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import random
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import es as es_mod
from repro_torch.core.jash import Jash, JashMeta
from repro_torch.core.ledger import Ledger, merkle_root
from repro_torch.core.rewards import CreditBook, reward_full, reward_optimal
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.device import DeviceLike, resolve
from repro_torch.train.steps import (TrainHparams, TrainState, make_eval_step,
                                     make_train_state, make_train_step,
                                     make_update, params_digest)


@dataclasses.dataclass
class BlockRecord:
    height: int
    mode: str
    loss: float
    state_digest: str
    block_hash: str


def _metrics_digest(metrics: Dict[str, Any], step: int) -> str:
    h = hashlib.sha256()
    h.update(np.int64(step).tobytes())
    for k in sorted(metrics):
        h.update(k.encode())
        h.update(np.asarray(metrics[k], np.float64).tobytes())
    return h.hexdigest()


def _light_state_digest(state: TrainState) -> str:
    """Per-block state digest: sha256 of the canonical params bytes
    (``train.steps.params_digest``: gathered to the host, little-endian,
    dtype and shape framed), the helper ``ModelTrainingWorkload`` commits
    too."""
    return params_digest(state)


def _fake_on_cpu(tree: Any, mode) -> Any:
    """A tree of dicts and named tuples with each tensor as a fake CPU
    tensor of ``mode`` (a ``FakeTensorMode``) of the same shape and dtype:
    no storage, nothing copied."""
    if isinstance(tree, dict):
        return {k: _fake_on_cpu(v, mode) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_fake_on_cpu(v, mode) for v in tree))
    with mode:
        return torch.empty(tree.shape, dtype=tree.dtype, device="cpu")


@dataclasses.dataclass
class TrainStepJash(Jash):
    """The published train step. Its id is the reference's (name and
    meta). Its review departs from the reference's (ROADMAP.md §3):
    ``torch.export`` cannot take a function that calls
    ``torch.autograd.grad`` (it lifts the outputs autograd saves, such as
    a log-sum-exp, as constants of the example inputs), so ``validate``
    exports the step's two halves, each on its own: the loss's forward
    (``loss_fn``) and the schedule with the AdamW update (``update_fn``).
    Both are traced on fake CPU tensors of the state's shapes and dtypes,
    through the hand kernels' plain versions: a kernel's wrapper hands raw
    device pointers to its library, which the trace cannot follow. The
    graph is the one a CPU copy gives, but nothing is copied: at
    qwen3-0.6b's width a host copy of the state is ~7 GB a trainer."""
    loss_fn: Optional[Callable] = None
    update_fn: Optional[Callable] = None

    def validate(self, state: TrainState, batch: Dict, *,
                 loop_bound: int = 1 << 20
                 ) -> Tuple[torch.export.ExportedProgram, ...]:
        from torch._subclasses.fake_tensor import FakeTensorMode
        mode = FakeTensorMode()
        params, opt = (_fake_on_cpu(state.params, mode),
                       _fake_on_cpu(state.opt, mode))
        # both halves run without autograd's graph, as in the step
        with torch.no_grad():
            loss = Jash(f"{self.name}/loss", self.loss_fn,
                        self.meta).validate(params, _fake_on_cpu(batch, mode),
                                            loop_bound=loop_bound)
            # the gradients have the params' shapes and dtypes
            update = Jash(f"{self.name}/update", self.update_fn,
                          self.meta).validate(params, params, opt,
                                              loop_bound=loop_bound)
        return loss, update


class PoUWTrainer:
    """Block-driven trainer. ``mode``: "full" (data-parallel SGD) or
    "optimal" (ES candidate search, §3.3). It trains on ``device`` (the
    card unless the caller names another)."""

    def __init__(self, cfg: ModelConfig, shape: InputShape, *,
                 hp: TrainHparams = TrainHparams(), mode: str = "full",
                 n_miners: int = 8, block_reward: float = 50.0,
                 pop_size: int = 8, sigma: float = 0.01,
                 seed: int = 0, block_microsteps: int = 1,
                 fixed_batch: bool = False,
                 device: DeviceLike = None) -> None:
        if mode not in ("full", "optimal"):
            raise ValueError(f"mode is 'full' or 'optimal', got {mode!r}")
        if block_microsteps < 1:
            raise ValueError(
                f"block_microsteps must be >= 1, got {block_microsteps} "
                "(a block with no microsteps commits no work)")
        self.cfg, self.shape, self.hp, self.mode = cfg, shape, hp, mode
        self.fixed_batch = fixed_batch
        self.n_miners = n_miners
        self.block_reward = block_reward
        self.pop_size, self.sigma = pop_size, sigma
        self.block_microsteps = block_microsteps
        self.device = resolve(device)
        self._seed = seed
        self.pipeline = SyntheticTokenPipeline(cfg, shape, seed=seed)
        self.ledger = Ledger()
        self.book = CreditBook()
        self.state = make_train_state(cfg, random.key(seed), self.device)
        self._train_step = make_train_step(cfg, hp)
        self._eval_step = make_eval_step(cfg)
        self._replay_cache: Dict[int, "PoUWTrainer"] = {}
        self.key = random.key(seed + 1)
        self.history: List[BlockRecord] = []

        # The published payload is itself a jash, reviewed for bounded
        # complexity like any researcher submission.
        self.step_jash = TrainStepJash(
            name=f"train-{cfg.name}-{shape.name}",
            fn=self._train_step,
            meta=JashMeta(arg_bits=32, res_bits=256,
                          data_checksum=self.pipeline.checksum(),
                          data_acquisition="p2p",
                          importance=1.0,
                          description="one PoUW training step"),
            loss_fn=self._eval_step, update_fn=make_update(hp))
        self.step_jash.validate(self.state, self.pipeline.batch(0))

    # ------------------------------------------------------------------
    def _block_step(self, state: TrainState, batch: Dict
                    ) -> Tuple[TrainState, Dict]:
        """A block's microsteps on one batch; the last one's metrics."""
        for _ in range(self.block_microsteps):
            state, metrics = self._train_step(state, batch)
        return state, metrics

    def run_block(self) -> BlockRecord:
        step = self.ledger.height
        batch = self.pipeline.batch(0 if self.fixed_batch else step)

        if self.mode == "full":
            self.state, metrics = self._block_step(self.state, batch)
            metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
            loss = float(metrics["loss"])
            # every miner's shard result is a first submission (§3.3)
            leaves = [
                f"{step}|{m}|{_metrics_digest(metrics, step)}".encode()
                for m in range(self.n_miners)]
            winner = None
            best_res = None
            reward_full(self.book, list(range(self.n_miners)),
                        self.block_reward)
        else:
            self.key, sub = random.split(self.key)
            losses, best = es_mod.es_block(
                self._eval_step, self.state.params, batch, sub,
                pop_size=self.pop_size, sigma=self.sigma)
            best = int(best)
            losses = losses.cpu().numpy()
            loss = float(losses[best])
            new_params = es_mod.candidate_params(
                self.state.params, sub, best, self.sigma)
            self.state = TrainState(params=new_params, opt=self.state.opt)
            leaves = [f"{step}|{i}|{float(l):.8f}".encode()
                      for i, l in enumerate(losses)]
            winner = best % self.n_miners
            best_res = f"{loss:.8f}"
            reward_optimal(self.book, winner, self.block_reward)

        digest = _light_state_digest(self.state)
        blk = self.ledger.append(
            jash_id=self.step_jash.source_id(), mode=self.mode,
            merkle=merkle_root(leaves), winner=winner, best_res=best_res,
            n_results=len(leaves), state_digest=digest)
        rec = BlockRecord(height=blk.height, mode=self.mode, loss=loss,
                          state_digest=digest, block_hash=blk.block_hash)
        self.history.append(rec)
        return rec

    def run(self, n_blocks: int) -> List[BlockRecord]:
        return [self.run_block() for _ in range(n_blocks)]

    # ------------------------------------------------------------------
    def audit_block(self, height: int, seed: Optional[int] = None) -> bool:
        """Verifier path: replay the chain up to ``height`` and compare the
        recorded state digest (determinism, §3 req. 2). ``seed`` defaults
        to the trainer's own construction seed. The replay trainer is
        cached per seed, so successive audits are incremental: O(delta
        blocks), not a replay from genesis per call."""
        seed = self._seed if seed is None else seed
        replay = self._replay_cache.get(seed)
        if replay is None:
            replay = PoUWTrainer(self.cfg, self.shape, hp=self.hp,
                                 mode=self.mode, n_miners=self.n_miners,
                                 pop_size=self.pop_size, sigma=self.sigma,
                                 seed=seed,
                                 block_microsteps=self.block_microsteps,
                                 fixed_batch=self.fixed_batch,
                                 device=self.device)
            self._replay_cache[seed] = replay
        while replay.ledger.height <= height:
            replay.run_block()
        return (replay.history[height].state_digest
                == self.history[height].state_digest)
