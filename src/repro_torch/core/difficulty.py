"""Block-work retargeting (PNPCoin §3.1 granularity + §5 limitation): a
copy of ``repro/core/difficulty.py`` (pure Python).

Bitcoin retargets the leading-zero difficulty every 2016 blocks so block
time tracks 10 minutes.  PNPCoin's analogue is the *amount of useful
work per block*: the RA controls ``meta.max_arg`` ("to achieve greater
granularity than powers of two", §3.1), so the controller adjusts the
published arg-space size to hit a target block time — directly
addressing the paper's own §5 limitation that "jash functions are
computed on a one-per-block basis, putting an inconvenient limitation on
the runtime of each node".

A standard EMA controller: work_{t+1} = work_t * clip(target/ema, 1/4, 4)
(Bitcoin clips retargets to 4x as well).  Before any observation the
controller proposes the current work unchanged, and the EMA seeds from
the *mean of the first ``seed_samples`` observations* rather than
locking the first (often cold-compile-skewed) block time in with full
weight.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class DifficultyController:
    target_block_s: float
    min_work: int = 1
    max_work: int = 1 << 32
    ema_alpha: float = 0.3
    max_retarget: float = 4.0
    seed_samples: int = 4

    _ema: Optional[float] = None
    _warmup: List[float] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        if self.seed_samples < 1:
            raise ValueError(
                f"seed_samples must be >= 1, got {self.seed_samples} "
                "(the EMA needs at least one sample to seed from)")

    def observe(self, block_time_s: float) -> None:
        if len(self._warmup) < self.seed_samples:
            # seed phase: the EMA is the running mean of the first k
            # samples, so one outlier block can't dominate the seed
            self._warmup.append(block_time_s)
            self._ema = sum(self._warmup) / len(self._warmup)
        else:
            self._ema = (1 - self.ema_alpha) * self._ema + \
                self.ema_alpha * block_time_s

    @property
    def ema_block_s(self) -> Optional[float]:
        return self._ema

    def propose_work(self, current_work: int) -> int:
        """args-per-block for the next publication.  With no observation
        yet there is nothing to retarget against: the current work is
        returned unchanged."""
        if self._ema is None or self._ema <= 0:
            return current_work
        ratio = self.target_block_s / self._ema
        ratio = min(max(ratio, 1.0 / self.max_retarget), self.max_retarget)
        work = int(current_work * ratio)
        return min(max(work, self.min_work), self.max_work)


def work_for_runtime(runtime_mean_s: float, target_block_s: float,
                     n_miners: int, *, safety: float = 0.9) -> int:
    """Initial work sizing from the RA's §3.3 runtime estimate: how many
    args fit the target block time across the miner fleet."""
    if runtime_mean_s <= 0:
        return 1
    return max(1, int(n_miners * target_block_s * safety / runtime_mean_s))
