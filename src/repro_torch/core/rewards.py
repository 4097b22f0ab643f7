"""Reward distribution (PNPCoin §3.3/§4): a copy of
``repro/core/rewards.py`` (pure Python).

**full** mode: "the reward is distributed evenly across all first
submissions of results" — miners earn block_reward / n_args for each arg
they were first to submit, plus (§4) a leading-zeros bonus on
sha256(input || output).

**optimal** mode: "the first lowest solution is accepted" — the winner
takes the block reward.

The credit table is the PoUW analogue of the coin: conservation
(sum of all credits == sum of all block rewards) is a property test.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence


@dataclasses.dataclass
class CreditBook:
    balances: Dict[int, float] = dataclasses.field(default_factory=dict)
    total_issued: float = 0.0

    def credit(self, miner: int, amount: float) -> None:
        self.balances[miner] = self.balances.get(miner, 0.0) + amount
        self.total_issued += amount


def reward_full(book: CreditBook, first_submitter: Sequence[int],
                block_reward: float,
                bonus_winner: Optional[int] = None,
                bonus_fraction: float = 0.1) -> None:
    """``first_submitter[i]`` = miner id first to return arg i's result."""
    n = len(first_submitter)
    if n == 0:
        return
    base = block_reward * (1.0 - (bonus_fraction if bonus_winner is not None
                                  else 0.0))
    per = base / n
    for miner in first_submitter:
        book.credit(int(miner), per)
    if bonus_winner is not None:
        book.credit(int(bonus_winner), block_reward * bonus_fraction)


def reward_optimal(book: CreditBook, winner: int,
                   block_reward: float) -> None:
    book.credit(int(winner), block_reward)
