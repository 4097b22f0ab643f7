"""``repro_torch.core`` — the kernel layer under ``repro_torch.chain``:
the port of ``repro.core``'s jash, executor, ledger, rewards, verify,
authority and difficulty modules."""
from repro_torch.core.authority import (
    ReviewReport, RuntimeAuthority, classic_jash,
)
from repro_torch.core.difficulty import DifficultyController, work_for_runtime
from repro_torch.core.executor import (
    FullResult, OptimalResult, run_full, run_optimal,
)
from repro_torch.core.jash import (
    Jash, JashMeta, JashValidationError, bounded_while, collatz_jash,
)
from repro_torch.core.ledger import Block, Ledger, merkle_root
from repro_torch.core.rewards import CreditBook, reward_full, reward_optimal
from repro_torch.core.verify import (VerifyReport, quorum_verify,
                                     quorum_verify_batched, verify_inclusion)

__all__ = [
    "Block",
    "CreditBook",
    "DifficultyController",
    "FullResult",
    "Jash",
    "JashMeta",
    "JashValidationError",
    "Ledger",
    "OptimalResult",
    "ReviewReport",
    "RuntimeAuthority",
    "VerifyReport",
    "bounded_while",
    "classic_jash",
    "collatz_jash",
    "merkle_root",
    "quorum_verify",
    "quorum_verify_batched",
    "reward_full",
    "reward_optimal",
    "run_full",
    "run_optimal",
    "verify_inclusion",
    "work_for_runtime",
]
