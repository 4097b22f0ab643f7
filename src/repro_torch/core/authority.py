"""The Runtime Authority (PNPCoin §3.3, Fig. 1).

The port of ``repro/core/authority.py``. Review pipeline:
  1. validate + compile check: ``torch.export`` and the bounded-complexity
     walk of the exported graph (``Jash.validate``)
  2. runtime estimation: "performing runs on random inputs" on the device
     -> mean/std wall time (first run dropped), plus FLOPs from
     ``FlopCounterMode``
  3. prioritization: the reference's formula over importance, FLOPs and
     runtime, and a veto flag
  4. publication: one jash per block; when the queue is empty, a
     "Classic" SHA-256 jash is published (§3.4 back-compatibility).

``FlopCounterMode`` counts matrix products and convolutions only, where
XLA's cost analysis also counts elementwise work, so priorities differ
from the reference's and two queued jashes may pop in another order.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.jash import Jash, JashMeta
from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels.native import MASK32
from repro_torch.kernels.ops import sha256_words


@dataclasses.dataclass
class ReviewReport:
    jash_id: str
    compiled: bool
    flops_estimate: float
    runtime_mean_s: float
    runtime_std_s: float
    loop_bound_ok: bool
    priority: float
    vetoed: bool = False
    reason: str = ""


@dataclasses.dataclass(order=True)
class _QueueEntry:
    neg_priority: float
    seq: int
    jash: Jash = dataclasses.field(compare=False)
    report: ReviewReport = dataclasses.field(compare=False)


class RuntimeAuthority:
    def __init__(self, *, loop_bound: int = 1 << 20,
                 runtime_probe_n: int = 4, device: DeviceLike = None) -> None:
        self.loop_bound = loop_bound
        self.runtime_probe_n = runtime_probe_n
        self.device = resolve(device)
        self._queue: List[_QueueEntry] = []
        self._seq = 0
        self.reviews: Dict[str, ReviewReport] = {}

    # ------------------------------------------------------------------
    def submit(self, jash: Jash, veto: bool = False) -> ReviewReport:
        """Full §3.3 review.  Raises JashValidationError on hard failures;
        a veto (human criterion) parks the jash without publication."""
        jid = jash.source_id()
        jash.validate(loop_bound=self.loop_bound)

        with FlopCounterMode(display=False) as counter:
            jash.fn(*jash.example_args)
        flops = float(counter.get_total_flops())

        # runtime estimation on random inputs, on the mining device
        times = []
        rng = np.random.RandomState(0)
        for _ in range(self.runtime_probe_n):
            arg = torch.tensor([rng.randint(0, max(jash.meta.n_args, 2))],
                               dtype=torch.int64, device=self.device)
            t0 = time.perf_counter()
            jash.fn(arg)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            times.append(time.perf_counter() - t0)
        mean_t, std_t = float(np.mean(times[1:])), float(np.std(times[1:]))

        # prioritization: cheap + important first (§3.3 criteria)
        data_penalty = 1.0 + len(jash.meta.data_checksum) * 0.0
        priority = jash.meta.importance / (
            (1e-9 + flops) ** 0.25 * (1e-6 + mean_t) ** 0.25 * data_penalty)

        report = ReviewReport(
            jash_id=jid, compiled=True, flops_estimate=flops,
            runtime_mean_s=mean_t, runtime_std_s=std_t,
            loop_bound_ok=True, priority=priority, vetoed=veto,
            reason="veto" if veto else "")
        self.reviews[jid] = report
        if not veto:
            heapq.heappush(self._queue,
                           _QueueEntry(-priority, self._seq, jash, report))
            self._seq += 1
        return report

    # ------------------------------------------------------------------
    def publish_next(self) -> Tuple[Jash, str]:
        """Pop the highest-priority jash for the next block; if the queue
        is empty, publish a Classic SHA-256 jash (§3.4)."""
        if self._queue:
            entry = heapq.heappop(self._queue)
            return entry.jash, "queued"
        return classic_jash(), "classic"

    def requeue(self, jash: Jash) -> None:
        """Return a published-but-unmined jash to the queue at its
        reviewed priority (the chain layer uses this when a mined block
        fails self-verification, so a submission is not silently lost)."""
        report = self.reviews.get(jash.source_id())
        priority = report.priority if report is not None else 0.0
        heapq.heappush(self._queue,
                       _QueueEntry(-priority, self._seq, jash, report))
        self._seq += 1

    @property
    def queue_depth(self) -> int:
        return len(self._queue)


def _classic_fn(args: torch.Tensor) -> torch.Tensor:
    # module-level: every classic block shares one function identity, so
    # verify-side replay memos recognise it across blocks and nodes
    msg = torch.stack([args & MASK32,
                       torch.full_like(args, 0x504E5043)], dim=1)  # "PNPC"
    return sha256_words(sha256_words(msg))              # double SHA-256


def classic_jash(arg_bits: int = 20) -> Jash:
    """§3.4: 'jash functions containing the SHA-256 hashes with fixed
    input, and empty meta files' — plain double-SHA-256 proof of work."""
    meta = JashMeta(arg_bits=arg_bits, res_bits=256, data_checksum="",
                    data_acquisition="none", importance=0.0,
                    description="Classic SHA-256 block (back-compat §3.4)")
    return Jash("classic-sha256", _classic_fn, meta,
                example_args=(torch.tensor([0], dtype=torch.int64),))
