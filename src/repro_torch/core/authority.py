"""The Runtime Authority (PNPCoin §3.3, Fig. 1).

The port of ``repro/core/authority.py``. Review pipeline:
  1. validate + compile check: ``torch.export`` and the bounded-complexity
     walk of the exported graph (``Jash.validate``)
  2. runtime estimation: "performing runs on random inputs" on the device
     -> mean/std wall time (first run dropped), plus FLOPs counted over
     the exported graph (``count_flops``)
  3. prioritization: the reference's formula over importance, FLOPs and
     runtime, and a veto flag
  4. publication: one jash per block; when the queue is empty, a
     "Classic" SHA-256 jash is published (§3.4 back-compatibility).

FLOPs are counted the way XLA's cost analysis counts them for the
reference, over the ``torch.export`` graph that validation builds, for the
example args:
  - one flop per output element of every arithmetic, compare or select
    ``aten`` op (``_ELEMENTWISE``), and one per input element of a
    reduction (``_REDUCTIONS``);
  - ``2·M·N·K`` for a matrix product (plus one per output element for the
    bias of ``addmm``, ``baddbmm`` and ``linear``);
  - the body of a ``scan`` counted once, as XLA counts a loop body once,
    and the larger branch of a ``cond``;
  - nothing for views, copies, casts, indexing and tensor creation.
The priority formula is the reference's, so queued jashes pop in the
reference's order.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.jash import Jash, JashMeta
from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels.native import MASK32
from repro_torch.kernels.ops import sha256_words


_ELEMENTWISE = frozenset("""
    abs add sub rsub mul div true_divide floor_divide remainder fmod neg
    reciprocal pow exp exp2 expm1 log log2 log1p sqrt rsqrt sin cos tan tanh
    sigmoid silu relu gelu erf sign floor ceil round trunc maximum minimum
    clamp clamp_min clamp_max bitwise_and bitwise_or bitwise_xor bitwise_not
    bitwise_left_shift bitwise_right_shift __and__ __or__ __xor__ __lshift__
    __rshift__ logical_and logical_or logical_xor logical_not eq ne lt le gt
    ge where masked_fill
    """.split())
_REDUCTIONS = frozenset("""
    sum mean prod amax amin max min argmax argmin any all cumsum cumprod
    logsumexp _softmax _log_softmax softmax log_softmax
    """.split())
# index of the operand whose last dim is the contraction K, and whether
# a bias adds one flop per output element
_MATMULS = {"mm": (0, False), "bmm": (0, False), "matmul": (0, False),
            "mv": (0, False), "dot": (0, False), "addmm": (1, True),
            "baddbmm": (1, True), "addmv": (1, True), "linear": (0, True)}


def _numel(node: torch.fx.Node) -> int:
    val = node.meta.get("val")
    if isinstance(val, (tuple, list)):
        return sum(int(v.numel()) for v in val
                   if isinstance(v, torch.Tensor))
    return int(val.numel()) if isinstance(val, torch.Tensor) else 0


def count_flops(gm: torch.fx.GraphModule) -> float:
    """FLOPs of one run of an exported graph, by the rule in the module
    docstring."""
    total = 0.0
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        target = node.target
        if isinstance(target, torch._ops.HigherOrderOperator):
            subs = [count_flops(getattr(gm, a.target)) for a in node.args
                    if isinstance(a, torch.fx.Node) and a.op == "get_attr"
                    and isinstance(getattr(gm, a.target),
                                   torch.fx.GraphModule)]
            total += max(subs, default=0.0)
            continue
        if not isinstance(target, torch._ops.OpOverload) \
                or target.namespace != "aten":
            continue
        name = target._schema.name.split("::", 1)[1]
        if not name.startswith("__"):
            name = name.rstrip("_")         # in-place forms count the same
        if name in _MATMULS:
            operand, bias = _MATMULS[name]
            k = int(node.args[operand].meta["val"].shape[-1])
            out = _numel(node)
            if name == "linear":
                bias = len(node.args) > 2 and node.args[2] is not None
            total += 2.0 * out * k + (out if bias else 0)
        elif name in _ELEMENTWISE:
            total += _numel(node)
        elif name in _REDUCTIONS:
            total += _numel(node.args[0])
    return total


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
        program = jash.validate(loop_bound=self.loop_bound)
        flops = count_flops(program.graph_module)

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
