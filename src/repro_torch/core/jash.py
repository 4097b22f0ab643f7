"""The *jash* (PNPCoin §3): an arbitrary deterministic bounded-complexity
function replacing Bitcoin's SHA-256 in the proof-of-work step.

The port of ``repro/core/jash.py``. A jash function takes a 1-D int64
tensor of args and returns, per arg, one or more 32-bit result words
(int64 tensors masked to 32 bits; a tuple of outputs is concatenated
word-wise, as the reference flattens a result pytree).

Paper requirements -> PyTorch enforcement:

  1. "compiles with the current gcc"       -> exports under
     ``torch.export`` (checked by the Runtime Authority at submission).
  2. "deterministic across runs/archs"     -> only ``aten``/``prims``
     operators in the exported graph: no print, no effectful or custom
     (Python callback) operators.
  3./4. n-bit argument, m-bit result       -> ``JashMeta.arg_bits`` /
     ``res_bits``, with ``max_arg`` for sub-power-of-two granularity.
  5. no unbounded loops, loops run <= s times -> the exported graph is
     walked recursively: a ``while_loop`` is REJECTED, a ``scan`` longer
     than the RA bound is rejected, Python loops unroll at export and so
     are bounded by construction.

``bounded_while`` reproduces the paper's Fig.2 -> Fig.3 conversion.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Optional, Tuple

import torch
from torch._higher_order_ops import scan

from repro_torch.kernels.native import MASK32

# higher-order operators a jash may use; `while_loop` is the unbounded one
_ALLOWED_HOPS = {"scan", "cond"}
# operators that talk to the outside world
_IO_FORBIDDEN = {"aten::_print", "with_effects", "call_torchbind"}
_DETERMINISTIC_NAMESPACES = {"aten", "prims"}


class JashValidationError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class JashMeta:
    """The meta file accompanying every jash (§3): data checksum, how data
    is acquired, and the argument bound. Class name, field order and
    defaults equal the reference's: ``Jash.source_id`` hashes
    ``repr(meta)``."""
    arg_bits: int
    res_bits: int
    max_arg: Optional[int] = None          # §3.1 granularity bound
    data_checksum: str = ""                # sha256 of the data bundle
    data_acquisition: str = "none"         # "direct" | "p2p" | "none"
    importance: float = 0.5                # §3.3 prioritization (0..1)
    description: str = ""

    @property
    def n_args(self) -> int:
        upper = 1 << self.arg_bits
        return min(upper, self.max_arg) if self.max_arg else upper


def _op_name(target) -> str:
    if isinstance(target, torch._ops.HigherOrderOperator):
        return target.name()
    if isinstance(target, torch._ops.OpOverload):
        return target.name()
    return getattr(target, "__name__", str(target))


def _check_graph(gm: torch.fx.GraphModule, *, allow_loops_up_to: int,
                 path: str = "") -> None:
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        target, name = node.target, _op_name(node.target)
        if name == "while_loop":
            raise JashValidationError(
                f"unbounded `while_loop` at {path or '<jash>'} — PNPCoin §3 "
                "requires every loop to have a static bound (req. 5). "
                "Use repro_torch.core.jash.bounded_while.")
        if name in _IO_FORBIDDEN or (
                isinstance(target, torch._ops.OpOverload)
                and target.namespace not in _DETERMINISTIC_NAMESPACES):
            raise JashValidationError(
                f"IO/callback operator `{name}` — jash functions must be "
                "deterministic and must not communicate (§3 req. 2).")
        if isinstance(target, torch._ops.HigherOrderOperator):
            if name not in _ALLOWED_HOPS:
                raise JashValidationError(
                    f"higher-order operator `{name}` at {path or '<jash>'} "
                    "is not allowed in a jash")
            if name == "scan":
                length = int(node.args[2][0].meta["val"].shape[0])
                if length > allow_loops_up_to:
                    raise JashValidationError(
                        f"scan length {length} exceeds the RA loop bound "
                        f"s={allow_loops_up_to} (§3 req. 5)")
        for arg in _flat_nodes(node.args):
            if arg.op == "get_attr":
                sub = getattr(gm, arg.target)
                if isinstance(sub, torch.fx.GraphModule):
                    _check_graph(sub, allow_loops_up_to=allow_loops_up_to,
                                 path=f"{path}/{name}")


def _flat_nodes(args) -> list:
    out = []
    for a in args:
        if isinstance(a, torch.fx.Node):
            out.append(a)
        elif isinstance(a, (tuple, list)):
            out.extend(_flat_nodes(a))
    return out


class _JashModule(torch.nn.Module):
    def __init__(self, fn: Callable) -> None:
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


@dataclasses.dataclass
class Jash:
    """A validated jash: ``fn(args: int64[n]) -> words[n, ...]`` plus meta."""
    name: str
    fn: Callable
    meta: JashMeta
    example_args: Tuple = ()

    def validate(self, *example_args, loop_bound: int = 1 << 20
                 ) -> torch.export.ExportedProgram:
        """§3.3 automated review, steps 1-2: export (the compile check)
        and the bounded-complexity walk of the exported graph."""
        args = example_args or self.example_args
        program = torch.export.export(_JashModule(self.fn), tuple(args))
        _check_graph(program.graph_module, allow_loops_up_to=loop_bound)
        return program

    def source_id(self) -> str:
        """Unique ID under which the jash circulates on the fileshare (§4)."""
        h = hashlib.sha256()
        h.update(self.name.encode())
        h.update(repr(self.meta).encode())
        return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# §3.2 — conversion of unbounded loops to bounded complexity
# ---------------------------------------------------------------------------


def bounded_while(cond: Callable, body: Callable, init: Any, *,
                  max_steps: int) -> Tuple[Any, torch.Tensor]:
    """The paper's Fig.2 -> Fig.3 transform: run ``body`` while ``cond``
    holds, for at most ``max_steps`` iterations, element-wise over the
    batch. ``init`` is a tensor or a tuple of tensors; ``cond`` and
    ``body`` take and return the same structure. Returns
    ``(final_state, terminated)``, where ``terminated`` is False where the
    bound was hit first — the §4 "did not terminate" result code.

    Run eagerly it is a Python loop of ``max_steps`` steps. Under
    ``torch.export`` it is one ``scan`` of length ``max_steps``, so the
    exported graph stays small and the validator reads the bound off the
    scan instead of off an unrolled loop."""
    single = isinstance(init, torch.Tensor)
    pack = (lambda s: s[0]) if single else (lambda s: tuple(s))
    unpack = (lambda s: (s,)) if single else tuple

    def step(state, done):
        active = ~done & cond(pack(state))
        new = unpack(body(pack(state)))
        state = tuple(torch.where(active, b, a) for a, b in zip(state, new))
        return state, done | ~cond(pack(state))

    state = unpack(init)
    done = torch.zeros_like(cond(pack(state)), dtype=torch.bool)
    if torch.compiler.is_exporting():
        def combine(carry, _):
            *st, d = carry
            st, d = step(tuple(st), d)
            return (*st, d), torch.zeros((), dtype=torch.int8,
                                         device=d.device)

        steps = torch.zeros(max_steps, dtype=torch.int8, device=done.device)
        (*state, done), _ = scan(combine, (*state, done), steps)
        state = tuple(state)
    else:
        for _ in range(max_steps):
            state, done = step(state, done)
    return pack(state), done


def collatz_jash(max_steps: int = 1024) -> Jash:
    """The paper's own worked example (§3.2 Figs. 2-3): bounded Collatz.
    res = number of steps to reach 1, or max_steps if not terminated.
    ``3b + 1`` wraps modulo 2**32, as the reference's uint32 does."""

    def fn(args: torch.Tensor) -> torch.Tensor:
        b0 = torch.clamp(args & MASK32, min=1)

        def cond(s):
            return s[0] != 1

        def body(s):
            b, n = s
            nxt = torch.where(b & 1 == 0, b >> 1, (3 * b + 1) & MASK32)
            return nxt, n + 1

        (_, n), terminated = bounded_while(
            cond, body, (b0, torch.zeros_like(b0)), max_steps=max_steps)
        return torch.where(terminated, n, torch.full_like(n, max_steps))

    meta = JashMeta(arg_bits=16, res_bits=32,
                    description="Collatz stopping time (paper Fig. 2-3)")
    return Jash("collatz", fn, meta,
                example_args=(torch.tensor([27], dtype=torch.int64),))
