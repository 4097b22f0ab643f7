"""Execution engines: how miners evaluate a published jash over its
argument space (PNPCoin §3.3). The port of ``repro/core/executor.py``.

**full** mode — "Full execution returns the output of every valid input":
the arg space [0, n_args) is processed in chunks of at most
``DEFAULT_CHUNK`` args. For each chunk the jash runs on the device over
the chunk's args, and one launch of the SHA-256 kernel reads the
``arg || res`` rows once and writes both the submission hash
``sha256(arg || res)`` and the Merkle leaf digest (the same words
byte-swapped, i.e. the little-endian leaf bytes). The block commits to the
Merkle root over the leaf digests (``kernels/merkle.py``).

**optimal** mode — "accepts the lowest res, the result with most leading
zeros": each miner lane reduces its contiguous slice to the lexicographic
(res, arg) minimum (min, tie-masked min, first index — no sort), and a
cross-lane pass of the same kind picks the winner lane.

**lanes** — ``lanes=k`` emulates a k-miner fleet on one card. In full mode
lane ``l`` is credited with the args ``≡ l (mod k)`` (``miner_of = arg %
lanes``); in optimal mode lanes are contiguous slices, which keeps the
global first-occurrence tie-break. Lanes never change the mined bits, so
a verifier replays with ``lanes=1``. One H100 has no miner mesh: ``lanes``
is the only partition.

Results leave the device as numpy arrays with the reference's dtypes
(uint32 words, int32 ``miner_of``), so everything downstream hashes the
same bytes as the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.jash import Jash
from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels.merkle import merkle_root_from_digests
from repro_torch.kernels.native import MASK32
from repro_torch.kernels.ops import sha256_digests

# Default ceiling on args per chunk in full mode: bounds device-resident
# results while keeping each launch large.
DEFAULT_CHUNK = 1 << 16

MAXW = MASK32


@dataclasses.dataclass(frozen=True)
class FullResult:
    args: np.ndarray           # (n,) uint32
    results: np.ndarray        # (n, res_words) uint32
    hashes: np.ndarray         # (n, 8) uint32  sha256(arg || res)
    miner_of: np.ndarray       # (n,) int32 — first submitter per arg
    leaf_digests: np.ndarray   # (n, 8) uint32  sha256(leaf bytes)
    device: Optional[torch.device] = dataclasses.field(
        default=None, repr=False, compare=False)
    _leaves: Optional[Tuple[bytes, ...]] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _packed: Optional[np.ndarray] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def packed_words(self) -> np.ndarray:
        """(n, 1 + res_words) little-endian uint32 message words — each
        row is the ``arg || res`` Merkle-leaf message; ``merkle_leaves``
        is its byte view. Cached."""
        if self._packed is None:
            object.__setattr__(self, "_packed", np.ascontiguousarray(
                np.concatenate([self.args[:, None], self.results],
                               axis=1).astype("<u4")))
        return self._packed

    @property
    def merkle_leaves(self) -> Tuple[bytes, ...]:
        """Leaf byte strings ``arg.tobytes() + res.tobytes()``, sliced
        lazily from one buffer."""
        if self._leaves is None:
            packed = self.packed_words()
            buf = packed.tobytes()
            stride = packed.shape[1] * 4
            leaves = tuple(buf[i * stride:(i + 1) * stride]
                           for i in range(packed.shape[0]))
            object.__setattr__(self, "_leaves", leaves)
        return self._leaves

    def commit_root(self) -> str:
        """Block-commitment Merkle root over the leaf digests (device)."""
        return merkle_root_from_digests(self.leaf_digests, device=self.device)


@dataclasses.dataclass(frozen=True)
class OptimalResult:
    best_arg: int
    best_res: np.ndarray       # (res_words,) uint32
    winner: int                # miner id
    n_evaluated: int


def _as_words(res, n: int) -> torch.Tensor:
    """Canonicalize a jash result (a tensor or a tuple of tensors) to (n,
    words) int64 words, wrapping each value to 32 bits as the reference's
    ``astype(uint32)`` does."""
    leaves = res if isinstance(res, (tuple, list)) else (res,)
    flat = [x.to(torch.int64).reshape(n, -1) & MASK32 for x in leaves]
    return torch.cat(flat, dim=1) if len(flat) > 1 else flat[0]


def eval_words(jash: Jash, args: torch.Tensor) -> torch.Tensor:
    """The jash over a 1-D batch of args -> (n, words) int64 words."""
    return _as_words(jash.fn(args), args.shape[0])


def _to_u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.uint32)


def run_full(jash: Jash, *, chunk_size: Optional[int] = None,
             lanes: int = 1, device: DeviceLike = None) -> FullResult:
    """Evaluate every valid arg (§3.3 full mode), ``chunk_size`` args per
    chunk (None = whole space, capped at ``DEFAULT_CHUNK``). ``lanes``
    partitions the arg space over that many miner lanes (``miner_of =
    arg % lanes``); results are bit-identical to ``lanes=1``."""
    if chunk_size is not None and chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    if lanes < 1:
        raise ValueError(f"lanes must be >= 1, got {lanes}")
    dev = resolve(device)
    n = jash.meta.n_args
    n_miners = lanes = min(lanes, n)

    chunk = min(n, chunk_size or DEFAULT_CHUNK)
    chunk += -chunk % n_miners                 # chunk divisible by miners
    n_chunks = -(-n // chunk)
    # the last chunk is right-sized (rounded up to the miner count) so a
    # ragged tail doesn't evaluate and hash a whole chunk of discarded args
    tail = n - (n_chunks - 1) * chunk
    tail += -tail % n_miners

    res_parts, hash_parts, leaf_parts = [], [], []
    for c in range(n_chunks):
        width = chunk if c < n_chunks - 1 else tail
        args_c = torch.arange(c * chunk, c * chunk + width,
                              dtype=torch.int64, device=dev)
        res = eval_words(jash, args_c)
        msg = torch.cat([args_c[:, None], res], dim=1)
        # one launch: sha256(arg || res) and the Merkle leaf digest
        # sha256(bswap32(arg || res)) from one read of the rows
        hashes, leaves = sha256_digests(msg, raw=True, bswap=True)
        res_parts.append(_to_u32(res))
        hash_parts.append(_to_u32(hashes))
        leaf_parts.append(_to_u32(leaves))

    def cat(parts):
        return parts[0][:n] if len(parts) == 1 \
            else np.concatenate(parts, axis=0)[:n]

    args_np = np.arange(n, dtype=np.uint32)
    miner_of = (args_np % n_miners).astype(np.int32) if n_miners > 1 \
        else np.zeros(n, np.int32)
    return FullResult(args=args_np, results=cat(res_parts),
                      hashes=cat(hash_parts), miner_of=miner_of,
                      leaf_digests=cat(leaf_parts), device=dev)


def _lex_argmin(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """Index of the lexicographic minimum of (w0, w1) along the last dim —
    first occurrence, three reductions, no sort."""
    tie = w0 == w0.min(dim=-1, keepdim=True).values
    m1 = torch.where(tie, w1, MAXW).min(dim=-1, keepdim=True).values
    # `tie & (w1 == m1)` keeps the edge case where every tied w1 is MAXW
    # from escaping the tie set (a plain argmin over the masked w1 would)
    return torch.argmax((tie & (w1 == m1)).to(torch.int32), dim=-1)


def run_optimal(jash: Jash, *, lanes: int = 1,
                device: DeviceLike = None) -> OptimalResult:
    """Distributed argmin of res (§3.3 optimal mode).  The res ordering is
    lexicographic on words == 'most leading zeros' for hash-like outputs.

    ``lanes`` partitions the arg space into that many contiguous miner
    lanes; ``winner`` is the lane holding the block minimum.  ``(best_arg,
    best_res)`` is independent of the lane count."""
    if lanes < 1:
        raise ValueError(f"lanes must be >= 1, got {lanes}")
    dev = resolve(device)
    n = jash.meta.n_args
    lanes = min(lanes, n)
    args = torch.arange(n + (-n % lanes), dtype=torch.int64, device=dev)
    valid = args < n
    res = eval_words(jash, args)
    w0 = torch.where(valid, res[:, 0], MAXW)
    w1 = res[:, 1] if res.shape[1] > 1 else torch.zeros_like(w0)
    w1 = torch.where(valid, w1, MAXW)
    per_lane = len(args) // lanes
    rows = _lex_argmin(w0.view(lanes, per_lane), w1.view(lanes, per_lane)) \
        + torch.arange(lanes, device=dev) * per_lane
    winner = _lex_argmin(w0[rows], w1[rows])
    best = rows[winner]
    return OptimalResult(best_arg=int(args[best]),
                         best_res=_to_u32(res[best]).reshape(-1),
                         winner=int(winner), n_evaluated=n)
