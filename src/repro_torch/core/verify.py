"""Result verification: the consensus stand-in. The port of
``repro/core/verify.py``.

``quorum_verify`` re-executes a random fraction of the arg space (the same
numpy ``RandomState`` draw as the reference, so the same samples) and
compares results bit-exactly; one mismatch marks the block invalid.
``verify_inclusion`` checks one (arg, res) pair against the block's Merkle
root. The batched counterparts amortize verification across a chain
segment: ``quorum_verify_batched`` stacks every block's sampled args into
one re-execution per jash function, and ``recompute_roots_batched``
re-commits every root from its raw ``(arg, res)`` arrays on the card (one
SHA-256 launch for the leaf digests, one forest reduction per shape),
with a hashlib spot-check of one block per shape group. When the
spot-check disagrees, every root is recomputed with hashlib, so the
verdict never rests on the device kernel; ``hashlib_fallbacks`` counts how
often that happened.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.executor import FullResult, eval_words
from repro_torch.core.jash import Jash
from repro_torch.core.ledger import (merkle_proof, merkle_root,
                                     verify_merkle_proof)
from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels.merkle import merkle_roots_from_digests
from repro_torch.kernels.ops import sha256_words

# Times ``recompute_roots_batched``'s hashlib spot-check disagreed with the
# device roots (any non-zero value means a device kernel is wrong).
hashlib_fallbacks = 0


@dataclasses.dataclass(frozen=True)
class VerifyReport:
    n_checked: int
    n_mismatch: int
    ok: bool
    mismatched_args: tuple = ()


def _sample_indices(n: int, *, fraction: float, seed: int,
                    min_checks: int) -> np.ndarray:
    """The quorum sample for one block — shared by the scalar and
    batched paths so their accept/reject decisions are bit-identical."""
    rng = np.random.RandomState(seed)
    k = max(min_checks, int(n * fraction))
    return rng.choice(n, size=min(k, n), replace=False)


def _recompute(jash: Jash, args: np.ndarray, device: torch.device
               ) -> np.ndarray:
    t = torch.from_numpy(np.asarray(args, np.uint32).astype(np.int64))
    return eval_words(jash, t.to(device)).cpu().numpy().astype(np.uint32)


def quorum_verify(jash: Jash, full: FullResult, *, fraction: float = 0.05,
                  seed: int = 0, min_checks: int = 4,
                  device: DeviceLike = None) -> VerifyReport:
    """Deterministic re-execution of a random subset of args."""
    idx = _sample_indices(len(full.args), fraction=fraction, seed=seed,
                          min_checks=min_checks)
    recomputed = _recompute(jash, full.args[idx], resolve(device))
    mism = [int(full.args[i]) for j, i in enumerate(idx)
            if not np.array_equal(recomputed[j], full.results[i])]
    return VerifyReport(n_checked=len(idx), n_mismatch=len(mism),
                        ok=not mism, mismatched_args=tuple(mism))


def quorum_verify_batched(pairs: Sequence[Tuple[Jash, FullResult]], *,
                          fraction: float = 0.05, seed: int = 0,
                          min_checks: int = 4, device: DeviceLike = None
                          ) -> List[VerifyReport]:
    """``quorum_verify`` over a chain segment, one re-execution per jash
    function. Each block samples exactly the indices its scalar call
    would; reports are bit-identical to per-block ``quorum_verify``."""
    dev = resolve(device)
    samples = [
        _sample_indices(len(full.args), fraction=fraction, seed=seed,
                        min_checks=min_checks)
        for _, full in pairs]
    by_fn: dict = {}
    for b, (jash, _) in enumerate(pairs):
        by_fn.setdefault(jash.fn, []).append((b, jash))

    recomputed: List[Optional[np.ndarray]] = [None] * len(pairs)
    for members in by_fn.values():
        stacked = np.concatenate(
            [pairs[b][1].args[samples[b]] for b, _ in members])
        out = _recompute(members[0][1], stacked, dev)
        off = 0
        for b, _ in members:
            k = len(samples[b])
            recomputed[b] = out[off:off + k]
            off += k

    reports = []
    for b, (_, full) in enumerate(pairs):
        idx, out = samples[b], recomputed[b]
        expect = full.results[idx]      # same indexing as the scalar path
        bad = ~(out.reshape(len(idx), -1) == expect.reshape(len(idx), -1)
                ).all(axis=1)
        mism = tuple(int(full.args[i]) for i in idx[bad])
        reports.append(VerifyReport(n_checked=len(idx),
                                    n_mismatch=len(mism), ok=not mism,
                                    mismatched_args=mism))
    return reports


def recompute_roots_batched(fulls: Sequence[FullResult], *, seed: int = 0,
                            device: DeviceLike = None) -> List[str]:
    """Independent Merkle-root re-commitment for a segment of blocks.

    Re-derives each block's root from its raw ``(arg, res)`` arrays —
    never trusting the evidence ``leaf_digests`` — with one SHA-256 launch
    (byte-swapped words only) and one forest reduction per distinct block
    shape. One seeded-random block per shape group is re-committed with
    ``hashlib`` too; a mismatch there means the device kernels disagree
    with the reference, and *every* root is then recomputed with
    ``hashlib``."""
    global hashlib_fallbacks
    if not fulls:
        return []
    dev = resolve(device)
    packed = [full.packed_words() for full in fulls]
    by_shape: dict = {}
    for b, words in enumerate(packed):
        by_shape.setdefault(words.shape, []).append(b)

    roots: List[Optional[str]] = [None] * len(fulls)
    for shape, blocks in by_shape.items():
        words = np.stack([packed[b] for b in blocks])
        flat = torch.from_numpy(
            words.reshape(-1, shape[1]).astype(np.int64)).to(dev)
        digests = sha256_words(flat, bswap=True).cpu().numpy() \
            .astype(np.uint32).reshape(len(blocks), shape[0], 8)
        for b, root in zip(blocks, merkle_roots_from_digests(digests,
                                                             device=dev)):
            roots[b] = root

    # hashlib spot-check of one root per shape group: each group took its
    # own device shapes, so one probe per group keeps the reference path
    # live on every shape used in this call
    rng = np.random.RandomState(seed)
    for blocks in by_shape.values():
        probe = blocks[int(rng.randint(len(blocks)))]
        reference = merkle_root(list(fulls[probe].merkle_leaves),
                                backend="hashlib")
        if reference != roots[probe]:        # a device kernel is wrong:
            hashlib_fallbacks += 1
            return [merkle_root(list(f.merkle_leaves), backend="hashlib")
                    for f in fulls]          # fall back to the reference
    return roots


def verify_inclusion(full: FullResult, arg_index: int, root: str) -> bool:
    """Merkle inclusion proof for one submitted result.

    Raises ``IndexError`` for an index outside the block's arg space."""
    if not 0 <= arg_index < len(full.args):
        raise IndexError(
            f"arg_index {arg_index} out of range for a block of "
            f"{len(full.args)} results")
    leaves = list(full.merkle_leaves)
    proof = merkle_proof(leaves, arg_index)
    return verify_merkle_proof(leaves[arg_index], proof, root)
