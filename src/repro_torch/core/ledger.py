"""Blockchain ledger: blocks, SHA-256 chaining, Merkle trees over results.

The port of ``repro/core/ledger.py``. Header bytes, block hashes, the
genesis hash, roots and proofs are bit-identical to it; the ``"device"``
Merkle backend runs the wide tree levels on the card
(``kernels/merkle.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.device import DeviceLike


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


# The reference's switch point: below it the Python tree, above it the
# device reduction.
_DEVICE_MIN_LEAVES = 256


def _pick(backend: str, n: int) -> str:
    if backend == "auto":
        return "device" if n >= _DEVICE_MIN_LEAVES else "hashlib"
    if backend not in ("device", "hashlib"):
        raise ValueError(f"unknown merkle backend {backend!r} "
                         "(expected 'auto', 'device' or 'hashlib')")
    return backend


def merkle_root(leaves: Sequence[bytes], *, backend: str = "auto",
                device: DeviceLike = None) -> str:
    """Bitcoin-style Merkle tree (duplicate last node on odd levels).

    ``backend="hashlib"`` is the reference implementation; ``"device"``
    reduces the wide levels on ``device``; ``"auto"`` picks by leaf
    count."""
    if _pick(backend, len(leaves)) == "device":
        from repro_torch.kernels.merkle import merkle_root_device
        return merkle_root_device(leaves, device=device)
    if not leaves:
        return sha256_hex(b"")
    level = [hashlib.sha256(x).digest() for x in leaves]
    while len(level) > 1:
        if len(level) % 2:
            level.append(level[-1])
        level = [hashlib.sha256(level[i] + level[i + 1]).digest()
                 for i in range(0, len(level), 2)]
    return level[0].hex()


def merkle_proof(leaves: Sequence[bytes], index: int, *,
                 backend: str = "hashlib",
                 device: DeviceLike = None) -> List[Dict]:
    """Inclusion proof for ``leaves[index]`` -> list of (side, hash).

    Raises ``IndexError`` outside the leaf set on every backend — a
    proof over a duplicated odd-level pad node would verify against
    the root without corresponding to any submitted result."""
    if not 0 <= index < len(leaves):
        raise IndexError(
            f"proof index {index} out of range for {len(leaves)} leaves")
    if _pick(backend, len(leaves)) == "device":
        from repro_torch.kernels.merkle import merkle_proof_device
        return merkle_proof_device(leaves, index, device=device)
    level = [hashlib.sha256(x).digest() for x in leaves]
    proof = []
    idx = index
    while len(level) > 1:
        if len(level) % 2:
            level.append(level[-1])
        sib = idx ^ 1
        proof.append({"side": "left" if sib < idx else "right",
                      "hash": level[sib].hex()})
        level = [hashlib.sha256(level[i] + level[i + 1]).digest()
                 for i in range(0, len(level), 2)]
        idx //= 2
    return proof


def verify_merkle_proof(leaf: bytes, proof: List[Dict], root: str) -> bool:
    h = hashlib.sha256(leaf).digest()
    for step in proof:
        sib = bytes.fromhex(step["hash"])
        h = hashlib.sha256(sib + h if step["side"] == "left" else h + sib
                           ).digest()
    return h.hex() == root


@dataclasses.dataclass(frozen=True)
class Block:
    height: int
    prev_hash: str
    jash_id: str
    mode: str                      # "full" | "optimal" | "classic"
    merkle_root: str
    winner: Optional[int]          # miner id of the optimal submission
    best_res: Optional[str]        # hex of the lowest res (optimal mode)
    n_results: int
    state_digest: str = ""         # PoUW: checkpoint digest chained in
    timestamp: float = 0.0

    def header_bytes(self) -> bytes:
        # the reference's serialization: sort-keys JSON of every field
        # but the timestamp. Fields must be plain Python scalars (a numpy
        # or tensor integer would not serialize the same).
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self) if f.name != "timestamp"}
        return json.dumps(d, sort_keys=True).encode()

    @functools.cached_property
    def block_hash(self) -> str:
        # cached: the frozen dataclass never changes after construction
        # (cached_property writes straight to __dict__)
        return sha256_hex(self.header_bytes())


class Ledger:
    """Append-only chain with integrity verification."""

    GENESIS_HASH = sha256_hex(b"PNPCoin genesis (Kolar 2022)")

    def __init__(self) -> None:
        self.blocks: List[Block] = []

    @property
    def tip_hash(self) -> str:
        return self.blocks[-1].block_hash if self.blocks else self.GENESIS_HASH

    @property
    def height(self) -> int:
        return len(self.blocks)

    def append(self, *, jash_id: str, mode: str, merkle: str,
               winner: Optional[int], best_res: Optional[str],
               n_results: int, state_digest: str = "") -> Block:
        blk = Block(height=self.height, prev_hash=self.tip_hash,
                    jash_id=jash_id, mode=mode, merkle_root=merkle,
                    winner=winner, best_res=best_res, n_results=n_results,
                    state_digest=state_digest, timestamp=time.time())
        self.blocks.append(blk)
        return blk

    def verify_chain(self) -> bool:
        prev = self.GENESIS_HASH
        for i, blk in enumerate(self.blocks):
            if blk.height != i or blk.prev_hash != prev:
                return False
            prev = blk.block_hash
        return True

    def to_json(self) -> str:
        return json.dumps([dataclasses.asdict(b) for b in self.blocks],
                          indent=2)
