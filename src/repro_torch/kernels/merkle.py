"""Bitcoin-style Merkle trees (odd levels duplicate their last node) with
the wide levels reduced on the card.

The leaf digests go to the device once, in the reference's words-major
layout: 8 rows of width n, one row per digest word, or (8, B, n) for a
forest of B same-width trees. Each level is one launch of the hand-written
kernel in ``csrc/merkle.cu`` (one thread per parent). Levels reduce until
the width is at most ``_CUTOVER``, and ``hashlib`` finishes the narrow top
on the host, as ``repro/kernels/merkle.py`` does. Roots, levels and proofs
are bit-identical to the reference and to ``core.ledger``'s hashlib tree.

Word convention: SHA-256 serializes words big-endian and digests are
big-endian words, so a parent's message is its two children's 16 words.
``bswap32`` turns little-endian word buffers (the executor's leaves) into
that convention.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import native
from repro_torch.kernels.ops import sha256_words
from repro_torch.kernels.ref import _K, bswap32, sha256_words_ref

# The reference's cutover: levels at most this wide finish on the host.
_CUTOVER = 64

# Kernel launches since the last reset; only the launch below adds to it.
launches = 0


# ---------------------------------------------------------------------------
# packing: bytes <-> big-endian word arrays
# ---------------------------------------------------------------------------


def pack_leaves(leaves: Sequence[bytes]) -> Optional[np.ndarray]:
    """Uniform word-aligned leaves -> (N, L//4) big-endian uint32 words.

    Returns None when the leaf set is ragged or not 4-byte aligned (the
    caller then hashes the leaf level with hashlib)."""
    if not leaves:
        return None
    L = len(leaves[0])
    if L == 0 or L % 4 or any(len(x) != L for x in leaves):
        return None
    buf = b"".join(leaves)
    return np.frombuffer(buf, dtype=">u4").reshape(len(leaves), L // 4) \
        .astype(np.uint32)


def pack_digests(digests: Sequence[bytes]) -> np.ndarray:
    """32-byte digests -> (N, 8) uint32 word rows."""
    return np.frombuffer(b"".join(digests), dtype=">u4").reshape(-1, 8) \
        .astype(np.uint32)


def words_to_hex(words: np.ndarray) -> str:
    """(8,) uint32 digest words -> hex string (big-endian serialization)."""
    return np.asarray(words, np.uint32).astype(">u4").tobytes().hex()


def _words_to_digest_list(level: np.ndarray) -> List[bytes]:
    buf = np.ascontiguousarray(level.astype(">u4")).tobytes()
    return [buf[i:i + 32] for i in range(0, len(buf), 32)]


# ---------------------------------------------------------------------------
# one level: SHA-256 of each pair of children
# ---------------------------------------------------------------------------


def _pad_block_schedule() -> List[int]:
    """Message schedule of the constant padding block of a 64-byte msg."""
    w = [0x80000000] + [0] * 14 + [512]

    def rr(x, n):
        return ((x >> n) | (x << (32 - n))) & 0xFFFFFFFF

    for t in range(16, 64):
        s0 = rr(w[t - 15], 7) ^ rr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = rr(w[t - 2], 17) ^ rr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & 0xFFFFFFFF)
    return w


# K[t] + W[t] folded into one constant per round of the padding block; the
# CUDA kernel holds the same table (`kKW` in csrc/merkle.cu).
_KW = tuple((int(k) + w) & 0xFFFFFFFF
            for k, w in zip(_K, _pad_block_schedule()))


def _node_hash_ref(rows: torch.Tensor) -> torch.Tensor:
    """Plain version of one level: (8, B, w) words -> (8, B, ceil(w/2)),
    pairing within each tree and duplicating an odd level's last node."""
    _, B, w = rows.shape
    if w % 2:
        rows = torch.cat([rows, rows[:, :, -1:]], dim=2)
    pairs = torch.cat([rows[:, :, 0::2], rows[:, :, 1::2]], dim=0)
    msgs = pairs.reshape(16, -1).T                 # (B * w/2, 16)
    return sha256_words_ref(msgs).T.reshape(8, B, -1)


def _merkle_level_cuda(rows: torch.Tensor) -> torch.Tensor:
    global launches
    native.check_cuda_words("merkle_level", rows, 3)
    if rows.shape[0] != 8 or rows.shape[2] < 1:
        raise ValueError(f"merkle_level: expected (8, B, w >= 1) words, "
                         f"got {tuple(rows.shape)}")
    _, B, w = rows.shape
    r32 = native.to_i32(rows)
    out = torch.empty((8, B, (w + 1) // 2), dtype=torch.int32,
                      device=rows.device)
    if B:
        with torch.cuda.device(rows.device):
            rc = native.library().pnp_merkle_level(
                r32.data_ptr(), B, w, out.data_ptr(), native.stream_of(rows))
        launches += 1
        native.check_launch("merkle_level", rc)
    return native.from_i32(out)


def merkle_level(rows: torch.Tensor) -> torch.Tensor:
    """One level of B trees: (8, B, w) words -> (8, B, ceil(w/2)). The CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if rows.is_cuda:
        return _merkle_level_cuda(rows)
    if rows.device.type != "cpu":
        raise ValueError(f"merkle_level: unsupported device {rows.device}")
    return _node_hash_ref(rows)


def _reduce(rows: torch.Tensor, keep_levels: bool) -> List[torch.Tensor]:
    """(8, B, w) words -> the levels down to width <= ``_CUTOVER``: every
    level with ``keep_levels``, else only the last."""
    levels = []
    while rows.shape[2] > _CUTOVER:
        if keep_levels:
            levels.append(rows)
        rows = merkle_level(rows)
    levels.append(rows)
    return levels


def _to_rows(digests: np.ndarray, device: torch.device) -> torch.Tensor:
    """(B, N, 8) uint32 words -> (8, B, N) int64 words on ``device``."""
    d = np.ascontiguousarray(np.asarray(digests, np.uint32)
                             .transpose(2, 0, 1)).astype(np.int64)
    return torch.from_numpy(d).to(device)


def _to_host(rows: torch.Tensor) -> np.ndarray:
    """(8, B, w) words -> (B, w, 8) uint32."""
    return rows.permute(1, 2, 0).cpu().numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# the hybrid tree
# ---------------------------------------------------------------------------


def _host_levels(digests: List[bytes]) -> List[List[bytes]]:
    """Reference tail: hashlib over a pre-joined buffer, one level a pass."""
    levels, level = [], list(digests)
    sha = hashlib.sha256
    while len(level) > 1:
        if len(level) % 2:
            level.append(level[-1])
        levels.append(level)
        buf = b"".join(level)
        level = [sha(buf[i:i + 64]).digest() for i in range(0, len(buf), 64)]
    levels.append(level)
    return levels


def _hybrid_levels(digests: np.ndarray, *, keep_levels: bool = True,
                   device: DeviceLike = None
                   ) -> Tuple[List[np.ndarray], str]:
    """(N, 8) leaf digests -> (padded levels as (m, 8) arrays, root hex)."""
    n = int(digests.shape[0])
    if n == 0:
        return [], hashlib.sha256(b"").hexdigest()
    device_levels: List[np.ndarray] = []
    if n > _CUTOVER:
        out = [_to_host(lv)[0] for lv in
               _reduce(_to_rows(digests[None], resolve(device)), keep_levels)]
        # proofs index odd levels with their last node duplicated
        device_levels = [np.concatenate([lv, lv[-1:]]) if len(lv) % 2 else lv
                         for lv in out[:-1]]
        boundary = _words_to_digest_list(out[-1])
    else:
        boundary = _words_to_digest_list(np.asarray(digests, np.uint32))
    host = _host_levels(boundary)
    levels = device_levels + [pack_digests(lv) for lv in host]
    return levels, host[-1][0].hex()


def leaf_digests_device(packed: np.ndarray, *,
                        device: DeviceLike = None) -> torch.Tensor:
    """(N, W) big-endian word leaves -> (N, 8) leaf digests on device."""
    words = torch.from_numpy(np.asarray(packed, np.uint32).astype(np.int64))
    return sha256_words(words.to(resolve(device)))


def _digests_for(leaves: Sequence[bytes], device: DeviceLike) -> np.ndarray:
    packed = pack_leaves(leaves)
    if packed is not None and len(leaves) >= _CUTOVER:
        return leaf_digests_device(packed, device=device).cpu().numpy() \
            .astype(np.uint32)
    return pack_digests([hashlib.sha256(x).digest() for x in leaves])


def merkle_root_from_digests(digests: np.ndarray, *,
                             device: DeviceLike = None) -> str:
    """(N, 8) uint32 leaf-digest words -> root hex."""
    return _hybrid_levels(np.asarray(digests), keep_levels=False,
                          device=device)[1]


def merkle_roots_from_digests(digests: np.ndarray, *,
                              device: DeviceLike = None) -> List[str]:
    """(B, N, 8) uint32 leaf-digest words -> B root hex strings.

    The B trees are reduced together, pairing within each tree's own
    lanes, so each root is bit-identical to ``merkle_root_from_digests``
    of that tree alone."""
    d = np.asarray(digests, np.uint32)
    if d.ndim != 3 or d.shape[-1] != 8:
        raise ValueError(f"expected (B, N, 8) digest words, got {d.shape}")
    B, n, _ = d.shape
    if B == 0:
        return []
    if n == 0:
        return [hashlib.sha256(b"").hexdigest()] * B
    if n > _CUTOVER:
        d = _to_host(_reduce(_to_rows(d, resolve(device)), False)[-1])
    return [_host_levels(_words_to_digest_list(d[b]))[-1][0].hex()
            for b in range(B)]


def merkle_root_device(leaves: Sequence[bytes], *,
                       device: DeviceLike = None) -> str:
    """Device analogue of ``core.ledger.merkle_root`` — bit-identical."""
    if not leaves:
        return hashlib.sha256(b"").hexdigest()
    return merkle_root_from_digests(_digests_for(leaves, device),
                                    device=device)


def merkle_levels_device(leaves: Sequence[bytes], *,
                         device: DeviceLike = None) -> List[np.ndarray]:
    """All (odd-padded) tree levels, leaf digests first, root level last."""
    return _hybrid_levels(_digests_for(leaves, device), device=device)[0]


def merkle_proof_device(leaves: Sequence[bytes], index: int, *,
                        device: DeviceLike = None) -> List[dict]:
    """Inclusion proof in the ``core.ledger`` format, tree built on device.

    Raises ``IndexError`` for an index outside the leaf set — a proof
    over a duplicated odd-level pad node would verify against the root
    without corresponding to any submitted result."""
    if not 0 <= index < len(leaves):
        raise IndexError(
            f"proof index {index} out of range for {len(leaves)} leaves")
    levels = merkle_levels_device(leaves, device=device)
    proof = []
    idx = index
    for level in levels[:-1]:
        sib = idx ^ 1
        proof.append({"side": "left" if sib < idx else "right",
                      "hash": words_to_hex(level[sib])})
        idx //= 2
    return proof
