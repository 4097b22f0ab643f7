"""Bitcoin-style Merkle trees (odd levels duplicate their last node) with
the wide levels reduced on the card.

The leaf digests go to the device once, as they come: (N, 8) uint32 words
a tree, or (B, N, 8) for a forest of B same-width trees, viewed as int32
(no transpose, no widening). One launch of the hand-written kernel in
``csrc/merkle.cu`` reduces every level of every tree until the width is at
most ``_CUTOVER``, and ``hashlib`` finishes the narrow top on the host, as
``repro/kernels/merkle.py`` does. Roots, levels and proofs are
bit-identical to the reference and to ``core.ledger``'s hashlib tree. The
layout (row-major, where the reference's is words-major) is internal to
this module.

Word convention: SHA-256 serializes words big-endian and digests are
big-endian words, so a parent's message is its two children's 16 words.
``bswap32`` turns little-endian word buffers (the executor's leaves) into
that convention.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import native
from repro_torch.kernels.native import MASK32
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
# the wide levels: SHA-256 of each pair of children, level after level
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


def _node_hash_ref(level: torch.Tensor) -> torch.Tensor:
    """Plain version of one level: (B, w, 8) int64 words -> (B, ceil(w/2),
    8), pairing within each tree and duplicating an odd level's last node.
    A parent's message is its two children's rows, one after the other."""
    B, w, _ = level.shape
    if w % 2:
        level = torch.cat([level, level[:, -1:]], dim=1)
    return sha256_words_ref(level.reshape(-1, 16)).reshape(B, -1, 8)


def _widths(n: int) -> List[int]:
    """Widths of the levels a reduction of ``n`` leaves computes: level l
    is ceil(n / 2**l) wide, down to the first at most ``_CUTOVER``."""
    widths, w = [], n
    while w > _CUTOVER:
        w = (w + 1) // 2
        widths.append(w)
    return widths


def _i32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) -> int32 holding the same 32 bits."""
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def _reduce_ref(digests: torch.Tensor, keep_levels: bool
                ) -> List[torch.Tensor]:
    """Plain version of ``merkle_reduce``, level by level."""
    level = digests.to(torch.int64) & MASK32
    levels = []
    while level.shape[1] > _CUTOVER:
        level = _node_hash_ref(level)
        levels.append(level)
    return [_i32(lv) for lv in (levels if keep_levels else levels[-1:])]


# The reduction kernel's workspace, one per card and stream: its tickets
# (zero before a launch; every launch leaves them zero) and its scratch
# nodes (the levels where its units meet), in two buffers.
_workspace: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace_for(digests: torch.Tensor, B: int, n: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    lib = native.library()
    need = [lib.pnp_merkle_workspace_words(B, n, _CUTOVER, c) for c in (1, 0)]
    key = (digests.device.index, native.stream_of(digests))
    have = _workspace.get(key)
    if have is None or any(t.numel() < w for t, w in zip(have, need)):
        old = have or (None, None)
        have = tuple(t if t is not None and t.numel() >= w else
                     torch.zeros(max(w, 1), dtype=torch.int32,
                                 device=digests.device)
                     for t, w in zip(old, need))
        _workspace[key] = have
    return have


def _check_digests(name: str, digests: torch.Tensor) -> None:
    if digests.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 words (uint32 bits), got "
                        f"{digests.dtype}")
    if digests.dim() != 3 or digests.shape[2] != 8:
        raise ValueError(f"{name}: expected (B, n, 8) digest words, got "
                         f"{tuple(digests.shape)}")
    if not digests.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _merkle_reduce_cuda(digests: torch.Tensor, keep_levels: bool
                        ) -> List[torch.Tensor]:
    global launches
    _check_digests("merkle_reduce", digests)
    B, n, _ = digests.shape
    widths = _widths(n)
    if not widths:
        return []
    sizes = [B * w * 8 for w in (widths if keep_levels else widths[-1:])]
    out = torch.empty(sum(sizes), dtype=torch.int32, device=digests.device)
    levels = [lv.view(B, -1, 8) for lv in out.split(sizes)]
    if not B:
        return levels
    # the host's time counts here: the C entry makes the card current
    # itself, with no device context here
    counters, nodes = _workspace_for(digests, B, n)
    rc = native.library().pnp_merkle_reduce(
        digests.data_ptr(), B, n, _CUTOVER, int(keep_levels), out.data_ptr(),
        counters.data_ptr(), nodes.data_ptr(), digests.device.index,
        native.stream_of(digests))
    native.check_launch("merkle_reduce", rc)
    launches += 1
    return levels


def merkle_reduce(digests: torch.Tensor, *, keep_levels: bool = False
                  ) -> List[torch.Tensor]:
    """The wide levels of B same-width trees: (B, n, 8) int32 words
    (uint32 bits, one leaf digest a row) -> the levels down to the first at
    most ``_CUTOVER`` wide, each (B, w, 8) int32: every level after the
    leaves with ``keep_levels``, else only that last one; none where n <=
    ``_CUTOVER``. One launch of the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if digests.is_cuda:
        return _merkle_reduce_cuda(digests, keep_levels)
    if digests.device.type != "cpu":
        raise ValueError(f"merkle_reduce: unsupported device "
                         f"{digests.device}")
    _check_digests("merkle_reduce", digests)
    return _reduce_ref(digests, keep_levels)


def _to_device(digests: np.ndarray, device: torch.device) -> torch.Tensor:
    """(B, N, 8) uint32 words -> the same bits as int32 on ``device``."""
    d = np.ascontiguousarray(digests, dtype=np.uint32)
    return torch.from_numpy(d.view(np.int32)).to(device)


def _to_host(level: torch.Tensor) -> np.ndarray:
    """(B, w, 8) int32 words -> (B, w, 8) uint32."""
    return level.cpu().numpy().view(np.uint32)


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
        out = [_to_host(lv)[0] for lv in merkle_reduce(
            _to_device(digests[None], resolve(device)),
            keep_levels=keep_levels)]
        if keep_levels:
            out.insert(0, np.asarray(digests, np.uint32))
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
        d = _to_host(merkle_reduce(_to_device(d, resolve(device)))[-1])
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
