"""Public SHA-256 entry: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor. There is no fallback from one to the
other: a CUDA tensor launches the kernel or raises."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.sha256 import sha256_rows_cuda


def sha256_digests(msg: torch.Tensor, *, raw: bool = True,
                   bswap: bool = False
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(N, W) words -> (digest of the words, digest of the byte-swapped
    words), each (N, 8) or None where not asked for; one kernel launch on
    the card for both."""
    if msg.is_cuda:
        return sha256_rows_cuda(msg, raw=raw, bswap=bswap)
    if msg.device.type != "cpu":
        raise ValueError(f"sha256: unsupported device {msg.device}")
    return (ref.sha256_words_ref(msg) if raw else None,
            ref.sha256_words_ref(ref.bswap32(msg)) if bswap else None)


def sha256_words(msg: torch.Tensor, *, bswap: bool = False) -> torch.Tensor:
    """(N, W) words -> (N, 8) digest words; ``bswap`` hashes the
    byte-swapped words (the Merkle leaf convention)."""
    raw, swapped = sha256_digests(msg, raw=not bswap, bswap=bswap)
    return swapped if bswap else raw
