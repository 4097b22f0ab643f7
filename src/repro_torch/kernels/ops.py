"""Public kernel entries: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor. There is no fallback from one to the
other: a CUDA tensor launches the kernel or raises."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.sha256 import sha256_rows_cuda


def _cpu_only(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {t.device}")


def sha256_digests(msg: torch.Tensor, *, raw: bool = True,
                   bswap: bool = False
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(N, W) words -> (digest of the words, digest of the byte-swapped
    words), each (N, 8) or None where not asked for; one kernel launch on
    the card for both."""
    if msg.is_cuda:
        return sha256_rows_cuda(msg, raw=raw, bswap=bswap)
    _cpu_only("sha256", msg)
    return (ref.sha256_words_ref(msg) if raw else None,
            ref.sha256_words_ref(ref.bswap32(msg)) if bswap else None)


def sha256_words(msg: torch.Tensor, *, bswap: bool = False) -> torch.Tensor:
    """(N, W) words -> (N, 8) digest words; ``bswap`` hashes the
    byte-swapped words (the Merkle leaf convention)."""
    raw, swapped = sha256_digests(msg, raw=not bswap, bswap=bswap)
    return swapped if bswap else raw


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, T, Kv, hd) -> (B, S, H, hd) in q's dtype.
    Softmax attention with scores scaled by 1/sqrt(hd); GQA maps query head
    h to KV head h // (H // Kv)."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal)
    _cpu_only("flash_attention", q)
    return ref.flash_attention_ref(q, k, v, causal=causal)
