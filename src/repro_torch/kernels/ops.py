"""Public kernel entries: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor. There is no fallback from one to the
other: a CUDA tensor launches the kernel or raises.

With grad on, a CUDA tensor that requires grad goes through the kernel's
autograd Function (``FlashAttention``, ``DecayScan``, ``WKV6``: the forward
kernel and a hand-written backward kernel); on the CPU autograd
differentiates the plain version (for the two recurrences, their few-op
forms, ``ref.decay_scan_doubling`` and ``ref.wkv6_chunked``; the
sequential loops stay the kernels' twins). The recurrences' start states (``h0``,
``s0``) take no gradient on either device: one that requires grad
raises."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decay_scan import DecayScan, decay_scan_cuda
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention_cuda)
from repro_torch.kernels.sha256 import sha256_rows_cuda
from repro_torch.kernels.wkv6 import WKV6, wkv6_cuda


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
                    causal: bool, window: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, T, Kv, hd) -> (B, S, H, hd) in q's dtype.
    Softmax attention with scores scaled by 1/sqrt(hd); GQA maps query head
    h to KV head h // (H // Kv); ``window > 0`` lets query s see only keys
    t > s - window.

    On the card, when grad mode is on and q, k or v requires grad, the
    training Function (the forward instance that saves the row log-sum-exp,
    and the hand-written backward) runs; otherwise the serving kernel. On
    the CPU autograd differentiates the plain version."""
    if q.is_cuda:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, window)
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    _cpu_only("flash_attention", q)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _no_start_grad(name: str, arg: str, t: Optional[torch.Tensor]) -> None:
    if t is not None and torch.is_grad_enabled() and t.requires_grad:
        raise NotImplementedError(
            f"{name}: {arg} requires grad; the backward kernel gives no "
            f"gradient of the start state (no training path needs one)")


def _decay_scan_card(a, b, h0):
    if _wants_grad(a, b):
        return DecayScan.apply(a, b, h0)
    return decay_scan_cuda(a, b, h0)


def _wkv6_card(r, k, v, w, u, s0):
    if _wants_grad(r, k, v, w, u):
        return WKV6.apply(r, k, v, w, u, s0)
    return wkv6_cuda(r, k, v, w, u, s0)


def _decay_scan_plain(a, b, h0):
    h = ref.decay_scan_doubling(a, b, h0)
    if a.shape[1]:
        return h, h[:, -1]
    return h, (a.new_zeros((a.shape[0], a.shape[2])) if h0 is None
               else h0.float().clone())


def decay_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None,
               seq_chunk: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + b_t. a, b: (B, S, C); h0: (B, C) or None (zeros).
    Returns (h, h_last). By default the whole sequence is one piece; with
    ``seq_chunk`` it runs in pieces of that many steps, h carried from one
    to the next (the reference's contract). On the card each piece is one
    kernel launch, float32 only; with grad on, the backward is one launch
    of ``csrc/decay_scan_bwd.cu`` a piece. ``h0`` takes no gradient (one
    that requires grad raises, as does a later piece's under grad)."""
    if a.is_cuda:
        scan = _decay_scan_card
    else:
        _cpu_only("decay_scan", a)
        scan = _decay_scan_plain
    S = a.shape[1]
    _no_start_grad("decay_scan", "h0", h0)
    if seq_chunk is None or S <= seq_chunk:
        return scan(a, b, h0)
    outs, h = [], h0
    for s0 in range(0, S, seq_chunk):
        piece = slice(s0, min(s0 + seq_chunk, S))
        _no_start_grad("decay_scan", "h0 (the piece before's h_last)", h)
        o, h = scan(a[:, piece].contiguous(), b[:, piece].contiguous(), h)
        outs.append(o)
    return torch.cat(outs, dim=1), h


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: Optional[torch.Tensor] = None,
         seq_chunk: Optional[int] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, w: (B, S, H, K); v: (B, S, H, V); u: (H, K); s0: (B, H, K, V)
    or None (zeros). Returns (out (B, S, H, V), s_final (B, H, K, V)), both
    float32. By default the whole sequence is one piece; with ``seq_chunk``
    it runs in pieces of that many steps, the state carried from one to the
    next (the reference's contract). On the card each piece is one kernel
    launch; with grad on, the backward is one call of ``csrc/wkv6_bwd.cu``
    a piece. ``s0`` takes no gradient (one that requires grad raises, as
    does a later piece's under grad)."""
    if r.is_cuda:
        step = _wkv6_card
    else:
        _cpu_only("wkv6", r)
        step = ref.wkv6_chunked
    S = r.shape[1]
    _no_start_grad("wkv6", "s0", s0)
    if seq_chunk is None or S <= seq_chunk:
        return step(r, k, v, w, u, s0)
    outs, s = [], s0
    for c0 in range(0, S, seq_chunk):
        piece = slice(c0, min(c0 + seq_chunk, S))
        _no_start_grad("wkv6", "s0 (the piece before's s_final)", s)
        o, s = step(*(x[:, piece].contiguous() for x in (r, k, v, w)), u, s)
        outs.append(o)
    return torch.cat(outs, dim=1), s
