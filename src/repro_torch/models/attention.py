"""Attention: the port of ``repro/models/attention.py`` for training and
serving.

GQA + qk-norm + rope. ``self_attention`` (the training forward, no cache;
the encoder's bidirectional attention) and prefill run causal attention,
optionally within a local window, through ``kernels.ops.flash_attention``
(the hand-written kernel on the card, whose backward is a hand-written
kernel too); prefill also fills the KV cache; decode attends one token
over the ring cache in plain PyTorch, as the reference does in plain jnp.
``cross_attention`` (whisper's decoder, the VLM's image layers) sends its
queries and the source's precomputed keys and values to the flash kernel
too, not causal, at every prefill and decode step. One
card has no sharding, so the reference's ``constrain`` calls are dropped.

Unlike the reference, the cache is updated in place: prefill and decode
write their keys and values into the cache tensors they are given and
return that same cache dict, so a decode step copies no cache. Callers
that need the old cache keep a clone.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import (Rng, apply_rope, dense_init,
                                       head_rms_norm, rng_device, split_rng,
                                       stacked_dense_init)

NEG_INF = -1e9


def init_attention(rng: Rng, d: int, n_heads: int, n_kv: int,
                   head_dim: int, dtype, qk_norm: bool = False,
                   n_stack: int = 0) -> Dict:
    ks = split_rng(rng, 4)
    if n_stack:
        def mk(k, i, o):
            return stacked_dense_init(k, n_stack, i, o, dtype)
    else:
        def mk(k, i, o):
            return dense_init(k, i, o, dtype)
    p = {"wq": mk(ks[0], d, n_heads * head_dim),
         "wk": mk(ks[1], d, n_kv * head_dim),
         "wv": mk(ks[2], d, n_kv * head_dim),
         "wo": mk(ks[3], n_heads * head_dim, d)}
    if qk_norm:
        shape = (n_stack, head_dim) if n_stack else (head_dim,)
        p["q_norm"] = torch.zeros(shape, dtype=torch.float32,
                                  device=rng_device(rng))
        p["k_norm"] = torch.zeros(shape, dtype=torch.float32,
                                  device=rng_device(rng))
    return p


def _gqa_scores_out(q, k, v, mask) -> torch.Tensor:
    """q: (B,Kv,G,Sq,hd); k/v: (B,Kv,T,hd); mask broadcastable to
    (B,Kv,G,Sq,T)."""
    hd = q.shape[-1]
    scores = torch.matmul(q, k[:, :, None].transpose(-1, -2)).float()
    scores = scores / hd ** 0.5 + mask
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, v[:, :, None])


def _project_qkv(p, x, n_heads, n_kv, hd, qk_norm):
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, n_kv, hd)
    v = (x @ p["wv"]).reshape(B, S, n_kv, hd)
    if qk_norm:
        q = head_rms_norm(q, p["q_norm"])
        k = head_rms_norm(k, p["k_norm"])
    return q, k, v


def self_attention(p: Dict, x: torch.Tensor, *, n_heads: int, n_kv: int,
                   head_dim: int, rope_theta: float, causal: bool = True,
                   window: int = 0, qk_norm: bool = False) -> torch.Tensor:
    """The training and evaluation forward: attention over the whole
    sequence with no cache. On the card, with grad on, the flash kernel
    saves its row log-sum-exp and the backward kernel gives q, k and v
    their gradients."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, qk_norm)
    positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    return out.reshape(B, S, n_heads * head_dim) @ p["wo"]


def prefill_self_attention(p: Dict, x: torch.Tensor, cache: Dict, *,
                           n_heads: int, n_kv: int, head_dim: int,
                           rope_theta: float, window: int = 0,
                           qk_norm: bool = False
                           ) -> Tuple[torch.Tensor, Dict]:
    """Prefill: causal attention over the prompt (within ``window`` keys
    where it is > 0), and the prompt's keys and values written into the
    (ring) cache."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, qk_norm)
    positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    out = out.reshape(B, S, n_heads * head_dim) @ p["wo"]

    C = cache["k"].shape[1]
    if C >= S:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
        cache["slot_pos"][:S] = positions.to(torch.int32)
    else:
        # ring cache smaller than the prompt: keep the last C tokens,
        # rolled so that slot = pos % C (matches decode's ring update)
        shift = S % C
        cache["k"].copy_(torch.roll(k[:, S - C:], shift, dims=1))
        cache["v"].copy_(torch.roll(v[:, S - C:], shift, dims=1))
        cache["slot_pos"].copy_(torch.roll(
            torch.arange(S - C, S, dtype=torch.int32, device=x.device),
            shift))
    return out, cache


def init_kv_cache(batch: int, cache_len: int, n_kv: int, head_dim: int,
                  dtype, device=None) -> Dict:
    return {
        "k": torch.zeros((batch, cache_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, cache_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "slot_pos": torch.full((cache_len,), -1, dtype=torch.int32,
                               device=device),
    }


def decode_self_attention(p: Dict, x: torch.Tensor, cache: Dict, pos: int,
                          *, n_heads: int, n_kv: int, head_dim: int,
                          rope_theta: float, qk_norm: bool = False
                          ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d); pos: the number of tokens already seen. The cache is a
    ring of length C (the window for sliding-window archs, the longest
    sequence for full attention)."""
    B = x.shape[0]
    C = cache["k"].shape[1]
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, qk_norm)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, rope_theta)
    k = apply_rope(k, posv, rope_theta)

    slot = pos % C
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["slot_pos"][slot] = pos

    G = n_heads // n_kv
    qs = q.reshape(B, 1, n_kv, G, head_dim).permute(0, 2, 3, 1, 4)
    kt = cache["k"].transpose(1, 2)
    vt = cache["v"].transpose(1, 2)
    slot_pos = cache["slot_pos"]
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    mask = torch.where(valid, 0.0, NEG_INF)
    out = _gqa_scores_out(qs, kt, vt, mask)            # (B,Kv,G,1,hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, 1, n_heads * head_dim)
    return out @ p["wo"], cache


# ---------------------------------------------------------------------------
# cross-attention (whisper decoder / VLM image layers)
# ---------------------------------------------------------------------------


def cross_kv(p: Dict, src: torch.Tensor, n_kv: int, head_dim: int) -> Dict:
    """The source's keys and values, (B, T, n_kv, hd) each."""
    B, T, _ = src.shape
    return {"k": (src @ p["wk"]).reshape(B, T, n_kv, head_dim),
            "v": (src @ p["wv"]).reshape(B, T, n_kv, head_dim)}


def cross_attention(p: Dict, x: torch.Tensor, kv: Dict, *, n_heads: int,
                    n_kv: int, head_dim: int) -> torch.Tensor:
    """x: (B, S, d) queries over ``kv`` precomputed from the source; every
    query sees every source position."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_heads, head_dim)
    out = ops.flash_attention(q, kv["k"], kv["v"], causal=False)
    return out.reshape(B, S, n_heads * head_dim) @ p["wo"]
