"""Shared building blocks: the port of ``repro/models/layers.py``.

Params are plain dicts of tensors with the reference's keys, shapes and
dtypes. Initialisers take either a ``torch.Generator`` or a key of
``repro_torch.random`` (the port's copy of ``jax.random``'s threefry
stream). With a generator they draw ``torch.randn`` on its device, which
is quick at any size (serving at 7B); with a key they draw the
reference's numbers on the key's device, splitting the key as the
reference does, so a model initialised from ``random.key(seed)`` starts
from the weights the reference's ``Model.init(jax.random.key(seed))``
gives (within ``random.normal``'s last bits).
"""
from __future__ import annotations

from typing import Any, Dict, List, Union

import numpy as np
import torch

from repro_torch import random

Params = Dict[str, Any]
# a torch.Generator, or a (2,) int64 threefry key of ``repro_torch.random``
Rng = Union[torch.Generator, torch.Tensor]


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def rng_device(rng: Rng) -> torch.device:
    """Where an initialiser makes its tensors: the generator's or the
    threefry key's device."""
    return rng.device


def split_rng(rng: Rng, n: int) -> List[Rng]:
    """``n`` sources for ``n`` draws in turn: a key split as
    ``jax.random.split(key, n)`` splits it, or the same generator ``n``
    times."""
    if isinstance(rng, torch.Generator):
        return [rng] * n
    return list(random.split(rng, n))


def normal_init(rng: Rng, shape, std: float, dtype) -> torch.Tensor:
    """N(0, std^2) of ``shape`` in ``dtype``: ``torch.randn`` on the
    generator's device, or the reference's threefry draw from a key."""
    if isinstance(rng, torch.Generator):
        x = torch.randn(shape, generator=rng, device=rng.device,
                        dtype=torch.float32)
    else:
        # the reference multiplies in float32 by its scale rounded to
        # float32
        x = random.normal(rng, shape)
        std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x * std).to(dtype)


def dense_init(rng: Rng, d_in: int, d_out: int, dtype) -> torch.Tensor:
    return normal_init(rng, (d_in, d_out), d_in ** -0.5, dtype)


def stacked_dense_init(rng: Rng, n: int, d_in: int, d_out: int,
                       dtype) -> torch.Tensor:
    return normal_init(rng, (n, d_in, d_out), d_in ** -0.5, dtype)


def embed_init(rng: Rng, vocab: int, d: int, dtype) -> torch.Tensor:
    return normal_init(rng, (vocab, d), 0.02, dtype)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(x.dtype)


def head_rms_norm(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMSNorm over the trailing head_dim of (..., heads, hd)."""
    return rms_norm(x, gamma, eps)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) or (B, S). Split-half rotation in
    float32, cast back to x's dtype."""
    if theta <= 0.0:
        return x
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.float()[..., None] * freqs          # (S | B,S, hd/2)
    if positions.dim() == 1:
        ang = ang[None]
    ang = ang[:, :, None, :]                            # (1|B, S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) float32: sin, then cos, of pos / 10000^(2i/d). Built in numpy
    float64 and cast, as the reference builds it, so the bits are its."""
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(emb.astype(np.float32)).to(device)


def sinusoidal_pos_at(pos: int, d: int, device=None) -> torch.Tensor:
    """(d,) float32: the embedding of one position, computed in float32
    (the reference's decode step does so for its traced position)."""
    i = torch.arange(d // 2, dtype=torch.float32, device=device)
    ang = torch.tensor(float(pos), dtype=torch.float32, device=device) \
        / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP (gated)
# ---------------------------------------------------------------------------


def init_mlp(rng: Rng, d: int, f: int, dtype, n_stack: int = 0) -> Params:
    k1, k2, k3 = split_rng(rng, 3)
    if n_stack:
        return {"w1": stacked_dense_init(k1, n_stack, d, f, dtype),
                "w3": stacked_dense_init(k2, n_stack, d, f, dtype),
                "w2": stacked_dense_init(k3, n_stack, f, d, dtype)}
    return {"w1": dense_init(k1, d, f, dtype),
            "w3": dense_init(k2, d, f, dtype),
            "w2": dense_init(k3, f, d, dtype)}


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = silu(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean next-token CE in float32; positions with label < 0 are masked,
    and logits at or past ``vocab_size`` (the padded vocab) never count.
    The gold logit is picked by a select against a boolean one-hot and a
    sum over the vocab, whose backward is a select too: no scatter, so the
    same bits on every run (and one byte a logit, not a float one-hot's
    four, at a 256,000-wide vocab)."""
    v_pad = logits.shape[-1]
    logits = logits.float()
    if v_pad != vocab_size:
        keep = torch.arange(v_pad, device=logits.device) < vocab_size
        logits = torch.where(keep, logits, -1e9)
    logz = torch.logsumexp(logits, dim=-1)
    labels = labels.to(logits.device)
    pick = torch.arange(v_pad, device=logits.device) == \
        labels.clamp(min=0).long()[..., None]
    gold = torch.where(pick, logits, 0.0).sum(dim=-1)
    valid = (labels >= 0).float()
    return (logz - gold).mul(valid).sum() / valid.sum().clamp(min=1.0)
