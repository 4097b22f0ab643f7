"""Shared building blocks: the port of ``repro/models/layers.py``.

Params are plain dicts of tensors with the reference's keys, shapes and
dtypes. Initialisers draw from an explicit ``torch.Generator`` and make
their tensors on its device. They do not reproduce ``jax.random``'s
numbers: weights that must equal the reference's are converted from it
(``repro_torch.convert.params_from_jax``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

Params = Dict[str, Any]


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * std).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype) -> torch.Tensor:
    return _normal(gen, (d_in, d_out), d_in ** -0.5, dtype)


def stacked_dense_init(gen: torch.Generator, n: int, d_in: int, d_out: int,
                       dtype) -> torch.Tensor:
    return _normal(gen, (n, d_in, d_out), d_in ** -0.5, dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype) -> torch.Tensor:
    return _normal(gen, (vocab, d), 0.02, dtype)


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


# ---------------------------------------------------------------------------
# MLP (gated)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d: int, f: int, dtype,
             n_stack: int = 0) -> Params:
    if n_stack:
        return {"w1": stacked_dense_init(gen, n_stack, d, f, dtype),
                "w3": stacked_dense_init(gen, n_stack, d, f, dtype),
                "w2": stacked_dense_init(gen, n_stack, f, d, dtype)}
    return {"w1": dense_init(gen, d, f, dtype),
            "w3": dense_init(gen, d, f, dtype),
            "w2": dense_init(gen, f, d, dtype)}


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = silu(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]
