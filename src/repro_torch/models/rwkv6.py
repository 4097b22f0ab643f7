"""RWKV-6 "Finch" (arXiv:2404.05892): the port of ``repro/models/rwkv6.py``.

Attention-free time mix with a matrix-valued state per head (K = V =
head_dim):
    o_t = r_t^T (S_{t-1} + (u * k_t) v_t^T)
    S_t = Diag(w_t) S_{t-1} + k_t v_t^T
with w_t = exp(-exp(xw_t @ W_w + b_w)) in (0, 1), a data-dependent decay.

The recurrence goes through ``kernels.ops.wkv6`` in prefill and decode
alike: the hand-written kernel on the card (one launch per layer and
call), the plain loop of ``kernels/ref.py`` on the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import Rng, dense_init, rng_device, silu, \
    split_rng


def init_rwkv_layer(rng: Rng, d: int, f: int, head_dim: int,
                    dtype, n_stack: int = 0) -> Dict:
    """As the reference: one draw per weight, the same for every layer of
    a stack. From a threefry key, the reference's draws (its ``split(key,
    12)``, ``ks[0..8]`` in the order below); from a generator,
    ``torch.randn`` in that order."""
    H = d // head_dim
    dev = rng_device(rng)
    ks = iter(split_rng(rng, 12))

    def mk(i, o):
        w = dense_init(next(ks), i, o, dtype)
        return w.expand((n_stack, i, o)).contiguous() if n_stack else w

    def vec(val, shape):
        v = torch.full(shape, val, dtype=torch.float32, device=dev)
        return v.expand((n_stack,) + shape).contiguous() if n_stack else v
    return {
        # time mix
        "tm_r": mk(d, d), "tm_k": mk(d, d), "tm_v": mk(d, d),
        "tm_g": mk(d, d), "tm_w": mk(d, d), "tm_out": mk(d, d),
        "mu": vec(0.5, (5, d)),            # token-shift lerp for r,k,v,g,w
        "w_bias": vec(-0.6, (d,)),         # decay bias
        "u": vec(0.3, (H, head_dim)),      # per-head bonus
        "ln_x": vec(0.0, (d,)),            # per-head group-norm gamma
        # channel mix
        "cm_k": mk(d, f), "cm_v": mk(f, d), "cm_r": mk(d, d),
        "mu_c": vec(0.5, (2, d)),          # token-shift lerp for k,r
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """xs_t = x_{t-1}; prev: (B, d) carries across calls."""
    B, S, d = x.shape
    first = prev[:, None, :] if prev is not None else \
        torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
    return torch.cat([first, x[:, :-1]], dim=1)


def time_mix(p: Dict, x: torch.Tensor, state: Optional[Dict],
             head_dim: int) -> Tuple[torch.Tensor, Optional[Dict]]:
    B, S, d = x.shape
    H = d // head_dim
    prev_tok = state["tok"] if state is not None else None
    xs = _token_shift(x, prev_tok)
    mu = p["mu"].to(x.dtype)

    def mixed(i):
        return x + (xs - x) * mu[i]
    r = (mixed(0) @ p["tm_r"]).reshape(B, S, H, head_dim)
    k = (mixed(1) @ p["tm_k"]).reshape(B, S, H, head_dim)
    v = (mixed(2) @ p["tm_v"]).reshape(B, S, H, head_dim)
    g = silu(mixed(3) @ p["tm_g"])
    w_raw = (mixed(4) @ p["tm_w"]).float() + p["w_bias"]
    w = torch.exp(-torch.exp(w_raw)).reshape(B, S, H, head_dim)

    s0 = state["wkv"] if state is not None else None
    # the whole sequence in one call: one kernel launch per layer
    out, sT = ops.wkv6(r, k, v, w, p["u"].float(), s0)

    # per-head group norm
    mean = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, unbiased=False)
    o32 = (out - mean) * torch.rsqrt(var + 1e-5)
    o = (o32.reshape(B, S, d) * (1.0 + p["ln_x"])).to(x.dtype)
    y = (o * g) @ p["tm_out"]
    new_state = {"tok": x[:, -1], "wkv": sT} if state is not None else None
    return y, new_state


def channel_mix(p: Dict, x: torch.Tensor, state: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    xs = _token_shift(x, state)
    mu = p["mu_c"].to(x.dtype)
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    kk = torch.square(torch.relu(xk @ p["cm_k"]))
    out = torch.sigmoid(xr @ p["cm_r"]) * (kk @ p["cm_v"])
    return out, (x[:, -1] if state is not None else None)


def init_rwkv_state(batch: int, d: int, head_dim: int, dtype,
                    device=None) -> Dict:
    H = d // head_dim
    return {
        "tm": {"tok": torch.zeros((batch, d), dtype=dtype, device=device),
               "wkv": torch.zeros((batch, H, head_dim, head_dim),
                                  dtype=torch.float32, device=device)},
        "cm_tok": torch.zeros((batch, d), dtype=dtype, device=device),
    }
