"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427):
the port of ``repro/models/rglru.py``.

    r_t = sigmoid(x_t @ W_a)                  (recurrence gate)
    i_t = sigmoid(x_t @ W_x)                  (input gate)
    log a_t = -c * softplus(Lambda) * r_t     (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the scan through ``kernels.ops.decay_scan`` (the hand-written
kernel on the card, one launch per layer); decode carries (h, conv state)
and steps elementwise in plain PyTorch, as the reference does. The block
wraps the RG-LRU with Griffin's input/gate projections, width-4 causal
depthwise conv and output projection.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import (Rng, dense_init, normal_init,
                                       rng_device, silu, split_rng)

_C = 8.0
_CONV_W = 4


def init_rglru_block(rng: Rng, d: int, lru: int, dtype,
                     n_stack: int = 0) -> Dict:
    """As the reference: one draw per weight, the same for every layer of
    a stack. From a threefry key, the reference's draws (its ``split(key,
    6)``: ``ks[4]`` for ``conv``, ``ks[5]`` for ``w_x``); from a generator,
    ``torch.randn`` in the order of the dict. ``lambda`` is drawn from no
    key: it is ``linspace``'s, computed in float32 by PyTorch (the
    reference's XLA rounds its linspace and log differently, by a few
    float32 ulps)."""
    dev = rng_device(rng)
    ks = split_rng(rng, 6)

    def mk(key, i, o):
        w = dense_init(key, i, o, dtype)
        return w.expand((n_stack, i, o)).contiguous() if n_stack else w
    lam = torch.linspace(0.9, 0.999, lru, dtype=torch.float32, device=dev)
    lam = torch.log(torch.exp(-torch.log(lam) / _C) - 1.0)  # a ~ lam
    p = {"gate_in": mk(ks[0], d, lru), "lru_in": mk(ks[1], d, lru),
         "lru_out": mk(ks[2], lru, d), "w_a": mk(ks[3], lru, lru),
         "w_x": mk(ks[5], lru, lru), "lambda": lam}
    # the reference scales its float32 draw by 0.1 rounded to float32
    conv = normal_init(ks[4], (_CONV_W, lru), 0.1, torch.float32).to(dtype)
    p["conv"] = conv
    if n_stack:
        p["lambda"] = lam.expand((n_stack, lru)).contiguous()
        p["conv"] = conv.expand((n_stack, _CONV_W, lru)).contiguous()
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, width 4. x: (B, S, C); state: (B, 3, C)."""
    B, S, C = x.shape
    pad = state if state is not None else \
        torch.zeros((B, _CONV_W - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + S] * w[i] for i in range(_CONV_W))
    new_state = xp[:, S:][:, -(_CONV_W - 1):] if S >= _CONV_W - 1 \
        else xp[:, -(_CONV_W - 1):]
    return out, new_state


def _gates(x32: torch.Tensor, p: Dict):
    r = torch.sigmoid(x32 @ p["w_a"].float())
    i = torch.sigmoid(x32 @ p["w_x"].float())
    log_a = -_C * F.softplus(p["lambda"]) * r                 # <= 0
    gain = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return torch.exp(log_a), gain * (i * x32)


def rg_lru_scan(xc: torch.Tensor, p: Dict,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc: (B, S, lru) post-conv activations -> (h (B, S, lru) in xc's
    dtype, h_last (B, lru) float32). h0 enters the scan as the state
    before step 0 (the reference folds a_0 h0 into step 0's input: the
    same value)."""
    a, gated = _gates(xc.float(), p)
    # the whole sequence in one call: one kernel launch per layer
    h, h_last = ops.decay_scan(a, gated, None if h0 is None else h0.float())
    return h.to(xc.dtype), h_last


def rg_lru_step(xc: torch.Tensor, p: Dict, h: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. xc: (B, 1, lru); h: (B, lru)."""
    a, gated = _gates(xc[:, 0].float(), p)
    h_new = a * h.float() + gated
    return h_new.to(xc.dtype)[:, None, :], h_new


def init_rec_state(batch: int, lru: int, dtype, device=None) -> Dict:
    return {
        "h": torch.zeros((batch, lru), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, _CONV_W - 1, lru), dtype=dtype,
                            device=device),
    }


def rglru_block(p: Dict, x: torch.Tensor, state: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The Griffin recurrent block. x: (B, S, d). With ``state`` given it
    runs statefully (prefill from a carried state, or one decode step) and
    returns the new state."""
    gate = silu(x @ p["gate_in"])                              # (B,S,lru)
    xin = x @ p["lru_in"]
    conv_state = state["conv"] if state is not None else None
    xc, new_conv = _causal_conv(xin, p["conv"], conv_state)
    if state is not None and x.shape[1] == 1:
        h_seq, h_last = rg_lru_step(xc, p, state["h"])
    else:
        h0 = state["h"] if state is not None else None
        h_seq, h_last = rg_lru_scan(xc, p, h0)
    out = (gate * h_seq) @ p["lru_out"]
    new_state = {"h": h_last, "conv": new_conv} if state is not None \
        else None
    return out, new_state
