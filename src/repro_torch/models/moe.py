"""Mixture-of-Experts: the port of ``repro/models/moe.py``, a top-k router
and the fixed-capacity scatter/gather dispatch.

Tokens are scattered into an (E, C, d) buffer, the experts run as three
batched products over E (cuBLAS on the card; the reference leaves them to
XLA too, no Pallas kernel), and the results gather back weighted by the
router. Capacity C = ceil(T k / E cf); a (token, choice) past its
expert's capacity is dropped: it goes to a dummy row E C, whose content
never counts. Supports Arctic's dense residual (in ``transformer.py``)
and returns the Switch load-balance aux loss.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Rng, normal_init, silu, split_rng


def init_moe(rng: Rng, d: int, f: int, n_experts: int, dtype,
             n_stack: int = 0) -> Dict:
    """Router (d, E) float32, N(0, 0.02^2), and the experts' w1, w3 (E, d,
    f) and w2 (E, f, d) at a fan-in scale, each with a leading ``n_stack``
    axis where given."""
    k1, k2, k3, k4 = split_rng(rng, 4)
    lead = (n_stack,) if n_stack else ()

    def mk(k, i, o):
        return normal_init(k, lead + (n_experts, i, o), i ** -0.5, dtype)
    return {"router": normal_init(k1, lead + (d, n_experts), 0.02,
                              torch.float32),
            "experts": {"w1": mk(k2, d, f), "w3": mk(k3, d, f),
                        "w2": mk(k4, f, d)}}


def route(router: torch.Tensor, xt: torch.Tensor, top_k: int):
    """The router in float32: (probs (T, E), gate weights (T, k)
    renormalised to sum to 1, expert indices (T, k)). Ties go to the lower
    expert index, as ``jax.lax.top_k`` breaks them: a stable descending
    sort, of which the first k."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    gate_w, gate_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_i = gate_w[:, :top_k], gate_i[:, :top_k]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate_w, gate_i


def dispatch_slots(gate_i: torch.Tensor, n_experts: int, capacity: int):
    """Each (token, choice)'s row in the (E C + 1, d) buffer and whether it
    was kept: its rank among the choices of its expert, by a stable sort of
    the flattened indices, within ``capacity``; the dropped ones go to row
    E C."""
    flat_i = gate_i.reshape(-1)
    Tk = flat_i.shape[0]
    order = torch.argsort(flat_i, stable=True)
    sorted_e = flat_i[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=flat_i.device))
    ranks = torch.arange(Tk, device=flat_i.device) - starts[sorted_e]
    pos = torch.empty_like(ranks).scatter_(0, order, ranks)
    keep = pos < capacity
    slot = torch.where(keep, flat_i * capacity + pos,
                       torch.full_like(pos, n_experts * capacity))
    return slot, keep


def moe_ffn(p: Dict, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, aux loss, float32)."""
    B, S, d = x.shape
    E = p["router"].shape[-1]
    T = B * S
    xt = x.reshape(T, d)
    probs, gate_w, gate_i = route(p["router"], xt, top_k)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_i, E).float().sum(dim=1).mean(dim=0)
    aux = E * torch.sum(me * ce)

    C = max(1, math.ceil(T * top_k / E * capacity_factor))
    slot, keep = dispatch_slots(gate_i, E, C)

    # scatter into (E C + 1, d): every dropped choice lands on the dummy
    # row, in no set order, and the row is cut off before the products
    xk = xt.repeat_interleave(top_k, dim=0)
    buf = x.new_zeros((E * C + 1, d)).index_copy_(0, slot, xk)
    buf = buf[: E * C].reshape(E, C, d)

    w = p["experts"]
    h = silu(torch.bmm(buf, w["w1"])) * torch.bmm(buf, w["w3"])
    eout = torch.bmm(h, w["w2"])                              # (E, C, d)

    # gather back, the dummy row giving zeros, and combine in float32
    flat_out = torch.cat([eout.reshape(E * C, d), eout.new_zeros((1, d))])
    tok_out = flat_out.index_select(0, slot).reshape(T, top_k, d)
    w_keep = gate_w * keep.reshape(T, top_k).float()
    out = torch.einsum("tkd,tk->td", tok_out.float(), w_keep)
    return out.reshape(B, S, d).to(x.dtype), aux
