"""AdamW: the port of ``repro/optim/adamw.py``.

Optimizer state mirrors the params (m, v as nested dicts of float32
tensors). The update is functional, returning new tensors, and visits the
leaves in the reference's order (dict keys sorted, as JAX flattens a
dict), so the global norm sums its squares in the same order:

    state = adamw_init(params)
    params, state = adamw_update(params, grads, state, lr, ...)
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Tuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor       # scalar int32
    m: Any                   # nested dict like params (float32)
    v: Any                   # nested dict like params (float32)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def adamw_init(params: Any, dtype=torch.float32) -> AdamWState:
    """``dtype``: storage dtype for m and v; the update math runs in
    float32."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=dtype, device=p.device)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def adamw_update(params: Any, grads: Any, state: AdamWState, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip: float = 1.0) -> Tuple[Any, AdamWState]:
    step = state.step + 1
    if grad_clip > 0:
        # global-norm clip, squares summed leaf by leaf in sorted-key order
        total = None
        for g in tree_leaves(grads):
            s = g.float().square().sum()
            total = s if total is None else total + s
        gnorm = torch.sqrt(total)
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        grads = tree_map(lambda g: g * scale, grads)

    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=stepf.device), stepf)

    def upd(p, g, m, v):
        g32 = g.float()
        m_new = b1 * m.float() + (1 - b1) * g32
        v_new = b2 * v.float() + (1 - b2) * g32.square()
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        if weight_decay > 0 and p.dim() >= 2:       # decay matrices only
            delta = delta + weight_decay * p.float()
        p_new = p.float() - lr * delta
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    out = tree_map(upd, params, grads, state.m, state.v)
    return _pick(out, 0), AdamWState(step=step, m=_pick(out, 1),
                                     v=_pick(out, 2))


def _pick(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
