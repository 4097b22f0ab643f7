"""Optimal-mode training: population search over parameter perturbations.
The port of ``repro/core/es.py``.

PNPCoin §1 names "finding the next optimum in hyperdimensional stochastic
gradient descent" as a target workload and §3.3's **optimal** mode accepts
the lowest result. Every miner perturbs the params with its own seed,
evaluates the loss on the block's batch, and the chain accepts the lowest
loss: the winning perturbation is the block's "res".

Candidates are never held as a population: candidate ``i``'s noise is
drawn again from ``fold_in(key, (i - 1) // 2)``, so a verifier re-derives
any candidate from the key alone. The noise is ``repro_torch.random``'s
threefry stream, drawn on each leaf's device, leaf by leaf in the
reference's order (dict keys sorted, as ``jax.tree_util.tree_flatten``
flattens a dict). No tensor is updated in place: a caller's snapshot of
the params stays valid.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch import random
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.train.steps import _unflatten


def perturb(params: Any, key: torch.Tensor,
            sigma: Union[float, torch.Tensor],
            antithetic_sign: float = 1.0) -> Any:
    """``params + antithetic_sign * sigma * noise`` on every floating leaf,
    one subkey of ``split(key, n_leaves)`` a leaf, the noise float32 cast
    to the leaf's dtype; integer leaves pass through."""
    leaves = tree_leaves(params)
    keys = random.split(key, len(leaves))
    drawn = [i for i, leaf in enumerate(leaves) if leaf.is_floating_point()]
    sizes = [leaves[i].numel() for i in drawn]
    noise = {}
    if drawn:
        # every floating leaf's noise in one pass, each from its own key
        flat = random.normal_concat(keys[drawn], sizes,
                                    leaves[drawn[0]].device)
        noise = dict(zip(drawn, flat.split(sizes)))
    scale = antithetic_sign * sigma
    new = [leaf + scale * noise[i].view(leaf.shape).to(leaf.dtype)
           if i in noise else leaf for i, leaf in enumerate(leaves)]
    return _unflatten(params, iter(new))


def candidate_params(params: Any, key: torch.Tensor, i: int,
                     sigma: float) -> Any:
    """Candidate 0 is the incumbent (a miner may re-submit it, so the chain
    never regresses on the block's batch); candidates 2j + 1 and 2j + 2 are
    the antithetic pair +/- sigma noise_j. Candidate 0 still adds ``-0.0 *
    noise``, as the reference does: the sum, not the params returned
    unchanged, is what ``params_digest`` hashes."""
    sub = random.fold_in(key, max(i - 1, 0) // 2)
    sign = 1.0 if i % 2 == 1 else -1.0
    eff_sigma = torch.tensor(0.0 if i == 0 else sigma, dtype=torch.float32)
    return perturb(params, sub, eff_sigma * sign, 1.0)


def es_block(eval_fn: Callable[[Any, Dict], torch.Tensor], params: Any,
             batch: Dict, key: torch.Tensor, *, pop_size: int,
             sigma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate ``pop_size`` candidates (antithetic pairs) one after the
    other; returns (losses (pop,), best index), the first of equal
    minima."""
    losses = torch.stack([
        eval_fn(candidate_params(params, key, i, sigma), batch)
        for i in range(pop_size)])
    return losses, torch.argmin(losses)


def es_update(params: Any, key: torch.Tensor, losses: torch.Tensor, *,
              sigma: float, lr: float) -> Any:
    """The ES gradient step from all submitted results: theta - lr / pop
    sum_i adv_i eps_i, with eps_i candidate i's unit noise drawn again and
    adv the losses normalised by their mean and population standard
    deviation (ddof 0, as ``jnp.std``). ``sigma`` is unused, as in the
    reference (the step uses unit noise)."""
    pop = losses.shape[0]
    adv = (losses - losses.mean()) / (losses.std(correction=0) + 1e-8)
    acc = tree_map(lambda p: p.float(), params)
    for i in range(pop):
        cand = candidate_params(params, key, i, 1.0)
        coef = (lr / pop) * adv[i]
        acc = tree_map(lambda a, c, p: a - coef * (c.float() - p.float()),
                       acc, cand, params)
    return tree_map(lambda a, p: a.to(p.dtype), acc, params)
