"""Step builders of ``repro/train/steps.py``: the training step (the jash
payload of proof-of-useful-work training), its state and the canonical
digests the chain commits, and the serving half: prefill, one greedy
decode step, and the cache.

``make_train_step(cfg)`` returns ``(state, batch) -> (state, metrics)``:
the loss, its gradients by autograd (through the hand-written flash
backward on the card), the cosine schedule and AdamW. The state is
replaced, never changed in place, so a snapshot of it stays valid.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, Iterator, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models.model import (adapt_for_shape, build_model,
                                      cache_len_for)
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     tree_leaves, tree_map)
from repro_torch.optim.schedule import cosine_schedule


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


# ---------------------------------------------------------------------------
# digest-stable state canonicalization
# ---------------------------------------------------------------------------


def _flatten_with_path(tree: Any, path: Tuple[str, ...] = ()
                       ) -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in JAX's flattening order: dict keys sorted,
    sequences by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_path(v, path + (str(i),))
    else:
        yield "/".join(path), tree


# the dtype string numpy gives a JAX bfloat16 array (``ml_dtypes``)
BF16_DTYPE_STR = "<V2"


def host_leaf(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf on the host and its dtype string, as the reference's bytes
    give them: numpy has no bfloat16, so a bf16 leaf is its bits as int16
    under the reference's dtype string, ``'<V2'``. The one place that
    decides how a leaf is framed, for digests and checkpoints alike."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).cpu().numpy(), BF16_DTYPE_STR
        leaf = leaf.cpu().numpy()
    arr = np.asarray(leaf)
    return arr, arr.dtype.str


def _canonical_leaf(leaf: Any) -> Tuple[np.ndarray, str]:
    """Little-endian, C-contiguous host copy of a leaf (the only byte
    order a digest may ever see, whatever device the tensor lives on) and
    its dtype string (``host_leaf``)."""
    arr, dtype = host_leaf(leaf)
    if dtype.startswith(">"):
        arr = arr.astype(arr.dtype.newbyteorder("<"))
        dtype = arr.dtype.str
    return np.ascontiguousarray(arr), dtype


def canonical_tree_bytes(tree: Any) -> Iterator[bytes | memoryview]:
    """The canonical byte framing of a tree, leaf by leaf: ``path | dtype |
    ndim | shape | little-endian C-order data``, byte for byte the
    reference's, so both packages commit the same digest for the same
    values. Leaves are gathered to the host first; a leaf's data comes as
    a view of its C-contiguous host copy (no second copy of a state's
    gigabytes)."""
    for pstr, leaf in _flatten_with_path(tree):
        arr, dtype = _canonical_leaf(leaf)
        yield pstr.encode() + b"\x00" + dtype.encode() + b"\x00"
        yield np.int64(arr.ndim).tobytes()
        yield np.asarray(arr.shape, np.int64).tobytes()
        yield memoryview(arr.reshape(-1)).cast("B")


def tree_digest(tree: Any) -> str:
    """sha256 hex digest of ``canonical_tree_bytes(tree)``."""
    h = hashlib.sha256()
    for chunk in canonical_tree_bytes(tree):
        h.update(chunk)
    return h.hexdigest()


def params_digest(state_or_params: Any) -> str:
    """The chain's ``state_digest`` for model training: the digest of the
    params of a ``TrainState`` or of a bare params tree."""
    params = (state_or_params.params
              if isinstance(state_or_params, TrainState) else state_or_params)
    return tree_digest(params)


@dataclasses.dataclass(frozen=True)
class TrainHparams:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def make_train_state(cfg: ModelConfig, key: Any,
                     device: DeviceLike = None) -> TrainState:
    """Params from ``Model.init(key)`` (a threefry key of
    ``repro_torch.random``: the reference's weights, drawn on ``device``
    itself) and zeroed AdamW state in ``cfg.opt_dtype``."""
    dev = resolve(device)
    params = build_model(cfg).init(key.to(dev))
    return TrainState(params=params,
                      opt=adamw_init(params, getattr(torch, cfg.opt_dtype)))


def _unflatten(tree: Any, leaves: Iterator[torch.Tensor]) -> Any:
    """A tree like ``tree`` holding ``leaves`` in sorted-key order."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def make_update(hp: TrainHparams = TrainHparams()
                ) -> Callable[[Any, Any, AdamWState],
                              Tuple[Any, AdamWState, torch.Tensor]]:
    """The training step's second half: ``(params, grads, opt) ->
    (params, opt, lr)``, the cosine schedule at the next step and AdamW."""

    def update(params: Any, grads: Any, opt: AdamWState):
        with torch.no_grad():
            lr = cosine_schedule(opt.step + 1, peak_lr=hp.peak_lr,
                                 warmup_steps=hp.warmup_steps,
                                 total_steps=hp.total_steps)
            new_params, new_opt = adamw_update(
                params, grads, opt, lr, weight_decay=hp.weight_decay,
                grad_clip=hp.grad_clip)
        return new_params, new_opt, lr

    return update


def make_train_step(cfg: ModelConfig, hp: TrainHparams = TrainHparams()
                    ) -> Callable[[TrainState, Dict],
                                  Tuple[TrainState, Dict]]:
    model = build_model(cfg)
    update = make_update(hp)

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        params = tree_map(lambda t: t.detach().requires_grad_(True),
                          state.params)
        with torch.enable_grad():
            loss, metrics = model.loss(params, batch)
            # every leaf must be reached: an op that drops the gradient
            # raises here instead of leaving a weight unchanged
            grads = torch.autograd.grad(loss, tree_leaves(params))
        grads = _unflatten(params, iter(grads))
        new_params, opt, lr = update(tree_map(torch.Tensor.detach, params),
                                     grads, state.opt)
        out = {"loss": loss.detach(), "ce": metrics["ce"].detach(),
               "aux": metrics["aux"].detach(), "lr": lr}
        return TrainState(params=new_params, opt=opt), out

    return train_step


def make_eval_step(cfg: ModelConfig):
    """Forward-only loss (optimal-mode and ES candidate scoring)."""
    model = build_model(cfg)

    def eval_step(params, batch) -> torch.Tensor:
        with torch.no_grad():
            loss, _ = model.loss(params, batch)
        return loss

    return eval_step


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, shape: InputShape):
    """``(params, batch, cache) -> (logits of the last token, cache)``; the
    batch carries ``tokens`` and, for the vlm and encdec families,
    ``image_embeds`` or ``audio_frames``, whose cross keys and values the
    prefill writes into the cache."""
    cfg = adapt_for_shape(cfg, shape)
    model = build_model(cfg)

    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)

    return prefill_step


def make_decode_step(cfg: ModelConfig, shape: InputShape):
    """One new token against a ``shape.seq_len``-deep cache; the next token
    is the argmax over the real vocab (padded columns never win)."""
    cfg = adapt_for_shape(cfg, shape)
    model = build_model(cfg)

    def decode_step(params, batch, cache):
        logits, new_cache = model.decode_step(params, batch, cache)
        next_tok = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)
        return next_tok.to(torch.int32), logits, new_cache

    return decode_step


def make_init_cache(cfg: ModelConfig, shape: InputShape, device=None):
    """The family's cache for ``shape``: ring KV caches or recurrent
    states, plus the cross keys and values of the encdec and vlm
    families."""
    cfg = adapt_for_shape(cfg, shape)
    model = build_model(cfg)

    def init_cache():
        return model.init_cache(shape.global_batch,
                                cache_len_for(cfg, shape), device)

    return init_cache
