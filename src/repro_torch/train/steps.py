"""Step builders of ``repro/train/steps.py``, serving half: prefill, one
greedy decode step, and the cache. The training step waits for the
training slice (ROADMAP.md §1)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.model import (adapt_for_shape, build_model,
                                      cache_len_for)


def make_prefill_step(cfg: ModelConfig, shape: InputShape):
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
    cfg = adapt_for_shape(cfg, shape)
    model = build_model(cfg)

    def init_cache():
        return model.init_cache(shape.global_batch,
                                cache_len_for(cfg, shape), device)

    return init_cache
