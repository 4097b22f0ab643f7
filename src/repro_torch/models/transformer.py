"""Decoder-only model assembly: the dense path of
``repro/models/transformer.py``, for serving.

Params keep the reference's stacked layout: ``groups/l0`` holds every
layer with a leading ``n_layers`` axis (the dense pattern is one kind of
layer, so the reference's ``rest{r}`` layers never occur), and weights
converted from the reference drop in. Layers run as a Python loop over
that axis (the reference scans it). The other families raise
``NotImplementedError``.

    init(gen)                          -> params
    init_cache(batch, cache_len)       -> cache
    prefill(params, batch, cache)      -> (logits of the last token, cache)
    decode_step(params, batch, cache)  -> (logits, cache)     # one token
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (compute_dtype, embed_init, init_mlp,
                                       mlp, rms_norm)

Params = Dict[str, Any]

# where each family's port stands in ROADMAP.md
_FAMILY_TODO = {
    "moe": "ROADMAP.md §1, the remaining model families (models/moe.py)",
    "hybrid": "ROADMAP.md §1, the RG-LRU slice (models/rglru.py)",
    "ssm": "ROADMAP.md §1, the RWKV-6 slice (models/rwkv6.py)",
    "encdec": "ROADMAP.md §1, the remaining model families "
              "(models/encdec.py)",
    "vlm": "ROADMAP.md §1, the remaining model families (models/vlm.py)",
}


def _zeros(shape, n_stack, device):
    if n_stack:
        shape = (n_stack,) + shape
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _init_attn_layer(gen: torch.Generator, cfg: ModelConfig,
                     n_stack: int) -> Params:
    dt = compute_dtype(cfg)
    return {
        "ln1": _zeros((cfg.d_model,), n_stack, gen.device),
        "ln2": _zeros((cfg.d_model,), n_stack, gen.device),
        "attn": attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.resolved_head_dim,
                                    dt, cfg.qk_norm, n_stack),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dt, n_stack),
    }


def _apply_attn_layer(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                      mode: str, cache: Dict, pos: int) -> torch.Tensor:
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
              head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
              qk_norm=cfg.qk_norm)
    h = rms_norm(x, lp["ln1"])
    if mode == "prefill":
        out, _ = attn.prefill_self_attention(
            lp["attn"], h, cache, window=cfg.window, **kw)
    elif mode == "decode":
        out, _ = attn.decode_self_attention(lp["attn"], h, cache, pos, **kw)
    else:
        raise NotImplementedError(
            f"mode {mode!r}: the training slice (ROADMAP.md §1) ports "
            "`self_attention` and the train forward")
    x = x + out
    return x + mlp(lp["mlp"], rms_norm(x, lp["ln2"]))


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


class Model:
    """Decoder-only LM over a stack of attention layers (dense family)."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r}: "
                f"{_FAMILY_TODO.get(cfg.family, 'ROADMAP.md §1')}")
        self.cfg = cfg
        self.n_groups = cfg.n_layers

    # -- init ---------------------------------------------------------------
    def init(self, gen: torch.Generator) -> Params:
        """Random params on ``gen``'s device, in the reference's layout."""
        cfg = self.cfg
        dt = compute_dtype(cfg)
        p: Params = {
            "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dt),
            "ln_f": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                device=gen.device),
        }
        if not cfg.tie_embeddings:
            p["unembed"] = embed_init(gen, cfg.padded_vocab, cfg.d_model, dt)
        p["groups"] = {"l0": _init_attn_layer(gen, cfg, self.n_groups)}
        return p

    # -- embedding / head -----------------------------------------------------
    def _embed(self, p: Params, tokens: torch.Tensor) -> torch.Tensor:
        return p["embed"][tokens.long()].to(compute_dtype(self.cfg))

    def _head(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, p["ln_f"])
        table = p["embed"] if self.cfg.tie_embeddings else p["unembed"]
        return x @ table.T

    # -- cache ----------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, device=None) -> Dict:
        """The reference's cache layout: ``groups/l0`` holds each layer's
        ring cache with a leading ``n_layers`` axis; ``pos`` counts the
        tokens seen (a Python int here)."""
        cfg = self.cfg
        C = min(cache_len, cfg.window) if cfg.window else cache_len
        one = attn.init_kv_cache(batch, C, cfg.n_kv_heads,
                                 cfg.resolved_head_dim, compute_dtype(cfg),
                                 device)
        stacked = {k: v.expand((self.n_groups,) + v.shape).contiguous()
                   for k, v in one.items()}
        return {"pos": 0, "groups": {"l0": stacked}}

    # -- prefill / decode -------------------------------------------------------
    def _stateful(self, p: Params, x: torch.Tensor, cache: Dict, mode: str):
        for i in range(self.n_groups):
            # each layer writes into its view of the stacked cache tensors
            x = _apply_attn_layer(
                _index(p["groups"]["l0"], i), x, self.cfg, mode,
                _index(cache["groups"]["l0"], i), cache["pos"])
        return x, {"groups": cache["groups"]}

    def prefill(self, p: Params, batch: Dict, cache: Dict):
        tokens = batch["tokens"]
        x = self._embed(p, tokens)
        x, new_cache = self._stateful(p, x, cache, "prefill")
        new_cache["pos"] = cache["pos"] + tokens.shape[1]
        return self._head(p, x[:, -1:]), new_cache

    def decode_step(self, p: Params, batch: Dict, cache: Dict):
        token = batch["tokens"]                      # (B, 1)
        x = self._embed(p, token)
        x, new_cache = self._stateful(p, x, cache, "decode")
        new_cache["pos"] = cache["pos"] + 1
        return self._head(p, x), new_cache
