"""Llama-3.2-Vision-style VLM: the port of ``repro/models/vlm.py``.

A dense GQA text decoder with a gated cross-attention layer to the image
tokens every ``cross_attn_every`` layers: groups of (``cross_attn_every``
- 1) self-attention layers and one cross layer. The vision encoder is a
stub: the batch carries patch embeddings ``image_embeds`` (B,
n_img_tokens, d_vision); the model owns only the linear projector into
d_model. Prefill computes each cross layer's keys and values from the
projected image once and keeps them in the cache; the cross-attention
runs on the flash kernel, not causal, at prefill and at every decode step.
Serving only: ``init`` takes a ``torch.Generator``, and ``forward`` runs
without grad.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (compute_dtype, dense_init,
                                       embed_init)
from repro_torch.models.transformer import (Model, _apply_attn_layer,
                                            _apply_cross_layer, _index,
                                            _init_attn_layer,
                                            _init_cross_layer,
                                            _init_sub_cache, _stack,
                                            _train_attn_layer, wants_grad)

Params = Dict[str, Any]


class VLMModel(Model):
    """Params: ``embed``, ``ln_f``, ``unembed``, ``img_proj`` (d_vision,
    d_model), ``groups/self{j}`` and ``groups/cross`` stacked over the
    groups. Cache: ``groups/self{j}`` (ring caches), ``groups/cross_kv/k``
    and ``v`` (n_groups, B, n_img_tokens, Kv, hd), ``pos``."""

    def __init__(self, cfg):
        super().__init__(cfg)
        if cfg.cross_attn_every < 1 or cfg.n_layers % cfg.cross_attn_every:
            raise ValueError("vlm stack must be whole groups of "
                             f"{cfg.cross_attn_every} layers")
        self.n_self = cfg.cross_attn_every - 1
        self.n_groups = cfg.n_layers // cfg.cross_attn_every
        self.n_rest = 0

    def init(self, rng) -> Params:
        if not isinstance(rng, torch.Generator):
            self._trained_family("init from a threefry key")
        cfg, dt = self.cfg, compute_dtype(self.cfg)
        p = {"embed": embed_init(rng, cfg.padded_vocab, cfg.d_model, dt),
             "ln_f": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                 device=rng.device)}
        if not cfg.tie_embeddings:
            p["unembed"] = embed_init(rng, cfg.padded_vocab, cfg.d_model, dt)
        p["img_proj"] = dense_init(rng, cfg.d_vision or cfg.d_model,
                                   cfg.d_model, dt)
        groups = {f"self{j}": _init_attn_layer(rng, cfg, self.n_groups)
                  for j in range(self.n_self)}
        groups["cross"] = _init_cross_layer(rng, cfg, self.n_groups)
        p["groups"] = groups
        return p

    def _project_image(self, p: Params, batch: Dict) -> torch.Tensor:
        img = batch["image_embeds"].to(p["img_proj"].device,
                                       compute_dtype(self.cfg))
        return img @ p["img_proj"]                     # (B, N, d)

    def _cross_kv(self, gp: Params, img: torch.Tensor) -> Dict:
        cfg = self.cfg
        return attn.cross_kv(gp["cross"]["attn"], img, cfg.n_kv_heads,
                             cfg.resolved_head_dim)

    # -- teacher-forced ---------------------------------------------------------
    def forward(self, p: Params, batch: Dict):
        """Teacher-forced logits (B, S, padded vocab) and aux 0.0."""
        if wants_grad(p):
            self._trained_family("the training forward")
        cfg = self.cfg
        img = self._project_image(p, batch)
        x = self._embed(p, batch["tokens"])
        for g in range(self.n_groups):
            gp = _index(p["groups"], g)
            for j in range(self.n_self):
                x = _train_attn_layer(gp[f"self{j}"], x, cfg)
            x = _apply_cross_layer(gp["cross"], x, cfg,
                                   self._cross_kv(gp, img))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._head(p, x), aux

    # -- cache ------------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, device=None) -> Dict:
        cfg = self.cfg
        groups = {f"self{j}": _stack(_init_sub_cache(
            "attn", cfg, batch, cache_len, device), self.n_groups)
            for j in range(self.n_self)}
        shape = (self.n_groups, batch, cfg.n_img_tokens, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        groups["cross_kv"] = {
            name: torch.zeros(shape, dtype=compute_dtype(cfg), device=device)
            for name in ("k", "v")}
        return {"groups": groups, "pos": 0}

    # -- prefill / decode -------------------------------------------------------
    def _stateful(self, p: Params, x: torch.Tensor, cache: Dict, mode: str):
        cfg, pos = self.cfg, cache["pos"]
        for g in range(self.n_groups):
            gp, gc = _index(p["groups"], g), _index(cache["groups"], g)
            for j in range(self.n_self):
                x = _apply_attn_layer(gp[f"self{j}"], x, cfg, mode,
                                      gc[f"self{j}"], pos)
            x = _apply_cross_layer(gp["cross"], x, cfg, gc["cross_kv"])
        return x, {"groups": cache["groups"]}

    def prefill(self, p: Params, batch: Dict, cache: Dict):
        """Projects ``image_embeds``, writes each cross layer's keys and
        values into the cache, then runs the prompt."""
        img = self._project_image(p, batch)
        for g in range(self.n_groups):
            kv = self._cross_kv(_index(p["groups"], g), img)
            for name in ("k", "v"):
                cache["groups"]["cross_kv"][name][g] = kv[name]
        return super().prefill(p, batch, cache)
