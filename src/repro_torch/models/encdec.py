"""Whisper-style encoder-decoder: the port of ``repro/models/encdec.py``.

The mel-spectrogram and conv frontend is a stub: the batch carries frame
embeddings ``audio_frames`` (B, n_enc_tokens, d_model). A bidirectional
encoder over them, then a causal decoder with a cross-attention to the
encoder's output in every layer; sinusoidal positions, no rope. Every
attention goes through the flash kernel: the encoder's not causal (S = T
= n_enc_tokens), the decoder's causal in prefill, and the cross-attention
not causal at prefill and at every decode step (S = 1 there), over the
keys and values that prefill computes once from the encoder's output and
keeps in ``cache["cross_kv"]``. Serving only: ``init`` takes a
``torch.Generator``, and ``forward`` runs without grad.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (compute_dtype, mlp, rms_norm,
                                       sinusoidal_pos, sinusoidal_pos_at)
from repro_torch.models.transformer import (Model, _index, _init_attn_layer,
                                            _zeros, wants_grad)

Params = Dict[str, Any]


class EncDecModel(Model):
    """Params: the decoder-only model's (``embed``, ``ln_f``, ``unembed``,
    ``groups/l0`` the decoder's self-attention layers), ``enc/layers`` and
    ``enc/ln_f``, and ``cross/ln`` and ``cross/attn`` stacked over the
    decoder's layers. Cache: ``groups/l0`` (the self-attention's ring
    caches), ``cross_kv/k`` and ``cross_kv/v`` (n_layers, B,
    n_enc_tokens, Kv, hd), ``pos``."""

    # -- init -----------------------------------------------------------------
    def init(self, rng) -> Params:
        if not isinstance(rng, torch.Generator):
            self._trained_family("init from a threefry key")
        cfg = self.cfg
        dev = rng.device
        p = super().init(rng)
        p["enc"] = {"layers": _init_attn_layer(rng, cfg, cfg.n_enc_layers),
                    "ln_f": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                        device=dev)}
        p["cross"] = {
            "ln": _zeros((cfg.d_model,), cfg.n_layers, dev),
            "attn": attn.init_attention(
                rng, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.resolved_head_dim, compute_dtype(cfg), False,
                cfg.n_layers)}
        return p

    def _kw(self) -> dict:
        cfg = self.cfg
        return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                    head_dim=cfg.resolved_head_dim)

    def _with_positions(self, x: torch.Tensor) -> torch.Tensor:
        pos = sinusoidal_pos(x.shape[1], self.cfg.d_model, x.device)
        return x + pos.to(x.dtype)[None]

    def _cross(self, p: Params, i: int) -> Params:
        return {"ln": p["cross"]["ln"][i],
                "attn": _index(p["cross"]["attn"], i)}

    # -- encoder ----------------------------------------------------------------
    def encode(self, p: Params, frames: torch.Tensor) -> torch.Tensor:
        """(B, T, d_model) frames -> the encoder's normed output."""
        cfg = self.cfg
        x = frames.to(p["embed"].device, compute_dtype(cfg))
        x = self._with_positions(x)
        for i in range(cfg.n_enc_layers):
            lp = _index(p["enc"]["layers"], i)
            x = x + attn.self_attention(
                lp["attn"], rms_norm(x, lp["ln1"]), **self._kw(),
                rope_theta=0.0, causal=False)
            x = x + mlp(lp["mlp"], rms_norm(x, lp["ln2"]))
        return rms_norm(x, p["enc"]["ln_f"])

    # -- decoder (teacher-forced) -----------------------------------------------
    def forward(self, p: Params, batch: Dict):
        """Teacher-forced logits (B, S, padded vocab) and aux 0.0."""
        if wants_grad(p):
            self._trained_family("the training forward")
        cfg = self.cfg
        enc_out = self.encode(p, batch["audio_frames"])
        x = self._with_positions(self._embed(p, batch["tokens"]))
        for i in range(cfg.n_layers):
            lp, cp = _index(p["groups"]["l0"], i), self._cross(p, i)
            x = x + attn.self_attention(
                lp["attn"], rms_norm(x, lp["ln1"]), **self._kw(),
                rope_theta=0.0, causal=True)
            kv = attn.cross_kv(cp["attn"], enc_out, cfg.n_kv_heads,
                               cfg.resolved_head_dim)
            x = x + attn.cross_attention(cp["attn"], rms_norm(x, cp["ln"]),
                                         kv, **self._kw())
            x = x + mlp(lp["mlp"], rms_norm(x, lp["ln2"]))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._head(p, x), aux

    # -- cache ------------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, device=None) -> Dict:
        cfg = self.cfg
        cache = super().init_cache(batch, cache_len, device)
        shape = (cfg.n_layers, batch, cfg.n_enc_tokens, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        cache["cross_kv"] = {
            name: torch.zeros(shape, dtype=compute_dtype(cfg), device=device)
            for name in ("k", "v")}
        return cache

    # -- prefill / decode --------------------------------------------------------
    def _dec_stateful(self, p: Params, x: torch.Tensor, cache: Dict,
                      mode: str) -> torch.Tensor:
        cfg, pos = self.cfg, cache["pos"]
        for i in range(cfg.n_layers):
            lp, cp = _index(p["groups"]["l0"], i), self._cross(p, i)
            sc = _index(cache["groups"]["l0"], i)
            h = rms_norm(x, lp["ln1"])
            if mode == "prefill":
                out, _ = attn.prefill_self_attention(
                    lp["attn"], h, sc, **self._kw(), rope_theta=0.0)
            else:
                out, _ = attn.decode_self_attention(
                    lp["attn"], h, sc, pos, **self._kw(), rope_theta=0.0)
            x = x + out
            x = x + attn.cross_attention(cp["attn"], rms_norm(x, cp["ln"]),
                                         _index(cache["cross_kv"], i),
                                         **self._kw())
            x = x + mlp(lp["mlp"], rms_norm(x, lp["ln2"]))
        return x

    def prefill(self, p: Params, batch: Dict, cache: Dict):
        """Encodes ``audio_frames``, writes each layer's cross keys and
        values into the cache, then runs the prompt through the decoder."""
        cfg = self.cfg
        enc_out = self.encode(p, batch["audio_frames"])
        for i in range(cfg.n_layers):
            kv = attn.cross_kv(_index(p["cross"]["attn"], i), enc_out,
                               cfg.n_kv_heads, cfg.resolved_head_dim)
            for name in ("k", "v"):
                cache["cross_kv"][name][i] = kv[name]
        tokens = batch["tokens"]
        x = self._with_positions(self._embed(p, tokens))
        x = self._dec_stateful(p, x, cache, "prefill")
        return self._head(p, x[:, -1:]), {
            **cache, "pos": cache["pos"] + tokens.shape[1]}

    def decode_step(self, p: Params, batch: Dict, cache: Dict):
        x = self._embed(p, batch["tokens"])
        pos = sinusoidal_pos_at(cache["pos"], self.cfg.d_model, x.device)
        x = self._dec_stateful(p, x + pos.to(x.dtype)[None, None], cache,
                               "decode")
        return self._head(p, x), {**cache, "pos": cache["pos"] + 1}
