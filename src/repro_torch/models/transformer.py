"""Decoder-only model assembly: the port of
``repro/models/transformer.py`` for serving the dense, moe, hybrid and ssm
families, the training forward and loss of the dense, hybrid and ssm
families, and the layers the encoder-decoder and VLM models
(``encdec.py``, ``vlm.py``) build on.

Params and caches keep the reference's layout, so weights converted from
it drop in: ``groups/l{j}`` holds the j-th kind of layer of the repeating
pattern, stacked over ``n_groups`` (dense: one ``attn``; moe: one
``moe``; ssm: one ``rwkv``; recurrentgemma: ``rec, rec, attn``), and
``rest{r}`` the unstacked layers left after the last whole group. Layers
run as a Python loop over the stack (the reference scans it); with
``cfg.remat`` and grad on, each layer of the training forward is
recomputed in the backward (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint`` does. The dense, hybrid (recurrentgemma:
RG-LRU layers and local attention) and ssm (RWKV-6) families train, their
recurrences' gradients by the hand-written backward kernels on the card;
the teacher-forced ``forward`` of the moe family runs without grad (and
raises with it), and ``init`` from a threefry key raises for the moe
family.

    init(rng)                          -> params
    forward(params, batch)             -> (logits, aux)       # teacher-forced
    loss(params, batch)                -> (loss, {"ce", "aux"})
    init_cache(batch, cache_len)       -> cache
    prefill(params, batch, cache)      -> (logits of the last token, cache)
    decode_step(params, batch, cache)  -> (logits, cache)     # one token

Caches are updated in place: each layer writes its new keys, values or
recurrent state into its view of the stacked cache tensors.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import random
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.layers import (Rng, compute_dtype, cross_entropy,
                                       embed_init, init_mlp, mlp, rms_norm,
                                       rng_device, split_rng)

Params = Dict[str, Any]

# where training the families that do not train yet stands in ROADMAP.md
TRAINING_TODO = ("ROADMAP.md §1, item 4: training the moe, encdec and vlm "
                 "families")
# the families that train
TRAINED_FAMILIES = ("dense", "hybrid", "ssm")


def _zeros(shape, n_stack, device):
    if n_stack:
        shape = (n_stack,) + shape
    return torch.zeros(shape, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# sub-layer init
# ---------------------------------------------------------------------------


def _init_attn_layer(rng: Rng, cfg: ModelConfig, n_stack: int) -> Params:
    dt = compute_dtype(cfg)
    k1, k2 = split_rng(rng, 2)
    return {
        "ln1": _zeros((cfg.d_model,), n_stack, rng_device(rng)),
        "ln2": _zeros((cfg.d_model,), n_stack, rng_device(rng)),
        "attn": attn.init_attention(k1, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.resolved_head_dim,
                                    dt, cfg.qk_norm, n_stack),
        "mlp": init_mlp(k2, cfg.d_model, cfg.d_ff, dt, n_stack),
    }


def _init_moe_layer(rng: Rng, cfg: ModelConfig, n_stack: int) -> Params:
    dt = compute_dtype(cfg)
    k1, k2, k3 = split_rng(rng, 3)
    p = {
        "ln1": _zeros((cfg.d_model,), n_stack, rng_device(rng)),
        "ln2": _zeros((cfg.d_model,), n_stack, rng_device(rng)),
        "attn": attn.init_attention(k1, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.resolved_head_dim,
                                    dt, cfg.qk_norm, n_stack),
        "moe": moe_mod.init_moe(k2, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                dt, n_stack),
    }
    if cfg.moe_dense_residual:
        p["dense_mlp"] = init_mlp(k3, cfg.d_model, cfg.d_ff, dt, n_stack)
    return p


def _init_cross_layer(rng: Rng, cfg: ModelConfig, n_stack: int) -> Params:
    """A gated cross-attention layer (llama-3.2-vision's image layers)."""
    dt = compute_dtype(cfg)
    k1, k2 = split_rng(rng, 2)
    return {
        "ln1": _zeros((cfg.d_model,), n_stack, rng_device(rng)),
        "ln2": _zeros((cfg.d_model,), n_stack, rng_device(rng)),
        "attn": attn.init_attention(k1, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.resolved_head_dim,
                                    dt, False, n_stack),
        "gate": _zeros((), n_stack, rng_device(rng)),
        "mlp": init_mlp(k2, cfg.d_model, cfg.d_ff, dt, n_stack),
    }


def _init_rec_layer(rng: Rng, cfg: ModelConfig, n_stack: int) -> Params:
    dt = compute_dtype(cfg)
    k1, k2 = split_rng(rng, 2)
    return {
        "ln1": _zeros((cfg.d_model,), n_stack, rng_device(rng)),
        "ln2": _zeros((cfg.d_model,), n_stack, rng_device(rng)),
        "rec": rglru_mod.init_rglru_block(
            k1, cfg.d_model, cfg.lru_width or cfg.d_model, dt, n_stack),
        "mlp": init_mlp(k2, cfg.d_model, cfg.d_ff, dt, n_stack),
    }


def _init_rwkv_layer(rng: Rng, cfg: ModelConfig, n_stack: int) -> Params:
    return {
        "ln1": _zeros((cfg.d_model,), n_stack, rng_device(rng)),
        "ln2": _zeros((cfg.d_model,), n_stack, rng_device(rng)),
        "mix": rwkv_mod.init_rwkv_layer(rng, cfg.d_model, cfg.d_ff,
                                        cfg.wkv_head_dim,
                                        compute_dtype(cfg), n_stack),
    }


# ---------------------------------------------------------------------------
# sub-layer apply (one layer, unstacked params; the cache is updated in
# place)
# ---------------------------------------------------------------------------


def _assign(dst: Dict, src: Dict) -> None:
    """Write a layer's new recurrent state into its cache views."""
    for key, val in src.items():
        if isinstance(val, dict):
            _assign(dst[key], val)
        elif val is not dst[key]:
            dst[key].copy_(val)


def _attend(lp: Params, x: torch.Tensor, cfg: ModelConfig, mode: str,
            cache: Dict, pos: int) -> torch.Tensor:
    """x plus the self-attention of an attn or moe layer, its keys and
    values written into ``cache``."""
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
              head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
              qk_norm=cfg.qk_norm)
    h = rms_norm(x, lp["ln1"])
    if mode == "prefill":
        out, _ = attn.prefill_self_attention(
            lp["attn"], h, cache, window=cfg.window, **kw)
    else:
        out, _ = attn.decode_self_attention(lp["attn"], h, cache, pos, **kw)
    return x + out


def _apply_attn_layer(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                      mode: str, cache: Dict, pos: int) -> torch.Tensor:
    x = _attend(lp, x, cfg, mode, cache, pos)
    return x + mlp(lp["mlp"], rms_norm(x, lp["ln2"]))


def _moe_block(lp: Params, x: torch.Tensor, cfg: ModelConfig):
    """x plus the MoE FFN of the normed x (and, for Arctic, the dense FFN
    beside it), and the router's aux loss."""
    h2 = rms_norm(x, lp["ln2"])
    ffn, aux = moe_mod.moe_ffn(lp["moe"], h2, top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor)
    if cfg.moe_dense_residual:
        ffn = ffn + mlp(lp["dense_mlp"], h2)
    return x + ffn, aux


def _apply_moe_layer(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                     mode: str, cache: Dict, pos: int) -> torch.Tensor:
    return _moe_block(lp, _attend(lp, x, cfg, mode, cache, pos), cfg)[0]


def _apply_cross_layer(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                       kv: Dict) -> torch.Tensor:
    """A gated cross-attention layer over precomputed keys and values: the
    attention scaled by tanh(gate) in float32."""
    h = rms_norm(x, lp["ln1"])
    out = attn.cross_attention(lp["attn"], h, kv, n_heads=cfg.n_heads,
                               n_kv=cfg.n_kv_heads,
                               head_dim=cfg.resolved_head_dim)
    x = x + (torch.tanh(lp["gate"]) * out.float()).to(x.dtype)
    return x + mlp(lp["mlp"], rms_norm(x, lp["ln2"]))


def _apply_rec_layer(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                     mode: str, cache: Dict, pos: int) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"])
    out, new_state = rglru_mod.rglru_block(lp["rec"], h, cache)
    _assign(cache, new_state)
    x = x + out
    return x + mlp(lp["mlp"], rms_norm(x, lp["ln2"]))


def _apply_rwkv_layer(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                      mode: str, cache: Dict, pos: int) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"])
    out, new_tm = rwkv_mod.time_mix(lp["mix"], h, cache["tm"],
                                    cfg.wkv_head_dim)
    x = x + out
    out2, new_cm = rwkv_mod.channel_mix(lp["mix"], rms_norm(x, lp["ln2"]),
                                        cache["cm_tok"])
    _assign(cache, {"tm": new_tm, "cm_tok": new_cm})
    return x + out2


def _train_attend(lp: Params, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"])
    return x + attn.self_attention(
        lp["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        window=cfg.window, qk_norm=cfg.qk_norm)


def _train_attn_layer(lp: Params, x: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    x = _train_attend(lp, x, cfg)
    return x + mlp(lp["mlp"], rms_norm(x, lp["ln2"]))


def _train_moe_layer(lp: Params, x: torch.Tensor, cfg: ModelConfig):
    return _moe_block(lp, _train_attend(lp, x, cfg), cfg)


def _train_rec_layer(lp: Params, x: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """The reference's ``_apply_rec_layer`` in train mode: no state."""
    out, _ = rglru_mod.rglru_block(lp["rec"], rms_norm(x, lp["ln1"]))
    x = x + out
    return x + mlp(lp["mlp"], rms_norm(x, lp["ln2"]))


def _train_rwkv_layer(lp: Params, x: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """The reference's ``_apply_rwkv_layer`` in train mode: no state."""
    out, _ = rwkv_mod.time_mix(lp["mix"], rms_norm(x, lp["ln1"]), None,
                               cfg.wkv_head_dim)
    x = x + out
    out2, _ = rwkv_mod.channel_mix(lp["mix"], rms_norm(x, lp["ln2"]), None)
    return x + out2


def _train_layer(fn, lp: Params, x: torch.Tensor, cfg: ModelConfig):
    """``fn(lp, x, cfg)``, a layer of the training forward. With
    ``cfg.remat`` and grad on, its activations are not kept: the backward
    runs it again (the flash forward launches twice a step)."""
    if cfg.remat and torch.is_grad_enabled():
        # the layers draw no random numbers: no RNG state to stash
        return checkpoint(fn, lp, x, cfg, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(lp, x, cfg)


def wants_grad(tree) -> bool:
    """Grad mode is on and some tensor of ``tree`` requires grad."""
    if not torch.is_grad_enabled():
        return False
    if isinstance(tree, dict):
        return any(wants_grad(v) for v in tree.values())
    return isinstance(tree, torch.Tensor) and tree.requires_grad


_SUBLAYER = {"attn": _apply_attn_layer, "moe": _apply_moe_layer,
             "rec": _apply_rec_layer, "rwkv": _apply_rwkv_layer}
_SUBINIT = {"attn": _init_attn_layer, "moe": _init_moe_layer,
            "rec": _init_rec_layer, "rwkv": _init_rwkv_layer}
_TRAIN_LAYER = {"attn": _train_attn_layer, "rec": _train_rec_layer,
                "rwkv": _train_rwkv_layer}


def _init_sub_cache(kind: str, cfg: ModelConfig, batch: int,
                    cache_len: int, device) -> Dict:
    dt = compute_dtype(cfg)
    if kind in ("attn", "moe"):
        C = min(cache_len, cfg.window) if cfg.window else cache_len
        return attn.init_kv_cache(batch, C, cfg.n_kv_heads,
                                  cfg.resolved_head_dim, dt, device)
    if kind == "rec":
        return rglru_mod.init_rec_state(batch, cfg.lru_width or cfg.d_model,
                                        dt, device)
    return rwkv_mod.init_rwkv_state(batch, cfg.d_model, cfg.wkv_head_dim,
                                    dt, device)


def _stack(tree, n: int):
    if isinstance(tree, dict):
        return {k: _stack(v, n) for k, v in tree.items()}
    return tree.expand((n,) + tree.shape).contiguous()


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


class Model:
    """Decoder-only LM over a (possibly heterogeneous) layer stack."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        if cfg.family == "hybrid" and cfg.pattern:
            pat = list(cfg.pattern)
        elif cfg.family == "ssm":
            pat = ["rwkv"]
        elif cfg.family == "moe":
            pat = ["moe"]
        else:
            pat = ["attn"]
        self.pattern = pat
        self.n_groups = cfg.n_layers // len(pat)
        self.n_rest = cfg.n_layers - self.n_groups * len(pat)

    def _trained_family(self, what: str) -> None:
        if self.cfg.family not in TRAINED_FAMILIES:
            raise NotImplementedError(
                f"{what} of the {self.cfg.family} family: {TRAINING_TODO}")

    # -- init ---------------------------------------------------------------
    def init(self, rng: Rng) -> Params:
        """Random params in the reference's layout: from a generator, on
        its device; from a threefry key of ``repro_torch.random``, the
        reference's draws (its ``split(key, 8)`` and ``fold_in`` tree), on
        the key's device."""
        cfg = self.cfg
        dt = compute_dtype(cfg)
        if not isinstance(rng, torch.Generator):
            self._trained_family("init from a threefry key")

        def fold(k, data):
            return k if isinstance(k, torch.Generator) else \
                random.fold_in(k, data)
        keys = split_rng(rng, 8)
        p: Params = {
            "embed": embed_init(keys[0], cfg.padded_vocab, cfg.d_model, dt),
            "ln_f": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                device=rng_device(rng)),
        }
        if not cfg.tie_embeddings:
            p["unembed"] = embed_init(keys[1], cfg.padded_vocab, cfg.d_model,
                                      dt)
        p["groups"] = {f"l{j}": _SUBINIT[kind](fold(keys[2], j), cfg,
                                               self.n_groups)
                       for j, kind in enumerate(self.pattern)}
        for r in range(self.n_rest):
            p[f"rest{r}"] = _SUBINIT[self.pattern[r]](fold(keys[3], r), cfg,
                                                      0)
        return p

    # -- embedding / head -----------------------------------------------------
    def _embed(self, p: Params, tokens: torch.Tensor) -> torch.Tensor:
        # F.embedding's backward gives the same bits on every run on the
        # card (two fresh training workloads agree bit for bit,
        # tests/test_torch_cuda.py)
        tokens = tokens.to(p["embed"].device).long()
        return F.embedding(tokens, p["embed"]).to(compute_dtype(self.cfg))

    def _head(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, p["ln_f"])
        table = p["embed"] if self.cfg.tie_embeddings else p["unembed"]
        return x @ table.T

    # -- train forward --------------------------------------------------------
    def forward(self, p: Params, batch: Dict):
        """Teacher-forced logits (B, S, padded vocab) and the router aux
        summed over the layers (float32 0.0 but for the moe family). The
        moe family's runs without grad only. Each layer of the stack, rest
        layers too, runs under ``_train_layer``: with ``cfg.remat`` its
        activations are recomputed in the backward."""
        if self.cfg.family != "moe" or wants_grad(p):
            self._trained_family("the training forward")
        cfg = self.cfg
        x = self._embed(p, batch["tokens"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        layers = [(_index(p["groups"], i)[f"l{j}"], kind)
                  for i in range(self.n_groups)
                  for j, kind in enumerate(self.pattern)]
        layers += [(p[f"rest{r}"], self.pattern[r])
                   for r in range(self.n_rest)]
        for lp, kind in layers:
            if cfg.family == "moe":
                x, a = _train_moe_layer(lp, x, cfg)
                aux = aux + a
            else:
                x = _train_layer(_TRAIN_LAYER[kind], lp, x, cfg)
        return self._head(p, x), aux

    def loss(self, p: Params, batch: Dict):
        logits, aux = self.forward(p, batch)
        ce = cross_entropy(logits, batch["labels"], self.cfg.vocab_size)
        return ce + self.cfg.router_aux_coef * aux, {"ce": ce, "aux": aux}

    # -- cache ----------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, device=None) -> Dict:
        """The reference's cache layout: ``groups/l{j}`` holds each layer's
        ring KV cache (attn: ``k``, ``v``, ``slot_pos``) or recurrent state
        (rec: ``h``, ``conv``; rwkv: ``tm/tok``, ``tm/wkv``, ``cm_tok``)
        with a leading ``n_groups`` axis, ``rest{r}`` the rest layers';
        ``pos`` counts the tokens seen (a Python int here)."""
        cache: Dict = {"pos": 0, "groups": {
            f"l{j}": _stack(_init_sub_cache(kind, self.cfg, batch,
                                            cache_len, device),
                            self.n_groups)
            for j, kind in enumerate(self.pattern)}}
        for r in range(self.n_rest):
            cache[f"rest{r}"] = _init_sub_cache(self.pattern[r], self.cfg,
                                                batch, cache_len, device)
        return cache

    # -- prefill / decode -------------------------------------------------------
    def _stateful(self, p: Params, x: torch.Tensor, cache: Dict, mode: str):
        cfg, pos = self.cfg, cache["pos"]
        for i in range(self.n_groups):
            gp, gc = _index(p["groups"], i), _index(cache["groups"], i)
            for j, kind in enumerate(self.pattern):
                x = _SUBLAYER[kind](gp[f"l{j}"], x, cfg, mode, gc[f"l{j}"],
                                    pos)
        for r in range(self.n_rest):
            x = _SUBLAYER[self.pattern[r]](p[f"rest{r}"], x, cfg, mode,
                                           cache[f"rest{r}"], pos)
        return x, {k: v for k, v in cache.items() if k != "pos"}

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
