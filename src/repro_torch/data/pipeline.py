"""Deterministic synthetic data pipeline: the port of
``repro/data/pipeline.py``.

Batches are a pure function of (seed, step), drawn from
``repro_torch.random``'s copy of ``jax.random``'s threefry stream on the
host, so a port node and a reference node derive the same token bits from
the same meta: the pipeline's checksum, its batches and their digests are
the reference's. The token stream is a Zipf-ish mixture with Markov
structure so the LM loss actually decreases. A vlm batch also carries
``image_embeds`` and an encdec batch ``audio_frames`` (the stubbed
encoders' outputs), normal draws in float32 cast to the model's dtype.
Tensors are on the CPU; the step moves them to its device.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict

import torch

from repro_torch import random
from repro_torch.configs.base import InputShape, ModelConfig


@dataclasses.dataclass(frozen=True)
class SyntheticTokenPipeline:
    cfg: ModelConfig
    shape: InputShape
    seed: int = 0

    def checksum(self) -> str:
        """The PNPCoin meta checksum for this data bundle."""
        h = hashlib.sha256(
            f"{self.cfg.name}|{self.shape.name}|{self.seed}".encode())
        return h.hexdigest()

    def _key(self, step: int) -> torch.Tensor:
        return random.fold_in(random.key(self.seed), step)

    def batch(self, step: int) -> Dict[str, Any]:
        """Global batch for ``step`` (pure function of seed+step)."""
        return self._batch_from_key(self._key(step))

    def microbatch(self, height: int, micro: int) -> Dict[str, Any]:
        """The chain-train stream: microbatch ``micro`` of block
        ``height``, a pure function of ``(seed, height, micro)`` keyed by a
        second ``fold_in``, so block ``h`` microstep ``m`` never aliases
        the plain ``batch(step)`` stream and a verifier re-derives the
        miner's batches from the chain position alone."""
        if micro < 0:
            raise ValueError(f"micro index must be >= 0, got {micro}")
        return self._batch_from_key(random.fold_in(self._key(height), micro))

    def _batch_from_key(self, key: torch.Tensor) -> Dict[str, Any]:
        cfg, shape = self.cfg, self.shape
        B = shape.global_batch
        S = shape.seq_len if shape.kind in ("train", "prefill") else 1
        k1, k2, k3 = random.split(key, 3)
        v = cfg.vocab_size
        # Markov-ish stream: next token = (a*tok + drift) % v with noise
        base = random.randint(k1, (B, 1), 0, v)
        drift = random.randint(k2, (B, S), 0, 16)
        toks = torch.cumsum(drift, dim=1, dtype=torch.int32) * 31 + base
        noise = random.randint(k3, (B, S), 0, v)
        mix = random.bernoulli(k3, 0.05, (B, S))
        tokens = torch.where(mix, noise, torch.remainder(toks, v)) \
            .to(torch.int32)
        out: Dict[str, Any] = {"tokens": tokens}
        if shape.kind == "train":
            out["labels"] = torch.cat(
                [tokens[:, 1:], torch.full((B, 1), -1, dtype=torch.int32)],
                dim=1)
        dtype = getattr(torch, cfg.dtype)
        if cfg.family == "vlm" and shape.kind != "decode":
            out["image_embeds"] = random.normal(
                random.fold_in(key, 7),
                (B, cfg.n_img_tokens, cfg.d_vision)).to(dtype)
        if cfg.family == "encdec" and shape.kind != "decode":
            out["audio_frames"] = random.normal(
                random.fold_in(key, 8),
                (B, cfg.n_enc_tokens, cfg.d_model)).to(dtype)
        return out
