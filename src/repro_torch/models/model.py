"""``build_model``: config -> model (family dispatch), and the per-shape
config adaptation, shape support and cache length of
``repro/models/model.py``."""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs.base import InputShape, ModelConfig

# sliding-window width a dense arch uses for the 500k-token decode
LONG_CONTEXT_WINDOW = 8192


def build_model(cfg: ModelConfig):
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecModel
        return EncDecModel(cfg)
    if cfg.family == "vlm":
        from repro_torch.models.vlm import VLMModel
        return VLMModel(cfg)
    from repro_torch.models.transformer import Model
    return Model(cfg)


def adapt_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Dense/vlm archs get the sliding-window variant for long_500k."""
    if shape.name == "long_500k" and cfg.family in ("dense", "vlm") \
            and not cfg.window:
        return dataclasses.replace(cfg, window=LONG_CONTEXT_WINDOW)
    return cfg


def supports_shape(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether ``cfg`` runs ``shape``, and why not: the encoder-decoder's
    full-attention decoder has a context of a few hundred tokens by design
    and skips long_500k."""
    if shape.name == "long_500k" and cfg.family == "encdec":
        return False, ("enc-dec full-attention decoder with by-design tiny "
                       "context; skip noted in DESIGN.md §4")
    return True, ""


def cache_len_for(cfg: ModelConfig, shape: InputShape) -> int:
    """The attention cache's length: the window caps it (recurrentgemma:
    2048), else the whole sequence."""
    if cfg.window:
        return min(shape.seq_len, cfg.window)
    return shape.seq_len
