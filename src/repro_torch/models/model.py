"""``build_model``: config -> model (the dense, hybrid and ssm families),
and the per-shape config adaptation and cache length of
``repro/models/model.py``."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import InputShape, ModelConfig

# sliding-window width a dense arch uses for the 500k-token decode
LONG_CONTEXT_WINDOW = 8192


def build_model(cfg: ModelConfig):
    from repro_torch.models.transformer import Model
    return Model(cfg)


def adapt_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Dense/vlm archs get the sliding-window variant for long_500k."""
    if shape.name == "long_500k" and cfg.family in ("dense", "vlm") \
            and not cfg.window:
        return dataclasses.replace(cfg, window=LONG_CONTEXT_WINDOW)
    return cfg


def cache_len_for(cfg: ModelConfig, shape: InputShape) -> int:
    """The attention cache's length: the window caps it (recurrentgemma:
    2048), else the whole sequence."""
    if cfg.window:
        return min(shape.seq_len, cfg.window)
    return shape.seq_len
