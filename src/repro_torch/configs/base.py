"""Model and input-shape configs: the port's copy of
``repro/configs/base.py`` (plain dataclasses, no tensor code).

``get_config(name)`` resolves from the registry; ``reduced(cfg)`` gives the
small CPU variant (2 layers, d_model <= 256, head_dim 32) the tests use.
Every config of the reference is registered: the model zoo the port
serves, and ``pnpcoin-demo`` (the chain's training payload).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Field names, order and defaults equal the reference's, so a config
    carries over with ``ModelConfig(**dataclasses.asdict(ref_cfg))``."""
    name: str
    family: str                      # dense | moe | encdec | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qk_norm: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25

    # --- hybrid (recurrentgemma) ---
    pattern: Tuple[str, ...] = ()
    lru_width: int = 0
    window: int = 0                  # sliding attention window (0 -> full)

    # --- ssm (rwkv6) ---
    wkv_head_dim: int = 64

    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    n_enc_tokens: int = 1500

    # --- vlm (llama-3.2-vision) ---
    cross_attn_every: int = 0
    n_img_tokens: int = 0
    d_vision: int = 0

    # --- sharding policy (read by the reference's mesh code only) ---
    fsdp: bool = True
    fsdp_pod: bool = False
    constrain_kv: bool = False
    expert_axis: str = "model"

    # --- numerics / training ---
    dtype: str = "bfloat16"
    opt_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    rope_theta: float = 1_000_000.0
    tie_embeddings: bool = False

    # --- bookkeeping ---
    citation: str = ""
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128; logits beyond
        ``vocab_size`` are never picked."""
        return 128 * math.ceil(self.vocab_size / 128)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load_all() -> None:
    import importlib
    for mod in ("whisper_medium", "arctic_480b", "stablelm_1_6b",
                "qwen3_0_6b", "qwen3_8b", "olmoe_1b_7b", "stablelm_3b",
                "llama_3_2_vision_11b", "recurrentgemma_2b", "rwkv6_7b",
                "pnpcoin_demo"):
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """The reference's smoke-test variant: 2 layers, d_model <= 256,
    head_dim 32, d_ff <= 512, vocab <= 1024, float32."""
    d = min(cfg.d_model, 256)
    hd = 32
    n_heads = max(2, min(cfg.n_heads, d // hd))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    if n_heads % n_kv:
        n_kv = 1
    changes = dict(
        name=cfg.name + "-smoke",
        n_layers=2 if not cfg.pattern else len(cfg.pattern),
        d_model=d,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=hd,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 1024),
        remat=False,
        dtype="float32",
    )
    if cfg.n_experts:
        changes["n_experts"] = min(cfg.n_experts, 4)
        changes["top_k"] = min(cfg.top_k, 2)
        changes["capacity_factor"] = float(changes["n_experts"])
    if cfg.lru_width:
        changes["lru_width"] = d
    if cfg.window:
        changes["window"] = 64
    if cfg.n_enc_layers:
        changes["n_enc_layers"] = 2
        changes["n_enc_tokens"] = 16
    if cfg.cross_attn_every:
        changes["n_layers"] = 2 * cfg.cross_attn_every
        changes["n_img_tokens"] = 8
        changes["d_vision"] = 64
    if cfg.family == "ssm":
        changes["wkv_head_dim"] = 32
    return dataclasses.replace(cfg, **changes)
