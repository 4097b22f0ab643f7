"""qwen3-8b [dense]: qk_norm, GQA. [hf:Qwen/Qwen3-8B]

36 layers, d_model=4096, 32 heads (GQA kv=8), head_dim=128, d_ff=12288,
vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    citation="hf:Qwen/Qwen3-8B",
))
