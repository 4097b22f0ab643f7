"""qwen3-0.6b [dense]: qk-norm, GQA. [hf:Qwen/Qwen3-8B family]

28 layers, d_model=1024, 16 heads (GQA kv=8), head_dim=128 (explicit,
larger than d_model/n_heads per the Qwen3 card), d_ff=3072, vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    citation="hf:Qwen/Qwen3-8B",
))
