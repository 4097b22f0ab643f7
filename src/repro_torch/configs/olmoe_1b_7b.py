"""olmoe-1b-7b [moe]: 64 experts top-8. [arXiv:2409.02060]

16 layers, d_model=2048, 16 heads (GQA kv=16), per-expert d_ff=1024,
vocab=50304. 1B active / 7B total parameters.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    top_k=8,
    qk_norm=True,
    citation="arXiv:2409.02060",
))
