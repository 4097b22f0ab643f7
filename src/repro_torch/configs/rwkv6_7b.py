"""rwkv6-7b [ssm]: Finch, attention-free, data-dependent decay.

[arXiv:2404.05892] Peng et al., "Eagle and Finch: RWKV with Matrix-Valued
States and Dynamic Recurrence". 32 layers, d_model=4096 (64 wkv heads of
size 64), d_ff=14336, vocab=65536. Decode state is O(1) in sequence
length.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,                # wkv heads = d_model / wkv_head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    wkv_head_dim=64,
    citation="arXiv:2404.05892",
))
