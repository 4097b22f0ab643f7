"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1:2.

[arXiv:2402.19427] De et al., "Griffin: Mixing Gated Linear Recurrences
with Local Attention". 26 layers, d_model=2560, 10 heads (MQA kv=1),
d_ff=7680, vocab=256000. Pattern (rec, rec, attn): two RG-LRU recurrent
blocks per local-attention block; local attention window 2048.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    pattern=("rec", "rec", "attn"),
    lru_width=2560,
    window=2048,
    rope_theta=10_000.0,
    tie_embeddings=True,
    citation="arXiv:2402.19427",
))
