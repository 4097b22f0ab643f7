"""stablelm-1.6b [dense]: [hf:stabilityai/stablelm-2-1_6b].

24 layers, d_model=2048, 32 heads (GQA kv=32 == MHA), d_ff=5632,
vocab=100352. ``long_500k`` runs with the sliding-window attention
variant (window 8192, ``models/model.py`` ``adapt_for_shape``).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    rope_theta=10_000.0,
    citation="hf:stabilityai/stablelm-2-1_6b",
))
