"""llama-3.2-vision-11b [vlm]: cross-attn image layers.

[hf:meta-llama/Llama-3.2-11B-Vision]  40 layers, d_model=4096, 32 heads
(GQA kv=8), d_ff=14336, vocab=128256. A cross-attention layer to the
image tokens every 5th layer (8 total), scanned as 8 groups of
(4 self + 1 cross). The ViT vision encoder is stubbed: the batch
carries patch embeddings (B, 1601, d_vision=1280); the model owns only
the linear projector into d_model.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_every=5,
    n_img_tokens=1601,
    d_vision=1280,
    rope_theta=500_000.0,
    citation="hf:meta-llama/Llama-3.2-11B-Vision",
))
