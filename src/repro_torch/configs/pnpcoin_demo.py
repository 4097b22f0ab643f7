"""pnpcoin-demo: the chain's own training payload, a ~2M-parameter dense
LM (2 layers, d_model 256, GQA 8/4, qk-norm, tied embeddings, float32),
trained as proof of useful work one block at a time.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="pnpcoin-demo",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=4,
    d_ff=768,
    vocab_size=2048,
    qk_norm=True,
    tie_embeddings=True,
    remat=False,
    dtype="float32",
    citation="this work (PNPCoin reproduction demo payload)",
))
