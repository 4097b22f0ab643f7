"""arctic-480b [moe]: 128 experts top-2 with a parallel dense residual FFN.

[hf:Snowflake/snowflake-arctic-base]  35 layers, d_model=7168, 56 heads
(GQA kv=8), d_ff=4864 (dense residual and per-expert), vocab=32000.
Dense-MoE hybrid: every layer computes dense_ffn(x) + moe(x). Its
~960 GB of bf16 weights do not fit one card: the port runs it reduced.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    citation="hf:Snowflake/snowflake-arctic-base",
))
