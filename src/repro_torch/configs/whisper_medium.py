"""whisper-medium [audio]: enc-dec, conv/mel frontend stubbed.

[arXiv:2212.04356] Radford et al., "Robust Speech Recognition via
Large-Scale Weak Supervision". 24 enc + 24 dec layers, d_model=1024,
16 heads (kv=16), d_ff=4096, vocab=51865 (padded to 51968 for sharding).
The mel-spectrogram + conv feature extractor is a stub: the batch
carries post-conv frame embeddings (B, 1500, d_model) directly.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,              # decoder layers
    n_enc_layers=24,
    n_enc_tokens=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    rope_theta=0.0,           # whisper uses learned/sinusoidal pos, not rope
    citation="arXiv:2212.04356",
    notes="long_500k skipped: enc-dec full-attention decoder with a "
          "by-design 448-token context; see DESIGN.md §4.",
))
