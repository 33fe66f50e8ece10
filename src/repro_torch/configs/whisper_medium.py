"""Whisper-medium  [arXiv:2212.04356] — encoder-decoder audio model.

24L (x2: encoder+decoder) d_model=1024 16H (kv=16, MHA) d_ff=4096
vocab=51865.  The conv frontend is a STUB: the batch carries precomputed
frame embeddings (1500 frames = 30s audio), per the assignment.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,           # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51_865,
    encoder_frames=1500,
    rope_theta=10_000.0,     # RoPE instead of learned absolute positions,
                             # as in the JAX package
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-medium-reduced", num_layers=2, encoder_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
        encoder_frames=24)
