"""Yi-9B  [arXiv:2403.04652].

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000, llama-arch GQA.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11_008,
    vocab_size=64_000,
    rope_theta=10_000.0,
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="yi-9b-reduced", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=256)
