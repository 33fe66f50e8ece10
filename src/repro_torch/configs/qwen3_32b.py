"""Qwen3-32B  [hf:Qwen/Qwen3 family].

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, qk_norm.
head_dim = d_model/num_heads = 80 per the assigned config.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    d_ff=25_600,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-32b-reduced", num_layers=2, d_model=64, num_heads=8,
        num_kv_heads=2, d_ff=160, vocab_size=256)
