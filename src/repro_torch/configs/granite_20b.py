"""Granite-20B (code)  [arXiv:2405.04324].

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152, llama-arch.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,          # MQA
    d_ff=24_576,
    vocab_size=49_152,
    rope_theta=10_000.0,
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="granite-20b-reduced", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=1, d_ff=160, vocab_size=256)
