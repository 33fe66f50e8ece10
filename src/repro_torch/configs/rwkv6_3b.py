"""RWKV6-3B "Finch"  [arXiv:2404.05892]: attention-free, data-dependent decay.

32L d_model=2560 d_ff=8960 vocab=65536.  WKV heads of size 64 -> 40 heads.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,            # d_model / rwkv_head_dim
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65_536,
    rwkv_head_dim=64,
    rwkv_chunk=64,
    rwkv_lora_dim=64,
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="rwkv6-3b-reduced", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=256, rwkv_head_dim=16,
        rwkv_chunk=16, rwkv_lora_dim=8)
