"""Qwen3-MoE-30B-A3B  [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4) per-expert d_ff=768 vocab=151936,
MoE 128 experts top-8, qk_norm (qwen3 family).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,            # qwen3 family uses head_dim 128
    d_ff=768,                # per-expert intermediate size
    vocab_size=151_936,
    num_experts=128,
    experts_per_token=8,
    qk_norm=True,
    rope_theta=1_000_000.0,
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-moe-30b-a3b-reduced", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=96, vocab_size=256,
        num_experts=8, experts_per_token=2)
