"""Zamba2-7B  [arXiv:2411.15242] — hybrid Mamba2 + shared attention blocks.

81L d_model=3584 32H (kv=32, i.e. MHA on the shared block) d_ff=14336
vocab=32000, ssm_state=64.  A single shared transformer block is applied
every ``attn_every`` Mamba2 layers (zamba2 signature: shared weights).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14_336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,            # 81 layers -> 13 shared-attn applications
    rope_theta=10_000.0,
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="zamba2-7b-reduced", num_layers=4, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=256, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=16, attn_every=2)
