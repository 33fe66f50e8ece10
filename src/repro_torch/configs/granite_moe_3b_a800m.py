"""Granite-MoE-3B-A800M  [hf:ibm-granite/granite-3.0 family].

32L d_model=1536 24H (GQA kv=8) per-expert d_ff=512 vocab=49155,
MoE 40 experts top-8, tied embeddings.  (The JAX package's header notes
that its source says both 40 and 32 experts; it follows the structured
field, 40, and so does the port.)
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,                # per-expert intermediate size
    vocab_size=49_155,
    num_experts=40,
    experts_per_token=8,
    rope_theta=10_000.0,
    tied_embeddings=True,
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="granite-moe-3b-a800m-reduced", num_layers=2, d_model=48,
        num_heads=6, num_kv_heads=2, d_ff=64, vocab_size=256,
        num_experts=5, experts_per_token=2)
