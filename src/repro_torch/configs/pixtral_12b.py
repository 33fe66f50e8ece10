"""Pixtral-12B  [hf:mistralai/Pixtral-12B-2409] — VLM.

Backbone (mistral-nemo-like): 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072.  The pixtral-ViT frontend is a stub, as in the JAX package:
precomputed patch embeddings at backbone width are fused into the token
sequence at given positions (``models.transformer._embed_inputs``).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,            # mistral-nemo uses head_dim 128
    d_ff=14_336,
    vocab_size=131_072,
    image_token_frac=0.25,   # 25% of sequence positions carry patch embeds
    rope_theta=1_000_000.0,
))


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="pixtral-12b-reduced", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)
