"""The paper's own backbone configurations (Table 1).

OVERLORD evaluates VLMs = {ViT-1B, ViT-2B} encoder x {Llama-12B, tMoE-25B,
Mixtral-8x7B} backbone.  The backbones are selectable archs and the
encoders are described by their cost models only (the encoder frontend is
a patch-embedding stub: ``image_embeds`` arrive at backbone width).
"""
from repro_torch.configs.base import ModelConfig, register

LLAMA_12B = register(ModelConfig(
    name="paper-llama-12b",
    family="vlm",
    num_layers=45,
    d_model=4608,
    num_heads=36,
    num_kv_heads=36,
    d_ff=4608 * 4,
    vocab_size=128_256,
    image_token_frac=0.25,
    rope_theta=500_000.0,
))

TMOE_25B = register(ModelConfig(
    name="paper-tmoe-25b",
    family="moe",
    num_layers=42,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2048 * 4,
    vocab_size=128_256,
    num_experts=16,
    experts_per_token=2,
))

MIXTRAL_8X7B = register(ModelConfig(
    name="paper-mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=32_000,
    num_experts=8,
    experts_per_token=2,
    rope_theta=1_000_000.0,
))

# Encoder cost descriptors (#layers, #heads, hidden) for the data-plane cost
# models; see data/cost_models.py.
VIT_1B = dict(name="vit-1b", num_layers=39, num_heads=16, d_model=1408)
VIT_2B = dict(name="vit-2b", num_layers=48, num_heads=16, d_model=1664)


def reduced() -> ModelConfig:
    return LLAMA_12B.replace(
        name="paper-llama-12b-reduced", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256)
