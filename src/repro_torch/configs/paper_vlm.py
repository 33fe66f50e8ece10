"""The paper's own backbone configurations (Table 1), as far as ported.

OVERLORD evaluates VLMs = {ViT-1B, ViT-2B} encoder x {Llama-12B, tMoE-25B,
Mixtral-8x7B} backbone.  The backbones are selectable archs and the
encoders are described by their cost models only (the encoder frontend is
a patch-embedding stub: ``image_embeds`` arrive at backbone width).  Only
the dense backbone, paper-llama-12b, is registered here: the two MoE
backbones wait for the MoE block (see ROADMAP.md).
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

# Encoder cost descriptors (#layers, #heads, hidden) for the data-plane cost
# models; see data/cost_models.py.
VIT_1B = dict(name="vit-1b", num_layers=39, num_heads=16, d_model=1408)
VIT_2B = dict(name="vit-2b", num_layers=48, num_heads=16, d_model=1664)


def reduced() -> ModelConfig:
    return LLAMA_12B.replace(
        name="paper-llama-12b-reduced", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256)
