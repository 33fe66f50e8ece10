"""Cost models registered via the ``cost()`` primitive (paper §4.2).

They estimate per-sample compute from METADATA ONLY (token counts), which
is what makes load-time balancing possible.  Coefficients derive from the
target architecture's config, so the same planner program serves every
assigned arch; for attention-free archs (rwkv6) the quadratic term is 0 and
balancing degenerates to token-count balancing (DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class QuadraticCost:
    """flops(sample) ~ a * l + b * l^2  per packed subsequence of length l.

    a: per-token matmul work (6*N_active/layer-ish); b: attention term
    12 * L * d per token-pair (fwd 4*l^2*d per layer incl qk+av, x3 bwd).
    """
    a: float
    b: float
    name: str = "quadratic"

    def __call__(self, meta: dict) -> float:
        l = meta.get("text_tokens", 0) + meta.get("image_tokens", 0)
        return self.a * l + self.b * l * l


@dataclasses.dataclass(frozen=True)
class LinearCost:
    a: float
    name: str = "linear"

    def __call__(self, meta: dict) -> float:
        l = meta.get("text_tokens", 0) + meta.get("image_tokens", 0)
        return self.a * l


@dataclasses.dataclass(frozen=True)
class EncoderCost:
    """Vision/audio encoder: quadratic in per-image patch count (NaViT
    packs images, so cost follows sum p_i^2 over images in the batch)."""
    a: float
    b: float
    name: str = "encoder"

    def __call__(self, meta: dict) -> float:
        p = meta.get("image_tokens", 0)
        return self.a * p + self.b * p * p


def active_params(cfg: ModelConfig) -> float:
    """Rough active-parameter count per token (backbone only)."""
    d, L = cfg.d_model, cfg.num_layers
    hd = cfg.resolved_head_dim()
    attn = d * (cfg.num_heads * hd + 2 * cfg.num_kv_heads * hd) \
        + cfg.num_heads * hd * d
    if cfg.num_experts > 0:
        ffn = 3 * d * cfg.d_ff * cfg.experts_per_token
    else:
        ffn = 3 * d * cfg.d_ff
    return L * (attn + ffn)


def backbone_cost(cfg: ModelConfig) -> Callable[[dict], float]:
    """Default cost model for a backbone config (what `cost()` registers)."""
    n = active_params(cfg)
    if cfg.family == "ssm":               # attention-free: linear
        return LinearCost(a=6.0 * n)
    b = 12.0 * cfg.num_layers * cfg.d_model
    if cfg.family == "hybrid":            # attention on 1/attn_every layers
        b = 12.0 * (cfg.num_layers // max(cfg.attn_every, 1)) * cfg.d_model
    return QuadraticCost(a=6.0 * n, b=b)


def encoder_cost(num_layers: int, d_model: int) -> EncoderCost:
    n = num_layers * 12 * d_model * d_model  # dense ViT block params approx
    return EncoderCost(a=6.0 * n / max(d_model, 1), b=12.0 * num_layers
                       * d_model)


def microbatch_cost(segment_lengths: list[int], costfn) -> float:
    """Cost of one packed row = sum of per-segment costs (block-diagonal
    attention => no cross terms; this is exactly what the Pallas
    segment-kernel computes)."""
    return float(sum(costfn({"text_tokens": l}) for l in segment_lengths))
