"""Model configs and the registry of archs this port runs.

The port's own copy of ``repro.configs.base.ModelConfig``, so it imports
nothing of ``repro``.  It holds only the fields the ported code reads, with
the JAX package's names and defaults (its kv-chunk, layer-scan and Pallas
knobs have no counterpart here).  ``remat`` picks what the training forward
keeps for the backward, as in the JAX package: ``"layer"`` (the default)
recomputes each layer, ``"dots_saveable"`` keeps the matmul outputs of each
layer and recomputes the rest, ``"none"`` keeps every activation.  ``dtype``
is read only by ``analysis.config_lint``; the compute dtype does not follow
it.  The registry holds every arch of the JAX package's; asking for any
other raises a ``KeyError``.  ``SHAPES``, ``shape_applicable`` and
``assigned_archs`` are the reference's dry-run cells, with its values.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | vlm | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    tied_embeddings: bool = False
    # --- moe (models/moe.py; experts_per_token is also read by the data
    # plane's cost model, data/cost_models.py) ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # --- hybrid (Mamba2, models/ssm.py and models/hybrid.py) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0          # hybrid: shared attention every N layers
    # --- rwkv6 ---
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 64
    rwkv_lora_dim: int = 64
    # --- encoder-decoder (whisper, models/encdec.py) ---
    encoder_layers: int = 0
    encoder_frames: int = 1500   # whisper: 30s audio -> 1500 frames (stub)
    # --- vlm ---
    image_token_frac: float = 0.0  # fraction of sequence that is image embeds
    # --- numerics / performance knobs ---
    dtype: str = "bfloat16"
    remat: str = "layer"         # none | layer | dots_saveable

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim()

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim()

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

# long_500k needs sub-quadratic attention: only SSM / hybrid families run it
# (see DESIGN.md §4); everything else records an explicit skip.
_SUBQUADRATIC_FAMILIES = ("hybrid", "ssm")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family not in _SUBQUADRATIC_FAMILIES:
        return False, "long_500k skipped: quadratic full attention (DESIGN.md §4)"
    return True, ""


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    key = name.replace("_", "-")
    if key not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


# Config modules of the archs this port runs: all of the JAX package's.
_PORTED = ["qwen3_8b", "rwkv6_3b", "pixtral_12b", "paper_vlm",
           "qwen3_moe_30b_a3b", "granite_moe_3b_a800m", "yi_9b",
           "granite_20b", "qwen3_32b", "zamba2_7b", "whisper_medium"]

_ASSIGNED = [
    "qwen3_moe_30b_a3b", "granite_moe_3b_a800m", "granite_20b", "qwen3_8b",
    "yi_9b", "qwen3_32b", "zamba2_7b", "pixtral_12b", "whisper_medium",
    "rwkv6_3b",
]


def assigned_archs() -> list[str]:
    _ensure_loaded()
    return [a.replace("_", "-") for a in _ASSIGNED]


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    import importlib
    for mod in _PORTED:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True
