"""Model configs and the registry of archs this port runs.

The port's own copy of ``repro.configs.base.ModelConfig``, so it imports
nothing of ``repro``.  It holds only the fields the ported code reads, with
the JAX package's names and defaults; the rest come with the slice that
reads them.  The registry lists only the archs whose model code has been
ported; asking for any other arch raises a ``KeyError`` that points at
``ROADMAP.md``, where the rest are queued.
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
    # only so that a MoE config is refused; the MoE layers are not ported
    num_experts: int = 0
    # read by the data plane's cost model (data/cost_models.py)
    experts_per_token: int = 0
    attn_every: int = 0          # hybrid: shared attention every N layers
    # --- rwkv6 ---
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 64
    rwkv_lora_dim: int = 64

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


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    key = name.replace("_", "-")
    if key not in _REGISTRY:
        raise KeyError(
            f"arch {name!r} is not ported to repro_torch yet (ported: "
            f"{sorted(_REGISTRY)}); see ROADMAP.md for the port's queue")
    return _REGISTRY[key]


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


# Config modules of the archs this port runs.
_PORTED = ["qwen3_8b", "rwkv6_3b"]

_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    import importlib
    for mod in _PORTED:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True
