"""The model as an ``nn.Module``: the port of ``repro.models.model_zoo``.

``Model`` holds the parameter tree as parameters whose ``state_dict`` keys
are the JAX tree's key paths joined by ``.`` (``embed.table``,
``layers.attn.wq``, ...), with the stacked ``layers`` dim kept, so the
weight bridge is one to one.  They are built frozen (``requires_grad``
off), as serving wants; ``train.train_step.init_train_state`` turns
``requires_grad`` on with ``Model.requires_grad_``.  All five families of
the JAX package are ported: dense, and the moe and vlm families, which it
builds as transformers (``models.transformer``); the Mamba2 hybrid
(``models.hybrid``); the Whisper encoder-decoder (``models.encdec``); and
the ssm family, RWKV6 (``models.rwkv_model``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as pdefs
from repro_torch.models import encdec, hybrid, rwkv_model, transformer

# family -> the module of its forward / prefill / decode_step / init_cache,
# and its ParamDef tree
_FAMILIES = {"dense": (transformer, transformer.lm_defs),
             "moe": (transformer, transformer.lm_defs),
             "vlm": (transformer, transformer.lm_defs),
             "hybrid": (hybrid, hybrid.hybrid_defs),
             "audio": (encdec, encdec.encdec_defs),
             "ssm": (rwkv_model, rwkv_model.rwkv_defs)}


class ParamTree(nn.Module):
    """A nested dict of tensors held as parameters named by key path."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def tree(self) -> dict:
        """The nested dict of parameter tensors (no copies)."""
        out = dict(self.named_parameters(recurse=False))
        out.update({n: m.tree() for n, m in self.named_children()})
        return out


class Model(ParamTree):
    """An LM of a ported family: parameters plus the forward / prefill /
    decode steps of ``repro.models.model_zoo.build_model``'s mapping."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg
        self._mod = _family(cfg)[0]

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def forward(self, batch, params: dict | None = None):
        """Packed batch -> (logits, aux loss), on ``params`` (a tree shaped
        like ``self.tree()``, e.g. the train step's bf16 copy) or else on
        the model's own leaves."""
        return self._mod.forward(self.tree() if params is None else params,
                                 self.cfg, batch)

    def prefill(self, batch):
        """Prompt -> (last-token logits, cache)."""
        return self._mod.prefill(self.tree(), self.cfg, batch)

    def decode_step(self, cache, tokens, pos: int):
        return self._mod.decode_step(self.tree(), self.cfg, cache, tokens,
                                     pos)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        return self._mod.init_cache(self.cfg, batch, max_len, dtype,
                                    self.device)


def _family(cfg: ModelConfig) -> tuple:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r} "
                         f"(known: {sorted(_FAMILIES)})")
    return _FAMILIES[cfg.family]


def model_defs(cfg: ModelConfig) -> dict:
    """The ParamDef tree of ``cfg`` (shapes only, nothing allocated)."""
    return _family(cfg)[1](cfg)


def build_model(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32) -> Model:
    """A model with weights drawn from ``generator``, on its device."""
    defs = model_defs(cfg)
    return Model(cfg, pdefs.init_params(defs, generator, dtype,
                                        generator.device))
