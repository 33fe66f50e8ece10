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
the ssm family, RWKV6 (``models.rwkv_model``).  ``build_meta_model``,
``input_specs`` and ``batch_logical_axes`` give the dry-run
(``launch.dryrun``) a model and a batch of meta tensors, the port's
counterpart of the reference's ``ShapeDtypeStruct`` stand-ins;
``distribute_model`` makes a model's leaves DTensors for a sharded step.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import params as pdefs
from repro_torch.models import encdec, hybrid, rwkv_model, transformer
from repro_torch.sharding.logical import (
    TRAIN_RULES, ShardingRules, distribute,
)

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

    def cache_axes(self) -> dict:
        """The logical axes of ``init_cache``'s tree, leaf by leaf."""
        return self._mod.cache_logical_axes(self.cfg)


def distribute_model(model: Model, mesh, mapping=None) -> ShardingRules:
    """Make every leaf of ``model`` a DTensor on ``mesh`` (a DeviceMesh),
    placed by the spec ``mapping`` (``TRAIN_RULES`` by default) gives its
    logical axes, as ``sharding.param_shardings`` resolves them.  Returns
    the rules, with the fallbacks they recorded."""
    rules = ShardingRules(mesh, TRAIN_RULES if mapping is None else mapping)
    specs = dict(pdefs.tree_leaves(pdefs.logical_specs(model_defs(model.cfg))))
    for name, p in pdefs.tree_leaves(model.tree()):
        owner, _, leaf = name.rpartition(".")
        spec = rules.spec(specs[name], tuple(p.shape))
        setattr(model.get_submodule(owner), leaf, nn.Parameter(
            distribute(p.detach(), spec, mesh),
            requires_grad=p.requires_grad))
    return rules


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
    """A model with weights drawn from ``generator``, on its device, held
    as a model computing in ``dtype`` holds them (``params.init_param``:
    float32 leaves of rank > 1 in ``dtype``, the rest as drawn)."""
    defs = model_defs(cfg)
    return Model(cfg, pdefs.init_params(defs, generator, dtype,
                                        generator.device))


def build_meta_model(cfg: ModelConfig, dtype=torch.float32) -> Model:
    """A model whose leaves are meta tensors (each of its ParamDef's own
    dtype if it has one, else ``dtype``): shapes and dtypes, no storage."""
    return Model(cfg, pdefs.abstract_params(model_defs(cfg), dtype))


# ----------------------------------------------------------- input specs
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta stand-ins for every model input of this cell.

    train/prefill: a packed token batch (+ modality stubs).
    decode: one new token; the KV cache is built separately by
    ``Model.init_cache`` on a meta model.
    """
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        return {"tokens": _meta((b, 1), i32)}

    batch = {
        "tokens": _meta((b, s), i32),
        "segment_ids": _meta((b, s), i32),
        "positions": _meta((b, s), i32),
    }
    if shape.kind == "train":
        batch["labels"] = _meta((b, s), i32)
    if cfg.family == "vlm" and cfg.image_token_frac > 0:
        n_img = int(s * cfg.image_token_frac)
        batch["image_embeds"] = _meta((b, n_img, cfg.d_model), torch.bfloat16)
        batch["image_positions"] = _meta((b, n_img), i32)
    if cfg.family == "audio":
        batch["enc_embeds"] = _meta((b, cfg.encoder_frames, cfg.d_model),
                                    torch.bfloat16)
    return batch


def batch_logical_axes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Logical sharding axes mirroring ``input_specs``."""
    if shape.kind == "decode":
        return {"tokens": ("batch", None)}
    axes = {
        "tokens": ("batch", "seq"),
        "segment_ids": ("batch", "seq"),
        "positions": ("batch", "seq"),
    }
    if shape.kind == "train":
        axes["labels"] = ("batch", "seq")
    if cfg.family == "vlm" and cfg.image_token_frac > 0:
        axes["image_embeds"] = ("batch", "seq", "act_embed")
        axes["image_positions"] = ("batch", "seq")
    if cfg.family == "audio":
        axes["enc_embeds"] = ("batch", "seq", "act_embed")
    return axes
