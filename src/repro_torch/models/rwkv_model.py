"""RWKV6 LM assembly: embed -> ln0 -> [timemix + channelmix] x L -> head.

The port of ``repro.models.rwkv_model``, plus the ssm family's ``prefill``
that ``repro.models.model_zoo.build_model`` defines.  Layers keep the JAX
package's stacked leaves (leading ``layers`` dim); the scan over them is a
Python loop over views, as in ``models.transformer``.  On the card each layer's
time mix runs the WKV6 CUDA kernel (``kernels.ops.wkv6``) in ``forward``;
``decode_step`` is the one-token recurrence in plain tensor ops.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import rwkv
from repro_torch.models.params import EMBED, VOCAB, ParamDef, stacked, tree_map
from repro_torch.models.remat import remat, whole_layer
from repro_torch.sharding.logical import shard


def rwkv_defs(cfg: ModelConfig) -> dict:
    layer = {
        "tm": rwkv.rwkv6_timemix_def(cfg),
        "cm": rwkv.rwkv6_channelmix_def(cfg),
    }
    return {
        "embed": L.embedding_def(cfg.vocab_size, cfg.d_model),
        "ln0": L.layernorm_def(cfg.d_model),
        "layers": stacked(layer, cfg.num_layers),
        "final_norm": L.layernorm_def(cfg.d_model),
        "unembed": ParamDef((cfg.d_model, cfg.vocab_size), (EMBED, VOCAB),
                            init="scaled"),
    }


def _layer(params, i: int) -> dict:
    """Layer ``i``'s leaves: views into the stacked tensors."""
    return tree_map(lambda t: t[i], params["layers"])


def _head(params, cfg, h):
    h = L.layernorm(params["final_norm"], h, cfg.norm_eps)
    return h @ params["unembed"]


def forward(params, cfg: ModelConfig, batch, return_state: bool = False):
    """batch: tokens/segment_ids (b, s) int32 tensors.  Returns (logits
    (b, s, vocab), 0) or, with ``return_state``, (logits, the states stacked
    over layers: tm_shift and cm_shift (L, b, 1, d) in the activations'
    dtype, wkv (L, b, h, dk, dk) float32).  Without ``return_state``, each
    layer is checkpointed under grad unless ``cfg.remat`` is ``"none"``, as
    in JAX."""
    seg = batch["segment_ids"]
    h = L.embed(params["embed"], batch["tokens"])
    h = L.layernorm(params["ln0"], h, cfg.norm_eps)
    h = shard(h, "batch", "seq", "act_embed")
    states = []

    def layer_fn(h, lp):
        h = h + rwkv.rwkv6_timemix_train(lp["tm"], cfg, h, seg)
        h = h + rwkv.rwkv6_channelmix_train(lp["cm"], cfg, h)
        return shard(h, "batch", "seq", "act_embed")

    body = remat(layer_fn, whole_layer(cfg.remat))
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        if return_state:
            tm_out, st = rwkv.rwkv6_timemix_train(lp["tm"], cfg, h, seg,
                                                  return_state=True)
            h = h + tm_out
            # the row's last position, padding or not, as in JAX
            st["cm_shift"] = L.layernorm(lp["cm"]["ln"], h,
                                         cfg.norm_eps)[:, -1:]
            h = h + rwkv.rwkv6_channelmix_train(lp["cm"], cfg, h)
            states.append(st)
        else:
            h = body(h, lp)
    logits = shard(_head(params, cfg, h), "batch", "seq", "act_vocab")
    if return_state:
        return logits, {n: torch.stack([st[n] for st in states])
                        for n in ("tm_shift", "cm_shift", "wkv")}
    return logits, torch.zeros((), dtype=torch.float32, device=h.device)


# ---------------------------------------------------------------- serving
def prefill(params, cfg: ModelConfig, batch):
    """``forward`` with its states; the last position's logits (b, 1, vocab)
    and the stacked states, as ``repro.models.model_zoo.build_model`` maps
    the ssm family's prefill."""
    logits, states = forward(params, cfg, batch, return_state=True)
    return logits[:, -1:], states


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    del max_len  # constant-size state: the point of an SSM
    d = cfg.d_model
    dk = cfg.rwkv_head_dim
    h = d // dk
    n = cfg.num_layers
    return {
        "tm_shift": torch.zeros((n, batch, 1, d), dtype=dtype, device=device),
        "cm_shift": torch.zeros((n, batch, 1, d), dtype=dtype, device=device),
        "wkv": torch.zeros((n, batch, h, dk, dk), dtype=torch.float32,
                           device=device),
    }


def cache_logical_axes(cfg: ModelConfig):
    return {"tm_shift": ("layers", "batch", None, None),
            "cm_shift": ("layers", "batch", None, None),
            "wkv": ("layers", "batch", "act_heads", None, None)}


def decode_step(params, cfg: ModelConfig, cache, tokens, pos: int):
    """One decode step.  tokens: (b, 1); ``pos`` is unused (the state
    carries all positional context).

    The cache is updated in place (JAX's scan returns a new one): each
    layer writes its new shift rows and state into its slice, cast to the
    cache's dtype as ``astype`` does.  Returns (logits (b, 1, vocab), the
    same cache dict).
    """
    del pos
    h = L.embed(params["embed"], tokens)
    h = L.layernorm(params["ln0"], h, cfg.norm_eps)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        tm_out, tm_new = rwkv.rwkv6_timemix_decode(
            lp["tm"], cfg, h, {"tm_shift": cache["tm_shift"][i],
                               "wkv": cache["wkv"][i]})
        h = h + tm_out
        cm_out, cm_new = rwkv.rwkv6_channelmix_decode(
            lp["cm"], cfg, h, {"cm_shift": cache["cm_shift"][i]})
        h = h + cm_out
        cache["tm_shift"][i] = tm_new["tm_shift"]
        cache["cm_shift"][i] = cm_new["cm_shift"]
        cache["wkv"][i] = tm_new["wkv"]
    return _head(params, cfg, h), cache
