"""Decoder-only transformer LM, dense, moe and vlm families: the port of
``repro.models.transformer``.

Three entry points: ``forward`` (packed batch -> logits), ``prefill``
(prompt -> last-token logits and KV cache), ``decode_step`` (one token
against the full cache).  Layers keep the JAX package's stacked leaves
(leading ``layers`` dim); the scan over them is a Python loop over views.
Attention runs through the CUDA kernels on the card (``models.attention``).
A vlm config is the same backbone; its ``forward`` and ``prefill`` write
the batch's ``image_embeds`` over the token embeddings at
``image_positions`` when the batch holds them (``_embed_inputs``).  A moe
config's layers hold ``models.moe``'s block in place of the SwiGLU;
``forward`` sums its aux losses, ``prefill`` and ``decode_step`` drop them.
Under grad, ``forward`` checkpoints each layer as ``cfg.remat`` says
(``models.remat``), carrying ``h`` and the aux loss, as JAX's scan does.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import (
    decode_attention, segment_attention, write_position,
)
from repro_torch.models.params import EMBED, VOCAB, ParamDef, stacked, tree_map
from repro_torch.models.remat import remat
from repro_torch.sharding.logical import batch_local, dtensor_mesh, shard


# ------------------------------------------------------------------- defs
def layer_def(cfg: ModelConfig) -> dict:
    d = {
        "attn_norm": L.rmsnorm_def(cfg.d_model),
        "attn": L.attention_proj_def(cfg),
        "mlp_norm": L.rmsnorm_def(cfg.d_model),
    }
    if cfg.family == "moe" or cfg.num_experts > 0:
        d["moe"] = moe_lib.moe_def(cfg)
    else:
        d["mlp"] = L.swiglu_def(cfg.d_model, cfg.d_ff)
    return d


def lm_defs(cfg: ModelConfig) -> dict:
    defs = {
        "embed": L.embedding_def(cfg.vocab_size, cfg.d_model),
        "layers": stacked(layer_def(cfg), cfg.num_layers),
        "final_norm": L.rmsnorm_def(cfg.d_model),
    }
    if not cfg.tied_embeddings:
        defs["unembed"] = ParamDef(
            (cfg.d_model, cfg.vocab_size), (EMBED, VOCAB), init="scaled")
    return defs


# ----------------------------------------------------------------- blocks
def _layer(params, i: int) -> dict:
    """Layer ``i``'s leaves: views into the stacked tensors."""
    return tree_map(lambda t: t[i], params["layers"])


def _attn_block(lp, cfg, h, segment_ids, positions):
    x = L.rmsnorm(lp["attn_norm"], h, cfg.norm_eps)
    q, k, v = L.qkv_project(lp["attn"], cfg, x, positions)
    attn = segment_attention(q, k, v, segment_ids, segment_ids, causal=True)
    attn = shard(attn, "batch", "seq", "act_heads", None)
    return L.attn_out_project(lp["attn"], attn), k, v


def _ffn_block(lp, cfg, h):
    """(out, the MoE block's aux loss, or None for the SwiGLU)."""
    x = L.rmsnorm(lp["mlp_norm"], h, cfg.norm_eps)
    if "moe" in lp:
        return moe_lib.moe_block(lp["moe"], cfg, x)
    return L.swiglu(lp["mlp"], x), None


def _put_images(h, positions, embeds):
    bi = torch.arange(h.shape[0], device=h.device)[:, None]
    return h.index_put((bi, positions.long()), embeds.to(h.dtype))


def _embed_inputs(params, cfg, batch):
    """Token embeddings, with a vlm batch's ``image_embeds`` (b, n, d)
    written over them at ``image_positions`` (b, n), cast to their dtype;
    on DTensors, row by row on each rank's batch shard."""
    h = L.embed(params["embed"], batch["tokens"])
    if cfg.family == "vlm" and "image_embeds" in batch:
        args = (h, batch["image_positions"], batch["image_embeds"])
        mesh = dtensor_mesh(h)
        h = _put_images(*args) if mesh is None else \
            batch_local(_put_images, args, mesh)
    return shard(h, "batch", "seq", "act_embed")


def _unembed(params, cfg, h):
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if cfg.tied_embeddings:
        return L.unembed(params["embed"], h)
    return shard(h @ params["unembed"], "batch", "seq", "act_vocab")


# ------------------------------------------------------------------ train
def forward(params, cfg: ModelConfig, batch) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """batch: tokens/segment_ids/positions (b, s) int32 tensors [+ vlm
    ``image_embeds``/``image_positions``].  Returns (logits (b, s, vocab),
    aux_loss float32 scalar: the layers' MoE aux losses summed, 0 for a
    dense model)."""
    h = _embed_inputs(params, cfg, batch)
    seg = batch["segment_ids"]
    pos = batch["positions"]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    def layer_fn(h, aux, lp):
        h = h + _attn_block(lp, cfg, h, seg, pos)[0]
        ffn, a = _ffn_block(lp, cfg, h)
        h = shard(h + ffn, "batch", "seq", "act_embed")
        return h, aux if a is None else aux + a

    body = remat(layer_fn, cfg.remat)
    for i in range(cfg.num_layers):
        h, aux = body(h, aux, _layer(params, i))
    return _unembed(params, cfg, h), aux


# ---------------------------------------------------------------- serving
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    hd = cfg.resolved_head_dim()
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_logical_axes(cfg: ModelConfig):
    return {"k": ("layers", "batch", "kv_seq", "act_kv_heads", None),
            "v": ("layers", "batch", "kv_seq", "act_kv_heads", None)}


def prefill(params, cfg: ModelConfig, batch):
    """Run the full prompt, return (last-token logits, populated cache)."""
    h = _embed_inputs(params, cfg, batch)
    seg = batch["segment_ids"]
    pos = batch["positions"]
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        attn, k, v = _attn_block(lp, cfg, h, seg, pos)
        ks.append(k)
        vs.append(v)
        h = h + attn
        h = shard(h + _ffn_block(lp, cfg, h)[0], "batch", "seq", "act_embed")
    kv = {n: shard(torch.stack(t), "layers", "batch", "kv_seq",
                   "act_kv_heads", None) for n, t in (("k", ks), ("v", vs))}
    return _unembed(params, cfg, h[:, -1:, :]), kv


def decode_step(params, cfg: ModelConfig, cache, tokens, pos: int):
    """One decode step.  tokens: (b, 1); pos: the index the new token is
    written at (cache positions <= pos are attended).

    The cache is updated in place (JAX's ``dynamic_update_slice`` returns
    a new one): each layer writes its new k/v row into its slice of the
    (layers, b, S, kh, hd) buffers, and attention reads that slice through
    strides (on a cache whose S is split over a mesh, each rank its own
    positions, merged: ``kernels.ops``).  Returns (logits (b, 1, vocab),
    the same cache dict).
    """
    S = cache["k"].shape[2]
    if not 0 <= pos < S:
        raise IndexError(f"decode position {pos} outside cache of {S}")
    b = tokens.shape[0]
    h = shard(L.embed(params["embed"], tokens), "batch", "seq", "act_embed")
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=h.device)
    cache_len = torch.full((b,), pos + 1, dtype=torch.int32, device=h.device)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        x = L.rmsnorm(lp["attn_norm"], h, cfg.norm_eps)
        q, k, v = L.qkv_project(lp["attn"], cfg, x, positions)
        ck, cv = cache["k"][i], cache["v"][i]           # (b, S, kh, hd)
        write_position(ck, pos, k[:, 0])                # casts to the cache's
        write_position(cv, pos, v[:, 0])                # dtype, as astype does
        attn = decode_attention(q, ck, cv, cache_len)
        h = h + L.attn_out_project(lp["attn"], attn)
        h = h + _ffn_block(lp, cfg, h)[0]
    return _unembed(params, cfg, h), cache
