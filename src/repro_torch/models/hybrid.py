"""Zamba2-style hybrid: Mamba2 backbone + a SHARED transformer block applied
every ``attn_every`` layers (weight sharing is the zamba2 signature): the
port of ``repro.models.hybrid``.

Structure (81 layers, attn_every=6): 13 super-blocks of [6 x mamba2 +
shared-attn application] + 3 tail mamba2 layers.  ``blocks`` leaves keep
the JAX package's two stacked dims, (n_blocks, attn_every, ...); the
serving cache keeps its states flat, (n_blocks * attn_every, ...).  The
one ``shared_attn`` copy is applied after every block, so its gradient is
the sum over the applications.  Its attention runs through the CUDA
kernels on the card (``models.attention``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.attention import (
    decode_attention, segment_attention, write_position,
)
from repro_torch.models.params import (
    EMBED, VOCAB, ParamDef, stacked, unstack,
)
from repro_torch.models.remat import remat, whole_layer
from repro_torch.sharding.logical import shard


def _split_counts(cfg: ModelConfig) -> tuple[int, int]:
    n_blocks = cfg.num_layers // cfg.attn_every
    tail = cfg.num_layers - n_blocks * cfg.attn_every
    return n_blocks, tail


def _shared_attn_def(cfg) -> dict:
    return {
        "attn_norm": L.rmsnorm_def(cfg.d_model),
        "attn": L.attention_proj_def(cfg),
        "mlp_norm": L.rmsnorm_def(cfg.d_model),
        "mlp": L.swiglu_def(cfg.d_model, cfg.d_ff),
    }


def hybrid_defs(cfg: ModelConfig) -> dict:
    n_blocks, tail = _split_counts(cfg)
    mamba = {"norm": L.rmsnorm_def(cfg.d_model), "mixer": ssm.mamba2_def(cfg)}
    defs = {
        "embed": L.embedding_def(cfg.vocab_size, cfg.d_model),
        "blocks": stacked(stacked(mamba, cfg.attn_every), n_blocks),
        "shared_attn": _shared_attn_def(cfg),   # ONE copy, reused
        "final_norm": L.rmsnorm_def(cfg.d_model),
        "unembed": ParamDef((cfg.d_model, cfg.vocab_size), (EMBED, VOCAB),
                            init="scaled"),
    }
    if tail:
        defs["tail"] = stacked(mamba, tail)
    return defs


def _mamba_layers(params) -> tuple[list, list]:
    """(the blocks' layers, flat in block order; the tail's layers)."""
    return (unstack(params["blocks"], 2),
            unstack(params["tail"]) if "tail" in params else [])


def _mamba_layer(lp, cfg, h, seg):
    x = L.rmsnorm(lp["norm"], h, cfg.norm_eps)
    return h + ssm.mamba2_train(lp["mixer"], cfg, x, seg)


def _shared_attn_apply(sp, cfg, h, seg, pos):
    """(h after the shared block, its k and v)."""
    x = L.rmsnorm(sp["attn_norm"], h, cfg.norm_eps)
    q, k, v = L.qkv_project(sp["attn"], cfg, x, pos)
    attn = segment_attention(q, k, v, seg, seg, causal=True)
    h = h + L.attn_out_project(sp["attn"], attn)
    x = L.rmsnorm(sp["mlp_norm"], h, cfg.norm_eps)
    return h + L.swiglu(sp["mlp"], x), k, v


def _head(params, cfg, h):
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return h @ params["unembed"]


def forward(params, cfg: ModelConfig, batch):
    """batch: tokens/segment_ids/positions (b, s) int32 tensors.  Returns
    (logits (b, s, vocab), 0).  Under grad each block (its ``attn_every``
    Mamba2 layers and the shared block) is one checkpoint unless
    ``cfg.remat`` is ``"none"``; the tail is not checkpointed, as in JAX."""
    seg, pos = batch["segment_ids"], batch["positions"]
    h = shard(L.embed(params["embed"], batch["tokens"]), "batch", "seq",
              "act_embed")
    blocks, tail = _mamba_layers(params)

    def block_fn(h, sp, *layers):
        for lp in layers:
            h = _mamba_layer(lp, cfg, h, seg)
        h = _shared_attn_apply(sp, cfg, h, seg, pos)[0]
        return shard(h, "batch", "seq", "act_embed")

    body = remat(block_fn, whole_layer(cfg.remat))
    for i in range(len(blocks) // cfg.attn_every):
        h = body(h, params["shared_attn"],
                 *blocks[i * cfg.attn_every:(i + 1) * cfg.attn_every])
    for lp in tail:
        h = _mamba_layer(lp, cfg, h, seg)
    logits = shard(_head(params, cfg, h), "batch", "seq", "act_vocab")
    return logits, torch.zeros((), dtype=torch.float32, device=h.device)


def prefill(params, cfg: ModelConfig, batch):
    """Prompt pass: returns (last-token logits, cache) for decode: the
    Mamba2 states of every layer (float32; ``blocks`` flat, ``tail``) and
    the shared block's k and v of every application (bf16)."""
    seg, pos = batch["segment_ids"], batch["positions"]
    h = shard(L.embed(params["embed"], batch["tokens"]), "batch", "seq",
              "act_embed")
    blocks, tail = _mamba_layers(params)

    def mamba(lp, h, states):
        x = L.rmsnorm(lp["norm"], h, cfg.norm_eps)
        y, st = ssm.mamba2_train(lp["mixer"], cfg, x, seg, return_state=True)
        states.append(st)
        return h + y

    block_states, tail_states, ks, vs = [], [], [], []
    for i in range(len(blocks) // cfg.attn_every):
        for lp in blocks[i * cfg.attn_every:(i + 1) * cfg.attn_every]:
            h = mamba(lp, h, block_states)
        h, k, v = _shared_attn_apply(params["shared_attn"], cfg, h, seg, pos)
        ks.append(k)
        vs.append(v)
    for lp in tail:
        h = mamba(lp, h, tail_states)

    def stack(states, like=None):
        if not states:          # no tail: empty stacks of the blocks' shapes
            return {n: t[:0] for n, t in like.items()}
        return {n: torch.stack([st[n] for st in states])
                for n in ("ssm", "conv")}
    cache = {"blocks": stack(block_states),
             "k": torch.stack(ks).to(torch.bfloat16),
             "v": torch.stack(vs).to(torch.bfloat16)}
    cache["tail"] = stack(tail_states, cache["blocks"])
    return _head(params, cfg, h[:, -1:, :]), cache


# ---------------------------------------------------------------- serving
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    n_blocks, tail = _split_counts(cfg)
    hd = cfg.resolved_head_dim()
    kv_shape = (n_blocks, batch, max_len, cfg.num_kv_heads, hd)
    one = ssm.mamba2_init_state(cfg, batch, torch.float32, device)

    def mk(n):
        return {k: t.new_zeros((n,) + t.shape) for k, t in one.items()}
    return {
        "blocks": mk(n_blocks * cfg.attn_every),
        "tail": mk(tail),
        "k": torch.zeros(kv_shape, dtype=dtype, device=device),
        "v": torch.zeros(kv_shape, dtype=dtype, device=device),
    }


def cache_logical_axes(cfg: ModelConfig):
    st = {"ssm": ("layers", "batch", "act_ssm", None, None),
          "conv": ("layers", "batch", None, "act_ssm")}
    return {"blocks": st, "tail": dict(st),
            "k": ("layers", "batch", "kv_seq", "act_kv_heads", None),
            "v": ("layers", "batch", "kv_seq", "act_kv_heads", None)}


def _mamba_step(lp, cfg, h, states, i):
    """One layer's decode step on layer ``i`` of the (layers, ...) state
    stacks ``states``, which it updates in place."""
    x = L.rmsnorm(lp["norm"], h, cfg.norm_eps)
    y, st = ssm.mamba2_decode(lp["mixer"], cfg, x, {
        n: states[n][i] for n in ("ssm", "conv")})
    for n in ("ssm", "conv"):
        states[n][i] = st[n]        # casts to the cache's dtype, as astype
    return h + y


def decode_step(params, cfg: ModelConfig, cache, tokens, pos: int):
    """One decode step.  tokens: (b, 1); pos: the index the new token is
    written at (KV positions <= pos are attended).

    The cache is updated in place (JAX's scan returns a new one): each
    Mamba2 layer writes its new state into its slice, and each application
    of the shared block its new k/v row into its slice of the (n_blocks,
    b, S, kh, hd) buffers, which attention reads through strides (on a
    cache whose S is split over a mesh, as ``LONG_DECODE_RULES`` splits it
    over two mesh dims, each rank its own positions, merged:
    ``kernels.ops``).  Returns (logits (b, 1, vocab), the same cache
    dict).
    """
    S = cache["k"].shape[2]
    if not 0 <= pos < S:
        raise IndexError(f"decode position {pos} outside cache of {S}")
    b = tokens.shape[0]
    h = L.embed(params["embed"], tokens)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=h.device)
    cache_len = torch.full((b,), pos + 1, dtype=torch.int32, device=h.device)
    sp = params["shared_attn"]
    blocks, tail = _mamba_layers(params)
    for i in range(len(blocks) // cfg.attn_every):
        for j in range(i * cfg.attn_every, (i + 1) * cfg.attn_every):
            h = _mamba_step(blocks[j], cfg, h, cache["blocks"], j)
        x = L.rmsnorm(sp["attn_norm"], h, cfg.norm_eps)
        q, k, v = L.qkv_project(sp["attn"], cfg, x, positions)
        ck, cv = cache["k"][i], cache["v"][i]           # (b, S, kh, hd)
        write_position(ck, pos, k[:, 0])
        write_position(cv, pos, v[:, 0])
        attn = decode_attention(q, ck, cv, cache_len)
        h = h + L.attn_out_project(sp["attn"], attn)
        x = L.rmsnorm(sp["mlp_norm"], h, cfg.norm_eps)
        h = h + L.swiglu(sp["mlp"], x)
    for j, lp in enumerate(tail):
        h = _mamba_step(lp, cfg, h, cache["tail"], j)
    return _head(params, cfg, h), cache
