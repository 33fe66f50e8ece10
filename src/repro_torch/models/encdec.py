"""Whisper-style encoder-decoder (audio family): the port of
``repro.models.encdec``.

The conv/mel frontend is a STUB, as in the JAX package: the batch carries
precomputed frame embeddings ``enc_embeds`` (b, frames, d_model).  The
encoder is bidirectional; the decoder is causal with cross-attention.
Whisper uses LayerNorm; we keep that.  Learned absolute positions are
replaced by RoPE, as in the JAX package.

Dtypes follow JAX's promotion: float32 ``enc_embeds`` on bf16 weights run
the encoder in float32 (``layers.matmul``), and an attention call on a
bf16 q and float32 keys runs in float32 (``attention.segment_attention``),
so a served encoder runs the float32 attention kernel.  The float32 kernel
has no backward, so training on the card feeds bf16 ``enc_embeds``.
Attention runs through the CUDA kernels on the card.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import (
    decode_attention, segment_attention, write_position,
)
from repro_torch.models.params import (
    EMBED, VOCAB, ParamDef, stacked, unstack,
)
from repro_torch.models.remat import remat, whole_layer
from repro_torch.sharding.logical import shard


def _enc_layer_def(cfg) -> dict:
    return {
        "attn_norm": L.layernorm_def(cfg.d_model),
        "attn": L.attention_proj_def(cfg),
        "mlp_norm": L.layernorm_def(cfg.d_model),
        "mlp": L.gelu_mlp_def(cfg.d_model, cfg.d_ff),
    }


def _dec_layer_def(cfg) -> dict:
    d = _enc_layer_def(cfg)
    d["cross_norm"] = L.layernorm_def(cfg.d_model)
    d["cross"] = L.attention_proj_def(cfg.replace(qk_norm=False))
    return d


def encdec_defs(cfg: ModelConfig) -> dict:
    return {
        "embed": L.embedding_def(cfg.vocab_size, cfg.d_model),
        "enc_layers": stacked(_enc_layer_def(cfg), cfg.encoder_layers),
        "enc_norm": L.layernorm_def(cfg.d_model),
        "dec_layers": stacked(_dec_layer_def(cfg), cfg.num_layers),
        "final_norm": L.layernorm_def(cfg.d_model),
        "unembed": ParamDef((cfg.d_model, cfg.vocab_size), (EMBED, VOCAB),
                            init="scaled"),
    }


def _ones(b: int, s: int, device) -> torch.Tensor:
    return torch.ones((b, s), dtype=torch.int32, device=device)


def encode(params, cfg: ModelConfig, enc_embeds: torch.Tensor
           ) -> torch.Tensor:
    """enc_embeds: (b, F, d) stub frame embeddings -> encoder states, in
    the promoted dtype of the embeddings and the weights.  Under grad each
    layer is checkpointed unless ``cfg.remat`` is ``"none"``, as in JAX."""
    b, F_, _ = enc_embeds.shape
    h = shard(enc_embeds, "batch", "seq", "act_embed")
    pos = torch.arange(F_, dtype=torch.int32, device=h.device).expand(b, F_)
    ones = _ones(b, F_, h.device)

    def layer_fn(h, lp):
        x = L.layernorm(lp["attn_norm"], h, cfg.norm_eps)
        q, k, v = L.qkv_project(lp["attn"], cfg, x, pos)
        attn = segment_attention(q, k, v, ones, ones, causal=False)
        h = h + L.attn_out_project(lp["attn"], attn)
        return shard(_mlp(lp, cfg, h), "batch", "seq", "act_embed")

    body = remat(layer_fn, whole_layer(cfg.remat))
    for lp in unstack(params["enc_layers"]):
        h = body(h, lp)
    return L.layernorm(params["enc_norm"], h, cfg.norm_eps)


def _cross_block(lp, cfg, h, enc_out, enc_valid):
    x = L.layernorm(lp["cross_norm"], h, cfg.norm_eps)
    q = L.head_project(x, lp["cross"]["wq"])
    k = L.head_project(enc_out, lp["cross"]["wk"])
    v = L.head_project(enc_out, lp["cross"]["wv"])
    b, s = x.shape[:2]
    attn = segment_attention(q, k, v, _ones(b, s, x.device), enc_valid,
                             causal=False)
    return h + L.attn_out_project(lp["cross"], attn)


def _self_attn(lp, cfg, h, seg, pos):
    """(h after the causal self-attention, its k and v)."""
    x = L.layernorm(lp["attn_norm"], h, cfg.norm_eps)
    q, k, v = L.qkv_project(lp["attn"], cfg, x, pos)
    attn = segment_attention(q, k, v, seg, seg, causal=True)
    return h + L.attn_out_project(lp["attn"], attn), k, v


def _mlp(lp, cfg, h):
    x = L.layernorm(lp["mlp_norm"], h, cfg.norm_eps)
    return h + L.gelu_mlp(lp["mlp"], x)


def _head(params, cfg, h):
    h = L.layernorm(params["final_norm"], h, cfg.norm_eps)
    return L.matmul(h, params["unembed"])


def forward(params, cfg: ModelConfig, batch):
    """Train forward: batch tokens/segment_ids/positions (b, s) int32 and
    ``enc_embeds`` (b, F, d).  Returns (logits (b, s, vocab), 0).  Under
    grad each decoder layer is checkpointed unless ``cfg.remat`` is
    ``"none"``, as in JAX."""
    enc_out = encode(params, cfg, batch["enc_embeds"])
    enc_valid = _ones(*enc_out.shape[:2], enc_out.device)
    seg, pos = batch["segment_ids"], batch["positions"]
    h = shard(L.embed(params["embed"], batch["tokens"]), "batch", "seq",
              "act_embed")

    def layer_fn(h, enc_out, lp):
        h = _self_attn(lp, cfg, h, seg, pos)[0]
        h = _cross_block(lp, cfg, h, enc_out, enc_valid)
        return shard(_mlp(lp, cfg, h), "batch", "seq", "act_embed")

    body = remat(layer_fn, whole_layer(cfg.remat))
    for lp in unstack(params["dec_layers"]):
        h = body(h, enc_out, lp)
    logits = shard(_head(params, cfg, h), "batch", "seq", "act_vocab")
    return logits, torch.zeros((), dtype=torch.float32, device=h.device)


# ---------------------------------------------------------------- serving
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    hd = cfg.resolved_head_dim()
    self_shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, hd)
    cross_shape = (cfg.num_layers, batch, cfg.encoder_frames,
                   cfg.num_kv_heads, hd)
    return {n: torch.zeros(shape, dtype=dtype, device=device)
            for n, shape in (("k", self_shape), ("v", self_shape),
                             ("cross_k", cross_shape),
                             ("cross_v", cross_shape))}


def cache_logical_axes(cfg: ModelConfig):
    kv = ("layers", "batch", "kv_seq", "act_kv_heads", None)
    cross = ("layers", "batch", None, "act_kv_heads", None)
    return {"k": kv, "v": kv, "cross_k": cross, "cross_v": cross}


def build_cross_cache(params, cfg, enc_out):
    """Per-layer cross K/V from encoder states: (layers, b, F, kh, hd)
    bf16 each."""
    ks, vs = [], []
    for lp in unstack(params["dec_layers"]):
        for out, w in ((ks, "wk"), (vs, "wv")):
            out.append(L.head_project(enc_out, lp["cross"][w]).to(
                torch.bfloat16))
    return torch.stack(ks), torch.stack(vs)


def prefill(params, cfg: ModelConfig, batch):
    """Prompt pass for the decoder given stub frame embeddings: (last-token
    logits, cache with the self-attention k/v and the cross k/v, bf16)."""
    enc_out = encode(params, cfg, batch["enc_embeds"])
    enc_valid = _ones(*enc_out.shape[:2], enc_out.device)
    cross_k, cross_v = build_cross_cache(params, cfg, enc_out)
    seg, pos = batch["segment_ids"], batch["positions"]
    h = shard(L.embed(params["embed"], batch["tokens"]), "batch", "seq",
              "act_embed")
    ks, vs = [], []
    for i, lp in enumerate(unstack(params["dec_layers"])):
        h, k, v = _self_attn(lp, cfg, h, seg, pos)
        ks.append(k.to(torch.bfloat16))
        vs.append(v.to(torch.bfloat16))
        x = L.layernorm(lp["cross_norm"], h, cfg.norm_eps)
        q = L.head_project(x, lp["cross"]["wq"])
        cattn = segment_attention(q, cross_k[i].to(q.dtype),
                                  cross_v[i].to(q.dtype),
                                  _ones(*x.shape[:2], x.device), enc_valid,
                                  causal=False)
        h = h + L.attn_out_project(lp["cross"], cattn)
        h = _mlp(lp, cfg, h)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "cross_k": cross_k, "cross_v": cross_v}
    return _head(params, cfg, h[:, -1:, :]), cache


def decode_step(params, cfg: ModelConfig, cache, tokens, pos: int):
    """One decode step.  tokens: (b, 1); pos: the index the new token is
    written at.  Cross-attention reads the static cross cache over
    ``encoder_frames`` positions.

    The cache is updated in place (JAX's scan returns a new one): each
    layer writes its new self-attention k/v row into its slice.  Under the
    decode rules the self-attention cache's positions are split over the
    mesh and merged (``kernels.ops``' KV-sequence-parallel decode); the
    cross cache's frames are not split, so its attention reads it whole.
    Returns (logits (b, 1, vocab), the same cache dict).
    """
    S = cache["k"].shape[2]
    if not 0 <= pos < S:
        raise IndexError(f"decode position {pos} outside cache of {S}")
    b = tokens.shape[0]
    h = L.embed(params["embed"], tokens)
    dev = h.device
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
    cache_len = torch.full((b,), pos + 1, dtype=torch.int32, device=dev)
    f_len = torch.full((b,), cfg.encoder_frames, dtype=torch.int32,
                       device=dev)
    for i, lp in enumerate(unstack(params["dec_layers"])):
        x = L.layernorm(lp["attn_norm"], h, cfg.norm_eps)
        q, k, v = L.qkv_project(lp["attn"], cfg, x, positions)
        ck, cv = cache["k"][i], cache["v"][i]           # (b, S, kh, hd)
        write_position(ck, pos, k[:, 0])                # casts to the cache's
        write_position(cv, pos, v[:, 0])                # dtype, as astype does
        h = h + L.attn_out_project(lp["attn"],
                                   decode_attention(q, ck, cv, cache_len))
        # cross attention vs static cross cache
        x = L.layernorm(lp["cross_norm"], h, cfg.norm_eps)
        q = L.head_project(x, lp["cross"]["wq"])
        cattn = decode_attention(q, cache["cross_k"][i], cache["cross_v"][i],
                                 f_len)
        h = h + L.attn_out_project(lp["cross"], cattn)
        h = _mlp(lp, cfg, h)
    return _head(params, cfg, h), cache
