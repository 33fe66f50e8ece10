"""Shared building blocks: the port of ``repro.models.layers``.

Plain functions over nested dicts of tensors declared with ParamDef, with
the JAX package's numerics: norms and RoPE compute in float32 and return
the input's dtype; matrix products run in the operands' dtype, promoted as
``jnp`` promotes it where the two differ (``matmul``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.params import (
    EMBED, HEADS, HEAD_DIM, KV_HEADS, MLP, VOCAB, ParamDef,
)
from repro_torch.sharding.logical import dtensor_mesh, on_shards, shard


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in ``torch.promote_types`` of the two, as ``jnp``'s ``@``
    promotes: a float32 activation times a bf16 weight runs in float32
    (torch refuses a product of two dtypes)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


# --------------------------------------------------------------------- norm
def rmsnorm_def(dim: int) -> dict:
    return {"scale": ParamDef((dim,), (None,), init="ones",
                              dtype=torch.float32)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * p["scale"]
    return out.to(dt)


def layernorm_def(dim: int) -> dict:
    return {
        "scale": ParamDef((dim,), (None,), init="ones", dtype=torch.float32),
        "bias": ParamDef((dim,), (None,), init="zeros", dtype=torch.float32),
    }


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Population variance (``correction=0``), as ``jnp.var``."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    out = (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(dt)


# --------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int32.

    Split-halves convention: the first and second halves of head_dim are
    the real and imaginary parts; angles are computed in float32.
    """
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)            # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., s, hd/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., s, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- mlp
def swiglu_def(d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": ParamDef((d_model, d_ff), (EMBED, MLP), init="scaled"),
        "w_up": ParamDef((d_model, d_ff), (EMBED, MLP), init="scaled"),
        "w_down": ParamDef((d_ff, d_model), (MLP, EMBED), init="scaled"),
    }


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    h = shard(h, "batch", "seq", "act_mlp")
    return h @ p["w_down"]


def gelu_mlp_def(d_model: int, d_ff: int) -> dict:
    return {
        "w_up": ParamDef((d_model, d_ff), (EMBED, MLP), init="scaled"),
        "b_up": ParamDef((d_ff,), (MLP,), init="zeros"),
        "w_down": ParamDef((d_ff, d_model), (MLP, EMBED), init="scaled"),
        "b_down": ParamDef((d_model,), (None,), init="zeros"),
    }


def gelu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation; ``F.gelu``'s
    is erf, so the form is named."""
    h = F.gelu(matmul(x, p["w_up"]) + p["b_up"], approximate="tanh")
    h = shard(h, "batch", "seq", "act_mlp")
    return matmul(h, p["w_down"]) + p["b_down"]


# --------------------------------------------------------------- embeddings
def embedding_def(vocab: int, d_model: int) -> dict:
    return {"table": ParamDef((vocab, d_model), (VOCAB, EMBED), scale=1.0)}


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The table's rows at ``tokens``; on DTensors, on each rank's batch
    shard of the tokens with the table gathered whole (its gradient then a
    sum over the batch shards), not by DTensor's index strategies, which
    differ from one torch release to the next."""
    if dtensor_mesh(tokens) is not None or dtensor_mesh(p["table"]) \
            is not None:
        return on_shards(lambda t, table: table[t], (tokens, p["table"]),
                         ({"b": 0}, {}), ({"b": 0},))
    return p["table"][tokens]


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    return shard(x @ p["table"].T, "batch", "seq", "act_vocab")


# --------------------------------------------------- attention projections
def attention_proj_def(cfg) -> dict:
    hd = cfg.resolved_head_dim()
    d = {
        "wq": ParamDef((cfg.d_model, cfg.num_heads, hd),
                       (EMBED, HEADS, HEAD_DIM), init="scaled"),
        "wk": ParamDef((cfg.d_model, cfg.num_kv_heads, hd),
                       (EMBED, KV_HEADS, HEAD_DIM), init="scaled"),
        "wv": ParamDef((cfg.d_model, cfg.num_kv_heads, hd),
                       (EMBED, KV_HEADS, HEAD_DIM), init="scaled"),
        "wo": ParamDef((cfg.num_heads, hd, cfg.d_model),
                       (HEADS, HEAD_DIM, EMBED), init="scaled"),
    }
    if cfg.qk_norm:
        d["q_norm"] = rmsnorm_def(hd)
        d["k_norm"] = rmsnorm_def(hd)
    return d


def head_project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product.  On DTensors, on
    each rank's batch shard with ``w`` gathered whole (its gradient then a
    sum over the batch shards): DTensor may shard the product's ``h * k``
    columns over more devices than there are heads, and then cannot
    unflatten them."""
    if dtensor_mesh(x) is not None:
        return on_shards(head_project, (x, w), ({"b": 0}, {}), ({"b": 0},))
    d, h, k = w.shape
    return matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def qkv_project(p: dict, cfg, x: torch.Tensor,
                positions: Optional[torch.Tensor]) -> tuple:
    """x: (b, s, d) -> q (b,s,H,hd), k/v (b,s,KH,hd) with qk_norm + RoPE.

    qk-norm runs before RoPE, as in the JAX package.
    """
    q = head_project(x, p["wq"])
    k = head_project(x, p["wk"])
    v = head_project(x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", "seq", "act_heads", None)
    k = shard(k, "batch", "seq", "act_kv_heads", None)
    v = shard(v, "batch", "seq", "act_kv_heads", None)
    return q, k, v


def attn_out_project(p: dict, attn: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product.  On DTensors, on
    each rank's batch and heads with ``wo``'s rows of those heads gathered
    whole, the product a sum over the heads' shards: DTensor's gradient of
    the flattened heads may be split over more devices than there are
    heads, and then cannot be unflattened."""
    if dtensor_mesh(attn) is not None:
        return on_shards(_attn_out, (attn, p["wo"]),
                         ({"b": 0, "h": 2}, {"h": 0}),
                         ({"b": 0, "sum": ("h",)},))
    return _attn_out(attn, p["wo"])


def _attn_out(attn: torch.Tensor, wo: torch.Tensor
                           ) -> torch.Tensor:
    h, k, d = wo.shape
    return matmul(attn.flatten(-2), wo.reshape(h * k, d))
