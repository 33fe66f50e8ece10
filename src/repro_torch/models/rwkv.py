"""RWKV6 "Finch": attention-free time mixing with data-dependent decay.

The port of ``repro.models.rwkv``.  WKV recurrence per head (dk = dv =
head_dim):
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t,   w_t = exp(-exp(w0 + lora_w(x)))

The full-sequence path runs the chunked WKV through ``kernels.ops.wkv6``:
the CUDA kernel on the card (and under autograd its backward kernel),
``wkv6_chunked`` (the JAX package's chunked path, kept in ``kernels.ref``
and re-exported here) on the CPU.  Decode is
the recurrence for one token, in plain tensor ops.

Packing: a segment start, or padding, resets the state; padding tokens add
nothing to it (their k is zeroed).  The token shift uses a zero previous
token only at the row start, so the first token of a packed segment mixes
in the last token of the one before: that is the reference's contract.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import wkv6_chunked  # noqa: F401  (JAX name)
from repro_torch.models.layers import layernorm, layernorm_def
from repro_torch.models.params import EMBED, LORA, MLP, RWKV_HEADS, ParamDef
from repro_torch.sharding.logical import dtensor_mesh, shard

_MIX_TARGETS = ("r", "k", "v", "w", "g")


def rwkv6_timemix_def(cfg) -> dict:
    d = cfg.d_model
    h = d // cfg.rwkv_head_dim
    lo = cfg.rwkv_lora_dim
    p: dict = {
        "ln": layernorm_def(d),
        "mu_base": ParamDef((d,), (None,), init="uniform", scale=0.5),
    }
    for t in _MIX_TARGETS:
        # the mix LoRAs are 32 wide whatever rwkv_lora_dim is, as in JAX
        p[f"mu_{t}"] = ParamDef((d,), (None,), init="uniform", scale=0.5)
        p[f"mixA_{t}"] = ParamDef((d, 32), (EMBED, LORA), init="scaled")
        p[f"mixB_{t}"] = ParamDef((32, d), (LORA, EMBED), init="zeros")
    for t in ("r", "k", "v", "g", "o"):
        p[f"w_{t}"] = ParamDef((d, d), (EMBED, None), init="scaled")
    p["w0"] = ParamDef((d,), (None,), init="uniform", scale=1.0)
    p["loraA_w"] = ParamDef((d, lo), (EMBED, LORA), init="scaled")
    p["loraB_w"] = ParamDef((lo, d), (LORA, EMBED), init="zeros")
    p["u"] = ParamDef((h, cfg.rwkv_head_dim), (RWKV_HEADS, None),
                      init="uniform", scale=0.5)
    p["out_ln"] = layernorm_def(cfg.rwkv_head_dim)
    return p


def rwkv6_channelmix_def(cfg) -> dict:
    d, dff = cfg.d_model, cfg.d_ff
    return {
        "ln": layernorm_def(d),
        "mu_k": ParamDef((d,), (None,), init="uniform", scale=0.5),
        "mu_r": ParamDef((d,), (None,), init="uniform", scale=0.5),
        "w_k": ParamDef((d, dff), (EMBED, MLP), init="scaled"),
        "w_v": ParamDef((dff, d), (MLP, EMBED), init="scaled"),
        "w_r": ParamDef((d, d), (EMBED, None), init="scaled"),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x: (b, s, d) -> previous-token stream; prev: (b, 1, d) carried state."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(p, t: str, x, xs, base_mix):
    mu = p[f"mu_{t}"].to(x.dtype)
    lora = torch.tanh(base_mix @ p[f"mixA_{t}"]) @ p[f"mixB_{t}"]
    return x + (xs - x) * (mu + lora)


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """(..., h * dk) -> (..., h, dk).  A DTensor whose last dim is split
    (DTensor may split a product's columns over more devices than there
    are heads: rwkv6-3b's 40 over 16) is made whole on it first."""
    mesh = dtensor_mesh(t)
    if mesh is not None:
        from torch.distributed.tensor import Replicate
        last = t.ndim - 1
        t = t.redistribute(mesh, [Replicate() if p.is_shard(last) else p
                                  for p in t.placements])
    return t.unflatten(-1, (h, -1))


def _per_head_ln(p, x, eps):
    """x: (b, s, h, dk), GroupNorm(heads) equivalent; returns float32."""
    xf = x.float()
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.var(xf, -1, keepdim=True, correction=0)
    return (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _project(p, cfg, x, x_shift):
    """Shared r/k/v/w/g projection.  Returns float32 tensors: r, k, v, loga
    (b, s, h, dk) and g (b, s, d)."""
    h = x.shape[-1] // cfg.rwkv_head_dim
    base_mix = x + (x_shift - x) * p["mu_base"].to(x.dtype)
    xr, xk, xv, xw, xg = (_ddlerp(p, t, x, x_shift, base_mix)
                          for t in _MIX_TARGETS)
    r = _heads(xr @ p["w_r"], h).float()
    k = _heads(xk @ p["w_k"], h).float()
    v = _heads(xv @ p["w_v"], h).float()
    g = F.silu((xg @ p["w_g"]).float())
    w_raw = p["w0"].float() \
        + (torch.tanh(xw @ p["loraA_w"]) @ p["loraB_w"]).float()
    loga = -torch.exp(_heads(w_raw, h))                 # log decay, <= 0
    return r, k, v, g, loga


def rwkv6_timemix_train(p, cfg, x, segment_ids, return_state: bool = False):
    """x: (b, s, d).  Full time-mix sublayer (includes its own LN)."""
    b, s, d = x.shape
    h = d // cfg.rwkv_head_dim
    xn = layernorm(p["ln"], x, cfg.norm_eps)
    xs = _token_shift(xn, None)
    r, k, v, g, loga = _project(p, cfg, xn, xs)
    prev_seg = F.pad(segment_ids[:, :-1], (1, 0))
    reset = (segment_ids != prev_seg) | (segment_ids == 0)
    k = k * (segment_ids > 0)[..., None, None]      # padding adds no state
    u = p["u"].float()
    o = ops.wkv6(r, k, v, loga, u, reset, chunk=cfg.rwkv_chunk,
                 return_state=return_state)
    if return_state:
        o, S_final = o
    o = _per_head_ln(p["out_ln"], o, cfg.norm_eps) * _heads(g, h)
    o = shard(o.to(x.dtype), "batch", "seq", "act_heads", None)
    out = o.reshape(b, s, d) @ p["w_o"]
    if return_state:
        # the row's last position, padding or not, as in JAX
        return out, {"tm_shift": xn[:, -1:], "wkv": S_final}
    return out


def rwkv6_channelmix_train(p, cfg, x):
    xn = layernorm(p["ln"], x, cfg.norm_eps)
    xs = _token_shift(xn, None)
    xk = xn + (xs - xn) * p["mu_k"].to(xn.dtype)
    xr = xn + (xs - xn) * p["mu_r"].to(xn.dtype)
    kk = torch.square(F.relu(xk @ p["w_k"]))
    kk = shard(kk, "batch", "seq", "act_mlp")
    return torch.sigmoid(xr @ p["w_r"]) * (kk @ p["w_v"])


# ---------------------------------------------------------------- decode
def rwkv6_timemix_decode(p, cfg, x, state):
    """x: (b, 1, d).  Returns (out, new state pieces)."""
    b, _, d = x.shape
    h = d // cfg.rwkv_head_dim
    xn = layernorm(p["ln"], x, cfg.norm_eps)
    xs = state["tm_shift"].to(xn.dtype)
    r, k, v, g, loga = _project(p, cfg, xn, xs)
    u = p["u"].float()
    S = state["wkv"]
    r1, k1, v1 = r[:, 0], k[:, 0], v[:, 0]          # (b, h, dk)
    kv = torch.einsum("bhi,bhj->bhij", k1, v1)
    o = torch.einsum("bhi,bhij->bhj", r1, S + u[None, :, :, None] * kv)
    S_new = S * torch.exp(loga[:, 0])[..., None] + kv
    o = _per_head_ln(p["out_ln"], o[:, None], cfg.norm_eps)[:, 0] \
        * _heads(g, h)[:, 0]
    out = o.reshape(b, d)[:, None, :].to(x.dtype) @ p["w_o"]
    return out, {"tm_shift": xn, "wkv": S_new}


def rwkv6_channelmix_decode(p, cfg, x, state):
    xn = layernorm(p["ln"], x, cfg.norm_eps)
    xs = state["cm_shift"].to(xn.dtype)
    xk = xn + (xs - xn) * p["mu_k"].to(xn.dtype)
    xr = xn + (xs - xn) * p["mu_r"].to(xn.dtype)
    kk = torch.square(F.relu(xk @ p["w_k"]))
    out = torch.sigmoid(xr @ p["w_r"]) * (kk @ p["w_v"])
    return out, {"cm_shift": xn}
