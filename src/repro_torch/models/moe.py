"""Token-choice top-k MoE with row-local capacity: the port of
``repro.models.moe``.

* Capacity is per batch row, ``C = max(1, ceil(cf * s * k / E))`` with
  ``E`` the unpadded expert count.  Each row's (token, choice) pairs take
  their expert's slots in token-major order; the pairs past ``C`` land in
  slot ``C``, which is zeroed before the combine, so they are dropped.
* Experts are padded to a multiple of ``EXPERT_PAD``, as in JAX (granite's
  40 become 48): the padded experts hold weights and get no tokens.
* Dispatch is one scatter-add into a ``(b, ep, C + 1, d)`` buffer, the
  experts' SwiGLU is a batched product over it, and the combine is one
  gather weighted in float32.  Every slot but the overflow has one writer.
* Padding tokens are not masked: they route and take slots, as in JAX.
* On one card the reference's ``shard_map`` over batch rows is the plain
  call.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.params import EMBED, EXPERT, MLP, ParamDef

EXPERT_PAD = 16  # the JAX package pads experts to its tensor-axis size


def padded_experts(cfg) -> int:
    return int(math.ceil(cfg.num_experts / EXPERT_PAD) * EXPERT_PAD)


def moe_def(cfg) -> dict:
    d, dff = cfg.d_model, cfg.d_ff
    ep = padded_experts(cfg)
    return {
        "router": ParamDef((d, cfg.num_experts), (EMBED, None),
                           init="scaled", dtype=torch.float32),
        "w_gate": ParamDef((ep, d, dff), (EXPERT, EMBED, MLP), init="scaled"),
        "w_up": ParamDef((ep, d, dff), (EXPERT, EMBED, MLP), init="scaled"),
        "w_down": ParamDef((ep, dff, d), (EXPERT, MLP, EMBED), init="scaled"),
    }


def row_capacity(cfg, seq_len: int) -> int:
    c = int(math.ceil(cfg.capacity_factor * seq_len
                      * cfg.experts_per_token / cfg.num_experts))
    return max(c, 1)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the ``k`` largest along the last dim, descending,
    ties broken toward the lower index.  ``torch.topk`` promises no order
    among ties; a stable descending sort gives JAX's on CPU and CUDA."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: torch.Tensor, cfg, x: torch.Tensor) -> tuple:
    """x: (b, s, d) -> (probs (b, s, E), top-k weights renormalised to sum
    1 (b, s, k), expert ids (b, s, k) int64).  The logits are float32 (the
    train step's compute copy holds a bf16 router; JAX promotes the
    product, torch is told)."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    weights, ids = top_k(probs, cfg.experts_per_token)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return probs, weights, ids


def slots(ids: torch.Tensor, num_experts: int, capacity: int) -> torch.Tensor:
    """ids: (b, s, k) -> each pair's slot in its expert, counted in its row
    over the token-major (s, k) pairs and capped at ``capacity``, the
    overflow slot: (b, s * k) int64."""
    idf = ids.reshape(ids.shape[0], -1)
    oh = (idf[..., None] == torch.arange(num_experts, device=ids.device)
          ).to(torch.int32)                                  # (b, g, E)
    pos_all = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh
    pos = torch.gather(pos_all, 2, idf[..., None])[..., 0]
    return torch.clamp(pos, max=capacity).long()


def moe_block(p: dict, cfg, x: torch.Tensor) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """x: (b, s, d) -> (out (b, s, d) in x's dtype, aux loss float32
    scalar: ``E * sum_e mean(probs)_e * f_e``, the standard load-balancing
    loss)."""
    b, s, d = x.shape
    k, E = cfg.experts_per_token, cfg.num_experts
    C = row_capacity(cfg, s)
    probs, weights, ids = route(p["router"], cfg, x)
    idf = ids.reshape(b, s * k)
    dest = slots(ids, E, C)
    rows = torch.arange(b, device=x.device)[:, None]

    x_rep = x[:, :, None, :].expand(b, s, k, d).reshape(b, s * k, d)
    buf = x.new_zeros((b, padded_experts(cfg), C + 1, d)).index_put(
        (rows, idf, dest), x_rep, accumulate=True)
    h = F.silu(torch.einsum("becd,edf->becf", buf, p["w_gate"])) \
        * torch.einsum("becd,edf->becf", buf, p["w_up"])
    out_e = torch.einsum("becf,efd->becd", h, p["w_down"])
    # drop overflow: the overflow slot reads as 0 (JAX sets out_e[:, :, C]
    # to 0); masked after the gather, not written in place, since remat's
    # "dots_saveable" keeps the einsum's output for the recompute
    gathered = torch.where((dest < C)[..., None], out_e[rows, idf, dest],
                           0).reshape(b, s, k, d)
    out = torch.sum(weights[..., None] * gathered.float(), dim=2)

    me = probs.mean(dim=(0, 1))                             # (E,)
    fe = F.one_hot(ids, E).float().sum(2).mean(dim=(0, 1)) / k
    return out.to(x.dtype), E * torch.sum(me * fe)
