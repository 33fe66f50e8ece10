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
* The dispatch scatter and the combine gather index rows only within their
  batch row.  On DTensors, ``_shmap_batch`` runs them on each rank's batch
  shard through ``local_map``, the counterpart of the reference's
  ``shard_map``, so that neither needs a collective; what moves is the
  buffer's redistribution from batch-sharded to expert-sharded and back
  (``shard`` at the reference's three sites).  The routing runs per batch
  shard too, and the experts' products on each rank's experts.  Without
  DTensors they are the plain calls.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.params import EMBED, EXPERT, MLP, ParamDef
from repro_torch.sharding.logical import (
    batch_local, current_rules, dtensor_mesh, on_mesh, on_shards, shard,
)

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


# ------------------------------------------------------- local dispatch
def _dispatch_local(x, ids, dest, ep: int, C: int):
    """One scatter-add of every (token, choice) pair into the dispatch
    buffer, within each batch row.  x: (b, s, d); ids: (b, s, k); dest:
    (b, s * k) -> (b, ep, C + 1, d)."""
    b, s, d = x.shape
    k = ids.shape[2]
    rows = torch.arange(b, device=x.device)[:, None]
    x_rep = x[:, :, None, :].expand(b, s, k, d).reshape(b, s * k, d)
    return x.new_zeros((b, ep, C + 1, d)).index_put(
        (rows, ids.reshape(b, s * k), dest), x_rep, accumulate=True)


def _combine_local(out_buf, ids, dest, weights, C: int):
    """One gather within each batch row, weighted in float32.  out_buf:
    (b, ep, C + 1, d) -> (b, s, d).  The overflow slot ``C`` reads as 0
    (JAX sets ``out_e[:, :, C]`` to 0); it is masked after the gather, not
    written in place, since remat's ``"dots_saveable"`` keeps the einsum's
    output for the recompute."""
    b, s, k = ids.shape
    rows = torch.arange(b, device=out_buf.device)[:, None]
    gathered = torch.where((dest < C)[..., None],
                           out_buf[rows, ids.reshape(b, s * k), dest], 0)
    return torch.sum(weights[..., None]
                     * gathered.reshape(b, s, k, -1).float(), dim=2)


def _shmap_batch(fn, args, extra):
    """``fn(*args, *extra)`` on each rank's batch shard through
    ``local_map`` when ``args`` are DTensors on the rules' mesh (the
    indices are row-local, so the body needs no collective): split over
    the batch axes when they divide the batch, else whole on every rank,
    where the reference makes the plain call under GSPMD.  The plain call
    otherwise (no mesh, no DTensors)."""
    rules = current_rules()
    if rules is None or not on_mesh(args[0], rules.mesh):
        return fn(*args, *extra)
    return batch_local(lambda *xs: fn(*xs, *extra), args, rules.mesh)


def _swiglu_up(buf_e, w_gate, w_up):
    return F.silu(torch.einsum("becd,edf->becf", buf_e, w_gate)) \
        * torch.einsum("becd,edf->becf", buf_e, w_up)


def _swiglu_down(h, w_down):
    return torch.einsum("becf,efd->becd", h, w_down)


def _per_expert(fn, buf, *weights):
    """``fn(buf, *weights)``; on DTensors, on each rank's experts (dim 1
    of ``buf``, dim 0 of each weight) through ``local_map``, each weight
    gathered whole over the other dims first.  DTensor's own einsum
    backward fails on the permuted layout of these products' gradients."""
    if dtensor_mesh(buf) is None:
        return fn(buf, *weights)
    e1, e0 = {"e": 1}, {"e": 0}
    return on_shards(fn, (buf, *weights), (e1,) + (e0,) * len(weights),
                     (e1,))


def moe_block(p: dict, cfg, x: torch.Tensor) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """x: (b, s, d) -> (out (b, s, d) in x's dtype, aux loss float32
    scalar: ``E * sum_e mean(probs)_e * f_e``, the standard load-balancing
    loss)."""
    b, s, d = x.shape
    k, E = cfg.experts_per_token, cfg.num_experts
    C = row_capacity(cfg, s)
    mesh = dtensor_mesh(x)
    if mesh is None:
        probs, weights, ids = route(p["router"], cfg, x)
    else:   # per batch shard: the sort's backward makes plain zeros, which
        # a DTensor step's backward (on autograd's CUDA thread) cannot mix
        probs, weights, ids = batch_local(
            lambda x, router: route(router, cfg, x), (x, p["router"]), mesh,
            whole=(1,), outputs=3)
    dest = slots(ids, E, C)

    buf = _shmap_batch(_dispatch_local, (x, ids, dest),
                       extra=(padded_experts(cfg), C))
    # the expert transpose (batch-sharded -> expert-sharded), the batched
    # expert SwiGLU, and the transpose back
    buf_e = shard(buf, None, "act_expert", "cap", None)
    h = _per_expert(_swiglu_up, buf_e, p["w_gate"], p["w_up"])
    h = shard(h, None, "act_expert", "cap", "act_mlp")
    out_e = _per_expert(_swiglu_down, h, p["w_down"])
    out_buf = shard(out_e, "batch", None, "cap", None)
    out = _shmap_batch(_combine_local, (out_buf, ids, dest, weights),
                       extra=(C,))

    me = probs.mean(dim=(0, 1))                             # (E,)
    fe = F.one_hot(ids, E).float().sum(2).mean(dim=(0, 1)) / k
    return out.to(x.dtype), E * torch.sum(me * fe)
