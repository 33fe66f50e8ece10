"""AdamW with a warmup-cosine schedule and global-norm clipping: the port of
``repro.train.optimizer``.

Plain functions on nested dicts of tensors, with the reference's formulas
line for line.  Params are float32 (master weights; the train step checks);
moments are float32 and have the params' tree structure.  The step count,
the learning rate and the bias corrections stay on the params' device, so
an update makes no host sync.  One departure, for memory:
``adamw_update`` writes the new params and moments into the old tensors
(JAX returns new trees), which holds qwen3-8b's full-width layers on one
card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.models.params import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor       # scalar int32, on the params' device
    mu: dict                 # tree like params
    nu: dict                 # tree like params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
        * 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_adamw(params: dict) -> AdamWState:
    """Zero moments like each param (a DTensor param's are DTensors of its
    placements) and a step count on the params' device."""
    device = next(leaf for _, leaf in tree_leaves(params)).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params),
        nu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params))


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for _, leaf in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: dict, state: AdamWState,
                 params: dict):
    """Returns (params, new_state, metrics); ``params`` and the moments of
    ``state`` are updated in place and returned."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    leaves = zip(tree_leaves(params), tree_leaves(grads),
                 tree_leaves(state.mu), tree_leaves(state.nu))
    for (path, p), (gpath, g), (_, m), (_, v) in leaves:
        if gpath != path:
            raise ValueError(f"grads and params differ: {gpath} vs {path}")
        g = g.float() * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)           # b1 m + (1-b1) g
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)    # b2 v + (1-b2) g^2
        del g
        mhat = m / b1c
        vhat = v / b2c
        # p - lr (mhat / (sqrt(vhat) + eps) + wd p)
        upd = mhat.div_(vhat.sqrt_().add_(cfg.eps))
        del vhat
        upd.add_(p, alpha=cfg.weight_decay)
        p.sub_(upd.mul_(lr))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, state.mu, state.nu), metrics
