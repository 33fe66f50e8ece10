"""Parameter definitions: the port's copy of ``repro.models.params``.

Models declare a tree (nested dicts) of :class:`ParamDef`.  The tree's
key paths, shapes and init rules are those of the JAX package, so a JAX
parameter tree maps one to one onto the port's ``state_dict`` (paths
joined by ``.``).  From the same tree come the logical axes of every
leaf (``logical_specs``), which ``sharding.logical`` maps onto a mesh, and
meta tensors of every leaf's shape and dtype (``abstract_params``), which
the dry-run (``launch.dryrun``) traces and counts without allocating.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

# Logical axis names used across the model zoo (see repro.models.params).
EMBED = "embed"
MLP = "mlp"
HEADS = "heads"
KV_HEADS = "kv_heads"
HEAD_DIM = "head_dim"
VOCAB = "vocab"
EXPERT = "expert"
LAYERS = "layers"
SSM_STATE = "ssm_state"
SSM_INNER = "ssm_inner"
CONV = "conv"
RWKV_HEADS = "rwkv_heads"
LORA = "lora"
FRAMES = "frames"


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative description of one parameter tensor."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"        # normal | zeros | ones | scaled | uniform
    scale: float | None = None  # stddev override for "normal"/"scaled"
    dtype: Any = None           # override container dtype (e.g. fp32 norms)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"shape {self.shape} and axes {self.axes} rank mismatch")


def _fan_in(shape: tuple[int, ...]) -> int:
    # Heuristic: all-but-last dims are fan-in for projection matrices.
    if len(shape) == 1:
        return shape[0]
    return int(np.prod(shape[:-1]))


def init_param(defn: ParamDef, generator: torch.Generator, dtype,
               device) -> torch.Tensor:
    dt = defn.dtype or dtype
    if defn.init == "zeros":
        return torch.zeros(defn.shape, dtype=dt, device=device)
    if defn.init == "ones":
        return torch.ones(defn.shape, dtype=dt, device=device)
    if defn.init == "uniform":
        lim = defn.scale or 1.0
        out = torch.empty(defn.shape, dtype=dt, device=device)
        return out.uniform_(-lim, lim, generator=generator)
    if defn.init == "scaled":  # 1/sqrt(fan_in) normal
        std = (defn.scale or 1.0) / math.sqrt(max(_fan_in(defn.shape), 1))
    else:
        std = defn.scale if defn.scale is not None else 0.02
    out = torch.randn(defn.shape, dtype=torch.float32, device=device,
                      generator=generator)
    return out.mul_(std).to(dt)


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree, prefix: str = ""):
    """``(dotted path, leaf)`` pairs in sorted-key order, as jax.tree does."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def init_params(defs, generator: torch.Generator, dtype=torch.bfloat16,
                device="cuda"):
    """Materialize a ParamDef tree into tensors on ``device``.

    Leaves are drawn in sorted-key order from one ``generator``, which must
    live on ``device``.  The numbers differ from ``jax.random``'s; a test
    that compares with JAX hands the JAX tree over with
    ``models.convert.params_from_jax`` instead.
    """
    return tree_map(lambda d: init_param(d, generator, dtype, device), defs)


def abstract_params(defs, dtype=torch.bfloat16):
    """A tree of meta tensors (dry-run: no allocation), each of its leaf's
    own dtype if it has one, else ``dtype``."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype or dtype,
                                          device="meta"), defs)


def logical_specs(defs):
    """Tree of logical-axis tuples, mirroring the params tree."""
    return tree_map(lambda d: d.axes, defs)


def unstack(tree, dims: int = 1) -> list:
    """The layers of a tree stacked over its first ``dims`` dims, in
    order, as views: one ``unbind`` a leaf, so autograd writes each stacked
    gradient once (indexing would write a full-size one a layer)."""
    cols = tree_map(lambda t: t.flatten(0, dims - 1).unbind(0), tree)
    n = len(next(tree_leaves(cols))[1])
    return [tree_map(lambda c, i=i: c[i], cols) for i in range(n)]


def stacked(defs, n: int):
    """Add a leading scan ("layers") dim to every ParamDef in the tree."""
    return tree_map(
        lambda d: ParamDef((n,) + d.shape, (LAYERS,) + d.axes, d.init,
                           d.scale, d.dtype), defs)


def param_count(defs) -> int:
    return sum(int(np.prod(d.shape)) for _, d in tree_leaves(defs))
