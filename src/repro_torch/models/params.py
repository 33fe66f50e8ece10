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


def compute_dtype(dtype, shape, compute) -> torch.dtype:
    """The cast rule of a model computing in ``compute`` (JAX's
    ``_cast_for_compute``): a float32 leaf of rank > 1 is held in
    ``compute``, any other leaf keeps ``dtype``.  A stacked leaf's rank
    counts its ``layers`` dim, so the per-layer norm scales are cast and
    ``final_norm`` (rank 1) stays float32.  ``dtype`` and ``shape`` are a
    leaf's, or a ParamDef's container dtype and shape."""
    return compute if dtype == torch.float32 and len(shape) > 1 else dtype


def init_param(defn: ParamDef, generator: torch.Generator, dtype,
               device) -> torch.Tensor:
    """Draw one leaf in float32 (its def's own dtype, if it has one) and
    hold it as a model computing in ``dtype`` holds it (``compute_dtype``).

    A leaf stacked over ``layers`` is drawn a slice of its first dim at a
    time, in order, into the leaf it is held in, so no float32 piece
    larger than one slice is made: a bf16 model of 64 layers never holds
    a float32 copy of a stacked leaf.  The values are the cast of the
    float32 leaf drawn the same way, bit for bit."""
    dt = defn.dtype or torch.float32
    held = compute_dtype(dt, defn.shape, dtype)
    if defn.init == "zeros":
        return torch.zeros(defn.shape, dtype=held, device=device)
    if defn.init == "ones":
        return torch.ones(defn.shape, dtype=held, device=device)
    if defn.init == "scaled":  # 1/sqrt(fan_in) normal, fan-in of the stack
        std = (defn.scale or 1.0) / math.sqrt(max(_fan_in(defn.shape), 1))
    else:
        std = defn.scale if defn.scale is not None else 0.02

    def draw(shape):
        if defn.init == "uniform":
            lim = defn.scale or 1.0
            out = torch.empty(shape, dtype=dt, device=device)
            return out.uniform_(-lim, lim, generator=generator)
        out = torch.randn(shape, dtype=torch.float32, device=device,
                          generator=generator)
        return out.mul_(std).to(dt)

    if defn.axes[:1] != (LAYERS,):
        return draw(defn.shape).to(held)
    out = torch.empty(defn.shape, dtype=held, device=device)
    for piece in out:
        piece.copy_(draw(defn.shape[1:]))
    return out


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


def init_params(defs, generator: torch.Generator, dtype=torch.float32,
                device="cuda"):
    """Materialize a ParamDef tree into tensors on ``device``, held as a
    model computing in ``dtype`` holds them (``init_param``): float32 gives
    the float32 tree, bf16 its cast for serving, drawn without it.

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


def param_bytes(defs, dtype=torch.float32) -> int:
    """The bytes of the tree ``init_params(defs, ..., dtype)`` holds."""
    return sum(int(np.prod(d.shape)) * compute_dtype(
        d.dtype or torch.float32, d.shape, dtype).itemsize
        for _, d in tree_leaves(defs))
