"""Logical-axis sharding rules with divisibility fallback: the port of
``repro.sharding.logical``.

Models annotate params and caches with *logical* axis names
(models/params.py).  A :class:`ShardingRules` maps logical names onto mesh
axes.  Resolution is shape-aware: a mapping is dropped (replicated) when the
dim is not divisible by the mesh-axis product — this is what lets one rule
table serve every assigned architecture (e.g. 24 attention heads or 40
experts cannot shard 16-way; they fall back to replication instead of
failing).  Dropped mappings are recorded for the dry-run's report.

The rule tables, the resolution and the fallback are the reference's.  The
mesh is anything with axis names and sizes: ``launch.mesh.MeshShape`` (the
production meshes, with no devices) or a ``torch.distributed`` DeviceMesh.
A :class:`PartitionSpec` holds one entry a dim (``None``, an axis name or a
tuple of axis names), normalised as ``jax.sharding.PartitionSpec``
normalises its entries, so the two compare entry by entry.  ``placements``
turns a spec into DTensor placements; ``local_shape`` gives a shard's shape.

``shard`` is the models' activation constraint.  The rest runs a step on
DTensors: ``distribute`` and ``distribute_tree`` place tensors by the
rules, ``sharded`` is the context a sharded step runs in,
``on_shards`` and ``batch_local`` run a function on each rank's local
shards (``local_map``), ``seq_split_dims`` names the mesh dims that split
a KV cache's sequence, and ``placed_like`` puts a gradient on its
param's placements.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import Iterable, Optional

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.models import params as pdefs

AxisMap = dict[str, tuple[str, ...]]

# --- rule tables --------------------------------------------------------
# fsdp := ("pod", "data"); tensor := ("model",).  Axes absent from the
# active mesh are silently skipped at resolution time, so the same table
# works for the single-pod (data, model) and multi-pod (pod, data, model)
# production meshes as well as 1-device local meshes.

_COMMON: AxisMap = {
    # params
    pdefs.EMBED: ("pod", "data"),
    pdefs.MLP: ("model",),
    pdefs.HEADS: ("model",),
    pdefs.KV_HEADS: (),            # GQA kv heads: replicated
    pdefs.HEAD_DIM: (),
    pdefs.VOCAB: ("model",),
    pdefs.EXPERT: ("model",),      # expert parallelism on the tensor axis
    pdefs.LAYERS: (),
    pdefs.SSM_STATE: (),
    pdefs.SSM_INNER: ("model",),
    pdefs.RWKV_HEADS: ("model",),
    pdefs.LORA: (),
    pdefs.CONV: (),
    pdefs.FRAMES: (),
    # activations
    "batch": ("pod", "data"),
    "seq": (),
    "act_embed": (),
    "act_heads": ("model",),
    "act_kv_heads": (),
    "act_mlp": ("model",),
    "act_vocab": ("model",),
    "act_expert": ("model",),
    "act_ssm": ("model",),
    "kv_seq": (),
    "cap": (),
}

TRAIN_RULES: AxisMap = dict(_COMMON)

# Decode: KV cache sequence dim is sharded over the tensor axis
# ("KV-sequence-parallel flash-decode"); query heads stay replicated for the
# single-token step.
DECODE_RULES: AxisMap = dict(_COMMON)
DECODE_RULES.update({
    "kv_seq": ("model",),
    "act_heads": (),
})

# Long-context decode (batch=1): nothing to shard on the batch axis, so the
# KV/state sequence dim takes both data and tensor axes.
LONG_DECODE_RULES: AxisMap = dict(_COMMON)
LONG_DECODE_RULES.update({
    "kv_seq": ("data", "model"),
    "act_heads": (),
})


class PartitionSpec(tuple):
    """One entry a dim: ``None`` (replicated), a mesh axis name, or a tuple
    of names.  A one-name tuple becomes the name and an empty one ``None``,
    as in ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` in the mesh's axis order, for a ``MeshShape``
    (or any object with ``axis_names`` and a ``shape`` dict) or a
    DeviceMesh (``mesh_dim_names`` and a ``shape`` tuple)."""
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    shape = mesh.shape
    if isinstance(shape, dict):
        return {n: int(shape[n]) for n in names}
    return dict(zip(names, (int(s) for s in shape)))


def local_shape(spec: PartitionSpec, shape: tuple[int, ...],
                mesh) -> tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` tensor under
    ``spec``."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for i, dim in enumerate(shape):
        n = 1
        for a in _entry_axes(spec[i] if i < len(spec) else None):
            n *= sizes[a]
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {spec[i]!r} ({n} devices)")
        out.append(dim // n)
    return tuple(out)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec``, one a mesh dim: ``Shard(d)`` where
    the mesh axis shards tensor dim ``d``, else ``Replicate()``.  A dim
    sharded over several mesh axes takes them in the mesh's order, which
    is DTensor's; a spec that lists them in another order raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{entry!r} is not in the mesh's axis order "
                             f"{tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass
class ShardingRules:
    mesh: object
    mapping: AxisMap
    # (logical axis, dim, axes) combos that fell back to replication:
    dropped: list[tuple[str, int, tuple[str, ...]]] = dataclasses.field(
        default_factory=list)

    def resolve_axis(self, logical: Optional[str], dim: int,
                     used: set[str]) -> Optional[tuple[str, ...]]:
        """Resolve one logical axis for a dim of the given size."""
        if logical is None or self.mesh is None:
            return None
        sizes = mesh_axis_sizes(self.mesh)
        axes = self.mapping.get(logical, ())
        axes = tuple(a for a in axes if a in sizes and a not in used)
        if not axes:
            return None
        size = 1
        for a in axes:
            size *= sizes[a]
        if size <= 1:
            return None
        if dim % size != 0:
            # try progressively shorter prefixes before replicating
            for cut in range(len(axes) - 1, 0, -1):
                sub = axes[:cut]
                s = 1
                for a in sub:
                    s *= sizes[a]
                if s > 1 and dim % s == 0:
                    self.dropped.append((logical, dim, axes[cut:]))
                    return sub
            self.dropped.append((logical, dim, axes))
            return None
        return axes

    def spec(self, axes: Iterable[Optional[str]],
             shape: tuple[int, ...]) -> PartitionSpec:
        used: set[str] = set()
        out = []
        for logical, dim in zip(axes, shape):
            r = self.resolve_axis(logical, dim, used)
            if r is None:
                out.append(None)
            else:
                used.update(r)
                # multi-axis mappings keep tuple form even when only one
                # mesh axis survives filtering (PartitionSpec then
                # normalises a one-name tuple, as JAX's does)
                multi = len(self.mapping.get(logical, ())) > 1
                out.append(r if (len(r) > 1 or multi) else r[0])
        return PartitionSpec(*out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``."""
    mesh: object
    spec: PartitionSpec

    def shard_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        return local_shape(self.spec, shape, self.mesh)

    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


_current: contextvars.ContextVar[Optional[ShardingRules]] = \
    contextvars.ContextVar("sharding_rules", default=None)


def current_rules() -> Optional[ShardingRules]:
    return _current.get()


@contextlib.contextmanager
def rules_in(rules: Optional[ShardingRules]):
    """``rules`` in force for the span of a ``with`` block (a remat
    recompute, on autograd's thread, enters again the rules that
    ``current_rules`` gave its forward)."""
    token = _current.set(rules)
    try:
        yield rules
    finally:
        _current.reset(token)


def use_rules(mesh, mapping: AxisMap = TRAIN_RULES):
    return rules_in(ShardingRules(mesh, mapping) if mesh is not None
                    else None)


def spec_for(axes: Iterable[Optional[str]],
             shape: tuple[int, ...]) -> PartitionSpec:
    rules = current_rules()
    if rules is None:
        return PartitionSpec()
    return rules.spec(axes, shape)


def shard(x, *axes: Optional[str]):
    """Apply a logical sharding constraint to an activation (no-op outside
    a ``use_rules`` context).  A DTensor on the rules' DeviceMesh is
    redistributed to the spec's placements; any other tensor passes
    through, its spec resolved (and any fallback recorded) all the same.
    The redistributed DTensor is made contiguous: a reduction that DTensor
    inserts can leave a local shard whose strides are not those DTensor
    records (an einsum's permuted output, summed over a sharded dim), and
    a later view of it then fails."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"shard(): {len(axes)} axes for rank-{x.ndim} array")
    spec = rules.spec(axes, tuple(x.shape))
    if on_mesh(x, rules.mesh):
        return x.redistribute(rules.mesh,
                              placements(spec, rules.mesh)).contiguous()
    return x


# --- DTensors -------------------------------------------------------------
def dtensor_mesh(x):
    """The DeviceMesh of a DTensor; None for any other object."""
    from torch.distributed.tensor import DTensor
    return x.device_mesh if isinstance(x, DTensor) else None


def on_mesh(x, mesh) -> bool:
    """Whether ``x`` is a DTensor on ``mesh`` (a DeviceMesh equal to it:
    DTensor's autograd can hand back an equal mesh, not the same object)."""
    own = dtensor_mesh(x)
    return own is not None and own == mesh


def sharded(tree) -> contextlib.AbstractContextManager:
    """The context a step on ``tree`` runs in.  When a leaf of ``tree``
    (nested dicts, lists and tuples) is a DTensor, every torch call made in
    it that mixes DTensors with plain tensors (the ``arange``s, masks and
    zeros a model makes) gets the plain ones as replicated DTensors on the
    same mesh, before autograd records them (``_Replicated``); and
    ``implicit_replication`` covers the plain tensors that autograd's own
    backward formulas make (a sort's zeros).  Else nothing."""
    from torch.utils._pytree import tree_leaves
    if not any(dtensor_mesh(x) is not None for x in tree_leaves(tree)):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    stack = contextlib.ExitStack()
    stack.enter_context(implicit_replication())
    stack.enter_context(_Replicated())
    return stack


class _Replicated(TorchFunctionMode):
    """Plain tensors that meet a DTensor in a torch call join it as
    replicated DTensors on its mesh."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_flatten, tree_unflatten
        flat, spec = tree_flatten((args, kwargs or {}))
        mesh = next((t.device_mesh for t in flat
                     if isinstance(t, DTensor)), None)
        if mesh is not None:
            flat = [DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)
                    if isinstance(t, torch.Tensor)
                    and not isinstance(t, DTensor) else t for t in flat]
        args, kwargs = tree_unflatten(flat, spec)
        return func(*args, **kwargs)


def seq_split_dims(cache) -> list[int]:
    """The mesh dims of more than one device over which a DTensor KV cache
    in ``kernels.ops``' (b, kh, S, d) layout splits its sequence (dim 2);
    ``[]`` for any other tensor."""
    mesh = dtensor_mesh(cache)
    if mesh is None:
        return []
    return [i for i, p in enumerate(cache.placements)
            if p.is_shard(2) and mesh.size(i) > 1]


def placed_like(t, ref):
    """``t`` redistributed to ``ref``'s placements when both are DTensors
    (a gradient to its param's shards: one reduce-scatter of a ``Partial``
    sum, not one a later op that meets the two); ``t`` otherwise."""
    mesh = dtensor_mesh(t)
    if mesh is None or dtensor_mesh(ref) is None:
        return t
    return t.redistribute(mesh, ref.placements)


def on_shards(fn, args, roles, out_roles, mesh_roles=None,
              with_offset: bool = False):
    """``fn`` on each rank's local shards of ``args`` through
    ``local_map``, its outputs DTensors again.

    ``roles[i]`` maps role names (``"b"`` batch, ``"h"`` heads, ``"e"``
    experts) to the dims of ``args[i]`` that ``fn`` computes independently
    over (or, as ``"s"`` a KV cache's sequence, that ``fn`` merges over
    with collectives of its own).  ``mesh_roles`` names the role each mesh dim shards (None: that
    dim is whole); by default, the role of the dim ``args[0]`` is sharded
    on there.  Every argument is redistributed to shard its dim of each
    mesh dim's role, and to be whole otherwise (``CommDebugMode`` counts
    what that moves); plain tensors join as replicated.  An argument whole
    on a mesh dim that shards a role it lacks (GQA keys cut to a rank's
    heads, a weight used by each batch shard) gets a gradient that is a
    ``Partial`` sum over that dim.  ``out_roles`` places the outputs
    alike; an output's ``"sum"`` entry names roles whose mesh dims hold it
    as a ``Partial`` sum (a product over a split contraction).  With
    ``with_offset``, ``fn`` gets first the global index of ``args[0]``'s
    local shard."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    args = [a if isinstance(a, DTensor) else DTensor.from_local(
        a, mesh, [Replicate()] * mesh.ndim, run_check=False) for a in args]
    if mesh_roles is None:
        by_dim = {d: r for r, d in roles[0].items()}
        mesh_roles = [by_dim.get(p.dim) if p.is_shard() else None
                      for p in args[0].placements]

    def place(r):
        return tuple(Shard(r[role]) if role in r else
                     Partial() if role in r.get("sum", ()) else Replicate()
                     for role in mesh_roles)
    in_pl = tuple(place(r) for r in roles)
    grad_pl = tuple(tuple(Partial() if role is not None and role not in r
                          else p for role, p in zip(mesh_roles, pl))
                    for r, pl in zip(roles, in_pl))
    run = fn
    if with_offset:
        _, first = compute_local_shape_and_global_offset(
            args[0].shape, mesh, in_pl[0])
        run = functools.partial(fn, tuple(first))
    return local_map(run, out_placements=tuple(place(r) for r in out_roles),
                     in_placements=in_pl, in_grad_placements=grad_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def batch_local(fn, args, mesh, whole: tuple = (), outputs: int = 1):
    """``fn`` on each rank's batch shard (dim 0 of every argument but those
    at the indices ``whole``, which stay whole, and of its ``outputs``
    outputs) through ``on_shards``: the batch split over the mesh's batch
    axes (``pod``, ``data``) when they divide it, else whole on every
    rank."""
    sizes = mesh_axis_sizes(mesh)
    batch_axes = [a for a in ("pod", "data") if a in sizes]
    n = 1
    for a in batch_axes:
        n *= sizes[a]
    split = args[0].shape[0] % n == 0
    mesh_roles = ["b" if split and a in batch_axes else None for a in sizes]
    b = {"b": 0}
    roles = tuple({} if i in whole else b for i in range(len(args)))
    return on_shards(fn, args, roles, (b,) * outputs, mesh_roles)


def distribute(t, spec: PartitionSpec, mesh):
    """``t`` as a DTensor on ``mesh`` with ``spec``'s placements: its shard
    of ``t`` on each rank (every rank holds the same ``t``), or, for a meta
    ``t``, a meta shard of the local shape (no data, no collective)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = placements(spec, mesh)
    if t.is_meta:
        local = torch.empty(local_shape(spec, tuple(t.shape), mesh),
                            dtype=t.dtype, device="meta")
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return distribute_tensor(t, mesh, pl)


def distribute_tree(tree, axes_tree, rules: ShardingRules):
    """Each leaf of ``tree`` distributed on the rules' mesh by the spec the
    rules give its logical axes (the leaf of ``axes_tree``), in sorted-key
    order, as ``param_shardings`` resolves them."""
    if isinstance(tree, dict):
        return {k: distribute_tree(tree[k], axes_tree[k], rules)
                for k in sorted(tree)}
    return distribute(tree, rules.spec(axes_tree, tuple(tree.shape)),
                      rules.mesh)


def param_shardings(defs, mesh, mapping: AxisMap = TRAIN_RULES):
    """NamedSharding tree for a ParamDef tree, and the rules (with what
    they dropped)."""
    rules = ShardingRules(mesh, mapping)
    return pdefs.tree_map(
        lambda d: NamedSharding(mesh, rules.spec(d.axes, d.shape)),
        defs), rules
