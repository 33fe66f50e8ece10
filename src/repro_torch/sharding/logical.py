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
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterable, Optional

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
def use_rules(mesh, mapping: AxisMap = TRAIN_RULES):
    rules = ShardingRules(mesh, mapping) if mesh is not None else None
    token = _current.set(rules)
    try:
        yield rules
    finally:
        _current.reset(token)


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
    through, its spec resolved (and any fallback recorded) all the same."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"shard(): {len(axes)} axes for rank-{x.ndim} array")
    spec = rules.spec(axes, tuple(x.shape))
    if getattr(x, "device_mesh", None) is rules.mesh:
        return x.redistribute(rules.mesh, placements(spec, rules.mesh))
    return x


def param_shardings(defs, mesh, mapping: AxisMap = TRAIN_RULES):
    """NamedSharding tree for a ParamDef tree, and the rules (with what
    they dropped)."""
    rules = ShardingRules(mesh, mapping)
    return pdefs.tree_map(
        lambda d: NamedSharding(mesh, rules.spec(d.axes, d.shape)),
        defs), rules
