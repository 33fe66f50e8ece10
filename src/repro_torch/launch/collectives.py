"""Per-device collectives of a sharded step: the port of the collective half
of ``repro.launch.hlo_cost`` and ``repro.launch.hlo_analysis``.

The reference reads the collectives that GSPMD placed from the compiled,
per-device HLO.  The port compiles nothing: its sharded step runs eagerly
on DTensors, and each redistribution a DTensor op or a ``shard`` constraint
needs issues one functional collective (``torch.ops._c10d_functional``).
``count`` runs a step once under ``CommDebugMode`` and records, for every
collective, its kind under the reference's names, the bytes of its result
on one device, and the size of its group; ``wire_bytes`` turns a result
into the bytes one device sends by the reference's ring formulas
(``hlo_cost._collective_wire``, copied below).  So the three tallies mean
what the reference's ``collective_counts``, ``collective_result_bytes``
and ``collective_wire_bytes`` mean: per device, for one step.

The step runs on meta shards in a fake world (``fake_mesh``): every rank's
process group is ``torch.testing._internal.distributed.fake_pg``'s, which
moves nothing, so one process on any machine plays rank 0 of a 256- or
512-device mesh.  Rank 0's collectives are every rank's: the sharding
rules place every rank alike.

One substitution keeps the counts those of a CUDA mesh.  DTensor moves a
``Shard(i) -> Shard(j)`` redistribution over one mesh dim (the MoE's expert
transpose) by one all-to-all, except on a mesh whose device type is
``cpu``: gloo has no all-to-all, and
``torch.distributed.tensor._collective_utils.shard_dim_alltoall`` gathers
everything and keeps a chunk instead.  The fake mesh is a ``cpu`` mesh, so
while ``count`` runs, that function is replaced (where
``placement_types`` calls it) by ``_shard_dim_alltoall``: the one
``all_to_all_single`` that the CUDA path issues, with the same result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from repro_torch.launch.mesh import named_mesh

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "ragged-all-to-all", "collective-permute")
WORLD = 512          # the multi-pod mesh; the single pod is its first 256

# functional collectives (native and legacy namespaces), by name -> the
# reference's kind
_SPACES = ("_c10d_functional", "c10d_functional")
_KIND = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def wire_bytes(op: str, rb: float, n: int) -> float:
    """Bytes one device sends for a collective whose result on it is ``rb``
    bytes, over a group of ``n``: ``hlo_cost._collective_wire``, copied."""
    if op == "all-reduce":
        return 2 * (n - 1) / n * rb
    if op == "all-gather":
        return (n - 1) / n * rb
    if op == "reduce-scatter":
        return (n - 1) * rb
    if op in ("all-to-all", "ragged-all-to-all"):
        return (n - 1) / n * rb
    return rb  # collective-permute


@dataclasses.dataclass
class Collectives:
    """The reference's three per-device tallies, keyed by ``KINDS``."""
    counts: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in KINDS})
    result_bytes: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in KINDS})
    wire_bytes: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in KINDS})
    # each collective in order: (kind, its result's shape, group size)
    each: list = dataclasses.field(default_factory=list)

    def add(self, kind: str, rb: int, n: int, shape: tuple = ()) -> None:
        self.each.append((kind, tuple(shape), n))
        self.counts[kind] += 1
        self.result_bytes[kind] += rb
        self.wire_bytes[kind] += wire_bytes(kind, rb, n)

    @property
    def total(self) -> int:
        return sum(self.counts.values())


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in args if isinstance(a, str)]   # a reduce op, the group
    if names:
        return _resolve_process_group(names[-1]).size()
    raise ValueError(f"no group name among a collective's arguments {args}")


def _counter(tally: Collectives):
    from torch.distributed.tensor.debug import CommDebugMode

    class Counter(CommDebugMode):
        """CommDebugMode that also tallies each collective's kind, result
        bytes and group size."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            packet = getattr(func, "_overloadpacket", None)
            space, _, name = getattr(packet, "_qualified_op_name",
                                     "").partition("::")
            kind = _KIND.get(name) if space in _SPACES else None
            if out is not NotImplemented and kind is not None:
                tally.add(kind, out.numel() * out.element_size(),
                          _group_size(args), out.shape)
            return out
    return Counter()


def _shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """What the CUDA path of ``shard_dim_alltoall`` computes, as one
    ``all_to_all_single`` over ``mesh_dim``: this rank's chunks along
    ``shard_dim`` go one to each peer, and the pieces received are joined
    along ``gather_dim``."""
    from torch.distributed import _functional_collectives as funcol
    n = mesh.size(mesh_dim)
    sent = torch.cat(torch.chunk(input, n, dim=shard_dim), dim=0)
    got = funcol.all_to_all_single(sent.contiguous(), None, None,
                                   (mesh, mesh_dim))
    got = funcol.wait_tensor(got)
    return torch.cat(torch.chunk(got, n, dim=0), dim=gather_dim).contiguous()


@contextlib.contextmanager
def _cuda_alltoall():
    from torch.distributed.tensor import placement_types
    saved = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = _shard_dim_alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = saved


def count(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under ``CommDebugMode``; returns
    (its result, the ``Collectives`` it issued on this rank)."""
    tally = Collectives()
    with _cuda_alltoall(), _counter(tally):
        out = fn(*args, **kwargs)
    return out, tally


@contextlib.contextmanager
def fake_mesh(name):
    """The named mesh (``launch.mesh.named_mesh``) as a ``cpu``
    DeviceMesh over the first ranks of one fake world of ``WORLD`` ranks,
    this process rank 0.  Starts the fake process group, and destroys it
    at exit; refuses to run inside another process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_mesh needs a process without a process "
                           "group: its fake world would replace the "
                           "running one")
    shape = named_mesh(name)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    try:
        n = math.prod(shape.sizes)
        yield DeviceMesh("cpu", torch.arange(n).reshape(shape.sizes),
                         mesh_dim_names=shape.axis_names)
    finally:
        dist.destroy_process_group()
