"""Per-op cost of an eager step: the dry-run's counterpart of ``hlo_cost``.

The reference lowers a step to XLA HLO and rolls its ``while`` bodies up
(``repro.launch.hlo_cost``).  The port runs eagerly, so every layer's ops
are dispatched one by one and there is nothing to roll up: ``measure``
runs a step once under two dispatch modes and sums what they see.

  * flops — ``torch.utils.flop_counter.FlopCounterMode``: matmuls,
            convolutions and attention, 2 x multiply-adds; elementwise
            ops are not counted (as the reference counts dot products
            only).  ``wkv6`` on meta is one custom op whose formulas
            (``kernels.meta``) equal the plain version's count.
  * bytes — per aten op: every tensor operand and every tensor result,
            each once (numel x element size), skipping the ops that move
            no data (views, ``detach``, ``alias``, ``empty``), as the
            reference skips ``parameter``, ``bitcast`` and friends.
  * ops   — how many aten ops that moved data were dispatched.

All three are global quantities for the whole step on one device.  They
are counted on whatever device the step's tensors are on; on meta tensors
nothing is allocated or computed.  The reference's HLO parser has no
counterpart; its collective counts are ``launch.collectives``'.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import meta

_aten = torch.ops.aten
_NO_DATA_OPS = frozenset({
    _aten.detach, _aten.alias, _aten.lift_fresh, _aten.empty,
    _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten._unsafe_view,
})


@dataclasses.dataclass
class OpCost:
    flops: int = 0
    bytes: int = 0
    ops: int = 0


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _ByteCounter(TorchDispatchMode):
    """Sums the operand and result bytes of every aten op that moves
    data."""

    def __init__(self, cost: OpCost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not (func.is_view or func.overloadpacket in _NO_DATA_OPS):
            self.cost.ops += 1
            self.cost.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def measure(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once; returns (its result, OpCost)."""
    meta.register()       # before the counter copies the flop registry
    cost = OpCost()
    with FlopCounterMode(display=False) as flops, _ByteCounter(cost):
        out = fn(*args, **kwargs)
    cost.flops = flops.get_total_flops()
    return out, cost
