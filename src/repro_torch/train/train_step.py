"""Loss and train/serve step factories: the port of ``repro.train.train_step``.

Training keeps float32 master weights (the model's own leaves, trainable)
and computes in bf16: the loss casts a bf16 copy of every float32 leaf of
rank > 1 on each step, by a differentiable cast, so the gradients land
float32 on the master leaves, as in the reference's ``loss_fn``.  Serving
casts the leaves themselves, once and in place (``_cast_for_compute``),
which a trainer must never do.

Every step also runs on a model and batch of DTensors (a sharded step):
the leaves placed by ``sharding.logical.param_shardings``' specs
(``model_zoo.distribute_model``), the moments like their params, the
batch by ``model_zoo.batch_logical_axes``, under ``sharding.use_rules`` on
the same ``DeviceMesh``.  The step then runs in ``sharding.sharded``'s
context, and the models' ``shard`` constraints redistribute the
activations.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.models.model_zoo import Model
from repro_torch.models.params import compute_dtype, tree_leaves, tree_map
from repro_torch.sharding.logical import dtensor_mesh, placed_like, sharded
from repro_torch.train.optimizer import (
    AdamWConfig, AdamWState, adamw_update, init_adamw,
)

COMPUTE_DTYPE = torch.bfloat16
AUX_LOSS_WEIGHT = 0.01


class TrainState(NamedTuple):
    params: dict      # the model's float32 leaves, requiring grad
    opt: AdamWState


def init_train_state(model: Model) -> TrainState:
    """Make ``model``'s float32 leaves the trainable master weights and
    start AdamW with zero moments."""
    not_f32 = [n for n, p in model.named_parameters()
               if p.dtype != torch.float32]
    if not_f32:
        raise ValueError(f"master weights must be float32; {not_f32} are not "
                         "(a model cast for serving cannot train)")
    model.requires_grad_(True)
    params = model.tree()
    return TrainState(params=params, opt=init_adamw(params))


def _compute_copy(params: dict) -> dict:
    """A bf16 copy of every float32 leaf of rank > 1, through autograd."""
    return tree_map(lambda p: p.to(compute_dtype(p.dtype, p.shape,
                                                 COMPUTE_DTYPE)), params)


def _vocab_local(fn, logits, *rest, reduce_op: str):
    """``fn(local logits, *rest)`` on each rank's vocab shard of DTensor
    ``logits`` (last dim) through ``local_map``.  ``fn`` gets the global
    index of its first vocab entry; ``rest`` (the logits' shape without
    the vocab) and the output are placed like the logits elsewhere, and the
    output is a ``Partial(reduce_op)`` over the vocab's mesh dims."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )
    from torch.distributed.tensor.experimental import local_map
    vdim = logits.ndim - 1
    mesh = logits.device_mesh
    keep = tuple(p if p.is_shard() and p.dim != vdim else Replicate()
                 for p in logits.placements)
    out = tuple(Partial(reduce_op) if p.is_shard() and p.dim == vdim else q
                for p, q in zip(logits.placements, keep))
    _, first = compute_local_shape_and_global_offset(
        logits.shape, mesh, logits.placements)
    return local_map(functools.partial(fn, first[vdim]),
                     out_placements=(out,),
                     in_placements=(logits.placements,) + (keep,) * len(rest),
                     device_mesh=mesh, redistribute_inputs=True)(
        logits, *rest)


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]`` (labels clamped at 0).  On DTensor logits
    each vocab shard picks the labels in its range (DTensor's own gather
    over a sharded vocab fails), a ``Partial`` sum of one non-zero term."""
    idx = torch.clamp(labels, min=0).long()
    if dtensor_mesh(logits) is None:
        return torch.gather(logits, -1, idx[..., None])[..., 0]

    def pick(first, lg, ix):
        ix = ix - first
        inside = (ix >= 0) & (ix < lg.shape[-1])
        g = torch.gather(lg, -1, torch.where(inside, ix, 0)[..., None])
        return torch.where(inside, g[..., 0], 0.0)
    return _vocab_local(pick, logits, idx, reduce_op="sum")


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    """``argmax`` over the last dim, the first index of the maximum.  On
    DTensor logits, the maximum (a reduction DTensor places), then each
    vocab shard's first index that reaches it, a ``Partial`` min
    (DTensor's own argmax over a sharded vocab fails on gloo)."""
    if dtensor_mesh(logits) is None:
        return torch.argmax(logits, -1)
    top = torch.amax(logits, -1)

    def first_max(first, lg, m):
        idx = torch.arange(lg.shape[-1], device=lg.device) + first
        at = torch.where(lg == m[..., None], idx, torch.iinfo(idx.dtype).max)
        return torch.amin(at, -1)
    return _vocab_local(first_max, logits, top, reduce_op="min")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean masked token xent (fp32) + accuracy."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = _gold(logits, labels)
    nll = (logz - gold) * mask
    denom = torch.clamp(torch.sum(mask), min=1.0)
    acc = torch.sum((_argmax(logits) == labels) * mask) / denom
    return torch.sum(nll) / denom, acc


def make_loss_fn(model: Model):
    """``loss_fn(params, batch) -> (total, metrics)`` on the bf16 copy of
    ``params`` (the master tree); batch: (b, s) tensors ``tokens``,
    ``segment_ids``, ``positions`` and ``labels`` (-1 where no loss), and
    whatever else the model reads (an audio model's ``enc_embeds``), passed
    through whole."""
    def loss_fn(params, batch):
        with sharded(params):
            logits, aux = model.forward(batch, _compute_copy(params))
            labels = batch["labels"]
            mask = ((labels >= 0) & (batch["segment_ids"] > 0)).float()
            loss, acc = cross_entropy(logits, labels, mask)
            total = loss + AUX_LOSS_WEIGHT * aux
            return total, {"loss": loss, "aux_loss": aux, "accuracy": acc,
                           "tokens": torch.sum(mask)}
    return loss_fn


def make_train_step(model: Model, opt_cfg: AdamWConfig = AdamWConfig()):
    """``train_step(state, batch) -> (state, metrics)``: forward, backward,
    AdamW.  The master weights and moments are updated in place; the
    gradients are dropped after the update.  Metrics stay on the device."""
    loss_fn = make_loss_fn(model)

    def train_step(state: TrainState, batch):
        with sharded(state.params):
            total, metrics = loss_fn(state.params, batch)
            total.backward()
            grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                             else placed_like(p.grad, p), state.params)
            params, opt, opt_metrics = adamw_update(opt_cfg, grads,
                                                    state.opt, state.params)
        for _, p in tree_leaves(params):
            p.grad = None
        metrics = dict(metrics, total_loss=total, **opt_metrics)
        return TrainState(params, opt), {k: v.detach()
                                         for k, v in metrics.items()}

    return train_step


def _cast_for_compute(model: Model) -> Model:
    """Cast every float32 leaf of rank > 1 to ``COMPUTE_DTYPE``, in place.

    The rule is JAX's (``params.compute_dtype``, which the draw of a served
    model applies too), on the same stacked shapes: the per-layer norm
    scales (and RWKV6's ``u``, ``w0`` and ``mu_*``) are rank 2 or more
    because of the ``layers`` dim, so they become bf16 too, while
    ``final_norm`` (rank 1) stays float32.  JAX casts inside every jitted
    call; the port casts once, leaf by leaf, so the float32 tree is freed
    as it goes instead of a second full-size copy being made per call.
    The cast is deterministic, so the numbers are the same.  A model drawn
    in ``COMPUTE_DTYPE`` (``serve.run``) is already cast: nothing changes.
    """
    for name, p in list(model.named_parameters()):
        if compute_dtype(p.dtype, p.shape, COMPUTE_DTYPE) == p.dtype:
            continue
        if dtensor_mesh(p) is None:
            p.data = p.data.to(COMPUTE_DTYPE)
        else:   # a DTensor's .data takes the dtype but keeps its shards'
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner), leaf, torch.nn.Parameter(
                p.detach().to(COMPUTE_DTYPE), requires_grad=False))
    return model


def make_prefill_step(model: Model):
    """``prefill_step(batch) -> (logits, cache)`` on the bf16 weights."""
    _cast_for_compute(model)

    @torch.no_grad()
    def prefill_step(batch):
        with sharded(model.tree()):
            return model.prefill(batch)
    return prefill_step


def make_decode_step(model: Model):
    """``decode_step(cache, tokens, pos) -> (logits, cache)`` on the bf16
    weights; the cache is updated in place."""
    _cast_for_compute(model)

    @torch.no_grad()
    def decode_step(cache, tokens, pos: int):
        with sharded(model.tree()):
            return model.decode_step(cache, tokens, pos)
    return decode_step
