"""Carry a JAX parameter tree, or a JAX train state, over to the port.

The tree arrives as numpy arrays in the nested-dict form of
``repro.models.params.init_params`` (``jax.tree.map(np.asarray, params)``);
this module never imports JAX.  Loading is strict: a missing, extra or
misshapen leaf raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model_zoo import Model, model_defs
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train.optimizer import AdamWState
from repro_torch.train.train_step import TrainState, init_train_state


def params_from_jax(np_tree: dict, cfg: ModelConfig, device="cuda",
                    dtype=torch.float32) -> Model:
    """A ``Model`` holding ``np_tree``'s values on ``device``.

    Each leaf takes its ParamDef's dtype override (float32 norm scales) or
    else ``dtype``, as ``init_params`` would have made it.
    """
    defs = model_defs(cfg)
    dtypes = {path: d.dtype or dtype for path, d in tree_leaves(defs)}
    model = Model(cfg, tree_map(
        lambda d: torch.empty(d.shape, dtype=d.dtype or dtype,
                              device="meta"), defs))
    state = {
        path: torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=device, dtype=dtypes.get(path, dtype))
        for path, arr in tree_leaves(np_tree)}
    model.load_state_dict(state, strict=True, assign=True)
    return model


def train_state_from_jax(np_state, cfg: ModelConfig, device="cuda"):
    """``(Model, train_step.TrainState)`` holding a JAX ``TrainState`` whose
    leaves are numpy arrays (``jax.tree.map(np.asarray, state)``): its
    ``params`` as the float32 master weights, and its ``opt.step``,
    ``opt.mu`` and ``opt.nu``."""
    model = params_from_jax(np_state.params, cfg, device)
    state = init_train_state(model)

    def load(dst: dict, src: dict, name: str) -> dict:
        dst_leaves, src_leaves = list(tree_leaves(dst)), list(
            tree_leaves(src))
        if [p for p, _ in dst_leaves] != [p for p, _ in src_leaves]:
            raise ValueError(f"{name}: leaves differ from the params'")
        for (path, t), (_, arr) in zip(dst_leaves, src_leaves):
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{name}.{path}: shape {arr.shape}, want "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
        return dst

    opt = AdamWState(
        step=torch.tensor(int(np_state.opt.step), dtype=torch.int32,
                          device=device),
        mu=load(state.opt.mu, np_state.opt.mu, "mu"),
        nu=load(state.opt.nu, np_state.opt.nu, "nu"))
    return model, TrainState(state.params, opt)
