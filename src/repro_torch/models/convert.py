"""Carry a JAX parameter tree over to the port's ``Model``.

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
