"""Trainer: OVERLORD data plane -> train step on the card, with the JAX
package's checkpoint format: the port of ``repro.train.trainer``.

The loop is the reference's: every data-fetching client's view of a step is
concatenated into the global batch on the host, the numpy rows go to the
device (through pinned memory on a CUDA device), one train step runs, and
the Overlord hears ``step_done``.  A checkpoint holds the train state's
leaves in ``jax.tree.flatten(TrainState)`` order, so one written by either
package loads into the other.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.orchestrator import Overlord
from repro_torch.models.model_zoo import Model
from repro_torch.models.params import tree_leaves
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (
    TrainState, init_train_state, make_train_step,
)


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def state_leaves(state: TrainState) -> list[torch.Tensor]:
    """The leaves of ``state`` in ``jax.tree.flatten(TrainState)`` order:
    the params by sorted key path, then ``opt.step``, ``mu`` and ``nu``."""
    return ([t for _, t in tree_leaves(state.params)] + [state.opt.step]
            + [t for _, t in tree_leaves(state.opt.mu)]
            + [t for _, t in tree_leaves(state.opt.nu)])


class Trainer:
    """Single-process trainer consuming OVERLORD batches.

    ``model`` holds its own weights, so there is no ``seed`` argument (the
    JAX trainer draws the weights from one): they become the float32 master
    weights of ``train_step.init_train_state``.  The batches go to the
    model's device.
    """

    def __init__(self, model: Model, overlord: Overlord,
                 cfg: TrainerConfig = TrainerConfig()):
        self.model = model
        self.device = model.device
        self.ov = overlord
        self.cfg = cfg
        self.state = init_train_state(model)
        self.step_fn = make_train_step(model, cfg.opt)
        self.history: list[dict] = []

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _assemble_global_batch(self, step: int) -> dict:
        """Pull every data-fetching client's view; concatenate bucket/bin
        rows into the global batch."""
        axis = self.ov.cfg.strategy_params.get("axis", "DP")
        parts = []
        for rank in self.ov.tree.data_fetching_clients(axis):
            view = self.ov.get_batch(step, rank)
            if view["role"] != "data" or view.get("cp_rank", 0) != 0:
                continue
            for b in view["bins"]:
                parts.append(b)
        tokens = np.concatenate([p.tokens for p in parts], 0)
        seg = np.concatenate([p.segment_ids for p in parts], 0)
        pos = np.concatenate([p.positions for p in parts], 0)
        labels = np.concatenate([p.labels for p in parts], 0)
        return {k: self._to_device(v) for k, v in (
            ("tokens", tokens), ("segment_ids", seg), ("positions", pos),
            ("labels", labels))}

    def train(self, steps: Optional[int] = None) -> list[dict]:
        """``fetch_s`` is host time before the step; ``step_s`` ends when
        the loss reaches the host, which waits for the step to finish."""
        steps = steps or self.cfg.steps
        for step in range(steps):
            t0 = time.time()
            batch = self._assemble_global_batch(step)
            fetch_s = time.time() - t0
            t1 = time.time()
            self.state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])
            rec = {"step": step, "loss": loss,
                   "accuracy": float(metrics["accuracy"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "fetch_s": round(fetch_s, 4),
                   "step_s": round(time.time() - t1, 4)}
            self.history.append(rec)
            self.ov.step_done(step, {"loss": loss})
            if step % self.cfg.log_every == 0:
                print(f"step {step:5d} loss {loss:8.4f} "
                      f"acc {rec['accuracy']:.3f} "
                      f"fetch {fetch_s*1e3:6.1f}ms "
                      f"step {rec['step_s']*1e3:7.1f}ms", flush=True)
            if self.cfg.ckpt_dir and step and \
                    step % self.cfg.ckpt_every == 0:
                self.save_checkpoint(step)
        return self.history

    # ------------------------------------------------- unified checkpoint
    def save_checkpoint(self, step: int):
        os.makedirs(self.cfg.ckpt_dir, exist_ok=True)
        np.savez(os.path.join(self.cfg.ckpt_dir, f"model_{step}.npz"),
                 *[t.detach().cpu().numpy() for t in
                   state_leaves(self.state)])
        with open(os.path.join(self.cfg.ckpt_dir, f"meta_{step}.pkl"),
                  "wb") as f:
            pickle.dump({"step": step}, f)

    def load_checkpoint(self, step: int):
        """Copy a checkpoint's leaves into the state, in place; a leaf
        missing, extra or of another shape raises."""
        data = np.load(os.path.join(self.cfg.ckpt_dir,
                                    f"model_{step}.npz"))
        leaves = state_leaves(self.state)
        if len(data.files) != len(leaves):
            raise ValueError(f"checkpoint holds {len(data.files)} leaves, "
                             f"the train state {len(leaves)}")
        with torch.no_grad():
            for i, t in enumerate(leaves):
                a = data[f"arr_{i}"]
                if tuple(a.shape) != tuple(t.shape):
                    raise ValueError(f"leaf {i}: shape {a.shape}, want "
                                     f"{tuple(t.shape)}")
                t.copy_(torch.from_numpy(a))
