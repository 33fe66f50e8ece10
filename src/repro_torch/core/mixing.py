"""Data-mixture schedules for the ``mix()`` primitive (paper §4.2).

A schedule maps a training step to per-source sampling weights.  Supports
the paper's scheduled modes (static ratios, staged/warmup curricula) and
the dynamic mode driven by runtime metrics (loss/entropy-adaptive), at
epoch/step/substep granularity.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np


def _normalize(w: dict[str, float]) -> dict[str, float]:
    tot = sum(max(v, 0.0) for v in w.values())
    if tot <= 0:
        n = len(w)
        return {k: 1.0 / n for k in w}
    return {k: max(v, 0.0) / tot for k, v in w.items()}


class MixSchedule:
    def weights(self, step: int) -> dict[str, float]:
        raise NotImplementedError

    def observe(self, step: int, metrics: dict) -> None:
        """Hook for dynamic schedules (loss/entropy feedback)."""

    @property
    def sources(self) -> list[str]:
        return sorted(self.weights(0))


@dataclasses.dataclass
class StaticSchedule(MixSchedule):
    ratios: dict[str, float]

    def weights(self, step: int) -> dict[str, float]:
        return _normalize(self.ratios)


@dataclasses.dataclass
class StagedSchedule(MixSchedule):
    """[(until_step, ratios), ...] — warmup / staged training (Gemini-style)."""
    stages: list[tuple[int, dict[str, float]]]

    def weights(self, step: int) -> dict[str, float]:
        for until, ratios in self.stages:
            if step < until:
                return _normalize(ratios)
        return _normalize(self.stages[-1][1])


@dataclasses.dataclass
class CurriculumSchedule(MixSchedule):
    """Easy-to-hard: linearly ramps hard-source weight over ramp_steps."""
    easy: dict[str, float]
    hard: dict[str, float]
    ramp_steps: int

    def weights(self, step: int) -> dict[str, float]:
        t = min(max(step / max(self.ramp_steps, 1), 0.0), 1.0)
        keys = set(self.easy) | set(self.hard)
        return _normalize({
            k: (1 - t) * self.easy.get(k, 0.0) + t * self.hard.get(k, 0.0)
            for k in keys})


class AdaptiveSchedule(MixSchedule):
    """Loss-driven reweighting: sources with higher recent loss get more
    weight (softmax over EMA losses / temperature)."""

    def __init__(self, base: dict[str, float], temperature: float = 1.0,
                 ema: float = 0.9):
        self.base = _normalize(base)
        self.temperature = temperature
        self.ema = ema
        self._loss: dict[str, float] = {}

    def observe(self, step: int, metrics: dict) -> None:
        for src, loss in metrics.get("per_source_loss", {}).items():
            prev = self._loss.get(src, loss)
            self._loss[src] = self.ema * prev + (1 - self.ema) * loss

    def weights(self, step: int) -> dict[str, float]:
        if not self._loss:
            return dict(self.base)
        mx = max(self._loss.values())
        boost = {k: math.exp((self._loss.get(k, mx) - mx)
                             / max(self.temperature, 1e-6))
                 for k in self.base}
        return _normalize({k: self.base[k] * boost.get(k, 1.0)
                           for k in self.base})


def sample_counts(weights: dict[str, float], total: int,
                  rng: np.random.Generator) -> dict[str, int]:
    """Integer sample counts per source for one global batch, stochastic
    rounding so long-run ratios match weights exactly."""
    w = _normalize(weights)
    names = sorted(w)
    probs = np.array([w[n] for n in names])
    draws = rng.multinomial(total, probs)
    return {n: int(c) for n, c in zip(names, draws)}
