"""Sample transformations (the P term of the loader cost tuple (P, T, M)).

Each transform converts a raw storage record into a training-ready sample:
token ids (text) and patch-embedding token counts (image/video/audio).
Real work is done (deterministic tokenization from the record seed) so the
pipeline is end-to-end runnable; in addition every transform reports its
*virtual cost* in normalized cpu-units — the quantity the AutoScaler
provisions for (Fig. 5's heterogeneity), so benchmarks on this 1-core
container can reason about fleet sizing without wall-clock noise.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np

from repro_torch.core.resilience import CorruptSampleError


@dataclasses.dataclass
class Sample:
    sample_id: str
    source: str
    modality: str
    tokens: np.ndarray          # token ids (text part)
    image_tokens: int           # number of patch tokens (0 for text)
    virtual_cost: float         # normalized preprocessing cost units
    meta: dict

    @property
    def total_tokens(self) -> int:
        return int(len(self.tokens)) + int(self.image_tokens)


_MAX_TOKENS = 10_000_000


def validate_record(record: dict) -> None:
    """Integrity gate run before transforming a record.

    Raises CorruptSampleError on malformed records (bit-flipped counts,
    missing fields, chaos-injected ``_corrupt`` markers) so the loader can
    quarantine the sample in its dead-letter queue instead of crashing.
    """
    if record.get("_corrupt"):
        raise CorruptSampleError(
            f"corruption marker: {record.get('_corrupt')}")
    sid = record.get("sample_id")
    if not isinstance(sid, str) or not sid:
        raise CorruptSampleError(f"bad sample_id {sid!r}")
    for key in ("text_tokens", "image_tokens"):
        v = record.get(key)
        if not isinstance(v, (int, np.integer)) or isinstance(v, bool) \
                or v < 0 or v > _MAX_TOKENS:
            raise CorruptSampleError(f"bad {key}={v!r} in {sid}")
    cost = record.get("transform_cost")
    if not isinstance(cost, (int, float)) or not math.isfinite(cost) \
            or cost < 0:
        raise CorruptSampleError(f"bad transform_cost={cost!r} in {sid}")
    if "seed" not in record:
        raise CorruptSampleError(f"missing seed in {sid}")


def transform_record(record: dict, source: str, vocab_size: int = 50_000,
                     work_scale: float = 0.0) -> Sample:
    """Tokenize / decode one record.

    ``work_scale`` > 0 burns proportional real CPU (for wall-clock
    experiments); the default keeps transforms cheap and reports virtual
    cost only.
    """
    n_text = int(record["text_tokens"])
    n_img = int(record["image_tokens"])
    rng = np.random.default_rng(record["seed"])
    tokens = rng.integers(1, vocab_size, size=n_text, dtype=np.int32)
    cost = float(record["transform_cost"]) * (n_text + n_img)
    if work_scale > 0:  # simulate heavyweight decode (JPEG/keyframe)
        k = int(work_scale * cost)
        if k:
            np.square(np.arange(min(k, 200_000), dtype=np.float64)).sum()
    return Sample(
        sample_id=record["sample_id"], source=source,
        modality=record["modality"], tokens=tokens, image_tokens=n_img,
        virtual_cost=cost,
        meta={"text_tokens": n_text, "image_tokens": n_img},
    )


def record_metadata(record: dict, source: str) -> dict:
    """Lightweight metadata (what Source Loaders report to the Planner —
    DGraph nodes carry this, never payloads)."""
    return {
        "sample_id": record["sample_id"],
        "source": source,
        "modality": record["modality"],
        "text_tokens": int(record["text_tokens"]),
        "image_tokens": int(record["image_tokens"]),
        "transform_cost": float(record["transform_cost"]),
    }
