"""Synthetic multisource datasets with the paper's skew characteristics.

Fig. 2: token distributions in coyo700m / navit_data are heavily skewed
(98.23% of coyo text <= 64 tokens while the top 1.62% holds 9.3% of
tokens).  We generate sources whose text/image token counts follow
log-normal mixtures calibrated to that shape, and whose per-sample
transformation costs reproduce Fig. 5's heterogeneity (audio ~300x text,
image ~50x, variable-resolution spread within a modality).
"""
from __future__ import annotations

import dataclasses
import math
import os
import numpy as np

from repro_torch.data import storage

MODALITY_COST = {  # relative per-output-token transform cost (§1, §2.3)
    "text": 1.0,
    "image": 50.0,
    "video": 120.0,
    "audio": 300.0,
}


@dataclasses.dataclass(frozen=True)
class SourceSpec:
    name: str
    modality: str            # text | image | video | audio
    n_samples: int = 2048
    text_mu: float = 3.2     # log-normal params for text token counts
    text_sigma: float = 1.1
    image_mu: float = 5.5    # log-normal params for image patch counts
    image_sigma: float = 0.9
    seed: int = 0

    @property
    def transform_cost(self) -> float:
        return MODALITY_COST[self.modality]


def coyo_like_specs(n_sources: int = 5, seed: int = 0) -> list[SourceSpec]:
    """Small source group, image-text pairs (coyo700m: 5 sources)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_sources):
        out.append(SourceSpec(
            name=f"coyo_{i:03d}", modality="image",
            text_mu=3.0 + rng.uniform(-0.3, 0.3),
            text_sigma=1.2, image_mu=5.2 + rng.uniform(-0.5, 0.8),
            image_sigma=0.8 + rng.uniform(0, 0.4), seed=seed + i))
    return out


def navit_like_specs(n_sources: int = 306, seed: int = 1) -> list[SourceSpec]:
    """Large heterogeneous production-like group (navit_data: 306 srcs)."""
    rng = np.random.default_rng(seed)
    mods = ["text"] * (n_sources // 2) + ["image"] * (n_sources // 3)
    mods += ["video"] * (n_sources // 9)
    mods += ["audio"] * (n_sources - len(mods))
    out = []
    for i, m in enumerate(mods):
        out.append(SourceSpec(
            name=f"navit_{i:03d}", modality=m,
            text_mu=2.8 + rng.uniform(0, 1.5),
            text_sigma=0.9 + rng.uniform(0, 0.6),
            image_mu=4.5 + rng.uniform(0, 1.8),
            image_sigma=0.7 + rng.uniform(0, 0.6), seed=seed * 1000 + i))
    return out


def sample_lengths(spec: SourceSpec, n: int, rng) -> tuple:
    """Draw (text_tokens, image_tokens) with Fig.-2-style skew."""
    text = np.clip(rng.lognormal(spec.text_mu, spec.text_sigma, n),
                   1, 8192).astype(np.int64)
    if spec.modality == "text":
        image = np.zeros(n, np.int64)
    else:
        image = np.clip(rng.lognormal(spec.image_mu, spec.image_sigma, n),
                        16, 16384).astype(np.int64)
    return text, image


def materialize_source(spec: SourceSpec, root: str,
                       row_group_rows: int = 256) -> str:
    """Write the source to disk; payload bytes simulate raw content."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"{spec.name}.colstore")
    if os.path.exists(path):
        return path
    rng = np.random.default_rng(spec.seed)
    text, image = sample_lengths(spec, spec.n_samples, rng)
    records = []
    for i in range(spec.n_samples):
        payload_len = int(text[i]) * 4 + int(image[i]) * 12
        records.append({
            "sample_id": f"{spec.name}/{i}",
            "text_tokens": int(text[i]),
            "image_tokens": int(image[i]),
            "modality": spec.modality,
            "transform_cost": spec.transform_cost
            * (1.0 + float(rng.uniform(0, 0.5))),
            # payload stands in for the raw bytes (decoded at transform time)
            "payload": bytes(payload_len % 251 for _ in range(
                min(payload_len, 512))),
            "seed": int(rng.integers(0, 2**31 - 1)),
        })
    storage.write_source(path, records, row_group_rows)
    return path


def materialize_group(specs: list[SourceSpec], root: str) -> dict[str, str]:
    return {s.name: materialize_source(s, root) for s in specs}
