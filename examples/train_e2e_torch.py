"""End-to-end example of the PyTorch port: train a small LM for a few hundred
steps with the port's copy of the OVERLORD data plane feeding balanced
packed batches.

    PYTHONPATH=src python examples/train_e2e_torch.py --steps 200   # card
    PYTHONPATH=src python examples/train_e2e_torch.py --device cpu

The port of ``examples/train_e2e.py``: the same model (qwen3-8b's block at
width 128, 4 layers, 4/2 heads, vocab 4096), the same Overlord (four
coyo-like sources, DP 2 x 2 rows, ``backbone_balance``) and the same
optimiser, plus ``--device`` (default ``cuda``; without a card that raises
unless ``--device cpu`` is given) and ``--lr`` (default the example's
3e-3).  On the card attention runs through the CUDA kernels, forward and
backward.

It checks what the JAX example checks, that the mean of the last 10 losses
is below that of the first 10, and one thing more: the data plane's tokens
are uniform on [1, V), so ln(V - 1) is the least loss a model can reach on
documents it has not seen, and the last 10 must close ``GAP_SHARE`` of the
gap from the first 10's mean to it.  A bare ``last < first`` can pass an
update that does nothing, on the spread of the losses alone.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs.qwen3_8b import CONFIG
from repro_torch.core import (
    ClientPlaceTree, Overlord, OverlordConfig, StaticSchedule,
)
from repro_torch.data.cost_models import backbone_cost
from repro_torch.data.sources import coyo_like_specs, materialize_group
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import build_model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig, gap_closed

# the share of the gap to ln(V - 1) the last 10 losses must close; --lr 0
# closes none of it, give or take the spread of the batches' losses
GAP_SHARE = 0.3


def main(argv=None) -> dict:
    """Train once and check the loss.  Returns the per-step records
    (``history``), the first and last means and the share closed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = CONFIG.replace(
        name="qwen3-e2e", num_layers=args.layers, d_model=args.width,
        num_heads=4, num_kv_heads=2, head_dim=max(args.width // 4, 16),
        d_ff=args.width * 3, vocab_size=4096)
    model = build_model(cfg, torch.Generator(device=device).manual_seed(0))
    print(f"model params: {sum(p.numel() for p in model.parameters()):,}")

    specs = coyo_like_specs(4)
    with tempfile.TemporaryDirectory(prefix="overlord_e2e_") as root:
        ov = Overlord(materialize_group(specs, root),
                      ClientPlaceTree([("PP", 1), ("DP", 2), ("CP", 1),
                                       ("TP", 1)]),
                      StaticSchedule({s.name: 1.0 for s in specs}),
                      OverlordConfig(
                          seq_len=args.seq_len, rows_per_microbatch=2,
                          n_bins=1, strategy="backbone_balance",
                          strategy_params=dict(costfn=backbone_cost(cfg),
                                               broadcast=()),
                          vocab_size=cfg.vocab_size))
        try:
            ov.start()
            trainer = Trainer(model, ov, TrainerConfig(
                steps=args.steps, log_every=20,
                opt=AdamWConfig(peak_lr=args.lr, warmup_steps=20,
                                total_steps=args.steps)))
            hist = trainer.train()
        finally:
            ov.shutdown()
    losses = [h["loss"] for h in hist]
    first, last, share = gap_closed(losses, cfg.vocab_size, n=10)
    print(f"mean loss first10={first:.4f} last10={last:.4f} "
          f"ln(V - 1)={np.log(cfg.vocab_size - 1):.4f}: {share:.4f} of the "
          f"gap closed (at least {GAP_SHARE})")
    if not np.isfinite(losses).all() or not last < first:
        raise AssertionError("loss did not improve")
    if not share >= GAP_SHARE:
        raise AssertionError(f"{share:.4f} of the gap to ln(V - 1) closed, "
                             f"under {GAP_SHARE}")
    print("OK: loss improved with OVERLORD-fed batches")
    return {"history": hist, "first": first, "last": last, "share": share,
            "trainer": trainer}


if __name__ == "__main__":
    main()
