"""Loss curves of the Overlord-fed trainer on one NVIDIA card.

    python3 tools/loss_probe.py
    python3 tools/loss_probe.py --data-vocab 4096 --steps 19 \
        --lrs 0,1e-4,3e-4,1e-3 --no-launcher

qwen3-8b at full width with ``chip_smoke``'s depth cut (8 of 36 layers),
trained by ``train.trainer.Trainer`` from ``chip_smoke``'s trainer data
plane (four coyo-like sources, DP 4 x 1 row x 1024, 96 samples a step) for
``STEPS`` steps at each peak learning rate of ``LRS`` (warmup 2, as phase
8); the weights are drawn from the same seed each time.  Then the reduced
launcher (``launch.train.main``, its defaults) at 20 and at 100 steps,
unless ``--no-launcher``.  ``--data-vocab`` draws the plane's tokens from
fewer ids than the model's vocabulary (``chip_smoke.phase_loss``'s
setting); ``--steps`` and ``--lrs`` replace ``STEPS`` and ``LRS``.

For every step it prints the loss and how many of the step's documents an
earlier step of the same run already delivered (the loaders read their
sources round and round, and a document comes back with its id and its
tokens).  The tokens are uniform on [1, V), so ln(V - 1) is the least loss
a model can reach on documents it has not seen; the share of the gap to it
closed is ``train.trainer.gap_closed``'s.  Also prints the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import collections
import gc
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

STEPS = 24                      # past the sources' first pass at 96 a step
LRS = (1e-4, 3e-4, 1e-3)        # phase 8 runs 1e-3


def full_width(lr: float, steps: int, data_vocab: int | None = None):
    """``steps`` Trainer steps at peak ``lr``, tokens on [1, ``data_vocab``)
    (default the model's vocabulary): each step's loss, the number of its
    documents delivered before in this run, and the vocabulary the tokens
    come from."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config(cs.ARCH).replace(num_layers=cs.TRAIN_LAYERS)
    model = build_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    seen, repeats = collections.Counter(), []
    with tempfile.TemporaryDirectory(prefix="loss_probe_sources_") as root:
        ov = cs._trainer_plane(root, cfg, vocab=data_vocab)
        try:
            ov.start()
            trainer = Trainer(model, ov, TrainerConfig(
                log_every=steps, opt=AdamWConfig(
                    peak_lr=lr, warmup_steps=2, total_steps=1000)))
            get_batch = ov.get_batch

            def counting(step, rank, timeout=60.0):
                view = get_batch(step, rank, timeout)
                if view["role"] == "data":
                    ids = [s for b in view["bins"] for row in b.doc_ids
                           for s in row]
                    repeats.append(sum(seen[i] > 0 for i in ids))
                    seen.update(ids)
                return view
            ov.get_batch = counting
            hist = trainer.train(steps)
        finally:
            ov.shutdown()
    # one entry a rank: sum the ranks of each step
    ranks = len(repeats) // steps
    per_step = [sum(repeats[i * ranks:(i + 1) * ranks])
                for i in range(steps)]
    losses = [r["loss"] for r in hist]
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return losses, per_step, data_vocab or cfg.vocab_size


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data-vocab", type=int, default=None)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--lrs", default=",".join(map(str, LRS)))
    ap.add_argument("--no-launcher", action="store_true")
    args = ap.parse_args()
    cs.phase_device()
    cs.phase_build(("packed_attention", "packed_attention_bwd"))
    from repro_torch.train.trainer import gap_closed
    for lr in map(float, args.lrs.split(",")):
        losses, repeats, vocab = full_width(lr, args.steps, args.data_vocab)
        first, last, share = gap_closed(losses, vocab)
        print(f"full width, {cs.TRAIN_LAYERS} layers, tokens on [1, {vocab}),"
              f" peak lr {lr}: losses "
              f"{[round(x, 4) for x in losses]}; documents seen before "
              f"{repeats}; mean of the first 5 {first:.4f}, of the last 5 "
              f"{last:.4f}, ln(V - 1) {np.log(vocab - 1):.4f}: {share:.4f} "
              "of the gap closed", flush=True)
    if args.no_launcher:
        return
    from repro_torch.configs.qwen3_8b import reduced
    from repro_torch.launch import train
    for steps in (20, 100):
        losses = [r["loss"] for r in train.main(
            ["--reduced", "--steps", str(steps)])["history"]]
        first, last, share = gap_closed(losses, reduced().vocab_size)
        print(f"reduced launcher, {steps} steps: losses "
              f"{[round(x, 4) for x in losses]}; mean of the first 5 "
              f"{first:.4f}, of the last 5 {last:.4f}: {share:.4f} of the "
              "gap closed", flush=True)


if __name__ == "__main__":
    main()
