"""End-to-end training launcher: OVERLORD data plane + train step.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch pixtral-12b \
        --reduced --device cpu --steps 3 --strategy hybrid_balance
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen3-moe-30b-a3b --reduced --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \
        --reduced --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \
        --reduced --device cpu --steps 3

The port of ``repro.launch.train``: the same CLI and defaults plus
``--device`` (default ``cuda``; without a card that raises unless
``--device cpu`` is given).  Everything runs in one process: the data
plane's actors are threads beside the loop.  The Overlord runs its
launch-time static analysis (``repro_torch.analysis``) before any thread
starts, as the JAX launcher's does, so a configuration it refuses raises
``AnalysisError``: ``--strategy vanilla`` is one, in both packages, since
the launcher passes ``broadcast``, which ``vanilla`` does not accept
(CFG304).  A vlm arch trains as a dense one, as in the JAX
package, whose trainer passes no image embeddings; a moe arch trains with
its aux loss in the total, as in the JAX package; an ssm arch (RWKV6)
trains through the wkv6 forward and backward kernels on the card; a
hybrid arch (zamba2-7b) trains its shared attention block through the
attention kernels, balanced by the data plane's hybrid cost (attention on
``num_layers // attn_every`` layers); ``hybrid_balance`` balances with the
JAX launcher's encoder cost, ViT-2B's (``configs.paper_vlm.VIT_2B``).  The
audio family (whisper-medium) is refused: the Overlord's batches carry no
``enc_embeds``, and the JAX package trains it on a fixed batch only.
"""
from __future__ import annotations

import argparse
import importlib
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core import (
    ClientPlaceTree, CurriculumSchedule, Overlord, OverlordConfig,
    StaticSchedule,
)
from repro_torch.data.cost_models import backbone_cost, encoder_cost
from repro_torch.data.sources import coyo_like_specs, materialize_group
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import build_model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> dict:
    """Train once.  Returns the per-step records (``history``) and the
    ``trainer``, whose Overlord is shut down by then."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--strategy", default="backbone_balance",
                    choices=["vanilla", "backbone_balance",
                             "hybrid_balance"])
    ap.add_argument("--dp", type=int, default=4)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--rows", type=int, default=2)
    ap.add_argument("--n-bins", type=int, default=1)
    ap.add_argument("--sources", type=int, default=4)
    ap.add_argument("--curriculum", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = importlib.import_module(
            "repro_torch.configs." + args.arch.replace("-", "_")).reduced()
    if cfg.family == "audio":
        raise ValueError(
            f"{cfg.name}: the Overlord's batches carry no enc_embeds, so the "
            "audio family trains on a fixed batch only "
            "(train_step.make_train_step), as in the JAX package; see "
            "ROADMAP.md")
    model = build_model(cfg, torch.Generator(device=device).manual_seed(0))
    print(f"arch={cfg.name} params="
          f"{sum(p.numel() for p in model.parameters()):,}")

    specs = coyo_like_specs(args.sources)
    names = [s.name for s in specs]
    if args.curriculum:
        sched = CurriculumSchedule(
            easy={names[0]: 1.0},
            hard={n: 1.0 for n in names[1:]},
            ramp_steps=max(args.steps // 2, 1))
    else:
        sched = StaticSchedule({n: 1.0 for n in names})

    sparams = {"broadcast": ("TP",) if args.tp > 1 else ()}
    if args.strategy == "hybrid_balance":
        sparams.update(backbone_costfn=backbone_cost(cfg),
                       encoder_costfn=encoder_cost(48, 1664))
    else:
        sparams.update(costfn=backbone_cost(cfg))
    tree = ClientPlaceTree([("PP", 1), ("DP", args.dp), ("CP", 1),
                            ("TP", args.tp)])
    with tempfile.TemporaryDirectory(prefix="overlord_train_") as root:
        ov = Overlord(materialize_group(specs, root), tree, sched,
                      OverlordConfig(
                          seq_len=args.seq_len, rows_per_microbatch=args.rows,
                          n_bins=args.n_bins, strategy=args.strategy,
                          strategy_params=sparams, vocab_size=cfg.vocab_size,
                      ))
        try:
            ov.start()
            trainer = Trainer(model, ov, TrainerConfig(
                steps=args.steps, ckpt_dir=args.ckpt_dir,
                opt=AdamWConfig(peak_lr=args.lr, warmup_steps=10,
                                total_steps=max(args.steps, 20))))
            hist = trainer.train()
            print(f"final loss {hist[-1]['loss']:.4f} "
                  f"(first {hist[0]['loss']:.4f})")
            print("memory:", {k: f"{v / 1e6:.1f}MB"
                              for k, v in ov.memory_report().items()})
        finally:
            ov.shutdown()
    return {"history": hist, "trainer": trainer}


if __name__ == "__main__":
    main()
