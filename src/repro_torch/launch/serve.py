"""Serving launcher: batched prefill + decode with the cache step.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --batch 4 --prompt-len 32 --gen 16            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --reduced --device cpu --batch 2 --prompt-len 16 --gen 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b \
        --reduced --device cpu --batch 2 --prompt-len 16 --gen 4
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-3b-a800m --reduced --device cpu --batch 2 \
        --prompt-len 16 --gen 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --reduced --device cpu --batch 2 --prompt-len 16 --gen 4
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-medium --reduced --device cpu --batch 2 \
        --prompt-len 16 --gen 4

The port of ``repro.launch.serve``: the same CLI plus ``--device`` (default
``cuda``; without a card that raises unless ``--device cpu`` is given), and
the same flow for every ported arch: prefill the prompt, then refill a
fresh float32 cache (the KV cache of a dense model, the shift and WKV
states of RWKV6, the Mamba2 states and the shared block's KV of the
hybrid, the self and cross KV of Whisper) by replaying the prompt through
``decode_step``, then decode greedily.  A vlm arch's prompt also carries
``image_token_frac`` of its positions as image embeddings (the first ones
of each row), and an audio arch's batch ``encoder_frames`` float32 frame
embeddings, drawn after the tokens from the same numpy generator, as the
JAX launcher draws them; prefill reads them, and the replay, as in the JAX
launcher, feeds the tokens alone.  So a served Whisper decodes against a
cross cache of zeros, never the audio: the JAX launcher's behaviour
(ROADMAP.md, C5), kept so that the greedy tokens equal JAX's.  On the card
attention and the WKV always run through the CUDA kernels.  The weights
are drawn from seed 0 straight into the dtypes the steps compute in
(``models.params.init_param``): the cast of the float32 tree the same seed
draws, bit for bit, without that tree ever existing.
"""
from __future__ import annotations

import argparse
import importlib
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import build_model
from repro_torch.train import train_step
from repro_torch.train.train_step import make_decode_step, make_prefill_step


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Parse the CLI and serve once (``run``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = importlib.import_module(
            "repro_torch.configs." + args.arch.replace("-", "_")).reduced()
    return run(cfg, args.batch, args.prompt_len, args.gen, device)


def run(cfg, b: int, s: int, gen: int, device: torch.device) -> dict:
    """Serve ``cfg`` once: ``b`` prompts of ``s`` tokens, ``gen`` greedy
    tokens each.  Returns the greedy tokens ``(b, gen)``, the last prefill
    and decode logits, the host-clock timings, and the bf16 model, its
    prefill and decode steps, the prompt batch and the filled cache, so a
    caller can rerun the prefill or go on stepping at the run's own cache
    length."""
    generator = torch.Generator(device=device).manual_seed(0)
    # drawn straight into the dtypes the steps compute in, a layer of a
    # stacked leaf at a time: no float32 copy of the tree is ever made, so
    # every config serves whole on one 80 GB card
    model = build_model(cfg, generator, train_step.COMPUTE_DTYPE)

    max_len = s + gen
    rng = np.random.default_rng(0)
    batch = {
        "tokens": rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32),
        "segment_ids": np.ones((b, s), np.int32),
        "positions": np.broadcast_to(np.arange(s, dtype=np.int32),
                                     (b, s)).copy(),
    }
    if cfg.family == "vlm":
        n = int(s * cfg.image_token_frac)
        batch["image_embeds"] = rng.normal(
            size=(b, n, cfg.d_model)).astype(np.float32) * 0.02
        batch["image_positions"] = np.broadcast_to(
            np.arange(n, dtype=np.int32), (b, n)).copy()
    if cfg.family == "audio":
        batch["enc_embeds"] = rng.normal(
            size=(b, cfg.encoder_frames, cfg.d_model)).astype(
            np.float32) * 0.02
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    # both steps share the bf16 weights (a float32 tree handed in by a
    # caller is cast here, leaf by leaf)
    prefill = make_prefill_step(model)
    decode = make_decode_step(model)

    _sync(device)
    t0 = time.perf_counter()
    prefill_logits, _pref_cache = prefill(batch)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    del _pref_cache
    print(f"prefill {b}x{s}: {prefill_s:.3f}s "
          f"logits={tuple(prefill_logits.shape)}")

    # decode loop against a full-size cache: write the prompt by replaying
    # it through decode_step (exercises the serving path end to end)
    cache = model.init_cache(b, max_len, torch.float32)
    toks = batch["tokens"]
    for t in range(s):
        logits, cache = decode(cache, toks[:, t:t + 1], t)
    out = []
    _sync(device)
    t0 = time.perf_counter()
    cur = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    for t in range(s, max_len):
        out.append(cur[:, 0].cpu().numpy())
        logits, cache = decode(cache, cur, t)
        cur = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    _sync(device)
    dt = time.perf_counter() - t0
    tokens = np.stack(out, 1)
    print(f"decoded {gen} tokens x {b} seqs in {dt:.3f}s "
          f"({gen * b / dt:.1f} tok/s)")
    print("greedy continuations:", tokens[:, :8].tolist())
    return {"tokens": tokens, "prefill_logits": prefill_logits,
            "logits": logits, "prefill_s": prefill_s, "decode_s": dt,
            "decode_tok_s": gen * b / dt, "model": model,
            "prefill": prefill, "decode": decode, "batch": batch,
            "cache": cache}


if __name__ == "__main__":
    main()
