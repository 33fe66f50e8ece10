"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --only wkv6
    python3 chip_smoke.py --only train
    python3 chip_smoke.py --only bwd
    python3 chip_smoke.py --only trainer
    python3 chip_smoke.py --only vlm
    python3 chip_smoke.py --only moe
    python3 chip_smoke.py --only rwkvtrain
    python3 chip_smoke.py --only dense
    python3 chip_smoke.py --only hybrid
    python3 chip_smoke.py --only audio
    python3 chip_smoke.py --only remat
    python3 chip_smoke.py --only dryrun
    python3 chip_smoke.py --only shard
    python3 chip_smoke.py --only seqdecode

Phases (any failure raises, and the exit code is not 0):
  1. device  — the card's name, count and power limit; no card, no run.
  2. build   — nvcc builds the five CUDA kernels of ``src/repro_torch/
               kernels/csrc`` (in parallel) into ``build/repro_torch_kernels``.
  3. check   — each kernel against its plain PyTorch version on the card,
               TF32 off: packed_attention and flash_decode at qwen3-8b head
               shapes and more (ragged tiles, segments changing mid-tile,
               skipped tiles between live ones, every head chunking of
               decode, cache lengths at tile and split edges, a CUDA-graph
               replay of decode), wkv6 at rwkv6-3b head shapes (packed
               resets, a ragged length, the final state, resets on
               sub-chunk edges, the state entering every chunk against
               ``ref.wkv6_two_pass``, steep decays against the float64
               oracle, a single chunk whose final state is read next and
               in CUDA-graph replays) and more; then
               reduced qwen3-8b and reduced rwkv6-3b prefill + decode on
               the card against the CPU.  The training checks: the
               forward's log-sum-exp and the backward kernel
               (packed_attention_bwd, bf16, d 16/64/128; MHA, GQA, MQA,
               causal and sq != sk, ragged tails, short segments, padding
               tiles and rows, an expanded dO) against
               ``packed_attention_bwd_ref`` and autograd of
               ``packed_attention_ref``, two calls bitwise equal, and the
               live tiles each CTA reports against
               ``ref.packed_attention_live_tiles``; at paper-llama-12b's
               heads (36 on 36 of 128) the forward, the backward and
               flash_decode, and the backward at GQA group 8 with d 128
               against the float32 autograd oracle; reduced
               paper-llama-12b with image embeddings, prefill and decode,
               on the card against the CPU; the kernels with no backward
               raising under grad;
               qwen3-8b at full width with 2 layers, loss and every
               gradient, kernels against plain attention; reduced qwen3-8b
               memorising one batch through the kernels.  The MoE checks:
               the three attention kernels at granite-moe-3b-a800m's heads
               (24 on 8 of 64, GQA group 3) and flash_decode at
               qwen3-moe-30b-a3b's (32 on 4 of 128); qwen3-moe-30b-a3b's
               MoE block at full width (4 x 1024 bf16) bitwise equal over
               two calls, out, aux and every gradient; 2 full-width
               qwen3-moe-30b-a3b layers, kernels against plain attention
               with the plain run routed as the kernel run; reduced
               qwen3-moe-30b-a3b on the card against the CPU, and
               memorising one batch.  The RWKV6 training checks: the wkv6
               backward kernel (wkv6_bwd) against ``ref.wkv6_bwd_ref`` at
               rwkv6-3b's training shape, a ragged length, dk 16 and 32,
               resets mid-chunk and padding rows, two calls bitwise equal,
               and against the float64 oracle (autograd of ``wkv6_ref``)
               at steep decays; ``ops.wkv6`` under grad through both
               kernels; reduced rwkv6-3b's first training step on the card
               against the CPU's, and memorising one batch.  The dense
               family's checks: the attention kernels at qwen3-32b's heads
               (64 on 8 of 80), granite-20b's (48 on 1 of 128: the
               backward held to the version that rounds where it rounds,
               and to SDPA's distance from the float32 oracle) and
               yi-9b's, the backward's time at granite-20b's heads, and
               the three reduced configs on the card against the CPU.  The
               hybrid's checks: the three attention kernels at zamba2-7b's
               heads (32 on 32 of 112) with packed segments, ragged tails,
               short segments and its serve and training shapes; reduced
               zamba2-7b on the card against the CPU (forward, prefill
               logits and Mamba2 states, greedy tokens); 2 full-width
               layers (attn_every 1) against plain attention; memorising.
               The audio family's: the attention kernels at whisper-medium's
               shapes (the encoder's non-causal 1500 x 1500, the decoder's
               cross-attention of 512 and 1024 queries on 1500 keys,
               forward in both dtypes and backward; flash_decode on a
               1500-frame cross cache); reduced whisper-medium on the card
               against the CPU, decode against the prefill's cross cache
               included; memorising.  The remat checks: the grad guards,
               and each training family's reduced config (qwen3-8b,
               qwen3-moe-30b-a3b, pixtral-12b, rwkv6-3b, zamba2-7b with a
               tail, whisper-medium) under the remat policies "layer" and
               "dots_saveable" against "none": the first step's loss and
               every gradient, and the launches (the forward kernels once
               more in the recompute).
  3b. dryrun — the dry-run's byte count against the card's allocator: on a
               world-of-one local mesh (``launch.mesh.make_local_mesh``,
               nccl), qwen3-8b at full width with 8 of its 36 layers (the
               trainer's cut): the bytes ``launch.dryrun`` predicts on meta
               tensors for its float32 params, its whole train state and an
               ``init_cache(8, 4096)`` against the growth of
               ``torch.cuda.memory_allocated()`` across ``build_model``,
               ``init_train_state`` and ``init_cache`` (within 512 B a
               leaf, the allocator's rounding); every parameter distributed
               as a DTensor with the sharding rules' placements, its local
               shard bitwise equal to it; then ``python -m
               repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
               --mesh single`` as a subprocess (bytes, the meta pass and
               the sharded pass's collectives); the group destroyed.
  3c. shard  — the sharded step on the same world-of-one nccl mesh: a
               bf16-compute training step (the loss and every gradient of
               one forward and backward, then one AdamW step) of qwen3-8b
               at full width with 2 of 36 layers, then of
               qwen3-moe-30b-a3b with 1 of 48 (its dispatch and combine
               through ``local_map``), on DTensors placed by
               ``TRAIN_RULES`` against the same on plain tensors; then
               qwen3-8b's prefill of 4 x 512 and 4 decode steps under
               ``DECODE_RULES``.  Each under ``CommDebugMode``
               (``launch.collectives.count``): no collective, the launch
               counts equal to the plain run's, every number bitwise equal
               (or within the training checks' tolerances, logged).
  3d. seqdecode — the KV-sequence-parallel decode's parts on the card (its
               all-reduces run on 4 gloo CPU ranks in the tests and on meta
               shards in the dry-run: this machine has one card).
               flash_decode's partial result (the float32 output and its
               log-sum-exp) against ``ref.flash_decode_ref(...,
               return_lse=True)`` at qwen3-8b's serve decode (b 4, 32 heads
               on 8 of 128, a float32 cache of PROMPT + GEN) and at the
               per-device block of its decode_32k cell on the 16 x 16 mesh
               (b 8, 2048 positions, bf16), on the whole cache and on each
               of 4 pieces along the sequence (local lengths 0 and inside
               a tile among them), the output without lse bitwise the lse
               output cast, and the pieces merged by
               ``ops.merge_partials`` against the whole; then qwen3-8b at
               full width (the serve run's model): the float32 cache that
               a real BATCH x PROMPT prefill fills, 4 greedy decode steps,
               and at every layer of each the 4 pieces' partials merged
               against the kernel on the whole cache, in float32 before
               the cast; then the device times of flash_decode with and
               without lse at both shapes, and the block's byte bound.
               Runs after the qwen3-8b serve run's traces.
  4. serve   — ``repro_torch.launch.serve`` on qwen3-8b (36 layers, d_model
               4096), on rwkv6-3b (32 layers, d_model 2560) and on the
               paper's VLM backbone paper-llama-12b (45 layers, d_model
               4608, 36 heads; a quarter of each prompt's positions under
               image embeddings, whose effect on the prefill is checked),
               each at its published width and depth with random weights
               from a seed: batch 4, 32 greedy tokens, a prompt of 512
               tokens for qwen3-8b and rwkv6-3b and of 128 for every other
               run (``CUT_PROMPT``: the serve flow replays the prompt one
               host-bound decode step a token); then the
               MoE family at the same batch: granite-moe-3b-a800m (32
               layers, 40 experts padded to 48, top 8, tied embeddings) and
               qwen3-moe-30b-a3b (48 layers, 128 experts, top 8); then the
               rest of the dense family: yi-9b, granite-20b (52 layers) and
               qwen3-32b (64); then zamba2-7b (81 Mamba2 layers and 13
               applications of one shared attention block) and
               whisper-medium (float32 frame embeddings of 1500 frames; then
               4 decode steps against the prefill's real cross cache, which
               the serve flow never reads, ROADMAP C5), each at full width
               and depth.  ``serve.run`` draws the weights straight into
               bf16, a layer of a stacked leaf at a time, so no float32
               tree is made: each run prints its peak beside its served
               weights' bytes, and fails if the model holds other bytes.
               Every
               kernel's launch count is set to 0 just before each run and
               read just after; the counts must show the path went through
               the kernels.
  5. trace   — torch.profiler over one prefill and over decode steps of
               each serve run's own model and cache: the device's busy
               share, the share of the hand-written kernels, and the
               kernels that take its time.
  6. train   — qwen3-8b at full width with 8 of its 36 layers, AdamW on
               float32 master weights: 5 steps through ``train_step`` on
               one packed batch of 4 x 1024 (counts set to 0 before, read
               after: 16 forward and 8 backward launches a step, since
               every training phase runs the reference's remat policy
               "layer", which runs each layer's forward again in the
               backward), losses,
               step time, tokens/s and peak memory; one step by its parts
               (forward, backward, update) and one under the profiler.
  8. trainer — the same model (freed and drawn again) trained by
               ``repro_torch.train.trainer.Trainer`` from a live Overlord
               (the port's copy of the data plane: four coyo-like sources,
               DP 4 x 1 row x 1024, 96 samples a step, a strict delivery
               ledger; the launch-time static analysis, whose report is
               logged): 8 steps with the counts set to 0 before and read
               after (16 forward and 8 backward launches a step), finite
               losses, every batch holding tokens, the ledger verified;
               each batch's fill, documents and per-row sum of squared
               document lengths; one step under the profiler with its
               batch fetch, one without, and one with the data plane shut
               down.  Then
               ``repro_torch.launch.train`` at the reduced size on the card
               (100 steps: the loss must close a share of its gap to
               ln(V - 1), the floor on the data plane's uniform tokens)
               and a bitwise checkpoint round trip of its trainer.
  9. vlm-trainer — paper-llama-12b at full width with 6 of its 45 layers
               trained by the same ``Trainer`` from a live Overlord under
               ``hybrid_balance`` (the paper's VLM strategy) for 8 steps,
               then 4 steps under ``backbone_balance``: counts, losses,
               step and fetch times, peak memory, per-row sum of squared
               document lengths, a profiled step, the strict ledger.
 12. moe-trainer — the paper's tMoE-25B backbone (16 experts, top 2) at
               full width with 3 of its 42 layers (a cut for memory) trained
               by the same ``Trainer`` from phase 8's plane for 8 steps:
               counts, losses and aux losses, step and fetch times, peak
               memory, a profiled step, the strict ledger.
 13. rwkv-trainer — rwkv6-3b at full width and depth (32 layers) trained
               by the same ``Trainer`` from phase 8's plane for 8 steps
               through the wkv6 forward kernel (twice a layer a step: the
               forward and the recompute) and the backward kernel (once):
               counts, losses, step and fetch times, peak memory, a
               profiled step, the strict ledger.
 14. dense-trainer — qwen3-32b at full width with 4 of its 64 layers
               trained the same way: the attention backward at d 80.
 15. hybrid-trainer — zamba2-7b at full width with 39 of its 81 layers
               (six blocks of 6 and the 3-layer tail; a cut for memory)
               trained the same way: the attention forward kernel at d 112
               twice a block a step, the backward once, the Mamba2 scan in
               eager float32, each block recomputed in the backward.
 16. whisper-train — whisper-medium at full width and depth, 5 steps on a
               fixed batch (4 x 1024 decoder tokens, bf16 frame embeddings
               of 1500 frames): 144 forward and 72 backward attention
               launches a step, the encoder's and the cross-attention's
               non-causal.
 10. loss    — phase 8's model trained for 19 steps from phase 8's plane
               drawing its tokens from 4,096 ids (the model keeps its
               151,936): the loss must close a share of its gap to
               ln(4095).
 11. example — ``examples/train_e2e_torch.py`` with its defaults (200
               steps), which checks its own loss.
  7. time    — each kernel at the serving shapes (CUDA events around a
               CUDA-graph replay, and around eager calls), beside its plain
               version, one PyTorch library call where there is one, and
               its bound; the backward kernel at the training shape; the
               wkv6 backward on phase 13's first batch.  Runs last, so
               every record has its count on every path.
The line before the last is a JSON ``kernels`` record: each kernel's
``launches`` is its count on the path the record is timed on
(``launches_path``: packed_attention and flash_decode on the qwen3-8b
serve run, wkv6 on the rwkv6-3b one, packed_attention_bwd on the training
run, 5 steps, wkv6_bwd on phase 13), and ``launches_by_path`` its count on
every path
(``trainer:qwen3-8b`` is phase 8, ``trainer:paper-llama-12b`` and
``trainer:paper-llama-12b:backbone_balance`` phase 9,
``trainer:paper-tmoe-25b`` phase 12, ``serve:granite-moe-3b-a800m`` and
``serve:qwen3-moe-30b-a3b`` the MoE serve runs,
``serve:yi-9b``, ``serve:granite-20b`` and ``serve:qwen3-32b`` the dense
ones,
``trainer:rwkv6-3b`` phase 13,
``trainer:qwen3-32b:4-of-64-layers`` phase 14,
``serve:zamba2-7b`` and ``serve:whisper-medium`` the last two families'
serve runs, ``trainer:zamba2-7b:39-of-81-layers`` phase 15,
``train:whisper-medium`` phase 16,
``loss:qwen3-8b:data-vocab-4096`` phase 10,
``example:train_e2e_torch`` phase 11), each read from its own zeroed run;
the last line is ``{"ok": true, "device": {...}}``.

``--only wkv6`` is the short loop for the wkv6 kernel: phase 1, the wkv6
build, its phase-3 checks (``_check_wkv6``, ``_check_reduced_rwkv``) and
its timing, with no serve run (so its record's ``launches`` is null).
``--only train`` is the short loop for training: phase 1, the builds of
packed_attention and packed_attention_bwd, the training checks, phase 6
and the backward kernel's record.
``--only trainer`` is the short loop for the Overlord-fed trainer: phase
1, the builds of packed_attention and packed_attention_bwd, phase 8, and
the backward's record at the shape of the trainer's first batch
(``launches_path`` ``trainer:qwen3-8b``).
``--only vlm`` is the short loop for the paper's VLM backbone: phase 1,
the builds of the three attention kernels, their checks at
paper-llama-12b's heads and the group-8 backward, the reduced vlm, the
paper-llama-12b serve run and its traces, phase 9, and the three kernels'
records at paper-llama-12b's shapes (``launches_path`` its serve run, or
phase 9 for the backward).
``--only moe`` is the short loop for the MoE family: phase 1, the builds
of the three attention kernels, their checks at the MoE heads, the MoE
checks, the two MoE serve runs and their traces, phase 12, and the
three kernels' records at the MoE shapes (the forward and the backward
on phase 12's first batch, ``flash_decode`` at granite-moe-3b-a800m's
heads).
``--only rwkvtrain`` is the short loop for RWKV6 training: phase 1, the
builds of wkv6 and wkv6_bwd, the RWKV6 training checks, phase 13, and the
two wkv6 kernels' records on phase 13's first batch.
``--only dense`` is the short loop for the rest of the dense family: phase
1, the builds of the three attention kernels, the dense family's checks,
its three serve runs and their traces, phase 14, and the three attention
records at qwen3-32b's shapes (the forward and the backward on phase 14's
first batch) and ``flash_decode`` at granite-20b's heads.
``--only hybrid`` is the short loop for the hybrid family: phase 1, the
builds of the five kernels, the hybrid's checks, the zamba2-7b serve run
and its traces, phase 15, and the five records: the forward and the
backward on phase 15's first batch, ``flash_decode`` at zamba2-7b's heads,
and the two wkv6 kernels at their own shapes (``launches`` null: no path
here runs them).
``--only audio`` is the short loop for the audio family: phase 1, the
builds of the five kernels, the audio family's checks, the whisper-medium
serve run, its decode against the real cross cache and its traces, phase
16, and the five records: the forward at the served encoder's shape
(float32, 1500 on 1500, non-causal), ``flash_decode`` on the 1500-frame
cross cache, the backward at the training cross-attention's (1024 on
1500), and the two wkv6 kernels as in ``--only hybrid``.
``--only remat`` is the short loop for the remat policy: phase 1, the
builds of the four training kernels, the remat checks, then in one call
zamba2-7b with 15 of its 81 layers under each policy and rwkv6-3b with 24
of its 32 under "none" and "layer" (peak memory, step time and a profiled
step's busy share each), rwkv6-3b whole under "layer", and the deepest
zamba2-7b of 51, 45 and 39 layers that trains under "layer"; and four
records: the attention forward and backward on that zamba2-7b's first
batch, the two wkv6 kernels on rwkv6-3b's.
``--only dryrun`` is the short loop for the dry-run: phase 1 and phase 3b;
it builds and launches no kernel, so its ``kernels`` line is empty.
``--only shard`` is the short loop for the sharded step: phase 1, the
builds of the three attention kernels and phase 3c; it times nothing, so
its ``kernels`` line is empty.
``--only seqdecode`` is the short loop for the KV-sequence-parallel
decode: phase 1, the builds of packed_attention and flash_decode (the
qwen3-8b prefill and decode), qwen3-8b drawn at full width and depth as
the serve run draws it, and phase 3d; its ``kernels`` line is empty.
``tools/time_in_turns.py decode`` times flash_decode in turns against
another version of its source.
``--only bwd`` is the short loop for the backward kernel: phase 1, the
builds of packed_attention and packed_attention_bwd, the backward checks,
and the backward's record at the training shape with the live tile pairs
the kernel reports (``launches`` null: no training run).
``tools/time_in_turns.py bwd`` times it in turns against another version
of its source.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py
# flash_decode at the serve shape, bf16 q and a float32 cache: the kernel
# and the plain version both sum in float32 and round once to bf16, so they
# differ by at most one bf16 rounding (2**-8 relative), which 2e-3 covers
# for outputs below 1 in magnitude.
SERVE_DECODE_TOL = 2e-3
WKV_TOL = (5e-5, 5e-4)             # atol, rtol: tests/test_kernels.py:106
# the forward kernel's log-sum-exp against the plain one: float32 sums of
# the same bf16 products in another order, and exp2 on the SFU (~2 ulp)
LSE_TOL = 1e-4
# kernels vs plain attention in a bf16 training step of qwen3-8b at full
# width: the loss (a mean over ~2,000 tokens) to a relative 2e-3, and each
# leaf's gradient to a relative L2 of 3e-2, the CPU tests' JAX-vs-port
# gradient tolerance (tests/test_torch_train.py)
LOSS_REL_TOL = 2e-3
GRAD_REL_L2 = 3e-2
ARCH, BATCH, PROMPT, GEN = "qwen3-8b", 4, 512, 32
# every serve run but qwen3-8b's (the main path) and rwkv6-3b's (the wkv6
# record's path) prompts CUT_PROMPT tokens: serving replays the prompt
# through one host-bound decode step a token, and 512 + 32 steps a run
# took most of the serve runs' 672.8 s in an earlier full run on an H100;
# 128 + 32 leave the script room under its time limit
CUT_PROMPT = 128
# the sharded step (phase 3c): qwen3-8b at full width with SHARD_LAYERS
# layers and qwen3-moe-30b-a3b with SHARD_MOE_LAYERS, one training step at
# TRAIN_BATCH x TRAIN_SEQ; qwen3-8b's prefill of BATCH x PROMPT and
# SHARD_DECODE_STEPS decode steps
SHARD_LAYERS, SHARD_MOE_LAYERS, SHARD_DECODE_STEPS = 2, 1, 4
# the KV-sequence-parallel decode (phase 3d): flash_decode's partial
# (out, lse) at qwen3-8b's serve decode and at the per-device block of its
# decode_32k cell on the 16 x 16 mesh (8 of 128 sequences, 2048 of 32,768
# positions, bf16: b, h, kh, S, d below); the serve cache, filled by a
# real BATCH x PROMPT prefill, cut into SEQ_PIECES pieces along its
# sequence and merged, at every layer of SEQ_DECODE_STEPS decode steps
SEQ_BLOCK = (8, 32, 8, 2048, 128)
SEQ_PIECES, SEQ_DECODE_STEPS = 4, 4
RWKV_ARCH = "rwkv6-3b"             # served at the same batch, prompt, gen
# the training run: qwen3-8b at full width with 8 of its 36 layers (the
# float32 weights, grads and two moments of 36 layers, ~131 GB, do not fit
# one card; 8 take ~45 GB, ~50 GB with the bf16 copy)
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 4, 1024, 5
TRAIN_PARAMS = 2_788_235_264
TRAIN_SEED = 11                    # the training batch's documents and tokens
# the trainer phase: the same model and global batch fed by the Overlord,
# 96 samples a step (left at 0, the planner would size a step at 0.6 x
# capacity / 96 = 25 samples, as if each held 96 tokens; the coyo-like
# texts have a median near 20)
TRAINER_STEPS, TRAINER_SAMPLES = 8, 96
# the reduced launcher's run: its tokens are uniform on [1, V), so no model
# does better than ln(V - 1) on them; in LAUNCHER_STEPS steps the mean of
# the last five losses must close LAUNCHER_GAP_SHARE of the gap from the
# first five's mean to that floor (an update that does nothing closes none
# of it, give or take the steps' spread of ~0.03 in a gap of ~0.49)
LAUNCHER_STEPS, LAUNCHER_GAP_SHARE = 100, 0.3
# the paper's VLM backbone (Table 1): served at full width and depth with
# image embeddings over image_token_frac of the prompt; trained at full
# width with VLM_TRAIN_LAYERS of its 45 layers (float32 weights, grads and
# two moments: 16 B a parameter, 51.5 GB) from the Overlord under
# hybrid_balance, then VLM_BACKBONE_STEPS steps under backbone_balance
VLM_ARCH = "paper-llama-12b"
VLM_PARAMS = 16_470_664_704
VLM_TRAIN_LAYERS, VLM_TRAIN_PARAMS = 6, 3_220_498_944
VLM_BACKBONE_STEPS = 4
# the MoE family: granite-moe-3b-a800m and qwen3-moe-30b-a3b served at
# full width and depth (every serve run draws its weights in bf16, a layer
# of a stacked leaf at a time: qwen3-moe-30b-a3b's 48 layers are 56.9 GiB
# so, where a float32 draw would be 113.7); the paper's tMoE-25B backbone
# trained at full width with TMOE_TRAIN_LAYERS of its 42 layers from phase
# 8's plane (16 B a parameter: 3 layers and the embeddings are 2.99B
# parameters, 47.9 GB before the step's activations)
GRANITE_ARCH, MOE_ARCH = "granite-moe-3b-a800m", "qwen3-moe-30b-a3b"
TMOE_ARCH, TMOE_TRAIN_LAYERS, TMOE_TRAIN_PARAMS = ("paper-tmoe-25b", 3,
                                                   2_991_699_968)
# RWKV6 training: rwkv6-3b at full width and depth, all 32 layers, trained
# from phase 8's plane under the reference's remat policy, "layer" (keeping
# every activation, 24 layers peaked at 67.87 GiB and 32 would need ~94 GB;
# a layer recomputed in the backward leaves the 18 B a parameter of float32
# weights, grads, two moments and the bf16 copy, 52 GiB, and one layer's
# activations).  RWKV_PARAMS_BY_LAYERS holds the parameter counts of the
# depths the remat loop also trains.
RWKV_TRAIN_LAYERS = 32
RWKV_PARAMS_BY_LAYERS = {24: 2_408_666_112, 32: 3_099_703_296}
# the rest of the dense family: yi-9b, granite-20b (MQA: 48 q heads on one
# kv head) and qwen3-32b (head_dim 80) served at full width and depth (52.5
# and 56.8 GiB of bf16 weights for the last two); qwen3-32b trained from
# phase 8's plane with QWEN32_TRAIN_LAYERS of its 64 layers (16 B a
# parameter: 3.36B, 1.56B of them embeddings, are 53.8 GB before the step's
# activations), so the backward runs at d 80 on a trained path
YI_ARCH, GRANITE20_ARCH, QWEN32_ARCH = "yi-9b", "granite-20b", "qwen3-32b"
QWEN32_TRAIN_LAYERS, QWEN32_TRAIN_PARAMS = 4, 3_364_664_960
RWKV_TRAIN_PATH = f"trainer:{RWKV_ARCH}"
QWEN32_TRAIN_PATH = f"trainer:{QWEN32_ARCH}:{QWEN32_TRAIN_LAYERS}-of-64-layers"
# the last two families.  zamba2-7b (81 Mamba2 layers, one shared attention
# block of 32 heads of 112 after every 6): served at full width and depth;
# trained from phase 8's plane with ZAMBA_TRAIN_LAYERS of its 81 layers (a
# cut for memory: whole blocks of 6 and the full model's 3-layer tail, the
# deepest that fits one card under the remat policy "layer" in
# ``--only remat``; the 3-layer tail is not checkpointed, as in the
# reference, and keeps the eager chunked scan's activations; keeping every
# activation, 15 layers peaked at 64.14 GiB).  ZAMBA_PARAMS_BY_LAYERS holds
# the parameter counts of the depths the remat loop trains.  whisper-medium (24 encoder and 24 decoder layers, 16
# heads of 64, 1500 frames): served at full width and depth with float32
# enc_embeds, as the JAX launcher feeds them; trained on a fixed batch, as
# the JAX package trains it, with bf16 enc_embeds (model_zoo.input_specs'
# dtype; the float32 attention kernel has no backward)
ZAMBA_ARCH, ZAMBA_PARAMS = "zamba2-7b", 6_750_498_384
ZAMBA_TRAIN_LAYERS = 39
ZAMBA_PARAMS_BY_LAYERS = {15: 1_604_461_488, 39: 3_475_747_632,
                          45: 3_943_569_168, 51: 4_411_390_704}
ZAMBA_TRAIN_PATH = f"trainer:{ZAMBA_ARCH}:{ZAMBA_TRAIN_LAYERS}-of-81-layers"
WHISPER_ARCH, WHISPER_PARAMS = "whisper-medium", 811_358_208
WHISPER_TRAIN_PATH = f"train:{WHISPER_ARCH}"
# the full-width loss: phase 8's model (vocab 151,936) on phase 8's plane
# drawing its tokens uniformly from [1, LOSS_VOCAB), within the sources'
# first pass (LOSS_STEPS < 20 at 96 samples a step); the mean of the last
# five losses must close LOSS_GAP_SHARE of the gap from the first five's to
# ln(LOSS_VOCAB - 1).  tools/loss_probe.py picked the lr on the card: in
# 19 steps lr 0 closes 0.0016 of the gap (the batches' spread), 1e-4 0.155,
# 3e-4 0.828 (a smooth fall from step 7), 1e-3 0.816 (after a spike to 15.7)
LOSS_VOCAB, LOSS_STEPS, LOSS_LR, LOSS_GAP_SHARE = 4096, 19, 3e-4, 0.5
EXAMPLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "examples", "train_e2e_torch.py")


def log(msg: str):
    print(msg, flush=True)


# ------------------------------------------------------------ 1. device
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(f"[device] {name} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    return name


# ------------------------------------------------------------- 2. build
def phase_build(names=None):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all(names or _build.KERNELS)
    log(f"[build] {sorted(logs) or 'nothing stale'} in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "entry")):
                log(f"[build] {name}: {line.strip()}")


# ------------------------------------------------------------- 3. check
def _segs(rng, b, s):
    """Packed rows: several segments and trailing padding on every row."""
    out = np.zeros((b, s), np.int32)
    for i in range(b):
        pos, sid = 0, 1
        while pos < s:
            ln = int(rng.integers(16, max(s // 3, 17)))
            out[i, pos:pos + ln] = sid
            pos += ln
            sid += 1
        out[i, -int(rng.integers(1, s // 8 + 1)):] = 0
    return out


def _bshd(rng, b, s, h, d, dtype):
    """(b, s, h, d) activations seen as (b, h, s, d), as the model does."""
    x = torch.tensor(rng.normal(size=(b, s, h, d)), dtype=torch.float32,
                     device="cuda")
    return x.to(dtype).transpose(1, 2)


def _check(name, got, exp, tol, rtol=None) -> float:
    """allclose at atol = ``tol`` and rtol = ``rtol`` (default ``tol``)."""
    rtol = tol if rtol is None else rtol
    if got.dtype != exp.dtype or got.shape != exp.shape:
        raise AssertionError(f"{name}: got {got.dtype} {tuple(got.shape)}, "
                             f"want {exp.dtype} {tuple(exp.shape)}")
    err = (got.float() - exp.float()).abs().max().item()
    ok = torch.allclose(got.float(), exp.float(), atol=tol, rtol=rtol)
    log(f"[check] {name}: max_abs_err={err:.3e} atol={tol:g} rtol={rtol:g} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def _launch(module, fn, *args, **kw):
    """Call a kernel wrapper once and check it launched exactly once."""
    before = module.launches
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    if module.launches != before + 1:
        raise AssertionError(f"{fn.__name__} launched "
                             f"{module.launches - before} times, not once")
    return out


def phase_check():
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    _check_packed_attention()
    _check_flash_decode()
    _check_flash_decode_graph()
    _check_wkv6()
    _check_reduced_slice()
    _check_reduced_rwkv()
    _check_reduced_vlm()


def _check_pa(rng, b, h, kh, sq, sk, d, dt, causal, q_seg, kv_seg, what=""):
    from repro_torch.kernels import packed_attention, ref
    q, k, v = (_bshd(rng, b, sq, h, d, dt), _bshd(rng, b, sk, kh, d, dt),
               _bshd(rng, b, sk, kh, d, dt))
    q_seg = torch.as_tensor(q_seg, device="cuda")
    kv_seg = torch.as_tensor(kv_seg, device="cuda")
    got = _launch(packed_attention, packed_attention.packed_attention,
                  q, k, v, q_seg, kv_seg, causal=causal)
    exp = ref.packed_attention_ref(q, k, v, q_seg, kv_seg, causal=causal)
    _check(f"packed_attention b={b} h={h} kh={kh} sq={sq} sk={sk} d={d} "
           f"{str(dt)[6:]} causal={causal}{what}", got, exp, TOL[dt])


def _check_packed_attention():
    rng = np.random.default_rng(0)
    pa_cases = [  # (b, h, kh, sq, sk, d, dtype, causal)
        (2, 32, 8, 1000, 1000, 128, dt, c)
        for dt in (torch.float32, torch.bfloat16) for c in (True, False)]
    pa_cases += [
        (2, 8, 1, 300, 300, 64, dt, True) for dt in TOL] + [     # MQA
        (1, 8, 1, 200, 200, 32, dt, True) for dt in TOL] + [     # MQA, d=32
        (2, 4, 4, 300, 300, 80, dt, True) for dt in TOL] + [     # MHA
        (2, 8, 2, 200, 333, 128, dt, False) for dt in TOL]       # sq != sk
    for b, h, kh, sq, sk, d, dt, causal in pa_cases:
        q_seg = _segs(rng, b, sq)
        kv_seg = q_seg if sq == sk else _segs(rng, b, sk)
        _check_pa(rng, b, h, kh, sq, sk, d, dt, causal, q_seg, kv_seg)

    # What the bf16 tensor-core design can break (64-row q and kv tiles).
    bf = torch.bfloat16
    for s in (1, 63, 65, 1000):                 # ragged q and kv tails
        for d in (32, 64, 80, 128):
            seg = _segs(rng, 2, s) if s > 16 else np.ones((2, s), np.int32)
            _check_pa(rng, 2, 8, 2, s, s, d, bf, True, seg, seg)
    # short segments that change mid-tile on both sides, and q and kv ids
    # drawn apart: live tiles where some q rows have no valid key (p must be
    # zeroed there) and rows with no valid key at all (output 0)
    short = np.zeros((2, 300), np.int32)
    for i in range(2):
        short[i] = np.repeat(np.arange(1, 301), rng.integers(3, 40, 300))[:300]
    _check_pa(rng, 2, 8, 2, 300, 300, 128, bf, True, short, short,
              " short segments")
    for causal in (True, False):
        _check_pa(rng, 2, 8, 2, 300, 300, 128, bf, causal, _segs(rng, 2, 300),
                  _segs(rng, 2, 300), " q and kv ids apart")
    # an all-padding q tile (rows 64-127) between live ones
    seg = _segs(rng, 2, 256)
    seg[:, 64:128] = 0
    _check_pa(rng, 2, 8, 2, 256, 256, 128, bf, True, seg, seg,
              " padding q tile")
    # kv tiles live, skipped, live, skipped (padding), live: the cp.async
    # double buffer across skipped tiles
    ids = np.repeat(np.array([5, 7, 5, 0, 5], np.int32), 64)[None].repeat(2, 0)
    _check_pa(rng, 2, 8, 2, 320, 320, 128, bf, True, ids, ids,
              " tiles 5,7,5,0,5")
    _check_pa(rng, 2, 8, 2, 100, 320, 128, bf, False,
              np.full((2, 100), 5, np.int32), ids, " kv tiles 5,7,5,0,5")
    # head dims off the 16-byte path: d % 8 != 0 takes the scalar loads
    _check_pa(rng, 2, 4, 2, 130, 130, 100, bf, True, _segs(rng, 2, 130),
              _segs(rng, 2, 130), " scalar path")
    _check_vlm_packed_attention(rng)
    _check_moe_packed_attention(rng)


def _check_vlm_packed_attention(rng):
    """paper-llama-12b's heads (MHA, 36 of 128) at s 1000, causal."""
    seg = _segs(rng, 2, 1000)
    _check_pa(rng, 2, 36, 36, 1000, 1000, 128, torch.bfloat16, True, seg,
              seg, f" {VLM_ARCH} heads")


def _check_moe_packed_attention(rng):
    """granite-moe-3b-a800m's heads (24 q heads on 8 kv heads of 64, GQA
    group 3) at s 1000, causal, in both dtypes."""
    for dt in TOL:
        seg = _segs(rng, 2, 1000)
        _check_pa(rng, 2, 24, 8, 1000, 1000, 64, dt, True, seg, seg,
                  f" {GRANITE_ARCH} heads")


def _check_flash_decode():
    """The old cases, then every GQA group size the head chunking meets
    (1, 4, 6 and 16 q heads per kv head), cache_len 1, just past a tile and
    just past a split, and a long cache whose warps walk several tiles
    (the two-stage ring); then paper-llama-12b's heads."""
    rng = np.random.default_rng(1)
    cases = [(4, 32, 8, 1100, 128, None), (3, 16, 2, 300, 64, None),
             (2, 4, 4, 70, 80, None)]
    for b, h, kh, S, d in [(4, 16, 16, 300, 128), (4, 16, 4, 300, 128),
                           (4, 12, 2, 200, 64), (4, 32, 2, 300, 128),
                           (4, 32, 8, 4096, 128)]:
        cases.append((b, h, kh, S, d, _edge_lens(b, h, kh, S)))
    for case in cases:
        _check_fd(rng, *case)
    _check_vlm_flash_decode(rng)
    _check_moe_flash_decode(rng)


def _edge_lens(b, h, kh, S) -> list:
    """cache_len 1, just past a tile, just past a split, and S."""
    from repro_torch.kernels import flash_decode
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = flash_decode.split_plan(b, kh, h // kh, S, sms)
    lens = [1, flash_decode.TILE_ROWS + 1, plan.split_len + 1, S]
    return [min(n, S) for n in lens]


def _check_fd(rng, b, h, kh, S, d, lens):
    """flash_decode against its plain version for three (q, cache) dtype
    pairs, on one layer's slice of a (kv, layers, b, S, kh, d) cache;
    ``lens``: the cache lengths, or None for random ones with row 0 full."""
    from repro_torch.kernels import flash_decode, ref
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = flash_decode.split_plan(b, kh, h // kh, S, sms)
    for q_dt, c_dt in [(torch.float32, torch.float32),
                       (torch.bfloat16, torch.float32),
                       (torch.bfloat16, torch.bfloat16)]:
        q = torch.tensor(rng.normal(size=(b, h, d)), device="cuda").to(q_dt)
        cache = torch.tensor(rng.normal(size=(2, 2, b, S, kh, d)),
                             device="cuda").to(c_dt)  # (kv, layers, ...)
        kc, vc = cache[0, 1].transpose(1, 2), cache[1, 1].transpose(1, 2)
        if lens is None:
            clen = torch.tensor(rng.integers(1, S + 1, size=(b,)),
                                dtype=torch.int32, device="cuda")
            clen[0] = S
        else:
            clen = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = _launch(flash_decode, flash_decode.flash_decode, q, kc, vc,
                      clen)
        exp = ref.flash_decode_ref(q, kc, vc, clen)
        _check(f"flash_decode b={b} h={h} kh={kh} S={S} d={d} "
               f"q={str(q_dt)[6:]} cache={str(c_dt)[6:]} "
               f"cache_len={clen.tolist()} {plan}", got, exp, TOL[q_dt])


def _check_vlm_flash_decode(rng):
    """paper-llama-12b's heads (36 on 36 kv heads of 128) on its serve
    cache's length, PROMPT + GEN, with ragged cache lengths."""
    S = PROMPT + GEN
    _check_fd(rng, BATCH, 36, 36, S, 128, _edge_lens(BATCH, 36, 36, S))


def _check_moe_flash_decode(rng):
    """granite-moe-3b-a800m's heads (group 3, d 64: four heads a CTA, one
    idle) and qwen3-moe-30b-a3b's (32 on 4 of 128, group 8) on their serve
    caches' length, PROMPT + GEN, with ragged cache lengths."""
    S = PROMPT + GEN
    for h, kh, d in ((24, 8, 64), (32, 4, 128)):
        _check_fd(rng, BATCH, h, kh, S, d, _edge_lens(BATCH, h, kh, S))


def _check_flash_decode_graph():
    """One flash_decode call captured in a CUDA graph and replayed three
    times with other cache lengths: each replay must match the plain
    version, which holds only if the fused combine leaves its arrival
    counters at 0."""
    from repro_torch.kernels import flash_decode, ref
    rng = np.random.default_rng(2)
    b, h, kh, S, d = BATCH, 32, 8, PROMPT + GEN, 128
    q = torch.tensor(rng.normal(size=(b, h, d)), device="cuda").to(
        torch.bfloat16)
    kc, vc = (torch.tensor(rng.normal(size=(b, S, kh, d)), dtype=torch.float32,
                           device="cuda").transpose(1, 2) for _ in range(2))
    clen = torch.full((b,), S, dtype=torch.int32, device="cuda")
    flash_decode.flash_decode(q, kc, vc, clen)    # scratch made before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_decode.flash_decode(q, kc, vc, clen)
    for lens in ([S, 1, 300, 33], [17, S, 9, 200], [S, S, S, S]):
        clen.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        _check(f"flash_decode CUDA-graph replay cache_len={lens}", out,
               ref.flash_decode_ref(q, kc, vc, clen), SERVE_DECODE_TOL)


def _check_reduced_slice(module: str = "qwen3_8b"):
    """A reduced config (qwen3-8b unless ``module`` names another),
    float32: prefill and 24 decode steps with the kernels on the card
    against the plain versions on the CPU, same weights; logits to 2e-3
    (tests/test_models.py)."""
    import importlib
    from repro_torch.models.model_zoo import build_model
    cfg = importlib.import_module(f"repro_torch.configs.{module}").reduced()
    gpu = build_model(cfg, torch.Generator(device="cuda").manual_seed(1))
    cpu = build_model(cfg, torch.Generator().manual_seed(1))
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(1)
    b, s = 2, 24
    tokens = rng.integers(1, cfg.vocab_size, (b, s))
    outs = []
    with torch.no_grad():
        for m in (gpu, cpu):
            batch = {"tokens": torch.tensor(tokens, dtype=torch.int32,
                                            device=m.device),
                     "segment_ids": torch.ones((b, s), dtype=torch.int32,
                                               device=m.device),
                     "positions": torch.arange(
                         s, dtype=torch.int32, device=m.device).repeat(b, 1)}
            logits, _ = m.prefill(batch)
            cache = m.init_cache(b, s, torch.float32)
            for t in range(s):
                dec, cache = m.decode_step(cache, batch["tokens"][:, t:t + 1],
                                           t)
            outs.append(torch.cat([logits, dec], 1).cpu())
    _check(f"{cfg.name} slice, card vs CPU plain", outs[0], outs[1], 2e-3)


def _check_reduced_vlm():
    """Reduced paper-llama-12b, float32: a prefill whose rows carry image
    embeddings over image_token_frac of their positions, then decode steps
    of given tokens from its cache, with the kernels on the card against
    the plain versions on the CPU, same weights and embeddings; logits to
    2e-3."""
    from repro_torch.configs.paper_vlm import reduced
    from repro_torch.models.model_zoo import build_model
    cfg = reduced()
    gpu = build_model(cfg, torch.Generator(device="cuda").manual_seed(4))
    cpu = build_model(cfg, torch.Generator().manual_seed(4))
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(4)
    b, s, gen = 2, 64, 8
    n = int(s * cfg.image_token_frac)
    tokens = rng.integers(1, cfg.vocab_size, (b, s))
    embeds = rng.normal(size=(b, n, cfg.d_model)) * 0.02
    later = rng.integers(1, cfg.vocab_size, (b, gen))   # the decoded tokens
    outs = []
    with torch.no_grad():
        for m in (gpu, cpu):
            dev = m.device
            batch = {"tokens": torch.tensor(tokens, dtype=torch.int32,
                                            device=dev),
                     "segment_ids": torch.ones((b, s), dtype=torch.int32,
                                               device=dev),
                     "positions": torch.arange(
                         s, dtype=torch.int32, device=dev).repeat(b, 1),
                     "image_embeds": torch.tensor(embeds, dtype=torch.float32,
                                                  device=dev),
                     "image_positions": torch.arange(
                         n, dtype=torch.int32, device=dev).repeat(b, 1)}
            logits, kv = m.prefill(batch)
            cache = m.init_cache(b, s + gen, torch.float32)
            for name in ("k", "v"):
                cache[name][:, :, :s] = kv[name]
            steps = [logits]
            for t in range(s, s + gen):
                cur = torch.tensor(later[:, t - s:t - s + 1],
                                   dtype=torch.int32, device=dev)
                dec, cache = m.decode_step(cache, cur, t)
                steps.append(dec)
            outs.append(torch.cat(steps, 1).cpu())
    _check(f"reduced {VLM_ARCH} slice with {n} image positions, card vs CPU "
           "plain: prefill + decode logits", outs[0], outs[1], 2e-3)


def _wkv6_inputs(rng, b, s, h, dk, seg=None, scale=0.5):
    """r, k, v, loga (b, s, h, dk) and u (h, dk), float32 on the card, at
    the scales of tests/test_kernels.py, with loga = -exp(scale N(0, 1)).
    With packed segment ids ``seg`` the resets are the model's,
    ``(seg != prev) | (seg == 0)``, and k is zeroed on padding as the model
    does; else the first token resets."""
    def normal(*shape, scale=0.5):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device="cuda") * scale
    r, k, v = (normal(b, s, h, dk) for _ in range(3))
    loga = -torch.exp(normal(b, s, h, dk, scale=scale))
    u = normal(h, dk)
    if seg is None:
        reset = torch.zeros((b, s), dtype=torch.bool, device="cuda")
        reset[:, 0] = True
        return r, k, v, loga, u, reset
    seg = torch.tensor(seg, device="cuda")
    prev = torch.nn.functional.pad(seg[:, :-1], (1, 0))
    k = k * (seg > 0)[..., None, None]
    return r, k, v, loga, u, (seg != prev) | (seg == 0)


def _check_wkv6():
    """wkv6 against the sequential oracle ``ref.wkv6_ref`` and the chunked
    plain version ``ref.wkv6_chunked`` (o and the final state), at
    atol 5e-5 / rtol 5e-4 (tests/test_kernels.py:106)."""
    from repro_torch.kernels import ref, wkv6
    rng = np.random.default_rng(4)
    # rwkv6-3b heads, ragged s: resets at row starts, mid-chunk segment
    # starts and a padded tail
    b, h, s, dk = 4, 40, 1000, 64
    args = _wkv6_inputs(rng, b, s, h, dk, _segs(rng, b, s))
    got = _launch(wkv6, wkv6.wkv6, *args, chunk=64)
    _check(f"wkv6 b={b} h={h} s={s} dk={dk} chunk=64 packed, vs wkv6_ref",
           got, ref.wkv6_ref(*args), *WKV_TOL)
    # the final state, at a length the chunked plain version takes; the
    # padded tail becomes one more segment (starting mid-chunk), so the
    # state at the end is live rather than reset to zero by padding
    s = 1024
    seg = _segs(rng, b, s)
    for row in seg:
        row[row == 0] = row.max() + 1
    args = _wkv6_inputs(rng, b, s, h, dk, seg)
    o, state = _launch(wkv6, wkv6.wkv6, *args, chunk=64, return_state=True)
    o_exp, state_exp = ref.wkv6_chunked(*args[:5], chunk=64, reset=args[5],
                                        return_state=True)
    _check(f"wkv6 b={b} h={h} s={s} dk={dk} packed, o vs wkv6_chunked", o,
           o_exp, *WKV_TOL)
    _check(f"wkv6 b={b} h={h} s={s} dk={dk} packed, final state vs "
           "wkv6_chunked", state, state_exp, *WKV_TOL)
    # the same with slow decays (loga / 50, about exp(-0.02) a token), so
    # the state carries across several chunks instead of fading in one
    args = args[:3] + (args[3] / 50,) + args[4:]
    o, state = _launch(wkv6, wkv6.wkv6, *args, chunk=64, return_state=True)
    o_exp, state_exp = ref.wkv6_chunked(*args[:5], chunk=64, reset=args[5],
                                        return_state=True)
    name = f"wkv6 b={b} h={h} s={s} dk={dk} packed, slow decays"
    _check(f"{name}, vs wkv6_ref", o, ref.wkv6_ref(*args), *WKV_TOL)
    _check(f"{name}, o vs wkv6_chunked", o, o_exp, *WKV_TOL)
    _check(f"{name}, final state vs wkv6_chunked", state, state_exp,
           *WKV_TOL)
    # tests/test_kernels.py:84-98 (mid-chunk resets), and s below the chunk
    for b, h, s, dk, chunk in [(2, 3, 128, 32, 32), (1, 2, 192, 64, 64),
                               (2, 2, 64, 16, 16), (2, 4, 40, 64, 64)]:
        args = _wkv6_inputs(rng, b, s, h, dk)
        args[5][0, s // 3] = True
        args[5][-1, s // 2 + 3] = True
        rst = args[5].to(torch.int32) if dk == 16 else args[5]
        if dk == 32:    # (b, h, s, dk) buffers seen as (b, s, h, dk)
            args = tuple(a.transpose(1, 2).contiguous().transpose(1, 2)
                         for a in args[:4]) + args[4:]
        o, state = _launch(wkv6, wkv6.wkv6, *args[:5], rst, chunk=chunk,
                           return_state=True)
        name = f"wkv6 b={b} h={h} s={s} dk={dk} chunk={chunk} " \
            f"reset={str(rst.dtype)[6:]} r.stride={args[0].stride()}"
        _check(f"{name}, vs wkv6_ref", o, ref.wkv6_ref(*args), *WKV_TOL)
        o_exp, state_exp = ref.wkv6_chunked(*args[:5], chunk=chunk,
                                            reset=args[5], return_state=True)
        _check(f"{name}, o vs wkv6_chunked", o, o_exp, *WKV_TOL)
        _check(f"{name}, final state vs wkv6_chunked", state, state_exp,
               *WKV_TOL)
    # resets on sub-chunk edges (t = 16, 32, 48 of a chunk) and mid-sub-
    # chunk, loga down to about -700 (scale 1.5), every head size and chunk
    edges = [(0, 16), (0, 96), (1, 48), (1, 69), (1, 160)]
    for dk in (16, 32, 64):
        for chunk in (16, 32, 64):
            b, h, s = 2, 3, 192
            args = _wkv6_inputs(rng, b, s, h, dk, scale=1.5)
            for row, t in edges:
                args[5][row, t] = True
            o, state = _launch(wkv6, wkv6.wkv6, *args, chunk=chunk,
                               return_state=True)
            name = f"wkv6 b={b} h={h} s={s} dk={dk} chunk={chunk} " \
                "sub-chunk-edge resets, loga scale 1.5"
            _check(f"{name}, vs wkv6_ref", o, ref.wkv6_ref(*args), *WKV_TOL)
            o_exp, state_exp = ref.wkv6_chunked(
                *args[:5], chunk=chunk, reset=args[5], return_state=True)
            _check(f"{name}, o vs wkv6_chunked", o, o_exp, *WKV_TOL)
            _check(f"{name}, final state vs wkv6_chunked", state, state_exp,
                   *WKV_TOL)
    # rows that are not 16-byte aligned (r, k, v, loga seen through columns
    # 1..64 of a 65-wide buffer): the kernels' 4-byte copies
    b, h, s, dk = 2, 3, 100, 64
    args = _wkv6_inputs(rng, b, s, h, dk)
    args[5][1, 50] = True
    args = tuple(torch.nn.functional.pad(a, (1, 0))[..., 1:]
                 for a in args[:4]) + args[4:]
    o, state = _launch(wkv6, wkv6.wkv6, *args, chunk=64, return_state=True)
    name = f"wkv6 b={b} h={h} s={s} dk={dk} r.stride={args[0].stride()}"
    _check(f"{name}, vs wkv6_ref", o, ref.wkv6_ref(*args), *WKV_TOL)
    _check(f"{name}, final state vs wkv6_two_pass", state,
           ref.wkv6_two_pass(*args, chunk=64)[1], *WKV_TOL)
    # rwkv6-3b heads at the serve length: the state entering every chunk
    # (pass 1's output) against the plain two-pass decomposition, so a
    # wrong state shows at its chunk
    b, h, s, dk = 4, 40, 512, 64
    seg = np.ones((b, s), np.int32)
    seg[0, 80:], seg[1, 160:], seg[2, 304:], seg[3, 327:] = 2, 2, 2, 2
    args = _wkv6_inputs(rng, b, s, h, dk, seg)
    states = torch.empty((b, h, s // 64, dk, dk), device="cuda")
    o, state = _launch(wkv6, wkv6.wkv6, *args, chunk=64, return_state=True,
                       chunk_states=states)
    o_exp, state_exp, states_exp = ref.wkv6_two_pass(*args, chunk=64)
    name = f"wkv6 b={b} h={h} s={s} dk={dk} resets at 80, 160, 304, 327"
    _check(f"{name}, entering states vs wkv6_two_pass", states, states_exp,
           *WKV_TOL)
    _check(f"{name}, o vs wkv6_two_pass", o, o_exp, *WKV_TOL)
    _check(f"{name}, final state vs wkv6_two_pass", state, state_exp,
           *WKV_TOL)
    _check(f"{name}, o vs wkv6_ref", o, ref.wkv6_ref(*args), *WKV_TOL)
    _check_steep_wkv6()
    _check_wkv6_one_chunk()


def _steep_wkv6_inputs(scale: float):
    """rwkv6-3b heads at the serve length with steep decays, loga =
    -exp(scale N(0, 1)), and one segment start inside each row."""
    b, h, s, dk = BATCH, 40, PROMPT, 64
    seg = np.ones((b, s), np.int32)
    seg[0, 80:], seg[1, 160:], seg[2, 304:], seg[3, 327:] = 2, 2, 2, 2
    return _wkv6_inputs(np.random.default_rng([7, int(scale * 10)]), b, s,
                        h, dk, seg, scale=scale)


def _steep_distance(o, exact) -> str:
    """How far ``o`` lies from the float64 ``exact``, against 5e-5 / 5e-4."""
    err = (o.double() - exact).abs()
    tol = WKV_TOL[0] + WKV_TOL[1] * exact.abs()
    return (f"max_abs_err={err.max().item():.3e} worst err/(atol + rtol "
            f"|exact|)={(err / tol).max().item():.3f} outputs past it="
            f"{int((err > tol).sum())} of {err.numel()}")


def _check_steep_wkv6():
    """Steep decays at the serve shape: loga down to about -700 (scale 1.5)
    and -1e5 (scale 2.5).  The kernel sums every exponent over its own
    range, so it holds 5e-5 / 5e-4 of the float64 sequential oracle, and of
    ``wkv6_two_pass`` (o, final state).  The plain ``wkv6_chunked`` takes
    differences of float32 cumsums, which move its outputs past that here:
    its distance is printed, not checked."""
    from repro_torch.kernels import ref, wkv6
    for scale in (1.5, 2.5):
        args = _steep_wkv6_inputs(scale)
        o, state = _launch(wkv6, wkv6.wkv6, *args, chunk=64,
                           return_state=True)
        o_exp, state_exp, _ = ref.wkv6_two_pass(*args, chunk=64)
        exact = ref.wkv6_ref(*(a.double() for a in args[:5]), args[5])
        name = f"wkv6 serve shape, loga scale {scale}"
        _check(f"{name}, o vs float64 wkv6_ref", o.double(), exact,
               *WKV_TOL)
        _check(f"{name}, o vs wkv6_two_pass", o, o_exp, *WKV_TOL)
        _check(f"{name}, final state vs wkv6_two_pass", state, state_exp,
               *WKV_TOL)
        plain = ref.wkv6_chunked(*args[:5], chunk=64, reset=args[5])
        log(f"[report] {name}, plain wkv6_chunked vs float64 wkv6_ref: "
            f"{_steep_distance(plain, exact)}")


def _check_wkv6_one_chunk():
    """s within one chunk, so no CTA of pass 2 reads pass 1's scratch: the
    final state, read by the next operation on the stream, right after the
    call and in three replays of a CUDA graph of the call and that read."""
    from repro_torch.kernels import ref, wkv6
    rng = np.random.default_rng(8)
    b, h, s, dk = BATCH, 40, 40, 64
    args = _wkv6_inputs(rng, b, s, h, dk)
    args[5][1, 20] = True
    o_exp, state_exp, _ = ref.wkv6_two_pass(*args, chunk=64)
    name = f"wkv6 b={b} h={h} s={s} dk={dk} chunk=64"
    o, state = wkv6.wkv6(*args, chunk=64, return_state=True)
    read = state.clone()
    torch.cuda.synchronize()
    _check(f"{name}, o vs wkv6_two_pass", o, o_exp, *WKV_TOL)
    _check(f"{name}, final state read next vs wkv6_two_pass", read,
           state_exp, *WKV_TOL)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o, state = wkv6.wkv6(*args, chunk=64, return_state=True)
        read = state.clone()
    for i in range(3):
        read.zero_()
        graph.replay()
        torch.cuda.synchronize()
        _check(f"{name}, CUDA-graph replay {i}, final state read next vs "
               "wkv6_two_pass", read, state_exp, *WKV_TOL)


def _check_reduced_rwkv():
    """Reduced rwkv6-3b, float32: prefill of a packed batch (segment starts
    mid-chunk, padding at a row's end) and 24 decode steps, the WKV6 kernel
    on the card against the plain versions on the CPU, same weights; the
    zero-initialised LoRA up-projections get small random values so the
    data-dependent mix and decay are live.  Logits and the prefill states
    to 2e-3 (tests/test_models.py); prefill launches the kernel once per
    layer."""
    from repro_torch.configs.rwkv6_3b import reduced
    from repro_torch.kernels import wkv6
    from repro_torch.models.model_zoo import build_model
    cfg = reduced()
    gen = torch.Generator(device="cuda").manual_seed(2)
    gpu = build_model(cfg, gen)
    for name, prm in gpu.named_parameters():
        if ".mixB_" in name or name.endswith("loraB_w"):
            prm.data.normal_(0.0, 0.1, generator=gen)
    cpu = build_model(cfg, torch.Generator().manual_seed(2))
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(2)
    b, s, steps = 2, 48, 24                # three chunks of 16
    tokens = rng.integers(1, cfg.vocab_size, (b, s))
    seg = np.ones((b, s), np.int32)
    seg[0, 20:42], seg[0, 42:] = 2, 0
    seg[1, 7:] = 2
    logits, states = [], []
    with torch.no_grad():
        for m in (gpu, cpu):
            batch = {"tokens": torch.tensor(tokens, dtype=torch.int32,
                                            device=m.device),
                     "segment_ids": torch.tensor(seg, device=m.device)}
            before = wkv6.launches
            pre, st = m.prefill(batch)
            torch.cuda.synchronize()
            launched = wkv6.launches - before
            want = cfg.num_layers if m is gpu else 0
            if launched != want:
                raise AssertionError(f"reduced rwkv6-3b prefill on "
                                     f"{m.device} launched wkv6 {launched} "
                                     f"times, not {want}")
            cache = m.init_cache(b, s, torch.float32)
            outs = [pre]
            for t in range(steps):
                dec, cache = m.decode_step(cache, batch["tokens"][:, t:t + 1],
                                           t)
                outs.append(dec)
            logits.append(torch.cat(outs, 1).cpu())
            states.append({n: x.cpu() for n, x in st.items()})
    _check("reduced rwkv6-3b slice, card vs CPU plain: prefill + decode "
           "logits", logits[0], logits[1], 2e-3)
    for n in ("tm_shift", "cm_shift", "wkv"):
        _check(f"reduced rwkv6-3b slice, card vs CPU plain: prefill {n}",
               states[0][n], states[1][n], 2e-3)


# ------------------------------------------------------ 3. train checks
def _packed_rows(rng, b: int, s: int, vocab: int = 2):
    """``b`` training rows of ``s`` tokens as the data plane packs them
    (a ``data.packing.PackedBatch``).  Each document's source is one of
    ``data.sources.coyo_like_specs(4)`` (the group the training launcher
    reads by default), chosen uniformly (the launcher's equal-weight
    schedule), and its text length is drawn by ``sample_lengths``, with
    Fig. 2's skew (most documents short, a long tail); documents are drawn
    until they hold as many tokens as the rows, each cut to ``s``.  Then
    their tokens, uniform on [1, ``vocab``), after every length, so the
    rows' layout does not depend on ``vocab`` (2 for a caller that reads
    only the layout).  ``pack_sequences`` packs them first-fit in draw
    order, dropping a document that fits no row: segment ids from 1 in
    each row, positions restarting at each document, next-token labels,
    -1 on each document's last token and on padding."""
    from types import SimpleNamespace
    from repro_torch.data.packing import pack_sequences
    from repro_torch.data.sources import coyo_like_specs, sample_lengths
    specs, docs, drawn = coyo_like_specs(4), [], 0
    while drawn < b * s:
        spec = specs[rng.integers(len(specs))]
        n = min(int(sample_lengths(spec, 1, rng)[0][0]), s)
        docs.append((f"{spec.name}/{len(docs)}", n))
        drawn += n
    return pack_sequences([SimpleNamespace(
        sample_id=name, tokens=rng.integers(1, vocab, n).astype(np.int32))
        for name, n in docs], s, b)


def _card_batch(rows) -> dict:
    """A ``PackedBatch``'s tokens, segment ids, positions and labels on
    the card."""
    return {k: torch.as_tensor(getattr(rows, k), device="cuda")
            for k in ("tokens", "segment_ids", "positions", "labels")}


def _lm_batch(rng, vocab: int, seg: np.ndarray,
              next_token: bool = False) -> dict:
    """A packed LM batch on the card with a layout made by hand (``seg``,
    not the data plane's: ``_packed_rows`` gives those): positions restart
    at every segment; labels -1 on padding and, as tests/conftest.
    make_lm_batch makes them, the tokens themselves, or with
    ``next_token`` each segment's next tokens and -1 on its last."""
    b, s = seg.shape
    tokens = rng.integers(1, vocab, (b, s)).astype(np.int32)
    pos = np.zeros((b, s), np.int32)
    labels = np.where(seg > 0, tokens, -1).astype(np.int32)
    for i in range(b):
        for sid in np.unique(seg[i][seg[i] > 0]):
            idx = np.flatnonzero(seg[i] == sid)
            pos[i, idx] = np.arange(len(idx))
            if next_token:
                labels[i, idx[:-1]] = tokens[i, idx[1:]]
                labels[i, idx[-1]] = -1
    return {k: torch.as_tensor(v, device="cuda") for k, v in (
        ("tokens", tokens), ("segment_ids", seg), ("positions", pos),
        ("labels", labels))}


def _check_lse(name, got, exp, tol) -> float:
    """Equal +inf where a row has no valid key, allclose elsewhere."""
    inf = torch.isinf(exp)
    if not torch.equal(torch.isinf(got), inf) or (got[inf] < 0).any():
        raise AssertionError(f"{name}: rows with no valid key differ")
    return _check(name, got[~inf], exp[~inf], tol)


def _kernel_live_pairs(live_q, live_kv, q_seg, kv_seg, causal, tag) -> int:
    """The live tiles each CTA of the backward kernel reported
    (``return_live``) against ``ref.packed_attention_live_tiles``: a dQ
    CTA's count of key tiles, for every q head, and a dK/dV CTA's count of
    q tiles must be the mirror's.  Returns the tile pairs a launch
    computes over every q head, as the kernel counted them."""
    from repro_torch.kernels import ref
    mirror = ref.packed_attention_live_tiles(q_seg, kv_seg, causal=causal)
    per_q, per_kv = mirror.sum(2, dtype=torch.int32), mirror.sum(
        1, dtype=torch.int32)
    if not (torch.equal(live_q, per_q[:, None].expand_as(live_q))
            and torch.equal(live_kv, per_kv[:, None].expand_as(live_kv))):
        raise AssertionError(f"{tag}: the live tiles the kernel found differ "
                             "from ref.packed_attention_live_tiles")
    return int(live_q.sum())


def _tol_share(got, exp, tol) -> tuple[float, int]:
    """The largest |got - exp| / (tol + tol |exp|) and how many elements
    pass 1."""
    ratio = (got.double() - exp.double()).abs() / (tol + tol
                                                    * exp.double().abs())
    return ratio.max().item(), int((ratio > 1).sum())


def _check_long_group_bwd(tag, q, k, v, out, lse, dout, q_seg, kv_seg,
                          causal, got) -> float:
    """A long GQA group (granite-20b's 48 q heads on one kv head): dK and
    dV sum the group's heads, so the bf16 operands' rounding adds up past
    the float32 oracles' elementwise tolerance for any bf16 backward.  The
    kernel is held to ``packed_attention_bwd_bf16_ref`` (the float32 sums
    rounding P and dS where the kernel rounds them) at the bf16 tolerance,
    and its distance from the float32 autograd oracle, as a share of that
    tolerance, to at most the distance of SDPA's backward (autograd of
    ``F.scaled_dot_product_attention`` on the same bf16 inputs, the rows
    holding no padding); the float32 plain version's distance is logged."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    bf = torch.bfloat16
    if not (q_seg > 0).all():
        raise ValueError("the SDPA yardstick needs rows with no padding")
    emul = ref.packed_attention_bwd_bf16_ref(q, k, v, out, lse, dout, q_seg,
                                             kv_seg, causal=causal)
    plain = ref.packed_attention_bwd_ref(q, k, v, out, lse, dout, q_seg,
                                         kv_seg, causal=causal)
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    ref.packed_attention_ref(*leaves, q_seg, kv_seg, causal=causal
                             ).backward(dout.float())
    mask = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
    if causal:
        mask = mask & torch.tril(torch.ones(
            (q.shape[2], k.shape[2]), dtype=torch.bool, device="cuda"))
    lib = [t.detach().requires_grad_() for t in (q, k, v)]
    F.scaled_dot_product_attention(*lib, attn_mask=mask, enable_gqa=True
                                   ).backward(dout)
    err = 0.0
    for i, name in enumerate(("dq", "dk", "dv")):
        err = max(err, _check(f"{tag}: {name} vs packed_attention_bwd_bf16_"
                              "ref", got[i], emul[i], TOL[bf]))
        share = _tol_share(got[i], emul[i], TOL[bf])[0]
        log(f"[report] {tag}: {name} vs packed_attention_bwd_bf16_ref, worst "
            f"err/(atol + rtol |ref|) {share:.3f}")
        f32 = leaves[i].grad
        ours, past = _tol_share(got[i], f32, TOL[bf])
        sdpa, sdpa_past = _tol_share(lib[i].grad, f32, TOL[bf])
        flat, flat_past = _tol_share(plain[i], f32, TOL[bf])
        ok = ours <= sdpa
        log(f"[check] {tag}: {name} vs float32 autograd of "
            f"packed_attention_ref, worst err/(atol + rtol |ref|): kernel "
            f"{ours:.3f} ({past} of {f32.numel()} past 1), SDPA backward "
            f"{sdpa:.3f} ({sdpa_past} past), float32 plain version "
            f"{flat:.3f} ({flat_past} past); kernel at most SDPA's "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag}: {name} lies farther from the "
                                 "float32 oracle than SDPA's backward")
    return err


def _check_pa_bwd(rng, b, h, kh, sq, sk, d, causal, q_seg, kv_seg, what="",
                  dout=None, f32_oracle=False, long_group=False):
    """The backward kernel against both plain versions, bf16: the forward's
    lse against ``packed_attention_lse_ref``, then dq, dk, dv against
    ``packed_attention_bwd_ref`` (on the kernel's own out and lse) and
    against autograd of ``packed_attention_ref``; two calls on the same
    inputs must agree bit for bit, and the live tiles the kernel reports
    must be the mirror's.  ``dout``: drawn like q unless given.  With
    ``f32_oracle`` the autograd oracle runs on float32 copies of q, k, v
    and dout, and the bf16 one is only logged: the bf16 oracle rounds each
    of its own intermediates (scores, probabilities, dP, dS) to bf16, so
    at long GQA groups it is the side that drifts.  With ``long_group``
    the three gradients are held as ``_check_long_group_bwd`` holds
    them."""
    from repro_torch.kernels import packed_attention, packed_attention_bwd
    from repro_torch.kernels import ref
    bf = torch.bfloat16
    q, k, v = (_bshd(rng, b, sq, h, d, bf), _bshd(rng, b, sk, kh, d, bf),
               _bshd(rng, b, sk, kh, d, bf))
    if dout is None:
        dout = _bshd(rng, b, sq, h, d, bf)
    q_seg = torch.as_tensor(q_seg, device="cuda")
    kv_seg = torch.as_tensor(kv_seg, device="cuda")
    tag = (f"packed_attention_bwd b={b} h={h} kh={kh} sq={sq} sk={sk} d={d} "
           f"causal={causal}{what}")
    out, lse = _launch(packed_attention, packed_attention.packed_attention,
                       q, k, v, q_seg, kv_seg, causal=causal, return_lse=True)
    _check_lse(f"{tag}: forward lse", lse, ref.packed_attention_lse_ref(
        q, k, q_seg, kv_seg, causal=causal), LSE_TOL)
    *got, live_q, live_kv = _launch(
        packed_attention_bwd, packed_attention_bwd.packed_attention_bwd, q,
        k, v, out, lse, dout, q_seg, kv_seg, causal=causal, return_live=True)
    pairs = _kernel_live_pairs(live_q, live_kv, q_seg, kv_seg, causal, tag)
    again = packed_attention_bwd.packed_attention_bwd(
        q, k, v, out, lse, dout, q_seg, kv_seg, causal=causal)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{tag}: two calls differ (not deterministic)")
    if long_group:
        err = _check_long_group_bwd(tag, q, k, v, out, lse, dout, q_seg,
                                    kv_seg, causal, got)
        log(f"[check] {tag}: dq, dk, dv bitwise equal over two calls; "
            f"{pairs} live tile pairs, each CTA's count as the mirror's")
        return err
    plain = ref.packed_attention_bwd_ref(q, k, v, out, lse, dout, q_seg,
                                         kv_seg, causal=causal)

    def autograd(dt):
        leaves = [t.detach().to(dt).requires_grad_() for t in (q, k, v)]
        ref.packed_attention_ref(*leaves, q_seg, kv_seg, causal=causal
                                 ).backward(dout.to(dt))
        return [t.grad for t in leaves]
    oracle = autograd(torch.float32 if f32_oracle else bf)
    kind = "float32 autograd" if f32_oracle else "autograd"
    if f32_oracle:
        for name, g, a in zip(("dq", "dk", "dv"), got, autograd(bf)):
            err = (g.float() - a.float()).abs().max().item()
            log(f"[check] {tag}: {name} vs bf16 autograd of "
                f"packed_attention_ref (logged, not checked): "
                f"max_abs_err={err:.3e}, "
                f"allclose at {TOL[bf]:g}: "
                f"{torch.allclose(g.float(), a.float(), TOL[bf], TOL[bf])}")
    err = 0.0
    for name, g, p_, a in zip(("dq", "dk", "dv"), got, plain, oracle):
        err = max(err, _check(f"{tag}: {name} vs packed_attention_bwd_ref", g,
                              p_, TOL[bf]),
                  _check(f"{tag}: {name} vs {kind} of packed_attention_ref",
                         g.to(a.dtype), a, TOL[bf]))
    log(f"[check] {tag}: dq, dk, dv bitwise equal over two calls; "
        f"{pairs} live tile pairs, each CTA's count as the mirror's")
    return err


def _check_packed_attention_bwd():
    """The shapes the backward kernel can break (64-row q and kv tiles,
    D padded to 16/32/64/128), at d 16, 64 and 128."""
    rng = np.random.default_rng(7)
    cases = [  # (b, h, kh, sq, sk, d, causal), segments from _segs
        (2, 8, 2, 1000, 1000, 128, True),   # GQA, ragged tail
        (2, 8, 8, 300, 300, 64, True),      # MHA
        (2, 8, 1, 200, 200, 16, True),      # MQA, d = 16
        (2, 8, 2, 200, 333, 128, False),    # sq != sk
        (2, 4, 1, 130, 70, 64, False),      # MQA, sq > sk
        (1, 4, 2, 65, 65, 16, True),        # one row past a tile
    ]
    for b, h, kh, sq, sk, d, causal in cases:
        q_seg = _segs(rng, b, sq)
        kv_seg = q_seg if sq == sk else _segs(rng, b, sk)
        _check_pa_bwd(rng, b, h, kh, sq, sk, d, causal, q_seg, kv_seg)
    # short segments that start mid-tile, q and kv ids apart (rows with no
    # valid key in live tiles), an all-padding q tile, a padding batch row
    short = np.repeat(np.arange(1, 301), rng.integers(3, 40, 300))[:300]
    short = np.stack([short, short]).astype(np.int32)
    _check_pa_bwd(rng, 2, 8, 2, 300, 300, 64, True, short, short,
                  " short segments")
    for causal in (True, False):
        _check_pa_bwd(rng, 2, 8, 2, 300, 300, 128, causal,
                      _segs(rng, 2, 300), _segs(rng, 2, 300),
                      " q and kv ids apart")
    seg = _segs(rng, 2, 256)
    seg[0, 64:128] = 0
    seg[1] = 0
    _check_pa_bwd(rng, 2, 8, 2, 256, 256, 128, True, seg, seg,
                  " padding q tile and padding row")
    # dO with zero strides, as autograd hands it back for a loss such as
    # (out * w).sum(): TMA cannot describe it, so the wrapper copies it
    seg = _segs(rng, 2, 300)
    row = torch.tensor(rng.normal(size=128), dtype=torch.float32,
                       device="cuda").to(torch.bfloat16)
    _check_pa_bwd(rng, 2, 8, 2, 300, 300, 128, True, seg, seg,
                  " expanded dO", dout=row.expand(2, 8, 300, 128))
    _check_vlm_packed_attention_bwd(rng)
    _check_moe_packed_attention_bwd(rng)


def _check_vlm_packed_attention_bwd(rng):
    """paper-llama-12b's heads (MHA, 36 of 128) at s 1000, causal; and GQA
    group 8 at d 128 (32 q heads on 4 kv heads, the shape the dense family
    queues next), held against the float32 autograd oracle."""
    seg = _segs(rng, 2, 1000)
    _check_pa_bwd(rng, 2, 36, 36, 1000, 1000, 128, True, seg, seg,
                  f" {VLM_ARCH} heads")
    seg = _segs(rng, 2, 1000)
    _check_pa_bwd(rng, 2, 32, 4, 1000, 1000, 128, True, seg, seg,
                  " group 8", f32_oracle=True)


def _check_moe_packed_attention_bwd(rng):
    """granite-moe-3b-a800m's heads (24 on 8 of 64, group 3) at s 1000,
    causal."""
    seg = _segs(rng, 2, 1000)
    _check_pa_bwd(rng, 2, 24, 8, 1000, 1000, 64, True, seg, seg,
                  f" {GRANITE_ARCH} heads")


def _check_grad_guards():
    """Fault C1: under grad, the kernels with no backward raise on the card
    (before they build or launch anything), and so does ``wkv6`` asked for
    its final state, whose gradient the backward kernel does not take."""
    from repro_torch.kernels import ops
    x = torch.zeros((2, 4, 64, 16), device="cuda", requires_grad=True)
    seg = torch.ones((2, 64), dtype=torch.int32, device="cuda")
    reset = torch.zeros((2, 64), dtype=torch.bool, device="cuda")
    calls = {
        "packed_attention float32": lambda: ops.packed_attention(
            x, x, x, seg, seg),
        "decode_attention": lambda: ops.decode_attention(
            x[:, :, 0], x, x, torch.full((2,), 64, dtype=torch.int32,
                                         device="cuda")),
        "wkv6 return_state": lambda: ops.wkv6(
            x, x, x, x, x[0, 0, :4], reset, chunk=16, return_state=True),
    }
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "ROADMAP.md" not in str(e):
                raise
            log(f"[check] {name} under grad on the card raises: {e}")
            continue
        raise AssertionError(f"{name} under grad did not raise")


@contextlib.contextmanager
def _plain_attention():
    """The models' attention runs the plain version on the card inside this
    context (autograd differentiates it), for the kernels-vs-plain check."""
    from repro_torch.kernels import ops, ref
    kernel = ops.packed_attention
    ops.packed_attention = ref.packed_attention_ref
    try:
        yield
    finally:
        ops.packed_attention = kernel


def _check_full_width_grads(arch: str = ARCH, **cut):
    """``arch`` (qwen3-8b unless named) at full width with 2 layers (or the
    config fields ``cut`` gives), one packed batch of 2 x 1024: the loss
    and every leaf's gradient with the kernels against the plain attention
    on the same weights (relative L2 <= GRAD_REL_L2)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.train_step import init_train_state, make_loss_fn
    cfg = get_config(arch).replace(**(cut or {"num_layers": 2}))
    model = build_model(cfg, torch.Generator(device="cuda").manual_seed(5))
    state = init_train_state(model)
    rng = np.random.default_rng(5)
    batch = _card_batch(_packed_rows(rng, 2, TRAIN_SEQ, cfg.vocab_size))
    loss_fn = make_loss_fn(model)

    def run():
        total, _ = loss_fn(state.params, batch)
        total.backward()
        grads = {}
        for path, p in tree_leaves(state.params):
            grads[path], p.grad = p.grad, None
        return total.item(), grads

    _zero_launch_counts()
    loss_k, grads_k = run()
    counts = _launch_counts()
    if counts != _train_want(cfg, 1):
        raise AssertionError(f"{cfg.num_layers}-layer step launched {counts}")
    with _plain_attention():
        loss_p, grads_p = run()
    if _launch_counts() != counts:
        raise AssertionError("the plain run launched a kernel")
    rel = abs(loss_k - loss_p) / abs(loss_p)
    tag = f"{arch} {cut or '2 layers'} full width"
    log(f"[check] {tag}, kernels vs plain attention: "
        f"loss {loss_k:.6f} vs {loss_p:.6f} relative {rel:.3e} (limit "
        f"{LOSS_REL_TOL:g}) {'ok' if rel <= LOSS_REL_TOL else 'FAIL'}")
    worst = max(((torch.linalg.vector_norm(grads_k[n] - grads_p[n])
                  / torch.linalg.vector_norm(grads_p[n])).item(), n)
                for n in grads_p)
    log(f"[check] {tag}, kernels vs plain attention: "
        f"worst gradient relative L2 {worst[0]:.3e} ({worst[1]}; limit "
        f"{GRAD_REL_L2:g}) {'ok' if worst[0] <= GRAD_REL_L2 else 'FAIL'}")
    if rel > LOSS_REL_TOL or not worst[0] <= GRAD_REL_L2:
        raise AssertionError("full-width gradients disagree with the plain "
                             "path")


def _check_memorise(module: str = "qwen3_8b"):
    """A reduced config (qwen3-8b, head_dim 16, unless ``module`` names
    another) memorises one batch on the card through the kernels: the loss
    falls below 0.8x its first value in 12 steps (tests/test_train.py:
    50-66); a MoE config's aux losses are logged; an audio config's batch
    carries bf16 frame embeddings (the float32 attention kernel, which
    float32 ones would run the encoder on, has no backward)."""
    import importlib
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    cfg = importlib.import_module(f"repro_torch.configs.{module}").reduced()
    model = build_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    state = init_train_state(model)
    step = make_train_step(model, AdamWConfig(peak_lr=5e-3, warmup_steps=5,
                                              total_steps=100))
    seg = np.ones((4, 64), np.int32)       # make_lm_batch(cfg, 4, 64)
    seg[:, 30:60], seg[:, 60:] = 2, 0
    rng = np.random.default_rng(3)
    batch = _lm_batch(rng, cfg.vocab_size, seg)
    if cfg.family == "audio":
        batch["enc_embeds"] = _frames(rng, 4, cfg, torch.bfloat16)
    _zero_launch_counts()
    losses, auxes = [], []
    for _ in range(12):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
        auxes.append(metrics["aux_loss"].item())
    counts = _launch_counts()
    ok = (losses[-1] < 0.8 * losses[0] and np.isfinite(losses).all()
          and np.isfinite(auxes).all() and counts == _train_want(cfg, 12))
    aux = (f", aux losses {[round(x, 4) for x in auxes]}"
           if cfg.family == "moe" else "")
    log(f"[check] {cfg.name} memorises one batch on the card: losses "
        f"{[round(x, 4) for x in losses]}{aux}, launches {counts} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{cfg.name} did not memorise its batch "
                             "through the kernels")


# ------------------------------------------------- 3. rwkv training checks
def _wkv6_bwd_launch(args, dout, chunk: int):
    """The forward kernel on ``args``, keeping the states entering each
    chunk, then the backward kernel once: dr, dk, dv, dloga, du."""
    from repro_torch.kernels import wkv6, wkv6_bwd
    b, s, h, dk = args[0].shape
    states = torch.empty((b, h, -(-s // min(chunk, s)), dk, dk),
                         device="cuda")
    wkv6.wkv6(*args, chunk=chunk, chunk_states=states)
    return _launch(wkv6_bwd, wkv6_bwd.wkv6_bwd, *args, dout, states,
                   chunk=chunk)


WKV_GRADS = ("dr", "dk", "dv", "dloga", "du")


def _check_wkv6_grads(name: str, got, exp) -> float:
    """Each gradient against its plain or exact version at atol 5e-5 /
    rtol 5e-4, with the worst error as a share of atol + rtol |exp|
    logged; returns the largest max abs error."""
    err = 0.0
    for n, g, e in zip(WKV_GRADS, got, exp):
        log(f"[report] {name}, {n}: {_steep_distance(g, e.double())}")
        err = max(err, _check(f"{name}, {n}", g.to(e.dtype), e, *WKV_TOL))
    return err


def _wkv6_exact_grads(args, dout):
    """Autograd of the sequential ``ref.wkv6_ref`` in float64: the exact
    oracle of the gradients at any decay."""
    from repro_torch.kernels import ref
    with torch.enable_grad():
        leaves = [a.double().requires_grad_() for a in args[:5]]
        o = ref.wkv6_ref(*leaves, args[5].bool())
        return torch.autograd.grad(o, leaves, dout.double())


def _check_wkv6_bwd():
    """The wkv6 backward kernel against ``ref.wkv6_bwd_ref`` (autograd of
    ``ref.wkv6_chunked``, float32) at rwkv6-3b's training shape (4 x 1024,
    40 heads of 64, the data plane's documents: resets mid-chunk and
    padding rows, k zeroed on padding as the model zeroes it), at a ragged
    s, at dk 16 and 32 (resets on sub-chunk edges and mid-chunk, int32
    resets, strided inputs); bitwise equal over two calls at the training
    shape; against the float64 oracle (autograd of ``ref.wkv6_ref``) at
    the steep decays of ``_steep_wkv6_inputs``, where the float32 plain
    version's own distance is logged, not checked; and at chunk 40, whose
    last sub-chunk of 16 is ragged, against ``ref.wkv6_bwd_two_pass``."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(9)

    def dout_like(a):
        return torch.tensor(rng.normal(size=tuple(a.shape)),
                            dtype=torch.float32, device="cuda") * 0.5
    b, s, h, dk = TRAIN_BATCH, TRAIN_SEQ, 40, 64
    seg = _packed_rows(rng, b, s).segment_ids
    args = _wkv6_inputs(rng, b, s, h, dk, seg)
    dout = dout_like(args[0])
    name = f"wkv6_bwd b={b} s={s} h={h} dk={dk} chunk=64, data-plane rows"
    got = _wkv6_bwd_launch(args, dout, 64)
    _check_wkv6_grads(f"{name} vs wkv6_bwd_ref", got,
                      ref.wkv6_bwd_ref(*args, dout, chunk=64))
    again = _wkv6_bwd_launch(args, dout, 64)
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    log(f"[check] {name}: two calls bitwise equal: {same}")
    if not same:
        raise AssertionError("wkv6_bwd is not deterministic")
    del got, again
    # a ragged s: resets at row starts, mid-chunk segment starts, padding
    b, s = 2, 1000
    args = _wkv6_inputs(rng, b, s, h, dk, _segs(rng, b, s))
    dout = dout_like(args[0])
    _check_wkv6_grads(f"wkv6_bwd b={b} s={s} h={h} dk={dk} chunk=64 packed "
                      "vs wkv6_bwd_ref", _wkv6_bwd_launch(args, dout, 64),
                      ref.wkv6_bwd_ref(*args, dout, chunk=64))
    # dk 16 and 32: resets on sub-chunk edges and mid-chunk, a ragged last
    # chunk, int32 resets, (b, h, s, dk) buffers seen as (b, s, h, dk)
    edges = [(0, 16), (0, 96), (0, 107), (1, 48), (1, 69)]
    for dk, chunk, s in [(16, 16, 192), (32, 32, 192), (32, 64, 200),
                         (16, 64, 40)]:
        b, h = 2, 3
        args = _wkv6_inputs(rng, b, s, h, dk, scale=1.0)
        for row, t in edges:
            if t < s:
                args[5][row, t] = True
        if dk == 32:
            args = tuple(a.transpose(1, 2).contiguous().transpose(1, 2)
                         for a in args[:4]) + args[4:]
        if chunk == 16:
            args = args[:5] + (args[5].to(torch.int32),)
        dout = dout_like(args[0])
        name = f"wkv6_bwd b={b} s={s} h={h} dk={dk} chunk={chunk}"
        got = _wkv6_bwd_launch(args, dout, chunk)
        _check_wkv6_grads(f"{name} vs wkv6_bwd_ref", got,
                          ref.wkv6_bwd_ref(*args, dout, chunk=chunk))
        _check_wkv6_grads(f"{name} vs float64 autograd of wkv6_ref", got,
                          _wkv6_exact_grads(args, dout))
    # steep decays at the serve shape, against the float64 oracle
    for scale in (1.5, 2.5):
        args = _steep_wkv6_inputs(scale)
        dout = dout_like(args[0])
        exact = _wkv6_exact_grads(args, dout)
        name = f"wkv6_bwd serve shape, loga scale {scale}"
        _check_wkv6_grads(f"{name} vs float64 autograd of wkv6_ref",
                          _wkv6_bwd_launch(args, dout, 64), exact)
        plain = ref.wkv6_bwd_ref(*args, dout, chunk=64)
        for n, g, e in zip(WKV_GRADS, plain, exact):
            log(f"[report] {name}, plain wkv6_bwd_ref vs float64 oracle, "
                f"{n}: {_steep_distance(g, e)}")
        del exact, plain
    # chunk 40: sub-chunks of 16 leave the chunk's last one ragged; a
    # ragged s, resets on sub-chunk edges; against the kernel's
    # decomposition in plain PyTorch on the card
    b, s, h, dk, chunk = 2, 230, 3, 64, 40
    args = _wkv6_inputs(rng, b, s, h, dk, scale=1.0)
    for row, t in [(0, 16), (0, 72), (1, 120), (1, 159)]:
        args[5][row, t] = True
    dout = dout_like(args[0])
    _check_wkv6_grads(f"wkv6_bwd b={b} s={s} h={h} dk={dk} chunk={chunk} "
                      "vs wkv6_bwd_two_pass",
                      _wkv6_bwd_launch(args, dout, chunk),
                      ref.wkv6_bwd_two_pass(*args, dout, chunk=chunk)[:5])


def _check_wkv6_autograd():
    """``ops.wkv6`` under grad on the card goes through the forward and the
    backward kernel (one launch each) and its gradients are
    ``ref.wkv6_bwd_ref``'s."""
    from repro_torch.kernels import ops, ref, wkv6, wkv6_bwd
    rng = np.random.default_rng(10)
    b, s, h, dk = 2, 256, 8, 64
    args = _wkv6_inputs(rng, b, s, h, dk, _segs(rng, b, s))
    dout = torch.tensor(rng.normal(size=(b, s, h, dk)), dtype=torch.float32,
                        device="cuda")
    leaves = [a.detach().requires_grad_() for a in args[:5]]
    before = (wkv6.launches, wkv6_bwd.launches)
    o = ops.wkv6(*leaves, args[5], chunk=64)
    o.backward(dout)
    torch.cuda.synchronize()
    if (wkv6.launches, wkv6_bwd.launches) != (before[0] + 1, before[1] + 1):
        raise AssertionError("ops.wkv6 under grad did not launch the forward "
                             "and the backward kernel once each")
    _check_wkv6_grads(f"ops.wkv6 autograd b={b} s={s} h={h} dk={dk} vs "
                      "wkv6_bwd_ref", [t.grad for t in leaves],
                      ref.wkv6_bwd_ref(*args, dout, chunk=64))


def _check_rwkv_first_step():
    """Reduced rwkv6-3b's first training step on the card through the wkv6
    kernels against the same step on the CPU (plain ``wkv6_chunked`` under
    autograd), same weights, the zero-initialised LoRA up-projections given
    small random values so the data-dependent decay is live: the loss to a
    relative LOSS_REL_TOL and every leaf's gradient to a relative L2 of
    GRAD_REL_L2 (bf16 compute on both)."""
    from repro_torch.configs.rwkv6_3b import reduced
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.train_step import init_train_state, make_loss_fn
    cfg = reduced()
    gen = torch.Generator(device="cuda").manual_seed(3)
    gpu = build_model(cfg, gen)
    for name, prm in gpu.named_parameters():
        if ".mixB_" in name or name.endswith("loraB_w"):
            prm.data.normal_(0.0, 0.1, generator=gen)
    cpu = build_model(cfg, torch.Generator().manual_seed(3))
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    seg = np.ones((4, 64), np.int32)
    seg[:, 30:60], seg[:, 60:] = 2, 0
    seg[1, 9:] = 3
    batch = _lm_batch(np.random.default_rng(3), cfg.vocab_size, seg,
                      next_token=True)
    runs = []
    for m in (gpu, cpu):
        state = init_train_state(m)
        _zero_launch_counts()
        total, _ = make_loss_fn(m)(state.params,
                                   {k: v.to(m.device) for k, v in
                                    batch.items()})
        total.backward()
        torch.cuda.synchronize()
        runs.append((total.item(), {p: t.grad.float().cpu() for p, t in
                                    tree_leaves(state.params)},
                     _launch_counts()))
    (loss_k, grads_k, counts), (loss_c, grads_c, cpu_counts) = runs
    if counts != _train_want(cfg, 1) or cpu_counts != _want():
        raise AssertionError(f"first step launched {counts} on the card, "
                             f"{cpu_counts} on the CPU")
    rel = abs(loss_k - loss_c) / abs(loss_c)
    worst = max(((torch.linalg.vector_norm(grads_k[n] - grads_c[n])
                  / torch.linalg.vector_norm(grads_c[n])).item(), n)
                for n in grads_c)
    ok = rel <= LOSS_REL_TOL and worst[0] <= GRAD_REL_L2
    log(f"[check] reduced rwkv6-3b first step, card (kernels) vs CPU "
        f"(plain): loss {loss_k:.6f} vs {loss_c:.6f} relative {rel:.3e} "
        f"(limit {LOSS_REL_TOL:g}); worst gradient relative L2 "
        f"{worst[0]:.3e} ({worst[1]}; limit {GRAD_REL_L2:g}); launches "
        f"{counts} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("reduced rwkv6-3b's first step on the card "
                             "disagrees with the CPU's")


def phase_check_rwkv_train():
    _check_wkv6_bwd()
    _check_wkv6_autograd()
    _check_grad_guards()
    torch.cuda.empty_cache()
    _check_rwkv_first_step()
    _check_memorise("rwkv6_3b")


def phase_check_train():
    _check_packed_attention_bwd()
    _check_grad_guards()
    _check_full_width_grads()
    torch.cuda.empty_cache()
    _check_memorise()


def _check_moe_block_determinism():
    """qwen3-moe-30b-a3b's MoE block at full width on 4 x 1024 bf16 tokens
    (capacity 80 a row, the overflow slot written by every dropped pair):
    out, aux and the gradients of x and of every leaf bitwise equal over
    two calls."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.params import init_param
    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(6)
    bf = torch.bfloat16
    # the train step's compute copy: every stacked leaf, the router too, bf16
    p = {n: init_param(d, gen, torch.float32, "cuda").to(bf).requires_grad_()
         for n, d in sorted(moe.moe_def(cfg).items())}
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), generator=gen,
                    device="cuda").to(bf).requires_grad_()
    dout = torch.randn(x.shape, generator=gen, device="cuda").to(bf)
    C = moe.row_capacity(cfg, TRAIN_SEQ)

    def run():
        out, aux = moe.moe_block(p, cfg, x)
        ((out.float() * dout.float()).sum() + aux).backward()
        got = [out.detach(), aux.detach(), x.grad] + [p[n].grad for n in p]
        x.grad = None
        for t in p.values():
            t.grad = None
        return got
    first, second = run(), run()
    same = [torch.equal(a, b) for a, b in zip(first, second)]
    with torch.no_grad():
        _, _, ids = moe.route(p["router"], cfg, x)
        dropped = int((moe.slots(ids, cfg.num_experts, C) == C).sum())
    log(f"[check] {MOE_ARCH} MoE block, full width, {TRAIN_BATCH}x"
        f"{TRAIN_SEQ} bf16, capacity {C}: {dropped} of {ids.numel()} "
        f"(token, expert) pairs dropped; out, aux and the gradients of x, "
        f"{', '.join(p)} bitwise equal over two calls: {same} "
        f"{'ok' if all(same) else 'FAIL'}")
    if not all(same):
        raise AssertionError("the MoE block is not deterministic")


@contextlib.contextmanager
def _recorded_routing():
    """The port's MoE top-k records each call's expert ids, in call order,
    inside this context."""
    from repro_torch.models import moe
    own, ids = moe.top_k, []

    def recording(probs, k):
        vals, idx = own(probs, k)
        ids.append(idx)
        return vals, idx
    moe.top_k = recording
    try:
        yield ids
    finally:
        moe.top_k = own


@contextlib.contextmanager
def _forced_routing(ids: list):
    """The port's MoE top-k takes ``ids`` (one tensor a call, in order)
    in place of its own inside this context, and the weights at them; the
    yielded list gets, a call, the tokens its own top-k would have sent
    elsewhere."""
    from repro_torch.models import moe
    own, queue, moved = moe.top_k, list(ids), []

    def forced(probs, k):
        idx = queue.pop(0)
        mine = own(probs, k)[1]
        moved.append(int((mine.sort(-1)[0] != idx.sort(-1)[0]).any(-1).sum()))
        return torch.gather(probs, -1, idx), idx
    moe.top_k = forced
    try:
        yield moved
    finally:
        moe.top_k = own


def _check_moe_full_width_grads():
    """qwen3-moe-30b-a3b at full width with 2 layers, one packed batch of
    2 x 1024: the loss and every leaf's gradient with the kernels against
    the plain attention on the same weights, the plain run routed as the
    kernel run (a bf16 rounding of attention flips near-tied experts of a
    few tokens a layer, which would move whole expert outputs); how many
    tokens its own top-k would have moved is logged."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.train_step import init_train_state, make_loss_fn
    cfg = get_config(MOE_ARCH).replace(num_layers=2)
    model = build_model(cfg, torch.Generator(device="cuda").manual_seed(5))
    state = init_train_state(model)
    rng = np.random.default_rng(5)
    batch = _card_batch(_packed_rows(rng, 2, TRAIN_SEQ, cfg.vocab_size))
    loss_fn = make_loss_fn(model)

    def run():
        total, _ = loss_fn(state.params, batch)
        total.backward()
        grads = {}
        for path, p in tree_leaves(state.params):
            grads[path], p.grad = p.grad, None
        return total.item(), grads

    _zero_launch_counts()
    with _recorded_routing() as ids:
        loss_k, grads_k = run()
    counts = _launch_counts()
    if counts != _train_want(cfg, 1):
        raise AssertionError(f"2-layer step launched {counts}")
    with _plain_attention(), _forced_routing(ids) as moved:
        loss_p, grads_p = run()
    if _launch_counts() != counts:
        raise AssertionError("the plain run launched a kernel")
    tag = f"{MOE_ARCH} 2 layers full width, kernels vs plain attention"
    log(f"[check] {tag}: the plain run routed as the kernel run; its own "
        f"top-k would have moved {moved} of {batch['tokens'].numel()} "
        "tokens a call (each layer's forward, then its recompute)")
    rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"[check] {tag}: loss {loss_k:.6f} vs {loss_p:.6f} relative "
        f"{rel:.3e} (limit {LOSS_REL_TOL:g}) "
        f"{'ok' if rel <= LOSS_REL_TOL else 'FAIL'}")
    worst = max(((torch.linalg.vector_norm(grads_k[n] - grads_p[n])
                  / torch.linalg.vector_norm(grads_p[n])).item(), n)
                for n in grads_p)
    log(f"[check] {tag}: worst gradient relative L2 {worst[0]:.3e} "
        f"({worst[1]}; limit {GRAD_REL_L2:g}) "
        f"{'ok' if worst[0] <= GRAD_REL_L2 else 'FAIL'}")
    if rel > LOSS_REL_TOL or not worst[0] <= GRAD_REL_L2:
        raise AssertionError("full-width MoE gradients disagree with the "
                             "plain path")


def phase_check_moe():
    """The MoE family's checks: the block's determinism at full width,
    2 full-width qwen3-moe-30b-a3b layers against plain attention, reduced
    qwen3-moe-30b-a3b on the card against the CPU, and memorising a
    batch."""
    import gc
    _check_moe_block_determinism()
    _check_moe_full_width_grads()
    gc.collect()
    torch.cuda.empty_cache()
    _check_reduced_slice("qwen3_moe_30b_a3b")
    _check_memorise("qwen3_moe_30b_a3b")


# ------------------------------------------------ 3. dense family checks
def _check_dense_attention():
    """The attention kernels at the heads the rest of the dense family
    brings, before any of them serves or trains, at s 1000 with packed
    segments (the backward against the float32 autograd oracle) and on the
    serve cache's length with ragged cache lengths: qwen3-32b's 64 q heads
    on 8 kv heads of 80 (the bf16 forward's d-80 instance; the backward's
    d 80 through its 128-wide instance, whose second 64-column TMA box
    holds 16 real columns and zeros; flash_decode at d 80), granite-20b's
    48 q heads on one kv head of 128 (MQA, GQA group 48: the backward's dK
    and dV sum 48 heads, held as ``_check_long_group_bwd`` holds them;
    flash_decode's 6 group chunks of 8 heads), and
    yi-9b's 32 on 4 of 128 (the forward; its backward and flash_decode at
    group 8 and d 128 are the vlm and MoE checks')."""
    rng = np.random.default_rng(14)
    S = PROMPT + GEN
    for arch, h, kh, d in ((QWEN32_ARCH, 64, 8, 80),
                           (GRANITE20_ARCH, 48, 1, 128)):
        what = f" {arch} heads"
        for dt in TOL:
            seg = _segs(rng, 2, 1000)
            _check_pa(rng, 2, h, kh, 1000, 1000, d, dt, True, seg, seg, what)
        seg = _segs(rng, 2, 1000)
        if kh == 1:     # one kv head: the rows' padding becomes a segment
            for row in seg:
                row[row == 0] = row.max() + 1
        _check_pa_bwd(rng, 2, h, kh, 1000, 1000, d, True, seg, seg, what,
                      f32_oracle=True, long_group=kh == 1)
        _check_fd(rng, BATCH, h, kh, S, d, _edge_lens(BATCH, h, kh, S))
    for dt in TOL:
        seg = _segs(rng, 2, 1000)
        _check_pa(rng, 2, 32, 4, 1000, 1000, 128, dt, True, seg, seg,
                  f" {YI_ARCH} heads")


def _time_granite_bwd():
    """The backward kernel at granite-20b's heads (one kv head under 48 q
    heads: each dK/dV CTA sums 48 heads) at the training shape, on the
    data plane's documents, beside SDPA's backward; logged, not a record
    (no granite-20b training path runs)."""
    from repro_torch.configs import get_config
    seg = _packed_rows(np.random.default_rng(TRAIN_SEED), TRAIN_BATCH,
                       TRAIN_SEQ).segment_ids
    rec = _time_packed_attention_bwd(get_config(GRANITE20_ARCH), None, seg)
    log(f"[time] packed_attention_bwd at {GRANITE20_ARCH}'s heads (48 on 1 "
        f"of 128), {TRAIN_BATCH} x {TRAIN_SEQ}: ms={rec['ms']:.4f} "
        f"plain_ms={rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f} "
        f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']})")


def phase_check_dense():
    """The dense family's card checks: the attention kernels at the new
    heads, the backward's time at granite-20b's, each reduced config's
    prefill and decode on the card against the CPU, and 2 full-width
    qwen3-32b layers' loss and gradients, kernels (the backward at d 80)
    against plain attention."""
    import gc
    _check_dense_attention()
    _time_granite_bwd()
    for module in ("yi_9b", "granite_20b", "qwen3_32b"):
        _check_reduced_slice(module)
    gc.collect()
    torch.cuda.empty_cache()
    _check_full_width_grads(QWEN32_ARCH)
    gc.collect()
    torch.cuda.empty_cache()


# -------------------------------------------- 3. hybrid and audio checks
def _frames(rng, b: int, cfg, dtype) -> torch.Tensor:
    """(b, encoder_frames, d_model) stub frame embeddings on the card, at
    the serve launcher's scale (normal x 0.02), in ``dtype``."""
    x = rng.normal(size=(b, cfg.encoder_frames, cfg.d_model)) * 0.02
    return torch.tensor(x, dtype=torch.float32, device="cuda").to(dtype)


def _check_hybrid_attention():
    """The attention kernels at zamba2-7b's heads (32 on 32 of 112: a head
    dim no other cell runs, through the forward's and the backward's
    128-wide instances with 16 zero columns, over rows of 224 B) before any
    zamba2 phase: the forward in both dtypes at s 1000 with packed
    segments, at ragged tails (1, 63, 65 rows), on short segments, at its
    serve shape (4 x 512, one segment a row) and at its training shape (4 x
    1024, the data plane's documents); the backward at s 1000, a ragged
    tail, short segments and the training shape; flash_decode on its
    serve cache's length with ragged lengths."""
    rng = np.random.default_rng(25)
    bf, h, d, what = torch.bfloat16, 32, 112, f" {ZAMBA_ARCH} heads"
    short = np.repeat(np.arange(1, 301), rng.integers(3, 40, 300))[:300]
    short = np.stack([short, short]).astype(np.int32)
    serve = np.ones((BATCH, PROMPT), np.int32)
    train = _packed_rows(rng, TRAIN_BATCH, TRAIN_SEQ).segment_ids
    for dt in TOL:
        seg = _segs(rng, 2, 1000)
        _check_pa(rng, 2, h, h, 1000, 1000, d, dt, True, seg, seg, what)
        _check_pa(rng, BATCH, h, h, PROMPT, PROMPT, d, dt, True, serve,
                  serve, what + ", serve shape")
    for s in (1, 63, 65):
        seg = _segs(rng, 2, s) if s > 16 else np.ones((2, s), np.int32)
        _check_pa(rng, 2, h, h, s, s, d, bf, True, seg, seg, what)
    _check_pa(rng, 2, h, h, 300, 300, d, bf, True, short, short,
              what + ", short segments")
    _check_pa(rng, TRAIN_BATCH, h, h, TRAIN_SEQ, TRAIN_SEQ, d, bf, True,
              train, train, what + ", training shape")
    for seg in (_segs(rng, 2, 1000), _segs(rng, 2, 65), short):
        s = seg.shape[1]
        _check_pa_bwd(rng, 2, h, h, s, s, d, True, seg, seg, what)
    _check_pa_bwd(rng, TRAIN_BATCH, h, h, TRAIN_SEQ, TRAIN_SEQ, d, True,
                  train, train, what + ", training shape")
    S = PROMPT + GEN
    _check_fd(rng, BATCH, h, h, S, d, _edge_lens(BATCH, h, h, S))


def _check_audio_attention():
    """The attention kernels at whisper-medium's shapes (16 on 16 heads of
    64, every segment id 1) before any Whisper phase: the encoder's
    non-causal self-attention over 1500 frames (23 tiles of 64 and a
    ragged 28) in float32 (the served encoder's) and bf16 (training's),
    and the decoder's cross-attention, 512 (serve) and 1024 (training)
    queries against the 1500 frames, non-causal, forward in both dtypes
    and backward; flash_decode on a (layers, b, 1500, kh, hd) cross cache
    read by strides, full and at edge lengths."""
    from repro_torch.configs import get_config
    rng = np.random.default_rng(26)
    F_ = get_config(WHISPER_ARCH).encoder_frames
    b, h, d = BATCH, 16, 64

    def ones(s):
        return np.ones((b, s), np.int32)
    for sq in (F_, PROMPT, TRAIN_SEQ):
        what = " whisper encoder" if sq == F_ else " whisper cross-attention"
        for dt in TOL:
            _check_pa(rng, b, h, h, sq, F_, d, dt, False, ones(sq), ones(F_),
                      what)
        _check_pa_bwd(rng, b, h, h, sq, F_, d, False, ones(sq), ones(F_),
                      what)
    _check_fd(rng, b, h, h, F_, d, [F_] * b)
    _check_fd(rng, b, h, h, F_, d, _edge_lens(b, h, h, F_))


def _positions(seg: np.ndarray) -> np.ndarray:
    """Positions restarting at every segment (0 on padding)."""
    pos = np.zeros_like(seg)
    for i, row in enumerate(seg):
        for sid in np.unique(row[row > 0]):
            idx = np.flatnonzero(row == sid)
            pos[i, idx] = np.arange(len(idx))
    return pos


def _check_reduced_family(module: str, seed: int):
    """A reduced zamba2-7b or whisper-medium, float32, with the kernels on
    the card against the plain versions on the CPU, same weights (and
    frame embeddings): the forward on a packed batch (two segments and
    padding); the prefill's logits and every cache leaf (the Mamba2 states,
    the k/v of the shared block or of Whisper's self- and
    cross-attention); the prompt replayed through ``decode_step`` on a
    fresh cache, as the serve flow runs it, and 8 greedy tokens (the CPU
    is fed the card's tokens, and its own argmax must pick them).  For
    Whisper also 8 decode steps against the prefill's own cross cache, which
    the serve flow never reads (ROADMAP C5), held to the CPU's and, on the
    card, to the forward over the same tokens at the bf16 tolerance (the
    cross cache is bf16).  Logits and float32 leaves to 2e-3, bf16 leaves
    to the bf16 tolerance."""
    import importlib
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import tree_leaves
    cfg = importlib.import_module(f"repro_torch.configs.{module}").reduced()
    gpu = build_model(cfg, torch.Generator(device="cuda").manual_seed(seed))
    cpu = build_model(cfg, torch.Generator().manual_seed(seed))
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(seed)
    b, s, gen = 2, 32, 8
    audio = cfg.family == "audio"
    tokens = rng.integers(1, cfg.vocab_size, (b, s))
    packed = np.ones((b, s), np.int32)
    packed[:, 20:], packed[:, -3:] = 2, 0
    frames = _frames(rng, b, cfg, torch.float32) if audio else None
    outs, greedy = {}, None
    with torch.no_grad():
        for name, m in (("card", gpu), ("CPU", cpu)):
            dev = m.device

            def batch(seg, toks=tokens):
                out = {k: torch.as_tensor(v, dtype=torch.int32, device=dev)
                       for k, v in (("tokens", toks), ("segment_ids", seg),
                                    ("positions", _positions(seg)))}
                if audio:
                    out["enc_embeds"] = frames.to(dev)
                return out
            got = {"forward on a packed batch": m(batch(packed))[0]}
            one = np.ones((b, s), np.int32)
            got["prefill logits"], cache = m.prefill(batch(one))
            got.update((f"prefill cache {path}", t)
                       for path, t in tree_leaves(cache) if t.numel())
            dec = m.init_cache(b, s + gen, torch.float32)
            toks = batch(one)["tokens"]
            for t in range(s):
                logits, dec = m.decode_step(dec, toks[:, t:t + 1], t)
            steps, picked = [logits], []
            for t in range(s, s + gen):
                picked.append(torch.argmax(logits[:, -1:], -1).to(
                    torch.int32).cpu())
                feed = picked[-1] if greedy is None \
                    else greedy[:, t - s:t - s + 1]
                logits, dec = m.decode_step(dec, feed.to(dev), t)
                steps.append(logits)
            got["prompt replay + greedy decode logits"] = torch.cat(steps, 1)
            picked = torch.cat(picked, 1)
            if greedy is None:
                greedy = picked
            elif not torch.equal(picked, greedy):
                raise AssertionError(f"reduced {cfg.name}: greedy tokens "
                                     f"{picked.tolist()} on the CPU, "
                                     f"{greedy.tolist()} on the card")
            if audio:
                real = m.init_cache(b, s + gen, torch.float32)
                for n in ("k", "v"):
                    real[n][:, :, :s] = cache[n]
                for n in ("cross_k", "cross_v"):
                    real[n].copy_(cache[n])
                steps = []
                for t in range(s, s + gen):
                    logits, real = m.decode_step(
                        real, greedy[:, t - s:t - s + 1].to(dev), t)
                    steps.append(logits)
                key = "decode against the prefill's cross cache"
                got[key] = torch.cat(steps, 1)
                if name == "card":
                    full = batch(np.ones((b, s + gen), np.int32),
                                 np.concatenate([tokens, greedy.numpy()], 1))
                    _check(f"reduced {cfg.name} on the card: {key} vs the "
                           "forward over the same tokens",
                           got[key], m(full)[0][:, s:],
                           TOL[torch.bfloat16])
            outs[name] = {k: v.cpu() for k, v in got.items()}
    for key, got in outs["card"].items():
        _check(f"reduced {cfg.name}, card vs CPU plain: {key}", got,
               outs["CPU"][key], TOL[torch.bfloat16]
               if got.dtype == torch.bfloat16 else 2e-3)
    log(f"[check] reduced {cfg.name}: greedy tokens {greedy.tolist()} on "
        "the card and the CPU")


def phase_check_hybrid():
    """The hybrid's card checks: the attention kernels at zamba2-7b's heads,
    reduced zamba2-7b on the card against the CPU, 2 full-width layers
    (attn_every 1: a Mamba2 layer then the shared block, twice, so its
    gradient sums two backward launches) against plain attention, and
    reduced zamba2-7b memorising one batch."""
    import gc
    _check_hybrid_attention()
    _check_reduced_family("zamba2_7b", 8)
    gc.collect()
    torch.cuda.empty_cache()
    _check_full_width_grads(ZAMBA_ARCH, num_layers=2, attn_every=1)
    gc.collect()
    torch.cuda.empty_cache()
    _check_memorise("zamba2_7b")


def phase_check_audio():
    """The audio family's card checks: the attention kernels at
    whisper-medium's shapes, reduced whisper-medium on the card against
    the CPU (decode against the prefill's cross cache included), and
    reduced whisper-medium memorising one batch."""
    _check_audio_attention()
    _check_reduced_family("whisper_medium", 9)
    torch.cuda.empty_cache()
    _check_memorise("whisper_medium")


# ------------------------------------------------------------- 4. serve
KERNEL_NAMES = ("packed_attention", "packed_attention_bwd", "flash_decode",
                "wkv6", "wkv6_bwd")


def _kernel_modules() -> dict:
    import importlib
    return {n: importlib.import_module(f"repro_torch.kernels.{n}")
            for n in KERNEL_NAMES}


def _launch_counts() -> dict:
    return {n: m.launches for n, m in _kernel_modules().items()}


def _zero_launch_counts():
    for m in _kernel_modules().values():
        m.launches = 0


def _want(**counts) -> dict:
    """Every kernel's expected count on a path: ``counts``, else 0."""
    return {n: counts.get(n, 0) for n in KERNEL_NAMES}


def _attention_calls(cfg) -> tuple[int, int]:
    """(attention calls of one forward or prefill, of one decode step) of
    ``cfg``: a layer's each, the hybrid's shared block once a block, and
    Whisper's encoder layers and its decoder layers' self- and
    cross-attention (decode: the decoder's two)."""
    if cfg.family == "hybrid":
        n = cfg.num_layers // cfg.attn_every
        return n, n
    if cfg.family == "audio":
        return cfg.encoder_layers + 2 * cfg.num_layers, 2 * cfg.num_layers
    return cfg.num_layers, cfg.num_layers


def _train_want(cfg, steps: int) -> dict:
    """The counts of ``steps`` training steps of ``cfg``: its backward
    kernel once an attention call (a layer's WKV for the ssm family) a
    step, and its forward kernel once more in the backward's recompute
    unless ``cfg.remat`` is ``"none"`` (every attention call and WKV of a
    training forward lies inside a checkpoint, and each checkpoint saves a
    tensor after it, so its recompute reaches it)."""
    fwd = 1 if cfg.remat == "none" else 2
    if cfg.family == "ssm":
        n = cfg.num_layers * steps
        return _want(wkv6=fwd * n, wkv6_bwd=n)
    n = _attention_calls(cfg)[0] * steps
    return _want(packed_attention=fwd * n, packed_attention_bwd=n)


def phase_serve(arch: str, prompt: int = CUT_PROMPT) -> tuple[dict, dict]:
    """Serve ``arch`` at full width and depth through ``serve.main`` on
    ``BATCH`` prompts of ``prompt`` tokens, with every kernel's count set
    to 0 just before and read just after; its peak beside the bytes of the
    served weights."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model_zoo import model_defs
    from repro_torch.models.params import param_bytes
    from repro_torch.train.train_step import COMPUTE_DTYPE
    cfg = get_config(arch)
    weights = param_bytes(model_defs(cfg), COMPUTE_DTYPE)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t0 = time.perf_counter()
    out = serve.main(["--arch", arch, "--batch", str(BATCH),
                      "--prompt-len", str(prompt), "--gen", str(GEN)])
    counts = _launch_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] {arch} layers={cfg.num_layers} d_model={cfg.d_model} "
        f"batch={BATCH} prompt={prompt} gen={GEN} ({wall:.1f}s in serve, "
        "weights drawn included)")
    log(f"[serve] {arch} prefill_s={out['prefill_s']:.4f} "
        f"decode_tok_s={out['decode_tok_s']:.2f} "
        f"(decode_s={out['decode_s']:.4f} for {GEN} steps x {BATCH} seqs) "
        f"max_memory_allocated={peak} B ({peak / 2**30:.2f} GiB), served "
        f"weights {weights} B ({weights / 2**30:.2f} GiB)")
    log(f"[serve] {arch} greedy tokens: {out['tokens'].tolist()}")
    log(f"[serve] {arch} launches on the path: {counts}")
    held = sum(p.numel() * p.element_size()
               for p in out["model"].parameters())
    if held != weights:
        raise AssertionError(f"the served model holds {held} B of weights, "
                             f"not the {weights} B of its bf16 tree")
    if cfg.family == "ssm":     # the WKV kernel once per layer, in prefill
        want = _want(wkv6=cfg.num_layers)
    else:
        pre, dec = _attention_calls(cfg)
        want = _want(packed_attention=pre, flash_decode=dec * (prompt + GEN))
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != expected {want}")
    for key in ("prefill_logits", "logits"):
        if not torch.isfinite(out[key].float()).all():
            raise AssertionError(f"serve {key} not finite")
    if out["tokens"].shape != (BATCH, GEN) or not (
            (out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all():
        raise AssertionError(f"bad greedy tokens {out['tokens'].shape}")
    if cfg.family == "vlm":
        _check_image_fusion(arch, out)
    return counts, out


def _prompt(served: dict) -> int:
    """The prompt length of a serve run."""
    return served["batch"]["tokens"].shape[1]


def _check_image_fusion(arch: str, out: dict):
    """The serve run's prompt carried image embeddings: its prefill logits
    must move when the same prompt is prefilled without them (the launch
    made here is after the path's counts were read)."""
    batch = out["batch"]
    n = batch["image_embeds"].shape[1]
    text = {k: batch[k] for k in ("tokens", "segment_ids", "positions")}
    logits, _ = out["prefill"](text)
    moved = (logits.float() - out["prefill_logits"].float()).abs().max()
    log(f"[serve] {arch}: {n} of {_prompt(out)} positions a row under image "
        f"embeddings (positions 0..{n - 1}); without them the prefill's last "
        f"logits move by max {moved.item():.4e}")
    if not moved > 0:
        raise AssertionError(f"{arch}: the image embeddings changed nothing")


# -------------------------------------------------------------- 7. time
def _time_ms(fn, arg_sets, iters: int) -> tuple[float, float]:
    """Mean ms per call over ``iters`` calls cycling through ``arg_sets``
    (distinct buffers, so the 50 MB L2 holds none of them between calls).

    Returns (device ms, eager ms).  Device ms times a replay of the calls
    captured in one CUDA graph, so host work between launches is not
    counted; eager ms times the same calls issued from Python, host
    overhead included, as the serve loop issues them.
    """
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    eager = start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, eager


def _time_eager_ms(fn, arg_sets, iters: int) -> float:
    """Mean ms per call of ``fn`` issued from Python, by CUDA events, for a
    call that cannot be captured in a CUDA graph (autograd's backward)."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start, end = _events(), _events()
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _time_packed_attention(cfg, launches: int,
                           train_seg: np.ndarray | None = None) -> dict:
    """At the serve shape (BATCH x PROMPT, one segment a row), or on a
    training batch's segment ids ``train_seg`` (causal, as the training
    forward runs it)."""
    import torch.nn.functional as F
    from repro_torch.kernels import packed_attention, ref
    h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    dt = torch.bfloat16
    rng = np.random.default_rng(2)
    if train_seg is None:
        b, s = BATCH, PROMPT
        seg = torch.ones((b, s), dtype=torch.int32, device="cuda")  # serve's
        pairs = b * h * s * (s + 1) // 2   # one segment per row, causal
        shape = "serve shape"
    else:
        b, s = train_seg.shape
        seg = torch.as_tensor(train_seg, device="cuda")
        pairs = sum(int(n) * (int(n) + 1) // 2 for row in train_seg
                    for n in np.bincount(row[row > 0])[1:]) * h
        shape = "training shape"
    sets = [(_bshd(rng, b, s, h, d, dt), _bshd(rng, b, s, kh, d, dt),
             _bshd(rng, b, s, kh, d, dt), seg, seg) for _ in range(4)]
    q, k, v = sets[0][:3]
    got = packed_attention.packed_attention(q, k, v, seg, seg)
    err = _check(f"packed_attention {shape}", got,
                 ref.packed_attention_ref(q, k, v, seg, seg), TOL[dt])
    ms = _time_ms(packed_attention.packed_attention, sets, 40)
    plain_ms = _time_ms(ref.packed_attention_ref, sets, 10)
    # padding rows attend to padding keys here, so no row is empty (an empty
    # row would make SDPA's softmax NaN)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device="cuda"))
    mask = mask[None, None] & (seg[:, None, :, None] == seg[:, None, None, :])

    def library(q, k, v, *_):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    lib_ms = _time_ms(library, sets, 40)
    flops = 4 * d * pairs
    nbytes = _nbytes(q, k, v, got, seg, seg)
    return _record("packed_attention", "packed_attention.cu",
                   "src/repro/kernels/packed_attention.py:122", launches,
                   err, ms, plain_ms, lib_ms, nbytes, flops, PEAK_FLOPS[dt])


def _time_flash_decode(cfg, launches: int, S: int = PROMPT + GEN,
                       layers: int | None = None) -> dict:
    """At the serve cache's length S (the final decode step attends to all
    of it), one call a layer of a (layers, b, S, kh, d) float32 cache, each
    layer's slice read by strides; ``layers`` defaults to the attention
    calls of a decode step."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode, ref
    b, h, kh, d = BATCH, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim()
    layers = layers or _attention_calls(cfg)[1]
    gen = torch.Generator(device="cuda").manual_seed(3)
    shape = (layers, b, S, kh, d)           # the serve cache, float32
    kc = torch.randn(shape, generator=gen, device="cuda")
    vc = torch.randn(shape, generator=gen, device="cuda")
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    clen = torch.full((b,), S, dtype=torch.int32, device="cuda")
    sets = [(q, kc[i].transpose(1, 2), vc[i].transpose(1, 2), clen)
            for i in range(layers)]           # one layer's slice per call
    got = flash_decode.flash_decode(*sets[0])
    err = _check(f"flash_decode serve shape cache_len={clen.tolist()}", got,
                 ref.flash_decode_ref(*sets[0]), SERVE_DECODE_TOL)
    ragged = clen.clone()
    ragged[1] = 300
    err = max(err, _check(
        f"flash_decode serve shape cache_len={ragged.tolist()}",
        flash_decode.flash_decode(*sets[0][:3], ragged),
        ref.flash_decode_ref(*sets[0][:3], ragged), SERVE_DECODE_TOL))
    ms = _time_ms(flash_decode.flash_decode, sets, 360)
    plain_ms = _time_ms(ref.flash_decode_ref, sets, 72)
    mask = (torch.arange(S, device="cuda") < clen[:, None])[:, None, None]
    q32 = q.float()[:, :, None]   # SDPA needs one dtype: q upcast once

    def library(q, k, v, _):
        return F.scaled_dot_product_attention(q32, k, v, attn_mask=mask,
                                              enable_gqa=True)
    lib_ms = _time_ms(library, sets, 360)
    flops = 4 * d * b * h * S
    nbytes = _nbytes(q, got, clen) + 2 * b * kh * S * d * kc.element_size()
    return _record("flash_decode", "flash_decode.cu",
                   "src/repro/kernels/flash_decode.py:83", launches, err, ms,
                   plain_ms, lib_ms, nbytes, flops, PEAK_FLOPS[kc.dtype])


def _record(name, src, replaces, launches, err, ms, plain_ms, lib_ms,
            nbytes, flops, peak, no_library="") -> dict:
    """``ms``, ``plain_ms`` and ``lib_ms`` are (device, eager) pairs; the
    record keeps the device times.  ``lib_ms`` is None where no single
    PyTorch call computes the function; ``no_library`` says why."""
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    rec = {"name": name, "route": "cuda",
           "source": f"src/repro_torch/kernels/csrc/{src}",
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": ms[0], "plain_ms": plain_ms[0],
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": lib_ms[0] if lib_ms else None}
    lib = f"{lib_ms[0]:.4f}" if lib_ms else f"null ({no_library})"
    log(f"[time] {name}: device ms={ms[0]:.4f} plain_ms={plain_ms[0]:.4f} "
        f"library_ms={lib} bound_ms={rec['bound_ms']:.4f} "
        f"({rec['bound_by']}: {nbytes} B, {flops} FLOP) launches={launches} "
        f"max_abs_err={err:.3e}")
    lib = f"{lib_ms[1]:.4f}" if lib_ms else "null"
    log(f"[time] {name}: eager ms (host overhead included)={ms[1]:.4f} "
        f"plain={plain_ms[1]:.4f} library={lib}")
    return rec


def _wkv6_flops(reset, h: int, dk: int, chunk: int, sub: int = 16) -> int:
    """Operations the chunked WKV6 needs on these resets (an exp counts as
    one, a multiply-add as two), counted for the sub-chunked form of
    ``ref.wkv6_two_pass``, the least of the chunked forms known here.  Per
    head and chunk:
      * each pair s < t with no reset in (s, t] in one sub-chunk of ``sub``
        tokens: its weight, dk x (the running product of decays, a
        multiply, a multiply-add), and its A[t,s] v[s] row, 2 dv;
      * each such pair across sub-chunks: a dot product of the two
        factors, 2 dk, and its A[t,s] v[s] row, 2 dv;
      * each token past the first sub-chunk: its r factor, 2 dk; each
        query sub-chunk past the first, for every key before it: the k
        factor, 3 dk;
      * each token: its decay exp(loga), dk, the u bonus, 3 dk, and its v
        row, 2 dv;
      * each token with no reset before it in the chunk: r exp(cw), 2 dk,
        and r_q S, 2 dk dv;
      * each token with no reset after it in the chunk: k_hat, 3 dk, and
        k_hat^T v, 2 dk dv;
      * each chunk with no reset: the decay of S, dk + dk dv.
    Pairs across a reset, and the state term behind one, need nothing."""
    b, s = reset.shape
    L = min(chunk, s)
    n = -(-s // L) * L
    dev = reset.device
    flags = torch.zeros((b, n), dtype=torch.int64, device=dev)
    flags[:, :s] = reset.to(torch.int64)
    valid = (torch.arange(n, device=dev) < s).view(1, -1, L)
    R = flags.view(b, -1, L).cumsum(-1)
    pos = torch.arange(L, device=dev)
    blk = pos // sub
    live = ((R[..., :, None] == R[..., None, :])
            & (pos[:, None] > pos[None, :]) & valid[..., :, None])
    same = blk[:, None] == blk[None, :]
    diag_pairs = int((live & same).sum())
    below_pairs = int((live & ~same).sum())
    r_rows = int((valid & (blk >= 1)).sum())
    k_rows = int((valid * pos * ((pos % sub == 0) & (pos >= sub))).sum())
    q_rows = int(((R == 0) & valid).sum())
    kh_rows = int(((R == R[..., -1:]) & valid).sum())
    live_chunks = int((R[..., -1] == 0).sum())
    dv = dk
    per_head = (diag_pairs * (4 * dk + 2 * dv)
                + below_pairs * (2 * dk + 2 * dv)
                + r_rows * 2 * dk + k_rows * 3 * dk
                + b * s * (4 * dk + 2 * dv)
                + q_rows * (2 * dk + 2 * dk * dv)
                + kh_rows * (3 * dk + 2 * dk * dv)
                + live_chunks * (dk + dk * dv))
    return h * per_head


def _time_wkv6(cfg, launches, train_seg: np.ndarray | None = None) -> dict:
    """At the serve shape (BATCH x PROMPT, one segment a row), or on a
    training batch's segment ids ``train_seg``."""
    from repro_torch.kernels import ref, wkv6
    dk, chunk = cfg.rwkv_head_dim, cfg.rwkv_chunk
    h = cfg.d_model // dk
    rng = np.random.default_rng(6)
    seg = np.ones((BATCH, PROMPT), np.int32) if train_seg is None \
        else train_seg                             # serve: one segment a row
    b, s = seg.shape
    sets = [_wkv6_inputs(rng, b, s, h, dk, seg) for _ in range(4)]

    def kernel(*a):
        return wkv6.wkv6(*a, chunk=chunk, return_state=True)

    def plain(*a):
        return ref.wkv6_chunked(*a[:5], chunk=chunk, reset=a[5],
                                return_state=True)
    got, exp = kernel(*sets[0]), plain(*sets[0])
    shape = "serve shape" if train_seg is None else "training shape"
    err = max(_check(f"wkv6 {shape}, o", got[0], exp[0], *WKV_TOL),
              _check(f"wkv6 {shape}, final state", got[1], exp[1],
                     *WKV_TOL))
    ms = _time_ms(kernel, sets, 40)
    plain_ms = _time_ms(plain, sets, 8)
    nbytes = _nbytes(*sets[0], *got)
    flops = _wkv6_flops(sets[0][5], h, dk, chunk)
    return _record("wkv6", "wkv6.cu", "src/repro/kernels/wkv6.py:90",
                   launches, err, ms, plain_ms, None, nbytes, flops,
                   PEAK_FLOPS[torch.float32],
                   no_library="no single PyTorch call computes WKV6")


def _wkv6_bwd_flops(reset, h: int, dk: int, chunk: int) -> int:
    """Operations the WKV6 gradients need on these resets, as
    ``ref.wkv6_bwd_two_pass`` forms them (an exp counts as one, a
    multiply-add as two).  Per head and chunk:
      * each pair s < t with no reset in (s, t]: its weight, dk (a running
        product), A[t,s], 4 dk, dA[t,s], 2 dv, and the pair terms of dr,
        dk and dv, 2 dk + 2 dk + 2 dv;
      * each token: d = exp(loga) and the decays Pq, Pk, 3 dk, B and dB,
        4 dk + 2 dv, the bonus terms of dr, dk, dv, 6 dk, and dloga's
        scans, 6 dk;
      * each token with no reset before it in the chunk: dO S^T and its
        decay, 2 dk dv + dk, and r_q^T dO into the state's gradient,
        2 dk dv;
      * each token with no reset after it: v dS^T and k_hat dS, 4 dk dv;
      * each chunk with no reset: dec dS and dS . S, 3 dk dv;
      * du: 3 dk a token."""
    b, s = reset.shape
    L = min(chunk, s)
    n = -(-s // L) * L
    dev = reset.device
    flags = torch.zeros((b, n), dtype=torch.int64, device=dev)
    flags[:, :s] = reset.to(torch.int64)
    valid = (torch.arange(n, device=dev) < s).view(1, -1, L)
    R = flags.view(b, -1, L).cumsum(-1)
    pos = torch.arange(L, device=dev)
    pairs = int(((R[..., :, None] == R[..., None, :])
                 & (pos[:, None] > pos[None, :]) & valid[..., :, None]).sum())
    q_rows = int(((R == 0) & valid).sum())
    k_rows = int(((R == R[..., -1:]) & valid).sum())
    live_chunks = int((R[..., -1] == 0).sum())
    dv = dk
    per_head = (pairs * (9 * dk + 4 * dv)
                + b * s * (22 * dk + 2 * dv)
                + q_rows * (4 * dk * dv + dk)
                + k_rows * 4 * dk * dv
                + live_chunks * 3 * dk * dv)
    return h * per_head


def _wkv6_bwd_sets(cfg, seg: np.ndarray) -> list:
    """Four sets of the wkv6 backward's inputs on segment ids ``seg`` at
    ``cfg``'s heads: r, k, v, loga, u, resets (``_wkv6_inputs``), dO and
    the forward kernel's chunk states."""
    from repro_torch.kernels import wkv6
    b, s = seg.shape
    dk, chunk = cfg.rwkv_head_dim, cfg.rwkv_chunk
    h = cfg.d_model // dk
    rng = np.random.default_rng(13)
    sets = []
    for _ in range(4):
        args = _wkv6_inputs(rng, b, s, h, dk, seg)
        states = torch.empty((b, h, -(-s // chunk), dk, dk), device="cuda")
        wkv6.wkv6(*args, chunk=chunk, chunk_states=states)
        dout = torch.tensor(rng.normal(size=(b, s, h, dk)),
                            dtype=torch.float32, device="cuda") * 0.5
        sets.append((*args, dout, states))
    return sets


def _launch_split_ms(fn, sets, calls: int) -> dict:
    """Device ms a call of each kernel ``fn`` launches, by name, from
    ``torch.profiler`` over ``calls`` eager calls cycling through
    ``sets``."""
    import re
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    return {(re.search(r"(\w+_kernel)", e.key) or [e.key[:60]])[0]:
            e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def _time_wkv6_bwd(cfg, launches, seg: np.ndarray) -> dict:
    """The wkv6 backward kernel at rwkv6-3b's training shape (TRAIN_BATCH x
    TRAIN_SEQ, 40 heads of 64, the resets of segment ids ``seg``, the
    rwkv trainer's first batch) beside its plain version (autograd of
    ``ref.wkv6_chunked``, eager: autograd is not captured in a graph).
    No single PyTorch call computes it.  Bound: each input (r, k, v, loga,
    u, the resets, dO and the forward's chunk states) read once and each
    gradient written once."""
    from repro_torch.kernels import ref, wkv6_bwd
    b, s = seg.shape
    dk, chunk = cfg.rwkv_head_dim, cfg.rwkv_chunk
    h = cfg.d_model // dk
    sets = _wkv6_bwd_sets(cfg, seg)

    def kernel(*a):
        return wkv6_bwd.wkv6_bwd(*a, chunk=chunk)

    def plain(*a):
        return ref.wkv6_bwd_ref(*a[:7], chunk=chunk)
    got = kernel(*sets[0])
    err = _check_wkv6_grads("wkv6_bwd training shape vs wkv6_bwd_ref", got,
                            plain(*sets[0]))
    ms = _time_ms(kernel, sets, 20)
    split = _launch_split_ms(kernel, sets, 20)
    log(f"[time] wkv6_bwd: pass 2 resident CTAs an SM "
        f"{wkv6_bwd.chunk_ctas_per_sm()}; each launch a call under the "
        "profiler, device ms: "
        + ", ".join(f"{k} {v:.5f}" for k, v in split.items()))
    plain_ms = _time_eager_ms(plain, sets, 4)
    nbytes = _nbytes(*sets[0], *got)
    flops = _wkv6_bwd_flops(sets[0][5], h, dk, chunk)
    return _record("wkv6_bwd", "wkv6_bwd.cu",
                   "none: JAX differentiates wkv6_chunked, "
                   "src/repro/models/rwkv.py:112", launches, err, ms,
                   (plain_ms, plain_ms), None, nbytes, flops,
                   PEAK_FLOPS[torch.float32],
                   no_library="no single PyTorch call computes the WKV6 "
                   "gradients")


# the path each record is timed on; its ``launches`` is that path's count
RECORD_PATH = {"packed_attention": f"serve:{ARCH}",
               "flash_decode": f"serve:{ARCH}",
               "wkv6": f"serve:{RWKV_ARCH}",
               "packed_attention_bwd": f"train:{ARCH}",
               "wkv6_bwd": RWKV_TRAIN_PATH}


def _with_paths(rec: dict, paths: dict, own: str | None = None) -> dict:
    """``launches``: the count on the record's own path (``launches_path``,
    ``RECORD_PATH``'s unless ``own`` is given; null where that path did not
    run); ``launches_by_path``: the kernel's count on every path that ran,
    each from its own zeroed run."""
    own = own or RECORD_PATH[rec["name"]]
    rec["launches"] = paths[own][rec["name"]] if own in paths else None
    rec["launches_path"] = own
    rec["launches_by_path"] = {path: counts[rec["name"]]
                               for path, counts in paths.items()}
    return rec


def phase_time(paths: dict, train_seg: np.ndarray,
               rwkv_seg: np.ndarray) -> list:
    from repro_torch.configs import get_config
    qwen, rwkv = get_config(ARCH), get_config(RWKV_ARCH)
    torch.cuda.empty_cache()
    return [_with_paths(r, paths) for r in (
        _time_packed_attention(qwen, paths[f"serve:{ARCH}"][
            "packed_attention"]),
        _time_flash_decode(qwen, paths[f"serve:{ARCH}"]["flash_decode"]),
        _time_wkv6(rwkv, paths[f"serve:{RWKV_ARCH}"]["wkv6"]),
        _time_packed_attention_bwd(qwen, paths[f"train:{ARCH}"][
            "packed_attention_bwd"], train_seg),
        _time_wkv6_bwd(rwkv, paths[RWKV_TRAIN_PATH]["wkv6_bwd"], rwkv_seg))]


# ------------------------------------------------------------- 6. train
def _events():
    return torch.cuda.Event(enable_timing=True)


def phase_train() -> tuple[dict, np.ndarray]:
    """qwen3-8b at full width with TRAIN_LAYERS of its 36 layers, AdamW on
    float32 master weights, TRAIN_STEPS steps through ``train_step`` on one
    packed batch of TRAIN_BATCH x TRAIN_SEQ (the data plane's documents
    and packer, ``_packed_rows``; next-token labels, -1 on padding and on
    each segment's last token), every kernel's count set to 0 just before the
    steps and read just after; then one more step by its parts (forward,
    backward, update) between CUDA events, and one step under the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.optimizer import AdamWConfig, adamw_update
    from repro_torch.train.train_step import (init_train_state, make_loss_fn,
                                              make_train_step)
    from repro_torch.models.params import tree_leaves, tree_map
    cfg = get_config(ARCH).replace(num_layers=TRAIN_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != TRAIN_PARAMS:
        raise AssertionError(f"{n_params} parameters, not {TRAIN_PARAMS}")
    state = init_train_state(model)
    opt_cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=1000)
    step = make_train_step(model, opt_cfg)
    rng = np.random.default_rng(TRAIN_SEED)
    rows = _packed_rows(rng, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
    seg, batch = rows.segment_ids, _card_batch(rows)
    lengths = [np.bincount(r[r > 0]).tolist()[1:] for r in seg]
    flat = np.concatenate(lengths)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[train] {ARCH} layers={cfg.num_layers} of 36 d_model={cfg.d_model} "
        f"params={n_params} batch={TRAIN_BATCH}x{TRAIN_SEQ} "
        f"loss tokens={int((batch['labels'] >= 0).sum())} segment lengths "
        f"{lengths}")
    log(f"[train] documents={flat.size} tokens={int(flat.sum())} of {tokens} "
        f"median={np.median(flat):g} p98={np.percentile(flat, 98):g} "
        f"max={flat.max()} share<=64={np.mean(flat <= 64):.4f} "
        f"causal pairs per head={int((flat * (flat + 1) // 2).sum())} "
        f"of {TRAIN_BATCH * TRAIN_SEQ * (TRAIN_SEQ + 1) // 2}")

    torch.cuda.synchronize()
    _zero_launch_counts()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        start, end = _events(), _events()
        start.record()
        state, metrics = step(state, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(metrics["loss"].item())
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = _train_want(cfg, TRAIN_STEPS)
    steady = float(np.mean(step_ms[1:]))
    log(f"[train] losses {losses}")
    log(f"[train] step ms (CUDA events) {[round(t, 3) for t in step_ms]}; "
        f"steps 2-{TRAIN_STEPS} mean {steady:.3f} ms, "
        f"{tokens / steady * 1e3:.1f} tokens/s")
    log(f"[train] max_memory_allocated={peak} B ({peak / 2**30:.2f} GiB)")
    log(f"[train] launches on the path: {counts} (per step: "
        f"{ {k: v / TRAIN_STEPS for k, v in counts.items()} })")
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != expected {want}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses}: not finite or not "
                             "falling")

    # one step by its parts: forward (the loss), backward, AdamW
    loss_fn = make_loss_fn(model)
    ev = [_events() for _ in range(4)]
    ev[0].record()
    total, _ = loss_fn(state.params, batch)
    ev[1].record()
    total.backward()
    ev[2].record()
    grads = tree_map(lambda p: p.grad, state.params)
    _, state_opt, _ = adamw_update(opt_cfg, grads, state.opt, state.params)
    ev[3].record()
    ev[3].synchronize()
    state = state._replace(opt=state_opt)
    for _, p in tree_leaves(state.params):
        p.grad = None
    split = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    log(f"[train] one step by its parts (CUDA events): forward "
        f"{split[0]:.3f} ms, backward {split[1]:.3f} ms, update "
        f"{split[2]:.3f} ms")

    # one step under the profiler
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    attn = {n: sum(e.self_device_time_total for e in kernels
                   if any(w in e.key for w in words)) / 1e3
            for n, words in (("forward", ("packed_attention_tc_kernel",)),
                             ("backward", ("dq_kernel", "dkdv_kernel")))}
    log(f"[trace] {ARCH} train step ({cfg.num_layers} layers, "
        f"{TRAIN_BATCH}x{TRAIN_SEQ}): wall_ms={wall_ms:.3f} (profiler on) "
        f"device_busy_ms={busy_ms:.3f} busy_share={busy_ms / wall_ms:.4f} "
        f"kernel_launches={sum(e.count for e in kernels)} "
        f"attention_forward_ms={attn['forward']:.3f} "
        f"attention_backward_ms={attn['backward']:.3f} "
        f"attention_share_of_busy="
        f"{(attn['forward'] + attn['backward']) / busy_ms:.4f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[trace]   {e.self_device_time_total / 1e3:9.4f} ms "
            f"x{e.count:<5d} {e.key[:90]}")
    return counts, seg


# ----------------------------------------------------------- 8. trainer
def _trainer_plane(root: str, cfg, strategy: str = "backbone_balance",
                   vocab: int | None = None):
    """The data plane of the trainer phase, from the port's copy of the
    Overlord: the four coyo-like sources the JAX launcher reads by default,
    equal weights, DP ``TRAIN_BATCH`` with one row and one bin a bucket (a
    global batch of TRAIN_BATCH x TRAIN_SEQ), ``TRAINER_SAMPLES`` samples a
    step, balanced by ``backbone_cost`` of the depth-cut config that trains
    (under ``hybrid_balance`` also by ViT-2B's encoder cost over the
    images, as the training launcher passes it), tokens drawn on [1,
    ``vocab``) (default the model's vocabulary), a strict delivery ledger,
    and the launch-time static analysis (``Overlord``'s default)."""
    from repro_torch.configs.paper_vlm import VIT_2B
    from repro_torch.core import (ClientPlaceTree, Overlord, OverlordConfig,
                                  StaticSchedule)
    from repro_torch.data.cost_models import backbone_cost, encoder_cost
    from repro_torch.data.sources import coyo_like_specs, materialize_group
    specs = coyo_like_specs(4)
    paths = materialize_group(specs, root)
    tree = ClientPlaceTree([("PP", 1), ("DP", TRAIN_BATCH), ("CP", 1),
                            ("TP", 1)])
    if strategy == "hybrid_balance":
        sparams = dict(backbone_costfn=backbone_cost(cfg),
                       encoder_costfn=encoder_cost(VIT_2B["num_layers"],
                                                   VIT_2B["d_model"]))
    else:
        sparams = dict(costfn=backbone_cost(cfg))
    return Overlord(paths, tree, StaticSchedule({s.name: 1.0 for s in specs}),
                    OverlordConfig(
                        seq_len=TRAIN_SEQ, rows_per_microbatch=1, n_bins=1,
                        samples_per_step=TRAINER_SAMPLES, strategy=strategy,
                        strategy_params=dict(sparams, broadcast=()),
                        vocab_size=vocab or cfg.vocab_size, ledger=True))


def _log_analysis(tag: str, ov):
    """The report of the static analysis ``Overlord(validate=True)`` ran
    at launch (warnings only: an error would have raised)."""
    rep = ov.analysis
    log(f"[{tag}] the Overlord's launch-time analysis: {len(rep)} findings "
        f"({len(rep.errors)} errors, {len(rep.warnings)} warnings) "
        f"{[f.render() for f in rep.findings]}")


def _sum_l2(seg: np.ndarray) -> np.ndarray:
    """Each row's sum of squared document lengths (the attention cost the
    balancer evens out)."""
    return np.array([float((np.bincount(r[r > 0])[1:].astype(np.int64) ** 2
                            ).sum()) for r in seg])


def _row_stats(seg: np.ndarray) -> str:
    """Fill, documents, and the rows' sum of squared document lengths, max
    over mean."""
    sq = _sum_l2(seg)
    docs = sum(int((np.bincount(r[r > 0])[1:] > 0).sum()) for r in seg)
    return (f"fill={(seg > 0).mean():.4f} documents={docs} sum_l2 per row "
            f"{sq.astype(int).tolist()} max/mean={sq.max() / sq.mean():.4f}")


def _profiled(fn, top: int = 0) -> tuple[str, float]:
    """``fn()`` once under the profiler: wall ms, the device's busy ms and
    share, and its launches; returns them as text, and what ``fn``
    returned.  ``top``: also log the kernels that take the most device
    time, that many."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[trace]   {e.self_device_time_total / 1e3:9.4f} ms "
            f"x{e.count:<5d} {e.key[:90]}")
    return (f"wall_ms={wall_ms:.3f} (profiler on) device_busy_ms="
            f"{busy_ms:.3f} busy_share={busy_ms / wall_ms:.4f} "
            f"kernel_launches={sum(e.count for e in kernels)} "
            f"loss={out}"), out


def phase_trainer() -> tuple[dict, np.ndarray]:
    """qwen3-8b at full width with TRAIN_LAYERS layers trained by the port's
    ``Trainer`` from a live Overlord (``_trainer_plane``): TRAINER_STEPS
    steps with every kernel's count set to 0 just before and read just
    after, each batch's rows logged; then one step under the profiler with
    its fetch, one on a batch fetched before it, and that batch again once
    the data plane is shut down; then the reduced launcher on the card and
    a checkpoint round trip.  Returns the counts and the first batch's
    segment ids."""
    import collections
    import gc
    import tempfile
    import threading
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig, gap_closed
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[trainer] memory_allocated before the phase: "
        f"{torch.cuda.memory_allocated()} B")
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(ARCH).replace(num_layers=TRAIN_LAYERS)
    model = build_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != TRAIN_PARAMS:
        raise AssertionError(f"{n_params} parameters, not {TRAIN_PARAMS}")
    kept = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sources_") as root:
        ov = _trainer_plane(root, cfg)
        _log_analysis("trainer", ov)
        try:
            ov.start()
            trainer = Trainer(model, ov, TrainerConfig(
                steps=TRAINER_STEPS, log_every=1, opt=AdamWConfig(
                    peak_lr=1e-3, warmup_steps=2, total_steps=1000)))
            assemble = trainer._assemble_global_batch

            def assemble_and_keep(step):
                batch = assemble(step)
                kept.append(batch["segment_ids"])
                return batch
            trainer._assemble_global_batch = assemble_and_keep
            torch.cuda.synchronize()
            _zero_launch_counts()
            hist = trainer.train(TRAINER_STEPS)
            counts = _launch_counts()
            peak = torch.cuda.max_memory_allocated()

            def step_on(batch_fn):
                """A step as ``Trainer.train`` runs it, on ``batch_fn()``."""
                trainer.state, metrics = trainer.step_fn(trainer.state,
                                                         batch_fn())
                return float(metrics["loss"])
            # one step with its fetch in the window, one on a batch fetched
            # before it, and (below) that batch again with the plane shut
            step = TRAINER_STEPS
            with_fetch, loss = _profiled(lambda: step_on(
                lambda: assemble(step)))
            ov.step_done(step, {"loss": loss})
            batch = assemble(step + 1)
            without, loss = _profiled(lambda: step_on(lambda: batch))
            ov.step_done(step + 1, {"loss": loss})
            report = ov.ledger.verify(strict=True)
            drops = collections.Counter(
                ov.ledger.snapshot()["dropped"].values())
            threads = threading.active_count()
        finally:
            ov.shutdown()
    shut, _ = _profiled(lambda: step_on(lambda: batch))
    log(f"[trainer] {ARCH} layers={cfg.num_layers} of 36 d_model="
        f"{cfg.d_model} params={n_params}; Overlord: coyo_like_specs(4), "
        f"DP {TRAIN_BATCH} x 1 row x {TRAIN_SEQ}, samples_per_step "
        f"{TRAINER_SAMPLES}, backbone_balance on the {cfg.num_layers}-layer "
        "config")
    segs = [s.cpu().numpy() for s in kept]
    for rec, seg in zip(hist, segs):
        log(f"[trainer] step {rec['step']} loss={rec['loss']} "
            f"fetch_s={rec['fetch_s']} step_s={rec['step_s']} "
            f"grad_norm={rec['grad_norm']} {_row_stats(seg)}")
    fetch = float(np.mean([r["fetch_s"] for r in hist[1:]])) * 1e3
    step_ms = float(np.mean([r["step_s"] for r in hist[1:]])) * 1e3
    log(f"[trainer] steps 2-{TRAINER_STEPS} mean: step_ms={step_ms:.3f} "
        f"fetch_ms={fetch:.3f} (host clock; the step ends when the loss "
        f"reaches the host, the fetch runs before it, in series) "
        f"{TRAIN_BATCH * TRAIN_SEQ / (step_ms + fetch) * 1e3:.1f} "
        "positions/s")
    first, last, share = gap_closed([r["loss"] for r in hist],
                                    cfg.vocab_size)
    log(f"[trainer] loss: mean of the first 5 {first}, of the last 5 "
        f"{last}, ln(V - 1) {np.log(cfg.vocab_size - 1)}: {share:.4f} of "
        "the gap closed (logged, not checked)")
    log(f"[trainer] max_memory_allocated={peak} B ({peak / 2**30:.2f} GiB)")
    log(f"[trainer] launches on the path: {counts}")
    log(f"[trace] {ARCH} trainer step with its fetch: {with_fetch}")
    log(f"[trace] {ARCH} trainer step, batch fetched before: {without}")
    log(f"[trace] {ARCH} trainer step on that batch again, the data plane "
        f"shut down ({threading.active_count()} Python threads): {shut}")
    log(f"[trainer] ledger {report}; dropped by reason {dict(drops)}; "
        f"{threads} Python threads alive (the data plane's actors, the "
        "clients' prefetchers and this one)")
    want = _train_want(cfg, TRAINER_STEPS)
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != expected {want}")
    losses = [r["loss"] for r in hist]
    if len(hist) != TRAINER_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"trainer losses {losses}")
    empty = [i for i, s in enumerate(segs) if not (s > 0).any()]
    if len(segs) != TRAINER_STEPS or empty:
        raise AssertionError(f"batches without tokens at steps {empty}")
    del trainer, model, kept, assemble, assemble_and_keep, batch, step_on
    gc.collect()
    torch.cuda.empty_cache()
    _check_reduced_launcher()
    return counts, segs[0]


def _check_reduced_launcher():
    """``launch.train.main`` at the reduced size on the card, through the
    kernels, for LAUNCHER_STEPS steps with the JAX launcher's defaults: the
    loss must close LAUNCHER_GAP_SHARE of its gap to ln(V - 1)
    (``train.trainer.gap_closed``); then a checkpoint of its trainer loads
    into a fresh one bitwise."""
    from repro_torch.configs.qwen3_8b import reduced
    from repro_torch.launch import train
    from repro_torch.train.trainer import gap_closed
    cfg = reduced()
    _zero_launch_counts()
    out = train.main(["--reduced", "--steps", str(LAUNCHER_STEPS)])
    counts = _launch_counts()
    losses = [r["loss"] for r in out["history"]]
    first, last, share = gap_closed(losses, cfg.vocab_size)
    log(f"[trainer] reduced launcher on {out['trainer'].device}: losses "
        f"{losses}; mean of the first 5 {first}, of the last 5 {last}, "
        f"ln(V - 1) {np.log(cfg.vocab_size - 1)}: {share:.4f} of the gap "
        f"closed (at least {LAUNCHER_GAP_SHARE}); launches {counts}")
    if out["trainer"].device.type != "cuda" or counts != _train_want(
            cfg, LAUNCHER_STEPS):
        raise AssertionError("the reduced launcher did not train through "
                             "the kernels on the card")
    if not np.isfinite(losses).all() or not share >= LAUNCHER_GAP_SHARE:
        raise AssertionError(f"reduced launcher: losses not finite, or "
                             f"{share:.4f} of the gap to ln(V - 1) closed")
    _check_checkpoint_round_trip(out["trainer"])


def _check_checkpoint_round_trip(trainer):
    """``trainer``'s checkpoint, loaded into a fresh trainer of other
    weights on the same device, gives every leaf bitwise equal."""
    import tempfile
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.trainer import Trainer, TrainerConfig, state_leaves
    cfg, step = trainer.model.cfg, int(trainer.state.opt.step)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        trainer.cfg.ckpt_dir = ckpt
        trainer.save_checkpoint(step)
        fresh = Trainer(build_model(cfg, torch.Generator(
            device=trainer.device).manual_seed(1)), None, TrainerConfig(
            ckpt_dir=ckpt))
        fresh.load_checkpoint(step)
    leaves = list(zip(state_leaves(trainer.state), state_leaves(fresh.state)))
    differ = [i for i, (a, b) in enumerate(leaves) if not torch.equal(a, b)]
    if differ or int(fresh.state.opt.step) != step:
        raise AssertionError(f"checkpoint round trip: leaves {differ} "
                             f"differ, opt.step {int(fresh.state.opt.step)}")
    log(f"[trainer] checkpoint round trip on {fresh.device}: {len(leaves)} "
        f"leaves bitwise equal, opt.step {step}")


def _train_from_plane(model, cfg, strategy: str, steps: int, lr: float,
                      tag: str, vocab: int | None = None, top: int = 0,
                      stats: dict | None = None) -> tuple[dict, list, list]:
    """``steps`` steps of ``model`` by the port's ``Trainer`` from a live
    ``_trainer_plane(strategy, vocab)``, with every kernel's count set to 0
    just before and read just after; each batch's rows and aux loss, the
    step and fetch times, the peak memory, one more step under the profiler
    with its fetch in the window (``top``: its kernels that take the most
    device time, logged), and the strict ledger (which raises on a sample
    lost or delivered twice).  Returns the counts, the records and
    each batch's segment ids; ``stats``, if given, gets the peak GiB, the
    mean step and fetch ms and the profiled step's trace."""
    import collections
    import tempfile
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    kept = []
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sources_") as root:
        ov = _trainer_plane(root, cfg, strategy, vocab)
        _log_analysis(tag, ov)
        try:
            ov.start()
            trainer = Trainer(model, ov, TrainerConfig(
                steps=steps, log_every=1, opt=AdamWConfig(
                    peak_lr=lr, warmup_steps=2, total_steps=1000)))
            assemble, step_fn, auxes = (trainer._assemble_global_batch,
                                        trainer.step_fn, [])

            def assemble_and_keep(step):
                batch = assemble(step)
                kept.append(batch["segment_ids"].cpu().numpy())
                return batch

            def step_and_keep_aux(state, batch):
                state, metrics = step_fn(state, batch)
                auxes.append(metrics["aux_loss"])     # read after the run
                return state, metrics
            trainer._assemble_global_batch = assemble_and_keep
            trainer.step_fn = step_and_keep_aux
            torch.cuda.synchronize()
            _zero_launch_counts()
            hist = trainer.train(steps)
            counts = _launch_counts()
            peak = torch.cuda.max_memory_allocated()

            def step_with_fetch():
                state, metrics = trainer.step_fn(trainer.state,
                                                 assemble(steps))
                trainer.state = state
                return float(metrics["loss"])
            traced, loss = _profiled(step_with_fetch, top)
            ov.step_done(steps, {"loss": loss})
            report = ov.ledger.verify(strict=True)
            drops = collections.Counter(
                ov.ledger.snapshot()["dropped"].values())
        finally:
            ov.shutdown()
            trainer = assemble = assemble_and_keep = step_with_fetch = None
            step_fn = step_and_keep_aux = None
    for rec, seg, aux in zip(hist, kept, auxes):
        log(f"[{tag}] step {rec['step']} loss={rec['loss']} "
            f"aux_loss={float(aux)} fetch_s={rec['fetch_s']} "
            f"step_s={rec['step_s']} grad_norm={rec['grad_norm']} "
            f"{_row_stats(seg)}")
    fetch = float(np.mean([r["fetch_s"] for r in hist[1:]])) * 1e3
    step_ms = float(np.mean([r["step_s"] for r in hist[1:]])) * 1e3
    balance = [float(_sum_l2(seg).max() / _sum_l2(seg).mean())
               for seg in kept]
    log(f"[{tag}] {strategy}, steps 2-{steps} mean: step_ms={step_ms:.3f} "
        f"fetch_ms={fetch:.3f} (host clock) "
        f"{TRAIN_BATCH * TRAIN_SEQ / (step_ms + fetch) * 1e3:.1f} "
        f"positions/s; per-row sum_l2 max/mean by step "
        f"{[round(x, 4) for x in balance]}, mean {np.mean(balance):.4f}")
    log(f"[{tag}] {strategy}: max_memory_allocated={peak} B "
        f"({peak / 2**30:.2f} GiB); launches on the path: {counts}")
    log(f"[trace] {tag} step with its fetch, {strategy}: {traced}")
    log(f"[{tag}] {strategy}: ledger {report}; dropped by reason "
        f"{dict(drops)}")
    if stats is not None:
        stats.update(peak_gib=peak / 2**30, step_ms=step_ms, fetch_ms=fetch,
                     trace=traced)
    want = _train_want(cfg, steps)
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != expected {want}")
    losses = [r["loss"] for r in hist]
    if len(hist) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"{tag} losses {losses}")
    empty = [i for i, seg in enumerate(kept) if not (seg > 0).any()]
    if len(kept) != steps or empty:
        raise AssertionError(f"batches without tokens at steps {empty}")
    return counts, hist, kept


def phase_trainer_vlm() -> tuple[dict, np.ndarray]:
    """paper-llama-12b at full width with VLM_TRAIN_LAYERS of its 45 layers
    (no image path in training, as in the JAX trainer) trained by the
    port's ``Trainer`` from a live Overlord under ``hybrid_balance``, the
    paper's VLM strategy (images balanced over the encoder's consumers by
    ViT-2B's cost, then whole sequences over DP), for TRAINER_STEPS steps;
    then VLM_BACKBONE_STEPS steps of the same model from a
    ``backbone_balance`` plane, so the two strategies' row balance and step
    time stand side by side; each run starts from the same weights, drawn
    from one seed.  Returns each run's counts by path, and the first hybrid
    batch's segment ids."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[vlm-trainer] memory_allocated before the phase: "
        f"{torch.cuda.memory_allocated()} B")
    cfg = get_config(VLM_ARCH).replace(num_layers=VLM_TRAIN_LAYERS)
    runs = {}
    for strategy, steps in (("hybrid_balance", TRAINER_STEPS),
                            ("backbone_balance", VLM_BACKBONE_STEPS)):
        model = build_model(cfg, torch.Generator(device="cuda").manual_seed(0))
        n_params = sum(p.numel() for p in model.parameters())
        if n_params != VLM_TRAIN_PARAMS:
            raise AssertionError(f"{n_params} parameters, not "
                                 f"{VLM_TRAIN_PARAMS}")
        log(f"[vlm-trainer] {VLM_ARCH} layers={cfg.num_layers} of 45 "
            f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
            f"params={n_params}; Overlord: coyo_like_specs(4), DP "
            f"{TRAIN_BATCH} x 1 row x {TRAIN_SEQ}, samples_per_step "
            f"{TRAINER_SAMPLES}, {strategy}")
        runs[strategy] = _train_from_plane(model, cfg, strategy, steps, 1e-3,
                                           "vlm-trainer")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    (hyb, hyb_hist, segs), (bb, bb_hist, bb_segs) = (
        runs["hybrid_balance"], runs["backbone_balance"])
    same_rows = all(np.array_equal(a, b) for a, b in zip(segs, bb_segs))
    same_loss = [a["loss"] for a in hyb_hist[:len(bb_hist)]] == [
        b["loss"] for b in bb_hist]
    log(f"[vlm-trainer] the first {len(bb_hist)} steps under the two "
        f"strategies: rows equal {same_rows}, losses equal {same_loss}")
    return ({f"trainer:{VLM_ARCH}": hyb,
             f"trainer:{VLM_ARCH}:backbone_balance": bb}, segs[0])


def phase_trainer_moe() -> tuple[dict, np.ndarray]:
    """The paper's tMoE-25B backbone (16 experts, top 2, 16 heads of 128
    with no GQA) at full width with TMOE_TRAIN_LAYERS of its 42 layers,
    trained by the port's ``Trainer`` from phase 8's live plane under
    ``backbone_balance`` (whose cost model reads the experts a token runs)
    for TRAINER_STEPS steps.  Returns the counts and the first batch's
    segment ids."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[moe-trainer] memory_allocated before the phase: "
        f"{torch.cuda.memory_allocated()} B")
    cfg = get_config(TMOE_ARCH).replace(num_layers=TMOE_TRAIN_LAYERS)
    model = build_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != TMOE_TRAIN_PARAMS:
        raise AssertionError(f"{n_params} parameters, not {TMOE_TRAIN_PARAMS}")
    log(f"[moe-trainer] {TMOE_ARCH} layers={cfg.num_layers} of 42 "
        f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
        f"experts={cfg.num_experts} top-{cfg.experts_per_token} "
        f"params={n_params}; Overlord: coyo_like_specs(4), DP {TRAIN_BATCH} "
        f"x 1 row x {TRAIN_SEQ}, samples_per_step {TRAINER_SAMPLES}, "
        "backbone_balance")
    counts, _, segs = _train_from_plane(model, cfg, "backbone_balance",
                                        TRAINER_STEPS, 1e-3, "moe-trainer")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts, segs[0]


def phase_trainer_rwkv(layers: int = RWKV_TRAIN_LAYERS,
                       remat: str = "layer", stats: dict | None = None
                       ) -> tuple[dict, np.ndarray]:
    """rwkv6-3b at full width with ``layers`` of its 32 layers (all of them
    unless the remat loop asks for fewer) under the remat policy ``remat``
    (the reference's default) trained by the port's ``Trainer`` from phase
    8's live plane under ``backbone_balance`` (whose cost model is linear
    for the ssm family) for TRAINER_STEPS steps, through the wkv6 forward
    kernel once a layer a step and once more in the recompute, and the
    backward kernel once a layer a step.  Returns the counts and the first
    batch's segment ids; ``stats`` gets the run's peak, step and trace."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[rwkv-trainer] memory_allocated before the phase: "
        f"{torch.cuda.memory_allocated()} B")
    cfg = get_config(RWKV_ARCH).replace(num_layers=layers, remat=remat)
    model = build_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != RWKV_PARAMS_BY_LAYERS[layers]:
        raise AssertionError(f"{n_params} parameters, not "
                             f"{RWKV_PARAMS_BY_LAYERS[layers]}")
    log(f"[rwkv-trainer] {RWKV_ARCH} layers={cfg.num_layers} of 32 "
        f"remat={cfg.remat} d_model={cfg.d_model} wkv heads="
        f"{cfg.d_model // cfg.rwkv_head_dim} of {cfg.rwkv_head_dim} "
        f"chunk={cfg.rwkv_chunk} params={n_params}; Overlord: "
        f"coyo_like_specs(4), DP {TRAIN_BATCH} x 1 row x {TRAIN_SEQ}, "
        f"samples_per_step {TRAINER_SAMPLES}, backbone_balance")
    counts, _, segs = _train_from_plane(model, cfg, "backbone_balance",
                                        TRAINER_STEPS, 1e-3, "rwkv-trainer",
                                        stats=stats)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts, segs[0]


def phase_trainer_dense() -> tuple[dict, np.ndarray]:
    """qwen3-32b (64 q heads on 8 kv heads of 80) at full width with
    QWEN32_TRAIN_LAYERS of its 64 layers (a cut for memory) trained by the
    port's ``Trainer`` from phase 8's live plane under ``backbone_balance``
    for TRAINER_STEPS steps: the attention backward at d 80 on a trained
    path.  Returns the counts and the first batch's segment ids."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[dense-trainer] memory_allocated before the phase: "
        f"{torch.cuda.memory_allocated()} B")
    cfg = get_config(QWEN32_ARCH).replace(num_layers=QWEN32_TRAIN_LAYERS)
    model = build_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != QWEN32_TRAIN_PARAMS:
        raise AssertionError(f"{n_params} parameters, not "
                             f"{QWEN32_TRAIN_PARAMS}")
    log(f"[dense-trainer] {QWEN32_ARCH} layers={cfg.num_layers} of 64 "
        f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} of "
        f"{cfg.resolved_head_dim()} params={n_params}; Overlord: "
        f"coyo_like_specs(4), DP {TRAIN_BATCH} x 1 row x {TRAIN_SEQ}, "
        f"samples_per_step {TRAINER_SAMPLES}, backbone_balance")
    counts, _, segs = _train_from_plane(model, cfg, "backbone_balance",
                                        TRAINER_STEPS, 1e-3, "dense-trainer")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts, segs[0]


def phase_loss() -> dict:
    """The full-width loss: phase 8's model (qwen3-8b, TRAIN_LAYERS layers,
    vocab 151,936) trained by ``Trainer`` for LOSS_STEPS steps at peak lr
    LOSS_LR from phase 8's plane drawing its tokens on [1, LOSS_VOCAB).
    The least loss on unseen documents is then ln(LOSS_VOCAB - 1), which
    the model reaches only by learning which tokens occur; the mean of the
    last five losses must close LOSS_GAP_SHARE of the gap from the first
    five's mean to it."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.trainer import gap_closed
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(ARCH).replace(num_layers=TRAIN_LAYERS)
    model = build_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    counts, hist, _ = _train_from_plane(model, cfg, "backbone_balance",
                                        LOSS_STEPS, LOSS_LR, "loss",
                                        vocab=LOSS_VOCAB)
    losses = [r["loss"] for r in hist]
    first, last, share = gap_closed(losses, LOSS_VOCAB)
    log(f"[loss] {ARCH} {cfg.num_layers} layers, model vocab "
        f"{cfg.vocab_size}, tokens on [1, {LOSS_VOCAB}), peak lr {LOSS_LR}: "
        f"losses {losses}; mean of the first 5 {first}, of the last 5 "
        f"{last}, ln({LOSS_VOCAB} - 1) {np.log(LOSS_VOCAB - 1)}: "
        f"{share:.4f} of the gap closed (at least {LOSS_GAP_SHARE})")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if not share >= LOSS_GAP_SHARE:
        raise AssertionError(f"full-width loss closed {share:.4f} of its gap "
                             f"to ln({LOSS_VOCAB} - 1)")
    return counts


def phase_example() -> dict:
    """``examples/train_e2e_torch.py`` with its defaults (200 steps) on the
    card; it raises unless its loss checks pass.  Counts set to 0 just
    before and read just after."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("train_e2e_torch", EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    _zero_launch_counts()
    t0 = time.perf_counter()
    out = example.main([])
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    cfg = out["trainer"].model.cfg
    steps = len(out["history"])
    log(f"[example] train_e2e_torch on {out['trainer'].device}: {steps} steps "
        f"in {wall:.1f}s; mean loss first 10 {out['first']}, last 10 "
        f"{out['last']}: {out['share']:.4f} of the gap to ln(V - 1) closed; "
        f"launches {counts}")
    want = _train_want(cfg, steps)
    if out["trainer"].device.type != "cuda" or counts != want:
        raise AssertionError(f"the example launched {counts}, not {want}")
    return counts


def _bwd_sets(cfg, seg: np.ndarray) -> list:
    """Four sets of the backward kernel's inputs at the training shape
    (TRAIN_BATCH x TRAIN_SEQ, qwen3-8b heads, segment ids ``seg``, causal):
    q, k, v, the forward kernel's out and lse, dout, and the segment ids."""
    from repro_torch.kernels import packed_attention
    b, s = seg.shape
    h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    bf = torch.bfloat16
    rng = np.random.default_rng(12)
    segs = torch.as_tensor(seg, device="cuda")
    sets = []
    for _ in range(4):
        q, k, v = (_bshd(rng, b, s, h, d, bf), _bshd(rng, b, s, kh, d, bf),
                   _bshd(rng, b, s, kh, d, bf))
        out, lse = packed_attention.packed_attention(q, k, v, segs, segs,
                                                     return_lse=True)
        sets.append((q, k, v, out, lse, _bshd(rng, b, s, h, d, bf), segs,
                     segs))
    return sets


def _needed_tile_pairs(seg: np.ndarray, h: int) -> int:
    """The 64 x 64 tile pairs holding a valid (q, k) pair, over every q
    head, for causal self-attention on ``seg`` (counted on the host)."""
    from repro_torch.kernels import ref
    segs = torch.as_tensor(seg)
    valid = ref._attention_mask(segs, segs, seg.shape[1], seg.shape[1], True)
    b, s = seg.shape
    n = -(-s // 64)
    pad = torch.nn.functional.pad(valid[:, 0], (0, n * 64 - s, 0, n * 64 - s))
    return int(pad.view(b, n, 64, n, 64).any(-1).any(2).sum()) * h


def _time_packed_attention_bwd(cfg, launches, seg: np.ndarray) -> dict:
    """The backward kernel at the training shape (``_bwd_sets``) beside its
    plain version and SDPA's backward (autograd of
    ``F.scaled_dot_product_attention`` with the same boolean mask, eager,
    timed as a yardstick only).  Bound: 10 d FLOP per valid (q, k) pair;
    q, k, v, o, dO, lse, dq, dk and dv moved once."""
    import torch.nn.functional as F
    from repro_torch.kernels import packed_attention_bwd, ref
    b, s = seg.shape
    h, d = cfg.num_heads, cfg.resolved_head_dim()
    bf = torch.bfloat16
    sets = _bwd_sets(cfg, seg)
    segs = sets[0][6]
    *got, live_q, live_kv = packed_attention_bwd.packed_attention_bwd(
        *sets[0], return_live=True)
    live = _kernel_live_pairs(live_q, live_kv, segs, segs, True,
                              "packed_attention_bwd training shape")
    # one kv head under every q head (MQA): held to the version that
    # rounds where the kernel rounds (_check_long_group_bwd says why)
    plain_fn = ref.packed_attention_bwd_bf16_ref if cfg.num_kv_heads == 1 \
        else ref.packed_attention_bwd_ref
    exp = plain_fn(*sets[0])
    err = max(_check(f"packed_attention_bwd training shape {name} vs "
                     f"{plain_fn.__name__}", g, e, TOL[bf])
              for name, g, e in zip(("dq", "dk", "dv"), got, exp))
    ms = _time_ms(packed_attention_bwd.packed_attention_bwd, sets, 20)
    plain_ms = _time_ms(ref.packed_attention_bwd_ref, sets, 4)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device="cuda"))
    # padding rows attend to padding keys here, so no row is empty (an
    # empty row would make SDPA's softmax NaN)
    mask = causal[None, None] & (segs[:, None, :, None]
                                 == segs[:, None, None, :])
    lib_sets = []
    for q, k, v, _, _, dout, _, _ in sets:
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                           enable_gqa=True)
        lib_sets.append((o, leaves, dout))

    def library(o, leaves, dout):
        return torch.autograd.grad(o, leaves, dout, retain_graph=True)
    lib_ms = _time_eager_ms(library, lib_sets, 20)
    pairs = sum(int(n) * (int(n) + 1) // 2 for row in seg
                for n in np.bincount(row[row > 0])[1:]) * h
    log(f"[time] packed_attention_bwd training shape: {pairs} valid (q, k) "
        f"pairs of {b * h * s * (s + 1) // 2} causal ones; {live} live 64x64 "
        f"tile pairs a launch as the kernel counted them, each CTA's count "
        f"as ref.packed_attention_live_tiles' "
        f"({_needed_tile_pairs(seg, h)} hold a valid pair)")
    items = live_kv * (h // live_kv.shape[1])   # (q head, q tile) a CTA
    log("[time] packed_attention_bwd work per CTA, from the kernel's counts:"
        + "".join(f" {name} {t.numel()} CTAs, {what} min/mean/max "
                  f"{int(t.min())}/{t.float().mean().item():.3f}/"
                  f"{int(t.max())};" for name, what, t in (
                      ("dQ", "key tiles", live_q),
                      ("dK/dV", "items", items))))
    q, k, v, out, lse, dout = sets[0][:6]
    nbytes = _nbytes(q, k, v, out, dout, lse, *got)
    rec = _record("packed_attention_bwd", "packed_attention_bwd.cu",
                  "none: JAX differentiates segment_attention, "
                  "src/repro/models/attention.py:70", launches, err, ms,
                  plain_ms, (lib_ms, lib_ms), nbytes, 10 * d * pairs,
                  PEAK_FLOPS[bf])
    rec["live_tile_pairs"] = live
    return rec


# ------------------------------------------------------------- 5. trace
def _device_kernels(prof) -> list:
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def phase_trace_decode(arch: str, served: dict, steps: int = 4):
    """Profile ``steps`` decode steps of the serve run's own bf16 model on
    its float32 cache, at the first positions the serve run decoded (its
    prompt's length on), so attention reads the cache length it read there:
    wall time per step, the device's busy share, and device time by kernel.
    Rewriting those cache rows (or stepping the RWKV state on) changes no
    shape or launch."""
    from torch.profiler import ProfilerActivity, profile
    decode, cache = served["decode"], served["cache"]
    tokens = torch.ones((BATCH, 1), dtype=torch.int32, device="cuda")
    first = _prompt(served)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(first, first + steps):
            decode(cache, tokens, t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = _device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    log(f"[trace] {arch} decode step at positions {first}..{first + steps}"
        f": wall_ms={wall_ms:.3f} (profiler on) "
        f"device_busy_ms={busy_ms:.3f} busy_share={busy_ms / wall_ms:.4f} "
        f"kernel_launches_per_step={sum(e.count for e in kernels) / steps}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[trace]   {e.self_device_time_total / 1e3 / steps:9.4f} ms "
            f"x{e.count // steps:<5d} {e.key[:90]}")


def phase_trace_prefill(arch: str, served: dict):
    """Profile one prefill of the serve run's own model and prompt (the
    serve run's prefill already warmed it): wall time, the device's busy
    share, the share of the hand-written kernels, and device time by
    kernel."""
    from torch.profiler import ProfilerActivity, profile
    prefill, batch = served["prefill"], served["batch"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ours = {n: sum(e.self_device_time_total for e in kernels if n in e.key)
            / 1e3 for n in ("wkv6", "packed_attention")}
    log(f"[trace] {arch} prefill {BATCH}x{_prompt(served)}: "
        f"wall_ms={wall_ms:.3f} "
        f"(profiler on) device_busy_ms={busy_ms:.3f} "
        f"busy_share={busy_ms / wall_ms:.4f} "
        f"kernel_launches={sum(e.count for e in kernels)} " + " ".join(
            f"{n}_ms={t:.3f} {n}_share_of_busy={t / busy_ms:.4f}"
            for n, t in ours.items() if t))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[trace]   {e.self_device_time_total / 1e3:9.4f} ms "
            f"x{e.count:<5d} {e.key[:90]}")


def main_wkv6():
    """``--only wkv6``: the wkv6 build, checks and timing, no serve run."""
    from repro_torch.configs import get_config
    phase_build(("wkv6",))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _check_wkv6()
    _check_reduced_rwkv()
    return [_with_paths(_time_wkv6(get_config(RWKV_ARCH), None), {})]


def main_train():
    """``--only train``: the two attention kernels' build, the training
    checks, the training run and the backward kernel's record."""
    from repro_torch.configs import get_config
    phase_build(("packed_attention", "packed_attention_bwd"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_check_train()
    counts, seg = phase_train()
    return [_with_paths(_time_packed_attention_bwd(
        get_config(ARCH), counts["packed_attention_bwd"], seg),
        {f"train:{ARCH}": counts})]


def main_bwd():
    """``--only bwd``: the backward's build and checks, and its record at
    the training shape."""
    from repro_torch.configs import get_config
    phase_build(("packed_attention", "packed_attention_bwd"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _check_packed_attention_bwd()
    seg = _packed_rows(np.random.default_rng(TRAIN_SEED), TRAIN_BATCH,
                       TRAIN_SEQ).segment_ids
    return [_with_paths(_time_packed_attention_bwd(get_config(ARCH), None,
                                                   seg), {})]


def main_trainer():
    """``--only trainer``: the two attention kernels' build, phase 8, and
    the backward's record at the shape of the trainer's first batch."""
    from repro_torch.configs import get_config
    phase_build(("packed_attention", "packed_attention_bwd"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path = f"trainer:{ARCH}"
    counts, seg = phase_trainer()
    return [_with_paths(_time_packed_attention_bwd(
        get_config(ARCH), counts["packed_attention_bwd"], seg),
        {path: counts}, own=path)]


def main_vlm():
    """``--only vlm``: the builds of the three attention kernels, their
    checks at paper-llama-12b's heads (and the backward's group-8 case),
    the reduced vlm on the card, the paper-llama-12b serve run and its
    traces, the vlm trainer phase, and the three kernels' records at
    paper-llama-12b's shapes (the backward at the trainer's first batch)."""
    from repro_torch.configs import get_config
    phase_build(("packed_attention", "packed_attention_bwd", "flash_decode"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _check_vlm_packed_attention(np.random.default_rng(0))
    _check_vlm_flash_decode(np.random.default_rng(1))
    _check_vlm_packed_attention_bwd(np.random.default_rng(7))
    _check_reduced_vlm()
    paths = _serve_traced((VLM_ARCH,))
    trained, seg = phase_trainer_vlm()
    paths.update(trained)
    log(f"[done] launches by path: {paths}")
    cfg, serve, train = (get_config(VLM_ARCH), f"serve:{VLM_ARCH}",
                         f"trainer:{VLM_ARCH}")
    return [_with_paths(_time_packed_attention(
                cfg, paths[serve]["packed_attention"]), paths, own=serve),
            _with_paths(_time_flash_decode(
                cfg, paths[serve]["flash_decode"]), paths, own=serve),
            _with_paths(_time_packed_attention_bwd(
                cfg, paths[train]["packed_attention_bwd"], seg), paths,
                own=train)]


def _serve_traced(archs, prompt: int = CUT_PROMPT) -> dict:
    """Each of ``archs`` served whole (``phase_serve``) with its prefill
    and decode traces, its weights freed before the next is drawn.
    Returns each path's counts."""
    paths = {}
    for arch in archs:
        paths[f"serve:{arch}"], served = phase_serve(arch, prompt)
        phase_trace_prefill(arch, served)
        phase_trace_decode(arch, served)
        del served
    return paths


def phase_serve_moe() -> dict:
    """granite-moe-3b-a800m and qwen3-moe-30b-a3b at full width and depth,
    each with its prefill and decode traces."""
    return _serve_traced((GRANITE_ARCH, MOE_ARCH))


def phase_serve_dense() -> dict:
    """yi-9b, granite-20b and qwen3-32b at full width and depth, each with
    its prefill and decode traces."""
    return _serve_traced((YI_ARCH, GRANITE20_ARCH, QWEN32_ARCH))


def main_moe():
    """``--only moe``: the builds of the three attention kernels, their
    checks at the MoE family's heads (granite-moe's group 3, qwen3-moe's
    group 8 decode), the MoE checks, the two MoE serve runs and their
    traces, the tMoE trainer phase, and the three kernels' records at the
    MoE shapes: the forward and the backward on the tMoE trainer's first
    batch, ``flash_decode`` at granite-moe's heads."""
    from repro_torch.configs import get_config
    phase_build(("packed_attention", "packed_attention_bwd", "flash_decode"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _check_moe_packed_attention(np.random.default_rng(0))
    _check_moe_flash_decode(np.random.default_rng(1))
    _check_moe_packed_attention_bwd(np.random.default_rng(7))
    phase_check_moe()
    paths = phase_serve_moe()
    train, serve = f"trainer:{TMOE_ARCH}", f"serve:{GRANITE_ARCH}"
    paths[train], seg = phase_trainer_moe()
    log(f"[done] launches by path: {paths}")
    tmoe, granite = get_config(TMOE_ARCH), get_config(GRANITE_ARCH)
    return [_with_paths(_time_packed_attention(
                tmoe, paths[train]["packed_attention"], seg), paths,
                own=train),
            _with_paths(_time_flash_decode(
                granite, paths[serve]["flash_decode"]), paths, own=serve),
            _with_paths(_time_packed_attention_bwd(
                tmoe, paths[train]["packed_attention_bwd"], seg), paths,
                own=train)]



def main_rwkvtrain():
    """``--only rwkvtrain``: the builds of the two wkv6 kernels, the
    backward's checks, reduced rwkv6-3b's first step against the CPU and
    its memorising a batch, the rwkv6-3b trainer phase, and the two wkv6
    kernels' records on the trainer's first batch."""
    from repro_torch.configs import get_config
    phase_build(("wkv6", "wkv6_bwd"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_check_rwkv_train()
    paths = {}
    paths[RWKV_TRAIN_PATH], seg = phase_trainer_rwkv()
    log(f"[done] launches by path: {paths}")
    cfg, counts = get_config(RWKV_ARCH), paths[RWKV_TRAIN_PATH]
    return [_with_paths(_time_wkv6(cfg, counts["wkv6"], seg), paths,
                        own=RWKV_TRAIN_PATH),
            _with_paths(_time_wkv6_bwd(cfg, counts["wkv6_bwd"], seg), paths,
                        own=RWKV_TRAIN_PATH)]



def main_dense():
    """``--only dense``: the builds of the three attention kernels, their
    checks at the dense family's new heads (d 80, group 48), the three
    reduced configs on the card, the three serve runs and their traces,
    the qwen3-32b trainer phase, and the three kernels' records: the
    forward and the backward on the qwen3-32b trainer's first batch,
    ``flash_decode`` at granite-20b's heads."""
    from repro_torch.configs import get_config
    phase_build(("packed_attention", "packed_attention_bwd", "flash_decode"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_check_dense()
    paths = phase_serve_dense()
    paths[QWEN32_TRAIN_PATH], seg = phase_trainer_dense()
    log(f"[done] launches by path: {paths}")
    qwen32, granite = get_config(QWEN32_ARCH), get_config(GRANITE20_ARCH)
    train, serve = QWEN32_TRAIN_PATH, f"serve:{GRANITE20_ARCH}"
    return [_with_paths(_time_packed_attention(
                qwen32, paths[train]["packed_attention"], seg), paths,
                own=train),
            _with_paths(_time_flash_decode(
                granite, paths[serve]["flash_decode"]), paths, own=serve),
            _with_paths(_time_packed_attention_bwd(
                qwen32, paths[train]["packed_attention_bwd"], seg), paths,
                own=train)]



def phase_trainer_hybrid(layers: int = ZAMBA_TRAIN_LAYERS,
                         remat: str = "layer", stats: dict | None = None
                         ) -> tuple[dict, np.ndarray]:
    """zamba2-7b at full width with ``layers`` of its 81 layers (whole
    blocks of 6, each closed by the one shared attention block, and the
    3-layer tail) under the remat policy ``remat`` (the reference's
    default; each block one checkpoint, the tail none) trained by the
    port's ``Trainer`` from phase 8's live plane under ``backbone_balance``
    (whose cost model charges attention on ``num_layers // attn_every``
    layers) for TRAINER_STEPS steps: the attention forward kernel at d 112
    once a block a step and once more in the recompute, the backward once a
    block a step.  Returns the counts and the first batch's segment ids;
    ``stats`` gets the run's peak, step and trace."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[hybrid-trainer] memory_allocated before the phase: "
        f"{torch.cuda.memory_allocated()} B")
    cfg = get_config(ZAMBA_ARCH).replace(num_layers=layers, remat=remat)
    model = build_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != ZAMBA_PARAMS_BY_LAYERS[layers]:
        raise AssertionError(f"{n_params} parameters, not "
                             f"{ZAMBA_PARAMS_BY_LAYERS[layers]}")
    log(f"[hybrid-trainer] {ZAMBA_ARCH} layers={cfg.num_layers} of 81 "
        f"remat={cfg.remat} (blocks of {cfg.attn_every} and a tail of "
        f"{cfg.num_layers % cfg.attn_every}) d_model={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} of "
        f"{cfg.resolved_head_dim()} ssm heads "
        f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} chunk "
        f"{cfg.ssm_chunk} params={n_params}; Overlord: coyo_like_specs(4), "
        f"DP {TRAIN_BATCH} x 1 row x {TRAIN_SEQ}, samples_per_step "
        f"{TRAINER_SAMPLES}, backbone_balance")
    counts, _, segs = _train_from_plane(model, cfg, "backbone_balance",
                                        TRAINER_STEPS, 1e-3,
                                        "hybrid-trainer", top=10,
                                        stats=stats)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts, segs[0]


# ---------------------------------------------------------------- remat
# the training families' reduced configs (the hybrid with a 1-layer tail,
# which is not checkpointed); qwen3-moe-30b-a3b's reduced heads are 16
# wide, granite-moe's 8 are narrower than the backward kernel takes
REMAT_FAMILIES = {"qwen3_8b": {}, "qwen3_moe_30b_a3b": {},
                  "pixtral_12b": {}, "rwkv6_3b": {},
                  "zamba2_7b": {"num_layers": 5}, "whisper_medium": {}}
# the depths tried for the deepest zamba2-7b that trains under "layer":
# whole blocks of 6 and the full model's 3-layer tail, deepest first (15
# layers peaked at 38.78 GiB, 33 at 59.69 and 39 at 66.66: ~6.97 GiB a
# block; at 45 a 4 GiB allocation found 3.7 GiB free beside 66.9 GiB
# allocated and 7.8 GiB cached in pieces)
ZAMBA_DEPTHS = (51, 45, 39)


def _check_remat_reduced():
    """Each training family's reduced config on the card, the same weights
    and batch (4 x 256 of the data plane's documents; bf16 frames for
    Whisper) under each remat policy: the first step's loss to a relative
    LOSS_REL_TOL and every leaf's gradient to a relative L2 of GRAD_REL_L2
    against ``"none"``, and the launches of each (the forward kernel once
    more in the recompute).  The recompute runs each kernel again on the
    same inputs; the MoE block's scatter-add accumulates with atomics, so
    its recomputed values may differ in the last bits, hence tolerances,
    not bitwise equality."""
    import importlib
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.remat import POLICIES
    from repro_torch.train.train_step import init_train_state, make_loss_fn
    for module, cut in REMAT_FAMILIES.items():
        base = importlib.import_module(
            f"repro_torch.configs.{module}").reduced().replace(**cut)
        runs = {}
        for policy in POLICIES:
            cfg = base.replace(remat=policy)
            gen = torch.Generator(device="cuda").manual_seed(7)
            model = build_model(cfg, gen)
            for name, prm in model.named_parameters():  # RWKV6's LoRA legs
                if ".mixB_" in name or name.endswith("loraB_w"):
                    prm.data.normal_(0.0, 0.1, generator=gen)
            state = init_train_state(model)
            rng = np.random.default_rng(7)
            batch = _card_batch(_packed_rows(rng, TRAIN_BATCH, 256,
                                             cfg.vocab_size))
            if cfg.family == "audio":
                batch["enc_embeds"] = _frames(rng, TRAIN_BATCH, cfg,
                                              torch.bfloat16)
            torch.cuda.synchronize()
            _zero_launch_counts()
            total, _ = make_loss_fn(model)(state.params, batch)
            total.backward()
            torch.cuda.synchronize()
            counts = _launch_counts()
            if counts != _train_want(cfg, 1):
                raise AssertionError(f"{cfg.name} remat={policy}: launched "
                                     f"{counts}, not {_train_want(cfg, 1)}")
            runs[policy] = (total.item(), {
                n: t.grad.float() for n, t in tree_leaves(state.params)},
                counts)
        loss_n, grads_n, _ = runs["none"]
        for policy in POLICIES[1:]:
            loss, grads, counts = runs[policy]
            rel = abs(loss - loss_n) / abs(loss_n)
            worst = max(((torch.linalg.vector_norm(grads[n] - grads_n[n])
                          / torch.linalg.vector_norm(grads_n[n])).item(), n)
                        for n in grads_n)
            ok = rel <= LOSS_REL_TOL and worst[0] <= GRAD_REL_L2
            log(f"[check] remat {cfg.name} {policy} vs none on the card: "
                f"loss {loss:.6f} vs {loss_n:.6f} relative {rel:.3e} (limit "
                f"{LOSS_REL_TOL:g}); worst gradient relative L2 "
                f"{worst[0]:.3e} ({worst[1]}; limit {GRAD_REL_L2:g}); "
                f"launches {counts} against {runs['none'][2]} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{cfg.name}: remat={policy} disagrees "
                                     "with remat=none")
        del runs
        torch.cuda.empty_cache()


def phase_check_remat():
    _check_grad_guards()
    _check_remat_reduced()


def _remat_row(what: str, policy: str, stats: dict):
    log(f"[remat] {what} remat={policy}: peak {stats['peak_gib']:.2f} GiB, "
        f"step_ms={stats['step_ms']:.3f} fetch_ms={stats['fetch_ms']:.3f} "
        f"(host clock, steps 2-{TRAINER_STEPS}); profiled step with its "
        f"fetch: {stats['trace']}")


def phase_remat_memory() -> dict:
    """What the remat policy buys at full width, in one call: zamba2-7b
    with 15 of its 81 layers under each policy and rwkv6-3b with 24 of its
    32 under ``"none"`` and ``"layer"`` (the deepest each trained at
    keeping every activation), each trained from phase 8's plane for
    TRAINER_STEPS steps; then rwkv6-3b whole under ``"layer"``; then the
    deepest zamba2-7b that trains under ``"layer"`` of ZAMBA_DEPTHS (a
    depth whose step runs out of device memory is logged as not fitting,
    and the next is tried).  Returns each run's counts by path, and the
    first batch's segment ids of rwkv6-3b whole and of the deepest
    zamba2-7b, by path."""
    import gc
    from repro_torch.models.remat import POLICIES
    paths, rows, segs = {}, [], {}
    for policy in POLICIES:
        stats = {}
        paths[f"trainer:{ZAMBA_ARCH}:15-of-81-layers:{policy}"], _ = \
            phase_trainer_hybrid(15, policy, stats)
        rows.append((f"{ZAMBA_ARCH} 15 of 81 layers", policy, stats))
    for policy in ("none", "layer"):
        stats = {}
        paths[f"trainer:{RWKV_ARCH}:24-of-32-layers:{policy}"], _ = \
            phase_trainer_rwkv(24, policy, stats)
        rows.append((f"{RWKV_ARCH} 24 of 32 layers", policy, stats))
    stats = {}
    paths[RWKV_TRAIN_PATH], segs[RWKV_TRAIN_PATH] = phase_trainer_rwkv(
        RWKV_TRAIN_LAYERS, "layer", stats)
    rows.append((f"{RWKV_ARCH} 32 of 32 layers", "layer", stats))
    for layers in ZAMBA_DEPTHS:
        stats = {}
        try:
            counts, seg = phase_trainer_hybrid(layers, "layer", stats)
        except torch.cuda.OutOfMemoryError as e:
            log(f"[remat] {ZAMBA_ARCH} {layers} of 81 layers under layer "
                f"does not fit: {str(e).splitlines()[0]}")
            counts = None
        if counts is None:      # the failed step's tensors are free now
            gc.collect()
            torch.cuda.empty_cache()
            continue
        zamba = f"trainer:{ZAMBA_ARCH}:{layers}-of-81-layers"
        paths[zamba], segs[zamba] = counts, seg
        rows.append((f"{ZAMBA_ARCH} {layers} of 81 layers", "layer", stats))
        log(f"[remat] the deepest {ZAMBA_ARCH} of {list(ZAMBA_DEPTHS)} that "
            f"trains under layer: {layers} of 81 layers (the full run's "
            f"phase 15 trains {ZAMBA_TRAIN_LAYERS})")
        break
    else:
        raise AssertionError(f"no {ZAMBA_ARCH} depth of {ZAMBA_DEPTHS} "
                             "trains under layer")
    for row in rows:
        _remat_row(*row)
    return paths, segs


def main_remat():
    """``--only remat``: the builds of the four training kernels, the grad
    guards, each training family's reduced config under the three remat
    policies against each other, the memory and step runs of
    ``phase_remat_memory``, and four records under ``"layer"``: the
    attention forward and backward on the deepest zamba2-7b's first batch,
    the two wkv6 kernels on rwkv6-3b's (whole) first batch."""
    from repro_torch.configs import get_config
    phase_build(("packed_attention", "packed_attention_bwd", "wkv6",
                 "wkv6_bwd"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_check_remat()
    paths, segs = phase_remat_memory()
    log(f"[done] launches by path: {paths}")
    zamba, rwkv = get_config(ZAMBA_ARCH), get_config(RWKV_ARCH)
    z = next(p for p in segs if p != RWKV_TRAIN_PATH)
    r = RWKV_TRAIN_PATH
    return [_with_paths(_time_packed_attention(
                zamba, paths[z]["packed_attention"], segs[z]), paths, own=z),
            _with_paths(_time_packed_attention_bwd(
                zamba, paths[z]["packed_attention_bwd"], segs[z]), paths,
                own=z),
            _with_paths(_time_wkv6(rwkv, paths[r]["wkv6"], segs[r]), paths,
                        own=r),
            _with_paths(_time_wkv6_bwd(rwkv, paths[r]["wkv6_bwd"], segs[r]),
                        paths, own=r)]


def phase_train_whisper() -> dict:
    """whisper-medium at full width and depth, AdamW on float32 master
    weights, TRAIN_STEPS steps through ``train_step`` on one fixed batch:
    4 x 1024 decoder tokens (the data plane's documents, next-token
    labels) and bf16 frame embeddings of 1500 frames, every kernel's count
    set to 0 just before and read just after (72 attention calls a step,
    24 encoder, 24 self, 24 cross: each a backward launch, and two forward
    launches under the remat policy "layer"); step ms by
    CUDA events, tokens/s, peak memory, then one step under the profiler.
    Returns the counts."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(WHISPER_ARCH)
    model = build_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != WHISPER_PARAMS:
        raise AssertionError(f"{n_params} parameters, not {WHISPER_PARAMS}")
    state = init_train_state(model)
    step = make_train_step(model, AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                              total_steps=1000))
    rng = np.random.default_rng(TRAIN_SEED)
    rows = _packed_rows(rng, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
    seg, batch = rows.segment_ids, _card_batch(rows)
    batch["enc_embeds"] = _frames(rng, TRAIN_BATCH, cfg, torch.bfloat16)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[whisper-train] {WHISPER_ARCH} encoder {cfg.encoder_layers} + "
        f"decoder {cfg.num_layers} layers d_model={cfg.d_model} heads="
        f"{cfg.num_heads}/{cfg.num_kv_heads} of {cfg.resolved_head_dim()} "
        f"params={n_params}; batch {TRAIN_BATCH}x{TRAIN_SEQ} decoder tokens "
        f"({int((seg > 0).sum())} in documents), enc_embeds "
        f"{tuple(batch['enc_embeds'].shape)} bf16")
    torch.cuda.synchronize()
    _zero_launch_counts()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        start, end = _events(), _events()
        start.record()
        state, metrics = step(state, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(metrics["loss"].item())
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steady = float(np.mean(step_ms[1:]))
    log(f"[whisper-train] losses {losses}")
    log(f"[whisper-train] step ms (CUDA events) "
        f"{[round(t, 3) for t in step_ms]}; steps 2-{TRAIN_STEPS} mean "
        f"{steady:.3f} ms, {tokens / steady * 1e3:.1f} decoder tokens/s")
    log(f"[whisper-train] max_memory_allocated={peak} B "
        f"({peak / 2**30:.2f} GiB); launches on the path: {counts}")

    def one_step():
        nonlocal state
        state, metrics = step(state, batch)
        return float(metrics["loss"])
    traced, _ = _profiled(one_step, top=10)
    log(f"[trace] {WHISPER_ARCH} train step, fixed batch: {traced}")
    want = _train_want(cfg, TRAIN_STEPS)
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != expected {want}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"whisper training losses {losses}")
    del state, step, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _check_whisper_cross_decode(served: dict, steps: int = 4):
    """At full width, after the serve run's counts were read: the serve
    run's own bf16 model prefills its prompt again, the prefill's self k/v
    and cross k/v go into a float32 cache of ``steps`` positions past the
    prompt,
    and ``steps`` decode steps read them, so flash_decode reads the
    1500-frame cross cache's real values (the serve flow decodes against
    zeros there, ROADMAP C5).  Their logits must be finite and must move
    from those of the same steps on the same cache with its cross k/v
    zeroed; their distance from the forward over the same tokens, and
    the share of positions whose argmax agrees, are logged."""
    prefill, decode, batch, model = (served[k] for k in (
        "prefill", "decode", "batch", "model"))
    _, kv = prefill(batch)
    prompt = _prompt(served)
    cache = model.init_cache(BATCH, prompt + steps, torch.float32)
    for n in ("k", "v"):
        cache[n][:, :, :prompt] = kv[n]
    for n in ("cross_k", "cross_v"):
        cache[n].copy_(kv[n])
    zero = {n: t.clone() for n, t in cache.items()}
    for n in ("cross_k", "cross_v"):
        zero[n].zero_()
    feed = batch["tokens"][:, :steps]          # any tokens: the same twice
    real_logits, zero_logits = [], []
    for t in range(steps):
        real_logits.append(decode(cache, feed[:, t:t + 1], prompt + t)[0])
        zero_logits.append(decode(zero, feed[:, t:t + 1], prompt + t)[0])
    real, zeroed = torch.cat(real_logits, 1), torch.cat(zero_logits, 1)
    full = dict(batch, tokens=torch.cat([batch["tokens"], feed], 1),
                segment_ids=torch.ones((BATCH, prompt + steps),
                                       dtype=torch.int32, device="cuda"),
                positions=torch.arange(prompt + steps, dtype=torch.int32,
                                       device="cuda").expand(BATCH, -1))
    with torch.no_grad():
        fwd = model(full)[0][:, prompt:].float()
    moved = (real.float() - zeroed.float()).abs().max().item()
    dist = (real.float() - fwd).abs().max().item()
    agree = (real.argmax(-1) == fwd.argmax(-1)).float().mean().item()
    ok = torch.isfinite(real.float()).all().item() and moved > 0
    log(f"[check] {WHISPER_ARCH} full width, {steps} decode steps against "
        f"the prefill's cross cache ({tuple(cache['cross_k'].shape)}): "
        f"logits move by max {moved:.4e} from a zero cross cache's; vs the "
        f"bf16 forward over the same tokens max abs {dist:.4e}, argmax "
        f"agreeing at {agree:.4f} of positions (logged) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("decode against the prefill's cross cache: "
                             "logits not finite, or the audio read nothing")


def _time_cross_attention(cfg, launches, sq: int, dt) -> dict:
    """packed_attention at a whisper-medium shape: BATCH rows of ``sq``
    queries against its ``encoder_frames`` keys, non-causal, every segment
    id 1 (sq = encoder_frames: the encoder's self-attention), in ``dt``
    (float32: the served encoder's; bf16: the prefill's cross-attention
    and training's), beside its plain version and SDPA (no mask: every
    pair is valid)."""
    import torch.nn.functional as F
    from repro_torch.kernels import packed_attention, ref
    h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    b, sk = BATCH, cfg.encoder_frames
    rng = np.random.default_rng(27)
    q_seg = torch.ones((b, sq), dtype=torch.int32, device="cuda")
    kv_seg = torch.ones((b, sk), dtype=torch.int32, device="cuda")
    sets = [(_bshd(rng, b, sq, h, d, dt), _bshd(rng, b, sk, kh, d, dt),
             _bshd(rng, b, sk, kh, d, dt), q_seg, kv_seg) for _ in range(4)]

    def kernel(*a):
        return packed_attention.packed_attention(*a, causal=False)

    def plain(*a):
        return ref.packed_attention_ref(*a, causal=False)

    def library(q, k, v, *_):
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
    got = kernel(*sets[0])
    err = _check(f"packed_attention {b}x{sq} vs {sk} keys, non-causal, "
                 f"{str(dt)[6:]}", got, plain(*sets[0]), TOL[dt])
    q, k, v = sets[0][:3]
    return _record("packed_attention", "packed_attention.cu",
                   "src/repro/kernels/packed_attention.py:122", launches,
                   err, _time_ms(kernel, sets, 20), _time_ms(plain, sets, 4),
                   _time_ms(library, sets, 20),
                   _nbytes(q, k, v, got, q_seg, kv_seg),
                   4 * d * b * h * sq * sk, PEAK_FLOPS[dt])


def _time_cross_attention_bwd(cfg, launches, sq: int) -> dict:
    """packed_attention_bwd at a whisper-medium shape: BATCH rows of ``sq``
    queries against its ``encoder_frames`` keys, non-causal, bf16, beside
    its plain version and SDPA's backward (eager).  Bound as
    ``_time_packed_attention_bwd``'s: 10 d FLOP a (q, k) pair, every
    tensor moved once."""
    import torch.nn.functional as F
    from repro_torch.kernels import packed_attention, packed_attention_bwd
    from repro_torch.kernels import ref
    h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    b, sk, bf = BATCH, cfg.encoder_frames, torch.bfloat16
    rng = np.random.default_rng(28)
    q_seg = torch.ones((b, sq), dtype=torch.int32, device="cuda")
    kv_seg = torch.ones((b, sk), dtype=torch.int32, device="cuda")
    sets = []
    for _ in range(4):
        q, k, v = (_bshd(rng, b, sq, h, d, bf), _bshd(rng, b, sk, kh, d, bf),
                   _bshd(rng, b, sk, kh, d, bf))
        out, lse = packed_attention.packed_attention(
            q, k, v, q_seg, kv_seg, causal=False, return_lse=True)
        sets.append((q, k, v, out, lse, _bshd(rng, b, sq, h, d, bf), q_seg,
                     kv_seg))

    def kernel(*a):
        return packed_attention_bwd.packed_attention_bwd(*a, causal=False)

    def plain(*a):
        return ref.packed_attention_bwd_ref(*a, causal=False)
    got = kernel(*sets[0])
    err = max(_check(f"packed_attention_bwd {b}x{sq} vs {sk} keys, "
                     f"non-causal: {name}", g, e, TOL[bf])
              for name, g, e in zip(("dq", "dk", "dv"), got,
                                    plain(*sets[0])))
    lib_sets = []
    for q, k, v, _, _, dout, _, _ in sets:
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_sets.append((F.scaled_dot_product_attention(
            *leaves, enable_gqa=True), leaves, dout))

    def library(o, leaves, dout):
        return torch.autograd.grad(o, leaves, dout, retain_graph=True)
    lib_ms = _time_eager_ms(library, lib_sets, 20)
    q, k, v, out, lse, dout = sets[0][:6]
    return _record("packed_attention_bwd", "packed_attention_bwd.cu",
                   "none: JAX differentiates segment_attention, "
                   "src/repro/models/attention.py:70", launches, err,
                   _time_ms(kernel, sets, 20), _time_ms(plain, sets, 4),
                   (lib_ms, lib_ms), _nbytes(q, k, v, out, dout, lse, *got),
                   10 * d * b * h * sq * sk, PEAK_FLOPS[bf])


def _wkv6_records(paths: dict) -> list:
    """The two wkv6 kernels' records for a run whose paths launch neither
    (their count on every path that ran is 0, and ``launches`` is null:
    their own paths did not run): ``wkv6`` at rwkv6-3b's serve shape,
    ``wkv6_bwd`` at its training shape on the data plane's documents."""
    from repro_torch.configs import get_config
    rwkv = get_config(RWKV_ARCH)
    seg = _packed_rows(np.random.default_rng(TRAIN_SEED), TRAIN_BATCH,
                       TRAIN_SEQ).segment_ids
    return [_with_paths(_time_wkv6(rwkv, None), paths),
            _with_paths(_time_wkv6_bwd(rwkv, None, seg), paths)]


def phase_serve_hybrid() -> dict:
    """zamba2-7b at full width and depth (81 layers: 13 applications of the
    shared block), with its prefill and decode traces.  Returns its
    counts by path."""
    path = f"serve:{ZAMBA_ARCH}"
    counts, served = phase_serve(ZAMBA_ARCH)
    phase_trace_prefill(ZAMBA_ARCH, served)
    phase_trace_decode(ZAMBA_ARCH, served)
    return {path: counts}       # frees the 13.5 GB of bf16 zamba2 weights


def phase_serve_audio() -> dict:
    """whisper-medium at full width and depth, then its decode against the
    prefill's cross cache (``_check_whisper_cross_decode``), and its
    prefill and decode traces.  Returns its counts by path."""
    path = f"serve:{WHISPER_ARCH}"
    counts, served = phase_serve(WHISPER_ARCH)
    _check_whisper_cross_decode(served)
    phase_trace_prefill(WHISPER_ARCH, served)
    phase_trace_decode(WHISPER_ARCH, served)
    return {path: counts}


def main_hybrid():
    """``--only hybrid``: the builds of the five kernels, the hybrid's card
    checks (the attention kernels at d 112 first), the zamba2-7b serve run
    and its traces, the zamba2-7b trainer phase, and the five kernels'
    records: the forward and the backward on the trainer's first batch,
    ``flash_decode`` at zamba2's heads, the two wkv6 kernels (no launch on
    these paths)."""
    from repro_torch.configs import get_config
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_check_hybrid()
    paths = phase_serve_hybrid()
    paths[ZAMBA_TRAIN_PATH], seg = phase_trainer_hybrid()
    log(f"[done] launches by path: {paths}")
    cfg, train, serve = (get_config(ZAMBA_ARCH), ZAMBA_TRAIN_PATH,
                         f"serve:{ZAMBA_ARCH}")
    return [_with_paths(_time_packed_attention(
                cfg, paths[train]["packed_attention"], seg), paths,
                own=train),
            _with_paths(_time_flash_decode(
                cfg, paths[serve]["flash_decode"]), paths, own=serve),
            _with_paths(_time_packed_attention_bwd(
                cfg, paths[train]["packed_attention_bwd"], seg), paths,
                own=train),
            *_wkv6_records(paths)]


def main_audio():
    """``--only audio``: the builds of the five kernels, the audio family's
    card checks (the attention kernels at Whisper's shapes first), the
    whisper-medium serve run with its decode against the real cross cache
    and its traces, the fixed-batch training run, and the five kernels'
    records: the forward at the served encoder's shape (float32, 1500 on
    1500, non-causal), ``flash_decode`` on the 1500-frame cross cache, the
    backward at the training cross-attention's (1024 on 1500), the two
    wkv6 kernels (no launch on these paths)."""
    from repro_torch.configs import get_config
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_check_audio()
    paths = phase_serve_audio()
    paths[WHISPER_TRAIN_PATH] = phase_train_whisper()
    log(f"[done] launches by path: {paths}")
    cfg, train, serve = (get_config(WHISPER_ARCH), WHISPER_TRAIN_PATH,
                         f"serve:{WHISPER_ARCH}")
    F_ = cfg.encoder_frames
    cross = _time_cross_attention(cfg, None, PROMPT, torch.bfloat16)
    log(f"[time] packed_attention at the served cross-attention's shape "
        f"({BATCH}x{PROMPT} on {F_}, bf16): ms={cross['ms']:.4f} "
        f"plain_ms={cross['plain_ms']:.4f} "
        f"library_ms={cross['library_ms']:.4f} "
        f"bound_ms={cross['bound_ms']:.4f} ({cross['bound_by']})")
    return [_with_paths(_time_cross_attention(
                cfg, paths[serve]["packed_attention"], F_, torch.float32),
                paths, own=serve),
            _with_paths(_time_flash_decode(
                cfg, paths[serve]["flash_decode"], S=F_,
                layers=cfg.num_layers), paths, own=serve),
            _with_paths(_time_cross_attention_bwd(
                cfg, paths[train]["packed_attention_bwd"], TRAIN_SEQ), paths,
                own=train),
            *_wkv6_records(paths)]


# --------------------------------------------------------- 3b. dryrun
DRYRUN_LEAF_SLACK = 512     # the caching allocator rounds blocks to 512 B


def _allocated() -> int:
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _check_predicted(what: str, predicted: int, grown: int, leaves: int,
                     smi: str):
    slack = DRYRUN_LEAF_SLACK * leaves
    log(f"[dryrun] {what}: predicted={predicted} B grown={grown} B "
        f"(diff {grown - predicted} B, allowed {slack} B for {leaves} "
        f"leaves) on {smi}")
    if abs(grown - predicted) > slack:
        raise AssertionError(f"dry-run {what}: predicted {predicted} B, "
                             f"the allocator grew {grown} B")


def phase_dryrun():
    """Phase 3b: the dry-run's predicted bytes against the allocator, the
    rules' DTensor placements on a local mesh, and the dry-run's CLI."""
    import gc
    import tempfile
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.launch import dryrun, mesh as lmesh
    from repro_torch.models import params as pdefs
    from repro_torch.models.model_zoo import (
        build_meta_model, build_model, model_defs,
    )
    from repro_torch.sharding.logical import (
        ShardingRules, mesh_axis_sizes, param_shardings,
    )
    from repro_torch.train.train_step import init_train_state
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    cfg = get_config(ARCH).replace(num_layers=TRAIN_LAYERS)
    train, prefill = SHAPES["train_4k"], ShapeConfig("prefill", "prefill",
                                                      1, 1)
    decode = ShapeConfig("decode_4k_b8", "decode", 4096, 8)
    leaves = len(list(pdefs.tree_leaves(model_defs(cfg))))
    cache_leaves = len(list(pdefs.tree_leaves(
        build_meta_model(cfg).cache_axes())))
    gc.collect()
    torch.cuda.empty_cache()
    mesh = lmesh.make_local_mesh("cuda")
    try:
        log(f"[dryrun] local mesh {mesh_axis_sizes(mesh)} backend "
            f"{torch.distributed.get_backend()}")

        def predict(shape):
            return dryrun.persistent_bytes(
                build_meta_model(cfg), shape, mesh,
                ShardingRules(mesh, dryrun.rules_for(shape)))
        p_params, p_state, p_decode = map(predict, (prefill, train, decode))
        base = _allocated()
        model = build_model(cfg, torch.Generator("cuda").manual_seed(
            TRAIN_SEED), torch.float32)
        grown_params = _allocated() - base
        state = init_train_state(model)
        grown_state = _allocated() - base
        _check_predicted(f"{ARCH} {TRAIN_LAYERS}-layer float32 params",
                         p_params, grown_params, leaves, smi)
        _check_predicted(f"{ARCH} {TRAIN_LAYERS}-layer train state",
                         p_state, grown_state, 3 * leaves + 1, smi)
        shardings, rules = param_shardings(model_defs(cfg), mesh)
        specs = dict(pdefs.tree_leaves(shardings))
        for path, p in pdefs.tree_leaves(state.params):
            d = distribute_tensor(p.detach(), mesh, specs[path].placements())
            local = d.to_local()
            if not (local.shape == p.shape and torch.equal(
                    local.view(torch.int32), p.detach().view(torch.int32))):
                raise AssertionError(f"DTensor shard of {path} differs")
            del d, local
        log(f"[dryrun] {leaves} parameters distributed as DTensors with the "
            f"rules' placements, each local shard bitwise equal "
            f"(dropped {rules.dropped})")
        with torch.no_grad():
            base = _allocated()
            cache = model.init_cache(decode.global_batch, decode.seq_len)
            grown_cache = _allocated() - base
        _check_predicted(f"{ARCH} {TRAIN_LAYERS}-layer init_cache("
                         f"{decode.global_batch}, {decode.seq_len})",
                         p_decode - p_params, grown_cache, cache_leaves, smi)
        del cache, state, model
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        lmesh.close_local_mesh()
    if torch.distributed.is_initialized():
        raise AssertionError("the local mesh's process group outlived it")
    with tempfile.TemporaryDirectory() as out:
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             ARCH, "--shape", "train_4k", "--mesh", "single", "--out", out],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "src")))
        wall = time.perf_counter() - t1
        if proc.returncode != 0:
            raise AssertionError(f"dryrun CLI failed: {proc.stderr[-3000:]}")
        rec = json.loads(open(os.path.join(
            out, f"{ARCH}__train_4k__single.json")).read())
        if rec["status"] != "ok":
            raise AssertionError(f"dryrun single: {rec}")
        log(f"[dryrun] CLI {ARCH} train_4k single: persistent_bytes_per_"
            f"device={rec['persistent_bytes_per_device']} "
            f"({rec['persistent_bytes_per_device'] / 2**30:.2f} GiB) "
            f"model_flops={rec['model_flops']:.6e} "
            f"op_flops={rec['op_flops']} op_bytes={rec['op_bytes']} "
            f"op_count={rec['op_count']} trace_s={rec['trace_s']} "
            f"dropped={len(rec['dropped_shardings'])} "
            f"collective_counts={rec['collective_counts']} "
            f"collective_wire_bytes={rec['collective_wire_bytes']}")
    phase_s = time.perf_counter() - t0
    log(f"[dryrun] CLI subprocess {wall:.1f}s; phase {phase_s:.1f}s on {smi}")


# ------------------------------------------------------------- 3c. shard
def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _distance(got: dict, want: dict) -> tuple[bool, float, float, str]:
    """(every tensor bitwise equal, the largest max abs difference, the
    worst relative L2 and its key) of two dicts of CPU tensors."""
    bitwise, worst_abs, worst = True, 0.0, (0.0, "")
    for key, w in want.items():
        g = got[key]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{key}: {g.dtype} {tuple(g.shape)} "
                                 f"against {w.dtype} {tuple(w.shape)}")
        if torch.equal(g, w):
            continue
        bitwise = False
        d = (g.double() - w.double())
        worst_abs = max(worst_abs, d.abs().max().item())
        norm = torch.linalg.vector_norm(w.double()).item()
        rel = torch.linalg.vector_norm(d).item() / max(norm, 1e-30)
        worst = max(worst, (rel, key))
    return bitwise, worst_abs, worst[0], worst[1]


def _train_once(model, batch) -> dict:
    """The loss and every gradient of one forward and backward, then one
    AdamW step through ``train_step``, on ``model``'s leaves (plain tensors
    or DTensors): every number on the CPU, with the launch counts."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.train_step import (
        init_train_state, make_loss_fn, make_train_step,
    )
    state = init_train_state(model)
    _zero_launch_counts()
    total, _ = make_loss_fn(model)(state.params, batch)
    total.backward()
    out = {"loss": {"loss": _full(total).detach().float().cpu()},
           "grads": {}, "after": {}}
    for path, p in tree_leaves(state.params):
        out["grads"][path], p.grad = _full(p.grad).cpu(), None
    state, _ = make_train_step(model)(state, batch)
    for path, p in tree_leaves(state.params):
        out["after"][path] = _full(p).detach().cpu()
    out["counts"] = _launch_counts()
    return out


def _serve_once(model, batch, steps: int) -> dict:
    """The prefill logits of ``batch`` and ``steps`` decode steps on an
    empty float32 cache (the prompt's first tokens, as serving replays
    it), on the CPU, with the launch counts; ``batch`` and the cache are
    distributed by the rules in use when the model's leaves are DTensors."""
    from repro_torch.models.model_zoo import batch_logical_axes
    from repro_torch.sharding.logical import (
        current_rules, distribute, distribute_tree, dtensor_mesh,
    )
    from repro_torch.train.train_step import (
        make_decode_step, make_prefill_step,
    )
    b, s = batch["tokens"].shape
    cache = model.init_cache(b, s + GEN, torch.float32)
    tokens = batch["tokens"]
    rules = current_rules()
    if dtensor_mesh(model.embed.table) is not None:
        from repro_torch.configs import ShapeConfig
        axes = batch_logical_axes(model.cfg, ShapeConfig("p", "prefill", s, b))
        batch = distribute_tree(batch, axes, rules)
        cache = distribute_tree(cache, model.cache_axes(), rules)
        tokens = distribute(tokens, rules.spec(("batch", None), (b, s)),
                            rules.mesh)
    _zero_launch_counts()
    logits, _ = make_prefill_step(model)(batch)
    out = {"prefill": {"logits": _full(logits).float().cpu()}, "decode": {}}
    step = make_decode_step(model)
    for t in range(steps):
        logits, cache = step(cache, tokens[:, t:t + 1], t)
        out["decode"][f"step {t}"] = _full(logits).float().cpu()
    out["counts"] = _launch_counts()
    return out


def _sharded_against_plain(what: str, run, arch: str, layers: int,
                           mapping_name: str, batch) -> dict:
    """``run(model, batch)`` on ``arch`` at full width with ``layers``
    layers (weights from one seed), first on plain tensors, then with every
    leaf a DTensor placed by ``mapping_name``'s rules on the world-of-one
    nccl mesh under ``use_rules`` and ``collectives.count``: the same
    numbers (bitwise, or within LOSS_REL_TOL and GRAD_REL_L2), the same
    launch counts, and no collective."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch import collectives, mesh as lmesh
    from repro_torch.models.model_zoo import build_model, distribute_model
    from repro_torch.sharding import logical
    cfg = get_config(arch).replace(num_layers=layers)
    mapping = getattr(logical, mapping_name)

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        return build_model(cfg, torch.Generator("cuda").manual_seed(
            TRAIN_SEED), torch.float32)
    plain = run(fresh(), batch)
    mesh = lmesh.make_local_mesh("cuda")
    try:
        model = fresh()
        with logical.use_rules(mesh, mapping):
            distribute_model(model, mesh, mapping)
            got, tally = collectives.count(run, model, batch)
        del model
    finally:
        lmesh.close_local_mesh()
    gc.collect()
    torch.cuda.empty_cache()
    tag = f"[shard] {what}: {arch} {layers} of {get_config(arch).num_layers}"
    if got["counts"] != plain["counts"]:
        raise AssertionError(f"{tag}: launches {got['counts']} on DTensors, "
                             f"{plain['counts']} on plain tensors")
    log(f"{tag} launches {got['counts']} on both; collectives "
        f"{tally.counts} (total {tally.total})")
    if tally.total:
        raise AssertionError(f"{tag}: a world of one issued collectives")
    for part in (k for k in plain if k != "counts"):
        bitwise, mx, rel, key = _distance(got[part], plain[part])
        limit = LOSS_REL_TOL if part in ("loss", "prefill") else GRAD_REL_L2
        ok = bitwise or rel <= limit
        how = "bitwise equal" if bitwise else (
            f"not bitwise: max abs {mx:.3e}, worst relative L2 {rel:.3e} "
            f"({key}; limit {limit:g})")
        log(f"{tag} {part} ({len(plain[part])} tensors) DTensor against "
            f"plain: {how} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag}: {part} disagrees")
    return plain["counts"]


def phase_shard():
    """Phase 3c: the sharded step on the world-of-one nccl mesh.  qwen3-8b
    at full width with SHARD_LAYERS layers and qwen3-moe-30b-a3b with
    SHARD_MOE_LAYERS (the MoE's dispatch and combine through
    ``local_map``): a bf16-compute train step on DTensors placed by
    ``TRAIN_RULES`` against the same step on plain tensors; then qwen3-8b's
    prefill and SHARD_DECODE_STEPS decode steps under ``DECODE_RULES``."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    t0 = time.perf_counter()
    rng = np.random.default_rng(TRAIN_SEED)
    for arch, layers in ((ARCH, SHARD_LAYERS), (MOE_ARCH, SHARD_MOE_LAYERS)):
        cfg = get_config(arch).replace(num_layers=layers)
        batch = _card_batch(_packed_rows(rng, TRAIN_BATCH, TRAIN_SEQ,
                                         cfg.vocab_size))
        calls = []
        local = moe.batch_local
        moe.batch_local = lambda *a, **k: calls.append(1) or local(*a, **k)
        try:
            counts = _sharded_against_plain(
                "train step", _train_once, arch, layers, "TRAIN_RULES", batch)
        finally:
            moe.batch_local = local
        if counts != _train_want(cfg, 2):
            raise AssertionError(f"{arch}: launches {counts}")
        if cfg.family == "moe":
            # routing, dispatch and combine, a layer, in the forward and
            # the recompute, of the loss's pass and of the train step's
            want = 3 * 2 * 2 * layers
            log(f"[shard] {arch}: the routing and _shmap_batch ran "
                f"local_map {len(calls)} times (want {want})")
            if len(calls) != want:
                raise AssertionError("the MoE did not run batch-local")
    cfg = get_config(ARCH)
    prompt = {k: v for k, v in _lm_batch(
        rng, cfg.vocab_size, np.ones((BATCH, PROMPT), np.int32)).items()
        if k != "labels"}
    counts = _sharded_against_plain(
        "prefill and decode", lambda m, b: _serve_once(m, b,
                                                       SHARD_DECODE_STEPS),
        ARCH, SHARD_LAYERS, "DECODE_RULES", prompt)
    want = _want(packed_attention=SHARD_LAYERS,
                 flash_decode=SHARD_LAYERS * SHARD_DECODE_STEPS)
    if counts != want:
        raise AssertionError(f"prefill and decode launched {counts}")
    if torch.distributed.is_initialized():
        raise AssertionError("the local mesh's process group outlived it")
    log(f"[shard] phase {time.perf_counter() - t0:.1f}s")


# -------------------------------------------------------- 3d. seqdecode
def _pieces(q, k, v, clen, n: int, check=None):
    """``flash_decode``'s partial on each of ``n`` contiguous pieces of a
    (b, kh, S, d) cache along S (views, read in place), each piece's
    cache_len made local; ``check(i, out, lse, k, v, lens)`` sees each."""
    from repro_torch.kernels import flash_decode
    step = k.shape[2] // n
    outs, lses = [], []
    for i in range(n):
        sl = slice(i * step, (i + 1) * step)
        lens = (clen - i * step).clamp(0, step).to(torch.int32)
        out, lse = _launch(flash_decode, flash_decode.flash_decode, q,
                           k[:, :, sl], v[:, :, sl], lens, return_lse=True)
        if check is not None:
            check(i, out, lse, k[:, :, sl], v[:, :, sl], lens)
        outs.append(out)
        lses.append(lse)
    return torch.stack(outs), torch.stack(lses)


def _stacked_merge(outs, lses):
    """``ops.merge_partials`` over the stacked pieces, in float32: (out,
    the lse of the whole)."""
    from repro_torch.kernels import ops
    out = ops.merge_partials(outs, lses, lambda t: t.amax(0, keepdim=True),
                             lambda t: t.sum(0, keepdim=True),
                             torch.float32)[0]
    return out, torch.logsumexp(lses, dim=0)


def _check_fd_partial(rng, b, h, kh, S, d, c_dt, lens, what: str):
    """flash_decode's (out, lse) against the plain version's on a whole
    (b, kh, S, d) cache and on each of SEQ_PIECES pieces (cache lengths
    ``lens``: pieces wholly past them, so local length 0, and lengths
    inside a tile); the output without lse bitwise the lse output cast to
    q's dtype; the pieces merged against the whole."""
    from repro_torch.kernels import flash_decode, ref
    q = torch.tensor(rng.normal(size=(b, h, d)), device="cuda").to(
        torch.bfloat16)
    cache = torch.tensor(rng.normal(size=(2, b, S, kh, d)),
                         device="cuda").to(c_dt)
    k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    clen = torch.tensor(lens, dtype=torch.int32, device="cuda")
    tag = f"flash_decode partial {what} b={b} h={h} kh={kh} d={d} " \
          f"cache={str(c_dt)[6:]}"

    def check(piece, out, lse, k, v, lens):
        want, want_lse = ref.flash_decode_ref(q, k, v, lens, return_lse=True)
        name = f"{tag} S={k.shape[2]} {piece} cache_len={lens.tolist()}"
        _check(f"{name} out (float32)", out, want, TOL[torch.float32])
        _check(f"{name} lse", lse, want_lse, LSE_TOL)
        if not bool(torch.isfinite(lse).all() and torch.isfinite(out).all()):
            raise AssertionError(f"{name}: not finite")
        plain = _launch(flash_decode, flash_decode.flash_decode, q, k, v,
                        lens)
        if not torch.equal(plain, out.to(q.dtype)):
            raise AssertionError(f"{name}: the output without lse is not "
                                 "the lse output cast to q's dtype")
    whole, whole_lse = _launch(flash_decode, flash_decode.flash_decode, q,
                               k, v, clen, return_lse=True)
    check("whole", whole, whole_lse, k, v, clen)
    outs, lses = _pieces(q, k, v, clen, SEQ_PIECES,
                         lambda i, *a: check(f"piece {i}", *a))
    out, lse = _stacked_merge(outs, lses)
    live = clen > 0      # the lse of no live position is NEG_INF, not merged
    _check(f"{tag} {SEQ_PIECES} pieces merged against the whole, out", out,
           whole, TOL[torch.float32])
    _check(f"{tag} {SEQ_PIECES} pieces merged against the whole, lse",
           lse[live], whole_lse[live], LSE_TOL)


def _seq_model():
    """qwen3-8b at full width and depth as ``serve.run`` builds it (its
    weights drawn from one seed in the dtypes the steps compute in) and its
    BATCH x PROMPT prompt."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_step import (
        COMPUTE_DTYPE, make_decode_step, make_prefill_step,
    )
    cfg = get_config(ARCH)
    model = build_model(cfg, torch.Generator("cuda").manual_seed(0),
                        COMPUTE_DTYPE)
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size, (BATCH, PROMPT)).astype(
        np.int32)
    pos = np.broadcast_to(np.arange(PROMPT, dtype=np.int32), (BATCH, PROMPT))
    batch = {"tokens": tokens, "segment_ids": np.ones_like(tokens),
             "positions": pos.copy()}
    return {"model": model, "prefill": make_prefill_step(model),
            "decode": make_decode_step(model),
            "batch": {k: torch.from_numpy(v).cuda() for k, v in batch.items()}}


def _check_seq_merge_model(served: dict):
    """qwen3-8b at full width: the float32 cache of PROMPT + GEN positions
    that a real BATCH x PROMPT prefill fills, then SEQ_DECODE_STEPS greedy
    decode steps.  At every layer of every step, the pieces' partials
    (SEQ_PIECES along the sequence, through the kernel) merged by
    ``ops.merge_partials`` against the kernel on the whole cache, in
    float32 before the cast, and that output cast against what
    ``ops.decode_attention`` returned to the model, bitwise."""
    from repro_torch.kernels import flash_decode, ops
    model, batch = served["model"], served["batch"]
    logits, kv = served["prefill"](batch)
    b, s = batch["tokens"].shape
    cache = model.init_cache(b, s + GEN, torch.float32)
    for n in ("k", "v"):
        cache[n][:, :, :s] = kv[n]
    del kv
    whole_path = ops.decode_attention
    worst = {"out": 0.0, "lse": 0.0}

    def checked(q, k, v, clen):
        got = whole_path(q, k, v, clen)
        whole, whole_lse = flash_decode.flash_decode(q, k, v, clen,
                                                     return_lse=True)
        if not torch.equal(got, whole.to(q.dtype)):
            raise AssertionError("ops.decode_attention is not the whole "
                                 "cache's float32 output cast")
        out, lse = _stacked_merge(*_pieces(q, k, v, clen, SEQ_PIECES))
        for key, a, w in (("out", out, whole), ("lse", lse, whole_lse)):
            worst[key] = max(worst[key], (a - w).abs().max().item())
        calls.append(clen[0].item())
        return got
    calls = []
    ops.decode_attention = checked
    try:
        cur = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        for t in range(s, s + SEQ_DECODE_STEPS):
            logits, cache = served["decode"](cache, cur, t)
            cur = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    finally:
        ops.decode_attention = whole_path
    torch.cuda.synchronize()
    layers = model.cfg.num_layers
    ok = worst["out"] <= TOL[torch.float32] and worst["lse"] <= LSE_TOL
    log(f"[seqdecode] {ARCH} full width, {layers} layers, {b} x {s} prefill "
        f"into a float32 cache of {s + GEN}, {SEQ_DECODE_STEPS} decode steps "
        f"(cache_len {sorted(set(calls))}): {len(calls)} attention calls, "
        f"{SEQ_PIECES} pieces of {(s + GEN) // SEQ_PIECES} merged against "
        f"the whole cache: max abs out {worst['out']:.3e} (atol "
        f"{TOL[torch.float32]:g}) lse {worst['lse']:.3e} (atol "
        f"{LSE_TOL:g}) {'ok' if ok else 'FAIL'}")
    if len(calls) != layers * SEQ_DECODE_STEPS or not ok:
        raise AssertionError("the merged pieces disagree with the whole "
                             "cache")
    if not torch.isfinite(logits.float()).all():
        raise AssertionError("decode logits not finite")


def _time_partials(smi: str):
    """Device ms (CUDA events around a graph replay) of flash_decode
    without and with lse, at the serve shape (one call a layer of the
    36-layer float32 cache, as ``_time_flash_decode``) and at the
    decode_32k block (bf16 cache, four copies so L2 holds none), and the
    block's byte bound."""
    from repro_torch.kernels import flash_decode
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, h, kh, S, d = SEQ_BLOCK
    shapes = {"serve": (BATCH, 32, 8, PROMPT + GEN, 128, torch.float32, 36),
              "decode_32k block": (b, h, kh, S, d, torch.bfloat16, 4)}
    for tag, (b, h, kh, S, d, dt, copies) in shapes.items():
        kc, vc = (torch.randn((copies, b, S, kh, d), generator=gen,
                              device="cuda").to(dt) for _ in range(2))
        q = torch.randn((b, h, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        clen = torch.full((b,), S, dtype=torch.int32, device="cuda")
        sets = [(q, kc[i].transpose(1, 2), vc[i].transpose(1, 2), clen)
                for i in range(copies)]
        iters = 10 * copies

        def with_lse(*a):
            return flash_decode.flash_decode(*a, return_lse=True)
        plain = _time_ms(flash_decode.flash_decode, sets, iters)
        lse = _time_ms(with_lse, sets, iters)
        again = _time_ms(flash_decode.flash_decode, sets, iters)
        kv_bytes = 2 * b * kh * S * d * kc.element_size()
        nbytes = kv_bytes + _nbytes(q, clen) + b * h * (d + 1) * 4
        log(f"[seqdecode] time {tag} b={b} h={h} kh={kh} S={S} d={d} "
            f"cache={str(dt)[6:]}: device ms without lse {plain[0]:.4f} "
            f"and {again[0]:.4f}, with lse {lse[0]:.4f}; bound "
            f"{nbytes / H100_BYTES_PER_S * 1e3:.4f} ms ({nbytes} B; K + V "
            f"{kv_bytes} B, {kv_bytes / H100_BYTES_PER_S * 1e3:.4f} ms); "
            f"{smi}")
        del kc, vc


def phase_seqdecode(served: dict):
    """Phase 3d: the KV-sequence-parallel decode's parts on the card (the
    collectives run on 4 gloo CPU ranks in tests/test_torch_sharded_step.py
    and on meta shards in the dry-run: the machine has one card).
    ``served``: qwen3-8b's model, steps and prompt."""
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    rng = np.random.default_rng(5)
    S = PROMPT + GEN
    piece = S // SEQ_PIECES
    _check_fd_partial(rng, BATCH, 32, 8, S, 128, torch.float32,
                      [S, piece + 1, 2 * piece + 9, 0], "serve shape")
    b, h, kh, S, d = SEQ_BLOCK
    piece = S // SEQ_PIECES
    _check_fd_partial(rng, b, h, kh, S, d, torch.bfloat16,
                      [S, 0, 1, 9, piece, piece + 13, 3 * piece - 1, S - 1],
                      "decode_32k block")
    _check_seq_merge_model(served)
    _time_partials(smi)
    log(f"[seqdecode] phase {time.perf_counter() - t0:.1f}s")


def main_seqdecode():
    """``--only seqdecode``: the two kernels the qwen3-8b prefill and
    decode run, built, and phase 3d on a freshly drawn qwen3-8b; nothing
    goes in the ``kernels`` line."""
    phase_build(("packed_attention", "flash_decode"))
    served = _seq_model()
    phase_seqdecode(served)
    return []


def main_shard():
    """``--only shard``: the three attention kernels' build and phase 3c;
    nothing is timed, so its ``kernels`` line is empty."""
    phase_build(("packed_attention", "packed_attention_bwd", "flash_decode"))
    phase_shard()
    return []


def main_dryrun():
    """``--only dryrun``: phase 3b alone; no kernel is built or launched."""
    phase_dryrun()
    return []


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=["wkv6", "train", "bwd",
                                           "trainer", "vlm", "moe",
                                           "rwkvtrain", "dense", "hybrid",
                                           "audio", "remat", "dryrun",
                                           "shard", "seqdecode"],
                        default=None, help="run only this path's builds, "
                        "checks and timing")
    args = parser.parse_args()
    name = phase_device()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    t0 = time.perf_counter()
    if args.only:
        kernels = {"wkv6": main_wkv6, "train": main_train,
                   "bwd": main_bwd, "trainer": main_trainer,
                   "vlm": main_vlm, "moe": main_moe,
                   "rwkvtrain": main_rwkvtrain,
                   "dense": main_dense, "hybrid": main_hybrid,
                   "audio": main_audio, "remat": main_remat,
                   "dryrun": main_dryrun, "shard": main_shard,
                   "seqdecode": main_seqdecode}[args.only]()
        log(f"[done] {time.perf_counter() - t0:.1f}s after the device check")
        print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return

    def stamp(what: str):
        log(f"[time] {what} done {time.perf_counter() - t0:.1f}s after the "
            "device check")
    phase_build()
    phase_check()
    phase_check_train()
    phase_check_moe()
    phase_check_rwkv_train()
    phase_check_dense()
    phase_check_hybrid()
    phase_check_audio()
    phase_check_remat()
    stamp("the checks")
    phase_dryrun()
    stamp("phase 3b")
    phase_shard()
    stamp("phase 3c")
    paths = {}          # each path's launch counts, from its own zeroed run
    paths[f"serve:{ARCH}"], served = phase_serve(ARCH, prompt=PROMPT)
    phase_trace_prefill(ARCH, served)
    phase_trace_decode(ARCH, served)
    phase_seqdecode(served)
    stamp("phase 3d")
    del served          # frees the 16.4 GB of bf16 qwen3-8b weights
    paths.update(_serve_traced((RWKV_ARCH,), PROMPT))
    paths.update(_serve_traced((VLM_ARCH,)))
    paths.update(phase_serve_moe())
    paths.update(phase_serve_dense())
    paths.update(phase_serve_hybrid())
    paths.update(phase_serve_audio())
    stamp("the serve runs")
    paths[f"train:{ARCH}"], seg = phase_train()
    paths[f"trainer:{ARCH}"], _ = phase_trainer()
    stamp("phases 6 and 8")
    paths.update(phase_trainer_vlm()[0])
    paths[f"trainer:{TMOE_ARCH}"], _ = phase_trainer_moe()
    paths[RWKV_TRAIN_PATH], rwkv_seg = phase_trainer_rwkv()
    stamp("phases 9, 12 and 13")
    paths[QWEN32_TRAIN_PATH], _ = phase_trainer_dense()
    paths[ZAMBA_TRAIN_PATH], _ = phase_trainer_hybrid()
    paths[WHISPER_TRAIN_PATH] = phase_train_whisper()
    stamp("phases 14, 15 and 16")
    paths[f"loss:{ARCH}:data-vocab-{LOSS_VOCAB}"] = phase_loss()
    paths["example:train_e2e_torch"] = phase_example()
    stamp("phases 10 and 11")
    log(f"[done] launches by path: {paths}")
    kernels = phase_time(paths, seg, rwkv_seg)
    log(f"[done] {time.perf_counter() - t0:.1f}s after the device check")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
