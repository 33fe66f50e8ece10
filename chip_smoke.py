"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --only wkv6
    python3 chip_smoke.py --only train
    python3 chip_smoke.py --only bwd
    python3 chip_smoke.py --only trainer

Phases (any failure raises, and the exit code is not 0):
  1. device  — the card's name, count and power limit; no card, no run.
  2. build   — nvcc builds the four CUDA kernels of ``src/repro_torch/
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
               ``ref.packed_attention_live_tiles``; the kernels with no backward raising under grad;
               qwen3-8b at full width with 2 layers, loss and every
               gradient, kernels against plain attention; reduced qwen3-8b
               memorising one batch through the kernels.
  4. serve   — ``repro_torch.launch.serve`` on qwen3-8b (36 layers, d_model
               4096) and then on rwkv6-3b (32 layers, d_model 2560), each at
               its published width and depth with random weights from a
               seed: batch 4, prompt 512, 32 greedy tokens.  Every kernel's
               launch count is set to 0 just before each run and read just
               after; the counts must show the path went through the
               kernels.
  5. trace   — torch.profiler over one prefill and over decode steps of
               each serve run's own model and cache: the device's busy
               share, the share of the hand-written kernels, and the
               kernels that take its time.
  6. train   — qwen3-8b at full width with 8 of its 36 layers, AdamW on
               float32 master weights: 5 steps through ``train_step`` on
               one packed batch of 4 x 1024 (counts set to 0 before, read
               after: 8 forward and 8 backward launches a step), losses,
               step time, tokens/s and peak memory; one step by its parts
               (forward, backward, update) and one under the profiler.
  8. trainer — the same model (freed and drawn again) trained by
               ``repro_torch.train.trainer.Trainer`` from a live Overlord
               (the port's copy of the data plane: four coyo-like sources,
               DP 4 x 1 row x 1024, 96 samples a step, a strict delivery
               ledger): 8 steps with the counts set to 0 before and read
               after (8 forward and 8 backward launches a step), finite
               losses, every batch holding tokens, the ledger verified;
               each batch's fill, documents and per-row sum of squared
               document lengths; one step under the profiler with its
               batch fetch, one without, and one with the data plane shut
               down.  Then
               ``repro_torch.launch.train`` at the reduced size on the card
               (100 steps: the loss must close a share of its gap to
               ln(V - 1), the floor on the data plane's uniform tokens)
               and a bitwise checkpoint round trip of its trainer.
  7. time    — each kernel at the serving shapes (CUDA events around a
               CUDA-graph replay, and around eager calls), beside its plain
               version, one PyTorch library call where there is one, and
               its bound; the backward kernel at the training shape.
               Runs after phase 8, so every record has its count there.
The line before the last is a JSON ``kernels`` record: each kernel's
``launches`` is its count on the path the record is timed on
(``launches_path``: packed_attention and flash_decode on the qwen3-8b
serve run, wkv6 on the rwkv6-3b one, packed_attention_bwd on the training
run, 5 steps), and ``launches_by_path`` its count on every path
(``trainer:qwen3-8b`` is phase 8), each read from its own zeroed run; the
last line is ``{"ok": true, "device": {...}}``.

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
# the training rows' documents: the text-token log-normal (mu, sigma) of
# each source of coyo_like_specs(4), the group the JAX package's training
# launcher reads by default (src/repro/launch/train.py:58), as
# src/repro/data/sources.py:43-53 draws them from default_rng(0); the
# lengths carry Fig. 2's skew (most documents short, a long tail)
COYO_TEXT = ((3.0821770123928727, 1.2), (2.7099165813171173, 1.2),
             (3.0639814654603077, 1.2), (3.2610434542726607, 1.2))


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


def _check_flash_decode():
    """The old cases, then every GQA group size the head chunking meets
    (1, 4, 6 and 16 q heads per kv head), cache_len 1, just past a tile and
    just past a split, and a long cache whose warps walk several tiles
    (the two-stage ring)."""
    from repro_torch.kernels import flash_decode, ref
    rng = np.random.default_rng(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dtypes = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
              (torch.bfloat16, torch.bfloat16)]      # (q, cache)
    cases = [(4, 32, 8, 1100, 128, None), (3, 16, 2, 300, 64, None),
             (2, 4, 4, 70, 80, None)]
    for b, h, kh, S, d in [(4, 16, 16, 300, 128), (4, 16, 4, 300, 128),
                           (4, 12, 2, 200, 64), (4, 32, 2, 300, 128),
                           (4, 32, 8, 4096, 128)]:
        plan = flash_decode.split_plan(b, kh, h // kh, S, sms)
        lens = [1, flash_decode.TILE_ROWS + 1, plan.split_len + 1, S]
        cases.append((b, h, kh, S, d, [min(n, S) for n in lens]))
    for b, h, kh, S, d, lens in cases:
        plan = flash_decode.split_plan(b, kh, h // kh, S, sms)
        for q_dt, c_dt in dtypes:
            q = torch.tensor(rng.normal(size=(b, h, d)), device="cuda").to(
                q_dt)
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


def _check_reduced_slice():
    """Reduced qwen3-8b, float32: prefill and 24 decode steps with the
    kernels on the card against the plain versions on the CPU, same
    weights; logits to 2e-3 (tests/test_models.py)."""
    from repro_torch.configs.qwen3_8b import reduced
    from repro_torch.models.model_zoo import build_model
    cfg = reduced()
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
    _check("reduced qwen3-8b slice, card vs CPU plain", outs[0], outs[1],
           2e-3)


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
def _data_plane_segs(rng, b, s):
    """Packed training rows as the data plane makes them: each document
    from one of ``COYO_TEXT``'s sources, chosen uniformly (the launcher's
    equal-weight schedule), with its text length drawn as
    src/repro/data/sources.py:73-75 draws it and cut to ``s``
    (src/repro/data/packing.py:56); documents are drawn until they hold as
    many tokens as the rows, then packed first-fit in draw order, and a
    document that fits no row is dropped (packing.py:39-69).  Segment ids
    count from 1 in each row; the rest of a row is padding (0)."""
    seg = np.zeros((b, s), np.int32)
    fill, count, drawn = [0] * b, [0] * b, 0
    while drawn < b * s:
        mu, sigma = COYO_TEXT[rng.integers(len(COYO_TEXT))]
        n = min(int(np.clip(rng.lognormal(mu, sigma), 1, 8192)), s)
        drawn += n
        row = next((r for r in range(b) if fill[r] + n <= s), None)
        if row is None:
            continue
        count[row] += 1
        seg[row, fill[row]:fill[row] + n] = count[row]
        fill[row] += n
    return seg


def _lm_batch(rng, vocab: int, seg: np.ndarray,
              next_token: bool = False) -> dict:
    """A packed LM batch on the card: positions restart at every segment;
    labels -1 on padding and, as tests/conftest.make_lm_batch makes them,
    the tokens themselves, or with ``next_token`` each segment's next
    tokens and -1 on its last, as the data plane packs them
    (src/repro/data/packing.py:66)."""
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


def _check_pa_bwd(rng, b, h, kh, sq, sk, d, causal, q_seg, kv_seg, what="",
                  dout=None):
    """The backward kernel against both plain versions, bf16: the forward's
    lse against ``packed_attention_lse_ref``, then dq, dk, dv against
    ``packed_attention_bwd_ref`` (on the kernel's own out and lse) and
    against autograd of ``packed_attention_ref``; two calls on the same
    inputs must agree bit for bit, and the live tiles the kernel reports
    must be the mirror's.  ``dout``: drawn like q unless given."""
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
    plain = ref.packed_attention_bwd_ref(q, k, v, out, lse, dout, q_seg,
                                         kv_seg, causal=causal)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    ref.packed_attention_ref(*leaves, q_seg, kv_seg, causal=causal
                             ).backward(dout)
    err = 0.0
    for name, g, p_, a in zip(("dq", "dk", "dv"), got, plain, leaves):
        err = max(err, _check(f"{tag}: {name} vs packed_attention_bwd_ref", g,
                              p_, TOL[bf]),
                  _check(f"{tag}: {name} vs autograd of "
                         "packed_attention_ref", g, a.grad, TOL[bf]))
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


def _check_grad_guards():
    """Fault C1: under grad, the kernels with no backward raise on the card
    (before they build or launch anything)."""
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
        "wkv6": lambda: ops.wkv6(x, x, x, x, x[0, 0, :4], reset, chunk=16),
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


def _check_full_width_grads():
    """qwen3-8b at full width with 2 layers, one packed batch of 2 x 1024:
    the loss and every leaf's gradient with the kernels against the plain
    attention on the same weights (relative L2 <= GRAD_REL_L2)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.train_step import init_train_state, make_loss_fn
    cfg = get_config(ARCH).replace(num_layers=2)
    model = build_model(cfg, torch.Generator(device="cuda").manual_seed(5))
    state = init_train_state(model)
    rng = np.random.default_rng(5)
    batch = _lm_batch(rng, cfg.vocab_size,
                      _data_plane_segs(rng, 2, TRAIN_SEQ), next_token=True)
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
    if counts["packed_attention"] != 2 or counts["packed_attention_bwd"] != 2:
        raise AssertionError(f"2-layer step launched {counts}")
    with _plain_attention():
        loss_p, grads_p = run()
    if _launch_counts() != counts:
        raise AssertionError("the plain run launched a kernel")
    rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"[check] qwen3-8b 2 layers full width, kernels vs plain attention: "
        f"loss {loss_k:.6f} vs {loss_p:.6f} relative {rel:.3e} (limit "
        f"{LOSS_REL_TOL:g}) {'ok' if rel <= LOSS_REL_TOL else 'FAIL'}")
    worst = max(((torch.linalg.vector_norm(grads_k[n] - grads_p[n])
                  / torch.linalg.vector_norm(grads_p[n])).item(), n)
                for n in grads_p)
    log(f"[check] qwen3-8b 2 layers full width, kernels vs plain attention: "
        f"worst gradient relative L2 {worst[0]:.3e} ({worst[1]}; limit "
        f"{GRAD_REL_L2:g}) {'ok' if worst[0] <= GRAD_REL_L2 else 'FAIL'}")
    if rel > LOSS_REL_TOL or not worst[0] <= GRAD_REL_L2:
        raise AssertionError("full-width gradients disagree with the plain "
                             "path")


def _check_memorise():
    """Reduced qwen3-8b (head_dim 16) memorises one batch on the card
    through the kernels: the loss falls below 0.8x its first value in 12
    steps (tests/test_train.py:50-66)."""
    from repro_torch.configs.qwen3_8b import reduced
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    cfg = reduced()
    model = build_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    state = init_train_state(model)
    step = make_train_step(model, AdamWConfig(peak_lr=5e-3, warmup_steps=5,
                                              total_steps=100))
    seg = np.ones((4, 64), np.int32)       # make_lm_batch(cfg, 4, 64)
    seg[:, 30:60], seg[:, 60:] = 2, 0
    batch = _lm_batch(np.random.default_rng(3), cfg.vocab_size, seg)
    _zero_launch_counts()
    losses = []
    for _ in range(12):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    counts = _launch_counts()
    want = 12 * cfg.num_layers
    ok = (losses[-1] < 0.8 * losses[0] and np.isfinite(losses).all()
          and counts["packed_attention"] == want
          and counts["packed_attention_bwd"] == want)
    log(f"[check] reduced qwen3-8b memorises one batch on the card: losses "
        f"{[round(x, 4) for x in losses]}, launches {counts} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("reduced qwen3-8b did not memorise its batch "
                             "through the kernels")


def phase_check_train():
    _check_packed_attention_bwd()
    _check_grad_guards()
    _check_full_width_grads()
    torch.cuda.empty_cache()
    _check_memorise()


# ------------------------------------------------------------- 4. serve
def _launch_counts() -> dict:
    from repro_torch.kernels import (flash_decode, packed_attention,
                                     packed_attention_bwd, wkv6)
    return {"packed_attention": packed_attention.launches,
            "packed_attention_bwd": packed_attention_bwd.launches,
            "flash_decode": flash_decode.launches, "wkv6": wkv6.launches}


def _zero_launch_counts():
    from repro_torch.kernels import (flash_decode, packed_attention,
                                     packed_attention_bwd, wkv6)
    packed_attention.launches = packed_attention_bwd.launches = 0
    flash_decode.launches = wkv6.launches = 0


def phase_serve(arch: str) -> tuple[dict, dict]:
    """Serve ``arch`` at full width through ``serve.main``, with every
    kernel's count set to 0 just before and read just after."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t0 = time.perf_counter()
    out = serve.main(["--arch", arch, "--batch", str(BATCH), "--prompt-len",
                      str(PROMPT), "--gen", str(GEN)])
    counts = _launch_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] {arch} layers={cfg.num_layers} d_model={cfg.d_model} "
        f"batch={BATCH} prompt={PROMPT} gen={GEN} ({wall:.1f}s in serve.main,"
        f" weights drawn and cast included)")
    log(f"[serve] {arch} prefill_s={out['prefill_s']:.4f} "
        f"decode_tok_s={out['decode_tok_s']:.2f} "
        f"(decode_s={out['decode_s']:.4f} for {GEN} steps x {BATCH} seqs) "
        f"max_memory_allocated={peak} B ({peak / 2**30:.2f} GiB)")
    log(f"[serve] {arch} greedy tokens: {out['tokens'].tolist()}")
    log(f"[serve] {arch} launches on the path: {counts}")
    L = cfg.num_layers
    if cfg.family == "ssm":     # the WKV kernel once per layer, in prefill
        want = {"packed_attention": 0, "packed_attention_bwd": 0,
                "flash_decode": 0, "wkv6": L}
    else:
        want = {"packed_attention": L, "packed_attention_bwd": 0,
                "flash_decode": L * (PROMPT + GEN), "wkv6": 0}
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != expected {want}")
    for key in ("prefill_logits", "logits"):
        if not torch.isfinite(out[key].float()).all():
            raise AssertionError(f"serve {key} not finite")
    if out["tokens"].shape != (BATCH, GEN) or not (
            (out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all():
        raise AssertionError(f"bad greedy tokens {out['tokens'].shape}")
    return counts, out


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


def _time_packed_attention(cfg, launches: int) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import packed_attention, ref
    b, s, h, kh, d = BATCH, PROMPT, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim()
    dt = torch.bfloat16
    rng = np.random.default_rng(2)
    seg = torch.ones((b, s), dtype=torch.int32, device="cuda")  # serve's
    sets = [(_bshd(rng, b, s, h, d, dt), _bshd(rng, b, s, kh, d, dt),
             _bshd(rng, b, s, kh, d, dt), seg, seg) for _ in range(4)]
    q, k, v = sets[0][:3]
    got = packed_attention.packed_attention(q, k, v, seg, seg)
    err = _check("packed_attention serve shape", got,
                 ref.packed_attention_ref(q, k, v, seg, seg), TOL[dt])
    ms = _time_ms(packed_attention.packed_attention, sets, 40)
    plain_ms = _time_ms(ref.packed_attention_ref, sets, 10)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device="cuda"))
    mask = mask[None, None] & (seg[:, None, :, None] == seg[:, None, None, :])

    def library(q, k, v, *_):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    lib_ms = _time_ms(library, sets, 40)
    pairs = b * h * s * (s + 1) // 2   # one segment per row, causal
    flops = 4 * d * pairs
    nbytes = _nbytes(q, k, v, got, seg, seg)
    return _record("packed_attention", "packed_attention.cu",
                   "src/repro/kernels/packed_attention.py:122", launches,
                   err, ms, plain_ms, lib_ms, nbytes, flops, PEAK_FLOPS[dt])


def _time_flash_decode(cfg, launches: int) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode, ref
    b, h, kh, d = BATCH, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim()
    S = PROMPT + GEN        # the final decode step attends to all of it
    gen = torch.Generator(device="cuda").manual_seed(3)
    shape = (cfg.num_layers, b, S, kh, d)   # the serve cache, float32
    kc = torch.randn(shape, generator=gen, device="cuda")
    vc = torch.randn(shape, generator=gen, device="cuda")
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    clen = torch.full((b,), S, dtype=torch.int32, device="cuda")
    sets = [(q, kc[i].transpose(1, 2), vc[i].transpose(1, 2), clen)
            for i in range(cfg.num_layers)]   # one layer's slice per call
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


def _time_wkv6(cfg, launches) -> dict:
    from repro_torch.kernels import ref, wkv6
    b, s, dk, chunk = BATCH, PROMPT, cfg.rwkv_head_dim, cfg.rwkv_chunk
    h = cfg.d_model // dk
    rng = np.random.default_rng(6)
    serve_seg = np.ones((b, s), np.int32)          # one segment per row
    sets = [_wkv6_inputs(rng, b, s, h, dk, serve_seg) for _ in range(4)]

    def kernel(*a):
        return wkv6.wkv6(*a, chunk=chunk, return_state=True)

    def plain(*a):
        return ref.wkv6_chunked(*a[:5], chunk=chunk, reset=a[5],
                                return_state=True)
    got, exp = kernel(*sets[0]), plain(*sets[0])
    err = max(_check("wkv6 serve shape, o", got[0], exp[0], *WKV_TOL),
              _check("wkv6 serve shape, final state", got[1], exp[1],
                     *WKV_TOL))
    ms = _time_ms(kernel, sets, 40)
    plain_ms = _time_ms(plain, sets, 8)
    nbytes = _nbytes(*sets[0], *got)
    flops = _wkv6_flops(sets[0][5], h, dk, chunk)
    return _record("wkv6", "wkv6.cu", "src/repro/kernels/wkv6.py:90",
                   launches, err, ms, plain_ms, None, nbytes, flops,
                   PEAK_FLOPS[torch.float32],
                   no_library="no single PyTorch call computes WKV6")


# the path each record is timed on; its ``launches`` is that path's count
RECORD_PATH = {"packed_attention": f"serve:{ARCH}",
               "flash_decode": f"serve:{ARCH}",
               "wkv6": f"serve:{RWKV_ARCH}",
               "packed_attention_bwd": f"train:{ARCH}"}


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


def phase_time(paths: dict, train_seg: np.ndarray) -> list:
    from repro_torch.configs import get_config
    qwen, rwkv = get_config(ARCH), get_config(RWKV_ARCH)
    torch.cuda.empty_cache()
    return [_with_paths(r, paths) for r in (
        _time_packed_attention(qwen, paths[f"serve:{ARCH}"][
            "packed_attention"]),
        _time_flash_decode(qwen, paths[f"serve:{ARCH}"]["flash_decode"]),
        _time_wkv6(rwkv, paths[f"serve:{RWKV_ARCH}"]["wkv6"]),
        _time_packed_attention_bwd(qwen, paths[f"train:{ARCH}"][
            "packed_attention_bwd"], train_seg))]


# ------------------------------------------------------------- 6. train
def _events():
    return torch.cuda.Event(enable_timing=True)


def phase_train() -> tuple[dict, np.ndarray]:
    """qwen3-8b at full width with TRAIN_LAYERS of its 36 layers, AdamW on
    float32 master weights, TRAIN_STEPS steps through ``train_step`` on one
    packed batch of TRAIN_BATCH x TRAIN_SEQ (the data plane's documents,
    ``_data_plane_segs``; next-token labels, -1 on padding and on each
    segment's last token), every kernel's count set to 0 just before the
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
    seg = _data_plane_segs(rng, TRAIN_BATCH, TRAIN_SEQ)
    batch = _lm_batch(rng, cfg.vocab_size, seg, next_token=True)
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
    want = {"packed_attention": cfg.num_layers * TRAIN_STEPS,
            "packed_attention_bwd": cfg.num_layers * TRAIN_STEPS,
            "flash_decode": 0, "wkv6": 0}
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
def _trainer_plane(root: str, cfg):
    """The data plane of the trainer phase, from the port's copy of the
    Overlord: the four coyo-like sources the JAX launcher reads by default,
    equal weights, DP ``TRAIN_BATCH`` with one row and one bin a bucket (a
    global batch of TRAIN_BATCH x TRAIN_SEQ), ``TRAINER_SAMPLES`` samples a
    step, balanced by ``backbone_cost`` of the depth-cut config that trains,
    a strict delivery ledger, and no launch-time analysis (not ported)."""
    from repro_torch.core import (ClientPlaceTree, Overlord, OverlordConfig,
                                  StaticSchedule)
    from repro_torch.data.cost_models import backbone_cost
    from repro_torch.data.sources import coyo_like_specs, materialize_group
    specs = coyo_like_specs(4)
    paths = materialize_group(specs, root)
    tree = ClientPlaceTree([("PP", 1), ("DP", TRAIN_BATCH), ("CP", 1),
                            ("TP", 1)])
    return Overlord(paths, tree, StaticSchedule({s.name: 1.0 for s in specs}),
                    OverlordConfig(
                        seq_len=TRAIN_SEQ, rows_per_microbatch=1, n_bins=1,
                        samples_per_step=TRAINER_SAMPLES,
                        strategy="backbone_balance",
                        strategy_params=dict(costfn=backbone_cost(cfg),
                                             broadcast=()),
                        vocab_size=cfg.vocab_size, ledger=True),
                    validate=False)


def _row_stats(seg: np.ndarray) -> str:
    """Fill, documents, and the rows' sum of squared document lengths (the
    attention cost the balancer evens out), max over mean."""
    lens = [np.bincount(r[r > 0])[1:] for r in seg]
    sq = np.array([float((n.astype(np.int64) ** 2).sum()) for n in lens])
    return (f"fill={(seg > 0).mean():.4f} documents="
            f"{sum(int((n > 0).sum()) for n in lens)} sum_l2 per row "
            f"{sq.astype(int).tolist()} max/mean={sq.max() / sq.mean():.4f}")


def _profiled(fn) -> tuple[str, float]:
    """``fn()`` once under the profiler: wall ms, the device's busy ms and
    share, and its launches; returns them as text, and what ``fn``
    returned."""
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
    from repro_torch.train.trainer import Trainer, TrainerConfig
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
    first, last, share = _gap_closed([r["loss"] for r in hist],
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
    want = {"packed_attention": cfg.num_layers * TRAINER_STEPS,
            "packed_attention_bwd": cfg.num_layers * TRAINER_STEPS,
            "flash_decode": 0, "wkv6": 0}
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


def _gap_closed(losses, vocab: int) -> tuple[float, float, float]:
    """The means of the first and last five ``losses``, and the share of
    the gap from the first mean to ln(``vocab`` - 1) that the last closed:
    the data plane's tokens are uniform on [1, vocab), so ln(vocab - 1)
    is the least loss a model can reach on documents it has not seen."""
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    return first, last, (first - last) / (first - float(np.log(vocab - 1)))


def _check_reduced_launcher():
    """``launch.train.main`` at the reduced size on the card, through the
    kernels, for LAUNCHER_STEPS steps with the JAX launcher's defaults: the
    loss must close LAUNCHER_GAP_SHARE of its gap to ln(V - 1)
    (``_gap_closed``); then a checkpoint of its trainer loads into a fresh
    one bitwise."""
    from repro_torch.configs.qwen3_8b import reduced
    from repro_torch.launch import train
    cfg = reduced()
    _zero_launch_counts()
    out = train.main(["--reduced", "--steps", str(LAUNCHER_STEPS)])
    counts = _launch_counts()
    losses = [r["loss"] for r in out["history"]]
    first, last, share = _gap_closed(losses, cfg.vocab_size)
    log(f"[trainer] reduced launcher on {out['trainer'].device}: losses "
        f"{losses}; mean of the first 5 {first}, of the last 5 {last}, "
        f"ln(V - 1) {np.log(cfg.vocab_size - 1)}: {share:.4f} of the gap "
        f"closed (at least {LAUNCHER_GAP_SHARE}); launches {counts}")
    want = LAUNCHER_STEPS * cfg.num_layers
    if out["trainer"].device.type != "cuda" or counts[
            "packed_attention"] != want or counts[
            "packed_attention_bwd"] != want:
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
    exp = ref.packed_attention_bwd_ref(*sets[0])
    err = max(_check(f"packed_attention_bwd training shape {name}", g, e,
                     TOL[bf]) for name, g, e in zip(("dq", "dk", "dv"), got,
                                                    exp))
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
    its float32 cache, at the first positions the serve run decoded
    (``PROMPT ..``), so attention reads the cache length it read there:
    wall time per step, the device's busy share, and device time by kernel.
    Rewriting those cache rows (or stepping the RWKV state on) changes no
    shape or launch."""
    from torch.profiler import ProfilerActivity, profile
    decode, cache = served["decode"], served["cache"]
    tokens = torch.ones((BATCH, 1), dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(PROMPT, PROMPT + steps):
            decode(cache, tokens, t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = _device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    log(f"[trace] {arch} decode step at positions {PROMPT}..{PROMPT + steps}"
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
    log(f"[trace] {arch} prefill {BATCH}x{PROMPT}: wall_ms={wall_ms:.3f} "
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
    seg = _data_plane_segs(np.random.default_rng(TRAIN_SEED), TRAIN_BATCH,
                           TRAIN_SEQ)
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=["wkv6", "train", "bwd",
                                           "trainer"],
                        default=None, help="run only this path's builds, "
                        "checks and timing")
    args = parser.parse_args()
    name = phase_device()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    t0 = time.perf_counter()
    if args.only:
        kernels = {"wkv6": main_wkv6, "train": main_train,
                   "bwd": main_bwd, "trainer": main_trainer}[args.only]()
        log(f"[done] {time.perf_counter() - t0:.1f}s after the device check")
        print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return
    phase_build()
    phase_check()
    phase_check_train()
    paths = {}          # each path's launch counts, from its own zeroed run
    paths[f"serve:{ARCH}"], served = phase_serve(ARCH)
    phase_trace_prefill(ARCH, served)
    phase_trace_decode(ARCH, served)
    del served          # frees the 16.4 GB of bf16 qwen3-8b weights
    paths[f"serve:{RWKV_ARCH}"], served = phase_serve(RWKV_ARCH)
    phase_trace_prefill(RWKV_ARCH, served)
    phase_trace_decode(RWKV_ARCH, served)
    del served          # frees the 6.2 GB of bf16 rwkv6-3b weights
    paths[f"train:{ARCH}"], seg = phase_train()
    paths[f"trainer:{ARCH}"], _ = phase_trainer()
    log(f"[done] launches by path: {paths}")
    kernels = phase_time(paths, seg)
    log(f"[done] {time.perf_counter() - t0:.1f}s after the device check")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
