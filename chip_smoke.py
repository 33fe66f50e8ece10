"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is not 0):
  1. device  — the card's name, count and power limit; no card, no run.
  2. build   — nvcc builds every CUDA kernel from ``src/repro_torch/kernels/
               csrc`` (in parallel) into ``build/repro_torch_kernels``.
  3. check   — each kernel against its plain PyTorch version on the card,
               at qwen3-8b head shapes and more, TF32 off; then reduced
               qwen3-8b prefill + decode on the card against the CPU.
  4. serve   — ``repro_torch.launch.serve`` on qwen3-8b at its published
               width and depth (36 layers, d_model 4096), random weights
               from a seed: batch 4, prompt 512, 32 greedy tokens.  The
               kernels' launch counts must show the path went through them.
  5. trace   — torch.profiler over decode steps of the serve run's own
               model and cache, at its own cache positions: the device's
               busy share and the kernels that take its time.
  6. time    — each kernel at the serving shapes (CUDA events around a
               CUDA-graph replay, and around eager calls), beside its plain
               version, one PyTorch library call, and its bound.
The line before the last is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
ARCH, BATCH, PROMPT, GEN = "qwen3-8b", 4, 512, 32


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
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {sorted(logs) or 'nothing stale'} in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
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


def _check(name, got, exp, tol) -> float:
    if got.dtype != exp.dtype or got.shape != exp.shape:
        raise AssertionError(f"{name}: got {got.dtype} {tuple(got.shape)}, "
                             f"want {exp.dtype} {tuple(exp.shape)}")
    err = (got.float() - exp.float()).abs().max().item()
    ok = torch.allclose(got.float(), exp.float(), atol=tol, rtol=tol)
    log(f"[check] {name}: max_abs_err={err:.3e} tol={tol:g} (atol=rtol) "
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
    from repro_torch.kernels import flash_decode, packed_attention, ref
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
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
        q, k, v = (_bshd(rng, b, sq, h, d, dt), _bshd(rng, b, sk, kh, d, dt),
                   _bshd(rng, b, sk, kh, d, dt))
        q_seg = torch.tensor(_segs(rng, b, sq), device="cuda")
        kv_seg = q_seg if sq == sk else torch.tensor(_segs(rng, b, sk),
                                                     device="cuda")
        got = _launch(packed_attention, packed_attention.packed_attention,
                      q, k, v, q_seg, kv_seg, causal=causal)
        exp = ref.packed_attention_ref(q, k, v, q_seg, kv_seg, causal=causal)
        _check(f"packed_attention b={b} h={h} kh={kh} sq={sq} sk={sk} d={d} "
               f"{str(dt)[6:]} causal={causal}", got, exp, TOL[dt])

    dtypes = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
              (torch.bfloat16, torch.bfloat16)]      # (q, cache)
    for b, h, kh, S, d in [(4, 32, 8, 1100, 128), (3, 16, 2, 300, 64),
                           (2, 4, 4, 70, 80)]:
        for q_dt, c_dt in dtypes:
            q = torch.tensor(rng.normal(size=(b, h, d)), device="cuda").to(
                q_dt)
            cache = torch.tensor(rng.normal(size=(2, 2, b, S, kh, d)),
                                 device="cuda").to(c_dt)  # (kv, layers, ...)
            kc, vc = cache[0, 1].transpose(1, 2), cache[1, 1].transpose(1, 2)
            clen = torch.tensor(rng.integers(1, S + 1, size=(b,)),
                                dtype=torch.int32, device="cuda")
            clen[0] = S
            got = _launch(flash_decode, flash_decode.flash_decode, q, kc, vc,
                          clen)
            exp = ref.flash_decode_ref(q, kc, vc, clen)
            _check(f"flash_decode b={b} h={h} kh={kh} S={S} d={d} "
                   f"q={str(q_dt)[6:]} cache={str(c_dt)[6:]} "
                   f"cache_len={clen.tolist()}", got, exp, TOL[q_dt])
    _check_reduced_slice()


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


# ------------------------------------------------------------- 4. serve
def phase_serve() -> tuple[dict, dict]:
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode, packed_attention
    from repro_torch.launch import serve
    cfg = get_config(ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    packed_attention.launches = 0
    flash_decode.launches = 0
    out = serve.main(["--arch", ARCH, "--batch", str(BATCH), "--prompt-len",
                      str(PROMPT), "--gen", str(GEN)])
    counts = {"packed_attention": packed_attention.launches,
              "flash_decode": flash_decode.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] {ARCH} layers={cfg.num_layers} d_model={cfg.d_model} "
        f"batch={BATCH} prompt={PROMPT} gen={GEN}")
    log(f"[serve] prefill_s={out['prefill_s']:.4f} "
        f"decode_tok_s={out['decode_tok_s']:.2f} "
        f"(decode_s={out['decode_s']:.4f} for {GEN} steps x {BATCH} seqs) "
        f"max_memory_allocated={peak} B ({peak / 2**30:.2f} GiB)")
    log(f"[serve] greedy tokens: {out['tokens'].tolist()}")
    log(f"[serve] launches on the path: {counts}")
    want = {"packed_attention": cfg.num_layers,
            "flash_decode": cfg.num_layers * (PROMPT + GEN)}
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != expected {want}")
    for key in ("prefill_logits", "logits"):
        if not torch.isfinite(out[key].float()).all():
            raise AssertionError(f"serve {key} not finite")
    if out["tokens"].shape != (BATCH, GEN) or not (
            (out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all():
        raise AssertionError(f"bad greedy tokens {out['tokens'].shape}")
    return counts, out


# -------------------------------------------------------------- 6. time
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
            nbytes, flops, peak) -> dict:
    """``ms``, ``plain_ms`` and ``lib_ms`` are (device, eager) pairs; the
    record keeps the device times."""
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    rec = {"name": name, "route": "cuda",
           "source": f"src/repro_torch/kernels/csrc/{src}",
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": ms[0], "plain_ms": plain_ms[0],
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": lib_ms[0]}
    log(f"[time] {name}: device ms={ms[0]:.4f} plain_ms={plain_ms[0]:.4f} "
        f"library_ms={lib_ms[0]:.4f} bound_ms={rec['bound_ms']:.4f} "
        f"({rec['bound_by']}: {nbytes} B, {flops} FLOP) launches={launches} "
        f"max_abs_err={err:.3e}")
    log(f"[time] {name}: eager ms (host overhead included)={ms[1]:.4f} "
        f"plain={plain_ms[1]:.4f} library={lib_ms[1]:.4f}")
    return rec


def phase_time(counts: dict) -> list:
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    torch.cuda.empty_cache()
    return [_time_packed_attention(cfg, counts["packed_attention"]),
            _time_flash_decode(cfg, counts["flash_decode"])]


# ------------------------------------------------------------- 5. trace
def phase_trace(served: dict, steps: int = 4):
    """Profile ``steps`` decode steps of the serve run's own bf16 model on
    its float32 cache, at the first positions the serve run decoded
    (``PROMPT ..``), so attention reads the cache length it read there:
    wall time per step, the device's busy share, and device time by kernel.
    Rewriting those cache rows changes no shape or launch."""
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
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    log(f"[trace] decode step at cache positions {PROMPT}..{PROMPT + steps}: "
        f"wall_ms={wall_ms:.3f} (profiler on) "
        f"device_busy_ms={busy_ms:.3f} busy_share={busy_ms / wall_ms:.4f} "
        f"kernel_launches_per_step={sum(e.count for e in kernels) / steps}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[trace]   {e.self_device_time_total / 1e3 / steps:9.4f} ms "
            f"x{e.count // steps:<5d} {e.key[:90]}")


def main():
    name = phase_device()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    t0 = time.perf_counter()
    phase_build()
    phase_check()
    counts, served = phase_serve()
    phase_trace(served)
    del served          # frees the 16.4 GB of bf16 weights before timing
    kernels = phase_time(counts)
    log(f"[done] {time.perf_counter() - t0:.1f}s after the device check")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
