"""Time a variant of one of the port's kernels against the
committed one in turns, on one NVIDIA card.

    git show <commit>:src/repro_torch/kernels/csrc/packed_attention.cu \\
        > _archive/packed_attention_variant.cu
    python3 tools/time_in_turns.py fwd _archive/packed_attention_variant.cu \\
        --no-lse-arg
    git show <commit>:src/repro_torch/kernels/csrc/packed_attention_bwd.cu \\
        > _archive/packed_attention_bwd_variant.cu
    python3 tools/time_in_turns.py bwd _archive/packed_attention_bwd_variant.cu
    git show <commit>:src/repro_torch/kernels/csrc/wkv6_bwd.cu \\
        > _archive/wkv6_bwd_variant.cu
    python3 tools/time_in_turns.py wkv6_bwd _archive/wkv6_bwd_variant.cu
    git show <commit>:src/repro_torch/kernels/csrc/flash_decode.cu \\
        > _archive/flash_decode_variant.cu
    python3 tools/time_in_turns.py decode _archive/flash_decode_variant.cu \\
        --no-lse-arg

The variant is built with the port's nvcc flags into
``build/repro_torch_kernels/variants/`` and loaded with ctypes.  Each of
``ROUNDS`` rounds times every run in one order on even rounds and in the
reverse order on odd ones: each time is the mean of calls replayed from a
CUDA graph (``chip_smoke._time_ms``) over four sets of inputs.

``fwd``: the forward kernel at qwen3-8b's serve shape; the runs are the
variant, the committed kernel as the serve path calls it (no lse) and as
the training path calls it (with lse).  ``--no-lse-arg`` takes the C
interface from before the forward had an ``lse`` argument.

``decode``: ``flash_decode`` at qwen3-8b's serve shape (b 4, 32 heads on
8 of 128, one call a layer of a 36-layer float32 cache of 544 positions,
bf16 q), and at the per-device block of the ``decode_32k`` cell on the
16 x 16 mesh (b 8, 32 heads on 8 of 128, 2048 positions, bf16); the runs
are the variant, the committed kernel as the serve path calls it (no lse)
and as a cache shard's partial (with lse).  The variant's output must be
bitwise the committed one's.  ``--no-lse-arg`` takes the C interface
from before the decode had an ``lse`` argument.

``wkv6_bwd``: the WKV6 backward kernel on the first batch of chip_smoke's
rwkv6-3b trainer phase (4 x 1024, 40 heads of 64, chunk 64; the data
plane stood up for one step's segment ids); the variant (e.g. an older
commit's ``wkv6_bwd.cu``) has the committed C interface.  The runs are the
variant and the committed kernel; after the rounds one pass of each under
``torch.profiler`` gives each of its launches' device time.

``bwd``: the backward kernel at the training shape (``chip_smoke.
_bwd_sets`` on the data plane's documents); the variant has the committed
C interface.  The runs are the variant, the committed kernel, and each of
the committed kernel's two launches alone (its source built with
``-DPA_BWD_PARTS=1`` or ``2``).  After the rounds one pass of each whole
kernel under ``torch.profiler`` gives every launch's device time, the
variant's too.

Prints the card's name and power limit, every time, the means and medians,
and in how many rounds the committed kernel was faster than the variant.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

ROUNDS = 10


def _build_variants(jobs: dict) -> dict:
    """``{name: (source, extra nvcc flags)}`` built in parallel; returns
    ``{name: ctypes.CDLL}``."""
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, (src, flags) in jobs.items():
        lib = out / ("lib" + name.replace(" ", "_") + ".so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        libs[name] = ctypes.CDLL(str(lib))
    print(f"[turns] built {sorted(libs)} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    return libs


def _in_turns(module, runs: dict, sets: list, iters: int) -> dict:
    """``runs``: ``{name: (C entry, wrapper)}``; each round times every run
    with ``module._kernel`` set to its entry, the order alternating."""
    committed = module._kernel()
    times = {name: [] for name in runs}
    order = list(runs)
    for r in range(ROUNDS):
        for name in (order if r % 2 == 0 else order[::-1]):
            kernel, fn = runs[name]
            module._kernel = lambda k=kernel: k
            times[name].append(cs._time_ms(fn, sets, iters)[0])
        print(f"[turns] round {r}: " + " ".join(
            f"{n.replace(' ', '_')}={times[n][-1]:.5f}" for n in order),
            flush=True)
    module._kernel = lambda: committed
    return times


def _summary(smi: str, shape, times: dict, **extra) -> dict:
    faster = sum(c < v for c, v in zip(times["committed"], times["variant"]))
    return {"device": smi, "shape": shape, "ms": times,
            "mean_ms": {n: statistics.fmean(t) for n, t in times.items()},
            "median_ms": {n: statistics.median(t) for n, t in times.items()},
            "committed_faster_rounds": faster, "rounds": ROUNDS, **extra}


def run_fwd(smi: str, src: str, no_lse_arg: bool) -> dict:
    from repro_torch.kernels import packed_attention as pa
    fn = _build_variants({"variant": (src, [])})["variant"] \
        .packed_attention_launch
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    fn.argtypes = ([ptr] * (6 if no_lse_arg else 7) + [i32] * 6 + [i64] * 14
                   + [f32, i32, i32, i32, ptr])
    fn.restype = i32
    variant = fn
    if no_lse_arg:
        def variant(*args):
            if args[6] is not None:
                raise ValueError("this variant writes no log-sum-exp")
            return fn(*args[:6], *args[7:])
    committed = pa._kernel()
    b, s, h, kh, d = cs.BATCH, cs.PROMPT, 32, 8, 128   # qwen3-8b serve
    rng = np.random.default_rng(2)
    bf = torch.bfloat16
    seg = torch.ones((b, s), dtype=torch.int32, device="cuda")
    sets = [(cs._bshd(rng, b, s, h, d, bf), cs._bshd(rng, b, s, kh, d, bf),
             cs._bshd(rng, b, s, kh, d, bf), seg, seg) for _ in range(4)]

    def with_lse(*a):
        return pa.packed_attention(*a, return_lse=True)
    runs = {"variant": (variant, pa.packed_attention),
            "committed": (committed, pa.packed_attention),
            "committed+lse": (committed, with_lse)}
    outs = {}
    for name in ("variant", "committed"):
        pa._kernel = lambda k=runs[name][0]: k
        outs[name] = pa.packed_attention(*sets[0])
    pa._kernel = lambda: committed
    diff = (outs["variant"].float() - outs["committed"].float()).abs()
    print(f"[turns] variant vs committed output max abs diff "
          f"{diff.max().item():.3e}", flush=True)
    return _summary(smi, [b, s, h, kh, d], _in_turns(pa, runs, sets, 40))


def _decode_sets(b, h, kh, S, d, dt, layers: int) -> list:
    """``layers`` calls' inputs: one layer's slice each of a (layers, b, S,
    kh, d) cache of ``dt``, bf16 q, every position live."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    kc = torch.randn((layers, b, S, kh, d), generator=gen,
                     device="cuda").to(dt)
    vc = torch.randn((layers, b, S, kh, d), generator=gen,
                     device="cuda").to(dt)
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    clen = torch.full((b,), S, dtype=torch.int32, device="cuda")
    return [(q, kc[i].transpose(1, 2), vc[i].transpose(1, 2), clen)
            for i in range(layers)]


def run_decode(smi: str, src: str, no_lse_arg: bool) -> dict:
    from repro_torch.kernels import flash_decode as fd
    fn = _build_variants({"variant": (src, [])})["variant"] \
        .flash_decode_launch
    argtypes = list(fd._kernel().argtypes)
    fn.argtypes = argtypes[:5] + argtypes[6:] if no_lse_arg else argtypes
    fn.restype = ctypes.c_int
    variant = fn
    if no_lse_arg:
        def variant(*args):
            if args[5] is not None:
                raise ValueError("this variant writes no log-sum-exp")
            return fn(*args[:5], *args[6:])
    committed = fd._kernel()

    def with_lse(*a):
        return fd.flash_decode(*a, return_lse=True)
    runs = {"variant": (variant, fd.flash_decode),
            "committed": (committed, fd.flash_decode),
            "committed+lse": (committed, with_lse)}
    shapes = {"serve": (cs.BATCH, 32, 8, cs.PROMPT + cs.GEN, 128,
                        torch.float32, 36),
              "decode_32k block": (8, 32, 8, 2048, 128, torch.bfloat16, 4)}
    result = {}
    for tag, (b, h, kh, S, d, dt, layers) in shapes.items():
        sets = _decode_sets(b, h, kh, S, d, dt, layers)
        outs = {}
        for name in ("variant", "committed"):
            fd._kernel = lambda k=runs[name][0]: k
            outs[name] = fd.flash_decode(*sets[0])
        fd._kernel = lambda: committed
        bitwise = torch.equal(outs["variant"], outs["committed"])
        print(f"[turns] {tag}: variant vs committed output bitwise equal: "
              f"{bitwise}", flush=True)
        if not bitwise:
            raise AssertionError(f"{tag}: the variant's output differs")
        result[tag] = _summary(smi, [b, h, kh, S, d, str(dt)[6:]],
                               _in_turns(fd, runs, sets, 10 * layers),
                               bitwise_equal=bitwise)
    return result


def _launch_ms(module, kernel, fn, sets: list, calls: int) -> dict:
    """Device ms of each launch a call of ``fn`` makes with
    ``module._kernel`` set to ``kernel``, from torch.profiler over
    ``calls`` eager calls."""
    committed = module._kernel()
    module._kernel = lambda: kernel
    split = cs._launch_split_ms(fn, sets, calls)
    module._kernel = lambda: committed
    return split


def _print_split(times: dict, launch_ms: dict):
    for name, split in launch_ms.items():
        print(f"[turns] {name}: whole call {statistics.fmean(times[name]):.5f}"
              " ms; each launch under the profiler: " + ", ".join(
                  f"{k} {v:.5f}" for k, v in split.items()), flush=True)


def run_bwd(smi: str, src: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import packed_attention_bwd as pab
    committed = pab._kernel()
    mine = _build.CSRC / "packed_attention_bwd.cu"
    libs = _build_variants({"variant": (src, []),
                            "committed dq": (mine, ["-DPA_BWD_PARTS=1"]),
                            "committed dkdv": (mine, ["-DPA_BWD_PARTS=2"])})
    kernels = {"committed": committed}
    for name, lib in libs.items():
        fn = lib.packed_attention_bwd_launch
        fn.argtypes, fn.restype = committed.argtypes, ctypes.c_int
        kernels[name] = fn
    cfg = get_config(cs.ARCH)
    seg = cs._packed_rows(np.random.default_rng(cs.TRAIN_SEED),
                          cs.TRAIN_BATCH, cs.TRAIN_SEQ).segment_ids
    sets = cs._bwd_sets(cfg, seg)
    outs = {}
    for name in ("variant", "committed"):
        pab._kernel = lambda k=kernels[name]: k
        outs[name] = pab.packed_attention_bwd(*sets[0])
    pab._kernel = lambda: committed
    diff = max((a.float() - b.float()).abs().max().item()
               for a, b in zip(outs["variant"], outs["committed"]))
    print(f"[turns] variant vs committed dq, dk, dv max abs diff "
          f"{diff:.3e}", flush=True)
    order = ("variant", "committed", "committed dq", "committed dkdv")
    times = _in_turns(pab, {n: (kernels[n], pab.packed_attention_bwd)
                            for n in order}, sets, 20)
    launch_ms = {n: _launch_ms(pab, kernels[n], pab.packed_attention_bwd,
                               sets, 40) for n in ("variant", "committed")}
    _print_split(times, launch_ms)
    return _summary(smi, [*seg.shape, cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim()], times,
                    launch_ms_profiler=launch_ms, max_abs_diff=diff)


def _rwkv_trainer_first_seg(cfg):
    """The segment ids of the first global batch that the rwkv6-3b trainer
    phase of chip_smoke.py draws from its data plane
    (``chip_smoke._trainer_plane`` under ``backbone_balance``, assembled as
    ``Trainer._assemble_global_batch`` assembles step 0)."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="turns_sources_") as root:
        ov = cs._trainer_plane(root, cfg, "backbone_balance")
        try:
            ov.start()
            bins = []
            for rank in ov.tree.data_fetching_clients("DP"):
                view = ov.get_batch(0, rank)
                if view["role"] == "data" and view.get("cp_rank", 0) == 0:
                    bins.extend(view["bins"])
        finally:
            ov.shutdown()
    return np.concatenate([p.segment_ids for p in bins], 0)


def run_wkv6_bwd(smi: str, src: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import wkv6_bwd as wb
    committed = wb._kernel()
    fn = _build_variants({"variant": (src, [])})["variant"].wkv6_bwd_launch
    fn.argtypes, fn.restype = committed.argtypes, ctypes.c_int
    kernels = {"variant": fn, "committed": committed}
    cfg = get_config(cs.RWKV_ARCH).replace(num_layers=cs.RWKV_TRAIN_LAYERS)
    seg = _rwkv_trainer_first_seg(cfg)
    sets = cs._wkv6_bwd_sets(cfg, seg)

    def call(*a):
        return wb.wkv6_bwd(*a, chunk=cfg.rwkv_chunk)
    outs = {}
    for name in ("variant", "committed"):
        wb._kernel = lambda k=kernels[name]: k
        outs[name] = call(*sets[0])
    wb._kernel = lambda: committed
    diff = max((a - b).abs().max().item()
               for a, b in zip(outs["variant"], outs["committed"]))
    print(f"[turns] variant vs committed dr, dk, dv, dloga, du max abs diff "
          f"{diff:.3e}", flush=True)
    times = _in_turns(wb, {n: (kernels[n], call) for n in kernels}, sets, 20)
    launch_ms = {n: _launch_ms(wb, kernels[n], call, sets, 20)
                 for n in kernels}
    _print_split(times, launch_ms)
    h = cfg.d_model // cfg.rwkv_head_dim
    return _summary(smi, [*seg.shape, h, cfg.rwkv_head_dim, cfg.rwkv_chunk],
                    times, launch_ms_profiler=launch_ms, max_abs_diff=diff)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("kernel",
                        choices=["fwd", "bwd", "wkv6_bwd", "decode"])
    parser.add_argument("variant", help="path of the variant .cu")
    parser.add_argument("--no-lse-arg", action="store_true",
                        help="fwd, decode: the variant's C entry has no "
                        "lse argument")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_in_turns: needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[turns] nvidia-smi: {smi}", flush=True)
    if args.kernel == "fwd":
        result = run_fwd(smi, args.variant, args.no_lse_arg)
    elif args.kernel == "bwd":
        result = run_bwd(smi, args.variant)
    elif args.kernel == "decode":
        result = run_decode(smi, args.variant, args.no_lse_arg)
    else:
        result = run_wkv6_bwd(smi, args.variant)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
