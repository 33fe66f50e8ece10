"""Time a variant of the packed_attention forward kernel against the
committed one in turns, at qwen3-8b's serve shape, on one NVIDIA card.

    git show <commit>:src/repro_torch/kernels/csrc/packed_attention.cu \\
        > _archive/packed_attention_variant.cu
    python3 tools/time_in_turns.py _archive/packed_attention_variant.cu \\
        --no-lse-arg

The variant is built with the port's nvcc flags into
``build/repro_torch_kernels/variants/`` and loaded with ctypes;
``--no-lse-arg`` takes the C interface from before the forward had an
``lse`` argument.  Each of ``ROUNDS`` rounds times the variant, the
committed kernel as the serve path calls it (no lse) and as the training
path calls it (with lse), in that order on even rounds and in the reverse
order on odd ones: each time is the mean of 40 calls replayed from a CUDA
graph (``chip_smoke._time_ms``), over four sets of inputs.  Prints the card's
name and power limit, every time, the means and medians, and in how many
rounds the committed kernel without lse was faster than the variant.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import packed_attention as pa  # noqa: E402

ROUNDS = 10


def _load_variant(src: str, no_lse_arg: bool):
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / ("lib" + os.path.basename(src).replace(".cu", ".so"))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), src],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).packed_attention_launch
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    fn.argtypes = ([ptr] * (6 if no_lse_arg else 7) + [i32] * 6 + [i64] * 14
                   + [f32, i32, i32, i32, ptr])
    fn.restype = i32
    if not no_lse_arg:
        return fn

    def without_lse(*args):
        if args[6] is not None:
            raise ValueError("this variant writes no log-sum-exp")
        return fn(*args[:6], *args[7:])
    return without_lse


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("variant", help="path of the variant .cu")
    parser.add_argument("--no-lse-arg", action="store_true",
                        help="the variant's C entry has no lse argument")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_in_turns: needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[turns] nvidia-smi: {smi}", flush=True)
    variant = _load_variant(args.variant, args.no_lse_arg)
    committed = pa._kernel()
    b, s, h, kh, d = cs.BATCH, cs.PROMPT, 32, 8, 128   # qwen3-8b serve
    rng = np.random.default_rng(2)
    bf = torch.bfloat16
    seg = torch.ones((b, s), dtype=torch.int32, device="cuda")
    sets = [(cs._bshd(rng, b, s, h, d, bf), cs._bshd(rng, b, s, kh, d, bf),
             cs._bshd(rng, b, s, kh, d, bf), seg, seg) for _ in range(4)]

    def use(kernel):
        pa._kernel = lambda: kernel

    def with_lse(*a):
        return pa.packed_attention(*a, return_lse=True)
    runs = {"variant": (variant, pa.packed_attention),
            "committed": (committed, pa.packed_attention),
            "committed+lse": (committed, with_lse)}
    outs = {}
    for name in ("variant", "committed"):
        use(runs[name][0])
        outs[name] = runs[name][1](*sets[0])
    diff = (outs["variant"].float() - outs["committed"].float()).abs()
    print(f"[turns] variant vs committed output max abs diff "
          f"{diff.max().item():.3e}", flush=True)
    times = {name: [] for name in runs}
    order = list(runs)
    for r in range(ROUNDS):
        for name in (order if r % 2 == 0 else order[::-1]):
            kernel, fn = runs[name]
            use(kernel)
            times[name].append(cs._time_ms(fn, sets, 40)[0])
        print(f"[turns] round {r}: "
              + " ".join(f"{n}={times[n][-1]:.5f}" for n in order), flush=True)
    use(committed)
    faster = sum(c < v for c, v in zip(times["committed"], times["variant"]))
    print(json.dumps({
        "device": smi, "shape": [b, s, h, kh, d], "ms": times,
        "mean_ms": {n: statistics.fmean(t) for n, t in times.items()},
        "median_ms": {n: statistics.median(t) for n, t in times.items()},
        "committed_faster_rounds": faster, "rounds": ROUNDS}))


if __name__ == "__main__":
    main()
