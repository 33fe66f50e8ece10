"""Serve qwen3-8b twice, run ``chip_smoke.py``'s phase 3b (the dry-run's
checks on a world-of-one nccl mesh), then serve twice more, on one NVIDIA
card: whether the phase slows the host work that follows it in the full
run (the process group it starts and destroys, the modules it imports).

    python3 tools/serve_around_dryrun.py

Each serve run is ``chip_smoke.phase_serve`` (weights drawn, prefill,
the prompt replayed through decode, 32 greedy steps); its wall time, its
decode tokens/s and the live Python threads are logged as ``[probe]``.
"""
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402


def _serve(tag: str):
    t0 = time.perf_counter()
    _, out = cs.phase_serve(cs.ARCH)
    cs.log(f"[probe] {tag}: wall {time.perf_counter() - t0:.2f}s "
           f"decode_tok_s={out['decode_tok_s']:.2f} "
           f"threads={threading.active_count()}")


def main():
    cs.phase_device()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    cs.phase_build(("packed_attention", "flash_decode"))
    _serve("before-1")
    _serve("before-2")
    cs.phase_dryrun()
    cs.log(f"[probe] threads after phase 3b: "
           f"{[t.name for t in threading.enumerate()]}")
    _serve("after-1")
    _serve("after-2")


if __name__ == "__main__":
    main()
