"""Build the CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` (``packed_attention``, ``packed_attention_bwd``,
``flash_decode``, ``wkv6``, ``wkv6_bwd``) has a plain C interface and is
compiled on its own into ``build/repro_torch_kernels/lib<name>.so`` at the
repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o lib<name>.so <name>.cu

and loaded with ``ctypes``.  A library is rebuilt when its source is newer.
Nothing prebuilt is shipped and nothing is fetched; the build needs only
the CUDA toolkit.  ``build_all`` starts one ``nvcc`` per stale source, all
at once, and waits for them.
"""
from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" \
    / "repro_torch_kernels"
KERNELS = ("packed_attention", "packed_attention_bwd", "flash_decode",
           "wkv6", "wkv6_bwd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels are built on the machine with the "
                           "card")
    return path


def library_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    return (not lib.exists()
            or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime)


def build_all(names=KERNELS) -> dict[str, str]:
    """Compile every stale kernel in parallel; return nvcc's log by name.

    Raises if any compile fails.  Each library is written to a temporary
    name and renamed into place, so a concurrent loader never sees half a
    file.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if it is missing or stale."""
    build_all((name,))
    return ctypes.CDLL(str(library_path(name)))
