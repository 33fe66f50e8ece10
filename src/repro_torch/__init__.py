"""PyTorch + CUDA port of the ``repro`` model stack, for NVIDIA Hopper.

The layout mirrors ``repro`` (``configs/``, ``models/``, ``kernels/``,
``train/``, ``launch/``) so each module's counterpart is easy to find.
The package imports ``torch`` and numpy only: no JAX, and nothing of
``repro``.  Entry points run on ``cuda`` unless the caller asks for the
CPU; on the CPU each kernel is replaced by its plain PyTorch version.
"""
