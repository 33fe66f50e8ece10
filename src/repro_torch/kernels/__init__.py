"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

``ops`` is the entry point; ``ref`` holds the plain PyTorch versions;
``packed_attention``, ``flash_decode`` and ``wkv6`` wrap the kernels in
``csrc/``, which ``_build`` compiles with nvcc at first use.
"""
