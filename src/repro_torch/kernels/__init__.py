"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

``ops`` is the entry point; ``ref`` holds the plain PyTorch versions;
``packed_attention``, ``packed_attention_bwd``, ``flash_decode``, ``wkv6``
and ``wkv6_bwd`` wrap the kernels in ``csrc/``, which ``_build`` compiles
with nvcc at first use.
"""
import torch


def refuse_grad(name: str, tensors, hint: str = ""):
    """Raise if autograd would record a call of kernel ``name`` on
    ``tensors``: the kernels write their outputs outside autograd, so a
    gradient would silently stop there."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} kernel: an input requires grad, and this kernel has no "
            f"backward{hint}; see ROADMAP.md")

