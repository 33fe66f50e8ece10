"""Models: the port of ``repro.models`` (dense and RWKV6 families so far)."""
