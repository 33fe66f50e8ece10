"""Models: the port of ``repro.models`` (dense family so far)."""
