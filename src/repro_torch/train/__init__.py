"""Serve steps (the training half of the port comes later)."""
