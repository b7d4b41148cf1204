"""Checkpoints: atomic saves of flat arrays."""
