"""Synthetic data for the training step."""
