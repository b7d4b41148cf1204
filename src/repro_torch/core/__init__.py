"""Acquisition functions, batched L-BFGS-B, coroutine MSO strategies."""
