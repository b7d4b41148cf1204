"""Serving: the continuous-batching LM engine."""
