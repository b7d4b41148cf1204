"""Evaluation plane: plans, posterior backends, the evaluation engine."""
