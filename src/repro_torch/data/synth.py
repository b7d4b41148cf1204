"""Deterministic synthetic data pipeline (restart-stable).

Counterpart of ``repro/data/synth.py``: numpy only, so a batch is bitwise
the reference's.  Batches are a pure function of ``(seed, step)``: a
restarted job resumes at step k and sees exactly the data it would have
seen, with no data-loader state in the checkpoint.  One process makes the
whole global batch; the caller moves it to its device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0


def _rng_for(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng((cfg.seed * 1_000_003 + step) % (2**63))


def synth_batch(model_cfg: ModelConfig, cfg: DataConfig,
                step: int) -> Dict[str, np.ndarray]:
    """One global batch: ``tokens`` and ``targets`` (B, S) int32 from a
    drifting token stream (so the loss can fall); the encoder-decoder adds
    stub ``frames`` (B, max(S·enc_seq_fraction, 8), d_model) float32."""
    rng = _rng_for(cfg, step)
    B, S = cfg.global_batch, cfg.seq_len
    V = model_cfg.vocab_size

    base = rng.integers(0, V, (B, 1))
    drift = np.cumsum(rng.integers(0, 7, (B, S + 1)), axis=1)
    toks = ((base + drift) % V).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    if model_cfg.family == "encdec":
        S_enc = max(int(S * model_cfg.enc_seq_fraction), 8)
        batch["frames"] = rng.standard_normal(
            (B, S_enc, model_cfg.d_model)).astype(np.float32) * 0.02
    return batch


def batch_iterator(model_cfg: ModelConfig, cfg: DataConfig,
                   start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield synth_batch(model_cfg, cfg, step)
        step += 1
