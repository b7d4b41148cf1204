"""Shape cells and their parameter initializers.

Counterpart of ``repro/launch/shapes.py``; only :func:`init_fn_for` is
ported (the training launcher's initializer).  The cells' lowering
targets and counts are ROADMAP queue A item 4.6.
"""
from __future__ import annotations

from repro_torch.models import lm
from repro_torch.models import whisper as wh
from repro_torch.models.config import ModelConfig


def init_fn_for(cfg: ModelConfig):
    """The family's ``init_params(cfg, gen, *, stacked=False)``."""
    return wh.init_params if cfg.family == "encdec" else lm.init_params
