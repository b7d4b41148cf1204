"""The assigned input-shape cells and their steps, built on the meta
device (shapes and dtypes, nothing allocated).

Counterpart of ``repro/launch/shapes.py``.  Each cell pairs an
architecture with one of the four assigned shapes; :func:`build_cell`
gives the step the cell runs and its arguments as meta tensors, which
``launch/hlo_cost.py`` runs to count the step's work and
``launch/dryrun.py`` turns into a record.  The reference's shardings,
output layouts and donation place a step on a mesh; on one card there
is nothing to place or alias, so the port returns the step and its
arguments alone, and a mesh raises (ROADMAP queue A item 9b).

Cell eligibility as in the reference: ``long_500k`` needs sub-quadratic
decode (the hybrid and ssm families); full-attention archs skip it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import whisper as wh
from repro_torch.models.config import ModelConfig
from repro_torch.train.optim import OptimConfig, init_opt_state
from repro_torch.train.step import make_train_step

META = torch.device("meta")


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

# whisper-native encoder length of a decode cell, as in the reference
DECODE_ENC_LEN = 1500


def cell_supported(cfg: ModelConfig, shape: ShapeCell) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full attention is O(S²) — 500k decode infeasible"
    return True, ""


def init_fn_for(cfg: ModelConfig):
    """The family's ``init_params(cfg, gen, *, stacked=False,
    device=None)``."""
    return wh.init_params if cfg.family == "encdec" else lm.init_params


def params_shapes(cfg: ModelConfig):
    """The stacked parameter tree (the reference's leaves) on the meta
    device: the twin of ``jax.eval_shape`` of the initializer.  Nothing
    is allocated; the draws come from a CPU generator, as meta has
    none."""
    return init_fn_for(cfg)(cfg, torch.Generator(), stacked=True,
                            device=META)


def default_grad_accum(shape: ShapeCell, devices: int = 1) -> int:
    """Baseline microbatching: one batch row a device a microbatch, the
    reference's memory-safe default (256 microbatches of train_4k on one
    card)."""
    return max(shape.global_batch // max(devices, 1), 1)


def _enc_len(cfg: ModelConfig, s: int) -> int:
    return max(int(s * cfg.enc_seq_fraction), 8)


def _tokens(b: int, s: int):
    return torch.empty((b, s), dtype=torch.int32, device=META)


def _train_batch(cfg: ModelConfig, b: int, s: int
                 ) -> Dict[str, torch.Tensor]:
    """A train cell's batch on meta: ``tokens`` and ``targets`` (B, S),
    and for encdec the stub ``frames`` (B, S·enc_seq_fraction, d) float32,
    as the reference's."""
    batch = {"tokens": _tokens(b, s), "targets": _tokens(b, s)}
    if cfg.family == "encdec":
        batch["frames"] = torch.empty((b, _enc_len(cfg, s), cfg.d_model),
                                      dtype=torch.float32, device=META)
    return batch


def _decode_cache(params, cfg: ModelConfig, b: int, s: int):
    """A decode cell's cache on meta: ``lm.init_cache`` or, for encdec,
    ``whisper.init_cache`` over DECODE_ENC_LEN encoder positions."""
    if cfg.family != "encdec":
        return lm.init_cache(cfg, b, s, device=META)
    enc = torch.empty((b, DECODE_ENC_LEN, cfg.d_model),
                      dtype=lm.torch_dtype(cfg), device=META)
    return wh.init_cache(params, cfg, enc, b, s, device=META)


def build_cell(cfg: ModelConfig, shape: ShapeCell, *,
               opt_cfg: Optional[OptimConfig] = None,
               grad_accum: Optional[int] = None, mesh=None):
    """→ (step_fn, args): the cell's step and its arguments on meta.

    train: ``train_step`` (grad_accum microbatches, default one row
    each) over (params, opt_state, batch); prefill: the forward and the
    last position's logits over (params, tokens) (encdec: encode, then
    decode_train over the rest of the sequence); decode: one
    ``decode_step`` over (params, tokens (B, 1), cache, position)."""
    if mesh is not None:
        raise NotImplementedError(
            "build_cell(mesh=): the port runs on one card; meshes are "
            "ROADMAP queue A item 9b")
    ok, why = cell_supported(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} × {shape.name}: {why}")
    b, s = shape.global_batch, shape.seq_len
    params = params_shapes(cfg)
    if shape.kind == "train":
        opt_cfg = opt_cfg or OptimConfig()
        if grad_accum is None:
            grad_accum = default_grad_accum(shape)
        step = make_train_step(cfg, opt_cfg, grad_accum=grad_accum)
        return step, (params, init_opt_state(params, opt_cfg),
                      _train_batch(cfg, b, s))
    if shape.kind == "prefill":
        if cfg.family == "encdec":
            s_enc = _enc_len(cfg, s)

            def step(params, frames, tokens):
                enc = wh.encode(params, cfg, frames)
                hid = wh.decode_train(params, cfg, enc, tokens)
                return L.lm_logits(params["embed"], cfg, hid[:, -1:, :])

            frames = torch.empty((b, s_enc, cfg.d_model),
                                 dtype=torch.float32, device=META)
            return step, (params, frames, _tokens(b, s - s_enc))

        def step(params, tokens):
            hid, _ = lm.forward(params, cfg, tokens)
            return L.lm_logits(params["embed"], cfg, hid[:, -1:, :])

        return step, (params, _tokens(b, s))
    cache = _decode_cache(params, cfg, b, s)
    decode = wh.decode_step if cfg.family == "encdec" else lm.decode_step

    def step(params, tokens, cache, position):
        return decode(params, cfg, tokens, cache, position)

    # the last slot: a decode over a full cache (every slot written)
    return step, (params, _tokens(b, 1), cache, s - 1)
