"""Architecture configuration for the LM substrate.

Counterpart of ``repro/models/config.py`` (a copy: the port imports
nothing of the JAX package).  One frozen dataclass covers all ten assigned
families; family-specific fields are zero/empty when unused.  Exact
assigned configs live in ``repro_torch/configs/<id>.py``; reduced smoke
variants come from ``reduced()``.  ``models/lm.py`` runs the dense, moe,
vlm, hybrid and ssm families, ``models/whisper.py`` the encdec one.
Of the JAX config's runtime options only ``remat`` has a counterpart
(``torch.utils.checkpoint`` per layer unit: ``lm._remat``); ``fsdp``,
``seq_shard``, ``scan_layers`` and ``attn_chunk`` are XLA or mesh
settings with none here, so they are not copied.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 → d_model // n_heads

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # positional / attention details
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0   # chatglm: 0.5 ("2d" partial rotary)
    qk_norm: bool = False        # chameleon
    window: int = 0              # local-attention window (hybrid)

    # hybrid (RecurrentGemma): block pattern repeats (rec, rec, attn)
    attn_every: int = 0          # every k-th block is attention; 0 = all attn
    lru_width: int = 0
    conv_width: int = 4

    # ssm (xLSTM): one sLSTM per `slstm_every` blocks, rest mLSTM
    slstm_every: int = 0
    mlstm_chunk: int = 256

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    enc_seq_fraction: float = 0.5   # encoder gets this share of cell seq_len

    # frontend stubs
    frontend: str = "none"       # none | vq_image | audio_frames

    norm: str = "rmsnorm"        # rmsnorm | layernorm
    activation: str = "swiglu"   # swiglu | gelu
    tie_embeddings: bool = False

    dtype: str = "bfloat16"
    # sub-quadratic decode (eligibility for long_500k per DESIGN.md §5)
    sub_quadratic: bool = False

    # runtime knob (not part of the architecture): what a layer unit keeps
    # for its backward, as the reference's scan body
    remat: str = "full"          # none | full | dots

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        if self.family == "encdec" and self.n_enc_layers == 0:
            object.__setattr__(self, "n_enc_layers", self.n_layers)
            object.__setattr__(self, "n_dec_layers", self.n_layers)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Small same-family variant for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 4 if self.family != "ssm" else 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(max(self.n_kv_heads
                               * 4 // max(self.n_heads, 1), 1), 4),
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            head_dim=32,
        )
        if self.is_moe:
            kw.update(n_experts=8, experts_per_token=2)
        if self.family == "hybrid":
            kw.update(lru_width=128, window=64, n_layers=3)
        if self.family == "ssm":
            kw.update(slstm_every=2, mlstm_chunk=32)
        if self.family == "encdec":
            kw.update(n_enc_layers=2, n_dec_layers=2, n_layers=2)
        return self.replace(**kw)


# ---------------------------------------------------------------------------
# parameter counting (for MODEL_FLOPS in the roofline)
# ---------------------------------------------------------------------------

def param_counts(cfg: ModelConfig) -> dict:
    """Approximate parameter counts: total and active-per-token."""
    d, h = cfg.d_model, cfg.head_dim
    attn = d * (cfg.n_heads * h) + 2 * d * (cfg.n_kv_heads * h) \
        + (cfg.n_heads * h) * d

    def mlp_params(ff):
        mult = 3 if cfg.activation == "swiglu" else 2
        return mult * d * ff

    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)

    if cfg.family == "encdec":
        enc = cfg.n_enc_layers * (attn + mlp_params(cfg.d_ff))
        dec = cfg.n_dec_layers * (2 * attn + mlp_params(cfg.d_ff))
        total = enc + dec + emb
        return {"total": total, "active": total}

    if cfg.is_moe:
        router = cfg.n_layers * d * cfg.n_experts
        experts = cfg.n_layers * cfg.n_experts * mlp_params(cfg.d_ff)
        act_experts = cfg.n_layers * cfg.experts_per_token \
            * mlp_params(cfg.d_ff)
        base = cfg.n_layers * attn + emb + router
        return {"total": base + experts, "active": base + act_experts}

    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // max(cfg.attn_every, 1)
        n_rec = cfg.n_layers - n_attn
        lru = cfg.lru_width
        rec_block = 2 * d * lru + lru * d + cfg.conv_width * lru + 3 * lru
        total = (n_attn * attn + n_rec * rec_block
                 + cfg.n_layers * mlp_params(cfg.d_ff) + emb)
        return {"total": total, "active": total}

    if cfg.family == "ssm":
        # mLSTM block: up-proj(2x), qkv in up space, gates, down-proj
        up = 2 * d
        mlstm = d * up * 2 + up * (3 * up // 2) // 1 + up * d
        total = cfg.n_layers * mlstm + emb
        return {"total": total, "active": total}

    total = cfg.n_layers * (attn + mlp_params(cfg.d_ff)) + emb
    return {"total": total, "active": total}
