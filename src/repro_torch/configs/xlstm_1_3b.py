"""xlstm-1.3b [ssm]: mLSTM + sLSTM blocks (xLSTM[7:1]), no separate FFN
(d_ff=0).  48L d_model=2048 4H vocab=50304.  [arXiv:2405.04517; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=512,
    slstm_every=8, mlstm_chunk=256, conv_width=4,
    norm="layernorm", activation="gelu",
    sub_quadratic=True,
)
