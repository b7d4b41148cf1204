"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, pattern 1 attn : 2
recurrent, window 2048.  38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000, lru_width=4096.  [arXiv:2402.19427; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    attn_every=3, window=2048, lru_width=4096, conv_width=4,
    norm="rmsnorm", activation="geglu",
    sub_quadratic=True,
)
