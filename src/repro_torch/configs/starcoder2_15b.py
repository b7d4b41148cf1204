"""starcoder2-15b [dense]: GQA kv=4, RoPE.
40L d_model=6144 48H d_ff=24576 vocab=49152.  [arXiv:2402.19173; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab_size=49152, head_dim=128,
    norm="layernorm", activation="gelu",
    sub_quadratic=False,
)
