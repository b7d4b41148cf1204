"""deepseek-7b [dense]: llama-arch, full MHA (kv=32).
30L d_model=4096 32H d_ff=11008 vocab=102400.  [arXiv:2401.02954; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab_size=102400, head_dim=128,
    norm="rmsnorm", activation="swiglu",
    sub_quadratic=False,
)
