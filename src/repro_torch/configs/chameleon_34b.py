"""chameleon-34b [vlm]: early-fusion, VQ image tokens live in the vocab.
48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536, qk-norm.
[arXiv:2405.09818; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536, head_dim=128,
    qk_norm=True, norm="rmsnorm", activation="swiglu",
    rope_theta=10000.0, frontend="vq_image",
    sub_quadratic=False,
)
