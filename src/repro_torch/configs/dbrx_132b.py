"""dbrx-132b [moe]: 16 experts top-4, fine-grained; GQA kv=8.
40L d_model=6144 48H d_ff=10752 vocab=100352.
[hf:databricks/dbrx-base; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab_size=100352, head_dim=128,
    n_experts=16, experts_per_token=4,
    norm="layernorm", activation="swiglu",
    sub_quadratic=False,
)
