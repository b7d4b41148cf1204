"""qwen3-moe-30b-a3b [moe]: 128 experts top-8, fine-grained (d_ff=768).
48L d_model=2048 32H (GQA kv=4) vocab=151936.  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128,
    n_experts=128, experts_per_token=8,
    qk_norm=True, norm="rmsnorm", activation="swiglu",
    sub_quadratic=False,
)
