"""whisper-base [audio]: enc-dec, conv frontend STUBBED (precomputed frame
embeddings).  6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865.
[arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51865, head_dim=64,
    n_enc_layers=6, n_dec_layers=6, enc_seq_fraction=0.5,
    frontend="audio_frames",
    norm="layernorm", activation="gelu", rope_fraction=0.0,
    sub_quadratic=False,
)
