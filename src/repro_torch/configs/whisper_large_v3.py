"""whisper-large-v3 [arXiv:2212.04356; unverified] — enc-dec audio backbone.

Conv frontend is a STUB per the assignment: input_specs() provides
precomputed mel-frame embeddings (B, 1500, d) for the encoder.  32 encoder +
32 decoder layers, MHA (kv = heads), GELU FFN, sinusoidal positions.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="whisper",
    n_layers=32, d_model=1280, n_heads=20, n_kv=20, d_ff=5120, vocab=51866,
    head_dim=64, norm="layernorm", act="gelu", pos="sinusoidal",
    enc_dec=True, n_enc_layers=32, n_audio_ctx=1500, frontend="audio_stub")

TINY = CONFIG.with_(name="whisper-tiny", n_layers=2, d_model=64, n_heads=4,
                    n_kv=4, d_ff=128, vocab=256, head_dim=16,
                    n_enc_layers=2, n_audio_ctx=30)
