"""llama3.2-3b [hf:meta-llama; unverified] — small llama3, dense GQA."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv=8, d_ff=8192, vocab=128256,
    head_dim=128, norm="rmsnorm", act="silu", pos="rope", rope_theta=5e5)

TINY = CONFIG.with_(name="llama3.2-tiny", n_layers=2, d_model=96, n_heads=6,
                    n_kv=2, d_ff=192, vocab=256, head_dim=16)
