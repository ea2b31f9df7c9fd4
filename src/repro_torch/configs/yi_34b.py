"""yi-34b [arXiv:2403.04652; hf] — llama-arch GQA at 34B."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv=8, d_ff=20480, vocab=64000,
    head_dim=128, norm="rmsnorm", act="silu", pos="rope", rope_theta=5e6)

TINY = CONFIG.with_(name="yi-tiny", n_layers=3, d_model=112, n_heads=7,
                    n_kv=1, d_ff=320, vocab=256, head_dim=16)
