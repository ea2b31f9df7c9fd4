"""internlm2-1.8b [arXiv:2403.17297; hf] — dense GQA transformer."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv=8, d_ff=8192, vocab=92544,
    head_dim=128, norm="rmsnorm", act="silu", pos="rope", rope_theta=1e6)

TINY = CONFIG.with_(name="internlm2-tiny", n_layers=2, d_model=64, n_heads=4,
                    n_kv=2, d_ff=128, vocab=256, head_dim=16)
