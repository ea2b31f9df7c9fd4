"""qwen3-0.6b [hf:Qwen/Qwen3-8B family; hf] — dense GQA with qk-norm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv=8, d_ff=3072, vocab=151936,
    head_dim=128, norm="rmsnorm", act="silu", pos="rope", rope_theta=1e6,
    qk_norm=True)

TINY = CONFIG.with_(name="qwen3-tiny", n_layers=2, d_model=64, n_heads=4,
                    n_kv=2, d_ff=128, vocab=256, head_dim=16)
