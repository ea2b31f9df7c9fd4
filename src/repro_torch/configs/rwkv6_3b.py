"""rwkv6-3b "Finch" [arXiv:2404.05892; hf] — attention-free, data-dependent
decay; sub-quadratic => runs the long_500k cell."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="rwkv6",
    n_layers=32, d_model=2560, n_heads=40, n_kv=40, d_ff=8960, vocab=65536,
    head_dim=64, norm="layernorm", act="relu2", pos="none",
    mixer_pattern=("rwkv",) * 32, subquadratic=True)

TINY = CONFIG.with_(name="rwkv6-tiny", n_layers=2, d_model=64, n_heads=2,
                    n_kv=2, d_ff=128, vocab=256, head_dim=32,
                    mixer_pattern=("rwkv",) * 2)
