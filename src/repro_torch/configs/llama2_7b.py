"""llama2-7b [arXiv:2307.09288] — the paper's own evaluation family."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=32, d_ff=11008, vocab=32000,
    head_dim=128, norm="rmsnorm", act="silu", pos="rope", rope_theta=1e4)

TINY = CONFIG.with_(name="llama2-tiny", n_layers=4, d_model=128, n_heads=4,
                    n_kv=4, d_ff=384, vocab=512, head_dim=32)
