"""mixtral-8x7b [arXiv:2401.04088; hf] — 8-expert top-2 MoE with sliding-window
attention (window 4096 => ring KV cache, long_500k-capable)."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336, vocab=32000,
    head_dim=128, norm="rmsnorm", act="silu", pos="rope", rope_theta=1e6,
    window=4096, subquadratic=True,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336))

TINY = CONFIG.with_(name="mixtral-tiny", n_layers=2, d_model=64, n_heads=4,
                    n_kv=2, d_ff=128, vocab=256, head_dim=16, window=16,
                    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128))
