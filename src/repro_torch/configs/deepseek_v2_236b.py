"""deepseek-v2-236b [arXiv:2405.04434; hf] — MLA (kv_lora 512) + MoE
(2 shared + 160 routed, top-6)."""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="mla_moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv=128, d_ff=1536, vocab=102400,
    head_dim=128, norm="rmsnorm", act="silu", pos="rope", rope_theta=1e4,
    mixer_pattern=("mla",) * 60,
    mla=MLAConfig(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
                  v_head=128, n_heads=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2))

TINY = CONFIG.with_(
    name="deepseek-v2-tiny", n_layers=2, d_model=64, n_heads=4, n_kv=4,
    d_ff=96, vocab=256, head_dim=16, mixer_pattern=("mla",) * 2,
    mla=MLAConfig(q_lora=48, kv_lora=32, qk_nope=16, qk_rope=8, v_head=16,
                  n_heads=4),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96, n_shared=1))
