"""recurrentgemma-2b [arXiv:2402.19427; hf] — Griffin: RG-LRU + local attn 1:2.

Pattern: (rglru, rglru, attn) repeating over 26 layers; local attention window
2048, MQA (kv=1).  Sub-quadratic (bounded window + O(1) recurrent state) =>
runs the long_500k cell.
"""
from repro_torch.models.config import ModelConfig

_PATTERN = tuple(("rglru", "rglru", "attn")[i % 3] for i in range(26))

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="rglru",
    n_layers=26, d_model=2560, n_heads=10, n_kv=1, d_ff=7680, vocab=256000,
    head_dim=256, norm="rmsnorm", act="silu", pos="rope", rope_theta=1e4,
    window=2048, mixer_pattern=_PATTERN, rglru_width=2560, subquadratic=True)

TINY = CONFIG.with_(
    name="recurrentgemma-tiny", n_layers=5, d_model=64, n_heads=2, n_kv=1,
    d_ff=128, vocab=256, head_dim=32, window=16, rglru_width=64,
    mixer_pattern=tuple(("rglru", "rglru", "attn")[i % 3] for i in range(5)))
