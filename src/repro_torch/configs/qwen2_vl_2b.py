"""qwen2-vl-2b [arXiv:2409.12191; hf] — VLM backbone with M-RoPE.

The vision frontend is a STUB per the assignment: input_specs() provides
token ids plus the (3, B, S) multimodal position ids the frontend would emit
(temporal / height / width streams).  mrope_section (16, 24, 24) over the 64
rotary channel pairs of head_dim 128, as in the HF config.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv=2, d_ff=8960, vocab=151936,
    head_dim=128, norm="rmsnorm", act="silu", pos="mrope", rope_theta=1e6,
    mrope_sections=(16, 24, 24), frontend="vision_stub")

TINY = CONFIG.with_(name="qwen2-vl-tiny", n_layers=2, d_model=64, n_heads=4,
                    n_kv=2, d_ff=128, vocab=256, head_dim=16,
                    mrope_sections=(2, 3, 3))
