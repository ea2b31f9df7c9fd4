"""ModelConfig: a single declarative description that covers all ten assigned
architectures (dense GQA / MoE / MLA / RWKV6 / RG-LRU hybrid / enc-dec).

A verbatim copy of ``repro/models/config.py`` (which imports no JAX): the
port imports nothing of the reference package, and a test asserts that the
two registries give equal configs."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared (always-on) experts, DeepSeek style
    capacity_factor: float = 1.25
    aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128
    n_heads: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | mla_moe | rwkv6 | rglru | whisper | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"
    act: str = "silu"
    pos: str = "rope"            # rope | mrope | sinusoidal | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()
    qk_norm: bool = False
    window: Optional[int] = None  # sliding/local attention window
    mixer_pattern: Tuple[str, ...] = ()  # per layer: attn | mla | rwkv | rglru
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rglru_width: Optional[int] = None
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_audio_ctx: int = 1500
    subquadratic: bool = False   # long_500k applicability (DESIGN.md §4)
    frontend: str = "none"       # none | audio_stub | vision_stub
    # --- perf knobs (EXPERIMENTS.md §Perf) ---
    remat_attention: bool = False  # flash-style bwd: recompute per-chunk
    #   probabilities instead of stacking S^2 residuals (checkpointed kv_step)
    expand_kv: bool = False        # expand GQA KV heads to full heads so the
    #   attention einsums shard on the flat head axis (§Perf B2)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.mixer_pattern:
            assert len(self.mixer_pattern) == self.n_layers
            return self.mixer_pattern
        return ("attn",) * self.n_layers

    @property
    def scan_period(self) -> int:
        """Smallest p such that the mixer pattern is (prefix of) a p-cycle."""
        pat = self.pattern
        for p in range(1, len(pat) + 1):
            if all(pat[i] == pat[i % p] for i in range(len(pat))):
                return p
        return len(pat)

    def ffn_kind(self) -> str:
        if self.family in ("rwkv6",):
            return "cm"
        if self.moe is not None:
            return "moe"
        return "glu" if self.act in ("silu", "geglu") else "gelu"

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
