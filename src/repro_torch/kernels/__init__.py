"""Hand-written CUDA kernels for the port, each beside its plain PyTorch twin.

  * ``qmatmul``         — dequant GEMMs: fused practical RHT + GEMM (Alg. 5
    + 3) and the unfused GEMM on an already-rotated X.
  * ``hadamard``        — practical randomized Hadamard transform (Alg. 5).
  * ``rabitq_quant``    — RaBitQ code search + least-squares rescale.
  * ``paged_attention`` — flash-decode over the serving engine's block arena.
  * ``flash_attention`` — fused causal / window / GQA attention forward
    (ported with its dispatcher; no model path calls it, as in the
    reference).

Every ``ops.py`` wrapper launches its kernel for CUDA tensors and runs the
plain version for CPU tensors; ``_build`` compiles the sources in
``csrc/`` with nvcc at first use.  Each wrapper adds one to its module's
launch counter where it launches; the helpers below read, set and credit
those counters by kernel name (a replayed CUDA graph launches without the
wrappers, ``serve/graphs.py``).
"""
from __future__ import annotations

import importlib

# kernel -> (wrapper module, its launch counter)
_COUNTERS = {
    "rht_qmatmul": ("qmatmul", "launches"),
    "qmatmul": ("qmatmul", "unfused_launches"),
    "grouped_rht_qmatmul": ("qmatmul", "grouped_launches"),
    "grouped_qmatmul": ("qmatmul", "grouped_unfused_launches"),
    "rht": ("hadamard", "launches"),
    "paged_attention": ("paged_attention", "launches"),
    "flash_attention": ("flash_attention", "launches"),
    "rabitq_quant": ("rabitq_quant", "launches"),
}


def _ops(module: str):
    # imported when called: every ops module imports this package first
    return importlib.import_module(f"repro_torch.kernels.{module}.ops")


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch counter, by kernel."""
    return {k: getattr(_ops(m), attr) for k, (m, attr) in _COUNTERS.items()}


def set_launch_counts(counts: dict[str, int]) -> None:
    """Set the wrappers' counters (a snapshot from ``launch_counts``, or 0
    for every kernel)."""
    for k, n in counts.items():
        m, attr = _COUNTERS[k]
        setattr(_ops(m), attr, n)


def launches_since(before: dict[str, int]) -> dict[str, int]:
    """Launches per kernel since the snapshot ``before``."""
    return {k: n - before[k] for k, n in launch_counts().items()}


def credit_launches(per_call: dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``per_call`` to the counters: a CUDA graph's replay
    launches what its capture recorded, without running the wrappers, so the
    replaying code credits them here."""
    now = launch_counts()
    set_launch_counts({k: now[k] + times * per_call.get(k, 0) for k in now})


def plain_forced() -> bool:
    """Whether a serving kernel's wrapper is forced onto its plain version
    (``set_forced_path("ref")``).  ``paged_kernel(False)`` is not: it
    selects the dense gather, which reads nothing back to the host and is
    captured like the kernel."""
    return any(_ops(m)._FORCE_PATH == "ref"
               for m in ("qmatmul", "hadamard", "paged_attention"))
