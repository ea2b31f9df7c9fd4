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

Cost accounting (``launch/hlocost.py``): each wrapper's dispatcher runs
its call inside ``credited(kernel, **shape)``, which credits the kernel's
own work (its ``cost(...)``: the operations and compulsory bytes of its
bound) to every active cost counter and hides the ops the call dispatches
beneath it (the plain version's, or the output's allocation) from them.
The credit depends on shapes only, so it is the same whether the kernel
launches, its plain version runs or the inputs are fake.  A wrapper given
fake tensors (``is_fake``) returns an empty output of the right shape and
dtype after the kernel's own shape checks and runs neither version.  TP
gathers report their bytes through ``collective``; a model loop run once
for all its equal-shaped trips on fake inputs through ``repeated``.
"""
from __future__ import annotations

import contextlib
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


# kernel -> (wrapper module, the keywords its cost(...) adds)
_COSTS = {
    "rht_qmatmul": ("qmatmul", {"fused": True}),
    "qmatmul": ("qmatmul", {"fused": False}),
    "grouped_rht_qmatmul": ("qmatmul", {"fused": True}),
    "grouped_qmatmul": ("qmatmul", {"fused": False}),
    "rht": ("hadamard", {}),
    "paged_attention": ("paged_attention", {}),
    "flash_attention": ("flash_attention", {}),
    "rabitq_quant": ("rabitq_quant", {}),
}
_SINKS: list = []        # the active cost counters, innermost last


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


def kernel_cost(kernel: str, **shape) -> dict:
    """``kernel``'s work at ``shape`` (its wrapper module's ``cost``):
    ``flops`` (its operations), ``bytes`` (each input read once, each
    output written once) and ``work``, [operations, rate name] pairs."""
    module, extra = _COSTS[kernel]
    return _ops(module).cost(**shape, **extra)


@contextlib.contextmanager
def credited(kernel: str, **shape):
    """One wrapper call: ``kernel``'s cost at ``shape`` credited to every
    active counter, and the ops dispatched inside hidden from them."""
    if not _SINKS:
        yield
        return
    sinks = list(_SINKS)
    for s in sinks:
        s.enter_kernel(kernel, shape)
    try:
        yield
    finally:
        for s in sinks:
            s.exit_kernel()


@contextlib.contextmanager
def repeated(trips: int):
    """One trip of a loop whose trips all have one shape, run on fake
    inputs, counted ``trips`` times by every active counter (the
    reference's cost multiplies a while body by its trip count)."""
    sinks = list(_SINKS)
    for s in sinks:
        s.enter_repeat(trips)
    try:
        yield
    finally:
        for s in sinks:
            s.exit_repeat()


def collective(kind: str, nbytes: int) -> None:
    """A collective's bytes on the wire (``runtime/tp.py``'s gathers)."""
    for s in _SINKS:
        s.add_collective(kind, nbytes)


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (shapes and dtypes, no storage)."""
    from torch._subclasses.fake_tensor import is_fake as _is_fake
    return _is_fake(t)
