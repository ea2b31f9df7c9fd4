"""AllocateBits (paper §4, Alg. 4): optimal layer-wise bit allocation.

Minimize  sum_k alpha_k * 2^{-b_k}   s.t.   sum_k b_k * m_k <= R,  b_k in B,

solved exactly by dynamic programming over the budget axis after dividing all
m_k and R by g = gcd(m_1..m_L, R) — the paper's divide-by-GCD trick, which is
what makes the DP table small enough (R/g ~ 1e5) to solve in seconds on host.

When the slot count still exceeds ``_MAX_SLOTS`` the budget unit is coarsened
and g no longer divides the m_k, so the per-(layer, bits) slot costs are
rounded.  Round-to-nearest (Alg. 4's floor(m b / g + 1/2)) can *under*-count
real bits, so the reconstructed allocation is verified against the true
budget and, if it overruns, the DP is re-solved with ceiling costs — which
over-count and therefore guarantee sum b_k m_k <= g * n_slots <= R.  The
all-minimum-bits assignment is feasible by the entry precondition, so the
repair always terminates with a true-budget-feasible result.

Everything here is host-side numpy: allocation happens once per model, before
quantization, and its output (a python list of ints) is static metadata.

A verbatim copy of ``repro/core/allocate.py`` (numpy only) without its
test-only brute-force solver: the port imports
nothing of the reference package, and a test holds the two to identical
results.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

__all__ = ["AllocationResult", "allocate_bits", "allocate_for_avg_bits"]

# Above this many DP budget slots we coarsen the budget unit and accept a
# sub-1-slot rounding of R (documented safeguard; never triggers when layer
# sizes share a large gcd, which the paper notes is the common LLM case).
_MAX_SLOTS = 4_000_000


@dataclass(frozen=True)
class AllocationResult:
    bits: list[int]          # chosen b_k per layer
    total_bits: int          # sum b_k * m_k actually used
    budget: int              # requested R
    objective: float         # sum alpha_k 2^{-b_k}
    gcd: int                 # the g actually used by the DP
    n_slots: int             # R // g
    total_params: int = 0    # sum m_k (0 only if the caller omitted it)

    @property
    def avg_bits(self) -> float:
        return self.total_bits / max(1, self.total_params)


def _gcd_many(vals: Sequence[int]) -> int:
    g = 0
    for v in vals:
        g = math.gcd(g, int(v))
    return max(g, 1)


def allocate_for_avg_bits(alphas: Sequence[float], m: Sequence[int],
                          avg_bits: float, bit_choices: Sequence[int]
                          ) -> AllocationResult:
    """Convenience wrapper: budget R = avg_bits * total params (floored)."""
    r = int(math.floor(avg_bits * sum(int(x) for x in m)))
    return allocate_bits(alphas, m, r, bit_choices)


def _dp_solve(err: np.ndarray, costs: np.ndarray, bits: list[int],
              n_slots: int):
    """DP over the slot axis.  Returns (picked bits per layer, objective) or
    None when no assignment fits in ``n_slots`` slots under ``costs``."""
    num_layers = costs.shape[0]
    inf = np.inf
    f = np.full(n_slots + 1, inf)
    f[0] = 0.0
    choice = np.zeros((num_layers, n_slots + 1), dtype=np.int8)

    for k in range(num_layers):
        newf = np.full(n_slots + 1, inf)
        ch = np.zeros(n_slots + 1, dtype=np.int8)
        for j in range(len(bits)):
            ckj = int(costs[k, j])
            if ckj > n_slots:
                continue
            cand = np.full(n_slots + 1, inf)
            cand[ckj:] = f[: n_slots + 1 - ckj] + err[k, j]
            better = cand < newf
            newf = np.where(better, cand, newf)
            ch = np.where(better, np.int8(j), ch)
        f = newf
        choice[k] = ch

    if not np.isfinite(f).any():
        return None
    r = int(np.argmin(f))
    objective = float(f[r])
    picked = []
    for k in range(num_layers - 1, -1, -1):
        j = int(choice[k, r])
        picked.append(bits[j])
        r -= int(costs[k, j])
    picked.reverse()
    return picked, objective


def allocate_bits(alphas: Sequence[float], m: Sequence[int], budget: int,
                  bit_choices: Sequence[int]) -> AllocationResult:
    """Exact DP solve of the bit-allocation integer program (Alg. 4).

    The returned allocation always satisfies ``total_bits <= budget``, even
    on the coarsened-g path where the DP's slot costs are rounded."""
    alphas = np.asarray(alphas, dtype=np.float64)
    m = np.asarray(m, dtype=np.int64)
    bits = sorted(int(b) for b in set(bit_choices))
    num_layers = len(m)
    if num_layers == 0:
        raise ValueError("no layers to allocate")
    if alphas.shape[0] != num_layers:
        raise ValueError("alphas and m must have the same length")
    if budget < bits[0] * int(m.sum()):
        raise ValueError(
            f"budget {budget} below the minimum {bits[0] * int(m.sum())} "
            f"(every layer at {bits[0]} bits)")

    g = _gcd_many(list(m) + [budget])
    n_slots = budget // g
    if n_slots > _MAX_SLOTS:                       # coarsen (safeguard)
        factor = int(math.ceil(n_slots / _MAX_SLOTS))
        g *= factor
        n_slots = budget // g

    err = (alphas[:, None] * np.exp2(-np.asarray(bits, dtype=np.float64))[None, :])
    bcol = np.asarray(bits, dtype=np.int64)[None, :]
    # round-to-nearest slot count, as in Alg. 4:  floor(m_k b / g + 1/2)
    costs = (m[:, None] * bcol + g // 2) // g

    solved = _dp_solve(err, costs, bits, n_slots)
    picked, objective = solved if solved is not None else (None, None)

    def total(bs):
        return int(np.sum(np.asarray(bs, dtype=np.int64) * m))

    if picked is None or total(picked) > budget:
        # Nearest-rounding under-counted (only possible when g does not
        # divide the m_k, i.e. the coarsened path): re-solve with ceiling
        # costs, which over-count and so can never exceed the true budget.
        costs = -((-m[:, None] * bcol) // g)
        solved = _dp_solve(err, costs, bits, n_slots)
        if solved is not None:
            picked, objective = solved
        else:
            # Ceiling costs over-shrank the feasible set; the all-minimum
            # assignment fits the true budget by the precondition above.
            picked = [bits[0]] * num_layers
            objective = float(np.sum(err[:, 0]))
    total_bits = total(picked)
    assert total_bits <= budget, "allocation repair failed to fit budget"
    return AllocationResult(bits=picked, total_bits=total_bits, budget=budget,
                            objective=objective, gcd=g, n_slots=n_slots,
                            total_params=int(m.sum()))

