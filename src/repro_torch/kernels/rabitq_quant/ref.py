"""Plain PyTorch version of the RaBitQ code-search kernel (port of
``repro/kernels/rabitq_quant/ref.py``): ``core/rabitq.quantize``; and
``search_walk``, the kernel's split of d walked on the host."""
from __future__ import annotations

import torch

from repro_torch.core import rabitq

WARPS = 8                       # warps per CTA of csrc/rabitq_quant.cu


def quantize_ref(w: torch.Tensor, bits: int, n_candidates: int = 12):
    q = rabitq.quantize(w, bits, n_candidates=n_candidates)
    return q.codes, q.rescale


def search_walk(w: torch.Tensor, bits: int, n_candidates: int = 12,
                slices: int = 1):
    """The code-search kernel's decomposition on the host: d cut into
    ``slices`` row slices of ceil(d / slices) rows (one CTA of a cluster
    each), a column's absmax the maximum of its slices', and <w,v_s>,
    <v_s,v_s> summed per warp over its interleaved rows of a slice, warps
    in order, then slices in rank order; the step choice, codes and rescale
    follow from those sums as in the kernel.  Returns (codes, rescale,
    choice)."""
    w = w.to(torch.float32)
    d, c = w.shape
    levels = (1 << bits) - 1
    c_b = levels / 2.0
    per = -(-d // slices)
    bounds = [(min(d, r * per), min(d, r * per + per)) for r in range(slices)]
    absmax = w.new_zeros(c)
    for r0, r1 in bounds:
        if r1 > r0:
            absmax = torch.maximum(absmax, w[r0:r1].abs().amax(dim=0))
    delta0 = torch.clamp(absmax, min=1e-30) / torch.full_like(absmax, c_b)
    scales = torch.from_numpy(rabitq.candidate_scales(n_candidates)).to(
        w.device)
    wv = w.new_zeros(n_candidates, c)
    vv = w.new_zeros(n_candidates, c)
    for r0, r1 in bounds:
        slice_wv = w.new_zeros(n_candidates, c)
        slice_vv = w.new_zeros(n_candidates, c)
        for k in range(WARPS):
            rows = w[r0 + k:r1:WARPS]
            for s in range(n_candidates):
                v = rabitq._codes_v(rows, delta0 * scales[s], c_b, levels)
                slice_wv[s] = slice_wv[s] + torch.sum(rows * v, dim=0)
                slice_vv[s] = slice_vv[s] + torch.sum(v * v, dim=0)
        wv = wv + slice_wv
        vv = vv + slice_vv
    err = -(wv * wv) / torch.clamp(vv, min=1e-30)
    choice = torch.argmin(err, dim=0)              # the first minimum
    v = rabitq._codes_v(w, delta0 * scales[choice], c_b, levels)
    best_wv = wv.gather(0, choice[None])[0]
    best_vv = vv.gather(0, choice[None])[0]
    rescale = torch.where(best_vv > 0,
                          best_wv / torch.clamp(best_vv, min=1e-30),
                          torch.zeros_like(best_vv))
    return (v + c_b).to(torch.uint8), rescale, choice
