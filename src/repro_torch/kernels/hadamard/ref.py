"""Plain PyTorch version of the RHT kernel (port of
``repro/kernels/hadamard/ref.py``): ``core/hadamard``'s Kronecker-matmul
transform, which the CUDA kernel's butterfly must match; and
``rotate_walk``, the kernel's own decomposition walked on the host."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hadamard as hcore


def practical_rht_ref(x: torch.Tensor, signs1: torch.Tensor,
                      signs2: torch.Tensor | None) -> torch.Tensor:
    """Alg. 5 over the last axis: the first d_hat coordinates with signs1,
    then the last d_hat (overlap transformed twice) with signs2."""
    return hcore.practical_rht(x, signs1, signs2, axis=-1)


def phase2_index(threads: int, per_thread: int) -> np.ndarray:
    """(T, E) block index that register slot e of thread t holds after the
    kernel's transpose (``fwht.cuh:phase2_index``): the slot's low log2 W
    bits are the warp bits of j = e * T + warp * 32 + lane."""
    lw = (threads // 32).bit_length() - 1
    le = per_thread.bit_length() - 1
    t = np.arange(threads)[:, None]
    e = np.arange(per_thread)[None, :]
    return ((((e >> lw) | ((t >> 5) << (le - lw))) * threads)
            + (e & (threads // 32 - 1)) * 32 + (t & 31))


def _pairs(v: torch.Tensor, dim: int, m: int) -> torch.Tensor:
    """One butterfly stage over the index bit of weight m along ``dim``:
    (a, b) -> (a + b, a - b), a the lower index."""
    v = v.movedim(dim, -1)
    lead, size = v.shape[:-1], v.shape[-1]
    g = v.reshape(*lead, size // (2 * m), 2, m)
    a, b = g[..., 0, :], g[..., 1, :]
    return torch.stack((a + b, a - b), dim=-2).reshape(*lead, size).movedim(
        -1, dim)


def _block_walk(u: torch.Tensor, d_hat: int, threads: int, per_thread: int,
                idx: np.ndarray, scale: torch.Tensor) -> torch.Tensor:
    """The kernel's ``transform`` of the sign-flipped blocks u (n, d_hat):
    slot stages, lane stages (shuffles), the transpose, warp stages (slots
    again), the scale.  Returns (n, T, E) in the phase2_index layout."""
    n = u.shape[0]
    if d_hat < 32:                  # lanes past d_hat hold zeros
        u = torch.cat((u, u.new_zeros(n, 32 - d_hat)), dim=1)
    v = u.reshape(n, per_thread, threads).transpose(1, 2)   # v[t, e]
    for b in range(per_thread.bit_length() - 1):
        v = _pairs(v, 2, 1 << b)
    lanes = v.reshape(n, threads // 32, 32, per_thread)
    for h in (1, 2, 4, 8, 16):
        if h >= d_hat:
            break
        lanes = _pairs(lanes, 2, h)
    v = lanes.reshape(n, threads, per_thread)
    if threads > 32:
        buf = v.transpose(1, 2).reshape(n, threads * per_thread)
        v = buf[:, torch.from_numpy(idx.reshape(-1)).to(u.device)].reshape(
            n, threads, per_thread)
        for b in range((threads // 32).bit_length() - 1):
            v = _pairs(v, 2, 1 << b)
    return v * scale


def _lane_tree(part: torch.Tensor) -> torch.Tensor:
    """Lane 0 of the kernel's __shfl_down_sync sum over (..., 32) lanes."""
    for off in (16, 8, 4, 2, 1):
        nxt = part + part            # a lane past 31 - off reads itself
        nxt[..., :32 - off] = part[..., :32 - off] + part[..., off:]
        part = nxt
    return part[..., 0]


def rotate_walk(x: torch.Tensor, signs1: torch.Tensor,
                signs2: torch.Tensor | None, threads: int, per_thread: int,
                out_ld: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rotation kernel of ``csrc/fwht.cuh`` walked on the host under the
    plan (threads, per_thread): the same stages in the same order, the
    overlap of Alg. 5's blocks through the row buffer, rows zero-padded to
    out_ld, and each row's sum in the kernel's order (slots in order, block
    1's [0, d - d_hat) before block 2, the lane tree, warps in order).
    Returns (out (n, out_ld), rowsum (n,))."""
    n, d = x.shape
    d_hat = hcore.largest_pow2_leq(d)
    out_ld = d if out_ld is None else out_ld
    o = d - d_hat
    x = x.to(torch.float32)
    scale = (torch.tensor(1.0, dtype=torch.float32)
             / torch.sqrt(torch.tensor(float(d_hat), dtype=torch.float32))
             ).to(x.device)
    idx = phase2_index(threads, per_thread)
    live = idx < d_hat                       # lanes past a small d_hat idle
    slots = torch.from_numpy(live).to(x.device)
    where = torch.from_numpy(idx[live]).to(x.device)
    row = x.clone()
    part = x.new_zeros(n, threads)

    def block(start, signs, counted):
        nonlocal part
        v = _block_walk(row[:, start:start + d_hat] * signs, d_hat, threads,
                        per_thread, idx, scale)
        for e in range(per_thread):
            part = torch.where(counted[:, e], part + v[:, :, e], part)
        row[:, start + where] = v[:, slots]

    block(0, signs1, torch.from_numpy(live & (idx < o) if o else live).to(
        x.device))
    if o:
        block(o, signs2, slots)
    out = x.new_zeros(n, out_ld)
    out[:, :d] = row
    warp = _lane_tree(part.reshape(n, threads // 32, 32))
    rowsum = x.new_zeros(n)
    for w in range(threads // 32):
        rowsum = rowsum + warp[:, w]
    return out, rowsum
