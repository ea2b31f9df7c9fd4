"""Paged KV-cache pool (port of ``repro/serve/pool.py`` for attention archs).

A fixed arena of (num_blocks, block_size, KV, hd) blocks per layer, shared by
all in-flight requests; a physical block id addresses the same slab in every
layer's arena, so one block table serves the whole stack.  Physical block 0
is the null block: unallocated block-table entries point at it and
inactive-slot writes land in it; stored-position masks guarantee it is never
read as a real key.

The content-addressed prefix cache (and with it copy-on-write, LRU parking
and preemption) is ROADMAP Queue 1 item 3; until it lands,
``PoolConfig(prefix_cache=True)`` raises instead of being ignored.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import decode as decmod
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Static sizing of the paged KV pool.  ``num_blocks=None`` sizes the
    arena so every slot can hold a ``max_context`` request at once."""
    max_slots: int = 8          # concurrent in-flight requests
    block_size: int = 16        # tokens per KV block
    max_context: int = 512      # per-request cap (prompt + generation)
    num_blocks: int | None = None
    prefill_chunk: int = 32     # prompt tokens per engine iteration
    prefix_cache: bool = False  # not ported yet (ROADMAP Queue 1 item 3)

    def __post_init__(self):
        if self.prefix_cache:
            raise NotImplementedError(
                "the prefix cache is not ported yet (ROADMAP Queue 1 item 3: "
                "prefix cache, copy-on-write and preemption)")

    def resolved_num_blocks(self, cfg: ModelConfig) -> int:
        """Arena size in physical blocks (the +1 is the null block)."""
        if self.num_blocks is not None:
            return self.num_blocks
        per = request_blocks(cfg, self, self.max_context)
        return 1 + self.max_slots * max(per, 1)


def request_blocks(cfg: ModelConfig, pool: PoolConfig, total_len: int) -> int:
    """Blocks a request of ``total_len`` tokens needs.  Sliding-window archs
    are capped at the window: their blocks are ring-reused in place."""
    cap = decmod.attn_capacity(cfg, total_len)
    return -(-cap // pool.block_size)


class BlockAllocator:
    """Host-side refcounted ownership of physical blocks; block 0 reserved."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least the null block + one real block")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))   # pop() -> 1, 2, ...
        self._ref: dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """n private block ids (refcount 1 each), or None if the pool can't
        satisfy it now."""
        if n > self.free_blocks:
            return None
        out = []
        for _ in range(n):
            b = self._free.pop()
            self._ref[b] = 1
            out.append(b)
        return out

    def decref(self, block: int) -> None:
        """Release one reference; a block at zero returns to the free list."""
        r = self._ref[block] - 1
        if r > 0:
            self._ref[block] = r
            return
        del self._ref[block]
        self._free.append(block)

    def free(self, blocks: list[int]) -> None:
        """Release one reference on each block (request teardown)."""
        for b in blocks:
            self.decref(b)


def init_pool_caches(cfg: ModelConfig, pool: PoolConfig, device) -> list:
    """One {"k", "v"} arena pair per layer, each (num_blocks, block_size,
    KV, hd) f32 zeros on ``device``.  (bf16 arenas wait for a workload that
    needs them; the attention kernel already reads both.)"""
    shape = (pool.resolved_num_blocks(cfg), pool.block_size, cfg.n_kv, cfg.hd)
    return [{"k": torch.zeros(shape, dtype=torch.float32, device=device),
             "v": torch.zeros(shape, dtype=torch.float32, device=device)}
            for _ in range(cfg.n_layers)]
