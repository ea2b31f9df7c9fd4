"""Paged KV-cache pool (port of ``repro/serve/pool.py`` for attention archs).

A fixed arena of (num_blocks, block_size, KV, hd) blocks per layer, shared by
all in-flight requests; a physical block id addresses the same slab in every
layer's arena, so one block table serves the whole stack.  Physical block 0
is the null block: unallocated block-table entries point at it and
inactive-slot writes land in it; stored-position masks guarantee it is never
read as a real key.

Block ownership: ``BlockAllocator`` refcounts every live block.  A block
whose refcount drops to zero returns to the free list unless its contents
are registered in the ``PrefixCache``; then it parks on an LRU list, still
holding its KV, and is evicted (hash entry dropped, block reusable) only
when an allocation cannot be met from the free list.  The cache is
content-addressed: a full block is keyed by a hash chain over (parent hash,
block tokens), so a lookup walks the prompt block by block and two requests
sharing a prompt prefix share physical blocks.  Drop-and-replay preemption
rides on the same parking: the engine registers a victim's fully written
blocks before releasing them, so its replay walks them as cache hits.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

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
    prefix_cache: bool = True   # content-addressed KV block reuse (engines
    #   enable it only for archs whose blocks are immutable once written)

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


class PrefixCache:
    """Content-addressed index over full KV blocks.

    A block holding tokens ``t`` whose predecessor blocks hash to ``parent``
    is keyed by ``chain_hash(parent, t)``; the chain root is ``None``.  The
    index only names blocks: ownership (refcounts, eviction order) lives in
    ``BlockAllocator``, which calls :meth:`_evict` when it reclaims a cached
    block under allocation pressure.
    """

    ROOT = None

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._by_hash: dict = {}     # hash -> (block, parent, tokens)
        self._by_block: dict = {}    # block -> hash
        self._children: dict = {}    # parent hash -> set of child hashes
        self.evictions = 0

    @staticmethod
    def chain_hash(parent, tokens) -> int:
        return hash((parent,) + tuple(int(t) for t in tokens))

    def __len__(self) -> int:
        return len(self._by_hash)

    def contains_block(self, block: int) -> bool:
        return block in self._by_block

    def register(self, parent, tokens, block: int):
        """Register a fully written block; first content wins (an existing
        entry for the same chain keeps its block).  Returns the chain hash,
        the ``parent`` of the request's next block."""
        h = self.chain_hash(parent, tokens)
        if h not in self._by_hash:
            self._by_hash[h] = (block, parent, tuple(int(t) for t in tokens))
            self._by_block[block] = h
            self._children.setdefault(parent, set()).add(h)
        return h

    def match(self, prompt, max_tokens: int):
        """Longest cached prefix of ``prompt``, capped at ``max_tokens``
        (callers pass plen - 1, so at least one prompt token is recomputed
        for the first-token logits).

        Returns ``(hit_blocks, parent_hash, cached_tokens, cow_block)``:
        ``hit_blocks`` are whole-block hits in prompt order;
        ``cached_tokens = len(hit_blocks) * bs + lcp``, where ``lcp > 0``
        means ``cow_block`` is a cached block whose first ``lcp`` tokens
        match the prompt past the last full hit: the caller takes a private
        copy-on-write copy before writing positions ``>= cached``.
        """
        bs = self.block_size
        hits: list[int] = []
        parent = self.ROOT
        k = 0
        while (k + 1) * bs <= max_tokens:
            block_toks = tuple(int(t) for t in prompt[k * bs:(k + 1) * bs])
            h = self.chain_hash(parent, block_toks)
            ent = self._by_hash.get(h)
            # a hash hit alone is not trusted: the stored tokens must match
            # too, or a chain_hash collision would serve another sequence's KV
            if ent is None or ent[2] != block_toks:
                break
            hits.append(ent[0])
            parent = h
            k += 1
        cached = k * bs
        # mid-block divergence: the longest token-level common prefix among
        # the cached children of the last fully matched block
        cow: Optional[int] = None
        best = 0
        rest = [int(t) for t in prompt[cached:max_tokens]]
        if rest:
            for h in self._children.get(parent, ()):
                ent = self._by_hash.get(h)
                if ent is None:
                    continue
                blk, _, toks = ent
                lcp = 0
                for a, b in zip(rest, toks):
                    if a != b:
                        break
                    lcp += 1
                if lcp > best:
                    best, cow = lcp, blk
        return hits, parent, cached + best, cow

    def _evict(self, block: int) -> None:
        """Drop the entry naming ``block`` (the allocator reclaimed it).  A
        child chained off an evicted parent becomes unreachable to ``match``
        and ages out of the LRU on its own."""
        h = self._by_block.pop(block)
        _, parent, _ = self._by_hash.pop(h)
        kids = self._children.get(parent)
        if kids is not None:
            kids.discard(h)
            if not kids:
                del self._children[parent]
        self.evictions += 1


class BlockAllocator:
    """Host-side refcounted ownership of physical blocks; block 0 reserved.

    Free blocks live on ``_free``, referenced ones in ``_ref`` (block ->
    count); cached blocks nobody references park in ``_lru`` (insertion
    order = eviction order) and are reclaimed, oldest first and with the
    attached ``PrefixCache`` told, only when ``alloc`` outgrows the free
    list.
    """

    def __init__(self, num_blocks: int, cache: PrefixCache | None = None):
        if num_blocks < 2:
            raise ValueError("need at least the null block + one real block")
        self.num_blocks = num_blocks
        self.cache = cache
        self._free = list(range(num_blocks - 1, 0, -1))   # pop() -> 1, 2, ...
        self._ref: dict[int, int] = {}
        self._lru: collections.OrderedDict[int, bool] = (
            collections.OrderedDict())

    @property
    def free_blocks(self) -> int:
        """Blocks an ``alloc`` could hand out now (cached idle blocks are
        reclaimable, so they count)."""
        return len(self._free) + len(self._lru)

    @property
    def cached_idle_blocks(self) -> int:
        return len(self._lru)

    def alloc(self, n: int) -> list[int] | None:
        """n private block ids (refcount 1 each), or None if the pool can't
        satisfy it now.  Evicts LRU cached blocks only under pressure."""
        if n > self.free_blocks:
            return None
        out = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                b, _ = self._lru.popitem(last=False)     # LRU eviction
                if self.cache is not None:
                    self.cache._evict(b)
            self._ref[b] = 1
            out.append(b)
        return out

    def incref(self, block: int) -> None:
        """Take a reference on a live or cached idle block (a prefix hit)."""
        if block in self._ref:
            self._ref[block] += 1
        else:
            del self._lru[block]                          # revive from LRU
            self._ref[block] = 1

    def decref(self, block: int) -> None:
        """Release one reference; a block at zero parks in the LRU if its
        contents are cached, else returns to the free list."""
        r = self._ref[block] - 1
        if r > 0:
            self._ref[block] = r
            return
        del self._ref[block]
        if self.cache is not None and self.cache.contains_block(block):
            self._lru[block] = True
        else:
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
