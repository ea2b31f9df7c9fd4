"""Continuous-batching serving engine over a paged KV-cache pool (port of
``repro/serve`` for attention decoders).

``pool``   — fixed block arena per layer + block tables + refcounted
             block ownership.
``engine`` — request queue, admission control, chunked prefill
             interleaved with decode, per-request completion,
             re-entrant ``step()``.
"""
from .engine import PagedServer, Request, RequestResult
from .pool import BlockAllocator, PoolConfig, init_pool_caches, request_blocks

__all__ = ["PagedServer", "Request", "RequestResult", "BlockAllocator",
           "PoolConfig", "init_pool_caches", "request_blocks"]
