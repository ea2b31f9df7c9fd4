"""Continuous-batching serving engine over a paged KV-cache pool (port of
``repro/serve`` for attention decoders).

``pool``   — fixed block arena per layer + block tables + refcounted
             block ownership + the content-addressed prefix cache.
``engine`` — request queue, admission control (longest cached prefix,
             copy-on-write), chunked prefill interleaved with decode,
             self-speculative decoding, per-request completion,
             preemption and cancel, re-entrant ``step()``.
"""
from .engine import PagedServer, Request, RequestResult, speculative_accept
from .pool import (BlockAllocator, PoolConfig, PrefixCache, init_pool_caches,
                   request_blocks)

__all__ = ["PagedServer", "Request", "RequestResult", "speculative_accept",
           "BlockAllocator", "PoolConfig", "PrefixCache", "init_pool_caches",
           "request_blocks"]
