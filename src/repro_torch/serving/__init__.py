"""Batched integer serving over a paged KV cache."""
from repro_torch.serving.engine import EngineStalled, Request, ServingEngine
from repro_torch.serving.kvcache import (BlockAllocator, CacheLayout,
                                         NULL_PAGE, PagedKVCache,
                                         PagePoolExhausted, PageTable,
                                         PrefixEntry, PrefixIndex, Session)

__all__ = ["ServingEngine", "Request", "EngineStalled", "BlockAllocator",
           "CacheLayout", "NULL_PAGE", "PagedKVCache", "PagePoolExhausted",
           "PageTable", "PrefixEntry", "PrefixIndex", "Session"]
