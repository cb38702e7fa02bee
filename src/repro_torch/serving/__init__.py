"""Batched integer serving over a paged KV cache, its asyncio front end
and self-speculative decoding."""
from repro_torch.serving.engine import (EngineStalled, PendingStep, Request,
                                        ServingEngine, StepInFlight)
from repro_torch.serving.frontend import (QueueFull, RequestMetrics,
                                          ServingFrontend, StreamHandle,
                                          TERMINAL_STATES)
from repro_torch.serving.kvcache import (BlockAllocator, CacheLayout,
                                         NULL_PAGE, PagedKVCache,
                                         PagePoolExhausted, PageTable,
                                         PrefixEntry, PrefixIndex, Session)
from repro_torch.serving.speculate import (NgramProposer, Proposer,
                                           SpeculationError,
                                           SpeculationUnsupported,
                                           get_proposer, validate_spec)

__all__ = ["ServingEngine", "Request", "EngineStalled", "PendingStep",
           "StepInFlight", "ServingFrontend", "StreamHandle", "QueueFull",
           "RequestMetrics", "TERMINAL_STATES", "BlockAllocator",
           "CacheLayout", "NULL_PAGE", "PagedKVCache", "PagePoolExhausted",
           "PageTable", "PrefixEntry", "PrefixIndex", "Session",
           "NgramProposer", "Proposer", "SpeculationError",
           "SpeculationUnsupported", "get_proposer", "validate_spec"]
