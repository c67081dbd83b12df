"""Serving layer of the port: scheduler, slot pool, block pool, static and
continuous engines, and the multi-rank serving fabric."""

from repro_torch.serve.block_pool import BlockPool, PagedKVCache
from repro_torch.serve.engine import (ContinuousEngine, KVHandoff,
                                      StaticEngine)
from repro_torch.serve.fabric import (DisaggregatedPlacement, EngineWorker,
                                      KVBlockTransport, ReplicatedPlacement,
                                      ServingFabric)
from repro_torch.serve.kv_cache import (LeaseLeakError, LeaseLeakWarning,
                                        SlotError, SlotKVCache)
from repro_torch.serve.scheduler import (CellQueueScheduler, ServeRequest,
                                         TraceEntry, latency_stats_over,
                                         make_trace, shard_trace)
