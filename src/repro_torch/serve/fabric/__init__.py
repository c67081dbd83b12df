"""Multi-rank serving fabric over the threadcomm substrate (the port of
the reference's ``serve/fabric``): a router rank and N engine ranks,
replicated or prefill/decode-disaggregated placement, request-based
KV-block migration."""

from repro_torch.serve.fabric.placement import (DisaggregatedPlacement,
                                                Placement,
                                                ReplicatedPlacement,
                                                make_placement)
from repro_torch.serve.fabric.router import ServingFabric
from repro_torch.serve.fabric.transport import KVBlockTransport
from repro_torch.serve.fabric.worker import EngineWorker
