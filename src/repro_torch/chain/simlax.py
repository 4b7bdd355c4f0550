"""Configuration of the vectorized federation engine.

Only ``SimLaxConfig`` is ported so far, with the JAX package's fields and
defaults, because the §VI recipe (``scenarios.lenet_paper_setup``) returns
one and ``scenarios.make_heap_simulator`` reads the heap simulator's
settings from it. The vectorized engine itself (``LaxSimulator`` with its
dense, sparse, compact and sharded delivery engines) is a later slice of
the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class SimLaxConfig:
    ticks: int = 200
    train_interval: tuple = (8, 16)   # uniform random ticks between trains
    latency: int = 2                  # per-hop delivery delay (ticks)
    ttl: int = 2                      # flood radius (hops)
    record_every: int = 10
    seed: int = 0
    delivery: str = "compact"         # receipt engine of the vectorized engine
    shards: Optional[int] = None      # sharded engine: device count
    compact_budget: Optional[int] = None   # compact engine work-buffer width
    compress: Optional[str] = None    # None | "int8" wire quantization
    # ^ "int8": every broadcast payload is quantize->dequantize round-
    #   tripped ONCE at the sender (repro_torch.core.compression), so all
    #   receivers of that broadcast see the identical reconstruction.
    #   Attacks apply BEFORE quantization; committed params stay full
    #   precision — only the wire payload is lossy.
