"""Tiered memory: the counterpart of ``hpc_patterns_tpu/memory/``.

- ``kinds.py``: which memory kinds a device really has (the card, pinned
  host memory) and the cached transfer callables every consumer shares;
- ``residency.py``: the manager that owns WHERE each block of serving KV
  or training optimizer state lives — per-block tier, pin state, policy,
  and the side-stream prefetch/evict pipeline measured through the flight
  recorder;
- ``prefix_cache.py``: the radix prefix index that lets the serving arena
  share pages across requests with common prompt prefixes.

Consumers: ``models/serving.py`` (``EngineCore(residency=...)``,
``EngineCore(prefix_cache=True)``), ``models/train.py``
(``offload_opt_state``, ``make_train_step(..., residency=...)``),
``concurrency/commands.py`` and ``apps/common.py`` (the probes).
"""

from hpc_patterns_tpu_torch.memory.prefix_cache import RadixPrefixCache
from hpc_patterns_tpu_torch.memory.kinds import (
    kind_sharding,
    memory_kind_placement_works,
    memory_kind_shardings,
    memory_kind_transfers_work,
    move_to_kind,
    supports_memory_kind,
)
from hpc_patterns_tpu_torch.memory.residency import (
    BlockState,
    ColdAfterNPolicy,
    EvictionPolicy,
    LRUPolicy,
    PriorityAwarePolicy,
    ResidencyManager,
)

__all__ = [
    "BlockState",
    "ColdAfterNPolicy",
    "EvictionPolicy",
    "LRUPolicy",
    "PriorityAwarePolicy",
    "RadixPrefixCache",
    "ResidencyManager",
    "kind_sharding",
    "memory_kind_placement_works",
    "memory_kind_shardings",
    "memory_kind_transfers_work",
    "move_to_kind",
    "supports_memory_kind",
]
