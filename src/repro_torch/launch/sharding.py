"""Placement for the sharded keyed-state plane (DESIGN.md §9).

Only ``shard_owner_map`` is ported so far: the serving router builds its
default bin table from it.  Its source equals the reference's
(tests/test_torch_isolation.py).  The logical-axis sharding rules of the
reference module come with the launch slice of the port.
"""
from __future__ import annotations


def shard_owner_map(n_shards: int, n_owners: int) -> list:
    """Round-robin shard->owner table.  ``ShardRouter`` builds its default
    bin table from this; ``ShardPlane`` (streaming side, deliberately
    jax-free) keeps an identical inline copy — change both together."""
    if n_shards < n_owners:
        raise ValueError(f"n_shards={n_shards} < n_owners={n_owners}")
    return [s % n_owners for s in range(n_shards)]
