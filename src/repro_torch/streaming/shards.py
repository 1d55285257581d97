"""Sharded keyed-state plane for the dataflow engine (DESIGN.md §9).

Keyed state is partitioned into ``n_shards`` hash shards (Flink key groups
/ Megaphone bins): ``shard = hash_partition(key, n_shards)``, and an owner
table maps each shard to the stateful subtask holding its cache + backend
partition.  Channels partition by OWNERSHIP, not by ``hash(key) % p`` —
the routed plane is what lets the upstream hint side channel deliver each
hint to the one subtask whose prefetcher can act on it (a hint landing
anywhere else stages state into a cache no tuple for that key will ever
probe).

Migration (``StatefulOp.migrate_shard``) reassigns a shard between
subtasks with Megaphone-style fluidity: ownership flips immediately (new
traffic routes to the destination and PARKS), the source drains its cache
entries and backend partition, the hot entries ride a modelled bulk
transfer, and the destination re-admits them with preserved timestamps
before replaying everything parked.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

# calibrated migration constants (DESIGN.md §8): one RTT to set up the
# transfer plus state bytes at backbone bandwidth
MIGRATE_RTT = 500e-6
MIGRATE_BANDWIDTH = 1.2e9


def hash_partition(key: Any, n: int) -> int:
    """Canonical key partitioner (also the engine's channel default).

    Window-pane keys (``WindowKey`` — anything exposing ``.base``) hash by
    their BASE key: every pane of a key, and every hint for one, must land
    on the subtask that owns the key itself (DESIGN.md §10)."""
    key = getattr(key, "base", key)
    return hash(key) % n if key is not None else 0


class ShardPlane:
    """Shard ownership + routing state for one stateful operator.

    ``owner[shard]`` is the subtask currently owning the shard; shards in
    ``migrating`` have flipped ownership but their state is still in
    transit, so the new owner parks traffic for them.  Counters are
    per-shard and surfaced by ``Engine.metrics``.
    """

    def __init__(self, n_shards: int, n_owners: int,
                 owners: Optional[List[int]] = None):
        if n_shards < n_owners:
            raise ValueError(f"n_shards={n_shards} < n_owners={n_owners}")
        self.n_shards = n_shards
        self.n_owners = n_owners
        self.owner = list(owners) if owners is not None \
            else [s % n_owners for s in range(n_shards)]
        if len(self.owner) != n_shards or \
                not all(0 <= o < n_owners for o in self.owner):
            raise ValueError("owners must map every shard to a subtask")
        self.migrating: Dict[int, int] = {}     # shard -> destination sub
        # when the last migration LANDED: the checkpoint coordinator keeps
        # deferring triggers for a short quiesce after this, so the tail
        # of stale-partitioned in-flight traffic (forwarded around the
        # flip with no channel origin) drains before any barrier cut
        # (DESIGN.md §7 ∩ §9)
        self.last_finish_t = float("-inf")
        # per-shard counters
        self.hints_routed = [0] * n_shards
        self.tuples_routed = [0] * n_shards
        self.prefetch_hits = [0] * n_shards
        self.migrations = 0
        self.misroutes = 0
        self.parked_in_migration = 0

    # -------------------------------------------------------------- routing
    def shard_of(self, key: Any) -> int:
        return hash_partition(key, self.n_shards)

    def owner_of(self, key: Any) -> int:
        return self.owner[self.shard_of(key)]

    def route_data(self, key: Any, n: int) -> int:
        """Channel partition fn for the data edge into the stateful op."""
        s = self.shard_of(key)
        self.tuples_routed[s] += 1
        return self.owner[s]

    def route_hint(self, key: Any, n: int) -> int:
        """Channel partition fn for the hint side channel: each hint goes
        to the owning shard's prefetcher, never broadcast."""
        s = self.shard_of(key)
        self.hints_routed[s] += 1
        return self.owner[s]

    # ------------------------------------------------------------ migration
    def begin_migration(self, shard: int, dst: int) -> int:
        """Flip ownership (new traffic routes to ``dst`` and parks there);
        returns the previous owner."""
        src = self.owner[shard]
        self.owner[shard] = dst
        self.migrating[shard] = dst
        return src

    def finish_migration(self, shard: int) -> None:
        self.migrating.pop(shard, None)
        self.migrations += 1

    # -------------------------------------------------------------- metrics
    def snapshot(self) -> Dict[str, Any]:
        return {
            "n_shards": self.n_shards,
            "owner": list(self.owner),
            "hints_routed": list(self.hints_routed),
            "tuples_routed": list(self.tuples_routed),
            "prefetch_hits": list(self.prefetch_hits),
            "migrations": self.migrations,
            "misroutes": self.misroutes,
            "parked_in_migration": self.parked_in_migration,
        }

    def registry_sync(self, registry, prefix: str,
                      pending: Optional[Dict[int, list]] = None) -> None:
        """Mirror the routed-plane counters into the metrics registry
        under ``<prefix>.shard.<i>.*`` / ``<prefix>.shards.*``
        (DESIGN.md §12); called by ``Engine._sync_registry`` at
        snapshot/export time."""
        for i in range(self.n_shards):
            registry.counter(f"{prefix}.shard.{i}.hints_routed").set(
                self.hints_routed[i])
            registry.counter(f"{prefix}.shard.{i}.prefetch_hits").set(
                self.prefetch_hits[i])
            registry.gauge(f"{prefix}.shard.{i}.pending").set(
                len(pending.get(i, [])) if pending else 0)
        registry.counter(f"{prefix}.shards.misroutes").set(self.misroutes)
        registry.counter(f"{prefix}.shards.migrations").set(self.migrations)
