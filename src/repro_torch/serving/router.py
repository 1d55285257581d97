# Copy of repro/serving/router.py; differs only where page blocks are built,
# sliced and joined: they are torch tensors on the host, not numpy arrays.
"""Sharded keyed-state plane for serving (DESIGN.md §9).

``ShardRouter`` runs N per-shard ``PagedStateArena`` + ``TieredStore``
pairs behind the SAME batched interface the single-owner pair exposes, so
``ContinuousBatchingScheduler`` drives a sharded plane unchanged — it is
handed the router as both its ``arena`` and its ``store``.

Ownership is bin-based (Megaphone-style): keys hash into ``n_bins``
logical bins (``bin = key % n_bins``, the device twin of the engine's
``hash_partition``) and an owner table maps bins to shards.  Every batched
call is SPLIT by owner, dispatched to the owning shard's arena/store, and
merged back in the caller's key order; physical slots are globalized as
``shard * slots_per_shard + local_slot`` so an admit's slots can be handed
straight back to ``stage``.

``migrate_bins`` is the key-range migration primitive: drain the moving
bins out of each source arena (one batched ``page_gather`` per pool),
carry tier contents and in-flight stage requests across, flip ownership,
and re-admit at the destination with PRESERVED timestamps and dirty bits —
a prefetched page whose hint timestamp lies in the future stays protected
across the move, and the prefetch-timeliness accounting stays correct per
shard.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serving.arena import Admitted, PagedStateArena
from repro_torch.serving.store import TieredStore


class ShardRouter:
    """Arena + store facade over per-shard (PagedStateArena, TieredStore).

    ``arena_factory(shard)`` / ``store_factory(shard)`` build one shard's
    pair; all arenas must have identical geometry (slot ids are globalized
    by uniform stride).  ``owners`` optionally seeds the bin->shard table
    (default: round-robin).
    """

    def __init__(self, n_shards: int,
                 arena_factory: Callable[[int], PagedStateArena],
                 store_factory: Callable[[int], TieredStore],
                 n_bins: int = 64,
                 owners: Optional[Sequence[int]] = None):
        if n_bins < n_shards:
            raise ValueError(f"n_bins={n_bins} < n_shards={n_shards}")
        self.n_shards = n_shards
        self.n_bins = n_bins
        self.arenas = [arena_factory(s) for s in range(n_shards)]
        self.stores = [store_factory(s) for s in range(n_shards)]
        slots = {a.n_slots for a in self.arenas}
        if len(slots) != 1:
            raise ValueError("all shard arenas must share one geometry "
                             f"(got n_slots {sorted(slots)})")
        self.slots_per_shard = self.arenas[0].n_slots
        from repro_torch.launch.sharding import shard_owner_map
        self.owner = np.asarray(
            owners if owners is not None
            else shard_owner_map(n_bins, n_shards), np.int32)
        if self.owner.shape != (n_bins,) or \
                not ((0 <= self.owner) & (self.owner < n_shards)).all():
            raise ValueError("owners must map every bin to a valid shard")
        # routed-plane counters (per shard; Engine.metrics analogue)
        self.hints_routed = np.zeros(n_shards, np.int64)
        self.pages_routed = np.zeros(n_shards, np.int64)
        self.hits = 0
        self.misses = 0
        self.migrations = 0
        self.pages_migrated = 0
        self.tier_entries_migrated = 0

    # -------------------------------------------------------------- routing
    def bin_of(self, keys: np.ndarray) -> np.ndarray:
        return np.mod(np.asarray(keys, np.int64), self.n_bins)

    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        """Owning shard per key via the bin table."""
        return self.owner[self.bin_of(keys)]

    def _split(self, keys: np.ndarray) -> List[Tuple[int, np.ndarray]]:
        """(shard, caller-order indices) for each shard with any keys."""
        keys = np.asarray(keys)
        if keys.size == 0:
            return []
        shards = self.shard_of(keys)
        return [(s, np.nonzero(shards == s)[0])
                for s in np.unique(shards)]

    # --------------------------------------------------- arena facade: probe
    @property
    def n_slots(self) -> int:
        return self.slots_per_shard * self.n_shards

    def probe(self, keys, now_ts=None, count: bool = True
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched cross-shard residency probe; slots come back globalized.
        Misrouted keys cannot refresh a foreign shard's entries because
        each subset only ever reaches its owner."""
        keys = np.asarray(keys)
        hit = np.zeros(keys.shape[0], bool)
        slots = np.full(keys.shape[0], -1, np.int32)
        for s, idx in self._split(keys):
            ts_s = None if now_ts is None else np.asarray(now_ts)[idx]
            h, sl = self.arenas[s].probe(keys[idx], now_ts=ts_s, count=count)
            hit[idx] = h
            slots[idx] = np.where(sl >= 0,
                                  sl + s * self.slots_per_shard, -1)
        if count:
            self.hits += int(hit.sum())
            self.misses += int((~hit).sum())
        return hit, slots

    def count_access(self, hits: int, misses: int) -> None:
        """Scheduler-side access accounting (probes ran with count=False)."""
        self.hits += int(hits)
        self.misses += int(misses)

    def renew(self, keys, ts) -> None:
        keys = np.asarray(keys)
        ts = np.asarray(ts)
        for s, idx in self._split(keys):
            self.arenas[s].renew(keys[idx], ts[idx])
            self.hints_routed[s] += len(idx)

    # --------------------------------------------------- arena facade: admit
    def _pool_row_shapes(self) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
        a = self.arenas[0]
        return {name: (pool.shape[1:], pool.dtype)
                for name, pool in a.pools.items()}

    def admit(self, keys, ts, dirty=None) -> Admitted:
        """Batched multi-shard admission, merged in caller key order.
        ``evicted_blocks`` rows align with the merged batch; shards with no
        dirty victims contribute zero rows (filtered by the -1/dirty mask
        exactly as with a single arena)."""
        keys = np.asarray(keys)
        n = keys.shape[0]
        slots = np.zeros(n, np.int32)
        ev_k = np.full(n, -1, np.int32)
        ev_d = np.zeros(n, bool)
        parts: List[Tuple[np.ndarray, Dict[str, torch.Tensor]]] = []
        for s, idx in self._split(keys):
            d_s = None if dirty is None else np.asarray(dirty)[idx]
            adm = self.arenas[s].admit(keys[idx], np.asarray(ts)[idx],
                                       dirty=d_s)
            slots[idx] = adm.slots + s * self.slots_per_shard
            ev_k[idx] = adm.evicted_keys
            ev_d[idx] = adm.evicted_dirty
            self.pages_routed[s] += len(idx)
            if adm.evicted_blocks:
                parts.append((idx, adm.evicted_blocks))
        blocks: Dict[str, torch.Tensor] = {}
        if parts:
            for name, (shape, dtype) in self._pool_row_shapes().items():
                rows = torch.zeros((n, *shape), dtype=dtype)
                for idx, blk in parts:
                    rows[torch.from_numpy(idx)] = blk[name]
                blocks[name] = rows
        return Admitted(slots, ev_k, ev_d, blocks)

    def stage(self, slots, blocks: Dict[str, Any]) -> None:
        """Scatter staged pages through each owning shard's arena; ``slots``
        are the globalized ids ``admit`` returned."""
        slots = np.asarray(slots, np.int32)
        if slots.size == 0:
            return
        shards = slots // self.slots_per_shard
        for s in np.unique(shards):
            idx = np.nonzero(shards == s)[0]
            self.arenas[s].stage(slots[idx] - s * self.slots_per_shard,
                                 {name: torch.as_tensor(blk)[
                                     torch.from_numpy(idx)]
                                  for name, blk in blocks.items()})

    def mark_dirty(self, keys) -> None:
        keys = np.asarray(keys)
        for s, idx in self._split(keys):
            self.arenas[s].mark_dirty(keys[idx])

    def flush_dirty(self) -> Tuple[np.ndarray, Dict[str, torch.Tensor]]:
        keys_all: List[np.ndarray] = []
        rows: Dict[str, List[torch.Tensor]] = {}
        for a in self.arenas:
            keys, blocks = a.flush_dirty()
            if len(keys) == 0:
                continue
            keys_all.append(keys)
            for name, blk in blocks.items():
                rows.setdefault(name, []).append(blk)
        if not keys_all:
            return np.zeros((0,), np.int32), {}
        return (np.concatenate(keys_all),
                {name: torch.cat(parts) for name, parts in rows.items()})

    # ----------------------------------------------------------- store facade
    def seed(self, key: Any, blocks: Any) -> None:
        self.stores[int(self.shard_of(np.asarray([key]))[0])].seed(key,
                                                                   blocks)

    def request_stage(self, keys: List[Any], now: float,
                      hint_ts: Optional[List[float]] = None) -> int:
        """Hint routing: each key's stage request goes to the shard that
        owns it (never broadcast)."""
        keys_arr = np.asarray(keys)
        n = 0
        for s, idx in self._split(keys_arr):
            hs = None if hint_ts is None else [hint_ts[i] for i in idx]
            n += self.stores[s].request_stage([keys[i] for i in idx],
                                              now, hs)
            self.hints_routed[s] += len(idx)
        return n

    def poll(self, now: float) -> List[Tuple[Any, Any, float]]:
        out: List[Tuple[Any, Any, float]] = []
        for st in self.stores:
            out.extend(st.poll(now))
        return out

    def fetch_sync(self, keys: List[Any], now: float
                   ) -> Tuple[List[Any], float]:
        """On-demand staging across shards: per-shard makespans overlap
        (independent lane pools), so the critical path is their max."""
        blocks: List[Any] = [None] * len(keys)
        lat = 0.0
        for s, idx in self._split(np.asarray(keys)):
            blk, l = self.stores[s].fetch_sync([keys[i] for i in idx], now)
            for j, i in enumerate(idx):
                blocks[i] = blk[j]
            lat = max(lat, l)
        return blocks, lat

    def writeback(self, key: Any, blocks: Any) -> None:
        self.stores[int(self.shard_of(np.asarray([key]))[0])].writeback(
            key, blocks)

    def persist(self) -> int:
        return sum(st.persist() for st in self.stores)

    @property
    def in_flight(self) -> Dict[Any, Tuple[float, Any, float, float]]:
        merged: Dict[Any, Tuple[float, Any, float, float]] = {}
        for st in self.stores:
            merged.update(st.in_flight)
        return merged

    # -------------------------------------------------------------- migration
    def migrate_bins(self, bins: Sequence[int], dst: int) -> Dict[str, int]:
        """Move ownership of ``bins`` to shard ``dst`` (drain -> batched
        page transfer -> re-admit with preserved timestamps).  Dirty victims
        displaced at the destination go through its store's write-back path,
        exactly like a workload admission."""
        bins_arr = np.asarray(sorted(set(int(b) for b in bins)), np.int64)
        if ((bins_arr < 0) | (bins_arr >= self.n_bins)).any():
            raise ValueError("bin out of range")
        if not 0 <= dst < self.n_shards:
            raise ValueError("dst shard out of range")
        srcs = {int(s) for s in np.unique(self.owner[bins_arr])} - {dst}
        pages = entries = 0
        key_pred = lambda k: bool(np.isin(int(k) % self.n_bins, bins_arr))
        vec_pred = lambda keys: np.isin(np.mod(keys, self.n_bins), bins_arr)
        for src in srcs:
            keys, ts, dirty, blocks = self.arenas[src].export_where(vec_pred)
            if len(keys):
                adm = self.arenas[dst].admit(keys, ts, dirty=dirty)
                mask = (adm.evicted_keys >= 0) & adm.evicted_dirty
                for i in np.nonzero(mask)[0]:
                    self.stores[dst].writeback(
                        int(adm.evicted_keys[i]),
                        {p: blk[i] for p, blk in
                         adm.evicted_blocks.items()})
                self.arenas[dst].stage(adm.slots, blocks)
                pages += len(keys)
            entries += self.stores[dst].import_keys(
                self.stores[src].export_keys(key_pred))
        self.owner[bins_arr] = dst
        self.migrations += 1
        self.pages_migrated += pages
        self.tier_entries_migrated += entries
        return {"pages": pages, "tier_entries": entries,
                "sources": len(srcs)}

    # ---------------------------------------------------------------- metrics
    def stats(self) -> Dict[str, Any]:
        tot = self.hits + self.misses
        out: Dict[str, Any] = {
            "arena_hits": self.hits, "arena_misses": self.misses,
            "arena_hit_rate": self.hits / tot if tot else 0.0,
            "n_shards": self.n_shards, "n_bins": self.n_bins,
            "router_migrations": self.migrations,
            "router_pages_migrated": self.pages_migrated,
            "router_tier_entries_migrated": self.tier_entries_migrated,
            "shard_hints_routed": self.hints_routed.tolist(),
            "shard_pages_routed": self.pages_routed.tolist(),
        }
        arena_stats = [a.stats() for a in self.arenas]
        store_stats = [st.stats() for st in self.stores]
        sums: Dict[str, float] = {}
        for s in arena_stats:
            for k, v in s.items():
                if k not in ("arena_hits", "arena_misses", "arena_hit_rate"):
                    sums[k] = sums.get(k, 0) + v
        hidden = critical = 0.0
        for s in store_stats:
            hidden += s["store_hidden_latency"]
            critical += s["store_critical_latency"]
            for k, v in s.items():
                if k != "staging_overlap":
                    sums[k] = sums.get(k, 0) + v
        out.update(sums)
        tot_lat = hidden + critical
        out["staging_overlap"] = hidden / tot_lat if tot_lat else 0.0
        out["shard_arena_hit_rate"] = [s["arena_hit_rate"]
                                       for s in arena_stats]
        out["shard_prefetch_staged"] = [s["store_staged_pages"]
                                        for s in store_stats]
        return out
