"""Device-resident paged state arena (DESIGN.md §6), on PyTorch tensors.

The port of ``repro/serving/arena.py``.  The physical page pool lives in
fixed device slots (one or more parallel pools — e.g. K pages and V pages —
sharing slot indices); the device TAC (``repro_torch.core.tac_torch``) is
its page table.  All APIs are BATCHED: a probe, admit, stage or victim
gather over N pages is one kernel launch per pool, never a per-page loop.

Admission reuses the TAC's eviction rule (min-timestamp way within the
key's bucket); dirty victims are surfaced — with their page contents
gathered BEFORE restaging overwrites the slots — so the caller (the tiered
store / scheduler) can write them back.

Pages that leave the device for the store — the victims an admission
displaces and the dirty pages ``flush_dirty`` drains — are copied to the
host once per call (one device-to-host copy per pool, not one per page),
so device memory does not grow with the pages written back; the scheduler
and the store slice those host tensors row by row.  ``gather`` and
``export_where`` leave their pages on the device, where the caller stages
them again.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import tac_torch
from repro_torch.kernels.page_gather.page_gather import (gather_in_range,
                                                         scatter_in_range)
from repro_torch.kernels.tac_probe.ops import (bucket_of, tac_probe,
                                               tac_probe_counted)
from repro_torch.obs import NULL_COUNTER


class Admitted(NamedTuple):
    slots: np.ndarray           # [N] flat physical slot per admitted key
    evicted_keys: np.ndarray    # [N] displaced key (-1 = none)
    evicted_dirty: np.ndarray   # [N] displaced key's dirty bit
    evicted_blocks: Dict[str, torch.Tensor]  # victim page contents per pool,
    #                             gathered pre-staging, on the host; rows
    #                             align with slots


class PagedStateArena:
    """Fixed-slot page pool with a TAC page table.

    ``pools`` maps pool name -> ((page, d), torch dtype); every pool holds
    ``n_buckets * ways`` physical pages addressed by the same slot ids, on
    ``device`` ("cuda" unless the caller asks for "cpu").
    """

    def __init__(self, n_buckets: int, ways: int,
                 pools: Dict[str, Tuple[Tuple[int, int], torch.dtype]],
                 device="cuda"):
        self.n_buckets = n_buckets
        self.ways = ways
        self.n_slots = n_buckets * ways
        self.device = torch.device(device)
        self.tac = tac_torch.init(n_buckets, ways, 1, device=self.device)
        self.pools: Dict[str, torch.Tensor] = {
            name: torch.zeros((self.n_slots, *shape), dtype=dtype,
                              device=self.device)
            for name, (shape, dtype) in pools.items()}
        self.hits = 0
        self.misses = 0
        self.conflicts = 0
        self.admits = 0
        self.evictions = 0
        self.dirty_evictions = 0
        self.staged_pages = 0
        self._c_hits = self._c_misses = self._c_conflicts = NULL_COUNTER

    def bind_registry(self, registry) -> None:
        """Publish device probe tallies into a MetricsRegistry
        (DESIGN.md §12)."""
        self._c_hits = registry.counter("serving.arena.probe.hits")
        self._c_misses = registry.counter("serving.arena.probe.misses")
        self._c_conflicts = registry.counter(
            "serving.arena.probe.conflicts")

    def load_numpy(self, keys, ts, vals, dirty,
                   pools: Dict[str, np.ndarray]) -> None:
        """Make this arena hold the state another arena holds: the TAC
        fields (keys, ts, vals, dirty) and the page pools as numpy arrays,
        e.g. the reference arena's ``np.asarray(arena.tac.keys)`` and
        ``np.asarray(arena.pools[name])``.  The geometry must match."""
        state = tac_torch.state_from_numpy(keys, ts, vals, dirty,
                                           self.device)
        if any(a.shape != b.shape for a, b in zip(state, self.tac)) \
                or set(pools) != set(self.pools):
            raise ValueError("load_numpy: state or pools do not match the "
                             "arena's geometry")
        for name, arr in pools.items():
            pool = self.pools[name]
            src = torch.from_numpy(np.array(arr, np.float32))
            if src.shape != pool.shape:
                raise ValueError(f"load_numpy: pool {name!r} is "
                                 f"{tuple(src.shape)}, not "
                                 f"{tuple(pool.shape)}")
            pool.copy_(src)
        self.tac = state

    def _keys(self, keys) -> torch.Tensor:
        return torch.as_tensor(keys, device=self.device).int().reshape(-1)

    def _slots(self, slots) -> torch.Tensor:
        """Slot ids as an int32 tensor on the arena's device, checked
        against [0, n_slots): on the host before the upload, or on the
        device (one synchronisation) when they arrive as a device tensor."""
        if isinstance(slots, torch.Tensor) and slots.device.type != "cpu":
            out = slots.to(self.device).int().contiguous()
            bad = out.numel() > 0 and bool(
                ((out < 0) | (out >= self.n_slots)).any())
        else:
            host = np.asarray(slots, np.int32).reshape(-1)
            bad = bool(((host < 0) | (host >= self.n_slots)).any())
            out = torch.from_numpy(host).to(self.device)
        if bad:
            raise IndexError(f"arena: slot outside [0, {self.n_slots})")
        return out

    # -------------------------------------------------------------- probing
    def probe(self, keys, now_ts=None,
              count: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Batched residency probe.  Returns (hit [N] bool, slots [N] int32,
        -1 for misses).  With ``now_ts`` the probe is an ACCESS: hit
        timestamps are refreshed (max with now).  ``count=False`` keeps
        polling/hint probes out of the hit-rate stats (a parked request is
        probed every scheduler tick; counting those would turn the hit rate
        into a poll-frequency artifact).  The results come to the host in
        one copy."""
        keys = self._keys(keys)
        n = keys.shape[0]
        if n == 0:                            # empty batch: nothing to probe
            return (np.zeros((0,), bool), np.zeros((0,), np.int32))
        parts = []
        if count:
            # counted variant: hit/conflict tallies reduced ON DEVICE in
            # the same launch feed the registry (DESIGN.md §12)
            _, hit_d, way, tallies = tac_probe_counted(
                keys, self.tac.keys, self.tac.vals)
            parts.append(tallies)
        else:
            _, hit_d, way = tac_probe(keys, self.tac.keys, self.tac.vals)
        bucket_d = bucket_of(keys, self.n_buckets)
        if now_ts is not None:                # access: refresh hit ts
            tac_torch.refresh_ts(
                self.tac, bucket_d.long() * self.ways + way.clamp(min=0).long(),
                hit_d.bool(), now_ts)
        host = torch.cat([hit_d, way, bucket_d, *parts]).cpu().numpy()
        hit = host[:n].astype(bool)
        slots = np.where(hit, host[2 * n:3 * n] * self.ways + host[n:2 * n],
                         -1)
        if count:
            n_hit, n_conflict = (int(x) for x in host[3 * n:])
            self.hits += n_hit
            self.misses += n - n_hit
            self.conflicts += n_conflict
            self._c_hits.inc(n_hit)
            self._c_misses.inc(n - n_hit)
            self._c_conflicts.inc(n_conflict)
        return hit, slots.astype(np.int32)

    def count_access(self, hits: int, misses: int) -> None:
        """Explicit hit-rate bookkeeping for callers that probe with
        ``count=False`` and decide afterwards what constituted an access."""
        self.hits += int(hits)
        self.misses += int(misses)
        self._c_hits.inc(int(hits))
        self._c_misses.inc(int(misses))

    def page_table(self, keys) -> Tuple[np.ndarray, torch.Tensor]:
        """keys [B, P] -> (hit [B, P], table [B, P] int32 slot ids on the
        arena's device) for ``paged_decode_attention`` — one batched probe
        for all sequences."""
        keys = torch.as_tensor(keys)
        B, P = keys.shape
        hit, slots = self.probe(keys)
        return hit.reshape(B, P), \
            torch.from_numpy(slots.reshape(B, P)).to(self.device)

    def renew(self, keys, ts) -> None:
        """Hint for already-resident pages: bump predicted relevance."""
        keys = self._keys(keys)
        if keys.shape[0] == 0:
            return
        tac_torch.renew(self.tac, keys, ts)

    # ------------------------------------------------------------- admission
    def admit(self, keys, ts, dirty=None) -> Admitted:
        """Batched multi-key admission via ``tac_torch.admit_batch``.
        Chooses slots (evicting min-ts ways), gathers victim page contents
        before they can be overwritten and copies them to the host, and
        returns everything the caller needs to stage new pages and write
        dirty victims back."""
        keys = self._keys(keys)
        n = keys.shape[0]
        if n == 0:                            # empty batch: nothing to admit
            return Admitted(np.zeros((0,), np.int32),
                            np.zeros((0,), np.int32),
                            np.zeros((0,), bool), {})
        res = tac_torch.admit_batch(self.tac, keys, ts, None, dirty)
        host = torch.cat([res.slots, res.evicted_keys,
                          res.evicted_dirty.int()]).cpu().numpy()
        slots = host[:n]
        ev_k = host[n:2 * n]
        ev_d = host[2 * n:].astype(bool)
        # victim contents: gather the chosen slots BEFORE staging overwrites
        # them (rows where evicted_keys == -1 are garbage; callers filter).
        # Only DIRTY victims are ever written back, so all-clean eviction
        # rounds skip the gather entirely
        evicted_blocks = {name: gather_in_range(res.slots, pool).cpu()
                          for name, pool in self.pools.items()} \
            if bool(((ev_k >= 0) & ev_d).any()) else {}
        self.admits += n
        self.evictions += int((ev_k >= 0).sum())
        self.dirty_evictions += int((ev_d & (ev_k >= 0)).sum())
        return Admitted(slots.astype(np.int32), ev_k, ev_d, evicted_blocks)

    def stage(self, slots, blocks: Dict[str, Any]) -> None:
        """Scatter N staged pages into their physical slots (one kernel
        launch per pool); ``blocks`` rows may lie on the host or on the
        device and are converted to the pool's type."""
        slots = self._slots(slots)
        if slots.shape[0] == 0:
            return
        for name, blk in blocks.items():
            pool = self.pools[name]
            scatter_in_range(slots, torch.as_tensor(blk).to(
                device=pool.device, dtype=pool.dtype).contiguous(), pool)
        self.staged_pages += int(slots.shape[0])

    def gather(self, slots) -> Dict[str, torch.Tensor]:
        """Batched read of N physical pages from every pool (on the
        device)."""
        slots = self._slots(slots)
        return {name: gather_in_range(slots, pool)
                for name, pool in self.pools.items()}

    # ------------------------------------------------------------- migration
    def export_where(self, pred) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray, Dict[str, torch.Tensor]]:
        """Migration drain (DESIGN.md §9): pop every resident entry whose key
        satisfies ``pred`` (vectorized numpy predicate) out of the page
        table, gather its page contents (one batched gather per pool, left
        on the device), and return (keys, ts, dirty, blocks) with timestamps
        and dirty bits preserved — the destination re-admits with the same
        eviction priority via ``admit(keys, ts, dirty)`` + ``stage``."""
        exp = tac_torch.export_mask(self.tac,
                                    pred(self.tac.keys.cpu().numpy()))
        blocks = self.gather(exp.slots) if len(exp.keys) else {}
        return exp.keys, exp.ts, exp.dirty, blocks

    # ----------------------------------------------------------- dirty state
    def mark_dirty(self, keys) -> None:
        """Decode mutated these pages in place: flag them for write-back."""
        keys = self._keys(keys)
        if keys.shape[0] == 0:
            return
        tac_torch.set_dirty(self.tac, keys, True)

    def flush_dirty(self) -> Tuple[np.ndarray, Dict[str, torch.Tensor]]:
        """Checkpoint/shutdown: return (keys, page contents on the host) of
        every dirty resident page and clear the dirty bits."""
        keys = self.tac.keys.cpu().numpy()
        mask = self.tac.dirty.cpu().numpy() & (keys >= 0)
        if not mask.any():
            return np.zeros((0,), np.int32), {}
        b, w = np.nonzero(mask)
        slots = (b * self.ways + w).astype(np.int32)
        blocks = {name: blk.cpu() for name, blk in self.gather(slots).items()}
        self.tac.dirty.zero_()
        return keys[mask], blocks

    # --------------------------------------------------------------- metrics
    def stats(self) -> Dict[str, float]:
        tot = self.hits + self.misses
        return {"arena_hits": self.hits, "arena_misses": self.misses,
                "arena_hit_rate": self.hits / tot if tot else 0.0,
                "arena_conflicts": self.conflicts,
                "arena_admits": self.admits,
                "arena_evictions": self.evictions,
                "arena_dirty_evictions": self.dirty_evictions,
                "arena_staged_pages": self.staged_pages}
