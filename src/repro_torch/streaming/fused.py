"""Fused execution mode: device-resident keyed state behind a cache-
compatible control plane (DESIGN.md §14).

The interpreted engine walks one tuple at a time through
``TimestampAwareCache`` — a Python dict + lazy heap.  In fused mode the
stateful operator instead batches runs of consecutive tuples into
fixed-width device batches and executes the whole inner loop — TAC probe
→ ``page_gather`` → operator compute → scatter write-back — as one
``repro_torch.core.tac_torch.fused_step`` call per batch, whose probe,
gather and scatter are the CUDA kernels of ``repro_torch.kernels``.
The Python layer is demoted to control plane: watermarks, barriers,
hints, parking, checkpoint cuts, and eviction POLICY stay host-side.

Two data structures cooperate:

  * the DEVICE plane — ``TACState`` directory + a payload pool
    ``pages [W + 1, 1, V + 1]`` (channel 0 = presence flag, the device
    encoding of the Python side's ``None`` state; last row = zeroed
    scratch slot that miss/padding lanes alias);
  * the HOST SHADOW — per-slot key/ts/gen/dirty/admission metadata in
    numpy.  The shadow owns eviction ORDER (fp64 timestamps + an
    insertion-generation tie-break replicating the reference heap) and
    slot assignment; the device owns membership and payloads.  Both
    change only through the entry points below, so they agree by
    construction.

``FusedPlane`` implements the full ``TimestampAwareCache`` interface
(lookup/insert/write/renew/drop/pop_writeback/flush_dirty/export/import/
eviction_block, the §12 counters, and the prefetch-quality recorder
hooks) so every cold path of the engine — parked resumes, write-back
lanes, checkpoints, recovery — runs unchanged against it; ``batch_step``
is the hot path the fused operator drives.

The plane lives on ``device`` (default ``"cuda"``; the tests pass
``"cpu"``, where the kernels' plain PyTorch versions run).  Nothing falls
back to the CPU: a CUDA plane without a CUDA device raises.  Each
``batch_step`` uploads its lane arrays and brings the per-lane results
back in ONE packed device-to-host copy.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

import torch

from repro_torch.core import tac_torch
from repro_torch.core.tac import Entry


@dataclass
class FusedSpec:
    """Declarative operator compute for the fused data path (§14).

    The interpreted engine accepts arbitrary Python ``apply_fn``s; a
    fused operator must instead DECLARE its state transition so it can
    compile: ``kind`` picks the device compute (``sum`` — count is a sum
    of ones —, ``max``, or ``read`` for read-only enrichment), ``width``
    the state-vector arity V, and the encode/decode pair maps the host
    state object to/from the device row (``None`` state <-> absent row).
    ``weight_of`` extracts the per-tuple update vector; ``emit_of``
    (read/sum kinds) produces per-lane outputs host-side.
    """
    kind: str                                   # sum | max | read
    width: int = 1
    weight_of: Optional[Callable[[Any], Any]] = None
    encode: Optional[Callable[[Any], Any]] = None
    decode: Optional[Callable[[np.ndarray], Any]] = None
    emit_of: Optional[Callable[[Any, Any], list]] = None

    def __post_init__(self):
        if self.kind not in ("sum", "max", "read"):
            raise ValueError(f"fused kind {self.kind!r}")

    def weight(self, tup) -> np.ndarray:
        if self.weight_of is None:
            return _ONES[:self.width]
        w = self.weight_of(tup)
        return np.atleast_1d(np.asarray(w, np.float32))

    def weight_raw(self, tup):
        """Like ``weight`` but stays in Python — a length-V sequence the
        batch staging vectorizes in one ``np.asarray`` over all lanes
        (per-lane array wrapping dominated the assembly cost)."""
        if self.weight_of is None:
            return _ONES_T[:self.width]
        w = self.weight_of(tup)
        if isinstance(w, (int, float)):
            return (w,)
        return w

    def enc(self, state) -> Tuple[np.ndarray, bool]:
        if state is None:
            return _ZEROS[:self.width], False
        if self.encode is None:
            return np.atleast_1d(np.asarray(state, np.float32)), True
        vec = self.encode(state)
        if vec is None:
            return _ZEROS[:self.width], False
        return np.atleast_1d(np.asarray(vec, np.float32)), True

    def dec(self, vec: np.ndarray, present: bool):
        if not present:
            return None
        if self.decode is None:
            return float(vec[0])
        return self.decode(np.asarray(vec))


_ONES = np.ones(16, np.float32)
_ZEROS = np.zeros(16, np.float32)
_ONES_T = (1.0,) * 16


class Lane(NamedTuple):
    """One device lane of a fused batch: a pane/key access derived from
    a queued tuple at batch-assembly time (``StatefulOp._fused_expand``).
    """
    key: Any                  # state-access key (WindowKey for panes)
    ts: float                 # event time of the access
    weight: Any               # length-V update vector (sequence or
    #                           ndarray; zeros for fire/read lanes)
    fire: bool                # window-fire read (no update)
    late_update: bool         # update on a FIRED pane (late_policy=update)
    tup: Any                  # source Tuple_ (parking, traces, emits)


class BatchResult(NamedTuple):
    hit: np.ndarray           # [n] bool — device-resident, update applied
    present: np.ndarray       # [n] bool — value present after the lane
    new_vals: np.ndarray      # [n, V]  — value after the lane (composed)
    fire: np.ndarray          # [n] bool — the staged fire flags (lets
    #                           the caller mask lanes without re-walking)


class FusedPlane:
    """Device-resident keyed-state plane with TAC-compatible semantics.

    Capacity is counted in the same size units as ``TimestampAwareCache``
    (``capacity // entry_size`` uniform slots).  Single-key operations
    (the engine's cold paths) each cost one small device call; the hot
    path is ``batch_step``.
    """

    PAD_KEY = -2              # never matches empty (-1) or interned (>=0)
    DROP_W = 32               # fixed width of the batched directory clear

    def __init__(self, capacity: int, entry_size: int, spec: FusedSpec,
                 deadline_aware: bool = False, batch: int = 64,
                 device: str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FusedPlane on a CUDA device, but CUDA is "
                               "not available (pass device='cpu' to run "
                               "the plain PyTorch versions)")
        self._tj = tac_torch
        self.spec = spec
        self.batch = int(batch)
        self.capacity = capacity
        self.entry_size = max(1, int(entry_size))
        self.deadline_aware = deadline_aware
        W = max(1, capacity // self.entry_size)
        self.n_slots = W
        V = spec.width
        self.tac = tac_torch.init(1, W, 1, device=self.device)
        self.pages = torch.zeros((W + 1, 1, V + 1), dtype=torch.float32,
                                 device=self.device)
        # host shadow directory (fp64 eviction order, §14)
        self._sid = np.full(W, -1, np.int64)        # interned key id
        self._sts = np.full(W, -np.inf, np.float64)
        self._sgen = np.zeros(W, np.int64)
        self._sdirty = np.zeros(W, bool)
        self._spf = np.zeros(W, bool)               # admitted by prefetch
        self._spf_unused = np.zeros(W, bool)        # staged, never read
        self._sstage_t = np.zeros(W, np.float64)
        self._sorigin: List[str] = [""] * W
        self._key_by_slot: List[Any] = [None] * W
        self._slot_by_key: Dict[Any, int] = {}
        self._free: List[int] = list(range(W - 1, -1, -1))
        self._ids: Dict[Any, int] = {}
        self._gen = 0
        self._pending_drops: List[int] = []
        # deferred admissions (§14): misses arrive one completion at a
        # time from the I/O plane, and each device call costs launches
        # and host-device copies.  _place queues the row host-side
        # (slot-keyed, so a re-write before the flush supersedes in
        # place) and _flush_admits lands the whole backlog in chunked
        # fused_admit calls right before the next device op needs it.
        # _pending_state mirrors the encoded rows so reads of a queued
        # slot are served host-side without touching the device.
        self._pending_admits: Dict[int, list] = {}
        self._pending_state: Dict[int, tuple] = {}
        # lazy victim heaps, the same structure the interpreted TAC
        # uses: (ts, gen, slot) min-order and (-ts, gen, slot) for the
        # deadline-aware farthest-first rule.  gen is a unique version
        # per (slot, ts) assignment, so staleness is a gen mismatch.
        # Touches only note the slot; the push happens when a victim is
        # actually needed, so a slot hit N times between evictions costs
        # one push, not N.
        self._heap: List[Tuple[float, int, int]] = []
        self._fheap: List[Tuple[float, int, int]] = []
        self._touched: set = set()
        self.clock = float("-inf")
        self.evict_buffer: Dict[Any, Entry] = {}
        self.used = 0
        self.on_writeback = None
        # §12 counter block (TimestampAwareCache-compatible)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.writebacks = 0
        self.prefetch_insertions = 0
        self.prefetch_unused_evicted = 0
        self.pf_ins_by_origin: Dict[str, int] = {}
        self.pf_unused_by_origin: Dict[str, int] = {}
        self.evict_reasons: Dict[Tuple[str, str], int] = {}
        self.recorder = None
        # fused-plane telemetry (device tallies folded into §12, §14)
        self.batches = 0
        self.lanes = 0
        self.device_hits = 0
        self.device_misses = 0
        self.device_conflicts = 0

    # ------------------------------------------------------------ internals
    def _intern(self, key) -> int:
        kid = self._ids.get(key)
        if kid is None:
            kid = len(self._ids)
            self._ids[key] = kid
        return kid

    def _next_gen(self) -> int:
        self._gen += 1
        return self._gen

    def _flush_drops(self) -> None:
        if not self._pending_drops:
            return
        drops = self._pending_drops
        self._pending_drops = []
        for i in range(0, len(drops), self.DROP_W):
            chunk = drops[i:i + self.DROP_W]
            slots = np.zeros(self.DROP_W, np.int32)
            valid = np.zeros(self.DROP_W, bool)
            slots[:len(chunk)] = chunk
            valid[:len(chunk)] = True
            self.tac = self._tj.drop_slots(self.tac, self._put(slots),
                                           self._put(valid))

    def _flush_admits(self) -> None:
        """Land the queued admissions.  Chunks pad to a few fixed widths
        (the reference's stable jit shapes) by REPEATING the first
        record — an idempotent duplicate write under the scatter's
        last-write-wins order.  Must run after ``_flush_drops``: a queued drop and a
        queued admit can target the same slot, and the admit wins."""
        if not self._pending_admits:
            return
        recs = list(self._pending_admits.items())
        self._pending_admits.clear()
        self._pending_state.clear()
        i = 0
        while i < len(recs):
            chunk = recs[i:i + 64]
            i += 64
            n = len(chunk)
            W = next(w for w in (1, 8, 16, 32, 64) if n <= w)
            if n < W:
                chunk = chunk + [chunk[0]] * (W - n)
            slots = np.asarray([c[0] for c in chunk], np.int32)
            rs = [c[1] for c in chunk]
            kids = np.asarray([r[0] for r in rs], np.int32)
            ts = np.asarray([r[1] for r in rs], np.float32)
            rows = np.asarray([r[2] for r in rs], np.float32)
            pres = np.asarray([r[3] for r in rs], bool)
            dirty = np.asarray([r[4] for r in rs], bool)
            self.tac, self.pages, _ = self._tj.fused_admit(
                self.tac, self.pages, self._put(slots), self._put(kids),
                self._put(ts), self._put(rows), self._put(pres),
                self._put(dirty))

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _row(self, slot: int) -> np.ndarray:
        """One pool row ``[V + 1]`` on the host (one gather, one copy)."""
        return self._tj.gather_rows(
            self.pages, self._put(np.array([slot], np.int32)))[0, 0] \
            .cpu().numpy()

    def _sync(self) -> None:
        self._flush_drops()
        self._flush_admits()

    def _touch(self, slot: int) -> None:
        self._touched.add(slot)

    def _flush_touches(self) -> None:
        """Push each touched slot's CURRENT (ts, gen) into the victim
        heaps; earlier entries lazily invalidate on gen mismatch."""
        for slot in self._touched:
            if self._sid[slot] < 0:
                continue
            t, g = float(self._sts[slot]), int(self._sgen[slot])
            heapq.heappush(self._heap, (t, g, slot))
            if self.deadline_aware:
                heapq.heappush(self._fheap, (-t, g, slot))
        self._touched.clear()

    def _live(self, g: int, slot: int) -> bool:
        return self._sgen[slot] == g and self._sid[slot] >= 0

    def _choose_victim(self) -> Tuple[int, str]:
        """Replicates ``TimestampAwareCache._evict_one``'s ORDER on the
        shadow: default = min (ts, gen); deadline_aware = stale entries
        (ts behind the watermark clock) oldest-first, else the FARTHEST
        deadline first (Belady on known fire times), gen tie-break.
        Same lazy-heap scheme as the interpreted cache: the min-heap top
        is the global (ts, gen) minimum, so if it is not stale nothing
        is."""
        self._flush_touches()
        if self.deadline_aware:
            while self._heap:
                ts, g, s = self._heap[0]
                if not self._live(g, s):
                    heapq.heappop(self._heap)
                    continue
                if ts < self.clock:
                    heapq.heappop(self._heap)
                    return s, "stale"
                break
            while True:
                _, g, s = heapq.heappop(self._fheap)
                if self._live(g, s):
                    return s, "deadline"
        while True:
            _, g, s = heapq.heappop(self._heap)
            if self._live(g, s):
                return s, "capacity"

    def _account_eviction(self, slot: int, reason: str) -> None:
        """Runs BEFORE the new occupant is queued at ``slot``.  A dirty
        victim's value comes from its own queued admission if it never
        reached the device, else from a single-row pool gather — clean
        victims (the common prefetch-churn case) touch nothing."""
        key = self._key_by_slot[slot]
        self.evictions += 1
        adm = "prefetched" if self._spf[slot] else "demand"
        self.evict_reasons[(reason, adm)] = \
            self.evict_reasons.get((reason, adm), 0) + 1
        if self._spf_unused[slot]:
            self.prefetch_unused_evicted += 1
            org = self._sorigin[slot]
            self.pf_unused_by_origin[org] = \
                self.pf_unused_by_origin.get(org, 0) + 1
            if self.recorder is not None:
                self.recorder.on_wasted()
        if self._sdirty[slot]:
            pend = self._pending_state.get(slot)
            if pend is not None:
                state = self.spec.dec(pend[0], pend[1])
            else:
                row = self._row(slot)
                state = self.spec.dec(row[1:], row[0] > 0.5)
            e = Entry(key, state, float(self._sts[slot]), True,
                      self.entry_size)
            e.prefetched = bool(self._spf[slot])
            e.prefetched_unused = False
            e.origin = self._sorigin[slot]
            self.evict_buffer[key] = e
        # a queued admission evicted before it ever landed is cancelled;
        # the new occupant's queued row overwrites the slot at flush
        self._pending_admits.pop(slot, None)
        self._pending_state.pop(slot, None)
        del self._slot_by_key[key]
        self._key_by_slot[slot] = None
        self.used -= self.entry_size

    def _place(self, key, state, ts: float, dirty: bool,
               prefetched: bool, origin: str,
               pf_unused: bool) -> None:
        """Shared admit: resolve a slot (overwrite > free > evict) and
        QUEUE the row for the next ``_flush_admits`` (directory set +
        pool scatter land in one chunked program per device op)."""
        slot = self._slot_by_key.get(key)
        evict_reason = None
        if slot is None:
            if self._free:
                slot = self._free.pop()
            else:
                slot, evict_reason = self._choose_victim()
            self.used += self.entry_size
        if evict_reason is not None:
            self._account_eviction(slot, evict_reason)
        vec, present = self.spec.enc(state)
        self._pending_admits[slot] = [self._intern(key), float(ts), vec,
                                      present, dirty]
        self._pending_state[slot] = (vec, present)
        self._sid[slot] = self._ids[key]
        self._sts[slot] = ts
        self._sgen[slot] = self._next_gen()
        self._sdirty[slot] = dirty
        self._spf[slot] = prefetched
        self._spf_unused[slot] = pf_unused
        self._sorigin[slot] = origin
        self._key_by_slot[slot] = key
        self._slot_by_key[key] = slot
        self._touch(slot)
        if prefetched and self.recorder is not None:
            self._sstage_t[slot] = self.recorder.now()

    def _read_slot(self, slot: int):
        pend = self._pending_state.get(slot)
        if pend is not None:
            return self.spec.dec(pend[0], pend[1])
        row = self._row(slot)
        return self.spec.dec(row[1:], row[0] > 0.5)

    def _restore(self, staged: Entry, ts: float) -> None:
        """Eviction-buffer restore (the paper's staged-entry move-back):
        re-admit preserving admission metadata, NO insert counters."""
        self._place(staged.key, staged.state, max(staged.ts, ts),
                    staged.dirty, getattr(staged, "prefetched", False),
                    getattr(staged, "origin", ""), pf_unused=False)

    # ----------------------------------------------------------- cache API
    def lookup(self, key, now_ts: float):
        slot = self._slot_by_key.get(key)
        if slot is None:
            staged = self.evict_buffer.pop(key, None)
            if staged is not None:
                self._restore(staged, now_ts)
                self.hits += 1
                return staged.state
            self.misses += 1
            return None
        self.hits += 1
        if now_ts > self._sts[slot]:
            self._sts[slot] = now_ts
            self._sgen[slot] = self._next_gen()
            self._touch(slot)
        if self._spf_unused[slot] and self.recorder is not None:
            self.recorder.on_used(float(self._sstage_t[slot]))
        self._spf_unused[slot] = False
        return self._read_slot(slot)

    def contains(self, key) -> bool:
        return key in self._slot_by_key or key in self.evict_buffer

    def insert(self, key, state, ts: float, dirty: bool = False,
               size: int = 1, prefetched: bool = False,
               origin: str = "") -> None:
        self.evict_buffer.pop(key, None)
        self._place(key, state, ts, dirty, prefetched, origin,
                    pf_unused=prefetched)
        if prefetched:
            self.prefetch_insertions += 1
            self.pf_ins_by_origin[origin] = \
                self.pf_ins_by_origin.get(origin, 0) + 1
            if self.recorder is not None:
                self.recorder.on_staged()

    def write(self, key, state, now_ts: float, size: int = 1) -> None:
        slot = self._slot_by_key.get(key)
        if slot is None:
            self.insert(key, state, now_ts, dirty=True, size=size)
            return
        ts = max(float(self._sts[slot]), now_ts)
        self._place(key, state, ts, True,
                    self._spf[slot], self._sorigin[slot], pf_unused=False)

    def renew(self, key, hint_ts: float) -> bool:
        slot = self._slot_by_key.get(key)
        if slot is None:
            staged = self.evict_buffer.pop(key, None)
            if staged is None:
                return False
            self._restore(staged, hint_ts)
            return True
        if hint_ts > self._sts[slot]:
            self._sts[slot] = hint_ts
            self._sgen[slot] = self._next_gen()
            self._touch(slot)
        return True

    def drop(self, key) -> bool:
        slot = self._slot_by_key.pop(key, None)
        if slot is not None:
            self._pending_admits.pop(slot, None)
            self._pending_state.pop(slot, None)
            self._sid[slot] = -1
            self._sts[slot] = -np.inf
            self._sdirty[slot] = False
            self._spf[slot] = self._spf_unused[slot] = False
            self._key_by_slot[slot] = None
            self._free.append(slot)
            self._pending_drops.append(slot)
            self.used -= self.entry_size
            return True
        return self.evict_buffer.pop(key, None) is not None

    def set_clock(self, watermark: float) -> None:
        if watermark > self.clock:
            self.clock = watermark

    def pop_writeback(self) -> Optional[Entry]:
        if not self.evict_buffer:
            return None
        key = next(iter(self.evict_buffer))
        e = self.evict_buffer.pop(key)
        self.writebacks += 1
        return e

    # ------------------------------------------------------- bulk/cold ops
    def _pool_host(self) -> np.ndarray:
        self._flush_admits()
        return self.pages.cpu().numpy()

    def _entry_at(self, slot: int, pool: np.ndarray) -> Entry:
        row = pool[slot, 0]
        e = Entry(self._key_by_slot[slot],
                  self.spec.dec(row[1:], row[0] > 0.5),
                  float(self._sts[slot]), bool(self._sdirty[slot]),
                  self.entry_size)
        e.prefetched = bool(self._spf[slot])
        e.prefetched_unused = bool(self._spf_unused[slot])
        e.origin = self._sorigin[slot]
        return e

    @property
    def entries(self) -> Dict[Any, Entry]:
        """Decoded resident view (checkpoint manifest; cold path)."""
        pool = self._pool_host()
        return {k: self._entry_at(s, pool)
                for k, s in self._slot_by_key.items()}

    def flush_dirty(self) -> List[Entry]:
        pool = self._pool_host()
        out = [self._entry_at(s, pool)
               for s in sorted(self._slot_by_key.values())
               if self._sdirty[s]]
        self._sdirty[:] = False
        out += list(self.evict_buffer.values())
        for e in out:
            e.dirty = False
        self.evict_buffer.clear()
        self.tac = self.tac._replace(
            dirty=torch.zeros_like(self.tac.dirty))
        return out

    def export_entries(self, pred) -> List[Entry]:
        pool = self._pool_host()
        out = []
        for key in [k for k in self._slot_by_key if pred(k)]:
            out.append(self._entry_at(self._slot_by_key[key], pool))
            self.drop(key)
        for key in [k for k in self.evict_buffer if pred(k)]:
            out.append(self.evict_buffer.pop(key))
        return out

    def import_entries(self, entries: List[Entry],
                       now_ts: float = 0.0) -> int:
        for e in entries:
            self.insert(e.key, e.state, getattr(e, "ts", now_ts),
                        dirty=e.dirty, size=e.size)
        return len(entries)

    def eviction_block(self) -> Dict[str, int]:
        return {f"{r}.{a}": n
                for (r, a), n in sorted(self.evict_reasons.items())}

    def __len__(self) -> int:
        return len(self._slot_by_key)

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    @property
    def fill_ratio(self) -> float:
        """Mean device-batch occupancy: lanes / (batches * width) —
        underfilled batches mean the launch overhead is amortized over
        too few tuples (surfaced by tools/obs_report.py, §14)."""
        return self.lanes / (self.batches * self.batch) \
            if self.batches else 0.0

    # -------------------------------------------------------- fused hot path
    def batch_step(self, lanes: List[Lane]) -> BatchResult:
        """Run one fused device batch over ``lanes`` (≤ ``self.batch``).

        Device-HIT lanes have their update fully applied on device (one
        ``fused_step``); the caller finishes them host-side (emits,
        fires) from the returned per-lane values.  Device-MISS lanes are
        untouched — the caller adjudicates them through ``lookup`` in
        lane order (eviction-buffer restores, keys admitted earlier in
        the same drain, true misses to park), which keeps the §12
        hit/miss counters exactly sequential-equivalent.  Device tallies
        fold into ``device_hits``/``device_misses``.
        """
        self._sync()
        n = len(lanes)
        B = self.batch
        if n > B:
            raise ValueError(f"batch of {n} lanes exceeds width {B}")
        V = self.spec.width
        # bulk staging: one fromiter/asarray per field beats per-lane
        # numpy scalar writes by ~50x at B=64
        keys = np.full(B, self.PAD_KEY, np.int32)
        keys[:n] = np.fromiter((self._intern(ln.key) for ln in lanes),
                               np.int64, n)
        ts64 = np.fromiter((ln.ts for ln in lanes), np.float64, n)
        ts32 = np.zeros(B, np.float32)
        ts32[:n] = ts64
        weights = np.zeros((B, V), np.float32)
        weights[:n] = np.asarray([ln.weight for ln in lanes],
                                 np.float32).reshape(n, V)
        fire = np.zeros(B, bool)
        fire[:n] = np.fromiter((ln.fire for ln in lanes), bool, n)
        valid = np.zeros(B, bool)
        valid[:n] = True
        out = self._tj.fused_step(
            self.tac, self.pages, self._put(keys), self._put(ts32),
            self._put(weights), self._put(fire), self._put(valid),
            kind=self.spec.kind)
        self.tac, self.pages = out.state, out.pages
        # ONE device-to-host copy for every per-lane output: int32 words
        # [hit | slots | present | tallies | new_vals bits]
        host = torch.cat([
            out.hit.int(), out.slots, out.present.int(), out.tallies,
            out.new_vals.float().contiguous().view(torch.int32).view(-1),
        ]).cpu().numpy()
        hit = host[:n] != 0
        slots = host[B:B + n]
        present = host[2 * B:2 * B + n] != 0
        tallies = host[3 * B:3 * B + 2]
        new_vals = host[3 * B + 2:].view(np.float32).reshape(B, V)[:n]
        self.batches += 1
        self.lanes += n
        misses = int(tallies[1])
        self.device_hits += int(tallies[0])
        self.device_misses += misses
        # conflict tally (§12): misses in excess of the slots free (or
        # already queued to free) when the batch was adjudicated — each
        # one forces an eviction to admit, the streaming analogue of the
        # serving plane's full-bucket probe conflicts
        free_now = len(self._free) + len(self._pending_drops)
        if misses > free_now:
            self.device_conflicts += misses - free_now
        self.hits += int(tallies[0])
        # shadow advance for hit lanes, vectorized (fp64 order + dirty)
        if hit.any():
            hs = slots[hit]
            hts = ts64[hit]
            cur = self._sts[hs]
            np.maximum.at(self._sts, hs, hts)
            # slots whose ts actually advanced get a fresh generation
            # (unique-slot order, as the sequential loop this replaces)
            adv = np.unique(hs[hts > cur])
            if len(adv):
                self._sgen[adv] = np.arange(
                    self._gen + 1, self._gen + 1 + len(adv))
                self._gen += len(adv)
                self._touched.update(adv.tolist())
            if self.spec.kind != "read":
                upd = hit & ~fire[:n]
                self._sdirty[slots[upd]] = True
            # first read of staged entries: signed lead time (§12)
            first = hs[self._spf_unused[hs]]
            if len(first) and self.recorder is not None:
                for s in np.unique(first):
                    self.recorder.on_used(float(self._sstage_t[s]))
            self._spf_unused[hs] = False
        return BatchResult(hit, present, new_vals, fire[:n])

    def decode_lane(self, res: BatchResult, i: int):
        return self.spec.dec(res.new_vals[i], bool(res.present[i]))
