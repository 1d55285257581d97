"""Device-side Timestamp-Aware Cache on PyTorch tensors: every call of
``repro/core/tac_jax.py``.

State rows live in (n_buckets x ways) slots; eviction picks the
min-timestamp way within the key's bucket.  Lookups go through the probe
kernel.  ``admit`` has the reference's sequential semantics (duplicate
keys in one batch see each other's effects); ``admit_batch`` resolves a
batch in conflict rounds with the same result and reports each key's
slot and the key and dirty bit it displaced.  Around them sit the
sharded plane's ownership calls (``shard_of``, ``shard_mask``,
``probe_owned``, ``admit_owned``, DESIGN.md §9), the watermark reclaim
(``evict_expired``, §10, §11), migration (``export_mask``,
``import_entries``) and the barrier's dirty export (``flush_dirty``,
§7).  The fused plane uses one bucket of ``ways = capacity`` slots.  The
payload pool is ``pages [n_slots + 1, 1, V + 1]``: channel 0 is a
presence flag (0 = the pane was never written; decodes to the Python
side's ``None``), channels 1..V the value vector, and the LAST row a
zeroed scratch slot that miss/read/padding lanes alias so their scatters
are inert.  The host shadow directory (``streaming/fused.py``) owns
eviction ORDER and slot assignment; the device directory
(``TACState.keys``) is authoritative for MEMBERSHIP and the pool for
payloads.

Unlike the reference, whose arrays are immutable, these functions update
``state`` and ``pages`` IN PLACE and return them: a batch touches a few
hundred rows of a pool that can hold hundreds of thousands.  Callers that
need the old state clone it first; the host arrays that the bulk exports
return are copies taken before the state changes.  The state's device
decides where the work runs: probe, gather and scatter go through the
kernels of ``repro_torch.kernels`` (CUDA on a CUDA tensor, the plain
PyTorch versions on a CPU tensor): the fused plane's batch step and
admission are one kernel each (``kernels/tac_fused``); the other calls
use the probe and page kernels around plain tensor code.  Where a
probe's miss lanes alias way 0 of their bucket, the updates are
``scatter_reduce_`` with a neutral value for those lanes, never a plain
``scatter_``, whose order on duplicate indices is unspecified.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels.page_gather.page_gather import page_gather_kernel
from repro_torch.kernels.tac_fused import tac_fused
from repro_torch.kernels.tac_probe.ops import bucket_of, tac_probe


class TACState(NamedTuple):
    keys: torch.Tensor     # [n_buckets, ways] int32, -1 = empty
    ts: torch.Tensor       # [n_buckets, ways] fp32
    vals: torch.Tensor     # [n_buckets, ways, D]
    dirty: torch.Tensor    # [n_buckets, ways] bool


def init(n_buckets: int, ways: int, d: int, dtype=torch.float32,
         device="cuda") -> TACState:
    return TACState(
        keys=torch.full((n_buckets, ways), -1, dtype=torch.int32,
                        device=device),
        ts=torch.full((n_buckets, ways), -float("inf"), dtype=torch.float32,
                      device=device),
        vals=torch.zeros((n_buckets, ways, d), dtype=dtype, device=device),
        dirty=torch.zeros((n_buckets, ways), dtype=torch.bool,
                          device=device))


def _put(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def state_from_numpy(keys, ts, vals, dirty, device) -> TACState:
    """The reference's ``TACState`` fields, as numpy arrays, turned into
    this module's tensors on ``device``."""
    return TACState(_put(keys, np.int32, device), _put(ts, np.float32, device),
                    _put(vals, np.asarray(vals).dtype, device),
                    _put(dirty, bool, device))


def from_numpy(keys, ts, vals, dirty, pages,
               device) -> Tuple[TACState, torch.Tensor]:
    """``state_from_numpy`` plus the fused plane's pool."""
    return (state_from_numpy(keys, ts, vals, dirty, device),
            _put(pages, np.float32, device))


def to_numpy(state: TACState, pages: torch.Tensor):
    """Inverse of ``from_numpy``: (keys, ts, vals, dirty, pages) arrays."""
    return tuple(t.cpu().numpy() for t in (*state, pages))


def _flat(t: torch.Tensor) -> torch.Tensor:
    """1-D view sharing storage (bool viewed as uint8 for reductions)."""
    t = t.view(-1)
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _on(state: TACState, a, dtype=None) -> torch.Tensor:
    """``a`` (numpy, list or tensor) as a tensor on the state's device."""
    return torch.as_tensor(a, dtype=dtype, device=state.keys.device)


def _host(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _probe(state: TACState, keys: torch.Tensor):
    """(vals, hit [B] bool, flat directory index [B] int64).  A miss lane's
    index is way 0 of its bucket, so updates through it must be inert."""
    vals, hit, way = tac_probe(keys, state.keys, state.vals)
    b = bucket_of(keys, state.keys.shape[0]).long()
    return vals, hit.bool(), b * state.keys.shape[1] + way.clamp(min=0).long()


def refresh_ts(state: TACState, at, hit, ts) -> None:
    """IN PLACE: the timestamps at flat directory index ``at`` of the
    ``hit`` lanes become max(ts, current); -inf for the miss lanes makes
    their aliased updates no-ops."""
    ts = _on(state, ts, torch.float32).expand(hit.shape)
    _flat(state.ts).scatter_reduce_(0, at, torch.where(hit, ts, -float("inf")),
                                    "amax")


def renew(state: TACState, keys, hint_ts) -> TACState:
    """Bump predicted relevance of cached keys (hint for a cached entry),
    IN PLACE."""
    _, hit, at = _probe(state, _on(state, keys).int())
    refresh_ts(state, at, hit, hint_ts)
    return state


def lookup(state: TACState, qkeys, now_ts
           ) -> Tuple[torch.Tensor, torch.Tensor, TACState]:
    """Batched probe+gather; refreshes the timestamps of hits (max with
    ``now_ts``) IN PLACE.  Returns ``(vals [B, D], hit [B] bool, state)``."""
    vals, hit, at = _probe(state, _on(state, qkeys).int())
    refresh_ts(state, at, hit, now_ts)
    return vals, hit, state


class AdmitResult(NamedTuple):
    state: TACState
    slots: torch.Tensor          # [B] int32 flat slot (bucket * ways + way)
    evicted_keys: torch.Tensor   # [B] int32 displaced key, -1 = none/overwrite
    evicted_dirty: torch.Tensor  # [B] bool  dirty bit of the displaced key


def _rank_in_group(b: torch.Tensor) -> torch.Tensor:
    """Occurrence rank of each lane among the earlier lanes with the same
    value, in batch order.  A stable sort gives it in O(B log B); the
    reference's ``[B, B]`` lower-triangular count is quadratic."""
    n = b.shape[0]
    sb, order = torch.sort(b, stable=True)
    pos = torch.arange(n, device=b.device)
    start = torch.ones(n, dtype=torch.bool, device=b.device)
    start[1:] = sb[1:] != sb[:-1]
    first = torch.where(start, pos, 0).cummax(dim=0).values
    return torch.empty_like(pos).scatter_(0, order, pos - first)


def admit_batch(state: TACState, keys, ts, vals=None,
                dirty=None) -> AdmitResult:
    """Vectorized multi-key admit, IN PLACE.

    Keys hashing to DISTINCT buckets are admitted in one update; keys
    colliding in a bucket are resolved in batch order over conflict rounds
    (as many as the largest same-bucket multiplicity).  Semantics are
    exactly the reference's sequential ``admit``: overwrite a matching key, else evict the
    bucket's min-ts way (the first on ties; empty ways hold -inf).

    Returns the state plus, per admitted key, the flat slot it landed in and
    the key/dirty bit it displaced (-1/False when the way was empty or held
    the same key)."""
    keys = _on(state, keys).int()
    B = keys.shape[0]
    n_buckets, ways = state.keys.shape
    D = state.vals.shape[-1]
    ts = _on(state, ts, torch.float32)
    vals = torch.zeros((B, D), dtype=state.vals.dtype,
                       device=keys.device) if vals is None \
        else _on(state, vals).to(state.vals.dtype)
    dirty = torch.zeros_like(keys, dtype=torch.bool) if dirty is None \
        else _on(state, dirty).bool()
    if B == 0:
        return AdmitResult(state, keys, keys.clone(), dirty)
    b = bucket_of(keys, n_buckets).long()
    rank = _rank_in_group(b)
    slots = torch.zeros(B, dtype=torch.long, device=keys.device)
    ev_k = torch.full((B,), -1, dtype=torch.int32, device=keys.device)
    ev_d = torch.zeros(B, dtype=torch.bool, device=keys.device)
    fk, ft, fd = _flat(state.keys), _flat(state.ts), _flat(state.dirty)
    fv = state.vals.view(-1, D)
    for r in range(int(rank.max()) + 1):
        lane = (rank == r).nonzero(as_tuple=True)[0]
        lb = b[lane]
        match = state.keys[lb] == keys[lane, None]           # [n, ways]
        hit = match.any(dim=1)
        way = torch.where(hit, match.int().argmax(dim=1),
                          state.ts[lb].argmin(dim=1))
        at = lb * ways + way
        old_key = fk[at]
        old_dirty = fd[at].bool()
        # the lanes of one round have distinct buckets, so these index
        # writes never meet a duplicate index
        fk[at] = keys[lane]
        ft[at] = ts[lane]
        fv[at] = vals[lane]
        fd[at] = dirty[lane].to(torch.uint8)
        slots[lane] = at
        displaced = ~hit & (old_key >= 0)
        ev_k[lane] = torch.where(displaced, old_key, -1)
        ev_d[lane] = displaced & old_dirty
    return AdmitResult(state, slots.int(), ev_k, ev_d)


def admit(state: TACState, keys, ts, vals=None, dirty=None) -> TACState:
    """Insert a batch (prefetched or freshly computed state), IN PLACE,
    with the reference's sequential semantics: each insert overwrites a
    matching key (its timestamp replaced) if present, else evicts the
    bucket's first min-ts way, and duplicate buckets compose in batch
    order.  ``admit_batch``'s conflict rounds give exactly that state."""
    return admit_batch(state, keys, ts, vals, dirty).state


def set_dirty(state: TACState, keys, value: bool = True) -> TACState:
    """Flip the dirty bit of resident keys (no-op for missing keys), IN
    PLACE.  Miss lanes alias way 0 of their bucket, so the update is an
    amax/amin scatter with a neutral value for them."""
    _, hit, at = _probe(state, _on(state, keys).int())
    if value:
        _flat(state.dirty).scatter_reduce_(0, at, hit.to(torch.uint8), "amax")
    else:
        _flat(state.dirty).scatter_reduce_(0, at, (~hit).to(torch.uint8),
                                           "amin")
    return state


# ----------------------------------------------------------- sharded plane
# Key ownership in the sharded state plane (DESIGN.md §9): int32 keys are
# assigned to shards by a floor modulo, which agrees with the engine-side
# ``hash_partition`` for ints (CPython hash(i) == i for small ints), so a
# hint routed host-side and a page admitted device-side land at the same
# owner.

def shard_of(keys, n_shards: int) -> torch.Tensor:
    """Owning shard per key, int32 (device-side twin of ``hash_partition``).
    ``torch.remainder`` is a floor modulo, as the reference's ``jnp.mod``:
    a negative key maps into [0, n_shards) too.  A tensor stays on its
    device; other array-likes become CPU tensors."""
    return torch.remainder(torch.as_tensor(keys).int(), n_shards)


def shard_mask(keys, shard_id: int, n_shards: int) -> torch.Tensor:
    """True where ``shard_id`` owns the key."""
    return shard_of(keys, n_shards) == shard_id


def probe_owned(state: TACState, keys, shard_id: int, n_shards: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shard-local probe: foreign keys (misrouted in the shard plane) are
    forced to miss so a stray probe can never refresh another shard's
    entries.  Returns (vals, hit, owned) — callers count ``~owned`` lanes
    as misroutes, not misses."""
    keys = _on(state, keys).int()
    owned = shard_mask(keys, shard_id, n_shards)
    vals, hit, _ = _probe(state, keys)
    return vals, hit & owned, owned


def admit_owned(state: TACState, keys, ts, shard_id: int, n_shards: int,
                vals=None, dirty=None) -> Tuple[AdmitResult, int]:
    """Shard-local admit, IN PLACE: drops keys the shard does not own
    before the batched admit (a misrouted admit would orphan a page — no
    hint or probe would ever find it on this shard again).  The filter
    runs on the host, as the reference's does (the owned subset's size
    depends on the data).  Returns (AdmitResult over the owned subset,
    n_dropped); with every key dropped the result holds zero-length
    tensors on the state's device."""
    keys = _on(state, keys).int()
    owned = shard_mask(keys, shard_id, n_shards).cpu().numpy()
    at = _on(state, np.nonzero(owned)[0])
    sub = lambda a: None if a is None else _on(state, a)[at]  # noqa: E731
    return admit_batch(state, keys[at], sub(ts), sub(vals),
                       sub(dirty)), int((~owned).sum())


def evict_expired(state: TACState, watermark: float, retention: Any = 0.0
                  ) -> Tuple[TACState, torch.Tensor]:
    """Watermark-driven bulk reclaim (DESIGN.md §10, §11), IN PLACE:
    invalidate every occupied slot whose EXPIRY time lies strictly behind
    ``watermark``.

    The expiry time is ``ts + retention`` in fp32: ``retention == 0`` (the
    default) makes the slot timestamp the deadline (window panes admitted
    with their fire deadline, §10); ``retention > 0`` expires slots at
    their interval end instead (interval-join entries, §11).
    ``retention`` may be a scalar or a ``[n_buckets, ways]`` array of
    per-slot bounds.  The watermark is rounded to fp32, as the reference
    rounds a Python scalar against an fp32 array.  Keys, timestamps (to
    -inf) and dirty bits are cleared; values stay.  Expired state is
    purged, not written back, so callers that still need the data flush
    BEFORE the watermark passes.  Returns (state, number of slots
    reclaimed as an int32 0-dim tensor on the state's device, so that the
    call does not wait for the device)."""
    expiry = state.ts + _on(state, retention, torch.float32)
    expired = (state.keys >= 0) & (expiry < _on(state, watermark,
                                                torch.float32))
    state.keys.masked_fill_(expired, -1)
    state.ts.masked_fill_(expired, -float("inf"))
    state.dirty.masked_fill_(expired, False)
    return state, expired.sum(dtype=torch.int32)


# --------------------------------------------------------------- migration
class Exported(NamedTuple):
    state: TACState           # source state with the entries cleared
    keys: np.ndarray          # [M] exported keys
    ts: np.ndarray            # [M] their timestamps (preserved end-to-end)
    vals: np.ndarray          # [M, D] their value rows
    dirty: np.ndarray         # [M] their dirty bits
    slots: np.ndarray         # [M] flat source slots (page-payload gather)


def export_mask(state: TACState, mask: np.ndarray) -> Exported:
    """Migration drain, IN PLACE: pop every resident entry selected by
    ``mask`` (a host boolean over keys) out of the cache, preserving
    timestamps and dirty bits so the destination re-admits them with the
    SAME eviction priority.  Host-side: migrations are rare and bulk."""
    keys = _host(state.keys)
    sel = (keys >= 0) & np.asarray(mask)
    b, w = np.nonzero(sel)
    slots = (b * state.keys.shape[1] + w).astype(np.int32)
    # boolean indexing copies, so the entries are taken before the clears
    out = Exported(state, keys[sel].astype(np.int32),
                   _host(state.ts)[sel].astype(np.float32),
                   _host(state.vals)[sel], _host(state.dirty)[sel], slots)
    at = _on(state, slots.astype(np.int64))
    _flat(state.keys)[at] = -1
    _flat(state.ts)[at] = -float("inf")
    _flat(state.dirty)[at] = 0
    return out


def import_entries(state: TACState, keys, ts, vals=None,
                   dirty=None) -> AdmitResult:
    """Migration re-admit at the destination shard, IN PLACE: a batched
    admit that keeps the exported timestamps (NOT the migration time — a
    prefetched page whose hint ts lies in the future must stay protected
    after the move, DESIGN.md §9)."""
    return admit_batch(state, keys, ts, vals, dirty)


def flush_dirty(state: TACState) -> Tuple[TACState, Exported]:
    """Barrier-time dirty export (DESIGN.md §7): the device twin of
    ``TimestampAwareCache.flush_dirty``.  Returns every DIRTY resident
    row (keys, timestamps, values, flat slots — the write-back batch the
    checkpoint persists) and the state with those dirty bits CLEARED IN
    PLACE; unlike the migration drain (``export_mask``) the entries stay
    resident.  The exported arrays are host copies taken before the
    clear, so a later change to the state leaves them as they were."""
    sel = _flat(state.dirty).bool() & (_flat(state.keys) >= 0)
    at = sel.nonzero().squeeze(1)
    D = state.vals.shape[-1]
    exp = Exported(state, _host(_flat(state.keys)[at]),
                   _host(_flat(state.ts)[at]),
                   _host(state.vals.view(-1, D)[at]),
                   np.ones((at.numel(),), bool), _host(at.int()))
    _flat(state.dirty)[at] = 0
    return state, exp


class FusedStep(NamedTuple):
    state: TACState
    pages: torch.Tensor
    hit: torch.Tensor       # [B] bool   (padding lanes forced False)
    slots: torch.Tensor     # [B] int32  flat slot; scratch for miss/padding
    new_vals: torch.Tensor  # [B, V]     value AFTER this lane's update,
    #                         prefix-composed over earlier same-key lanes
    present: torch.Tensor   # [B] bool   presence flag after this lane
    tallies: torch.Tensor   # [2] int32  (hits, misses) over valid lanes


def fused_step(state: TACState, pages: torch.Tensor, keys: torch.Tensor,
               ts: torch.Tensor, weights: torch.Tensor, fire: torch.Tensor,
               valid: torch.Tensor, *, kind: str = "sum") -> FusedStep:
    """One fused batch over the resident working set.

    ``kind`` picks the operator compute: ``sum`` (count is sum of ones),
    ``max``, or ``read`` (no state update, read-only enrichment).
    ``weights`` is ``[B, V]``; ``fire`` lanes read the pane without
    updating it.

    Duplicate keys in one batch compose EXACTLY as the interpreted
    sequential loop: lane i's ``new_vals`` folds in every earlier
    same-key update lane (lower-triangular mask), and only a key's last
    update lane writes the final composed value to the pool.
    Miss lanes are NOT admitted here — admissions arrive later through
    ``fused_admit`` — so a miss lane's only trace is its tally.  On CUDA
    tensors the whole batch is one launch of ``tac_fused_step``, which
    takes a directory of one bucket (every ``FusedPlane``'s) and raises
    for any other.
    """
    hit, slots, new_v, present, tallies = tac_fused.fused_step(
        state, pages, keys, ts, weights, fire, valid, kind)
    return FusedStep(state, pages, hit, slots, new_v, present, tallies)


def fused_admit(state: TACState, pages: torch.Tensor, slots: torch.Tensor,
                keys: torch.Tensor, ts: torch.Tensor, rows: torch.Tensor,
                present: torch.Tensor, dirty: torch.Tensor):
    """Admit at HOST-CHOSEN slots (the shadow directory resolved victims
    and free slots; a slot may repeat only as an IDENTICAL padding
    duplicate of an earlier lane — chunked flushes pad to fixed widths
    that way).  Gathers the pre-overwrite victim rows first — a dirty
    victim's value feeds the eviction buffer for asynchronous write-back
    — then scatters the new rows and updates the device directory, in one
    launch of ``tac_fused_admit`` on CUDA tensors.
    Returns ``(state, pages, victim_rows [B, 1, V+1])``."""
    victim_rows = tac_fused.fused_admit(state, pages, slots, keys, ts, rows,
                                        present, dirty)
    return state, pages, victim_rows


def drop_slots(state: TACState, slots: torch.Tensor,
               valid: torch.Tensor) -> TACState:
    """Clear directory entries at host-chosen slots (window-pane purges,
    drops).  Padding lanes (``valid`` False) alias slot 0, so the clears
    use masked min-scatters that are idempotent no-ops for them.  Pool
    rows are left stale: a cleared slot can no longer be probed, and the
    next ``fused_admit`` overwrites the row."""
    at = slots.long()
    imax = torch.iinfo(torch.int32).max
    _flat(state.keys).scatter_reduce_(
        0, at, torch.where(valid, -1, imax).int(), "amin")
    _flat(state.ts).scatter_reduce_(
        0, at, torch.where(valid, -float("inf"), float("inf")), "amin")
    _flat(state.dirty).scatter_reduce_(
        0, at, torch.where(valid, 0, 1).to(torch.uint8), "amin")
    return state


def gather_rows(pages: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Pull payload rows at flat slots (single-key adapter reads)."""
    return page_gather_kernel(slots, pages)
