"""Device-side Timestamp-Aware Cache on PyTorch tensors: the fused hot
path of ``repro/core/tac_jax.py`` (DESIGN.md §14).

State rows live in (n_buckets x ways) slots; the fused plane uses one
bucket of ``ways = capacity`` slots.  The payload pool is
``pages [n_slots + 1, 1, V + 1]``: channel 0 is a presence flag (0 = the
pane was never written; decodes to the Python side's ``None``), channels
1..V the value vector, and the LAST row a zeroed scratch slot that
miss/read/padding lanes alias so their scatters are inert.  The host
shadow directory (``streaming/fused.py``) owns eviction ORDER and slot
assignment; the device directory (``TACState.keys``) is authoritative for
MEMBERSHIP and the pool for payloads.

Unlike the reference, whose arrays are immutable, these functions update
``state`` and ``pages`` IN PLACE and return them: a batch touches a few
hundred rows of a pool that can hold hundreds of thousands.  Callers that
need the old state clone it first.  Probe, gather and scatter go through
the kernels of ``repro_torch.kernels`` (CUDA on a CUDA tensor, the plain
PyTorch versions on a CPU tensor); the rest is plain tensor code.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels.page_gather.page_gather import (page_gather_kernel,
                                                         page_scatter_kernel,
                                                         scatter_in_range)
from repro_torch.kernels.tac_probe.ops import tac_probe_gather


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


def from_numpy(keys, ts, vals, dirty, pages,
               device) -> Tuple[TACState, torch.Tensor]:
    """The reference's ``TACState`` fields and pool, as numpy arrays,
    turned into this module's tensors on ``device``."""
    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)
    state = TACState(put(keys, np.int32), put(ts, np.float32),
                     put(vals, np.asarray(vals).dtype), put(dirty, bool))
    return state, put(pages, np.float32)


def to_numpy(state: TACState, pages: torch.Tensor):
    """Inverse of ``from_numpy``: (keys, ts, vals, dirty, pages) arrays."""
    return tuple(t.cpu().numpy() for t in (*state, pages))


def _flat(t: torch.Tensor) -> torch.Tensor:
    """1-D view sharing storage (bool viewed as uint8 for reductions)."""
    t = t.view(-1)
    return t.view(torch.uint8) if t.dtype == torch.bool else t


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
    same-key update lane (lower-triangular mask), and the scatter's
    last-write-wins order leaves the final composed value in the pool.
    Miss lanes are NOT admitted here — admissions arrive later through
    ``fused_admit`` — so a miss lane's only trace is its tally.
    """
    B = keys.shape[0]
    trash = pages.shape[0] - 1
    rows, hit, slots = tac_probe_gather(keys, state.keys, state.vals, pages)
    hit = hit & valid
    slots = torch.where(hit, slots, trash).int()
    # flat directory index of a hit (bucket * ways + way); misses alias 0
    # with a neutral value, so the max-scatters below ignore them
    at = torch.where(hit, slots, 0).long()
    # timestamp refresh on hits (advisory fp32 copy; the fp64 eviction
    # order lives in the host shadow, §14)
    _flat(state.ts).scatter_reduce_(
        0, at, torch.where(hit, ts, -float("inf")), "amax")
    g = rows[:, 0, 1:]                          # [B, V] current value
    f = rows[:, 0, 0] > 0.5                     # [B] presence
    upd = torch.zeros_like(hit) if kind == "read" else hit & ~fire
    same = keys[:, None] == keys[None, :]
    M = same & upd[None, :] & torch.ones(
        (B, B), dtype=torch.bool, device=keys.device).tril()
    hasupd = M.any(dim=1)
    if kind == "max":
        m = torch.where(M[:, :, None], weights[None, :, :],
                        -float("inf")).amax(dim=1)
        new_v = torch.maximum(torch.where(f[:, None], g, -float("inf")), m)
    else:                                       # sum (count = sum of ones)
        # the composed sums must be exact fp32 (integer counts and prices)
        torch.backends.cuda.matmul.allow_tf32 = False
        new_v = torch.where(f[:, None], g, 0.0) + M.to(weights.dtype) @ weights
    present = f | hasupd
    new_v = torch.where(present[:, None], new_v, 0.0)
    if kind != "read":
        blocks = torch.cat([present[:, None].to(pages.dtype),
                            new_v.to(pages.dtype)], dim=1)[:, None, :]
        wslots = torch.where(upd, slots, trash).int()
        # write slots come from the probe, inside the pool by construction
        scatter_in_range(wslots, blocks.contiguous(), pages)
        # the scratch row must stay "absent" for future miss gathers
        pages[trash].zero_()
        _flat(state.dirty).scatter_reduce_(0, at, upd.to(torch.uint8),
                                           "amax")
    tallies = torch.stack([hit.sum(), (valid & ~hit).sum()]).int()
    return FusedStep(state, pages, hit, slots, new_v, present, tallies)


def fused_admit(state: TACState, pages: torch.Tensor, slots: torch.Tensor,
                keys: torch.Tensor, ts: torch.Tensor, rows: torch.Tensor,
                present: torch.Tensor, dirty: torch.Tensor):
    """Admit at HOST-CHOSEN slots (the shadow directory resolved victims
    and free slots; a slot may repeat only as an IDENTICAL padding
    duplicate of an earlier lane — chunked flushes pad to fixed widths
    that way).  Gathers the pre-overwrite victim rows first — a dirty
    victim's value feeds the eviction buffer for asynchronous write-back
    — then scatters the new rows and updates the device directory.
    Returns ``(state, pages, victim_rows [B, 1, V+1])``."""
    victim_rows = page_gather_kernel(slots, pages)
    blocks = torch.cat([present[:, None].to(pages.dtype),
                        rows.to(pages.dtype)], dim=1)[:, None, :]
    page_scatter_kernel(slots, blocks.contiguous(), pages)
    pages[-1].zero_()
    # duplicate slots carry identical records, so any write order is exact
    at = slots.long()
    _flat(state.keys).scatter_(0, at, keys.int())
    _flat(state.ts).scatter_(0, at, ts.float())
    _flat(state.dirty).scatter_(0, at, dirty.to(torch.uint8))
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
