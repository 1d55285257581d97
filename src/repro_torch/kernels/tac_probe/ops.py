"""Wrappers around the probe kernel: hash, probe, gather."""
from __future__ import annotations

import torch

from repro_torch.kernels.page_gather.page_gather import gather_in_range
from repro_torch.kernels.tac_probe.tac_probe import tac_probe_kernel

_A, _B = 2654435761, 40503
_A_HI, _A_LO = _A >> 16, _A & 0xFFFF
_M32 = 0xFFFFFFFF


def bucket_of(keys: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """``(uint32(key) * A ^ B) % n_buckets`` with uint32 wraparound, as
    the reference computes it, in int64: keys are taken as uint32 (so
    int32 negatives wrap) and the multiply is split at 16 bits so that no
    partial product of a key below 2**32 leaves int64."""
    k = keys.long() & _M32
    h = (k * _A_LO + (((k * _A_HI) & 0xFFFF) << 16)) & _M32
    return ((h ^ _B) % n_buckets).int()


def tac_probe(qkeys, bucket_keys, bucket_vals):
    buckets = bucket_of(qkeys, bucket_keys.shape[0])
    return tac_probe_kernel(qkeys.int(), buckets, bucket_keys, bucket_vals)


def tac_probe_counted(qkeys, bucket_keys, bucket_vals):
    """Probe + device-side tallies for the observability plane
    (DESIGN.md §12): returns ``(values, hit, way, counts)`` where
    ``counts`` is an int32 ``[2]`` vector of (n_hit, n_conflict) — a
    CONFLICT is a miss whose bucket is already full, i.e. admitting the
    key would evict."""
    buckets = bucket_of(qkeys, bucket_keys.shape[0])
    vals, hit, way = tac_probe_kernel(qkeys.int(), buckets, bucket_keys,
                                      bucket_vals)
    full = (bucket_keys[buckets.long()] != -1).all(dim=1)
    miss = hit == 0
    counts = torch.stack([hit.sum(), (miss & full).sum()]).int()
    return vals, hit, way, counts


def tac_probe_gather(qkeys, bucket_keys, bucket_vals, pages):
    """Composed probe -> page gather (DESIGN.md §14): the probe's
    (bucket, way) resolves to a flat slot id that indexes the page
    gather directly.

    ``pages`` is ``[n_slots + 1, page, d]``: the LAST row is a zeroed
    scratch slot that miss lanes alias, so their gathered rows decode as
    "absent" without any host-side masking.  Returns
    ``(rows [B, page, d], hit [B] bool, slots [B] int32 flat)``.
    """
    n_buckets, ways = bucket_keys.shape
    buckets = bucket_of(qkeys, n_buckets)
    _, hit, way = tac_probe_kernel(qkeys.int(), buckets, bucket_keys,
                                   bucket_vals)
    hit = hit.bool()
    trash = pages.shape[0] - 1
    slots = torch.where(hit, buckets * ways + way.clamp(min=0),
                        trash).int()
    # slots lie in [0, n_slots] by construction: no host-side range check
    rows = gather_in_range(slots, pages)
    return rows, hit, slots
