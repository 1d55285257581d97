"""Batched Count-Min Sketch update/estimate: the CUDA kernel
``csrc/cms_sketch.cu`` and its plain PyTorch version.

The lookahead operator's hint extractor classifies a BATCH of keys per step
on the device.  Per sketch row and in batch order every lane increments its
column's saturating counter and reads the value after its own increment, so
duplicate keys in one batch see each other, exactly as the sequential
oracle does.  Both versions compute that walk in its parallel form:
``est = min(ctr0[c] + rank + 1, max_count)``, with ``rank`` the number of
earlier lanes of the row with the same column.

``cms_update_kernel`` launches the kernel for CUDA tensors and runs
``cms_update_plain`` for CPU tensors; it never falls back from one to the
other.  The kernel takes a block per (sketch row, column tile), the tiles
from ``plan_tiles``, and any batch size, as the reference does.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import cuda_build

# launches of the CUDA kernel (not of the plain version) since the last reset
LAUNCHES = 0

MAX_TILE = 4096         # counters a block holds; the kernel rejects more
MIN_TILE = 256          # below this a block's pass over the batch dominates


@functools.lru_cache(maxsize=None)
def plan_tiles(d: int, w: int, sms: int) -> Tuple[int, int]:
    """(tile, n_tiles): the columns a block holds, a multiple of 4 within
    [MIN_TILE, MAX_TILE] (or all of a narrower row), and the tiles a row,
    about one block an SM over the ``d`` rows."""
    cdiv = lambda a, b: -(-a // b)  # noqa: E731
    want = cdiv(max(w, 1), max(1, cdiv(sms, max(d, 1))))
    tile = min(MAX_TILE, max(MIN_TILE, cdiv(want, 4) * 4))
    tile = min(tile, max(4, cdiv(w, 4) * 4))
    return tile, max(1, cdiv(w, tile))


def cms_update_plain(cols, counters, max_count: int = 255):
    """cols [d, B] int32; counters [d, w] int32.  Returns (new_counters
    [d, w], est [d, B] int32); ``counters`` is left as it was."""
    d, B = cols.shape
    c = cols.long()
    # rank of each lane among the earlier lanes of its column: a stable sort
    # keeps batch order inside a column
    sc, idx = torch.sort(c, dim=1, stable=True)
    pos = torch.arange(B, device=cols.device).expand(d, B)
    start = torch.ones((d, B), dtype=torch.bool, device=cols.device)
    start[:, 1:] = sc[:, 1:] != sc[:, :-1]
    first = torch.where(start, pos, 0).cummax(dim=1).values
    rank = torch.empty_like(pos).scatter_(1, idx, pos - first)
    est = torch.clamp(counters.gather(1, c).long() + rank + 1,
                      max=max_count)
    # a touched counter ends at its last lane's value, the largest of its
    # column's estimates; untouched counters keep theirs
    new = counters.clone().scatter_reduce_(1, c, est.to(counters.dtype),
                                           "amax", include_self=False)
    return new, est.int()


def _check(cols, counters) -> None:
    if cols.device != counters.device:
        raise ValueError("cms_sketch: cols and counters on different "
                         "devices")
    if cols.dtype != torch.int32 or counters.dtype != torch.int32:
        raise TypeError("cms_sketch: cols and counters must be int32")
    if cols.dim() != 2 or counters.dim() != 2 \
            or cols.shape[0] != counters.shape[0]:
        raise ValueError("cms_sketch: shapes cols [d, B], counters [d, w] "
                         "expected")
    if cols.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cms_sketch: no kernel for device {cols.device}")


def update_in_range(cols, counters, max_count: int = 255):
    """``cms_update_kernel`` without the host-side column range check, for
    columns hashed into [0, w) (``ops.columns_for``)."""
    global LAUNCHES
    _check(cols, counters)
    if cols.device.type == "cpu":
        return cms_update_plain(cols, counters, max_count)
    if not (cols.is_contiguous() and counters.is_contiguous()):
        raise ValueError("cms_sketch: tensors must be contiguous")
    d, B = cols.shape
    w = counters.shape[1]
    fn = cuda_build.load("cms_sketch").cms_update
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    new = torch.empty_like(counters)
    est = torch.empty((d, B), dtype=torch.int32, device=cols.device)
    if d == 0:
        return new, est
    tile, n_tiles = plan_tiles(d, w, cuda_build.sm_count(cols.device))
    vec = w % 4 == 0 and counters.data_ptr() % 16 == 0 \
        and new.data_ptr() % 16 == 0
    err = fn(cols.data_ptr(), counters.data_ptr(), new.data_ptr(),
             est.data_ptr(), d, B, w, tile, n_tiles, int(max_count),
             int(vec), cuda_build.stream_ptr(cols.device))
    cuda_build.check(err, "cms_sketch")
    LAUNCHES += 1
    return new, est


def cms_update_kernel(cols, counters, *, max_count: int = 255):
    """cols [d, B] int32 (hash columns per row); counters [d, w] int32.
    Returns (new_counters [d, w], est [d, B]) where est is each key's
    counter AFTER its increment (the min over rows is taken outside).
    Raises ``IndexError`` for a column outside [0, w)."""
    _check(cols, counters)
    w = counters.shape[1]
    if cols.numel() and bool(((cols < 0) | (cols >= w)).any()):
        raise IndexError(f"cms_sketch: column outside [0, {w})")
    return update_in_range(cols, counters, max_count)
