"""Batched page gather/scatter between logical order and physical slots:
the CUDA kernels ``csrc/page_gather.cu`` and their plain PyTorch versions.

The keyed-state pool keeps rows in fixed physical slots chosen by the
device TAC.  Pulling N rows out (``page_gather_kernel``) or writing N rows
back (``page_scatter_kernel``) is one launch each.  The scatter updates
``pages`` IN PLACE and returns it; on duplicate slots the last write
wins, as in the reference's grid order.  Each wrapper launches the kernel
for CUDA tensors and runs the plain version for CPU tensors; it never
falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_build

# launches of each CUDA kernel (not of the plain versions) since the last
# reset
GATHER_LAUNCHES = 0
SCATTER_LAUNCHES = 0


def page_gather_plain(slots, pages):
    return pages[slots.long()]


def page_scatter_plain(slots, blocks, pages):
    """In place; a row is written only if no later row names its slot."""
    n = slots.shape[0]
    idx = torch.arange(n, device=slots.device)
    later = (slots[None, :] == slots[:, None]) & (idx[None, :] > idx[:, None])
    last = ~later.any(dim=1)
    pages[slots[last].long()] = blocks[last]
    return pages


def _unit(row_bytes: int, *tensors) -> int:
    """Widest copy unit dividing the row and every base pointer."""
    for u in (16, 8, 4, 2, 1):
        if row_bytes % u == 0 and all(t.data_ptr() % u == 0
                                      for t in tensors):
            return u
    return 1


def _fn(name: str):
    lib = cuda_build.load("page_gather")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(slots, pages, what: str) -> None:
    if slots.device != pages.device:
        raise ValueError(f"{what}: slots and pages on different devices")
    if slots.dtype != torch.int32 or slots.dim() != 1:
        raise TypeError(f"{what}: slots must be int32 [N]")
    if pages.dim() != 3:
        raise ValueError(f"{what}: pages must be [n_slots, page, d]")
    if pages.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {pages.device}")


def _check_range(slots, n_slots: int, what: str) -> None:
    if slots.numel() and bool(((slots < 0) | (slots >= n_slots)).any()):
        raise IndexError(f"{what}: slot outside [0, {n_slots})")


def gather_in_range(slots, pages):
    """``page_gather_kernel`` without the host-side range check, for
    callers that built ``slots`` on the device inside [0, n_slots) (the
    probe's slot ids); the kernel still reads nothing out of range."""
    global GATHER_LAUNCHES
    _check(slots, pages, "page_gather")
    if pages.device.type == "cpu":
        return page_gather_plain(slots, pages)
    if not (slots.is_contiguous() and pages.is_contiguous()):
        raise ValueError("page_gather: tensors must be contiguous")
    n = slots.shape[0]
    out = torch.empty((n,) + tuple(pages.shape[1:]), dtype=pages.dtype,
                      device=pages.device)
    if n == 0:
        return out
    row_bytes = pages[0].numel() * pages.element_size()
    err = _fn("page_gather")(
        slots.data_ptr(), pages.data_ptr(), out.data_ptr(), n,
        pages.shape[0], row_bytes, _unit(row_bytes, pages, out),
        cuda_build.stream_ptr(pages.device))
    cuda_build.check(err, "page_gather")
    GATHER_LAUNCHES += 1
    return out


def scatter_in_range(slots, blocks, pages):
    """``page_scatter_kernel`` without the host-side range check (see
    ``gather_in_range``)."""
    global SCATTER_LAUNCHES
    _check(slots, pages, "page_scatter")
    if blocks.device != pages.device or blocks.dtype != pages.dtype \
            or blocks.shape != (slots.shape[0],) + tuple(pages.shape[1:]):
        raise ValueError("page_scatter: blocks must be [N, page, d] of the "
                         "pool's dtype and device")
    if pages.device.type == "cpu":
        return page_scatter_plain(slots, blocks, pages)
    if not (slots.is_contiguous() and blocks.is_contiguous()
            and pages.is_contiguous()):
        raise ValueError("page_scatter: tensors must be contiguous")
    n = slots.shape[0]
    if n == 0:
        return pages
    row_bytes = pages[0].numel() * pages.element_size()
    err = _fn("page_scatter")(
        slots.data_ptr(), blocks.data_ptr(), pages.data_ptr(), n,
        pages.shape[0], row_bytes, _unit(row_bytes, blocks, pages),
        cuda_build.stream_ptr(pages.device))
    cuda_build.check(err, "page_scatter")
    SCATTER_LAUNCHES += 1
    return pages


def page_gather_kernel(slots, pages):
    """slots [N] int32; pages [n_slots, page, d].  Returns [N, page, d].
    Raises ``IndexError`` for a slot outside [0, n_slots)."""
    _check_range(slots, pages.shape[0], "page_gather")
    return gather_in_range(slots, pages)


def page_scatter_kernel(slots, blocks, pages):
    """slots [N] int32; blocks [N, page, d]; pages [n_slots, page, d].
    Sets ``pages[slots[i]] = blocks[i]`` IN PLACE (last write wins on
    duplicate slots) and returns ``pages``.  Raises ``IndexError`` for a
    slot outside [0, n_slots)."""
    _check_range(slots, pages.shape[0], "page_scatter")
    return scatter_in_range(slots, blocks, pages)
