"""Wrappers: slot-indirect page gather / scatter."""
from __future__ import annotations

from repro_torch.kernels.page_gather.page_gather import (page_gather_kernel,
                                                         page_scatter_kernel)


def page_gather(slots, pages):
    """slots [N]; pages [n_slots, page, d] -> [N, page, d]."""
    return page_gather_kernel(slots.int(), pages)


def page_scatter(slots, blocks, pages):
    """pages[slots[i]] = blocks[i], in place; returns the updated pool."""
    return page_scatter_kernel(slots.int(), blocks, pages)
