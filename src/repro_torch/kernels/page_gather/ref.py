"""Oracles for the page gather/scatter kernels: the plain PyTorch versions
beside the kernels (the reference package keeps its oracles here)."""
from repro_torch.kernels.page_gather.page_gather import (  # noqa: F401
    page_gather_plain as page_gather_ref,
    page_scatter_plain as page_scatter_ref)
