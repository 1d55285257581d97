"""The H100's figures for the roofline analysis: the port's counterpart of
``repro/launch/hw.py``, for the card the port runs on.

The card's figures are NVIDIA's data sheet for the H100 SXM5 part, the
one that ``nvidia-smi`` names "NVIDIA H100 80GB HBM3" at a power limit of
700.00 W; a card set below 700 W runs slower under load than these peaks
say.  The node's (eight cards on NVLink, one network port a card) are the
DGX H100 data sheet's.  ``chip_smoke.py`` takes its kernels' bounds from
here too.
"""

# dense bf16 on the tensor cores (no sparsity); H100 SXM5 data sheet,
# NVIDIA H100 80GB HBM3 at 700.00 W
PEAK_FLOPS_BF16 = 989e12      # FLOP/s per card
# fp32 on the CUDA cores (no TF32); H100 SXM5 data sheet, NVIDIA H100 80GB
# HBM3 at 700.00 W
PEAK_FLOPS_FP32 = 67e12       # FLOP/s per card
# HBM3 bandwidth; H100 SXM5 data sheet, NVIDIA H100 80GB HBM3 at 700.00 W
HBM_BW = 3.35e12              # bytes/s per card
# NVLink 4: 900 GB/s in total, 450 GB/s each way; H100 SXM5 data sheet,
# NVIDIA H100 80GB HBM3 at 700.00 W
NVLINK_BW = 450e9             # bytes/s per card, one direction
# device memory; H100 SXM5 data sheet, NVIDIA H100 80GB HBM3 (80 GB)
HBM_BYTES = 80 * 10 ** 9      # bytes per card
# the cards that NVLink joins: the eight of one HGX H100 board, on its
# NVSwitch fabric; DGX H100 data sheet (8 x NVIDIA H100 80GB HBM3, 700 W)
NVLINK_DOMAIN = 8             # cards per node
# between nodes: one 400 Gb/s ConnectX-7 port a card, 50 GB/s each way;
# DGX H100 data sheet (8 x single-port ConnectX-7, 400 Gb/s InfiniBand)
NETWORK_BW = 50e9             # bytes/s per card, one direction


def node_of(rank: int) -> int:
    """The node of a global rank, ``NVLINK_DOMAIN`` consecutive ranks a
    node, as a launcher places them."""
    return rank // NVLINK_DOMAIN


def roofline_terms(hlo_flops: float, hlo_bytes: float,
                   collective_bytes: float, chips: int,
                   inter_node_bytes: float = 0.0) -> dict:
    """The three roofline terms of one device's program, in seconds: its
    flops at the bf16 peak, its bytes at the HBM rate, and the bytes its
    collectives send, each way once (a ring collective sends each byte one
    way).  Of ``collective_bytes``, those of collectives whose group lies
    within one node go at ``NVLINK_BW`` (450 GB/s); ``inter_node_bytes``,
    those of collectives whose group spans nodes, go at ``NETWORK_BW`` (50
    GB/s), the slowest link of such a ring.  Both rates are peaks, so the
    term is a lower bound."""
    return {
        "compute_s": hlo_flops / PEAK_FLOPS_BF16,
        "memory_s": hlo_bytes / HBM_BW,
        "collective_s": (collective_bytes - inter_node_bytes) / NVLINK_BW
        + inter_node_bytes / NETWORK_BW,
    }
