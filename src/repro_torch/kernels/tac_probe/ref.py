"""Oracle for the TAC probe kernel: the plain PyTorch version beside the
kernel (the reference package keeps its oracles here)."""
from repro_torch.kernels.tac_probe.tac_probe import (  # noqa: F401
    tac_probe_plain as tac_probe_ref)
