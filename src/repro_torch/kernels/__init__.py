"""Hand-written CUDA kernels for Hopper (sources in ``repro_torch/csrc``),
each beside its plain PyTorch version."""
