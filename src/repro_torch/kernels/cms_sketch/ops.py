"""Wrapper: hash keys -> columns, run the kernel, classify hot keys.

Device hashing uses uint32 multiply-shift wraparound, as the reference's
does; the host ``CountMinFilter`` uses prime-mod hashing.  The two sketches
share SEMANTICS (saturating counters, aging, all-rows >= T
classification), not hash values.  Torch has no uint32 arithmetic to rely
on, so the hash runs in int64 with every value masked to 32 bits, and the
multiply split at 16 bits so that no partial product leaves int64."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.cms_sketch.cms_sketch import update_in_range

_M32 = 0xFFFFFFFF


def _u32(x, device) -> torch.Tensor:
    """Values taken as uint32 (int32 negatives wrap), as int64 tensors."""
    if isinstance(x, torch.Tensor):
        t = x.to(device=device, dtype=torch.int64)
    else:
        t = torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)
    return t & _M32


def columns_for(keys, a, b, width: int) -> torch.Tensor:
    """keys [B] -> cols [d, B] int32 via uint32 multiply-shift wraparound,
    on the keys' device (the CPU for numpy keys)."""
    dev = keys.device if isinstance(keys, torch.Tensor) else "cpu"
    k = _u32(keys, dev)[None, :]
    a = _u32(a, dev)[:, None]
    h = (((a & 0xFFFF) * k + ((((a >> 16) * k) & 0xFFFF) << 16))
         + _u32(b, dev)[:, None]) & _M32
    h = h ^ (h >> 16)
    return (h % width).int()


def _device_of(x) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def run_device(keys_device: torch.device, counters_device: torch.device,
               interpret=None) -> torch.device:
    """Where ``cms_update_and_classify`` runs.  The inputs' device decides:
    host inputs (numpy arrays, CPU tensors) run the plain version on the
    CPU, CUDA tensors launch the kernel there.  ``interpret=True`` is the
    caller asking for the CPU, its only meaning in the reference, and
    ``interpret=False`` for the kernel; either raises when the inputs lie
    elsewhere, so no work moves between devices unasked."""
    devs = {keys_device.type, counters_device.type}
    dev = counters_device if devs == {"cuda"} else torch.device("cpu")
    if len(devs) > 1 and devs != {"cpu"}:
        raise ValueError(f"cms_update_and_classify: keys on {keys_device}, "
                         f"counters on {counters_device}")
    if devs - {"cpu", "cuda"}:
        raise ValueError(f"cms_sketch: no kernel for device {counters_device}")
    if interpret is not None and bool(interpret) != (dev.type == "cpu"):
        raise ValueError(f"cms_update_and_classify(interpret={interpret}) "
                         f"with inputs on {counters_device}: interpret=True "
                         f"takes host inputs, interpret=False CUDA tensors")
    return dev


def cms_update_and_classify(keys, counters, a, b, *, threshold: int = 20,
                            max_count: int = 255, interpret=None):
    """Batched equivalent of CountMinFilter.update_and_classify (no aging;
    the caller right-shifts ``counters`` every aging interval).  Returns
    (new_counters [d, w], hot [B] bool) as tensors on the device the work
    ran on, which ``run_device`` picks from the inputs and ``interpret``."""
    dev = run_device(_device_of(keys), _device_of(counters), interpret)
    if not isinstance(counters, torch.Tensor):
        counters = torch.from_numpy(np.ascontiguousarray(counters, np.int32))
    counters = counters.to(device=dev, dtype=torch.int32)
    keys = keys.to(dev) if isinstance(keys, torch.Tensor) \
        else torch.from_numpy(np.asarray(keys, np.int32)).to(dev)
    cols = columns_for(keys, a, b, counters.shape[1])
    new_counters, est = update_in_range(cols, counters, max_count)
    return new_counters, (est >= threshold).all(dim=0)
