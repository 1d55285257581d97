"""Batched TAC probe: the CUDA kernel ``csrc/tac_probe.cu`` and its plain
PyTorch version.

The device-resident Timestamp-Aware Cache stores state rows in fixed slots
organised as (n_buckets x ways); a batch of state-access keys is probed in
one launch: each query compares its bucket's ``ways`` keys and returns
(value_row, hit, way).  ``tac_probe_kernel`` launches the kernel for CUDA
tensors and runs ``tac_probe_plain`` for CPU tensors; it never falls back
from one to the other.  The kernel takes any value width D: a block sums
one tile of ``TILE_D`` columns of the matched rows (``d_tiles``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_build

# launches of the CUDA kernel (not of the plain version) since the last reset
LAUNCHES = 0

_DTYPES = {torch.float32: "tac_probe_f32", torch.bfloat16: "tac_probe_bf16"}
TILE_D = 1024                    # value columns a block sums (kTileD)


def d_tiles(D: int):
    """The kernel's tiles of the value columns: (first column, width) of
    each block of a query, ``TILE_D`` wide but the last."""
    return [(d0, min(TILE_D, D - d0)) for d0 in range(0, D, TILE_D)]


def tac_probe_plain(qkeys, buckets, bucket_keys, bucket_vals):
    """The probe in plain PyTorch: same arguments and results as
    ``tac_probe_kernel``."""
    B = qkeys.shape[0]
    ways = bucket_keys.shape[1]
    b = buckets.long()
    match = bucket_keys.index_select(0, b) == qkeys[:, None]    # [B, ways]
    qi, wi = match.nonzero(as_tuple=True)
    first = torch.full((B,), ways, dtype=torch.long, device=qkeys.device) \
        .scatter_reduce_(0, qi, wi, "amin")
    hit = first < ways
    way = torch.where(hit, first, -1)
    # only the matched rows are read: fp32 sum per query
    out = torch.zeros((B, bucket_vals.shape[-1]), dtype=torch.float32,
                      device=qkeys.device)
    out.index_add_(0, qi, bucket_vals[b[qi], wi].float())
    return (out.to(bucket_vals.dtype), hit.int(), way.int())


def _launch(qkeys, buckets, bucket_keys, bucket_vals):
    global LAUNCHES
    B = qkeys.shape[0]
    n_buckets, ways = bucket_keys.shape
    D = bucket_vals.shape[-1]
    lib = cuda_build.load("tac_probe")
    fn = getattr(lib, _DTYPES[bucket_vals.dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    dev = qkeys.device
    out = torch.empty((B, D), dtype=bucket_vals.dtype, device=dev)
    hit = torch.empty((B,), dtype=torch.int32, device=dev)
    way = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return out, hit, way
    err = fn(qkeys.data_ptr(), buckets.data_ptr(), bucket_keys.data_ptr(),
             bucket_vals.data_ptr(), out.data_ptr(), hit.data_ptr(),
             way.data_ptr(), B, n_buckets, ways, D,
             cuda_build.stream_ptr(dev))
    cuda_build.check(err, "tac_probe")
    LAUNCHES += 1
    return out, hit, way


def tac_probe_kernel(qkeys, buckets, bucket_keys, bucket_vals):
    """qkeys [B] int32; buckets [B] int32 (hash(qkey) % n_buckets, computed
    by the caller); bucket_keys [n_buckets, ways] int32 (-1 = empty);
    bucket_vals [n_buckets, ways, D] float32 or bfloat16.  Returns
    (values [B, D], hit [B] int32, way [B] int32), where ``values`` is the
    fp32 sum of the matched rows and ``way`` the first match or -1."""
    tensors = (qkeys, buckets, bucket_keys, bucket_vals)
    dev = qkeys.device
    if any(t.device != dev for t in tensors):
        raise ValueError("tac_probe: all tensors must be on one device")
    if qkeys.dtype != torch.int32 or buckets.dtype != torch.int32 \
            or bucket_keys.dtype != torch.int32:
        raise TypeError("tac_probe: keys and buckets must be int32")
    if qkeys.dim() != 1 or buckets.shape != qkeys.shape \
            or bucket_keys.dim() != 2 or bucket_vals.dim() != 3 \
            or bucket_vals.shape[:2] != bucket_keys.shape:
        raise ValueError("tac_probe: shapes qkeys [B], buckets [B], "
                         "bucket_keys [nb, ways], bucket_vals "
                         "[nb, ways, D] expected")
    if dev.type == "cpu":
        return tac_probe_plain(*tensors)
    if dev.type != "cuda":
        raise ValueError(f"tac_probe: no kernel for device {dev}")
    if bucket_vals.dtype not in _DTYPES:
        raise TypeError(f"tac_probe: no kernel for {bucket_vals.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("tac_probe: tensors must be contiguous")
    return _launch(*tensors)
