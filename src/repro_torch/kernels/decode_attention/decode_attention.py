"""Paged single-token decode attention: the CUDA kernel
``csrc/decode_attention.cu`` and its plain PyTorch version.

One query token per sequence attends over a KV history stored as fixed-size
pages whose physical slots the Timestamp-Aware Cache assigned
(``repro_torch.serving.arena``).  ``page_table [B, P]`` names each
sequence's pages in order; positions at or past ``seq_lens[b]`` are masked
and their pages are never read, so their table entries may be -1 (a probe
miss).  One KV head is shared by all H query heads; callers with
grouped-query attention fold the KV heads into the batch
(q ``[B * KV, H / KV, d]``, one table row per sequence and KV head).

``paged_decode_attention_kernel`` launches the kernel for CUDA tensors and
runs ``paged_decode_plain`` for CPU tensors; it never falls back from one to
the other.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import cuda_build

# launches of the CUDA kernel (not of the plain version) since the last reset
LAUNCHES = 0

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)     # the kernel's head dims (one build each)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _needed(page_table, seq_lens, page: int) -> torch.Tensor:
    """[B, P] bool: the pages that hold a position below ``seq_len``."""
    P = page_table.shape[1]
    first = torch.arange(P, device=page_table.device) * page
    return first[None, :] < seq_lens[:, None].long()


def paged_decode_plain(q, k_pages, v_pages, page_table, seq_lens):
    """The Pallas kernel's function in plain PyTorch: fp32 scores divided by
    sqrt(d), masked to -1e30 at or past ``seq_len``, softmax in fp32 and
    ``acc / max(l, 1e-30)`` (a sequence of length 0 gives zeros).  Pages
    past ``seq_len`` are not read."""
    B, H, d = q.shape
    page = k_pages.shape[1]
    P = page_table.shape[1]
    T = P * page
    tbl = torch.where(_needed(page_table, seq_lens, page), page_table,
                      0).long()
    k = k_pages[tbl].reshape(B, T, -1).float()
    v = v_pages[tbl].reshape(B, T, -1).float()
    valid = (torch.arange(T, device=q.device)[None, :]
             < seq_lens[:, None].long())[:, None, :]            # [B, 1, T]
    s = torch.einsum("bhd,btd->bht", q.float(), k) / math.sqrt(d)
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    out = torch.einsum("bht,btd->bhd", p, v) \
        / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return out.to(q.dtype)


def _check(q, k_pages, v_pages, page_table, seq_lens) -> None:
    tensors = (q, k_pages, v_pages, page_table, seq_lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("decode_attention: all tensors must be on one "
                         "device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_attention: no kernel for device "
                         f"{q.device}")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("decode_attention: page_table and seq_lens must be "
                        "int32")
    if q.dim() != 3 or k_pages.dim() != 3 or v_pages.dim() != 3 \
            or page_table.dim() != 2 or seq_lens.shape != (q.shape[0],) \
            or page_table.shape[0] != q.shape[0] \
            or k_pages.shape[:2] != v_pages.shape[:2] \
            or k_pages.shape[2] != q.shape[2]:
        raise ValueError("decode_attention: shapes q [B, H, d], pages "
                         "[n_slots, page, d*], page_table [B, P], seq_lens "
                         "[B] expected")


def _check_range(page_table, seq_lens, n_slots: int, page: int) -> None:
    bad = _needed(page_table, seq_lens, page) \
        & ((page_table < 0) | (page_table >= n_slots))
    if bool(bad.any()):
        raise IndexError(f"decode_attention: a page below seq_len names a "
                         f"slot outside [0, {n_slots})")


def attention_in_range(q, k_pages, v_pages, page_table, seq_lens):
    """``paged_decode_attention_kernel`` without the host-side range check
    (which synchronises), for callers whose table holds only slots the
    arena returned for resident pages; the kernel still reads no slot
    outside the pool."""
    global LAUNCHES
    _check(q, k_pages, v_pages, page_table, seq_lens)
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, page_table, seq_lens)
    B, H, d = q.shape
    n_slots, page, dv = v_pages.shape
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"decode_attention: no kernel for q {q.dtype}, "
                        f"pages {k_pages.dtype}/{v_pages.dtype}")
    if d not in HEAD_DIMS or dv != d:
        raise ValueError(f"decode_attention: the kernel takes d = dv in "
                         f"{HEAD_DIMS}, not d={d}, dv={dv}")
    tensors = (q, k_pages, v_pages, page_table, seq_lens)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention: tensors must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("decode_attention: pages must be 16-byte aligned")
    out = torch.empty((B, H, d), dtype=q.dtype, device=q.device)
    if B == 0 or H == 0:
        return out
    lib = cuda_build.load("decode_attention")
    fn = lib.decode_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
             B, H, d, page_table.shape[1], page, n_slots, _DTYPES[q.dtype],
             cuda_build.stream_ptr(q.device))
    cuda_build.check(err, "decode_attention")
    LAUNCHES += 1
    return out


def paged_decode_attention_kernel(q, k_pages, v_pages, page_table,
                                  seq_lens):
    """q [B, H, d]; k_pages/v_pages [n_slots, page, d*] (float32 or
    bfloat16, the type of q); page_table [B, P] int32 physical slot ids;
    seq_lens [B] int32.  Returns [B, H, dv] in q's type.  Raises
    ``IndexError`` when a page below ``seq_len`` names a slot outside
    [0, n_slots)."""
    _check(q, k_pages, v_pages, page_table, seq_lens)
    _check_range(page_table, seq_lens, k_pages.shape[0], k_pages.shape[1])
    return attention_in_range(q, k_pages, v_pages, page_table, seq_lens)
