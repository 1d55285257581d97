"""Blocked online-softmax attention: the CUDA kernel
``csrc/flash_attention.cu`` and its plain PyTorch version.

q ``[B, S, H, d]`` attends over k/v ``[B, T, KV, d]`` with scale 1/sqrt(d),
causally (key t <= query s) or over every key; query head h reads KV head
``h // (H / KV)``, which is the reference wrapper's repeat of the KV heads
without the copy.  Scores, softmax and the value sum are fp32; the output
has q's type.  The Pallas layout ``[BH, S, d]`` is the case H = KV = 1.

``flash_attention_kernel`` launches the kernel for CUDA tensors and runs
``flash_attention_plain`` for CPU tensors; it never falls back from one to
the other.  On the card bfloat16 runs on the tensor cores (probabilities
rounded to bf16 before the value product, as SDPA's flash backend does) and
float32 on the CUDA cores in full fp32.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import cuda_build

# launches of the CUDA kernel (not of the plain version) since the last reset
LAUNCHES = 0

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # the kernel's head dims
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, causal: bool = True):
    """The Pallas kernel's function in plain PyTorch: fp32 scores times
    1/sqrt(d), masked to -1e30 above the diagonal when causal, softmax in
    fp32, the output in q's type."""
    B, S, H, d = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, S, KV, G, d)
    s = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) \
        * (1.0 / math.sqrt(d))
    if causal:
        mask = torch.arange(S, device=q.device)[:, None] \
            >= torch.arange(T, device=q.device)[None, :]
        s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float()) \
        / p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]
    return o.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def smem_bytes(d: int, dtype) -> int:
    """The kernel's dynamic shared memory a block at head dim ``d``."""
    fn = cuda_build.load("flash_attention").flash_attention_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(d, _DTYPES[dtype])


def _check(q, k, v) -> None:
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: all tensors must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3] or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3] or k.shape[2] == 0 \
            or q.shape[2] % k.shape[2]:
        raise ValueError("flash_attention: shapes q [B, S, H, d], k/v "
                         "[B, T, KV, d*] with H a multiple of KV expected")


def flash_attention_kernel(q, k, v, causal: bool = True):
    """q [B, S, H, d]; k/v [B, T, KV, d*].  Returns [B, S, H, dv] in q's
    type."""
    global LAUNCHES
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    B, S, H, d = q.shape
    T, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: no kernel for q {q.dtype}, k/v "
                        f"{k.dtype}/{v.dtype}")
    if d not in HEAD_DIMS or dv != d:
        raise ValueError(f"flash_attention: the kernel takes d = dv in "
                         f"{HEAD_DIMS}, not d={d}, dv={dv}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: tensors must be contiguous")
    if T == 0:
        raise ValueError("flash_attention: no keys")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: tensors must be 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = cuda_build.load("flash_attention").flash_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
             T, H, KV, d, int(causal), _DTYPES[q.dtype],
             cuda_build.stream_ptr(q.device))
    cuda_build.check(err, "flash_attention")
    LAUNCHES += 1
    return out
