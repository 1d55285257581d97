"""Blocked online-softmax attention: the CUDA kernel
``csrc/flash_attention.cu``, its backward ``csrc/flash_attention_bwd.cu``
and their plain PyTorch versions.

q ``[B, S, H, d]`` attends over k ``[B, T, KV, d]`` and v ``[B, T, KV,
dv]`` with scale 1/sqrt(d), causally (key t <= query s) or over every key;
query head h reads KV head ``h // (H / KV)``, which is the reference
wrapper's repeat of the KV heads without the copy.  Scores, softmax and the
value sum are fp32; the output ``[B, S, H, dv]`` has q's type.  The Pallas
layout ``[BH, S, d]`` is the case H = KV = 1.  The kernel is instantiated
for the ``(d, dv)`` pairs of ``PAIRS``: every pair the model zoo's configs
reach.

``flash_attention_kernel`` launches the kernel for CUDA tensors and runs
``flash_attention_plain`` for CPU tensors; it never falls back from one to
the other.  On the card bfloat16 runs on the tensor cores (probabilities
rounded to bf16 before the value product, as SDPA's flash backend does) and
float32 on the CUDA cores in full fp32.

When a gradient is asked of CUDA tensors, the call goes through
``FlashAttention``, a ``torch.autograd.Function``: its forward launches the
same kernel, which also writes each row's log-sum-exp, and its backward
launches ``flash_attention_backward`` (D = rowsum(dO o), then dK/dV and
dQ).  On the CPU autograd differentiates the plain version, which is also
the plain backward (``flash_attention_backward_plain``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import cuda_build

# launches of the CUDA kernel (not of the plain version) since the last
# reset, and of the backward (its three kernels, once a call)
LAUNCHES = 0
BWD_LAUNCHES = 0

NEG_INF = -1e30
# the kernel's (d, dv) pairs: FLASH_PAIRS in csrc/flash_attention.cu
PAIRS = ((8, 8), (16, 16), (24, 16), (32, 32), (64, 64), (80, 80),
         (128, 128), (192, 128), (256, 256))
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


def flash_attention_backward_plain(q, k, v, dout, causal: bool = True):
    """(dq, dk, dv): autograd through ``flash_attention_plain``, each in
    its input's type."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention_plain(*leaves, causal)
        return torch.autograd.grad(out, leaves, dout)


def smem_bytes(d: int, dv: int, dtype) -> int:
    """The kernel's dynamic shared memory a block at ``(d, dv)``."""
    fn = cuda_build.load("flash_attention").flash_attention_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(d, dv, _DTYPES[dtype])


def bwd_smem_bytes(d: int, dv: int, dtype, dkdv: bool) -> int:
    """The backward's dynamic shared memory a block of its dK/dV kernel
    (``dkdv``) or its dQ kernel at ``(d, dv)``."""
    fn = cuda_build.load("flash_attention_bwd") \
        .flash_attention_bwd_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn(d, dv, _DTYPES[dtype], int(dkdv))


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
    type, differentiable (through ``FlashAttention`` on the card)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal, False)[0]


def _cuda_limits(q, k, v) -> None:
    """Raise on what the CUDA kernels do not take."""
    d, dv = q.shape[3], v.shape[3]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: no kernel for q {q.dtype}, k/v "
                        f"{k.dtype}/{v.dtype}")
    if (d, dv) not in PAIRS:
        raise ValueError(f"flash_attention: the kernel takes (d, dv) in "
                         f"{PAIRS}, not ({d}, {dv})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: tensors must be contiguous")
    if k.shape[1] == 0:
        raise ValueError("flash_attention: no keys")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: tensors must be 16-byte aligned")


def _forward(q, k, v, causal: bool, with_lse: bool):
    """The kernel's (out [B, S, H, dv], lse [B, H, S] fp32 or None)."""
    global LAUNCHES
    _cuda_limits(q, k, v)
    B, S, H, d = q.shape
    T, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    out = q.new_empty((B, S, H, dv))
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() == 0:
        return out, lse
    fn = cuda_build.load("flash_attention").flash_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             0 if lse is None else lse.data_ptr(), B, S, T, H, KV, d, dv,
             int(causal), _DTYPES[q.dtype], cuda_build.stream_ptr(q.device))
    cuda_build.check(err, "flash_attention")
    LAUNCHES += 1
    return out, lse


def backward_from_delta(q, k, v, lse, delta, dout, causal: bool = True):
    """The backward's dK/dV and dQ kernels alone, given the row vector
    ``delta`` [B, H, S] (D = rowsum(dO o), fp32).  Returns (dq, dk, dv) in
    q's type.  Not counted: ``flash_attention_backward`` is the entry
    point."""
    _cuda_limits(q, k, v)
    B, S, H, d = q.shape
    T, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    if dout.shape != (B, S, H, dv) or dout.dtype != q.dtype \
            or not dout.is_contiguous() or lse.shape != (B, H, S) \
            or delta.shape != (B, H, S) or lse.dtype != torch.float32 \
            or delta.dtype != torch.float32:
        raise ValueError("flash_attention_backward: dout [B, S, H, dv] in "
                         "q's type and fp32 lse, delta [B, H, S] expected")
    dq, dk, dvv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk.zero_(), dvv.zero_()
    fn = cuda_build.load("flash_attention_bwd").flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dvv.data_ptr(), B, S, T, H, KV, d, dv, int(causal),
             _DTYPES[q.dtype], cuda_build.stream_ptr(q.device))
    cuda_build.check(err, "flash_attention_bwd")
    return dq, dk, dvv


def flash_attention_backward(q, k, v, out, lse, dout, causal: bool = True):
    """(dq, dk, dv) of the attention ``out`` = flash_attention(q, k, v)
    for its gradient ``dout``, from the forward's ``lse``: three kernel
    launches (D, dK/dV, dQ), counted once."""
    global BWD_LAUNCHES
    B, S, H, _ = q.shape
    dv = v.shape[3]
    if any(t.shape != (B, S, H, dv) or t.dtype != q.dtype
           or not t.is_contiguous() for t in (out, dout)):
        raise ValueError("flash_attention_backward: out and dout "
                         "[B, S, H, dv], contiguous, in q's type expected")
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if delta.numel():
        fn = cuda_build.load("flash_attention_bwd").flash_attention_bwd_delta
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        err = fn(out.data_ptr(), dout.data_ptr(), delta.data_ptr(), B, S, H,
                 dv, _DTYPES[q.dtype], cuda_build.stream_ptr(q.device))
        cuda_build.check(err, "flash_attention_bwd_delta")
    grads = backward_from_delta(q, k, v, lse, delta, dout, causal)
    BWD_LAUNCHES += 1
    return grads


class FlashAttention(torch.autograd.Function):
    """The kernel with its backward kernels, for CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _forward(q, k, v, causal, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout.to(q.dtype).contiguous(), ctx.causal)
        return dq, dk, dv, None
