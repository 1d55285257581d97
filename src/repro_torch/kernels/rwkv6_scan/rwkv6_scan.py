"""RWKV6 (Finch) recurrence: the CUDA kernel ``csrc/rwkv6_scan.cu`` and its
plain PyTorch version.

Per batch row and head, sequentially over t, with an [N, N] fp32 state
(from ``init`` or zeros):
    y_t = r_t (S + (u * k_t) v_t^T)
    S   = diag(w_t) S + k_t v_t^T
Besides y the kernel returns the final state, which the prefill cache
needs.  Layout: r, k, v, w [B, S, H, N] in one type, u [B * H, N] (one
bonus per batch row and head), init [B, H, N, N]; y [B, S, H, N] in r's
type, state [B, H, N, N] fp32.  The Pallas layout ([BH, S, N], u [BH, N])
is the case H = 1.

``rwkv6_scan_kernel`` launches the kernel for CUDA tensors and runs
``rwkv6_scan_plain`` for CPU tensors; it never falls back from one to the
other.  The kernel cuts each head's state columns over blocks
(``plan_columns``) and its rows over the lanes of a block
(``rows_per_lane``); see the source's note.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_build

# launches of the CUDA kernel (not of the plain version) since the last reset
LAUNCHES = 0

HEAD_DIMS = (8, 16, 32, 64)          # the kernel's state sizes N
MIN_COLS = 8                         # state columns a block, at least
COLS_PER_THREAD = 4
STEPS = 32                           # time steps a staging buffer holds
SMEM_LIMIT = 232_448                 # dynamic shared memory a block may take
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rows_per_lane(N: int) -> int:
    """State rows of one column a thread keeps: N / rows_per_lane(N) lanes
    share a column."""
    return min(N, 16)


def plan_columns(units: int, N: int, sms: int) -> int:
    """State columns a block takes, for ``units`` (batch row, head) pairs
    on a card of ``sms`` SMs: the widest power-of-two tile of N, down to
    ``MIN_COLS``, that still gives every SM a block.  A wider tile reads
    each step's r, k and w once for more columns, and fewer blocks leave
    each warp a scheduler of its own."""
    cols = N
    while cols > MIN_COLS and units * (N // cols) < sms:
        cols //= 2
    return cols


def threads(N: int, cols: int) -> int:
    """Threads a block: ``COLS_PER_THREAD`` columns of one row slice
    each."""
    return cols // COLS_PER_THREAD * (N // rows_per_lane(N))


def smem_bytes(N: int, cols: int, dtype) -> int:
    """A block's dynamic shared memory, as ``csrc/rwkv6_scan.cu`` lays it
    out: two buffers of r, k and w (16 bytes of padding after each row
    slice) and of the tile's v for ``STEPS`` steps in the inputs' type;
    the slices' parts of y and bonus sums, and u, in fp32."""
    it = 2 if dtype == torch.bfloat16 else 4
    L = N // rows_per_lane(N)
    row = N + L * (16 // it)
    return it * 2 * STEPS * (3 * row + cols) + 4 * (L * STEPS * (cols + 1) + N)


def rwkv6_scan_plain(r, k, v, w, u, init=None):
    """The recurrence in plain PyTorch, one step at a time in fp32.
    Returns (y in r's type, final state [B, H, N, N] fp32)."""
    B, S, H, N = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float().reshape(B, H, N)
    st = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device) \
        if init is None else init.float()
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]    # [B,H,N,N]
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t],
                               st + uf[..., None] * kv))
        st = wf[:, t, :, :, None] * st + kv
    y = torch.stack(ys, dim=1) if ys else rf.clone()
    return y.to(r.dtype), st


def _check(r, k, v, w, u, init) -> None:
    tensors = [r, k, v, w, u] + ([] if init is None else [init])
    if any(t.device != r.device for t in tensors):
        raise ValueError("rwkv6_scan: all tensors must be on one device")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rwkv6_scan: no kernel for device {r.device}")
    B, S, H, N = r.shape if r.dim() == 4 else (0, 0, 0, 0)
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)) \
            or u.shape != (B * H, N) \
            or (init is not None and init.shape != (B, H, N, N)):
        raise ValueError("rwkv6_scan: shapes r/k/v/w [B, S, H, N], "
                         "u [B * H, N], init [B, H, N, N] expected")


def kernel_limits(r, k, v, w) -> None:
    """Raise on what the CUDA kernel does not take: a type other than fp32
    or bf16 (r, k, v and w alike), or N outside ``HEAD_DIMS``."""
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, w)):
        raise TypeError(f"rwkv6_scan: no kernel for r/k/v/w "
                        f"{[t.dtype for t in (r, k, v, w)]}")
    N = r.shape[3]
    if N not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: the kernel takes N in {HEAD_DIMS}, "
                         f"not {N}")


def rwkv6_scan_kernel(r, k, v, w, u, init=None):
    """Returns (y [B, S, H, N] in r's type, final state [B, H, N, N]
    fp32)."""
    global LAUNCHES
    _check(r, k, v, w, u, init)
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, init)
    cuda_build.refuse_grad("rwkv6_scan", (r, k, v, w, u, init))
    B, S, H, N = r.shape
    kernel_limits(r, k, v, w)
    if not all(t.is_contiguous() for t in (r, k, v, w)):
        raise ValueError("rwkv6_scan: tensors must be contiguous")
    u = u.float().contiguous()
    if init is not None:
        init = init.float().contiguous()
    y = torch.empty_like(r)
    state = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    if B * H == 0:
        return y, state
    sms = torch.cuda.get_device_properties(r.device).multi_processor_count
    fn = cuda_build.load("rwkv6_scan").rwkv6_scan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), 0 if init is None else init.data_ptr(),
             y.data_ptr(), state.data_ptr(), B, S, H, N,
             plan_columns(B * H, N, sms), _DTYPES[r.dtype],
             cuda_build.stream_ptr(r.device))
    cuda_build.check(err, "rwkv6_scan")
    LAUNCHES += 1
    return y, state


def kernel_smem_bytes(N: int, cols: int, dtype) -> int:
    """A block's shared memory as the CUDA source computes it (for the
    card's checks against ``smem_bytes``)."""
    fn = cuda_build.load("rwkv6_scan").rwkv6_scan_smem_bytes
    return fn(N, cols, int(dtype == torch.bfloat16))
