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

When a gradient is asked of CUDA tensors, the call goes through
``RWKV6Scan``, a ``torch.autograd.Function``: its forward launches the
same kernel, which also writes the state before every ``SAVE_EVERY``-th
step, and its backward launches ``csrc/rwkv6_scan_bwd.cu``
(``rwkv6_scan_backward``: the stretches between saved states, each
one's own part of the state gradient, a pass over them, then all of them
at once), fp32 only.  On the CPU autograd differentiates
the plain version, which is also the plain backward
(``rwkv6_scan_backward_plain``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_build

# launches of the CUDA kernel (not of the plain version) since the last
# reset, and of the backward (its four kernels, once a call)
LAUNCHES = 0
BWD_LAUNCHES = 0

HEAD_DIMS = (8, 16, 32, 64)          # the kernel's state sizes N
MIN_COLS = 8                         # state columns a block, at least
COLS_PER_THREAD = 4
STEPS = 32                           # time steps a staging buffer holds
SMEM_LIMIT = 232_448                 # dynamic shared memory a block may take
SAVE_EVERY = 16                      # steps between saved states (kSave)
BWD_SUB = 4                          # steps between the backward's checkpoints
# the backward's piece of the [N, N] state a thread (rows, columns)
BWD_PIECE = {8: (1, 2), 16: (2, 4), 32: (4, 4), 64: (4, 4)}
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


def saved_states(S: int) -> int:
    """States the forward saves for the backward: the state before steps
    0, ``SAVE_EVERY``, 2 ``SAVE_EVERY``, ..."""
    return -(-S // SAVE_EVERY)


def bwd_threads(N: int) -> int:
    """Threads a block of the backward's stretch kernels: one a
    ``BWD_PIECE`` piece of the [N, N] state, so a block holds whole
    rows."""
    ra, ca = BWD_PIECE[N]
    return (N // ra) * (N // ca)


def bwd_smem_bytes(N: int) -> int:
    """A block of the backward's stretch walk (kernel (3)), dynamic shared
    memory as ``csrc/rwkv6_scan_bwd.cu`` lays it out, all fp32: the
    stretch's r, k, v, w, dy [5][SAVE_EVERY][N] and two sums a step, the
    checkpoints [SAVE_EVERY / BWD_SUB][N][N], the column sums' parts
    [BWD_SUB][N / rows a piece][N] and dr, dk, dw [3][SAVE_EVERY][N]."""
    L, ra = SAVE_EVERY, BWD_PIECE[N][0]
    return 4 * (5 * L * N + 2 * L + L // BWD_SUB * N * N
                + BWD_SUB * (N // ra) * N + 3 * L * N)


def bwd_scratch_bytes(B: int, S: int, H: int, N: int) -> dict:
    """What the backward holds beside its inputs and gradients, all fp32:
    the forward's saved states [B, saved_states(S), H, N, N]; each
    stretch's own part of the state gradient, then the state gradient at
    its end, gs [B, saved_states(S), H, N, N]; each stretch's decay and
    its part of du [B, saved_states(S), H, N]."""
    ns = saved_states(S)
    return dict(states=4 * B * ns * H * N * N, gs=4 * B * ns * H * N * N,
                dec=4 * B * ns * H * N, du=4 * B * ns * H * N)


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


def rwkv6_scan_backward_plain(r, k, v, w, u, init, dy, dstate=None):
    """(dr, dk, dv, dw, du, dinit): autograd through ``rwkv6_scan_plain``
    for the gradients ``dy`` of y and ``dstate`` (or none) of the final
    state, each in its input's type; dinit is fp32, the gradient of a zero
    initial state when ``init`` is None."""
    B, S, H, N = r.shape
    if init is None:
        init = torch.zeros((B, H, N, N), dtype=torch.float32,
                           device=r.device)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (r, k, v, w, u, init)]
        y, st = rwkv6_scan_plain(*leaves)
        outs, grads = [y], [dy]
        if dstate is not None:
            outs.append(st)
            grads.append(dstate)
        return torch.autograd.grad(outs, leaves, grads)


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
    fp32), differentiable (through ``RWKV6Scan`` on the card, in fp32)."""
    _check(r, k, v, w, u, init)
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, init)
    u = u.float().contiguous()
    if init is not None:
        init = init.float().contiguous()
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, init)):
        if any(t.dtype != torch.float32 for t in (r, k, v, w)):
            raise TypeError(f"rwkv6_scan: the backward kernel takes float32 "
                            f"r/k/v/w only, not "
                            f"{[t.dtype for t in (r, k, v, w)]}")
        return RWKV6Scan.apply(r, k, v, w, u, init)
    return _forward(r, k, v, w, u, init, False)[:2]


def _forward(r, k, v, w, u, init, with_states: bool):
    """The kernel's (y, final state, the saved states [B,
    saved_states(S), H, N, N] fp32 or None); u and init fp32."""
    global LAUNCHES
    B, S, H, N = r.shape
    kernel_limits(r, k, v, w)
    if not all(t.is_contiguous() for t in (r, k, v, w)):
        raise ValueError("rwkv6_scan: tensors must be contiguous")
    y = torch.empty_like(r)
    state = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    states = torch.empty((B, saved_states(S), H, N, N), dtype=torch.float32,
                         device=r.device) if with_states else None
    if B * H == 0:
        return y, state, states
    sms = torch.cuda.get_device_properties(r.device).multi_processor_count
    fn = cuda_build.load("rwkv6_scan").rwkv6_scan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), 0 if init is None else init.data_ptr(),
             y.data_ptr(), state.data_ptr(),
             0 if states is None else states.data_ptr(), B, S, H, N,
             plan_columns(B * H, N, sms), _DTYPES[r.dtype],
             cuda_build.stream_ptr(r.device))
    cuda_build.check(err, "rwkv6_scan")
    LAUNCHES += 1
    return y, state, states


def rwkv6_scan_backward(r, k, v, w, u, states, dy, dstate=None):
    """(dr, dk, dv, dw, du, dinit) of the scan for the gradients ``dy`` of
    y and ``dstate`` (or none) of the final state, from the forward's
    saved ``states``: the backward's four kernels, counted once.  fp32
    throughout."""
    global BWD_LAUNCHES
    B, S, H, N = r.shape
    tensors = (r, k, v, w, u, dy, states) + (() if dstate is None
                                             else (dstate,))
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in tensors) or N not in HEAD_DIMS \
            or dy.shape != r.shape or u.shape != (B * H, N) \
            or states.shape != (B, saved_states(S), H, N, N) \
            or (dstate is not None and dstate.shape != (B, H, N, N)):
        raise ValueError("rwkv6_scan_backward: contiguous float32 r/k/v/w/"
                         "dy [B, S, H, N], u [B * H, N], states [B, "
                         "ceil(S / 16), H, N, N], dstate [B, H, N, N] and "
                         f"N in {HEAD_DIMS} expected")
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((B * H, N), dtype=torch.float32, device=r.device)
    dinit = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    ns = saved_states(S)
    gs = torch.empty((B, ns, H, N, N), dtype=torch.float32, device=r.device)
    dec, du_part = (torch.empty((B, ns, H, N), dtype=torch.float32,
                                device=r.device) for _ in range(2))
    fn = cuda_build.load("rwkv6_scan_bwd").rwkv6_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), dy.data_ptr(),
             0 if dstate is None else dstate.data_ptr(), states.data_ptr(),
             dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
             du.data_ptr(), dinit.data_ptr(), gs.data_ptr(), dec.data_ptr(),
             du_part.data_ptr(), B, S, H, N, cuda_build.stream_ptr(r.device))
    cuda_build.check(err, "rwkv6_scan_bwd")
    BWD_LAUNCHES += 1
    return dr, dk, dv, dw, du, dinit


class RWKV6Scan(torch.autograd.Function):
    """The scan with its backward kernel, for CUDA tensors; on CPU tensors
    the plain version and the plain backward."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, init):
        if r.device.type == "cpu":
            (y, state), states = rwkv6_scan_plain(r, k, v, w, u, init), None
        else:
            y, state, states = _forward(r, k, v, w, u, init, True)
        ctx.save_for_backward(r, k, v, w, u, init, states)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u, init, states = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else dy.to(r.dtype) \
            .contiguous()
        if dstate is not None:
            dstate = dstate.float().contiguous()
        if r.device.type == "cpu":
            grads = rwkv6_scan_backward_plain(r, k, v, w, u, init, dy,
                                              dstate)
        else:
            grads = rwkv6_scan_backward(r, k, v, w, u, states, dy, dstate)
        return (*grads[:5], None if init is None else grads[5])


def kernel_smem_bytes(N: int, cols: int, dtype) -> int:
    """A block's shared memory as the CUDA source computes it (for the
    card's checks against ``smem_bytes``)."""
    fn = cuda_build.load("rwkv6_scan").rwkv6_scan_smem_bytes
    return fn(N, cols, int(dtype == torch.bfloat16))


def kernel_bwd_smem_bytes(N: int) -> int:
    """A block of the backward's stretch walk, shared memory as the CUDA
    source computes it (for the card's checks against
    ``bwd_smem_bytes``)."""
    return cuda_build.load("rwkv6_scan_bwd").rwkv6_scan_bwd_smem_bytes(N)
