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
(``rows_per_lane``); see the source's note.  It is built for the state
sizes of ``HEAD_DIMS``; any other N up to ``BLOCK_N`` runs the next one up
on inputs zero-padded to it (``padded_n``, ``pad_state_dim``), and y and
the state are sliced back.  Zero k and v columns leave the state's extra
rows and columns zero whatever w holds, and zero r adds nothing to y, so
the padding changes no output.  It sits outside ``RWKV6Scan``, so the
backward takes the padded size too.

A state past ``BLOCK_N`` runs as blocks of the ``BLOCK_N`` instance: block
(I, J) of S [N, N] depends only on r_I, k_I, w_I, u_I, v_J and init[I, J]
(the recurrence is row-wise in w and k, column-wise in v), so it is
exactly the square instance's scan of those, and y_J = sum_I y_{I,J}.
``stack_blocks`` lays the nb^2 blocks of N padded to nb * ``BLOCK_N``
(``padded_n``) on the head axis, one launch runs them all, and
``unstack`` sums y over I in fp32 (a bf16 input runs the fp32 instance
on its exact fp32 values, so y is rounded to bf16 once) and puts the
state's blocks back.  ``RWKV6Blocks`` is the gradient: the backward
kernel on the stacked blocks, dr, dk, dw and du summed over J and dv over
I.  The blocks re-read r, k, w nb times and v nb times; the work booked
is the scan's own at N (``costs.rwkv_fwd``).

When a gradient is asked of CUDA tensors, the call goes through
``RWKV6Scan``, a ``torch.autograd.Function``: its forward launches the
same kernel, which also writes the state before every ``SAVE_EVERY``-th
step, and its backward launches ``csrc/rwkv6_scan_bwd.cu``
(``rwkv6_scan_backward``: the stretches between saved states, each
one's own part of the state gradient, a pass over them, then all of them
at once), fp32 only.  On the CPU autograd differentiates
the plain version, which is also the plain backward
(``rwkv6_scan_backward_plain``).

Given DTensors (under a mesh), the wrapper runs on the local shards
(``kernels/sharded.py``): batch and heads may be split over the mesh, the
sequence and the head dim stay whole.  Given meta tensors, the forward
and the backward return empty outputs of the right shapes and book their
cost (``kernels/costs.py``) instead of running, the plain version's step
loop included.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import costs, cuda_build, sharded

# launches of the CUDA kernel (not of the plain version) since the last
# reset, and of the backward (its four kernels, once a call)
LAUNCHES = 0
BWD_LAUNCHES = 0

HEAD_DIMS = (8, 16, 32, 64)          # the kernel's state sizes N
BLOCK_N = HEAD_DIMS[-1]              # a larger N runs as blocks of this
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
    if r.device.type not in ("cpu", "cuda", "meta"):
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


def padded_n(N: int) -> int:
    """The state size N runs at: the smallest of ``HEAD_DIMS`` that holds
    it, or past ``BLOCK_N`` the next multiple of ``BLOCK_N`` (its blocks,
    ``stack_blocks``).  Raises below 1."""
    if N < 1:
        raise ValueError(f"rwkv6_scan: a state size N >= 1, not {N}")
    for n in HEAD_DIMS:
        if N <= n:
            return n
    return -(-N // BLOCK_N) * BLOCK_N


def stack_blocks(r, k, v, w, u, init, nb: int):
    """The blocks (I, J) of a state of nb * ``BLOCK_N`` rows and columns
    as heads of the ``BLOCK_N`` scan, head (h, I, J) at h nb^2 + I nb + J:
    r, k, w of row block I, v of column block J [B, S, H nb^2,
    BLOCK_N], u of I [B H nb^2, BLOCK_N] and init's block (I, J) [B, H
    nb^2, BLOCK_N, BLOCK_N] (or None).  Inputs already padded."""
    B, S, H, _ = r.shape
    n = BLOCK_N

    def rows(t):                      # [.., nb, n] -> block I at (I, J)
        t = t.reshape(*t.shape[:-1], nb, 1, n)
        return t.expand(*t.shape[:-3], nb, nb, n)

    def cols(t):                      # block J at (I, J)
        t = t.reshape(*t.shape[:-1], 1, nb, n)
        return t.expand(*t.shape[:-3], nb, nb, n)

    heads = lambda t: t.reshape(B, S, H * nb * nb, n).contiguous()  # noqa
    out = [heads(rows(r)), heads(rows(k)), heads(cols(v)), heads(rows(w)),
           rows(u).reshape(B * H * nb * nb, n).contiguous()]
    out.append(None if init is None else init.reshape(B, H, nb, n, nb, n)
               .permute(0, 1, 2, 4, 3, 5)
               .reshape(B, H * nb * nb, n, n).contiguous())
    return out


def stack_cotangents(dy, dstate, nb: int):
    """The cotangents of the whole scan's y [B, S, H, N] and final state
    [B, H, N, N] (or None) as the stacked blocks' (``stack_blocks``),
    padded to nb * ``BLOCK_N``, fp32: each block (I, J) gets dy_J (y_J
    sums the blocks over I) and dstate's block (I, J)."""
    B, S, H, N = dy.shape
    n, Np = BLOCK_N, nb * BLOCK_N
    dy = F.pad(dy.float(), (0, Np - N)).reshape(B, S, H, 1, nb, n) \
        .expand(B, S, H, nb, nb, n).reshape(B, S, H * nb * nb, n) \
        .contiguous()
    if dstate is not None:
        dstate = F.pad(dstate.float(), (0, Np - N, 0, Np - N)) \
            .reshape(B, H, nb, n, nb, n).permute(0, 1, 2, 4, 3, 5) \
            .reshape(B, H * nb * nb, n, n).contiguous()
    return dy, dstate


def unstack(y, state, B: int, S: int, H: int, nb: int):
    """The blocks' (y [B, S, H nb^2, BLOCK_N], final state [B, H nb^2,
    BLOCK_N, BLOCK_N]) as the whole scan's: y_J the sum over I (in y's
    type), the state's blocks in place."""
    n = BLOCK_N
    y = y.reshape(B, S, H, nb, nb, n).sum(dim=3).reshape(B, S, H, nb * n)
    state = state.reshape(B, H, nb, nb, n, n).permute(0, 1, 2, 4, 3, 5) \
        .reshape(B, H, nb * n, nb * n)
    return y, state


def unstack_grads(dr, dk, dv, dw, du, dinit, B: int, S: int, H: int,
                  nb: int):
    """The stacked blocks' gradients as the whole scan's: dr, dk, dw and
    du summed over the column blocks J, dv over the row blocks I, dinit's
    blocks in place."""
    n = BLOCK_N
    per = lambda t: t.reshape(B, S, H, nb, nb, n)  # noqa: E731
    sum_j = lambda t: per(t).sum(dim=4).reshape(B, S, H, nb * n)  # noqa
    dv = per(dv).sum(dim=3).reshape(B, S, H, nb * n)
    du = du.reshape(B * H, nb, nb, n).sum(dim=2).reshape(B * H, nb * n)
    dinit = dinit.reshape(B, H, nb, nb, n, n).permute(0, 1, 2, 4, 3, 5) \
        .reshape(B, H, nb * n, nb * n)
    return sum_j(dr), sum_j(dk), dv, sum_j(dw), du, dinit


def pad_state_dim(r, k, v, w, u, init, n: int):
    """r, k, v, w [B, S, H, N] and u [B * H, N] zero-padded to N = ``n``,
    init [B, H, N, N] (if given) to [B, H, n, n]."""
    N = r.shape[3]
    r, k, v, w, u = (F.pad(t, (0, n - N)) for t in (r, k, v, w, u))
    if init is not None:
        init = F.pad(init, (0, n - N, 0, n - N))
    return r, k, v, w, u, init


def kernel_limits(r, k, v, w) -> None:
    """Raise on what the CUDA kernel does not take: a type other than fp32
    or bf16 (r, k, v and w alike), or N below 1."""
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, w)):
        raise TypeError(f"rwkv6_scan: no kernel for r/k/v/w "
                        f"{[t.dtype for t in (r, k, v, w)]}")
    padded_n(r.shape[3])


def _grad_wanted(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _fp32_for_grad(r, k, v, w) -> None:
    if any(t.dtype != torch.float32 for t in (r, k, v, w)):
        raise TypeError(f"rwkv6_scan: the backward kernel takes float32 "
                        f"r/k/v/w only, not {[t.dtype for t in (r, k, v, w)]}")


def rwkv6_scan_kernel(r, k, v, w, u, init=None):
    """Returns (y [B, S, H, N] in r's type, final state [B, H, N, N]
    fp32), differentiable (through ``RWKV6Scan`` on the card, in fp32)."""
    if sharded.any_dtensor(r, k, v, w, u, init):
        return _on_mesh(r, k, v, w, u, init)
    _check(r, k, v, w, u, init)
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, init)
    N = r.shape[3]
    if N > BLOCK_N:                    # blocks of the BLOCK_N instance
        kernel_limits(r, k, v, w)
        if _grad_wanted(r, k, v, w, u, init):
            _fp32_for_grad(r, k, v, w)
            return RWKV6Blocks.apply(r, k, v, w, u, init)
        return _blocks_forward(r, k, v, w, u, init)[:2]
    if N not in HEAD_DIMS:             # the next instance up, on zeros
        kernel_limits(r, k, v, w)
        y, state = rwkv6_scan_kernel(*pad_state_dim(r, k, v, w, u, init,
                                                    padded_n(N)))
        return y[..., :N].contiguous(), state[..., :N, :N].contiguous()
    u = u.float().contiguous()
    if init is not None:
        init = init.float().contiguous()
    if _grad_wanted(r, k, v, w, u, init):
        _fp32_for_grad(r, k, v, w)
        return RWKV6Scan.apply(r, k, v, w, u, init)
    return _forward(r, k, v, w, u, init, False)[:2]


def _blocks_forward(r, k, v, w, u, init, with_states: bool = False):
    """The scan at N past ``BLOCK_N`` as one launch on its blocks
    (``stack_blocks``): (y in r's type, final state fp32, the stacked
    inputs and the saved states when ``with_states``, else None).  On meta
    tensors it books the scan's own cost at N."""
    B, S, H, N = r.shape
    if r.device.type == "meta":
        costs.book("rwkv6_scan", costs.rwkv_fwd(B, S, H, N,
                                                r.element_size()))
        return (torch.empty_like(r),
                torch.empty((B, H, N, N), dtype=torch.float32,
                            device="meta"), None)
    Np = padded_n(N)
    nb = Np // BLOCK_N
    fp32 = [t.float() for t in (r, k, v, w, u)] \
        + [None if init is None else init.float()]
    stacked = stack_blocks(*pad_state_dim(*fp32, Np), nb)
    y, state, states = _forward(*stacked, with_states)
    y, state = unstack(y, state, B, S, H, nb)
    return (y[..., :N].to(r.dtype), state[..., :N, :N].contiguous(),
            (stacked, states) if with_states else None)


class RWKV6Blocks(torch.autograd.Function):
    """The scan at N past ``BLOCK_N`` on the card with its gradient: the
    forward and backward kernels on the stacked blocks, fp32."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, init):
        y, state, saved = _blocks_forward(r, k, v, w, u, init, True)
        ctx.shape = r.shape
        ctx.has_init = init is not None
        ctx.save_for_backward(*(() if saved is None
                                else (*saved[0][:5], saved[1])))
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        B, S, H, N = ctx.shape
        if not ctx.saved_tensors:       # meta: the backward's own cost
            costs.book("rwkv6_scan_bwd",
                       costs.rwkv_bwd(B, S, H, N, SAVE_EVERY))
            e = torch.empty((B, S, H, N), device="meta")
            return (e, e, e, e, torch.empty((B * H, N), device="meta"),
                    torch.empty((B, H, N, N), device="meta")
                    if ctx.has_init else None)
        *stacked, states = ctx.saved_tensors
        nb = padded_n(N) // BLOCK_N
        if dy is None:
            dy = torch.zeros((B, S, H, N), device=states.device)
        grads = unstack_grads(*rwkv6_scan_backward(
            *stacked, states, *stack_cotangents(dy, dstate, nb)), B, S, H, nb)
        dr, dk, dv, dw = (g[..., :N] for g in grads[:4])
        return (dr, dk, dv, dw, grads[4][:, :N],
                grads[5][:, :, :N, :N] if ctx.has_init else None)


def _on_mesh(r, k, v, w, u, init):
    """The kernel on each shard: batch and heads split, or replicated; u
    [B * H, N] is taken as [B, H, N]."""
    mesh = sharded.mesh_of(r, k, v, w, u, init)
    lay = sharded.layout("rwkv6_scan", r, mesh, {0: "batch", 2: "heads"})
    B, _S, H, N = r.shape
    u3 = sharded.as_dtensor(u, mesh).reshape(B, H, N)
    args = tuple(sharded.placed("rwkv6_scan", t, mesh, lay, dims)
                 for t, dims in ((r, sharded.SAME4), (k, sharded.SAME4),
                                 (v, sharded.SAME4), (w, sharded.SAME4),
                                 (u3, sharded.BH), (init, sharded.BH)))

    def local(r, k, v, w, u3, init):
        return rwkv6_scan_kernel(
            r.contiguous(), k.contiguous(), v.contiguous(), w.contiguous(),
            u3.reshape(-1, u3.shape[-1]),
            None if init is None else init.contiguous())
    return sharded.run(local, mesh, args, lay, [sharded.SAME4, sharded.BH])


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
    if r.device.type == "meta":
        costs.book("rwkv6_scan", costs.rwkv_fwd(B, S, H, N,
                                                r.element_size()))
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
    if r.device.type == "meta":
        costs.book("rwkv6_scan_bwd", costs.rwkv_bwd(B, S, H, N, SAVE_EVERY))
        return dr, dk, dv, dw, du, dinit
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
