"""Chunked Mamba2 SSD scan: the CUDA kernel ``csrc/mamba2_scan.cu`` and its
plain PyTorch version.

Per batch row and head, over chunks of Q positions in order, with the
[N, P] state carried from chunk to chunk (from ``init`` or zeros):
dA = dt * A, cum its cumulative sum within the chunk, dtx = dt * x;
y = (C B^T * exp(segsum)) @ dtx + (C @ state) * exp(cum); then the state
update.  Besides y the kernel returns the final state, which the prefill
cache needs.  Layout: x [B, S, H, P], dt [B, S, H], A [B * H] (one decay
per batch row and head, negative), Bm/Cm [B, S, G, N] with head h in group
h // (H / G); y [B, S, H, P] in x's type, state [B, H, N, P] fp32.  The
Pallas layout ([BH, S, P], dt [BH, S], A [BH], Bm/Cm [BH, S, N]) is the
case H = G = 1.  A last chunk shorter than Q is padded with zeros, which
adds nothing.

``mamba2_scan_kernel`` launches the kernel for CUDA tensors and runs
``mamba2_scan_plain`` for CPU tensors; it never falls back from one to the
other.  In bf16 the kernel is three passes (chunk states, state passing,
chunk outputs; see the source's note), counted as one launch; ``plan``
sets their blocks and scratch.  fp32 runs one pass on the CUDA cores.
A launch takes N up to ``GROUP_N`` and P up to ``GROUP_P``; the wrapper
takes any chunk and runs one above ``chunk_cap`` as chunks of the cap
(``kernel_chunk``), which changes only the order of the sums.  That sits
outside ``Mamba2Scan``, so the backward runs at the kernel's chunk.

Any N and P run: the state h [N, P] is separable on both axes (column p
of h and y depends only on x[..., p]; row n of h only on B[n], and
y = sum_n C[n] h[n, :] sums over the rows), so ``_forward`` and
``mamba2_scan_backward`` cut a wider state into near-equal groups
(``split_plan``), a launch each: over column groups y, the final state
and dx are concatenated and dB, dC, ddt and dA summed; over row groups
y, dx, ddt and dA are summed and dB, dC and dinit concatenated.  The sums
are in fp32 and rounded to the input's type once: over column groups a
bf16 backward writes dB and dC in fp32; over row groups a bf16 forward
writes y in fp32 and the backward runs the fp32 design on the inputs'
exact fp32 values and the sum of the saved state's halves
(``fp32_design``), whose dx is fp32, both at that design's chunk.  A
wider state is the same
function at the same cost, booked once (``costs.mamba_fwd`` at the
caller's N and P); only the inputs a group re-reads (x and dy over row
groups, B, C over column groups) are extra bytes.

When a gradient is asked of CUDA tensors, the call goes through
``Mamba2Scan``, a ``torch.autograd.Function``: its forward launches the
same kernel and keeps the state entering each chunk (bf16: the passes'
hi and lo scratch; fp32: an output of the one-pass kernel), and its
backward launches ``csrc/mamba2_scan_bwd.cu`` (``mamba2_scan_backward``:
the state gradients at the chunk boundaries, then each chunk's
gradients; on the tensor cores with a tile of heads a block,
``bwd_plan``, in both types: fp32 inputs are split into bf16 hi and lo
planes first, ``split_planes``).  On the CPU autograd differentiates the
plain version, which is also the plain backward
(``mamba2_scan_backward_plain``).

Given DTensors (under a mesh), the wrapper runs on the local shards
(``kernels/sharded.py``): batch and heads may be split over the mesh,
the sequence and the state dims stay whole; the groups of Bm/Cm split as
the heads do, or stay whole when there is one group.  Given meta tensors,
the forward and the backward return empty outputs of the right shapes
and book their cost (``kernels/costs.py``) instead of running.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import costs, cuda_build, sharded

# launches of the CUDA kernel (not of the plain version) since the last
# reset, and of the backward (its kernels, once a call)
LAUNCHES = 0
BWD_LAUNCHES = 0

MAX_CHUNK = 128                  # the kernel's chunk (the wrapper's: any)
GROUP_N = 128                    # state rows N (d_state) a launch
GROUP_P = 64                     # state columns P (head dim) a launch
MAX_N_F32 = 64                   # fp32 runs chunks of 64 above this N
TILE_N = 64                      # state rows a group of the backward's warps
MAX_HEADS = 16                   # heads a block of passes (a) and (c)
WAVE_SHARE = 0.9                 # how full pass (c)'s last wave must be
SMEM_LIMIT = 232_448             # dynamic shared memory a block may take
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PER_SM = {}                     # (library, Q, N, P, dtype) -> blocks an SM


def pad16(n: int) -> int:
    """``n`` rounded up to the mma tile (16): the bf16 kernel pads Q, N and
    P so in shared memory, with zeros."""
    return -(-n // 16) * 16


def plan_heads(units: int, rep: int, sms: int, per_sm: int) -> int:
    """Heads a block of the bf16 passes (a) and (c) takes, of the ``rep``
    heads of a group, for ``units`` (batch row, chunk, group) triples on a
    card of ``sms`` SMs that holds ``per_sm`` blocks of pass (c) each: the
    most, up to ``MAX_HEADS``, that cut the group into equal tiles, give
    every block slot of the card a block and fill the last wave to
    ``WAVE_SHARE``; 1 (the most blocks) if none does.  Pass (c) computes
    C B^T once a block, so more heads a block share it."""
    slots = sms * max(per_sm, 1)
    for heads in range(min(rep, MAX_HEADS), 0, -1):
        tiles = -(-rep // heads)
        if -(-rep // tiles) != heads:
            continue                # a last tile short of the others
        blocks = units * tiles
        share = blocks / (-(-blocks // slots) * slots)
        if blocks >= slots and share >= WAVE_SHARE:
            return heads
    return 1


def smem_bytes(Q: int, N: int, P: int, heads: int):
    """(pass (a), pass (c)) dynamic shared memory of a bf16 block, as
    ``csrc/mamba2_scan.cu`` lays it out, bf16 rows padded by 8 elements.
    (a): B, two buffers of x, dt, cum and weights a head; (c): C, two
    buffers of x and s_prev's hi and lo (B over the second until C B^T is
    in registers), dt and cum a head."""
    Qp, Np, Pp = pad16(Q), pad16(N), pad16(P)
    a = 2 * (Qp * (Np + 8) + 2 * Qp * (Pp + 8)) + 4 * 3 * heads * Qp
    buf = Qp * (Pp + 8) + 2 * Np * (Pp + 8)
    c = 2 * (Qp * (Np + 8) + buf + max(buf, Qp * (Np + 8))) \
        + 4 * 2 * heads * Qp
    return a, c


def scratch_bytes(B: int, S: int, H: int, N: int, P: int, Q: int) -> dict:
    """The bf16 kernel's scratch, allocated by the wrapper: each chunk's own
    state S_loc [B, chunks, H, N, P] fp32, the state entering it s_prev as
    two bf16 halves (hi and the remainder lo) [B, chunks, H, 2, N, P], and
    each chunk's decay [B, chunks, H] fp32."""
    nc = -(-S // Q)
    return dict(s_loc=4 * B * nc * H * N * P, s_prev=4 * B * nc * H * N * P,
                dec=4 * B * nc * H)


def plan(B: int, S: int, H: int, G: int, N: int, P: int, Q: int,
         sms: int, per_sm: int) -> dict:
    """The bf16 launch at these shapes: chunks, heads a block, blocks of
    passes (a) and (c), the padded mma sizes, shared memory and scratch."""
    nc = -(-S // Q)
    heads = plan_heads(B * nc * G, H // G, sms, per_sm)
    return dict(chunks=nc, heads=heads,
                blocks=B * nc * G * -(-(H // G) // heads),
                padded=(pad16(Q), pad16(N), pad16(P)),
                smem=smem_bytes(Q, N, P, heads),
                scratch=scratch_bytes(B, S, H, N, P, Q))


def n_tiles(N: int) -> int:
    """Tiles of ``TILE_N`` state rows the backward's chunk kernels walk,
    a group of warps each."""
    return -(-N // TILE_N)


def bwd_threads(Q: int, N: int) -> int:
    """Threads a block of the backward's chunk kernels: 4 warps a tile of
    N, or 2 a tile with two tiles when the chunk has at most 4 row tiles
    of 16 (2 warps own them all)."""
    return 2 * 2 * 32 if n_tiles(N) > 1 and pad16(Q) <= 64 \
        else n_tiles(N) * 4 * 32


def bwd_smem_bytes(Q: int, N: int, P: int, heads: int, dtype):
    """(kernel (a), the chunk kernels) dynamic shared memory of a backward
    block, as ``csrc/mamba2_scan_bwd.cu`` lays it out, bf16 rows padded by
    8 elements, each input in R planes (2 for fp32's hi and lo).  (a) is
    the forward's pass (a) (``smem_bytes``) on R planes; (c1) and (c2)
    hold B or C, two buffers of x and dy, s_prev or dS as hi and lo, five
    fp32 vectors of Qp and four floats, and with two tiles of N (c2)'s
    exchange of d dtx [Qp][Pp] and two vectors of Qp."""
    R = 2 if dtype == torch.float32 else 1
    Qp, Np, Pp = pad16(Q), pad16(N), pad16(P)
    a = 2 * R * (Qp * (Np + 8) + 2 * Qp * (Pp + 8)) + 4 * 3 * heads * Qp
    c = 2 * (R * Qp * (Np + 8) + 4 * R * Qp * (Pp + 8) + 2 * Np * (Pp + 8)) \
        + 4 * (5 * Qp + 4)
    if n_tiles(N) > 1:
        c += 4 * (Qp * Pp + 2 * Qp)
    return a, c


def bwd_scratch_bytes(B: int, S: int, H: int, G: int, N: int, P: int,
                      Q: int, dtype, heads: int = 1) -> dict:
    """What the backward holds beside its inputs and gradients: the state
    entering each chunk from the forward (fp32, or bf16 hi and lo); the
    state gradient at each chunk's end ds [B, chunks, H, 2, N, P] as bf16
    hi and lo, from the chunks' own parts ds_loc, fp32, and the chunks'
    decays [B, chunks, H]; the parts of dB and dC [B, S, G tiles, N] of
    each tile of ``heads`` heads; W's row sums plus the inter term [B,
    chunks, H, N tiles, pad16(Q)]; the chunks' parts of dA [B, chunks,
    H]; in fp32 the inputs split into bf16 hi and lo planes (x, Bm, Cm,
    dy and the forward's states), as many bytes as they hold."""
    nc = -(-S // Q)
    state = 4 * B * nc * H * N * P
    tiles = -(-(H // G) // heads)
    out = dict(s_prev=state, ds=state, dec=4 * B * nc * H,
               dBC_part=2 * 4 * B * S * G * tiles * N, dA_part=4 * B * nc * H,
               ds_loc=state, rsi=4 * B * nc * H * n_tiles(N) * pad16(Q))
    if dtype == torch.float32:
        out["planes"] = 4 * (2 * B * S * H * P + 2 * B * S * G * N) + state
    return out


def bwd_plan(B: int, S: int, H: int, G: int, N: int, P: int, Q: int,
             sms: int, per_sm: int) -> dict:
    """The bf16 backward's launch at these shapes: heads a block of
    kernels (a), (c1) and (c2) (``plan_heads`` on the blocks of (c2) an
    SM holds), tiles of a group, blocks, threads, shared memory and
    scratch."""
    nc = -(-S // Q)
    heads = plan_heads(B * nc * G, H // G, sms, per_sm)
    tiles = -(-(H // G) // heads)
    return dict(chunks=nc, heads=heads, tiles=tiles, blocks=B * nc * G * tiles,
                threads=bwd_threads(Q, N),
                smem=bwd_smem_bytes(Q, N, P, heads, torch.bfloat16),
                scratch=bwd_scratch_bytes(B, S, H, G, N, P, Q, torch.bfloat16,
                                          heads))


def mamba2_scan_plain(x, dt, A, Bm, Cm, Q: int, init=None):
    """The chunked SSD scan in plain PyTorch (fp32; fp64 for a float64 x),
    the chunks vectorised and the state carried over them in a loop.
    Returns (y in x's type, final state [B, H, N, P] in the working
    type)."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    pad = (-S) % Q
    work = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf, dtf, Bf, Cf = (t.to(work) for t in (x, dt, Bm, Cm))
    if pad:
        xf, Bf, Cf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, Bf, Cf))
        dtf = F.pad(dtf, (0, 0, 0, pad))
    nc = (S + pad) // Q
    x_ = xf.reshape(B_, nc, Q, G, rep, P)
    dt_ = dtf.reshape(B_, nc, Q, G, rep)
    B_m = Bf.reshape(B_, nc, Q, G, N)
    C_m = Cf.reshape(B_, nc, Q, G, N)
    A_ = A.to(work).reshape(B_, 1, 1, G, rep)

    cum = torch.cumsum(dt_ * A_, dim=2)                     # [B,nc,Q,G,rep]
    dtx = dt_[..., None] * x_                               # [B,nc,Q,G,rep,P]
    CB = torch.einsum("bcign,bcjgn->bcgij", C_m, B_m)       # [B,nc,G,Q,Q]
    diff = cum[:, :, :, None] - cum[:, :, None, :]          # [B,nc,Q,Q,G,rep]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(tri[:, :, None, None], diff,
                                  float("-inf")))
    M = CB.permute(0, 1, 3, 4, 2)[..., None] * decay        # [B,nc,Q,Q,G,rep]
    y_intra = torch.einsum("bcijgr,bcjgrp->bcigrp", M, dtx)

    dec_end = torch.exp(cum[:, :, -1:] - cum)               # [B,nc,Q,G,rep]
    S_loc = torch.einsum("bcjgrp,bcjgn->bcgrnp", dec_end[..., None] * dtx,
                         B_m)                               # [B,nc,G,rep,N,P]
    chunk_dec = torch.exp(cum[:, :, -1])                    # [B,nc,G,rep]
    s = torch.zeros((B_, G, rep, N, P), dtype=work,
                    device=x.device) if init is None \
        else init.to(work).reshape(B_, G, rep, N, P)
    prevs = []
    for c in range(nc):
        prevs.append(s)
        s = s * chunk_dec[:, c, ..., None, None] + S_loc[:, c]
    s_prev = torch.stack(prevs, dim=1)                      # [B,nc,G,rep,N,P]
    y_inter = torch.einsum("bcign,bcgrnp->bcigrp", C_m, s_prev) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B_, S + pad, H, P)[:, :S]
    return y.to(x.dtype), s.reshape(B_, H, N, P)


def mamba2_scan_backward_plain(x, dt, A, Bm, Cm, Q: int, init, dy,
                               dstate=None):
    """(dx, ddt, dA, dB, dC, dinit): autograd through ``mamba2_scan_plain``
    for the gradients ``dy`` of y and ``dstate`` (or none) of the final
    state, each in its input's type; dinit is fp32, the gradient of a zero
    initial state when ``init`` is None."""
    B_, S, H, P = x.shape
    N = Bm.shape[3]
    if init is None:
        init = torch.zeros((B_, H, N, P), dtype=torch.float32,
                           device=x.device)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (x, dt, A, Bm, Cm, init)]
        y, st = mamba2_scan_plain(*leaves[:5], Q, leaves[5])
        outs, grads = [y], [dy]
        if dstate is not None:
            outs.append(st)
            grads.append(dstate)
        return torch.autograd.grad(outs, leaves, grads)


def _check(x, dt, A, Bm, Cm, Q: int, init) -> None:
    tensors = [x, dt, A, Bm, Cm] + ([] if init is None else [init])
    if any(t.device != x.device for t in tensors):
        raise ValueError("mamba2_scan: all tensors must be on one device")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"mamba2_scan: no kernel for device {x.device}")
    B_, S, H, P = x.shape if x.dim() == 4 else (0, 0, 0, 0)
    if x.dim() != 4 or dt.shape != (B_, S, H) or A.shape != (B_ * H,) \
            or Bm.dim() != 4 or Bm.shape[:2] != (B_, S) \
            or Cm.shape != Bm.shape or Bm.shape[2] == 0 or H % Bm.shape[2] \
            or (init is not None
                and init.shape != (B_, H, Bm.shape[3], P)) or Q < 1:
        raise ValueError("mamba2_scan: shapes x [B, S, H, P], dt [B, S, H], "
                         "A [B * H], Bm/Cm [B, S, G, N] (H a multiple of G), "
                         "init [B, H, N, P] and a chunk >= 1 expected")


def card_slots(Q: int, N: int, P: int, device, lib: str = "mamba2_scan",
               dtype=torch.bfloat16):
    """(SMs of the card, blocks an SM holds at these sizes), as the library
    reports them (asked once a size): of the forward's pass (c) for
    ``lib`` "mamba2_scan", of the backward's kernel (c2) in ``dtype`` for
    "mamba2_scan_bwd"."""
    key = (lib, Q, N, P, dtype)
    if key not in _PER_SM:
        fn = getattr(cuda_build.load(lib), f"{lib}_blocks_per_sm")
        fn.restype = ctypes.c_int
        n = ctypes.c_int(0)
        if lib == "mamba2_scan_bwd":
            fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
            err = fn(Q, N, P, int(dtype == torch.float32), ctypes.byref(n))
        else:
            fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
            err = fn(Q, N, P, ctypes.byref(n))
        cuda_build.check(err, f"{lib} blocks per SM")
        _PER_SM[key] = n.value
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms, _PER_SM[key]


def bwd_heads(x, Bm, Q: int) -> int:
    """Heads a block of the backward's tensor-core kernels take."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-S // Q)
    return plan_heads(B_ * nc * G, H // G,
                      *card_slots(Q, N, P, x.device, "mamba2_scan_bwd",
                                  x.dtype))


def groups(n: int, cap: int) -> list:
    """[(start, stop)]: ``n`` cut into the fewest near-equal groups of at
    most ``cap`` (the first ``n % groups`` one longer)."""
    if n < 1:
        raise ValueError(f"mamba2_scan: a state size >= 1, not {n}")
    k = -(-n // cap)
    base, extra = divmod(n, k)
    out, at = [], 0
    for i in range(k):
        size = base + (i < extra)
        out.append((at, at + size))
        at += size
    return out


def split_plan(N: int, P: int):
    """(row groups, column groups) of a state [N, P]: each (row group,
    column group) pair is one launch of the kernel."""
    return groups(N, GROUP_N), groups(P, GROUP_P)


def group_n(N: int) -> int:
    """The state rows of the widest row group a launch takes."""
    return max(b - a for a, b in groups(N, GROUP_N))


def fp32_design(N: int, dtype) -> bool:
    """Whether the scan's backward at state size N in ``dtype`` runs the
    fp32 design: for fp32, and for bf16 past one row group (N >
    ``GROUP_N``), whose dx is a sum over the groups, which the fp32
    design gives in fp32 from the bf16 inputs' exact fp32 values.  The
    chunk follows it (``chunk_cap``), in the forward too."""
    return dtype == torch.float32 or N > GROUP_N


def chunk_cap(N: int, dtype) -> int:
    """The largest chunk the kernel runs at state size N in ``dtype``:
    ``MAX_CHUNK``, or 64 on the fp32 design when a row group passes
    ``MAX_N_F32`` (whose shared memory at chunk 128 and N 128 would pass
    the card's)."""
    return 64 if fp32_design(N, dtype) and group_n(N) > MAX_N_F32 \
        else MAX_CHUNK


def kernel_chunk(Q: int, N: int, dtype) -> int:
    """The chunk the kernel runs for a caller's chunk ``Q``: Q itself up to
    ``chunk_cap``, else the cap.  The scan's output and final state do not
    depend on the chunk, only the order of its sums does, and a last
    chunk padded with zeros adds nothing, so any chunk computes the
    caller's function."""
    return min(Q, chunk_cap(N, dtype))


def kernel_limits(x, Bm, Cm, Q: int) -> None:
    """Raise on what the CUDA kernel does not take: a type other than fp32
    or bf16 (x, Bm and Cm alike) or a chunk above ``chunk_cap`` (the
    wrapper passes ``kernel_chunk``).  Every N and P runs, a wide state
    as groups (``split_plan``)."""
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"mamba2_scan: no kernel for x {x.dtype}, Bm/Cm "
                        f"{Bm.dtype}/{Cm.dtype}")
    N = Bm.shape[3]
    if Q > chunk_cap(N, x.dtype):
        raise ValueError(f"mamba2_scan: the kernel takes a chunk <= "
                         f"{chunk_cap(N, x.dtype)} at N {N}, not {Q}")


def mamba2_scan_kernel(x, dt, A, Bm, Cm, Q: int, init=None):
    """Returns (y [B, S, H, P] in x's type, final state [B, H, N, P]
    fp32), differentiable (through ``Mamba2Scan`` on the card)."""
    if sharded.any_dtensor(x, dt, A, Bm, Cm, init):
        return _on_mesh(x, dt, A, Bm, Cm, Q, init)
    _check(x, dt, A, Bm, Cm, Q, init)
    if x.device.type == "cpu":
        return mamba2_scan_plain(x, dt, A, Bm, Cm, Q, init)
    dt = dt.float().contiguous()
    A = A.float().contiguous()
    if init is not None:
        init = init.float().contiguous()
    Q = kernel_chunk(Q, Bm.shape[3], x.dtype)
    kernel_limits(x, Bm, Cm, Q)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, init)):
        return Mamba2Scan.apply(x, dt, A, Bm, Cm, Q, init)
    return _forward(x, dt, A, Bm, Cm, Q, init, False)[:2]


def _on_mesh(x, dt, A, Bm, Cm, Q: int, init):
    """The kernel on each shard: batch and heads split, or replicated; A
    [B * H] is taken as [B, H]."""
    mesh = sharded.mesh_of(x, dt, A, Bm, Cm, init)
    lay = sharded.layout("mamba2_scan", x, mesh, {0: "batch", 2: "heads"})
    B_, _S, H, _P = x.shape
    groups = {0: 0, 2: 2 if Bm.shape[2] > 1 else None}
    A2 = sharded.as_dtensor(A, mesh).reshape(B_, H)
    args = tuple(sharded.placed("mamba2_scan", t, mesh, lay, dims)
                 for t, dims in ((x, sharded.SAME4), (dt, sharded.SAME4),
                                 (A2, {0: 0, 2: 1}), (Bm, groups),
                                 (Cm, groups), (init, sharded.BH)))

    def local(x, dt, A2, Bm, Cm, init):
        return mamba2_scan_kernel(
            x.contiguous(), dt.contiguous(), A2.reshape(-1),
            Bm.contiguous(), Cm.contiguous(), Q,
            None if init is None else init.contiguous())
    return sharded.run(local, mesh, args, lay, [sharded.SAME4, sharded.BH])


def _forward(x, dt, A, Bm, Cm, Q: int, init, with_states: bool):
    """The kernel's (y, final state, the state entering each chunk or
    None): fp32 [B, chunks, H, N, P], or bf16 hi and lo [B, chunks, H, 2,
    N, P] (the bf16 passes' own scratch, kept).  dt, A and init fp32.  A
    state past one launch runs as the groups of ``split_plan``."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    kernel_limits(x, Bm, Cm, Q)
    if not (x.is_contiguous() and Bm.is_contiguous() and Cm.is_contiguous()):
        raise ValueError("mamba2_scan: tensors must be contiguous")
    nc = -(-S // Q)
    if x.device.type == "meta":
        costs.book("mamba2_scan", costs.mamba_fwd(B_, S, H, G, N, P, Q,
                                                  x.element_size()))
        return (torch.empty_like(x),
                torch.empty((B_, H, N, P), dtype=torch.float32,
                            device="meta"),
                torch.empty((B_, nc, H, N, P), dtype=torch.float32,
                            device="meta") if with_states else None)
    rows, cols = split_plan(N, P)
    if len(rows) * len(cols) == 1:
        return _launch(x, dt, A, Bm, Cm, Q, init, with_states)
    summed = len(rows) > 1           # y a sum over row groups, in fp32
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device) \
        if summed else torch.empty_like(x)
    state = torch.empty((B_, H, N, P), dtype=torch.float32, device=x.device)
    s_prev = None
    for n0, n1 in rows:
        Bg, Cg = (_cols(t, n0, n1, N) for t in (Bm, Cm))
        for p0, p1 in cols:
            yg, sg, spg = _launch(
                _cols(x, p0, p1, P), dt, A, Bg, Cg, Q,
                None if init is None else init[:, :, n0:n1, p0:p1]
                .contiguous(), with_states, y_f32=summed)
            if summed:
                y[..., p0:p1] += yg
            else:
                y[..., p0:p1] = yg
            state[:, :, n0:n1, p0:p1] = sg
            if with_states:
                if s_prev is None:
                    s_prev = spg.new_empty((*spg.shape[:-2], N, P))
                s_prev[..., n0:n1, p0:p1] = spg
    return y.to(x.dtype), state, s_prev


def _cols(t, a: int, b: int, width: int):
    """The last dim's columns [a, b) of ``t``, contiguous (``t`` itself
    when they are all of them)."""
    return t if (a, b) == (0, width) else t[..., a:b].contiguous()


def _launch(x, dt, A, Bm, Cm, Q: int, init, with_states: bool,
            y_f32: bool = False):
    """One launch of the kernel on a state of at most ``GROUP_N`` rows
    and ``GROUP_P`` columns: ``_forward``'s outputs, y in fp32 with
    ``y_f32``."""
    global LAUNCHES
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device) \
        if y_f32 else torch.empty_like(x)
    state = torch.empty((B_, H, N, P), dtype=torch.float32, device=x.device)
    bf16 = x.dtype == torch.bfloat16
    nc = -(-S // Q)
    heads, scratch = 0, (None, None, None)
    if bf16:
        pl = plan(B_, S, H, G, N, P, Q, *card_slots(Q, N, P, x.device))
        heads = pl["heads"]
        scratch = (torch.empty((B_, nc, H, N, P), dtype=torch.float32,
                               device=x.device),
                   torch.empty((B_, nc, H, 2, N, P), dtype=torch.bfloat16,
                               device=x.device),
                   torch.empty((B_, nc, H), dtype=torch.float32,
                               device=x.device))
    elif with_states:
        scratch = (None, torch.empty((B_, nc, H, N, P), dtype=torch.float32,
                                     device=x.device), None)
    s_prev = scratch[1] if with_states else None
    if B_ * H == 0:
        return y, state, s_prev
    fn = cuda_build.load("mamba2_scan").mamba2_scan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
             Cm.data_ptr(), 0 if init is None else init.data_ptr(),
             y.data_ptr(), state.data_ptr(),
             *(0 if t is None else t.data_ptr() for t in scratch),
             B_, S, H, G, N, P, Q, heads, int(bf16), int(y_f32 and bf16),
             cuda_build.stream_ptr(x.device))
    cuda_build.check(err, "mamba2_scan")
    LAUNCHES += 1
    return y, state, s_prev


def _bwd_check(x, dt, A, Bm, Cm, Q: int, dy, dstate) -> None:
    B_, S, H, P = x.shape
    N = Bm.shape[3]
    kernel_limits(x, Bm, Cm, Q)
    if any(not t.is_contiguous() for t in (x, dt, A, Bm, Cm, dy)) \
            or dt.dtype != torch.float32 or A.dtype != torch.float32 \
            or dy.shape != x.shape or dy.dtype != x.dtype \
            or (dstate is not None
                and (dstate.shape != (B_, H, N, P)
                     or dstate.dtype != torch.float32
                     or not dstate.is_contiguous())):
        raise ValueError("mamba2_scan_backward: contiguous inputs, fp32 dt "
                         "and A, dy [B, S, H, P] in x's type and fp32 "
                         "dstate [B, H, N, P] expected")


def split_planes(t, rows: int):
    """An fp32 tensor of ``rows`` rows as the backward's split input: bf16
    [rows, 2, width], each value's bf16 rounding hi and the rounding of the
    rest lo (``csrc/mamba2_scan_bwd.cu``'s ``mamba2_scan_bwd_split``); a
    bf16 tensor as it is."""
    if t.dtype == torch.bfloat16:
        return t
    width = t.numel() // rows if rows else 0
    out = torch.empty((rows, 2, width), dtype=torch.bfloat16,
                      device=t.device)
    fn = cuda_build.load("mamba2_scan_bwd").mamba2_scan_bwd_split
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    cuda_build.check(fn(t.data_ptr(), out.data_ptr(), rows, width,
                        cuda_build.stream_ptr(t.device)),
                     "mamba2_scan_bwd_split")
    return out


def backward_dstates(x, dt, A, Cm, Q: int, dy, dstate, heads: int):
    """Kernels (a) and (b) of the backward, ``heads`` heads a block
    (``bwd_heads``): the gradient of the state leaving each chunk as bf16
    hi and lo halves, ds [B, chunks, H, 2, N, P], and dinit [B, H, N, P]
    fp32.  Not counted: ``mamba2_scan_backward`` is the entry point."""
    B_, S, H, P = x.shape
    G, N = Cm.shape[2], Cm.shape[3]
    nc = -(-S // Q)
    f32 = x.dtype == torch.float32
    Cm2, dy2 = split_planes(Cm, B_ * S * G), split_planes(dy, B_ * S * H)
    ds = torch.empty((B_, nc, H, 2, N, P), dtype=torch.bfloat16,
                     device=x.device)
    ds_loc = torch.empty((B_, nc, H, N, P), dtype=torch.float32,
                         device=x.device)
    dec = torch.empty((B_, nc, H), dtype=torch.float32, device=x.device)
    dinit = torch.empty((B_, H, N, P), dtype=torch.float32, device=x.device)
    fn = cuda_build.load("mamba2_scan_bwd").mamba2_scan_bwd_dstates
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(dt.data_ptr(), A.data_ptr(), Cm2.data_ptr(), dy2.data_ptr(),
             0 if dstate is None else dstate.data_ptr(), ds.data_ptr(),
             ds_loc.data_ptr(), dec.data_ptr(), dinit.data_ptr(), B_, S, H,
             G, N, P, Q, heads, int(f32), cuda_build.stream_ptr(x.device))
    cuda_build.check(err, "mamba2_scan_bwd_dstates")
    return ds, dinit


def backward_from_dstates(x, dt, A, Bm, Cm, Q: int, s_prev, dy, ds,
                          heads: int, out_f32: bool = False):
    """The chunk kernels and (d) of the backward, ``heads`` heads a block:
    (dx, ddt, dA, dB, dC) from the forward's ``s_prev`` (fp32 [B, chunks,
    H, N, P], or bf16 hi and lo [B, chunks, H, 2, N, P]) and the state
    gradients ``ds`` at the chunks' ends; a bf16 launch's dB and dC in
    fp32 with ``out_f32``.  Not counted: ``mamba2_scan_backward`` is the
    entry point."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-S // Q)
    f32 = x.dtype == torch.float32
    halves = (B_, nc, H, 2, N, P)
    want = (B_, nc, H, N, P) if f32 else halves
    if s_prev.shape != want or s_prev.dtype != x.dtype \
            or ds.shape != halves or ds.dtype != torch.bfloat16:
        raise ValueError(f"mamba2_scan_backward: s_prev {want} in x's type "
                         f"and ds {halves} bf16 expected")
    x2, Bm2, Cm2, dy2, sp2 = (
        split_planes(t, n) for t, n in (
            (x, B_ * S * H), (Bm, B_ * S * G), (Cm, B_ * S * G),
            (dy, B_ * S * H), (s_prev, B_ * nc * H)))
    out = torch.float32 if out_f32 else x.dtype
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    dB, dC = (torch.empty(t.shape, dtype=out, device=x.device)
              for t in (Bm, Cm))
    tiles = -(-(H // G) // heads)
    parts = [torch.empty((B_, S, G * tiles, N), dtype=torch.float32,
                         device=x.device) for _ in range(2)]
    dA_part = torch.empty((B_, nc, H), dtype=torch.float32, device=x.device)
    rsi = torch.empty((B_, nc, H, n_tiles(N), pad16(Q)), dtype=torch.float32,
                      device=x.device)
    fn = cuda_build.load("mamba2_scan_bwd").mamba2_scan_bwd_chunks
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(x2.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm2.data_ptr(),
             Cm2.data_ptr(), dy2.data_ptr(), sp2.data_ptr(), ds.data_ptr(),
             dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
             dC.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
             dA_part.data_ptr(), rsi.data_ptr(), B_, S, H, G, N, P, Q, heads,
             int(f32), int(out_f32 and not f32),
             cuda_build.stream_ptr(x.device))
    cuda_build.check(err, "mamba2_scan_bwd_chunks")
    return dx, ddt, dA, dB, dC


def mamba2_scan_backward(x, dt, A, Bm, Cm, Q: int, s_prev, dy, dstate=None):
    """(dx, ddt, dA, dB, dC, dinit) of the scan for the gradients ``dy`` of
    y and ``dstate`` (or none) of the final state, from the forward's
    ``s_prev``: the backward's kernels, counted once a group of
    ``split_plan``, the groups' parts summed in fp32."""
    global BWD_LAUNCHES
    _bwd_check(x, dt, A, Bm, Cm, Q, dy, dstate)
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if x.device.type == "meta":
        costs.book("mamba2_scan_bwd", costs.mamba_bwd(B_, S, H, G, N, P, Q,
                                                      x.element_size()))
        return (*(torch.empty_like(t) for t in (x, dt, A, Bm, Cm)),
                torch.empty((B_, H, N, P), dtype=torch.float32,
                            device="meta"))
    rows, cols = split_plan(N, P)
    if len(rows) * len(cols) == 1:
        heads = bwd_heads(x, Bm, Q)
        ds, dinit = backward_dstates(x, dt, A, Cm, Q, dy, dstate, heads)
        grads = backward_from_dstates(x, dt, A, Bm, Cm, Q, s_prev, dy, ds,
                                      heads)
        BWD_LAUNCHES += 1
        return (*grads, dinit)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, dB, dC = (torch.zeros(t.shape, **f32) for t in (x, Bm, Cm))
    ddt, dA = torch.zeros_like(dt), torch.zeros_like(A)
    dinit = torch.empty((B_, H, N, P), **f32)
    # past one row group the backward runs the fp32 design
    # (``fp32_design``) on the inputs' exact fp32 values and on the bf16
    # forward's saved state as the fp32 sum of its halves
    xw, Bw, Cw, dyw = (x, Bm, Cm, dy)
    if len(rows) > 1 and x.dtype == torch.bfloat16:
        xw, Bw, Cw, dyw = (t.float() for t in (x, Bm, Cm, dy))
        s_prev = s_prev[:, :, :, 0].float() + s_prev[:, :, :, 1].float()
    for n0, n1 in rows:
        Bg, Cg = (_cols(t, n0, n1, N) for t in (Bw, Cw))
        for p0, p1 in cols:
            xg, dyg = (_cols(t, p0, p1, P) for t in (xw, dyw))
            spg = s_prev[..., n0:n1, p0:p1].contiguous()
            dsg = None if dstate is None \
                else dstate[:, :, n0:n1, p0:p1].contiguous()
            heads = bwd_heads(xg, Bg, Q)
            ds, dig = backward_dstates(xg, dt, A, Cg, Q, dyg, dsg, heads)
            gx, gdt, gA, gB, gC = backward_from_dstates(
                xg, dt, A, Bg, Cg, Q, spg, dyg, ds, heads, out_f32=True)
            BWD_LAUNCHES += 1
            dx[..., p0:p1] += gx
            ddt += gdt
            dA += gA
            dB[..., n0:n1] += gB
            dC[..., n0:n1] += gC
            dinit[:, :, n0:n1, p0:p1] = dig
    return (dx.to(x.dtype), ddt, dA, dB.to(x.dtype), dC.to(x.dtype), dinit)


class Mamba2Scan(torch.autograd.Function):
    """The scan with its backward kernels, for CUDA tensors; on CPU tensors
    the plain version and the plain backward."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, Q, init):
        if x.device.type == "cpu":
            (y, state), s_prev = mamba2_scan_plain(x, dt, A, Bm, Cm, Q,
                                                   init), None
        else:
            y, state, s_prev = _forward(x, dt, A, Bm, Cm, Q, init, True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init, s_prev)
        ctx.Q = Q
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm, init, s_prev = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype) \
            .contiguous()
        if dstate is not None:
            dstate = dstate.float().contiguous()
        if x.device.type == "cpu":
            grads = mamba2_scan_backward_plain(x, dt, A, Bm, Cm, ctx.Q, init,
                                               dy, dstate)
        else:
            grads = mamba2_scan_backward(x, dt, A, Bm, Cm, ctx.Q, s_prev, dy,
                                         dstate)
        return (*grads[:5], None, None if init is None else grads[5])


def kernel_smem_bytes(Q: int, N: int, P: int, heads: int):
    """(pass (a), pass (c)) shared memory of a bf16 block as the CUDA
    source computes it (for the card's checks against ``smem_bytes``)."""
    fn = cuda_build.load("mamba2_scan").mamba2_scan_smem_bytes
    return fn(Q, N, P, heads, 0), fn(Q, N, P, heads, 1)


def kernel_bwd_smem_bytes(Q: int, N: int, P: int, heads: int, dtype):
    """(kernel (a), the chunk kernels) shared memory of a backward block as
    the CUDA source computes it (for the card's checks against
    ``bwd_smem_bytes``)."""
    fn = cuda_build.load("mamba2_scan_bwd").mamba2_scan_bwd_smem_bytes
    f32 = int(dtype == torch.float32)
    return fn(Q, N, P, heads, f32, 0), fn(Q, N, P, heads, f32, 1)


def kernel_bwd_threads(Q: int, N: int) -> int:
    """Threads a block of the backward's chunk kernels as the CUDA source
    computes them (for the card's checks against ``bwd_threads``)."""
    return cuda_build.load("mamba2_scan_bwd").mamba2_scan_bwd_threads(Q, N)
