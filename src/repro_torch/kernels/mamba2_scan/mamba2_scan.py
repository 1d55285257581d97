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

When a gradient is asked of CUDA tensors, the call goes through
``Mamba2Scan``, a ``torch.autograd.Function``: its forward launches the
same kernel and keeps the state entering each chunk (bf16: the passes'
hi and lo scratch; fp32: an output of the one-pass kernel), and its
backward launches ``csrc/mamba2_scan_bwd.cu`` (``mamba2_scan_backward``:
the state gradients at the chunk boundaries, then each chunk's
gradients; in bf16 on the tensor cores with a tile of heads a block,
``bwd_plan``).  On the CPU autograd differentiates the plain version, which
is also the plain backward (``mamba2_scan_backward_plain``).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda_build

# launches of the CUDA kernel (not of the plain version) since the last
# reset, and of the backward (its kernels, once a call)
LAUNCHES = 0
BWD_LAUNCHES = 0

MAX_CHUNK = 128
MAX_NP = 64
MAX_HEADS = 16                   # heads a block of passes (a) and (c)
WAVE_SHARE = 0.9                 # how full pass (c)'s last wave must be
SMEM_LIMIT = 232_448             # dynamic shared memory a block may take
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PER_SM = {}                     # (library, Q, N, P) -> blocks an SM


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


def bwd_smem_bytes(Q: int, N: int, P: int, heads: int, dtype):
    """(kernel (a), the chunk kernels) dynamic shared memory of a backward
    block, as ``csrc/mamba2_scan_bwd.cu`` lays it out.  bf16 (a) is the
    forward's pass (a) (``smem_bytes``); (c1) and (c2) hold B or C, two
    buffers of x and dy, s_prev or dS as hi and lo, bf16 rows padded by 8
    elements, and five fp32 vectors of Qp and four floats.  fp32, all
    fp32: (a) exp(cum) C [Q][N], dy [Q][P], dt and cum; (c) B and C
    [Q][N + 1], dtx and dy [Q][P + 1], the state gradient (then s_prev)
    [N][P + 1], M [Q][Q + 1] and 16 vectors of Q."""
    if dtype == torch.bfloat16:
        Qp, Np, Pp = pad16(Q), pad16(N), pad16(P)
        return (smem_bytes(Q, N, P, heads)[0],
                2 * (Qp * (Np + 8) + 4 * Qp * (Pp + 8) + 2 * Np * (Pp + 8))
                + 4 * (5 * Qp + 4))
    return (4 * (Q * N + Q * P + 2 * Q),
            4 * (2 * Q * (N + 1) + 2 * Q * (P + 1) + N * (P + 1)
                 + Q * (Q + 1) + 16 * Q))


def bwd_scratch_bytes(B: int, S: int, H: int, G: int, N: int, P: int,
                      Q: int, dtype, heads: int = 1) -> dict:
    """What the backward holds beside its inputs and gradients, all fp32
    but the bf16 hi and lo halves: the state entering each chunk from the
    forward (fp32, or hi and lo); the state gradient at each chunk's end
    ds [B, chunks, H, N, P] (fp32; bf16: hi and lo, from the chunks' own
    parts ds_loc, fp32) and the chunks' decays [B, chunks, H]; the parts
    of dB and dC [B, S, G tiles, N] of each tile of ``heads`` heads (fp32:
    a head a tile); W's row sums plus the inter term [B, chunks, H,
    pad16(Q)] (bf16 only); the chunks' parts of dA [B, chunks, H]."""
    nc = -(-S // Q)
    state = 4 * B * nc * H * N * P
    tiles = -(-(H // G) // heads)
    out = dict(s_prev=state, ds=state, dec=4 * B * nc * H,
               dBC_part=2 * 4 * B * S * G * tiles * N, dA_part=4 * B * nc * H)
    if dtype == torch.bfloat16:
        out.update(ds_loc=state, rsi=4 * B * nc * H * pad16(Q))
    return out


def bwd_plan(B: int, S: int, H: int, G: int, N: int, P: int, Q: int,
             sms: int, per_sm: int) -> dict:
    """The bf16 backward's launch at these shapes: heads a block of
    kernels (a), (c1) and (c2) (``plan_heads`` on the blocks of (c2) an
    SM holds), tiles of a group, blocks, shared memory and scratch."""
    nc = -(-S // Q)
    heads = plan_heads(B * nc * G, H // G, sms, per_sm)
    tiles = -(-(H // G) // heads)
    return dict(chunks=nc, heads=heads, tiles=tiles, blocks=B * nc * G * tiles,
                smem=bwd_smem_bytes(Q, N, P, heads, torch.bfloat16),
                scratch=bwd_scratch_bytes(B, S, H, G, N, P, Q, torch.bfloat16,
                                          heads))


def mamba2_scan_plain(x, dt, A, Bm, Cm, Q: int, init=None):
    """The chunked SSD scan in plain PyTorch (fp32), the chunks vectorised
    and the state carried over them in a loop.  Returns (y in x's type,
    final state [B, H, N, P] fp32)."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    pad = (-S) % Q
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), Cm.float()
    if pad:
        xf, Bf, Cf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, Bf, Cf))
        dtf = F.pad(dtf, (0, 0, 0, pad))
    nc = (S + pad) // Q
    x_ = xf.reshape(B_, nc, Q, G, rep, P)
    dt_ = dtf.reshape(B_, nc, Q, G, rep)
    B_m = Bf.reshape(B_, nc, Q, G, N)
    C_m = Cf.reshape(B_, nc, Q, G, N)
    A_ = A.float().reshape(B_, 1, 1, G, rep)

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
    s = torch.zeros((B_, G, rep, N, P), dtype=torch.float32,
                    device=x.device) if init is None \
        else init.float().reshape(B_, G, rep, N, P)
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
    if x.device.type not in ("cpu", "cuda"):
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


def card_slots(Q: int, N: int, P: int, device, lib: str = "mamba2_scan"):
    """(SMs of the card, blocks an SM holds at these sizes), as the library
    reports them (asked once a size): of the forward's pass (c) for
    ``lib`` "mamba2_scan", of the backward's kernel (c2) for
    "mamba2_scan_bwd"."""
    key = (lib, Q, N, P)
    if key not in _PER_SM:
        fn = getattr(cuda_build.load(lib), f"{lib}_blocks_per_sm")
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        n = ctypes.c_int(0)
        cuda_build.check(fn(Q, N, P, ctypes.byref(n)),
                         f"{lib} blocks per SM")
        _PER_SM[key] = n.value
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms, _PER_SM[key]


def bwd_heads(x, Bm, Q: int) -> int:
    """Heads a block of the backward's tensor-core kernels take (bf16), 1
    for fp32 (a block a head)."""
    if x.dtype != torch.bfloat16:
        return 1
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-S // Q)
    return plan_heads(B_ * nc * G, H // G,
                      *card_slots(Q, N, P, x.device, "mamba2_scan_bwd"))


def kernel_limits(x, Bm, Cm, Q: int) -> None:
    """Raise on what the CUDA kernel does not take: a type other than fp32
    or bf16 (x, Bm and Cm alike), a chunk above ``MAX_CHUNK`` or N, P above
    ``MAX_NP``."""
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"mamba2_scan: no kernel for x {x.dtype}, Bm/Cm "
                        f"{Bm.dtype}/{Cm.dtype}")
    N, P = Bm.shape[3], x.shape[3]
    if Q > MAX_CHUNK or N > MAX_NP or P > MAX_NP:
        raise ValueError(f"mamba2_scan: the kernel takes chunk <= "
                         f"{MAX_CHUNK} and N, P <= {MAX_NP}, not {Q}, {N}, "
                         f"{P}")


def mamba2_scan_kernel(x, dt, A, Bm, Cm, Q: int, init=None):
    """Returns (y [B, S, H, P] in x's type, final state [B, H, N, P]
    fp32), differentiable (through ``Mamba2Scan`` on the card)."""
    _check(x, dt, A, Bm, Cm, Q, init)
    if x.device.type == "cpu":
        return mamba2_scan_plain(x, dt, A, Bm, Cm, Q, init)
    dt = dt.float().contiguous()
    A = A.float().contiguous()
    if init is not None:
        init = init.float().contiguous()
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, init)):
        return Mamba2Scan.apply(x, dt, A, Bm, Cm, Q, init)
    return _forward(x, dt, A, Bm, Cm, Q, init, False)[:2]


def _forward(x, dt, A, Bm, Cm, Q: int, init, with_states: bool):
    """The kernel's (y, final state, the state entering each chunk or
    None): fp32 [B, chunks, H, N, P], or bf16 hi and lo [B, chunks, H, 2,
    N, P] (the bf16 passes' own scratch, kept).  dt, A and init fp32."""
    global LAUNCHES
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    kernel_limits(x, Bm, Cm, Q)
    if not (x.is_contiguous() and Bm.is_contiguous() and Cm.is_contiguous()):
        raise ValueError("mamba2_scan: tensors must be contiguous")
    y = torch.empty_like(x)
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
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
             Cm.data_ptr(), 0 if init is None else init.data_ptr(),
             y.data_ptr(), state.data_ptr(),
             *(0 if t is None else t.data_ptr() for t in scratch),
             B_, S, H, G, N, P, Q, heads, int(bf16),
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


def backward_dstates(x, dt, A, Cm, Q: int, dy, dstate, heads: int):
    """Kernels (a) and (b) of the backward, ``heads`` heads a block
    (``bwd_heads``): the gradient of the state leaving each chunk, ds [B,
    chunks, H, N, P] fp32 (bf16: its hi and lo halves [B, chunks, H, 2,
    N, P]), and dinit [B, H, N, P] fp32.  Not counted:
    ``mamba2_scan_backward`` is the entry point."""
    B_, S, H, P = x.shape
    G, N = Cm.shape[2], Cm.shape[3]
    nc = -(-S // Q)
    bf16 = x.dtype == torch.bfloat16
    ds = torch.empty((B_, nc, H, 2, N, P) if bf16 else (B_, nc, H, N, P),
                     dtype=x.dtype, device=x.device)
    ds_loc = torch.empty((B_, nc, H, N, P), dtype=torch.float32,
                         device=x.device) if bf16 else None
    dec = torch.empty((B_, nc, H), dtype=torch.float32, device=x.device)
    dinit = torch.empty((B_, H, N, P), dtype=torch.float32, device=x.device)
    fn = cuda_build.load("mamba2_scan_bwd").mamba2_scan_bwd_dstates
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(dt.data_ptr(), A.data_ptr(), Cm.data_ptr(), dy.data_ptr(),
             0 if dstate is None else dstate.data_ptr(), ds.data_ptr(),
             0 if ds_loc is None else ds_loc.data_ptr(), dec.data_ptr(),
             dinit.data_ptr(), B_, S, H, G, N, P, Q, heads, int(bf16),
             cuda_build.stream_ptr(x.device))
    cuda_build.check(err, "mamba2_scan_bwd_dstates")
    return ds, dinit


def backward_from_dstates(x, dt, A, Bm, Cm, Q: int, s_prev, dy, ds,
                          heads: int):
    """The chunk kernels and (d) of the backward, ``heads`` heads a block:
    (dx, ddt, dA, dB, dC) from the forward's ``s_prev`` and the state
    gradients ``ds`` at the chunks' ends.  Not counted:
    ``mamba2_scan_backward`` is the entry point."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-S // Q)
    bf16 = x.dtype == torch.bfloat16
    want = (B_, nc, H, 2, N, P) if bf16 else (B_, nc, H, N, P)
    if s_prev.shape != want or s_prev.dtype != x.dtype \
            or ds.shape != want or ds.dtype != x.dtype:
        raise ValueError(f"mamba2_scan_backward: s_prev and ds {want} in "
                         f"x's type expected")
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    tiles = -(-(H // G) // heads)
    parts = [torch.empty((B_, S, G * tiles, N), dtype=torch.float32,
                         device=x.device) for _ in range(2)]
    dA_part = torch.empty((B_, nc, H), dtype=torch.float32, device=x.device)
    rsi = torch.empty((B_, nc, H, pad16(Q)), dtype=torch.float32,
                      device=x.device) if bf16 else None
    fn = cuda_build.load("mamba2_scan_bwd").mamba2_scan_bwd_chunks
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
             Cm.data_ptr(), dy.data_ptr(), s_prev.data_ptr(), ds.data_ptr(),
             dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
             dC.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
             dA_part.data_ptr(), 0 if rsi is None else rsi.data_ptr(), B_, S,
             H, G, N, P, Q, heads, int(bf16), cuda_build.stream_ptr(x.device))
    cuda_build.check(err, "mamba2_scan_bwd_chunks")
    return dx, ddt, dA, dB, dC


def mamba2_scan_backward(x, dt, A, Bm, Cm, Q: int, s_prev, dy, dstate=None):
    """(dx, ddt, dA, dB, dC, dinit) of the scan for the gradients ``dy`` of
    y and ``dstate`` (or none) of the final state, from the forward's
    ``s_prev``: the backward's kernels, counted once."""
    global BWD_LAUNCHES
    _bwd_check(x, dt, A, Bm, Cm, Q, dy, dstate)
    heads = bwd_heads(x, Bm, Q)
    ds, dinit = backward_dstates(x, dt, A, Cm, Q, dy, dstate, heads)
    grads = backward_from_dstates(x, dt, A, Bm, Cm, Q, s_prev, dy, ds, heads)
    BWD_LAUNCHES += 1
    return (*grads, dinit)


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
    bf16 = int(dtype == torch.bfloat16)
    return fn(Q, N, P, heads, bf16, 0), fn(Q, N, P, heads, bf16, 1)
