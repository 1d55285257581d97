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
reach.  Any other pair with d and dv up to ``MAX_D`` runs on the smallest
instantiated pair that covers it (``cover_pair``): q and k zero-padded to
its DK, v to its DV (``pad_to_pair``), the scale still 1/sqrt(d) of the
caller's d (a runtime argument of the kernels), and the output sliced
back to dv.  Zero key columns leave every q.k as it was and zero value
columns only add output columns, so the result is the caller's.  The
padding and the slicing sit outside ``FlashAttention``, so the gradient
runs on the covering pair's backward and flows back through them.  A pair
that no instance covers (d or dv past ``MAX_D``: ``cover_pair`` gives
None) runs on ``csrc/flash_attention_wide.cu``.  In bfloat16 that is
Hopper's design (wgmma and TMA on 64-column boxes, ``wide_plan`` gives
each kernel's blocks, ring and shared memory): the forward forms the
scores once for each piece of at most 512 value columns, the backward
splits dK, dV and dQ into pieces a warpgroup's registers hold and writes
fp32 gradients that the wrapper rounds to the inputs' type once.  TMA maps
rows of whole 16-byte chunks only, so a bf16 width that is no multiple of
8 is zero-padded to the next one (``wide_pair``), as a covering pair is.
In float32 it is the agreement route on the CUDA cores: both widths
walked at run time, the scores recomputed for each group of
``WIDE_GROUP`` value columns.

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

Given DTensors (under a mesh), the wrapper runs on the local shards
(``kernels/sharded.py``): batch and heads may be split over the mesh, the
sequence and the head dim stay whole; the KV heads must split as the
query heads do.  Given meta tensors, the forward and the backward return
empty outputs of the right shapes and book their cost
(``kernels/costs.py``) instead of running.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import costs, cuda_build, sharded

# launches of the CUDA kernel (not of the plain version) since the last
# reset, and of the backward (its three kernels, once a call)
LAUNCHES = 0
BWD_LAUNCHES = 0

NEG_INF = -1e30
# the kernel's (d, dv) pairs: FLASH_PAIRS in csrc/flash_attention.cu
PAIRS = ((8, 8), (16, 16), (24, 16), (32, 32), (64, 64), (80, 80),
         (128, 128), (192, 128), (256, 256))
MAX_D = 256                      # d and dv past this: the wide kernel
WIDE_GROUP = 512                 # value columns a fp32 wide forward block
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, causal: bool = True, scale=None):
    """The Pallas kernel's function in plain PyTorch: fp32 scores times
    ``scale`` (1/sqrt(d) unless given), masked to -1e30 above the diagonal
    when causal, softmax in fp32, the output in q's type."""
    B, S, H, d = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, S, KV, G, d)
    s = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) \
        * (1.0 / math.sqrt(d) if scale is None else scale)
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


def cover_pair(d: int, dv: int):
    """The instantiated pair a call at ``(d, dv)`` runs on: ``(d, dv)``
    itself when it is one of ``PAIRS``, else the covering pair (DK >= d,
    DV >= dv) with the fewest padded columns, DK + DV; None past
    ``MAX_D``, where the wide kernel runs (d, dv) as it is.  Raises for
    a width below 1."""
    if d < 1 or dv < 1:
        raise ValueError(f"flash_attention: widths d, dv >= 1, not "
                         f"({d}, {dv})")
    fits = [p for p in PAIRS if p[0] >= d and p[1] >= dv]
    return min(fits, key=lambda p: (p[0] + p[1], p)) if fits else None


def pad_to_pair(q, k, v, pair):
    """q and k zero-padded along their last dim to the pair's DK, v to its
    DV (each returned as it is when it already has that width)."""
    DK, DV = pair
    d, dv = q.shape[3], v.shape[3]
    if DK != d:
        q, k = (F.pad(t, (0, DK - d)) for t in (q, k))
    if DV != dv:
        v = F.pad(v, (0, DV - dv))
    return q, k, v


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


# the backward's designs, by ``flash_attention_bwd_design``'s code
BWD_DESIGNS = {0: "cuda_cores", 1: "mma_sync", 2: "wgmma"}
# the wgmma design's rows a tile and the shared memory an H100 block may
# take (csrc/flash_attention_bwd.cu: kSmemLimit)
BWD_TILE = 64
SMEM_LIMIT = 232448
# (batch row, head) pairs whose blocks the wgmma backward numbers together
# (kGroupHeads), so that the blocks in flight share few heads' tiles
BWD_GROUP_HEADS = 4


class BwdPlan(NamedTuple):
    """A wgmma backward block's plan (``WgPlan`` in the source)."""
    rows: bool             # each warpgroup owns 64 rows end to end
    rows_per_block: int    # 128 in rows mode, else 64
    stages: int            # streamed tile pairs in flight
    smem_bytes: int        # dynamic shared memory a block
    dq_cols0: int          # exchange mode's dQ columns of the first group


def bwd_design(d: int, dv: int, dtype) -> str:
    """The backward's design at ``(d, dv)`` in ``dtype`` as the library
    built it: ``wgmma`` (bf16 at head dims that are whole 64-column
    boxes), ``mma_sync`` (the other bf16 pairs) or ``cuda_cores``
    (float32)."""
    fn = cuda_build.load("flash_attention_bwd").flash_attention_bwd_design
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return BWD_DESIGNS[fn(d, dv, _DTYPES[dtype])]


def on_wgmma(d: int, dv: int) -> bool:
    """Whether the bf16 backward at ``(d, dv)`` runs the wgmma design:
    head dims that are whole 64-column TMA boxes."""
    return d % 64 == 0 and dv % 64 == 0


def wgmma_plan(d: int, dv: int, dq: bool) -> BwdPlan:
    """``WgPlan<d, dv, dq>``, the dQ kernel's (``dq``) or the dK/dV
    kernel's: rows mode (128 rows a block, 64 a warpgroup end to end) for
    dQ where 128 resident rows leave room for two stages, else exchange
    mode (64 rows a block, the products split between the two groups,
    two 16 KB fp32 buffers); 1 KB of alignment and the barriers; then as
    many streamed 64-row tile pairs as fit, 2 to 4.  Exchange mode's dQ
    columns split at a whole box so that each group's products are even
    (its score product's depth plus its share of dQ)."""
    pair = BWD_TILE * (d + dv) * 2
    rows = dq and 1280 + 4 * pair <= SMEM_LIMIT
    per_block = 2 * BWD_TILE if rows else BWD_TILE
    fixed = 1280 + per_block // BWD_TILE * pair \
        + (0 if rows else 2 * BWD_TILE * BWD_TILE * 4)
    stages = min(4, (SMEM_LIMIT - fixed) // pair)
    return BwdPlan(rows, per_block, stages, fixed + stages * pair,
                   dv // 2 // 64 * 64)


def _check(q, k, v) -> None:
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: all tensors must be on one device")
    if q.device.type not in ("cpu", "cuda", "meta"):
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
    if sharded.any_dtensor(q, k, v):
        return _on_mesh(q, k, v, causal)
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    d, dv = q.shape[3], v.shape[3]
    pair = cover_pair(d, dv) or wide_pair(d, dv, q.dtype)
    scale = 1.0 / math.sqrt(d)
    q, k, v = pad_to_pair(q, k, v, pair)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = FlashAttention.apply(q, k, v, causal, scale)
    else:
        out = _forward(q, k, v, causal, False, scale)[0]
    return out if pair[1] == dv else out[..., :dv].contiguous()


def _on_mesh(q, k, v, causal: bool):
    """The kernel on each shard: batch and heads split, or replicated."""
    mesh = sharded.mesh_of(q, k, v)
    lay = sharded.layout("flash_attention", q, mesh,
                         {0: "batch", 2: "heads"})
    q, k, v = (sharded.placed("flash_attention", t, mesh, lay,
                              sharded.SAME4) for t in (q, k, v))
    return sharded.run(
        lambda a, b, c: flash_attention_kernel(
            a.contiguous(), b.contiguous(), c.contiguous(), causal),
        mesh, (q, k, v), lay, [sharded.SAME4])


def _cost(q, k, v, causal: bool, fn=costs.flash_fwd):
    B, S, H, d = q.shape
    return fn(B, S, k.shape[1], H, k.shape[2], d, v.shape[3], causal,
              q.element_size())


def is_wide(d: int, dv: int) -> bool:
    """Whether ``(d, dv)`` runs on the wide kernel: no pair covers it."""
    return cover_pair(d, dv) is None


def wide_pair(d: int, dv: int, dtype) -> tuple:
    """The widths the wide kernel runs a call at ``(d, dv)`` on: bf16's
    rounded up to whole 16-byte rows (multiples of 8) for TMA, zero-padded
    by ``pad_to_pair``; fp32's as they are."""
    if dtype != torch.bfloat16:
        return (d, dv)
    return (-(-d // 8) * 8, -(-dv // 8) * 8)


# the bf16 wide kernels: the forward, the backward's dK/dV and dQ
WIDE_KINDS = ("fwd", "dkdv", "dq")
WIDE_BOX = 64                    # columns (and rows) of a TMA box
WIDE_GROUP_BOXES = 4             # boxes a consumer group accumulates
WIDE_FIXED = 1024 + 512          # alignment slack and mbarriers
WIDE_XCHG = 64 * 64 * 4          # a 64 x 64 fp32 exchange buffer
WIDE_STAGES = (8, 24)            # the ring's least and most stages


class WidePlan(NamedTuple):
    """A bf16 wide kernel's blocks (``WidePlan`` in the source).  Side a
    is the score product over d's boxes, side b the value side over dv's;
    ``resident`` says whether each side's own rows (the forward's Q;
    dK/dV's K, V; dQ's Q, dO) stay in shared memory, else they stream
    through the ring beside the others.  A 64-row tile of a head takes
    ``pieces`` blocks, each holding ``piece_boxes`` boxes of dK / dQ
    columns (a) and of V / dV columns (b)."""
    kind: str
    boxes: tuple           # (d's, dv's) 64-column boxes
    resident: tuple        # side a's, side b's rows resident
    pieces: int            # blocks a 64-row tile of a head
    piece_boxes: tuple     # boxes a piece of side a, of side b
    xchg: int              # 16 KB fp32 exchange buffers
    entries: int           # ring entries a step (the forward: a key tile)
    stages: int            # 8 KB stages of the ring
    table: int             # bytes of the backward's entry table
    smem_bytes: int        # dynamic shared memory a block (0: too wide)
    score_work: int        # S (and dP) formed a tile, over the one needed


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wide_dq_split(n: int, na: int, nb: int) -> int:
    """dQ: the first group's boxes of a piece of ``n``, so that the
    groups' products are even (na + n0 = nb + n - n0), each at most
    ``WIDE_GROUP_BOXES``."""
    g = WIDE_GROUP_BOXES
    return min(min(g, n), max(max(0, n - g), (n + nb - na) // 2))


def wide_plan(d: int, dv: int, kind: str) -> WidePlan:
    """The bf16 wide kernel of ``kind`` at ``(d, dv)`` (whole 16-byte
    rows): its pieces (forward: value pieces of at most 8 boxes; dK/dV:
    as many dK and dV pieces of at most 4 boxes; dQ: pieces of at most 8
    boxes), whose rows stay resident (both sides, else side a alone, else
    side b, else none: the first that leaves the ring 8 stages, and in the
    backward two more than a step's held entries), the ring's stages (as
    many as fit, at most 24; the forward's even, half a group) and the
    shared memory a block."""
    g = WIDE_GROUP_BOXES
    na, nb = _cdiv(d, WIDE_BOX), _cdiv(dv, WIDE_BOX)
    if kind == "fwd":
        pieces = _cdiv(nb, 2 * g)
        pa, pb, xchg = 0, _cdiv(nb, pieces), 2
    elif kind == "dkdv":
        pieces = max(_cdiv(na, g), _cdiv(nb, g))
        pa, pb, xchg = _cdiv(na, pieces), _cdiv(nb, pieces), 1
    elif kind == "dq":
        pieces = _cdiv(na, 2 * g)
        pa, pb, xchg = _cdiv(na, pieces), 0, 2
    else:
        raise ValueError(f"wide_plan: kind in {WIDE_KINDS}, not {kind!r}")
    box = 2 * WIDE_BOX * WIDE_BOX
    for ra, rb in ((1, 1), (1, 0), (0, 1), (0, 0)):
        if kind == "fwd" and rb:
            continue
        if kind == "fwd":
            entries, table, need = na * (2 - ra) + pb, 0, WIDE_STAGES[0]
        else:
            entries = na * (2 - ra) + nb * (2 - rb)
            table = _cdiv(2 * entries, 16) * 16
            need = max(WIDE_STAGES[0], pa * (2 - ra) + pb * (2 - rb) + 2)
        fixed = WIDE_FIXED + xchg * WIDE_XCHG + table \
            + (ra * na + rb * nb) * box
        avail = (SMEM_LIMIT - fixed) // box
        if avail >= need:
            stages = min(avail, WIDE_STAGES[1])
            if kind == "fwd":          # a ring of half the stages a group
                stages -= stages % 2
            return WidePlan(kind, (na, nb), (ra, rb), pieces, (pa, pb),
                            xchg, entries, stages, table,
                            fixed + stages * box, pieces)
    return WidePlan(kind, (na, nb), (0, 0), pieces, (pa, pb), xchg, 0, 0, 0,
                    0, pieces)


def wide_score_work(d: int, dv: int) -> dict:
    """How often the bf16 wide route forms its score products, over the
    function's need: the forward's S (once a value piece), the
    backward's S and dP (once a dK/dV block and once a dQ block of a
    tile), and the backward's products in all against the five (S, dP,
    dV, dK, dQ) that suffice."""
    kv, q = wide_plan(d, dv, "dkdv").pieces, wide_plan(d, dv, "dq").pieces
    return dict(forward=wide_plan(d, dv, "fwd").pieces, backward=kv + q,
                backward_products=2 * (kv + q) + 3)


def _cuda_limits(q, k, v) -> None:
    """Raise on what the CUDA kernels do not take."""
    d, dv = q.shape[3], v.shape[3]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: no kernel for q {q.dtype}, k/v "
                        f"{k.dtype}/{v.dtype}")
    if (d, dv) not in PAIRS and not is_wide(d, dv):
        raise ValueError(f"flash_attention: the kernel is built for (d, dv) "
                         f"in {PAIRS}, not ({d}, {dv}); the wrapper pads "
                         f"to them (cover_pair)")
    if is_wide(d, dv) and wide_pair(d, dv, q.dtype) != (d, dv):
        raise ValueError(f"flash_attention: the bf16 wide kernel maps whole "
                         f"16-byte rows, not ({d}, {dv}); the wrapper pads "
                         f"to {wide_pair(d, dv, q.dtype)} (wide_pair)")
    if is_wide(d, dv) and q.dtype == torch.bfloat16 and any(
            wide_plan(d, dv, kind).smem_bytes == 0 for kind in WIDE_KINDS):
        raise ValueError(f"flash_attention: ({d}, {dv}) leaves no ring "
                         f"beside a block's fixed shared memory")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: tensors must be contiguous")
    if k.shape[1] == 0:
        raise ValueError("flash_attention: no keys")
    if q.device.type == "cuda" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: tensors must be 16-byte aligned")


def _scale(q, scale) -> float:
    return 1.0 / math.sqrt(q.shape[3]) if scale is None else float(scale)


def _forward(q, k, v, causal: bool, with_lse: bool, scale=None):
    """The kernel's (out [B, S, H, dv], lse [B, H, S] fp32 or None), scores
    times ``scale`` (1/sqrt(d) of q's width unless given)."""
    global LAUNCHES
    _cuda_limits(q, k, v)
    B, S, H, d = q.shape
    T, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    out = q.new_empty((B, S, H, dv))
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() == 0:
        return out, lse
    if q.device.type == "meta":
        costs.book("flash_attention", _cost(q, k, v, causal))
        return out, lse
    if is_wide(d, dv):
        fn = cuda_build.load("flash_attention_wide").flash_attention_wide
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 0 if lse is None else lse.data_ptr(), B, S, T, H, KV, d,
                 dv, int(causal), _scale(q, scale), _DTYPES[q.dtype],
                 cuda_build.stream_ptr(q.device))
        cuda_build.check(err, "flash_attention_wide")
        LAUNCHES += 1
        return out, lse
    fn = cuda_build.load("flash_attention").flash_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             0 if lse is None else lse.data_ptr(), B, S, T, H, KV, d, dv,
             int(causal), _scale(q, scale), _DTYPES[q.dtype],
             cuda_build.stream_ptr(q.device))
    cuda_build.check(err, "flash_attention")
    LAUNCHES += 1
    return out, lse


def backward_from_delta(q, k, v, lse, delta, dout, causal: bool = True,
                        scale=None):
    """The backward's dK/dV and dQ kernels alone, given the row vector
    ``delta`` [B, H, S] (D = rowsum(dO o), fp32) and the forward's
    ``scale``.  Returns (dq, dk, dv) in q's type.  Not counted:
    ``flash_attention_backward`` is the entry point."""
    _cuda_limits(q, k, v)
    B, S, H, d = q.shape
    T, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    if dout.shape != (B, S, H, dv) or dout.dtype != q.dtype \
            or not dout.is_contiguous() or lse.shape != (B, H, S) \
            or delta.shape != (B, H, S) or lse.dtype != torch.float32 \
            or delta.dtype != torch.float32:
        raise ValueError("flash_attention_backward: dout [B, S, H, dv] in "
                         "q's type and fp32 lse, delta [B, H, S] expected")
    if is_wide(d, dv):
        return _wide_backward(q, k, v, lse, delta, dout, causal, scale)
    dq, dk, dvv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk.zero_(), dvv.zero_()
    fn = cuda_build.load("flash_attention_bwd").flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dvv.data_ptr(), B, S, T, H, KV, d, dv, int(causal),
             _scale(q, scale), _DTYPES[q.dtype],
             cuda_build.stream_ptr(q.device))
    cuda_build.check(err, "flash_attention_bwd")
    return dq, dk, dvv


def _wide_backward(q, k, v, lse, delta, dout, causal: bool, scale):
    """``backward_from_delta`` on the wide kernel: its fp32 gradients,
    each rounded to the input's type once."""
    B, S, H, d = q.shape
    T, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    grads = [torch.empty(t.shape, dtype=torch.float32, device=q.device)
             for t in (q, k, v)]
    if S == 0:
        return tuple(g.zero_().to(q.dtype) for g in grads)
    fn = cuda_build.load("flash_attention_wide").flash_attention_wide_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(),
             *(g.data_ptr() for g in grads), B, S, T, H, KV, d, dv,
             int(causal), _scale(q, scale), _DTYPES[q.dtype],
             cuda_build.stream_ptr(q.device))
    cuda_build.check(err, "flash_attention_wide_bwd")
    return tuple(g.to(q.dtype) for g in grads)


def wide_smem_bytes(d: int, dv: int, kind: str, dtype) -> int:
    """The wide kernel's dynamic shared memory a block of its ``kind``
    (``WIDE_KINDS``) at ``(d, dv)`` in ``dtype``, as the source computes
    it (the fp32 backward's is static: 0)."""
    fn = cuda_build.load("flash_attention_wide") \
        .flash_attention_wide_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn(d, dv, WIDE_KINDS.index(kind), _DTYPES[dtype])


def wide_source_plan(d: int, dv: int, kind: str) -> WidePlan:
    """The bf16 wide kernel's plan as the source computes it (its
    ``WidePlan``), in ``wide_plan``'s fields."""
    fn = cuda_build.load("flash_attention_wide").flash_attention_wide_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_int * 13)()
    fn(d, dv, WIDE_KINDS.index(kind), ctypes.addressof(out))
    (_, na, nb, ra, rb, pieces, pa, pb, xchg, entries, stages, table,
     smem) = list(out)
    return WidePlan(kind, (na, nb), (ra, rb), pieces, (pa, pb), xchg,
                    entries, stages, table, smem, pieces)


def flash_attention_backward(q, k, v, out, lse, dout, causal: bool = True,
                             scale=None):
    """(dq, dk, dv) of the attention ``out`` = flash_attention(q, k, v)
    for its gradient ``dout``, from the forward's ``lse`` and ``scale``
    (1/sqrt(d) of q's width unless given): three kernel launches (D,
    dK/dV, dQ), counted once."""
    global BWD_LAUNCHES
    B, S, H, _ = q.shape
    dv = v.shape[3]
    if any(t.shape != (B, S, H, dv) or t.dtype != q.dtype
           or not t.is_contiguous() for t in (out, dout)):
        raise ValueError("flash_attention_backward: out and dout "
                         "[B, S, H, dv], contiguous, in q's type expected")
    if q.device.type == "meta":
        costs.book("flash_attention_bwd",
                   _cost(q, k, v, causal, costs.flash_bwd))
        return tuple(torch.empty_like(t) for t in (q, k, v))
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
    grads = backward_from_delta(q, k, v, lse, delta, dout, causal, scale)
    BWD_LAUNCHES += 1
    return grads


class FlashAttention(torch.autograd.Function):
    """The kernel with its backward kernels, for CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale=None):
        out, lse = _forward(q, k, v, causal, True, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout.to(q.dtype).contiguous(), ctx.causal,
            ctx.scale)
        return dq, dk, dv, None, None
