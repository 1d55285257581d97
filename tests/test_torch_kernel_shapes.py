"""The arithmetic the K5-K8 wrappers do around their kernels so that every
shape the JAX kernels take runs on the card: K5's choice of instance, K6's
covering pair and padding with the caller's scale, K7's chunk, K8's padded
state size; and past the instances, every width: K5's walk of any key and
value width, K6's wide kernels (bf16: 64-column boxes, two groups' partial
scores, pieces of value and gradient columns, ``wide_plan``; fp32: d walked
in slabs, value columns in groups), K7's state in groups of rows and
columns, K8's state in blocks of its N 64 instance.  A run on the card
shows only that the kernel agrees with the plain version; these show, on
the CPU, that the padding, the chunking, the splits and the slabs
themselves change nothing: the plain version on the padded inputs (or at
the kernel's chunk, or over the groups and blocks, or a replay of the
slabs in float64), sliced back, equals the plain version as the caller
called it, and the JAX kernel.  Meta tensors take the wrappers' card path
without a card."""
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port import (assert_close, assert_close_beside_the_reference,  # noqa: E402,F401,E501
                         mamba2_scan_ref64,
                         one_thread, to_np)

from repro.kernels.mamba2_scan.ops import mamba2_scan as j_mamba  # noqa: E402
from repro.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.kernels import costs  # noqa: E402
from repro_torch.kernels.decode_attention import \
    decode_attention as da  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as fa  # noqa: E402
from repro_torch.kernels.mamba2_scan import mamba2_scan as ms  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as rs  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16


# ------------------------------------------------------------ K5 instances
@pytest.mark.parametrize("d,dv,dtype,want", [
    (128, 128, F32, ("workers", 128, 128)),       # the first instances
    (16, 16, F32, ("workers", 16, 16)),
    (96, 96, F32, ("lanes", 576, 512)),
    (64, 32, F32, ("lanes", 576, 512)),
    (256, 256, F32, ("lanes", 576, 512)),
    (576, 512, F32, ("lanes", 576, 512)),
    (128, 128, BF16, ("tensor_cores", 128, 128)),
    (96, 96, BF16, ("tensor_cores", 128, 128)),
    (64, 32, BF16, ("tensor_cores", 64, 64)),
    (8, 8, BF16, ("tensor_cores", 16, 16)),
    (256, 256, BF16, ("tensor_cores", 256, 256)),  # gemma-7b
    (200, 64, BF16, ("tensor_cores", 256, 256)),
    # past 256 up to (576, 512), bf16 rows of whole 16-byte chunks run on
    # wgmma at the caller's own widths: deepseek-v2's latent and the widths
    # that route 1's (576, 512) instance once covered
    (576, 512, BF16, ("wgmma", 576, 512)),
    (264, 256, BF16, ("wgmma", 264, 256)),
    (200, 304, BF16, ("wgmma", 200, 304)),
    (576, 8, BF16, ("wgmma", 576, 8)),
    (100, 60, BF16, ("lanes", 576, 512)),         # rows of 200 bytes
    (1, 1, BF16, ("lanes", 576, 512)),
    (300, 100, F32, ("lanes", 576, 512)),
    # past (576, 512): bf16 rows of whole 16-byte chunks on the tensor-core
    # walk, float32 and other bf16 rows on the TF32 walk
    (1024, 1024, BF16, ("walk_tc", 1024, 1024)),
    (1000, 600, BF16, ("walk_tc", 1000, 600)),
    (584, 8, BF16, ("walk_tc", 584, 8)),
    (1024, 1024, F32, ("walk", 1024, 1024)),
    (1001, 600, BF16, ("walk", 1001, 600)),
    (1000, 602, BF16, ("walk", 1000, 602)),
])
def test_decode_instance_covers_the_widths(d, dv, dtype, want):
    """``instance`` at one query head a row: float32 at the square head
    dims keeps its instance; bf16 rows of whole 16-byte chunks go to the
    tensor cores up to 256 and to wgmma past it up to (576, 512) (past
    that the tensor-core walk), every other width to the CUDA-core lanes
    or, past them, the TF32 walk; the instance always holds (d, dv)."""
    route, DK, DV = da.instance(d, dv, dtype)
    assert (route, DK, DV) == want
    assert d <= DK and dv <= DV
    if route in ("tensor_cores", "walk_tc", "wgmma"):
        assert d % 8 == 0 and dv % 8 == 0 and dtype == BF16


@pytest.mark.parametrize("d,dv,dtype", [
    (96, 96, F32), (256, 256, F32), (576, 512, F32), (300, 100, F32),
    (100, 60, BF16), (1, 1, BF16), (576, 511, BF16)])
@pytest.mark.parametrize("H", [1, 4, 5, 20, 128])
def test_decode_instance_moves_many_heads_off_the_lanes(d, dv, dtype, H):
    """Up to (576, 512), float32 outside the square instances and bf16
    rows that are not whole 16-byte chunks stay on the lanes (route 2,
    ``LANES_HEADS`` heads a block, each K and V byte read once) at up to 4
    heads a row, and run on the TF32 walk (route 3, 16 heads a block) at
    the caller's widths past that; the other routes do not depend on the
    head count."""
    got = da.instance(d, dv, dtype, H)
    assert got == (("walk", d, dv) if H > da.LANES_HEADS
                   else ("lanes", 576, 512))
    assert da.LANES_HEADS == 4
    for other in ((128, 128, F32), (576, 512, BF16), (256, 256, BF16),
                  (1024, 1024, F32), (1000, 600, BF16)):
        assert da.instance(*other, H) == da.instance(*other)


@pytest.mark.parametrize("d,dv", [(577, 512), (576, 513), (0, 16),
                                  (1024, 64), (16, 0), (1024, 1024),
                                  (640, 512), (576, 640), (1, 2048)])
def test_decode_instance_refuses_past_its_limit(d, dv):
    """K5's limit is now a width of at least 1, the one it refuses; past
    the lanes instance's (576, 512), where it refused until PR 29, every
    width runs on a walk at the caller's own widths (no padding): bf16
    rows of whole 16-byte chunks on the tensor-core walk, float32 and
    other bf16 rows on the TF32 walk."""
    for dtype in (F32, BF16):
        if d < 1 or dv < 1:
            with pytest.raises(ValueError, match=">= 1"):
                da.instance(d, dv, dtype)
        else:
            whole = dtype == BF16 and d % 8 == 0 and dv % 8 == 0
            assert da.instance(d, dv, dtype) == (
                "walk_tc" if whole else "walk", d, dv)


def _tf32(a):
    """float32 values rounded to TF32 (10 mantissa bits, to nearest, ties
    away from zero: cvt.rna.tf32.f32), as float64."""
    b = np.asarray(a, np.float32).view(np.uint32)
    b = (b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return b.view(np.float32).astype(np.float64)


def _split(a, lo=True):
    """float32 values as the TF32 walk splits them: hi = tf32(x) and lo =
    tf32(x - hi) (``lo=False``: hi alone)."""
    a = np.asarray(a, np.float32)
    hi = _tf32(a)
    return hi, (_tf32(a - hi.astype(np.float32)) if lo else 0.0 * hi)


def _tf32_product(a, b, split: bool, lo: bool = True):
    """a @ b as the TF32 walk's tensor cores form it, in float64: float32
    (``split``) as hi.hi + hi.lo + lo.hi of the split operands (hi.hi
    alone with ``lo=False``); bfloat16 values, exact in TF32, as they
    are."""
    if not split:
        return a @ b
    ah, al = _split(a, lo)
    bh, bl = _split(b, lo)
    return ah @ bh + (ah @ bl + al @ bh)


def decode_walk_replay(q, kp, vp, pt, lens, n_splits: int,
                       dtype: str = "float32", lo: bool = True):
    """The TF32 walk's arithmetic in float64 (``csrc/decode_attention.cu``
    route 3 and the merge), on ``walk_plan``: each split's tokens in tiles
    of ``tile``; a tile's scores summed over d's chunks of ``chunk``
    columns (zero past d), each chunk's Q K^T float32 as three products of
    split operands, bfloat16 as one; the tile's maximum of each head over
    all its tokens, the running max and sum (of P unrounded); P V float32
    as three products of P (as float32) and V split, bfloat16 with P
    rounded once to TF32; value columns in the plan's groups, each
    recomputing the same scores; the splits merged in order.  ``lo=False``
    drops the lo products (one TF32 product)."""
    B, H, d = q.shape
    page, dv = kp.shape[1], vp.shape[2]
    P = pt.shape[1]
    split = dtype == "float32"
    plan = da.walk_plan(d, dv, {"float32": F32, "bfloat16": BF16}[dtype])
    per = -(-P // n_splits)
    out = np.zeros((B, H, dv))
    width = plan.k_chunks * plan.chunk
    for b in range(B):
        n_pages = min(P, -(-int(lens[b]) // page)) if lens[b] > 0 else 0
        Q = np.pad(q[b], ((0, 0), (0, width - d)))
        parts = []
        for sp in range(0, P, per):
            toks = [(pt[b, pi], t) for pi in range(sp, min(sp + per,
                                                           n_pages))
                    for t in range(min(page, int(lens[b]) - pi * page))]
            acc = np.zeros((H, dv))
            for grp in range(plan.groups):
                cols = slice(grp * plan.group_cols,
                             min(dv, (grp + 1) * plan.group_cols))
                m, l = np.full(H, -1e30), np.zeros(H)
                for t0 in range(0, len(toks), plan.tile):
                    tile = toks[t0:t0 + plan.tile]
                    K = np.pad(np.stack([kp[sl, t] for sl, t in tile]),
                               ((0, 0), (0, width - d)))
                    V = np.stack([vp[sl, t, cols] for sl, t in tile])
                    s = sum(_tf32_product(Q[:, c:c + plan.chunk],
                                          K[:, c:c + plan.chunk].T, split,
                                          lo)
                            for c in range(0, width, plan.chunk))
                    s = s / math.sqrt(d)
                    mn = np.maximum(m, s.max(axis=1))
                    alpha, p = np.exp(m - mn), np.exp(s - mn[:, None])
                    l = l * alpha + p.sum(axis=1)
                    pv = _tf32_product(p, V, True, lo) if split \
                        else _tf32(p) @ V
                    acc[:, cols] = acc[:, cols] * alpha[:, None] + pv
                    m = mn
            parts.append((m, l, acc))   # every group's m and l are the same
        M = np.max([pm for pm, _, _ in parts], axis=0)
        L = sum(pl * np.exp(pm - M) for pm, pl, _ in parts)
        A = sum(pa * np.exp(pm - M)[:, None] for pm, _, pa in parts)
        out[b] = A / np.maximum(L, 1e-30)[:, None]
    return out


def decode_walk_tc_replay(q, kp, vp, pt, lens, n_splits: int,
                          dtype: str = "bfloat16"):
    """The tensor-core walk's arithmetic in float64 (``csrc/
    decode_attention.cu`` route 4 and the merge), on ``walk_tc_plan``:
    each split's tokens in tiles of ``tile``; a tile's scores summed over
    d's chunks of ``chunk`` columns (zero past d), the tile's maximum of
    each head over all its tokens, the running max and sum, P rounded to
    bf16 before P V (the sum of P unrounded); value columns in the plan's
    groups, each recomputing the same scores; the splits merged in
    order."""
    B, H, d = q.shape
    page, dv = kp.shape[1], vp.shape[2]
    P = pt.shape[1]
    plan = da.walk_tc_plan(d, dv)
    per = -(-P // n_splits)
    out = np.zeros((B, H, dv))
    q, kp, vp = (a.astype(np.float64) for a in (q, kp, vp))
    width = plan.k_chunks * plan.chunk
    for b in range(B):
        n_pages = min(P, -(-int(lens[b]) // page)) if lens[b] > 0 else 0
        Q = np.pad(q[b], ((0, 0), (0, width - d)))
        parts = []
        for sp in range(0, P, per):
            toks = [(pt[b, pi], t) for pi in range(sp, min(sp + per,
                                                           n_pages))
                    for t in range(min(page, int(lens[b]) - pi * page))]
            acc = np.zeros((H, dv))
            for grp in range(plan.groups):
                cols = slice(grp * plan.group_cols,
                             min(dv, (grp + 1) * plan.group_cols))
                m, l = np.full(H, -1e30), np.zeros(H)
                for t0 in range(0, len(toks), plan.tile):
                    tile = toks[t0:t0 + plan.tile]
                    K = np.pad(np.stack([kp[sl, t] for sl, t in tile]),
                               ((0, 0), (0, width - d)))
                    V = np.stack([vp[sl, t, cols] for sl, t in tile])
                    s = sum(Q[:, c:c + plan.chunk] @ K[:, c:c + plan.chunk].T
                            for c in range(0, width, plan.chunk))
                    s = s / math.sqrt(d)
                    mn = np.maximum(m, s.max(axis=1))
                    alpha, p = np.exp(m - mn), np.exp(s - mn[:, None])
                    l = l * alpha + p.sum(axis=1)
                    acc[:, cols] = acc[:, cols] * alpha[:, None] + _bf16(p) @ V
                    m = mn
            parts.append((m, l, acc))   # every group's m and l are the same
        M = np.max([pm for pm, _, _ in parts], axis=0)
        L = sum(pl * np.exp(pm - M) for pm, pl, _ in parts)
        A = sum(pa * np.exp(pm - M)[:, None] for pm, _, pa in parts)
        out[b] = A / np.maximum(L, 1e-30)[:, None]
    return out


WALK_REPLAY = {"walk_tc": decode_walk_tc_replay, "walk": decode_walk_replay}


@pytest.mark.parametrize("d,dv,n_splits", [(640, 512, 2), (576, 640, 1),
                                           (1024, 1024, 3), (1000, 600, 2),
                                           (640, 1100, 2)])
@pytest.mark.parametrize("schedule,dtype", [("walk_tc", "bfloat16"),
                                            ("walk", "float32"),
                                            ("walk", "bfloat16")])
def test_decode_walk_replay_equals_the_jax_kernel(d, dv, n_splits, schedule,
                                                  dtype):
    """The walks' splits and value groups, replayed in float64, against
    the Pallas kernel in interpret mode and the port's plain version at
    widths past the lanes instance, within the reference's tolerances:
    the tensor-core walk's (bf16: tiles of 64 tokens, d in chunks of 64,
    P rounded to bf16, groups of 1024 value columns; two at dv 1100) and
    the TF32 walk's on the same tiles and groups in both types (float32:
    three products of split operands; bfloat16: one, P rounded to
    TF32)."""
    from repro.kernels.decode_attention.ops import \
        paged_decode_attention as j_decode
    q, kp, vp, pt, lens = (t.numpy() for t in _decode_case(2, 3, d, dv, 4,
                                                            3, seed=d))
    lens = np.maximum(lens, 1).astype(np.int32)
    tdt = {"float32": F32, "bfloat16": BF16}[dtype]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, kp, vp = (np.array(jnp.asarray(a).astype(jdt), np.float32)
                 for a in (q, kp, vp))     # the type's values, exactly
    ref = np.asarray(j_decode(*(jnp.asarray(a).astype(jdt)
                                for a in (q, kp, vp)),
                              jnp.asarray(pt), jnp.asarray(lens)),
                     np.float32)
    got = WALK_REPLAY[schedule](q, kp, vp, pt, lens, n_splits, dtype)
    assert_close(got.astype(np.float32), ref, dtype)
    plain = da.paged_decode_plain(*(torch.from_numpy(a).to(tdt)
                                    for a in (q, kp, vp)),
                                  torch.from_numpy(pt),
                                  torch.from_numpy(lens))
    assert_close(to_np(plain), ref, dtype)


def _walk_case(d, dv, dtype, seed):
    """``test_decode_walk_replay_equals_the_jax_kernel``'s inputs: the
    type's values as float32 numpy arrays, and the JAX kernel's output."""
    from repro.kernels.decode_attention.ops import \
        paged_decode_attention as j_decode
    q, kp, vp, pt, lens = (t.numpy() for t in _decode_case(2, 3, d, dv, 4,
                                                            3, seed=seed))
    lens = np.maximum(lens, 1).astype(np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, kp, vp = (np.array(jnp.asarray(a).astype(jdt), np.float32)
                 for a in (q, kp, vp))
    ref = np.asarray(j_decode(*(jnp.asarray(a).astype(jdt)
                                for a in (q, kp, vp)),
                              jnp.asarray(pt), jnp.asarray(lens)),
                     np.float32)
    return q, kp, vp, pt, lens, ref


@pytest.mark.parametrize("d,dv,n_splits", [(1024, 1024, 3), (640, 1100, 2)])
def test_decode_walk_replay_needs_the_lo_products_in_fp32(d, dv, n_splits):
    """The TF32 walk's float32 split is needed: the same replay with the
    lo products dropped (one TF32 product, an error near 2^-11) leaves
    the reference's 2e-5 against the JAX kernel, where the three products
    stay inside it."""
    q, kp, vp, pt, lens, ref = _walk_case(d, dv, "float32", seed=d)
    full = decode_walk_replay(q, kp, vp, pt, lens, n_splits, "float32")
    assert_close(full.astype(np.float32), ref, "float32")
    one = decode_walk_replay(q, kp, vp, pt, lens, n_splits, "float32",
                             lo=False).astype(np.float32)
    over = np.abs(one - ref) - (2e-5 + 2e-5 * np.abs(ref))
    assert over.max() > 0, "one TF32 product stayed within 2e-5"
    assert np.abs(one - ref).max() > 10 * np.abs(full - ref).max()


# the TF32 walk's plans by hand: (stages, k_chunks, groups, group_cols,
# v_chunks, q_resident, entry_rows, shift_tiles, smem_bytes).  Shared
# memory, within two blocks an SM (115,712 bytes each): a ring of entries
# of 64 token rows (80 with Q's 16 rows) x the wider pitch (fp32 72 x 4
# bytes, 4 entries; bf16 80 x 2 bytes, 8 entries), P's fragments hi and lo
# 2 x 8 x 32 x 4 x 4 bytes, the warps' maxima 8 x 16 x 4 bytes (8,704
# bytes with P), the tiles' shifts shift_tiles x 2 x 64 bytes, and Q 16 x
# (64 k_chunks + one window) of the type where all of it fits.  The copier
# runs stages - 1 entries ahead and enters a tile as it issues its first;
# a tile's shifts are read until its K entries are done: one slot where a
# tile (k_chunks + v_chunks entries) is longer than stages - 1 + k_chunks,
# else stages // 2 + 1, enough for tiles of two entries
WALK_PLANS = {
    # Q 1028 wide would take 65,792 bytes beside a ring of 73,728: it
    # rides in the K entries, 4 x 80 x 288 + 8,832; one group, so every K
    # and V byte of a (row, head chunk) is asked for once
    ("float32", 1024, 1024): (4, 16, 1, 1024, 16, False, 80, 1, 100992),
    ("float32", 640, 512): (4, 10, 1, 512, 8, False, 80, 1, 100992),
    ("float32", 4928, 520): (4, 77, 1, 520, 9, False, 80, 1, 100992),
    # bf16: 8 x 80 x 160 + 8,832 past d 768; d's last chunk 41 columns
    ("bfloat16", 1001, 1000): (8, 16, 1, 1000, 16, False, 80, 1, 111232),
    ("bfloat16", 1000, 602): (8, 16, 1, 602, 10, False, 80, 1, 111232),
    # Q 648 wide, 20,736 bytes, fits beside 81,920 + 8,832
    ("bfloat16", 640, 512): (8, 10, 1, 512, 8, True, 64, 1, 111488),
    # one K chunk and two groups, the second of 6 columns (one V chunk):
    # its tiles are two entries, so the copier enters (3 + 1) // 2 = 2
    # (fp32) or (7 + 1) // 2 = 4 (bf16) tiles ahead of a tile's last read
    # of its shifts, the most it can; Q resident, fp32 16 x 68 x 4 beside
    # 73,728 + 8,704 + 3 x 128, bf16 16 x 72 x 2 beside 81,920 + 8,704 +
    # 5 x 128
    ("float32", 60, 1030): (4, 1, 2, 1024, 16, True, 64, 3, 87168),
    ("bfloat16", 60, 1030): (8, 1, 2, 1024, 16, True, 64, 5, 93568),
}


@pytest.mark.parametrize("dtype,d,dv", list(WALK_PLANS))
def test_decode_walk_plan_matches_the_hand_counts(dtype, d, dv):
    """``walk_plan`` at the timed and checked widths: stages, chunks,
    groups, Q's place, the shift slots and shared memory as counted by
    hand, within two blocks an H100 SM and adding up; the fewest shift
    slots that outlast the copier's lead; the row pitches; the blocks a
    (row, head chunk, split); the K and V bytes asked for: each once per
    (row, head chunk) where one group covers dv, K again for each further
    group, both again for each chunk of 16 heads."""
    tdt = {"float32": F32, "bfloat16": BF16}[dtype]
    item = 4 if dtype == "float32" else 2
    plan = da.walk_plan(d, dv, tdt)
    assert (plan.stages, plan.k_chunks, plan.groups, plan.group_cols,
            plan.v_chunks, plan.q_resident, plan.entry_rows,
            plan.shift_tiles, plan.smem_bytes) == WALK_PLANS[dtype, d, dv]
    assert (plan.tile, plan.chunk, plan.window) == (64, 64, 16 // item)
    assert (plan.k_pitch, plan.v_pitch) == ((68, 72) if item == 4
                                            else (72, 80))
    assert plan.q_pitch == 64 * plan.k_chunks + 16 // item
    # two blocks an SM: each within half of its 233,472 bytes less 1,024
    assert plan.smem_bytes <= da.WALK_BLOCK_SMEM == 233472 // 2 - 1024
    ring = plan.stages * plan.entry_rows * max(plan.k_pitch,
                                               plan.v_pitch) * item
    q_bytes = 16 * plan.q_pitch * item
    fixed = 8704 + 128 * plan.shift_tiles
    assert plan.smem_bytes == ring + fixed \
        + (q_bytes if plan.q_resident else 0)
    if not plan.q_resident:             # Q streams only where it must
        assert plan.stages * 64 * max(plan.k_pitch, plan.v_pitch) * item \
            + fixed + q_bytes > da.WALK_BLOCK_SMEM
    # slots that keep a tile's shifts until its last read: the copier
    # enters a tile every k_chunks + v_chunks entries (fewest in the last
    # group) and runs stages - 1 ahead; one slot only where it enters none
    fewest = plan.k_chunks + -(-(dv - (plan.groups - 1) * 1024) // 64)
    ahead = plan.stages - 1 + plan.k_chunks
    assert plan.shift_tiles * fewest > ahead
    assert plan.shift_tiles == (1 if fewest > ahead
                                else plan.stages // 2 + 1)
    # a row chunk and its extra window fit a shared row, 16-byte aligned
    assert plan.k_pitch >= 64 + 16 // item and plan.v_pitch >= 64 + 16 // item
    assert plan.k_pitch * item % 16 == 0 and plan.v_pitch * item % 16 == 0
    assert da.value_groups(("walk", d, dv)) == plan.groups \
        == -(-dv // 1024)
    tokens = 4096
    k_bytes, v_bytes = plan.reads(d, dv, 16, tokens)
    assert (k_bytes, v_bytes) == (item * tokens * d * plan.groups,
                                  item * tokens * dv)
    assert plan.reads(d, dv, 20, tokens) == (2 * k_bytes, 2 * v_bytes)


@pytest.mark.parametrize("dtype,width", [("bfloat16", 1001),
                                         ("bfloat16", 1000),
                                         ("float32", 1001),
                                         ("bfloat16", 602),
                                         ("float32", 602)])
@pytest.mark.parametrize("page", [16, 7])
def test_decode_walk_windows_are_aligned_cover_and_stay_in_the_pool(
        dtype, width, page):
    """Every (slot, token, chunk) of a pool of 5 slots: the TF32 walk's
    windows start on 16-byte boundaries (the pool's base is 16-byte
    aligned), at most one window below the chunk's first element, cover
    every wanted byte with bytes they read, land the chunk in a shared row
    of the plan's pitch, read nothing past the pool's last byte, and are
    at most one more than the chunk's whole 16-byte chunks; the pool's
    last row, where the row's bytes are not a multiple of 16, ends
    mid-window and its last window reads only what remains."""
    item = 4 if dtype == "float32" else 2
    plan = da.walk_plan(width, 1, {"float32": F32, "bfloat16": BF16}[dtype])
    window = 16 // item
    n_slots = 5
    total = n_slots * page * width
    rows = torch.arange(n_slots * page)
    for col0 in range(0, width, 64):
        n = min(64, width - col0)
        e0 = rows * width + col0
        base, nwin, nbytes = da.walk_windows(rows * width, col0, n, item,
                                             total)
        assert bool((base * item % 16 == 0).all())
        assert bool(((base <= e0) & (e0 < base + window)).all())
        assert bool((e0 - base + 64 <= min(plan.k_pitch,
                                             plan.v_pitch)).all())
        assert bool((nwin <= -(-n // window) + 1).all())
        assert bool((base + nwin * window >= e0 + n).all())   # covers
        assert bool(((e0 + n - base) * item <= nbytes).all())  # all read
        assert bool((base * item + nbytes <= total * item).all())
        assert bool((nbytes <= 16 * nwin).all())
        # every window but the pool's last reads its 16 bytes
        inside = base + nwin * window <= total
        assert bool((nbytes[inside] == 16 * nwin[inside]).all())
    last = da.walk_windows(torch.tensor([total - 1]), 0, 1, item, total)[2]
    assert int(last[0]) == 16 - (-total * item) % 16
    # a row the copier zero-fills reads nothing
    assert int(da.walk_windows(torch.tensor([-1]), 0, 64, item,
                               total)[2][0]) == 0


# the tensor-core walk's plans by hand: (k_chunks, groups, group_cols,
# v_chunks, q_resident, entry_rows, smem_bytes).  Shared memory: a ring
# of 8 entries of 64 token rows (80 with Q's 16 rows) x 144 bytes (64
# columns + 8 of padding), P 16 x 144 bytes, the warps' maxima 8 x 16 x 4
# bytes, and Q 16 x (64 k_chunks + 8) x 2 bytes where all of it fits in
# an H100 block's 232,448 bytes
WALK_TC_PLANS = {
    # 73,728 + 2,304 + 512 + 33,024 (Q 1032 wide); one group, so every K
    # and V byte of a (row, head chunk) is read once
    (1024, 1024): (16, 1, 1024, 16, True, 64, 109568),
    (640, 512): (10, 1, 512, 8, True, 64, 97280),        # Q 648 wide
    (576, 640): (9, 1, 640, 10, True, 64, 95232),        # Q 584 wide
    # Q 4104 wide (131,328 bytes); four groups of 1024 value columns,
    # each reading K again
    (4096, 4096): (64, 4, 1024, 16, True, 64, 207872),
    # ragged chunks: d's last chunk 40 columns, dv's 24
    (1000, 600): (16, 1, 600, 10, True, 64, 109568),
    # Q 4936 wide would take 157,952 bytes: it rides in the K entries
    (4928, 520): (77, 1, 520, 9, False, 80, 94976),
}


@pytest.mark.parametrize("d,dv", list(WALK_TC_PLANS))
def test_decode_walk_tc_plan_matches_the_hand_counts(d, dv):
    """``walk_tc_plan`` at the issue's widths: chunks, groups, Q's place,
    stages and shared memory as counted by hand, within an H100 block's
    232,448 bytes and adding up; the blocks a (row, head chunk, split)
    and the split count at (1024, 1024) x 8 rows x 16 heads over 256
    pages on 132 SMs of two blocks each; the K and V bytes read: each
    exactly once at (1024, 1024) with 16 heads, K once a group past
    1024 value columns, both again for each chunk of 16 heads."""
    plan = da.walk_tc_plan(d, dv)
    assert (plan.k_chunks, plan.groups, plan.group_cols, plan.v_chunks,
            plan.q_resident, plan.entry_rows, plan.smem_bytes) \
        == WALK_TC_PLANS[d, dv]
    assert (plan.tile, plan.chunk, plan.stages) == (64, 64, 8)
    assert plan.smem_bytes <= da.SMEM_LIMIT == 232448
    q_bytes = 16 * (64 * plan.k_chunks + 8) * 2 if plan.q_resident else 0
    assert plan.smem_bytes == 8 * plan.entry_rows * 144 + 16 * 144 \
        + 8 * 16 * 4 + q_bytes
    if not plan.q_resident:             # Q streams only where it must
        assert 8 * 64 * 144 + 16 * 144 + 8 * 16 * 4 \
            + 16 * (64 * plan.k_chunks + 8) * 2 > da.SMEM_LIMIT
    inst = ("walk_tc", d, dv)
    assert da.value_groups(inst) == plan.groups == -(-dv // 1024)
    tokens = 4096
    k_bytes, v_bytes = plan.reads(d, dv, 16, tokens)
    assert v_bytes == 2 * tokens * dv
    assert k_bytes == 2 * tokens * d * plan.groups
    assert plan.reads(d, dv, 20, tokens) == (2 * k_bytes, 2 * v_bytes)
    if (d, dv) == (1024, 1024):
        assert (k_bytes, v_bytes) == (2 * tokens * d, 2 * tokens * dv)
        n = da.plan_splits(8 * 1 * plan.groups, 256, 132, 2)
        assert n == 32 and 8 * 1 * plan.groups * n == 256   # blocks


def decode_wg_replay(q, kp, vp, pt, lens, n_splits: int):
    """The wgmma route's arithmetic in float64 (``csrc/decode_attention.cu``
    route 5 and the merge), on ``wg_plan``: blocks of ``heads`` query
    heads; each split's tokens in tiles of ``tile``; a tile's scores Q K^T
    summed over d's boxes in order (64 columns each, zero past d), as each
    consumer group forms the whole S; the running max and sum (of P
    unrounded), P rounded to bf16 before P V; the splits merged in
    order."""
    B, H, d = q.shape
    page, dv = kp.shape[1], vp.shape[2]
    P = pt.shape[1]
    plan = da.wg_plan(d, dv)
    per = -(-P // n_splits)
    width = 64 * plan.k_boxes
    box = lambda a, j: a[:, 64 * j:64 * j + 64]   # noqa: E731
    q, kp, vp = (a.astype(np.float64) for a in (q, kp, vp))
    out = np.zeros((B, H, dv))
    for b in range(B):
        n_pages = min(P, -(-int(lens[b]) // page)) if lens[b] > 0 else 0
        Qb = np.pad(q[b], ((0, 0), (0, width - d)))
        for h0 in range(0, H, plan.heads):
            Q = Qb[h0:h0 + plan.heads]
            n = len(Q)
            parts = []
            for sp in range(0, P, per):
                toks = [(pt[b, pi], t)
                        for pi in range(sp, min(sp + per, n_pages))
                        for t in range(min(page, int(lens[b]) - pi * page))]
                m, l, acc = np.full(n, -1e30), np.zeros(n), np.zeros((n, dv))
                for t0 in range(0, len(toks), plan.tile):
                    tile = toks[t0:t0 + plan.tile]
                    K = np.pad(np.stack([kp[sl, t] for sl, t in tile]),
                               ((0, 0), (0, width - d)))
                    V = np.stack([vp[sl, t] for sl, t in tile])
                    s = sum(box(Q, j) @ box(K, j).T
                            for j in range(plan.k_boxes)) / math.sqrt(d)
                    mn = np.maximum(m, s.max(axis=1))
                    alpha, p = np.exp(m - mn), np.exp(s - mn[:, None])
                    l = l * alpha + p.sum(axis=1)
                    acc = acc * alpha[:, None] + _bf16(p) @ V
                    m = mn
                parts.append((m, l, acc))
            M = np.max([pm for pm, _, _ in parts], axis=0)
            L = sum(pl * np.exp(pm - M) for pm, pl, _ in parts)
            A = sum(pa * np.exp(pm - M)[:, None] for pm, _, pa in parts)
            out[b, h0:h0 + n] = A / np.maximum(L, 1e-30)[:, None]
    return out


def _bf16_decode_case(B, H, d, dv, page, P, lens, seed):
    """bf16 values (as float32 numpy arrays) of a pool of B * P + 2 pages,
    each row's pages distinct random slots (valid past its length too, as
    the JAX kernel's index maps read them), the given lengths, and the JAX
    kernel's output in interpret mode."""
    from repro.kernels.decode_attention.ops import \
        paged_decode_attention as j_decode
    q, kp, vp, pt, _ = (t.numpy() for t in _decode_case(B, H, d, dv, page,
                                                         P, seed=seed))
    lens = np.asarray(lens, np.int32)
    q, kp, vp = (np.array(jnp.asarray(a).astype(jnp.bfloat16), np.float32)
                 for a in (q, kp, vp))
    ref = np.asarray(j_decode(*(jnp.asarray(a).astype(jnp.bfloat16)
                                for a in (q, kp, vp)),
                              jnp.asarray(pt), jnp.asarray(lens)),
                     np.float32)
    return q, kp, vp, pt, lens, ref


# (d, dv, H, page, P, n_splits): MLA's latent at 128 heads and at 70 (a
# second block of 6), widths route 1's (576, 512) instance once covered;
# rows of length 0, 1 and ragged (several tiles, a last one short)
WG_REPLAY = [(576, 512, 128, 7, 20, 3), (576, 512, 70, 16, 9, 2),
             (264, 256, 70, 8, 12, 1), (320, 512, 128, 16, 9, 4)]


@pytest.mark.parametrize("d,dv,H,page,P,n_splits", WG_REPLAY)
def test_decode_wg_replay_equals_the_jax_kernel(d, dv, H, page, P,
                                                n_splits):
    """Route 5's schedule replayed in float64 on bf16 inputs (64-head
    blocks, 64-token tiles, S summed over d's boxes in order, P rounded
    to bf16 with l unrounded, then the split partials and the merge)
    against the Pallas kernel in interpret mode and the port's plain
    version, within the bf16 tolerance; the route that runs these widths
    is route 5 at every head count."""
    lens = (0, 1, P * page - page // 2 - 3)
    q, kp, vp, pt, lens, ref = _bf16_decode_case(3, H, d, dv, page, P,
                                                 lens, seed=d + H)
    assert da.instance(d, dv, BF16, H) == ("wgmma", d, dv)
    got = decode_wg_replay(q, kp, vp, pt, lens, n_splits)
    assert_close(got.astype(np.float32), ref, "bfloat16")
    assert np.abs(got[1:]).max() > 0           # the check has something
    assert np.abs(got[0]).max() == 0           # a row of length 0: zeros
    plain = da.paged_decode_plain(*(torch.from_numpy(a).to(BF16)
                                    for a in (q, kp, vp)),
                                  torch.from_numpy(pt),
                                  torch.from_numpy(lens))
    assert_close(to_np(plain), ref, "bfloat16")


# route 5's plans by hand: (k_boxes, v_boxes, stages, smem_bytes).  Shared
# memory: 1,536 bytes of slack and mbarriers and Q's boxes of 8 KB, then
# 8 KB stages, as many as fit in 232,448 bytes, at most 24
WG_PLANS = {
    # 75,264 fixed; 19 stages (a tile is 17 boxes): 230,912
    (576, 512): (9, 8, 19, 230912),
    (576, 8): (9, 1, 19, 230912),
    # 42,496 fixed; 23 fit
    (264, 256): (5, 4, 23, 230912),
    (320, 512): (5, 8, 23, 230912),
    # 34,304 fixed; 24 fit, the most
    (200, 304): (4, 5, 24, 230912),
    # 9,728 fixed; 27 would fit, 24 kept
    (64, 264): (1, 5, 24, 206336),
}


@pytest.mark.parametrize("d,dv", list(WG_PLANS))
def test_decode_wg_plan_matches_the_hand_counts(d, dv):
    """``wg_plan`` at route 5's widths: Q's boxes and V's, the stages and
    shared memory as counted by hand, within an H100 block's 232,448 bytes
    and adding up, as many stages as fit and a whole tile's boxes at
    least; the K and V bytes asked for, once a (row, 64 heads): once at 64
    heads, twice at 65 and at 128 (blocks of 16 heads: 8 times at 128),
    and the split counts at MLA's latent, 8 rows x 128 heads over 64
    pages, one block an SM."""
    plan = da.wg_plan(d, dv)
    assert (plan.k_boxes, plan.v_boxes, plan.stages, plan.smem_bytes) \
        == WG_PLANS[d, dv]
    assert (plan.heads, plan.tile, plan.q_resident) == (64, 64, True)
    fixed = 1536 + 8192 * plan.k_boxes
    assert plan.smem_bytes == fixed + 8192 * plan.stages <= da.SMEM_LIMIT
    assert plan.stages == 24 or fixed + 8192 * (plan.stages + 1) \
        > da.SMEM_LIMIT
    assert plan.stages >= plan.k_boxes + plan.v_boxes   # a tile fits
    tokens = 4096
    once = (2 * tokens * d, 2 * tokens * dv)
    assert plan.reads(d, dv, 64, tokens) == once
    for H in (65, 128):
        assert plan.reads(d, dv, H, tokens) == (2 * once[0], 2 * once[1])
    assert da.value_groups(("wgmma", d, dv)) == 1
    if (d, dv) == (576, 512):
        # the default planner gives every SM a block: 16 splits, 256
        # blocks in two waves; route 5's (``busy`` 0.9): 8, one wave of
        # 128 blocks on 132 SMs, half the partials
        assert da.plan_splits(8 * 2, 64, 132, 1) == 16
        assert da.plan_splits(8 * 2, 64, 132, 1, da.SPLIT_WAVE_SHARE) == 8


@pytest.mark.parametrize("d,dv", [(576, 512), (8, 512), (576, 8),
                                  (512, 512), (264, 256)])
def test_decode_wg_plan_holds_a_tile_at_every_width(d, dv):
    """Every width route 5 takes (d up to 576, dv up to 512) leaves room
    for a whole tile's boxes in the ring, which its protocol needs (no
    wait on a stage the waiting group itself holds)."""
    plan = da.wg_plan(d, dv)
    assert plan.stages >= plan.k_boxes + plan.v_boxes
    assert plan.smem_bytes <= da.SMEM_LIMIT


def _wg_walk(d, dv, n_tiles):
    """Route 5's ring protocol: one ring, a tile's entries K_j for d's
    boxes, then V_c for dv's; both groups wait for every entry in order
    and release each once: a K entry when the next product is issued (the
    last after the scores), the other group's V entries as they land, the
    group's own (V_c with c = g mod 2) after its sums."""
    p = da.wg_plan(d, dv)
    na, nb = p.k_boxes, p.v_boxes
    E = na + nb
    order = [(0, i) for i in range(n_tiles * E)]
    walks = []
    for g in (0, 1):
        acts = []
        for kt in range(n_tiles):
            base = kt * E
            for j in range(na):
                acts.append(("wait", base + j))
                if j > 0:
                    acts.append(("rel", base + j - 1))
            acts.append(("rel", base + na - 1))
            mine = []
            for c in range(nb):
                acts.append(("wait", base + na + c))
                if c % 2 == g:
                    mine.append(base + na + c)
                else:
                    acts.append(("rel", base + na + c))
            acts += [("rel", e) for e in mine]
        walks.append(acts)
    return order, walks, [p.stages], 2


@pytest.mark.parametrize("d,dv", list(WG_PLANS) + [(8, 512), (576, 264)])
def test_decode_wg_ring_never_deadlocks_or_reads_a_stale_stage(d, dv):
    """Route 5's stage protocol replayed at 1-4 tiles: no wait that can
    never end, no wait two phases ahead of its stage, every stage
    released once by each of the two groups."""
    for n in (1, 2, 3, 4):
        assert _ring_run(*_wg_walk(d, dv, n)) is None, n


@pytest.mark.parametrize("d,dv,dtype,H,n_splits", [
    (576, 512, "float32", 20, 2), (256, 256, "float32", 5, 1),
    (100, 60, "bfloat16", 20, 3), (300, 100, "float32", 33, 2)])
def test_decode_walk_replay_at_many_heads_equals_the_jax_kernel(
        d, dv, dtype, H, n_splits):
    """Route 3 up to (576, 512) past 4 heads a row, where it takes the
    lanes' widths: the TF32 walk's schedule replayed in
    float64 against the Pallas kernel in interpret mode within the type's
    tolerance (fp32: three products of split operands; bf16 rows that are
    not whole 16-byte chunks: one, P rounded to TF32), on that route."""
    from repro.kernels.decode_attention.ops import \
        paged_decode_attention as j_decode
    tdt = {"float32": F32, "bfloat16": BF16}[dtype]
    assert da.instance(d, dv, tdt, H) == ("walk", d, dv)
    q, kp, vp, pt, lens = (t.numpy() for t in _decode_case(2, H, d, dv, 8,
                                                            5, seed=H))
    lens = np.maximum(lens, 1).astype(np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, kp, vp = (np.array(jnp.asarray(a).astype(jdt), np.float32)
                 for a in (q, kp, vp))
    ref = np.asarray(j_decode(*(jnp.asarray(a).astype(jdt)
                                for a in (q, kp, vp)),
                              jnp.asarray(pt), jnp.asarray(lens)),
                     np.float32)
    got = decode_walk_replay(q, kp, vp, pt, lens, n_splits, dtype)
    assert_close(got.astype(np.float32), ref, dtype)


def _decode_case(B, H, d, dv, page, P, seed=0):
    rng = np.random.RandomState(seed)
    slots = B * P + 2
    q = torch.from_numpy(rng.randn(B, H, d).astype(np.float32))
    kp = torch.from_numpy(rng.randn(slots, page, d).astype(np.float32))
    vp = torch.from_numpy(rng.randn(slots, page, dv).astype(np.float32))
    pt = torch.from_numpy(rng.permutation(slots)[:B * P].reshape(B, P)
                          .astype(np.int32))
    lens = torch.from_numpy(rng.randint(0, P * page + 1, B).astype(np.int32))
    return q, kp, vp, pt, lens


@pytest.mark.parametrize("d,dv", [(96, 96), (40, 24), (200, 64)])
def test_decode_padded_q_with_the_callers_scale_is_the_callers_attention(
        d, dv):
    """The tensor-core route zero-pads q (never the pool) to the
    instance's DK and scores with 1/sqrt(d): the plain version on q and
    the pool's keys padded alike, with that scale, equals the caller's."""
    q, kp, vp, pt, lens = _decode_case(3, 4, d, dv, 8, 3)
    _, DK, _ = da.instance(d, dv, BF16)
    want = da.paged_decode_plain(q, kp, vp, pt, lens)
    pad = torch.nn.functional.pad
    got = da.paged_decode_plain(pad(q, (0, DK - d)), pad(kp, (0, DK - d)),
                                vp, pt, lens)   # scaled by 1/sqrt(DK)
    assert not torch.allclose(got, want, atol=1e-3)
    qs = pad(q, (0, DK - d)) * math.sqrt(DK / d)   # 1/sqrt(d) in effect
    got = da.paged_decode_plain(qs, pad(kp, (0, DK - d)), vp, pt, lens)
    assert_close(got.numpy(), want.numpy())


# ------------------------------------------------------ K6 covering pairs
@pytest.mark.parametrize("d,dv,want", [
    (80, 80, (80, 80)), (192, 128, (192, 128)), (24, 16, (24, 16)),
    (96, 96, (128, 128)), (48, 40, (64, 64)), (100, 60, (128, 128)),
    (40, 40, (64, 64)), (24, 24, (32, 32)), (20, 16, (24, 16)),
    (1, 1, (8, 8)), (160, 128, (192, 128)), (200, 100, (256, 256)),
    (256, 1, (256, 256))])
def test_flash_cover_pair_is_the_least_padded_instance(d, dv, want):
    pair = fa.cover_pair(d, dv)
    assert pair == want and pair in fa.PAIRS
    fits = [p for p in fa.PAIRS if p[0] >= d and p[1] >= dv]
    assert sum(pair) == min(map(sum, fits))


@pytest.mark.parametrize("d,dv", [(257, 64), (64, 257), (0, 8), (8, 0),
                                  (320, 320), (512, 512), (288, 512),
                                  (512, 128), (1024, 1024), (1, 1024)])
def test_flash_cover_pair_refuses_past_256(d, dv):
    """No pair covers a width past 256, where the wrapper refused until PR
    29: ``cover_pair`` gives None and the wide kernel runs the caller's
    (d, dv) unpadded.  A width below 1 is still refused."""
    if d < 1 or dv < 1:
        with pytest.raises(ValueError, match=">= 1"):
            fa.cover_pair(d, dv)
        return
    assert fa.cover_pair(d, dv) is None and fa.is_wide(d, dv)
    assert not fa.is_wide(min(d, 256), min(dv, 256))


def wide_fwd_replay_fp32(q, k, v, causal):
    """``csrc/flash_attention_wide.cu``'s float32 forward (the CUDA cores)
    in float64: a block of 32 query rows a (batch row, head, group of
    ``WIDE_GROUP`` value columns), key tiles of 64 up to the diagonal,
    each tile's scores summed over slabs of 32 key-width columns, the
    online softmax, then P V over the group's columns.  Returns (out, lse
    [B, H, S])."""
    B, S, H, d = q.shape
    T, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    G, scale = H // KV, 1 / math.sqrt(d)
    q, k, v = (a.astype(np.float64) for a in (q, k, v))
    out, lse = np.zeros((B, S, H, dv)), np.zeros((B, H, S))
    for b in range(B):
        for h in range(H):
            for q0 in range(0, S, 32):
                Q = q[b, q0:q0 + 32, h]
                pos = q0 + np.arange(len(Q))
                for v0 in range(0, dv, fa.WIDE_GROUP):
                    V = v[b, :, h // G, v0:v0 + fa.WIDE_GROUP]
                    m = np.full(len(Q), -1e30)
                    l, O = np.zeros(len(Q)), np.zeros((len(Q), V.shape[1]))
                    end = min(T, q0 + 32) if causal else T
                    for k0 in range(0, end, 64):
                        K = k[b, k0:min(k0 + 64, T), h // G]
                        s = sum(Q[:, c:c + 32] @ K[:, c:c + 32].T
                                for c in range(0, d, 32))
                        keys = k0 + np.arange(len(K))
                        ok = (keys[None, :] <= pos[:, None]) | (not causal)
                        s = np.where(ok, s * scale, -np.inf)
                        mn = np.maximum(m, s.max(axis=1))
                        p = np.where(ok, np.exp(s - mn[:, None]), 0.0)
                        alpha = np.exp(m - mn)
                        l = l * alpha + p.sum(axis=1)
                        O = O * alpha[:, None] + p @ V[k0:k0 + len(K)]
                        m = mn
                    out[b, q0:q0 + 32, h, v0:v0 + V.shape[1]] = O / l[:, None]
                    lse[b, h, q0:q0 + 32] = m + np.log(l)
    return out, lse


def _bf16(a):
    """``a`` rounded to bfloat16 (to nearest even), as float64."""
    return torch.from_numpy(np.asarray(a, np.float64)).to(BF16) \
        .double().numpy()


def _boxes(a, n):
    """``a`` [..., w] zero-padded to ``n`` 64-column boxes (what TMA
    brings past the width), as float64."""
    a = np.asarray(a, np.float64)
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, 64 * n - a.shape[-1])])


def wide_fwd_replay_bf16(q, k, v, causal):
    """``csrc/flash_attention_wide.cu``'s bf16 forward (wgmma) in float64,
    on ``wide_plan(.., "fwd")``: a block of 64 query rows a (batch row,
    head, value piece), key tiles of 64 up to the diagonal; each tile's S
    summed over d's 64-column boxes (zero columns past d) by the two
    groups, boxes j = 0 and 1 mod 2, and the two partial S added; the
    online softmax; P rounded to bf16 before P V (the row sum of P
    unrounded), each group P V over alternate boxes of the piece.
    Returns (out, lse [B, H, S])."""
    B, S, H, d = q.shape
    T, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    G, scale = H // KV, 1 / math.sqrt(d)
    plan = fa.wide_plan(*fa.wide_pair(d, dv, BF16), "fwd")
    (na, nb), pb = plan.boxes, plan.piece_boxes[1]
    q, k, v = _boxes(q, na), _boxes(k, na), _boxes(v, nb)
    out, lse = np.zeros((B, S, H, 64 * nb)), np.zeros((B, H, S))
    for b in range(B):
        for h in range(H):
            for q0 in range(0, S, 64):
                Q = q[b, q0:q0 + 64, h]
                pos = q0 + np.arange(len(Q))
                for piece in range(plan.pieces):
                    p0 = min(piece * pb, nb)
                    cols = slice(64 * p0, 64 * min(p0 + pb, nb))
                    m = np.full(len(Q), -np.inf)
                    l = np.zeros(len(Q))
                    O = np.zeros((len(Q), cols.stop - cols.start))
                    for k0 in range(0, min(T, q0 + 64) if causal else T, 64):
                        K = k[b, k0:k0 + 64, h // G]
                        part = [sum(Q[:, 64 * j:64 * j + 64]
                                    @ K[:, 64 * j:64 * j + 64].T
                                    for j in range(g, na, 2))
                                for g in (0, 1)]
                        s = part[0] + part[1]
                        keys = k0 + np.arange(len(K))
                        ok = (keys[None, :] <= pos[:, None]) | (not causal)
                        s = np.where(ok, s * scale, -np.inf)
                        mn = np.maximum(m, s.max(axis=1))
                        p = np.where(ok, np.exp(s - mn[:, None]), 0.0)
                        alpha = np.exp(m - mn)
                        l = l * alpha + p.sum(axis=1)
                        O = O * alpha[:, None] \
                            + _bf16(p) @ v[b, k0:k0 + len(K), h // G, cols]
                        m = mn
                    out[b, q0:q0 + 64, h, cols] = O / l[:, None]
                    if piece == 0:
                        lse[b, h, q0:q0 + 64] = m + np.log(l)
    return out[..., :dv], lse


WIDE_REPLAY = {"bf16": (wide_fwd_replay_bf16, "bfloat16"),
               "fp32": (wide_fwd_replay_fp32, "float32")}


@pytest.mark.parametrize("schedule", ["bf16", "fp32"])
@pytest.mark.parametrize("d,dv,S,H,KV", [
    (288, 512, 64, 4, 2), (520, 600, 64, 4, 2), (257, 64, 64, 4, 2),
    (576, 512, 70, 16, 1)])                 # MLA's absorbed width, G 16
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wide_replay_equals_the_jax_kernel(d, dv, S, H, KV, causal,
                                                 schedule):
    """The wide forward's schedule, replayed in float64: bf16's (wgmma:
    64-row blocks, d's boxes in two halves with partial S summed, P
    rounded to bf16, value pieces; two pieces at dv 600; (257, 64) on its
    padded (264, 64)) on bf16 inputs within the bf16 tolerance, fp32's
    (CUDA cores: 32-row blocks, slabs, value groups) within fp32's;
    against the Pallas kernel in interpret mode and the port's plain
    version; lse against the scores' logsumexp."""
    from repro.kernels.flash_attention.ops import \
        flash_attention as j_flash
    replay, tol = WIDE_REPLAY[schedule]
    q, k, v = (t.numpy() for t in _flash_inputs(1, S, S, H, KV, d, dv,
                                                 seed=d + dv))
    if schedule == "bf16":
        q, k, v = (_bf16(a).astype(np.float32) for a in (q, k, v))
    blk = 32 if S % 32 == 0 else S // 2
    ref = np.asarray(j_flash(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=causal, bq=blk, bk=blk))
    got, lse = replay(q, k, v, causal)
    assert_close(got.astype(np.float32), ref, tol)
    plain = fa.flash_attention_plain(*(torch.from_numpy(a)
                                       for a in (q, k, v)), causal)
    assert_close(plain.numpy(), ref)
    s = np.einsum("bshd,bthd->bhst", q.astype(np.float64),
                  np.repeat(k, H // KV, axis=2).astype(np.float64)) \
        / math.sqrt(d)
    if causal:
        s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    np.testing.assert_allclose(lse, np.logaddexp.reduce(s, axis=-1),
                               rtol=1e-10, atol=1e-10)


def wide_bwd_replay_fp32(q, k, v, do, causal):
    """``csrc/flash_attention_wide.cu``'s float32 backward (the CUDA
    cores) in float64: dK/dV blocks of 32 keys walking the G query heads
    and their query tiles of 32 from the first that sees the keys, dQ
    blocks of 32 query rows walking the key tiles to the diagonal; each
    32 x 32 tile forms S (key width in slabs of 32), P from lse, dP (value
    width in slabs of 32), dS = P (dP - D), and adds into the block's own
    rows 64 columns at a time.  lse and D as the forward and the D kernel
    give them."""
    B, S, H, d = q.shape
    T, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    G, scale = H // KV, 1 / math.sqrt(d)
    q, k, v, do = (a.astype(np.float64) for a in (q, k, v, do))
    o, lse = wide_fwd_replay_fp32(q, k, v, causal)
    D = np.einsum("bshd,bshd->bhs", do, o)
    dq, dk, dvv = np.zeros(q.shape), np.zeros(k.shape), np.zeros(v.shape)

    def tile(b, h, q0, k0):
        Q, dO = q[b, q0:q0 + 32, h], do[b, q0:q0 + 32, h]
        K, V = k[b, k0:k0 + 32, h // G], v[b, k0:k0 + 32, h // G]
        s = sum(Q[:, c:c + 32] @ K[:, c:c + 32].T for c in range(0, d, 32))
        dp = sum(dO[:, c:c + 32] @ V[:, c:c + 32].T
                 for c in range(0, dv, 32))
        pos, keys = q0 + np.arange(len(Q)), k0 + np.arange(len(K))
        ok = (keys[None, :] <= pos[:, None]) | (not causal)
        p = np.where(ok, np.exp(s * scale - lse[b, h, pos][:, None]), 0.0)
        return Q, dO, K, p, p * (dp - D[b, h, pos][:, None])

    for b in range(B):
        for kvh in range(KV):
            for k0 in range(0, T, 32):
                for h in range(kvh * G, kvh * G + G):
                    for q0 in range(k0 if causal else 0, S, 32):
                        Q, dO, _, p, ds = tile(b, h, q0, k0)
                        for c in range(0, dv, 64):
                            dvv[b, k0:k0 + 32, kvh, c:c + 64] += \
                                p.T @ dO[:, c:c + 64]
                        for c in range(0, d, 64):
                            dk[b, k0:k0 + 32, kvh, c:c + 64] += \
                                scale * (ds.T @ Q[:, c:c + 64])
        for h in range(H):
            for q0 in range(0, S, 32):
                for k0 in range(0, min(T, q0 + 32) if causal else T, 32):
                    _, _, K, _, ds = tile(b, h, q0, k0)
                    for c in range(0, d, 64):
                        dq[b, q0:q0 + 32, h, c:c + 64] += \
                            scale * (ds @ K[:, c:c + 64])
    return dq, dk, dvv


def wide_bwd_replay_bf16(q, k, v, do, causal):
    """``csrc/flash_attention_wide.cu``'s bf16 backward (wgmma) in
    float64, on ``wide_plan``'s dK/dV and dQ plans.  lse and the output
    (rounded to bf16, as the forward writes it) from the bf16 forward
    replay, D = rowsum(dO o).  dK/dV: a block of 64 keys a (batch row, KV
    head, piece) walks the G query heads and their query tiles of 64 from
    the first that sees its keys; each tile's S^T over d's boxes and dP^T
    over dv's (zero columns past the widths), P^T from lse, dS^T = P^T
    (dP^T - D); dV += bf16(P^T) dO over its dV piece's boxes, dK +=
    bf16(dS^T) Q scale over its dK piece's.  dQ: a block of 64 queries a
    (batch row, head, piece) walks the key tiles to the diagonal, forms S
    and dP again, and adds bf16(dS) K scale into the piece's boxes, split
    between the two groups (``wide_dq_split``)."""
    B, S, H, d = q.shape
    T, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    G, scale = H // KV, 1 / math.sqrt(d)
    pd, pdv = fa.wide_pair(d, dv, BF16)
    kv, qp = fa.wide_plan(pd, pdv, "dkdv"), fa.wide_plan(pd, pdv, "dq")
    na, nb = kv.boxes
    o, lse = wide_fwd_replay_bf16(q, k, v, causal)
    D = np.einsum("bshd,bshd->bhs", np.asarray(do, np.float64), _bf16(o))
    q, k, v, do = _boxes(q, na), _boxes(k, na), _boxes(v, nb), \
        _boxes(do, nb)
    dq, dk, dvv = (np.zeros(a.shape) for a in (q, k, v))

    def tile(b, h, q0, k0):
        """S, dS [queries, keys] of one tile."""
        Q, dO = q[b, q0:q0 + 64, h], do[b, q0:q0 + 64, h]
        K, V = k[b, k0:k0 + 64, h // G], v[b, k0:k0 + 64, h // G]
        s = sum(Q[:, 64 * j:64 * j + 64] @ K[:, 64 * j:64 * j + 64].T
                for j in range(na))
        dp = sum(dO[:, 64 * j:64 * j + 64] @ V[:, 64 * j:64 * j + 64].T
                 for j in range(nb))
        pos, keys = q0 + np.arange(len(Q)), k0 + np.arange(len(K))
        ok = (keys[None, :] <= pos[:, None]) | (not causal)
        p = np.where(ok, np.exp(s * scale - lse[b, h, pos][:, None]), 0.0)
        return p, p * (dp - D[b, h, pos][:, None])

    def cols(j0, j1):
        return slice(64 * j0, 64 * j1)

    for b in range(B):
        for kvh in range(KV):
            for k0 in range(0, T, 64):
                for piece in range(kv.pieces):
                    a0 = min(piece * kv.piece_boxes[0], na)
                    a1 = min(a0 + kv.piece_boxes[0], na)
                    b0 = min(piece * kv.piece_boxes[1], nb)
                    b1 = min(b0 + kv.piece_boxes[1], nb)
                    for h in range(kvh * G, kvh * G + G):
                        for q0 in range(k0 if causal else 0, S, 64):
                            p, ds = tile(b, h, q0, k0)
                            rows = slice(k0, k0 + p.shape[1])
                            dvv[b, rows, kvh, cols(b0, b1)] += \
                                _bf16(p).T @ do[b, q0:q0 + 64, h, cols(b0, b1)]
                            dk[b, rows, kvh, cols(a0, a1)] += scale * (
                                _bf16(ds).T @ q[b, q0:q0 + 64, h, cols(a0, a1)])
        for h in range(H):
            for q0 in range(0, S, 64):
                for piece in range(qp.pieces):
                    a0 = min(piece * qp.piece_boxes[0], na)
                    a1 = min(a0 + qp.piece_boxes[0], na)
                    n0 = fa.wide_dq_split(a1 - a0, na, nb)
                    for k0 in range(0, min(T, q0 + 64) if causal else T, 64):
                        _, ds = tile(b, h, q0, k0)
                        K = k[b, k0:k0 + 64, h // G]
                        for j0, j1 in ((a0, a0 + n0), (a0 + n0, a1)):
                            dq[b, q0:q0 + 64, h, cols(j0, j1)] += scale * (
                                _bf16(ds) @ K[:, cols(j0, j1)])
    return dq[..., :d], dk[..., :d], dvv[..., :dv]


@pytest.mark.parametrize("schedule", ["bf16", "fp32"])
@pytest.mark.parametrize("d,dv,S,H,KV", [
    (288, 512, 70, 4, 2), (320, 96, 40, 4, 2),
    (576, 512, 70, 16, 1)])                 # MLA's absorbed width, G 16
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wide_backward_replay_equals_the_reference_gradient(
        d, dv, S, H, KV, causal, schedule):
    """The wide backward's schedule (ragged S, G query heads a KV head),
    replayed in float64: bf16's (wgmma: 64-row tiles, d's and dv's boxes,
    the dK/dV and dQ pieces, P and dS rounded to bf16 before the sums) on
    bf16 inputs within the bf16 tolerance, fp32's (CUDA cores: 32 x 32
    tiles, slabs) within 1e-4; against ``jax.vjp`` of the Pallas kernel's
    oracle, and the port's plain backward within 1e-4."""
    from repro.kernels.flash_attention.ref import attention_ref
    rng = np.random.RandomState(d + S)
    q, k, v, do = (rng.randn(*sh).astype(np.float32) for sh in (
        (1, S, H, d), (1, S, KV, d), (1, S, KV, dv), (1, S, H, dv)))
    if schedule == "bf16":
        q, k, v, do = (_bf16(a).astype(np.float32) for a in (q, k, v, do))
    G = H // KV

    def ref_attention(q, k, v):
        qf, kf, vf = (jnp.repeat(a.transpose(0, 2, 1, 3), r, axis=1)
                      .reshape(H, S, -1) for a, r in ((q, 1), (k, G), (v, G)))
        o = attention_ref(qf, kf, vf, causal=causal)
        return o.reshape(1, H, S, -1).transpose(0, 2, 1, 3)
    _, vjp = jax.vjp(ref_attention, *(jnp.asarray(a) for a in (q, k, v)))
    ref = vjp(jnp.asarray(do))
    replay = wide_bwd_replay_bf16 if schedule == "bf16" \
        else wide_bwd_replay_fp32
    rel = 2e-2 if schedule == "bf16" else 1e-4
    got = replay(q, k, v, do, causal)
    plain = fa.flash_attention_backward_plain(
        *(torch.from_numpy(a) for a in (q, k, v, do)), causal)
    for a, b, c, name in zip(got, ref, plain, ("dq", "dk", "dv")):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=rel,
                                   atol=rel * np.abs(b).max(), err_msg=name)
        np.testing.assert_allclose(c.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(), err_msg=name)


# the bf16 wide kernels' plans by hand: (pieces, piece_boxes, resident,
# stages, smem_bytes) of each kind.  Shared memory: 1536 (alignment,
# mbarriers) + 16 KB an exchange buffer (fwd 2, dkdv 1, dq 2) + the
# backward's entry table (2 bytes an entry, rounded up to 16) + 8 KB a
# resident box + 8 KB a stage; rows resident while the ring keeps 8
# stages (the backward: and two past a step's held entries), stages as
# many as fit up to 24, the forward's even (a ring of half a group).
WIDE_PLANS = {
    # d, dv 8 boxes each; Q (64 KB) resident leaves 16 stages; dK/dV one
    # piece of 4 + 4 boxes a block, 2 blocks, K and V (128 KB) resident
    # with 10 = 8 held + 2 stages; dQ both resident would leave 8 < 10,
    # so dO streams beside V (24 entries, a 48-byte table)
    (512, 512): {"fwd": (1, (0, 8), (1, 0), 16, 230912),
                 "dkdv": (2, (4, 4), (1, 1), 10, 230944),
                 "dq": (1, (8, 0), (1, 0), 16, 230960)},
    # MLA's absorbed width: d 9 boxes (Q 72 KB leaves 15 stages, 14 used),
    # so dK needs 3 pieces of 3 (dV's 8 boxes then 3, 3, 2) and dQ 2
    # pieces of 5 and 4
    (576, 512): {"fwd": (1, (0, 8), (1, 0), 14, 222720),
                 "dkdv": (3, (3, 3), (1, 1), 9, 230960),
                 "dq": (2, (5, 0), (1, 0), 15, 230976)},
    # dv 10 boxes: the forward's two pieces of 5; dK/dV 3 pieces (3 and 4
    # boxes), K resident, V streaming (29 entries)
    (520, 600): {"fwd": (2, (0, 5), (1, 0), 14, 222720),
                 "dkdv": (3, (3, 4), (1, 0), 17, 230976),
                 "dq": (2, (5, 0), (1, 0), 15, 230976)},
    # (257, 64) runs padded to (264, 64): d 5 boxes, dv 1
    (257, 64): {"fwd": (1, (0, 1), (1, 0), 18, 222720),
                "dkdv": (2, (3, 1), (1, 1), 20, 230928),
                "dq": (1, (5, 0), (1, 1), 18, 230928)},
    (512, 128): {"fwd": (1, (0, 2), (1, 0), 16, 230912),
                 "dkdv": (2, (4, 1), (1, 1), 16, 230944),
                 "dq": (1, (8, 0), (1, 1), 14, 230944)},
}
WIDE_SCORE_WORK = {(512, 512): (1, 3, 9), (576, 512): (1, 5, 13),
                   (520, 600): (2, 5, 13), (257, 64): (1, 3, 9),
                   (512, 128): (1, 3, 9)}


@pytest.mark.parametrize("d,dv", list(WIDE_PLANS))
def test_flash_wide_plan_matches_the_hand_counts(d, dv):
    """``wide_plan`` at the widths of the issue's table: each kernel's
    pieces (its blocks a 64-row tile), boxes a piece, resident rows,
    stages and shared memory as counted by hand, every block within an
    H100's 232,448 bytes and the bytes adding up; ``score_work`` the
    forward's pieces and the backward's dK/dV plus dQ pieces (S and dP
    formed, over the two the function needs), and the backward's
    products against the five that suffice."""
    pd, pdv = fa.wide_pair(d, dv, BF16)
    assert (pd, pdv) == ((264, 64) if (d, dv) == (257, 64) else (d, dv))
    for kind, (pieces, pbox, res, stages, smem) in WIDE_PLANS[d, dv].items():
        plan = fa.wide_plan(pd, pdv, kind)
        assert (plan.pieces, plan.piece_boxes, plan.resident, plan.stages,
                plan.smem_bytes) == (pieces, pbox, res, stages, smem), kind
        na, nb = plan.boxes
        assert plan.smem_bytes <= fa.SMEM_LIMIT
        assert plan.smem_bytes == 1536 + plan.xchg * 16384 + plan.table \
            + (res[0] * na + res[1] * nb + stages) * 8192
        assert plan.score_work == pieces
    work = fa.wide_score_work(pd, pdv)
    assert (work["forward"], work["backward"],
            work["backward_products"]) == WIDE_SCORE_WORK[d, dv]


@pytest.mark.parametrize("d,dv", [(257, 64), (300, 100), (64, 260),
                                  (1, 1024)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wide_padded_width_equals_the_callers_attention(d, dv, causal):
    """What the wrapper runs on the card at a bf16 wide width that TMA
    cannot map (rows not whole 16-byte chunks), in plain PyTorch: q, k, v
    zero-padded to ``wide_pair`` (multiples of 8), the caller's scale, the
    output sliced back; equal to the plain version on the caller's
    tensors.  fp32 runs the caller's widths as they are."""
    pair = fa.wide_pair(d, dv, BF16)
    assert pair == (-(-d // 8) * 8, -(-dv // 8) * 8) and fa.is_wide(*pair)
    assert fa.wide_pair(d, dv, F32) == (d, dv)
    q, k, v = _flash_inputs(1, 24, 24, 4, 2, d, dv, seed=d)
    want = fa.flash_attention_plain(q, k, v, causal)
    padded = fa.pad_to_pair(q, k, v, pair)
    got = fa.flash_attention_plain(*padded, causal, 1 / math.sqrt(d))
    assert got.shape[-1] == pair[1]
    assert_close(got[..., :dv].numpy(), want.numpy())


@pytest.mark.parametrize("d,dv", [(512, 512), (288, 512), (1024, 64)])
def test_flash_wide_card_path_books_the_functions_cost_on_meta(d, dv):
    """Meta tensors take the wrapper's card path past 256: no padding,
    the caller's width returned, the forward and (through
    ``FlashAttention``) the backward booked at the caller's (d, dv)."""
    B, S, H = 2, 64, 4
    q, k = (torch.empty((B, S, H, d), device="meta") for _ in range(2))
    v = torch.empty((B, S, H, dv), device="meta")
    booked = []
    with costs.listening(lambda name, fl, by: booked.append((name, fl, by))):
        out = fa.flash_attention_kernel(q, k, v, True)
        assert out.shape == (B, S, H, dv) and out.device.type == "meta"
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention_kernel(*leaves, True)
        grads = torch.autograd.grad(out, leaves, torch.empty_like(out))
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    fwd = costs.flash_fwd(B, S, S, H, H, d, dv, True, 4)
    assert booked == [("flash_attention", *fwd), ("flash_attention", *fwd),
                      ("flash_attention_bwd",
                       *costs.flash_bwd(B, S, S, H, H, d, dv, True, 4))]


def _flash_inputs(B, S, T, H, KV, d, dv, seed=0, dtype=F32):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
            for shape in ((B, S, H, d), (B, T, KV, d), (B, T, KV, dv))]


@pytest.mark.parametrize("d,dv", [(96, 96), (48, 40), (100, 60), (40, 40)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_padded_pair_equals_the_callers_attention(d, dv, causal):
    """What the wrapper runs on the card at an uninstantiated pair, in
    plain PyTorch: q, k, v zero-padded to the covering pair, scores scaled
    by 1/sqrt(d) of the caller's d, the output sliced to dv.  Equal to the
    plain version on the caller's tensors; with the padded width's scale
    it would not be."""
    q, k, v = _flash_inputs(2, 24, 24, 4, 2, d, dv)
    pair = fa.cover_pair(d, dv)
    qp, kp, vp = fa.pad_to_pair(q, k, v, pair)
    assert qp.shape[-1] == kp.shape[-1] == pair[0] and vp.shape[-1] == pair[1]
    want = fa.flash_attention_plain(q, k, v, causal)
    got = fa.flash_attention_plain(qp, kp, vp, causal,
                                   scale=1 / math.sqrt(d))[..., :dv]
    assert_close(got.numpy(), want.numpy())
    wrong = fa.flash_attention_plain(qp, kp, vp, causal)[..., :dv]
    assert not torch.allclose(wrong, want, atol=1e-3)


@pytest.mark.parametrize("d,dv", [(96, 96), (48, 40)])
def test_flash_gradient_through_the_padding_is_the_callers(d, dv):
    """The padding and the slice sit outside ``FlashAttention``: autograd
    through them and the padded pair's attention (the plain version here,
    the pair's backward kernel on the card) gives the caller's gradient;
    the padded columns' gradients are dropped by the slice."""
    q, k, v = _flash_inputs(1, 20, 28, 4, 2, d, dv, seed=3)
    dout = torch.from_numpy(np.random.RandomState(4).randn(1, 20, 4, dv)
                            .astype(np.float32))
    want = fa.flash_attention_backward_plain(q, k, v, dout, False)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_plain(
        *fa.pad_to_pair(*leaves, fa.cover_pair(d, dv)), False,
        scale=1 / math.sqrt(d))[..., :dv]
    got = torch.autograd.grad(out, leaves, dout)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert_close(a.numpy(), b.numpy())


def test_flash_card_path_pads_books_and_slices_on_meta_tensors():
    """Meta tensors take the wrapper's card path: (96, 96) books the
    (128, 128) instance's cost and returns the caller's width."""
    q, k, v = (torch.empty((2, 64, 4, 96), device="meta") for _ in range(3))
    booked = []
    with costs.listening(lambda name, fl, by: booked.append((name, fl, by))):
        out = fa.flash_attention_kernel(q, k, v, True)
    assert out.shape == (2, 64, 4, 96) and out.device.type == "meta"
    want = costs.flash_fwd(2, 64, 64, 4, 4, 128, 128, True, 4)
    assert booked == [("flash_attention", *want)]


# ---------------------------------------------------------- K7 the chunk
@pytest.mark.parametrize("Q,N,dtype,want", [
    (128, 64, BF16, 128), (31, 64, F32, 31), (256, 128, BF16, 128),
    (256, 128, F32, 64), (100, 100, F32, 64), (100, 64, F32, 100),
    (200, 16, F32, 128), (64, 128, F32, 64), (1000, 8, BF16, 128),
    # past one row group bf16 runs the fp32 design, at its chunk there
    (256, 256, BF16, 64), (128, 160, BF16, 64), (256, 256, F32, 64)])
def test_mamba_kernel_chunk(Q, N, dtype, want):
    """The chunk the kernel runs: the caller's up to the cap, 128 (64 in
    fp32 past N 64, where chunk 128's shared memory would pass the
    card's); never past the caller's."""
    assert ms.kernel_chunk(Q, N, dtype) == want
    assert ms.kernel_chunk(Q, N, dtype) <= ms.chunk_cap(N, dtype)


def _mamba_model_inputs(B, S, H, G, N, P, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, S, H))).astype(np.float32)
    A = (-np.exp(rng.randn(B * H) * 0.5)).astype(np.float32)
    Bm = rng.randn(B, S, G, N).astype(np.float32)
    Cm = rng.randn(B, S, G, N).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("S,N,Q,dtype", [(384, 128, 256, "float32"),
                                         (384, 128, 256, "bfloat16"),
                                         (300, 100, 200, "float32"),
                                         (256, 16, 256, "float32")])
def test_mamba_sub_chunked_plain_equals_the_jax_kernel_at_the_callers_chunk(
        S, N, Q, dtype):
    """K7 at a chunk past 128 runs as chunks of ``kernel_chunk``: the plain
    version at that chunk (the kernel's arithmetic) against the Pallas
    kernel at the caller's chunk (S padded with zeros to a multiple of it,
    which the kernel needs and which adds nothing), within the reference's
    tolerances in bf16; in fp32 the Pallas kernel's own sums stray 2.1e-4
    to 4.2e-4 from the exact result (the reference's oracle in float64),
    past the tolerance, so there the port is held beside it
    (``assert_close_beside_the_reference``).  The final state, which the
    Pallas kernel drops, against the reference model's ``ssd_chunked`` at
    the caller's chunk, within the tolerances."""
    tdt = {"float32": F32, "bfloat16": BF16}[dtype]
    x, dt, A, Bm, Cm = _mamba_model_inputs(1, S, 3, 1, N, 16, seed=5)
    Qk = ms.kernel_chunk(Q, N, tdt)
    assert Qk < Q
    args = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    args = [t.to(tdt) if i in (0, 3, 4) else t for i, t in enumerate(args)]
    y, state = ms.mamba2_scan_plain(*args, Qk)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    pad = (-S) % Q
    jx, jB, jC = (np.pad(a[0].transpose(1, 0, 2), ((0, 0), (0, pad), (0, 0)))
                  for a in (x, Bm.repeat(3, axis=2), Cm.repeat(3, axis=2)))
    jdtv = np.pad(dt[0].T, ((0, 0), (0, pad)))
    ref = j_mamba(jnp.asarray(jx).astype(jdt), jnp.asarray(jdtv),
                  jnp.asarray(A), jnp.asarray(jB).astype(jdt),
                  jnp.asarray(jC).astype(jdt), chunk=Q)
    ref = np.asarray(ref, np.float32)[:, :S].transpose(1, 0, 2)[None]
    if dtype == "float32":
        exact = mamba2_scan_ref64(jx, jdtv, A, jB, jC)[0]
        exact = exact[:, :S].transpose(1, 0, 2)[None]
        assert_close_beside_the_reference(y.numpy(), ref, exact, dtype)
    else:
        assert_close(to_np(y), ref, dtype)
    grow = lambda a: np.pad(a, ((0, 0), (0, pad)) + ((0, 0),) * (a.ndim - 2))  # noqa: E731,E501
    x_, B_, C_ = (jnp.asarray(grow(to_np(args[i]))).astype(jdt)
                  for i in (0, 3, 4))
    _, ref_state = ssd_chunked(x_, jnp.asarray(grow(dt)), jnp.asarray(A),
                               B_, C_, Q)
    assert_close(state.float().numpy(), ref_state, dtype)


def test_mamba_card_path_at_n128_runs_the_kernels_chunk_on_meta_tensors():
    """Meta tensors take the wrapper's card path: N 128 at chunk 256 books
    the kernel's chunk, 128 in bf16, forward and, through ``Mamba2Scan``,
    backward (the backward takes N up to 128 since its chunk kernels walk
    the state in tiles of 64); past N 128 the wrapper takes the state as
    groups and books the function's own cost once, forward and
    backward."""
    B, S, H, N, P = 1, 512, 4, 128, 64
    meta = dict(device="meta")
    x = torch.empty((B, S, H, P), dtype=BF16, **meta)
    dt = torch.empty((B, S, H), **meta)
    A = torch.empty((B * H,), **meta)
    bc = torch.empty((B, S, 1, N), dtype=BF16, **meta)
    booked = []
    with costs.listening(lambda name, fl, by: booked.append((name, fl, by))):
        y, state = ms.mamba2_scan_kernel(x, dt, A, bc, bc, 256)
        assert y.shape == x.shape and state.shape == (B, H, N, P)
        assert booked == [("mamba2_scan",
                           *costs.mamba_fwd(B, S, H, 1, N, P, 128, 2))]
        xg = x.clone().requires_grad_()
        y, state = ms.mamba2_scan_kernel(xg, dt, A, bc, bc, 256)
        (dx,) = torch.autograd.grad(y, xg, torch.empty_like(y))
        assert dx.shape == x.shape and dx.device.type == "meta"
    assert booked[1:] == [
        ("mamba2_scan", *costs.mamba_fwd(B, S, H, 1, N, P, 128, 2)),
        ("mamba2_scan_bwd", *costs.mamba_bwd(B, S, H, 1, N, P, 128, 2))]
    wide = torch.empty((B, S, 1, 129), dtype=BF16, **meta)
    with costs.listening(lambda name, fl, by: booked.append((name, fl, by))):
        xg = x.clone().requires_grad_()
        y, state = ms.mamba2_scan_kernel(xg, dt, A, wide, wide, 256)
        torch.autograd.grad(y, xg, torch.empty_like(y))
    assert state.shape == (B, H, 129, P)
    # past one row group bf16 runs the fp32 design, at its chunk of 64
    assert ms.fp32_design(129, BF16) and ms.kernel_chunk(256, 129, BF16) == 64
    assert booked[3:] == [
        ("mamba2_scan", *costs.mamba_fwd(B, S, H, 1, 129, P, 64, 2)),
        ("mamba2_scan_bwd", *costs.mamba_bwd(B, S, H, 1, 129, P, 64, 2))]


# ------------------------------------------------------ K7 state groups
@pytest.mark.parametrize("N,P,rows,cols", [
    (64, 64, [(0, 64)], [(0, 64)]),
    (128, 64, [(0, 128)], [(0, 64)]),
    (256, 128, [(0, 128), (128, 256)], [(0, 64), (64, 128)]),
    (160, 96, [(0, 80), (80, 160)], [(0, 48), (48, 96)]),
    (129, 65, [(0, 65), (65, 129)], [(0, 33), (33, 65)]),
    (1024, 1024, [(i, i + 128) for i in range(0, 1024, 128)],
     [(i, i + 64) for i in range(0, 1024, 64)])])
def test_mamba_split_plan(N, P, rows, cols):
    """A state past one launch's (``GROUP_N`` rows, ``GROUP_P`` columns)
    is cut into the fewest near-equal groups; the zoo's widths stay one
    group, so they run the launch they ran before."""
    assert ms.split_plan(N, P) == (rows, cols)
    assert all(b - a <= ms.GROUP_N for a, b in rows)
    assert all(b - a <= ms.GROUP_P for a, b in cols)


def mamba_groups_plain(x, dt, A, Bm, Cm, Q, init=None):
    """What ``_forward`` does on the card, on the plain version: a launch
    a (row group, column group) of ``split_plan`` on the group's columns of
    x, rows of B and C and block of init, y in fp32 (a bf16 launch past
    one row group writes it so), concatenated over column groups and
    summed over row groups, rounded to x's type once; the state's blocks
    in place."""
    B, S, H, P = x.shape
    N = Bm.shape[3]
    rows, cols = ms.split_plan(N, P)
    y = torch.zeros(x.shape, dtype=torch.float32)
    state = torch.zeros((B, H, N, P))
    for n0, n1 in rows:
        for p0, p1 in cols:
            yg, sg = ms.mamba2_scan_plain(
                x[..., p0:p1].float(), dt, A, Bm[..., n0:n1].float(),
                Cm[..., n0:n1].float(), Q,
                None if init is None else init[:, :, n0:n1, p0:p1])
            y[..., p0:p1] += yg
            state[:, :, n0:n1, p0:p1] = sg
    return y.to(x.dtype), state


@pytest.mark.parametrize("N,P", [(64, 128), (64, 96), (256, 16),
                                 (160, 16), (129, 65)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_state_groups_equal_the_jax_kernel(N, P, dtype):
    """K7 past N 128 or P 64, as the card runs it (``mamba_groups_plain``,
    ragged groups too), against the Pallas kernel in interpret mode at the
    caller's width within the reference's tolerances, fp32 beside the
    float64 oracle as the chunk test does; the final state against the
    reference model's ``ssd_chunked`` at the caller's width."""
    tdt = {"float32": F32, "bfloat16": BF16}[dtype]
    S, Q = 64, 32
    x, dt, A, Bm, Cm = _mamba_model_inputs(1, S, 2, 1, N, P, seed=N + P)
    args = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    args = [t.to(tdt) if i in (0, 3, 4) else t for i, t in enumerate(args)]
    y, state = mamba_groups_plain(*args, Q)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx, jB, jC = (a[0].transpose(1, 0, 2)
                  for a in (x, Bm.repeat(2, axis=2), Cm.repeat(2, axis=2)))
    jdtv = dt[0].T
    ref = j_mamba(jnp.asarray(jx).astype(jdt), jnp.asarray(jdtv),
                  jnp.asarray(A), jnp.asarray(jB).astype(jdt),
                  jnp.asarray(jC).astype(jdt), chunk=Q)
    ref = np.asarray(ref, np.float32).transpose(1, 0, 2)[None]
    if dtype == "float32":
        exact = mamba2_scan_ref64(jx, jdtv, A, jB, jC)[0]
        assert_close_beside_the_reference(
            y.numpy(), ref, exact.transpose(1, 0, 2)[None], dtype)
    else:
        assert_close(to_np(y), ref, dtype)
    _, ref_state = ssd_chunked(*(jnp.asarray(to_np(args[i])).astype(jdt)
                                 if i in (0, 3, 4) else jnp.asarray(to_np(
                                     args[i])) for i in range(5)), Q)
    assert_close(state.numpy(), ref_state, dtype)


def test_mamba_wide_state_books_the_functions_cost_once_on_meta():
    """P 128 and N 256 on meta tensors: the wrapper's card path (the
    groups of ``split_plan``, four launches on the card, bf16 on the fp32
    design at its chunk of 64) books the scan's own cost at the caller's N
    and P once, forward and backward."""
    B, S, H, N, P = 1, 256, 2, 256, 128
    meta = dict(device="meta")
    x = torch.empty((B, S, H, P), dtype=BF16, **meta, requires_grad=True)
    dt, A = torch.empty((B, S, H), **meta), torch.empty((B * H,), **meta)
    bc = torch.empty((B, S, 1, N), dtype=BF16, **meta)
    booked = []
    with costs.listening(lambda name, fl, by: booked.append((name, fl, by))):
        y, state = ms.mamba2_scan_kernel(x, dt, A, bc, bc, 128)
        (dx,) = torch.autograd.grad(y, x, torch.empty_like(y))
    assert y.shape == x.shape == dx.shape and state.shape == (B, H, N, P)
    assert booked == [
        ("mamba2_scan", *costs.mamba_fwd(B, S, H, 1, N, P, 64, 2)),
        ("mamba2_scan_bwd", *costs.mamba_bwd(B, S, H, 1, N, P, 64, 2))]
    rows, cols = ms.split_plan(N, P)
    assert len(rows) * len(cols) == 4


# --------------------------------------------------- K8 padded state size
@pytest.mark.parametrize("N,want", [(1, 8), (8, 8), (12, 16), (24, 32),
                                    (33, 64), (48, 64), (64, 64)])
def test_rwkv_padded_n(N, want):
    assert rs.padded_n(N) == want


def test_rwkv_padded_n_refuses_past_64():
    """Past 64, where it refused until PR 29, N runs as blocks of the N 64
    instance (65 on two a way); N 0 is refused."""
    assert rs.padded_n(65) == 128
    with pytest.raises(ValueError, match=">= 1"):
        rs.padded_n(0)


@pytest.mark.parametrize("N,want", [(65, 128), (96, 128), (128, 128),
                                    (129, 192), (1024, 1024)])
def test_rwkv_padded_n_past_64_is_whole_blocks(N, want):
    """Past the largest instance N runs as blocks of it: padded to whole
    blocks of ``BLOCK_N``."""
    assert rs.padded_n(N) == want and want % rs.BLOCK_N == 0


def _rwkv_model_inputs(B, S, H, N, seed=0):
    rng = np.random.RandomState(seed)
    r, v = (rng.randn(B, S, H, N).astype(np.float32) for _ in range(2))
    k = (rng.randn(B, S, H, N) * 0.3).astype(np.float32)
    w = (1 / (1 + np.exp(-rng.randn(B, S, H, N)))).astype(np.float32)
    u = (rng.randn(B * H, N) * 0.1).astype(np.float32)
    s0 = (rng.randn(B, H, N, N) * 0.5).astype(np.float32)
    return [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]


@pytest.mark.parametrize("N", [12, 24, 48, 5])
def test_rwkv_padded_state_equals_the_callers_scan(N):
    """Zero k and v columns leave the padded state's extra rows and columns
    zero whatever w holds, and zero r adds nothing to y: the plain version
    on the padded inputs, sliced back, equals it on the caller's."""
    args = _rwkv_model_inputs(2, 40, 2, N, seed=N)
    n = rs.padded_n(N)
    padded = rs.pad_state_dim(*args, n)
    assert all(t.shape[-1] == n for t in padded)
    y, state = rs.rwkv6_scan_plain(*padded)
    want_y, want_state = rs.rwkv6_scan_plain(*args)
    assert_close(y[..., :N].numpy(), want_y.numpy())
    assert_close(state[..., :N, :N].numpy(), want_state.numpy())
    assert not y[..., N:].any() and not state[..., N:, :].any() \
        and not state[..., :, N:].any()


def test_rwkv_gradient_through_the_padding_is_the_callers():
    """The padding sits outside ``RWKV6Scan``: autograd through it and the
    padded scan gives the caller's gradient of every input."""
    args = _rwkv_model_inputs(1, 20, 2, 24, seed=9)
    dy = torch.from_numpy(np.random.RandomState(2).randn(1, 20, 2, 24)
                          .astype(np.float32))
    want = rs.rwkv6_scan_backward_plain(*args, dy)
    leaves = [t.clone().requires_grad_() for t in args]
    y, _ = rs.rwkv6_scan_plain(*rs.pad_state_dim(*leaves, 32))
    got = torch.autograd.grad(y[..., :24], leaves, dy)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert_close(a.numpy(), b.numpy())


def rwkv_blocks_plain(r, k, v, w, u, init=None):
    """What the card runs past ``BLOCK_N``, on the plain version: the
    inputs in fp32, padded to whole blocks, stacked (``stack_blocks``),
    the scan of the stacked heads, y summed over the row blocks and
    rounded to r's type once, the state's blocks in place."""
    B, S, H, N = r.shape
    Np = rs.padded_n(N)
    fp32 = [t.float() for t in (r, k, v, w, u)] \
        + [None if init is None else init.float()]
    stacked = rs.stack_blocks(*rs.pad_state_dim(*fp32, Np), Np // rs.BLOCK_N)
    y, state = rs.rwkv6_scan_plain(*stacked)
    y, state = rs.unstack(y, state, B, S, H, Np // rs.BLOCK_N)
    return y[..., :N].to(r.dtype), state[..., :N, :N]


@pytest.mark.parametrize("N", [128, 96, 65])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_blocks_equal_the_jax_kernel(N, dtype):
    """K8 past N 64 as blocks of the N 64 scan (``rwkv_blocks_plain``),
    against the Pallas kernel in interpret mode within the reference's
    tolerances, and against the plain version at the caller's N from a
    nonzero state (y and the final state)."""
    from repro.kernels.rwkv6_scan.ops import rwkv6_scan as j_rwkv
    tdt = {"float32": F32, "bfloat16": BF16}[dtype]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    r, k, v, w, u, s0 = _rwkv_model_inputs(1, 24, 2, N, seed=N)
    args = [t.to(tdt) for t in (r, k, v, w)] + [u]
    y, _ = rwkv_blocks_plain(*args)
    jargs = [jnp.asarray(to_np(t)[0].transpose(1, 0, 2)).astype(jdt)
             for t in args[:4]] + [jnp.asarray(u.numpy())]
    ref = np.asarray(j_rwkv(*jargs, chunk=8), np.float32)
    assert_close(to_np(y), ref.transpose(1, 0, 2)[None], dtype)
    y, state = rwkv_blocks_plain(*args, s0)
    want_y, want_state = rs.rwkv6_scan_plain(*args, s0)
    assert_close(to_np(y), to_np(want_y), dtype)
    assert_close(state.numpy(), want_state.numpy())


def test_rwkv_blocks_book_the_functions_cost_once_on_meta():
    """N 128 on meta tensors: one launch on the card on the stacked blocks,
    the scan's own cost at N 128 booked once, forward and (through
    ``RWKV6Blocks``) backward."""
    B, S, H, N = 2, 16, 3, 128
    r = torch.empty((B, S, H, N), device="meta", requires_grad=True)
    u = torch.empty((B * H, N), device="meta")
    init = torch.empty((B, H, N, N), device="meta", requires_grad=True)
    booked = []
    with costs.listening(lambda name, fl, by: booked.append((name, fl, by))):
        y, state = rs.rwkv6_scan_kernel(r, r, r, r, u, init)
        grads = torch.autograd.grad((y, state), (r, init),
                                    (torch.empty_like(y),
                                     torch.empty_like(state)))
    assert y.shape == (B, S, H, N) and state.shape == (B, H, N, N)
    assert [g.shape for g in grads] == [r.shape, init.shape]
    assert booked == [("rwkv6_scan", *costs.rwkv_fwd(B, S, H, N, 4)),
                      ("rwkv6_scan_bwd",
                       *costs.rwkv_bwd(B, S, H, N, rs.SAVE_EVERY))]


def test_rwkv_card_path_pads_and_slices_on_meta_tensors():
    B, S, H, N = 2, 16, 3, 48
    r = torch.empty((B, S, H, N), device="meta")
    u = torch.empty((B * H, N), device="meta")
    booked = []
    with costs.listening(lambda name, fl, by: booked.append((name, fl, by))):
        y, state = rs.rwkv6_scan_kernel(r, r, r, r, u)
    assert y.shape == (B, S, H, N) and state.shape == (B, H, N, N)
    assert booked == [("rwkv6_scan", *costs.rwkv_fwd(B, S, H, 64, 4))]


# ------------------------------------------- K6 wide: the ring's protocol
def _wide_bwd_walk(d, dv, kind, piece, n_steps):
    """The stage waits and releases of ``csrc/flash_attention_wide.cu``'s
    backward consumers, group by group, as the kernel makes them: the
    block's entry table, every entry waited for in order, the group's own
    product's stages released when the next is issued (or before a wait
    on an entry that reuses their stage), the others' at once, the held
    sum boxes after the sums; the exchange's two named barriers a step."""
    p = fa.wide_plan(d, dv, kind)
    (na, nb), (res_a, res_b) = p.boxes, p.resident
    pa, pb = p.piece_boxes
    dq = kind == "dq"
    ha0 = min(piece * pa, na)
    ha1 = min(ha0 + pa, na)
    hb0 = 0 if dq else min(piece * pb, nb)
    hb1 = 0 if dq else min(hb0 + pb, nb)
    table = []

    def add(side, j, res):
        table.extend(([(side, 1, j)] if not res else []) + [(side, 0, j)])
    for j in range(max(na, nb)):
        if j < na and not ha0 <= j < ha1:
            add(0, j, res_a)
        if j < nb and not hb0 <= j < hb1:
            add(1, j, res_b)
    for j in range(ha0, ha1):
        add(0, j, res_a)
    for j in range(hb0, hb1):
        add(1, j, res_b)
    E = len(table)
    assert E == p.entries
    ra, rb = 2 - res_a, 2 - res_b
    e2 = E - (ha1 - ha0) * ra - (hb1 - hb0) * rb
    walks = []
    for g in (0, 1):
        sum_side = 0 if dq else 1 - g
        if dq:
            n0 = fa.wide_dq_split(ha1 - ha0, na, nb)
            s0, s1 = (ha0, ha0 + n0) if g == 0 else (ha0 + n0, ha1)
        else:
            s0, s1 = (hb0, hb1) if g == 0 else (ha0, ha1)
        sum_e = [e2 + (c - ha0) * ra + ra - 1 if sum_side == 0
                 else e2 + (ha1 - ha0) * ra + (c - hb0) * rb + rb - 1
                 for c in range(s0, s1)]
        acts = []
        for s in range(n_steps):
            base, pend, pend_r, pend_held, re = s * E, -1, -1, False, -1

            def release_pend():
                acts.extend([("rel", pend)] if not pend_held else [])
                acts.extend([("rel", pend_r)] if pend_r >= 0 else [])
            for e, (side, isr, j) in enumerate(table):
                i = base + e
                held = not isr and side == sum_side and s0 <= j < s1
                if pend >= 0 and min(pend, pend if pend_r < 0 else pend_r) \
                        <= i - p.stages:
                    release_pend()
                    pend = pend_r = -1
                acts.append(("wait", i))
                if side != g:
                    acts.extend([] if held else [("rel", i)])
                    continue
                if isr:
                    re = i
                    continue
                if pend >= 0:
                    release_pend()
                pend, pend_held = i, held
                pend_r = -1 if (res_b if side else res_a) else re
            if pend >= 0:
                release_pend()
            acts += [("bar", 2)] * (s > 0) + [("bar", 1)]
            acts += [("rel", base + e) for e in sum_e]
        walks.append(acts)
    order = [(0, i) for i in range(n_steps * E)]
    return order, walks, [p.stages], 2


def _wide_fwd_walk(d, dv, piece, n_tiles):
    """The forward's: a ring of half the stages a group, group g's entries
    in a key tile Q_j (when Q streams) and K_j for d's boxes j = g mod 2,
    then its value boxes; the producer loads the two rings' entries in the
    order of the boxes."""
    p = fa.wide_plan(d, dv, "fwd")
    (na, nb), pb, res = p.boxes, p.piece_boxes[1], p.resident[0]
    step = 2 - res
    p0 = min(piece * pb, nb)
    nv = min(p0 + pb, nb) - p0
    count, order = [0, 0], []
    for _ in range(n_tiles):
        for r in [j % 2 for j in range(na) for _ in range(step)] \
                + [c % 2 for c in range(nv)]:
            order.append((r, count[r]))
            count[r] += 1
    walks = []
    for g in (0, 1):
        mine, my_a = (nv - g + 1) // 2, (na - g + 1) // 2
        E, acts = my_a * step + mine, []
        for kt in range(n_tiles):
            base, pend = kt * E, -1
            for jj in range(my_a):
                ik = base + (jj + 1) * step - 1
                acts += [("wait", e) for e in range(ik - step + 1, ik + 1)]
                if pend >= 0:
                    acts += [("rel", e) for e in range(pend - step + 1,
                                                       pend + 1)]
                pend = ik
            if pend >= 0:
                acts += [("rel", e) for e in range(pend - step + 1, pend + 1)]
            acts += [("bar", 2)] * (kt > 0) + [("bar", 1)]
            v = [base + my_a * step + c for c in range(mine)]
            acts += [("wait", e) for e in v] + [("rel", e) for e in v]
        walks.append([(a, (g, i)) if a != "bar" else (a, i)
                      for a, i in acts])
    return order, walks, [p.stages // 2] * 2, 1


def _ring_run(order, walks, stages, readers):
    """Replays a producer loading ``order`` (ring, entry) and the two
    groups' ``walks``: an entry loads once every reader has released the
    entry ``stages`` before it in its ring; a wait needs its entry loaded,
    and the entry before it in its stage loaded too, or the kernel's
    parity wait would pass on the phase before; each named barrier waits
    for both groups.  Returns None when every walk ends with every entry
    released once by each reader, else where it stuck."""
    def key(x):
        return x if isinstance(x, tuple) else (0, x)
    loaded, released = set(), {}
    at, done_bars, pc, produced = [0, 0], {1: [0, 0], 2: [0, 0]}, [0, 0], 0
    pending = [None, None]
    while True:
        moved = False
        while produced < len(order):
            r, i = order[produced]
            if i >= stages[r] and released.get((r, i - stages[r]), 0) \
                    < readers:
                break
            loaded.add((r, i))
            produced += 1
            moved = True
        for g in (0, 1):
            while pc[g] < len(walks[g]):
                kind, x = walks[g][pc[g]]
                if kind == "wait":
                    r, i = key(x)
                    if (r, i) not in loaded:
                        break
                    assert i < stages[r] or (r, i - stages[r]) in loaded
                elif kind == "rel":
                    released[key(x)] = released.get(key(x), 0) + 1
                else:
                    if pending[g] is None:
                        done_bars[x][g] += 1
                        pending[g] = done_bars[x][g]
                    if done_bars[x][1 - g] < pending[g]:
                        break
                    pending[g] = None
                pc[g] += 1
                moved = True
        if pc == [len(w) for w in walks]:
            assert produced == len(order)
            assert all(released.get(key(x), 0) == readers for x in order)
            return None
        if not moved:
            return dict(produced=produced, at=pc)


@pytest.mark.parametrize("d,dv", [
    (512, 512), (576, 512), (520, 600), (264, 64), (512, 128), (8, 1024),
    (64, 1024), (1600, 64), (1024, 1024), (320, 320), (2048, 72)])
def test_flash_wide_ring_never_deadlocks_or_reads_a_stale_stage(d, dv):
    """The wide kernels' stage protocol replayed for every piece of each
    kind at 1-3 steps: no wait that can never end (the hang that keeping
    a product's stage while walking on to the entry that reuses it gave at
    (8, 1024) and (1600, 64)), no wait two phases ahead of its stage (a
    group skipping the other's stages let dQ read stale K), and every
    stage released once by each reader."""
    for kind in ("dkdv", "dq"):
        for piece in range(fa.wide_plan(d, dv, kind).pieces):
            for n in (1, 2, 3):
                assert _ring_run(*_wide_bwd_walk(d, dv, kind, piece, n)) \
                    is None, (kind, piece, n)
    for piece in range(fa.wide_plan(d, dv, "fwd").pieces):
        for n in (1, 2, 3):
            assert _ring_run(*_wide_fwd_walk(d, dv, piece, n)) is None, \
                ("fwd", piece, n)
