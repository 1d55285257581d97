"""K6's backward as redesigned for the H100 (the wgmma design of
csrc/flash_attention_bwd.cu): its tile schedule, checked by replaying the
kernels' index arithmetic on the CPU, and its arithmetic, replayed tile by
tile in numpy in the kernels' order, against ``jax.vjp`` of the Pallas
kernel's own oracle.

The dK/dV kernel has a block per (key tile of 64, batch row, KV head),
numbered key tile first; it walks the G query heads of its KV head and,
for each, the query tiles from the first that sees its keys.  The dQ
kernel has a block per (query tile of 64, batch row, head), the last
query tile first when causal; it walks the key tiles up to the diagonal.
Every output element has one block, which sums its terms in one fixed
order: the result is the same run to run."""
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port import one_thread  # noqa: E402,F401

from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as tfa  # noqa: E402

TILE = tfa.BWD_TILE


def block_of(idx, n_t, n_bh, last_first):
    """(row tile, b * heads + head) of block ``idx``: heads in groups of
    ``BWD_GROUP_HEADS``, tiles first within a group, the last tile first
    when ``last_first``."""
    gh = tfa.BWD_GROUP_HEADS
    group, r = divmod(idx, gh * n_t)
    in_group = min(gh, n_bh - group * gh)
    rank = r // in_group
    return (n_t - 1 - rank if last_first else rank), group * gh + r % in_group


def dkdv_blocks(B, S, T, H, KV, causal, R=TILE):
    """(block, b, KV head, first key, [(head, query tile), ...] in the
    order the block's warpgroups sum them), by bwd_wgmma_kernel's
    arithmetic with DQ false and ``R`` keys a block."""
    G = H // KV
    n_qt, n_t = -(-S // TILE), -(-T // R)
    for idx in range(n_t * B * KV):
        tile, bh = block_of(idx, n_t, B * KV, False)
        b, kvh = divmod(bh, KV)
        i0 = R * tile // TILE if causal else 0
        n_q = max(0, n_qt - i0)
        yield idx, b, kvh, R * tile, [(kvh * G + s // n_q, i0 + s % n_q)
                                      for s in range(G * n_q)]


def dq_blocks(B, S, T, H, causal, R=TILE):
    """(block, b, head, first query, [key tile, ...] in the order the
    block's warpgroups sum them), by bwd_wgmma_kernel's arithmetic with DQ
    true and ``R`` queries a block."""
    n_t, n_kt = -(-S // R), -(-T // TILE)
    for idx in range(n_t * B * H):
        tile, bh = block_of(idx, n_t, B * H, causal)
        b, h = divmod(bh, H)
        last = (R * tile + R - 1) // TILE
        yield idx, b, h, R * tile, list(range(min(last + 1, n_kt) if causal
                                              else n_kt))


def step_mask(q0, k0, S, T, causal):
    """[query, key] of a step's 64 x 64 scores that the kernels keep."""
    q = q0 + np.arange(TILE)[:, None]
    k = k0 + np.arange(TILE)[None, :]
    return (q < S) & (k < T) & ((q >= k) | (not causal))


def reference_mask(S, T, causal):
    return np.arange(S)[:, None] >= np.arange(T)[None, :] if causal \
        else np.ones((S, T), bool)


SHAPES = [
    # B, S, T, H, KV
    (1, 64, 64, 1, 1),
    (2, 100, 100, 4, 2),     # ragged tiles, G 2
    (2, 96, 160, 4, 2),      # S != T
    (1, 160, 96, 4, 1),      # T < S, G 4
    (1, 130, 130, 8, 2),     # G 4
    (1, 200, 200, 8, 1),     # G 8 (qwen3-moe's ratio)
    (1, 1, 1, 2, 2),
    (1, 65, 257, 2, 1),
    (3, 257, 63, 3, 3),
    (1, 640, 640, 2, 2),     # ten tiles, the causal triangle
    (2, 300, 300, 12, 12),   # three groups of heads, the last short
]


@pytest.mark.parametrize("R", [TILE, 2 * TILE])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,T,H,KV", SHAPES)
def test_each_unmasked_pair_is_summed_once_by_each_kernel(B, S, T, H, KV,
                                                          causal, R):
    """Over all blocks and steps, each (b, head, query s, key t) with
    s < S, t < T and (s >= t when causal) is computed exactly once by the
    dK/dV kernel and once by the dQ kernel, with blocks of ``R`` rows
    (exchange mode 64, rows mode 128: a warpgroup for each 64); nothing
    else is."""
    want = np.broadcast_to(reference_mask(S, T, causal), (B, H, S, T))
    pad = lambda n: -(-n // R) * R  # noqa: E731
    for blocks, of in ((dkdv_blocks(B, S, T, H, KV, causal, R), "dkdv"),
                       (dq_blocks(B, S, T, H, causal, R), "dq")):
        seen = np.zeros((B, H, pad(S), pad(T)), np.int32)
        for _, b, head, r0, steps in blocks:
            for step in steps:
                for half in range(0, R, TILE):     # the block's warpgroups
                    if of == "dkdv":
                        h, q0, k0 = step[0], TILE * step[1], r0 + half
                    else:
                        h, q0, k0 = head, r0 + half, TILE * step
                    seen[b, h, q0:q0 + TILE, k0:k0 + TILE] += step_mask(
                        q0, k0, S, T, causal)
        assert seen.max() <= 1, of
        np.testing.assert_array_equal(seen[:, :, :S, :T], want, err_msg=of)
        assert seen.sum() == want.sum(), of


@pytest.mark.parametrize("R", [TILE, 2 * TILE])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,T,H,KV", SHAPES)
def test_every_output_row_has_one_block_and_a_fixed_order(B, S, T, H, KV,
                                                         causal, R):
    """dK/dV: each (b, KV head, key tile of R) has one block, which sums
    its G heads in order and each head's query tiles in ascending order,
    each once.  dQ: each (b, head, query tile of R) has one block, which
    adds its key tiles in ascending order from 0, each once.  Blocks are
    numbered by groups of ``BWD_GROUP_HEADS`` (b, head) pairs, and within
    a group the longest first when causal, so that short ones fill each
    group's tail."""
    G = H // KV
    gh = tfa.BWD_GROUP_HEADS
    owners, lengths = {}, {}
    for idx, b, kvh, r0, steps in dkdv_blocks(B, S, T, H, KV, causal, R):
        assert owners.setdefault(("dkdv", b, kvh, r0), idx) == idx
        assert steps == sorted(steps)
        assert all(kvh * G <= h < (kvh + 1) * G for h, _ in steps)
        assert len(set(steps)) == len(steps)
        assert (b * KV + kvh) // gh == idx // (gh * -(-T // R))
        lengths.setdefault(("dkdv", (b * KV + kvh) // gh), []).append(
            len(steps))
    assert len(owners) == -(-T // R) * B * KV
    for idx, b, h, r0, keys in dq_blocks(B, S, T, H, causal, R):
        assert owners.setdefault(("dq", b, h, r0), idx) == idx
        assert keys == list(range(len(keys)))
        assert (b * H + h) // gh == idx // (gh * -(-S // R))
        lengths.setdefault(("dq", (b * H + h) // gh), []).append(len(keys))
    assert len(owners) == -(-T // R) * B * KV + -(-S // R) * B * H
    if causal:
        for run in lengths.values():
            assert run == sorted(run, reverse=True)


@pytest.mark.parametrize("dq", [False, True])
@pytest.mark.parametrize("d,dv", tfa.PAIRS)
def test_wgmma_plan_fits_the_card(d, dv, dq):
    """The training pairs (64, 64), (128, 128), (192, 128), (256, 256)
    take the wgmma design, the smaller pairs keep mma.sync.  Each kernel's
    block takes 2-4 stages in at most 227 KB; the dQ kernel runs rows mode
    (128 rows, no exchange) but at d 256, where its 128 resident rows and
    two stages would take 256 KB; the dK/dV kernel exchange mode.
    Exchange mode's dQ columns split at a whole 64-column box into the
    most even two parts."""
    assert tfa.on_wgmma(d, dv) == ((d, dv) in {(64, 64), (128, 128),
                                               (192, 128), (256, 256)})
    if not tfa.on_wgmma(d, dv):
        return
    plan = tfa.wgmma_plan(d, dv, dq)
    assert plan.rows == (dq and (d, dv) != (256, 256))
    assert plan.rows_per_block == (2 * TILE if plan.rows else TILE)
    assert 2 <= plan.stages <= 4
    assert plan.smem_bytes <= tfa.SMEM_LIMIT
    pair = TILE * (d + dv) * 2
    assert plan.smem_bytes == 1024 + 256 \
        + (0 if plan.rows else 2 * TILE * TILE * 4) \
        + (plan.rows_per_block // TILE + plan.stages) * pair
    assert plan.stages == 4 or plan.smem_bytes + pair > tfa.SMEM_LIMIT
    c0 = plan.dq_cols0
    assert c0 % 64 == 0 and 0 <= c0 < d
    # each group's work: its score product's depth (d or dv) plus its dQ
    # columns; no other whole-box split is more even
    work = lambda c: abs((d + c) - (dv + d - c))  # noqa: E731
    assert all(work(c0) <= work(c) for c in range(0, d, 64))


def _ref_attention(q, k, v, causal):
    """The Pallas kernel's oracle in the models' layout, the KV heads
    broadcast as the kernel's wrapper does."""
    B, S, H, d = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.transpose(0, 2, 1, 3).reshape(B * H, S, d)
    kf = jnp.repeat(k.transpose(0, 2, 1, 3), G, axis=1).reshape(B * H, T, d)
    vf = jnp.repeat(v.transpose(0, 2, 1, 3), G, axis=1).reshape(
        B * H, T, v.shape[-1])
    o = attention_ref(qf, kf, vf, causal=causal)
    return o.reshape(B, H, S, -1).transpose(0, 2, 1, 3)


def _rows(x, r0):
    """TILE rows of x from r0, zero past its end (as TMA fills them)."""
    out = np.zeros((TILE,) + x.shape[1:], x.dtype)
    part = x[r0:r0 + TILE]
    out[:len(part)] = part
    return out


def replay(q, k, v, do, causal, zero_d=False):
    """(dq, dk, dv) in float64 by the two kernels' tiles, masks and
    summation order, from lse and D = rowsum(dO o) as the forward and the
    D kernel give them (D zero with ``zero_d``): dK/dV blocks form S^T,
    P^T, dP^T, dS^T a step and add P^T dO into dV and dS^T Q into dK; dQ
    blocks form S, P, dP, dS and add dS K into dQ, in exchange mode the
    first warpgroup's columns and the rest apart; each 64 rows of a
    rows-mode block on their own."""
    B, S, H, d = q.shape
    T, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    scale = 1.0 / math.sqrt(d)
    q, k, v, do = (x.astype(np.float64) for x in (q, k, v, do))
    kh = np.repeat(k, G, axis=2)
    s_full = np.einsum("bshd,bthd->bhst", q, kh) * scale
    s_full = np.where(reference_mask(S, T, causal), s_full, -np.inf)
    lse = np.logaddexp.reduce(s_full, axis=-1)                 # [B, H, S]
    o = np.einsum("bhst,bthd->bshd", np.exp(s_full - lse[..., None]),
                  np.repeat(v, G, axis=2))
    D = np.einsum("bshd,bshd->bhs", do, o) * (not zero_d)
    dq, dk, dvv = np.zeros(q.shape), np.zeros(k.shape), np.zeros(v.shape)
    kv_plan, q_plan = (tfa.wgmma_plan(d, dv, x) for x in (False, True))
    for _, b, kvh, r0, steps in dkdv_blocks(B, S, T, H, KV, causal,
                                            kv_plan.rows_per_block):
        for k0 in range(r0, r0 + kv_plan.rows_per_block, TILE):
            if k0 >= T:
                continue
            K, V = _rows(k[b, :, kvh], k0), _rows(v[b, :, kvh], k0)
            acc_k, acc_v = np.zeros((TILE, d)), np.zeros((TILE, dv))
            for h, i in steps:
                q0 = TILE * i
                Q, dO = _rows(q[b, :, h], q0), _rows(do[b, :, h], q0)
                m = step_mask(q0, k0, S, T, causal).T    # [key, query]
                lq, dq_ = _rows(lse[b, h], q0), _rows(D[b, h], q0)
                pT = np.where(m, np.exp(K @ Q.T * scale - lq[None, :]), 0.0)
                dsT = pT * (V @ dO.T - dq_[None, :])
                acc_v += pT @ dO
                acc_k += dsT @ Q
            n = min(TILE, T - k0)
            dk[b, k0:k0 + n, kvh] = acc_k[:n] * scale
            dvv[b, k0:k0 + n, kvh] = acc_v[:n]
    c0 = 0 if q_plan.rows else q_plan.dq_cols0
    for _, b, h, r0, keys in dq_blocks(B, S, T, H, causal,
                                       q_plan.rows_per_block):
        for q0 in range(r0, r0 + q_plan.rows_per_block, TILE):
            if q0 >= S:
                continue
            Q, dO = _rows(q[b, :, h], q0), _rows(do[b, :, h], q0)
            lq, dq_ = _rows(lse[b, h], q0), _rows(D[b, h], q0)
            parts = [np.zeros((TILE, c0)), np.zeros((TILE, d - c0))]
            for j in keys:
                k0 = TILE * j
                K, V = _rows(k[b, :, h // G], k0), _rows(v[b, :, h // G], k0)
                m = step_mask(q0, k0, S, T, causal)      # [query, key]
                p = np.where(m, np.exp(Q @ K.T * scale - lq[:, None]), 0.0)
                ds = p * (dO @ V.T - dq_[:, None])
                parts[0] += ds @ K[:, :c0]
                parts[1] += ds @ K[:, c0:]
            n = min(TILE, S - q0)
            dq[b, q0:q0 + n, h] = np.concatenate(parts, axis=1)[:n] * scale
    return dq, dk, dvv


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,T,H,KV,d,dv", [
    (1, 100, 100, 4, 2, 64, 64),
    (1, 96, 160, 4, 2, 128, 128),
    (1, 160, 96, 4, 1, 192, 128),        # dQ in rows mode
    (1, 100, 70, 2, 1, 256, 256),        # exchange, dQ split 128 / 128
    (2, 130, 130, 8, 1, 64, 64),         # G 8
])
def test_tiled_replay_matches_the_reference_gradient(B, S, T, H, KV, d, dv,
                                                     causal):
    """The schedule's tiles, masks and order give ``jax.vjp`` of the
    Pallas kernel's oracle on the same seeded inputs (fp32 there, float64
    here)."""
    rng = np.random.RandomState(S + T + d + causal)
    q, k, v, do = (rng.randn(*s).astype(np.float32) for s in (
        (B, S, H, d), (B, T, KV, d), (B, T, KV, dv), (B, S, H, dv)))
    _, vjp = jax.vjp(lambda *a: _ref_attention(*a, causal),
                     *(jnp.asarray(x) for x in (q, k, v)))
    ref = vjp(jnp.asarray(do))
    got = replay(q, k, v, do, causal)
    for a, b, name in zip(got, ref, ("dq", "dk", "dv")):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_replay_with_d_left_at_zero_is_rejected(causal):
    """The planted fault of ``chip_smoke.py``'s backward gate (D left at
    zero) takes the replay's dq or dk past the gate's bf16 tolerance (2e-2
    of the largest magnitude), while dv, which no D enters, stays."""
    rng = np.random.RandomState(1)
    B, S, T, H, KV, d, dv = 1, 100, 100, 4, 2, 64, 64
    q, k, v, do = (rng.randn(*s).astype(np.float32) for s in (
        (B, S, H, d), (B, T, KV, d), (B, T, KV, dv), (B, S, H, dv)))
    good = replay(q, k, v, do, causal)
    bad = replay(q, k, v, do, causal, zero_d=True)
    rel = [np.abs(a - b).max() / np.abs(b).max() for a, b in zip(bad, good)]
    assert max(rel[:2]) > 2e-2
    assert rel[2] == 0.0
