"""The port's probe and page kernels, in their plain PyTorch versions (the
CPU path of each wrapper), against the reference package's Pallas kernels
in interpret mode, on the same numpy inputs.  Ints and bools must be
bit-equal; floats agree within the reference's ``_tol``."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port import assert_close, one_thread, to_np  # noqa: E402,F401

from repro.kernels.page_gather import ops as jpg  # noqa: E402
from repro.kernels.page_gather.ref import page_scatter_ref  # noqa: E402
from repro.kernels.tac_probe import ops as jtp  # noqa: E402
from repro_torch.kernels.page_gather import ops as tpg  # noqa: E402
from repro_torch.kernels.page_gather import page_gather as tpg_mod  # noqa: E402
from repro_torch.kernels.tac_probe import ops as ttp  # noqa: E402
from repro_torch.kernels.tac_probe import tac_probe as ttp_mod  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _probe_inputs(nb, ways, D, B, seed=0):
    """The reference's sweep construction (tests/test_kernels.py): even
    lanes query random keys planted in their hashed bucket, odd lanes
    query -(7 + i) misses."""
    rng = np.random.RandomState(seed)
    bkeys = rng.choice(max(10_000, 2 * nb * ways), size=(nb, ways),
                       replace=False).astype(np.int32)
    bvals = rng.randn(nb, ways, D).astype(np.float32)
    qk = np.where(np.arange(B) % 2 == 0, rng.randint(1, 100_000, B),
                  -(7 + np.arange(B))).astype(np.int32)
    bks = np.asarray(jtp.bucket_of(jnp.asarray(qk), nb))
    next_way = {}
    for i in range(0, B, 2):
        w = next_way.get(bks[i], 0)
        if w < ways:
            bkeys[bks[i], w] = qk[i]
            next_way[bks[i]] = w + 1
    return qk, bkeys, bvals


def _probe_both(qk, bkeys, bvals, dtype):
    jdt, tdt = DTYPES[dtype]
    ref = jtp.tac_probe(jnp.asarray(qk), jnp.asarray(bkeys),
                        jnp.asarray(bvals).astype(jdt))
    port = ttp.tac_probe(torch.from_numpy(qk), torch.from_numpy(bkeys),
                         torch.from_numpy(bvals).to(tdt))
    return ref, port


@pytest.mark.parametrize("nb,ways,D,B", [(16, 8, 64, 32), (8, 4, 128, 16),
                                         (32, 16, 32, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tac_probe_matches_reference(nb, ways, D, B, dtype):
    qk, bkeys, bvals = _probe_inputs(nb, ways, D, B)
    (rv, rh, rw), (pv, ph, pw) = _probe_both(qk, bkeys, bvals, dtype)
    assert pv.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(ph.numpy(), np.asarray(rh))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(rw))
    assert_close(to_np(pv), rv, dtype)
    assert int(ph.sum()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tac_probe_wide_single_bucket(dtype):
    # the fused plane's shape: one fully-associative bucket, D = 1, with
    # duplicate query keys and a key present twice in the bucket (the
    # value row is the SUM of the matched rows, the way the first match)
    qk, bkeys, bvals = _probe_inputs(1, 2048, 1, 64, seed=3)
    qk[10] = qk[0]
    bkeys[0, 2047] = qk[0]
    (rv, rh, rw), (pv, ph, pw) = _probe_both(qk, bkeys, bvals, dtype)
    np.testing.assert_array_equal(ph.numpy(), np.asarray(rh))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(rw))
    assert_close(to_np(pv), rv, dtype)
    assert int(ph.sum()) == 32


def test_tac_probe_counted_matches_reference():
    qk, bkeys, bvals = _probe_inputs(8, 4, 16, 48, seed=5)
    bkeys[1, 2:] = -1                       # one bucket with room
    ref = jtp.tac_probe_counted(jnp.asarray(qk), jnp.asarray(bkeys),
                                jnp.asarray(bvals))
    port = ttp.tac_probe_counted(torch.from_numpy(qk),
                                 torch.from_numpy(bkeys),
                                 torch.from_numpy(bvals))
    for r, p in zip(ref[1:], port[1:]):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    assert_close(port[0].numpy(), ref[0])


@pytest.mark.parametrize("nb,ways", [(1, 64), (4, 8)])
def test_tac_probe_gather_matches_reference(nb, ways):
    qk, bkeys, bvals = _probe_inputs(nb, ways, 1, 24, seed=nb)
    pages = np.random.RandomState(1).randn(nb * ways + 1, 1, 3) \
        .astype(np.float32)
    pages[-1] = 0.0
    rr, rh, rs = jtp.tac_probe_gather(jnp.asarray(qk), jnp.asarray(bkeys),
                                      jnp.asarray(bvals), jnp.asarray(pages))
    pr, ph, ps = ttp.tac_probe_gather(torch.from_numpy(qk),
                                      torch.from_numpy(bkeys),
                                      torch.from_numpy(bvals),
                                      torch.from_numpy(pages))
    assert ph.dtype == torch.bool and ps.dtype == torch.int32
    np.testing.assert_array_equal(ph.numpy(), np.asarray(rh))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(rr))


@pytest.mark.parametrize("n_buckets", [1, 7, 16, 977, 1 << 20])
def test_bucket_of_bit_equal(n_buckets):
    i = np.arange(8)
    signed = np.concatenate([
        [-2, -1, 0, 1, 2 ** 31 - 1, -(2 ** 31)], -(7 + i),
        np.random.RandomState(0).randint(-2 ** 31, 2 ** 31 - 1, 64)
    ]).astype(np.int32)
    high = np.array([2 ** 31, 2 ** 31 + 12345, 3_000_000_000, 2 ** 32 - 1],
                    np.uint32)
    for keys, as_torch in ((signed, torch.from_numpy(signed)),
                           (high, torch.from_numpy(high.astype(np.int64)))):
        ref = np.asarray(jtp.bucket_of(jnp.asarray(keys), n_buckets))
        port = ttp.bucket_of(as_torch, n_buckets)
        assert port.dtype == torch.int32
        np.testing.assert_array_equal(port.numpy(), ref)


@pytest.mark.parametrize("n_slots,page,d,N", [
    (9, 1, 2, 8), (16, 4, 32, 12), (64, 16, 8, 40),
    # K2's shapes on the card (chip_smoke.gather_shapes), pools cut down:
    # serve's append, serve_lm's zamba2 state pages, the fused plane's
    # single-key reads at N 1 and 256
    (9, 64, 128, 8), (20, 8192, 1, 3), (2049, 1, 2, 1), (2049, 1, 2, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_gather_matches_reference(n_slots, page, d, N, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(n_slots)
    pages = rng.randn(n_slots, page, d).astype(np.float32)
    slots = rng.randint(0, n_slots, N).astype(np.int32)   # repeats allowed
    ref = jpg.page_gather(jnp.asarray(slots), jnp.asarray(pages).astype(jdt))
    port = tpg.page_gather(torch.from_numpy(slots),
                           torch.from_numpy(pages).to(tdt))
    assert port.dtype == tdt
    np.testing.assert_array_equal(to_np(port), np.asarray(ref, np.float32))


@pytest.mark.parametrize("n_slots,page,d,N", [(9, 1, 2, 8), (16, 4, 32, 12),
                                              (64, 16, 8, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_scatter_last_write_wins(n_slots, page, d, N, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(n_slots + 1)
    pages = rng.randn(n_slots, page, d).astype(np.float32)
    blocks = rng.randn(N, page, d).astype(np.float32)
    slots = rng.randint(0, n_slots, N).astype(np.int32)
    slots[N // 2] = slots[N - 1] = slots[0]             # duplicates
    jp, jb = jnp.asarray(pages).astype(jdt), jnp.asarray(blocks).astype(jdt)
    ref = jpg.page_scatter(jnp.asarray(slots), jb, jp)
    oracle = page_scatter_ref(jnp.asarray(slots), jb, jp)
    tp = torch.from_numpy(pages).to(tdt)
    port = tpg.page_scatter(torch.from_numpy(slots),
                            torch.from_numpy(blocks).to(tdt), tp)
    assert port is tp                                    # in place
    np.testing.assert_array_equal(to_np(port), np.asarray(ref, np.float32))
    np.testing.assert_array_equal(to_np(port),
                                  np.asarray(oracle, np.float32))
    np.testing.assert_array_equal(to_np(port[slots[0]]),
                                  np.asarray(jb[N - 1], np.float32))


@pytest.mark.parametrize("bad", [-1, 9])
def test_page_wrappers_reject_out_of_range_slots(bad):
    pages = torch.zeros((9, 1, 2))
    slots = torch.tensor([0, bad, 3], dtype=torch.int32)
    with pytest.raises(IndexError):
        tpg_mod.page_gather_kernel(slots, pages)
    with pytest.raises(IndexError):
        tpg_mod.page_scatter_kernel(slots, torch.zeros((3, 1, 2)), pages)


def test_wrappers_check_types_and_count_no_plain_runs():
    g0, s0, p0 = (tpg_mod.GATHER_LAUNCHES, tpg_mod.SCATTER_LAUNCHES,
                  ttp_mod.LAUNCHES)
    pages = torch.zeros((4, 1, 2))
    with pytest.raises(TypeError):
        tpg_mod.page_gather_kernel(torch.tensor([0, 1]), pages)   # int64
    with pytest.raises(ValueError):
        tpg_mod.page_scatter_kernel(torch.tensor([0], dtype=torch.int32),
                                    torch.zeros((1, 2, 2)), pages)
    with pytest.raises(TypeError):
        ttp_mod.tac_probe_kernel(torch.tensor([1]), torch.tensor([0]),
                                 torch.zeros((1, 4), dtype=torch.int32),
                                 torch.zeros((1, 4, 1)))
    q = torch.tensor([3], dtype=torch.int32)
    ttp_mod.tac_probe_kernel(q, torch.zeros(1, dtype=torch.int32),
                             torch.arange(4, dtype=torch.int32)[None],
                             torch.ones((1, 4, 1)))
    tpg_mod.page_gather_kernel(q - 3, pages)
    # the counters count CUDA launches only: the plain versions ran here
    assert (tpg_mod.GATHER_LAUNCHES, tpg_mod.SCATTER_LAUNCHES,
            ttp_mod.LAUNCHES) == (g0, s0, p0)


# ------------------------------------------------------ paged decode attention
from repro.kernels.decode_attention.ops import \
    paged_decode_attention as j_decode  # noqa: E402
from repro.kernels.decode_attention.ref import paged_decode_ref  # noqa: E402
from repro_torch.kernels.decode_attention import \
    decode_attention as tda_mod  # noqa: E402
from repro_torch.kernels.decode_attention.ops import \
    paged_decode_attention as t_decode  # noqa: E402


def _decode_inputs(B, H, d, page, P, seed=0, dv=None):
    """tests/test_kernels.py's construction from a numpy seed: a pool of
    B * P + 3 slots, each sequence's pages a distinct random slot, lengths
    in [1, P * page]."""
    rng = np.random.RandomState(seed)
    slots = B * P + 3
    q = rng.randn(B, H, d).astype(np.float32)
    kp = rng.randn(slots, page, d).astype(np.float32)
    vp = rng.randn(slots, page, dv or d).astype(np.float32)
    pt = rng.permutation(slots)[:B * P].reshape(B, P).astype(np.int32)
    lens = rng.randint(1, P * page + 1, B).astype(np.int32)
    return q, kp, vp, pt, lens


def _decode_port(q, kp, vp, pt, lens, tdt=torch.float32):
    return t_decode(torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
                    torch.from_numpy(vp).to(tdt), torch.from_numpy(pt),
                    torch.from_numpy(lens))


@pytest.mark.parametrize("B,H,d,page,P", [(3, 8, 32, 16, 4), (2, 4, 64, 32, 2),
                                          (4, 16, 16, 8, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_matches_reference_kernel(B, H, d, page, P, dtype):
    jdt, tdt = DTYPES[dtype]
    q, kp, vp, pt, lens = _decode_inputs(B, H, d, page, P)
    jargs = [jnp.asarray(a).astype(jdt) for a in (q, kp, vp)]
    ref = j_decode(*jargs, jnp.asarray(pt), jnp.asarray(lens))
    oracle = paged_decode_ref(*jargs, jnp.asarray(pt), jnp.asarray(lens))
    port = _decode_port(q, kp, vp, pt, lens, tdt)
    assert port.dtype == tdt and port.shape == (B, H, d)
    assert_close(to_np(port), np.asarray(ref, np.float32), dtype)
    assert_close(to_np(port), np.asarray(oracle, np.float32), dtype)


def test_paged_decode_gqa_fold_matches_per_head_reference():
    """Grouped-query attention folded into the batch: q [B * KV, H / KV, d]
    with one table row per (sequence, KV head) equals the reference kernel
    run once per KV head on that head's pages."""
    B, KV, G, d, page, P = 2, 2, 3, 32, 8, 3
    rng = np.random.RandomState(7)
    n_slots = B * KV * P + 2
    q = rng.randn(B, KV * G, d).astype(np.float32)
    kp = rng.randn(n_slots, page, d).astype(np.float32)
    vp = rng.randn(n_slots, page, d).astype(np.float32)
    tables = rng.permutation(n_slots)[:B * KV * P].reshape(B, KV, P) \
        .astype(np.int32)
    lens = np.asarray([P * page, page + 3], np.int32)
    per_head = [np.asarray(j_decode(
        jnp.asarray(q[:, h * G:(h + 1) * G]), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(tables[:, h]), jnp.asarray(lens)))
        for h in range(KV)]
    ref = np.concatenate(per_head, axis=1)                  # [B, KV*G, d]
    port = _decode_port(q.reshape(B * KV, G, d), kp, vp,
                        tables.reshape(B * KV, P), np.repeat(lens, KV))
    assert_close(port.numpy().reshape(B, KV * G, d), ref)


def test_paged_decode_never_reads_pages_past_seq_len():
    """Table entries of pages at or past seq_len may be -1 (probe misses);
    the result equals the reference's on a table that names real slots
    there, and a zero-length sequence gives zeros as the kernel does."""
    q, kp, vp, pt, _ = _decode_inputs(3, 4, 32, 8, 4, seed=2)
    lens = np.asarray([5, 17, 0], np.int32)
    ref = j_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                   jnp.asarray(pt), jnp.asarray(lens))
    holes = pt.copy()
    holes[0, 1:] = -1
    holes[1, 3] = -1
    holes[2, :] = -1
    port = _decode_port(q, kp, vp, holes, lens)
    assert_close(port.numpy(), ref)
    assert not port[2].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_decode_gate_rejects_zero_and_half_context_outputs(dtype):
    """``chip_smoke.decode_agrees``, the gate between the attention kernel
    and its plain version on the card, at a long context where outputs are
    small: it passes the plain output itself and one rounding away, and
    fails an all-zero output and one that skipped half of each sequence."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from chip_smoke import TOL, decode_agrees
    tdt = DTYPES[dtype][1]
    B, H, d, page, P = 2, 4, 32, 64, 64               # 4096 tokens a row
    q, kp, vp, pt, _ = _decode_inputs(B, H, d, page, P, seed=4)
    lens = np.full(B, P * page, np.int32)
    plain = _decode_port(q, kp, vp, pt, lens, tdt)
    half = _decode_port(q, kp, vp, pt, lens // 2, tdt)
    tol = TOL[tdt]
    assert float(plain.float().abs().max()) < 0.5
    assert decode_agrees(plain, plain, tol)
    assert decode_agrees((plain.double() * (1 + tol / 4)).to(tdt), plain,
                         tol)
    assert not decode_agrees(torch.zeros_like(plain), plain, tol)
    assert not decode_agrees(half, plain, tol)
    assert not decode_agrees(torch.full_like(plain, float("nan")), plain, tol)


@pytest.mark.parametrize("units,pages,sms,per_sm", [
    (8, 65, 132, 8),         # chip_smoke's serve launch: 8 rows, 5 heads
    (8, 65, 132, 1),
    (1024, 512, 132, 6),     # decode_32k: 1024 rows of 512 pages
    (1024, 512, 132, 7),
    (160, 40, 132, 8),
    (3, 1, 132, 8),          # a single page
    (4, 0, 132, 8),          # an empty table
    (1, 2, 132, 16),
    (5000, 3, 132, 4),
])
def test_decode_split_planner_contract(units, pages, sms, per_sm):
    """``plan_splits``: at least 1, at most the table's pages, 1 for a
    single page; every page its own block while that is under one wave;
    otherwise the fewest splits that give every SM a block and fill the
    last wave to ``SPLIT_WAVE_SHARE``, or the best-filled count.  The serve
    launch covers the card's SMs."""
    n = tda_mod.plan_splits(units, pages, sms, per_sm)
    assert 1 <= n <= max(pages, 1)
    # ranges of ceil(pages / n) pages each: none of the n is empty
    assert pages <= 1 or -(-pages // -(-pages // n)) == n
    slots = sms * per_sm
    share = lambda m: units * m / (-(-units * m // slots) * slots)  # noqa
    exact = [m for m in range(1, pages + 1)
             if -(-pages // -(-pages // m)) == m]
    good = lambda m: share(m) >= tda_mod.SPLIT_WAVE_SHARE \
        and units * m >= sms  # noqa
    if pages <= 1:
        assert n == 1
    elif units * pages <= slots:
        assert n == pages
    else:
        assert good(n) or share(n) == max(share(m) for m in exact)
        assert not any(good(m) for m in exact if m < n)
    if (units, pages, sms) == (8, 65, 132):
        assert units * n >= sms


@pytest.mark.parametrize("bad", [-1, 35])
def test_paged_decode_rejects_out_of_range_slot_below_seq_len(bad):
    q, kp, vp, pt, _ = _decode_inputs(3, 4, 32, 8, 4, seed=3)   # 15 slots
    lens = np.asarray([32, 9, 1], np.int32)
    pt[1, 1] = bad                                # page 1 holds position 8
    with pytest.raises(IndexError):
        _decode_port(q, kp, vp, pt, lens)
    pt[1, 1] = 0
    pt[1, 2] = bad                                # past seq_len: never read
    _decode_port(q, kp, vp, pt, lens)


# ------------------------------------------------------------------ cms sketch
from repro.kernels.cms_sketch import ops as jcms  # noqa: E402
from repro.kernels.cms_sketch.ref import cms_update_ref  # noqa: E402
from repro_torch.kernels.cms_sketch import cms_sketch as tcms_mod  # noqa: E402
from repro_torch.kernels.cms_sketch import ops as tcms  # noqa: E402


@pytest.mark.parametrize("d,w,B", [(4, 256, 64), (2, 512, 128), (4, 128, 32)])
def test_cms_update_matches_reference(d, w, B):
    """tests/test_kernels.py's sweep: a heavy hitter among random keys."""
    rng = np.random.RandomState(1)
    a = rng.randint(1, 2 ** 31, d).astype(np.uint32)
    b = rng.randint(0, 2 ** 31, d).astype(np.uint32)
    keys = np.concatenate([np.full(20, 42), rng.randint(0, 1000, B - 20)])
    rng.shuffle(keys)
    keys = keys.astype(np.int32)
    counters0 = np.zeros((d, w), np.int32)
    rc, rhot = jcms.cms_update_and_classify(
        jnp.asarray(keys), jnp.asarray(counters0), jnp.asarray(a),
        jnp.asarray(b), threshold=5)
    pc, phot = tcms.cms_update_and_classify(keys, counters0, a, b,
                                            threshold=5)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(phot.numpy(), np.asarray(rhot))
    assert bool(phot[np.where(keys == 42)[0][-1]])
    assert not counters0.any()                    # the input is left alone


def test_cms_saturation_matches_reference():
    a = np.asarray([3, 7], np.uint32)
    b = np.asarray([1, 5], np.uint32)
    counters = np.full((2, 64), 250, np.int32)
    keys = np.full(32, 9, np.int32)
    rc, rhot = jcms.cms_update_and_classify(
        jnp.asarray(keys), jnp.asarray(counters), jnp.asarray(a),
        jnp.asarray(b), threshold=10)
    pc, phot = tcms.cms_update_and_classify(keys, counters, a, b,
                                            threshold=10)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(phot.numpy(), np.asarray(rhot))
    assert int(pc.max()) == 255 and int((pc >> 1).max()) == 127


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cms_plain_matches_sequential_oracle(seed):
    """Duplicate columns, counters already at or above max_count, and
    untouched columns above it (left as they were)."""
    rng = np.random.RandomState(seed)
    d, w, B = 3, 16, 96
    cols = rng.randint(0, w, (d, B)).astype(np.int32)
    counters = rng.randint(0, 300, (d, w)).astype(np.int32)
    counters[:, -1] = 400                     # untouched and above max
    cols[cols == w - 1] = 0
    ref_c, ref_est = cms_update_ref(cols, counters)
    pc, pest = tcms_mod.cms_update_kernel(torch.from_numpy(cols),
                                          torch.from_numpy(counters))
    np.testing.assert_array_equal(pc.numpy(), ref_c)
    np.testing.assert_array_equal(pest.numpy(), ref_est)
    assert int(pc[0, -1]) == 400


def test_columns_for_bit_equal_with_negative_keys_and_wide_multipliers():
    i = np.arange(8)
    keys = np.concatenate([[-2, -1, 0, 1, 2 ** 31 - 1, -(2 ** 31)],
                           -(7 + i),
                           np.random.RandomState(0).randint(
                               -2 ** 31, 2 ** 31 - 1, 64)]).astype(np.int32)
    a = np.asarray([1, 3, 2 ** 31 - 1, 2 ** 32 - 1], np.uint32)
    b = np.asarray([0, 2 ** 31 - 2, 12345, 2 ** 32 - 1], np.uint32)
    for w in (64, 10_000, 977):
        ref = np.asarray(jcms.columns_for(jnp.asarray(keys), jnp.asarray(a),
                                          jnp.asarray(b), w))
        port = tcms.columns_for(torch.from_numpy(keys), a, b, w)
        assert port.dtype == torch.int32
        np.testing.assert_array_equal(port.numpy(), ref)


def test_cms_wrappers_check_inputs_and_count_no_plain_runs():
    n0 = tcms_mod.LAUNCHES
    with pytest.raises(ValueError):           # the kernel needs CUDA tensors
        tcms.cms_update_and_classify(np.zeros(4, np.int32),
                                     np.zeros((2, 8), np.int32),
                                     np.ones(2, np.uint32),
                                     np.ones(2, np.uint32), interpret=False)
    with pytest.raises(IndexError):
        tcms_mod.cms_update_kernel(torch.tensor([[0, 8]], dtype=torch.int32),
                                   torch.zeros((1, 8), dtype=torch.int32))
    with pytest.raises(TypeError):
        tcms_mod.cms_update_kernel(torch.tensor([[0]]),
                                   torch.zeros((1, 8), dtype=torch.int32))
    tcms.cms_update_and_classify(np.arange(4), np.zeros((2, 8), np.int32),
                                 np.ones(2, np.uint32), np.ones(2, np.uint32))
    assert tcms_mod.LAUNCHES == n0 and tda_mod.LAUNCHES == 0


def test_cms_classify_runs_where_its_inputs_lie():
    """Host inputs run the plain version on the CPU; CUDA tensors launch
    the kernel on their card, by default too.  ``interpret=True`` with CUDA
    tensors, ``interpret=False`` with host inputs, and split or foreign
    devices raise instead of moving the work."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    for interpret in (None, True):
        assert tcms.run_device(cpu, cpu, interpret) == cpu
    for interpret in (None, False):
        assert tcms.run_device(cuda, cuda, interpret) == cuda
    for keys_dev, ctr_dev, interpret in ((cuda, cuda, True),
                                         (cpu, cpu, False),
                                         (cpu, cuda, None), (cuda, cpu, None),
                                         (torch.device("meta"),) * 2 + (None,)):
        with pytest.raises(ValueError):
            tcms.run_device(keys_dev, ctr_dev, interpret)
    meta = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tcms.cms_update_and_classify(torch.zeros(4, **meta),
                                     torch.zeros((2, 8), **meta),
                                     np.ones(2, np.uint32),
                                     np.ones(2, np.uint32))
    pc, hot = tcms.cms_update_and_classify(
        torch.arange(4, dtype=torch.int32),
        torch.zeros((2, 8), dtype=torch.int32), np.ones(2, np.uint32),
        np.ones(2, np.uint32))
    assert pc.device == hot.device == cpu and int(pc.sum()) == 8


def test_hint_filter_classify_batch_matches_reference():
    """The port's HintFilter.classify_batch (its kernel path imported
    ``repro_torch.kernels.cms_sketch.ops``, which was missing) equals the
    reference's on one key stream across aging boundaries."""
    from repro.core.hint_filter import HintFilter as JFilter
    from repro_torch.core.hint_filter import HintFilter as TFilter
    conf = dict(depth=4, width=512, threshold=6, aging_interval=300)
    jf, tf = JFilter(mode="hot", cms_conf=conf), TFilter(mode="hot",
                                                         cms_conf=conf)
    rng = np.random.RandomState(11)
    for i in range(12):
        keys = np.where(rng.rand(64) < 0.5, rng.randint(0, 8, 64),
                        rng.randint(0, 5000, 64)).astype(np.int32)
        jm, tm = jf.classify_batch(keys), tf.classify_batch(keys)
        np.testing.assert_array_equal(np.asarray(tm), np.asarray(jm))
        np.testing.assert_array_equal(tf._dev["counters"],
                                      np.asarray(jf._dev["counters"]))
        assert tf._dev["since_aging"] == jf._dev["since_aging"]
    assert tm.any() and not tm.all()


# ------------------------------------------------------------ flash attention
from repro.kernels.flash_attention.ops import \
    flash_attention as j_flash  # noqa: E402
from repro.kernels.mamba2_scan.ops import mamba2_scan as j_mamba  # noqa: E402
from repro.kernels.rwkv6_scan.ops import rwkv6_scan as j_rwkv  # noqa: E402
from repro.models.ssm import _rwkv6_chunked, ssd_chunked  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as tfa_mod  # noqa: E402
from repro_torch.kernels.mamba2_scan import \
    mamba2_scan as tms_mod  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as trs_mod  # noqa: E402


def t_mamba(x, dt, A, Bm, Cm, *, chunk):
    """The port's SSD scan in the Pallas kernel's layout (x [BH, S, P],
    dt [BH, S], Bm/Cm [BH, S, N]): one head per batch row."""
    y, state = tms_mod.mamba2_scan_kernel(
        x[:, :, None].contiguous(), dt[:, :, None].contiguous(), A,
        Bm[:, :, None].contiguous(), Cm[:, :, None].contiguous(),
        min(chunk, x.shape[1]))
    return y[:, :, 0], state[:, 0]


def t_rwkv(r, k, v, w, u):
    """The port's RWKV6 scan in the Pallas kernel's layout ([BH, S, N],
    u [BH, N])."""
    y, state = trs_mod.rwkv6_scan_kernel(
        *(t[:, :, None].contiguous() for t in (r, k, v, w)), u)
    return y[:, :, 0], state[:, 0]


def _both_dtypes(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("S,H,KV,d,bq,bk", [
    (128, 4, 2, 32, 64, 64),
    (256, 2, 2, 64, 64, 128),
    (128, 4, 1, 16, 128, 32),      # MQA, uneven blocks
    (128, 4, 2, 80, 64, 32),       # zamba2-2.7b's head dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference_kernel(S, H, KV, d, bq, bk, dtype,
                                                  causal):
    """tests/test_kernels.py's sweep (B = 2, GQA through the wrappers) and
    d 80: the port's kernel (KV head h // G) on the CPU against the Pallas
    kernel behind the reference's GQA wrapper."""
    rng = np.random.RandomState(0)
    B = 2
    arrays = [rng.randn(B, S, H, d).astype(np.float32),
              rng.randn(B, S, KV, d).astype(np.float32),
              rng.randn(B, S, KV, d).astype(np.float32)]
    (jq, jk, jv), (tq, tk, tv) = _both_dtypes(arrays, dtype)
    ref = j_flash(jq, jk, jv, causal=causal, bq=bq, bk=bk)
    out = tfa_mod.flash_attention_kernel(tq, tk, tv, causal)
    assert out.dtype == tq.dtype and out.shape == (B, S, H, d)
    assert_close(to_np(out), ref, dtype)


def test_flash_attention_ragged_lengths_match_padded_reference():
    """S and T that are not multiples of any block: the kernel takes them
    as they are; the reference kernel needs them padded, with padded keys
    masked, which the causal mask does when they come last."""
    rng = np.random.RandomState(1)
    q = rng.randn(2, 45, 4, 16).astype(np.float32)
    k = rng.randn(2, 45, 2, 16).astype(np.float32)
    v = rng.randn(2, 45, 2, 16).astype(np.float32)
    pad = ((0, 0), (0, 3), (0, 0), (0, 0))
    ref = j_flash(*(jnp.asarray(np.pad(a, pad)) for a in (q, k, v)),
                  causal=True, bq=16, bk=16)[:, :45]
    out = tfa_mod.flash_attention_kernel(
        *(torch.from_numpy(a) for a in (q, k, v)), True)
    assert_close(out.numpy(), ref)


# ------------------------------------------------------------------ ssm scans
def _mamba_inputs(BH, S, P, N, seed=0):
    """tests/test_kernels.py's construction from a numpy seed."""
    rng = np.random.RandomState(seed)
    x = rng.randn(BH, S, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(BH, S))).astype(np.float32)
    A = (-np.exp(rng.randn(BH) * 0.5)).astype(np.float32)
    Bm = rng.randn(BH, S, N).astype(np.float32)
    Cm = rng.randn(BH, S, N).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("S,P,N,chunk", [(128, 16, 8, 32), (64, 32, 16, 64),
                                         (256, 8, 4, 16), (62, 16, 8, 31)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_scan_matches_reference_kernel(S, P, N, chunk, dtype):
    """The sweep, plus Q = 31 (the S - 1 prefill of tests/test_models.py)."""
    x, dt, A, Bm, Cm = _mamba_inputs(3, S, P, N)
    (jx, jdt, jB, jC), (tx, tdt, tB, tC) = _both_dtypes([x, dt, Bm, Cm],
                                                        dtype)
    ref = j_mamba(jx, jdt, jnp.asarray(A), jB, jC, chunk=chunk)
    y, state = t_mamba(tx, tdt, torch.from_numpy(A), tB, tC, chunk=chunk)
    assert y.dtype == tx.dtype and state.shape == (3, N, P)
    assert_close(to_np(y), ref, dtype)


@pytest.mark.parametrize("G,chunk,init", [(1, 16, False), (2, 16, True),
                                          (2, 64, True)])
def test_mamba2_scan_final_state_matches_ssd_chunked(G, chunk, init):
    """The model layout (groups, a decay per head) and the final state the
    Pallas kernel drops, against the reference model's ``ssd_chunked``."""
    rng = np.random.RandomState(2)
    B, S, H, P, N = 2, 64, 4, 16, 8
    x = rng.randn(B, S, H, P).astype(np.float32)
    dt = np.abs(rng.randn(B, S, H)).astype(np.float32)
    A = (-np.exp(rng.randn(H) * 0.5)).astype(np.float32)
    Bm = rng.randn(B, S, G, N).astype(np.float32)
    Cm = rng.randn(B, S, G, N).astype(np.float32)
    s0 = rng.randn(B, H, N, P).astype(np.float32) if init else None
    jy, js = ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk,
                         init_state=None if s0 is None else jnp.asarray(s0))
    ty, ts = tms_mod.mamba2_scan_kernel(
        *map(torch.from_numpy, (x, dt, np.tile(A, B), Bm, Cm)), chunk,
        None if s0 is None else torch.from_numpy(s0))
    assert_close(ty.numpy(), jy)
    assert_close(ts.numpy(), js)


def test_mamba2_scan_plain_pads_a_short_last_chunk():
    """A last chunk shorter than Q (the kernel's ragged edge): zero padding
    adds nothing, so y and the state equal the divisible chunking's."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a)[:, :, None] if a.ndim > 1
                        else torch.from_numpy(a)
                        for a in _mamba_inputs(2, 60, 8, 4, seed=3))
    y16, s16 = tms_mod.mamba2_scan_plain(x, dt, A, Bm, Cm, 15)
    y24, s24 = tms_mod.mamba2_scan_plain(x, dt, A, Bm, Cm, 24)
    assert_close(y24.numpy(), y16.numpy())
    assert_close(s24.numpy(), s16.numpy())


@pytest.mark.parametrize("S,P,N,chunk", [(128, 16, 8, 32), (62, 16, 8, 31)])
def test_mamba2_scan_with_state_dropped_fails_reference_check(S, P, N,
                                                              chunk):
    """A planted fault, the scan with the state dropped at every chunk
    boundary (``chip_smoke.mamba_state_dropped``), fails the comparison
    with the Pallas kernel that the port's scan passes."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from chip_smoke import mamba_state_dropped
    x, dt, A, Bm, Cm = _mamba_inputs(3, S, P, N)
    ref = j_mamba(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=chunk)
    tx, tdt, tB, tC = (torch.from_numpy(a)[:, :, None] for a in (x, dt, Bm,
                                                                 Cm))
    assert_close(t_mamba(*(a[:, :, 0] for a in (tx, tdt)),
                         torch.from_numpy(A), tB[:, :, 0], tC[:, :, 0],
                         chunk=chunk)[0].numpy(), ref)
    fault = mamba_state_dropped(tx, tdt, torch.from_numpy(A), tB, tC, chunk)
    with pytest.raises(AssertionError):
        assert_close(fault[:, :, 0].numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_scan_gate_rejects_planted_faults(dtype):
    """``chip_smoke.scan_agrees``, the gate between K7/K8 and their plain
    versions on the card: it passes the plain output itself and one
    rounding away, and fails the SSD scan with the state dropped at chunk
    boundaries, the RWKV6 scan with its initial state dropped, errors of a
    typical element's size, an all-zero output and NaNs."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from chip_smoke import TOL, mamba_state_dropped, scan_agrees
    tdt = DTYPES[dtype][1]
    tol = TOL[tdt]
    rng = np.random.RandomState(7)
    B, S, H, P, N, Q = 2, 256, 4, 16, 16, 32
    x, Bm, Cm = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                 .to(tdt) for shape in ((B, S, H, P), (B, S, 1, N),
                                        (B, S, 1, N)))
    dt = torch.from_numpy(np.log1p(np.exp(rng.randn(B, S, H)))
                          .astype(np.float32))
    A = torch.from_numpy((-np.exp(rng.randn(B * H) * 0.5)).astype(np.float32))
    y, _ = tms_mod.mamba2_scan_plain(x, dt, A, Bm, Cm, Q)
    r, k, v, w = (torch.from_numpy(a.reshape(B, H, S, N).transpose(0, 2, 1, 3)
                                   .copy()).to(tdt)
                  for a in _rwkv_inputs(B * H, S, N, seed=7)[:4])
    u = torch.from_numpy((rng.randn(B * H, N) * 0.1).astype(np.float32))
    s0 = torch.from_numpy((rng.randn(B, H, N, N) * 0.5).astype(np.float32))
    ry, rst = trs_mod.rwkv6_scan_plain(r, k, v, w, u, s0)
    for plain in (y, ry, rst):
        assert scan_agrees(plain, plain, tol)
        assert scan_agrees((plain.double() * (1 + tol / 4)).to(plain.dtype),
                           plain, tol)
        rms = float(plain.float().square().mean().sqrt())
        noise = torch.from_numpy(rng.randn(*plain.shape).astype(np.float32))
        assert not scan_agrees((plain.float() + 0.5 * rms * noise)
                               .to(plain.dtype), plain, tol)
        assert not scan_agrees(torch.zeros_like(plain), plain, tol)
        assert not scan_agrees(torch.full_like(plain, float("nan")), plain,
                               tol)
    assert not scan_agrees(mamba_state_dropped(x, dt, A, Bm, Cm, Q), y, tol)
    assert not scan_agrees(trs_mod.rwkv6_scan_plain(r, k, v, w, u)[0], ry,
                           tol)


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_attention_gate_rejects_planted_faults(kernel, dtype):
    """``chip_smoke.decode_agrees``, the gate between K5/K6 and their plain
    versions on the card: it passes the plain output itself and one
    rounding away, and fails flash attention with the running-max rescale
    dropped between key tiles of 64 (``flash_rescale_dropped``) and decode
    attention that lost the split of each row's last quarter
    (``decode_split_dropped``)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from chip_smoke import (TOL, decode_agrees, decode_split_dropped,
                            flash_rescale_dropped)
    tdt = DTYPES[dtype][1]
    tol = TOL[tdt]
    if kernel == "flash_attention":
        rng = np.random.RandomState(5)
        q, k, v = (torch.from_numpy(rng.randn(2, 256, 4, kv, 32)
                                    .astype(np.float32)).to(tdt)
                   .reshape(2, 256, -1, 32) for kv in (2, 1, 1))
        plain = tfa_mod.flash_attention_plain(q, k, v, True)
        fault = flash_rescale_dropped(q, k, v, True)
        # one tile of keys has nothing to rescale
        one_tile = [t[:, :64] for t in (q, k, v)]
        assert torch.equal(flash_rescale_dropped(*one_tile, True),
                           tfa_mod.flash_attention_plain(*one_tile, True))
    else:
        q, kp, vp, pt, _ = _decode_inputs(3, 5, 64, 16, 32, seed=6)
        lens = np.asarray([512, 300, 77], np.int32)
        args = [torch.from_numpy(a).to(tdt) for a in (q, kp, vp)] \
            + [torch.from_numpy(pt), torch.from_numpy(lens)]
        plain = tda_mod.paged_decode_plain(*args)
        fault = decode_split_dropped(*args)
    assert decode_agrees(plain, plain, tol)
    assert decode_agrees((plain.double() * (1 + tol / 4)).to(tdt), plain,
                         tol)
    assert not decode_agrees(fault, plain, tol)


def _rwkv_inputs(BH, S, N, seed=0):
    rng = np.random.RandomState(seed)
    r = rng.randn(BH, S, N).astype(np.float32)
    k = (rng.randn(BH, S, N) * 0.3).astype(np.float32)
    v = rng.randn(BH, S, N).astype(np.float32)
    w = (1 / (1 + np.exp(-rng.randn(BH, S, N)))).astype(np.float32)
    u = (rng.randn(BH, N) * 0.1).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("S,N,chunk", [(128, 8, 32), (64, 16, 64),
                                       (96, 32, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_scan_matches_reference_kernel(S, N, chunk, dtype):
    arrays = _rwkv_inputs(3, S, N)
    jargs, targs = _both_dtypes(arrays, dtype)
    ref = j_rwkv(*jargs, chunk=chunk)
    y, state = t_rwkv(*targs)
    assert y.dtype == targs[0].dtype and state.shape == (3, N, N)
    assert_close(to_np(y), ref, dtype)


@pytest.mark.parametrize("S,Q", [(64, 16), (62, 31)])
def test_rwkv6_scan_final_state_matches_chunked_form(S, Q):
    """The sequential recurrence from a nonzero state against the reference
    model's chunked closed form (``_rwkv6_chunked``): y and final state."""
    rng = np.random.RandomState(4)
    B, H, N = 2, 2, 8
    r, k, v, w = (a.reshape(B, H, S, N).transpose(0, 2, 1, 3).copy()
                  for a in _rwkv_inputs(B * H, S, N, seed=4)[:4])
    u = (rng.randn(H, N) * 0.1).astype(np.float32)
    s0 = (rng.randn(B, H, N, N) * 0.5).astype(np.float32)
    jy, js = _rwkv6_chunked(*map(jnp.asarray, (r, k, v, w, u, s0)), Q)
    ty, ts = trs_mod.rwkv6_scan_kernel(
        *map(torch.from_numpy, (r, k, v, w, np.tile(u, (B, 1)), s0)))
    assert_close(ty.numpy(), jy)
    assert_close(ts.numpy(), js)


# the bf16 SSD launch plan: tests/test_kernels.py's sweeps, the groups
# case, zamba2-2.7b's prefill at full width (and at S 2000, a short last
# chunk), its S - 1 consistency prefill, and the largest sizes
SSD_SHAPES = [(1, 128, 3, 1, 8, 16, 32), (1, 64, 3, 1, 16, 32, 64),
              (1, 256, 3, 1, 4, 8, 16), (1, 62, 3, 1, 8, 16, 31),
              (1, 60, 3, 1, 16, 16, 24), (2, 64, 4, 2, 16, 16, 32),
              (4, 2048, 80, 1, 64, 64, 128), (4, 2000, 80, 1, 64, 64, 128),
              (4, 127, 80, 1, 64, 64, 127), (1, 4096, 64, 4, 64, 64, 128)]


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("B,S,H,G,N,P,Q", SSD_SHAPES)
def test_mamba2_launch_plan_contract(B, S, H, G, N, P, Q, per_sm):
    """``mamba2_scan.plan`` on an H100 (132 SMs): equal head tiles of at
    most MAX_HEADS within a group, the blocks they give, Q, N and P padded
    to the mma tile, shared memory within a block's limit and the scratch
    the wrapper allocates."""
    pl = tms_mod.plan(B, S, H, G, N, P, Q, 132, per_sm)
    rep, nc, heads = H // G, -(-S // Q), pl["heads"]
    assert 1 <= heads <= min(rep, tms_mod.MAX_HEADS)
    assert -(-rep // -(-rep // heads)) == heads          # equal tiles
    assert pl["chunks"] == nc
    assert pl["blocks"] == B * nc * G * -(-rep // heads)
    for size, padded in zip((Q, N, P), pl["padded"]):
        assert padded % 16 == 0 and size <= padded < size + 16
    assert max(pl["smem"]) <= tms_mod.SMEM_LIMIT
    # the most any plan takes: MAX_HEADS heads at the largest sizes
    assert max(tms_mod.smem_bytes(128, 64, 64, tms_mod.MAX_HEADS)) \
        <= tms_mod.SMEM_LIMIT
    assert pl["scratch"] == dict(s_loc=4 * B * nc * H * N * P,
                                 s_prev=4 * B * nc * H * N * P,
                                 dec=4 * B * nc * H)
    if heads > 1:               # a wave's worth of blocks, the last full
        slots = 132 * per_sm
        assert pl["blocks"] >= slots
        assert pl["blocks"] / (-(-pl["blocks"] // slots) * slots) \
            >= tms_mod.WAVE_SHARE


def test_mamba2_launch_plan_at_zamba2_prefill():
    """zamba2-2.7b's prefill (4 x 80 heads, S 2048, Q 128, N = P = 64) on
    an H100 holding two blocks of pass (c) an SM: 10 heads a block, 512
    blocks (the last wave 97% full), 84 MB of scratch each for S_loc and
    s_prev."""
    pl = tms_mod.plan(4, 2048, 80, 1, 64, 64, 128, 132, 2)
    assert (pl["heads"], pl["blocks"], pl["padded"]) == (10, 512,
                                                        (128, 64, 64))
    assert pl["smem"] == (70656, 102400)
    assert pl["scratch"] == dict(s_loc=83_886_080, s_prev=83_886_080,
                                 dec=20_480)
    assert [tms_mod.pad16(n) for n in (1, 16, 17, 24, 31, 127, 128)] == \
        [16, 16, 32, 32, 32, 128, 128]


@pytest.mark.parametrize("units,N", [(3, 8), (3, 16), (3, 32), (3, 64),
                                     (160, 64), (40, 64), (4, 64),
                                     (1024, 64), (160, 32)])
def test_rwkv6_column_plan_contract(units, N):
    """``rwkv6_scan.plan_columns`` on an H100 (132 SMs): a power-of-two
    tile of N columns, at least MIN_COLS, the widest that gives every SM a
    block; threads of whole column groups and row slices; shared memory
    within a block's limit in both types."""
    cols = trs_mod.plan_columns(units, N, 132)
    R = trs_mod.rows_per_lane(N)
    assert N % cols == 0 and cols & (cols - 1) == 0
    assert min(N, trs_mod.MIN_COLS) <= cols <= N
    assert units * (N // cols) >= 132 or cols == trs_mod.MIN_COLS
    assert cols == N or units * (N // (2 * cols)) < 132
    assert N % R == 0 and R % 4 == 0
    assert trs_mod.threads(N, cols) == \
        cols // trs_mod.COLS_PER_THREAD * (N // R)
    for dtype in (torch.float32, torch.bfloat16):
        assert trs_mod.smem_bytes(N, cols, dtype) <= trs_mod.SMEM_LIMIT


def test_rwkv6_column_plan_at_rwkv6_shapes():
    """rwkv6-3b at full width on an H100: the prefill's and decode's 4 x
    40 heads take the whole head a block (160 blocks of 64 threads); one
    request's 40 heads take 16 columns (160 blocks)."""
    assert trs_mod.plan_columns(160, 64, 132) == 64
    assert trs_mod.threads(64, 64) == 64
    assert trs_mod.smem_bytes(64, 64, torch.float32) == 111_360
    assert trs_mod.plan_columns(40, 64, 132) == 16
    assert [trs_mod.rows_per_lane(n) for n in trs_mod.HEAD_DIMS] == \
        [8, 16, 16, 16]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_scan_gate_rejects_lost_row_slice(dtype):
    """``chip_smoke.rwkv_slice_dropped``, the planted fault of K8's row
    split (one slice's part of y lost), fails ``scan_agrees`` against the
    plain version, which passes itself, on rwkv6-3b's head size from a
    nonzero state; the final state it leaves alone."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from chip_smoke import TOL, rwkv_slice_dropped, scan_agrees
    tdt = DTYPES[dtype][1]
    B, S, H, N = 2, 96, 4, 64
    rng = np.random.RandomState(8)
    r, k, v, w = (torch.from_numpy(a.reshape(B, H, S, N).transpose(0, 2, 1, 3)
                                   .copy()).to(tdt)
                  for a in _rwkv_inputs(B * H, S, N, seed=8)[:4])
    u = torch.from_numpy((rng.randn(B * H, N) * 0.1).astype(np.float32))
    s0 = torch.from_numpy((rng.randn(B, H, N, N) * 0.5).astype(np.float32))
    y, _ = trs_mod.rwkv6_scan_plain(r, k, v, w, u, s0)
    assert scan_agrees(y, y, TOL[tdt])
    assert not scan_agrees(rwkv_slice_dropped(r, k, v, w, u, s0), y,
                           TOL[tdt])


def test_scan_and_attention_wrappers_check_inputs_and_count_no_plain_runs():
    counts = (tfa_mod.LAUNCHES, tms_mod.LAUNCHES, trs_mod.LAUNCHES)
    q = torch.zeros((1, 4, 3, 16))
    with pytest.raises(ValueError):                 # H not a multiple of KV
        tfa_mod.flash_attention_kernel(q, torch.zeros((1, 4, 2, 16)),
                                       torch.zeros((1, 4, 2, 16)))
    with pytest.raises(ValueError):                 # A not [B * H]
        tms_mod.mamba2_scan_kernel(torch.zeros((1, 8, 2, 4)),
                                   torch.zeros((1, 8, 2)), torch.zeros(1),
                                   torch.zeros((1, 8, 1, 4)),
                                   torch.zeros((1, 8, 1, 4)), 4)
    with pytest.raises(ValueError):                 # u not [B * H, N]
        trs_mod.rwkv6_scan_kernel(*[torch.zeros((1, 8, 2, 4))] * 4,
                                  torch.zeros((2, 3)))
    tfa_mod.flash_attention_kernel(q, q, q)
    tms_mod.mamba2_scan_kernel(torch.zeros((1, 8, 2, 4)),
                               torch.zeros((1, 8, 2)), torch.zeros(2),
                               torch.zeros((1, 8, 1, 4)),
                               torch.zeros((1, 8, 1, 4)), 4)
    trs_mod.rwkv6_scan_kernel(*[torch.zeros((1, 8, 2, 4))] * 4,
                              torch.zeros((2, 4)))
    # what the CUDA kernels take, checked before a launch
    x, bc = torch.zeros((1, 8, 2, 64)), torch.zeros((1, 8, 1, 64))
    tms_mod.kernel_limits(x, bc, bc, 128)
    tms_mod.kernel_limits(x.bfloat16(), bc.bfloat16(), bc.bfloat16(), 31)
    with pytest.raises(TypeError):                  # fp16
        tms_mod.kernel_limits(x.half(), bc.half(), bc.half(), 64)
    with pytest.raises(TypeError):                  # Bm in another type
        tms_mod.kernel_limits(x.bfloat16(), bc, bc.bfloat16(), 64)
    for bad in ((x, bc, bc, 129), (torch.zeros((1, 8, 2, 65)), bc, bc, 64),
                (x, torch.zeros((1, 8, 1, 65)), torch.zeros((1, 8, 1, 65)),
                 64)):
        with pytest.raises(ValueError):             # chunk, P or N too big
            tms_mod.kernel_limits(*bad)
    for n in trs_mod.HEAD_DIMS:
        trs_mod.kernel_limits(*[torch.zeros((1, 4, 2, n))] * 4)
    with pytest.raises(ValueError):                 # N outside HEAD_DIMS
        trs_mod.kernel_limits(*[torch.zeros((1, 4, 2, 48))] * 4)
    with pytest.raises(TypeError):                  # w in another type
        trs_mod.kernel_limits(*[torch.zeros((1, 4, 2, 64))] * 3,
                              torch.zeros((1, 4, 2, 64)).bfloat16())
    # the counters count CUDA launches only: the plain versions ran here
    assert (tfa_mod.LAUNCHES, tms_mod.LAUNCHES, trs_mod.LAUNCHES) == counts


def test_ptxas_report_reads_each_kernel_of_a_build_log(monkeypatch):
    """``cuda_build.ptxas_report``, which the timed attention rows read
    their build facts from: registers, static shared memory, stack and
    spill bytes per kernel of nvcc's ``-Xptxas -v`` report."""
    from repro_torch.kernels import cuda_build
    fa_name = ("_ZN12_GLOBAL__N_117flash_bf16_kernelILi80ELi64EEEvPK13"
               "__nv_bfloat16S3_S3_PS1_iiiii")
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{fa_name}' for 'sm_90a'",
        f"ptxas info    : Function properties for {fa_name}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 130 registers, used 1 barriers, 400 bytes "
        "cmem[0]",
        "ptxas info    : Compiling entry function 'merge' for 'sm_90a'",
        "ptxas info    : Function properties for merge",
        "    24 bytes stack frame, 24 bytes spill stores, 16 bytes spill "
        "loads",
        "ptxas info    : Used 168 registers, 37376 bytes smem, 400 bytes "
        "cmem[0]"])
    monkeypatch.setitem(cuda_build.BUILD_LOG, "attn", log)
    assert cuda_build.ptxas_report("attn") == {
        fa_name: dict(stack_bytes=0, spill_stores=0, spill_loads=0,
                      registers=130),
        "merge": dict(stack_bytes=24, spill_stores=24, spill_loads=16,
                      registers=168, smem_bytes=37376)}
    assert cuda_build.ptxas_report("never_built") == {}
