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


@pytest.mark.parametrize("n_slots,page,d,N", [(9, 1, 2, 8), (16, 4, 32, 12),
                                              (64, 16, 8, 40)])
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
