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
