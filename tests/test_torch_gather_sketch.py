"""K2 (page gather) and K4 (count-min sketch) as redesigned for the H100:
the launch planners the CUDA kernels take their work split from, checked
by replaying each kernel's index arithmetic on the CPU; the plain
count-min update against the reference past the earlier kernel's batch
cap; and the planted faults that ``chip_smoke.py``'s gates must reject.  The plain gather at
the kernel's shapes is among ``test_page_gather_matches_reference``'s
cases in tests/test_torch_kernels.py."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port import one_thread  # noqa: E402,F401

from repro.kernels.cms_sketch.ref import cms_update_ref  # noqa: E402
from repro_torch.kernels.cms_sketch import cms_sketch as tcms  # noqa: E402
from repro_torch.kernels.page_gather import page_gather as tpg  # noqa: E402

H100_SMS = 132


def _gather_units(plan, n, row_units):
    """(row, unit) of every store the gather kernel makes under ``plan``,
    by csrc/page_gather.cu's index arithmetic (gather_as, gather_chunks;
    block b here is the kernel's (row b // n_chunks, chunk b % n_chunks))."""
    n_chunks = -(-row_units // plan.chunk_units)
    assert plan.blocks == n * n_chunks
    rounds = -(-plan.chunk_units // (plan.threads * tpg.VEC))
    b = np.arange(plan.blocks)[:, None, None, None]
    j = np.arange(rounds)[None, :, None, None]
    t = np.arange(plan.threads)[None, None, :, None]
    k = np.arange(tpg.VEC)[None, None, None, :]
    lo = (b % n_chunks) * plan.chunk_units
    u = lo + t + j * plan.threads * tpg.VEC + k * plan.threads
    keep = u < np.minimum(lo + plan.chunk_units, row_units)
    rows = np.broadcast_to(b // n_chunks, u.shape)
    return rows[keep], u[keep]


@pytest.mark.parametrize("n,row_bytes,unit", [
    (8, 32768, 16),          # (a) serve's append: 8 rows of [64, 128] fp32
    (256, 32768, 16),        # (b) a batch gather of the same rows
    (1, 8, 8),               # (c) the fused plane's single-key read
    (256, 8, 8),             # (c) at N 256
    (3, 32768, 16),          # (d) a zamba2 session's [8192, 1] fp32 pages
    (256, 8192, 16),         # 8 KB rows
    (100, 3, 1), (40, 6, 2), (33, 12, 4), (17, 24, 8),      # odd units
    (8, 32771, 1), (5, 32770, 2), (7, 4100, 4), (9, 264, 8),
    (1000, 256, 16),         # many short rows
    (0, 32768, 16), (0, 8, 8),
    (1, 32768, 16),
])
def test_gather_planner_covers_every_byte_once(n, row_bytes, unit):
    """``plan_gather``: every (row, byte) of the output is stored exactly
    once; chunks are whole units, one round of a block's threads * VEC
    loads at most; a short row is one chunk; blocks of 32-256 threads; at
    least one block an SM for serve's append."""
    plan = tpg.plan_gather(n, row_bytes, unit, H100_SMS)
    row_units = row_bytes // unit
    if n == 0:
        assert plan.blocks == 0
        return
    assert 32 <= plan.threads <= tpg.MAX_THREADS and plan.threads % 32 == 0
    assert 0 < plan.chunk_units <= plan.threads * tpg.VEC
    assert plan.blocks % n == 0 and plan.blocks // n <= 65535   # grid y
    assert plan.chunk_units * (plan.blocks // n - 1) < row_units
    if row_bytes <= 256:
        assert plan.blocks == n
    rows, units = _gather_units(plan, n, row_units)
    count = np.zeros((n, row_units), np.int64)
    np.add.at(count, (rows, units), 1)
    assert (count == 1).all()
    # bytes: each unit covers its unit bytes, so each byte once
    assert row_units * unit == row_bytes
    if (n, row_bytes) == (8, 32768):
        assert plan.blocks >= H100_SMS


@pytest.mark.parametrize("d,w", [(4, 10_000), (2, 64), (4, 256), (1, 1),
                                 (3, 0), (1, 1_000_000), (8, 4099),
                                 (200, 10_000)])
def test_cms_tiles_cover_the_row_once(d, w):
    """``plan_tiles``: the kernel's tiles of a row cover [0, w) exactly
    once, each within the kernel's MAX_TILE counters and a multiple of 4
    wide, and exactly one tile (the first) writes est = 0 for the lanes
    whose column is out of the row.  The hint filter's sketch gets about
    one block an SM."""
    tile, n_tiles = tcms.plan_tiles(d, w, H100_SMS)
    assert 0 < tile <= tcms.MAX_TILE and tile % 4 == 0 and n_tiles >= 1
    # csrc/cms_sketch.cu: tile t holds [t * tile, min(t * tile + tile, w))
    # and tile 0 writes the out-of-row lanes' est
    spans = [(t * tile, min(t * tile + tile, w), t == 0)
             for t in range(n_tiles)]
    cover = np.zeros(w, np.int64)
    for lo, hi, _ in spans:
        cover[lo:hi] += 1
    assert (cover == 1).all()
    assert [owns for _, _, owns in spans].count(True) == 1
    if (d, w) == (4, 10_000):
        assert d * n_tiles >= H100_SMS


@pytest.mark.parametrize("seed", [0, 1])
def test_cms_plain_at_b16384_with_hot_keys_matches_oracle(seed):
    """The plain update at B 16,384 (past the earlier kernel's cap of
    12,288): hot keys of thousands of copies that saturate their counters,
    warm counters, some at or above max_count, against the sequential
    oracle."""
    rng = np.random.RandomState(seed)
    d, w, B = 4, 10_000, 16_384
    cols = rng.randint(0, w, (d, B)).astype(np.int32)
    hot = rng.rand(d, B) < 0.25
    cols[hot] = 17
    cols[:, rng.rand(B) < 0.05] = 4242
    counters = rng.randint(0, 40, (d, w)).astype(np.int32)
    counters[:, 4242] = 300                       # above max, touched
    counters[:, 9999] = 400                       # above max, untouched
    cols[cols == 9999] = 0
    ref_c, ref_est = cms_update_ref(cols, counters)
    pc, pest = tcms.cms_update_kernel(torch.from_numpy(cols),
                                      torch.from_numpy(counters))
    np.testing.assert_array_equal(pc.numpy(), ref_c)
    np.testing.assert_array_equal(pest.numpy(), ref_est)
    assert int(pc[0, 17]) == 255 and int(pc[0, 9999]) == 400
    assert int(pc[0, 4242]) == 255


@pytest.mark.parametrize("n_slots,page,d,N", [(20, 8192, 1, 3),
                                              (9, 64, 128, 8),
                                              (2049, 1, 2, 1),
                                              (2049, 1, 2, 256)])
def test_gather_gate_rejects_a_dropped_chunk(n_slots, page, d, N):
    """``chip_smoke.gather_chunk_dropped``, the planted fault of K2's
    timed rows, fails the bit-equality gate and changes nothing outside row
    0; ``gather_expected`` writes zeros for slots out of range."""
    from chip_smoke import gather_chunk_dropped, gather_expected
    rng = np.random.RandomState(3)
    pages = torch.from_numpy(rng.randn(n_slots, page, d).astype(np.float32))
    slots = torch.from_numpy(rng.permutation(n_slots)[:N].astype(np.int32))
    good = tpg.page_gather_plain(slots, pages)
    assert torch.equal(gather_expected(slots, pages), good)
    fault = gather_chunk_dropped(slots, pages, sms=H100_SMS)
    assert not torch.equal(fault, good)
    assert torch.equal(fault[1:], good[1:])
    odd = slots.clone()
    odd[0] = -1
    zeroed = gather_expected(odd, pages)
    assert not zeroed[0].any() and torch.equal(zeroed[1:], good[1:])


@pytest.mark.parametrize("label", ["hint_filter", "saturation"])
def test_cms_gate_rejects_lanes_ranked_out_of_batch_order(label):
    """``chip_smoke.cms_ranked_backwards``, the planted fault of K4's timed
    rows: the same final counters, but a column's estimates in reverse
    batch order, which the bit-equality gate rejects."""
    from chip_smoke import cms_ranked_backwards
    rng = np.random.RandomState(7)
    if label == "saturation":
        cols = np.full((2, 32), 5, np.int32)
        counters = np.full((2, 64), 250, np.int32)
    else:
        cols = rng.randint(0, 10_000, (4, 256)).astype(np.int32)
        cols[:, rng.rand(256) < 0.25] = 42
        counters = rng.randint(0, 40, (4, 10_000)).astype(np.int32)
    cols, counters = torch.from_numpy(cols), torch.from_numpy(counters)
    pc, pe = tcms.cms_update_plain(cols, counters)
    fc, fe = cms_ranked_backwards(cols, counters)
    assert torch.equal(fc, pc)
    assert not torch.equal(fe, pe)
    ref_c, ref_est = cms_update_ref(cols.numpy(), counters.numpy())
    np.testing.assert_array_equal(pe.numpy(), ref_est)
