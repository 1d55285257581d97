"""The port's serving path against the reference package on the CPU: the
device-TAC calls of ``repro_torch.core.tac_torch`` against
``repro.core.tac_jax``, the paged arena, the scheduler in its three modes,
the shard router, and the arena + paged-attention composition.  Both
packages start from the same numpy state and take the same numpy inputs.
Keys, slots, hit flags, evicted keys and dirty bits, counters and
``stats()`` must be bit-equal; floats agree within the reference's
``_tol``.  The port updates in place, so each comparison gives it its own
copy of the state."""
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port import assert_close, one_thread  # noqa: E402,F401

from repro import serving as jserving  # noqa: E402
from repro.core import tac_jax  # noqa: E402
from repro.kernels.decode_attention.ops import \
    paged_decode_attention as j_decode  # noqa: E402
from repro.streaming.backend import IN_MEMORY  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.core import tac_torch  # noqa: E402
from repro_torch.kernels.decode_attention.ops import \
    paged_decode_attention as t_decode  # noqa: E402
from repro_torch.streaming.backend import IN_MEMORY as T_IN_MEMORY  # noqa: E402


# ------------------------------------------------------------------ helpers
def _np_state(nb, ways, D, seed, fill=0.6, tie=False):
    """A set-associative TAC state as numpy arrays: random residents with
    timestamps, values and dirty bits; ``tie`` gives every resident the
    same timestamp (argmin ties)."""
    rng = np.random.RandomState(seed)
    keys = np.full((nb, ways), -1, np.int32)
    live = rng.rand(nb, ways) < fill
    keys[live] = rng.choice(50 * nb * ways, int(live.sum()), replace=False)
    ts = np.where(live, 5.0 if tie else rng.rand(nb, ways) * 10,
                  -np.inf).astype(np.float32)
    vals = (rng.randn(nb, ways, D) * live[..., None]).astype(np.float32)
    dirty = (rng.rand(nb, ways) < 0.4) & live
    return [keys, ts, vals, dirty], rng


def _both(arrays):
    j = tac_jax.TACState(*map(jnp.asarray, arrays))
    t = tac_torch.state_from_numpy(*arrays, "cpu")
    return j, t


def _assert_state(jstate, tstate):
    for name in ("keys", "dirty", "ts"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      np.asarray(getattr(jstate, name)), name)
    assert_close(tstate.vals.numpy(), jstate.vals)


def _resident_and_missing(keys_np, rng, n_hit, n_miss):
    res = keys_np[keys_np >= 0]
    return np.concatenate([rng.choice(res, n_hit),
                           rng.randint(10 ** 6, 2 * 10 ** 6, n_miss)]
                          ).astype(np.int32)


# -------------------------------------------------------- tac_torch calls
@pytest.mark.parametrize("seed", [0, 1])
def test_renew_matches_reference(seed):
    """Two renewals over resident and missing keys (miss lanes alias way 0
    of their bucket), a duplicate hit lane among them; the second raises
    some timestamps and leaves lower hints alone."""
    arrays, rng = _np_state(4, 4, 3, seed)
    q = _resident_and_missing(arrays[0], rng, 6, 4)
    q[1] = q[0]                                   # a duplicate hit lane
    now = (rng.rand(len(q)) * 20).astype(np.float32)
    j, t = _both(arrays)
    rs = tac_jax.renew(j, jnp.asarray(q), jnp.asarray(now))
    ps = tac_torch.renew(t, q, now)
    _assert_state(rs, ps)
    rs = tac_jax.renew(rs, jnp.asarray(q[::-1].copy()),
                       jnp.asarray(now * 2 - 10))
    ps = tac_torch.renew(ps, q[::-1].copy(), now * 2 - 10)
    _assert_state(rs, ps)


def test_admit_batch_matches_sequential_reference_on_tied_timestamps():
    """Every resident shares one timestamp and empty ways hold -inf: the
    min-ts way is a tie that must resolve to the first way, as in the
    reference's sequential ``admit``."""
    arrays, rng = _np_state(2, 4, 2, 5, fill=0.5, tie=True)
    keys = np.asarray([7, 9, 7, 11, 13, 15, 17, 19, 21, 9], np.int32)
    ts = np.full(len(keys), 5.0, np.float32)
    vals = rng.randn(len(keys), 2).astype(np.float32)
    dirty = rng.rand(len(keys)) < 0.5
    j, t = _both(arrays)
    rs = tac_jax.admit(j, *map(jnp.asarray, (keys, ts, vals, dirty)))
    ps = tac_torch.admit_batch(t, keys, ts, vals, dirty).state
    _assert_state(rs, ps)


@pytest.mark.parametrize("seed", range(3))
def test_fully_associative_admit_evicts_like_python_tac(seed):
    """tests/test_tac_jax.py's equivalence on seeded traces: one bucket of
    6 ways evicts in the host TAC's min-timestamp order through
    ``admit_batch``."""
    from repro_torch.core.tac import TimestampAwareCache
    rng = np.random.RandomState(seed)
    ways = 6
    py = TimestampAwareCache(capacity=ways)
    bat = tac_torch.init(1, ways, 2, device="cpu")
    for key, ts in zip(rng.randint(0, 16, 40), rng.uniform(1, 100, 40)):
        ts = np.float32(ts)
        py.insert(int(key), None, ts=float(ts))
        tac_torch.admit_batch(bat, [key], [ts])
    keys = bat.keys[0].numpy()
    assert set(keys[keys >= 0].tolist()) == set(py.entries.keys())


@pytest.mark.parametrize("seed", range(4))
def test_admit_batch_matches_reference(seed):
    """tests/test_serving.py's trace: successive batches with duplicate keys
    and same-bucket collisions resolved over conflict rounds."""
    rng = np.random.RandomState(seed)
    nb, ways, D = (1, 4, 2) if seed % 2 else (4, 3, 2)
    j = tac_jax.init(nb, ways, D)
    t = tac_torch.init(nb, ways, D, device="cpu")
    for _ in range(3):
        B = rng.randint(1, 16)
        keys = rng.randint(0, 12, B).astype(np.int32)
        ts = rng.uniform(1, 100, B).astype(np.float32)
        vals = rng.randn(B, D).astype(np.float32)
        dirty = rng.rand(B) < 0.5
        ref = tac_jax.admit_batch(j, *map(jnp.asarray,
                                          (keys, ts, vals, dirty)))
        out = tac_torch.admit_batch(t, keys, ts, vals, dirty)
        for name in ("slots", "evicted_keys", "evicted_dirty"):
            np.testing.assert_array_equal(getattr(out, name).numpy(),
                                          np.asarray(getattr(ref, name)))
        j, t = ref.state, out.state
        _assert_state(j, t)


@pytest.mark.parametrize("tie", [False, True])
def test_admit_batch_conflict_rounds_and_ties_match_reference(tie):
    """A full bucket receives several new keys in one batch (conflict
    rounds evict in batch order); with ``tie`` all residents share a
    timestamp, so each round's victim is the first tied way."""
    arrays, rng = _np_state(3, 4, 1, 9, fill=1.0, tie=tie)
    keys = rng.randint(10 ** 6, 2 * 10 ** 6, 40).astype(np.int32)
    keys[5:8] = arrays[0][0, :3]                  # overwrites of residents
    keys[20] = keys[3]                            # a key twice
    ts = np.full(40, 5.0 if tie else 7.0, np.float32)
    ts[::3] = 2.0
    j, t = _both(arrays)
    ref = tac_jax.admit_batch(j, jnp.asarray(keys), jnp.asarray(ts))
    out = tac_torch.admit_batch(t, keys, ts)
    for name in ("slots", "evicted_keys", "evicted_dirty"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    _assert_state(ref.state, out.state)
    assert int((out.evicted_keys >= 0).sum()) > 5


@pytest.mark.parametrize("value", [True, False])
def test_set_dirty_matches_reference_with_aliased_misses(value):
    arrays, rng = _np_state(4, 4, 1, 3)
    q = _resident_and_missing(arrays[0], rng, 6, 6)
    j, t = _both(arrays)
    _assert_state(tac_jax.set_dirty(j, jnp.asarray(q), value),
                  tac_torch.set_dirty(t, q, value))


@pytest.mark.parametrize("select", ["odd", "none"])
def test_export_mask_and_readmit_match_reference(select):
    """tests/test_sharding.py's export/import roundtrip on both packages:
    the drained entries keep their timestamps and dirty bits, and the
    destination re-admits them with ``import_entries``."""
    arrays, _ = _np_state(4, 2, 2, 6, fill=0.8)
    j, t = _both(arrays)
    mask = arrays[0] % 2 == 1 if select == "odd" else arrays[0] < -1
    rexp = tac_jax.export_mask(j, mask)
    pexp = tac_torch.export_mask(t, mask)
    for name in ("keys", "ts", "vals", "dirty", "slots"):
        np.testing.assert_array_equal(getattr(pexp, name),
                                      np.asarray(getattr(rexp, name)), name)
        assert getattr(pexp, name).dtype == np.asarray(
            getattr(rexp, name)).dtype, name
    _assert_state(rexp.state, pexp.state)
    assert (len(pexp.keys) > 0) == (select == "odd")
    dst_j, dst_t = tac_jax.init(4, 2, 2), tac_torch.init(4, 2, 2, device="cpu")
    rres = tac_jax.import_entries(dst_j, rexp.keys, rexp.ts, rexp.vals,
                                  rexp.dirty)
    pres = tac_torch.import_entries(dst_t, pexp.keys, pexp.ts, pexp.vals,
                                    pexp.dirty)
    np.testing.assert_array_equal(pres.slots.numpy(), np.asarray(rres.slots))
    _assert_state(rres.state, pres.state)


# -------------------------------------------------------------------- arena
POOLS = {"k": (4, 3), "v": (4, 3)}


def _arenas(nb=4, ways=3, seed=0):
    """A reference arena brought to a non-empty state by its own admits
    and stages, and a port arena loaded from it with ``load_numpy``."""
    rng = np.random.RandomState(seed)
    j = jserving.PagedStateArena(nb, ways, {n: (s, jnp.float32)
                                            for n, s in POOLS.items()})
    keys = rng.choice(200, 8, replace=False).astype(np.int32)
    adm = j.admit(keys, rng.rand(8).astype(np.float32) * 5)
    j.stage(adm.slots, {n: jnp.asarray(rng.randn(8, *s).astype(np.float32))
                        for n, s in POOLS.items()})
    j.mark_dirty(keys[:4])
    t = tserving.PagedStateArena(nb, ways, {n: (s, torch.float32)
                                            for n, s in POOLS.items()},
                                 device="cpu")
    t.load_numpy(*(np.asarray(a) for a in j.tac),
                 {n: np.asarray(p) for n, p in j.pools.items()})
    # load_numpy carries state, not counters: both count from here
    for name in ("hits", "misses", "conflicts", "admits", "evictions",
                 "dirty_evictions", "staged_pages"):
        setattr(j, name, 0)
    return j, t, rng


def _assert_arena(j, t):
    _assert_state(j.tac, t.tac)
    for n in POOLS:
        np.testing.assert_array_equal(t.pools[n].numpy(),
                                      np.asarray(j.pools[n]))
    assert t.stats() == j.stats()


def _assert_admitted(ra, pa):
    for name in ("slots", "evicted_keys", "evicted_dirty"):
        np.testing.assert_array_equal(getattr(pa, name),
                                      np.asarray(getattr(ra, name)))
    assert set(pa.evicted_blocks) == set(ra.evicted_blocks)
    mask = (pa.evicted_keys >= 0) & pa.evicted_dirty
    for n, blk in pa.evicted_blocks.items():
        assert blk.device.type == "cpu"
        np.testing.assert_array_equal(
            blk.numpy()[mask], np.asarray(ra.evicted_blocks[n])[mask])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_arena_op_sequence_matches_reference(seed):
    j, t, rng = _arenas(seed=seed)
    _assert_arena(j, t)
    for step in range(4):
        new = rng.randint(200, 400, 6).astype(np.int32)
        ts = (rng.rand(6) * 10 + step).astype(np.float32)
        ra, pa = j.admit(new, ts), t.admit(new, ts)
        _assert_admitted(ra, pa)
        blocks = {n: rng.randn(6, *s).astype(np.float32)
                  for n, s in POOLS.items()}
        j.stage(ra.slots, {n: jnp.asarray(b) for n, b in blocks.items()})
        t.stage(pa.slots, blocks)
        probe = np.concatenate([new[:3], rng.randint(0, 400, 5)]) \
            .astype(np.int32)
        now = np.full(len(probe), 20.0 + step, np.float32)
        rh, rs = j.probe(probe, now_ts=now)
        ph, ps = t.probe(probe, now_ts=now)
        np.testing.assert_array_equal(ph, rh)
        np.testing.assert_array_equal(ps, rs)
        j.renew(probe[:4], now[:4] + 5)
        t.renew(probe[:4], now[:4] + 5)
        j.mark_dirty(probe[::2])
        t.mark_dirty(probe[::2])
        _assert_arena(j, t)
        rg, pg = j.gather(rs[rh]), t.gather(ps[ph])
        for n in POOLS:
            np.testing.assert_array_equal(pg[n].numpy(), np.asarray(rg[n]))
    rk, rts, rd, rb = j.export_where(lambda k: k % 3 == 0)
    pk, pts, pd, pb = t.export_where(lambda k: k % 3 == 0)
    for a, b in ((pk, rk), (pts, rts), (pd, rd)):
        np.testing.assert_array_equal(a, b)
    for n in rb:
        np.testing.assert_array_equal(pb[n].numpy(), np.asarray(rb[n]))
    rk, rb = j.flush_dirty()
    pk, pb = t.flush_dirty()
    np.testing.assert_array_equal(pk, rk)
    for n in rb:
        np.testing.assert_array_equal(pb[n].numpy(), np.asarray(rb[n]))
    _assert_arena(j, t)


def test_arena_rejects_slots_outside_the_pool():
    _, t, _ = _arenas()
    with pytest.raises(IndexError):
        t.stage(np.asarray([0, t.n_slots]), {"k": np.zeros((2, 4, 3))})
    with pytest.raises(IndexError):
        t.gather(np.asarray([-1]))
    with pytest.raises(ValueError):
        t.load_numpy(*(np.zeros((1, 1)),) * 4, {})


def test_arena_eviction_surfaces_dirty_victims_with_contents():
    """tests/test_serving.py's victim case: a dirty page displaced by an
    admission comes back with its pre-overwrite contents, on the host."""
    arena = tserving.PagedStateArena(1, 2, {"state": ((4, 2),
                                                      torch.float32)},
                                     device="cpu")
    blocks = np.random.RandomState(1).randn(2, 4, 2).astype(np.float32)
    adm = arena.admit(np.asarray([1, 2], np.int32),
                      np.asarray([10.0, 20.0], np.float32))
    arena.stage(adm.slots, {"state": blocks})
    arena.mark_dirty(np.asarray([1], np.int32))
    adm2 = arena.admit(np.asarray([5], np.int32),
                       np.asarray([30.0], np.float32))
    assert list(adm2.evicted_keys) == [1] and list(adm2.evicted_dirty) == [1]
    np.testing.assert_array_equal(adm2.evicted_blocks["state"][0].numpy(),
                                  blocks[0])


# ---------------------------------------------------------------- scheduler
def _run_mode(pkg, mode, n_requests=24, rate=2000.0, decode_s=0.8e-3):
    """tests/test_serving.py's ``_run_mode`` for either package."""
    if pkg is jserving:
        arena = pkg.PagedStateArena(6, 2, {"state": ((4, 2), jnp.float32)})
    else:
        arena = pkg.PagedStateArena(6, 2, {"state": ((4, 2), torch.float32)},
                                    device="cpu")
    store = pkg.TieredStore(page_bytes=32 * 1024, workers=4)
    rng = np.random.RandomState(0)
    n_sessions, pages_per = 8, 3

    def pkeys(sid):
        return np.asarray([sid * 64 + p + 1 for p in range(pages_per)],
                          np.int32)

    for sid in range(n_sessions):
        for k in pkeys(sid):
            store.seed(int(k), {"state": np.full((4, 2), k, np.float32)})
    clock = pkg.SimClock()
    sched = pkg.ContinuousBatchingScheduler(arena, store, mode=mode,
                                            max_batch=2, clock=clock,
                                            metrics=pkg.ServingMetrics())
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n_requests))
    reqs = [pkg.Request(rid=i, session=int(rng.randint(n_sessions)),
                        page_keys=None, n_tokens=2)
            for i in range(n_requests)]
    for r in reqs:
        r.page_keys = pkeys(r.session)
    i = 0
    while i < n_requests or sched.pending:
        while i < n_requests and arrivals[i] <= clock.now():
            sched.submit(reqs[i])
            i += 1
        batch = sched.schedule()
        if not batch:
            if sched.wait_for_progress():
                continue
            if i < n_requests:
                clock.sleep(max(1e-6, arrivals[i] - clock.now()))
                continue
            break
        for req in batch:
            clock.advance(decode_s)
            sched.complete_token(req, dirty_keys=req.page_keys[:1])
    sched.drain_dirty()
    return sched.stats(), store


@pytest.mark.parametrize("mode", ["sync", "async", "prefetch"])
def test_scheduler_stats_match_reference(mode):
    (rstats, rstore), (pstats, pstore) = (_run_mode(jserving, mode),
                                          _run_mode(tserving, mode))
    assert pstats == rstats
    assert pstats["n_tokens"] == 48 and pstats["arena_evictions"] > 0
    assert set(pstore.backing.data) == set(rstore.backing.data)
    for k, blk in rstore.backing.data.items():
        np.testing.assert_array_equal(np.asarray(pstore.backing.data[k][
            "state"]), np.asarray(blk["state"]))


def test_scheduler_prefetch_beats_on_demand_ttft():
    res = {m: _run_mode(tserving, m)[0] for m in ("sync", "prefetch")}
    assert res["prefetch"]["ttft_p99"] < res["sync"]["ttft_p99"]
    assert res["prefetch"]["staging_overlap"] == pytest.approx(1.0)


# ------------------------------------------------------------------- router
def _router(n_shards=2, n_bins=8):
    mk_arena = lambda s: tserving.PagedStateArena(  # noqa: E731
        4, 2, {"kv": ((2, 4), torch.float32)}, device="cpu")
    mk_store = lambda s: tserving.TieredStore(  # noqa: E731
        backing_model=T_IN_MEMORY, page_bytes=256, workers=2)
    return tserving.ShardRouter(n_shards, mk_arena, mk_store, n_bins=n_bins)


def _kv(keys):
    return {"kv": np.stack([np.full((2, 4), float(k), np.float32)
                            for k in keys])}


def test_router_empty_batches():
    r = _router()
    hit, slots = r.probe(np.zeros((0,), np.int32))
    assert hit.shape == (0,) and slots.shape == (0,)
    adm = r.admit(np.zeros((0,), np.int32), np.zeros((0,), np.float32))
    assert adm.slots.shape == (0,)
    r.stage(adm.slots, {})
    r.renew(np.zeros((0,), np.int32), np.zeros((0,), np.float32))
    r.mark_dirty(np.zeros((0,), np.int32))
    assert r.request_stage([], now=0.0) == 0
    keys, blocks = r.flush_dirty()
    assert keys.shape == (0,) and blocks == {}


def test_router_routes_and_globalizes_slots():
    r = _router()
    keys = np.asarray([0, 1, 2, 3], np.int32)
    adm = r.admit(keys, np.asarray([1.0, 2.0, 3.0, 4.0], np.float32))
    r.stage(adm.slots, _kv(keys))
    hit, slots = r.probe(keys)
    assert hit.all() and (slots == adm.slots).all()
    assert (slots // r.slots_per_shard).tolist() == [0, 1, 0, 1]
    a0 = r.arenas[0].tac.keys.numpy()
    assert set(a0[a0 >= 0].tolist()) == {0, 2}


def test_router_migration_preserves_pages_ts_dirty():
    r = _router()
    keys = np.asarray([0, 2, 4], np.int32)
    ts = np.asarray([10.0, 20.0, 30.0], np.float32)
    adm = r.admit(keys, ts, dirty=np.asarray([True, False, True]))
    r.stage(adm.slots, _kv(keys))
    r.stores[0].seed(2, {"kv": np.zeros((2, 4), np.float32)})
    stats = r.migrate_bins([0, 2, 4], dst=1)
    assert stats["pages"] == 3 and stats["sources"] == 1
    assert (r.shard_of(keys) == 1).all()
    hit, slots = r.probe(keys, count=False)
    assert hit.all() and (slots // r.slots_per_shard == 1).all()
    blk = r.arenas[1].gather(slots - r.slots_per_shard)["kv"].numpy()
    for i, k in enumerate(keys):
        assert np.allclose(blk[i], float(k))
    dk = r.arenas[1].tac.keys.numpy()
    for k, t, d in zip(keys, ts, [True, False, True]):
        b, w = np.nonzero(dk == k)
        assert r.arenas[1].tac.ts.numpy()[b[0], w[0]] == t
        assert bool(r.arenas[1].tac.dirty.numpy()[b[0], w[0]]) == d
    assert 2 in r.stores[1].backing.data and 2 not in r.stores[0].backing.data
    assert (r.arenas[0].tac.keys.numpy() < 0).all()
    fkeys, fblocks = r.flush_dirty()
    assert sorted(fkeys.tolist()) == [0, 4]
    assert fblocks["kv"].shape == (2, 2, 4)


def test_router_hint_routing_not_broadcast():
    r = _router()
    assert r.request_stage([0, 1, 2, 5], now=0.0,
                           hint_ts=[1.0, 1.0, 1.0, 1.0]) == 4
    assert set(r.stores[0].in_flight) == {0, 2}
    assert set(r.stores[1].in_flight) == {1, 5}
    assert r.hints_routed.tolist() == [2, 2]
    assert {k for k, _, _ in r.poll(now=10.0)} == {0, 1, 2, 5}


def test_router_dirty_victims_and_stats_match_reference():
    """The same admit/stage/dirty/re-admit sequence through both routers:
    merged victim rows and every stat agree."""
    def make(pkg, dtype, **kw):
        return pkg.ShardRouter(
            2, lambda s: pkg.PagedStateArena(1, 2, {"kv": ((2, 4), dtype)},
                                             **kw),
            lambda s: pkg.TieredStore(backing_model=IN_MEMORY,
                                      page_bytes=256, workers=2), n_bins=4)
    j, t = make(jserving, jnp.float32), make(tserving, torch.float32,
                                             device="cpu")
    keys = np.asarray([0, 1, 2, 3], np.int32)
    for r in (j, t):
        adm = r.admit(keys, np.asarray([1.0, 2.0, 3.0, 4.0], np.float32))
        r.stage(adm.slots, _kv(keys))
        r.mark_dirty(keys[:3])
    new = np.asarray([4, 5, 6, 7], np.int32)
    ra = j.admit(new, np.full(4, 9.0, np.float32))
    pa = t.admit(new, np.full(4, 9.0, np.float32))
    for name in ("slots", "evicted_keys", "evicted_dirty"):
        np.testing.assert_array_equal(getattr(pa, name),
                                      getattr(ra, name))
    mask = (pa.evicted_keys >= 0) & pa.evicted_dirty
    assert mask.sum() == 3
    np.testing.assert_array_equal(pa.evicted_blocks["kv"].numpy()[mask],
                                  ra.evicted_blocks["kv"][mask])
    assert t.stats() == j.stats()


# ------------------------------------------------------------ the whole slice
def _page_key(seq, page):
    return seq * 1024 + page + 1


def test_arena_managed_paged_attention_matches_dense_and_reference():
    """tests/test_integration_tac_paged.py through the port: one batched
    admit, one scatter per pool, one probe for the page table, attention
    over the scattered physical pages — equal to dense attention over the
    logical sequence and to the reference's composition."""
    rng = np.random.RandomState(0)
    B, H, d, page, P = 2, 4, 32, 16, 3
    logical_k = rng.randn(B, P * page, d).astype(np.float32)
    logical_v = rng.randn(B, P * page, d).astype(np.float32)
    keys = np.asarray([[_page_key(b, p) for p in range(P)]
                       for b in range(B)], np.int32)
    ts = np.asarray([[100.0 + p for p in range(P)] for _ in range(B)],
                    np.float32)
    q = rng.randn(B, H, d).astype(np.float32)
    seq_lens = np.asarray([P * page, 2 * page + 5], np.int32)
    blocks = {"k": logical_k.reshape(-1, page, d),
              "v": logical_v.reshape(-1, page, d)}

    outs = []
    for pkg in (jserving, tserving):
        if pkg is jserving:
            arena = pkg.PagedStateArena(8, 4, {n: ((page, d), jnp.float32)
                                               for n in "kv"})
        else:
            arena = pkg.PagedStateArena(8, 4, {n: ((page, d), torch.float32)
                                               for n in "kv"}, device="cpu")
        adm = arena.admit(keys.reshape(-1), ts.reshape(-1))
        arena.stage(adm.slots, blocks if pkg is tserving else
                    {n: jnp.asarray(b) for n, b in blocks.items()})
        hit, table = arena.page_table(keys)
        assert hit.all()
        if pkg is jserving:
            outs.append(np.asarray(j_decode(
                jnp.asarray(q), arena.pools["k"], arena.pools["v"], table,
                jnp.asarray(seq_lens))))
        else:
            assert table.dtype == torch.int32
            outs.append(t_decode(torch.from_numpy(q), arena.pools["k"],
                                 arena.pools["v"], table,
                                 torch.from_numpy(seq_lens)).numpy())
    s = np.einsum("bhd,btd->bht", q, logical_k) / math.sqrt(d)
    for b in range(B):
        s[b, :, seq_lens[b]:] = -1e30
    p_ = np.exp(s - s.max(-1, keepdims=True))
    dense = np.einsum("bht,btd->bhd", p_ / p_.sum(-1, keepdims=True),
                      logical_v)
    assert_close(outs[1], dense)
    assert_close(outs[1], outs[0])


def test_arena_eviction_frees_slots_for_new_pages():
    arena = tserving.PagedStateArena(1, 2, {"k": ((4, 2), torch.float32)},
                                     device="cpu")
    adm = arena.admit(np.asarray([_page_key(0, 0), _page_key(0, 1)]),
                      np.asarray([10.0, 50.0], np.float32))
    assert (adm.evicted_keys == -1).all()
    arena.renew(np.asarray([_page_key(0, 0)]), np.asarray([99.0]))
    adm2 = arena.admit(np.asarray([_page_key(0, 2)]),
                       np.asarray([60.0], np.float32))
    assert list(adm2.evicted_keys) == [_page_key(0, 1)]
    hit, _ = arena.probe(np.asarray([_page_key(0, p) for p in range(3)]))
    assert list(hit) == [True, False, True]
