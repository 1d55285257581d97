"""The rest of the device TAC on the CPU: ``lookup``, the sequential
``admit``, ``shard_of``/``shard_mask``, ``probe_owned``/``admit_owned``,
``evict_expired``, ``import_entries`` and ``flush_dirty`` of
``repro_torch.core.tac_torch`` against ``repro.core.tac_jax``.  Both
packages start from the same numpy state and take the same numpy inputs;
keys, slots, hit flags, owned masks, counts, timestamps, dirty bits and
values must be bit-equal, and so must the outputs' dtypes.  The port
updates in place, so each comparison gives it its own copy of the
state."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _hypothesis_compat import given, settings, st  # noqa: E402
from _torch_port import one_thread  # noqa: E402,F401

from repro.core import tac_jax  # noqa: E402
from repro.kernels.tac_probe.ops import bucket_of  # noqa: E402
from repro_torch.core import tac_torch  # noqa: E402
from repro_torch.streaming.shards import hash_partition  # noqa: E402


def _np_state(nb, ways, D, seed, fill=0.6, tie=False):
    """A set-associative TAC state as numpy arrays: random residents, each
    in its own key's bucket (so that a probe finds it), with gaps between
    them, timestamps, values and dirty bits; ``tie`` gives every resident
    the same timestamp."""
    rng = np.random.RandomState(seed)
    keys = np.full((nb, ways), -1, np.int32)
    cand = rng.choice(50 * nb * ways, 8 * nb * ways, replace=False)
    home = np.asarray(bucket_of(jnp.asarray(cand, jnp.int32), nb))
    for b in range(nb):
        mine = cand[home == b]
        for w in range(min(ways, len(mine))):
            if rng.rand() < fill:
                keys[b, w] = mine[w]
    live = keys >= 0
    ts = np.where(live, 5.0 if tie else rng.rand(nb, ways) * 10,
                  -np.inf).astype(np.float32)
    vals = (rng.randn(nb, ways, D) * live[..., None]).astype(np.float32)
    dirty = (rng.rand(nb, ways) < 0.4) & live
    return [keys, ts, vals, dirty], rng


def _both(arrays):
    j = tac_jax.TACState(*map(jnp.asarray, arrays))
    t = tac_torch.state_from_numpy(*arrays, "cpu")
    return j, t


def _equal(port, ref, name=""):
    """Bit-equal values and the same dtype (tensors and arrays alike)."""
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.dtype == r.dtype, (name, p.dtype, r.dtype)
    assert p.shape == r.shape, (name, p.shape, r.shape)
    np.testing.assert_array_equal(p, r, name)


def _assert_state(jstate, tstate):
    for name in tac_jax.TACState._fields:
        _equal(getattr(tstate, name), getattr(jstate, name), name)


def _assert_result(ref, out):
    for name in ("slots", "evicted_keys", "evicted_dirty"):
        _equal(getattr(out, name), getattr(ref, name), name)
    _assert_state(ref.state, out.state)


def _resident_and_missing(keys_np, rng, n_hit, n_miss):
    res = keys_np[keys_np >= 0]
    return np.concatenate([rng.choice(res, n_hit),
                           rng.randint(10 ** 6, 2 * 10 ** 6, n_miss)]
                          ).astype(np.int32)


# ------------------------------------------------------------------ lookup
@pytest.mark.parametrize("seed", [0, 1])
def test_lookup_matches_reference(seed):
    """Hits, misses (which alias way 0 of their bucket), a duplicate hit
    lane, and a second lookup whose ``now_ts`` lies below the current
    timestamps: those stay as they are."""
    arrays, rng = _np_state(4, 4, 3, seed)
    q = _resident_and_missing(arrays[0], rng, 7, 5)
    q[1] = q[0]
    q[2] = q[0]
    now = (rng.rand(len(q)) * 20).astype(np.float32)
    j, t = _both(arrays)
    rv, rh, j = tac_jax.lookup(j, jnp.asarray(q), jnp.asarray(now))
    pv, ph, t2 = tac_torch.lookup(t, q, now)
    assert t2 is t
    _equal(pv, rv, "vals")
    _equal(ph, rh, "hit")
    _assert_state(j, t)
    assert ph.sum() == 7 and not ph[7:].any()
    low = np.full(len(q), -3.0, np.float32)
    rv, rh, j = tac_jax.lookup(j, jnp.asarray(q[::-1].copy()),
                               jnp.asarray(low))
    pv, ph, _ = tac_torch.lookup(t, q[::-1].copy(), low)
    _equal(pv, rv, "vals")
    _equal(ph, rh, "hit")
    _assert_state(j, t)


def test_lookup_with_a_scalar_now():
    arrays, rng = _np_state(2, 4, 2, 3)
    q = _resident_and_missing(arrays[0], rng, 3, 2)
    j, t = _both(arrays)
    rv, rh, j = tac_jax.lookup(j, jnp.asarray(q), 40.0)
    pv, ph, _ = tac_torch.lookup(t, q, 40.0)
    _equal(pv, rv)
    _equal(ph, rh)
    _assert_state(j, t)


# ------------------------------------------------------- sequential admit
TIE_TRACE = [(0, 1.0), (0, 1.0), (12, 3.1), (0, 1.0), (5, 1.0), (8, 1.1),
             (7, 99.70409440836916), (5, 1.1), (0, 1.0),
             (6, 39.526522937674066), (0, 60.480178052976406), (2, 1.0)]


def test_admit_equals_the_reference_on_the_timestamp_tie_trace():
    """The trace on which the reference's ``admit`` keeps key 8 where the
    host TAC keeps key 5 (6 ways, one bucket): the port follows the
    reference, key by key, through every insert."""
    j, t = tac_jax.init(1, 6, 2), tac_torch.init(1, 6, 2, device="cpu")
    for key, ts in TIE_TRACE:
        k = np.asarray([key], np.int32)
        s = np.asarray([ts], np.float32)
        v = np.zeros((1, 2), np.float32)
        j = tac_jax.admit(j, jnp.asarray(k), jnp.asarray(s), jnp.asarray(v))
        assert tac_torch.admit(t, k, s, v) is t
        _assert_state(j, t)
    final = set(t.keys[0].numpy().tolist())
    assert final == {0, 2, 6, 7, 8, 12}


@pytest.mark.parametrize("seed", range(3))
def test_admit_matches_sequential_reference(seed):
    """Batches with duplicate keys, same-bucket collisions, overwrites of
    residents and tied timestamps, with and without dirty bits."""
    arrays, rng = _np_state(3, 4, 2, seed, fill=0.7, tie=seed == 2)
    j, t = _both(arrays)
    for step in range(3):
        B = 12
        keys = np.concatenate([rng.randint(0, 40, B - 3),
                               arrays[0][arrays[0] >= 0][:3]]).astype(np.int32)
        keys[4] = keys[0]
        ts = rng.choice([2.0, 5.0, 7.5], B).astype(np.float32)
        vals = rng.randn(B, 2).astype(np.float32)
        dirty = None if step == 1 else rng.rand(B) < 0.5
        j = tac_jax.admit(j, jnp.asarray(keys), jnp.asarray(ts),
                          jnp.asarray(vals),
                          None if dirty is None else jnp.asarray(dirty))
        tac_torch.admit(t, keys, ts, vals, dirty)
        _assert_state(j, t)


# ------------------------------------------------------------ sharded plane
NEG_KEYS = np.asarray([-2 ** 31, -7, -6, -5, -1, 0, 1, 4, 5, 6, 13,
                       2 ** 31 - 1], np.int32)


@pytest.mark.parametrize("n_shards", [1, 3, 5, 7])
def test_shard_of_and_mask_match_reference_on_negative_keys(n_shards):
    ref = tac_jax.shard_of(jnp.asarray(NEG_KEYS), n_shards)
    out = tac_torch.shard_of(NEG_KEYS, n_shards)
    _equal(out, ref)
    assert out.dtype == torch.int32
    assert ((out >= 0) & (out < n_shards)).all()
    # the host partitioner agrees for every key (hash(i) == i but -1)
    for k, s in zip(NEG_KEYS.tolist(), out.tolist()):
        if k != -1:
            assert hash_partition(k, n_shards) == s
    for sid in range(n_shards):
        _equal(tac_torch.shard_mask(torch.from_numpy(NEG_KEYS), sid,
                                    n_shards),
               tac_jax.shard_mask(jnp.asarray(NEG_KEYS), sid, n_shards))


@pytest.mark.parametrize("shard_id", [0, 2])
def test_probe_owned_forces_foreign_keys_to_miss(shard_id):
    arrays, rng = _np_state(4, 4, 3, 4, fill=0.8)
    q = _resident_and_missing(arrays[0], rng, 10, 4)
    q[-1] = -q[0] - 1
    j, t = _both(arrays)
    rv, rh, ro = tac_jax.probe_owned(j, jnp.asarray(q), shard_id, 3)
    pv, ph, po = tac_torch.probe_owned(t, q, shard_id, 3)
    _equal(pv, rv, "vals")
    _equal(ph, rh, "hit")
    _equal(po, ro, "owned")
    resident = np.isin(q, arrays[0])
    assert (resident & ~po.numpy()).any()
    assert not (ph.numpy() & ~po.numpy()).any()
    _assert_state(j, t)                      # a probe changes nothing


@pytest.mark.parametrize("drop", ["none", "some", "all"])
def test_admit_owned_matches_reference(drop):
    arrays, rng = _np_state(3, 4, 2, 6, fill=0.7)
    B = 14
    keys = (rng.randint(0, 300, B) * 4).astype(np.int32)
    if drop == "some":
        keys[::3] += 1
        keys[1] = -keys[1] - 3
    elif drop == "all":
        keys += 2
    keys[5] = keys[2]
    ts = rng.uniform(0, 10, B).astype(np.float32)
    vals = rng.randn(B, 2).astype(np.float32)
    dirty = rng.rand(B) < 0.5
    j, t = _both(arrays)
    ref, rn = tac_jax.admit_owned(j, jnp.asarray(keys), jnp.asarray(ts),
                                  0, 4, jnp.asarray(vals),
                                  jnp.asarray(dirty))
    out, pn = tac_torch.admit_owned(t, keys, ts, 0, 4, vals, dirty)
    assert pn == rn and isinstance(pn, int)
    assert (pn == 0) == (drop == "none") and (pn == B) == (drop == "all")
    _assert_result(ref, out)
    assert out.slots.device == t.keys.device
    if drop == "all":
        assert out.slots.shape == (0,) and out.evicted_dirty.dtype == \
            torch.bool


def test_admit_owned_without_values():
    arrays, rng = _np_state(2, 4, 3, 8)
    keys = rng.randint(-50, 50, 9).astype(np.int32)
    ts = rng.uniform(0, 10, 9).astype(np.float32)
    j, t = _both(arrays)
    ref, rn = tac_jax.admit_owned(j, jnp.asarray(keys), jnp.asarray(ts), 1, 2)
    out, pn = tac_torch.admit_owned(t, keys, ts, 1, 2)
    assert pn == rn > 0
    _assert_result(ref, out)


# ------------------------------------------------------------ evict_expired
@pytest.mark.parametrize("retention", ["zero", "scalar", "array"])
def test_evict_expired_matches_reference_and_is_idempotent(retention):
    arrays, rng = _np_state(4, 4, 2, 2, fill=0.8)
    ret = {"zero": 0.0, "scalar": 2.5,
           "array": rng.choice([0.0, 1.5, 4.0], (4, 4))}[retention]
    j, t = _both(arrays)
    for wm in (6.1, 6.1, 9.0):
        j, rn = tac_jax.evict_expired(j, wm, jnp.asarray(ret))
        t2, pn = tac_torch.evict_expired(t, wm, ret)
        assert t2 is t
        _equal(pn, rn, "reclaimed")
        assert pn.dim() == 0 and pn.device == t.keys.device
        _assert_state(j, t)
    assert int(tac_torch.evict_expired(t, 6.1, ret)[1]) == 0


@pytest.mark.parametrize("wm", [6.1, 16777217.0])
def test_evict_expired_rounds_the_watermark_to_fp32(wm):
    """Timestamps on both sides of a watermark that fp32 cannot hold: the
    comparison is against the watermark rounded to fp32, as the
    reference's."""
    w32 = np.float32(wm)
    below = np.nextafter(w32, np.float32(-np.inf))
    above = np.nextafter(w32, np.float32(np.inf))
    ts = np.asarray([[below, w32, above, below]], np.float32)
    keys = np.asarray([[3, 4, 5, -1]], np.int32)
    arrays = [keys, ts, np.ones((1, 4, 1), np.float32),
              np.asarray([[True, True, True, False]])]
    j, t = _both(arrays)
    j, rn = tac_jax.evict_expired(j, wm)
    _, pn = tac_torch.evict_expired(t, wm)
    _equal(pn, rn)
    assert int(pn) == 1
    _assert_state(j, t)


# ------------------------------------------------------------- migration
@pytest.mark.parametrize("n", [0, 5])
def test_import_entries_matches_reference(n):
    arrays, rng = _np_state(3, 2, 2, 1, fill=0.5)
    keys = rng.randint(0, 99, n).astype(np.int32)
    ts = rng.uniform(0, 10, n).astype(np.float32)
    vals = rng.randn(n, 2).astype(np.float32)
    dirty = rng.rand(n) < 0.5
    j, t = _both(arrays)
    ref = tac_jax.import_entries(j, keys, ts, vals, dirty)
    out = tac_torch.import_entries(t, keys, ts, vals, dirty)
    _assert_result(ref, out)


def test_export_and_import_between_shards_match_reference():
    """A key range moves from one shard's state to another's, timestamps
    and dirty bits preserved."""
    src_arrays, _ = _np_state(4, 2, 2, 6, fill=0.8)
    dst_arrays, _ = _np_state(4, 2, 2, 7, fill=0.4)
    (js, ts_), (jd, td) = _both(src_arrays), _both(dst_arrays)
    mask = src_arrays[0] % 3 == 0
    rexp = tac_jax.export_mask(js, mask)
    pexp = tac_torch.export_mask(ts_, mask)
    assert len(pexp.keys) > 0
    ref = tac_jax.import_entries(jd, rexp.keys, rexp.ts, rexp.vals,
                                 rexp.dirty)
    out = tac_torch.import_entries(td, pexp.keys, pexp.ts, pexp.vals,
                                   pexp.dirty)
    _assert_result(ref, out)
    _assert_state(rexp.state, pexp.state)


def _assert_exported(pexp, rexp):
    for name in ("keys", "ts", "vals", "dirty", "slots"):
        _equal(getattr(pexp, name), getattr(rexp, name), name)
        assert isinstance(getattr(pexp, name), np.ndarray), name


def test_flush_dirty_when_nothing_is_dirty():
    arrays, _ = _np_state(2, 4, 3, 0)
    arrays[3][:] = False
    j, t = _both(arrays)
    j, rexp = tac_jax.flush_dirty(j)
    t2, pexp = tac_torch.flush_dirty(t)
    assert t2 is t and pexp.state is t
    _assert_exported(pexp, rexp)
    assert pexp.vals.shape == (0, 3) and pexp.vals.dtype == np.float32
    _assert_state(j, t)


def test_flush_dirty_exports_host_copies_taken_before_the_clear():
    """The exported rows equal the reference's, the dirty bits clear and
    the entries stay; a second flush is empty; and admits, expiry and a
    lookup on the state afterwards leave the exported arrays as they
    were."""
    arrays, rng = _np_state(3, 4, 2, 5, fill=0.9)
    j, t = _both(arrays)
    j, rexp = tac_jax.flush_dirty(j)
    _, pexp = tac_torch.flush_dirty(t)
    _assert_exported(pexp, rexp)
    _assert_state(rexp.state, pexp.state)
    assert len(pexp.keys) > 2 and not t.dirty.any()
    kept = {n: getattr(pexp, n).copy() for n in
            ("keys", "ts", "vals", "dirty", "slots")}
    tac_torch.admit(t, pexp.keys, pexp.ts + 100, np.full(
        (len(pexp.keys), 2), 7.0, np.float32), np.ones(len(pexp.keys), bool))
    t.vals.mul_(-3.0)
    tac_torch.evict_expired(t, 1e9)
    for name, before in kept.items():
        np.testing.assert_array_equal(getattr(pexp, name), before, name)
    j, rexp2 = tac_jax.flush_dirty(j)
    _, pexp2 = tac_torch.flush_dirty(tac_torch.state_from_numpy(
        *(np.asarray(a) for a in rexp.state), "cpu"))
    _assert_exported(pexp2, rexp2)
    assert len(pexp2.keys) == 0


# ------------------------------------------------------------ mixed traces
OPS = ("lookup", "admit", "admit_batch", "admit_owned", "probe_owned",
       "evict_expired", "set_dirty", "flush_dirty", "renew")


def _apply(op, j, t, keys, ts, vals, flag):
    """One call on both sides; asserts the outputs equal; returns the
    reference's new state."""
    jk, jt, jv = jnp.asarray(keys), jnp.asarray(ts), jnp.asarray(vals)
    if op == "lookup":
        rv, rh, j = tac_jax.lookup(j, jk, jt)
        pv, ph, _ = tac_torch.lookup(t, keys, ts)
        _equal(pv, rv)
        _equal(ph, rh)
    elif op == "admit":
        j = tac_jax.admit(j, jk, jt, jv, jnp.asarray(flag))
        tac_torch.admit(t, keys, ts, vals, flag)
    elif op == "admit_batch":
        ref = tac_jax.admit_batch(j, jk, jt, jv, jnp.asarray(flag))
        _assert_result(ref, tac_torch.admit_batch(t, keys, ts, vals, flag))
        j = ref.state
    elif op == "admit_owned":
        ref, rn = tac_jax.admit_owned(j, jk, jt, 1, 3, jv,
                                      jnp.asarray(flag))
        out, pn = tac_torch.admit_owned(t, keys, ts, 1, 3, vals, flag)
        assert pn == rn
        _assert_result(ref, out)
        j = ref.state
    elif op == "probe_owned":
        for a, b in zip(tac_torch.probe_owned(t, keys, 2, 3),
                        tac_jax.probe_owned(j, jk, 2, 3)):
            _equal(a, b)
    elif op == "evict_expired":
        wm = float(ts[0])
        j, rn = tac_jax.evict_expired(j, wm, 0.5)
        _equal(tac_torch.evict_expired(t, wm, 0.5)[1], rn)
    elif op == "set_dirty":
        j = tac_jax.set_dirty(j, jk, bool(flag[0]))
        tac_torch.set_dirty(t, keys, bool(flag[0]))
    elif op == "flush_dirty":
        j, rexp = tac_jax.flush_dirty(j)
        _assert_exported(tac_torch.flush_dirty(t)[1], rexp)
    else:
        j = tac_jax.renew(j, jk, jt)
        tac_torch.renew(t, keys, ts)
    _assert_state(j, t)
    return j


@settings(max_examples=12, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(OPS),
                          st.lists(st.integers(-6, 30), min_size=6,
                                   max_size=6),
                          st.lists(st.integers(0, 20), min_size=6,
                                   max_size=6),
                          st.lists(st.booleans(), min_size=6, max_size=6)),
                min_size=1, max_size=10))
def test_mixed_trace_stays_bit_equal(trace):
    """Any sequence of the calls, on keys that collide in buckets and
    repeat within a batch, on integer timestamps that tie: the state and
    every output stay bit-equal after every call."""
    j = tac_jax.init(2, 3, 2)
    t = tac_torch.init(2, 3, 2, device="cpu")
    for op, keys, ts, flag in trace:
        keys = np.asarray(keys, np.int32)
        ts = np.asarray(ts, np.float32)
        vals = np.stack([ts, keys.astype(np.float32)], axis=1)
        j = _apply(op, j, t, keys, ts, vals, np.asarray(flag))
