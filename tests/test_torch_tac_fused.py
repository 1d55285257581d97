"""The fused plane's packed entry points (``repro_torch.kernels.tac_fused``)
against ``repro.core.tac_jax`` on the CPU, where they unpack into the plain
versions: the same numpy state and batches go through the reference's
``fused_step`` / ``fused_admit`` and through the port's packed layouts.
Keys, slots, hit, present, dirty and tallies must be bit-equal; new values,
pool and timestamps too for integer weights, and within 2e-5 for float
weights (tests/test_torch_tac.py's tolerance).  The layouts round-trip, and
a CPU ``FusedPlane`` goes through the packed path and agrees with the
reference's plane.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port import assert_close, one_thread  # noqa: E402,F401
from test_torch_tac import (PAD_KEY, _assert_state_equal, _both,  # noqa: E402
                            _state)

from repro.core import tac_jax  # noqa: E402
from repro.streaming import fused as jfused  # noqa: E402
from repro_torch.core import tac_torch  # noqa: E402
from repro_torch.kernels.tac_fused import tac_fused as tf  # noqa: E402
from repro_torch.streaming import fused as tfused  # noqa: E402

W = 24


def _lanes(arrays, rng, B, V, batch, int_weights):
    """``mixed``: resident keys with a key three times, a key at lanes 255
    and 256 and one at 1023 and 1024 (across the old 256-lane cap and the
    step kernel's tail tiles, where B reaches them), misses, fire lanes,
    an invalid lane and PAD_KEY padding at the tail; ``hot``: all B lanes
    one resident key, fire lanes among them; ``empty``: mixed, with query
    keys of -1 against a directory with empty ways."""
    keys0 = arrays[0][0]
    resident = keys0[keys0 >= 0]
    if batch == "hot":
        keys = np.full(B, resident[0], np.int32)
        valid = np.ones(B, bool)
    else:
        n = B - 3
        keys = np.where(rng.rand(n) < 0.7, rng.choice(resident, n),
                        rng.randint(4 * W, 5 * W, n))
        keys[1] = keys[n - 1] = keys[0]
        if batch == "empty":
            keys[2::5] = -1
        for a, b in ((255, 256), (1023, 1024)):
            if b < n:
                keys[b] = keys[a]
        keys = np.concatenate([keys, [PAD_KEY] * 3]).astype(np.int32)
        valid = np.arange(B) < n
        valid[4] = False
    ts = (rng.rand(B) * 20).astype(np.float32)
    weights = rng.randint(1, 9, (B, V)) if int_weights else rng.randn(B, V)
    fire = rng.rand(B) < 0.2
    return keys, ts, weights.astype(np.float32), fire, valid


def _packed_step(state, pages, lanes, kind):
    B, V = lanes[2].shape
    fields = tf.step_in_fields(B, V)
    packed = tf.fill(np.zeros(tf.nbytes(fields), np.uint8), fields, *lanes)
    out = tf.fused_step_packed(state, pages, torch.from_numpy(packed), B,
                               kind)
    assert out.dtype == torch.int32 and out.shape == (
        tf.step_out_words(B, V),)
    return tf.unpack_step_out(out, B, V)


@pytest.mark.parametrize("batch,B", [("mixed", 16), ("empty", 16),
                                     ("hot", 256)])
@pytest.mark.parametrize("V", [1, 3])
@pytest.mark.parametrize("kind", ["sum", "max", "read"])
@pytest.mark.parametrize("int_weights", [True, False])
def test_packed_step_matches_reference(batch, B, V, kind, int_weights):
    _check_packed_step(batch, B, V, kind, int_weights)


# batches past the step kernel's old 256-lane cap: one tail tile of 1024
# lanes and four.  A hot batch's float sums run over B lanes of one key,
# which the two packages' matrix products add in different orders: they
# are held to the summation bound below instead of 2e-5.
WIDE = [(batch, B, kind, int_weights) for B in (257, 1024, 4096)
        for batch in ("mixed", "hot", "empty")
        for kind in ("sum", "max", "read") for int_weights in (True, False)
        if (batch, kind, int_weights) != ("hot", "sum", False)]


@pytest.mark.parametrize("batch,B,kind,int_weights", WIDE)
@pytest.mark.parametrize("V", [1, 3])
def test_wide_packed_step_matches_reference(batch, B, V, kind, int_weights):
    _check_packed_step(batch, B, V, kind, int_weights)


def _check_packed_step(batch, B, V, kind, int_weights):
    arrays, rng = _state(W, V, seed=B + V)
    lanes = _lanes(arrays, rng, B, V, batch, int_weights)
    (js, jp), (ts_, tp) = _both(arrays)
    ref = tac_jax.fused_step(js, jp, *map(jnp.asarray, lanes), kind=kind)
    hit, slots, present, tallies, new_vals = _packed_step(ts_, tp, lanes,
                                                          kind)
    for name, got in (("hit", hit), ("slots", slots), ("present", present),
                      ("tallies", tallies)):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(ref, name)), name)
    if int_weights:
        np.testing.assert_array_equal(new_vals.numpy(),
                                      np.asarray(ref.new_vals))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(ref.pages))
    assert_close(new_vals.numpy(), ref.new_vals)
    _assert_state_equal(ref.state, ref.pages, ts_, tp)
    if batch == "empty":
        # a valid -1 lane hits the first empty way, as the reference's
        # compare of keys with no exception gives
        first_empty = int(np.flatnonzero(arrays[0][0] == -1)[0])
        lane = int(np.flatnonzero((lanes[0] == -1) & lanes[4])[0])
        assert bool(hit[lane]) and int(slots[lane]) == first_empty
    if batch == "hot":
        assert int(tallies[0]) == B


@pytest.mark.parametrize("n", [1, 5, 13, 64])
@pytest.mark.parametrize("V", [1, 3])
def test_packed_admit_matches_reference(n, V):
    """Host-chosen slots padded to the chunk width by repeating the first
    record, as ``FusedPlane._flush_admits`` pads: victim rows, pool and
    directory as the reference's."""
    arrays, rng = _state(64, V, seed=n)
    width = next(w for w in (1, 8, 16, 32, 64) if n <= w)
    recs = [rng.choice(64, n, replace=False), rng.randint(0, 1000, n),
            rng.rand(n) * 9, rng.randn(n, V), rng.rand(n) < 0.7,
            rng.rand(n) < 0.5]
    recs = [np.concatenate([a, np.repeat(a[:1], width - n, 0)]).astype(t)
            for a, t in zip(recs, (np.int32, np.int32, np.float32,
                                   np.float32, bool, bool))]
    (js, jp), (ts_, tp) = _both(arrays)
    rs, rp, rv = tac_jax.fused_admit(js, jp, *map(jnp.asarray, recs))
    fields = tf.admit_in_fields(width, V)
    packed = tf.fill(np.zeros(tf.nbytes(fields), np.uint8), fields, *recs)
    tf.check_slots(recs[0], 64)
    victims = tf.fused_admit_packed(ts_, tp, torch.from_numpy(packed), width)
    np.testing.assert_array_equal(victims.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))
    _assert_state_equal(rs, rp, ts_, tp)


@pytest.mark.parametrize("B,V", [(1, 1), (16, 3), (256, 1), (7, 5)])
def test_step_layouts_round_trip(B, V):
    rng = np.random.RandomState(B * V)
    lanes = (rng.randint(-2, 1000, B).astype(np.int32),
             rng.randn(B).astype(np.float32),
             rng.randn(B, V).astype(np.float32), rng.rand(B) < 0.5,
             rng.rand(B) < 0.5)
    fields = tf.step_in_fields(B, V)
    packed = tf.fill(np.zeros(tf.nbytes(fields), np.uint8), fields, *lanes)
    for buf in (packed, torch.from_numpy(packed)):
        for got, want in zip(tf.split(buf, fields), lanes):
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            np.testing.assert_array_equal(got, want.reshape(-1))
    outs = (torch.from_numpy(rng.rand(B) < 0.5),
            torch.from_numpy(rng.randint(0, 99, B).astype(np.int32)),
            torch.from_numpy(rng.rand(B) < 0.5),
            torch.tensor([3, 4], dtype=torch.int32),
            torch.from_numpy(rng.randn(B, V).astype(np.float32)))
    word = tf.pack_step_out(*outs)
    assert word.dtype == torch.int32 and word.numel() == tf.step_out_words(
        B, V)
    for back in (tf.unpack_step_out(word, B, V),
                 tf.unpack_step_out(word.numpy(), B, V)):
        for got, want in zip(back, outs):
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("N,V", [(1, 1), (8, 3), (64, 1)])
def test_admit_layout_round_trip(N, V):
    rng = np.random.RandomState(N + V)
    recs = (rng.randint(0, 99, N).astype(np.int32),
            rng.randint(0, 999, N).astype(np.int32),
            rng.rand(N).astype(np.float32),
            rng.randn(N, V).astype(np.float32), rng.rand(N) < 0.5,
            rng.rand(N) < 0.5)
    fields = tf.admit_in_fields(N, V)
    packed = tf.fill(np.zeros(tf.nbytes(fields), np.uint8), fields, *recs)
    assert tf.nbytes(fields) == N * (14 + 4 * V)
    for got, want in zip(tf.split(torch.from_numpy(packed), fields), recs):
        np.testing.assert_array_equal(got.numpy(), want.reshape(-1))


@pytest.mark.parametrize("bad", [-1, 64])
def test_admit_slots_are_checked_on_the_host(bad):
    arrays, _ = _state(64, 1, seed=0)
    _, (ts_, tp) = _both(arrays)
    slots = np.array([3, bad, 5], np.int32)
    with pytest.raises(IndexError):
        tf.check_slots(slots, 64)
    recs = (slots, np.zeros(3, np.int32), np.zeros(3, np.float32),
            np.zeros((3, 1), np.float32), np.ones(3, bool),
            np.zeros(3, bool))
    fields = tf.admit_in_fields(3, 1)
    packed = tf.fill(np.zeros(tf.nbytes(fields), np.uint8), fields, *recs)
    with pytest.raises(IndexError):
        tf.fused_admit_packed(ts_, tp, torch.from_numpy(packed), 3)


def test_packed_wrappers_reject_bad_buffers_and_count_no_plain_runs():
    arrays, _ = _state(8, 1, seed=1)
    _, (ts_, tp) = _both(arrays)
    n0 = (tf.STEP_LAUNCHES, tf.ADMIT_LAUNCHES)
    with pytest.raises(ValueError):
        tf.fused_step_packed(ts_, tp, torch.zeros(7, dtype=torch.uint8), 4)
    with pytest.raises(ValueError):
        tf.fused_admit_packed(ts_, tp, torch.zeros(7, dtype=torch.int32), 1)
    fields = tf.step_in_fields(4, 1)
    tf.fused_step_packed(ts_, tp, torch.zeros(tf.nbytes(fields),
                                              dtype=torch.uint8), 4)
    tac_torch.fused_admit(ts_, tp, *(torch.zeros(1, dtype=d) for d in (
        torch.int32, torch.int32, torch.float32)), torch.zeros((1, 1)),
        torch.ones(1, dtype=torch.bool), torch.zeros(1, dtype=torch.bool))
    # the counters count CUDA launches only: the plain versions ran here
    assert (tf.STEP_LAUNCHES, tf.ADMIT_LAUNCHES) == n0


def _plane_spec(mod, kind):
    return mod.FusedSpec(
        kind=kind, width=1, weight_of=lambda tup: float(tup),
        encode=lambda s: None if s is None else [float(s)],
        decode=lambda v: float(v[0]))


@pytest.mark.parametrize("kind", ["sum", "max", "read"])
def test_fusedplane_packed_path_matches_reference(kind, monkeypatch):
    """A CPU ``FusedPlane`` runs its batches and admissions through the
    packed entry points, and its per-lane results, counters and resident
    entries equal the reference plane's on the same operations."""
    calls = {"step": 0, "admit": 0}
    step, admit = tf.fused_step_packed, tf.fused_admit_packed

    def count(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(tf, "fused_step_packed", count("step", step))
    monkeypatch.setattr(tf, "fused_admit_packed", count("admit", admit))
    planes = [jfused.FusedPlane(12 * 8, 8, _plane_spec(jfused, kind),
                                batch=16),
              tfused.FusedPlane(12 * 8, 8, _plane_spec(tfused, kind),
                                batch=16, device="cpu")]
    results = []
    for p, mod in zip(planes, (jfused, tfused)):
        rs = np.random.RandomState(7)
        out = []
        for k in range(9):
            p.insert(k, float(k + 1), float(k))
        for rnd in range(3):
            keys = rs.randint(0, 14, 13)
            keys[1] = keys[0]
            lanes = [mod.Lane(int(k), 10.0 * rnd + i, (float(k % 5 + 1),),
                              bool(rs.rand() < 0.2), False, None)
                     for i, k in enumerate(keys)]
            res = p.batch_step(lanes)
            out.append([np.asarray(a) for a in res])
            for i, ln in enumerate(lanes):     # misses go through lookup
                if not res.hit[i]:
                    p.lookup(ln.key, ln.ts)
                    p.insert(ln.key, float(i), ln.ts, dirty=True)
        out.append((p.hits, p.misses, p.evictions, p.device_hits,
                    p.device_misses))
        out.append(sorted((k, e.state, e.ts, e.dirty)
                          for k, e in p.entries.items()))
        results.append(out)
    ref, got = results
    for r, g in zip(ref[:3], got[:3]):
        for a, b in zip(r, g):
            np.testing.assert_array_equal(b, a)
    assert got[3:] == ref[3:]
    assert calls["step"] == 3 and calls["admit"] >= 2


@pytest.mark.parametrize("B", [257, 1024, 4096])
@pytest.mark.parametrize("V", [1, 3])
def test_wide_hot_float_sums_within_the_summation_bound(B, V):
    """A hot batch of float weights: every lane folds the key's update
    lanes up to it, a run of up to B terms.  Both packages' new values and
    pools lie within the bound of recursive summation, gamma_n S (n terms,
    the row's value one of them, u = 2^-24, S the terms' magnitudes), of
    the sums in float64; everything else is bit-equal."""
    arrays, rng = _state(W, V, seed=B + V)
    lanes = _lanes(arrays, rng, B, V, "hot", False)
    (js, jp), (ts_, tp) = _both(arrays)
    ref = tac_jax.fused_step(js, jp, *map(jnp.asarray, lanes), kind="sum")
    hit, slots, present, tallies, new_vals = _packed_step(ts_, tp, lanes,
                                                          "sum")
    for name, got in (("hit", hit), ("slots", slots), ("present", present),
                      ("tallies", tallies)):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(ref, name)), name)
    keys, _, w, fire, valid = lanes
    upd = np.asarray(ref.hit) & ~fire
    M = np.tril(np.ones((B, B), bool)) & upd[None, :]
    row = arrays[4][np.asarray(ref.slots), 0]
    g = np.where(row[:, :1] > 0.5, row[:, 1:], 0.0).astype(np.float64)
    exact = g + M @ w.astype(np.float64)
    n = M.sum(1, keepdims=True) + 1.0
    u = 2.0 ** -24
    bound = n * u / (1 - n * u) * (np.abs(g) + M @ np.abs(w).astype(
        np.float64))
    for got in (new_vals.numpy(), np.asarray(ref.new_vals)):
        assert (np.abs(got - exact) <= bound).all()
    last = int(np.flatnonzero(upd)[-1])
    slot = int(slots[last])
    for pool in (tp.numpy(), np.asarray(ref.pages)):
        assert (np.abs(pool[slot, 0, 1:] - exact[last]) <= bound[last]).all()
    _assert_state_equal(ref.state, ref.pages, ts_, tp)
