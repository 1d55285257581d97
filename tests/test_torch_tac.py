"""The port's fused TAC entry points (``repro_torch.core.tac_torch``)
against ``repro.core.tac_jax`` on the CPU: both start from the same numpy
state (through ``from_numpy``) and take the same numpy batches.  Keys,
slots, hit, present, dirty and tallies must be bit-equal; values, pool
and timestamps agree within 2e-5, exactly when the weights are integers.
The port updates in place, so each call gets a fresh copy of the state.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port import assert_close, one_thread  # noqa: E402,F401

from repro.core import tac_jax  # noqa: E402
from repro_torch.core import tac_torch  # noqa: E402

PAD_KEY = -2


def _state(W, V, seed, fill=0.75):
    """A fully-associative directory (one bucket of W ways) and its pool
    ``[W + 1, 1, V + 1]``: a random subset of slots is resident, with
    timestamps, dirty bits, payloads and presence flags; the scratch row
    is zero."""
    rng = np.random.RandomState(seed)
    keys = np.full((1, W), -1, np.int32)
    live = rng.rand(W) < fill
    keys[0, live] = rng.choice(4 * W, size=int(live.sum()), replace=False)
    ts = np.where(keys >= 0, rng.rand(1, W) * 10, -np.inf).astype(np.float32)
    vals = np.zeros((1, W, 1), np.float32)
    dirty = (rng.rand(1, W) < 0.3) & (keys >= 0)
    pages = np.zeros((W + 1, 1, V + 1), np.float32)
    pages[:W, 0, 0] = (rng.rand(W) < 0.8) & live
    pages[:W, 0, 1:] = rng.randint(0, 50, (W, V)) * pages[:W, 0, :1]
    return (keys, ts, vals, dirty, pages), rng


def _both(arrays):
    keys, ts, vals, dirty, pages = arrays
    jstate = tac_jax.TACState(jnp.asarray(keys), jnp.asarray(ts),
                              jnp.asarray(vals), jnp.asarray(dirty))
    tstate, tpages = tac_torch.from_numpy(keys, ts, vals, dirty, pages,
                                          "cpu")
    return (jstate, jnp.asarray(pages)), (tstate, tpages)


def _assert_state_equal(jstate, jpages, tstate, tpages):
    keys, ts, vals, dirty, pages = tac_torch.to_numpy(tstate, tpages)
    np.testing.assert_array_equal(keys, np.asarray(jstate.keys))
    np.testing.assert_array_equal(dirty, np.asarray(jstate.dirty))
    np.testing.assert_array_equal(vals, np.asarray(jstate.vals))
    assert_close(ts, jstate.ts)
    assert_close(pages, jpages)
    assert pages[-1].sum() == 0.0


def _batch(arrays, rng, B, V, int_weights):
    """Lanes mixing resident keys (with duplicates), misses, fire lanes
    and PAD_KEY padding lanes at the tail."""
    keys0 = arrays[0][0]
    resident = keys0[keys0 >= 0]
    n = B - 3
    keys = np.where(rng.rand(n) < 0.7, rng.choice(resident, n),
                    rng.randint(4 * len(keys0), 5 * len(keys0), n))
    keys[1] = keys[0]
    keys[n - 1] = keys[0]                      # a key three times
    keys = np.concatenate([keys, [PAD_KEY] * 3]).astype(np.int32)
    ts = (rng.rand(B) * 20).astype(np.float32)
    weights = rng.randint(1, 9, (B, V)) if int_weights else rng.randn(B, V)
    weights = weights.astype(np.float32)
    fire = rng.rand(B) < 0.2
    valid = np.arange(B) < n
    return keys, ts, weights, fire, valid


@pytest.mark.parametrize("kind", ["sum", "max", "read"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("int_weights", [True, False])
def test_fused_step_matches_reference(kind, seed, int_weights):
    W, V, B = 24, 2, 16
    arrays, rng = _state(W, V, seed)
    batch = _batch(arrays, rng, B, V, int_weights)
    (js, jp), (ts_, tp) = _both(arrays)
    ref = tac_jax.fused_step(js, jp, *map(jnp.asarray, batch), kind=kind)
    out = tac_torch.fused_step(ts_, tp, *map(torch.from_numpy, batch),
                               kind=kind)
    for name in ("hit", "slots", "present", "tallies"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    if int_weights:
        np.testing.assert_array_equal(out.new_vals.numpy(),
                                      np.asarray(ref.new_vals))
    assert_close(out.new_vals.numpy(), ref.new_vals)
    _assert_state_equal(ref.state, ref.pages, out.state, out.pages)
    assert int(out.tallies[0]) > 0 and int(out.tallies[1]) > 0


@pytest.mark.parametrize("n,seed", [(5, 0), (8, 1), (13, 2)])
def test_fused_admit_matches_reference(n, seed):
    """Host-chosen slots, padded to the next width by repeating the first
    record (FusedPlane._flush_admits): the duplicate writes are inert."""
    W, V = 32, 1
    arrays, rng = _state(W, V, seed)
    width = next(w for w in (1, 8, 16, 32, 64) if n <= w)
    slots = rng.choice(W, n, replace=False)
    recs = [rng.randint(0, 1000, n), rng.rand(n) * 9, rng.randn(n, V),
            rng.rand(n) < 0.7, rng.rand(n) < 0.5]
    pad = lambda a: np.concatenate([a, np.repeat(a[:1], width - n, 0)])
    args = [pad(slots).astype(np.int32), pad(recs[0]).astype(np.int32),
            pad(recs[1]).astype(np.float32), pad(recs[2]).astype(np.float32),
            pad(recs[3]), pad(recs[4])]
    (js, jp), (ts_, tp) = _both(arrays)
    rs, rp, rv = tac_jax.fused_admit(js, jp, *map(jnp.asarray, args))
    s, p, v = tac_torch.fused_admit(ts_, tp, *map(torch.from_numpy, args))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    _assert_state_equal(rs, rp, s, p)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drop_slots_matches_reference(seed):
    W = 32
    arrays, rng = _state(W, 1, seed)
    slots = np.zeros(16, np.int32)
    valid = np.zeros(16, bool)
    k = 5 + seed
    slots[:k] = rng.choice(np.arange(1, W), k, replace=False)
    valid[:k] = True                       # padding lanes alias slot 0
    (js, jp), (ts_, tp) = _both(arrays)
    ref = tac_jax.drop_slots(js, jnp.asarray(slots), jnp.asarray(valid))
    out = tac_torch.drop_slots(ts_, torch.from_numpy(slots),
                               torch.from_numpy(valid))
    _assert_state_equal(ref, jp, out, tp)
    assert (out.keys[0, torch.from_numpy(slots[:k]).long()] == -1).all()
    assert bool(out.keys[0, 0] == int(arrays[0][0, 0]))


def test_gather_rows_matches_reference():
    arrays, rng = _state(16, 3, 4)
    slots = rng.randint(0, 17, 9).astype(np.int32)
    ref = tac_jax.gather_rows(jnp.asarray(arrays[4]), jnp.asarray(slots))
    out = tac_torch.gather_rows(torch.from_numpy(arrays[4]),
                                torch.from_numpy(slots))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_state_numpy_roundtrip():
    arrays, _ = _state(8, 2, 5)
    back = tac_torch.to_numpy(*tac_torch.from_numpy(*arrays, "cpu"))
    for a, b in zip(arrays, back):
        assert a.dtype == b.dtype or a.dtype == np.float64
        np.testing.assert_array_equal(a, b)


def test_init_matches_reference():
    ref = tac_jax.init(2, 8, 3)
    out = tac_torch.init(2, 8, 3, device="cpu")
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("kind", ["sum", "max", "read"])
def test_fused_step_composition(kind):
    """The port of tests/test_kernels.py::test_fused_step_composition:
    duplicate keys compose exactly as a sequential per-lane loop."""
    W, V, B = 8, 2, 6
    state = tac_torch.init(1, W, 1, device="cpu")
    pages = torch.zeros((W + 1, 1, V + 1))
    seed = np.arange(1, 4 * V + 1, dtype=np.float32).reshape(4, V)
    state, pages, _ = tac_torch.fused_admit(
        state, pages, torch.arange(4, dtype=torch.int32),
        torch.arange(4, dtype=torch.int32), torch.zeros(4),
        torch.from_numpy(seed), torch.ones(4, dtype=torch.bool),
        torch.zeros(4, dtype=torch.bool))
    keys = torch.tensor([1, 1, 2, 7, 1, -2], dtype=torch.int32)
    ts = torch.full((B,), 5.0)
    wts = torch.arange(1, B * V + 1, dtype=torch.float32).reshape(B, V)
    fire = torch.tensor([0, 0, 1, 0, 0, 0], dtype=torch.bool)
    valid = torch.tensor([1, 1, 1, 1, 1, 0], dtype=torch.bool)
    before = (state._replace(**{k: v.clone() for k, v in
                                state._asdict().items()}), pages.clone())
    out = tac_torch.fused_step(state, pages, keys, ts, wts, fire, valid,
                               kind=kind)
    hit = out.hit.numpy()
    assert hit.tolist() == [True, True, True, False, True, False]
    assert out.tallies.tolist() == [4, 1]
    vals = {k: seed[k].copy() for k in range(4)}
    ref = []
    for i in range(B):
        k = int(keys[i])
        if not hit[i]:
            ref.append(np.zeros(V, np.float32))
            continue
        if kind != "read" and not bool(fire[i]):
            w = wts[i].numpy()
            vals[k] = np.maximum(vals[k], w) if kind == "max" \
                else vals[k] + w
        ref.append(vals[k].copy())
    np.testing.assert_allclose(out.new_vals.numpy(), np.stack(ref),
                               rtol=1e-6)
    pool = out.pages.numpy()
    expect = seed[1] if kind == "read" else vals[1]
    np.testing.assert_allclose(pool[1, 0, 1:], expect, rtol=1e-6)
    assert pool[-1].sum() == 0.0
    dirty = out.state.dirty.numpy()[0]
    assert not dirty[2]
    assert bool(dirty[1]) == (kind != "read")
    # the update happened in place; the clone taken before is untouched
    assert before[1][1, 0, 1:].tolist() == seed[1].tolist()
    st2 = tac_torch.drop_slots(out.state, torch.tensor([1, 0],
                                                       dtype=torch.int32),
                               torch.tensor([True, False]))
    out2 = tac_torch.fused_step(st2, out.pages, keys, ts, wts, fire, valid,
                                kind=kind)
    assert out2.hit.tolist() == [False, False, True, False, False, False]
