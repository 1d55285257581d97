"""The fused plane's batch step as csrc/tac_fused.cu computes it for any
batch: its plan replayed in numpy on the CPU, against the plain version.

The step kernel probes with a block per (tile of ways, partition of
lanes): each block's table keeps, per key, its partition's first lane,
and the least matching way of its tile; the blocks fold their ways into a
workspace by that lane.  The last block's tail gives each lane its way and
its key's first lane in the batch (the table's when one partition holds
the batch, else the least lane naming the way), each key its last lane,
last hit lane, last update lane and latest hit timestamp, then walks the
lanes in tiles.  A lane alone with its key folds only itself; the lanes
of keys with more lanes are packed in lane order and a bitonic network
sorts them by (key's first lane, lane) into one run a key, and a lane
folds its key's carry from the earlier tiles and its run's update lanes
up to it, in lane order.  The run's last lane carries the fold on.  After
the last tile the key's last update lane writes its row back.  The replay keeps the kernel's tile and widths as
parameters, so small tiles split key runs at many tile boundaries, and it
must equal ``fused_step_plain`` bit for bit on integer weights.
"""
import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port import one_thread  # noqa: E402,F401

from repro_torch.core import tac_torch  # noqa: E402
from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.kernels.tac_fused import tac_fused as tf  # noqa: E402

SOURCE = (cuda_build.CSRC / "tac_fused.cu").read_text()
NONE = 2 ** 31 - 1
WARP = 32


def constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\w+)(?: \* (\w+))?;", SOURCE)
    val = [int(v) if v.isdigit() else constant(v) for v in m.groups() if v]
    return int(np.prod(val))


TILE = constant("kTile")
WAYS_PER_BLOCK = constant("kWaysPerBlock")


def bitonic(entries: np.ndarray) -> np.ndarray:
    """The tail's sorting network over a tile's entries (a power of two of
    them, at least a warp), in the kernel's stage order: for each k, the
    exchanges across warps (j >= 32, through shared memory), then those
    within a warp (shuffles).  Place t keeps the smaller of (t, t ^ j)
    where (t & j == 0) agrees with (t & k == 0)."""
    e = entries.copy()
    S = len(e)
    t = np.arange(S)
    k = 2
    while k <= S:
        j = k // 2
        while j > 0:
            o = e[t ^ j]
            keep_min = ((t & j) == 0) == ((t & k) == 0)
            e = np.where(keep_min, np.minimum(e, o), np.maximum(e, o))
            j //= 2
        k *= 2
    return e


def entries_of(first: np.ndarray, lane: np.ndarray, shift: int):
    """The sort entries of a tile's packed lanes: key's first lane << shift
    | tile lane; pads fill the network to a power of two, at least a
    warp."""
    G = len(first)
    S = WARP
    while S < G:
        S *= 2
    e = np.full(S, (1 << (64 if shift == 32 else 32)) - 1, np.uint64)
    e[:G] = (first.astype(np.uint64) << np.uint64(shift)) | lane.astype(
        np.uint64)
    return e


def replay_step(keys, ts, w, fire, valid, dir_keys, dir_ts, dir_dirty,
                pages, kind, tile=TILE, ways_per_block=WAYS_PER_BLOCK):
    """The step kernel's plan in numpy, IN PLACE on the directory and the
    pool [W + 1, V + 1].  Returns (hit, slots, present, tallies, new_vals)
    and the workspace (ways, firsts) as the launch leaves it."""
    B, V = w.shape
    W = len(dir_keys)
    P = max(1, -(-B // tile))
    # the probe: a block per (tile of ways, partition of lanes); its table
    # holds a key's partition first lane and the block's least way
    ways_ws = np.full(1 + B, NONE, np.int64)
    ways_ws[0] = 0
    lane_part = np.zeros(B, np.int64)
    for p in range(P):
        lanes = range(p * tile, min(B, (p + 1) * tile))
        table = {}
        for i in lanes:
            table.setdefault(int(keys[i]), i)
        for i in lanes:
            lane_part[i] = table[int(keys[i])]
        for x in range(max(1, -(-W // ways_per_block))):
            least = {}
            for way in range(x * ways_per_block,
                             min(W, (x + 1) * ways_per_block)):
                k = int(dir_keys[way])
                if k in table:
                    least[k] = min(least.get(k, NONE), way)
            for k, way in least.items():
                ways_ws[1 + table[k]] = min(ways_ws[1 + table[k]], way)
            ways_ws[0] += 1
    assert ways_ws[0] == P * max(1, -(-W // ways_per_block))
    ways_ws[0] = 0
    # the tail: each lane's way and its key's first lane
    lane_way = ways_ws[1 + lane_part]
    firsts = np.full(max(W, 1), NONE, np.int64)
    if B <= tile:
        lane_first = np.where(lane_way < W, lane_part, -1)
    else:
        for i in range(B):
            if lane_way[i] < W:
                firsts[lane_way[i]] = min(firsts[lane_way[i]], i)
        lane_first = np.where(lane_way < W,
                              firsts[np.minimum(lane_way, W - 1)], -1)
    hit = valid & (lane_way < W)
    upd = hit & ~fire if kind != "read" else np.zeros(B, bool)
    # each key's last lane, last hit and update lane, latest hit timestamp
    key_last = np.full(B, -1)
    key_hit = np.full(B, -1)
    key_upd = np.full(B, -1)
    key_ts = np.full(B, -np.inf, np.float32)
    for i in np.flatnonzero(lane_way < W):
        f = lane_first[i]
        key_last[f] = i
        if hit[i]:
            key_hit[f] = i
            key_ts[f] = max(key_ts[f], ts[i])
        if upd[i]:
            key_upd[f] = i
    multi = (lane_way < W) & (key_last[np.maximum(lane_first, 0)]
                              != lane_first)
    # the tiles, in lane order, carrying each key's fold and whether an
    # update was seen
    ident = -np.inf if kind == "max" else 0.0
    fold = np.fmax if kind == "max" else np.add

    def combine(row, v, present):
        """The lane's new values from its row and its fold."""
        flag = row[0] > 0.5
        if kind == "max":
            nv = np.fmax(np.where(flag, row[1:], -np.inf), v)
        else:
            nv = np.where(flag, row[1:], 0).astype(np.float32) + v
        return np.where(present, nv, 0)

    carry = np.zeros((B, V), np.float32)
    seen_ = np.zeros(B, bool)
    present = np.zeros(B, bool)
    new_vals = np.zeros((B, V), np.float32)
    shift = 10 if B < 1 << 22 else 32
    rows = pages[np.where(lane_way < W, lane_way, W)]
    for t0 in range(0, B, tile):
        nl = min(tile, B - t0)
        more = t0 + tile < B
        # a lane alone with its key (or with no way) folds only itself
        for li in range(t0, t0 + nl):
            if multi[li]:
                continue
            v = fold(np.full(V, ident, np.float32), w[li]).astype(
                np.float32) if upd[li] else np.full(V, ident, np.float32)
            present[li] = rows[li, 0] > 0.5 or upd[li]
            new_vals[li] = combine(rows[li], v, present[li])
        # the other lanes, packed in lane order and sorted into runs
        packed = np.flatnonzero(multi[t0:t0 + nl])
        G = len(packed)
        e = entries_of(lane_first[t0 + packed], packed, shift)
        if G > 1:
            e = bitonic(e)
        assert (e[:-1] <= e[1:]).all()
        fk = (e >> np.uint64(shift)).astype(np.int64)
        lt = (e & np.uint64((1 << shift) - 1)).astype(np.int64)
        for pos in range(G):
            li = t0 + lt[pos]
            s = int(np.searchsorted(fk[:pos + 1], fk[pos]))
            last = pos + 1 == G or fk[pos + 1] != fk[pos]
            earlier = fk[pos] < t0
            run = [t0 + lt[q] for q in range(s, pos + 1)
                   if upd[t0 + lt[q]]]
            v = carry[fk[pos]].copy() if earlier else np.full(
                V, ident, np.float32)
            for j in run:
                v = fold(v, w[j]).astype(np.float32)
            seen = earlier and seen_[fk[pos]]
            present[li] = rows[li, 0] > 0.5 or seen or bool(run)
            if last and more:
                carry[fk[pos]] = v
                seen_[fk[pos]] = seen or bool(run)
            new_vals[li] = combine(rows[li], v, present[li])
    # after the last tile: timestamps, dirty bits and rows; the scratch row
    for i in range(B):
        if lane_way[i] >= W:
            continue
        f, way = lane_first[i], lane_way[i]
        if key_hit[f] == i:
            dir_ts[way] = max(dir_ts[way], key_ts[f])
        if key_upd[f] == i:
            dir_dirty[way] = True
            pages[way, 0] = 1.0
            pages[way, 1:] = new_vals[i]
        firsts[way] = NONE
    ways_ws[1 + lane_part] = NONE
    if kind != "read":
        pages[W] = 0.0
    slots = np.where(hit, lane_way, W)
    tallies = np.array([hit.sum(), (valid & ~hit).sum()])
    return (hit, slots, present, tallies, new_vals), (ways_ws, firsts)


def batch(W, B, V, kind_of_batch, seed):
    """A directory of one bucket of W ways, about 3/4 resident, and B
    lanes as chip_smoke.fused_case makes them (``mixed``, ``hot``,
    ``empty``), integer weights; ``few`` draws every lane from five
    resident keys, -1, a miss and the pad key, so keys repeat across
    every tile."""
    rng = np.random.default_rng(seed)
    keys = np.full(W, -1, np.int32)
    live = rng.random(W) < 0.75
    keys[live] = rng.permutation(4 * W)[:int(live.sum())]
    ts = np.where(live, rng.random(W) * 10, -np.inf).astype(np.float32)
    dirty = live & (rng.random(W) < 0.3)
    pages = np.zeros((W + 1, V + 1), np.float32)
    pages[:W, 0] = live & (rng.random(W) < 0.8)
    pages[:W, 1:] = rng.integers(0, 50, (W, V)) * pages[:W, :1]
    resident = keys[live]
    if kind_of_batch == "hot":
        q = np.full(B, resident[0], np.int32)
        valid = np.ones(B, bool)
    elif kind_of_batch == "few":
        q = rng.choice(np.concatenate([resident[:5], [-1, 5 * W, -2]]),
                       B).astype(np.int32)
        valid = rng.random(B) < 0.9
    else:
        n = B - 3
        q = np.where(rng.random(n) < 0.7, rng.choice(resident, n),
                     rng.integers(4 * W, 5 * W, n))
        q[1] = q[n // 2] = q[n - 1] = q[0]
        if kind_of_batch == "empty":
            q[2::7] = -1
        q = np.concatenate([q, [-2] * 3]).astype(np.int32)
        valid = np.arange(B) < n
        valid[5] = False
    lanes = (q, (rng.random(B) * 20).astype(np.float32),
             rng.integers(1, 9, (B, V)).astype(np.float32),
             rng.random(B) < 0.2, valid)
    return (keys, ts, dirty, pages), lanes


def plain(directory, lanes, kind):
    keys, ts, dirty, pages = directory
    W = len(keys)
    state, pg = tac_torch.from_numpy(
        keys[None], ts[None], np.zeros((1, W, 1), np.float32), dirty[None],
        pages[:, None], "cpu")
    hit, slots, new_vals, present, tallies = tf.fused_step_plain(
        state, pg, *map(torch.from_numpy, lanes), kind)
    return ((hit.numpy(), slots.numpy(), present.numpy(), tallies.numpy(),
             new_vals.numpy()),
            (state.ts.numpy()[0], state.dirty.numpy()[0], pg.numpy()[:, 0]))


@pytest.mark.parametrize("kind", ["sum", "max", "read"])
@pytest.mark.parametrize("W,B,V,kind_of_batch,tile,ways_per_block", [
    (40, 37, 2, "mixed", 8, 16),       # five partitions, three way tiles
    (40, 37, 1, "few", 8, 16),         # keys repeat in every tile
    (40, 64, 1, "hot", 8, 64),         # one key's run split eight times
    (300, 129, 3, "empty", 32, 128),   # -1 lanes on empty ways
    (24, 100, 1, "few", 32, 24),       # one way tile, four partitions
    (300, 30, 2, "mixed", 32, 64),     # one partition, several way tiles
    (2048, 4096, 1, "mixed", TILE, WAYS_PER_BLOCK),   # the kernel's own
    (2100, 1025, 1, "few", TILE, WAYS_PER_BLOCK),     # a tile of one lane
])
def test_replayed_plan_matches_the_plain_step(W, B, V, kind_of_batch, tile,
                                              ways_per_block, kind):
    directory, lanes = batch(W, B, V, kind_of_batch, seed=W + B)
    want, want_dir = plain(directory, lanes, kind)
    keys, ts, dirty, pages = (a.copy() for a in directory)
    got, (ways_ws, firsts) = replay_step(*lanes, keys, ts, dirty, pages,
                                         kind, tile, ways_per_block)
    for name, a, b in zip(("hit", "slots", "present", "tallies",
                           "new_vals"), got, want):
        np.testing.assert_array_equal(a, b, name)
    for name, a, b in zip(("ts", "dirty", "pages"), (ts, dirty, pages),
                          want_dir):
        np.testing.assert_array_equal(a, b, name)
    # the launch leaves its workspace as it found it
    assert ways_ws[0] == 0 and (ways_ws[1:] == NONE).all()
    assert (firsts == NONE).all()


@pytest.mark.parametrize("S", [32, 64, 256, 1024])
@pytest.mark.parametrize("shift", [10, 32])
def test_the_sort_network_orders_a_tile_into_runs(S, shift):
    """Any packing of up to S lanes: the network leaves the entries in
    order, each key's lanes one run in lane order, the pads last."""
    rng = np.random.default_rng(S + shift)
    for G in {2, S // 2 + 1, S}:
        lane = np.sort(rng.choice(TILE, G, replace=False))
        first = rng.choice([0, 3, 700, (1 << 22) - 1], G)
        if shift == 32:
            first[::3] = rng.integers(0, 2 ** 31 - 1, len(first[::3]))
        out = bitonic(entries_of(first, lane, shift))
        assert (out[:-1] <= out[1:]).all()
        lanes = (out[:G] & np.uint64((1 << shift) - 1)).astype(np.int64)
        keys = (out[:G] >> np.uint64(shift)).astype(np.int64)
        assert sorted(lanes.tolist()) == lane.tolist()
        for k in np.unique(keys):
            at = np.flatnonzero(keys == k)
            assert (np.diff(at) == 1).all()
            assert (np.diff(lanes[at]) > 0).all()
            assert set(lanes[at]) == set(lane[first == k])


def test_the_source_keeps_the_replayed_widths():
    """The replay's widths are the kernel's: tiles of 1024 lanes (the
    wrapper's STEP_TILE and its workspace layout), 2048 ways a block, and
    32-bit sort entries below 2^22 lanes."""
    assert TILE == tf.STEP_TILE == 1024
    assert WAYS_PER_BLOCK == 2048
    assert "return B < 1 << 22 ? launch_step<uint32_t>(a, stream)" in SOURCE
    assert "kShift = sizeof(Key) == 4 ? 10 : 32" in SOURCE
    B, W, V = 4097, 3000, 3
    assert tf.step_workspace_words(B, W, V) == (1 + B, W, 8 * B + B * V)
    assert tf.step_workspace_words(1024, W, V) == (1025, 0, 1024)
