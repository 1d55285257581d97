"""The port's checkpoint writer (``repro_torch.checkpoint.manager``) against
the reference's: round trip and retention (the twin of
tests/test_substrate.py::test_checkpoint_roundtrip), checkpoints written by
one package restoring in the other with nested dicts whose insertion order
is not sorted, the leaf order itself, and the streaming SnapshotStore
persisting through the port's AsyncAtomicWriter."""
import json
import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as ref_manager
from repro_torch.checkpoint import manager as port_manager
from repro_torch.checkpoint.manager import AsyncAtomicWriter, \
    CheckpointManager
from repro_torch.streaming.recovery import SnapshotStore

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port import one_thread  # noqa: E402,F401


def nested(seed: int = 0):
    """A tree of numpy leaves whose dict keys are NOT inserted in sorted
    order, with a list, a tuple and a ``None`` (no leaf) inside."""
    g = np.random.default_rng(seed)
    return {"zeta": {"b": g.standard_normal((3, 4)).astype(np.float32),
                     "a": np.arange(5, dtype=np.int32)},
            "alpha": [g.standard_normal(2).astype(np.float32),
                      (np.int64(7), None)],
            "mid": g.integers(0, 9, (2, 2)).astype(np.int64)}


def leaves_by_path(tree, path=()):
    """{path: numpy array}: the comparison ignores flattening order."""
    if isinstance(tree, dict):
        return {p: v for k in tree
                for p, v in leaves_by_path(tree[k], path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree)
                for p, v in leaves_by_path(x, path + (i,)).items()}
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        tree = tree.numpy()
    return {path: np.asarray(tree)}


def assert_same_tree(got, want):
    g, w = leaves_by_path(got), leaves_by_path(want)
    assert g.keys() == w.keys()
    for p in w:
        np.testing.assert_array_equal(g[p], w[p], err_msg=str(p))


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    return None if tree is None else torch.as_tensor(np.asarray(tree))


def test_checkpoint_roundtrip(tmp_path):
    state = {"w": torch.arange(12.0).reshape(3, 4),
             "opt": (torch.ones(3), torch.zeros((), dtype=torch.int32))}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(10, state, extra={"data_step": 10}, blocking=True)
    mgr.save(20, {"w": state["w"] + 1,
                  "opt": tuple(x + 1 for x in state["opt"])}, blocking=True)
    step, restored, extra = mgr.restore(state)
    assert step == 20 and extra == {}
    assert isinstance(restored["w"], torch.Tensor)
    np.testing.assert_allclose(restored["w"].numpy(),
                               np.arange(12.0).reshape(3, 4) + 1)
    assert restored["opt"][1].dtype == torch.int32
    assert int(restored["opt"][1]) == 1
    assert mgr.restore(state, step=10)[2] == {"data_step": 10}
    # retention: only `keep` checkpoints remain
    mgr.save(30, state, blocking=True)
    assert mgr.list_steps() == [20, 30]
    assert mgr.latest_step() == 30


def test_async_save_publishes_after_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"x": torch.ones(4)})
    mgr.wait()
    assert mgr.list_steps() == [1]
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".tmp_")]


def test_flattening_order_is_the_references(tmp_path):
    """Leaf i of the port's shard is leaf i of the reference's for the
    same tree: dict keys in sorted order, not insertion order."""
    tree = nested()
    ref_manager.CheckpointManager(str(tmp_path / "ref")).save(
        1, tree, blocking=True)
    port_manager.CheckpointManager(str(tmp_path / "port")).save(
        1, to_torch(tree), blocking=True)
    a = np.load(tmp_path / "ref" / "step_00000001" / "shard_0.npz")
    b = np.load(tmp_path / "port" / "step_00000001" / "shard_0.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(tmp_path / "ref" / "step_00000001" / "manifest.json") as f:
        ref_m = json.load(f)
    with open(tmp_path / "port" / "step_00000001" / "manifest.json") as f:
        port_m = json.load(f)
    assert port_m["n_leaves"] == ref_m["n_leaves"] == 5
    assert port_m["dtypes"] == ref_m["dtypes"]


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = nested(1)
    ref_manager.CheckpointManager(str(tmp_path)).save(
        3, tree, extra={"data_step": 3}, blocking=True)
    template = to_torch(nested(2))
    step, got, extra = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 3 and extra == {"data_step": 3}
    assert list(got) == list(template)          # the template's key order
    assert isinstance(got["zeta"]["b"], torch.Tensor)
    assert_same_tree(got, tree)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = nested(3)
    CheckpointManager(str(tmp_path)).save(4, to_torch(tree), blocking=True)
    step, got, _ = ref_manager.CheckpointManager(str(tmp_path)).restore(
        nested(4))
    assert step == 4
    assert_same_tree(got, tree)


def test_bf16_leaves_cross_load_both_ways(tmp_path):
    vals = np.linspace(-3, 3, 8, dtype=np.float32)
    ref_manager.CheckpointManager(str(tmp_path / "ref")).save(
        1, {"h": jnp.asarray(vals, jnp.bfloat16)}, blocking=True)
    _, got, _ = CheckpointManager(str(tmp_path / "ref")).restore(
        {"h": torch.zeros(8, dtype=torch.bfloat16)})
    assert got["h"].dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(vals, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got["h"].float().numpy(), want)
    CheckpointManager(str(tmp_path / "port")).save(
        1, {"h": torch.from_numpy(vals).bfloat16()}, blocking=True)
    _, back, _ = ref_manager.CheckpointManager(str(tmp_path / "port")) \
        .restore({"h": jnp.zeros(8, jnp.bfloat16)})
    assert back["h"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["h"].astype(jnp.float32)),
                                  want)


def test_restore_rejects_another_structure(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.ones(2), "b": torch.ones(2)}, blocking=True)
    with pytest.raises(ValueError, match="structure"):
        mgr.restore({"a": torch.ones(2)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({})


def test_failed_write_publishes_nothing(tmp_path):
    w = AsyncAtomicWriter(str(tmp_path))

    def boom(tmp):
        with open(os.path.join(tmp, "half"), "w") as f:
            f.write("x")
        raise OSError("disk full")

    with pytest.raises(OSError):
        w.submit("step_00000001", boom, blocking=True)
    assert os.listdir(tmp_path) == []


def test_snapshot_store_persists_to_disk_via_async_writer(tmp_path):
    store = SnapshotStore(directory=str(tmp_path))
    assert isinstance(store._writer, AsyncAtomicWriter)
    store.persist(1, {"t0": 0.0, "offsets": {}, "bytes": 10,
                      "ops": {("s", 0): {"delta": {"k": 1},
                                         "deleted": set()}}})
    store.persist(2, {"t0": 0.5, "offsets": {}, "bytes": 10,
                      "ops": {("s", 0): {"delta": {"k": 2},
                                         "deleted": set()}}})
    store.wait()
    assert store.materialized[("s", 0)] == {"k": 2}
    assert store._writer.writes == 2
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["epoch_00000001", "epoch_00000002"]
    with open(tmp_path / "epoch_00000002" / "record.pkl", "rb") as f:
        rec = pickle.load(f)
    assert rec["epoch"] == 2
    assert rec["record"]["ops"][("s", 0)]["delta"] == {"k": 2}
