"""Sharded checkpointing with async write-out and atomic publication, in
PyTorch: the port of ``repro/checkpoint/manager.py``.

Layout per checkpoint:  <dir>/step_<N>/
    manifest.json   tree structure, dtypes/shapes, step, data-pipeline step
    shard_<i>.npz   flattened leaves (one shard per host in multi-host runs;
                    one shard here)

Writes happen on a background thread (the training loop never blocks on
storage — the same off-critical-path discipline as the TAC eviction buffer),
and a checkpoint becomes visible only via atomic rename, so a crash
mid-write can never corrupt the restore point.  ``keep`` bounds retention.

The layout is the reference's, leaf for leaf: a tree is flattened the way
``jax.tree_util`` flattens it — dict keys in SORTED order whatever their
insertion order, list/tuple/NamedTuple items in order, ``None`` holding no
leaf — so a checkpoint written by either package restores in the other.
bf16 leaves are stored as 2-byte void records under the dtype name
``bfloat16``, as numpy writes ml_dtypes' bfloat16.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if tree is None:
        return []
    return [tree]


def _structure(tree: Any) -> str:
    """A readable description of the tree's shape (the manifest's
    ``treedef``; restore reads the template, not this)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "None" if tree is None else "*"


def _rebuild(template: Any, leaves: Iterator[Any]) -> Any:
    if isinstance(template, dict):
        # consume in sorted order (the flattening order), keep the
        # template's own key order in the result
        got = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return type(template)((k, got[k]) for k in template)
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(v, leaves) for v in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    if template is None:
        return None
    return next(leaves)


def _to_numpy(x: Any) -> Tuple[np.ndarray, str]:
    """A leaf as the array to store and its dtype name."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view("V2"), "bfloat16"
        x = x.numpy()
    a = np.asarray(x)
    return a, str(a.dtype)


def _to_tensor(arr: np.ndarray, dtype: str, like: Any) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(like, torch.Tensor):
        t = t.to(like.device)
    return t


def _flatten(tree: Any) -> Tuple[List[Tuple[str, np.ndarray]], List[str]]:
    flat, dtypes = [], []
    for i, x in enumerate(_leaves(tree)):
        a, dt = _to_numpy(x)
        flat.append((f"leaf_{i}", a))
        dtypes.append(dt)
    return flat, dtypes


class AsyncAtomicWriter:
    """The write discipline shared by the training CheckpointManager and
    the streaming SnapshotStore (DESIGN.md §7): at most ONE background
    write in flight at a time, each write lands in a hidden temp dir and
    is published only via atomic rename — a crash mid-write can never
    corrupt a restore point."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self.writes = 0

    def submit(self, final_name: str, write_fn, blocking: bool = False,
               after=None) -> None:
        """``write_fn(tmp_dir)`` fills a temp dir; it is renamed to
        ``final_name`` on success; ``after()`` runs post-publication
        (retention GC hooks)."""
        self.wait()                       # one in-flight write at a time

        def _run():
            tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
            try:
                write_fn(tmp)
                final = os.path.join(self.dir, final_name)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                if after is not None:
                    after()
            finally:
                if os.path.exists(tmp):
                    shutil.rmtree(tmp, ignore_errors=True)

        self.writes += 1
        if blocking:
            _run()
        else:
            self._thread = threading.Thread(target=_run, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._writer = AsyncAtomicWriter(directory)
        self.saves = 0

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        # snapshot to host BEFORE handing to the writer thread
        flat, dtypes = _flatten(state)
        manifest = {
            "step": step,
            "treedef": _structure(state),
            "n_leaves": len(flat),
            "dtypes": dtypes,
            "extra": extra or {},
        }

        def _write(tmp):
            np.savez(os.path.join(tmp, "shard_0.npz"),
                     **{k: v for k, v in flat})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)

        self.saves += 1
        self._writer.submit(f"step_{step:08d}", _write, blocking=blocking,
                            after=self._gc)

    def wait(self) -> None:
        self._writer.wait()

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def list_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def restore(self, template: Any, step: Optional[int] = None
                ) -> Tuple[int, Any, Dict]:
        """Restore into the structure of ``template`` (shapes must match).
        Leaves come back as torch tensors, on the device of the template's
        leaf where that is a tensor.  Returns (step, state, extra)."""
        steps = self.list_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        step = steps[-1] if step is None else step
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(path, "shard_0.npz"))
        leaves = _leaves(template)
        if len(leaves) != manifest["n_leaves"]:
            raise ValueError(f"structure mismatch: template has "
                             f"{len(leaves)} leaves, checkpoint "
                             f"{manifest['n_leaves']}")
        dtypes = manifest.get("dtypes") or [""] * len(leaves)
        new_leaves = [_to_tensor(data[f"leaf_{i}"], dtypes[i], leaf)
                      for i, leaf in enumerate(leaves)]
        state = _rebuild(template, iter(new_leaves))
        return step, state, manifest.get("extra", {})

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None
